"""Dataset loaders for the ZU-MAV (ETH) and Newer College sequence layouts.

A copy of `orbslam2_nmi_tpu/io/datasets.py` on the port's synthetic world.
It replicates the reference's LoadImages readers:
  * mono_ETH.cc:164-199 — reads ``<seq>/_times.txt`` (one timestamp per line)
    and generates image names ``<seq>/%05d.jpg`` from a start index: 1 for
    pt1, 20513 pt2, 52500 pt3, 68700 pt4 (the reference hard-codes these at
    mono_ETH.cc:196-199; here it is the ``start_index`` argument and the
    ``--start-index`` flag of `run_replay`). An explicit ``<seq>_files.txt``
    list is also accepted.
  * mono_newer_college.cc — the same contract for the Newer College release.
Plus a synthetic-sequence writer for tests when no dataset is on disk.

Images load as uint8 grayscale on the host: ``.npy`` natively, PNG and JPEG
through PIL, imported only when such a file is read.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass
class Sequence:
    """A monocular image sequence: filenames + timestamps."""

    image_paths: list[str]
    timestamps: np.ndarray  # [N] float64 seconds
    start_frame: int = 0  # pt2/pt3/pt4-style mid-sequence starts (mono_ETH.cc:196-199)

    def __len__(self) -> int:
        return len(self.image_paths)

    def load_gray(self, idx: int) -> np.ndarray:
        """Load image `idx` as uint8 grayscale HxW."""
        return load_image_gray(self.image_paths[idx])

    def frames(self) -> Iterator[tuple[int, float, np.ndarray]]:
        for i in range(self.start_frame, len(self.image_paths)):
            yield i, float(self.timestamps[i]), self.load_gray(i)


def load_image_gray(path: str) -> np.ndarray:
    """uint8 grayscale loader: .npy natively, PNG/JPG through PIL."""
    if path.endswith(".npy"):
        img = np.load(path)
    else:
        from PIL import Image

        img = np.asarray(Image.open(path))
    if img.ndim == 3:
        # luma with the reference renderer's grayscale weights
        # (ShadingWithTexture.fragmentshader:15: 0.299 r + 0.587 g + 0.114 b)
        img = (
            0.299 * img[..., 0].astype(np.float32)
            + 0.587 * img[..., 1].astype(np.float32)
            + 0.114 * img[..., 2].astype(np.float32)
        )
    return np.clip(img, 0, 255).astype(np.uint8)


def load_eth_sequence(seq_dir: str, start_frame: int = 0, start_index: int = 1) -> Sequence:
    """ZU-MAV layout (reference: mono_ETH.cc:164-199): `<dir>/_times.txt`,
    images `<dir>/%05d.jpg` numbered from `start_index` (1 / 20513 / 52500 /
    68700 for the pt1-pt4 yaml variants). A `<dir>_times.txt` sibling file and
    an explicit `<dir>_files.txt` filename list are accepted too."""
    base = seq_dir.rstrip("/")
    times_path = os.path.join(base, "_times.txt")
    if not os.path.exists(times_path):
        times_path = base + "_times.txt"
    with open(times_path) as f:
        times = np.array([float(x) for x in f.read().split()], dtype=np.float64)
    files_list = base + "_files.txt"
    if os.path.exists(files_list):
        with open(files_list) as f:
            names = [ln.strip() for ln in f if ln.strip()]
    else:
        names = [f"{start_index + i:05d}.jpg" for i in range(len(times))]
    paths = [os.path.join(base, n) for n in names]
    n = min(len(paths), len(times))
    return Sequence(paths[:n], times[:n], start_frame=start_frame)


def load_newer_college_sequence(seq_dir: str, start_frame: int = 0) -> Sequence:
    """Newer College layout (reference: mono_newer_college.cc): an image folder
    with sortable filenames; timestamps from filenames `sec_nsec.png` or an
    index file."""
    base = seq_dir.rstrip("/")
    if os.path.exists(base + "_times.txt"):
        return load_eth_sequence(seq_dir, start_frame)
    names = sorted(n for n in os.listdir(base) if n.lower().endswith((".png", ".jpg", ".npy")))
    times = []
    for i, n in enumerate(names):
        stem = os.path.splitext(n)[0]
        parts = stem.replace("-", "_").split("_")
        try:
            sec, nsec = int(parts[0]), int(parts[1])
            times.append(sec + nsec * 1e-9)
        except (ValueError, IndexError):
            times.append(i / 30.0)
    return Sequence([os.path.join(base, n) for n in names], np.array(times, dtype=np.float64),
                    start_frame=start_frame)


def make_synthetic_sequence(
    out_dir: str,
    n_frames: int = 30,
    width: int = 320,
    height: int = 240,
    fps: float = 30.0,
    seed: int = 0,
    world: Optional["SyntheticWorld"] = None,  # noqa: F821
    device="cuda",
) -> tuple[Sequence, "SyntheticWorld"]:  # noqa: F821
    """Render a synthetic sequence of the point world (`io/synthetic.
    SyntheticWorld`, rendered on `device`) into `.npy` frames: the replay
    oracle with a known trajectory."""
    from orbslam2_nmi_torch.io.synthetic import SyntheticWorld

    world = world or SyntheticWorld.generate(seed=seed)
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    times = np.arange(n_frames, dtype=np.float64) / fps
    for i in range(n_frames):
        img = world.render_frame(i, n_frames, width, height, device=device)
        p = os.path.join(out_dir, f"{i:06d}.npy")
        np.save(p, img)
        paths.append(p)
    return Sequence(paths, times), world
