"""Offline ORB vocabulary builder (the reference ships a pre-trained ~1M-word
ORBvoc.txt instead: System.cc:87, Vocabulary/ORBvoc.txt.tar.gz).

Port of `orbslam2_nmi_tpu/tools/build_vocabulary.py`. It harvests ORB
descriptors (`ops/orb.extract_orb` on the device) from an image directory
(the ZU-MAV or Newer College layout) or from rendered synthetic frames,
trains a hierarchical k-medians tree on the host (`slam/vocabulary.py`), and
writes the `.npz` serialization or the DBoW2 interchange text format; the
files are the JAX package's formats, so either package reads the other's.
k=10, depth=6 gives the reference vocabulary's shape (10^6 words); the
defaults are sized for quick runs.

    python3 -m orbslam2_nmi_torch.tools.build_vocabulary \\
        --synthetic-frames 200 --k 10 --depth 4 --out voc.npz [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from orbslam2_nmi_torch import kernels
from orbslam2_nmi_torch.config import ORBConfig
from orbslam2_nmi_torch.ops.orb import extract_orb
from orbslam2_nmi_torch.slam.vocabulary import Vocabulary
from orbslam2_nmi_torch.utils.readback import to_host


def descriptors(img, cfg: ORBConfig, device) -> np.ndarray:
    """The valid ORB descriptors of one uint8 image (numpy or tensor) as
    [n, 8] uint32 rows."""
    feats = extract_orb(torch.as_tensor(img).to(device), cfg)
    return to_host(feats.desc).view(np.uint32)[to_host(feats.valid)]


def harvest_synthetic(n_frames: int, width: int, height: int, n_features: int, seed: int,
                      device="cuda") -> np.ndarray:
    """Descriptors of `n_frames` frames of point worlds seeded from `seed`
    (a world every 50 frames, for diversity)."""
    from orbslam2_nmi_torch.io.synthetic import SyntheticWorld

    device = kernels.resolve_device(device, "harvest_synthetic()")
    cfg = ORBConfig(n_features=n_features, n_levels=8)
    out = []
    n_worlds = max(1, n_frames // 50)
    per_world = n_frames // n_worlds
    for w in range(n_worlds):
        world = SyntheticWorld.generate(seed=seed + w)
        for i in range(per_world):
            out.append(descriptors(world.render_frame(i, per_world, width, height, device=device),
                                   cfg, device))
            print(f"\rworld {w + 1}/{n_worlds} frame {i + 1}/{per_world}", end="",
                  file=sys.stderr)
    print(file=sys.stderr)
    return np.concatenate(out)


def harvest_sequence(seq_dir: str, max_frames: int, n_features: int,
                     device="cuda") -> np.ndarray:
    """Descriptors of at most `max_frames` frames spread over an image
    sequence."""
    from orbslam2_nmi_torch.io import datasets

    device = kernels.resolve_device(device, "harvest_sequence()")
    cfg = ORBConfig(n_features=n_features, n_levels=8)
    try:
        seq = datasets.load_eth_sequence(seq_dir)
    except (FileNotFoundError, ValueError):
        seq = datasets.load_newer_college_sequence(seq_dir)
    step = max(1, len(seq) // max_frames)
    idxs = list(range(0, len(seq), step))[:max_frames]
    out = []
    for i, fi in enumerate(idxs):
        out.append(descriptors(seq.load_gray(fi), cfg, device))
        print(f"\rframe {i + 1}/{len(idxs)}", end="", file=sys.stderr)
    print(file=sys.stderr)
    return np.concatenate(out)


def ensure_circuit_vocabulary(k: int = 10, depth: int = 5, seed: int = 1, n_frames: int = 260,
                              path: str | None = None, circuit: str = "standard",
                              device="cuda") -> str:
    """Train (once, cached beside the replay's sequences) a large vocabulary
    from the synthetic circuit's own imagery and return its path: the
    System.cc:87 flow, a pre-trained vocabulary loaded before tracking
    starts, in place of the small tree `SLAMSystem.ensure_vocabulary` trains
    from the first keyframes. k=10, depth=5 gives up to 100k words (the
    reference's ORBvoc is k=10, depth=6). The descriptors come from every
    other frame of the 520-frame circuit at 960x540 (2,000 features)."""
    from orbslam2_nmi_torch.tools import replay_bench

    tag = "w" if circuit == "wide" else ""
    path = path or os.path.join(
        replay_bench.cache_dir(),
        f"voc_v{replay_bench.SEQ_VERSION}_{tag}k{k}d{depth}s{seed}_{n_frames}f.npz")
    if os.path.exists(path):
        return path
    world, frames = replay_bench.generate_sequence(520, 960, 540, seed=seed, circuit=circuit,
                                                   device=device)
    cfg = ORBConfig(n_features=2000, n_levels=8)
    descs = np.concatenate([descriptors(frames[i], cfg, frames.device)
                            for i in range(0, len(frames), max(1, len(frames) // n_frames))])
    del frames
    voc = Vocabulary.train(descs, k=k, depth=depth, seed=seed)
    tmp = path[: -len(".npz")] + f".tmp{os.getpid()}.npz"
    voc.save(tmp)
    os.replace(tmp, path)
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="train an ORB vocabulary")
    ap.add_argument("--sequence", help="image sequence dir")
    ap.add_argument("--synthetic-frames", type=int, default=0)
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=540)
    ap.add_argument("--n-features", type=int, default=2000)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", required=True, help=".npz or .txt (DBoW2 format)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the descriptors are extracted (default: cuda)")
    args = ap.parse_args(argv)

    t0 = time.time()
    if args.sequence:
        descs = harvest_sequence(args.sequence, 500, args.n_features, device=args.device)
    elif args.synthetic_frames:
        descs = harvest_synthetic(args.synthetic_frames, args.width, args.height,
                                  args.n_features, args.seed, device=args.device)
    else:
        ap.error("one of --sequence / --synthetic-frames is required")
    print(f"harvested {len(descs)} descriptors in {time.time() - t0:.1f}s", file=sys.stderr)

    t0 = time.time()
    voc = Vocabulary.train(descs, k=args.k, depth=args.depth, seed=args.seed)
    print(f"trained {voc.n_words}-word vocabulary (k={args.k}, depth={args.depth}) "
          f"in {time.time() - t0:.1f}s", file=sys.stderr)
    if args.out.endswith(".txt"):
        voc.save_dbow2_text(args.out)
    else:
        voc.save(args.out)
    print(f"saved {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
