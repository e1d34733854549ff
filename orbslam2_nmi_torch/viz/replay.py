"""Headless visualization: trajectory and map plots, frame overlays.

Port of `orbslam2_nmi_tpu/viz/replay.py`. It replaces the reference's
Pangolin Viewer, FrameDrawer and MapDrawer threads (src/Viewer.cc:57,
src/FrameDrawer.cc, src/MapDrawer.cc) with images written to files, since a
server has no display:
  * MapDrawer colors the NMI-relocalized keyframes apart (FORK,
    src/MapDrawer.cc): so does `plot_map_topdown`;
  * FrameDrawer draws the tracked keypoints on the camera image:
    `draw_frame`.
Every function takes host numpy arrays and builds the image in numpy. The
images are PNG files where PIL is installed, else `.npy` arrays (the path
name with `.npy` appended), as in the JAX package.
"""

from __future__ import annotations

import numpy as np


def _save_image(path: str, rgb: np.ndarray):
    try:
        from PIL import Image

        Image.fromarray(rgb.astype(np.uint8)).save(path)
    except ImportError:
        np.save(path + ".npy", rgb.astype(np.uint8))


def draw_frame(gray: np.ndarray, xy: np.ndarray, tracked: np.ndarray, path: str,
               radius: int = 2):
    """FrameDrawer::Update: a green box on each tracked keypoint, a gray one
    on the others."""
    h, w = gray.shape
    rgb = np.stack([gray] * 3, axis=-1).astype(np.float32)
    for (x, y), ok in zip(xy.astype(int), tracked):
        if not (0 <= x < w and 0 <= y < h):
            continue
        color = (0.0, 255.0, 0.0) if ok else (120.0, 120.0, 120.0)
        x0, x1 = max(x - radius, 0), min(x + radius + 1, w)
        y0, y1 = max(y - radius, 0), min(y + radius + 1, h)
        rgb[y0:y1, x0, :] = color
        rgb[y0:y1, x1 - 1, :] = color
        rgb[y0, x0:x1, :] = color
        rgb[y1 - 1, x0:x1, :] = color
    _save_image(path, rgb)


def plot_map_topdown(map_store, path: str, trajectory: list | None = None, size: int = 900,
                     axes: tuple[int, int] = (0, 2)):
    """MapDrawer as a top-down raster of a `slam/map_store.MapStore`: map
    points (white), keyframes (blue), NMI-relocalized keyframes (red, the
    fork's coloring), the trajectory's camera centres (green; rows as
    `SLAMSystem.full_trajectory` gives them)."""
    ax, ay = axes
    pts = map_store.mp_pos[map_store.valid_point_indices()]
    kfs = map_store.valid_keyframe_indices()
    centers = []
    for k in kfs:
        T = map_store.kf_Tcw[k]
        centers.append(-T[:3, :3].T @ T[:3, 3])
    centers = np.array(centers) if len(centers) else np.zeros((0, 3))
    traj = []
    if trajectory:
        for row in trajectory:
            T = row[2]
            traj.append(-T[:3, :3].T @ T[:3, 3])
    traj = np.array(traj) if traj else np.zeros((0, 3))

    parts = [p for p in (pts, centers, traj) if len(p)]
    if not parts:  # an empty map draws nothing (the JAX function raises there)
        return
    allpts = np.concatenate(parts, axis=0)
    lo = allpts[:, [ax, ay]].min(0) - 1
    hi = allpts[:, [ax, ay]].max(0) + 1
    span = np.maximum(hi - lo, 1e-6)
    img = np.zeros((size, size, 3), np.float32)

    def to_px(p):
        q = (p[[ax, ay]] - lo) / span * (size - 1)
        return int(q[1]), int(q[0])

    for p in pts:
        r, c = to_px(p)
        img[size - 1 - r, c] = np.maximum(img[size - 1 - r, c], 180.0)
    for p in traj:
        r, c = to_px(p)
        img[size - 1 - r, c] = (0, 255, 0)
    for i, p in enumerate(centers):
        r, c = to_px(p)
        color = (255, 60, 60) if map_store.kf_nmi_reloc[kfs[i]] else (80, 120, 255)
        rr = slice(max(size - 1 - r - 2, 0), min(size - 1 - r + 3, size))
        cc = slice(max(c - 2, 0), min(c + 3, size))
        img[rr, cc] = color
    _save_image(path, img)


def save_nmi_debug_overlay(camera_gray: np.ndarray, synth_gray: np.ndarray, path: str):
    """The reference's saveImage debug overlay (ioData.cpp:266-347): the camera
    in the red channel, the synthetic render in the green one, so alignment
    shows as yellow."""
    h = min(camera_gray.shape[0], synth_gray.shape[0])
    w = min(camera_gray.shape[1], synth_gray.shape[1])
    rgb = np.zeros((h, w, 3), np.float32)
    rgb[..., 0] = camera_gray[:h, :w]
    rgb[..., 1] = synth_gray[:h, :w]
    _save_image(path, rgb)
