"""Prior 3-D model loaders: OBJ mesh (+texture) and XYZRGB pointcloud.

A numpy copy of `orbslam2_nmi_tpu/io/model_loader.py`, kept in this package
so that the port imports nothing of the JAX package. It replaces the
reference's GL-oriented loaders (Thirdparty/Localization/objloader.cpp:44-223
for OBJ, objloader.cpp:225-264 for XYZ(+offset)+RGB, texture.cpp:31-229 for
BMP). Models are returned as flat numpy arrays ready for device upload: the
renderer consumes them as SoA buffers, not GL vertex objects.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass(frozen=True)
class MeshModel:
    """Triangle mesh with per-vertex UVs + a grayscale texture.

    The renderer samples the texture and converts to grayscale with the same
    luma weights as the reference's fragment shader
    (ShadingWithTexture.fragmentshader:15: 0.299 r + 0.587 g + 0.114 b).
    Frozen: the card keeps a mesh's arrays resident by mesh
    (`ops/raster.resident_mesh`), so a variant is a new mesh
    (`dataclasses.replace`), never a field assigned again.
    """

    vertices: np.ndarray  # [V, 3] float32, world frame
    uvs: np.ndarray  # [V, 2] float32 in [0,1]
    faces: np.ndarray  # [F, 3] int32 vertex indices
    texture_gray: np.ndarray  # [Th, Tw] float32 in [0,255]


@dataclass
class PointCloudModel:
    """XYZ + grayscale intensity pointcloud (RENDER_POINT_CLOUD mode)."""

    points: np.ndarray  # [P, 3] float32, world frame (offset already applied)
    gray: np.ndarray  # [P] float32 in [0,255]


def load_obj(path: str, texture_path: Optional[str] = None) -> MeshModel:
    """Minimal OBJ reader: v / vt / f (v/vt[/vn]) records.

    Faces with >3 vertices are fan-triangulated. Vertex/UV pairs are flattened so
    each face corner owns its UV (the reference does the same unindexed expansion,
    objloader.cpp:44-223); we then re-index to unique (v, vt) pairs.
    """
    positions: list[list[float]] = []
    uvs: list[list[float]] = []
    corner_map: dict[tuple[int, int], int] = {}
    out_verts: list[list[float]] = []
    out_uvs: list[list[float]] = []
    out_faces: list[list[int]] = []

    def corner_index(vi: int, ti: int) -> int:
        key = (vi, ti)
        idx = corner_map.get(key)
        if idx is None:
            idx = len(out_verts)
            corner_map[key] = idx
            out_verts.append(positions[vi])
            out_uvs.append(uvs[ti] if 0 <= ti < len(uvs) else [0.0, 0.0])
        return idx

    with open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "v" and len(t) >= 4:
                positions.append([float(t[1]), float(t[2]), float(t[3])])
            elif t[0] == "vt" and len(t) >= 3:
                uvs.append([float(t[1]), float(t[2])])
            elif t[0] == "f" and len(t) >= 4:
                corners = []
                for c in t[1:]:
                    parts = c.split("/")
                    vi = int(parts[0]) - 1
                    ti = int(parts[1]) - 1 if len(parts) > 1 and parts[1] else -1
                    corners.append(corner_index(vi, ti))
                for k in range(1, len(corners) - 1):
                    out_faces.append([corners[0], corners[k], corners[k + 1]])

    tex = load_texture_gray(texture_path) if texture_path else np.full((2, 2), 128.0, np.float32)
    return MeshModel(
        vertices=np.asarray(out_verts, dtype=np.float32).reshape(-1, 3),
        uvs=np.asarray(out_uvs, dtype=np.float32).reshape(-1, 2),
        faces=np.asarray(out_faces, dtype=np.int32).reshape(-1, 3),
        texture_gray=tex,
    )


def load_texture_gray(path: str) -> np.ndarray:
    """Texture -> grayscale float32 [0,255]. BMP/PNG via PIL, .npy natively."""
    if path.endswith(".npy"):
        img = np.load(path).astype(np.float32)
    else:
        from PIL import Image

        img = np.asarray(Image.open(path)).astype(np.float32)
    if img.ndim == 3:
        img = 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    return np.clip(img, 0.0, 255.0).astype(np.float32)


def load_xyz_pointcloud(path: str, offset_path: Optional[str] = None) -> PointCloudModel:
    """Read `x y z r g b` rows (+ optional 1-row offset file subtracted from XYZ),
    matching objloader.cpp:225-264's contract."""
    data = np.loadtxt(path, dtype=np.float64)
    if data.ndim == 1:
        data = data[None, :]
    xyz = data[:, :3].astype(np.float64)
    if offset_path:
        off = np.loadtxt(offset_path, dtype=np.float64).reshape(-1)[:3]
        xyz = xyz - off[None, :]
    if data.shape[1] >= 6:
        rgb = data[:, 3:6].astype(np.float32)
        gray = 0.299 * rgb[:, 0] + 0.587 * rgb[:, 1] + 0.114 * rgb[:, 2]
        if gray.max() <= 1.0 + 1e-6:
            gray = gray * 255.0
    else:
        gray = np.full(len(xyz), 128.0, np.float32)
    return PointCloudModel(points=xyz.astype(np.float32), gray=gray.astype(np.float32))


def save_xyz_pointcloud(path: str, points: np.ndarray, colors: Optional[np.ndarray] = None,
                        fmt: str = "%.6f"):
    """Write `x y z [r g b]` rows — the map-dump format of Tracking::PrintMapPoints
    (reference: src/Tracking.cc:2422-2449). `fmt` formats every number
    ("%.17g" writes float64 values that read back exactly)."""
    pts = np.asarray(points, dtype=np.float64).reshape(-1, 3)
    if colors is None:
        np.savetxt(path, pts, fmt=fmt)
    else:
        cols = np.asarray(colors).reshape(-1, 3)
        np.savetxt(path, np.hstack([pts, cols]), fmt=fmt)
