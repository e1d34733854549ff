"""Fixtures and scenes shared by the port's tests (tests/test_torch_*.py).

Whether a card is present is decided inside the fixture, never while a test
module is imported, so every pytest-xdist worker collects the same tests.
"""

import numpy as np
import pytest
import torch

from orbslam2_nmi_torch.io.model_loader import MeshModel
from orbslam2_nmi_torch.ops import raster

# The suite runs in several worker processes at once (pytest-xdist). Torch's
# CPU ops would each start a thread per core in every worker, and the
# oversubscribed threads then wait on each other: one thread a worker.
THREADS = 1
torch.set_num_threads(THREADS)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def make_world(n=20000, seed=0):
    """tests/test_nmi.py:make_world's textured point world (strong depth
    structure), as numpy (points [n, 3], gray [n]) float32 arrays."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-18, 18, n)
    y = rng.uniform(-12, 12, n)
    z = rng.uniform(8, 24, n) + 4.0 * np.sin(x * 0.7) * np.cos(y * 0.5)
    pts = np.stack([x, y, z], axis=-1).astype(np.float32)
    gray = (np.sin(pts[:, 0] * 2.1) * np.cos(pts[:, 1] * 1.7) * 100 + 128).clip(0, 255)
    return pts, gray.astype(np.float32)


def height_field_mesh(n=40, seed=3):
    """tests/test_raster.py:144-169's textured height field, as numpy arrays
    (vertices, uvs, faces, texture)."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(-12, 12, n)
    ys = np.linspace(-6, 6, n)
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    Z = 10.0 + 0.8 * np.sin(X * 0.9) * np.cos(Y * 1.1)
    verts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], -1).astype(np.float32)
    uvs = np.stack([(X.ravel() - xs[0]) / (xs[-1] - xs[0]),
                    (Y.ravel() - ys[0]) / (ys[-1] - ys[0])], -1).astype(np.float32)
    ii, jj = np.meshgrid(np.arange(n - 1), np.arange(n - 1), indexing="ij")
    a = (ii * n + jj).ravel()
    faces = np.concatenate([np.stack([a, a + 1, a + n + 1], -1),
                            np.stack([a, a + n + 1, a + n], -1)]).astype(np.int32)
    return verts, uvs, faces, rng.uniform(10, 245, (64, 64)).astype(np.float32)


# the camera of tests/test_raster.py:170, for height_field_mesh (near/far 1/50 m)
MESH_CAMERA = dict(fx=100.0, fy=100.0, cx=128.0, cy=24.0, width=256, height=48)


def mesh_frame(mesh, device="cpu"):
    """The port's render of `mesh` (height_field_mesh's arrays) at Tcw = I
    through MESH_CAMERA: [48, 256] f32 on `device`."""
    c = MESH_CAMERA
    K = np.array([[c["fx"], 0, c["cx"]], [0, c["fy"], c["cy"]], [0, 0, 1]], np.float32)
    b = raster.bin_mesh(MeshModel(*mesh), np.eye(4, dtype=np.float32), K, c["height"],
                        c["width"], 1.0, 50.0, device=device)
    return raster.render_mesh_grid(b, torch.eye(4), K, torch.zeros(1, 3), 1.0, 50.0)[0]


# The reduced tracking scene of the fused-step tests: the circuit on a 60x60
# terrain grid at half the full camera's width and focal length (480x270, fx
# 225, so the field of view is the full camera's), 500 features on 8 levels,
# 256 local-map candidates, seeded from ground truth like tracking_entry().
TRACK_SCENE = dict(height=270, width=480, n_grid=60, fx=225.0, n_features=500, n_cand=256)


def tracking_scene(count=5, device="cpu"):
    """`entry.tracking_entry` on the reduced scene: (step, frames, carry0,
    candidates, poses_gt), frames 8 .. 8+count-1 of the 520-frame circuit."""
    from orbslam2_nmi_torch.entry import tracking_entry
    from orbslam2_nmi_torch.io.synthetic import SyntheticMeshWorld, terrain_mesh

    s = TRACK_SCENE
    world = SyntheticMeshWorld(mesh=terrain_mesh(seed=0, n=s["n_grid"]), fx=s["fx"])
    return tracking_entry(device=device, height=s["height"], width=s["width"], count=count,
                          world=world, n_features=s["n_features"], n_cand=s["n_cand"])
