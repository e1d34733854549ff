"""The binning on the card (`raster.bin_mesh` on a CUDA device: kernels
`bin_count` and `bin_fill`) against the host binning (`device=None`), and the
mesh's resident arrays.

On the CPU (tier 1): `MeshModel` is frozen; the resident arrays take CUDA
devices only, and malformed meshes, images with no tiles or too many, and
spans past `bin_fill`'s passes raise before anything touches the device;
the CPU binning launches no kernel.

On the card (marker `gpu`): the resident arrays are built once per (mesh,
device) and reused, hold the mesh's arrays and `_downsample_texture`'s
padded texture, and leave with the mesh; the device binning equals the host
binning bit for bit (`tri_ids`, `tri_data`, `capacity`, `overflow`, the tile
counts) at 960x540 and 240x135, on six circuit poses of the 71,442-face
synthetic terrain, with the mesh-reloc cell's margins (0.2, 0.2, 0.5) m and
with none, once numpy's BLAS is seen to project in the order the kernel
copies, and on a dense patch that overflows MAX_CAPACITY; renders from the
two binnings are equal; one sweep on the card launches each binning kernel
once.
"""

import dataclasses
import gc
from fractions import Fraction

import numpy as np
import pytest
import torch
from torch_port_fixtures import MESH_CAMERA, cuda_device, height_field_mesh  # noqa: F401

from orbslam2_nmi_torch import kernels
from orbslam2_nmi_torch.config import CameraConfig, NMIConfig, NMIGridConfig
from orbslam2_nmi_torch.io.model_loader import MeshModel
from orbslam2_nmi_torch.io.synthetic import SyntheticMeshWorld
from orbslam2_nmi_torch.ops import raster, render
from orbslam2_nmi_torch.slam.nmi.localizer import NMILocalizer
from orbslam2_nmi_torch.utils import profiling

NEAR, FAR = 5.0, 30.0  # the mesh-reloc cell's near and far
CELL_MARGIN = (0.2, 0.2, 0.5)  # the cell's translation steps: its grid's largest offsets
CIRCUIT = (0, 87, 173, 260, 347, 433)  # frames of the 520-frame circuit
DENSE_K = np.array([[100.0, 0, 128.0], [0, 100.0, 24.0], [0, 0, 1]], np.float32)


@pytest.fixture(scope="module")
def terrain():
    return SyntheticMeshWorld.generate()


def dense_patch(n=40) -> MeshModel:
    """3,042 faces in a 4x4-pixel patch at 10 m across the corner of four
    tiles (x = 128, y = 16 at 256x48 under DENSE_K): every tile holds more
    than MAX_CAPACITY faces, reached in several passes."""
    xs = np.linspace(-0.1, 0.1, n)
    ys = np.linspace(-0.9, -0.7, n)
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    verts = np.stack([X.ravel(), Y.ravel(), np.full(X.size, 10.0)], -1).astype(np.float32)
    uvs = np.stack([(X.ravel() + 0.1) / 0.2, (Y.ravel() + 0.9) / 0.2], -1).astype(np.float32)
    ii, jj = np.meshgrid(np.arange(n - 1), np.arange(n - 1), indexing="ij")
    a = (ii * n + jj).ravel()
    faces = np.concatenate([np.stack([a, a + 1, a + n + 1], -1),
                            np.stack([a, a + n + 1, a + n], -1)]).astype(np.int32)
    tex = np.random.default_rng(0).uniform(0, 255, (32, 32)).astype(np.float32)
    return MeshModel(verts, uvs, faces, tex)


def small_mesh(tex_hw=(600, 1100)) -> MeshModel:
    verts, uvs, faces, _ = height_field_mesh(n=8)
    tex = np.random.default_rng(1).uniform(0, 255, tex_hw).astype(np.float32)
    return MeshModel(verts, uvs, faces, tex)


# ---------------------------------------------------------------- the CPU


def test_mesh_model_is_frozen():
    """The resident arrays are kept by mesh, so a mesh's fields are never
    assigned again: a variant is a new mesh."""
    mesh = small_mesh()
    with pytest.raises(dataclasses.FrozenInstanceError):
        mesh.texture_gray = mesh.texture_gray[:128, :128]
    variant = dataclasses.replace(mesh, texture_gray=mesh.texture_gray[:128, :128])
    assert variant is not mesh and variant.vertices is mesh.vertices


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")])
def test_resident_mesh_takes_cuda_devices_only(device):
    with pytest.raises(ValueError, match="CUDA device"):
        raster.resident_mesh(small_mesh(), device)


@pytest.mark.parametrize("fault", ["index_past_vertices", "negative_index", "faces_not_3",
                                   "no_faces", "verts_not_3", "uvs_short"])
def test_resident_mesh_rejects_malformed_meshes(fault):
    """The checks run before anything touches the device, so they raise
    here without one."""
    verts, uvs, faces, tex = height_field_mesh(n=6)
    if fault == "index_past_vertices":
        faces = faces.copy()
        faces[3, 1] = len(verts)
    elif fault == "negative_index":
        faces = faces.copy()
        faces[0, 0] = -1
    elif fault == "faces_not_3":
        faces = np.concatenate([faces, faces[:, :1]], 1)
    elif fault == "no_faces":
        faces = faces[:0]
    elif fault == "verts_not_3":
        verts = verts[:, :2]
    else:
        uvs = uvs[:-1]
    mesh = MeshModel(verts, uvs, faces, tex)
    with pytest.raises(ValueError):
        raster.resident_mesh(mesh, "cuda:0")
    assert not any(key[0] == id(mesh) for key in raster._RESIDENT)


@pytest.mark.parametrize("hw", [(0, 256), (48, 0), (48, raster.TILE_W * 40000)],
                         ids=["no_height", "no_width", "too_wide"])
def test_card_binning_checks_the_image(hw):
    """An image with no tiles, or with more per axis than `bin_count`'s
    packed spans hold, raises before the mesh goes to the device."""
    mesh = small_mesh(tex_hw=(64, 64))
    with pytest.raises(ValueError, match="tiles per axis"):
        raster.bin_mesh(mesh, np.eye(4), DENSE_K, *hw, NEAR, FAR, device="cuda:0")
    assert not any(key[0] == id(mesh) for key in raster._RESIDENT)


@pytest.mark.parametrize("max_sx, max_sy", [(200, 200), (1, raster.MAX_PASSES + 1)])
def test_bin_fill_checks_its_passes(max_sx, max_sy):
    """Spans that need more (dy, dx) passes than `bin_fill` counts in shared
    memory raise before the launch."""
    verts, uvs, faces, tex = height_field_mesh(n=6)
    res = raster.ResidentMesh(torch.from_numpy(verts), torch.from_numpy(uvs),
                              torch.from_numpy(faces.astype(np.int32)), torch.from_numpy(tex),
                              tex.shape)
    spans = torch.zeros((len(faces), 2), dtype=torch.int32)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="passes"):
        raster._bin_fill(res, spans, 300, 300, max_sx, max_sy, 128)
    assert kernels.LAUNCHES["bin_fill"] == 0


def test_cpu_binning_launches_no_kernel(terrain):
    """`device="cpu"` and `device=None` take the host binning: the same
    arrays, and no launch of either binning kernel."""
    K = terrain.camera_K(240, 135)
    T = terrain.pose_at(CIRCUIT[2], 520)
    kernels.reset_launches()
    host = raster.bin_mesh(terrain.mesh, T, K, 135, 240, NEAR, FAR, max_offset=CELL_MARGIN,
                           device=None)
    cpu = raster.bin_mesh(terrain.mesh, T, K, 135, 240, NEAR, FAR, max_offset=CELL_MARGIN,
                          device="cpu")
    assert kernels.LAUNCHES["bin_count"] == kernels.LAUNCHES["bin_fill"] == 0
    assert isinstance(cpu.tri_data, torch.Tensor) and cpu.tri_data.device.type == "cpu"
    for k in raster._ARRAY_FIELDS:
        assert np.array_equal(getattr(host, k), getattr(cpu, k).numpy()), k
    assert cpu._replace(**{k: None for k in raster._ARRAY_FIELDS}) == \
        host._replace(**{k: None for k in raster._ARRAY_FIELDS})


# ---------------------------------------------------------------- the card


def assert_blas_projection_order(mesh, T):
    """Kernel `bin_count` projects in the order numpy's OpenBLAS gives
    `v @ R.T + t`: fma(Z, r2, fma(Y, r1, X * r0)) + t, each step rounded
    once. A BLAS of another order moves the host's projection in the last
    bit, and the parity would then fail with no fault in the kernel."""
    T = np.asarray(T, np.float64)
    R, t = T[:3, :3], T[:3, 3]
    v = mesh.vertices[:: max(len(mesh.vertices) // 64, 1)].astype(np.float64)

    def fma(a, b, c):  # a * b + c, rounded once
        return float(Fraction(a) * Fraction(b) + Fraction(c))

    fused = np.array([[fma(z, R[j, 2], fma(y, R[j, 1], x * R[j, 0])) + t[j] for j in range(3)]
                      for x, y, z in v.tolist()])
    assert np.array_equal(v @ R.T + t, fused), (
        "numpy's BLAS does not compute v @ R.T in the order fma(Z, r2, fma(Y, r1, X * r0)) "
        "that kernel bin_count copies: the host and card binnings may differ in the last bit "
        "of a projection with no fault in the kernel")


@pytest.mark.gpu
def test_resident_arrays_are_built_once_per_mesh_and_device(cuda_device):  # noqa: F811
    mesh = small_mesh()
    res = raster.resident_mesh(mesh, cuda_device)
    here = torch.device("cuda", torch.cuda.current_device())
    assert raster.resident_mesh(mesh, here) is res
    assert [key[1] for key in raster._RESIDENT if key[0] == id(mesh)] == [here]
    tex_pad, tex_hw = raster._downsample_texture(mesh.texture_gray, raster.MAX_TEX_DIM)
    assert res.tex_hw == tex_hw == (150, 275)
    assert torch.equal(res.texture.cpu(), torch.from_numpy(tex_pad))
    assert torch.equal(res.verts.cpu(), torch.from_numpy(mesh.vertices))
    assert torch.equal(res.uvs.cpu(), torch.from_numpy(mesh.uvs))
    assert res.faces.dtype == torch.int32
    assert torch.equal(res.faces.cpu(), torch.from_numpy(mesh.faces))
    twin = MeshModel(mesh.vertices, mesh.uvs, mesh.faces, mesh.texture_gray)
    assert raster.resident_mesh(twin, cuda_device) is not res  # one entry per mesh object
    key = id(mesh)
    del mesh, res
    gc.collect()
    assert not any(k[0] == key for k in raster._RESIDENT)  # the entry left with its mesh


def assert_same_binning(dev, host):
    """`dev` (tensors on the card) equals `host` (numpy) bit for bit."""
    scalars = ("tex_hw", "tiles_y", "tiles_x", "height", "width", "capacity", "overflow")
    assert [getattr(dev, k) for k in scalars] == [getattr(host, k) for k in scalars]
    for k in raster._ARRAY_FIELDS:
        a, b = getattr(dev, k).cpu().numpy(), getattr(host, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a.view(np.int32), b.view(np.int32)), k


@pytest.mark.gpu
@pytest.mark.parametrize("margin", [CELL_MARGIN, 0.0], ids=["cell_margin", "no_margin"])
@pytest.mark.parametrize("hw", [(540, 960), (135, 240)], ids=["960x540", "240x135"])
def test_device_binning_equals_host(cuda_device, terrain, hw, margin):  # noqa: F811
    h, w = hw
    K = terrain.camera_K(w, h)
    offsets = render.translation_grid_offsets((3, 3, 3), CELL_MARGIN, device=cuda_device)
    assert_blas_projection_order(terrain.mesh, terrain.pose_at(CIRCUIT[1], 520))
    for i in CIRCUIT:
        T = terrain.pose_at(i, 520)
        host = raster.bin_mesh(terrain.mesh, T, K, h, w, NEAR, FAR, max_offset=margin,
                               device=None)
        dev = raster.bin_mesh(terrain.mesh, T, K, h, w, NEAR, FAR, max_offset=margin,
                              device=cuda_device)
        assert host.overflow == 0 and host.tri_data[:, 15].any(), i
        assert_same_binning(dev, host)
        images = [raster.render_mesh_grid(b, T, K, offsets, NEAR, FAR)
                  for b in (dev, raster.to_device(host, cuda_device))]
        assert torch.equal(images[0], images[1]), i


@pytest.mark.gpu
def test_device_binning_keeps_the_host_overflow(cuda_device):  # noqa: F811
    mesh = dense_patch()
    eye = np.eye(4, dtype=np.float32)
    host = raster.bin_mesh(mesh, eye, DENSE_K, 48, 256, 1.0, 50.0, device=None)
    dev = raster.bin_mesh(mesh, eye, DENSE_K, 48, 256, 1.0, 50.0, device=cuda_device)
    assert host.capacity == raster.MAX_CAPACITY and host.overflow > 0
    assert_same_binning(dev, host)
    zero = torch.zeros((1, 3), device=cuda_device)
    assert torch.equal(raster.render_mesh_grid(dev, eye, DENSE_K, zero, 1.0, 50.0),
                       raster.render_mesh_grid(raster.to_device(host, cuda_device), eye,
                                               DENSE_K, zero, 1.0, 50.0))


@pytest.mark.gpu
def test_one_sweep_launches_each_binning_kernel_once(cuda_device):  # noqa: F811
    """A sweep on the card launches `bin_count` and `bin_fill` once each and
    renders from the resident arrays, which the localizer uploaded in its
    set-up; the same sweep on the CPU launches neither."""
    mesh = MeshModel(*height_field_mesh())
    cfg = NMIConfig(grid=NMIGridConfig(synth_num=(3, 1, 1), warp_num=(1, 1, 1),
                                       synth_step=(0.4, 0.4, 0.4), warp_step=(0.03,) * 3),
                    render_near=1.0, render_far=50.0)
    T = np.eye(4, dtype=np.float32)
    frame = torch.zeros((MESH_CAMERA["height"], MESH_CAMERA["width"]))
    for dev, n in ((cuda_device, 1), ("cpu", 0)):
        loc = NMILocalizer(cfg, CameraConfig(**MESH_CAMERA), None, mesh=mesh, device=dev)
        kernels.reset_launches()
        loc.evaluate_grid(frame, T, loc.initial_kernel)
        assert kernels.LAUNCHES["bin_count"] == kernels.LAUNCHES["bin_fill"] == n, dev
        if n:
            assert "nmi.mesh_upload" in profiling.SETUP
            res = raster.resident_mesh(mesh, dev)
            sweep = loc.prepare_sweep(frame, T, loc.initial_kernel)
            assert sweep.binned.verts is res.verts and sweep.binned.texture is res.texture
