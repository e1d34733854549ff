"""The point splat's kernels (`csrc/splat.cu`: `splat_scatter`, `splat_resolve`)
against its plain torch version (`ops/render.splat_keys_plain`,
`resolve_keys_plain`).

On the card (`-m gpu`) the kernels must equal the plain version on the card
bit for bit: the key buffer before the resolve, and the images after it, at
point sizes 1, 3 and 5, for the translation grid (27 candidates at 960x540)
and for one render (`render_pointcloud`), and on edge cases: a ragged point
count, points behind the camera and under the depth floor, points exactly at
near and far, projections exactly on half-pixel edges (round half to even),
equal keys on one pixel, an occlusion pair, an empty cloud and a cloud out of
view. On the CPU: what each edge case renders by the plain version, and that
a CPU tensor never reaches the kernel library.
"""

import numpy as np
import pytest
import torch
from torch_port_fixtures import cuda_device, make_world  # noqa: F401  (fixture)

from orbslam2_nmi_torch import convert, kernels
from orbslam2_nmi_torch.geometry import se3
from orbslam2_nmi_torch.ops import render

BIG = 2**30
# the edge cases' camera: with z = 8 and fx = 128, x = (u - cx) / 16 projects
# to u exactly
EH, EW = 64, 96
EK = np.array([[128.0, 0, EW / 2], [0, 128.0, EH / 2], [0, 0, 1]], np.float32)
EDGE_NEAR, EDGE_FAR = 1.0, 30.0
# the main path's camera (ZU-MAV) and grid
H, W = 540, 960
K = np.array([[435.05, 0, 480.0], [0, 435.05, 270.0], [0, 0, 1]], np.float32)
NEAR, FAR = 5.0, 30.0


def _pose(seed):
    rng = np.random.default_rng(seed)
    T = torch.eye(4)
    T[:3, :3] = se3.so3_exp(torch.from_numpy(rng.normal(size=3).astype(np.float32) * 0.05))
    T[:3, 3] = torch.from_numpy(rng.normal(size=3).astype(np.float32) * 0.3)
    return T


def _at(us, vs, z=8.0):
    """Points at depth z that project to (u, v) exactly under EK."""
    us, vs = np.asarray(us, np.float64), np.asarray(vs, np.float64)
    return np.stack([(us - EW / 2) * z / 128.0, (vs - EH / 2) * z / 128.0,
                     np.full(us.shape, z)], -1).astype(np.float32)


def _f32(*v):
    return np.array(v, np.float32)


def _edge_cases():
    """{name: (points [P, 3], gray [P], near)}, each at R = I, t = 0."""
    near_up = np.nextafter(np.float32(EDGE_NEAR), np.float32(np.inf))
    far_down = np.nextafter(np.float32(EDGE_FAR), np.float32(0))
    pts, gray = make_world(256 * 40 + 37, seed=3)
    return {
        # not a multiple of the scatter's 256-thread block
        "ragged": (pts - _f32(0, 0, 4), gray, EDGE_NEAR),
        # behind the camera, at z = 0, and under the 1e-6 depth floor with
        # near = 0 (that one renders, at the centre)
        "behind": (np.array([[0.0, 0.0, -5.0], [0.1, 0.1, 0.0], [0.0, 0.0, 5e-7]], np.float32),
                   _f32(10, 20, 30), 0.0),
        # exactly at near and far (not rendered), and one ulp inside each
        "near_far": (np.array([[0, 0, EDGE_NEAR], [0.01, 0.01, EDGE_FAR], [0.05, 0, near_up],
                               [0, 0.05, far_down]], np.float32), _f32(10, 20, 30, 40),
                     EDGE_NEAR),
        # u and v exactly on the half-pixel edges: -0.5 -> 0 and 0.5 -> 0,
        # 1.5 -> 2, W - 1.5 -> W - 2, W - 0.5 -> W (outside)
        "half_pixel": (_at([-0.5, 0.5, 1.5, EW - 1.5, EW - 0.5, 10, 10, 10, 10, 10],
                           [10, 10, 10, 10, 10, -0.5, 0.5, 1.5, EH - 1.5, EH - 0.5]),
                       _f32(*range(11, 21)), EDGE_NEAR),
        # one key twice on a pixel, and two depths' equal keys beside it
        "equal_keys": (np.concatenate([_at([20, 20, 40], [30, 30, 30]),
                                       _at([40], [30], z=8.0000005)]),
                       _f32(77, 77, 90, 90), EDGE_NEAR),
        # the nearer of two points on one pixel wins
        "occlusion": (np.concatenate([_at([30], [20], z=16.0), _at([30], [20])]),
                      _f32(200, 50), EDGE_NEAR),
        "empty": (np.zeros((0, 3), np.float32), np.zeros((0,), np.float32), EDGE_NEAR),
        "out_of_view": (_at(np.linspace(-50, -2, 64), np.full(64, 10.0)), np.full(64, 9.0,
                                                                                  np.float32),
                        EDGE_NEAR),
    }


EDGE_CASES = _edge_cases()


def _edge_keys(name, dev, plain):
    pts, gray, near = EDGE_CASES[name]
    m = convert.render_model_from_numpy(pts, gray, dev)
    eye, t0 = torch.eye(3, device=dev), torch.zeros((1, 3), device=dev)
    fn = render.splat_keys_plain if plain else render.splat_keys
    return fn(m.points, m.gray, eye, t0, EK, EH, EW, near, EDGE_FAR)[0]


def _hits(keys):
    """{(v, u): gray} of the pixels a key landed on."""
    v, u = np.nonzero(keys < BIG)
    return {(int(a), int(b)): int(keys[a, b] % 256) for a, b in zip(v, u)}


@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_edge_cases_render_as_stated(name):
    """The plain version on the CPU lands each edge case where its comment
    says, so the card's comparison exercises those edges."""
    keys = _edge_keys(name, "cpu", plain=True).numpy()
    hits = _hits(keys)
    if name == "ragged":
        assert len(hits) > 500
    elif name == "behind":
        assert hits == {(EH // 2, EW // 2): 30}
    elif name == "near_far":
        assert sorted(hits.values()) == [30, 40]
    elif name == "half_pixel":
        # -0.5 and 0.5 share pixel 0 at one depth: the lower gray wins
        assert hits == {(10, 0): 11, (10, 2): 13, (10, EW - 2): 14,
                        (0, 10): 16, (2, 10): 18, (EH - 2, 10): 19}
    elif name == "equal_keys":
        assert hits == {(30, 20): 77, (30, 40): 90}
        zq = [int(keys[30, u]) // 256 for u in (20, 40)]
        assert zq[0] == zq[1]  # both depths quantize alike: the keys are equal
    elif name == "occlusion":
        assert hits == {(20, 30): 50}
    else:
        assert hits == {}
    for size in (1, 3, 5):
        img = render.resolve_keys_plain(torch.from_numpy(keys), size, 7.5).numpy()
        assert ((img == 7.5) == (render._min_pool(torch.from_numpy(keys), size).numpy()
                                 == BIG)).all()


def test_cpu_tensor_never_loads_the_kernel_library(monkeypatch):
    """Every render on CPU tensors takes the torch ops: the library is never
    loaded and nothing is launched."""
    def refuse(*a, **kw):
        raise AssertionError("the kernel library was reached from CPU tensors")

    monkeypatch.setattr(kernels, "lib", refuse)
    monkeypatch.setattr(kernels, "launch", refuse)
    before = dict(kernels.LAUNCHES)
    pts, gray = make_world(5000, seed=1)
    m = convert.render_model_from_numpy(pts, gray, "cpu")
    offsets = render.translation_grid_offsets((3, 1, 1), (0.3,) * 3, device="cpu")
    grid = render.render_translation_grid(m, _pose(4), K, offsets, 60, 80, 1.0, 30.0, 3)
    one = render.render_pointcloud(m, _pose(4), K, 60, 80, 1.0, 30.0, 3)
    T = _pose(4)
    plain = render.resolve_keys_plain(render.splat_keys_plain(
        m.points, m.gray, T[:3, :3], T[:3, 3][None, :] - offsets, K, 60, 80, 1.0, 30.0), 3, 0.0)
    assert torch.equal(grid, plain) and grid.shape == (3, 60, 80) and one.shape == (60, 80)
    assert dict(kernels.LAUNCHES) == before


# --- on the card -------------------------------------------------------------


def _equal(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("point_size", [1, 3, 5])
def test_grid_keys_and_images_match_plain_on_card(cuda_device, point_size, record_property):
    """27 candidates at 960x540 on 400,000 points: the key buffer and the
    images equal the plain version's on the card, bit for bit."""
    pts, gray = make_world(400_000, seed=11)
    m = convert.render_model_from_numpy(pts, gray, cuda_device)
    T = _pose(5).to(cuda_device)
    offsets = render.translation_grid_offsets((3, 3, 3), (0.2, 0.2, 0.5), device=cuda_device)
    t_all = T[:3, 3][None, :] - offsets
    keys = render.splat_keys(m.points, m.gray, T[:3, :3], t_all, K, H, W, NEAR, FAR)
    plain = render.splat_keys_plain(m.points, m.gray, T[:3, :3], t_all, K, H, W, NEAR, FAR)
    record_property("key_mismatch", int((keys != plain).sum()))
    assert _equal(keys, plain)
    assert 0.3 < float((keys < BIG).float().mean()) < 1.0
    img = render.resolve_keys(keys, point_size, 0.0)
    assert _equal(img, render.resolve_keys_plain(plain, point_size, 0.0))
    grid = render.render_translation_grid(m, T, K, offsets, H, W, NEAR, FAR, point_size)
    assert _equal(grid, img)


@pytest.mark.gpu
@pytest.mark.parametrize("point_size", [1, 3, 5])
def test_render_pointcloud_matches_plain_on_card(cuda_device, point_size):
    """One render (S = 1, t unshifted: `se3_apply`'s arithmetic) equals the
    plain version's, and the grid's candidate at a zero offset."""
    pts, gray = make_world(200_000, seed=12)
    m = convert.render_model_from_numpy(pts, gray, cuda_device)
    T = _pose(6).to(cuda_device)
    one = render.render_pointcloud(m, T, K, H, W, NEAR, FAR, point_size, background=3.25)
    keys = render.splat_keys_plain(m.points, m.gray, T[:3, :3], T[:3, 3][None, :], K, H, W,
                                   NEAR, FAR)
    assert _equal(one, render.resolve_keys_plain(keys, point_size, 3.25)[0])
    zero = torch.zeros((1, 3), device=cuda_device)
    grid = render.render_translation_grid(m, T, K, zero, H, W, NEAR, FAR, point_size)
    assert _equal(torch.where(one == 3.25, 0.0, one), grid[0])


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_edge_cases_match_plain_on_card(cuda_device, name):
    kernels.reset_launches()
    keys = _edge_keys(name, cuda_device, plain=False)
    # an empty cloud lands nothing, so nothing is launched for it
    assert kernels.LAUNCHES["splat_scatter"] == (0 if name == "empty" else 1)
    plain = _edge_keys(name, cuda_device, plain=True)
    assert _equal(keys, plain)
    for size in (1, 3, 5):
        assert _equal(render.resolve_keys(keys[None], size, 7.5),
                      render.resolve_keys_plain(plain[None], size, 7.5))


@pytest.mark.gpu
def test_one_launch_of_each_kernel_a_render_call(cuda_device):
    """A grid and a single render each launch `splat_scatter` and
    `splat_resolve` once, and nothing else."""
    pts, gray = make_world(20_000, seed=13)
    m = convert.render_model_from_numpy(pts, gray, cuda_device)
    offsets = render.translation_grid_offsets((3, 3, 3), (0.2, 0.2, 0.5), device=cuda_device)
    T = _pose(7).to(cuda_device)
    for call in (lambda: render.render_translation_grid(m, T, K, offsets, H, W, NEAR, FAR, 3),
                 lambda: render.render_pointcloud(m, T, K, H, W, NEAR, FAR, 3)):
        kernels.reset_launches()
        call()
        torch.cuda.synchronize()
        assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {"splat_scatter": 1,
                                                                     "splat_resolve": 1}
