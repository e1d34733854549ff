"""The port's ORB extractor against the JAX package's, on the CPU.

Bars, each measured on these inputs:
  * `level_sizes`, `resize_bilinear` (against the reference run op by op),
    FAST (masks and scores at both thresholds on pyramid levels), NMS, the
    cell fallback, `select_spatial_topk` and `compute_descriptors` given the
    same blurred image and angles: exact;
  * `build_pyramid` against the reference compiled with `jax.jit`, as
    `extract_orb` runs it: 2e-3 gray levels. XLA fuses and contracts the
    resize's products and sums, and the levels compound it (measured max
    9.5e-4 here, 1.6e-3 on uniform noise; op by op the two are equal);
  * `gaussian_blur`: 1e-4 gray levels. XLA's CPU convolution adds the seven
    taps in another order than the port's fixed one (measured max 4.6e-5);
  * orientation: the moments come from float32 prefix sums that XLA and
    torch add in different orders, so angles differ where the moments are
    small. At the keypoints of `extract_orb`, 2e-3 rad (measured max 8.7e-4);
  * `extract_orb` end to end: xy, octave, valid and size exact; the FAST
    response within 5e-3 (XLA fuses the score sum into one program and adds
    it in another order; measured max 1.7e-3); descriptor bits apart on at
    most 1e-4 of all bits (they read the blur and the angles; measured 0 at
    160x200 and 2 of 128,000 bits, 1.6e-5, at 320x240).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_fixtures import cuda_device  # noqa: F401  (fixture)

from orbslam2_nmi_torch.config import ORBConfig as TConfig
from orbslam2_nmi_torch.ops import fast as tfast
from orbslam2_nmi_torch.ops import orb as torb
from orbslam2_nmi_torch.ops import pyramid as tpyr
from orbslam2_nmi_tpu.config import ORBConfig as JConfig
from orbslam2_nmi_tpu.ops import fast as jfast
from orbslam2_nmi_tpu.ops import orb as jorb
from orbslam2_nmi_tpu.ops import pyramid as jpyr

BLUR_ATOL = 1e-4
ANGLE_ATOL = 2e-3
RESPONSE_ATOL = 5e-3
DESC_BIT_SHARE = 1e-4


def textured(h, w, seed=0):
    """tests/test_orb.py's blocky texture (corners everywhere), uint8."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (h // 4, w // 4))
    return np.kron(img, np.ones((4, 4))).astype(np.uint8)


PYRAMID_JIT_ATOL = 2e-3

# the JAX functions compiled once a shape (eager JAX compiles every op a shape)
_j_pyramid = jax.jit(jpyr.build_pyramid, static_argnums=(1, 2))
_j_fast = jax.jit(jfast.fast_response, static_argnums=1)
_j_fallback = jax.jit(jfast.detect_with_fallback, static_argnums=(1, 2, 3, 4))
_j_orientation = jax.jit(jorb.orientation_maps)
# levels checked where a test loops over the pyramid: full size, the first
# resize, and two far down
LEVELS = (0, 1, 4, 7)


@pytest.fixture(scope="module")
def frame_and_levels():
    """A textured 240x320 frame and the port's pyramid of it: the common
    input of the per-level checks."""
    img = textured(240, 320).astype(np.float32)
    return img, [lv.numpy() for lv in tpyr.build_pyramid(torch.from_numpy(img), 8, 1.2)]


@pytest.mark.parametrize("hw", [(540, 960), (240, 320), (160, 200), (33, 47)])
@pytest.mark.parametrize("n_levels,scale", [(8, 1.2), (4, 1.5)])
def test_level_sizes_exact(hw, n_levels, scale):
    assert tpyr.level_sizes(*hw, n_levels, scale) == jpyr.level_sizes(*hw, n_levels, scale)


def test_pyramid_matches_reference(frame_and_levels):
    img, levels = frame_and_levels
    for t, j in zip(levels, _j_pyramid(jnp.asarray(img), 8, 1.2)):
        np.testing.assert_allclose(t, np.asarray(j), atol=PYRAMID_JIT_ATOL, rtol=0)
    img = np.random.default_rng(1).uniform(0, 255, (96, 128)).astype(np.float32)
    out = tpyr.resize_bilinear(torch.from_numpy(img), 80, 107).numpy()
    np.testing.assert_array_equal(out, np.asarray(jpyr.resize_bilinear(jnp.asarray(img), 80, 107)))


@pytest.mark.parametrize("kind", ["uniform", "blocky"])
def test_gaussian_blur_within_bar(kind):
    rng = np.random.default_rng(2)
    img = (rng.uniform(0, 255, (96, 128)) if kind == "uniform"
           else textured(96, 128, seed=2)).astype(np.float32)
    t = tpyr.gaussian_blur(torch.from_numpy(img), 7, 2.0).numpy()
    j = np.asarray(jpyr.gaussian_blur(jnp.asarray(img), 7, 2.0))
    np.testing.assert_allclose(t, j, atol=BLUR_ATOL, rtol=0)


@pytest.mark.parametrize("level", LEVELS)
def test_fast_exact_on_pyramid_levels(frame_and_levels, level):
    lv = frame_and_levels[1][level]
    for th in (20.0, 7.0):
        cj, sj = _j_fast(jnp.asarray(lv), th)
        ct, st = tfast.fast_response(torch.from_numpy(lv), th)
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    kj, skj = _j_fallback(jnp.asarray(lv), 20.0, 7.0, 30, 16)
    kt, skt = tfast.detect_with_fallback(torch.from_numpy(lv), 20.0, 7.0, cell=30, border=16)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(skt.numpy(), np.asarray(skj))


def test_fast_naive_parity():
    """The port's bit-trick FAST equals a naive contiguous-arc check (the
    loop of tests/test_orb.py), including arcs through bit 15."""
    img = np.random.default_rng(3).uniform(0, 255, (40, 40)).astype(np.float32)
    corner = tfast.fast_response(torch.from_numpy(img), 20.0)[0].numpy()
    for y in range(3, 37):
        for x in range(3, 37):
            circ = np.array([img[y + dr, x + dc] for dr, dc in tfast.CIRCLE_OFFSETS])
            runs = []
            for m in (circ > img[y, x] + 20.0, circ < img[y, x] - 20.0):
                run = best = 0
                for v in np.concatenate([m, m]):
                    run = run + 1 if v else 0
                    best = max(best, run)
                runs.append(best >= 9)
            assert corner[y, x] == any(runs), (y, x)


def test_nms_and_fallback_cases():
    """tests/test_orb.py's NMS peak and weak-cell fallback, both packages."""
    score = np.zeros((16, 16), np.float32)
    score[8, 8], score[8, 9], score[3, 3], score[3, 4] = 5.0, 3.0, 2.0, 2.0  # and a plateau
    keep = tfast.nms3x3(torch.from_numpy(score)).numpy()
    np.testing.assert_array_equal(keep, np.asarray(jfast.nms3x3(jnp.asarray(score))))
    assert keep[8, 8] and not keep[8, 9] and keep[3, 3] and keep[3, 4]
    img = np.zeros((90, 90), np.float32)
    img[20:40, 20:40] = 255.0
    img[60:75, 60:75] = 12.0  # passes th=7, fails th=20
    kt, st = tfast.detect_with_fallback(torch.from_numpy(img), 20.0, 7.0, cell=30, border=4)
    kj, sj = jfast.detect_with_fallback(jnp.asarray(img), 20.0, 7.0, cell=30, border=4)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert kt.numpy()[55:80, 55:80].any()


def _tie_heavy_score(seed=4, h=96, w=160):
    """Integer scores on a sparse map with runs of equal values, several
    cells whose best is tied, and preferred keys that collide after the
    float32 1e9 bonus (spacing 64)."""
    rng = np.random.default_rng(seed)
    score = np.zeros((h, w), np.float32)
    m = rng.random((h, w)) < 0.3
    score[m] = rng.integers(1, 6, m.sum()).astype(np.float32)
    score[10:14, 10:40] = 3.0
    score[50, 50], score[50, 52] = 90.0, 90.0
    return score


@pytest.mark.parametrize("n_target,cell", [(100, 16), (700, 16), (3000, 8), (60, 32)])
def test_select_spatial_topk_exact_with_ties(n_target, cell):
    score = _tie_heavy_score()
    t = torb.select_spatial_topk(torch.from_numpy(score), n_target, cell)
    j = jorb.select_spatial_topk(jnp.asarray(score), n_target, cell)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("level", LEVELS)
def test_orientation_within_bar(frame_and_levels, level):
    """Dense moment maps: on level 0 (an integer image, whose prefix sums
    stay exact at this width) equal; on every level the angles agree within
    5e-3 rad where the moments are large (measured max 1.9e-3, level 1)."""
    lv = frame_and_levels[1][level]
    m10j, m01j = (np.asarray(a) for a in _j_orientation(jnp.asarray(lv)))
    m10t, m01t = (a.numpy() for a in torb.orientation_maps(torch.from_numpy(lv)))
    if level == 0:
        np.testing.assert_array_equal(m10t, m10j)
        np.testing.assert_array_equal(m01t, m01j)
    d = np.abs(np.arctan2(m01t, m10t) - np.arctan2(m01j, m10j))
    d = np.minimum(d, 2 * np.pi - d)
    large = np.hypot(m10j, m01j) > 1e3
    assert d[large].max() <= 5e-3, d[large].max()


def test_orientation_matches_naive():
    """tests/test_orb.py's naive moment at one pixel."""
    img = np.random.default_rng(1).uniform(0, 255, (64, 64)).astype(np.float32)
    m10, m01 = torb.orientation_maps(torch.from_numpy(img))
    umax = torb.circle_umax()
    n10 = n01 = 0.0
    for dy in range(-15, 16):
        for dx in range(-15, 16):
            if abs(dx) <= umax[abs(dy)]:
                n10 += dx * img[32 + dy, 30 + dx]
                n01 += dy * img[32 + dy, 30 + dx]
    assert abs(float(m10[32, 30]) - n10) / max(abs(n10), 1) < 1e-4
    assert abs(float(m01[32, 30]) - n01) / max(abs(n01), 1) < 1e-4


def test_descriptors_exact_given_blur_and_angles():
    rng = np.random.default_rng(5)
    blurred = np.array(jpyr.gaussian_blur(jnp.asarray(textured(120, 160, seed=5).astype(
        np.float32)), 7, 2.0))
    n = 300
    xs = rng.integers(0, 160, n).astype(np.int32)  # edges included: samples clip
    ys = rng.integers(0, 120, n).astype(np.int32)
    angles = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    angles[:8] = [0.0, np.pi / 2, -np.pi / 2, np.pi, np.pi / 4, 0.3, -1.2, 2.5]
    j = np.asarray(jorb.compute_descriptors(jnp.asarray(blurred), jnp.asarray(xs),
                                            jnp.asarray(ys), jnp.asarray(angles)))
    t = torb.compute_descriptors(torch.from_numpy(blurred), torch.from_numpy(xs),
                                 torch.from_numpy(ys), torch.from_numpy(angles)).numpy()
    assert t.dtype == np.int32
    np.testing.assert_array_equal(t.view(np.uint32), j)


def test_pattern_is_the_reference_table():
    np.testing.assert_array_equal(torb.load_pattern(), jorb.load_pattern())
    np.testing.assert_array_equal(torb.circle_umax(), jorb.circle_umax())
    assert "orbslam2_nmi_torch" in torb._PATTERN_PATH


def _flipped_bit_share(a_u32, b_u32):
    return np.unpackbits(np.bitwise_xor(a_u32, b_u32).view(np.uint8)).sum() / (a_u32.size * 32)


@pytest.mark.parametrize("h,w,n_levels,n_features", [(160, 200, 4, 200), (240, 320, 8, 500)])
def test_extract_orb_end_to_end(h, w, n_levels, n_features):
    img = textured(h, w)
    fj = jorb.extract_orb(jnp.asarray(img), JConfig(n_features=n_features, n_levels=n_levels))
    ft = torb.extract_orb(torch.from_numpy(img), TConfig(n_features=n_features, n_levels=n_levels))
    assert ft.n == n_features and ft.desc.dtype == torch.int32
    for name in ("xy", "octave", "valid", "size"):
        np.testing.assert_array_equal(getattr(ft, name).numpy(), np.asarray(getattr(fj, name)))
    v = ft.valid.numpy()
    assert v.sum() > n_features // 2
    np.testing.assert_allclose(ft.response.numpy(), np.asarray(fj.response), atol=RESPONSE_ATOL,
                               rtol=0)
    np.testing.assert_allclose(ft.angle.numpy()[v], np.asarray(fj.angle)[v], atol=ANGLE_ATOL,
                               rtol=0)
    share = _flipped_bit_share(ft.desc.numpy().view(np.uint32), np.asarray(fj.desc))
    assert share <= DESC_BIT_SHARE, share


@pytest.mark.gpu
def test_topk_ties_on_card(cuda_device):
    """The stable sort breaks ties by index on the card as on the CPU."""
    score = torch.from_numpy(_tie_heavy_score())
    for n_target, cell in [(100, 16), (3000, 8)]:
        c = torb.select_spatial_topk(score.to(cuda_device), n_target, cell)
        h = torb.select_spatial_topk(score, n_target, cell)
        for a, b in zip(c, h):
            assert torch.equal(a.cpu(), b)


@pytest.mark.gpu
def test_extract_orb_on_card_matches_cpu(cuda_device, record_property):
    """The pyramid, FAST and the sort are exact on both devices, so the
    keypoints are equal; the angles follow the card's cumsum. Bars just above
    what an H100 measured (80GB HBM3, 700 W): angles 1.02e-3 rad apart,
    3.1e-5 of the descriptor bits."""
    img = torch.from_numpy(textured(240, 320))
    cfg = TConfig(n_features=500, n_levels=8)
    fc = torb.extract_orb(img.to(cuda_device), cfg)
    fh = torb.extract_orb(img, cfg)
    for name in ("xy", "octave", "valid"):
        assert torch.equal(getattr(fc, name).cpu(), getattr(fh, name))
    v = fh.valid
    gap = float((fc.angle.cpu() - fh.angle)[v].abs().max())
    share = _flipped_bit_share(fc.desc.cpu().numpy().view(np.uint32),
                               fh.desc.numpy().view(np.uint32))
    record_property("angle_gap", gap)
    record_property("desc_bit_share", float(share))
    assert gap <= 1.5e-3 and share <= 5e-5
