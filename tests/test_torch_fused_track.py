"""The port's per-frame tracking step against the JAX package's.

The scene is `torch_port_fixtures.tracking_scene`: the circuit on a 60x60
terrain grid at 480x270 (fx 225), 500 features, 256 local-map candidates,
seeded from ground truth. Both packages get the port's rendered uint8 frames,
the same carry (`convert.track_carry_from_numpy` carries the JAX one across)
and the same candidate arrays. Bars, measured on these inputs:
  * keypoints (xy, octave, valid) exact: the extractors agree exactly;
  * `src_prev` and `src_cand` equal except on rows whose matches the
    flipped descriptor bits move (counted: at most 1 % of the matched rows;
    measured: 2 of 16,000 bits flipped, no row moved);
  * the match and inlier counts within 2 of each other (measured 0);
  * Tcw and the velocity within 2e-5 (measured max 7.7e-6 for frame 8);
  * a 5-frame chain through the port passes the gate of
    `frontend_pipelined.py:244` (matches1 >= 20, inliers >= 10) with a
    camera-center error under 0.05 m (measured max 0.028 m).
"""

import ast
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_fixtures import TRACK_SCENE, cuda_device, tracking_scene  # noqa: F401

from orbslam2_nmi_torch import convert
from orbslam2_nmi_torch.slam import fused_track as tft
from orbslam2_nmi_torch.slam.frame import FrameData
from orbslam2_nmi_tpu import config as jconfig
from orbslam2_nmi_tpu.slam import fused_track as jft

TCW_ATOL = 2e-5
SRC_SHARE = 0.01
COUNT_GAP = 2
ERR_M = 0.05
CHAIN = 5


def _center(T):
    return -T[:3, :3].T.astype(np.float64) @ T[:3, 3].astype(np.float64)


@pytest.fixture(scope="module")
def scene():
    return tracking_scene(count=CHAIN)


@pytest.fixture(scope="module")
def one_step(scene):
    """Frame 8 through both packages on the same inputs."""
    step, frames, carry, candidates, _ = scene
    d = dataclasses.asdict(step.cfg)
    jcfg = jconfig.SystemConfig(camera=jconfig.CameraConfig(**d["camera"]),
                                orb=jconfig.ORBConfig(**d["orb"]),
                                tracking=jconfig.TrackingConfig(**d["tracking"]))
    jstep = jft.make_fused_step(jcfg, step.n_cand)
    arrays = candidates.candidate_arrays(carry.Tcw.numpy())
    jcarry = jft.TrackCarry(**{k: jnp.asarray(v.numpy().view(np.uint32) if k == "desc"
                                              else v.numpy())
                               for k, v in carry._asdict().items()})
    j_arrays = [jnp.asarray(a.view(np.uint32) if k == 1 else a) for k, a in enumerate(arrays)]
    jout = jstep(jnp.asarray(frames[0].numpy()), jcarry, *j_arrays)
    # the port runs on the reference's carry, carried across
    tcarry = convert.track_carry_from_numpy({k: np.asarray(v) for k, v in
                                             jcarry._asdict().items()}, "cpu")
    tout = step(frames[0], tcarry, *(torch.from_numpy(a) for a in arrays))
    return step, tout, jout, carry, tcarry


def test_carry_converts_exactly(one_step):
    _, _, _, carry, tcarry = one_step
    for a, b in zip(carry, tcarry):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_step_matches_reference(one_step):
    step, tout, jout, _, _ = one_step
    n, c = step.n_feat, step.n_cand
    u = tft.unpack_step(tout.packed.numpy(), n, c)
    uj = jft.unpack_step(np.asarray(jout.packed), n, c)
    for name in ("xy", "octave", "valid"):
        np.testing.assert_array_equal(getattr(u, name), getattr(uj, name))
    for name in ("src_prev", "src_cand"):
        a, b = getattr(u, name), getattr(uj, name)
        moved = (a != b).sum()
        assert moved <= SRC_SHARE * max((b >= 0).sum(), 1), (name, moved)
    for name in ("n_matches1", "n_inliers1", "n_inliers"):
        assert abs(getattr(u, name) - getattr(uj, name)) <= COUNT_GAP, name
    np.testing.assert_allclose(u.Tcw, uj.Tcw, atol=TCW_ATOL, rtol=0)
    np.testing.assert_allclose(u.velocity, uj.velocity, atol=TCW_ATOL, rtol=0)
    assert u.n_matches1 >= 20 and u.n_inliers >= 10


def test_packed_wire_format_matches_reference(one_step):
    """Both buffers have the same length and layout: the port's unpack_step
    reads the JAX buffer exactly as the JAX unpack_step does, and the port's
    buffer unpacks to the JAX step's fields (within the step's bars)."""
    step, tout, jout, _, _ = one_step
    n, c = step.n_feat, step.n_cand
    buf_t, buf_j = tout.packed.numpy(), np.asarray(jout.packed)
    assert buf_t.dtype == buf_j.dtype == np.float32 and buf_t.shape == buf_j.shape
    # poses and counters, then 17 values a feature and one a candidate
    assert len(buf_t) == 35 + 17 * n + c
    a, b = tft.unpack_step(buf_j, n, c), jft.unpack_step(buf_j, n, c)
    for f in tft.UnpackedStep._fields:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    u = tft.unpack_step(buf_t, n, c)
    assert u.desc.dtype == np.uint32 and u.src_prev.dtype == np.int32
    np.testing.assert_array_equal(u.cand_in_view, b.cand_in_view)
    with pytest.raises(ValueError):
        tft.unpack_step(buf_t[:-1], n, c)


def test_descriptor_bits_close_to_reference(one_step):
    """The flipped descriptor bits between the two steps' frames stay within
    the extractor's bar (tests/test_torch_orb.py: 1e-4 of all bits)."""
    step, tout, jout, _, _ = one_step
    u = tft.unpack_step(tout.packed.numpy(), step.n_feat, step.n_cand)
    uj = jft.unpack_step(np.asarray(jout.packed), step.n_feat, step.n_cand)
    bits = np.unpackbits(np.bitwise_xor(u.desc, uj.desc).view(np.uint8)).sum()
    assert bits / (u.desc.size * 32) <= 1e-4


def test_step_invariants(one_step, scene):
    """tests/test_fused_track.py:98-115, on the port's step."""
    step, tout, _, _, _ = one_step
    poses = scene[4]
    u = tft.unpack_step(tout.packed.numpy(), step.n_feat, step.n_cand)
    assert np.isfinite(u.Tcw).all() and np.isfinite(u.velocity).all()
    sp = u.src_prev[u.src_prev >= 0]
    assert len(np.unique(sp)) == len(sp)
    sc = u.src_cand[u.src_cand >= 0]
    assert len(np.unique(sc)) == len(sc)
    bound = (u.src_prev >= 0) | (u.src_cand >= 0)
    assert not (u.inlier & ~bound).any()
    assert np.linalg.norm(_center(u.Tcw) - _center(poses[0])) < 0.5
    np.testing.assert_allclose(tout.carry.Tcw.numpy(), u.Tcw, atol=1e-6)
    assert torch.equal(tout.carry.bound, torch.from_numpy(u.inlier))
    assert not tout.carry.pts[~tout.carry.bound].any()


def test_chain_tracks_the_circuit(scene):
    """Five frames, each carry feeding the next and the candidates rebuilt at
    the last estimate, as PipelinedFrontend._dispatch does."""
    step, frames, carry, candidates, poses = scene
    T_last = carry.Tcw.numpy()
    errs = []
    for i in range(CHAIN):
        out = step(frames[i], carry, *candidates(T_last))
        u = tft.unpack_step(out.packed.numpy(), step.n_feat, step.n_cand)
        assert u.n_matches1 >= 20 and u.n_inliers >= 10, (i, u.n_matches1, u.n_inliers)
        errs.append(np.linalg.norm(_center(u.Tcw) - _center(poses[i])))
        carry, T_last = out.carry, u.Tcw
    assert max(errs) < ERR_M, errs


def test_carry_from_frame():
    rng = np.random.default_rng(0)
    n = 10
    frame = FrameData(frame_id=3, timestamp=0.1, Tcw=np.eye(4, dtype=np.float32),
                      xy=rng.uniform(0, 100, (n, 2)).astype(np.float32),
                      xy_raw=np.zeros((n, 2), np.float32),
                      octave=rng.integers(0, 8, n).astype(np.int32),
                      angle=rng.uniform(-3, 3, n).astype(np.float32),
                      desc=rng.integers(0, 2**32, (n, 8), dtype=np.uint32),
                      valid=np.ones(n, bool))
    frame.mp_idx[[1, 4, 7]] = [2, 0, 5]
    frame.outlier[7] = True

    class Store:
        mp_pos = rng.normal(size=(6, 3)).astype(np.float32)

    c = tft.carry_from_frame(frame, Store, None, device="cpu")
    assert c.bound.tolist() == [i in (1, 4) for i in range(n)]
    np.testing.assert_array_equal(c.pts[1].numpy(), Store.mp_pos[2])
    assert not c.pts[7].any() and torch.equal(c.velocity, torch.eye(4))
    np.testing.assert_array_equal(c.desc.numpy().view(np.uint32), frame.desc)
    assert frame.n_matched() == 2


def test_step_raises_without_cuda(monkeypatch, scene):
    from orbslam2_nmi_torch.entry import tracking_entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tft.FusedTrackStep(scene[0].cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tracking_entry()


def test_step_reads_nothing_back():
    """The step's code calls none of the methods that wait on the device."""
    import inspect
    import textwrap

    calls = set()
    for m in ("run_eager", "extract", "motion_match", "pose", "local_match", "finish"):
        tree = ast.parse(textwrap.dedent(inspect.getsource(getattr(tft.FusedTrackStep, m))))
        calls |= {n.func.attr for n in ast.walk(tree)
                  if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)}
    assert {"match_descriptors", "pose_optimization_k", "inv_ex"} <= calls
    assert not calls & {"item", "cpu", "numpy", "tolist", "nonzero", "inverse", "inv"}


@pytest.mark.gpu
def test_graph_replay_equals_eager(cuda_device):
    step, frames, carry, candidates, _ = tracking_scene(count=3, device=cuda_device)
    T = carry.Tcw.cpu().numpy()
    step.capture(frames[0], carry, *candidates(T))
    c = carry
    for i in range(3):
        args = (frames[i], c, *candidates(T))
        e, g = step.run_eager(*args), step.replay(*args)
        assert torch.equal(e.packed.view(torch.int32), g.packed.view(torch.int32))
        c = e.carry


@pytest.mark.gpu
def test_tf32_changes_no_pose(cuda_device):
    step, frames, carry, candidates, _ = tracking_scene(count=1, device=cuda_device)
    args = (frames[0], carry, *candidates(carry.Tcw.cpu().numpy()))
    base = step.run_eager(*args)
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = step.run_eager(*args)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    assert float((tf32.carry.Tcw - base.carry.Tcw).abs().max()) <= 1e-6


@pytest.mark.gpu
def test_step_on_card_matches_cpu(cuda_device, scene, record_property):
    """One step on the card against the CPU on the same inputs. The
    keypoints are equal (the extraction's pyramid, FAST and sort are exact
    on both); the CUDA cumsum moves angles and a few descriptor bits. Bars
    just above what an H100 measured (80GB HBM3, 700 W): 1.6e-5 of the bits,
    Tcw 2.3e-6 apart, the inlier counts equal."""
    step_h, frames, carry, candidates, _ = scene
    arrays = candidates.candidate_arrays(carry.Tcw.numpy())
    out_h = step_h.run_eager(frames[0], carry, *(torch.from_numpy(a) for a in arrays))
    step_c = tft.FusedTrackStep(step_h.cfg, step_h.n_cand, cuda_device)
    out_c = step_c.run_eager(frames[0].to(cuda_device),
                             tft.TrackCarry(*(x.to(cuda_device) for x in carry)),
                             *(torch.from_numpy(a).to(cuda_device) for a in arrays))
    n, c = step_h.n_feat, step_h.n_cand
    uh = tft.unpack_step(out_h.packed.numpy(), n, c)
    uc = tft.unpack_step(out_c.packed.cpu().numpy(), n, c)
    bits = np.unpackbits(np.bitwise_xor(uc.desc, uh.desc).view(np.uint8)).sum()
    record_property("desc_bit_share", float(bits / (uh.desc.size * 32)))
    record_property("tcw_gap", float(np.abs(uc.Tcw - uh.Tcw).max()))
    record_property("n_inliers_gap", uc.n_inliers - uh.n_inliers)
    np.testing.assert_array_equal(uc.xy, uh.xy)
    np.testing.assert_array_equal(uc.octave, uh.octave)
    assert bits / (uh.desc.size * 32) <= 3e-5
    assert abs(uc.n_inliers - uh.n_inliers) <= 1
    np.testing.assert_allclose(uc.Tcw, uh.Tcw, atol=5e-6, rtol=0)


def test_scene_is_the_stated_one(scene):
    step, frames, _, _, poses = scene
    assert frames.shape == (CHAIN, TRACK_SCENE["height"], TRACK_SCENE["width"])
    assert step.n_feat == TRACK_SCENE["n_features"] and step.n_cand == TRACK_SCENE["n_cand"]
    assert poses.shape == (CHAIN, 4, 4)
