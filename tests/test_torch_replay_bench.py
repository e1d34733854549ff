"""The port's replay harness (`orbslam2_nmi_torch/tools/replay_bench.py`)
against the JAX package's `tools/replay_bench.py`, on the CPU.

  * `generate_sequence`, plain and domain-gap, at 160x96 (3 frames of the
    seed-1 520-frame circuit): the two rasterizers hit the same pixels, and
    at least 99.5 % of the pixels are equal (measured: 99.967 % plain, 15
    of 46,080 pixels off by at most 26 levels, where a UV quantum flips on
    the random texture, test_torch_raster; 99.974 % domain-gap, at most 10
    levels); the domain gap's degradation is the same numpy on both;
  * `build_system`'s configuration equals the JAX tool's field by field, at
    the circuit's defaults and at the domain-gap threshold, and equals
    `entry.circuit_system`'s (chip_smoke.py's system phase rests on it);
  * `run_replay` returns the JAX tool's keys; driven over
    tests/test_torch_system.py's scene (the seed-3 point world, 25 frames
    at 320x240, no NMI, synchronous mapping), its outcome is within that
    file's bars: at least N-6 frames tracked, at least 3 keyframes, more
    than 100 points, ATE under 0.5 m (aligned, as run_replay computes it
    without NMI); pipelined with async mapping, at least N-8 tracked (the
    file's async bar) and 3 keyframes (the pipelined front-end's accuracy
    bars are tests/test_torch_frontend_pipelined.py's);
  * `run_replay` beside the JAX tool's on that scene and system, with
    synchronous mapping, on the classic path and pipelined: the same frames
    tracked, keyframes within one, ATE within 0.01 m (measured: 21 and 21
    tracked, 6 and 6 keyframes, 0.2411 and 0.2315 m classic; 21 and 21, 5
    and 5, 0.2250 and 0.2250 m pipelined).
"""

import dataclasses

import numpy as np
import pytest
import torch

from orbslam2_nmi_torch import entry as tentry
from orbslam2_nmi_torch.slam.system import SLAMSystem
from orbslam2_nmi_torch.tools import replay_bench as trb
from orbslam2_nmi_tpu.tools import replay_bench as jrb
from torch_port_fixtures import E2E, e2e_config, e2e_frames

MIN_EQUAL = 0.995


@pytest.mark.parametrize("domain_gap", [False, True])
def test_generate_sequence_matches_reference(domain_gap, monkeypatch, tmp_path):
    monkeypatch.setenv("ORBSLAM2_NMI_TORCH_SEQ_CACHE", str(tmp_path))
    wt, ft = trb.generate_sequence(3, 160, 96, n_total=520, domain_gap=domain_gap, device="cpu")
    wj, fj = jrb.generate_sequence(3, 160, 96, cache=False, n_total=520, domain_gap=domain_gap)
    assert ft.dtype == torch.uint8 and ft.shape == fj.shape == (3, 96, 160)
    np.testing.assert_array_equal(wt.mesh.texture_gray, wj.mesh.texture_gray)  # the flat prior
    a, b = ft.numpy(), np.asarray(fj)
    if not domain_gap:
        np.testing.assert_array_equal(a == 0, b == 0)  # the same pixels hit
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    equal = float((diff == 0).mean())
    assert equal >= MIN_EQUAL, f"{equal:.5f} of the pixels equal, max |diff| {diff.max()}"
    # the cache is the port's own, and a second call reads it back
    path = trb.sequence_cache_path(3, 160, 96, 1, 520, domain_gap)
    assert path.startswith(str(tmp_path)) and (tmp_path / path.split("/")[-1]).exists()
    _, again = trb.generate_sequence(3, 160, 96, n_total=520, domain_gap=domain_gap,
                                     device="cpu")
    assert torch.equal(again, ft)


def _jax_config(monkeypatch, **kw):
    """The SystemConfig the JAX tool's build_system hands its SLAMSystem."""
    import orbslam2_nmi_tpu.slam.system as jsystem

    seen = {}

    class Capture:
        def __init__(self, cfg, **_):
            seen["cfg"] = cfg

    monkeypatch.setattr(jsystem, "SLAMSystem", Capture)
    jrb.build_system(jrb_world(), 960, 540, **kw)
    return seen["cfg"]


def jrb_world():
    from orbslam2_nmi_tpu.io.synthetic import SyntheticMeshWorld

    return SyntheticMeshWorld(mesh=None)


@pytest.mark.parametrize("kw", [{}, {"threshold": 0.1, "max_frames": 15, "vocabulary_path": "v"}])
def test_build_system_config_matches_reference(kw, monkeypatch):
    from orbslam2_nmi_torch.io.synthetic import SyntheticMeshWorld

    world = SyntheticMeshWorld(mesh=None)
    port = tentry.mapping_config(world, 540, 960, **kw)
    assert dataclasses.asdict(port) == dataclasses.asdict(_jax_config(monkeypatch, **kw))
    if not kw:  # the circuit's system is build_system at its defaults
        system, _ = tentry.circuit_system(device="cpu")
        try:
            assert dataclasses.asdict(system.cfg) == dataclasses.asdict(port)
            assert system.pipeline is not None and system.nmi_worker is not None
            assert system.localizer is not None and system.localizer.mesh is not None
        finally:
            system.shutdown()


def test_build_system_passes_its_options(tmp_path):
    from orbslam2_nmi_torch.io.synthetic import SyntheticMeshWorld, terrain_mesh

    world = SyntheticMeshWorld(mesh=terrain_mesh(n=20))
    s = trb.build_system(world, 160, 96, use_nmi=False, async_mapping=True, async_nmi=False,
                         output_dir=str(tmp_path), threshold=0.1, device="cpu")
    try:
        assert s.localizer is None and s.pipeline is not None and s.nmi_worker is None
        assert s.cfg.nmi.threshold == 0.1 and s.output_dir == str(tmp_path)
    finally:
        s.shutdown()


REPLAY_KEYS = {"n_frames", "n_tracked", "n_keyframes", "n_map_points", "fps_steady",
               "fps_median", "frame_ms_p50", "frame_ms_p95", "frame_ms_max", "ate_rmse",
               "n_loop_closures", "n_nmi_anchors"}


@pytest.mark.parametrize("pipelined", [False, True])
def test_run_replay_on_the_system_scene(pipelined, monkeypatch, tmp_path):
    """run_replay on tests/test_torch_system.py's scene: build_system is
    replaced by that file's system (its config, no NMI; synchronous mapping
    on the classic path, async behind the pipelined front-end)."""
    world, frames, _ = e2e_frames()
    built = []

    def e2e_system(world, width, height, use_nmi=True, async_mapping=True, **kw):
        s = SLAMSystem(e2e_config(), use_nmi=False, output_dir=str(tmp_path),
                       async_mapping=async_mapping, device="cpu")
        built.append(s)
        return s

    monkeypatch.setattr(trb, "build_system", e2e_system)
    n = E2E["n_frames"]
    out = trb.run_replay(world, np.stack(frames), use_nmi=False, async_mapping=pipelined,
                         warmup=4, n_total=n, pipelined=pipelined, device="cpu")
    assert set(out) == REPLAY_KEYS
    assert out["n_frames"] == n and out["n_tracked"] >= n - (8 if pipelined else 6)
    assert out["n_keyframes"] >= 3
    if not pipelined:
        assert out["n_map_points"] > 100 and out["ate_rmse"] < 0.5
    assert out["fps_steady"] > 0 and out["frame_ms_p50"] <= out["frame_ms_max"]
    assert (built[0].pipeline is not None) == pipelined
    built[0].shutdown()  # run_replay shut it down: a second shutdown is harmless


def _replay_both(pipelined, monkeypatch, tmp_path):
    """run_replay of both packages on tests/test_torch_system.py's scene,
    each tool's build_system replaced by that file's system in its package
    (no NMI, synchronous mapping, so both runs are deterministic)."""
    from orbslam2_nmi_tpu.io.synthetic import SyntheticWorld as JWorld
    from orbslam2_nmi_tpu.slam.system import SLAMSystem as JSystem
    from torch_port_fixtures import jax_system_config

    world, frames, _ = e2e_frames()
    n = E2E["n_frames"]

    def port_system(world, width, height, **kw):
        return SLAMSystem(e2e_config(), use_nmi=False, output_dir=str(tmp_path / "port"),
                          async_mapping=False, device="cpu")

    def jax_system(world, width, height, **kw):
        return JSystem(jax_system_config(e2e_config()), use_nmi=False,
                       output_dir=str(tmp_path / "jax"), async_mapping=False)

    monkeypatch.setattr(trb, "build_system", port_system)
    monkeypatch.setattr(jrb, "build_system", jax_system)
    kw = dict(use_nmi=False, async_mapping=False, warmup=4, n_total=n, pipelined=pipelined)
    out = trb.run_replay(world, np.stack(frames), device="cpu", **kw)
    ref = jrb.run_replay(JWorld.generate(seed=E2E["seed"]), np.stack(frames), **kw)
    return out, ref


@pytest.mark.parametrize("pipelined", [False, True])
def test_run_replay_matches_reference(pipelined, monkeypatch, tmp_path):
    """The port's run_replay beside the JAX tool's on the same frames and
    the same system (classic path and the pipelined front-end): the same
    keys, the same frames tracked, keyframes within one and the ATE (aligned,
    without NMI) within 0.01 m, as tests/test_torch_frontend_pipelined.py
    holds the front-end."""
    out, ref = _replay_both(pipelined, monkeypatch, tmp_path)
    assert set(out) == set(ref) == REPLAY_KEYS
    assert out["n_frames"] == ref["n_frames"]
    assert out["n_tracked"] == ref["n_tracked"], (out, ref)
    assert abs(out["n_keyframes"] - ref["n_keyframes"]) <= 1, (out, ref)
    assert abs(out["ate_rmse"] - ref["ate_rmse"]) <= 0.01, (out, ref)
    assert out["n_nmi_anchors"] == ref["n_nmi_anchors"]
    assert out["n_loop_closures"] == ref["n_loop_closures"] == 0


def test_cuda_is_the_default_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trb.generate_sequence(2, 32, 16, cache=False)
    with pytest.raises(SystemExit):
        trb.main(["--device", "tpu"])


def test_fused_probe_raycast_matches_reference():
    """`tools/fused_probe.raycast_terrain` (the port's `io/synthetic` one)
    against the JAX tool's on rays from circuit poses: within 1e-6 m
    (measured: equal, the same float64 numpy); the terrain's height equal."""
    from orbslam2_nmi_torch.io import synthetic as tsyn
    from orbslam2_nmi_torch.tools import fused_probe as tfp
    from orbslam2_nmi_tpu.tools import fused_probe as jfp

    rng = np.random.default_rng(0)
    for i in (0, 130, 400):
        T = jrb_world().pose_at(i, 520).astype(np.float64)
        o = -T[:3, :3].T @ T[:3, 3]
        dirs = rng.normal(0, 0.3, (200, 3)) + np.array([0.0, 0.0, 1.0])
        np.testing.assert_allclose(tfp.raycast_terrain(o, dirs), jfp.raycast_terrain(o, dirs),
                                   atol=1e-6, rtol=0)
    x, y = rng.uniform(-40, 40, 50), rng.uniform(-30, 30, 50)
    np.testing.assert_array_equal(tsyn.terrain_height(x, y), jfp.terrain_height(x, y))
