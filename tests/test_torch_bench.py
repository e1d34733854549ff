"""The port's headline benchmark (`orbslam2_nmi_torch/tools/bench.py`)
against the repo's root `bench.py`, on the CPU.

  * the inputs: `bench_mesh` and the 500,000 points, their gray and the
    frame equal the reference's bit for bit (the same `default_rng(0)`
    draws in the same order);
  * the sweep at a reduced size (the bench mesh at 64x256, 27 renders x 27
    warps): the port's `run_sweep` scores against the reference's
    composition (`raster.render_mesh_grid` with Pallas in interpret mode,
    `homography.warp_rotation_grid`, `histogram_nmi.nmi_scores`) within
    tests/test_torch_entry.py's whole-step bar of 8.1e-4, with the same
    argmax (measured: 2.4e-4); on the CPU the wrappers take the plain
    versions, so the launch counts stay 0;
  * a replay's exception propagates out of `main` (the reference swallows
    it into the JSON line), so the tool exits non-zero;
  * CUDA is the default and nothing falls back to the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
from torch_port_fixtures import THREADS  # noqa: F401  (one torch thread a test worker)
from orbslam2_nmi_torch.tools import bench as tbench
from orbslam2_nmi_tpu.ops import histogram_nmi as jhn
from orbslam2_nmi_tpu.ops import homography as jhom
from orbslam2_nmi_tpu.ops import raster as jr
from orbslam2_nmi_tpu.ops import render as jrender

H, W = 64, 256
SCORE_ATOL_WHOLE = 8.1e-4


def test_inputs_equal_the_reference():
    """The reference's draws, line for line (bench.py:110-122)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-40, 40, 500_000)
    y = rng.uniform(-30, 30, 500_000)
    z = 15.0 + 3.0 * np.sin(x * 0.3) * np.cos(y * 0.25)
    pts = np.stack([x, y, z], -1).astype(np.float32)
    gray = ((np.floor(x * 1.1) * 53 + np.floor(y * 1.1) * 101) % 256).astype(np.float32)
    mesh = jbench._bench_mesh(rng)
    frame = rng.uniform(0, 255, (540, 960)).astype(np.float32)
    t_pts, t_gray, t_mesh, t_frame = tbench.bench_scene()
    for a, b in ((t_pts, pts), (t_gray, gray), (t_frame, frame)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for name in ("vertices", "uvs", "faces", "texture_gray"):
        a, b = getattr(t_mesh, name), getattr(mesh, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert t_mesh.faces.shape == (71442, 3) and t_mesh.texture_gray.shape == (512, 512)
    np.testing.assert_array_equal(tbench.bench_K(540, 960), np.array(
        [[435.0, 0, 480.0], [0, 435.0, 270.0], [0, 0, 1]], np.float32))


def test_sweep_matches_reference(monkeypatch):
    """The stages' timing is replaced by a fixed 1 ms a call (timing them on
    the CPU would only repeat the untimed sweep)."""
    timed = []

    def one_ms(fn, device, reps, warmup):
        timed.append(fn)
        return dict(median_ms=1.0, min_ms=1.0, max_ms=1.0, ms=[1.0])

    monkeypatch.setattr(tbench, "time_calls", one_ms)
    inp = tbench.sweep_inputs("cpu", H, W)
    res = tbench.run_sweep(inp)
    scores = res["scores"].numpy()
    assert scores.shape == (27, 27) and res["n_pairs"] == 729
    assert all(n == 0 for n in res["launches"].values())
    assert set(res["times"]) == {"render", "splat", "warp", "score"} and len(timed) == 4
    assert res["sweep_ms"] == 3.0 and res["evals_per_s"] == pytest.approx(729 / 3e-3)

    _, _, mesh, frame = tbench.bench_scene(H, W)
    K = tbench.bench_K(H, W)
    jb = jr.bin_mesh(mesh, np.eye(4, dtype=np.float32), K, H, W, tbench.NEAR, tbench.FAR,
                     max_offset=tbench.SYNTH_STEP, device_arrays=False)
    jb = jb._replace(tri_data=jnp.asarray(jb.tri_data), texture=jnp.asarray(jb.texture),
                     tex_origin=None if jb.tex_origin is None else jnp.asarray(jb.tex_origin))
    offsets = jnp.asarray(jrender.translation_grid_offsets(tbench.GRID, tbench.SYNTH_STEP))
    angles = jhom.rotation_grid_angles(tbench.GRID, tbench.WARP_STEP)
    synth = jr.render_mesh_grid(jb, np.eye(4, dtype=np.float32), K, offsets, tbench.NEAR,
                                tbench.FAR, interpret=True)
    warped = jhom.warp_rotation_grid(jnp.asarray(frame), jnp.asarray(K), angles)
    ref = np.asarray(jhn.nmi_scores(synth, warped, use_pallas=False))
    np.testing.assert_allclose(scores, ref, atol=SCORE_ATOL_WHOLE, rtol=0)
    assert int(scores.argmax()) == int(ref.argmax())


def test_a_failed_replay_fails_the_tool(monkeypatch, capsys):
    from orbslam2_nmi_torch.tools import replay_bench

    monkeypatch.setattr(tbench, "sweep_inputs", lambda device: None)
    monkeypatch.setattr(tbench, "run_sweep", lambda inp: dict(
        times={k: dict(median_ms=1.0, min_ms=1.0, max_ms=1.0) for k in
               ("render", "splat", "warp", "score")}, launches={}, n_pairs=729,
        evals_per_s=243000.0))
    monkeypatch.setattr(replay_bench, "generate_sequence", lambda *a, **k: (None, None))

    def fail(*a, **k):
        raise RuntimeError("a worker failed")

    monkeypatch.setattr(replay_bench, "run_replay", fail)
    with pytest.raises(RuntimeError, match="a worker failed"):
        tbench.main(["--device", "cpu"])
    assert "nmi_pose_evals_per_s" not in capsys.readouterr().out


def test_cuda_is_the_default_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.sweep_inputs()
