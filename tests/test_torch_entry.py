"""The port's NMI grid step as a whole, against the JAX package.

The reference is the same composition of JAX functions that
`__graft_entry__.entry()` runs: `raster.bin_mesh`, `raster.render_mesh_grid`
(Pallas in interpret mode), `homography.warp_rotation_grid` and
`histogram_nmi.nmi_scores(use_pallas=False)`. The binned mesh passes to the
port through `convert.binned_from_numpy`. Size: 64x256 frames, 9 renders x 9
warps (the entry's toy mesh and steps).

Three bars, each measured on these inputs (random and rendered frames, both
values of use_background):
  * the port's score, fed the reference's renders and warps, agrees to
    atol=1e-5 (exact histograms; see test_torch_histogram_nmi);
  * the port's warp and score, fed the reference's renders, agree to
    atol=5e-4. The warped grays differ by at most 0.015 levels (the
    homographies are rounded in another order), which moves 0.008 % of warped
    pixels across an integer bin edge; measured max |score diff| 7.9e-5;
  * the whole port, render included, agrees to atol=2e-3. Its renders differ
    from the reference's where a UV quantum flips (about 0.04 % of pixels, see
    test_torch_raster), which moves a random texture's gray by up to tens of
    levels there; measured max |score diff| 8.1e-4.
The argmax must agree wherever the top two scores differ by more than ten
times the bar in force.
"""

import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_fixtures import THREADS, cuda_device  # noqa: F401  (fixture)

from orbslam2_nmi_torch import config as tconfig
from orbslam2_nmi_torch import convert
from orbslam2_nmi_torch import entry as tentry
from orbslam2_nmi_torch.ops import histogram_nmi as thn
from orbslam2_nmi_tpu import config as jconfig
from orbslam2_nmi_tpu.ops import histogram_nmi as jhn
from orbslam2_nmi_tpu.ops import homography as jhom
from orbslam2_nmi_tpu.ops import raster as jr
from orbslam2_nmi_tpu.ops import render as jrender

ROOT = Path(__file__).resolve().parent.parent
H, W = 64, 256
NUM = (3, 3, 1)
SCORE_ATOL_SAME_IMAGES = 1e-5
SCORE_ATOL_SAME_RENDERS = 5e-4
SCORE_ATOL_WHOLE = 2e-3


def _assert_argmax_agrees(out, ref, atol):
    top2 = np.sort(ref.reshape(-1))[-2:]
    if top2[1] - top2[0] > 10 * atol:
        assert int(out.argmax()) == int(ref.argmax())


@pytest.fixture(scope="module")
def slice_setup():
    fn, (frame, Tcw) = tentry.entry(device="cpu", height=H, width=W, synth_num=NUM,
                                    warp_num=NUM)
    K = tentry.camera_K(H, W)
    jb = jr.bin_mesh(tentry._toy_mesh(), np.eye(4, dtype=np.float32), K, H, W, tentry.NEAR,
                     tentry.FAR, max_offset=tentry.SYNTH_STEP, device_arrays=False)
    offsets = jnp.asarray(jrender.translation_grid_offsets(NUM, tentry.SYNTH_STEP))
    angles = jhom.rotation_grid_angles(NUM, tentry.WARP_STEP)
    jb_dev = jb._replace(tri_data=jnp.asarray(jb.tri_data), texture=jnp.asarray(jb.texture),
                         tex_origin=jnp.asarray(jb.tex_origin))
    synth_j = jr.render_mesh_grid(jb_dev, np.eye(4, dtype=np.float32), K, offsets,
                                  tentry.NEAR, tentry.FAR, interpret=True)
    frames = {"random": frame.numpy(), "rendered": np.array(synth_j[len(offsets) // 2])}
    return fn, jb, K, angles, np.array(synth_j), frames


@pytest.mark.parametrize("frame_kind", ["random", "rendered"])
@pytest.mark.parametrize("use_background", [True, False])
def test_slice_matches_reference(slice_setup, frame_kind, use_background):
    fn, jb, K, angles, synth_j, frames = slice_setup
    frame = frames[frame_kind]
    warped_j = jhom.warp_rotation_grid(jnp.asarray(frame), jnp.asarray(K), angles)
    ref = np.asarray(jhn.nmi_scores(jnp.asarray(synth_j), warped_j, use_pallas=False,
                                    use_background=use_background))

    # the port's state comes across from the reference's binned mesh
    tb = convert.binned_from_numpy(jb._asdict(), "cpu")
    step = tentry.NMIGridStep(tb, K, fn.offsets, fn.angles, use_background=use_background)
    frame_t, Tcw_t = torch.from_numpy(frame), torch.eye(4)

    # 1. the score alone, on the reference's renders and warps
    warped_t = torch.from_numpy(np.array(warped_j))
    same = step.score(torch.from_numpy(synth_j), warped_t).numpy()
    np.testing.assert_allclose(same, ref, atol=SCORE_ATOL_SAME_IMAGES)
    _assert_argmax_agrees(same, ref, SCORE_ATOL_SAME_IMAGES)

    # 2. warp and score, on the reference's renders
    warp_score = step.score(torch.from_numpy(synth_j), step.warp(frame_t)).numpy()
    np.testing.assert_allclose(warp_score, ref, atol=SCORE_ATOL_SAME_RENDERS)
    _assert_argmax_agrees(warp_score, ref, SCORE_ATOL_SAME_RENDERS)

    # 3. the whole step, render included
    scores, best = step(frame_t, Tcw_t)
    assert scores.shape == (9, 9) and scores.dtype == torch.float32
    assert int(best) == int(scores.argmax())
    np.testing.assert_allclose(scores.numpy(), ref, atol=SCORE_ATOL_WHOLE)
    _assert_argmax_agrees(scores.numpy(), ref, SCORE_ATOL_WHOLE)
    if frame_kind == "rendered":  # rendered at the center pose: best at the center
        assert int(best) == 4 * 9 + 4


def test_entry_defaults_match_the_reference_entry():
    """At its defaults the port's entry has the reference entry's intrinsics,
    grid and binning (960x540, 27 x 27); checked on the host without running
    the step."""
    K = tentry.camera_K(540, 960)
    np.testing.assert_array_equal(
        K, np.array([[435.0, 0, 480.0], [0, 435.0, 270.0], [0, 0, 1]], np.float32))
    jb = jr.bin_mesh(tentry._toy_mesh(), np.eye(4, dtype=np.float32), K, 540, 960, 5.0, 40.0,
                     max_offset=(0.2, 0.2, 0.5), device_arrays=False)
    assert (jb.tiles_y, jb.tiles_x, jb.capacity, jb.overflow, jb.tex_win) == (34, 8, 128, 0, 128)
    assert tentry.NEAR == 5.0 and tentry.FAR == 40.0


@pytest.mark.parametrize("name", ["CameraConfig", "NMIGridConfig", "NMIConfig"])
def test_config_copies_match_reference(name):
    """The copied dataclasses have the reference's fields and defaults."""
    t, j = getattr(tconfig, name)(), getattr(jconfig, name)()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    if name == "CameraConfig":
        np.testing.assert_array_equal(t.K, j.K)
        assert t.has_distortion == j.has_distortion


def test_entry_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tentry.entry()


def test_port_never_imports_jax():
    """Running the port's entry, its localizer (one strategy on the textured
    mesh, and one grid on the point model) and its tracking step (one frame
    of `tracking_entry`) on the CPU leaves jax and the JAX package out of
    sys.modules, and no file of the port (nor chip_smoke.py) imports them."""
    code = (
        "import sys, json\n"
        "import numpy as np, torch\n"
        "from orbslam2_nmi_torch.entry import entry, localizer_entry\n"
        "from orbslam2_nmi_torch.ops import render\n"
        "from orbslam2_nmi_torch.slam.nmi import async_worker, localizer\n"
        "fn, args = entry(device='cpu', height=32, width=128, synth_num=(1, 1, 1),"
        " warp_num=(1, 1, 1))\n"
        "fn(*args)\n"
        "loc, frame, T = localizer_entry(device='cpu', height=32, width=128)\n"
        "T[0, 3] = -0.2\n"
        "out = loc.relocalize_strategy(frame, T)\n"
        "assert out.relocalized and abs(out.Tcw[0, 3]) < 1e-6, out\n"
        "pts = render.mesh_to_points(loc.mesh, samples_per_unit_area=4.0)\n"
        "loc.model = render.model_from_pointcloud(pts, 'cpu')\n"
        "loc.mesh = None\n"
        "assert loc.evaluate_grid(frame, T, loc.initial_kernel).shape == (27, 27)\n"
        "from orbslam2_nmi_torch.entry import tracking_entry\n"
        "step, frames, carry, cands, poses = tracking_entry(device='cpu', height=120,"
        " width=160, count=2)\n"
        "out = step(frames[0], carry, *cands(carry.Tcw.numpy()))\n"
        "assert out.packed.shape == (35 + 17 * step.n_feat + step.n_cand,), out.packed.shape\n"
        "print(json.dumps(sorted(m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'jaxlib', 'orbslam2_nmi_tpu'))))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = str(THREADS)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []

    files = sorted((ROOT / "orbslam2_nmi_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "orbslam2_nmi_tpu"), (path, name)


@pytest.mark.gpu
def test_entry_on_card_matches_cpu(cuda_device):
    """The step on the card (kernels) agrees with the step on the CPU (plain
    versions) at a small size, within the whole-step bar: the homographies are
    inverted by another library on each device, which can flip a floor()."""
    fn_c, (frame_c, Tcw_c) = tentry.entry(device=cuda_device, height=H, width=W,
                                          synth_num=NUM, warp_num=NUM)
    fn_h, (frame_h, Tcw_h) = tentry.entry(device="cpu", height=H, width=W, synth_num=NUM,
                                          warp_num=NUM)
    s_c, _ = fn_c(frame_c, Tcw_c)
    s_h, _ = fn_h(frame_h, Tcw_h)
    np.testing.assert_allclose(s_c.cpu().numpy(), s_h.numpy(), atol=SCORE_ATOL_WHOLE)


def test_kernel_ablations_apply_to_the_sources():
    """Each ablation of tools/ablate_kernels.py is one edit of the committed
    kernel source, each found exactly once, so the tool times what it names."""
    from orbslam2_nmi_torch.tools import ablate_kernels as ab

    for kernel, name, edits, _ in ab.ABLATIONS:
        src = ab._source(kernel, edits)
        assert (src != ab._source(kernel, [])) == bool(edits), name
