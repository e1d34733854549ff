"""The port's NMI localizer recovers known perturbations on the CPU, in both
render modes (the contracts of tests/test_nmi.py:367-425 and
tests/test_raster.py:144-189, run on the port alone).

  * render mode 4 (point splat): tests/test_nmi.py's 40,000-point world at
    160x120, steps 0.3 m / 0.03 rad, threshold 0.3; the translation case
    with initialization-sized grids (125 renders x 27 warps a sweep), the
    others 27 x 27;
  * render mode 1 (textured mesh, the plain versions of kernel B3 and the
    sampler): tests/test_raster.py's height field at 48x256, steps 0.4 m /
    0.03 rad, threshold 0.5, two sweeps of 9 x 27 (3 x 3 x 1 translations:
    the plain rasterizer is slow on the CPU).
Cases: one translation step (error at most half the initial), a one-step
rotation with a rotation-only kernel (at most 0.7 of the initial), the same
translation with coarse_scale=2 (and the accepted score is the final
full-resolution sweep's), and a uniform-noise frame (failed; Tcw returned
equal to the input, byte for byte).
"""

import dataclasses
import re

import numpy as np
import pytest
import torch
from torch_port_fixtures import MESH_CAMERA, height_field_mesh, make_world, mesh_frame

from orbslam2_nmi_torch.config import CameraConfig, NMIConfig, NMIGridConfig
from orbslam2_nmi_torch.geometry import se3
from orbslam2_nmi_torch.io.model_loader import MeshModel
from orbslam2_nmi_torch.ops import render
from orbslam2_nmi_torch.slam.nmi.localizer import NMILocalizer

POINT_CAM = CameraConfig(fx=120.0, fy=120.0, cx=80.0, cy=60.0, width=160, height=120)


def _setup(render_mode, coarse_scale, log_fn):
    """(localizer, frame at T = I, translation step)."""
    if render_mode == 4:
        cfg = NMIConfig(grid=NMIGridConfig(synth_step=(0.3,) * 3, warp_step=(0.03,) * 3),
                        render_near=1.0, render_far=30.0, threshold=0.3,
                        coarse_scale=coarse_scale)
        pts, gray = make_world(40000, seed=7)
        model = render.RenderModel(torch.from_numpy(pts), torch.from_numpy(gray))
        frame = render.render_pointcloud(model, torch.eye(4), POINT_CAM.K, 120, 160, 1.0, 30.0, 3)
        return NMILocalizer(cfg, POINT_CAM, model, log_fn=log_fn, device="cpu"), frame, 0.3
    cfg = NMIConfig(grid=NMIGridConfig(synth_num=(3, 3, 1), synth_step=(0.4,) * 3,
                                       warp_step=(0.03,) * 3),
                    render_near=1.0, render_far=50.0, threshold=0.5, max_iteration_count=2,
                    coarse_scale=coarse_scale)
    mesh = height_field_mesh()
    loc = NMILocalizer(cfg, CameraConfig(**MESH_CAMERA), None, log_fn=log_fn,
                       mesh=MeshModel(*mesh), device="cpu")
    return loc, mesh_frame(mesh), 0.4


def pose_error(T):
    """(translation m, rotation rad) of T against the identity."""
    Twc = np.linalg.inv(T.astype(np.float64))
    cos = np.clip((np.trace(Twc[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
    return float(np.linalg.norm(Twc[:3, 3])), float(np.arccos(cos))


@pytest.mark.parametrize("case", ["translation", "rotation", "coarse", "garbage"])
@pytest.mark.parametrize("render_mode", [1, 4])
def test_port_localizer_recovers(render_mode, case):
    logs = []
    loc, frame, step = _setup(render_mode, 2 if case == "coarse" else 1, logs.append)
    T = np.eye(4, dtype=np.float32)
    # initialization sizing (125 renders a sweep) only where the CPU time allows
    kw = dict(initializing=render_mode == 4 and case == "translation")
    if case in ("translation", "coarse", "garbage"):
        T[0, 3] = -step  # the camera moved +step along its x axis
    if case == "rotation":  # tiny translation drift, large rotation drift
        T[:3, :3] = se3.euler_zyx(torch.tensor([0.0, 0.03, 0.0])).numpy()
        kw = dict(dist_since=(1e-4,) * 3, rot_since=(1.5,) * 3)
    if case == "garbage":
        frame = torch.from_numpy(np.random.default_rng(9).uniform(0, 255, tuple(frame.shape))
                                 .astype(np.float32))
    out = loc.relocalize_strategy(frame, T.copy(), **kw)
    t0, r0 = pose_error(T)
    t1, r1 = pose_error(out.Tcw)
    if case == "garbage":
        assert out.failed and not out.relocalized
        assert out.Tcw.dtype == T.dtype and out.Tcw.tobytes() == T.tobytes()
        return
    assert out.relocalized and not out.failed
    if case == "rotation":
        assert (out.num_synth, out.num_warp) == ((1, 1, 1), (3, 3, 3))
        assert r1 <= 0.7 * r0, (r0, r1)
    else:
        assert t1 <= 0.5 * t0, (t0, t1)
    if case == "coarse":  # the accepted score is the final full-resolution sweep's
        final = [line for line in logs if line.startswith("NMI final (full res)")]
        assert len(final) == 1
        assert float(re.search(r"nmi=([0-9.]+)", final[0]).group(1)) == round(out.nmi, 5)
        assert all("(1/2 res)" in line for line in logs[:-1])
    assert len(out.previous_poses) == sum(line.startswith("NMI ") for line in logs)


def test_coarse_pass_renders_at_half_resolution(monkeypatch):
    """With coarse_scale=2 the coarse sweeps render at half the frame size,
    with the point size halved (3 / 2 rounds to 2, as Python's round does)."""
    sizes = []
    render_grid = render.render_translation_grid

    def spy(model, Tcw, K, offsets, h, w, near, far, point_size):
        sizes.append((h, w, point_size))
        return render_grid(model, Tcw, K, offsets, h, w, near, far, point_size)

    loc, frame, step = _setup(4, 2, None)
    loc.cfg = dataclasses.replace(loc.cfg, max_iteration_count=1)
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = -step
    monkeypatch.setattr(render, "render_translation_grid", spy)
    loc.relocalize_strategy(frame, T)
    assert sizes == [(60, 80, 2), (120, 160, 3)]
