"""The reference's point splat (render mode 4) against the program's, at the
deployment's size on the CPU: 960x540, the terrain sampled at 400 points/m²
(2,184,253 points), three candidates of a 3x3x3 translation grid (two
corners and the centre) at circuit frames spread over the lap. The float32
reference equals the program's renders bit for bit; the bfloat16 control
(the coordinates rounded before they are projected) fails `render_gap`."""

import json

import numpy as np
import pytest
import torch

from slambench import nmi_check, run, world
from slambench.reference import splat
from slambench.reference.strategy import Kernel, Reference
from slambench.tests.conftest import CELLS, ROOT

from orbslam2_nmi_torch.ops import render

FRAMES = (40, 100, 260, 400)
DENSITY = 400.0


@pytest.fixture(scope="module")
def scene():
    with open(ROOT / "slambench" / "configs" / "zumav_mesh.json") as f:
        cfg = json.load(f)
    mesh = world.terrain_mesh(cfg["prior"]["world_seed"], cfg["prior"])
    points, gray = world.mesh_to_points(mesh, DENSITY)
    assert len(points) == 2_184_253
    return cfg, torch.from_numpy(points), torch.from_numpy(gray)


def _program(cfg, points, gray, Tcw, offsets):
    c, n = cfg["camera"], cfg["nmi"]
    return render.render_translation_grid(
        render.RenderModel(points, gray), Tcw, world.camera_K(c), offsets, c["height"],
        c["width"], n["render_near"], n["render_far"],
        point_size=int(round(n["render_point_size"])))


def _pose(cfg, frame):
    return torch.from_numpy(world.pose_at(frame, cfg["scene"]["circuit"]).astype(np.float32))


@pytest.mark.parametrize("frame", FRAMES)
def test_reference_splat_is_the_programs(scene, frame):
    cfg, points, gray = scene
    c, n = cfg["camera"], cfg["nmi"]
    offsets = splat.translation_grid_offsets((3, 3, 3), tuple(n["synth_step"]), "cpu")[[0, 13, 26]]
    Tcw = _pose(cfg, frame)
    ours = splat.render_translation_grid(
        splat.RenderModel(points, gray), Tcw, world.camera_K(c), offsets, c["height"], c["width"],
        n["render_near"], n["render_far"], point_size=int(round(n["render_point_size"])))
    theirs = _program(cfg, points, gray, Tcw, offsets)
    assert (theirs > 0).float().mean() > 0.9  # a dense render, not mostly background
    assert torch.equal(ours, theirs)


@pytest.mark.parametrize("frame", FRAMES)
def test_bfloat16_control_fails_render_gap(scene, frame):
    cfg, points, gray = scene
    c, n = cfg["camera"], cfg["nmi"]
    kernel = Kernel(num_synth=(3, 1, 1), num_warp=(1, 1, 1), step_synth=tuple(n["synth_step"]),
                    step_warp=tuple(n["warp_step"]))
    Tcw = world.pose_at(frame, cfg["scene"]["circuit"]).astype(np.float32)
    image = 255.0 * torch.rand((c["height"], c["width"]),
                               generator=torch.Generator().manual_seed(frame))
    control = Reference(n, world.camera_K(c), c["height"], c["width"], "cpu", points=points,
                        gray=gray, precision="bfloat16")
    res = control.sweep(image, Tcw, kernel, 1, keep_images=True)
    offsets = splat.translation_grid_offsets(kernel.num_synth, kernel.step_synth, "cpu")
    program = _program(cfg, points, gray, torch.from_numpy(Tcw), offsets)
    limit = max(run.load_limits(w)["render_gap"] for w in CELLS)
    assert nmi_check._max_gap(res.renders, program) > limit
