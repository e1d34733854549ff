"""Helpers the per-layer readers share: the sweeps of the traced window
(its requests and the one it ended inside of, all of which the trace holds),
the program's range names a stage's device time is charged to, and the
shapes of a sweep."""

from __future__ import annotations

import math

# the program's named ranges (orbslam2_nmi_torch/utils/profiling.labelled)
RENDER = ("render_mesh_grid", "render_gray", "render_translation_grid", "rasterize_keys")
WARP = ("warp_rotation_grid", "warp_homographies")
SCORE = ("entropy.nmi_scores", "joint_entropy_grid", "marginal_entropy_sets",
         "marginal_entropy_grid")
PREPARE = "render.prepare_sweep"


def traced_sweeps(ctx) -> list:
    reqs = list(ctx.res["requests"]) + [ctx.res["overrun"]]
    return [s for r in reqs for s in r["sweeps"]]


def n_sweeps(ctx) -> int:
    """Sweeps the traced window ran, as its `render.prepare_sweep` ranges count them."""
    return ctx.trace.range_host.get(PREPARE, (0, 0.0))[0]


def shape(ctx, sweep: dict) -> tuple:
    """(S, R, h, w) of one recorded sweep."""
    cam = ctx.cell.cfg["camera"]
    scale = sweep["scale"]
    return (math.prod(sweep["num_synth"]), math.prod(sweep["num_warp"]),
            cam["height"] // scale, cam["width"] // scale)


def per_sweep_device_ms(ctx, ranges) -> float | None:
    n = n_sweeps(ctx)
    if ctx.trace.busy_s <= 0 or n == 0:
        return None
    return 1e3 * ctx.trace.device_s(ranges) / n
