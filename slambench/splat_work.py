"""The work of the point splat (render mode 4), from the shapes alone.

The bytes are those of what the splat has to read and write, whatever
implements it (torch's scatter now, a hand-written kernel later): each
point's coordinates and gray read once, each render written once. The
program's intermediates (camera-frame coordinates, keys, pixel indices, the
key buffer) are not counted. Besides, the program's ranges a sweep's splat
device time is charged to.
"""

from __future__ import annotations

# `ops/render.render_translation_grid` and the three spans inside its `_splat`
RANGES = ("render_translation_grid", "render.splat.project", "render.splat.scatter",
          "render.splat.resolve")


def splat_bytes(n_points: int, S: int, H: int, W: int) -> int:
    """One sweep's splat: float32 xyz and gray of every point read once
    (16 bytes a point), S float32 images of H x W written once."""
    return 16 * n_points + 4 * S * H * W
