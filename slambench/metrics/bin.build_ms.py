"""Host ms a sweep in the first phase of `raster.bin_mesh` (the projection,
the near/far cull, the margins, the (face, tile) pairs, their sort, the
slots and the tile lists), from its `render.bin_mesh.build` ranges."""


def read(ctx):
    n, s = ctx.trace.range_host.get("render.bin_mesh.build", (0, 0.0))
    return 1e3 * s / n if n else None
