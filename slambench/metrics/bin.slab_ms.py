"""Host ms a sweep in the second phase of `raster.bin_mesh` (the [tiles, 16,
C] triangle slab and the texture's downsample and pad), from its
`render.bin_mesh.slab` ranges."""


def read(ctx):
    n, s = ctx.trace.range_host.get("render.bin_mesh.slab", (0, 0.0))
    return 1e3 * s / n if n else None
