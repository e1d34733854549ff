"""Host ms a sweep in the last phase of `raster.bin_mesh` (the upload of the
binned mesh to the device, `raster.to_device`), from its
`render.bin_mesh.upload` ranges."""


def read(ctx):
    n, s = ctx.trace.range_host.get("render.bin_mesh.upload", (0, 0.0))
    return 1e3 * s / n if n else None
