"""Host ms a sweep in one phase of `raster.bin_mesh`, from its
`render.bin_mesh.upload` ranges: on the card, the lookup of the mesh's
arrays resident on the device (`raster.resident_mesh`; uploaded once, in
the localizer's set-up) and the pose and intrinsics packed as `bin_count`'s
parameters; on the CPU, the upload of the host's binned mesh."""


def read(ctx):
    n, s = ctx.trace.range_host.get("render.bin_mesh.upload", (0, 0.0))
    return 1e3 * s / n if n else None
