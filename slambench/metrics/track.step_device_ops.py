"""Device operations a tracking step: those charged to the `fused_step`
range over the step's calls in the traced window (a count)."""


def read(ctx):
    n = ctx.trace.range_host.get("fused_step", (0, 0.0))[0]
    ops = ctx.trace.range_device_ops.get("fused_step", 0)
    if n == 0 or ops == 0:
        return None
    return ops / n
