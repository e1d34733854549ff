"""Device ms a tracking step: the device time charged to the `fused_step`
range (the replayed CUDA graph) over the step's calls in the traced window."""


def read(ctx):
    n = ctx.trace.range_host.get("fused_step", (0, 0.0))[0]
    if n == 0 or ctx.trace.busy_s <= 0:
        return None
    return 1e3 * ctx.trace.range_device_s.get("fused_step", 0.0) / n
