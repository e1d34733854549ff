"""Seconds of the program's own set-up, recorded before the window: the sum
of the set-up counters in `orbslam2_nmi_torch.utils.profiling.SETUP` (the
kernel library's build or load, the vocabulary's load, the tracking step's
graph capture, the NMI init latches), each the first reading of its process.
A program without the counters gives nothing to read."""


def read(ctx):
    from orbslam2_nmi_torch.utils import profiling

    setup = getattr(profiling, "SETUP", None)
    if setup is None:
        return None
    return sum(s for s, t in setup.values() if t <= ctx.res["t_start"])
