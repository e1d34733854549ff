"""Named profiler ranges around the port's subsystem entry points.

Each entry point runs inside a `torch.profiler.record_function` range named
after the JAX package's jitted function that does the same work (`fused_step`,
`bundle_adjust`, `rasterize_keys`, ...), or, where the function's own name
says less, `<reference name>.<function>` (`entropy.nmi_scores`). A range
changes nothing the function computes, and is opened only while a profiler
runs: a range costs ~11 us a call, as much as a kernel wrapper's own host
time. `tools/device_budget.py` charges each device kernel to the innermost
range open on the thread that launched it, and buckets the ranges by the
reference's module-name rules.
"""

from __future__ import annotations

import functools

import torch

NAMES: set = set()  # every range name in use, filled as the modules import


def _profiling() -> bool:
    # torch keeps this flag for cheap checks; a torch without it always records
    return getattr(torch.autograd.profiler, "_is_profiler_enabled", True)


def labelled(name: str):
    """Decorator: while a profiler runs, each call of the function runs inside
    a fresh range `name` (a fresh one a call, so that threads never share a
    range object)."""
    NAMES.add(name)

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _profiling():
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return wrapper

    return deco
