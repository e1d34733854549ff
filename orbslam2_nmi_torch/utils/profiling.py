"""The port's tracing: named profiler ranges, set-up counters, bounded records.

Each entry point runs inside a `torch.profiler.record_function` range named
after the JAX package's jitted function that does the same work (`fused_step`,
`bundle_adjust`, `rasterize_keys`, ...), or, where the function's own name
says less, `<reference name>.<function>` (`entropy.nmi_scores`). A phase
inside a function runs inside a range of its own (`span`), under the same
rules. A range changes nothing the function computes, and is opened only
while a profiler runs: a range costs ~11 us a call, as much as a kernel
wrapper's own host time. `tools/device_budget.py` charges each device kernel
to the innermost range open on the thread that launched it, and buckets the
ranges by the reference's module-name rules.

Set-up steps that a process runs once (the kernel library's build or load,
the vocabulary's load, the graph capture, the NMI init latches, the NMI
localizer's mesh or point-cloud upload) record their seconds in `SETUP`. Per-frame and per-keyframe counters go into the records
the front-end and the mapper keep (`PipelinedFrontend.records`,
`LocalMapper.records`), which hold the newest entries only (`Newest`); a
timestamp meant to be laid on a profile is taken with `clock_ns`.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import threading
import time

import torch

NAMES: set = set()  # every range name in use, filled as the modules import

# set-up step -> (seconds, time.perf_counter() when recorded); the first
# reading of each step in this process
SETUP: dict = {}
_setup_lock = threading.Lock()

_OFF = contextlib.nullcontext()

# The profiler's clock: a kineto event's `start_ns()` is Unix-epoch ns, so a
# `time.time_ns()` reading lies on the trace of the same process.
clock_ns = time.time_ns


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


def span(name: str):
    """A phase inside a function, named `name`: `PHASE = span(name)` where
    the module imports, then `with PHASE():` around the phase. While a
    profiler runs, each entry opens a fresh range `name`; otherwise it is
    one flag check."""
    NAMES.add(name)

    def enter():
        if not _profiling():
            return _OFF
        return torch.profiler.record_function(name)

    return enter


def record_setup(name: str, seconds: float) -> None:
    """Record a set-up step's seconds; a step recorded before keeps its
    first reading."""
    with _setup_lock:
        SETUP.setdefault(name, (float(seconds), time.perf_counter()))


class Newest(collections.OrderedDict):
    """A dict that keeps the `maxlen` keys set most recently for the first
    time: setting a new key beyond that drops the oldest."""

    def __init__(self, maxlen: int):
        super().__init__()
        self.maxlen = maxlen

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        if len(self) > self.maxlen:
            self.popitem(last=False)
