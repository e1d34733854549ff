"""Reading the profiler's trace of a `--trace 1` window.

The attribution is that of `orbslam2_nmi_torch/tools/device_budget.py`
(`device_label_times`), copied here: each device operation (kernel, copy,
fill) is charged to the innermost named range open on the thread that
launched it, found through the profiler's link to the launching host op or,
for a CUDA graph's replay and the ctypes kernels, through the CUDA API call
that launched it. Besides, this module reads each named range's host time
and count, each device kernel's time and count by name, the union of the
device's busy intervals inside the window (streams that overlap count once),
and the idle gaps between them labelled by the innermost range the window's
thread had open in the middle of each gap.
"""

from __future__ import annotations

import collections
import re
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np
import torch

from slambench import stats

WINDOW = "slambench.window"  # the range around the whole measured window
UNLABELLED = "(no range)"
_CUDA_API = re.compile(r"cu(da)?[A-Z]")


@contextmanager
def traced():
    """A profile of the host and the card, every thread's ranges recorded
    where this torch offers it."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        cfg = None
    with torch.profiler.profile(activities=acts, experimental_config=cfg) as prof:
        yield prof


class Tracer:
    """Opens the profiler and the `WINDOW` range around the stretch of a
    window a driver traces (`with tracer(): ...`); `prof` holds the finished
    profile."""

    def __init__(self):
        self.prof = None

    @contextmanager
    def __call__(self):
        with traced() as prof:
            with torch.profiler.record_function(WINDOW):
                yield
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
        self.prof = prof


@dataclass
class Trace:
    window_s: float = 0.0
    busy_s: float = 0.0  # union of device intervals inside the window
    range_device_s: dict = field(default_factory=dict)  # innermost range -> device s
    range_device_ops: dict = field(default_factory=dict)  # innermost range -> device operations
    range_host: dict = field(default_factory=dict)  # range -> (count, host s)
    kernel_device: dict = field(default_factory=dict)  # kernel name -> (count, device s)
    idle_by_range: dict = field(default_factory=dict)  # range -> idle s

    def device_s(self, names) -> float:
        return sum(self.range_device_s.get(n, 0.0) for n in names)

    def kernel(self, substring: str) -> tuple:
        n, s = 0, 0.0
        for name, (c, t) in self.kernel_device.items():
            if substring in name:
                n, s = n + c, s + t
        return n, s


def _innermost(intervals: list, queries: list) -> dict:
    intervals.sort(key=lambda x: (x[0], -x[1]))
    queries.sort()
    out, stack, i = {}, [], 0
    for t, key in queries:
        while i < len(intervals) and intervals[i][0] <= t:
            while stack and stack[-1][1] < intervals[i][0]:
                stack.pop()
            stack.append(intervals[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[key] = stack[-1][2] if stack else None
    return out


def read(prof, names: set) -> Trace:
    """The `Trace` of a finished `traced()` profile whose window ran inside a
    `WINDOW` range; `names` are the range names to attribute to."""
    cuda = torch.autograd.DeviceType.CUDA
    names = set(names) | {WINDOW}
    by_key: dict = collections.defaultdict(int)
    ops_of: dict = collections.defaultdict(int)
    intervals = []
    kernels: dict = collections.defaultdict(lambda: [0, 0])
    host_ops: dict = {}
    api: dict = {}
    votes: dict = collections.defaultdict(collections.Counter)
    ranges: dict = collections.defaultdict(list)
    window = None
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            if e.is_user_annotation():
                continue
            s, t = e.start_ns(), e.end_ns()
            intervals.append((s, t))
            lc = e.linked_correlation_id()
            key = ("op", lc) if lc > 0 else ("api", e.correlation_id())
            by_key[key] += t - s
            ops_of[key] += 1
            k = kernels[e.name()]
            k[0] += 1
            k[1] += t - s
            continue
        name = e.name()
        if _CUDA_API.match(name):
            api[e.correlation_id()] = (e.device_resource_id(), e.start_ns())
        elif e.linked_correlation_id() == 0:
            tid, s = e.start_thread_id(), e.start_ns()
            host_ops[e.correlation_id()] = (tid, s)
            votes[e.device_resource_id()][tid] += 1
            if name in names:
                ranges[tid].append((s, e.end_ns(), name))
                if name == WINDOW:
                    window = (s, e.end_ns(), tid)
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    w0, w1, w_tid = window
    thread_of = {k: v.most_common(1)[0][0] for k, v in votes.items()}
    queries: dict = collections.defaultdict(list)
    times: dict = collections.defaultdict(float)
    n_ops: dict = collections.defaultdict(int)
    for key, ns in by_key.items():
        where = None
        if key[0] == "op":
            where = host_ops.get(key[1])
        elif key[1] in api and api[key[1]][0] in thread_of:
            where = (thread_of[api[key[1]][0]], api[key[1]][1])
        if where is None:
            times[UNLABELLED] += ns / 1e9
            n_ops[UNLABELLED] += ops_of[key]
        else:
            queries[where[0]].append((where[1], key))
    for tid, q in queries.items():
        for key, name in _innermost(list(ranges.get(tid, [])), q).items():
            times[name or UNLABELLED] += by_key[key] / 1e9
            n_ops[name or UNLABELLED] += ops_of[key]
    host: dict = collections.defaultdict(lambda: [0, 0.0])
    for rs in ranges.values():
        for s, t, name in rs:
            host[name][0] += 1
            host[name][1] += (t - s) / 1e9
    clipped = [(max(s, w0), min(t, w1)) for s, t in intervals if t > w0 and s < w1]
    busy = stats.union_seconds([(s / 1e9, t / 1e9) for s, t in clipped])
    # idle gaps inside the window, by the window thread's innermost range
    idle: dict = collections.defaultdict(float)
    if clipped:
        arr = np.asarray(sorted(clipped), np.int64)
        ends = np.maximum.accumulate(arr[:, 1])
        gap_lo = np.concatenate([[w0], ends])
        gap_hi = np.concatenate([arr[:, 0], [w1]])
        gq = [(int((lo + hi) // 2), (int(lo), int(hi))) for lo, hi in zip(gap_lo, gap_hi)
              if hi > lo]
        for (lo, hi), name in _innermost(list(ranges.get(w_tid, [])), gq).items():
            idle[name or UNLABELLED] += (hi - lo) / 1e9
    return Trace(window_s=(w1 - w0) / 1e9, busy_s=busy,
                 range_device_s=dict(times), range_device_ops=dict(n_ops),
                 range_host={k: (c, s) for k, (c, s) in host.items()},
                 kernel_device={k: (c, s / 1e9) for k, (c, s) in kernels.items()},
                 idle_by_range=dict(idle))


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device time by the innermost range that launched it, and the idle
    time by the range the host had open, each as [name, seconds], largest
    first."""
    ops = sorted(tr.range_device_s.items(), key=lambda kv: -kv[1])
    gaps = sorted(tr.idle_by_range.items(), key=lambda kv: -kv[1])
    return {"device_ops": [[k, s] for k, s in ops[:top]],
            "idle_gaps": [[k, s] for k, s in gaps[:top]]}
