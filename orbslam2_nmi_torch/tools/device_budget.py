"""Per-subsystem device-time budget of the full replay, from a profiler trace.

    python3 -m orbslam2_nmi_torch.tools.device_budget [--frames 160] [--window 60]
        [--domain-gap] [--classic] [--device cuda]

Port of `orbslam2_nmi_tpu/tools/device_budget.py`. It runs the real replay
(tracking, NMI, local BA, fusion, loop closing: the path `tools/bench.py`
reports) under `torch.profiler` and sums the device time of every kernel,
copy and fill the card ran into subsystem buckets. Unlike summing
microbenchmarks, this counts every operation the pipeline really launched,
the workers' overlapped work included; unlike wall clock, it leaves out the
host. The analogous evaluation in the reference is mono_ETH.cc:107-151
(per-frame wall timing on an in-chassis GPU).

Attribution: the JAX tool buckets XLA module names. Here each device
operation is charged to the innermost named range (`utils/profiling.py`)
open on the thread that launched it, when it was launched
(`device_label_times`); the ranges carry the JAX package's jitted function
names, so `BUCKETS` and `classify` are the JAX tool's and the buckets
compare key for key. The replayed tracking step is one graph launch inside
`fused_step`, so all its kernels land there. The mapping and NMI workers
launch from their own threads (the mapping worker on its own stream); the
profiler records every thread's ranges where this torch offers it
(`profile_all_threads`), and the device time whose launch it could not
place is reported as `unattributed_ms_by_stream` and counted in "other".

Output: one JSON dict with the JAX tool's keys ({subsystem: device ms},
device ms a frame, the wall fps of the same run), and besides them the
device's idle share over the traced window, from the union of the
operations' intervals (streams that overlap count once).
"""

from __future__ import annotations

import collections
import json
import re
import time
from contextlib import contextmanager

import numpy as np
import torch

from orbslam2_nmi_torch.utils import profiling

# range-name substring -> subsystem bucket (first match wins); the JAX tool's
BUCKETS = [
    ("fused_step", "tracking_fused_step"),
    ("jit_step", "tracking_fused_step"),  # fused_track.make_fused_step's jit
    ("extract", "orb_extraction"),
    ("pyramid", "orb_extraction"),
    ("rasterize", "nmi_render"),
    ("sample_texture", "nmi_render"),
    ("gather_windows", "nmi_render"),
    ("render", "nmi_render"),
    ("warp", "nmi_warp"),
    ("entropy", "nmi_score"),
    ("bundle_adjust", "bundle_adjustment"),
    ("solve_structure", "bundle_adjustment"),
    ("pose_optimization", "pose_optimization"),
    ("pose_graph", "pose_graph"),
    ("sim3", "loop_closing"),
    ("match", "matching"),
    ("triangulate", "local_mapping"),
    ("fuse", "local_mapping"),
    ("epipolar", "local_mapping"),
    ("pnp", "relocalization"),
    ("word", "place_recognition"),
    ("vocab", "place_recognition"),
]
UNLABELLED = "(no range)"  # launched outside every named range
TOP = 12
# CUDA runtime and driver API calls (cudaLaunchKernel, cudaGraphLaunch, cuLaunchKernel)
_CUDA_API = re.compile(r"cu(da)?[A-Z]")
# the port's hand-written kernels (csrc/*.cu), reported by range apart
CUDA_KERNELS = ("joint_entropy_kernel", "marginal_entropy_kernel", "rasterize_keys_kernel",
                "render_gray_kernel")


def classify(name: str) -> str:
    n = name.lower()
    for sub, bucket in BUCKETS:
        if sub in n:
            return bucket
    return "other"


def budget_from_module_times(mod_times: dict, n_frames: int) -> dict:
    """{name: seconds} -> the JAX tool's budget dict (its rounding too)."""
    buckets: dict = collections.defaultdict(float)
    for name, sec in mod_times.items():
        buckets[classify(name)] += sec
    total = sum(buckets.values())
    return {
        "device_s_total": round(total, 3),
        "device_ms_per_frame": round(total / max(n_frames, 1) * 1e3, 2),
        "fits_33ms_per_frame": bool(total / max(n_frames, 1) <= 0.033),
        "by_subsystem_ms": {
            k: round(v * 1e3, 1) for k, v in sorted(buckets.items(), key=lambda kv: -kv[1])
        },
    }


@contextmanager
def traced(device=None):
    """A `torch.profiler.profile` of the host and, on CUDA, the card,
    recording every thread's ranges where this torch offers it."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device or "cuda").type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        cfg = None
    with torch.profiler.profile(activities=acts, experimental_config=cfg) as prof:
        yield prof


def _innermost(intervals: list, queries: list) -> dict:
    """For each query (t, key), the name of the innermost interval (start,
    end, name) of one thread that contains t (None where none does); the
    intervals nest, as ranges on one thread do."""
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


def device_label_times(prof) -> tuple:
    """({range name: device seconds}, info) of a finished `traced()` profile.

    Each device operation (kernels, copies, fills; not the profiler's own
    device-side annotations) is charged to the innermost named range open on
    the thread that launched it, when it was launched, or to `UNLABELLED`.
    The launch is found two ways: through the profiler's link from the
    operation to the host op that launched it (torch's own kernels), or,
    where there is no such link (a CUDA graph's replay, the hand-written
    kernels launched through ctypes), through the CUDA API call that
    launched it (`cudaGraphLaunch`, `cudaLaunchKernel`; the same correlation
    id), placed on the profiler's thread by its system thread, which the
    host ops name too. `info`:
    the summed and the union device seconds, the number of operations, the
    device ms whose launch was not found, by stream, and each of
    `CUDA_KERNELS`' device ms by range."""
    cuda = torch.autograd.DeviceType.CUDA
    names = profiling.NAMES
    by_key: dict = collections.defaultdict(int)  # ("op", host op id) or ("api", call id) -> ns
    stream_of: dict = {}
    watched: dict = collections.defaultdict(int)  # (kernel, key) -> ns
    starts, ends = [], []
    host_ops: dict = {}  # host op id -> (thread, start)
    api: dict = {}  # CUDA API call id -> (system thread, start)
    votes: dict = collections.defaultdict(collections.Counter)  # system thread -> threads
    ranges: dict = collections.defaultdict(list)  # thread -> [(start, end, name)]
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            if e.is_user_annotation():
                continue
            s, t = e.start_ns(), e.end_ns()
            starts.append(s)
            ends.append(t)
            lc = e.linked_correlation_id()
            key = ("op", lc) if lc > 0 else ("api", e.correlation_id())
            by_key[key] += t - s
            if key not in stream_of:
                stream_of[key] = e.device_resource_id()
            name = e.name()
            for k in CUDA_KERNELS:
                if k in name:
                    watched[k, key] += t - s
            continue
        # a host event's `device_resource_id` is its system thread; a CUDA API
        # call outside every host op carries no profiler thread of its own
        name = e.name()
        if _CUDA_API.match(name):
            api[e.correlation_id()] = (e.device_resource_id(), e.start_ns())
        elif e.linked_correlation_id() == 0:  # a host op or a range
            tid, s = e.start_thread_id(), e.start_ns()
            host_ops[e.correlation_id()] = (tid, s)
            votes[e.device_resource_id()][tid] += 1
            if name in names:
                ranges[tid].append((s, e.end_ns(), name))
    # the profiler's thread of each system thread that ran host ops
    thread_of = {k: v.most_common(1)[0][0] for k, v in votes.items()}
    queries: dict = collections.defaultdict(list)
    lost: dict = collections.defaultdict(int)
    routes = dict(host_op=0, cuda_api_call=0, not_found=0)  # device ns by how the launch was found
    for key, ns in by_key.items():
        where = None
        if key[0] == "op":
            where = host_ops.get(key[1])
        elif key[1] in api:
            sys_tid, t0 = api[key[1]]
            if sys_tid in thread_of:
                where = (thread_of[sys_tid], t0)
        if where is None:
            lost[stream_of[key]] += ns
            routes["not_found"] += ns
        else:
            queries[where[0]].append((where[1], key))
            routes["host_op" if key[0] == "op" else "cuda_api_call"] += ns
    times: dict = collections.defaultdict(float)
    range_of: dict = {}
    for tid, q in queries.items():
        for key, name in _innermost(ranges.get(tid, []), q).items():
            range_of[key] = name or UNLABELLED
            times[range_of[key]] += by_key[key] / 1e9
    for ns in lost.values():
        times[UNLABELLED] += ns / 1e9
    kernels_ms: dict = collections.defaultdict(lambda: collections.defaultdict(float))
    for (k, key), ns in watched.items():
        kernels_ms[k][range_of.get(key, UNLABELLED)] += ns / 1e6
    busy = float(sum(ends) - sum(starts)) / 1e9
    union = 0.0
    if starts:
        order = np.argsort(np.asarray(starts, np.int64))
        s_arr = np.asarray(starts, np.int64)[order]
        e_arr = np.maximum.accumulate(np.asarray(ends, np.int64)[order])
        gap = np.maximum(s_arr[1:] - e_arr[:-1], 0)
        union = float(e_arr[-1] - s_arr[0] - gap.sum()) / 1e9
    info = dict(device_busy_s=busy, device_union_s=union, n_device_ops=len(starts),
                unattributed_ms_by_stream={str(k): v / 1e6 for k, v in lost.items()},
                launch_found_ms={k: v / 1e6 for k, v in routes.items()},
                cuda_kernels_ms={k: dict(v) for k, v in kernels_ms.items()})
    return dict(times), info


def _summary(times: dict, info: dict, n_frames: int, wall_s: float) -> dict:
    budget = budget_from_module_times(times, n_frames)
    union = info["device_union_s"]
    ranked = sorted(times.items(), key=lambda kv: -kv[1])
    budget.update(
        top_modules_ms={k: v * 1e3 for k, v in ranked[:TOP]},
        modules_ms={k: v * 1e3 for k, v in ranked},
        traced_wall_s=wall_s,
        device_idle_share_union=1.0 - union / wall_s if wall_s > 0 else None,
        **info,
    )
    return budget


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _sequence(world, frames, n_frames, n_total, width, height, domain_gap, device):
    from orbslam2_nmi_torch.tools import replay_bench

    if frames is None:
        world, frames = replay_bench.generate_sequence(n_frames, width, height, n_total=n_total,
                                                       domain_gap=domain_gap, device=device)
    return world, frames[:n_frames]


def run(n_frames: int = 160, n_total: int = 520, width: int = 960, height: int = 540,
        pipelined: bool = True, domain_gap: bool = False, device="cuda", world=None,
        frames=None) -> dict:
    """The budget of a whole replay of `n_frames` (after an unprofiled warm
    pass over 48 frames: the kernels' build and the graph capture stay out
    of the trace). `world` and `frames` from `replay_bench.generate_sequence`
    may be passed in."""
    from orbslam2_nmi_torch.tools import replay_bench

    world, frames = _sequence(world, frames, n_frames, n_total, width, height, domain_gap,
                              device)
    threshold = 0.1 if domain_gap else 0.45
    replay_bench.run_replay(world, frames[: min(48, n_frames)], n_total=n_total,
                            pipelined=pipelined, threshold=threshold, device=device)
    t0 = time.perf_counter()
    with traced(device) as prof:
        out = replay_bench.run_replay(world, frames, n_total=n_total, pipelined=pipelined,
                                      warmup=0, threshold=threshold, device=device)
        _sync(device)
    wall = time.perf_counter() - t0
    times, info = device_label_times(prof)
    budget = _summary(times, info, n_frames, wall)
    budget.update(n_frames=n_frames, wall_fps=out["fps_steady"], ate_rmse_m=out["ate_rmse"],
                  n_keyframes=out["n_keyframes"], n_nmi_anchors=out["n_nmi_anchors"])
    return budget


def run_windowed(n_frames: int = 160, window_start: int = 60, n_total: int = 520,
                 width: int = 960, height: int = 540, domain_gap: bool = False, device="cuda",
                 world=None, frames=None, warm: bool = True) -> dict:
    """The measured steady-state budget: trace only frames [window_start,
    n_frames) of one continuous pipelined replay, so the NMI init latches
    and the bootstrap stay outside the window. The async mapping and NMI
    work the window starts is drained inside the trace, so its device time
    is charged to the window. Also the window's per-frame completion walls.
    With `warm`, an unprofiled 48-frame replay first builds the kernels and
    captures the step (pass False when this process has run them)."""
    from orbslam2_nmi_torch.slam.frontend_pipelined import PipelinedFrontend
    from orbslam2_nmi_torch.tools import replay_bench

    world, frames = _sequence(world, frames, n_frames, n_total, width, height, domain_gap,
                              device)
    threshold = 0.1 if domain_gap else 0.45
    if warm:
        replay_bench.run_replay(world, frames[: min(48, n_frames)], n_total=n_total,
                                pipelined=True, threshold=threshold, device=device)
    sys_ = replay_bench.build_system(world, width, height, threshold=threshold, device=device)
    try:
        sys_.set_init_poses(world.pose_at(0, n_total),
                            world.pose_at(sys_.cfg.nmi.offset, n_total))
        fe = PipelinedFrontend(sys_)
        ts = np.arange(n_frames) / 30.0
        fe.run(frames[:window_start], ts[:window_start], start_id=0)
        replay_bench.drain(sys_)  # the init's async work is not the window's
        _sync(device)
        t0 = time.perf_counter()
        with traced(device) as prof:
            fe.run(frames[window_start:], ts[window_start:], start_id=window_start)
            replay_bench.drain(sys_)
            _sync(device)
        wall = time.perf_counter() - t0
        n_win = n_frames - window_start
        times, info = device_label_times(prof)
        budget = _summary(times, info, n_win, wall)
        walls = [fe.completion_walls[f] for f in sorted(fe.completion_walls) if f >= window_start]
        d = np.diff(np.asarray(walls))
        with sys_.map.lock:
            budget.update(
                window=[window_start, n_frames], wall_fps_window=n_win / wall,
                frame_ms_p50=float(np.median(d)) * 1e3,
                frame_ms_p95=float(np.quantile(d, 0.95)) * 1e3,
                frame_ms_max=float(d.max()) * 1e3, n_keyframes=int(sys_.map.n_keyframes),
                n_nmi_anchors=replay_bench.count_anchors(sys_.map))
        return budget
    finally:
        sys_.shutdown()


def main(argv=None) -> int:
    import argparse

    from orbslam2_nmi_torch import kernels

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--frames", type=int, default=160)
    p.add_argument("--total", type=int, default=520)
    p.add_argument("--classic", action="store_true")
    p.add_argument("--window", type=int, default=None, metavar="START",
                   help="measured steady-state mode: trace only frames [START, --frames) of "
                        "one continuous replay")
    p.add_argument("--domain-gap", action="store_true",
                   help="the domain-gap imagery at the accept threshold 0.1")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cpu runs the replay with no device time to count")
    args = p.parse_args(argv)
    device = kernels.resolve_device(args.device, "device_budget")
    if args.window is not None:
        out = run_windowed(args.frames, args.window, args.total, domain_gap=args.domain_gap,
                           device=device)
    else:
        out = run(args.frames, args.total, pipelined=not args.classic,
                  domain_gap=args.domain_gap, device=device)
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
