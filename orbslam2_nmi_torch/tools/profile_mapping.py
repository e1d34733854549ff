"""Where the mapping path's time goes on the card.

    python3 -m orbslam2_nmi_torch.tools.profile_mapping    # from the root of a checkout, one GPU

It builds `entry.mapping_entry()` (the full-circuit replay configuration at
960x540), initializes the map and tracks frames 9-48 with each keyframe
processed at once on the tracking thread, so the map holds keyframes. Then:

1. it times the last local BA alone, and beside a loop of tracking-step
   replays on the main thread that waits for each replay in one of three
   ways: `torch.cuda.synchronize()`, `Tensor.cpu()` of the packed buffer,
   and `utils.readback.to_host` (a pinned copy and a CUDA event), the BA on
   a thread and a stream of its own as the mapping worker runs it. A wait
   that holds the interpreter lock starves the BA's thread;
2. it profiles that local BA's solve alone with torch.profiler: device
   operations, device time and wall time;
3. it profiles one keyframe's new points and local BA with torch.profiler:
   device time by operation, launches, and host time.
Every time is printed with the card's `nvidia-smi` line. It refuses to run
without CUDA: its numbers are device numbers.
"""

from __future__ import annotations

import subprocess
import sys
import threading
import time

import numpy as np
import torch

from orbslam2_nmi_torch.entry import mapping_entry
from orbslam2_nmi_torch.slam.frontend_pipelined import local_candidates, upload_candidates
from orbslam2_nmi_torch.solvers import local_ba
from orbslam2_nmi_torch.utils.readback import to_host

LAST = 48  # the last tracked frame: keyframes 18, 28, 38, 48
REPS = 3
TOP = 12


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _device_rows(prof) -> list:
    """(device us, name, count) of each device operation, largest first."""
    return sorted(((_device_us(e), e.key, e.count) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0),
                  reverse=True)


def _ba_ms(prob) -> float:
    t = time.perf_counter()
    to_host(local_ba.bundle_adjust(prob).cam_Tcw)
    return (time.perf_counter() - t) * 1e3


def ba_beside(prob, replay, wait) -> tuple[list, int]:
    """ms of REPS local BAs on a thread and stream of their own while the
    main thread runs `replay()` (a tracking step) and waits by `wait(out)`;
    and the replays made meanwhile."""
    times = []
    stream = torch.cuda.Stream()

    def work():
        with torch.cuda.stream(stream):
            times.extend(_ba_ms(prob) for _ in range(REPS))

    worker = threading.Thread(target=work)
    worker.start()
    n = 0
    while worker.is_alive():
        wait(replay())
        n += 1
    worker.join()
    return times, n


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_mapping: CUDA is not available; this tool measures an NVIDIA GPU",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    session = mapping_entry(device="cuda", last=LAST)
    lm = session.local_mapper
    session.keyframe_sink = lm.process_keyframe  # each keyframe at once, on this thread
    if not session.initialize().ok:
        print("profile_mapping: the map was not initialized", file=sys.stderr)
        return 1
    errs = [session.track_frame(i)["err_m"] for i in session.track_ids]
    prob = lm._last_prob
    C, P, O = prob.cam_Tcw.shape[0], prob.pts_w.shape[0], prob.obs_cam.shape[0]
    print(f"map: {len(session.keyframes) + 2} keyframes, camera-centre error max "
          f"{max(errs):.4f} m over frames 9-{LAST}; the last local BA at (C, P, O) = "
          f"({C}, {P}, {O})  [{smi}]")

    step = session.step
    with session.map.lock:
        kfs = np.nonzero(session.map.kf_valid[: session.map.n_keyframes])[0]
        _, arrays = local_candidates(session.map, session.cfg, kfs, session.ref_kf,
                                     session.last.Tcw, session.step.n_cand)
    args = (session.frame(session.track_ids[-1]), session.carry,
            *upload_candidates(arrays, session.device))

    def replay():
        return step.replay(*args)

    _ba_ms(prob)  # warm-up
    alone = [_ba_ms(prob) for _ in range(REPS)]
    print(f"local BA alone: {[round(t, 1) for t in alone]} ms  [{smi}]")
    for name, wait in (("torch.cuda.synchronize()", lambda out: torch.cuda.synchronize()),
                       ("Tensor.cpu()", lambda out: out.packed.cpu()),
                       ("to_host (pinned copy, CUDA event)", lambda out: to_host(out.packed))):
        times, n = ba_beside(prob, replay, wait)
        print(f"local BA beside step replays waited by {name}: "
              f"{[round(t, 1) for t in times]} ms ({n} replays meanwhile)  [{smi}]")

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall_ms = _ba_ms(prob)
    rows = _device_rows(prof)
    print(f"local BA solve alone, profiled: wall {wall_ms:.1f} ms, device busy "
          f"{sum(r[0] for r in rows) / 1e3:.1f} ms, {sum(r[2] for r in rows)} device operations"
          f"  [{smi}]")

    k = session.keyframes[-1][1]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        lm._create_new_map_points(k)
        lm.local_bundle_adjust(k)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = _device_rows(prof)
    busy_ms = sum(r[0] for r in rows) / 1e3
    launches = sum(r[2] for r in rows)
    print(f"keyframe {k}'s new points and local BA, profiled: wall {wall_ms:.1f} ms, device "
          f"busy {busy_ms:.1f} ms, {launches} device operations  [{smi}]")
    for us, name, count in rows[:TOP]:
        print(f"  {us / 1e3:9.3f} ms  {count:6d}  {name[:100]}")
    session.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
