"""Where the tracking step's time goes on the card, by torch.profiler.

    python3 -m orbslam2_nmi_torch.tools.profile_tracking    # from the root of a checkout, one GPU

It builds `entry.tracking_entry()` at the full circuit's configuration
(960x540, 2,000 features, 2,048 candidates), runs the per-frame loop a user
runs (candidates at the last pose, upload, step, readback, `unpack_step`)
over a window of frames, once without the profiler for its wall time and
once profiled for the device's time by kernel, and prints the device's busy
time against that wall time, so its idle share (the host's candidate build,
launch gaps, the readback; the profiled window's share, which tracing
inflates, is printed beside it), with the card's `nvidia-smi` line. It does
so twice: replaying the step's CUDA graph, and eagerly. It refuses to run
without CUDA: its numbers are device numbers.
"""

from __future__ import annotations

import subprocess
import sys
import time

import torch

from orbslam2_nmi_torch.entry import tracking_entry
from orbslam2_nmi_torch.slam.fused_track import unpack_step

WINDOW = 8  # frames a run
TOP = 15


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _loop(step, run, frames, carry, candidates, first: int):
    """The per-frame loop over frames first .. first+WINDOW-1, each step
    through `run` (the step itself, which replays, or `step.run_eager`);
    returns the carry after it."""
    T_last = carry.Tcw.cpu().numpy()
    for i in range(first, first + WINDOW):
        out = run(frames[i], carry, *candidates(T_last))
        u = unpack_step(out.packed.cpu().numpy(), step.n_feat, step.n_cand)
        carry, T_last = out.carry, u.Tcw
    return carry


def profile(step, run, frames, carry, candidates, smi: str, label: str) -> dict:
    carry = _loop(step, run, frames, carry, candidates, 0)  # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    _loop(step, run, frames, carry, candidates, WINDOW)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t) * 1e3  # unprofiled: tracing adds host time
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        t = time.perf_counter()
        _loop(step, run, frames, carry, candidates, WINDOW)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    # the device's own events (kernels, copies, fills, graph replays' kernels)
    rows = sorted(((_device_us(e), e.key, e.count) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0),
                  reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    launches = sum(r[2] for r in rows)
    print(f"{label}: {WINDOW} frames at {frames.shape[2]}x{frames.shape[1]}: wall "
          f"{plain_wall_ms / WINDOW:.3f} ms a frame ({wall_ms / WINDOW:.3f} profiled), device "
          f"busy {busy_ms / WINDOW:.3f} ms a frame, {launches // WINDOW} device operations a "
          "frame, idle share "
          + (f"{1 - busy_ms / plain_wall_ms:.3f} ({1 - busy_ms / wall_ms:.3f} profiled)"
             if busy_ms > 0 else "not measured (no device time)")
          + f"  [{smi}]")
    for us, name, count in rows[:TOP]:
        print(f"  {us / 1e3 / WINDOW:9.4f} ms a frame  {count // WINDOW:6d} a frame  {name[:100]}")
    return dict(wall_ms=plain_wall_ms / WINDOW, busy_ms=busy_ms / WINDOW,
                ops=launches // WINDOW,
                top=[(name, us / 1e3 / WINDOW) for us, name, _ in rows[:TOP]])


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_tracking: CUDA is not available; this tool measures an NVIDIA GPU",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    step, frames, carry, candidates, _ = tracking_entry(device="cuda", count=3 * WINDOW)
    profile(step, step, frames, carry, candidates, smi, "replayed")  # first call captures
    profile(step, step.run_eager, frames, carry, candidates, smi, "eager")
    return 0


if __name__ == "__main__":
    sys.exit(main())
