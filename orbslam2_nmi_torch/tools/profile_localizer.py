"""Where one localizer sweep's time goes on the card, by torch.profiler.

    python3 -m orbslam2_nmi_torch.tools.profile_localizer      # from the root of a checkout, one GPU

For each render mode (1: the textured mesh through kernel B3 and the
sampler; 4: the mesh's 2.2 M-point sampling through the point splat) it
builds `entry.localizer_entry()` at 960x540, warms up, and profiles three
calls of `evaluate_grid` on the initialization grid (125 renders x 27 warps,
one translation step off). It prints the device time summed by kernel name
(the largest first), the device's busy time against the wall time of the
same sweeps run without the profiler (and so its idle share: the binning's host side,
Python and launch gaps, the readback; the profiled window's share, which
tracing inflates, is printed beside it),
and the card's `nvidia-smi` line beside them. It refuses to run without
CUDA: its numbers are device numbers.
"""

from __future__ import annotations

import subprocess
import sys
import time

import torch

from orbslam2_nmi_torch import entry as entry_mod
from orbslam2_nmi_torch.slam.nmi import search_kernel as sk

CALLS = 3
TOP = 12


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile(render_mode: int, smi: str) -> dict:
    loc, frame, T = entry_mod.localizer_entry(device="cuda", render_mode=render_mode)
    T[0, 3] = -loc.cfg.grid.synth_step[0]
    kernel = sk.initial_kernel_for_init(loc.initial_kernel)
    for _ in range(2):
        loc.evaluate_grid(frame, T, kernel)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(CALLS):
        loc.evaluate_grid(frame, T, kernel)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t) * 1e3  # unprofiled: tracing adds host time
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        t = time.perf_counter()
        for _ in range(CALLS):
            loc.evaluate_grid(frame, T, kernel)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    # the device's own events (kernels, copies, fills); the host ops that
    # launched them carry the same time and are left out
    rows = sorted(((_device_us(e), e.key, e.count) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0),
                  reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    print(f"render mode {render_mode}: {CALLS} sweeps of {kernel.n_synth} x {kernel.n_warp} "
          f"at {loc.width}x{loc.height}: wall {plain_wall_ms / CALLS:.3f} ms a sweep "
          f"({wall_ms / CALLS:.3f} profiled), device busy {busy_ms / CALLS:.3f} ms a sweep, "
          "idle share "
          + (f"{1 - busy_ms / plain_wall_ms:.3f} ({1 - busy_ms / wall_ms:.3f} profiled)"
             if busy_ms > 0 else "not measured (no device time)")
          + f"  [{smi}]")
    for us, name, count in rows[:TOP]:
        print(f"  {us / 1e3 / CALLS:9.3f} ms a sweep  {count // CALLS:5d} launches  {name[:110]}")
    return dict(wall_ms=plain_wall_ms / CALLS, busy_ms=busy_ms / CALLS,
                top=[(name, us / 1e3 / CALLS) for us, name, _ in rows[:TOP]])


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_localizer: CUDA is not available; this tool measures an NVIDIA GPU",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    for mode in (1, 4):
        profile(mode, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
