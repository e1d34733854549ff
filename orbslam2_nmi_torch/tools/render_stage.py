"""Time the mesh render stage of a checkout on one GPU, and compare two checkouts.

    python3 -m orbslam2_nmi_torch.tools.render_stage                 # this checkout
    python3 -m orbslam2_nmi_torch.tools.render_stage --turns build/parent

The render stage is `ops/raster.render_mesh_grid`: in this checkout one launch
of `render_gray` (kernel B3 with the texture sampler fused into its epilogue);
in a checkout before that, B3's keys, the sampler's launch over them and the
untiling copy. The stage is timed at two shapes, each with CUDA events (mean
of 20 calls back to back after 3): the grid step's (`entry.entry()`: 960x540,
27 candidates, 12,482 faces, a 256x256 texture) and the bench sweep's
(`tools/bench.py`: 960x540, 27 candidates, 71,442 faces, 512x512). Each
kernel wrapper of the stage that the checkout has (`rasterize_keys`,
`sample_texture`, `render_gray`) is timed alone beside it, and where the
checkout's library can say so, the registers, shared memory and resident
blocks per SM of its two raster kernels.

`--root DIR` times the package found under DIR instead (an earlier commit
unpacked there with `git archive`; its kernels build under DIR/build).
`--turns DIR` runs the earlier checkout and this one in turns, earlier,
this, this, earlier, one process each, on the same card, so that the two
are compared within one run. Each run prints one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve()
REPS, WARMUP = 20, 3


def _import_package(root: Path):
    """The package under `root`, imported in place of any other."""
    if str(HERE.parent) in sys.path:  # run as a file: tools/ heads the path
        sys.path.remove(str(HERE.parent))
    sys.path.insert(0, str(root))
    from orbslam2_nmi_torch import entry, kernels
    from orbslam2_nmi_torch.ops import raster
    from orbslam2_nmi_torch.tools import bench

    if not Path(raster.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {raster.__file__}, not the package under {root}")
    return entry, kernels, raster, bench


def _ms(torch, fn) -> float:
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def raster_resources(kernels) -> dict | None:
    """Registers, static shared memory and resident blocks per SM of the two
    raster kernels, as the CUDA runtime reports them; None for a library
    without `nmi_raster_resources` (a checkout before the gray epilogue)."""
    handle = kernels.lib()
    fn = getattr(handle, "nmi_raster_resources", None)
    if fn is None:
        return None
    fn.argtypes = (ctypes.c_int, *([ctypes.POINTER(ctypes.c_int)] * 3))
    fn.restype = ctypes.c_int
    out = {}
    for gray, name in ((0, "rasterize_keys_kernel"), (1, "render_gray_kernel")):
        regs, smem, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        if fn(gray, ctypes.byref(regs), ctypes.byref(smem), ctypes.byref(blocks)) != 0:
            raise RuntimeError(f"cudaFuncGetAttributes failed for {name}")
        out[name] = dict(registers=regs.value, shared_bytes=smem.value,
                         blocks_per_sm=blocks.value)
    return out


def run(root: Path) -> dict:
    """Time the render stage of the package under `root` at both shapes."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("render_stage times the card: no CUDA device is available")
    entry, kernels, raster, bench = _import_package(root)
    fn, (_, Tcw) = entry.entry(device="cuda")
    inp = bench.sweep_inputs("cuda")
    shapes = {
        "grid_step": (fn.binned, Tcw, fn.K, fn.offsets, entry.NEAR, entry.FAR),
        "bench_sweep": (inp.binned, inp.Tcw, inp.K, inp.offsets, bench.NEAR, bench.FAR),
    }
    out = dict(root=str(root), card=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), resources=raster_resources(kernels))
    for name, (b, T, K, offsets, near, far) in shapes.items():
        poses = raster.grid_poses(T, offsets)
        rargs = (b.tri_data, poses, b.capacity, float(K[0, 0]), float(K[1, 1]),
                 float(K[0, 2]), float(K[1, 2]), near, b.tiles_x)
        th, tw = b.tex_hw
        kernels.reset_launches()
        img = raster.render_mesh_grid(b, T, K, offsets, near, far)
        torch.cuda.synchronize()
        row = dict(launches={k: v for k, v in kernels.LAUNCHES.items() if v},
                   shape=list(img.shape),
                   stage_ms=_ms(torch, lambda: raster.render_mesh_grid(b, T, K, offsets, near,
                                                                       far)),
                   rasterize_keys_ms=_ms(torch, lambda: raster.rasterize_keys(*rargs)))
        if hasattr(raster, "sample_texture"):
            keys, uu, vv = raster.rasterize_keys(*rargs)
            gray = raster.sample_texture(keys, uu, vv, b.texture, th, tw, 0.0)
            row["sample_texture_ms"] = _ms(
                torch, lambda: raster.sample_texture(keys, uu, vv, b.texture, th, tw, 0.0))
            # the copy that `render_mesh_grid` made (its reshape of the permuted tiles)
            row["untile_ms"] = _ms(torch, lambda: raster._untile(
                gray, poses.shape[0], b.tiles_y, b.tiles_x, b.height, b.width))
            del keys, uu, vv, gray
        if hasattr(raster, "render_gray"):
            gargs = (*rargs, b.texture, th, tw, 0.0, b.height, b.width)
            row["render_gray_ms"] = _ms(torch, lambda: raster.render_gray(*gargs))
        out[name] = row
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=HERE.parents[2],
                    help="the checkout whose package is timed (default: this one)")
    ap.add_argument("--turns", type=Path, metavar="DIR",
                    help="time the checkout under DIR and this one in turns")
    args = ap.parse_args(argv)
    if args.turns is None:
        print(json.dumps(run(args.root.resolve())))
        return 0
    this = HERE.parents[2]
    order = [args.turns.resolve(), this, this, args.turns.resolve()]
    for i, root in enumerate(order):
        print(f"turn {i + 1} of 4: {root}", flush=True)
        rc = subprocess.run([sys.executable, str(HERE), "--root", str(root)], cwd=root,
                            env=dict(os.environ)).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
