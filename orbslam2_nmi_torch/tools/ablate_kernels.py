"""Ablations of kernels B1 (joint entropy) and B3 (rasterizer), timed on the main path.

    python3 -m orbslam2_nmi_torch.tools.ablate_kernels      # from the root of a checkout, one GPU

Each ablation is the committed source of one kernel (`csrc/histogram_nmi.cu`
or `csrc/raster.cu`) with one named edit. All are built at once with the
package's nvcc flags into `build/ablations/`, launched through the kernel's C
entry point on the main path's inputs (`entry()`: 960x540, 27 renders x 27
warps), and timed with CUDA events (mean of 20 launches after 3), each
beside the committed kernel. An ablation that skips work no longer computes
the kernel's function: it shows where the kernel's time goes, and its output
is not checked. Every other one is held against the plain version.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from orbslam2_nmi_torch import entry as entry_mod
from orbslam2_nmi_torch import kernels
from orbslam2_nmi_torch.ops import histogram_nmi as hn
from orbslam2_nmi_torch.ops import raster

OUT = kernels.BUILD_DIR.parent / "ablations"
SKIP = "(int)(qscale < 0.0f)"  # 0 at run time, unknown to the compiler

_SWEEP_8X4 = """      for (int by = ly; by - ly < q.h; by += 4) {
        for (int bx = lx; bx - lx < q.w; bx += 8) {
          if (by >= q.h || bx >= q.w) continue;"""
_SWEEP_ROWS = """      for (int j0 = 0; j0 < q.w * q.h; j0 += 32) {
        {
          const int by = (j0 + lane) / q.w, bx = j0 + lane - by * q.w;
          if (j0 + lane >= q.w * q.h) continue;"""
_WRITES = "#pragma unroll\n  for (int k = 0; k < kPix / 4 / kThreads; ++k) {"
_NO_SWEEP = ("for (int t = warp; t < n; t += kWarps) {",
             f"for (int t = warp; t < n * {SKIP}; t += kWarps) {{")
_NO_WRITES = (_WRITES, f"if ({SKIP})\n" + _WRITES)
_LOADS_2 = """      const bool two = i + kJointThreads < n16;
      const uint4 x = va[i], y = vb[i];
      const uint4 x1 = two ? va[i + kJointThreads] : x, y1 = two ? vb[i + kJointThreads] : y;
      count_16<kMaskZero>(sm, x, y);
      if (two) count_16<kMaskZero>(sm, x1, y1);"""
_ADD = """  const unsigned old = atomicAdd(&sm.words[w], 1u << sh);
  if (((old >> sh) & 0xffffu) == kSpill - 1u) spill(sm, w, sh);"""
_ADD_AGGREGATED = """  const unsigned peers = __match_any_sync(__activemask(), (w << 5) | sh);
  if ((int)(threadIdx.x & 31) != __ffs(peers) - 1) return;
  const unsigned inc = __popc(peers);
  const unsigned old = (atomicAdd(&sm.words[w], inc << sh) >> sh) & 0xffffu;
  if (old < kSpill && old + inc >= kSpill) spill(sm, w, sh);"""

# (kernel, name, edits, computes the kernel's function)
ABLATIONS = [
    ("raster", "as committed", [], True),
    ("raster", "no coverage sweep", [_NO_SWEEP], False),
    ("raster", "no output writes", [_NO_WRITES], False),
    ("raster", "triangle setup only", [_NO_SWEEP, _NO_WRITES], False),
    ("raster", "256 threads a block (half set up triangles)",
     [("constexpr int kThreads = 128;", "constexpr int kThreads = 256;")], True),
    ("raster", "row-major runs of 32 pixels, not 8x4 blocks", [(_SWEEP_8X4, _SWEEP_ROWS)], True),
    ("raster", "blocks of 4x8 pixels",
     [("ly = lane >> 3", "ly = lane >> 2"), ("lx = lane & 7", "lx = lane & 3"),
      ("by += 4)", "by += 8)"), ("bx += 8)", "bx += 4)")], True),
    ("raster", "blocks of 16x2 pixels",
     [("ly = lane >> 3", "ly = lane >> 4"), ("lx = lane & 7", "lx = lane & 15"),
      ("by += 4)", "by += 2)"), ("bx += 8)", "bx += 16)")], True),
    ("histogram_nmi", "as committed", [], True),
    ("histogram_nmi", "one 16-byte load of each image in flight, not two",
     [(_LOADS_2, "      count_16<kMaskZero>(sm, va[i], vb[i]);"),
      ("i < n16; i += 2 * kJointThreads)", "i < n16; i += kJointThreads)")], True),
    ("histogram_nmi", "512 threads a block",
     [("constexpr int kJointThreads = 1024;", "constexpr int kJointThreads = 512;")], True),
    ("histogram_nmi", "warp aggregation of equal bins (__match_any_sync)",
     [(_ADD, _ADD_AGGREGATED)], True),
]


def _source(kernel: str, edits) -> str:
    src = (kernels._CSRC / f"{kernel}.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"ablation edit does not apply once to {kernel}.cu: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def _build_all() -> list[ctypes.CDLL]:
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc, procs = kernels._nvcc(), []
    for i, (kernel, _, edits, _) in enumerate(ABLATIONS):
        cu = OUT / f"{i:02d}_{kernel}.cu"
        cu.write_text(_source(kernel, edits))
        procs.append(subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, "-shared", "-o", str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = []
    for i, p in enumerate(procs):
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for ablation {ABLATIONS[i][1]!r}:\n{out}")
        lib = ctypes.CDLL(str(OUT / f"{i:02d}_{ABLATIONS[i][0]}.so"))
        for name in ("rasterize_keys", "joint_entropy"):
            if hasattr(lib, f"nmi_{name}"):
                getattr(lib, f"nmi_{name}").argtypes = kernels._SIGNATURES[name]
        libs.append(lib)
    return libs


def _ms(call, reps=20, warmup=3) -> float:
    for _ in range(warmup):
        if call() != 0:
            raise RuntimeError("kernel launch failed")
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_kernels: needs an NVIDIA GPU with CUDA", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    libs = _build_all()
    fn, (frame, Tcw) = entry_mod.entry(device="cuda")
    b, K = fn.binned, fn.K
    stream = torch.cuda.current_stream().cuda_stream
    poses = raster.grid_poses(Tcw, fn.offsets)
    S = poses.shape[0]
    rargs = (b.tri_data, poses, b.capacity, float(K[0, 0]), float(K[1, 1]), float(K[0, 2]),
             float(K[1, 2]), entry_mod.NEAR, b.tiles_x)
    keys_ref = raster.rasterize_keys_plain(*rargs)
    keys, u, v = (torch.empty_like(x) for x in keys_ref)
    sb, wb = hn.pack_bins(fn.render(Tcw)), hn.pack_bins(fn.warp(frame))
    P = sb.shape[1]
    hab_ref = hn.joint_entropy_grid_plain(sb, wb, P)
    hab = torch.empty_like(hab_ref)
    calls = {
        "raster": lambda lib: lib.nmi_rasterize_keys(
            b.tri_data.data_ptr(), poses.data_ptr(), S, b.tri_data.shape[0], b.capacity,
            b.tiles_x, *rargs[3:8], float((raster.DEPTH_LEVELS - 1) * entry_mod.NEAR),
            keys.data_ptr(), u.data_ptr(), v.data_ptr(), stream),
        "histogram_nmi": lambda lib: lib.nmi_joint_entropy(
            sb.data_ptr(), wb.data_ptr(), S, wb.shape[0], P, hn._inv_n(P), 0, hab.data_ptr(),
            stream),
    }
    committed = {k: libs[[a[0] for a in ABLATIONS].index(k)] for k in calls}
    for (kernel, name, _, checked), lib in zip(ABLATIONS, libs):
        call = calls[kernel]
        base_ms = _ms(lambda: call(committed[kernel]))
        ms = _ms(lambda: call(lib))
        note = ""
        if checked:
            torch.cuda.synchronize()
            if kernel == "raster":
                same = all(bool((x == y).all()) for x, y in zip((keys, u, v), keys_ref))
                note = "equals the plain version" if same else "DIFFERS from the plain version"
            else:
                note = f"max |diff| to plain {(hab - hab_ref).abs().max().item():.3g}"
        print(f"{kernel}: {name}: {ms:.4f} ms (committed {base_ms:.4f} ms beside it) {note}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
