"""Ablations of kernels B1 (joint entropy), B2 (marginal entropy) and B3
(rasterizer), timed on the main path.

    python3 -m orbslam2_nmi_torch.tools.ablate_kernels      # from the root of a checkout, one GPU

Each ablation is the committed source of one kernel (`csrc/histogram_nmi.cu`,
which holds B1 and B2, or `csrc/raster.cu`) with one named edit; it is named
by its kernel's C entry point. All are built at once with the package's nvcc
flags into `build/ablations/`, launched through the entry point on the main
path's inputs (`entry()`: 960x540, 27 renders x 27 warps; B2 takes the
renders and the warps in one launch; it is timed on 54 flat images, one gray
each, too), and timed with CUDA events (mean of 50 launches after 3), each
beside the committed kernel, twice: launched back to back, where the host's
time to make each call can set the pace, and queued behind a sleep kernel,
so that every launch is enqueued before the first runs and the time is the
device's alone. An ablation that skips work no longer computes the kernel's
function: it shows where the kernel's time goes, and its output is not
checked. Every other one is held against the plain version.
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
SKIP_MARGINAL = "(long long)(inv_n < 0.0f)"  # the same in the marginal kernel
QUEUE_CYCLES = 20_000_000  # ~10 ms of sleep kernel, longer than enqueueing the timed launches
SOURCES = {"rasterize_keys": "raster", "joint_entropy": "histogram_nmi",
           "marginal_entropy": "histogram_nmi"}  # C entry point -> csrc/<source>.cu

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
_MARGINAL_LOOP = ("for (long long i = lo + threadIdx.x; i < hi; i += kMarginalThreads) "
                  "count_bytes_16(hist, v[i]);")
_MARGINAL_LOADS_2 = """for (long long i = lo + threadIdx.x; i < hi; i += 2 * kMarginalThreads) {
    const bool two = i + kMarginalThreads < hi;
    const uint4 x = v[i];
    const uint4 x1 = two ? v[i + kMarginalThreads] : x;
    count_bytes_16(hist, x);
    if (two) count_bytes_16(hist, x1);
  }"""
_HIST = "  __shared__ unsigned hist[kBins];   // this CTA's counts\n"
_ZERO = "hist[i] = total[i] = 0u;\n"
_FOLD = "  unsigned* gathered = cluster.map_shared_rank(total, 0);\n"
_WARP_COPIES = [  # one histogram a warp, folded into hist before the gather
    (_HIST, _HIST + "  __shared__ unsigned copies[kMarginalThreads / 32 * kBins];\n"),
    (_ZERO, _ZERO + "  for (int i = threadIdx.x; i < kMarginalThreads / 32 * kBins; "
                    "i += kMarginalThreads) copies[i] = 0u;\n"),
    (_MARGINAL_LOOP, _MARGINAL_LOOP.replace("count_bytes_16(hist,",
                                            "count_bytes_16(copies + (threadIdx.x >> 5) * kBins,")),
    (_FOLD, "  for (int i = threadIdx.x; i < kBins; i += kMarginalThreads)\n"
            "    for (int k = 0; k < kMarginalThreads / 32; ++k) hist[i] += copies[k * kBins + i];\n"
            "  __syncthreads();\n" + _FOLD),
]
_COUNT_16 = """__device__ __forceinline__ void count_bytes_16(unsigned* hist, const uint4& x) {
"""
_COUNT_16_SHORTCUT = _COUNT_16 + """  const unsigned rep = (x.x & 255u) * 0x01010101u;
  if ((x.x == rep) & (x.y == rep) & (x.z == rep) & (x.w == rep)) {
    atomicAdd(&hist[x.x & 255u], 16u);
    return;
  }
"""
_CLUSTER = "constexpr int kMarginalCluster = 4;"
_ADD_AGGREGATED = """  const unsigned peers = __match_any_sync(__activemask(), (w << 5) | sh);
  if ((int)(threadIdx.x & 31) != __ffs(peers) - 1) return;
  const unsigned inc = __popc(peers);
  const unsigned old = (atomicAdd(&sm.words[w], inc << sh) >> sh) & 0xffffu;
  if (old < kSpill && old + inc >= kSpill) spill(sm, w, sh);"""

# (C entry point, name, edits, computes the kernel's function)
ABLATIONS = [
    ("rasterize_keys", "as committed", [], True),
    ("rasterize_keys", "no coverage sweep", [_NO_SWEEP], False),
    ("rasterize_keys", "no output writes", [_NO_WRITES], False),
    ("rasterize_keys", "triangle setup only", [_NO_SWEEP, _NO_WRITES], False),
    ("rasterize_keys", "256 threads a block (half set up triangles)",
     [("constexpr int kThreads = 128;", "constexpr int kThreads = 256;")], True),
    ("rasterize_keys", "row-major runs of 32 pixels, not 8x4 blocks",
     [(_SWEEP_8X4, _SWEEP_ROWS)], True),
    ("rasterize_keys", "blocks of 4x8 pixels",
     [("ly = lane >> 3", "ly = lane >> 2"), ("lx = lane & 7", "lx = lane & 3"),
      ("by += 4)", "by += 8)"), ("bx += 8)", "bx += 4)")], True),
    ("rasterize_keys", "blocks of 16x2 pixels",
     [("ly = lane >> 3", "ly = lane >> 4"), ("lx = lane & 7", "lx = lane & 15"),
      ("by += 4)", "by += 2)"), ("bx += 8)", "bx += 16)")], True),
    ("joint_entropy", "as committed", [], True),
    ("joint_entropy", "one 16-byte load of each image in flight, not two",
     [(_LOADS_2, "      count_16<kMaskZero>(sm, va[i], vb[i]);"),
      ("i < n16; i += 2 * kJointThreads)", "i < n16; i += kJointThreads)")], True),
    ("joint_entropy", "512 threads a block",
     [("constexpr int kJointThreads = 1024;", "constexpr int kJointThreads = 512;")], True),
    ("joint_entropy", "warp aggregation of equal bins (__match_any_sync)",
     [(_ADD, _ADD_AGGREGATED)], True),
    ("marginal_entropy", "as committed", [], True),
    ("marginal_entropy", "clusters of 1 CTA (one block an image)",
     [(_CLUSTER, "constexpr int kMarginalCluster = 1;")], True),
    ("marginal_entropy", "clusters of 2 CTAs",
     [(_CLUSTER, "constexpr int kMarginalCluster = 2;")], True),
    ("marginal_entropy", "clusters of 8 CTAs",
     [(_CLUSTER, "constexpr int kMarginalCluster = 8;")], True),
    ("marginal_entropy", "clusters of 16 CTAs (non-portable size)",
     [(_CLUSTER, "constexpr int kMarginalCluster = 16;")], True),
    ("marginal_entropy", "one histogram a warp, not one a CTA", _WARP_COPIES, True),
    ("marginal_entropy", "256 threads a CTA",
     [("constexpr int kMarginalThreads = 512;", "constexpr int kMarginalThreads = 256;")], True),
    ("marginal_entropy", "1024 threads a CTA",
     [("constexpr int kMarginalThreads = 512;", "constexpr int kMarginalThreads = 1024;")], True),
    ("marginal_entropy", "two 16-byte loads in flight, not one",
     [(_MARGINAL_LOOP, _MARGINAL_LOADS_2)], True),
    ("marginal_entropy", "16 equal bytes (a flat run) counted by one add of 16",
     [(_COUNT_16, _COUNT_16_SHORTCUT)], True),
    ("marginal_entropy", "clusters of 8, a histogram a warp, two loads (the first build's choices)",
     [(_CLUSTER, "constexpr int kMarginalCluster = 8;"), *_WARP_COPIES[:2],
      (_MARGINAL_LOOP, _MARGINAL_LOADS_2.replace(
          "count_bytes_16(hist,", "count_bytes_16(copies + (threadIdx.x >> 5) * kBins,")),
      _WARP_COPIES[3]], True),
    ("marginal_entropy", "no counting (launch, cluster syncs, remote adds, entropy)",
     [(_MARGINAL_LOOP, _MARGINAL_LOOP.replace("i < hi;", f"i < hi * {SKIP_MARGINAL};"))],
     False),
    ("marginal_entropy", "no counting, clusters of 1 CTA",
     [(_MARGINAL_LOOP, _MARGINAL_LOOP.replace("i < hi;", f"i < hi * {SKIP_MARGINAL};")),
      (_CLUSTER, "constexpr int kMarginalCluster = 1;")], False),
]


def _source(entry: str, edits) -> str:
    path = kernels._CSRC / f"{SOURCES[entry]}.cu"
    src = path.read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"ablation edit does not apply once to {path.name}: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def _build_all() -> list[ctypes.CDLL]:
    """One library an ablation; equal sources (each kernel's committed one
    for B1 and B2) are built once."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc, procs, first = kernels._nvcc(), {}, {}
    for i, (entry, _, edits, _) in enumerate(ABLATIONS):
        src = _source(entry, edits)
        if src in first:
            continue
        first[src] = i
        cu = OUT / f"{i:02d}_{SOURCES[entry]}.cu"
        cu.write_text(src)
        procs[i] = subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, "-shared", "-o", str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for i, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for ablation {ABLATIONS[i][1]!r}:\n{out}")
        lib = ctypes.CDLL(str(OUT / f"{i:02d}_{SOURCES[ABLATIONS[i][0]]}.so"))
        for name in SOURCES:
            if hasattr(lib, f"nmi_{name}"):
                getattr(lib, f"nmi_{name}").argtypes = kernels._SIGNATURES[name]
        built[i] = lib
    return [built[first[_source(entry, edits)]] for entry, _, edits, _ in ABLATIONS]


def _ms(call, reps=50, warmup=3, queued=False) -> float:
    for _ in range(warmup):
        if call() != 0:
            raise RuntimeError("kernel launch failed")
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(QUEUE_CYCLES)
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
    R = wb.shape[0]
    hab_ref = hn.joint_entropy_grid_plain(sb, wb, P)
    hab = torch.empty_like(hab_ref)
    h_ref = hn.marginal_entropy_sets_plain(sb, wb, P)
    h = torch.empty_like(h_ref)
    # B2 also on 54 flat images (one gray each), where every add of an image
    # lands on one bin
    flat_s = torch.zeros_like(sb)
    flat_w = (torch.arange(R, device=sb.device) * 9).to(torch.uint8)[:, None].expand(R, P)
    flat_w = flat_w.contiguous()
    hf_ref = hn.marginal_entropy_sets_plain(flat_s, flat_w, P)

    def marginal(x, y):
        return lambda lib: lib.nmi_marginal_entropy(
            x.data_ptr(), S, y.data_ptr(), R, P, hn._inv_n(P), h.data_ptr(), stream)

    # C entry point -> [(inputs, launch, output, plain version's output)]
    calls = {
        "rasterize_keys": [("main path", lambda lib: lib.nmi_rasterize_keys(
            b.tri_data.data_ptr(), poses.data_ptr(), S, b.tri_data.shape[0], b.capacity,
            b.tiles_x, *rargs[3:8], float((raster.DEPTH_LEVELS - 1) * entry_mod.NEAR),
            keys.data_ptr(), u.data_ptr(), v.data_ptr(), stream), (keys, u, v), keys_ref)],
        "joint_entropy": [("main path", lambda lib: lib.nmi_joint_entropy(
            sb.data_ptr(), wb.data_ptr(), S, R, P, hn._inv_n(P), 0, hab.data_ptr(), stream),
            hab, hab_ref)],
        "marginal_entropy": [("main path", marginal(sb, wb), h, h_ref),
                             ("54 flat images", marginal(flat_s, flat_w), h, hf_ref)],
    }
    committed = {k: libs[[a[0] for a in ABLATIONS].index(k)] for k in calls}
    for (kernel, name, _, checked), lib in zip(ABLATIONS, libs):
        for inputs, call, out, ref in calls[kernel]:
            base_ms = _ms(lambda: call(committed[kernel]))
            ms = _ms(lambda: call(lib))
            base_q = _ms(lambda: call(committed[kernel]), queued=True)
            ms_q = _ms(lambda: call(lib), queued=True)
            note = ""
            if checked:
                call(lib)
                torch.cuda.synchronize()
                if isinstance(out, tuple):
                    same = all(bool((x == y).all()) for x, y in zip(out, ref))
                    note = "equals the plain version" if same else "DIFFERS from the plain version"
                else:
                    note = f"max |diff| to plain {(out - ref).abs().max().item():.3g}"
            print(f"{kernel}: {name}, {inputs}: {ms:.4f} ms (committed {base_ms:.4f} ms beside "
                  f"it); queued {ms_q:.4f} ms (committed {base_q:.4f}) {note}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
