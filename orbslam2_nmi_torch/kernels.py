"""Build, load and launch the port's hand-written CUDA kernels.

The sources in `csrc/` have a plain C interface (no PyTorch headers), so each
compiles in seconds with `nvcc` for `sm_90a`; all of them are compiled at once,
one `nvcc` process per source, and linked into one shared library that is
loaded with `ctypes`. The library is built on first use into `build/kernels/`
at the root of the checkout (listed in `.gitignore`), under a name that hashes
the sources and flags, so an edited source is rebuilt and an unchanged one is
loaded as it is.

Every C entry point launches one kernel on the stream it is given and returns
`cudaGetLastError()`; `launch` raises on a non-zero code and counts the launch
in `LAUNCHES`, which is how a run shows that its main path went through the
kernels. Nothing here is imported or built until a CUDA tensor reaches a
wrapper, so the CPU tests import every module without `nvcc`. The first
load's seconds, the build included, are the set-up counter
`kernels.load` (`utils/profiling.SETUP`).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from orbslam2_nmi_torch.utils import profiling

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = ("histogram_nmi.cu", "raster.cu", "splat.cu")
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
# -fmad=false: no multiply-add contraction, so every kernel rounds each
# product and sum as its plain PyTorch version does and the two agree bit for
# bit on the card (the texture sampling must also copy the reference's
# rounding).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC",
)

_p, _i, _ll, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry point -> argument types (pointers and the stream as c_void_p)
_SIGNATURES = {
    "joint_entropy": (_p, _p, _i, _i, _ll, _f, _i, _p, _p),
    "marginal_entropy": (_p, _i, _p, _i, _ll, _f, _p, _p),
    "rasterize_keys": (_p, _p, _i, _i, _i, _i, _f, _f, _f, _f, _f, _f, _p, _p, _p, _p),
    "render_gray": (_p, _p, _i, _i, _i, _i, _f, _f, _f, _f, _f, _f, _p, _i, _i, _i, _f, _i, _i,
                    _p, _p),
    "bin_count": (_p, _p, _i, _p, _i, _i, _i, _i, _p, _p, _p, _p),
    "bin_fill": (_p, _p, _p, _i, _p, _i, _i, _i, _i, _i, _p, _p, _p),
    "splat_scatter": (_p, _p, _p, _p, _i, _i, _i, _i, _f, _f, _f, _f, _f, _f, _f, _p, _p),
    "splat_resolve": (_p, _i, _i, _i, _i, _f, _p, _p),
}

# launches per kernel since the last reset_launches()
LAUNCHES = {name: 0 for name in _SIGNATURES}

_lib = None
_lock = threading.Lock()


def reset_launches() -> None:
    with _lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build(verbose: bool = False) -> Path:
    """Compile every source (in parallel) and link the shared library.

    Returns its path; an existing library with the same hash is reused. With
    `verbose`, `ptxas -v` reports each kernel's registers and shared memory.
    Safe across processes (the ranks of one world build at once): the build
    holds an exclusive `flock` on `build/kernels/build.lock`, and a process
    that waited for it finds the library built and reuses it.
    """
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _SOURCES:
        h.update((_CSRC / src).read_bytes())
    so = BUILD_DIR / f"libnmi_kernels_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if not so.exists():
            _compile(_nvcc(), so, verbose)
    return so


def _compile(nvcc: str, so: Path, verbose: bool) -> None:
    """nvcc each source to an object beside `so`, all at once, and link them
    into `so` (through a temporary name, so `so` appears whole)."""
    flags = list(NVCC_FLAGS) + (["-Xptxas=-v"] if verbose else [])
    objs, procs = [], []
    for src in _SOURCES:
        obj = so.with_name(f"{so.stem}_{Path(src).stem}.o")
        objs.append(str(obj))
        procs.append(subprocess.Popen(
            [nvcc, *flags, "-c", str(_CSRC / src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failed = []
    for src, p in zip(_SOURCES, procs):
        out, _ = p.communicate()
        if verbose and out:
            print(out, end="")
        if p.returncode != 0:
            failed.append(f"{src}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    tmp = so.with_suffix(f".tmp{os.getpid()}")
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp), *objs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    os.replace(tmp, so)


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            t0 = time.perf_counter()
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, f"nmi_{name}")
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.nmi_error_string.argtypes = (ctypes.c_int,)
            handle.nmi_error_string.restype = ctypes.c_char_p
            _lib = handle
            profiling.record_setup("kernels.load", time.perf_counter() - t0)
    return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Launch kernel `name` on PyTorch's current stream on `device`; raise on
    a CUDA error."""
    handle = lib()
    with torch.cuda.device(device):
        err = getattr(handle, f"nmi_{name}")(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        msg = handle.nmi_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {err} ({msg})")
    count_launch(name)


def count_launch(name: str) -> None:
    """Add one to kernel `name`'s launch count. Launches come from more than
    one thread (slam/nmi/async_worker.py), so the count is taken under the
    lock."""
    with _lock:
        LAUNCHES[name] += 1


def resolve_device(device, who: str) -> torch.device:
    """`device` as a torch.device; raise when it is CUDA and no CUDA device
    is available, so that nothing carries on on the CPU by accident."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who} runs on CUDA and no CUDA device is available; "
                           "pass device='cpu' to run the plain versions on the CPU")
    return device


def require_cuda(*tensors: torch.Tensor, dtypes) -> torch.device:
    """Validate the tensors a kernel reads: one CUDA device, contiguous, and
    each of the dtype given at its position in `dtypes`."""
    dev = tensors[0].device
    for t, dt in zip(tensors, dtypes, strict=True):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"kernel inputs must share one CUDA device, got {t.device}")
        if t.dtype != dt:
            raise TypeError(f"kernel input has dtype {t.dtype}, expected {dt}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    return dev
