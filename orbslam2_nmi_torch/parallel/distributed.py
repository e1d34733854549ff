"""The multi-process runtime: `torch.distributed` initialization, the global
mesh, and a launcher that runs a function on every rank of a fresh world.

Port of `orbslam2_nmi_tpu/parallel/distributed.py`. Every process calls
`init_runtime()` before its first collective. The coordinator address, the
process count and this process's id come from the arguments or from torch's
own environment as `torchrun` sets it (MASTER_ADDR and MASTER_PORT,
WORLD_SIZE, RANK, LOCAL_RANK, LOCAL_WORLD_SIZE), in place of the JAX
package's `JAX_*` variables. With none of them the process becomes a world of
one rank, as the JAX package's single-process path does.

The JAX function's `local_device_count` has no counterpart: torch runs one
process a device, so a rank's device count is always one. Each rank holds an
explicit device, `cuda:<local rank % visible cards>` unless the caller asks
for the CPU. The backend is NCCL for CUDA tensors and gloo for CPU tensors; a
caller may name gloo for CUDA tensors too (several ranks sharing one card,
which NCCL refuses). A NCCL world with more ranks on this host than it has
visible cards raises.

`spawn_world(fn, n)` starts n rank processes with the `spawn` start method
(the parent may already hold a CUDA context, which `fork` would break), runs
`fn(*args)` on each inside a fresh world, and returns every rank's result.
A rank that fails ends the world: the others are stopped and the call raises
with that rank's traceback.
"""

from __future__ import annotations

import datetime
import logging
import os
import queue as queue_mod
import socket
import time
import traceback

import torch
import torch.distributed as dist

from orbslam2_nmi_torch import kernels

_log = logging.getLogger(__name__)
# This process's device, chosen by init_runtime (one rank a process, as the
# process group itself is one a process).
_DEVICE: list = []
TIMEOUT_S = 600.0  # a collective, or a world, waiting longer than this fails


def _env_int(name: str):
    v = os.environ.get(name)
    return None if v is None else int(v)


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_runtime(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    device=None,
) -> torch.device:
    """Join this process to a `torch.distributed` world and return its device.

    `coordinator_address` is "host:port" or "tcp://host:port" (rank 0
    listens there). `device` defaults to CUDA; "cuda" without an index means
    `cuda:<local rank % visible cards>`. `backend` defaults to NCCL for a CUDA
    device and gloo for the CPU.
    """
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")

    if coordinator_address is None and num_processes is None and process_id is None:
        _log.info("no distributed configuration: continuing as a world of one rank")
        coordinator_address, num_processes, process_id = f"127.0.0.1:{free_port()}", 1, 0
    # all three together: a partial configuration would otherwise fail deep
    # inside torch with an obscure error, or run as a mis-configured world
    missing = [name for name, v in (
        ("coordinator_address/MASTER_ADDR", coordinator_address),
        ("num_processes/WORLD_SIZE", num_processes),
        ("process_id/RANK", process_id),
    ) if v is None]
    if missing:
        raise ValueError(f"incomplete torch.distributed configuration: missing {missing} "
                         "(coordinator address, process count and process id must be "
                         "provided together)")
    if not coordinator_address.startswith("tcp://"):
        coordinator_address = "tcp://" + coordinator_address

    local_rank = _env_int("LOCAL_RANK")
    local_rank = process_id if local_rank is None else local_rank
    local_world = _env_int("LOCAL_WORLD_SIZE") or num_processes
    device = kernels.resolve_device("cuda" if device is None else device, "init_runtime")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"NCCL carries CUDA tensors only; this rank's device is {device}")
        if local_world > torch.cuda.device_count():
            raise RuntimeError(
                f"a NCCL world takes one card a rank: {local_world} ranks on this host, "
                f"{torch.cuda.device_count()} visible cards (use gloo to share a card)")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = dict(device_id=device) if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=coordinator_address, world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=TIMEOUT_S), **kw)
    _DEVICE[:] = [device]
    return device


def local_device() -> torch.device:
    """The device `init_runtime` gave this rank."""
    if not _DEVICE:
        raise RuntimeError("no device: call init_runtime first")
    return _DEVICE[0]


def shutdown() -> None:
    """Leave the world (and forget this rank's device)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _DEVICE.clear()


def global_mesh(axis: str = "pose"):
    """1-D mesh over every rank of the world."""
    from orbslam2_nmi_torch.parallel import mesh

    return mesh.make_mesh(axis=axis)


def replicate(x) -> torch.Tensor:
    """`x` on this rank's device with rank 0's value on every rank (a
    broadcast). Every rank must pass a value of the same shape and dtype."""
    t = torch.as_tensor(x).to(local_device()).contiguous()
    dist.broadcast(t, src=0)
    return t


def _to_host(obj):
    """Tensors (nested in lists, tuples and dicts) as numpy arrays."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    return obj


def _rank_main(fn, args, rank, n_ranks, port, backend, device, threads, results):
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(n_ranks)
    torch.set_num_threads(threads)
    try:
        init_runtime(f"127.0.0.1:{port}", n_ranks, rank, backend=backend, device=device)
        out = fn(*args)
        if local_device().type == "cuda":
            torch.cuda.synchronize(local_device())
        results.put((rank, True, _to_host(out)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        shutdown()


def spawn_world(fn, n_ranks: int, *args, backend: str | None = None, device="cuda") -> list:
    """Run `fn(*args)` on every rank of a fresh world of `n_ranks` processes
    and return the ranks' results in rank order (tensors as numpy arrays).

    `fn` must be importable (a module-level function): the ranks start from a
    fresh interpreter. Each rank calls `init_runtime` with `backend` and
    `device` first, so `fn` finds its device in `local_device()`. Each rank
    takes its share of the parent's torch threads. Raises if any rank fails,
    exits non-zero or does not report within `TIMEOUT_S`; every rank process
    is stopped before this returns.
    """
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    threads = max(1, torch.get_num_threads() // n_ranks)
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, args, r, n_ranks, port, backend, device, threads, results))
             for r in range(n_ranks)]
    out = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + TIMEOUT_S
        while len(out) < n_ranks:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)
                        and r not in out]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} of {n_ranks} exited with code "
                                       f"{procs[dead[0]].exitcode} before reporting")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the world of {n_ranks} ranks did not finish within "
                                       f"{TIMEOUT_S} s ({len(out)} reported)")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {n_ranks} failed:\n{payload}")
            out[rank] = payload
        # the queue is drained: now each rank can exit
        for r, p in enumerate(procs):
            p.join(timeout=max(1.0, deadline - time.monotonic()))
            if p.exitcode != 0:
                raise RuntimeError(f"rank {r} of {n_ranks} exited with code {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5.0)
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(n_ranks)]
