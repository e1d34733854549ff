"""Meshes of ranks for the sharded paths.

Port of `orbslam2_nmi_tpu/parallel/mesh.py`. There a mesh is an array of the
devices one process drives, and `shard_map` cuts arrays over its axes. Torch
runs one process a device, so here a mesh is the world of `torch.distributed`
ranks, one device each, seen along one or two named axes: an axis has a size,
a process group over the ranks that share the other axes' coordinates, and
this rank's index along it. The sharded functions (`sharded_nmi`,
`sharded_ba`, `sharded_pose_graph`) cut their work by that index and meet in
the axis's collectives.

A small dataclass over process groups, not `torch.distributed.DeviceMesh`:
that binds the device to the backend (one rank a card), and the tests and
`chip_smoke.py` also run several gloo ranks on one card or on the CPU.

A group must be able to carry the mesh's tensors: NCCL carries CUDA tensors
only, gloo carries CPU and CUDA tensors. `make_mesh` raises on a group that
cannot, so nothing is staged through the host behind the caller's back.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

POSE_AXIS = "pose"  # NMI translation candidates (and rotation warps); BA points; pose-graph edges
OBS_AXIS = "obs"  # BA observations (the second axis of a 2-D mesh)


@dataclass
class Mesh:
    """This rank's view of a mesh: the axes' names and sizes, a process
    group along each axis, this rank's index along each, and its device."""

    axis_names: tuple
    shape: dict  # axis name -> size
    groups: dict  # axis name -> ProcessGroup along that axis
    coords: dict  # axis name -> this rank's index along that axis
    device: torch.device

    def size(self, axis: str | None = None) -> int:
        """Ranks along `axis`, or in the whole mesh."""
        if axis is None:
            n = 1
            for a in self.axis_names:
                n *= self.shape[a]
            return n
        return self.shape[axis]

    def get_group(self, axis: str):
        return self.groups[axis]

    def get_local_rank(self, axis: str) -> int:
        return self.coords[axis]

    def root(self, axis: str) -> int:
        """The global rank of index 0 along `axis` (a collective's source)."""
        return dist.get_global_rank(self.groups[axis], 0)


def _world(n_devices: int | None) -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.distributed.init_runtime first "
                           "(one process a rank)")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh spans the whole world: asked for {n_devices} ranks in a "
                         f"world of {world}")
    return world


def _device(device) -> torch.device:
    from orbslam2_nmi_torch.parallel import distributed

    return distributed.local_device() if device is None else torch.device(device)


def _check_backend(group, device: torch.device) -> None:
    backend = dist.get_backend(group)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"a NCCL group carries CUDA tensors only, not {device.type} tensors")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unsupported backend {backend!r} (nccl or gloo)")


def make_mesh(n_devices: int | None = None, axis: str = POSE_AXIS, device=None) -> Mesh:
    """A 1-D mesh over every rank of the world, along `axis`. `device` is
    where this rank's tensors live (default: the device `init_runtime` gave
    this rank)."""
    n = _world(n_devices)
    device = _device(device)
    group = dist.group.WORLD
    _check_backend(group, device)
    return Mesh((axis,), {axis: n}, {axis: group}, {axis: dist.get_rank()}, device)


def make_mesh_2d(n_pose: int, n_obs: int, device=None) -> Mesh:
    """A (pose, obs) mesh over the world's n_pose * n_obs ranks, rank
    p * n_obs + o at (p, o). Every rank must call it (it creates groups)."""
    _world(n_pose * n_obs)
    device = _device(device)
    rank = dist.get_rank()
    p, o = divmod(rank, n_obs)
    groups = {}
    # new_group is collective: every rank creates every group, in one order
    for q in range(n_obs):
        g = dist.new_group([i * n_obs + q for i in range(n_pose)])
        if q == o:
            groups[POSE_AXIS] = g
    for q in range(n_pose):
        g = dist.new_group([q * n_obs + j for j in range(n_obs)])
        if q == p:
            groups[OBS_AXIS] = g
    for g in groups.values():
        _check_backend(g, device)
    return Mesh((POSE_AXIS, OBS_AXIS), {POSE_AXIS: n_pose, OBS_AXIS: n_obs}, groups,
                {POSE_AXIS: p, OBS_AXIS: o}, device)


def all_gather_cat(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The ranks' `x` along `axis`, concatenated on dim 0 in rank order (the
    tiled all_gather of the JAX package's shard_map)."""
    if x.device != mesh.device:
        raise ValueError(f"tensor on {x.device}, the mesh's device is {mesh.device}")
    if x.dtype == torch.bool:  # not every backend reduces or gathers bool
        return all_gather_cat(x.to(torch.uint8), mesh, axis).bool()
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size(axis))]
    dist.all_gather(parts, x, group=mesh.get_group(axis))
    return torch.cat(parts)
