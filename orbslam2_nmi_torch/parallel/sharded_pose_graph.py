"""Edge-sharded essential-graph Sim(3) optimization over a mesh of ranks.

Port of `orbslam2_nmi_tpu/parallel/sharded_pose_graph.py`. The post-loop pose
graph (`solvers/pose_graph.py`; reference Optimizer::OptimizeEssentialGraph,
src/Optimizer.cc:798) has one natural parallel axis, the edges (spanning
tree, loop and strong covisibility). The normal equations add up over edges,
so each rank computes its edge shard's 7x7 GN blocks and only those O(E)
blocks cross the interconnect: one `all_gather` of [E_loc, 161] floats a
rank, in rank order, which reassembles the padded edge order. An essential
graph touches ~2E+V of the V^2 block pairs, so exchanging a reduced dense
[7V, 7V] H would move 50-70x more bytes than that. The dense scatter and the
Cholesky solve (V is a few hundred keyframes) run on the axis's first rank
only, and `broadcast` sends the new poses out (the JAX module's psum of a
zero-masked value does the same).

The scatter is `pose_graph.scatter_blocks`'s fixed-order segment sum over the
gathered blocks; the padding edges (invalid, at vertex 0) add exact zeros at
the end of block (0, 0)'s segment. So a sharded solve sums what the
single-device one sums, in the same order, and gives its result to the bit
on one device. (On the CPU, a solve's LAPACK factorization rounds by its
thread count, and an essential graph of a few hundred keyframes amplifies
that last bit: compare ranks and a single process at equal thread counts.)
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from orbslam2_nmi_torch.parallel.mesh import Mesh, all_gather_cat
from orbslam2_nmi_torch.solvers import pose_graph as pg
from orbslam2_nmi_torch.utils.readback import to_host


def _pad_edges(prob: pg.PoseGraphProblem, multiple: int) -> pg.PoseGraphProblem:
    E = prob.edge_i.shape[0]
    pad = (-E) % multiple
    if pad == 0:
        return prob
    dev = prob.edge_i.device
    eye = torch.eye(4, dtype=prob.edge_Sji.dtype, device=dev).expand(pad, 4, 4)
    return prob._replace(
        edge_i=torch.cat([prob.edge_i, torch.zeros(pad, dtype=prob.edge_i.dtype, device=dev)]),
        edge_j=torch.cat([prob.edge_j, torch.zeros(pad, dtype=prob.edge_j.dtype, device=dev)]),
        edge_Sji=torch.cat([prob.edge_Sji, eye]),
        edge_valid=torch.cat([prob.edge_valid, torch.zeros(pad, dtype=torch.bool, device=dev)]),
    )


def sharded_optimize_pose_graph(mesh: Mesh, prob: pg.PoseGraphProblem, iters: int = 20,
                                lam: float = 1e-16) -> torch.Tensor:
    """`pose_graph.optimize_pose_graph` with the edges sharded over the
    mesh's first axis. Every rank passes the same problem (on the mesh's
    device) and returns the same optimized Scw [V, 4, 4]."""
    axis = mesh.axis_names[0]
    D, rank = mesh.size(axis), mesh.get_local_rank(axis)
    prob = _pad_edges(pg.PoseGraphProblem(*(t.to(mesh.device) for t in prob)), D)
    V = prob.Scw.shape[0]
    E_loc = prob.edge_i.shape[0] // D
    mine = slice(rank * E_loc, (rank + 1) * E_loc)
    ei, ej, Sji, ev = (t[mine] for t in (prob.edge_i, prob.edge_j, prob.edge_Sji,
                                         prob.edge_valid))
    free = prob.valid & (~prob.fixed)
    on_root = rank == 0
    layout = (pg.block_layout(V, to_host(prob.edge_i), to_host(prob.edge_j), mesh.device)
              if on_root else None)
    Scw = prob.Scw.clone().contiguous()
    for _ in range(iters):
        HII, HJJ, HIJ, bI, bJ = pg.edge_blocks(Scw, ei, ej, Sji, ev)
        flat = torch.cat([HII.reshape(E_loc, 49), HJJ.reshape(E_loc, 49),
                          HIJ.reshape(E_loc, 49), bI, bJ], dim=-1)  # [E_loc, 161]
        flat_all = all_gather_cat(flat, mesh, axis)  # [E, 161], the padded edge order
        if on_root:
            H, b = pg.scatter_blocks(
                V, prob.edge_i, prob.edge_j,
                flat_all[:, :49].reshape(-1, 7, 7), flat_all[:, 49:98].reshape(-1, 7, 7),
                flat_all[:, 98:147].reshape(-1, 7, 7), flat_all[:, 147:154],
                flat_all[:, 154:161], layout=layout)
            Scw = pg.solve_and_update(Scw, H, b, free, lam).contiguous()
        dist.broadcast(Scw, src=mesh.root(axis), group=mesh.get_group(axis))
    return Scw
