"""Distributed Schur bundle adjustment: the landmarks sharded over the mesh.

Port of `orbslam2_nmi_tpu/parallel/sharded_ba.py`. The g2o replacement
(`solvers/local_ba.py`) marginalizes the landmarks by a Schur complement; the
reduced camera system

    S = Hcc - B Hpp^{-1} B^T,   g_s = g_c - B Hpp^{-1} g_p

adds up over points once every observation of a point lives on the rank that
owns the point. So the points are sharded over the mesh, and each
observation goes to its point's rank (host grouping, one stable sort a
solve, copied from the JAX module as it is):

  * Hpp, gp, Hpp^{-1} and the points' back-substitution are local;
  * the Schur product B (Hpp^{-1} B^T), the solve's largest, runs on each
    rank over its own points: [6C, 3P/D] x [3P/D, 6C];
  * the only collectives are an `all_reduce` of the [6C, 6C] and [6C]
    partial systems and of the robust totals, and a `broadcast` of the
    [C, 6] camera step: O(C^2) bytes an iteration, whatever the point count.

The axis's first rank factors the reduced system (Cholesky) and broadcasts
the step; a replicated factorization would cost D times the work for the
same wall time. The result equals `local_ba.bundle_adjust`'s up to the
reduction's summation order; the two-phase chi2-gated schedule is the same
(Optimizer.cc:679-725). As in the JAX module, the camera damping is added to
the reduced system on the root rather than to Hcc on every rank.

The port's precision rules of `solvers/local_ba.py` hold here: the Schur
products in float64, cast back (`local_ba._wide`); the small products
elementwise in float32 (`se3.mm`, `se3.mv`); segment sums in a fixed order
(`local_ba._segments`), never `index_add_`; a failed `cholesky_ex` gives a
NaN step, which the LM loop rejects. No TF32 flag reaches any of it.
"""

from __future__ import annotations

import heapq

import numpy as np
import torch
import torch.distributed as dist

from orbslam2_nmi_torch.geometry import se3
from orbslam2_nmi_torch.parallel.mesh import POSE_AXIS, Mesh, all_gather_cat
from orbslam2_nmi_torch.solvers import local_ba
from orbslam2_nmi_torch.utils.readback import to_host


def _balance_points(obs_pt: np.ndarray, P_n: int, n_dev: int):
    """Assign points to shards balancing OBSERVATION counts (greedy LPT):
    every shard's per-iteration work and padding is ~mean instead of the max
    of a contiguous range (uneven landmark covisibility skews contiguous
    ranges ~1.5x, which every other shard then pads and idles to).
    Returns (shard_of [P_n], slot_of [P_n], p_loc)."""
    counts = np.bincount(obs_pt, minlength=P_n)
    order = np.argsort(-counts, kind="stable")
    p_loc = -(-P_n // n_dev)
    shard_of = np.zeros(P_n, np.int64)
    slot_of = np.zeros(P_n, np.int64)
    fill = np.zeros(n_dev, np.int64)
    heap = [(0, d) for d in range(n_dev)]
    heapq.heapify(heap)
    for p in order:
        spill = []
        while True:
            load, d = heapq.heappop(heap)
            if fill[d] < p_loc:
                break
            spill.append((load, d))
        for item in spill:
            heapq.heappush(heap, item)
        shard_of[p] = d
        slot_of[p] = fill[d]
        fill[d] += 1
        heapq.heappush(heap, (load + int(counts[p]), d))
    return shard_of, slot_of, p_loc


def _group_obs_by_point_shard(obs_pt: np.ndarray, shard_of: np.ndarray, n_dev: int):
    """Stable-sort observation slots so each device receives exactly the
    observations of its point shard. Returns (idx [n_dev, O_loc] source slot
    or -1 pad, O_loc)."""
    shard = shard_of[obs_pt]
    order = np.argsort(shard, kind="stable")
    counts = np.bincount(shard, minlength=n_dev)
    o_loc = max(int(counts.max()), 1)
    o_loc = -(-o_loc // 8) * 8  # pad for lane friendliness
    idx = np.full((n_dev, o_loc), -1, np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)])
    for d in range(n_dev):
        idx[d, : counts[d]] = order[starts[d] : starts[d] + counts[d]]
    return idx, o_loc


def _all_reduce(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    x = x.contiguous()
    dist.all_reduce(x, group=mesh.get_group(axis))
    return x


def sharded_bundle_adjust(mesh: Mesh, prob: local_ba.BAProblem, iters1: int = 5,
                          iters2: int = 10, axis: str = POSE_AXIS) -> local_ba.BAResult:
    """`local_ba.bundle_adjust` with the landmarks (and each landmark's
    observations) sharded over `axis`. Every rank passes the same problem and
    returns the same full result."""
    n_dev, rank = mesh.size(axis), mesh.get_local_rank(axis)
    dev = mesh.device
    C = prob.cam_Tcw.shape[0]
    P_n = prob.pts_w.shape[0]
    O = prob.obs_cam.shape[0]

    # ---- host grouping (the JAX module's, as it is)
    obs_cam_h, obs_pt_h = to_host(prob.obs_cam), to_host(prob.obs_pt)
    shard_of, slot_of, p_loc = _balance_points(obs_pt_h, P_n, n_dev)
    idx, o_loc = _group_obs_by_point_shard(obs_pt_h, shard_of, n_dev)
    safe = np.maximum(idx, 0).reshape(-1)
    pad_ok = (idx >= 0).reshape(-1)
    mine = slice(rank * o_loc, (rank + 1) * o_loc)

    def local_obs(a, fill=0):
        out = np.asarray(a)[safe[mine]]
        ok = pad_ok[mine]
        return np.where(ok if out.ndim == 1 else ok[:, None], out, fill)

    obs_valid_full = to_host(prob.obs_valid) & to_host(prob.cam_valid)[obs_cam_h]
    ocam_h = local_obs(obs_cam_h).astype(np.int64)
    opt_h = np.where(pad_ok[mine], slot_of[obs_pt_h[safe[mine]]], 0).astype(np.int64)
    ovalid_h = local_obs(obs_valid_full, fill=False).astype(bool)
    ocam = torch.from_numpy(ocam_h).to(dev)
    opt = torch.from_numpy(opt_h).to(dev)
    ouv = torch.from_numpy(local_obs(to_host(prob.obs_uv))).to(dev)
    ow = torch.from_numpy(local_obs(to_host(prob.obs_inv_sigma2), fill=1.0)).to(dev)
    ovalid = torch.from_numpy(ovalid_h).to(dev)

    # permuted point layout: global slot = shard_of * p_loc + slot_of
    perm_pos = shard_of * p_loc + slot_of
    pts_h = np.zeros((p_loc * n_dev, 3), np.float32)
    pts_h[perm_pos] = to_host(prob.pts_w)
    ptsv_h = np.zeros(p_loc * n_dev, bool)
    ptsv_h[perm_pos] = to_host(prob.pts_valid)
    pts0 = torch.from_numpy(pts_h[rank * p_loc:(rank + 1) * p_loc]).to(dev)
    ptsv = torch.from_numpy(ptsv_h[rank * p_loc:(rank + 1) * p_loc]).to(dev)

    K = prob.K.to(dev)
    cam_free = ((~prob.cam_fixed) & prob.cam_valid).to(dev)
    free6 = torch.repeat_interleave(cam_free, 6)
    # this rank's observations by camera, point and (camera, point): the
    # fixed summation order of every segment sum
    segs = (local_ba._segments(ocam_h, ovalid_h, C, dev),
            local_ba._segments(opt_h, ovalid_h, p_loc, dev),
            local_ba._segments(ocam_h * p_loc + opt_h, ovalid_h, C * p_loc, dev))
    on_root = rank == 0
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    eyeC = torch.eye(C, dtype=torch.float32, device=dev)
    eye6C = torch.eye(C * 6, dtype=torch.float32, device=dev)

    def iteration(cam_Tcw, pts_w, active, lam):
        r, Jc, Jp, z = local_ba._residuals(K, cam_Tcw, pts_w, ocam, opt, ouv)
        chi2 = torch.sum(r * r, dim=-1) * ow
        rho_w = torch.where(chi2 > local_ba.CHI2_MONO,
                            local_ba.HUBER_DELTA / torch.sqrt(chi2 + 1e-12), 1.0)
        w = ow * rho_w * active * (z > 0)
        Jc = Jc * cam_free[ocam].to(Jc.dtype)[:, None, None]
        wJc = Jc * w[:, None, None]
        wJp = Jp * w[:, None, None]
        by_cam, by_pt, by_pair = segs
        # camera blocks: partial over this rank's observations; landmark
        # blocks: complete (all observations of its points are here)
        Hcc = local_ba._segment_sum(local_ba._tmm(wJc, Jc), by_cam)
        gc = local_ba._segment_sum(se3.mv(wJc.transpose(-1, -2), r), by_cam)
        Hpp = local_ba._segment_sum(local_ba._tmm(wJp, Jp), by_pt)
        gp = local_ba._segment_sum(se3.mv(wJp.transpose(-1, -2), r), by_pt)
        Hcp = local_ba._segment_sum(local_ba._tmm(wJc, Jp), by_pair).reshape(C, p_loc, 6, 3)

        Hpp = Hpp + lam * eye3 + 1e-8 * eye3
        Hpp_inv = local_ba._spd_inv3(Hpp) * ptsv[:, None, None]

        # this rank's partial reduced system, the two large products in
        # float64 (never TF32)
        B = Hcp.permute(0, 2, 1, 3).reshape(C * 6, p_loc * 3).double()
        HppinvBT = se3.mm(Hcp, Hpp_inv.transpose(-1, -2))  # [C, P_l, 6, 3]
        HppinvBT_m = HppinvBT.permute(1, 3, 0, 2).reshape(p_loc * 3, C * 6)
        S_part = -local_ba._wide(B, HppinvBT_m)
        S_part = (S_part.reshape(C, 6, C, 6) + eyeC[:, None, :, None] * Hcc[:, :, None, :])
        gp_tilde = se3.mv(Hpp_inv, gp)
        g_part = gc.reshape(-1) - local_ba._wide(B, gp_tilde.reshape(-1))

        # the only non-scalar collectives: [6C, 6C] + [6C], and the [C, 6] step
        S = _all_reduce(S_part.reshape(C * 6, C * 6), mesh, axis)
        g_s = _all_reduce(g_part, mesh, axis)
        if on_root:
            Sd = (S.reshape(C, 6, C, 6)
                  + eyeC[:, None, :, None] * (lam * eye6 + 1e-8 * eye6)[None, :, None, :])
            Sd = Sd.reshape(C * 6, C * 6)
            Sd = torch.where(free6[:, None] & free6[None, :], Sd, 0.0)
            Sd = Sd + torch.diag(torch.where(free6, 0.0, 1.0))
            g = torch.where(free6, g_s, 0.0)
            L, info = torch.linalg.cholesky_ex(Sd + 1e-8 * eye6C)
            dxc = torch.cholesky_solve(g[:, None], L)[:, 0]
            # an indefinite S: NaN, as cho_factor gives, so the step is rejected
            dxc = torch.where(info == 0, dxc, float("nan")).reshape(C, 6).contiguous()
        else:
            dxc = torch.empty((C, 6), dtype=torch.float32, device=dev)
        dist.broadcast(dxc, src=mesh.root(axis), group=mesh.get_group(axis))

        # back-substitute this rank's points
        Bt_dxc = torch.sum(Hcp * dxc[:, None, :, None], dim=(0, 2))
        dp = se3.mv(Hpp_inv, gp - Bt_dxc) * ptsv[:, None]
        new_cams = torch.where(cam_free[:, None, None],
                               se3.se3_compose(se3.se3_exp(dxc), cam_Tcw), cam_Tcw)
        return new_cams, pts_w + dp

    def chi2_of(cam, pts):
        r, _, _, z = local_ba._residuals(K, cam, pts, ocam, opt, ouv)
        return torch.sum(r * r, dim=-1) * ow, z

    def total(chi2, active, z):  # the robust total over every rank's observations
        return _all_reduce(local_ba._robust_total(chi2, active, z).reshape(1), mesh, axis)[0]

    active0 = ovalid & ptsv[opt]

    def phase(cam, pts, active, n_iters):
        chi2_0, z0 = chi2_of(cam, pts)
        best = total(chi2_0, active, z0)
        lam = torch.full((), 1e-4, dtype=torch.float32, device=dev)
        for _ in range(n_iters):
            new_cam, new_pts = iteration(cam, pts, active.to(torch.float32), lam)
            chi2_new, z = chi2_of(new_cam, new_pts)
            total_new = total(chi2_new, active, z)
            improved = total_new < best
            cam = torch.where(improved, new_cam, cam)
            pts = torch.where(improved, new_pts, pts)
            lam = torch.where(improved, lam * 0.5, lam * 5.0)
            best = torch.minimum(best, total_new)
        return cam, pts

    cam, pts = phase(prob.cam_Tcw.to(dev), pts0, active0, iters1)
    chi2, z = chi2_of(cam, pts)
    active1 = active0 & (chi2 <= local_ba.CHI2_MONO) & (z > 0)
    cam, pts = phase(cam, pts, active1, iters2)
    chi2, z = chi2_of(cam, pts)
    inlier = active0 & (chi2 <= local_ba.CHI2_MONO) & (z > 0)

    # every rank's points and observations, back in the problem's order
    pts_all = all_gather_cat(pts, mesh, axis)
    inlier_all = all_gather_cat(inlier, mesh, axis)
    chi2_all = all_gather_cat(chi2, mesh, axis)
    src = torch.from_numpy(safe[pad_ok]).to(dev)
    keep = torch.from_numpy(np.nonzero(pad_ok)[0]).to(dev)
    inlier_out = torch.zeros(O, dtype=torch.bool, device=dev)
    chi2_out = torch.zeros(O, dtype=torch.float32, device=dev)
    inlier_out[src] = inlier_all[keep]
    chi2_out[src] = chi2_all[keep]
    return local_ba.BAResult(cam_Tcw=cam, pts_w=pts_all[torch.from_numpy(perm_pos).to(dev)],
                             obs_inlier=inlier_out, chi2=chi2_out)
