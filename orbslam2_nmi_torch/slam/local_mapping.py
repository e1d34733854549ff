"""Local mapping: map-point culling, triangulation, fusion, local BA, KF culling.

Port of `orbslam2_nmi_tpu/slam/local_mapping.py`, the equivalent of the
reference's LocalMapping thread body (src/LocalMapping.cc:50-115). The map
is host numpy (`slam/map_store.py`); the batched matching, triangulation and
bundle adjustment run as torch ops on `device`.

Parity notes (the JAX package's):
  * recent-point culling ratios and windows: LocalMapping.cc:173-204
  * triangulation against the top-20 covisible KFs with baseline/median-depth,
    epipolar, parallax, reprojection and scale-consistency gates:
    LocalMapping.cc:210 + ORBmatcher::SearchForTriangulation (:690)
  * neighbour fuse: LocalMapping.cc SearchInNeighbors
  * local BA with NMI-relocalized keyframes FIXED: Optimizer.cc:548 (FORK)
  * KF culling (>= 90 % redundant), NMI KFs immune: LocalMapping.cc:696 (FORK)

Where the port differs:
  * Descriptors stay uint32 in the map and cross to the device as int32 bit
    patterns (`ops/matching.py`).
  * The epoch and version checks and the lock discipline are the JAX
    package's: map mutations hold `map.lock`, the BA's device solve does not,
    and a result computed against a map that a reset wiped is discarded.
  * `records` keeps, for each processed keyframe, the time of each phase,
    the sizes of its local BA (`last_ba`) and its wait in the mapping queue
    (`queued_ms`), read by `chip_smoke.py`; the newest `KEYFRAME_RECORDS`.
  * A rejected local BA is logged and, when `ORBSLAM2_NMI_TORCH_DUMP_BAD_BA`
    names a directory, dumped there as `bad_ba_{O}.npz` with the JAX
    package's keys (its `ORBSLAM2_NMI_TPU_DUMP_BAD_BA`, local_mapping.py:
    597-613).
  * `_triangulate_pair`, which nothing in the JAX package calls, is not
    ported.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from orbslam2_nmi_torch import kernels
from orbslam2_nmi_torch.config import SystemConfig
from orbslam2_nmi_torch.ops import matching, triangulate
from orbslam2_nmi_torch.slam.map_store import MapStore
from orbslam2_nmi_torch.solvers import local_ba
from orbslam2_nmi_torch.utils.bucketing import bucket, pad_rows, row_mask
from orbslam2_nmi_torch.utils.readback import to_host

# names a directory into which a rejected local BA's problem is dumped
DUMP_BAD_BA = "ORBSLAM2_NMI_TORCH_DUMP_BAD_BA"
KEYFRAME_RECORDS = 1024  # keyframes whose record is kept


def _next_pow2(n: int, lo: int = 64) -> int:
    v = lo
    while v < n:
        v *= 2
    return v


class LocalMapper:
    def __init__(self, cfg: SystemConfig, map_store: MapStore, log_fn=None, device="cuda"):
        self.cfg = cfg
        self.map = map_store
        self.log = log_fn or (lambda s: None)
        self.device = kernels.resolve_device(device, "LocalMapper")
        self.K = cfg.camera.K
        n_lv = cfg.orb.n_levels
        sf = cfg.orb.scale_factor
        self.inv_sigma2 = (1.0 / (sf ** np.arange(n_lv)) ** 2).astype(np.float32)
        self.recent_points: list[tuple[int, int]] = []  # (mp, created_at_kf)
        self.enable_kf_culling = True
        self.records: list[dict] = []  # one a processed keyframe (see module docstring)
        self.last_ba: dict | None = None  # sizes and times of the last local BA
        self.last_gba: dict | None = None  # and of the last synchronous global BA
        self._last_prob = None

    def _up(self, a) -> torch.Tensor:
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:  # descriptor words: their bits as int32
            a = a.view(np.int32)
        return torch.from_numpy(a).to(self.device)

    # ------------------------------------------------------------- pipeline

    def process_keyframe(self, k: int, abort_fn=None, queued_at: float | None = None):
        """LocalMapping::Run body for one queued KF (LocalMapping.cc:50-115).

        `abort_fn` is the InterruptBA hook (LocalMapping.cc mbAbortBA): when it
        returns True (a newer KF is already queued), the local BA is skipped —
        it reruns at the newer KF, which is the reference's net behavior. Map
        mutations run under the map lock; the BA device solve does not.
        `queued_at` is the `time.perf_counter()` at which the KF was queued
        (None: it was not).
        """
        t0 = time.perf_counter()
        rec = {"kf": int(k), "t_start": t0,
               "queued_ms": 0.0 if queued_at is None else (t0 - queued_at) * 1e3}
        with self.map.lock:
            # a System::Reset may have wiped the map while this KF sat in the
            # queue (the reference drains the mapping thread during Reset,
            # Tracking.cc:1764-1779; the epoch check is the async equivalent)
            epoch = self.map.epoch
            if k >= self.map.n_keyframes or not self.map.kf_valid[k]:
                return
            n_pts0 = self.map.n_points
            self._refresh_point_stats(k)
            self._cull_recent_points(k)
            t1 = time.perf_counter()
            rec["created"] = self._create_new_map_points(k, abort_fn=abort_fn)
            t2 = time.perf_counter()
            # the reference skips SearchInNeighbors when a newer KF is already
            # queued (LocalMapping.cc:84-88 `if(!CheckNewKeyFrames())`)
            if not (abort_fn and abort_fn()):
                self._fuse_neighbors(k)
            t3 = time.perf_counter()
            self.map.bump_version()
            rec.update(stats_cull_ms=(t1 - t0) * 1e3, create_ms=(t2 - t1) * 1e3,
                       fuse_ms=(t3 - t2) * 1e3, new_slots=self.map.n_points - n_pts0)
        self.last_ba = None
        if self.map.n_keyframes > 2 and not (abort_fn and abort_fn()):
            self.local_bundle_adjust(k, epoch=epoch)
        t4 = time.perf_counter()
        rec.update(ba_ms=(t4 - t3) * 1e3, ba=self.last_ba)
        with self.map.lock:
            if self.map.epoch != epoch:
                return
            if self.enable_kf_culling:
                n_kf = int(self.map.kf_valid[: self.map.n_keyframes].sum())
                self._cull_keyframes(k)
                rec["culled_kfs"] = n_kf - int(self.map.kf_valid[: self.map.n_keyframes].sum())
                self.map.bump_version()
        rec["t_end"] = time.perf_counter()
        rec["total_ms"] = (rec["t_end"] - t0) * 1e3
        self.records.append(rec)
        del self.records[:-KEYFRAME_RECORDS]

    def _refresh_point_stats(self, k: int):
        for f in np.nonzero(self.map.kf_mp_idx[k] >= 0)[0]:
            p = int(self.map.kf_mp_idx[k, f])
            self.map.update_point_stats(
                p, self.K, self.cfg.orb.scale_factor, self.cfg.orb.n_levels
            )

    # ------------------------------------------------------------- culling

    def _cull_recent_points(self, k: int):
        """MapPointCulling (LocalMapping.cc:173-204)."""
        keep = []
        for p, born in self.recent_points:
            if not self.map.mp_valid[p]:
                continue
            ratio = self.map.mp_found[p] / max(self.map.mp_visible[p], 1)
            age = k - born
            if ratio < 0.25:
                self.map.remove_map_point(p)
            elif age >= 2 and self.map.mp_obs_n[p] <= 2:
                self.map.remove_map_point(p)
            elif age >= 3:
                pass  # graduated — stop tracking
            else:
                keep.append((p, born))
        self.recent_points = keep

    def _cull_keyframes(self, k: int):
        """KeyFrameCulling (LocalMapping.cc:696): a covisible KF is redundant if
        >= 90% of its points are seen by >= 3 other KFs at same-or-finer scale.
        FORK rule: never cull NMI-relocalized keyframes."""
        m = self.map
        for kc in m.covisible_keyframes(k):
            kc = int(kc)
            if kc == 0 or m.kf_nmi_reloc[kc]:
                continue
            fs = np.nonzero(m.kf_mp_idx[kc] >= 0)[0]
            if len(fs) < 20:
                continue
            ps = m.kf_mp_idx[kc, fs]
            lvl = m.kf_feat_octave[kc, fs]
            kk = m.mp_obs_kf[ps]  # [F, M]
            ff = m.mp_obs_feat[ps]
            slot = np.arange(kk.shape[1])[None, :]
            omask = (slot < m.mp_obs_n[ps][:, None]) & (kk >= 0) & (kk != kc)
            kk0 = np.maximum(kk, 0)
            omask &= m.kf_feat_octave[kk0, np.maximum(ff, 0)] <= lvl[:, None] + 1
            n_other = omask.sum(1)
            n_redundant = int((m.mp_valid[ps] & (n_other >= 3)).sum())
            if n_redundant >= 0.9 * len(fs):
                m.remove_keyframe(kc)
                self.log(f"culled redundant keyframe {kc}")

    # ------------------------------------------------------- new map points

    def _create_new_map_points(self, k: int, abort_fn=None) -> int:
        """CreateNewMapPoints (LocalMapping.cc:210), batched: one epipolar
        match and one triangulation covering every usable neighbour pair
        (matching.match_epipolar_batch, triangulate.triangulate_and_gate_batch).
        The abort check runs before the device work. Returns the number of
        points created."""
        m = self.map
        ck = self._center(k)
        pairs = []
        for kn in self.map.best_covisible(k, 20):
            kn = int(kn)
            baseline = float(np.linalg.norm(self._center(kn) - ck))
            med_depth = self._median_depth(kn)
            if med_depth <= 0 or baseline / med_depth < 0.01:
                continue
            if (m.kf_feat_valid[kn] & (m.kf_mp_idx[kn] < 0)).sum() >= 5:
                pairs.append(kn)
        free1 = m.kf_feat_valid[k] & (m.kf_mp_idx[k] < 0)
        if not pairs or free1.sum() < 5 or (abort_fn and abort_fn()):
            return 0

        # one epipolar match across all pairs (pair axis padded to a power of 2)
        sigma2 = 1.0 / self.inv_sigma2
        N = len(pairs)
        NP = 1
        while NP < N:
            NP *= 2
        F = m.kf_feat_desc.shape[1]
        pad_pairs = pairs + [pairs[0]] * (NP - N)
        free2 = m.kf_feat_valid[pad_pairs] & (m.kf_mp_idx[pad_pairs] < 0)
        free2[N:] = False  # padding pairs match nothing
        F12 = np.stack([self._fundamental(k, kn) for kn in pad_pairs]).astype(np.float32)
        s2 = sigma2[m.kf_feat_octave[pad_pairs]].astype(np.float32)
        idx_b = to_host(matching.match_epipolar_batch(
            self._up(m.kf_feat_desc[k]),
            self._up(np.broadcast_to(free1, (NP, F))),
            self._up(m.kf_feat_xy[k]),
            self._up(m.kf_feat_desc[pad_pairs]),
            self._up(free2),
            self._up(m.kf_feat_xy[pad_pairs]),
            self._up(F12),
            self._up(s2),
        ))[:N]  # [N, F] match into each neighbour

        # one triangulation across all matched pairs
        f1_list = [np.nonzero(idx_b[i] >= 0)[0] for i in range(N)]
        n_max = max((len(f) for f in f1_list), default=0)
        if n_max == 0:
            return 0
        nb = bucket(n_max)
        uv1 = np.zeros((NP, nb, 2), np.float32)
        uv2 = np.zeros((NP, nb, 2), np.float32)
        s1g = np.ones((NP, nb), np.float32)
        s2g = np.ones((NP, nb), np.float32)
        vmask = np.zeros((NP, nb), bool)
        for i, kn in enumerate(pairs):
            f1s = f1_list[i]
            f2s = idx_b[i, f1s]
            nn = len(f1s)
            uv1[i, :nn] = m.kf_feat_xy[k][f1s]
            uv2[i, :nn] = m.kf_feat_xy[kn][f2s]
            s1g[i, :nn] = self.inv_sigma2[m.kf_feat_octave[k, f1s]]
            s2g[i, :nn] = self.inv_sigma2[m.kf_feat_octave[kn, f2s]]
            vmask[i, :nn] = True
        tri = triangulate.triangulate_and_gate_batch(
            self._up(self.K), self._up(m.kf_Tcw[k]), self._up(m.kf_Tcw[pad_pairs]),
            self._up(uv1), self._up(uv2), self._up(s1g), self._up(s2g), self._up(vmask),
        )
        ok_b = to_host(tri.valid)
        pts_b = to_host(tri.points_w)

        # host insertion (same gates and bookkeeping as the JAX package)
        sf = self.cfg.orb.scale_factor
        created = 0
        for i, kn in enumerate(pairs):
            f1s = f1_list[i]
            nn = len(f1s)
            if nn == 0:
                continue
            f2s = idx_b[i, f1s]
            ok = ok_b[i, :nn].copy()
            pts = pts_b[i, :nn]
            # scale consistency (LocalMapping.cc ratioDist vs ratioOctave, 1.5)
            d1 = np.linalg.norm(pts - ck, axis=-1)
            d2 = np.linalg.norm(pts - self._center(kn), axis=-1)
            ratio_dist = d2 / np.maximum(d1, 1e-9)
            ratio_oct = sf ** (
                m.kf_feat_octave[k, f1s].astype(np.float32)
                - m.kf_feat_octave[kn, f2s].astype(np.float32)
            )
            ok &= (ratio_dist < ratio_oct * sf * 1.5) & (ratio_dist * sf * 1.5 > ratio_oct)
            for j in np.nonzero(ok)[0]:
                f1, f2 = int(f1s[j]), int(f2s[j])
                if m.kf_mp_idx[kn, f2] >= 0:
                    continue
                existing = int(m.kf_mp_idx[k, f1])
                if existing >= 0:
                    # the same new-KF feature matched in an earlier pair this
                    # round: a third view of the same landmark
                    if m.mp_valid[existing]:
                        m.add_observation(kn, f2, existing)
                    continue
                p = m.add_map_point(pts[j], m.kf_feat_desc[k, f1], k, np.zeros(3, np.float32))
                m.add_observation(k, f1, p)
                m.add_observation(kn, f2, p)
                m.update_point_stats(p, self.K, sf, self.cfg.orb.n_levels)
                self.recent_points.append((p, k))
                created += 1
        if created:
            self.log(f"KF {k}: created {created} map points")
        return created

    # ----------------------------------------------------------------- fuse

    def _fuse_neighbors(self, k: int):
        """SearchInNeighbors (LocalMapping.cc SearchInNeighbors): project this
        KF's points into neighbours (and back) and merge duplicates, all
        (src, dst) directions matched in one batched call
        (matching.fuse_match_batch) against the pre-fuse map state, mutations
        applied on the host afterwards; stale entries (a point replaced by an
        earlier direction's merge) are dropped by the validity guards."""
        m = self.map
        neighbors = [int(x) for x in self.map.best_covisible(k, 10)]
        directions = [(k, kn) for kn in neighbors] + [(kn, k) for kn in neighbors]

        jobs = []  # (k_src, k_dst, src_ps, proj)
        for k_src, k_dst in directions:
            src_ps = np.unique(m.kf_mp_idx[k_src])
            src_ps = src_ps[src_ps >= 0]
            src_ps = src_ps[m.mp_valid[src_ps]]
            if len(src_ps) == 0:
                continue
            pj, vis = self._project_visible(m.kf_Tcw[k_dst], m.mp_pos[src_ps])
            src_ps = src_ps[vis]
            if len(src_ps) == 0:
                continue
            jobs.append((k_src, k_dst, src_ps, pj[vis]))
        if jobs:
            P = len(jobs)
            PP = 1
            while PP < P:
                PP *= 2
            nb = bucket(max(len(j[2]) for j in jobs))
            F = m.kf_feat_desc.shape[1]
            desc_src = np.zeros((PP, nb, 8), np.uint32)
            valid_src = np.zeros((PP, nb), bool)
            proj = np.zeros((PP, nb, 2), np.float32)
            desc_dst = np.zeros((PP, F, 8), np.uint32)
            valid_dst = np.zeros((PP, F), bool)
            xy_dst = np.zeros((PP, F, 2), np.float32)
            for i, (k_src, k_dst, src_ps, pj) in enumerate(jobs):
                n = len(src_ps)
                desc_src[i, :n] = m.mp_desc[src_ps]
                valid_src[i, :n] = True
                proj[i, :n] = pj
                desc_dst[i] = m.kf_feat_desc[k_dst]
                valid_dst[i] = m.kf_feat_valid[k_dst]
                xy_dst[i] = m.kf_feat_xy[k_dst]
            idx_b = to_host(matching.fuse_match_batch(
                self._up(desc_src), self._up(valid_src), self._up(proj),
                self._up(desc_dst), self._up(valid_dst), self._up(xy_dst),
            ))
            for i, (k_src, k_dst, src_ps, _) in enumerate(jobs):
                idx = idx_b[i, : len(src_ps)]
                for j in np.nonzero(idx >= 0)[0]:
                    self._merge(k_dst, int(idx[j]), int(src_ps[j]))
        self._refresh_point_stats(k)

    def _merge(self, k_dst: int, f: int, p: int):
        """Bind point p to feature f of k_dst, or merge it with the point
        already there, keeping the better-observed one (MapPoint::Replace)."""
        m = self.map
        if not m.mp_valid[p]:
            return  # replaced by an earlier merge
        existing = int(m.kf_mp_idx[k_dst, f])
        if existing < 0:
            m.add_observation(k_dst, f, p)
        elif existing != p and m.mp_valid[existing]:
            if m.mp_obs_n[existing] >= m.mp_obs_n[p]:
                m.replace_map_point(p, existing)
            else:
                m.replace_map_point(existing, p)

    def _project_visible(self, Tcw: np.ndarray, pts: np.ndarray):
        """(uv [N, 2], in-image mask [N]) of world points seen from Tcw."""
        pc = (Tcw[:3, :3] @ pts.T).T + Tcw[:3, 3]
        z = pc[:, 2]
        zs = np.where(np.abs(z) > 1e-9, z, 1e-9)
        u = self.K[0, 0] * pc[:, 0] / zs + self.K[0, 2]
        v = self.K[1, 1] * pc[:, 1] / zs + self.K[1, 2]
        vis = ((z > 0) & (u >= 0) & (u < self.cfg.camera.width) & (v >= 0)
               & (v < self.cfg.camera.height))
        return np.stack([u, v], -1), vis

    def _fuse_into(self, k_src: int, k_dst: int, radius: float = 3.0):
        """Fuse k_src's points into k_dst (loop closing's SearchAndFuse)."""
        m = self.map
        src_ps = np.unique(m.kf_mp_idx[k_src])
        src_ps = src_ps[src_ps >= 0]
        src_ps = src_ps[m.mp_valid[src_ps]]
        if len(src_ps) == 0:
            return
        pj, vis = self._project_visible(m.kf_Tcw[k_dst], m.mp_pos[src_ps])
        src_ps = src_ps[vis]
        if len(src_ps) == 0:
            return
        nb = bucket(len(src_ps))
        sm = matching.window_mask(self._up(pad_rows(pj[vis].astype(np.float32), nb)),
                                  self._up(m.kf_feat_xy[k_dst]), radius)
        idx, _ = matching.match_descriptors(
            self._up(pad_rows(m.mp_desc[src_ps], nb)),
            self._up(row_mask(len(src_ps), nb)),
            self._up(m.kf_feat_desc[k_dst]),
            self._up(m.kf_feat_valid[k_dst]),
            spatial_mask=sm,
            max_dist=matching.TH_LOW,
            apply_ratio=False,
        )
        idx = to_host(idx)[: len(src_ps)]
        for i in np.nonzero(idx >= 0)[0]:
            self._merge(k_dst, int(idx[i]), int(src_ps[i]))

    # ------------------------------------------------------------------- BA

    def local_bundle_adjust(self, k: int, epoch: int | None = None):
        """Optimizer::LocalBundleAdjustment (Optimizer.cc:472): covisible KFs
        free (NMI-anchored + KF 0 fixed), observer-only KFs fixed.

        Snapshot and write-back hold the map lock; the device solve runs
        unlocked, so a tracking thread is never blocked on BA. A result
        computed against a map that was reset mid-solve (epoch changed) is
        discarded at write-back."""
        with self.map.lock:
            if epoch is not None and self.map.epoch != epoch:
                return
            snap = self._ba_snapshot(k)
        if snap is None:
            return
        prob, cams, pts, fixed, oc, op, O, n_local = snap
        self._last_prob = prob
        t = time.perf_counter()
        res = local_ba.bundle_adjust(
            prob,
            iters1=self.cfg.tracking.local_ba_iters1,
            iters2=self.cfg.tracking.local_ba_iters2,
        )
        host = local_ba.BAResult(*(to_host(x) for x in res))  # waits for the solve
        solve_ms = (time.perf_counter() - t) * 1e3
        C, P = prob.cam_Tcw.shape[0], prob.pts_w.shape[0]
        self.last_ba = dict(C=C, P=P, O=prob.obs_cam.shape[0], n_obs=O, n_cams=len(cams),
                            n_pts=len(pts), free=int((~fixed[: len(cams)]).sum()),
                            fixed=int(fixed[: len(cams)].sum()), solve_ms=solve_ms,
                            hcp_bytes=local_ba.coupling_bytes(prob), dropped=None)
        with self.map.lock:
            if epoch is not None and self.map.epoch != epoch:
                return
            self.last_ba["dropped"] = self._ba_apply(host, cams, pts, fixed, oc, op, O, n_local)
            self.map.bump_version()

    def _snapshot_observations(self, pts: np.ndarray, cam_pos_arr: np.ndarray):
        """(obs_cam, obs_pt, kk, ff) of the points' observations by valid
        keyframes that have a camera slot."""
        m = self.map
        obs_kk = m.mp_obs_kf[pts]  # [P, M]
        obs_ff = m.mp_obs_feat[pts]
        slot = np.arange(obs_kk.shape[1])[None, :]
        omask = (slot < m.mp_obs_n[pts][:, None]) & (obs_kk >= 0)
        omask &= m.kf_valid[np.maximum(obs_kk, 0)]
        kk_flat = obs_kk[omask]
        ff_flat = obs_ff[omask]
        obs_cam = cam_pos_arr[kk_flat]
        obs_pt = np.broadcast_to(np.arange(len(pts))[:, None], obs_kk.shape)[omask]
        keep = obs_cam >= 0
        return obs_cam[keep], obs_pt[keep], kk_flat[keep], ff_flat[keep]

    def _problem(self, cams: list, pts: np.ndarray, fixed_of, obs,
                 pad_fixed: bool) -> tuple | None:
        """The padded BAProblem over keyframes `cams` and points `pts`;
        `fixed_of(kf)` says whether a keyframe is fixed, `pad_fixed` whether
        the padding camera slots are marked fixed (they are invalid either
        way). Returns (problem, fixed [C], oc [Ob], op [Ob], O) or None below
        20 observations."""
        m = self.map
        obs_cam, obs_pt, kk_flat, ff_flat = obs
        O = len(obs_cam)
        if O < 20:
            return None
        C = _next_pow2(len(cams), 8)
        P = _next_pow2(len(pts), 256)
        Ob = _next_pow2(O, 1024)
        fixed = np.zeros(C, bool)
        fixed[len(cams):] = pad_fixed
        for i, kf in enumerate(cams):
            fixed[i] = fixed_of(kf)
        cam_valid = np.zeros(C, bool)
        cam_valid[: len(cams)] = True
        pts_valid = np.zeros(P, bool)
        pts_valid[: len(pts)] = True
        cam_Tcw = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
        cam_Tcw[: len(cams)] = m.kf_Tcw[cams]
        pts_w = np.zeros((P, 3), np.float32)
        pts_w[: len(pts)] = m.mp_pos[pts]
        oc = np.zeros(Ob, np.int32)
        op = np.zeros(Ob, np.int32)
        ouv = np.zeros((Ob, 2), np.float32)
        ow = np.ones(Ob, np.float32)
        ovalid = np.zeros(Ob, bool)
        oc[:O] = obs_cam
        op[:O] = obs_pt
        ouv[:O] = m.kf_feat_xy[kk_flat, ff_flat]
        ow[:O] = self.inv_sigma2[m.kf_feat_octave[kk_flat, ff_flat]]
        ovalid[:O] = True
        prob = local_ba.BAProblem(
            K=self._up(self.K.astype(np.float32)), cam_Tcw=self._up(cam_Tcw),
            cam_fixed=self._up(fixed), cam_valid=self._up(cam_valid), pts_w=self._up(pts_w),
            pts_valid=self._up(pts_valid), obs_cam=self._up(oc), obs_pt=self._up(op),
            obs_uv=self._up(ouv), obs_inv_sigma2=self._up(ow), obs_valid=self._up(ovalid),
        )
        return prob, fixed, oc, op, O

    def _ba_snapshot(self, k: int):
        m = self.map
        local = [k] + [int(x) for x in self.map.covisible_keyframes(k)]
        local = local[:24]
        pts = np.unique(m.kf_mp_idx[local])
        pts = pts[pts >= 0]
        pts = pts[m.mp_valid[pts]]
        if len(pts) < 10:
            return None
        obs_kk = m.mp_obs_kf[pts]
        slot = np.arange(obs_kk.shape[1])[None, :]
        omask = (slot < m.mp_obs_n[pts][:, None]) & (obs_kk >= 0)
        omask &= m.kf_valid[np.maximum(obs_kk, 0)]
        observers = np.unique(obs_kk[omask])
        fixed_kfs = sorted(set(int(x) for x in observers) - set(local))
        cams = local + fixed_kfs
        cam_pos_arr = np.full(m.kf_valid.shape[0], -1, np.int64)
        for i, kf in enumerate(cams):
            cam_pos_arr[kf] = i
        fixed_set = set(fixed_kfs)
        out = self._problem(
            cams, pts, lambda kf: kf in fixed_set or kf == 0 or bool(m.kf_nmi_reloc[kf]),
            self._snapshot_observations(pts, cam_pos_arr), pad_fixed=True)
        if out is None:
            return None
        prob, fixed, oc, op, O = out
        return prob, cams, pts, fixed, oc, op, O, len(local)

    def _ba_apply(self, res, cams, pts, fixed, oc, op, O, n_local) -> int | None:
        """Write a local BA's result (host arrays) back; returns the number
        of outlier observations dropped, or None when the solve is rejected."""
        m = self.map
        new_cams, new_pts, inlier = res.cam_Tcw, res.pts_w, res.obs_inlier
        # divergence guard: a solve that rejects (nearly) every observation is
        # a failed solve, not a legitimate outlier recollection
        n_bad = int((~inlier[:O]).sum())
        if O >= 50 and n_bad > 0.8 * O:
            self.log(f"local BA REJECTED: {n_bad}/{O} observations marked outlier "
                     "(divergent solve, fixed-anchor conflict?) — result discarded")
            dump, prob = os.environ.get(DUMP_BAD_BA), self._last_prob
            if dump and prob is not None:
                np.savez(os.path.join(dump, f"bad_ba_{O}.npz"), O=O, new_cams=new_cams,
                         chi2=res.chi2, **{f: to_host(getattr(prob, f)) for f in prob._fields})
            return None
        for i, kf in enumerate(cams):
            if not fixed[i] and m.kf_valid[kf]:
                m.kf_Tcw[kf] = new_cams[i]
        # skip points culled/replaced while the (unlocked) solve ran
        still = m.mp_valid[pts]
        m.mp_pos[pts[still]] = new_pts[: len(pts)][still]
        # drop outlier observations (Optimizer.cc:725 recollection)
        dropped = 0
        for j in np.nonzero(~inlier[:O])[0]:
            kf = cams[int(oc[j])]
            p = int(pts[op[j]])
            n = m.mp_obs_n[p]
            for kk, ff in zip(m.mp_obs_kf[p, :n], m.mp_obs_feat[p, :n]):
                if int(kk) == kf:
                    m.remove_observation(int(kk), int(ff))
                    dropped += 1
                    break
        self.log(
            f"local BA: {n_local} KFs ({int(fixed[:len(cams)].sum())} fixed), "
            f"{len(pts)} pts, {O} obs, dropped {dropped}"
        )
        return dropped

    def global_ba(self, iters: int = 20):
        """GlobalBundleAdjustemnt (Optimizer.cc:43) with NMI-fixed anchors
        (Optimizer.cc:82 FORK). Used at NMI initialization and after loops.
        Synchronous: snapshot, solve and apply inline."""
        with self.map.lock:
            snap = self.global_ba_snapshot()
        if snap is None:
            return
        prob = snap[0]
        t = time.perf_counter()
        res = local_ba.bundle_adjust(prob, iters1=iters // 2, iters2=iters - iters // 2)
        res = local_ba.BAResult(*(to_host(x) for x in res))  # waits for the solve
        self.last_gba = dict(C=prob.cam_Tcw.shape[0], P=prob.pts_w.shape[0],
                             O=prob.obs_cam.shape[0], solve_ms=(time.perf_counter() - t) * 1e3)
        self.global_ba_apply(res, *snap[1:])

    def global_ba_snapshot(self):
        """Build the full-map BA problem. Caller holds the map lock.

        Returns (problem, kfs, pts, fixed) or None; the async pipeline runs
        the solve off-thread (the reference's GBA thread, LoopClosing.cc:587)
        and global_ba_apply propagates to state created meanwhile."""
        m = self.map
        kfs = [int(x) for x in m.valid_keyframe_indices()]
        pts = m.valid_point_indices()
        if len(kfs) < 1 or len(pts) < 10:
            return None
        cam_pos_arr = np.full(m.kf_valid.shape[0], -1, np.int64)
        for i, kf in enumerate(kfs):
            cam_pos_arr[kf] = i
        out = self._problem(kfs, pts, lambda kf: kf == 0 or bool(m.kf_nmi_reloc[kf]),
                            self._snapshot_observations(pts, cam_pos_arr), pad_fixed=False)
        if out is None:
            return None
        return out[0], kfs, pts, out[1]

    def global_ba_apply(self, res, kfs: list, pts: np.ndarray, fixed: np.ndarray):
        """Write a (possibly stale) global-BA result back and propagate the
        corrections to keyframes/points created while the solve ran, through
        the spanning tree (RunGlobalBundleAdjustment tail,
        LoopClosing.cc:690-756). `res` holds host arrays (numpy, or CPU
        tensors)."""
        m = self.map
        new_cams, new_pts = np.asarray(res.cam_Tcw), np.asarray(res.pts_w)
        with m.lock:
            Tbef = m.kf_Tcw.copy()  # mTcwBefGBA per keyframe
            in_ba_kf = np.zeros(m.kf_valid.shape[0], bool)
            in_ba_kf[kfs] = True
            for i, kf in enumerate(kfs):
                if not fixed[i] and m.kf_valid[kf]:
                    m.kf_Tcw[kf] = new_cams[i]
            # KFs created during the solve: Tcw = (Tcw_old @ inv(Tparent_old))
            # @ Tparent_new — parents always precede children in index order
            n_prop = 0
            for kf in m.valid_keyframe_indices():
                if in_ba_kf[kf]:
                    continue
                par = int(m.kf_parent[kf])
                while par >= 0 and not m.kf_valid[par]:
                    par = int(m.kf_parent[par])
                if par < 0:
                    continue
                rel = Tbef[kf] @ np.linalg.inv(Tbef[par])
                m.kf_Tcw[kf] = (rel @ m.kf_Tcw[par]).astype(np.float32)
                n_prop += 1
            # points solved by the BA (skip ones culled/replaced meanwhile)
            still = m.mp_valid[pts]
            m.mp_pos[pts[still]] = new_pts[: len(pts)][still]
            # points created during the solve: move with their reference KF
            # (LoopClosing.cc:744-755: Rwc_new * (Rcw_bef * X + tcw_bef))
            in_ba_pt = np.zeros(m.mp_valid.shape[0], bool)
            in_ba_pt[pts] = True
            others = m.valid_point_indices()
            others = others[~in_ba_pt[others]]
            if len(others):
                ref = m.mp_first_kf[others].astype(np.int64)
                ok = (ref >= 0) & m.kf_valid[np.maximum(ref, 0)]
                others, ref = others[ok], ref[ok]
                if len(others):
                    ph = np.concatenate(
                        [m.mp_pos[others], np.ones((len(others), 1), np.float32)], 1
                    )
                    corr = np.einsum("nij,njk->nik", np.linalg.inv(m.kf_Tcw[ref]), Tbef[ref])
                    m.mp_pos[others] = np.einsum("nij,nj->ni", corr, ph)[:, :3]
            self.log(
                f"global BA: {len(kfs)} KFs, {len(pts)} pts "
                f"(+{n_prop} KFs, {len(others)} pts propagated)"
            )
            m.bump_version()

    # ----------------------------------------------------------------- utils

    def _center(self, k: int) -> np.ndarray:
        T = self.map.kf_Tcw[k]
        return -T[:3, :3].T @ T[:3, 3]

    def _median_depth(self, k: int) -> float:
        """KeyFrame::ComputeSceneMedianDepth (KeyFrame.cc:641)."""
        m = self.map
        ps = m.kf_mp_idx[k]
        ps = ps[ps >= 0]
        ps = ps[m.mp_valid[ps]]
        if len(ps) == 0:
            return -1.0
        T = m.kf_Tcw[k]
        z = (m.mp_pos[ps] @ T[2, :3]) + T[2, 3]
        return float(np.median(z))

    def _fundamental(self, k1: int, k2: int) -> np.ndarray:
        """F12 = K^-T [t]x R K^-1 from relative pose (ORBmatcher epipolar)."""
        T1 = self.map.kf_Tcw[k1]
        T2 = self.map.kf_Tcw[k2]
        R1, t1 = T1[:3, :3], T1[:3, 3]
        R2, t2 = T2[:3, :3], T2[:3, 3]
        R12 = R1 @ R2.T
        t12 = -R12 @ t2 + t1
        tx = np.array(
            [[0, -t12[2], t12[1]], [t12[2], 0, -t12[0]], [-t12[1], t12[0], 0]],
            np.float32,
        )
        Kinv = np.linalg.inv(self.K)
        return Kinv.T @ tx @ R12 @ Kinv
