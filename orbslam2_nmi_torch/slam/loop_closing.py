"""Loop closing: detection, Sim3 verification, loop correction.

Port of `orbslam2_nmi_tpu/slam/loop_closing.py`, the step-interleaved
equivalent of the reference's LoopClosing thread (src/LoopClosing.cc:59 Run).
Per keyframe:

  * DetectLoop (:111-237): BoW candidates gated by the minimum covisible-
    neighbor score, then covisibility consistency over 3 consecutive KFs.
  * ComputeSim3 (:239-408): descriptor matching against each candidate's
    map points, batched Horn Sim3 RANSAC (`solvers/sim3.py`), guided
    SearchBySim3 matching (ORBmatcher.cc:1135), OptimizeSim3 refinement
    (Optimizer.cc:1063) requiring >= 20 optimized inliers, and a final
    Scw-projection search against the loop side's map points requiring
    >= 40 total matches (LoopClosing.cc:380-395).
  * CorrectLoop (:410-593): Sim3-propagate the current KF's covisible
    neighborhood, re-map their points, fuse the matched loop points into
    the current KF (:528-547), SearchAndFuse the loop map points into EVERY
    corrected neighbor with the Scw Fuse variant (:595-627,
    ORBmatcher.cc:1010), optimize the essential graph
    (`solvers/pose_graph.py`) and run a global BA with NMI-fixed anchors,
    on its own thread when the mapping pipeline gives a launcher (:587).

The map is host numpy, as in the JAX package; the matching and the three
solvers run as torch ops on `device`, and every result comes back through
`utils/readback.to_host`, which does not hold the interpreter lock while the
device finishes (the closer runs beside the tracking thread).

Where the port differs:
  * RANSAC samples. The JAX package splits a `jax.random` key per ComputeSim3
    (`PRNGKey(7)`). Here `draw_samples(n_rows, n_valid, n_hypotheses, size)`
    gives the [H, size] sample rows: by default drawn uniformly over the
    valid rows without replacement on a seeded CPU `torch.Generator`
    (`generator`), so a card run and a CPU run of the same closer test the
    same hypotheses; the parity tests replace it with the JAX package's
    draws.
  * `records` keeps, for each processed keyframe, the time of each phase
    (database add, detection, ComputeSim3 per candidate, the parts of
    CorrectLoop), the database's candidates and those that passed the
    consistency test (`candidates`); `last_pose_graph` keeps the
    last essential-graph problem as host arrays. `chip_smoke.py` reads both.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from orbslam2_nmi_torch import kernels
from orbslam2_nmi_torch.config import SystemConfig
from orbslam2_nmi_torch.ops import matching
from orbslam2_nmi_torch.slam.keyframe_database import KeyFrameDatabase
from orbslam2_nmi_torch.slam.map_store import MapStore
from orbslam2_nmi_torch.solvers import pose_graph, sim3 as sim3_solver
from orbslam2_nmi_torch.utils.bucketing import bucket, pad_rows, row_mask
from orbslam2_nmi_torch.utils.readback import to_host

N_HYPOTHESES = 128  # sim3_ransac's n_hypotheses in the JAX package


def draw_uniform(generator: torch.Generator, n_valid: int, n_hypotheses: int,
                 size: int) -> np.ndarray:
    """[n_hypotheses, size] int64 rows, each drawn uniformly without
    replacement from rows 0 .. n_valid - 1 (the valid rows of a padded set
    come first), on a CPU `generator`: the same rows on every device."""
    keys = torch.rand((n_hypotheses, n_valid), generator=generator)
    return torch.argsort(keys, dim=1)[:, :size].numpy()


def _sim3_to_se3(S: np.ndarray) -> np.ndarray:
    """Fold the sim3 scale into translation: [sR | t] -> [R | t/s] (the
    reference's `Rcw = sRcw/scw; tcw /= scw` at ORBmatcher.cc:330-333 and
    `eigt *= 1/s` at LoopClosing.cc:517)."""
    s = float(np.linalg.norm(S[:3, 0]))
    T = S.copy()
    T[:3, :3] /= s
    T[:3, 3] /= s
    return T.astype(np.float32)


class LoopCloser:
    def __init__(
        self,
        cfg: SystemConfig,
        map_store: MapStore,
        database: KeyFrameDatabase,
        local_mapper,
        log_fn=None,
        device="cuda",
        seed: int = 7,
    ):
        self.device = kernels.resolve_device(device, "LoopCloser")
        self.cfg = cfg
        self.map = map_store
        self.db = database
        self.local_mapper = local_mapper
        self.log = log_fn or (lambda s: None)
        self.consistent_groups: list[tuple[set, int]] = []
        # async-mode hook: launches RunGlobalBundleAdjustment on its own
        # thread with the abort protocol (set by MappingPipeline)
        self.gba_launcher = None
        self.last_loop_kf = -1
        self.covisibility_consistency_th = 3  # LoopClosing.h mnCovisibilityConsistencyTh
        self.loop_edges: list[tuple[int, int, np.ndarray]] = []  # (i, j, S_ji)
        self.generator = torch.Generator().manual_seed(seed)  # on the CPU
        self.draw_samples = self._draw_uniform
        self.records: list[dict] = []
        self.last_pose_graph: dict | None = None
        self._rec: dict = {}

    def _draw_uniform(self, n_rows: int, n_valid: int, n_hypotheses: int,
                      size: int) -> np.ndarray:
        return draw_uniform(self.generator, n_valid, n_hypotheses, size)

    def _up(self, a) -> torch.Tensor:
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:  # descriptor words: their bits as int32
            a = a.view(np.int32)
        return torch.from_numpy(a).to(self.device)

    # ------------------------------------------------------------- pipeline

    def process_keyframe(self, k: int) -> bool:
        """Returns True if a loop was closed at this keyframe."""
        # the KF may have been culled while queued, or the map Reset (the
        # reference's LoopClosing queue checks isBad, LoopClosing.cc:102)
        if k >= self.map.n_keyframes or not self.map.kf_valid[k]:
            return False
        closed = False
        self._rec = rec = dict(kf=k, candidates=None, sim3_ms=[], closed_with=-1)
        if self.map.n_keyframes >= 10 and k - self.last_loop_kf > 10:
            t = time.perf_counter()
            cands = self._detect_loop(k)
            rec["detect_ms"] = (time.perf_counter() - t) * 1e3
            rec["candidates"] = list(cands)
            for cand in cands:
                t = time.perf_counter()
                ok, Scw_corr, matched_cur, loop_mps = self._compute_sim3(k, cand)
                rec["sim3_ms"].append((time.perf_counter() - t) * 1e3)
                if ok:
                    self._correct_loop(k, cand, Scw_corr, matched_cur, loop_mps)
                    self.map.bump_version()
                    rec["closed_with"] = int(cand)
                    closed = True
                    break
        t = time.perf_counter()
        self.db.add(k, self.map.kf_feat_desc[k], self.map.kf_feat_valid[k])
        rec["db_add_ms"] = (time.perf_counter() - t) * 1e3
        self.records.append(rec)
        return closed

    # ------------------------------------------------------------ detection

    def _detect_loop(self, k: int) -> list[int]:
        """DetectLoop (LoopClosing.cc:111): candidate gen + 3-consecutive
        covisibility-consistency. The minimum score is the lowest BoW
        similarity to a covisible neighbor (:127-141)."""
        neighbors = self.map.covisible_keyframes(k)
        if len(neighbors) == 0:
            self.consistent_groups = []
            return []
        words, weights = self.db.compute_entry(
            self.map.kf_feat_desc[k], self.map.kf_feat_valid[k]
        )
        in_db = np.array([n for n in neighbors if self.db.active[int(n)]], np.int64)
        if len(in_db):
            neigh_scores = self.db.score_against(words, weights, in_db)
            min_score = float(neigh_scores.min())
        else:
            min_score = 0.0

        cands = self.db.detect_loop_candidates(self.map, k, words, weights, min_score)
        self._rec["db_candidates"] = list(cands)
        if not cands:
            self.consistent_groups = []
            self.log(f"KF {k}: loop detect — no DB candidates (min_score {min_score:.4f})")
            return []
        self.log(f"KF {k}: loop detect — raw candidates {cands}")

        # covisibility consistency over consecutive keyframes
        enough: list[int] = []
        new_groups: list[tuple[set, int]] = []
        for cand in cands:
            group = {cand} | {int(x) for x in self.map.covisible_keyframes(cand)}
            matched_any = False
            for prev_group, count in self.consistent_groups:
                if group & prev_group:
                    new_count = count + 1
                    new_groups.append((group, new_count))
                    if new_count >= self.covisibility_consistency_th:
                        enough.append(cand)
                    matched_any = True
                    break
            if not matched_any:
                new_groups.append((group, 0))
                if 0 >= self.covisibility_consistency_th:
                    enough.append(cand)
        self.consistent_groups = new_groups
        if enough:
            self.log(f"KF {k}: loop candidates {enough}")
        return enough

    # ------------------------------------------------------------- sim3

    def _compute_sim3(self, k: int, cand: int):
        """ComputeSim3 (LoopClosing.cc:239-408): match map-point features of
        both KFs, Horn RANSAC, guided SearchBySim3 expansion
        (ORBmatcher.cc:1135), OptimizeSim3 with the >= 20 optimized-inlier
        gate (Optimizer.cc:1063; LoopClosing.cc:337), then an Scw-projection
        search against the loop side's map-point set with the >= 40
        total-match gate (LoopClosing.cc:380-395).

        Returns (ok, Scw_corr, matched_cur, loop_mps): the corrected sim3
        world->current-camera pose, the per-feature loop-point matches of the
        current KF (mvpCurrentMatchedPoints), and the loop side's map points
        (mvpLoopMapPoints)."""
        m = self.map
        has1 = m.kf_mp_idx[k] >= 0
        has2 = m.kf_mp_idx[cand] >= 0
        if has1.sum() < 20 or has2.sum() < 20:
            return False, None, None, None
        idx, _ = matching.match_descriptors(
            self._up(m.kf_feat_desc[k]),
            self._up(has1),
            self._up(m.kf_feat_desc[cand]),
            self._up(has2),
            max_dist=matching.TH_LOW,
            nn_ratio=0.75,
            angle_a=self._up(m.kf_feat_angle[k]),
            angle_b=self._up(m.kf_feat_angle[cand]),
            check_rotation=True,
        )
        idx = to_host(idx)
        f1 = np.nonzero(idx >= 0)[0]
        if len(f1) < 20:  # LoopClosing.cc:273 nmatches<20
            self.log(f"KF {k}: Sim3 to {cand} rejected ({len(f1)} raw matches)")
            return False, None, None, None
        f2 = idx[f1]
        T1 = m.kf_Tcw[k]
        T2 = m.kf_Tcw[cand]
        n_lv = self.cfg.orb.n_levels
        inv_s2 = (1.0 / (self.cfg.orb.scale_factor ** np.arange(n_lv)) ** 2).astype(np.float32)

        def pair_arrays(f1s, f2s):
            p1_cam = m.mp_pos[m.kf_mp_idx[k, f1s]] @ T1[:3, :3].T + T1[:3, 3]
            p2_cam = m.mp_pos[m.kf_mp_idx[cand, f2s]] @ T2[:3, :3].T + T2[:3, 3]
            return p1_cam, p2_cam

        p1_cam, p2_cam = pair_arrays(f1, f2)
        nb = bucket(len(f1))
        samples = self.draw_samples(nb, len(f1), N_HYPOTHESES, 3)
        res = sim3_solver.sim3_ransac(
            self._up(samples),
            self.cfg.camera.K,
            self._up(pad_rows(p1_cam, nb)),
            self._up(pad_rows(p2_cam, nb)),
            self._up(pad_rows(m.kf_feat_xy[k, f1], nb)),
            self._up(pad_rows(m.kf_feat_xy[cand, f2], nb)),
            self._up(pad_rows(inv_s2[m.kf_feat_octave[k, f1]], nb, 1.0)),
            self._up(pad_rows(inv_s2[m.kf_feat_octave[cand, f2]], nb, 1.0)),
            self._up(row_mask(len(f1), nb)),
            min_inliers=20,
        )
        ransac_inl = to_host(res.inliers)[: len(f1)]
        self._rec.update(raw_matches=len(f1), ransac_inliers=int(ransac_inl.sum()))
        if not bool(to_host(res.ok)):
            self.log(
                f"KF {k}: Sim3 to {cand} rejected (RANSAC, {len(f1)} matches, "
                f"{int(ransac_inl.sum())} best inliers)"
            )
            return False, None, None, None
        S12 = to_host(res.S12).astype(np.float32)

        # guided matching with the RANSAC sim3 (SearchBySim3, th=7.5)
        f1_inl, f2_inl = f1[ransac_inl], f2[ransac_inl]
        ef1, ef2 = self._search_by_sim3(k, cand, S12, f1_inl, f2_inl, th=7.5)
        all_f1 = np.concatenate([f1_inl, ef1]).astype(np.int64)
        all_f2 = np.concatenate([f2_inl, ef2]).astype(np.int64)

        # OptimizeSim3 on the expanded set, >= 20 optimized inliers
        p1_cam, p2_cam = pair_arrays(all_f1, all_f2)
        nb = bucket(len(all_f1))
        opt = sim3_solver.optimize_sim3(
            self.cfg.camera.K,
            self._up(S12),
            self._up(pad_rows(p1_cam, nb)),
            self._up(pad_rows(p2_cam, nb)),
            self._up(pad_rows(m.kf_feat_xy[k, all_f1], nb)),
            self._up(pad_rows(m.kf_feat_xy[cand, all_f2], nb)),
            self._up(pad_rows(inv_s2[m.kf_feat_octave[k, all_f1]], nb, 1.0)),
            self._up(pad_rows(inv_s2[m.kf_feat_octave[cand, all_f2]], nb, 1.0)),
            self._up(row_mask(len(all_f1), nb)),
        )
        n_opt = int(to_host(opt.n_inliers))
        self._rec.update(expanded_matches=len(all_f1), opt_inliers=n_opt)
        if n_opt < 20:  # LoopClosing.cc:339 nInliers>=20
            self.log(f"KF {k}: Sim3 to {cand} rejected ({n_opt} optimized inliers)")
            return False, None, None, None
        S12 = to_host(opt.S12).astype(np.float32)
        Scw_corr = (S12 @ T2).astype(np.float32)  # gScm * gSmw (LoopClosing.cc:344)

        # loop-side map points: candidate + its covisible neighborhood
        loop_kfs = [cand] + [int(x) for x in m.covisible_keyframes(cand)]
        loop_mps = np.unique(m.kf_mp_idx[loop_kfs])
        loop_mps = loop_mps[(loop_mps >= 0) & m.mp_valid[np.maximum(loop_mps, 0)]].astype(np.int64)

        # matched_cur: current-KF feature -> loop map point (mvpCurrentMatchedPoints)
        matched_cur = np.full(m.kf_mp_idx.shape[1], -1, np.int64)
        opt_inl = to_host(opt.inliers)[: len(all_f1)]
        matched_cur[all_f1[opt_inl]] = m.kf_mp_idx[cand, all_f2[opt_inl]]

        # find more matches by projecting loop points with the corrected Scw
        # (SearchByProjection(KF, Scw, ...) th=10, LoopClosing.cc:380; the
        # reference folds the sim3 scale out first, ORBmatcher.cc:330-333)
        free = ~np.isin(loop_mps, matched_cur)
        if free.any():
            best = self._project_match(
                loop_mps[free], _sim3_to_se3(Scw_corr), k, th=10.0,
                max_hamming=matching.TH_LOW, check_angle=True,
                feat_allowed=matched_cur < 0,
            )
            got = best >= 0
            matched_cur[best[got]] = loop_mps[free][got]
        n_total = int((matched_cur >= 0).sum())
        self._rec.update(total_matches=n_total)
        if n_total < 40:  # LoopClosing.cc:391 nTotalMatches>=40
            self.log(f"KF {k}: loop to {cand} rejected ({n_total} total matches)")
            return False, None, None, None
        self.log(
            f"KF {k}: Sim3 to {cand} accepted ({n_opt} optimized inliers, "
            f"{n_total} total matches, scale {float(to_host(opt.scale)):.3f})"
        )
        return True, Scw_corr, matched_cur, loop_mps

    # ------------------------------------------------- projection searches

    def _project_match(
        self,
        mp_ids: np.ndarray,
        A: np.ndarray,
        k_dst: int,
        th: float,
        max_hamming: int,
        check_angle: bool,
        feat_allowed: np.ndarray | None = None,
    ) -> np.ndarray:
        """Project map points through a world->camera transform `A` (rows may
        carry a sim3 scale) into KF `k_dst` and match each to its best feature
        within radius th*scale^predicted_level, levels [pred-1, pred].

        The shared core of ORBmatcher::SearchByProjection(KF, Scw, ...)
        (ORBmatcher.cc:318), Fuse(KF, Scw, ...) (:1010) and each direction of
        SearchBySim3 (:1135) — same gates: positive depth, in-image,
        scale-invariance distance window, optional viewing-angle >= 0.5.
        Returns [len(mp_ids)] best feature index in k_dst or -1.
        """
        m = self.map
        cam = self.cfg.camera
        sf = self.cfg.orb.scale_factor
        n_lv = self.cfg.orb.n_levels
        out = np.full(len(mp_ids), -1, np.int64)
        if len(mp_ids) == 0:
            return out
        pts = m.mp_pos[mp_ids]
        pc = pts @ A[:3, :3].T + A[:3, 3]
        z = pc[:, 2]
        zs = np.where(np.abs(z) > 1e-9, z, 1e-9)
        u = cam.K[0, 0] * pc[:, 0] / zs + cam.K[0, 2]
        v = cam.K[1, 1] * pc[:, 1] / zs + cam.K[1, 2]
        dist3d = np.linalg.norm(pc, axis=-1)
        # 0.8/1.2 margins = MapPoint::Get{Min,Max}DistanceInvariance
        ok = (
            (z > 0)
            & (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
            & (dist3d >= 0.8 * m.mp_min_dist[mp_ids])
            & (dist3d <= 1.2 * m.mp_max_dist[mp_ids])
        )
        if check_angle:
            s = float(np.linalg.norm(A[:3, 0]))
            Ow = -(A[:3, :3].T / (s * s)) @ A[:3, 3]  # camera center of A
            po = pts - Ow
            pod = np.linalg.norm(po, axis=-1)
            cosv = (po * m.mp_normal[mp_ids]).sum(-1) / np.maximum(pod, 1e-9)
            ok &= cosv >= 0.5
        rows = np.nonzero(ok)[0]
        if len(rows) == 0:
            return out
        # PredictScale (MapPoint.cc:397); ratio clamped so points without
        # scale stats (max_dist = inf) land on the coarsest level, not UB
        ratio = np.clip(
            m.mp_max_dist[mp_ids[rows]] / np.maximum(dist3d[rows], 1e-9),
            1.0, float(sf) ** n_lv,
        )
        pred = np.clip(
            np.ceil(np.log(ratio) / np.log(sf)).astype(np.int32), 0, n_lv - 1
        )
        radius = th * sf ** pred.astype(np.float32)
        proj = np.stack([u[rows], v[rows]], -1).astype(np.float32)
        nb = bucket(len(rows))
        # spatial + exact [pred-1, pred] level window (ORBmatcher.cc:409)
        xy_dst = m.kf_feat_xy[k_dst]
        oct_dst = m.kf_feat_octave[k_dst]
        diff = np.abs(pad_rows(proj, nb)[:, None, :] - xy_dst[None, :, :])
        r = pad_rows(radius, nb)[:, None]
        pl = pad_rows(pred, nb)[:, None]
        sm = (
            (diff[..., 0] < r) & (diff[..., 1] < r)
            & (oct_dst[None, :] >= pl - 1) & (oct_dst[None, :] <= pl)
        )
        valid_dst = m.kf_feat_valid[k_dst]
        if feat_allowed is not None:
            valid_dst = valid_dst & feat_allowed
        idx, _ = matching.match_descriptors(
            self._up(pad_rows(m.mp_desc[mp_ids[rows]], nb)),
            self._up(row_mask(len(rows), nb)),
            self._up(m.kf_feat_desc[k_dst]),
            self._up(valid_dst),
            spatial_mask=self._up(sm),
            max_dist=max_hamming,
            apply_ratio=False,
        )
        out[rows] = to_host(idx)[: len(rows)]
        return out

    def _search_by_sim3(
        self, k: int, cand: int, S12: np.ndarray, f1_known: np.ndarray,
        f2_known: np.ndarray, th: float = 7.5,
    ) -> tuple[np.ndarray, np.ndarray]:
        """SearchBySim3 (ORBmatcher.cc:1135): two-way guided projection search
        for NEW feature<->feature matches between the two KFs' map points with
        the RANSAC sim3; only mutual agreements are kept (:1306-1317).

        Returns (new_f1, new_f2) feature-index pairs not already in
        (f1_known, f2_known)."""
        m = self.map
        T1, T2 = m.kf_Tcw[k], m.kf_Tcw[cand]
        S21 = np.linalg.inv(S12)
        # world->cam2 (through cam1 and S21) and world->cam1 (through cam2 and
        # S12); scale stays in the transform like the reference's sR21/sR12
        A_1to2 = (S21 @ T1).astype(np.float32)
        A_2to1 = (S12 @ T2).astype(np.float32)

        feats1 = np.nonzero(m.kf_mp_idx[k] >= 0)[0]
        feats2 = np.nonzero(m.kf_mp_idx[cand] >= 0)[0]
        feats1 = feats1[~np.isin(feats1, f1_known)]
        feats2 = feats2[~np.isin(feats2, f2_known)]
        if len(feats1) == 0 or len(feats2) == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        mps1 = m.kf_mp_idx[k, feats1].astype(np.int64)
        mps2 = m.kf_mp_idx[cand, feats2].astype(np.int64)
        match1 = self._project_match(
            mps1, A_1to2, cand, th, matching.TH_HIGH, check_angle=False,
        )  # feature idx in cand per feats1 row
        match2 = self._project_match(
            mps2, A_2to1, k, th, matching.TH_HIGH, check_angle=False,
        )
        # mutual agreement: match1[a] == feats2[b] and match2[b] == feats1[a]
        by_feat2 = np.full(m.kf_mp_idx.shape[1], -1, np.int64)
        by_feat2[feats2] = match2
        got = match1 >= 0
        agree = got & (by_feat2[np.maximum(match1, 0)] == feats1)
        return feats1[agree], match1[agree]

    # ---------------------------------------------------------- correction

    def _correct_loop(
        self, k: int, cand: int, Scw_corr: np.ndarray,
        matched_cur: np.ndarray | None = None, loop_mps: np.ndarray | None = None,
    ):
        """CorrectLoop (LoopClosing.cc:410-593)."""
        m = self.map
        parts = self._rec.setdefault("correct_ms", {})
        t = time.perf_counter()
        self.log(f"KF {k}: closing loop with {cand}")
        neighbors = [k] + [int(x) for x in m.covisible_keyframes(k)]
        T_k_old = m.kf_Tcw[k].copy()
        T_k_old_inv = np.linalg.inv(T_k_old)

        corrected: dict[int, np.ndarray] = {}
        moved_points: set[int] = set()
        for kn in neighbors:
            T_n_old = m.kf_Tcw[kn].copy()
            rel = T_n_old @ T_k_old_inv  # n <- k (SE3)
            S_n_corr = rel @ Scw_corr  # sim3 corrected pose of neighbor
            corrected[kn] = S_n_corr.astype(np.float32)
        # re-map the neighborhood's points through the correction (vectorized:
        # one camera transform + one Sim3 inverse per keyframe, not per point)
        for kn in neighbors:
            S_n_corr = corrected[kn]
            T_n_old = m.kf_Tcw[kn]
            ps = np.unique(m.kf_mp_idx[kn])
            ps = ps[(ps >= 0) & m.mp_valid[np.maximum(ps, 0)]]
            ps = np.array([p for p in ps if p not in moved_points], np.int64)
            if len(ps) == 0:
                continue
            moved_points.update(int(p) for p in ps)
            pc = m.mp_pos[ps] @ T_n_old[:3, :3].T + T_n_old[:3, 3]  # [n, 3]
            sR = S_n_corr[:3, :3]
            s2 = float(sR[:, 0] @ sR[:, 0])  # scale^2; S_inv = (R^T/s^2 | -R^T t / s^2)
            m.mp_pos[ps] = (pc - S_n_corr[:3, 3]) @ sR / s2
            # write the corrected pose back as SE3 (normalize scale into
            # translation, like the reference's eigt /= s conversion :517)
            m.kf_Tcw[kn] = _sim3_to_se3(S_n_corr)

        parts["propagation"] = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        # loop fusion: bind/replace the current KF's features matched to loop
        # points during ComputeSim3 (LoopClosing.cc:528-547)
        if matched_cur is not None:
            for f in np.nonzero(matched_cur >= 0)[0]:
                lp = int(matched_cur[f])
                if not m.mp_valid[lp]:
                    continue
                cur = int(m.kf_mp_idx[k, f])
                if cur >= 0 and m.mp_valid[cur] and cur != lp:
                    m.replace_map_point(cur, lp)  # pCurMP->Replace(pLoopMP)
                elif cur < 0:
                    m.add_observation(k, int(f), lp)
                    m.update_point_stats(
                        lp, self.cfg.camera.K, self.cfg.orb.scale_factor,
                        self.cfg.orb.n_levels,
                    )

        parts["loop_fusion"] = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        # SearchAndFuse: project the loop map points into EVERY corrected
        # neighbor with the Scw Fuse variant, replacing duplicates
        # (LoopClosing.cc:550, :595-627; ORBmatcher.cc:1010, th=4)
        if loop_mps is not None and len(loop_mps):
            self._search_and_fuse(corrected, loop_mps)
        elif self.local_mapper is not None:
            self.local_mapper._fuse_into(cand, k)
            self.local_mapper._fuse_into(k, cand)

        parts["search_and_fuse"] = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        # essential-graph optimization
        S_loop = (m.kf_Tcw[k] @ np.linalg.inv(m.kf_Tcw[cand])).astype(np.float32)
        self.loop_edges.append((cand, k, S_loop))
        self._optimize_essential_graph(fixed_kf=cand)
        parts["essential_graph"] = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()

        # global BA with NMI anchors (reference spawns a thread,
        # LoopClosing.cc:587; the async pipeline runs it abortable)
        self._run_global_ba()
        parts["global_ba_launch"] = (time.perf_counter() - t) * 1e3
        self.last_loop_kf = k

    def _run_global_ba(self):
        """RunGlobalBundleAdjustment (LoopClosing.cc:652): on the async
        pipeline, spawned on its own abortable thread; inline otherwise."""
        if self.gba_launcher is not None:
            self.gba_launcher(iters=10)
        elif self.local_mapper is not None:
            self.local_mapper.global_ba(iters=10)

    def _search_and_fuse(self, corrected: dict[int, np.ndarray], loop_mps: np.ndarray):
        """LoopClosing::SearchAndFuse (:595-627): Scw-projection Fuse of the
        loop-side map points into each corrected keyframe; an existing point
        at the matched feature is REPLACED by the loop point."""
        m = self.map
        n_fused = 0
        for kn, S_n in corrected.items():
            mps = loop_mps[m.mp_valid[loop_mps]]
            if len(mps) == 0:
                continue
            best = self._project_match(
                mps, _sim3_to_se3(S_n), kn, th=4.0,
                max_hamming=matching.TH_LOW, check_angle=True,
            )
            for i in np.nonzero(best >= 0)[0]:
                lp = int(mps[i])
                f = int(best[i])
                if not m.mp_valid[lp]:
                    continue
                existing = int(m.kf_mp_idx[kn, f])
                if existing >= 0 and m.mp_valid[existing]:
                    if existing != lp:
                        m.replace_map_point(existing, lp)  # pRep->Replace(loopMP)
                        n_fused += 1
                else:
                    m.add_observation(kn, f, lp)
                    m.update_point_stats(
                        lp, self.cfg.camera.K, self.cfg.orb.scale_factor,
                        self.cfg.orb.n_levels,
                    )
                    n_fused += 1
        self.log(f"SearchAndFuse: {n_fused} loop-point fusions across {len(corrected)} KFs")

    def _optimize_essential_graph(self, fixed_kf: int):
        """OptimizeEssentialGraph (Optimizer.cc:798): spanning tree + loop
        edges + strong covisibility (>=100) edges over Sim3 poses."""
        m = self.map
        kfs = [int(x) for x in m.valid_keyframe_indices()]
        if len(kfs) < 3:
            return
        pos = {kf: i for i, kf in enumerate(kfs)}
        V = len(kfs)
        edges_i, edges_j, meas = [], [], []

        def add_edge(i, j, S_ji=None):
            if i not in pos or j not in pos:
                return
            if S_ji is None:
                S_ji = (m.kf_Tcw[j] @ np.linalg.inv(m.kf_Tcw[i])).astype(np.float32)
            edges_i.append(pos[i])
            edges_j.append(pos[j])
            meas.append(S_ji)

        for kf in kfs:
            parent = int(m.kf_parent[kf])
            if parent >= 0 and m.kf_valid[parent]:
                add_edge(parent, kf)
            for kc in m.covisible_keyframes(kf, min_weight=100):
                if int(kc) > kf:
                    add_edge(kf, int(kc))
        for i, j, S in self.loop_edges:
            if m.kf_valid[i] and m.kf_valid[j]:
                add_edge(i, j, S)
        if not edges_i:
            return

        fixed = np.zeros(V, bool)
        fixed[pos[fixed_kf]] = True
        # NMI-anchored keyframes stay fixed in the pose graph too: they are
        # the georeference (FORK semantics carried into graph optimization)
        for kf in kfs:
            if m.kf_nmi_reloc[kf]:
                fixed[pos[kf]] = True

        host = dict(Scw=m.kf_Tcw[kfs].astype(np.float32), fixed=fixed, valid=np.ones(V, bool),
                    edge_i=np.asarray(edges_i, np.int32), edge_j=np.asarray(edges_j, np.int32),
                    edge_Sji=np.stack(meas).astype(np.float32),
                    edge_valid=np.ones(len(meas), bool))
        self.last_pose_graph = host
        prob = pose_graph.PoseGraphProblem(**{f: self._up(a) for f, a in host.items()})
        out = to_host(pose_graph.optimize_pose_graph(prob, iters=20))
        # per-KF world correction corr = inv(T_new) @ T_old (identity for
        # fixed vertices), applied to poses first
        C = np.tile(np.eye(4, dtype=np.float32), (m.kf_valid.shape[0], 1, 1))
        for kf in kfs:
            i = pos[kf]
            if fixed[i]:
                continue
            T_old = m.kf_Tcw[kf].copy()
            T_new = _sim3_to_se3(out[i])
            C[kf] = np.linalg.inv(T_new) @ T_old
            m.kf_Tcw[kf] = T_new
        # correct EVERY map point through its reference keyframe's correction
        # (Optimizer.cc:963-995: each MP moves with its reference KF, falling
        # back to any valid observer when the first observer is gone)
        pts = m.valid_point_indices()
        if len(pts):
            ref = m.mp_first_kf[pts].astype(np.int64)
            bad_ref = (ref < 0) | ~m.kf_valid[np.maximum(ref, 0)]
            if bad_ref.any():
                # fall back to the first valid observer in the table
                obs = m.mp_obs_kf[pts[bad_ref]]  # [n, M]
                ok = (obs >= 0) & m.kf_valid[np.maximum(obs, 0)]
                first = np.argmax(ok, axis=1)
                has = ok[np.arange(len(first)), first]
                fb = np.where(has, obs[np.arange(len(first)), first], -1)
                ref[bad_ref] = fb
            keep = ref >= 0
            pts, ref = pts[keep], ref[keep]
            ph = np.concatenate([m.mp_pos[pts], np.ones((len(pts), 1), np.float32)], 1)
            m.mp_pos[pts] = np.einsum("nij,nj->ni", C[ref], ph)[:, :3]
        self.log(f"essential graph optimized over {V} KFs, {len(meas)} edges")
