"""The per-frame tracking step on the device: extraction to final pose.

Port of `orbslam2_nmi_tpu/slam/fused_track.py`. One call of `FusedTrackStep`
runs the per-frame hot path of Tracking::Track (src/Tracking.cc:356-692):
ORB extraction, motion-model matching, pose-only Gauss-Newton, local-map
matching and a second pose GN, and packs every result the host needs into
one float32 buffer, so a frame costs one readback. Its carry (last pose,
velocity, last frame's features and bound landmark positions) stays on the
device across frames.

The JAX package compiles the step into one XLA program. Here it is torch ops
with static shapes that never read a value back between the frame upload
and the readback of `packed` (no `.item()`, `bool()`, `.cpu()`, boolean
indexing or error-checking inverse), so it can be captured in a CUDA graph:
on CUDA, the first call captures the step and every call replays it (7.6-8.8x
faster than eager on an H100, PERF.md); a capture that fails raises. On the
CPU, and for stage timing, `run_eager` runs the same stages. A replay and an
eager run launch the same kernels on the same inputs and give the same
`packed` bit for bit.

Where the port differs, or is likely to trip:

* `jnp.linalg.inv(carry.Tcw)` becomes `torch.linalg.inv_ex`, which does not
  wait on the device for its error check as `torch.linalg.inv` would (the
  pose GN's Cholesky likewise, `solvers/pose_gn.py`). It must be the general
  inverse: the pose's rotation drifts from orthonormal by float32 rounding
  at every update, and a rigid inverse [R^T, -R^T t] then feeds a scale
  error into the velocity that compounds frame over frame (measured: the
  chain diverged after ~12 frames, where the JAX step's stayed within 2 cm).
* The pose math is in plain float32 whatever the TF32 flags
  (`geometry/se3.mm`), as the JAX package pins `Precision.HIGHEST`.
* `_scatter_rows`' mode="drop" becomes a sentinel row `n_feat` that is
  sliced off. The indices are one-to-one (the mutual check of the matcher),
  so `index_put_` has no duplicates to race on except the sentinel's.
* Descriptors are int32 bit patterns on the device (`ops/orb.py`), so the
  packed buffer, bitcast to float32, holds the same bytes as the JAX
  package's: `unpack_step` is a copy of the JAX package's, byte for byte.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from orbslam2_nmi_torch import kernels
from orbslam2_nmi_torch.config import SystemConfig
from orbslam2_nmi_torch.geometry import se3
from orbslam2_nmi_torch.ops import matching
from orbslam2_nmi_torch.ops.orb import Features, extract_orb
from orbslam2_nmi_torch.slam.frame import FrameData
from orbslam2_nmi_torch.solvers import pose_gn


class TrackCarry(NamedTuple):
    """Device-resident inter-frame state (the `mLastFrame` and velocity of
    Tracking.cc, never read back on the critical path)."""

    Tcw: torch.Tensor  # [4, 4] last frame's pose
    velocity: torch.Tensor  # [4, 4] Tcw_cur @ inv(Tcw_last)
    xy: torch.Tensor  # [N, 2] last frame's keypoints
    octave: torch.Tensor  # [N] int32
    angle: torch.Tensor  # [N] f32
    desc: torch.Tensor  # [N, 8] int32 bit patterns of the uint32 words
    pts: torch.Tensor  # [N, 3] world position of the landmark bound to each kp
    bound: torch.Tensor  # [N] bool: kp has an (inlier) landmark


class StepOutputs(NamedTuple):
    carry: TrackCarry
    packed: torch.Tensor  # [P] f32, see unpack_step


class MotionMatch(NamedTuple):
    Tp: torch.Tensor  # [4, 4] predicted pose, velocity @ Tcw_last
    idx: torch.Tensor  # [N] carry row -> feature row or -1
    pts: torch.Tensor  # [N, 3] landmark of each feature row
    bound: torch.Tensor  # [N] bool
    src: torch.Tensor  # [N] int32 feature row -> carry row or -1


class LocalMatch(NamedTuple):
    in_view: torch.Tensor  # [C] bool candidate passes the frustum gates
    idx: torch.Tensor  # [C] candidate -> feature row or -1
    pts: torch.Tensor  # [N, 3]
    bound: torch.Tensor  # [N] bool
    src: torch.Tensor  # [N] int32 feature row -> candidate or -1


def _scatter_rows(idx_src_to_feat, values, n_feat, fill=0.0):
    """values [M, ...] scattered to feature rows; idx -1 goes to a sentinel
    row that is dropped."""
    safe = torch.where(idx_src_to_feat >= 0, idx_src_to_feat, n_feat).long()
    base = torch.full((n_feat + 1,) + tuple(values.shape[1:]), fill, dtype=values.dtype,
                      device=values.device)
    base[safe] = values
    return base[:n_feat]


def _as_f32(a: torch.Tensor) -> torch.Tensor:
    """Bitcast for transport: the int32 value's bytes as a float32."""
    return a.to(torch.int32).view(torch.float32)


class FusedTrackStep:
    """The per-frame step on one device.

    step(gray_u8 [H, W], carry, cand_pts [C, 3], cand_desc [C, 8] int32,
         cand_min_d [C], cand_max_d [C], cand_normal [C, 3], cand_valid [C])
      -> StepOutputs

    The candidates are the local-map set (host-provided, padded to C =
    n_cand). `extract`, `motion_match`, `pose`, `local_match` and `finish`
    are the step's stages, callable alone for timing; `run_eager` runs them
    in order. Runs on CUDA unless `device="cpu"`.
    """

    def __init__(self, cfg: SystemConfig, n_cand: int = 2048, device="cuda"):
        self.device = kernels.resolve_device(device, "FusedTrackStep")
        self.cfg = cfg
        self.n_cand = n_cand
        self.n_feat = int(sum(cfg.orb.features_per_level()))
        K = cfg.camera.K
        self.K = K
        self.fx, self.fy, self.cx, self.cy = (float(K[0, 0]), float(K[1, 1]), float(K[0, 2]),
                                              float(K[1, 2]))
        self.sf = float(cfg.orb.scale_factor)
        self.n_levels = cfg.orb.n_levels
        tab = (1.0 / (self.sf ** np.arange(self.n_levels)) ** 2).astype(np.float32)
        self.inv_sigma2_tab = torch.from_numpy(tab).to(self.device)
        self._graph = None
        self._static_in = None
        self._static_out = None

    # ------------------------------------------------------------- stages

    def _project(self, Tcw, pts):
        pc = se3.mv(Tcw[:3, :3], pts) + Tcw[:3, 3]
        z = torch.where(torch.abs(pc[:, 2]) > 1e-9, pc[:, 2], 1e-9)
        uv = torch.stack([self.fx * pc[:, 0] / z + self.cx, self.fy * pc[:, 1] / z + self.cy], -1)
        return uv, pc[:, 2]

    def extract(self, gray_u8: torch.Tensor) -> Features:
        return extract_orb(gray_u8, self.cfg.orb)

    def motion_match(self, feats: Features, carry: TrackCarry) -> MotionMatch:
        """Project the last frame's landmarks at the predicted pose and search
        a window of 15 px at their octave's scale (Tracking.cc:1083, :1124)."""
        N = feats.xy.shape[0]
        Tp = se3.mm(carry.velocity, carry.Tcw)
        proj, _ = self._project(Tp, carry.pts)
        radius = 15.0 * self.sf ** carry.octave.to(torch.float32)
        sm = matching.window_mask(proj, feats.xy, torch.where(carry.bound, radius, -1.0),
                                  carry.octave, feats.octave, level_window=1)
        idx, _ = matching.match_descriptors(
            carry.desc, carry.bound, feats.desc, feats.valid, spatial_mask=sm,
            max_dist=matching.TH_HIGH, apply_ratio=False, angle_a=carry.angle,
            angle_b=feats.angle, check_rotation=True,
        )
        n_c = carry.xy.shape[0]
        return MotionMatch(
            Tp=Tp, idx=idx,
            pts=_scatter_rows(idx, carry.pts, N),
            bound=_scatter_rows(idx, torch.ones(n_c, dtype=torch.bool, device=idx.device), N,
                                fill=False),
            src=_scatter_rows(idx, torch.arange(n_c, dtype=torch.int32, device=idx.device), N,
                              fill=-1),
        )

    def pose(self, Tcw0, pts, feats: Features, valid) -> pose_gn.PoseOptResult:
        t = self.cfg.tracking
        return pose_gn.pose_optimization_k(
            self.K, Tcw0, pts, feats.xy, self.inv_sigma2_tab[feats.octave.long()], valid,
            rounds=t.pose_opt_rounds, iters=t.pose_opt_iters)

    def local_match(self, feats: Features, Tcw, bound1, cand_pts, cand_desc, cand_min_d,
                    cand_max_d, cand_normal, cand_valid) -> LocalMatch:
        """TrackLocalMap (Tracking.cc:1172): project the candidates at the
        refined pose, gate by frustum, distance and viewing angle
        (Frame::isInFrustum), search a scale-predicted radius."""
        N = feats.xy.shape[0]
        sf, n_levels = self.sf, self.n_levels
        cproj, cz = self._project(Tcw, cand_pts)
        cam_c = -se3.mv(Tcw[:3, :3].T, Tcw[:3, 3])
        dvec = cand_pts - cam_c
        dist = torch.sqrt(torch.sum(dvec * dvec, dim=-1))
        cosv = torch.sum(dvec / torch.clamp(dist[:, None], min=1e-9) * cand_normal, dim=-1)
        W, H = self.cfg.camera.width, self.cfg.camera.height
        in_view = (
            cand_valid
            & (cz > 0)
            & (cproj[:, 0] >= 0) & (cproj[:, 0] < W)
            & (cproj[:, 1] >= 0) & (cproj[:, 1] < H)
            & (dist >= 0.8 * cand_min_d) & (dist <= 1.2 * cand_max_d)
            & (cosv > 0.5)
        )
        ratio = torch.clamp(cand_max_d / torch.clamp(dist, min=1e-9), 1.0, sf**n_levels)
        pred = torch.clamp(torch.ceil(torch.log(ratio) / math.log(sf)).to(torch.int32), 0,
                           n_levels - 1)
        crad = 4.0 * sf ** pred.to(torch.float32)
        csm = matching.window_mask(cproj, feats.xy, torch.where(in_view, crad, -1.0), pred,
                                   feats.octave, level_window=1)
        free = feats.valid & ~bound1
        idx, _ = matching.match_descriptors(
            cand_desc, in_view, feats.desc, free, spatial_mask=csm,
            max_dist=matching.TH_HIGH, nn_ratio=0.8)
        C = cand_pts.shape[0]
        return LocalMatch(
            in_view=in_view, idx=idx,
            pts=_scatter_rows(idx, cand_pts, N),
            bound=_scatter_rows(idx, torch.ones(C, dtype=torch.bool, device=idx.device), N,
                                fill=False),
            src=_scatter_rows(idx, torch.arange(C, dtype=torch.int32, device=idx.device), N,
                              fill=-1),
        )

    def finish(self, feats: Features, carry: TrackCarry, m1: MotionMatch, r1, m2: LocalMatch,
               r2) -> StepOutputs:
        """The new carry and the packed buffer (wire format of the JAX
        package's `fused_track.py:187-208`)."""
        inlier = r2.inliers & (m1.bound | m2.bound)
        all_pts = torch.where(m1.bound[:, None], m1.pts, m2.pts)
        velocity = se3.mm(r2.Tcw, torch.linalg.inv_ex(carry.Tcw)[0])
        new_carry = TrackCarry(
            Tcw=r2.Tcw, velocity=velocity, xy=feats.xy, octave=feats.octave,
            angle=feats.angle, desc=feats.desc,
            pts=torch.where(inlier[:, None], all_pts, 0.0), bound=inlier,
        )
        counters = torch.stack([
            torch.sum(m1.idx >= 0).to(torch.float32),
            r1.n_inliers.to(torch.float32),
            r2.n_inliers.to(torch.float32),
        ])
        packed = torch.cat([
            r2.Tcw.reshape(-1),  # 16
            velocity.reshape(-1),  # 16
            counters,  # 3
            feats.xy.reshape(-1),  # 2N
            feats.angle,  # N
            _as_f32(feats.octave),  # N
            _as_f32(feats.valid),  # N
            _as_f32(m1.src),  # N
            _as_f32(m2.src),  # N
            _as_f32(inlier),  # N
            _as_f32(r2.inliers & m1.bound),  # N (outlier reconstruction)
            _as_f32(m2.in_view),  # C
            feats.desc.view(torch.float32).reshape(-1),  # 8N
        ])
        return StepOutputs(carry=new_carry, packed=packed)

    def run_eager(self, gray_u8, carry: TrackCarry, cand_pts, cand_desc, cand_min_d,
                  cand_max_d, cand_normal, cand_valid) -> StepOutputs:
        feats = self.extract(gray_u8)
        m1 = self.motion_match(feats, carry)
        r1 = self.pose(m1.Tp, m1.pts, feats, m1.bound & feats.valid)
        m2 = self.local_match(feats, r1.Tcw, m1.bound, cand_pts, cand_desc, cand_min_d,
                              cand_max_d, cand_normal, cand_valid)
        all_bound = m1.bound | m2.bound
        all_pts = torch.where(m1.bound[:, None], m1.pts, m2.pts)
        r2 = self.pose(r1.Tcw, all_pts, feats, all_bound & feats.valid)
        return self.finish(feats, carry, m1, r1, m2, r2)

    # ------------------------------------------------------------- CUDA graph

    def capture(self, *args) -> None:
        """Capture the step in a CUDA graph on static copies of `args` (the
        step's arguments, on this device), after two eager warm-up runs on a
        side stream. Raises what the capture raises."""
        flat = [args[0], *args[1], *args[2:]]
        self._static_in = [a.clone() for a in flat]
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(2):
                self._run_static()
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._static_out = self._run_static()
        self._graph = graph

    def _run_static(self) -> StepOutputs:
        s = self._static_in
        return self.run_eager(s[0], TrackCarry(*s[1:9]), *s[9:])

    def replay(self, gray_u8, carry: TrackCarry, *cand) -> StepOutputs:
        """The captured step on these inputs: copy them into the graph's
        static inputs, replay, and return copies of its static outputs."""
        for dst, src in zip(self._static_in, [gray_u8, *carry, *cand], strict=True):
            dst.copy_(src)
        self._graph.replay()
        out = self._static_out
        return StepOutputs(carry=TrackCarry(*(t.clone() for t in out.carry)),
                           packed=out.packed.clone())

    def __call__(self, gray_u8, carry: TrackCarry, cand_pts, cand_desc, cand_min_d,
                 cand_max_d, cand_normal, cand_valid) -> StepOutputs:
        args = (gray_u8, carry, cand_pts, cand_desc, cand_min_d, cand_max_d, cand_normal,
                cand_valid)
        if self.device.type != "cuda":
            return self.run_eager(*args)
        if self._graph is None:
            self.capture(*args)
        return self.replay(*args)


class UnpackedStep(NamedTuple):
    Tcw: np.ndarray
    velocity: np.ndarray
    n_matches1: int
    n_inliers1: int
    n_inliers: int
    xy: np.ndarray
    angle: np.ndarray
    octave: np.ndarray
    valid: np.ndarray
    src_prev: np.ndarray  # [N] prev-frame feature row or -1
    src_cand: np.ndarray  # [N] candidate row or -1
    inlier: np.ndarray  # [N] bool (final pose-GN inliers among bound)
    inlier_bound1: np.ndarray  # [N] bool
    cand_in_view: np.ndarray  # [C] bool
    desc: np.ndarray  # [N, 8] uint32


def unpack_step(buf: np.ndarray, n_feat: int, n_cand: int) -> UnpackedStep:
    """The packed buffer's fields, on the host (descriptors as uint32)."""
    i = lambda a: a.view(np.int32)  # noqa: E731
    b = lambda a: a.view(np.int32).astype(bool)  # noqa: E731
    o = 0

    def take(n):
        nonlocal o
        out = buf[o : o + n]
        o += n
        return out

    Tcw = take(16).reshape(4, 4).copy()
    vel = take(16).reshape(4, 4).copy()
    counters = take(3)
    xy = take(2 * n_feat).reshape(n_feat, 2).copy()
    angle = take(n_feat).copy()
    octave = i(take(n_feat)).copy()
    valid = b(take(n_feat))
    src_prev = i(take(n_feat)).copy()
    src_cand = i(take(n_feat)).copy()
    inlier = b(take(n_feat))
    inlier_b1 = b(take(n_feat))
    cand_in_view = b(take(n_cand))
    desc = take(8 * n_feat).view(np.uint32).reshape(n_feat, 8).copy()
    if o != len(buf):
        raise ValueError(f"packed buffer has {len(buf)} floats, the layout {o}")
    return UnpackedStep(
        Tcw=Tcw, velocity=vel,
        n_matches1=int(counters[0]), n_inliers1=int(counters[1]),
        n_inliers=int(counters[2]),
        xy=xy, angle=angle, octave=octave, valid=valid,
        src_prev=src_prev, src_cand=src_cand, inlier=inlier,
        inlier_bound1=inlier_b1, cand_in_view=cand_in_view, desc=desc,
    )


def carry_from_frame(frame: FrameData, map_store, velocity: Optional[np.ndarray],
                     device="cuda") -> TrackCarry:
    """Seed the device carry from a host-tracked frame (after init, reloc, or
    a keyframe/map event that invalidates the device chain). `map_store` is
    any object with an `mp_pos` [P, 3] array."""
    n = len(frame.xy)
    bound = (frame.mp_idx >= 0) & ~frame.outlier
    pts = np.zeros((n, 3), np.float32)
    if bound.any():
        pts[bound] = map_store.mp_pos[frame.mp_idx[bound]]
    vel = np.eye(4, dtype=np.float32) if velocity is None else velocity
    dev = torch.device(device)

    def up(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a if dtype is None else a.astype(dtype))
                                ).to(dev)

    return TrackCarry(
        Tcw=up(frame.Tcw, np.float32), velocity=up(vel, np.float32),
        xy=up(frame.xy, np.float32), octave=up(frame.octave, np.int32),
        angle=up(frame.angle, np.float32),
        desc=up(np.asarray(frame.desc, np.uint32).view(np.int32)),
        pts=up(pts), bound=up(bound),
    )
