"""NMI initialization: the map's first two keyframes, anchored by NMI.

The first-run branch of the JAX package's `Tracker._initialize`
(`orbslam2_nmi_tpu/slam/tracking.py:245-383`, InitializeWithNMI,
Tracking.cc:2181-2372), without re-initialization and without the classic
two-view fallback. Two frames `offset` apart are latched to the prior model
by NMI (`initializing=True`), their features matched (TH_LOW, ratio 0.9,
rotation check), the matches triangulated and gated, and the two keyframes,
both flagged NMI-relocalized, hold the new map points; a global BA of 20
iterations with both keyframes fixed follows. The map's scale is then metric
and its frame the model's (SURVEY §3.4).

`create_initial_map` is the map-building half on frames already posed:
`Tracker._initialize` (`slam/tracking.py`) latches each frame itself,
through its own NMI bookkeeping, and calls it; `nmi_initialize` latches and
then calls it (`entry.mapping_entry`'s sessions).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from orbslam2_nmi_torch.ops import matching, triangulate
from orbslam2_nmi_torch.slam.frame import FrameData
from orbslam2_nmi_torch.utils.bucketing import bucket, pad_rows, row_mask
from orbslam2_nmi_torch.utils.readback import to_host

MIN_MATCHES = 20  # tracking.py:327
MIN_POINTS = 15  # tracking.py:345


class InitResult(NamedTuple):
    ok: bool  # the map was created
    n_matches: int
    n_points: int  # triangulated points that passed the gates
    k1: int  # keyframe ids (-1 when not created)
    k2: int
    latches: list  # NMIOutcome of each latch (empty without a localizer)


def nmi_latch(localizer, frame: FrameData, gray: torch.Tensor):
    """Latch `frame` (posed at its seed) to the prior model by NMI
    (`Tracker._run_nmi(frame, initializing=True)`, tracking.py:1071-1106):
    the frame takes the search's pose and its flags. Returns the outcome."""
    out = localizer.relocalize_strategy(gray.to(torch.float32), frame.Tcw, initializing=True)
    frame.previous_poses.extend(out.previous_poses)
    frame.Tcw = out.Tcw
    frame.nmi_relocalized = out.relocalized
    frame.nmi_failed = out.failed
    return out


def nmi_initialize(cfg, map_store, local_mapper, f1: FrameData, f2: FrameData,
                   localizer=None, gray1: Optional[torch.Tensor] = None,
                   gray2: Optional[torch.Tensor] = None, log_fn=None) -> InitResult:
    """Initialize the map from frames f1 and f2 (f2 `cfg.nmi.offset` frames
    later), each posed at its seed pose (`Tcw`).

    With a `localizer`, each frame is first latched by NMI against its gray
    image; without one the seed poses stand, and the second keyframe is
    flagged NMI-relocalized as the JAX tracker flags it when it has no
    localizer. Then `create_initial_map`.
    """
    latches = []
    if localizer is not None:
        latches = [nmi_latch(localizer, f1, gray1), nmi_latch(localizer, f2, gray2)]
    res = create_initial_map(cfg, map_store, local_mapper, f1, f2,
                             k2_anchored=f2.nmi_relocalized or localizer is None, log_fn=log_fn)
    return res._replace(latches=latches)


def create_initial_map(cfg, map_store, local_mapper, f1: FrameData, f2: FrameData,
                       k2_anchored: bool, log_fn=None, device=None) -> InitResult:
    """The map's first two keyframes from f1 and f2 at their poses
    (tracking.py:312-383): their features matched (TH_LOW, ratio 0.9,
    rotation check), the matches triangulated and gated, both keyframes
    added (the first flagged NMI-relocalized, the second if `k2_anchored`)
    with the new points, then a global BA of 20 iterations when there is a
    `local_mapper` (on whose device the solves run, else on `device`). On
    success f2's `mp_idx` binds the new points and its pose is its
    keyframe's after the BA. On the JAX package's aborts (fewer than 20
    matches or 15 triangulated points) the map is left untouched."""
    log = log_fn or (lambda s: None)
    dev = local_mapper.device if local_mapper is not None else torch.device(device)

    def up(a, dtype=None):
        a = np.ascontiguousarray(a if dtype is None else a.astype(dtype))
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(a).to(dev)

    idx, _ = matching.match_descriptors(
        up(f1.desc), up(f1.valid), up(f2.desc), up(f2.valid),
        max_dist=matching.TH_LOW, nn_ratio=0.9,
        angle_a=up(f1.angle, np.float32), angle_b=up(f2.angle, np.float32),
        check_rotation=True,
    )
    idx = to_host(idx)
    m1 = np.nonzero(idx >= 0)[0]
    m2 = idx[m1]
    if len(m1) < MIN_MATCHES:
        log(f"init: only {len(m1)} matches, retrying with next frame pair")
        return InitResult(False, len(m1), 0, -1, -1, [])

    n_lv, sf = cfg.orb.n_levels, cfg.orb.scale_factor
    inv_sigma2 = (1.0 / (sf ** np.arange(n_lv)) ** 2).astype(np.float32)
    nb = bucket(len(m1))
    tri = triangulate.triangulate_and_gate(
        up(cfg.camera.K, np.float32), up(f1.Tcw, np.float32), up(f2.Tcw, np.float32),
        up(pad_rows(f1.xy[m1], nb), np.float32), up(pad_rows(f2.xy[m2], nb), np.float32),
        up(pad_rows(inv_sigma2[f1.octave[m1]], nb, 1.0)),
        up(pad_rows(inv_sigma2[f2.octave[m2]], nb, 1.0)),
        up(row_mask(len(m1), nb)),
    )
    ok = to_host(tri.valid)[: len(m1)]
    pts = to_host(tri.points_w)[: len(m1)]
    if ok.sum() < MIN_POINTS:
        log(f"init: only {int(ok.sum())} triangulated, aborting this pair")
        return InitResult(False, len(m1), int(ok.sum()), -1, -1, [])

    # the two NMI-anchored keyframes + map points
    m = map_store
    with m.lock:
        k1 = m.add_keyframe(f1.Tcw, f1.frame_id, f1.timestamp, f1.xy, f1.octave, f1.angle,
                            f1.desc, f1.valid, nmi_relocalized=True)
        k2 = m.add_keyframe(f2.Tcw, f2.frame_id, f2.timestamp, f2.xy, f2.octave, f2.angle,
                            f2.desc, f2.valid, nmi_relocalized=bool(k2_anchored))
        for i in np.nonzero(ok)[0]:
            fa, fb = int(m1[i]), int(m2[i])
            p = m.add_map_point(pts[i], f1.desc[fa], k1, np.zeros(3, np.float32))
            m.add_observation(k1, fa, p)
            m.add_observation(k2, fb, p)
            m.update_point_stats(p, cfg.camera.K, cfg.orb.scale_factor, cfg.orb.n_levels)
            f2.mp_idx[fb] = p

    # global BA on the initial map (20 iterations, both KFs fixed by the flag)
    if local_mapper is not None:
        local_mapper.global_ba(iters=20)
        f2.Tcw = m.kf_Tcw[k2].copy()
    log(f"NMI initialization: {int(ok.sum())} map points from frames "
        f"{f1.frame_id}/{f2.frame_id}")
    return InitResult(True, len(m1), int(ok.sum()), k1, k2, [])
