"""Per-frame container (host-side): features + pose + map-point bindings.

A numpy copy of `orbslam2_nmi_tpu/slam/frame.py`, kept in this package so
that the port imports nothing of the JAX package. It replaces the
reference's Frame (src/Frame.cc): keypoints, descriptors (uint32 words, as
the JAX package keeps them), the 64x48 grid index (unneeded: matching uses
dense windowed masks on the device), pose, and the NMI status flags
(Frame.h:85-89 FORK fields).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class FrameData:
    frame_id: int
    timestamp: float
    Tcw: np.ndarray | None  # [4, 4] or None if not yet posed
    xy: np.ndarray  # [N, 2] undistorted level-0 pixels
    xy_raw: np.ndarray  # [N, 2] raw (distorted) pixels
    octave: np.ndarray  # [N]
    angle: np.ndarray  # [N] radians
    desc: np.ndarray  # [N, 8] uint32
    valid: np.ndarray  # [N] bool
    mp_idx: np.ndarray = field(default=None)  # [N] -> map point or -1
    outlier: np.ndarray = field(default=None)  # [N] bool
    nmi_relocalized: bool = False
    nmi_failed: bool = False
    previous_poses: list = field(default_factory=list)  # Twc history (NMI parity)
    # relative-pose bookkeeping (Tracking.cc:667-691): pose vs reference KF,
    # recomposed at save time so post-hoc optimization reaches the trajectory
    ref_kf: int = -1
    Tcr: np.ndarray | None = None  # Tcw @ inv(kf_Tcw[ref_kf])

    def __post_init__(self):
        n = len(self.xy)
        if self.mp_idx is None:
            self.mp_idx = np.full(n, -1, np.int32)
        if self.outlier is None:
            self.outlier = np.zeros(n, bool)

    @property
    def n(self) -> int:
        return len(self.xy)

    def n_matched(self) -> int:
        return int(((self.mp_idx >= 0) & ~self.outlier).sum())
