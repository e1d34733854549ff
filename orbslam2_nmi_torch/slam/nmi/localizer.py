"""NMI absolute localization against the prior 3-D model.

Port of `orbslam2_nmi_tpu/slam/nmi/localizer.py`: NmiObjects
(Thirdparty/Localization/localization.cpp:82-254) + the Tracking-side control
flow RelocalizeWithNMI / RelocalizeWithNMIStrategy / CalculateNMIRelocalization
(reference: src/Tracking.cc:1851-2179, :2374-2419). Each sweep evaluates the
whole 6-D grid in three device stages and one [S, R] readback:

    1. render the model at all translation candidates  (kernel B3 + the
       sampler for a mesh, the point splat for a pointcloud)
    2. warp the camera frame by all rotation hypotheses (torch ops)
    3. score all (render x warp) pairs                  (kernels B1 and B2)

The coarse-to-fine schedule, gain/middle termination, pose revert and
adaptive accept threshold run on the host as in the reference.

Where it differs from the JAX localizer, on purpose:
  * **Device.** It takes an explicit `device` (default "cuda") and raises
    when CUDA is asked for and absent, as `entry()` does; nothing falls back
    to the CPU. `relocalize_strategy` takes the frame as a tensor on that
    device and `Tcw` as a host float32 array; the state machine stays on the
    host, and each grid evaluation reads back its [S, R] scores once.
  * **No silent renderer swap.** The JAX localizer replaces a mesh by its
    point splat whenever it is not on a TPU (its :103-110). Here a mesh
    always goes through `raster.bin_mesh` (once per `evaluate_grid`, with the
    margin of the grid's largest offset per axis) and `raster.render_mesh_grid`
    (`render_gray`, kernel B3 with the sampler fused, on the card, its plain
    version on the CPU), so there is no `force_mesh_raster`. On the card the
    binning is kernels `bin_count` and `bin_fill`, which read the mesh's
    arrays resident on the device: the constructor uploads them once (set-up
    counter `nmi.mesh_upload`), so a sweep uploads nothing of the mesh. On
    the CPU it is the host's numpy binning. A point model (render mode 4)
    goes through `render.render_translation_grid`; on the card the
    constructor places it on the device (set-up counter `nmi.cloud_upload`).
  * **One byte a level.** `cfg.n_bins` goes to `nmi_scores`, which packs
    the gray levels in one byte: more than 256 bins score as 256, which is
    the reference's result on frames and renders in [0, 255].

Tracing (`utils/profiling`): a relocalization runs inside `nmi.relocalize`,
each sweep inside `nmi.sweep`, and the readback of its scores inside
`nmi.readback`. Both readbacks of a sweep (the binning's four ints and the
scores) go through `utils/readback.to_host`, whose wait releases the
interpreter lock: on the async NMI worker they wait behind the tracking
thread's queued step on the shared stream, and the tracking thread runs on
meanwhile.

Sign conventions: translation candidates move the camera center along its own
axes, offset_cam = (i - (n-1)/2) * step per axis (x right, y down, z forward);
rotation candidates compose camera-frame R = Rz Ry Rx on the right of Twc.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from orbslam2_nmi_torch import kernels
from orbslam2_nmi_torch.config import CameraConfig, NMIConfig
from orbslam2_nmi_torch.geometry import se3
from orbslam2_nmi_torch.io.model_loader import MeshModel
from orbslam2_nmi_torch.ops import histogram_nmi, homography, raster, render
from orbslam2_nmi_torch.slam.nmi import search_kernel as sk
from orbslam2_nmi_torch.utils import profiling
from orbslam2_nmi_torch.utils.profiling import labelled, span
from orbslam2_nmi_torch.utils.readback import to_host

_READBACK = span("nmi.readback")


@dataclass
class NMIOutcome:
    Tcw: np.ndarray  # final pose (possibly reverted)
    nmi: float  # best NMI score of the last evaluated kernel
    relocalized: bool
    failed: bool
    iterations: int
    previous_poses: list  # Twc before each iteration (mvPreviousPoses parity)
    # per-axis grid sizes of the kernel at exit — the Track() drift reset only
    # clears axes the kernel actually searched (num > 1), Tracking.cc:600-612
    num_synth: tuple = (3, 3, 3)
    num_warp: tuple = (3, 3, 3)


@dataclass
class Sweep:
    """One grid evaluation's inputs on the device, shared by its stages."""

    frame: torch.Tensor  # [h, w] f32, box-pooled at scale > 1
    K: np.ndarray  # host f32 intrinsics at this scale
    Tcw: torch.Tensor  # [4, 4] f32, the grid's center pose
    offsets: torch.Tensor  # [S, 3] camera-frame translation candidates
    angles: np.ndarray  # [R, 3] host rotation hypotheses
    height: int
    width: int
    point_size: int  # splat size at this scale (point model only)
    binned: Optional[raster.BinnedMesh]  # the mesh's binning, None for a point model


def _box_pool(img: torch.Tensor, scale: int) -> torch.Tensor:
    """[H, W] -> [H//s, W//s] average pooling (exact box filter). Each
    window is summed row by row and the sum multiplied by the f32 reciprocal
    of its size, as the reference's compiled mean does, so the two agree bit
    for bit."""
    h, w = img.shape
    hs, ws = h // scale * scale, w // scale * scale
    blocks = img[:hs, :ws].reshape(hs // scale, scale, ws // scale, scale)
    total = blocks[:, 0, :, 0]
    for k in range(1, scale * scale):
        total = total + blocks[:, k // scale, :, k % scale]
    return total * float(np.float32(1.0) / np.float32(scale * scale))


def _inverse(T: np.ndarray) -> np.ndarray:
    """SE(3) inverse of a host 4x4 pose, in float32."""
    return se3.se3_inverse(torch.as_tensor(np.asarray(T, np.float32))).numpy()


class NMILocalizer:
    """Owns the render model + camera and runs NMI pose-grid searches on one
    device."""

    def __init__(
        self,
        cfg: NMIConfig,
        camera: CameraConfig,
        model: Optional[render.RenderModel],
        log_fn: Optional[Callable[[str], None]] = None,
        image_scale: int = 1,
        mesh: Optional[MeshModel] = None,
        device: str | torch.device = "cuda",
    ):
        """`model` drives the point-splat path (RENDER_POINT_CLOUD, mode 4);
        `mesh` selects the tiled triangle rasterizer (RENDER_TEXTURE, mode 1 —
        rendering.hpp:54-55) and wins when both are given. Either may be None,
        not both. `image_scale` > 1 runs every sweep on frames downscaled by
        that factor: the caller passes frames of camera size // image_scale."""
        if model is None and mesh is None:
            raise ValueError("NMILocalizer needs a point model or a mesh")
        histogram_nmi.quantize_to_bins(torch.zeros(1), cfg.n_bins)  # raises below 1 bin
        self.device = kernels.resolve_device(device, "NMILocalizer")
        self.cfg = cfg
        self.camera = camera
        # > 1 widens the next search's steps when a call passes no
        # search_scale (the re-init latch's widening)
        self.search_scale = 1.0
        self.mesh = mesh
        if mesh is not None and self.device.type == "cuda":
            t0 = time.perf_counter()
            raster.resident_mesh(mesh, self.device)
            torch.cuda.synchronize(self.device)
            profiling.record_setup("nmi.mesh_upload", time.perf_counter() - t0)
        self.model = None
        if model is not None:
            t0 = time.perf_counter()
            self.model = render.RenderModel(*(t.to(self.device) for t in model))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
                profiling.record_setup("nmi.cloud_upload", time.perf_counter() - t0)
        self.log = log_fn or (lambda s: None)
        # when set, relocalize_once saves the best and the middle cell's
        # overlay images here (the reference's orb_prop_log imagery,
        # Tracking.cc:1911-1948)
        self.debug_dir: Optional[str] = None
        self._debug_seq = 0
        # NMI runs on (possibly downscaled) full frames; scale 1 = parity
        self.scale = image_scale
        self.height = camera.height // image_scale
        self.width = camera.width // image_scale
        self.K = camera.K  # host float32
        if image_scale != 1:
            self.K = self.K.copy()
            self.K[:2] /= image_scale
        self.initial_kernel = sk.SearchKernel(
            num_synth=cfg.grid.synth_num,
            num_warp=cfg.grid.warp_num,
            step_synth=cfg.grid.synth_step,
            step_warp=cfg.grid.warp_step,
        )

    # ------------------------------------------------------------------ grid

    def evaluate_grid(
        self, frame_gray: torch.Tensor, Tcw: np.ndarray, kernel: sk.SearchKernel,
        scale: int = 1,
    ) -> np.ndarray:
        """Score the full 6-D grid at pose Tcw. Returns [S, R] numpy scores.

        Equivalent to one RelocalizeWithNMI grid sweep (Tracking.cc:1879-1902).
        `scale > 1` evaluates at reduced resolution (box-pooled camera frame,
        scaled intrinsics), used for the coarse iterations of the search (the
        FINAL iteration always runs at full resolution)."""
        sweep = self.prepare_sweep(frame_gray, Tcw, kernel, scale)
        scores = self.score_sweep(self.render_sweep(sweep), self.warp_sweep(sweep))
        with _READBACK():
            return to_host(scores)

    # The stages of one `evaluate_grid`, callable alone so that a grid can be
    # timed stage by stage or re-scored against other versions of its kernels.

    @labelled("render.prepare_sweep")
    def prepare_sweep(
        self, frame_gray: torch.Tensor, Tcw: np.ndarray, kernel: sk.SearchKernel,
        scale: int = 1,
    ) -> Sweep:
        """The host stage: the frame and intrinsics at `scale`, the candidate
        grid, and for a mesh its binning (on the card by kernels, from the
        resident mesh; on the CPU in numpy)."""
        offsets_host = kernel.offsets()
        h, w = self.height // scale, self.width // scale
        frame = torch.as_tensor(frame_gray, dtype=torch.float32, device=self.device)
        K = self.K
        if scale != 1:
            K = K.copy()
            K[:2] /= scale
            frame = _box_pool(frame, scale)
        binned = None
        if self.mesh is not None:
            # RENDER_TEXTURE: binned per pose, with a margin that covers the
            # whole candidate grid so all S renders share one binning
            binned = raster.bin_mesh(
                self.mesh, np.asarray(Tcw), K, h, w, self.cfg.render_near, self.cfg.render_far,
                max_offset=np.abs(offsets_host).max(axis=0), device=self.device,
            )
            if binned.overflow:
                self.log(f"NMI raster: {binned.overflow} tile-list entries dropped (capacity)")
        return Sweep(
            frame=frame, K=K,
            Tcw=torch.as_tensor(np.asarray(Tcw, np.float32), device=self.device),
            offsets=torch.from_numpy(offsets_host).to(self.device), angles=kernel.angles(),
            height=h, width=w,
            point_size=max(1, int(round(self.cfg.render_point_size / (self.scale * scale)))),
            binned=binned,
        )

    def render_sweep(self, sweep: Sweep) -> torch.Tensor:
        """[S, h, w] renders of the model at the S candidates."""
        if sweep.binned is not None:
            return raster.render_mesh_grid(sweep.binned, sweep.Tcw, sweep.K, sweep.offsets,
                                           self.cfg.render_near, self.cfg.render_far)
        return render.render_translation_grid(
            self.model, sweep.Tcw, sweep.K, sweep.offsets, sweep.height, sweep.width,
            self.cfg.render_near, self.cfg.render_far, point_size=sweep.point_size,
        )

    def warp_sweep(self, sweep: Sweep) -> torch.Tensor:
        """[R, h, w] warps of the frame by the R rotation hypotheses; the
        homographies are built on each call."""
        return homography.warp_rotation_grid(sweep.frame, sweep.K, sweep.angles)

    def score_sweep(self, synth: torch.Tensor, warped: torch.Tensor) -> torch.Tensor:
        """[S, R] scores on the device."""
        return histogram_nmi.nmi_scores(synth, warped, metric=self.cfg.metric,
                                        n_bins=self.cfg.n_bins,
                                        use_background=self.cfg.use_background)

    # ------------------------------------------------------------- one round

    @labelled("nmi.sweep")
    def relocalize_once(
        self, frame_gray: torch.Tensor, Tcw: np.ndarray, kernel: sk.SearchKernel,
        scale: int = 1,
    ) -> tuple[np.ndarray, sk.SearchKernel]:
        """One grid evaluation + pose snap to the best cell
        (RelocalizeWithNMI, Tracking.cc:1851-1985)."""
        scores = self.evaluate_grid(frame_gray, Tcw, kernel, scale=scale)
        s_flat, r_flat = np.unravel_index(np.argmax(scores), scores.shape)
        kernel = kernel.with_best_from_flat(int(s_flat), int(r_flat), float(scores[s_flat, r_flat]))
        if self.debug_dir:
            self._save_debug_overlays(frame_gray, Tcw, kernel, scores)
        return self._apply_best_cell(Tcw, kernel), kernel

    def _save_debug_overlays(self, frame_gray, Tcw, kernel, scores):
        """The best and the middle cell's overlays at full resolution, the
        grid cell and score in the file name (Tracking.cc:1911-1948: red =
        camera, green = render). The render is one candidate through kernel
        B3 and the sampler for a mesh (binned at `Tcw`), the splat for a
        point model."""
        import os

        from orbslam2_nmi_torch.viz.replay import save_nmi_debug_overlay

        offsets = torch.from_numpy(kernel.offsets()).to(self.device)
        angles = kernel.angles()
        frame = torch.as_tensor(frame_gray, dtype=torch.float32, device=self.device)
        T = torch.as_tensor(np.asarray(Tcw, np.float32), device=self.device)
        near, far = self.cfg.render_near, self.cfg.render_far
        (s_best, r_best), s_mid, r_mid = kernel.best_flat(), kernel.n_synth // 2, kernel.n_warp // 2
        binned = None if self.mesh is None else raster.bin_mesh(
            self.mesh, np.asarray(Tcw), self.K, self.height, self.width, near, far,
            device=self.device)
        point_size = max(1, int(round(self.cfg.render_point_size / self.scale)))
        for tag, s_idx, r_idx in (("best", s_best, r_best), ("middle", s_mid, r_mid)):
            if binned is not None:
                synth = raster.render_mesh_grid(binned, T, self.K, offsets[s_idx:s_idx + 1],
                                                near, far)[0]
            else:
                T_s = T.clone()
                T_s[:3, 3] -= offsets[s_idx]
                synth = render.render_pointcloud(self.model, T_s, self.K, self.height,
                                                 self.width, near, far, point_size=point_size)
            warped = homography.warp_rotation_grid(frame, self.K, angles[r_idx:r_idx + 1])[0]
            name = (f"{self._debug_seq:04d}_{tag}_s{s_idx}_r{r_idx}"
                    f"_nmi{float(scores[s_idx, r_idx]):.4f}.png")
            save_nmi_debug_overlay(to_host(warped), to_host(synth),
                                   os.path.join(self.debug_dir, name))
        self._debug_seq += 1

    def _apply_best_cell(self, Tcw: np.ndarray, kernel: sk.SearchKernel) -> np.ndarray:
        """CalculateNMIRelocalization (Tracking.cc:2374-2419): compose the best
        warp rotation into Twc and shift the camera center by the best render
        offset (expressed in the ORIGINAL camera axes). Host float32."""
        off_cam, angles = kernel.best_cell()
        R_warp = se3.euler_zyx(torch.from_numpy(angles)).numpy()
        Twc = _inverse(Tcw)
        Twc_new = Twc.copy()
        Twc_new[:3, :3] = Twc[:3, :3] @ R_warp
        Twc_new[:3, 3] = Twc[:3, 3] + Twc[:3, :3] @ off_cam
        return _inverse(Twc_new)

    # ------------------------------------------------------------- strategy

    @labelled("nmi.relocalize")
    def relocalize_strategy(
        self,
        frame_gray: torch.Tensor,
        Tcw: np.ndarray,
        dist_since: tuple[float, float, float] = (0.0, 0.0, 0.0),
        rot_since: tuple[float, float, float] = (0.0, 0.0, 0.0),
        initializing: bool = False,
        search_scale: float | None = None,
    ) -> NMIOutcome:
        """Full coarse-to-fine NMI relocalization
        (RelocalizeWithNMIStrategy, Tracking.cc:1987-2179).

        `search_scale` widens the kernel steps for this call only (failure /
        re-init widening); None takes the `search_scale` attribute. Callers
        on other threads pass it rather than set the attribute."""
        cfg = self.cfg
        # --- kernel sizing (Tracking.cc:2001-2070)
        if dist_since[0] > 0.0:
            kernel = sk.initial_kernel_for_drift(
                self.initial_kernel, dist_since, rot_since, cfg.drift_fraction
            )
        elif initializing:
            kernel = sk.initial_kernel_for_init(self.initial_kernel)
        else:
            kernel = dataclasses.replace(self.initial_kernel)
        scale = self.search_scale if search_scale is None else search_scale
        if scale != 1.0:
            kernel = dataclasses.replace(
                kernel,
                step_synth=tuple(s * scale for s in kernel.step_synth),
                step_warp=tuple(s * scale for s in kernel.step_warp),
            )

        # coarse iterations can run at reduced resolution (cfg.coarse_scale
        # > 1); the FINAL full-resolution pass below re-searches the last
        # (smallest-step) grid so the accepted pose and score are always
        # full-resolution quantities
        coarse = max(1, int(cfg.coarse_scale))

        Tcw_save = Tcw.copy()
        Tcw_save_last = Tcw.copy()
        last_nmi = 0.0
        under_threshold = 0
        previous_poses = []
        i = 0
        while True:
            i += 1
            if i > cfg.max_iteration_count:
                break
            previous_poses.append(_inverse(Tcw))
            Tcw, kernel = self.relocalize_once(frame_gray, Tcw, kernel, scale=coarse)
            self.log(
                f"NMI iter {i}: nmi={kernel.nmi:.5f} best_s={kernel.best_synth} "
                f"best_w={kernel.best_warp} steps={kernel.step_synth}/{kernel.step_warp}"
                + (f" (1/{coarse} res)" if coarse > 1 else "")
            )
            if (initializing and scale > 1.0
                    and i == 1 and kernel.nmi < 0.5 * cfg.threshold):
                # hopeless RE-init latch (widened re-init path only): on the
                # original initialization callers ignore the outcome
                break
            if i > 1 and kernel.is_middle():
                break
            if i > 1:
                gain = kernel.nmi / last_nmi if last_nmi > 0 else float("inf")
                if gain < cfg.gain_epsilon:
                    if under_threshold > 0:
                        break
                    under_threshold += 1
                else:
                    under_threshold = 0
            last_nmi = kernel.nmi
            kernel = kernel.resized()
            Tcw_save_last = Tcw.copy()

        # revert to previous iterate if the last evaluation regressed
        if kernel.nmi < last_nmi:
            Tcw = Tcw_save_last

        if coarse > 1:
            # final pass at FULL resolution over the final kernel, shrunk to
            # <= 3 cells per axis: it snaps the pose and gives the score for
            # the accept gate (coarse scores only steered the search)
            fine = dataclasses.replace(
                kernel,
                num_synth=tuple(min(n, 3) for n in kernel.num_synth),
                num_warp=tuple(min(n, 3) for n in kernel.num_warp),
            )
            previous_poses.append(_inverse(Tcw))
            Tcw, kernel = self.relocalize_once(frame_gray, Tcw, fine, scale=1)
            self.log(
                f"NMI final (full res): nmi={kernel.nmi:.5f} "
                f"best_s={kernel.best_synth} best_w={kernel.best_warp}"
            )

        # adaptive acceptance (Tracking.cc:2140-2168). Fail safe on any
        # non-finite input: a NaN distance would make every comparison False
        # and silently accept an arbitrarily bad latch.
        distance = float(np.linalg.norm(dist_since))
        if not np.isfinite(distance):
            distance = 0.0  # strictest threshold
        threshold = sk.adaptive_threshold(cfg.threshold, distance)
        accepted = bool(np.isfinite(kernel.nmi) and kernel.nmi >= threshold)
        if not accepted and initializing:
            self.log(
                f"NMI INIT REJECTED: nmi={kernel.nmi:.5f} < threshold "
                f"{threshold:.5f} — init pose NOT refined"
            )
        return NMIOutcome(
            Tcw=Tcw if accepted else Tcw_save,
            nmi=kernel.nmi,
            relocalized=accepted,
            failed=not accepted,
            iterations=i,
            previous_poses=previous_poses,
            num_synth=kernel.num_synth,
            num_warp=kernel.num_warp,
        )
