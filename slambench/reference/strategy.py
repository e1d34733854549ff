"""Plain reference of one NMI relocalization (RelocalizeWithNMIStrategy).

The search-kernel state machine (the reference system's nmiSearchKernel.cpp
and Tracking.cc:1987-2179, as the program's `slam/nmi/search_kernel.py` and
`NMILocalizer.relocalize_strategy` state them): a drift-sized 3x3x3 x 3x3x3
grid, each sweep's renders, warps and [S, R] scores from this package's
plain modules, the pose snapped to the best cell, steps halved where the
best is not peripheral, stopped at the middle cell, on a stalled gain or
after `max_iteration_count` sweeps, reverted if the last sweep regressed,
and accepted against the distance-relaxed threshold.

The poses are float64 (`geometry.py`); a sweep's centre pose is handed on
in float32, as the program hands it on.
`precision="bfloat16"` is the control, one precision below the float32 the
configuration states: the homographies, the splat's camera-frame
coordinates, every render and warp, and each pose the search hands on are
rounded to bfloat16. Grays 0-255 are exact in bfloat16, so a splat's render
rounded after it is made would be the float32 render; its coordinates,
rounded before they are projected, are the precision the control stands for.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from slambench.reference import geometry, nmi, raster, splat, warp

MIN_KERNEL_TRANSLATION = 0.005
MIN_KERNEL_ROTATION = 0.001
STEP_FACTOR = 0.5


@dataclass
class Kernel:
    num_synth: tuple = (3, 3, 3)
    num_warp: tuple = (3, 3, 3)
    step_synth: tuple = (0.2, 0.2, 0.5)
    step_warp: tuple = (0.02, 0.02, 0.05)
    best_synth: tuple = (-1, -1, -1)
    best_warp: tuple = (-1, -1, -1)
    nmi: float = 0.0

    def is_middle(self) -> bool:
        return (all(b == n // 2 for b, n in zip(self.best_synth, self.num_synth))
                and all(b == n // 2 for b, n in zip(self.best_warp, self.num_warp)))

    def with_best(self, s: int, r: int, score: float) -> "Kernel":
        nsx, nsy, _ = self.num_synth
        nwx, nwy, _ = self.num_warp
        return replace(self, best_synth=(s % nsx, (s // nsx) % nsy, s // (nsx * nsy)),
                       best_warp=(r % nwx, (r // nwx) % nwy, r // (nwx * nwy)), nmi=score)

    def resized(self) -> "Kernel":
        def shrink(steps, nums, bests, min_step):
            out_s, out_n = [], []
            for step, n, b in zip(steps, nums, bests):
                peripheral = (b == n - 1 or b == 0) and n > 1
                s2 = step if peripheral else step * STEP_FACTOR
                out_s.append(s2)
                out_n.append(1 if s2 < min_step else n)
            return tuple(out_s), tuple(out_n)

        ss, ns = shrink(self.step_synth, self.num_synth, self.best_synth, MIN_KERNEL_TRANSLATION)
        sw, nw = shrink(self.step_warp, self.num_warp, self.best_warp, MIN_KERNEL_ROTATION)
        return replace(self, num_synth=ns, num_warp=nw, step_synth=ss, step_warp=sw)


def kernel_for_drift(base_num_synth, base_num_warp, dist, rot, drift_fraction) -> Kernel:
    steps_t = tuple(d * drift_fraction for d in dist)
    steps_r = tuple(r * drift_fraction for r in rot)
    return Kernel(
        num_synth=tuple(1 if s < MIN_KERNEL_TRANSLATION else n
                        for s, n in zip(steps_t, base_num_synth)),
        num_warp=tuple(1 if s < MIN_KERNEL_ROTATION else n for s, n in zip(steps_r, base_num_warp)),
        step_synth=steps_t, step_warp=steps_r)


def adaptive_threshold(base: float, distance: float, baseline: float = 5.0) -> float:
    if distance < baseline:
        return base
    return max(base * (baseline / distance), base / 2.0)


def box_pool(img: torch.Tensor, scale: int) -> torch.Tensor:
    h, w = img.shape
    hs, ws = h // scale * scale, w // scale * scale
    blocks = img[:hs, :ws].reshape(hs // scale, scale, ws // scale, scale)
    total = blocks[:, 0, :, 0]
    for k in range(1, scale * scale):
        total = total + blocks[:, k // scale, :, k % scale]
    return total * float(np.float32(1.0) / np.float32(scale * scale))


@dataclass
class SweepResult:
    Tcw: np.ndarray  # the sweep's centre pose
    kernel: Kernel  # the kernel it swept (before its best cell)
    scale: int
    renders: torch.Tensor  # [S, h, w]
    warps: torch.Tensor  # [R, h, w]
    scores: np.ndarray  # [S, R]
    Tcw_own: np.ndarray = None  # the centre the reference itself handed on to this sweep


class Reference:
    """The plain relocalizer of one configuration on `device`: a mesh prior
    (render mode 1) or a pointcloud (render mode 4), never both."""

    def __init__(self, nmi_cfg: dict, K: np.ndarray, height: int, width: int, device,
                 mesh=None, points=None, gray=None, precision: str = "float32"):
        if precision not in ("float32", "bfloat16"):
            raise ValueError(f"unknown precision {precision!r}")
        self.cfg = nmi_cfg
        self.K = np.asarray(K, np.float32)
        self.height, self.width = height, width
        self.device = torch.device(device)
        self.mesh = mesh
        self.model = None if points is None else splat.RenderModel(
            torch.as_tensor(points, device=self.device), torch.as_tensor(gray, device=self.device))
        self.precision = precision

    def sweep(self, frame: torch.Tensor, Tcw: np.ndarray, kernel: Kernel, scale: int,
              keep_images: bool = False) -> SweepResult:
        cfg = self.cfg
        offsets = splat.translation_grid_offsets(kernel.num_synth, kernel.step_synth, device="cpu")
        angles = warp.rotation_grid_angles(kernel.num_warp, kernel.step_warp, device="cpu").numpy()
        h, w = self.height // scale, self.width // scale
        K = self.K
        frame = torch.as_tensor(frame, dtype=torch.float32, device=self.device)
        if scale != 1:
            K = K.copy()
            K[:2] /= scale
            frame = box_pool(frame, scale)
        T = torch.as_tensor(np.asarray(Tcw, np.float32), device=self.device)
        low = self.precision == "bfloat16"
        if self.mesh is not None:
            binned = raster.bin_mesh(self.mesh, np.asarray(Tcw), K, h, w, cfg["render_near"],
                                     cfg["render_far"],
                                     max_offset=np.abs(offsets.numpy()).max(axis=0))
            renders = raster.render_mesh_grid(binned, T, K, offsets, cfg["render_near"],
                                              self.device)
        else:
            point_size = max(1, int(round(cfg["render_point_size"] / scale)))
            renders = splat.render_translation_grid(self.model, T, K, offsets.to(self.device), h,
                                                    w, cfg["render_near"], cfg["render_far"],
                                                    point_size=point_size,
                                                    round_to=torch.bfloat16 if low else None)
        warps = warp.warp_rotation_grid(frame, K, angles, round_to=torch.bfloat16 if low else None)
        if low:
            renders = renders.to(torch.bfloat16).to(torch.float32)
            warps = warps.to(torch.bfloat16).to(torch.float32)
        scores = nmi.nmi_scores(renders, warps).cpu().numpy()
        return SweepResult(Tcw=np.asarray(Tcw, np.float32).copy(), kernel=replace(kernel),
                           scale=scale, renders=renders if keep_images else None,
                           warps=warps if keep_images else None, scores=scores)

    def apply_best_cell(self, Tcw: np.ndarray, kernel: Kernel) -> np.ndarray:
        """CalculateNMIRelocalization: the best rotation composed into Twc,
        the centre moved by the best offset along the original camera axes.
        Float64 throughout; the pose handed on is float32 (bfloat16 values in
        the control)."""
        def cell_value(best, num, step):
            return np.array([(b - (n - 1) / 2.0) * s for b, n, s in zip(best, num, step)])

        off_cam = cell_value(kernel.best_synth, kernel.num_synth, kernel.step_synth)
        R_warp = geometry.euler_zyx_matrix(
            cell_value(kernel.best_warp, kernel.num_warp, kernel.step_warp))
        Twc = geometry.inverse_host(Tcw)
        Twc_new = Twc.copy()
        Twc_new[:3, :3] = Twc[:3, :3] @ R_warp
        Twc_new[:3, 3] = Twc[:3, 3] + Twc[:3, :3] @ off_cam
        out = torch.from_numpy(geometry.inverse_host(Twc_new))
        if self.precision == "bfloat16":
            out = out.to(torch.bfloat16)
        return out.to(torch.float32).numpy()

    def step(self, frame, Tcw, kernel, scale, keep_images=False):
        """One sweep and its pose snap: (new Tcw, kernel with its best, sweep)."""
        res = self.sweep(frame, Tcw, kernel, scale, keep_images)
        s, r = np.unravel_index(np.argmax(res.scores), res.scores.shape)
        kernel = kernel.with_best(int(s), int(r), float(res.scores[s, r]))
        return self.apply_best_cell(Tcw, kernel), kernel, res

    def relocalize(self, frame, Tcw: np.ndarray, dist, rot, search_scale: float = 1.0,
                   keep_images=False, follow=None):
        """(pose, accepted, sweeps): the whole strategy from a drift prior,
        its steps widened by `search_scale` (the worker's widening after
        failed anchors).

        `follow`, the centres of the program's sweeps in order: each sweep
        is made at the program's centre, and the centre the reference
        itself handed on is kept beside it (`SweepResult.Tcw_own`) to be
        judged. A pose one ulp off moves the scores by up to ~1e-4, so two
        sound chains part at a near-tied best cell; followed, every step
        is judged from the same state."""
        cfg = self.cfg
        if dist[0] > 0.0:
            kernel = kernel_for_drift(tuple(cfg["synth_num"]), tuple(cfg["warp_num"]), dist, rot,
                                      cfg["drift_fraction"])
        else:
            kernel = Kernel(num_synth=tuple(cfg["synth_num"]), num_warp=tuple(cfg["warp_num"]),
                            step_synth=tuple(cfg["synth_step"]), step_warp=tuple(cfg["warp_step"]))
        if search_scale != 1.0:
            kernel = replace(kernel, step_synth=tuple(s * search_scale for s in kernel.step_synth),
                             step_warp=tuple(s * search_scale for s in kernel.step_warp))
        coarse = max(1, int(cfg["coarse_scale"]))
        Tcw = np.asarray(Tcw, np.float32).copy()
        Tcw_save, Tcw_last = Tcw.copy(), Tcw.copy()
        last_nmi, under, i, sweeps = 0.0, 0, 0, []
        follow = list(follow or [])

        def step(Tcw, kernel, scale):
            own = Tcw
            if len(sweeps) < len(follow):
                Tcw = np.asarray(follow[len(sweeps)], np.float32).copy()
            Tcw_new, kernel, res = self.step(frame, Tcw, kernel, scale, keep_images)
            res.Tcw_own = np.asarray(own, np.float32).copy()
            sweeps.append(res)
            return Tcw, Tcw_new, kernel

        while True:
            i += 1
            if i > cfg["max_iteration_count"]:
                break
            Tcw_last, Tcw, kernel = step(Tcw, kernel, coarse)
            if i > 1 and kernel.is_middle():
                break
            if i > 1:
                gain = kernel.nmi / last_nmi if last_nmi > 0 else float("inf")
                if gain < cfg["gain_epsilon"]:
                    if under > 0:
                        break
                    under += 1
                else:
                    under = 0
            last_nmi = kernel.nmi
            kernel = kernel.resized()
            Tcw_last = Tcw.copy()
        if kernel.nmi < last_nmi:
            Tcw = Tcw_last
        if coarse > 1:
            fine = replace(kernel, num_synth=tuple(min(n, 3) for n in kernel.num_synth),
                           num_warp=tuple(min(n, 3) for n in kernel.num_warp))
            _, Tcw, kernel = step(Tcw, fine, 1)
        distance = float(np.linalg.norm(dist))
        if not np.isfinite(distance):
            distance = 0.0
        accepted = bool(np.isfinite(kernel.nmi)
                        and kernel.nmi >= adaptive_threshold(cfg["threshold"], distance))
        return (Tcw if accepted else Tcw_save), accepted, sweeps
