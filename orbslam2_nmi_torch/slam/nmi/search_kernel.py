"""The 6-DoF NMI search-grid descriptor + coarse-to-fine schedule.

A copy of `orbslam2_nmi_tpu/slam/nmi/search_kernel.py`, kept in this package
so that the port imports nothing of the JAX package.

Host-side pure-Python state machine replicating NmiSearchKernel (reference:
Thirdparty/Localization/nmiSearchKernel.cpp): grid sizes, step sizes, best
cell, and the resize rule — halve steps in dimensions whose best is not
peripheral (nmiSearchKernel.cpp:104-141, STEPFACTOR=0.5), collapse a dimension
to a single cell when its step falls under the minimum
(allProperties.hpp:49-50: 0.005 m translation, 0.001 rad rotation).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

MIN_KERNEL_TRANSLATION = 0.005  # m   (nmi_prop_MIN_KERNEL_TRANSLATION)
MIN_KERNEL_ROTATION = 0.001  # rad (nmi_prop_MIN_KERNEL_ROTATION)
STEP_FACTOR = 0.5  # nmi_prop_STEPFACTOR


@dataclass
class SearchKernel:
    num_synth: tuple[int, int, int] = (3, 3, 3)
    num_warp: tuple[int, int, int] = (3, 3, 3)
    step_synth: tuple[float, float, float] = (0.2, 0.2, 0.5)
    step_warp: tuple[float, float, float] = (0.02, 0.02, 0.05)
    best_synth: tuple[int, int, int] = (-1, -1, -1)
    best_warp: tuple[int, int, int] = (-1, -1, -1)
    nmi: float = 0.0

    @property
    def n_synth(self) -> int:
        nx, ny, nz = self.num_synth
        return nx * ny * nz

    @property
    def n_warp(self) -> int:
        nx, ny, nz = self.num_warp
        return nx * ny * nz

    def is_middle(self) -> bool:
        """Best cell is the exact grid center (nmiSearchKernel.cpp:99)."""
        return all(
            b == n // 2 for b, n in zip(self.best_synth, self.num_synth)
        ) and all(b == n // 2 for b, n in zip(self.best_warp, self.num_warp))

    def with_best_from_flat(self, s_flat: int, r_flat: int, nmi: float) -> "SearchKernel":
        """Decode flat (s, r) argmax indices; layout s=(sz*ny+sy)*nx+sx."""
        nsx, nsy, _ = self.num_synth
        nwx, nwy, _ = self.num_warp
        sx = s_flat % nsx
        sy = (s_flat // nsx) % nsy
        sz = s_flat // (nsx * nsy)
        wx = r_flat % nwx
        wy = (r_flat // nwx) % nwy
        wz = r_flat // (nwx * nwy)
        return replace(self, best_synth=(sx, sy, sz), best_warp=(wx, wy, wz), nmi=nmi)

    def resized(self) -> "SearchKernel":
        """Coarse-to-fine shrink (nmiSearchKernel.cpp resizeKernel): halve the
        step of every dimension whose best is NOT on the periphery, then
        collapse dimensions whose step dropped below the minimum."""

        def shrink(steps, nums, bests, min_step):
            new_steps = []
            new_nums = []
            for step, n, b in zip(steps, nums, bests):
                peripheral = (b == n - 1 or b == 0) and n > 1
                s2 = step if peripheral else step * STEP_FACTOR
                new_steps.append(s2)
                new_nums.append(1 if s2 < min_step else n)
            return tuple(new_steps), tuple(new_nums)

        step_s, num_s = shrink(
            self.step_synth, self.num_synth, self.best_synth, MIN_KERNEL_TRANSLATION
        )
        step_w, num_w = shrink(
            self.step_warp, self.num_warp, self.best_warp, MIN_KERNEL_ROTATION
        )
        return replace(
            self, num_synth=num_s, num_warp=num_w, step_synth=step_s, step_warp=step_w
        )


def initial_kernel_for_drift(
    base: SearchKernel,
    dist_since: tuple[float, float, float],
    rot_since: tuple[float, float, float],
    drift_fraction: float = 0.02,
) -> SearchKernel:
    """Drift-scaled kernel sizing at reloc entry (Tracking.cc:2001-2052):
    step = drift_fraction * accumulated per-axis motion; dims whose step is
    below the minimum collapse to a single cell."""
    steps_t = tuple(d * drift_fraction for d in dist_since)
    steps_r = tuple(r * drift_fraction for r in rot_since)
    nums_t = tuple(
        1 if s < MIN_KERNEL_TRANSLATION else n for s, n in zip(steps_t, base.num_synth)
    )
    nums_r = tuple(
        1 if s < MIN_KERNEL_ROTATION else n for s, n in zip(steps_r, base.num_warp)
    )
    return SearchKernel(
        num_synth=nums_t, num_warp=nums_r, step_synth=steps_t, step_warp=steps_r
    )


def initial_kernel_for_init(base: SearchKernel) -> SearchKernel:
    """Initialization-time kernel: 5x5x5 translations, base rotations
    (Tracking.cc:2057-2063)."""
    return SearchKernel(
        num_synth=(5, 5, 5),
        num_warp=base.num_warp,
        step_synth=base.step_synth,
        step_warp=base.step_warp,
    )


def adaptive_threshold(base_threshold: float, distance_since: float, baseline: float = 5.0) -> float:
    """Accept threshold relaxed with distance (Tracking.cc:2140-2152): scaled
    by baseline/distance beyond `baseline` meters, floored at half."""
    if distance_since < baseline:
        return base_threshold
    return max(base_threshold * (baseline / distance_since), base_threshold / 2.0)
