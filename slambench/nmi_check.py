"""Recording the program's NMI relocalizations and judging them against the
plain reference (`slambench/reference/strategy.py`).

`SweepRecorder` wraps a localizer's own stages: for each relocalization it
records, on the thread that runs it, each sweep's inputs and [S, R] scores
(read back by the program anyway) and, when asked, the renders and warps the
sweep made. `check` replays relocalizations in the reference from the same
frame, prior, motion and widening, step by step from the program's own
sweep centres, and judges every recorded sweep and every pose handed on.
"""

from __future__ import annotations

import threading

import numpy as np
import torch


class SweepRecorder:
    """Records the sweeps of the relocalizations run between `start` and
    `stop` on the calling thread."""

    def __init__(self, loc):
        self._local = threading.local()
        evaluate, render, warp = loc.evaluate_grid, loc.render_sweep, loc.warp_sweep
        local = self._local

        def evaluate_grid(frame, Tcw, kernel, scale=1):
            sweeps = getattr(local, "sweeps", None)
            rec = None
            if sweeps is not None:
                rec = dict(Tcw=np.asarray(Tcw, np.float32).copy(), num_synth=kernel.num_synth,
                           num_warp=kernel.num_warp, step_synth=kernel.step_synth,
                           step_warp=kernel.step_warp, scale=scale)
                sweeps.append(rec)
            scores = evaluate(frame, Tcw, kernel, scale)
            if rec is not None:
                rec["scores"] = scores
            return scores

        def render_sweep(sweep):
            out = render(sweep)
            if getattr(local, "keep", False):
                local.sweeps[-1]["renders"] = out
            return out

        def warp_sweep(sweep):
            out = warp(sweep)
            if getattr(local, "keep", False):
                local.sweeps[-1]["warps"] = out
            return out

        loc.evaluate_grid, loc.render_sweep, loc.warp_sweep = evaluate_grid, render_sweep, warp_sweep

    def start(self, keep: bool) -> list:
        self._local.sweeps, self._local.keep = [], keep
        return self._local.sweeps

    def stop(self) -> None:
        self._local.sweeps, self._local.keep = None, False


def sweep_record(s) -> dict:
    """A reference `SweepResult` in the recorder's format."""
    k = s.kernel
    return dict(Tcw=s.Tcw, num_synth=k.num_synth, num_warp=k.num_warp, step_synth=k.step_synth,
                step_warp=k.step_warp, scale=s.scale, scores=s.scores, renders=s.renders,
                warps=s.warps)


def _same_inputs(s: dict, rs) -> bool:
    k = rs.kernel
    return (np.array_equal(np.asarray(s["Tcw"], np.float32), rs.Tcw) and s["scale"] == rs.scale
            and tuple(s["num_synth"]) == tuple(k.num_synth)
            and tuple(s["num_warp"]) == tuple(k.num_warp)
            and tuple(s["step_synth"]) == tuple(k.step_synth)
            and tuple(s["step_warp"]) == tuple(k.step_warp))


def _max_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    if tuple(a.shape) != tuple(b.shape):
        return float("inf")
    return float((a.to(b.device, torch.float32) - b).abs().max())


def pose_gap(T_a: np.ndarray, T_b: np.ndarray) -> tuple:
    """(camera-centre distance in m, rotation angle in rad) between two Tcw;
    the angle from the chord ||Ra - Rb|| = 2 sqrt(2) sin(angle / 2), exact
    at zero where arccos of the trace is not."""
    Ta, Tb = np.asarray(T_a, np.float64), np.asarray(T_b, np.float64)
    ca = -Ta[:3, :3].T @ Ta[:3, 3]
    cb = -Tb[:3, :3].T @ Tb[:3, 3]
    chord = np.linalg.norm(Ta[:3, :3] - Tb[:3, :3]) / (2.0 * np.sqrt(2.0))
    return float(np.linalg.norm(ca - cb)), float(2.0 * np.arcsin(min(chord, 1.0)))


def check(ref, items: list) -> dict:
    """The worst gaps over `items`, each a relocalization the program ran:
    its inputs (`frame`, `Tcw_prior`, `dist`, `rot`, `search_scale`), its
    outcome (`Tcw`, `relocalized`) and its recorded `sweeps`. The reference
    replays each from the same inputs, each sweep at the centre the program
    swept (`Reference.relocalize(follow=...)`): the pose gaps are the worst
    of the final pose's and of each centre the program handed on against
    the one the reference handed on from the same state (the first against
    the prior). A sweep of another kernel, or a count of sweeps that
    differs, is a cell miss; such a sweep is judged against the
    reference's sweep of the program's own inputs."""
    from slambench.reference.strategy import Kernel

    out = dict(render_gap=0.0, warp_gap=0.0, score_gap=0.0, cell_miss=0, accept_miss=0,
               pose_gap_m=0.0, pose_gap_rad=0.0, compared_sweeps=0, compared_images=0)
    for it in items:
        keep = bool(it["sweeps"]) and "renders" in it["sweeps"][0]
        pose, accepted, ref_sweeps = ref.relocalize(it["frame"], it["Tcw_prior"], it["dist"],
                                                    it["rot"], it.get("search_scale", 1.0),
                                                    keep_images=keep,
                                                    follow=[s["Tcw"] for s in it["sweeps"]])
        out["accept_miss"] += int(bool(accepted) != bool(it["relocalized"]))
        out["cell_miss"] += int(len(ref_sweeps) != len(it["sweeps"]))
        gaps = [pose_gap(np.asarray(it["Tcw"]), pose)]
        gaps += [pose_gap(np.asarray(s["Tcw"]), rs.Tcw_own)
                 for s, rs in zip(it["sweeps"], ref_sweeps)]
        out["pose_gap_m"] = max([out["pose_gap_m"]] + [g[0] for g in gaps])
        out["pose_gap_rad"] = max([out["pose_gap_rad"]] + [g[1] for g in gaps])
        for i, s in enumerate(it["sweeps"]):
            rs = ref_sweeps[i] if i < len(ref_sweeps) else None
            if rs is not None and not _same_inputs(s, rs):
                out["cell_miss"] += 1
            if rs is None or not _same_inputs(s, rs):
                kern = Kernel(num_synth=tuple(s["num_synth"]), num_warp=tuple(s["num_warp"]),
                              step_synth=tuple(s["step_synth"]), step_warp=tuple(s["step_warp"]))
                rs = ref.sweep(it["frame"], s["Tcw"], kern, s["scale"], keep_images=keep)
            out["compared_sweeps"] += 1
            if s["scores"].shape != rs.scores.shape:
                out["score_gap"] = float("inf")
                out["cell_miss"] += 1
                continue
            out["score_gap"] = max(out["score_gap"], float(np.max(np.abs(s["scores"] - rs.scores))))
            out["cell_miss"] += int(np.argmax(s["scores"]) != np.argmax(rs.scores))
            if "renders" in s and rs.renders is not None:
                out["compared_images"] += 1
                out["render_gap"] = max(out["render_gap"], _max_gap(s["renders"], rs.renders))
                out["warp_gap"] = max(out["warp_gap"], _max_gap(s["warps"], rs.warps))
    out["uncompared"] = int(out["compared_sweeps"] == 0 or out["compared_images"] == 0)
    return out
