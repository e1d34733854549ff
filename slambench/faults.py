"""Faults a cell's timed path can have, planted underneath it.

Each takes a built cell (before its warm-up) and breaks the program's path in
place; a run with one must come out with `correct` false. The benchmark's
tests plant them on the CPU; `tools/readings.py --fault` reads them on the
card. A reloc cell and the live cell's NMI anchors break in the localizer;
the live cell's tracking breaks in the replayed step's outputs.
"""

from __future__ import annotations

import numpy as np
import torch


def _localizer(cell):
    return cell.system.localizer if hasattr(cell, "system") else cell.loc


def unchanged_state(cell) -> None:
    """A step that returns its state unchanged: the tracking step reports the
    pose (and carry) it was given; a relocalization sweeps and returns the
    pose it was given."""
    if hasattr(cell, "fe"):
        from orbslam2_nmi_torch.slam.fused_track import StepOutputs

        step = cell.fe.step

        def stuck(img, carry, *cand):
            out = step(img, carry, *cand)
            packed = out.packed.clone()
            packed[:16] = carry.Tcw.reshape(-1)
            return StepOutputs(carry=carry, packed=packed)

        cell.fe.step = stuck
        return
    loc = cell.loc
    strategy = loc.relocalize_strategy

    def returns_prior(frame, Tcw, dist, rot, **kw):
        out = strategy(frame, Tcw, dist, rot, **kw)
        out.Tcw = np.asarray(Tcw, np.float32).copy()
        return out

    loc.relocalize_strategy = returns_prior


def half_batch(cell) -> None:
    """Half of the batch left out: only the first half of each sweep's
    renders is scored, the rest take the mean of those scores."""
    loc = _localizer(cell)
    score = loc.score_sweep

    def half(synth, warped):
        h = max(1, synth.shape[0] // 2)
        part = score(synth[:h], warped)
        return torch.cat([part, part.mean(0, keepdim=True).expand(synth.shape[0] - h, -1)])

    loc.score_sweep = half


def altered_answer(cell) -> None:
    """An answer altered where it is produced: one gray level of every render
    of a relocalization, or the first word of every descriptor the tracking
    step extracts."""
    if hasattr(cell, "fe"):
        from orbslam2_nmi_torch.slam.fused_track import StepOutputs

        step, n = cell.fe.step, cell.fe.n_feat

        def flipped(img, carry, *cand):
            out = step(img, carry, *cand)
            packed = out.packed.clone()
            words = packed[packed.shape[0] - 8 * n:].view(torch.int32).view(n, 8)
            words[:, 0] ^= 1
            return StepOutputs(carry=out.carry, packed=packed)

        cell.fe.step = flipped
        return
    loc = cell.loc
    render = loc.render_sweep

    def altered(sweep):
        out = render(sweep)
        out[:, out.shape[1] // 2, out.shape[2] // 2] += 9.0
        return out

    loc.render_sweep = altered


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "altered_answer": altered_answer}
