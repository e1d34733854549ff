#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It
  1. prints the card's name and power limit (nvidia-smi);
  2. builds the CUDA kernels from `orbslam2_nmi_torch/csrc/` (timed);
  3. holds each kernel against its plain PyTorch version on the card, at the
     shapes of the main path, within the tolerances stated below, and times
     kernel, plain version and (where one exists) one PyTorch library call,
     or a near relative of one (B1 and B2: `torch.bincount` of the histograms);
     holds B1, B2 and B3 against their plain versions on adversarial inputs
     too (`orbslam2_nmi_torch/kernel_cases.py`); holds B3's gray epilogue
     (`render_gray`: B3 with the texture sampler B4/B5 fused) exactly against
     the sampler's plain version on B3's keys epilogue's own outputs, and
     against the all-plain composition, on the entry's windowed binning, a
     whole-texture binning, a non-zero background and the adversarial cases;
     times B2's C entry point alone beside its wrapper, so the wrapper's host
     time shows;
  4. drives the main path, `orbslam2_nmi_torch.entry.entry()` at 960x540 with
     27 renders x 27 warps, with the launch counts set to 0 just before and
     read just after; checks the scores against an all-plain run on the card
     and that a frame rendered at the grid's center pose scores best at the
     center; then times render, warp, score and the whole step;
  5. drives the NMI localizer (`entry.localizer_entry()`, 960x540) on the
     textured mesh (render mode 1): (a) initialization from one translation
     step off (first sweep 125 renders x 27 warps), (b) a one-step rotation
     with a rotation-only kernel, (c) (a) with half-resolution coarse sweeps,
     (d) a uniform-noise frame, which must fail and return the input pose;
     in each case holds the first grid of each (renders, warps, scale)
     against an all-plain run on the card on the same sweep inputs; checks
     that each kernel launched once a grid evaluation in each case; times
     each case and splits one sweep of (a) into the localizer's stages (host
     binning, render, warp, score) and the readback;
  6. holds the point splat's kernels (`splat_scatter`, `splat_resolve`)
     against the plain torch splat bit for bit at the deployment's shapes
     (27 candidates of the 2,184,253-point terrain cloud at 960x540, point
     size 3), the key buffer and the images, and times both beside their
     byte bounds, the plain path and `scatter_reduce_` alone (`library_ms`);
     then drives the localizer on the mesh's point sampling (render mode 4),
     case (a), where B1, B2 and the two splat kernels launch once a grid,
     with the same all-plain checks (the all-plain renders by the plain
     torch splat);
  7. drives the per-frame tracking front-end (`entry.tracking_entry()`,
     960x540, 2,000 ORB features, 2,048 local-map candidates), seeded from
     ground truth: renders frames 6-55 of the 520-frame circuit
     (`render_gray`, launch counts set to 0 just before and read after the chain),
     runs the step over frames 8-55 with each frame's carry feeding the next
     and the candidates rebuilt at the last estimate; checks every frame
     against the tracking gate and the camera-center error against ground
     truth; holds B3 and `render_gray` against their plain versions on frame
     8's binning of the circuit's terrain; holds eager against CUDA-graph
     replay bit for bit on three frames, runs a step under
     `set_sync_debug_mode("error")`, runs one with TF32 turned on, holds the
     first frame's step against the CPU's; times the step eagerly (by
     stage) and replayed, the host's share of a frame, and the rendering of
     one frame and its host binning;
  8. drives mapping and NMI initialization (`entry.mapping_entry()`, the
     full-circuit replay configuration at 960x540): checks that the native
     map core is live; renders frames 0 and 8-68 (`render_gray`);
     latches frames 0 and 8 by NMI from seeds one translation step off,
     holding the first grid of each shape in each latch against an
     all-plain run and counting one launch of each kernel a grid; checks
     the init map (at least 15 points, distance to the ray-cast oracle) and
     its global BA; tracks frames 9-68 against the map being built, every
     frame through the gate within 0.0625 m of ground truth, a keyframe
     every 10 frames to the mapping worker (6 processed, no error), the NMI
     keyframes' poses bit for bit after every BA; times the replayed step
     beside a local BA on the worker's stream and on the default stream;
     holds the last keyframe's local BA on the card against the CPU (one LM
     step within `MAP_BA_STEP_POSE`; the whole solve's LM traces, gaps and
     costs printed), repeated and with TF32 on (max |diff| 0); times the
     kernels at the latches' shapes. The session is `entry.loop_entry()`'s,
     so place recognition is wired: the vocabulary trains where the
     reference trains it, and the phase prints when, on which thread and at
     which frame;
  9. on that session, place recognition and loop closing: relocalizes frame
     500 against the map by BoW and PnP (error to truth under 0.1 m; the
     card against the CPU on the same matches and samples); adds the drifted
     revisit arc (`entry.add_revisit_arc`, frames 476-518 rendered by
     `render_gray`, launch counts set to 0 just before and read after); runs
     the loop closer on each arc keyframe with the reference's consistency
     of 3 and waits for the global BA; checks that exactly one loop closed,
     against a keyframe of frames 0-68, that the arc's error fell below half,
     that at most half of the seam's duplicates survive, that the NMI
     keyframes did not move; holds ComputeSim3 of the closing pair and the
     closure's essential graph on the card against the CPU (bars `LOOP_*`,
     a one-ulp control beside them) and with TF32 on; prints the C2 counts
     and times `optimize_pose_graph` at V 424 on the card and the CPU;
 10. drives the whole system (`entry.circuit_entry()`: SLAMSystem with async
     mapping and async NMI on the JAX package's full-circuit record, the
     seed-1 world, all 520 frames rendered on the card) through
     `PipelinedFrontend.run` in chunks of 40 frames, the launch counts set to
     0 just before and read just after; drains both workers and checks the
     record's bars (`SYS_*`: at least 508 of 520 frames tracked, unaligned
     ATE-RMSE of the recomposed trajectory at most 0.0625 m, no loop
     closure), printing each beside the reference's number, the anchors
     against half the reference's 42, the keyframe decisions by cause (c2
     refused while the mapper was busy), the completion walls, where a
     frame's host time goes, the vocabulary's record and the C2 counts;
     captures a tracking step while
     the NMI worker runs a sweep and the mapping worker a local BA (replay
     against eager, bit for bit); runs one classic frame (motion model, local
     map, pose LM) on the card and on the CPU from the state after frame 279
     (bindings equal, Tcw within 1e-4 or twice the one-ulp control; TF32 on:
     0); feeds 3 noise frames and then frames 48-99 (LOST, relocalized by
     `Tracker._relocalize` within 3 frames at most 0.1 m off), then frames
     100-159 in localization-only mode (no keyframe, at least 56 tracked);
     then drives the circuit again on a fresh system with the mapping worker
     drained after every fused frame, the keyframe decisions of a tracker
     slower than its mapper, as the reference's record was taken at 1.35
     frames/s, and holds the record's bars there: at least 21 NMI anchors
     (half of the reference's 42), 508 frames tracked, ATE-RMSE 0.0625 m;
 11. the settings-file entry, the user's front door: writes the 120-frame
     domain-gap prefix of the seed-1 circuit to disk in the reference's
     formats (`entry.write_settings_scene`: a settings YAML at threshold 0.1
     with NMI.Init1/Init2, the terrain as an OBJ with its texture and as an
     XYZ pointcloud with an offset file, the frames in the ETH layout); runs
     `run_replay.main --settings --sequence` in-process (the classic path,
     synchronous mapping, NMI from the OBJ; launch counts set to 0 just
     before and read after): the localizer holds the OBJ's mesh, B1, B2 and
     `render_gray` launched, the first sweep within SCORE_ATOL of its
     all-plain rescore with the same argmax, at least 108 of 120 tracked,
     the saved trajectory's unaligned ATE-RMSE at most 0.0625 m, at least
     one anchor; prints the ms a frame; holds the OBJ's mesh equal to the
     world's (corner for corner, one vertex relabelling) and one init sweep
     of `SLAMSystem.from_yaml` against `replay_bench.build_system`'s
     in-memory mesh, and the XYZ's at render mode 4 against the in-memory
     pointcloud (SCORE_ATOL, the same argmax); drives
     `tools/circuit_diag.run_diag` classic and pipelined, NMI off,
     synchronous mapping, over the clean prefix's first 80 frames (at least
     68 tracked, online error p95 at most 0.0625 m each);
 12. the tools (`tools/bench.py`, `replay_bench.py`, `device_budget.py`) and
     the headless visualization (`viz/replay.py`), at 960x540: the bench
     sweep on the reference bench's scene (71,442 faces, a 512x512 texture,
     27 x 27; medians and spreads by CUDA events, evaluations/s, one launch
     of each kernel, the scores within 1e-5 of an all-plain run with the
     same argmax, `render_gray`'s and B3's keys epilogue's times beside
     their byte bounds);
     the domain-gap replay of the 160-frame prefix of the seed-1 circuit
     (`run_replay`: threshold 0.1, pipelined, async mapping and async NMI;
     at least 148 tracked, unaligned ATE-RMSE at most 0.0625 m), the same
     prefix by the synchronous system (the same bars); frames 60-159
     profiled by `device_budget.run_windowed` ("other" under 10 % of the
     device time, `render_gray` in nmi_render, B1 and B2 in nmi_score,
     the replayed step in tracking_fused_step, the idle share); the async
     replay's last frame drawn, its map plotted, and the debug overlays of
     one `relocalize_strategy` named by each sweep's argmax;
 13. the sharded paths (`orbslam2_nmi_torch/parallel/`) on worlds of ranks
     spawned from this process (`MC_WORLDS`): a NCCL world of one rank on
     cuda:0, and worlds of 2 and 4 gloo ranks sharing the card (a check of
     the partition, pads included, not a scaling figure), each on four
     problems at full width: the mesh NMI search of the grid step (960x540,
     27 x 27), the splat NMI search of the localizer's pointcloud case (a)
     (125 x 27 on 2,211,835 points), a local BA's (C, P) = (8, 2048) and an
     essential graph at V 424; every rank's result equal, each held against
     the unsharded call on the card (`MC_*` bars), each rank's launches of
     B1, B2 and `render_gray` once a mesh grid, and of B1, B2, `splat_scatter`
     and `splat_resolve` once a splat grid; the sharded and the
     unsharded call timed in turns in the one-rank world; then
     `entry.dryrun_multichip(2)` on two gloo ranks;
 14. prints a JSON line of the step times, one of the localizer's, one of the
     tracking phase's, one of the mapping phase's, one of the loop phase's,
     one of the system phase's, one of the settings phase's, one of the
     tools phase's, one of the
     multichip phase's, one JSON line listing the kernels, then the final
     JSON line {"ok": true, ...}.
The grid step and the localizer's case (b) also run with TF32 turned on for
the whole process, and must give the same scores and pose (fault C1).
Any failed check raises, and the script exits non-zero without the final
line. It also exits non-zero when CUDA is absent or the package is missing.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

# Tolerances (kernel vs plain version, both on the card).
ENTROPY_ATOL = 1e-5  # exact integer histograms; only the f64 sum order and logf differ
RASTER_MISMATCH_FRAC = 1e-4  # hit mask, u, v: same f32 operations, so expected bit for bit
RASTER_DEPTH_LEVELS = 2  # depth bits (key >> 11) where both hit
SAMPLER_ATOL = 0.0  # render_gray vs the sampler's plain version on the same z-buffer: bit for bit
SCORE_ATOL = 1e-5  # [S, R] scores, kernels vs all-plain

# The tracking phase: frames 8-55 of the 520-frame circuit (frames 6 and 7 seed),
# and its bar on every frame's camera-center error (the reference's own online
# maximum on the whole circuit with a real map was 0.0625 m, FULL_CIRCUIT_r05.json).
TRACK_FIRST, TRACK_COUNT, TRACK_CIRCUIT = 8, 48, 520
TRACK_ERR_M = 0.05
# The first frame's step on the card against the CPU, each bar just above the
# readings at 960x540 on an H100 (keypoints equal, 5.1e-5 of descriptor bits,
# counts equal, Tcw 1.3e-6): the CUDA cumsum's order moves the angles.
TRACK_CPU_DESC_BITS = 1e-4
TRACK_CPU_COUNT_GAP = 1
TRACK_CPU_TCW = 5e-6

# The mapping phase: frames 0 and 8 initialize, 9-68 are tracked (keyframes at
# 18, 28, ..., 68), and the bar on every frame's camera-centre error is the
# reference's own online maximum on the circuit (0.0625 m, FULL_CIRCUIT_r05.json).
MAP_LAST = 68
MAP_ERR_M = 0.0625
# The last keyframe's local BA on the card against the CPU. The bar comes
# from `orbslam2_nmi_torch/tools/ba_parity.py` over 42 BA problems (36 local)
# of 6 mapping runs on an H100 (NVIDIA H100 80GB HBM3, 700 W): one LM step
# from the problem's start at damping 1 moves the cameras within
# MAP_BA_STEP_POSE of the CPU's (readings 4.5e-8 to 1.43e-6; with the Schur
# products as float32 matmuls under TF32, the fault this guards against,
# 9.8e-6 to 1.5e-3). At the loop's own damping (1e-4) the weakly
# constrained points amplify the devices' different summation orders as much
# as TF32 does, so that step is printed, not held. Neither is the whole
# solve: its LM decisions part in 36 of the 42 (29 where one device's Schur
# matrix failed its Cholesky factorization and the other's did not, 7 at
# cost ties within 3e-7), after which the points whose depth the problem
# leaves free drift apart (up to 12.4 m; the CPU on inputs moved by one
# ulp, 24 m) and the final robust costs differ by up to 7.4 % (TF32, 7.6 %).
# It must not raise the robust cost (final over start: 0.70 to 0.95 in
# every local solve).
MAP_BA_STEP_POSE = 3.5e-6

# The loop phase: the PnP relocalization of frame 500 (the pose of frame 28.2)
# against the map of frames 0-68, and the bars on its error to truth and on
# the card against the CPU on the same matches and samples. Each bar sits
# above the gaps this script measured on an H100 (NVIDIA H100 80GB HBM3,
# 700 W), beside the CPU's own gap when the inputs move by one float32 ulp,
# which is what a threshold tie (one inlier more or less) costs:
#   PnP Tcw: 4.5e-5, 7.5e-6, 8.3e-6 and 1.6e-3 with equal inlier counts (the
#     pose-only LM's accept decisions part); the one-ulp control 4.8e-4,
#     2.3e-3, 7.9e-6 and 2.3e-3; later runs 4.2e-4 to 2.1e-3, and once 5.4e-3
#     (inliers 594 against 587) with the one-ulp control at 5.4e-3: the map
#     PnP runs on differs from run to run, and the gap follows the CPU's own
#     one-ulp gap. The bar is 5e-3 or twice that control, as the system
#     phase holds its classic frame;
#   ComputeSim3 of the closing pair: every count equal; Scw 1.43e-6, 6.6e-7;
#     the one-ulp control 1.5e-5, 1.4e-5;
#   the essential graph of the closure: 9.5e-7 twice; the one-ulp control
#     9.5e-7, 1.9e-6.
LOOP_PNP_FRAME = 500
LOOP_PNP_ERR_M = 0.1
LOOP_PNP_TCW = 5e-3
LOOP_PNP_ULP = 2.0
LOOP_SIM3_COUNTS = 2  # raw, RANSAC, expanded, optimized and total matches: ties only
LOOP_SIM3_SCW = 1e-5
LOOP_EG_SCW = 3e-6
ARC_DRIFT_TEXT = "scale 1.04, 0.03 rad about world z, (0.5, -0.3, 0.1) m"
# The keyframe count of the JAX package's live loop run
# (LOOP_r05.json full_feature_run.n_keyframes_created), for one timed
# optimize_pose_graph.
LOOP_PG_V = 424

# Peak rates of one H100 SXM (NVIDIA data sheet, at the 700 W limit), for bounds.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12  # f32 outside the tensor cores; also used for int increments


def _bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / SCALAR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


class tf32_on:
    """Turn TF32 on for the whole process inside the block, restoring the
    flags after."""

    def __enter__(self):
        import torch

        self.flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True

    def __exit__(self, *exc):
        import torch

        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.flags


def _raster_tests(raster, b, poses, K, near):
    """The (pixel, triangle) coverage tests that this run's data needs: for
    each candidate, each tile's live triangles (valid, past `near`, not
    degenerate) against the tile's pixel centers inside the triangle's screen
    bounding box; no pixel outside it can be covered."""
    import torch

    td = b.tri_data.double()
    tile = torch.arange(td.shape[0], device=td.device, dtype=torch.float64)
    ox = (torch.remainder(tile, b.tiles_x) * raster.TILE_W + 0.5)[:, None]
    oy = (torch.div(tile, b.tiles_x, rounding_mode="floor") * raster.TILE_H + 0.5)[:, None]
    fx, fy, cx, cy = (float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2]))
    total = 0
    for m in poses.double():
        xs, ys, zs = [], [], []
        for k in range(3):
            X, Y, Z = td[:, 3 * k], td[:, 3 * k + 1], td[:, 3 * k + 2]
            zc = m[6] * X + m[7] * Y + m[8] * Z + m[11]
            zp = zc.clamp(min=1e-6)
            xs.append(fx * (m[0] * X + m[1] * Y + m[2] * Z + m[9]) / zp + cx - ox)
            ys.append(fy * (m[3] * X + m[4] * Y + m[5] * Z + m[10]) / zp + cy - oy)
            zs.append(zc)
        x, y, z = torch.stack(xs), torch.stack(ys), torch.stack(zs)
        area2 = (x[1] - x[0]) * (y[2] - y[0]) - (x[2] - x[0]) * (y[1] - y[0])
        live = (td[:, 15] > 0.5) & (z.amin(0) > near) & (area2.abs() > 1e-9)
        nx = (x.amax(0).floor().clamp(max=raster.TILE_W - 1)
              - x.amin(0).ceil().clamp(min=0) + 1).clamp(min=0)
        ny = (y.amax(0).floor().clamp(max=raster.TILE_H - 1)
              - y.amin(0).ceil().clamp(min=0) + 1).clamp(min=0)
        total += int((nx * ny)[live].sum().item())
    return total


def _render_gray_bytes(b, poses, n_out):
    """The bytes `render_gray` must move: the triangle slab, the poses and
    the texture read once, `n_out` gray floats written once."""
    return (b.tri_data.numel() + poses.numel() + b.texture.numel() + n_out) * 4


def render_gray_check(check, args, what):
    """Hold `raster.render_gray(*args)` to its two bars
    (`kernel_cases.render_gray_gaps`): equal within SAMPLER_ATOL to the
    sampler's plain version on B3's keys epilogue's own outputs, and equal to
    the all-plain composition on all but RASTER_MISMATCH_FRAC of pixels.
    Returns the gaps."""
    from orbslam2_nmi_torch import kernel_cases

    g = kernel_cases.render_gray_gaps(args)
    print(f"  {what}: render_gray against the plain sampling of the keys epilogue's outputs: "
          f"max |diff| {g['exact']}; against all-plain: pixels differing {g['mismatch']}, "
          f"max |diff| {g['err']}")
    check(g["exact"] <= SAMPLER_ATOL, f"{what}: render_gray within {SAMPLER_ATOL} of the plain "
          "sampling of the keys epilogue's outputs")
    check(g["mismatch"] <= RASTER_MISMATCH_FRAC, f"{what}: render_gray equals the all-plain "
          f"composition on all but {RASTER_MISMATCH_FRAC} of pixels")
    return g


def _plain_nmi(synth, warped, use_background):
    """[S, R] SUC scores of renders x warps with B1 and B2 replaced by their
    plain versions."""
    from orbslam2_nmi_torch.ops import histogram_nmi as hn

    a, w = hn.pack_bins(synth), hn.pack_bins(warped)
    P = a.shape[1]
    if not use_background:
        Hab, Ha, Hb = hn.joint_entropy_grid_plain(a, w, P, mask_zero=True)
        return hn._combine_pairwise(Ha, Hb, Hab, "SUC")
    Ha, Hb = hn.marginal_entropy_sets_plain(a, w, P).split([a.shape[0], w.shape[0]])
    return hn._combine(Ha, Hb, hn.joint_entropy_grid_plain(a, w, P), "SUC")


def _all_plain_scores(b, Tcw, K, offsets, near, warped, use_background):
    """[S, R] scores of a binned mesh's translation grid against `warped`,
    every kernel replaced by its plain version (on the inputs' device)."""
    from orbslam2_nmi_torch.ops import raster

    img = raster.render_gray_plain(
        b.tri_data, raster.grid_poses(Tcw, offsets), b.capacity, float(K[0, 0]),
        float(K[1, 1]), float(K[0, 2]), float(K[1, 2]), near, b.tiles_x, b.texture,
        *b.tex_hw, 0.0, b.height, b.width)
    return _plain_nmi(img, warped, use_background)


def keep_sweeps(loc):
    """Wrap `loc.prepare_sweep` so that it keeps the newest sweep it made, the
    inputs that `plain_rescore` re-scores; `del loc.prepare_sweep` unwraps.
    Returns the list that holds it."""
    kept = []
    prepare = loc.prepare_sweep

    def prep(*a, **kw):
        kept[:] = [prepare(*a, **kw)]
        return kept[0]

    loc.prepare_sweep = prep
    return kept


def _same_binning(dev, host):
    """Whether a binning on the card equals the host's (numpy) bit for bit:
    lists, slab, mesh arrays, capacity, overflow and tile counts."""
    import numpy as np

    from orbslam2_nmi_torch.ops import raster

    scalars = ("tex_hw", "tiles_y", "tiles_x", "height", "width", "capacity", "overflow")
    if [getattr(dev, k) for k in scalars] != [getattr(host, k) for k in scalars]:
        return False
    for k in raster._ARRAY_FIELDS:
        a, b = np.asarray(getattr(dev, k).cpu()), getattr(host, k)
        if a.dtype != b.dtype or a.shape != b.shape or not np.array_equal(a.view(np.int32),
                                                                          b.view(np.int32)):
            return False
    return True


def plain_rescore(loc, sw, Tcw, scores):
    """Score a localizer grid again on the inputs of its own sweep `sw`
    (offsets, warped frame; `keep_sweeps`) with every kernel replaced by its
    plain version, the binning included: a mesh is binned again on the host
    (`device=None`), which must equal the sweep's binning bit for bit, and
    the all-plain renders read the host's binning. Plain versions launch
    nothing, so the launch counts are untouched. Returns (max |scores -
    plain|, argmax, plain argmax, whether the binnings are equal; True for a
    point model)."""
    import numpy as np

    from orbslam2_nmi_torch.ops import raster

    warped = loc.warp_sweep(sw)
    use_bg = loc.cfg.use_background
    same = True
    if sw.binned is not None:
        host = raster.bin_mesh(loc.mesh, np.asarray(Tcw), sw.K, sw.height, sw.width,
                               loc.cfg.render_near, loc.cfg.render_far,
                               max_offset=np.abs(sw.offsets.cpu().numpy()).max(axis=0),
                               device=None)
        same = _same_binning(sw.binned, host)
        plain = _all_plain_scores(raster.to_device(host, sw.Tcw.device), sw.Tcw, sw.K,
                                  sw.offsets, loc.cfg.render_near, warped, use_bg)
    else:
        from orbslam2_nmi_torch.ops import render

        synth = _plain_splat_grid(loc.model, sw.Tcw, sw.K, sw.offsets, sw.height, sw.width,
                                  loc.cfg.render_near, loc.cfg.render_far, sw.point_size)
        plain = _plain_nmi(synth, warped, use_bg)
    plain = plain.cpu().numpy()
    return float(np.abs(scores - plain).max()), int(scores.argmax()), int(plain.argmax()), same


def _plain_splat_grid(model, Tcw, K, offsets, height, width, near, far, point_size):
    """`render_translation_grid` by the plain torch splat, on any device."""
    from orbslam2_nmi_torch.ops import render

    keys = render.splat_keys_plain(model.points, model.gray, Tcw[:3, :3],
                                   Tcw[:3, 3][None, :] - offsets, K, height, width, near, far)
    return render.resolve_keys_plain(keys, point_size, 0.0)


# The point splat's kernels at the deployment's shapes: the ZU-MAV camera and
# grid (slambench/configs/zumav_cloud.json) over the terrain sampled at
# 400 points/m^2, from the circuit's first pose.
SPLAT_DENSITY = 400.0
SPLAT_K = ((435.04593205, 0.0, 475.55781765), (0.0, 435.04593205, 274.7487729), (0.0, 0.0, 1.0))
SPLAT_STEP = (0.2, 0.2, 0.5)
SPLAT_POINT_SIZE = 3


def splat_kernels(dev, smi, check, cuda_ms):
    """Phase 6's first part: `splat_scatter` and `splat_resolve` against the
    plain torch splat on the card, bit for bit (the key buffer, then the
    images), and their times beside their byte bounds, the plain path's and
    `scatter_reduce_`'s alone on the plain path's in-view candidates. Returns
    the two kernels' rows (their launches are counted by the localizer's run)."""
    import numpy as np
    import torch

    from orbslam2_nmi_torch.io.synthetic import SyntheticMeshWorld
    from orbslam2_nmi_torch.ops import render

    world = SyntheticMeshWorld.generate()
    model = render.model_from_pointcloud(render.mesh_to_points(world.mesh, SPLAT_DENSITY), dev)
    P = model.points.shape[0]
    K = np.array(SPLAT_K, np.float32)
    Hh, Ww, near, far = 540, 960, 5.0, 30.0
    T = torch.as_tensor(world.pose_at(0, 520), dtype=torch.float32, device=dev)
    offsets = render.translation_grid_offsets((3, 3, 3), SPLAT_STEP, device=dev)
    S = offsets.shape[0]
    R, t_all = T[:3, :3], T[:3, 3][None, :] - offsets
    kargs = (model.points, model.gray, R, t_all, K, Hh, Ww, near, far)
    keys = render.splat_keys(*kargs)
    plain = render.splat_keys_plain(*kargs)
    n_key = int((keys != plain).sum())
    err_key = int((keys.to(torch.int64) - plain.to(torch.int64)).abs().max())
    hit = float((plain < render._BIG).float().mean())
    img = render.resolve_keys(keys, SPLAT_POINT_SIZE, 0.0)
    img_plain = render.resolve_keys_plain(plain, SPLAT_POINT_SIZE, 0.0)
    n_img = int((img != img_plain).sum())
    err_img = float((img - img_plain).abs().max())
    print(f"  {S} renders of {P} points at {Ww}x{Hh}: keys differing {n_key} (max |gap| "
          f"{err_key}), pixels differing {n_img} (max |gap| {err_img}, point size "
          f"{SPLAT_POINT_SIZE}); keys landed on {hit:.4f} of the buffer")
    check(n_key == 0 and n_img == 0, "splat_scatter and splat_resolve equal the plain torch "
          "splat bit for bit, key buffer and images")
    del plain, img_plain
    # the plain path's scatter-min alone on its in-view candidates' pixel
    # indices and keys (built as splat_keys_plain builds them, outside the timing)
    pix, key = render._splat_candidates(*kargs)
    in_view = key < render._BIG
    pix, key = pix[in_view], key[in_view]
    n_in_view = pix.numel()
    del in_view
    buf = torch.empty(S * Hh * Ww, dtype=torch.int32, device=dev)

    def scatter_only():
        buf.fill_(render._BIG)
        buf.scatter_reduce_(0, pix, key, "amin", include_self=True)

    n_out = S * Hh * Ww
    b_scatter, by_scatter = _bound_ms(16 * P + 4 * n_out, 25 * S * P)
    b_resolve, by_resolve = _bound_ms(8 * n_out, SPLAT_POINT_SIZE**2 * n_out)
    library_ms = cuda_ms(scatter_only)
    del pix, key, buf
    plain_ms = cuda_ms(lambda: _plain_splat_grid(model, T, K, offsets, Hh, Ww, near, far,
                                                 SPLAT_POINT_SIZE), reps=3, warmup=1)
    rows = {
        "splat_scatter": dict(
            ms=cuda_ms(lambda: render.splat_keys(*kargs)), bound_ms=b_scatter,
            bound_by=by_scatter, plain_ms=plain_ms, library_ms=library_ms,
            max_abs_err=float(err_key)),
        "splat_resolve": dict(
            ms=cuda_ms(lambda: render.resolve_keys(keys, SPLAT_POINT_SIZE, 0.0)),
            bound_ms=b_resolve, bound_by=by_resolve, plain_ms=plain_ms, library_ms=None,
            max_abs_err=err_img),
    }
    grid_ms = cuda_ms(lambda: render.render_translation_grid(model, T, K, offsets, Hh, Ww, near,
                                                             far, SPLAT_POINT_SIZE))
    whole, _ = _bound_ms(16 * P + 4 * n_out, 0)
    print(f"  splat_scatter (the fill and the kernel) {rows['splat_scatter']['ms']:.4f} ms, "
          f"bound {b_scatter:.4f} ms by {by_scatter}; splat_resolve "
          f"{rows['splat_resolve']['ms']:.4f} ms, bound {b_resolve:.4f} ms by {by_resolve}; "
          f"the whole grid render {grid_ms:.4f} ms against the splat's byte bound {whole:.4f} "
          f"ms; the plain torch splat {plain_ms:.3f} ms; scatter_reduce_ (with the fill) "
          f"alone on the plain path's {n_in_view} in-view candidates {library_ms:.4f} ms  "
          f"[{smi}]")
    for r in rows.values():
        r.update(points=P, renders=S, grid_ms=grid_ms, source="orbslam2_nmi_torch/csrc/splat.cu",
                 replaces="none (orbslam2_nmi_tpu/ops/render.py `_splat` is XLA ops)")
    return rows


def localizer_phases(dev, smi, cuda_ms, check):
    """Phases 5 and 6: the NMI localizer at 960x540 in both render modes.
    Returns their record for the JSON line."""
    import dataclasses

    import numpy as np
    import torch

    from orbslam2_nmi_torch import entry as entry_mod
    from orbslam2_nmi_torch import kernels
    from orbslam2_nmi_torch.geometry import se3
    from orbslam2_nmi_torch.slam.nmi import search_kernel as sk
    from orbslam2_nmi_torch.slam.nmi.localizer import NMILocalizer

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def wall_ms(fn, reps=3, warmup=1):
        """Mean ms of a call, by the host's clock with the device synchronized
        around each call."""
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            sync()
            t = time.perf_counter()
            fn()
            sync()
            times.append((time.perf_counter() - t) * 1e3)
        return sum(times) / reps, times

    def pose_error(T):  # (m, rad) against T_true = I
        Twc = np.linalg.inv(T.astype(np.float64))
        cos = np.clip((np.trace(Twc[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
        return float(np.linalg.norm(Twc[:3, 3])), float(np.arccos(cos))

    record = {"plain_checks": []}

    def plain_check(name, loc, sw, Tcw, kernel, scale, scores):
        """Score the grid again on its sweep's inputs (offsets, warped frame)
        with every kernel replaced by its plain version, the mesh binned on
        the host; the binning must equal the sweep's bit for bit, the scores
        agree within SCORE_ATOL, with the same argmax. Plain versions launch
        nothing, so the launch counts are untouched."""
        d, am, pm, same = plain_rescore(loc, sw, Tcw, scores)
        what = f"{name}, first {kernel.n_synth} x {kernel.n_warp} grid at {sw.width}x{sw.height}"
        binning = ("" if sw.binned is None else f", binning tiles {sw.binned.tiles_y}x"
                   f"{sw.binned.tiles_x}, capacity {sw.binned.capacity}, overflow "
                   f"{sw.binned.overflow}, equal to the host's {same}")
        print(f"  {what}{binning}: max |kernels - all-plain| {d}, argmax {am} vs {pm}, "
              f"best {scores.max():.6f}")
        check(same, f"{what}: the sweep's binning equals the host's bit for bit")
        check(d <= SCORE_ATOL and am == pm,
              f"{what}: kernels agree with the all-plain run within {SCORE_ATOL}, same argmax")
        record["plain_checks"].append(dict(case=name, renders=kernel.n_synth,
                                           warps=kernel.n_warp, scale=scale,
                                           max_abs_diff=d, argmax=am))

    def recorded(name, loc):
        """Record every grid evaluation of `loc`: (renders, warps, scale,
        best); hold the first grid of each (renders, warps, scale) against
        the all-plain run."""
        calls = []
        evaluate = loc.evaluate_grid
        kept = keep_sweeps(loc)

        def rec(frame, Tcw, kernel, scale=1):
            scores = evaluate(frame, Tcw, kernel, scale)
            shape = (kernel.n_synth, kernel.n_warp, scale)
            if shape not in [c[:3] for c in calls]:
                plain_check(name, loc, kept[0], Tcw, kernel, scale, scores)
            calls.append(shape + (float(scores.max()),))
            return scores

        loc.evaluate_grid = rec
        return calls

    def run_case(name, loc, frame, T, kw, mesh):
        """Drive one case with the launch counts set to 0 just before and
        read just after; check the counts and each grid shape against the
        all-plain run; time it."""
        calls = recorded(name, loc)
        sync()
        kernels.reset_launches()
        out = loc.relocalize_strategy(frame, T.copy(), **kw)
        sync()
        launches = dict(kernels.LAUNCHES)
        n = len(calls)
        print(f"  {name}: iterations {out.iterations}, {n} grids "
              f"{[c[:3] for c in calls]} (renders, warps, scale), relocalized "
              f"{out.relocalized}, nmi {out.nmi:.6f}, launches {launches}")
        check(n == len(out.previous_poses) and n > 0, f"{name}: one pose kept a grid")
        use_bg = loc.cfg.use_background
        want = {"joint_entropy": n, "marginal_entropy": n if use_bg else 0,
                "rasterize_keys": 0, "render_gray": n if mesh else 0,
                "bin_count": n if mesh else 0, "bin_fill": n if mesh else 0,
                "splat_scatter": 0 if mesh else n, "splat_resolve": 0 if mesh else n}
        check(launches == want, f"{name}: launches {want}, one a grid evaluation")
        del loc.evaluate_grid, loc.prepare_sweep  # the recorders
        ms, runs = wall_ms(lambda: loc.relocalize_strategy(frame, T.copy(), **kw))
        print(f"  {name}: {ms:.3f} ms a call (runs {[round(t, 3) for t in runs]}, after 1 "
              f"warm-up; {out.iterations} iterations, {n} grids)  [{smi}]")
        record[name] = dict(ms=ms, runs_ms=runs, iterations=out.iterations, grids=n,
                            nmi=out.nmi, relocalized=out.relocalized, launches=launches)
        return out, calls

    def split(loc, frame, T, kernel):
        """One sweep through the localizer's own stages, each timed alone:
        prepare (the frame and the mesh's binning, kernels on the card), render, warp
        (with its host homography build), score, readback, and the whole
        evaluate_grid."""
        st = {}
        st["prepare"], _ = wall_ms(lambda: loc.prepare_sweep(frame, T, kernel))
        sw = loc.prepare_sweep(frame, T, kernel)
        synth, warped = loc.render_sweep(sw), loc.warp_sweep(sw)
        st["render"] = cuda_ms(lambda: loc.render_sweep(sw), reps=5, warmup=1)
        st["warp"] = cuda_ms(lambda: loc.warp_sweep(sw), reps=5, warmup=1)
        st["score"] = cuda_ms(lambda: loc.score_sweep(synth, warped), reps=5, warmup=1)
        scores = loc.score_sweep(synth, warped)
        st["readback"], _ = wall_ms(lambda: scores.cpu())
        st["evaluate_grid"], _ = wall_ms(lambda: loc.evaluate_grid(frame, T, kernel))
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
            loc.evaluate_grid(frame, T, kernel)
            st["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        print(f"  one {kernel.n_synth} x {kernel.n_warp} sweep, ms: "
              + ", ".join(f"{k} {v:.3f}" for k, v in st.items())
              + "  (render, warp, score: CUDA events, mean of 5 after 1 warm-up; prepare, "
              f"readback, evaluate_grid: host clock, mean of 3)  [{smi}]")
        return st

    # --- phase 5: textured mesh -------------------------------------------------
    t_phase = time.perf_counter()
    print("localizer, textured mesh (render mode 1)")
    loc, frame, T_true = entry_mod.localizer_entry(device=dev)
    H, W = loc.height, loc.width
    check(not np.any(T_true - np.eye(4)), "the frame is rendered at T_true = I")
    step = loc.cfg.grid.synth_step[0]
    T_pert = T_true.copy()
    T_pert[0, 3] = -step  # the camera moved +step along its x axis
    T_rot = T_true.copy()
    T_rot[:3, :3] = se3.euler_zyx(torch.tensor([0.0, 0.03, 0.0])).numpy()
    print(f"  {W}x{H}, translation step {step} m, threshold {loc.cfg.threshold}")

    t0, _ = pose_error(T_pert)
    out, _ = run_case("(a) initialization", loc, frame, T_pert, dict(initializing=True), True)
    t1, _ = pose_error(out.Tcw)
    check(out.relocalized and t1 <= 0.5 * t0, f"(a) translation error {t1:.5f} <= 0.5 x {t0:.5f}")
    _, r0 = pose_error(T_rot)
    out, _ = run_case("(b) rotation only", loc, frame, T_rot,
                      dict(dist_since=(1e-4,) * 3, rot_since=(1.5,) * 3), True)
    _, r1 = pose_error(out.Tcw)
    check(out.relocalized and out.num_synth == (1, 1, 1) and r1 <= 0.7 * r0,
          f"(b) rotation-only kernel, rotation error {r1:.6f} <= 0.7 x {r0:.6f}")
    with tf32_on():  # fault C1: TF32 on for the whole process changes nothing
        out_tf32 = loc.relocalize_strategy(frame, T_rot.copy(), dist_since=(1e-4,) * 3,
                                           rot_since=(1.5,) * 3)
    d_tf32 = float(np.abs(out_tf32.Tcw - out.Tcw).max())
    check(d_tf32 == 0.0 and out_tf32.nmi == out.nmi,
          f"(b) with TF32 on: Tcw max |diff| {d_tf32} and the same score as the default run")
    record["tf32_case_b_tcw_gap"] = d_tf32
    loc_c = NMILocalizer(dataclasses.replace(loc.cfg, coarse_scale=2), loc.camera, None,
                         mesh=loc.mesh, device=dev)
    out, calls = run_case("(c) coarse_scale=2", loc_c, frame, T_pert, dict(initializing=True),
                          True)
    t1, _ = pose_error(out.Tcw)
    check(out.relocalized and t1 <= 0.5 * t0, f"(c) translation error {t1:.5f} <= 0.5 x {t0:.5f}")
    check([c[2] for c in calls] == [2] * (len(calls) - 1) + [1] and out.nmi == calls[-1][3],
          "(c) coarse sweeps at 1/2 resolution, and the accepted score is the final "
          "full-resolution sweep's")
    noise = torch.from_numpy(np.random.default_rng(9).uniform(0, 255, (H, W))
                             .astype(np.float32)).to(dev)
    out, _ = run_case("(d) uniform-noise frame", loc, noise, T_pert, dict(initializing=True),
                      True)
    check(out.failed and not out.relocalized and out.Tcw.tobytes() == T_pert.tobytes(),
          "(d) failed, and Tcw returned equal to the input byte for byte")
    k0 = sk.initial_kernel_for_init(loc.initial_kernel)
    record["sweep_a_mesh"] = split(loc, frame, T_pert, k0)

    print(f"  phase took {time.perf_counter() - t_phase:.1f} s")

    # --- phase 6: pointcloud ----------------------------------------------------
    t_phase = time.perf_counter()
    print("localizer, pointcloud (render mode 4)")
    record["splat_kernels"] = splat_kernels(dev, smi, check, cuda_ms)
    loc4, frame4, _ = entry_mod.localizer_entry(device=dev, render_mode=4)
    n_points = loc4.model.points.shape[0]
    print(f"  {n_points} points (mesh_to_points of the toy mesh), frame coverage "
          f"{(frame4 > 0).float().mean().item():.4f}")
    out, calls = run_case("(a) initialization, pointcloud", loc4, frame4, T_pert,
                          dict(initializing=True), False)
    for name, r in record["splat_kernels"].items():  # launches a grid, as counted there
        r["launches"] = record["(a) initialization, pointcloud"]["launches"][name] / len(calls)
    t1, _ = pose_error(out.Tcw)
    check(out.relocalized and t1 <= 0.5 * t0, f"(a) pointcloud: translation error {t1:.5f} <= "
          f"0.5 x {t0:.5f}")
    record["sweep_a_pointcloud"] = split(loc4, frame4, T_pert, k0)
    record["points"] = n_points
    print(f"  phase took {time.perf_counter() - t_phase:.1f} s")
    return record


def tracking_phase(dev, smi, check, check_raster):
    """Phase 7: the per-frame tracking front-end at the full circuit's
    configuration (960x540, 2,000 features, 2,048 candidates), seeded from
    ground truth. Returns its record for the JSON line."""
    import numpy as np
    import torch

    from orbslam2_nmi_torch import kernel_cases, kernels
    from orbslam2_nmi_torch.entry import tracking_entry
    from orbslam2_nmi_torch.io.synthetic import SyntheticMeshWorld
    from orbslam2_nmi_torch.ops import raster
    from orbslam2_nmi_torch.slam.fused_track import FusedTrackStep, TrackCarry, unpack_step

    t_phase = time.perf_counter()
    print("tracking front-end (slam/fused_track.FusedTrackStep), seeded from ground truth")
    kernels.reset_launches()
    step, frames, carry, candidates, poses = tracking_entry(device=dev, first=TRACK_FIRST,
                                                            count=TRACK_COUNT)
    n = len(frames)
    t_entry = time.perf_counter() - t_phase
    print(f"  {frames.shape[2]}x{frames.shape[1]}, {n} frames from {TRACK_FIRST} of a "
          f"{TRACK_CIRCUIT}-frame circuit, {step.n_feat} features, {step.n_cand} candidates; "
          f"tracking_entry (rendering {n + 2} frames, seeding) {t_entry:.1f} s")
    check(frames.shape == (TRACK_COUNT, 540, 960) and frames.dtype == torch.uint8
          and step.n_feat == 2000 and step.n_cand == 2048, "the full circuit's configuration")

    def center(T):
        return -T[:3, :3].T.astype(np.float64) @ T[:3, 3].astype(np.float64)

    def sync():
        torch.cuda.synchronize(dev)

    # --- the chain: each frame's carry feeds the next, candidates at the last estimate
    rec = {k: [] for k in ("eager_ms", "graph_ms", "cand_ms", "upload_ms", "readback_ms",
                           "unpack_ms", "err_m", "n_matches1", "n_inliers")}
    stages = {k: [] for k in ("extract", "motion_match", "gn1", "local_match", "gn2", "pack")}
    first_args = None
    T_last = carry.Tcw.cpu().numpy()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
    for i in range(n):
        t = time.perf_counter()
        arrays = candidates.candidate_arrays(T_last)
        t1 = time.perf_counter()
        cand = candidates.upload(arrays)
        sync()
        t2 = time.perf_counter()
        args = (frames[i], carry, *cand)
        if first_args is None:
            first_args = (frames[i], carry, arrays)
        out = step(*args)  # the first call captures the graph; every call replays
        sync()
        t3 = time.perf_counter()
        buf = out.packed.cpu().numpy()
        t4 = time.perf_counter()
        u = unpack_step(buf, step.n_feat, step.n_cand)
        t5 = time.perf_counter()
        err = float(np.linalg.norm(center(u.Tcw) - center(poses[i])))
        print(f"  frame {TRACK_FIRST + i}: matches1 {u.n_matches1}, inliers1 {u.n_inliers1}, "
              f"inliers {u.n_inliers}, candidates in view {int(u.cand_in_view.sum())}, "
              f"camera-center error {err:.4f} m")
        check(u.n_matches1 >= 20 and u.n_inliers >= 10,
              f"frame {TRACK_FIRST + i} passes the gate (matches1 >= 20, inliers >= 10)")
        rec["err_m"].append(err)
        rec["n_matches1"].append(u.n_matches1)
        rec["n_inliers"].append(u.n_inliers)
        if i >= 2:  # two warm-up frames
            rec["cand_ms"].append((t1 - t) * 1e3)
            rec["upload_ms"].append((t2 - t1) * 1e3)
            rec["readback_ms"].append((t4 - t3) * 1e3)
            rec["unpack_ms"].append((t5 - t4) * 1e3)
            # the step eagerly, stage by stage between events, then replayed
            ev[0].record()
            feats = step.extract(frames[i])
            ev[1].record()
            m1 = step.motion_match(feats, carry)
            ev[2].record()
            r1 = step.pose(m1.Tp, m1.pts, feats, m1.bound & feats.valid)
            ev[3].record()
            m2 = step.local_match(feats, r1.Tcw, m1.bound, *cand)
            ev[4].record()
            all_pts = torch.where(m1.bound[:, None], m1.pts, m2.pts)
            r2 = step.pose(r1.Tcw, all_pts, feats, (m1.bound | m2.bound) & feats.valid)
            ev[5].record()
            staged = step.finish(feats, carry, m1, r1, m2, r2)
            ev[6].record()
            ev[6].synchronize()
            for k, (a, b) in zip(stages, zip(ev[:-1], ev[1:])):
                stages[k].append(a.elapsed_time(b))
            rec["eager_ms"].append(ev[0].elapsed_time(ev[6]))
            check(torch.equal(staged.packed.view(torch.int32), out.packed.view(torch.int32)),
                  f"frame {TRACK_FIRST + i}: the eager step, stage by stage, equals the "
                  "step's output bit for bit")
            ev[0].record()
            step.replay(*args)
            ev[1].record()
            ev[1].synchronize()
            rec["graph_ms"].append(ev[0].elapsed_time(ev[1]))
        carry = out.carry
        T_last = u.Tcw
    launches = dict(kernels.LAUNCHES)
    print(f"  launches (rendering and the chain): {launches}")
    check(launches["render_gray"] == n + 2 and launches["rasterize_keys"] == 0,
          f"render_gray launched once a rendered frame ({n + 2}), B3's keys epilogue never")
    errs = np.array(rec["err_m"])
    print(f"  camera-center error over {n} frames: median {np.median(errs):.5f} m, "
          f"max {errs.max():.5f} m")
    check(errs.max() < TRACK_ERR_M, f"camera-center error under {TRACK_ERR_M} m on every frame")
    check(step._graph is not None, "the step was captured in a CUDA graph on its first call")

    # --- B3 and render_gray against their plain versions at the circuit's binning
    world = SyntheticMeshWorld.generate(seed=0)
    W, H = frames.shape[2], frames.shape[1]
    K = world.camera_K(W, H)
    near, far = world.near_far()
    T = world.pose_at(TRACK_FIRST, TRACK_CIRCUIT)
    bh = raster.bin_mesh(world.mesh, T, K, H, W, near, far, device=None)
    bt = bh._replace(tri_data=torch.from_numpy(bh.tri_data).to(dev),
                     texture=torch.from_numpy(bh.texture).to(dev))
    kposes = raster.grid_poses(torch.from_numpy(T).to(dev), torch.zeros((1, 3), device=dev))
    rargs = (bt.tri_data, kposes, bt.capacity, float(K[0, 0]), float(K[1, 1]), float(K[0, 2]),
             float(K[1, 2]), near, bt.tiles_x)
    keys, uu, vv = raster.rasterize_keys(*rargs)
    d_raster = kernel_cases.raster_mismatch((keys, uu, vv), raster.rasterize_keys_plain(*rargs))
    check_raster(d_raster, f"frame {TRACK_FIRST}'s binning ({len(world.mesh.faces)} faces, "
                 f"tiles {bt.tiles_y}x{bt.tiles_x}, capacity {bt.capacity}, overflow "
                 f"{bt.overflow}), {keys.numel()} pixels")
    th, tw = bt.tex_hw
    g = render_gray_check(check, (*rargs, bt.texture, th, tw, 0.0, H, W),
                          f"frame {TRACK_FIRST}'s binning ({th}x{tw} texture)")
    err_s = g["exact"]
    raster_check = dict(capacity=bt.capacity, tiles=[bt.tiles_y, bt.tiles_x],
                        raster_err=d_raster["err"], render_gray_err=err_s,
                        render_gray_mismatch=g["mismatch"],
                        mismatch={k: d_raster[k] for k in ("mask", "u", "v", "depth")})
    del keys, uu, vv

    # --- eager against graph, bit for bit, on three frames --------------------
    c = first_args[1]
    for i in range(3):
        cand = candidates(poses[i])
        args = (frames[i], c, *cand)
        e = step.run_eager(*args)
        g = step.replay(*args)
        check(torch.equal(e.packed.view(torch.int32), g.packed.view(torch.int32))
              and all(torch.equal(a, b) for a, b in zip(e.carry, g.carry)),
              f"frame {TRACK_FIRST + i}: eager and graph replay equal bit for bit")
        c = e.carry

    # --- sync-free ------------------------------------------------------------
    args = (frames[3], c, *candidates(poses[2]))
    sync()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step.run_eager(*args)
        step.replay(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sync()
    check(True, "one eager step and one replay ran under set_sync_debug_mode('error')")

    # --- TF32 on globally: the same pose ----------------------------------------
    base = step.run_eager(*args)
    with tf32_on():
        tf32 = step.run_eager(*args)
    d_tf32 = float((tf32.carry.Tcw - base.carry.Tcw).abs().max())
    check(d_tf32 <= 1e-6, f"TF32 on globally: Tcw within 1e-6 of the default run ({d_tf32})")

    # --- the card against the CPU, first frame --------------------------------
    frame0, carry0, arrays0 = first_args
    cpu = FusedTrackStep(step.cfg, step.n_cand, "cpu")
    t = time.perf_counter()
    out_h = cpu(frame0.cpu(), TrackCarry(*(x.cpu() for x in carry0)),
                *(torch.from_numpy(a) for a in arrays0))
    cpu_s = time.perf_counter() - t
    out_c = step(frame0, carry0, *candidates(carry0.Tcw.cpu().numpy()))
    uc = unpack_step(out_c.packed.cpu().numpy(), step.n_feat, step.n_cand)
    uh = unpack_step(out_h.packed.numpy(), step.n_feat, step.n_cand)
    kp = np.concatenate([uc.xy, uc.octave[:, None]], 1) != np.concatenate(
        [uh.xy, uh.octave[:, None]], 1)
    bits = np.unpackbits(np.bitwise_xor(uc.desc, uh.desc).view(np.uint8)).sum()
    vs = dict(
        keypoint_share=float(kp.any(1).mean()),
        desc_bit_share=float(bits / (uc.desc.size * 32)),
        angle_gap=float(np.abs(uc.angle - uh.angle).max()),
        n_matches1_gap=uc.n_matches1 - uh.n_matches1,
        n_inliers_gap=uc.n_inliers - uh.n_inliers,
        tcw_gap=float(np.abs(uc.Tcw - uh.Tcw).max()),
        cpu_step_s=cpu_s,
    )
    print(f"  card against CPU, frame {TRACK_FIRST}: keypoints (x, y, octave) differ on "
          f"{vs['keypoint_share']:.6f}, descriptor bits on {vs['desc_bit_share']:.3e}, "
          f"angles by up to {vs['angle_gap']:.3e} rad; matches1 gap {vs['n_matches1_gap']}, "
          f"inliers gap {vs['n_inliers_gap']}, max |Tcw gap| {vs['tcw_gap']:.3e} "
          f"(CPU step {cpu_s:.1f} s)")
    check(vs["keypoint_share"] == 0.0, "card against CPU: keypoints (x, y, octave) equal")
    check(vs["desc_bit_share"] <= TRACK_CPU_DESC_BITS,
          f"card against CPU: descriptor bits differ on <= {TRACK_CPU_DESC_BITS}")
    check(abs(vs["n_matches1_gap"]) <= TRACK_CPU_COUNT_GAP
          and abs(vs["n_inliers_gap"]) <= TRACK_CPU_COUNT_GAP,
          f"card against CPU: matches1 and inliers within {TRACK_CPU_COUNT_GAP}")
    check(vs["tcw_gap"] <= TRACK_CPU_TCW, f"card against CPU: Tcw within {TRACK_CPU_TCW}")

    # --- rendering one frame and its host binning, apart from the step -------------
    def host_ms(fn, reps=5):
        """ms of each of `reps` calls after one warm-up, by the host's clock
        with the device synchronized around each call."""
        fn()
        times = []
        for _ in range(reps):
            sync()
            t = time.perf_counter()
            fn()
            sync()
            times.append((time.perf_counter() - t) * 1e3)
        return times

    bin_runs = host_ms(lambda: raster.bin_mesh(world.mesh, T, K, H, W, near, far, device=None))
    card_bin_runs = host_ms(lambda: raster.bin_mesh(world.mesh, T, K, H, W, near, far, device=dev))
    render_runs = host_ms(lambda: world.render_frames([TRACK_FIRST], TRACK_CIRCUIT, W, H,
                                                      device=dev))
    bin_ms, render_ms = float(np.mean(bin_runs)), float(np.mean(render_runs))

    mean = {k: float(np.mean(v)) for k, v in rec.items() if k not in ("err_m", "n_matches1",
                                                                      "n_inliers")}
    stage_ms = {k: float(np.mean(v)) for k, v in stages.items()}
    print(f"  step ms, mean over frames {TRACK_FIRST + 2}-{TRACK_FIRST + n - 1} (CUDA events): "
          f"eager {mean['eager_ms']:.3f}, replayed {mean['graph_ms']:.3f}; eager by stage: "
          + ", ".join(f"{k} {v:.3f}" for k, v in stage_ms.items()) + f"  [{smi}]")
    print(f"  host ms a frame: candidate build {mean['cand_ms']:.3f}, upload "
          f"{mean['upload_ms']:.3f}, readback {mean['readback_ms']:.3f}, unpack_step "
          f"{mean['unpack_ms']:.3f}  [{smi}]")
    print(f"  rendering one frame (render_frames: host binning, upload, render_gray), ms: mean "
          f"{render_ms:.3f} (runs {[round(t, 3) for t in render_runs]}); its host binning "
          f"alone (bin_mesh): mean {bin_ms:.3f} (runs {[round(t, 3) for t in bin_runs]}); "
          f"the same binning on the card (bin_count, bin_fill): mean "
          f"{float(np.mean(card_bin_runs)):.3f} (runs {[round(t, 3) for t in card_bin_runs]}); "
          f"each after 1 warm-up  [{smi}]")
    print(f"  phase took {time.perf_counter() - t_phase:.1f} s")
    return dict(frames=n, first=TRACK_FIRST, err_median_m=float(np.median(errs)),
                err_max_m=float(errs.max()), n_matches1_min=int(min(rec["n_matches1"])),
                n_inliers_min=int(min(rec["n_inliers"])), step_ms=mean, stage_ms=stage_ms,
                render_ms=render_ms, render_runs_ms=render_runs, bin_ms=bin_ms,
                bin_runs_ms=bin_runs, raster_check=raster_check, launches=launches,
                tf32_tcw_gap=d_tf32, card_vs_cpu=vs)


def mapping_phase(dev, smi, check, cuda_ms):
    """Phase 8: NMI initialization and local mapping on the full-circuit replay
    configuration at 960x540 (`entry.mapping_entry`). Returns its record for
    the JSON line."""
    import threading

    import numpy as np
    import torch

    from orbslam2_nmi_torch import kernels, native
    from orbslam2_nmi_torch.entry import INIT_FRAMES, loop_entry
    from orbslam2_nmi_torch.ops import histogram_nmi as hn
    from orbslam2_nmi_torch.ops import raster
    from orbslam2_nmi_torch.slam.frontend_pipelined import local_candidates, upload_candidates
    from orbslam2_nmi_torch.solvers import local_ba
    from orbslam2_nmi_torch.tools import ba_parity

    t_phase = time.perf_counter()
    print("mapping: NMI initialization and local mapping (entry.mapping_entry)")
    rec = {}

    def sync():
        torch.cuda.synchronize(dev)

    def center(T):
        return -T[:3, :3].T.astype(np.float64) @ T[:3, 3].astype(np.float64)

    def pose_error(T, T_true):  # (m, rad)
        R = T[:3, :3].astype(np.float64) @ T_true[:3, :3].T.astype(np.float64)
        ang = float(np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)))
        return float(np.linalg.norm(center(T) - center(T_true))), ang

    rec["mapcore"] = native.path()
    print(f"  mapcore: {rec['mapcore']} (built into build/native/)")
    check(rec["mapcore"] == "native", "the native map core is live, not the numpy fallback")

    # --- render frames 0, 8-68 of the circuit -----------------------------------
    kernels.reset_launches()
    t = time.perf_counter()
    session = loop_entry(device=dev, last=MAP_LAST)
    sync()
    rec["entry_s"] = time.perf_counter() - t
    launches = dict(kernels.LAUNCHES)
    n_render = len(session.frame_ids)
    cfg, m, lm = session.cfg, session.map, session.local_mapper
    tcfg = cfg.tracking
    print(f"  {cfg.camera.width}x{cfg.camera.height}, fx {cfg.camera.fx}, "
          f"{len(session.world.mesh.faces)} faces, {cfg.orb.n_features} features on "
          f"{cfg.orb.n_levels} levels, {session.step.n_cand} candidates; capacities "
          f"{tcfg.max_keyframes} keyframes, {tcfg.max_map_points} points, {tcfg.max_features} "
          f"features; NMI offset {cfg.nmi.offset}, threshold {cfg.nmi.threshold}, coarse_scale "
          f"{cfg.nmi.coarse_scale}; {n_render} frames rendered in {rec['entry_s']:.1f} s "
          f"(launches {launches})")
    check((cfg.camera.width, cfg.camera.height, cfg.orb.n_features, session.step.n_cand,
           tcfg.max_keyframes, tcfg.max_map_points, tcfg.max_features)
          == (960, 540, 2000, 2048, 512, 131072, 2048), "the replay's configuration, uncut")
    check(launches["render_gray"] == n_render and launches["rasterize_keys"] == 0,
          f"render_gray launched once a rendered frame ({n_render}), B3's keys epilogue never")

    # --- NMI initialization: two latches, each first grid of a shape all-plain ----
    loc = session.localizer
    latch_no = [0]
    seen, grids, plain = set(), [], []
    evaluate, strategy = loc.evaluate_grid, loc.relocalize_strategy
    kept = keep_sweeps(loc)

    def rec_strategy(*a, **kw):
        latch_no[0] += 1
        return strategy(*a, **kw)

    def rec_grid(frame, Tcw, kernel, scale=1):
        scores = evaluate(frame, Tcw, kernel, scale)
        key = (latch_no[0], kernel.n_synth, kernel.n_warp, scale)
        grids.append(key)
        if key not in seen:
            seen.add(key)
            sw = kept[0]
            d, am, pm, same = plain_rescore(loc, sw, Tcw, scores)
            b = sw.binned
            print(f"  latch {key[0]}: first {key[1]} x {key[2]} grid at {sw.width}x{sw.height}, "
                  f"binning tiles {b.tiles_y}x{b.tiles_x}, capacity {b.capacity}, overflow "
                  f"{b.overflow}, equal to the host's {same}: max |kernels - all-plain| {d}, "
                  f"argmax {am} vs {pm}")
            check(same, f"latch {key[0]}, {key[1]} x {key[2]} at scale {scale}: the sweep's "
                  "binning equals the host's bit for bit")
            check(d <= SCORE_ATOL and am == pm, f"latch {key[0]}, {key[1]} x {key[2]} at scale "
                  f"{scale}: kernels agree with the all-plain run within {SCORE_ATOL}, same "
                  "argmax")
            plain.append(dict(latch=key[0], renders=key[1], warps=key[2], scale=scale,
                              max_abs_diff=d, argmax=am))
        return scores

    loc.evaluate_grid, loc.relocalize_strategy = rec_grid, rec_strategy
    kernels.reset_launches()
    init = session.initialize()
    sync()
    launches = dict(kernels.LAUNCHES)
    del loc.evaluate_grid, loc.relocalize_strategy, loc.prepare_sweep
    n = len(grids)
    print(f"  initialization launches: {launches}, {n} grid evaluations")
    rec["init_launches"] = launches
    check(n > 0 and launches == {"joint_entropy": n, "marginal_entropy": n, "rasterize_keys": 0,
                                 "render_gray": n, "bin_count": n, "bin_fill": n,
                                 "splat_scatter": 0, "splat_resolve": 0},
          "the binning, B1, B2 and render_gray launched once a grid evaluation inside the "
          "latches, B3's keys epilogue never")
    check(init.ok, f"the map was initialized ({init.n_matches} matches, {init.n_points} points)")
    latched = [f.Tcw.copy() for f in session.init_frames]
    rec["latches"] = []
    for j, (i, out) in enumerate(zip(INIT_FRAMES, init.latches)):
        T_true = session.true_pose(i)
        e0 = pose_error(session.seed_pose(i), T_true)
        e1 = pose_error(out.Tcw, T_true)
        frame = session.frame(i)
        seed = session.seed_pose(i)
        strategy(frame.to(torch.float32), seed.copy(), initializing=True)  # warm
        runs = []
        for _ in range(3):
            sync()
            t = time.perf_counter()
            strategy(frame.to(torch.float32), seed.copy(), initializing=True)
            sync()
            runs.append((time.perf_counter() - t) * 1e3)
        print(f"  latch {j + 1} (frame {i}): seed error {e0[0]:.4f} m; latched error "
              f"{e1[0]:.5f} m, {e1[1]:.5f} rad; score {out.nmi:.5f}, relocalized "
              f"{out.relocalized}, iterations {out.iterations}; {np.mean(runs):.2f} ms a latch "
              f"(runs {[round(r, 2) for r in runs]}, after 1 warm-up)  [{smi}]")
        check(out.relocalized, f"latch {j + 1} accepted (score >= {cfg.nmi.threshold})")
        rec["latches"].append(dict(frame=i, err_m=e1[0], err_rad=e1[1], seed_err_m=e0[0],
                                   nmi=out.nmi, iterations=out.iterations,
                                   ms=float(np.mean(runs)), runs_ms=runs))
    rec["latch_plain_checks"] = plain
    g = lm.last_gba
    perr = session.point_errors(init.k1)
    print(f"  init map: {init.n_matches} matches, {init.n_points} points kept; global BA "
          f"(20 iterations) {g['solve_ms']:.1f} ms at (C, P, O) = ({g['C']}, {g['P']}, "
          f"{g['O']}); distance to the ray-cast oracle: median {np.median(perr):.4f} m, 90th "
          f"percentile {np.percentile(perr, 90):.4f} m  [{smi}]")
    check(init.n_points >= 15, "at least 15 init points (the reference's abort bar)")
    rec["init"] = dict(matches=init.n_matches, points=init.n_points, gba=g,
                       oracle_median_m=float(np.median(perr)),
                       oracle_p90_m=float(np.percentile(perr, 90)))

    def anchors_fixed():
        with m.lock:
            return all(np.array_equal(m.kf_Tcw[k], T) for k, T in zip((init.k1, init.k2),
                                                                        latched))

    check(anchors_fixed(), "both NMI keyframes hold their latched poses after the global BA")

    # --- tracking against the map, keyframes to the worker --------------------
    frames = []
    anchors_ok = True
    for i in session.track_ids:
        r = session.track_frame(i)
        frames.append(r)
        anchors_ok &= anchors_fixed()
        print(f"  frame {i}: matches1 {r['n_matches1']}, inliers {r['n_inliers']}, candidates "
              f"{r['n_cand']}, error {r['err_m']:.4f} m"
              + (f", keyframe {r['keyframe']}" if r["keyframe"] >= 0 else "")
              + (", reseeded" if r["reseed"] else "") + (", worker busy" if r["worker_busy"]
                                                          else ""))
    session.flush()
    anchors_ok &= anchors_fixed()
    ba_prob = lm._last_prob  # the last keyframe's local BA as the worker solved it
    errs = np.array([r["err_m"] for r in frames])
    print(f"  camera-centre error over {len(frames)} frames: median {np.median(errs):.5f} m, "
          f"max {errs.max():.5f} m; host ms a frame: candidates "
          f"{np.mean([r['cand_ms'] for r in frames]):.3f}, step with upload and readback "
          f"{np.mean([r['step_ms'] for r in frames]):.3f}, binding and keyframes "
          f"{np.mean([r['process_ms'] for r in frames]):.3f}  [{smi}]")
    records = lm.records
    t0 = frames[0]["t_end"]
    for r in records:
        ba = r["ba"] or {}
        print(f"  keyframe {r['kf']}: stats and culling {r['stats_cull_ms']:.1f} ms, new points "
              f"{r['create_ms']:.1f} ms ({r['created']} created), fuse {r['fuse_ms']:.1f} ms, "
              f"local BA {r['ba_ms']:.1f} ms (device solve {ba.get('solve_ms', 0):.1f} ms at "
              f"(C, P, O) = ({ba.get('C')}, {ba.get('P')}, {ba.get('O')}), {ba.get('n_obs')} "
              f"observations, {ba.get('free')} free and {ba.get('fixed')} fixed cameras, "
              f"{ba.get('dropped')} dropped, Hcp_blocks {ba.get('hcp_bytes', 0) / 2**20:.1f} MiB), "
              f"{r['culled_kfs']} keyframes culled; total {r['total_ms']:.1f} ms, from "
              f"{r['t_start'] - t0:.3f} s to {r['t_end'] - t0:.3f} s after frame "
              f"{frames[0]['frame']}  [{smi}]")
    failed = [r["frame"] for r in frames if not r["passed"]]
    check(not failed, f"every frame passes the gate (matches1 >= 20, inliers >= 10): {failed}")
    check(errs.max() <= MAP_ERR_M, f"camera-centre error max <= {MAP_ERR_M} m")
    check(not session.pipeline.errors(), "the mapping worker reported no error")
    check(len(session.keyframes) == 6 and len(records) == 6,
          f"6 keyframes made and processed by the worker ({len(records)})")
    check(anchors_ok, "the NMI keyframes' poses equal the latched poses, bit for bit, after "
          "every frame and BA")
    sysm = session.system
    vr = sysm.vocab_record
    check(vr is not None, "the vocabulary trained during the mapping phase (ensure_vocabulary)")
    lc_recs = sysm.loop_closer.records
    print(f"  vocabulary: {vr['words']} words (k=8, depth 4) from {vr['descriptors']} "
          f"descriptors, trained in {vr['train_s']:.3f} s ({vr['total_s']:.3f} s with the "
          f"database's backfill) on thread '{vr['thread']}' at frame {vr['frame']} "
          f"({vr['keyframes']} keyframes then); the worker's loop closer then processed "
          f"{len(lc_recs)} keyframes (no detection below 10 keyframes), database add "
          f"{np.mean([r['db_add_ms'] for r in lc_recs]) if lc_recs else 0:.2f} ms a keyframe  "
          f"[{smi}]")
    with m.lock:
        in_db = [int(k) for k in m.valid_keyframe_indices() if sysm.database.active[k]]
    check(in_db == [int(k) for k in m.valid_keyframe_indices()],
          f"every mapped keyframe is in the database ({len(in_db)})")
    rec["vocabulary"] = dict(vr, db_add_ms=[r["db_add_ms"] for r in lc_recs])
    rec["tracking"] = dict(frames=len(frames), err_median_m=float(np.median(errs)),
                           err_max_m=float(errs.max()),
                           n_matches1_min=int(min(r["n_matches1"] for r in frames)),
                           n_inliers_min=int(min(r["n_inliers"] for r in frames)),
                           cand_ms=float(np.mean([r["cand_ms"] for r in frames])),
                           step_wall_ms=float(np.mean([r["step_ms"] for r in frames])),
                           process_ms=float(np.mean([r["process_ms"] for r in frames])),
                           map_points=int(m.mp_valid[: m.n_points].sum()),
                           keyframes=int(m.kf_valid[: m.n_keyframes].sum()))
    rec["keyframes"] = records

    # --- the replayed step with the worker idle, and beside a local BA ---------
    step = session.step
    with m.lock:
        kfs = np.nonzero(m.kf_valid[: m.n_keyframes])[0]
        ids, arrays = local_candidates(m, session.cfg, kfs, session.ref_kf, session.last.Tcw,
                                       step.n_cand)
    args = (session.frame(session.track_ids[-1]), session.carry,
            *upload_candidates(arrays, session.device))
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def replay_ms(busy=None, n=10, cap=200):
        """ms of step replays by CUDA events: `n` of them, or with `busy`,
        each that starts and ends while busy() holds (at most `cap`)."""
        times = []
        while len(times) < (n if busy is None else cap):
            if busy is not None and not busy():
                break
            ev[0].record()
            step.replay(*args)
            ev[1].record()
            ev[1].synchronize()
            if busy is None or busy():
                times.append(ev[0].elapsed_time(ev[1]))
        return times

    idle = replay_ms()
    k_last = session.keyframes[-1][1]
    for _ in range(3):
        session.pipeline.insert_ba(k_last, m.epoch)
    on_worker = replay_ms(busy=lambda: not session.pipeline.idle())
    session.flush()
    t_ba = threading.Thread(target=lm.local_bundle_adjust, args=(k_last,))
    t_ba.start()  # a local BA on the default stream, from another thread
    on_default = replay_ms(busy=t_ba.is_alive)
    t_ba.join()
    stat = lambda x: (float(np.mean(x)) if x else None)  # noqa: E731
    print(f"  step replayed (CUDA events): worker idle {stat(idle):.3f} ms (n={len(idle)}); "
          f"beside a local BA on the worker's stream {stat(on_worker) or 0:.3f} ms "
          f"(n={len(on_worker)}); beside a local BA on the default stream "
          f"{stat(on_default) or 0:.3f} ms (n={len(on_default)})  [{smi}]")
    rec["step_replay_ms"] = dict(idle=stat(idle), worker_stream=stat(on_worker),
                                 default_stream=stat(on_default), n_worker=len(on_worker),
                                 n_default=len(on_default))

    # --- one recorded local BA: the card against the CPU, and TF32 ------------
    prob = ba_prob
    card = local_ba.bundle_adjust(prob)
    again = local_ba.bundle_adjust(prob)
    with tf32_on():
        tf32 = local_ba.bundle_adjust(prob)
    same = all(torch.equal(a, b) for a, b in zip(card, again))
    d_tf32 = max(float((a.float() - b.float()).abs().max()) for a, b in zip(card, tf32))
    traced, card_tr = ba_parity.lm_solve(prob)
    traced_same = all(torch.equal(a, b) for a, b in zip(card, traced))
    cpu_prob = ba_parity.to_device(prob, "cpu")
    t = time.perf_counter()
    cpu, cpu_tr = ba_parity.lm_solve(cpu_prob)
    cpu_s = time.perf_counter() - t
    g = ba_parity.gaps(card, cpu, cpu_prob)
    part = ba_parity.first_part(card_tr["accepted"], cpu_tr["accepted"])
    cause = ba_parity.part_cause(card_tr, cpu_tr, part)
    cost = {k: ba_parity.robust_cost(cpu_prob, r) for k, r in (
        ("start", local_ba.BAResult(prob.cam_Tcw, prob.pts_w, None, None)), ("card", card),
        ("cpu", cpu))}
    cost_rel = (cost["card"] - cost["cpu"]) / cost["cpu"]
    ref_steps = ba_parity.one_steps(cpu_prob)
    steps = ba_parity.step_gaps(ba_parity.one_steps(prob), ref_steps, cpu_prob)
    with ba_parity.tf32_schur():
        control = ba_parity.step_gaps(ba_parity.one_steps(prob), ref_steps, cpu_prob)
    held = ba_parity.STEP_LAMS.index(1.0)
    O = int(prob.obs_valid.sum())
    gaps = dict(pose=g["pose"], point=g["point"], inlier_mismatch=g["inlier_mismatch"],
                cost=cost, cost_rel=cost_rel,
                accept_card=ba_parity.decisions_string(card_tr["accepted"]),
                accept_cpu=ba_parity.decisions_string(cpu_tr["accepted"]), part_cause=cause,
                steps=steps,
                tf32_schur_steps=control, tf32_gap=d_tf32, repeat_equal=same, cpu_s=cpu_s,
                shape=[prob.cam_Tcw.shape[0], prob.pts_w.shape[0], prob.obs_cam.shape[0]],
                observations=O)
    print(f"  local BA at (C, P, O) = {tuple(gaps['shape'])} ({O} observations), card against "
          f"CPU: LM decisions card {gaps['accept_card']}, CPU {gaps['accept_cpu']} (part: "
          f"{cause}); whole solve: max pose gap {g['pose']:.3e}, max point gap {g['point']:.3e} "
          f"m, inlier mismatches {g['inlier_mismatch']}, robust cost start {cost['start']:.1f}, "
          f"card {cost['card']:.1f}, CPU {cost['cpu']:.1f} ({cost_rel:+.3%}); one step (damping, "
          "max pose gap, reprojection p99 px) "
          + ", ".join(f"({s['lam']:g}, {s['pose']}, {s['pix_p99']})" for s in steps)
          + "; the TF32-Schur control "
          + ", ".join(f"({s['lam']:g}, {s['pose']}, {s['pix_p99']})" for s in control)
          + f"; repeated on the card bit for bit {same}; TF32 on max |diff| {d_tf32} (CPU solve "
          f"{cpu_s:.1f} s)")
    check(same and traced_same, "a local BA repeats bit for bit on the card, traced or not")
    check(d_tf32 == 0.0, "a local BA with TF32 on: max |diff| 0 against the default run")
    s1 = steps[held]
    check(s1["finite"] and s1["finite_ref"] and s1["pose"] <= MAP_BA_STEP_POSE,
          f"one LM step at damping 1, card against CPU: max pose gap {s1['pose']} <= "
          f"{MAP_BA_STEP_POSE}")
    check(cost["card"] <= cost["start"], "the card's local BA does not raise the robust cost")
    rec["ba_card_vs_cpu"] = gaps

    # --- the kernels at the terrain's latch shapes ------------------------------
    f0 = session.frame(INIT_FRAMES[0]).to(torch.float32)
    from orbslam2_nmi_torch.slam.nmi import search_kernel as sk

    k0 = sk.initial_kernel_for_init(loc.initial_kernel)
    sw = loc.prepare_sweep(f0, latched[0], k0, cfg.nmi.coarse_scale)
    b = sw.binned
    poses = raster.grid_poses(sw.Tcw, sw.offsets)
    K = sw.K
    rargs = (b.tri_data, poses, b.capacity, float(K[0, 0]), float(K[1, 1]), float(K[0, 2]),
             float(K[1, 2]), cfg.nmi.render_near, b.tiles_x)
    synth = loc.render_sweep(sw)
    warped = loc.warp_sweep(sw)
    S, R, P = synth.shape[0], warped.shape[0], sw.height * sw.width
    sb, wb = hn.pack_bins(synth), hn.pack_bins(warped)
    th, tw = b.tex_hw
    n_pix = S * b.tri_data.shape[0] * raster.TILE_H * raster.TILE_W
    n_tests = _raster_tests(raster, b, poses, K, cfg.nmi.render_near)
    gargs = (*rargs, b.texture, th, tw, 0.0, b.height, b.width)
    rec["latch_render_gray"] = render_gray_check(
        check, gargs, f"the first latch's coarse sweep ({S} renders at {b.width}x{b.height}, "
        f"tiles {b.tiles_y}x{b.tiles_x})")
    shapes = {}
    for name, fn, nb, no in (
            ("rasterize_keys", lambda: raster.rasterize_keys(*rargs),
             b.tri_data.numel() * 4 + poses.numel() * 4 + 3 * n_pix * 4, n_tests * 10),
            ("render_gray", lambda: raster.render_gray(*gargs),
             _render_gray_bytes(b, poses, S * b.height * b.width),
             n_tests * 10 + 20 * S * b.height * b.width),
            ("marginal_entropy", lambda: hn.marginal_entropy_sets(sb, wb, P),
             (S + R) * P + (S + R) * 4, (S + R) * P),
            ("joint_entropy", lambda: hn.joint_entropy_grid(sb, wb, P),
             (S + R) * P + S * R * 4, S * R * P)):
        bound, by = _bound_ms(nb, no)
        shapes[name] = dict(ms=cuda_ms(fn, reps=5, warmup=1), bound_ms=bound, bound_by=by)
    print(f"  kernels at the first latch's coarse sweep ({S} renders x {R} warps at "
          f"{sw.width}x{sw.height}, tiles {b.tiles_y}x{b.tiles_x}, capacity {b.capacity}), ms: "
          + ", ".join(f"{k} {v['ms']:.4f} (bound {v['bound_ms']:.4f} by {v['bound_by']})"
                      for k, v in shapes.items()) + f"  [{smi}]")
    rec["kernels_at_latch_shapes"] = dict(renders=S, warps=R, width=sw.width, height=sw.height,
                                          **shapes)
    print(f"  phase took {time.perf_counter() - t_phase:.1f} s")
    return rec, session


def loop_phase(dev, smi, check, session):
    """Phase 9: place recognition and loop closing on the mapping phase's map
    (`entry.loop_entry`, 960x540). Returns its record for the JSON line."""
    import numpy as np
    import torch

    from orbslam2_nmi_torch import convert, kernels
    from orbslam2_nmi_torch.entry import INIT_FRAMES, add_revisit_arc, relocalize_pnp
    from orbslam2_nmi_torch.slam.checkpoint import _MAP_FIELDS
    from orbslam2_nmi_torch.slam.loop_closing import LoopCloser
    from orbslam2_nmi_torch.solvers import pnp, pose_graph
    from orbslam2_nmi_torch.utils.readback import to_host

    t_phase = time.perf_counter()
    print("loop: place recognition and loop closing (entry.loop_entry, add_revisit_arc)")
    rec = {}
    m, cfg, sysm = session.map, session.cfg, session.system
    lc = sysm.loop_closer
    world, n_frames = session.world, session.n_frames
    cpu = torch.device("cpu")

    def sync():
        torch.cuda.synchronize(dev)

    def center(T):
        return -T[:3, :3].T.astype(np.float64) @ T[:3, 3].astype(np.float64)

    def twin(i):  # the frame of the circuit's first lap at frame i's pose
        return i - (n_frames - 1) / (1.0 + world.overlap)

    def up(d, device):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in d.items()}

    def max_gap(a, b):
        return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())

    # --- PnP: relocalize frame 500 against the map of frames 0-68 ---------------
    img = world.render_frames([LOOP_PNP_FRAME], n_frames, cfg.camera.width, cfg.camera.height,
                              device=dev)[0]
    t = time.perf_counter()
    tries = relocalize_pnp(session, LOOP_PNP_FRAME, frame=img)
    sync()
    pnp_ms = (time.perf_counter() - t) * 1e3
    got = [r for r in tries if r.get("ok")]
    print(f"  PnP of frame {LOOP_PNP_FRAME} (the pose of frame {twin(LOOP_PNP_FRAME):.1f}): "
          f"candidates tried " + ", ".join(
              f"KF {r['cand']} (frame {r['frame']}): {r['matches']} matches"
              + (f", {r['n_inliers']} inliers" if "n_inliers" in r else "") for r in tries)
          + f"; {pnp_ms:.1f} ms in all  [{smi}]")
    check(bool(got), "a relocalization candidate gave a PnP pose (>= 15 matches, >= 10 "
          "inliers)")
    r = got[0]
    T_true = world.pose_at(LOOP_PNP_FRAME, n_frames)
    pnp_err = float(np.linalg.norm(center(r["Tcw"]) - center(T_true)))
    inp = r["inputs"]

    def pnp_on(device, inputs=inp):
        d = up(inputs, device)
        res = pnp.pnp_ransac(d["samples"], cfg.camera.K, d["pts_w"], d["uv"], d["inv_sigma2"],
                             d["valid"], min_inliers=10)
        return to_host(res.Tcw), int(to_host(res.n_inliers))

    T_cpu, n_cpu = pnp_on(cpu)
    T_ulp, _ = pnp_on(cpu, dict(inp, pts_w=np.nextafter(inp["pts_w"], np.float32(np.inf))))
    with tf32_on():
        T_tf32, _ = pnp_on(dev)
    g_pnp, g_ulp, g_tf = max_gap(r["Tcw"], T_cpu), max_gap(T_cpu, T_ulp), max_gap(T_tf32, r["Tcw"])
    print(f"  PnP pose: camera-centre error {pnp_err:.4f} m against truth; card against CPU "
          f"(same matches and samples) max |Tcw gap| {g_pnp:.3e}, inliers {r['n_inliers']} vs "
          f"{n_cpu}; the CPU on points moved by one ulp {g_ulp:.3e}; TF32 on {g_tf}")
    check(pnp_err < LOOP_PNP_ERR_M, f"PnP camera-centre error {pnp_err:.4f} < {LOOP_PNP_ERR_M} m")
    check(g_pnp <= max(LOOP_PNP_TCW, LOOP_PNP_ULP * g_ulp), f"PnP Tcw, card against CPU: "
          f"{g_pnp:.3e} <= max({LOOP_PNP_TCW}, {LOOP_PNP_ULP} x {g_ulp:.3e})")
    check(g_tf == 0.0, "PnP with TF32 on: max |diff| 0")
    rec["pnp"] = dict(frame=LOOP_PNP_FRAME, tries=[{k: x[k] for k in ("cand", "frame", "matches",
                                                                      "n_inliers", "ok") if k in x}
                                                    for x in tries],
                      err_m=pnp_err, ms=pnp_ms, cpu_gap=g_pnp, ulp_gap=g_ulp, tf32_gap=g_tf)

    # --- the revisit arc ------------------------------------------------------
    with m.lock:
        n_old = int(m.n_keyframes)
        old_frames = [int(m.kf_frame_id[k]) for k in range(n_old)]
        init_T = {k: m.kf_Tcw[k].copy() for k in range(n_old) if m.kf_nmi_reloc[k]}
    kernels.reset_launches()
    t = time.perf_counter()
    arc = add_revisit_arc(session)
    sync()
    arc_s = time.perf_counter() - t
    launches = dict(kernels.LAUNCHES)
    print(f"  revisit arc: frames {[i for i, _ in arc]} as keyframes {[k for _, k in arc]} with "
          f"drift {ARC_DRIFT_TEXT}; {arc_s:.2f} s (rendering, features, points); launches "
          f"{launches}")
    check(launches["render_gray"] == len(arc) and launches["rasterize_keys"] == 0,
          "render_gray launched once an arc frame, B3's keys epilogue never")

    def arc_errors():
        with m.lock:
            return [float(np.linalg.norm(center(m.kf_Tcw[k]) - center(world.pose_at(i, n_frames))))
                    for i, k in arc]

    def repeated_pairs():  # (keyframe, point) pairs bound more than once in a keyframe
        n = 0
        with m.lock:
            for k in m.valid_keyframe_indices():
                ps = m.kf_mp_idx[k][m.kf_mp_idx[k] >= 0]
                n += len(ps) - len(np.unique(ps))
            return n, int((m.kf_mp_idx[: m.n_keyframes] >= 0).sum())

    with m.lock:
        old_obs = [k for _, k in arc if (np.isin(m.kf_mp_idx[k][m.kf_mp_idx[k] >= 0],
                                                 m.kf_mp_idx[:n_old])).any()]
    check(not old_obs, "no arc keyframe observes a point of frames 0-68")
    err0 = arc_errors()
    c2_before = repeated_pairs()
    snap = {}
    compute = lc._compute_sim3

    def recorded_compute(k, cand):  # keep the inputs of the call that accepts
        with m.lock:
            fields = {f: getattr(m, f).copy() for f in _MAP_FIELDS}
            fields.update(n_keyframes=m.n_keyframes, n_points=m.n_points)
        gen = lc.generator.get_state()
        out = compute(k, cand)
        if out[0]:
            snap.update(k=k, cand=cand, fields=fields, gen=gen, rec=dict(lc._rec),
                        Scw=out[1].copy(), matched=out[2].copy())
        return out

    lc._compute_sim3 = recorded_compute
    lc.covisibility_consistency_th = 3
    closed, proc_ms, c2_after = [], [], None
    try:
        for i, k in arc:
            t = time.perf_counter()
            with m.lock:
                if lc.process_keyframe(k):
                    closed.append((i, k))
                    c2_after = repeated_pairs()  # after loop fusion and SearchAndFuse
            proc_ms.append((time.perf_counter() - t) * 1e3)
    finally:
        del lc._compute_sim3
    t = time.perf_counter()
    session.flush()  # waits for the global BA's thread
    gba_wait_s = time.perf_counter() - t
    arc_recs = lc.records[-len(arc):]
    err1 = arc_errors()
    for (i, k), r, ms in zip(arc, arc_recs, proc_ms):
        parts = r.get("correct_ms")
        print(f"  KF {k} (frame {i}, twin of {twin(i):.1f}): DetectLoop candidates "
              f"{r.get('db_candidates')}, consistent {r['candidates']}"
              + (f" ({r['detect_ms']:.2f} ms)" if "detect_ms" in r else "")
              + (f", ComputeSim3 {[round(x, 1) for x in r['sim3_ms']]} ms" if r["sim3_ms"] else "")
              + (f", closed with KF {r['closed_with']}" if r["closed_with"] >= 0 else "")
              + (", CorrectLoop ms " + ", ".join(f"{a} {b:.1f}" for a, b in parts.items())
                 if parts else "")
              + f", database add {r['db_add_ms']:.2f} ms; {ms:.1f} ms in all  [{smi}]")
    gb = session.pipeline.gba_records
    print(f"  global BAs: " + ", ".join(
        f"(C, P, O) = ({g['C']}, {g['P']}, {g['O']}) solve {g.get('solve_ms', 0):.1f} ms, "
        f"applied {g['applied']}" for g in gb) + f"; waited {gba_wait_s:.2f} s  [{smi}]")
    check(not session.pipeline.errors(), "the mapping worker and the global BA reported no error")
    check(len(closed) == 1, f"exactly one loop closed ({len(closed)})")
    i_c, k_c = closed[0]
    cand = arc_recs[[k for _, k in arc].index(k_c)]["closed_with"]
    print(f"  loop closed at KF {k_c} (frame {i_c}, twin of {twin(i_c):.1f}) with KF {cand} "
          f"(frame {old_frames[cand] if cand < n_old else -1}); arc camera-centre errors before "
          f"{[round(e, 4) for e in err0]} m, after {[round(e, 4) for e in err1]} m "
          f"(mean {np.mean(err0):.4f} -> {np.mean(err1):.4f} m)")
    check(cand < n_old and 0 <= old_frames[cand] <= MAP_LAST,
          "the loop closed against a keyframe of frames 0-68")
    check(np.mean(err1) < 0.5 * np.mean(err0), "the arc's mean camera-centre error after the "
          "correction is below half of what it was before")
    f = snap["fields"]
    own = (f["mp_first_kf"] == k_c) & f["mp_valid"]
    # the seam's duplicates: own points at the features that ComputeSim3
    # matched to a loop-side point (mvpCurrentMatchedPoints)
    row = f["kf_mp_idx"][k_c]
    dup = np.zeros_like(own)
    hit = (snap["matched"] >= 0) & (row >= 0)
    dup[row[hit]] = True
    dup &= own
    with m.lock:
        surviving = int((m.mp_valid & own).sum())
        dup_left = int((m.mp_valid & dup).sum())
        init_fixed = all(np.array_equal(m.kf_Tcw[k], T) for k, T in init_T.items())
    n_own, n_dup = int(own.sum()), int(dup.sum())
    print(f"  seam: ComputeSim3 matched {int((snap['matched'] >= 0).sum())} of the closing "
          f"keyframe's features to loop-side points, {n_dup} of them at its own points; "
          f"{dup_left} of those {n_dup} duplicates survive loop fusion, and {surviving} of all "
          f"its {n_own} own points (the loop side maps fewer points than the arc's dense "
          f"ray-cast landmarks); repeated (keyframe, point) pairs (C2) {c2_before[0]} of "
          f"{c2_before[1]} bound features before, {c2_after[0]} of {c2_after[1]} after loop "
          f"fusion")
    check(dup_left <= n_dup // 2, "at most half of the seam's duplicates (the closing "
          "keyframe's own points matched to loop-side points) survive loop fusion")
    check(init_fixed, f"the NMI keyframes {sorted(init_T)} did not move")
    rec["arc"] = dict(frames=[i for i, _ in arc], keyframes=[k for _, k in arc], build_s=arc_s,
                      closed_at=k_c, closed_frame=i_c, cand=cand, cand_frame=old_frames[cand],
                      err_before=err0, err_after=err1, records=arc_recs, process_ms=proc_ms,
                      gba=gb, surviving=surviving, own=n_own, duplicates=n_dup,
                      duplicates_left=dup_left, c2_before=c2_before,
                      c2_after=c2_after, sim3=snap["rec"])

    # --- ComputeSim3 of the closing pair: the card against the CPU --------------
    def sim3_on(device, nudge=False):
        fields = dict(snap["fields"])
        if nudge:
            fields["mp_pos"] = np.nextafter(fields["mp_pos"], np.float32(np.inf))
        mm = convert.map_store_from_fields(fields, cfg)
        c = LoopCloser(cfg, mm, None, None, device=device)
        c.generator.set_state(snap["gen"])
        c._rec = {}
        if device.type == "cuda":
            sync()
        t = time.perf_counter()
        out = c._compute_sim3(snap["k"], snap["cand"])
        if device.type == "cuda":
            sync()
        ms = (time.perf_counter() - t) * 1e3
        return out[0], (out[1] if out[0] else None), dict(c._rec, ms=ms)

    keys = ("raw_matches", "ransac_inliers", "expanded_matches", "opt_inliers", "total_matches")
    ok_d, S_d, r_d = sim3_on(dev)
    ok_c, S_c, r_c = sim3_on(cpu)
    ok_u, S_u, r_u = sim3_on(cpu, nudge=True)
    with tf32_on():
        ok_t, S_t, _ = sim3_on(dev)
    counts = {k: (r_d.get(k), r_c.get(k), r_u.get(k)) for k in keys}
    g_s = max_gap(S_d, S_c) if ok_d and ok_c else float("inf")
    g_su = max_gap(S_u, S_c) if ok_u and ok_c else float("inf")
    g_st = max_gap(S_t, S_d) if ok_t and ok_d else float("inf")
    d_counts = max(abs(a - b) for a, b, _ in counts.values())
    print(f"  ComputeSim3 (KF {snap['k']}, KF {snap['cand']}) on the same map and samples: accept "
          f"card {ok_d}, CPU {ok_c}; counts (card, CPU, CPU one ulp) {counts}; max |Scw gap| card "
          f"against CPU {g_s:.3e}, the CPU on points moved by one ulp {g_su:.3e}; TF32 on {g_st}; "
          f"scale {float(np.linalg.norm(snap['Scw'][:3, 0])):.4f}; a warm call {r_d['ms']:.1f} "
          f"ms on the card, {r_c['ms']:.1f} ms on the CPU  [{smi}]")
    check(ok_d and ok_c, "ComputeSim3 accepts on the card and on the CPU")
    check(d_counts <= LOOP_SIM3_COUNTS, f"match and inlier counts, card against CPU, within "
          f"{LOOP_SIM3_COUNTS} (threshold ties)")
    check(g_s <= LOOP_SIM3_SCW, f"Scw card against CPU {g_s:.3e} <= {LOOP_SIM3_SCW}")
    check(g_st == 0.0, "ComputeSim3 with TF32 on: max |diff| 0")
    rec["sim3_card_vs_cpu"] = dict(counts=counts, scw_gap=g_s, ulp_gap=g_su, tf32_gap=g_st,
                                   warm_ms=r_d["ms"], cpu_ms=r_c["ms"])

    # --- the essential graph of that closure: the card against the CPU ---------
    host = lc.last_pose_graph
    pg = {}
    pg_ms = {}
    for name, device, h in (("card", dev, host), ("cpu", cpu, host),
                            ("ulp", cpu, dict(host, Scw=np.nextafter(host["Scw"],
                                                                      np.float32(np.inf))))):
        prob = pose_graph.PoseGraphProblem(**up(h, device))
        sync()
        t = time.perf_counter()
        pg[name] = to_host(pose_graph.optimize_pose_graph(prob, iters=20))
        pg_ms[name] = (time.perf_counter() - t) * 1e3
    with tf32_on():
        pg["tf32"] = to_host(pose_graph.optimize_pose_graph(
            pose_graph.PoseGraphProblem(**up(host, dev)), iters=20))
    g_e, g_eu, g_et = (max_gap(pg["card"], pg["cpu"]), max_gap(pg["ulp"], pg["cpu"]),
                       max_gap(pg["tf32"], pg["card"]))
    V, E = host["Scw"].shape[0], host["edge_i"].shape[0]
    print(f"  essential graph (V {V}, E {E}, {int(host['fixed'].sum())} fixed): max |Scw gap| "
          f"card against CPU {g_e:.3e}, the CPU on poses moved by one ulp {g_eu:.3e}; TF32 on "
          f"{g_et}; finite {bool(np.isfinite(pg['card']).all())}; a warm solve {pg_ms['card']:.1f} "
          f"ms on the card, {pg_ms['cpu']:.1f} ms on the CPU  [{smi}]")
    check(bool(np.isfinite(pg["card"]).all()), "the essential-graph solution is finite")
    check(g_e <= LOOP_EG_SCW, f"essential graph card against CPU {g_e:.3e} <= {LOOP_EG_SCW}")
    check(g_et == 0.0, "the essential graph with TF32 on: max |diff| 0")
    rec["essential_graph"] = dict(V=V, E=E, gap=g_e, ulp_gap=g_eu, tf32_gap=g_et, ms=pg_ms)

    # --- optimize_pose_graph at V = 424: a chain and one loop edge, card and CPU -
    V = LOOP_PG_V
    gt = np.stack([world.pose_at(i, n_frames) for i in np.linspace(0, 471, V).round()
                   .astype(int)]).astype(np.float64)
    bias = np.eye(4)
    bias[:3, :3] = np.array([[1, -0.002, 0], [0.002, 1, 0], [0, 0, 1]])
    bias[:3, 3] = (0.01, 0.005, 0.0)
    est = [gt[0]]
    for j in range(1, V):
        est.append(bias @ gt[j] @ np.linalg.inv(gt[j - 1]) @ est[-1])
    est = np.stack(est)
    ei = np.concatenate([np.arange(V - 1), [0]]).astype(np.int32)
    ej = np.concatenate([np.arange(1, V), [V - 1]]).astype(np.int32)
    meas = np.stack([est[j] @ np.linalg.inv(est[i]) for i, j in zip(ei[:-1], ej[:-1])]
                    + [gt[V - 1] @ np.linalg.inv(gt[0])])
    big = dict(Scw=est.astype(np.float32), fixed=np.arange(V) == 0, valid=np.ones(V, bool),
               edge_i=ei, edge_j=ej, edge_Sji=meas.astype(np.float32),
               edge_valid=np.ones(V, bool))
    times = {}
    for name, device in (("card", dev), ("cpu", cpu)):
        prob = pose_graph.PoseGraphProblem(**up(big, device))
        runs = []
        for _ in range(3 if name == "card" else 1):
            if device.type == "cuda":
                sync()
            t = time.perf_counter()
            out = pose_graph.optimize_pose_graph(prob, iters=20)
            out = to_host(out)
            runs.append((time.perf_counter() - t) * 1e3)
        times[name] = dict(ms=runs, finite=bool(np.isfinite(out).all()),
                           end_err_m=float(np.linalg.norm(center(out[-1]) - center(gt[-1]))))
    e0 = float(np.linalg.norm(center(est[-1]) - center(gt[-1])))
    print(f"  optimize_pose_graph at V {V} (chain + one loop edge, 20 iterations): card "
          f"{[round(x, 1) for x in times['card']['ms']]} ms, CPU "
          f"{[round(x, 1) for x in times['cpu']['ms']]} ms ({os.cpu_count()} host cores, "
          f"{torch.get_num_threads()} torch threads); the last keyframe's "
          f"error {e0:.3f} -> {times['card']['end_err_m']:.3f} m (card), "
          f"{times['cpu']['end_err_m']:.3f} m (CPU)  [{smi}]")
    check(times["card"]["finite"], f"optimize_pose_graph at V {V} gives finite poses")
    rec["pose_graph_424"] = dict(times, start_err_m=e0)
    print(f"  phase took {time.perf_counter() - t_phase:.1f} s")
    return rec


# The system phase: the whole system (SLAMSystem, Tracker, PipelinedFrontend)
# over the seed-1 520-frame circuit of the JAX package's full-circuit record
# (FULL_CIRCUIT_r05.json, on a TPU v5e: 512 of 520 tracked, unaligned ATE-RMSE
# 0.0283 m, 42 NMI anchors, online error p50 0.0233 / p95 0.0444 / max 0.0625 m,
# 262 keyframes created, 54 surviving culling; BENCH_r05.json: no loop closure).
SYS_CHUNK = 40  # frames a PipelinedFrontend.run call (tools/circuit_diag.py:79-85)
SYS_MIN_TRACKED = 508  # frames 0-7 come before initialization
SYS_ATE_M = 0.0625  # the reference's own online maximum, PERF.md's mapping bar
# NMI anchors: at least half of the reference's 42. Anchors follow keyframes
# (every reloc_frequency-th), and a monocular keyframe wanted by c2 is refused
# while the mapper is busy (Tracking.cc:1290-1302). The reference's record was
# taken with its tracker at 1.35 frames/s (BENCH_r05.json), slower than its
# mapper; the port's tracks at 11-14 frames/s, its mapper takes ~0.7 s a
# keyframe, and most c2 keyframes meet a busy mapper, so its async drive makes
# few keyframes (orbslam2_nmi_torch/tools/circuit_diag.py). The bar is held on
# a second drive of the same circuit by the synchronous system (SLAMSystem's
# default: no workers, so the mapper is idle at every decision and each
# anchor lands at its keyframe; its outcome does not depend on thread
# timing), and printed beside the async drive's count.
SYS_MIN_ANCHORS = 21
SYS_REF = dict(tracked=512, keyframes_created=262, keyframes_surviving=54, anchors=42,
               ate_m=0.0283, err_p50_m=0.0233, err_p95_m=0.0444, err_max_m=0.0625,
               loop_closures=0)
SYS_BUDGET_MS = 1000.0 / 30.0  # a 30 fps camera
SYS_LOSS_FRAME = 48  # the induced loss: 3 noise frames, then frames 48 onward
SYS_LOSS_WITHIN = 3  # relocalized within this many real frames
SYS_RELOC_ERR_M = 0.1  # the loop phase's PnP bar (LOOP_PNP_ERR_M)
SYS_LOC_FRAMES = (100, 160)  # localization-only mode over frames 100-159
SYS_LOC_MIN = 56
SYS_CLASSIC_FRAME = 280  # the classic frame, card against CPU, from the state after 279
SYS_CLASSIC_TCW = 1e-4
SYS_CLASSIC_ULP = 2.0  # where the LM decisions part: the gap within 2x the one-ulp control


def system_phase(dev, smi, check):
    """Phase 10: the whole system on the seed-1 circuit (`entry.circuit_entry`,
    960x540, async mapping and async NMI) driven through
    `PipelinedFrontend.run` in chunks of 40 frames; then, on the same system,
    the capture of a tracking step beside both workers, one classic frame on
    the card against the CPU from the map and tracker state copied after
    frame 279 (the checkpoint's fields, in memory), an induced loss and
    relocalization, and localization-only mode. Returns its record for the
    JSON line."""
    import copy

    import numpy as np
    import torch

    from orbslam2_nmi_torch import convert, kernels
    from orbslam2_nmi_torch.entry import circuit_entry, circuit_system
    from orbslam2_nmi_torch.io.trajectory import ate_rmse, recompose_trajectory
    from orbslam2_nmi_torch.slam import checkpoint, fused_track
    from orbslam2_nmi_torch.slam.frontend_pipelined import PipelinedFrontend, local_candidates
    from orbslam2_nmi_torch.slam.map_store import MapStore
    from orbslam2_nmi_torch.slam.tracking import Tracker, TrackingState
    from orbslam2_nmi_torch.solvers import pnp
    from orbslam2_nmi_torch.tools import circuit_diag

    t_phase = time.perf_counter()
    print("system: SLAMSystem + Tracker + PipelinedFrontend on the seed-1 circuit "
          "(entry.circuit_entry)")
    rec = {}

    def sync():
        torch.cuda.synchronize(dev)

    def center(T):
        return -T[:3, :3].T.astype(np.float64) @ T[:3, 3].astype(np.float64)

    def stats(x):
        x = np.asarray(x, np.float64)
        return dict(p50=float(np.median(x)), p95=float(np.quantile(x, 0.95)), max=float(x.max()),
                    mean=float(x.mean()), n=int(len(x)))

    kernels.reset_launches()
    t = time.perf_counter()
    system, frames, poses = circuit_entry(device=dev)
    sync()
    rec["render_s"] = time.perf_counter() - t
    launches = dict(kernels.LAUNCHES)
    n = frames.shape[0]
    cfg, m, tr = system.cfg, system.map, system.tracker
    print(f"  {n} frames rendered on the card in {rec['render_s']:.1f} s ({tuple(frames.shape)} "
          f"uint8, {frames.numel() / 2**20:.0f} MiB; launches {launches})  [{smi}]")
    check(n == 520 and launches["render_gray"] == n and launches["rasterize_keys"] == 0,
          "render_gray launched once a rendered frame, B3's keys epilogue never")
    check((cfg.camera.width, cfg.camera.height, cfg.orb.n_features, cfg.nmi.offset,
           cfg.nmi.threshold, cfg.nmi.max_iteration_count, cfg.nmi.coarse_scale,
           cfg.nmi.reloc_frequency, cfg.tracking.max_frames, cfg.tracking.max_keyframes)
          == (960, 540, 2000, 8, 0.45, 4, 2, 2, 30, 512),
          "the reference's full-circuit configuration, uncut")
    check(system.pipeline is not None and system.nmi_worker is not None,
          "async mapping and async NMI are on")
    fe = PipelinedFrontend(system)
    sweeps = circuit_diag.record_sweeps(system, poses)
    ts = np.arange(n) / cfg.camera.fps
    results, snap = [], None
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        for c0 in range(0, n, SYS_CHUNK):
            c1 = min(c0 + SYS_CHUNK, n)
            if c0 == SYS_CLASSIC_FRAME:  # the state the classic frame starts from
                with m.lock:  # the checkpoint's fields, copied in memory
                    fields = {f: getattr(m, f).copy() for f in checkpoint._MAP_FIELDS}
                    fields.update(n_keyframes=m.n_keyframes, n_points=m.n_points)
                    snap = dict(fields=fields, state={k: copy.deepcopy(getattr(tr, k)) for k in (
                        "velocity", "last_frame", "ref_kf", "last_kf_frame_id")})
            results.extend(fe.run(frames[c0:c1], ts[c0:c1], start_id=c0))
        wall = time.perf_counter() - t0
        system.nmi_worker.flush(timeout=600.0)
        system.pipeline.flush(timeout=600.0)
        drained = time.perf_counter() - t0
    finally:
        errs = system.errors()
    launches = dict(kernels.LAUNCHES)
    check(not errs, "the mapping and NMI workers reported no error" + (f":\n{errs[0]}" if errs
                                                                       else ""))
    tracked = [i for i, r in enumerate(results)
               if r is not None and r.state == TrackingState.OK and r.Tcw is not None]
    online = np.array([np.linalg.norm(center(results[i].Tcw) - center(poses[i]))
                       for i in tracked])
    with m.lock:
        rows = recompose_trajectory(tr.trajectory, m)
        vk = m.valid_keyframe_indices()
        anchors = [int(f) for f, a in zip(m.kf_frame_id[vk], m.kf_nmi_reloc[vk]) if a]
        n_points = int(len(m.valid_point_indices()))
        created = int(m.n_keyframes)
        repeated = sum(len(ps) - len(np.unique(ps)) for ps in
                       (m.kf_mp_idx[k][m.kf_mp_idx[k] >= 0] for k in vk))
    ate = ate_rmse([r[2] for r in rows], [poses[r[0]] for r in rows], align=False)
    final = np.array([np.linalg.norm(center(r[2]) - center(poses[r[0]])) for r in rows])
    n_loops = len(system.loop_closer.loop_edges) if system.loop_closer is not None else 0
    walls = [fe.completion_walls[i] for i in sorted(fe.completion_walls)]
    dt = np.diff(np.asarray([t0] + walls)) * 1e3
    steady = dt[SYS_CHUNK:]
    fps = len(steady) / (steady.sum() / 1e3)
    recs = fe.records
    classic = [r["ms"] for r in recs.values() if r["path"] == "classic"]
    fused = [r for r in recs.values() if r["path"] == "fused" and "process_ms" in r]
    kf_frames = [r for r in fused if r.get("keyframe")]
    rebased = [r for r in fused if r.get("rebased")]
    vr = system.vocab_record
    nw = system.nmi_worker
    print(f"  launches over the circuit's drive: {launches}")
    check(all(launches[k] > 0 for k in ("joint_entropy", "marginal_entropy", "render_gray"))
          and launches["rasterize_keys"] == 0,
          "B1, B2 and render_gray launched on the system path (latches and anchors), B3's "
          "keys epilogue never")
    print(f"  frames tracked {len(tracked)} of {n} (reference {SYS_REF['tracked']}); keyframes "
          f"created {created} (reference {SYS_REF['keyframes_created']}), surviving {len(vk)} "
          f"(reference {SYS_REF['keyframes_surviving']}); map points {n_points}; NMI anchors "
          f"{len(anchors)} (reference {SYS_REF['anchors']}; the worker applied {nw.n_applied}, "
          f"failed {nw.n_failed}) at frames {anchors}; loop closures {n_loops} (reference 0)")
    print(f"  online camera-centre error over the tracked frames: p50 {np.median(online):.4f}, "
          f"p95 {np.quantile(online, 0.95):.4f}, max {online.max():.4f} m (reference "
          f"{SYS_REF['err_p50_m']}, {SYS_REF['err_p95_m']}, {SYS_REF['err_max_m']}); the "
          f"recomposed trajectory ({len(rows)} rows): unaligned ATE-RMSE {ate:.4f} m (reference "
          f"{SYS_REF['ate_m']}), max {final.max():.4f} m")
    print(f"  completion wall a frame, frames {SYS_CHUNK}-{n - 1}: p50 {np.median(steady):.2f}, "
          f"p95 {np.quantile(steady, 0.95):.2f}, max {steady.max():.2f} ms; steady state "
          f"{fps:.2f} frames/s against the {SYS_BUDGET_MS:.1f} ms budget (30 fps); drive "
          f"{wall:.1f} s, with the workers drained {drained:.1f} s  [{smi}]")
    lm_ms = [r["total_ms"] for r in system.local_mapper.records]
    lc_ms = [r.get("detect_ms", 0.0) + sum(r["sim3_ms"]) + r.get("db_add_ms", 0.0)
             + sum(r.get("correct_ms", {}).values())
             for r in (system.loop_closer.records if system.loop_closer is not None else [])]
    lock = np.array([r["lock_ms"] for r in fused])
    print(f"  where a fused frame's host time goes (mean ms over {len(fused)}): waiting for the "
          f"map lock {lock.mean():.2f} (p50 {np.median(lock):.2f}, max {lock.max():.1f}), "
          f"candidates {np.mean([r['cand_ms'] for r in fused]):.2f}, dispatch (upload + replay) "
          f"{np.mean([r['dispatch_ms'] for r in fused]):.2f}, readback wait "
          f"{np.mean([r['wait_ms'] for r in fused]):.2f}, binding and bookkeeping "
          f"{np.mean([r['process_ms'] for r in fused]):.2f}; keyframe frames "
          f"({len(kf_frames)}) processing {np.mean([r['process_ms'] for r in kf_frames]):.2f}; "
          f"frames meeting a landed correction (chain rebased, {len(rebased)}) processing "
          f"{np.mean([r['process_ms'] for r in rebased]) if rebased else 0:.2f}; rewinds "
          f"{fe.n_rewinds}; classic frames {len(classic)}, {np.mean(classic):.1f} ms each "
          f"(max {np.max(classic):.1f}); on the mapping worker: {len(lm_ms)} keyframes mapped, "
          f"{np.mean(lm_ms):.1f} ms each (max {np.max(lm_ms):.1f}), the loop closer "
          f"{np.mean(lc_ms) if lc_ms else 0:.1f} ms a keyframe (max "
          f"{np.max(lc_ms) if lc_ms else 0:.1f})  [{smi}]")
    print(f"  vocabulary: {vr['words']} words from {vr['descriptors']} descriptors, trained in "
          f"{vr['train_s']:.3f} s on thread '{vr['thread']}' at frame {vr['frame']}; repeated "
          f"(keyframe, point) pairs (C2) {repeated}")
    check(len(tracked) >= SYS_MIN_TRACKED, f"at least {SYS_MIN_TRACKED} of {n} frames tracked "
          f"({len(tracked)})")
    check(ate <= SYS_ATE_M, f"unaligned ATE-RMSE {ate:.4f} <= {SYS_ATE_M} m")
    gaps = np.diff([0] + sorted(anchors) + [n - 1])
    dec = circuit_diag.decision_counts(fe.records)
    print(f"  keyframe decisions of the fused frames: {dec}")
    print(f"  NMI anchors {len(anchors)} against the bar of {SYS_MIN_ANCHORS} (half of the "
          f"reference's 42), held on the synchronous system's drive below: "
          + ("met" if len(anchors) >= SYS_MIN_ANCHORS else
             f"not met here, {created} keyframes created; c2 held at {dec['c2_held']} fused "
             f"frames, {dec['c2_refused_mapper_busy']} of them refused with the mapper busy")
          + f"; the longest stretch without an anchor {int(gaps.max())} frames")
    snapped = [w for w in sweeps if w["relocalized"]]
    nmi_err = {k: float(np.mean([w[k] for w in snapped])) if snapped else None
               for k in ("err_before_m", "err_found_m")}
    print(f"  the keyframes' NMI sweeps: {len(sweeps)} landed, {len(snapped)} snapped; camera-"
          f"centre error before the sweep {nmi_err['err_before_m']}, at the pose found "
          f"{nmi_err['err_found_m']} m (means)")
    check(nw.n_applied + nw.n_failed > 0 and nw.n_failed <= nw.n_applied,
          f"the NMI worker anchored keyframes ({nw.n_applied} applied, {nw.n_failed} failed)")
    check(n_loops == 0, "no loop closed (the standard circuit's keyframes stay covisible)")
    rec["circuit"] = dict(
        frames=n, tracked=len(tracked), keyframes_created=created, keyframes_surviving=len(vk),
        map_points=n_points, anchors=len(anchors), anchor_frames=anchors,
        anchor_gap_max=int(gaps.max()), keyframe_decisions=dec, nmi_sweep_err_m=nmi_err,
        nmi_applied=nw.n_applied, nmi_failed=nw.n_failed, loop_closures=n_loops,
        online_err_m=stats(online), ate_m=ate, final_err_max_m=float(final.max()),
        frame_wall_ms=stats(steady), fps_steady=fps, drive_s=wall, drained_s=drained,
        launches=launches, vocabulary=vr, repeated_pairs=repeated, rewinds=fe.n_rewinds,
        rebases=fe.n_rebases, classic_ms=stats(classic),
        fused_host_ms={k: float(np.mean([r[k] for r in fused])) for k in (
            "lock_ms", "cand_ms", "dispatch_ms", "wait_ms", "process_ms")},
        keyframe_mapping_ms=stats(lm_ms), loop_closer_ms=stats(lc_ms) if lc_ms else None,
        keyframe_process_ms=float(np.mean([r["process_ms"] for r in kf_frames])),
        reference=SYS_REF, render_s=rec["render_s"])

    # --- capture and replay beside the NMI worker's sweep and a local BA -------
    step = fused_track.FusedTrackStep(cfg, fe.n_cand, dev)
    with m.lock:
        last = tr.last_frame
        kfs = tr._local_keyframes(last)
        _, arrays = local_candidates(m, cfg, kfs, tr.ref_kf, last.Tcw, fe.n_cand)
        carry = fused_track.carry_from_frame(last, m, tr.velocity, dev)
        k_last = int(vk[-1])
        busy_nmi = nw.submit(k_last, frames[int(m.kf_frame_id[k_last])].to(torch.float32),
                             m.kf_Tcw[k_last], tr.dist_since_nmi, tr.rot_since_nmi,
                             int(m.kf_frame_id[k_last]))
        system.pipeline.insert_ba(k_last, m.epoch)
    cand = tuple(torch.from_numpy(a).to(dev) for a in arrays)
    args = (frames[n - 1], carry, *cand)
    time.sleep(0.02)  # the worker has taken the job and launches
    mid_sweep = nw.busy()
    replayed = step(*args)  # captures on this first call, then replays
    eager = step.run_eager(*args)
    sync()
    still = nw.busy()
    nw.flush(timeout=600.0)
    system.pipeline.flush(timeout=600.0)
    again = step.replay(*args)
    sync()
    bits = lambda out: out.packed.view(torch.int32)  # noqa: E731 (int rows bitcast: NaN)
    same = bool(torch.equal(bits(replayed), bits(eager)) and torch.equal(bits(again), bits(eager)))
    print(f"  capture: the NMI worker took a sweep {busy_nmi}, was mid-sweep at the capture "
          f"{mid_sweep} (and after the eager run {still}), a local BA queued on the mapping "
          f"worker; replayed (mid-sweep, and again after both workers drained) against eager, "
          f"packed equal bit for bit {same}")
    check(busy_nmi and mid_sweep, "the step was captured while the NMI worker ran a sweep")
    check(same, "one circuit frame: eager and replayed equal bit for bit")
    check(not system.errors(), "the workers reported no error after the capture")
    rec["capture"] = dict(mid_sweep=mid_sweep, equal=same)

    # --- the classic frame on the card and on the CPU, from the checkpoint -----
    def classic_on(device, nudge=False):
        fields = dict(snap["fields"])
        if nudge:
            fields["mp_pos"] = np.nextafter(fields["mp_pos"], np.float32(np.inf))
        mm = convert.map_store_from_fields(copy.deepcopy(fields), cfg)
        t2 = Tracker(cfg, mm, device=device)
        for k, v in snap["state"].items():
            setattr(t2, k, copy.deepcopy(v))
        f = copy.deepcopy(feat)
        ok = t2._track_with_motion_model(f)
        n_in = t2._track_local_map(f) if ok else 0
        return ok, n_in, f

    feat = Tracker(cfg, MapStore(cfg), device=dev)._make_frame(
        SYS_CLASSIC_FRAME, float(ts[SYS_CLASSIC_FRAME]), frames[SYS_CLASSIC_FRAME])
    sync()
    tc = time.perf_counter()
    ok_d, n_d, f_d = classic_on(dev)
    sync()
    card_ms = (time.perf_counter() - tc) * 1e3
    ok_c, n_c, f_c = classic_on(torch.device("cpu"))
    _, _, f_u = classic_on(torch.device("cpu"), nudge=True)
    with tf32_on():
        _, _, f_t = classic_on(dev)
    gap = float(np.abs(f_d.Tcw - f_c.Tcw).max())
    ulp = float(np.abs(f_u.Tcw - f_c.Tcw).max())
    g_tf = float(np.abs(f_t.Tcw - f_d.Tcw).max())
    same_bind = bool(np.array_equal(f_d.mp_idx, f_c.mp_idx))
    print(f"  classic frame {SYS_CLASSIC_FRAME} (motion model + local map + pose LM) from the "
          f"state after frame {SYS_CLASSIC_FRAME - 1}: card {ok_d}/{n_d} inliers, CPU {ok_c}/"
          f"{n_c}; bindings equal {same_bind}; max |Tcw gap| {gap:.3e} (the CPU on points moved "
          f"by one ulp {ulp:.3e}); TF32 on {g_tf}; {card_ms:.1f} ms on the card  [{smi}]")
    check(ok_d and ok_c and n_d == n_c and same_bind, "the classic frame binds the same points "
          "on the card and on the CPU")
    if gap > SYS_CLASSIC_TCW:
        print(f"  the pose LM's accept decisions part: held against {SYS_CLASSIC_ULP} x the "
              "one-ulp control")
    check(gap <= max(SYS_CLASSIC_TCW, SYS_CLASSIC_ULP * ulp),
          f"classic frame Tcw, card against CPU: {gap:.3e} <= max({SYS_CLASSIC_TCW}, "
          f"{SYS_CLASSIC_ULP} x {ulp:.3e})")
    check(g_tf == 0.0, "the classic frame with TF32 on: max |diff| 0")
    rec["classic_card_vs_cpu"] = dict(frame=SYS_CLASSIC_FRAME, gap=gap, ulp_gap=ulp, tf32_gap=g_tf,
                                      inliers=n_d, card_ms=card_ms)

    # --- induced loss: 3 noise frames, then frames 48 onward ---------------------
    n_kf0 = int(m.n_keyframes)
    with m.lock:  # the points whose EPnP hypotheses pnp.epnp_pose returns as NaN (C5)
        pos = m.mp_pos[m.valid_point_indices()]
    n_far = int((~(np.abs(pos) < pnp._FAR).all(-1)).sum())
    print(f"  map points not finite or beyond {pnp._FAR:g} m before the loss: {n_far} of "
          f"{len(pos)}")
    g = torch.Generator(device=dev).manual_seed(0)
    noise = torch.randint(0, 256, (3,) + tuple(frames.shape[1:]), generator=g, device=dev,
                          dtype=torch.uint8)
    fid = n
    n_rel0 = len(tr.relocalizations)
    res_noise = fe.run(noise, np.arange(fid, fid + 3) / cfg.camera.fps, start_id=fid)
    lost = tr.state == TrackingState.LOST
    fid += 3
    lo, hi = SYS_LOSS_FRAME, SYS_LOC_FRAMES[0]
    res_back = fe.run(frames[lo:hi], np.arange(fid, fid + hi - lo) / cfg.camera.fps, start_id=fid)
    rel = tr.relocalizations[n_rel0:]
    first_ok = next((j for j, r in enumerate(res_back) if r is not None
                     and r.state == TrackingState.OK), None)
    rel_err = (float(np.linalg.norm(center(res_back[first_ok].Tcw) - center(poses[lo + first_ok])))
               if first_ok is not None else float("inf"))
    back = [j for j, r in enumerate(res_back) if r is not None and r.state == TrackingState.OK]
    print(f"  induced loss: the 3 noise frames {[r.state.name for r in res_noise]}; relocalizations {rel} (frame id, keyframe, "
          f"inliers); first tracked frame {SYS_LOSS_FRAME + (first_ok or 0)} ({first_ok} frames "
          f"in), camera-centre error {rel_err:.4f} m; {len(back)} of {hi - lo} frames tracked "
          f"after it; keyframes {n_kf0} -> {int(m.n_keyframes)}")
    check(lost, "the noise frames made tracking LOST")
    check(bool(rel) and rel[0][0] - fid < SYS_LOSS_WITHIN and first_ok is not None
          and first_ok < SYS_LOSS_WITHIN,
          f"relocalized by Tracker._relocalize within {SYS_LOSS_WITHIN} frames")
    check(rel_err <= SYS_RELOC_ERR_M, f"the relocalized pose within {SYS_RELOC_ERR_M} m "
          f"({rel_err:.4f})")
    rec["induced_loss"] = dict(relocalizations=rel, first_ok=first_ok, err_m=rel_err,
                               tracked_after=len(back), frames_after=hi - lo, far_points=n_far)

    # --- localization-only mode over frames 100-159 ------------------------------
    system.activate_localization_mode()
    n_kf1, n_pt1 = int(m.n_keyframes), int(len(m.valid_point_indices()))
    lo, hi = SYS_LOC_FRAMES
    fid += SYS_LOC_FRAMES[0] - SYS_LOSS_FRAME
    res_loc = fe.run(frames[lo:hi], np.arange(fid, fid + hi - lo) / cfg.camera.fps, start_id=fid)
    ok_loc = [j for j, r in enumerate(res_loc) if r is not None and r.state == TrackingState.OK]
    err_loc = [float(np.linalg.norm(center(res_loc[j].Tcw) - center(poses[lo + j])))
               for j in ok_loc]
    system.deactivate_localization_mode()
    print(f"  localization-only mode, frames {lo}-{hi - 1}: {len(ok_loc)} of {hi - lo} tracked, "
          f"error max {max(err_loc) if err_loc else float('nan'):.4f} m; keyframes {n_kf1} -> "
          f"{int(m.n_keyframes)}, map points {n_pt1} -> {int(len(m.valid_point_indices()))}")
    check(int(m.n_keyframes) == n_kf1, "no keyframe created in localization-only mode")
    check(len(ok_loc) >= SYS_LOC_MIN, f"at least {SYS_LOC_MIN} of {hi - lo} frames tracked in "
          f"localization-only mode ({len(ok_loc)})")
    check(not system.errors(), "the workers reported no error")
    rec["localization_only"] = dict(tracked=len(ok_loc), frames=hi - lo,
                                    err_max_m=max(err_loc) if err_loc else None,
                                    keyframes=n_kf1)
    system.shutdown()

    # --- the circuit again, by the synchronous system -------------------------
    _, _, sync_run = circuit_diag.drive(circuit_system(dev, asynchronous=False)[0], frames, poses,
                                        mapper="sync")
    errs = sync_run.pop("worker_errors")
    print(f"  synchronous system (no workers: local mapping and the anchors' NMI sweeps at their "
          f"keyframe): {sync_run['tracked']} of {n} tracked, keyframes created "
          f"{sync_run['keyframes_created']} (reference {SYS_REF['keyframes_created']}), surviving "
          f"{sync_run['keyframes_surviving']} (reference {SYS_REF['keyframes_surviving']}), NMI "
          f"anchors {sync_run['anchors']} (reference {SYS_REF['anchors']}) at frames "
          f"{sync_run['anchor_frames']}, unaligned ATE-RMSE {sync_run['ate_rmse_m']:.4f} m "
          f"(reference {SYS_REF['ate_m']}); the anchored keyframes' camera-centre error before "
          f"the sweep {sync_run['nmi_err_before_m']:.4f} m, at the pose found "
          f"{sync_run['nmi_err_found_m']:.4f} m (means); {sync_run['frames_per_s']:.2f} frames/s; "
          f"keyframe decisions {sync_run['decisions']}  [{smi}]")
    check(not errs, "the synchronous system reported no error" + (
        f":\n{errs[0]}" if errs else ""))
    check(sync_run["anchors"] >= SYS_MIN_ANCHORS, f"at least {SYS_MIN_ANCHORS} NMI anchors with "
          f"the mapper idle at each decision ({sync_run['anchors']})")
    check(sync_run["tracked"] >= SYS_MIN_TRACKED, f"synchronous system: at least "
          f"{SYS_MIN_TRACKED} of {n} frames tracked ({sync_run['tracked']})")
    check(sync_run["ate_rmse_m"] <= SYS_ATE_M, f"synchronous system: unaligned ATE-RMSE "
          f"{sync_run['ate_rmse_m']:.4f} <= {SYS_ATE_M} m")
    rec["synchronous"] = {k: v for k, v in sync_run.items() if k not in ("keyframe_frames",
                                                                         "sweeps")}
    print(f"  phase took {time.perf_counter() - t_phase:.1f} s")
    return rec


# The settings phase: the user's front door, `run_replay --settings X.yaml
# --sequence DIR` (mono_ETH's), on a scene written to disk in the reference's
# formats by `entry.write_settings_scene`: the domain-gap prefix of the
# seed-1 520-frame circuit (SET_FRAMES) in the ETH layout, its settings YAML
# (threshold 0.1, NMI.Init1/Init2 the true Twc of frames 0 and 8), the
# terrain as an OBJ with its texture and as an XYZ pointcloud with an offset
# file. The settings file cannot set what the replay's configuration sets
# beyond the reference's keys (coarse_scale 2, 512 keyframes): this drive
# runs the reference's full-resolution sweeps and the default capacities.
SET_DIR = os.path.join("build", "chip_smoke_settings")  # gitignored
# The drive is cut to the prefix's first 120 frames (the NMI init and 50-odd
# keyframe sweeps): the classic path maps a keyframe nearly every frame in
# line, ~1 s a frame, and all 160 took the phase to 264 s of a ~180 s budget
# (PERF.md).
SET_FRAMES = 120
SET_MIN_TRACKED = 108  # frames 0-7 come before initialization; 4 fewer than the rest
SET_ATE_M = 0.0625  # PERF.md §2's bar (SYS_ATE_M); DOMAIN_GAP_r04.json: 0.0403 m
SET_DIAG_FRAMES = 80  # circuit_diag's drives: the clean prefix's first 80 frames
SET_DIAG_MIN_TRACKED = 68  # frames 0-7 come before initialization; 4 fewer than the rest
SET_DIAG_P95_M = 0.0625


def mesh_relabeling(loaded, mesh):
    """The vertex map that makes `loaded` (an OBJ read by `load_obj`, which
    numbers vertices by first use) equal `mesh` array for array:
    `loaded.vertices[perm] == mesh.vertices` and the same for the UVs, with
    `perm[mesh.faces] == loaded.faces`. Raises where no such map exists."""
    import numpy as np

    if loaded.faces.shape != mesh.faces.shape or len(loaded.vertices) != len(mesh.vertices):
        raise AssertionError(f"{loaded.faces.shape} faces, {len(loaded.vertices)} vertices "
                             f"against {mesh.faces.shape}, {len(mesh.vertices)}")
    perm = np.full(len(mesh.vertices), -1, np.int64)
    perm[mesh.faces.ravel()] = loaded.faces.ravel()
    if (perm < 0).any() or not np.array_equal(perm[mesh.faces], loaded.faces) \
            or len(np.unique(perm)) != len(perm):
        raise AssertionError("the faces are not one relabelling of the mesh's")
    for name in ("vertices", "uvs"):
        if not np.array_equal(getattr(loaded, name)[perm], getattr(mesh, name)):
            raise AssertionError(f"the relabelled {name} differ")
    return perm


def settings_phase(dev, smi, check):
    """Phase 11: the settings-file entry (see the SET_* constants): (a) the
    scene written; (b) `run_replay.main` on it in-process, the classic path
    with synchronous mapping and NMI from the OBJ; (c) the OBJ's mesh against
    the in-memory one, and one NMI init sweep of a `SLAMSystem.from_yaml`
    against the same sweep of `replay_bench.build_system`'s in-memory mesh;
    (d) the same for the XYZ pointcloud at render mode 4; (e)
    `circuit_diag.run_diag`'s classic and pipelined drives with NMI off and
    synchronous mapping. Returns its record for the JSON line."""
    import contextlib
    import dataclasses
    import io
    import re

    import numpy as np
    import torch

    from orbslam2_nmi_torch import entry, kernels, run_replay
    from orbslam2_nmi_torch.config import load_yaml_config
    from orbslam2_nmi_torch.io import model_loader
    from orbslam2_nmi_torch.ops import render
    from orbslam2_nmi_torch.slam import system as system_mod
    from orbslam2_nmi_torch.slam.nmi import search_kernel as sk
    from orbslam2_nmi_torch.slam.nmi.localizer import NMILocalizer
    from orbslam2_nmi_torch.tools import circuit_diag, replay_bench

    t_phase = time.perf_counter()
    rec = {}

    def center(T):
        return -T[:3, :3].T.astype(np.float64) @ T[:3, 3].astype(np.float64)

    # --- (a) the scene on disk ------------------------------------------------------
    print(f"settings: the {SET_FRAMES}-frame domain-gap prefix of the seed-1 circuit, written "
          f"to {SET_DIR} in the reference's formats (entry.write_settings_scene)")
    t = time.perf_counter()
    sc = entry.write_settings_scene(SET_DIR, SET_FRAMES, n_total=520, domain_gap=True,
                                    layout="eth", device=dev)
    rec["write_s"] = time.perf_counter() - t
    cfg = load_yaml_config(sc.settings)
    sizes = {os.path.basename(p): os.path.getsize(p) for p in (
        sc.settings, cfg.nmi.model_obj_path, cfg.nmi.model_texture_path,
        cfg.nmi.model_cloud_path, cfg.nmi.model_offset_path)}
    print(f"  written in {rec['write_s']:.1f} s: {len(os.listdir(sc.sequence)) - 1} frames, "
          f"{len(sc.world.mesh.faces)} faces, {len(sc.cloud.points)} cloud points; bytes {sizes}"
          f"  [{smi}]")
    check((cfg.camera.width, cfg.camera.height, cfg.nmi.threshold, cfg.nmi.offset,
           cfg.nmi.render_mode, cfg.nmi.coarse_scale, cfg.orb.n_features)
          == (960, 540, 0.1, 8, 1, 1, 2000),
          "the settings file: 960x540, threshold 0.1, offset 8, the textured mesh (mode 1), "
          "full-resolution sweeps, 2000 features")

    # --- (b) run_replay --settings --sequence, in-process ------------------------------
    print(f"settings: run_replay.main --settings --sequence --max-frames {SET_FRAMES} (classic "
          "path, synchronous mapping, NMI from the OBJ)")
    built, first = [], {}

    class Recorded(system_mod.SLAMSystem):
        """The replay's system, recorded: its first NMI sweep is re-scored
        all-plain, its keyframe sweeps are kept (`circuit_diag.record_sweeps`)."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)
            self.sweeps = circuit_diag.record_sweeps(self, sc.poses)
            loc = self.localizer
            if loc is None:
                return
            evaluate = loc.evaluate_grid
            kept = keep_sweeps(loc)

            def rec_grid(frame, Tcw, kernel, scale=1):
                scores = evaluate(frame, Tcw, kernel, scale)
                if not first:
                    first.update(zip(("d", "am", "pm", "same"), plain_rescore(
                        loc, kept[0], Tcw, scores)), shape=scores.shape, scale=scale)
                return scores

            loc.evaluate_grid = rec_grid

    out_dir = os.path.join(SET_DIR, "output")
    args = ["--settings", sc.settings, "--sequence", sc.sequence, "--output", out_dir,
            "--max-frames", str(SET_FRAMES)]
    printed = io.StringIO()
    system_mod.SLAMSystem, original = Recorded, system_mod.SLAMSystem
    try:
        kernels.reset_launches()
        t = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            rc = run_replay.main(args)
        torch.cuda.synchronize(dev)
        rec["replay_s"] = time.perf_counter() - t
        launches = dict(kernels.LAUNCHES)
    finally:
        system_mod.SLAMSystem = original
    print("  " + printed.getvalue().strip().replace("\n", "\n  "))
    check(rc == 0 and len(built) == 1, f"run_replay.main returned {rc}")
    system = built[0]
    log = open(os.path.join(out_dir, "_log.txt")).read()
    check(system.localizer is not None and system.localizer.mesh is not None
          and "NMI disabled" not in log,
          "the system's localizer holds the OBJ's mesh (the 'NMI model not found' branch not "
          "taken)")
    print(f"  launches over the drive: {launches}")
    check(all(launches[k] > 0 for k in ("render_gray", "joint_entropy", "marginal_entropy"))
          and launches["rasterize_keys"] == 0,
          "render_gray, B1 and B2 launched on the settings path, B3's keys epilogue never")
    print(f"  first NMI sweep {first.get('shape')} at scale {first.get('scale')}: binning equal "
          f"to the host's {first.get('same')}, max |kernels - all-plain| {first.get('d')}, "
          f"argmax {first.get('am')} vs {first.get('pm')}")
    check(first and first["same"], "the first NMI sweep's binning equals the host's bit for bit")
    check(first["d"] <= SCORE_ATOL and first["am"] == first["pm"],
          f"the first NMI sweep within {SCORE_ATOL} of its all-plain rescore, the same argmax")
    m = re.search(r"tracked (\d+)/(\d+) frames", printed.getvalue())
    n_ok, n_run = int(m.group(1)), int(m.group(2))
    rows = [ln.replace(",", " ").split() for ln in open(os.path.join(out_dir,
                                                                     "FullTrajectory.txt"))]
    ids = np.array([int(r[0]) for r in rows])
    est = np.array([[float(x) for x in r[-7:-4]] for r in rows])
    gt = np.array([center(sc.poses[i]) for i in ids])
    err = np.linalg.norm(est - gt, axis=1)
    ate = float(np.sqrt(np.mean(err ** 2)))
    anchors = [w for w in system.sweeps if w["relocalized"]]
    with system.map.lock:
        vk = system.map.valid_keyframe_indices()
        kf = [int(f) for f in system.map.kf_frame_id[vk]]
    ft = np.asarray(system.frame_times) * 1e3
    n_nmi_log = log.count(": NMI ok")
    rec["replay"] = dict(
        tracked=n_ok, frames=n_run, keyframes=len(kf), ate_rmse_m=ate,
        err_p50_m=float(np.median(err)), err_p95_m=float(np.quantile(err, 0.95)),
        err_max_m=float(err.max()), sweeps=len(system.sweeps), anchors=len(anchors),
        anchor_frames=[w["frame"] for w in anchors], launches=launches,
        frame_ms=dict(p50=float(np.median(ft)), p95=float(np.quantile(ft, 0.95)),
                      max=float(ft.max()), mean=float(ft.mean())),
        first_sweep=dict(first, shape=list(first["shape"])), replay_s=rec["replay_s"])
    print(f"  {n_ok} of {n_run} tracked, {len(kf)} keyframes surviving; unaligned ATE-RMSE of "
          f"FullTrajectory's {len(rows)} frames {ate:.4f} m (p50 {np.median(err):.4f}, p95 "
          f"{np.quantile(err, 0.95):.4f}, max {err.max():.4f}); {len(system.sweeps)} keyframe NMI "
          f"sweeps, {len(anchors)} anchored at frames {rec['replay']['anchor_frames']} ("
          f"{n_nmi_log} 'NMI ok' lines with the latches); ms a frame (track_monocular, host "
          f"clock) p50 {np.median(ft):.1f}, p95 {np.quantile(ft, 0.95):.1f}, max {ft.max():.1f}, "
          f"mean {ft.mean():.1f}; the drive {rec['replay_s']:.1f} s  [{smi}]")
    check(n_run == SET_FRAMES and n_ok >= SET_MIN_TRACKED,
          f"at least {SET_MIN_TRACKED} of {SET_FRAMES} frames tracked ({n_ok})")
    check(ate <= SET_ATE_M, f"unaligned ATE-RMSE {ate:.4f} <= {SET_ATE_M} m")
    check(len(anchors) >= 1, f"at least one NMI anchor landed ({len(anchors)})")
    built.clear()
    del system

    # --- (c) the file-built mesh against the in-memory one ---------------------------
    print("settings: the OBJ's model against the world's, and one NMI init sweep of "
          "SLAMSystem.from_yaml against replay_bench.build_system's in-memory mesh")
    mesh = sc.world.mesh
    loaded = model_loader.load_obj(cfg.nmi.model_obj_path, cfg.nmi.model_texture_path)
    perm = mesh_relabeling(loaded, mesh)
    check(np.array_equal(loaded.texture_gray, mesh.texture_gray)
          and np.array_equal(loaded.vertices[loaded.faces], mesh.vertices[mesh.faces])
          and np.array_equal(loaded.uvs[loaded.faces], mesh.uvs[mesh.faces]),
          f"load_obj's mesh is the world's: {len(loaded.faces)} faces corner for corner, the "
          f"texture bit for bit, the vertices one relabelling ({int((perm != np.arange(len(perm))).sum())} "
          "renumbered by first use)")
    frame0 = sc.frames[0].float()
    yaml_sys = system_mod.SLAMSystem.from_yaml(sc.settings, device=dev,
                                               output_dir=os.path.join(SET_DIR, "from_yaml"))
    mem_sys = replay_bench.build_system(sc.world, cfg.camera.width, cfg.camera.height,
                                        threshold=0.1, async_mapping=False,
                                        output_dir=os.path.join(SET_DIR, "in_memory"), device=dev)
    try:
        T1 = yaml_sys.tracker._init_T1
        kernel = sk.initial_kernel_for_init(yaml_sys.localizer.initial_kernel)
        s_yaml = yaml_sys.localizer.evaluate_grid(frame0, T1, kernel)
        s_mem = mem_sys.localizer.evaluate_grid(frame0, T1, kernel)
    finally:
        yaml_sys.shutdown()
        mem_sys.shutdown()
    d_mesh = float(np.abs(s_yaml - s_mem).max())
    print(f"  init sweep {s_yaml.shape} at the YAML's Init1: max |from_yaml - in-memory| "
          f"{d_mesh}, argmax {int(s_yaml.argmax())} vs {int(s_mem.argmax())}, best "
          f"{float(s_yaml.max()):.5f}; the init pose's distance to frame 0's truth "
          f"{float(np.linalg.norm(center(T1) - center(sc.poses[0]))):.2e} m")
    check(d_mesh <= SCORE_ATOL and int(s_yaml.argmax()) == int(s_mem.argmax()),
          f"the OBJ's init sweep equals the in-memory mesh's within {SCORE_ATOL} ({d_mesh}), "
          "the same argmax")

    # --- (d) the XYZ pointcloud at render mode 4 ----------------------------------------
    print("settings: the XYZ pointcloud and its offset file at render mode 4")
    cfg4 = cfg.replace(nmi=dataclasses.replace(cfg.nmi, render_mode=4))
    pc_sys = system_mod.SLAMSystem(cfg4, device=dev, output_dir=os.path.join(SET_DIR, "xyz"))
    try:
        loc4 = pc_sys.localizer
        check(loc4 is not None and loc4.mesh is None and loc4.model is not None,
              "render mode 4 loads the pointcloud, no mesh")
        d_pts = float((loc4.model.points.cpu() - torch.from_numpy(sc.cloud.points)).abs().max())
        d_gray = float((loc4.model.gray.cpu() - torch.from_numpy(sc.cloud.gray)).abs().max())
        mem4 = NMILocalizer(cfg4.nmi, cfg4.camera, render.model_from_pointcloud(sc.cloud, dev),
                            device=dev)
        s_file = loc4.evaluate_grid(frame0, T1, kernel)
        s_mem4 = mem4.evaluate_grid(frame0, T1, kernel)
    finally:
        pc_sys.shutdown()
    d_pc = float(np.abs(s_file - s_mem4).max())
    print(f"  {len(sc.cloud.points)} points: max |file - in-memory| points {d_pts}, gray "
          f"{d_gray}; init sweep {s_file.shape}: max |diff| {d_pc}, argmax "
          f"{int(s_file.argmax())} vs {int(s_mem4.argmax())}")
    check(d_pc <= SCORE_ATOL and int(s_file.argmax()) == int(s_mem4.argmax()),
          f"the XYZ's init sweep equals the in-memory pointcloud's within {SCORE_ATOL}, the same "
          "argmax")
    rec["models"] = dict(mesh_sweep_gap=d_mesh, cloud_sweep_gap=d_pc,
                         cloud_points=len(sc.cloud.points), cloud_points_gap=d_pts,
                         cloud_gray_gap=d_gray,
                         renumbered_vertices=int((perm != np.arange(len(perm))).sum()))
    del sc

    # --- (e) circuit_diag's classic and pipelined drives ---------------------------------
    print(f"settings: circuit_diag.run_diag, classic and pipelined, NMI off, synchronous "
          f"mapping, the first {SET_DIAG_FRAMES} frames of the clean prefix")
    world, frames = replay_bench.generate_sequence(SET_DIAG_FRAMES, 960, 540, n_total=520,
                                                   cache=False, device=dev)
    rec["diag"] = {}
    for pipelined in (False, True):
        front = "pipelined" if pipelined else "classic"
        s = circuit_diag.run_diag(world, frames, pipelined, use_nmi=False, threshold=0.45,
                                  out_path=os.path.join(SET_DIR, f"diag_{front}.jsonl"),
                                  n_total=520, async_mapping=False, device=dev)
        rec["diag"][front] = s
        print("  " + json.dumps({k: v for k, v in s.items() if k != "kf_frame_ids"})
              + f"  [{smi}]")
        check(s["n_tracked"] >= SET_DIAG_MIN_TRACKED
              and s["online_err_p95_m"] <= SET_DIAG_P95_M,
              f"{front}: at least {SET_DIAG_MIN_TRACKED} of {SET_DIAG_FRAMES} tracked "
              f"({s['n_tracked']}), online error p95 {s['online_err_p95_m']:.4f} <= "
              f"{SET_DIAG_P95_M} m")
    del frames
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase took {rec['phase_s']:.1f} s  [{smi}]")
    return rec


# The tools phase: the bench sweep on tools/bench.py's scene (the reference's
# bench.py: the 71,442-face height field, a 512x512 texture, 27 x 27 at
# 960x540), then the domain-gap replay of tools/replay_bench.py on the
# 160-frame prefix of the seed-1 520-frame circuit (the lit mesh and the
# photometric gap against the flat prior, threshold 0.1, pipelined, async
# mapping and async NMI), frames 60-159 profiled by tools/device_budget.py
# (STEADY_STATE_r05.json's window), and the viz artifacts of that replay.
TOOLS_FRAMES = 160
TOOLS_WINDOW = 60
TOOLS_MIN_TRACKED = 148  # BENCH_r05.json's control prefix tracked 152; 4 fewer, as SYS_MIN_TRACKED
# The reference's online maximum (SYS_ATE_M), held on the async drive of the
# prefix (the JAX package's prefix, DOMAIN_GAP_r04.json: 0.0403 m) and, as an
# extra check, on the synchronous system's drive of the same frames (no
# workers: each keyframe mapped and swept at its frame).
TOOLS_ATE_M = 0.0625
TOOLS_OTHER_SHARE = 0.10  # STEADY_STATE_r05.json: "other" 5.6 of 3,112 ms
TOOLS_VIZ_DIR = os.path.join("build", "chip_smoke_viz")  # gitignored


def tools_phase(dev, smi, check, cuda_ms):
    """Phase 12: the tools and the headless visualization at 960x540 (see
    the TOOLS_* constants). Returns its record for the JSON line."""
    import re

    import numpy as np
    import torch

    from orbslam2_nmi_torch import kernels
    from orbslam2_nmi_torch.ops import raster
    from orbslam2_nmi_torch.tools import bench, device_budget, replay_bench
    from orbslam2_nmi_torch.viz import replay as viz

    t_phase = time.perf_counter()
    rec = {}
    print("tools: the bench sweep (tools/bench.py) on the reference bench's scene")
    inp = bench.sweep_inputs(dev)
    b = inp.binned
    res = bench.run_sweep(inp)
    t = res["times"]
    print(f"  binned: tiles {b.tiles_y}x{b.tiles_x}, capacity {b.capacity}, overflow "
          f"{b.overflow}, texture {tuple(b.texture.shape)}")
    ratio = res["evals_per_s"] / bench.BASELINE_EVALS_PER_S
    print(f"  stage ms (median, min-max of {bench.REPS} calls, CUDA events): " + ", ".join(
        f"{k} {v['median_ms']:.4f} ({v['min_ms']:.4f}-{v['max_ms']:.4f})" for k, v in t.items())
        + f"; {res['evals_per_s']:.1f} evaluations/s ({ratio:.3f} x the 1458/s requirement); "
        f"the 27-candidate point splat {t['splat']['median_ms']:.3f} ms  [{smi}]")
    print(f"  launches over one sweep: {res['launches']}")
    check(res["launches"] == {"joint_entropy": 1, "marginal_entropy": 1, "rasterize_keys": 0,
                              "render_gray": 1, "bin_count": 0, "bin_fill": 0,
                              "splat_scatter": 0, "splat_resolve": 0},
          "B1, B2 and render_gray launched once over the bench sweep, B3's keys epilogue never "
          "(the bench bins once, before the sweep)")
    warped = res["warped"]
    plain = _all_plain_scores(b, inp.Tcw, inp.K, inp.offsets, bench.NEAR, warped, True)
    d = (res["scores"] - plain).abs().max().item()
    a_k, a_p = int(res["scores"].argmax()), int(plain.argmax())
    print(f"  scores [27, 27]: max |kernels - all-plain| {d}, argmax {a_k} vs {a_p}")
    check(d <= SCORE_ATOL and a_k == a_p,
          f"bench sweep scores within {SCORE_ATOL} of the all-plain run, the same argmax")
    poses = raster.grid_poses(inp.Tcw, inp.offsets)
    K = inp.K
    rargs = (b.tri_data, poses, b.capacity, float(K[0, 0]), float(K[1, 1]), float(K[0, 2]),
             float(K[1, 2]), bench.NEAR, b.tiles_x)
    S = poses.shape[0]
    n_pix = S * b.tri_data.shape[0] * raster.TILE_H * raster.TILE_W
    n_img = S * b.height * b.width
    n_tests = _raster_tests(raster, b, poses, K, bench.NEAR)
    b3_bound, b3_by = _bound_ms(b.tri_data.numel() * 4 + poses.numel() * 4 + 3 * n_pix * 4,
                                n_tests * 10)
    gargs = (*rargs, b.texture, *b.tex_hw, 0.0, b.height, b.width)
    g_bound, g_by = _bound_ms(_render_gray_bytes(b, poses, n_img), n_tests * 10 + 20 * n_img)
    kernel_ms = dict(
        rasterize_keys=dict(ms=cuda_ms(lambda: raster.rasterize_keys(*rargs)),
                            bound_ms=b3_bound, bound_by=b3_by),
        render_gray=dict(ms=cuda_ms(lambda: raster.render_gray(*gargs)),
                         bound_ms=g_bound, bound_by=g_by))
    print(f"  at the bench's shapes ({n_tests:.4e} coverage tests, {n_pix} tiled pixels): "
          f"render_gray {kernel_ms['render_gray']['ms']:.4f} ms (bound {g_bound:.4f} ms by "
          f"{g_by}), B3's keys epilogue {kernel_ms['rasterize_keys']['ms']:.4f} ms (bound "
          f"{b3_bound:.4f} ms by {b3_by})  [{smi}]")
    rec["sweep"] = dict(times={k: {m: v[m] for m in ("median_ms", "min_ms", "max_ms")}
                               for k, v in t.items()},
                        evals_per_s=res["evals_per_s"], launches=res["launches"],
                        scores_gap=d, kernels=kernel_ms)
    del res, warped, plain, inp

    print(f"tools: the domain-gap replay (tools/replay_bench.py), the {TOOLS_FRAMES}-frame "
          "prefix of the seed-1 520-frame circuit, threshold 0.1, pipelined, async mapping "
          "and async NMI")
    t0 = time.perf_counter()
    world, frames = replay_bench.generate_sequence(TOOLS_FRAMES, 960, 540, n_total=520,
                                                   domain_gap=True, cache=False, device=dev)
    torch.cuda.synchronize(dev)
    rec["render_s"] = time.perf_counter() - t0
    viz_dir = TOOLS_VIZ_DIR
    os.makedirs(os.path.join(viz_dir, "nmi_debug"), exist_ok=True)
    for f in os.listdir(os.path.join(viz_dir, "nmi_debug")):
        os.remove(os.path.join(viz_dir, "nmi_debug", f))
    drawn = {}

    def draw(system):  # (c): the replay's artifacts, its workers drained
        tr, loc = system.tracker, system.localizer
        fr = tr.last_frame
        viz.draw_frame(frames[-1].cpu().numpy(), fr.xy, fr.mp_idx >= 0,
                       os.path.join(viz_dir, "last_frame.png"))
        viz.plot_map_topdown(system.map, os.path.join(viz_dir, "map_topdown.png"),
                             trajectory=system.full_trajectory())
        sweeps = []
        evaluate = loc.evaluate_grid

        def recorded(*a, **k):
            sweeps.append(evaluate(*a, **k))
            return sweeps[-1]

        loc.evaluate_grid, loc.debug_dir = recorded, os.path.join(viz_dir, "nmi_debug")
        T = world.pose_at(TOOLS_FRAMES - 1, 520).copy()
        T[0, 3] -= system.cfg.nmi.grid.synth_step[0]  # one translation step off
        out = loc.relocalize_strategy(frames[-1].float(), T)
        loc.debug_dir = None
        del loc.evaluate_grid
        drawn.update(sweeps=sweeps, outcome=out)

    kernels.reset_launches()
    t0 = time.perf_counter()
    out = replay_bench.run_replay(world, frames, n_total=520, pipelined=True, threshold=0.1,
                                  device=dev, after=draw)
    rec["replay_s"] = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    rec["replay"] = out
    print(f"  {TOOLS_FRAMES} frames rendered and degraded in {rec['render_s']:.1f} s; the replay "
          f"{rec['replay_s']:.1f} s: tracked {out['n_tracked']}, keyframes {out['n_keyframes']}, "
          f"map points {out['n_map_points']}, NMI anchors {out['n_nmi_anchors']}, loop closures "
          f"{out['n_loop_closures']}; {out['fps_steady']:.2f} frames/s (p50 "
          f"{out['fps_median']:.2f}); walls p50 {out['frame_ms_p50']:.1f}, p95 "
          f"{out['frame_ms_p95']:.1f}, max {out['frame_ms_max']:.1f} ms; unaligned ATE-RMSE "
          f"{out['ate_rmse']:.4f} m; launches {launches}  [{smi}]")
    check(out["n_tracked"] >= TOOLS_MIN_TRACKED and out["ate_rmse"] <= TOOLS_ATE_M,
          f"domain-gap prefix: at least {TOOLS_MIN_TRACKED} of {TOOLS_FRAMES} frames tracked, "
          f"unaligned ATE-RMSE {out['ate_rmse']:.4f} <= {TOOLS_ATE_M} m")
    check(all(launches[k] > 0 for k in ("joint_entropy", "marginal_entropy", "render_gray"))
          and launches["rasterize_keys"] == 0,
          "B1, B2 and render_gray launched on the replay's path (latches, anchors, the "
          "overlays), B3's keys epilogue never")
    t0 = time.perf_counter()
    sync = replay_bench.run_replay(world, frames, n_total=520, pipelined=True, threshold=0.1,
                                   async_mapping=False, device=dev)
    rec["sync_replay"] = sync
    print(f"  the same prefix by the synchronous system ({time.perf_counter() - t0:.1f} s): "
          f"tracked {sync['n_tracked']}, keyframes {sync['n_keyframes']}, NMI anchors "
          f"{sync['n_nmi_anchors']}, {sync['fps_steady']:.2f} frames/s, unaligned ATE-RMSE "
          f"{sync['ate_rmse']:.4f} m (the async drive's {out['ate_rmse']:.4f}; the JAX "
          "package's prefix 0.0403, DOMAIN_GAP_r04.json)")
    check(sync["n_tracked"] >= TOOLS_MIN_TRACKED and sync["ate_rmse"] <= TOOLS_ATE_M,
          f"domain-gap prefix, synchronous system: at least {TOOLS_MIN_TRACKED} tracked, "
          f"unaligned ATE-RMSE {sync['ate_rmse']:.4f} <= {TOOLS_ATE_M} m")

    print(f"tools: the device budget of frames {TOOLS_WINDOW}-{TOOLS_FRAMES - 1} "
          "(tools/device_budget.run_windowed, torch.profiler)")
    t0 = time.perf_counter()
    bud = device_budget.run_windowed(TOOLS_FRAMES, TOOLS_WINDOW, 520, domain_gap=True,
                                     device=dev, world=world, frames=frames, warm=False)
    rec["budget_s"] = time.perf_counter() - t0
    total_ms = sum(bud["by_subsystem_ms"].values())
    other = bud["by_subsystem_ms"].get("other", 0.0)
    print(f"  by subsystem (device ms over the window): {bud['by_subsystem_ms']}; "
          f"{bud['device_ms_per_frame']} device ms a frame over {bud['n_device_ops']} device "
          f"operations; idle share {bud['device_idle_share_union']:.4f} (union of intervals) "
          f"over the traced {bud['traced_wall_s']:.2f} s; {bud['wall_fps_window']:.2f} "
          f"frames/s traced; walls "
          f"p50 {bud['frame_ms_p50']:.1f}, p95 {bud['frame_ms_p95']:.1f}, max "
          f"{bud['frame_ms_max']:.1f} ms; keyframes {bud['n_keyframes']}, anchors "
          f"{bud['n_nmi_anchors']}; the budget took {rec['budget_s']:.1f} s  [{smi}]")
    print(f"  top ranges (ms): {bud['top_modules_ms']}")
    print(f"  device ms by how each launch was found: {bud['launch_found_ms']}; not found, "
          f"by stream: {bud['unattributed_ms_by_stream']}")
    print(f"  the hand-written kernels by range (ms): {bud['cuda_kernels_ms']}")
    rec["budget"] = {k: v for k, v in bud.items() if k != "modules_ms"}
    check(other < TOOLS_OTHER_SHARE * total_ms,
          f"'other' {other} ms under {TOOLS_OTHER_SHARE:.0%} of the traced {total_ms:.1f} ms")
    where = {k: {device_budget.classify(r) for r in v} for k, v in bud["cuda_kernels_ms"].items()}
    print(f"  the hand-written kernels' buckets: {where}")
    check(where.get("render_gray_kernel") == {"nmi_render"}
          and "rasterize_keys_kernel" not in where
          and where.get("joint_entropy_kernel") == {"nmi_score"}
          and where.get("marginal_entropy_kernel") == {"nmi_score"},
          "render_gray lands in nmi_render, B1 and B2 in nmi_score; B3's keys epilogue "
          "does not run")
    fused = bud["modules_ms"].get("fused_step", 0.0)
    check(bud["by_subsystem_ms"].get("tracking_fused_step", 0.0) > 0 and fused > 0,
          f"the replayed step lands in tracking_fused_step ({fused:.1f} ms in 'fused_step')")
    del frames

    print("tools: the replay's viz artifacts (viz/replay.py, the localizer's debug_dir)")

    def image(name):  # PNG where PIL is installed, else the .npy beside the name
        path = os.path.join(viz_dir, name)
        if os.path.exists(path + ".npy"):
            return np.load(path + ".npy")
        from PIL import Image

        return np.asarray(Image.open(path))

    img = image("last_frame.png")
    check(img.shape == (540, 960, 3) and img.dtype == np.uint8,
          f"draw_frame of the last frame: {img.shape} {img.dtype}")
    img = image("map_topdown.png")
    check(img.shape == (900, 900, 3) and bool(img.any()),
          f"plot_map_topdown of the replay's map: {img.shape}, {int((img > 0).any(-1).sum())} "
          "pixels drawn")
    names = sorted(f.removesuffix(".npy") for f in os.listdir(os.path.join(viz_dir, "nmi_debug")))
    best = [n for n in names if "_best_" in n]
    sweeps = drawn["sweeps"]
    cells = [tuple(int(x) for x in re.search(r"_s(\d+)_r(\d+)_", n).groups()) for n in best]
    argmax = [tuple(int(x) for x in np.unravel_index(np.argmax(s), s.shape)) for s in sweeps]
    print(f"  {len(names)} overlays for {len(sweeps)} sweeps of one relocalize_strategy "
          f"(relocalized {drawn['outcome'].relocalized}, NMI {drawn['outcome'].nmi:.4f}): "
          f"best cells {cells}, the sweeps' argmax {argmax}")
    check(len(names) == 2 * len(sweeps) > 0 and cells == argmax,
          "the debug overlays name each sweep's argmax (s, r)")
    for n in names:
        img = image(os.path.join("nmi_debug", n))
        check(img.shape == (540, 960, 3), f"overlay {n}: {img.shape}")
    rec["viz"] = dict(dir=viz_dir, overlays=names)
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase took {rec['phase_s']:.1f} s")
    return rec


# The multichip phase: the sharded paths (orbslam2_nmi_torch/parallel/) on
# worlds of ranks spawned from this process (torch.multiprocessing, spawn).
# A NCCL world of one rank on cuda:0 runs the production backend and its
# collectives; worlds of 2 and 4 gloo ranks share the one card (NCCL refuses
# two ranks on one GPU), which is the only way one card holds a true
# partition, pads included (27 renders over 2 or 4 ranks). They are a check,
# not a scaling figure.
MC_WORLDS = ((1, "nccl"), (2, "gloo"), (4, "gloo"))
MC_REPS = 5  # timed calls of each problem after one warm-up in the NCCL world (medians)
MC_REPS_SHARED = 2  # the same in the shared-card gloo worlds (a check, not a figure)
MC_NMI_ATOL = 1e-5  # each (render, warp) pair is scored on its own: expected 0
MC_BA_CAM_ATOL = 5e-3  # tests/test_sharding.py:22-32's bar
MC_PG_ATOL = 1e-4
MC_BA_SHAPE = (8, 2048)  # a local BA's (C, P) on the mapping path (PERF.md, H3)
MC_PG_V = LOOP_PG_V


def _mc_ba_problem():
    """A seeded local BA at the mapping path's size: 8 keyframes along 1.4 m
    (the first 2 fixed), 2,048 points 10-30 m ahead, each seen by each
    keyframe with probability 0.4 (~6,500 observations; the mapping phase's
    local BAs have 3,893-10,465), octave weights, 0.5 px of noise. Numpy."""
    import numpy as np

    rng = np.random.default_rng(11)
    C, P = MC_BA_SHAPE
    K = np.array([[450.0, 0, 480.0], [0, 450.0, 270.0], [0, 0, 1]], np.float32)
    pw = np.stack([rng.uniform(-10, 10, P), rng.uniform(-6, 6, P), rng.uniform(10, 30, P)],
                  -1).astype(np.float32)
    cams = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    cams[:, 0, 3] = -np.linspace(0, 1.4, C)
    oc, op = np.meshgrid(np.arange(C), np.arange(P), indexing="ij")
    keep = rng.random(oc.size) < 0.4
    oc, op = oc.ravel()[keep], op.ravel()[keep]
    pc = np.einsum("oij,oj->oi", cams[oc, :3, :3], pw[op]) + cams[oc, :3, 3]
    uv = pc[:, :2] / pc[:, 2:3] * 450.0 + [480.0, 270.0] + rng.normal(0, 0.5, (len(oc), 2))
    cams0 = cams.copy()
    cams0[2:, :3, 3] += rng.normal(0, 0.02, (C - 2, 3))
    level = rng.integers(0, 8, len(oc))
    return dict(K=K, cam_Tcw=cams0, cam_fixed=np.arange(C) < 2, cam_valid=np.ones(C, bool),
                pts_w=pw + rng.normal(0, 0.05, pw.shape).astype(np.float32),
                pts_valid=np.ones(P, bool), obs_cam=oc.astype(np.int32),
                obs_pt=op.astype(np.int32), obs_uv=uv.astype(np.float32),
                obs_inv_sigma2=(1.2 ** (-2.0 * level)).astype(np.float32),
                obs_valid=np.ones(len(oc), bool))


def _mc_pose_graph():
    """A seeded essential graph at the loop phase's V 424: a drifting chain,
    one loop edge and covisibility edges every 3rd keyframe to the 8th after
    it (E 563, a multiple of neither 2 nor 4, so the edge padding runs).
    Numpy."""
    import numpy as np

    rng = np.random.default_rng(12)
    V = MC_PG_V
    a = np.linspace(0, 2 * np.pi * 0.9, V)
    gt = np.tile(np.eye(4), (V, 1, 1))
    for i, ang in enumerate(a):
        c, s = np.cos(ang), np.sin(ang)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])  # yaw about the camera's y
        center = np.array([40 * np.sin(ang), rng.normal(0, 0.05), 40 * (1 - np.cos(ang))])
        gt[i, :3, :3] = R.T
        gt[i, :3, 3] = -R.T @ center
    bias = np.eye(4)
    bias[:3, :3] = np.array([[1, -0.002, 0], [0.002, 1, 0], [0, 0, 1]])
    bias[:3, 3] = (0.01, 0.005, 0.0)
    est = [gt[0]]
    for j in range(1, V):
        est.append(bias @ gt[j] @ np.linalg.inv(gt[j - 1]) @ est[-1])
    est = np.stack(est)
    cov_i = np.arange(0, V - 8, 3)
    ei = np.concatenate([np.arange(V - 1), [0], cov_i]).astype(np.int32)
    ej = np.concatenate([np.arange(1, V), [V - 1], cov_i + 8]).astype(np.int32)
    meas = [est[j] @ np.linalg.inv(est[i]) for i, j in zip(ei[:V - 1], ej[:V - 1])]
    meas += [gt[j] @ np.linalg.inv(gt[i]) for i, j in zip(ei[V - 1:], ej[V - 1:])]
    return dict(Scw=est.astype(np.float32), fixed=np.arange(V) == 0, valid=np.ones(V, bool),
                edge_i=ei, edge_j=ej, edge_Sji=np.stack(meas).astype(np.float32),
                edge_valid=np.ones(len(ei), bool))


def multichip_rank(reps, unsharded):
    """One rank of a multichip world: each of the four problems through its
    sharded function (one warm-up, the launch counts of one call, `reps`
    timed calls, each after a barrier), and with `unsharded` the
    single-process call on the same inputs, timed in turn with it."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from orbslam2_nmi_torch import entry as entry_mod
    from orbslam2_nmi_torch import kernels
    from orbslam2_nmi_torch.ops import histogram_nmi, homography, render
    from orbslam2_nmi_torch.parallel import distributed, mesh as mesh_lib
    from orbslam2_nmi_torch.parallel import sharded_ba, sharded_nmi, sharded_pose_graph
    from orbslam2_nmi_torch.solvers import local_ba, pose_graph

    dev = distributed.local_device()
    mesh = mesh_lib.make_mesh()
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    NEAR, FAR = entry_mod.NEAR, entry_mod.FAR

    # the grid step of entry(): 960x540, 27 x 27, capacity 128
    fn, (frame, Tcw) = entry_mod.entry(device=dev)
    # the localizer's pointcloud case (a): 2,211,835 points, 5x5x5 by 27 at
    # one translation step off
    K = entry_mod.camera_K(540, 960)
    model = render.model_from_pointcloud(render.mesh_to_points(entry_mod._toy_mesh()), dev)
    frame4 = render.render_pointcloud(model, torch.eye(4, device=dev), K, 540, 960, NEAR, FAR,
                                      point_size=3)
    T_pert = torch.eye(4, device=dev)
    T_pert[0, 3] = -entry_mod.SYNTH_STEP[0]
    off4 = render.translation_grid_offsets((5, 5, 5), entry_mod.SYNTH_STEP, device=dev)
    ang4 = homography.rotation_grid_angles((3, 3, 3), entry_mod.WARP_STEP, device="cpu").numpy()
    ba = local_ba.BAProblem(**{k: t(v) for k, v in _mc_ba_problem().items()})
    pg = pose_graph.PoseGraphProblem(**{k: t(v) for k, v in _mc_pose_graph().items()})

    problems = {
        "nmi_mesh": (lambda: sharded_nmi.sharded_nmi_search_mesh(
            mesh, fn.binned, frame, Tcw, fn.offsets, fn.angles, fn.K, NEAR, FAR),
            lambda: fn(frame, Tcw)[0]),
        "nmi_splat": (lambda: sharded_nmi.sharded_nmi_search(
            mesh, model, frame4, T_pert, off4, ang4, K, 540, 960, NEAR, FAR, 3),
            lambda: histogram_nmi.nmi_scores(
                render.render_translation_grid(model, T_pert, K, off4, 540, 960, NEAR, FAR, 3),
                homography.warp_rotation_grid(frame4, K, ang4))),
        "ba": (lambda: tuple(sharded_ba.sharded_bundle_adjust(mesh, ba)),
               lambda: tuple(local_ba.bundle_adjust(ba))),
        "pose_graph": (lambda: sharded_pose_graph.sharded_optimize_pose_graph(mesh, pg),
                       lambda: pose_graph.optimize_pose_graph(pg)),
    }

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(f):
        dist.barrier()
        sync()
        t0 = time.perf_counter()
        out = f()
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    rec = {}
    for name, (sharded, plain) in problems.items():
        sharded()
        if unsharded:
            plain()
        kernels.reset_launches()
        out, _ = timed(sharded)
        r = dict(result=out, launches=dict(kernels.LAUNCHES), ms=[])
        if unsharded:
            r["unsharded"], _ = timed(plain)
            r["unsharded_ms"] = []
        for _ in range(reps):  # in turns: sharded, unsharded, sharded, ...
            r["ms"].append(timed(sharded)[1])
            if unsharded:
                r["unsharded_ms"].append(timed(plain)[1])
        rec[name] = r
    rec["rank"] = dist.get_rank()
    rec["device"] = str(dev)
    return rec


def multichip_phase(smi, check, device="cuda"):
    """Phase 13: the sharded paths on worlds of ranks (see MC_WORLDS), each
    result held against the unsharded single-process call on the card, the
    launches of each rank counted, the times printed; then
    `entry.dryrun_multichip(2)`. Returns the phase's record."""
    import numpy as np
    import torch

    from orbslam2_nmi_torch import entry as entry_mod
    from orbslam2_nmi_torch import kernels
    from orbslam2_nmi_torch.parallel import distributed

    t_phase = time.perf_counter()
    print("multichip: the sharded paths on worlds of ranks on this card "
          f"({torch.cuda.device_count()} visible)")
    if device == "cuda":
        kernels.build()  # built before any rank starts (the ranks find it)
        torch.cuda.empty_cache()
    ba_np, pg_np = _mc_ba_problem(), _mc_pose_graph()
    print(f"  problems: the grid step 960x540, 27 x 27, capacity 128 (mesh); the localizer's "
          f"pointcloud case (a), 125 x 27 on 2,211,835 points (splat); BA (C, P) = "
          f"{MC_BA_SHAPE}, {len(ba_np['obs_cam'])} observations; essential graph V "
          f"{MC_PG_V}, E {len(pg_np['edge_i'])}")

    def ba_rmse(cam, pts):
        T = cam[ba_np["obs_cam"]]
        pc = np.einsum("oij,oj->oi", T[:, :3, :3], pts[ba_np["obs_pt"]]) + T[:, :3, 3]
        K = ba_np["K"]
        uv = pc[:, :2] / pc[:, 2:3] * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
        return float(np.sqrt(np.mean(np.sum((ba_np["obs_uv"] - uv) ** 2, -1))))

    ref = None
    record = {"worlds": []}
    for n, backend in MC_WORLDS:
        t0 = time.perf_counter()
        reps = MC_REPS if n == 1 else MC_REPS_SHARED
        outs = distributed.spawn_world(multichip_rank, n, reps, n == 1, device=device,
                                       backend=backend if device == "cuda" else "gloo")
        wall = time.perf_counter() - t0
        what = (f"NCCL world of {n} rank on cuda:0" if backend == "nccl" else
                f"gloo world of {n} ranks sharing cuda:0 (a check of the partition, not a "
                "scaling figure)")
        print(f"  {what}: {wall:.1f} s with spawning")
        if ref is None:
            ref = {k: outs[0][k]["unsharded"] for k in ("nmi_mesh", "nmi_splat", "ba",
                                                         "pose_graph")}
        world = dict(ranks=n, backend=backend, wall_s=wall, problems={})
        for name in ("nmi_mesh", "nmi_splat", "ba", "pose_graph"):
            res = [o[name]["result"] for o in outs]
            parts = [x if isinstance(x, tuple) else (x,) for x in res]
            for r in range(1, n):
                check(all(np.array_equal(a, b) for a, b in zip(parts[0], parts[r])),
                      f"{name}: rank {r}'s result equals rank 0's")
            got = res[0]
            launches = [o[name]["launches"] for o in outs]
            print(f"    {name}: launches per rank {launches}")
            if name == "nmi_mesh":
                check(all(ln == {"joint_entropy": 1, "marginal_entropy": 1, "rasterize_keys": 0,
                                 "render_gray": 1, "bin_count": 0, "bin_fill": 0,
                                 "splat_scatter": 0, "splat_resolve": 0}
                          for ln in launches),
                      f"{name}: each rank launched B1, B2 and render_gray once for the grid")
            elif name == "nmi_splat":
                check(all(ln["joint_entropy"] == 1 and ln["marginal_entropy"] == 1
                          and ln["rasterize_keys"] == 0 and ln["render_gray"] == 0
                          and ln["splat_scatter"] == 1 and ln["splat_resolve"] == 1
                          for ln in launches),
                      f"{name}: each rank launched B1, B2 and the splat's two kernels once, "
                      "B3 never")
            if name.startswith("nmi"):
                d = float(np.abs(got - ref[name]).max())
                am, rm = int(np.argmax(got)), int(np.argmax(ref[name]))
                check(got.shape == ref[name].shape and np.isfinite(got).all()
                      and d <= MC_NMI_ATOL and am == rm,
                      f"{name} {got.shape}: max |sharded - unsharded| {d} <= {MC_NMI_ATOL}, "
                      f"argmax {am} = {rm}")
                gap = dict(max_abs=d, argmax=am)
            elif name == "ba":
                cam, pts = got[0], got[1]
                d = float(np.abs(cam - ref["ba"][0]).max())
                r1, r2 = ba_rmse(ref["ba"][0], ref["ba"][1]), ba_rmse(cam, pts)
                check(d <= MC_BA_CAM_ATOL and r2 <= max(2 * r1, 0.05),
                      f"ba: cameras within {d:.3e} <= {MC_BA_CAM_ATOL} of the unsharded, "
                      f"reprojection RMSE {r2:.4f} <= max(2 x {r1:.4f}, 0.05) px")
                check(np.array_equal(cam[:2], ba_np["cam_Tcw"][:2]),
                      "ba: the fixed cameras equal to the bit")
                gap = dict(cam_max_abs=d, rmse=r2, unsharded_rmse=r1)
            else:
                d = float(np.abs(got - ref["pose_graph"]).max())
                check(np.isfinite(got).all() and d <= MC_PG_ATOL,
                      f"pose_graph: max |sharded - unsharded| {d:.3e} <= {MC_PG_ATOL}")
                gap = dict(max_abs=d)
            ms = float(np.median(outs[0][name]["ms"]))
            line = f"    {name}: sharded {ms:.2f} ms (median of {reps}, rank 0)"
            p = dict(gap, launches=launches, sharded_ms=outs[0][name]["ms"], sharded_median_ms=ms)
            if n == 1:
                um = float(np.median(outs[0][name]["unsharded_ms"]))
                line += f", unsharded {um:.2f} ms: the wrapper and its collectives {ms - um:+.2f} ms"
                p.update(unsharded_ms=outs[0][name]["unsharded_ms"], unsharded_median_ms=um)
            print(line + f"  [{smi}]")
            world["problems"][name] = p
        record["worlds"].append(world)

    print("  entry.dryrun_multichip(2) (gloo: two ranks on one card)")
    entry_mod.dryrun_multichip(2, device=device, backend="gloo")
    record["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase took {record['phase_s']:.1f} s")
    return record


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    try:
        from orbslam2_nmi_torch import kernels
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})", file=sys.stderr)
        return 1
    import numpy as np

    from orbslam2_nmi_torch import entry as entry_mod
    from orbslam2_nmi_torch import kernel_cases
    from orbslam2_nmi_torch.ops import histogram_nmi as hn
    from orbslam2_nmi_torch.ops import raster
    from orbslam2_nmi_torch.tools import render_stage

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    so = kernels.build(verbose=True)
    print(f"build: {time.perf_counter() - t0:.1f} s -> {so.name}")
    kernels.lib()
    raster_res = render_stage.raster_resources(kernels)
    print(f"raster kernels (registers a thread, static shared bytes a block, resident blocks "
          f"an SM): {raster_res}")

    dev = torch.device("cuda")

    def cuda_ms(fn, reps=10, warmup=2, queued=False):
        """Mean ms a call over `reps` calls, by CUDA events. With `queued`,
        the calls wait behind a ~10 ms sleep kernel, so all are enqueued
        before the first runs: the device's time alone, not the host's."""
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def check(ok, msg):
        if not ok:
            raise AssertionError(msg)
        print(f"  ok: {msg}")

    def texture_window(binned):  # the reference's sampler window side (0: whole texture)
        return raster._tile_texture_windows(binned.tri_data.cpu().numpy(),
                                            tuple(binned.texture.shape), binned.tex_hw)[1]

    fn, (frame, Tcw) = entry_mod.entry(device="cuda")
    b = fn.binned
    S = fn.offsets.shape[0]
    R = fn.angles.shape[0]
    K = fn.K
    win = texture_window(b)
    print(f"main path: {b.height}x{b.width}, {S} renders x {R} warps, tiles "
          f"{b.tiles_y}x{b.tiles_x}, capacity {b.capacity}, overflow {b.overflow}, "
          f"texture {tuple(b.texture.shape)} (reference window {win}), "
          f"warp shift bound {fn.plan.bound}")
    rows = {}

    # --- B3: rasterizer -------------------------------------------------------
    print("kernel rasterize_keys (B3)")
    poses = raster.grid_poses(Tcw, fn.offsets)
    rargs = (b.tri_data, poses, b.capacity, float(K[0, 0]), float(K[1, 1]), float(K[0, 2]),
             float(K[1, 2]), entry_mod.NEAR, b.tiles_x)
    keys, uu, vv = raster.rasterize_keys(*rargs)
    d = kernel_cases.raster_mismatch((keys, uu, vv), raster.rasterize_keys_plain(*rargs))
    n_pix = keys.numel()

    def check_raster(d, what):
        print(f"  {what}: hit {d['hit']:.4f}; mismatch: mask {d['mask']}, u {d['u']}, "
              f"v {d['v']}; depth levels {d['depth']}; max|du,dv| {d['err']}")
        check(d["mask"] <= RASTER_MISMATCH_FRAC and d["u"] <= RASTER_MISMATCH_FRAC
              and d["v"] <= RASTER_MISMATCH_FRAC,
              f"{what}: hit mask, u, v equal on all but {RASTER_MISMATCH_FRAC} of pixels")
        check(d["depth"] <= RASTER_DEPTH_LEVELS,
              f"{what}: depth bits within {RASTER_DEPTH_LEVELS} levels")

    check_raster(d, f"main path, {n_pix} pixels")
    err = d["err"]
    del keys, uu, vv
    print("kernel rasterize_keys (B3), adversarial inputs")
    for name in kernel_cases.RASTER_CASES:
        cargs = kernel_cases.raster_case(name, dev)
        dc = kernel_cases.raster_mismatch(raster.rasterize_keys(*cargs),
                                         raster.rasterize_keys_plain(*cargs))
        check_raster(dc, f"{name} (capacity {cargs[2]})")
        err = max(err, dc["err"])
    n_tests = _raster_tests(raster, b, poses, K, entry_mod.NEAR)
    tri_bytes = b.tri_data.numel() * 4 + poses.numel() * 4 + 3 * n_pix * 4
    # per (pixel, triangle) test: two edge planes (2 mul + 2 add each) + E2 (2 sub)
    bound, by = _bound_ms(tri_bytes, n_tests * 10)
    rows["rasterize_keys"] = dict(
        source="orbslam2_nmi_torch/csrc/raster.cu",
        replaces="orbslam2_nmi_tpu/ops/raster.py:487", max_abs_err=err,
        ms=cuda_ms(lambda: raster.rasterize_keys(*rargs)),
        plain_ms=cuda_ms(lambda: raster.rasterize_keys_plain(*rargs), reps=2, warmup=1),
        bound_ms=bound, bound_by=by, library_ms=None)
    print(f"  {n_tests:.4e} (pixel, triangle) tests inside the triangles' bounding boxes; "
          f"bound {bound:.4f} ms by {by}")

    # --- render_gray: B3's gray epilogue, the sampler (B4 and B5) fused ---------
    # The reference samples the entry's binning through per-tile windows (B5)
    # and a binning with a 128x128 texture whole (B4). The port's epilogue
    # reads the whole texture in both, so its checks differ in the texture's
    # size; then a non-zero background and the adversarial cases, whose
    # images crop the last tile row and column.
    th, tw = b.tex_hw
    gargs = (*rargs, b.texture, th, tw, 0.0, b.height, b.width)
    check(win > 0, f"the reference samples the entry's binning through windows (side {win})")
    err_g = render_gray_check(check, gargs, "render_gray (B3, B4/B5), windowed binning")["exact"]
    m2 = entry_mod._toy_mesh()
    m2 = dataclasses.replace(m2, texture_gray=m2.texture_gray[:128, :128])
    b2 = raster.bin_mesh(m2, np.eye(4, dtype=np.float32), K, b.height, b.width, entry_mod.NEAR,
                         entry_mod.FAR, max_offset=entry_mod.SYNTH_STEP, device=dev)
    check(texture_window(b2) == 0, "the reference samples the second binning's texture whole")
    g = render_gray_check(check, (b2.tri_data, poses, b2.capacity, *rargs[3:], b2.texture,
                                  *b2.tex_hw, 0.0, b2.height, b2.width),
                          "render_gray, whole-texture binning")
    err_g = max(err_g, g["exact"])
    g = render_gray_check(check, (*gargs[:-3], 23.5, b.height, b.width),
                          "render_gray, windowed binning, background 23.5")
    err_g = max(err_g, g["exact"])
    for name in kernel_cases.RASTER_CASES:
        cargs = kernel_cases.render_case(name, dev)
        g = render_gray_check(check, cargs, f"render_gray, {name} ({cargs[-2]}x{cargs[-1]} of "
                              f"{cargs[0].shape[0] // cargs[8]}x{cargs[8]} tiles, background "
                              f"{cargs[-3]})")
        err_g = max(err_g, g["exact"])
    gray = raster.render_gray(*gargs)
    n_img = gray.numel()
    bound, by = _bound_ms(_render_gray_bytes(b, poses, n_img), n_tests * 10 + 20 * n_img)
    rows["render_gray"] = dict(
        source="orbslam2_nmi_torch/csrc/raster.cu",
        replaces="orbslam2_nmi_tpu/ops/raster.py:487 (B3), :722 (B4), :693 (B5)",
        max_abs_err=err_g,
        ms=cuda_ms(lambda: raster.render_gray(*gargs)),
        plain_ms=cuda_ms(lambda: raster.render_gray_plain(*gargs), reps=2, warmup=1),
        bound_ms=bound, bound_by=by, library_ms=None)
    print(f"  render_gray over {S} renders: {rows['render_gray']['ms']:.4f} ms, bound "
          f"{bound:.4f} ms by {by}; B3's keys epilogue {rows['rasterize_keys']['ms']:.4f} ms  "
          f"[{smi}]")
    del b2

    # --- B2 and B1 on the main path's images ----------------------------------
    synth = gray
    warped = fn.warp(frame)
    P = b.height * b.width
    sb, wb = hn.pack_bins(synth), hn.pack_bins(warped)
    print("kernel marginal_entropy (B2), renders and warps in one launch")
    e2 = (hn.marginal_entropy_sets(sb, wb, P)
          - hn.marginal_entropy_sets_plain(sb, wb, P)).abs().max().item()
    check(e2 <= ENTROPY_ATOL,
          f"main path, {S}+{R} images: max |kernel - plain| {e2} <= {ENTROPY_ATOL}")
    d = (hn.marginal_entropy_grid(sb, P) - hn.marginal_entropy_grid_plain(sb, P)).abs().max().item()
    check(d <= ENTROPY_ATOL, f"renders alone (one set): max |kernel - plain| {d} <= {ENTROPY_ATOL}")
    e2 = max(e2, d)
    print("kernel marginal_entropy (B2), adversarial inputs")
    for name, calls in kernel_cases.marginal_cases(dev):
        for ca, cb in calls:
            d = kernel_cases.marginal_error(ca, cb)
            n_b = 0 if cb is None else cb.shape[0]
            check(d <= ENTROPY_ATOL, f"{name} [{ca.shape[0]}+{n_b}, P={ca.shape[1]}]: "
                  f"max |kernel - plain| {d} <= {ENTROPY_ATOL}")
            e2 = max(e2, d)
    flat = (torch.cat([sb, wb]).long()
            + torch.arange(S + R, device=dev)[:, None] * 256).reshape(-1)
    bound, by = _bound_ms((S + R) * P + (S + R) * 4, (S + R) * P)
    h_out = torch.empty(S + R, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def b2_entry():  # the C entry point alone, on an output allocated once
        return kernels.lib().nmi_marginal_entropy(sb.data_ptr(), S, wb.data_ptr(), R, P,
                                                  hn._inv_n(P), h_out.data_ptr(), stream)

    check(b2_entry() == 0, "B2's C entry point launches")
    rows["marginal_entropy"] = dict(
        source="orbslam2_nmi_torch/csrc/histogram_nmi.cu",
        replaces="orbslam2_nmi_tpu/ops/histogram_nmi.py:346", max_abs_err=e2,
        ms=cuda_ms(lambda: hn.marginal_entropy_sets(sb, wb, P)),
        plain_ms=cuda_ms(lambda: hn.marginal_entropy_sets_plain(sb, wb, P)),
        bound_ms=bound, bound_by=by,
        library_ms=cuda_ms(lambda: torch.bincount(flat, minlength=(S + R) * 256)))
    entry_ms = cuda_ms(b2_entry)
    queued_ms = cuda_ms(lambda: hn.marginal_entropy_sets(sb, wb, P), queued=True)

    def host_us(fn, n=100):  # host time a call, the device left to run behind
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        t = time.perf_counter() - t
        torch.cuda.synchronize()
        return t / n * 1e6

    wrapper_us = host_us(lambda: hn.marginal_entropy_sets(sb, wb, P))
    print(f"  B2 host time a call: wrapper {wrapper_us:.1f} us, C entry point "
          f"{host_us(b2_entry):.1f} us")
    torch.cuda.synchronize()
    check(bool((h_out == hn.marginal_entropy_sets(sb, wb, P)).all()),
          "B2's C entry point gives the wrapper's result")
    print(f"  B2 over {S}+{R} images: wrapper {rows['marginal_entropy']['ms']:.5f} ms, "
          f"C entry point alone {entry_ms:.5f} ms, wrapper queued behind a sleep (device "
          f"time) {queued_ms:.5f} ms, bound {bound:.5f} ms by {by}  [{smi}]")
    print("kernel joint_entropy (B1), both epilogues")
    e1 = 0.0
    for mask_zero in (False, True):
        d = (hn.joint_entropy_grid(sb, wb, P, mask_zero)
             - hn.joint_entropy_grid_plain(sb, wb, P, mask_zero)).abs().max().item()
        check(d <= ENTROPY_ATOL, f"mask_zero={mask_zero}: max |kernel - plain| {d} <= {ENTROPY_ATOL}")
        e1 = max(e1, d)
    print("kernel joint_entropy (B1), adversarial inputs, both epilogues")
    for name, ca, cb in kernel_cases.joint_cases(dev):
        for mask_zero in (False, True):
            n = ca.shape[1]
            d = (hn.joint_entropy_grid(ca, cb, n, mask_zero)
                 - hn.joint_entropy_grid_plain(ca, cb, n, mask_zero)).abs().max().item()
            check(d <= ENTROPY_ATOL, f"{name} [{ca.shape[0]}x{cb.shape[0]}, P={n}], "
                  f"mask_zero={mask_zero}: max |kernel - plain| {d} <= {ENTROPY_ATOL}")
            e1 = max(e1, d)
    bound, by = _bound_ms((S + R) * P + S * R * 4, S * R * P)
    # a near relative only: one torch.bincount over the pair-offset joint
    # indices pair * 65536 + a * 256 + b computes the S * R histograms, and
    # no entropy
    pair = (torch.arange(S, device=dev)[:, None] * R + torch.arange(R, device=dev)[None, :])
    joint_idx = (pair[:, :, None] * 65536 + sb.long()[:, None, :] * 256
                 + wb.long()[None, :, :]).reshape(-1)
    rows["joint_entropy"] = dict(
        source="orbslam2_nmi_torch/csrc/histogram_nmi.cu",
        replaces="orbslam2_nmi_tpu/ops/histogram_nmi.py:266", max_abs_err=e1,
        ms=cuda_ms(lambda: hn.joint_entropy_grid(sb, wb, P)),
        plain_ms=cuda_ms(lambda: hn.joint_entropy_grid_plain(sb, wb, P), reps=2, warmup=1),
        bound_ms=bound, bound_by=by,
        library_ms=cuda_ms(lambda: torch.bincount(joint_idx, minlength=S * R * 65536)))
    print(f"  B1 over {S} x {R} pairs: {rows['joint_entropy']['ms']:.5f} ms; one torch.bincount "
          f"of the {joint_idx.numel()} pair-offset joint indices (histograms only) "
          f"{rows['joint_entropy']['library_ms']:.5f} ms  [{smi}]")
    del pair, joint_idx
    torch.cuda.empty_cache()

    # --- the main path ----------------------------------------------------------
    print("main path: entry() step at full width")
    kernels.reset_launches()
    scores, best = fn(frame, Tcw)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"  launches: {launches}")
    check(launches == {"joint_entropy": 1, "marginal_entropy": 1, "rasterize_keys": 0,
                       "render_gray": 1, "bin_count": 0, "bin_fill": 0, "splat_scatter": 0,
                       "splat_resolve": 0},
          "B1, B2 and render_gray (B3 with B4/B5) launched once each; B3's keys epilogue, "
          "B3's parity surface, is not on the path, nor the binning (entry() bins once)")
    check(scores.shape == (S, R) and bool(torch.isfinite(scores).all()), "scores finite, [S, R]")

    def plain_scores(use_background):
        return _all_plain_scores(b, Tcw, K, fn.offsets, entry_mod.NEAR, fn.warp(frame),
                                 use_background)

    ps = plain_scores(True)
    ds = (scores - ps).abs().max().item()
    print(f"  scores: max |kernels - all-plain| {ds}, argmax {int(best)} vs {int(ps.argmax())}, "
          f"range [{scores.min().item():.6f}, {scores.max().item():.6f}]")
    check(ds <= SCORE_ATOL, f"scores agree with the all-plain run within {SCORE_ATOL}")
    fn_bg = entry_mod.NMIGridStep(b, K, fn.offsets, fn.angles, use_background=False)
    kernels.reset_launches()
    scores_bg, _ = fn_bg(frame, Tcw)
    torch.cuda.synchronize()
    print(f"  use_background=False launches: {dict(kernels.LAUNCHES)}")
    ds_bg = (scores_bg - plain_scores(False)).abs().max().item()
    check(ds_bg <= SCORE_ATOL, f"use_background=False: max |kernels - all-plain| {ds_bg}")
    center = S // 2 * R + R // 2
    s_self, best_self = fn(fn.render(Tcw)[S // 2].clone(), Tcw)
    print(f"  self-consistency: argmax {int(best_self)} (center {center}), "
          f"score {s_self.flatten()[center].item():.6f}")
    check(int(best_self) == center, "a frame rendered at the center pose scores best at the center")

    stage = {}
    synth = fn.render(Tcw)
    warped = fn.warp(frame)
    stage["render"] = cuda_ms(lambda: fn.render(Tcw))
    stage["warp"] = cuda_ms(lambda: fn.warp(frame))
    stage["score"] = cuda_ms(lambda: fn.score(synth, warped))
    stage["total"] = cuda_ms(lambda: fn(frame, Tcw))
    print("  step ms (CUDA events, mean of 10 after 2 warm-up): "
          + ", ".join(f"{k} {v:.3f}" for k, v in stage.items()) + f"  [{smi}]")
    with tf32_on():  # fault C1: TF32 on for the whole process changes nothing
        scores_tf32, _ = fn(frame, Tcw)
    d_tf32 = (scores_tf32 - scores).abs().max().item()
    check(d_tf32 == 0.0, f"grid step with TF32 on: scores max |diff| {d_tf32} against the "
          "default run")
    stage["tf32_scores_gap"] = d_tf32

    print(f"build, kernel checks and the step took {time.perf_counter() - t_start:.1f} s")
    loc_record = localizer_phases(dev, smi, cuda_ms, check)
    track_record = tracking_phase(dev, smi, check, check_raster)
    map_record, session = mapping_phase(dev, smi, check, cuda_ms)
    try:
        loop_record = loop_phase(dev, smi, check, session)
    finally:
        session.shutdown()
    system_record = system_phase(dev, smi, check)
    settings_record = settings_phase(dev, smi, check)
    tools_record = tools_phase(dev, smi, check, cuda_ms)
    multichip_record = multichip_phase(smi, check)
    rc = track_record["raster_check"]
    rows["rasterize_keys"]["max_abs_err"] = max(rows["rasterize_keys"]["max_abs_err"],
                                                rc["raster_err"])
    rows["render_gray"]["max_abs_err"] = max(rows["render_gray"]["max_abs_err"],
                                             rc["render_gray_err"])

    out = []
    for name in ("joint_entropy", "marginal_entropy", "rasterize_keys", "render_gray"):
        rows[name]["launches"] = launches[name]  # counted over the grid step above
    rows.update(loc_record["splat_kernels"])  # counted a grid over the mode-4 localizer's run
    for name in ("joint_entropy", "marginal_entropy", "rasterize_keys", "render_gray",
                 "splat_scatter", "splat_resolve"):
        r = rows[name]
        out.append({"name": name, "route": "cuda", "source": r["source"],
                    "replaces": r["replaces"], "launches": r["launches"],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                    "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"]})
    print(json.dumps({"step_ms": stage, "raster_resources": raster_res, "card": smi}))
    print(json.dumps({"localizer": loc_record, "card": smi}))
    print(json.dumps({"tracking": track_record, "card": smi}))
    print(json.dumps({"mapping": map_record, "card": smi}))
    print(json.dumps({"loop": loop_record, "card": smi}))
    print(json.dumps({"system": system_record, "card": smi}, default=float))
    print(json.dumps({"settings": settings_record, "card": smi}, default=float))
    print(json.dumps({"tools": tools_record, "card": smi}, default=float))
    print(json.dumps({"multichip": multichip_record, "card": smi}, default=float))
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
