#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It
  1. prints the card's name and power limit (nvidia-smi);
  2. builds the CUDA kernels from `orbslam2_nmi_torch/csrc/` (timed);
  3. holds each kernel against its plain PyTorch version on the card, at the
     shapes of the main path, within the tolerances stated below, and times
     kernel, plain version and (where one exists) one PyTorch library call;
     holds B1, B2 and B3 against their plain versions on adversarial inputs
     too (`orbslam2_nmi_torch/kernel_cases.py`); times B2's C entry point
     alone beside its wrapper, so the wrapper's host time shows;
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
  6. drives the localizer on the mesh's point sampling (render mode 4, the
     point splat), case (a), where only B1 and B2 may launch, with the same
     all-plain checks;
  7. drives the per-frame tracking front-end (`entry.tracking_entry()`,
     960x540, 2,000 ORB features, 2,048 local-map candidates), seeded from
     ground truth: renders frames 6-55 of the 520-frame circuit (B3 and the
     sampler, launch counts set to 0 just before and read after the chain),
     runs the step over frames 8-55 with each frame's carry feeding the next
     and the candidates rebuilt at the last estimate; checks every frame
     against the tracking gate and the camera-center error against ground
     truth; holds B3 and the sampler against their plain versions on frame
     8's binning of the circuit's terrain; holds eager against CUDA-graph
     replay bit for bit on three frames, runs a step under
     `set_sync_debug_mode("error")`, runs one with TF32 turned on, holds the
     first frame's step against the CPU's; times the step eagerly (by
     stage) and replayed, the host's share of a frame, and the rendering of
     one frame and its host binning;
  8. prints a JSON line of the step times, one of the localizer's, one of the
     tracking phase's, one JSON line listing the kernels, then the final JSON
     line {"ok": true, ...}.
Any failed check raises, and the script exits non-zero without the final
line. It also exits non-zero when CUDA is absent or the package is missing.
"""

import json
import subprocess
import sys
import time

# Tolerances (kernel vs plain version, both on the card).
ENTROPY_ATOL = 1e-5  # exact integer histograms; only the f64 sum order and logf differ
RASTER_MISMATCH_FRAC = 1e-4  # hit mask, u, v: same f32 operations, so expected bit for bit
RASTER_DEPTH_LEVELS = 2  # depth bits (key >> 11) where both hit
SAMPLER_ATOL = 0.0  # no FMA contraction, bf16 rounding copied: bit for bit
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

# Peak rates of one H100 SXM (NVIDIA data sheet, at the 700 W limit), for bounds.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12  # f32 outside the tensor cores; also used for int increments


def _bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / SCALAR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


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

    S = offsets.shape[0]
    k, u, v = raster.rasterize_keys_plain(
        b.tri_data, raster.grid_poses(Tcw, offsets), b.capacity, float(K[0, 0]),
        float(K[1, 1]), float(K[0, 2]), float(K[1, 2]), near, b.tiles_x)
    g = raster.sample_texture_plain(k, u, v, b.texture, *b.tex_hw, 0.0)
    img = raster._untile(g, S, b.tiles_y, b.tiles_x, b.height, b.width)
    return _plain_nmi(img, warped, use_background)


def localizer_phases(dev, smi, cuda_ms, check):
    """Phases 5 and 6: the NMI localizer at 960x540 in both render modes.
    Returns their record for the JSON line."""
    import dataclasses

    import numpy as np
    import torch

    from orbslam2_nmi_torch import entry as entry_mod
    from orbslam2_nmi_torch import kernels
    from orbslam2_nmi_torch.slam.nmi import search_kernel as sk
    from orbslam2_nmi_torch.slam.nmi.localizer import NMILocalizer, _euler_zyx_matrix

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

    def plain_check(name, loc, frame, Tcw, kernel, scale, scores):
        """Score the grid again on the same sweep inputs (binning, offsets,
        warped frame) with every kernel replaced by its plain version; the
        scores must agree within SCORE_ATOL, with the same argmax. Plain
        versions launch nothing, so the launch counts are untouched."""
        sw = loc.prepare_sweep(frame, Tcw, kernel, scale)
        warped = loc.warp_sweep(sw)
        use_bg = loc.cfg.use_background
        if sw.binned is not None:
            plain = _all_plain_scores(sw.binned, sw.Tcw, sw.K, sw.offsets, loc.cfg.render_near,
                                      warped, use_bg)
        else:  # the splat is torch ops: only B1 and B2 have plain versions
            plain = _plain_nmi(loc.render_sweep(sw), warped, use_bg)
        plain = plain.cpu().numpy()
        d = float(np.abs(scores - plain).max())
        am, pm = int(scores.argmax()), int(plain.argmax())
        what = f"{name}, first {kernel.n_synth} x {kernel.n_warp} grid at {sw.width}x{sw.height}"
        binning = ("" if sw.binned is None else f", binning tiles {sw.binned.tiles_y}x"
                   f"{sw.binned.tiles_x}, capacity {sw.binned.capacity}, overflow "
                   f"{sw.binned.overflow}")
        print(f"  {what}{binning}: max |kernels - all-plain| {d}, argmax {am} vs {pm}, "
              f"best {scores.max():.6f}")
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

        def rec(frame, Tcw, kernel, scale=1):
            scores = evaluate(frame, Tcw, kernel, scale)
            shape = (kernel.n_synth, kernel.n_warp, scale)
            if shape not in [c[:3] for c in calls]:
                plain_check(name, loc, frame, Tcw, kernel, scale, scores)
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
                "rasterize_keys": n if mesh else 0, "sample_texture": n if mesh else 0}
        check(launches == want, f"{name}: launches {want}, one a grid evaluation")
        del loc.evaluate_grid  # the recorder
        ms, runs = wall_ms(lambda: loc.relocalize_strategy(frame, T.copy(), **kw))
        print(f"  {name}: {ms:.3f} ms a call (runs {[round(t, 3) for t in runs]}, after 1 "
              f"warm-up; {out.iterations} iterations, {n} grids)  [{smi}]")
        record[name] = dict(ms=ms, runs_ms=runs, iterations=out.iterations, grids=n,
                            nmi=out.nmi, relocalized=out.relocalized)
        return out, calls

    def split(loc, frame, T, kernel):
        """One sweep through the localizer's own stages, each timed alone:
        prepare (host: the mesh's bin_mesh and the uploads), render, warp
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
    T_rot[:3, :3] = _euler_zyx_matrix(torch.tensor([0.0, 0.03, 0.0])).numpy()
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
    loc4, frame4, _ = entry_mod.localizer_entry(device=dev, render_mode=4)
    n_points = loc4.model.points.shape[0]
    print(f"  {n_points} points (mesh_to_points of the toy mesh), frame coverage "
          f"{(frame4 > 0).float().mean().item():.4f}")
    out, _ = run_case("(a) initialization, pointcloud", loc4, frame4, T_pert,
                      dict(initializing=True), False)
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
    check(launches["rasterize_keys"] == n + 2 and launches["sample_texture"] == n + 2,
          f"B3 and the sampler launched once a rendered frame ({n + 2})")
    errs = np.array(rec["err_m"])
    print(f"  camera-center error over {n} frames: median {np.median(errs):.5f} m, "
          f"max {errs.max():.5f} m")
    check(errs.max() < TRACK_ERR_M, f"camera-center error under {TRACK_ERR_M} m on every frame")
    check(step._graph is not None, "the step was captured in a CUDA graph on its first call")

    # --- B3 and the sampler against their plain versions at the circuit's binning
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
    err_s = (raster.sample_texture(keys, uu, vv, bt.texture, th, tw, 0.0)
             - raster.sample_texture_plain(keys, uu, vv, bt.texture, th, tw, 0.0)).abs().max().item()
    check(err_s <= SAMPLER_ATOL, f"frame {TRACK_FIRST}'s binning, sampler ({th}x{tw} texture): "
          f"max |kernel - plain| {err_s} <= {SAMPLER_ATOL}")
    raster_check = dict(capacity=bt.capacity, tiles=[bt.tiles_y, bt.tiles_x],
                        raster_err=d_raster["err"], sampler_err=err_s,
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
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = step.run_eager(*args)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
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
    print(f"  rendering one frame (render_frames: host binning, upload, B3, sampler), ms: mean "
          f"{render_ms:.3f} (runs {[round(t, 3) for t in render_runs]}); its host binning "
          f"alone (bin_mesh): mean {bin_ms:.3f} (runs {[round(t, 3) for t in bin_runs]}); "
          f"each after 1 warm-up  [{smi}]")
    print(f"  phase took {time.perf_counter() - t_phase:.1f} s")
    return dict(frames=n, first=TRACK_FIRST, err_median_m=float(np.median(errs)),
                err_max_m=float(errs.max()), n_matches1_min=int(min(rec["n_matches1"])),
                n_inliers_min=int(min(rec["n_inliers"])), step_ms=mean, stage_ms=stage_ms,
                render_ms=render_ms, render_runs_ms=render_runs, bin_ms=bin_ms,
                bin_runs_ms=bin_runs, raster_check=raster_check, launches=launches,
                tf32_tcw_gap=d_tf32, card_vs_cpu=vs)


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
          f"warp shift bound {fn.shift_bound}")
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

    # --- sampler (B4 and B5) ---------------------------------------------------
    # The reference samples the entry's binning through per-tile windows (B5)
    # and a binning with a 128x128 texture whole (B4). The port's one sampler
    # reads the whole texture in both, so its two checks differ only in the
    # texture's size.
    print("kernel sample_texture (B4/B5), windowed binning")
    th, tw = b.tex_hw
    check(win > 0, f"the reference samples the entry's binning through windows (side {win})")
    gray = raster.sample_texture(keys, uu, vv, b.texture, th, tw, 0.0)
    pgray = raster.sample_texture_plain(keys, uu, vv, b.texture, th, tw, 0.0)
    err_s = (gray - pgray).abs().max().item()
    check(err_s <= SAMPLER_ATOL, f"windowed binning: max |kernel - plain| {err_s} <= {SAMPLER_ATOL}")
    print("kernel sample_texture (B4/B5), whole-texture binning")
    m2 = entry_mod._toy_mesh()
    m2.texture_gray = m2.texture_gray[:128, :128]
    b2 = raster.bin_mesh(m2, np.eye(4, dtype=np.float32), K, b.height, b.width, entry_mod.NEAR,
                         entry_mod.FAR, max_offset=entry_mod.SYNTH_STEP, device=dev)
    check(texture_window(b2) == 0, "the reference samples the second binning's texture whole")
    k2, u2, v2 = raster.rasterize_keys(b2.tri_data, poses, b2.capacity, *rargs[3:])
    g2 = raster.sample_texture(k2, u2, v2, b2.texture, *b2.tex_hw, 0.0)
    err_w = (g2 - raster.sample_texture_plain(k2, u2, v2, b2.texture, *b2.tex_hw, 0.0)).abs().max().item()
    check(err_w <= SAMPLER_ATOL, f"whole-texture binning: max |kernel - plain| {err_w} <= {SAMPLER_ATOL}")
    grid = torch.stack([uu * 2 - 1, (1 - vv) * 2 - 1], -1).reshape(1, -1, raster.TILE_W, 2)
    tex4 = b.texture[:th, :tw][None, None]
    bound, by = _bound_ms(16 * n_pix + b.texture.numel() * 4, 20 * n_pix)
    rows["sample_texture"] = dict(
        source="orbslam2_nmi_torch/csrc/sample_texture.cu",
        replaces="orbslam2_nmi_tpu/ops/raster.py:722 (B4) and :693 (B5)",
        max_abs_err=max(err_s, err_w),
        ms=cuda_ms(lambda: raster.sample_texture(keys, uu, vv, b.texture, th, tw, 0.0)),
        plain_ms=cuda_ms(lambda: raster.sample_texture_plain(keys, uu, vv, b.texture, th, tw, 0.0)),
        bound_ms=bound, bound_by=by,
        library_ms=cuda_ms(lambda: torch.nn.functional.grid_sample(
            tex4, grid, mode="bilinear", align_corners=True)))
    del k2, u2, v2, g2, pgray

    # --- B2 and B1 on the main path's images ----------------------------------
    synth = raster._untile(gray, S, b.tiles_y, b.tiles_x, b.height, b.width)
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
    rows["joint_entropy"] = dict(
        source="orbslam2_nmi_torch/csrc/histogram_nmi.cu",
        replaces="orbslam2_nmi_tpu/ops/histogram_nmi.py:266", max_abs_err=e1,
        ms=cuda_ms(lambda: hn.joint_entropy_grid(sb, wb, P)),
        plain_ms=cuda_ms(lambda: hn.joint_entropy_grid_plain(sb, wb, P), reps=2, warmup=1),
        bound_ms=bound, bound_by=by, library_ms=None)

    # --- the main path ----------------------------------------------------------
    print("main path: entry() step at full width")
    kernels.reset_launches()
    scores, best = fn(frame, Tcw)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"  launches: {launches}")
    check(all(n > 0 for n in launches.values()), "every kernel of the path launched")
    check(launches["marginal_entropy"] == 1, "B2 launched once for renders and warps together")
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

    print(f"build, kernel checks and the step took {time.perf_counter() - t_start:.1f} s")
    loc_record = localizer_phases(dev, smi, cuda_ms, check)
    track_record = tracking_phase(dev, smi, check, check_raster)
    rc = track_record["raster_check"]
    rows["rasterize_keys"]["max_abs_err"] = max(rows["rasterize_keys"]["max_abs_err"],
                                                rc["raster_err"])
    rows["sample_texture"]["max_abs_err"] = max(rows["sample_texture"]["max_abs_err"],
                                                rc["sampler_err"])

    out = []
    for name in ("joint_entropy", "marginal_entropy", "rasterize_keys", "sample_texture"):
        r = rows[name]
        out.append({"name": name, "route": "cuda", "source": r["source"],
                    "replaces": r["replaces"], "launches": launches[name],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                    "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"]})
    print(json.dumps({"step_ms": stage, "card": smi}))
    print(json.dumps({"localizer": loc_record, "card": smi}))
    print(json.dumps({"tracking": track_record, "card": smi}))
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
