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
  5. prints a JSON line of the step times, one JSON line listing the
     kernels, then the final JSON line {"ok": true, "device": {...}}.
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
        k, u, v = raster.rasterize_keys_plain(*rargs)
        g = raster.sample_texture_plain(k, u, v, b.texture, th, tw, 0.0)
        img = raster._untile(g, S, b.tiles_y, b.tiles_x, b.height, b.width)
        a, w = hn.pack_bins(img), hn.pack_bins(fn.warp(frame))
        if not use_background:
            Hab, Ha, Hb = hn.joint_entropy_grid_plain(a, w, P, mask_zero=True)
            return hn._combine_pairwise(Ha, Hb, Hab, "SUC")
        Ha, Hb = hn.marginal_entropy_sets_plain(a, w, P).split([S, R])
        return hn._combine(Ha, Hb, hn.joint_entropy_grid_plain(a, w, P), "SUC")

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

    out = []
    for name in ("joint_entropy", "marginal_entropy", "rasterize_keys", "sample_texture"):
        r = rows[name]
        out.append({"name": name, "route": "cuda", "source": r["source"],
                    "replaces": r["replaces"], "launches": launches[name],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                    "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"]})
    print(json.dumps({"step_ms": stage, "card": smi}))
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
