"""Fused frame-batch preprocessing of the CLI ``stack`` path, mirror of
nightlight_tpu/models/fastpath.py.

For a whole batch of loaded frames: calibration, bad-pixel repair (CFA-aware
with debayer), debayer, deband, pixel math, binning, min/mean/max, the
-lsEst 3 location/scale (same sampled estimator draws as the JAX package),
star detection and background extraction, then the per-frame log lines of
the operator chain it replaces (OpCalibrate, OpBadPixel, OpDebayer,
OpDebandHoriz/Vert, OpScaleOffset, OpBin, OpStarDetect, OpBackExtract,
OpExportStats). The JAX package traces this into one device program; the
port runs it as eager torch code: the light phases frame by frame (their
temporaries stay one frame in size; each input frame is released once its
output is written), the estimator batched over all frames, detection in
DETECT_CHUNK-frame slices.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from nightlight_tpu_torch import trace
from nightlight_tpu_torch.detect.stars import MAX_CANDIDATES, find_stars_batch
from nightlight_tpu_torch.image import bin_block_mean
from nightlight_tpu_torch.ops import pixelmath as pm
from nightlight_tpu_torch.ops.prestack import (
    bad_pixel_repair, bad_pixel_stats, cfa_offsets, cosmetic_correction_bayer,
    debayer_bilinear, flat_divide, subtract)
from nightlight_tpu_torch.ops.stats import LSEstimatorMode, Stats, location_scale, min_mean_max

# frames per detection slice: detection's candidate buffers, not the frame
# pixels, dominate its working set
DETECT_CHUNK = 8
BIG = 3.4e38


def match_histograms_batch(frames, locs, scales, ref_loc, ref_scale):
    """Per-frame linear histogram match of a (N, H, W) batch
    (pixelops.go:601-611 over the frame axis)."""
    dev = frames.device
    locs = torch.as_tensor(locs, dtype=torch.float32, device=dev)
    scales = torch.as_tensor(scales, dtype=torch.float32, device=dev)
    ref_loc = torch.as_tensor(ref_loc, dtype=torch.float32, device=dev)
    ref_scale = torch.as_tensor(ref_scale, dtype=torch.float32, device=dev)
    mult = (ref_scale / scales)[:, None, None]
    off = (ref_loc - locs * (ref_scale / scales))[:, None, None]
    return frames * mult + off


def _deband_stage(img, params, horizontal: bool):
    """One deband pass with the per-frame path's threshold: for sigma != 0
    location and scale of the current image (the estimator's PRNGKey(0)
    draws), loc + sigma*scale as the JAX program's fused multiply-add; 3.4e38
    for sigma 0. Returns (image, lowest, highest, threshold)."""
    from nightlight_tpu_torch.ops.deband import deband_core

    perc, window, dsigma = params
    dev = img.device
    if dsigma != 0:
        fl = img.reshape(1, -1)
        mn, _, mx = min_mean_max(fl)
        loc, scale = location_scale(fl, mn, mx)
        thr = pm.fma32(torch.tensor(float(dsigma), dtype=torch.float32, device=dev),
                       scale[0], loc[0])
    else:
        thr = torch.tensor(BIG, dtype=torch.float32, device=dev)
    n = img.shape[0] if horizontal else img.shape[1]
    out, lo, hi = deband_core(img, perc, min(int(window), n), thr, horizontal)
    return out, lo, hi, thr


def _preprocess_frame(img, dark, flat, flat_max, spec):
    """The light phases of one (H, W) frame, in the per-frame chain's order.
    Returns (image, n_bad, diff_std, six deband scalars)."""
    if dark is not None:
        img = subtract(img, dark)
    if flat is not None:
        img = flat_divide(img, flat, flat_max)
    if spec.debayer:
        img, n_bad = cosmetic_correction_bayer(img, spec.debayer, spec.cfa,
                                               spec.bp_sigma_low, spec.bp_sigma_high)
        img = debayer_bilinear(img, spec.debayer, spec.cfa)
        diff_std = None
    else:
        img, n_bad, diff_std = bad_pixel_repair(img, spec.bp_sigma_low, spec.bp_sigma_high)
    zero = torch.zeros((), dtype=torch.float32, device=img.device)
    deband = [zero] * 6
    for k, (params, horizontal) in enumerate(((spec.deband_h, True), (spec.deband_v, False))):
        if params is not None:
            img, lo, hi, thr = _deband_stage(img, params, horizontal)
            deband[3 * k:3 * k + 3] = [lo, hi, thr]
    if spec.pre_scale != 1 or spec.pre_offset != 0:
        img = pm.scale_offset(img, spec.pre_scale, spec.pre_offset)
    if spec.binning and spec.binning > 1:
        img = bin_block_mean(img, int(spec.binning))
    if diff_std is None:
        # the OSC chain leaves median_diff_stats unset, so detection's
        # bad-pixel threshold comes from the final image (find_stars)
        diff_std = bad_pixel_stats(img)[1]
    return img, n_bad, diff_std, deband


def preprocess_frames(frames: list, dark, flat, flat_max, spec,
                      max_candidates=MAX_CANDIDATES):
    """The fused chain for a list of (H, W) frames, which it empties as it
    goes: the output batch is allocated at the output shape (debayer with
    an offset CFA crops, binning shrinks) and each input frame released once
    written. Returns the (N, H', W') batch, per-frame [n_bad, diff_std, min,
    mean, max, location, scale, six deband scalars] host rows, the star
    lists and the average HFRs."""
    n = len(frames)
    batch = None
    per_frame = []
    for i in range(n):
        img, n_bad, diff_std, deband = _preprocess_frame(frames[i], dark, flat, flat_max, spec)
        frames[i] = None
        if batch is None:
            batch = torch.empty((n, *img.shape), dtype=torch.float32, device=img.device)
        batch[i] = img
        del img
        per_frame.append((n_bad, diff_std, deband))
    flat_b = batch.reshape(n, -1)
    mn, me, mx = min_mean_max(flat_b)
    loc, scale = location_scale(flat_b, mn, mx)
    n_bad = torch.stack([p[0] for p in per_frame]).to(torch.float32)
    diff_std_t = torch.stack([p[1] for p in per_frame])
    deband = torch.stack([torch.stack(p[2]) for p in per_frame])

    stars, hfrs = [], []
    for s in range(0, n, DETECT_CHUNK):
        e = min(n, s + DETECT_CHUNK)
        st, hf = find_stars_batch(batch[s:e], loc[s:e], scale[s:e], spec.star_sig,
                                  spec.star_bp_sig, spec.star_in_out,
                                  int(spec.star_radius), diff_std_t[s:e], max_candidates)
        stars.extend(st)
        hfrs.extend(hf)
    scalars = trace.to_host(torch.cat([torch.stack([n_bad, diff_std_t, mn, me, mx, loc, scale],
                                                   dim=1), deband], dim=1)).numpy()
    return batch, scalars, stars, hfrs


def fused_batch_eligible(images, c) -> tuple[bool, str | None]:
    """The fused executor handles uniform 2D batches (mono or one CFA
    mosaic) on the default estimator. Returns (eligible, reason when not)."""
    if c.mesh is not None:  # sharded runs use the per-frame + mesh path
        return False, "sharded run (mesh active)"
    if c.ls_estimator_mode != LSEstimatorMode.SCMedianQn:
        return False, f"non-default location/scale estimator {int(c.ls_estimator_mode)}"
    if not images:
        return False, "empty batch"
    shape0 = images[0].data.shape
    if not all(f.data.dim() == 2 and f.data.shape == shape0 for f in images):
        return False, "non-uniform or non-mono frame shapes"
    return True, None


@contextlib.contextmanager
def per_frame_path(active: bool = True, reason: str = "per-frame comparison"):
    """While active, every batch is found ineligible for the fused executor
    (`reason`), so an unsharded run takes the per-frame operator path that a
    mesh takes, after the same loads and batch plan: the unsharded side of a
    sharded-vs-unsharded comparison."""
    global fused_batch_eligible
    eligible = fused_batch_eligible
    if active:
        fused_batch_eligible = lambda images, c: (False, reason)
    try:
        yield
    finally:
        fused_batch_eligible = eligible


@trace.span("preprocess")
def run_fused_preprocess(images, c, spec) -> list:
    """Run the fused preprocess chain for a batch of loaded Images and emit
    the per-frame operator log lines in the chain's order. Mutates and
    returns the Images. spec: pipeline.ops_stack.FusedPreprocessSpec."""
    dark = flat = None
    flat_max = 1.0
    if spec.dark or spec.flat:
        from nightlight_tpu_torch.pipeline.ops_pre import OpCalibrate

        OpCalibrate(dark=spec.dark, flat=spec.flat)._init_masters(c)
        dark, flat = c.dark_frame, c.flat_frame
        if flat is not None:
            flat_max = float(flat.stats.max)

    for f in images:
        for master, what in ((dark, "dark"), (flat, "flat")):
            if master is None or f.naxisn == master.naxisn:
                continue
            if f.pixels != master.pixels:
                raise ValueError(f"{f.id}: Light dimensions {f.naxisn} differ from {what} "
                                 f"dimensions {master.naxisn}")
            c.logf("%d: Warning: light dimensions %s differ from %s dimensions %s "
                   "but same product, ignoring for Seestar",
                   f.id, f.naxisn, what, master.naxisn)

    shape = images[0].data.shape
    frames = []
    for f in images:
        frames.append(f.data)
        f.data = None  # the frame list holds the pixels now
        f.stats.free_data()
    batch, scalars, stars, hfrs = preprocess_frames(
        frames, dark.data.reshape(shape) if dark is not None else None,
        flat.data.reshape(shape) if flat is not None else None, flat_max, spec)

    export_stats = None
    if spec.export_stats is not None:
        from nightlight_tpu_torch.pipeline.ops_ref import OpExportStats

        export_stats = OpExportStats(file_name=spec.export_stats)

    out_h, out_w = int(batch.shape[1]), int(batch.shape[2])
    n = len(images)
    # background extraction from this batch's detections; the cells of all
    # frames read back together (ops/background.fit_background_batch)
    backs = None
    if spec.back_grid and spec.back_grid > 0:
        from nightlight_tpu_torch.ops.background import fit_background_batch

        backs = fit_background_batch([batch[i] for i in range(n)], stars, int(spec.back_grid),
                                     float(spec.back_sigma), int(spec.back_clip),
                                     float(spec.back_hfr_factor))
    if spec.debayer:
        xo, yo = cfa_offsets(spec.cfa)
        adj_w, adj_h = (shape[1] - xo) & ~1, (shape[0] - yo) & ~1
    for i, f in enumerate(images):
        (n_bad, diff_std, mn, me, mx, loc, scale,
         dbh_lo, dbh_hi, dbh_thr, dbv_lo, dbv_hi, dbv_thr) = scalars[i]
        # the pixel count before any debayer or binning resize; float32
        # 100 * n / pixels, as the JAX package formats it
        pct = 100.0 * np.float32(n_bad) / f.pixels
        if spec.debayer:
            c.logf("%d: Removed %d bad bayer pixels (%.2f%%) with sigma low=%.2f high=%.2f\n",
                   f.id, int(n_bad), pct, spec.bp_sigma_low, spec.bp_sigma_high)
        else:
            c.logf("%d: Removed %d bad pixels (%.2f%%) with sigma low=%.2f high=%.2f\n",
                   f.id, int(n_bad), pct, spec.bp_sigma_low, spec.bp_sigma_high)
        if backs is not None:
            # the Stars line below prints the statistics before the
            # subtraction (the per-frame chain logs them at OpStarDetect);
            # the frame's own statistics recompute on the subtracted image
            f.set_data(backs[i].subtract(batch[i]), naxisn=[out_w, out_h])
            pre_stats = Stats.with_all(f.data, out_w, mn, mx, me, loc, scale,
                                       mode=c.ls_estimator_mode)
        else:
            f.set_data(batch[i], naxisn=[out_w, out_h])
            f.stats = pre_stats = Stats.with_all(f.data, out_w, mn, mx, me, loc, scale,
                                                 mode=c.ls_estimator_mode)
        f.median_diff_stats = None if spec.debayer else Stats.from_stddev(diff_std)
        if spec.debayer:
            c.logf("%d: Debayered channel %s from cfa %s, new size %dx%d\n",
                   f.id, spec.debayer, spec.cfa, adj_w, adj_h)
        if spec.deband_h is not None:
            c.logf("%d: De-banded horizontally with %.3fth percentile, window %d, "
                   "sigma %.2f, threshold %.2f, factors in [%.3f, %.3f]\n",
                   f.id, spec.deband_h[0], int(spec.deband_h[1]), spec.deband_h[2],
                   float(dbh_thr) if spec.deband_h[2] != 0 else BIG,
                   float(dbh_lo), float(dbh_hi))
        if spec.deband_v is not None:
            c.logf("%d: De-banded vertically with %.3fth percentile, window %d "
                   "and sigma %.2f, threshold %.2f, factors in [%.3f, %.3f]\n",
                   f.id, spec.deband_v[0], int(spec.deband_v[1]), spec.deband_v[2],
                   float(dbv_thr) if spec.deband_v[2] != 0 else BIG,
                   float(dbv_lo), float(dbv_hi))
        if spec.pre_scale != 1 or spec.pre_offset != 0:
            c.logf("%d: Applying pixel math x = x * %.3f + %.3f%%\n",
                   f.id, spec.pre_scale, spec.pre_offset * 100)
        if spec.binning and spec.binning > 1:
            c.logf("%d: After %dx%d binning, new image size %dx%d\n",
                   f.id, spec.binning, spec.binning, out_w, out_h)
        f.stars = stars[i]
        f.hfr = hfrs[i]
        c.logf("%d: Stars %d HFR %.2f %s\n", f.id, f.stars.count, f.hfr, pre_stats)
        if backs is not None:
            c.logf("%d: %s\n", f.id, backs[i])
        if export_stats is not None:
            export_stats.apply(f, c)
    return images
