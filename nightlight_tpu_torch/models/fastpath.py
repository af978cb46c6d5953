"""Fused frame-batch preprocessing of the CLI ``stack`` path, mirror of
nightlight_tpu/models/fastpath.py.

For a whole batch of loaded frames: calibration, bad-pixel repair,
min/mean/max, the -lsEst 3 location/scale (same sampled estimator draws as
the JAX package) and star detection, then the per-frame log lines of the
operator chain it replaces (OpCalibrate, OpBadPixel, OpStarDetect,
OpExportStats). The JAX package traces this into one device program; the
port runs it as eager batched torch code: the light phases per frame (their
3x3-median temporaries stay one frame in size), the estimator batched over
all frames, detection in DETECT_CHUNK-frame slices.

Only the mono default chain is ported here; debayer, deband, pixel math,
binning and background extraction raise NotImplementedError.
"""

from __future__ import annotations

import numpy as np
import torch

from nightlight_tpu_torch.detect.stars import MAX_CANDIDATES, find_stars_batch
from nightlight_tpu_torch.ops.prestack import bad_pixel_repair, flat_divide, subtract
from nightlight_tpu_torch.ops.stats import LSEstimatorMode, Stats, location_scale, min_mean_max

# frames per detection slice: detection's candidate buffers, not the frame
# pixels, dominate its working set
DETECT_CHUNK = 8


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


def _unported_stage(spec) -> str | None:
    if spec.debayer:
        return "debayer"
    if spec.deband_h is not None or spec.deband_v is not None:
        return "deband"
    if spec.pre_scale != 1 or spec.pre_offset != 0:
        return "scaleOffset"
    if spec.binning and spec.binning > 1:
        return "binning"
    if spec.back_grid and spec.back_grid > 0:
        return "backExtract"
    return None


def preprocess_frames(batch, dark, flat, flat_max, spec, max_candidates=MAX_CANDIDATES):
    """calibrate + badPixel + stats + starDetect for a (N, H, W) batch,
    repairing it in place. Returns per-frame (n_bad, diff_std, min, mean,
    max, location, scale) host lists and the star lists and average HFRs."""
    stage = _unported_stage(spec)
    if stage is not None:
        raise NotImplementedError(
            f"the fused stack preprocess of the port does not implement '{stage}' "
            "yet (queued in ROADMAP.md)")
    n = batch.shape[0]
    n_bad, diff_std = [], []
    for i in range(n):
        img = batch[i]
        if dark is not None:
            img = subtract(img, dark)
        if flat is not None:
            img = flat_divide(img, flat, flat_max)
        rep, nb, sd = bad_pixel_repair(img, spec.bp_sigma_low, spec.bp_sigma_high)
        batch[i] = rep
        n_bad.append(nb)
        diff_std.append(sd)
    flat_b = batch.reshape(n, -1)
    mn, me, mx = min_mean_max(flat_b)
    loc, scale = location_scale(flat_b, mn, mx)
    diff_std_t = torch.stack(diff_std)

    stars, hfrs = [], []
    for s in range(0, n, DETECT_CHUNK):
        e = min(n, s + DETECT_CHUNK)
        st, hf = find_stars_batch(batch[s:e], loc[s:e], scale[s:e], spec.star_sig,
                                  spec.star_bp_sig, spec.star_in_out,
                                  int(spec.star_radius), diff_std_t[s:e], max_candidates)
        stars.extend(st)
        hfrs.extend(hf)
    scalars = torch.stack([torch.stack(n_bad).to(torch.float32), diff_std_t, mn, me, mx,
                           loc, scale], dim=1).cpu().tolist()
    return scalars, stars, hfrs


def fused_batch_eligible(images, c) -> tuple[bool, str | None]:
    """The fused executor handles uniform mono 2D batches on the default
    estimator. Returns (eligible, reason when not)."""
    if c.ls_estimator_mode != LSEstimatorMode.SCMedianQn:
        return False, f"non-default location/scale estimator {int(c.ls_estimator_mode)}"
    if not images:
        return False, "empty batch"
    shape0 = images[0].data.shape
    if not all(f.data.dim() == 2 and f.data.shape == shape0 for f in images):
        return False, "non-uniform or non-mono frame shapes"
    return True, None


def run_fused_preprocess(images, c, spec) -> list:
    """Run calibrate+badPixel+starDetect(+exportStats) for a batch of loaded
    Images and emit the per-frame operator log lines. Mutates and returns
    the Images. spec: pipeline.ops_stack.FusedPreprocessSpec."""
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
    batch = torch.stack([f.data for f in images])
    for f in images:
        f.data = None  # the batch holds the pixels now
    scalars, stars, hfrs = preprocess_frames(
        batch, dark.data.reshape(shape) if dark is not None else None,
        flat.data.reshape(shape) if flat is not None else None, flat_max, spec)

    export_stats = None
    if spec.export_stats is not None:
        from nightlight_tpu_torch.pipeline.ops_ref import OpExportStats

        export_stats = OpExportStats(file_name=spec.export_stats)

    out_h, out_w = int(batch.shape[1]), int(batch.shape[2])
    for i, f in enumerate(images):
        n_bad, diff_std, mn, me, mx, loc, scale = scalars[i]
        # float32 arithmetic for the percentage, as the JAX package formats it
        c.logf("%d: Removed %d bad pixels (%.2f%%) with sigma low=%.2f high=%.2f\n",
               f.id, int(n_bad), 100.0 * np.float32(n_bad) / f.pixels,
               spec.bp_sigma_low, spec.bp_sigma_high)
        f.set_data(batch[i], naxisn=[out_w, out_h])
        f.stats = Stats.with_all(f.data, out_w, mn, mx, me, loc, scale,
                                 mode=c.ls_estimator_mode)
        f.median_diff_stats = Stats.from_stddev(diff_std)
        f.stars = stars[i]
        f.hfr = hfrs[i]
        c.logf("%d: Stars %d HFR %.2f %s\n", f.id, f.stars.count, f.hfr, f.stats)
        if export_stats is not None:
            export_stats.apply(f, c)
    return images
