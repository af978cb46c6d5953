"""Pipeline presets, mirror of nightlight_tpu/models/presets.py: the
operator DAG of a CLI command (reference: cmd/nightlight/main.go:285-405).
The port builds the ``stack`` command; the other commands are queued in
ROADMAP.md."""

from __future__ import annotations

import os


def build_preprocess_seq(args, op_star_detect, op_debayer):
    """The shared preprocessing sub-DAG (main.go:285-297)."""
    from nightlight_tpu_torch.pipeline.operators import ExportMode, OpSave, OpSequence
    from nightlight_tpu_torch.pipeline.ops_pre import (
        OpBackExtract, OpBadPixel, OpBin, OpCalibrate, OpDebandHoriz, OpDebandVert,
        OpScaleOffset)
    from nightlight_tpu_torch.pipeline.ops_ref import OpExportStats

    return OpSequence(steps=[
        OpCalibrate(dark=args.dark, flat=args.flat),
        OpBadPixel(sigma_low=args.bpSigLow, sigma_high=args.bpSigHigh, debayer=op_debayer),
        op_debayer,
        OpDebandHoriz(percentile=args.debandH, window=args.debandHWindow, sigma=args.debandHSigma),
        OpDebandVert(percentile=args.debandV, window=args.debandVWindow, sigma=args.debandVSigma),
        OpScaleOffset(scale=args.preScale, offset=args.preOffset),
        OpBin(bin_size=args.binning),
        op_star_detect,
        OpBackExtract(grid_size=args.backGrid, hfr_factor=args.backHFRFactor,
                      sigma=args.backSigma, clip=args.backClip,
                      save=OpSave(file_pattern=args.back, export_mode=int(ExportMode.MinMax),
                                  gamma=1)),
        OpExportStats(file_name=args.exportStats),
        OpSave(file_pattern=args.pre, export_mode=int(ExportMode.MinMax), gamma=1),
    ])


def _fused_spec_from_seq(op_preproc, args):
    """Fused-preprocess eligibility derived FROM the built sequence: every
    step outside calibrate + badPixel + starDetect [+ backExtract]
    [+ exportStats] must be a no-op and no per-frame save may be set.
    Returns (spec or None, reason or None)."""
    from nightlight_tpu_torch.pipeline.operators import Operator, OpSave
    from nightlight_tpu_torch.pipeline.ops_pre import (
        OpBackExtract, OpBadPixel, OpBin, OpCalibrate, OpDebandHoriz, OpDebandVert, OpDebayer,
        OpScaleOffset, OpStarDetect)
    from nightlight_tpu_torch.pipeline.ops_ref import OpExportStats
    from nightlight_tpu_torch.pipeline.ops_stack import FusedPreprocessSpec

    calibrate = bad_pixel = star_detect = debayer = scale_offset = op_bin = None
    deband_h = deband_v = back_extract = None
    for op in op_preproc.steps:
        if isinstance(op, OpCalibrate) and calibrate is None:
            calibrate = op
        elif isinstance(op, OpBadPixel) and bad_pixel is None:
            bad_pixel = op
        elif isinstance(op, OpDebayer) and debayer is None:
            debayer = op
        elif isinstance(op, OpDebandHoriz) and deband_h is None:
            deband_h = op
        elif isinstance(op, OpDebandVert) and deband_v is None:
            deband_v = op
        elif isinstance(op, OpScaleOffset) and scale_offset is None:
            scale_offset = op
        elif isinstance(op, OpBin) and op_bin is None:
            op_bin = op
        elif isinstance(op, OpBackExtract) and back_extract is None:
            if not op.is_noop():
                save = op.save
                if isinstance(save, Operator) and not save.is_noop():
                    return None, "backExtract with a per-frame background save"
                back_extract = op
        elif isinstance(op, OpStarDetect) and star_detect is None:
            save = op.save
            if isinstance(save, Operator) and not save.is_noop():
                return None, "starDetect with a per-frame star-image save"
            star_detect = op
        elif isinstance(op, (OpExportStats, OpSave)):
            continue
        elif not op.is_noop():
            return None, f"active '{op.TYPE}' step outside the fused chain"
    if bad_pixel is None or bad_pixel.is_noop():
        return None, "badPixel disabled"
    if star_detect is None or star_detect.is_noop():
        return None, "starDetect disabled"
    debayer_channel = debayer.channel if debayer is not None and not debayer.is_noop() else ""
    if getattr(bad_pixel.debayer, "channel", "") != debayer_channel:
        return None, "badPixel/debayer CFA wiring disagrees"
    for op in op_preproc.steps:
        if isinstance(op, OpSave) and not op.is_noop():
            return None, "per-frame save pattern in the preprocess chain"
    export_stats = next((op.file_name for op in op_preproc.steps
                         if isinstance(op, OpExportStats)), None)
    return FusedPreprocessSpec(
        dark=calibrate.dark if calibrate is not None else "",
        flat=calibrate.flat if calibrate is not None else "",
        bp_sigma_low=bad_pixel.sigma_low, bp_sigma_high=bad_pixel.sigma_high,
        star_radius=star_detect.radius, star_sig=star_detect.sigma,
        star_bp_sig=star_detect.bad_pixel_sigma, star_in_out=star_detect.in_out_ratio,
        export_stats=export_stats,
        debayer=debayer_channel,
        cfa=debayer.color_filter_array if debayer is not None else "RGGB",
        pre_scale=scale_offset.scale if scale_offset is not None else 1.0,
        pre_offset=scale_offset.offset if scale_offset is not None else 0.0,
        binning=op_bin.bin_size if op_bin is not None and not op_bin.is_noop() else 1,
        deband_h=((deband_h.percentile, deband_h.window, deband_h.sigma)
                  if deband_h is not None and not deband_h.is_noop() else None),
        deband_v=((deband_v.percentile, deband_v.window, deband_v.sigma)
                  if deband_v is not None and not deband_v.is_noop() else None),
        back_grid=back_extract.grid_size if back_extract is not None else 0,
        back_sigma=back_extract.sigma if back_extract is not None else 1.5,
        back_clip=back_extract.clip if back_extract is not None else 0,
        back_hfr_factor=back_extract.hfr_factor if back_extract is not None else 4.0), None


def build_command_seq(args):
    """The preset DAG of the current command (main.go:300-405)."""
    from nightlight_tpu_torch.pipeline.operators import ExportMode, OpLoadMany, OpSave, OpSequence
    from nightlight_tpu_torch.pipeline.ops_post import OpAlign, OpMatchHistogram, OutOfBoundsMode
    from nightlight_tpu_torch.pipeline.ops_pre import OpDebayer, OpStarDetect
    from nightlight_tpu_torch.pipeline.ops_ref import OpFilter, OpSelectReference, SelRefTarget
    from nightlight_tpu_torch.pipeline.ops_stack import OpStack, OpStackBatches

    cmd = args.command
    if cmd != "stack":
        raise NotImplementedError(f"the '{cmd}' command is not ported yet (queued in ROADMAP.md)")

    op_load_many = OpLoadMany(file_patterns=list(args.files))
    op_debayer = OpDebayer(channel=args.debayer, color_filter_array=args.cfa)
    op_star_detect = OpStarDetect(
        radius=args.starRadius, sigma=args.starSig, bad_pixel_sigma=args.starBpSig,
        in_out_ratio=args.starInOut,
        save=OpSave(file_pattern=args.stars, export_mode=int(ExportMode.MinMax), gamma=1))
    op_preproc = build_preprocess_seq(args, op_star_detect, op_debayer)
    fused_spec, fused_reason = _fused_spec_from_seq(op_preproc, args)
    return OpSequence(steps=[
        op_load_many,
        OpStackBatches(fused_spec=fused_spec, fused_reason=fused_reason,
                       per_batch=OpSequence(steps=[
                           op_preproc,
                           OpSelectReference(target=int(SelRefTarget.Histo), mode=args.histoRef,
                                             star_detect=op_star_detect),
                           OpSelectReference(target=int(SelRefTarget.Align), mode=args.alignRef,
                                             star_detect=op_star_detect),
                           OpFilter(min_stars=args.minStars),
                           OpMatchHistogram(mode=args.normHist),
                           # projection waits for the stack/save barrier, where
                           # check_align_drop resolves the drop decision first
                           OpAlign(k=args.alignK, threshold=args.alignT,
                                   oob_mode=int(OutOfBoundsMode.NaN), defer_warp=True),
                           OpSave(file_pattern=args.post, export_mode=int(ExportMode.MinMax),
                                  gamma=1),
                           # negative sigma: goal-seek the sigmas from the target
                           # clip percentages (ops/findsigma.py)
                           OpStack(mode=args.stMode, weighting=args.stWeight,
                                   sigma_low=args.stSigLow, sigma_high=args.stSigHigh),
                           op_star_detect,
                           OpSave(file_pattern=args.batch, export_mode=int(ExportMode.MinMax),
                                  gamma=1),
                       ])),
        op_star_detect,
        OpSave(file_pattern=args.out, export_mode=int(ExportMode.MinMax), gamma=1),
        OpSave(file_pattern=args.tiff, export_mode=int(ExportMode.Zero65535), gamma=1),
        OpSave(file_pattern=args.jpg, export_mode=int(ExportMode.Zero65535), gamma=args.jpgGamma),
    ])
