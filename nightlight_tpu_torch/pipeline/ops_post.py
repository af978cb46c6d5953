"""Histogram normalization and alignment operators
(reference: internal/ops/post/postprocess.go), mirror of
nightlight_tpu/pipeline/ops_post.py."""

from __future__ import annotations

from enum import IntEnum

import numpy as np

from nightlight_tpu_torch.align import transform as tf
from nightlight_tpu_torch.image import Image
from nightlight_tpu_torch.ops import pixelmath as pm
from nightlight_tpu_torch.pipeline.context import Context
from nightlight_tpu_torch.pipeline.operators import UnaryOperator, materialize_all, register


class HistoNormMode(IntEnum):
    """Histogram normalization modes (postprocess.go:33-39)."""

    NoNorm = 0
    Location = 1
    LocScale = 2
    LocBlack = 3
    Auto = 4


class OutOfBoundsMode(IntEnum):
    """Out-of-bounds fill for projection (postprocess.go:99-103)."""

    NaN = 0
    RefLocation = 1
    OwnLocation = 2


@register
class OpMatchHistogram(UnaryOperator):
    """Match the histogram against the context reference (postprocess.go:41-94)."""

    TYPE = "matchHist"
    PARAMS = {"mode": ("mode", int(HistoNormMode.LocScale))}

    def apply(self, f: Image, c: Context):
        if f is None:
            return None
        mode = HistoNormMode(self.mode)
        if mode == HistoNormMode.NoNorm:
            return f
        if c.match_histo is None:
            raise ValueError("missing histogram reference")
        if mode == HistoNormMode.Location:
            multiplier = c.match_histo.location / f.stats.location
            f.data = pm.match_location(f.data, f.stats.location, c.match_histo.location)
            f.stats.replace_data(f.data)
            f.stats.update_cached_with(multiplier, 0.0)
        elif mode == HistoNormMode.LocScale:
            multiplier = c.match_histo.scale / f.stats.scale
            offset = c.match_histo.location - f.stats.location * multiplier
            f.data = pm.match_histogram(f.data, f.stats.location, f.stats.scale,
                                        c.match_histo.location, c.match_histo.scale)
            f.stats.replace_data(f.data)
            f.stats.update_cached_with(multiplier, offset)
        else:
            raise NotImplementedError(f"histogram normalization mode {int(mode)} is not "
                                      "ported yet (queued in ROADMAP.md)")
        c.logf("%d: %s after matching reference histogram %s\n", f.id, f.stats, c.match_histo)
        return f


class _TransformText:
    """The Transform log argument; held in the ordered log buffer like the
    JAX package's lazily rendered transform."""

    def __init__(self, trans):
        self._text = tf.to_string(trans)

    def render_deferred(self) -> str:
        return self._text


@register
class OpAlign(UnaryOperator):
    """Align each frame to the context reference (postprocess.go:105-207).
    With defer_warp (set by the stack preset) the projection waits for the
    stack/save barrier, where check_align_drop applies the residual
    threshold first."""

    TYPE = "align"
    PARAMS = {
        "k": ("k", 50),
        "threshold": ("threshold", 1.0),
        "oob_mode": ("oobMode", int(OutOfBoundsMode.NaN)),
    }

    def __init__(self, defer_warp: bool = False, **kwargs):
        super().__init__(**kwargs)
        self._aligner = None
        self.defer_warp = defer_warp

    def _init_aligner(self, c: Context) -> None:
        if self.k <= 0 or self._aligner is not None:
            return
        if c.align_naxisn is None or c.align_stars is None:
            raise ValueError("Unable to align without reference frame")
        if len(c.align_stars) == 0:
            raise ValueError("Unable to align without star detections in reference frame")
        from nightlight_tpu_torch.align.aligner import Aligner

        self._aligner = Aligner(c.align_naxisn, c.align_stars, self.k, device=c.device)

    def make_promises(self, ins, c):
        """The first promise to run materializes all inputs and aligns every
        eligible frame in one batch (Aligner.align_batch); each promise then
        applies its frame's result."""
        if not ins or self.k <= 0:
            return super().make_promises(ins, c)
        state = {"frames": None, "results": None}

        def mk(i: int):
            def out():
                if state["frames"] is None:
                    frames, err = materialize_all(ins, compact=False)
                    if err is not None:
                        raise err
                    state["frames"] = frames
                    state["results"] = self._batch_align(frames, c)
                f = state["frames"][i]
                state["frames"][i] = None
                if f is None:
                    return None
                results = state["results"]
                return self.apply(f, c, _batch_result=results.get(i) if results else None)

            return out

        return [mk(i) for i in range(len(ins))]

    def _batch_align(self, frames, c: Context):
        if not any(f is not None and f.stars is not None and len(f.stars) > 0 for f in frames):
            return None
        self._init_aligner(c)
        aligner = self._aligner
        if aligner is None or len(aligner.ref_stars) == 0 or not aligner.ref_tris.size:
            return None
        eligible = [i for i, f in enumerate(frames)
                    if f is not None and f.stars is not None
                    and f.stars is not aligner.ref_stars and len(f.stars) >= 3]
        if not eligible:
            return None
        rows = aligner.align_batch([(frames[i].naxisn, frames[i].stars) for i in eligible])
        return dict(zip(eligible, rows))

    def apply(self, f: Image, c: Context, _batch_result=None):
        if f is None:
            return None
        self._init_aligner(c)
        aligner = self._aligner
        if self.k <= 0 or aligner is None or len(aligner.ref_stars) == 0:
            f.trans = tf.identity()
            return f
        if f.stars is aligner.ref_stars:
            f.trans = tf.identity()  # the reference frame (postprocess.go:155-157)
            return f
        if f.stars is None or len(f.stars) == 0:
            c.logf("%d: No alignment stars found, skipping frame\n", f.id)
            return None
        mode = OutOfBoundsMode(self.oob_mode)
        if mode == OutOfBoundsMode.NaN:
            oob = float("nan")
        elif mode == OutOfBoundsMode.RefLocation:
            oob = c.match_histo.location
        else:
            oob = f.stats.location
        if _batch_result is not None:
            trans, residual = _batch_result
        else:
            one = aligner.align_one(f.naxisn, f.stars)
            if one is None:
                c.logf("%d: No alignment stars found, skipping frame\n", f.id)
                return None
            trans, residual = one
        c.logf("%d: Transform %s; residual %.3g oob %.3g\n",
               f.id, _TransformText(trans), residual, oob)
        if self.defer_warp:
            out = Image.from_naxisn(list(aligner.naxisn), f.data,
                                    ls_mode=f.stats.mode if f.stats else None)
            out.pending_warp_oob = oob
            out.align_threshold = self.threshold
        else:
            if residual > self.threshold:
                c.logf("%d: Alignment residual %g is above threshold %g, skipping frame\n",
                       f.id, residual, self.threshold)
                return None
            from nightlight_tpu_torch.ops.resample import project

            out = Image.from_naxisn(list(aligner.naxisn),
                                    project(f.data, aligner.naxisn, trans, oob),
                                    ls_mode=f.stats.mode if f.stats else None)
        out.id, out.exposure = f.id, f.exposure
        out.stars, out.hfr = f.stars, f.hfr
        out.trans, out.residual = trans, residual
        return out


def check_align_drop(f: Image, c: Context, project: bool = True):
    """Apply a deferred alignment threshold decision: None (with the
    reference's skip line) when the residual exceeds the threshold, else the
    frame -- projected unless project=False (OpStack then warps the whole
    batch at once)."""
    if f is None:
        return None
    thr = f.align_threshold
    if thr is None:
        return f
    res = float(f.residual)
    f.align_threshold = None
    f.residual = res
    if res > thr:
        c.logf("%d: Alignment residual %g is above threshold %g, skipping frame\n",
               f.id, res, thr)
        return None
    if f.pending_warp_oob is not None:
        f.trans = np.asarray(f.trans, np.float32)
        if project:
            from nightlight_tpu_torch.ops.resample import project as _project

            f.set_data(_project(f.data, f.naxisn, f.trans, f.pending_warp_oob))
            f.pending_warp_oob = None
    return f
