"""HSLuv-space operators on (H, S, L) cubes with the luminance in channel 2
(reference: internal/ops/hsl/hsl.go), mirror of
nightlight_tpu/pipeline/ops_hsl.py. Thresholds derived from the luminance
statistics are float32, as the JAX package keeps them on the device; the
lines that print them are held in the context's ordered log buffer, where
the JAX package holds its lazily rendered lines."""

from __future__ import annotations

import numpy as np
import torch

from nightlight_tpu_torch.image import Image
from nightlight_tpu_torch.ops import color as col
from nightlight_tpu_torch.ops import pixelmath as pm
from nightlight_tpu_torch.ops.stats import Stats
from nightlight_tpu_torch.pipeline.context import Context
from nightlight_tpu_torch.pipeline.operators import UnaryOperator, register
from nightlight_tpu_torch.pipeline.ops_stretch import _Text, stretch_iterative

_F32 = np.float32


def _lum_stats(f: Image) -> Stats:
    """Stats over the luminance channel (hsl.go:164, stats.go:70-76)."""
    return Stats.for_channel(f.data, f.naxisn[0], 2, f.stats.mode if f.stats else None)


def _set_channel(f: Image, ch: int, data: torch.Tensor) -> None:
    out = f.data.clone()
    out[ch] = data
    f.set_data(out)


def _log_held(c: Context, fmt: str, *args) -> None:
    """A line with values from the statistics, held in order like the JAX
    package's lazily rendered lines."""
    c.logf("%s", _Text(fmt % args))


def _pct(v) -> np.float32:
    """A float32 statistic times 100 in float32, as the JAX package prints it."""
    return _F32(v) * _F32(100)


@register
class OpHSLApplyLum(UnaryOperator):
    """Copy the context luminance frame into the L channel (hsl.go:30-71)."""

    TYPE = "hslApplyLum"
    PARAMS = {}

    def apply(self, f: Image, c: Context) -> Image:
        if c.lum_frame is None:
            return f
        c.logf("Converting mono luminance image to HSLuv as well...\n")
        lum = col.mono_to_hsluv_lum(c.lum_frame.data)
        c.logf("Applying luminance image to luminance channel...\n")
        _set_channel(f, 2, lum)
        f.exposure += c.lum_frame.exposure
        c.lum_frame = None
        return f


@register
class OpHSLScaleOffsetChannel(UnaryOperator):
    """Scale/offset one channel (hsl.go:73-119)."""

    TYPE = "hslScaleOffsetChannel"
    PARAMS = {"channel_id": ("channelID", 2), "scale": ("scale", 1.0), "offset": ("offset", 0.0)}

    def apply(self, f: Image, c: Context) -> Image:
        if self.scale == 1 and self.offset == 0:
            return f
        c.logf("%d: Applying pixel math x = x * %.3f + %.3f%% to channel %d\n",
               f.id, self.scale, self.offset * 100, self.channel_id)
        _set_channel(f, self.channel_id,
                     pm.scale_offset(f.data[self.channel_id], self.scale, self.offset))
        return f


@register
class OpHSLNeutralizeBackground(UnaryOperator):
    """Desaturate low-luminance background (hsl.go:121-172)."""

    TYPE = "hslNeutralizeBackground"
    PARAMS = {"sigma_low": ("sigmaLow", 0.75), "sigma_high": ("sigmaHigh", 1.0)}

    def apply(self, f: Image, c: Context) -> Image:
        if self.sigma_low <= 0 and self.sigma_high <= 0:
            return f
        c.logf("Neutralizing background values below %.4g sigma, keeping color above %.4g sigma\n",
               self.sigma_low, self.sigma_high)
        loc, scale = _lum_stats(f).device_location_scale()
        low = loc + scale * _F32(self.sigma_low)
        high = loc + scale * _F32(self.sigma_high)
        _log_held(c, "Location %.2f%%, scale %.2f%%, low %.2f%% high %.2f%%\n",
                  _pct(loc), _pct(scale), _pct(low), _pct(high))
        f.set_data(col.neutralize_background(f.data, low, high))
        return f


@register
class OpHSLSaturationGamma(UnaryOperator):
    """Gamma on saturation above a luminance threshold (hsl.go:174-222)."""

    TYPE = "hslSaturationGamma"
    PARAMS = {"gamma": ("gamma", 1.75), "sigma": ("sigma", 0.75)}

    def apply(self, f: Image, c: Context) -> Image:
        if self.gamma == 1.0:
            return f
        c.logf("Applying gamma %.2f to saturation for values %.4g sigma above background...\n",
               self.gamma, self.sigma)
        loc, scale = _lum_stats(f).device_location_scale()
        threshold = loc + scale * _F32(self.sigma)
        _log_held(c, "Location %.2f%%, scale %.2f%%, threshold %.2f%%\n",
                  _pct(loc), _pct(scale), _pct(threshold))
        f.set_data(col.adjust_chroma(f.data, self.gamma, threshold))
        return f


@register
class OpHSLSelectiveSaturation(UnaryOperator):
    """Scale saturation for a hue range (hsl.go:224-270)."""

    TYPE = "hslSelectiveSaturation"
    PARAMS = {"from_": ("from", 295.0), "to": ("to", 40.0), "factor": ("factor", 1.0)}

    def apply(self, f: Image, c: Context) -> Image:
        if self.factor == 1:
            return f
        c.logf("Multiplying LCH chroma (saturation) by %.4g for hues in [%g,%g]...\n",
               self.factor, self.from_, self.to)
        f.set_data(col.adjust_chroma_for_hues(f.data, self.from_, self.to, self.factor))
        return f


@register
class OpHSLRotateHue(UnaryOperator):
    """Rotate hues in a range for luminances above threshold (hsl.go:272-321)."""

    TYPE = "hslRotateHue"
    PARAMS = {"from_": ("from", 100.0), "to": ("to", 190.0), "offset": ("offset", 0.0),
              "sigma": ("sigma", 1.0)}

    def apply(self, f: Image, c: Context) -> Image:
        if self.offset == 0:
            return f
        c.logf("Rotating LCH hue angles in [%g,%g] by %.4g for lum>=loc+%g*scale...\n",
               self.from_, self.to, self.offset, self.sigma)
        loc, scale = _lum_stats(f).device_location_scale()
        threshold = loc + scale * _F32(self.sigma)
        f.set_data(col.rotate_colors(f.data, self.from_, self.to, self.offset, threshold))
        return f


@register
class OpHSLSCNR(UnaryOperator):
    """Subtractive chroma noise reduction on green (hsl.go:323-362)."""

    TYPE = "hslSCNR"
    PARAMS = {"factor": ("factor", 0.0)}

    def apply(self, f: Image, c: Context) -> Image:
        if self.factor == 0:
            return f
        c.logf("Applying SCNR of %.4g ...\n", self.factor)
        f.set_data(col.scnr(f.data, self.factor))
        return f


@register
class OpHSLMidtones(UnaryOperator):
    """Midtones on the luminance channel (hsl.go:364-411)."""

    TYPE = "hslMidtones"
    PARAMS = {"mid": ("mid", 0.0), "black": ("black", 2.0)}

    def apply(self, f: Image, c: Context) -> Image:
        if self.mid == 0:
            return f
        c.logf("Applying midtone correction with midtone=%.2f%% x scale and "
               "black=location - %.2f%% x scale\n", self.mid, self.black)
        loc, scale = _lum_stats(f).device_location_scale()
        abs_mid = _F32(self.mid) * scale
        abs_black = loc - _F32(self.black) * scale
        _log_held(c, "loc %.2f%% scale %.2f%% absMid %.2f%% absBlack %.2f%%\n",
                  _pct(loc), _pct(scale), _pct(abs_mid), _pct(abs_black))
        _set_channel(f, 2, pm.midtones(f.data[2], abs_mid, abs_black))
        return f


@register
class OpHSLGamma(UnaryOperator):
    """Gamma on the luminance channel (hsl.go:413-451)."""

    TYPE = "hslGamma"
    PARAMS = {"gamma": ("gamma", 1.0)}

    def apply(self, f: Image, c: Context) -> Image:
        if self.gamma == 1.0:
            return f
        c.logf("Applying gamma %.3g\n", self.gamma)
        _set_channel(f, 2, pm.gamma(f.data[2], self.gamma))
        return f


@register
class OpHSLGammaPP(UnaryOperator):
    """Post-peak gamma on the luminance channel (hsl.go:453-499)."""

    TYPE = "hslGammaPP"
    PARAMS = {"gamma": ("gamma", 1.0), "sigma": ("sigma", 1.0)}

    def apply(self, f: Image, c: Context) -> Image:
        if self.gamma == 1.0:
            return f
        loc, scale = _lum_stats(f).device_location_scale()
        from_ = loc + _F32(self.sigma) * scale
        to = 1.0
        _log_held(c, "Based on sigma=%.4g, boosting values in [%.2f%%, %.2f%%] with gamma %.4g...\n",
                  self.sigma, _pct(from_), to * 100, self.gamma)
        _set_channel(f, 2, pm.partial_gamma(f.data[2], from_, to, self.gamma))
        return f


@register
class OpHSLUnsharpMask(UnaryOperator):
    """USM on the luminance channel (hsl.go:501-556)."""

    TYPE = "HSLUnsharpMask"
    PARAMS = {"sigma": ("sigma", 1.5), "gain": ("gain", 0.0), "threshold": ("threshold", 0.75)}

    def apply(self, f: Image, c: Context) -> Image:
        if self.gain == 0.0:
            return f
        from nightlight_tpu_torch.ops.gauss import gaussian_kernel_1d, unsharp_mask

        st = _lum_stats(f)
        loc, scale = st.device_location_scale()
        abs_thresh = loc + scale * _F32(self.threshold)
        _log_held(c, "%d: Unsharp masking with sigma %.3g gain %.3g thresh %.3g absThresh %.3g\n",
                  f.id, self.sigma, self.gain, self.threshold, abs_thresh)
        kernel = gaussian_kernel_1d(self.sigma)
        c.logf("%d: Unsharp masking kernel sigma %.2f size %d: %s\n",
               f.id, self.sigma, len(kernel), list(np.round(kernel, 6)))
        vmin, vmax = st.device_min_max()
        _set_channel(f, 2, unsharp_mask(f.data[2], self.sigma, self.gain, vmin, vmax,
                                        abs_thresh))
        return f


@register
class OpHSLScaleBlack(UnaryOperator):
    """Scale black on the luminance channel, with the target converted from
    linear to HSLuv luminance (hsl.go:558-610)."""

    TYPE = "hslScaleBlack"
    PARAMS = {"location": ("location", 0.0)}

    def apply(self, f: Image, c: Context) -> Image:
        if self.location == 0:
            return f
        loc, scale = _lum_stats(f).device_location_scale()
        _log_held(c, "Location %.2f%% and scale %.2f%%: ", _pct(loc), _pct(scale))
        target = col.mono_to_hsluv_lum(torch.tensor(self.location, dtype=torch.float32))
        target_black = _F32(target.item())
        if loc > target_black:
            _log_held(c, "scaling black to move location to HSLuv %.2f%% for linear %.2f%%...\n",
                      _pct(target_black), self.location * 100.0)
            _set_channel(f, 2, pm.shift_black_to_move(f.data[2], loc, target_black))
        else:
            _log_held(c, "cannot move to location %.2f%% by scaling black\n", _pct(target_black))
            f.set_data(f.data)  # fresh statistics, as the JAX package's where() leaves them
        return f


@register
class OpHSLStretchIterative(UnaryOperator):
    """Iterative auto-stretch on the luminance channel (hsl.go:613-703)."""

    TYPE = "hslStretch"
    PARAMS = {"location": ("location", 0.1), "scale": ("scale", 0.004)}

    def apply(self, f: Image, c: Context) -> Image:
        if self.location == 0 and self.scale == 0:
            return f
        c.logf("%d: Auto-stretching HSL loc to %.2f%% and scale to %.2f%% ...\n",
               f.id, self.location * 100, self.scale * 100)
        stretch_iterative(f, c, self.location, self.scale, f.data[2],
                          lambda d: _set_channel(f, 2, d))
        return f
