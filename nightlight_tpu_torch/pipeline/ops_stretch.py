"""Mono stretch operators: normalize, iterative auto-stretch, midtones,
gamma, post-peak gamma, black scaling, gaussian blur, unsharp mask
(reference: internal/ops/stretch/stretch.go), mirror of
nightlight_tpu/pipeline/ops_stretch.py. Scalars derived from statistics
are float32, as the JAX package keeps them on the device.

Under ``Context.mesh`` the operators that are per pixel given scalars
(normalize, the iterative auto-stretch, midtones, gamma, black scaling) run
on each shard's block of a row-sharded image, their statistics read from
the shards (ops/stats.py); the post-peak gamma, the blur and the unsharp
mask take the image whole."""

from __future__ import annotations

import numpy as np

from nightlight_tpu_torch.image import Image
from nightlight_tpu_torch.ops import pixelmath as pm
from nightlight_tpu_torch.parallel.mesh import per_block
from nightlight_tpu_torch.pipeline.context import Context
from nightlight_tpu_torch.pipeline.operators import UnaryOperator, register


class _Text:
    """A finished log text held in the context's ordered buffer, as the
    JAX package holds its lazily rendered lines."""

    def __init__(self, text: str):
        self._text = text

    def render_deferred(self) -> str:
        return self._text


def ideal_stretch_gamma(loc: float, scale: float, target_loc: float, target_scale: float) -> float:
    """Search gamma in [1, 5] step 0.01 for the value whose post-stretch scale
    best matches the target (stretch.go:118-140), on the host in float64.
    Unlike the device search it clamps loc - scale at 0 (no NaN case)."""
    gammas = np.arange(1.0, 5.0 + 1e-9, 0.01)
    exponent = 1.0 / gammas
    new_loc_lower = np.power(max(loc - scale, 0.0), exponent)
    new_loc = np.power(loc, exponent)
    new_loc_upper = np.power(loc + scale, exponent)
    black = (target_loc - new_loc) / (target_loc - 1.0)
    s = 1.0 / (1.0 - black)
    lower = np.maximum(0.0, (new_loc_lower - black) * s)
    upper = np.maximum(0.0, (new_loc_upper - black) * s)
    delta = np.abs(target_scale - (upper - lower) / 2.0)
    best = int(np.argmin(delta))
    if delta[best] < abs(target_scale - scale):
        return float(gammas[best])
    return 1.0


def _stretch_log(frame_id: int, target_loc: float, hist: np.ndarray, converged: bool) -> str:
    """The reference's per-round lines of an auto-stretch (stretch.go:103-159)."""
    from nightlight_tpu_torch.ops import autostretch as ast

    lines = []
    for row in hist:
        loc, scale, action, param = (row[ast.H_LOC], row[ast.H_SCALE], row[ast.H_ACTION],
                                     row[ast.H_PARAM])
        line = "%d: Linear location %.2f%% and scale %.2f%%, " % (frame_id, loc * 100,
                                                                 scale * 100)
        if action == ast.ACT_GAMMA:
            line += "applying gamma %.3g\n" % param
        elif action == ast.ACT_BLACK:
            line += "scaling black to move location to %.2f%%...\n" % (target_loc * 100)
        else:
            line += "done\n"
        lines.append(line)
    if not converged:
        lines.append("%d: Warning: did not converge after %d iterations\n" % (frame_id, 50))
    return "".join(lines)


def stretch_iterative(f: Image, c: Context, target_loc: float, target_scale: float,
                      data, set_data) -> None:
    """Shared iterative auto-stretch (stretch.go:103-159) of `data`, the
    result handed to set_data; the rounds logged as the reference does."""
    from nightlight_tpu_torch.ops import autostretch as ast

    out, hist, _n_iter, converged = ast.auto_stretch(data, target_loc, target_scale)
    c.logf("%s", _Text(_stretch_log(f.id, target_loc, hist, converged)))
    set_data(out)


def _f32(v) -> np.float32:
    return np.float32(v)


@register
class OpNormalizeRange(UnaryOperator):
    """Normalize to [0,1] (stretch.go:30-67).
    A uniform image passes."""

    TYPE = "normRange"
    PARAMS = {}
    SHARDED = True

    def apply(self, f: Image, c: Context) -> Image:
        if f.stats is None:
            raise ValueError("missing stats")
        vmin, vmax = _f32(f.stats.min), _f32(f.stats.max)
        if vmax - vmin < 1e-8:
            c.logf("%s\n", _Text(f"{f.id}: Warning: Image is of uniform intensity "
                                 f"{vmin:.4g}, skipping normalization"))
            return f
        c.logf("%s\n", _Text(f"{f.id}: Normalizing from [{vmin:.4g},{vmax:.4g}] to [0,1]"))
        f.data = per_block(lambda b: pm.normalize(b, vmin, vmax), f.data)
        f.stats.set_data(f.data)
        return f


@register
class OpStretchIterative(UnaryOperator):
    """Iterative gamma/black-shift auto-stretch (stretch.go:70-159)."""

    TYPE = "stretch"
    PARAMS = {"location": ("location", 0.1), "scale": ("scale", 0.004)}
    SHARDED = True

    def apply(self, f: Image, c: Context) -> Image:
        if self.location == 0 and self.scale == 0:
            return f
        c.logf("%d: Auto-stretching loc to %.2f%% and scale to %.2f%% ...\n",
               f.id, self.location * 100, self.scale * 100)

        def set_data(d):
            f.data = d
            f.stats.set_data(d)

        stretch_iterative(f, c, self.location, self.scale, f.data, set_data)
        return f


@register
class OpMidtones(UnaryOperator):
    """Midtones transfer keyed off location/scale (stretch.go:163-206)."""

    TYPE = "midtones"
    PARAMS = {"mid": ("mid", 0.0), "black": ("black", 1.0)}
    SHARDED = True

    def apply(self, f: Image, c: Context) -> Image:
        if self.mid == 0:
            return f
        c.logf("%d: Applying midtone correction with midtone=%.2f%% x scale and "
               "black=location - %.2f%% x scale\n", f.id, self.mid, self.black)
        loc, scale = _f32(f.stats.location), _f32(f.stats.scale)
        abs_mid = _f32(self.mid) * scale
        abs_black = loc - _f32(self.black) * scale
        c.logf("%d: loc %.2f%% scale %.2f%% absMid %.2f%% absBlack %.2f%%\n",
               f.id, loc * _f32(100), scale * _f32(100), abs_mid * _f32(100),
               abs_black * _f32(100))
        f.data = per_block(lambda b: pm.midtones(b, abs_mid, abs_black), f.data)
        f.stats.set_data(f.data)
        return f


@register
class OpGamma(UnaryOperator):
    """Plain gamma (stretch.go:210-244)."""

    TYPE = "gamma"
    PARAMS = {"gamma": ("gamma", 1.0)}
    SHARDED = True

    def apply(self, f: Image, c: Context) -> Image:
        if self.gamma == 1.0:
            return f
        c.logf("%d: Applying gamma %.3g\n", f.id, self.gamma)
        f.data = per_block(lambda b: pm.gamma(b, self.gamma), f.data)
        f.stats.set_data(f.data)
        return f


@register
class OpGammaPP(UnaryOperator):
    """Post-peak partial gamma (stretch.go:247-289)."""

    TYPE = "gammaPP"
    PARAMS = {"gamma": ("gamma", 1.0), "sigma": ("sigma", 1.0)}

    def is_noop(self) -> bool:
        return self.gamma == 1.0

    def apply(self, f: Image, c: Context) -> Image:
        if self.is_noop():
            return f
        from_ = _f32(f.stats.location) + _f32(self.sigma) * _f32(f.stats.scale)
        to = 1.0
        c.logf("%d: Based on sigma=%.4g, boosting [%.2f%%, %.2f%%] with gamma %.4g...\n",
               f.id, self.sigma, from_ * _f32(100), to * 100, self.gamma)
        f.data = pm.partial_gamma(f.data, from_, to, self.gamma)
        f.stats.set_data(f.data)
        return f


@register
class OpScaleBlack(UnaryOperator):
    """Move the black point so the peak lands at a target (stretch.go:293-335)."""

    TYPE = "scaleBlack"
    PARAMS = {"location": ("location", 0.0)}
    SHARDED = True

    def apply(self, f: Image, c: Context) -> Image:
        if self.location == 0:
            return f
        loc, scale = _f32(f.stats.location), _f32(f.stats.scale)
        c.logf("%d: Location %.2f%% and scale %.2f%%: ", f.id, loc * _f32(100),
               scale * _f32(100))
        if loc > self.location:
            c.logf("scaling black to move location to %.2f%%...\n", self.location * 100.0)
            f.data = per_block(lambda b: pm.shift_black_to_move(b, loc, self.location),
                               f.data)
        else:
            c.logf("cannot move to location %.2f%% by scaling black\n", self.location * 100.0)
        f.stats.set_data(f.data)
        return f


@register
class OpGaussianBlur(UnaryOperator):
    """Gaussian blur (stretch.go:339-376)."""

    TYPE = "gaussianBlur"
    PARAMS = {"sigma": ("sigma", 2.0)}

    def is_noop(self) -> bool:
        return self.sigma == 0

    def apply(self, f: Image, c: Context) -> Image:
        if self.is_noop():
            return f
        from nightlight_tpu_torch.ops.gauss import gaussian_blur, gaussian_kernel_1d

        kernel = gaussian_kernel_1d(self.sigma)
        c.logf("%d: Gaussian blur kernel sigma %.2f size %d: %s\n",
               f.id, self.sigma, len(kernel), list(np.round(kernel, 6)))
        f.set_data(gaussian_blur(f.data, self.sigma))
        return f


@register
class OpUnsharpMask(UnaryOperator):
    """Unsharp mask above a noise threshold (stretch.go:380-424)."""

    TYPE = "unsharpMask"
    PARAMS = {"sigma": ("sigma", 1.5), "gain": ("gain", 0.0), "threshold": ("threshold", 1.0)}

    def is_noop(self) -> bool:
        return self.sigma == 0 or self.gain == 0

    def apply(self, f: Image, c: Context) -> Image:
        if self.is_noop():
            return f
        from nightlight_tpu_torch.ops.gauss import gaussian_kernel_1d, unsharp_mask

        abs_thresh = _f32(f.stats.location) + _f32(f.stats.scale) * _f32(self.threshold)
        c.logf("%d: Unsharp masking with sigma %.3g gain %.3g thresh %.3g absThresh %.3g\n",
               f.id, self.sigma, self.gain, self.threshold, abs_thresh)
        kernel = gaussian_kernel_1d(self.sigma)
        c.logf("%d: Unsharp masking kernel sigma %.2f size %d: %s\n",
               f.id, self.sigma, len(kernel), list(np.round(kernel, 6)))
        vmin, vmax = f.stats.min, f.stats.max
        f.set_data(unsharp_mask(f.data, self.sigma, self.gain, vmin, vmax, abs_thresh))
        return f
