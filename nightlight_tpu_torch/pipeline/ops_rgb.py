"""RGB combination and balance operators (reference:
internal/ops/rgb/rgb.go), mirror of nightlight_tpu/pipeline/ops_rgb.py."""

from __future__ import annotations

import numpy as np
import torch

from nightlight_tpu_torch.image import Image
from nightlight_tpu_torch.ops import color as col
from nightlight_tpu_torch.ops import pixelmath as pm
from nightlight_tpu_torch.ops import rgb as rgbops
from nightlight_tpu_torch.ops.rgb import RGB
from nightlight_tpu_torch.ops.stats import Stats
from nightlight_tpu_torch.pipeline.context import Context
from nightlight_tpu_torch.pipeline.operators import (
    Operator, UnaryOperator, materialize_all, register, take_whole)


@register
class OpRGBCombine(Operator):
    """Combine 3(+1 luminance) mono frames into an RGB cube (rgb.go:42-80).
    With four inputs the fourth is the luminance frame, kept in the context
    for hslApplyLum."""

    TYPE = "rgbCombine"
    PARAMS = {}

    def make_promises(self, ins, c):
        if len(ins) < 3 or len(ins) > 4:
            raise ValueError(f"{self.TYPE} operator with {len(ins)} inputs")

        def out():
            fs, err = materialize_all(ins)
            if err is not None:
                raise err
            return self.apply(fs, c)

        return [out]

    def apply(self, fs: list[Image], c: Context) -> Image:
        if len(fs) < 3 or len(fs) > 4:
            raise ValueError(f"invalid number of channels for color combination: {len(fs)}")
        for f in fs:
            # the colour chain has no row-sharded form: under a mesh the
            # channels are taken whole
            take_whole(f, self.TYPE)
        if len(fs) == 4:
            c.lum_frame = fs[3]
        c.logf("\nCombining RGB color channels...\n")

        vmin, mult = rgbops.common_normalization_factors(
            [f.stats.min for f in fs[:3]], [f.stats.max for f in fs[:3]])
        c.logf("common normalization factors min=%f mult=%f\n", vmin, mult)
        cube = rgbops.combine_channels(torch.stack([f.data for f in fs[:3]]), vmin, mult)

        out = Image.from_naxisn(list(fs[0].naxisn) + [3], cube,
                                ls_mode=fs[0].stats.mode if fs[0].stats else None)
        out.exposure = sum(f.exposure for f in fs[:3])
        if c.align_stars is not None:
            out.stars, out.hfr = c.align_stars, c.align_hfr
        return out


@register
class OpRGBBalance(UnaryOperator):
    """Two-pass automatic black/white point balance (rgb.go:82-135,
    fits/rgb.go:94-148)."""

    TYPE = "rgbBalance"
    PARAMS = {
        "block": ("block", 16),
        "border": ("border", 0.1),
        "skip_bright": ("skipBright", 0.0),
        "skip_dim": ("skipDim", 0.75),
        "shadows": ("shadows", None),     # RGB dict {R, G, B}
        "highlights": ("highlights", None),
    }

    def _rgb(self, v) -> RGB:
        if v is None:
            return RGB(1.0, 1.0, 1.0)
        if isinstance(v, RGB):
            return v
        return RGB(v.get("R", 1.0), v.get("G", 1.0), v.get("B", 1.0))

    def to_dict(self):
        d = super().to_dict()
        for key in ("shadows", "highlights"):
            rgb = self._rgb(getattr(self, key))
            d[key] = {"R": rgb.r, "G": rgb.g, "B": rgb.b}
        return d

    def apply(self, f: Image, c: Context) -> Image:
        if f.stars is None or len(f.stars) == 0:
            raise ValueError("cannot balance colors with zero stars detected")
        shadows = self._rgb(self.shadows)
        highlights = self._rgb(self.highlights)
        c.logf("Balancing darkest %dx%d block outside %.1f%% border to color tint %s and "
               "stars skipping brightest %.1f%% and dimmest %.1f%% to %s\n",
               self.block, self.block, 100 * self.border, shadows,
               100 * self.skip_bright, 100 * self.skip_dim, highlights)

        # pass 1: per-channel location and location + 3 scale (fits/rgb.go:95-104)
        stats = [Stats.for_channel(f.data, f.naxisn[0], ch, f.stats.mode) for ch in range(3)]
        loc = tuple(s.location for s in stats)
        scaled = tuple(s.location + s.scale * 3 for s in stats)
        c.logf("Location is %s and loc+3 sigma is %s\n", RGB(*loc), RGB(*scaled))
        self._apply_correction(f, c, loc, scaled, shadows, highlights)

        # pass 2: the darkest block and the mean star colour
        # (fits/rgb.go:106-119), both on the cube's device; one read of the
        # two 3-vectors
        stats = [Stats.for_channel(f.data, f.naxisn[0], ch, f.stats.mode) for ch in range(3)]
        darkest_d = rgbops.find_darkest_block(f.data, int(self.block), float(self.border))
        clip = tuple(s.device_min_max()[1] * np.float32(0.9) for s in stats)
        star_d = rgbops.mean_star_intensity_device(f.data, f.stars, self.skip_bright,
                                                   self.skip_dim, clip)
        both = torch.stack([darkest_d, star_d if star_d is not None
                            else torch.zeros_like(darkest_d)]).cpu().numpy()
        darkest = tuple(float(v) for v in both[0])
        star_color = tuple(float(v) for v in both[1])
        c.logf("Darkest block is %s and mean star color is %s\n", RGB(*darkest), RGB(*star_color))
        self._apply_correction(f, c, darkest, star_color, shadows, highlights)
        return f

    def _apply_correction(self, f: Image, c: Context, cur_shadows, cur_highlights,
                          shadows: RGB, highlights: RGB) -> None:
        alpha, beta = rgbops.black_white_correction(cur_shadows, cur_highlights, shadows,
                                                    highlights)
        c.logf("r=%.3f*r %+.1f%%, g=%.1f*g %+.3f%%, b=%.3f*b %+.1f%%\n",
               alpha[0], beta[0] * 100, alpha[1], beta[1] * 100, alpha[2], beta[2] * 100)
        f.set_data(pm.scale_offset_clamp_rgb(f.data, alpha, beta))


@register
class OpRGBToHSLuv(UnaryOperator):
    """Linear RGB -> HSLuv (rgb.go:137-170)."""

    TYPE = "rgbToHSLuv"
    PARAMS = {}

    def apply(self, f: Image, c: Context) -> Image:
        c.logf("Converting linear RGB to nonlinear HSLuv...\n")
        f.set_data(col.linrgb_to_hsluv(f.data))
        return f


@register
class OpHSLuvToRGB(UnaryOperator):
    """HSLuv -> linear RGB with color-preserving clamp (rgb.go:172-205)."""

    TYPE = "hsluvToRGB"
    PARAMS = {}

    def apply(self, f: Image, c: Context) -> Image:
        c.logf("Converting nonlinear HSLuv to linear RGB\n")
        f.set_data(col.hsluv_to_linrgb(f.data))
        return f
