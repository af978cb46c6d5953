"""Preprocessing operators: calibrate, badPixel, debayer, deband,
scaleOffset, bin, starDetect, backExtract (reference: internal/ops/pre/),
mirror of nightlight_tpu/pipeline/ops_pre.py.

Under ``Context.mesh`` each takes a row-sharded frame (parallel/mesh.py
RowSharded). Calibrate, bad-pixel repair, debayer, scaleOffset, bin and
star detection run on each shard's rows (detection with a halo, the
candidates merged on the lead); the debands and background extraction,
which need whole columns or the whole grid, run on the gathered frame and
place the result back."""

from __future__ import annotations

import numpy as np

from nightlight_tpu_torch import trace
from nightlight_tpu_torch.image import Image, bin_nxn
from nightlight_tpu_torch.ops import pixelmath as pxm
from nightlight_tpu_torch.ops import prestack as ps
from nightlight_tpu_torch.parallel import mesh as pm
from nightlight_tpu_torch.pipeline.context import Context
from nightlight_tpu_torch.pipeline.operators import (
    OpLoad, UnaryOperator, materialize_all, register, take_whole)


@register
class OpCalibrate(UnaryOperator):
    """Dark subtraction and flat division with lazy master-frame loading
    (pre/preprocess.go:29-143)."""

    TYPE = "calibrate"
    PARAMS = {"dark": ("dark", ""), "flat": ("flat", "")}
    SHARDED = True

    def is_noop(self) -> bool:
        return not self.dark and not self.flat

    def _init_masters(self, c: Context) -> None:
        """Load dark/flat once (preprocess.go:102-143); the dark is ID -1,
        the flat -2."""
        with c.lock:
            if not ((self.dark and c.dark_frame is None) or (self.flat and c.flat_frame is None)):
                return
            promises = []
            for i, name in enumerate([self.dark, self.flat]):
                if name:
                    promises.extend(OpLoad(id=-(i + 1), file_name=name).make_promises([], c))
            images, err = materialize_all(promises)
            if err is not None:
                raise err
            if self.dark:
                c.dark_frame = images[0]
                if self.flat:
                    c.flat_frame = images[1]
            elif self.flat:
                c.flat_frame = images[0]
            if (c.dark_frame is not None and c.flat_frame is not None
                    and c.dark_frame.naxisn != c.flat_frame.naxisn):
                raise ValueError(f"dark dimensions {c.dark_frame.naxisn} differ from flat "
                                 f"dimensions {c.flat_frame.naxisn}")

    @trace.span("perframe")
    def apply(self, f: Image, c: Context) -> Image:
        self._init_masters(c)
        for master, what in ((c.dark_frame, "dark"), (c.flat_frame, "flat")):
            if master is not None and f.naxisn != master.naxisn:
                if f.pixels != master.pixels:
                    raise ValueError(f"{f.id}: Light dimensions {f.naxisn} differ from "
                                     f"{what} dimensions {master.naxisn}")
                c.logf("%d: Warning: light dimensions %s differ from %s dimensions %s "
                       "but same product, ignoring for Seestar",
                       f.id, f.naxisn, what, master.naxisn)
        if isinstance(f.data, pm.RowSharded):
            # per shard, the masters sharded like the frame
            if c.dark_frame is not None:
                f.set_data(pm.map_blocks(ps.subtract, f.data, _master_like(c.dark_frame, f)))
            if c.flat_frame is not None:
                flat_max = c.flat_frame.stats.max
                f.set_data(pm.map_blocks(lambda b, fl: ps.flat_divide(b, fl, flat_max), f.data,
                                         _master_like(c.flat_frame, f)))
            return f
        if c.dark_frame is not None:
            dark = pm.gather(c.dark_frame.data, "master")
            f.set_data(ps.subtract(f.data, dark.reshape(f.data.shape)))
        if c.flat_frame is not None:
            flat = pm.gather(c.flat_frame.data, "master")
            f.set_data(ps.flat_divide(f.data, flat.reshape(f.data.shape),
                                      c.flat_frame.stats.max))
        return f


def _master_like(master: Image, f: Image):
    """A master frame's pixels placed like the frame's: its own data (it is
    loaded under the same mesh), unless its axes differ from the frame's
    with the same pixel count (the Seestar case); then it is reshaped
    whole and placed."""
    d = master.data
    if isinstance(d, pm.RowSharded) and d.shape == f.data.shape \
            and d.replicated == f.data.replicated:
        return d
    whole = pm.gather(d, "master").reshape(f.data.shape)
    return pm.place_on_mesh(whole, f.data.mesh)


@register
class OpBadPixel(UnaryOperator):
    """Bad-pixel detection and cosmetic repair (pre/preprocess.go:145-201).
    CFA-aware when a debayer channel is configured."""

    TYPE = "badPixel"
    PARAMS = {"sigma_low": ("sigmaLow", 3.0), "sigma_high": ("sigmaHigh", 5.0)}
    SHARDED = True

    def __init__(self, debayer=None, **kwargs):
        super().__init__(**kwargs)
        self.debayer = debayer  # wiring only, not JSON (preprocess.go:149)

    def is_noop(self) -> bool:
        return self.sigma_low == 0 or self.sigma_high == 0

    @trace.span("perframe")
    def apply(self, f: Image, c: Context) -> Image:
        if self.is_noop():
            return f
        if isinstance(f.data, pm.RowSharded) and f.data.dim() != 2:
            # a cube's repair is per plane: it is taken whole
            take_whole(f, self.TYPE)
        debayer = self.debayer
        if debayer is not None and getattr(debayer, "channel", ""):
            # median_diff_stats stays unset: detection then estimates it on
            # the final (debayered) image
            correct = (ps.cosmetic_correction_bayer_sharded
                       if isinstance(f.data, pm.RowSharded) else ps.cosmetic_correction_bayer)
            corrected, n_removed = correct(f.data, debayer.channel, debayer.color_filter_array,
                                           self.sigma_low, self.sigma_high)
            f.set_data(corrected)
            n_removed = int(trace.to_host(n_removed))
            # float32 n * (100 / pixels), as the JAX package formats it
            c.logf("%d: Removed %d bad bayer pixels (%.2f%%) with sigma low=%.2f high=%.2f\n",
                   f.id, n_removed, np.float32(n_removed) * np.float32(100.0 / f.pixels),
                   self.sigma_low, self.sigma_high)
            return f
        from nightlight_tpu_torch.ops.stats import Stats

        repair = (ps.bad_pixel_repair_sharded if isinstance(f.data, pm.RowSharded)
                  else ps.bad_pixel_repair)
        repaired, n_bad, diff_std = repair(f.data, self.sigma_low, self.sigma_high)
        f.median_diff_stats = Stats.from_stddev(float(trace.to_host(diff_std)))
        f.set_data(repaired)
        n_bad = int(trace.to_host(n_bad))
        c.logf("%d: Removed %d bad pixels (%.2f%%) with sigma low=%.2f high=%.2f\n",
               f.id, n_bad, n_bad * (100.0 / f.pixels), self.sigma_low, self.sigma_high)
        return f


@register
class OpDebayer(UnaryOperator):
    """Bilinear single-channel debayer (pre/preprocess.go:203-249)."""

    TYPE = "debayer"
    PARAMS = {"channel": ("channel", ""), "color_filter_array": ("colorFilterArray", "RGGB")}
    SHARDED = True

    def is_noop(self) -> bool:
        return not self.channel or not self.color_filter_array

    def apply(self, f: Image, c: Context) -> Image:
        if self.is_noop():
            return f
        debayer = (ps.debayer_sharded if isinstance(f.data, pm.RowSharded)
                   else ps.debayer_bilinear)
        out = debayer(f.data, self.channel, self.color_filter_array)
        f.set_data(out, naxisn=[out.shape[1], out.shape[0]])
        c.logf("%d: Debayered channel %s from cfa %s, new size %dx%d\n",
               f.id, self.channel, self.color_filter_array, f.naxisn[0], f.naxisn[1])
        return f


class _Deband(UnaryOperator):
    """Banding removal along rows (horizontal) or columns (vertical); the
    threshold from the current image's location and scale."""

    PARAMS = {"percentile": ("percentile", 50.0), "window": ("window", 128),
              "sigma": ("sigma", 3.0)}
    HORIZONTAL = True
    SHARDED = True
    LOG = ""

    def is_noop(self) -> bool:
        # window <= 0 is a no-op in both directions (the reference's
        # vertical op would panic, banding.go:199,256-259)
        return self.percentile <= 0 or self.percentile >= 100 or self.window <= 0

    def apply(self, f: Image, c: Context) -> Image:
        if self.is_noop():
            return f
        from nightlight_tpu_torch.ops.deband import deband

        loc, scale = (f.stats.location, f.stats.scale) if self.sigma != 0 else (0.0, 0.0)
        # the band factors need whole rows and columns: a row-sharded frame
        # is debanded gathered and placed back
        out, lo, hi, threshold = deband(pm.gather(f.data, self.TYPE), self.percentile,
                                        self.window, self.sigma, loc, scale, self.HORIZONTAL)
        f.set_data(_place_like(out, f.data))
        c.logf(self.LOG, f.id, self.percentile, self.window, self.sigma, threshold, lo, hi)
        return f


@register
class OpDebandHoriz(_Deband):
    """Horizontal banding removal (pre/banding.go:28-132)."""

    TYPE = "debandHoriz"
    LOG = ("%d: De-banded horizontally with %.3fth percentile, window %d, sigma %.2f, "
           "threshold %.2f, factors in [%.3f, %.3f]\n")


@register
class OpDebandVert(_Deband):
    """Vertical banding removal (pre/banding.go:164-269)."""

    TYPE = "debandVert"
    HORIZONTAL = False
    LOG = ("%d: De-banded vertically with %.3fth percentile, window %d and sigma %.2f, "
           "threshold %.2f, factors in [%.3f, %.3f]\n")


@register
class OpScaleOffset(UnaryOperator):
    """Pixel math x*scale + offset (pre/preprocess.go:251-291)."""

    TYPE = "scaleOffset"
    PARAMS = {"scale": ("scale", 1.0), "offset": ("offset", 0.0)}
    SHARDED = True

    def is_noop(self) -> bool:
        return self.scale == 1 and self.offset == 0

    def apply(self, f: Image, c: Context) -> Image:
        if self.is_noop():
            return f
        c.logf("%d: Applying pixel math x = x * %.3f + %.3f%%\n",
               f.id, self.scale, self.offset * 100)
        f.data = pm.per_block(lambda b: pxm.scale_offset(b, self.scale, self.offset), f.data)
        f.stats.replace_data(f.data)
        f.stats.update_cached_with(self.scale, self.offset)
        return f


@register
class OpBin(UnaryOperator):
    """NxN average-pooling binning (pre/preprocess.go:293-331)."""

    TYPE = "bin"
    PARAMS = {"bin_size": ("binSize", 1)}
    SHARDED = True

    def is_noop(self) -> bool:
        return self.bin_size <= 1

    def apply(self, f: Image, c: Context) -> Image:
        if self.is_noop():
            return f
        f = bin_nxn(f, self.bin_size)
        c.logf("%d: After %dx%d binning, new image size %dx%d\n",
               f.id, self.bin_size, self.bin_size, f.naxisn[0], f.naxisn[1])
        return f


@register
class OpStarDetect(UnaryOperator):
    """Star detection with optional debug rendering (pre/preprocess.go:401-465).
    The rendering is the star-image save (-stars)."""

    TYPE = "starDetect"
    PARAMS = {
        "radius": ("radius", 16),
        "sigma": ("sigma", 10.0),
        "bad_pixel_sigma": ("badPixelSigma", 0.0),
        "in_out_ratio": ("inOutRatio", 10.0),
        "save": ("save", None),
    }
    SHARDED = True

    def is_noop(self) -> bool:
        return self.radius == 0 or self.sigma == 0

    def apply(self, f: Image, c: Context) -> Image:
        if self.is_noop():
            return f
        if f.stats is None:
            raise ValueError("missing stats")
        from nightlight_tpu_torch.detect.stars import find_stars

        median_diff_std = None
        if f.median_diff_stats is not None:
            median_diff_std = f.median_diff_stats.stddev
        args = (f.stats.location, f.stats.scale, self.sigma, self.bad_pixel_sigma,
                self.in_out_ratio)
        if isinstance(f.data, pm.RowSharded):
            # each shard detects on its rows with a halo of 2 x radius rows,
            # K4 on its haloed block, the lead merges the candidates and
            # finishes on their patches (the JAX package feeds XLA's gather
            # under a mesh: a pallas_call cannot address a row-sharded
            # frame); a cube's first plane is taken block by block
            plane = f.data
            if plane.dim() == 3:
                plane = pm.map_blocks(lambda b: b[0], plane, shape=plane.shape[1:])
            f.stars, f.hfr = pm.sharded_star_detect(plane.mesh, int(self.radius))(
                plane, *args, median_diff_std)
        else:
            data2d = f.data if f.data.dim() == 2 else f.data[0]
            f.stars, f.hfr = find_stars(data2d, *args, int(self.radius), median_diff_std)
        c.logf("%d: Stars %d HFR %.2f %s\n", f.id, f.stars.count, f.hfr, f.stats)
        save = self.save
        if save is not None and getattr(save, "file_pattern", ""):
            from nightlight_tpu_torch.image import image_from_stars

            save.apply(image_from_stars(f, 2.0), c)
        return f


@register
class OpBackExtract(UnaryOperator):
    """Automated background extraction (pre/preprocess.go:333-399)."""

    TYPE = "backExtract"
    PARAMS = {
        "grid_size": ("gridSize", 0),
        "hfr_factor": ("hfrFactor", 4.0),
        "sigma": ("sigma", 1.5),
        "clip": ("clip", 0),
        "save": ("save", None),
    }
    SHARDED = True

    def is_noop(self) -> bool:
        return self.grid_size <= 0

    def apply(self, f: Image, c: Context) -> Image:
        if self.is_noop():
            return f
        from nightlight_tpu_torch.ops.background import Background

        # the grid's cells and its fit span the whole frame: a row-sharded
        # frame is taken gathered and the result placed back
        whole = pm.gather(f.data, self.TYPE)
        bg = Background(whole, self.grid_size, self.sigma, self.clip, f.stars, self.hfr_factor)
        c.logf("%d: %s\n", f.id, bg)
        save = self.save
        if save is not None and getattr(save, "file_pattern", ""):
            bg_img = Image.from_naxisn(list(f.naxisn), bg.render())
            bg_img.id = f.id
            save.apply(bg_img, c)
            f.set_data(_place_like(ps.subtract(whole, bg_img.data), f.data))
        else:
            f.set_data(_place_like(bg.subtract(whole), f.data))
        return f


def _place_like(out, data):
    """`out`, computed on a gathered frame, placed on the frame's mesh
    again (a tensor frame: `out` as it is)."""
    return pm.place_on_mesh(out, data.mesh) if isinstance(data, pm.RowSharded) else out
