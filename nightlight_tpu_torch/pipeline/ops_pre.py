"""Preprocessing operators (reference: internal/ops/pre/), mirror of
nightlight_tpu/pipeline/ops_pre.py.

Ported in full: calibrate, badPixel (mono) and starDetect. The stack preset
also builds debayer, debandHoriz/Vert, scaleOffset, bin and backExtract;
the port carries them with their JSON parameters and runs them in the
no-op form the CLI defaults give. Any active setting raises
NotImplementedError (the stages are queued in ROADMAP.md).
"""

from __future__ import annotations

from nightlight_tpu_torch.image import Image
from nightlight_tpu_torch.ops import prestack as ps
from nightlight_tpu_torch.pipeline.context import Context
from nightlight_tpu_torch.pipeline.operators import (
    OpLoad, UnaryOperator, materialize_all, register)


class _NoopOnlyOperator(UnaryOperator):
    """A preset stage the port runs only in its no-op form."""

    def apply(self, f: Image, c: Context) -> Image:
        if self.is_noop():
            return f
        raise NotImplementedError(
            f"operator '{self.TYPE}' with {self.to_dict()} is not ported yet "
            "(queued in ROADMAP.md)")


@register
class OpCalibrate(UnaryOperator):
    """Dark subtraction and flat division with lazy master-frame loading
    (pre/preprocess.go:29-143)."""

    TYPE = "calibrate"
    PARAMS = {"dark": ("dark", ""), "flat": ("flat", "")}

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
        if c.dark_frame is not None:
            f.set_data(ps.subtract(f.data, c.dark_frame.data.reshape(f.data.shape)))
        if c.flat_frame is not None:
            f.set_data(ps.flat_divide(f.data, c.flat_frame.data.reshape(f.data.shape),
                                      c.flat_frame.stats.max))
        return f


@register
class OpBadPixel(UnaryOperator):
    """Bad-pixel detection and cosmetic repair (pre/preprocess.go:145-201).
    The CFA-aware variant (a configured debayer channel) is not ported."""

    TYPE = "badPixel"
    PARAMS = {"sigma_low": ("sigmaLow", 3.0), "sigma_high": ("sigmaHigh", 5.0)}

    def __init__(self, debayer=None, **kwargs):
        super().__init__(**kwargs)
        self.debayer = debayer  # wiring only, not JSON (preprocess.go:149)

    def is_noop(self) -> bool:
        return self.sigma_low == 0 or self.sigma_high == 0

    def apply(self, f: Image, c: Context) -> Image:
        if self.is_noop():
            return f
        if self.debayer is not None and getattr(self.debayer, "channel", ""):
            raise NotImplementedError("CFA-aware bad-pixel repair is not ported yet "
                                      "(queued in ROADMAP.md)")
        from nightlight_tpu_torch.ops.stats import Stats

        repaired, n_bad, diff_std = ps.bad_pixel_repair(f.data, self.sigma_low, self.sigma_high)
        f.median_diff_stats = Stats.from_stddev(float(diff_std))
        f.set_data(repaired)
        n_bad = int(n_bad)
        c.logf("%d: Removed %d bad pixels (%.2f%%) with sigma low=%.2f high=%.2f\n",
               f.id, n_bad, n_bad * (100.0 / f.pixels), self.sigma_low, self.sigma_high)
        return f


@register
class OpDebayer(_NoopOnlyOperator):
    """Bilinear single-channel debayer (pre/preprocess.go:203-249)."""

    TYPE = "debayer"
    PARAMS = {"channel": ("channel", ""), "color_filter_array": ("colorFilterArray", "RGGB")}

    def is_noop(self) -> bool:
        return not self.channel or not self.color_filter_array


@register
class OpDebandHoriz(_NoopOnlyOperator):
    """Horizontal banding removal (pre/banding.go:28-132)."""

    TYPE = "debandHoriz"
    PARAMS = {"percentile": ("percentile", 50.0), "window": ("window", 128),
              "sigma": ("sigma", 3.0)}

    def is_noop(self) -> bool:
        return self.percentile <= 0 or self.percentile >= 100 or self.window <= 0


@register
class OpDebandVert(_NoopOnlyOperator):
    """Vertical banding removal (pre/banding.go:164-269)."""

    TYPE = "debandVert"
    PARAMS = {"percentile": ("percentile", 50.0), "window": ("window", 128),
              "sigma": ("sigma", 3.0)}

    def is_noop(self) -> bool:
        return self.percentile <= 0 or self.percentile >= 100 or self.window <= 0


@register
class OpScaleOffset(_NoopOnlyOperator):
    """Pixel math x*scale + offset (pre/preprocess.go:251-291)."""

    TYPE = "scaleOffset"
    PARAMS = {"scale": ("scale", 1.0), "offset": ("offset", 0.0)}

    def is_noop(self) -> bool:
        return self.scale == 1 and self.offset == 0


@register
class OpBin(_NoopOnlyOperator):
    """NxN average-pooling binning (pre/preprocess.go:293-331)."""

    TYPE = "bin"
    PARAMS = {"bin_size": ("binSize", 1)}

    def is_noop(self) -> bool:
        return self.bin_size <= 1


@register
class OpStarDetect(UnaryOperator):
    """Star detection (pre/preprocess.go:401-465). Per-frame star-image
    saves are not ported."""

    TYPE = "starDetect"
    PARAMS = {
        "radius": ("radius", 16),
        "sigma": ("sigma", 10.0),
        "bad_pixel_sigma": ("badPixelSigma", 0.0),
        "in_out_ratio": ("inOutRatio", 10.0),
        "save": ("save", None),
    }

    def is_noop(self) -> bool:
        return self.radius == 0 or self.sigma == 0

    def apply(self, f: Image, c: Context) -> Image:
        if self.is_noop():
            return f
        if f.stats is None:
            raise ValueError("missing stats")
        save = self.save
        if save is not None and getattr(save, "file_pattern", ""):
            raise NotImplementedError("star-image saves are not ported yet "
                                      "(queued in ROADMAP.md)")
        from nightlight_tpu_torch.detect.stars import find_stars

        median_diff_std = None
        if f.median_diff_stats is not None:
            median_diff_std = f.median_diff_stats.stddev
        data2d = f.data if f.data.dim() == 2 else f.data[0]
        f.stars, f.hfr = find_stars(data2d, f.stats.location, f.stats.scale, self.sigma,
                                    self.bad_pixel_sigma, self.in_out_ratio,
                                    int(self.radius), median_diff_std)
        c.logf("%d: Stars %d HFR %.2f %s\n", f.id, f.stars.count, f.hfr, f.stats)
        return f


@register
class OpBackExtract(_NoopOnlyOperator):
    """Automated background extraction (pre/preprocess.go:333-399)."""

    TYPE = "backExtract"
    PARAMS = {
        "grid_size": ("gridSize", 0),
        "hfr_factor": ("hfrFactor", 4.0),
        "sigma": ("sigma", 1.5),
        "clip": ("clip", 0),
        "save": ("save", None),
    }

    def is_noop(self) -> bool:
        return self.grid_size <= 0
