"""Robust statistics for the stack path, in eager PyTorch.

Port of the parts of nightlight_tpu/ops/stats.py that the CLI ``stack``
command reaches at ``-lsEst 3``: min/mean/max, the quickselect-compatible
median/quartile helpers, the sampled iteratively sigma-clipped median + Qn
estimator (the default location/scale estimator) and the Stats object.

The sampled estimator draws the same sample indices and roll shifts as the
JAX package: they come from fixed ``PRNGKey(0)`` keys, reproduced bit for
bit by ops/jaxrand.py and cached per image size. The estimator runs batched
over frames: a (B, P) block of flattened frames gives (B,) locations and
scales, each frame's clip loop freezing once it converges, as a vmapped
``lax.while_loop`` does.
"""

from __future__ import annotations

import math
from enum import IntEnum
from functools import lru_cache

import numpy as np
import torch

from nightlight_tpu_torch.ops import jaxrand

NUM_SAMPLES = 128 * 1024
QN_SCALE = 2.21914
MAD_SCALE = 1.4826
CLIP_SCALE_ADJUST = 1.134


class LSEstimatorMode(IntEnum):
    """Location and scale estimator selection (stats.go:29-37)."""

    MeanStdDev = 0
    MedianMAD = 1
    IKSS = 2
    SCMedianQn = 3
    Histogram = 4


def _require_scmedianqn(mode) -> None:
    if LSEstimatorMode(mode) != LSEstimatorMode.SCMedianQn:
        raise NotImplementedError(
            f"location/scale estimator {int(mode)} is not ported yet (the port "
            "implements -lsEst 3; the other estimators are queued in ROADMAP.md)")


# ---------------------------------------------------------------------------
# Basic reductions
# ---------------------------------------------------------------------------


def min_mean_max(data: torch.Tensor):
    """Min, mean and max over the LAST axis of a flattened (..., P) block,
    as float32 tensors. The mean accumulates in float64 and rounds once to
    float32."""
    flat = data.reshape(*data.shape[:-1], -1) if data.dim() > 1 else data
    mn = flat.amin(-1)
    mx = flat.amax(-1)
    me = flat.to(torch.float64).mean(-1).to(torch.float32)
    return mn, me, mx


def median_sorted(ss: torch.Tensor) -> torch.Tensor:
    """Median along the last axis of sorted data (quickselect semantics:
    mean of the two middle elements for an even count)."""
    n = ss.shape[-1]
    if n % 2 == 1:
        return ss[..., n // 2]
    return 0.5 * (ss[..., n // 2 - 1] + ss[..., n // 2])


def first_quartile_sorted(ss: torch.Tensor) -> torch.Tensor:
    """The (n>>2)-th element, 0-indexed (qsort.go:61-63)."""
    return ss[..., ss.shape[-1] >> 2]


def _take_last(ss: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """ss[b, idx[b]] with indices clamped into range, like a JAX gather."""
    idx = idx.clamp(0, ss.shape[-1] - 1)
    return torch.gather(ss, -1, idx[..., None])[..., 0]


def _median_of_sorted_range(ss, lo, cnt):
    cnt = cnt.clamp(min=1)
    upper = _take_last(ss, lo + cnt // 2)
    lower = _take_last(ss, lo + (cnt // 2 - 1).clamp(min=0))
    return torch.where(cnt % 2 == 1, upper, 0.5 * (lower + upper))


# ---------------------------------------------------------------------------
# Sampled sigma-clipped median + Qn (-lsEst 3)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=16)
def _scmq_draws(p: int, num_samples: int, max_iter: int, seed: int = 0):
    """The estimator's random draws for an image of p pixels, exactly as
    nightlight_tpu/ops/stats.py sigma_clipped_median_qn takes them from
    PRNGKey(seed): sample indices, the Qn roll of the start, two rolls per
    clip iteration, and the roll of the final scale. Read-only numpy."""
    key = jaxrand.prng_key(seed)
    k_sample, k_qn0, k_loop, k_final = jaxrand.split(key, 4)
    idx = jaxrand.randint(k_sample, (num_samples,), 0, p)
    shift0 = int(jaxrand.randint(k_qn0, (1,), 1, num_samples)[0])
    loop = tuple(tuple(int(s) for s in jaxrand.randint(
        jaxrand.fold_in(k_loop, i), (2,), 1, num_samples)) for i in range(max_iter))
    final = int(jaxrand.randint(k_final, (1,), 1, num_samples)[0])
    idx.setflags(write=False)
    return idx, shift0, loop, final


def _sample(flat: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    """The estimator's sample (with replacement) of each row of (B, P) at
    the indices JAX's randint drew (stats.go:336-345)."""
    return flat[:, torch.tensor(idx, dtype=torch.int64, device=flat.device)]


def _qn_diffs_roll(sample, mask, shifts):
    """|s[i] - s[(i - k) mod n]| along the last axis for each roll k; pairs
    with an endpoint outside `mask` are +inf (ops/stats.py _qn_diffs_roll)."""
    parts = []
    for k in shifts:
        d = (sample - torch.roll(sample, k, dims=-1)).abs()
        if mask is not None:
            valid = mask & torch.roll(mask, k, dims=-1)
            d = torch.where(valid, d, torch.full((), math.inf, device=d.device))
        parts.append(d)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def sigma_clipped_median_qn(flat: torch.Tensor, sigma_low: float = 2.0,
                            epsilon=1e-4, num_samples: int = NUM_SAMPLES,
                            max_iter: int = 10):
    """Iteratively sigma-clipped sampled median and sampled Qn per row of a
    (B, P) block (stats.go:477-499). Keeps the reference's quirk of using
    sigma_low for both bounds. epsilon is a scalar or a (B,) tensor.
    Returns ((B,) location, (B,) scale), float32."""
    if flat.dim() == 1:
        loc, scale = sigma_clipped_median_qn(flat[None], sigma_low, epsilon,
                                             num_samples, max_iter)
        return loc[0], scale[0]
    b, p = flat.shape
    dev = flat.device
    idx, shift0, loop_shifts, shift_final = _scmq_draws(p, num_samples, max_iter)
    sr = _sample(flat, idx)
    ss = torch.sort(sr, dim=-1).values
    eps = torch.as_tensor(epsilon, dtype=torch.float32, device=dev).expand(b)
    sig = torch.tensor(float(sigma_low), dtype=torch.float32, device=dev)

    loc = median_sorted(ss)
    scale = first_quartile_sorted(torch.sort(_qn_diffs_roll(sr, None, (shift0,)),
                                             dim=-1).values) * QN_SCALE
    active = torch.ones(b, dtype=torch.bool, device=dev)
    n2 = 2 * num_samples
    for i in range(max_iter):
        lo_bound = loc - sig * scale
        hi_bound = loc + sig * scale
        lo = torch.searchsorted(ss, lo_bound[:, None], right=False)[:, 0]
        hi = torch.searchsorted(ss, hi_bound[:, None], right=True)[:, 0]
        cnt = (hi - lo).clamp(min=2)
        new_loc = _median_of_sorted_range(ss, lo, cnt)
        in_bounds = (sr >= lo_bound[:, None]) & (sr <= hi_bound[:, None])
        sd = torch.sort(_qn_diffs_roll(sr, in_bounds, loop_shifts[i]), dim=-1).values
        n_valid = torch.isfinite(sd).sum(-1)
        q = _take_last(sd, (n_valid >> 2).clamp(0, n2 - 1))
        new_scale = torch.where(n_valid > 0, q * QN_SCALE * CLIP_SCALE_ADJUST, scale)
        delta = (new_loc - loc).abs() + (new_scale - scale).abs()
        converged = delta <= eps
        # the reference returns the PREVIOUS location on convergence
        step = active & ~converged
        loc = torch.where(step, new_loc, loc)
        scale = torch.where(step, new_scale, scale)
        active = step
        if not bool(active.any()):
            break
    final_scale = first_quartile_sorted(torch.sort(
        _qn_diffs_roll(sr, None, (shift_final,)), dim=-1).values) * QN_SCALE
    return loc, final_scale


def location_scale(flat: torch.Tensor, mn: torch.Tensor, mx: torch.Tensor):
    """-lsEst 3 location/scale of (B, P) rows with their min/max, the exact
    call of Stats._update_location_scale: sigma 2, epsilon (max-min)/65535."""
    return sigma_clipped_median_qn(flat, 2.0, (mx - mn) / 65535.0)


def estimate_noise(img: torch.Tensor) -> torch.Tensor:
    """Immerkaer 1996 noise estimate of a 2D image (noise.go:32-55)."""
    d = img
    conv = (d[:-2, :-2] - 2 * d[:-2, 1:-1] + d[:-2, 2:]
            - 2 * d[1:-1, :-2] + 4 * d[1:-1, 1:-1] - 2 * d[1:-1, 2:]
            + d[2:, :-2] - 2 * d[2:, 1:-1] + d[2:, 2:])
    h, w = img.shape
    factor = math.sqrt(0.5 * math.pi) / (6.0 * (w - 2) * (h - 2))
    return conv.abs().sum() * factor


# ---------------------------------------------------------------------------
# Stats object
# ---------------------------------------------------------------------------


class Stats:
    """Cached statistics of an image plane (stats.go:44-244), computed on
    first access. Values are host floats: the port runs eagerly, so each
    statistic is one device reduction plus one read when first asked for.
    Linear transforms update the cache in O(1) (update_cached_with)."""

    __slots__ = ("_data", "_width", "_min", "_max", "_mean", "_stddev",
                 "_location", "_scale", "_noise", "_have_mmm", "_have_stddev",
                 "_have_locscale", "_have_noise", "mode")

    def __init__(self, data, width: int, mode: LSEstimatorMode | None = None):
        self._data = data
        self._width = int(width)
        self.mode = LSEstimatorMode.SCMedianQn if mode is None else LSEstimatorMode(mode)
        self._min = self._max = self._mean = self._stddev = 0.0
        self._location = self._scale = self._noise = 0.0
        self._have_mmm = self._have_stddev = self._have_locscale = self._have_noise = False

    @classmethod
    def with_mmm(cls, data, width, vmin, vmax, mean, mode=None) -> "Stats":
        s = cls(data, width, mode)
        s._min, s._max, s._mean = float(vmin), float(vmax), float(mean)
        s._have_mmm = True
        return s

    @classmethod
    def with_all(cls, data, width, vmin, vmax, mean, location, scale, mode=None) -> "Stats":
        s = cls.with_mmm(data, width, vmin, vmax, mean, mode)
        s._location, s._scale = float(location), float(scale)
        s._have_locscale = True
        return s

    @classmethod
    def from_stddev(cls, stddev) -> "Stats":
        s = cls(None, 0)
        s._stddev = float(stddev)
        s._have_stddev = True
        return s

    def set_data(self, data) -> None:
        self._data = data
        self.clear()

    def replace_data(self, data) -> None:
        self._data = data

    def free_data(self) -> None:
        self._data = None

    def clear(self) -> None:
        self._have_mmm = self._have_stddev = self._have_locscale = self._have_noise = False

    def _flat(self):
        if self._data is None:
            raise ValueError("cannot calculate stats on freed data")
        return self._data.reshape(-1)

    def update_cached_with(self, multiplier: float, offset: float) -> None:
        """O(1) cache update after x -> x*multiplier + offset (stats.go:91-99)."""
        self._min = float(self._min) * multiplier + offset
        self._max = float(self._max) * multiplier + offset
        self._mean = float(self._mean) * multiplier + offset
        self._stddev = float(self._stddev) * multiplier
        self._location = float(self._location) * multiplier + offset
        self._scale = float(self._scale) * multiplier
        self._noise = float(self._noise) * multiplier

    def _ensure_mmm(self) -> None:
        if not self._have_mmm:
            mn, me, mx = min_mean_max(self._flat())
            self._min, self._mean, self._max = float(mn), float(me), float(mx)
            self._have_mmm = True

    @property
    def min(self) -> float:
        self._ensure_mmm()
        return self._min

    @property
    def max(self) -> float:
        self._ensure_mmm()
        return self._max

    @property
    def mean(self) -> float:
        self._ensure_mmm()
        return self._mean

    @property
    def stddev(self) -> float:
        if not self._have_stddev:
            self._ensure_mmm()
            flat = self._flat()
            mean = torch.tensor(self._mean, dtype=torch.float32, device=flat.device)
            diff = flat - mean
            self._stddev = float(torch.sqrt(torch.mean(diff * diff)))
            self._have_stddev = True
        return self._stddev

    @property
    def location(self) -> float:
        if not self._have_locscale:
            self._update_location_scale()
        return self._location

    @property
    def scale(self) -> float:
        if not self._have_locscale:
            self._update_location_scale()
        return self._scale

    @property
    def noise(self) -> float:
        if not self._have_noise:
            d = self._data
            if d.dim() == 1:
                d = d.reshape(-1, self._width)
            elif d.dim() == 3:
                d = d[0]
            self._noise = float(estimate_noise(d))
            self._have_noise = True
        return self._noise

    def _update_location_scale(self) -> None:
        _require_scmedianqn(self.mode)
        flat = self._flat()
        if not self._have_mmm:
            mn, me, mx = min_mean_max(flat)
            self._min, self._mean, self._max = float(mn), float(me), float(mx)
            self._have_mmm = True
        dev = flat.device
        mn = torch.tensor(self._min, dtype=torch.float32, device=dev)
        mx = torch.tensor(self._max, dtype=torch.float32, device=dev)
        loc, scale = location_scale(flat[None], mn[None], mx[None])
        self._location, self._scale = float(loc[0]), float(scale[0])
        self._have_locscale = True

    def snapshot_for_log(self) -> "_StatsSnapshot":
        return _StatsSnapshot(self._min, self._max, self._mean, self._stddev,
                              self._location, self._scale, self._noise,
                              self._have_mmm, self._have_stddev,
                              self._have_locscale, self._have_noise)

    def __str__(self) -> str:
        return str(self.snapshot_for_log())


class _StatsSnapshot:
    """Stats field values frozen for one log line. ``render_deferred`` marks
    it for the context's ordered log buffer (pipeline/context.py)."""

    __slots__ = ("_min", "_max", "_mean", "_stddev", "_location", "_scale",
                 "_noise", "_have_mmm", "_have_stddev", "_have_locscale",
                 "_have_noise")

    def __init__(self, mn, mx, mean, stddev, location, scale, noise,
                 have_mmm, have_stddev, have_locscale, have_noise):
        self._min, self._max, self._mean = mn, mx, mean
        self._stddev, self._location, self._scale = stddev, location, scale
        self._noise = noise
        self._have_mmm, self._have_stddev = have_mmm, have_stddev
        self._have_locscale, self._have_noise = have_locscale, have_noise

    def render_deferred(self) -> str:
        return str(self)

    def __str__(self) -> str:
        precision = 6
        if self._have_mmm:
            m = float(self._max)
            if m >= 1_000_000:
                precision = 0
            elif m >= 100_000:
                precision = 1
            elif m >= 10_000:
                precision = 2
            elif m >= 1_000:
                precision = 3
            elif m > 100:
                precision = 4
            elif m > 10:
                precision = 5
        parts = []
        if self._have_mmm:
            parts.append(f"Min {self._min:.{precision}f} Max {self._max:.{precision}f} "
                         f"Mean {self._mean:.{precision}f}")
        if self._have_stddev:
            parts.append(f"StdDev {self._stddev:.{precision}f}")
        if self._have_locscale:
            parts.append(f"Location {self._location:.{precision}f} Scale {self._scale:.{precision}f}")
        if self._have_noise:
            parts.append(f"Noise {self._noise:.{precision}f}")
        if not parts:
            return "(no stats yet)"
        return " ".join(parts)
