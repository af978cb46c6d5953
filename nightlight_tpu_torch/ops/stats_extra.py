"""Remaining estimator inventory, mirror of nightlight_tpu/ops/stats_extra.py:
exact sigma-clipped median/MAD, bounded sampled estimators, half-sample
mode, perceptual histogram, and the Gaussian-fit histogram mode.

Completes the reference's stats surface (reference: internal/stats/stats.go:
290-332, 349-430, 591-637; histogram.go:44-190) beyond the hot-path
estimators in ops/stats.py. No CLI path calls these. The sampled
estimators take a raw threefry key (ops/jaxrand.py, ``prng_key(seed)`` for
``jax.random.PRNGKey(seed)``) and draw the JAX package's own samples from
it. The histogram helpers and the half-sample mode are host code on numpy,
as in the JAX package; the Gaussian fit carries its own copy of the
Nelder-Mead simplex search that the JAX package takes from scipy.
"""

from __future__ import annotations

import numpy as np
import torch

from nightlight_tpu_torch.ops import jaxrand
from nightlight_tpu_torch.ops.pixelmath import _f32, fma32
from nightlight_tpu_torch.ops.stats import (
    MAD_SCALE,
    NUM_SAMPLES,
    QN_SCALE,
    _median_of_sorted_range,
    _sample,
    first_quartile_sorted,
    median_sorted,
)


def _prefix_sum(x: torch.Tensor, block: int = 16) -> torch.Tensor:
    """Inclusive prefix sum of a 1-D float32 tensor in the order of XLA's
    CPU cumsum (its reduce-window rewrite): blocks of 16 summed left to
    right, the block totals prefix-summed the same way, recursively, and
    each block's running sums offset by the total before it. Any device
    gives the same bits."""
    n = x.shape[0]
    nb = -(-n // block)
    b = torch.zeros(nb * block, dtype=x.dtype, device=x.device)
    b[:n] = x
    b = b.reshape(nb, block)
    cols = [b[:, 0]]
    for k in range(1, block):
        cols.append(cols[-1] + b[:, k])
    inner = torch.stack(cols, 1)
    if nb > 1:
        before = _prefix_sum(inner[:, -1].contiguous(), block)[:-1]
        inner[1:] += before[:, None]
    return inner.reshape(-1)[:n]


def _clip_window(xs: torch.Tensor, sigma_low: float, sigma_high: float):
    """The final clip window [lo, hi) of sorted float32 xs: while a round
    rejects something and more than 3 values remain, keep [median -
    sigma_low*std, median + sigma_high*std] of the window, std about the
    median from float32 prefix sums (added in XLA's order, so that a bound
    lands where the JAX package's does), scaled by 1.134. A host loop over
    0-d device indices, one read a round."""
    n = xs.shape[0]
    zero = torch.zeros(1, dtype=xs.dtype, device=xs.device)
    s1 = torch.cat([zero, _prefix_sum(xs)])
    s2 = torch.cat([zero, _prefix_sum(xs * xs)])
    lo = torch.tensor(0, dtype=torch.int64, device=xs.device)
    hi = torch.tensor(n, dtype=torch.int64, device=xs.device)
    while True:
        cnt = hi - lo
        med = _median_of_sorted_range(xs, lo, cnt)
        c = cnt.clamp(min=1).to(xs.dtype)
        # stddev about the median: E[x^2] - 2 m E[x] + m^2, with the fused
        # multiply-adds XLA's CPU code contracts it to (the difference
        # cancels to a few bits), the square root correctly rounded
        ex2 = (s2[hi] - s2[lo]) / c
        ex = (s1[hi] - s1[lo]) / c
        var = fma32(med, med, fma32(-2 * med, ex, ex2)).clamp(min=0.0)
        std = torch.sqrt(var.to(torch.float64)).to(xs.dtype) * 1.134
        bounds = torch.stack([fma32(-_f32(sigma_low, std), std, med),
                              fma32(_f32(sigma_high, std), std, med)])
        new_lo = torch.maximum(torch.searchsorted(xs, bounds[:1], right=False)[0], lo)
        new_hi = torch.minimum(torch.searchsorted(xs, bounds[1:], right=True)[0], hi)
        rejected = (new_lo - lo) + (hi - new_hi)
        lo, hi = new_lo, new_hi
        if bool((rejected == 0) | ((hi - lo) <= 3)):
            return lo, hi


def sigma_clipped_median_and_mad(data: torch.Tensor, sigma_low: float, sigma_high: float):
    """EXACT iterative sigma-clipped median + final full-data MAD
    (stats.go:290-332).

    Clipping removes values outside [median - sigmaLow*std, median +
    sigmaHigh*std] with std about the MEDIAN scaled by 1.134; since the kept
    set is always an interval, it stays contiguous in sorted order and the
    loop is index arithmetic over prefix sums (_clip_window). The final MAD
    is over the ORIGINAL data w.r.t. the final median (stats.go:322-325),
    scaled by 1.4826. Returns 0-d float32 (median, mad).
    """
    flat = data.reshape(-1)
    xs = torch.sort(flat).values
    lo, hi = _clip_window(xs, sigma_low, sigma_high)
    med = _median_of_sorted_range(xs, lo, (hi - lo).clamp(min=1))
    mad = median_sorted(torch.sort((flat - med).abs()).values) * MAD_SCALE
    return med, mad


# ---------------------------------------------------------------------------
# Bounded sampled estimators (stats.go:349-430, 450-472)
# ---------------------------------------------------------------------------


def _key_sample(data: torch.Tensor, key: np.ndarray, num_samples: int) -> torch.Tensor:
    """The JAX package's _sample: num_samples pixels drawn with replacement
    at jax.random.randint(key, (num_samples,), 0, pixels)."""
    flat = data.reshape(1, -1)
    return _sample(flat, jaxrand.randint(key, (num_samples,), 0, flat.shape[1]))[0]


def _window(ss: torch.Tensor, low_bound, high_bound):
    """[lo, hi) of the sorted sample inside [low_bound, high_bound]."""
    bounds = torch.tensor([low_bound, high_bound], dtype=ss.dtype).to(ss.device)
    lo = torch.searchsorted(ss, bounds[:1], right=False)[0]
    hi = torch.searchsorted(ss, bounds[1:], right=True)[0]
    return lo, hi


def fast_approx_bounded_median(data, low_bound, high_bound, key,
                               num_samples: int = NUM_SAMPLES) -> torch.Tensor:
    """Sampled median restricted to [low, high] (stats.go:349-364); the
    reference's rejection resampling becomes a sorted-sample window."""
    ss = torch.sort(_key_sample(data, key, num_samples)).values
    lo, hi = _window(ss, low_bound, high_bound)
    return _median_of_sorted_range(ss, lo, (hi - lo).clamp(min=1))


def fast_approx_bounded_mad(data, location, low_bound, high_bound, key,
                            num_samples: int = NUM_SAMPLES) -> torch.Tensor:
    """Sampled bounded MAD (stats.go:413-430)."""
    s = _key_sample(data, key, num_samples)
    ok = (s >= low_bound) & (s <= high_bound)
    dev = torch.where(ok, (s - location).abs(), torch.full_like(s, 3.4e38))
    sd = torch.sort(dev).values
    cnt = ok.sum()
    return _median_of_sorted_range(sd, torch.zeros_like(cnt), cnt.clamp(min=1)) * MAD_SCALE


def fast_approx_bounded_stddev(data, location, low_bound, high_bound, key,
                               num_samples: int = NUM_SAMPLES) -> torch.Tensor:
    """Sampled bounded stddev about a location (stats.go:381-398)."""
    s = _key_sample(data, key, num_samples)
    ok = (s >= low_bound) & (s <= high_bound)
    d2 = torch.where(ok, (s - location) ** 2, torch.zeros_like(s))
    return torch.sqrt(d2.sum() / ok.sum().clamp(min=1))


def _qn_pairs_from(values: torch.Tensor, lo, cnt, key: np.ndarray,
                   num_samples: int) -> torch.Tensor:
    """Absolute differences of num_samples uniform unordered pairs drawn
    from values[lo:lo+cnt] (the JAX package's ops/stats.py _qn_pairs_from):
    i1 uniform, i2 uniform over the rest, from the same threefry draws.
    Indices past the end clamp, as a JAX gather does."""
    k1, k2 = jaxrand.split(key)
    u1 = torch.from_numpy(jaxrand.randint(k1, (num_samples,), 0, 1 << 30).astype(np.int64))
    u2 = torch.from_numpy(jaxrand.randint(k2, (num_samples,), 0, 1 << 30).astype(np.int64))
    cnt = max(int(cnt), 2)
    i1 = u1 % cnt
    i2 = u2 % (cnt - 1)
    i2 = torch.where(i2 >= i1, i2 + 1, i2)
    last = values.shape[0] - 1
    a = (int(lo) + i1).clamp(max=last).to(values.device)
    b = (int(lo) + i2).clamp(max=last).to(values.device)
    return (values[a] - values[b]).abs()


def fast_approx_bounded_qn(data, low_bound, high_bound, key,
                           num_samples: int = NUM_SAMPLES) -> torch.Tensor:
    """Sampled bounded Qn (stats.go:450-472)."""
    k1, k2 = jaxrand.split(key)
    ss = torch.sort(_key_sample(data, k1, num_samples)).values
    lo, hi = _window(ss, low_bound, high_bound)
    diffs = _qn_pairs_from(ss, lo, hi - lo, k2, num_samples)
    return first_quartile_sorted(torch.sort(diffs).values) * QN_SCALE


# ---------------------------------------------------------------------------
# Half-sample mode (stats.go:591-637; dead code in the reference)
# ---------------------------------------------------------------------------


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def half_sample_mode(data) -> float:
    """Bickel & Fruehwirth 2006 half-sample mode estimate (stats.go:591-637).

    Recursively narrows to the densest half-sample. The reference's tie
    bookkeeping is degenerate (it accumulates every non-improving index,
    stats.go:620-635) and the function is dead code there; this implements
    the standard first-minimal-window variant.
    """
    xs = np.sort(np.asarray(_host(data), np.float64).reshape(-1))
    while True:
        n = len(xs)
        if n == 1:
            return float(xs[0])
        if n == 2:
            return float(0.5 * (xs[0] + xs[1]))
        if n == 3:
            # The reference returns half the WIDTH of the tighter pair here
            # (stats.go:608-614), which cannot be a mode location; return the
            # midpoint of the tighter pair instead (dead code there anyway).
            width_diff = (xs[1] - xs[0]) - (xs[2] - xs[1])
            if width_diff < 0:
                return float(0.5 * (xs[1] + xs[0]))
            if width_diff > 0:
                return float(0.5 * (xs[2] + xs[1]))
            return float(xs[1])
        half = n // 2
        widths = xs[half - 1:] - xs[: n - half + 1]
        i = int(np.argmin(widths))
        xs = xs[i: i + half]


# ---------------------------------------------------------------------------
# Histogram peak utilities (histogram.go:44-190)
# ---------------------------------------------------------------------------


def get_peak(bins, vmin: float, vmax: float):
    """Location and value of the histogram peak (histogram.go:45-56)."""
    bins = _host(bins)
    max_index = int(np.argmax(bins))
    x = vmin + (max_index + 0.5) * (vmax - vmin) / (len(bins) - 1)
    y = 0.5 * float(bins[max_index] + bins[min(max_index + 1, len(bins) - 1)])
    return x, y


class _BudgetSpent(Exception):
    pass


def _nelder_mead(f, x0, xatol: float = 1e-4, fatol: float = 1e-4) -> np.ndarray:
    """Minimum of f by the Nelder-Mead simplex search, step for step as
    scipy.optimize.minimize(method="Nelder-Mead") runs it at its defaults
    (non-adaptive coefficients, an initial simplex 5% off x0 in each
    coordinate, at most 200 iterations and 200 evaluations a dimension, a
    step cut short where the evaluations run out), so that the fit lands on
    the JAX package's point."""
    x0 = np.asarray(x0, np.float64).reshape(-1)
    n = len(x0)
    rho, chi, psi, sigma = 1, 2, 0.5, 0.5
    max_calls = max_iter = 200 * n
    sim = np.empty((n + 1, n), np.float64)
    sim[0] = x0
    for k in range(n):
        y = np.array(x0, copy=True)
        y[k] = (1 + 0.05) * y[k] if y[k] != 0 else 0.00025
        sim[k + 1] = y
    calls = 0

    def fn(x):
        nonlocal calls
        if calls >= max_calls:
            raise _BudgetSpent
        calls += 1
        return f(np.copy(x))

    fsim = np.array([fn(v) for v in sim], float)
    ind = np.argsort(fsim)
    sim, fsim = np.take(sim, ind, 0), np.take(fsim, ind, 0)
    iterations = 1
    while calls < max_calls and iterations < max_iter:
        try:
            if (np.max(np.ravel(np.abs(sim[1:] - sim[0]))) <= xatol
                    and np.max(np.abs(fsim[0] - fsim[1:])) <= fatol):
                break
            xbar = np.add.reduce(sim[:-1], 0) / n
            xr = (1 + rho) * xbar - rho * sim[-1]
            fxr = fn(xr)
            if fxr < fsim[0]:
                xe = (1 + rho * chi) * xbar - rho * chi * sim[-1]
                fxe = fn(xe)
                if fxe < fxr:
                    sim[-1], fsim[-1] = xe, fxe
                else:
                    sim[-1], fsim[-1] = xr, fxr
            elif fxr < fsim[-2]:
                sim[-1], fsim[-1] = xr, fxr
            else:
                shrink = False
                if fxr < fsim[-1]:
                    xc = (1 + psi * rho) * xbar - psi * rho * sim[-1]
                    fxc = fn(xc)
                    if fxc <= fxr:
                        sim[-1], fsim[-1] = xc, fxc
                    else:
                        shrink = True
                else:
                    xcc = (1 - psi) * xbar + psi * sim[-1]
                    fxcc = fn(xcc)
                    if fxcc < fsim[-1]:
                        sim[-1], fsim[-1] = xcc, fxcc
                    else:
                        shrink = True
                if shrink:
                    for j in range(1, n + 1):
                        sim[j] = sim[0] + sigma * (sim[j] - sim[0])
                        fsim[j] = fn(sim[j])
            iterations += 1
        except _BudgetSpent:
            pass
        ind = np.argsort(fsim)
        sim, fsim = np.take(sim, ind, 0), np.take(fsim, ind, 0)
    return sim[0]


def get_mode_stddev_from_histogram(bins, vmin: float, vmax: float):
    """Gaussian fit to the histogram via Nelder-Mead (histogram.go:59-95).
    Returns (mode, stddev)."""
    bins = np.asarray(_host(bins), np.float64)
    peak, peak_val = get_peak(bins, vmin, vmax)
    xs = vmin + (np.arange(len(bins)) + 0.5) * (vmax - vmin) / (len(bins) - 1)

    def objective(p):
        alpha, mu, sigma = p
        scaler = alpha / (abs(sigma) * np.sqrt(2 * np.pi) + 1e-30)
        pred = scaler * np.exp(-0.5 * ((xs - mu) / (sigma + 1e-30)) ** 2)
        return float(np.sqrt(np.mean((bins - pred) ** 2)))

    x = _nelder_mead(objective, [peak_val, peak, 5.0])
    return float(x[1]), float(abs(x[2]))


_PERCEPTUAL_GAMMA = 2.4


def perceptual_histogram(data, vmin: float, vmax: float, num_bins: int) -> np.ndarray:
    """Histogram with perceptually (gamma-2.4) spaced bins
    (histogram.go:97-121)."""
    d = _host(data).reshape(-1)
    idx = (np.power(np.clip((d - vmin) / max(vmax - vmin, 1e-30), 0, 1),
                    1.0 / _PERCEPTUAL_GAMMA) * (num_bins - 1)).astype(np.int64)
    return np.bincount(np.clip(idx, 0, num_bins - 1), minlength=num_bins).astype(np.int32)


def get_perceptual_histogram_peak(bins, vmin: float, vmax: float):
    """Peak of a perceptual histogram mapped back to data space
    (histogram.go:124-137)."""
    bins = _host(bins)
    max_index = int(np.argmax(bins))
    x = (float(max_index + 0.5) / (len(bins) - 1)) ** _PERCEPTUAL_GAMMA * (vmax - vmin) + vmin
    y = 0.5 * float(bins[max_index] + bins[min(max_index + 1, len(bins) - 1)])
    return x, y
