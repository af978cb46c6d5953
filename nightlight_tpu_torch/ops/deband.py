"""Banding removal, mirror of nightlight_tpu/ops/deband.py (reference:
internal/ops/pre/banding.go): the per-row (or per-column) percentile of the
pixels at or below location + sigma*scale, the median of those percentiles
in a sliding window with linear extrapolation past the image edges, and a
multiplicative per-row correction.

On the device: one masked sort of the rows for the percentiles, then all
rows' windows as one (rows, window) gather and batched median, the edge
rule applied by mask. The host loop of the reference (_window_median_factors)
stays as the tests' cross-check.
"""

from __future__ import annotations

import numpy as np
import torch

from nightlight_tpu_torch.ops.pixelmath import fma32

BIG = 3.4e38


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _row_percentiles(img: torch.Tensor, percentile, threshold) -> torch.Tensor:
    """k-th lowest (1-based) value of each row among those <= threshold,
    k = int(count * percentile * 0.01) in float32 (banding.go:82-93)."""
    dev = img.device
    below = img <= threshold
    masked = torch.where(below, img, _f32(BIG, dev))
    s = torch.sort(masked, dim=1).values
    cnt = below.sum(dim=1)
    k = (cnt.to(torch.float32) * _f32(percentile, dev) * _f32(0.01, dev)).to(torch.int32)
    idx = torch.minimum((k - 1).clamp(min=0), (cnt - 1).clamp(min=0))
    return torch.gather(s, 1, idx.to(torch.int64)[:, None])[:, 0]


def _median_axis1(a: torch.Tensor) -> torch.Tensor:
    """Median along axis 1, the mean of the two middles for an even count."""
    s = torch.sort(a, dim=1).values
    m = a.shape[1]
    if m % 2 == 1:
        return s[:, m // 2]
    return 0.5 * (s[:, m // 2 - 1] + s[:, m // 2])


def _window_median_factors_device(percentiles: torch.Tensor, window: int) -> torch.Tensor:
    """Per-row correction factors: the window median of the percentiles
    over the clamped window, entries past either edge replaced by the
    linear gradient of the two half-window medians (banding.go:96-162)."""
    dev = percentiles.device
    n = percentiles.shape[0]
    w = int(window)
    rows = torch.arange(n, device=dev)
    start_raw = rows - (w >> 1)
    missing = torch.where(start_raw < 0, start_raw, (start_raw + w - n).clamp(min=0))
    start = start_raw.clamp(0, n - w)
    j = torch.arange(w, device=dev)[None, :]
    win = percentiles[start[:, None] + j]

    half = w // 2
    left_med = _median_axis1(win[:, :half]) if half > 0 else win[:, 0]
    right_med = _median_axis1(win[:, half:])
    mean_of_medians = 0.5 * (left_med + right_med)
    center = 0.5 * w
    slope = (right_med - left_med) / center

    jf = j.to(torch.float32)
    replace_left = (missing[:, None] < 0) & (j >= w + missing[:, None])
    replace_right = (missing[:, None] > 0) & (j < missing[:, None])
    # mean + slope * offset as the fused multiply-add XLA makes of it
    extrap_left = fma32(slope[:, None], (jf - w) - center, mean_of_medians[:, None])
    extrap_right = fma32(slope[:, None], (jf + w) - center, mean_of_medians[:, None])
    adjusted = torch.where(replace_left, extrap_left,
                           torch.where(replace_right, extrap_right, win))
    return _median_axis1(adjusted) / percentiles


def deband_core(img: torch.Tensor, percentile, window: int, threshold, horizontal: bool):
    """One deband pass at a given threshold. Returns (corrected image,
    lowest factor clamped to <= 1, highest clamped to >= 0) with the
    extrema as 0-d tensors. Vertical debanding runs on the transpose."""
    work = img if horizontal else img.T
    percentiles = _row_percentiles(work, percentile, threshold)
    factors = _window_median_factors_device(percentiles, window)
    lowest = torch.clamp(factors.min(), max=1.0)
    highest = torch.clamp(factors.max(), min=0.0)
    out = img * (factors[:, None] if horizontal else factors[None, :])
    return out, lowest, highest


def deband(img: torch.Tensor, percentile: float, window: int, sigma: float,
           location, scale, horizontal: bool):
    """Remove banding. Returns (corrected image, lowest factor, highest
    factor, threshold) for the log line (banding.go:61-131, 197-269); the
    threshold is float32(location) + sigma * float32(scale) in float32, or
    3.4e38 when sigma is 0."""
    threshold = (np.float32(location) + np.float32(sigma) * np.float32(scale) if sigma != 0
                 else np.float32(BIG))
    n = img.shape[0] if horizontal else img.shape[1]
    out, lowest, highest = deband_core(img, percentile, min(int(window), n),
                                       _f32(threshold, img.device), horizontal)
    return out, float(lowest), float(highest), float(threshold) if sigma != 0 else BIG


# ---------------------------------------------------------------------------
# The reference's host loop (banding.go:96-162), the cross-check of the
# device version
# ---------------------------------------------------------------------------


def _median(a: np.ndarray) -> float:
    """QSelectMedianFloat32 semantics = numpy median (average of middles)."""
    return float(np.median(a))


def _fix_window_edge(window: np.ndarray, missing: int) -> None:
    """Replace out-of-range window entries with a linear gradient
    extrapolation from the two half-window medians (banding.go:134-162)."""
    n = len(window)
    half = n // 2
    left_med = _median(window[:half])
    right_med = _median(window[half:])
    mean_of_medians = 0.5 * (left_med + right_med)
    center = 0.5 * (half + (n - half))
    slope = (right_med - left_med) / center
    if missing < 0:
        for i in range(n + missing, n):
            window[i] = mean_of_medians + slope * ((i - n) - center)
    else:
        for i in range(missing):
            window[i] = mean_of_medians + slope * ((i + n) - center)


def _window_median_factors(percentiles: np.ndarray, window: int) -> np.ndarray:
    """Median-of-percentiles in a sliding window with edge extrapolation,
    returning per-row correction factors (banding.go:96-127)."""
    n = len(percentiles)
    window = min(window, n)
    factors = np.empty(n, np.float32)
    for row in range(n):
        start = row - (window >> 1)
        missing = 0
        if start < 0:
            missing = start
            start = 0
        end = start + window
        if end > n:
            missing = end - n
            end = n
            start = end - window
        clone = percentiles[start:end].astype(np.float32).copy()
        if missing != 0:
            _fix_window_edge(clone, missing)
        factors[row] = _median(clone) / percentiles[row]
    return factors
