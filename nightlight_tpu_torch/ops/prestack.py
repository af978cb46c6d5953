"""Pre-stack calibration for mono frames, mirror of the matching functions
of nightlight_tpu/ops/prestack.py: dark subtraction, flat division with
degenerate-pixel passthrough (badpixels.go:107-123), the 3x3 median as the
9-element min/max sorting network (median3x3.go:85-110), and the bad-pixel
map with median repair (badpixels.go:32-104).

Every function works on (H, W) images and on (N, H, W) frame batches.
"""

from __future__ import annotations

import torch


def subtract(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b (badpixels.go:107-111)."""
    return a - b


def flat_divide(a: torch.Tensor, flat: torch.Tensor, flat_max: float) -> torch.Tensor:
    """a * flat_max / flat, passing through where the flat is <= 0."""
    fm = torch.tensor(float(flat_max), dtype=torch.float32, device=a.device)
    return torch.where(flat <= 0.0, a, a * fm / flat)


def _sort2(a, b):
    return torch.minimum(a, b), torch.maximum(a, b)


def median9(v: list) -> torch.Tensor:
    """Median of 9 planes via the 30-op sorting network (median3x3.go:85-110)."""
    a0, a1, a2, a3, a4, a5, a6, a7, a8 = v
    a0, a1 = _sort2(a0, a1)
    a3, a4 = _sort2(a3, a4)
    a6, a7 = _sort2(a6, a7)
    a1, a2 = _sort2(a1, a2)
    a4, a5 = _sort2(a4, a5)
    a7, a8 = _sort2(a7, a8)
    a0, a1 = _sort2(a0, a1)
    a3, a4 = _sort2(a3, a4)
    a6, a7 = _sort2(a6, a7)
    a3 = torch.maximum(a0, a3)
    a6 = torch.maximum(a3, a6)
    a1, a4 = _sort2(a1, a4)
    a4 = torch.minimum(a4, a7)
    a4 = torch.maximum(a1, a4)
    a5 = torch.minimum(a5, a8)
    a2 = torch.minimum(a2, a5)
    a2, a4 = _sort2(a2, a4)
    a4 = torch.minimum(a4, a6)
    a4 = torch.maximum(a2, a4)
    return a4


def median_filter_3x3(img: torch.Tensor) -> torch.Tensor:
    """3x3 median over the last two axes; the outermost rows and columns
    pass through unchanged (median3x3.go:26-38)."""
    h, w = img.shape[-2], img.shape[-1]
    planes = [img[..., dy:h - 2 + dy, dx:w - 2 + dx] for dy in range(3) for dx in range(3)]
    out = img.clone()
    out[..., 1:-1, 1:-1] = median9(planes)
    return out


def _std(diff: torch.Tensor) -> torch.Tensor:
    """Population stddev over the last two axes, accumulated in float64 and
    rounded once to float32."""
    d = diff.reshape(*diff.shape[:-2], -1).to(torch.float64)
    return d.std(-1, correction=0).to(torch.float32)


def bad_pixel_stats(img: torch.Tensor):
    """Difference from the local 3x3 median and its stddev (badpixels.go:32-41)."""
    diff = img - median_filter_3x3(img)
    return diff, _std(diff)


def bad_pixel_repair(img: torch.Tensor, sigma_low: float, sigma_high: float):
    """Replace pixels deviating from the 3x3 median by more than sigma times
    the stddev of the median-difference map with that median
    (badpixels.go:32-104). Returns (repaired, num_bad, diff_stddev), the
    last two per frame for a batch."""
    med = median_filter_3x3(img)
    diff = img - med
    std = _std(diff)
    s = std[..., None, None]
    slo = torch.tensor(float(sigma_low), dtype=torch.float32, device=img.device)
    shi = torch.tensor(float(sigma_high), dtype=torch.float32, device=img.device)
    bad = (diff < -slo * s) | (diff > shi * s)
    repaired = torch.where(bad, med, img)
    return repaired, bad.sum(dim=(-2, -1)), std
