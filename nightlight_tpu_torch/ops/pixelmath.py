"""Point operations and curves (pixelops.go), mirror of
nightlight_tpu/ops/pixelmath.py. Scalars enter as float32, as they do
inside the JAX package's jitted functions."""

from __future__ import annotations

import torch

from nightlight_tpu_torch import trace


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return trace.upload(torch.as_tensor(v, dtype=torch.float32), like.device)


def fma32(a, b, c) -> torch.Tensor:
    """a*b + c rounded once to float32, as the fused multiply-add that XLA's
    CPU code contracts such an expression to: the float64 product of two
    float32 values is exact, and the float64 sum rounds as the FMA does
    (but for a double rounding at odds of about 2^-29)."""
    d = torch.float64
    return (a.to(d) * b.to(d) + c.to(d)).to(torch.float32)


def scale_offset(data: torch.Tensor, scale: float, offset: float) -> torch.Tensor:
    """x*scale + offset (pixelops.go:123-128), as one fused multiply-add
    like the JAX package's jitted program."""
    return fma32(data, _f32(scale, data), _f32(offset, data))


def gamma(data: torch.Tensor, g: float) -> torch.Tensor:
    """x**(1/g); data normalized to [0, 1] (pixelops.go:151-157)."""
    return torch.pow(data, 1.0 / _f32(g, data))


def partial_gamma(data: torch.Tensor, from_, to, g: float) -> torch.Tensor:
    """Gamma boost restricted to values in (from, to) (pixelops.go:179-191)."""
    from_, to = _f32(from_, data), _f32(to, data)
    rescale2 = to - from_
    rescale1 = 1.0 / rescale2
    dd = (data - from_) * rescale1
    boosted = fma32(torch.pow(dd.clamp(min=0.0), 1.0 / _f32(g, data)), rescale2, from_)
    inside = (data > from_) & (data < to)
    return torch.where(inside, boosted, data)


def midtones(data: torch.Tensor, mid, black) -> torch.Tensor:
    """Midtones transfer function with black clip (pixelops.go:214-229);
    out-of-range values map to 0 or 1 before the rescale, as in the
    reference."""
    mid, black = _f32(mid, data), _f32(black, data)
    clip_low = black * (mid - 1.0) / fma32(2.0 * mid - 1.0, black, -mid)
    scaler = 1.0 / (1.0 - clip_low)
    raw = data * (mid - 1.0) / fma32(2.0 * mid - 1.0, data, -mid)
    zero = torch.zeros((), dtype=torch.float32, device=data.device)
    v = torch.where(raw < clip_low, zero, torch.where(raw > 1.0, zero + 1.0, raw))
    return (v - clip_low) * scaler


def shift_black_to_move(data: torch.Tensor, before, after) -> torch.Tensor:
    """Move the black point so `before` maps to `after` (pixelops.go:649-660)."""
    before, after = _f32(before, data), _f32(after, data)
    black = (after - before) / (after - 1.0)
    scale = 1.0 / (1.0 - black)
    return ((data - black) * scale).clamp(min=0.0)


def normalize(data: torch.Tensor, vmin, vmax) -> torch.Tensor:
    """Normalize [min, max] to [0, 1] (pixelops.go:143-147), clamped to the
    range; d*scale - min*scale as the fused multiply-add XLA makes of it."""
    vmin, vmax = _f32(vmin, data), _f32(vmax, data)
    scale = 1.0 / (vmax - vmin)
    return fma32(data, scale, -(vmin * scale)).clamp(0.0, 1.0)


def scale_offset_clamp_rgb(data: torch.Tensor, alpha, beta) -> torch.Tensor:
    """Per-channel x*alpha + beta on a (3, H, W) cube, clamped to [0, 1]
    (pixelops.go:679-692); alpha and beta are (3,) float32 vectors, and
    x*alpha + beta one fused multiply-add, as XLA contracts it."""
    alpha = torch.as_tensor(alpha, dtype=torch.float32).to(data.device)[:, None, None]
    beta = torch.as_tensor(beta, dtype=torch.float32).to(data.device)[:, None, None]
    return fma32(data, alpha, beta).clamp(0.0, 1.0)


def set_black_white(data: torch.Tensor, black_perc: float, white_perc: float,
                    num_bins: int = 65536):
    """Black/white point clip by histogram percentile (pixelops.go:695-744).
    Returns (new data, black_x, white_x, black fraction, white fraction),
    the scalars as 0-d tensors."""
    flat = data.reshape(-1)
    n = flat.shape[0]
    vmin, vmax = flat.min(), flat.max()
    scale = (num_bins - 1) / (vmax - vmin)
    idx = ((flat - vmin) * scale).to(torch.int32).clamp(0, num_bins - 1)
    hist = torch.bincount(idx.to(torch.int64), minlength=num_bins)
    cum_lo = torch.cumsum(hist, 0)
    black_budget = int(black_perc * 0.01 * n)
    black_index = torch.argmax((cum_lo > black_budget).to(torch.int32))
    black_pixels = torch.where(black_index > 0, cum_lo[(black_index - 1).clamp(min=0)], 0)
    black_x = vmin + (black_index.to(torch.float32) + 0.5) * (vmax - vmin) / (num_bins - 1)
    white_budget = int(white_perc * 0.01 * n)
    cum_hi = torch.flip(torch.cumsum(torch.flip(hist, (0,)), 0), (0,))
    white_index = num_bins - 1 - torch.argmax(torch.flip(cum_hi > white_budget, (0,)).to(
        torch.int32))
    white_pixels = torch.where(white_index < num_bins - 1,
                               cum_hi[(white_index + 1).clamp(max=num_bins - 1)], 0)
    white_x = vmin + (white_index.to(torch.float32) + 0.5) * (vmax - vmin) / (num_bins - 1)
    out = ((data - black_x) / (white_x - black_x)).clamp(0.0, 1.0)
    return out, black_x, white_x, black_pixels / n, white_pixels / n


def match_location(data: torch.Tensor, location: float, ref_location: float) -> torch.Tensor:
    """Multiply so the histogram peak matches the reference (pixelops.go:588-597)."""
    return data * (_f32(ref_location, data) / _f32(location, data))


def match_histogram(data: torch.Tensor, location: float, scale: float,
                    ref_location: float, ref_scale: float) -> torch.Tensor:
    """Linear map matching location and scale of a reference
    (pixelops.go:601-611); the offset and x*multiplier + offset each one
    fused multiply-add, as XLA contracts the JAX package's jitted program."""
    multiplier = _f32(ref_scale, data) / _f32(scale, data)
    offset = fma32(-_f32(location, data), multiplier, _f32(ref_location, data))
    return fma32(data, multiplier, offset)


def quantize_for_export(data: torch.Tensor, vmin: float, vmax: float, gamma: float,
                        levels: float) -> torch.Tensor:
    """clip((v-min)/(max-min), 0, 1) [** (1/gamma)] * levels, truncated to
    uint8 (levels <= 255) or to int32 holding uint16 values
    (writejpg.go:43-133, tiff16.go:45-91), on the data's device."""
    scale = 1.0 / (_f32(vmax, data) - _f32(vmin, data))
    d = (data - _f32(vmin, data)) * scale
    d = torch.nan_to_num(d, nan=0.0)
    d = d.clamp(0.0, 1.0)
    if gamma != 1.0:
        d = d ** (1.0 / gamma)
    out = d * levels
    return out.to(torch.uint8 if levels <= 255.0 else torch.int32)
