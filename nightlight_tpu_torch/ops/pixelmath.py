"""Pixel math on the stack path (pixelops.go), mirror of the matching
functions of nightlight_tpu/ops/pixelmath.py. Scalars enter as float32,
as they do inside the JAX package's jitted functions."""

from __future__ import annotations

import torch


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(float(v), dtype=torch.float32, device=like.device)


def scale_offset(data: torch.Tensor, scale: float, offset: float) -> torch.Tensor:
    """x*scale + offset (pixelops.go:123-128)."""
    return data * _f32(scale, data) + _f32(offset, data)


def match_location(data: torch.Tensor, location: float, ref_location: float) -> torch.Tensor:
    """Multiply so the histogram peak matches the reference (pixelops.go:588-597)."""
    return data * (_f32(ref_location, data) / _f32(location, data))


def match_histogram(data: torch.Tensor, location: float, scale: float,
                    ref_location: float, ref_scale: float) -> torch.Tensor:
    """Linear map matching location and scale of a reference (pixelops.go:601-611)."""
    multiplier = _f32(ref_scale, data) / _f32(scale, data)
    offset = _f32(ref_location, data) - _f32(location, data) * multiplier
    return data * multiplier + offset


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
