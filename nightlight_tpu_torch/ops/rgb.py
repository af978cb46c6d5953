"""RGB channel combination and automatic colour balance (reference:
internal/fits/rgb.go), mirror of nightlight_tpu/ops/rgb.py."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from nightlight_tpu_torch.image import bin_block_mean


@dataclass
class RGB:
    """Float RGB triple (rgb.go:28-38)."""

    r: float = 1.0
    g: float = 1.0
    b: float = 1.0

    def __str__(self) -> str:
        return f"RGB({self.r * 100:.2f}%, {self.g * 100:.2f}%, {self.b * 100:.2f}%)"


def common_normalization_factors(mins: list[float], maxs: list[float]):
    """Common [0, 1] normalization across channels (rgb.go:65-78)."""
    vmin = min(mins)
    vmax = max(maxs)
    return vmin, 1.0 / (vmax - vmin)


def combine_channels(channels: torch.Tensor, vmin: float, mult: float) -> torch.Tensor:
    """Stack 3 mono planes into a (3, H, W) cube with common normalization
    (rgb.go:43-62); vmin and mult enter as float32."""
    f32 = torch.float32
    return ((channels - torch.tensor(vmin, dtype=f32, device=channels.device))
            * torch.tensor(mult, dtype=f32, device=channels.device))


def _darkest_block_grid(h: int, w: int, block: int, border: float):
    x_first = (int(w * border) // block) * block
    x_last = ((w - x_first) // block) * block
    y_first = (int(h * border) // block) * block
    y_last = ((h - y_first) // block) * block
    nby = max((y_last - y_first) // block, 1)
    nbx = max((x_last - x_first) // block, 1)
    return y_first, x_first, nby, nbx


def darkest_block_index(cube: torch.Tensor, block: int, border: float):
    """(means (3, nby*nbx), index of the darkest block): per-block channel
    means over the grid inside the border, the block luminance their mean,
    the first minimal block in row-major order (rgb.go:153-219). The block
    sums run in the order of XLA's CPU reduction (image.bin_block_mean),
    the luminance as ((r + g) + b) times float32(1/3)."""
    _, h, w = cube.shape
    y0, x0, nby, nbx = _darkest_block_grid(h, w, block, border)
    region = cube[:, y0:y0 + nby * block, x0:x0 + nbx * block]
    blocks = bin_block_mean(region, block).reshape(3, -1)
    third = torch.tensor(np.float32(1.0) / np.float32(3.0), device=cube.device)
    lum = ((blocks[0] + blocks[1]) + blocks[2]) * third
    return blocks, torch.argmin(lum)


def find_darkest_block(cube: torch.Tensor, block: int, border: float) -> torch.Tensor:
    """Mean colour of the darkest block x block region inside the border
    (rgb.go:153-219), a (3,) tensor."""
    blocks, idx = darkest_block_index(cube, int(block), float(border))
    return blocks[:, idx]


def mean_star_intensity(cube: np.ndarray, stars, skip_bright: float, skip_dim: float,
                        clip: tuple[float, float, float]) -> tuple[float, float, float]:
    """Mean colour of the star disks (0.75 HFR), skipping the brightest and
    dimmest star fractions and pixels at or above the clip colour
    (rgb.go:223-281), on the host: the tests' cross-check of
    mean_star_intensity_device."""
    if stars is None or len(stars) == 0:
        return (0.0, 0.0, 0.0)
    n = len(stars)
    s_start = int(n * skip_bright)
    s_end = n - int(n * skip_dim)
    if s_start >= s_end:
        return (0.0, 0.0, 0.0)

    _, h, w = cube.shape
    total = np.zeros(3, np.float64)
    total_pixels = 0
    for i in range(s_start, s_end):
        sx, sy = int(float(stars.x[i])), int(float(stars.y[i]))
        hfr = float(stars.hfr[i]) * 0.75
        hfr_r = int(hfr + 0.5)
        hfr_sq = (hfr + 0.01) ** 2
        y0, y1 = max(0, sy - hfr_r), min(h, sy + hfr_r + 1)
        x0, x1 = max(0, sx - hfr_r), min(w, sx + hfr_r + 1)
        if y0 >= y1 or x0 >= x1:
            continue
        yy, xx = np.mgrid[y0:y1, x0:x1]
        disk = (xx - sx) ** 2 + (yy - sy) ** 2 <= hfr_sq
        r, g, b = (cube[ch, y0:y1, x0:x1] for ch in range(3))
        ok = disk & (r < clip[0]) & (g < clip[1]) & (b < clip[2])
        total += (r[ok].sum(), g[ok].sum(), b[ok].sum())
        total_pixels += int(ok.sum())
    if total_pixels == 0:
        return (0.0, 0.0, 0.0)
    return tuple(float(v) / total_pixels for v in total)


def mean_star_intensity_device(cube: torch.Tensor, stars, skip_bright: float, skip_dim: float,
                               clip):
    """The mean star colour on the cube's device (rgb.go:223-281): each
    star's window gathered by kernel K4 (ops/gather_cuda.py) at one radius,
    the smallest power of two >= 4 that covers every star's window, with the
    star count padded to a power of two >= 64 as in the JAX package, so the
    sums run over the same elements. Only pixels inside both the integer
    window [c - hfr_r, c + hfr_r] and the 0.75 HFR disk count, pixels at or
    above the clip colour and outside the frame are masked. `clip` holds
    three float32 values. Returns a (3,) float32 tensor, or None when no
    star is in range (the caller then takes zeros)."""
    from nightlight_tpu_torch.ops.gather_cuda import gather_patches

    if stars is None or len(stars) == 0:
        return None
    n = len(stars)
    s_start = int(n * skip_bright)
    s_end = n - int(n * skip_dim)
    if s_start >= s_end:
        return None
    xs = np.asarray(stars.x)[s_start:s_end]
    ys = np.asarray(stars.y)[s_start:s_end]
    hfr = np.asarray(stars.hfr)[s_start:s_end] * 0.75
    hfr_r = (hfr + 0.5).astype(np.int32)
    hfr_sq = ((hfr + 0.01) ** 2).astype(np.float32)
    rmax = 4
    while rmax < int(hfr_r.max(initial=1)):
        rmax *= 2
    s = len(xs)
    sb = max(64, 1 << (s - 1).bit_length())

    dev = cube.device

    def padded(a, dtype):
        out = np.zeros(sb, dtype)
        out[:s] = a
        return torch.from_numpy(out).to(dev)

    cy = padded(ys.astype(np.int32), np.int32)
    cx = padded(xs.astype(np.int32), np.int32)
    hr = padded(hfr_r, np.int32)
    hsq = padded(hfr_sq, np.float32)
    real = torch.arange(sb, device=dev) < s

    offs = torch.arange(2 * rmax + 1, device=dev, dtype=torch.int32) - rmax
    dy = offs[None, :, None]
    dx = offs[None, None, :]
    window = (dy.abs() <= hr[:, None, None]) & (dx.abs() <= hr[:, None, None])
    disk = (dx.to(torch.float32) ** 2 + dy.to(torch.float32) ** 2) <= hsq[:, None, None]
    keep = window & disk & real[:, None, None]
    chans = []
    for ch in range(3):
        patch, ok = gather_patches(cube[ch], cy, cx, rmax)
        chans.append(patch)
        keep = keep & ok
    for ch in range(3):
        keep = keep & (chans[ch] < torch.as_tensor(clip[ch], dtype=torch.float32, device=dev))
    cnt = keep.sum()
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    sums = torch.stack([torch.where(keep, p.to(torch.float64), zero).sum() for p in chans])
    mean = sums.to(torch.float32) / cnt.clamp(min=1).to(torch.float32)
    return torch.where(cnt > 0, mean, torch.zeros_like(mean))


def black_white_correction(cur_shadows, cur_highlights, target_shadows: RGB,
                           target_highlights: RGB):
    """Per-channel multiplicative/additive correction that keeps the
    brightness and moves the tint (rgb.go:125-148). Returns (alpha (3,),
    beta (3,)) float32 numpy vectors."""
    cs = np.asarray([float(v) for v in cur_shadows], np.float64)
    ch = np.asarray([float(v) for v in cur_highlights], np.float64)
    new_shadow = cs.mean()
    ns = np.array([target_shadows.r, target_shadows.g, target_shadows.b]) * new_shadow
    new_highlight = ch.mean()
    nh = np.array([target_highlights.r, target_highlights.g, target_highlights.b]) * new_highlight
    alpha = (nh - ns) / (ch - cs)
    beta = ns - alpha * cs
    return alpha.astype(np.float32), beta.astype(np.float32)
