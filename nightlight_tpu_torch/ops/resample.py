"""Geometric projection into the reference frame, mirror of
nightlight_tpu/ops/resample.py (reference: internal/fits/project.go:26-76):
bilinear sampling under the inverse transform, out-of-bounds pixels filled
with a given value (NaN marks missing data for stacking).

Two equivalent samplers: the general gather (_warp) and, for the
near-identity transforms alignment produces, the shift-blend warp, which
forms bilinear interpolation as a blend of a few integer-shifted copies of
the image with per-pixel weights; both apply the same px/py, floor and
fraction arithmetic and the same rule that a destination pixel is NaN iff
one of its four bilinear neighbours is not finite.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nightlight_tpu_torch.align import transform as tf

_SHIFT_PAD = 256
_SHIFT_COUNTS = (2, 4, 8)


def _source_coords(inv: torch.Tensor, dest_h: int, dest_w: int, device):
    col = torch.arange(dest_w, dtype=torch.float32, device=device)[None, :]
    row = torch.arange(dest_h, dtype=torch.float32, device=device)[:, None]
    px = inv[0] * col + inv[1] * row + inv[2]
    py = inv[3] * col + inv[4] * row + inv[5]
    xl = torch.floor(px)
    yl = torch.floor(py)
    return px - xl, py - yl, xl.to(torch.int64), yl.to(torch.int64)


def _warp(img: torch.Tensor, inv, out_of_bounds: float, dest_h: int, dest_w: int) -> torch.Tensor:
    """General bilinear warp by gather."""
    h, w = img.shape
    inv = torch.as_tensor(np.asarray(inv, np.float32), device=img.device)
    xr, yr, xl, yl = _source_coords(inv, dest_h, dest_w, img.device)
    oob = (xl < 0) | (xl + 1 >= w) | (yl < 0) | (yl + 1 >= h)
    xc = xl.clamp(0, w - 2)
    yc = yl.clamp(0, h - 2)
    v00, v01 = img[yc, xc], img[yc, xc + 1]
    v10, v11 = img[yc + 1, xc], img[yc + 1, xc + 1]
    v = (v00 * (1 - xr) + v01 * xr) * (1 - yr) + (v10 * (1 - xr) + v11 * xr) * yr
    return torch.where(oob, torch.tensor(float(out_of_bounds), device=img.device), v)


def _warp_shift(img: torch.Tensor, inv, out_of_bounds: float, kmin: int, mmin: int,
                dest_h: int, dest_w: int, n_kshift: int, n_mshift: int) -> torch.Tensor:
    """Gather-free bilinear warp for near-identity transforms: a blend of
    n_mshift x n_kshift integer-shifted slices of the padded image. Shift
    starts are clamped into the padded image, as lax.dynamic_slice does."""
    h, w = img.shape
    dev = img.device
    inv = torch.as_tensor(np.asarray(inv, np.float32), device=dev)
    xr, yr, xl, yl = _source_coords(inv, dest_h, dest_w, dev)
    oob = (xl < 0) | (xl + 1 >= w) | (yl < 0) | (yl + 1 >= h)
    k_idx = xl - torch.arange(dest_w, device=dev)[None, :] - kmin
    m_idx = yl - torch.arange(dest_h, device=dev)[:, None] - mmin

    finite = torch.isfinite(img)
    pad = (_SHIFT_PAD,) * 4
    padded = torch.nn.functional.pad(torch.where(finite, img, 0.0), pad)
    padded_bad = torch.nn.functional.pad((~finite).to(torch.float32), pad)
    hp, wp = padded.shape
    zero = torch.zeros((), device=dev)

    out = torch.zeros((dest_h, dest_w), dtype=torch.float32, device=dev)
    bad = torch.zeros((dest_h, dest_w), dtype=torch.float32, device=dev)
    for i in range(n_mshift):
        wy = torch.where(m_idx == i, 1.0 - yr, zero) + torch.where(m_idx == i - 1, yr, zero)
        by = ((m_idx == i) | (m_idx == i - 1)).to(torch.float32)
        r0 = min(max(mmin + i + _SHIFT_PAD, 0), hp - dest_h)
        acc = torch.zeros((dest_h, dest_w), dtype=torch.float32, device=dev)
        bacc = torch.zeros((dest_h, dest_w), dtype=torch.float32, device=dev)
        for j in range(n_kshift):
            wx = torch.where(k_idx == j, 1.0 - xr, zero) + torch.where(k_idx == j - 1, xr, zero)
            bx = ((k_idx == j) | (k_idx == j - 1)).to(torch.float32)
            c0 = min(max(kmin + j + _SHIFT_PAD, 0), wp - dest_w)
            acc = acc + wx * padded[r0:r0 + dest_h, c0:c0 + dest_w]
            bacc = bacc + bx * padded_bad[r0:r0 + dest_h, c0:c0 + dest_w]
        out = out + wy * acc
        bad = bad + by * bacc
    out = torch.where(bad > 0, torch.tensor(float("nan"), device=dev), out)
    return torch.where(oob, torch.tensor(float(out_of_bounds), device=dev), out)


def warp_shift_batch(frames: torch.Tensor, invs, oobs, kmins, mmins, flags,
                     n_kshift: int, n_mshift: int) -> torch.Tensor:
    """Shift-blend warp of a (N, H, W) batch IN PLACE, frame by frame, so
    the temporaries stay one frame in size; a frame whose flag is False (the
    alignment reference) keeps its pixels. The shift counts are the batch
    maxima: a frame needing fewer shifts gets zero weight on the extra
    slices. Returns `frames`."""
    _, dest_h, dest_w = frames.shape
    for i in range(frames.shape[0]):
        if flags[i]:
            frames[i] = _warp_shift(frames[i], invs[i], float(oobs[i]), int(kmins[i]),
                                    int(mmins[i]), dest_h, dest_w, n_kshift, n_mshift)
    return frames


def plan_batch_shift_warp(shapes, dest_naxisn, invs):
    """Per-frame integer shift ranges under a shared (n_k, n_m) bucket, or
    None when a transform needs the general gather warp."""
    kmins, mmins = [], []
    n_k = n_m = 2
    for shape, inv in zip(shapes, invs):
        plan = _shift_plan(np.asarray(inv, np.float64), shape, dest_naxisn)
        if plan is None:
            return None
        kmin, mmin, nk, nm = plan
        kmins.append(kmin)
        mmins.append(mmin)
        n_k = max(n_k, nk)
        n_m = max(n_m, nm)
    return np.asarray(kmins, np.int32), np.asarray(mmins, np.int32), int(n_k), int(n_m)


def _shift_plan(inv: np.ndarray, src_shape, dest_naxisn):
    """(kmin, mmin, n_kshift, n_mshift) for the shift-blend warp, or None
    when the transform needs the general gather (large rotation/scale or
    translation)."""
    dest_w, dest_h = int(dest_naxisn[0]), int(dest_naxisn[1])
    a, b, c, d, e, f = (float(v) for v in inv)
    corners = [(0.0, 0.0), (dest_w - 1.0, 0.0), (0.0, dest_h - 1.0),
               (dest_w - 1.0, dest_h - 1.0)]
    dxs = [a * x + b * y + c - x for (x, y) in corners]
    dys = [d * x + e * y + f - y for (x, y) in corners]
    kmin = math.floor(min(dxs))
    kmax = math.floor(max(dxs))
    mmin = math.floor(min(dys))
    mmax = math.floor(max(dys))
    n_k = kmax - kmin + 2
    n_m = mmax - mmin + 2
    if n_k > _SHIFT_COUNTS[-1] or n_m > _SHIFT_COUNTS[-1]:
        return None
    if max(abs(kmin), abs(kmax + 1), abs(mmin), abs(mmax + 1)) >= _SHIFT_PAD:
        return None
    n_k = next(s for s in _SHIFT_COUNTS if s >= n_k)
    n_m = next(s for s in _SHIFT_COUNTS if s >= n_m)
    h, w = int(src_shape[0]), int(src_shape[1])
    if mmin + _SHIFT_PAD < 0 or kmin + _SHIFT_PAD < 0:
        return None
    if mmin + n_m + _SHIFT_PAD + dest_h > h + 2 * _SHIFT_PAD:
        return None
    if kmin + n_k + _SHIFT_PAD + dest_w > w + 2 * _SHIFT_PAD:
        return None
    return kmin, mmin, n_k, n_m


def project(img: torch.Tensor, dest_naxisn, trans: np.ndarray, out_of_bounds: float) -> torch.Tensor:
    """Project a (H, W) image into dest dimensions under `trans` (source ->
    dest; sampling uses its inverse) (project.go:26-76)."""
    inv = tf.invert(trans)
    dest_w, dest_h = int(dest_naxisn[0]), int(dest_naxisn[1])
    plan = _shift_plan(inv, img.shape, dest_naxisn)
    if plan is not None:
        kmin, mmin, n_k, n_m = plan
        return _warp_shift(img, inv, out_of_bounds, kmin, mmin, dest_h, dest_w, n_k, n_m)
    return _warp(img, inv, out_of_bounds, dest_h, dest_w)
