"""Geometric projection into the reference frame, mirror of
nightlight_tpu/ops/resample.py (reference: internal/fits/project.go:26-76):
bilinear sampling under the inverse transform, out-of-bounds pixels filled
with a given value (NaN marks missing data for stacking).

Two equivalent samplers: the general gather (_warp) and, for the
near-identity transforms alignment produces, the shift-blend warp, which
forms bilinear interpolation as a blend of a few integer-shifted copies of
the image with per-pixel weights; both apply the same px/py, floor and
fraction arithmetic and the same rule that a destination pixel is NaN iff
one of its four bilinear neighbours is not finite. The shift-blend warp
runs through ops/warp_cuda.py warp_shift: kernel K7 on the card, the plain
version _warp_shift on the CPU.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nightlight_tpu_torch import trace
from nightlight_tpu_torch.align import transform as tf
from nightlight_tpu_torch.ops import warp_cuda
from nightlight_tpu_torch.parallel import mesh as pm

_SHIFT_PAD = 256
_SHIFT_COUNTS = (2, 4, 8)


def _source_coords(inv: torch.Tensor, row0: int, rows: int, dest_w: int, device):
    """Bilinear source coordinates of destination rows [row0, row0 + rows):
    the fractions and the integer floors."""
    col = torch.arange(dest_w, dtype=torch.float32, device=device)[None, :]
    row = (row0 + torch.arange(rows, device=device)).to(torch.float32)[:, None]
    px = inv[0] * col + inv[1] * row + inv[2]
    py = inv[3] * col + inv[4] * row + inv[5]
    xl = torch.floor(px)
    yl = torch.floor(py)
    return px - xl, py - yl, xl.to(torch.int64), yl.to(torch.int64)


def _warp(img: torch.Tensor, inv, out_of_bounds: float, dest_h: int, dest_w: int,
          row0: int = 0, rows: int | None = None, src_row0: int = 0,
          src_h: int | None = None) -> torch.Tensor:
    """General bilinear warp by gather, of destination rows [row0, row0 +
    rows) (all by default). `img` holds the source rows from global row
    src_row0 of a src_h-row source (the whole image by default); it must
    hold every row a pixel in bounds reads, else ValueError."""
    h, w = img.shape
    src_h = h if src_h is None else src_h
    rows = dest_h - row0 if rows is None else rows
    inv = trace.upload(np.asarray(inv, np.float32), img.device)
    xr, yr, xl, yl = _source_coords(inv, row0, rows, dest_w, img.device)
    oob = (xl < 0) | (xl + 1 >= w) | (yl < 0) | (yl + 1 >= src_h)
    if h < src_h:
        # a block: the rows its in-bounds pixels read must lie within it
        a, b = trace.to_host(torch.stack([torch.where(oob, src_h, yl).min(),
                                          torch.where(oob, -1, yl + 1).max()])).tolist()
        if a <= b and (a < src_row0 or b >= src_row0 + h):
            raise ValueError(f"_warp: source rows {a}..{b + 1} outside the block "
                             f"{src_row0}..{src_row0 + h}")
    xc = xl.clamp(0, w - 2)
    yc = (yl.clamp(0, src_h - 2) - src_row0).clamp(0, h - 2)
    v00, v01 = img[yc, xc], img[yc, xc + 1]
    v10, v11 = img[yc + 1, xc], img[yc + 1, xc + 1]
    v = (v00 * (1 - xr) + v01 * xr) * (1 - yr) + (v10 * (1 - xr) + v11 * xr) * yr
    return torch.where(oob, trace.upload(float(out_of_bounds), img.device), v)


def _warp_shift(img: torch.Tensor, inv, out_of_bounds: float, kmin: int, mmin: int,
                dest_h: int, dest_w: int, n_kshift: int, n_mshift: int,
                row0: int = 0, rows: int | None = None, src_row0: int = 0,
                src_h: int | None = None) -> torch.Tensor:
    """Gather-free bilinear warp for near-identity transforms (the plain
    version of kernel K7, ops/warp_cuda.py): a blend of
    n_mshift x n_kshift integer-shifted slices of the image, zero-padded
    by _SHIFT_PAD columns and beyond its first and last rows (the plan
    keeps every slice inside that padding). Of destination rows [row0, row0
    + rows) (all by default): `img` holds the source rows from global row
    src_row0 of a src_h-row source (the whole image by default), and must
    hold every in-frame row of [row0 + mmin, row0 + rows + mmin + n_mshift -
    1), the rows the slices read."""
    h, w = img.shape
    src_h = h if src_h is None else src_h
    rows = dest_h - row0 if rows is None else rows
    dev = img.device
    inv = trace.upload(np.asarray(inv, np.float32), dev)
    xr, yr, xl, yl = _source_coords(inv, row0, rows, dest_w, dev)
    oob = (xl < 0) | (xl + 1 >= w) | (yl < 0) | (yl + 1 >= src_h)
    k_idx = xl - torch.arange(dest_w, device=dev)[None, :] - kmin
    m_idx = yl - (row0 + torch.arange(rows, device=dev))[:, None] - mmin

    # the source rows the slices read, zero outside the frame
    lo = row0 + mmin
    n_rows = rows + n_mshift - 1
    a, b = max(lo, 0), min(lo + n_rows, src_h)
    padded = torch.zeros((n_rows, w + 2 * _SHIFT_PAD), dtype=torch.float32, device=dev)
    padded_bad = torch.zeros_like(padded)
    if a < b:
        if a < src_row0 or b > src_row0 + h:
            raise ValueError(f"_warp_shift: source rows {a}..{b} outside the block "
                             f"{src_row0}..{src_row0 + h}")
        src = img[a - src_row0:b - src_row0]
        finite = torch.isfinite(src)
        padded[a - lo:b - lo, _SHIFT_PAD:_SHIFT_PAD + w] = torch.where(finite, src, 0.0)
        padded_bad[a - lo:b - lo, _SHIFT_PAD:_SHIFT_PAD + w] = (~finite).to(torch.float32)
    wp = padded.shape[1]
    zero = torch.zeros((), device=dev)

    out = torch.zeros((rows, dest_w), dtype=torch.float32, device=dev)
    bad = torch.zeros((rows, dest_w), dtype=torch.float32, device=dev)
    for i in range(n_mshift):
        wy = torch.where(m_idx == i, 1.0 - yr, zero) + torch.where(m_idx == i - 1, yr, zero)
        by = ((m_idx == i) | (m_idx == i - 1)).to(torch.float32)
        acc = torch.zeros((rows, dest_w), dtype=torch.float32, device=dev)
        bacc = torch.zeros((rows, dest_w), dtype=torch.float32, device=dev)
        for j in range(n_kshift):
            wx = torch.where(k_idx == j, 1.0 - xr, zero) + torch.where(k_idx == j - 1, xr, zero)
            bx = ((k_idx == j) | (k_idx == j - 1)).to(torch.float32)
            c0 = min(max(kmin + j + _SHIFT_PAD, 0), wp - dest_w)
            acc = acc + wx * padded[i:i + rows, c0:c0 + dest_w]
            bacc = bacc + bx * padded_bad[i:i + rows, c0:c0 + dest_w]
        out = out + wy * acc
        bad = bad + by * bacc
    out = torch.where(bad > 0, trace.upload(float("nan"), dev), out)
    return torch.where(oob, trace.upload(float(out_of_bounds), dev), out)


@trace.span("warp")
def warp_shift_batch(frames: torch.Tensor, invs, oobs, kmins, mmins, flags,
                     n_kshift: int, n_mshift: int) -> torch.Tensor:
    """Shift-blend warp of a (N, H, W) batch IN PLACE, frame by frame: each
    warped frame goes to one frame-sized scratch and is copied back; a frame
    whose flag is False (the alignment reference) keeps its pixels. The
    shift counts are the batch maxima: a frame needing fewer shifts gets
    zero weight on the extra slices. Returns `frames`."""
    _, dest_h, dest_w = frames.shape
    scratch = torch.empty((dest_h, dest_w), dtype=frames.dtype, device=frames.device)
    for i in range(frames.shape[0]):
        if flags[i]:
            frames[i] = warp_cuda.warp_shift(frames[i], invs[i], float(oobs[i]), int(kmins[i]),
                                             int(mmins[i]), dest_h, dest_w, n_kshift, n_mshift,
                                             out=scratch)
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


@trace.span("warp")
def project(img, dest_naxisn, trans: np.ndarray, out_of_bounds: float):
    """Project a (H, W) image into dest dimensions under `trans` (source ->
    dest; sampling uses its inverse) (project.go:26-76). A RowSharded image
    is projected shard by shard (_project_sharded)."""
    inv = tf.invert(trans)
    dest_w, dest_h = int(dest_naxisn[0]), int(dest_naxisn[1])
    plan = _shift_plan(inv, tuple(img.shape), dest_naxisn)
    if isinstance(img, pm.RowSharded):
        return _project_sharded(img, inv, plan, out_of_bounds, dest_h, dest_w)
    if plan is not None:
        kmin, mmin, n_k, n_m = plan
        return warp_cuda.warp_shift(img, inv, out_of_bounds, kmin, mmin, dest_h, dest_w, n_k,
                                    n_m)
    return _warp(img, inv, out_of_bounds, dest_h, dest_w)


def _source_rows(inv, plan, row0: int, rows: int, dest_w: int, src_h: int):
    """The in-frame source rows [a, b) that destination rows [row0, row0 +
    rows) read: the slices' rows under a shift plan; under the gather, the
    floors of py at the four corners widened by a row each side (py is
    rounded in float32, the corners here in float64) and its +1 neighbour."""
    if plan is not None:
        _, mmin, _, n_m = plan
        lo, hi = row0 + mmin, row0 + rows + mmin + n_m - 1
    else:
        ys = [inv[3] * x + inv[4] * y + inv[5]
              for x in (0.0, dest_w - 1.0) for y in (float(row0), row0 + rows - 1.0)]
        lo, hi = math.floor(min(ys)) - 1, math.floor(max(ys)) + 3
    return max(lo, 0), min(hi, src_h)


def _project_sharded(img, inv, plan, out_of_bounds: float, dest_h: int, dest_w: int):
    """project() of a RowSharded image: each shard warps its own destination
    rows on its device, with the same arithmetic as the unsharded warp, so
    the result is the unsharded one bit for bit. The source rows come from
    a halo of the rows the transform reaches (parallel/mesh.py halo) where
    that fits within a shard's height; else the source is gathered and each
    shard reads its rows from it. A destination whose rows do not divide the
    mesh, or a source not sharded like it, is warped whole on the lead and
    placed (replicated)."""
    mesh = img.mesh
    src_h = img.shape[-2]

    def warp(src, row0, rows, src_row0):
        if plan is not None:
            kmin, mmin, n_k, n_m = plan
            return warp_cuda.warp_shift(src, inv, out_of_bounds, kmin, mmin, dest_h, dest_w,
                                        n_k, n_m, row0=row0, rows=rows, src_row0=src_row0,
                                        src_h=src_h)
        return _warp(src, inv, out_of_bounds, dest_h, dest_w, row0=row0, rows=rows,
                     src_row0=src_row0, src_h=src_h)

    if img.replicated or src_h != dest_h or not pm.divides(mesh, (dest_h, dest_w)):
        # the source frame is taken whole on the lead
        src = pm.gather(img, "warp")
        return pm.place_on_mesh(warp(src, 0, dest_h, 0), mesh)
    rows = dest_h // mesh.size
    above = below = 0
    for row0 in img.row0s:
        a, b = _source_rows(inv, plan, row0, rows, dest_w, src_h)
        above = max(above, row0 - a)
        below = max(below, b - (row0 + rows))
    if above <= rows and below <= rows:
        parts = pm.halo(img, above, below)
        blocks = [warp(ext, row0, rows, row0 - top)
                  for (ext, top, _), row0 in zip(parts, img.row0s)]
    else:
        # the displacement reaches beyond a neighbour's rows: every shard
        # reads its rows from the gathered source
        src = pm.gather(img, "warp")
        blocks = [warp(pm._to(src, dev), row0, rows, 0)
                  for dev, row0 in zip(mesh.devices, img.row0s)]
    return pm.RowSharded(mesh, (dest_h, dest_w), blocks)
