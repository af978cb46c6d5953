"""Automated background extraction (ABE), mirror of
nightlight_tpu/ops/background.py (reference: internal/ops/pre/
background.go): the image is cut into a grid of ~gridSpacing cells; each
cell's level is a star-masked trimmed median (median -> MAD -> clip at
median + sigma*1.4826*MAD -> median again, background.go:464-491); the k
brightest cells may be clipped and repaired from their neighbours
(background.go:175-201); the grid is smoothed with a renormalizing 3x3
gaussian (background.go:203-239); and the model is rendered with the
reference's half-cell-offset piecewise bilinear mapping
(background.go:309-461).

The cell fit runs on the device: every cell padded to the largest cell's
size, gathered in one indexing into a (cells, max_ch * max_cw) block and
sorted along its rows. The star mask is a bool tensor. The grid fixups run
on the host in float32 numpy (the grid is tiny); the render is one device
pass.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_GAUSS3X3_WEIGHTS = np.array([0.468592, 0.107973, 0.024879], np.float32)  # sigma 0.5
BIG = 3.4e38


class Background:
    """Fitted background model (background.go:30-45). `_fitted_cells`: a
    host (cells_y, cells_x) float32 array of already-fitted raw cell
    levels, which skips the device fit (fit_background_batch fits a whole
    batch and reads it back once)."""

    def __init__(self, img: torch.Tensor, grid_spacing: int, sigma: float,
                 back_clip: int, stars, hfr_factor: float,
                 _fitted_cells: np.ndarray | None = None):
        h, w = img.shape
        self.device = img.device
        self.width, self.height = w, h
        self.grid_spacing = int(grid_spacing)
        self.cells_x = int((w + grid_spacing // 2) // grid_spacing)
        self.cells_y = int((h + grid_spacing // 2) // grid_spacing)
        self.spacing_x = w / self.cells_x
        self.spacing_y = h / self.cells_y
        self.outlier_cells = 0

        if _fitted_cells is None:
            star_mask = _star_mask(h, w, stars, hfr_factor)
            _fitted_cells = _fit_cells(img, star_mask, self.cells_x, self.cells_y,
                                       self.spacing_x, self.spacing_y, float(sigma)).cpu().numpy()
        cells = np.asarray(_fitted_cells, np.float32).reshape(self.cells_y, self.cells_x)
        if back_clip > 0:
            cells, self.outlier_cells = _clip_cells(cells, int(back_clip))
        cells = _gauss3x3(cells)
        self.cells = cells
        self.min = float(np.min(cells))
        self.max = float(np.max(cells))

    def __str__(self) -> str:
        """Log format of background.go:47-51."""
        return (f"Background grid {self.grid_spacing} cells {self.cells_x}x{self.cells_y}"
                f" outliers {self.outlier_cells} range [{self.min:f}...{self.max:f}]")

    def render(self) -> torch.Tensor:
        """The background image (background.go:309-383)."""
        return _render(torch.from_numpy(self.cells).to(self.device), self.height, self.width,
                       self.spacing_x, self.spacing_y)

    def subtract(self, img: torch.Tensor) -> torch.Tensor:
        """img - rendered background (background.go:386-461)."""
        return img - self.render()


def _star_mask(h: int, w: int, stars, hfr_factor: float) -> np.ndarray:
    """Host bool mask of the pixels within hfr*factor of a detected star
    (the per-cell star exclusion of background.go:494-515)."""
    mask = np.zeros((h, w), bool)
    for k in range(len(stars) if stars is not None else 0):
        cx, cy = float(stars.x[k]), float(stars.y[k])
        r = float(stars.hfr[k]) * hfr_factor
        ri = int(math.ceil(r))
        if ri <= 0:
            continue
        y0, y1 = max(0, int(cy) - ri), min(h, int(cy) + ri + 1)
        x0, x1 = max(0, int(cx) - ri), min(w, int(cx) + ri + 1)
        if y0 >= y1 or x0 >= x1:
            continue
        yy, xx = np.mgrid[y0:y1, x0:x1]
        mask[y0:y1, x0:x1] |= (xx - cx) ** 2 + (yy - cy) ** 2 <= r * r
    return mask


def _masked_median(sorted_vals: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Median of the first c entries of each sorted row (quickselect
    semantics), an empty row read as one entry."""
    last = sorted_vals.shape[1] - 1
    c1 = c.clamp(min=1)
    up = torch.gather(sorted_vals, 1, (c1 // 2).clamp(0, last)[:, None])[:, 0]
    lo = torch.gather(sorted_vals, 1, (c1 // 2 - 1).clamp(min=0).clamp(0, last)[:, None])[:, 0]
    return torch.where(c1 % 2 == 1, up, 0.5 * (lo + up))


def _fit_cells_device(img: torch.Tensor, star_mask: torch.Tensor, y_slice, x_slice,
                      y_starts, x_starts, y_ends, x_ends, sigma: float,
                      max_ch: int, max_cw: int) -> torch.Tensor:
    """Trimmed median of every cell: (cells,) int64 slice origins, clamped
    so the max_ch x max_cw window stays inside the image, and the cells'
    true bounds, which decide what counts. Returns (cells,) float32."""
    dev = img.device
    big = torch.tensor(BIG, dtype=torch.float32, device=dev)
    yy = y_slice[:, None] + torch.arange(max_ch, device=dev)[None, :]   # (cells, max_ch)
    xx = x_slice[:, None] + torch.arange(max_cw, device=dev)[None, :]   # (cells, max_cw)
    patch = img[yy[:, :, None], xx[:, None, :]]
    smask = star_mask[yy[:, :, None], xx[:, None, :]]
    valid = (((yy >= y_starts[:, None]) & (yy < y_ends[:, None]))[:, :, None]
             & ((xx >= x_starts[:, None]) & (xx < x_ends[:, None]))[:, None, :] & ~smask)
    n_cells = patch.shape[0]
    valid = valid.reshape(n_cells, -1)
    vals = torch.where(valid, patch.reshape(n_cells, -1), big)
    del patch, smask
    cnt = valid.sum(dim=1)
    med = _masked_median(torch.sort(vals, dim=1).values, cnt)
    absdev = torch.where(valid, (vals - med[:, None]).abs(), big)
    mad = _masked_median(torch.sort(absdev, dim=1).values, cnt)
    del absdev
    std = mad * 1.4826
    upper = med + torch.tensor(float(sigma), dtype=torch.float32, device=dev) * std
    keep = valid & (vals < upper[:, None])
    vals2 = torch.where(keep, vals, big)
    return _masked_median(torch.sort(vals2, dim=1).values, keep.sum(dim=1))


def _fit_cells(img: torch.Tensor, star_mask: np.ndarray, cells_x: int, cells_y: int,
               spacing_x: float, spacing_y: float, sigma: float) -> torch.Tensor:
    """The cell fit of one frame from its host star mask. Returns the
    (cells,) device tensor without reading it back."""
    ys, xs, ye, xe = [], [], [], []
    h, w = img.shape
    max_ch = max_cw = 0
    for cy in range(cells_y):
        y_start = int(cy * spacing_y + 0.5)
        y_end = min(int((cy + 1) * spacing_y + 0.5), h)
        for cx in range(cells_x):
            x_start = int(cx * spacing_x + 0.5)
            x_end = min(int((cx + 1) * spacing_x + 0.5), w)
            ys.append(y_start)
            xs.append(x_start)
            ye.append(y_end)
            xe.append(x_end)
            max_ch = max(max_ch, y_end - y_start)
            max_cw = max(max_cw, x_end - x_start)
    ys_np = np.array(ys, np.int64)
    xs_np = np.array(xs, np.int64)
    dev = img.device

    def t(a):
        return torch.from_numpy(np.asarray(a, np.int64)).to(dev)

    return _fit_cells_device(
        img, torch.from_numpy(np.asarray(star_mask, bool)).to(dev),
        t(np.minimum(ys_np, h - max_ch)), t(np.minimum(xs_np, w - max_cw)),
        t(ys_np), t(xs_np), t(ye), t(xe), float(sigma), max_ch, max_cw)


def _clip_cells(cells: np.ndarray, n: int):
    """NaN out the n brightest cells, then repair by iterative neighbour-median
    interpolation with decreasing neighbour requirements (background.go:175-201)."""
    flat = cells.reshape(-1)
    k = len(flat) - n
    threshold = np.sort(flat)[max(k, 0)]  # (len-n+1)-th lowest (1-based)
    out = cells.copy()
    ignored = int((flat >= threshold).sum())
    out[out >= threshold] = np.nan

    h, w = out.shape
    for neighbors in range(8, -1, -1):
        changed = 1
        while changed > 0:
            changed = 0
            for y in range(h):
                for x in range(w):
                    if not np.isnan(out[y, x]):
                        continue
                    vals = []
                    for dy in (-1, 0, 1):
                        for dx in (-1, 0, 1):
                            if dy == 0 and dx == 0:
                                continue
                            y2, x2 = y + dy, x + dx
                            if 0 <= y2 < h and 0 <= x2 < w and not np.isnan(out[y2, x2]):
                                vals.append(out[y2, x2])
                    if len(vals) >= neighbors and len(vals) > 0:
                        out[y, x] = float(np.median(vals))
                        changed += 1
    return out, ignored


def _gauss3x3(cells: np.ndarray) -> np.ndarray:
    """3x3 gaussian (sigma 0.5) with boundary renormalization
    (background.go:209-239)."""
    h, w = cells.shape
    out = np.empty_like(cells)
    for y in range(h):
        for x in range(w):
            acc = 0.0
            wsum = 0.0
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    y2, x2 = y + dy, x + dx
                    if 0 <= y2 < h and 0 <= x2 < w:
                        wgt = _GAUSS3X3_WEIGHTS[dx * dx + dy * dy]
                        acc += cells[y2, x2] * wgt
                        wsum += wgt
            out[y, x] = acc / wsum
    return out


def _axis_mapping(length: int, cells: int, spacing: float):
    """Per-pixel (cell_low, fraction) for the reference's piecewise bilinear
    mapping with half-cell offset (background.go:312-344)."""
    bounds = [int(-0.5 * spacing - 0.5), int(0.5 * spacing + 0.5)]
    s = 0
    while bounds[-1] < length:
        s += 1
        bounds.append(int((s + 0.5) * spacing + 0.5))
    bounds_np = np.array(bounds)
    dest = np.arange(length)
    seg = np.searchsorted(bounds_np, dest, side="right") - 1
    src_l = seg - 1
    dlo = bounds_np[seg]
    dhi = bounds_np[np.minimum(seg + 1, len(bounds_np) - 1)]
    span = 1.0 / np.maximum(dhi - dlo, 1)
    src = src_l + (dest - dlo) * span
    cell_lo = np.clip(src_l, 0, cells - 2)
    frac = (src - cell_lo).astype(np.float32)
    return cell_lo.astype(np.int32), frac


def _render(cells: torch.Tensor, height: int, width: int, spacing_x: float,
            spacing_y: float) -> torch.Tensor:
    """Bilinear render of the (cells_y, cells_x) grid at (height, width)."""
    dev = cells.device
    cy, cx = cells.shape
    ylo, yfrac = _axis_mapping(height, cy, spacing_y)
    xlo, xfrac = _axis_mapping(width, cx, spacing_x)
    ylo = torch.from_numpy(ylo.astype(np.int64)).to(dev)[:, None]
    xlo = torch.from_numpy(xlo.astype(np.int64)).to(dev)[None, :]
    fy = torch.from_numpy(yfrac).to(dev)[:, None]
    fx = torch.from_numpy(xfrac).to(dev)[None, :]
    vyl = cells[ylo, xlo] * (1 - fx) + cells[ylo, xlo + 1] * fx
    vyh = cells[ylo + 1, xlo] * (1 - fx) + cells[ylo + 1, xlo + 1] * fx
    return vyl * (1 - fy) + vyh * fy


def fit_background_batch(datas, stars_list, grid_spacing: int, sigma: float,
                         back_clip: int, hfr_factor: float) -> list:
    """Backgrounds of a frame batch with one read-back: every frame's cells
    fitted on the device, read together, then each frame's grid fixups
    through the normal constructor, so the results equal the per-frame
    OpBackExtract path's. Returns a list of Background objects."""
    fits = []
    for img, stars in zip(datas, stars_list):
        h, w = img.shape
        cells_x = int((w + grid_spacing // 2) // grid_spacing)
        cells_y = int((h + grid_spacing // 2) // grid_spacing)
        mask = _star_mask(h, w, stars, hfr_factor)
        fits.append(_fit_cells(img, mask, cells_x, cells_y, w / cells_x, h / cells_y,
                               float(sigma)))
    packed = torch.cat(fits).cpu().numpy()
    bgs = []
    off = 0
    for img, stars, fit in zip(datas, stars_list, fits):
        n = fit.shape[0]
        bgs.append(Background(img, grid_spacing, sigma, back_clip, stars, hfr_factor,
                              _fitted_cells=packed[off:off + n]))
        off += n
    return bgs
