"""Star detection with half-flux-radius measurement, mirror of
nightlight_tpu/detect/stars.py (reference: internal/star/findstars.go:59-396).

Phases, on fixed-capacity candidate arrays (MAX_CANDIDATES per frame):

1. 3x3 local maxima above location + scale*starSig, brightest first: the
   tiled per-tile/global selection with its exact flat fallback;
2. bad-pixel rejection against the candidate's 9-neighbourhood median;
3. priority-MIS overlap filter by mass (ties by lower candidate index);
4. centre-of-mass refinement, <= 10 rounds, on one (2*2r+1)^2 patch per
   candidate gathered by kernel K4 (ops/gather_cuda.py);
5. the overlap filter again on refined positions and masses;
6. HFR and the in/out brightness plausibility test;
then the survivors sorted by descending mass.

Phases 3 to 6 only ever read candidates that survived phase 2, so the port
runs them on those candidates alone (kept in candidate order, with their
candidate index for tie-breaks): the results for every surviving candidate
are the ones the fixed-capacity arrays give, at a fraction of the work.
The K4 gather still runs over the full capacity, as in the JAX package.

On a card phases 3 to 6 and the compaction of a frame are one call of
kernel K8 (csrc/detect_finish.cu), which takes the phase-2 mask and writes
the frame's row of a buffer that covers the chunk; the chunk's star lists
come back in one read (_Finish). On the CPU the plain version _finish runs.
find_stars_batch runs phases 1 and 2 on the whole chunk, then K4 and K8
frame by frame; find_stars is a chunk of one.

A row-sharded frame (parallel/mesh.py RowSharded) is detected on its shards
(find_stars_sharded): phases 1-2 and K4 on each shard's block with a halo,
the candidate lists merged on the lead, which finishes phases 3-6 through
the same _Finish.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from nightlight_tpu_torch import kernels, trace
from nightlight_tpu_torch.ops.gather_cuda import gather_patches
from nightlight_tpu_torch.ops.prestack import bad_pixel_stats, median9

MAX_CANDIDATES = 2048

_SELECT_TILE = 16384  # flat elements per tile
_SELECT_KT = 32       # per-tile candidate capacity of the tiled branch
_SELECT_MIN_N = 1 << 22  # below ~4M pixels the flat selection is used

# K8's output row of a frame: count, average HFR, phase-2 survivors, then the
# kept stars' x, y, value, mass, hfr, each `capacity` floats
# (csrc/detect_finish.cuh kHead, kStarFields)
_ROW_HEAD = 3
_STAR_FIELDS = 5


@dataclass
class StarList:
    """Detection result on the host: mass-descending arrays plus count."""

    x: np.ndarray
    y: np.ndarray
    value: np.ndarray
    mass: np.ndarray
    hfr: np.ndarray
    count: int

    def __len__(self) -> int:
        return self.count

    @staticmethod
    def empty() -> "StarList":
        z = np.zeros(0, np.float32)
        return StarList(z, z, z, z, z, 0)


def _f32(v, device) -> torch.Tensor:
    return trace.upload(v, device, torch.float32)


def _host_f32(v) -> torch.Tensor:
    """A 0-d float32 tensor on the CPU: an operand that PyTorch hands a
    kernel on a card by value, with no upload."""
    return torch.tensor(v, dtype=torch.float32)


def _per_frame(device, *columns):
    """Each column of per-frame values as a float32 vector on `device`: a
    tensor already there as it is, the host columns (numbers, arrays, CPU
    tensors) with one upload for all of them."""
    out = list(columns)
    host = [i for i, c in enumerate(columns)
            if not (isinstance(c, torch.Tensor) and c.device == device)]
    for i, c in enumerate(columns):
        if i not in host:
            out[i] = c.to(torch.float32).reshape(-1)
    if host:
        up = trace.upload(np.stack([np.asarray(columns[i], dtype=np.float32).reshape(-1)
                                    for i in host]), device)
        for row, i in enumerate(host):
            out[i] = up[row]
    return out


def _disk_limit(radius: int) -> float:
    """The HFR disk's squared radius (findstars.go:341)."""
    return float(np.ceil(np.float32((radius + 1e-8) * (radius + 1e-8))))


def _overlap_filter(x, y, mass, valid, idx, radius: float):
    """Priority-MIS overlap filter (replaces findstars.go:209-271): a star
    survives iff no surviving star of higher priority (greater mass, ties by
    lower candidate index `idx`) lies within radius; iterated to its fixed
    point, which equals the sequential greedy filter."""
    k = x.shape[0]
    dx = x[:, None] - x[None, :]
    dy = y[:, None] - y[None, :]
    d2 = torch.floor(dx * dx + dy * dy + 0.5)
    conflict = d2 <= radius * radius
    conflict &= ~torch.eye(k, dtype=torch.bool, device=x.device)
    higher = (mass[None, :] > mass[:, None]) | (
        (mass[None, :] == mass[:, None]) & (idx[None, :] < idx[:, None]))
    dominates = conflict & higher & valid[None, :]
    alive = valid
    while True:
        new_alive = valid & ~(dominates & alive[None, :]).any(dim=1)
        if bool(trace.to_host((new_alive == alive).all())):
            return new_alive
        alive = new_alive


def _candidate_values(img: torch.Tensor, threshold) -> torch.Tensor:
    """Flat candidate map: each 3x3 local maximum above threshold keeps its
    value, everything else is -inf (findstars.go:105-129)."""
    h, w = img.shape[-2], img.shape[-1]
    pad = torch.nn.functional.pad(img, (1, 1, 1, 1), value=-float("inf"))
    nb = pad[..., 0:h, 0:w]
    for dy in range(3):
        for dx in range(3):
            if dy or dx:
                nb = torch.maximum(nb, pad[..., dy:dy + h, dx:dx + w])
    thr = torch.as_tensor(threshold, dtype=torch.float32, device=img.device)
    if thr.dim():
        thr = thr.reshape(-1, 1, 1)
    cand = torch.where((img > thr) & (img >= nb), img,
                       torch.full((), -float("inf"), device=img.device))
    return cand.reshape(*img.shape[:-2], -1)


def _topk_stable(v: torch.Tensor, k: int):
    """Top k along the last axis, ties by lower index (lax.top_k order)."""
    vals, idx = torch.sort(v, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _select_flat(v, n: int, k: int):
    vals, idx = _topk_stable(v, k)
    return vals, idx.clamp(max=n - 1)


def _select_tiled(cv, n: int, tiles: int, k: int):
    """Per-tile top _SELECT_KT, then a global top k over the winners."""
    pad = tiles * _SELECT_TILE - n
    v = torch.nn.functional.pad(cv, (0, pad), value=-float("inf")) if pad else cv
    v = v.reshape(*cv.shape[:-1], tiles, _SELECT_TILE)
    tv, ti = _topk_stable(v, _SELECT_KT)
    base = (torch.arange(tiles, device=cv.device) * _SELECT_TILE)[:, None]
    flat_v = tv.reshape(*cv.shape[:-1], -1)
    flat_i = (ti + base).reshape(*cv.shape[:-1], -1)
    vals, sel = _topk_stable(flat_v, k)
    return vals, torch.gather(flat_i, -1, sel).clamp(max=n - 1)


def _most_in_a_tile(cand_vals: torch.Tensor, max_candidates: int):
    """The most candidates in one tile of the tiled selection, over every
    frame of (B, n) or (n,) candidate maps, as a 0-d device tensor; None
    when the map's size takes the flat selection."""
    n = cand_vals.shape[-1]
    tiles = -(-n // _SELECT_TILE)
    if n < _SELECT_MIN_N or tiles * _SELECT_KT < 2 * max_candidates:
        return None
    pad = tiles * _SELECT_TILE - n
    v = (torch.nn.functional.pad(cand_vals, (0, pad), value=-float("inf"))
         if pad else cand_vals)
    return (v.reshape(*cand_vals.shape[:-1], tiles, _SELECT_TILE) > -float("inf")).sum(-1).max()


def _select_brightest(cand_vals: torch.Tensor, max_candidates: int, most=None):
    """Brightest candidates (values, flat indices) of (B, n) candidate maps:
    the tiled selection when no tile of any frame holds more than
    _SELECT_KT candidates, else the flat one -- the same set either way,
    in the same order (values descending, ties by lower flat index).
    `most`, the host value of _most_in_a_tile when the caller has read it
    already (else it is read here)."""
    n = cand_vals.shape[-1]
    k = min(max_candidates, n)
    tiles = -(-n // _SELECT_TILE)
    if most is None:
        t = _most_in_a_tile(cand_vals, max_candidates)
        most = None if t is None else int(trace.to_host(t))
    if most is not None and most <= _SELECT_KT:
        vals, idx = _select_tiled(cand_vals, n, tiles, k)
    else:
        vals, idx = _select_flat(cand_vals, n, k)
    if k < max_candidates:  # tiny images: pad to the fixed capacity
        fill = max_candidates - k
        vals = torch.nn.functional.pad(vals, (0, fill), value=-float("inf"))
        idx = torch.nn.functional.pad(idx, (0, fill), value=n - 1)
    return vals, idx


def _offset_step(o, d, radius: int):
    """o + round(d) clamped to [-radius, radius] in the JAX package's int32
    arithmetic: the rounded shift converted as XLA converts it (a NaN to 0,
    beyond int32 saturated) and the sum wrapping, as int64 tensors."""
    r = torch.nan_to_num(torch.round(d), nan=0.0).clamp(-2.0 ** 31, 2.0 ** 31).to(torch.int64)
    s = o + r.clamp(-2 ** 31, 2 ** 31 - 1)
    return ((s + 2 ** 31) % 2 ** 32 - 2 ** 31).clamp(-radius, radius)


def _center_of_mass(patch, ok, cy0, cx0, threshold, radius: int):
    """Iterative CoM refinement of all candidates at once
    (findstars.go:274-322) inside one (K, 4r+1, 4r+1) patch per candidate,
    drift clamped to +-radius. Returns (x, y, mass, oy, ox, offs)."""
    big = 2 * radius
    size = 2 * big + 1
    dev = patch.device
    zero = torch.zeros((), device=dev)
    val = torch.clamp(torch.where(ok, patch, zero) - threshold, min=0.0)
    val = torch.where(ok, val, zero)
    offs = torch.arange(size, dtype=torch.float32, device=dev) - big
    k = cy0.shape[0]
    oy = torch.zeros(k, dtype=torch.int64, device=dev)
    ox = torch.zeros(k, dtype=torch.int64, device=dev)
    px = cx0.to(torch.float32)
    py = cy0.to(torch.float32)
    mass = torch.zeros(k, dtype=torch.float32, device=dev)
    shift2 = torch.full((k,), 3.4e38, dtype=torch.float32, device=dev)
    for _ in range(10):
        active = shift2 > 1e-4
        oyf = oy.to(torch.float32)
        oxf = ox.to(torch.float32)
        wy = (offs[None, :] - oyf[:, None]).abs() <= radius
        wx = (offs[None, :] - oxf[:, None]).abs() <= radius
        # the window selects, as XLA compiles the JAX package's val * mask: a
        # NaN or infinite pixel outside it adds nothing
        v = torch.where(wy[:, :, None] & wx[:, None, :], val, zero)
        m = v.sum(dim=(1, 2))
        m = torch.where(m == 0.0, torch.full((), 1e-8, device=dev), m)
        dx = (v * (offs[None, None, :] - oxf[:, None, None])).sum(dim=(1, 2)) / m
        dy = (v * (offs[None, :, None] - oyf[:, None, None])).sum(dim=(1, 2)) / m
        new_x = cx0.to(torch.float32) + oxf + dx
        new_y = cy0.to(torch.float32) + oyf + dy
        s2 = (new_x - px) ** 2 + (new_y - py) ** 2
        new_oy = _offset_step(oy, dy, radius)
        new_ox = _offset_step(ox, dx, radius)
        oy = torch.where(active, new_oy, oy)
        ox = torch.where(active, new_ox, ox)
        px = torch.where(active, new_x, px)
        py = torch.where(active, new_y, py)
        mass = torch.where(active, m, mass)
        shift2 = torch.where(active, s2, shift2)
    return px, py, mass, oy, ox, offs


def _hfr(patch, ok, offs, oy, ox, location, radius: int):
    """Half-flux radius and plausibility masses (findstars.go:327-396) on
    the CoM patch about the refined centres."""
    dev = patch.device
    zero = torch.zeros((), device=dev)
    dy = offs[None, :, None] - oy.to(torch.float32)[:, None, None]
    dx = offs[None, None, :] - ox.to(torch.float32)[:, None, None]
    dist2 = dy * dy + dx * dx
    dist2_limit = _disk_limit(radius)
    in_disk = (dist2 <= dist2_limit) & ok
    v0 = torch.clamp(torch.where(ok, patch, zero) - location, min=0.0)
    v = torch.where(in_disk, v0, zero)
    mass = v.sum(dim=(1, 2))
    moment = (v * torch.sqrt(dist2)).sum(dim=(1, 2))
    small = torch.arange(2 * radius + 1, dtype=torch.float32, device=dev) - radius
    sd2 = small[:, None] ** 2 + small[None, :] ** 2
    pixels = (sd2 <= dist2_limit).sum()
    mass_safe = torch.where(mass == 0.0, torch.full((), 1e-8, device=dev), mass)
    hfr = moment / mass_safe
    inner_limit = torch.ceil(hfr * hfr)
    in_inner = (dist2 <= inner_limit[:, None, None]) & ok
    inner_mass = torch.where(in_inner, v0, zero).sum(dim=(1, 2))
    inner_pixels = (sd2[None] <= inner_limit[:, None, None]).sum(dim=(1, 2))
    return hfr, mass_safe, inner_mass, pixels, inner_pixels


def _bad_pixel_ok(img, cy, cx, values, bp_sig, bp_threshold):
    """Phase 2: whether each candidate passes the bad-pixel test against
    its 9-neighbourhood median (all pass when bp_sig <= 0), for the (..., K)
    candidates (cy, cx, values) of (..., H, W) frames; bp_threshold
    broadcasts against them. The neighbourhood reads index-clamped edge
    pixels unmasked, as the JAX package's XLA `_patches` does there."""
    h, w = img.shape[-2], img.shape[-1]
    flat = img.reshape(*img.shape[:-2], h * w)
    cy, cx = cy.to(torch.int64), cx.to(torch.int64)
    taps = [torch.gather(flat, -1, (cy + dy).clamp(0, h - 1) * w + (cx + dx).clamp(0, w - 1))
            for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    diff = values - median9(taps)
    return (bp_sig <= 0.0) | (diff.abs() < bp_threshold)


def _finish(location, scale, star_sig, star_in_out, radius: int, cand, cy_k, cx_k, vals_k,
            patch_k, ok_k):
    """Phases 3-6 and the compaction for the phase-2 survivors, in
    candidate order: `cand` their candidate indices (float32), (cy_k, cx_k)
    their int32 centres in the frame, `vals_k` their values, (patch_k,
    ok_k) their K4 windows of radius 2r. Returns a StarList and the
    average HFR. K8's plain version: _Finish runs it for CPU tensors only."""
    dev = vals_k.device
    x = cx_k.to(torch.float32)
    y = cy_k.to(torch.float32)
    alive = torch.ones(cand.shape[0], dtype=torch.bool, device=dev)
    alive = _overlap_filter(x, y, vals_k, alive, cand, float(radius))
    com_threshold = location + scale * star_sig * 0.5
    x, y, mass, oy, ox, offs = _center_of_mass(patch_k, ok_k, cy_k, cx_k, com_threshold,
                                               radius)
    alive = _overlap_filter(x, y, mass, alive, cand, float(radius))
    hfr, mass2, inner_mass, pixels, inner_pixels = _hfr(
        patch_k, ok_k, offs, oy, ox, location, radius)
    plausible = hfr <= radius
    outer_mass = mass2 - inner_mass
    outer_pixels = pixels - inner_pixels
    plausible &= (inner_mass * outer_pixels.to(torch.float32)
                  > star_in_out * outer_mass * inner_pixels.to(torch.float32))
    alive &= plausible

    sort_key = torch.where(alive, -mass2, torch.full((), float("inf"), device=dev))
    order = torch.argsort(sort_key, stable=True)
    num = int(trace.to_host(alive.sum()))
    avg_hfr = (torch.where(alive, hfr, torch.zeros((), device=dev)).sum()
               / max(num, 1))
    sel = order[:num]
    packed = trace.to_host(torch.stack([x[sel], y[sel], vals_k[sel], mass2[sel], hfr[sel]])).numpy()
    stars = StarList(x=packed[0], y=packed[1], value=packed[2], mass=packed[3],
                     hfr=packed[4], count=num)
    return stars, float(trace.to_host(avg_hfr))


def _finish_cuda(row, capacity: int, location, scale, star_sig: float, star_in_out: float,
                 radius: int, cy, cx, vals, keep, patch, ok):
    """K8 on one frame's K candidates: (cy, cx) int32 centres, `vals`
    float32 values, `keep` their phase-2 mask (bool, or None when all
    survived), (patch, ok) their K4 windows of radius 2r, at most
    MAX_CANDIDATES; location and scale 0-d float32 on the card. Writes the
    frame's row of _ROW_HEAD + _STAR_FIELDS * capacity floats."""
    named = [(patch, "patch", torch.float32), (ok, "ok", torch.bool), (cy, "cy", torch.int32),
             (cx, "cx", torch.int32), (vals, "vals", torch.float32),
             (location, "location", torch.float32), (scale, "scale", torch.float32),
             (row, "row", torch.float32)]
    if keep is not None:
        named.append((keep, "keep", torch.bool))
    for t, name, dtype in named:
        kernels.require_cuda(t, f"detect_finish {name}", dtype)
    k = int(cy.shape[0])
    size = 4 * radius + 1
    if (tuple(patch.shape) != (k, size, size) or ok.shape != patch.shape
            or cx.shape != cy.shape or vals.shape != cy.shape or cy.dim() != 1
            or (keep is not None and keep.shape != cy.shape)
            or location.numel() != 1 or scale.numel() != 1
            or tuple(row.shape) != (_ROW_HEAD + _STAR_FIELDS * capacity,)):
        raise ValueError("detect_finish: shapes do not match the candidates")
    if radius < 0 or k > capacity or k > MAX_CANDIDATES:
        raise ValueError(f"detect_finish: {k} candidates (capacity {capacity}, at most "
                         f"{MAX_CANDIDATES}), radius {radius}")
    res = torch.empty((6, k), dtype=torch.float32, device=row.device)
    err = kernels.library().nl_detect_finish(
        patch.data_ptr(), ok.data_ptr(), cy.data_ptr(), cx.data_ptr(), vals.data_ptr(),
        None if keep is None else keep.data_ptr(), k, int(radius), location.data_ptr(),
        scale.data_ptr(), float(star_sig), float(star_in_out), _disk_limit(radius),
        res.data_ptr(), row.data_ptr(), capacity, *kernels.launch_on(row.device))
    kernels.check(err, "detect_finish")
    kernels.count_launch("detect_finish")


class _Finish:
    """Phases 3-6 of a chunk's frames, one frame at a time (frame), then
    the chunk's star lists and average HFRs (read). On a card each frame is
    one K8 call, which writes the frame's row of one buffer, and read
    fetches every row with one blocking read; the phase-2 survivors a frame
    come from the row too (detect.candidates). On the CPU each frame runs
    the plain version _finish. A CUDA tensor never reaches _finish."""

    def __init__(self, frames: int, capacity: int, device: torch.device):
        self.capacity = capacity
        self.rows = (None if device.type == "cpu" else
                     torch.empty((frames, _ROW_HEAD + _STAR_FIELDS * capacity),
                                 dtype=torch.float32, device=device))
        self.done = []

    def frame(self, i: int, location, scale, star_sig: float, star_in_out: float,
              radius: int, cy, cx, vals, keep, patch, ok):
        """Frame i from its candidates as _finish_cuda takes them."""
        if self.rows is not None:
            _finish_cuda(self.rows[i], self.capacity, location, scale, star_sig, star_in_out,
                         radius, cy, cx, vals, keep, patch, ok)
            return
        at = torch.arange(cy.shape[0]) if keep is None else torch.nonzero(keep)[:, 0]
        trace.count("detect.candidates", n=int(at.shape[0]))
        self.done.append(_finish(location, scale, _host_f32(star_sig), _host_f32(star_in_out),
                                 radius, at.to(torch.float32), cy[at], cx[at], vals[at],
                                 patch[at], ok[at]))

    def read(self):
        """([StarList], [avg HFR]) of the frames in order."""
        if self.rows is None:
            return [st for st, _ in self.done], [hf for _, hf in self.done]
        stars, hfrs = [], []
        for row in trace.to_host(self.rows).numpy():
            num = int(row[0])
            trace.count("detect.candidates", n=int(row[2]))
            fields = row[_ROW_HEAD:].reshape(_STAR_FIELDS, self.capacity)[:, :num]
            stars.append(StarList(*(np.ascontiguousarray(f) for f in fields), count=num))
            hfrs.append(float(row[1]))
        return stars, hfrs


@trace.span("detect")
def find_stars_batch(imgs: torch.Tensor, locations, scales, star_sig: float,
                     bp_sig: float, star_in_out: float, radius: int, median_diff_stds,
                     max_candidates: int = MAX_CANDIDATES):
    """Detection for a (B, H, W) chunk of frames with per-frame location,
    scale and median-difference stddev (host values, uploaded at once, or
    tensors on the chunk's device). Phases 1 and 2 run on the whole chunk,
    K4 and phases 3-6 frame by frame (each frame's patches freed after its
    finish), and the chunk's results come back in one read.
    Returns ([StarList], [avg HFR])."""
    dev = imgs.device
    w = imgs.shape[-1]
    loc, sc, mds = _per_frame(dev, locations, scales, median_diff_stds)
    threshold = loc + sc * _host_f32(star_sig)
    cv = _candidate_values(imgs, threshold)
    vals, idx = _select_brightest(cv, max_candidates)
    del cv
    vals = vals.contiguous()
    cy = torch.div(idx, w, rounding_mode="floor").to(torch.int32)
    cx = (idx % w).to(torch.int32)

    # phase 2: bad-pixel rejection against the 9-neighbourhood median
    keep = (vals > -float("inf")) & _bad_pixel_ok(imgs, cy, cx, vals, bp_sig,
                                                   (mds * _host_f32(bp_sig))[:, None])

    # K4 over the full candidate capacity, phases 3-6 on the survivors
    finish = _Finish(imgs.shape[0], vals.shape[-1], dev)
    for i in range(imgs.shape[0]):
        patch, ok = gather_patches(imgs[i], cy[i], cx[i], 2 * radius)
        finish.frame(i, loc[i], sc[i], star_sig, star_in_out, radius, cy[i], cx[i], vals[i],
                     keep[i], patch, ok)
    return finish.read()


@trace.span("detect")
def find_stars(img: torch.Tensor, location, scale, star_sig: float, bp_sig: float,
               star_in_out: float, radius: int, median_diff_std=None,
               max_candidates: int = MAX_CANDIDATES):
    """Run star detection on one (H, W) image. Returns (StarList, avg_hfr).
    With median_diff_std None and bp_sig > 0, the stddev of the
    image-minus-3x3-median map is computed here (and stays on the card)."""
    if median_diff_std is None and bp_sig > 0:
        mds = bad_pixel_stats(img)[1].reshape(1)
    else:
        mds = [0.0 if median_diff_std is None else float(median_diff_std)]
    stars, hfrs = find_stars_batch(img[None], [float(location)], [float(scale)], star_sig,
                                   bp_sig, star_in_out, radius, mds, max_candidates)
    return stars[0], hfrs[0]


@trace.span("detect")
def find_stars_sharded(x, location, scale, star_sig: float, bp_sig: float,
                       star_in_out: float, radius: int, median_diff_std=None,
                       max_candidates: int = MAX_CANDIDATES):
    """find_stars of a row-sharded (H, W) image (parallel/mesh.py
    RowSharded), with the frame left sharded; the same (StarList, avg_hfr)
    as find_stars on the whole frame, bit for bit.

    Each shard works on its block with a halo of big = 2 x radius rows
    (mesh.halo; none beyond the frame's first and last rows):
    phase 1's candidate map of its own rows (the 3x3 maxima read one halo
    row) and their stable top-k with global flat indices; the lists merged
    on the lead (mesh.merge_top_k) give find_stars' candidate order. A
    candidate belongs to the shard that holds its centre row: that shard
    runs phase 2 on it and K4 on the haloed block with the centre moved by
    the block's first row. A window of radius big about an own row lies in
    the haloed block, and where the block's edge is the frame's, K4's
    in-frame mask and the 3x3 clamp are the whole frame's. A shard without
    candidates launches nothing. The lead receives each shard's patches
    and phase-2 verdicts and runs phases 3-6 (_Finish) on the survivors in
    candidate order. On a card K8's sums of a candidate run in an order
    fixed by the radius alone, and its filters and sort see the same
    survivors in the same order as find_stars' mask gives them, so the
    result is find_stars' bit for bit.

    Host reads: the tile counts of the tiled selection (when a shard is
    large enough to use it), the merged list, and the phase-2 masks, each
    once for all shards, then the finished frame's row. With
    median_diff_std None and bp_sig > 0, the stddev of the
    image-minus-3x3-median map comes from the shards (ops/prestack.py
    bad_pixel_stats_sharded). A replicated value is detected on its one
    copy."""
    from nightlight_tpu_torch.ops.prestack import bad_pixel_stats_sharded
    from nightlight_tpu_torch.parallel import mesh as pm

    if x.replicated:
        return find_stars(x.blocks[0], location, scale, star_sig, bp_sig, star_in_out,
                          radius, median_diff_std, max_candidates)
    if median_diff_std is None:
        median_diff_std = (float(trace.to_host(bad_pixel_stats_sharded(x))) if bp_sig > 0
                           else 0.0)
    lead = x.mesh.lead
    h, w = x.shape
    rows = h // x.mesh.size
    big = 2 * radius
    f32 = lambda v: _f32(v, lead)  # noqa: E731
    location, scale = f32(location), f32(scale)
    sig, bp = f32(star_sig), f32(bp_sig)
    threshold = location + scale * sig
    bp_threshold = f32(median_diff_std) * bp

    # phase 1 on every shard, then one read of the tile counts
    parts = pm.halo(x, big, big)
    cvs = [_candidate_values(ext, pm._to(threshold, ext.device))[top * w:(top + rows) * w]
           for ext, top, _ in parts]
    mosts = [_most_in_a_tile(cv, max_candidates) for cv in cvs]
    counted = [m for m in mosts if m is not None]
    read = iter(trace.to_host(torch.stack([pm._to(m, lead) for m in counted])).tolist()
                if counted else [])
    tops = []
    for k, (cv, most) in enumerate(zip(cvs, mosts)):
        vals, idx = _select_brightest(cv, max_candidates, None if most is None else next(read))
        tops.append((vals, idx + k * rows * w))
    del cvs
    vals, idx = pm.merge_top_k(tops, h * w, max_candidates, lead)
    vals_h, idx_h = trace.to_host(vals).numpy(), trace.to_host(idx).numpy()

    # phase 2 and K4's patches on the shard of each candidate's centre row
    pos = np.nonzero(vals_h > -np.inf)[0]
    cy_h, cx_h = np.divmod(idx_h[pos], w)
    owner = cy_h // rows
    sent = []
    for k, (ext, top, _) in enumerate(parts):
        mine = owner == k
        if not mine.any():
            continue
        dev = ext.device
        cy = torch.from_numpy((cy_h[mine] - (k * rows - top)).astype(np.int32)).to(dev)
        cx = torch.from_numpy(cx_h[mine].astype(np.int32)).to(dev)
        bp_ok = _bad_pixel_ok(ext, cy, cx, torch.from_numpy(vals_h[pos[mine]]).to(dev),
                              pm._to(bp, dev), pm._to(bp_threshold, dev))
        patch, ok = gather_patches(ext, cy, cx, big)
        sent.append((pos[mine], pm._to(patch, lead), pm._to(ok, lead), pm._to(bp_ok, lead)))
    del parts

    # phases 3-6 on the lead, the survivors in candidate order
    size = 2 * big + 1
    if sent:
        sent_pos = np.concatenate([s[0] for s in sent])
        survives = trace.to_host(torch.cat([s[3] for s in sent])).numpy()
        order = np.argsort(sent_pos, kind="stable")
        order = order[survives[order]]
        at = torch.from_numpy(order).to(lead)
        patch_k = torch.cat([s[1] for s in sent])[at]
        ok_k = torch.cat([s[2] for s in sent])[at]
        keep = sent_pos[order]
    else:
        keep = np.zeros(0, np.int64)
        patch_k = torch.zeros((0, size, size), dtype=torch.float32, device=lead)
        ok_k = torch.zeros((0, size, size), dtype=torch.bool, device=lead)
    cy_k, cx_k = np.divmod(idx_h[keep], w)
    as_lead = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(lead)  # noqa: E731
    finish = _Finish(1, len(keep), lead)
    finish.frame(0, location, scale, star_sig, star_in_out, radius,
                 as_lead(cy_k.astype(np.int32)), as_lead(cx_k.astype(np.int32)),
                 as_lead(vals_h[keep]), None, patch_k, ok_k)
    (stars,), (hfr,) = finish.read()
    return stars, hfr
