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

A row-sharded frame (parallel/mesh.py RowSharded) is detected on its shards
(find_stars_sharded): phases 1-2 and K4 on each shard's block with a halo,
the candidate lists merged on the lead, which finishes phases 3-6.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from nightlight_tpu_torch import trace
from nightlight_tpu_torch.ops.gather_cuda import gather_patches, patches_plain
from nightlight_tpu_torch.ops.prestack import bad_pixel_stats, median9

MAX_CANDIDATES = 2048

_SELECT_TILE = 16384  # flat elements per tile
_SELECT_KT = 32       # per-tile candidate capacity of the tiled branch
_SELECT_MIN_N = 1 << 22  # below ~4M pixels the flat selection is used


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


def _patches(img, cys, cxs, radius: int):
    """Index-clamped window gather on any device: the 3x3 neighbourhood of
    the bad-pixel test reads clamped edge pixels unmasked, as the JAX
    package's XLA `_patches` does there. It is also K4's plain version; K4
    itself serves only the masked centre-of-mass window."""
    return patches_plain(img, cys, cxs, radius)


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
        v = val * (wy[:, :, None] & wx[:, None, :])
        m = v.sum(dim=(1, 2))
        m = torch.where(m == 0.0, torch.full((), 1e-8, device=dev), m)
        dx = (v * (offs[None, None, :] - oxf[:, None, None])).sum(dim=(1, 2)) / m
        dy = (v * (offs[None, :, None] - oyf[:, None, None])).sum(dim=(1, 2)) / m
        new_x = cx0.to(torch.float32) + oxf + dx
        new_y = cy0.to(torch.float32) + oyf + dy
        s2 = (new_x - px) ** 2 + (new_y - py) ** 2
        new_oy = (oy + torch.round(dy).to(torch.int64)).clamp(-big + radius, big - radius)
        new_ox = (ox + torch.round(dx).to(torch.int64)).clamp(-big + radius, big - radius)
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
    dist2_limit = float(np.ceil(np.float32((radius + 1e-8) * (radius + 1e-8))))
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
    its 9-neighbourhood median (all pass when bp_sig <= 0)."""
    p9, _ = _patches(img, cy, cx, 1)
    med = median9([p9[:, j // 3, j % 3] for j in range(9)])
    diff = values - med
    return (bp_sig <= 0.0) | (diff.abs() < bp_threshold)


def _finish(location, scale, star_sig, star_in_out, radius: int, cand, cy_k, cx_k, vals_k,
            patch_k, ok_k):
    """Phases 3-6 and the compaction for the phase-2 survivors, in
    candidate order: `cand` their candidate indices (float32), (cy_k, cx_k)
    their int32 centres in the frame, `vals_k` their values, (patch_k,
    ok_k) their K4 windows of radius 2r. Returns a StarList and the
    average HFR."""
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


def _find_stars_one(img, location, scale, star_sig, bp_sig, star_in_out, radius: int,
                    median_diff_std, values, flat_idx):
    """Phases 2-6 for one frame from its selected candidates. Returns a
    StarList and the average HFR."""
    dev = img.device
    h, w = img.shape
    f32 = lambda v: _f32(v, dev)  # noqa: E731
    location, scale = f32(location), f32(scale)
    star_sig, bp_sig, star_in_out = f32(star_sig), f32(bp_sig), f32(star_in_out)
    valid = values > -float("inf")
    cy = torch.div(flat_idx, w, rounding_mode="floor").to(torch.int32)
    cx = (flat_idx % w).to(torch.int32)

    # phase 2: bad-pixel rejection against the 9-neighbourhood median
    valid &= _bad_pixel_ok(img, cy, cx, values, bp_sig, f32(median_diff_std) * bp_sig)

    # phase 4's patch: K4 over the full candidate capacity
    patch, ok = gather_patches(img, cy, cx, 2 * radius)

    # phases 3-6 on the phase-2 survivors only (module docstring)
    with trace.host_read(valid.device):
        keep = torch.nonzero(valid)[:, 0]
    trace.count("detect.candidates", n=int(keep.shape[0]))
    return _finish(location, scale, star_sig, star_in_out, radius, keep.to(torch.float32),
                   cy[keep], cx[keep], values[keep], patch[keep], ok[keep])


@trace.span("detect")
def find_stars_batch(imgs: torch.Tensor, locations, scales, star_sig: float,
                     bp_sig: float, star_in_out: float, radius: int, median_diff_stds,
                     max_candidates: int = MAX_CANDIDATES):
    """Detection for a (B, H, W) chunk of frames with per-frame location,
    scale and median-difference stddev. Returns ([StarList], [avg HFR])."""
    dev = imgs.device
    loc = _f32(locations, dev).reshape(-1)
    sc = _f32(scales, dev).reshape(-1)
    threshold = loc + sc * _f32(star_sig, dev)
    cv = _candidate_values(imgs, threshold)
    vals, idx = _select_brightest(cv, max_candidates)
    del cv
    stars, hfrs = [], []
    for i in range(imgs.shape[0]):
        s, hf = _find_stars_one(imgs[i], loc[i], sc[i], star_sig, bp_sig, star_in_out,
                                radius, _f32(median_diff_stds, dev).reshape(-1)[i],
                                vals[i], idx[i])
        stars.append(s)
        hfrs.append(hf)
    return stars, hfrs


@trace.span("detect")
def find_stars(img: torch.Tensor, location, scale, star_sig: float, bp_sig: float,
               star_in_out: float, radius: int, median_diff_std=None,
               max_candidates: int = MAX_CANDIDATES):
    """Run star detection on one (H, W) image. Returns (StarList, avg_hfr).
    With median_diff_std None and bp_sig > 0, the stddev of the
    image-minus-3x3-median map is computed here."""
    if median_diff_std is None:
        median_diff_std = float(trace.to_host(bad_pixel_stats(img)[1])) if bp_sig > 0 else 0.0
    stars, hfrs = find_stars_batch(img[None], [float(location)], [float(scale)], star_sig,
                                   bp_sig, star_in_out, radius, [float(median_diff_std)],
                                   max_candidates)
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
    and phase-2 verdicts and runs phases 3-6 (_finish) on the survivors in
    candidate order, the same tensors as find_stars builds: the
    per-candidate sums of phases 4 and 6 reduce over as many candidates as
    there, since a reduction's order on a card may depend on that count.

    Host reads: the tile counts of the tiled selection (when a shard is
    large enough to use it), the merged list, and the phase-2 masks, each
    once for all shards. With median_diff_std None and bp_sig > 0, the
    stddev of the image-minus-3x3-median map comes from the shards
    (ops/prestack.py bad_pixel_stats_sharded). A replicated value is
    detected on its one copy."""
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
    star_sig, bp_sig, star_in_out = f32(star_sig), f32(bp_sig), f32(star_in_out)
    threshold = location + scale * star_sig
    bp_threshold = f32(median_diff_std) * bp_sig

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
                              pm._to(bp_sig, dev), pm._to(bp_threshold, dev))
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
    trace.count("detect.candidates", n=len(keep))
    cy_k, cx_k = np.divmod(idx_h[keep], w)
    as_lead = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(lead)  # noqa: E731
    return _finish(location, scale, star_sig, star_in_out, radius,
                   as_lead(keep.astype(np.float32)), as_lead(cy_k.astype(np.int32)),
                   as_lead(cx_k.astype(np.int32)), as_lead(vals_h[keep]), patch_k, ok_k)
