"""Star detection and triangle alignment of the plain reference: the
semantics of nightlight's findstars.go and align.go as the program's plain
versions compute them, copied here so that the reference picks the same
stars, the same reference light (the best stars-over-HFR score) and the
same transforms from the same pixels, whatever later changes make to the
program. Nothing here imports the program.

Detection (find_stars): 3x3 local maxima above location + starSig scales,
the brightest first (at most MAX_CANDIDATES); a bad-pixel test against the
9-neighbourhood median; an overlap filter by mass; centre-of-mass
refinement on a window of twice the radius; the overlap filter again; the
half-flux radius and the in/out brightness test; the survivors by
descending mass. Alignment (align): the K brightest mutually distant stars'
canonical triangles matched in side-length space, the affine transform of
each candidate triple, stars matched within 8 px, and a least-squares
refine; the candidate with the smallest residual wins.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from benchmark_torch.reference import median9

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
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _patches(img, cys, cxs, radius: int):
    """(K, 2r+1, 2r+1) windows about the centres, indices clamped into the
    frame, and the mask of their in-frame elements."""
    h, w = img.shape
    size = 2 * radius + 1
    offs = torch.arange(size, device=cys.device, dtype=torch.int64)
    yy = cys.to(torch.int64)[:, None, None] + offs[None, :, None] - radius
    xx = cxs.to(torch.int64)[:, None, None] + offs[None, None, :] - radius
    ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
    return img[yy.clamp(0, h - 1), xx.clamp(0, w - 1)], ok


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
        if bool((new_alive == alive).all()):
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
        most = None if t is None else int(t)
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
    num = int(alive.sum())
    avg_hfr = (torch.where(alive, hfr, torch.zeros((), device=dev)).sum()
               / max(num, 1))
    sel = order[:num]
    packed = torch.stack([x[sel], y[sel], vals_k[sel], mass2[sel], hfr[sel]]).cpu().numpy()
    stars = StarList(x=packed[0], y=packed[1], value=packed[2], mass=packed[3],
                     hfr=packed[4], count=num)
    return stars, float(avg_hfr)


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
    patch, ok = _patches(img, cy, cx, 2 * radius)

    # phases 3-6 on the phase-2 survivors only (module docstring)
    keep = torch.nonzero(valid)[:, 0]
    return _finish(location, scale, star_sig, star_in_out, radius, keep.to(torch.float32),
                   cy[keep], cx[keep], values[keep], patch[keep], ok[keep])


def find_stars(img: torch.Tensor, location, scale, star_sig: float, bp_sig: float,
               star_in_out: float, radius: int, median_diff_std):
    """Detection on one (H, W) image. Returns (StarList, average HFR)."""
    dev = img.device
    threshold = _f32(location, dev) + _f32(scale, dev) * _f32(star_sig, dev)
    cv = _candidate_values(img[None], threshold.reshape(1))
    vals, idx = _select_brightest(cv, MAX_CANDIDATES)
    return _find_stars_one(img, location, scale, star_sig, bp_sig, star_in_out, radius,
                           median_diff_std, vals[0], idx[0])


def select_stars_over_hfr(detections) -> int:
    """The index of the best number-of-stars over HFR score, the first on
    a tie (refframe.go:212-227)."""
    best, score = None, -1.0
    for i, (stars, hfr) in enumerate(detections):
        s = len(stars) / hfr if len(stars) > 0 and hfr != 0 else 0.0
        if s > score:
            best, score = i, s
    return best


MIN_DISTANCE_FRACTION = 1.0 / 20.0
DIST_SQ_LIMIT = 8.0 * 8.0


def pick_brightest_distant(xs: np.ndarray, ys: np.ndarray, min_length: float,
                           k: int) -> np.ndarray:
    """Greedy selection of up to k stars in brightness order, skipping stars
    closer than min_length to an already picked one (align.go:86-104), in
    float32 difference form."""
    n = len(xs)
    avail = np.ones(n, bool)
    picked: list[int] = []
    ml2 = np.float32(min_length) * np.float32(min_length)
    xs32 = xs.astype(np.float32)
    ys32 = ys.astype(np.float32)
    while len(picked) < k:
        idxs = np.nonzero(avail)[0]
        if len(idxs) == 0:
            break
        s = int(idxs[0])
        picked.append(s)
        d2 = (xs32 - xs32[s]) ** 2 + (ys32 - ys32[s]) ** 2
        avail &= d2 >= ml2
    return np.array(picked, np.int32)


def generate_triangles(xs: np.ndarray, ys: np.ndarray, indices: np.ndarray,
                       scale_factor: float = 1.0):
    """All canonical triangles (dAB < dAC < dBC) over the given star
    indices (align.go:108-130). Returns (sides (T,3) f32, vertices (T,3) i32)."""
    if len(indices) < 3:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    pts = np.stack([xs[indices] * scale_factor, ys[indices] * scale_factor], axis=-1)
    combos = np.array(list(itertools.combinations(range(len(indices)), 3)), np.int32)
    i, j, k = combos[:, 0], combos[:, 1], combos[:, 2]

    def dist(a, b):
        d = pts[a] - pts[b]
        return np.sqrt((d * d).sum(-1)).astype(np.float32)

    sides = np.stack([dist(i, j), dist(i, k), dist(j, k)], axis=-1)
    order = np.argsort(sides, axis=-1, kind="stable")
    s_sorted = np.take_along_axis(sides, order, axis=-1)
    valid = (s_sorted[:, 0] < s_sorted[:, 1]) & (s_sorted[:, 1] < s_sorted[:, 2])
    ends = np.stack([np.stack([i, j], -1), np.stack([i, k], -1), np.stack([j, k], -1)], axis=1)
    shortest = np.take_along_axis(ends, order[:, 0:1, None], axis=1)[:, 0]
    middle = np.take_along_axis(ends, order[:, 1:2, None], axis=1)[:, 0]
    a_is_first = (shortest[:, 0:1] == middle).any(axis=1)
    A = np.where(a_is_first, shortest[:, 0], shortest[:, 1])
    B = np.where(a_is_first, shortest[:, 1], shortest[:, 0])
    C = np.where(middle[:, 0] == A, middle[:, 1], middle[:, 0])
    tris = np.stack([indices[A], indices[B], indices[C]], axis=-1)[valid]
    return s_sorted[valid].astype(np.float32), tris.astype(np.int32)


@lru_cache(maxsize=8)
def _combos_for(k: int) -> np.ndarray:
    """(C(k,3), 3) triple-index table over the k pick slots (read-only)."""
    c = np.array(list(itertools.combinations(range(k), 3)), np.int32).reshape(-1, 3)
    c.setflags(write=False)
    return c


def _pick_frame(xs: np.ndarray, ys: np.ndarray, ml2: np.float32, k: int) -> np.ndarray:
    """The whole-batch path's pick (aligner.py _pick_device): k slots,
    -1 once the stars are exhausted."""
    n = len(xs)
    avail = np.ones(n, bool)
    idxs = np.arange(n)
    picked = np.full(k, -1, np.int32)
    xs32, ys32 = xs.astype(np.float32), ys.astype(np.float32)
    for i in range(k):
        if not avail.any():
            break
        s = int(np.argmax(avail))
        d2 = (xs32 - xs32[s]) ** 2 + (ys32 - ys32[s]) ** 2
        avail = avail & (d2 >= ml2) & (idxs != s)
        picked[i] = s
    return picked


def _tris_frame(xs, ys, picked: np.ndarray, combos: np.ndarray, scale: float, device):
    """Canonical triangles over the pick slots (aligner.py _tris_device):
    invalid slots and tied sides keep their row with 1e30 sides and zero
    vertices. Sides are scaled by `scale`, vertices are not."""
    pk_ok = torch.as_tensor(picked >= 0, device=device)
    sel = torch.as_tensor(np.where(picked >= 0, picked, 0), dtype=torch.int64, device=device)
    xs_t = torch.as_tensor(xs, dtype=torch.float32, device=device)
    ys_t = torch.as_tensor(ys, dtype=torch.float32, device=device)
    zero = torch.zeros((), device=device)
    px = torch.where(pk_ok, xs_t[sel], zero)
    py = torch.where(pk_ok, ys_t[sel], zero)
    sc = torch.tensor(float(scale), dtype=torch.float32, device=device)
    sx, sy = px * sc, py * sc
    cb = torch.tensor(combos, dtype=torch.int64, device=device)
    i, j, k3 = cb[:, 0], cb[:, 1], cb[:, 2]

    def dist(a, b):
        dx = sx[a] - sx[b]
        dy = sy[a] - sy[b]
        return torch.sqrt(dx * dx + dy * dy)

    sides = torch.stack([dist(i, j), dist(i, k3), dist(j, k3)], dim=-1)
    order = torch.argsort(sides, dim=-1, stable=True)
    s_sorted = torch.gather(sides, -1, order)
    tri_ok = (pk_ok[i] & pk_ok[j] & pk_ok[k3]
              & (s_sorted[:, 0] < s_sorted[:, 1]) & (s_sorted[:, 1] < s_sorted[:, 2]))
    ends = torch.stack([torch.stack([i, j], -1), torch.stack([i, k3], -1),
                        torch.stack([j, k3], -1)], dim=1)
    t = cb.shape[0]
    shortest = torch.gather(ends, 1, order[:, 0:1, None].expand(t, 1, 2))[:, 0]
    middle = torch.gather(ends, 1, order[:, 1:2, None].expand(t, 1, 2))[:, 0]
    a_first = (shortest[:, 0:1] == middle).any(dim=1)
    A = torch.where(a_first, shortest[:, 0], shortest[:, 1])
    B = torch.where(a_first, shortest[:, 1], shortest[:, 0])
    C = torch.where(middle[:, 0] == A, middle[:, 1], middle[:, 0])
    tri_pts = torch.stack([torch.stack([px[A], py[A]], -1), torch.stack([px[B], py[B]], -1),
                           torch.stack([px[C], py[C]], -1)], dim=1)
    tri_sides = torch.where(tri_ok[:, None], s_sorted, torch.full((), 1.0e30, device=device))
    tri_pts = torch.where(tri_ok[:, None, None], tri_pts, zero)
    return tri_sides, tri_pts


def _from_three_points(cp, cr):
    """Affine transforms mapping frame triples cp (k,3,2) onto reference
    triples cr (k,3,2), as a centred 3x3 cofactor solve (coord.go:118-137).
    Returns (k, 6); NaN/Inf for collinear triples."""
    c0 = cp.mean(dim=1)
    r0 = cr.mean(dim=1)
    P = cp - c0[:, None, :]
    Q = cr - r0[:, None, :]
    x1, y1 = P[:, 0, 0], P[:, 0, 1]
    x2, y2 = P[:, 1, 0], P[:, 1, 1]
    x3, y3 = P[:, 2, 0], P[:, 2, 1]
    det = x1 * (y2 - y3) - y1 * (x2 - x3) + (x2 * y3 - x3 * y2)
    c11, c12, c13 = y2 - y3, y3 - y1, y1 - y2
    c21, c22, c23 = x3 - x2, x1 - x3, x2 - x1
    c31, c32, c33 = x2 * y3 - x3 * y2, x3 * y1 - x1 * y3, x1 * y2 - x2 * y1

    def solve(rhs):
        a = (c11 * rhs[:, 0] + c12 * rhs[:, 1] + c13 * rhs[:, 2]) / det
        b = (c21 * rhs[:, 0] + c22 * rhs[:, 1] + c23 * rhs[:, 2]) / det
        t = (c31 * rhs[:, 0] + c32 * rhs[:, 1] + c33 * rhs[:, 2]) / det
        return a, b, t

    a, b, t1 = solve(Q[:, :, 0])
    d, e, t2 = solve(Q[:, :, 1])
    c = t1 + r0[:, 0] - a * c0[:, 0] - b * c0[:, 1]
    f = t2 + r0[:, 1] - d * c0[:, 0] - e * c0[:, 1]
    return torch.stack([a, b, c, d, e, f], dim=-1)


def _search(tri_sides, tri_pts, ref_sides, ref_tri_pts, pts, ref_pts, n_stars: float, k: int):
    """The candidate search of one frame (aligner.py _search_one), all k
    candidates evaluated at once. Returns (trans (6,), residual) tensors."""
    dev = pts.device
    n_ref = ref_pts.shape[0]
    d2t = ((tri_sides[:, None, :] - ref_sides[None, :, :]) ** 2).sum(-1)
    nn_idx = torch.argmin(d2t, dim=1)  # first minimum, like jnp.argmin
    nn_d2 = torch.gather(d2t, 1, nn_idx[:, None])[:, 0]
    order = torch.sort(nn_d2, stable=True).indices[:k]
    cand_pts = tri_pts[order]
    cand_ref = ref_tri_pts[nn_idx[order]]
    if cand_pts.shape[0] < k:  # fewer triangles than candidates: degenerate fill
        fill = k - cand_pts.shape[0]
        cand_pts = torch.cat([cand_pts, torch.zeros((fill, 3, 2), device=dev)])
        cand_ref = torch.cat([cand_ref, torch.zeros((fill, 3, 2), device=dev)])
    min_distinct = min(4, n_ref)

    t0 = _from_three_points(cand_pts, cand_ref)  # (k, 6)
    X, Y = pts[:, 0], pts[:, 1]
    px = t0[:, 0:1] * X + t0[:, 1:2] * Y + t0[:, 2:3]
    py = t0[:, 3:4] * X + t0[:, 4:5] * Y + t0[:, 5:6]
    d2 = ((px[:, :, None] - ref_pts[None, None, :, 0]) ** 2
          + (py[:, :, None] - ref_pts[None, None, :, 1]) ** 2)  # (k, S, S2)
    ridx = torch.argmin(d2, dim=2)
    rmin = torch.gather(d2, 2, ridx[:, :, None])[:, :, 0]
    m = rmin < DIST_SQ_LIMIT
    cnt = m.sum(dim=1)
    cntf = cnt.clamp(min=1).to(torch.float32)

    sentinel = 1 << 30
    s = torch.sort(torch.where(m, ridx, sentinel), dim=1).values
    distinct = (((s[:, 1:] != s[:, :-1]) & (s[:, 1:] < sentinel)).sum(dim=1)
                + (s[:, 0] < sentinel).to(torch.int64))

    mf = m.to(torch.float32)
    q = ref_pts[ridx]  # (k, S, 2)
    zero = torch.zeros((), device=dev)
    mpx = (mf * X).sum(1) / cntf
    mpy = (mf * Y).sum(1) / cntf
    mqx = (mf * q[:, :, 0]).sum(1) / cntf
    mqy = (mf * q[:, :, 1]).sum(1) / cntf
    Px = torch.where(m, X - mpx[:, None], zero)
    Py = torch.where(m, Y - mpy[:, None], zero)
    Qx = torch.where(m, q[:, :, 0] - mqx[:, None], zero)
    Qy = torch.where(m, q[:, :, 1] - mqy[:, None], zero)
    sxx = (Px * Px).sum(1)
    sxy = (Px * Py).sum(1)
    syy = (Py * Py).sum(1)
    det = sxx * syy - sxy * sxy
    det_ok = det.abs() > 1e-6
    det_safe = torch.where(det_ok, det, torch.ones((), device=dev))

    def row(bx, by):
        return (syy * bx - sxy * by) / det_safe, (sxx * by - sxy * bx) / det_safe

    a, b = row((Px * Qx).sum(1), (Py * Qx).sum(1))
    d_, e = row((Px * Qy).sum(1), (Py * Qy).sum(1))
    c = mqx - a * mpx - b * mpy
    f = mqy - d_ * mpx - e * mpy
    refined = torch.stack([a, b, c, d_, e, f], dim=-1)
    rx = a[:, None] * X + b[:, None] * Y + c[:, None] - q[:, :, 0]
    ry = d_[:, None] * X + e[:, None] * Y + f[:, None] - q[:, :, 1]
    rr = torch.where(m, rx * rx + ry * ry, zero)
    residual = torch.sqrt(rr.sum(1)) / cntf
    n_third = torch.tensor(n_stars, dtype=torch.float32, device=dev) / 3.0
    valid = ((cnt.to(torch.float32) >= n_third) & (distinct >= min_distinct) & det_ok
             & torch.isfinite(t0).all(dim=1))
    res_all = torch.where(valid, residual, torch.full((), float("inf"), device=dev))
    best = torch.argmin(res_all)
    return refined[best], res_all[best]


def align(ref_stars, stars, naxisn, ref_naxisn, k: int, device):
    """(transform float32 (6,), residual) mapping a light's coordinates to
    the reference light's, from their star lists: the reference's
    triangles picked on the host, the light's over the k pick slots (the
    whole-batch path that the program's align operator takes for every
    light with 3 stars or more); None for a light with fewer, or a
    reference without triangles."""
    n = stars.count
    if n < 3:
        return None
    min_length = float(ref_naxisn[1]) * MIN_DISTANCE_FRACTION
    ref_pts = np.stack([ref_stars.x, ref_stars.y], axis=-1).astype(np.float32)
    ref_idx = pick_brightest_distant(ref_stars.x, ref_stars.y, min_length, k)
    ref_sides, ref_tris = generate_triangles(ref_stars.x, ref_stars.y, ref_idx, 1.0)
    if len(ref_tris) == 0:
        return None
    xs, ys = stars.x[:n], stars.y[:n]
    picked = _pick_frame(xs, ys, np.float32(min_length * min_length), k)
    scale = np.float32(float(ref_naxisn[0]) / float(naxisn[0]))
    tri_sides, tri_pts = _tris_frame(xs, ys, picked, _combos_for(k), scale, device)
    pts = torch.as_tensor(np.stack([xs, ys], axis=-1).astype(np.float32), device=device)

    def t(a):
        return torch.as_tensor(a, device=device)

    trans, res = _search(tri_sides, tri_pts, t(ref_sides), t(ref_pts[ref_tris]), pts,
                         t(ref_pts), float(n), k)
    return trans.cpu().numpy().astype(np.float32), float(res)
