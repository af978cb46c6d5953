"""Triangle-based star alignment, mirror of nightlight_tpu/align/aligner.py
(reference: internal/star/align.go).

* pick the K brightest mutually distant stars (align.go:86-104);
* the canonical triangle of every star triple, dAB < dAC < dBC
  (align.go:108-130);
* per frame, one batched search on the device: the nearest reference
  triangle of every frame triangle in side-length space, the k closest
  matches as candidates, the affine transform of each candidate's star
  triple, all stars projected and matched to reference stars within 8 px,
  the >= 1/3-matched validity rule, and a closed-form least-squares refine
  of the 6 affine parameters on the matched pairs; the candidate with the
  smallest residual sqrt(sum distSq)/matched wins (align.go:193-244).

All distances are in difference form, never |a|^2+|b|^2-2ab, and the
least-squares sums are taken about the matched centroid.
"""

from __future__ import annotations

import itertools
from functools import lru_cache

import numpy as np
import torch

MIN_DISTANCE_FRACTION = 1.0 / 20.0
DIST_SQ_LIMIT = 8.0 * 8.0


def pick_brightest_distant(xs: np.ndarray, ys: np.ndarray, min_length: float, k: int) -> np.ndarray:
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


class Aligner:
    """Star aligner against a fixed reference frame (align.go:28-71);
    reference arrays are prepared once on `device`."""

    def __init__(self, naxisn, ref_stars, k: int, device="cpu"):
        self.naxisn = list(naxisn)
        self.ref_stars = ref_stars
        self.k = int(k)
        self.device = torch.device(device)
        self.ref_pts = np.stack([ref_stars.x, ref_stars.y], axis=-1).astype(np.float32)
        min_length = float(naxisn[1]) * MIN_DISTANCE_FRACTION
        idx = pick_brightest_distant(ref_stars.x, ref_stars.y, min_length, self.k)
        self.ref_tri_sides, self.ref_tris = generate_triangles(ref_stars.x, ref_stars.y, idx, 1.0)
        ref_tri_pts = (self.ref_pts[self.ref_tris] if len(self.ref_tris)
                       else np.zeros((0, 3, 2), np.float32))
        self._ref_sides = torch.as_tensor(self.ref_tri_sides, device=self.device)
        self._ref_tri_pts = torch.as_tensor(ref_tri_pts, device=self.device)
        self._ref_pts = torch.as_tensor(self.ref_pts, device=self.device)

    def align_batch(self, frames_meta):
        """Align frames given as (naxisn, StarList) with >= 3 stars each, the
        whole-batch path of the JAX package (device pick and triangles).
        Returns a list of (trans float32 (6,), residual float)."""
        combos = _combos_for(self.k)
        min_length = float(self.naxisn[1]) * MIN_DISTANCE_FRACTION
        ml2 = np.float32(min_length * min_length)
        out = []
        for naxisn, stars in frames_meta:
            n = stars.count
            xs, ys = stars.x[:n], stars.y[:n]
            picked = _pick_frame(xs, ys, ml2, self.k)
            scale = np.float32(float(self.naxisn[0]) / float(naxisn[0]))
            tri_sides, tri_pts = _tris_frame(xs, ys, picked, combos, scale, self.device)
            pts = torch.as_tensor(np.stack([xs, ys], axis=-1).astype(np.float32),
                                  device=self.device)
            trans, res = _search(tri_sides, tri_pts, self._ref_sides, self._ref_tri_pts,
                                 pts, self._ref_pts, float(n), self.k)
            out.append((trans.cpu().numpy().astype(np.float32), float(res)))
        return out

    def align_one(self, naxisn, stars):
        """Align one frame through the host-side pick and compacted triangle
        list (aligner.py align_deferred). Returns (trans, residual) or None
        when no triangle exists."""
        if len(stars) == 0 or len(self.ref_tris) == 0:
            return None
        min_length = float(self.naxisn[1]) * MIN_DISTANCE_FRACTION
        idx = pick_brightest_distant(stars.x, stars.y, min_length, self.k)
        scale = float(self.naxisn[0]) / float(naxisn[0])
        tri_sides, tris = generate_triangles(stars.x, stars.y, idx, scale)
        if len(tris) == 0:
            return None
        pts = np.stack([stars.x, stars.y], axis=-1).astype(np.float32)
        trans, res = _search(torch.as_tensor(tri_sides, device=self.device),
                             torch.as_tensor(pts[tris], device=self.device),
                             self._ref_sides, self._ref_tri_pts,
                             torch.as_tensor(pts, device=self.device), self._ref_pts,
                             float(len(stars)), self.k)
        return trans.cpu().numpy().astype(np.float32), float(res)
