"""The plain reference of a stack job: what the saved stacked FITS should
hold, computed from the job's input files in plain PyTorch.

It follows the semantics of nightlight's `stack` chain: dark subtraction,
flat division, bad-pixel repair against the 3x3 median (or, for a CFA
channel, the CFA-aware cosmetic correction and the bilinear debayer), the
sampled, iteratively sigma-clipped median and Qn location and scale,
histogram matching to the reference light's location and scale, bilinear
projection into the reference light's frame with NaN outside, and the
stack (the mean, or the sigma, winsorized sigma or linear-fit clip) at
given sigmas or at sigmas goal-sought to the target clip percentages, its
sums in the kernels' order. Star detection and
alignment (ref_stars.py) pick the reference light by its stars-over-HFR
score and map every other light onto it.

The arithmetic is that of the program's plain versions, copied here so
that the yardstick stays fixed whatever later changes make to the program:
the estimator draws its sample and roll shifts from the keys the program
uses (JAX's threefry PRNG, reproduced in numpy below), so location and
scale agree to the bit on the same pixels. Nothing here imports the
program.

`precision="bfloat16"` is the control: every stage's output is rounded to
bfloat16, the next precision below the float32 the program states.
"""

from __future__ import annotations

import math

import numpy as np
import torch

FITS_BLOCK = 2880
QN_SCALE = 2.21914
CLIP_SCALE_ADJUST = 1.134
NUM_SAMPLES = 128 * 1024
BIG = 3.0e38
PLAIN_ELEMS = 1 << 25
SEARCH_STRIDE = 17
SEARCH_SUBSAMPLE_MIN = 1 << 22
f32 = np.float32


# ---------------------------------------------------------------------------
# FITS
# ---------------------------------------------------------------------------


def read_fits(path: str, device) -> torch.Tensor:
    """The (H, W) float32 pixels of a 2-D FITS file of BITPIX 16 or -32,
    BZERO and BSCALE applied."""
    with open(path, "rb") as f:
        raw = f.read()
    cards, pos = {}, 0
    while True:
        block = raw[pos:pos + FITS_BLOCK].decode("ascii")
        pos += FITS_BLOCK
        done = False
        for i in range(0, FITS_BLOCK, 80):
            card = block[i:i + 80]
            key = card[:8].strip()
            if key == "END":
                done = True
                break
            if card[8:10] == "= ":
                cards[key] = card[10:].split("/")[0].strip()
        if done:
            break
    bitpix, w, h = int(cards["BITPIX"]), int(cards["NAXIS1"]), int(cards["NAXIS2"])
    dtype = {16: ">i2", -32: ">f4"}[bitpix]
    data = np.frombuffer(raw, dtype=dtype, count=w * h, offset=pos).astype(np.float32)
    bzero = float(cards.get("BZERO", "0"))
    bscale = float(cards.get("BSCALE", "1"))
    t = torch.from_numpy(data.reshape(h, w)).to(device)
    if bscale != 1.0:
        t = t * bscale
    return t + bzero if bzero != 0.0 else t


# ---------------------------------------------------------------------------
# JAX's threefry2x32 PRNG: the estimator's sample indices and roll shifts
# ---------------------------------------------------------------------------

_ROT0 = (13, 15, 26, 6)
_ROT1 = (17, 29, 16, 24)


def _rotl(x, d):
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def _threefry(k1, k2, x1, x2):
    k1, k2 = np.uint32(k1), np.uint32(k2)
    ks = (k1, k2, np.uint32(k1 ^ k2 ^ np.uint32(0x1BD11BDA)))
    x = [np.asarray(x1, np.uint32) + ks[0], np.asarray(x2, np.uint32) + ks[1]]
    schedule = ((_ROT0, ks[1], ks[2], 1), (_ROT1, ks[2], ks[0], 2), (_ROT0, ks[0], ks[1], 3),
                (_ROT1, ks[1], ks[2], 4), (_ROT0, ks[2], ks[0], 5))
    with np.errstate(over="ignore"):
        for rots, ka, kb, inc in schedule:
            for r in rots:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r)
                x[1] = x[0] ^ x[1]
            x[0] = x[0] + ka
            x[1] = x[1] + kb + np.uint32(inc)
    return x[0], x[1]


def _iota(n: int):
    idx = np.arange(n, dtype=np.uint64)
    low = idx & np.uint64(0xFFFFFFFF)
    return (idx >> np.uint64(32)).astype(np.uint32), low.astype(np.uint32)


def _split(key, num: int):
    b1, b2 = _threefry(key[0], key[1], *_iota(num))
    return np.stack([b1, b2], axis=-1)


def _fold_in(key, data: int):
    b1, b2 = _threefry(key[0], key[1], np.array([0], np.uint32),
                       np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.array([b1[0], b2[0]], np.uint32)


def _bits(key, n: int):
    b1, b2 = _threefry(key[0], key[1], *_iota(n))
    return b1 ^ b2


def _randint(key, n: int, lo: int, hi: int) -> np.ndarray:
    k = _split(key, 2)
    higher, lower = _bits(k[0], n), _bits(k[1], n)
    span = np.uint32(hi - lo)
    with np.errstate(over="ignore"):
        mult = np.uint32((1 << 16) % int(span))
        mult = np.uint32(((int(mult) * int(mult)) & 0xFFFFFFFF) % int(span))
        off = ((higher % span) * mult + (lower % span)) % span
    return (np.int64(lo) + off.astype(np.int64)).astype(np.int32)


_DRAWS = {}


def estimator_draws(p: int, max_iter: int = 10):
    """Sample indices, the first Qn roll, two rolls per clip round and the
    final roll, from PRNGKey(0) split four ways."""
    if p not in _DRAWS:
        key = np.array([0, 0], np.uint32)
        k_sample, k_qn0, k_loop, k_final = _split(key, 4)
        idx = _randint(k_sample, NUM_SAMPLES, 0, p)
        shift0 = int(_randint(k_qn0, 1, 1, NUM_SAMPLES)[0])
        loop = [[int(s) for s in _randint(_fold_in(k_loop, i), 2, 1, NUM_SAMPLES)]
                for i in range(max_iter)]
        final = int(_randint(k_final, 1, 1, NUM_SAMPLES)[0])
        _DRAWS[p] = (idx, shift0, loop, final)
    return _DRAWS[p]


# ---------------------------------------------------------------------------
# Calibration and repair
# ---------------------------------------------------------------------------


def _sort2(a, b):
    return torch.minimum(a, b), torch.maximum(a, b)


def median9(a: list) -> torch.Tensor:
    """Elementwise median of 9 planes by the min/max network of
    median3x3.go."""
    a = list(a)
    for i, j in ((0, 1), (3, 4), (6, 7), (1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7)):
        a[i], a[j] = _sort2(a[i], a[j])
    a[3] = torch.maximum(a[0], a[3])
    a[6] = torch.maximum(a[3], a[6])
    a[1], a[4] = _sort2(a[1], a[4])
    a[4] = torch.minimum(a[4], a[7])
    a[4] = torch.maximum(a[1], a[4])
    a[5] = torch.minimum(a[5], a[8])
    a[2] = torch.minimum(a[2], a[5])
    a[2], a[4] = _sort2(a[2], a[4])
    a[4] = torch.minimum(a[4], a[6])
    return torch.maximum(a[2], a[4])


def median3x3(img: torch.Tensor) -> torch.Tensor:
    """3x3 median; the outer rows and columns pass through."""
    h, w = img.shape
    out = img.clone()
    out[1:-1, 1:-1] = median9([img[dy:h - 2 + dy, dx:w - 2 + dx]
                               for dy in range(3) for dx in range(3)])
    return out


def _std64(d: torch.Tensor) -> torch.Tensor:
    """Population stddev in two float64 passes, rounded once to float32."""
    mean = d.to(torch.float64).mean()
    e = d.to(torch.float64) - mean
    return torch.sqrt((e * e).mean()).to(torch.float32)


def bad_pixel_repair(img, sigma_low: float, sigma_high: float):
    """Pixels further than sigma times the stddev of (image - 3x3 median)
    from their median are replaced by it. Returns (image, the stddev)."""
    med = median3x3(img)
    d = img - med
    s = _std64(d)
    bad = (d < -f32(sigma_low) * s) | (d > f32(sigma_high) * s)
    return torch.where(bad, med, img), s


_SORT9 = [(0, 1), (3, 4), (6, 7), (1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (0, 3), (3, 6),
          (0, 3), (1, 4), (4, 7), (1, 4), (2, 5), (5, 8), (2, 5), (1, 3), (5, 7), (2, 6), (4, 6),
          (2, 4), (2, 3), (5, 6)]
_G_OFFSETS = [(-2, 0), (-1, -1), (-1, 1), (0, -2), (0, 0), (0, 2), (1, -1), (1, 1), (2, 0)]
_RB_OFFSETS = [(dy, dx) for dy in (-2, 0, 2) for dx in (-2, 0, 2)]
_CFA = {"RGGB": (0, 0), "GRBG": (1, 0), "GBRG": (0, 1), "BGGR": (1, 1)}


def cosmetic_bayer(img, channel: str, cfa: str, sigma_low: float, sigma_high: float):
    """CFA-aware repair of one channel's positions: each against the median
    of its same-colour neighbourhood (edges counting only in-frame
    neighbours), outliers beyond sigma times the stddev of the channel's
    differences replaced by the median."""
    h, w = img.shape
    xo, yo = _CFA[cfa]
    green = channel == "G"
    if channel == "B":
        xo, yo = xo + 1, yo + 1
    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    v, cnt = [], torch.zeros((h, w), dtype=torch.int32, device=img.device)
    for dy, dx in (_G_OFFSETS if green else _RB_OFFSETS):
        valid = (yy + dy >= 0) & (yy + dy < h) & (xx + dx >= 0) & (xx + dx < w)
        v.append(torch.where(valid, torch.roll(img, (-dy, -dx), dims=(0, 1)),
                             torch.full((), 3.4e38, device=img.device)))
        cnt = cnt + valid.to(torch.int32)
    for i, j in _SORT9:
        v[i], v[j] = _sort2(v[i], v[j])
    up_idx, lo_idx = (cnt // 2).clamp(0, 8), (cnt // 2 - 1).clamp(0, 8)
    upper, lower = v[0], v[0]
    for k in range(1, 9):
        upper = torch.where(up_idx == k, v[k], upper)
        lower = torch.where(lo_idx == k, v[k], lower)
    med = torch.where(cnt % 2 == 1, upper, 0.5 * (lower + upper))
    if green:
        chan = (((yy - yo) + (xx - xo)) % 2 == 1) & (yy >= yo) & (xx >= xo)
    else:
        chan = ((yy - yo) % 2 == 0) & ((xx - xo) % 2 == 0) & (yy >= yo) & (xx >= xo)
    chan = chan.expand(h, w)
    d = img - med
    n = chan.sum().clamp(min=1).to(torch.float32)
    zero = torch.zeros((), device=img.device)
    mean = torch.where(chan, d, zero).to(torch.float64).sum().to(torch.float32) / n
    var = torch.where(chan, (d - mean) ** 2, zero).to(torch.float64).sum().to(torch.float32) / n
    s = torch.sqrt(var)
    out = chan & ((d < -f32(sigma_low) * s) | (d > f32(sigma_high) * s))
    return torch.where(out, med, img)


def _edge_pad(a, top, bottom, left, right):
    return torch.nn.functional.pad(a[None, None], (left, right, top, bottom),
                                   mode="replicate")[0, 0]


def debayer(img, channel: str, cfa: str) -> torch.Tensor:
    """Bilinear interpolation of one channel at full resolution, cropped to
    an even size from the CFA offset. A neighbour that the mosaic lacks is
    replaced by the pixel itself (red, blue) or by the sqrt2-weighted
    extrapolation from the two nearest greens (green)."""
    xo, yo = _CFA[cfa]
    h, w = img.shape
    ah, aw = (h - yo) & ~1, (w - xo) & ~1
    h2, w2 = ah // 2, aw // 2
    dev = img.device
    cols = torch.arange(w2, device=dev)[None, :]
    rows = torch.arange(h2, device=dev)[:, None]
    out = torch.empty((ah, aw), dtype=img.dtype, device=dev)
    if channel == "R":
        c = img[yo::2, xo::2]
        fh, fw = c.shape
        pad = _edge_pad(c, 0, 1, 0, 1)
        r = c[:h2, :w2]
        has_r, has_d = cols + 1 < fw, rows + 1 < fh
        right = torch.where(has_r, pad[:h2, 1:w2 + 1], r)
        down = torch.where(has_d, pad[1:h2 + 1, :w2], r)
        diag = torch.where(has_r & has_d, pad[1:h2 + 1, 1:w2 + 1], r)
        quads = (r, 0.5 * (r + right), 0.5 * (r + down), 0.25 * (r + right + down + diag))
    elif channel == "B":
        c = img[(yo + 1) % 2::2, (xo + 1) % 2::2]
        i0, j0 = (yo + 1) // 2, (xo + 1) // 2
        pad = _edge_pad(c, 1, 0, 1, 0)
        b = c[i0:i0 + h2, j0:j0 + w2]
        has_l, has_u = cols + j0 >= 1, rows + i0 >= 1
        left = torch.where(has_l, pad[1 + i0:1 + i0 + h2, j0:j0 + w2], b)
        up = torch.where(has_u, pad[i0:i0 + h2, 1 + j0:1 + j0 + w2], b)
        lu = torch.where(has_l & has_u, pad[i0:i0 + h2, j0:j0 + w2], b)
        quads = (0.25 * (b + left + up + lu), 0.5 * (b + up), 0.5 * (b + left), b)
    else:
        g1all = img[yo % 2::2, (xo + 1) % 2::2]
        g2all = img[(yo + 1) % 2::2, xo % 2::2]
        j0, i0 = (xo + 1) // 2, (yo + 1) // 2
        g1, g2 = g1all[:h2, j0:j0 + w2], g2all[i0:i0 + h2, :w2]
        k = 1.0 / (2.0 + math.sqrt(2.0))
        fb_lr = (2.0 * g1 + math.sqrt(2.0) * g2) * k
        fb_ud = fma32(torch.tensor(math.sqrt(2.0), device=dev), g1, 2.0 * g2) * k
        g1pad, g2pad = _edge_pad(g1all, 0, 1, 1, 0), _edge_pad(g2all, 1, 0, 0, 1)
        left = torch.where(cols + j0 >= 1, g1pad[:h2, j0:j0 + w2], fb_lr)
        up = torch.where(rows + i0 >= 1, g2pad[i0:i0 + h2, :w2], fb_ud)
        right = torch.where(cols + 1 < g2all.shape[1], g2pad[1 + i0:1 + i0 + h2, 1:w2 + 1], fb_lr)
        down = torch.where(rows + 1 < g1all.shape[0], g1pad[1:h2 + 1, 1 + j0:1 + j0 + w2], fb_ud)
        quads = (0.25 * (g1 + g2 + left + up), g1, g2, 0.25 * (g1 + g2 + right + down))
    out[0::2, 0::2], out[0::2, 1::2], out[1::2, 0::2], out[1::2, 1::2] = quads
    return out


# ---------------------------------------------------------------------------
# Location and scale: sampled, iteratively sigma-clipped median and Qn
# ---------------------------------------------------------------------------


def _median_sorted(ss):
    n = ss.shape[-1]
    return ss[n // 2] if n % 2 else 0.5 * (ss[n // 2 - 1] + ss[n // 2])


def _qn(sample, mask, shifts):
    parts = []
    for k in shifts:
        d = (sample - torch.roll(sample, k)).abs()
        if mask is not None:
            d = torch.where(mask & torch.roll(mask, k), d, torch.full((), math.inf,
                                                                     device=d.device))
        parts.append(d)
    return torch.sort(torch.cat(parts)).values


def location_scale(img: torch.Tensor):
    """(location, scale) as float32 0-d tensors: the median of a fixed
    sample of 131072 pixels, clipped iteratively at location +- 2 scales
    (the Qn of the kept sample, at most ten rounds, stopping when both
    move by no more than (max - min) / 65535), and the final scale the Qn
    of the whole sample."""
    flat = img.reshape(-1)
    idx, shift0, loop, final = estimator_draws(flat.numel())
    eps = (flat.max() - flat.min()) / 65535.0
    sr = flat[torch.as_tensor(idx, dtype=torch.int64, device=flat.device)]
    ss = torch.sort(sr).values
    sig = torch.tensor(2.0, device=flat.device)
    loc = _median_sorted(ss)
    scale = _qn(sr, None, (shift0,))[NUM_SAMPLES >> 2] * QN_SCALE
    for shifts in loop:
        lo_b, hi_b = loc - sig * scale, loc + sig * scale
        lo = int(torch.searchsorted(ss, lo_b.reshape(1), right=False)[0])
        hi = int(torch.searchsorted(ss, hi_b.reshape(1), right=True)[0])
        cnt = max(hi - lo, 2)
        up = ss[min(lo + cnt // 2, NUM_SAMPLES - 1)]
        low = ss[min(lo + max(cnt // 2 - 1, 0), NUM_SAMPLES - 1)]
        new_loc = up if cnt % 2 else 0.5 * (low + up)
        keep = (sr >= lo_b) & (sr <= hi_b)
        sd = _qn(sr, keep, shifts)
        n_valid = int(torch.isfinite(sd).sum())
        new_scale = (sd[min(n_valid >> 2, 2 * NUM_SAMPLES - 1)] * QN_SCALE * CLIP_SCALE_ADJUST
                     if n_valid > 0 else scale)
        if float((new_loc - loc).abs() + (new_scale - scale).abs()) <= float(eps):
            break
        loc, scale = new_loc, new_scale
    return loc, _qn(sr, None, (final,))[NUM_SAMPLES >> 2] * QN_SCALE


def fma32(a, b, c) -> torch.Tensor:
    """a * b + c rounded once to float32 (a fused multiply-add)."""
    d = torch.float64
    return (a.to(d) * b.to(d) + c.to(d)).to(torch.float32)


def match_histogram(img, loc, scale, ref_loc, ref_scale):
    """The linear map of (loc, scale) onto the reference light's, its offset
    and the map each one fused multiply-add."""
    mult = ref_scale / scale
    return fma32(img, mult, fma32(-loc, mult, ref_loc))


# ---------------------------------------------------------------------------
# Projection
# ---------------------------------------------------------------------------


def invert(t) -> np.ndarray:
    a, b, c, d, e, f = (float(v) for v in t)
    det = a * e - b * d
    return np.array([e / det, -b / det, (b * f - c * e) / det,
                     -d / det, a / det, (c * d - a * f) / det])


def project(img: torch.Tensor, to_ref) -> torch.Tensor:
    """Bilinear sampling of img under the inverse of to_ref (source ->
    destination), NaN where a neighbour lies outside or is not finite."""
    h, w = img.shape
    inv = torch.as_tensor(invert(to_ref), dtype=torch.float32, device=img.device)
    col = torch.arange(w, dtype=torch.float32, device=img.device)[None, :]
    row = torch.arange(h, dtype=torch.float32, device=img.device)[:, None]
    px = inv[0] * col + inv[1] * row + inv[2]
    py = inv[3] * col + inv[4] * row + inv[5]
    xl, yl = torch.floor(px), torch.floor(py)
    xr, yr = px - xl, py - yl
    xl, yl = xl.to(torch.int64), yl.to(torch.int64)
    oob = (xl < 0) | (xl + 1 >= w) | (yl < 0) | (yl + 1 >= h)
    xc, yc = xl.clamp(0, w - 2), yl.clamp(0, h - 2)
    v00, v01 = img[yc, xc], img[yc, xc + 1]
    v10, v11 = img[yc + 1, xc], img[yc + 1, xc + 1]
    v = (v00 * (1 - xr) + v01 * xr) * (1 - yr) + (v10 * (1 - xr) + v11 * xr) * yr
    return torch.where(oob, torch.full((), math.nan, device=img.device), v)


# ---------------------------------------------------------------------------
# Stacking
# ---------------------------------------------------------------------------


def auto_mode(n: int) -> int:
    """Stack mode by frame count: 5 linear fit, 3 winsorized, 2 sigma, 1 mean."""
    return 5 if n >= 25 else 3 if n >= 15 else 2 if n >= 6 else 1


def _take(t, idx):
    return torch.gather(t, 0, idx.clamp(0, t.shape[0] - 1)[None, :])[0]


def _median_range(z, lo, cnt):
    c1 = cnt.clamp(min=1)
    upper = _take(z, lo + c1 // 2)
    lower = _take(z, lo + (c1 // 2 - 1).clamp(min=0))
    return torch.where(c1 % 2 == 1, upper, 0.5 * (lower + upper))


def _prefix(v):
    """Sums of the first k rows, (N+1, P), accumulated row by row in
    float32: the stacking kernels' order, so that the clip counts, and the
    goal-seek's decisions on them, agree to the sample."""
    out = torch.empty((v.shape[0] + 1,) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)
    out[0] = 0.0
    acc = torch.zeros_like(v[0])
    for i in range(v.shape[0]):
        acc = acc + v[i]
        out[i + 1] = acc
    return out


def _seqsum(v):
    """The sum over the frame axis, row by row in float32 (the kernels'
    order)."""
    acc = torch.zeros_like(v[0])
    for i in range(v.shape[0]):
        acc = acc + v[i]
    return acc


def _tails(z, row, lo, hi, b, t):
    m = (row >= lo) & (row < hi)
    return (m & (z < b)).sum(0), (m & (z > t)).sum(0)


def _winsor_std(z, row, s1, s2, lo, hi, median, std0):
    """Fixed point of the winsorized stddev of the sorted range [lo, hi):
    values clamped to median +- 1.5 stddev, the stddev rescaled by 1.134,
    until it moves by 0.05% or clamps nothing new (32 rounds at most)."""
    c = (hi - lo).clamp(min=1).to(torch.float32)
    std = std0
    lo_r = torch.full_like(std0, -math.inf)
    hi_r = torch.full_like(std0, math.inf)
    done = torch.zeros_like(std0, dtype=torch.bool)
    for _ in range(32):
        if bool(done.all()):
            break
        wlo, whi = median - 1.5 * std, median + 1.5 * std
        nlo, nhi = torch.maximum(lo_r, wlo), torch.minimum(hi_r, whi)
        below, above = _tails(z, row, lo, hi, nlo, nhi)
        a, b = lo + below, hi - above
        bf, af = below.to(torch.float32), above.to(torch.float32)
        m = ((_take(s1, b) - _take(s1, a)) + bf * nlo + af * nhi) / c
        var = ((_take(s2, b) - _take(s2, a)) + bf * nlo * nlo + af * nhi * nhi) / c - m * m
        s = 1.134 * torch.sqrt(var.clamp(min=0.0))
        changed = torch.where(wlo > lo_r, below, 0) + torch.where(whi < hi_r, above, 0)
        new_done = done | (changed == 0) | ((s - std).abs() / std.clamp(min=1e-30) <= 0.0005)
        std = torch.where(done, std, s)
        lo_r = torch.where(done, lo_r, nlo)
        hi_r = torch.where(done, hi_r, nhi)
        done = new_done
    return std


def _sigma_block(f, sigma_lo, sigma_hi, winsorize):
    """Sigma or winsorized sigma clip of a (N, P) block about the median:
    rounds of clipping beyond median - lo std and median + hi std until none
    is clipped or one value is left; the mean of the kept values."""
    n, p = f.shape
    dev = f.device
    valid = ~torch.isnan(f)
    cnt0 = valid.sum(0)
    svals = torch.sort(torch.where(valid, f, torch.full((), BIG, device=dev)), dim=0).values
    row = torch.arange(n, device=dev)[:, None]
    center = torch.where(cnt0 > 0, _median_range(svals, torch.zeros_like(cnt0), cnt0), 0.0)
    z = torch.where(row < cnt0, svals - center, 0.0)
    s1, s2 = _prefix(z), _prefix(z * z)
    lo, hi = torch.zeros_like(cnt0), cnt0.clone()
    running = cnt0 > 0
    result = torch.zeros(p, dtype=torch.float32, device=dev)
    clo = torch.zeros(p, dtype=torch.int64, device=dev)
    chi = torch.zeros(p, dtype=torch.int64, device=dev)
    for _ in range(n + 1):
        if not bool(running.any()):
            break
        cf = (hi - lo).clamp(min=1).to(torch.float32)
        median = _median_range(z, lo, hi - lo)
        mean = (_take(s1, hi) - _take(s1, lo)) / cf
        std = torch.sqrt(((_take(s2, hi) - _take(s2, lo)) / cf - mean * mean).clamp(min=0.0))
        if winsorize:
            std = _winsor_std(z, row, s1, s2, lo, hi, median, std)
        below, above = _tails(z, row, lo, hi, median - sigma_lo * std, median + sigma_hi * std)
        below = torch.where(running, below, 0)
        above = torch.where(running, above, 0)
        new_lo, new_hi = lo + below, hi - above
        stop = running & ((below + above == 0) | (new_hi - new_lo <= 1))
        result = torch.where(stop, mean, result)
        clo += below
        chi += above
        lo, hi = new_lo, new_hi
        running = running & ~stop
    return torch.where(cnt0 > 0, result + center, 0.0), clo.sum(), chi.sum()


def _linfit_block(f, sigma_lo, sigma_hi):
    """Linear-fit clip of a (N, P) block: a line through the sorted values
    against their rank, values whose residual exceeds sigma times the mean
    absolute residual dropped, until none is or fewer than 3 are left; the
    mean of the kept values."""
    n, p = f.shape
    valid = ~torch.isnan(f)
    cnt0 = valid.sum(0)
    svals = torch.sort(torch.where(valid, f, torch.full((), BIG, device=f.device)), dim=0).values
    row = torch.arange(n, device=f.device)[:, None]
    ys = torch.where(svals >= BIG, 0.0, svals)
    active = (row < cnt0).to(torch.float32)
    running = cnt0 > 0
    result = torch.zeros(p, dtype=torch.float32, device=f.device)
    clo = torch.zeros(p, dtype=torch.int64, device=f.device)
    chi = torch.zeros(p, dtype=torch.int64, device=f.device)
    for _ in range(n + 1):
        if not bool(running.any()):
            break
        cnt = active.sum(0)
        c = cnt.clamp(min=1.0)
        xs = torch.cumsum(active, 0) - active
        xmean = _seqsum(active * xs) / c
        ymean = _seqsum(active * ys) / c
        dx, dy = xs - xmean, ys - ymean
        xstd = torch.sqrt(_seqsum(active * dx * dx) / c)
        ystd = torch.sqrt(_seqsum(active * dy * dy) / c)
        corr = _seqsum(active * dx * dy) / (xstd * ystd * (c + 1.0) + 1e-30)
        slope = corr * ystd / (xstd + 1e-30)
        resid = ys - (xs * slope + (ymean - slope * xmean))
        sigma = _seqsum(active * resid.abs()) / c
        amask = active > 0.0
        rej_lo = amask & (-resid > sigma_lo * sigma)
        rej_hi = amask & (resid > sigma_hi * sigma)
        rej = rej_lo | rej_hi
        n_rej = torch.where(running, rej.sum(0), 0)
        stop = running & ((n_rej == 0) | (cnt < 3.0))
        result = torch.where(stop, ymean, result)
        clo += torch.where(running, rej_lo.sum(0), 0)
        chi += torch.where(running, rej_hi.sum(0), 0)
        drop = running & ~stop
        active = torch.where(drop, active * (1.0 - rej.to(torch.float32)), active)
        running = running & ~stop
    return result, clo.sum(), chi.sum()


def stack_mean(frames: torch.Tensor) -> torch.Tensor:
    """The mean of the finite samples of each pixel (0 where none is)."""
    valid = ~torch.isnan(frames)
    cnt = valid.sum(0)
    s = torch.where(valid, frames, 0.0).sum(0)
    return torch.where(cnt == 0, torch.zeros((), device=frames.device), s / cnt.clamp(min=1))


def stack(frames: torch.Tensor, mode: int, sigma_lo: float, sigma_hi: float):
    """(stacked (P,), clipped low, clipped high) of (N, P) frames, in pixel
    blocks: mode 1 the mean, 2 sigma, 3 winsorized sigma, 5 linear fit."""
    n, p = frames.shape
    if mode == 1:
        return stack_mean(frames), 0, 0
    slo = torch.tensor(float(f32(sigma_lo)), device=frames.device)
    shi = torch.tensor(float(f32(sigma_hi)), device=frames.device)
    outs, clo, chi = [], 0, 0
    step = max(1, PLAIN_ELEMS // n)
    for s in range(0, p, step):
        blk = frames[:, s:s + step]
        if mode == 5:
            o, cl, ch = _linfit_block(blk, slo, shi)
        else:
            o, cl, ch = _sigma_block(blk, slo, shi, winsorize=mode == 3)
        outs.append(o)
        clo, chi = clo + int(cl), chi + int(ch)
    return torch.cat(outs), clo, chi


def _round_perc(clips: int, total: float, target: int) -> int:
    perc = f32(clips) * f32(100.0) / f32(total)
    return int(np.floor(f32(100.0) * perc + f32(0.5))) - target


def _binary_search(clips_at, total, t_lo, t_hi, max_iter):
    lo_l, lo_r, hi_l, hi_r = f32(1.0), f32(11.0), f32(1.0), f32(11.0)
    hist = []
    for i in range(max_iter + 1):
        lo_m, hi_m = f32(0.5) * (lo_l + lo_r), f32(0.5) * (hi_l + hi_r)
        cl, ch = clips_at(lo_m, hi_m)
        hist.append((lo_m, hi_m))
        dl, dh = _round_perc(cl, total, t_lo), _round_perc(ch, total, t_hi)
        if dl > 0:
            lo_l = lo_m
        elif dl < 0:
            lo_r = lo_m
        if dh > 0:
            hi_l = hi_m
        elif dh < 0:
            hi_r = hi_m
        if dl == 0 and dh == 0:
            break
    return hist


def _newton_search(clips_at, total, t_lo, t_hi, max_iter):
    eps, st = f32(0.005), f32(total)
    sl, sh = f32(6.0), f32(6.0)
    hist = []
    for i in range(max_iter + 1):
        cl, ch = clips_at(sl, sh)
        dl = f32(cl) * f32(100.0) / st - f32(t_lo / 100.0)
        dh = f32(ch) * f32(100.0) / st - f32(t_hi / 100.0)
        hist.append((sl, sh))
        converged = (int(np.floor(f32(100.0) * dl + f32(0.5))) == 0
                     and int(np.floor(f32(100.0) * dh + f32(0.5))) == 0)
        cl2, _ = clips_at(sl + eps, sh)
        _, ch3 = clips_at(sl, sh + eps)
        d_l = (f32(cl2) - f32(cl)) * f32(100.0) / st / eps
        d_h = (f32(ch3) - f32(ch)) * f32(100.0) / st / eps
        if converged or d_l == 0.0 or d_h == 0.0:
            break
        sl = f32(np.clip(sl - dl / d_l, f32(0.1), f32(20.0)))
        sh = f32(np.clip(sh - dh / d_h, f32(0.1), f32(20.0)))
    return hist


def goal_seek_stack(frames: torch.Tensor, mode: int, clip_lo: float = 0.5,
                    clip_hi: float = 0.5, max_iter: int = 20):
    """The stack at sigmas goal-sought until the clipped shares round to the
    targets in hundredths of a percent: a binary search (Newton's method
    first for the linear fit), over a stride-17 pixel subsample for
    frames of 2^22 pixels or more, repeated at full resolution when the
    full-resolution stack at the found sigmas lands off target."""
    n, p = frames.shape
    total = frames.numel()
    t_lo, t_hi = int(100 * clip_lo), int(100 * clip_hi)
    big = p >= SEARCH_SUBSAMPLE_MIN

    def run(search, subsample):
        sub, sub_total = frames, float(total)
        if subsample and p >= 4 * SEARCH_STRIDE:
            sub = frames[:, ::SEARCH_STRIDE].contiguous()
            sub_total = total * (sub.numel() / frames.numel())

        def clips_at(lo, hi):
            return stack(sub, mode, lo, hi)[1:]

        hist = search(clips_at, sub_total, t_lo, t_hi, max_iter)
        out, cl, ch = stack(frames, mode, *hist[-1])
        off = (int(100.0 * cl * 100.0 / total + 0.5) - t_lo,
               int(100.0 * ch * 100.0 / total + 0.5) - t_hi)
        return out, off

    search = _newton_search if mode == 5 else _binary_search
    out, off = run(search, big)
    if mode == 5 and off != (0, 0):
        search = _binary_search
        out, off = run(search, big)
    if big and off != (0, 0):
        out, off = run(search, False)
    return out


# ---------------------------------------------------------------------------
# The job
# ---------------------------------------------------------------------------


def stack_job(inputs, recipe: dict, device, precision: str = "float32"):
    """(the stacked (H, W) image of one run of a job on the input files
    (gen.Inputs), the scale of its reference light).

    recipe: "debayer" (None or R/G/B) and "cfa", "bad_pixel_sigmas" (low,
    high), "stars" (radius, sigma, bad_pixel_sigma, in_out_ratio), "align"
    (k, threshold), "stack_mode" (6: by frame count), "sigmas" (low, high;
    negative: goal-seek) and "clip_percent" (low, high)."""
    from benchmark_torch import ref_stars

    if precision == "float32":
        def q(x):
            return x
    else:
        low = getattr(torch, precision)

        def q(x):
            return x.to(low).to(torch.float32)
    dark = q(read_fits(inputs.dark, device)) if inputs.dark else None
    flat = q(read_fits(inputs.flat, device)) if inputs.flat else None
    flat_max = flat.max() if flat is not None else None
    bp_lo, bp_hi = recipe["bad_pixel_sigmas"]
    det, al = recipe["stars"], recipe["align"]
    channel, cfa = recipe.get("debayer"), recipe.get("cfa", "RGGB")
    frames, locscale, found = [], [], []
    for path in inputs.lights:
        img = q(read_fits(path, device))
        if dark is not None:
            img = q(img - dark)
        if flat is not None:
            img = q(torch.where(flat <= 0.0, img, img * flat_max / flat))
        if channel:
            img = q(debayer(q(cosmetic_bayer(img, channel, cfa, bp_lo, bp_hi)), channel, cfa))
            diff_std = _std64(img - median3x3(img))
        else:
            img, diff_std = bad_pixel_repair(img, bp_lo, bp_hi)
            img = q(img)
        loc, scale = location_scale(img)
        locscale.append((loc, scale))
        found.append(ref_stars.find_stars(img, loc, scale, det["sigma"], det["bad_pixel_sigma"],
                                          det["in_out_ratio"], int(det["radius"]), diff_std))
        frames.append(img)
        del img
    ref = ref_stars.select_stars_over_hfr(found)
    ref_loc, ref_scale = locscale[ref]
    h, w = frames[0].shape
    kept = []
    for i, img in enumerate(frames):
        trans = None
        if i != ref:
            aligned = ref_stars.align(found[ref][0], found[i][0], (w, h), (w, h),
                                      int(al["k"]), device)
            if aligned is None or aligned[1] > al["threshold"]:
                frames[i] = None
                continue
            trans = aligned[0]
        img = q(match_histogram(img, *locscale[i], ref_loc, ref_scale))
        if trans is not None:
            img = q(project(img, trans))
        frames[i] = img
        kept.append(i)
    cube = torch.empty((len(kept), h * w), dtype=torch.float32, device=device)
    for row, i in enumerate(kept):
        cube[row] = frames[i].reshape(-1)
        frames[i] = None
    del frames
    mode = recipe["stack_mode"]
    if mode == 6:
        mode = auto_mode(cube.shape[0])
    sig_lo, sig_hi = recipe["sigmas"]
    if mode not in (1, 2, 3, 5):
        raise ValueError(f"stack mode {mode} has no reference")
    if mode != 1 and (sig_lo < 0 or sig_hi < 0):
        out = goal_seek_stack(cube, mode, *recipe["clip_percent"])
    else:
        out = stack(cube, mode, sig_lo, sig_hi)[0]
    return q(out).reshape(h, w), float(ref_scale)
