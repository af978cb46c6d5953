"""Pre-stack calibration, mirror of nightlight_tpu/ops/prestack.py: dark
subtraction, flat division with degenerate-pixel passthrough
(badpixels.go:107-123), the 3x3 median as the 9-element min/max sorting
network (median3x3.go:85-110), the bad-pixel map with median repair
(badpixels.go:32-104), the CFA-aware cosmetic correction
(badpixels_bayer.go) and the bilinear one-channel debayer (debayer.go).

The mono functions work on (H, W) images and on (N, H, W) frame batches;
the bayer ones on one (H, W) mosaic.
"""

from __future__ import annotations

import torch

from nightlight_tpu_torch.ops.pixelmath import fma32


def subtract(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b (badpixels.go:107-111)."""
    return a - b


def flat_divide(a: torch.Tensor, flat: torch.Tensor, flat_max: float) -> torch.Tensor:
    """a * flat_max / flat, passing through where the flat is <= 0."""
    fm = torch.tensor(float(flat_max), dtype=torch.float32, device=a.device)
    return torch.where(flat <= 0.0, a, a * fm / flat)


def _sort2(a, b):
    return torch.minimum(a, b), torch.maximum(a, b)


def median9(v: list) -> torch.Tensor:
    """Median of 9 planes via the 30-op sorting network (median3x3.go:85-110)."""
    a0, a1, a2, a3, a4, a5, a6, a7, a8 = v
    a0, a1 = _sort2(a0, a1)
    a3, a4 = _sort2(a3, a4)
    a6, a7 = _sort2(a6, a7)
    a1, a2 = _sort2(a1, a2)
    a4, a5 = _sort2(a4, a5)
    a7, a8 = _sort2(a7, a8)
    a0, a1 = _sort2(a0, a1)
    a3, a4 = _sort2(a3, a4)
    a6, a7 = _sort2(a6, a7)
    a3 = torch.maximum(a0, a3)
    a6 = torch.maximum(a3, a6)
    a1, a4 = _sort2(a1, a4)
    a4 = torch.minimum(a4, a7)
    a4 = torch.maximum(a1, a4)
    a5 = torch.minimum(a5, a8)
    a2 = torch.minimum(a2, a5)
    a2, a4 = _sort2(a2, a4)
    a4 = torch.minimum(a4, a6)
    a4 = torch.maximum(a2, a4)
    return a4


def median_filter_3x3(img: torch.Tensor) -> torch.Tensor:
    """3x3 median over the last two axes; the outermost rows and columns
    pass through unchanged (median3x3.go:26-38)."""
    h, w = img.shape[-2], img.shape[-1]
    planes = [img[..., dy:h - 2 + dy, dx:w - 2 + dx] for dy in range(3) for dx in range(3)]
    out = img.clone()
    out[..., 1:-1, 1:-1] = median9(planes)
    return out


def _std(diff: torch.Tensor) -> torch.Tensor:
    """Population stddev over the last two axes, accumulated in float64 and
    rounded once to float32."""
    d = diff.reshape(*diff.shape[:-2], -1).to(torch.float64)
    return d.std(-1, correction=0).to(torch.float32)


def bad_pixel_stats(img: torch.Tensor):
    """Difference from the local 3x3 median and its stddev (badpixels.go:32-41)."""
    diff = img - median_filter_3x3(img)
    return diff, _std(diff)


def bad_pixel_repair(img: torch.Tensor, sigma_low: float, sigma_high: float):
    """Replace pixels deviating from the 3x3 median by more than sigma times
    the stddev of the median-difference map with that median
    (badpixels.go:32-104). Returns (repaired, num_bad, diff_stddev), the
    last two per frame for a batch."""
    med = median_filter_3x3(img)
    diff = img - med
    std = _std(diff)
    s = std[..., None, None]
    slo = torch.tensor(float(sigma_low), dtype=torch.float32, device=img.device)
    shi = torch.tensor(float(sigma_high), dtype=torch.float32, device=img.device)
    bad = (diff < -slo * s) | (diff > shi * s)
    repaired = torch.where(bad, med, img)
    return repaired, bad.sum(dim=(-2, -1)), std


# ---------------------------------------------------------------------------
# Debayer (bilinear, one channel), debayer.go:26-263
# ---------------------------------------------------------------------------

_CFA_OFFSETS = {"RGGB": (0, 0), "GRBG": (1, 0), "GBRG": (0, 1), "BGGR": (1, 1)}
_SQRT2 = 2.0**0.5


def cfa_offsets(cfa: str) -> tuple[int, int]:
    """CFA pattern -> (xOffset, yOffset) into the canonical RGGB tiling
    (debayer.go:26-38)."""
    try:
        return _CFA_OFFSETS[cfa.upper()]
    except KeyError:
        raise ValueError(f"Unknown CFA value {cfa}") from None


def debayer_bilinear(img: torch.Tensor, channel: str, cfa: str) -> torch.Tensor:
    """Bilinear debayer of one colour channel at full resolution, cropped to
    even width and height from the CFA offset (debayer.go:41-60)."""
    xo, yo = cfa_offsets(cfa)
    ch = channel.upper()
    if ch == "R":
        return _debayer_red(img, xo, yo)
    if ch == "G":
        return _debayer_green(img, xo, yo)
    if ch == "B":
        return _debayer_blue(img, xo, yo)
    raise ValueError(f"Unknown debayering value {channel}")


def _adj_size(img, xo: int, yo: int):
    h, w = img.shape
    return (h - yo) & ~1, (w - xo) & ~1


def _pad_edge(a, top: int, bottom: int, left: int, right: int):
    """Edge-replicating pad of a 2-D tensor (jnp.pad mode="edge")."""
    return torch.nn.functional.pad(a[None, None], (left, right, top, bottom),
                                   mode="replicate")[0, 0]


def _interleave(img, adj_h: int, adj_w: int, q00, q01, q10, q11):
    """The (adj_h, adj_w) image whose 2x2 cells are the four quarter planes."""
    out = torch.empty((adj_h, adj_w), dtype=img.dtype, device=img.device)
    out[0::2, 0::2] = q00
    out[0::2, 1::2] = q01
    out[1::2, 0::2] = q10
    out[1::2, 1::2] = q11
    return out


def _debayer_red(img, xo: int, yo: int):
    """Red channel (debayer.go:63-124). Neighbours follow the reference's
    source-coordinate tests: on an odd size the last cell's right or down
    neighbour is the cropped-off sample, and the diagonal falls back to r
    itself on the last available row or column (nightlight_tpu
    _debayer_red)."""
    adj_h, adj_w = _adj_size(img, xo, yo)
    ah2, aw2 = adj_h // 2, adj_w // 2
    rall = img[yo::2, xo::2]
    fh, fw = rall.shape
    rpad = _pad_edge(rall, 0, 1, 0, 1)
    r = rall[:ah2, :aw2]
    dev = img.device
    has_r = (torch.arange(aw2, device=dev) + 1 < fw)[None, :]
    has_d = (torch.arange(ah2, device=dev) + 1 < fh)[:, None]
    r_right = torch.where(has_r, rpad[:ah2, 1:aw2 + 1], r)
    r_down = torch.where(has_d, rpad[1:ah2 + 1, :aw2], r)
    r_rd = torch.where(has_r & has_d, rpad[1:ah2 + 1, 1:aw2 + 1], r)
    return _interleave(img, adj_h, adj_w, r, 0.5 * (r + r_right), 0.5 * (r + r_down),
                       0.25 * (r + r_right + r_down + r_rd))


def _debayer_blue(img, xo: int, yo: int):
    """Blue channel (debayer.go:201-262): the up-left mirror of red, with
    real neighbours outside the even crop for offset CFAs."""
    adj_h, adj_w = _adj_size(img, xo, yo)
    ah2, aw2 = adj_h // 2, adj_w // 2
    ball = img[(yo + 1) % 2::2, (xo + 1) % 2::2]
    i0, j0 = (yo + 1) // 2, (xo + 1) // 2
    bpad = _pad_edge(ball, 1, 0, 1, 0)  # bpad[i+1, j+1] = ball[i, j]
    b = ball[i0:i0 + ah2, j0:j0 + aw2]
    dev = img.device
    has_l = (torch.arange(aw2, device=dev) + j0 >= 1)[None, :]
    has_u = (torch.arange(ah2, device=dev) + i0 >= 1)[:, None]
    b_left = torch.where(has_l, bpad[1 + i0:1 + i0 + ah2, j0:j0 + aw2], b)
    b_up = torch.where(has_u, bpad[i0:i0 + ah2, 1 + j0:1 + j0 + aw2], b)
    b_lu = torch.where(has_l & has_u, bpad[i0:i0 + ah2, j0:j0 + aw2], b)
    return _interleave(img, adj_h, adj_w, 0.25 * (b + b_left + b_up + b_lu),
                       0.5 * (b + b_up), 0.5 * (b + b_left), b)


def _debayer_green(img, xo: int, yo: int):
    """Green channel (debayer.go:128-199): the missing corners from the four
    nearest greens, with the sqrt2-weighted extrapolation only where the
    source-coordinate neighbour does not exist."""
    adj_h, adj_w = _adj_size(img, xo, yo)
    ah2, aw2 = adj_h // 2, adj_w // 2
    g1all = img[yo % 2::2, (xo + 1) % 2::2]
    g2all = img[(yo + 1) % 2::2, xo % 2::2]
    j0g1 = (xo + 1) // 2
    i0g2 = (yo + 1) // 2
    g1h = g1all.shape[0]
    g2w = g2all.shape[1]
    g1 = g1all[:ah2, j0g1:j0g1 + aw2]
    g2 = g2all[i0g2:i0g2 + ah2, :aw2]

    w_edge = 1.0 / (2.0 + _SQRT2)
    fb_lr = (2.0 * g1 + _SQRT2 * g2) * w_edge
    # XLA contracts sqrt2*g1 + 2*g2 into one fused multiply-add (2*g1 is
    # exact, so fb_lr's contraction changes nothing)
    s2 = torch.tensor(_SQRT2, dtype=torch.float32, device=img.device)
    fb_ud = fma32(s2, g1, 2.0 * g2) * w_edge

    g1pad = _pad_edge(g1all, 0, 1, 1, 0)
    g2pad = _pad_edge(g2all, 1, 0, 0, 1)
    dev = img.device
    has_left = (torch.arange(aw2, device=dev) + j0g1 >= 1)[None, :]
    has_up = (torch.arange(ah2, device=dev) + i0g2 >= 1)[:, None]
    has_right = (torch.arange(aw2, device=dev) + 1 < g2w)[None, :]
    has_down = (torch.arange(ah2, device=dev) + 1 < g1h)[:, None]

    g1_left = torch.where(has_left, g1pad[:ah2, j0g1:j0g1 + aw2], fb_lr)
    g2_up = torch.where(has_up, g2pad[i0g2:i0g2 + ah2, :aw2], fb_ud)
    g2_right = torch.where(has_right, g2pad[1 + i0g2:1 + i0g2 + ah2, 1:aw2 + 1], fb_lr)
    g1_down = torch.where(has_down, g1pad[1:ah2 + 1, 1 + j0g1:1 + j0g1 + aw2], fb_ud)
    return _interleave(img, adj_h, adj_w, 0.25 * (g1 + g2 + g1_left + g2_up), g1, g2,
                       0.25 * (g1 + g2 + g2_right + g1_down))


# ---------------------------------------------------------------------------
# Bayer cosmetic correction (badpixels_bayer.go)
# ---------------------------------------------------------------------------

# 25-comparator sorting network for 9 inputs, as compare-exchanges over
# separate planes (nightlight_tpu/ops/prestack.py _SORT9_NET)
_SORT9_NET = [(0, 1), (3, 4), (6, 7),
              (1, 2), (4, 5), (7, 8),
              (0, 1), (3, 4), (6, 7),
              (0, 3), (3, 6), (0, 3),
              (1, 4), (4, 7), (1, 4),
              (2, 5), (5, 8), (2, 5),
              (1, 3), (5, 7),
              (2, 6), (4, 6), (2, 4),
              (2, 3), (5, 6)]


def _masked_median9(stacks: list, valids: list) -> torch.Tensor:
    """Elementwise median of 9 planes counting only the `valids` entries
    (median.MedianFloat32: the mean of the two middles for an even count).
    Invalid entries go to 3.4e38 before the network; the rank is picked by
    a where-chain."""
    big = torch.tensor(3.4e38, dtype=torch.float32, device=stacks[0].device)
    v = [torch.where(m, s, big) for s, m in zip(stacks, valids)]
    for i, j in _SORT9_NET:
        v[i], v[j] = _sort2(v[i], v[j])
    cnt = valids[0].to(torch.int32)
    for m in valids[1:]:
        cnt = cnt + m.to(torch.int32)
    up_idx = (cnt // 2).clamp(0, 8)
    lo_idx = (cnt // 2 - 1).clamp(min=0).clamp(0, 8)
    upper = v[0]
    lower = v[0]
    for k in range(1, 9):
        upper = torch.where(up_idx == k, v[k], upper)
        lower = torch.where(lo_idx == k, v[k], lower)
    return torch.where(cnt % 2 == 1, upper, 0.5 * (lower + upper))


def _shifted(img: torch.Tensor, dy: int, dx: int):
    """img shifted by (dy, dx) with the validity mask of in-frame reads
    (broadcastable to the image)."""
    h, w = img.shape
    shifted = torch.roll(img, (-dy, -dx), dims=(0, 1))
    yy = torch.arange(h, device=img.device)[:, None] + dy
    xx = torch.arange(w, device=img.device)[None, :] + dx
    valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
    return shifted, valid


_G_OFFSETS = [(-2, 0), (-1, -1), (-1, 1), (0, -2), (0, 0), (0, 2), (1, -1), (1, 1), (2, 0)]
_RB_OFFSETS = [(dy, dx) for dy in (-2, 0, 2) for dx in (-2, 0, 2)]


def _bayer_channel_correct(img, xo: int, yo: int, green: bool, sigma_low: float,
                           sigma_high: float):
    """Shared bayer cosmetic-correction core (badpixels_bayer.go:49-61): the
    same-colour neighbourhood median at every pixel, the mean and stddev of
    delta = data - median over the channel's positions, and the channel's
    outliers replaced by the median. The two sums accumulate in float64 and
    round once to float32. Returns (image, count)."""
    h, w = img.shape
    dev = img.device
    offsets = _G_OFFSETS if green else _RB_OFFSETS
    stacks, valids = [], []
    for dy, dx in offsets:
        s, v = _shifted(img, dy, dx)
        stacks.append(s)
        valids.append(v)
    med = _masked_median9(stacks, valids)
    del stacks

    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    if green:
        chan = ((yy - yo) + (xx - xo)) % 2 == 1
        chan = chan & (yy >= yo) & (xx >= xo)
    else:
        chan = ((yy - yo) % 2 == 0) & ((xx - xo) % 2 == 0) & (yy >= yo) & (xx >= xo)
    chan = chan.expand(h, w)

    delta = img - med
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    cnt = chan.sum().clamp(min=1).to(torch.float32)
    mean = torch.where(chan, delta, zero).to(torch.float64).sum().to(torch.float32) / cnt
    dev2 = (delta - mean) ** 2
    var = torch.where(chan, dev2, zero).to(torch.float64).sum().to(torch.float32) / cnt
    std = torch.sqrt(var)
    slo = torch.tensor(float(sigma_low), dtype=torch.float32, device=dev)
    shi = torch.tensor(float(sigma_high), dtype=torch.float32, device=dev)
    outlier = chan & ((delta < -slo * std) | (delta > shi * std))
    return torch.where(outlier, med, img), outlier.sum()


def cosmetic_correction_bayer(img: torch.Tensor, channel: str, cfa: str,
                              sigma_low: float, sigma_high: float):
    """CFA-aware cosmetic correction of the debayer channel's positions
    (badpixels_bayer.go:26-46). Returns (corrected image, number removed)."""
    xo, yo = cfa_offsets(cfa)
    ch = channel.upper()
    if ch == "R":
        return _bayer_channel_correct(img, xo, yo, False, sigma_low, sigma_high)
    if ch == "G":
        return _bayer_channel_correct(img, xo, yo, True, sigma_low, sigma_high)
    if ch == "B":
        return _bayer_channel_correct(img, xo + 1, yo + 1, False, sigma_low, sigma_high)
    raise ValueError(f"Unknown debayering value {channel}")
