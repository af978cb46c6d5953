"""Pre-stack calibration, mirror of nightlight_tpu/ops/prestack.py: dark
subtraction, flat division with degenerate-pixel passthrough
(badpixels.go:107-123), the 3x3 median as the 9-element min/max sorting
network (median3x3.go:85-110), the bad-pixel map with median repair
(badpixels.go:32-104), the CFA-aware cosmetic correction
(badpixels_bayer.go) and the bilinear one-channel debayer (debayer.go).

The mono functions work on (H, W) images and on (N, H, W) frame batches;
the bayer ones on one (H, W) mosaic. bad_pixel_repair_sharded and
debayer_sharded take one row-sharded frame (parallel/mesh.py RowSharded)
and work on each shard's rows with its neighbours' halo rows.
"""

from __future__ import annotations

import torch

from nightlight_tpu_torch import trace
from nightlight_tpu_torch.ops.pixelmath import fma32
from nightlight_tpu_torch.parallel import mesh as pm


def subtract(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b (badpixels.go:107-111)."""
    return a - b


def flat_divide(a: torch.Tensor, flat: torch.Tensor, flat_max: float) -> torch.Tensor:
    """a * flat_max / flat, passing through where the flat is <= 0."""
    fm = trace.upload(float(flat_max), a.device, torch.float32)
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


def _total(values, device: torch.device) -> torch.Tensor:
    """Per-part partials (a frame's one part, or its shards' in mesh order)
    added on `device`."""
    total = None
    for v in values:
        v = pm._to(v, device)
        total = v if total is None else total + v
    return total


def _std(diffs, n: int, device: torch.device) -> torch.Tensor:
    """Population stddev over the last two axes of a frame held in parts
    (row blocks): two passes of float64 sums (the mean, then the squared
    deviations), each part summed on its device and the partials added on
    `device`, rounded once to float32."""
    mean = _total([d.to(torch.float64).sum(dim=(-2, -1)) for d in diffs], device) / n

    def dev2(d):
        e = d.to(torch.float64) - pm._to(mean, d.device)[..., None, None]
        return (e * e).sum(dim=(-2, -1))

    return torch.sqrt(_total([dev2(d) for d in diffs], device) / n).to(torch.float32)


def bad_pixel_stats(img: torch.Tensor):
    """Difference from the local 3x3 median and its stddev (badpixels.go:32-41)."""
    diff = img - median_filter_3x3(img)
    return diff, _std([diff], img.shape[-2] * img.shape[-1], img.device)


def _repair_parts(parts, n: int, device, sigma_low: float, sigma_high: float):
    """The bad-pixel policy over a frame held in parts, each (rows, their
    3x3 medians): the difference map's stddev from the parts' float64 sums
    (_std), the outliers beyond sigma times it replaced by the median.
    Returns (repaired parts, num_bad as int64, diff_stddev), the last two
    added up on `device`."""
    diffs = [b - m for b, m in parts]
    std = _std(diffs, n, device)
    repaired, counts = [], []
    for (b, m), d in zip(parts, diffs):
        s = pm._to(std, b.device)[..., None, None]
        slo = trace.upload(float(sigma_low), b.device, torch.float32)
        shi = trace.upload(float(sigma_high), b.device, torch.float32)
        bad = (d < -slo * s) | (d > shi * s)
        repaired.append(torch.where(bad, m, b))
        counts.append(bad.sum(dim=(-2, -1)).to(torch.int64))
    return repaired, _total(counts, device), std


def bad_pixel_repair(img: torch.Tensor, sigma_low: float, sigma_high: float):
    """Replace pixels deviating from the 3x3 median by more than sigma times
    the stddev of the median-difference map with that median
    (badpixels.go:32-104). Returns (repaired, num_bad, diff_stddev), the
    last two per frame for a batch."""
    (repaired,), n_bad, std = _repair_parts([(img, median_filter_3x3(img))],
                                            img.shape[-2] * img.shape[-1], img.device,
                                            sigma_low, sigma_high)
    return repaired, n_bad, std


def bad_pixel_repair_sharded(x, sigma_low: float, sigma_high: float):
    """bad_pixel_repair of one row-sharded (H, W) frame, shard by shard
    (_repair_parts over the shards): each shard's 3x3 median takes one halo
    row from each neighbour, and the frame's first and last rows (and its
    outer columns) pass through as unsharded. Returns (repaired RowSharded,
    n_bad, diff_stddev), the last two 0-d tensors on the lead device."""
    meds = [median_filter_3x3(ext)[..., top:top + b.shape[-2], :]
            for (ext, top, _), b in zip(pm.halo(x, 1, 1), x.blocks)]
    repaired, n_bad, std = _repair_parts(list(zip(x.blocks, meds)), x.numel(), x.mesh.lead,
                                         sigma_low, sigma_high)
    return pm.RowSharded(x.mesh, x.shape, repaired, x.replicated), n_bad, std


def bad_pixel_stats_sharded(x):
    """The stddev of bad_pixel_stats' difference map of one row-sharded
    (H, W) frame, shard by shard: each shard's 3x3 median with one halo row
    from each neighbour (as bad_pixel_repair_sharded), the stddev from the
    shards' float64 partials (_std), a 0-d float32 tensor on the lead."""
    diffs = [b - median_filter_3x3(ext)[..., top:top + b.shape[-2], :]
             for (ext, top, _), b in zip(pm.halo(x, 1, 1), x.blocks)]
    return _std(diffs, x.numel(), x.mesh.lead)


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


def debayer_sharded(x, channel: str, cfa: str):
    """debayer_bilinear of one row-sharded (H, W) mosaic, shard by shard,
    where the output keeps the input's rows (a CFA row offset of 0, an even
    row count in each shard): each shard debayers its rows with two halo
    rows from each neighbour (whole CFA cells, so the pattern's phase
    holds) and keeps its own output rows, which read no further than one
    row across. Otherwise (or for a replicated frame) the mosaic is
    debayered whole on the lead and the result placed by the mesh's rule.
    Returns a RowSharded image."""
    _, yo = cfa_offsets(cfa)
    rows = x.shape[-2] // x.mesh.size
    if x.replicated or yo != 0 or rows % 2 != 0:
        # the output rows do not line up with the input shards
        return pm.place_on_mesh(debayer_bilinear(pm.gather(x, "debayer"), channel, cfa),
                                x.mesh)
    blocks = []
    for (ext, top, _), b in zip(pm.halo(x, 2, 2), x.blocks):
        out = debayer_bilinear(ext, channel, cfa)
        blocks.append(out[top:top + rows].contiguous())
    return pm.RowSharded(x.mesh, (x.shape[-2], blocks[0].shape[-1]), blocks)


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
    s2 = trace.upload(_SQRT2, img.device, torch.float32)
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
    big = trace.upload(3.4e38, stacks[0].device, torch.float32)
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


def _bayer_correct_parts(parts, device, sigma_low: float, sigma_high: float):
    """Shared bayer cosmetic-correction core (badpixels_bayer.go:49-61) over
    a mosaic held in parts, each (rows, their same-colour neighbourhood
    medians, the mask of the channel's positions): the mean and stddev of
    delta = data - median over the channel's positions, and the channel's
    outliers replaced by the median. The two sums accumulate in float64
    per part, are added on `device` and round once to float32. Returns
    (corrected parts, count on `device`)."""
    deltas = [b - med for b, med, _ in parts]
    cnt = _total([chan.sum() for _, _, chan in parts], device).clamp(min=1).to(torch.float32)

    def chan_sum(fn):
        return _total([torch.where(chan, fn(d), torch.zeros((), device=d.device))
                       .to(torch.float64).sum() for (_, _, chan), d in zip(parts, deltas)],
                      device).to(torch.float32)

    mean = chan_sum(lambda d: d) / cnt
    var = chan_sum(lambda d: (d - pm._to(mean, d.device)) ** 2) / cnt
    std = torch.sqrt(var)
    out, counts = [], []
    for (b, med, chan), d in zip(parts, deltas):
        s = pm._to(std, b.device)
        slo = trace.upload(float(sigma_low), b.device, torch.float32)
        shi = trace.upload(float(sigma_high), b.device, torch.float32)
        outlier = chan & ((d < -slo * s) | (d > shi * s))
        out.append(torch.where(outlier, med, b))
        counts.append(outlier.sum())
    return out, _total(counts, device)


def _bayer_median_chan(img, xo: int, yo: int, green: bool):
    """The same-colour neighbourhood median at every pixel of a mosaic and
    the mask of the channel's positions."""
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
    return med, chan.expand(h, w)


def _bayer_channel(channel: str, cfa: str):
    """(xo, yo, green) of the debayer channel's positions."""
    xo, yo = cfa_offsets(cfa)
    ch = channel.upper()
    if ch == "R":
        return xo, yo, False
    if ch == "G":
        return xo, yo, True
    if ch == "B":
        return xo + 1, yo + 1, False
    raise ValueError(f"Unknown debayering value {channel}")


def cosmetic_correction_bayer(img: torch.Tensor, channel: str, cfa: str,
                              sigma_low: float, sigma_high: float):
    """CFA-aware cosmetic correction of the debayer channel's positions
    (badpixels_bayer.go:26-46). Returns (corrected image, number removed)."""
    xo, yo, green = _bayer_channel(channel, cfa)
    (out,), n = _bayer_correct_parts([(img, *_bayer_median_chan(img, xo, yo, green))],
                                     img.device, sigma_low, sigma_high)
    return out, n


def cosmetic_correction_bayer_sharded(x, channel: str, cfa: str, sigma_low: float,
                                      sigma_high: float):
    """cosmetic_correction_bayer of one row-sharded mosaic, shard by shard,
    where each shard's row count is even (whole CFA cells): the medians
    from two halo rows of each neighbour, the channel's mean and variance
    of the differences summed per shard in float64 (the unsharded sums
    accumulate in float64 too), the count an int64 sum. Otherwise the
    mosaic is corrected whole on the lead and placed back. Returns
    (RowSharded image, number removed on the lead device)."""
    xo, yo, green = _bayer_channel(channel, cfa)
    rows = x.shape[-2] // x.mesh.size
    if x.replicated or rows % 2 != 0:
        out, n = cosmetic_correction_bayer(pm.gather(x, "bayer"), channel, cfa, sigma_low,
                                           sigma_high)
        return pm.place_on_mesh(out, x.mesh), n
    parts = []
    for (ext, top, _), b in zip(pm.halo(x, 2, 2), x.blocks):
        med, chan = _bayer_median_chan(ext, xo, yo, green)
        parts.append((b, med[top:top + rows], chan[top:top + rows]))
    blocks, n = _bayer_correct_parts(parts, x.mesh.lead, sigma_low, sigma_high)
    return pm.RowSharded(x.mesh, x.shape, blocks), n
