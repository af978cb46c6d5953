"""Clip-stacking kernels K1 (sigma / winsorized, plain or weighted) and K2
(linear fit), each beside its plain PyTorch version.

The CUDA sources are ``csrc/stack_clip.cu`` and ``csrc/stack_linfit.cu``;
they replace the Pallas kernels of nightlight_tpu/ops/stack_pallas.py
(``_stack_clip_pallas`` and ``_stack_linfit_pallas``) and compute the same
per-pixel functions. The wrappers take a (N, P) float32 frame block with NaN
for missing samples and return ``(stacked (P,), clip_lo, clip_hi)`` with the
clip totals as 0-d int64 tensors (30 frames x 16.8 MP already holds 5e8
samples; a larger batch passes 2^31).

A wrapper runs the plain version only for a tensor on the CPU. A CUDA tensor
goes to the kernel, or the wrapper raises.
"""

from __future__ import annotations

import math

import torch

from nightlight_tpu_torch import kernels

BIG = 3.0e38
# pixels per block of the plain versions: bounds their (N, block)
# temporaries to ~128 MB each, whatever the frame count
_PLAIN_ELEMS = 1 << 25
# scratch bytes per kernel launch: the wrappers launch pixel chunks so that
# the kernels' per-pixel scratch (3-6x the frames) stays within this beside
# a batch the memory solver sized to fill the card
SCRATCH_BYTES = 2 << 30


def _check_frames(frames: torch.Tensor, name: str) -> None:
    if frames.dim() != 2:
        raise ValueError(f"{name}: expected (N, P) frames, got {tuple(frames.shape)}")
    if frames.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32 frames, got {frames.dtype}")


def _blocks(p: int, n: int):
    step = max(1, _PLAIN_ELEMS // max(n, 1))
    for s in range(0, p, step):
        yield s, min(p, s + step)


def _chunk_pixels(p: int, scratch_bytes_per_pixel: int) -> int:
    """Pixels per kernel launch: as many as SCRATCH_BYTES of scratch hold,
    at least 2^18 (enough threads to fill the card)."""
    return max(1, min(p, max(1 << 18, SCRATCH_BYTES // scratch_bytes_per_pixel)))


# ---------------------------------------------------------------------------
# K1: sigma / winsorized clip
# ---------------------------------------------------------------------------


def stack_sigma(frames: torch.Tensor, ref_loc: float, sigma_lo: float, sigma_hi: float,
                weights: torch.Tensor | None = None, winsorize: bool = False):
    """Sigma-clipped (winsorize=False) or winsorized sigma-clipped mean per
    pixel, optionally weighted by per-frame `weights` (N,)."""
    _check_frames(frames, "stack_sigma")
    if frames.device.type == "cpu":
        return stack_sigma_plain(frames, ref_loc, sigma_lo, sigma_hi, weights, winsorize)
    return stack_sigma_cuda(frames, ref_loc, sigma_lo, sigma_hi, weights, winsorize)


def stack_sigma_cuda(frames, ref_loc, sigma_lo, sigma_hi, weights=None, winsorize=False):
    kernels.require_cuda(frames, "stack_sigma", torch.float32)
    n, p = frames.shape
    if weights is not None:
        kernels.require_cuda(weights, "stack_sigma weights", torch.float32)
        if tuple(weights.shape) != (n,):
            raise ValueError(f"stack_sigma: weights shape {tuple(weights.shape)} != ({n},)")
    lib = kernels.library()
    rows = (6 * n + 4) if weights is not None else (3 * n + 2)
    q = _chunk_pixels(p, rows * 4)
    scratch = torch.empty((rows, q), dtype=torch.float32, device=frames.device)
    out = torch.empty(p, dtype=torch.float32, device=frames.device)
    clips = torch.empty((2, p), dtype=torch.int32, device=frames.device)
    stream = kernels.stream_handle(frames.device)
    for s in range(0, p, q):
        err = lib.nl_stack_clip(
            frames.data_ptr() + 4 * s, weights.data_ptr() if weights is not None else None,
            n, p, min(q, p - s), float(sigma_lo), float(sigma_hi), float(ref_loc),
            int(bool(winsorize)), scratch.data_ptr(), out.data_ptr() + 4 * s,
            clips.data_ptr() + 4 * s, stream)
        kernels.check(err, "stack_clip")
        kernels.count_launch("stack_clip")
    totals = torch.sum(clips, dim=1, dtype=torch.int64)
    return out, totals[0], totals[1]


def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t[idx[j], j], indices clamped into range (lanes that could reach
    past it are never consumed)."""
    idx = idx.clamp(0, t.shape[0] - 1)
    return torch.gather(t, 0, idx[None, :])[0]


def _median_range(z, lo, cnt):
    c1 = cnt.clamp(min=1)
    upper = _take(z, lo + c1 // 2)
    lower = _take(z, lo + (c1 // 2 - 1).clamp(min=0))
    return torch.where(c1 % 2 == 1, upper, 0.5 * (lower + upper))


def _prefix(v):
    """S[k] = sum of the first k rows, accumulated row by row in float32 (the
    kernels' order; torch.cumsum accumulates float32 in float64 on the
    CPU), with a leading zero row: shape (N+1, P)."""
    out = torch.empty((v.shape[0] + 1,) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)
    out[0] = 0.0
    acc = torch.zeros_like(v[0])
    for i in range(v.shape[0]):
        acc = acc + v[i]
        out[i + 1] = acc
    return out


def _seqsum(v):
    """Sum over the frame axis accumulated row by row in float32, the
    order of the kernels and of the JAX package's reductions."""
    acc = torch.zeros_like(v[0])
    for i in range(v.shape[0]):
        acc = acc + v[i]
    return acc


def _tail_counts(z, row, lo, hi, b, t):
    m = (row >= lo) & (row < hi)
    return (m & (z < b)).sum(0), (m & (z > t)).sum(0)


def _winsor_std(z, row, s1, s2, lo, hi, median, std0):
    """Progressive-clamp winsorized stddev fixed point of the sorted range
    [lo, hi), the clamped sums as interior prefix-sum difference plus bound
    times tail count (ops/stack.py _sigma_clip_core winsor_std)."""
    c = (hi - lo).clamp(min=1).to(torch.float32)
    std = std0
    lo_r = torch.full_like(std0, -math.inf)
    hi_r = torch.full_like(std0, math.inf)
    done = torch.zeros_like(std0, dtype=torch.bool)
    for _ in range(32):  # 8 trips of 4 applications
        if bool(done.all()):
            break
        wlo = median - 1.5 * std
        whi = median + 1.5 * std
        nlo = torch.maximum(lo_r, wlo)
        nhi = torch.minimum(hi_r, whi)
        below, above = _tail_counts(z, row, lo, hi, nlo, nhi)
        a, b = lo + below, hi - above
        bf, af = below.to(torch.float32), above.to(torch.float32)
        wsum = (_take(s1, b) - _take(s1, a)) + bf * nlo + af * nhi
        wsq = (_take(s2, b) - _take(s2, a)) + bf * nlo * nlo + af * nhi * nhi
        m = wsum / c
        var = wsq / c - m * m
        s = 1.134 * torch.sqrt(var.clamp(min=0.0))
        changed = torch.where(wlo > lo_r, below, 0) + torch.where(whi < hi_r, above, 0)
        fac = (s - std).abs() / std.clamp(min=1e-30)
        new_done = done | (changed == 0) | (fac <= 0.0005)
        std = torch.where(done, std, s)
        lo_r = torch.where(done, lo_r, nlo)
        hi_r = torch.where(done, hi_r, nhi)
        done = new_done
    return std


def _sigma_block(f, ref_loc, sigma_lo, sigma_hi, weights, winsorize):
    n, p = f.shape
    dev = f.device
    valid = ~torch.isnan(f)
    cnt0 = valid.sum(0)
    filled = torch.where(valid, f, torch.full((), BIG, dtype=f.dtype, device=dev))
    svals, order = torch.sort(filled, dim=0, stable=True)
    row = torch.arange(n, device=dev)[:, None]
    center = torch.where(cnt0 > 0, _median_range(svals, torch.zeros_like(cnt0), cnt0), 0.0)
    z = torch.where(row < cnt0, svals - center, 0.0)
    s1, s2 = _prefix(z), _prefix(z * z)
    if weights is not None:
        sw = weights[order]
        w1, wv1 = _prefix(sw), _prefix(sw * z)

    lo = torch.zeros_like(cnt0)
    hi = cnt0.clone()
    running = cnt0 > 0
    ref = torch.full((p,), float(ref_loc), dtype=torch.float32, device=dev)
    result = ref
    clo = torch.zeros(p, dtype=torch.int64, device=dev)
    chi = torch.zeros(p, dtype=torch.int64, device=dev)
    for _ in range(n + 1):
        if not bool(running.any()):
            break
        cf = (hi - lo).clamp(min=1).to(torch.float32)
        median = _median_range(z, lo, hi - lo)
        mean = (_take(s1, hi) - _take(s1, lo)) / cf
        var = (_take(s2, hi) - _take(s2, lo)) / cf - mean * mean
        std = torch.sqrt(var.clamp(min=0.0))
        if winsorize:
            std = _winsor_std(z, row, s1, s2, lo, hi, median, std)
        below, above = _tail_counts(z, row, lo, hi, median - sigma_lo * std,
                                    median + sigma_hi * std)
        below = torch.where(running, below, 0)
        above = torch.where(running, above, 0)
        new_lo, new_hi = lo + below, hi - above
        new_cnt = new_hi - new_lo
        stop = running & ((below + above == 0) | (new_cnt <= 1))
        if weights is None:
            final = mean
        else:
            ws, wv = _take(w1, new_hi) - _take(w1, new_lo), _take(wv1, new_hi) - _take(wv1, new_lo)
            ws_pre, wv_pre = _take(w1, hi) - _take(w1, lo), _take(wv1, hi) - _take(wv1, lo)
            final = torch.where(new_cnt > 0, wv / ws.clamp(min=1e-30),
                                wv_pre / ws_pre.clamp(min=1e-30))
        result = torch.where(stop, final, result)
        clo += below
        chi += above
        lo, hi = new_lo, new_hi
        running = running & ~stop
    return torch.where(cnt0 > 0, result + center, ref), clo.sum(), chi.sum()


def stack_sigma_plain(frames, ref_loc, sigma_lo, sigma_hi, weights=None, winsorize=False):
    """Plain PyTorch version of K1: sort along the frame axis, centre on the
    median, prefix sums of the sorted values, then the clip rounds as
    per-pixel range arithmetic and masked tail counts, pixel blocks at a
    time. Sigmas are rounded to float32 as the kernel receives them."""
    n, p = frames.shape
    slo = torch.tensor(float(sigma_lo), dtype=torch.float32, device=frames.device)
    shi = torch.tensor(float(sigma_hi), dtype=torch.float32, device=frames.device)
    outs, clo, chi = [], 0, 0
    for s, e in _blocks(p, n):
        o, cl, ch = _sigma_block(frames[:, s:e], ref_loc, slo, shi, weights, winsorize)
        outs.append(o)
        clo = clo + cl
        chi = chi + ch
    out = torch.cat(outs) if outs else frames.new_empty(0)
    zero = torch.zeros((), dtype=torch.int64, device=frames.device)
    return out, zero + clo, zero + chi


# ---------------------------------------------------------------------------
# K2: linear fit
# ---------------------------------------------------------------------------


def stack_linfit(frames: torch.Tensor, ref_loc: float, sigma_lo: float, sigma_hi: float):
    """Linear-fit clipped mean per pixel (no weighted variant, as in the
    reference)."""
    _check_frames(frames, "stack_linfit")
    if frames.device.type == "cpu":
        return stack_linfit_plain(frames, ref_loc, sigma_lo, sigma_hi)
    return stack_linfit_cuda(frames, ref_loc, sigma_lo, sigma_hi)


def stack_linfit_cuda(frames, ref_loc, sigma_lo, sigma_hi):
    kernels.require_cuda(frames, "stack_linfit", torch.float32)
    n, p = frames.shape
    lib = kernels.library()
    q = _chunk_pixels(p, n * 5)
    scratch_v = torch.empty((n, q), dtype=torch.float32, device=frames.device)
    scratch_a = torch.empty((n, q), dtype=torch.uint8, device=frames.device)
    out = torch.empty(p, dtype=torch.float32, device=frames.device)
    clips = torch.empty((2, p), dtype=torch.int32, device=frames.device)
    stream = kernels.stream_handle(frames.device)
    for s in range(0, p, q):
        err = lib.nl_stack_linfit(
            frames.data_ptr() + 4 * s, n, p, min(q, p - s), float(sigma_lo),
            float(sigma_hi), float(ref_loc), scratch_v.data_ptr(), scratch_a.data_ptr(),
            out.data_ptr() + 4 * s, clips.data_ptr() + 4 * s, stream)
        kernels.check(err, "stack_linfit")
        kernels.count_launch("stack_linfit")
    totals = torch.sum(clips, dim=1, dtype=torch.int64)
    return out, totals[0], totals[1]


def _linfit_block(f, ref_loc, sigma_lo, sigma_hi):
    n, p = f.shape
    valid = ~torch.isnan(f)
    cnt0 = valid.sum(0)
    filled = torch.where(valid, f, torch.full((), BIG, dtype=f.dtype, device=f.device))
    svals = torch.sort(filled, dim=0).values
    row = torch.arange(n, device=f.device)[:, None]
    ys = torch.where(svals >= BIG, 0.0, svals)
    active = (row < cnt0).to(torch.float32)
    running = cnt0 > 0
    result = torch.full((p,), float(ref_loc), dtype=torch.float32, device=f.device)
    clo = torch.zeros(p, dtype=torch.int64, device=f.device)
    chi = torch.zeros(p, dtype=torch.int64, device=f.device)
    for _ in range(n + 1):
        if not bool(running.any()):
            break
        cnt = active.sum(0)
        c = cnt.clamp(min=1.0)
        xs = torch.cumsum(active, 0) - active  # exclusive prefix = rank
        xmean = _seqsum(active * xs) / c
        ymean = _seqsum(active * ys) / c
        dx = xs - xmean
        dy = ys - ymean
        xstd = torch.sqrt(_seqsum(active * dx * dx) / c)
        ystd = torch.sqrt(_seqsum(active * dy * dy) / c)
        corr = _seqsum(active * dx * dy)
        corr = corr / (xstd * ystd * (c + 1.0) + 1e-30)
        slope = corr * ystd / (xstd + 1e-30)
        intercept = ymean - slope * xmean
        resid = ys - (xs * slope + intercept)
        sigma = _seqsum(active * resid.abs()) / c
        amask = active > 0.0
        rej_lo = amask & ((-resid) > sigma_lo * sigma)
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


def stack_linfit_plain(frames, ref_loc, sigma_lo, sigma_hi):
    """Plain PyTorch version of K2: sort along the frame axis, ranks as an
    exclusive cumulative sum of the active mask, the regression and the
    rejections as masked reductions."""
    n, p = frames.shape
    slo = torch.tensor(float(sigma_lo), dtype=torch.float32, device=frames.device)
    shi = torch.tensor(float(sigma_hi), dtype=torch.float32, device=frames.device)
    outs, clo, chi = [], 0, 0
    for s, e in _blocks(p, n):
        o, cl, ch = _linfit_block(frames[:, s:e], ref_loc, slo, shi)
        outs.append(o)
        clo = clo + cl
        chi = chi + ch
    out = torch.cat(outs) if outs else frames.new_empty(0)
    zero = torch.zeros((), dtype=torch.int64, device=frames.device)
    return out, zero + clo, zero + chi
