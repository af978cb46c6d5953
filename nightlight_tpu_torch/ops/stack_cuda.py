"""Stacking kernels K1 (sigma / winsorized clip, plain or weighted), K2
(linear fit) and K3 (median, single-pass MAD sigma clip), each beside its
plain PyTorch version.

The CUDA sources are ``csrc/stack_clip.cu``, ``csrc/stack_linfit.cu`` and
``csrc/stack_single_pass.cu``; they replace the Pallas kernels of
nightlight_tpu/ops/stack_pallas.py (``_stack_clip_pallas``,
``_stack_linfit_pallas`` and ``_stack_single_pass_pallas``) and compute the
same per-pixel functions. The wrappers take a (N, P) float32 frame block with NaN
for missing samples and return ``(stacked (P,), clip_lo, clip_hi)`` with the
clip totals as 0-d int64 tensors (30 frames x 16.8 MP already holds 5e8
samples; a larger batch passes 2^31).

Each kernel has two CUDA designs, picked by the frame count alone
(``_clip_plan``, ``_linfit_plan``, ``_single_pass_plan``): the column on
chip (registers and shared memory, one launch over all pixels) up to 32
frames for K1 and 256 for K2 and K3, and the first design of the port, the
column in global scratch launched in pixel chunks, above that. The limits
are where the on-chip design stopped beating the scratch design on the card
(chip_smoke.py times both at every bucket).

A wrapper runs the plain version only for a tensor on the CPU. A CUDA tensor
goes to the kernel, or the wrapper raises.
"""

from __future__ import annotations

import math
from typing import NamedTuple

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
# H100 shared memory: per SM, the most one block may take, and what the
# runtime reserves per block
SM_SHARED_BYTES = 233_472
BLOCK_SHARED_BYTES = 232_448
BLOCK_RESERVED_BYTES = 1_024
# wire counts of the on-chip kernels (csrc/stack_clip.cu, csrc/stack_linfit.cu,
# csrc/stack_single_pass.cu); above 64 wires the column is in shared memory
CLIP_WIRES = (8, 16, 32)
LINFIT_WIRES = (32, 64, 128, 256)
SINGLE_PASS_WIRES = (8, 16, 32, 64, 128, 256)
# threads per block of the on-chip kernels, in order of preference: blocks
# of two warps let a kernel of many registers per thread fill an SM in fine
# steps (K2 at 32 wires, about 90 registers a thread: 2 blocks of 256
# threads fit an SM's registers, or 11 of 64, i.e. 16 or 22 warps)
_THREADS = (64, 32)


class Plan(NamedTuple):
    """How a wrapper launches a kernel: the design ("onchip" or "scratch"),
    the sorting network's wires (0 for scratch), threads per block, dynamic
    shared memory per block, and pixels per launch."""

    variant: str
    wires: int
    threads: int
    smem_bytes: int
    pixels_per_launch: int


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


def _grid_warps(pixels: int, threads: int) -> int:
    """Warps of a launch of one thread a pixel."""
    return -(-pixels // threads) * threads // 32


def _clip_partials(plan: Plan, p: int, device):
    """Room for the per-warp (low, high) clip count sums that K1-K3 write
    (csrc/common.cuh write_clip_partials), and the launches of `plan` over
    p pixels: (partials, [(first pixel, pixels, first warp), ...])."""
    if plan.variant == "onchip":
        launches = [(0, p, 0)] if p > 0 else []
        warps = _grid_warps(p, plan.threads)
    else:
        launches, warps = [], 0
        for s in range(0, p, plan.pixels_per_launch):
            q = min(plan.pixels_per_launch, p - s)
            launches.append((s, q, warps))
            warps += _grid_warps(q, plan.threads)
    return torch.empty((warps, 2), dtype=torch.int32, device=device), launches


def _clip_totals(partials: torch.Tensor):
    totals = torch.sum(partials, dim=0, dtype=torch.int64)
    return totals[0], totals[1]


def _onchip_plan(n: int, p: int, wires_choices, bytes_per_thread) -> Plan | None:
    """The on-chip launch for n frames: the fewest wires that hold them, and
    the first of _THREADS for which two blocks fit an SM's shared memory;
    None when n is past the largest network."""
    wires = next((w for w in wires_choices if n >= 1 and w >= n), None)
    if wires is None:
        return None
    per_thread = bytes_per_thread(wires)
    for threads in _THREADS:
        smem = threads * per_thread
        if 2 * (smem + BLOCK_RESERVED_BYTES) <= SM_SHARED_BYTES:
            return Plan("onchip", wires, threads, smem, p)
    return None


def _clip_plan(n: int, p: int, weighted: bool, force_scratch: bool = False) -> Plan:
    """K1's launch for (n, p) frames: on chip up to 32 frames (rows of 4
    bytes per thread in shared memory: the column and its prefix sums, 3n+2
    or weighted 5n+4), else global scratch of 3n+2 (weighted 6n+4) rows in
    pixel chunks."""
    rows = 5 * n + 4 if weighted else 3 * n + 2
    plan = None if force_scratch else _onchip_plan(n, p, CLIP_WIRES, lambda wires: 4 * rows)
    if plan is not None:
        return plan
    scratch_rows = 6 * n + 4 if weighted else 3 * n + 2
    return Plan("scratch", 0, 256, 0, _chunk_pixels(p, scratch_rows * 4))


def _linfit_plan(n: int, p: int, force_scratch: bool = False) -> Plan:
    """K2's launch for (n, p) frames: on chip up to 256 frames (in registers
    up to 64 wires; above, the sorted column in shared memory, 4n bytes per
    thread), else global scratch of n float and n byte rows in pixel
    chunks."""
    plan = None if force_scratch else _onchip_plan(
        n, p, LINFIT_WIRES, lambda wires: 4 * n if wires > 64 else 0)
    if plan is not None:
        return plan
    return Plan("scratch", 0, 256, 0, _chunk_pixels(p, n * 5))


def _single_pass_plan(n: int, p: int, mad: bool, force_scratch: bool = False) -> Plan:
    """K3's launch for (n, p) frames: on chip up to 256 frames (in registers
    up to 64 wires; above, the column in shared memory, 4n bytes per
    thread), else global scratch of n rows (MAD 2n) in pixel chunks."""
    plan = None if force_scratch else _onchip_plan(
        n, p, SINGLE_PASS_WIRES, lambda wires: 4 * n if wires > 64 else 0)
    if plan is not None:
        return plan
    return Plan("scratch", 0, 256, 0, _chunk_pixels(p, (2 * n if mad else n) * 4))


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


def stack_sigma_cuda(frames, ref_loc, sigma_lo, sigma_hi, weights=None, winsorize=False,
                     _force_scratch=False):
    """K1 on the card; `_force_scratch` launches the global-scratch design
    whatever n is, so a measurement can set the two designs side by side."""
    kernels.require_cuda(frames, "stack_sigma", torch.float32)
    n, p = frames.shape
    if weights is not None:
        kernels.require_cuda(weights, "stack_sigma weights", torch.float32)
        if tuple(weights.shape) != (n,):
            raise ValueError(f"stack_sigma: weights shape {tuple(weights.shape)} != ({n},)")
    lib = kernels.library()
    plan = _clip_plan(n, p, weights is not None, _force_scratch)
    out = torch.empty(p, dtype=torch.float32, device=frames.device)
    partials, launches = _clip_partials(plan, p, frames.device)
    target = kernels.launch_on(frames.device)
    w_ptr = weights.data_ptr() if weights is not None else None
    args = (float(sigma_lo), float(sigma_hi), float(ref_loc), int(bool(winsorize)))
    if plan.variant == "onchip":
        if launches:
            err = lib.nl_stack_clip_onchip(frames.data_ptr(), w_ptr, n, p, *args, plan.wires,
                                           plan.threads, plan.smem_bytes, out.data_ptr(),
                                           partials.data_ptr(), *target)
            kernels.check(err, "stack_clip")
            kernels.count_launch("stack_clip")
    else:
        rows = 6 * n + 4 if weights is not None else 3 * n + 2
        scratch = torch.empty((rows, plan.pixels_per_launch), dtype=torch.float32,
                              device=frames.device)
        for s, q, w in launches:
            err = lib.nl_stack_clip(frames.data_ptr() + 4 * s, w_ptr, n, p, q, *args,
                                    scratch.data_ptr(), out.data_ptr() + 4 * s,
                                    partials.data_ptr() + 8 * w, *target)
            kernels.check(err, "stack_clip")
            kernels.count_launch("stack_clip")
    return (out, *_clip_totals(partials))


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
# K3: median and single-pass MAD sigma clip
# ---------------------------------------------------------------------------


def stack_single_pass(frames: torch.Tensor, ref_loc: float, sigma_lo: float = 0.0,
                      sigma_hi: float = 0.0, mad: bool = False):
    """NaN-skipping median (mad=False) or MAD sigma-clipped mean (mad=True)
    per pixel; the median has no clip counts (both 0)."""
    _check_frames(frames, "stack_single_pass")
    if frames.device.type == "cpu":
        return stack_single_pass_plain(frames, ref_loc, sigma_lo, sigma_hi, mad)
    return stack_single_pass_cuda(frames, ref_loc, sigma_lo, sigma_hi, mad)


def stack_single_pass_cuda(frames, ref_loc, sigma_lo=0.0, sigma_hi=0.0, mad=False,
                           _force_scratch=False):
    """K3 on the card; `_force_scratch` as in stack_sigma_cuda. The median
    writes no clip counts: its totals are zeros."""
    kernels.require_cuda(frames, "stack_single_pass", torch.float32)
    n, p = frames.shape
    lib = kernels.library()
    plan = _single_pass_plan(n, p, mad, _force_scratch)
    out = torch.empty(p, dtype=torch.float32, device=frames.device)
    partials, launches = _clip_partials(plan, p, frames.device)
    partials_ptr = partials.data_ptr() if mad else None  # the median counts nothing
    target = kernels.launch_on(frames.device)
    args = (float(sigma_lo), float(sigma_hi), float(ref_loc), int(bool(mad)))
    if plan.variant == "onchip":
        if launches:
            err = lib.nl_stack_single_pass_onchip(frames.data_ptr(), n, p, *args, plan.wires,
                                                  plan.threads, plan.smem_bytes, out.data_ptr(),
                                                  partials_ptr, *target)
            kernels.check(err, "stack_single_pass")
            kernels.count_launch("stack_single_pass")
    else:
        rows = 2 * n if mad else n
        scratch = torch.empty((rows, plan.pixels_per_launch), dtype=torch.float32,
                              device=frames.device)
        for s, q, w in launches:
            err = lib.nl_stack_single_pass(
                frames.data_ptr() + 4 * s, n, p, q, *args, scratch.data_ptr(),
                out.data_ptr() + 4 * s, None if partials_ptr is None else partials_ptr + 8 * w,
                *target)
            kernels.check(err, "stack_single_pass")
            kernels.count_launch("stack_single_pass")
    if mad:
        return (out, *_clip_totals(partials))
    zeros = torch.zeros(2, dtype=torch.int64, device=frames.device)
    return out, zeros[0], zeros[1]


def _single_pass_block(f, ref_loc, sigma_lo, sigma_hi, mad):
    n, p = f.shape
    dev = f.device
    valid = ~torch.isnan(f)
    cnt0 = valid.sum(0)
    svals = torch.sort(torch.where(valid, f, torch.full((), BIG, dtype=f.dtype, device=dev)),
                       dim=0).values
    zero = torch.zeros_like(cnt0)
    ref = torch.full((p,), float(ref_loc), dtype=torch.float32, device=dev)
    median = _median_range(svals, zero, cnt0)
    if not mad:
        return torch.where(cnt0 > 0, median, ref), 0, 0
    in_cnt = torch.arange(n, device=dev)[:, None] < cnt0
    sdev = torch.sort(torch.where(in_cnt, (svals - median).abs(), BIG), dim=0).values
    std = _median_range(sdev, zero, cnt0) * 1.4826
    lo_b = median - sigma_lo * std
    hi_b = median + sigma_hi * std
    below = in_cnt & (svals < lo_b)
    above = in_cnt & (svals > hi_b)
    keep = in_cnt & ~below & ~above
    mean = _seqsum(torch.where(keep, svals, 0.0)) / keep.sum(0).clamp(min=1).to(torch.float32)
    return torch.where(cnt0 > 0, mean, ref), below.sum(), above.sum()


def stack_single_pass_plain(frames, ref_loc, sigma_lo=0.0, sigma_hi=0.0, mad=False):
    """Plain PyTorch version of K3 (the XLA twins stack_median and
    stack_mad_sigma of nightlight_tpu/ops/stack.py): sort along the frame
    axis, the median of the valid prefix, and for MAD the median of the
    sorted absolute deviations, one clip pass and the mean of the kept
    samples summed in sorted order, pixel blocks at a time. A pixel with
    valid samples but none kept gives 0.0. Sigmas are rounded to float32 as
    the kernel receives them."""
    n, p = frames.shape
    slo = torch.tensor(float(sigma_lo), dtype=torch.float32, device=frames.device)
    shi = torch.tensor(float(sigma_hi), dtype=torch.float32, device=frames.device)
    outs, clo, chi = [], 0, 0
    for s, e in _blocks(p, n):
        o, cl, ch = _single_pass_block(frames[:, s:e], ref_loc, slo, shi, mad)
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


def stack_linfit_cuda(frames, ref_loc, sigma_lo, sigma_hi, _force_scratch=False):
    """K2 on the card; `_force_scratch` as in stack_sigma_cuda."""
    kernels.require_cuda(frames, "stack_linfit", torch.float32)
    n, p = frames.shape
    lib = kernels.library()
    plan = _linfit_plan(n, p, _force_scratch)
    out = torch.empty(p, dtype=torch.float32, device=frames.device)
    partials, launches = _clip_partials(plan, p, frames.device)
    target = kernels.launch_on(frames.device)
    args = (float(sigma_lo), float(sigma_hi), float(ref_loc))
    if plan.variant == "onchip":
        if launches:
            err = lib.nl_stack_linfit_onchip(frames.data_ptr(), n, p, *args, plan.wires,
                                             plan.threads, plan.smem_bytes, out.data_ptr(),
                                             partials.data_ptr(), *target)
            kernels.check(err, "stack_linfit")
            kernels.count_launch("stack_linfit")
    else:
        q = plan.pixels_per_launch
        scratch_v = torch.empty((n, q), dtype=torch.float32, device=frames.device)
        scratch_a = torch.empty((n, q), dtype=torch.uint8, device=frames.device)
        for s, q, w in launches:
            err = lib.nl_stack_linfit(frames.data_ptr() + 4 * s, n, p, q, *args,
                                      scratch_v.data_ptr(), scratch_a.data_ptr(),
                                      out.data_ptr() + 4 * s, partials.data_ptr() + 8 * w,
                                      *target)
            kernels.check(err, "stack_linfit")
            kernels.count_launch("stack_linfit")
    return (out, *_clip_totals(partials))


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
