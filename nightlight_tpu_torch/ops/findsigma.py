"""Goal-seek clip sigmas that hit target clip percentages, mirror of
nightlight_tpu/ops/findsigma.py (dead code in the reference:
internal/ops/stack/stackfindsigma.go; live behind -stSigLow/-stSigHigh -1).

Sigma and winsorized clipping use the dual binary search (brackets [1, 11],
midpoint start, converge when round(100*perc) hits round(100*target) on
both sides); linear fit uses the Newton joint update with epsilon probes,
falling back to the binary search when it exits off target. Above 2^22
pixels per frame the search rounds evaluate a stride-17 pixel subsample;
one full-resolution stack at the accepted sigmas then gives the output and
the exact clip counts, and a subsampled search that lands off target is
repeated at full resolution.

The search runs on the host, one kernel launch (three for a Newton round)
and one read of the clip totals per round; over a device mesh, one launch
per shard and one read of the summed totals. All bracket and percentage
arithmetic is float32, as in the JAX package's device loop, so both take
the same decisions on the same counts. Clip counts are int64 throughout.
"""

from __future__ import annotations

import math

import numpy as np

from nightlight_tpu_torch import trace
from nightlight_tpu_torch.ops import stack as stk
from nightlight_tpu_torch.parallel import mesh as pm

_SEARCH_STRIDE = 17
_SEARCH_SUBSAMPLE_MIN = 1 << 22

f32 = np.float32


def _search_subsample(frames, total: int):
    """(stride-17 pixel subsample (N, P/17) made contiguous for the kernels,
    its sample total as float)."""
    p = frames[0].numel()
    if p < 4 * _SEARCH_STRIDE:
        return frames, float(total)
    flat = frames.reshape(frames.shape[0], -1)
    sub = flat[:, ::_SEARCH_STRIDE].contiguous()
    return sub, total * (sub.numel() / flat.numel())


def _clips_fn(subs, mesh, mode, weights, ref_frame_loc):
    """The evaluator of one search: (sig_lo, sig_hi) -> (clip_lo, clip_hi)
    over `subs`, the whole block (mesh None) or one block per mesh shard.
    Each round launches every shard's stack on its device, sums the counts
    on the lead device and reads the sums back once, so every shard takes
    the one host decision (JAX: shard_map with psum'd counts, the
    while_loops in lockstep)."""
    devices = mesh.devices if mesh is not None else [subs[0].device]
    ws = [None if weights is None else weights.to(dev) for dev in devices]

    def clips(sig_lo, sig_hi):
        lows, highs = [], []
        for sub, w in zip(subs, ws):
            _, cl, ch = stk.stack(sub, stk.StackMode(mode), weights=w, sigma_low=sig_lo,
                                  sigma_high=sig_hi, ref_frame_loc=ref_frame_loc)
            lows.append(cl)
            highs.append(ch)
        if mesh is not None:
            lows, highs = [pm.psum(lows, mesh)], [pm.psum(highs, mesh)]
        return int(trace.to_host(lows[0])), int(trace.to_host(highs[0]))

    return clips


def _round_perc(clips: int, sub_total: float, target: int) -> int:
    perc = f32(clips) * f32(100.0) / f32(sub_total)
    return int(np.floor(f32(100.0) * perc + f32(0.5))) - target


def _binary_search(clips_at, sub_total, target_l, target_h, max_iter):
    """Dual binary search (binarySearchAndStack, stackfindsigma.go:49-100)
    over the evaluator clips_at(sig_lo, sig_hi) -> (cl, ch) of a block of
    sub_total samples. Returns (sigma history [(lo, hi)], clip history
    [(cl, ch)])."""
    lo_l, lo_r, hi_l, hi_r = f32(1.0), f32(11.0), f32(1.0), f32(11.0)
    hist, clips = [], []
    i = 0
    while True:
        lo_m = f32(0.5) * (lo_l + lo_r)
        hi_m = f32(0.5) * (hi_l + hi_r)
        cl, ch = clips_at(lo_m, hi_m)
        hist.append((lo_m, hi_m))
        clips.append((cl, ch))
        delta_l = _round_perc(cl, sub_total, target_l)
        delta_h = _round_perc(ch, sub_total, target_h)
        converged = delta_l == 0 and delta_h == 0
        # more clipping than target -> raise sigma (clip less); vice versa
        if delta_l > 0:
            lo_l = lo_m
        elif delta_l < 0:
            lo_r = lo_m
        if delta_h > 0:
            hi_l = hi_m
        elif delta_h < 0:
            hi_r = hi_m
        running = not converged and i < max_iter
        i += 1
        if not running:
            return hist, clips


def _newton_search(clips_at, sub_total, target_l, target_h, max_iter):
    """Newton goal-seek for linear fit (newtonMethodAndStack,
    stackfindsigma.go:101-169, with the high side held to the high target),
    over the evaluator clips_at as in _binary_search. Returns (sigma
    history, clip history)."""
    eps = f32(0.005)
    st = f32(sub_total)
    sl, sh = f32(6.0), f32(6.0)
    hist, clips = [], []
    i = 0
    while True:
        cl, ch = clips_at(sl, sh)
        perc_l = f32(cl) * f32(100.0) / st
        perc_h = f32(ch) * f32(100.0) / st
        delta_l = perc_l - f32(target_l / 100.0)
        delta_h = perc_h - f32(target_h / 100.0)
        d_li = int(np.floor(f32(100.0) * delta_l + f32(0.5)))
        d_hi = int(np.floor(f32(100.0) * delta_h + f32(0.5)))
        hist.append((sl, sh))
        clips.append((cl, ch))
        converged = d_li == 0 and d_hi == 0
        cl2, _ = clips_at(sl + eps, sh)
        _, ch3 = clips_at(sl, sh + eps)
        d_l_diff = (f32(cl2) - f32(cl)) * f32(100.0) / st / eps
        d_h_diff = (f32(ch3) - f32(ch)) * f32(100.0) / st / eps
        stuck = d_l_diff == 0.0 or d_h_diff == 0.0
        new_sl = f32(np.clip(sl - delta_l / (d_l_diff if d_l_diff != 0.0 else f32(1.0)),
                             f32(0.1), f32(20.0)))
        new_sh = f32(np.clip(sh - delta_h / (d_h_diff if d_h_diff != 0.0 else f32(1.0)),
                             f32(0.1), f32(20.0)))
        running = not (converged or stuck) and i < max_iter
        i += 1
        if not running:
            return hist, clips
        sl, sh = new_sl, new_sh


def _evaluator(frames, mode, weights, ref_frame_loc, subsample, mesh):
    """(clips_at, sub_total) of one search: over the whole block, or with
    a mesh over each shard's block. The sharded subsample is each shard's
    part of the global stride-17 pattern (the pixels whose flat index in
    the whole frame divides by 17), so the shards together count the
    unsharded subsample's clips and a sharded search takes the unsharded
    one's steps; the sample total is the unsharded one. (JAX's shard_map
    hands its search the local block, which subsamples other pixels than
    its unsharded search.)"""
    total = frames.numel()
    sub_total = float(total)
    if mesh is None:
        if subsample:
            frames, sub_total = _search_subsample(frames, total)
        return _clips_fn([frames], None, mode, weights, ref_frame_loc), sub_total
    subs = pm.shard_rows(mesh, frames).blocks
    p = math.prod(frames.shape[1:])
    if subsample and p >= 4 * _SEARCH_STRIDE:
        local = subs[0][0].numel()
        subs = [b.reshape(b.shape[0], -1)[:, (-k * local) % _SEARCH_STRIDE::_SEARCH_STRIDE]
                .contiguous() for k, b in enumerate(subs)]
        sub_total = total * (-(-p // _SEARCH_STRIDE) / p)
    return _clips_fn(subs, mesh, mode, weights, ref_frame_loc), sub_total


@trace.span("stack")
def find_sigmas_and_stack(frames, mode: stk.StackMode, weights=None, ref_frame_loc: float = 0.0,
                          clip_perc_low: float = 0.5, clip_perc_high: float = 0.5,
                          max_iter: int = 20, log=None, mesh=None, axis: str = "pix"):
    """Goal-seek sigma_low/sigma_high until the clip percentages match the
    targets (to 0.01%), then stack at those sigmas. frames: (N, ...).
    Returns (stacked, clip_lo, clip_hi, sigma_low, sigma_high).

    With `mesh` set and a row count that divides it, the whole search runs
    row-sharded: each round launches every shard's stack and makes one
    host decision on the summed counts (_clips_fn), and the final
    full-resolution stack is stack_sharded, its image RowSharded."""
    mode = stk.StackMode(mode)
    if mode == stk.StackMode.Auto:
        mode = stk.auto_select_mode(frames.shape[0])
    shardable = (mesh is not None and frames.dim() >= 3
                 and frames.shape[1] % mesh.size == 0)
    if not shardable:
        mesh, frames = None, pm.gather(frames)
    if mode not in (stk.StackMode.Sigma, stk.StackMode.WinsorSigma, stk.StackMode.LinearFit):
        out, cl, ch = stk.stack(frames, mode, weights=weights, ref_frame_loc=ref_frame_loc,
                                mesh=mesh, axis=axis)
        return out, int(trace.to_host(cl)), int(trace.to_host(ch)), 0.0, 0.0

    total = frames.numel()
    target_l, target_h = int(100 * clip_perc_low), int(100 * clip_perc_high)
    # gated on the GLOBAL pixel count, so sharded and unsharded runs of the
    # same data decide alike
    big = math.prod(frames.shape[1:]) >= _SEARCH_SUBSAMPLE_MIN

    def run(search, subsample=True):
        clips_at, sub_total = _evaluator(frames, mode, weights, ref_frame_loc,
                                         subsample and big, mesh)
        hist, clips = search(clips_at, sub_total, target_l, target_h, max_iter)
        # one full-resolution stack at the accepted sigmas: the output and
        # the exact counts, which replace the last history entry
        lo, hi = hist[-1]
        out, cl, ch = stk.stack(frames, mode, weights=weights, sigma_low=lo, sigma_high=hi,
                                ref_frame_loc=ref_frame_loc, mesh=mesh, axis=axis)
        clips[-1] = (int(trace.to_host(cl)), int(trace.to_host(ch)))
        return out, hist, clips

    def final_deltas(clips):
        cl0, ch0 = clips[-1]
        return (int(100.0 * cl0 * 100.0 / total + 0.5) - target_l,
                int(100.0 * ch0 * 100.0 / total + 0.5) - target_h)

    search = _newton_search if mode == stk.StackMode.LinearFit else _binary_search
    out, hist, clips = run(search)
    if mode == stk.StackMode.LinearFit and final_deltas(clips) != (0, 0):
        if log:
            log.write("Newton method off target, retrying with binary search\n")
        search = _binary_search
        out, hist, clips = run(search)
    if big and final_deltas(clips) != (0, 0):
        if log:
            log.write("Subsampled goal-seek off target, repeating at full resolution\n")
        out, hist, clips = run(search, subsample=False)

    if log:
        for i, (lo_mid, hi_mid) in enumerate(hist):
            log.write(f"Step {i}: stSigLow {float(lo_mid):.2f} stSigHigh {float(hi_mid):.2f}\n")
    cl, ch = clips[-1]
    lo_mid, hi_mid = float(hist[-1][0]), float(hist[-1][1])
    delta_l, delta_h = final_deltas(clips)
    if log:
        if delta_l == 0 and delta_h == 0:
            log.write(f"Reached {clip_perc_low:.2f}% and {clip_perc_high:.2f}% clipping. "
                      f"Settings are -stSigLow {lo_mid:.3f} -stSigHigh {hi_mid:.3f}\n")
        else:
            method = "Newton method" if mode == stk.StackMode.LinearFit else "Binary search"
            log.write(f"Warning: {method} did not converge, proceeding with "
                      f"last approximation {lo_mid:.2f} and {hi_mid:.2f}\n")
    return out, cl, ch, lo_mid, hi_mid


def search_histories(frames, mode: stk.StackMode, weights=None, ref_frame_loc: float = 0.0,
                     clip_perc_low: float = 0.5, clip_perc_high: float = 0.5,
                     max_iter: int = 20, subsample: bool = False):
    """The raw search of one method without the finalization: (sigma
    history, clip history). For tests that hold the port's search against
    the JAX package's round by round."""
    mode = stk.StackMode(mode)
    search = _newton_search if mode == stk.StackMode.LinearFit else _binary_search
    clips_at, sub_total = _evaluator(frames, mode, weights, ref_frame_loc, subsample, None)
    return search(clips_at, sub_total, int(100 * clip_perc_low), int(100 * clip_perc_high),
                  max_iter)
