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
and one read of the clip totals per round. All bracket and percentage
arithmetic is float32, as in the JAX package's device loop, so both take
the same decisions on the same counts. Clip counts are int64 throughout.
"""

from __future__ import annotations

import numpy as np

from nightlight_tpu_torch.ops import stack as stk

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


def _clips(sub, mode, weights, ref_frame_loc, sig_lo, sig_hi):
    _, cl, ch = stk.stack(sub, stk.StackMode(mode), weights=weights, sigma_low=sig_lo,
                          sigma_high=sig_hi, ref_frame_loc=ref_frame_loc)
    return int(cl), int(ch)


def _round_perc(clips: int, sub_total: float, target: int) -> int:
    perc = f32(clips) * f32(100.0) / f32(sub_total)
    return int(np.floor(f32(100.0) * perc + f32(0.5))) - target


def _binary_search(frames, weights, ref_frame_loc, target_l, target_h, mode, max_iter,
                   subsample):
    """Dual binary search (binarySearchAndStack, stackfindsigma.go:49-100).
    Returns (sigma history [(lo, hi)], clip history [(cl, ch)])."""
    total = frames.numel()
    sub, sub_total = _search_subsample(frames, total) if subsample else (frames, float(total))
    lo_l, lo_r, hi_l, hi_r = f32(1.0), f32(11.0), f32(1.0), f32(11.0)
    hist, clips = [], []
    i = 0
    while True:
        lo_m = f32(0.5) * (lo_l + lo_r)
        hi_m = f32(0.5) * (hi_l + hi_r)
        cl, ch = _clips(sub, mode, weights, ref_frame_loc, lo_m, hi_m)
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


def _newton_search(frames, weights, ref_frame_loc, target_l, target_h, mode, max_iter,
                   subsample):
    """Newton goal-seek for linear fit (newtonMethodAndStack,
    stackfindsigma.go:101-169, with the high side held to the high target).
    Returns (sigma history, clip history)."""
    total = frames.numel()
    sub, sub_total = _search_subsample(frames, total) if subsample else (frames, float(total))
    eps = f32(0.005)
    st = f32(sub_total)
    sl, sh = f32(6.0), f32(6.0)
    hist, clips = [], []
    i = 0
    while True:
        cl, ch = _clips(sub, mode, weights, ref_frame_loc, sl, sh)
        perc_l = f32(cl) * f32(100.0) / st
        perc_h = f32(ch) * f32(100.0) / st
        delta_l = perc_l - f32(target_l / 100.0)
        delta_h = perc_h - f32(target_h / 100.0)
        d_li = int(np.floor(f32(100.0) * delta_l + f32(0.5)))
        d_hi = int(np.floor(f32(100.0) * delta_h + f32(0.5)))
        hist.append((sl, sh))
        clips.append((cl, ch))
        converged = d_li == 0 and d_hi == 0
        cl2, _ = _clips(sub, mode, weights, ref_frame_loc, sl + eps, sh)
        _, ch3 = _clips(sub, mode, weights, ref_frame_loc, sl, sh + eps)
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


def find_sigmas_and_stack(frames, mode: stk.StackMode, weights=None, ref_frame_loc: float = 0.0,
                          clip_perc_low: float = 0.5, clip_perc_high: float = 0.5,
                          max_iter: int = 20, log=None):
    """Goal-seek sigma_low/sigma_high until the clip percentages match the
    targets (to 0.01%), then stack at those sigmas. frames: (N, ...).
    Returns (stacked, clip_lo, clip_hi, sigma_low, sigma_high)."""
    mode = stk.StackMode(mode)
    if mode == stk.StackMode.Auto:
        mode = stk.auto_select_mode(frames.shape[0])
    if mode not in (stk.StackMode.Sigma, stk.StackMode.WinsorSigma, stk.StackMode.LinearFit):
        out, cl, ch = stk.stack(frames, mode, weights=weights, ref_frame_loc=ref_frame_loc)
        return out, int(cl), int(ch), 0.0, 0.0

    total = frames.numel()
    target_l, target_h = int(100 * clip_perc_low), int(100 * clip_perc_high)
    big = frames[0].numel() >= _SEARCH_SUBSAMPLE_MIN

    def run(search, subsample=True):
        hist, clips = search(frames, weights, ref_frame_loc, target_l, target_h, int(mode),
                             max_iter, subsample and big)
        # one full-resolution stack at the accepted sigmas: the output and
        # the exact counts, which replace the last history entry
        lo, hi = hist[-1]
        out, cl, ch = stk.stack(frames, mode, weights=weights, sigma_low=lo, sigma_high=hi,
                                ref_frame_loc=ref_frame_loc)
        clips[-1] = (int(cl), int(ch))
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
    return search(frames, weights, ref_frame_loc, int(100 * clip_perc_low),
                  int(100 * clip_perc_high), int(mode), max_iter, subsample)
