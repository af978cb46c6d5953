"""Stacking engine of the port, mirror of nightlight_tpu/ops/stack.py
(reference: internal/ops/stack/stack.go): the modes, the auto rule, the
weights, the mean modes and the dispatch to the clip kernels.

NaN marks a missing sample. Sigma and winsorized clipping (K1) and linear
fit (K2) run in ops/stack_cuda.py; median and MAD clipping (the TPU
package's single-pass kernel) are not ported yet.
"""

from __future__ import annotations

from enum import IntEnum

import numpy as np
import torch

from nightlight_tpu_torch.ops import stack_cuda


class StackMode(IntEnum):
    """Stacking modes (stack.go:33-42)."""

    Median = 0
    Mean = 1
    Sigma = 2
    WinsorSigma = 3
    MADSigma = 4
    LinearFit = 5
    Auto = 6


class StackWeighting(IntEnum):
    """Weighting modes (stack.go:57-63)."""

    NoWeight = 0
    Exposure = 1
    InverseNoise = 2
    InverseHFR = 3


def auto_select_mode(num_frames: int) -> StackMode:
    """Frame-count based auto mode (stack.go:45-55)."""
    if num_frames >= 25:
        return StackMode.LinearFit
    if num_frames >= 15:
        return StackMode.WinsorSigma
    if num_frames >= 6:
        return StackMode.Sigma
    return StackMode.Mean


def stack_mean(frames: torch.Tensor, ref_frame_loc: float) -> torch.Tensor:
    """NaN-skipping mean of a (N, P) block (stack.go:307-333)."""
    valid = ~torch.isnan(frames)
    cnt = valid.sum(0)
    s = torch.where(valid, frames, 0.0).sum(0)
    return torch.where(cnt == 0, torch.tensor(float(ref_frame_loc), device=frames.device),
                       s / cnt.clamp(min=1))


def stack_mean_weighted(frames: torch.Tensor, weights: torch.Tensor,
                        ref_frame_loc: float) -> torch.Tensor:
    """NaN-skipping weighted mean (stack.go:337-366)."""
    valid = ~torch.isnan(frames)
    w = torch.where(valid, weights[:, None], 0.0)
    ws = w.sum(0)
    s = (torch.where(valid, frames, 0.0) * weights[:, None]).sum(0)
    return torch.where(ws == 0, torch.tensor(float(ref_frame_loc), device=frames.device),
                       s / torch.where(ws == 0, torch.ones((), device=frames.device), ws))


def stack(frames: torch.Tensor, mode: StackMode, weights=None, sigma_low: float = 2.75,
          sigma_high: float = 2.75, ref_frame_loc: float = 0.0):
    """Stack (N, ...) frames along axis 0. Returns (stacked, clip_lo,
    clip_hi), the clip totals as 0-d int64 tensors."""
    shape = frames.shape[1:]
    flat = frames.reshape(frames.shape[0], -1)
    if not flat.is_contiguous():
        flat = flat.contiguous()
    mode = StackMode(mode)
    if mode == StackMode.Auto:
        mode = auto_select_mode(frames.shape[0])
    zero = torch.zeros((), dtype=torch.int64, device=frames.device)
    if mode == StackMode.Mean:
        data = (stack_mean(flat, ref_frame_loc) if weights is None
                else stack_mean_weighted(flat, weights, ref_frame_loc))
        return data.reshape(shape), zero, zero
    if mode in (StackMode.Sigma, StackMode.WinsorSigma):
        data, cl, ch = stack_cuda.stack_sigma(flat, ref_frame_loc, sigma_low, sigma_high,
                                              weights=weights,
                                              winsorize=mode == StackMode.WinsorSigma)
        return data.reshape(shape), cl, ch
    if mode == StackMode.LinearFit:
        data, cl, ch = stack_cuda.stack_linfit(flat, ref_frame_loc, sigma_low, sigma_high)
        return data.reshape(shape), cl, ch
    if mode in (StackMode.Median, StackMode.MADSigma):
        raise NotImplementedError(
            f"stacking mode {int(mode)} needs the median/MAD kernel, which is not "
            "ported yet (queued in ROADMAP.md)")
    raise ValueError(f"invalid stacking mode {mode}")


def stack_incremental(acc, light: torch.Tensor, weight: float):
    """Weighted running sum for a stack of stacks (stack.go:924-937)."""
    w = torch.tensor(float(weight), dtype=torch.float32, device=light.device)
    return light * w if acc is None else acc + light * w


def stack_incremental_finalize(acc: torch.Tensor, weight_sum: float) -> torch.Tensor:
    """Divide by the total weight (stack.go:940-944)."""
    return acc * torch.tensor(1.0 / weight_sum, dtype=torch.float32, device=acc.device)


def get_weights(images, weighting: StackWeighting, device="cpu"):
    """Per-frame weights from image metadata (stack.go:231-270) as a
    float32 tensor on `device`, or None."""
    weighting = StackWeighting(weighting)
    if weighting == StackWeighting.NoWeight:
        return None
    if weighting == StackWeighting.Exposure:
        ws = []
        for f in images:
            if f.exposure == 0:
                raise ValueError(f"{f.id}: Missing exposure information for "
                                 "exposure-weighted stacking")
            ws.append(f.exposure)
    elif weighting in (StackWeighting.InverseNoise, StackWeighting.InverseHFR):
        xs = ([f.stats.noise for f in images] if weighting == StackWeighting.InverseNoise
              else [f.hfr for f in images])
        lo, hi = min(xs), max(xs)
        rng = hi - lo if hi > lo else 1.0
        ws = [1.0 / (1.0 + 4.0 * (x - lo) / rng) for x in xs]
    else:
        raise ValueError(f"Invalid weighting mode {weighting}")
    return torch.as_tensor(np.array(ws, np.float32), device=device)
