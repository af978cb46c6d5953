"""Shift-blend bilinear warp: kernel K7 beside its plain PyTorch version.

The CUDA source is ``csrc/warp_shift.cu`` (its per-pixel arithmetic in
``csrc/warp_shift.cuh``); it replaces no TPU kernel, the JAX package's
shift-blend warp being XLA. The plain version is ops/resample.py
``_warp_shift``, a blend of integer-shifted slices of the frame; the kernel
computes the same function bit for bit in one pass over the destination.

The wrapper runs the plain version only for a tensor on the CPU. A CUDA
tensor goes to the kernel, or the wrapper raises.
"""

from __future__ import annotations

import numpy as np
import torch

from nightlight_tpu_torch import kernels


def warp_shift(img: torch.Tensor, inv, out_of_bounds: float, kmin: int, mmin: int,
               dest_h: int, dest_w: int, n_kshift: int, n_mshift: int, row0: int = 0,
               rows: int | None = None, src_row0: int = 0, src_h: int | None = None,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """Destination rows [row0, row0 + rows) (all by default) of the warp of
    `img` under the inverse transform `inv` with the shift plan (kmin,
    mmin, n_kshift, n_mshift): the arguments of resample._warp_shift. Into
    `out` (rows, dest_w) when given, which must not overlap `img`."""
    if img.device.type == "cpu":
        # resample imports this module
        from nightlight_tpu_torch.ops.resample import _warp_shift

        res = _warp_shift(img, inv, out_of_bounds, kmin, mmin, dest_h, dest_w, n_kshift,
                          n_mshift, row0=row0, rows=rows, src_row0=src_row0, src_h=src_h)
        return res if out is None else out.copy_(res)
    return warp_shift_cuda(img, inv, out_of_bounds, kmin, mmin, dest_h, dest_w, n_kshift,
                           n_mshift, row0, rows, src_row0, src_h, out)


def warp_shift_cuda(img, inv, out_of_bounds: float, kmin: int, mmin: int, dest_h: int,
                    dest_w: int, n_kshift: int, n_mshift: int, row0: int = 0,
                    rows: int | None = None, src_row0: int = 0, src_h: int | None = None,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    if img.dim() != 2:
        raise ValueError(f"warp_shift: expected a (H, W) image, got {tuple(img.shape)}")
    h, w = img.shape
    src_h = h if src_h is None else src_h
    rows = dest_h - row0 if rows is None else rows
    # the in-frame source rows the slices read must lie within the block
    lo = row0 + mmin
    a, b = max(lo, 0), min(lo + rows + n_mshift - 1, src_h)
    if a < b and (a < src_row0 or b > src_row0 + h):
        raise ValueError(f"warp_shift: source rows {a}..{b} outside the block "
                         f"{src_row0}..{src_row0 + h}")
    img = img.contiguous()
    kernels.require_cuda(img, "warp_shift", torch.float32)
    if out is None:
        out = torch.empty((rows, dest_w), dtype=torch.float32, device=img.device)
    else:
        kernels.require_cuda(out, "warp_shift out", torch.float32)
        if tuple(out.shape) != (rows, dest_w) or out.device != img.device:
            raise ValueError(f"warp_shift: out {tuple(out.shape)} on {out.device}, expected "
                             f"({rows}, {dest_w}) on {img.device}")
    inv32 = [float(v) for v in np.asarray(inv, np.float32)]
    err = kernels.library().nl_warp_shift(
        img.data_ptr(), h, w, int(src_row0), int(src_h), *inv32, float(out_of_bounds),
        int(kmin), int(mmin), int(n_kshift), int(n_mshift), int(row0), int(rows), int(dest_w),
        out.data_ptr(), *kernels.launch_on(img.device))
    kernels.check(err, "warp_shift")
    kernels.count_launch("warp_shift")
    return out
