"""Star-candidate patch gather: kernel K4 beside its plain PyTorch version.

The CUDA source is ``csrc/gather_patches.cu``; it replaces the Pallas kernel
nightlight_tpu/ops/gather_pallas.py ``gather_patches_pallas``. Output
contract of both (and of detect/stars.py ``_patches``): ``(patch, ok)`` with
patch (K, 2r+1, 2r+1) float32 windows around integer centres and ok marking
the in-frame elements. Out-of-frame patch values are unspecified (the
kernel writes 0, the plain version reads the clamped edge pixel); every
consumer masks them with ok. The kernel writes ok in the same pass as the
patch; the plain version builds it from the window offsets.

The wrapper runs the plain version only for a tensor on the CPU. A CUDA
tensor goes to the kernel, or the wrapper raises.
"""

from __future__ import annotations

import torch

from nightlight_tpu_torch import kernels


def _offsets(cys, cxs, radius: int, h: int, w: int):
    size = 2 * radius + 1
    offs = torch.arange(size, device=cys.device, dtype=torch.int64)
    yy = cys.to(torch.int64)[:, None, None] + offs[None, :, None] - radius
    xx = cxs.to(torch.int64)[:, None, None] + offs[None, None, :] - radius
    ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
    return yy, xx, ok


def patches_plain(img: torch.Tensor, cys: torch.Tensor, cxs: torch.Tensor, radius: int):
    """Index-clamped advanced-indexing gather of the windows (the plain
    version; detect/stars.py _patches)."""
    h, w = img.shape
    yy, xx, ok = _offsets(cys, cxs, radius, h, w)
    patch = img[yy.clamp(0, h - 1), xx.clamp(0, w - 1)]
    return patch, ok


def gather_patches(img: torch.Tensor, cys: torch.Tensor, cxs: torch.Tensor, radius: int):
    """(K, 2r+1, 2r+1) windows of img (H, W) around (cys, cxs) (K,)."""
    if img.dim() != 2:
        raise ValueError(f"gather_patches: expected a (H, W) image, got {tuple(img.shape)}")
    if img.device.type == "cpu":
        return patches_plain(img, cys, cxs, radius)
    return gather_patches_cuda(img, cys, cxs, radius)


def gather_patches_cuda(img, cys, cxs, radius: int):
    kernels.require_cuda(img, "gather_patches", torch.float32)
    kernels.require_cuda(cys, "gather_patches cys", torch.int32)
    kernels.require_cuda(cxs, "gather_patches cxs", torch.int32)
    if cys.shape != cxs.shape or cys.dim() != 1:
        raise ValueError("gather_patches: cys and cxs must be (K,) vectors")
    if radius < 0:
        raise ValueError("gather_patches: negative radius")
    h, w = img.shape
    k = int(cys.shape[0])
    size = 2 * radius + 1
    if k * size >= 1 << 31:
        raise ValueError(f"gather_patches: {k} candidates x {size} rows reach 2^31")
    lib = kernels.library()
    out = torch.empty((k, size, size), dtype=torch.float32, device=img.device)
    ok = torch.empty((k, size, size), dtype=torch.bool, device=img.device)
    err = lib.nl_gather_patches(img.data_ptr(), h, w, cys.data_ptr(), cxs.data_ptr(),
                                k, int(radius), out.data_ptr(), ok.data_ptr(),
                                *kernels.launch_on(img.device))
    kernels.check(err, "gather_patches")
    kernels.count_launch("gather_patches")
    return out, ok
