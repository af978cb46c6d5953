"""Gaussian blur and unsharp masking, mirror of nightlight_tpu/ops/gauss.py
(reference: internal/ops/stretch/usm.go). The kernel is made on the host by
integrating the gaussian through erf with a 1% truncation budget
(usm.go:41-82); the convolution runs on the device as two 1-D passes of
shifted adds in the JAX package's order, over a symmetric ("reflect
including the edge") border (usm.go:25-33). It is not a conv2d: cuDNN would
sum in another order, and in TF32 where that is allowed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nightlight_tpu_torch.ops.pixelmath import fma32


def gaussian_definite_integral(mu: float, sigma: float, x: float) -> float:
    """Integral of the gaussian pdf up to x (usm.go:36-38)."""
    return 0.5 * (1.0 + math.erf((x - mu) / (math.sqrt(2.0) * sigma)))


def gaussian_kernel_1d(sigma: float) -> np.ndarray:
    """1-D kernel by symbolic integration, 1% truncation budget, mirrored
    right half, normalized (usm.go:41-82)."""
    mu = 0.0
    accept_out = 0.01
    radius = 0
    while True:
        val = gaussian_definite_integral(mu, sigma, -0.5 - radius)
        if val < accept_out:
            radius -= 1
            break
        radius += 1
    width = 2 * radius + 1
    kernel = np.zeros(width, np.float32)

    total = 0.0
    lower = gaussian_definite_integral(mu, sigma, -0.5 - radius)
    for i in range(radius + 1):
        upper = gaussian_definite_integral(mu, sigma, -0.5 - radius + i + 1)
        delta = upper - lower
        kernel[i] = delta
        total += delta
        lower = upper
    for i in range(1, radius + 1):
        kernel[radius + i] = kernel[radius - i]
        total += kernel[radius - i]
    kernel *= 1.0 / total
    return kernel


def _symmetric_index(n: int, k: int, device) -> torch.Tensor:
    """Source indices of an axis of length n padded by k on both sides in
    numpy's "symmetric" mode (-1 -> 0, n -> n - 1)."""
    i = np.arange(-k, n + k)
    period = 2 * n
    i = np.mod(i, period)
    i = np.where(i >= n, period - 1 - i, i)
    return torch.from_numpy(i.astype(np.int64)).to(device)


def _weighted_sum(kernel: torch.Tensor, parts) -> torch.Tensor:
    """sum_i kernel[i] * parts(i), rounded as XLA's CPU code rounds the
    JAX package's loop: its first two terms contracted into
    fma(k0, p0, k1*p1), then one fused multiply-add a term."""
    acc = kernel[0] * parts(0) if kernel.shape[0] == 1 else fma32(
        kernel[0], parts(0), kernel[1] * parts(1))
    for i in range(2, kernel.shape[0]):
        acc = fma32(kernel[i], parts(i), acc)
    return acc


def _convolve_sym(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Separable 2-D convolution with a symmetric border (usm.go:85-122):
    the x pass, then the y pass, each a sum of kernel-weighted shifted
    copies in kernel order (_weighted_sum)."""
    k = kernel.shape[0] // 2
    h, w = img.shape
    padded = img.index_select(1, _symmetric_index(w, k, img.device))
    x = _weighted_sum(kernel, lambda i: padded[:, i:i + w])
    padded = x.index_select(0, _symmetric_index(h, k, img.device))
    return _weighted_sum(kernel, lambda i: padded[i:i + h, :])


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Gaussian blur (usm.go:126-130)."""
    kernel = torch.from_numpy(gaussian_kernel_1d(sigma)).to(img.device)
    return _convolve_sym(img, kernel)


def unsharp_mask(img: torch.Tensor, sigma: float, gain: float, vmin, vmax,
                 abs_threshold) -> torch.Tensor:
    """USM: d + (d - blur)*gain above the threshold, clipped to [vmin, vmax]
    (usm.go:134-159)."""
    blurred = gaussian_blur(img, sigma)

    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32).to(img.device)

    # img + (img - blur)*gain as the fused multiply-add XLA makes of it
    sharp = torch.minimum(torch.maximum(fma32(img - blurred, f32(gain), img), f32(vmin)),
                          f32(vmax))
    return torch.where(img < f32(abs_threshold), img, sharp)
