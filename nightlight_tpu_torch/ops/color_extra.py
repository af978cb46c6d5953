"""Auxiliary colour components, mirror of nightlight_tpu/ops/color_extra.py:
OkLab/OkHcl on (3, ...) float32 tensors and the B-V star colour table.

Rebuild of the reference's extra colour utilities (reference:
internal/fits/oklab.go, bv.go). Neither is wired into pipeline operators in
the reference either; they are library surface. The matrix rows round as
XLA's CPU code contracts them (ops/color.py _apply3x3; the operand order
of each row's first sum measured per matrix), cbrt, atan2, sin and cos as
ops/color.py evaluates them, so the conversions differ from the JAX
package only where one of those rounds a float32 step apart.
"""

from __future__ import annotations

import numpy as np
import torch

from nightlight_tpu_torch.ops.color import _RAD, _apply3x3, _atan2_deg, _c, _cbrt, _sin_cos
from nightlight_tpu_torch.ops.pixelmath import fma32

# OkLab matrices (bottosson.github.io/posts/oklab, as used in oklab.go:48-77)
_M1 = np.array([
    [0.4122214708, 0.5363325363, 0.0514459929],
    [0.2119034982, 0.6806995451, 0.1073969566],
    [0.0883024619, 0.2817188376, 0.6299787005],
], np.float32)
_M2 = np.array([
    [0.2104542553, 0.7936177850, -0.0040720468],
    [1.9779984951, -2.4285922050, 0.4505937099],
    [0.0259040371, 0.7827717662, -0.8086757660],
], np.float32)
_M2_INV = np.array([
    [1.0, 0.3963377774, 0.2158037573],
    [1.0, -0.1055613458, -0.0638541728],
    [1.0, -0.0894841775, -1.2914855480],
], np.float32)
_M1_INV = np.array([
    [4.0767416621, -3.3077115913, 0.2309699292],
    [-1.2684380046, 2.6097574011, -0.3413193965],
    [-0.0041960863, -0.7034186147, 1.7076147010],
], np.float32)


def linrgb_to_oklab(rgb: torch.Tensor) -> torch.Tensor:
    """(3, ...) linear sRGB in [0,1] -> OkLab (oklab.go:36-61).
    Inputs are clamped to [0,1] like the reference."""
    lms = _apply3x3(_M1, rgb.clamp(0.0, 1.0), (0, 0, 0))
    return _apply3x3(_M2, _cbrt(lms), (0, 0, 0))


def oklab_to_linrgb(lab: torch.Tensor) -> torch.Tensor:
    """OkLab -> linear sRGB (oklab.go:63-77)."""
    lms3 = _apply3x3(_M2_INV, lab, (1, 1, 1))
    return _apply3x3(_M1_INV, lms3 * lms3 * lms3, (0, 1, 0))


def oklab_to_okhcl(lab: torch.Tensor) -> torch.Tensor:
    """OkLab -> (H deg, C, L) (oklab.go:84-88)."""
    l, a, b = lab[0], lab[1], lab[2]
    # the square root correctly rounded, as XLA's is (torch's float32 sqrt
    # on the CPU is a step off on about 1% of inputs)
    c = torch.sqrt(fma32(a, a, b * b).to(torch.float64)).to(torch.float32)
    return torch.stack([_atan2_deg(b, a), c, l])


def okhcl_to_oklab(hcl: torch.Tensor) -> torch.Tensor:
    """(H deg, C, L) -> OkLab (oklab.go:90-95)."""
    sin_h, cos_h = _sin_cos(hcl[0] * _c(_RAD, hcl))
    c, l = hcl[1], hcl[2]
    return torch.stack([l, c * cos_h, c * sin_h])


# B-V color index -> RGB lookup (bv.go:20-97); 49 entries for -0.4..2.0 in
# 0.05 steps, from vendian.org/mncharity starcolor data.
_BV_TABLE = np.array([
    [0.60784, 0.69804, 1.00000], [0.61961, 0.70980, 1.00000],
    [0.63922, 0.72549, 1.00000], [0.66667, 0.74902, 1.00000],
    [0.69804, 0.77255, 1.00000], [0.73333, 0.80000, 1.00000],
    [0.76863, 0.82353, 1.00000], [0.80000, 0.84706, 1.00000],
    [0.82745, 0.86667, 1.00000], [0.85490, 0.88627, 1.00000],
    [0.87451, 0.89804, 1.00000], [0.89412, 0.91373, 1.00000],
    [0.91373, 0.92549, 1.00000], [0.93333, 0.93725, 1.00000],
    [0.95294, 0.94902, 1.00000], [0.97255, 0.96471, 1.00000],
    [0.99608, 0.97647, 1.00000], [1.00000, 0.97647, 0.98431],
    [1.00000, 0.96863, 0.96078], [1.00000, 0.96078, 0.93725],
    [1.00000, 0.95294, 0.91765], [1.00000, 0.94510, 0.89804],
    [1.00000, 0.93725, 0.87843], [1.00000, 0.92941, 0.85882],
    [1.00000, 0.92157, 0.83922], [1.00000, 0.91373, 0.82353],
    [1.00000, 0.90980, 0.80784], [1.00000, 0.90196, 0.79216],
    [1.00000, 0.89804, 0.77647], [1.00000, 0.89020, 0.76471],
    [1.00000, 0.88627, 0.74902], [1.00000, 0.87843, 0.73333],
    [1.00000, 0.87451, 0.72157], [1.00000, 0.86667, 0.70588],
    [1.00000, 0.85882, 0.69020], [1.00000, 0.85490, 0.67843],
    [1.00000, 0.84706, 0.66275], [1.00000, 0.83922, 0.64706],
    [1.00000, 0.83529, 0.63137], [1.00000, 0.82353, 0.61176],
    [1.00000, 0.81569, 0.58824], [1.00000, 0.80000, 0.56078],
    [1.00000, 0.78431, 0.52157], [1.00000, 0.75686, 0.47059],
    [1.00000, 0.71765, 0.39608], [1.00000, 0.66275, 0.29412],
    [1.00000, 0.58431, 0.13725], [1.00000, 0.48235, 0.00000],
    [1.00000, 0.32157, 0.00000],
], np.float32)


def bv_to_rgb(bv) -> np.ndarray:
    """Star color index (B-V, -0.4..2.0) -> RGB via table interpolation
    (bv.go:20-47). Accepts scalar or array; returns (..., 3), on the host
    as in the JAX package."""
    bv = np.clip(np.asarray(bv, np.float32), -0.4, 2.0)
    index = (bv + 0.4) * 20.0
    floor = np.minimum(index.astype(np.int32), len(_BV_TABLE) - 1)
    ceil = np.minimum(floor + 1, len(_BV_TABLE) - 1)
    frac = (index - floor)[..., None]
    return _BV_TABLE[floor] * (1 - frac) + _BV_TABLE[ceil] * frac
