"""Colour-space conversions and chroma/hue operators on (3, H, W) float32
cubes, mirror of nightlight_tpu/ops/color.py (reference:
internal/fits/pixelops.go:244-578):

* linear RGB <-> CIE XYZ (sRGB primaries, D65 white)
* XYZ <-> CIE Luv <-> HSLuv, with the HSLuv max-chroma gamut function
  evaluated from the six RGB gamut boundary lines
* XYZ <-> CIE Lab / LCh(ab) ("HCL"), xyY and CIE "HSL"
* the reference's colour-preserving clamp for HSLuv -> RGB
* chroma gamma, selective saturation, hue rotation, background
  neutralization and SCNR

H in degrees [0, 360), S/L/C in [0, 1], as go-colorful has them. Where
XLA's CPU code contracts a*b + c into a fused multiply-add, the port rounds
once too (fma32), and the hypotenuse is the JAX package's formula, so the
conversions differ from the JAX package only where a transcendental (cbrt,
pow, atan2, sin, cos) rounds a float32 step apart.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nightlight_tpu_torch.ops.pixelmath import fma32

# sRGB D65 matrices (as hsluv and go-colorful use them), rounded to float32
_M_XYZ_TO_RGB = np.array([
    [3.2409699419045214, -1.5373831775700935, -0.49861076029300328],
    [-0.96924363628087983, 1.8759675015077207, 0.041555057407175613],
    [0.055630079696993609, -0.20397695888897657, 1.0569715142428786],
], np.float32)
_M_RGB_TO_XYZ = np.array([
    [0.41239079926595948, 0.35758433938387796, 0.18048078840183429],
    [0.21263900587151036, 0.71516867876775593, 0.072192315360733715],
    [0.019330818715591851, 0.11919477979462599, 0.95053215224966058],
], np.float32)
# D65 reference white (pixelops.go:414 hSLuvD65)
_WHITE = np.array([0.95045592705167, 1.0, 1.089057750759878], np.float32)
_KAPPA = 903.2962962
_EPSILON = 0.0088564516
_REF_U = 0.19783000664283681
_REF_V = 0.468319994938791

_DEG = 180.0 / math.pi
_RAD = math.pi / 180.0
# 100 - 1e-7 is 100 in float32, as the JAX package's weakly typed bound is
_L_TOP = float(np.float32(100.0 - 1e-7))


def _c(v, like: torch.Tensor) -> torch.Tensor:
    """A float32 constant on the device of `like`."""
    return torch.as_tensor(v, dtype=torch.float32).to(like.device)


def _pow(x: torch.Tensor, e) -> torch.Tensor:
    """x ** e for a float32 exponent e, evaluated in float64 and rounded
    once: XLA's CPU pow is that close to correctly rounded (it differs from
    this on under 0.1% of inputs, from torch's float32 pow on 1.5%)."""
    return torch.pow(x.to(torch.float64), float(np.float32(e))).to(torch.float32)


def _sin_cos(theta: torch.Tensor):
    """sin and cos of float32 angles, evaluated in float64 and rounded once
    (as close to XLA's CPU code as that allows: 1.3% of inputs a step
    apart, against 5% for torch's float32 versions)."""
    t = theta.to(torch.float32).to(torch.float64)
    return torch.sin(t).to(torch.float32), torch.cos(t).to(torch.float32)


def _cdiv(x: torch.Tensor, k: float) -> torch.Tensor:
    """x / k for a constant k as XLA's CPU code computes it: x times the
    float32 reciprocal of float32(k)."""
    return x * _c(np.float32(1.0) / np.float32(k), x)


def _gamut_coefficients() -> list[tuple]:
    """Per RGB channel and t in (0, 1): the constant parts of the gamut line
    (slope numerator, intercept numerator, denominator and its offset), each
    product and sum rounded to float32 as XLA folds the constants."""
    f = np.float32
    out = []
    for c in range(3):
        m1, m2, m3 = _M_XYZ_TO_RGB[c]
        top1 = f(f(284517.0) * m1) - f(f(94839.0) * m3)
        top2 = f(f(f(838422.0) * m3) + f(f(769860.0) * m2)) + f(f(731718.0) * m1)
        bottom = f(f(632260.0) * m3) - f(f(126452.0) * m2)
        for t in (0.0, 1.0):
            out.append((top1, top2, bottom, f(769860.0 * t), f(126452.0 * t)))
    return out


_GAMUT = _gamut_coefficients()


# ---------------------------------------------------------------------------
# XYZ <-> linear RGB
# ---------------------------------------------------------------------------


def _apply3x3(m: np.ndarray, v: torch.Tensor, first: tuple) -> torch.Tensor:
    """The 3x3 colour matrix as explicit float32 linear combinations, each
    row m0*v0 + m1*v1 + m2*v2 rounded as XLA's CPU code contracts it:
    fma(m2, v2, fma(m0, v0, m1*v1)) where first[row] is 0, and
    fma(m2, v2, fma(m1, v1, m0*v0)) where it is 1 (XLA orders the operands
    of each row's first sum its own way)."""
    rows = []
    for r in range(3):
        m0, m1, m2 = (_c(x, v) for x in m[r])
        head = (fma32(m0, v[0], m1 * v[1]) if first[r] == 0 else fma32(m1, v[1], m0 * v[0]))
        rows.append(fma32(m2, v[2], head))
    return torch.stack(rows)


def linrgb_to_xyz(rgb: torch.Tensor) -> torch.Tensor:
    """(3, ...) linear RGB -> XYZ."""
    return _apply3x3(_M_RGB_TO_XYZ, rgb, (0, 0, 0))


def xyz_to_linrgb(xyz: torch.Tensor) -> torch.Tensor:
    return _apply3x3(_M_XYZ_TO_RGB, xyz, (0, 1, 0))


def srgb_compand(lin: torch.Tensor) -> torch.Tensor:
    """Linear -> sRGB companding (go-colorful delinearize)."""
    powed = _pow(lin.clamp(min=0.0), 1 / 2.4)
    return torch.where(lin <= 0.0031308, _c(12.92, lin) * lin,
                       fma32(_c(1.055, lin), powed, _c(-0.055, lin)))


def srgb_uncompand(s: torch.Tensor) -> torch.Tensor:
    return torch.where(s <= 0.04045, _cdiv(s, 12.92),
                       _pow(_cdiv(s + _c(0.055, s), 1.055).clamp(min=0.0), 2.4))


# ---------------------------------------------------------------------------
# Luv / HSLuv
# ---------------------------------------------------------------------------


def _y_to_l(y: torch.Tensor) -> torch.Tensor:
    """CIE Y (relative, [0, 1]) -> L* in [0, 100]."""
    cbrt = _cbrt(y.clamp(min=0.0))
    return torch.where(y <= _c(_EPSILON, y), y * _c(_KAPPA, y),
                       fma32(_c(116.0, y), cbrt, _c(-16.0, y)))


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Cube root of x >= 0 as XLA's CPU code computes it: x ** float32(1/3)
    (a correctly rounded cube root differs from it on 12% of inputs)."""
    return _pow(x, 1.0 / 3.0)


def _l_to_y(l: torch.Tensor) -> torch.Tensor:
    t = _cdiv(l + _c(16.0, l), 116.0)
    return torch.where(l <= 8.0, _cdiv(l, _KAPPA), t * (t * t))


def xyz_to_luv(xyz: torch.Tensor) -> torch.Tensor:
    """XYZ -> (L, u, v) with L in [0, 100]."""
    x, y, z = xyz[0], xyz[1], xyz[2]
    denom = fma32(_c(3.0, z), z, fma32(_c(15.0, y), y, x))
    zero = denom == 0.0
    safe = torch.where(zero, _c(1.0, denom), denom)
    up = torch.where(zero, _c(0.0, x), _c(4.0, x) * x / safe)
    vp = torch.where(zero, _c(0.0, y), _c(9.0, y) * y / safe)
    l = _y_to_l(y)
    l13 = _c(13.0, l) * l
    u = l13 * (up - _c(_REF_U, up))
    v = l13 * (vp - _c(_REF_V, vp))
    return torch.stack([l, u, v])


def luv_to_xyz(luv: torch.Tensor) -> torch.Tensor:
    l, u, v = luv[0], luv[1], luv[2]
    zero = l == 0.0
    safe_l = torch.where(zero, _c(1.0, l), l)
    up = u / (_c(13.0, l) * safe_l) + _c(_REF_U, u)
    vp = v / (_c(13.0, l) * safe_l) + _c(_REF_V, v)
    y = _l_to_y(l)
    safe_vp = torch.where(vp == 0.0, _c(1.0, vp), vp)
    den = _c(4.0, vp) * safe_vp
    x = y * _c(9.0, y) * up / den
    inner = fma32(_c(-20.0, vp), vp, fma32(_c(-3.0, up), up, _c(12.0, up)))
    z = y * inner / den
    z0 = _c(0.0, l)
    return torch.stack([torch.where(zero, z0, x), torch.where(zero, z0, y),
                        torch.where(zero, z0, z)])


def _max_chroma_for_lh(l: torch.Tensor, h_deg: torch.Tensor) -> torch.Tensor:
    """HSLuv gamut boundary: the maximum chroma at (L, H), the smallest
    non-negative ray length at angle H to the six RGB gamut boundary lines
    in (u, v) space (the hsluv.org algorithm)."""
    sin_t, cos_t = _sin_cos(h_deg * _c(_RAD, h_deg))
    lp = l + _c(16.0, l)
    sub1 = _cdiv((lp * lp) * lp, 1560896.0)
    sub2 = torch.where(sub1 > _c(_EPSILON, l), sub1, _cdiv(l, _KAPPA))
    best = torch.full_like(l, float("inf"))
    for top1, top2, bottom_k, t_top, t_bottom in _GAMUT:
        lsub = _c(top2, l) * l
        top1_v = _c(top1, l) * sub2
        if t_top:
            top2_v = fma32(lsub, sub2, -(_c(t_top, l) * l))
            bottom = fma32(_c(bottom_k, l), sub2, _c(t_bottom, l))
        else:
            top2_v = lsub * sub2
            bottom = _c(bottom_k, l) * sub2
        slope = top1_v / bottom
        denom = fma32(-slope, cos_t, sin_t)
        # intercept / denom with intercept = top2 / bottom, which XLA
        # rewrites to top2 / (bottom * denom)
        length = top2_v / (bottom * torch.where(denom == 0.0, _c(1e-30, denom), denom))
        best = torch.where((length >= 0.0) & (length < best), length, best)
    return best


def _hypot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The JAX package's hypotenuse: max * sqrt(1 + (min/max)^2), the square
    and the one added in one fused multiply-add."""
    a, b = a.abs(), b.abs()
    inf = torch.isposinf(a) | torch.isposinf(b)
    hi, lo = torch.maximum(a, b), torch.minimum(a, b)
    zero = hi == 0.0
    r = lo / torch.where(zero, _c(1.0, hi), hi)
    out = torch.where(zero, hi, hi * torch.sqrt(fma32(r, r, _c(1.0, r))))
    return torch.where(inf, _c(float("inf"), out), out)


def _atan2_deg(v: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """atan2 in degrees; XLA's float32 atan2 and this one round a step
    apart on about 16% of inputs."""
    d = torch.float64
    return torch.atan2(v.to(d), u.to(d)).to(torch.float32) * _c(_DEG, v)


def luv_to_hsluv(luv: torch.Tensor) -> torch.Tensor:
    """(L, u, v) -> (H deg, S [0, 1], L [0, 1]) per go-colorful conventions."""
    l, u, v = luv[0], luv[1], luv[2]
    c = _hypot(u, v)
    h = torch.where(c < _c(1e-8, c), _c(0.0, c), _atan2_deg(v, u))
    h = torch.where(h < 0.0, h + _c(360.0, h), h)
    mx = _max_chroma_for_lh(l.clamp(_c(1e-7, l), _c(_L_TOP, l)), h)
    grey = (l > _c(_L_TOP, l)) | (l < _c(1e-8, l))
    s = torch.where(grey, _c(0.0, c), c / mx)
    return torch.stack([h, s.clamp(0.0, 1.0), _cdiv(l, 100.0)])


def hsluv_to_luv(hsl: torch.Tensor) -> torch.Tensor:
    h, s, l01 = hsl[0], hsl[1], hsl[2]
    l = l01 * _c(100.0, l01)
    mx = _max_chroma_for_lh(l.clamp(_c(1e-7, l), _c(_L_TOP, l)), h)
    grey = (l > _c(_L_TOP, l)) | (l < _c(1e-8, l))
    c = torch.where(grey, _c(0.0, mx), mx * s)
    sin_t, cos_t = _sin_cos(h * _c(_RAD, h))
    return torch.stack([l, cos_t * c, sin_t * c])


def linrgb_to_hsluv(rgb: torch.Tensor) -> torch.Tensor:
    """Linear RGB cube -> HSLuv cube (pixelops.go:380-396)."""
    return luv_to_hsluv(xyz_to_luv(linrgb_to_xyz(rgb)))


def hsluv_to_linrgb(hsl: torch.Tensor) -> torch.Tensor:
    """HSLuv cube -> linear RGB with the colour-preserving clamp: where
    max(r, g, b) > 1, all three scale down by it (pixelops.go:401-428)."""
    rgb = xyz_to_linrgb(luv_to_xyz(hsluv_to_luv(hsl)))
    mx = rgb.amax(dim=0, keepdim=True)
    return torch.where(mx > 1.0, rgb / mx, rgb)


def mono_to_hsluv_lum(data: torch.Tensor) -> torch.Tensor:
    """Grey value -> HSLuv luminance (pixelops.go:245-256): for grey pixels
    Y equals the value, so this is the CIE L* curve scaled to [0, 1]."""
    return _cdiv(_y_to_l(data.clamp(min=0.0)), 100.0)


# ---------------------------------------------------------------------------
# Lab / HCL (CIE LCh(ab)) and xyY
# ---------------------------------------------------------------------------

_DELTA = 6.0 / 29.0


def _lab_f(t: torch.Tensor) -> torch.Tensor:
    lin = fma32(t, _c(np.float32(1.0) / np.float32(3.0 * _DELTA * _DELTA), t),
                _c(4.0 / 29.0, t))
    return torch.where(t > _c(_DELTA ** 3, t), _cbrt(t.clamp(min=0.0)), lin)


def _lab_finv(t: torch.Tensor) -> torch.Tensor:
    return torch.where(t > _c(_DELTA, t), t * (t * t),
                       _c(3.0 * _DELTA * _DELTA, t) * (t - _c(4.0 / 29.0, t)))


def xyz_to_lab(xyz: torch.Tensor) -> torch.Tensor:
    """XYZ -> Lab with go-colorful's scaling."""
    fx = _lab_f(_cdiv(xyz[0], _WHITE[0]))
    fy = _lab_f(xyz[1])
    fz = _lab_f(_cdiv(xyz[2], _WHITE[2]))
    l = fma32(_c(1.16, fy), fy, _c(-0.16, fy))
    return torch.stack([l, _c(5.0, fx) * (fx - fy), _c(2.0, fy) * (fy - fz)])


def lab_to_xyz(lab: torch.Tensor) -> torch.Tensor:
    l, a, b = lab[0], lab[1], lab[2]
    fy = _cdiv(l + _c(0.16, l), 1.16)
    fx = fma32(a, _c(0.2, a), fy)
    fz = fy - _cdiv(b, 2.0)
    return torch.stack([_lab_finv(fx) * _c(_WHITE[0], fx), _lab_finv(fy),
                        _lab_finv(fz) * _c(_WHITE[2], fz)])


def linrgb_to_hcl(rgb: torch.Tensor) -> torch.Tensor:
    """Linear RGB -> (H deg, C, L) via Lab (pixelops.go:275-290)."""
    lab = xyz_to_lab(linrgb_to_xyz(rgb))
    l, a, b = lab[0], lab[1], lab[2]
    h = _atan2_deg(b, a)
    h = torch.where(h < 0.0, h + _c(360.0, h), h)
    return torch.stack([h, _hypot(a, b), l])


def hcl_to_linrgb(hcl: torch.Tensor) -> torch.Tensor:
    """(H, C, L) -> linear RGB with the sRGB-space clamp of go-colorful's
    Clamped() (pixelops.go:319-337)."""
    h, c, l = hcl[0], hcl[1], hcl[2]
    sin_t, cos_t = _sin_cos(h * _c(_RAD, h))
    rgb = xyz_to_linrgb(lab_to_xyz(torch.stack([l, c * cos_t, c * sin_t])))
    return srgb_uncompand(srgb_compand(rgb).clamp(0.0, 1.0))


def linrgb_to_xyy(rgb: torch.Tensor) -> torch.Tensor:
    """Linear RGB -> xyY (pixelops.go:341-356); black pixels get the white
    point's chromaticity, as go-colorful gives them."""
    xyz = linrgb_to_xyz(rgb)
    total = xyz[0] + xyz[1] + xyz[2]
    zero = total == 0.0
    safe = torch.where(zero, _c(1.0, total), total)
    x = torch.where(zero, _c(0.312727, total), xyz[0] / safe)
    y = torch.where(zero, _c(0.329023, total), xyz[1] / safe)
    return torch.stack([x, y, xyz[1]])


def xyy_to_linrgb(xyy: torch.Tensor) -> torch.Tensor:
    """xyY -> linear RGB with the sRGB clamp (pixelops.go:360-375)."""
    x, y, big_y = xyy[0], xyy[1], xyy[2]
    zero = y == 0.0
    ratio = big_y / torch.where(zero, _c(1.0, y), y)
    z0 = _c(0.0, y)
    xyz = torch.stack([torch.where(zero, z0, ratio * x), torch.where(zero, z0, big_y),
                       torch.where(zero, z0, ratio * (_c(1.0, x) - x - y))])
    return srgb_uncompand(srgb_compand(xyz_to_linrgb(xyz)).clamp(0.0, 1.0))


def linrgb_to_ciehsl(rgb: torch.Tensor) -> torch.Tensor:
    """Linear RGB -> CIE "HSL": HCL with saturation c / sqrt(c^2 + l^2)
    (pixelops.go:295-313)."""
    h, c, l = linrgb_to_hcl(rgb)
    return torch.stack([h, c / torch.sqrt(fma32(c, c, fma32(l, l, _c(1e-30, l)))), l])


def ciehsl_to_linrgb(hsl: torch.Tensor) -> torch.Tensor:
    """CIE HSL -> linear RGB: c = l*s / sqrt(1 - s^2), then HCL -> RGB with
    the sRGB clamp (pixelops.go:319-337)."""
    h, s, l = hsl[0], hsl[1], hsl[2]
    c = l * s / torch.sqrt(fma32(-s, s, _c(1.0, s)).clamp(min=1e-30))
    return hcl_to_linrgb(torch.stack([h, c, l]))


def mono_to_hcl_lum(data: torch.Tensor) -> torch.Tensor:
    """Grey value -> HCL (Lab) luminance (pixelops.go:260-271)."""
    fy = _lab_f(data.clamp(min=0.0))
    return fma32(_c(1.16, fy), fy, _c(-0.16, fy))


def offset_rgb(cube: torch.Tensor, offsets) -> torch.Tensor:
    """Per-channel additive offset (pixelops.go:615-628)."""
    return cube + torch.as_tensor(offsets, dtype=torch.float32).to(cube.device)[:, None, None]


def scale_rgb(cube: torch.Tensor, scales) -> torch.Tensor:
    """Per-channel scale, clamped to <= 1 (pixelops.go:632-645)."""
    s = torch.as_tensor(scales, dtype=torch.float32).to(cube.device)[:, None, None]
    return torch.minimum(cube * s, _c(1.0, cube))


# ---------------------------------------------------------------------------
# Chroma / hue / SCNR on (H, C/S, L) cubes
# ---------------------------------------------------------------------------


def _hue_in_range(h: torch.Tensor, from_, to) -> torch.Tensor:
    """Hue range test with wraparound (pixelops.go:504-505)."""
    from_, to = np.float32(from_), np.float32(to)
    if from_ <= to:
        return (h > _c(from_, h)) & (h < _c(to, h))
    return (h > _c(from_, h)) | (h < _c(to, h))


def adjust_chroma(cube: torch.Tensor, gamma: float, threshold) -> torch.Tensor:
    """Gamma on the chroma/saturation channel where lum >= threshold
    (pixelops.go:448-455)."""
    h, c, l = cube[0], cube[1], cube[2]
    boosted = _pow(c.clamp(min=0.0), np.float32(1.0) / np.float32(gamma))
    return torch.stack([h, torch.where(l < _c(threshold, l), c, boosted), l])


def neutralize_background(cube: torch.Tensor, low, high) -> torch.Tensor:
    """Zero chroma below `low`, ramp to full above `high`
    (pixelops.go:472-484). The reference reads both bounds from Low
    (pixelops.go:473 assigns low twice), so the ramp is a step at `low`;
    the port keeps that."""
    h, c, l = cube[0], cube[1], cube[2]
    lo = hi = _c(low, l)
    zero = _c(0.0, c)
    return torch.stack([h, torch.where(l < lo, zero, torch.where(l < hi, zero, c)), l])


def adjust_chroma_for_hues(cube: torch.Tensor, from_: float, to: float,
                           factor: float) -> torch.Tensor:
    """Scale chroma for hues in (from, to), clamped to [0, 1]
    (pixelops.go:501-511)."""
    h, c, l = cube[0], cube[1], cube[2]
    scaled = (c * _c(factor, c)).clamp(0.0, 1.0)
    return torch.stack([h, torch.where(_hue_in_range(h, from_, to), scaled, c), l])


def rotate_colors(cube: torch.Tensor, from_: float, to: float, offset: float,
                  l_threshold) -> torch.Tensor:
    """Rotate hues in (from, to) by offset where lum >= threshold
    (pixelops.go:530-543)."""
    h, s, l = cube[0], cube[1], cube[2]
    sel = _hue_in_range(h, from_, to) & (l >= _c(l_threshold, l))
    return torch.stack([torch.where(sel, h + _c(offset, h), h), s, l])


def scnr(cube: torch.Tensor, factor: float) -> torch.Tensor:
    """Subtractive chroma noise reduction on green, average neutral, with
    luminance protection (pixelops.go:555-571). The cube is HSLuv."""
    rgb = hsluv_to_linrgb(cube)
    r, g, b = rgb[0], rgb[1], rgb[2]
    g2 = torch.minimum(g, _c(0.5, r) * (r + b))
    f = _c(factor, g)
    weighted = fma32(f, g2, (_c(1.0, f) - f) * g)
    new = linrgb_to_hsluv(torch.stack([r, weighted, b]))
    return torch.stack([new[0], new[1], cube[2]])
