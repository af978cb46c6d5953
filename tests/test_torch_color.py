"""The port's colour modules and the 17 colour operators held against the
JAX package on the same seeded numpy inputs: ops/color.py, ops/rgb.py,
pixelmath.scale_offset_clamp_rgb, Stats.for_channel and its float32
accessors, then every operator of pipeline/ops_rgb.py and ops_hsl.py (log
text, data, JSON round trip).

Bands. Where XLA's CPU code contracts a*b + c, divides by a constant
through its reciprocal or rewrites (a/b)/c as a/(b*c), the port rounds the
same way, so the linear parts are bit for bit. The transcendentals are not:
the port evaluates pow, sin and cos in float64 and rounds once, which XLA's
float32 versions miss by a float32 step on under 2% of inputs, and atan2 on
about 16%. A step in a hue or in the gamut's ray length moves the results
by a few steps, more where a difference cancels (near zero), so each case
states the share of elements that may differ and by how many float32 steps
(ULP) or, near zero, by how much absolutely."""

import io

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nightlight_tpu.detect.stars import StarList as JStarList
from nightlight_tpu.image import Image as JImage
from nightlight_tpu.ops import color as jcol
from nightlight_tpu.ops import pixelmath as jpm
from nightlight_tpu.ops import rgb as jrgb
from nightlight_tpu.ops.stats import Stats as JStats
from nightlight_tpu.pipeline import context as jctx
from nightlight_tpu.pipeline import ops_hsl as jhsl
from nightlight_tpu.pipeline import ops_rgb as jops_rgb
from nightlight_tpu.pipeline.operators import op_from_dict as j_from_dict
from nightlight_tpu_torch.detect.stars import StarList as TStarList
from nightlight_tpu_torch.image import Image as TImage
from nightlight_tpu_torch.ops import color as tcol
from nightlight_tpu_torch.ops import pixelmath as tpm
from nightlight_tpu_torch.ops import rgb as trgb
from nightlight_tpu_torch.ops.stats import Stats as TStats
from nightlight_tpu_torch.pipeline import context as tctx
from nightlight_tpu_torch.pipeline import ops_hsl as thsl
from nightlight_tpu_torch.pipeline import ops_rgb as tops_rgb
from nightlight_tpu_torch.pipeline.operators import op_from_dict as t_from_dict

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _steps(a, b):
    """Distance in float32 steps (0 where both are NaN)."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    both_nan = np.isnan(a) & np.isnan(b)
    return np.where(both_nan, 0, np.abs(ia - ib))


def assert_band(got, want, share: float, steps: int, atol: float = 0.0, hue_rows=()):
    """At most `share` of the elements differ at all, none by more than
    `steps` float32 steps unless within `atol` absolutely. Rows listed in
    hue_rows are hues, compared on the circle (359.99998 and 0.0 are
    neighbours)."""
    got = np.asarray(got, np.float32).copy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    for r in hue_rows:
        wrap = np.abs(got[r] - want[r]) > 180.0
        got[r] = np.where(wrap & (got[r] > want[r]), got[r] - 360.0, got[r])
        got[r] = np.where(wrap & (got[r] < want[r]), got[r] + 360.0, got[r])
    d = _steps(got, want)
    near = np.abs(got.astype(np.float64) - want) <= atol
    far = (d > steps) & ~near
    assert not far.any(), (int(far.sum()), got[far][:5], want[far][:5], d[far][:5])
    assert np.mean(d > 0) <= share, np.mean(d > 0)


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def _linear_rgb(seed=0, h=96, w=112):
    """Uniform linear RGB with the cases the conversions branch on: black
    (L = 0, the Luv denominator 0), greys (chroma 0, hue 0), pure
    primaries, and values above 1."""
    rng = np.random.default_rng(seed)
    rgb = rng.uniform(0.0, 1.0, (3, h, w)).astype(np.float32)
    rgb[:, 0, :8] = 0.0
    rgb[:, 1, :8] = np.linspace(0.05, 1.0, 8, dtype=np.float32)
    rgb[:, 2, :3] = np.eye(3, dtype=np.float32)
    rgb[:, 3, :4] = 1.5
    rgb[:, 4, :8] = rng.uniform(0.0, 1e-3, (3, 8))
    return rgb


def _hsluv(seed=1, h=96, w=112):
    """HSLuv cubes: hues over the circle with 0 and 359.99998 among them,
    saturations and lightnesses in [0, 1] with 0 and 1 among them (1 at high
    saturation drives RGB above 1: the clamp)."""
    rng = np.random.default_rng(seed)
    hs = np.stack([rng.uniform(0.0, 360.0, (h, w)), rng.uniform(0.0, 1.0, (h, w)),
                   rng.uniform(0.0, 1.0, (h, w))]).astype(np.float32)
    hs[0, 0, :4] = [0.0, 359.99998, 180.0, 90.0]
    hs[2, 1, :4] = [0.0, 1.0, 1e-9, 0.999999]
    hs[1, 2, :4] = 1.0
    return hs


_RGB = _linear_rgb()
_HSL = _hsluv()
_Y = np.concatenate([np.linspace(0.0, 0.02, 64), np.random.default_rng(2).uniform(0, 1, 4032),
                     [-0.5, 0.0088564516, 1.0, 2.0]]).astype(np.float32)


# name, JAX function, port function, input, band (share, steps, atol), hue rows
_CONVERSIONS = [
    ("linrgb_to_xyz", _RGB, (0.0, 0, 0.0), ()),
    ("xyz_to_linrgb", np.asarray(jcol.linrgb_to_xyz(_RGB)), (0.0, 0, 0.0), ()),
    ("xyz_to_luv", np.asarray(jcol.linrgb_to_xyz(_RGB)), (0.002, 4, 0.0), ()),
    ("luv_to_xyz", np.asarray(jcol.xyz_to_luv(jcol.linrgb_to_xyz(_RGB))), (0.0, 0, 0.0), ()),
    ("linrgb_to_hsluv", _RGB, (0.08, 4, 1e-4), (0,)),
    ("hsluv_to_linrgb", _HSL, (0.04, 2, 1e-6), ()),
    ("mono_to_hsluv_lum", _Y, (0.002, 2, 0.0), ()),
    ("linrgb_to_hcl", _RGB, (0.05, 4, 1e-3), (0,)),
    ("hcl_to_linrgb", np.asarray(jcol.linrgb_to_hcl(_RGB)), (0.35, 2, 1e-6), ()),
    ("linrgb_to_xyy", _RGB, (0.0, 0, 0.0), ()),
    ("xyy_to_linrgb", np.asarray(jcol.linrgb_to_xyy(_RGB)), (0.005, 8, 0.0), ()),
    ("linrgb_to_ciehsl", _RGB, (0.25, 4, 1e-3), (0,)),
    ("ciehsl_to_linrgb", np.asarray(jcol.linrgb_to_ciehsl(_RGB)), (0.35, 2, 1e-6), ()),
    ("mono_to_hcl_lum", _Y, (0.002, 2, 0.0), ()),
    ("srgb_compand", _RGB, (0.002, 2, 0.0), ()),
    ("srgb_uncompand", _RGB, (0.002, 2, 0.0), ()),
]


@pytest.mark.parametrize("name,x,band,hue_rows", _CONVERSIONS,
                         ids=[c[0] for c in _CONVERSIONS])
def test_conversion_matches_jax(name, x, band, hue_rows):
    """Each conversion of ops/color.py on the same inputs, within its band
    (module doc): the matrix, xyY and Luv -> XYZ steps bit for bit; the
    pow-only curves a step or two apart on under 0.2%; RGB -> HSLuv, whose
    hue passes atan2, 4 steps on 8% of elements (hues near grey, where u
    and v cancel, within 1e-4 degree); HSLuv -> RGB, through sin and cos, 2
    steps on 4% (1e-6 near 0); the Lab / HCL / CIE-HSL conversions, off the
    CLI path, the same steps on up to 35% (their Lab hue within 1e-3
    degree)."""
    want = np.asarray(jax.jit(getattr(jcol, name))(jnp.asarray(x)))
    got = getattr(tcol, name)(_t(x)).numpy()
    assert_band(got, want, *band, hue_rows=hue_rows)


def test_hsluv_round_trip_and_clamp():
    """Port only: RGB -> HSLuv -> RGB restores in-gamut pixels to 1e-5, and
    the colour-preserving clamp leaves no channel above 1."""
    rgb = np.clip(_RGB, 0.0, 1.0)
    back = tcol.hsluv_to_linrgb(tcol.linrgb_to_hsluv(_t(rgb))).numpy()
    np.testing.assert_allclose(back, rgb, atol=1e-5)
    out = tcol.hsluv_to_linrgb(_t(_HSL)).numpy()
    assert out.max() <= 1.0 and np.isfinite(out).all()


def test_scnr_and_color_ops_match_jax():
    """The chroma operators on an HSLuv cube: selective saturation, the
    background step and the chroma gamma exactly where their luminance or
    hue test agrees (it does on every pixel here: no value sits on a
    bound); hue rotation exact; SCNR within the HSLuv band."""
    hs = np.asarray(jcol.linrgb_to_hsluv(_RGB))
    t = _t(hs)
    cases = [
        ("adjust_chroma_for_hues", (295.0, 40.0, 1.2)),
        ("adjust_chroma_for_hues", (100.0, 190.0, 0.5)),
        ("rotate_colors", (100.0, 190.0, -30.0, np.float32(0.3))),
        ("neutralize_background", (np.float32(0.25), np.float32(0.4))),
    ]
    for name, args in cases:
        want = np.asarray(getattr(jcol, name)(jnp.asarray(hs), *args))
        np.testing.assert_array_equal(getattr(tcol, name)(t, *args).numpy(), want, err_msg=name)
    want = np.asarray(jcol.adjust_chroma(jnp.asarray(hs), 1.75, np.float32(0.3)))
    assert_band(tcol.adjust_chroma(t, 1.75, np.float32(0.3)).numpy(), want, 0.005, 1)
    want = np.asarray(jcol.scnr(jnp.asarray(hs), 0.5))
    assert_band(tcol.scnr(t, 0.5).numpy(), want, 0.08, 16, 1e-4, hue_rows=(0,))


@pytest.mark.parametrize("fn,args", [("offset_rgb", ([0.1, -0.2, 0.3],)),
                                     ("scale_rgb", ([1.5, 0.5, 2.0],))])
def test_offset_and_scale_rgb_match_jax(fn, args):
    want = np.asarray(getattr(jcol, fn)(jnp.asarray(_RGB), jnp.asarray(args[0], jnp.float32)))
    np.testing.assert_array_equal(getattr(tcol, fn)(_t(_RGB), *args).numpy(), want)


# ---------------------------------------------------------------------------
# ops/rgb.py, pixelmath, Stats
# ---------------------------------------------------------------------------


def test_combine_and_normalization_match_jax():
    """The normalization factors and the combined cube exact."""
    rng = np.random.default_rng(3)
    planes = rng.uniform(100.0, 5000.0, (3, 64, 80)).astype(np.float32)
    mins, maxs = [float(p.min()) for p in planes], [float(p.max()) for p in planes]
    assert trgb.common_normalization_factors(mins, maxs) == jrgb.common_normalization_factors(
        mins, maxs)
    vmin, mult = jrgb.common_normalization_factors(mins, maxs)
    want = np.asarray(jrgb.combine_channels(jnp.asarray(planes), vmin, mult))
    np.testing.assert_array_equal(trgb.combine_channels(_t(planes), vmin, mult).numpy(), want)


@pytest.mark.parametrize("shape,block,border", [((3, 96, 128), 16, 0.1), ((3, 128, 128), 8, 0.0),
                                                ((3, 100, 90), 10, 0.25)])
def test_find_darkest_block_matches_jax(shape, block, border):
    """The same block (its index exact) and its mean colour within a
    float32 step (exact where the block count per row is a power of two,
    image.bin_block_mean)."""
    rng = np.random.default_rng(sum(shape))
    cube = rng.uniform(0.1, 1.0, shape).astype(np.float32)
    want = np.asarray(jrgb.find_darkest_block(jnp.asarray(cube), block, border))
    blocks, idx = trgb.darkest_block_index(_t(cube), block, border)
    got = blocks[:, idx].numpy()
    # the JAX package's index: the block whose means it returned
    j_blocks = blocks.numpy()
    j_idx = int(np.argmin(np.abs(j_blocks - want[:, None]).sum(axis=0)))
    assert int(idx) == j_idx
    assert_band(got, want, 1.0, 1)
    np.testing.assert_array_equal(trgb.find_darkest_block(_t(cube), block, border).numpy(), got)


def _star_field(seed=4, size=128, n=24):
    """A (3, size, size) cube of sky 0.1 with gaussian stars of different
    colours, some near the edges, and both packages' star lists for it
    (mass descending)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    cube = (0.1 + rng.normal(0.0, 0.002, (3, size, size))).astype(np.float32)
    xs = rng.uniform(1, size - 2, n).astype(np.float32)
    ys = rng.uniform(1, size - 2, n).astype(np.float32)
    xs[:2], ys[:2] = [0.4, size - 1.2], [size - 0.7, 1.1]
    mass = np.sort(rng.uniform(50.0, 500.0, n))[::-1].astype(np.float32)
    hfr = rng.uniform(1.0, 7.0, n).astype(np.float32)
    for i in range(n):
        amp = mass[i] / 400.0
        tint = rng.uniform(0.6, 1.0, 3)
        blob = np.exp(-((xx - xs[i]) ** 2 + (yy - ys[i]) ** 2) / (2 * (hfr[i] / 1.2) ** 2))
        cube += (amp * tint[:, None, None] * blob).astype(np.float32)
    fields = dict(x=xs, y=ys, value=mass / 10, mass=mass, hfr=hfr, count=n)
    return cube, JStarList(**fields), TStarList(**fields)


@pytest.mark.parametrize("skip", [(0.0, 0.0), (0.1, 0.5)])
def test_mean_star_intensity_device_matches_host_and_jax(skip):
    """Port: the device version (K4's plain version here) against the host
    loop within 1e-6 relative (float64 sums either way); against the JAX
    package's device version, which sums in float32, within 2e-6; the host
    loops of both packages exact. Clip values cut some star pixels."""
    cube, jstars, tstars = _star_field()
    clip = tuple(np.float32(v) for v in (0.9, 0.95, 1.0))
    host_t = trgb.mean_star_intensity(cube, tstars, *skip, clip)
    host_j = jrgb.mean_star_intensity(cube, jstars, *skip, clip)
    assert host_t == host_j
    dev_t = trgb.mean_star_intensity_device(_t(cube), tstars, *skip, clip).numpy()
    dev_j = np.asarray(jrgb.mean_star_intensity_device(jnp.asarray(cube), jstars, *skip, clip))
    np.testing.assert_allclose(dev_t, host_t, rtol=1e-6)
    np.testing.assert_allclose(dev_j, host_j, rtol=2e-6)
    np.testing.assert_allclose(dev_t, dev_j, rtol=2e-6)


def test_mean_star_intensity_no_stars_in_range():
    cube, _, tstars = _star_field(n=3)
    assert trgb.mean_star_intensity_device(_t(cube), tstars, 0.7, 0.5, (1, 1, 1)) is None
    assert trgb.mean_star_intensity_device(_t(cube), None, 0.0, 0.0, (1, 1, 1)) is None


def test_black_white_correction_and_clamp_match_jax():
    cs, ch = (0.05, 0.07, 0.06), (0.6, 0.7, 0.8)
    tgt = (trgb.RGB(1.0, 0.9, 0.8), trgb.RGB(1.0, 1.0, 0.95))
    jt = (jrgb.RGB(1.0, 0.9, 0.8), jrgb.RGB(1.0, 1.0, 0.95))
    a_t, b_t = trgb.black_white_correction(cs, ch, *tgt)
    a_j, b_j = jrgb.black_white_correction(cs, ch, *jt)
    np.testing.assert_array_equal(a_t, a_j)
    np.testing.assert_array_equal(b_t, b_j)
    assert str(tgt[0]) == str(jt[0]) == "RGB(100.00%, 90.00%, 80.00%)"
    want = np.asarray(jpm.scale_offset_clamp_rgb(jnp.asarray(_RGB), jnp.asarray(a_j),
                                                 jnp.asarray(b_j)))
    np.testing.assert_array_equal(tpm.scale_offset_clamp_rgb(_t(_RGB), a_t, b_t).numpy(), want)


def test_stats_for_channel_matches_jax():
    """Location, scale, min and max of one channel equal the JAX package's
    as float32 values."""
    cube, _, _ = _star_field()
    for ch in range(3):
        j = JStats.for_channel(jnp.asarray(cube), 128, ch)
        t = TStats.for_channel(_t(cube), 128, ch)
        jl, js = j.device_location_scale()
        tl, ts = t.device_location_scale()
        assert (tl, ts) == (np.float32(jl), np.float32(js))
        assert t.device_min_max() == tuple(np.float32(v) for v in j.device_min_max())
        assert isinstance(tl, np.float32)


# ---------------------------------------------------------------------------
# The 17 operators
# ---------------------------------------------------------------------------


def _contexts():
    jlog, tlog = io.StringIO(), io.StringIO()
    return jlog, tlog, jctx.new_context(log=jlog), tctx.new_context(log=tlog, device="cpu")


def _cube_images(cube, stars=None):
    jf = JImage.from_naxisn([cube.shape[2], cube.shape[1], 3], jnp.asarray(cube))
    tf = TImage.from_numpy(cube)
    if stars is not None:
        jf.stars, jf.hfr = stars[0], 3.0
        tf.stars, tf.hfr = stars[1], 3.0
    return jf, tf


def _field_hsluv():
    cube, _, _ = _star_field()
    return np.asarray(jcol.linrgb_to_hsluv(jnp.asarray(np.clip(cube, 0.0, 1.0))))


# operator, kwargs (non-default where the operator then acts), input,
# band of the data (share, steps, atol)
_HSL_OPS = [
    ("OpHSLScaleOffsetChannel", {"channel_id": 2, "scale": 1.1, "offset": 0.02}, (0.0, 0, 0.0)),
    ("OpHSLNeutralizeBackground", {"sigma_low": 0.7, "sigma_high": 1.0}, (0.0, 0, 0.0)),
    ("OpHSLSaturationGamma", {"gamma": 1.5, "sigma": 1.0}, (0.005, 1, 0.0)),
    ("OpHSLSelectiveSaturation", {"from_": 295.0, "to": 40.0, "factor": 1.2}, (0.0, 0, 0.0)),
    ("OpHSLRotateHue", {"from_": 30.0, "to": 300.0, "offset": -30.0, "sigma": 1.0},
     (0.0, 0, 0.0)),
    ("OpHSLSCNR", {"factor": 0.5}, (0.08, 16, 1e-4)),
    ("OpHSLMidtones", {"mid": 2.0, "black": 2.0}, (0.0, 0, 0.0)),
    ("OpHSLGamma", {"gamma": 1.3}, (0.02, 1, 0.0)),
    ("OpHSLGammaPP", {"gamma": 1.3, "sigma": 1.0}, (0.02, 1, 0.0)),
    ("OpHSLUnsharpMask", {"sigma": 1.5, "gain": 1.0, "threshold": 0.75}, (0.0, 0, 0.0)),
    ("OpHSLScaleBlack", {"location": 0.001}, (0.0, 0, 0.0)),   # movable
    ("OpHSLScaleBlack", {"location": 0.5}, (0.0, 0, 0.0)),     # cannot move
    ("OpHSLStretchIterative", {"location": 0.1, "scale": 0.004}, (0.0, 8, 1e-7)),
]


@pytest.mark.parametrize("name,kwargs,band", _HSL_OPS,
                         ids=[f"{o[0]}-{i}" for i, o in enumerate(_HSL_OPS)])
def test_hsl_operator_matches_jax(name, kwargs, band):
    """The same log text word for word; the cube within the band (pow-free
    operators exact; gamma curves a float32 step on a few percent of the
    luminance; SCNR the HSLuv band; the auto-stretch 8 steps or 1e-7 near
    black, as test_torch_stretch's auto-stretch)."""
    hs = _field_hsluv()
    jlog, tlog, jc, tc = _contexts()
    jf, tf = _cube_images(hs)
    jf = getattr(jhsl, name)(**kwargs).apply(jf, jc)
    tf = getattr(thsl, name)(**kwargs).apply(tf, tc)
    jc.flush_log()
    tc.flush_log()
    assert tlog.getvalue() == jlog.getvalue()
    assert tlog.getvalue() or name == "OpHSLRotateHue"
    assert_band(tf.data.numpy(), np.asarray(jf.data), *band, hue_rows=(0,))


def test_hsl_apply_lum_matches_jax():
    """The luminance frame's L* curve into channel 2, its exposure added,
    the context's frame consumed; without one the operator passes."""
    hs = _field_hsluv()
    lum = np.random.default_rng(6).uniform(0.0, 1.0, hs.shape[1:]).astype(np.float32)
    jlog, tlog, jc, tc = _contexts()
    jf, tf = _cube_images(hs)
    jc.lum_frame = JImage.from_naxisn([lum.shape[1], lum.shape[0]], jnp.asarray(lum))
    tc.lum_frame = TImage.from_numpy(lum)
    jc.lum_frame.exposure = tc.lum_frame.exposure = 60.0
    jf = jhsl.OpHSLApplyLum().apply(jf, jc)
    tf = thsl.OpHSLApplyLum().apply(tf, tc)
    assert tlog.getvalue() == jlog.getvalue() and "luminance channel" in tlog.getvalue()
    assert tc.lum_frame is None and tf.exposure == jf.exposure == 60.0
    assert_band(tf.data.numpy(), np.asarray(jf.data), 0.005, 2)
    assert thsl.OpHSLApplyLum().apply(tf, tc) is tf


@pytest.mark.parametrize("n", [3, 4])
def test_rgb_combine_matches_jax(n):
    """3 or 4 mono frames: the same log, the cube exact, the 4th frame held
    as the context's luminance frame, the alignment stars handed on."""
    rng = np.random.default_rng(n)
    planes = rng.uniform(200.0, 3000.0, (n, 48, 64)).astype(np.float32)
    jlog, tlog, jc, tc = _contexts()
    _, jstars, tstars = _star_field(n=5)
    jc.align_stars, tc.align_stars = jstars, tstars
    jfs, tfs = [], []
    for i, p in enumerate(planes):
        jfs.append(JImage.from_naxisn([64, 48], jnp.asarray(p)))
        float(jfs[-1].stats.min)  # resolved, as the CLI's reference selection leaves them
        tfs.append(TImage.from_numpy(p))
        jfs[-1].exposure = tfs[-1].exposure = 30.0 * (i + 1)
    jout = jops_rgb.OpRGBCombine().apply(jfs, jc)
    tout = tops_rgb.OpRGBCombine().apply(tfs, tc)
    assert tlog.getvalue() == jlog.getvalue()
    np.testing.assert_array_equal(tout.data.numpy(), np.asarray(jout.data))
    assert tout.naxisn == jout.naxisn == [64, 48, 3] and tout.exposure == jout.exposure
    assert tout.stars is tstars and (tc.lum_frame is tfs[3] if n == 4 else tc.lum_frame is None)


def test_rgb_balance_matches_jax():
    """Both passes: the same log (location, loc+3 sigma, darkest block,
    mean star colour, the two corrections), the cube within 2 float32
    steps or 1e-7: the star colour sums in float64 here and in float32 in
    XLA, so the second correction's factors, and with them most pixels,
    may sit a step apart."""
    cube, jstars, tstars = _star_field()
    jlog, tlog, jc, tc = _contexts()
    jf, tf = _cube_images(cube, (jstars, tstars))
    kw = dict(block=16, border=0.1, skip_bright=0.0, skip_dim=0.5,
              shadows={"R": 1.0, "G": 0.95, "B": 1.0}, highlights=None)
    jf = jops_rgb.OpRGBBalance(**kw).apply(jf, jc)
    tf = tops_rgb.OpRGBBalance(**kw).apply(tf, tc)
    assert tlog.getvalue() == jlog.getvalue()
    assert "Darkest block is RGB(" in tlog.getvalue()
    assert_band(tf.data.numpy(), np.asarray(jf.data), 1.0, 2, 1e-7)


def test_rgb_balance_without_stars_raises():
    cube, _, _ = _star_field()
    _, _, _, tc = _contexts()
    with pytest.raises(ValueError, match="zero stars"):
        tops_rgb.OpRGBBalance().apply(TImage.from_numpy(cube), tc)


@pytest.mark.parametrize("name", ["OpRGBToHSLuv", "OpHSLuvToRGB"])
def test_hsluv_operators_match_jax(name):
    cube, _, _ = _star_field()
    x = np.clip(cube, 0, 1) if name == "OpRGBToHSLuv" else _field_hsluv()
    jlog, tlog, jc, tc = _contexts()
    jf, tf = _cube_images(x)
    jf = getattr(jops_rgb, name)().apply(jf, jc)
    tf = getattr(tops_rgb, name)().apply(tf, tc)
    assert tlog.getvalue() == jlog.getvalue()
    band = (0.08, 4, 1e-4, (0,)) if name == "OpRGBToHSLuv" else (0.04, 2, 1e-6, ())
    assert_band(tf.data.numpy(), np.asarray(jf.data), *band[:3], hue_rows=band[3])


# every colour operator with parameters off their defaults
_JSON_CASES = [
    ("rgbCombine", {}), ("rgbToHSLuv", {}), ("hsluvToRGB", {}), ("hslApplyLum", {}),
    ("rgbBalance", {"block": 8, "border": 0.2, "skipBright": 0.1, "skipDim": 0.6,
                    "shadows": {"R": 0.9, "G": 1, "B": 1.0}, "highlights": {"R": 1.0}}),
    ("rgbBalance", {}),
    ("hslScaleOffsetChannel", {"channelID": 1, "scale": 1.5, "offset": 0.1}),
    ("hslNeutralizeBackground", {"sigmaLow": 0.7, "sigmaHigh": 1.0}),
    ("hslSaturationGamma", {"gamma": 1.2, "sigma": 2}),
    ("hslSelectiveSaturation", {"from": 100, "to": 200.5, "factor": 1.3}),
    ("hslRotateHue", {"from": 100, "to": 190, "offset": -30, "sigma": 1.0}),
    ("hslSCNR", {"factor": 0.5}), ("hslMidtones", {"mid": 3.0, "black": 1.5}),
    ("hslGamma", {"gamma": 1.4}), ("hslGammaPP", {"gamma": 1.2, "sigma": 0.5}),
    ("HSLUnsharpMask", {"sigma": 2.0, "gain": 0.5, "threshold": 1.0}),
    ("hslScaleBlack", {"location": 0.05}), ("hslStretch", {"location": 0.2, "scale": 0.01}),
]


@pytest.mark.parametrize("tag,params", _JSON_CASES, ids=[f"{c[0]}-{i}" for i, c in
                                                          enumerate(_JSON_CASES)])
def test_color_operator_json_matches_jax(tag, params):
    """to_dict, to_json and the op_from_dict round trip equal the JAX
    package's, defaults filled in the same way."""
    d = {"type": tag, **params}
    jop, top = j_from_dict(d), t_from_dict(d)
    assert top.to_dict() == jop.to_dict()
    assert top.to_json() == jop.to_json()
    assert t_from_dict(top.to_dict()).to_dict() == j_from_dict(jop.to_dict()).to_dict()


def test_every_json_tag_is_registered():
    """The port's operator registry holds every tag of the JAX package's."""
    import nightlight_tpu.pipeline  # noqa: F401
    import nightlight_tpu_torch.pipeline  # noqa: F401
    from nightlight_tpu.pipeline.operators import _operator_factories as jreg
    from nightlight_tpu_torch.pipeline.operators import _operator_factories as treg

    assert sorted(treg) == sorted(jreg) and len(treg) == 45
