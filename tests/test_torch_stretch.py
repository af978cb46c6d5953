"""The port's `stretch` command and its modules held against the JAX package
on the same numpy inputs: the pixel-math curves, the gaussian kernel, blur
and unsharp mask, the iterative auto-stretch, the stretch operators' log
lines, and the whole CLI. Each case states its tolerance; "exact" means bit
for bit."""

import contextlib
import io
import os
import shutil

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image as PILImage

from nightlight_tpu import cli as jcli
from nightlight_tpu.image import Image as JImage
from nightlight_tpu.ops import autostretch as jast
from nightlight_tpu.ops import gauss as jgauss
from nightlight_tpu.ops import pixelmath as jpm
from nightlight_tpu.pipeline import context as jctx
from nightlight_tpu.pipeline import ops_stretch as jops
from nightlight_tpu_torch import cli as tcli
from nightlight_tpu_torch.image import Image as TImage
from nightlight_tpu_torch.io import fits as tfits
from nightlight_tpu_torch.ops import autostretch as tast
from nightlight_tpu_torch.ops import gauss as tgauss
from nightlight_tpu_torch.ops import pixelmath as tpm
from nightlight_tpu_torch.pipeline import context as tctx
from nightlight_tpu_torch.pipeline import ops_stretch as tops
from test_torch_cli import _STARS, _compare_logs, run_main

torch.set_num_threads(1)

# torch's float32 pow (libm's powf) and XLA's CPU pow round apart by one
# float32 step on a few percent of inputs
POW_RTOL = 1.2e-7


def _unit(rng, shape=(96, 112)):
    return rng.uniform(0.0, 1.0, size=shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# Pixel math
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,args,exact", [
    ("scale_offset", (1.3, 0.1), True),
    ("normalize", (0.0371, 0.9311), True),
    ("midtones", (0.02, 0.05), True),
    ("shift_black_to_move", (0.3, 0.1), True),
    ("gamma", (2.2,), False),
    ("partial_gamma", (0.2, 1.0, 1.7), False),
])
def test_pixelmath_matches_jax(name, args, exact):
    """Exact where the function has no pow (the port rounds XLA's fused
    multiply-adds once, as XLA does); gamma curves within one float32 step
    of the pow (POW_RTOL)."""
    x = _unit(np.random.default_rng(len(name)))
    want = np.asarray(getattr(jpm, name)(jnp.asarray(x), *args))
    got = getattr(tpm, name)(_t(x), *args).numpy()
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=POW_RTOL, atol=0)


def test_set_black_white_matches_jax():
    """Image and the four scalars exact."""
    x = np.random.default_rng(5).normal(1000.0, 50.0, (128, 96)).astype(np.float32)
    want = jpm.set_black_white(jnp.asarray(x), 1.0, 0.5)
    got = tpm.set_black_white(_t(x), 1.0, 0.5)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert [float(v) for v in got[1:]] == [float(v) for v in want[1:]]


# ---------------------------------------------------------------------------
# Gaussian kernel, blur, unsharp mask
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sigma", [0.5, 1.0, 1.5, 2.0, 3.0])
def test_gaussian_kernel_matches_jax(sigma):
    """The host kernel exact, golden values of usm_test.go included."""
    np.testing.assert_array_equal(tgauss.gaussian_kernel_1d(sigma),
                                  jgauss.gaussian_kernel_1d(sigma))


@pytest.mark.parametrize("sigma", [0.7, 1.0, 2.0, 3.0])
def test_gaussian_blur_matches_jax(sigma):
    """Exact: shifted adds in the JAX package's order, each rounded as XLA's
    fused multiply-adds round them."""
    x = _unit(np.random.default_rng(int(sigma * 10)))
    want = np.asarray(jgauss.gaussian_blur(jnp.asarray(x), sigma))
    np.testing.assert_array_equal(tgauss.gaussian_blur(_t(x), sigma).numpy(), want)


@pytest.mark.parametrize("gain", [0.7, 1.0])
def test_unsharp_mask_matches_jax(gain):
    """Exact, clipped to [vmin, vmax] above the threshold."""
    x = _unit(np.random.default_rng(3))
    want = np.asarray(jgauss.unsharp_mask(jnp.asarray(x), 2.0, gain, 0.05, 0.95, 0.3))
    got = tgauss.unsharp_mask(_t(x), 2.0, gain, 0.05, 0.95, 0.3).numpy()
    np.testing.assert_array_equal(got, want)


def test_symmetric_border_is_numpys():
    for n, k in ((4, 3), (9, 4), (1, 2)):
        np.testing.assert_array_equal(tgauss._symmetric_index(n, k, "cpu").numpy(),
                                      np.pad(np.arange(n), k, mode="symmetric"))


# ---------------------------------------------------------------------------
# Auto-stretch
# ---------------------------------------------------------------------------


def _stacked_field(size=192, seed=0):
    """A normalized stacked frame: a sky of 100 +- 0.5 and three stars up to
    20000, so the sky sits near 0.5% and its scale near 0.003%."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    img = rng.normal(100.0, 0.5, (size, size)).astype(np.float32)
    for x, y, f in ((40, 50, 20000), (120, 80, 8000), (150, 160, 3000)):
        img += (f * np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / 8)).astype(np.float32)
    return ((img - img.min()) / (img.max() - img.min())).astype(np.float32)


@pytest.mark.parametrize("target", [(0.1, 0.004), (0.25, 0.02), (0.1, 0.0001)])
def test_auto_stretch_matches_jax(target):
    """The same rounds (actions, iteration count, convergence) and the
    same per-round location and scale to 1e-6 relative, the gammas exact;
    the image within 8 float32 steps (each gamma round's pow may round one
    step apart, and later rounds carry it), or 1e-7 absolute (a step at 1.0)
    near the black point, where a black shift cancels the leading digits.
    A black shift whose location sits a step from XLA's moves every pixel
    after it, so rounds past one take 1e-5 relative."""
    x = _stacked_field()
    j_out, j_hist, j_n, j_conv = jast.auto_stretch(jnp.asarray(x), *target)
    t_out, t_hist, t_n, t_conv = tast.auto_stretch(_t(x), *target)
    j_hist = np.asarray(j_hist)[:int(j_n)]
    assert t_n == int(j_n) and t_conv == bool(j_conv)
    np.testing.assert_array_equal(t_hist[:, tast.H_ACTION], j_hist[:, jast.H_ACTION])
    gamma_rows = t_hist[:, tast.H_ACTION] == tast.ACT_GAMMA
    np.testing.assert_array_equal(t_hist[gamma_rows, tast.H_PARAM],
                                  j_hist[gamma_rows, jast.H_PARAM])
    np.testing.assert_allclose(t_hist[:, [tast.H_LOC, tast.H_SCALE, tast.H_PARAM]],
                               j_hist[:, [jast.H_LOC, jast.H_SCALE, jast.H_PARAM]],
                               rtol=1e-6, atol=0)
    black_shifts = int((t_hist[:, tast.H_ACTION] == tast.ACT_BLACK).sum())
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out),
                               rtol=1e-5 if black_shifts else 8 * POW_RTOL, atol=1e-7)


@pytest.mark.parametrize("loc,scale", [(0.01, 0.0005), (0.05, 0.001), (0.2, 0.01),
                                       (0.001, 0.002), (0.1, 0.1)])
def test_stretch_decision_and_ideal_gamma_match_jax(loc, scale):
    """The device search's action and gamma exact, the NaN case included
    (loc < scale: every candidate NaN, gamma 1, as Go returns); the host
    search ideal_stretch_gamma equal to the JAX package's, which clamps
    loc - scale at 0 and so finds a gamma there."""
    j = jast.stretch_decision(jnp.float32(loc), jnp.float32(scale), jnp.float32(0.1),
                              jnp.float32(0.004))
    t = tast.stretch_decision(torch.tensor(loc, dtype=torch.float32),
                              torch.tensor(scale, dtype=torch.float32),
                              torch.tensor(0.1, dtype=torch.float32),
                              torch.tensor(0.004, dtype=torch.float32))
    assert (float(t[0]), float(t[1])) == (float(j[0]), float(j[1]))
    g = tast._ideal_gamma(torch.tensor(loc, dtype=torch.float32),
                          torch.tensor(scale, dtype=torch.float32),
                          torch.tensor(0.1, dtype=torch.float32),
                          torch.tensor(0.004, dtype=torch.float32))
    if loc < scale:
        assert float(g) == 1.0
    assert tops.ideal_stretch_gamma(loc, scale, 0.1, 0.004) == jops.ideal_stretch_gamma(
        loc, scale, 0.1, 0.004)


# ---------------------------------------------------------------------------
# The stretch operators' log lines and branches
# ---------------------------------------------------------------------------


def _apply_both(op_name, kwargs, data):
    """Apply the same operator of both packages to the same image; returns
    (JAX log, port log, JAX data, port data)."""
    jlog, tlog = io.StringIO(), io.StringIO()
    jc = jctx.new_context(log=jlog)
    tc = tctx.new_context(log=tlog, device="cpu")
    jf = JImage.from_naxisn([data.shape[1], data.shape[0]], jnp.asarray(data))
    tf = TImage.from_numpy(data)
    jf = getattr(jops, op_name)(**kwargs).apply(jf, jc)
    tf = getattr(tops, op_name)(**kwargs).apply(tf, tc)
    jc.flush_log()
    tc.flush_log()
    return jlog.getvalue(), tlog.getvalue(), np.asarray(jf.data), tf.data.numpy()


_UNIFORM = np.full((32, 32), 0.25, np.float32)


@pytest.mark.parametrize("op_name,kwargs,data,exact", [
    ("OpNormalizeRange", {}, None, True),
    ("OpNormalizeRange", {}, _UNIFORM, True),  # uniform: skipped, with the warning
    ("OpMidtones", {"mid": 2.0, "black": 2.0}, None, True),
    ("OpGamma", {"gamma": 1.8}, None, False),
    ("OpGammaPP", {"gamma": 1.5, "sigma": 1.0}, None, False),
    ("OpScaleBlack", {"location": 0.001}, None, True),  # movable
    ("OpScaleBlack", {"location": 0.5}, None, True),  # cannot move
    ("OpGaussianBlur", {"sigma": 1.5}, None, True),
    ("OpUnsharpMask", {"sigma": 1.5, "gain": 0.8, "threshold": 1.0}, None, True),
    ("OpStretchIterative", {"location": 0.1, "scale": 0.004}, None, False),
])
def test_stretch_operators_match_jax(op_name, kwargs, data, exact):
    """The same log text word for word, numbers included; the image exact
    or, where a pow runs, within 8 float32 steps (1e-7 absolute near 0)."""
    if data is None:
        data = _stacked_field(96)
    jlog, tlog, jd, td = _apply_both(op_name, kwargs, data)
    assert tlog == jlog
    if exact:
        np.testing.assert_array_equal(td, jd)
    else:
        np.testing.assert_allclose(td, jd, rtol=8 * POW_RTOL, atol=1e-7)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def _stacked_fits(d, size=256):
    """A stacked-looking float32 FITS: the ten stars of test_torch_cli's
    fixture (fwhm 8, flux 60000) on a sky of 1000 +- 2."""
    rng = np.random.default_rng(21)
    k = size / 512
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    s = 8.0 / 2.3548
    img = rng.normal(1000.0, 2.0, size=(size, size)).astype(np.float32)
    for sx, sy in _STARS:
        img += 60000.0 / (2 * np.pi * s * s) * np.exp(
            -(((xx - sx * k) ** 2) + ((yy - sy * k) ** 2)) / (2 * s * s))
    im = TImage.from_numpy(img.astype(np.float32))
    im.exposure = 3600.0
    tfits.write_file(im, os.path.join(d, "stacked.fits"))


def _run_in(d, cli_mod, flags):
    cwd = os.getcwd()
    os.chdir(d)
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = run_main(cli_mod, ["-out", "s.fits", "-tiff", "s.tif", "-log", "", *flags,
                                    "stretch", "stacked.fits"])
        return rc, buf.getvalue()
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("flags", [
    pytest.param((), id="defaults"),
    pytest.param(("-blurSigma", "1", "-usmSigma", "2", "-usmGain", "1"), id="blur-usm"),
])
def test_cli_stretch_matches_jax(tmp_path, flags):
    """JAX CLI and port CLI: the same log (the stretch rounds and their
    gammas included) under _compare_logs' bands; FITS within 8 float32
    steps of the gamma pow (plus the ~1e-5 px centroid band when a blur
    follows, none here: alignment is the identity on one frame); TIFF and
    JPEG within one level (a pixel on a quantization edge)."""
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    _stacked_fits(str(jdir))
    shutil.copytree(jdir, tdir)
    rc_j, jlog = _run_in(jdir, jcli, flags)
    rc_t, tlog = _run_in(tdir, tcli, flags)
    assert rc_j == 0 and rc_t == 0, tlog[-3000:]
    assert "applying gamma" in tlog and "Stars 10 " in tlog
    if flags:
        assert "Gaussian blur kernel sigma 1.00 size 3" in tlog
        assert "Unsharp masking kernel sigma 2.00 size 9" in tlog
    _compare_logs(jlog, tlog, exact_seek=True)
    a = tfits.read_file(str(jdir / "s.fits")).to_numpy()
    b = tfits.read_file(str(tdir / "s.fits")).to_numpy()
    assert b.shape == a.shape and np.isfinite(b).all()
    np.testing.assert_allclose(b, a, rtol=8 * POW_RTOL, atol=1e-7)
    for name in ("s.tif", "s.jpg"):
        pa = np.asarray(PILImage.open(str(jdir / name))).astype(np.int64)
        pb = np.asarray(PILImage.open(str(tdir / name))).astype(np.int64)
        assert pa.shape == pb.shape
        assert np.abs(pa - pb).max() <= 1, name
