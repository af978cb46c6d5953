"""The modules of the port's one-shot-colour preprocess chain held against
the JAX package on the same numpy inputs: debayer (and the Go oracle),
CFA cosmetic correction and its masked median, deband (and the reference's
host loop), background extraction and binning. Each case states its
tolerance; "exact" means bit for bit."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nightlight_tpu.detect.stars import StarList as JStarList
from nightlight_tpu.image import Image as JImage
from nightlight_tpu.image import bin_nxn as jbin_nxn
from nightlight_tpu.ops import background as jbg
from nightlight_tpu.ops import deband as jdeband
from nightlight_tpu.ops import prestack as jps
from nightlight_tpu_torch.detect.stars import StarList as TStarList
from nightlight_tpu_torch.image import Image as TImage
from nightlight_tpu_torch.image import bin_nxn as tbin_nxn
from nightlight_tpu_torch.ops import background as tbg
from nightlight_tpu_torch.ops import deband as tdeband
from nightlight_tpu_torch.ops import prestack as tps
from test_go_oracles import go_debayer_oracle

torch.set_num_threads(1)

CFAS = ["RGGB", "GRBG", "GBRG", "BGGR"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# Debayer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(64, 64), (64, 65), (65, 64)], ids=["even", "odd-w", "odd-h"])
@pytest.mark.parametrize("cfa", CFAS)
@pytest.mark.parametrize("channel", ["R", "G", "B"])
def test_debayer_matches_jax_and_go(channel, cfa, shape):
    """Every channel x CFA x {even, odd width, odd height}. Tolerance: equal
    to the JAX function bit for bit; to the Go oracle within 1 float32 step
    (rtol 1e-6), where XLA's fused multiply-add rounds green's edge
    extrapolation (sqrt2*g1 + 2*g2) once and the oracle twice, as the JAX
    package's own oracle test allows."""
    rng = np.random.default_rng(hash((channel, cfa, shape)) % 2**32)
    img = rng.normal(900.0, 20.0, size=shape).astype(np.float32)
    want = np.asarray(jps.debayer_bilinear(jnp.asarray(img), channel, cfa))
    got = tps.debayer_bilinear(_t(img), channel, cfa).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    oracle = go_debayer_oracle(img, channel, cfa)
    assert got.shape == oracle.shape
    np.testing.assert_allclose(got, oracle, rtol=1e-6, atol=0)


def test_debayer_unknown_values_raise():
    img = torch.zeros((4, 4))
    with pytest.raises(ValueError, match="Unknown CFA value"):
        tps.debayer_bilinear(img, "R", "XYZW")
    with pytest.raises(ValueError, match="Unknown debayering value"):
        tps.debayer_bilinear(img, "Q", "RGGB")


# ---------------------------------------------------------------------------
# CFA cosmetic correction
# ---------------------------------------------------------------------------


def _mosaic_with_defects(rng, h, w):
    """A sky of 900 +- 20 with hot (3000) and cold (0) pixels in every 2x2
    phase, so each channel has outliers of both signs."""
    img = rng.normal(900.0, 20.0, size=(h, w)).astype(np.float32)
    for py in (0, 1):
        for px in (0, 1):
            ys = rng.integers(1, h // 2 - 1, 4) * 2 + py
            xs = rng.integers(1, w // 2 - 1, 4) * 2 + px
            img[ys[:2], xs[:2]] = 3000.0
            img[ys[2:], xs[2:]] = 0.0
    return img


@pytest.mark.parametrize("cfa", CFAS)
@pytest.mark.parametrize("channel", ["R", "G", "B"])
def test_cosmetic_correction_bayer_matches_jax(channel, cfa):
    """Image and count exact, with hot and cold pixels in each channel; the
    channel's own outliers are all repaired."""
    rng = np.random.default_rng(3)
    img = _mosaic_with_defects(rng, 96, 80)
    want, n_want = jps.cosmetic_correction_bayer(jnp.asarray(img), channel, cfa, 3.0, 5.0)
    got, n_got = tps.cosmetic_correction_bayer(_t(img), channel, cfa, 3.0, 5.0)
    assert int(n_got) == int(n_want) >= 4
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("count", range(1, 10))
def test_masked_median9_matches_jax(count):
    """Every count of valid entries from 1 to 9, exact."""
    rng = np.random.default_rng(count)
    planes = [rng.normal(0.0, 1.0, size=(16, 16)).astype(np.float32) for _ in range(9)]
    masks = []
    for k in range(9):
        m = np.zeros((16, 16), bool)
        m[:, :] = k < count
        masks.append(m)
    # shuffle which entries are valid per pixel, keeping the count
    perm = np.argsort(rng.random((9, 16, 16)), axis=0)
    masks = [np.take_along_axis(np.stack(masks), perm, 0)[k] for k in range(9)]
    want = jps._masked_median9([jnp.asarray(p) for p in planes], [jnp.asarray(m) for m in masks])
    got = tps._masked_median9([_t(p) for p in planes], [_t(m) for m in masks])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # and the definition: the median of the valid entries
    vals = np.where(np.stack(masks), np.stack(planes), np.nan)
    np.testing.assert_allclose(got.numpy(), np.nanmedian(vals, axis=0), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# Deband
# ---------------------------------------------------------------------------


def _banded(rng, h, w):
    img = rng.normal(900.0, 20.0, size=(h, w)).astype(np.float32)
    img *= (1 + 0.02 * np.sin(np.arange(h) / 5.0)).astype(np.float32)[:, None]
    img *= (1 + 0.01 * np.cos(np.arange(w) / 7.0)).astype(np.float32)[None, :]
    img[10, 12] = 30000.0
    return img


@pytest.mark.parametrize("window", [16, 17, 500], ids=["even", "odd", "longer-than-image"])
@pytest.mark.parametrize("sigma", [0.0, 3.0])
@pytest.mark.parametrize("horizontal", [True, False], ids=["horizontal", "vertical"])
def test_deband_matches_jax(horizontal, sigma, window):
    """Image, factor extrema and threshold exact against the JAX function,
    the threshold 3.4e38 at sigma 0; except where the window spans the
    image: there every row's window reaches past an edge, and XLA rounds
    the edge extrapolation (mean + slope * offset) with and without a fused
    multiply-add from row to row, so a factor may sit 1 float32 step away
    (image and extrema within 2 steps, rtol 2.4e-7)."""
    img = _banded(np.random.default_rng(1), 96, 80)
    loc, scale = 900.25, 20.5
    want = jdeband.deband(jnp.asarray(img), 50.0, window, sigma, loc, scale, horizontal)
    got = tdeband.deband(_t(img), 50.0, window, sigma, loc, scale, horizontal)
    lo, hi = (float(v.value) for v in want[1:3])
    if window < 80:
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        assert (got[1], got[2]) == (lo, hi)
    else:
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=2.4e-7, atol=0)
        np.testing.assert_allclose(got[1:3], (lo, hi), rtol=2.4e-7, atol=0)
    thr = want[3] if sigma == 0 else float(want[3].value)
    assert got[3] == thr
    if sigma == 0:
        assert got[3] == 3.4e38


@pytest.mark.parametrize("window", [8, 9, 50, 60])
def test_window_median_factors_device_matches_host_loop(window):
    """The vectorized window median against the reference's host loop
    (banding.go:96-162): the loop's medians are float64, so 2 float32 steps."""
    p = np.random.default_rng(window).normal(100.0, 3.0, 50).astype(np.float32)
    host = tdeband._window_median_factors(p, window)
    dev = tdeband._window_median_factors_device(_t(p), min(window, 50)).numpy()
    np.testing.assert_allclose(dev, host, rtol=2.5e-7, atol=0)
    np.testing.assert_array_equal(host, jdeband._window_median_factors(p, window))


# ---------------------------------------------------------------------------
# Background extraction
# ---------------------------------------------------------------------------


def _sky_with_stars(h=200, w=230):
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = (900 + 0.05 * xx + 0.03 * yy + rng.normal(0, 2, (h, w))).astype(np.float32)
    sx = np.array([50, 120, 180.5], np.float32)
    sy = np.array([40, 100, 150.2], np.float32)
    for x, y in zip(sx, sy):
        img += (3000 * np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / 8)).astype(np.float32)
    img[5:20, 5:20] += 500  # a bright cell for the clip
    hfr = np.array([2.0, 2.5, 1.5], np.float32)
    z = np.zeros(3, np.float32)
    return img, JStarList(sx, sy, z, z, hfr, 3), TStarList(sx, sy, z, z, hfr, 3)


@pytest.mark.parametrize("grid,clip,with_stars", [
    (32, 0, False), (32, 3, True), (50, 2, True), (64, 0, True)])
def test_background_matches_jax(grid, clip, with_stars):
    """Cells and the log string exact; the render within 4 float32 steps
    (rtol 5e-7): XLA contracts its bilinear sums into fused multiply-adds
    whose pattern varies along the vectorized rows."""
    img, js, ts = _sky_with_stars()
    a = jbg.Background(jnp.asarray(img), grid, 1.5, clip, js if with_stars else None, 4.0)
    b = tbg.Background(_t(img), grid, 1.5, clip, ts if with_stars else None, 4.0)
    assert str(b) == str(a)
    np.testing.assert_array_equal(b.cells, a.cells)
    np.testing.assert_allclose(b.render().numpy(), np.asarray(a.render()), rtol=5e-7, atol=0)
    if clip:
        assert b.outlier_cells == clip


def test_fit_background_batch_matches_single_frames():
    """The batch fit (one read-back) gives the per-frame Background's cells."""
    img, _, ts = _sky_with_stars()
    imgs = [_t(img), _t(img[::-1].copy())]
    batch = tbg.fit_background_batch(imgs, [ts, None], 40, 1.5, 2, 4.0)
    for im, st, bg in zip(imgs, [ts, None], batch):
        one = tbg.Background(im, 40, 1.5, 2, st, 4.0)
        np.testing.assert_array_equal(bg.cells, one.cells)
        assert str(bg) == str(one)


def test_star_mask_matches_jax():
    _, js, ts = _sky_with_stars()
    np.testing.assert_array_equal(tbg._star_mask(200, 230, ts, 4.0),
                                  jbg._star_mask(200, 230, js, 4.0))


# ---------------------------------------------------------------------------
# Binning
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,shape", [(2, (64, 64)), (2, (256, 128)), (3, (64, 64)),
                                     (3, (65, 67)), (4, (66, 64))])
def test_bin_nxn_matches_jax(n, shape):
    """Exact where the block columns are a power of two (2x2) or the block
    is larger than 2x2; the sizes and FITS axes follow the crop."""
    img = np.random.default_rng(n).normal(900.0, 20.0, size=shape).astype(np.float32)
    j = jbin_nxn(JImage.from_naxisn([shape[1], shape[0]], jnp.asarray(img)), n)
    t = tbin_nxn(TImage.from_numpy(img), n)
    assert t.naxisn == j.naxisn == [shape[1] // n, shape[0] // n]
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))


def test_bin_nxn_other_widths_within_one_step():
    """2x2 bins over an odd number of block columns: XLA sums them in row
    order, the port in row-pair order; 1 float32 step (rtol 1.2e-7)."""
    img = np.random.default_rng(9).normal(900.0, 20.0, size=(64, 66)).astype(np.float32)
    j = jbin_nxn(JImage.from_naxisn([66, 64], jnp.asarray(img)), 2)
    t = tbin_nxn(TImage.from_numpy(img), 2)
    np.testing.assert_allclose(t.data.numpy(), np.asarray(j.data), rtol=1.2e-7, atol=0)
