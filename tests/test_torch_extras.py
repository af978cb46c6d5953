"""The port's off-path estimators and colour spaces (ops/stats_extra.py,
ops/color_extra.py): every case of tests/test_extras.py on the port, and
each function held against the JAX package's on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nightlight_tpu.ops import color_extra as jce
from nightlight_tpu.ops import stats as jstats
from nightlight_tpu.ops import stats_extra as jse
from nightlight_tpu_torch.ops import color_extra as ce
from nightlight_tpu_torch.ops import jaxrand
from nightlight_tpu_torch.ops import stats_extra as se
from nightlight_tpu_torch.ops.stats import histogram

torch.set_num_threads(1)

_F32_STEP = float(np.spacing(np.float32(1.0)))


def _t(x):
    return torch.from_numpy(np.array(x))


def _key(seed):
    return jaxrand.prng_key(seed)


def _hist(d, num_bins):
    return histogram(_t(d), torch.tensor(d.min()), torch.tensor(d.max()), num_bins).numpy()


# ---------------------------------------------------------------------------
# tests/test_extras.py, case for case, on the port
# ---------------------------------------------------------------------------


class TestOkLab:
    def test_white_point(self):
        # OkLab maps linear white (1,1,1) to L=1, a=b=0
        lab = ce.linrgb_to_oklab(torch.ones((3, 1, 1))).numpy().ravel()
        assert lab[0] == pytest.approx(1.0, abs=1e-3)
        assert abs(lab[1]) < 1e-3 and abs(lab[2]) < 1e-3

    def test_roundtrip(self, rng):
        rgb = _t(rng.uniform(0.05, 0.95, size=(3, 4, 4)).astype(np.float32))
        back = ce.oklab_to_linrgb(ce.linrgb_to_oklab(rgb))
        np.testing.assert_allclose(back.numpy(), rgb.numpy(), atol=2e-3)

    def test_hcl_roundtrip(self, rng):
        rgb = _t(rng.uniform(0.05, 0.95, size=(3, 4, 4)).astype(np.float32))
        lab = ce.linrgb_to_oklab(rgb)
        back = ce.okhcl_to_oklab(ce.oklab_to_okhcl(lab))
        np.testing.assert_allclose(back.numpy(), lab.numpy(), atol=1e-5)


class TestBV:
    def test_table_endpoints(self):
        # bv.go table: -0.4 -> blue-ish, 2.0 -> orange/red
        np.testing.assert_allclose(ce.bv_to_rgb(-0.4), [0.60784, 0.69804, 1.0], atol=1e-5)
        np.testing.assert_allclose(ce.bv_to_rgb(2.0), [1.0, 0.32157, 0.0], atol=1e-5)

    def test_interpolation_and_clamping(self):
        mid = ce.bv_to_rgb(-0.375)  # halfway between first two entries
        np.testing.assert_allclose(mid, [(0.60784 + 0.61961) / 2, (0.69804 + 0.70980) / 2, 1.0],
                                   atol=1e-5)
        np.testing.assert_allclose(ce.bv_to_rgb(-5.0), ce.bv_to_rgb(-0.4))
        np.testing.assert_allclose(ce.bv_to_rgb(9.0), ce.bv_to_rgb(2.0))


class TestSigmaClippedMedianMAD:
    def test_gaussian(self, rng):
        d = rng.normal(10.0, 2.0, size=20000).astype(np.float32)
        med, mad = se.sigma_clipped_median_and_mad(_t(d), 3.0, 3.0)
        assert float(med) == pytest.approx(10.0, abs=0.1)
        assert float(mad) == pytest.approx(2.0, rel=0.05)

    def test_outlier_robust_location(self, rng):
        d = rng.normal(10.0, 1.0, size=20000).astype(np.float32)
        d[:500] = 1000.0
        med, mad = se.sigma_clipped_median_and_mad(_t(d), 2.0, 2.0)
        assert float(med) == pytest.approx(10.0, abs=0.2)


class TestBoundedEstimators:
    def test_bounded_median_excludes_outliers(self, rng):
        d = rng.normal(50.0, 2.0, size=100000).astype(np.float32)
        d[:5000] = 500.0
        med = se.fast_approx_bounded_median(_t(d), 40.0, 60.0, _key(0))
        assert float(med) == pytest.approx(50.0, abs=0.3)

    def test_bounded_mad(self, rng):
        d = rng.normal(50.0, 2.0, size=100000).astype(np.float32)
        mad = se.fast_approx_bounded_mad(_t(d), 50.0, 40.0, 60.0, _key(0))
        assert float(mad) == pytest.approx(2.0, rel=0.1)

    def test_bounded_stddev(self, rng):
        d = rng.normal(50.0, 2.0, size=100000).astype(np.float32)
        sd = se.fast_approx_bounded_stddev(_t(d), 50.0, 40.0, 60.0, _key(0))
        assert float(sd) == pytest.approx(2.0, rel=0.1)

    def test_bounded_qn(self, rng):
        d = rng.normal(50.0, 2.0, size=100000).astype(np.float32)
        qn = se.fast_approx_bounded_qn(_t(d), 40.0, 60.0, _key(0))
        assert float(qn) == pytest.approx(2.0, rel=0.1)


class TestHalfSampleMode:
    def test_finds_mode(self, rng):
        # bimodal: narrow dense mode at 5, broad spread at 20
        d = np.concatenate([rng.normal(5.0, 0.2, size=5000),
                            rng.normal(20.0, 5.0, size=3000)])
        assert se.half_sample_mode(d) == pytest.approx(5.0, abs=0.3)

    def test_small_inputs(self):
        assert se.half_sample_mode([3.0]) == 3.0
        assert se.half_sample_mode([3.0, 5.0]) == 4.0


class TestHistogramUtilities:
    def test_get_peak(self, rng):
        d = rng.normal(100.0, 5.0, size=100000).astype(np.float32)
        x, y = se.get_peak(_hist(d, 512), float(d.min()), float(d.max()))
        assert x == pytest.approx(100.0, abs=2.0)
        assert y > 0

    def test_gaussian_fit_mode(self, rng):
        d = rng.normal(100.0, 5.0, size=200000).astype(np.float32)
        mode, stddev = se.get_mode_stddev_from_histogram(_hist(d, 256), float(d.min()),
                                                         float(d.max()))
        assert mode == pytest.approx(100.0, abs=1.0)
        assert stddev == pytest.approx(5.0, rel=0.15)

    def test_perceptual_histogram_roundtrip(self, rng):
        d = rng.uniform(0.0, 1.0, size=50000).astype(np.float32) ** 3  # skewed dark
        bins = se.perceptual_histogram(d, 0.0, 1.0, 256)
        assert bins.sum() == 50000
        x, _ = se.get_perceptual_histogram_peak(bins, 0.0, 1.0)
        assert 0.0 <= x <= 1.0


# ---------------------------------------------------------------------------
# The port against the JAX package on the same inputs
# ---------------------------------------------------------------------------


def _jax_clip_window(x, sigma_low, sigma_high):
    """The final window [lo, hi) of the JAX package's
    sigma_clipped_median_and_mad, its loop as written there (stats_extra.py
    :31-79) with the window returned in place of the median."""
    xs = jnp.sort(jnp.asarray(x))
    zero = jnp.zeros((1,), xs.dtype)
    s1 = jnp.concatenate([zero, jnp.cumsum(xs)])
    s2 = jnp.concatenate([zero, jnp.cumsum(xs * xs)])

    def body(state):
        lo, hi, _ = state
        cnt = hi - lo
        med = jstats._median_of_sorted_range(xs, lo, cnt)
        c = jnp.maximum(cnt, 1).astype(xs.dtype)
        ex2 = (s2[hi] - s2[lo]) / c
        ex = (s1[hi] - s1[lo]) / c
        std = jnp.sqrt(jnp.maximum(ex2 - 2 * med * ex + med * med, 0.0)) * 1.134
        new_lo = jnp.maximum(jnp.searchsorted(xs, med - sigma_low * std, side="left"), lo)
        new_hi = jnp.minimum(jnp.searchsorted(xs, med + sigma_high * std, side="right"), hi)
        rejected = (new_lo - lo) + (hi - new_hi)
        return new_lo, new_hi, jnp.logical_or(rejected == 0, (new_hi - new_lo) <= 3)

    lo, hi, _ = jax.jit(lambda: jax.lax.while_loop(
        lambda s: jnp.logical_not(s[2]), body,
        (jnp.int32(0), jnp.int32(xs.shape[0]), jnp.bool_(False))))()
    return int(lo), int(hi)


def _clip_inputs():
    rng = np.random.default_rng(42)
    clean = rng.normal(10.0, 2.0, size=20000).astype(np.float32)
    dirty = rng.normal(10.0, 1.0, size=20000).astype(np.float32)
    dirty[:500] = 1000.0
    skew = np.concatenate([rng.normal(100.0, 3.0, 6000),
                           rng.exponential(40.0, 1500) + 100.0]).astype(np.float32)
    return [(clean, 3.0, 3.0), (dirty, 2.0, 2.0), (clean, 1.5, 2.5), (skew, 2.0, 3.0)]


@pytest.mark.parametrize("case", range(4))
def test_sigma_clipped_median_and_mad_matches_jax(case):
    """The final window exactly: the port adds the float32 prefix sums in
    XLA's order and rounds the variance (which cancels to a few bits) as
    XLA contracts it, so every bound lands on the same sample. Then the
    median exactly, and the MAD (the median of |x - median| of the same
    data) within one float32 step."""
    x, sl, sh = _clip_inputs()[case]
    xs = torch.sort(_t(x)).values
    lo, hi = se._clip_window(xs, sl, sh)
    assert (int(lo), int(hi)) == _jax_clip_window(x, sl, sh)
    med, mad = se.sigma_clipped_median_and_mad(_t(x), sl, sh)
    jmed, jmad = jse.sigma_clipped_median_and_mad(jnp.asarray(x), sl, sh)
    assert float(med) == float(jmed)
    np.testing.assert_array_max_ulp(mad.numpy(), np.asarray(jmad), maxulp=1)


@pytest.mark.parametrize("seed", [0, 11])
def test_bounded_estimators_match_jax(seed):
    """The same key draws the same sample (_key_sample == the JAX
    package's _sample, and fast_approx_bounded_qn's split key the same
    pairs), so median, MAD and Qn, order statistics of it, are bit-exact;
    the stddev sums the squares in another order than XLA, within 1e-6
    relative."""
    rng = np.random.default_rng(seed)
    d = rng.normal(50.0, 2.0, size=100000).astype(np.float32)
    d[:5000] = 500.0
    jk, tk = jax.random.PRNGKey(seed), _key(seed)
    np.testing.assert_array_equal(se._key_sample(_t(d), tk, 4096).numpy(),
                                  np.asarray(jstats._sample(jnp.asarray(d), jk, 4096)))
    jd = jnp.asarray(d)
    assert float(se.fast_approx_bounded_median(_t(d), 40.0, 60.0, tk)) == float(
        jse.fast_approx_bounded_median(jd, 40.0, 60.0, jk))
    assert float(se.fast_approx_bounded_mad(_t(d), 50.0, 40.0, 60.0, tk)) == float(
        jse.fast_approx_bounded_mad(jd, jnp.float32(50.0), 40.0, 60.0, jk))
    assert float(se.fast_approx_bounded_qn(_t(d), 40.0, 60.0, tk)) == float(
        jse.fast_approx_bounded_qn(jd, 40.0, 60.0, jk))
    assert float(se.fast_approx_bounded_stddev(_t(d), 50.0, 40.0, 60.0, tk)) == pytest.approx(
        float(jse.fast_approx_bounded_stddev(jd, jnp.float32(50.0), 40.0, 60.0, jk)), rel=1e-6)
    # a window of one sample: Qn's pair indices run past it and clamp, as
    # JAX's gather does
    lone = np.full(1000, 7.0, np.float32)
    lone[0] = 3.0
    assert float(se.fast_approx_bounded_qn(_t(lone), 2.0, 4.0, tk, 256)) == float(
        jse.fast_approx_bounded_qn(jnp.asarray(lone), 2.0, 4.0, jk, 256))


def test_host_estimators_match_jax():
    """half_sample_mode, the histogram peaks, the Gaussian fit (the port's
    Nelder-Mead against scipy's) and the perceptual histogram: numpy on
    both sides, exactly equal."""
    rng = np.random.default_rng(3)
    d = np.concatenate([rng.normal(5.0, 0.2, size=5000), rng.normal(20.0, 5.0, size=3000)])
    assert se.half_sample_mode(d) == jse.half_sample_mode(d)
    assert se.half_sample_mode(_t(d)) == jse.half_sample_mode(d)
    for mu, sigma, nbins in ((100.0, 5.0, 256), (1000.0, 40.0, 64), (0.2, 0.01, 512)):
        x = rng.normal(mu, sigma, size=100000).astype(np.float32)
        bins = np.asarray(jstats.histogram(jnp.asarray(x), jnp.float32(x.min()),
                                           jnp.float32(x.max()), nbins))
        lo, hi = float(x.min()), float(x.max())
        assert se.get_peak(bins, lo, hi) == jse.get_peak(bins, lo, hi)
        assert se.get_mode_stddev_from_histogram(bins, lo, hi) == \
            jse.get_mode_stddev_from_histogram(bins, lo, hi)
    u = rng.uniform(0.0, 1.0, size=50000).astype(np.float32) ** 3
    pb = se.perceptual_histogram(u, 0.0, 1.0, 256)
    np.testing.assert_array_equal(pb, jse.perceptual_histogram(u, 0.0, 1.0, 256))
    np.testing.assert_array_equal(se.perceptual_histogram(_t(u), 0.0, 1.0, 256), pb)
    assert se.get_perceptual_histogram_peak(pb, 0.0, 1.0) == \
        jse.get_perceptual_histogram_peak(pb, 0.0, 1.0)


def test_nelder_mead_spends_the_budget_like_scipy():
    """A fit that does not converge within 600 evaluations stops where
    scipy's stops, mid-step (Rosenbrock from far away)."""
    from scipy.optimize import minimize

    def rosen(p):
        return float(sum(100.0 * (p[1:] - p[:-1] ** 2) ** 2 + (1 - p[:-1]) ** 2))

    x0 = [-30.0, 40.0, 25.0]
    np.testing.assert_array_equal(se._nelder_mead(rosen, x0),
                                  minimize(rosen, x0, method="Nelder-Mead").x)


def _oklab_inputs():
    rng = np.random.default_rng(0)
    rgb = rng.uniform(-0.05, 1.05, size=(3, 96, 96)).astype(np.float32)
    rgb[:, 0, :4] = [[0, 1, 1, 0.5], [0, 1, 0, 0.5], [0, 1, 0, 0.5]]  # black, white, red, grey
    return rgb


def test_oklab_matches_jax():
    """Same inputs through both packages. The matrix rows round as XLA
    contracts them, so the band is the cube root's: XLA's and the port's
    round a float32 step apart on under 1% of inputs, which M2 carries to
    at most 4 steps of 1.0 absolute in L, a, b; the inverse is exact."""
    rgb = _oklab_inputs()
    jlab = np.asarray(jce.linrgb_to_oklab(jnp.asarray(rgb)))
    lab = ce.linrgb_to_oklab(_t(rgb)).numpy()
    assert np.abs(lab - jlab).max() <= 4 * _F32_STEP
    assert np.mean(lab != jlab) <= 0.01
    np.testing.assert_array_equal(ce.oklab_to_linrgb(_t(jlab)).numpy(),
                                  np.asarray(jce.oklab_to_linrgb(jnp.asarray(jlab))))


def test_okhcl_matches_jax():
    """(H, C, L) from the same OkLab: L exact, C within one float32 step,
    the hue within two steps of its value on the circle (atan2 in float64
    rounded once against XLA's float32 atan2); back to OkLab within one
    step of 1.0 absolute (sin and cos likewise)."""
    jlab = np.asarray(jce.linrgb_to_oklab(jnp.asarray(_oklab_inputs())))
    jhcl = np.asarray(jce.oklab_to_okhcl(jnp.asarray(jlab)))
    hcl = ce.oklab_to_okhcl(_t(jlab)).numpy()
    np.testing.assert_array_equal(hcl[2], jhcl[2])
    np.testing.assert_array_max_ulp(hcl[1], jhcl[1], maxulp=1)
    dh = np.abs((hcl[0] - jhcl[0] + 180.0) % 360.0 - 180.0)
    assert np.all(dh <= 2 * np.spacing(np.abs(jhcl[0]).astype(np.float32)) + 1e-12)
    back = ce.okhcl_to_oklab(_t(jhcl)).numpy()
    jback = np.asarray(jce.okhcl_to_oklab(jnp.asarray(jhcl)))
    np.testing.assert_array_equal(back[0], jback[0])
    assert np.abs(back - jback).max() <= _F32_STEP


def test_bv_to_rgb_matches_jax():
    bv = np.concatenate([np.linspace(-1.0, 2.5, 301), [-0.4, 2.0, 0.05, 1.2345]]).astype(np.float32)
    np.testing.assert_array_equal(ce.bv_to_rgb(bv), jce.bv_to_rgb(bv))
    np.testing.assert_array_equal(ce.bv_to_rgb(0.65), jce.bv_to_rgb(0.65))
