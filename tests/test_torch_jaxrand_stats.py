"""The port's JAX-compatible random draws and its -lsEst 3 statistics,
held against jax.random and nightlight_tpu/ops/stats.py on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nightlight_tpu.ops import stats as jstats
from nightlight_tpu_torch.ops import jaxrand
from nightlight_tpu_torch.ops import stats as tstats

torch.set_num_threads(1)

# every key the sampled estimators derive from PRNGKey(0)
# (ops/stats.py:246, :263; models/fastpath.py:161, :196), plus other seeds
_KEYS = [0, 1, 42]


@pytest.mark.parametrize("seed", _KEYS)
def test_prng_key_split_fold_in_bit_exact(seed):
    k = jax.random.PRNGKey(seed)
    assert np.array_equal(np.asarray(k), jaxrand.prng_key(seed))
    kn = jaxrand.prng_key(seed)
    for num in (2, 4):
        assert np.array_equal(np.asarray(jax.random.split(k, num)), jaxrand.split(kn, num))
    for d in range(10):  # the clip loop folds in its iteration 0..9
        assert np.array_equal(np.asarray(jax.random.fold_in(k, d)), jaxrand.fold_in(kn, d))


@pytest.mark.parametrize("shape,lo,hi", [
    ((131072,), 0, 512 * 512),        # sample indices of a 512x512 frame
    ((131072,), 0, 4096 * 4096),      # ... of a 16.8 MP frame
    ((131072,), 0, 1 << 30),          # _qn_pairs_from draws
    ((1,), 1, 131072),                # the Qn roll of the start and the end
    ((2,), 1, 131072),                # the two rolls per clip iteration
    ((7, 3), -5, 1000003),
])
def test_randint_bit_exact(shape, lo, hi):
    key = jax.random.PRNGKey(0)
    k_sample, k_qn0, k_loop, _ = jax.random.split(key, 4)
    for k in (key, k_sample, k_qn0, jax.random.fold_in(k_loop, 3)):
        a = np.asarray(jax.random.randint(k, shape, lo, hi))
        b = jaxrand.randint(np.asarray(k), shape, lo, hi)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _image(rng, shape, outliers=0.01):
    x = rng.normal(100.0, 2.0, size=shape).astype(np.float32)
    x[rng.uniform(size=shape) < outliers] += 500.0
    return x


@pytest.mark.parametrize("shape", [(512, 512), (300, 200), (64, 64)])
def test_sigma_clipped_median_qn_matches(shape):
    """Same sample indices and rolls as the JAX estimator, so location and
    scale are the same order statistics. rtol 1e-6: both are f32 values
    picked from the same sample; only a mean of two middle values rounds."""
    rng = np.random.default_rng(sum(shape))
    x = _image(rng, shape)
    mn, me, mx = jstats.min_mean_max(jnp.asarray(x))
    jl, js = jstats.sigma_clipped_median_qn(jnp.asarray(x).reshape(-1), 2.0, 2.0,
                                            (mx - mn) / 65535.0, jax.random.PRNGKey(0))
    t = torch.from_numpy(x.reshape(1, -1))
    tmn, tme, tmx = tstats.min_mean_max(t)
    tl, ts = tstats.location_scale(t, tmn, tmx)
    np.testing.assert_allclose(float(tl[0]), float(jl), rtol=1e-6)
    np.testing.assert_allclose(float(ts[0]), float(js), rtol=1e-6)
    assert float(tmn[0]) == float(mn) and float(tmx[0]) == float(mx)
    # the mean accumulates in float64 here and in float32 order in XLA
    np.testing.assert_allclose(float(tme[0]), float(me), rtol=1e-6)


def test_batched_estimator_equals_per_frame():
    """Frames that converge in different iterations freeze independently,
    as under vmap."""
    rng = np.random.default_rng(3)
    frames = np.stack([_image(rng, (128, 128), outliers=o) for o in (0.0, 0.05, 0.2)])
    t = torch.from_numpy(frames.reshape(3, -1))
    mn, _, mx = tstats.min_mean_max(t)
    loc, scale = tstats.location_scale(t, mn, mx)
    for i in range(3):
        l1, s1 = tstats.location_scale(t[i:i + 1], mn[i:i + 1], mx[i:i + 1])
        assert float(l1[0]) == float(loc[i]) and float(s1[0]) == float(scale[i])


def test_stats_object_and_log_format(monkeypatch):
    # both packages' default estimator; the JAX CLI resets the JAX one from
    # -lsEst, so a CLI run earlier in the worker must not choose it here
    monkeypatch.setattr(jstats, "DEFAULT_LS_ESTIMATOR", jstats.LSEstimatorMode.SCMedianQn)
    rng = np.random.default_rng(5)
    x = _image(rng, (96, 80))
    js = jstats.Stats(jnp.asarray(x), 80)
    ts = tstats.Stats(torch.from_numpy(x), 80)
    assert js.location == pytest.approx(ts.location, rel=1e-6)
    assert js.scale == pytest.approx(ts.scale, rel=1e-6)
    js.update_cached_with(1.5, 2.0)
    ts.update_cached_with(1.5, 2.0)
    assert str(js.snapshot_for_log()).split()[:2] == str(ts).split()[:2]
    assert str(ts).startswith("Min ") and "Location" in str(ts)


def test_quickselect_helpers():
    ss = torch.tensor([[1.0, 2.0, 3.0, 10.0], [0.0, 5.0, 6.0, 7.0]])
    assert tstats.median_sorted(ss).tolist() == [2.5, 5.5]
    assert tstats.first_quartile_sorted(ss).tolist() == [2.0, 5.0]
    odd = torch.tensor([1.0, 4.0, 9.0])
    assert float(tstats.median_sorted(odd)) == float(jstats.median_sorted(jnp.asarray([1.0, 4.0, 9.0])))


def test_match_histograms_batch_matches():
    """Per-frame linear histogram match of a batch: the same float32
    multiply-add chain (rtol 1e-6 for a contracted multiply-add in XLA)."""
    from nightlight_tpu.models import fastpath as jfp
    from nightlight_tpu_torch.models import fastpath as tfp

    rng = np.random.default_rng(8)
    frames = rng.normal(500.0, 20.0, size=(3, 32, 48)).astype(np.float32)
    locs = np.array([480.0, 500.0, 530.0], np.float32)
    scales = np.array([18.0, 20.0, 25.0], np.float32)
    a = np.asarray(jfp.match_histograms_batch(jnp.asarray(frames), jnp.asarray(locs),
                                              jnp.asarray(scales), jnp.float32(100.0),
                                              jnp.float32(5.0)))
    b = tfp.match_histograms_batch(torch.from_numpy(frames), locs, scales, 100.0, 5.0).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-6)
