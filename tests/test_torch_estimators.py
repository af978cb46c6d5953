"""The location/scale estimators of -lsEst 0, 1, 2 and 4 (the port's
ops/stats.py) held against the JAX package's Stats on the same images."""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nightlight_tpu.ops import stats as jstats
from nightlight_tpu_torch.ops import stats as tstats

torch.set_num_threads(1)


def _image(seed, h, w):
    """Sky about 100 with sigma 2, a few stars, hot and cold pixels."""
    rng = np.random.default_rng(seed)
    img = rng.normal(100.0, 2.0, size=(h, w)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for _ in range(12):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        img += (rng.uniform(200, 2000) * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 8.0)
                ).astype(np.float32)
    img[rng.uniform(size=(h, w)) < 0.002] = 4000.0
    img[rng.uniform(size=(h, w)) < 0.001] = 10.0
    return img


_IMAGES = [(1, 256, 256), (2, 160, 192), (3, 97, 301)]


def _both(img, mode):
    h, w = img.shape
    j = jstats.Stats(jnp.asarray(img), w, jstats.LSEstimatorMode(mode))
    t = tstats.Stats(torch.from_numpy(img), w, tstats.LSEstimatorMode(mode))
    return (float(j.location), float(j.scale)), (t.location, t.scale), j, t


@pytest.mark.parametrize("seed,h,w", _IMAGES)
def test_median_mad_exact(seed, h, w):
    """-lsEst 1: the same PRNGKey(0)/(1) sample indices, an exact median of
    the sorted sample, so location and scale are equal."""
    (jl, js), (tl, ts), _, _ = _both(_image(seed, h, w), 1)
    assert (tl, ts) == (jl, js)


@pytest.mark.parametrize("seed,h,w", _IMAGES)
def test_mean_stddev(seed, h, w):
    """-lsEst 0: the cached mean and stddev. Band 1e-6 relative: the port
    accumulates the mean in float64 and XLA in a float32 tree, so the two
    round differently in the last bit."""
    (jl, js), (tl, ts), j, t = _both(_image(seed, h, w), 0)
    assert tl == pytest.approx(jl, rel=1e-6) and ts == pytest.approx(js, rel=1e-6)
    assert (tl, ts) == (t.mean, t.stddev)


@pytest.mark.parametrize("seed,h,w", _IMAGES)
def test_ikss(seed, h, w):
    """-lsEst 2: the same sort, window bisection and iteration; the
    biweight sums run over the whole image in another order (torch vs an
    XLA reduction), so the scale agrees to 1e-5 relative and the location,
    a sorted sample picked by the same window, exactly."""
    (jl, js), (tl, ts), _, _ = _both(_image(seed, h, w), 2)
    assert tl == jl
    assert ts == pytest.approx(js, rel=1e-5)


@pytest.mark.parametrize("seed,h,w", _IMAGES)
def test_histogram(seed, h, w):
    """-lsEst 4: the reference's rounding bin map over [min, max] in 4096
    bins. Where XLA contracts (d - min) * scale + 0.5 into one rounding a
    sample can change bin, which moves the peak or the ring by one bin, so
    location and scale agree to one bin width; the counts to a few samples."""
    img = _image(seed, h, w)
    (jl, js), (tl, ts), _, _ = _both(img, 4)
    width = (float(img.max()) - float(img.min())) / 4095
    assert abs(tl - jl) <= width * 1.0001 and abs(ts - js) <= width * 1.0001
    mn, mx = np.float32(img.min()), np.float32(img.max())
    jh = np.asarray(jstats.histogram(jnp.asarray(img), mn, mx, 4096))
    th = tstats.histogram(torch.from_numpy(img), torch.tensor(mn), torch.tensor(mx), 4096).numpy()
    assert th.sum() == jh.sum() == img.size
    assert np.abs(np.cumsum(th) - np.cumsum(jh)).max() <= 4


def test_histogram_constant_image():
    img = np.full((16, 24), 7.5, np.float32)
    (jl, js), (tl, ts), _, _ = _both(img, 4)
    assert (tl, ts) == (jl, js) == (7.5, 0.0)


def test_ikss_constant_image_terminates():
    """A constant window has scale 0: the estimator stops there (the
    reference loops forever). Run with its own time limit of 60 s."""
    img = np.full((64, 64), 123.25, np.float32)
    box = {}

    def run():
        box["t"] = tstats.ikss(torch.from_numpy(img))

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout=60)
    assert not th.is_alive(), "IKSS did not return on a constant image"
    loc, scale = box["t"]
    assert (float(loc), float(scale)) == (123.25, 0.0)
    jl, js = jstats.ikss(jnp.asarray(img))
    assert (float(jl), float(js)) == (123.25, 0.0)
