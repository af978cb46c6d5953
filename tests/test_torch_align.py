"""Alignment and warping of the port, held against nightlight_tpu on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nightlight_tpu.align import aligner as jal
from nightlight_tpu.deferred import resolve_maybe
from nightlight_tpu.detect.stars import StarList as JStarList
from nightlight_tpu.ops import resample as jrs
from nightlight_tpu_torch.align import aligner as tal
from nightlight_tpu_torch.align import transform as tf
from nightlight_tpu_torch.detect.stars import StarList as TStarList
from nightlight_tpu_torch.ops import resample as trs

torch.set_num_threads(1)


def _stars(cls, xy, rng):
    n = len(xy)
    mass = np.sort(rng.uniform(1e3, 1e5, n))[::-1].astype(np.float32)
    z = np.zeros(n, np.float32)
    return cls(x=xy[:, 0].astype(np.float32), y=xy[:, 1].astype(np.float32),
               value=z, mass=mass, hfr=z + 2.0, count=n)


def _scene(seed, n_ref=40, size=(1200, 900)):
    rng = np.random.default_rng(seed)
    ref = np.stack([rng.uniform(0, size[0], n_ref), rng.uniform(0, size[1], n_ref)], -1)
    frames = []
    for k, (a, b, c, d, e, f) in enumerate([
            (1.0, 0.0, 4.3, 0.0, 1.0, -3.1),            # translation
            (0.9998, 0.002, -12.5, -0.002, 0.9998, 7.25),  # small rotation
            (1.0003, -0.0004, 30.0, 0.0005, 0.9997, -22.0)]):
        xy = ref.copy()
        xy = np.stack([a * xy[:, 0] + b * xy[:, 1] + c, d * xy[:, 0] + e * xy[:, 1] + f], -1)
        xy += rng.normal(0, 0.02, xy.shape)
        keep = rng.uniform(size=n_ref) > 0.1 * k  # some stars lost
        frames.append(xy[keep])
    frames.append(np.stack([rng.uniform(0, size[0], 25), rng.uniform(0, size[1], 25)], -1))
    return rng, ref, frames, [size[0], size[1]]


@pytest.mark.parametrize("seed", [0, 1])
def test_aligner_matches(seed):
    """Transforms to 1e-4 relative and residuals to 1e-4 px, the same drop
    decisions under the CLI's 1.0 px threshold: the least-squares sums over
    star coordinates of up to ~1000 px run in another float32 order (and XLA
    may contract multiply-adds), which moves the translation terms by a few
    1e-4 px."""
    rng, ref, frames, naxisn = _scene(seed)
    j = jal.Aligner(naxisn, _stars(JStarList, ref, np.random.default_rng(9)), 20)
    t = tal.Aligner(naxisn, _stars(TStarList, ref, np.random.default_rng(9)), 20)
    np.testing.assert_array_equal(j.ref_tri_sides, t.ref_tri_sides)
    metas_j = [(naxisn, _stars(JStarList, xy, np.random.default_rng(i))) for i, xy in enumerate(frames)]
    metas_t = [(naxisn, _stars(TStarList, xy, np.random.default_rng(i))) for i, xy in enumerate(frames)]
    rows = j.align_batch_deferred(metas_j)
    out = t.align_batch(metas_t)
    for (jt, jr), (tt, tr) in zip(rows, out):
        jt, jr = np.asarray(resolve_maybe(jt), np.float32), float(resolve_maybe(jr))
        assert (jr > 1.0) == (tr > 1.0)
        if np.isfinite(jr):
            np.testing.assert_allclose(tt, jt, rtol=1e-4, atol=1e-5)
            assert tr == pytest.approx(jr, abs=1e-4)
        else:
            assert not np.isfinite(tr)
    # the per-frame path (host pick and compacted triangles)
    for (_, sj), (_, st) in zip(metas_j[:3], metas_t[:3]):
        jt, jr, _ = j.align_deferred(naxisn, sj)
        tt, tr = t.align_one(naxisn, st)
        np.testing.assert_allclose(tt, np.asarray(resolve_maybe(jt), np.float32),
                                   rtol=1e-4, atol=1e-5)
        assert tr == pytest.approx(float(resolve_maybe(jr)), abs=1e-4)


def _image(seed, h=120, w=150, nan_frac=0.01):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = (100 + 20 * np.sin(xx / 7.0) * np.cos(yy / 5.0)
           + rng.normal(0, 1, (h, w))).astype(np.float32)
    img[rng.uniform(size=(h, w)) < nan_frac] = np.nan
    return img


_TRANSFORMS = [
    np.array([1.0, 0.0, 3.4, 0.0, 1.0, -2.7], np.float32),
    np.array([1.0001, 0.0002, -5.25, -0.0003, 0.9999, 1.5], np.float32),
    np.array([0.94, -0.34, 20.3, 0.34, 0.94, -15.2], np.float32),  # rotation: gather warp
]


@pytest.mark.parametrize("k", range(len(_TRANSFORMS)))
def test_project_matches(k):
    """NaN positions equal; values to 1e-5 relative (the same bilinear
    arithmetic; XLA may contract its multiply-adds). The transforms keep
    source coordinates off the float rounding of the frame edge, where a
    contracted multiply-add could move a pixel in or out of bounds."""
    img = _image(k)
    naxisn = [150, 120]
    trans = _TRANSFORMS[k]
    a = np.asarray(jrs.project(jnp.asarray(img), naxisn, trans, float("nan")))
    b = trs.project(torch.from_numpy(img), naxisn, trans, float("nan")).numpy()
    assert np.array_equal(np.isnan(a), np.isnan(b))
    ok = ~np.isnan(a)
    np.testing.assert_allclose(b[ok], a[ok], rtol=1e-5)
    assert (trs._shift_plan(tf.invert(trans), img.shape, naxisn) is None) == (k == 2)


def test_batch_shift_warp_matches():
    imgs = np.stack([_image(s) for s in range(3)])
    naxisn = [150, 120]
    invs = [tf.invert(t) for t in (_TRANSFORMS[0], _TRANSFORMS[1], tf.identity())]
    plan_j = jrs.plan_batch_shift_warp([i.shape for i in imgs], naxisn, invs)
    plan_t = trs.plan_batch_shift_warp([i.shape for i in imgs], naxisn, invs)
    kmins, mmins, n_k, n_m = plan_t
    assert np.array_equal(kmins, plan_j[0]) and np.array_equal(mmins, plan_j[1])
    assert (n_k, n_m) == plan_j[2:]
    flags = [True, True, False]
    oobs = [float("nan")] * 3
    a = np.asarray(jrs._warp_shift_batch(
        jnp.asarray(imgs), jnp.asarray(np.stack(invs)), jnp.asarray(np.array(oobs, np.float32)),
        jnp.asarray(kmins), jnp.asarray(mmins), jnp.asarray(np.array(flags)), n_k, n_m))
    b = trs.warp_shift_batch(torch.from_numpy(imgs.copy()), invs, oobs, kmins, mmins, flags,
                             n_k, n_m).numpy()
    assert np.array_equal(np.isnan(a), np.isnan(b))
    ok = ~np.isnan(a)
    np.testing.assert_allclose(b[ok], a[ok], rtol=1e-5)
    assert np.array_equal(b[2], imgs[2], equal_nan=True)  # reference frame untouched
