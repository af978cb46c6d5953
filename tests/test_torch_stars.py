"""Star detection of the port (kernel K4's plain version and find_stars),
held against nightlight_tpu on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nightlight_tpu.ops.gather_pallas as gp
from nightlight_tpu.detect import stars as jstars
from nightlight_tpu_torch.detect import stars as tstars
from nightlight_tpu_torch.ops import gather_cuda

torch.set_num_threads(1)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run the Pallas kernels in interpret mode, as the JAX package's own
    CPU tests do; restored afterwards."""
    monkeypatch.setattr(gp, "INTERPRET", True)


def synth_field(rng, h=256, w=256, stars=(), bg=100.0, noise=2.0, fwhm=8.0, flux=8000.0):
    img = rng.normal(bg, noise, size=(h, w)).astype(np.float32)
    sigma = fwhm / 2.3548
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for sx, sy in stars:
        img += flux / (2 * np.pi * sigma ** 2) * np.exp(
            -((xx - sx) ** 2 + (yy - sy) ** 2) / (2 * sigma ** 2))
    return img


@pytest.mark.parametrize("radius", [32, 16, 8, 3, 1])
def test_patch_gather_plain_matches_pallas_where_ok(pallas_interpret, radius):
    """K4's plain version against gather_patches_pallas: equal masks and
    equal values wherever the window lies in the frame (out-of-frame values
    are unspecified by both contracts). Centres reach 40 pixels past every
    edge, as chip_smoke.py draws them for the kernel."""
    rng = np.random.default_rng(radius)
    img = rng.normal(100, 5, size=(140, 210)).astype(np.float32)
    cy = np.r_[rng.integers(0, 140, 40), [0, 1, 138, 139],
               rng.integers(-40, 180, 12), [-40, 179, -1, 140]].astype(np.int32)
    cx = np.r_[rng.integers(0, 210, 40), [0, 209, 1, 208],
               rng.integers(-40, 250, 12), [249, -40, 210, -1]].astype(np.int32)
    pj, okj = gp.gather_patches_pallas(jnp.asarray(img), jnp.asarray(cy), jnp.asarray(cx), radius)
    pt, okt = gather_cuda.gather_patches(torch.from_numpy(img), torch.from_numpy(cy),
                                         torch.from_numpy(cx), radius)
    ok = np.asarray(okj)
    assert np.array_equal(ok, okt.numpy())
    assert okt.dtype == torch.bool and 0 < ok.sum() < ok.size
    assert not ok[-4:].all(axis=(1, 2)).any()  # centres outside: every window cut
    np.testing.assert_array_equal(pt.numpy()[ok], np.asarray(pj)[ok])


def _compare(img, loc, scale, star_sig, bp_sig, in_out, radius, mds):
    js, jh = jstars.find_stars(jnp.asarray(img), loc, scale, star_sig, bp_sig, in_out,
                               radius, mds, use_pallas_gather=False)
    ts, th = tstars.find_stars(torch.from_numpy(img), loc, scale, star_sig, bp_sig, in_out,
                               radius, mds)
    # counts exactly; positions to 1e-3 px and masses/HFRs to 1e-4 relative:
    # the centre-of-mass sums run in another float32 order (XLA fuses and
    # may contract multiply-adds), which moves centroids by ~1e-5 px
    assert ts.count == js.count
    for a, b, tol in ((ts.x, js.x, 1e-3), (ts.y, js.y, 1e-3)):
        np.testing.assert_allclose(a, b, atol=tol)
    np.testing.assert_allclose(ts.value, js.value, rtol=1e-6)
    np.testing.assert_allclose(ts.mass, js.mass, rtol=1e-4)
    np.testing.assert_allclose(ts.hfr, js.hfr, rtol=1e-4)
    assert th == pytest.approx(jh, rel=1e-4)
    return ts


def test_find_stars_matches_field():
    rng = np.random.default_rng(7)
    pos = [(40.3, 50.7), (120.0, 80.2), (200.6, 200.1), (60.0, 180.5), (10.2, 128.0),
           (250.0, 5.0), (130.0, 132.0), (137.0, 139.0)]  # edges and a close pair
    img = synth_field(rng, stars=pos)
    stars = _compare(img, 100.0, 2.0, 15.0, 5.0, 1.4, 16, 2.5)
    assert 4 <= stars.count <= len(pos)


@pytest.mark.parametrize("seed", [1, 2])
def test_find_stars_random_fields(seed):
    rng = np.random.default_rng(seed)
    pos = [tuple(rng.uniform(8, 248, 2)) for _ in range(25)]
    flux = rng.uniform(3000, 20000)
    img = synth_field(rng, stars=pos, flux=flux)
    _compare(img, 100.0, 2.0, 10.0, 0.0, 1.4, 8, 0.0)
    img[rng.integers(0, 256, 20), rng.integers(0, 256, 20)] += 800.0  # hot pixels
    # with the bad-pixel test on (bp_sig 5); without it a hot pixel inside a
    # star converges onto the star's centroid with a mass equal to the last
    # float32 bit, and which duplicate survives is a coin toss on both sides
    _compare(img, 100.0, 2.0, 15.0, 5.0, 1.4, 16, 2.1)


def test_select_brightest_tiled_equals_flat():
    """The tiled selection (per-tile top-32, then global) and the flat one
    give the same candidates in the same order when no tile overflows."""
    rng = np.random.default_rng(3)
    n = 1 << 22
    cv = torch.full((2, n), -float("inf"))
    idx = torch.from_numpy(rng.choice(n, 3000, replace=False))
    cv[0, idx] = torch.from_numpy(rng.normal(500, 50, 3000).astype(np.float32))
    cv[1, idx[:100]] = 7.0  # ties resolve by lower index
    vals_t, idx_t = tstars._select_brightest(cv, 2048)
    vals_f, idx_f = tstars._select_flat(cv, n, 2048)
    valid = vals_f > -float("inf")
    assert torch.equal(vals_t, vals_f)
    assert torch.equal(idx_t[valid], idx_f[valid])


def test_cuda_tensor_never_reaches_plain_version():
    """On a CUDA tensor the wrapper launches the kernel or raises: its
    dispatch names the plain version only under the CPU branch."""
    import inspect

    src = inspect.getsource(gather_cuda.gather_patches)
    cpu_branch, rest = src.split('if img.device.type == "cpu":')
    assert "patches_plain" not in cpu_branch
    assert rest.strip().splitlines()[0].strip() == "return patches_plain(img, cys, cxs, radius)"
    assert "gather_patches_cuda(" in rest and rest.count("patches_plain") == 1
    with pytest.raises(ValueError, match="CUDA"):
        gather_cuda.gather_patches_cuda(torch.zeros(4, 4), torch.zeros(1, dtype=torch.int32),
                                        torch.zeros(1, dtype=torch.int32), 1)
