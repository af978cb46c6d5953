"""Clip stacking (kernels K1 and K2 through their plain versions) and the
goal-seek search of the port, held against nightlight_tpu on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nightlight_tpu.ops.stack_pallas as sp
from nightlight_tpu.ops import findsigma as jfs
from nightlight_tpu.ops import stack as jstk
from nightlight_tpu_torch.ops import findsigma as tfs
from nightlight_tpu_torch.ops import stack as tstk
from nightlight_tpu_torch.ops import stack_cuda

torch.set_num_threads(1)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run the Pallas kernels in interpret mode, as the JAX package's own
    CPU tests do; restored afterwards."""
    monkeypatch.setattr(sp, "INTERPRET", True)


def frames_with_nans(seed, n, p=1024):
    """Sky samples about 1000 with 10% missing and 5% bright outliers, an
    all-missing pixel 0 (the repo's stack test recipe)."""
    rng = np.random.default_rng(seed)
    f = rng.normal(1000.0, 10.0, size=(n, p)).astype(np.float32)
    f[rng.uniform(size=(n, p)) < 0.1] = np.nan
    f[rng.uniform(size=(n, p)) < 0.05] += 2000.0
    f[:, 0] = np.nan
    return f


def _check(j, t):
    """Clip counts exactly; outputs to 1e-5 relative (1e-3 absolute near
    zero): the kernels and their plain versions sum in frame order in float32
    like the TPU kernel, but XLA may contract multiply-adds, so a value can
    differ in its last bits. The seeds below are ones where no sample sits
    within that rounding of a clip bound; elsewhere a single borderline
    sample can flip (the JAX package's own XLA and Pallas twins then differ
    from each other the same way)."""
    assert int(t[1]) == int(j[1]) and int(t[2]) == int(j[2])
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), rtol=1e-5, atol=1e-3)


_N_SEEDS = [(6, 20), (16, 20), (26, 20)]


@pytest.mark.parametrize("n,seed", _N_SEEDS)
@pytest.mark.parametrize("variant", ["sigma", "winsorized", "weighted"])
def test_k1_plain_matches_pallas(pallas_interpret, n, seed, variant):
    f = frames_with_nans(seed, n)
    w = np.random.default_rng(seed).uniform(0.5, 2.0, n).astype(np.float32)
    winsor = "winsorized" in variant
    weights = "weighted" in variant
    j = sp.stack_sigma_pallas(jnp.asarray(f), 42.5, 2.5, 2.5,
                              weights=jnp.asarray(w) if weights else None, winsorize=winsor)
    t = stack_cuda.stack_sigma(torch.from_numpy(f), 42.5, 2.5, 2.5,
                               weights=torch.from_numpy(w) if weights else None,
                               winsorize=winsor)
    _check(j, t)
    assert float(t[0][0]) == 42.5  # no valid sample -> ref_loc


@pytest.mark.parametrize("n,seed", _N_SEEDS)
def test_k2_plain_matches_pallas(pallas_interpret, n, seed):
    f = frames_with_nans(seed, n)
    j = sp.stack_linfit_pallas(jnp.asarray(f), 42.5, 2.5, 2.5)
    t = stack_cuda.stack_linfit(torch.from_numpy(f), 42.5, 2.5, 2.5)
    _check(j, t)
    assert int(t[1]) + int(t[2]) > 0


@pytest.mark.parametrize("n,seed", _N_SEEDS)
def test_plain_versions_match_xla_twins(n, seed):
    """The JAX package's XLA stack path (the one its CPU CLI runs) agrees
    with the port the same way."""
    f = frames_with_nans(seed, n)
    _check(jstk.stack_sigma(jnp.asarray(f), 42.5, 2.5, 2.5),
           stack_cuda.stack_sigma(torch.from_numpy(f), 42.5, 2.5, 2.5))
    _check(jstk.stack_winsor_sigma(jnp.asarray(f), 42.5, 2.5, 2.5),
           stack_cuda.stack_sigma(torch.from_numpy(f), 42.5, 2.5, 2.5, winsorize=True))
    _check(jstk.stack_linear_fit(jnp.asarray(f), 42.5, 2.5, 2.5),
           stack_cuda.stack_linfit(torch.from_numpy(f), 42.5, 2.5, 2.5))


def test_mean_modes_and_dispatch():
    f = frames_with_nans(9, 5, 500)
    w = np.linspace(0.5, 2.0, 5).astype(np.float32)
    a = jstk.stack(jnp.asarray(f), jstk.StackMode.Mean, ref_frame_loc=3.0)
    b = tstk.stack(torch.from_numpy(f), tstk.StackMode.Mean, ref_frame_loc=3.0)
    np.testing.assert_allclose(b[0].numpy(), np.asarray(a[0]), rtol=1e-6)
    a = jstk.stack(jnp.asarray(f), jstk.StackMode.Mean, weights=jnp.asarray(w))
    b = tstk.stack(torch.from_numpy(f), tstk.StackMode.Mean, weights=torch.from_numpy(w))
    np.testing.assert_allclose(b[0].numpy(), np.asarray(a[0]), rtol=1e-6)
    for n in (1, 5, 6, 14, 15, 24, 25, 100):
        assert int(tstk.auto_select_mode(n)) == int(jstk.auto_select_mode(n))
    a = jstk.stack(jnp.asarray(f), jstk.StackMode.Median, ref_frame_loc=3.0)
    b = tstk.stack(torch.from_numpy(f), tstk.StackMode.Median, ref_frame_loc=3.0)
    np.testing.assert_array_equal(b[0].numpy(), np.asarray(a[0]))


def test_incremental_stack():
    a = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    acc = tstk.stack_incremental(None, a, 3.0)
    acc = tstk.stack_incremental(acc, a + 1, 2.0)
    ref = jstk.stack_incremental_finalize(
        jstk.stack_incremental(jstk.stack_incremental(None, jnp.asarray(a.numpy()), 3.0),
                               jnp.asarray(a.numpy() + 1), 2.0), 5.0)
    np.testing.assert_allclose(tstk.stack_incremental_finalize(acc, 5.0).numpy(),
                               np.asarray(ref), rtol=1e-6)


@pytest.mark.parametrize("mode,n,seed", [
    (jstk.StackMode.Sigma, 8, 11), (jstk.StackMode.WinsorSigma, 16, 12),
    (jstk.StackMode.LinearFit, 26, 13)])
def test_findsigma_histories_exact(mode, n, seed):
    """Same frames in, the same search: every round's sigmas and clip counts
    are equal (float32 bracket/Newton arithmetic on both sides)."""
    f = frames_with_nans(seed, n, 1200).reshape(n, 30, 40)
    search = jfs._newton_search_device if mode == jstk.StackMode.LinearFit else jfs._search_device
    _, hist, clips, n_iter = search(jnp.asarray(f), None, jnp.float32(0.0), 50, 50, int(mode),
                                    20, use_pallas=False, subsample=False)
    n_iter = int(n_iter)
    th, tc = tfs.search_histories(torch.from_numpy(f), mode)
    assert len(th) == n_iter
    np.testing.assert_array_equal(np.array(th, np.float32), np.asarray(hist)[:n_iter])
    np.testing.assert_array_equal(np.array(tc), np.asarray(clips)[:n_iter])

    jo, jcl, jch, jlo, jhi = jfs.find_sigmas_and_stack(jnp.asarray(f), mode, use_pallas=False)
    to, tcl, tch, tlo, thi = tfs.find_sigmas_and_stack(torch.from_numpy(f), mode)
    assert (tcl, tch) == (int(jcl), int(jch)) and (tlo, thi) == (jlo, jhi)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5, atol=1e-3)


def test_search_subsample_matches():
    f = frames_with_nans(1, 3, 200 * 37).reshape(3, 200, 37)
    js, jt = jfs._search_subsample(jnp.asarray(f), f.size)
    ts, tt = tfs._search_subsample(torch.from_numpy(f), f.size)
    assert ts.is_contiguous()
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tt == jt
