"""Median and MAD sigma-clip stacking (kernel K3 through its plain version)
and the sort-and-sum of the sort-network microbenchmarks (K5/K6 through
theirs), held against nightlight_tpu and a per-pixel NumPy oracle on the
CPU."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nightlight_tpu.ops.stack_pallas as sp
from nightlight_tpu.ops import stack as jstk
from nightlight_tpu_torch.ops import sortnet_cuda, stack_cuda
from nightlight_tpu_torch.ops import stack as tstk
from test_go_oracles import go_median
from test_torch_stack import _check, frames_with_nans

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_N_SEEDS = [(6, 21), (16, 22), (26, 23)]


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run the Pallas kernels in interpret mode, as the JAX package's own
    CPU tests do; restored afterwards."""
    monkeypatch.setattr(sp, "INTERPRET", True)


def _port(f, mad, sigma=2.5, ref=42.5):
    return stack_cuda.stack_single_pass(torch.from_numpy(f), ref, sigma, sigma, mad=mad)


@pytest.mark.parametrize("n,seed", _N_SEEDS)
@pytest.mark.parametrize("mad", [False, True])
def test_k3_plain_matches_pallas(pallas_interpret, n, seed, mad):
    """Against the TPU kernel in interpret mode: clip counts exactly,
    outputs to 1e-5 relative (test_torch_stack._check states why)."""
    f = frames_with_nans(seed, n)
    j = sp.stack_single_pass_pallas(jnp.asarray(f), 42.5, 2.5, 2.5, mad=mad)
    t = _port(f, mad)
    _check(j, t)
    assert float(t[0][0]) == 42.5  # no valid sample -> ref_loc
    if mad:
        assert int(t[1]) > 0 and int(t[2]) > 0
    else:
        assert int(t[1]) == int(t[2]) == 0


@pytest.mark.parametrize("n,seed", _N_SEEDS)
def test_k3_plain_matches_xla_twins(n, seed):
    """The JAX package's XLA twins (the path its CPU CLI runs): the median
    is a selection, so it agrees exactly; MAD within _check's band."""
    f = frames_with_nans(seed, n)
    med = _port(f, False)[0]
    np.testing.assert_array_equal(med.numpy(), np.asarray(jstk.stack_median(jnp.asarray(f), 42.5)))
    _check(jstk.stack_mad_sigma(jnp.asarray(f), 42.5, 2.5, 2.5), _port(f, True))


def test_k3_even_counts_and_empty_kept_set():
    """Even valid counts average the two middle samples; at sigma 0.1 many
    pixels keep no sample and give 0.0, not ref_loc (ops/stack.py
    stack_mad_sigma); the all-missing pixel still gives ref_loc."""
    f = frames_with_nans(5, 6)
    f[:, 1] = [1.0, 2.0, np.nan, 3.0, 10.0, np.nan]  # 4 valid: median 2.5
    t_med = _port(f, False)[0]
    assert float(t_med[1]) == 2.5
    t = _port(f, True, sigma=0.1)
    j = jstk.stack_mad_sigma(jnp.asarray(f), 42.5, 0.1, 0.1)
    _check(j, t)
    cnt = (~np.isnan(f)).sum(0)
    empty = (cnt > 0) & (t[0].numpy() == 0.0)
    assert empty.sum() > 100
    assert float(t[0][0]) == 42.5


def _oracle(frames, ref, sigma_lo, sigma_hi, mad):
    """Per-pixel NumPy transliteration of the reference's median and MAD
    stacks (stack.go:274-303, 536-605) on go_median."""
    n, p = frames.shape
    out = np.empty(p, np.float32)
    clo = chi = 0
    slo, shi = np.float32(sigma_lo), np.float32(sigma_hi)
    for i in range(p):
        g = frames[:, i]
        g = np.sort(g[~np.isnan(g)])
        if g.size == 0:
            out[i] = ref
            continue
        m = np.float32(go_median(g))
        if not mad:
            out[i] = m
            continue
        std = np.float32(go_median(np.abs(g - m))) * np.float32(1.4826)
        lo, hi = m - slo * std, m + shi * std
        keep = g[(g >= lo) & (g <= hi)]
        clo += int((g < lo).sum())
        chi += int((g > hi).sum())
        acc = np.float32(0.0)
        for v in keep:
            acc = np.float32(acc + v)
        out[i] = acc / np.float32(max(keep.size, 1))
    return out, clo, chi


@pytest.mark.parametrize("mad", [False, True])
def test_k3_plain_matches_numpy_oracle(mad):
    f = frames_with_nans(31, 11, 600)
    o, clo, chi = _oracle(f, 42.5, 2.5, 2.5, mad)
    t = _port(f, mad)
    np.testing.assert_array_equal(t[0].numpy(), o)
    assert (int(t[1]), int(t[2])) == (clo, chi)


def test_median_ignores_weights_and_weighted_mad_raises():
    """Dispatch of ops/stack.py as the JAX package's: median has no
    weighted variant, and weighted MAD raises its error."""
    f = frames_with_nans(9, 7, 500)
    w = np.linspace(0.5, 2.0, 7).astype(np.float32)
    a = tstk.stack(torch.from_numpy(f), tstk.StackMode.Median, weights=torch.from_numpy(w),
                   ref_frame_loc=3.0)
    b = tstk.stack(torch.from_numpy(f), tstk.StackMode.Median, ref_frame_loc=3.0)
    j = jstk.stack(jnp.asarray(f), jstk.StackMode.Median, weights=jnp.asarray(w),
                   ref_frame_loc=3.0)
    np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
    np.testing.assert_array_equal(a[0].numpy(), np.asarray(j[0]))
    with pytest.raises(NotImplementedError) as je:
        jstk.stack(jnp.asarray(f), jstk.StackMode.MADSigma, weights=jnp.asarray(w))
    with pytest.raises(NotImplementedError) as te:
        tstk.stack(torch.from_numpy(f), tstk.StackMode.MADSigma, weights=torch.from_numpy(w))
    assert str(te.value) == str(je.value)


def test_cuda_tensor_never_reaches_plain_version():
    """On a CUDA tensor K3's wrapper launches the kernel or raises: its
    dispatch names the plain version only under the CPU branch, and the
    CUDA entry refuses a CPU tensor."""
    import inspect

    src = inspect.getsource(stack_cuda.stack_single_pass)
    cpu_branch, rest = src.split('if frames.device.type == "cpu":')
    assert "stack_single_pass_plain" not in cpu_branch
    assert rest.strip().splitlines()[0].strip().startswith("return stack_single_pass_plain(")
    assert "stack_single_pass_cuda(" in rest and rest.count("_plain") == 1
    cuda_src = inspect.getsource(stack_cuda.stack_single_pass_cuda)
    assert "_plain" not in cuda_src and "except" not in cuda_src
    for mad in (False, True):
        with pytest.raises(ValueError, match="CUDA"):
            stack_cuda.stack_single_pass_cuda(torch.zeros(4, 8), 0.0, 2.5, 2.5, mad)


def _microbench_layout():
    spec = importlib.util.spec_from_file_location(
        "jax_microbench_layout", os.path.join(ROOT, "scripts", "microbench_layout.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sort_sum_input(kind: str) -> np.ndarray:
    """(40, P) float32 columns of one kind, from a seed: normal samples with
    a few 3.0e38 and +inf; small integers (heavy ties); -0.0 and 0.0 mixed
    with -1 and 1, with columns of zeros of both signs and of -0.0 alone;
    whole columns of 3.0e38 (and of +inf) among normal ones; normal samples
    at a ragged P."""
    rng = np.random.default_rng(4)
    p = 4093 if kind == "ragged" else 4096
    x = (rng.normal(size=(40, p)) * 2.0 + 100.0).astype(np.float32)
    if kind == "normal_big_inf":
        x[rng.uniform(size=x.shape) < 0.01] = 3.0e38
        x[rng.uniform(size=x.shape) < 0.005] = np.inf
    elif kind == "integer_ties":
        x = rng.integers(0, 6, size=(40, p)).astype(np.float32)
    elif kind == "signed_zeros":
        x = rng.integers(-1, 2, size=(40, p)).astype(np.float32)
        x[x == 0] = np.where(rng.uniform(size=int((x == 0).sum())) < 0.5, -0.0, 0.0)
        x[:, ::7] = np.where(rng.uniform(size=(40, len(range(0, p, 7)))) < 0.5, -0.0, 0.0)
        x[:4, 1::7] = -0.0
        x[:, 3::7] = -0.0  # all -0.0: the sum is -0.0
    elif kind == "big_columns":
        x[:, ::16] = 3.0e38
        x[:, 1::32] = np.inf
    return x


@pytest.mark.parametrize("kind", ["normal_big_inf", "integer_ties", "signed_zeros",
                                  "big_columns", "ragged"])
def test_sort_sum_plain_matches_jax_sort_sum(kind):
    """sort_sum_plain against the microbenchmark's pure-jnp sort-and-sum
    (_sort_sum_rows on the 64-row padded network) bit for bit (as int32
    words, so a zero's sign counts): both sort exactly and add the same
    rows in the same order. 3.0e38 and +inf samples exercise the mask of
    the rows above row 0; ties, signed zeros, whole columns of 3.0e38 or
    +inf and a ragged P the order and the edges."""
    mb = _microbench_layout()
    x = _sort_sum_input(kind)
    assert x.shape[0] == mb.N
    p = x.shape[1]
    rows = [jnp.asarray(x[i]) for i in range(mb.N)]
    rows += [jnp.full((p,), 3.0e38, jnp.float32) for _ in range(mb.N_PAD - mb.N)]
    j = np.asarray(mb._sort_sum_rows(rows, mb.N))
    t = sortnet_cuda.sort_sum(torch.from_numpy(x))
    np.testing.assert_array_equal(t.numpy().view(np.int32), j.view(np.int32))


def test_sort_sum_checks_shape():
    with pytest.raises(ValueError, match="40"):
        sortnet_cuda.sort_sum(torch.zeros(8, 16))
    with pytest.raises(ValueError, match="float32"):
        sortnet_cuda.sort_sum(torch.zeros(40, 16, dtype=torch.float64))
