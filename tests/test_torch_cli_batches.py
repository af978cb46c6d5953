"""The `stack` slice with -stMemory small enough for several random batches:
the memory solver's plan, the batch permutation and the incremental
stack-of-stacks, held against the JAX CLI on the CPU."""

import contextlib
import io
import os
import random

import numpy as np
import torch

from nightlight_tpu import cli as jcli
from nightlight_tpu_torch import cli as tcli
from nightlight_tpu_torch.io import fits as tfits
from test_torch_cli import _compare_logs, _fixture, run_main

torch.set_num_threads(1)


def _run(cli_mod, out, flags=()):
    # both packages permute the frames with the global `random` module
    random.seed(3)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run_main(cli_mod, ["-out", out, "-log", "", "-stMemory", "4", *flags, "stack",
                                "light*.fits"])
    return rc, buf.getvalue()


def test_cli_stack_random_batches_match_jax(tmp_path, monkeypatch):
    """14 frames of 256x256 under -stMemory 4 with 4 threads: the solver
    plans 2 random batches of 7 (sigma clip each, goal-seeked), then the
    batch stacks are averaged. Same log (bands as in test_torch_cli) and
    output within band."""
    n, size = 14, 256
    _fixture(str(tmp_path), n, size)
    monkeypatch.chdir(tmp_path)
    # the thread count enters the batch plan; pin it for both packages
    monkeypatch.setattr(os, "cpu_count", lambda: 4)
    rc_j, jlog = _run(jcli, "jax.fits")
    rc_t, tlog = _run(tcli, "port.fits")
    assert rc_j == 0 and rc_t == 0, tlog[-2000:]
    assert "Using 2 random batches of size 7 with 4 images in parallel." in tlog
    assert tlog.count("Stacking 7 frames with stacking mode 2 ") == 2
    tlog_cmp = tlog.replace("port.fits", "jax.fits").replace("port.jpg", "jax.jpg").replace(
        "port.html", "jax.html")
    _compare_logs(jlog, tlog_cmp, exact_seek=True)

    a = tfits.read_file("jax.fits").to_numpy()
    b = tfits.read_file("port.fits").to_numpy()
    assert a.shape == b.shape == (size, size) and np.isfinite(b).all()
    rel = np.abs(a - b) / np.maximum(np.abs(a), 1.0)
    # the band of test_torch_cli: a pixel whose clip decision flipped in
    # one batch moves by a few percent divided by the batch count
    assert np.median(rel) <= 1e-5 and np.mean(rel > 1e-4) <= 2e-3 and rel.max() <= 0.1


def test_cli_stack_random_batches_per_frame_match_jax(tmp_path, monkeypatch):
    """The same two random batches of 7 on the per-frame operator path
    (-lsEst 2, IKSS): each batch logs why the fused executor is off, runs
    the operators frame by frame and stacks; same log (per-frame lines in
    any order, bands as in test_torch_cli) and output within band."""
    n, size = 14, 256
    _fixture(str(tmp_path), n, size)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(os, "cpu_count", lambda: 4)
    flags = ("-lsEst", "2")
    rc_j, jlog = _run(jcli, "jax.fits", flags)
    rc_t, tlog = _run(tcli, "port.fits", flags)
    assert rc_j == 0 and rc_t == 0, tlog[-2000:]
    assert "Using 2 random batches of size 7 with 4 images in parallel." in tlog
    off = ("Fused batch executor off (non-default location/scale estimator 2); "
           "using the per-frame operator path.")
    assert jlog.count(off) == tlog.count(off) == 2
    assert tlog.count("Stacking 7 frames with stacking mode 2 ") == 2
    tlog_cmp = tlog.replace("port.fits", "jax.fits").replace("port.jpg", "jax.jpg").replace(
        "port.html", "jax.html")
    # a sample within the transform band of a clip bound moves one count
    # of the goal-seek, which can then take one more bisection step: both
    # searches must reach the 0.50% target (exact_seek=False), and a batch
    # stacked at sigmas a few thousandths apart has statistics within 1e-3
    _compare_logs(jlog, tlog_cmp, exact_seek=False, per_frame=True, stacked_rel=1e-3)

    a = tfits.read_file("jax.fits").to_numpy()
    b = tfits.read_file("port.fits").to_numpy()
    assert a.shape == b.shape == (size, size) and np.isfinite(b).all()
    rel = np.abs(a - b) / np.maximum(np.abs(a), 1.0)
    assert np.median(rel) <= 1e-5 and np.mean(rel > 1e-4) <= 2e-3 and rel.max() <= 0.1
