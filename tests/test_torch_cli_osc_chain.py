"""The whole one-shot-colour chain of the port's CLI `stack` (debayer R, both
debands, -preScale, -binning 2, -backGrid with -backClip) and the
per-frame background save (-backGrid -back), held against the JAX CLI on
the same small fixtures. Beside tests/test_torch_cli_osc.py so that the
two files' JAX CLI runs, which compile for most of their time, run on two
workers."""

import numpy as np
import pytest
import shutil
import torch

from nightlight_tpu import cli as jcli
from nightlight_tpu_torch import cli as tcli
from nightlight_tpu_torch.io import fits as tfits
from test_torch_cli import _compare_logs, _fixture
from test_torch_cli_osc import _CHAIN, _OSC, _R_BANDS, _lines, _osc_fixture, _run_in

torch.set_num_threads(1)


def test_cli_osc_chain_matches_jax(tmp_path):
    """-debayer R with the chain, fused, binned to 128^2 (4x4 background
    cells): the same log under the bands of test_torch_cli_osc (_R_BANDS),
    every chain line for every frame, and the background-subtracted stack
    within 1e-2 absolute (its cells' order-statistic gaps), the typical
    pixel within 5e-4: 4 float32 steps of the sky near 1350 that the
    subtraction removes."""
    n = 8
    flags = (*_OSC, "-debayer", "R", *_CHAIN)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    _osc_fixture(str(jdir), n, 256)
    shutil.copytree(jdir, tdir)
    rc_j, jlog = _run_in(jdir, jcli, "out.fits", flags)
    rc_t, tlog = _run_in(tdir, tcli, "out.fits", flags)
    assert rc_j == 0 and rc_t == 0, tlog[-3000:]
    assert "Error:" not in tlog and "Fused batch executor off" not in tlog
    assert f"Stacking {n} frames with stacking mode 2 " in tlog
    for text in ("bad bayer pixels", "Debayered channel R from cfa RGGB, new size 256x256",
                 "De-banded horizontally", "De-banded vertically", "Applying pixel math",
                 "After 2x2 binning, new image size 128x128", "Background grid 32"):
        assert len(_lines(tlog, text)) == n, text
    _compare_logs(jlog, tlog, exact_seek=True, **_R_BANDS)
    a = tfits.read_file(str(jdir / "out.fits")).to_numpy()
    b = tfits.read_file(str(tdir / "out.fits")).to_numpy()
    assert a.shape == b.shape == (128, 128) and np.isfinite(b).all()
    diff = np.abs(a - b)
    assert np.median(diff) <= 5e-4 and diff.max() <= 1e-2


def test_cli_background_save_matches_jax(tmp_path):
    """-backGrid 64 -back b%d.fits: the per-frame background save takes the
    per-frame path with the JAX package's reason; the same log and the same
    background images within band. The band: a star-mask rim pixel that
    flips (the centroids sit ~1e-5 px from XLA's) moves its cell's trimmed
    median by an order-statistic gap, noise * sqrt(2 pi) / pixels = 2 * 2.5
    / 4096 = 1.2e-3 in a 64x64 cell; 4 such gaps, 5e-3."""
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    _fixture(str(jdir), 6, 256)
    shutil.copytree(jdir, tdir)
    flags = ("-backGrid", "64", "-back", "b%d.fits")
    rc_j, jlog = _run_in(jdir, jcli, "out.fits", flags)
    rc_t, tlog = _run_in(tdir, tcli, "out.fits", flags)
    assert rc_j == 0 and rc_t == 0, tlog[-3000:]
    reason = ("Fused batch executor off (backExtract with a per-frame background save); "
              "using the per-frame operator path.")
    assert reason in jlog and reason in tlog
    assert len(_lines(tlog, "Background grid 64 cells 4x4")) == 6
    _compare_logs(jlog, tlog, exact_seek=True, per_frame=True, abs_floats=5e-3)
    for i in range(6):
        a = tfits.read_file(str(jdir / f"b{i}.fits")).to_numpy()
        b = tfits.read_file(str(tdir / f"b{i}.fits")).to_numpy()
        np.testing.assert_allclose(b, a, rtol=0, atol=5e-3)
