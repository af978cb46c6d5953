"""The port's CLI `stack` over the read-ahead loader (io/ingest.py) on
BITPIX-16 lights of nightlight_tpu_torch/fixtures.py with a master dark,
under -stMemory small enough for two random batches, held against the JAX
CLI (its BulkUploader) on both the fused and the per-frame path; a light
that vanishes after the glob; and the same runs with the loader off
(NIGHTLIGHT_NO_PREFETCH=1), bit for bit. Beside the other CLI test files
so that its JAX CLI runs, which compile for most of their time, run on a
worker of their own."""

import contextlib
import glob
import io
import os
import random
import shutil

import numpy as np
import pytest
import torch

from nightlight_tpu import cli as jcli
from nightlight_tpu_torch import cli as tcli
from nightlight_tpu_torch import fixtures
from nightlight_tpu_torch.io import fits as tfits
from test_torch_cli import _compare_logs, run_main
from test_torch_cli_rgb import jax_log_lines

torch.set_num_threads(1)

N, SIZE = 14, 256
PLAN = "Using 2 random batches of size 7 with 4 images in parallel."
PREFETCHED = "Prefetched "
PATHS = {"fused": (), "per_frame": ("-lsEst", "2")}


@pytest.fixture
def lights(tmp_path, monkeypatch):
    """14 BITPIX-16 lights and the dark at 256^2 (seed 7) in tmp_path, the
    working directory; the thread count, which enters the batch plan,
    pinned to 4 for both packages."""
    fixtures.gen(str(tmp_path), N, SIZE, seed=7)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(os, "cpu_count", lambda: 4)
    return tmp_path


def _run(cli_mod, out, flags=()):
    # both packages permute the frames with the global `random` module
    random.seed(3)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run_main(cli_mod, ["-out", out, "-log", "", "-stMemory", "4", "-dark", "dark.fits",
                                *flags, "stack", "light*.fits"])
    return rc, buf.getvalue()


def _port_names(log):
    return log.replace("port.fits", "jax.fits").replace("port.jpg", "jax.jpg").replace(
        "port.html", "jax.html")


def _band(a, b):
    """test_torch_cli_batches' band: a pixel whose clip decision flipped in
    one batch moves by a few percent divided by the batch count."""
    rel = np.abs(a - b) / np.maximum(np.abs(a), 1.0)
    assert np.median(rel) <= 1e-5 and np.mean(rel > 1e-4) <= 2e-3 and rel.max() <= 0.1


@pytest.mark.parametrize("path", list(PATHS))
def test_cli_ingest_matches_jax(lights, path):
    """Two random batches of 7: the same log as the JAX CLI once its
    upload summary ("Ingest: ...") is filtered (bands of
    test_torch_cli_batches), no "Prefetched" line from either package
    (the read-ahead window holds the whole 256^2 set before batch 2 is
    announced), and the output within band."""
    flags = PATHS[path]
    rc_j, jlog = _run(jcli, "jax.fits", flags)
    rc_t, tlog = _run(tcli, "port.fits", flags)
    assert rc_j == 0 and rc_t == 0, tlog[-2000:]
    assert "Ingest: " in jlog
    assert PLAN in tlog and tlog.count("Stacking 7 frames with stacking mode 2 ") == 2
    assert PREFETCHED not in jlog and PREFETCHED not in tlog
    off = "Fused batch executor off ("
    assert jlog.count(off) == tlog.count(off) == (2 if path == "per_frame" else 0)
    jlog = jax_log_lines(jlog)
    if path == "fused":
        _compare_logs(jlog, _port_names(tlog), exact_seek=True)
    else:
        # test_torch_cli_batches' per-frame bands (a goal-seek count can
        # move one bisection step; both reach the target), and frame_rel:
        # the IKSS scale of these integer-valued frames sits 2.6e-7
        # relative (3 float32 steps) from XLA's, the reader aside (the
        # direct read gives the same digits)
        _compare_logs(jlog, _port_names(tlog), exact_seek=False, per_frame=True,
                      stacked_rel=1e-3, frame_rel=1e-6)
    a = tfits.read_file("jax.fits").to_numpy()
    b = tfits.read_file("port.fits").to_numpy()
    assert a.shape == b.shape == (SIZE, SIZE) and np.isfinite(b).all()
    _band(a, b)


@pytest.mark.parametrize("path", list(PATHS))
def test_cli_without_the_loader_is_bit_for_bit(lights, monkeypatch, path):
    """NIGHTLIGHT_NO_PREFETCH=1 stops the next batch's read-ahead (the
    JAX package's control; the loader still reads each batch ahead): the
    same log and the output bit for bit."""
    flags = PATHS[path]
    rc_on, log_on = _run(tcli, "loader_on.fits", flags)
    monkeypatch.setenv("NIGHTLIGHT_NO_PREFETCH", "1")
    rc_off, log_off = _run(tcli, "loader_off.fits", flags)
    assert rc_on == 0 and rc_off == 0, log_off[-2000:]
    assert PLAN in log_on

    def lines(log, out):
        return [ln.replace(out, "x") for ln in log.splitlines()
                if not ln.startswith("Done after")]

    assert lines(log_on, "loader_on") == lines(log_off, "loader_off")
    a = tfits.read_file("loader_on.fits").to_numpy()
    b = tfits.read_file("loader_off.fits").to_numpy()
    assert np.array_equal(a, b, equal_nan=True)


def test_cli_missing_light_gives_jax_error(tmp_path, monkeypatch):
    """A light deleted between the glob and its load: both CLIs end with
    the same error line and rc -1."""
    for side in ("jax", "port"):
        fixtures.gen(str(tmp_path / side), N, SIZE, seed=7)
    monkeypatch.setattr(os, "cpu_count", lambda: 4)
    real_glob = glob.glob

    def glob_then_delete(pattern, *args, **kwargs):
        found = real_glob(pattern, *args, **kwargs)
        if pattern == "light*.fits" and os.path.exists("light005.fits"):
            os.remove("light005.fits")
        return found

    monkeypatch.setattr(glob, "glob", glob_then_delete)
    errors = {}
    for side, cli_mod in (("jax", jcli), ("port", tcli)):
        monkeypatch.chdir(tmp_path / side)
        rc, log = _run(cli_mod, "out.fits")
        assert rc == -1, log[-2000:]
        errors[side] = [ln for ln in log.splitlines() if ln.startswith("Error: ")]
    assert errors["port"] == errors["jax"] == [
        "Error: [Errno 2] No such file or directory: 'light005.fits'"]
    shutil.rmtree(tmp_path / "jax")
