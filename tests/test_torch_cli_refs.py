"""The last inputs of the port's CLI against the JAX CLI on the fixture of
tests/test_torch_cli.py: the `stats` command, `stack -normHist 3` (the
black-point histogram match) and `stack` with an external reference file
for -alignRef and -histoRef."""

import contextlib
import io
import os
import re
import shutil

import numpy as np
import torch

from nightlight_tpu import cli as jcli
from nightlight_tpu_torch import cli as tcli
from nightlight_tpu_torch.io import fits as tfits
from test_torch_cli import _compare_logs, _fixture, _same_numbers, run_main

torch.set_num_threads(1)

_MATCH = re.compile(r"(after matching reference histogram).*$", re.M)


def _run(d, cli_mod, cmd, flags):
    cwd = os.getcwd()
    os.chdir(d)
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = run_main(cli_mod, ["-out", "o.fits", "-log", "", *flags, cmd, "light*.fits"])
        return rc, buf.getvalue()
    finally:
        os.chdir(cwd)


def _both(tmp_path, cmd, flags):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    _fixture(str(jdir), 6, 256)
    # an external reference: a copy of a light under another name
    shutil.copy(jdir / "light02.fits", jdir / "ref.fits")
    shutil.copytree(jdir, tdir)
    rc_j, jlog = _run(jdir, jcli, cmd, flags)
    rc_t, tlog = _run(tdir, tcli, cmd, flags)
    assert rc_j == 0 and rc_t == 0, tlog[-3000:]
    assert "Error" not in tlog
    return jdir, tdir, jlog, tlog


def test_cli_stats_matches_jax(tmp_path):
    """`stats`: per-frame loads, detections and statistics rows, the same
    log (any frame order) and the same report rows."""
    jdir, tdir, jlog, tlog = _both(tmp_path, "stats", ())
    assert len([ln for ln in tlog.splitlines() if " Stars 10 " in ln]) == 6
    assert "Stacking" not in tlog
    _compare_logs(jlog, tlog, exact_seek=True, per_frame=True)
    rows = [sorted(re.findall(r"^  ,\[.*\]$", open(d / "o.html").read(), re.M))
            for d in (jdir, tdir)]
    assert len(rows[1]) == 6
    # numbers as the log's: the HFR sums in another order, its last digit
    assert all(_same_numbers(a, b) for a, b in zip(*rows)), rows


def _stack_band(jdir, tdir):
    """The stacked FITS in the band of test_cli_stack_matches_jax: typical
    pixels within 1e-5, a pixel whose clip decision flipped a few percent."""
    a = tfits.read_file(str(jdir / "o.fits")).to_numpy()
    b = tfits.read_file(str(tdir / "o.fits")).to_numpy()
    assert a.shape == b.shape == (256, 256) and np.isfinite(b).all()
    rel = np.abs(a - b) / np.maximum(np.abs(a), 1.0)
    assert np.median(rel) <= 1e-5 and np.mean(rel > 1e-4) <= 2e-3 and rel.max() <= 0.1


def test_cli_stack_normhist3_matches_jax(tmp_path):
    """-normHist 3: each frame's black point shifted so its location lands
    on the reference's. The same log but for what the match line prints of
    the reference's statistics: the reference frame's own match clears
    them, and whether the JAX CLI's other frames print them recomputed or
    "(no stats yet)" depends on its thread pool's timing; the port runs the
    frames in order and prints them recomputed."""
    jdir, tdir, jlog, tlog = _both(tmp_path, "stack", ("-normHist", "3"))
    lines = [ln for ln in tlog.splitlines() if "after matching reference histogram" in ln]
    assert len(lines) == 6
    assert lines[0] == "0: (no stats yet) after matching reference histogram (no stats yet)"
    assert all(ln.endswith(lines[1].split("histogram ")[1]) and " Location " in ln
               for ln in lines[1:])
    assert "Stacking 6 frames with stacking mode 2 " in tlog
    _compare_logs(_MATCH.sub(r"\1", jlog), _MATCH.sub(r"\1", tlog), exact_seek=True,
                  per_frame=True)
    _stack_band(jdir, tdir)


def test_cli_stack_external_reference_matches_jax(tmp_path):
    """An external reference file: loaded as image -3 and star-detected,
    neither frame of the set; every light is aligned to it. The same log,
    the stacked image's statistics within 1e-3 relative: every frame,
    light02 too, now passes a transform whose centroid sums differ at ~1e-5
    px between XLA and torch, and the sampled Qn scale of the stack moves by
    a few order-statistic gaps (as with -lsEst 1 in test_torch_cli)."""
    flags = ("-alignRef", "ref.fits", "-histoRef", "ref.fits")
    jdir, tdir, jlog, tlog = _both(tmp_path, "stack", flags)
    for target in ("alignment", "histogram"):
        assert f"using loaded image -3 as {target} reference" in tlog
    assert "-3: Loaded 256x256 image" in tlog and "-3: Stars 10 " in tlog
    assert len(re.findall(r"^\d: Transform ", tlog, re.M)) == 6
    _compare_logs(jlog, tlog, exact_seek=True, per_frame=True, stacked_rel=1e-3)
    _stack_band(jdir, tdir)
