"""The per-frame operator path of the `stack` slice: the per-frame saves
(-pre, -post, -stars, -batch) and the -lsEst 0 failure, held against the
JAX CLI on the CPU."""

import contextlib
import glob
import io
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nightlight_tpu import cli as jcli
from nightlight_tpu.image import Image as JImage
from nightlight_tpu.models import fastpath as jfast
from nightlight_tpu.models import presets as jpresets
from nightlight_tpu.ops import stats as jstats
from nightlight_tpu.pipeline import context as jctx
from nightlight_tpu_torch import cli as tcli
from nightlight_tpu_torch.image import Image as TImage
from nightlight_tpu_torch.io import fits as tfits
from nightlight_tpu_torch.models import fastpath as tfast
from nightlight_tpu_torch.models import presets as tpresets
from nightlight_tpu_torch.ops import stats as tstats
from nightlight_tpu_torch.pipeline import context as tctx
from test_torch_cli import _compare_logs, _fixture, run_main

torch.set_num_threads(1)

_SAVES = ("-pre", "pre%d.fits", "-post", "post%d.fits", "-stars", "stars%d.fits",
          "-batch", "batch%d.fits")


def _run_in(d, cli_mod, flags):
    cwd = os.getcwd()
    os.chdir(d)
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = run_main(cli_mod, ["-out", "out.fits", "-log", "", "-jpg", "", *flags,
                                    "stack", "light*.fits"])
        return rc, buf.getvalue()
    finally:
        os.chdir(cwd)


def _two_dirs(tmp_path, n, size):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    _fixture(str(jdir), n, size)
    shutil.copytree(jdir, tdir)
    return str(jdir), str(tdir)


def test_per_frame_saves_match_jax(tmp_path):
    """-pre/-post/-stars/-batch take the per-frame path (the star-image save
    needs the frame loop) and write the same files as the JAX CLI: the
    calibrated frames exactly; the warped frames, star discs and stacks
    within the transform band of test_torch_cli (star centroids sum in
    another order, ~1e-5 px)."""
    jdir, tdir = _two_dirs(tmp_path, 6, 256)
    rc_j, jlog = _run_in(jdir, jcli, _SAVES)
    rc_t, tlog = _run_in(tdir, tcli, _SAVES)
    assert rc_j == 0 and rc_t == 0, tlog[-2000:]
    reason = ("Fused batch executor off (starDetect with a per-frame star-image save); "
              "using the per-frame operator path.")
    assert reason in jlog and reason in tlog
    _compare_logs(jlog, tlog, exact_seek=True, per_frame=True)

    names = sorted(os.path.basename(p) for p in glob.glob(os.path.join(jdir, "*.fits")))
    assert names == sorted(os.path.basename(p) for p in glob.glob(os.path.join(tdir, "*.fits")))
    for prefix in ("pre", "post", "stars", "batch"):
        assert any(n.startswith(prefix) for n in names), prefix
    for name in names:
        if name.startswith("light"):
            continue
        a = tfits.read_file(os.path.join(jdir, name)).to_numpy()
        b = tfits.read_file(os.path.join(tdir, name)).to_numpy()
        assert a.shape == b.shape, name
        assert np.array_equal(np.isnan(a), np.isnan(b)), name
        a, b = np.nan_to_num(a), np.nan_to_num(b)
        if name.startswith("pre"):
            np.testing.assert_array_equal(b, a, err_msg=name)
            continue
        rel = np.abs(a - b) / np.maximum(np.abs(a), 1.0)
        assert np.median(rel) <= 1e-5 and np.mean(rel > 1e-4) <= 2e-3 and rel.max() <= 0.1, name


def test_mean_stddev_estimator_fails_like_jax(tmp_path):
    """-lsEst 0: mean/stddev is inflated by the stars, nothing clears 15
    sigma, and alignment stops with the JAX CLI's error and rc -1."""
    jdir, tdir = _two_dirs(tmp_path, 4, 128)
    rc_j, jlog = _run_in(jdir, jcli, ("-lsEst", "0"))
    rc_t, tlog = _run_in(tdir, tcli, ("-lsEst", "0"))
    assert rc_j == rc_t == -1
    err = "Error: Unable to align without star detections in reference frame"
    assert err in jlog.splitlines() and err in tlog.splitlines()
    _compare_logs(jlog, tlog, exact_seek=True, per_frame=True)


@pytest.mark.parametrize("argv", [
    (), ("-pre", "p%d.fits"), ("-stars", "s%d.fits"), ("-pre", "p.fits", "-stars", "s.fits"),
    ("-bpSigLow", "0"), ("-starSig", "0"), ("-backGrid", "64", "-back", "b%d.fits"),
    ("-preScale", "2"), ("-post", "q%d.fits", "-batch", "b%d.fits"),
    ("-debayer", "G"), ("-debayer", "R", "-cfa", "BGGR", "-stMode", "3"),
    ("-debandH", "50"), ("-debandV", "60", "-debandVSigma", "0"), ("-binning", "2"),
    ("-preScale", "1.5", "-preOffset", "0.01"),
    ("-debayer", "R", "-debandH", "50", "-debandV", "50", "-preScale", "1.5", "-binning", "2",
     "-backGrid", "128", "-backClip", "4"),
    ("-debayer", "B", "-lsEst", "1"), ("-debayer", "G", "-pre", "p%d.fits"),
])
@pytest.mark.parametrize("no_fused", [False, True])
def test_fused_reasons_match_jax(monkeypatch, argv, no_fused):
    """The preset's decision between the fused executor and the per-frame
    path, and its reason, word for word the JAX package's."""
    if no_fused:
        monkeypatch.setenv("NIGHTLIGHT_NO_FUSED", "1")
    full = ["-out", "x.fits", *argv, "stack", "a.fits"]
    decisions = []
    for cli_mod, presets in ((jcli, jpresets), (tcli, tpresets)):
        args = cli_mod.build_parser().parse_args(full)
        cli_mod.apply_command_defaults(args)
        op = presets.build_command_seq(args).steps[1]
        decisions.append((op.fused_spec is None, op.fused_reason))
    assert decisions[0] == decisions[1]
    assert (decisions[1][1] is not None) == decisions[1][0]


@pytest.mark.parametrize("ls_mode", [0, 1, 2, 3, 4])
def test_fused_batch_eligible_matches_jax(ls_mode):
    """The run-time check on a loaded batch: only the default estimator
    keeps the fused executor, with the JAX package's reason otherwise."""
    img = np.zeros((8, 8), np.float32)
    jc = jctx.new_context(log=io.StringIO(), ls_mode=jstats.LSEstimatorMode(ls_mode))
    tc = tctx.new_context(log=io.StringIO(), ls_mode=tstats.LSEstimatorMode(ls_mode),
                          device="cpu")
    j = jfast.fused_batch_eligible([JImage.from_naxisn([8, 8], jnp.asarray(img))], jc)
    t = tfast.fused_batch_eligible([TImage.from_numpy(img)], tc)
    assert j == t
    assert t[0] == (ls_mode == 3)
