"""The one-shot-colour `stack` of the port's CLI (CFA repair, debayer,
deband) held against the JAX CLI on the same small fixtures, and the
port's fused executor against its own per-frame operator path on the whole
chain (deband, pixel math, binning, background extraction). The whole
chain against the JAX CLI: tests/test_torch_cli_osc_chain.py."""

import contextlib
import io
import os
import re
import shutil

import numpy as np
import pytest
import torch

from nightlight_tpu import cli as jcli
from nightlight_tpu_torch import cli as tcli
from nightlight_tpu_torch.image import Image as TImage
from nightlight_tpu_torch.io import fits as tfits
from test_torch_cli import _STARS, _compare_logs, run_main

torch.set_num_threads(1)

_GAINS = {"R": 1.0, "G": 0.8, "B": 0.6}


def _osc_fixture(d, n, size, cfa="RGGB", seed=5):
    """n float32 one-shot-colour lights on a dark: the ten stars of
    test_torch_cli._fixture (fwhm 8, drifting (0.7, -0.4) px per frame) at
    the sky, noise and peak-to-noise ratios of nightlight_tpu_torch.fixtures
    (sky 900, noise 20), the peaks ~12x the noise: the window in which the debayered R and B planes, smoothed by the interpolation, keep their stars through detection's bad-pixel test, mosaicked with its channel
    gains R 1.0, G 0.8, B 0.6, plus a few hot and cold pixels; dark.fits
    the mono bias of about 100 they sit on."""
    rng = np.random.default_rng(seed)
    k = size / 512
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    s = 8.0 / 2.3548
    tile = np.array([[_GAINS[cfa[0]], _GAINS[cfa[1]]], [_GAINS[cfa[2]], _GAINS[cfa[3]]]],
                    np.float32)
    gain = np.tile(tile, (size // 2, size // 2))
    dark = rng.normal(100.0, 3.0, size=(size, size)).astype(np.float32)
    tfits.write_file(TImage.from_numpy(dark), os.path.join(d, "dark.fits"))
    for i in range(n):
        sky = rng.normal(900.0, 20.0, size=(size, size)).astype(np.float32)
        for sx, sy in _STARS:
            sky += 18000.0 / (2 * np.pi * s * s) * np.exp(
                -(((xx - sx * k - 0.7 * i) ** 2) + ((yy - sy * k + 0.4 * i) ** 2)) / (2 * s * s))
        img = dark + sky * gain
        img[rng.integers(0, size, 6), rng.integers(0, size, 6)] = 30000.0
        img[rng.integers(0, size, 6), rng.integers(0, size, 6)] = 0.0
        im = TImage.from_numpy(img.astype(np.float32))
        im.exposure = 60.0
        tfits.write_file(im, os.path.join(d, f"light{i:02d}.fits"))


def _run_in(d, cli_mod, out, flags):
    cwd = os.getcwd()
    os.chdir(d)
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = run_main(cli_mod, ["-out", out, "-log", "", "-jpg", "", *flags,
                                    "stack", "light*.fits"])
        return rc, buf.getvalue()
    finally:
        os.chdir(cwd)


def _lines(log, text):
    return [ln for ln in log.splitlines() if text in ln]


_PER_FRAME = "Fused batch executor off ("
_OSC = ("-dark", "dark.fits", "-cfa", "RGGB")
_CHAIN = ("-debandH", "50", "-debandV", "50", "-preScale", "1.5", "-binning", "2",
          "-backGrid", "32", "-backClip", "2")


# Bands of the comparison with the JAX CLI, beside those of
# test_torch_cli._compare_logs:
# - frame_rel 1e-6: the JAX package's fused program takes each frame's mean
#   as a float32 sum, a few float32 steps (~3e-7 relative) from the port's
#   float64 one, up to 2 units of the 4th decimal of a sky near 720;
# - clip_band 0.2%: the warped frames differ from the JAX package's through
#   the transforms (~1e-5 px, test_torch_cli), and the interpolated
#   debayered planes put more samples within that of a clip bound;
# - stacked_rel 1e-4: a stacked pixel whose clip decision flipped can be the
#   image's minimum or maximum;
# - the background-subtracted chain (R): abs 0.1 for every decimal (7e-5 of
#   the sky near 1350 it subtracts). The star mask of the cell fit takes the
#   stars' centroids and HFRs, ~1e-5 apart from XLA's, so a pixel on a
#   mask's rim can flip and move its cell's trimmed median to a neighbouring
#   order statistic, about noise * sqrt(2 pi) / pixels = 10 * 2.5 / 1024 =
#   0.025 apart in a 32x32 cell of the binned frames; 4 such gaps. (The
#   render itself sums ~2 float32 steps apart from XLA's, test_torch_osc.)
# - -lsEst 1 (B): frame_rel 1e-4, the sampled MAD moving by a gap between
#   sorted deviations when a pixel moves by one step (test_torch_cli).
_G_BANDS = dict(frame_rel=1e-6, clip_band=0.002, stacked_rel=1e-4)
_R_BANDS = dict(frame_rel=1e-6, clip_band=0.002, stacked_rel=1e-4, abs_floats=0.1)
_B_BANDS = dict(frame_rel=1e-4, clip_band=0.002, stacked_rel=1e-3)


@pytest.mark.parametrize("n,flags,mode,per_frame,bands", [
    # BASELINE config #3 cut to 8 frames of 256^2: fused, winsorized
    pytest.param(8, (*_OSC, "-debayer", "G", "-stMode", "3"), 3, False, _G_BANDS,
                 id="osc-G-mode3"),
    # the per-frame operator path: CFA branch of OpBadPixel, OpDebayer,
    # OpDebandHoriz frame by frame
    pytest.param(6, (*_OSC, "-debayer", "B", "-debandH", "50", "-lsEst", "1"), 2, True,
                 _B_BANDS, id="osc-B-perframe"),
])
def test_cli_osc_stack_matches_jax(tmp_path, n, flags, mode, per_frame, bands):
    """JAX CLI and port CLI on the same OSC lights: the same log under
    _compare_logs' bands and the ones above (integers equal: bad bayer
    pixels, stars, dropped frames), the same stacking mode and path, the
    bayer and debayer lines, and the stacked FITS within the band of
    test_torch_cli: |a - b| / max(|a|, 1) to 1e-5 for the typical pixel, at
    most 0.2% of them beyond 1e-4, none beyond 10% (a clip decision that
    flipped)."""
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    _osc_fixture(str(jdir), n, 256)
    shutil.copytree(jdir, tdir)
    rc_j, jlog = _run_in(jdir, jcli, "out.fits", flags)
    rc_t, tlog = _run_in(tdir, tcli, "out.fits", flags)
    assert rc_j == 0 and rc_t == 0, tlog[-3000:]
    assert "Error:" not in tlog
    assert f"Stacking {n} frames with stacking mode {mode} " in tlog
    assert (_PER_FRAME in jlog) == (_PER_FRAME in tlog) == per_frame
    assert len(_lines(tlog, "bad bayer pixels")) == n
    assert len(_lines(tlog, "Debayered channel")) == n
    _compare_logs(jlog, tlog, exact_seek=True, per_frame=per_frame, **bands)
    a = tfits.read_file(str(jdir / "out.fits")).to_numpy()
    b = tfits.read_file(str(tdir / "out.fits")).to_numpy()
    assert a.shape == b.shape == (256, 256) and np.isfinite(b).all()
    rel = np.abs(a - b) / np.maximum(np.abs(a), 1.0)
    assert np.median(rel) <= 1e-5 and np.mean(rel > 1e-4) <= 2e-3 and rel.max() <= 0.1


_NUM = re.compile(r"-?\d+\.?\d*")


@pytest.mark.parametrize("cfa,flags", [
    pytest.param("RGGB", ("-debayer", "R", *_CHAIN), id="R-chain"),
    # an offset CFA: debayer crops the frames to 254x256
    pytest.param("GRBG", ("-debayer", "G", "-debandV", "60", "-debandVWindow", "32",
                          "-stMode", "1"), id="G-GRBG-debandV"),
])
def test_fused_osc_matches_per_frame_path(tmp_path, monkeypatch, cfa, flags):
    """The port's fused executor against its per-frame operator path on the
    same OSC lights, as tests/test_pipeline_configs.py holds the JAX
    package's: the per-frame lines equal up to their last printed digit
    (the fused estimator and mean run batched) and the stacked images
    within 1e-3."""
    _osc_fixture(str(tmp_path), 4, 256, cfa)
    args = ("-dark", "dark.fits", "-exportStats", "", "-cfa", cfa, *flags)
    rc_f, log_f = _run_in(tmp_path, tcli, "fused.fits", args)
    monkeypatch.setenv("NIGHTLIGHT_NO_FUSED", "1")
    rc_p, log_p = _run_in(tmp_path, tcli, "perframe.fits", args)
    assert rc_f == 0 and rc_p == 0, log_p[-3000:]
    assert _PER_FRAME not in log_f and "NIGHTLIGHT_NO_FUSED=1" in log_p

    def frame_lines(s):
        return sorted(ln for ln in s.splitlines() if re.match(r"^\d+: ", ln)
                      and "Loaded" not in ln and "Writing" not in ln)

    lf, lp = frame_lines(log_f), frame_lines(log_p)
    assert len(lf) == len(lp) > 0
    for a, b in zip(lf, lp):
        assert _NUM.sub("#", a) == _NUM.sub("#", b), (a, b)
        for x, y in zip(_NUM.findall(a), _NUM.findall(b)):
            assert float(x) == pytest.approx(float(y), rel=1e-4, abs=1e-3), (a, b)
    a = tfits.read_file(str(tmp_path / "fused.fits")).to_numpy()
    b = tfits.read_file(str(tmp_path / "perframe.fits")).to_numpy()
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    m = ~np.isnan(a)
    np.testing.assert_allclose(a[m], b[m], rtol=0, atol=1e-3)
