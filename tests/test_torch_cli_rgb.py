"""The port's CLI `rgb` / `lrgb` against the JAX CLI on the same channel
masters (nightlight_tpu_torch.fixtures.gen_channels, the recipe of
scripts/gen_fixtures.py): three channels, four with the luminance last, and
the narrowband (SHO) flag set of bench.py's bench_narrowband and the
ngc7635-nb walkthrough."""

import contextlib
import io
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image as PILImage

from nightlight_tpu import cli as jcli
from nightlight_tpu_torch import cli as tcli
from nightlight_tpu_torch import fixtures
from nightlight_tpu_torch.io import fits as tfits
from test_torch_cli import _compare_logs, run_main

torch.set_num_threads(1)

SHO_FLAGS = ("-neutSigmaLow", "0.7", "-neutSigmaHigh", "1.0", "-scnr", "0.5", "-chromaBy", "1.2",
             "-chromaFrom", "295", "-chromaTo", "40", "-rotFrom", "100", "-rotTo", "190",
             "-rotBy", "-30")


def jax_log_lines(log: str) -> str:
    """The JAX CLI's log without its bulk loader's transfer summary
    ("Ingest: ..."), a line of the JAX package's host-to-TPU upload that
    the port has no counterpart of."""
    return "".join(ln for ln in log.splitlines(keepends=True) if not ln.startswith("Ingest: "))


def run_rgb(d, cli_mod, names, flags=(), out="o"):
    """`rgb` on `names` in directory d, FITS, TIFF and JPEG out; (rc, log)."""
    cwd = os.getcwd()
    os.chdir(d)
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = run_main(cli_mod, ["-out", f"{out}.fits", "-tiff", f"{out}.tif", "-log", "",
                                    *flags, "rgb", *names])
        return rc, buf.getvalue()
    finally:
        os.chdir(cwd)


def compare_outputs(jdir, tdir, out="o"):
    """FITS within 2e-5 absolute (values in [0, 1]; the HSLuv round trip's
    steps, carried through the stretch) with the typical pixel within 1e-6;
    TIFF and JPEG within one level (a pixel on a quantization edge)."""
    a = tfits.read_file(os.path.join(jdir, f"{out}.fits")).to_numpy()
    b = tfits.read_file(os.path.join(tdir, f"{out}.fits")).to_numpy()
    assert a.shape == b.shape and a.shape[0] == 3 and np.isfinite(b).all()
    diff = np.abs(a - b)
    assert diff.max() <= 2e-5 and np.median(diff) <= 1e-6, (diff.max(), np.median(diff))
    for ext in ("tif", "jpg"):
        pa = np.asarray(PILImage.open(os.path.join(jdir, f"{out}.{ext}"))).astype(np.int64)
        pb = np.asarray(PILImage.open(os.path.join(tdir, f"{out}.{ext}"))).astype(np.int64)
        assert pa.shape == pb.shape and pa.shape[-1] == 3
        assert np.abs(pa - pb).max() <= 1, ext


@pytest.mark.parametrize("case", ["rgb", "lrgb", "sho"])
def test_cli_rgb_matches_jax(tmp_path, case):
    """The same log line for line (per-frame load and detection lines in
    any order, the JAX CLI runs them on a thread pool; decimals within one
    unit of their last digit), the outputs within compare_outputs' bands.
    lrgb: the 4th input is the luminance (its reference for %rgb is file 3),
    as the JAX package takes it."""
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    if case == "sho":
        fixtures.gen_channels(str(jdir), 256, channels=fixtures.SHO_CHANNELS)
        names, flags = ["chan_s.fits", "chan_h.fits", "chan_o.fits"], SHO_FLAGS
    else:
        fixtures.gen_channels(str(jdir), 256)
        names, flags = ["chan_r.fits", "chan_g.fits", "chan_b.fits"], ()
        if case == "lrgb":
            names.append("chan_l.fits")
    shutil.copytree(jdir, tdir)
    rc_j, jlog = run_rgb(jdir, jcli, names, flags)
    rc_t, tlog = run_rgb(tdir, tcli, names, flags)
    assert rc_j == 0 and rc_t == 0, tlog[-3000:]
    assert "Error" not in tlog and "Auto-stretching HSL" in tlog
    ref = "Using image 3 with score 0 as alignment reference." if case == "lrgb" else (
        "as alignment reference.")
    assert ref in tlog
    assert ("Applying luminance image to luminance channel" in tlog) == (case == "lrgb")
    if case == "sho":
        for text in ("Neutralizing background", "Multiplying LCH chroma", "Rotating LCH hue",
                     "Applying SCNR"):
            assert text in tlog, text
    _compare_logs(jax_log_lines(jlog), tlog, exact_seek=True)
    compare_outputs(str(jdir), str(tdir))
