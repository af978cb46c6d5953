"""The port's CLI `run` against the JAX CLI on the repo's three example jobs
(examples/stack_l_channel.json, lrgb_combine.json, narrowband_hubble.json),
each on generated inputs of the file names the job reads."""

import contextlib
import io
import os
import shutil

import numpy as np
import pytest
import torch

from nightlight_tpu import cli as jcli
from nightlight_tpu_torch import cli as tcli
from nightlight_tpu_torch import fixtures
from nightlight_tpu_torch.image import Image as TImage
from nightlight_tpu_torch.io import fits as tfits
from test_torch_cli import _compare_logs, _fixture, run_main
from test_torch_cli_rgb import jax_log_lines

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _stack_inputs(d):
    """lights/light00..05.fits (the test_torch_cli fixture, 256^2) and the
    masters the job names: a dark of 5 +- 0.5 and a flat with a 10% ramp."""
    os.makedirs(os.path.join(d, "lights"))
    os.makedirs(os.path.join(d, "masters"))
    _fixture(os.path.join(d, "lights"), 6, 256)
    rng = np.random.default_rng(9)
    dark = rng.normal(5.0, 0.5, (256, 256)).astype(np.float32)
    flat = (0.95 + 0.1 * np.linspace(0.0, 1.0, 256, dtype=np.float32)[None, :]
            * np.ones((256, 1), np.float32))
    for name, data in (("dark", dark), ("flat", flat)):
        tfits.write_file(TImage.from_numpy(data), os.path.join(d, "masters", f"{name}.fits"))
    return ["stacked_L.fits"]


def _channel_inputs(d, channels, names):
    """The channel masters of fixtures.gen_channels at 256^2, under the
    stacked_<X>.fits names of the job."""
    for f, name in zip(fixtures.gen_channels(d, 256, channels=channels), names):
        os.rename(f, os.path.join(d, f"stacked_{name}.fits"))


_JOBS = {
    "stack_l_channel": (_stack_inputs, "stacked_L.fits", (256, 256)),
    "lrgb_combine": (lambda d: _channel_inputs(d, fixtures.LRGB_CHANNELS, "LRGB"), "lrgb.fits",
                     (3, 256, 256)),
    "narrowband_hubble": (lambda d: _channel_inputs(d, fixtures.SHO_CHANNELS, ("S2", "Ha", "O3")),
                          "hubble.fits", (3, 256, 256)),
}


def _run(d, cli_mod):
    cwd = os.getcwd()
    os.chdir(d)
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = run_main(cli_mod, ["-log", "", "-job", "job.json", "run"])
        return rc, buf.getvalue()
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("job", sorted(_JOBS))
def test_cli_run_example_job_matches_jax(tmp_path, job):
    """The job JSON echoed as the JAX CLI echoes it (key order and number
    formatting), the same log line for line (per-frame lines in any order;
    decimals within one unit of their last digit), and the output within
    the bands of the direct commands: the stack as test_cli_stack_matches_jax
    states it, the colour composites 2e-5 absolute."""
    make, out, shape = _JOBS[job]
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    make(str(jdir))
    shutil.copy(os.path.join(ROOT, "examples", f"{job}.json"), jdir / "job.json")
    shutil.copytree(jdir, tdir)
    rc_j, jlog = _run(jdir, jcli)
    rc_t, tlog = _run(tdir, tcli)
    assert rc_j == 0 and rc_t == 0, tlog[-3000:]
    assert "Error" not in tlog
    echo = tlog.split("\nRunning JSON job:\n")[1].split("\n}\n")[0]
    assert echo == jlog.split("\nRunning JSON job:\n")[1].split("\n}\n")[0]
    _compare_logs(jax_log_lines(jlog), tlog, exact_seek=True, per_frame=job == "stack_l_channel")
    a = tfits.read_file(str(jdir / out)).to_numpy()
    b = tfits.read_file(str(tdir / out)).to_numpy()
    assert a.shape == b.shape == shape and np.isfinite(b).all()
    if job == "stack_l_channel":
        rel = np.abs(a - b) / np.maximum(np.abs(a), 1.0)
        assert np.median(rel) <= 1e-5 and np.mean(rel > 1e-4) <= 2e-3 and rel.max() <= 0.1
    else:
        assert np.abs(a - b).max() <= 2e-5
    for f in os.listdir(jdir):
        if f.endswith(".jpg"):
            assert os.path.getsize(tdir / f) > 0
