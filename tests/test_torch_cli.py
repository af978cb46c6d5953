"""The whole `stack` slice: the JAX CLI and the port's CLI on the same small
fixture, plus the port's import and dispatch guarantees: every command is
ported, and those that need the card (the pipeline commands and `serve`)
raise without one unless the caller passes the CPU."""

import contextlib
import inspect
import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from nightlight_tpu import cli as jcli
from nightlight_tpu.models import presets as jpresets
from nightlight_tpu.ops import stats as jstats
from nightlight_tpu_torch import cli as tcli
from nightlight_tpu_torch.image import Image as TImage
from nightlight_tpu_torch.io import fits as tfits
from nightlight_tpu_torch.models import presets as tpresets
from nightlight_tpu_torch.ops import sortnet_cuda, stack_cuda

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    """Importing every module of the port leaves jax and nightlight_tpu
    out of sys.modules (fresh interpreter)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import nightlight_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'nightlight_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'nightlight_tpu.'))"
        " or m == 'nightlight_tpu']\n"
        "print('BAD', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


@pytest.mark.parametrize("wrapper,plain,kernel", [
    (stack_cuda.stack_sigma, "stack_sigma_plain", "stack_sigma_cuda"),
    (stack_cuda.stack_linfit, "stack_linfit_plain", "stack_linfit_cuda"),
    (stack_cuda.stack_single_pass, "stack_single_pass_plain", "stack_single_pass_cuda"),
    (sortnet_cuda.sort_sum, "sort_sum_plain", "sort_sum_cuda"),
])
def test_stack_wrappers_raise_rather_than_fall_back(wrapper, plain, kernel):
    """A CUDA tensor goes to the kernel or raises: the plain version is
    reachable only from the CPU branch, and the kernel entry refuses
    anything but a CUDA tensor."""
    src = inspect.getsource(wrapper)
    cpu_branch = re.split(r'if \w+\.device\.type == "cpu":', src)[1].strip().splitlines()[0]
    assert cpu_branch.startswith(f"return {plain}(")
    assert src.count(plain) == 1 and f"return {kernel}(" in src
    assert "try:" not in src and "except" not in src
    mod = inspect.getmodule(wrapper)
    args = (0.0, 2.0, 2.0) if mod is stack_cuda else ()
    with pytest.raises(ValueError, match="CUDA"):
        getattr(mod, kernel)(torch.zeros(3, 8), *args)


def _stack_args(parser_mod, argv):
    args = parser_mod.build_parser().parse_args(argv)
    parser_mod.apply_command_defaults(args)
    return args


def test_job_json_identical():
    argv = ["-out", "x.fits", "-dark", "d.fits", "stack", "a.fits", "b.fits"]
    j = jpresets.build_command_seq(_stack_args(jcli, argv)).to_json()
    t = tpresets.build_command_seq(_stack_args(tcli, argv)).to_json()
    assert j == t


def run_main(cli_mod, argv):
    """cli_mod.main(argv); the port's on the CPU, which it takes only when
    asked. The JAX CLI sets its package-wide default estimator from -lsEst;
    the default is restored after the run, so that later tests in the same
    worker see the JAX package's own default."""
    if cli_mod is tcli:
        return cli_mod.main(argv, device="cpu")
    saved = jstats.DEFAULT_LS_ESTIMATOR
    try:
        return cli_mod.main(argv)
    finally:
        jstats.DEFAULT_LS_ESTIMATOR = saved


def test_serve_without_a_card_raises(tmp_path, monkeypatch):
    """`serve` resolves its device as the pipeline commands do: without a
    CUDA device, and without device="cpu", main raises before it warms,
    sandboxes or binds anything."""
    from nightlight_tpu_torch.serve import rest as trest

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(trest, "serve", lambda *a, **k: pytest.fail("serve was reached"))
    with contextlib.redirect_stdout(io.StringIO()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(["-log", "", "serve"])


def test_cli_without_a_card_raises(tmp_path, monkeypatch):
    """No silent CPU fallback: without a CUDA device, cli.main and
    new_context raise unless the caller passes the CPU."""
    from nightlight_tpu_torch.pipeline import context as tctx

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with contextlib.redirect_stdout(io.StringIO()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(["-log", "", "stretch", "x.fits"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tctx.new_context(log=io.StringIO())
    assert tctx.new_context(log=io.StringIO(), device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("script,message", [
    ("mesh_cards", "no CUDA device"), ("microbench_layout", "needs a CUDA device"),
    ("microbench_tile", "needs a CUDA device")])
def test_measurement_scripts_without_a_card_raise(monkeypatch, script, message):
    """The measurement scripts time the card and nothing else: without a
    CUDA device they stop before any work."""
    import importlib

    mod = importlib.import_module(f"nightlight_tpu_torch.scripts.{script}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match=message):
        mod.main([])


@pytest.mark.parametrize("command, expect", [
    ("version", "Version "), ("legal", "ABSOLUTELY NO WARRANTY"), ("help", "usage:")])
def test_cli_commands_without_tensors_run_without_a_card(tmp_path, monkeypatch, command,
                                                         expect):
    """version, legal and help touch no tensor and answer without a CUDA
    device, as the JAX CLI does."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tcli.main(["-log", "", command])
    assert rc == 0 and expect in buf.getvalue()


# ---------------------------------------------------------------------------
# The slice end to end
# ---------------------------------------------------------------------------

_STARS = [(60, 80), (200, 150), (400, 300), (100, 400), (330, 90), (450, 450),
          (250, 320), (150, 250), (380, 180), (60, 350)]


def _fixture(d, n, size, seed=7):
    """The verify recipe (fwhm 8, flux 5500, noise 2 about 100) scaled to
    size x size, drifting (0.7, -0.4) px per frame, float32 FITS."""
    rng = np.random.default_rng(seed)
    k = size / 512
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    s = 8.0 / 2.3548
    for i in range(n):
        img = rng.normal(100.0, 2.0, size=(size, size)).astype(np.float32)
        for sx, sy in _STARS:
            img += 5500.0 / (2 * np.pi * s * s) * np.exp(
                -(((xx - sx * k - 0.7 * i) ** 2) + ((yy - sy * k + 0.4 * i) ** 2)) / (2 * s * s))
        im = TImage.from_numpy(img)
        im.exposure = 120.0
        tfits.write_file(im, os.path.join(d, f"light{i:02d}.fits"))


def _run(cli_mod, out, flags=()):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run_main(cli_mod, ["-out", out, "-log", "", *flags, "stack", "light*.fits"])
    return rc, buf.getvalue()


_FRAME_LINE = re.compile(r"^-?\d+: ")
_NUM = re.compile(r"[-+]?\d+(?:\.\d+)?")
_SEEK = ("Step ", "Reached ", "Warning: ", "Newton method", "Subsampled goal-seek")


def _normalize(log):
    """Lines without the timing line; each run of per-frame lines sorted,
    because the JAX CLI runs frames on a thread pool and their order varies
    from run to run."""
    out, run = [], []
    for line in log.splitlines():
        if line.startswith("Done after"):
            continue
        if _FRAME_LINE.match(line):
            run.append(line)
            continue
        out.extend(sorted(run))
        run = []
        out.append(line)
    return out + sorted(run)


def _same_numbers(a, b, rel_floats=0.0, abs_floats=0.0):
    """Text equal outside numbers; integers equal; decimals within one unit
    of their last printed digit (float32 means and centroid sums accumulate
    in another order in XLA than in torch), or within rel_floats relative
    or abs_floats absolute."""
    ta, tb = _NUM.split(a), _NUM.split(b)
    na, nb = _NUM.findall(a), _NUM.findall(b)
    if ta != tb or len(na) != len(nb):
        return False
    for x, y in zip(na, nb):
        if "." in x:
            unit = 10.0 ** -len(x.split(".")[1])
            if abs(float(x) - float(y)) > max(unit * 1.0001, rel_floats * abs(float(x)),
                                              abs_floats):
                return False
        elif x != y:
            return False
    return True


def _compare_line(a, b, stacked, exact_seek, stacked_rel, frame_rel=0.0, clip_band=None,
                  abs_floats=0.0):
    if stacked and a.startswith("Clipped low"):
        # Band: the frames reach the stack through transforms whose
        # centroid sums differ at ~1e-5 px between XLA and torch, and a
        # sample within that of a clip bound flips. At the same accepted
        # sigmas the totals agree to 0.1% of the clipped count; after a
        # Newton search that stepped differently (linear fit), both
        # still sit on the 0.50% target, to 2%. Percentages as printed.
        band = clip_band or (0.001 if exact_seek else 0.02)
        ca = [int(v) for v in _NUM.findall(a)[::2]]
        cb = [int(v) for v in _NUM.findall(b)[::2]]
        assert all(abs(x - y) <= max(2, band * x) for x, y in zip(ca, cb)), (a, b)
        assert _NUM.findall(a)[1::2] == _NUM.findall(b)[1::2], (a, b)
    elif stacked:
        # the stacked image's statistics inherit that band (stacked_rel)
        assert _same_numbers(a, b, rel_floats=stacked_rel, abs_floats=abs_floats), (a, b)
    else:
        assert _same_numbers(a, b, rel_floats=frame_rel, abs_floats=abs_floats), (a, b)


def _keyed_lines(log):
    """The per-frame operator path of the JAX CLI runs frames on a thread
    pool and defers part of its log, so its per-frame lines and the stats
    report's header/footer lines (written straight through while other
    lines wait in the deferred buffer) may come in any order, even before
    the run's first lines. Returns the other lines in order and those lines
    keyed by (frame id, text with numbers blanked), each with whether it
    follows a stack in its batch."""
    other, frames = [], {}
    stacked = False
    for line in log.splitlines():
        if line.startswith("Done after") or line.startswith(_SEEK):
            continue
        if line.startswith("Starting batch"):
            stacked = False
        elif line.startswith("Stacking "):
            stacked = True
        m = _FRAME_LINE.match(line)
        if m or line.startswith("Writing statistics "):
            key = (m.group() if m else "", _NUM.sub("#", line))
            frames.setdefault(key, []).append((line, stacked))
        else:
            other.append((line, stacked))
    return other, frames


def _compare_logs(jlog, tlog, exact_seek, per_frame=False, stacked_rel=1e-5, frame_rel=0.0,
                  clip_band=None, abs_floats=0.0):
    """frame_rel: a relative band for the decimals of the lines before the
    stack, beside the one unit of their last digit (_same_numbers);
    abs_floats: an absolute band for every decimal; clip_band: the relative
    band of the clip totals, when not _compare_line's."""
    if per_frame:
        jo, jf = _keyed_lines(jlog)
        to, tf = _keyed_lines(tlog)
        assert len(jo) == len(to), (len(jo), len(to))
        for (a, s), (b, _) in zip(jo, to):
            _compare_line(a, b, s, exact_seek, stacked_rel, frame_rel, clip_band,
                              abs_floats)
        assert sorted(jf) == sorted(tf), set(jf) ^ set(tf)
        for key, rows in jf.items():
            assert len(rows) == len(tf[key]), (key, len(rows), len(tf[key]))
            for (a, s), (b, _) in zip(rows, tf[key]):
                _compare_line(a, b, s, exact_seek, stacked_rel, frame_rel, clip_band,
                              abs_floats)
    else:
        j = [ln for ln in _normalize(jlog) if not ln.startswith(_SEEK)]
        t = [ln for ln in _normalize(tlog) if not ln.startswith(_SEEK)]
        assert len(j) == len(t), (len(j), len(t))
        stacked = False
        for a, b in zip(j, t):
            if a.startswith("Stacking "):
                stacked = True
            _compare_line(a, b, stacked, exact_seek, stacked_rel, frame_rel, clip_band,
                          abs_floats)
    js = [ln for ln in jlog.splitlines() if ln.startswith(_SEEK)]
    ts = [ln for ln in tlog.splitlines() if ln.startswith(_SEEK)]
    if exact_seek:
        assert js == ts
    else:
        # linear fit's Newton search steps on clip-count derivatives, which
        # the band above can move; both must still reach the target
        assert js[-1].startswith("Reached 0.50% and 0.50%") and ts[-1].startswith(
            "Reached 0.50% and 0.50%"), (js[-1], ts[-1])
        sj = [float(v) for v in _NUM.findall(js[-1])[-2:]]
        st = [float(v) for v in _NUM.findall(ts[-1])[-2:]]
        assert all(abs(x - y) <= 0.05 for x, y in zip(sj, st)), (sj, st)


_PER_FRAME = "Fused batch executor off (non-default location/scale estimator "


@pytest.mark.parametrize("n,mode,exact_seek,flags", [
    pytest.param(6, 2, True, (), id="6-2-True"),
    pytest.param(26, 5, False, (), id="26-5-False"),
    # 6 frames like the first case: the JAX CLI reuses its compiled programs
    pytest.param(6, 0, True, ("-stMode", "0"), id="median"),
    pytest.param(6, 4, True, ("-stMode", "4"), id="mad"),
    pytest.param(6, 4, True, ("-lsEst", "1", "-stMode", "4"), id="lsEst1-mad"),
    pytest.param(6, 0, True, ("-lsEst", "2", "-stMode", "0"), id="lsEst2-median"),
    pytest.param(6, 2, True, ("-lsEst", "4"), id="lsEst4-sigma"),
])
def test_cli_stack_matches_jax(tmp_path, monkeypatch, n, mode, exact_seek, flags):
    """JAX CLI and port CLI on the same frames, defaults or the given
    stacking mode / estimator: the same log (see _compare_logs for the
    stated bands), the same stacking mode, the per-frame operator path
    exactly where the JAX CLI takes it, and a stacked FITS within band."""
    size = 256
    _fixture(str(tmp_path), n, size)
    monkeypatch.chdir(tmp_path)
    rc_j, jlog = _run(jcli, "jax.fits", flags)
    rc_t, tlog = _run(tcli, "port.fits", flags)
    assert rc_j == 0 and rc_t == 0, tlog[-2000:]
    assert f"Stacking {n} frames with stacking mode {mode} " in tlog
    per_frame = "-lsEst" in flags
    assert (_PER_FRAME in jlog) == (_PER_FRAME in tlog) == per_frame
    assert ("Clipped low" in tlog) == (mode >= 2)
    tlog_cmp = tlog.replace("port.fits", "jax.fits").replace("port.jpg", "jax.jpg").replace(
        "port.html", "jax.html")
    # The sampled median/MAD of the stacked 256x256 image (-lsEst 1) draws
    # 131072 samples from 65536 pixels, so its sorted deviations sit ~1e-4
    # apart at the MAD: a stacked pixel that moves within the band above
    # shifts the median by one float32 step and the MAD by a few such gaps,
    # up to 1e-3 relative.
    stacked_rel = 1e-3 if flags[:2] == ("-lsEst", "1") else 1e-5
    _compare_logs(jlog, tlog_cmp, exact_seek, per_frame=per_frame, stacked_rel=stacked_rel)

    a = tfits.read_file("jax.fits").to_numpy()
    b = tfits.read_file("port.fits").to_numpy()
    assert a.shape == b.shape == (size, size) and np.isfinite(b).all()
    rel = np.abs(a - b) / np.maximum(np.abs(a), 1.0)
    # the same band as the clip totals: typical pixels agree to 1e-5, a
    # pixel whose clip decision flipped moves by a few percent
    assert np.median(rel) <= 1e-5 and np.mean(rel > 1e-4) <= 2e-3 and rel.max() <= 0.1
    assert os.path.exists("port.jpg") and os.path.exists("port.html")


def test_shard_on_one_device_runs_unsharded(tmp_path, monkeypatch):
    """-shard with device="cpu" (one device) prints the JAX CLI's line,
    read from its source, and runs unsharded: every other log line and the
    output equal the port's run without -shard."""
    src = inspect.getsource(jcli.main)
    m = re.search(r'"(-shard requested[^"]*)"\s*"([^"]*)\\n"', src)
    line = m.group(1) + m.group(2)
    assert line == "-shard requested but only one device attached; running unsharded"
    _fixture(str(tmp_path), 6, 256)
    monkeypatch.chdir(tmp_path)
    rc_s, log_s = _run(tcli, "shard.fits", ("-shard",))
    rc_u, log_u = _run(tcli, "plain.fits")
    assert rc_s == 0 and rc_u == 0, log_s[-2000:]
    lines = [ln for ln in log_s.splitlines() if not ln.startswith("Done after")]
    assert lines.count(line) == 1 and lines[1] == line  # after the estimator line
    lines.remove(line)
    assert "\n".join(lines).replace("shard.", "X.") == "\n".join(
        ln for ln in log_u.splitlines() if not ln.startswith("Done after")).replace(
        "plain.", "X.")
    np.testing.assert_array_equal(tfits.read_file("shard.fits").to_numpy(),
                                  tfits.read_file("plain.fits").to_numpy())
