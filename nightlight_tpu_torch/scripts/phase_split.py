"""Where the wall of a CLI `stack` or `rgb` goes, phase by phase, on an
NVIDIA GPU.

Runs the port's CLI `stack` on the fixtures of nightlight_tpu_torch/
fixtures.py (BITPIX-16 lights and a master dark, seed 7) in its auto mode
at 30, 16 and 8 lights (linear fit, winsorized and sigma clip, each with
its goal-seek), with -stMode 4 at 30 (MAD, kernel K3 on the fused path) and
with -stMode 0 -lsEst 1 at 16 (median through K3 on the per-frame path,
whose preprocess falls under "rest"), and osc12_G, 12 RGGB mosaics of the
same recipe with -debayer G -stMode 3 (BASELINE config #3: the CFA repair
and the debayer run inside the fused preprocess), the flags of
chip_smoke.py; ooc48, 48 lights at the defaults under the -stMemory for
which the port's planner makes 3 random batches of 16 (plan_st_memory;
Python's random seeded before every run), the out-of-core path with the
next batch read ahead; and `rgb` on the channel masters of fixtures.gen_channels:
lrgb_4096 (R, G, B, L at the CLI defaults) and sho_4096 (S, H, O with the
narrowband flags); job16_run and job16_served, the live-stacking JSON job
of tests/test_rest.py (16 lights, no dark, the per-frame operator path, 2
batches of 8 under the -stMemory plan_st_memory finds) through the CLI
`run` and POSTed to serve/rest.py's server on a thread of this process,
its chunked log read to the end; shard4_auto16, auto16's job through
`run_op` with a device mesh of 4 shards on the one card (each frame
row-sharded from its load, the per-frame operator path), and
perframe16, the same job unsharded on the per-frame path (the fused
executor found ineligible, after the same loads and batch plan), so the
two set the mesh's cost beside the same path. Each configuration runs
`--warmup` times, then once measured with every phase function wrapped:
the wrapper synchronises the card on entry and exit and books the time
to its phase, less the time of phases nested inside it (star detection
inside the fused preprocess, for example). "rest" is the wall less every
phase: operator dispatch, reference selection, histogram match and the
host work between phases. "load" is what the consumer spends on a
frame: the read-ahead loader's `get` (its wait for a worker's read, the
decode) and every direct `read_file` (the dark; every light with
NIGHTLIGHT_NO_PREFETCH=1 or on a tree without the loader). The workers'
reads overlap the rest and are printed apart, summed over their threads
("workers_read_s"), with the frames the consumer had to read itself
("inline_reads"), the part of "load" the consumer spent waiting for a
worker ("wait_s") and the workers' seconds pinning host buffers
("pin_s"), read from the loader's spans (load.read, load.wait, load.pin)
and its inline-read counter.

The fixtures are written just before the first run, so reads hit the page
cache. With --cold every input of a configuration is dropped from the page
cache just before its measured run (evict_page_cache: fsync and
posix_fadvise DONTNEED on those files alone), and the row says
"cache": "cold". With --work DIR the fixtures go to DIR and are kept, and
files already there are used again: a later process (a first run in a
fresh process, --warmup 0) skips writing them.

    python -m nightlight_tpu_torch.scripts.phase_split [--size 4096] [--warmup 2] \
        [--configs mad30,median16_lsEst1,osc12_G,lrgb_4096] [--out FILE --tag TEXT] \
        [--cold] [--work DIR]
    python -m nightlight_tpu_torch.scripts.phase_split --summarise FILE

Prints one JSON line per configuration: the wall, the seconds of each
phase, and the kernel launches of the measured run; with --out it also
appends each line to FILE, marked with --tag. The synchronisations add
their own waits, so the phases sum to a wall slightly above an unwrapped
run's.

To compare two trees, run this script from each in turns (A, B, B, A, ...)
with --out to one file and the tags "A:<i>" and "B:<i>", i the index of
the pair; --summarise then prints, per configuration and phase, each
side's median and quartiles and in how many pairs B was the faster.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import http.client
import importlib
import io
import json
import os
import random
import shutil
import statistics
import sys
import tempfile
import threading
import time
from pathlib import Path

import torch

from nightlight_tpu_torch import cli, fixtures, kernels

# phase -> (module, attribute path) of each function booked to it
PHASES = {
    "load (FITS read, H2D, decode)": [("nightlight_tpu_torch.io.ingest", "ReadAheadLoader.get"),
                                      ("nightlight_tpu_torch.io.fits", "read_file")],
    "fused preprocess": [("nightlight_tpu_torch.models.fastpath", "run_fused_preprocess")],
    "star detection": [("nightlight_tpu_torch.detect.stars", "find_stars_batch"),
                       ("nightlight_tpu_torch.detect.stars", "find_stars"),
                       ("nightlight_tpu_torch.detect.stars", "find_stars_sharded")],
    "calibrate, bad pixel (per frame)": [("nightlight_tpu_torch.pipeline.ops_pre",
                                          "OpCalibrate.apply"),
                                         ("nightlight_tpu_torch.pipeline.ops_pre",
                                          "OpBadPixel.apply")],
    "location/scale (per frame)": [("nightlight_tpu_torch.ops.stats",
                                    "Stats._update_location_scale")],
    "histogram match (per frame)": [("nightlight_tpu_torch.pipeline.ops_post",
                                     "OpMatchHistogram.apply")],
    "mesh gathers": [("nightlight_tpu_torch.parallel.mesh", "RowSharded.gather")],
    "align": [("nightlight_tpu_torch.align.aligner", "Aligner.align_batch"),
              ("nightlight_tpu_torch.align.aligner", "Aligner.align_one")],
    "warp": [("nightlight_tpu_torch.ops.resample", "warp_shift_batch"),
             ("nightlight_tpu_torch.ops.resample", "project")],
    "stack (goal-seek + kernels)": [("nightlight_tpu_torch.ops.findsigma",
                                     "find_sigmas_and_stack"),
                                    ("nightlight_tpu_torch.ops.stack", "stack")],
    "save (FITS)": [("nightlight_tpu_torch.io.fits", "write_file")],
    "rgb combine": [("nightlight_tpu_torch.pipeline.ops_rgb", "OpRGBCombine.apply")],
    "rgb balance": [("nightlight_tpu_torch.pipeline.ops_rgb", "OpRGBBalance.apply")],
    "HSLuv conversions": [("nightlight_tpu_torch.ops.color", "linrgb_to_hsluv"),
                          ("nightlight_tpu_torch.ops.color", "hsluv_to_linrgb")],
    "HSL auto-stretch": [("nightlight_tpu_torch.pipeline.ops_hsl",
                          "OpHSLStretchIterative.apply")],
    "HSL operators (other)": [("nightlight_tpu_torch.pipeline.ops_hsl", f"{op}.apply") for op in (
        "OpHSLApplyLum", "OpHSLNeutralizeBackground", "OpHSLSaturationGamma",
        "OpHSLSelectiveSaturation", "OpHSLRotateHue", "OpHSLSCNR", "OpHSLMidtones",
        "OpHSLGamma", "OpHSLGammaPP", "OpHSLScaleOffsetChannel", "OpHSLScaleBlack",
        "OpHSLUnsharpMask")],
    "save (TIFF, JPEG)": [("nightlight_tpu_torch.io.tiff", "write_tiff16"),
                          ("nightlight_tpu_torch.io.jpeg", "write_jpg")],
}
# name, lights, extra CLI flags, CFA pattern of the lights (None: mono),
# random batches the -stMemory is planned for (None: the default budget)
CONFIGS = (("auto30", 30, (), None, None), ("auto16", 16, (), None, None),
           ("auto8", 8, (), None, None),
           ("mad30", 30, ("-stMode", "4"), None, None),
           ("median16_lsEst1", 16, ("-stMode", "0", "-lsEst", "1"), None, None),
           ("osc12_G", 12, ("-cfa", "RGGB", "-debayer", "G", "-stMode", "3"), "RGGB", None),
           ("ooc48", 48, (), None, 3))
BATCH_SEED = 3  # Python's random permutes the frames into batches
SHO_FLAGS = ("-neutSigmaLow", "0.7", "-neutSigmaHigh", "1.0", "-scnr", "0.5", "-chromaBy", "1.2",
             "-chromaFrom", "295", "-chromaTo", "40", "-rotFrom", "100", "-rotTo", "190",
             "-rotBy", "-30")
# name, channel masters (fixtures.gen_channels) in the order given to `rgb`,
# extra CLI flags
COLOR_CONFIGS = (("lrgb_4096", (("r", 1.0), ("g", 0.8), ("b", 0.6), ("l", 1.0)), ()),
                 ("sho_4096", (("s", 0.9), ("h", 1.0), ("o", 0.7)), SHO_FLAGS))
# name, lights, shards of the mesh on the one card (0: unsharded on the
# per-frame path); auto16's flags, through run_op
MESH_CONFIGS = (("shard4_auto16", 16, 4), ("perframe16", 16, 0))
# name, how the live-stacking job runs; its lights, batches and seed
JOB_CONFIGS = (("job16_run", "run"), ("job16_served", "served"))
JOB_LIGHTS, JOB_BATCHES, JOB_SEED = 16, 2, 123
BUILD = Path(__file__).resolve().parents[2] / "build"
DEVICE = "cuda:0"


def plan_st_memory(n: int, size: int, device, batches: int, flags=None) -> int:
    """The smallest -stMemory, in steps of one frame's MiB, for which the
    port's own batch planner (OpStackBatches._partition) splits n size^2
    frames into `batches` batches of n // batches on this host: the planner
    of a JSON job's stackBatches (flags None) or of the CLI `stack` with
    `flags` (the fused executor's, with its reserve for the next batch).
    Raises ValueError when no budget does."""
    from nightlight_tpu_torch.pipeline.context import new_context
    from nightlight_tpu_torch.pipeline.ops_stack import OpStackBatches

    if flags is None:
        planner = OpStackBatches()
    else:
        from nightlight_tpu_torch.models.presets import build_command_seq

        args = cli.build_parser().parse_args([*flags, "stack", "light*.fits"])
        cli.apply_command_defaults(args)
        planner = next(s for s in build_command_seq(args).steps
                       if isinstance(s, OpStackBatches))

    class Frame:
        naxisn = [size, size]
        file_name = "plan"

    frame_mib = max(1, size * size * 4 >> 20)
    for st in range(frame_mib, 4 * n * frame_mib + 1, frame_mib):
        c = new_context(log=io.StringIO(), st_memory=st, device=device)
        try:
            _, num_batches, batch_size, _ = planner._partition([Frame] * n, c)
        except ValueError:  # the budget fits no plan
            continue
        if (num_batches, batch_size) == (batches, n // batches):
            return st
    raise ValueError(f"no -stMemory plans {n} frames of {size}^2 as {batches} batches")


class PhaseClock:
    """Exclusive seconds per phase of the wrapped functions."""

    def __init__(self):
        self.seconds = {name: 0.0 for name in PHASES}
        self._stack = []  # [phase, start, seconds of nested phases]

    def wrap(self, phase, fn):
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            self._stack.append([phase, time.perf_counter(), 0.0])
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                _, start, nested = self._stack.pop()
                spent = time.perf_counter() - start
                self.seconds[phase] += spent - nested
                if self._stack:
                    self._stack[-1][2] += spent
        return timed


@contextlib.contextmanager
def phases_wrapped(clock: PhaseClock):
    """Replace each phase function by its timed wrapper wherever the port
    holds a reference to it (its module, classes, and modules that imported
    it by name); restore them afterwards."""
    undo = []
    for phase, targets in PHASES.items():
        for mod_name, path in targets:
            try:
                owner = importlib.import_module(mod_name)
            except ModuleNotFoundError:  # a tree without this module (a parent)
                continue
            *outer, name = path.split(".")
            for part in outer:
                owner = getattr(owner, part)
            original = getattr(owner, name, None)
            if original is None:  # a tree without this function (a parent)
                continue
            timed = clock.wrap(phase, original)
            holders = [(owner, name)]
            if not outer:
                holders += [(m, attr) for m in list(sys.modules.values())
                            if getattr(m, "__name__", "").startswith("nightlight_tpu_torch")
                            and m is not owner for attr, v in list(vars(m).items())
                            if v is original]
            for holder, attr in holders:
                setattr(holder, attr, timed)
                undo.append((holder, attr, original))
    try:
        yield
    finally:
        for holder, attr, original in reversed(undo):
            setattr(holder, attr, original)


def loader_seconds(spans) -> dict:
    """The read-ahead loader's seconds in `spans` (trace records): its
    workers' reads ("workers_read_s", load.read on the read-ahead-*
    threads), the consumer's waits for them ("wait_s", load.wait) and the
    pinning of host buffers ("pin_s", load.pin)."""
    out = {"workers_read_s": 0.0, "wait_s": 0.0, "pin_s": 0.0}
    for s in spans:
        key = {"load.wait": "wait_s", "load.pin": "pin_s"}.get(s.name)
        if s.name == "load.read" and s.thread_name.startswith("read-ahead"):
            key = "workers_read_s"
        if key:
            out[key] += (s.end_ns - s.start_ns) * 1e-9
    return out


@contextlib.contextmanager
def loader_reads(totals: dict):
    """Add the read-ahead loaders' workers' read seconds, inline reads,
    the consumer's waits and the pinning seconds inside the block to
    `totals`, from the program's spans and counters (nothing on a tree
    without them)."""
    try:
        from nightlight_tpu_torch import trace
    except ModuleNotFoundError:
        yield
        return
    with trace.recording():
        first = len(trace.records())
        inline0 = sum(trace.counter("load.inline_reads").values())
        try:
            yield
        finally:
            for k, v in loader_seconds(trace.records()[first:]).items():
                totals[k] += v
            totals["inline_reads"] += sum(trace.counter("load.inline_reads").values()) - inline0


def evict_page_cache(paths) -> None:
    """Drop the files `paths` from the host's page cache, so that their
    next read goes to the disk: each is flushed (fsync) and advised away
    (posix_fadvise DONTNEED). Touches nothing but these files."""
    for path in paths:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)


def live_stacking_job(out: str) -> dict:
    """tests/test_rest.py's live-stacking job (:182-195) on light*.fits,
    saving `out`."""
    return {"type": "seq", "steps": [
        {"type": "loadMany", "filePatterns": ["light*.fits"]},
        {"type": "stackBatches", "perBatch": {"type": "seq", "steps": [
            {"type": "starDetect", "radius": 16, "sigma": 15.0,
             "badPixelSigma": 5.0, "inOutRatio": 1.4},
            {"type": "selectRef", "target": 1, "mode": "%starsHFR"},
            {"type": "selectRef", "target": 0, "mode": "%starsHFR"},
            {"type": "matchHist", "mode": 2},
            {"type": "align", "k": 20, "threshold": 1.0, "oobMode": 0},
            {"type": "stack", "mode": 6, "sigmaLow": 2.75, "sigmaHigh": 2.75},
        ]}},
        {"type": "save", "filePattern": out},
    ]}


def run_job(kind: str, out: str, flags) -> float:
    """The live-stacking job on the lights of the working directory with
    -stMemory flags[1], through the CLI `run` (kind "run") or POSTed to the
    port's server on a thread, its chunked log read to the end ("served");
    its wall in seconds. Python's random is seeded first."""
    job = live_stacking_job(out)
    random.seed(JOB_SEED)
    if kind == "run":
        with open("job.json", "w") as f:
            json.dump(job, f)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["-log", "", *flags, "-job", "job.json", "run"], device=DEVICE)
        torch.cuda.synchronize()
        if rc != 0:
            raise RuntimeError(f"run {out}: rc {rc}")
        return time.perf_counter() - t0
    from nightlight_tpu_torch.serve import rest

    srv = rest.make_server(0, int(flags[1]), device=DEVICE)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        t0 = time.perf_counter()
        conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1], timeout=600)
        conn.request("POST", "/api/v1/job", body=json.dumps(job),
                     headers={"Content-Type": "application/json"})
        log = conn.getresponse().read().decode()
        conn.close()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    if "Error" in log:
        raise RuntimeError(f"served {out}: {log[-2000:]}")
    return seconds


def run_stack(lights, out: str, flags=(), command: str = "stack") -> float:
    """The CLI's `command` on `lights`; its wall in seconds. `rgb` also
    writes its JPEG, as a user's run does. Python's random is seeded
    first, so that out-of-core batches are the same in every run."""
    jpg = out.replace(".fits", ".jpg") if command == "rgb" else ""
    args = ["-out", out, "-jpg", jpg, "-log", "", *flags, command, *lights]
    random.seed(BATCH_SEED)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(args, device=DEVICE)
    torch.cuda.synchronize()
    if rc != 0:
        raise RuntimeError(f"{command} {out}: rc {rc}")
    return time.perf_counter() - t0


def run_mesh(lights, out: str, flags, shards: int) -> float:
    """The `stack` preset on `lights` through run_op with a mesh of
    `shards` shards on the card, or (0) unsharded with the fused executor
    found ineligible for each batch; its wall in seconds."""
    from nightlight_tpu_torch.models import fastpath
    from nightlight_tpu_torch.models.presets import build_command_seq
    from nightlight_tpu_torch.parallel.mesh import make_mesh
    from nightlight_tpu_torch.pipeline.context import new_context

    args = cli.build_parser().parse_args(["-out", out, "-jpg", "", "-log", "", *flags,
                                          "stack", *lights])
    cli.apply_command_defaults(args)
    c = new_context(log=io.StringIO(), device=DEVICE)
    if shards:
        c.mesh = make_mesh([torch.device(DEVICE)] * shards)
    random.seed(BATCH_SEED)
    with fastpath.per_frame_path(not shards):
        t0 = time.perf_counter()
        cli.run_op(build_command_seq(args), c)
        torch.cuda.synchronize()
        return time.perf_counter() - t0


def summarise(path: str) -> dict:
    """Per configuration and phase (and the wall): each side's median and
    quartiles over its runs, and the pairs in which side B was the faster,
    from the rows of `path` tagged "<side>:<pair>"."""
    runs = {}  # (config, side) -> {pair: row}
    with open(path) as f:
        for line in f:
            row = json.loads(line)
            side, pair = row["tag"].split(":")
            runs.setdefault((row["config"], side), {})[int(pair)] = row
    out = {}
    for config in dict.fromkeys(c for c, _ in runs):
        a, b = runs.get((config, "A"), {}), runs.get((config, "B"), {})
        pairs = sorted(set(a) & set(b))
        keys = ["wall_s", "workers_read_s", "wait_s", "pin_s", "inline_reads"]
        first = next(iter(a.values()))
        for key in [k for k in keys if k in first] + list(first["phases_s"]):
            def value(row):
                return row[key] if key in row else row["phases_s"][key]
            stats = {}
            for side, rows in (("A", a), ("B", b)):
                q = statistics.quantiles([value(r) for r in rows.values()], n=4)
                stats[side] = {"median": q[1], "q1": q[0], "q3": q[2], "runs": len(rows)}
            stats["B_faster_pairs"] = sum(value(b[i]) < value(a[i]) for i in pairs)
            stats["pairs"] = len(pairs)
            out.setdefault(config, {})[key] = stats
    print(json.dumps(out, indent=1))
    return out


def _fixtures(paths: list, write) -> list:
    """`paths` where they all exist already (a kept --work directory), else
    what write() returns."""
    return paths if all(os.path.exists(p) for p in paths) else write()


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=4096, help="frame edge in pixels")
    ap.add_argument("--warmup", type=int, default=2, help="unmeasured stacks per configuration")
    ap.add_argument("--out", help="append each JSON line to this file too")
    ap.add_argument("--tag", default="", help="mark of this run's lines in --out")
    ap.add_argument("--summarise", metavar="FILE", help="summarise the A/B lines of FILE")
    every = CONFIGS + COLOR_CONFIGS + JOB_CONFIGS + MESH_CONFIGS
    ap.add_argument("--configs", default=",".join(c[0] for c in every),
                    help="comma-separated configurations to run (default: all)")
    ap.add_argument("--cold", action="store_true",
                    help="drop each configuration's inputs from the page cache before its "
                         "measured run")
    ap.add_argument("--work", metavar="DIR",
                    help="write the fixtures here and keep them (reused when present)")
    opts = ap.parse_args(argv)
    if opts.summarise:
        return summarise(opts.summarise)
    if not torch.cuda.is_available():
        raise SystemExit("phase_split: no CUDA device")
    out_path = os.path.abspath(opts.out) if opts.out else None
    kernels.library()
    results = []
    if opts.work:
        work = os.path.abspath(opts.work)
        os.makedirs(work, exist_ok=True)
    else:
        BUILD.mkdir(exist_ok=True)
        work = tempfile.mkdtemp(prefix="phase-split-", dir=BUILD)
    cwd = os.getcwd()
    try:
        chosen = opts.configs.split(",")
        unknown = set(chosen) - {c[0] for c in every}
        if unknown:
            raise SystemExit(f"phase_split: unknown configurations {sorted(unknown)}")
        lights = {}  # CFA pattern (None: mono), colour configuration or "job16" -> inputs
        for name, channels, _ in (c for c in COLOR_CONFIGS if c[0] in chosen):
            sub = os.path.join(work, name)
            paths = [os.path.join(sub, f"chan_{ch}.fits") for ch, _ in channels]
            lights[name] = [os.path.relpath(p, work) for p in _fixtures(
                paths, lambda sub=sub, channels=channels: fixtures.gen_channels(
                    sub, opts.size, seed=7, channels=channels))]
        stacks = [c for c in CONFIGS if c[0] in chosen]
        stacks += [(c[0], c[1], (), None, None) for c in MESH_CONFIGS if c[0] in chosen]
        for bayer in dict.fromkeys(c[3] for c in stacks):
            sub = os.path.join(work, bayer or "mono")
            n_max = max(c[1] for c in stacks if c[3] == bayer)
            paths = [os.path.join(sub, f"light{i:03d}.fits") for i in range(n_max)]
            lights[bayer] = [os.path.relpath(p, work) for p in _fixtures(
                paths + [os.path.join(sub, "dark.fits")],
                lambda sub=sub, n=n_max, bayer=bayer: fixtures.gen(
                    sub, n, opts.size, seed=7, bayer=bayer))[:n_max]]
        if any(c[0] in chosen for c in JOB_CONFIGS):
            sub = os.path.join(work, "job16")
            paths = [os.path.join(sub, f"light{i:03d}.fits") for i in range(JOB_LIGHTS)]
            lights["job16"] = _fixtures(paths + [os.path.join(sub, "dark.fits")], lambda: (
                fixtures.gen(sub, JOB_LIGHTS, opts.size, seed=7)))[:JOB_LIGHTS]
        os.chdir(work)
        runs = []
        for name, n, flags, bayer, batches in (c for c in CONFIGS if c[0] in chosen):
            flags = ("-dark", os.path.join(bayer or "mono", "dark.fits"), *flags)
            if batches:
                st = plan_st_memory(n, opts.size, torch.device(DEVICE), batches, flags)
                flags = (*flags, "-stMemory", str(st))
            runs.append((name, lights[bayer][:n], flags, "stack"))
        runs += [(name, lights[name], flags, "rgb")
                 for name, _, flags in COLOR_CONFIGS if name in chosen]
        runs += [(name, lights[None][:n], ("-dark", os.path.join("mono", "dark.fits")),
                  f"mesh{shards}") for name, n, shards in MESH_CONFIGS if name in chosen]
        for name, kind in (c for c in JOB_CONFIGS if c[0] in chosen):
            st = plan_st_memory(JOB_LIGHTS, opts.size, torch.device(DEVICE), JOB_BATCHES)
            runs.append((name, lights["job16"], ("-stMemory", str(st)), kind))

        def run(inputs, out, flags, command):
            if command in ("stack", "rgb"):
                return run_stack(inputs, out, flags, command)
            if command.startswith("mesh"):
                return run_mesh(inputs, out, flags, int(command[4:]))
            with contextlib.chdir(os.path.join(work, "job16")):
                return run_job(command, out, flags)

        for name, inputs, flags, command in runs:
            for _ in range(opts.warmup):
                run(inputs, f"{name}.fits", flags, command)
            if opts.cold:
                evict_page_cache([*inputs, *(flags[1:2] if flags[0] == "-dark" else ())])
            clock = PhaseClock()
            reads = {"workers_read_s": 0.0, "inline_reads": 0, "wait_s": 0.0, "pin_s": 0.0}
            kernels.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            with phases_wrapped(clock), loader_reads(reads):
                wall = run(inputs, f"{name}.fits", flags, command)
            n = len(inputs)
            row = {"config": name, "tag": opts.tag, "lights": n,
                   "flags": list(flags[2:] if command == "stack" or command.startswith("mesh")
                                 else flags),
                   "size": opts.size, "cache": "cold" if opts.cold else "warm",
                   "warmup": opts.warmup,
                   "device": torch.cuda.get_device_name(0), "wall_s": wall,
                   "phases_s": dict(clock.seconds, rest=wall - sum(clock.seconds.values())),
                   **reads, "no_prefetch": bool(os.environ.get("NIGHTLIGHT_NO_PREFETCH")),
                   "launches": kernels.launch_counts(),
                   "peak_gib": torch.cuda.max_memory_allocated() / (1 << 30)}
            print(json.dumps(row), flush=True)
            if out_path:
                with open(out_path, "a") as f:
                    f.write(json.dumps(row) + "\n")
            results.append(row)
    finally:
        os.chdir(cwd)
        if not opts.work:
            shutil.rmtree(work, ignore_errors=True)
    return results


if __name__ == "__main__":
    main()
