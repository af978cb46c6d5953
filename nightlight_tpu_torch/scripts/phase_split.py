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
chip_smoke.py; and `rgb` on the channel masters of fixtures.gen_channels:
lrgb_4096 (R, G, B, L at the CLI defaults) and sho_4096 (S, H, O with the
narrowband flags). Each configuration runs
`--warmup` times, then once measured with every phase function wrapped:
the wrapper synchronises the card on entry and exit and books the time
to its phase, less the time of phases nested inside it (star detection
inside the fused preprocess, for example). "rest" is the wall less every
phase: operator dispatch, reference selection, histogram match and the
host work between phases.

    python -m nightlight_tpu_torch.scripts.phase_split [--size 4096] [--warmup 2] \
        [--configs mad30,median16_lsEst1,osc12_G,lrgb_4096] [--out FILE --tag TEXT]
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
import importlib
import io
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path

import torch

from nightlight_tpu_torch import cli, fixtures, kernels

# phase -> (module, attribute path) of each function booked to it
PHASES = {
    "load (FITS read, H2D, decode)": [("nightlight_tpu_torch.io.fits", "read_file")],
    "fused preprocess": [("nightlight_tpu_torch.models.fastpath", "run_fused_preprocess")],
    "star detection": [("nightlight_tpu_torch.detect.stars", "find_stars_batch"),
                       ("nightlight_tpu_torch.detect.stars", "find_stars")],
    "align": [("nightlight_tpu_torch.align.aligner", "Aligner.align_batch"),
              ("nightlight_tpu_torch.align.aligner", "Aligner.align_one")],
    "warp": [("nightlight_tpu_torch.ops.resample", "warp_shift_batch"),
             ("nightlight_tpu_torch.ops.resample", "project")],
    "stack (goal-seek + kernels)": [("nightlight_tpu_torch.ops.findsigma",
                                     "find_sigmas_and_stack")],
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
# name, lights, extra CLI flags, CFA pattern of the lights (None: mono)
CONFIGS = (("auto30", 30, (), None), ("auto16", 16, (), None), ("auto8", 8, (), None),
           ("mad30", 30, ("-stMode", "4"), None),
           ("median16_lsEst1", 16, ("-stMode", "0", "-lsEst", "1"), None),
           ("osc12_G", 12, ("-cfa", "RGGB", "-debayer", "G", "-stMode", "3"), "RGGB"))
SHO_FLAGS = ("-neutSigmaLow", "0.7", "-neutSigmaHigh", "1.0", "-scnr", "0.5", "-chromaBy", "1.2",
             "-chromaFrom", "295", "-chromaTo", "40", "-rotFrom", "100", "-rotTo", "190",
             "-rotBy", "-30")
# name, channel masters (fixtures.gen_channels) in the order given to `rgb`,
# extra CLI flags
COLOR_CONFIGS = (("lrgb_4096", (("r", 1.0), ("g", 0.8), ("b", 0.6), ("l", 1.0)), ()),
                 ("sho_4096", (("s", 0.9), ("h", 1.0), ("o", 0.7)), SHO_FLAGS))
BUILD = Path(__file__).resolve().parents[2] / "build"


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
            owner = importlib.import_module(mod_name)
            *outer, name = path.split(".")
            for part in outer:
                owner = getattr(owner, part)
            original = getattr(owner, name)
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


def run_stack(lights, out: str, flags=(), command: str = "stack") -> float:
    """The CLI's `command` on `lights`; its wall in seconds. `rgb` also
    writes its JPEG, as a user's run does."""
    jpg = out.replace(".fits", ".jpg") if command == "rgb" else ""
    args = ["-out", out, "-jpg", jpg, "-log", "", *flags, command, *lights]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(args)
    torch.cuda.synchronize()
    if rc != 0:
        raise RuntimeError(f"{command} {out}: rc {rc}")
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
        for key in ["wall_s", *next(iter(a.values()))["phases_s"]]:
            def value(row):
                return row[key] if key == "wall_s" else row["phases_s"][key]
            stats = {}
            for side, rows in (("A", a), ("B", b)):
                q = statistics.quantiles([value(r) for r in rows.values()], n=4)
                stats[side] = {"median": q[1], "q1": q[0], "q3": q[2], "runs": len(rows)}
            stats["B_faster_pairs"] = sum(value(b[i]) < value(a[i]) for i in pairs)
            stats["pairs"] = len(pairs)
            out.setdefault(config, {})[key] = stats
    print(json.dumps(out, indent=1))
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=4096, help="frame edge in pixels")
    ap.add_argument("--warmup", type=int, default=2, help="unmeasured stacks per configuration")
    ap.add_argument("--out", help="append each JSON line to this file too")
    ap.add_argument("--tag", default="", help="mark of this run's lines in --out")
    ap.add_argument("--summarise", metavar="FILE", help="summarise the A/B lines of FILE")
    ap.add_argument("--configs", default=",".join(c[0] for c in CONFIGS + COLOR_CONFIGS),
                    help="comma-separated configurations to run (default: all)")
    opts = ap.parse_args(argv)
    if opts.summarise:
        return summarise(opts.summarise)
    if not torch.cuda.is_available():
        raise SystemExit("phase_split: no CUDA device")
    out_path = os.path.abspath(opts.out) if opts.out else None
    kernels.library()
    results = []
    BUILD.mkdir(exist_ok=True)
    work = tempfile.mkdtemp(prefix="phase-split-", dir=BUILD)
    cwd = os.getcwd()
    try:
        chosen = opts.configs.split(",")
        unknown = set(chosen) - {c[0] for c in CONFIGS + COLOR_CONFIGS}
        if unknown:
            raise SystemExit(f"phase_split: unknown configurations {sorted(unknown)}")
        lights = {}  # CFA pattern (None: mono), or colour configuration -> inputs
        for name, channels, _ in (c for c in COLOR_CONFIGS if c[0] in chosen):
            lights[name] = [os.path.relpath(p, work) for p in fixtures.gen_channels(
                os.path.join(work, name), opts.size, seed=7, channels=channels)]
        for bayer in dict.fromkeys(c[3] for c in CONFIGS if c[0] in chosen):
            sub = os.path.join(work, bayer or "mono")
            n_max = max(c[1] for c in CONFIGS if c[0] in chosen and c[3] == bayer)
            lights[bayer] = [os.path.relpath(p, work)
                             for p in fixtures.gen(sub, n_max, opts.size, seed=7, bayer=bayer)]
        os.chdir(work)
        runs = [(name, lights[bayer][:n], ("-dark", os.path.join(bayer or "mono", "dark.fits"),
                                           *flags), "stack")
                for name, n, flags, bayer in CONFIGS if name in chosen]
        runs += [(name, lights[name], flags, "rgb")
                 for name, _, flags in COLOR_CONFIGS if name in chosen]
        for name, inputs, flags, command in runs:
            for _ in range(opts.warmup):
                run_stack(inputs, f"{name}.fits", flags, command)
            clock = PhaseClock()
            kernels.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            with phases_wrapped(clock):
                wall = run_stack(inputs, f"{name}.fits", flags, command)
            n = len(inputs)
            row = {"config": name, "tag": opts.tag, "lights": n,
                   "flags": list(flags[2:] if command == "stack" else flags),
                   "size": opts.size,
                   "device": torch.cuda.get_device_name(0), "wall_s": wall,
                   "phases_s": dict(clock.seconds, rest=wall - sum(clock.seconds.values())),
                   "launches": kernels.launch_counts(),
                   "peak_gib": torch.cuda.max_memory_allocated() / (1 << 30)}
            print(json.dumps(row), flush=True)
            if out_path:
                with open(out_path, "a") as f:
                    f.write(json.dumps(row) + "\n")
            results.append(row)
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    return results


if __name__ == "__main__":
    main()
