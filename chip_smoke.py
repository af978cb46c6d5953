"""Smoke run of the PyTorch port's main path on one NVIDIA GPU.

    python3 chip_smoke.py            # full size: 4096x4096 frames
    python3 chip_smoke.py --size 1024  # a quicker pass at a smaller frame size

1. Prints torch/CUDA versions and the card's name and power limit.
2. Builds the CUDA kernels from nightlight_tpu_torch/csrc (one nvcc per
   source, all at once, sm_90a).
3. Holds each kernel against its plain PyTorch version on the card at the
   main path's shapes, bit for bit, timing both with CUDA events (median of
   5; kernels both as 10 calls back to back and as a single call): K1
   sigma 8 frames, K1 winsorized 16, K1 weighted sigma 10 (also on
   integer-valued frames, many ties), K2 linear fit 30, K3 median 16 and
   MAD 30, all at size^2 pixels with 5% outliers and 5% NaN; K1-K3 in
   both designs, on chip and global scratch, timed in turns (scratch, on
   chip, on chip, scratch), the run failing unless the on-chip design is
   the faster; every wire-count bucket of K1 (n = 6, 15, 24, 32, 33, 65),
   K2 (n = 25, 64, 65, 96, 128, 160, 200, 256, 300) and K3 in both modes
   (n = 3, 8, 16, 30, 32, 33, 64, 65, 128, 256, 300; at odd n integer
   frames with signed zeros and all-NaN columns) on 2^20 pixels, the
   on-chip ones also timed against scratch in turns; K4 with K=2048, r=32,
   centres past the edges, the whole call and its C entry alone; K7 (the
   shift-blend warp) at the shift buckets 2, 4 and 8 on a sky with NaN and
   +-inf pixels, the edges too, two fills, a block call and
   warp_shift_batch on 8 frames, its ms a warped frame required under 0.5
   (warp_cases); K8 (phases 3-6 of star detection) on find_stars' own
   inputs from a 4096^2 and a 9576 x 6388 light at radius 16 and 8, bit
   for bit its host mirror (csrc/detect_finish_host.cpp, built with g++)
   and the sharded feed, the plain version within tolerance (a star's
   value other than the plain version's only where two candidates tie),
   at least 380 and 1,100 phase-2 survivors, and find_stars_sharded on 4
   shards bit for bit find_stars (finish_cases,
   before step 4); K5 column
   and tiled and K6 tiled at 128/256/512/1024 threads per block on (40,
   2^21) samples, the tiled layout in both designs (bulk_ring and the port's
   first, smem_sort; timed in turns, bulk_ring required the faster) and held bit
   for bit on three more inputs that take the per-thread path or a partial
   tile (sort_sum_cases); the ptxas report of the bulk_ring instantiations
   (registers, no spill). Each row of the kernel table carries the bytes and
   operations of the call, counted from the shapes (stack_work), its bound
   at 3.35 TB/s and 67 TFLOP/s float32, the share of that bound, the
   launches per stack of step 5, and for K3's median and K4 the time of
   the closest single PyTorch call (K5/K6: none computes the function;
   x.sum(0) and torch.sort(x, dim=0) are recorded as floors).
4. Writes BITPIX-16 fixtures (nightlight_tpu_torch/fixtures.py, the recipe
   of scripts/gen_fixtures.py): 48 lights and a master dark.
5. Runs the port's CLI `stack` with -dark on the first N lights: auto mode
   at 30, 16 and 8 (linear fit, winsorized, sigma clip), -stMode 4 at 30
   (MAD, fused executor), -stMode 0 -lsEst 1 at 16 (median, per-frame
   operator path), -lsEst 2 and -lsEst 4 at 8 (sigma clip, per-frame).
   Checks the return code, the stacking mode, the per-frame path line and
   the clip line where expected, the output FITS and the kernel launch
   counts of each run of the first 30; then holds two small stacks on the
   card (defaults; -stMode 4 -lsEst 1) against the same stacks on the CPU.
5e. Ingest (nightlight_tpu_torch/io/ingest.py): ooc48, all 48 lights at
   the defaults under the -stMemory for which the port's planner makes 3
   random batches of 16 (fixtures.plan_st_memory; Python's random
   seeded), the fused path out of core with the next batch read ahead
   ("Prefetched" lines), then the same with NIGHTLIGHT_NO_PREFETCH=1 (the
   loader reads each batch, but not the next one during this one's
   compute), then with the prefetch again (ooc48_again, the first run
   being the process's first out-of-core stack): outputs bit for bit,
   logs equal apart from the Prefetched lines and timing, peak memory
   under the planner's device budget, K1 and K4 launches; loader_reuse48,
   the 48 lights through the loader in a shuffled order, its pinned pool
   (4 buffers) far smaller than the frame count, each frame and its
   min/mean/max bit for bit a direct read_file.
5a. The device mesh (nightlight_tpu_torch/parallel/mesh.py), 4 shards on
   cuda:0, on step 4's lights, each frame row-sharded from its load and
   the per-frame operators run on the shards: shard4_detect16, the
   sharded detector on 16 lights against find_stars on the whole frame,
   the StarList bit for bit, K4 launched once per shard that holds a
   candidate, then K4 on the first light's haloed blocks ((size/4 + halo)
   x size) against its plain version, timed (a row of the kernel table);
   shard4_job16, tests/test_rest.py's live-stacking job on 16 lights
   through `run_op`, and shard4_auto16 and shard4_auto30, the `stack`
   preset's defaults on 16 and 30 lights + dark (mode 3 with K1, mode 5
   with K2, the goal-seek on target); shard4_stretch, `stretch` on
   auto16's stack twice, each per-pixel stretch operator taking effect in
   one of the runs. Each against the same job unsharded (the
   stacks on the per-frame path): every frame placed as 4 blocks of
   (size/4, size), no gather but the save's (the mesh's gather counter),
   the log line for line and the output bit for bit, 4x the K1/K2
   launches and K4 between 1x and 4x (once per shard with candidates),
   each run's wall and peak beside the card's name and power limit;
   mesh_step16, stack_sharded against stack on the cube of 16 lights
   (winsorized, K1) and on 30 frames of sky (linear fit, K2), bit for bit
   with equal clip counts and 4x the launches; cli_shard, the CLI's
   `stack -shard` (one card: the one-device line and an output bit for bit
   the run without -shard).
5b. The one-shot-colour chain on RGGB mosaics of the same recipe (16
   lights, mono dark): osc12_G (-debayer G -stMode 3, BASELINE config #3,
   fused), osc16_R_chain (-debayer R with both debands, -preScale 1.5,
   -binning 2, -backGrid 128 -backClip 4, -stMode 3; fused, 2048x2048 out)
   and osc8_B_perframe (-debayer B -debandH 50 -lsEst 1, per-frame path),
   each checked for its mode, path, bayer / debayer / chain lines, output
   shape and K1 and K4 launches; then `stretch` twice on osc12_G's stack
   (defaults; -blurSigma 1 -usmSigma 2 -usmGain 1), each writing finite
   FITS, TIFF and JPEG and launching K4; then a small OSC stack and a small
   stretch on the card against the same runs on the CPU.
5c. The colour commands on channel masters (fixtures.gen_channels, the
   recipe of scripts/gen_fixtures.py): lrgb_4096, `rgb` on R, G, B, L
   (gains 1.0, 0.8, 0.6, 1.0) at the CLI defaults (bench.py's bench_rgb
   with the inputs in the reference's R G B L order), and sho_4096, `rgb` on
   S, H, O (0.9, 1.0, 0.7) with bench_narrowband's flags; each checked for
   rc 0, a finite size x size x 3 output and K4 launches, its wall and peak
   memory printed. Then, at 256^2 or 512^2 with rc 0: a small LRGB on the
   card against the CPU, `run` on the three examples/*.json jobs on
   generated inputs, `stats`, a -normHist 3 stack and a stack with an
   external -alignRef file.
5d. The REST server (nightlight_tpu_torch/serve): serve_batches16, the
   live-stacking job of tests/test_rest.py (loadMany; stackBatches of
   starDetect, two selectRef, matchHist 2, align and stack mode 6 at sigma
   2.75; save) POSTed to rest.make_server on a thread over 16 of step 4's
   lights, -stMemory chosen by the port's batch planner for 2 batches of
   8; the chunked stream (over 20 chunks, each batch start in its own
   chunk, no error), a finite size^2 output and K1 and K4 launches
   checked, its wall and peak memory printed; then run_batches16, the same
   job through the CLI `run` with the same seed and budget, its output bit
   for bit the served one and its log lines equal after the job echo; two
   512^2 jobs POSTed at once (the second streams the queued notice);
   `python -m nightlight_tpu_torch.cli serve` as a subprocess answering
   ping, its schema (45 operators) and a job; ops/stats_extra.py and
   ops/color_extra.py on the card against the CPU.
6. Runs the sort-network microbenchmarks (nightlight_tpu_torch.scripts.
   microbench_layout and microbench_tile) and checks their launches and
   that every variant gives the same value.
7. Prints the bucket timings, the stack walls and the kernel table as
   JSON, and as the last line
   {"ok": true, "device": {...}}. Any failure exits non-zero before it.

Exits non-zero without a result when no CUDA device is present. Logs of
the CLI and microbenchmark runs and the ptxas report go to LOG_DIR.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import io
import json
import math
import os
import random
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
LOG_DIR = os.path.join(ROOT, "chiprun_out")

CSRC = "nightlight_tpu_torch/csrc/"
# kernel -> (source, file:line of the TPU kernel it replaces)
KERNELS = {
    "stack_clip": (CSRC + "stack_clip.cu", "nightlight_tpu/ops/stack_pallas.py:396"),
    "stack_linfit": (CSRC + "stack_linfit.cu", "nightlight_tpu/ops/stack_pallas.py:679"),
    "stack_single_pass": (CSRC + "stack_single_pass.cu",
                          "nightlight_tpu/ops/stack_pallas.py:530"),
    "gather_patches": (CSRC + "gather_patches.cu", "nightlight_tpu/ops/gather_pallas.py:41"),
    # no TPU kernel: the JAX package's shift-blend warp is XLA
    "warp_shift": (CSRC + "warp_shift.cu", "none (XLA: nightlight_tpu/ops/resample.py:57)"),
    # no TPU kernel: the JAX package's detection phases 3-6 are XLA
    "detect_finish": (CSRC + "detect_finish.cu",
                      "none (XLA: nightlight_tpu/detect/stars.py _find_stars_device)"),
}
SORT_SRC = CSRC + "sort_sum.cu"
SORT_REPLACES = {"column": "scripts/microbench_layout.py:56",   # run_flat
                 "tiled": "scripts/microbench_layout.py:75",    # run_8x
                 "sweep": "scripts/microbench_tile.py:41"}      # make_run(tile).run

# name, lights, extra CLI flags, stacking mode, kernel that must launch,
# per-frame operator path, clip line
STACKS = [
    ("auto30", 30, (), 5, "stack_linfit", False, True),
    ("auto16", 16, (), 3, "stack_clip", False, True),
    ("auto8", 8, (), 2, "stack_clip", False, True),
    ("mad30", 30, ("-stMode", "4"), 4, "stack_single_pass", False, True),
    ("median16_lsEst1", 16, ("-stMode", "0", "-lsEst", "1"), 0, "stack_single_pass", True, False),
    ("lsEst2_8", 8, ("-lsEst", "2"), 2, "stack_clip", True, True),
    ("lsEst4_8", 8, ("-lsEst", "4"), 2, "stack_clip", True, True),
]
PER_FRAME = "Fused batch executor off ("

_CHAIN = ("-debandH", "50", "-debandV", "50", "-preScale", "1.5", "-binning", "2",
          "-backGrid", "128", "-backClip", "4")
# name, lights, extra CLI flags (after -dark dark.fits -cfa RGGB), stacking
# mode (None: the auto mode of the frames stacked), per-frame operator
# path, output size divisor, per-frame lines of the chain. osc16_R_chain
# sets -stMode 3: on this star field detection keeps 4-13 stars a frame of
# the interpolated R plane, so alignment drops frames (11 of 16 kept at
# 4096^2, 6 at 1024^2), and the auto mode would follow the count.
OSC_STACKS = [
    ("osc12_G", 12, ("-debayer", "G", "-stMode", "3"), 3, False, 1, ()),
    ("osc16_R_chain", 16, ("-debayer", "R", *_CHAIN, "-stMode", "3"), 3, False, 2,
     ("De-banded horizontally", "De-banded vertically", "Applying pixel math",
      "After 2x2 binning", "Background grid 128")),
    ("osc8_B_perframe", 8, ("-debayer", "B", "-debandH", "50", "-lsEst", "1"), None, True, 1,
     ("De-banded horizontally",)),
]
STRETCHES = [("stretch", ()),
             ("stretch_blur_usm", ("-blurSigma", "1", "-usmSigma", "2", "-usmGain", "1"))]
SHO_FLAGS = ("-neutSigmaLow", "0.7", "-neutSigmaHigh", "1.0", "-scnr", "0.5", "-chromaBy", "1.2",
             "-chromaFrom", "295", "-chromaTo", "40", "-rotFrom", "100", "-rotTo", "190",
             "-rotBy", "-30")
# name, channel masters (name, gain) in the order given to `rgb`, extra flags
COLOR_RUNS = [("lrgb_4096", (("r", 1.0), ("g", 0.8), ("b", 0.6), ("l", 1.0)), ()),
              ("sho_4096", (("s", 0.9), ("h", 1.0), ("o", 0.7)), SHO_FLAGS)]


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(msg: str) -> None:
    """Print a line, and append it to LOG_DIR/chip_smoke.out (a chip run's
    printed output comes back only as its tail)."""
    print(msg, flush=True)
    os.makedirs(LOG_DIR, exist_ok=True)
    with open(os.path.join(LOG_DIR, "chip_smoke.out"), "a") as f:
        f.write(msg + "\n")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5, calls: int = 1) -> float:
    """Milliseconds per fn() on the card: `calls` calls back to back between
    two CUDA events, so the host enqueues ahead of the card and a wrapper's
    host work hides behind the kernels; the median of `reps` such runs after
    one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def frames_with_outliers(gen, n: int, p: int, device, integer: bool = False):
    """(n, p) float32 sky samples on the card: noise about 1000, 5% bright
    outliers (cosmic rays / satellites), 5% missing (NaN) samples; rounded
    to integers (the ADUs of BITPIX-16 lights, many ties) when `integer`."""
    import torch

    f = torch.randn((n, p), generator=gen, device=device) * 10.0 + 1000.0
    u = torch.rand((n, p), generator=gen, device=device)
    f = torch.where(u < 0.05, f + 2000.0, f)
    if integer:
        f = torch.round(f)
    f = torch.where((u > 0.5) & (u < 0.55), torch.full((), float("nan"), device=device), f)
    return f.contiguous()


# calls per timed run of a kernel (cuda_ms)
KERNEL_CALLS = 10

# published peaks of one H100 SXM: HBM bytes/s and float32 operations/s
# outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12


def batcher_pairs(rows: int) -> int:
    """Compare-exchanges of the odd-even merge network over the next power
    of two wires at or above `rows`, padding comparators pruned (the
    schedule of csrc/sortnet.cuh)."""
    wires = 1
    while wires < rows:
        wires *= 2
    count, p = 0, 1
    while p < wires:
        k = p
        while k >= 1:
            j = k % p
            while j + k < wires:
                for i in range(min(k, wires - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p) and i + j + k < rows:
                        count += 1
                j += 2 * k
            k //= 2
        p *= 2
    return count


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: bytes at the HBM rate or
    operations at the float32 rate, whichever is longer."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_S * 1e3
    return {"bytes": int(nbytes), "ops": int(ops), "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def stack_work(kernel: str, n: int, p: int, weighted: bool = False, winsorize: bool = False,
               mad: bool = False) -> dict:
    """Bytes and operations of one stacking call on (n, p) frames, counted
    from the shapes, for the function whatever implements it. Bytes: each
    frame sample read once, the result written once, and the two int64
    clip totals (the kernels' per-warp partials are intermediate; the
    median's totals are zeros), 4p + 16 for every kernel. Operations per
    pixel: a sort of the column on the pruned network (min and max per
    compare-exchange); for K1 4 a row to centre and prefix-sum the column
    (7 weighted) and one clip round, 16 plus two binary searches
    (winsorized: and one application of the fixed point, 32 plus two binary
    searches); for K2 3 a sample for the first count and sums and one
    round, 20 plus 24 a sample; for K3 MAD 8 a sample: the deviation (2),
    its order statistic by a merge of the two sorted runs (about 1), and
    the clip pass (5). One round is the fewest a pixel runs; how many more
    it runs depends on its data, so the bound is a floor."""
    nbytes = 4.0 * n * p + 4.0 * p + 16.0
    sort = 2.0 * batcher_pairs(n)
    search = 2.0 * math.ceil(math.log2(n + 1))
    if kernel == "stack_clip":
        extra = (7.0 if weighted else 4.0) * n + 16.0 + search
        extra += (32.0 + search) if winsorize else 0.0
    elif kernel == "stack_linfit":
        extra = 3.0 * n + 20.0 + 24.0 * n
    else:
        extra = 8.0 * n if mad else 0.0
    return bound(nbytes, (sort + extra) * p)


def kernel_ms(fn) -> dict:
    """A wrapper's ms two ways: `ms`, KERNEL_CALLS calls back to back (the
    card's time; the wrapper's host work hides behind the kernels), and
    `single_call_ms`, one call between the events, which counts the
    wrapper's host work too."""
    return {"ms": cuda_ms(fn, calls=KERNEL_CALLS), "single_call_ms": cuda_ms(fn)}


def bucket_frames(gen, n: int, p: int, device):
    """The ties a sorting network must get right: integer-valued frames
    (frames_with_outliers), one column in 64 of small integers about zero
    with -0.0 and 0.0 among them, and one column in 256 wholly missing."""
    import torch

    f = frames_with_outliers(gen, n, p, device, integer=True)
    cols = torch.arange(p, device=device)
    small = torch.randint(-2, 3, (n, p), generator=gen, device=device).to(torch.float32)
    flip = torch.rand((n, p), generator=gen, device=device) < 0.5
    small = torch.where((small == 0) & flip, torch.full((), -0.0, device=device), small)
    f = torch.where((cols % 64 == 5)[None, :], small, f)
    f = torch.where((cols % 256 == 7)[None, :], torch.full((), float("nan"), device=device), f)
    return f.contiguous()


def kernel_cases(size: int, stack_cuda, gather_cuda, kernels):
    """K1-K4 against their plain versions on the card. Returns the rows of
    the kernel table and the bucket timings."""
    import torch

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    p = size * size
    rows = []
    sig_lo, sig_hi, ref_loc = 2.5, 2.5, 0.0

    def compare(name, n, pp, got, want, exact: bool):
        """Kernel outputs against the plain version's: bit for bit (K1, K2,
        K3: the same float32 operations in the same order, -fmad=false) when
        `exact`."""
        (ok_, clo_k, chi_k), (op_, clo_p, chi_p) = got, want
        torch.cuda.synchronize()
        err = float((ok_ - op_).abs().max()) if pp else 0.0
        counts_k = (int(clo_k), int(chi_k))
        counts_p = (int(clo_p), int(chi_p))
        say(f"{name}: {n}x{pp} max_abs_err {err:.3g} clips kernel {counts_k} plain {counts_p}")
        check(err == 0.0 and counts_k == counts_p,
              f"{name}: kernel vs plain max abs error {err}, clips {counts_k} vs {counts_p}")
        return err, counts_k

    def table_row(name, kernel, n, err, times, plain_ms, work, library_ms=None, **extra):
        src, replaces = KERNELS[kernel]
        row = {"name": name, "kernel": kernel, "route": "cuda", "source": src,
               "replaces": replaces, "max_abs_err": err, **times, "plain_ms": plain_ms,
               "library_ms": library_ms, "shape": [n, p], **work,
               "share_of_bound": work["bound_ms"] / times["ms"]}
        row.update(extra)
        rows.append(row)

    def in_turns(run):
        """kernel_ms of the scratch and the on-chip design in turns
        (scratch, on chip, on chip, scratch): ({key: on-chip mean}, {key:
        scratch mean}, the four turns)."""
        turns = [kernel_ms(lambda: run(v)) for v in ("scratch", "onchip", "onchip", "scratch")]
        onchip = {k: (turns[1][k] + turns[2][k]) / 2 for k in turns[0]}
        scratch = {k: (turns[0][k] + turns[3][k]) / 2 for k in turns[0]}
        return onchip, scratch, turns

    def redesigned_case(name, kernel, n, run, library=None, clipped=True, **shape):
        """K1-K3 at a main-path shape: the on-chip design and the forced
        scratch design, each held bit for bit against the plain version, then
        timed in turns; the on-chip design must be the faster. `library`, a
        single PyTorch call timed beside them; `clipped`, whether the
        function clips (the median has zero totals)."""
        want = run("plain")
        err, counts = compare(name, n, p, run("onchip"), want, True)
        compare(name + " (scratch design)", n, p, run("scratch"), want, True)
        check((counts[0] + counts[1] > 0) == clipped, f"{name}: clip totals {counts}")
        onchip, scratch, turns = in_turns(run)
        plain_ms = cuda_ms(lambda: run("plain"))
        library_ms = None if library is None else cuda_ms(library, calls=KERNEL_CALLS)
        work = stack_work(kernel, n, p, **shape)
        say(f"{name}: on chip {onchip['ms']:.4f} ms ({onchip['single_call_ms']:.4f} single "
            f"call), scratch {scratch['ms']:.4f} ms ({scratch['single_call_ms']:.4f}), "
            f"plain {plain_ms:.3f} ms, library {library_ms} ms, "
            f"bound {work['bound_ms']:.4f} ms ({work['bound_by']})")
        check(onchip["ms"] < scratch["ms"], f"{name}: on-chip design {onchip['ms']:.3f} ms "
                                            f"not faster than scratch {scratch['ms']:.3f} ms")
        table_row(name, kernel, n, err, onchip, plain_ms, work, library_ms,
                  scratch_ms=scratch["ms"], scratch_single_call_ms=scratch["single_call_ms"],
                  turns=turns)

    def clip_run(frames, w, winsorize):
        def run(variant):
            if variant == "plain":
                return stack_cuda.stack_sigma_plain(frames, ref_loc, sig_lo, sig_hi, w, winsorize)
            return stack_cuda.stack_sigma_cuda(frames, ref_loc, sig_lo, sig_hi, w, winsorize,
                                               _force_scratch=variant == "scratch")
        return run

    def linfit_run(frames):
        def run(variant):
            if variant == "plain":
                return stack_cuda.stack_linfit_plain(frames, ref_loc, sig_lo, sig_hi)
            return stack_cuda.stack_linfit_cuda(frames, ref_loc, sig_lo, sig_hi,
                                                _force_scratch=variant == "scratch")
        return run

    def weights_for(n):
        return torch.rand((n,), generator=gen, device=dev) * 1.5 + 0.5

    def clip_case(name, n, winsorize=False, weighted=False, integer=False):
        frames = frames_with_outliers(gen, n, p, dev, integer)
        redesigned_case(name, "stack_clip", n,
                        clip_run(frames, weights_for(n) if weighted else None, winsorize),
                        weighted=weighted, winsorize=winsorize)

    def linfit_case(name, n):
        redesigned_case(name, "stack_linfit", n, linfit_run(frames_with_outliers(gen, n, p, dev)))

    def single_pass_run(frames, mad):
        def run(variant):
            if variant == "plain":
                return stack_cuda.stack_single_pass_plain(frames, ref_loc, sig_lo, sig_hi, mad)
            return stack_cuda.stack_single_pass_cuda(frames, ref_loc, sig_lo, sig_hi, mad,
                                                     _force_scratch=variant == "scratch")
        return run

    def single_pass_case(name, n, mad):
        frames = frames_with_outliers(gen, n, p, dev)
        # the one PyTorch call closest to the median: nanquantile, which
        # differs in the last bit of the even-count average and gives NaN
        # for an empty column
        library = None if mad else (lambda: torch.nanquantile(frames, 0.5, dim=0))
        redesigned_case(name, "stack_single_pass", n, single_pass_run(frames, mad), library,
                        clipped=mad, mad=mad)

    clip_case("stack_clip sigma", 8)
    clip_case("stack_clip winsorized", 16, winsorize=True)
    clip_case("stack_clip weighted sigma", 10, weighted=True)
    clip_case("stack_clip weighted sigma, integer frames", 10, weighted=True, integer=True)
    linfit_case("stack_linfit", 30)
    single_pass_case("stack_single_pass median", 16, False)
    single_pass_case("stack_single_pass mad", 30, True)
    torch.cuda.empty_cache()

    # every template bucket of K1/K2 and frame counts between them, and the
    # scratch design above the on-chip limit, on 2^20 pixels: bit for bit
    # against the plain version, and where the plan picks the on-chip design,
    # timed against the scratch design in turns (the cut-overs' evidence)
    pb = 1 << 20
    buckets = []

    def bucket(name, kernel, n, run, plan):
        want = run("plain")
        label = f"bucket {name} n={n} {plan.variant} wires={plan.wires} threads={plan.threads}"
        compare(label, n, pb, run("onchip"), want, True)
        row = {"kernel": kernel, "case": name, "n": n, "pixels": pb, **plan._asdict()}
        if plan.variant == "onchip":
            compare(label + " (scratch design)", n, pb, run("scratch"), want, True)
            onchip, scratch, _ = in_turns(run)
            row.update(onchip_ms=onchip["ms"], scratch_ms=scratch["ms"])
            say(f"{label}: on chip {onchip['ms']:.4f} ms, scratch {scratch['ms']:.4f} ms")
        buckets.append(row)

    for n in (6, 15, 24, 32, 33, 65):
        frames = frames_with_outliers(gen, n, pb, dev, integer=n % 2 == 1)
        w = weights_for(n)
        for name, winsorize, weights in (("stack_clip sigma", False, None),
                                         ("stack_clip winsorized weighted", True, w)):
            bucket(name, "stack_clip", n, clip_run(frames, weights, winsorize),
                   stack_cuda._clip_plan(n, pb, weights is not None))
    for n in (25, 64, 65, 96, 128, 160, 200, 256, 300):
        bucket("stack_linfit", "stack_linfit", n,
               linfit_run(frames_with_outliers(gen, n, pb, dev, integer=n % 2 == 1)),
               stack_cuda._linfit_plan(n, pb))
    torch.cuda.empty_cache()
    for n in (3, 8, 16, 30, 32, 33, 64, 65, 128, 256, 300):
        frames = bucket_frames(gen, n, pb, dev) if n % 2 else frames_with_outliers(gen, n, pb, dev)
        for mad in (False, True):
            bucket("stack_single_pass mad" if mad else "stack_single_pass median",
                   "stack_single_pass", n, single_pass_run(frames, mad),
                   stack_cuda._single_pass_plan(n, pb, mad))
    del frames
    torch.cuda.empty_cache()

    # K4 on a size^2 frame, K = 2048 candidates, r = 32 (65x65 windows),
    # centres up to 40 pixels past every edge
    img = torch.randn((size, size), generator=gen, device=dev) * 20.0 + 900.0
    k, r = 2048, 32
    win = 2 * r + 1
    cys = torch.randint(-40, size + 40, (k,), generator=gen, device=dev, dtype=torch.int32)
    cxs = torch.randint(-40, size + 40, (k,), generator=gen, device=dev, dtype=torch.int32)
    pk, ok_k = gather_cuda.gather_patches_cuda(img, cys, cxs, r)
    pp, ok_p = gather_cuda.patches_plain(img, cys, cxs, r)
    torch.cuda.synchronize()
    check(ok_k.dtype == torch.bool and torch.equal(ok_k, ok_p),
          "gather_patches: in-frame masks differ")
    err = float(torch.where(ok_k, (pk - pp).abs(), torch.zeros((), device=dev)).max())
    check(err == 0.0, f"gather_patches: kernel vs plain error {err}")
    times = kernel_ms(lambda: gather_cuda.gather_patches_cuda(img, cys, cxs, r))
    # the kernel alone: the C entry on buffers allocated once
    lib = kernels.library()
    out_k = torch.empty_like(pk)
    ok_buf = torch.empty_like(ok_k)
    target = kernels.launch_on(dev)

    def gather_alone():
        kernels.check(lib.nl_gather_patches(img.data_ptr(), size, size, cys.data_ptr(),
                                            cxs.data_ptr(), k, r, out_k.data_ptr(),
                                            ok_buf.data_ptr(), *target), "gather_patches")

    alone = kernel_ms(gather_alone)
    check(torch.equal(out_k, pk) and torch.equal(ok_buf, ok_k), "gather_patches: C entry differs")
    plain_ms = cuda_ms(lambda: gather_cuda.patches_plain(img, cys, cxs, r))
    # one PyTorch call for the same function on the in-frame elements:
    # advanced indexing with clamped int64 indices built outside the timing
    yy, xx, _ = gather_cuda._offsets(cys, cxs, r, size, size)
    yy_c, xx_c = yy.clamp(0, size - 1), xx.clamp(0, size - 1)
    library_ms = cuda_ms(lambda: img[yy_c, xx_c], calls=KERNEL_CALLS)
    # the in-frame elements read once, the centres read, the patch and its
    # byte mask written once; a gather does no arithmetic
    inside = int(ok_k.sum())
    work = bound(4.0 * inside + 8.0 * k + (4.0 + 1.0) * k * win * win, 0.0)
    say(f"gather_patches: K={k} r={r} on {size}x{size} max_abs_err {err:.3g} (where ok), "
        f"masks equal; call {times['ms']:.4f} ms ({times['single_call_ms']:.4f} single call), "
        f"kernel alone {alone['ms']:.4f} ms ({alone['single_call_ms']:.4f}), plain "
        f"{plain_ms:.3f} ms, img[yy_c, xx_c] {library_ms:.4f} ms, bound "
        f"{work['bound_ms']:.4f} ms")
    src, replaces = KERNELS["gather_patches"]
    rows.append({"name": "gather_patches", "kernel": "gather_patches", "route": "cuda",
                 "source": src, "replaces": replaces, "max_abs_err": err,
                 **times, "kernel_only_ms": alone["ms"],
                 "kernel_only_single_call_ms": alone["single_call_ms"], "plain_ms": plain_ms,
                 "library_ms": library_ms, "shape": [k, win, win], "in_frame": inside,
                 **work, "share_of_bound": work["bound_ms"] / times["ms"]})
    del yy, xx, yy_c, xx_c, pk, pp, ok_k, ok_p, out_k, ok_buf

    return rows, buckets


def sky_with_holes(gen, size: int, device):
    """A size^2 float32 sky on the card with 0.2% NaN and 0.1% each of +inf
    and -inf pixels, and one of each on every edge of the frame."""
    import torch

    img = torch.randn((size, size), generator=gen, device=device) * 20.0 + 900.0
    u = torch.rand((size, size), generator=gen, device=device)
    full = lambda v: torch.full((), v, device=device)  # noqa: E731
    img = torch.where(u < 0.002, full(float("nan")), img)
    img = torch.where((u >= 0.002) & (u < 0.003), full(float("inf")), img)
    img = torch.where((u >= 0.003) & (u < 0.004), full(float("-inf")), img)
    last = size - 1
    for k, v in enumerate((float("nan"), float("inf"), float("-inf"))):
        at = 100 + 7 * k
        img[0, at] = img[last, at + 1] = img[at + 2, 0] = img[at + 3, last] = v
    return img.contiguous()


# inverse transforms of the K7 cases at 4096^2 by the shift bucket (n_k,
# n_m) each plans: a dither; a dither with 0.02 degrees of rotation; 0.07
# degrees (what alignment hands the warp for these stacks lies in 2 or 4)
WARP_INVS = {2: [1.0, 0.0, 3.4, 0.0, 1.0, -2.7],
             4: [1.0001, 0.0003, -5.25, -0.0003, 0.9999, 1.5],
             8: [1.0, 0.0012, 2.2, -0.0012, 1.0, -1.3]}


def warp_inv(inv, size: int) -> list:
    """`inv` (for 4096^2) with its linear part's departure from the identity
    scaled to a size^2 frame, so that it plans the same shift bucket."""
    a, b, c, d, e, f = inv
    s = 4096.0 / size
    return [1.0 + (a - 1.0) * s, b * s, c, d * s, 1.0 + (e - 1.0) * s, f]


def warp_cases(size: int, kernels) -> list:
    """K7 (the shift-blend warp) against its plain version on the card, bit
    for bit as int32 words: the buckets 2, 4 and 8 on a size^2 sky with
    NaN and +-inf pixels (on the edges too), the out-of-bounds fill NaN and
    a non-zero one, a _project_sharded-style block call (rows [row0, row0 +
    rows) of a block of size/4 + 64 source rows); the plain version on the
    CPU once; then warp_shift_batch on 8 frames, one of them the reference
    (flag False), against the plain version frame by frame. Times: the
    wrapper (10 calls back to back, and one), the C entry alone, the plain
    version, the batch call a warped frame; the bound: the frame read once
    and written once at 3.35 TB/s. Returns the kernel table's rows."""
    import numpy as np
    import torch

    from nightlight_tpu_torch.ops import resample, warp_cuda

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    img = sky_with_holes(gen, size, dev)
    words = lambda t: t.contiguous().view(torch.int32)  # noqa: E731
    src, replaces = KERNELS["warp_shift"]
    work = bound(8.0 * size * size, 0.0)
    rows = []
    for bucket, inv in WARP_INVS.items():
        inv = warp_inv(inv, size)
        kmin, mmin, n_k, n_m = resample._shift_plan(np.asarray(inv), (size, size), [size, size])
        check((n_k, n_m) == (bucket, bucket), f"warp_shift: plan {(n_k, n_m)} for {bucket}")
        for fill in (float("nan"), -7.25):
            args = (img, inv, fill, kmin, mmin, size, size, n_k, n_m)
            got = warp_cuda.warp_shift_cuda(*args)
            want = resample._warp_shift(*args)
            torch.cuda.synchronize()
            check(torch.equal(words(got), words(want)),
                  f"warp_shift bucket {bucket} fill {fill}: kernel differs from plain")
        nan_px = int(torch.isnan(got).sum())
        if bucket == 4:
            cpu = resample._warp_shift(img.cpu(), *args[1:])
            check(torch.equal(words(got.cpu()), words(cpu)),
                  f"warp_shift bucket {bucket}: kernel differs from the plain version on the CPU")
        times = kernel_ms(lambda: warp_cuda.warp_shift_cuda(*args))
        out = torch.empty_like(got)
        lib = kernels.library()
        target = kernels.launch_on(dev)
        inv32 = [float(v) for v in np.asarray(inv, np.float32)]

        def alone():
            kernels.check(lib.nl_warp_shift(img.data_ptr(), size, size, 0, size, *inv32, fill,
                                            kmin, mmin, n_k, n_m, 0, size, size,
                                            out.data_ptr(), *target), "warp_shift")

        only = kernel_ms(alone)
        check(torch.equal(words(out), words(got)), "warp_shift: C entry differs")
        plain_ms = cuda_ms(lambda: resample._warp_shift(*args), reps=3)
        say(f"warp_shift bucket ({n_k}, {n_m}) on {size}x{size}: bit for bit the plain version "
            f"(fills NaN and -7.25{', and on the CPU' if bucket == 4 else ''}), {nan_px} NaN "
            f"px; call {times['ms']:.4f} ms ({times['single_call_ms']:.4f} single call), kernel "
            f"alone {only['ms']:.4f} ms ({only['single_call_ms']:.4f}), plain {plain_ms:.3f} ms, "
            f"bound {work['bound_ms']:.4f} ms")
        rows.append({"name": f"warp_shift bucket {bucket}", "kernel": "warp_shift",
                     "route": "cuda", "source": src, "replaces": replaces, "max_abs_err": 0.0,
                     **times, "kernel_only_ms": only["ms"],
                     "kernel_only_single_call_ms": only["single_call_ms"],
                     "plain_ms": plain_ms, "shape": [size, size], "buckets": [n_k, n_m],
                     **work, "share_of_bound": work["bound_ms"] / only["ms"]})
        del got, want, out

    # a block call as _project_sharded makes it: destination rows of the
    # second of four shards, from a block of its rows and a halo of 32 each side
    inv = warp_inv(WARP_INVS[4], size)
    kmin, mmin, n_k, n_m = resample._shift_plan(np.asarray(inv), (size, size), [size, size])
    rows_b = size // 4
    row0, src_row0 = rows_b, rows_b - 32
    block = img[src_row0:src_row0 + rows_b + 64].contiguous()
    kw = dict(row0=row0, rows=rows_b, src_row0=src_row0, src_h=size)
    args = (block, inv, 12.5, kmin, mmin, size, size, n_k, n_m)
    got = warp_cuda.warp_shift_cuda(*args, **kw)
    want = resample._warp_shift(*args, **kw)
    check(torch.equal(words(got), words(want)), "warp_shift block call: kernel differs from plain")
    say(f"warp_shift block call: rows {row0}..{row0 + rows_b} from a block of "
        f"{tuple(block.shape)} at row {src_row0}: bit for bit the plain version")

    # the whole batch call: 8 frames, the first the reference
    n = 8
    frames = torch.stack([sky_with_holes(gen, size, dev) for _ in range(n)])
    invs = [[1.0, 0.0, 0.0, 0.0, 1.0, 0.0]] + [
        warp_inv([1.0, 0.0002 * (i % 3 - 1), 1.7 * i - 6.1, -0.0002 * (i % 3 - 1), 1.0,
                  4.3 - 1.1 * i], size) for i in range(1, n)]
    kmins, mmins, n_k, n_m = resample.plan_batch_shift_warp([(size, size)] * n, [size, size],
                                                            invs)
    flags = [False] + [True] * (n - 1)
    oobs = [float("nan")] * n
    want = [frames[0].clone()] + [
        resample._warp_shift(frames[i], invs[i], oobs[i], int(kmins[i]), int(mmins[i]), size,
                             size, n_k, n_m) for i in range(1, n)]
    kernels.reset_launch_counts()
    got = resample.warp_shift_batch(frames.clone(), invs, oobs, kmins, mmins, flags, n_k, n_m)
    launches = kernels.launch_counts()["warp_shift"]
    check(launches == n - 1, f"warp_shift_batch: {launches} launches for {n - 1} warped frames")
    for i in range(n):
        check(torch.equal(words(got[i]), words(want[i])),
              f"warp_shift_batch frame {i}: differs from the plain version")
    del want, got
    batch_ms = cuda_ms(lambda: resample.warp_shift_batch(frames, invs, oobs, kmins, mmins, flags,
                                                         n_k, n_m))
    per_frame = batch_ms / (n - 1)
    say(f"warp_shift_batch: {n} frames of {size}x{size}, bucket ({n_k}, {n_m}), {launches} "
        f"launches, bit for bit the plain version frame by frame; {batch_ms:.3f} ms a call, "
        f"{per_frame:.4f} ms a warped frame")
    check(per_frame < 0.5, f"warp_shift_batch: {per_frame:.3f} ms a warped frame")
    rows.append({"name": "warp_shift_batch", "kernel": "warp_shift", "route": "cuda",
                 "source": src, "replaces": replaces, "max_abs_err": 0.0, "ms": per_frame,
                 "batch_call_ms": batch_ms, "frames": n, "buckets": [n_k, n_m], **work,
                 "share_of_bound": work["bound_ms"] / per_frame})
    del frames, img, block
    torch.cuda.empty_cache()
    return rows


# the K8 lights: name, rows, columns, stars, and the fewest phase-2
# survivors the light must leave (the benchmark's cells detect about 440 a
# 16.8 MP light and 1,280 a 61 MP one; this light model tops out near 1,200
# at 61 MP, where the 2,048 brightest candidates fill the capacity)
FINISH_LIGHTS = [("16mp", 4096, 4096, 1060, 380), ("61mp", 6388, 9576, 4200, 1100)]


def star_light(gen, h: int, w: int, n: int, device):
    """A (h, w) calibrated light on the card with mono16mp's values
    (benchmark_torch/configs/mono16mp.json) made simple: sky 1000 ADU, n
    stars of FWHM 3.65 px at random places (one in five beside another, 5-20
    px away) with the quantiles of N(>F) ~ F^-0.8 over 3,000 to 3,000,000
    ADU as fluxes, read noise 8 ADU and shot noise at 2 e-/ADU, and the hot
    pixels a master dark leaves behind, one in 10,000, within 10% of 300-6,000
    ADU."""
    import torch

    u = lambda *shape: torch.rand(shape, generator=gen, device=device)  # noqa: E731
    pos = u(n, 2) * torch.tensor([h - 48.0, w - 48.0], device=device) + 24.0
    pair = n // 5
    pos[1:1 + pair] = pos[:pair] + (u(pair, 2) * 15.0 + 5.0) * torch.where(
        u(pair, 2) < 0.5, -1.0, 1.0)
    pos[:, 0].clamp_(14.0, h - 15.0)
    pos[:, 1].clamp_(14.0, w - 15.0)
    q = (torch.randperm(n, generator=gen, device=device).to(torch.float32) + 0.5) / n
    flux = (3000.0 * q ** (-1.0 / 0.8)).clamp(max=3e6)
    sigma = 3.65 / 2.3548
    offs = torch.arange(-12, 13, device=device)
    cy, cx = pos[:, 0].floor().long(), pos[:, 1].floor().long()
    yy = cy[:, None, None] + offs[None, :, None]
    xx = cx[:, None, None] + offs[None, None, :]
    stamp = flux[:, None, None] / (2 * math.pi * sigma ** 2) * torch.exp(
        -((yy - pos[:, 0, None, None]) ** 2 + (xx - pos[:, 1, None, None]) ** 2)
        / (2 * sigma ** 2))
    yy, xx = yy.expand_as(stamp), xx.expand_as(stamp)
    img = torch.full((h, w), 1000.0, device=device)
    img.index_put_((yy.reshape(-1), xx.reshape(-1)), stamp.reshape(-1), accumulate=True)
    img += torch.sqrt(64.0 + img / 2.0) * torch.randn((h, w), generator=gen, device=device)
    hot = torch.randint(0, h * w, (h * w // 10_000,), generator=gen, device=device)
    img.view(-1)[hot] += (300.0 + 5700.0 * u(hot.shape[0])) * (u(hot.shape[0]) * 0.2 - 0.1)
    return img.contiguous()


def build_finish_mirror(work: str) -> str:
    """K8's host mirror (csrc/detect_finish_host.cpp) built with g++ as
    tests/test_torch_detect_finish.py builds it. Returns the program."""
    gxx = shutil.which("g++")
    check(gxx is not None, "detect_finish: no g++ for the host mirror")
    exe = os.path.join(work, "detect_finish_mirror")
    out = subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off",
                          "-D__host__=", "-D__device__=", "-D__forceinline__=inline", "-I",
                          os.path.join(ROOT, CSRC), os.path.join(ROOT, CSRC,
                                                                 "detect_finish_host.cpp"),
                          "-o", exe], capture_output=True, text=True, timeout=600)
    check(out.returncode == 0, f"detect_finish mirror: g++ failed: {out.stderr[-2000:]}")
    return exe


def finish_mirror_row(exe: str, work: str, args: tuple, frame: tuple):
    """The mirror's output row of one frame (keep None: every candidate a
    survivor), for (location, scale, star_sig, star_in_out, radius)."""
    from nightlight_tpu_torch.detect import stars

    loc, scale, sig, in_out, radius = args
    cy, cx, vals, keep, patch, ok = frame
    k = int(cy.shape[0])
    src, dst = os.path.join(work, "finish_in.bin"), os.path.join(work, "finish_out.bin")
    with open(src, "wb") as f:
        f.write(np.array([k, radius, k, keep is not None], np.int32).tobytes())
        f.write(np.array([loc, scale, sig, in_out, stars._disk_limit(radius)],
                         np.float32).tobytes())
        for a, dtype in ((cy, np.int32), (cx, np.int32), (vals, np.float32), (keep, np.uint8),
                         (patch, np.float32), (ok, np.uint8)):
            if a is not None:
                f.write(np.ascontiguousarray(a.cpu().numpy(), dtype).tobytes())
    out = subprocess.run([exe, src, dst], capture_output=True, timeout=600)
    check(out.returncode == 0, f"detect_finish mirror: exit {out.returncode}")
    return np.fromfile(dst, np.float32)


def finish_rows_equal(a, b) -> bool:
    """Two K8 output rows bit for bit: the head and each field's first
    count entries (the rest is not written)."""
    from nightlight_tpu_torch.detect import stars

    head, fields = stars._ROW_HEAD, stars._STAR_FIELDS
    num = int(a[0])
    cut = lambda r: r[head:].reshape(fields, -1)[:, :num]  # noqa: E731
    return (np.array_equal(a[:head].view(np.int32), b[:head].view(np.int32))
            and np.array_equal(cut(a).view(np.int32), cut(b).view(np.int32)))


def finish_errors(got, got_hfr, want, want_hfr) -> dict:
    """The largest differences of two star lists of one count, place by
    place: absolute over x, y, mass, hfr and the average HFR; in pixels over
    x and y; relative over mass, hfr and the average HFR."""
    pos = max([0.0] + [float(np.abs(getattr(got, f) - getattr(want, f)).max())
                       for f in ("x", "y")])
    fields = [(got.mass, want.mass), (got.hfr, want.hfr),
              (np.float32([got_hfr]), np.float32([want_hfr]))]
    absolute = max([pos] + [float(np.abs(a - b).max()) for a, b in fields])
    rel = max(float((np.abs(a - b) / np.maximum(np.abs(b), 1e-30)).max()) for a, b in fields)
    return {"max_abs_err": absolute, "max_pos_err_px": pos, "max_rel_err": rel}


def finish_close(got, got_hfr, want, want_hfr) -> bool:
    """Within the tolerances of tests/test_torch_stars.py: positions (so the
    order) to 1e-3 px, masses, HFRs and the average HFR to 1e-4 relative
    (the sums run in another float32 order)."""
    err = finish_errors(got, got_hfr, want, want_hfr)
    return err["max_pos_err_px"] <= 1e-3 and err["max_rel_err"] <= 1e-4


def finish_refined(location, scale, star_sig: float, radius: int, compact):
    """Every phase-2 survivor's value, refined x and y and HFR mass by the
    plain version's phases 4 and 6, host arrays, for (cy, cx, vals, patch,
    ok) of the survivors."""
    from nightlight_tpu_torch.detect import stars

    cy, cx, vals, patch, ok = compact
    x, y, _, oy, ox, offs = stars._center_of_mass(patch, ok, cy, cx,
                                                  location + scale * star_sig * 0.5, radius)
    mass2 = stars._hfr(patch, ok, offs, oy, ox, location, radius)[1]
    return [t.cpu().numpy() for t in (vals, x, y, mass2)]


def is_tie(got, j: int, refined) -> bool:
    """Whether star j of `got` sits where a phase-2 survivor with its value
    converged: that candidate's refined place within 1e-3 px and its mass
    within 1e-4 relative of the star's."""
    vals, x, y, mass = refined
    at = vals.view(np.int32) == np.float32(got.value[j]).view(np.int32)
    return bool((at & (np.abs(x - got.x[j]) <= 1e-3) & (np.abs(y - got.y[j]) <= 1e-3)
                 & (np.abs(mass - got.mass[j]) <= 1e-4 * abs(got.mass[j]))).any())


def finish_cases(work: str, kernels) -> list:
    """K8 (phases 3-6 of star detection) on the card at the main path's
    shapes: a 4096^2 light with about 440 phase-2 survivors and a 9576 x
    6388 one with about 1,200 (FINISH_LIGHTS), each at radius 16 and 8, the `stack`
    preset's detection arguments (sigma 15, bad-pixel sigma 5 with the
    stddev computed, in/out 1.4). The frame's inputs are find_stars' own
    (its _Finish.frame call). Checks: find_stars launches K8 once and its
    stars are the kernel's row; the row bit for bit the host mirror's and
    the one fed as find_stars_sharded feeds it (the survivors compacted, no
    mask); against the plain version _finish on the card, counts equal and
    finish_close, the largest differences reported, and a star whose value
    is not the plain version's must be a tie (is_tie: two candidates
    converged onto it); the light leaves at least its floor of survivors;
    find_stars_sharded on 4 shards of cuda:0 bit for bit find_stars. Times:
    K8 a frame, 10 calls back to back and one, the plain version, the
    whole find_stars; the bound: the survivors' patches (4r+1)^2 x 5 bytes
    read once at 3.35 TB/s. Returns the kernel table's rows."""
    import torch

    from nightlight_tpu_torch.detect import stars
    from nightlight_tpu_torch.parallel import mesh as pmesh

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    exe = build_finish_mirror(work)
    src, replaces = KERNELS["detect_finish"]
    rows = []
    for name, h, w, n, least in FINISH_LIGHTS:
        img = star_light(gen, h, w, n, dev)
        loc, scale = float(img.median()), 24.0
        for radius in (16, 8):
            frames = []

            class Capture(stars._Finish):
                def frame(self, *args):
                    frames.append(args)
                    super().frame(*args)

            real = stars._Finish
            kernels.reset_launch_counts()
            stars._Finish = Capture
            try:
                want, want_hfr = stars.find_stars(img, loc, scale, 15.0, 5.0, 1.4, radius)
            finally:
                stars._Finish = real
            check(kernels.launch_counts()["detect_finish"] == 1 and len(frames) == 1,
                  f"detect_finish {name} r={radius}: {kernels.launch_counts()} launches")
            _, location, scale_t, sig, in_out, _, cy, cx, vals, keep, patch, ok = frames[0]
            args = (loc, scale, sig, in_out, radius)
            k = int(cy.shape[0])
            survivors = int(keep.sum())
            check(survivors >= least, f"detect_finish {name}: {survivors} phase-2 survivors, "
                                      f"fewer than {least}")
            row = torch.empty(stars._ROW_HEAD + stars._STAR_FIELDS * k, device=dev)

            def launch(keep_=keep, frame=(cy, cx, vals, patch, ok), row_=row, cap=k):
                fy, fx, fv, fp, fo = frame
                stars._finish_cuda(row_, cap, location, scale_t, sig, in_out, radius, fy, fx,
                                   fv, keep_, fp, fo)

            launch()
            got = row.cpu().numpy()
            check(int(got[0]) == want.count and int(got[2]) == survivors and np.array_equal(
                got[stars._ROW_HEAD:stars._ROW_HEAD + want.count].view(np.int32),
                want.x.view(np.int32)) and float(got[1]) == want_hfr,
                f"detect_finish {name} r={radius}: find_stars differs from the kernel's row")
            check(finish_rows_equal(got, finish_mirror_row(exe, work, args, frames[0][6:])),
                  f"detect_finish {name} r={radius}: kernel differs from the host mirror")
            at = torch.nonzero(keep)[:, 0]
            compact = (cy[at], cx[at], vals[at], patch[at], ok[at])
            row_s = torch.empty(stars._ROW_HEAD + stars._STAR_FIELDS * survivors, device=dev)
            launch(None, compact, row_s, survivors)
            check(finish_rows_equal(got, row_s.cpu().numpy()),
                  f"detect_finish {name} r={radius}: the sharded feed differs")

            def plain():
                return stars._finish(location, scale_t, torch.tensor(sig, device=dev),
                                     torch.tensor(in_out, device=dev), radius,
                                     at.to(torch.float32), *compact)

            p_stars, p_hfr = plain()
            check(p_stars.count == want.count > 0 and finish_close(want, want_hfr, p_stars, p_hfr),
                  f"detect_finish {name} r={radius}: {want.count} stars against the "
                  f"plain version's {p_stars.count}, or beyond the tolerances")
            # where two candidates converged onto one star their masses tie to
            # rounding, and which one's value the star keeps follows the sums'
            # order: such a star's value must be a phase-2 survivor's whose
            # refined place and mass are the star's
            duplicates = np.nonzero(want.value.view(np.int32) != p_stars.value.view(np.int32))[0]
            refined = finish_refined(location, scale_t, sig, radius, compact)
            check(all(is_tie(want, j, refined) for j in duplicates),
                  f"detect_finish {name} r={radius}: a star keeps a value that no candidate "
                  f"converged onto it has")
            err = finish_errors(want, want_hfr, p_stars, p_hfr)
            mesh = shard_mesh()
            sharded = pmesh.sharded_star_detect(mesh, radius)(
                pmesh.place_on_mesh(img, mesh), loc, scale, 15.0, 5.0, 1.4, None)
            check(sharded[0].count == want.count and sharded[1] == want_hfr and all(
                np.array_equal(getattr(sharded[0], f).view(np.int32),
                               getattr(want, f).view(np.int32))
                for f in ("x", "y", "value", "mass", "hfr")),
                f"detect_finish {name} r={radius}: find_stars_sharded differs from find_stars")

            times = kernel_ms(launch)
            plain_ms = cuda_ms(plain, reps=3)
            whole_ms = cuda_ms(lambda: stars.find_stars(img, loc, scale, 15.0, 5.0, 1.4,
                                                        radius), reps=3)
            size = 4 * radius + 1
            work_ = bound(5.0 * survivors * size * size, 0.0)
            say(f"detect_finish {name} ({h}x{w}) r={radius}: {k} candidates, {survivors} "
                f"phase-2 survivors, {want.count} stars; bit for bit the host mirror and the "
                f"sharded feed, find_stars_sharded on {SHARDS} shards bit for bit find_stars, "
                f"the plain version within tolerance (max_abs_err {err['max_abs_err']:.3g}, "
                f"positions {err['max_pos_err_px']:.3g} px, masses and HFRs "
                f"{err['max_rel_err']:.3g} relative; {len(duplicates)} stars keep a tied "
                f"candidate's value); K8 {times['ms']:.4f} ms a frame "
                f"({times['single_call_ms']:.4f} single call), plain {plain_ms:.3f} ms, "
                f"find_stars {whole_ms:.3f} ms, bound {work_['bound_ms']:.5f} ms")
            rows.append({"name": f"detect_finish {name} r={radius}", "kernel": "detect_finish",
                         "route": "cuda", "source": src, "replaces": replaces,
                         **err, **times, "plain_ms": plain_ms,
                         "find_stars_ms": whole_ms, "shape": [k, size, size],
                         "frame": [h, w], "survivors": survivors, "stars": want.count,
                         "other_value_than_plain": len(duplicates),
                         **work_, "share_of_bound": work_["bound_ms"] / times["ms"]})
            del frames, patch, ok, compact, row, row_s
        del img
    torch.cuda.empty_cache()
    return rows


def edge_rows(gen, p: int, device):
    """(40, p) float32 columns with what a sort-and-sum must get right, from
    `gen` and with no NaN: small integers (heavy ties) with -0.0 and 0.0
    mixed, 1% samples of 3.0e38 and 1% of +inf, one column in 64 wholly
    3.0e38 and one in 128 wholly +inf."""
    import torch

    x = torch.randint(-3, 8, (40, p), generator=gen, device=device).to(torch.float32)
    u = torch.rand((40, p), generator=gen, device=device)
    x = torch.where((x == 0) & (u < 0.5), torch.full((), -0.0, device=device), x)
    x = torch.where((u > 0.50) & (u < 0.51), torch.full((), 3.0e38, device=device), x)
    x = torch.where((u > 0.60) & (u < 0.61), torch.full((), float("inf"), device=device), x)
    cols = torch.arange(p, device=device)
    x = torch.where((cols % 64 == 3)[None, :], torch.full((), 3.0e38, device=device), x)
    x = torch.where((cols % 128 == 5)[None, :], torch.full((), float("inf"), device=device), x)
    return x.contiguous()


def ptxas_entries(ptxas: str, needle: str) -> list:
    """(function, registers, spill store bytes, spill load bytes) of each
    entry function of the ptxas report whose name holds `needle`."""
    found, function = [], None
    for line in ptxas.splitlines():
        if "Compiling entry function" in line:
            function = line.split("'")[1] if "'" in line else line
        elif function and needle in function:
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if spill:
                found.append([function, None, int(spill.group(1)), int(spill.group(2))])
            regs = re.search(r"Used (\d+) registers", line)
            if regs and found and found[-1][0] == function:
                found[-1][1] = int(regs.group(1))
                function = None
    return [tuple(f) for f in found]


def max_abs_err(out, ref) -> float:
    """Largest |out - ref|, counting equal values (infinities too) as 0."""
    import torch

    return float(torch.where(out == ref, 0.0, (out - ref).abs()).max())


def sort_sum_cases(sortnet_cuda, microbench_layout) -> list:
    """K5 (column; tiled) and K6 (tiled at every tile) on the
    microbenchmarks' (40, 2^21) input. Both tiled designs, bulk_ring and the
    port's first, smem_sort, are held bit for bit (as int32 words) against the plain
    version at every tile on four inputs: the microbenchmark's (the bulk
    path), edge_rows at P = 2^21 - 3 (rows not 16-byte aligned: the
    per-thread path), its first 2^21 - 4 columns (the bulk path with a
    partial last tile) and the microbenchmark's rows at a pointer 4 bytes
    past a 16-byte boundary (the per-thread path). Then each tile is timed
    in turns (smem_sort, bulk_ring, bulk_ring, smem_sort), and bulk_ring
    must be the faster at every tile. Returns the kernel table's rows."""
    import torch

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    x = microbench_layout.make_input(microbench_layout.P, 0, dev)
    px = int(x.shape[1])
    edge = edge_rows(gen, px - 3, dev)
    flat = torch.empty(40 * px + 4, dtype=torch.float32, device=dev)
    unaligned = flat[1:1 + 40 * px].view(40, px)
    unaligned.copy_(x)
    inputs = [("microbench", x, "bulk"), ("edge P-3", edge, "per_thread"),
              ("edge P-4", edge[:, :px - 4].contiguous(), "bulk"),
              ("microbench +4 bytes", unaligned, "per_thread")]
    checks = {t: [] for t in sortnet_cuda.BLOCK_SIZES}
    for label, inp, want_path in inputs:
        ref = sortnet_cuda.sort_sum_plain(inp)
        col = sortnet_cuda.sort_sum_cuda(inp, "column")
        check(torch.equal(col.view(torch.int32), ref.view(torch.int32)),
              f"sort_sum column on {label}: differs from plain")
        for t in sortnet_cuda.BLOCK_SIZES:
            plan = sortnet_cuda.sort_sum_plan(inp, t)
            for design in sortnet_cuda.TILED_DESIGNS:
                out = sortnet_cuda.sort_sum_cuda(inp, "tiled", t, design)
                torch.cuda.synchronize()
                bits = torch.equal(out.view(torch.int32), ref.view(torch.int32))
                err = max_abs_err(out, ref)
                path = plan.path if design == "bulk_ring" else "-"
                tail = inp.shape[1] - plan.bulk_tiles * t if plan.path == "bulk" else 0
                say(f"sort_sum tiled {design} tile={t} on {label} (40x{inp.shape[1]}): path "
                    f"{path} (partial tile {tail} px) equal bits {bits} max_abs_err {err:.3g}")
                check(bits, f"sort_sum tiled {design} tile={t} on {label}: differs from plain")
                if design == "bulk_ring":
                    check(plan.path == want_path, f"sort_sum tile={t} on {label}: path "
                                                  f"{plan.path}, expected {want_path}")
                    checks[t].append({"input": label, "pixels": int(inp.shape[1]),
                                      "path": plan.path, "partial_tile_px": tail,
                                      "bits_equal": bits})
    del edge, flat, unaligned, inputs, ref, col, out
    torch.cuda.empty_cache()

    ref = sortnet_cuda.sort_sum_plain(x)
    plain_ms = cuda_ms(lambda: sortnet_cuda.sort_sum_plain(x))
    # no single PyTorch call computes this function: x.sum(0) reads the
    # block without sorting, torch.sort sorts it without summing (the floor
    # of any library route); both are recorded, as floors, not library_ms
    floors = {"x.sum(0)": cuda_ms(lambda: x.sum(0), calls=KERNEL_CALLS),
              "torch.sort(x, dim=0)": cuda_ms(lambda: torch.sort(x, dim=0), calls=KERNEL_CALLS)}
    work = bound(4.0 * 40 * px + 4.0 * px, (2.0 * batcher_pairs(40) + 39) * px)
    say(f"sort_sum: plain {plain_ms:.3f} ms, x.sum(0) {floors['x.sum(0)']:.4f} ms, "
        f"torch.sort(x, dim=0) {floors['torch.sort(x, dim=0)']:.4f} ms, bound "
        f"{work['bound_ms']:.4f} ms ({work['bound_by']})")
    rows = []

    def row(name, replaces, threads, out, times, **extra):
        err = max_abs_err(out, ref)
        check(torch.equal(out.view(torch.int32), ref.view(torch.int32)),
              f"{name}: differs from plain (max abs {err})")
        rows.append({"name": name, "kernel": "sort_sum", "route": "cuda", "source": SORT_SRC,
                     "replaces": replaces, "max_abs_err": err, **times, "plain_ms": plain_ms,
                     "library_ms": None, "library_floor_ms": floors, "shape": [40, px],
                     "threads": threads, **work, "share_of_bound": work["bound_ms"] / times["ms"],
                     **extra})

    times = kernel_ms(lambda: sortnet_cuda.sort_sum_cuda(x, "column"))
    say(f"sort_sum column: 40x{px} kernel {times['ms']:.4f} ms ({times['single_call_ms']:.4f} "
        f"single call), {100 * work['bound_ms'] / times['ms']:.1f}% of bound")
    row("sort_sum column", SORT_REPLACES["column"], 256, sortnet_cuda.sort_sum_cuda(x, "column"),
        times, design="column")
    cases = [("sort_sum tiled", 256, SORT_REPLACES["tiled"])]
    cases += [(f"sort_sum tiled tile={t}", t, SORT_REPLACES["sweep"])
              for t in sortnet_cuda.BLOCK_SIZES]
    for name, t, replaces in cases:
        def run(design, t=t):
            return sortnet_cuda.sort_sum_cuda(x, "tiled", t, design)

        turns = [kernel_ms(lambda d=d: run(d))
                 for d in ("smem_sort", "bulk_ring", "bulk_ring", "smem_sort")]
        ring = {k: (turns[1][k] + turns[2][k]) / 2 for k in turns[0]}
        old = {k: (turns[0][k] + turns[3][k]) / 2 for k in turns[0]}
        plan = sortnet_cuda.sort_sum_plan(x, t)
        say(f"{name}: bulk_ring {ring['ms']:.4f} ms ({ring['single_call_ms']:.4f} single call, "
            f"{100 * work['bound_ms'] / ring['ms']:.1f}% of bound), smem_sort {old['ms']:.4f} ms "
            f"({old['single_call_ms']:.4f}, {100 * work['bound_ms'] / old['ms']:.1f}%); plan "
            f"{plan.rows_per_stage} rows x {plan.stages} stages, {plan.smem_bytes} B shared, "
            f"{plan.blocks_per_sm} blocks/SM, grid {plan.grid}, path {plan.path}")
        check(ring["ms"] < old["ms"], f"{name}: bulk_ring {ring['ms']:.4f} ms not faster than "
                                      f"smem_sort {old['ms']:.4f} ms")
        row(name, replaces, t, run("bulk_ring"), ring, design="bulk_ring",
            rows_per_stage=plan.rows_per_stage, stages=plan.stages, smem_bytes=plan.smem_bytes, blocks_per_sm=plan.blocks_per_sm,
            grid=plan.grid, path=plan.path, smem_sort_ms=old["ms"],
            smem_sort_single_call_ms=old["single_call_ms"], turns=turns, checks=checks[t])
    return rows


def spill_summary(ptxas: str) -> str:
    """The kernels of the ptxas report that spill ("N bytes spill stores"
    with N > 0), by source, or that none does."""
    spills, source, function = [], "", ""
    for line in ptxas.splitlines():
        if line.startswith("== "):
            source = line[3:].strip()
        elif "Compiling entry function" in line:
            function = line.split("'")[1] if "'" in line else line
        else:
            found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if found and found.group(0) != "0 bytes spill stores, 0 bytes spill loads":
                spills.append(f"{source} {function}: {found.group(0)}")
    return "ptxas spills: " + ("; ".join(spills) if spills else "none")


def write_log(name: str, text: str) -> None:
    os.makedirs(LOG_DIR, exist_ok=True)
    with open(os.path.join(LOG_DIR, name), "w") as f:
        f.write(text)


def run_cli(cli, args, log_name: str, device=None):
    """Run the port's CLI capturing its log; returns (rc, log, seconds)."""
    import torch

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args, device=device)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    log = buf.getvalue()
    write_log(log_name, log)
    return rc, log, seconds


def check_output(fits_mod, name: str, size: int, shape=None):
    img = fits_mod.read_file(name)
    data = img.to_numpy()
    shape = shape or (size, size)
    check(data.shape == shape, f"{name}: shape {data.shape}, expected {shape}")
    finite = float(np.isfinite(data).mean())
    check(finite > 0.99, f"{name}: only {finite:.4f} finite")
    return data


def small_gpu_vs_cpu(cli, fits_mod, fixtures, work: str, tag: str, flags,
                     bayer=None) -> str:
    """The same small stack on the card (kernels) and on the CPU (plain
    versions, the path the CPU tests hold against the JAX package). Returns
    the directory of the stacks (gpu.fits, cpu.fits)."""
    import torch

    small = 512
    sdir = os.path.join(work, f"small_{tag}")
    fixtures.gen(sdir, 8, small, seed=11, bayer=bayer)
    os.chdir(sdir)
    names = sorted(glob.glob("light*.fits"))
    args = ["-dark", "dark.fits", "-jpg", "", "-log", "", "-exportStats", "", *flags,
            "stack", *names]
    rc_g, log_g, _ = run_cli(cli, ["-out", "gpu.fits", *args], f"chip_smoke_small_{tag}_gpu.log")
    rc_c, log_c, _ = run_cli(cli, ["-out", "cpu.fits", *args], f"chip_smoke_small_{tag}_cpu.log",
                             device=torch.device("cpu"))
    check(rc_g == 0 and rc_c == 0, f"small stack {tag}: rc gpu {rc_g} cpu {rc_c}")
    g = check_output(fits_mod, "gpu.fits", small)
    c = check_output(fits_mod, "cpu.fits", small)
    rel = np.abs(g - c) / np.maximum(np.abs(c), 1.0)
    off = float(np.mean(rel > 1e-4))
    clip_g = [ln for ln in log_g.splitlines() if ln.startswith("Clipped")]
    clip_c = [ln for ln in log_c.splitlines() if ln.startswith("Clipped")]
    say(f"small stack {tag} gpu vs cpu: median rel diff {float(np.median(rel)):.3g}, "
        f"max {float(rel.max()):.3g}, share above 1e-4 {off:.3g}; {clip_g} vs {clip_c}")
    # band: star centroids sum in another order on each device, which
    # moves transforms by ~1e-5 px and warped pixels near stars by ~1e-5
    # relative; a pixel whose clip decision sits on the bound can then flip
    # and move by a few percent. So: the typical pixel agrees to 1e-5, at
    # most 0.1% of pixels move by more than 1e-4, none by more than 10%.
    check(float(np.median(rel)) <= 1e-5 and off <= 1e-3 and float(rel.max()) <= 0.1,
          f"small stack {tag} gpu vs cpu outside the band")
    return sdir


def small_stretch_gpu_vs_cpu(cli, fits_mod, sdir: str) -> None:
    """`stretch` of the small OSC stack on the card and on the CPU: the
    same auto-stretch rounds, and the pixels within band. The band: float32
    pow rounds a step apart on the two devices, and a black shift carries
    it to every later pixel; the stretched image lies in [0, 1], so 1e-4
    absolute, the typical pixel within 1e-6."""
    import torch

    os.chdir(sdir)
    args = ["-log", "", "-jpg", "", "-blurSigma", "1", "-usmSigma", "2", "-usmGain", "1",
            "stretch", "gpu.fits"]
    rc_g, log_g, _ = run_cli(cli, ["-out", "sg.fits", *args], "chip_smoke_small_stretch_gpu.log")
    rc_c, log_c, _ = run_cli(cli, ["-out", "sc.fits", *args], "chip_smoke_small_stretch_cpu.log",
                             device=torch.device("cpu"))
    check(rc_g == 0 and rc_c == 0, f"small stretch: rc gpu {rc_g} cpu {rc_c}")
    rounds_g = [ln for ln in log_g.splitlines() if "Linear location" in ln]
    rounds_c = [ln for ln in log_c.splitlines() if "Linear location" in ln]
    g = check_output(fits_mod, "sg.fits", 512)
    c = check_output(fits_mod, "sc.fits", 512)
    diff = np.abs(g - c)
    say(f"small stretch gpu vs cpu: rounds {len(rounds_g)} / {len(rounds_c)}, same "
        f"{rounds_g == rounds_c}; median abs diff {float(np.median(diff)):.3g}, "
        f"max {float(diff.max()):.3g}")
    check(rounds_g == rounds_c and len(rounds_g) > 0, "small stretch: rounds differ")
    check(float(np.median(diff)) <= 1e-6 and float(diff.max()) <= 1e-4,
          "small stretch gpu vs cpu outside the band")


def color_runs(cli, fits_mod, fixtures, kernels, work: str, size: int, record) -> None:
    """lrgb_4096 and sho_4096 (COLOR_RUNS) at size^2: rc 0, a finite
    size x size x 3 output, K4 launched; `record(name, counts, seconds)`
    books each run's launches and wall."""
    import torch

    for name, channels, flags in COLOR_RUNS:
        cdir = os.path.join(work, name)
        names = [os.path.basename(p) for p in
                 fixtures.gen_channels(cdir, size, seed=7, channels=channels)]
        os.chdir(cdir)
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        rc, log, seconds = run_cli(cli, ["-out", f"{name}.fits", "-jpg", f"{name}.jpg",
                                         "-log", "", *flags, "rgb", *names],
                                   f"chip_smoke_{name}.log")
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated() / (1 << 30)
        img = fits_mod.read_file(f"{name}.fits")
        data = img.to_numpy()
        finite = bool(np.isfinite(data).all())
        rounds = len([ln for ln in log.splitlines() if "Linear location" in ln])
        say(f"{name} (rgb {' '.join(names)} {' '.join(flags) or 'defaults'}): rc {rc} "
            f"output {img.naxisn} finite {finite} wall {seconds:.2f} s peak {peak:.2f} GiB "
            f"launches {counts} stretch rounds {rounds}")
        check(rc == 0 and "Error:" not in log, f"{name}: rc {rc}; log tail: {log[-2000:]}")
        check(img.naxisn == [size, size, 3] and finite, f"{name}: output {img.naxisn}")
        check(counts["gather_patches"] > 0, f"{name}: gather_patches never launched")
        check(rounds > 0 and os.path.getsize(f"{name}.jpg") > 0, f"{name}: no stretch or JPEG")
        record(name, counts, seconds, peak)
        os.chdir(work)
        shutil.rmtree(cdir, ignore_errors=True)


def small_rgb_gpu_vs_cpu(cli, fits_mod, fixtures, work: str) -> None:
    """A 256^2 LRGB through `rgb` on the card and on the CPU: the same
    auto-stretch rounds, and the outputs within the band the CPU tests hold
    the port to against the JAX package (tests/test_torch_cli_rgb.py): 2e-5
    absolute, the typical pixel within 1e-6."""
    import torch

    sdir = os.path.join(work, "small_rgb")
    names = [os.path.basename(p) for p in fixtures.gen_channels(
        sdir, 256, seed=7, channels=(("r", 1.0), ("g", 0.8), ("b", 0.6), ("l", 1.0)))]
    os.chdir(sdir)
    args = ["-log", "", "-jpg", "", "rgb", *names]
    rc_g, log_g, _ = run_cli(cli, ["-out", "g.fits", *args], "chip_smoke_small_rgb_gpu.log")
    rc_c, log_c, _ = run_cli(cli, ["-out", "c.fits", *args], "chip_smoke_small_rgb_cpu.log",
                             device=torch.device("cpu"))
    check(rc_g == 0 and rc_c == 0, f"small rgb: rc gpu {rc_g} cpu {rc_c}")
    rounds_g = [ln for ln in log_g.splitlines() if "Linear location" in ln]
    rounds_c = [ln for ln in log_c.splitlines() if "Linear location" in ln]
    g = check_output(fits_mod, "g.fits", 256, (3, 256, 256))
    c = check_output(fits_mod, "c.fits", 256, (3, 256, 256))
    diff = np.abs(g - c)
    say(f"small rgb gpu vs cpu: rounds {len(rounds_g)} / {len(rounds_c)}, same "
        f"{rounds_g == rounds_c}; median abs diff {float(np.median(diff)):.3g}, "
        f"max {float(diff.max()):.3g}")
    check(rounds_g == rounds_c and len(rounds_g) > 0, "small rgb: rounds differ")
    check(float(np.median(diff)) <= 1e-6 and float(diff.max()) <= 2e-5,
          "small rgb gpu vs cpu outside the band")


def small_commands(cli, fits_mod, fixtures, work: str) -> None:
    """`run` on the three example jobs (examples/*.json) on generated
    inputs at 512^2, `stats`, a -normHist 3 stack and a stack with an
    external -alignRef file: rc 0 and finite outputs."""
    from nightlight_tpu_torch.image import Image

    small = 512
    sdir = os.path.join(work, "small_cmds")
    lights_dir = os.path.join(sdir, "lights")
    fixtures.gen(lights_dir, 8, small, seed=11)
    os.makedirs(os.path.join(sdir, "masters"))
    os.replace(os.path.join(lights_dir, "dark.fits"), os.path.join(sdir, "masters", "dark.fits"))
    ramp = np.linspace(0.95, 1.05, small, dtype=np.float32)
    fits_mod.write_file(Image.from_numpy(np.tile(ramp, (small, 1))),
                        os.path.join(sdir, "masters", "flat.fits"))
    for stem, channels in (("lrgb", (("R", 1.0), ("G", 0.8), ("B", 0.6), ("L", 1.0))),
                           ("nb", (("S2", 0.9), ("Ha", 1.0), ("O3", 0.7)))):
        for p in fixtures.gen_channels(os.path.join(sdir, stem), small, channels=channels):
            os.replace(p, os.path.join(sdir, os.path.basename(p).replace("chan_", "stacked_")))
    shutil.copy(os.path.join(sdir, "lights", "light002.fits"), os.path.join(sdir, "ref.fits"))
    os.chdir(sdir)
    jobs = (("stack_l_channel", "stacked_L.fits", (small, small)),
            ("lrgb_combine", "lrgb.fits", (3, small, small)),
            ("narrowband_hubble", "hubble.fits", (3, small, small)))
    for job, out, shape in jobs:
        shutil.copy(os.path.join(ROOT, "examples", f"{job}.json"), "job.json")
        rc, log, seconds = run_cli(cli, ["-log", "", "-job", "job.json", "run"],
                                   f"chip_smoke_run_{job}.log")
        say(f"run {job}: rc {rc} wall {seconds:.2f} s")
        check(rc == 0 and "Error:" not in log, f"run {job}: rc {rc}; log tail: {log[-2000:]}")
        check_output(fits_mod, out, small, shape)
    lights = sorted(glob.glob("lights/light*.fits"))
    for name, flags, cmd, text in (
            ("stats", (), "stats", "writing statistics"),
            ("normHist3", ("-normHist", "3"), "stack", "after matching reference histogram"),
            ("alignRef_file", ("-alignRef", "ref.fits"), "stack",
             "using loaded image -3 as alignment reference")):
        rc, log, seconds = run_cli(cli, ["-out", f"{name}.fits", "-jpg", "", "-log", "", *flags,
                                         cmd, *lights], f"chip_smoke_small_{name}.log")
        say(f"small {name}: rc {rc} wall {seconds:.2f} s")
        check(rc == 0 and "Error:" not in log and text in log,
              f"small {name}: rc {rc}; log tail: {log[-2000:]}")
        if cmd == "stack":
            check_output(fits_mod, f"{name}.fits", small)
    os.chdir(work)
    shutil.rmtree(sdir, ignore_errors=True)


def serve_job(out: str) -> dict:
    """tests/test_rest.py's live-stacking job (nightlight_tpu_torch/
    fixtures.py:live_stacking_job)."""
    from nightlight_tpu_torch.fixtures import live_stacking_job

    return live_stacking_job(out)


SERVE_SEED = 123  # Python's random permutes the frames into batches
SERVE_DEVICE = "cuda:0"


def plan_st_memory(n: int, size: int, device, batches: int = 2, flags=None) -> int:
    """The smallest -stMemory for which the port's own batch planner splits
    n size^2 frames into `batches` batches of n / batches on this host: a
    JSON job's stackBatches, or the CLI `stack` with `flags`
    (nightlight_tpu_torch/fixtures.py:plan_st_memory)."""
    from nightlight_tpu_torch.fixtures import plan_st_memory as plan

    try:
        return plan(n, size, device, batches, flags)
    except ValueError as e:
        raise SmokeFailure(str(e)) from e


def post_chunked(port: int, payload: dict, on_chunk=None):
    """POST a job to 127.0.0.1:port and read the chunked body frame by
    frame, as tests/test_rest.py's _post_raw_chunked does; on_chunk(bytes)
    sees each chunk as it arrives. Returns (header, chunks)."""
    import socket

    body = json.dumps(payload).encode()
    req = (f"POST /api/v1/job HTTP/1.1\r\nHost: 127.0.0.1\r\n"
           f"Content-Type: application/json\r\nContent-Length: {len(body)}\r\n\r\n"
           ).encode() + body
    with socket.create_connection(("127.0.0.1", port), timeout=600) as s:
        s.sendall(req)
        buf = b""
        while b"\r\n\r\n" not in buf:
            got = s.recv(65536)
            check(bool(got), "serve: connection closed before the header")
            buf += got
        header, data = buf.split(b"\r\n\r\n", 1)
        chunks = []
        while True:
            while b"\r\n" not in data:
                got = s.recv(65536)
                check(bool(got), "serve: connection closed mid-stream")
                data += got
            size_line, data = data.split(b"\r\n", 1)
            size = int(size_line, 16)
            if size == 0:
                break
            while len(data) < size + 2:
                got = s.recv(65536)
                check(bool(got), "serve: connection closed mid-chunk")
                data += got
            chunks.append(data[:size])
            if on_chunk is not None:
                on_chunk(data[:size])
            data = data[size + 2:]
    return header.decode(), chunks


def job_lines(log: str) -> list:
    """The log lines after the job's JSON echo ("Arguments:" from the
    server, "Running JSON job:" from `run`, each ending at the echo's
    closing brace), without the timing line and blank lines."""
    lines = log.splitlines()
    start = lines.index("}") + 1
    return [ln for ln in lines[start:] if ln.strip() and not ln.startswith("Done after")]


def serve_batches16(cli, fits_mod, kernels, serve_dir: str, size: int, record) -> None:
    """The served live-stacking job at full width: 16 lights through
    rest.make_server on a thread, st_memory chosen for 2 batches of 8; the
    chunked stream, the output and the K1/K4 launches checked; then the
    same job through the CLI `run` with the same seed and budget, held bit
    for bit against the served output, its log lines equal after the job
    echo."""
    import threading

    import torch

    from nightlight_tpu_torch.serve import rest

    n = len(glob.glob(os.path.join(serve_dir, "light*.fits")))
    check(n == 16, f"serve_batches16: {n} lights")
    st = plan_st_memory(n, size, torch.device(SERVE_DEVICE))
    say(f"serve_batches16: -stMemory {st} MiB plans 2 batches of {n // 2}")
    os.chdir(serve_dir)
    srv = rest.make_server(0, st, device=SERVE_DEVICE)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        random.seed(SERVE_SEED)
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        header, chunks = post_chunked(srv.server_address[1], serve_job("live_stacked.fits"))
        seconds = time.perf_counter() - t0
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated() / (1 << 30)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    log = b"".join(chunks).decode()
    write_log("chip_smoke_serve_batches16.log", log)
    starts = [ch.decode().strip() for ch in chunks if b"Starting batch" in ch]
    say(f"serve_batches16 (16 lights, live-stacking job, {n // 2} a batch): wall "
        f"{seconds:.2f} s peak {peak:.2f} GiB chunks {len(chunks)} launches {counts} "
        f"batch chunks {starts}")
    check("Transfer-Encoding: chunked" in header, f"serve_batches16: header {header!r}")
    check(len(chunks) > 20, f"serve_batches16: {len(chunks)} chunks")
    check(starts == [f"Starting batch 1 of 2 with {n // 2} frames...",
                     f"Starting batch 2 of 2 with {n // 2} frames..."],
          f"serve_batches16: batch chunks {starts}")
    check("Error" not in log, f"serve_batches16: log tail {log[-2000:]}")
    check(counts["stack_clip"] > 0 and counts["gather_patches"] > 0,
          f"serve_batches16: launches {counts}")
    served = check_output(fits_mod, "live_stacked.fits", size)
    check(bool(np.isfinite(served).all()), "serve_batches16: output not finite")
    record("serve_batches16", counts, seconds, peak)
    os.replace("live_stacked.fits", "served.fits")

    with open("job.json", "w") as fh:
        json.dump(serve_job("live_stacked.fits"), fh)
    random.seed(SERVE_SEED)
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    rc, run_log, run_seconds = run_cli(cli, ["-log", "", "-stMemory", str(st), "-job",
                                             "job.json", "run"], "chip_smoke_run_batches16.log",
                                       device=SERVE_DEVICE)
    run_counts = kernels.launch_counts()
    run_peak = torch.cuda.max_memory_allocated() / (1 << 30)
    check(rc == 0, f"run_batches16: rc {rc}; log tail {run_log[-2000:]}")
    ran = check_output(fits_mod, "live_stacked.fits", size)
    same_bits = bool(np.array_equal(served, ran, equal_nan=True))
    same_lines = job_lines(log) == job_lines(run_log)
    say(f"run_batches16 (the same job through `run`, seed {SERVE_SEED}): rc {rc} wall "
        f"{run_seconds:.2f} s peak {run_peak:.2f} GiB launches {run_counts}; output bit for "
        f"bit {same_bits}, log lines after the echo equal {same_lines}")
    check(same_bits, "run_batches16: output differs from the served one")
    check(same_lines, "run_batches16: log lines differ from the served ones")
    record("run_batches16", run_counts, run_seconds, run_peak)


OOC_BATCHES = 3
OOC_SEED = 3  # Python's random permutes ooc48's frames into batches
OOC_DEVICE = "cuda:0"


def ooc48(cli, fits_mod, kernels, lights, size: int, record) -> None:
    """The fused path out of core: the lights + dark at the defaults under
    the -stMemory for which the port's planner makes 3 random batches, with
    the next batch read ahead, then with NIGHTLIGHT_NO_PREFETCH=1 (the
    loader reads each batch ahead, but not the next batch during this
    one's compute); outputs bit for bit, logs equal apart from the
    Prefetched lines and timing, peak memory under the planner's device
    budget."""
    import torch

    from nightlight_tpu_torch.io.ingest import WINDOW_BYTES
    from nightlight_tpu_torch.pipeline.ops_stack import OpStackBatches

    device = torch.device(OOC_DEVICE)
    n = len(lights)
    per = n // OOC_BATCHES
    window_short = n * size * size * 2 > WINDOW_BYTES
    flags = ("-dark", "dark.fits")
    st = plan_st_memory(n, size, device, OOC_BATCHES, flags)
    budget = OpStackBatches._device_memory_mb(device) * 5 // 10 / 1024
    say(f"ooc48: -stMemory {st} MiB plans {OOC_BATCHES} batches of {per}; the planner's "
        f"device budget {budget:.2f} GiB")
    logs, outs = {}, {}
    # the first run of the three is the process's first out-of-core stack
    for name, no_prefetch in (("ooc48", False), ("ooc48_no_prefetch", True),
                              ("ooc48_again", False)):
        if no_prefetch:
            os.environ["NIGHTLIGHT_NO_PREFETCH"] = "1"
        try:
            random.seed(OOC_SEED)
            kernels.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            rc, log, seconds = run_cli(
                cli, ["-out", f"{name}.fits", *flags, "-jpg", "", "-log", "", "-stMemory",
                      str(st), "stack", *lights], f"chip_smoke_stack_{name}.log",
                device=OOC_DEVICE)
            counts = kernels.launch_counts()
            peak = torch.cuda.max_memory_allocated() / (1 << 30)
        finally:
            os.environ.pop("NIGHTLIGHT_NO_PREFETCH", None)
        prefetched = [ln for ln in log.splitlines() if ln.startswith("Prefetched ")]
        say(f"stack {name} ({n} lights, defaults, -stMemory {st}): rc {rc} wall {seconds:.2f} s "
            f"peak {peak:.2f} GiB launches {counts} {prefetched}")
        check(rc == 0 and "Error:" not in log, f"{name}: rc {rc}; log tail: {log[-2000:]}")
        check(f"Using {OOC_BATCHES} random batches of size {per} " in log, f"{name}: batch plan")
        stacks = re.findall(r"Stacking (\d+) frames with stacking mode (\d) ", log)
        check(len(stacks) == OOC_BATCHES, f"{name}: stacks {stacks}")
        check(PER_FRAME not in log, f"{name}: per-frame operator path taken")
        # the next batch is read ahead only where the read-ahead window
        # cannot hold the whole set already
        check(bool(prefetched) == (not no_prefetch and window_short),
              f"{name}: Prefetched lines {prefetched} with NIGHTLIGHT_NO_PREFETCH={no_prefetch}")
        check(counts["stack_clip"] > 0 and counts["gather_patches"] > 0,
              f"{name}: launches {counts}")
        check(peak < budget, f"{name}: peak {peak:.2f} GiB over the budget {budget:.2f}")
        record(name, counts, seconds, peak)
        logs[name] = [ln.replace(name, "ooc") for ln in log.splitlines()
                      if not ln.startswith(("Prefetched ", "Done after"))]
        outs[name] = check_output(fits_mod, f"{name}.fits", size)
        os.remove(f"{name}.fits")
    same_bits = all(np.array_equal(outs["ooc48"], o, equal_nan=True) for o in outs.values())
    same_lines = all(lines == logs["ooc48"] for lines in logs.values())
    say(f"ooc48 against ooc48_no_prefetch and ooc48_again: outputs bit for bit {same_bits}, "
        f"log lines equal {same_lines}")
    check(same_bits, "ooc48: the output differs without the prefetch")
    check(same_lines, "ooc48: the log differs without the prefetch")


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


def loader_reuse48(fits_mod, lights) -> None:
    """Every light through the read-ahead loader on cuda:0 in a shuffled
    order, as fast as the consumer can take them, its pool of pinned
    buffers far smaller than the frame count; then each frame, and its
    min/mean/max, bit for bit a direct read_file."""
    import torch

    from nightlight_tpu_torch import trace
    from nightlight_tpu_torch.io import ingest

    device = torch.device(OOC_DEVICE)
    ids = {name: i for i, name in enumerate(lights)}
    order = list(lights)
    random.Random(OOC_SEED).shuffle(order)
    loader = ingest.ReadAheadLoader.try_create(list(enumerate(lights)), io.StringIO(), device)
    check(loader is not None, "loader_reuse48: try_create refused BITPIX-16 lights")
    with trace.recording():
        first = len(trace.records())
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = {}
            for name in order:
                img = loader.get(name)
                img.stats._ensure_mmm()
                got[name] = img
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            pinned, inline = loader.pinned_buffers, loader.inline_reads
        finally:
            loader.close()
        reads = loader_seconds(trace.records()[first:])["workers_read_s"]
    apart = []
    for name in order:
        ref = fits_mod.read_file(name, id=ids[name], log=io.StringIO(), device=device)
        img = got.pop(name)
        if not (torch.equal(img.data, ref.data) and img.id == ref.id and (
                img.stats.min, img.stats.mean, img.stats.max) == (
                ref.stats.min, ref.stats.mean, ref.stats.max)):
            apart.append(name)
    say(f"loader_reuse48: {len(order)} lights through the loader in {seconds:.3f} s (page "
        f"cache warm), {pinned} pinned buffers, {inline} read inline, workers' reads "
        f"{reads:.3f} s; frames apart from read_file {apart}")
    check(0 < pinned < len(order), f"loader_reuse48: {pinned} pinned buffers")
    check(not apart, f"loader_reuse48: frames differ from read_file: {apart}")


# the smoke run's device mesh: 4 shards, all on one card
SHARDS = 4
MESH_DEVICE = "cuda:0"
ONE_DEVICE_LINE = "-shard requested but only one device attached; running unsharded"


def shard_mesh():
    import torch

    from nightlight_tpu_torch.parallel.mesh import make_mesh

    return make_mesh([torch.device(MESH_DEVICE)] * SHARDS)


def run_op_on(cli, kernels, op, mesh, log_name: str, per_frame: bool = False):
    """Run an operator job through the port's `run_op` on cuda:0 with
    c.mesh = mesh (None: unsharded; per_frame: the fused executor found
    ineligible for each batch, the path a mesh takes, after the same loads
    and batch plan), the launch counts and the mesh's gather counts set to
    0 just before, and every frame's placement after its load recorded;
    returns (log, seconds, counts, peak GiB, gathers, placements)."""
    import torch

    from nightlight_tpu_torch.models import fastpath
    from nightlight_tpu_torch.parallel import mesh as pmesh
    from nightlight_tpu_torch.pipeline import operators
    from nightlight_tpu_torch.pipeline.context import new_context

    log = io.StringIO()
    c = new_context(log=log, device=MESH_DEVICE)
    c.mesh = mesh
    placements = []
    load = operators.OpLoad.apply

    def placed(self, _unused, ctx):
        f = load(self, _unused, ctx)
        d = f.data
        placements.append([tuple(b.shape) for b in d.blocks]
                          if isinstance(d, pmesh.RowSharded) else [tuple(d.shape)])
        return f

    operators.OpLoad.apply = placed
    try:
        kernels.reset_launch_counts()
        pmesh.GATHERS.clear()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with fastpath.per_frame_path(per_frame):
            cli.run_op(op, c)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        operators.OpLoad.apply = load
    counts = kernels.launch_counts()
    gathers = dict(pmesh.GATHERS)
    peak = torch.cuda.max_memory_allocated() / (1 << 30)
    text = log.getvalue()
    write_log(log_name, text)
    return text, seconds, counts, peak, gathers, placements


def pixels_apart(a, b) -> int:
    """Pixels of two images that differ (NaN equal to NaN)."""
    return int((~((a == b) | (np.isnan(a) & np.isnan(b)))).sum())


# the batch planner's "this fits" count, and under a mesh its account of
# the devices it counted (pipeline/ops_stack.py _partition): the one
# planner line where a sharded job's log differs from the unsharded one's
FITS_CLAUSE = re.compile(r"this fits \d+ frames( on the mesh's \d+ devices \(\d+ MiB a "
                         r"frame's shard, the least device \d+ MiB\))?")


def same_lines(log_s: str, log_u: str, outs) -> bool:
    """The two jobs' log lines after the JSON echo equal, the outputs'
    names, the fused-off line's reason and the planner's count blanked."""
    def lines(log, out):
        return [PER_FRAME if ln.startswith(PER_FRAME) else FITS_CLAUSE.sub("this fits N", ln)
                for ln in job_lines(log.replace(out, "OUT"))]
    return lines(log_s, outs[0]) == lines(log_u, outs[1])


def sharded_against_unsharded(name: str, fits_mod, size: int, n: int, sharded, unsharded,
                              outs, kernel: str, record, keep: bool = False) -> None:
    """The checks of a shard4_* phase: every frame placed as 4 blocks of
    (size/4, size), no gather but the save's (detection runs on the shards
    and the stacked image stays row-sharded), the log line for line and the
    output bit for bit the unsharded per-frame run's, `kernel` launched 4x
    as often (None: no stacking kernel) and K4 once for each shard that
    holds a candidate, so between once and 4x as often; each run's wall and
    peak beside the card. `keep` keeps the outputs."""
    log_s, sec_s, cnt_s, peak_s, gath_s, place_s = sharded
    log_u, sec_u, cnt_u, peak_u, _, _ = unsharded
    shard = check_output(fits_mod, outs[0], size)
    plain = check_output(fits_mod, outs[1], size)
    apart = pixels_apart(shard, plain)
    lines_equal = same_lines(log_s, log_u, outs)
    blocks = [(size // SHARDS, size)] * SHARDS
    say(f"{name} ({n} lights, {SHARDS} shards on cuda:0; {card_line()}): first load "
        f"{place_s[0]}; gathers {gath_s}; wall {sec_s:.3f} s peak {peak_s:.2f} GiB launches "
        f"{cnt_s}; unsharded per-frame wall {sec_u:.3f} s peak {peak_u:.2f} GiB launches "
        f"{cnt_u}; pixels apart {apart}, log lines equal {lines_equal}")
    check("Error" not in log_s and "Error" not in log_u, f"{name}: error in a log")
    check(place_s[0] == blocks and all(p == blocks for p in place_s),
          f"{name}: placement {place_s[:2]}")
    check(gath_s == {"save": 1}, f"{name}: gathers {gath_s}")
    check(lines_equal, f"{name}: log lines differ from the unsharded run")
    check(apart == 0, f"{name}: {apart} pixels apart from the unsharded run")
    check(kernel is None or (cnt_u[kernel] > 0 and cnt_s[kernel] == SHARDS * cnt_u[kernel]),
          f"{name}: {kernel} launches {cnt_s.get(kernel)} against {cnt_u.get(kernel)}")
    k4_s, k4_u = cnt_s["gather_patches"], cnt_u["gather_patches"]
    check(0 < k4_u <= k4_s <= SHARDS * k4_u, f"{name}: gather_patches launches {k4_s} "
                                             f"against {k4_u}")
    record(name, cnt_s, sec_s, peak_s)
    record(f"{name}_unsharded", cnt_u, sec_u, peak_u)
    if not keep:
        for out in outs:
            os.remove(out)


def shard4_job16(cli, fits_mod, kernels, lights, size: int, record) -> None:
    """tests/test_rest.py's live-stacking job (fixed sigmas, as
    serve_batches16 runs it) on 16 lights, unsharded and then with a mesh of
    4 shards on cuda:0: each frame row-sharded from its load, the per-frame
    operators on the shards, the batch cube from each shard's blocks."""
    from nightlight_tpu_torch.pipeline import op_from_dict

    def job(out):
        d = serve_job(out)
        d["steps"][0]["filePatterns"] = list(lights[:16])
        return op_from_dict(d)

    outs = ("job16_shard.fits", "job16_plain.fits")
    unsharded = run_op_on(cli, kernels, job(outs[1]), None, "chip_smoke_job16_unsharded.log")
    sharded = run_op_on(cli, kernels, job(outs[0]), shard_mesh(), "chip_smoke_shard4_job16.log")
    check("Stacking 16 frames with stacking mode 3 " in sharded[0], "shard4_job16: stacking line")
    sharded_against_unsharded("shard4_job16", fits_mod, size, 16, sharded, unsharded, outs,
                              "stack_clip", record)


def shard4_auto(cli, fits_mod, kernels, lights, size: int, record, n: int, mode: int,
                kernel: str) -> None:
    """The `stack` preset at its defaults on n lights + dark (goal-seek)
    with a mesh of 4 shards on cuda:0, then unsharded on the per-frame
    path, the path a mesh takes: the fused executor off
    under the mesh, both clip percentages on target, and the checks of
    sharded_against_unsharded (the sharded search subsamples each shard's
    part of the unsharded search's pixels, so both take the same steps)."""
    from nightlight_tpu_torch.models.presets import build_command_seq

    name = f"shard4_auto{n}"

    def op(out):
        args = cli.build_parser().parse_args(["-out", out, "-dark", "dark.fits", "-jpg", "",
                                              "-log", "", "stack", *lights[:n]])
        cli.apply_command_defaults(args)
        return build_command_seq(args)

    outs = (f"auto{n}_shard.fits", f"auto{n}_plain.fits")
    sharded = run_op_on(cli, kernels, op(outs[0]), shard_mesh(), f"chip_smoke_{name}.log")
    unsharded = run_op_on(cli, kernels, op(outs[1]), None, f"chip_smoke_auto{n}_perframe.log",
                          per_frame=True)
    log_s = sharded[0]
    notes = [ln for ln in log_s.splitlines() if ln.startswith(("Clipped", "Reached", "Step"))]
    say(f"{name}: {notes}")
    check(f"{PER_FRAME}sharded run (mesh active)); using the per-frame operator path." in log_s,
          f"{name}: fused-off line missing")
    check(f"Stacking {n} frames with stacking mode {mode} " in log_s, f"{name}: stacking line")
    check("Reached 0.50% and 0.50% clipping" in log_s, f"{name}: goal-seek off target")
    clipped = re.findall(r"Clipped low \d+ \(([\d.]+)%\) high \d+ \(([\d.]+)%\)", log_s)
    check(clipped == [("0.50", "0.50")], f"{name}: clip line {clipped}")
    sharded_against_unsharded(name, fits_mod, size, n, sharded, unsharded, outs, kernel, record,
                              keep=n == 16)
    if n == 16:
        shard4_stretch(cli, fits_mod, kernels, outs[1], size, record)
        for out in outs:
            os.remove(out)


# the stretch runs of shard4_stretch on shard4_auto16's stack, each per-pixel
# stretch operator taking effect in one of them (at the defaults the stack's
# scale is already below the auto-stretch's target; midtones before gamma
# leaves negative pixels, whose power is NaN, so they run apart): name,
# flags, a line of each operator
SHARD_STRETCHES = (
    ("shard4_stretch", ("-autoScale", "2", "-gamma", "1.2", "-scaleBlack", "8"),
     ("applying gamma", "Applying gamma 1.2", "scaling black to move location to 8.00%")),
    ("shard4_stretch_midtone", ("-autoScale", "2", "-midtone", "20"),
     ("applying gamma", "Applying midtone correction")),
)


def shard4_stretch(cli, fits_mod, kernels, stacked: str, size: int, record) -> None:
    """The `stretch` command on a stacked image (shard4_auto16's) with each
    of SHARD_STRETCHES' flags, through `run_op` with a mesh of 4 shards on
    cuda:0 and then unsharded: normalize, the auto-stretch's rounds,
    midtones, gamma and black scaling run on the shards, detection too, and
    only the save gathers; the log line for line and the output bit for
    bit the unsharded run's (sharded_against_unsharded)."""
    from nightlight_tpu_torch.models.presets import build_command_seq

    for name, flags, texts in SHARD_STRETCHES:
        def op(out):
            args = cli.build_parser().parse_args(["-out", out, "-jpg", "", "-log", "", *flags,
                                                  "stretch", stacked])
            cli.apply_command_defaults(args)
            return build_command_seq(args)

        outs = (f"{name}.fits", f"{name}_plain.fits")
        sharded = run_op_on(cli, kernels, op(outs[0]), shard_mesh(), f"chip_smoke_{name}.log")
        unsharded = run_op_on(cli, kernels, op(outs[1]), None,
                              f"chip_smoke_{name}_unsharded.log")
        rounds = [ln for ln in sharded[0].splitlines() if "Linear location" in ln]
        say(f"{name} ({' '.join(flags)}): rounds {rounds}")
        check(len(rounds) > 1, f"{name}: no auto-stretch round")
        for text in texts:
            check(text in sharded[0], f"{name}: '{text}' missing")
        sharded_against_unsharded(name, fits_mod, size, 1, sharded, unsharded, outs, None,
                                  record)


def shard4_detect16(fits_mod, gather_cuda, kernels, lights, size: int) -> dict:
    """The sharded detector (parallel/mesh.py sharded_star_detect, 4 shards
    on cuda:0) on each of 16 lights at the `stack` preset's detection
    arguments (radius 16, sigma 15, bad-pixel sigma 5 with the stddev
    computed, in/out 1.4) against find_stars on the whole frame: the
    StarList bit for bit, K4 launched once for each shard that holds a
    candidate. Then K4 on the first light's haloed blocks ((size/4 + 32 or
    64) x size, the centres of the path) against its plain version, masks
    equal and in-frame values bit for bit, timed as the other kernel rows.
    Returns that row of the kernel table."""
    import torch

    from nightlight_tpu_torch.detect import stars
    from nightlight_tpu_torch.ops.stats import Stats
    from nightlight_tpu_torch.parallel import mesh as pmesh

    dev = torch.device(MESH_DEVICE)
    mesh = shard_mesh()
    calls = []
    real = stars.gather_patches

    def spy(img, cys, cxs, radius):
        calls.append((img, cys, cxs, radius))
        return real(img, cys, cxs, radius)

    walls = {"sharded": 0.0, "unsharded": 0.0}
    counts, launches, first = [], [], None
    for i, name in enumerate(lights[:16]):
        img = fits_mod.read_file(name, device=dev).data
        st = Stats(img, size)
        args = (st.location, st.scale, 15.0, 5.0, 1.4, 16, None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = stars.find_stars(img, *args)
        torch.cuda.synchronize()
        walls["unsharded"] += time.perf_counter() - t0
        x = pmesh.place_on_mesh(img, mesh)
        calls.clear()
        kernels.reset_launch_counts()
        stars.gather_patches = spy
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = pmesh.sharded_star_detect(mesh, 16)(x, *args[:5], None)
            torch.cuda.synchronize()
            walls["sharded"] += time.perf_counter() - t0
        finally:
            stars.gather_patches = real
        launched = kernels.launch_counts()["gather_patches"]
        same = (got[0].count == want[0].count and got[1] == want[1] and all(
            np.array_equal(getattr(got[0], f), getattr(want[0], f))
            for f in ("x", "y", "value", "mass", "hfr")))
        check(same, f"shard4_detect16: light {i}: sharded stars differ from find_stars "
                    f"({got[0].count} against {want[0].count})")
        check(launched == len(calls) > 0, f"shard4_detect16: light {i}: {launched} K4 "
                                          f"launches for {len(calls)} shards with candidates")
        counts.append(got[0].count)
        launches.append(launched)
        if i == 0:
            first = list(calls)
        del img, x
    say(f"shard4_detect16 ({SHARDS} shards on cuda:0; {card_line()}): stars {counts} bit for "
        f"bit find_stars; K4 launches per frame {launches}; detection {walls['sharded']:.3f} s "
        f"sharded against {walls['unsharded']:.3f} s whole (16 frames)")

    # K4 on the first light's haloed blocks
    r = first[0][3]
    win = 2 * r + 1
    err, shapes, inside = 0.0, [], 0
    ms = {"ms": 0.0, "single_call_ms": 0.0}
    plain_ms = library_ms = 0.0
    for ext, cys, cxs, _ in first:
        h, w = ext.shape
        pk, ok_k = gather_cuda.gather_patches_cuda(ext, cys, cxs, r)
        pp, ok_p = gather_cuda.patches_plain(ext, cys, cxs, r)
        torch.cuda.synchronize()
        check(torch.equal(ok_k, ok_p), f"gather_patches halo block {h}x{w}: masks differ")
        err = max(err, float(torch.where(ok_k, (pk - pp).abs(),
                                         torch.zeros((), device=dev)).max()))
        for key, v in kernel_ms(lambda: gather_cuda.gather_patches_cuda(ext, cys, cxs,
                                                                        r)).items():
            ms[key] += v
        plain_ms += cuda_ms(lambda: gather_cuda.patches_plain(ext, cys, cxs, r))
        yy, xx, _ = gather_cuda._offsets(cys, cxs, r, h, w)
        yy_c, xx_c = yy.clamp(0, h - 1), xx.clamp(0, w - 1)
        library_ms += cuda_ms(lambda: ext[yy_c, xx_c], calls=KERNEL_CALLS)
        shapes.append([int(cys.shape[0]), h, w])
        inside += int(ok_k.sum())
    check(err == 0.0, f"gather_patches halo blocks: kernel vs plain error {err}")
    k = sum(sh[0] for sh in shapes)
    work = bound(4.0 * inside + 8.0 * k + (4.0 + 1.0) * k * win * win, 0.0)
    say(f"gather_patches halo blocks: {len(shapes)} blocks (K, rows, cols) {shapes}, r={r}: "
        f"max_abs_err {err:.3g} (where ok), masks equal; calls {ms['ms']:.4f} ms "
        f"({ms['single_call_ms']:.4f} single calls), plain {plain_ms:.3f} ms, ext[yy_c, xx_c] "
        f"{library_ms:.4f} ms, bound {work['bound_ms']:.5f} ms (all blocks summed)")
    src, replaces = KERNELS["gather_patches"]
    return {"name": "gather_patches halo blocks", "kernel": "gather_patches", "route": "cuda",
            "source": src, "replaces": replaces, "max_abs_err": err, **ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "shape": shapes,
            "in_frame": inside, **work, "share_of_bound": work["bound_ms"] / ms["ms"],
            "detect16_walls_s": walls, "detect16_launches": launches}


def mesh_step16(fits_mod, kernels, lights, size: int, record) -> None:
    """ops/stack.py stack_sharded at full size on 4 shards of cuda:0
    against stack on one: the cube of 16 lights (winsorized, K1) and 30
    frames of sky with outliers (linear fit, K2), bit for bit with equal
    clip counts and each shard's kernel launched once."""
    import torch

    from nightlight_tpu_torch.ops import stack as tstk
    from nightlight_tpu_torch.parallel import mesh as pmesh

    dev = torch.device(MESH_DEVICE)
    mesh = shard_mesh()
    counts, walls = {k: 0 for k in kernels.KERNEL_NAMES}, {}
    torch.cuda.reset_peak_memory_stats()

    def timed(name, fn):
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        got = kernels.launch_counts()
        for k, v in got.items():
            counts[k] += v
        return out, got

    cube = torch.from_numpy(np.stack([fits_mod.read_file(n).to_numpy()
                                      for n in lights[:16]])).to(dev)
    gen = torch.Generator(device=dev).manual_seed(9)
    sky30 = frames_with_outliers(gen, 30, size * size, dev).reshape(30, size, size)
    for name, x, mode, kernel in (("winsorized 16", cube, tstk.StackMode.WinsorSigma,
                                   "stack_clip"),
                                  ("linear fit 30", sky30, tstk.StackMode.LinearFit,
                                   "stack_linfit")):
        u, u_counts = timed(f"stack {name}", lambda: tstk.stack(x, mode))
        sh, s_counts = timed(f"stack_sharded {name}", lambda: tstk.stack_sharded(x, mesh, mode))
        apart = pixels_apart(pmesh.gather(sh[0]).cpu().numpy(), u[0].cpu().numpy())
        same = (int(sh[1]), int(sh[2])) == (int(u[1]), int(u[2]))
        say(f"mesh_step16 stack_sharded {name} vs stack: pixels apart {apart}, clip counts "
            f"({int(sh[1])}, {int(sh[2])}) equal {same}; launches {s_counts[kernel]} against "
            f"{u_counts[kernel]}; walls {walls[f'stack_sharded {name}']:.4f} / "
            f"{walls[f'stack {name}']:.4f} s")
        check(apart == 0 and same, f"mesh_step16: stack_sharded {name} differs from stack")
        check(s_counts[kernel] == SHARDS * u_counts[kernel] > 0,
              f"mesh_step16: {name} {kernel} launches {s_counts[kernel]}")
        del u, sh
    peak = torch.cuda.max_memory_allocated() / (1 << 30)
    record("mesh_step16", counts, sum(walls.values()), peak)


def cli_shard(cli, fits_mod, kernels, lights, size: int, record) -> None:
    """The CLI's `stack -shard` (defaults, -dark, 8 lights) on the card:
    with one card the JAX CLI's one-device line and an output bit for bit
    the run without -shard; with more, a mesh over every card."""
    import torch

    count = torch.cuda.device_count()
    base = ["-dark", "dark.fits", "-jpg", "", "-log", ""]
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    rc, log, seconds = run_cli(cli, ["-out", "shard8.fits", *base, "-shard", "stack",
                                     *lights[:8]], "chip_smoke_cli_shard.log")
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / (1 << 30)
    check(rc == 0 and "Error:" not in log, f"cli_shard: rc {rc}; log tail {log[-2000:]}")
    shard = check_output(fits_mod, "shard8.fits", size)
    if count == 1:
        rc_p, log_p, _ = run_cli(cli, ["-out", "plain8.fits", *base, "stack", *lights[:8]],
                                 "chip_smoke_cli_plain.log")
        plain = check_output(fits_mod, "plain8.fits", size)
        same = bool(np.array_equal(shard, plain, equal_nan=True))
        say(f"cli_shard (one card): rc {rc} wall {seconds:.3f} s launches {counts}; "
            f"one-device line {ONE_DEVICE_LINE in log.splitlines()}; output bit for bit the "
            f"run without -shard {same}")
        check(rc_p == 0 and ONE_DEVICE_LINE in log.splitlines(), "cli_shard: one-device line")
        check(same, "cli_shard: output differs from the run without -shard")
        os.remove("plain8.fits")
    else:
        line = f"Sharding frames over {count} devices"
        say(f"cli_shard ({count} cards): rc {rc} wall {seconds:.3f} s launches {counts}; "
            f"'{line}' {line in log.splitlines()}")
        check(line in log.splitlines(), f"cli_shard: '{line}' missing")
    record("cli_shard", counts, seconds, peak)
    os.remove("shard8.fits")


def serve_two_jobs(fixtures, fits_mod, work: str) -> str:
    """Two 512^2 live-stacking jobs POSTed together: the second goes out
    once the first streams a line from inside the job lock, so it must
    stream the queued notice; both complete. Returns the lights'
    directory."""
    import threading

    from nightlight_tpu_torch.serve import rest

    sdir = os.path.join(work, "serve_small")
    fixtures.gen(sdir, 8, 512, seed=11)
    os.chdir(sdir)
    srv = rest.make_server(0, 0, device=SERVE_DEVICE)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    port = srv.server_address[1]
    inside = threading.Event()
    results = {}

    def first():
        results["a"] = post_chunked(port, serve_job("a.fits"),
                                    lambda ch: b"Found" in ch and inside.set())

    try:
        ta = threading.Thread(target=first)
        ta.start()
        check(inside.wait(timeout=300), "serve two jobs: the first job streamed nothing")
        results["b"] = post_chunked(port, serve_job("b.fits"))
        ta.join(timeout=600)
        check(not ta.is_alive() and "a" in results, "serve two jobs: the first job hung")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    logs = {k: b"".join(v[1]).decode() for k, v in results.items()}
    queued = [k for k, v in logs.items() if "Queued: another job is running" in v]
    say(f"serve two 512^2 jobs at once: queued notice in {queued}, "
        f"errors {[k for k, v in logs.items() if 'Error' in v]}")
    check(queued == ["b"], f"serve two jobs: queued notice in {queued}")
    for k in ("a", "b"):
        check("Error" not in logs[k], f"serve two jobs: job {k} log tail {logs[k][-2000:]}")
        check_output(fits_mod, f"{k}.fits", 512)
    return sdir


def serve_cli(sdir: str, fits_mod) -> None:
    """`python -m nightlight_tpu_torch.cli -port P serve` as a subprocess in
    sdir: it answers ping within a time limit, lists all 45 operators in
    its schema and completes one 512^2 job; killed in a finally."""
    import socket
    import urllib.request

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    os.makedirs(LOG_DIR, exist_ok=True)
    out_path = os.path.join(LOG_DIR, "chip_smoke_serve_cli.log")
    t0 = time.perf_counter()
    with open(out_path, "w") as out:
        proc = subprocess.Popen([sys.executable, "-m", "nightlight_tpu_torch.cli", "-log", "",
                                 "-port", str(port), "serve"],
                                cwd=sdir, env=env, stdout=out, stderr=subprocess.STDOUT)
        try:
            base = f"http://127.0.0.1:{port}"
            while True:
                check(proc.poll() is None, f"serve CLI exited with {proc.returncode}")
                check(time.perf_counter() - t0 < 180, "serve CLI: no ping within 180 s")
                try:
                    with urllib.request.urlopen(base + "/api/v1/ping", timeout=5) as resp:
                        pong = json.loads(resp.read())
                    break
                except OSError:
                    time.sleep(0.5)
            ready = time.perf_counter() - t0
            with urllib.request.urlopen(base + "/api/v1/schema", timeout=30) as resp:
                ops = json.loads(resp.read())["operators"]
            _, chunks = post_chunked(port, serve_job("cli.fits"))
            log = b"".join(chunks).decode()
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
    say(f"serve CLI subprocess: ping {pong} after {ready:.1f} s, schema {len(ops)} operators, "
        f"job {'completed' if 'Writing 512x512 pixel FITS to cli.fits' in log else 'FAILED'}")
    check(pong == {"message": "pong"} and len(ops) == 45, "serve CLI: ping or schema")
    check("Error" not in log and "Writing 512x512 pixel FITS to cli.fits" in log,
          f"serve CLI: job log tail {log[-2000:]}")
    check_output(fits_mod, os.path.join(sdir, "cli.fits"), 512)


def extras_on_card() -> None:
    """ops/stats_extra.py and ops/color_extra.py on the card against the
    CPU on the same seeded inputs, in the bands of tests/test_torch_extras.py
    (there against the JAX package): the clip window, the medians and the
    bounded order statistics exactly, MADs within one float32 step, the
    bounded stddev within 1e-6 relative (its sum's order); OkLab within 4
    float32 steps of 1.0, the hue within 2 steps on the circle."""
    import torch

    from nightlight_tpu_torch.ops import color_extra as ce
    from nightlight_tpu_torch.ops import jaxrand
    from nightlight_tpu_torch.ops import stats_extra as se

    rng = np.random.default_rng(42)
    x = rng.normal(10.0, 1.0, size=1 << 20).astype(np.float32)
    x[:25000] = 1000.0
    cpu, dev = torch.from_numpy(x), torch.from_numpy(x).to(SERVE_DEVICE)
    med_c, mad_c = se.sigma_clipped_median_and_mad(cpu, 2.0, 2.5)
    med_g, mad_g = se.sigma_clipped_median_and_mad(dev, 2.0, 2.5)
    mad_ulps = abs(int(np.float32(mad_g.cpu()).view(np.int32))
                   - int(np.float32(mad_c).view(np.int32)))
    key = jaxrand.prng_key(5)
    bounded = {}
    for name, fn in (("median", lambda d: se.fast_approx_bounded_median(d, 5.0, 15.0, key)),
                     ("mad", lambda d: se.fast_approx_bounded_mad(d, 10.0, 5.0, 15.0, key)),
                     ("qn", lambda d: se.fast_approx_bounded_qn(d, 5.0, 15.0, key)),
                     ("stddev", lambda d: se.fast_approx_bounded_stddev(d, 10.0, 5.0, 15.0,
                                                                       key))):
        bounded[name] = (float(fn(cpu)), float(fn(dev)))
    hsm = (se.half_sample_mode(cpu[:65536]), se.half_sample_mode(dev[:65536]))
    rgb = rng.uniform(-0.05, 1.05, size=(3, 1024, 1024)).astype(np.float32)
    lab_c = ce.linrgb_to_oklab(torch.from_numpy(rgb))
    lab_g = ce.linrgb_to_oklab(torch.from_numpy(rgb).to(SERVE_DEVICE))
    lab_err = float((lab_g.cpu() - lab_c).abs().max())
    back_err = float((ce.oklab_to_linrgb(lab_c.to(SERVE_DEVICE)).cpu()
                      - ce.oklab_to_linrgb(lab_c)).abs().max())
    hcl_c = ce.oklab_to_okhcl(lab_c)
    hcl_g = ce.oklab_to_okhcl(lab_c.to(SERVE_DEVICE)).cpu()
    dh = ((hcl_g[0] - hcl_c[0] + 180.0) % 360.0 - 180.0).abs()
    hue_ok = bool((dh <= 2 * torch.from_numpy(np.spacing(hcl_c[0].abs().numpy()))
                   + 1e-12).all())
    rt_err = float((ce.okhcl_to_oklab(hcl_c.to(SERVE_DEVICE)).cpu()
                    - ce.okhcl_to_oklab(hcl_c)).abs().max())
    say(f"extras gpu vs cpu: sigma-clipped median {float(med_g)} / {float(med_c)}, MAD "
        f"{mad_ulps} steps apart; bounded {bounded}; half-sample mode {hsm}; OkLab max "
        f"abs diff {lab_err:.3g}, inverse {back_err:.3g}, hue within 2 steps {hue_ok}, "
        f"HCL -> OkLab {rt_err:.3g}")
    step = float(np.spacing(np.float32(1.0)))
    check(float(med_g) == float(med_c) and mad_ulps <= 1, "extras: sigma-clipped median/MAD")
    check(all(g == c for k, (c, g) in bounded.items() if k != "stddev"),
          f"extras: bounded estimators {bounded}")
    check(abs(bounded["stddev"][1] - bounded["stddev"][0]) <= 1e-6 * bounded["stddev"][0],
          f"extras: bounded stddev {bounded['stddev']}")
    check(hsm[0] == hsm[1], f"extras: half-sample mode {hsm}")
    check(lab_err <= 4 * step and back_err <= 4 * step and hue_ok and rt_err <= 4 * step,
          "extras: OkLab outside the band")


def run_microbench(mod, log_name: str):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        results = mod.main([])
    write_log(log_name, buf.getvalue())
    say(buf.getvalue().rstrip())
    check("values match: True" in buf.getvalue(), f"{log_name}: variants disagree")
    return results


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=4096, help="frame edge in pixels")
    opts = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, ROOT)
    from nightlight_tpu_torch import cli, fixtures, kernels
    from nightlight_tpu_torch.io import fits as nlfits
    from nightlight_tpu_torch.ops import gather_cuda, sortnet_cuda, stack_cuda
    from nightlight_tpu_torch.scripts import microbench_layout, microbench_tile

    with contextlib.suppress(FileNotFoundError):
        os.remove(os.path.join(LOG_DIR, "chip_smoke.out"))
    say(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    say(card_line())  # name, power limit as nvidia-smi prints them
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()

    t0 = time.perf_counter()
    kernels.build()
    kernels.library()
    say(f"kernel build: {time.perf_counter() - t0:.1f} s (nvcc {kernels.BUILD_INFO.get('seconds', 0.0):.1f} s)")
    ptxas = kernels.BUILD_INFO.get("ptxas", "")
    if ptxas:
        write_log("ptxas.txt", ptxas)
        say(spill_summary(ptxas))
        ring = ptxas_entries(ptxas, "sort_sum_ring_kernel")
        for function, regs, stores, loads in ring:
            say(f"ptxas {function}: {regs} registers, spill stores {stores} B, loads {loads} B")
        check(len(ring) == len(sortnet_cuda.BLOCK_SIZES), f"ptxas: ring kernels {ring}")
        check(all(r[2] == 0 and r[3] == 0 for r in ring), "ptxas: a ring kernel spills")

    rows, buckets = kernel_cases(opts.size, stack_cuda, gather_cuda, kernels)
    rows += warp_cases(opts.size, kernels)
    rows += sort_sum_cases(sortnet_cuda, microbench_layout)
    torch.cuda.empty_cache()

    size = opts.size
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="smoke-", dir=os.path.join(ROOT, "build"))
    cwd = os.getcwd()
    totals = {name: 0 for name in kernels.KERNEL_NAMES}
    per_stack = {}
    walls = {}
    peaks = {}
    try:
        rows += finish_cases(work, kernels)
        t0 = time.perf_counter()
        all_lights = [os.path.basename(p) for p in fixtures.gen(work, 48, size, seed=7)]
        lights = all_lights[:30]
        say(f"fixtures: 48 lights + dark of {size}x{size} in {time.perf_counter() - t0:.1f} s")
        os.chdir(work)
        for name, n, flags, mode, kernel, per_frame, clipped in STACKS:
            out = f"stack_{name}.fits"
            kernels.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            rc, log, seconds = run_cli(
                cli, ["-out", out, "-dark", "dark.fits", "-jpg", "", "-log", "", *flags,
                      "stack", *lights[:n]], f"chip_smoke_stack_{name}.log")
            counts = kernels.launch_counts()
            for k, v in counts.items():
                totals[k] += v
            per_stack[name] = counts
            walls[name] = seconds
            peak = torch.cuda.max_memory_allocated() / (1 << 30)
            notes = [ln for ln in log.splitlines()
                     if ln.startswith(("Clipped", "Reached", "Warning", PER_FRAME))]
            say(f"stack {name} ({n} lights {' '.join(flags) or 'defaults'}): rc {rc} wall "
                f"{seconds:.2f} s peak {peak:.2f} GiB launches {counts} {notes}")
            check(rc == 0, f"stack {name}: rc {rc}; log tail: {log[-2000:]}")
            check("Error:" not in log, f"stack {name}: error in log")
            check(f"Stacking {n} frames with stacking mode {mode} " in log,
                  f"stack {name}: expected stacking mode {mode}")
            check((PER_FRAME in log) == per_frame,
                  f"stack {name}: per-frame operator path {'not ' if per_frame else ''}taken")
            check(("Clipped low" in log) == clipped,
                  f"stack {name}: clip line {'missing' if clipped else 'unexpected'}")
            check(counts[kernel] > 0, f"stack {name}: {kernel} never launched")
            check(counts["gather_patches"] > 0, f"stack {name}: gather_patches never launched")
            check(counts["warp_shift"] > 0, f"stack {name}: warp_shift never launched")
            check(counts["detect_finish"] > 0, f"stack {name}: detect_finish never launched")
            check_output(nlfits, out, size)
            os.remove(out)

        def record(name, counts, seconds, peak):
            for k, v in counts.items():
                totals[k] += v
            per_stack[name] = counts
            walls[name] = seconds
            peaks[name] = peak

        # ingest (io/ingest.py): the out-of-core stack, the pinned pool
        ooc48(cli, nlfits, kernels, all_lights, size, record)
        loader_reuse48(nlfits, all_lights)
        for ln in all_lights[30:]:
            os.remove(ln)
        torch.cuda.empty_cache()

        # the device mesh (parallel/mesh.py): 4 shards on cuda:0
        rows.append(shard4_detect16(nlfits, gather_cuda, kernels, lights, size))
        shard4_job16(cli, nlfits, kernels, lights, size, record)
        shard4_auto(cli, nlfits, kernels, lights, size, record, 16, 3, "stack_clip")
        shard4_auto(cli, nlfits, kernels, lights, size, record, 30, 5, "stack_linfit")
        mesh_step16(nlfits, kernels, lights, size, record)
        cli_shard(cli, nlfits, kernels, lights, size, record)
        torch.cuda.empty_cache()

        # 16 lights stay for the served live-stacking job (serve_batches16)
        serve_dir = os.path.join(work, "serve")
        os.makedirs(serve_dir)
        for ln in lights[:16]:
            os.replace(ln, os.path.join(serve_dir, ln))
        for ln in lights[16:]:
            os.remove(ln)

        # the one-shot-colour chain and the stretch command
        osc = os.path.join(work, "osc")
        t0 = time.perf_counter()
        osc_lights = [os.path.basename(p) for p in
                      fixtures.gen(osc, 16, size, seed=7, bayer="RGGB")]
        say(f"fixtures: 16 RGGB lights + dark of {size}x{size} in "
            f"{time.perf_counter() - t0:.1f} s")
        os.chdir(osc)
        for name, n, flags, mode, per_frame, div, chain in OSC_STACKS:
            out = f"stack_{name}.fits"
            kernels.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            rc, log, seconds = run_cli(
                cli, ["-out", out, "-dark", "dark.fits", "-cfa", "RGGB", "-jpg", "", "-log", "",
                      *flags, "stack", *osc_lights[:n]], f"chip_smoke_stack_{name}.log")
            counts = kernels.launch_counts()
            for k, v in counts.items():
                totals[k] += v
            per_stack[name] = counts
            walls[name] = seconds
            peaks[name] = torch.cuda.max_memory_allocated() / (1 << 30)
            stacking = re.findall(r"Stacking (\d+) frames with stacking mode (\d) ", log)
            notes = [ln for ln in log.splitlines()
                     if ln.startswith(("Clipped", "Reached", "Stacking", PER_FRAME))]
            say(f"stack {name} ({n} lights {' '.join(flags)}): rc {rc} wall {seconds:.2f} s "
                f"peak {peaks[name]:.2f} GiB launches {counts} {notes}")
            check(rc == 0, f"stack {name}: rc {rc}; log tail: {log[-2000:]}")
            check("Error:" not in log, f"stack {name}: error in log")
            check(len(stacking) == 1, f"stack {name}: no stacking line")
            stacked, got_mode = int(stacking[0][0]), int(stacking[0][1])
            want_mode = mode if mode is not None else (
                5 if stacked >= 25 else 3 if stacked >= 15 else 2 if stacked >= 6 else 1)
            check(stacked >= 3 and got_mode == want_mode,
                  f"stack {name}: {stacked} frames in mode {got_mode}, expected {want_mode}")
            check((PER_FRAME in log) == per_frame,
                  f"stack {name}: per-frame operator path {'not ' if per_frame else ''}taken")
            for text in ("bad bayer pixels", "Debayered channel", *chain):
                lines = [ln for ln in log.splitlines() if text in ln]
                check(len(lines) == n, f"stack {name}: {len(lines)} '{text}' lines for {n} lights")
            check("Clipped low" in log, f"stack {name}: clip line missing")
            check(counts["stack_clip"] > 0, f"stack {name}: stack_clip never launched")
            check(counts["gather_patches"] > 0, f"stack {name}: gather_patches never launched")
            check_output(nlfits, out, size, (size // div, size // div))
            if name != "osc12_G":
                os.remove(out)
        for name, flags in STRETCHES:
            kernels.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            rc, log, seconds = run_cli(
                cli, ["-out", f"{name}.fits", "-tiff", f"{name}.tif", "-jpg", f"{name}.jpg",
                      "-log", "", *flags, "stretch", "stack_osc12_G.fits"],
                f"chip_smoke_{name}.log")
            counts = kernels.launch_counts()
            for k, v in counts.items():
                totals[k] += v
            per_stack[name] = counts
            walls[name] = seconds
            peaks[name] = torch.cuda.max_memory_allocated() / (1 << 30)
            rounds = [ln for ln in log.splitlines() if "Linear location" in ln]
            say(f"{name} ({' '.join(flags) or 'defaults'}): rc {rc} wall {seconds:.2f} s peak "
                f"{peaks[name]:.2f} GiB launches {counts} rounds {rounds}")
            check(rc == 0 and "Error:" not in log, f"{name}: rc {rc}; log tail: {log[-2000:]}")
            check(len(rounds) > 0, f"{name}: no auto-stretch round")
            for text in (("Gaussian blur kernel", "Unsharp masking kernel") if flags else ()):
                check(text in log, f"{name}: '{text}' missing")
            check(counts["gather_patches"] > 0, f"{name}: gather_patches never launched")
            check_output(nlfits, f"{name}.fits", size)
            for ext in ("tif", "jpg"):
                check(os.path.getsize(f"{name}.{ext}") > 0, f"{name}: empty .{ext}")
        os.chdir(work)
        shutil.rmtree(osc, ignore_errors=True)

        color_runs(cli, nlfits, fixtures, kernels, work, size, record)
        small_rgb_gpu_vs_cpu(cli, nlfits, fixtures, work)
        small_commands(cli, nlfits, fixtures, work)
        small_gpu_vs_cpu(cli, nlfits, fixtures, work, "defaults", ())
        small_gpu_vs_cpu(cli, nlfits, fixtures, work, "mad_lsEst1",
                         ("-stMode", "4", "-lsEst", "1"))
        sdir = small_gpu_vs_cpu(cli, nlfits, fixtures, work, "osc_G_mode3",
                                ("-cfa", "RGGB", "-debayer", "G", "-stMode", "3"), bayer="RGGB")
        small_stretch_gpu_vs_cpu(cli, nlfits, sdir)

        # the REST server: the served live-stacking job at full width held
        # against `run`, two jobs at once, the CLI entry point; the extras
        serve_batches16(cli, nlfits, kernels, serve_dir, size, record)
        os.chdir(work)
        shutil.rmtree(serve_dir, ignore_errors=True)
        small_dir = serve_two_jobs(fixtures, nlfits, work)
        serve_cli(small_dir, nlfits)
        os.chdir(work)
        shutil.rmtree(small_dir, ignore_errors=True)
        extras_on_card()
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()

    # the microbenchmark entry points, the main path of K5/K6
    kernels.reset_launch_counts()
    run_microbench(microbench_layout, "microbench_layout.log")
    run_microbench(microbench_tile, "microbench_tile.log")
    counts = kernels.launch_counts()
    check(counts["sort_sum"] > 0, "microbenchmarks: sort_sum never launched")
    totals["sort_sum"] += counts["sort_sum"]

    per_stack["microbench"] = {"sort_sum": counts["sort_sum"]}
    for row in rows:
        row["launches"] = totals[row["kernel"]]
        row["launches_per_stack"] = {name: c[row["kernel"]] for name, c in per_stack.items()
                                     if c.get(row["kernel"], 0) > 0}
    say(json.dumps({"buckets": buckets}))
    say(json.dumps({"walls_s": walls, "peak_gib": peaks}))
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
