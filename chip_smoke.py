"""Smoke run of the PyTorch port's main path on one NVIDIA GPU.

    python3 chip_smoke.py            # full size: 4096x4096 frames
    python3 chip_smoke.py --size 1024  # a quicker pass at a smaller frame size

1. Prints torch/CUDA versions and the card's name and power limit.
2. Builds the CUDA kernels from nightlight_tpu_torch/csrc (one nvcc per
   source, all at once, sm_90a).
3. Holds each kernel against its plain PyTorch version on the card at the
   main path's shapes, timing both with CUDA events (median of 5): K1 sigma
   8 frames, K1 winsorized 16, K1 weighted sigma 10, K2 linear fit 30, K3
   median 16 and MAD 30, all at size^2 pixels with 5% outliers and 5% NaN;
   K4 with K=2048, r=32; K5 column and tiled and K6 tiled at 128/256/512/
   1024 threads per block on (40, 2^21) samples, bit for bit.
4. Writes BITPIX-16 fixtures (nightlight_tpu_torch/fixtures.py, the recipe
   of scripts/gen_fixtures.py): 30 lights and a master dark.
5. Runs the port's CLI `stack` with -dark on the first N lights: auto mode
   at 30, 16 and 8 (linear fit, winsorized, sigma clip), -stMode 4 at 30
   (MAD, fused executor), -stMode 0 -lsEst 1 at 16 (median, per-frame
   operator path), -lsEst 2 and -lsEst 4 at 8 (sigma clip, per-frame).
   Checks the return code, the stacking mode, the per-frame path line and
   the clip line where expected, the output FITS and the kernel launch
   counts of each run; then holds two small stacks on the card (defaults;
   -stMode 4 -lsEst 1) against the same stacks on the CPU.
6. Runs the sort-network microbenchmarks (nightlight_tpu_torch.scripts.
   microbench_layout and microbench_tile) and checks their launches and
   that every variant gives the same value.
7. Prints the kernel table as JSON, and as the last line
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
import os
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


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5) -> float:
    """Median of `reps` CUDA-event timings of fn() after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def frames_with_outliers(gen, n: int, p: int, device):
    """(n, p) float32 sky samples on the card: noise about 1000, 5% bright
    outliers (cosmic rays / satellites), 5% missing (NaN) samples."""
    import torch

    f = torch.randn((n, p), generator=gen, device=device) * 10.0 + 1000.0
    u = torch.rand((n, p), generator=gen, device=device)
    f = torch.where(u < 0.05, f + 2000.0, f)
    f = torch.where((u > 0.5) & (u < 0.55), torch.full((), float("nan"), device=device), f)
    return f.contiguous()


def kernel_cases(size: int, stack_cuda, gather_cuda, sortnet_cuda, microbench_layout):
    """Each kernel against its plain version on the card. Returns rows for
    the kernel table."""
    import torch

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    p = size * size
    rows = []
    sig_lo, sig_hi, ref_loc = 2.5, 2.5, 0.0

    def stack_case(name, kernel, n, run_k, run_p, exact_counts, clips):
        ok_, clo_k, chi_k = run_k()
        op_, clo_p, chi_p = run_p()
        torch.cuda.synchronize()
        err = float((ok_ - op_).abs().max())
        rel = float(((ok_ - op_).abs() / op_.abs().clamp(min=1e-6)).max())
        counts_k = (int(clo_k), int(chi_k))
        counts_p = (int(clo_p), int(chi_p))
        ms = cuda_ms(run_k)
        plain_ms = cuda_ms(run_p)
        say(f"{name}: {n}x{p} max_abs_err {err:.3g} max_rel_err {rel:.3g} "
            f"clips kernel {counts_k} plain {counts_p} kernel {ms:.3f} ms plain {plain_ms:.3f} ms")
        # band: the kernel runs the plain version's float32 arithmetic in the
        # same order (sequential sums, no fused multiply-add), so outputs
        # agree to float32 rounding and clip totals to within a handful of
        # samples out of n*p (K1, K2), exactly for the single clip pass of K3
        check(rel <= 1e-5, f"{name}: kernel vs plain relative error {rel}")
        tol = 0 if exact_counts else max(2, int(1e-6 * n * p))
        check(abs(counts_k[0] - counts_p[0]) <= tol and abs(counts_k[1] - counts_p[1]) <= tol,
              f"{name}: clip totals {counts_k} vs {counts_p}")
        check((counts_k[0] + counts_k[1] > 0) == clips, f"{name}: clip totals {counts_k}")
        src, replaces = KERNELS[kernel]
        rows.append({"name": name, "kernel": kernel, "route": "cuda", "source": src,
                     "replaces": replaces, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "shape": [n, p]})

    def clip_case(name, n, winsorize=False, weighted=False):
        frames = frames_with_outliers(gen, n, p, dev)
        w = (torch.rand((n,), generator=gen, device=dev) * 1.5 + 0.5) if weighted else None
        stack_case(name, "stack_clip", n,
                   lambda: stack_cuda.stack_sigma_cuda(frames, ref_loc, sig_lo, sig_hi, w,
                                                       winsorize),
                   lambda: stack_cuda.stack_sigma_plain(frames, ref_loc, sig_lo, sig_hi, w,
                                                        winsorize),
                   False, True)

    def linfit_case(name, n):
        frames = frames_with_outliers(gen, n, p, dev)
        stack_case(name, "stack_linfit", n,
                   lambda: stack_cuda.stack_linfit_cuda(frames, ref_loc, sig_lo, sig_hi),
                   lambda: stack_cuda.stack_linfit_plain(frames, ref_loc, sig_lo, sig_hi),
                   False, True)

    def single_pass_case(name, n, mad):
        frames = frames_with_outliers(gen, n, p, dev)
        stack_case(name, "stack_single_pass", n,
                   lambda: stack_cuda.stack_single_pass_cuda(frames, ref_loc, sig_lo, sig_hi,
                                                             mad),
                   lambda: stack_cuda.stack_single_pass_plain(frames, ref_loc, sig_lo,
                                                              sig_hi, mad),
                   True, mad)

    clip_case("stack_clip sigma", 8)
    clip_case("stack_clip winsorized", 16, winsorize=True)
    clip_case("stack_clip weighted sigma", 10, weighted=True)
    linfit_case("stack_linfit", 30)
    single_pass_case("stack_single_pass median", 16, False)
    single_pass_case("stack_single_pass mad", 30, True)
    torch.cuda.empty_cache()

    # K4 on a size^2 frame, K = 2048 candidates, r = 32 (65x65 windows)
    img = torch.randn((size, size), generator=gen, device=dev) * 20.0 + 900.0
    k = 2048
    cys = torch.randint(-40, size + 40, (k,), generator=gen, device=dev, dtype=torch.int32)
    cxs = torch.randint(-40, size + 40, (k,), generator=gen, device=dev, dtype=torch.int32)
    pk, ok_k = gather_cuda.gather_patches_cuda(img, cys, cxs, 32)
    pp, ok_p = gather_cuda.patches_plain(img, cys, cxs, 32)
    torch.cuda.synchronize()
    check(bool((ok_k == ok_p).all()), "gather_patches: in-frame masks differ")
    err = float(torch.where(ok_k, (pk - pp).abs(), torch.zeros((), device=dev)).max())
    ms = cuda_ms(lambda: gather_cuda.gather_patches_cuda(img, cys, cxs, 32))
    plain_ms = cuda_ms(lambda: gather_cuda.patches_plain(img, cys, cxs, 32))
    say(f"gather_patches: K={k} r=32 on {size}x{size} max_abs_err {err:.3g} (where ok) "
        f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms")
    check(err == 0.0, f"gather_patches: kernel vs plain error {err}")
    src, replaces = KERNELS["gather_patches"]
    rows.append({"name": "gather_patches", "kernel": "gather_patches", "route": "cuda",
                 "source": src, "replaces": replaces, "max_abs_err": err,
                 "ms": ms, "plain_ms": plain_ms, "shape": [k, 65, 65]})

    # K5 (column, tiled) and K6 (tiled over the block sizes) on the
    # microbenchmarks' (40, 2^21) input; exact sort and the same row-order
    # sum, so bit for bit
    x = microbench_layout.make_input(microbench_layout.P, 0, dev)
    ref = sortnet_cuda.sort_sum_plain(x)
    plain_ms = cuda_ms(lambda: sortnet_cuda.sort_sum_plain(x))
    cases = [("sort_sum column", "column", 256, SORT_REPLACES["column"]),
             ("sort_sum tiled", "tiled", 256, SORT_REPLACES["tiled"])]
    cases += [(f"sort_sum tiled tile={t}", "tiled", t, SORT_REPLACES["sweep"])
              for t in sortnet_cuda.BLOCK_SIZES]
    for name, layout, threads, replaces in cases:
        out = sortnet_cuda.sort_sum_cuda(x, layout, threads)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        ms = cuda_ms(lambda: sortnet_cuda.sort_sum_cuda(x, layout, threads))
        say(f"{name}: 40x{x.shape[1]} max_abs_err {err:.3g} kernel {ms:.4f} ms "
            f"plain {plain_ms:.3f} ms")
        check(torch.equal(out, ref), f"{name}: kernel differs from plain (max abs {err})")
        rows.append({"name": name, "kernel": "sort_sum", "route": "cuda", "source": SORT_SRC,
                     "replaces": replaces, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "shape": [40, int(x.shape[1])], "threads": threads})
    return rows


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


def check_output(fits_mod, name: str, size: int):
    img = fits_mod.read_file(name)
    data = img.to_numpy()
    check(data.shape == (size, size), f"{name}: shape {data.shape}")
    finite = float(np.isfinite(data).mean())
    check(finite > 0.99, f"{name}: only {finite:.4f} finite")
    return data


def small_gpu_vs_cpu(cli, fits_mod, fixtures, work: str, tag: str, flags) -> None:
    """The same small stack on the card (kernels) and on the CPU (plain
    versions, the path the CPU tests hold against the JAX package)."""
    import torch

    small = 512
    sdir = os.path.join(work, f"small_{tag}")
    fixtures.gen(sdir, 8, small, seed=11)
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

    rows = kernel_cases(opts.size, stack_cuda, gather_cuda, sortnet_cuda, microbench_layout)
    torch.cuda.empty_cache()

    size = opts.size
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="smoke-", dir=os.path.join(ROOT, "build"))
    cwd = os.getcwd()
    totals = {name: 0 for name in kernels.KERNEL_NAMES}
    walls = {}
    try:
        t0 = time.perf_counter()
        lights = [os.path.basename(p) for p in fixtures.gen(work, 30, size, seed=7)]
        say(f"fixtures: 30 lights + dark of {size}x{size} in {time.perf_counter() - t0:.1f} s")
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
            check_output(nlfits, out, size)
            os.remove(out)

        small_gpu_vs_cpu(cli, nlfits, fixtures, work, "defaults", ())
        small_gpu_vs_cpu(cli, nlfits, fixtures, work, "mad_lsEst1",
                         ("-stMode", "4", "-lsEst", "1"))
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

    for row in rows:
        row["launches"] = totals[row["kernel"]]
    say(json.dumps({"stack_walls_s": walls}))
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
