"""Smoke run of the PyTorch port's main path on one NVIDIA GPU.

    python3 chip_smoke.py            # full size: 4096x4096 frames, 30/16/8 lights
    python3 chip_smoke.py --size 1024  # a quicker pass at a smaller frame size

1. Prints torch/CUDA versions and the card's name and power limit.
2. Builds the CUDA kernels from nightlight_tpu_torch/csrc (nvcc, sm_90a).
3. Holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (K1 sigma 8 frames, K1 winsorized 16, K1 weighted
   sigma 10, K2 linear fit 30, all at size^2 pixels; K4 with K=2048, r=32),
   timing both with CUDA events (median of 5).
4. Writes BITPIX-16 fixtures (nightlight_tpu_torch/fixtures.py, the recipe
   of scripts/gen_fixtures.py): 30 lights and a master dark.
5. Runs the port's CLI `stack` with -dark on the first 30, 16 and 8 lights
   (auto mode: linear fit, winsorized, sigma clip) and checks the return
   code, the log's stacking mode, the output FITS and the kernel launch
   counts of each run; then holds a small GPU stack against the same stack
   run on the CPU through the plain versions.
6. Prints the kernel table as JSON, and as the last line
   {"ok": true, "device": {...}}. Any failure exits non-zero before it.

Exits non-zero without a result when no CUDA device is present. Logs of
the CLI runs go to chiprun_out/.
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

K1_SRC = "nightlight_tpu_torch/csrc/stack_clip.cu"
K2_SRC = "nightlight_tpu_torch/csrc/stack_linfit.cu"
K4_SRC = "nightlight_tpu_torch/csrc/gather_patches.cu"
K1_REPLACES = "nightlight_tpu/ops/stack_pallas.py:396"
K2_REPLACES = "nightlight_tpu/ops/stack_pallas.py:679"
K4_REPLACES = "nightlight_tpu/ops/gather_pallas.py:41"


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


def kernel_cases(size: int, stack_cuda, gather_cuda):
    """Each kernel against its plain version on the card. Returns rows for
    the kernel table."""
    import torch

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    p = size * size
    rows = []
    sig_lo, sig_hi, ref_loc = 2.5, 2.5, 0.0

    def clip_case(name, n, winsorize=False, weighted=False, linfit=False):
        frames = frames_with_outliers(gen, n, p, dev)
        w = (torch.rand((n,), generator=gen, device=dev) * 1.5 + 0.5) if weighted else None
        if linfit:
            run_k = lambda: stack_cuda.stack_linfit_cuda(frames, ref_loc, sig_lo, sig_hi)  # noqa: E731
            run_p = lambda: stack_cuda.stack_linfit_plain(frames, ref_loc, sig_lo, sig_hi)  # noqa: E731
        else:
            run_k = lambda: stack_cuda.stack_sigma_cuda(frames, ref_loc, sig_lo, sig_hi, w, winsorize)  # noqa: E731,E501
            run_p = lambda: stack_cuda.stack_sigma_plain(frames, ref_loc, sig_lo, sig_hi, w, winsorize)  # noqa: E731,E501
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
        # samples out of n*p
        check(rel <= 1e-5, f"{name}: kernel vs plain relative error {rel}")
        tol = max(2, int(1e-6 * n * p))
        check(abs(counts_k[0] - counts_p[0]) <= tol and abs(counts_k[1] - counts_p[1]) <= tol,
              f"{name}: clip totals {counts_k} vs {counts_p}")
        check(counts_k[0] + counts_k[1] > 0, f"{name}: nothing clipped")
        kernel = "stack_linfit" if linfit else "stack_clip"
        rows.append({"name": name, "kernel": kernel, "route": "cuda",
                     "source": K2_SRC if linfit else K1_SRC,
                     "replaces": K2_REPLACES if linfit else K1_REPLACES,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "shape": [n, p]})
        del frames

    clip_case("stack_clip sigma", 8)
    clip_case("stack_clip winsorized", 16, winsorize=True)
    clip_case("stack_clip weighted sigma", 10, weighted=True)
    clip_case("stack_linfit", 30, linfit=True)

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
    rows.append({"name": "gather_patches", "kernel": "gather_patches", "route": "cuda",
                 "source": K4_SRC, "replaces": K4_REPLACES, "max_abs_err": err,
                 "ms": ms, "plain_ms": plain_ms, "shape": [k, 65, 65]})
    return rows


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
    os.makedirs(LOG_DIR, exist_ok=True)
    with open(os.path.join(LOG_DIR, log_name), "w") as f:
        f.write(log)
    return rc, log, seconds


def check_output(fits_mod, name: str, size: int):
    img = fits_mod.read_file(name)
    data = img.to_numpy()
    check(data.shape == (size, size), f"{name}: shape {data.shape}")
    finite = float(np.isfinite(data).mean())
    check(finite > 0.99, f"{name}: only {finite:.4f} finite")
    return data


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
    from nightlight_tpu_torch.ops import gather_cuda, stack_cuda

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
        os.makedirs(LOG_DIR, exist_ok=True)
        with open(os.path.join(LOG_DIR, "ptxas.txt"), "w") as f:
            f.write(ptxas)

    rows = kernel_cases(opts.size, stack_cuda, gather_cuda)
    torch.cuda.empty_cache()

    size = opts.size
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="smoke-", dir=os.path.join(ROOT, "build"))
    cwd = os.getcwd()
    totals = {name: 0 for name in kernels.KERNEL_NAMES}
    try:
        t0 = time.perf_counter()
        lights = [os.path.basename(p) for p in fixtures.gen(work, 30, size, seed=7)]
        say(f"fixtures: 30 lights + dark of {size}x{size} in {time.perf_counter() - t0:.1f} s")
        os.chdir(work)
        expected = {30: (5, "stack_linfit"), 16: (3, "stack_clip"), 8: (2, "stack_clip")}
        for n, (mode, kernel) in expected.items():
            out = f"stack{n}.fits"
            kernels.reset_launch_counts()
            rc, log, seconds = run_cli(
                cli, ["-out", out, "-dark", "dark.fits", "-jpg", "", "-log", "",
                      "stack", *lights[:n]], f"chip_smoke_stack{n}.log")
            counts = kernels.launch_counts()
            for name, v in counts.items():
                totals[name] += v
            clipped = [ln for ln in log.splitlines() if ln.startswith(("Clipped", "Reached", "Warning"))]
            say(f"stack {n} lights: rc {rc} wall {seconds:.1f} s launches {counts} {clipped}")
            check(rc == 0, f"stack {n}: rc {rc}; log tail: {log[-2000:]}")
            check("Error:" not in log, f"stack {n}: error in log")
            check(f"Stacking {n} frames with stacking mode {mode} " in log,
                  f"stack {n}: expected stacking mode {mode}")
            check(counts[kernel] > 0, f"stack {n}: {kernel} never launched")
            check(counts["gather_patches"] > 0, f"stack {n}: gather_patches never launched")
            check_output(nlfits, out, size)

        # the same small stack on the card (kernels) and on the CPU (plain
        # versions, the path the CPU tests hold against the JAX package)
        small = 512
        sdir = os.path.join(work, "small")
        fixtures.gen(sdir, 8, small, seed=11)
        os.chdir(sdir)
        names = sorted(glob.glob("light*.fits"))
        args = ["-dark", "dark.fits", "-jpg", "", "-log", "", "-exportStats", "", "stack", *names]
        rc_g, log_g, _ = run_cli(cli, ["-out", "gpu.fits", *args], "chip_smoke_small_gpu.log")
        rc_c, log_c, _ = run_cli(cli, ["-out", "cpu.fits", *args], "chip_smoke_small_cpu.log",
                                 device=torch.device("cpu"))
        check(rc_g == 0 and rc_c == 0, f"small stack: rc gpu {rc_g} cpu {rc_c}")
        g = check_output(nlfits, "gpu.fits", small)
        c = check_output(nlfits, "cpu.fits", small)
        rel = np.abs(g - c) / np.maximum(np.abs(c), 1.0)
        off = float(np.mean(rel > 1e-4))
        clip_g = [ln for ln in log_g.splitlines() if ln.startswith("Clipped")]
        clip_c = [ln for ln in log_c.splitlines() if ln.startswith("Clipped")]
        say(f"small stack gpu vs cpu: median rel diff {float(np.median(rel)):.3g}, "
            f"max {float(rel.max()):.3g}, share above 1e-4 {off:.3g}; {clip_g} vs {clip_c}")
        # band: star centroids sum in another order on each device, which
        # moves transforms by ~1e-5 px and warped pixels near stars by
        # ~1e-5 relative; a pixel whose clip decision sits on the bound can
        # then flip and move by a few percent. So: the typical pixel agrees
        # to 1e-5, at most 0.1% of pixels move by more than 1e-4, none by
        # more than 10%.
        check(float(np.median(rel)) <= 1e-5 and off <= 1e-3 and float(rel.max()) <= 0.1,
              "small stack gpu vs cpu outside the band")
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)

    for row in rows:
        row["launches"] = totals[row["kernel"]]
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
