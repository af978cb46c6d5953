"""The port's device mesh over every NVIDIA card of one host: each kernel on
each card, the sharded stack and goal-seek over all cards, and the CLI's
``stack -shard``.

    python -m nightlight_tpu_torch.scripts.mesh_cards [--size 2048] [--lights 8]

Needs at least two cards (exits otherwise). Checks, each printed on a line
of its own:

1. every kernel (K1 sigma, K1 weighted winsorized, K2, K3 median and MAD,
   K4, K5 column and tiled) launched on each ``cuda:k`` with the inputs
   copied there, bit for bit the same call on ``cuda:0`` (the C entries
   take the device ordinal);
2. ``stack_sharded`` over a mesh of every card against ``stack`` on
   ``cuda:0`` (K1 winsorized on 16 frames, K2 on 30; size^2 pixels): bit
   for bit, equal clip counts, the walls of both (host clock around work
   that ends in a synchronisation of every card, median of 5);
3. ``find_sigmas_and_stack`` over the mesh of every card against the same
   search over as many shards on ``cuda:0``: equal sigmas, counts and
   image (the per-shard subsample is the same whatever card a shard is
   on);
4. the CLI: ``stack -shard`` (defaults, a dark) on fixture lights prints
   "Sharding frames over N devices" (each frame row-sharded over the cards
   from its load, the per-frame operators on each card's rows) and
   equals, bit for bit, the `stack` preset run through ``run_op`` with a
   mesh of N shards on ``cuda:0`` and the same job unsharded on the
   per-frame path (the fused executor found ineligible); its wall, its
   star detection's wall (each card synchronised around every detection)
   and each card's peak memory beside the run without ``-shard`` and the
   unsharded per-frame run, each timed after one unmeasured run of its
   own.

The last line is one JSON object of the measured walls and the card's name.
"""

from __future__ import annotations

import argparse
import contextlib
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
import torch

from nightlight_tpu_torch import kernels
from nightlight_tpu_torch.ops import gather_cuda, sortnet_cuda, stack_cuda
from nightlight_tpu_torch.ops import stack as stk
from nightlight_tpu_torch.parallel import mesh as pmesh


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().replace("\n", " | ")


def card(k: int) -> torch.device:
    return torch.device("cuda", k)


def synced(fn):
    """fn() with every card synchronised after it; (result, seconds)."""
    t0 = time.perf_counter()
    out = fn()
    for k in range(torch.cuda.device_count()):
        torch.cuda.synchronize(k)
    return out, time.perf_counter() - t0


def median_wall(fn, reps: int = 5) -> float:
    synced(fn)  # warm-up
    return statistics.median(synced(fn)[1] for _ in range(reps))


def sky(gen, n: int, p: int, device) -> torch.Tensor:
    """(n, p) sky samples about 1000, 5% bright outliers, 5% NaN."""
    f = torch.randn((n, p), generator=gen, device=device) * 10.0 + 1000.0
    u = torch.rand((n, p), generator=gen, device=device)
    f = torch.where(u < 0.05, f + 2000.0, f)
    return torch.where((u > 0.5) & (u < 0.55), torch.full((), float("nan"), device=device), f)


def bits_equal(a, b) -> bool:
    a, b = pmesh.gather(a).cpu(), pmesh.gather(b).cpu()
    return bool(torch.equal(torch.nan_to_num(a, nan=-7.0), torch.nan_to_num(b, nan=-7.0))
                and torch.equal(a.isnan(), b.isnan()))


def kernels_on_each_card(size: int, failures: list) -> None:
    cards = torch.cuda.device_count()
    dev0 = card(0)
    gen = torch.Generator(device=dev0).manual_seed(7)
    p = size * size
    f8, f16, f30 = sky(gen, 8, p, dev0), sky(gen, 16, p, dev0), sky(gen, 30, p, dev0)
    w16 = torch.linspace(0.5, 1.5, 16, device=dev0)
    img = torch.randn((size, size), generator=gen, device=dev0) * 5.0 + 100.0
    cys = torch.randint(-40, size + 40, (2048,), generator=gen, device=dev0, dtype=torch.int32)
    cxs = torch.randint(-40, size + 40, (2048,), generator=gen, device=dev0, dtype=torch.int32)
    x40 = torch.rand((40, 1 << 21), generator=gen, device=dev0)
    calls = {
        "K1 sigma 8": lambda d: stack_cuda.stack_sigma_cuda(f8.to(d), 0.0, 2.5, 2.5),
        "K1 weighted winsorized 16": lambda d: stack_cuda.stack_sigma_cuda(
            f16.to(d), 0.0, 2.5, 2.5, weights=w16.to(d), winsorize=True),
        "K2 linear fit 30": lambda d: stack_cuda.stack_linfit_cuda(f30.to(d), 0.0, 2.5, 2.5),
        "K3 median 16": lambda d: stack_cuda.stack_single_pass_cuda(f16.to(d), 0.0),
        "K3 MAD 30": lambda d: stack_cuda.stack_single_pass_cuda(f30.to(d), 0.0, 2.5, 2.5,
                                                                 mad=True),
        "K4 gather 2048 r32": lambda d: gather_cuda.gather_patches_cuda(
            img.to(d), cys.to(d), cxs.to(d), 32),
        "K5 column": lambda d: (sortnet_cuda.sort_sum_cuda(x40.to(d), "column"),),
        "K5 tiled bulk_ring": lambda d: (sortnet_cuda.sort_sum_cuda(x40.to(d), "tiled"),),
    }
    for name, call in calls.items():
        want = call(dev0)
        for k in range(1, cards):
            got = call(card(k))
            torch.cuda.synchronize(k)
            same = all(bits_equal(g, w) for g, w in zip(got, want))
            say(f"{name} on cuda:{k}: bit for bit cuda:0 {same}")
            if not same:
                failures.append(f"{name} on cuda:{k}")


def sharded_stacks(size: int, failures: list, walls: dict) -> None:
    cards = torch.cuda.device_count()
    dev0 = card(0)
    mesh = pmesh.make_mesh()
    gen = torch.Generator(device=dev0).manual_seed(9)
    for name, n, mode in (("winsorized 16", 16, stk.StackMode.WinsorSigma),
                          ("linear fit 30", 30, stk.StackMode.LinearFit)):
        cube = sky(gen, n, size * size, dev0).reshape(n, size, size)
        placed = pmesh.shard_rows(mesh, cube)
        kernels.reset_launch_counts()
        want, _ = synced(lambda: stk.stack(cube, mode))
        got, _ = synced(lambda: stk.stack_sharded(placed, mesh, mode))
        launches = kernels.launch_counts()
        same = bits_equal(got[0], want[0]) and (int(got[1]), int(got[2])) == (int(want[1]),
                                                                             int(want[2]))
        t_one = median_wall(lambda: stk.stack(cube, mode))
        t_mesh = median_wall(lambda: stk.stack_sharded(placed, mesh, mode))
        walls[f"stack {name}"] = t_one
        walls[f"stack_sharded {name} over {cards} cards"] = t_mesh
        say(f"stack_sharded {name} over {cards} cards vs stack on cuda:0: bit for bit and "
            f"equal counts {same} ({int(got[1])}, {int(got[2])}); launches {launches}; walls "
            f"{t_mesh * 1e3:.3f} ms against {t_one * 1e3:.3f} ms (blocks already placed)")
        if not same:
            failures.append(f"stack_sharded {name}")
        del cube, placed
    cube = sky(gen, 16, size * size, dev0).reshape(16, size, size)
    on_cards = pmesh.shard_rows(mesh, cube)
    one_card = pmesh.make_mesh([dev0] * cards)
    from nightlight_tpu_torch.ops.findsigma import find_sigmas_and_stack

    a = find_sigmas_and_stack(on_cards, stk.StackMode.WinsorSigma, mesh=mesh)
    b = find_sigmas_and_stack(cube, stk.StackMode.WinsorSigma, mesh=one_card)
    same = bits_equal(a[0], b[0]) and a[1:] == b[1:]
    say(f"sharded goal-seek over {cards} cards vs {cards} shards on cuda:0: equal {same} "
        f"(sigmas {a[3]:.3f} {a[4]:.3f}, counts {a[1]} {a[2]})")
    if not same:
        failures.append("sharded goal-seek")


def peaks_gib(cards: int) -> list:
    """Each card's peak allocated memory since the last reset, GiB."""
    return [round(torch.cuda.max_memory_allocated(k) / (1 << 30), 3) for k in range(cards)]


def reset_peaks(cards: int) -> None:
    for k in range(cards):
        torch.cuda.reset_peak_memory_stats(k)


@contextlib.contextmanager
def detection_timed(seconds: dict, key: str):
    """Add the wall of every star detection (detect/stars.py find_stars,
    find_stars_batch, find_stars_sharded), each card synchronised before
    and after, to seconds[key]."""
    from nightlight_tpu_torch.detect import stars

    names = ("find_stars", "find_stars_batch", "find_stars_sharded")
    originals = [getattr(stars, name) for name in names]
    # every module of the port that holds one of them by name
    holders = [(m, attr, v) for m in list(sys.modules.values())
               if getattr(m, "__name__", "").startswith("nightlight_tpu_torch")
               for attr, v in list(vars(m).items())
               if any(v is fn for fn in originals)]
    depth = [0]

    def timed(fn):
        def run(*args, **kwargs):
            if depth[0]:  # nested in a timed detection
                return fn(*args, **kwargs)
            depth[0] += 1
            try:
                out, spent = synced(lambda: fn(*args, **kwargs))
            finally:
                depth[0] -= 1
            seconds[key] = seconds.get(key, 0.0) + spent
            return out
        return run

    for m, attr, fn in holders:
        setattr(m, attr, timed(fn))
    try:
        yield
    finally:
        for m, attr, fn in holders:
            setattr(m, attr, fn)


def cli_over_cards(size: int, lights_n: int, failures: list, walls: dict, peaks: dict) -> None:
    from nightlight_tpu_torch import cli, fixtures
    from nightlight_tpu_torch.io import fits
    from nightlight_tpu_torch.models import fastpath
    from nightlight_tpu_torch.models.presets import build_command_seq
    from nightlight_tpu_torch.pipeline.context import new_context

    cards = torch.cuda.device_count()
    root = os.path.join(os.path.dirname(__file__), "..", "..", "build")
    os.makedirs(root, exist_ok=True)
    work = tempfile.mkdtemp(prefix="mesh-cards-", dir=root)
    cwd = os.getcwd()
    try:
        lights = [os.path.basename(p) for p in fixtures.gen(work, lights_n, size, seed=7)]
        os.chdir(work)
        base = ["-dark", "dark.fits", "-jpg", "", "-log", ""]
        logs = {}
        for name, flags in (("plain", ()), ("shard", ("-shard",))):
            # one unmeasured run first: each card loads the kernels it runs
            # at their first launch
            with contextlib.redirect_stdout(io.StringIO()):
                cli.main(["-out", f"{name}.fits", *base, *flags, "stack", *lights])
            buf = io.StringIO()
            reset_peaks(cards)
            with contextlib.redirect_stdout(buf), detection_timed(walls,
                                                                  f"detection {name}"):
                rc, seconds = synced(lambda: cli.main(["-out", f"{name}.fits", *base, *flags,
                                                       "stack", *lights]))
            logs[name] = buf.getvalue()
            walls[f"cli stack {name}"] = seconds
            peaks[f"cli stack {name}"] = peaks_gib(cards)
            if rc != 0:
                failures.append(f"cli {name}: rc {rc}")

        def preset(out, mesh):
            args = cli.build_parser().parse_args(["-out", out, *base, "stack", *lights])
            cli.apply_command_defaults(args)
            c = new_context(log=io.StringIO(), device=card(0))
            c.mesh = mesh
            with fastpath.per_frame_path(mesh is None):
                cli.run_op(build_command_seq(args), c)

        preset("one_card.fits", pmesh.make_mesh([card(0)] * cards))
        preset("per_frame.fits", None)  # unmeasured, as above
        reset_peaks(cards)
        with detection_timed(walls, "detection per-frame unsharded"):
            _, walls["per-frame unsharded"] = synced(lambda: preset("per_frame.fits", None))
        peaks["per-frame unsharded"] = peaks_gib(cards)
        shard, one, per_frame, plain = (
            fits.read_file(f).to_numpy()
            for f in ("shard.fits", "one_card.fits", "per_frame.fits", "plain.fits"))
        line = f"Sharding frames over {cards} devices"
        same = bool(np.array_equal(shard, one, equal_nan=True))
        same_pf = bool(np.array_equal(shard, per_frame, equal_nan=True))
        apart = float(np.mean(~((shard == plain) | (np.isnan(shard) & np.isnan(plain)))))
        say(f"cli stack -shard over {cards} cards ({lights_n} lights of {size}^2): "
            f"'{line}' {line in logs['shard'].splitlines()}, bit for bit the mesh of {cards} "
            f"shards on cuda:0 {same}, bit for bit the unsharded per-frame run {same_pf}, "
            f"share of pixels apart from the (fused) run without -shard {apart:.6f}; walls "
            f"{walls['cli stack shard']:.3f} s against {walls['cli stack plain']:.3f} s "
            f"(per-frame unsharded {walls['per-frame unsharded']:.3f} s); detection "
            f"{walls['detection shard']:.3f} s against {walls['detection plain']:.3f} s "
            f"(per-frame unsharded {walls['detection per-frame unsharded']:.3f} s); peak GiB "
            f"per card {peaks['cli stack shard']} against {peaks['cli stack plain']} "
            f"(per-frame {peaks['per-frame unsharded']})")
        if line not in logs["shard"].splitlines() or not same or not same_pf:
            failures.append("cli -shard")
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=2048, help="frame edge in pixels")
    ap.add_argument("--lights", type=int, default=8, help="lights of the CLI check")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mesh_cards: no CUDA device is present")
    if torch.cuda.device_count() < 2:
        raise SystemExit("mesh_cards needs at least two CUDA devices")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    say(card_line())
    kernels.library()
    failures, walls, peaks = [], {}, {}
    kernels_on_each_card(opts.size, failures)
    sharded_stacks(opts.size, failures, walls)
    cli_over_cards(opts.size, opts.lights, failures, walls, peaks)
    say(json.dumps({"walls_s": walls, "peak_gib_per_card": peaks,
                    "cards": torch.cuda.device_count(),
                    "kind": torch.cuda.get_device_name(0), "failures": failures}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
