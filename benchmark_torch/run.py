"""The benchmark of the PyTorch and CUDA port (nightlight_tpu_torch): one run
of one cell of BENCHMARK.json.

    python3 -m benchmark_torch.run --workload mono16.n100 --seed 7 --seconds 30 --trace 0

A run, from the root of a checkout: set-up (the port's import, the CUDA
context, the kernel library, which builds into the checkout's build/ on a
checkout's first run, the cell's lights and masters made on the card from
the seed and written as FITS to a temporary directory outside the
checkout, one warm-up job), then a closed loop of whole jobs with one
client, back to back, until the first job that ends after --seconds. With
--trace 1 the window's jobs run with the phase clock on (phases.py) and
whole jobs after it under the profiler (profile.py). Then the program's
state is freed and the stacked FITS of the window's first job, of a few
jobs drawn from the seed and of its last job are compared with the plain
reference (reference.py, compare.py); every other job's files are deleted
as the next job ends. Where a job runs several stacks (one a colour
channel), one of them, drawn from the seed, is compared. The last line of standard
output is one JSON object: correct, attempted, failed, the cell's metrics
(end-to-end with --trace 0, per-layer with --trace 1), the device and, with
--trace 1, the breakdown; the numbers compared, each with its limit, come
last there and as the last lines of standard error.

--control also computes the control, the reference in bfloat16, and
reports its numbers beside the program's; --fault plants a fault (faults.py)
under the timed path; --log keeps a copy of the program's log. None is part
of a benchmark run.

A cell runs on exactly its cards, cuda:0 .. cuda:chips-1 (cards.py): main
hides the others before CUDA starts, so the port's -shard meshes those
alone. Every synchronisation waits for each of them, since a sharded job
leaves work queued on every card. The device's peak (peak_mem_gib) is the
largest of the cards' peaks, each reset after the inputs are made: the
fullest card sets how large a night fits, where a sum would count the
shards' blocks as one card's; each card's is in memory_peak_bytes_by_card.
busy_s is the mean of the cards' busy seconds (profile.py), so device.idle
is the mean of the cards' idle shares, how long a card waits; each card's
is in busy_s_by_card. With one card every number is the one-card reading.

Without a CUDA card, or with fewer cards than the cell asks for, it exits
with code 2 and prints no result; with JAX or the JAX package loaded once
the window has closed, with code 3 and no result.
"""

from __future__ import annotations

import time

T_IMPORT = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import glob  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
KEPT_JOBS = 4  # window jobs whose stacked FITS are compared, besides the last


def process_start() -> float:
    """The wall-clock time this process started (Linux /proc), else the
    time this module was imported."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return T_IMPORT


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT):
    """(BENCHMARK.json, the workload entry, its configuration file, its
    traffic file)."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return (bench, cell, load_json(root / config["file"]),
            load_json(HERE / "traffic" / f"{cell['traffic']}.json"))


def load_metric(name: str):
    """The reader module metrics/<name>.py."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_torch.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_of(traffic: dict):
    """The plain reference that a traffic file names ("reference":
    "<module>.<function>" under benchmark_torch; reference.stack_job by
    default), so that a traffic mix with other semantics brings its own."""
    module, name = traffic.get("reference", "reference.stack_job").rsplit(".", 1)
    return getattr(importlib.import_module(f"benchmark_torch.{module}"), name)


def cell_metrics(bench: dict, cell: dict, kind: str) -> list:
    """The metric entries of `kind` ("end_to_end", "per_layer") that this
    cell reports."""
    return [m for m in bench[kind] if "workloads" not in m or cell["name"] in m["workloads"]]


def set_cache_dirs(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")


def visible_cards(chips: int, env: str | None) -> str:
    """The CUDA_VISIBLE_DEVICES that shows a cell of `chips` cards exactly
    its own: the first `chips` entries of the list already set (`env`), in
    its order, or cards 0 .. chips-1 where none is set. A host with fewer
    cards leaves fewer visible, and main refuses the run."""
    if env is None:
        return ",".join(str(k) for k in range(chips))
    return ",".join(e.strip() for e in env.split(",")[:chips])


FORBIDDEN = ("jax", "jaxlib", "flax", "nightlight_tpu")


def forbidden_modules(modules) -> list:
    """The loaded modules whose top-level name, whole, is JAX's, Flax's or
    the JAX package's (nightlight_tpu_torch is the port, not the JAX
    package)."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def run_cell(bench, cell, config, traffic, seed: int, seconds: float, trace: bool,
             device="cuda:0", t_start: float | None = None, control: bool = False,
             fault: str | None = None, generator: dict | None = None,
             keep_log: str | None = None) -> dict:
    """One run of the cell; returns the result object. The traffic's
    "generator" overrides keys of the configuration's generator (how the
    lights vary: the order of seeings, dithers and rotations, the
    trails), and `generator` overrides both (the tests' small sizes).
    `keep_log` is a file the program's log is copied to at the end."""
    import torch

    from benchmark_torch import cards, compare, faults, gen, jobs, phases, profile, reference

    t_start = process_start() if t_start is None else t_start
    set_cache_dirs(ROOT)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    cell_cards = cards.of_cell(cell["chips"]) if on_card else []
    from nightlight_tpu_torch import kernels

    if on_card:
        torch.cuda.set_device(dev)
        kernels.library()
    params = {**config["generator"], **traffic.get("generator", {}), **(generator or {})}
    per_layer = [(m, load_metric(m["name"])) for m in cell_metrics(bench, cell, "per_layer")]
    all_metrics = [load_metric(m["name"]) for m in bench["per_layer"]]
    targets = phases.phase_targets(all_metrics)
    work = tempfile.mkdtemp(prefix="nightlight-bench-")
    cwd = os.getcwd()
    log = open(os.path.join(work, "program.log"), "w")
    runner = None
    result = {}
    try:
        inputs = gen.generate(params, int(traffic["lights"]), seed, work, dev)
        os.chdir(work)
        cards.synchronize(cell_cards)
        cards.reset_peaks(cell_cards)
        gc.collect()
        with faults.planted(fault):
            runner = jobs.make_jobs(traffic, dev, log)
            t0 = time.perf_counter()
            first_ok = runner.run(0)
            cards.synchronize(cell_cards)
            first_job_s = time.perf_counter() - t0
            if not first_ok:
                raise RuntimeError(f"the warm-up job failed; the program's log ends:\n"
                                   f"{_tail(log)}")
            setup_s = time.time() - t_start
            clock = phases.PhaseClock(targets, cards=cell_cards) if trace else None
            spans = []
            sample = random.Random(seed)
            kept = set()

            def job(k: int) -> bool:
                if clock:
                    clock.start_job()
                j0 = time.perf_counter()
                ok = runner.run(k)
                cards.synchronize(cell_cards)
                if clock:
                    spans.append((j0, time.perf_counter(), clock.first_entry, clock.last_exit))
                # what is compared: the first job, a sample drawn from the
                # seed and the last; the rest is deleted before the page
                # cache writes it back, so a run writes little to disk
                if k == 1 or (len(kept) < KEPT_JOBS and sample.random() < 0.2):
                    kept.add(k)
                discard(k, keep_fits=True)
                if k - 1 not in kept:
                    discard(k - 1, keep_fits=False)
                return ok

            counts0 = kernels.launch_counts()
            with phases.phases_wrapped(clock, targets) if trace else contextlib.nullcontext():
                rows, window_s = closed_loop(job, seconds)
            kept.add(len(rows))
            done = [k for k, ok in rows if ok and k in kept]
            attempted, failed = len(rows), sum(not ok for _, ok in rows)
            k = len(rows) + 1
            counts1 = kernels.launch_counts()
            peaks = cards.peaks(cell_cards) if on_card else [0]
            peak = max(peaks)
            traced = None
            if trace:
                if on_card:
                    print(f"card: {card_line()}", flush=True)
                traced = profile.profile_jobs(lambda: runner.run(k), targets,
                                              min(2.0, seconds), cell_cards) if on_card else None
        runner.close()
        runner = None
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        # the reference of one run of the job (of several, one drawn from
        # the seed), against that run's output in each kept job
        recipes = [r["recipe"] for r in traffic["runs"]] if "runs" in traffic else [
            traffic["recipe"]]
        j = random.Random(seed + 1).randrange(len(recipes))
        stack_ref = reference_of(traffic)
        ref_img, scale = stack_ref(inputs, recipes[j], dev)
        rows = [compare.numbers(reference.read_fits(jobs.outputs(traffic, k_out)[j], dev),
                                ref_img, scale) for k_out in done]
        values = compare.worst(rows) if rows else {n: float("inf") for n in compare.NAMES}
        correct, check = compare.verdict(values, traffic["limits"])
        correct = correct and failed == 0 and bool(rows)
        if control:
            low = stack_ref(inputs, recipes[j], dev, "bfloat16")[0]
            result["control"] = compare.numbers(low, ref_img, scale)
        del ref_img
        metrics = {}
        if trace:
            rec = {"jobs": attempted, "wall_s": window_s, "phases_s": clock.seconds,
                   "first_job_s": first_job_s,
                   "entries": clock.entries, "spans": spans,
                   "launches": {n: counts1[n] - counts0[n] for n in counts1}}
            if traced:
                rec.update(busy_s=traced["busy_s"], window_s=traced["window_s"],
                           kernels=traced["kernels"])
            for entry, mod in per_layer:
                value = mod.read(rec)
                if value is not None:
                    metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
        else:
            e2e = {"job_s": window_s / attempted, "peak_mem_gib": peak / (1 << 30),
                   "setup_s": setup_s}
            for entry in cell_metrics(bench, cell, "end_to_end"):
                metrics[entry["name"]] = {"value": e2e[entry["name"]], "unit": entry["unit"]}
        result.update({"correct": correct, "attempted": attempted, "failed": failed,
                       "metrics": metrics,
                       "device": {"platform": "gpu" if on_card else dev.type,
                                  "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                                  "count": len(cell_cards) if on_card else 1,
                                  "memory_peak_bytes": int(peak),
                                  "memory_peak_bytes_by_card": peaks}})
        if traced:
            result["device"].update(busy_s=traced["busy_s"], window_s=traced["window_s"],
                                    busy_s_by_card=traced["busy_s_by_card"])
            result["breakdown"] = traced["breakdown"]
        result["check"] = check
        return result
    finally:
        if runner is not None:
            runner.close()
        log.close()
        if keep_log:
            shutil.copyfile(log.name, keep_log)
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)


def discard(k: int, keep_fits: bool) -> None:
    """Delete job k's files in the working directory (but its stacked FITS
    when keep_fits)."""
    for path in glob.glob(f"job{k:04d}_*"):
        if not (keep_fits and path.endswith(".fits")):
            os.remove(path)


def closed_loop(job, seconds: float):
    """Whole jobs back to back, one client, until the first that ends after
    `seconds`: ([(job number, ok)], the window's seconds)."""
    rows = []
    w0 = time.perf_counter()
    while True:
        ok = job(len(rows) + 1)
        end = time.perf_counter()
        rows.append((len(rows) + 1, ok))
        if end - w0 >= seconds:
            return rows, end - w0


def _tail(log) -> str:
    log.flush()
    with open(log.name) as f:
        return f.read()[-2000:]


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description="One run of one cell of BENCHMARK.json.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="also compute the bfloat16 control and report its numbers")
    ap.add_argument("--fault", choices=("half", "altered", "exchange"), default=None,
                    help="plant a fault under the timed path")
    ap.add_argument("--log", default=None, help="copy the program's log to this file")
    a = ap.parse_args(argv)
    bench, cell, config, traffic = load_cell(a.workload)
    # before CUDA starts, so that neither the harness nor the program's mesh
    # sees a card the cell did not ask for
    os.environ["CUDA_VISIBLE_DEVICES"] = visible_cards(int(cell["chips"]),
                                                       os.environ.get("CUDA_VISIBLE_DEVICES"))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"benchmark: cell {a.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = run_cell(bench, cell, config, traffic, a.seed, a.seconds, bool(a.trace),
                      t_start=t_start, control=a.control, fault=a.fault,
                      keep_log=a.log and os.path.abspath(a.log))
    loaded = forbidden_modules(list(sys.modules))
    if loaded:
        print(f"benchmark: the run loaded {', '.join(loaded)}; the port's benchmark "
              f"may load neither JAX nor the JAX package", file=sys.stderr)
        return 3
    if "control" in result:
        print("control " + " ".join(f"{k} {v}" for k, v in result["control"].items()),
              file=sys.stderr)
    for name, c in result["check"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    # the numbers compared come last in the line too
    result["check"] = result.pop("check")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
