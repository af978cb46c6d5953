"""CPU tests of the readers of the program's own spans and counters
(benchmark_torch/spans.py and the span.*, host.* and detect.candidates
metrics): exact values from a span tree made by hand, and a CLI job
recorded on the CPU whose layers and rest add up to its wall.

    python -m pytest benchmark_torch/tests -q
"""

from __future__ import annotations

import contextlib
import json
from pathlib import Path

import pytest

from benchmark_torch import gen, jobs, run, spans
from nightlight_tpu_torch import trace

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = ["span.load_s", "span.preprocess_s", "span.perframe_s", "span.detect_s", "span.align_s",
       "span.warp_s", "span.stack_s", "span.save_s", "span.rest_s", "span.request_s",
       "host.reads", "host.read_wait_s", "detect.candidates"]
MS = 1_000_000


def _span(name, start, end, id_, parent, thread=1, command=1):
    return trace.Span(name, start * MS, end * MS, id_, parent, thread,
                      "handler" if thread == 1 else "read-ahead-0", command)


# a served request: the request, its job's command, layers with sub-spans
# and reads, and a read-ahead worker's read (no parent); milliseconds
TREE = [
    _span("load.wait", 12, 18, 4, 3),
    _span("load", 10, 20, 3, 2),
    _span("host_read", 32, 34, 7, 6),
    _span("detect", 30, 40, 6, 5),
    _span("preprocess", 20, 50, 5, 2),
    _span("host_read", 50, 52, 8, 2),
    _span("host_read", 61, 69, 11, 10),
    _span("save.fetch", 60, 70, 10, 9),
    _span("save", 60, 80, 9, 2),
    _span("command", 10, 90, 2, 1),
    _span("request", 0, 100, 1, None),
    _span("host_read", 13, 14, 13, 12, thread=2),
    _span("load.read", 5, 15, 12, None, thread=2),
]
EXPECTED = {"span.load_s": 0.010, "span.preprocess_s": 0.020, "span.detect_s": 0.010,
            "span.save_s": 0.020, "span.rest_s": 0.020, "span.request_s": 0.020,
            "span.perframe_s": None, "span.align_s": None, "span.warp_s": None,
            "span.stack_s": None, "host.reads": 3.0, "host.read_wait_s": 0.012,
            "detect.candidates": 137.0}
PROFILED = {"window_s": 1.0, "busy_s": 0.5}


@pytest.fixture
def tree(monkeypatch):
    monkeypatch.setattr(trace, "records", lambda: list(TREE))
    monkeypatch.setattr(trace, "commands_issued", lambda: 3)
    monkeypatch.setattr(trace, "counters",
                        lambda: {"detect.candidates": {"": 3 * 137}, "host.reads": {"x": 9}})
    yield


def test_the_new_metrics_have_readers_and_entries():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for name in NEW:
        assert entries[name]["moves"] == "job_s" and entries[name]["workloads"], name
        assert not hasattr(run.load_metric(name), "WRAPS"), name  # no phase clock


@pytest.mark.parametrize("name", NEW)
def test_readers_on_a_span_tree(tree, name):
    value = run.load_metric(name).read(dict(PROFILED))
    expected = EXPECTED[name]
    assert value == (None if expected is None else pytest.approx(expected)), name


def test_the_tree_adds_up(tree):
    s = spans.summary(dict(PROFILED))
    assert s["commands"] == 1 and s["wall_s"] == pytest.approx(0.1)
    assert s["covered_s"] == pytest.approx(s["wall_s"])
    assert s["reads_by_layer"] == {"detect": 1, "command": 1, "save": 1}


@pytest.mark.parametrize("name", NEW)
def test_readers_say_nothing_without_profiled_jobs_or_a_tracer(tree, monkeypatch, name):
    assert run.load_metric(name).read({"jobs": 1}) is None
    monkeypatch.setattr(spans, "tracer", lambda: None)
    assert run.load_metric(name).read(dict(PROFILED)) is None


def test_a_recorded_cli_job_adds_up(tmp_path, monkeypatch):
    """Two jobs of mono16.n10 at 512 x 512 run through the CLI with the
    program's recording on: every layer of the fused path reports, and the
    layers and the rest sum to the commands' wall."""
    _, entry, config, traffic = run.load_cell("mono16.n10", ROOT)
    params = {**config["generator"], "width": 512, "height": 512, "stars": 150}
    gen.generate(params, 5, 2**31 + 5, str(tmp_path), "cpu")
    monkeypatch.chdir(tmp_path)
    trace.clear()
    runner = jobs.make_jobs(traffic, "cpu", open(tmp_path / "log.txt", "w"))
    try:
        with trace.recording(), contextlib.redirect_stdout(None):
            assert runner.run(1) and runner.run(2)
    finally:
        runner.close()
    s = spans.summary(dict(PROFILED))
    assert s["commands"] == 2 and s["request_s"] is None
    assert {"load", "preprocess", "detect", "align", "warp", "stack", "save"} <= set(
        s["layers_s"])
    assert all(v > 0 for v in s["layers_s"].values())
    assert s["covered_s"] == pytest.approx(s["wall_s"], rel=1e-9)
    assert sum(s["layers_s"].values()) + s["rest_s"] == pytest.approx(s["wall_s"] / 2)
    for name in ("span.load_s", "span.detect_s", "span.save_s", "span.rest_s"):
        assert run.load_metric(name).read(dict(PROFILED)) > 0, name
    trace.clear()
