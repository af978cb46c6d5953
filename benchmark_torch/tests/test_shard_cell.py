"""CPU tests of the four-card cell shard4.mono61.n100 and its readers of the
program's mesh and plan counters (stack.batches, mesh.gathers,
mesh.bytes).

    python -m pytest benchmark_torch/tests -q

The cell's job runs here at 768 x 512 (rows that divide by four) on a mesh
of four CPU shards that stands in for the four cards; the times say
nothing of the card.
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from benchmark_torch import phases, run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "shard4.mono61.n100"
COUNTERS = ("stack.batches", "mesh.gathers", "mesh.bytes")
# 150 stars a 512 x 512 frame, as the harness's other CPU runs
SMALL = {"width": 768, "height": 512, "stars": 225}
PROFILED = {"window_s": 1.0, "busy_s": 0.5}


def test_the_cell_and_its_configuration():
    bench, entry, config, traffic = run.load_cell(CELL, ROOT)
    assert entry["chips"] == 4 and entry["config"] == "mono61mp"
    g = config["generator"]
    assert (g["width"], g["height"], g["stars"], g["rotation_deg"]) == (9576, 6388, 3650, 0.005)
    base = json.loads((ROOT / "benchmark_torch/configs/mono16mp.json").read_text())["generator"]
    assert {k: v for k, v in g.items() if base[k] != v} == {
        "width": 9576, "height": 6388, "stars": 3650, "rotation_deg": 0.005}
    n100 = json.loads((ROOT / "benchmark_torch/traffic/mono16.n100.json").read_text())
    assert traffic["lights"] == 100 and traffic["limits"] == n100["limits"]
    assert traffic["runs"] == [dict(n100["runs"][0], argv=["-shard", *n100["runs"][0]["argv"]])]


@pytest.mark.parametrize("name", COUNTERS)
def test_new_readers_are_counters_with_no_phase(name):
    mod = run.load_metric(name)
    assert not hasattr(mod, "PHASE") and not hasattr(mod, "WRAPS")
    entry = next(m for m in BENCH["per_layer"] if m["name"] == name)
    assert entry["source"] == "program_counter" and entry["workloads"] == [CELL]


@pytest.fixture
def tracer(monkeypatch):
    from nightlight_tpu_torch import trace

    monkeypatch.setattr(trace, "commands_issued", lambda: 4)
    monkeypatch.setattr(trace, "counters", lambda: {
        "stack.batches": {"mesh": 4}, "mesh.gathers": {"save.fits": 4, "save.jpeg": 4},
        "mesh.bytes": {"save.fits": 4000, "halo": 800, "rows": 200}})
    return trace


@pytest.mark.parametrize("name,expected", [("stack.batches", 1.0), ("mesh.gathers", 2.0),
                                           ("mesh.bytes", 1250.0)])
def test_new_readers_on_hand_made_counters(tracer, name, expected):
    assert run.load_metric(name).read(dict(PROFILED)) == pytest.approx(expected)


@pytest.mark.parametrize("name", COUNTERS)
def test_new_readers_say_nothing_where_the_counter_is_absent(tracer, monkeypatch, name):
    monkeypatch.setattr(tracer, "counters", lambda: {"host.reads": {"x": 9}})
    assert run.load_metric(name).read(dict(PROFILED)) is None
    assert run.load_metric(name).read({"jobs": 1}) is None


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_wrapped_target_resolves(metric):
    """A traced run of any cell patches every metric's WRAPS targets: each
    has to be there, or every traced run fails."""
    mod = run.load_metric(metric)
    for target in phases.phase_targets([mod]).get(getattr(mod, "PHASE", None), []):
        owner, name, _ = phases._resolve(*target)
        assert callable(getattr(owner, name)), target


def _run(monkeypatch, tmp_path, **kw):
    from nightlight_tpu_torch import cli
    from nightlight_tpu_torch.parallel import mesh

    m = mesh.make_mesh([torch.device("cpu")] * 4)
    monkeypatch.setattr(cli, "shard_mesh", lambda device, log: m)
    bench, entry, config, traffic = run.load_cell(CELL, ROOT)
    traffic = dict(traffic, lights=8)
    log = tmp_path / "program.log"
    res = run.run_cell(bench, entry, config, traffic, 2**31 + 61, 0.1, False, device="cpu",
                       generator=SMALL, keep_log=str(log), **kw)
    return res, log.read_text()


def test_sound_run_is_correct_on_a_mesh(monkeypatch, tmp_path):
    res, log = _run(monkeypatch, tmp_path)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert "on the mesh's 4 devices" in log


def test_exchange_fault_is_not_correct_on_a_mesh(monkeypatch, tmp_path):
    res, log = _run(monkeypatch, tmp_path, fault="exchange")
    assert not res["correct"]
    assert "on the mesh's 4 devices" in log
