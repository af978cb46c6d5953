"""CPU tests of the benchmark harness (benchmark_torch/).

    python -m pytest benchmark_torch/tests -q

The runs of a cell here use the port's plain kernels on the CPU at 512 x
512 with 150 stars (about the configurations' star density), so they say
nothing of the card's times; they show that the harness drives the jobs,
that the comparison passes a sound run and fails the control and the
planted faults, and that the yardstick's arithmetic is right.
"""

from __future__ import annotations

import ast
import copy
import json
import math
import os
import re
import time
from pathlib import Path

import pytest
import torch

from benchmark_torch import cards, compare, faults, gen, phases, profile, reference, roofline, run

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SMALL = {"width": 512, "height": 512, "stars": 150}
CELLS = [w["name"] for w in BENCH["workloads"]]


# ---------------------------------------------------------------------------
# BENCHMARK.json and the files it names
# ---------------------------------------------------------------------------


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark_torch"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for e in BENCH[kind]:
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key]), e[key]
        for text in (e.get("why"), e.get("layer"), e.get("source")):
            if text is not None:
                assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_metric_entries():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%" and m["source"] == "device_trace"


def card_faults(bench: dict, name: str, traffic: dict) -> list:
    """What cell `name` of `bench`, with its traffic file, breaks of the
    rule on cards: chips is 1 or 4; at most max(1, cells // 4) cells take
    four; a four-card cell runs CLI jobs, every run with -shard, so that
    the program meshes the cell's cards (run.main shows it those alone)."""
    cells = bench["workloads"]
    entry = next(w for w in cells if w["name"] == name)
    out = []
    if entry["chips"] not in (1, 4):
        out.append("chips")
    if sum(w["chips"] == 4 for w in cells) > max(1, len(cells) // 4):
        out.append("quota")
    if entry["chips"] == 4:
        if traffic.get("kind") != "cli":
            out.append("kind")
        elif not all("-shard" in r["argv"] for r in traffic["runs"]):
            out.append("shard")
    return out


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files(cell):
    bench, entry, config, traffic = run.load_cell(cell, ROOT)
    assert card_faults(bench, cell, traffic) == []
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    assert (ROOT / conf["file"]).is_file()
    assert config["name"] == conf["name"] and config["source"] == conf["source"]
    assert config["reduced"] == conf["reduced"] == []
    assert set(traffic["limits"]) == set(compare.NAMES)
    for m in run.cell_metrics(bench, entry, "per_layer"):
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
    e2e = [m["name"] for m in run.cell_metrics(bench, entry, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert run.cell_metrics(bench, entry, "per_layer")


def _sharded(traffic: dict) -> dict:
    return dict(traffic, runs=[dict(r, argv=["-shard", *r["argv"]]) for r in traffic["runs"]])


@pytest.mark.parametrize("case,expected", [
    ("one four-card cell", []), ("two four-card cells of four", ["quota"]),
    ("two four-card cells of eight", []), ("four-card run without -shard", ["shard"]),
    ("four-card served cell", ["kind"]), ("two cards", ["chips"])])
def test_card_rule_on_synthetic_benchmarks(case, expected):
    bench = copy.deepcopy(BENCH)
    cells = bench["workloads"]
    if "eight" in case:
        cells += [dict(w, name=w["name"] + ".b") for w in copy.deepcopy(cells)]
    name = "mono16.served.n24" if "served" in case else "mono16.n10"
    traffic = run.load_cell(name, ROOT)[3]
    if "-shard" not in case and "served" not in case:
        traffic = _sharded(traffic)
    four = [name] + (["mono16.n100"] if case.startswith("two four") else [])
    for w in cells:
        if w["name"] in four:
            w["chips"] = 2 if case == "two cards" else 4
    assert card_faults(bench, name, traffic) == expected


@pytest.mark.parametrize("chips,env,expected", [
    (1, None, "0"), (4, None, "0,1,2,3"), (1, "0,1,2,3,4,5,6,7", "0"),
    (4, "0,1,2,3,4,5,6,7", "0,1,2,3"), (4, "5, 4,7,6,0", "5,4,7,6"), (4, "1,2", "1,2"),
    (1, "", "")])
def test_visible_cards(chips, env, expected):
    assert run.visible_cards(chips, env) == expected


def test_main_shows_the_cell_its_cards_alone(monkeypatch, capsys):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1,2,3,4,5,6,7")
    assert run.main(["--workload", "mono16.n10", "--seed", "5", "--seconds", "1"]) == 2
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "0"
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("loaded,expected", [
    (["torch", "nightlight_tpu_torch", "nightlight_tpu_torch.ops", "jaxtyping"], []),
    (["jax.numpy", "torch"], ["jax"]), (["nightlight_tpu.ops.stack"], ["nightlight_tpu"]),
    (["flax", "jaxlib.xla_client"], ["flax", "jaxlib"])])
def test_forbidden_modules_by_whole_top_level_name(loaded, expected):
    assert run.forbidden_modules(loaded) == expected


def test_reference_named_by_the_traffic():
    assert run.reference_of({}) is reference.stack_job
    assert run.reference_of({"reference": "compare.numbers"}) is compare.numbers


def test_every_config_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


# ---------------------------------------------------------------------------
# What the harness imports
# ---------------------------------------------------------------------------


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")), ids=lambda p: p.name)
def test_no_jax_nor_the_jax_package(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "nightlight_tpu"), (path, name)


@pytest.mark.parametrize("module", ["reference.py", "ref_stars.py", "compare.py", "gen.py",
                                    "roofline.py"])
def test_yardstick_imports_nothing_of_the_program(module):
    for name in _imports(HERE / module):
        assert not name.startswith("nightlight_tpu_torch"), (module, name)


def test_run_refuses_without_a_card(capsys, monkeypatch):
    # main narrows the visible cards; monkeypatch restores them afterwards
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    assert not torch.cuda.is_available()
    assert run.main(["--workload", CELLS[0], "--seed", "5", "--seconds", "1",
                     "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""


# ---------------------------------------------------------------------------
# The generator
# ---------------------------------------------------------------------------


def _params(cell="mono16.n10", **over):
    _, _, config, _ = run.load_cell(cell, ROOT)
    return {**config["generator"], **SMALL, **over}


def test_generator_is_deterministic(tmp_path):
    p = _params(width=256, height=256, stars=40)
    a = gen.generate(p, 3, 2**31 + 12345, tmp_path / "a", "cpu")
    b = gen.generate(p, 3, 2**31 + 12345, tmp_path / "b", "cpu")
    c = gen.generate(p, 3, 2**31 + 12346, tmp_path / "c", "cpu")
    for x, y in zip(a.lights + [a.dark, a.flat], b.lights + [b.dark, b.flat]):
        assert Path(x).read_bytes() == Path(y).read_bytes()
    assert Path(a.lights[0]).read_bytes() != Path(c.lights[0]).read_bytes()
    assert a.bytes_written == sum(Path(f).stat().st_size for f in a.lights + [a.dark, a.flat])


def test_generator_counts(tmp_path):
    p = _params(width=256, height=256, stars=40)
    d = gen.draw(p, 20, 99)
    assert d["sky_xy"].shape == (40, 2) and len(d["flux"]) == 40
    assert d["flux"].min() >= p["flux_min_adu"] and d["flux"].max() <= p["flux_max_adu"]
    assert len(set(d["hot_idx"].tolist())) == p["hot_pixels"]
    assert sum(t is not None for t in d["trails"]) == 20 // p["trail_every"]
    assert abs(d["dither"]).max() <= p["dither_px"]
    assert abs(d["theta"]).max() <= math.radians(p["rotation_deg"])
    inputs = gen.generate(p, 2, 99, tmp_path, "cpu")
    dark = reference.read_fits(inputs.dark, "cpu").reshape(-1)
    hot = torch.as_tensor(d["hot_idx"])
    assert bool((dark[hot] > p["bias_adu"] + p["hot_adu"][0] - 20).all())
    light = reference.read_fits(inputs.lights[0], "cpu")
    assert light.shape == (256, 256) and float(light.max()) <= p["max_adu"]
    # a star's window holds its flux
    pos = torch.tensor([[100.3, 120.7], [30.0, 40.5]])
    flux = torch.tensor([5000.0, 20000.0])
    idx, val = gen._star_values(pos, flux, 1.5, 256, 256)
    assert float(val.sum()) == pytest.approx(25000.0, rel=1e-3)
    assert len(idx) == 2 * (2 * gen.STAR_RADIUS + 1) ** 2


def test_fixed_layouts_are_the_same_for_every_seed():
    p = _params(width=256, height=256, stars=40, trails="fixed", order="fixed")
    a, b = gen.draw(p, 24, 99), gen.draw(p, 24, 2**31 + 5)
    for key in ("fwhm", "dither", "theta"):
        assert (a[key] == b[key]).all()
        assert sorted(a[key].reshape(-1)) == sorted(gen.draw(_params(), 24, 99)[key].reshape(-1))
    assert a["trails"] == b["trails"]
    assert [i for i, t in enumerate(a["trails"]) if t] == [5, 15]
    assert [t[2] for t in a["trails"] if t] == [math.pi / 4, 3 * math.pi / 4]
    assert not (a["sky_xy"] == b["sky_xy"]).all()
    # without the keys every seed draws its own trails and order
    c, d = gen.draw(_params(), 24, 99), gen.draw(_params(), 24, 2**31 + 5)
    assert not (c["fwhm"] == d["fwhm"]).all()


def test_osc_generator_mosaic(tmp_path):
    p = _params("osc16.rgb.n20", width=256, height=256, stars=0, hot_pixels=0,
                trail_every=1000)
    inputs = gen.generate(p, 1, 5, tmp_path, "cpu")
    light = reference.read_fits(inputs.lights[0], "cpu") - p["bias_adu"]
    r, g, b = light[0::2, 0::2].mean(), light[0::2, 1::2].mean(), light[1::2, 1::2].mean()
    assert abs(float(g / r) - 0.8) < 0.02 and abs(float(b / r) - 0.6) < 0.02
    assert float(light.max()) + p["bias_adu"] <= 16383


# ---------------------------------------------------------------------------
# The yardstick's arithmetic on hand-made records
# ---------------------------------------------------------------------------


def test_roofline_bounds_match_the_kernel_table():
    p = 4096 * 4096
    k1 = roofline.bound_s(*roofline.stack_work("stack_clip", 8, p)) * 1e3
    k2 = roofline.bound_s(*roofline.stack_work("stack_linfit", 30, p)) * 1e3
    k4 = roofline.bound_s(*roofline.gather_work(2048, 32, 2048 * 65 * 65)) * 1e3
    assert abs(k1 - 0.180) < 0.001 and abs(k2 - 0.621) < 0.001
    # the kernel table's 0.0228 ms counts the in-frame elements of its
    # candidates; all in frame is the most
    assert 0.0228 <= k4 <= 0.0233


def test_union_and_idle_gaps():
    merged = profile.union([(10, 20), (15, 30), (40, 50), (50, 55)])
    assert merged == [[10, 30], [40, 55]]
    marks = [("load", 0, 35), ("detect", 32, 34), ("save", 56, 100)]
    idle = profile.idle_by_phase(merged, marks, 0, 100)
    assert idle == pytest.approx({"load": 20e-9, "save": 45e-9})


def _events(*cards_and_intervals):
    return [(f"kernel{i}", k, s, e) for i, (k, s, e) in enumerate(cards_and_intervals)]


def test_busy_by_card_is_each_cards_own_union():
    device = _events((0, 10, 20), (1, 15, 30), (0, 15, 25), (1, 40, 50), (1, 45, 46))
    mean, by_card = profile.busy_by_card(device, 2)
    assert by_card == pytest.approx([15e-9, 25e-9])
    assert mean == pytest.approx(20e-9)
    # a card of the cell with no work counts in the mean at 0
    mean3, by_card3 = profile.busy_by_card(device, 3)
    assert by_card3[2] == 0 and mean3 == pytest.approx(40e-9 / 3)
    # device.idle of the mean is the mean of the cards' idle shares
    window = 60e-9
    idle = run.load_metric("device.idle").read({"busy_s": mean, "window_s": window})
    assert idle == pytest.approx(sum(100 * (1 - b / window) for b in by_card) / 2)


def test_busy_on_one_card_is_the_union_of_every_event():
    device = _events((0, 10, 20), (0, 15, 30), (0, 40, 50), (0, 50, 55), (0, 7, 8))
    merged = profile.union([(s, e) for _, _, s, e in device])
    mean, by_card = profile.busy_by_card(device, 1)
    assert mean == by_card[0] == sum(e - s for s, e in merged) * 1e-9


def test_peaks_are_read_on_every_card():
    read = {0: 5 << 30, 1: 9 << 30, 2: 7 << 30, 3: 1 << 30}
    cell = cards.of_cell(4)
    assert [c.index for c in cell] == [0, 1, 2, 3]
    peaks = cards.peaks(cell, read=lambda c: read[c.index])
    assert peaks == [5 << 30, 9 << 30, 7 << 30, 1 << 30] and max(peaks) == 9 << 30
    assert cards.peaks(cards.of_cell(1), read=lambda c: read[c.index]) == [5 << 30]


def test_waits_and_resets_cover_every_card(monkeypatch):
    seen = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d: seen.append(("sync", d.index)))
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda d: seen.append(("reset", d.index)))
    cards.synchronize(cards.of_cell(4))
    cards.reset_peaks(cards.of_cell(2))
    assert seen == [("sync", 0), ("sync", 1), ("sync", 2), ("sync", 3), ("reset", 0),
                    ("reset", 1)]
    seen.clear()
    clock = phases.PhaseClock(["p"], cards=cards.of_cell(4))
    clock.sync = True
    clock.wrap("p", lambda: None)()
    assert seen == [("sync", k) for k in range(4)] * 2


def test_exchange_fault_keeps_the_lead_rows_alone():
    from nightlight_tpu_torch.parallel import mesh

    m = mesh.make_mesh([torch.device("cpu")] * 4)
    x = torch.arange(2 * 8 * 3, dtype=torch.float32).reshape(2, 8, 3) + 1
    sharded = mesh.shard_rows(m, x)
    with faults.planted("exchange"):
        broken = mesh.gather(sharded)
        assert torch.equal(mesh.gather(mesh.replicated(m, x)), x)
    assert torch.equal(broken[:, :2], x[:, :2]) and not broken[:, 2:].any()
    assert torch.equal(mesh.gather(sharded), x)


def test_detection_phase_wraps_the_sharded_detector():
    from nightlight_tpu_torch.parallel import mesh

    targets = phases.phase_targets([run.load_metric("detect.stars_s")])
    clock = phases.PhaseClock(targets, sync=False)
    m = mesh.make_mesh([torch.device("cpu")] * 4)
    g = torch.Generator().manual_seed(3)
    img = 100.0 + torch.randn((256, 256), generator=g)
    img[100:103, 60:63] += 500.0
    with phases.phases_wrapped(clock, targets):
        mesh.sharded_star_detect(m, 16)(img, 100.0, 1.0, 15.0, 5.0, 1.4, None)
    assert clock.entries["detect"] == 1 and clock.seconds["detect"] > 0


def test_phase_clock_books_exclusive_seconds():
    clock = phases.PhaseClock(["outer", "inner"], sync=False)
    inner = clock.wrap("inner", lambda: time.sleep(0.05))

    def outer_fn():
        time.sleep(0.05)
        inner()

    clock.start_job()
    clock.wrap("outer", outer_fn)()
    assert 0.045 < clock.seconds["inner"] < 0.08
    assert 0.045 < clock.seconds["outer"] < 0.08
    assert clock.entries == {"outer": 1, "inner": 1}
    assert clock.last_exit - clock.first_entry >= 0.1


def _rec(**over):
    rec = {"jobs": 4, "wall_s": 10.0, "first_job_s": 1.5, "phases_s": {"load": 2.0, "detect": 3.0},
           "entries": {"load": 40, "detect": 0},
           "launches": {"stack_clip": 8, "gather_patches": 9},
           "spans": [(0.0, 2.0, 0.5, 1.5), (2.0, 4.0, 2.1, 3.9)], "busy_s": 3.0, "window_s": 4.0,
           "kernels": {"stack_clip": {"calls": 2, "bound_s": 0.001, "device_s": 0.004}}}
    rec.update(over)
    return rec


@pytest.mark.parametrize("name,expected", [
    ("io.load_s", 0.5), ("detect.stars_s", None), ("pipeline.rest_s", 1.25),
    ("stack.evals", 2.0), ("device.idle", 25.0), ("kernel.k1_roofline", 25.0),
    ("kernel.k2_roofline", None), ("serve.request_s", 0.6), ("first_job_s", 1.5)])
def test_metric_readers(name, expected):
    value = run.load_metric(name).read(_rec())
    assert value == (None if expected is None else pytest.approx(expected))


def test_comparison_numbers():
    ref = torch.arange(10000, dtype=torch.float32).reshape(100, 100)
    out = ref.clone()
    out[:2] += 4.0  # 2% of the pixels 2 scales off
    out[50, 50] = float("nan")
    n = compare.numbers(out, ref, 2.0)
    assert n == {"gap_p50": 0.0, "gap_p99": 2.0, "nonfinite_px": 1}
    ok, check = compare.verdict(n, {"gap_p50": 0.01, "gap_p99": 0.1, "nonfinite_px": 0})
    assert not ok and check["gap_p99"] == {"value": 2.0, "limit": 0.1}


def test_closed_loop_ends_with_the_first_job_past_the_window(monkeypatch):
    ends = iter([0.0, 1.0, 2.5, 4.0])
    monkeypatch.setattr(run.time, "perf_counter", lambda: next(ends))
    rows, window = run.closed_loop(lambda k: k != 2, 2.0)
    # job_s is the window over its whole jobs: 2.5 s / 2
    assert rows == [(1, True), (2, False)] and window == 2.5


# ---------------------------------------------------------------------------
# Runs of the cells on the CPU: a sound run passes, the control and the
# planted faults fail
# ---------------------------------------------------------------------------


def _run(cell, lights=None, **kw):
    bench, entry, config, traffic = run.load_cell(cell, ROOT)
    if lights:
        traffic = dict(traffic, lights=lights)
    return run.run_cell(bench, entry, config, traffic, 2**31 + 77, 0.1, kw.pop("trace", False),
                        device="cpu", generator=SMALL, **kw)


@pytest.mark.parametrize("cell,lights", [("mono16.n10", None), ("mono16.served.n24", 8),
                                         ("osc16.rgb.n20", 6)])
def test_sound_run_is_correct(cell, lights):
    res = _run(cell, lights, control=True)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "check"
    # the control, the reference in bfloat16, fails the cell's limits
    _, _, _, traffic = run.load_cell(cell, ROOT)
    assert not compare.verdict(res["control"], traffic["limits"])[0]


@pytest.mark.parametrize("fault", ["half", "altered"])
def test_planted_fault_is_not_correct(fault):
    assert not _run("mono16.n10", fault=fault)["correct"]


def test_exchange_fault_has_nothing_to_break_unsharded(tmp_path):
    res = _run("mono16.n10", fault="exchange", keep_log=str(tmp_path / "program.log"))
    assert res["correct"]
    log = (tmp_path / "program.log").read_text()
    assert "stack" in log.lower() and "Sharding frames" not in log


def test_traced_run_reports_the_layers():
    res = _run("mono16.n10", trace=True)
    m = res["metrics"]
    for name in ("io.load_s", "io.save_s", "fastpath.preprocess_s", "detect.stars_s",
                 "align.align_s", "resample.warp_s", "stack.stack_s", "pipeline.rest_s"):
        assert m[name]["value"] > 0, name
    assert "job_s" not in m
    assert res["device"]["count"] == 1 and res["device"]["memory_peak_bytes_by_card"] == [0]
