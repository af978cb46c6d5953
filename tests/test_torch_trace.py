"""The port's tracer (nightlight_tpu_torch/trace.py) on the CPU: spans, their
nesting and self time, command ids across threads, recording only while
something listens, the counted host reads, the -trace export, and the
counters that other modules keep."""

import contextlib
import io
import json
import threading
import time
import urllib.request

import pytest
import torch

from nightlight_tpu_torch import cli, fixtures, kernels, trace
from nightlight_tpu_torch.io.ingest import ReadAheadLoader
from nightlight_tpu_torch.parallel import mesh as pm
from nightlight_tpu_torch.serve import rest

torch.set_num_threads(1)

JOB = {"type": "seq", "steps": [
    {"type": "loadMany", "filePatterns": ["light*.fits"]},
    {"type": "badPixel", "sigmaLow": 3, "sigmaHigh": 5},
    {"type": "starDetect", "radius": 16, "sigma": 15, "badPixelSigma": 5, "inOutRatio": 1.4},
    {"type": "selectRef", "target": 1, "mode": "%starsHFR"},
    {"type": "selectRef", "target": 0, "mode": "%starsHFR"},
    {"type": "matchHist", "mode": 2},
    {"type": "align", "k": 20, "threshold": 1},
    {"type": "stack", "mode": 2, "sigmaLow": 2.5, "sigmaHigh": 2.5},
    {"type": "save", "filePattern": "out.fits"}]}


@pytest.fixture(autouse=True)
def fresh():
    trace.clear()
    yield
    trace.clear()


def _by_name(recs):
    out = {}
    for s in recs:
        out.setdefault(s.name, []).append(s)
    return out


@pytest.mark.parametrize("form", ["with", "decorator"])
def test_nesting_parents_and_self_time(form):
    """A span's parent is the innermost open span of its thread; its self
    time is its duration less its children's."""
    @trace.span("detect")
    def detect():
        time.sleep(0.02)
        with trace.span("host_read"):
            time.sleep(0.01)

    with trace.recording():
        with trace.command() as cid:
            with trace.span("load"):
                time.sleep(0.01)
            if form == "with":
                with trace.span("detect"):
                    time.sleep(0.02)
                    with trace.span("host_read"):
                        time.sleep(0.01)
            else:
                detect()
    spans = _by_name(trace.records())
    cmd, load, det, read = (spans[n][0] for n in ("command", "load", "detect", "host_read"))
    assert cmd.parent is None and load.parent == cmd.id and det.parent == cmd.id
    assert read.parent == det.id
    assert {s.command for s in trace.records()} == {cid}
    assert len({s.thread for s in trace.records()}) == 1
    own = trace.self_ns(trace.records())
    dur = lambda s: s.end_ns - s.start_ns  # noqa: E731
    assert own[cmd.id] == dur(cmd) - dur(load) - dur(det)
    assert own[det.id] == dur(det) - dur(read)
    assert own[read.id] == dur(read) >= 10_000_000
    assert own[det.id] >= 20_000_000
    # each span is appended when it ends: children first
    order = [s.name for s in trace.records()]
    assert order.index("host_read") < order.index("detect") < order.index("command")


def test_nothing_recorded_when_nobody_listens():
    """Off, a span records nothing (and leaves no open span behind), while
    the counters still count."""
    assert not trace.is_recording()
    before = trace.counter("host.reads").get("detect", 0)
    with trace.command():
        with trace.span("detect"):
            with trace.host_read():
                pass
    assert trace.records() == []
    assert trace._local.stack == []
    assert trace.counter("host.reads").get("detect", 0) == before + 1


def test_a_profiler_on_another_thread_switches_recording_on():
    """A torch.profiler session entered on another thread records the spans
    of this one (the profiler's flag is process-wide), and only while it
    runs."""
    entered, leave, done = threading.Event(), threading.Event(), threading.Event()

    def profile():
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            entered.set()
            leave.wait(30)
        done.set()

    t = threading.Thread(target=profile)
    t.start()
    try:
        assert entered.wait(30)
        assert trace.is_recording()
        with trace.span("align"):
            pass
    finally:
        leave.set()
        t.join(30)
    assert done.is_set() and not trace.is_recording()
    with trace.span("warp"):
        pass
    assert [s.name for s in trace.records()] == ["align"]


@pytest.mark.parametrize("how", ["to_host", "host_read", "upload"])
def test_host_reads_counted_by_the_innermost_layer(monkeypatch, how):
    """A blocking read counts in host.reads under the innermost layer span
    around it (a sub-span's layer, else the innermost span) and opens a
    host_read span while recording; a read of a CPU tensor is no blocking
    read."""
    t = torch.arange(4.0)

    def read():
        if how == "to_host":
            return trace.to_host(t)
        if how == "upload":
            return trace.upload([1.0, 2.0], "cpu")
        with trace.host_read(t.device):
            return torch.nonzero(t)

    def counts():
        return trace.counter("host.reads"), trace.counter("host.uploads")

    reads0, uploads0 = counts()
    read()  # the CPU: nothing counted
    assert counts() == (reads0, uploads0)
    monkeypatch.setattr(trace, "_on_card", lambda device: True)
    with trace.recording():
        with trace.command():
            with trace.span("save"):
                with trace.span("save.fetch"):
                    got = read()
            read()
    if how == "to_host":
        assert torch.equal(got, t)
    reads1, uploads1 = counts()
    for key in ("save", "command"):
        assert reads1.get(key, 0) - reads0.get(key, 0) == 1
        assert uploads1.get(key, 0) - uploads0.get(key, 0) == (how == "upload")
    spans = _by_name(trace.records())
    assert len(spans["host_read"]) == 2
    assert spans["host_read"][0].parent == spans["save.fetch"][0].id
    assert trace.to_host(3) == 3  # not a tensor: passes through


def test_a_served_job_shares_one_command_id_across_its_threads(tmp_path, monkeypatch):
    """A POSTed job: the request span on the handler thread, the job's
    command span inside it, its layer spans, and the read-ahead workers'
    reads (no parent) all carry one command id."""
    monkeypatch.chdir(tmp_path)
    fixtures.gen(str(tmp_path), 5, 256)
    srv = rest.make_server(0, 1024, device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        with trace.recording():
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.server_address[1]}/api/v1/job",
                data=json.dumps(JOB).encode(), method="POST")
            with urllib.request.urlopen(req, timeout=300) as resp:
                body = resp.read().decode()
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(30)
    assert "Error" not in body and (tmp_path / "out.fits").exists()
    spans = _by_name(trace.records())
    (req_span,), (cmd,) = spans["request"], spans["command"]
    assert req_span.parent is None and cmd.parent == req_span.id
    assert req_span.thread == cmd.thread != threading.get_ident()
    assert {s.command for s in trace.records()} == {req_span.command}
    workers = [s for s in spans["load.read"] if s.thread_name.startswith("read-ahead")]
    assert workers and all(s.parent is None for s in workers)
    for name in ("load", "perframe", "detect", "align", "warp", "stack", "save"):
        assert name in spans, name
        assert all(s.thread == cmd.thread for s in spans[name])


def test_trace_export_holds_spans_anchors_and_counters(tmp_path, monkeypatch):
    """stack -trace DIR on the CPU: trace.json holds the profiler's events,
    the program's spans in lanes of their own on the same clock (inside the
    profiled run), both clock anchors with their drift, and the
    counters."""
    monkeypatch.chdir(tmp_path)
    fixtures.gen(str(tmp_path), 5, 256)
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["-out", "s.fits", "-trace", "tr", "-dark", "dark.fits", "stack",
                       "light*.fits"], device="cpu")
    assert rc == 0
    with open(tmp_path / "tr" / "trace.json") as f:
        doc = json.load(f)
    meta = doc["nightlight"]
    assert set(meta["anchors"]) == {"start", "end"}
    assert meta["drift_ns"] == (meta["anchors"]["end"]["offset_ns"]
                                - meta["anchors"]["start"]["offset_ns"])
    events = doc["traceEvents"]
    spans = [e for e in events if e.get("cat") == "nightlight"]
    names = {e["name"] for e in spans}
    assert {"command", "load", "preprocess", "detect", "align", "warp", "stack",
            "save"} <= names
    assert meta["spans"] == len(spans)
    ours = {e["tid"] for e in spans}
    torch_ops = [e for e in events if e.get("ph") == "X" and e.get("cat") != "nightlight"]
    assert not ours & {e.get("tid") for e in torch_ops}
    lanes = [e for e in events if e.get("ph") == "M" and e.get("tid") in ours]
    assert any(e["args"]["name"].startswith("nightlight spans: ") for e in lanes)
    # one clock: the stack span lies within the profiled run's torch ops
    stack = max((e for e in spans if e["name"] == "stack"), key=lambda e: e["dur"])
    lo = min(e["ts"] for e in torch_ops)
    hi = max(e["ts"] + e.get("dur", 0) for e in torch_ops)
    assert lo <= stack["ts"] and stack["ts"] + stack["dur"] <= hi
    assert {"kernels.launches", "detect.candidates"} <= set(meta["counters"])
    assert any(e.get("ph") == "C" and e["name"] == "detect.candidates" for e in events)


def test_trace_export_survives_an_interrupt(tmp_path, monkeypatch):
    """An exception that is no Exception (KeyboardInterrupt) raised inside
    the run still stops the profiler and writes trace.json."""
    monkeypatch.chdir(tmp_path)
    fixtures.gen(str(tmp_path), 2, 256)

    def interrupted(op, c):
        with trace.span("load"):
            raise KeyboardInterrupt

    monkeypatch.setattr(cli, "run_op", interrupted)
    with contextlib.redirect_stdout(io.StringIO()), pytest.raises(KeyboardInterrupt):
        cli.main(["-out", "s.fits", "-trace", "tr", "stack", "light*.fits"], device="cpu")
    assert not torch.autograd.profiler._is_profiler_enabled
    with open(tmp_path / "tr" / "trace.json") as f:
        doc = json.load(f)
    assert set(doc["nightlight"]["anchors"]) == {"start", "end"}
    names = {e["name"] for e in doc["traceEvents"] if e.get("cat") == "nightlight"}
    assert {"command", "load"} <= names


@pytest.mark.parametrize("sharded", [False, True])
def test_detect_candidates_counts_the_phase_two_survivors(monkeypatch, sharded):
    """detect.candidates adds the candidates that pass phase 2, those that
    phases 3-6 work on: a count below the fixed capacity, the same on the
    sharded path as on the whole frame."""
    from nightlight_tpu_torch.detect import stars

    rng = torch.Generator().manual_seed(5)
    h = w = 256
    img = 100.0 + 2.0 * torch.randn(h, w, generator=rng)
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32), indexing="ij")
    sigma = 8.0 / 2.3548
    for sy, sx in ((40, 60), (100, 180), (180, 80), (220, 200), (140, 128)):
        img += 8000.0 / (2 * torch.pi * sigma ** 2) * torch.exp(
            -((yy - sy) ** 2 + (xx - sx) ** 2) / (2 * sigma ** 2))
    seen = []
    finish = stars._finish

    def spy(*args):
        seen.append(int(args[5].shape[0]))  # cand: the survivors' indices
        return finish(*args)

    monkeypatch.setattr(stars, "_finish", spy)
    before = sum(trace.counter("detect.candidates").values())
    if sharded:
        mesh = pm.make_mesh([torch.device("cpu")] * 2)
        found, _ = stars.find_stars_sharded(pm.place_on_mesh(img, mesh), 100.0, 2.0, 15.0, 5.0,
                                            1.4, 16, 2.5)
    else:
        found, _ = stars.find_stars(img, 100.0, 2.0, 15.0, 5.0, 1.4, 16, 2.5)
    added = sum(trace.counter("detect.candidates").values()) - before
    (survivors,) = seen
    assert added == survivors
    assert 5 <= int(found.count) <= survivors < stars.MAX_CANDIDATES


def test_the_modules_counters_read_as_before_and_export_from_where_they_live(tmp_path):
    """kernels.launch_counts(), mesh.GATHERS and the loader's inline_reads
    keep their names and values; the tracer's counters() reads the first
    two where they live."""
    kernels.reset_launch_counts()
    kernels.count_launch("stack_clip")
    assert kernels.launch_counts()["stack_clip"] == 1
    assert trace.counters()["kernels.launches"] == kernels.launch_counts()
    mesh = pm.make_mesh([torch.device("cpu")] * 2)
    before = pm.GATHERS["trace-test"]
    pm.RowSharded(mesh, (4, 2), [torch.zeros(2, 2), torch.ones(2, 2)]).gather("trace-test")
    assert pm.GATHERS["trace-test"] == before + 1
    assert trace.counters()["mesh.gathers"]["trace-test"] == before + 1
    pm.GATHERS.pop("trace-test")
    names = fixtures.gen(str(tmp_path), 4, 256)
    total = trace.counter("load.inline_reads").get("", 0)
    loader = ReadAheadLoader(list(enumerate(names)), io.StringIO(), "cpu", depth=0)
    try:
        loader.get(names[0])
        assert loader.inline_reads == 1
        loader.get(names[1])
        assert loader.inline_reads == 2
    finally:
        loader.close()
    assert trace.counters()["load.inline_reads"] == {"": total + 2}
    other = ReadAheadLoader(list(enumerate(names)), io.StringIO(), "cpu", depth=0)
    try:
        assert other.inline_reads == 0
    finally:
        other.close()
