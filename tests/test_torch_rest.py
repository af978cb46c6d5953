"""The port's REST server (nightlight_tpu_torch/serve) on the CPU: every case
of tests/test_rest.py against it, the live-stacking job on the JAX server
and the port's server held to each other, the schema and web assets
against the JAX package's, the sandbox, the CLI entry point and the
server's thread safety."""

import contextlib
import http.client
import io
import json
import os
import random
import socket
import sys
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nightlight_tpu.ops import stats as jstats
from nightlight_tpu.serve import rest as jrest
from nightlight_tpu_torch import cli as tcli
from nightlight_tpu_torch import kernels
from nightlight_tpu_torch.fixtures import live_stacking_job
from nightlight_tpu_torch.image import Image as TImage
from nightlight_tpu_torch.io import fits as tfits
from nightlight_tpu_torch.serve import rest as trest
from nightlight_tpu_torch.serve import sandbox as tsandbox
from test_torch_cli import _compare_logs
from test_torch_cli_rgb import jax_log_lines

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _start(srv):
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return thread


def _stop(srv, thread):
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=30)
    assert not thread.is_alive()


@pytest.fixture
def server(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    srv = trest.make_server(0, 1024, device="cpu")
    thread = _start(srv)
    yield f"http://127.0.0.1:{srv.server_address[1]}", tmp_path
    _stop(srv, thread)


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=300) as resp:
        return resp.status, resp.read().decode()


def _raw_get(url, path):
    """GET with the path sent verbatim (http.client does not normalize)."""
    host, port = url.replace("http://", "").split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _write_noise(d, n=2, size=128, seed=42):
    rng = np.random.default_rng(seed)
    for i in range(n):
        im = TImage.from_numpy(rng.normal(100.0, 2.0, size=(size, size)).astype(np.float32))
        im.exposure = 60.0
        tfits.write_file(im, os.path.join(str(d), f"light{i:02d}.fits"))


class TestREST:
    def test_ping(self, server):
        url, _ = server
        with urllib.request.urlopen(url + "/api/v1/ping") as resp:
            assert json.loads(resp.read()) == {"message": "pong"}
            assert resp.headers["Access-Control-Allow-Origin"] == "*"
        req = urllib.request.Request(url + "/api/v1/job", method="OPTIONS")
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert resp.status == 204
            assert "POST" in resp.headers["Access-Control-Allow-Methods"]

    def test_schema_covers_registry(self, server):
        url, _ = server
        with urllib.request.urlopen(url + "/api/v1/schema") as resp:
            schema = json.loads(resp.read())
        from nightlight_tpu_torch.pipeline.operators import _operator_factories

        assert set(schema["operators"]) == set(_operator_factories)
        assert len(_operator_factories) == 45
        categorized = {t for types in schema["categories"].values() for t in types}
        assert categorized == set(_operator_factories)

    def test_schema_field_metadata(self, server):
        """Slider ranges and enum dropdowns the web UI renders from."""
        url, _ = server
        with urllib.request.urlopen(url + "/api/v1/schema") as resp:
            ops = json.loads(resp.read())["operators"]

        def param(op, name):
            return next(p for p in ops[op]["params"] if p["name"] == name)

        assert param("starDetect", "radius")["range"] == [0, 128, 1]
        assert param("badPixel", "sigmaLow")["range"] == [0, 6, 0.01]
        assert param("stretch", "location")["range"] == [0, 1, 0.005]
        stack_modes = dict(param("stack", "mode")["enum"])
        assert stack_modes["median (no sigmas)"] == 0
        assert stack_modes["automatic selection"] == 6
        assert len(param("stack", "weighting")["enum"]) == 4
        assert [v for _, v in param("save", "saveMode")["enum"]] == [0, 1, 2, 3]
        cfa = [v for _, v in param("debayer", "colorFilterArray")["enum"]]
        assert cfa == ["RGGB", "GRBG", "GBRG", "BGGR"]
        for meta in ops.values():
            for p in meta["params"]:
                assert not ("enum" in p and "range" in p)

    def test_job_streams_log(self, server, rng):
        url, tmp_path = server
        img = TImage.from_numpy(rng.normal(50, 2, size=(64, 64)).astype(np.float32))
        tfits.write_file(img, str(tmp_path / "a.fits"))
        job = {"type": "seq", "steps": [
            {"type": "loadMany", "filePatterns": ["a.fits"]},
            {"type": "save", "filePattern": "b.fits"},
        ]}
        status, body = _post(url + "/api/v1/job", job)
        assert status == 200
        assert body.startswith("Arguments:\n")
        assert "Found 1 files." in body
        assert "Writing 64x64 pixel FITS to b.fits" in body
        assert (tmp_path / "b.fits").exists()

    def test_job_error_streams_error(self, server):
        """Errors arrive in the body, and a job that fails releases the
        one-job lock."""
        url, _ = server
        job = {"type": "seq", "steps": [{"type": "loadMany", "filePatterns": ["zz*.fits"]}]}
        status, body = _post(url + "/api/v1/job", job)
        assert status == 200
        assert "Error" in body
        assert not trest._job_lock.locked()
        status, body = _post(url + "/api/v1/job", {"type": "noSuchOp"})
        assert status == 200 and body.startswith("Error making promises: unknown operator type")

    def test_malformed_json_400(self, server):
        url, _ = server
        req = urllib.request.Request(url + "/api/v1/job", data=b"{broken", method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=30)
        assert ei.value.code == 400

    def test_index_served(self, server):
        url, _ = server
        with urllib.request.urlopen(url + "/") as resp:
            assert b"visual job editor" in resp.read()
        with urllib.request.urlopen(url + "/js/app.js") as resp:
            assert b"/api/v1/schema" in resp.read()

    def test_static_route_rejects_traversal(self, server):
        """GET /js/../../../../etc/passwd must not escape the web asset dir."""
        url, _ = server
        status, body = _raw_get(url, "/js/../../../../../../etc/passwd")
        assert status in (403, 404)
        assert b"root:" not in body

    def test_files_route_serves_cwd_and_rejects_traversal(self, server):
        """/api/v1/files/* serves the working directory and refuses any
        '..' and any absolute path."""
        url, tmp_path = server
        (tmp_path / "out.txt").write_text("stacked")
        status, body = _raw_get(url, "/api/v1/files/out.txt")
        assert status == 200 and body == b"stacked"
        for path in ("/api/v1/files/../../../../etc/passwd", "/api/v1/files//etc/passwd",
                     "/api/v1/files/a/..b"):
            status, body = _raw_get(url, path)
            assert status == 403 and b"root:" not in body, path


class TestConcurrentJobs:
    def test_two_simultaneous_jobs_serialize(self, server, tmp_path):
        """Jobs run one at a time; both requests still complete and stream
        their logs."""
        url, _ = server
        _write_noise(tmp_path)
        job = json.dumps({"type": "seq", "steps": [
            {"type": "loadMany", "filePatterns": ["light*.fits"]},
        ]}).encode()
        bodies = [None, None]

        def post(i):
            req = urllib.request.Request(url + "/api/v1/job", data=job, method="POST")
            with urllib.request.urlopen(req, timeout=120) as resp:
                bodies[i] = resp.read().decode()

        ts = [threading.Thread(target=post, args=(i,)) for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
            assert not t.is_alive()
        for b in bodies:
            assert b is not None and "Loaded" in b and "Error" not in b, b

    def test_queued_job_announces_wait_then_completes(self, server, tmp_path):
        """While a job holds the device lock, a second POST streams the
        queued notice at once and completes once the lock frees."""
        url, _ = server
        _write_noise(tmp_path)
        job = json.dumps({"type": "seq", "steps": [
            {"type": "loadMany", "filePatterns": ["light*.fits"]},
        ]}).encode()
        assert trest._job_lock.acquire(timeout=5)  # simulate a running job
        got_notice = threading.Event()
        body = {}

        def post():
            req = urllib.request.Request(url + "/api/v1/job", data=job, method="POST")
            with urllib.request.urlopen(req, timeout=120) as resp:
                lines = []
                for raw in resp:
                    line = raw.decode()
                    lines.append(line)
                    if "Queued:" in line:
                        got_notice.set()
                body["text"] = "".join(lines)

        t = threading.Thread(target=post)
        t.start()
        try:
            assert got_notice.wait(timeout=30), "no queued notice streamed"
            assert "text" not in body  # the job must not have run yet
        finally:
            trest._job_lock.release()
        t.join(timeout=120)
        assert not t.is_alive()
        assert "Queued: another job is running; waiting for the device...\n" in body["text"]
        assert "Loaded" in body["text"] and "Error" not in body["text"]


def _post_raw_chunked(host, port, payload):
    """POST a job; return (header, chunks), the raw HTTP chunk frames, one
    per server-side log write (as tests/test_rest.py reads them)."""
    body = json.dumps(payload).encode()
    req = (f"POST /api/v1/job HTTP/1.1\r\nHost: {host}\r\n"
           f"Content-Type: application/json\r\nContent-Length: {len(body)}\r\n\r\n"
           ).encode() + body
    with socket.create_connection((host, port), timeout=600) as s:
        s.sendall(req)
        buf = b""
        while b"\r\n\r\n" not in buf:
            buf += s.recv(65536)
        header, data = buf.split(b"\r\n\r\n", 1)
        chunks = []
        while True:
            while b"\r\n" not in data:
                data += s.recv(65536)
            size_line, data = data.split(b"\r\n", 1)
            size = int(size_line, 16)
            if size == 0:
                break
            while len(data) < size + 2:
                data += s.recv(65536)
            chunks.append(data[:size])
            data = data[size + 2:]
    return header.decode(), chunks


def _serve_one(srv, job):
    thread = _start(srv)
    try:
        random.seed(123)  # the batch permutation
        return _post_raw_chunked(*srv.server_address, job)
    finally:
        _stop(srv, thread)


def test_live_stacking_matches_jax_server(tmp_path, monkeypatch):
    """The live-stacking job on the JAX server and on the port's, on the
    same 10 scripts/gen_fixtures frames of 256x256, 4 threads, a 3 MiB
    budget (two random batches of 5) and the same `random` seed: the log
    streams chunk per write with each batch start in its own chunk; the
    logs are equal under the bands of tests/test_torch_cli.py (per-frame
    lines in any order, as the JAX server's thread pool writes them;
    without the JAX package's host-to-TPU "Ingest:" line), and the stacks
    agree within that file's band."""
    from scripts.gen_fixtures import gen

    monkeypatch.chdir(tmp_path)
    gen(str(tmp_path), 10, 256)
    # the thread count enters the batch plan; pin it for both servers
    monkeypatch.setattr(os, "cpu_count", lambda: 4)
    jnp.zeros(1).block_until_ready()
    jheader, jchunks = _serve_one(jrest.make_server(0, 3), live_stacking_job("jax.fits"))
    theader, tchunks = _serve_one(trest.make_server(0, 3, device="cpu"), live_stacking_job("port.fits"))

    for header, chunks in ((jheader, jchunks), (theader, tchunks)):
        assert "Transfer-Encoding: chunked" in header
        assert len(chunks) > 20, len(chunks)
        body = b"".join(chunks).decode()
        assert "random batches" in body and "Error" not in body, body
        starts = [ch for ch in chunks if b"Starting batch" in ch]
        assert [s.strip() for s in starts] == [b"Starting batch 1 of 2 with 5 frames...",
                                              b"Starting batch 2 of 2 with 5 frames..."]
    jlog = jax_log_lines(b"".join(jchunks).decode())
    tlog = b"".join(tchunks).decode().replace("port.fits", "jax.fits")
    assert "Writing 256x256 pixel FITS to jax.fits" in tlog
    _compare_logs(jlog, tlog, exact_seek=True, per_frame=True)

    a = tfits.read_file("jax.fits").to_numpy()
    b = tfits.read_file("port.fits").to_numpy()
    assert a.shape == b.shape == (256, 256) and np.isfinite(b).all()
    rel = np.abs(a - b) / np.maximum(np.abs(a), 1.0)
    assert np.median(rel) <= 1e-5 and np.mean(rel > 1e-4) <= 2e-3 and rel.max() <= 0.1


def test_served_jobs_ignore_the_cli_estimator(tmp_path, monkeypatch):
    """`serve -lsEst 1`: the JAX CLI sets its package default estimator
    (cli.py:362-364), yet a served job's frames take the job context's
    SCMedianQn, so the JAX server's log is the same under either default;
    the port's CLI hands no estimator to its server, whose log equals the
    JAX server's. The job's lines do depend on the estimator: `run -lsEst 1`
    of the same job prints other locations."""
    monkeypatch.chdir(tmp_path)
    _write_noise(tmp_path, n=3, size=64)
    job = {"type": "seq", "steps": [
        {"type": "loadMany", "filePatterns": ["light*.fits"]},
        {"type": "selectRef", "target": 1, "mode": "%location"},
        {"type": "matchHist", "mode": 2},
    ]}
    jnp.zeros(1).block_until_ready()

    def body(srv):
        return b"".join(_serve_one(srv, job)[1]).decode()

    jlog = body(jrest.make_server(0, 0))
    monkeypatch.setattr(jstats, "DEFAULT_LS_ESTIMATOR", jstats.LSEstimatorMode.MedianMAD)
    # the JAX server's thread pool writes the per-frame lines in any order
    assert sorted(body(jrest.make_server(0, 0)).splitlines()) == sorted(jlog.splitlines())
    assert "after matching reference histogram" in jlog

    calls = []
    monkeypatch.setattr(trest, "warm_device", lambda d: calls.append(("warm", d)))
    monkeypatch.setattr(tsandbox, "make_sandbox", lambda *a: calls.append(("sandbox", *a[:2])))
    monkeypatch.setattr(trest, "serve", lambda *a, **k: calls.append(("serve", a, k)))
    assert tcli.main(["-log", "", "-lsEst", "1", "-port", "8123", "-stMemory", "7",
                      "-chroot", "/nowhere", "-setuid", "5", "serve"], device="cpu") == 0
    cpu = torch.device("cpu")
    assert calls == [("warm", cpu), ("sandbox", "/nowhere", 5),
                     ("serve", (8123, 7), {"device": cpu})]
    monkeypatch.undo()
    monkeypatch.chdir(tmp_path)

    tlog = body(trest.make_server(0, 0, device="cpu"))
    _compare_logs(jax_log_lines(jlog), tlog, exact_seek=True, per_frame=True)
    with open("job.json", "w") as f:
        json.dump(job, f)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tcli.main(["-log", "", "-lsEst", "1", "-job", "job.json", "run"],
                         device="cpu") == 0
    served = [ln for ln in tlog.splitlines() if "after matching" in ln]
    mad = [ln for ln in out.getvalue().splitlines() if "after matching" in ln]
    assert len(served) == len(mad) == 3 and sorted(served) != sorted(mad)


def test_schema_equals_jax():
    """The schema the web UI builds its blocks from: the same JSON."""
    from nightlight_tpu.serve.schema import operator_schema as jschema
    from nightlight_tpu_torch.serve.schema import operator_schema as tschema

    assert tschema() == jschema()
    assert json.dumps(tschema()) == json.dumps(jschema())


@pytest.mark.parametrize("asset", ["index.html", "js/app.js"])
def test_web_assets_equal_jax(asset):
    with open(os.path.join(ROOT, "nightlight_tpu", "serve", "web", asset), "rb") as f:
        jax_bytes = f.read()
    with open(os.path.join(ROOT, "nightlight_tpu_torch", "serve", "web", asset), "rb") as f:
        assert f.read() == jax_bytes


def test_sandbox_without_flags_does_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    log = io.StringIO()
    tsandbox.make_sandbox("", -1, log)
    assert log.getvalue() == "" and os.getcwd() == str(tmp_path)


def test_sandbox_that_cannot_be_applied_exits(tmp_path):
    """A chroot that fails stops the server rather than serving
    unsandboxed."""
    with pytest.raises(SystemExit, match="Fatal: unable to chroot"):
        tsandbox.make_sandbox(str(tmp_path / "missing"), -1)


@pytest.mark.parametrize("entry", ["make_server", "serve"])
def test_server_without_a_card_raises(monkeypatch, entry):
    """No CPU fallback: without a CUDA device the server does not start
    unless the caller passes device="cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(trest, entry)(0, 0)


def test_launch_counts_hold_under_threads():
    """Served jobs launch from handler threads: the counters lose no
    update under many threads switching every microsecond."""
    kernels.reset_launch_counts()
    per_thread, n_threads = 2000, 8
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=lambda: [kernels.count_launch("gather_patches")
                                               for _ in range(per_thread)])
              for _ in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert kernels.launch_counts()["gather_patches"] == per_thread * n_threads
    kernels.reset_launch_counts()
