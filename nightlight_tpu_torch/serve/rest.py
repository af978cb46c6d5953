"""REST server of the port: POST a JSON job, stream the log back as a
chunked response. Mirror of nightlight_tpu/serve/rest.py (reference:
internal/rest/serve.go): GET / and /index.html serve the web UI, GET
/api/v1/ping health-checks, GET /api/v1/schema describes the operators,
POST /api/v1/job decodes a polymorphic OpSequence and streams the run log as
the plain-text chunked response body, GET /api/v1/files/* serves the working
directory. CORS headers match serve.go:64-78.

Jobs run on the server's device (cuda:0 unless the caller passes another),
one at a time. The card is readied and the kernel library built and loaded
on the main thread before the server answers (warm_device), so no handler
thread builds it and a sandbox applied afterwards needs neither the build
directory nor nvcc.

    python -m nightlight_tpu_torch.cli -port 8080 serve
"""

from __future__ import annotations

import io
import json
import mimetypes
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from nightlight_tpu_torch import kernels
from nightlight_tpu_torch.ops.stats import LSEstimatorMode
from nightlight_tpu_torch.pipeline import materialize_all, op_from_dict
from nightlight_tpu_torch.pipeline.context import default_device, new_context
from nightlight_tpu_torch.serve.schema import operator_schema

# One job at a time: each request handler runs on its own thread, but jobs
# issue device work and mutate working-directory files. The reference leaves
# this racy (serve.go:33 "Not thread safe"); this server serializes instead.
# Waiting requests stream a queued notice, then nothing until the lock is
# theirs.
_job_lock = threading.Lock()


class _ChunkedLogWriter(io.TextIOBase):
    """File-like writer that streams each write as an HTTP chunk, making the
    log the response body (serve.go:108-134)."""

    def __init__(self, wfile):
        self._wfile = wfile
        self._lock = threading.Lock()

    def write(self, s: str) -> int:
        data = s.encode("utf-8", "replace")
        if not data:
            return 0
        with self._lock:
            self._wfile.write(b"%x\r\n" % len(data))
            self._wfile.write(data)
            self._wfile.write(b"\r\n")
            self._wfile.flush()
        return len(s)

    def close_chunks(self) -> None:
        with self._lock:
            self._wfile.write(b"0\r\n\r\n")
            self._wfile.flush()


class JobServer(ThreadingHTTPServer):
    """A threading HTTP server that carries its jobs' settings: the stack
    memory budget in MiB (-stMemory, like rest.stMemory, serve.go:33) and
    the device."""

    def __init__(self, address, st_memory: int, device: torch.device):
        super().__init__(address, Handler)
        self.st_memory = st_memory
        self.device = device


class Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def _cors(self) -> None:
        self.send_header("Access-Control-Allow-Origin", "*")
        self.send_header("Access-Control-Allow-Credentials", "true")
        self.send_header(
            "Access-Control-Allow-Headers",
            "Content-Type, Content-Length, Accept-Encoding, X-CSRF-Token, Authorization, "
            "accept, origin, Cache-Control, X-Requested-With")
        self.send_header("Access-Control-Allow-Methods", "POST, OPTIONS, GET, PUT")

    def do_OPTIONS(self):  # noqa: N802
        self.send_response(204)
        self._cors()
        self.end_headers()

    def do_GET(self):  # noqa: N802
        path = self.path.split("?", 1)[0]
        if path in ("/", "/index.html"):
            self._serve_static("index.html", "text/html")
        elif path == "/api/v1/schema":
            self._send_json(200, operator_schema())
        elif path == "/api/v1/ping":
            self._send_json(200, {"message": "pong"})
        elif path.startswith("/api/v1/files/"):
            self._serve_file(path[len("/api/v1/files/"):])
        elif path.startswith("/js/"):
            self._serve_static(path.lstrip("/"), None)
        else:
            self.send_error(404)

    def _send_json(self, status: int, obj) -> None:
        body = json.dumps(obj).encode()
        self.send_response(status)
        self._cors()
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _serve_static(self, rel: str, content_type):
        base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "web")
        full = os.path.realpath(os.path.join(base, rel))
        # Containment check: reject traversal out of the web asset dir
        # (mirrors the path sandboxing contract of operator.go:258-266).
        if os.path.commonpath([full, os.path.realpath(base)]) != os.path.realpath(base):
            self.send_error(403)
            return
        self._send_file(full, content_type)

    def _serve_file(self, rel: str):
        if os.path.isabs(rel) or ".." in rel:
            self.send_error(403)
            return
        self._send_file(os.path.join(os.getcwd(), rel), None)

    def _send_file(self, full: str, content_type):
        if not os.path.isfile(full):
            self.send_error(404)
            return
        if content_type is None:
            content_type = mimetypes.guess_type(full)[0] or "application/octet-stream"
        with open(full, "rb") as f:
            body = f.read()
        self.send_response(200)
        self._cors()
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):  # noqa: N802
        if self.path.split("?", 1)[0] != "/api/v1/job":
            self.send_error(404)
            return
        length = int(self.headers.get("Content-Length", "0"))
        raw = self.rfile.read(length)
        try:
            spec = json.loads(raw)
        except json.JSONDecodeError as e:
            self._send_json(400, {"error": str(e)})
            return

        self.send_response(200)
        self._cors()
        self.send_header("Content-Type", "text/plain")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        log = _ChunkedLogWriter(self.wfile)
        try:
            op = op_from_dict(spec)
        except Exception as e:  # noqa: BLE001 - reported on the stream
            log.write(f"Error making promises: {e}\n")
            log.close_chunks()
            return
        log.write("Arguments:\n" + op.to_json() + "\n")
        # every job on the default estimator, as in the JAX server, whose
        # loaded frames take the job context's estimator, so that `serve
        # -lsEst` reaches no served job there either
        c = new_context(log=log, st_memory=self.server.st_memory,
                        ls_mode=LSEstimatorMode.SCMedianQn, device=self.server.device)
        # Queue, don't reject: a live-stacking client POSTing the next
        # frame's job during a long stack waits its turn. The wait is
        # announced on the stream at once, so the client is not left
        # staring at a silent connection.
        if not _job_lock.acquire(blocking=False):
            log.write("Queued: another job is running; waiting for the device...\n")
            _job_lock.acquire()
        try:
            promises = op.make_promises([], c)
            _, err = materialize_all(promises, forget=True)
            c.finalize()
            if err is not None:
                log.write(f"Error materializing promises: {err}\n")
        except Exception as e:  # noqa: BLE001 - reported on the stream
            log.write(f"Error making promises: {e}\n")
        finally:
            c.close()  # the job's readers stop before the next job starts
            _job_lock.release()
        log.close_chunks()

    def log_message(self, fmt, *args):  # quiet default request logging
        pass


def warm_device(device=None) -> torch.device:
    """Resolve `device` (default cuda:0, which must be present) and ready it
    on the calling thread: on a CUDA device, an allocation creates the
    card's context and kernels.library() builds and loads the kernels.
    Raises when either fails: a server that went on would fail every job."""
    device = torch.device(device) if device is not None else default_device()
    if device.type == "cuda":
        torch.zeros(1, device=device)
        torch.cuda.synchronize(device)
        kernels.library()
    return device


def serve(port: int, st_memory: int, device=None) -> None:
    """Start the REST server on all interfaces (serve.go:36-62); jobs run
    on `device` (default cuda:0, which must be present)."""
    httpd = JobServer(("0.0.0.0", port), st_memory, warm_device(device))
    print(f"Serving on :{port}", flush=True)
    httpd.serve_forever()


def make_server(port: int, st_memory: int, device=None) -> JobServer:
    """Create (but don't run) a server on 127.0.0.1, the device readied as
    serve() does; port 0 picks a free port (server_address)."""
    return JobServer(("127.0.0.1", port), st_memory, warm_device(device))
