"""The port's REST server (nightlight_tpu_torch/serve/rest.py) held to the
committed parity goldens: the black-box jobs of test/parity/*.json POSTed
to ``make_server(0, 1024, device="cpu")`` on scripts/parity.py's 256^2
fixtures (``_make_fixtures``), each streamed log compared with its
``<name>.expected`` by ``diff_logs`` (integers exact, floats within the
harness's CPU band) and each output file's digest with ``<name>.digest`` by
``_diff_digests`` (shape and NaN count exact, mean and std within 2e-3 /
1e-3 relative, the sha256 of the pixels rounded to 1e-3). The harness's
functions are imported from scripts/parity.py as they are; the JAX server
meets the same goldens when ``python scripts/parity.py`` runs.

Two outputs flip their pixel hash on the port's float-order band and are
named in ``HASH_EXCEPTED``; each is held instead against the JAX server's
output of the same job, pixel by pixel:

* ``parity_rgb_out.fits`` (job ``rgb``): within float32 rounding, rtol and
  atol 1e-6 (the balance's sums run in another order; one pixel of
  196,608 rounds to another 1e-3 step);
* ``parity_stack_out.fits`` (job ``stack``): within rtol 1e-5 everywhere
  but the outer ``EDGE`` rows and columns, where at most ``EDGE_OFF`` of
  the pixels may differ more: the transforms come from centroid sums that
  differ at ~1e-5 px from XLA's, which can move a frame's source row of an
  edge pixel across the frame's last row, so the pixel stacks one frame
  more or fewer (one pixel, 0.87 out of 99.65, at row 252)."""

import json
import os
import threading
import urllib.request

import numpy as np
import pytest

from scripts.parity import PARITY_DIR, _diff_digests, _digest_outputs, _make_fixtures, diff_logs

JOBS = ["stats", "stack", "rgb", "rgb_full"]
# job -> (output file, rtol, atol) held against the JAX server's output
HASH_EXCEPTED = {"rgb": ("parity_rgb_out.fits", 1e-6, 1e-6),
                 "stack": ("parity_stack_out.fits", 1e-5, 0.0)}
EDGE = 5       # the frames' drift reaches 4.06 px
EDGE_OFF = 4   # pixels of that border allowed outside the band


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """The port's server and the JAX package's on free ports, the working
    directory (shared: one process) holding the fixtures; yields ({"port":
    url, "jax": url}, directory, fixture names)."""
    from nightlight_tpu.serve.rest import make_server as jax_server
    from nightlight_tpu_torch.serve.rest import make_server

    work = tmp_path_factory.mktemp("parity")
    _make_fixtures(str(work))
    cwd = os.getcwd()
    os.chdir(work)
    running = []
    try:
        for srv in (make_server(0, 1024, device="cpu"), jax_server(0, 1024)):
            thread = threading.Thread(target=srv.serve_forever, daemon=True)
            thread.start()
            running.append((srv, thread))
        urls = {tag: f"http://127.0.0.1:{srv.server_address[1]}/api/v1/job"
                for tag, (srv, _) in zip(("port", "jax"), running)}
        yield urls, str(work), set(os.listdir(work))
    finally:
        for srv, thread in running:
            srv.shutdown()
            thread.join(timeout=30)
        os.chdir(cwd)


def _post(url: str, spec: dict) -> str:
    req = urllib.request.Request(url, data=json.dumps(spec).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=600) as resp:
        return resp.read().decode()


def _run(url: str, spec: dict, work: str, fixtures: set, keep: str | None = None):
    """POST a job; returns (log, digest of its outputs, pixels of `keep`),
    its outputs removed so the next job's digest is its own."""
    from nightlight_tpu.io import fits as jfits

    body = _post(url, spec)
    digest = _digest_outputs(work, fixtures)
    pixels = None
    if keep is not None:
        pixels = np.asarray(jfits.read_file(os.path.join(work, keep), to_device=False).data,
                            np.float64)
    for fn in set(os.listdir(work)) - fixtures:
        os.unlink(os.path.join(work, fn))
    return body, digest, pixels


@pytest.mark.parametrize("name", JOBS)
def test_port_server_meets_the_golden(servers, name):
    """One golden job through the port's server: no log line outside the
    harness's band and no digest mismatch, the pixel hash included but for
    the outputs of HASH_EXCEPTED, which are held against the JAX server's
    within their band."""
    urls, work, fixtures = servers
    with open(os.path.join(PARITY_DIR, f"{name}.json")) as fh:
        spec = json.load(fh)
    out, rtol, atol = HASH_EXCEPTED.get(name, (None, 0.0, 0.0))
    body, digest, got = _run(urls["port"], spec, work, fixtures, out)
    with open(os.path.join(PARITY_DIR, f"{name}.expected")) as fh:
        want = fh.read()
    with open(os.path.join(PARITY_DIR, f"{name}.digest")) as fh:
        want_digest = json.load(fh)
    assert "Error" not in body, body[-2000:]
    problems = diff_logs(body, want) + _diff_digests(digest, want_digest)
    if out is not None:
        problems = [p for p in problems if not p.startswith(f"digest: {out}: pixel hash")]
        _, _, ref = _run(urls["jax"], spec, work, fixtures, out)
        assert got.shape == ref.shape
        off = ~np.isclose(got, ref, rtol=rtol, atol=atol)
        inner = off[..., EDGE:-EDGE, EDGE:-EDGE]
        assert not inner.any(), np.argwhere(inner)[:5]
        assert off.sum() <= EDGE_OFF, np.argwhere(off)[:5]
    assert not problems, "\n".join(problems[:20])
