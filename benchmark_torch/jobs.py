"""The jobs of a cell, as its users run them, through the port's entry
points: the CLI's main (one `stack` per entry of the traffic's "runs", in
one job) or a JSON job POSTed to the port's REST server, which runs on a
thread of this process, the job ending with the end of its chunked log.

Each job writes its outputs under names of its own, so that every job's
stacked FITS can be compared once the window has closed. The program's log goes to a file in
the working directory, not to the benchmark's output.
"""

from __future__ import annotations

import contextlib
import http.client
import json
import threading


def outputs(traffic: dict, k: int) -> list:
    """The stacked FITS files of job k: one per run of the traffic."""
    return [f"job{k:04d}_{j}.fits" for j in range(len(traffic.get("runs", [None])))]


class CliJobs:
    """Job k runs `cli.main(["-out", "job<k>_<j>.fits", *argv_j])` for each
    run j of the traffic, in order."""

    def __init__(self, traffic: dict, device, log):
        from nightlight_tpu_torch import cli

        self.cli = cli
        self.runs = [r["argv"] for r in traffic["runs"]]
        self.device = device
        self.log = log

    def run(self, k: int) -> bool:
        """True when every run of job k returned 0."""
        ok = True
        for out, argv in zip(outputs({"runs": self.runs}, k), self.runs):
            with contextlib.redirect_stdout(self.log):
                rc = self.cli.main(["-out", out, *argv], device=self.device)
            ok = ok and rc == 0
        return ok

    def close(self) -> None:
        pass


def _substitute(node, out: str):
    """`node` with every "{out}" in its strings replaced by `out`."""
    if isinstance(node, dict):
        return {k: _substitute(v, out) for k, v in node.items()}
    if isinstance(node, list):
        return [_substitute(v, out) for v in node]
    if isinstance(node, str):
        return node.replace("{out}", out)
    return node


class ServedJobs:
    """Job k POSTs the traffic's JSON job, its "{out}" replaced by
    "job<k>_0", to the port's server on 127.0.0.1; the next POST goes when
    the chunked log has ended. A log with an error line is a failed job."""

    def __init__(self, traffic: dict, device, log):
        from nightlight_tpu_torch.serve import rest

        self.job = traffic["job"]
        self.log = log
        self.server = rest.make_server(0, int(traffic.get("st_memory", 0)), device=device)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        self.port = self.server.server_address[1]

    def run(self, k: int) -> bool:
        body = json.dumps(_substitute(self.job, f"job{k:04d}_0"))
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=600)
        try:
            conn.request("POST", "/api/v1/job", body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            text = resp.read().decode("utf-8", "replace")
            status = resp.status
        finally:
            conn.close()
        self.log.write(text)
        return status == 200 and "Error" not in text

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=60)


KINDS = {"cli": CliJobs, "served": ServedJobs}


def make_jobs(traffic: dict, device, log):
    return KINDS[traffic["kind"]](traffic, device, log)
