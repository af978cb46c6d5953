"""Per-command values of the program's own spans and counters
(nightlight_tpu_torch/trace.py) in the profiled jobs of a traced run.

The profiler's session (profile.py) switches the program's recording on,
so the spans recorded in the process are those of the profiled jobs. A
command is one CLI `stack` (osc16.rgb.n20's job runs three) or one served
request; every value is a sum over the profiled commands over their
number.

A layer's seconds are the exclusive seconds of its spans: a span's
duration less the layer spans, and the command and request spans, nested
inside it on its thread. Sub-spans (load.wait, save.fetch, host_read, ...)
stay in the layer around them. So the layer spans, the command's own
seconds ("rest") and the request's own seconds sum to the requests' (else
the commands') wall. The reads counted are the host_read spans on the
commands' own threads (not the read-ahead workers'): every blocking read
the program counts in host.reads opens one while recording.

Without profiled jobs (a run off the card) or on a program without the
tracer, every value is None.
"""

from __future__ import annotations

LAYERS = ("load", "preprocess", "perframe", "detect", "align", "warp", "stack", "save")
TOPS = ("command", "request")


def tracer():
    try:
        from nightlight_tpu_torch import trace
    except ImportError:
        return None
    return trace


def exclusive_ns(trace, spans, boundaries) -> dict:
    """{span id: exclusive ns} of the spans named in `boundaries`: the
    tracer's self time of the tree those spans form, each under the nearest
    boundary span around it on its thread."""
    by_id = {s.id: s for s in spans}

    def outer(s):
        p = by_id.get(s.parent)
        while p is not None and p.name not in boundaries:
            p = by_id.get(p.parent)
        return None if p is None else p.id

    return trace.self_ns([s._replace(parent=outer(s)) for s in spans if s.name in boundaries])


def summary(rec) -> dict | None:
    """{"commands", "wall_s", "covered_s", "layers_s", "rest_s", "request_s",
    "reads", "read_wait_s", "reads_by_layer"} over the profiled commands, or
    None (no profiled jobs, no tracer, no command recorded)."""
    if not rec.get("window_s"):
        return None
    trace = tracer()
    if trace is None:
        return None
    spans = trace.records()
    commands = [s for s in spans if s.name == "command"]
    if not commands:
        return None
    n = len(commands)
    excl = exclusive_ns(trace, spans, set(LAYERS) | set(TOPS))
    by_id = {s.id: s for s in spans}
    seconds = {}
    for s in spans:
        if s.id in excl:
            seconds[s.name] = seconds.get(s.name, 0.0) + excl[s.id] * 1e-9
    tops = [s for s in spans if s.name in TOPS and by_id.get(s.parent) is None]
    threads = {s.thread for s in tops}
    reads = [s for s in spans if s.name == "host_read" and s.thread in threads]
    by_layer = {}
    for s in reads:
        p = by_id.get(s.parent)
        while p is not None and p.name not in LAYERS and p.name not in TOPS:
            p = by_id.get(p.parent)
        name = p.name if p is not None else "none"
        by_layer[name] = by_layer.get(name, 0) + 1
    return {"commands": n,
            "wall_s": sum(s.end_ns - s.start_ns for s in tops) * 1e-9,
            "covered_s": sum(seconds.values()),
            "layers_s": {name: seconds[name] / n for name in LAYERS if name in seconds},
            "rest_s": seconds.get("command", 0.0) / n,
            "request_s": seconds["request"] / n if "request" in seconds else None,
            "reads": len(reads) / n,
            "read_wait_s": sum(s.end_ns - s.start_ns for s in reads) * 1e-9 / n,
            "reads_by_layer": {k: v / n for k, v in by_layer.items()}}


def layer_s(rec, name: str):
    """Exclusive seconds a command of the layer `name`'s spans, or None."""
    s = summary(rec)
    return None if s is None else s["layers_s"].get(name)


def value(rec, field: str):
    s = summary(rec)
    return None if s is None else s[field]


def counter_per_command(rec, name: str):
    """The program's counter `name`, summed over its keys, over the
    commands the process ran (every job of the run: the counters are
    always on), or None."""
    if not rec.get("window_s"):
        return None
    trace = tracer()
    if trace is None or not trace.commands_issued():
        return None
    total = sum(trace.counters().get(name, {}).values())
    return total / trace.commands_issued() if total else None
