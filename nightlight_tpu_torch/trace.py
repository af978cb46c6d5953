"""Spans and counters of the port, kept in memory.

A span is one timed stretch of work at a layer boundary: its name, its
start and end on ``time.perf_counter_ns()``, the span it nests in (the
innermost open span of the same thread, else none), its thread, and the
id of the command it serves: one CLI command or one served request, shared
by the work that command starts on other threads (the read-ahead loader's
workers, which carry the id and have no parent).

    with trace.command():              # one command: a new id and its span
        with trace.span("detect"):     # or @trace.span("detect") on a function
            n = int(trace.to_host(t))  # a blocking read, counted and timed

Spans are recorded only while something listens: ``recording()`` (the CLI's
``-trace DIR``, tests, scripts) or a ``torch.profiler`` session anywhere in
the process (``torch.autograd.profiler._is_profiler_enabled`` is
process-wide, so a served job's handler thread is recorded too). Otherwise
a span costs one flag test and a push and pop of its name on its thread's
stack, which allocates nothing; the name stack is what keys the counters
below by layer. ``records()`` returns what was recorded, ``clear()`` drops it.

Counters are always on. ``count(name, key)`` adds to the tracer's own:
``host.reads`` (blocking host reads by the innermost layer span),
``detect.candidates`` (the candidates that survive detection's phase 2,
those its phases 3-6 work on), ``load.inline_reads`` (frames a
read-ahead loader's consumer read itself, over every loader; each loader
keeps its own ``inline_reads`` besides), ``stack.batches`` (the batches
each stack plans, keyed "mesh" where the plan counted the mesh's devices,
else "device") and ``mesh.bytes`` (bytes copied between the shards of a
device mesh, counted from shapes, by gather site, "halo" and "rows").
The counters that other modules keep under their own names
(``kernels.launch_counts()``, ``parallel.mesh.GATHERS``) are read through
``source`` where they live, never copied: ``counters()`` returns them all.

A blocking read is a device-to-host copy, a read of a value (``int(t)``,
``float(t)``, ``.tolist()``), an op whose output size the host must learn
(``nonzero``, ``masked_select``), or an upload from pageable host memory,
which waits for the card's queue as a read does (torch copies a pageable
buffer and then synchronises the stream). ``to_host(t)`` makes the copy,
``upload(value, device)`` the upload, ``with host_read(device):`` wraps
any other. Each counts the read when the device is a card and opens a
``host_read`` span while recording.

``write_chrome_trace`` adds a command's spans and the counters to the
profiler's ``trace.json``, on the profiler's clock: the offset between the
two clocks comes from two anchor ranges, each opened at a known
``perf_counter_ns()`` (``anchor``), at the start and the end of the trace.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import json
import os
import threading
import time
from typing import NamedTuple

import torch
import torch.autograd.profiler as _profiler

# the layer spans: the boundaries that the per-layer metrics read
LAYERS = frozenset(("load", "preprocess", "perframe", "detect", "align", "warp", "stack",
                    "save"))
ANCHOR = "nightlight.anchor"


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None
    thread: int
    thread_name: str
    command: int | None


class _Open:
    """A recorded span while it is open."""

    __slots__ = ("name", "id", "parent", "start")

    def __init__(self, name: str, id_: int, parent, start: int):
        self.name, self.id, self.parent, self.start = name, id_, parent, start


class _Local(threading.local):
    def __init__(self):
        self.stack = []  # the open spans: a name when unrecorded, else an _Open
        self.command = None  # the id of the command this thread works for


_local = _Local()
_listeners = 0
_records: list[Span] = []
_ids = itertools.count(1)
_issued = 0  # commands begun in this process, the last one's id
_lock = threading.Lock()
_counts: dict[str, collections.Counter] = {}
_sources: dict = {}


def is_recording() -> bool:
    return bool(_listeners or _profiler._is_profiler_enabled)


@contextlib.contextmanager
def recording():
    """Record spans inside the block (nested and threaded uses add up)."""
    global _listeners
    with _lock:
        _listeners += 1
    try:
        yield
    finally:
        with _lock:
            _listeners -= 1


def records() -> list[Span]:
    """The spans recorded so far, each appended when it ended."""
    return list(_records)


def clear() -> None:
    """Drop the recorded spans (the counters stay)."""
    del _records[:]


def _push(name: str) -> None:
    stack = _local.stack
    if _listeners or _profiler._is_profiler_enabled:
        parent = None
        for e in reversed(stack):
            if type(e) is _Open:
                parent = e.id
                break
        stack.append(_Open(name, next(_ids), parent, time.perf_counter_ns()))
    else:
        stack.append(name)


def _pop() -> None:
    top = _local.stack.pop()
    if type(top) is _Open:
        end = time.perf_counter_ns()
        th = threading.current_thread()
        _records.append(Span(top.name, top.start, end, top.id, top.parent, th.ident, th.name,
                             _local.command))


class span:
    """``with span(name):`` or ``@span(name)``: one span around a block or
    each call of a function. One object may serve any number of threads
    and nested uses: what a use holds lives on its thread's stack."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        _push(self.name)
        return self

    def __exit__(self, *exc) -> bool:
        _pop()
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            _push(name)
            try:
                return fn(*args, **kwargs)
            finally:
                _pop()
        return spanned


def layer() -> str:
    """The innermost open layer span of this thread, else the innermost
    span ("command", "request", ...), else "none"."""
    stack = _local.stack
    for e in reversed(stack):
        name = e if type(e) is str else e.name
        if name in LAYERS:
            return name
    if stack:
        top = stack[-1]
        return top if type(top) is str else top.name
    return "none"


@contextlib.contextmanager
def command(name: str = "command"):
    """A `name` span around one command; the command gets a new id unless
    this thread already works for one (a served request's job), and yields
    the id."""
    global _issued
    outer = _local.command
    if outer is None:
        with _lock:
            _issued += 1
            _local.command = _issued
    try:
        with span(name):
            yield _local.command
    finally:
        _local.command = outer


def commands_issued() -> int:
    """Commands begun in this process (each CLI command, each served
    request), recording or not."""
    return _issued


def current_command():
    return _local.command


@contextlib.contextmanager
def in_command(command_id):
    """Work of this thread inside the block belongs to `command_id` (a
    thread that a command started)."""
    outer = _local.command
    _local.command = command_id
    try:
        yield
    finally:
        _local.command = outer


def count(name: str, key: str = "", n: int = 1) -> None:
    with _lock:
        c = _counts.get(name)
        if c is None:
            c = _counts[name] = collections.Counter()
        c[key] += n


def counter(name: str) -> dict:
    """{key: count} of one of the tracer's own counters."""
    with _lock:
        return dict(_counts.get(name, ()))


def source(name: str, read) -> None:
    """Export the counter `name` from where it lives: read() returns a
    {key: count} mapping."""
    _sources[name] = read


def counters() -> dict:
    """{counter: {key: count}}: the tracer's own and the sources'."""
    with _lock:
        out = {name: dict(c) for name, c in _counts.items()}
    for name, read in list(_sources.items()):
        out[name] = dict(read())
    return out


def _on_card(device) -> bool:
    return device is None or torch.device(device).type != "cpu"


class _HostRead:
    """The host_read span and the host.reads count of one blocking read."""

    __slots__ = ()

    def __enter__(self):
        count("host.reads", layer())
        _push("host_read")
        return self

    def __exit__(self, *exc) -> bool:
        _pop()
        return False


_HOST_READ = _HostRead()
_NOT_BLOCKING = contextlib.nullcontext()


def host_read(device=None):
    """``with host_read(device):`` around a read hidden in a torch op
    (nonzero, a value read, a pageable upload); counted unless `device` is
    the CPU (no device: counted)."""
    return _HOST_READ if _on_card(device) else _NOT_BLOCKING


def to_host(t):
    """t.to("cpu"), counted and timed as a blocking read when t is on a
    card; the values are t's. A value that is no tensor passes through."""
    if not isinstance(t, torch.Tensor):
        return t
    with host_read(t.device):
        return t.to("cpu")


def _tensor(value, device, dtype) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=dtype)
    return torch.tensor(value, dtype=dtype, device=device)


def upload(value, device, dtype=None) -> torch.Tensor:
    """A copy of `value` (a number, a list, an array, a tensor) on
    `device`, as torch.tensor(value, dtype=dtype, device=device) makes it
    (a tensor: value.to(device, dtype)). A host value copied to a card from
    pageable memory waits for the card's queue first: counted and timed as
    a blocking read, and in host.uploads besides. A tensor already on a
    card is not."""
    if not _on_card(device) or (isinstance(value, torch.Tensor)
                                and value.device.type != "cpu"):
        return _tensor(value, device, dtype)
    count("host.uploads", layer())
    with _HOST_READ:
        return _tensor(value, device, dtype)


def self_ns(recs) -> dict:
    """{span id: its duration less the time its children cover} (the
    children of a span are on its thread)."""
    out = {s.id: s.end_ns - s.start_ns for s in recs}
    for s in recs:
        if s.parent in out:
            out[s.parent] -= s.end_ns - s.start_ns
    return out


# -- the profiler's trace file -------------------------------------------


def anchor(label: str) -> tuple:
    """(label, perf_counter_ns()) of an anchor range opened at once, for
    write_chrome_trace to find in the profiler's events."""
    name = f"{ANCHOR}.{label}"
    # the first range of a session pays its set-up between the clock read
    # and the range's own start: a throwaway range takes it
    with torch.profiler.record_function(name + ".warmup"):
        pass
    t = time.perf_counter_ns()
    with torch.profiler.record_function(name):
        pass
    return label, t


def _lane(thread: int) -> int:
    """The trace's lane of a thread's spans, apart from its torch ops."""
    return 1_000_000_000 + thread % 1_000_000_000


def write_chrome_trace(path: str, anchors, command_id=None) -> dict:
    """Add the spans of `command_id` (every span when None) and the
    counters to the profiler's chrome trace at `path`: one complete event
    a span in a lane per thread, each counter's keys as a counter event at
    the end anchor, and under "nightlight" the anchors' offsets and their
    drift. Times go onto the trace's clock by the line through the two
    anchors. Returns the "nightlight" entry."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    found = {}
    for e in events:
        name = e.get("name", "")
        # the host's range, not its mirror on a device's timeline
        if (name.startswith(ANCHOR + ".") and e.get("ph") == "X"
                and not str(e.get("cat", "")).startswith("gpu")):
            found[name[len(ANCHOR) + 1:]] = float(e["ts"]) * 1e3
    pts = [(t, found[label] - t) for label, t in anchors if label in found]
    if not pts:
        raise ValueError(f"{path}: no anchor range in the trace")
    (t0, off0), (t1, off1) = pts[0], pts[-1]
    slope = (off1 - off0) / (t1 - t0) if t1 != t0 else 0.0

    def ts(t_ns: int) -> float:
        return (t_ns + off0 + slope * (t_ns - t0)) / 1e3

    pid = os.getpid()
    spans = [s for s in records() if command_id is None or s.command == command_id]
    lanes = {}
    for s in spans:
        lanes.setdefault(s.thread, s.thread_name)
        events.append({"ph": "X", "cat": "nightlight", "name": s.name, "pid": pid,
                       "tid": _lane(s.thread), "ts": ts(s.start_ns),
                       "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": {"command": s.command, "id": s.id, "parent": s.parent}})
    for thread, name in lanes.items():
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": _lane(thread),
                       "args": {"name": f"nightlight spans: {name}"}})
    totals = counters()
    for name, keys in totals.items():
        if keys:
            events.append({"ph": "C", "name": name, "pid": pid, "ts": ts(t1),
                           "args": keys})
    meta = {"anchors": {label: {"perf_counter_ns": t, "offset_ns": found[label] - t}
                        for label, t in anchors if label in found},
            "drift_ns": off1 - off0, "command": command_id, "spans": len(spans),
            "counters": totals}
    doc["nightlight"] = meta
    with open(path, "w") as f:
        json.dump(doc, f)
    return meta

