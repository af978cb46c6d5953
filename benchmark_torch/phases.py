"""Exclusive seconds per layer of the port, booked per job, measured from
outside the program: each wrapped function synchronises the card on entry
and exit and books its time to its phase, less the time of phases nested
inside it (star detection inside the fused preprocess, for example).

A copy of nightlight_tpu_torch/scripts/phase_split.py's PhaseClock and
phases_wrapped, with the phases given by the per-layer metric files
(metrics/<name>.py: PHASE and WRAPS) instead of a table, a stack per thread
(a served job runs on the server's handler thread, the read-ahead loader
on threads of its own), and the first entry and last exit of each job.

The synchronisations add waits, so the clock runs only in traced runs; the
device trace (profile.py) is taken with it off. Each waits for every card of
the cell, since a sharded job queues work on all of them.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import sys
import threading
import time

import torch

from benchmark_torch import cards as cardlist

PACKAGE = "nightlight_tpu_torch"


class PhaseClock:
    """Exclusive seconds and entries per phase of the wrapped functions,
    and the span from the first entry to the last exit of the current
    job. With `sync`, each entry and exit first waits for `cards` (every
    visible card by default)."""

    def __init__(self, phases, sync: bool = True, cards=None):
        self.seconds = {name: 0.0 for name in phases}
        self.entries = {name: 0 for name in phases}
        self.sync = sync and torch.cuda.is_available()
        self.cards = list(cardlist.visible() if cards is None else cards)
        self._local = threading.local()
        self._lock = threading.Lock()
        self.first_entry = self.last_exit = None

    def start_job(self) -> None:
        self.first_entry = self.last_exit = None

    def _stack(self):
        if not hasattr(self._local, "stack"):
            self._local.stack = []  # [phase, start, seconds of nested phases]
        return self._local.stack

    def wrap(self, phase, fn):
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            stack = self._stack()
            if self.sync:
                cardlist.synchronize(self.cards)
            start = time.perf_counter()
            with self._lock:
                if self.first_entry is None:
                    self.first_entry = start
            stack.append([phase, start, 0.0])
            try:
                return fn(*args, **kwargs)
            finally:
                if self.sync:
                    cardlist.synchronize(self.cards)
                _, start, nested = stack.pop()
                end = time.perf_counter()
                spent = end - start
                with self._lock:
                    self.seconds[phase] += spent - nested
                    self.entries[phase] += 1
                    self.last_exit = end
                if stack:
                    stack[-1][2] += spent
        return timed


def _resolve(mod_name: str, path: str):
    owner = importlib.import_module(mod_name)
    *outer, name = path.split(".")
    for part in outer:
        owner = getattr(owner, part)
    return owner, name, outer


@contextlib.contextmanager
def patched(targets, make):
    """Replace each (module, attribute path) of `targets` by make(original,
    target) wherever the port holds a reference to it (its module, its
    class, and modules that imported it by name); restore them on exit."""
    undo = []
    for target in targets:
        owner, name, outer = _resolve(*target)
        original = getattr(owner, name)
        replacement = make(original, target)
        holders = [(owner, name)]
        if not outer:
            holders += [(m, attr) for m in list(sys.modules.values())
                        if getattr(m, "__name__", "").startswith(PACKAGE) and m is not owner
                        for attr, v in list(vars(m).items()) if v is original]
        for holder, attr in holders:
            setattr(holder, attr, replacement)
            undo.append((holder, attr, original))
    try:
        yield
    finally:
        for holder, attr, original in reversed(undo):
            setattr(holder, attr, original)


def phase_targets(metrics) -> dict:
    """{phase: [(module, attribute path)]} of the metric modules that name a
    PHASE and its WRAPS."""
    out = {}
    for m in metrics:
        phase = getattr(m, "PHASE", None)
        if phase and getattr(m, "WRAPS", None):
            out.setdefault(phase, [])
            out[phase] += [tuple(t) for t in m.WRAPS if tuple(t) not in out[phase]]
    return out


@contextlib.contextmanager
def phases_wrapped(clock: PhaseClock, targets: dict):
    """Every function of `targets` timed by `clock` under its phase."""
    by_target = {t: phase for phase, ts in targets.items() for t in ts}
    with patched(list(by_target), lambda fn, t: clock.wrap(by_target[t], fn)):
        yield


@contextlib.contextmanager
def phases_marked(targets: dict, marks: list):
    """Every function of `targets` appends (phase, start_ns, end_ns) of each
    call to `marks`, on whatever thread it runs (a served job runs on the
    server's handler thread, which the profiler's own ranges do not
    reach), with no synchronisation, so the device trace can say which
    phase the host was in during each idle gap."""
    by_target = {t: phase for phase, ts in targets.items() for t in ts}

    def mark(fn, t):
        phase = by_target[t]

        @functools.wraps(fn)
        def marked(*args, **kwargs):
            start = time.time_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                marks.append((phase, start, time.time_ns()))
        return marked

    with patched(list(by_target), mark):
        yield
