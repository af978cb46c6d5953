"""The device trace of whole jobs: which seconds each card was busy, the
device time of each kernel, the calls' shapes for the roofline, and what
the host was doing in each idle gap.

Jobs run under torch.profiler (CPU and CUDA activities) with the phase
functions' calls timed on the host (no synchronisation added). A card's
busy seconds are the union of the intervals of its own kernels, copies and
sets; the window is the host's wall around the profiled jobs, which starts
and ends with every card of the cell idle.

On more than one card (a sharded job):
- busy_s is the mean of the cards' busy seconds, so that the idle share
  (metrics/device.idle.py) is the mean of the cards' idle shares: how long
  a card waits, where the union of all cards would read "some card busy"
  and hide three idle cards behind one busy one; busy_s_by_card lists each;
- the breakdown's idle gaps are the gaps in which no card is busy, booked
  to what the host was doing;
- a kernel's device seconds, and the breakdown's device operations, are
  summed over the cards: a sharded stack makes one call a shard, each with
  its own bound, so the roofline share stays the calls' bounds over their
  device time.
With one card every one of these is the one-card reading.
"""

from __future__ import annotations

import contextlib
import time

import torch

from benchmark_torch import cards as cardlist
from benchmark_torch import phases, roofline

# the wrappers whose calls a roofline needs: (module, attribute, kernel)
KERNEL_CALLS = (("nightlight_tpu_torch.ops.stack_cuda", "stack_sigma_cuda", "stack_clip"),
                ("nightlight_tpu_torch.ops.stack_cuda", "stack_linfit_cuda", "stack_linfit"),
                ("nightlight_tpu_torch.ops.gather_cuda", "gather_patches_cuda",
                 "gather_patches"))


@contextlib.contextmanager
def calls_recorded(calls: list):
    """Append (kernel, bytes, operations) of each kernel wrapper call to
    `calls`. A gather's in-frame element count is read from its mask after
    the jobs (the entry is then (kernel, mask, k, radius))."""
    names = {(m, a): k for m, a, k in KERNEL_CALLS}

    def record(fn, target):
        kernel = names[target]

        def recorded(*args, **kwargs):
            out = fn(*args, **kwargs)
            if kernel == "gather_patches":
                _, cys, _, radius = args[:4]
                calls.append((kernel, out[1], int(cys.shape[0]), int(radius)))
            else:
                frames = args[0]
                n, p = frames.shape
                weighted = (args[4] if len(args) > 4 else kwargs.get("weights")) is not None
                winsorize = bool(args[5] if len(args) > 5 else kwargs.get("winsorize", False))
                calls.append((kernel, *roofline.stack_work(kernel, n, p, weighted, winsorize)))
            return out
        return recorded

    with phases.patched([(m, a) for m, a, _ in KERNEL_CALLS], record):
        yield


def bounds_by_kernel(calls: list) -> dict:
    """{kernel: (calls, summed bound seconds)}."""
    out = {}
    for entry in calls:
        kernel = entry[0]
        if kernel == "gather_patches":
            _, ok, k, radius = entry
            nbytes, ops = roofline.gather_work(k, radius, int(ok.sum()))
        else:
            _, nbytes, ops = entry
        n, total = out.get(kernel, (0, 0.0))
        out[kernel] = (n + 1, total + roofline.bound_s(nbytes, ops))
    return out


CLOCK_MARK = "benchmark:clock"


def _device_events(prof):
    """(name, card, start_ns, end_ns) of every kernel, copy and set on a
    card (its CUDA device index), and the start of the CLOCK_MARK range on
    the trace's clock."""
    device, clock = [], None
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns()
        if e.device_type() == cuda:
            # a range's mirror on the device timeline is no device work
            if name != CLOCK_MARK and not getattr(e, "is_user_annotation", lambda: False)():
                device.append((name, e.device_index(), start, start + e.duration_ns()))
        elif name == CLOCK_MARK:
            clock = start
    return device, clock


def short_name(name: str) -> str:
    """A kernel's name without its trailing argument list, at most 160
    letters."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i > 0 else name
                break
    return name.strip()[:160]


def union(intervals):
    """Sorted, merged [start, end] intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def busy_by_card(device, n: int):
    """(the mean of cards 0 .. n-1's busy seconds, each card's): a card's
    are the union of its own operations' intervals ((name, card, start_ns,
    end_ns) events); a card with none counts in the mean at 0."""
    by_card = [sum(e - s for s, e in union([(s, e) for _, k, s, e in device if k == card]))
               * 1e-9 for card in range(n)]
    return sum(by_card) / n, by_card


def idle_by_phase(merged, marks, t0: int, t1: int) -> dict:
    """Seconds of the gaps between busy intervals within [t0, t1], each
    booked to the innermost phase range around its midpoint ("no phase"
    outside every range)."""
    gaps, prev = [], t0
    for s, e in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if t1 > prev:
        gaps.append((prev, t1))
    # one sweep over the nested ranges, sorted by start, and the gaps'
    # midpoints in order: the open ranges form a stack
    order = sorted(marks, key=lambda m: (m[1], -m[2]))
    out, open_, i = {}, [], 0
    for s, e in gaps:
        mid = (s + e) // 2
        while i < len(order) and order[i][1] <= mid:
            while open_ and open_[-1][2] < order[i][1]:
                open_.pop()
            open_.append(order[i])
            i += 1
        while open_ and open_[-1][2] < mid:
            open_.pop()
        label = open_[-1][0] if open_ else "no phase"
        out[label] = out.get(label, 0.0) + (e - s) * 1e-9
    return out


def profile_jobs(run_job, targets: dict, min_seconds: float, cards: list) -> dict:
    """Run whole jobs under the profiler until min_seconds have passed (one
    at least), waiting for every card of `cards` (the cell's) before and
    after. Returns the busy seconds (the cards' mean) and each card's, the
    window seconds, the device seconds and summed bounds of each kernel,
    and the breakdown."""
    calls, marks = [], []
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        # the marks' clock against the trace's: one range at a known time
        mine = time.time_ns()
        with torch.profiler.record_function(CLOCK_MARK):
            pass
        with phases.phases_marked(targets, marks), calls_recorded(calls):
            cardlist.synchronize(cards)
            t0 = time.perf_counter()
            jobs = 0
            while True:
                run_job()
                jobs += 1
                if time.perf_counter() - t0 >= min_seconds:
                    break
            cardlist.synchronize(cards)
            window_s = time.perf_counter() - t0
    device, clock = _device_events(prof)
    if not device:
        raise RuntimeError("the device trace holds no device operation")
    offset = clock - mine if clock is not None else 0
    marks = [(name, s + offset, e + offset) for name, s, e in marks]
    # no card of the cell busy: the idle gaps and the trace's span
    merged = union([(s, e) for _, _, s, e in device])
    busy_s, by_card = busy_by_card(device, len(cards))
    # the trace's own span of the jobs: the host ranges and the device work
    t_lo = min([s for _, s, _ in marks] + [merged[0][0]])
    t_hi = max([e for _, _, e in marks] + [merged[-1][1]])
    by_name = {}
    for name, _, s, e in device:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-9
    kernels = {}
    for kernel, (n, bound) in bounds_by_kernel(calls).items():
        sub = roofline.TRACE_NAMES[kernel]
        kernels[kernel] = {"calls": n, "bound_s": bound,
                           "device_s": sum(v for k, v in by_name.items() if sub in k)}
    idle = idle_by_phase(merged, marks, t_lo, t_hi)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    top = [(short_name(k), v) for k, v in top]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"jobs": jobs, "busy_s": busy_s, "busy_s_by_card": by_card,
            "window_s": window_s, "kernels": kernels,
            "breakdown": {"device_ops": [[k, v] for k, v in top],
                          "idle_gaps": [[k, v] for k, v in gaps]}}
