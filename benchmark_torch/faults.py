"""Faults planted under the timed path, for the tests that show the
comparison catches them and for reading their numbers on the card:

- "half": every stack call sees only the first half of its frames, the
  mean taken over the rest;
- "altered": the stacked value of the first 2% of pixels comes out 1% too
  high, where the stacking kernel's wrapper produces it.

A stack job on one card has no state carried between steps and no exchange
between cards, so the other faults of the list have nothing to break.
"""

from __future__ import annotations

import contextlib

from benchmark_torch import phases

TARGETS = (("nightlight_tpu_torch.ops.stack_cuda", "stack_sigma"),
           ("nightlight_tpu_torch.ops.stack_cuda", "stack_linfit"))


def _half(fn, target):
    def broken(frames, *args, **kwargs):
        return fn(frames[:max(1, frames.shape[0] // 2)].contiguous(), *args, **kwargs)
    return broken


def _altered(fn, target):
    def broken(frames, *args, **kwargs):
        out, lo, hi = fn(frames, *args, **kwargs)
        out = out.clone()
        out[:max(1, out.numel() // 50)] *= 1.01
        return out, lo, hi
    return broken


FAULTS = {"half": _half, "altered": _altered}


@contextlib.contextmanager
def planted(name: str | None):
    if not name:
        yield
        return
    with phases.patched(TARGETS, FAULTS[name]):
        yield
