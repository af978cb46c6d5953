"""Faults planted under the timed path, for the tests that show the
comparison catches them and for reading their numbers on the card:

- "half": every stack call sees only the first half of its frames, the
  mean taken over the rest;
- "altered": the stacked value of the first 2% of pixels comes out 1% too
  high, where the stacking kernel's wrapper produces it;
- "exchange": the exchange between cards left out, for a sharded job
  (`-shard`): every all-gather to the lead card (parallel/mesh.py,
  RowSharded.gather) takes the lead's own rows and zeros for every other
  card's.

A stack job has no state carried between steps, so the fault of a step
that returns its state unchanged has nothing to break; on one card the
"exchange" fault has none either.
"""

from __future__ import annotations

import contextlib

import torch

from benchmark_torch import phases

TARGETS = (("nightlight_tpu_torch.ops.stack_cuda", "stack_sigma"),
           ("nightlight_tpu_torch.ops.stack_cuda", "stack_linfit"))
GATHER = (("nightlight_tpu_torch.parallel.mesh", "RowSharded.gather"),)


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


def _exchange(fn, target):
    def broken(self, *args, **kwargs):
        if self.replicated:
            return fn(self, *args, **kwargs)
        lead = self.mesh.lead
        blocks = [self.blocks[0].to(lead)]
        blocks += [torch.zeros(b.shape, dtype=b.dtype, device=lead) for b in self.blocks[1:]]
        return torch.cat(blocks, dim=-2)
    return broken


# name: (what it patches, how)
FAULTS = {"half": (TARGETS, _half), "altered": (TARGETS, _altered),
          "exchange": (GATHER, _exchange)}


@contextlib.contextmanager
def planted(name: str | None):
    if not name:
        yield
        return
    with phases.patched(*FAULTS[name]):
        yield
