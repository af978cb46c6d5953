"""The comparison that decides `correct`: each stacked FITS a job saved
against the plain reference's stack of the same lights.

Three numbers per output, each held to its limit from the traffic file:

- gap_p50: the median over pixels of |output - reference|, in units of the
  reference light's scale (its noise). Alignment that misses the true
  transforms by hundredths of a pixel moves it little; rounding every
  stage to bfloat16, or a stack of half the frames, moves it much.
- gap_p99: the 99th percentile of the same. Star cores, where a small
  alignment error moves a pixel most, cover under 1% of a frame; an output
  altered over more than a hundredth of the frame moves it.
- nonfinite_px: pixels finite in one image and not in the other (limit 0).

The worst value over the outputs compared is held to the limit.
"""

from __future__ import annotations

import torch

NAMES = ("gap_p50", "gap_p99", "nonfinite_px")


def numbers(out: torch.Tensor, ref: torch.Tensor, scale: float) -> dict:
    if out.shape != ref.shape:
        raise ValueError(f"output shape {tuple(out.shape)} != reference {tuple(ref.shape)}")
    fo, fr = torch.isfinite(out), torch.isfinite(ref)
    both = fo & fr
    gap = ((out - ref).abs()[both] / float(scale)).sort().values
    n = gap.numel()
    if n == 0:
        return {"gap_p50": float("inf"), "gap_p99": float("inf"),
                "nonfinite_px": int((fo != fr).sum())}
    return {"gap_p50": float(gap[(n - 1) // 2]), "gap_p99": float(gap[int(0.99 * (n - 1))]),
            "nonfinite_px": int((fo != fr).sum())}


def worst(rows: list) -> dict:
    return {name: max(r[name] for r in rows) for name in NAMES}


def verdict(values: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    check = {name: {"value": values[name], "limit": limits[name]} for name in NAMES}
    return all(values[name] <= limits[name] for name in NAMES), check
