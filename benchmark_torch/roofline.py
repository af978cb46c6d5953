"""Operations and bytes of one kernel call, worked out from the shapes its
wrapper was called with, and the published peaks of one NVIDIA H100 SXM.

The counts describe the work of the call, whatever implements it (the
formulas of chip_smoke.py's kernel table, copied here). Bytes: each input
byte read once and each output byte written once. Operations: the fewest a
call of these shapes needs, so a bound computed from them is a floor. A
call's bound is the larger of its bytes at the HBM rate and its operations
at the float32 rate outside the tensor cores; a kernel's roofline share is
the sum of its calls' bounds over the sum of its device time.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12

# kernel (the program's launch counter name) -> the substring of its device
# kernels' names in a profiler trace
TRACE_NAMES = {"stack_clip": "stack_clip", "stack_linfit": "stack_linfit",
               "stack_single_pass": "stack_single_pass", "gather_patches": "gather_patches"}


def batcher_pairs(rows: int) -> int:
    """Compare-exchanges of the odd-even merge sorting network over the
    next power of two wires at or above `rows`, padding comparators
    pruned."""
    wires = 1
    while wires < rows:
        wires *= 2
    count, p = 0, 1
    while p < wires:
        k = p
        while k >= 1:
            j = k % p
            while j + k < wires:
                for i in range(min(k, wires - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p) and i + j + k < rows:
                        count += 1
                j += 2 * k
            k //= 2
        p *= 2
    return count


def bound_s(nbytes: float, ops: float) -> float:
    """The least time the card could take for this work, in seconds."""
    return max(nbytes / PEAK_BYTES_S, ops / PEAK_F32_S)


def stack_work(kernel: str, n: int, p: int, weighted: bool = False, winsorize: bool = False,
               mad: bool = False) -> tuple[float, float]:
    """(bytes, operations) of one stacking call on (n, p) frames. Bytes:
    every sample read once, the result written once, two int64 clip totals.
    Operations per pixel: a sort of the column on the pruned network (a min
    and a max per compare-exchange); for stack_clip 4 a row to centre and
    prefix-sum the column (7 weighted) and one clip round, 16 plus two
    binary searches (winsorized: one application of the fixed point, 32
    plus two binary searches, more); for stack_linfit 3 a sample for the
    first count and sums and one round, 20 plus 24 a sample; for the MAD
    of stack_single_pass 8 a sample. One round is the fewest a pixel runs."""
    nbytes = 4.0 * n * p + 4.0 * p + 16.0
    sort = 2.0 * batcher_pairs(n)
    search = 2.0 * math.ceil(math.log2(n + 1))
    if kernel == "stack_clip":
        extra = (7.0 if weighted else 4.0) * n + 16.0 + search
        extra += (32.0 + search) if winsorize else 0.0
    elif kernel == "stack_linfit":
        extra = 3.0 * n + 20.0 + 24.0 * n
    else:
        extra = 8.0 * n if mad else 0.0
    return nbytes, (sort + extra) * p


def gather_work(k: int, radius: int, in_frame: int) -> tuple[float, float]:
    """(bytes, operations) of one patch gather of k windows of radius r:
    the in-frame elements read once, the (y, x) centres read, the float
    patch and its byte mask written once; a gather does no arithmetic."""
    win = 2 * radius + 1
    return 4.0 * in_frame + 8.0 * k + 5.0 * k * win * win, 0.0
