"""Sort-and-sum of the sort-network microbenchmarks: kernels K5 (two
layouts) and K6 (a sweep of the tile) beside their plain PyTorch version.

The CUDA source is ``csrc/sort_sum.cu``; it replaces the Pallas kernels of
scripts/microbench_layout.py (``run_flat``, ``run_8x``) and
scripts/microbench_tile.py (``make_run(tile).run``). Per pixel of a (40, P)
float32 block: sort the column, then sum sorted row 0 and the rows 1..39
that are below 3.0e38, in row order -- the per-pixel "sort the frame
column, then reduce it" work that bounds the stacking kernels K1 and K3.

The wrapper runs the plain version only for a tensor on the CPU. A CUDA
tensor goes to the kernel, or the wrapper raises.
"""

from __future__ import annotations

import torch

from nightlight_tpu_torch import kernels

ROWS = 40
BIG = 3.0e38
LAYOUTS = {"column": 0, "tiled": 1}
BLOCK_SIZES = (128, 256, 512, 1024)


def _check(x: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape[0] != ROWS:
        raise ValueError(f"sort_sum: expected ({ROWS}, P) rows, got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise ValueError(f"sort_sum: expected float32, got {x.dtype}")


def sort_sum_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version (scripts/microbench_layout.py _sort_sum_rows): the TPU
    network pads the columns to 64 rows of 3.0e38, which sort after the 40
    real rows and are never summed, so sorting the 40 rows gives the same
    rows 0..39; then sorted[0] plus each later row with its 3.0e38 entries
    as 0, accumulated row by row in float32. Returns (P,)."""
    s = torch.sort(x, dim=0).values
    acc = s[0]
    for i in range(1, x.shape[0]):
        acc = acc + torch.where(s[i] >= BIG, 0.0, s[i])
    return acc


def sort_sum(x: torch.Tensor, layout: str = "column", threads: int = 256) -> torch.Tensor:
    """Sort-and-sum of each column of x (40, P); `layout` and `threads`
    (threads per block, the tile of the tiled layout) select the kernel
    variant and are not used by the plain version."""
    _check(x)
    if x.device.type == "cpu":
        return sort_sum_plain(x)
    return sort_sum_cuda(x, layout, threads)


def sort_sum_cuda(x: torch.Tensor, layout: str = "column", threads: int = 256) -> torch.Tensor:
    kernels.require_cuda(x, "sort_sum", torch.float32)
    _check(x)
    if layout not in LAYOUTS:
        raise ValueError(f"sort_sum: unknown layout {layout!r}, expected one of {list(LAYOUTS)}")
    if threads not in BLOCK_SIZES:
        raise ValueError(f"sort_sum: threads per block {threads} not in {BLOCK_SIZES}")
    p = int(x.shape[1])
    out = torch.empty(p, dtype=torch.float32, device=x.device)
    err = kernels.library().nl_sort_sum(x.data_ptr(), p, LAYOUTS[layout], int(threads),
                                        out.data_ptr(), kernels.stream_handle(x.device))
    kernels.check(err, "sort_sum")
    kernels.count_launch("sort_sum")
    return out
