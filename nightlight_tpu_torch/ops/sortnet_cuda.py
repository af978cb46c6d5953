"""Sort-and-sum of the sort-network microbenchmarks: kernels K5 (two
layouts) and K6 (a sweep of the tile) beside their plain PyTorch version.

The CUDA source is ``csrc/sort_sum.cu``; it replaces the Pallas kernels of
scripts/microbench_layout.py (``run_flat``, ``run_8x``) and
scripts/microbench_tile.py (``make_run(tile).run``). Per pixel of a (40, P)
float32 block: sort the column, then sum sorted row 0 and the rows 1..39
that are below 3.0e38, in row order -- the per-pixel "sort the frame
column, then reduce it" work that bounds the stacking kernels K1 and K3.

The tiled layout has two designs: ``"bulk_ring"`` (the tiled design: a
persistent grid streams each tile's rows through a ring of shared-memory
stages filled by bulk copies, and every thread sorts its column in
registers; ``ring_plan`` lays it out) and ``"smem_sort"`` (the port's first
design, which sorts each column in shared memory; kept to be timed against
the other).

The wrapper runs the plain version only for a tensor on the CPU. A CUDA
tensor goes to the kernel, or the wrapper raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from nightlight_tpu_torch import kernels
from nightlight_tpu_torch.ops.stack_cuda import (BLOCK_RESERVED_BYTES, BLOCK_SHARED_BYTES,
                                                 SM_SHARED_BYTES)

ROWS = 40
BIG = 3.0e38
LAYOUTS = ("column", "tiled")
TILED_DESIGNS = ("bulk_ring", "smem_sort")
# the C entry's layout codes (csrc/sort_sum.cu nl_sort_sum)
_CODES = {("column", None): 0, ("tiled", "bulk_ring"): 1, ("tiled", "smem_sort"): 2}
BLOCK_SIZES = (128, 256, 512, 1024)

# The ring of the bulk_ring design (csrc/sort_sum.cu sort_sum_ring_kernel):
# a stage holds R of a tile's 40 rows, R one of these (whole stages a tile)
ROWS_PER_STAGE = (40, 20, 10, 8)
# registers a thread of the ring kernel may use (its __launch_bounds__)
RING_REGS = 64
REGS_PER_SM = 65_536
BARRIER_BYTES = 8
# a bulk copy's source, destination and size: multiples of 16 bytes
COPY_ALIGN = 16


class RingPlan(NamedTuple):
    """How the bulk_ring kernel runs over P pixels: threads per block (the
    tile), rows per stage, stages in the ring, bytes of a stage, dynamic
    shared memory per block (the ring, then one barrier a stage), blocks per
    SM and the persistent grid, the path ("bulk": full tiles through the
    ring, a partial last tile by per-thread loads; "per_thread": every tile
    by per-thread loads, when the rows are not 16-byte aligned), the tiles,
    and the leading tiles that go through the ring."""

    threads: int
    rows_per_stage: int
    stages: int
    stage_bytes: int
    smem_bytes: int
    blocks_per_sm: int
    grid: int
    path: str
    tiles: int
    bulk_tiles: int


def ring_target_blocks(threads: int) -> int:
    """Blocks of the ring kernel that an SM's registers hold at RING_REGS a
    thread: 8, 4, 2, 1 at 128, 256, 512, 1024 threads."""
    return max(1, REGS_PER_SM // (RING_REGS * threads))


def ring_shape(threads: int) -> tuple:
    """(rows per stage, stages, shared bytes) of the ring at a tile of
    `threads` columns: the SM's shared memory split among
    ring_target_blocks blocks (each less the runtime's reserve, at most a
    block's limit), and of ROWS_PER_STAGE the one whose ring holds the most
    bytes in at least two stages, ties to the larger stage (fewer
    barriers)."""
    budget = min(BLOCK_SHARED_BYTES,
                 SM_SHARED_BYTES // ring_target_blocks(threads) - BLOCK_RESERVED_BYTES)
    best = None
    for rows in ROWS_PER_STAGE:
        stage = rows * threads * 4
        stages = budget // (stage + BARRIER_BYTES)
        if stages >= 2 and (best is None or stages * stage > best[1] * best[2]):
            best = (rows, stages, stage)
    rows, stages, stage = best
    return rows, stages, stages * (stage + BARRIER_BYTES)


def ring_plan(threads: int, p: int, data_ptr: int, sm_count: int,
              blocks_per_sm: int | None = None) -> RingPlan:
    """The bulk_ring launch over p pixels of rows at device address
    `data_ptr` on a card of `sm_count` SMs. The bulk path needs every row
    16-byte aligned (p % 4 == 0 and an aligned pointer) and a full tile;
    otherwise every tile takes the per-thread path and the launch needs no
    shared memory. `blocks_per_sm`, what the occupancy calculator allows
    for the plan's shared memory (the wrapper asks the library), defaults
    to ring_target_blocks. The grid is that many blocks an SM, never more
    than the tiles."""
    if threads not in BLOCK_SIZES:
        raise ValueError(f"sort_sum: threads per block {threads} not in {BLOCK_SIZES}")
    rows, stages, smem = ring_shape(threads)
    tiles = -(-p // threads)
    bulk_tiles = p // threads if p % 4 == 0 and data_ptr % COPY_ALIGN == 0 else 0
    if bulk_tiles == 0:
        stages, smem = 0, 0
    blocks = blocks_per_sm or ring_target_blocks(threads)
    return RingPlan(threads, rows, stages, rows * threads * 4, smem, blocks,
                    min(blocks * sm_count, tiles), "bulk" if bulk_tiles else "per_thread",
                    tiles, bulk_tiles)


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


def sort_sum(x: torch.Tensor, layout: str = "column", threads: int = 256,
             design: str | None = None) -> torch.Tensor:
    """Sort-and-sum of each column of x (40, P); `layout`, `threads`
    (threads per block, the tile of the tiled layout) and `design` (of the
    tiled layout: "bulk_ring", the default, or "smem_sort") select the
    kernel variant and are not used by the plain version."""
    _check(x)
    if x.device.type == "cpu":
        return sort_sum_plain(x)
    return sort_sum_cuda(x, layout, threads, design)


def _design(layout: str, design: str | None) -> str | None:
    if layout not in LAYOUTS:
        raise ValueError(f"sort_sum: unknown layout {layout!r}, expected one of {LAYOUTS}")
    if layout == "column":
        if design is not None:
            raise ValueError("sort_sum: the column layout has one design")
        return None
    design = design or TILED_DESIGNS[0]
    if design not in TILED_DESIGNS:
        raise ValueError(f"sort_sum: unknown design {design!r}, expected one of {TILED_DESIGNS}")
    return design


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(threads: int, rows_per_stage: int, smem_bytes: int, device: int) -> int:
    blocks = ctypes.c_int()
    kernels.check(kernels.library().nl_sort_sum_ring_blocks_per_sm(
        threads, rows_per_stage, smem_bytes, device, ctypes.byref(blocks)), "sort_sum occupancy")
    if blocks.value < 1:
        raise RuntimeError(f"sort_sum: no block of {threads} threads and {smem_bytes} bytes "
                           "of shared memory fits an SM")
    return blocks.value


def sort_sum_plan(x: torch.Tensor, threads: int = 256) -> RingPlan:
    """The bulk_ring plan for x (a CUDA tensor) at `threads` per block, with
    the card's SM count and the occupancy the library reports."""
    args = (threads, int(x.shape[1]), x.data_ptr(),
            torch.cuda.get_device_properties(x.device).multi_processor_count)
    plan = ring_plan(*args)
    device = kernels.launch_on(x.device)[0]
    return ring_plan(*args, _blocks_per_sm(threads, plan.rows_per_stage, plan.smem_bytes,
                                           device))


def sort_sum_cuda(x: torch.Tensor, layout: str = "column", threads: int = 256,
                  design: str | None = None) -> torch.Tensor:
    kernels.require_cuda(x, "sort_sum", torch.float32)
    _check(x)
    design = _design(layout, design)
    if threads not in BLOCK_SIZES:
        raise ValueError(f"sort_sum: threads per block {threads} not in {BLOCK_SIZES}")
    p = int(x.shape[1])
    out = torch.empty(p, dtype=torch.float32, device=x.device)
    plan = sort_sum_plan(x, threads) if design == "bulk_ring" and p > 0 else None
    ring = (plan.rows_per_stage, plan.stages, plan.smem_bytes, plan.grid,
            plan.bulk_tiles) if plan else (0, 0, 0, 0, 0)
    err = kernels.library().nl_sort_sum(x.data_ptr(), p, _CODES[(layout, design)], int(threads),
                                        *ring, out.data_ptr(), *kernels.launch_on(x.device))
    kernels.check(err, "sort_sum")
    kernels.count_launch("sort_sum")
    return out
