"""The launch plan of the tiled sort-and-sum's bulk-ring design (kernels K5
tiled and K6, ops/sortnet_cuda.py ring_plan), checked on the CPU against
what csrc/sort_sum.cu needs: the ring fits the shared memory with at least
two stages, every bulk copy is 16-byte aligned in size, source and
destination, the per-thread path is taken exactly where the rows are not
16-byte aligned (or no tile is full), and a Python transcription of the
kernel's walk over the persistent grid covers every pixel exactly once."""

import os
import re

import numpy as np
import pytest
import torch

from nightlight_tpu_torch import kernels
from nightlight_tpu_torch.ops import sortnet_cuda as sn
from nightlight_tpu_torch.ops.stack_cuda import (BLOCK_RESERVED_BYTES, BLOCK_SHARED_BYTES,
                                                 SM_SHARED_BYTES)

SM_COUNT = 132  # an H100 SXM
BASE_PTR = 0x7F3A_0000_0000  # a device allocation: 512-byte aligned
PIXELS = [1 << 21, (1 << 21) - 3, (1 << 21) - 4, 4093, 4, 1]
SORT_SUM_CU = os.path.join(os.path.dirname(sn.__file__), os.pardir, "csrc", "sort_sum.cu")


@pytest.mark.parametrize("threads", sn.BLOCK_SIZES)
def test_ring_fits_shared_memory(threads):
    """Shared bytes with the barriers within a block's limit, the target
    blocks within an SM's, at least two stages, stages and barriers
    aligned."""
    rows, stages, smem = sn.ring_shape(threads)
    blocks = sn.ring_target_blocks(threads)
    assert rows in sn.ROWS_PER_STAGE and sn.ROWS % rows == 0
    assert stages >= 2
    stage_bytes = rows * threads * 4
    assert smem == stages * stage_bytes + stages * sn.BARRIER_BYTES
    assert smem <= BLOCK_SHARED_BYTES == 232_448
    assert blocks * (smem + BLOCK_RESERVED_BYTES) <= SM_SHARED_BYTES
    assert stage_bytes % 128 == 0  # each stage (ring offset 0) 128-byte aligned
    assert (stages * stage_bytes) % 8 == 0  # the barriers after the ring
    # at least ~32 KB in flight per SM (the HBM rate times ~1 us, over 132 SMs)
    assert blocks * (stages - 1) * stage_bytes >= 32 * 1024


def test_ring_instances_match_source():
    """The (tile, rows per stage) pairs that ring_shape plans are the
    kernel instantiations that csrc/sort_sum.cu dispatches to, and the ring's
    header is hashed into the build."""
    src = open(SORT_SUM_CU).read()
    line = re.search(r"#define NL_RING_INSTANCES\(X\)(.*)", src).group(1)
    built = {(int(t), int(r)) for t, r in re.findall(r"X\((\d+), (\d+)\)", line)}
    assert built == {(t, sn.ring_shape(t)[0]) for t in sn.BLOCK_SIZES}
    assert '#include "bulk_ring.cuh"' in src and "bulk_ring.cuh" in kernels.HEADERS
    assert f"constexpr int kRingRegs = {sn.RING_REGS};" in src


def walk(plan, p: int) -> np.ndarray:
    """A transcription of sort_sum_ring_kernel's loop: each block b takes
    tiles b, b + grid, ...; its first `own` tiles come through the ring as
    chunks of rows_per_stage rows, the consumer tracking the stage and the
    fill parity as the kernel does (s, parity), which must equal the
    producer's c % stages and (c // stages) & 1; the rest by per-thread
    loads. Returns how often each pixel was written."""
    t, rows, stages = plan.threads, plan.rows_per_stage, plan.stages
    c_per_tile = sn.ROWS // rows
    written = np.zeros(p, np.int64)
    for b in range(plan.grid):
        own = (plan.bulk_tiles - 1 - b) // plan.grid + 1 if b < plan.bulk_tiles else 0
        s, parity, j = 0, 0, 0
        while b + j * plan.grid < plan.tiles:
            k = b + j * plan.grid
            if j < own:
                assert (k + 1) * t <= p  # a bulk tile is full
                for q in range(c_per_tile):
                    c = j * c_per_tile + q
                    assert (s, parity) == (c % stages, (c // stages) & 1)
                    s += 1
                    if s == stages:
                        s, parity = 0, parity ^ 1
            else:
                assert k >= plan.bulk_tiles
            written[k * t:min(p, (k + 1) * t)] += 1
            j += 1
    return written


def bulk_copies(plan, p: int, data_ptr: int):
    """Every bulk copy the kernel issues (fill_stage), vectorised: for bulk
    tile k and row r, the source address, the destination offset in the
    ring and the size."""
    t, rows = plan.threads, plan.rows_per_stage
    k = np.arange(plan.bulk_tiles, dtype=np.int64)[:, None]
    r = np.arange(sn.ROWS, dtype=np.int64)[None, :]
    chunk = (k // plan.grid) * (sn.ROWS // rows) + r // rows
    stage = chunk % plan.stages
    src = data_ptr + (r * p + k * t) * 4
    dst = stage * plan.stage_bytes + (r % rows) * t * 4
    return src, dst, t * 4


@pytest.mark.parametrize("misalign", [0, 4, 8])
@pytest.mark.parametrize("p", PIXELS)
@pytest.mark.parametrize("threads", sn.BLOCK_SIZES)
def test_ring_plan_paths_copies_and_walk(threads, p, misalign):
    data_ptr = BASE_PTR + misalign
    plan = sn.ring_plan(threads, p, data_ptr, SM_COUNT)
    aligned = p % 4 == 0 and misalign == 0
    assert plan.path == ("bulk" if aligned and p >= threads else "per_thread")
    assert plan.tiles == -(-p // threads)
    assert 1 <= plan.grid <= min(plan.tiles, plan.blocks_per_sm * SM_COUNT)
    if plan.path == "bulk":
        assert plan.bulk_tiles == p // threads and plan.stages >= 2
        assert plan.smem_bytes <= BLOCK_SHARED_BYTES
        src, dst, size = bulk_copies(plan, p, data_ptr)
        assert size % 16 == 0 and size * plan.rows_per_stage == plan.stage_bytes
        assert not np.any(src % 16) and not np.any(dst % 16)
        assert dst.max() + size <= plan.stages * plan.stage_bytes  # below the barriers
    else:
        assert plan.bulk_tiles == 0 and plan.stages == 0 and plan.smem_bytes == 0
    written = walk(plan, p)
    assert np.array_equal(written, np.ones(p, np.int64))


def test_ring_plan_takes_the_occupancy():
    """The grid is the occupancy the library reports times the SMs, never
    more than the tiles."""
    plan = sn.ring_plan(128, 1 << 21, BASE_PTR, SM_COUNT, blocks_per_sm=3)
    assert (plan.blocks_per_sm, plan.grid) == (3, 3 * SM_COUNT)
    assert sn.ring_plan(1024, 5000, BASE_PTR, SM_COUNT).grid == 5  # 5 tiles
    with pytest.raises(ValueError, match="threads"):
        sn.ring_plan(64, 1 << 21, BASE_PTR, SM_COUNT)


@pytest.mark.parametrize("layout,design", [("column", None), ("tiled", "bulk_ring"),
                                           ("tiled", "smem_sort"), ("tiled", None)])
def test_sort_sum_cuda_raises_on_cpu_tensor(layout, design):
    """Every design's entry refuses a CPU tensor instead of falling back."""
    with pytest.raises(ValueError, match="CUDA"):
        sn.sort_sum_cuda(torch.zeros(40, 8), layout, 256, design)


def test_sort_sum_cuda_checks_design():
    """An unknown design, or a design for the column layout, is refused
    (sort_sum_cuda checks it before it plans or launches)."""
    with pytest.raises(ValueError, match="design"):
        sn._design("tiled", "registers")
    with pytest.raises(ValueError, match="one design"):
        sn._design("column", "smem_sort")
    with pytest.raises(ValueError, match="layout"):
        sn._design("rows", None)
    assert sn._design("tiled", None) == "bulk_ring"
