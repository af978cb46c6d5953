"""Tile-size sweep of the stacking sort network on an NVIDIA GPU.

The port of scripts/microbench_tile.py (kernel K6): the sort-and-sum of
ops/sortnet_cuda.py over a (40, 2^21) float32 block at threads per block
1024, 512, 256 and 128. For the tiled layout that is the tile, in both
designs: "bulk_ring" streams the tile's rows through a ring of
shared-memory stages (its plan, ops/sortnet_cuda.py ring_plan, sizes the
ring per tile), "smem_sort" stages the whole tile and sorts in shared
memory (160 bytes a pixel, so it sets how many blocks an SM holds); for the
column layout only the block shape changes. Same dependent-chain timing as
microbench_layout.py, each variant with its ms per eval and its kernel's
own ms.

    python -m nightlight_tpu_torch.scripts.microbench_tile [--pixels P] [--seed S]
"""

from __future__ import annotations

import argparse

from nightlight_tpu_torch.ops import sortnet_cuda
from nightlight_tpu_torch.scripts.microbench_layout import P, make_input, require_cuda, time_chain

VARIANTS = [("column", None)] + [("tiled", d) for d in sortnet_cuda.TILED_DESIGNS]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description="sort-network tile sweep (K6)")
    ap.add_argument("--pixels", type=int, default=P)
    ap.add_argument("--seed", type=int, default=0)
    opts = ap.parse_args(argv)
    dev = require_cuda()
    x = make_input(opts.pixels, opts.seed, dev)
    results = []
    for threads in sorted(sortnet_cuda.BLOCK_SIZES, reverse=True):
        for layout, design in VARIANTS:
            def run(t, layout=layout, threads=threads, design=design):
                return sortnet_cuda.sort_sum_cuda(t, layout, threads, design)

            r = time_chain(run, x, f"tile={threads:5d} {layout:6s} {design or '':9s}")
            r.update(layout=layout, design=design, threads=threads)
            results.append(r)
    print(f"values match: {len({r['value'] for r in results}) == 1}", flush=True)
    return results


if __name__ == "__main__":
    main()
