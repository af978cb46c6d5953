"""Where the time of a star-patch gather call goes on an NVIDIA GPU: kernel
K4 against the in-frame mask.

    python -m nightlight_tpu_torch.scripts.gather_split [--size 4096] [--k 2048] \
        [--radius 32] [--seed 7] [--tag TEXT]

On a (size, size) frame with k candidates up to 40 pixels past every edge
(chip_smoke.py's draw), times with CUDA events, as the median of 5 runs
after a warm-up, both 10 calls back to back ("ms") and one call
("single_call_ms"):

* "call": the whole ``gather_cuda.gather_patches_cuda`` call;
* "without_mask_ops": the same call with ``gather_cuda._offsets`` (the
  torch ops that build the mask from the window offsets) replaced by a stub,
  so the kernel and the wrapper's host work. A wrapper whose kernel writes
  the mask itself never calls ``_offsets``, and then this is the whole call;
* "mask_ops": ``_offsets`` alone;
* "index": the one PyTorch call for the same patches, ``img[yy_c, xx_c]``
  with clamped int64 indices built outside the timing.

Prints one JSON line. Run from two trees in one call (parent, change,
change, parent) it sets one design's split beside the other's.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import torch

from nightlight_tpu_torch import kernels
from nightlight_tpu_torch.ops import gather_cuda


def cuda_ms(fn, calls: int, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def timed(fn) -> dict:
    return {"ms": cuda_ms(fn, 10), "single_call_ms": cuda_ms(fn, 1)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=4096, help="frame edge in pixels")
    ap.add_argument("--k", type=int, default=2048, help="candidates")
    ap.add_argument("--radius", type=int, default=32, help="window radius")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--tag", default="", help="mark of this run's line")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gather_split: no CUDA device")
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(opts.seed)
    size, k, r = opts.size, opts.k, opts.radius
    img = torch.randn((size, size), generator=gen, device=dev) * 20.0 + 900.0
    cys = torch.randint(-40, size + 40, (k,), generator=gen, device=dev, dtype=torch.int32)
    cxs = torch.randint(-40, size + 40, (k,), generator=gen, device=dev, dtype=torch.int32)
    kernels.library()

    def call():
        return gather_cuda.gather_patches_cuda(img, cys, cxs, r)

    row = {"tag": opts.tag, "device": torch.cuda.get_device_name(0), "size": size, "k": k,
           "radius": r, "call": timed(call)}
    offsets = gather_cuda._offsets
    gather_cuda._offsets = lambda *args: (None, None, None)
    try:
        row["without_mask_ops"] = timed(call)
    finally:
        gather_cuda._offsets = offsets
    row["mask_ops"] = timed(lambda: offsets(cys, cxs, r, size, size))
    yy, xx, _ = offsets(cys, cxs, r, size, size)
    yy_c, xx_c = yy.clamp(0, size - 1), xx.clamp(0, size - 1)
    row["index"] = timed(lambda: img[yy_c, xx_c])
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main(sys.argv[1:])
