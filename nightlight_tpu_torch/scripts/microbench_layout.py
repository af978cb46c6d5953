"""Layout microbenchmark of the stacking sort network on an NVIDIA GPU.

The port of scripts/microbench_layout.py (kernel K5): the sort-and-sum of
ops/sortnet_cuda.py over a (40, 2^21) float32 block, in the kernel's two
layouts -- "column" (each thread sorts its pixel's 40 values in registers)
and "tiled" (blocks of 256 columns) in its two designs, "bulk_ring" (a
persistent grid streams each tile's rows into a ring of shared-memory
stages by bulk copies; each thread sorts its column in registers) and
"smem_sort" (the port's first design: each block stages its (40, 256) tile
in shared memory and sorts the columns there) -- beside the plain PyTorch
version (torch.sort).

Timing is the dependent-chain method of the original: CHAIN kernel
applications, each feeding a scalar of its output back into the input
(x + acc * 1e-30, which leaves x unchanged but orders the chain), timed
with CUDA events; best of 5 after a warm-up. Each variant prints ms per
eval (one kernel plus the chain's update of x, a 335 MB read and write),
the kernel's own ms (CHAIN calls back to back, no update; best of 5), the
effective input rate of an eval and the chain's value, which must agree
across variants.

    python -m nightlight_tpu_torch.scripts.microbench_layout [--pixels P] [--seed S]
"""

from __future__ import annotations

import argparse

import torch

from nightlight_tpu_torch.ops import sortnet_cuda

N = sortnet_cuda.ROWS
P = 2 * 1024 * 1024  # pixels per eval, the JAX package's bench chunk
CHAIN = 8


def make_input(pixels: int, seed: int, device) -> torch.Tensor:
    """(40, pixels) float32 samples about 100 with sigma 2, from `seed`."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randn((N, pixels), generator=g, device=device) * 2.0 + 100.0


def chain(fn, x: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros((), dtype=torch.float32, device=x.device)
    for _ in range(CHAIN):
        acc = acc + fn(x)[0]
        x = x + acc * 1e-30  # orders the chain
    return acc


def best_ms(run, reps: int = 5) -> float:
    """Best-of-`reps` CUDA-event time of run(), after one warm-up run."""
    run()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def time_chain(fn, x: torch.Tensor, label: str, reps: int = 5) -> dict:
    """Per eval, the best-of-`reps` time of one chain, and the kernel's
    own time: CHAIN calls of fn(x) back to back."""
    value = float(chain(fn, x))
    ms = best_ms(lambda: chain(fn, x), reps) / CHAIN

    def calls():
        for _ in range(CHAIN):
            fn(x)

    kernel_ms = best_ms(calls, reps) / CHAIN
    gbps = N * x.shape[1] * 4 / (ms * 1e-3) / 1e9
    print(f"{label}: {ms:.4f} ms/eval, kernel {kernel_ms:.4f} ms ({gbps:.1f} GB/s effective)  "
          f"value={value:.3f}", flush=True)
    return {"label": label, "ms": ms, "kernel_ms": kernel_ms, "gbps": gbps, "value": value}


def require_cuda() -> torch.device:
    if not torch.cuda.is_available():
        raise SystemExit("this microbenchmark needs a CUDA device")
    return torch.device("cuda:0")


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description="sort-network layout microbenchmark (K5)")
    ap.add_argument("--pixels", type=int, default=P)
    ap.add_argument("--seed", type=int, default=0)
    opts = ap.parse_args(argv)
    dev = require_cuda()
    x = make_input(opts.pixels, opts.seed, dev)
    results = [
        time_chain(sortnet_cuda.sort_sum_plain, x, "plain             torch.sort"),
        time_chain(lambda t: sortnet_cuda.sort_sum_cuda(t, "column"), x,
                   "column            registers"),
    ]
    for design in sortnet_cuda.TILED_DESIGNS:
        results.append(time_chain(lambda t, d=design: sortnet_cuda.sort_sum_cuda(t, "tiled",
                                                                                 design=d),
                                  x, f"tiled {design:9s}   (40,256)"))
    ring, smem = results[2], results[3]
    print(f"kernel speedup bulk_ring/smem_sort: {smem['kernel_ms'] / ring['kernel_ms']:.2f}x   "
          f"values match: {len({r['value'] for r in results}) == 1}", flush=True)
    return results


if __name__ == "__main__":
    main()
