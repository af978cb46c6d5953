"""What the on-chip K1-K3 designs put in reach of the CPU: the shared
sorting networks of csrc/sortnet.cuh (compiled on the host), the launch plans
of ops/stack_cuda.py, and the plain versions (the specification the card is
held to bit for bit) against the JAX package on tie-heavy columns."""

import functools
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nightlight_tpu.ops.stack_pallas as sp
from nightlight_tpu.ops import stack as jstk
from nightlight_tpu_torch.ops import stack_cuda

torch.set_num_threads(1)

CSRC = Path(stack_cuda.__file__).resolve().parent.parent / "csrc"

# ---------------------------------------------------------------------------
# The shared network, compiled by the host compiler
# ---------------------------------------------------------------------------

# the (wires, rows) the kernels instantiate: unrolled over registers
# (run<W, R>: K1 8/16/32, K2 32/64, K5 64 wires for 40 rows) and as a run-time
# loop over shared memory (for_each_pair: K2 128 and 256 wires, for every
# frame count they take)
_UNROLLED = ((8, 8), (16, 16), (32, 32), (64, 64), (64, 40))
_LOOPED = {128: range(65, 129), 256: range(129, 257)}

_SCHEDULE_PRINTER = r"""
#include <cstdio>
#include "sortnet.cuh"

struct Print {
    template <int a, int b>
    void apply() { std::printf(" %d,%d", a, b); }
};

struct PrintLoop {
    void operator()(int a, int b) { std::printf(" %d,%d", a, b); }
};

template <int W, int R>
void unrolled() {
    std::printf("run %d %d %d", W, R, sortnet::count_pairs(W, R));
    Print p;
    sortnet::run<W, R>(p);
    std::printf("\n");
}

template <int W>
void bitonic() {
    std::printf("bitonic %d %d %d", W, W, W / 2 * sortnet::log2_wires(W));
    Print p;
    sortnet::run_bitonic_merge<W>(p);
    std::printf("\n");
}

int main() {
    bitonic<8>();
    bitonic<16>();
    bitonic<32>();
    bitonic<64>();
    unrolled<8, 8>();
    unrolled<16, 16>();
    unrolled<32, 32>();
    unrolled<64, 64>();
    unrolled<64, 40>();
    const int wires[2] = {128, 256};
    for (int w : wires) {
        for (int r = w / 2 + 1; r <= w; ++r) {
            std::printf("loop %d %d %d", w, r, sortnet::count_pairs(w, r));
            PrintLoop p;
            sortnet::for_each_pair(w, r, p);
            std::printf("\n");
        }
    }
    return 0;
}
"""


@pytest.fixture(scope="module")
def host_schedules(tmp_path_factory):
    """{(kind, wires, rows): [(lo, hi), ...]} as the header gives them."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler (g++) to read csrc/sortnet.cuh")
    d = tmp_path_factory.mktemp("sortnet")
    (d / "schedules.cpp").write_text(_SCHEDULE_PRINTER)
    exe = d / "schedules"
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O1", "-D__host__=", "-D__device__=",
                    "-D__forceinline__=inline", "-I", str(CSRC), str(d / "schedules.cpp"),
                    "-o", str(exe)], check=True, capture_output=True, timeout=300)
    out = subprocess.run([str(exe)], check=True, capture_output=True, text=True,
                         timeout=60).stdout
    schedules = {}
    for line in out.splitlines():
        kind, w, r, count, *pairs = line.split()
        pairs = [tuple(int(v) for v in pr.split(",")) for pr in pairs]
        assert len(pairs) == int(count)
        schedules[(kind, int(w), int(r))] = pairs
    return schedules


@functools.lru_cache(maxsize=None)
def _pallas_pairs(wires):
    return tuple(sp._oddeven_pairs(wires))


def _pruned_pallas_pairs(wires, rows):
    """The comparators that stack_pallas._sortnet_rows keeps as vector ops
    when rows >= `rows` are padding: those between two real rows."""
    return [(a, b) for a, b in _pallas_pairs(wires) if b < rows]


def _apply_lex(pairs, v, idx):
    """The kernels' compare-exchange on (value, frame index): the smaller
    pair to the lower wire."""
    v, idx = v.copy(), idx.copy()
    for a, b in pairs:
        swap = (v[:, b] < v[:, a]) | ((v[:, b] == v[:, a]) & (idx[:, b] < idx[:, a]))
        va, vb, ia, ib = v[:, a].copy(), v[:, b].copy(), idx[:, a].copy(), idx[:, b].copy()
        v[:, a], v[:, b] = np.where(swap, vb, va), np.where(swap, va, vb)
        idx[:, a], idx[:, b] = np.where(swap, ib, ia), np.where(swap, ia, ib)
    return v, idx


@pytest.mark.parametrize("kind,wires", [("run", w) for w, _ in _UNROLLED[:4]] + [("run40", 64)]
                         + [("loop", w) for w in _LOOPED])
def test_sortnet_header_schedule(host_schedules, kind, wires):
    """Each schedule the kernels instantiate is the pruned Batcher network of
    the JAX package (the same comparators) and sorts: every 0/1 input up to
    16 wires, random (value, frame index) inputs with many ties above, into
    the order of a stable sort (for the loop, the sort is checked at its
    smallest, middle and largest row count)."""
    if kind == "loop":
        configs = [("loop", wires, r) for r in _LOOPED[wires]]
    else:
        configs = [("run", wires, 40 if kind == "run40" else wires)]
    rng = np.random.default_rng(wires)
    for key in configs:
        _, w, rows = key
        pairs = host_schedules[key]
        assert sorted(pairs) == sorted(_pruned_pallas_pairs(w, rows)), key
        assert all(0 <= a < b < rows for a, b in pairs)
        if key[0] == "run" and rows == w:  # the run-time loop gives the same list
            assert host_schedules.get(("loop", w, rows), pairs) == pairs
        looped = _LOOPED.get(w, ()) if key[0] == "loop" else ()
        if looped and rows not in (looped[0], looped[len(looped) // 2], looped[-1]):
            continue
        if w <= 16:
            bits = (np.arange(1 << rows)[:, None] >> np.arange(rows)[None]) & 1
            v = bits.astype(np.float32)
        else:
            v = rng.integers(0, 6, size=(64, rows)).astype(np.float32)
            v[:, rng.integers(0, rows)] = -0.0
        idx = np.broadcast_to(np.arange(rows), v.shape).copy()
        sv, si = _apply_lex(pairs, v, idx)
        order = np.argsort(v, axis=1, kind="stable")
        np.testing.assert_array_equal(sv, np.take_along_axis(v, order, axis=1))
        np.testing.assert_array_equal(si, order)


@pytest.mark.parametrize("wires", [8, 16, 32, 64])
def test_bitonic_merge_schedule(host_schedules, wires):
    """K3's second network in registers: the bitonic merger of sortnet.cuh
    has (W/2) log2 W comparators and sorts every bitonic 0/1 input (the 0-1
    principle for merging networks) and the kernels' case, deviations that
    fall to the median's row and rise after it, 3.0e38 on missing rows."""
    pairs = host_schedules[("bitonic", wires, wires)]
    assert len(pairs) == wires // 2 * (wires.bit_length() - 1)
    assert all(0 <= a < b < wires for a, b in pairs)
    rows = []
    for i in range(wires + 1):  # 0^i 1^j 0^k and 1^i 0^j 1^k
        for j in range(wires + 1 - i):
            rows.append([0] * i + [1] * j + [0] * (wires - i - j))
            rows.append([1] * i + [0] * j + [1] * (wires - i - j))
    rng = np.random.default_rng(wires)
    for _ in range(200):
        cnt = int(rng.integers(1, wires + 1))
        z = np.sort(np.round(rng.normal(0.0, 3.0, cnt)).astype(np.float32))
        h = max(cnt, 1) // 2
        med = z[h] if cnt % 2 else np.float32(0.5) * (z[h - 1] + z[h])
        rows.append(np.r_[np.abs(z - med), np.full(wires - cnt, 3.0e38, np.float32)])
    v = np.array(rows, dtype=np.float32)
    s = v.copy()
    for a, b in pairs:
        lo, hi = np.minimum(s[:, a], s[:, b]), np.maximum(s[:, a], s[:, b])
        s[:, a], s[:, b] = lo, hi
    np.testing.assert_array_equal(s, np.sort(v, axis=1))


# ---------------------------------------------------------------------------
# Launch plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel,weighted", [("clip", False), ("clip", True), ("linfit", False)])
def test_launch_plans(kernel, weighted):
    """For every frame count 1-300: the on-chip design up to its largest
    network (K1 32 frames, K2 256), global scratch above; shared memory
    within one block's limit, two blocks to an SM, the wires the fewest
    power of two that holds the column, one launch over every pixel."""
    p = 4096 * 4096
    limit, wires_choices = ((32, stack_cuda.CLIP_WIRES) if kernel == "clip"
                            else (256, stack_cuda.LINFIT_WIRES))
    for n in range(1, 301):
        plan = (stack_cuda._clip_plan(n, p, weighted) if kernel == "clip"
                else stack_cuda._linfit_plan(n, p))
        forced = (stack_cuda._clip_plan(n, p, weighted, force_scratch=True) if kernel == "clip"
                  else stack_cuda._linfit_plan(n, p, force_scratch=True))
        assert forced.variant == "scratch" and forced.wires == 0
        if n > limit:
            assert plan == forced, n
            continue
        assert plan.variant == "onchip", n
        assert plan.wires == min(w for w in wires_choices if w >= n), n
        assert plan.pixels_per_launch == p
        assert plan.threads % 32 == 0 and 32 <= plan.threads <= 256
        assert 0 <= plan.smem_bytes <= stack_cuda.BLOCK_SHARED_BYTES
        assert 2 * (plan.smem_bytes + stack_cuda.BLOCK_RESERVED_BYTES) <= \
            stack_cuda.SM_SHARED_BYTES, n
        if kernel == "clip":  # the columns and their prefix sums live in shared memory
            rows = 5 * n + 4 if weighted else 3 * n + 2
            assert plan.smem_bytes >= 4 * rows * plan.threads
        elif plan.wires > 64:  # K2 above 64 wires: the column in shared memory
            assert plan.smem_bytes >= 4 * n * plan.threads
        else:  # K2 up to 64 wires: registers only
            assert plan.smem_bytes == 0
    for n in (limit + 1, 300):  # the scratch chunks stay within the scratch budget
        plan = (stack_cuda._clip_plan(n, p, weighted) if kernel == "clip"
                else stack_cuda._linfit_plan(n, p))
        per_pixel = ((6 * n + 4 if weighted else 3 * n + 2) * 4 if kernel == "clip" else 5 * n)
        assert plan.pixels_per_launch * per_pixel <= stack_cuda.SCRATCH_BYTES


@pytest.mark.parametrize("mad", [False, True])
def test_single_pass_plan(mad):
    """K3 for every frame count 1-300: registers up to 64 frames (no shared
    memory), the column in shared memory (4n bytes a thread) up to 256,
    global scratch above; the wires the fewest power of two that holds the
    column, two blocks to an SM, one launch over every pixel; the scratch
    chunks within the scratch budget (n rows a pixel, MAD 2n)."""
    p = 4096 * 4096
    for n in range(1, 301):
        plan = stack_cuda._single_pass_plan(n, p, mad)
        forced = stack_cuda._single_pass_plan(n, p, mad, force_scratch=True)
        assert forced.variant == "scratch" and forced.wires == 0 and forced.smem_bytes == 0
        assert forced.pixels_per_launch * (2 * n if mad else n) * 4 <= stack_cuda.SCRATCH_BYTES
        if n > 256:
            assert plan == forced, n
            continue
        assert plan.variant == "onchip", n
        assert plan.wires == min(w for w in stack_cuda.SINGLE_PASS_WIRES if w >= n), n
        assert plan.pixels_per_launch == p
        assert plan.threads % 32 == 0 and 32 <= plan.threads <= 256
        assert plan.smem_bytes == (4 * n * plan.threads if plan.wires > 64 else 0), n
        assert 2 * (plan.smem_bytes + stack_cuda.BLOCK_RESERVED_BYTES) <= \
            stack_cuda.SM_SHARED_BYTES, n


@pytest.mark.parametrize("n,p", [(8, 0), (8, 1), (8, 1000), (30, 4096 * 4096 + 17),
                                 (300, 4096 * 4096 + 17), (70, 5 * 10**6)])
def test_clip_partials_cover_every_warp(n, p):
    """The per-warp clip partials: one (low, high) pair for every warp of
    every launch, the launches tiling [0, p) in order, each launch's warps
    after the previous one's."""
    for plan in (stack_cuda._clip_plan(n, p, False), stack_cuda._linfit_plan(n, p),
                 stack_cuda._linfit_plan(n, p, force_scratch=True),
                 stack_cuda._single_pass_plan(n, p, True),
                 stack_cuda._single_pass_plan(n, p, True, force_scratch=True)):
        partials, launches = stack_cuda._clip_partials(plan, p, "cpu")
        assert partials.shape[1] == 2 and partials.dtype == torch.int32
        pixel = warp = 0
        for s, q, w in launches:
            assert (s, w) == (pixel, warp) and 0 < q <= plan.pixels_per_launch
            pixel, warp = s + q, w + -(-q // plan.threads) * plan.threads // 32
        assert (pixel, warp) == (p, partials.shape[0])
        if plan.variant == "onchip":
            assert len(launches) == (1 if p else 0)
        partials.fill_(3)
        lo, hi = stack_cuda._clip_totals(partials)
        assert int(lo) == int(hi) == 3 * partials.shape[0]


# ---------------------------------------------------------------------------
# The plain versions against the JAX package on ties
# ---------------------------------------------------------------------------

def tie_frames(seed, n, p=256):
    """Integer-valued sky (BITPIX-16 ADUs: many ties) with bright outliers
    and 10% missing samples; pixel 0 has no valid sample, pixel 1 one, and
    pixels 2-9 sit about zero with -0.0 and 0.0 among their samples."""
    rng = np.random.default_rng(seed)
    f = np.round(rng.normal(1000.0, 4.0, size=(n, p))).astype(np.float32)
    f[rng.uniform(size=(n, p)) < 0.05] += 2000.0
    f[rng.uniform(size=(n, p)) < 0.1] = np.nan
    f[:, 0] = np.nan
    f[:, 1] = np.nan
    f[n // 2, 1] = 1234.0
    zero = rng.integers(-2, 3, size=(n, 8)).astype(np.float32)
    zero[zero == 0] = np.where(rng.uniform(size=int((zero == 0).sum())) < 0.5, -0.0, 0.0)
    f[:, 2:10] = zero
    return f


_TIE_N = (6, 15, 24, 25, 33, 65)


@pytest.mark.parametrize("n", _TIE_N)
@pytest.mark.parametrize("variant", ["sigma", "winsorized", "weighted sigma",
                                     "weighted winsorized", "linear fit"])
def test_plain_versions_match_xla_on_ties(n, variant):
    """The specification the card is held to bit for bit: the plain versions
    (stable sort, weights read by sorted frame index) against the JAX
    package's XLA twins (a stable argsort) on tie-heavy columns. Clip totals
    exactly; outputs within 1e-6 relative (XLA may contract a multiply-add,
    and sorts -0.0 before 0.0 where a stable sort keeps frame order, which
    reorders a weighted sum)."""
    f = tie_frames(100 + n, n)
    w = np.random.default_rng(n).uniform(0.5, 2.0, n).astype(np.float32)
    ref_loc, lo, hi = 42.5, 2.5, 2.5
    ft, wt = torch.from_numpy(f), torch.from_numpy(w)
    if variant == "linear fit":
        j = jstk.stack_linear_fit(jnp.asarray(f), ref_loc, lo, hi)
        t = stack_cuda.stack_linfit(ft, ref_loc, lo, hi)
    else:
        winsor = "winsorized" in variant
        if "weighted" in variant:
            fn = jstk.stack_winsor_sigma_weighted if winsor else jstk.stack_sigma_weighted
            j = fn(jnp.asarray(f), jnp.asarray(w), ref_loc, lo, hi)
            t = stack_cuda.stack_sigma(ft, ref_loc, lo, hi, weights=wt, winsorize=winsor)
        else:
            fn = jstk.stack_winsor_sigma if winsor else jstk.stack_sigma
            j = fn(jnp.asarray(f), ref_loc, lo, hi)
            t = stack_cuda.stack_sigma(ft, ref_loc, lo, hi, winsorize=winsor)
    assert (int(t[1]), int(t[2])) == (int(j[1]), int(j[2]))
    assert int(t[1]) + int(t[2]) > 0
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), rtol=1e-6, atol=1e-6)
    assert float(t[0][0]) == ref_loc  # no valid sample
    assert float(t[0][1]) == 1234.0  # one valid sample
