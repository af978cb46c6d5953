// Batcher's odd-even merge sort as a compile-time schedule, shared by the
// stacking kernels (K1, K2, K3) and the sort-network microbenchmark (K5/K6).
//
// The schedule is the iterative form of the network for `wires` (a power of
// two) with every comparator whose upper wire is at or above `rows` dropped:
// rows >= `rows` hold padding that sorts last (+3.0e38, or a frame index past
// the real ones), the padding stays a suffix of the wires under every
// comparator, so those comparators never move a real value. This is the
// pruning of nightlight_tpu/ops/stack_pallas.py _sortnet_rows, and the kept
// comparators are the multiset of its _oddeven_pairs.
//
// The header includes no CUDA header, so a host compiler can read it with
//   g++ -x c++ -D__host__= -D__device__= -D__forceinline__=inline
// (tests/test_torch_stack_kernels_plan.py prints and checks the schedule so).
//
//   sortnet::count_pairs(W, R)      number of kept comparators
//   sortnet::pair_at(W, R, k)       the k-th kept comparator {lo, hi}
//   sortnet::run<W, R>(ce)          ce.template apply<lo, hi>() for each kept
//                                   comparator, unrolled with constant wires,
//                                   so register arrays stay in registers
//   sortnet::for_each_pair(W, R, f) f(lo, hi) for each, as a run-time loop
//                                   (large networks over shared memory)
//   sortnet::run_bitonic_merge<W>(ce)
//                                   Batcher's bitonic merger over W wires,
//                                   unrolled: (W/2) log2(W) comparators that
//                                   sort any bitonic input (one that falls
//                                   then rises, or rises then falls)
// A compare-exchange puts the smaller element on wire lo; what "smaller"
// means is the caller's: the value alone, or (value, frame index).
#pragma once

#include <utility>

namespace sortnet {

template <typename F>
__host__ __device__ constexpr void for_each_pair(int wires, int rows, F& f) {
    for (int p = 1; p < wires; p <<= 1) {
        const int block = ~(2 * p - 1);  // p is a power of two: no division
        for (int k = p; k >= 1; k >>= 1) {
            for (int j = k == p ? 0 : k; j + k < wires; j += 2 * k) {  // k % p
                // [j, j+k) and [j+k, j+2k) each lie in one block of 2k wires,
                // so either every i < k pairs wires of one block of 2p or
                // none does: the test is made once, not per comparator
                if ((j & block) != ((j + k) & block)) continue;
                int lim = k < rows - j - k ? k : rows - j - k;  // upper wire < rows
                for (int i = 0; i < lim; ++i) f(i + j, i + j + k);
            }
        }
    }
}

struct Pair {
    int lo;
    int hi;
};

struct PairAt {
    int want;
    int k;
    Pair found;
    __host__ __device__ constexpr void operator()(int a, int b) {
        if (k == want) found = Pair{a, b};
        ++k;
    }
};

// want = -1 never matches, so .k ends as the count
__host__ __device__ constexpr PairAt scan_pairs(int wires, int rows, int want) {
    PairAt s{want, 0, Pair{-1, -1}};
    for_each_pair(wires, rows, s);
    return s;
}

__host__ __device__ constexpr int count_pairs(int wires, int rows) {
    return scan_pairs(wires, rows, -1).k;
}

__host__ __device__ constexpr Pair pair_at(int wires, int rows, int k) {
    return scan_pairs(wires, rows, k).found;
}

template <int W, int R, typename CE, int... K>
__device__ __forceinline__ void run_seq(CE& ce, std::integer_sequence<int, K...>) {
    (ce.template apply<pair_at(W, R, K).lo, pair_at(W, R, K).hi>(), ...);
}

template <int W, int R, typename CE>
__device__ __forceinline__ void run(CE& ce) {
    static_assert(W > 0 && (W & (W - 1)) == 0, "wires must be a power of two");
    static_assert(R >= 0 && R <= W, "real rows must fit the wires");
    run_seq<W, R>(ce, std::make_integer_sequence<int, count_pairs(W, R)>{});
}

// Comparator k of the bitonic merger over W wires: stage s = k / (W/2)
// compares wires i and i + d, d = W >> (s + 1), for each i with bit d clear.
__host__ __device__ constexpr Pair bitonic_pair(int wires, int k) {
    int half = wires / 2;
    int d = wires >> (k / half + 1);
    int j = k % half;
    int lo = (j / d) * 2 * d + j % d;
    return Pair{lo, lo + d};
}

__host__ __device__ constexpr int log2_wires(int wires) {
    return wires <= 1 ? 0 : 1 + log2_wires(wires / 2);
}

template <int W, typename CE, int... K>
__device__ __forceinline__ void bitonic_seq(CE& ce, std::integer_sequence<int, K...>) {
    (ce.template apply<bitonic_pair(W, K).lo, bitonic_pair(W, K).hi>(), ...);
}

template <int W, typename CE>
__device__ __forceinline__ void run_bitonic_merge(CE& ce) {
    static_assert(W > 1 && (W & (W - 1)) == 0, "wires must be a power of two");
    bitonic_seq<W>(ce, std::make_integer_sequence<int, W / 2 * log2_wires(W)>{});
}

}  // namespace sortnet
