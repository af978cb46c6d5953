// The per-pixel arithmetic of K3 (median and single-pass MAD sigma clip) on
// a frame column held on chip, shared by csrc/stack_single_pass.cu and a
// host test. Like sortnet.cuh it includes no CUDA header, so a host
// compiler reads it with
//   g++ -x c++ -D__host__= -D__device__= -D__forceinline__=inline -ffp-contract=off
// (tests/test_torch_stack_single_pass_host.py holds it against the plain
// version stack_single_pass_plain of ops/stack_cuda.py).
//
// The function, for a column of n samples with NaN for missing:
//   * cnt0 valid samples; missing ones become 3.0e38 and sort last;
//   * the median of the valid prefix with quickselect semantics: the middle
//     one, or 0.5f * (lower + upper) for an even count; ref_loc when cnt0 = 0;
//   * MAD: std = 1.4826 * the median of |z - median| over the valid prefix,
//     bounds median - sigma_lo * std and median + sigma_hi * std, the mean of
//     the samples inside (added in ascending order, over max(kept, 1); 0.0
//     when none is kept) and the counts below and above.
// Samples are finite and below 1e38 in magnitude, so no deviation reaches
// the 3.0e38 of a missing sample.
//
// Sorting by value alone is enough here, where K1 needs (value, frame
// index): nothing follows the sorted values, so two equal values that swap
// change no result; -0.0 and +0.0 compare equal, and the outputs they give
// compare equal too (a sum that starts at +0 never turns -0, a deviation goes
// through fabsf); and every deviation is +0 or above.
//
// Two ways to the second order statistic, both exact (the k-th smallest
// value of a multiset is unique, whatever order ties come in):
//   * in registers: the deviations of the sorted column fall up to the
//     median's row and rise after it (rounding of z - median is monotone in
//     z), with 3.0e38 on the missing rows after them: a bitonic sequence,
//     which Batcher's bitonic merger sorts in (W/2) log2 W comparators (80
//     at 32 wires, 192 at 64) where a second full network takes 191 and 543;
//   * over a column in memory: the same two sorted runs, merged outward
//     from the median's row until the k-th value, O(n) reads.
#pragma once

#include <cmath>

#include "sortnet.cuh"

namespace single_pass {

constexpr float kBig = 3.0e38f;  // NL_BIG of common.cuh
constexpr float kMadScale = 1.4826f;

struct Result {
    float out;
    int clo;
    int chi;
};

// value-only compare-exchange on a register array (constant wires)
template <int W>
struct MinMaxRegs {
    float (&v)[W];
    template <int a, int b>
    __host__ __device__ __forceinline__ void apply() {
        float x = v[a], y = v[b];
        v[a] = fminf(x, y);
        v[b] = fmaxf(x, y);
    }
};

// ... and on a column in memory, for the run-time network loop (both
// stores unconditional: no branch for the lanes of a warp to split on)
template <typename Col>
struct MinMaxColumn {
    Col v;
    __host__ __device__ __forceinline__ void operator()(int a, int b) {
        float x = v[a], y = v[b];
        v[a] = fminf(x, y);
        v[b] = fmaxf(x, y);
    }
};

// v[idx] of a register array by an unrolled select: a dynamic index into a
// register array would move it to local memory
template <int W>
__host__ __device__ __forceinline__ float select_row(const float (&v)[W], int idx) {
    float r = v[0];
#pragma unroll
    for (int i = 1; i < W; ++i) r = i == idx ? v[i] : r;
    return r;
}

// the rows of the median of a sorted valid prefix of cnt samples: upper is
// row c1/2, lower row c1/2 - 1 (row 0 for one sample), c1 = max(cnt, 1)
__host__ __device__ __forceinline__ int upper_row(int cnt) { return (cnt > 1 ? cnt : 1) / 2; }
__host__ __device__ __forceinline__ int lower_row(int cnt) {
    int h = upper_row(cnt);
    return h > 1 ? h - 1 : 0;
}
__host__ __device__ __forceinline__ float median_of(float lower, float upper, int cnt) {
    return ((cnt > 1 ? cnt : 1) & 1) ? upper : 0.5f * (lower + upper);
}

template <int W>
__host__ __device__ __forceinline__ float median_regs(const float (&v)[W], int cnt) {
    return median_of(select_row<W>(v, lower_row(cnt)), select_row<W>(v, upper_row(cnt)), cnt);
}

template <typename Col>
__host__ __device__ __forceinline__ float median_column(const Col& z, int cnt) {
    return median_of(z[lower_row(cnt)], z[upper_row(cnt)], cnt);
}

// The clip pass over the sorted valid prefix, value(i) being row i: W > 0
// unrolls the rows (registers, read by constant index), W = 0 loops over
// cnt0 rows.
template <int W, typename Value>
__host__ __device__ __forceinline__ Result clip_pass(Value value, int cnt0, float median,
                                                    float std, float sigma_lo, float sigma_hi,
                                                    float ref_loc) {
    float lo_b = median - sigma_lo * std;
    float hi_b = median + sigma_hi * std;
    float acc = 0.f;
    int kept = 0, clo = 0, chi = 0;
    auto row = [&](int i) {
        float x = value(i);
        bool below = x < lo_b, above = x > hi_b;
        clo += below;
        chi += above;
        if (!below && !above) {
            acc = acc + x;
            ++kept;
        }
    };
    if constexpr (W > 0) {
#pragma unroll
        for (int i = 0; i < W; ++i)
            if (i < cnt0) row(i);
    } else {
        for (int i = 0; i < cnt0; ++i) row(i);
    }
    return Result{cnt0 > 0 ? acc / (float)(kept > 1 ? kept : 1) : ref_loc, clo, chi};
}

// One pixel in registers: v holds the n samples with missing ones (and the
// wires past n) at kBig, cnt0 of them valid; W is 8 to 64.
template <int W, bool MAD>
__host__ __device__ __forceinline__ Result pixel_regs(float (&v)[W], int cnt0, float sigma_lo,
                                                      float sigma_hi, float ref_loc) {
    MinMaxRegs<W> sorter{v};
    sortnet::run<W, W>(sorter);
    float median = median_regs<W>(v, cnt0);
    if (!MAD) return Result{cnt0 > 0 ? median : ref_loc, 0, 0};
    float d[W];
#pragma unroll
    for (int i = 0; i < W; ++i) d[i] = i < cnt0 ? fabsf(v[i] - median) : kBig;
    MinMaxRegs<W> merger{d};
    sortnet::run_bitonic_merge<W>(merger);
    float std = median_regs<W>(d, cnt0) * kMadScale;
    return clip_pass<W>([&](int i) { return v[i]; }, cnt0, median, std, sigma_lo, sigma_hi,
                        ref_loc);
}

// The (lower, upper) rows of the sorted deviations |z[i] - median| over the
// valid prefix [0, cnt) of a sorted column (cnt >= 1): rows below h =
// upper_row(cnt) hold samples <= median (for an even count the median lies
// between rows h-1 and h), rows from h on samples >= median, so the
// deviations are two sorted runs that meet at h. Merging them outward, the
// t-th value taken is row t of the sorted deviations.
template <typename Col>
__host__ __device__ __forceinline__ float mad_column(const Col& z, int cnt, float median) {
    const int h = upper_row(cnt), want_lower = lower_row(cnt);
    int l = h - 1, r = h;
    float dl = l >= 0 ? fabsf(z[l] - median) : 0.f;
    float dr = fabsf(z[r] - median);
    float lower = 0.f, upper = 0.f;
    for (int t = 0; t <= h; ++t) {
        bool left = l >= 0 && (r >= cnt || dl <= dr);
        float d = left ? dl : dr;
        if (left) {
            --l;
            dl = l >= 0 ? fabsf(z[l] - median) : 0.f;
        } else {
            ++r;
            dr = r < cnt ? fabsf(z[r] - median) : 0.f;
        }
        if (t == want_lower) lower = d;
        upper = d;
    }
    return median_of(lower, upper, cnt);
}

// One pixel over its column z[0, n) in memory (shared memory on the card),
// missing samples at kBig; wires the network's power of two >= n.
template <bool MAD, typename Col>
__host__ __device__ __forceinline__ Result pixel_column(const Col& z, int wires, int n, int cnt0,
                                                        float sigma_lo, float sigma_hi,
                                                        float ref_loc) {
    MinMaxColumn<Col> sorter{z};
    sortnet::for_each_pair(wires, n, sorter);
    float median = median_column(z, cnt0);
    if (!MAD) return Result{cnt0 > 0 ? median : ref_loc, 0, 0};
    if (cnt0 == 0) return Result{ref_loc, 0, 0};
    float std = mad_column(z, cnt0, median) * kMadScale;
    return clip_pass<0>([&](int i) { return z[i]; }, cnt0, median, std, sigma_lo, sigma_hi,
                        ref_loc);
}

}  // namespace single_pass
