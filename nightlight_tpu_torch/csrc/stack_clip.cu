// K1: sigma-clip / winsorized sigma-clip stacking, plain and weighted.
//
// Replaces the Pallas TPU kernel nightlight_tpu/ops/stack_pallas.py
// _stack_clip_pallas (body _make_kernel; public stack_sigma_pallas), and
// computes the same per-pixel function, in the arithmetic of the JAX
// package's XLA twin (ops/stack.py _sigma_clip_core), which the plain
// PyTorch version in ops/stack_cuda.py follows too:
//   * the frame column is sorted ascending with NaN (missing) last, in the
//     stable order (ties keep their frame order), weights following their
//     samples in the weighted variant;
//   * values are centred on the column median, so the f32 sums of squares
//     do not cancel when the cluster sits far from zero;
//   * the active set stays a contiguous range [lo, hi) of the sorted
//     column, so range sums come from prefix sums S1[k], S2[k] of the sorted
//     values and their squares (and of the weights and weighted values);
//   * each round takes median, mean and (winsorized) stddev of the range and
//     moves lo/hi past the samples outside median -/+ sigma * std, until
//     nothing is clipped or at most one sample is left (at most n+1 rounds);
//   * the winsorized stddev is the progressive-clamp fixed point: clamp at
//     the running (max lower, min upper) bounds median -/+ 1.5 std, std <-
//     1.134 * std(clamped), "changed" counted only against a bound that
//     tightened, stop at a relative change <= 5e-4 or nothing changed, at
//     most 8 trips of 4 applications; the clamped sums are the interior
//     prefix-sum difference plus bound times tail count;
//   * the result is the mean (weighted: the weighted mean, falling back to
//     the set before removal if it emptied) of the final range plus the
//     centre; ref_loc where the column has no valid sample. The low and
//     high clip counts are summed over each warp into partials[2w|2w+1]
//     (nl::write_clip_partials), which the wrapper adds up.
//
// What bounds it on the H100: each pixel is independent, one thread per
// pixel. The least the card can do is one read of the frames (4n bytes a
// pixel) and the write of the result (4 bytes); the work per pixel is a
// sort of n values and a few rounds of O(1) range arithmetic plus tail
// counts, as many as the data needs, so the lanes of a warp diverge: a warp
// runs as many rounds and winsorized applications as its slowest pixel.
// Two designs:
//
//   * on chip (n <= 32; nl_stack_clip_onchip). The column is read once,
//     coalesced, and sorted by the shared Batcher network (sortnet.cuh) on
//     (value, frame index) pairs, which reproduces the stable order, in
//     registers over 8, 16 or 32 wires, fully unrolled (frames past n are
//     padding that sorts last). The
//     sorted, centred column and its prefix sums (3n+2 rows, weighted 5n+4)
//     go once to dynamic shared memory laid out [row][thread], so the lanes
//     of a warp always hit distinct banks. Every tail count, in the clip
//     rounds and in the winsorized stddev, is two binary searches over the
//     sorted range (#{z < b} a lower bound, #{z > t} an upper bound) instead
//     of a scan. Nothing per pixel goes to device memory but the result.
//   * global scratch (n > 32; nl_stack_clip). The column and its prefix
//     sums live in scratch laid out like the input ((rows, Q), element i of
//     pixel p at i*Q + p), sorted by insertion, tails counted by scans; the
//     wrapper launches pixel chunks of Q so the scratch stays within a fixed
//     budget. This is the first design of the port, kept for frame counts
//     past the largest register network (the auto mode takes K1 for 6-24
//     frames; larger batches reach it only through -stMode 2 or 3). A
//     64-wire network looping over the column in shared memory was slower
//     than this design at 33-48 frames, so there is none.
// Both run the same float operations in the same order (prefix sums row by
// row, -fmad=false), so both match the plain version bit for bit.
#include "common.cuh"
#include "sortnet.cuh"

namespace {

template <typename Col>
__device__ __forceinline__ float median_range(const Col& z, int lo, int cnt) {
    int c1 = cnt > 1 ? cnt : 1;
    float upper = z[lo + c1 / 2];
    int li = c1 / 2 - 1;
    float lower = z[lo + (li > 0 ? li : 0)];
    return (c1 % 2 == 1) ? upper : 0.5f * (lower + upper);
}

// The tail counts #{i in [lo, hi) : z[i] < b} and #{i in [lo, hi) : z[i] >
// t} of the sorted, centred column, two ways (a NaN bound has an empty
// tail in both): ScanCounts scans the range (the global-scratch design);
// SearchCounts, as z is sorted ascending, finds the edge of each tail in
// the range by a binary search.
template <typename Col>
struct ScanCounts {
    Col z;
    __device__ __forceinline__ void operator()(int lo, int hi, float b, float t, int* below,
                                               int* above) const {
        int nb = 0, na = 0;
        for (int i = lo; i < hi; ++i) {
            float v = z[i];
            nb += v < b;
            na += v > t;
        }
        *below = nb;
        *above = na;
    }
};

template <typename Col>
struct SearchCounts {
    Col z;
    __device__ __forceinline__ void operator()(int lo, int hi, float b, float t, int* below,
                                               int* above) const {
        int a = lo, len = hi - lo;
        while (len > 0) {  // first i with !(z[i] < b)
            int half = len >> 1;
            if (z[a + half] < b) {
                a += half + 1;
                len -= half + 1;
            } else {
                len = half;
            }
        }
        *below = a - lo;
        a = lo;
        len = hi - lo;
        while (len > 0) {  // first i with z[i] > t
            int half = len >> 1;
            if (!(z[a + half] > t)) {
                a += half + 1;
                len -= half + 1;
            } else {
                len = half;
            }
        }
        *above = hi - a;
    }
};

// Winsorized stddev fixed point of the sorted range [lo, hi) about median.
template <typename Counts, typename Col>
__device__ float winsor_std(const Counts& counts, const Col& s1, const Col& s2, int lo, int hi,
                            float median, float std0) {
    int cnt = hi - lo;
    float c = (float)(cnt > 1 ? cnt : 1);
    float std = std0;
    float lo_r = -INFINITY, hi_r = INFINITY;
    for (int it = 0; it < 32; ++it) {
        float wlo = median - 1.5f * std;
        float whi = median + 1.5f * std;
        float nlo = fmaxf(lo_r, wlo);
        float nhi = fminf(hi_r, whi);
        int below, above;
        counts(lo, hi, nlo, nhi, &below, &above);
        int a = lo + below, b = hi - above;
        float wsum = (s1[b] - s1[a]) + (float)below * nlo + (float)above * nhi;
        float wsq = (s2[b] - s2[a]) + (float)below * nlo * nlo + (float)above * nhi * nhi;
        float m = wsum / c;
        float var = wsq / c - m * m;
        float s = 1.134f * sqrtf(fmaxf(var, 0.f));
        int changed = (wlo > lo_r ? below : 0) + (whi < hi_r ? above : 0);
        float fac = fabsf(s - std) / fmaxf(std, 1e-30f);
        std = s;
        lo_r = nlo;
        hi_r = nhi;
        if (changed == 0 || fac <= 0.0005f) break;
    }
    return std;
}

// The sorted, centred column z[0, n) and its prefix sums s1, s2 (and w1,
// wv1 when weighted) of one pixel, wherever they live.
template <typename Col>
struct ClipColumn {
    Col z, s1, s2, w1, wv1;
};

// The clip rounds over the valid prefix [0, cnt0) of c; writes the result
// (before adding the centre), and the low/high clip counts.
template <typename Counts, typename Col>
__device__ __forceinline__ void clip_rounds(const ClipColumn<Col>& c, const Counts& counts,
                                            int n, int cnt0, bool weighted, float sigma_lo,
                                            float sigma_hi, float ref_loc, int winsorize,
                                            float* result_out, int* clo_out, int* chi_out) {
    int lo = 0, hi = cnt0, clo = 0, chi = 0;
    float result = ref_loc;
    bool running = cnt0 > 0;
    for (int it = 0; running && it < n + 1; ++it) {
        int cnt = hi - lo;
        float cf = (float)(cnt > 1 ? cnt : 1);
        float median = median_range(c.z, lo, cnt);
        float mean = (c.s1[hi] - c.s1[lo]) / cf;
        float var = (c.s2[hi] - c.s2[lo]) / cf - mean * mean;
        float std = sqrtf(fmaxf(var, 0.f));
        if (winsorize) std = winsor_std(counts, c.s1, c.s2, lo, hi, median, std);
        float low_b = median - sigma_lo * std;
        float high_b = median + sigma_hi * std;
        int below, above;
        counts(lo, hi, low_b, high_b, &below, &above);
        int new_lo = lo + below, new_hi = hi - above;
        int new_cnt = new_hi - new_lo;
        bool stop = (below + above == 0) || new_cnt <= 1;
        if (stop) {
            if (weighted) {
                float ws = c.w1[new_hi] - c.w1[new_lo], wv = c.wv1[new_hi] - c.wv1[new_lo];
                float ws_pre = c.w1[hi] - c.w1[lo], wv_pre = c.wv1[hi] - c.wv1[lo];
                result = new_cnt > 0 ? wv / fmaxf(ws, 1e-30f) : wv_pre / fmaxf(ws_pre, 1e-30f);
            } else {
                result = mean;
            }
        }
        clo += below;
        chi += above;
        lo = new_lo;
        hi = new_hi;
        running = !stop;
    }
    *result_out = result;
    *clo_out = clo;
    *chi_out = chi;
}

// Centre the sorted column on `center` and write it with its prefix sums,
// row by row: value(i) is sorted row i before centring, weight(i) its
// frame's weight. W > 0 unrolls the rows (the register network, where
// value and weight read registers by constant index); W = 0 loops over n.
template <int W, typename Col, typename Value, typename Weight>
__device__ __forceinline__ void centre_and_prefix(const ClipColumn<Col>& c, int n, int cnt0,
                                                  float center, bool weighted, Value value,
                                                  Weight weight) {
    float a1 = 0.f, a2 = 0.f, b1 = 0.f, b2 = 0.f;
    c.s1[0] = 0.f;
    c.s2[0] = 0.f;
    if (weighted) {
        c.w1[0] = 0.f;
        c.wv1[0] = 0.f;
    }
    auto row = [&](int i) {
        float v = i < cnt0 ? value(i) - center : 0.f;
        c.z[i] = v;
        a1 = a1 + v;
        a2 = a2 + v * v;
        c.s1[i + 1] = a1;
        c.s2[i + 1] = a2;
        if (weighted) {
            float w = weight(i);
            b1 = b1 + w;
            b2 = b2 + w * v;
            c.w1[i + 1] = b1;
            c.wv1[i + 1] = b2;
        }
    };
    if constexpr (W > 0) {
#pragma unroll
        for (int i = 0; i < W; ++i)
            if (i < n) row(i);
    } else {
        for (int i = 0; i < n; ++i) row(i);
    }
}

// ---------------------------------------------------------------------------
// On chip: columns in registers / shared memory
// ---------------------------------------------------------------------------

// Shared memory of one thread, column t of a [row][thread] block of T
// threads: z[n] | s1[n+1] | s2[n+1] | w1[n+1] | wv1[n+1] floats (the last two
// only when weighted).
using SharedClipColumn = ClipColumn<nl::SharedColumn>;

__device__ __forceinline__ SharedClipColumn shared_column(float* smem, int t, int T, int n) {
    float* base = smem + t;
    return SharedClipColumn{nl::SharedColumn{base, T}, nl::SharedColumn{base + n * T, T},
                            nl::SharedColumn{base + (2 * n + 1) * T, T},
                            nl::SharedColumn{base + (3 * n + 2) * T, T},
                            nl::SharedColumn{base + (4 * n + 3) * T, T}};
}

__host__ __device__ constexpr int clip_rows(int n, bool weighted) {
    return weighted ? 5 * n + 4 : 3 * n + 2;
}

// (value, frame index) compare-exchange on register arrays: ties keep
// their frame order, the order of a stable sort.
template <int W>
struct LexRegs {
    float (&v)[W];
    int (&id)[W];
    template <int a, int b>
    __device__ __forceinline__ void apply() {
        float x = v[a], y = v[b];
        int i = id[a], j = id[b];
        bool swap = y < x || (y == x && j < i);
        v[a] = swap ? y : x;
        v[b] = swap ? x : y;
        id[a] = swap ? j : i;
        id[b] = swap ? i : j;
    }
};

// One pixel, W wires in registers (n <= W <= 32)
template <int W>
__device__ __forceinline__ void clip_pixel_regs(const float* __restrict__ frames,
                                                const float* __restrict__ weights, int n,
                                                long long P, long long p, float sigma_lo,
                                                float sigma_hi, float ref_loc, int winsorize,
                                                float* __restrict__ out, int* clo, int* chi) {
    extern __shared__ float smem[];
    const SharedClipColumn c = shared_column(smem, threadIdx.x, blockDim.x, n);
    float v[W];
    int id[W];
    int cnt0 = 0;
#pragma unroll
    for (int i = 0; i < W; ++i) {
        float x = i < n ? frames[(long long)i * P + p] : NL_BIG;
        bool ok = i < n && x == x;
        v[i] = ok ? x : NL_BIG;
        id[i] = i;
        cnt0 += ok;
    }
    LexRegs<W> ce{v, id};
    sortnet::run<W, W>(ce);
    // the sorted column to shared memory for the median; the values and
    // their frames stay in registers for the unrolled prefix rows
#pragma unroll
    for (int i = 0; i < W; ++i)
        if (i < n) c.z[i] = v[i];
    const bool weighted = weights != nullptr;
    float center = cnt0 > 0 ? median_range(c.z, 0, cnt0) : 0.f;
    centre_and_prefix<W>(
        c, n, cnt0, center, weighted, [&](int i) { return v[i]; },
        [&](int i) { return weights[id[i]]; });
    float result;
    clip_rounds(c, SearchCounts<nl::SharedColumn>{c.z}, n, cnt0, weighted, sigma_lo, sigma_hi,
                ref_loc, winsorize, &result, clo, chi);
    out[p] = cnt0 > 0 ? result + center : ref_loc;
}

template <int W>
__global__ void __launch_bounds__(256)
    stack_clip_regs_kernel(const float* __restrict__ frames, const float* __restrict__ weights,
                           int n, long long P, float sigma_lo, float sigma_hi, float ref_loc,
                           int winsorize, float* __restrict__ out,
                           int* __restrict__ partials) {
    long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    int clo = 0, chi = 0;
    if (p < P)
        clip_pixel_regs<W>(frames, weights, n, P, p, sigma_lo, sigma_hi, ref_loc, winsorize, out,
                           &clo, &chi);
    nl::write_clip_partials(clo, chi, partials);
}

// ---------------------------------------------------------------------------
// Global scratch (frame counts beyond the on-chip limit)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void clip_pixel_scratch(const float* __restrict__ frames,
                                                   const float* __restrict__ weights, int n,
                                                   long long stride, long long Q, long long p,
                                                   float sigma_lo, float sigma_hi, float ref_loc,
                                                   int winsorize, float* scratch,
                                                   float* __restrict__ out, int* clo, int* chi) {
    const bool weighted = weights != nullptr;
    // scratch rows of Q pixels: z[n] | s1[n+1] | s2[n+1] | w[n] | w1[n+1] | wv1[n+1]
    nl::Column w{scratch + (long long)(3 * n + 2) * Q + p, Q};
    const ClipColumn<nl::Column> c{nl::Column{scratch + p, Q},
                                   nl::Column{scratch + (long long)n * Q + p, Q},
                                   nl::Column{scratch + (long long)(2 * n + 1) * Q + p, Q},
                                   nl::Column{scratch + (long long)(4 * n + 2) * Q + p, Q},
                                   nl::Column{scratch + (long long)(5 * n + 3) * Q + p, Q}};
    int cnt0 = 0;
    for (int i = 0; i < n; ++i) {
        float v = frames[(long long)i * stride + p];
        bool ok = v == v;
        c.z[i] = ok ? v : NL_BIG;
        if (weighted) w[i] = weights[i];
        cnt0 += ok;
    }
    nl::insertion_sort(c.z, weighted ? &w : nullptr, n);
    float center = cnt0 > 0 ? median_range(c.z, 0, cnt0) : 0.f;
    centre_and_prefix<0>(
        c, n, cnt0, center, weighted, [&](int i) { return c.z[i]; },
        [&](int i) { return w[i]; });
    float result;
    clip_rounds(c, ScanCounts<nl::Column>{c.z}, n, cnt0, weighted, sigma_lo, sigma_hi, ref_loc,
                winsorize, &result, clo, chi);
    out[p] = cnt0 > 0 ? result + center : ref_loc;
}

__global__ void stack_clip_scratch_kernel(const float* __restrict__ frames,
                                          const float* __restrict__ weights, int n,
                                          long long stride, long long Q, float sigma_lo,
                                          float sigma_hi, float ref_loc, int winsorize,
                                          float* scratch, float* __restrict__ out,
                                          int* __restrict__ partials) {
    long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    int clo = 0, chi = 0;
    if (p < Q)
        clip_pixel_scratch(frames, weights, n, stride, Q, p, sigma_lo, sigma_hi, ref_loc,
                           winsorize, scratch, out, &clo, &chi);
    nl::write_clip_partials(clo, chi, partials);
}

}  // namespace

// Global-scratch design. One launch stacks the Q pixels starting at
// `frames` (rows `stride` floats apart) and `out`, so a caller can bound the
// scratch by launching pixel chunks, each with its own run of `partials`
// (two ints for each warp of the launch). Scratch: 3n+2 rows of Q floats,
// or 6n+4 for the weighted variant.
extern "C" int nl_stack_clip(const float* frames, const float* weights, int n,
                             long long stride, long long Q, float sigma_lo, float sigma_hi,
                             float ref_loc, int winsorize, float* scratch, float* out,
                             int* partials, int device, void* stream) {
    NL_USE_DEVICE(device);
    const int threads = 256;
    if (Q > 0) {
        stack_clip_scratch_kernel<<<nl::blocks_for(Q, threads), threads, 0,
                                    (cudaStream_t)stream>>>(frames, weights, n, stride, Q,
                                                            sigma_lo, sigma_hi, ref_loc,
                                                            winsorize, scratch, out, partials);
    }
    return (int)cudaGetLastError();
}

// On-chip design over all P pixels of frames (n, P) in one launch, the clip
// counts of each warp to `partials`: `wires` 8, 16 or 32 sorts in
// registers; `threads` per block (a multiple of 32, at
// most 256) and `smem` bytes of dynamic shared memory, at least what the
// column of every thread needs (ops/stack_cuda.py _clip_plan picks all
// three).
extern "C" int nl_stack_clip_onchip(const float* frames, const float* weights, int n,
                                    long long P, float sigma_lo, float sigma_hi, float ref_loc,
                                    int winsorize, int wires, int threads, int smem, float* out,
                                    int* partials, int device, void* stream) {
    NL_USE_DEVICE(device);
    const bool weighted = weights != nullptr;
    long long need = (long long)clip_rows(n, weighted) * threads * 4;
    if (n < 1 || n > wires || threads < 32 || threads > 256 || threads % 32 != 0 || smem < need)
        return (int)cudaErrorInvalidValue;
    if (P <= 0) return (int)cudaSuccess;
    cudaStream_t s = (cudaStream_t)stream;
    int blocks = nl::blocks_for(P, threads);
    auto regs = [&](auto kernel) {
        cudaError_t e =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
        kernel<<<blocks, threads, smem, s>>>(frames, weights, n, P, sigma_lo, sigma_hi, ref_loc,
                                             winsorize, out, partials);
        return (int)cudaGetLastError();
    };
    switch (wires) {
        case 8: return regs(stack_clip_regs_kernel<8>);
        case 16: return regs(stack_clip_regs_kernel<16>);
        case 32: return regs(stack_clip_regs_kernel<32>);
        default: return (int)cudaErrorInvalidValue;
    }
}
