// K1: sigma-clip / winsorized sigma-clip stacking, plain and weighted.
//
// Replaces the Pallas TPU kernel nightlight_tpu/ops/stack_pallas.py
// _stack_clip_pallas (body _make_kernel; public stack_sigma_pallas), and
// computes the same per-pixel function, in the arithmetic of the JAX
// package's XLA twin (ops/stack.py _sigma_clip_core), which the plain
// PyTorch version in ops/stack_cuda.py follows too:
//   * the frame column is sorted ascending with NaN (missing) last, weights
//     following their samples in the weighted variant;
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
//     centre; ref_loc where the column has no valid sample. Per-pixel clip
//     counts go to clips[0, p] (low) and clips[1, p] (high).
//
// What bounds it on the H100: each pixel is independent, so the design is
// one thread per pixel with no communication. The TPU kernel vectorised the
// frame axis across VMEM rows with a Batcher network; here a thread owns its
// column. The sorted column and its prefix sums live in global scratch laid
// out like the input ((rows, Q), element i of pixel p at i*Q + p), so every
// access of a warp is one coalesced 128-byte line and stays in L1/L2 while
// its warp works. That takes any frame count the memory solver forms
// (hundreds); the wrapper launches pixel chunks of Q so that the scratch
// (3x, weighted 6x, the chunk's frames) stays within a fixed budget beside
// a batch that fills the card. The O(n^2) insertion sort and the per-round range counts are
// cached column traffic; with prefix sums a round's mean and stddev cost
// O(1), so the kernel is bound by the sort, the counts and warp divergence
// (lanes run different numbers of rounds and winsor applications) rather
// than by its single pass over device memory.
#include "common.cuh"

namespace {

__device__ __forceinline__ float median_range(const nl::Column& z, int lo, int cnt) {
    int c1 = cnt > 1 ? cnt : 1;
    float upper = z[lo + c1 / 2];
    int li = c1 / 2 - 1;
    float lower = z[lo + (li > 0 ? li : 0)];
    return (c1 % 2 == 1) ? upper : 0.5f * (lower + upper);
}

// #{i in [lo, hi) : z[i] < b} and #{i in [lo, hi) : z[i] > t}
__device__ __forceinline__ void tail_counts(const nl::Column& z, int lo, int hi, float b,
                                            float t, int* below, int* above) {
    int nb = 0, na = 0;
    for (int i = lo; i < hi; ++i) {
        float v = z[i];
        nb += v < b;
        na += v > t;
    }
    *below = nb;
    *above = na;
}

// Winsorized stddev fixed point of the sorted range [lo, hi) about median.
__device__ float winsor_std(const nl::Column& z, const nl::Column& s1, const nl::Column& s2,
                            int lo, int hi, float median, float std0) {
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
        tail_counts(z, lo, hi, nlo, nhi, &below, &above);
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

__global__ void stack_clip_kernel(const float* __restrict__ frames,
                                  const float* __restrict__ weights, int n, long long stride,
                                  long long Q, float sigma_lo, float sigma_hi, float ref_loc,
                                  int winsorize, float* scratch, float* __restrict__ out,
                                  int* __restrict__ clips) {
    long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= Q) return;
    const bool weighted = weights != nullptr;
    // scratch rows of Q pixels: z[n] | s1[n+1] | s2[n+1] | w[n] | w1[n+1] | wv1[n+1]
    nl::Column z{scratch + p, Q};
    nl::Column s1{scratch + (long long)n * Q + p, Q};
    nl::Column s2{scratch + (long long)(2 * n + 1) * Q + p, Q};
    nl::Column w{scratch + (long long)(3 * n + 2) * Q + p, Q};
    nl::Column w1{scratch + (long long)(4 * n + 2) * Q + p, Q};
    nl::Column wv1{scratch + (long long)(5 * n + 3) * Q + p, Q};

    int cnt0 = 0;
    for (int i = 0; i < n; ++i) {
        float v = frames[(long long)i * stride + p];
        bool ok = v == v;
        z[i] = ok ? v : NL_BIG;
        if (weighted) w[i] = weights[i];
        cnt0 += ok;
    }
    nl::insertion_sort(z, weighted ? &w : nullptr, n);

    float center = cnt0 > 0 ? median_range(z, 0, cnt0) : 0.f;
    float a1 = 0.f, a2 = 0.f, b1 = 0.f, b2 = 0.f;
    s1[0] = 0.f;
    s2[0] = 0.f;
    if (weighted) {
        w1[0] = 0.f;
        wv1[0] = 0.f;
    }
    for (int i = 0; i < n; ++i) {
        float v = i < cnt0 ? z[i] - center : 0.f;
        z[i] = v;
        a1 = a1 + v;
        a2 = a2 + v * v;
        s1[i + 1] = a1;
        s2[i + 1] = a2;
        if (weighted) {
            b1 = b1 + w[i];
            b2 = b2 + w[i] * v;
            w1[i + 1] = b1;
            wv1[i + 1] = b2;
        }
    }

    int lo = 0, hi = cnt0, clo = 0, chi = 0;
    float result = ref_loc;
    bool running = cnt0 > 0;
    for (int it = 0; running && it < n + 1; ++it) {
        int cnt = hi - lo;
        float cf = (float)(cnt > 1 ? cnt : 1);
        float median = median_range(z, lo, cnt);
        float mean = (s1[hi] - s1[lo]) / cf;
        float var = (s2[hi] - s2[lo]) / cf - mean * mean;
        float std = sqrtf(fmaxf(var, 0.f));
        if (winsorize) std = winsor_std(z, s1, s2, lo, hi, median, std);
        float low_b = median - sigma_lo * std;
        float high_b = median + sigma_hi * std;
        int below, above;
        tail_counts(z, lo, hi, low_b, high_b, &below, &above);
        int new_lo = lo + below, new_hi = hi - above;
        int new_cnt = new_hi - new_lo;
        bool stop = (below + above == 0) || new_cnt <= 1;
        if (stop) {
            if (weighted) {
                float ws = w1[new_hi] - w1[new_lo], wv = wv1[new_hi] - wv1[new_lo];
                float ws_pre = w1[hi] - w1[lo], wv_pre = wv1[hi] - wv1[lo];
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
    out[p] = cnt0 > 0 ? result + center : ref_loc;
    clips[p] = clo;
    clips[stride + p] = chi;
}

}  // namespace

// One launch stacks the Q pixels starting at `frames`, `out` and `clips`,
// whose rows are `stride` floats apart (frames (n, stride), clips (2,
// stride)), so a caller can bound the scratch by launching pixel chunks.
// Scratch: 3n+2 rows of Q floats, or 6n+4 for the weighted variant.
extern "C" int nl_stack_clip(const float* frames, const float* weights, int n,
                             long long stride, long long Q, float sigma_lo, float sigma_hi,
                             float ref_loc, int winsorize, float* scratch, float* out,
                             int* clips, void* stream) {
    const int threads = 256;
    if (Q > 0) {
        stack_clip_kernel<<<nl::blocks_for(Q, threads), threads, 0, (cudaStream_t)stream>>>(
            frames, weights, n, stride, Q, sigma_lo, sigma_hi, ref_loc, winsorize, scratch,
            out, clips);
    }
    return (int)cudaGetLastError();
}
