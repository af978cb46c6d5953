// K3: NaN-skipping median stack and single-pass MAD sigma-clipped mean.
//
// Replaces the Pallas TPU kernel nightlight_tpu/ops/stack_pallas.py
// _stack_single_pass_pallas (body _make_single_pass_kernel; public
// stack_single_pass_pallas), and computes the same per-pixel function, in
// the arithmetic of the JAX package's XLA twins (ops/stack.py stack_median
// and stack_mad_sigma), which the plain PyTorch version in
// ops/stack_cuda.py follows too:
//   * the frame column is sorted ascending with NaN (missing) last;
//   * the median of the cnt0 valid samples has quickselect semantics: the
//     middle one, or the mean of the two middle ones for an even count;
//   * mad = 0 stops there: the result is the median, ref_loc where the
//     column has no valid sample, and no clip counts;
//   * mad = 1 sorts the absolute deviations from the median of the valid
//     samples, takes their median times 1.4826 as std, keeps the samples in
//     [median - sigma_lo * std, median + sigma_hi * std] and returns the
//     mean of the kept ones, summed in ascending order; 0.0 when nothing is
//     kept, ref_loc when nothing is valid. Per-pixel counts of the samples
//     below and above the bounds go to clips[0, p] and clips[1, p].
//
// What bounds it on the H100: each pixel is independent, so the design is
// one thread per pixel with no communication, as in K1. The TPU kernel ran
// two Batcher networks over (n_pad, tile) rows in VMEM; here a thread
// insertion-sorts its column in global scratch laid out (rows, Q) like the
// input (element i of pixel p at i*Q + p), so each access of a warp is one
// coalesced 128-byte line that stays in L1/L2 while the warp works. The
// wrapper launches pixel chunks of Q so that the scratch (1x the chunk's
// frames for the median, 2x for MAD) stays within a fixed budget beside a
// batch that fills the card. There is no clip loop, so the O(n^2) sorts
// (one, or two for MAD) bound the kernel, not its single pass over device
// memory.
#include "common.cuh"

namespace {

__device__ __forceinline__ float median_prefix(const nl::Column& z, int cnt) {
    int c1 = cnt > 1 ? cnt : 1;
    float upper = z[c1 / 2];
    int li = c1 / 2 - 1;
    float lower = z[li > 0 ? li : 0];
    return (c1 % 2 == 1) ? upper : 0.5f * (lower + upper);
}

__global__ void stack_single_pass_kernel(const float* __restrict__ frames, int n,
                                         long long stride, long long Q, float sigma_lo,
                                         float sigma_hi, float ref_loc, int mad,
                                         float* scratch, float* __restrict__ out,
                                         int* __restrict__ clips) {
    long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= Q) return;
    // scratch rows of Q pixels: z[n] (sorted samples) | d[n] (sorted deviations)
    nl::Column z{scratch + p, Q};
    nl::Column d{scratch + (long long)n * Q + p, Q};

    int cnt0 = 0;
    for (int i = 0; i < n; ++i) {
        float v = frames[(long long)i * stride + p];
        bool ok = v == v;
        z[i] = ok ? v : NL_BIG;
        cnt0 += ok;
    }
    nl::insertion_sort(z, nullptr, n);
    float median = median_prefix(z, cnt0);
    if (!mad) {
        out[p] = cnt0 > 0 ? median : ref_loc;
        clips[p] = 0;
        clips[stride + p] = 0;
        return;
    }

    // deviations of the valid samples; the BIG tail of the plain version's
    // full-column sort never moves below them, so sorting cnt0 suffices
    for (int i = 0; i < cnt0; ++i) d[i] = fabsf(z[i] - median);
    nl::insertion_sort(d, nullptr, cnt0);
    float std = median_prefix(d, cnt0) * 1.4826f;
    float lo_b = median - sigma_lo * std;
    float hi_b = median + sigma_hi * std;

    float acc = 0.f;
    int kept = 0, clo = 0, chi = 0;
    for (int i = 0; i < cnt0; ++i) {
        float v = z[i];
        bool below = v < lo_b, above = v > hi_b;
        clo += below;
        chi += above;
        if (!below && !above) {
            acc = acc + v;
            ++kept;
        }
    }
    out[p] = cnt0 > 0 ? acc / (float)(kept > 1 ? kept : 1) : ref_loc;
    clips[p] = clo;
    clips[stride + p] = chi;
}

}  // namespace

// One launch stacks the Q pixels starting at `frames`, `out` and `clips`,
// whose rows are `stride` floats apart (frames (n, stride), clips (2,
// stride)), so a caller can bound the scratch by launching pixel chunks.
// Scratch: n rows of Q floats for the median, 2n for MAD.
extern "C" int nl_stack_single_pass(const float* frames, int n, long long stride, long long Q,
                                    float sigma_lo, float sigma_hi, float ref_loc, int mad,
                                    float* scratch, float* out, int* clips, void* stream) {
    const int threads = 256;
    if (Q > 0) {
        stack_single_pass_kernel<<<nl::blocks_for(Q, threads), threads, 0,
                                   (cudaStream_t)stream>>>(frames, n, stride, Q, sigma_lo,
                                                           sigma_hi, ref_loc, mad, scratch,
                                                           out, clips);
    }
    return (int)cudaGetLastError();
}
