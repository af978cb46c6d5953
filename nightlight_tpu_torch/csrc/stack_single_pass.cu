// K3: NaN-skipping median stack and single-pass MAD sigma-clipped mean.
//
// Replaces the Pallas TPU kernel nightlight_tpu/ops/stack_pallas.py
// _stack_single_pass_pallas (body _make_single_pass_kernel; public
// stack_single_pass_pallas), and computes the same per-pixel function, in
// the arithmetic of the JAX package's XLA twins (ops/stack.py stack_median
// and stack_mad_sigma), which the plain PyTorch version in
// ops/stack_cuda.py follows too (csrc/single_pass.cuh states it):
//   * the frame column is sorted ascending with NaN (missing) last;
//   * mad = 0: the median of the cnt0 valid samples (quickselect semantics),
//     ref_loc where the column has no valid sample, and no clip counts;
//   * mad = 1: std = 1.4826 * the median absolute deviation, one clip pass,
//     the mean of the kept samples in ascending order; the low and high clip
//     counts are summed over each warp into partials[2w|2w+1]
//     (nl::write_clip_partials), which the wrapper adds up.
//
// What bounds it on the H100: each pixel is independent, one thread per
// pixel. The least the card can do is one read of the frames (4n bytes a
// pixel) and the write of the result; the work is a sort of n values (and
// for MAD the order statistic of the deviations and one pass), with no
// data-dependent rounds, so unlike K1/K2 a warp's lanes run the same
// instructions. Three designs, chosen by the frame count alone
// (ops/stack_cuda.py _single_pass_plan):
//
//   * registers (n <= 64; nl_stack_single_pass_onchip with 8-64 wires). The
//     column is read once, coalesced, n loads in flight a thread, and sorted
//     by the shared Batcher network (sortnet.cuh) fully unrolled; the median
//     rows are picked by unrolled selects, since a run-time index into a
//     register array would spill it to local memory; MAD sorts the
//     deviations with a bitonic merger (they form a bitonic sequence) and
//     runs the clip pass unrolled. Nothing goes to memory but the result.
//   * shared memory (65-256 frames; 128 and 256 wires). The column lives in
//     dynamic shared memory laid out [row][thread] (the lanes of a warp hit
//     distinct banks), the network runs as a loop pruned to n rows, and the
//     MAD's order statistic is a merge outward from the median's row, O(n)
//     instead of a second sort.
//   * global scratch (n > 256; nl_stack_single_pass). The first design of the
//     port: the column in scratch laid out (rows, Q) like the input,
//     insertion-sorted (twice for MAD) through L1/L2, launched in pixel
//     chunks so the scratch stays within a fixed budget. Kept for batches
//     past the largest on-chip network, and for comparison.
// All three run the same float operations on the same values (-fmad=false),
// so all match the plain version bit for bit.
#include "common.cuh"
#include "single_pass.cuh"
#include "sortnet.cuh"

namespace {

// ---------------------------------------------------------------------------
// On chip: registers up to 64 wires, shared memory at 128 and 256
// ---------------------------------------------------------------------------

template <int W, bool MAD>
__device__ __forceinline__ single_pass::Result single_pass_pixel(const float* __restrict__ frames,
                                                                 int n, long long P, long long p,
                                                                 float sigma_lo, float sigma_hi,
                                                                 float ref_loc) {
    int cnt0 = 0;
    if constexpr (W <= 64) {
        float v[W];
#pragma unroll
        for (int i = 0; i < W; ++i) {
            float x = i < n ? frames[(long long)i * P + p] : NL_BIG;
            bool ok = i < n && x == x;
            v[i] = ok ? x : NL_BIG;
            cnt0 += ok;
        }
        return single_pass::pixel_regs<W, MAD>(v, cnt0, sigma_lo, sigma_hi, ref_loc);
    } else {
        extern __shared__ float smem[];
        const nl::SharedColumn z{smem + threadIdx.x, (int)blockDim.x};
        for (int i = 0; i < n; ++i) {
            float x = frames[(long long)i * P + p];
            bool ok = x == x;
            z[i] = ok ? x : NL_BIG;
            cnt0 += ok;
        }
        return single_pass::pixel_column<MAD>(z, W, n, cnt0, sigma_lo, sigma_hi, ref_loc);
    }
}

template <int W, bool MAD>
__global__ void __launch_bounds__(256)
    stack_single_pass_onchip_kernel(const float* __restrict__ frames, int n, long long P,
                                    float sigma_lo, float sigma_hi, float ref_loc,
                                    float* __restrict__ out, int* __restrict__ partials) {
    long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    int clo = 0, chi = 0;
    if (p < P) {
        single_pass::Result r =
            single_pass_pixel<W, MAD>(frames, n, P, p, sigma_lo, sigma_hi, ref_loc);
        out[p] = r.out;
        clo = r.clo;
        chi = r.chi;
    }
    if constexpr (MAD) nl::write_clip_partials(clo, chi, partials);
}

// ---------------------------------------------------------------------------
// Global scratch (frame counts beyond the on-chip limit)
// ---------------------------------------------------------------------------

__device__ __forceinline__ single_pass::Result single_pass_pixel_scratch(
    const float* __restrict__ frames, int n, long long stride, long long Q, long long p,
    float sigma_lo, float sigma_hi, float ref_loc, int mad, float* scratch) {
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
    float median = single_pass::median_column(z, cnt0);
    if (!mad) return single_pass::Result{cnt0 > 0 ? median : ref_loc, 0, 0};

    // deviations of the valid samples; the BIG tail of the plain version's
    // full-column sort never moves below them, so sorting cnt0 suffices
    for (int i = 0; i < cnt0; ++i) d[i] = fabsf(z[i] - median);
    nl::insertion_sort(d, nullptr, cnt0);
    float std = single_pass::median_column(d, cnt0) * single_pass::kMadScale;
    return single_pass::clip_pass<0>([&](int i) { return z[i]; }, cnt0, median, std, sigma_lo,
                                     sigma_hi, ref_loc);
}

__global__ void stack_single_pass_kernel(const float* __restrict__ frames, int n,
                                         long long stride, long long Q, float sigma_lo,
                                         float sigma_hi, float ref_loc, int mad,
                                         float* scratch, float* __restrict__ out,
                                         int* __restrict__ partials) {
    long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    int clo = 0, chi = 0;
    if (p < Q) {
        single_pass::Result r = single_pass_pixel_scratch(frames, n, stride, Q, p, sigma_lo,
                                                          sigma_hi, ref_loc, mad, scratch);
        out[p] = r.out;
        clo = r.clo;
        chi = r.chi;
    }
    if (mad) nl::write_clip_partials(clo, chi, partials);
}

}  // namespace

// Global-scratch design. One launch stacks the Q pixels starting at
// `frames` (rows `stride` floats apart) and `out`, so a caller can bound the
// scratch by launching pixel chunks, each with its own run of `partials`
// (two ints for each warp of the launch; MAD only, null for the median).
// Scratch: n rows of Q floats for the median, 2n for MAD.
extern "C" int nl_stack_single_pass(const float* frames, int n, long long stride, long long Q,
                                    float sigma_lo, float sigma_hi, float ref_loc, int mad,
                                    float* scratch, float* out, int* partials, int device,
                                    void* stream) {
    NL_USE_DEVICE(device);
    const int threads = 256;
    if (mad && partials == nullptr) return (int)cudaErrorInvalidValue;
    if (Q > 0) {
        stack_single_pass_kernel<<<nl::blocks_for(Q, threads), threads, 0,
                                   (cudaStream_t)stream>>>(frames, n, stride, Q, sigma_lo,
                                                           sigma_hi, ref_loc, mad, scratch,
                                                           out, partials);
    }
    return (int)cudaGetLastError();
}

// On-chip design over all P pixels of frames (n, P) in one launch: `wires`
// 8-64 in registers (no shared memory), 128 or 256 in shared memory;
// `threads` per block (a multiple of 32, at most 256) and `smem` bytes of
// dynamic shared memory, at least 4 * n * threads above 64 wires
// (ops/stack_cuda.py _single_pass_plan picks all three). MAD writes the clip
// counts of each warp to `partials`; the median writes none (null).
extern "C" int nl_stack_single_pass_onchip(const float* frames, int n, long long P,
                                           float sigma_lo, float sigma_hi, float ref_loc, int mad,
                                           int wires, int threads, int smem, float* out,
                                           int* partials, int device, void* stream) {
    NL_USE_DEVICE(device);
    long long need = wires > 64 ? 4LL * n * threads : 0;
    if (n < 1 || n > wires || threads < 32 || threads > 256 || threads % 32 != 0 ||
        smem < need || (mad && partials == nullptr))
        return (int)cudaErrorInvalidValue;
    if (P <= 0) return (int)cudaSuccess;
    cudaStream_t s = (cudaStream_t)stream;
    int blocks = nl::blocks_for(P, threads);
    auto launch = [&](auto kernel) {
        if (smem > 0) {
            cudaError_t e =
                cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
            if (e != cudaSuccess) return (int)e;
        }
        kernel<<<blocks, threads, smem, s>>>(frames, n, P, sigma_lo, sigma_hi, ref_loc, out,
                                             partials);
        return (int)cudaGetLastError();
    };
    auto by_mode = [&](auto median_kernel, auto mad_kernel) {
        return mad ? launch(mad_kernel) : launch(median_kernel);
    };
    switch (wires) {
        case 8: return by_mode(stack_single_pass_onchip_kernel<8, false>,
                               stack_single_pass_onchip_kernel<8, true>);
        case 16: return by_mode(stack_single_pass_onchip_kernel<16, false>,
                                stack_single_pass_onchip_kernel<16, true>);
        case 32: return by_mode(stack_single_pass_onchip_kernel<32, false>,
                                stack_single_pass_onchip_kernel<32, true>);
        case 64: return by_mode(stack_single_pass_onchip_kernel<64, false>,
                                stack_single_pass_onchip_kernel<64, true>);
        case 128: return by_mode(stack_single_pass_onchip_kernel<128, false>,
                                 stack_single_pass_onchip_kernel<128, true>);
        case 256: return by_mode(stack_single_pass_onchip_kernel<256, false>,
                                 stack_single_pass_onchip_kernel<256, true>);
        default: return (int)cudaErrorInvalidValue;
    }
}
