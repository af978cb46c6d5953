// K2: linear-fit clipping stack.
//
// Replaces the Pallas TPU kernel nightlight_tpu/ops/stack_pallas.py
// _stack_linfit_pallas (body _make_linfit_kernel; public
// stack_linfit_pallas), computing the same per-pixel function:
//   * the frame column is sorted ascending, NaN (missing) last;
//   * each round, every active sample's rank is the exclusive prefix count
//     of the active mask; value is regressed on rank with the reference's
//     correlation divisor (c + 1); sigma is the mean |residual|; samples
//     whose residual falls below -sigma_lo*sigma or above sigma_hi*sigma are
//     rejected on both sides at once;
//   * a pixel stops on zero rejects or fewer than 3 active samples (its
//     rejects of that round still count), at most n+1 rounds;
//   * the result is the mean of the active samples at the stopping round,
//     initialised to ref_loc. The clip counts are summed over each warp
//     into partials[2w|2w+1] (common.cuh write_clip_partials).
//
// What bounds it on the H100: per-pixel independence again, so one thread
// per pixel. The least the card can do is one read of the frames (4n bytes
// a pixel) and the write of the result; the work is a sort and as many
// rounds of sequential passes over the active samples as the data needs
// (the rank is a running counter, where the TPU kernel needed a
// Hillis-Steele scan across VMEM rows), so a warp runs as many rounds as its
// slowest pixel. Two designs:
//
//   * on chip (n <= 256; nl_stack_linfit_onchip). The column is read once,
//     coalesced, and sorted by the shared Batcher network (sortnet.cuh). The
//     sort orders values only: the kernel reads nothing but the sorted
//     values, so which of two equal values comes first cannot change an
//     operation (and the sign of a zero cannot change a sum that starts at
//     +0 or a comparison). The active set is a bitmask in registers (one
//     64-bit word per 64 rows); every pass visits its samples in ascending
//     order, so ranks, sums and rejections are the float operations of the
//     scratch design in the same order. A round is three passes: the
//     rejection pass also builds the mask of this round's rejects and the
//     next round's count and sums over the samples that stay, which the
//     scratch design finds again in a fifth and a first pass.
//     At 32 and 64 wires everything stays in registers: the network and
//     every pass are unrolled over the wires, each step predicated on its
//     sample's bit. At 128 and 256 wires the column lives in dynamic shared
//     memory laid out [row][thread], the network runs as a loop over it, and
//     the passes walk the set bits (__ffsll).
//   * global scratch (n > 256; nl_stack_linfit). The sorted column and a
//     byte mask live in scratch laid out (n, Q) for coalesced warp access,
//     Q being the wrapper's pixel chunk; insertion sort, five passes a
//     round. The first design of the port, kept for batches past the
//     largest on-chip network.
#include "common.cuh"
#include "sortnet.cuh"

namespace {

__device__ __forceinline__ void linfit_pixel_scratch(const float* __restrict__ frames, int n,
                                                     long long stride, long long Q, long long p,
                                                     float sigma_lo, float sigma_hi,
                                                     float ref_loc, float* scratch_v,
                                                     uint8_t* scratch_a, float* __restrict__ out,
                                                     int* clo_out, int* chi_out) {
    nl::Column y{scratch_v + p, Q};
    nl::ByteColumn act{scratch_a + p, Q};

    int cnt0 = 0;
    for (int i = 0; i < n; ++i) {
        float v = frames[(long long)i * stride + p];
        bool ok = v == v;
        y[i] = ok ? v : NL_BIG;
        cnt0 += ok;
    }
    nl::insertion_sort(y, nullptr, n);
    for (int i = 0; i < n; ++i) {
        bool a = i < cnt0;
        act[i] = a;
        if (!a) y[i] = 0.f;  // padded entries read as 0, as in the TPU kernel
    }

    float result = ref_loc;
    int clo = 0, chi = 0;
    bool running = cnt0 > 0;
    for (int it = 0; running && it < n + 1; ++it) {
        // pass 1: count, rank sums and value sums over the active samples
        float cnt = 0.f, sx = 0.f, sy = 0.f;
        float rank = 0.f;
        for (int i = 0; i < n; ++i) {
            if (act[i]) {
                sx += rank;
                sy += y[i];
                cnt += 1.f;
                rank += 1.f;
            }
        }
        float c = fmaxf(cnt, 1.f);
        float xmean = sx / c, ymean = sy / c;
        // pass 2: second moments about the means
        float sxx = 0.f, syy = 0.f, sxy = 0.f;
        rank = 0.f;
        for (int i = 0; i < n; ++i) {
            if (act[i]) {
                float dx = rank - xmean, dy = y[i] - ymean;
                sxx += dx * dx;
                syy += dy * dy;
                sxy += dx * dy;
                rank += 1.f;
            }
        }
        float xstd = sqrtf(sxx / c), ystd = sqrtf(syy / c);
        float corr = sxy / (xstd * ystd * (c + 1.f) + 1e-30f);
        float slope = corr * ystd / (xstd + 1e-30f);
        float intercept = ymean - slope * xmean;
        // pass 3: mean absolute residual
        float sabs = 0.f;
        rank = 0.f;
        for (int i = 0; i < n; ++i) {
            if (act[i]) {
                sabs += fabsf(y[i] - (rank * slope + intercept));
                rank += 1.f;
            }
        }
        float sigma = sabs / c;
        // pass 4: rejections
        int rlo = 0, rhi = 0;
        rank = 0.f;
        for (int i = 0; i < n; ++i) {
            if (act[i]) {
                float resid = y[i] - (rank * slope + intercept);
                rlo += (-resid) > sigma_lo * sigma;
                rhi += resid > sigma_hi * sigma;
                rank += 1.f;
            }
        }
        bool stop = (rlo + rhi == 0) || cnt < 3.f;
        if (stop) result = ymean;
        clo += rlo;
        chi += rhi;
        if (!stop) {
            // pass 5: drop this round's rejects (ranks of the pre-drop mask)
            rank = 0.f;
            for (int i = 0; i < n; ++i) {
                if (act[i]) {
                    float resid = y[i] - (rank * slope + intercept);
                    if ((-resid) > sigma_lo * sigma || resid > sigma_hi * sigma) act[i] = 0;
                    rank += 1.f;
                }
            }
        }
        running = !stop;
    }
    out[p] = result;
    *clo_out = clo;
    *chi_out = chi;
}

__global__ void stack_linfit_scratch_kernel(const float* __restrict__ frames, int n,
                                            long long stride, long long Q, float sigma_lo,
                                            float sigma_hi, float ref_loc, float* scratch_v,
                                            uint8_t* scratch_a, float* __restrict__ out,
                                            int* __restrict__ partials) {
    long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    int clo = 0, chi = 0;
    if (p < Q)
        linfit_pixel_scratch(frames, n, stride, Q, p, sigma_lo, sigma_hi, ref_loc, scratch_v,
                             scratch_a, out, &clo, &chi);
    nl::write_clip_partials(clo, chi, partials);
}

// ---------------------------------------------------------------------------
// On chip
// ---------------------------------------------------------------------------

// value-only compare-exchanges: registers (constant wires) and shared memory
template <int W>
struct MinMaxRegs {
    float (&v)[W];
    template <int a, int b>
    __device__ __forceinline__ void apply() {
        float x = v[a], y = v[b];
        v[a] = fminf(x, y);
        v[b] = fmaxf(x, y);
    }
};

struct MinMaxShared {
    nl::SharedColumn v;
    __host__ __device__ __forceinline__ void operator()(int a, int b) {
        float x = v[a], y = v[b];
        if (y < x) {
            v[a] = y;
            v[b] = x;
        }
    }
};

__device__ __forceinline__ uint64_t low_bits(int k) {
    return k >= 64 ? ~0ull : (k <= 0 ? 0ull : (1ull << k) - 1);
}

// The active samples of one pixel, visited in ascending row order by
// each(f), f(value, word, bit). In registers (W <= 64 wires): every pass is
// unrolled over the wires and predicated on the sample's bit, so each
// index and shift is a constant and the column never leaves registers.
template <int W>
struct RegsActive {
    static constexpr int kWords = 1;
    float (&v)[W];
    uint64_t act[1];
    template <typename F>
    __device__ __forceinline__ void each(F f) const {
#pragma unroll
        for (int i = 0; i < W; ++i)
            if ((act[0] >> i) & 1ull) f(v[i], 0, 1ull << i);
    }
};

// In shared memory (128 or 256 wires): the sorted column [row][thread], the
// passes walking the set bits of each 64-row word with __ffsll.
template <int W>
struct SharedActive {
    static constexpr int kWords = W / 64;
    nl::SharedColumn y;
    uint64_t act[kWords];
    template <typename F>
    __device__ __forceinline__ void each(F f) const {
#pragma unroll
        for (int w = 0; w < kWords; ++w) {
            uint64_t m = act[w];
            while (m) {
                int b = __ffsll((long long)m) - 1;
                m &= m - 1;
                f(y[w * 64 + b], w, 1ull << b);
            }
        }
    }
};

// The clip rounds over the active set `a` (the first cnt0 sorted rows):
// the float operations of the scratch kernel's passes in the same order.
// Pass 1 of a round (count, rank sum, value sum) is folded into the
// rejection pass of the round before, over the samples that stay.
template <typename Active>
__device__ __forceinline__ void linfit_rounds(Active& a, int n, int cnt0, float sigma_lo,
                                              float sigma_hi, float ref_loc, float* result_out,
                                              int* clo_out, int* chi_out) {
    constexpr int NW = Active::kWords;
    float cnt = 0.f, sx = 0.f, sy = 0.f;  // the rank of a sample is the count before it
    a.each([&](float y, int, uint64_t) {
        sx += cnt;
        sy += y;
        cnt += 1.f;
    });
    float result = ref_loc;
    int clo = 0, chi = 0;
    bool running = cnt0 > 0;
    for (int it = 0; running && it < n + 1; ++it) {
        float c = fmaxf(cnt, 1.f);
        float xmean = sx / c, ymean = sy / c;
        // pass 2: second moments about the means
        float sxx = 0.f, syy = 0.f, sxy = 0.f, rank = 0.f;
        a.each([&](float y, int, uint64_t) {
            float dx = rank - xmean, dy = y - ymean;
            sxx += dx * dx;
            syy += dy * dy;
            sxy += dx * dy;
            rank += 1.f;
        });
        float xstd = sqrtf(sxx / c), ystd = sqrtf(syy / c);
        float corr = sxy / (xstd * ystd * (c + 1.f) + 1e-30f);
        float slope = corr * ystd / (xstd + 1e-30f);
        float intercept = ymean - slope * xmean;
        // pass 3: mean absolute residual
        float sabs = 0.f;
        rank = 0.f;
        a.each([&](float y, int, uint64_t) {
            sabs += fabsf(y - (rank * slope + intercept));
            rank += 1.f;
        });
        float sigma = sabs / c;
        // pass 4: rejections (ranks of the pre-drop set) and their mask, and
        // pass 1 of the next round over the samples that stay
        int rlo = 0, rhi = 0;
        uint64_t rej[NW];
#pragma unroll
        for (int w = 0; w < NW; ++w) rej[w] = 0;
        float ncnt = 0.f, nsx = 0.f, nsy = 0.f;
        rank = 0.f;
        a.each([&](float y, int w, uint64_t bit) {
            float resid = y - (rank * slope + intercept);
            bool lo = (-resid) > sigma_lo * sigma;
            bool hi = resid > sigma_hi * sigma;
            rlo += lo;
            rhi += hi;
            if (lo || hi) {
                rej[w] |= bit;
            } else {
                nsx += ncnt;
                nsy += y;
                ncnt += 1.f;
            }
            rank += 1.f;
        });
        bool stop = (rlo + rhi == 0) || cnt < 3.f;
        if (stop) result = ymean;
        clo += rlo;
        chi += rhi;
        if (!stop) {
#pragma unroll
            for (int w = 0; w < NW; ++w) a.act[w] &= ~rej[w];
            cnt = ncnt;
            sx = nsx;
            sy = nsy;
        }
        running = !stop;
    }
    *result_out = result;
    *clo_out = clo;
    *chi_out = chi;
}

// One pixel, W = 32 or 64 wires: column, network and passes in registers
template <int W>
__device__ __forceinline__ void linfit_pixel_regs(const float* __restrict__ frames, int n,
                                                  long long P, long long p, float sigma_lo,
                                                  float sigma_hi, float ref_loc,
                                                  float* __restrict__ out, int* clo, int* chi) {
    float v[W];
    int cnt0 = 0;
#pragma unroll
    for (int i = 0; i < W; ++i) {
        float x = i < n ? frames[(long long)i * P + p] : NL_BIG;
        bool ok = i < n && x == x;
        v[i] = ok ? x : NL_BIG;
        cnt0 += ok;
    }
    MinMaxRegs<W> ce{v};
    sortnet::run<W, W>(ce);
    RegsActive<W> a{v, {low_bits(cnt0)}};
    float result;
    linfit_rounds(a, n, cnt0, sigma_lo, sigma_hi, ref_loc, &result, clo, chi);
    out[p] = result;
}

// One pixel, W = 128 or 256 wires: the column and the network loop in
// shared memory
template <int W>
__device__ __forceinline__ void linfit_pixel_smem(const float* __restrict__ frames, int n,
                                                  long long P, long long p, float sigma_lo,
                                                  float sigma_hi, float ref_loc,
                                                  float* __restrict__ out, int* clo, int* chi) {
    extern __shared__ float smem[];
    SharedActive<W> a{nl::SharedColumn{smem + threadIdx.x, (int)blockDim.x}, {}};
    int cnt0 = 0;
    for (int i = 0; i < n; ++i) {
        float x = frames[(long long)i * P + p];
        bool ok = x == x;
        a.y[i] = ok ? x : NL_BIG;
        cnt0 += ok;
    }
    MinMaxShared ce{a.y};
    sortnet::for_each_pair(W, n, ce);
#pragma unroll
    for (int w = 0; w < W / 64; ++w) a.act[w] = low_bits(cnt0 - 64 * w);
    float result;
    linfit_rounds(a, n, cnt0, sigma_lo, sigma_hi, ref_loc, &result, clo, chi);
    out[p] = result;
}

template <int W>
__global__ void __launch_bounds__(256)
    stack_linfit_onchip_kernel(const float* __restrict__ frames, int n, long long P,
                               float sigma_lo, float sigma_hi, float ref_loc,
                               float* __restrict__ out, int* __restrict__ partials) {
    long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    int clo = 0, chi = 0;
    if (p < P) {
        if constexpr (W <= 64)
            linfit_pixel_regs<W>(frames, n, P, p, sigma_lo, sigma_hi, ref_loc, out, &clo, &chi);
        else
            linfit_pixel_smem<W>(frames, n, P, p, sigma_lo, sigma_hi, ref_loc, out, &clo, &chi);
    }
    nl::write_clip_partials(clo, chi, partials);
}

}  // namespace

// Global-scratch design. One launch stacks the Q pixels starting at
// `frames` (rows `stride` floats apart) and `out`, the clip counts of each
// warp to `partials`; scratch is n rows of Q floats and n rows of Q bytes
// (see nl_stack_clip).
extern "C" int nl_stack_linfit(const float* frames, int n, long long stride, long long Q,
                               float sigma_lo, float sigma_hi, float ref_loc,
                               float* scratch_v, uint8_t* scratch_a, float* out,
                               int* partials, int device, void* stream) {
    NL_USE_DEVICE(device);
    const int threads = 256;
    if (Q > 0) {
        stack_linfit_scratch_kernel<<<nl::blocks_for(Q, threads), threads, 0,
                                      (cudaStream_t)stream>>>(frames, n, stride, Q, sigma_lo,
                                                              sigma_hi, ref_loc, scratch_v,
                                                              scratch_a, out, partials);
    }
    return (int)cudaGetLastError();
}

// On-chip design over all P pixels of frames (n, P) in one launch, the clip
// counts of each warp to `partials`: `wires` 32 or 64 in registers (no
// shared memory), 128 or 256 in shared memory; `threads` per block (a
// multiple of 32, at most 256) and `smem` bytes of dynamic shared memory,
// at least 4 * n * threads for 128 and 256 wires (ops/stack_cuda.py
// _linfit_plan picks all three).
extern "C" int nl_stack_linfit_onchip(const float* frames, int n, long long P, float sigma_lo,
                                      float sigma_hi, float ref_loc, int wires, int threads,
                                      int smem, float* out, int* partials, int device,
                                      void* stream) {
    NL_USE_DEVICE(device);
    long long need = wires > 64 ? 4LL * n * threads : 0;
    if (n < 1 || n > wires || threads < 32 || threads > 256 || threads % 32 != 0 || smem < need)
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
    switch (wires) {
        case 32: return launch(stack_linfit_onchip_kernel<32>);
        case 64: return launch(stack_linfit_onchip_kernel<64>);
        case 128: return launch(stack_linfit_onchip_kernel<128>);
        case 256: return launch(stack_linfit_onchip_kernel<256>);
        default: return (int)cudaErrorInvalidValue;
    }
}
