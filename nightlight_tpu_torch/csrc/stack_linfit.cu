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
//     initialised to ref_loc. Per-pixel clip counts go to clips[0|1, p].
//
// What bounds it on the H100: per-pixel independence again, so one thread
// per pixel. The TPU kernel needed a Hillis-Steele scan to get ranks across
// VMEM rows; a thread here walks its own column in order, so the rank is a
// running counter and each round is a few sequential passes over the
// column. The sorted column and the active mask live in global scratch laid
// out (n, Q) for coalesced warp access, Q being the wrapper's pixel chunk;
// the kernel is bound by that cached
// column traffic (about seven passes per round) and by divergence between
// lanes that stop in different rounds.
#include "common.cuh"

namespace {

__global__ void stack_linfit_kernel(const float* __restrict__ frames, int n,
                                    long long stride, long long Q, float sigma_lo,
                                    float sigma_hi, float ref_loc, float* scratch_v,
                                    uint8_t* scratch_a, float* __restrict__ out,
                                    int* __restrict__ clips) {
    long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= Q) return;
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
    clips[p] = clo;
    clips[stride + p] = chi;
}

}  // namespace

// One launch stacks the Q pixels starting at `frames`, `out` and `clips`,
// whose rows are `stride` floats apart; scratch is n rows of Q floats and n
// rows of Q bytes (see nl_stack_clip).
extern "C" int nl_stack_linfit(const float* frames, int n, long long stride, long long Q,
                               float sigma_lo, float sigma_hi, float ref_loc,
                               float* scratch_v, uint8_t* scratch_a, float* out, int* clips,
                               void* stream) {
    const int threads = 256;
    if (Q > 0) {
        stack_linfit_kernel<<<nl::blocks_for(Q, threads), threads, 0, (cudaStream_t)stream>>>(
            frames, n, stride, Q, sigma_lo, sigma_hi, ref_loc, scratch_v, scratch_a, out,
            clips);
    }
    return (int)cudaGetLastError();
}
