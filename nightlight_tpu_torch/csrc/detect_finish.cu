// K8: phases 3-6 of star detection for one frame, the overlap filters, the
// centre of mass, the HFR and the plausibility test, and the compaction of
// the kept stars, mass descending.
//
// Replaces no TPU kernel: in the JAX package these phases are XLA code
// (nightlight_tpu/detect/stars.py _center_of_mass, _hfr, _overlap_filter,
// _find_stars_device). The port's plain version (detect/stars.py _finish)
// is the same eager chain: about 800 small operations a frame on the phase-2
// survivors' (K, 4r+1, 4r+1) patches, and a blocking read each time an
// overlap filter goes round its fixed-point loop and for the count, the
// stars and the average HFR, about 17 ms of host time a frame on the H100
// for tens of microseconds of work. This kernel does the work in two
// launches from one call, with nothing read back: the caller reads a whole
// chunk's rows at once.
//
// What bounds it on the H100: neither bytes nor operations, but latency.
// The patches (4r+1)^2 x 5 bytes a survivor, 9.4 MB for the 443 survivors
// of a 16.8 MP light at r = 16, are read about 12 times from L2 (at most 10
// centre-of-mass rounds and two HFR passes); the filters and the sort are a
// few thousand dependent steps in one block. The design:
//   * candidate_kernel spreads the per-candidate work over the card, one warp
//     a phase-2 survivor (detect_finish.cuh: lane l sums the elements l, l +
//     32, ... of the patch, the lanes combine by shuffles in a fixed
//     butterfly, so every sum's order depends on the radius alone), and
//     writes each survivor's centre, masses, HFR and plausibility;
//   * finish_kernel, one block of 1024 threads, compacts the phase-2 mask in
//     candidate order, runs both overlap filters to their fixed point in
//     shared memory and sorts the kept stars by mass. A filter round tests
//     each candidate only against the candidates whose y lies within
//     radius + 2 (a conflict needs |dy| <= radius + 1), found by a bitonic
//     sort by y, instead of all k^2 pairs: at 1,300 survivors that is tens
//     of pairs a candidate instead of 1,300 (all pairs made K8 3 to 8 times
//     slower on the H100: 0.34 and 1.54 ms a frame against 0.11 and 0.20 ms
//     at 452 and 1,187 survivors, r = 16). The rounds repeat until no
//     candidate changes, which is the plain loop's fixed point (it is
//     unique), with no host round trip.
// The radius is a run-time argument: a warp strides over the patch, with no
// size limit. The candidates of a frame are at most detect/stars.py
// MAX_CANDIDATES (2,048; the wrapper checks): finish_kernel's shared memory
// holds kSlotBytes for each of the power of two at or above them, 54 KiB at
// 2,048.
#include "common.cuh"
#include "detect_finish.cuh"

namespace {

using namespace detect_finish;

constexpr int kWarpsPerBlock = 8;
constexpr int kFinishThreads = 1024;
// shared bytes a candidate slot of finish_kernel: a sort key, x, y, mass,
// the candidate's index in the frame, and three flags
constexpr int kSlotBytes = 8 + 3 * 4 + 4 + 3;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = kLanes / 2; off > 0; off /= 2) v = v + __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

__global__ void __launch_bounds__(kWarpsPerBlock * kLanes)
    candidate_kernel(const float* __restrict__ patches, const uint8_t* __restrict__ oks,
                     const int* __restrict__ cys, const int* __restrict__ cxs,
                     const uint8_t* __restrict__ keep, int k, Params p,
                     const float* __restrict__ location, const float* __restrict__ scale,
                     float star_sig, float* __restrict__ res) {
    const int g = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (g >= k || (keep && !keep[g])) return;  // the whole warp
    p.location = *location;
    p.threshold = com_threshold(p.location, *scale, star_sig);
    const long long area = (long long)(4 * p.radius + 1) * (4 * p.radius + 1);
    const float* patch = patches + g * area;
    const uint8_t* ok = oks + g * area;
    const int cy = cys[g], cx = cxs[g];

    State st = com_start(cy, cx);
    for (int round = 0; round < kRounds && com_active(st); ++round) {
        float sum[3];
        com_lane(p, patch, ok, st, lane, sum);
        for (int q = 0; q < 3; ++q) sum[q] = warp_sum(sum[q]);
        com_update(p, cy, cx, st, sum);
    }
    float sum[2];
    hfr_lane(p, patch, ok, st, lane, sum);
    sum[0] = warp_sum(sum[0]);
    sum[1] = warp_sum(sum[1]);
    const Hfr h = hfr_of(sum);
    float inner_mass;
    int inner_pixels;
    inner_lane(p, patch, ok, st, h.inner_limit, lane, inner_mass, inner_pixels);
    inner_mass = warp_sum(inner_mass);
    inner_pixels = __reduce_add_sync(0xffffffffu, inner_pixels);
    if (lane == 0) {
        res[kX * k + g] = st.px;
        res[kY * k + g] = st.py;
        res[kMass * k + g] = st.mass;
        res[kHfr * k + g] = h.hfr;
        res[kMass2 * k + g] = h.mass2;
        res[kPlausible * k + g] = plausible(p, h, inner_mass, inner_pixels) ? 1.f : 0.f;
    }
}

// Ascending bitonic sort of keys[0, size), size a power of two; every
// thread of the block calls it.
__device__ void block_sort(unsigned long long* keys, int size) {
    for (int span = 2; span <= size; span <<= 1) {
        for (int j = span >> 1; j > 0; j >>= 1) {
            for (int i = threadIdx.x; i < size; i += blockDim.x) {
                const int other = i ^ j;
                if (other > i) {
                    const unsigned long long a = keys[i], b = keys[other];
                    if ((a > b) == ((i & span) == 0)) {
                        keys[i] = b;
                        keys[other] = a;
                    }
                }
            }
            __syncthreads();
        }
    }
}

__device__ __forceinline__ int pow2_at_least(int n) {
    int s = 1;
    while (s < n) s <<= 1;
    return s;
}

__device__ __forceinline__ int key_index(unsigned long long key) {
    return (int)(key & 0xffffffffu);
}

// The overlap filter of candidates [0, n) at (x, y) with masses m: alive
// becomes the fixed point of alive = valid & no alive candidate of higher
// priority within the radius, from alive = valid. `next` is scratch.
__device__ void overlap_filter(int n, const float* x, const float* y, const float* m,
                               const uint8_t* valid, uint8_t* alive, uint8_t* next,
                               unsigned long long* keys, int radius) {
    const float r2 = (float)radius * (float)radius, reach = (float)(radius + 2);
    const int size = pow2_at_least(n);
    for (int s = threadIdx.x; s < size; s += blockDim.x) {
        keys[s] = s < n ? ascending_key(y[s], s) : ~0ull;
        if (s < n) alive[s] = valid[s];
    }
    __syncthreads();
    block_sort(keys, size);
    for (;;) {
        int changed = 0;
        for (int s = threadIdx.x; s < n; s += blockDim.x) {
            const int i = key_index(keys[s]);
            bool a = valid[i];
            // the sorted neighbours within reach in y, below and above (a
            // NaN y is in no one's reach, and conflicts with no one)
            for (int t = s - 1; a && t >= 0; --t) {
                const int j = key_index(keys[t]);
                if (!(y[i] - y[j] <= reach)) break;
                if (valid[j] && alive[j] && dominates(x, y, m, i, j, r2)) a = false;
            }
            for (int t = s + 1; a && t < n; ++t) {
                const int j = key_index(keys[t]);
                if (!(y[j] - y[i] <= reach)) break;
                if (valid[j] && alive[j] && dominates(x, y, m, i, j, r2)) a = false;
            }
            next[i] = a;
            changed |= a != (bool)alive[i];
        }
        if (!__syncthreads_or(changed)) break;
        for (int i = threadIdx.x; i < n; i += blockDim.x) alive[i] = next[i];
        __syncthreads();
    }
}

__global__ void __launch_bounds__(kFinishThreads)
    finish_kernel(const float* __restrict__ res, const int* __restrict__ cys,
                  const int* __restrict__ cxs, const float* __restrict__ vals,
                  const uint8_t* __restrict__ keep, int k, int slots, int radius, int cap,
                  float* __restrict__ out) {
    extern __shared__ unsigned long long smem[];
    unsigned long long* keys = smem;
    float* x = reinterpret_cast<float*>(keys + slots);
    float* y = x + slots;
    float* m = y + slots;
    int* orig = reinterpret_cast<int*>(m + slots);
    uint8_t* valid = reinterpret_cast<uint8_t*>(orig + slots);
    uint8_t* alive = valid + slots;
    uint8_t* next = alive + slots;
    __shared__ int warp_counts[kFinishThreads / 32];
    __shared__ int total, kept_total;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

    // the phase-2 survivors in candidate order: orig[c] is survivor c's index
    if (threadIdx.x == 0) total = 0;
    __syncthreads();
    for (int base = 0; base < k; base += kFinishThreads) {
        const int g = base + threadIdx.x;
        const bool in = g < k && (!keep || keep[g]);
        const unsigned ballot = __ballot_sync(0xffffffffu, in);
        if (lane == 0) warp_counts[warp] = __popc(ballot);
        __syncthreads();
        int before = total;
        for (int w = 0; w < warp; ++w) before += warp_counts[w];
        if (in) orig[before + __popc(ballot & ((1u << lane) - 1u))] = g;
        __syncthreads();
        if (threadIdx.x == 0)
            for (int w = 0; w < kFinishThreads / 32; ++w) total += warp_counts[w];
        __syncthreads();
    }
    const int n = total;

    // phase 3: the filter on the integer centres and the values
    for (int c = threadIdx.x; c < n; c += blockDim.x) {
        const int g = orig[c];
        x[c] = (float)cxs[g];
        y[c] = (float)cys[g];
        m[c] = vals[g];
        valid[c] = 1;
    }
    __syncthreads();
    overlap_filter(n, x, y, m, valid, alive, next, keys, radius);

    // phase 5: on the refined centres and masses, among phase 3's survivors
    for (int c = threadIdx.x; c < n; c += blockDim.x) {
        const int g = orig[c];
        x[c] = res[kX * k + g];
        y[c] = res[kY * k + g];
        m[c] = res[kMass * k + g];
        valid[c] = alive[c];
    }
    __syncthreads();
    overlap_filter(n, x, y, m, valid, alive, next, keys, radius);

    // the plausible survivors by descending HFR mass, ties in candidate order
    if (threadIdx.x == 0) kept_total = 0;
    const int size = pow2_at_least(n);
    int kept = 0;
    for (int s = threadIdx.x; s < size; s += blockDim.x) {
        const bool a = s < n && alive[s] && res[kPlausible * k + orig[s]] != 0.f;
        keys[s] = a ? descending_key(res[kMass2 * k + orig[s]], s) : ~0ull;
        kept += a;
    }
    __syncthreads();
    if (kept) atomicAdd(&kept_total, kept);
    __syncthreads();
    const int num = kept_total;
    block_sort(keys, size);
    for (int j = threadIdx.x; j < num; j += blockDim.x) {
        const int g = orig[key_index(keys[j])];
        const float star[kStarFields] = {res[kX * k + g], res[kY * k + g], vals[g],
                                         res[kMass2 * k + g], res[kHfr * k + g]};
        for (int f = 0; f < kStarFields; ++f) out[kHead + f * cap + j] = star[f];
    }
    // the average HFR over the kept stars in their order, a warp's sum
    if (warp == 0) {
        float acc = 0.f;
        for (int j = lane; j < num; j += kLanes)
            acc = acc + res[kHfr * k + orig[key_index(keys[j])]];
        acc = warp_sum(acc);
        if (lane == 0) {
            out[0] = (float)num;
            out[1] = acc / (float)(num > 1 ? num : 1);
            out[2] = (float)n;
        }
    }
}

}  // namespace

// Phases 3-6 of one frame's k candidates into out, the
// frame's row of kHead + kStarFields * cap floats (cap >= k): the count, the
// average HFR, the phase-2 survivors, then the kept stars' x, y, value, mass
// and hfr, mass descending (each field's first count entries are written).
// patches (k, 4r+1, 4r+1) float32 and oks (same, bytes) are K4's windows of
// radius 2r about the centres (cys, cxs) int32, vals the candidates' values;
// keep (k bytes) their phase-2 mask, or null when all survived.
// location and scale are the frame's, on the card; res is scratch of
// kFields * k floats.
extern "C" int nl_detect_finish(const float* patches, const uint8_t* oks, const int* cys,
                                const int* cxs, const float* vals, const uint8_t* keep, int k,
                                int radius, const float* location, const float* scale,
                                float star_sig, float star_in_out, float dist2_limit,
                                float* res, float* out, int cap, int device, void* stream) {
    NL_USE_DEVICE(device);
    if (k < 0 || radius < 0 || cap < k) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const Params p{radius, 0.f, 0.f, star_in_out, dist2_limit,
                   grid_disk_count(radius, dist2_limit)};
    if (k > 0) {
        candidate_kernel<<<(k + kWarpsPerBlock - 1) / kWarpsPerBlock, kWarpsPerBlock * kLanes, 0,
                           s>>>(patches, oks, cys, cxs, keep, k, p, location, scale, star_sig,
                                res);
        cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    int slots = 1;
    while (slots < k) slots <<= 1;
    const int smem = slots * kSlotBytes;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            finish_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
    }
    finish_kernel<<<1, kFinishThreads, smem, s>>>(res, cys, cxs, vals, keep, k, slots, radius,
                                                  cap, out);
    return (int)cudaGetLastError();
}
