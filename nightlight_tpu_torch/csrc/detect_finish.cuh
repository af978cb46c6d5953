// The arithmetic of K8 (phases 3-6 of star detection), shared by
// csrc/detect_finish.cu and the host mirror csrc/detect_finish_host.cpp.
// Like warp_shift.cuh it includes no CUDA header, so a host compiler reads it
// with
//   g++ -x c++ -D__host__= -D__device__= -D__forceinline__=inline -ffp-contract=off
// (tests/test_torch_detect_finish.py holds the mirror against the plain
// version _finish of detect/stars.py, and chip_smoke.py the kernel against
// the mirror, bit for bit).
//
// The plain version, for the phase-2 survivors of a frame in candidate order:
//   1. the overlap filter on the integer centres and values;
//   2. the centre of mass: at most 10 rounds over the (4r+1)^2 patch of a
//      candidate, each summing val * window, val * window * (column offset -
//      ox) and val * window * (row offset - oy), val = max(pixel - threshold,
//      0) where the patch is in the frame (NaN stays NaN) and 0 elsewhere,
//      window 1 inside the (2r+1)^2 square about the offset (oy, ox) and 0
//      outside; a round moves (oy, ox) by the rounded shift, clamped to
//      [-r, r], and the candidate stops once its centre moved by at most
//      1e-2 px (squared 1e-4);
//   3. the overlap filter again on the refined centres and masses, its valid
//      set the first filter's survivors;
//   4. the HFR about the refined offset: the flux within the disk of
//      dist2_limit, its first moment, and the in/out plausibility test;
//   5. the survivors that are plausible, sorted by descending mass (ties by
//      candidate order).
// Every sum is a warp's: lane l adds the elements l, l + 32, ... of the whole
// patch in ascending order from +0, then the lanes combine in the butterfly
// xor 16, 8, 4, 2, 1. So the order of a candidate's sums is fixed by the
// radius alone, whatever the frame, its candidate count or the chunk; the
// host mirror runs the 32 lanes one after the other and combines them in the
// same butterfly. The plain version sums in another order, so the two agree
// to float32 rounding of those sums and not bit for bit. The window selects
// (a NaN or infinite val outside it adds nothing), as XLA compiles the JAX
// package's multiplication by the window's mask; the rounded shift converts
// to int32 as XLA converts it (a NaN to 0, beyond int32 saturated) and the
// int32 sum wraps, so a frame with NaN or infinite pixels in a window
// refines as the JAX package does.
//
// The overlap filter's fixed point is unique (the priority, greater mass,
// ties by lower candidate index, orders the candidates; a NaN mass ranks with
// none), so the kernel may reach it by another schedule than the plain loop:
// the kernel scans, for each candidate, only the candidates whose y lies
// within radius + 2 (sorted by y), the mirror every pair.
#pragma once

#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace detect_finish {

constexpr int kLanes = 32;
constexpr int kRounds = 10;
// per-candidate results of the first pass, each a row of k floats:
// x, y, centre-of-mass mass, hfr, HFR mass (the sort key), plausible (0 or 1)
constexpr int kFields = 6;
enum Field { kX = 0, kY, kMass, kHfr, kMass2, kPlausible };
// a frame's output row: count, average HFR, phase-2 survivors, then the kept
// stars' x, y, value, mass, hfr, each `cap` floats
constexpr int kHead = 3;
constexpr int kStarFields = 5;

struct Params {
    int radius;
    float threshold;    // location + scale * star_sig * 0.5
    float location;
    float star_in_out;
    float dist2_limit;  // ceil(float32((radius + 1e-8)^2)), from the caller
    int pixels;         // the small grid's points within dist2_limit
};

__host__ __device__ __forceinline__ float com_threshold(float location, float scale,
                                                        float star_sig) {
    return location + scale * star_sig * 0.5f;
}

// torch.clamp(v, min=0): NaN stays NaN
__host__ __device__ __forceinline__ float floor0(float v) { return v < 0.f ? 0.f : v; }

// points (a, b) of the (2r+1)^2 grid about 0 with a^2 + b^2 <= limit
__host__ __device__ __forceinline__ bool in_grid_disk(int a, int b, float limit) {
    const float fa = (float)a, fb = (float)b;
    return fa * fa + fb * fb <= limit;
}

__host__ __device__ inline int grid_disk_count(int radius, float limit) {
    int n = 0;
    for (int a = -radius; a <= radius; ++a)
        for (int b = -radius; b <= radius; ++b) n += in_grid_disk(a, b, limit);
    return n;
}

// float -> int32 as XLA converts (the JAX package's round(d).astype(int32)):
// NaN gives 0, values beyond int32 saturate
__host__ __device__ __forceinline__ int to_i32(float f) {
    if (f != f) return 0;
    if (f >= 2147483648.f) return INT_MAX;
    if (f < -2147483648.f) return INT_MIN;
    return (int)f;
}

// the int32 sum, wrapping as XLA's does
__host__ __device__ __forceinline__ int add_wrap(int a, int b) {
    return (int)((unsigned)a + (unsigned)b);
}

__host__ __device__ __forceinline__ int clamp_i(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// The element walk of lane `lane` over an s x s patch: e = lane, lane + 32,
// ... A step moves by 32 / s rows and 32 % s columns and wraps at most once,
// so the loops over it unroll and their loads overlap.
struct Walk {
    int e, row, col, step_rows, step_cols;
    __host__ __device__ __forceinline__ Walk(int lane, int s)
        : e(lane), row(lane / s), col(lane % s), step_rows(kLanes / s), step_cols(kLanes % s) {}
    __host__ __device__ __forceinline__ void next(int s) {
        e += kLanes;
        row += step_rows;
        col += step_cols;
        if (col >= s) {
            col -= s;
            ++row;
        }
    }
};

struct State {
    int oy, ox;
    float px, py, mass, shift2;
};

__host__ __device__ __forceinline__ State com_start(int cy, int cx) {
    return State{0, 0, (float)cx, (float)cy, 0.f, 3.4e38f};
}

// a lane's sums of one centre-of-mass round: m, sx, sy
__host__ __device__ __forceinline__ void com_lane(const Params& p, const float* patch,
                                                  const uint8_t* ok, const State& st, int lane,
                                                  float (&sum)[3]) {
    const int big = 2 * p.radius, s = 2 * big + 1;
    const float oyf = (float)st.oy, oxf = (float)st.ox;
    sum[0] = sum[1] = sum[2] = 0.f;
#pragma unroll 4
    for (Walk w(lane, s); w.e < s * s; w.next(s)) {
        const float val = ok[w.e] ? floor0(patch[w.e] - p.threshold) : 0.f;
        const int dr = w.row - big - st.oy;
        const int dc = w.col - big - st.ox;
        const bool in = dr >= -p.radius && dr <= p.radius && dc >= -p.radius && dc <= p.radius;
        const float v = in ? val : 0.f;
        sum[0] = sum[0] + v;
        sum[1] = sum[1] + v * ((float)(w.col - big) - oxf);
        sum[2] = sum[2] + v * ((float)(w.row - big) - oyf);
    }
}

// whether a round still moves the candidate: once it stopped, its state no
// longer changes
__host__ __device__ __forceinline__ bool com_active(const State& st) { return st.shift2 > 1e-4f; }

// one round's update of an active candidate from the warp's sums
__host__ __device__ __forceinline__ void com_update(const Params& p, int cy, int cx, State& st,
                                                    const float (&sum)[3]) {
    const float m = sum[0] == 0.f ? 1e-8f : sum[0];
    const float dx = sum[1] / m, dy = sum[2] / m;
    const float oyf = (float)st.oy, oxf = (float)st.ox;
    const float nx = ((float)cx + oxf) + dx, ny = ((float)cy + oyf) + dy;
    const float ddx = nx - st.px, ddy = ny - st.py;
    st.oy = clamp_i(add_wrap(st.oy, to_i32(rintf(dy))), -p.radius, p.radius);
    st.ox = clamp_i(add_wrap(st.ox, to_i32(rintf(dx))), -p.radius, p.radius);
    st.px = nx;
    st.py = ny;
    st.mass = m;
    st.shift2 = ddx * ddx + ddy * ddy;
}

__host__ __device__ __forceinline__ float hfr_dist2(const Walk& w, int big, const State& st) {
    const float dy = (float)(w.row - big) - (float)st.oy;
    const float dx = (float)(w.col - big) - (float)st.ox;
    return dy * dy + dx * dx;
}

// a lane's HFR sums: the flux within the disk and its first moment
__host__ __device__ __forceinline__ void hfr_lane(const Params& p, const float* patch,
                                                  const uint8_t* ok, const State& st, int lane,
                                                  float (&sum)[2]) {
    const int big = 2 * p.radius, s = 2 * big + 1;
    sum[0] = sum[1] = 0.f;
#pragma unroll 4
    for (Walk w(lane, s); w.e < s * s; w.next(s)) {
        const float d2 = hfr_dist2(w, big, st);
        const float v = (ok[w.e] && d2 <= p.dist2_limit) ? floor0(patch[w.e] - p.location) : 0.f;
        sum[0] = sum[0] + v;
        sum[1] = sum[1] + v * sqrtf(d2);
    }
}

// a lane's flux within the inner disk of ceil(hfr^2), and its count of the
// small grid's points within that disk
__host__ __device__ __forceinline__ void inner_lane(const Params& p, const float* patch,
                                                    const uint8_t* ok, const State& st,
                                                    float inner_limit, int lane, float& mass,
                                                    int& pixels) {
    const int big = 2 * p.radius, s = 2 * big + 1, g = 2 * p.radius + 1;
    mass = 0.f;
#pragma unroll 4
    for (Walk w(lane, s); w.e < s * s; w.next(s)) {
        const float v = (ok[w.e] && hfr_dist2(w, big, st) <= inner_limit)
                            ? floor0(patch[w.e] - p.location) : 0.f;
        mass = mass + v;
    }
    pixels = 0;
    for (Walk w(lane, g); w.e < g * g; w.next(g))
        pixels += in_grid_disk(w.row - p.radius, w.col - p.radius, inner_limit);
}

struct Hfr {
    float hfr, mass2, inner_limit;
};

__host__ __device__ __forceinline__ Hfr hfr_of(const float (&sum)[2]) {
    Hfr h;
    h.mass2 = sum[0] == 0.f ? 1e-8f : sum[0];
    h.hfr = sum[1] / h.mass2;
    h.inner_limit = ceilf(h.hfr * h.hfr);
    return h;
}

__host__ __device__ __forceinline__ bool plausible(const Params& p, const Hfr& h,
                                                   float inner_mass, int inner_pixels) {
    const float outer_mass = h.mass2 - inner_mass;
    return h.hfr <= (float)p.radius &&
           inner_mass * (float)(p.pixels - inner_pixels) >
               p.star_in_out * outer_mass * (float)inner_pixels;
}

// The overlap filter's test: candidate j, alive, keeps candidate i out.
__host__ __device__ __forceinline__ bool dominates(const float* x, const float* y, const float* m,
                                                   int i, int j, float r2) {
    const float dx = x[i] - x[j], dy = y[i] - y[j];
    const bool conflict = floorf(dx * dx + dy * dy + 0.5f) <= r2;
    return conflict && (m[j] > m[i] || (m[j] == m[i] && j < i));
}

// Sort keys of 64 bits, the low 32 the candidate: ascending order of a float
// (NaN last), and descending order of a float.
__host__ __device__ __forceinline__ uint32_t ordered(float f) {
    uint32_t u;
    memcpy(&u, &f, sizeof u);
    if (f != f) return 0xffffffffu;
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__host__ __device__ __forceinline__ unsigned long long ascending_key(float f, int c) {
    return ((unsigned long long)ordered(f) << 32) | (uint32_t)c;
}

__host__ __device__ __forceinline__ unsigned long long descending_key(float f, int c) {
    return ascending_key(-f, c);
}

}  // namespace detect_finish
