// The per-pixel arithmetic of K7 (the shift-blend bilinear warp), shared by
// csrc/warp_shift.cu and a host test. Like single_pass.cuh it includes no
// CUDA header, so a host compiler reads it with
//   g++ -x c++ -D__host__= -D__device__= -D__forceinline__=inline -ffp-contract=off
// (tests/test_torch_warp_shift.py holds it against the plain version
// _warp_shift of ops/resample.py).
//
// The plain version samples the source bilinearly under the inverse
// transform as a blend of n_m x n_k integer-shifted slices of the frame,
// zero-padded by kPad columns and beyond its first and last rows. For the
// destination pixel (R, c), R its global row:
//   * px = inv0 * c + inv1 * R + inv2, py likewise, each product and sum
//     rounded to float32 in that order; xl, yl their floors, xr = px - xl,
//     yr = py - yl;
//   * the fill where xl < 0 | xl + 1 >= w | yl < 0 | yl + 1 >= src_h;
//   * else k = xl - c - kmin, m = yl - R - mmin, and the value
//       out = sum over i < n_m of wy_i * (sum over j < n_k of wx_j * v_ij),
//     both sums from +0 in ascending order, wy_m = 1 - yr, wy_(m+1) = yr,
//     wx_k = 1 - xr, wx_(k+1) = xr, every other weight +0; v_ij the source
//     pixel at row R + mmin + i and column c0_j - kPad + c, c0_j = kmin + j +
//     kPad clamped to [0, w + 2 kPad - dest_w] (the slice's start), 0 outside
//     the frame and where the pixel is not finite;
//   * NaN where one of the (at most four) pixels of a non-zero weight is not
//     finite.
// Only the terms of slices i in {m, m+1}, j in {k, k+1} are computed. Each
// other term is +0 times a finite value, +-0, and a sum that starts at +0
// never turns -0, so adding it changes nothing. (One exception: a row slice
// whose two pixels lie near the float32 maximum may blend to inf, and the
// plain version's 0 * inf gives NaN there; no image of this program holds
// such values.) So the result is the plain version's bit for bit, with
// float32 rounding of every operation and no contraction (nvcc -fmad=false,
// g++ -ffp-contract=off).
//
// Two ways to read the neighbours, the same arithmetic on what is read:
//   * pixel(): one pixel, each of its terms' source pixel read on its own,
//     with the plain version's clamps and zeros outside the frame;
//   * group(): kGroup consecutive pixels of a row. Where all of them are in
//     bounds with the same yl and k (the transform's rotation moves either
//     once in thousands of pixels), rows yl and yl + 1 are both row slices
//     and no slice start is clamped (`direct`), their neighbours are columns
//     xl .. xl + kGroup of rows yl and yl + 1: two aligned 16-byte reads a
//     row when the rows are 16-byte aligned (`aligned`). Any other group
//     goes pixel by pixel.
#pragma once

#include <cmath>

namespace warp_shift {

constexpr int kPad = 256;   // the plain version's _SHIFT_PAD
constexpr int kGroup = 4;   // consecutive destination pixels of group()

struct Params {
    int h, w;             // the source block: h rows of w columns
    int src_row0, src_h;  // its first global row, the source frame's rows
    float inv[6];         // the inverse transform, float32
    float fill;           // the out-of-bounds value
    int kmin, mmin;       // the smallest column and row shift
    int n_k, n_m;         // the column and row slices
    int dest_w;           // destination columns
    bool direct;          // no slice start is clamped (set_flags)
    bool aligned;         // every source row starts on 16 bytes (set_flags)
};

// Sets p.direct and p.aligned for the source block at img.
__host__ __device__ inline void set_flags(Params& p, const float* img) {
    p.direct = p.kmin + kPad >= 0 && p.kmin + p.n_k - 1 + kPad <= p.w + 2 * kPad - p.dest_w;
    p.aligned = p.w % 4 == 0 && reinterpret_cast<unsigned long long>(img) % 16 == 0;
}

__host__ __device__ __forceinline__ bool is_finite(float v) {
    return fabsf(v) <= 3.40282347e38f;  // false for +-inf and NaN
}

struct Coords {
    float xr, yr;  // the fractions
    int xl, yl;    // the floors, when in bounds
    bool oob;
};

__host__ __device__ __forceinline__ Coords coords(const Params& p, int R, int c) {
    const float fc = (float)c, fr = (float)R;
    const float px = p.inv[0] * fc + p.inv[1] * fr + p.inv[2];
    const float py = p.inv[3] * fc + p.inv[4] * fr + p.inv[5];
    const float xl = floorf(px), yl = floorf(py);
    Coords co;
    // xl and yl are whole numbers, so these float tests are the plain
    // version's integer ones; a NaN coordinate is out of bounds
    co.oob = !(xl >= 0.f && xl < (float)(p.w - 1) && yl >= 0.f && yl < (float)(p.src_h - 1));
    co.xr = px - xl;
    co.yr = py - yl;
    co.xl = co.oob ? 0 : (int)xl;
    co.yl = co.oob ? 0 : (int)yl;
    return co;
}

// The pixel (R, c) from its coordinates; fetch(i, j, di, dj) returns the
// source pixel of row slice i = m + di and column slice j = k + dj.
template <class Fetch>
__host__ __device__ __forceinline__ float blend(const Params& p, const Coords& co, int R, int c,
                                                Fetch fetch) {
    if (co.oob) return p.fill;
    const int k = co.xl - c - p.kmin, m = co.yl - R - p.mmin;
    const float wx[2] = {1.f - co.xr, co.xr}, wy[2] = {1.f - co.yr, co.yr};
    float out = 0.f;
    bool bad = false;
#pragma unroll
    for (int di = 0; di < 2; ++di) {
        const int i = m + di;
        if (i < 0 || i >= p.n_m) continue;
        float acc = 0.f;
#pragma unroll
        for (int dj = 0; dj < 2; ++dj) {
            const int j = k + dj;
            if (j < 0 || j >= p.n_k) continue;
            float v = fetch(i, j, di, dj);
            if (!is_finite(v)) {
                bad = true;
                v = 0.f;
            }
            acc = acc + wx[dj] * v;
        }
        out = out + wy[di] * acc;
    }
    return bad ? NAN : out;
}

// The destination pixel at global row R, column c. `img` holds the source
// rows [src_row0, src_row0 + h), which must hold every row of the frame
// that the slices read (the wrapper checks).
__host__ __device__ __forceinline__ float pixel(const Params& p, const float* img, int R,
                                                int c) {
    return blend(p, coords(p, R, c), R, c, [&](int i, int j, int, int) {
        const int y = R + p.mmin + i;
        int c0 = p.kmin + j + kPad;  // the slice's start, clamped as the plain version's
        c0 = c0 < 0 ? 0 : c0;
        const int c0_max = p.w + 2 * kPad - p.dest_w;
        c0 = c0 > c0_max ? c0_max : c0;
        const int x = c0 - kPad + c;
        const bool in = y >= 0 && y < p.src_h && x >= 0 && x < p.w;
        return in ? img[(long long)(y - p.src_row0) * p.w + x] : 0.f;
    });
}

__host__ __device__ __forceinline__ void load8(const float* a, float (&r)[8]) {
#ifdef __CUDA_ARCH__
    const float4 lo = *reinterpret_cast<const float4*>(a);
    const float4 hi = *reinterpret_cast<const float4*>(a + 4);
    r[0] = lo.x, r[1] = lo.y, r[2] = lo.z, r[3] = lo.w;
    r[4] = hi.x, r[5] = hi.y, r[6] = hi.z, r[7] = hi.w;
#else
    for (int t = 0; t < 8; ++t) r[t] = a[t];
#endif
}

// The kGroup destination pixels (R, c + q), q < kGroup, all within the row.
__host__ __device__ __forceinline__ void group(const Params& p, const float* img, int R, int c,
                                               float (&out)[kGroup]) {
    Coords co[kGroup];
    bool fast = p.direct && p.aligned;
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
        co[q] = coords(p, R, c + q);
        fast = fast && !co[q].oob && co[q].yl == co[0].yl && co[q].xl == co[0].xl + q;
    }
    // rows yl and yl + 1 both among the row slices', which the block holds
    // (the columns xl, xl + 1 of a pixel in bounds lie in the frame)
    const int m = co[0].yl - R - p.mmin;
    fast = fast && m >= 0 && m + 1 < p.n_m;
    if (!fast) {
#pragma unroll
        for (int q = 0; q < kGroup; ++q) out[q] = pixel(p, img, R, c + q);
        return;
    }
    // columns xl .. xl + kGroup of rows yl and yl + 1, from the aligned
    // 8 columns at or below xl (xl + kGroup <= w - 1, w a multiple of 4)
    const int base = co[0].xl & ~3, off = co[0].xl - base;
    float win[2][kGroup + 1];
#pragma unroll
    for (int d = 0; d < 2; ++d) {
        float r[8];
        load8(img + (long long)(co[0].yl + d - p.src_row0) * p.w + base, r);
#pragma unroll
        for (int t = 0; t <= kGroup; ++t)
            win[d][t] = off == 0 ? r[t] : off == 1 ? r[t + 1] : off == 2 ? r[t + 2] : r[t + 3];
    }
#pragma unroll
    for (int q = 0; q < kGroup; ++q)
        out[q] = blend(p, co[q], R, c + q,
                       [&](int, int, int di, int dj) { return win[di][q + dj]; });
}

}  // namespace warp_shift
