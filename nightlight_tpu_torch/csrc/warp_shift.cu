// K7: the shift-blend bilinear warp of one frame (or of a block of its
// destination rows) in one pass.
//
// Replaces no TPU kernel: the JAX package's shift-blend warp
// (nightlight_tpu/ops/resample.py _warp_shift_impl, run a batch at a time by
// _warp_shift_batch) is XLA, not Pallas. The port's plain version
// (ops/resample.py _warp_shift) builds it as the JAX package does, a blend of
// up to 8 x 8 integer-shifted slices of a padded copy of the frame, about ten
// full-frame element-wise passes a slice; it took about 18 ms a 16.8 MP frame
// on the H100. This kernel computes each destination pixel once, with the
// plain version's arithmetic (warp_shift.cuh), bit for bit.
//
// What bounds it on the H100: bytes. A destination pixel reads four
// neighbours and writes one float; near-identity transforms keep the
// neighbours within a few pixels of the pixel's own position, so the frame
// is read about once from device memory and written once: 8 bytes a pixel,
// 134 MB and 0.040 ms at 3.35 TB/s for 16.8 MP. The design: one thread
// computes kGroup = 4 consecutive pixels of a destination row
// (warp_shift::group) and writes them with one 16-byte store where the row
// allows; their neighbours come as two aligned 16-byte reads from each of
// two source rows (the group's pixels share their integer shift in all but
// one group in thousands), so a warp's read of a row is 512 contiguous
// bytes. A block covers kThreads * kGroup columns of one row, so the next
// row's blocks find one of its two source rows in L2. Every argument comes
// by value: nothing is uploaded or read back. (Reading each neighbour on
// its own, four 4-byte reads a pixel, took 0.130 ms a 16.8 MP frame.)
#include "common.cuh"
#include "warp_shift.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = warp_shift::kGroup;

__global__ void __launch_bounds__(kThreads)
    warp_shift_kernel(const float* __restrict__ img, warp_shift::Params p, int row0, int rows,
                      bool vec, float* __restrict__ out) {
    const int c = (blockIdx.x * kThreads + threadIdx.x) * kGroup;
    if (c >= p.dest_w) return;
    for (int r = blockIdx.y; r < rows; r += gridDim.y) {
        const int R = row0 + r;
        float* dst = out + (long long)r * p.dest_w + c;
        if (c + kGroup <= p.dest_w) {
            float v[kGroup];
            warp_shift::group(p, img, R, c, v);
            if (vec) {
                *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
            } else {
#pragma unroll
                for (int q = 0; q < kGroup; ++q) dst[q] = v[q];
            }
        } else {
            for (int q = 0; c + q < p.dest_w; ++q) dst[q] = warp_shift::pixel(p, img, R, c + q);
        }
    }
}

}  // namespace

// Destination rows [row0, row0 + rows) of the warp into out (rows, dest_w)
// float32. img (h, w) holds the source rows [src_row0, src_row0 + h) of a
// src_h-row frame; it must hold every in-frame row of [row0 + mmin, row0 +
// rows + mmin + n_m - 1), the rows the slices read (the wrapper checks).
// out must not overlap img.
extern "C" int nl_warp_shift(const float* img, int h, int w, int src_row0, int src_h,
                             float inv0, float inv1, float inv2, float inv3, float inv4,
                             float inv5, float fill, int kmin, int mmin, int n_k, int n_m,
                             int row0, int rows, int dest_w, float* out, int device,
                             void* stream) {
    NL_USE_DEVICE(device);
    if (h < 0 || w < 0 || rows < 0 || dest_w < 0 || n_k < 1 || n_m < 1)
        return (int)cudaErrorInvalidValue;
    if (rows == 0 || dest_w == 0) return (int)cudaSuccess;
    warp_shift::Params p{h, w, src_row0, src_h, {inv0, inv1, inv2, inv3, inv4, inv5},
                         fill, kmin, mmin, n_k, n_m, dest_w};
    warp_shift::set_flags(p, img);
    const bool vec = dest_w % kGroup == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
    const int per_block = kThreads * kGroup;
    dim3 grid((dest_w + per_block - 1) / per_block, rows < 65535 ? rows : 65535);
    warp_shift_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(img, p, row0, rows, vec, out);
    return (int)cudaGetLastError();
}
