// K4: star-candidate patch gather.
//
// Replaces the Pallas TPU kernel nightlight_tpu/ops/gather_pallas.py
// gather_patches_pallas: (K, 2r+1, 2r+1) windows of a (H, W) f32 image
// around integer candidate centres (cys, cxs), feeding the centre-of-mass
// and HFR phases of star detection (detect/stars.py). Elements outside the
// frame are written as 0; the in-frame mask `ok` is computed by the caller
// and every consumer masks with it, so those values are never read.
//
// What bounds it on the H100: it is a pure copy, K * (2r+1)^2 * 4 bytes out
// (35 MB per frame at K=2048, r=32) and as many in, scattered over the
// frame in row segments of 2r+1 floats. The TPU kernel issued one DMA per
// candidate from an (8, 128)-aligned window and rotated the offset in VMEM;
// here one thread block per candidate walks the window row-major, so
// consecutive threads read consecutive pixels of a row (coalesced
// segments) and write consecutive output elements. Each load is bounds
// checked instead of clamping the window. Device bandwidth and the
// per-block launch granularity bound it; no shared memory is needed because
// nothing is reused.
#include "common.cuh"

namespace {

__global__ void gather_patches_kernel(const float* __restrict__ img, int h, int w,
                                      const int* __restrict__ cys,
                                      const int* __restrict__ cxs, int radius,
                                      float* __restrict__ out) {
    const int k = blockIdx.x;
    const int size = 2 * radius + 1;
    const int area = size * size;
    const int y0 = cys[k] - radius;
    const int x0 = cxs[k] - radius;
    float* dst = out + (long long)k * area;
    for (int t = threadIdx.x; t < area; t += blockDim.x) {
        int y = y0 + t / size;
        int x = x0 + t % size;
        bool ok = y >= 0 && y < h && x >= 0 && x < w;
        dst[t] = ok ? img[(long long)y * w + x] : 0.f;
    }
}

}  // namespace

extern "C" int nl_gather_patches(const float* img, int h, int w, const int* cys,
                                 const int* cxs, int k, int radius, float* out,
                                 void* stream) {
    if (k > 0) {
        gather_patches_kernel<<<k, 256, 0, (cudaStream_t)stream>>>(img, h, w, cys, cxs,
                                                                   radius, out);
    }
    return (int)cudaGetLastError();
}
