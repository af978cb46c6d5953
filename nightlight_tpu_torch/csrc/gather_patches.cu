// K4: star-candidate patch gather.
//
// Replaces the Pallas TPU kernel nightlight_tpu/ops/gather_pallas.py
// gather_patches_pallas: (K, 2r+1, 2r+1) windows of a (H, W) f32 image
// around integer candidate centres (cys, cxs), feeding the centre-of-mass
// and HFR phases of star detection (detect/stars.py), and the in-frame mask
// `ok` of each element (one byte, 0 or 1, a torch.bool). Elements outside
// the frame are written as 0; every consumer masks with `ok`, so those
// values are never read. Centres may lie outside the frame.
//
// What bounds it on the H100: it is a pure copy, K * (2r+1)^2 * 4 bytes out
// (35 MB per frame at K=2048, r=32), as many in, scattered over the frame in
// row segments of 2r+1 floats, and K * (2r+1)^2 mask bytes out. So the
// design is about keeping enough loads in flight to cover device-memory
// latency. The TPU kernel issued one DMA per candidate from an
// (8, 128)-aligned window and rotated the offset in VMEM. Here the patch
// rows of all candidates, K * (2r+1) of them, are dealt out to warps, four
// consecutive rows a warp: lane l covers columns l, l+32, ... of a row
// (template C slots, up to 128 columns a pass), so the warp reads and writes
// contiguous row segments, and each lane issues its 4*C loads before any of
// its stores. A warp finds its candidate with one division; nothing is
// divided per element. Bounds are tested per row: a row inside the frame
// loads unchecked, an edge row tests each column. The mask is written in the
// same pass, so the caller builds none.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // patch rows of one warp, all loaded before any store

template <int C>
__global__ void __launch_bounds__(kThreads)
    gather_patches_kernel(const float* __restrict__ img, int h, int w,
                          const int* __restrict__ cys, const int* __restrict__ cxs, int k,
                          int radius, float* __restrict__ out, uint8_t* __restrict__ ok) {
    const int size = 2 * radius + 1;
    const unsigned rows = (unsigned)k * (unsigned)size;
    const int lane = threadIdx.x & 31;
    const unsigned g0 = (blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) * kRows;
    if (g0 >= rows) return;  // the whole warp

    unsigned cand = g0 / (unsigned)size;
    int row = (int)(g0 - cand * (unsigned)size);
    bool live[kRows], row_in[kRows], inside[kRows];
    int x0[kRows];
    long long src[kRows], dst[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
        live[u] = g0 + u < rows;
        int c = live[u] ? (int)cand : 0;
        int y = cys[c] - radius + row;
        x0[u] = cxs[c] - radius;
        row_in[u] = live[u] && y >= 0 && y < h;
        inside[u] = row_in[u] && x0[u] >= 0 && x0[u] + size <= w;
        src[u] = (long long)(row_in[u] ? y : 0) * w;
        dst[u] = (long long)(g0 + u) * size;
        if (++row == size) {
            row = 0;
            ++cand;
        }
    }
    for (int c0 = 0; c0 < size; c0 += 32 * C) {
        float v[kRows][C];
        bool in[kRows][C];
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
#pragma unroll
            for (int j = 0; j < C; ++j) {
                int col = c0 + lane + 32 * j;
                int x = x0[u] + col;
                in[u][j] = col < size && row_in[u] && (inside[u] || (unsigned)x < (unsigned)w);
                v[u][j] = in[u][j] ? img[src[u] + x] : 0.f;
            }
        }
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
#pragma unroll
            for (int j = 0; j < C; ++j) {
                int col = c0 + lane + 32 * j;
                if (live[u] && col < size) {
                    out[dst[u] + col] = v[u][j];
                    ok[dst[u] + col] = in[u][j];
                }
            }
        }
    }
}

}  // namespace

// Patches of the k candidates into out (k, 2r+1, 2r+1) float32 and their
// in-frame mask into ok (k, 2r+1, 2r+1) bytes. k * (2r+1) must stay below
// 2^31 (the wrapper checks).
extern "C" int nl_gather_patches(const float* img, int h, int w, const int* cys,
                                 const int* cxs, int k, int radius, float* out, uint8_t* ok,
                                 int device, void* stream) {
    NL_USE_DEVICE(device);
    if (k < 0 || radius < 0) return (int)cudaErrorInvalidValue;
    if (k == 0) return (int)cudaSuccess;
    const int size = 2 * radius + 1;
    long long warps = ((long long)k * size + kRows - 1) / kRows;
    int blocks = (int)((warps + kThreads / 32 - 1) / (kThreads / 32));
    cudaStream_t s = (cudaStream_t)stream;
    auto launch = [&](auto kernel) {
        kernel<<<blocks, kThreads, 0, s>>>(img, h, w, cys, cxs, k, radius, out, ok);
        return (int)cudaGetLastError();
    };
    // column slots a lane: the fewest that cover a row, at most 4 a pass
    switch (size <= 32 ? 1 : size <= 64 ? 2 : size <= 96 ? 3 : 4) {
        case 1: return launch(gather_patches_kernel<1>);
        case 2: return launch(gather_patches_kernel<2>);
        case 3: return launch(gather_patches_kernel<3>);
        default: return launch(gather_patches_kernel<4>);
    }
}
