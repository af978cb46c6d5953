// Shared helpers for the hand-written Hopper kernels of nightlight_tpu_torch.
//
// Every kernel here is launched from Python through ctypes (see
// nightlight_tpu_torch/kernels.py): the C entry points take raw device
// pointers and the caller's CUDA stream, launch, and return
// cudaGetLastError() so the wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// NaN (missing sample) sorts to the end of a frame column as +BIG, the same
// sentinel the Pallas kernels use (ops/stack_pallas.py _BIG).
#define NL_BIG 3.0e38f

namespace nl {

// Strided view of one pixel's frame column in a (n, P) row-major buffer:
// element i of pixel p lives at base[i * P + p], so the threads of a warp
// (consecutive p) touch consecutive addresses for every i.
struct Column {
    float* base;
    long long stride;
    __device__ __forceinline__ float& operator[](int i) const {
        return base[(long long)i * stride];
    }
};

struct ByteColumn {
    uint8_t* base;
    long long stride;
    __device__ __forceinline__ uint8_t& operator[](int i) const {
        return base[(long long)i * stride];
    }
};

// Ascending insertion sort of v[0, n); values in w (when non-null) follow
// their keys. Stable, so equal keys keep their frame order.
__device__ __forceinline__ void insertion_sort(Column v, Column* w, int n) {
    for (int i = 1; i < n; ++i) {
        float key = v[i];
        float wk = w ? (*w)[i] : 0.f;
        int j = i - 1;
        while (j >= 0 && v[j] > key) {
            v[j + 1] = v[j];
            if (w) (*w)[j + 1] = (*w)[j];
            --j;
        }
        v[j + 1] = key;
        if (w) (*w)[j + 1] = wk;
    }
}

inline int blocks_for(long long p, int threads) {
    return (int)((p + threads - 1) / threads);
}

}  // namespace nl
