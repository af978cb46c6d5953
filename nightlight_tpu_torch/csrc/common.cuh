// Shared helpers for the hand-written Hopper kernels of nightlight_tpu_torch.
//
// Every kernel here is launched from Python through ctypes (see
// nightlight_tpu_torch/kernels.py): the C entry points take raw device
// pointers, the ordinal of the device they lie on and the caller's CUDA
// stream of that device, launch, and return
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
    __host__ __device__ __forceinline__ float& operator[](int i) const {
        return base[(long long)i * stride];
    }
};

// One pixel's column in a [row][thread] block of shared memory: element i
// of thread t at base[i * stride + t], so the lanes of a warp hit distinct
// banks at any row. Host-callable too, so the run-time network loop of
// sortnet.cuh (a __host__ __device__ template) may call compare-exchanges
// on it.
struct SharedColumn {
    float* base;
    int stride;
    __host__ __device__ __forceinline__ float& operator[](int i) const {
        return base[i * stride];
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

// Writes the sums over the warp of its lanes' low/high clip counts to
// partials[2w] and partials[2w + 1], w the warp's index in the launch; the
// wrapper adds the partials up. (An atomic per warp into two totals instead
// queues 2^19 atomics on each of two addresses at 16.8 MP.) Every lane of
// the warp calls it (a lane past the last pixel with zero counts).
__device__ __forceinline__ void write_clip_partials(int lo, int hi, int* partials) {
    lo = __reduce_add_sync(0xffffffffu, lo);
    hi = __reduce_add_sync(0xffffffffu, hi);
    if ((threadIdx.x & 31) == 0) {
        long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
        partials[2 * w] = lo;
        partials[2 * w + 1] = hi;
    }
}

inline int blocks_for(long long p, int threads) {
    return (int)((p + threads - 1) / threads);
}

// Every entry point starts here. nvcc links this library's CUDA runtime
// statically, so its current device is its own, apart from PyTorch's: a
// launch onto a stream of card k must first make k the calling thread's
// current device of this runtime (cudaFuncSetAttribute also applies to the
// current device only).
#define NL_USE_DEVICE(device)                       \
    do {                                            \
        cudaError_t nl_e_ = cudaSetDevice(device);  \
        if (nl_e_ != cudaSuccess) return (int)nl_e_; \
    } while (0)

}  // namespace nl
