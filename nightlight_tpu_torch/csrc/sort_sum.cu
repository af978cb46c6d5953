// K5/K6: the sort-network microbenchmark of the stacking kernels.
//
// Replaces the Pallas TPU kernels of scripts/microbench_layout.py (run_flat
// and run_8x, K5: the same sort in two row layouts) and
// scripts/microbench_tile.py (make_run(tile).run, K6: the same sort swept
// over tile sizes). Per pixel p of a (40, P) float32 block: sort the 40
// values of the column ascending (the padding of the TPU network to 64 rows
// with 3.0e38 only adds rows that sort last and are never read), then
// return sorted[0] plus, in row order, each of sorted[1..39] that is below
// 3.0e38 (microbench_layout.py _sort_sum_rows).
//
// The network is Batcher's odd-even merge sort for 64 wires with every
// comparator that touches a padding wire (index >= 40) dropped: a padding
// row is +3.0e38 and never moves below a real one, so the 305 remaining
// compare-exchanges sort the 40 real values (the pruning of stack_pallas.py
// _sortnet_rows). The comparator list comes from the shared schedule of
// sortnet.cuh at compile time and is unrolled, so each index is a constant.
//
// Two layouts, the GPU counterparts of the TPU row layouts:
//   * column (layout 0): one thread per pixel holds its 40 values in
//     registers and runs the network there (min/max on registers only);
//   * tiled (layout 1): a block stages its (40, blockDim) tile in shared
//     memory, row i of the tile at smem[i * blockDim + t], and each thread
//     sorts its column there, every compare-exchange a shared-memory round
//     trip (the VMEM-resident rows of the TPU kernel).
// The threads per block is the launch parameter that K6 sweeps (128 to
// 1024): for the tiled layout it is the tile, 160 bytes of shared memory
// per pixel, so it sets how many blocks fit on an SM.
//
// What bounds it on the H100: the input is read once (160 bytes a pixel,
// 335 MB at P = 2^21) and 4 bytes a pixel written, about 0.1 ms at 3.35
// TB/s; the network is 305 compare-exchanges (610 min/max) a pixel, 1.3
// G operations in all. The column layout keeps the network in registers
// and should sit near the memory bound; the tiled layout adds 4 shared
// accesses per compare-exchange.
#include "common.cuh"
#include "sortnet.cuh"

namespace {

constexpr int kRows = 40;
constexpr int kWires = 64;
static_assert(sortnet::count_pairs(kWires, kRows) == 305, "pruned Batcher network for 40 rows");

// value-only compare-exchange: min to the lower wire
template <typename V>
struct MinMax {
    V& v;
    template <int a, int b>
    __device__ __forceinline__ void apply() {
        float x = v[a], y = v[b];
        v[a] = fminf(x, y);
        v[b] = fmaxf(x, y);
    }
};

template <typename V>
__device__ __forceinline__ void sort_network(V& v) {
    MinMax<V> ce{v};
    sortnet::run<kWires, kRows>(ce);
}

template <typename V>
__device__ __forceinline__ float sorted_sum(V& v) {
    float acc = v[0];
#pragma unroll
    for (int i = 1; i < kRows; ++i) {
        float r = v[i];
        acc = acc + (r >= NL_BIG ? 0.f : r);
    }
    return acc;
}

struct Regs {
    float r[kRows];
    __device__ __forceinline__ float& operator[](int i) { return r[i]; }
};

__global__ void sort_sum_column_kernel(const float* __restrict__ x, long long P,
                                       float* __restrict__ out) {
    long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= P) return;
    Regs v;
#pragma unroll
    for (int i = 0; i < kRows; ++i) v[i] = x[(long long)i * P + p];
    sort_network(v);
    out[p] = sorted_sum(v);
}

__global__ void sort_sum_tiled_kernel(const float* __restrict__ x, long long P,
                                      float* __restrict__ out) {
    extern __shared__ float tile[];
    long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= P) return;
    // each thread stages and sorts only its own column of the tile, so the
    // block needs no barrier
    nl::SharedColumn v{tile + threadIdx.x, (int)blockDim.x};
#pragma unroll
    for (int i = 0; i < kRows; ++i) v[i] = x[(long long)i * P + p];
    sort_network(v);
    out[p] = sorted_sum(v);
}

}  // namespace

// x: (40, P) float32 row-major; out: (P,). layout 0 = column, 1 = tiled.
extern "C" int nl_sort_sum(const float* x, long long P, int layout, int threads, float* out,
                           void* stream) {
    if (threads <= 0 || threads > 1024) return (int)cudaErrorInvalidValue;
    if (P > 0) {
        int blocks = nl::blocks_for(P, threads);
        if (layout == 0) {
            sort_sum_column_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(x, P, out);
        } else {
            int smem = kRows * threads * (int)sizeof(float);
            cudaError_t e = cudaFuncSetAttribute(
                sort_sum_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
            if (e != cudaSuccess) return (int)e;
            sort_sum_tiled_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(x, P, out);
        }
    }
    return (int)cudaGetLastError();
}
