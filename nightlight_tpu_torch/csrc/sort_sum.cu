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
// What bounds it on the H100: the input is read once (160 bytes a pixel,
// 335 MB at P = 2^21) and 4 bytes a pixel written, about 0.1 ms at 3.35
// TB/s; the network is 305 compare-exchanges (610 min/max) a pixel, about
// 700 instructions with the sum, 0.05 ms at the issue rate. So the bytes
// bound it, as long as the column stays in registers.
//
// Three kernels, the GPU counterparts of the TPU row layouts:
//   * column (layout 0): one thread per pixel loads its 40 values into
//     registers and runs the network there;
//   * tiled, bulk ring (layout 1, the tiled design): a persistent grid
//     whose blocks walk tiles of TILE pixel columns; a tile's 40 rows
//     reach shared memory through a ring of stages of R rows each, filled
//     by bulk copies (bulk_ring.cuh) while the block sorts an earlier tile;
//     each thread copies its column's R values of a stage into registers,
//     the block releases the stage, and the column is sorted in registers.
//     About 80 shared-memory accesses a pixel: 40 written by the copy
//     engine, 40 read;
//   * tiled, shared-memory sort (layout 2, the first design of the port,
//     kept for comparison): a block stages its (40, blockDim) tile in
//     shared memory, row i at smem[i * blockDim + t], and each thread sorts
//     its column there, every compare-exchange a shared-memory round trip
//     (the VMEM-resident rows of the TPU kernel): about 1,300 shared
//     accesses a pixel, which the shared-memory port serves at 32 words a
//     clock, about 0.35 ms for 2^21 pixels.
// The threads per block is the launch parameter that K6 sweeps (128 to
// 1024); for the tiled kernels it is the tile.
//
// The ring kernel's plan (rows per stage, stages, shared bytes, grid, path)
// comes from ops/sortnet_cuda.py ring_plan. Its bulk copies need 16-byte
// aligned rows, so it takes them only when P % 4 == 0 and x is 16-byte
// aligned; otherwise, and for the last partial tile, the same kernel loads
// each thread's column with plain loads (the per-thread path).
#include <mutex>

#include "bulk_ring.cuh"
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

// Registers a thread of the ring kernel may use: the column (40) and the
// walk's state. __launch_bounds__ holds every instantiation to it, so
// 65536 / (64 * TILE) blocks fit an SM's registers (ring_target_blocks in
// ops/sortnet_cuda.py sizes the ring for that many).
constexpr int kRingRegs = 64;
constexpr int ring_min_blocks(int tile) { return 65536 / (kRingRegs * tile); }
constexpr int kBlockSharedBytes = 232448;

// Fill ring stage s with rows [q*R, q*R + R) of tile k: R bulk copies of
// one contiguous row chunk each, TILE floats, all completing on full[s].
template <int TILE, int R>
__device__ __forceinline__ void fill_stage(float* ring_buf, uint64_t* full, int s,
                                           const float* x, long long P, long long k, int q) {
    constexpr uint32_t kRowBytes = TILE * sizeof(float);
    float* stage = ring_buf + (size_t)s * R * TILE;
    ring::expect_bytes(full + s, R * kRowBytes);
    const float* src = x + (long long)(q * R) * P + k * TILE;
#pragma unroll
    for (int i = 0; i < R; ++i) ring::copy(stage + i * TILE, src + (long long)i * P, kRowBytes,
                                           full + s);
}

// The tiled design. Block b takes tiles b, b + gridDim.x, ...; those below
// `bulk_tiles` (all full, rows 16-byte aligned) come through the ring, the
// rest (the partial last tile, or every tile on the per-thread path) by
// plain loads. The block's bulk tiles are a stream of
// chunks c = j * C + q (its j-th tile, rows q*R .. q*R + R - 1), chunk c in
// stage c % stages; thread 0 keeps `stages` chunks in flight and refills a
// stage right after the block barrier that follows every thread's read.
//
// Shared memory: the ring (stages * R * TILE floats, from offset 0) and
// then one 8-byte barrier a stage.
template <int TILE, int R>
__global__ void __launch_bounds__(TILE, ring_min_blocks(TILE))
    sort_sum_ring_kernel(const float* __restrict__ x, long long P, int tiles, int bulk_tiles,
                         int stages, float* __restrict__ out) {
    static_assert(kRows % R == 0, "a tile's rows split into whole stages");
    constexpr int C = kRows / R;  // stages a tile spans
    extern __shared__ __align__(128) unsigned char smem[];
    float* ring_buf = reinterpret_cast<float*>(smem);
    uint64_t* full =
        reinterpret_cast<uint64_t*>(smem + (size_t)stages * R * TILE * sizeof(float));
    const int t = threadIdx.x;
    const int b = blockIdx.x;
    const int step = gridDim.x;
    const int own = b < bulk_tiles ? (bulk_tiles - 1 - b) / step + 1 : 0;
    const int chunks = own * C;
    if (own > 0) {
        if (t == 0) {
            ring::init(full, stages);
            for (int c = 0; c < stages && c < chunks; ++c)
                fill_stage<TILE, R>(ring_buf, full, c, x, P, b + (long long)(c / C) * step,
                                    c % C);
        }
        __syncthreads();
    }
    Regs v;
    int s = 0;            // stage of the next chunk
    uint32_t parity = 0;  // parity of that stage's next fill
    for (int j = 0; b + (long long)j * step < tiles; ++j) {
        const long long k = b + (long long)j * step;
        const long long p = k * TILE + t;
        if (j < own) {  // uniform across the block: every thread reads and syncs
#pragma unroll
            for (int q = 0; q < C; ++q) {
                ring::wait(full + s, parity);
                const float* stage = ring_buf + (size_t)s * R * TILE + t;
#pragma unroll
                for (int i = 0; i < R; ++i) v[q * R + i] = stage[i * TILE];
                __syncthreads();  // every thread holds its values of stage s
                const int next = j * C + q + stages;
                if (t == 0 && next < chunks)
                    fill_stage<TILE, R>(ring_buf, full, s, x, P,
                                        b + (long long)(next / C) * step, next % C);
                if (++s == stages) {
                    s = 0;
                    parity ^= 1u;
                }
            }
        } else if (p < P) {
#pragma unroll
            for (int i = 0; i < kRows; ++i) v[i] = x[(long long)i * P + p];
        }
        if (p < P) {
            sort_network(v);
            out[p] = sorted_sum(v);
        }
    }
}

// the most devices whose ring attributes prepare_ring remembers
constexpr int kMaxDevices = 64;

template <int TILE, int R>
cudaError_t prepare_ring() {
    // once per instantiation and device (an attribute is set for the
    // current device only): allow the largest block ring, and prefer the
    // largest shared-memory carve-out of the SM's 256 KB
    static std::mutex lock;
    static int status[kMaxDevices];  // 0: not yet; else the cudaError_t + 1
    int device = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e != cudaSuccess) return e;
    if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
    std::lock_guard<std::mutex> guard(lock);
    if (status[device] == 0) {
        e = cudaFuncSetAttribute(sort_sum_ring_kernel<TILE, R>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kBlockSharedBytes);
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(sort_sum_ring_kernel<TILE, R>,
                                     cudaFuncAttributePreferredSharedMemoryCarveout,
                                     (int)cudaSharedmemCarveoutMaxShared);
        status[device] = (int)e + 1;
    }
    return (cudaError_t)(status[device] - 1);
}

template <int TILE, int R>
cudaError_t ring_blocks_per_sm(int smem_bytes, int* blocks) {
    cudaError_t e = prepare_ring<TILE, R>();
    if (e != cudaSuccess) return e;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, sort_sum_ring_kernel<TILE, R>,
                                                         TILE, smem_bytes);
}

template <int TILE, int R>
cudaError_t launch_ring(const float* x, long long P, int stages, int smem_bytes, int grid,
                        int bulk_tiles, float* out, cudaStream_t stream) {
    const long long tiles = (P + TILE - 1) / TILE;
    const long long ring_bytes = (long long)stages * (R * TILE * (long long)sizeof(float) + 8);
    const bool aligned = P % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    // the plan must hold what the bulk copies need; a wrong one is refused
    if (grid <= 0 || tiles > INT32_MAX || bulk_tiles < 0 || bulk_tiles > P / TILE ||
        smem_bytes < 0 || smem_bytes > kBlockSharedBytes ||
        (bulk_tiles > 0 && (!aligned || stages < 2 || smem_bytes < ring_bytes)))
        return cudaErrorInvalidValue;
    cudaError_t e = prepare_ring<TILE, R>();
    if (e != cudaSuccess) return e;
    sort_sum_ring_kernel<TILE, R><<<grid, TILE, smem_bytes, stream>>>(x, P, (int)tiles,
                                                                      bulk_tiles, stages, out);
    return cudaGetLastError();
}

}  // namespace

// The (tile, rows per stage) pairs that ops/sortnet_cuda.py ring_shape
// plans; tests/test_torch_sort_sum_plan.py reads this line.
#define NL_RING_INSTANCES(X) X(128, 10) X(256, 10) X(512, 8) X(1024, 8)

// Blocks of the ring kernel that fit one SM with `smem_bytes` of dynamic
// shared memory each (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int nl_sort_sum_ring_blocks_per_sm(int threads, int rows_per_stage, int smem_bytes,
                                              int device, int* blocks) {
    NL_USE_DEVICE(device);
#define NL_RING_OCCUPANCY(T, RR)              \
    if (threads == T && rows_per_stage == RR) \
        return (int)ring_blocks_per_sm<T, RR>(smem_bytes, blocks);
    NL_RING_INSTANCES(NL_RING_OCCUPANCY)
#undef NL_RING_OCCUPANCY
    return (int)cudaErrorInvalidValue;
}

// x: (40, P) float32 row-major; out: (P,). layout 0 = column, 1 = tiled
// bulk ring (rows_per_stage, stages, smem_bytes, grid and bulk_tiles from
// ring_plan), 2 = tiled shared-memory sort (the plan's fields unused).
extern "C" int nl_sort_sum(const float* x, long long P, int layout, int threads,
                           int rows_per_stage, int stages, int smem_bytes, int grid,
                           int bulk_tiles, float* out, int device, void* stream) {
    NL_USE_DEVICE(device);
    if (threads <= 0 || threads > 1024) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (P > 0) {
        int blocks = nl::blocks_for(P, threads);
        if (layout == 0) {
            sort_sum_column_kernel<<<blocks, threads, 0, st>>>(x, P, out);
        } else if (layout == 1) {
#define NL_RING_LAUNCH(T, RR)                                                               \
    if (threads == T && rows_per_stage == RR)                                               \
        return (int)launch_ring<T, RR>(x, P, stages, smem_bytes, grid, bulk_tiles, out, st);
            NL_RING_INSTANCES(NL_RING_LAUNCH)
#undef NL_RING_LAUNCH
            return (int)cudaErrorInvalidValue;
        } else if (layout == 2) {
            int smem = kRows * threads * (int)sizeof(float);
            cudaError_t e = cudaFuncSetAttribute(
                sort_sum_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
            if (e != cudaSuccess) return (int)e;
            sort_sum_tiled_kernel<<<blocks, threads, smem, st>>>(x, P, out);
        } else {
            return (int)cudaErrorInvalidValue;
        }
    }
    return (int)cudaGetLastError();
}
