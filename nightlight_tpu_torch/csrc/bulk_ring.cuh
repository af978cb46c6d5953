// A ring of shared-memory stages filled by Hopper's bulk-copy engine, for
// the tiled sort-and-sum of csrc/sort_sum.cu (K5 tiled, K6).
//
// One elected thread arms a stage's mbarrier with the bytes it expects
// (arrive.expect_tx) and issues the stage's 1-D bulk copies
// (cp.async.bulk ... mbarrier::complete_tx::bytes, one per contiguous row
// chunk); the copy engine counts the bytes down on the same barrier, so
// the phase completes when the last byte has landed. Every consumer waits
// on the phase's parity. The n-th fill of a stage completes phase n, so
// its parity is n & 1.
//
// A bulk copy needs a 16-byte-aligned source and destination and a size
// that is a multiple of 16 bytes; the caller guarantees all three
// (ops/sortnet_cuda.py ring_plan picks the per-thread path otherwise).
// In a launch without clusters a block is its own cluster of one, so the
// block's shared::cta addresses are valid shared::cluster destinations.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ring {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Initialise `count` barriers, one arrival each (the producer's
// arrive.expect_tx); one thread calls it, then the block synchronises.
__device__ __forceinline__ void init(uint64_t* bars, int count) {
    for (int s = 0; s < count; ++s)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bars + s)),
                     "r"(1)
                     : "memory");
    // make the initialised barriers visible to the copy engine (the async
    // proxy) and to the other threads
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The producer's arrival: the phase now waits for `bytes` of copies.
__device__ __forceinline__ void expect_bytes(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
                 "r"(bytes)
                 : "memory");
}

// Copy `bytes` from global `src` to shared `dst`, completing on `bar`.
__device__ __forceinline__ void copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
    uint64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    return t;
}

// Spin until the phase of `bar` with this parity has completed. A phase
// still open after kWaitNs (copies that never match the armed bytes)
// traps, so the launch fails with an error instead of hanging the card.
constexpr uint64_t kWaitNs = 4000000000ull;

__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
    uint32_t done;
    uint64_t start = 0;
    for (;;) {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done)
            : "r"(smem_addr(bar)), "r"(parity)
            : "memory");
        if (done) return;
        const uint64_t now = global_ns();
        if (start == 0) {
            start = now;
        } else if (now - start > kWaitNs) {
            __trap();
        }
    }
}

}  // namespace ring
