// Device helpers shared by the probe kernels (probe_dot.cu, probe_route.cu,
// probe_stream_take.cu).
//
// Hopper bulk copies (cp.async.bulk, the TMA's 1-D form) from device memory
// into shared memory, completed on an mbarrier: one thread issues a
// contiguous copy of any multiple of 16 bytes, the hardware moves it and
// counts the bytes down on the barrier, and the block waits on the barrier's
// phase. Use: thread 0 calls mbar_init on each barrier, then
// fence_mbar_init, then the block synchronises. For each stage thread 0
// calls mbar_expect_tx with the stage's total bytes and then bulk_g2s for
// each piece; every thread calls mbar_wait with the barrier's current phase
// bit and flips its copy of the bit. Addresses and sizes must be multiples
// of 16 bytes. A ring also needs the reverse: consumers mbar_arrive on a
// stage's "empty" barrier after their last read, and the producer waits on
// it before a refill. Small pieces can go by cp_async_16 instead, tracked by
// the same barrier through cp_async_mbar_arrive.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
                 : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects ``bytes`` of bulk-copy traffic.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
                 "r"(bytes)
                 : "memory");
}

// One plain arrival (a consumer's release of a stage).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Orders this thread's later plain shared-memory accesses after the bulk
// copies that completed before it (reuse of a copy's target).
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, uint32_t bytes,
                                         uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
            smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}

// 16 bytes from device memory into shared memory by cp.async (bypassing L1).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
}

// The barrier's current phase also waits for this thread's earlier
// cp.async copies: one pending arrival now, released when they land.
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
    asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Spin until the barrier's phase of parity ``parity`` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = smem_addr(bar);
    uint32_t done = 0;
    while (!done) {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done)
            : "r"(addr), "r"(parity)
            : "memory");
    }
}

// Allow a kernel more than 48 KB of dynamic shared memory.
template <typename Kernel>
__host__ inline cudaError_t allow_smem(Kernel kernel, int bytes) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// One block of ``threads`` with ``smem`` bytes of dynamic shared memory on
// ``stream``; returns the error of the attribute call or the launch.
template <typename Kernel, typename... Args>
__host__ inline int launch_block(Kernel kernel, int threads, int smem, cudaStream_t stream,
                                 Args... args) {
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<1, threads, smem, stream>>>(args...);
    return (int)cudaGetLastError();
}
