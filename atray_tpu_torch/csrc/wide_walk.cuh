// The 8-wide frustum walk of one bundle (one warp), shared by
// wide_frustum.cu (one warp per bundle) and persistent_wide.cu (warps take
// bundles from a counter).
//
// Per popped wide node, lanes 0-7 each read one child's box and link from
// the node's 256-byte record (WideBVH.cnodes, accel/wide.py::node_records:
// child c's field f at word 8f + c, its link at word 48 + c) and take the
// interval test of its box (no tmax term, as in the reference);
// __ballot_sync packs the overlap bits. Children are pushed in slot order:
// interior ones onto the warp's stack, leaves -(link + 1) into its leaf
// queue; empty slots (INT32_MIN links) are skipped by their link, never by
// their inverted boxes. The queue drains in mid-walk once it holds
// kQCap - 8 leaves (the reference's rule, wide_pallas.py:203) and whole at
// the end of the walk; a drain tests every queued leaf's records against
// every lane in queue order. With no tmax in the walk the drain points do
// not change any result.
//
// What bounds it: an incoherent warp (bounce rays) passes nearly every box
// and drains nearly every leaf against all 32 lanes, so the record tests
// (about 45 float operations each) bound it; a coherent warp's walk is a
// chain of dependent node loads. The design:
//   - a drain streams the queued leaves' records through a ring of kRing
//     leaf slots in the warp's shared memory, in queue order: the cp.async
//     copy (16 bytes a lane: a leaf of 8 records is one 512-byte copy of
//     the warp) of the next leaf is in flight while one leaf is tested
//     (double buffering);
//   - the record test is lineage.cuh's leaf_test_pairs: two records at a
//     time from the slot, dets first, v and t only where u is in [0, 1];
//   - one record a node: a pop costs one row of dependent loads (seven
//     words a lane from one 256-byte record), not two tables;
//   - the bundle's bounds live in the warp's shared memory beside its stack
//     and queue, so that the drain holds no registers for them; blocks of
//     kWideThreads threads, each kernel's registers capped (its kMinBlocks)
//     so that its build takes 64.
// Measured and dropped (PERF.md §6 holds the ladder): records read from
// global memory, the bounds in registers, rings of 4 and 8 leaves,
// batches of 2 to 8 leaves a copy group, 128-thread blocks, other register
// caps (for 8, 10, 14 and 20 blocks an SM, and none), and the next pop's or
// the pushed children's records prefetched into L1 by the idle lanes 8-31.

#pragma once

#include "lineage.cuh"

namespace lineage {

constexpr int kStackCap = 192;     // STACK_CAP of kernels/wide_frustum.py
constexpr int kQCap = 512;         // QCAP of kernels/wide_frustum.py
constexpr int kEmptyGuard = -2147483647;   // links <= this are empty slots
constexpr int kNodeWords = 64;     // one cnodes record: 48 box words, 8 links, axis, pad
constexpr int kRing = 2;           // leaf slots of a warp's drain ring
constexpr int kWideThreads = 64;   // threads a block of either kernel
constexpr int kWideWarps = kWideThreads / kWarp;
constexpr int kBundleBytes = (sizeof(Bundle) + 15) / 16 * 16;

// 16-byte words of one ring slot: the leaf's records rounded up to an even
// count, since leaf_test_pairs reads a last odd record's partner (and drops
// its result).
__host__ __device__ constexpr int slot_words(int leaf_size) {
    return (leaf_size + 1) / 2 * 2 * 4;
}

// A warp's shared memory: the ring of kRing leaf slots, the bundle, the
// stack of kStackCap nodes and the queue of kQCap leaf rows.
__host__ __device__ constexpr long long wide_warp_smem(int leaf_size) {
    return (long long)kRing * slot_words(leaf_size) * 16 + kBundleBytes + (kStackCap + kQCap) * 4;
}

struct WideWarp {
    float4* ring;
    Bundle* bundle;
    int* stack;
    int* queue;
};

// This warp's part of the block's dynamic shared memory.
__device__ __forceinline__ WideWarp wide_warp(float4* smem, int leaf_size) {
    WideWarp w;
    char* base = reinterpret_cast<char*>(smem) + (threadIdx.x / kWarp) * wide_warp_smem(leaf_size);
    w.ring = reinterpret_cast<float4*>(base);
    w.bundle = reinterpret_cast<Bundle*>(base + (long long)kRing * slot_words(leaf_size) * 16);
    w.stack = reinterpret_cast<int*>(reinterpret_cast<char*>(w.bundle) + kBundleBytes);
    w.queue = w.stack + kStackCap;
    return w;
}

struct WideCounts {
    unsigned long long nodes = 0, records = 0, drains = 0;
};

__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void copies_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most kRing - 1 of this lane's copy groups are pending.
__device__ __forceinline__ void copies_wait_ring() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 1) : "memory");
}

// Starts the copy of queued leaf q's records into ring slot q % kRing.
__device__ __forceinline__ void stage_leaf(const WideWarp& w, int q, const float4* __restrict__ tris4,
                                           int leaf_size, int lane) {
    const float4* src = tris4 + (long long)w.queue[q] * 32;    // 32 words a row of 8 records
    float4* dst = w.ring + (q % kRing) * slot_words(leaf_size);
    for (int k = lane; k < leaf_size * 4; k += kWarp) copy16_async(dst + k, src + k);
}

// Tests the cnt queued leaves' records against every lane, in queue order.
// Each leaf's copy is one commit group (empty past the queue's end), so
// before leaf q is tested q + kRing groups are committed and waiting for
// all but kRing - 1 of them completes leaf q's.
__device__ __forceinline__ void drain_queue(const WideWarp& w, int cnt,
                                            const float4* __restrict__ tris4, int leaf_size,
                                            int lane, const Ray& r, Hit& h, WideCounts& wc) {
    for (int q = 0; q < kRing - 1; ++q) {
        if (q < cnt) stage_leaf(w, q, tris4, leaf_size, lane);
        copies_commit();
    }
    for (int q = 0; q < cnt; ++q) {
        if (q + kRing - 1 < cnt) stage_leaf(w, q + kRing - 1, tris4, leaf_size, lane);
        copies_commit();
        copies_wait_ring();
        __syncwarp();                    // every lane's part of leaf q has arrived
        leaf_test_pairs<false>(w.ring + (q % kRing) * slot_words(leaf_size), leaf_size, r, h);
        __syncwarp();                    // the slot is free for leaf q + kRing
    }
    wc.records += (unsigned long long)cnt * leaf_size;
}

// Writes the bundle of this warp's rays into its shared memory and walks
// it. A previous bundle's walk (persistent_wide) has ended in a __syncwarp,
// so nothing reads the old one. The caller guarantees 8 * (max_depth + 2)
// <= kStackCap.
__device__ __forceinline__ void wide_walk(const WideWarp& w, const Ray& r, bool live, int lane,
                                          const int* __restrict__ nodes,
                                          const float4* __restrict__ tris4, int leaf_size, Hit& h,
                                          WideCounts& wc) {
    {
        const Bundle setup = bundle_setup(r, live);
        if (lane == 0) *w.bundle = setup;
    }
    const Bundle& b = *w.bundle;
    const int c = lane & 7;              // lanes 8-31 repeat the tests of lanes 0-7
    const unsigned below = (1u << c) - 1u;
    if (lane == 0) w.stack[0] = 0;
    __syncwarp();                        // the bundle and the root are visible
    int sp = 1;
    int cnt = 0;
    while (sp > 0) {
        --sp;
        const int* rec = nodes + (long long)w.stack[sp] * kNodeWords;
        ++wc.nodes;
        float tlo, thi;
        box_bounds(b, __int_as_float(__ldg(rec + c)), __int_as_float(__ldg(rec + 8 + c)),
                   __int_as_float(__ldg(rec + 16 + c)), __int_as_float(__ldg(rec + 24 + c)),
                   __int_as_float(__ldg(rec + 32 + c)), __int_as_float(__ldg(rec + 40 + c)),
                   tlo, thi);
        const int link = __ldg(rec + 48 + c);
        const bool ov = lane < 8 && tlo <= thi;
        const unsigned inner = __ballot_sync(kFull, ov && link >= 0);
        const unsigned leaves = __ballot_sync(kFull, ov && link < 0 && link > kEmptyGuard);
        __syncwarp();                    // every lane has read stack[sp]
        if (lane < 8) {
            if (inner >> c & 1u) w.stack[sp + __popc(inner & below)] = link;
            if (leaves >> c & 1u) w.queue[cnt + __popc(leaves & below)] = -(link + 1);
        }
        sp += __popc(inner);
        cnt += __popc(leaves);
        __syncwarp();                    // the pushes are visible to the warp
        if (cnt >= kQCap - 8) {
            drain_queue(w, cnt, tris4, leaf_size, lane, r, h, wc);
            cnt = 0;
            ++wc.drains;
        }
    }
    drain_queue(w, cnt, tris4, leaf_size, lane, r, h, wc);
}

// Visit counts of one bundle, added to ``stats`` (5 int64, when given) as
// the plain version counts them: node pops and records per live ray,
// mid-walk drains, 1 if the bundle drained in mid-walk, and node pops
// once a warp.
__device__ __forceinline__ void add_wide_stats(unsigned long long* stats, int lane,
                                               long long base, long long n,
                                               const WideCounts& wc) {
    add_stats(stats, lane, base, n, wc.nodes, wc.records);
    if (stats != nullptr && lane == 0) {
        atomicAdd(stats + 4, wc.nodes);
        if (wc.drains > 0) {
            atomicAdd(stats + 2, wc.drains);
            atomicAdd(stats + 3, 1ull);
        }
    }
}

// Sets the kernel's dynamic shared memory limit where a block needs more
// than the default 48 KB; returns a cudaError_t.
template <typename Kernel>
inline int wide_smem_limit(Kernel kernel, int smem) {
    if (smem <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace lineage
