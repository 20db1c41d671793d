// The 8-wide frustum walk of one bundle (one warp), shared by
// wide_frustum.cu (one warp per bundle) and persistent_wide.cu (warps take
// bundles from a counter).
//
// Per popped wide node, lanes 0-7 each take the interval test of one child
// box (child c's field f is at cboxes[node][8f + c]; no tmax term, as in
// the reference) and __ballot_sync packs the overlap bits. Children are
// pushed in slot order: interior ones onto the warp's stack, leaves
// -(link + 1) into its leaf queue; empty slots (INT32_MIN links) are
// skipped by their link, never by their inverted boxes. Stack and queue
// live in shared memory, one of each per warp. The queue drains in mid-walk
// once it holds kQCap - 8 leaves (the reference's rule, wide_pallas.py:203)
// and whole at the end of the walk; a drain tests every queued leaf's
// records against every lane in queue order. With no tmax in the walk the
// drain points do not change any result.

#pragma once

#include "lineage.cuh"

namespace lineage {

constexpr int kStackCap = 192;   // STACK_CAP of kernels/wide_frustum.py
constexpr int kQCap = 512;       // QCAP of kernels/wide_frustum.py
constexpr int kEmptyGuard = -2147483647;   // links <= this are empty slots

struct WideCounts {
    unsigned long long nodes = 0, records = 0, drains = 0;
};

__device__ __forceinline__ void drain_queue(const int* queue, int cnt,
                                            const float* __restrict__ tris,
                                            const int* __restrict__ tris_i, int leaf_size,
                                            const Ray& r, Hit& h, WideCounts& wc) {
    for (int q = 0; q < cnt; ++q) {
        leaf_test(tris, tris_i, queue[q], leaf_size, r, h);
    }
    wc.records += (unsigned long long)cnt * leaf_size;
}

// ``stack`` and ``queue`` are this warp's kStackCap and kQCap entries of
// shared memory. The caller guarantees 8 * (max_depth + 2) <= kStackCap.
__device__ __forceinline__ void wide_bundle_walk(
    const Bundle& b, const Ray& r, int lane,
    const float* __restrict__ cboxes, const int* __restrict__ clinks, int num_nodes,
    const float* __restrict__ tris, const int* __restrict__ tris_i, int leaf_size,
    int* stack, int* queue, Hit& h, WideCounts& wc) {
    const int c = lane & 7;              // lanes 8-31 repeat the tests of lanes 0-7
    const unsigned below = (1u << c) - 1u;
    __syncwarp();                        // the previous bundle's readers are done
    if (lane == 0) stack[0] = 0;
    __syncwarp();
    int sp = 1;
    int cnt = 0;
    while (sp > 0) {
        --sp;
        const int node = stack[sp];
        ++wc.nodes;
        const float* row = cboxes + (long long)node * 128;
        float tlo, thi;
        box_bounds(b, row[c], row[8 + c], row[16 + c], row[24 + c], row[32 + c], row[40 + c],
                   tlo, thi);
        const bool ov = lane < 8 && tlo <= thi;
        const int link = clinks[(long long)c * num_nodes + node];
        const unsigned inner = __ballot_sync(kFull, ov && link >= 0);
        const unsigned leaves = __ballot_sync(kFull, ov && link < 0 && link > kEmptyGuard);
        __syncwarp();                    // every lane has read stack[sp]
        if (lane < 8) {
            if (inner >> c & 1u) stack[sp + __popc(inner & below)] = link;
            if (leaves >> c & 1u) queue[cnt + __popc(leaves & below)] = -(link + 1);
        }
        sp += __popc(inner);
        cnt += __popc(leaves);
        __syncwarp();                    // the pushes are visible to the warp
        if (cnt >= kQCap - 8) {
            drain_queue(queue, cnt, tris, tris_i, leaf_size, r, h, wc);
            cnt = 0;
            ++wc.drains;
        }
    }
    drain_queue(queue, cnt, tris, tris_i, leaf_size, r, h, wc);
}

// Visit counts of one bundle, added to ``stats`` (4 int64, when given) as
// the plain version counts them: node pops and records per live ray,
// mid-walk drains, and 1 if the bundle drained in mid-walk.
__device__ __forceinline__ void add_wide_stats(unsigned long long* stats, int lane,
                                               long long base, long long n,
                                               const WideCounts& wc) {
    add_stats(stats, lane, base, n, wc.nodes, wc.records);
    if (stats != nullptr && lane == 0 && wc.drains > 0) {
        atomicAdd(stats + 2, wc.drains);
        atomicAdd(stats + 3, 1ull);
    }
}

}  // namespace lineage
