// Nearest triangle hit (t, u, v, face id) over a TreePack by the frustum
// walk: the bundle's interval bounds walk the skip links warp-uniformly,
// overlapping leaves queue up, and a flush of 8 tests them against every
// lane.
//
// Replaces atray_tpu/kernels/frustum_pallas.py::_frustum_kernel. The TPU
// kernel summarizes a block of 1024 rays once by interval bounds (12
// reductions), walks the skip links on the scalar unit with the interval
// slab test of the bundle against each node box bounded by [0, tmax],
// queues overlapping leaves with their entry bound tlo (LEAF_BATCH = 8),
// and at a flush re-checks tlo <= tmax and tests each queued leaf's records
// against the block, then sets tmax = max(best_t). Here the bundle is a
// warp of 32 rays; the 12 bounds are warp shuffles over the live lanes
// (lineage.cuh), identical in every lane, and
// tmax is the warp max of best_t over the live lanes after each flush.
//
// What bounds it: the interval test of a bundle is looser than any of its
// rays' own slab tests. A coherent warp (neighbouring primaries) culls
// nearly as well as one ray; an incoherent one (bounce rays) passes nearly
// every box and tests every leaf's records on all 32 lanes, so its work is
// leaves x records x 32 ray-triangle tests, and the node walk is a chain of
// dependent loads. The design:
//   - a window of 32 skip-link positions a step, one lane a node: lane j
//     loads the 32-byte record of node p0 + j from cnodes
//     (accel/pack.py::pack_node_records, two 16-byte loads of one sector)
//     and takes the interval test of its box. A skipped node (culled, or a
//     leaf) blocks the positions inside its subtree, up to its miss link
//     (num_nodes where the link is -1); an inclusive max-scan of those ends
//     over the lanes gives the positions the walk visits. The ballot of
//     visited, overlapping leaves gives the pushes in skip-link order;
//   - the 8th queued leaf flushes. If the flush lowers tmax, the nodes after
//     that leaf were tested with the old bound: the window is cut just after
//     it, the walk resumes at its miss link and its later pushes are
//     dropped. Otherwise the window stands, and the next one starts at
//     max(p0 + 32, the scan's reach). So each flush tests the leaves the
//     one-node-a-step walk tests, with the same tmax, and the visits are
//     its visits (frustum_walk.py::frustum_ref walks the same windows);
//   - a queued leaf's records start an asynchronous copy (cp.async, 16 bytes
//     a lane: a leaf of 8 records is one 512-byte copy of the warp) into
//     its queue slot in the warp's shared memory, so they have arrived when
//     the flush reads them, each as three 16-byte loads at one address (a
//     broadcast);
//   - the record test is lineage.cuh's leaf_test_pairs: two records at a
//     time, dets first, v and t only where u is in [0, 1];
//   - the bundle's bounds live in the warp's shared memory, read at each
//     window's interval tests, so that the flush holds no registers for
//     them; blocks of 64 threads with registers capped for 16 blocks an SM
//     (64 registers, a spill of a few words).
// Measured and dropped (PERF.md holds the ladder): records one at a time,
// the flush reading records from global memory, the bounds in registers,
// 128- and 256-thread blocks, caps of 48 to 80 registers.
// The re-check tlo <= tmax never drops a leaf (tmax changes only at a
// flush, which empties the queue); it is kept as the reference has it.
//
// Order (the plain version's): leaves in queue order, each leaf's records
// in record order, strict t < best.t. NaN: see or_fill in lineage.cuh.

#include "lineage.cuh"

using namespace lineage;

namespace {

constexpr int kLeafBatch = 8;
constexpr int kThreads = 64;       // threads a block
constexpr int kMinBlocks = 16;     // resident blocks an SM the registers must allow
constexpr int kWarps = kThreads / kWarp;
constexpr int kBundleBytes = (sizeof(Bundle) + 15) / 16 * 16;

// A warp's shared memory: kLeafBatch queue slots of leaf_size records (4
// float4s each), the bundle, then the window's pushes (leaf row, tlo, miss
// end, lane; 32 each) and the slots' tlo.
__host__ __device__ constexpr long long warp_smem_bytes(int leaf_size) {
    return (long long)kLeafBatch * leaf_size * 64 + kBundleBytes + (4 * kWarp + kLeafBatch) * 4;
}

__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void copies_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void copies_wait() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

struct Walk {
    float4* slots;     // kLeafBatch x leaf_size records
    int* prow;         // the window's pushes, in skip-link order
    float* ptlo;
    int* pend;
    int* plane;
    float* qtlo;       // the queued slots' tlo
};

// Tests the cnt queued leaves (their copies waited for) against every lane
// and returns the new tmax.
__device__ __forceinline__ float flush(const Walk& w, int cnt, int leaf_size, float tmax,
                                       const Ray& r, bool live, Hit& h,
                                       unsigned long long& records) {
    copies_wait();
    __syncwarp();
    for (int q = 0; q < cnt; ++q) {
        if (w.qtlo[q] <= tmax) {
            leaf_test_pairs<false>(w.slots + (long long)q * leaf_size * 4, leaf_size, r, h);
            records += leaf_size;
        }
    }
    __syncwarp();      // the slots are free again
    return warp_max(live ? h.t : __int_as_float(0xff800000));
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) frustum_walk_kernel(
    const float* __restrict__ orig, const float* __restrict__ dirn, long long n,
    const int4* __restrict__ nodes, int num_nodes,
    const float4* __restrict__ tris4, int leaf_size,
    float* __restrict__ t_out, float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ id_out, unsigned long long* __restrict__ stats) {
    extern __shared__ float4 smem[];
    const long long base = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / kWarp * kWarp;
    if (base >= n) return;                       // the whole warp is past the end
    const int lane = threadIdx.x % kWarp;
    const long long i = base + lane;
    const bool live = i < n;
    const Ray r = load_ray(orig, dirn, i, live);

    Walk w;
    w.slots = smem + (threadIdx.x / kWarp) * (warp_smem_bytes(leaf_size) / 16);
    Bundle* bundle = reinterpret_cast<Bundle*>(w.slots + kLeafBatch * leaf_size * 4);
    {
        const Bundle setup = bundle_setup(r, live);
        if (lane == 0) *bundle = setup;
        __syncwarp();
    }
    const Bundle& b = *bundle;
    w.prow = reinterpret_cast<int*>(reinterpret_cast<char*>(bundle) + kBundleBytes);
    w.ptlo = reinterpret_cast<float*>(w.prow + kWarp);
    w.pend = w.prow + 2 * kWarp;
    w.plane = w.prow + 3 * kWarp;
    w.qtlo = w.ptlo + 3 * kWarp;
    const int leaf_chunks = leaf_size * 4;       // 16-byte words of a leaf
    const unsigned below = (1u << lane) - 1u;

    Hit h;
    unsigned long long steps = 0, records = 0;
    float tmax = kInf;
    int cnt = 0;       // queued leaves
    int p0 = 0;
    while (p0 < num_nodes) {
        const int p = p0 + lane;
        const bool inb = p < num_nodes;
        int4 a = make_int4(0, 0, 0, 0), c = make_int4(0, 0, 0, -1);
        if (inb) {
            a = __ldg(nodes + 2 * p);
            c = __ldg(nodes + 2 * p + 1);
        }
        float tlo, hi3;
        box_bounds(b, __int_as_float(a.x), __int_as_float(a.y), __int_as_float(a.z),
                   __int_as_float(a.w), __int_as_float(c.x), __int_as_float(c.y), tlo, hi3);
        const bool overlap = tlo <= fminf(hi3, tmax);
        const bool leaf = c.w >= 0;
        const int end = c.z >= 0 ? c.z : num_nodes;
        // reach: the largest end of a skipped node at or before this lane
        int reach = (inb && (!overlap || leaf)) ? end : 0;
#pragma unroll
        for (int s = 1; s < kWarp; s <<= 1) {
            const int o = __shfl_up_sync(kFull, reach, s);
            if (lane >= s) reach = max(reach, o);
        }
        const int prior = __shfl_up_sync(kFull, reach, 1);
        const bool visited = inb && (lane == 0 || prior <= p);
        const unsigned vis = __ballot_sync(kFull, visited);
        const unsigned push = __ballot_sync(kFull, visited && overlap && leaf);
        int next = max(p0 + kWarp, __shfl_sync(kFull, reach, kWarp - 1));
        __syncwarp();      // the last window's pushes are read
        if ((push >> lane) & 1u) {
            const int k = __popc(push & below);
            w.prow[k] = c.w;
            w.ptlo[k] = tlo;
            w.pend[k] = end;
            w.plane[k] = lane;
        }
        __syncwarp();
        unsigned counted = vis;
        const int npush = __popc(push);
        for (int taken = 0; taken < npush;) {
            const int take = min(npush - taken, kLeafBatch - cnt);
            if (lane < take) w.qtlo[cnt + lane] = w.ptlo[taken + lane];
            for (int j = 0; j < take; ++j) {
                const float4* src = tris4 + (long long)w.prow[taken + j] * 32;
                float4* dst = w.slots + (long long)(cnt + j) * leaf_chunks;
                for (int k = lane; k < leaf_chunks; k += kWarp) copy16_async(dst + k, src + k);
            }
            copies_commit();
            cnt += take;
            taken += take;
            if (cnt < kLeafBatch) break;
            const float t_new = flush(w, cnt, leaf_size, tmax, r, live, h, records);
            const bool lowered = t_new < tmax;
            cnt = 0;
            tmax = t_new;
            if (lowered) {
                // cut just after the leaf that filled the queue
                const int at = w.plane[taken - 1];
                counted = vis & (at == kWarp - 1 ? kFull : (2u << at) - 1u);
                next = w.pend[taken - 1];
                break;
            }
        }
        steps += __popc(counted);
        p0 = next;
    }
    if (cnt > 0) flush(w, cnt, leaf_size, tmax, r, live, h, records);
    if (live) store_hit(h, i, t_out, u_out, v_out, id_out);
    add_stats(stats, lane, base, n, steps, records);
    if (stats != nullptr && lane == 0) atomicAdd(stats + 2, steps);
}

}  // namespace

// Shared memory a block of the launch takes at ``leaf_size``.
extern "C" int atray_frustum_walk_smem(int leaf_size) {
    return (int)(kWarps * warp_smem_bytes(leaf_size));
}

// Launches on ``stream``; ``nodes`` is the pack's cnodes table, ``tris`` its
// stride-16 leaf records; ``stats`` (3 int64, or null) gains the visit
// counts: nodes and records per live ray, and the warps' node steps.
// Returns cudaGetLastError() of the launch.
extern "C" int atray_frustum_walk(
    const float* orig, const float* dirn, long long n, const int* nodes, int num_nodes,
    const float* tris, int leaf_size,
    float* t_out, float* u_out, float* v_out, int* id_out,
    unsigned long long* stats, void* stream) {
    if (n <= 0) return 0;
    const int smem = atray_frustum_walk_smem(leaf_size);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            frustum_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
    }
    const long long blocks = (n + kThreads - 1) / kThreads;
    frustum_walk_kernel<<<(unsigned)blocks, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
        orig, dirn, n, reinterpret_cast<const int4*>(nodes), num_nodes,
        reinterpret_cast<const float4*>(tris), leaf_size,
        t_out, u_out, v_out, id_out, stats);
    return (int)cudaGetLastError();
}
