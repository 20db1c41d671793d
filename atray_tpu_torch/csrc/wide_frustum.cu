// Nearest triangle hit (t, u, v, face id) over a WideBVH by the 8-wide
// frustum walk, one warp per bundle of 32 rays.
//
// Replaces atray_tpu/kernels/wide_pallas.py::_wide_kernel. The TPU kernel
// keeps a per-block SMEM stack of wide nodes, tests the 8 children of a
// popped node with one vectorized interval test of the block's bounds,
// packs the overlap bits into a mask, and queues leaves for a straight-line
// drain (qcap = 512, drained in mid-walk at qcap - 8). Here the bundle is
// a warp: its bounds come from warp shuffles over the live lanes, lanes
// 0-7 test one child each from the node's cnodes record, __ballot_sync
// forms the mask, and the stack, queue, bounds and a ring of leaf slots
// that drains stream records through are per warp in shared memory
// (wide_walk.cuh, which also says what bounds the walk and what the
// design does about it).

#include "wide_walk.cuh"

using namespace lineage;

namespace {

// the build takes 64 registers (capped for 16 blocks it took 61 and ran 4% slower)
constexpr int kMinBlocks = 12;     // resident blocks an SM the registers must allow

__global__ void __launch_bounds__(kWideThreads, kMinBlocks) wide_frustum_kernel(
    const float* __restrict__ orig, const float* __restrict__ dirn, long long n,
    const int* __restrict__ nodes, const float4* __restrict__ tris4, int leaf_size,
    float* __restrict__ t_out, float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ id_out, unsigned long long* __restrict__ stats) {
    extern __shared__ float4 smem[];
    const long long base = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / kWarp * kWarp;
    if (base >= n) return;                       // the whole warp is past the end
    const int lane = threadIdx.x % kWarp;
    const long long i = base + lane;
    const bool live = i < n;
    const Ray r = load_ray(orig, dirn, i, live);
    const WideWarp w = wide_warp(smem, leaf_size);
    Hit h;
    WideCounts wc;
    wide_walk(w, r, live, lane, nodes, tris4, leaf_size, h, wc);
    if (live) store_hit(h, i, t_out, u_out, v_out, id_out);
    add_wide_stats(stats, lane, base, n, wc);
}

}  // namespace

// Shared memory a block of the launch takes at ``leaf_size``.
extern "C" int atray_wide_frustum_smem(int leaf_size) {
    return (int)(kWideWarps * wide_warp_smem(leaf_size));
}

// Launches on ``stream``; ``nodes`` is the accel's cnodes table, ``tris``
// its stride-16 leaf rows (16-byte aligned); ``stats`` (5 int64, or null)
// gains the visit counts. ``stack_cap`` and ``qcap`` are the caller's
// STACK_CAP and QCAP: cudaErrorInvalidValue unless they are kStackCap and
// kQCap. Returns cudaGetLastError() of the launch.
extern "C" int atray_wide_frustum(
    const float* orig, const float* dirn, long long n, const int* nodes,
    const float* tris, int leaf_size, int stack_cap, int qcap,
    float* t_out, float* u_out, float* v_out, int* id_out,
    unsigned long long* stats, void* stream) {
    if (stack_cap != kStackCap || qcap != kQCap) return (int)cudaErrorInvalidValue;
    if (n <= 0) return 0;
    const int smem = atray_wide_frustum_smem(leaf_size);
    const int err = wide_smem_limit(wide_frustum_kernel, smem);
    if (err != 0) return err;
    const long long blocks = (n + kWideThreads - 1) / kWideThreads;
    wide_frustum_kernel<<<(unsigned)blocks, kWideThreads, (size_t)smem, (cudaStream_t)stream>>>(
        orig, dirn, n, nodes, reinterpret_cast<const float4*>(tris), leaf_size,
        t_out, u_out, v_out, id_out, stats);
    return (int)cudaGetLastError();
}
