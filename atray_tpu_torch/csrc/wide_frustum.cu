// Nearest triangle hit (t, u, v, face id) over a WideBVH by the 8-wide
// frustum walk, one warp per bundle of 32 rays.
//
// Replaces atray_tpu/kernels/wide_pallas.py::_wide_kernel. The TPU kernel
// keeps a per-block SMEM stack of wide nodes, tests the 8 children of a
// popped node with one vectorized interval test of the block's bounds,
// packs the overlap bits into a mask, and queues leaves for a straight-line
// drain (qcap = 512, drained in mid-walk at qcap - 8). Here the bundle is
// a warp: its bounds come from warp shuffles over the live lanes, lanes
// 0-7 test one child each, __ballot_sync forms the mask, and the stack and
// queue are per warp in shared memory (wide_walk.cuh). Four warps a block,
// (192 + 512) x 4 bytes of shared memory a warp.
//
// What bounds it: as frustum_walk.cu, the lockstep union of the bundle. A
// wide node costs one dependent row load and one ballot for 8 boxes, so a
// coherent warp's walk is short; an incoherent warp passes nearly every
// box and drains nearly every leaf against all 32 lanes, and then the
// ray-triangle tests (about 45 float operations each) bound it.

#include "wide_walk.cuh"

using namespace lineage;

namespace {

constexpr int kWarpsPerBlock = 4;

__global__ void __launch_bounds__(kWarpsPerBlock * kWarp) wide_frustum_kernel(
    const float* __restrict__ orig, const float* __restrict__ dirn, long long n,
    const float* __restrict__ cboxes, const int* __restrict__ clinks, int num_nodes,
    const float* __restrict__ tris, const int* __restrict__ tris_i, int leaf_size,
    float* __restrict__ t_out, float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ id_out, unsigned long long* __restrict__ stats) {
    __shared__ int stack_s[kWarpsPerBlock][kStackCap];
    __shared__ int queue_s[kWarpsPerBlock][kQCap];
    const int w = threadIdx.x / kWarp;
    const long long base = ((long long)blockIdx.x * kWarpsPerBlock + w) * kWarp;
    if (base >= n) return;                       // the whole warp is past the end
    const int lane = threadIdx.x % kWarp;
    const long long i = base + lane;
    const bool live = i < n;
    const Ray r = load_ray(orig, dirn, i, live);
    const Bundle b = bundle_setup(r, live);
    Hit h;
    WideCounts wc;
    wide_bundle_walk(b, r, lane, cboxes, clinks, num_nodes, tris, tris_i, leaf_size,
                     stack_s[w], queue_s[w], h, wc);
    if (live) store_hit(h, i, t_out, u_out, v_out, id_out);
    add_wide_stats(stats, lane, base, n, wc);
}

}  // namespace

// Launches on ``stream``; ``stats`` (4 int64, or null) gains the visit
// counts. ``stack_cap`` and ``qcap`` are the caller's STACK_CAP and QCAP:
// cudaErrorInvalidValue unless they are kStackCap and kQCap. Returns
// cudaGetLastError() of the launch.
extern "C" int atray_wide_frustum(
    const float* orig, const float* dirn, long long n,
    const float* cboxes, const int* clinks, int num_nodes,
    const float* tris, int leaf_size, int stack_cap, int qcap,
    float* t_out, float* u_out, float* v_out, int* id_out,
    unsigned long long* stats, void* stream) {
    if (stack_cap != kStackCap || qcap != kQCap) return (int)cudaErrorInvalidValue;
    if (n <= 0) return 0;
    const long long warps = (n + kWarp - 1) / kWarp;
    const long long blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
    wide_frustum_kernel<<<(unsigned)blocks, kWarpsPerBlock * kWarp, 0, (cudaStream_t)stream>>>(
        orig, dirn, n, cboxes, clinks, num_nodes,
        tris, reinterpret_cast<const int*>(tris), leaf_size,
        t_out, u_out, v_out, id_out, stats);
    return (int)cudaGetLastError();
}
