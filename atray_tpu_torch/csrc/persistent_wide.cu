// Nearest triangle hit (t, u, v, face id) over a WideBVH by the 8-wide
// frustum walk with persistent work distribution.
//
// Replaces atray_tpu/kernels/persistent_pallas.py::_persistent_kernel. The
// TPU kernel is one program that loops over all ray blocks and copies each
// in and out by DMA, because a per-program copy of the tables into SMEM and
// VMEM dominated there; its leaf queue holds every leaf. On the GPU the
// tables stay in device memory (and L2) and no block copies anything, so
// what carries over is persistent work distribution: the grid holds as
// many blocks as are resident at once (the occupancy query times the SM
// count, atray_persistent_wide_grid), and each warp takes 32-ray bundles
// from a global atomic counter until none are left (Aila and Laine,
// "Understanding the Efficiency of Ray Traversal on GPUs", HPG 2009). A
// queue of every leaf does not fit in shared memory at the slice's size
// (23,863 leaves of the slice mesh at leaf size 8, 95 KB a warp), so it
// drains when full, as in wide_frustum.cu; the walk carries no tmax, so
// the results are the same.
//
// What bounds it: as wide_frustum.cu. The counter trades the hardware
// block scheduler for one atomic per bundle, which pays where bundles'
// costs differ widely (coherent and incoherent warps in one launch).

#include "wide_walk.cuh"

using namespace lineage;

namespace {

constexpr int kWarpsPerBlock = 4;

__global__ void __launch_bounds__(kWarpsPerBlock * kWarp) persistent_wide_kernel(
    const float* __restrict__ orig, const float* __restrict__ dirn, long long n,
    const float* __restrict__ cboxes, const int* __restrict__ clinks, int num_nodes,
    const float* __restrict__ tris, const int* __restrict__ tris_i, int leaf_size,
    float* __restrict__ t_out, float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ id_out, unsigned long long* __restrict__ stats,
    unsigned long long* __restrict__ next_bundle) {
    __shared__ int stack_s[kWarpsPerBlock][kStackCap];
    __shared__ int queue_s[kWarpsPerBlock][kQCap];
    const int w = threadIdx.x / kWarp;
    const int lane = threadIdx.x % kWarp;
    const unsigned long long bundles = (unsigned long long)((n + kWarp - 1) / kWarp);
    while (true) {
        unsigned long long bundle = 0;
        if (lane == 0) bundle = atomicAdd(next_bundle, 1ull);
        bundle = __shfl_sync(kFull, bundle, 0);
        if (bundle >= bundles) break;
        const long long base = (long long)bundle * kWarp;
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
}

}  // namespace

// Warps of the grid that fills the current device: resident blocks per SM
// at this kernel's registers and shared memory, times the SM count, times
// the warps of a block; a value <= 0 is minus a CUDA error code.
extern "C" int atray_persistent_wide_grid() {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, persistent_wide_kernel, kWarpsPerBlock * kWarp, 0);
    }
    if (err != cudaSuccess) return -(int)err;
    return per_sm * sms * kWarpsPerBlock;
}

// Launches a persistent grid of ``warps`` warps (atray_persistent_wide_grid)
// on ``stream``; ``next_bundle`` is a zeroed int64 counter; ``stats`` (4
// int64, or null) gains the visit counts; ``stack_cap`` and ``qcap`` as in
// atray_wide_frustum. Returns cudaGetLastError() of the launch.
extern "C" int atray_persistent_wide(
    const float* orig, const float* dirn, long long n,
    const float* cboxes, const int* clinks, int num_nodes,
    const float* tris, int leaf_size, int stack_cap, int qcap,
    float* t_out, float* u_out, float* v_out, int* id_out,
    unsigned long long* stats, unsigned long long* next_bundle, int warps, void* stream) {
    if (stack_cap != kStackCap || qcap != kQCap) return (int)cudaErrorInvalidValue;
    if (n <= 0) return 0;
    const int blocks = warps / kWarpsPerBlock;
    if (blocks <= 0) return (int)cudaErrorInvalidConfiguration;
    persistent_wide_kernel<<<(unsigned)blocks, kWarpsPerBlock * kWarp, 0,
                             (cudaStream_t)stream>>>(
        orig, dirn, n, cboxes, clinks, num_nodes,
        tris, reinterpret_cast<const int*>(tris), leaf_size,
        t_out, u_out, v_out, id_out, stats, next_bundle);
    return (int)cudaGetLastError();
}
