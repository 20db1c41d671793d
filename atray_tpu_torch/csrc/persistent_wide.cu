// Nearest triangle hit (t, u, v, face id) over a WideBVH by the 8-wide
// frustum walk with persistent work distribution.
//
// Replaces atray_tpu/kernels/persistent_pallas.py::_persistent_kernel. The
// TPU kernel is one program that loops over all ray blocks and copies each
// in and out by DMA, because a per-program copy of the tables into SMEM and
// VMEM dominated there; its leaf queue holds every leaf. On the GPU the
// tables stay in device memory (and L2) and no block copies them, so what
// carries over is persistent work distribution: the grid holds as many
// blocks as are resident at once (the occupancy query at the launch's
// dynamic shared memory, times the SM count, atray_persistent_wide_grid),
// and each warp takes 32-ray bundles from a global atomic counter until
// none are left (Aila and Laine, "Understanding the Efficiency of Ray
// Traversal on GPUs", HPG 2009). A queue of every leaf does not fit in
// shared memory at the slice's size (23,863 leaves of the slice mesh at
// leaf size 8, 95 KB a warp), so it drains when full, as in
// wide_frustum.cu; the walk carries no tmax, so the results are the same.
//
// What bounds it: as wide_frustum.cu, whose walk (wide_walk.cuh) each
// bundle runs. The counter trades the hardware block scheduler for one
// atomic per bundle, which pays where bundles' costs differ widely
// (coherent and incoherent warps in one launch).

#include "wide_walk.cuh"

using namespace lineage;

namespace {

// 64 registers (capped for 12 blocks the build took 72, the grid held 14
// blocks an SM and ran 6% slower)
constexpr int kMinBlocks = 16;     // resident blocks an SM the registers must allow

__global__ void __launch_bounds__(kWideThreads, kMinBlocks) persistent_wide_kernel(
    const float* __restrict__ orig, const float* __restrict__ dirn, long long n,
    const int* __restrict__ nodes, const float4* __restrict__ tris4, int leaf_size,
    float* __restrict__ t_out, float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ id_out, unsigned long long* __restrict__ stats,
    unsigned long long* __restrict__ next_bundle) {
    extern __shared__ float4 smem[];
    const int lane = threadIdx.x % kWarp;
    const WideWarp w = wide_warp(smem, leaf_size);
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
        Hit h;
        WideCounts wc;
        wide_walk(w, r, live, lane, nodes, tris4, leaf_size, h, wc);
        if (live) store_hit(h, i, t_out, u_out, v_out, id_out);
        add_wide_stats(stats, lane, base, n, wc);
    }
}

}  // namespace

// Shared memory a block of the launch takes at ``leaf_size``.
extern "C" int atray_persistent_wide_smem(int leaf_size) {
    return (int)(kWideWarps * wide_warp_smem(leaf_size));
}

// Warps of the grid that fills the current device at ``leaf_size``:
// resident blocks per SM at this kernel's registers and dynamic shared
// memory, times the SM count, times the warps of a block; a value <= 0 is
// minus a CUDA error code.
extern "C" int atray_persistent_wide_grid(int leaf_size) {
    const int smem = atray_persistent_wide_smem(leaf_size);
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = (cudaError_t)wide_smem_limit(persistent_wide_kernel, smem);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, persistent_wide_kernel,
                                                            kWideThreads, (size_t)smem);
    }
    if (err != cudaSuccess) return -(int)err;
    return per_sm * sms * kWideWarps;
}

// Launches a persistent grid of ``warps`` warps (atray_persistent_wide_grid),
// or of one warp a bundle where there are fewer bundles, on ``stream``: a
// warp left without a bundle would only tilt the grid's work towards the
// SMs that take the bundles last. ``next_bundle`` is a zeroed int64
// counter; ``stats`` (5 int64, or null) gains the visit counts; the other
// arguments as in atray_wide_frustum. Returns cudaGetLastError() of the
// launch.
extern "C" int atray_persistent_wide(
    const float* orig, const float* dirn, long long n, const int* nodes,
    const float* tris, int leaf_size, int stack_cap, int qcap,
    float* t_out, float* u_out, float* v_out, int* id_out,
    unsigned long long* stats, unsigned long long* next_bundle, int warps, void* stream) {
    if (stack_cap != kStackCap || qcap != kQCap) return (int)cudaErrorInvalidValue;
    if (n <= 0) return 0;
    const long long bundle_blocks = (n + kWideThreads - 1) / kWideThreads;
    const int blocks = (int)(warps / kWideWarps < bundle_blocks ? warps / kWideWarps : bundle_blocks);
    if (blocks <= 0) return (int)cudaErrorInvalidConfiguration;
    const int smem = atray_persistent_wide_smem(leaf_size);
    const int err = wide_smem_limit(persistent_wide_kernel, smem);
    if (err != 0) return err;
    persistent_wide_kernel<<<(unsigned)blocks, kWideThreads, (size_t)smem,
                             (cudaStream_t)stream>>>(
        orig, dirn, n, nodes, reinterpret_cast<const float4*>(tris), leaf_size,
        t_out, u_out, v_out, id_out, stats, next_bundle);
    return (int)cudaGetLastError();
}
