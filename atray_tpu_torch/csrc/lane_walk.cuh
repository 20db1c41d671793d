// The traversal shared by the lane kernels (lane_take.cu, lane_scatter.cu):
// how one launch walks C planes of N 32-bit lanes in plane groups. The
// group size comes from the caller (lane_pack.py::plane_group, the one
// place that sizes groups).
//
// - Grid: x over lane blocks, y over walk steps, one plane group a step.
//   Blocks dispatch in linear order, so the blocks live at one time work on
//   one group's planes; correctness does not depend on that order.
// - Odd walk steps take their lane blocks backwards, so they start on the
//   index lines the step before read last.
// - A warp owns 32 x kLanes consecutive lanes, thread l the lanes
//   wb + 32 k + l (k < kLanes): every index load and every load or store of
//   a plane's own lanes is coalesced across the warp, for any N and any
//   4-byte base offset, with no vector path and no alignment flag.

#pragma once

#include <cuda_runtime.h>

namespace lane_walk {

constexpr int kThreads = 256;
constexpr int kLanes = 4;   // lanes a thread, strided by the warp width
constexpr int kStep = 4;    // planes whose loads are in flight together

// First lane of the calling thread's warp at walk step blockIdx.y.
__device__ __forceinline__ long long warp_base() {
    const unsigned bx = (blockIdx.y & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
    return ((long long)bx * kThreads + threadIdx.x - (threadIdx.x & 31)) * kLanes;
}

// Lane k of the calling thread, given its warp's first lane.
__device__ __forceinline__ long long lane_of(long long wb, int k) {
    return wb + 32 * k + (threadIdx.x & 31);
}

// Planes [begin, end) of plane group g.
struct Planes {
    int begin, end;
};

__device__ __forceinline__ Planes group_planes(int g, int group, int c_planes) {
    const int b = g * group;
    return {b, min(b + group, c_planes)};
}

// The launch grid: lane blocks by plane groups.
inline dim3 grid(long long n, int c_planes, int group) {
    const long long blocks = (n + kThreads * kLanes - 1) / (kThreads * kLanes);
    return dim3((unsigned)blocks, (unsigned)((c_planes + group - 1) / group));
}

}  // namespace lane_walk
