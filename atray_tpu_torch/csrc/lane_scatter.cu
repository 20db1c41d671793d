// Lane scatter: out[c, dst[i]] += cols[c, i] over C float32 planes; lanes
// with dst[i] < 0 (or not below n) are dropped, output lanes nobody targets
// stay 0, duplicate targets sum.
//
// Replaces the scatter direction of atray_tpu/kernels/lane_pack.py
// (_lane_stream_kernel with scatter=True, called by lane_scatter, :632),
// which is the VJP of every lane take. The TPU routes lanes through banded
// one-hot matmuls, so its scatter needs a MONOTONE, banded dst (a window of
// input rows per output row, anchor alignment for segment-local maps). A
// GPU scatters directly: this kernel takes any dst, with no window and no
// anchor.
//
// The adds: atomicAdd into an output that the wrapper has zeroed. Duplicate
// targets sum in an order that changes from run to run; on an injective
// map (pack_indices, unpack_indices: every map the renderer makes) each
// output lane receives one add onto +0.0, so the result is exact, does not
// depend on order, and a -0.0 source gives +0.0 as the plain version does.
//
// What bounds it: device-memory bytes. Per call it must read 4 B x C x N
// of cols and 4 B x N of dst and write 4 B x C x N. The adds are
// read-modify-writes at L2 on lines the wrapper's zero fill wrote: a line
// evicted between the fill and its adds is read back from device memory,
// and a walk that adds into all C planes at once (99.5 MB at C = 12,
// N = 2,073,600) keeps few of them.
//
// Design (the take's traversal, lane_walk.cuh):
// - Plane-major order: the grid's second dimension walks groups of
//   ``group`` planes (sized by lane_pack.py::plane_group), so the adds of
//   the live blocks land on one group's planes, which stay in L2. Groups
//   are walked from the last plane down, so the first adds hit the lines
//   the fill wrote last. Each group re-reads dst, which is most of the work
//   on the gradient's sparse maps (few live lanes): the group size is the
//   take's, not smaller.
// - A thread owns four source lanes strided by the warp width: dst and
//   cols loads are coalesced, and on the path's monotone maps a warp's 32
//   adds of one plane fall on one or two 128-byte lines. The thread loads
//   four planes' values before their adds.
// - Tried on the card and dropped (PERF.md, PR 8's ladder): 16-byte loads
//   with one red.global.add.v4.f32 per aligned run of four targets (a gain
//   within the runs' spread even on maps of long live runs), and zeroing
//   each group inside one cooperative launch behind a grid sync (no faster
//   than the fill).

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_walk.cuh"

namespace {

using namespace lane_walk;

__global__ void __launch_bounds__(kThreads) lane_scatter_kernel(
    const float* __restrict__ cols, const int* __restrict__ dst, float* __restrict__ out,
    int c_planes, long long n, int group) {
    const long long wb = warp_base();
    if (wb >= n) return;
    int d[kLanes];
    bool any = false;
#pragma unroll
    for (int k = 0; k < kLanes; ++k) {
        const long long i = lane_of(wb, k);
        const int t = i < n ? __ldg(dst + i) : -1;
        d[k] = t >= 0 && (long long)t < n ? t : -1;
        any = any || d[k] >= 0;
    }
    if (!any) return;
    const Planes pl = group_planes(gridDim.y - 1 - blockIdx.y, group, c_planes);
    for (int c = pl.begin; c < pl.end; c += kStep) {
        float v[kStep][kLanes];
#pragma unroll
        for (int j = 0; j < kStep; ++j) {
            const float* p = cols + (long long)(c + j) * n;
#pragma unroll
            for (int k = 0; k < kLanes; ++k)
                v[j][k] = c + j < pl.end && d[k] >= 0 ? __ldg(p + lane_of(wb, k)) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < kStep; ++j) {
            if (c + j >= pl.end) break;
            float* o = out + (long long)(c + j) * n;
#pragma unroll
            for (int k = 0; k < kLanes; ++k)
                if (d[k] >= 0) atomicAdd(o + d[k], v[j][k]);
        }
    }
}

}  // namespace

// Launches on ``stream``; ``out`` must hold zeros; ``group`` planes per
// plane group (>= 1). Returns cudaGetLastError() of the launch.
extern "C" int atray_lane_scatter(const float* cols, const int* dst, float* out, int c_planes,
                                  long long n, int group, void* stream) {
    if (n <= 0 || c_planes <= 0) return 0;
    if (group < 1) return (int)cudaErrorInvalidValue;
    lane_scatter_kernel<<<lane_walk::grid(n, c_planes, group), lane_walk::kThreads, 0,
                          (cudaStream_t)stream>>>(cols, dst, out, c_planes, n, group);
    return (int)cudaGetLastError();
}
