// Lane take: out[c, i] = (0 <= idx[i] < n) ? cols[c, idx[i]] : 0 over C
// planes of 32-bit words.
//
// Replaces the take direction of atray_tpu/kernels/lane_pack.py: the stream
// take (_lane_stream_kernel, :202) and the route (_lane_route_kernel, :65).
// The TPU routes lanes through banded one-hot matmuls on its matrix unit,
// which is why the reference needs a band contract (each output row's
// sources within a window of rows); a GPU gathers directly, so this kernel
// has no band and no window and accepts any index map.
//
// It moves words, not floats: float planes and int32 planes (ray ids,
// liveness, NaN-bit payloads) ride the same call bit-exactly.
//
// What bounds it: device-memory bytes. Per call it must read 4 B x C x N of
// sources and 4 B x N of idx and write 4 B x C x N. A scattered map is the
// hard case: each 4-byte gather pulls a 32-byte sector, and a lane-major
// walk touches all C planes at once (232 MB at C = 14, N = 4,147,200, over a
// 50 MB L2), so nearly every gather misses L2 and the kernel is bound by
// sector traffic, not by the bytes above.
//
// Design (the traversal is lane_walk.cuh's):
// - Plane-major order. The grid's second dimension walks groups of
//   ``group`` planes, so the blocks live at one time gather from one
//   group's planes, which the wrapper sizes to fit L2 with the idx they
//   re-read (lane_pack.py::plane_group). Where even one plane and idx
//   overflow L2 (the pair routing maps, N = K x R), one group takes all
//   planes and reads idx once.
// - Several lanes a thread, misses in flight: a thread owns four lanes
//   strided by the warp width and issues the gathers of four planes (16
//   loads) before their stores. 16-byte vector loads and stores measured
//   no faster (PERF.md, PR 8's ladder).

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_walk.cuh"

namespace {

using namespace lane_walk;

__global__ void __launch_bounds__(kThreads) lane_take_kernel(
    const uint32_t* __restrict__ cols, const int* __restrict__ idx,
    uint32_t* __restrict__ out, int c_planes, long long n, int group) {
    const long long wb = warp_base();
    if (wb >= n) return;
    int src[kLanes];
#pragma unroll
    for (int k = 0; k < kLanes; ++k) {
        const long long i = lane_of(wb, k);
        const int s = i < n ? __ldg(idx + i) : -1;
        src[k] = s >= 0 && (long long)s < n ? s : -1;
    }
    const Planes pl = group_planes(blockIdx.y, group, c_planes);
    for (int c = pl.begin; c < pl.end; c += kStep) {
        uint32_t v[kStep][kLanes];
#pragma unroll
        for (int j = 0; j < kStep; ++j) {
            const uint32_t* p = cols + (long long)(c + j) * n;
#pragma unroll
            for (int k = 0; k < kLanes; ++k)
                v[j][k] = c + j < pl.end && src[k] >= 0 ? __ldg(p + src[k]) : 0u;
        }
#pragma unroll
        for (int j = 0; j < kStep; ++j) {
            if (c + j >= pl.end) break;
            uint32_t* o = out + (long long)(c + j) * n;
#pragma unroll
            for (int k = 0; k < kLanes; ++k) {
                const long long i = lane_of(wb, k);
                if (i < n) o[i] = v[j][k];
            }
        }
    }
}

}  // namespace

// Launches on ``stream``; ``group`` planes per plane group (>= 1). Returns
// cudaGetLastError() of the launch.
extern "C" int atray_lane_take(const void* cols, const int* idx, void* out, int c_planes,
                               long long n, int group, void* stream) {
    if (n <= 0 || c_planes <= 0) return 0;
    if (group < 1) return (int)cudaErrorInvalidValue;
    lane_take_kernel<<<lane_walk::grid(n, c_planes, group), lane_walk::kThreads, 0,
                       (cudaStream_t)stream>>>(static_cast<const uint32_t*>(cols), idx,
                                               static_cast<uint32_t*>(out), c_planes, n, group);
    return (int)cudaGetLastError();
}
