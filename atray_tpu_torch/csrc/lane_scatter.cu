// Lane scatter: out[c, dst[i]] += cols[c, i] over C float32 planes; lanes
// with dst[i] < 0 (or not below n) are dropped, output lanes nobody targets
// stay 0, duplicate targets sum.
//
// Replaces the scatter direction of atray_tpu/kernels/lane_pack.py
// (_lane_stream_kernel with scatter=True, called by lane_scatter), which is
// the VJP of every lane take. The TPU routes lanes through banded one-hot
// matmuls, so its scatter needs a MONOTONE, banded dst (a window of input
// rows per output row, anchor alignment for segment-local maps). A GPU
// scatters directly: this kernel takes any dst, with no window and no
// anchor.
//
// Design: one thread per input lane, a grid-stride loop, C planes per
// thread, atomicAdd into an output that the wrapper has zeroed. The atomics
// make duplicate targets sum in an order that changes from run to run; on
// an injective map (pack_indices, unpack_indices: every map the renderer
// makes) each output lane receives one add onto +0.0, so the result is
// exact and does not depend on order.
//
// What bounds it: device-memory bytes. Per call it reads 4 B x C x N of
// cols (coalesced), 4 B x N of dst, and writes 4 B x C x N through the
// atomics (L2 read-modify-write; on a monotone map neighbouring threads hit
// neighbouring words, so the atomics coalesce into few sectors).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void lane_scatter_kernel(const float* __restrict__ cols,
                                    const int* __restrict__ dst,
                                    float* __restrict__ out, int c_planes,
                                    long long n) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
        const int d = dst[i];
        if (d < 0 || (long long)d >= n) continue;
        for (int c = 0; c < c_planes; ++c) {
            atomicAdd(out + (long long)c * n + d, cols[(long long)c * n + i]);
        }
    }
}

}  // namespace

// Launches on ``stream``; ``out`` must hold zeros. Returns
// cudaGetLastError() of the launch.
extern "C" int atray_lane_scatter(const float* cols, const int* dst, float* out,
                                  int c_planes, long long n, void* stream) {
    if (n <= 0 || c_planes <= 0) return 0;
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 132 * 16) blocks = 132 * 16;   // grid-stride beyond this
    lane_scatter_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        cols, dst, out, c_planes, n);
    return (int)cudaGetLastError();
}
