// Lane take: out[c, i] = (0 <= idx[i] < n) ? cols[c, idx[i]] : 0 over C
// planes of 32-bit words.
//
// Replaces the take direction of atray_tpu/kernels/lane_pack.py
// (_lane_stream_kernel and _lane_route_kernel). The TPU routes lanes
// through banded one-hot matmuls on its matrix unit, which is why the
// reference needs a band contract (each output row's sources within a
// window of rows); a GPU gathers directly, so this kernel has no band and
// no window and accepts any index map.
//
// It moves words, not floats: float planes and int32 planes (ray ids,
// liveness) ride the same call bit-exactly.
//
// What bounds it: device-memory bytes. Per call it reads 4 B x C x N
// through idx (a scattered map reads up to about twice that in partly used
// sectors), reads idx once (4 B x N) and writes 4 B x C x N. The design is
// a grid-stride loop with one index load per output lane and C coalesced
// stores; each plane's reads hit the same scattered positions.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void lane_take_kernel(const uint32_t* __restrict__ cols,
                                 const int* __restrict__ idx,
                                 uint32_t* __restrict__ out, int c_planes,
                                 long long n) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
        const int s = idx[i];
        const bool ok = s >= 0 && (long long)s < n;
        for (int c = 0; c < c_planes; ++c) {
            out[(long long)c * n + i] = ok ? cols[(long long)c * n + s] : 0u;
        }
    }
}

}  // namespace

// Launches on ``stream``; returns cudaGetLastError() of the launch.
extern "C" int atray_lane_take(const void* cols, const int* idx, void* out,
                               int c_planes, long long n, void* stream) {
    if (n <= 0 || c_planes <= 0) return 0;
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 132 * 16) blocks = 132 * 16;   // grid-stride beyond this
    lane_take_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        static_cast<const uint32_t*>(cols), idx, static_cast<uint32_t*>(out),
        c_planes, n);
    return (int)cudaGetLastError();
}
