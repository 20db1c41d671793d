// Probe kernel P10: the lane take over a ray-major layout,
//   out[j, c, l] = cols[s / 128, c, s % 128] for s = idx[128 j + l] in [0, N),
//   else 0, over cols and out of shape (rows, C, 128), N = 128 rows.
//
// Replaces scripts/probe_r21.py:26 _kernel (through lane_take_rm, :131). The
// TPU kernel asks whether a ray-major (rows, C, 128) layout, where a window
// row of all C planes is one contiguous burst, beats the plane-major
// (C, rows, 128) layout of the package's lane take. It routes each output
// row through a window of wcap rows from its smallest source with one-hot
// products, and drops sources beyond the window (the band limit). This
// kernel gathers directly, with no band and no wcap: on the banded maps that
// pack_indices makes the two agree, and on any other map this one is exact.
//
// One thread per output lane, moving 32-bit words (float or int bits alike):
// it reads its index once and moves C words. Neighbouring threads store to
// neighbouring words of each plane; they read from a source row's C planes
// at the row stride of C x 512 B, so a warp's reads of one plane stay within
// one source row where the map is banded. Its time beside the plane-major
// lane_take.cu on the same data and maps is the probe's answer.
//
// What bounds it: device-memory bytes, the index (4 N), the C words of each
// live lane (4 C per lane) and the output (4 C N).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void probe_take_rm_kernel(const uint32_t* __restrict__ cols, const int* __restrict__ idx,
                                     uint32_t* __restrict__ out, int c_planes, long long n) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
        const int s = idx[i];
        const bool ok = s >= 0 && (long long)s < n;
        const long long src = ok ? ((long long)(s >> 7) * c_planes) * 128 + (s & 127) : 0;
        const long long dst = ((i >> 7) * c_planes) * 128 + (i & 127);
        for (int c = 0; c < c_planes; ++c) out[dst + c * 128] = ok ? cols[src + c * 128] : 0u;
    }
}

}  // namespace

// cols, out: (rows, c_planes, 128) 32-bit words; idx: (rows * 128,) i32.
// Launches on ``stream``; returns cudaGetLastError() of the launch.
extern "C" int atray_probe_take_rm(const void* cols, const int* idx, void* out, int rows,
                                   int c_planes, void* stream) {
    if (rows <= 0 || c_planes <= 0) return 0;
    const long long n = (long long)rows * 128;
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond this
    probe_take_rm_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        static_cast<const uint32_t*>(cols), idx, static_cast<uint32_t*>(out), c_planes, n);
    return (int)cudaGetLastError();
}
