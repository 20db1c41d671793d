// Probe kernel P11: the lane take in the plane-major layout with source rows
// staged through shared memory,
//   out[c, i] = cols[c, idx[i]] for idx[i] in [0, N), else 0,
// over cols and out of shape (C, rows, 128), N = 128 rows: the function of
// lane_take.cu.
//
// Replaces scripts/probe_r22.py:26 _kern (through take, :231), the TPU's
// streaming lane take bisected into a full run, one without its copies
// (nodma) and one without its compute (nocompute). The TPU kernel streams
// slabs of source rows through VMEM, double-buffered, and routes each output
// row from them with one-hot products. The question for this card is whether
// staging source rows in fast memory pays against lane_take.cu's direct
// gather from device memory.
//
// Design. Block b takes output rows b, b + grid, ... (the live rows of a
// packed map are a prefix, so every block gets some). For each output row a
// block reduction finds the span of source rows its lanes read, [w0, w0 +
// nrow). A stage holds that span for a group of planes: one window row of
// all C = 14 planes is 7,168 B, and the TPU's wcap = 64 window (458,752 B)
// or even wcap = 16 double-buffered (229,376 B) leaves nothing of the
// 232,448 B a block may have. So a stage holds only the rows the map
// touches, and as many planes of them as fit 48 KiB (96 plane-rows): a
// banded map at occupancy 0.15 spans about 8 rows (12 planes a stage), at
// 0.035 about 30 (3 planes a stage). Thread 0 issues one bulk copy
// (cp.async.bulk, probe.cuh) per plane of the next stage into the other
// half of a two-stage ring while the block gathers the current stage from
// shared memory; an mbarrier per half counts the bytes in. A row whose span
// exceeds 96 rows (a scattered map) is gathered from device memory directly,
// so the kernel is exact on any map. Two blocks fit an SM (96 KiB each).
//
// Modes: 0 full (checked); 1 nocopy, the TPU's nodma: no copy is issued or
// waited for and the gather reads stale shared memory (timing only);
// 2 nocompute: the copies run, nothing is gathered or stored (the output
// stays as the caller made it; timing only).
//
// What bounds it: device-memory bytes. The function needs the index (4 N),
// the C words of each live lane and the output (4 C N); staging reads every
// word of the spans (for a packed map nearly all of cols), which the probe
// sets against that need.

#include <climits>

#include <cuda_runtime.h>
#include <stdint.h>

#include "probe.cuh"

namespace {

constexpr int kLane = 128;
constexpr int kThreads = 128;
constexpr int kStageWords = 48 * 1024 / 4;
constexpr int kStageRows = kStageWords / kLane;  // plane-rows a stage holds

enum Mode { kFull = 0, kNoCopy = 1, kNoCompute = 2 };

struct Span {
    int w0;       // first source row of the output row
    int nrow;     // source rows it spans; 0 when no lane is live
    int np;       // planes a stage holds
    int groups;   // stages of the row
    bool staged;  // 1 <= nrow <= kStageRows; otherwise gathered directly
};

// The span of output row j; every thread of the block calls it.
__device__ Span row_span(const int* __restrict__ idx, int j, long long n, int c, int* red) {
    const int s = idx[(long long)j * kLane + threadIdx.x];
    const bool ok = s >= 0 && (long long)s < n;
    int lo = ok ? (s >> 7) : INT_MAX;
    int hi = ok ? (s >> 7) : -1;
#pragma unroll
    for (int o = 16; o; o >>= 1) {
        lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
        hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    const int w = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
        red[w] = lo;
        red[4 + w] = hi;
    }
    __syncthreads();
    lo = min(min(red[0], red[1]), min(red[2], red[3]));
    hi = max(max(red[4], red[5]), max(red[6], red[7]));
    __syncthreads();
    Span sp;
    sp.w0 = lo;
    sp.nrow = hi >= lo ? hi - lo + 1 : 0;
    sp.staged = sp.nrow > 0 && sp.nrow <= kStageRows;
    sp.np = sp.staged ? min(c, kStageRows / sp.nrow) : c;
    sp.groups = sp.staged ? (c + sp.np - 1) / sp.np : 1;
    return sp;
}

// Thread 0: planes [g np, g np + np) of the span into one half of the ring.
__device__ void issue_stage(const uint32_t* __restrict__ cols, int rows, const Span& sp, int g,
                            int c, uint32_t* buf, uint64_t* bar) {
    const int p0 = g * sp.np, p1 = min(c, p0 + sp.np);
    const uint32_t bytes = (uint32_t)sp.nrow * kLane * 4;
    mbar_expect_tx(bar, bytes * (uint32_t)(p1 - p0));
    for (int p = p0; p < p1; ++p) {
        bulk_g2s(buf + (p - p0) * sp.nrow * kLane, cols + ((long long)p * rows + sp.w0) * kLane,
                 bytes, bar);
    }
}

__device__ void gather_stage(const uint32_t* __restrict__ cols, const int* __restrict__ idx,
                             uint32_t* __restrict__ out, long long n, int c, int j, const Span& sp,
                             int g, const uint32_t* buf) {
    const long long i = (long long)j * kLane + threadIdx.x;
    const int s = idx[i];
    const bool ok = s >= 0 && (long long)s < n;
    const int p0 = g * sp.np, p1 = min(c, p0 + sp.np);
    if (sp.staged) {
        const int off = ok ? ((s >> 7) - sp.w0) * kLane + (s & 127) : 0;
        for (int p = p0; p < p1; ++p) out[p * n + i] = ok ? buf[(p - p0) * sp.nrow * kLane + off] : 0u;
    } else {
        for (int p = p0; p < p1; ++p) out[p * n + i] = ok ? cols[p * n + s] : 0u;
    }
}

__global__ void __launch_bounds__(kThreads)
    probe_stream_take_kernel(const uint32_t* __restrict__ cols, const int* __restrict__ idx,
                             uint32_t* __restrict__ out, int rows, int c, int mode) {
    extern __shared__ __align__(128) uint32_t take_smem[];
    __shared__ __align__(8) uint64_t bar[2];
    __shared__ int red[8];
    const long long n = (long long)rows * kLane;
    int j = blockIdx.x;
    if (j >= rows) return;
    const bool copy = mode != kNoCopy, compute = mode != kNoCompute;
    if (threadIdx.x == 0) {
        mbar_init(&bar[0], 1);
        mbar_init(&bar[1], 1);
        fence_mbar_init();
    }
    __syncthreads();
    Span cur = row_span(idx, j, n, c, red);
    Span nxt = cur;
    if (threadIdx.x == 0 && copy && cur.staged) issue_stage(cols, rows, cur, 0, c, take_smem, &bar[0]);
    int g = 0, st = 0;
    uint32_t phase = 0;  // bit h: the parity half h waits on next
    while (true) {
        // the stage after (j, g), and its copy into the other half
        int nj = j, ng = g + 1;
        if (ng == cur.groups) {
            nj = j + gridDim.x;
            ng = 0;
        }
        const bool more = nj < rows;
        if (more && ng == 0) nxt = row_span(idx, nj, n, c, red);
        const Span& ns = ng == 0 ? nxt : cur;
        if (threadIdx.x == 0 && copy && more && ns.staged) {
            issue_stage(cols, rows, ns, ng, c, take_smem + (st ^ 1) * kStageWords, &bar[st ^ 1]);
        }
        if (copy && cur.staged) {
            mbar_wait(&bar[st], (phase >> st) & 1u);
            phase ^= 1u << st;
        }
        if (compute) gather_stage(cols, idx, out, n, c, j, cur, g, take_smem + st * kStageWords);
        __syncthreads();  // the half is free for the copy issued next
        if (!more) break;
        if (ng == 0) cur = nxt;
        j = nj;
        g = ng;
        st ^= 1;
    }
}

}  // namespace

// cols, out: (c_planes, rows, 128) 32-bit words; idx: (rows * 128,) i32;
// mode 0 full, 1 nocopy, 2 nocompute. Launches on ``stream``; returns
// cudaGetLastError() of the launch.
extern "C" int atray_probe_stream_take(const void* cols, const int* idx, void* out, int rows,
                                       int c_planes, int mode, void* stream) {
    if (rows <= 0 || c_planes <= 0) return 0;
    if (mode < kFull || mode > kNoCompute) return (int)cudaErrorInvalidValue;
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int smem = 2 * kStageWords * 4;
    if (err == cudaSuccess) err = allow_smem(probe_stream_take_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = rows < 2 * sms ? rows : 2 * sms;
    probe_stream_take_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
        static_cast<const uint32_t*>(cols), idx, static_cast<uint32_t*>(out), rows, c_planes, mode);
    return (int)cudaGetLastError();
}
