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
// Its time beside the plane-major lane_take.cu on the same data and maps is
// the probe's answer.
//
// What bounds it: device-memory bytes. The function needs the index (4 N),
// the C words of each live lane and the output (4 C N); the memory moves
// whole 32-byte sectors, so no design reads less of cols than C sectors for
// each 8-lane group of a source row that holds a live source
// (probe_r21.sector_work).
//
// The design (PERF.md section 6 gives its ladder): a warp owns an output row.
// Its 128 index words arrive in one 16-byte load a lane. A row with no live
// lane (__any_sync) stores C zero words a lane and reads nothing from cols.
// A live row passes its index words through the warp's shared tile, so that
// lane t gathers output lanes t + 32 k, k < 4: each gather instruction then
// reads 32 consecutive sources of the packed map, a few 128-byte lines of a
// plane, where lanes 4t + k would spread one instruction over the row's
// whole span (four times the L1 wavefronts: 35-45% slower on an NVIDIA H100
// 80GB HBM3 at a 700 W power limit).
// The planes go in batches of kBatch: all 4 x kBatch loads of a batch are
// issued (ld.global.nc, predicated on the lane's liveness, 0 where dead),
// then the words are transposed through the tile, and each plane leaves as
// one 16-byte store a lane, the warp's store one whole 512-byte plane-row.
// Every store is evict-first (st.global.cs): the output is not read again,
// and a stream of dead rows then writes at a memset's rate. C is a template
// parameter, an instance for each of 1-16 planes; more planes run as chunks
// of 16 over the row stride C x 128. Words move as bits (float or int
// alike), through no float operation.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLane = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPlanes = 16;       // planes of one instance; more run as chunks
constexpr int kBatch = 7;            // planes whose loads are in flight together

// the word at p where ok, else 0: the load is issued by live lanes only
__device__ __forceinline__ uint32_t load_live(const uint32_t* p, bool ok) {
    uint32_t v = 0u;
    asm volatile(
        "{\n\t.reg .pred q;\n\t"
        "setp.ne.u32 q, %2, 0;\n\t"
        "@q ld.global.nc.u32 %0, [%1];\n\t}"
        : "+r"(v)
        : "l"(p), "r"((unsigned)ok));
    return v;
}

__device__ __forceinline__ bool live(int s, long long n) { return s >= 0 && (long long)s < n; }

// A minimum of one block an SM leaves ptxas free to take 72 registers at C =
// 14, so three blocks (24 warps) share an SM; without it ptxas took 64 and
// four blocks, which ran the scattered map 1.4% and occupancy 0.15 1.3%
// slower on an NVIDIA H100 80GB HBM3 at a 700 W power limit.
template <int CP>
__global__ void __launch_bounds__(kThreads, 1)
probe_take_rm_kernel(const uint32_t* __restrict__ cols, const int* __restrict__ idx,
                     uint32_t* __restrict__ out, int rows, long long n, long long stride) {
    constexpr int G = kBatch < CP ? kBatch : CP;
    __shared__ __align__(16) uint32_t tiles[kWarps][G * kLane];
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (row >= rows) return;
    const int4 q = __ldg(reinterpret_cast<const int4*>(idx) + (long long)row * 32 + lane);
    uint4* dst = reinterpret_cast<uint4*>(out + (long long)row * stride) + lane;
    if (!__any_sync(0xffffffffu, live(q.x, n) || live(q.y, n) || live(q.z, n) || live(q.w, n))) {
#pragma unroll
        for (int c = 0; c < CP; ++c) __stcs(dst + c * (kLane / 4), make_uint4(0u, 0u, 0u, 0u));
        return;
    }
    uint32_t* tile = tiles[threadIdx.x >> 5];
    reinterpret_cast<int4*>(tile)[lane] = q;
    __syncwarp();
    bool ok[4];
    const uint32_t* src[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const int s = (int)tile[32 * k + lane];
        ok[k] = live(s, n);
        const int t = ok[k] ? s : 0;
        src[k] = cols + (long long)(t >> 7) * stride + (t & (kLane - 1));
    }
    __syncwarp();
#pragma unroll
    for (int c0 = 0; c0 < CP; c0 += G) {
        uint32_t v[G][4];
#pragma unroll
        for (int c = 0; c < G; ++c)
#pragma unroll
            for (int k = 0; k < 4; ++k)
                v[c][k] = c0 + c < CP ? load_live(src[k] + (c0 + c) * kLane, ok[k]) : 0u;
#pragma unroll
        for (int c = 0; c < G; ++c)
#pragma unroll
            for (int k = 0; k < 4; ++k) tile[c * kLane + 32 * k + lane] = v[c][k];
        __syncwarp();
#pragma unroll
        for (int c = 0; c < G; ++c)
            if (c0 + c < CP)
                __stcs(dst + (c0 + c) * (kLane / 4),
                       reinterpret_cast<const uint4*>(tile + c * kLane)[lane]);
        __syncwarp();
    }
}

// one chunk of CP planes: the launch (one warp a row), or with `shape` only
// its threads, blocks an SM (the occupancy query's) and grid
template <int CP>
int launch_planes(const uint32_t* cols, const int* idx, uint32_t* out, int rows,
                  long long stride, cudaStream_t stream, int* shape) {
    const long long blocks = ((long long)rows + kWarps - 1) / kWarps;
    if (shape) {
        int per_sm = 0;
        const cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, probe_take_rm_kernel<CP>, kThreads, 0);
        shape[0] = kThreads;
        shape[1] = per_sm;
        shape[2] = (int)blocks;
        return (int)rc;
    }
    probe_take_rm_kernel<CP><<<(unsigned)blocks, kThreads, 0, stream>>>(
        cols, idx, out, rows, (long long)rows * kLane, stride);
    return (int)cudaGetLastError();
}

int launch_chunk(int cp, const uint32_t* cols, const int* idx, uint32_t* out, int rows,
                 long long stride, cudaStream_t stream, int* shape) {
    switch (cp) {
#define P10_CASE(K) \
    case K: return launch_planes<K>(cols, idx, out, rows, stride, stream, shape);
        P10_CASE(1) P10_CASE(2) P10_CASE(3) P10_CASE(4) P10_CASE(5) P10_CASE(6) P10_CASE(7)
        P10_CASE(8) P10_CASE(9) P10_CASE(10) P10_CASE(11) P10_CASE(12) P10_CASE(13)
        P10_CASE(14) P10_CASE(15) P10_CASE(16)
#undef P10_CASE
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" int atray_probe_take_rm(const void* cols, const int* idx, void* out, int rows,
                                   int c_planes, void* stream) {
    if (rows <= 0 || c_planes <= 0) return 0;
    if (reinterpret_cast<uintptr_t>(idx) % 16 != 0) return (int)cudaErrorMisalignedAddress;
    const long long stride = (long long)c_planes * kLane;
    for (int c0 = 0; c0 < c_planes; c0 += kMaxPlanes) {
        const int cp = c_planes - c0 < kMaxPlanes ? c_planes - c0 : kMaxPlanes;
        const int rc = launch_chunk(cp, static_cast<const uint32_t*>(cols) + (long long)c0 * kLane,
                                    idx, static_cast<uint32_t*>(out) + (long long)c0 * kLane,
                                    rows, stride, (cudaStream_t)stream, nullptr);
        if (rc != 0) return rc;
    }
    return 0;
}

// shape[0..2]: threads, blocks an SM and grid of the instance that takes
// min(c_planes, 16) planes at ``rows`` rows
extern "C" int atray_probe_take_rm_shape(int rows, int c_planes, int* shape) {
    if (rows <= 0 || c_planes <= 0) return (int)cudaErrorInvalidValue;
    const int cp = c_planes < kMaxPlanes ? c_planes : kMaxPlanes;
    return launch_chunk(cp, nullptr, nullptr, nullptr, rows, 0, nullptr, shape);
}
