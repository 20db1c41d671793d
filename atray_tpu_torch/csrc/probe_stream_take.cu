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
// Design: a producer warp and eight consumer warps a block, five blocks an
// SM, each block a ring of two stages with a full and an empty mbarrier
// each (probe.cuh).
// - Block b takes output rows b, b + grid, ... (the live rows of a packed
//   map are a prefix, so they spread over every SM).
// - The producer reads a row's index words (one 16-byte load a lane; the
//   next row's are in flight meanwhile), finds the span of source rows its
//   live lanes read with a warp min/max (no block barrier), and fills the
//   next free stage: the index words and the unit's description, then one
//   bulk copy (cp.async.bulk) per plane of the span, as many planes as fit
//   a stage of kCap = 40 plane-rows (20 KiB), issued by as many lanes and
//   counted in by expect-tx. A row wider than a stage is gathered from
//   device memory directly (so the take is exact on any map), and a row
//   with no live lane takes no copy: its unit only tells the consumers to
//   store zeros.
// - The consumers wait on a stage's full barrier, gather (or zero) four
//   lanes of one plane a thread from shared memory into one 16-byte store,
//   and release the stage on its empty barrier. No block-wide barrier sits
//   in the loop.
// PERF.md (the P11 ladder) has the other shapes: units of 2, 4 and 8
// consecutive rows sharing a stage (fewer bytes staged, no faster), the
// index words prefetched into L2, 3 and 4 stages, stages of 32-96
// plane-rows (more blocks an SM ran faster down to 40), 4 and 6 consumer
// warps.
//
// Modes: 0 full (checked); 1 nocopy, the TPU's nodma: no copy is issued or
// waited for and the gather reads stale shared memory (timing only);
// 2 nocompute: the copies run, nothing is gathered or stored (the output
// stays as the caller made it; timing only).
//
// What bounds it: device-memory bytes. The function needs the index (4 N),
// the C words of each live lane and the output (4 C N); staging reads every
// word of the spans (for a packed map nearly all of cols), which the probe
// sets against that need and beside the bytes this design moves.

#include <climits>

#include <cuda_runtime.h>
#include <stdint.h>

#include "probe.cuh"

namespace {

constexpr int kLane = 128;
constexpr int kCap = 40;                        // plane-rows a stage holds
constexpr int kStages = 2;                      // a block's; five blocks fit an SM
constexpr int kConsumers = 8;                   // consumer warps
constexpr int kThreads = 32 * (kConsumers + 1);

enum Mode { kFull = 0, kNoCopy = 1, kNoCompute = 2 };

// What a stage holds: output row j, planes [p0, p1), and u source rows
// from w0 of each plane (u = 0: nothing staged; live lanes are then read
// from device memory); end marks the last unit.
struct Unit {
    int j, p0, p1, w0, u, end;
};

// A stage: the staged rows, the row's index words, the unit.
constexpr int kStageWords = kCap * kLane + kLane + 8;

__device__ __forceinline__ int* stage_idx(uint32_t* stage) {
    return reinterpret_cast<int*>(stage + kCap * kLane);
}

__device__ __forceinline__ Unit* stage_unit(uint32_t* stage) {
    return reinterpret_cast<Unit*>(stage + kCap * kLane + kLane);
}

// The producer warp's ring position: waits for a free stage, and hands the
// filled one on.
struct Ring {
    uint32_t* smem;
    uint64_t* full;
    uint64_t* empty;
    int st = 0;
    uint32_t ph = 0;
    long long used = 0;

    __device__ uint32_t* acquire() {
        if (used >= kStages) mbar_wait(&empty[st], ph ^ 1u);
        return smem + st * kStageWords;
    }

    __device__ void advance() {
        ++used;
        if (++st == kStages) {
            st = 0;
            ph ^= 1u;
        }
    }
};

// Producer lanes: one unit into the next stage; words are this lane's four
// index words of the unit's row.
__device__ __forceinline__ void put_unit(Ring& ring, const uint32_t* __restrict__ cols, int rows,
                                         int lane, int4 words, const Unit& u, bool copy) {
    uint32_t* stage = ring.acquire();
    reinterpret_cast<int4*>(stage_idx(stage))[lane] = words;
    if (lane == 0) *stage_unit(stage) = u;
    __syncwarp();
    const bool copies = copy && u.u > 0;
    const uint32_t bytes = (uint32_t)u.u * kLane * 4;
    if (lane == 0) {
        if (copies) {
            mbar_expect_tx(&ring.full[ring.st], bytes * (uint32_t)(u.p1 - u.p0));
        } else {
            mbar_arrive(&ring.full[ring.st]);
        }
    }
    for (int p = lane; copies && p < u.p1 - u.p0; p += 32)
        bulk_g2s(stage + p * u.u * kLane, cols + ((long long)(u.p0 + p) * rows + u.w0) * kLane,
                 bytes, &ring.full[ring.st]);
    ring.advance();
}

__device__ __forceinline__ int4 load_words(const int* __restrict__ idx, int j, int lane) {
    return __ldg(reinterpret_cast<const int4*>(idx + (long long)j * kLane) + lane);
}

__device__ void produce(const uint32_t* __restrict__ cols, const int* __restrict__ idx, int rows,
                        int c, bool copy, Ring& ring, int lane) {
    const long long n = (long long)rows * kLane;
    int4 cur = load_words(idx, blockIdx.x, lane), nxt = cur;
    for (int j = blockIdx.x; j < rows; j += gridDim.x) {
        if (j + (int)gridDim.x < rows) nxt = load_words(idx, j + gridDim.x, lane);
        int lo = INT_MAX, hi = -1;
        const int s[4] = {cur.x, cur.y, cur.z, cur.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            if (s[e] >= 0 && (long long)s[e] < n) {
                lo = min(lo, s[e] >> 7);
                hi = max(hi, s[e] >> 7);
            }
        }
#pragma unroll
        for (int o = 16; o; o >>= 1) {
            lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
            hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
        }
        // the span if it fits a stage (as many planes a unit as fit), else
        // none: zeros, or the row gathered directly, one unit of every plane
        const int span = hi >= 0 ? hi - lo + 1 : 0;
        const int u = span <= kCap ? span : 0;
        const int np = u > 0 ? min(c, kCap / u) : c;
        for (int p0 = 0; p0 < c; p0 += np)
            put_unit(ring, cols, rows, lane, cur, Unit{j, p0, min(c, p0 + np), u > 0 ? lo : 0, u, 0},
                     copy);
        cur = nxt;
    }
    uint32_t* stage = ring.acquire();
    if (lane == 0) {
        stage_unit(stage)->end = 1;
        mbar_arrive(&ring.full[ring.st]);
    }
    ring.advance();
}

// Consumer threads: the units in ring order until the last.
__device__ void consume(const uint32_t* __restrict__ cols, uint32_t* __restrict__ out, int rows,
                        bool compute, uint32_t* smem, uint64_t* full, uint64_t* empty, int tid) {
    const long long n = (long long)rows * kLane;
    int st = 0;
    uint32_t ph = 0;
    while (true) {
        mbar_wait(&full[st], ph);
        uint32_t* stage = smem + st * kStageWords;
        const Unit u = *stage_unit(stage);
        if (u.end) break;
        if (compute) {
            const int* widx = stage_idx(stage);
            for (int it = tid; it < (u.p1 - u.p0) * (kLane / 4); it += 32 * kConsumers) {
                const int pi = it / (kLane / 4), g = it % (kLane / 4), p = u.p0 + pi;
                const int4 s4 = reinterpret_cast<const int4*>(widx)[g];
                const int s[4] = {s4.x, s4.y, s4.z, s4.w};
                uint32_t v[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const bool ok = s[e] >= 0 && (long long)s[e] < n;
                    v[e] = !ok       ? 0u
                           : u.u > 0 ? stage[(pi * u.u + (s[e] >> 7) - u.w0) * kLane + (s[e] & 127)]
                                     : __ldg(cols + p * n + s[e]);
                }
                *reinterpret_cast<uint4*>(out + p * n + (long long)u.j * kLane + 4 * g) =
                    make_uint4(v[0], v[1], v[2], v[3]);
            }
        }
        __syncwarp();
        if ((tid & 31) == 0) mbar_arrive(&empty[st]);
        if (++st == kStages) {
            st = 0;
            ph ^= 1u;
        }
    }
}

__global__ void __launch_bounds__(kThreads, 1)
    probe_stream_take_kernel(const uint32_t* __restrict__ cols, const int* __restrict__ idx,
                             uint32_t* __restrict__ out, int rows, int c, int mode) {
    extern __shared__ __align__(128) uint32_t take_smem[];
    uint64_t* full = reinterpret_cast<uint64_t*>(take_smem + kStages * kStageWords);
    uint64_t* empty = full + kStages;
    const int tid = threadIdx.x, w = tid >> 5;
    if (tid == 0) {
        for (int s = 0; s < kStages; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], kConsumers);
        }
        fence_mbar_init();
    }
    __syncthreads();
    if (w == kConsumers) {
        Ring ring{take_smem, full, empty};
        produce(cols, idx, rows, c, mode != kNoCopy, ring, tid & 31);
    } else {
        consume(cols, out, rows, mode != kNoCompute, take_smem, full, empty, tid);
    }
}

constexpr int kSmem = kStages * kStageWords * 4 + 2 * kStages * 8;

}  // namespace

// cols, out: (c_planes, rows, 128) 32-bit words, 16-byte aligned; idx:
// (rows * 128,) i32; mode 0 full, 1 nocopy, 2 nocompute. Launches on
// ``stream``; returns cudaGetLastError() of the launch.
extern "C" int atray_probe_stream_take(const void* cols, const int* idx, void* out, int rows,
                                       int c_planes, int mode, void* stream) {
    if (rows <= 0 || c_planes <= 0) return 0;
    if (mode < kFull || mode > kNoCompute) return (int)cudaErrorInvalidValue;
    if (((uintptr_t)cols | (uintptr_t)idx | (uintptr_t)out) % 16)
        return (int)cudaErrorMisalignedAddress;           // bulk copies and 16-byte accesses
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = allow_smem(probe_stream_take_kernel, kSmem);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, probe_stream_take_kernel,
                                                            kThreads, kSmem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = min(rows, sms * max(per_sm, 1));
    probe_stream_take_kernel<<<blocks, kThreads, kSmem, (cudaStream_t)stream>>>(
        static_cast<const uint32_t*>(cols), idx, static_cast<uint32_t*>(out), rows, c_planes, mode);
    return (int)cudaGetLastError();
}

// The launch shape: threads a block, dynamic shared memory in bytes, stages
// and plane-rows a stage, into shape[0..3].
extern "C" int atray_probe_stream_take_shape(int* shape) {
    shape[0] = kThreads;
    shape[1] = kSmem;
    shape[2] = kStages;
    shape[3] = kCap;
    return 0;
}
