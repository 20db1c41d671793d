// Pair-binned traversal, Phase A: each live ray's K nearest treelet
// candidates by box entry distance.
//
// Replaces atray_tpu/kernels/treelet_pairs.py::_phase_a_kernel. The TPU
// kernel streams the packed treelet boxes past blocks of 8x128 rays and
// keeps K+1 slot planes in vector registers; here a block packs the live
// rays of its window, one ray a thread with its K+1 (entry distance,
// treelet id) slots in registers, and reads the boxes from shared-memory
// tiles.
//
// Tables (accel/shaded.py): tboxes (t_rows, 128) f32, 8 treelets per row,
// field f (lo x, y, z, hi x, y, z) of lane c at 8f + c; treelet id = 8r + c.
// Empty treelets and row-pad lanes are NaN. The kernel reads the accel's
// tboxes_ordered (ordered_boxes): each axis's lo and hi plane replaced by
// their NaN-propagating min and max, so every box is NaN or ordered. The
// slab test uses NaN-propagating min/max (nmin/nmax below, like
// jnp.minimum and torch.minimum): with fminf/fmaxf a NaN box would turn
// into an everything-box and every pad lane would become a candidate at
// distance 0.
//
// Slots: the reference's insertion network. Candidates stream in tid
// order into K+1 slots sorted by entry distance; a candidate takes the
// first slot whose distance is strictly larger, and the entry it displaces
// moves on down by the same rule. The slots hold the K+1 smallest
// distances; among equal ones the ids are those the reference keeps.
// tids (K, n) receive the first K slots (-1 = none) and bound (n,) the
// (K+1)-th entry distance (3e38 = none). Dead rays get no candidates.
//
// What bounds it: instruction issue. Every (live ray, treelet) pair is one
// slab test whose 6 subtractions and 6 multiplies are fixed by the
// bit-equality with the plain version (op order (box - o) * inv, built
// with --fmad=false). The design cuts everything around them:
//   - a block first packs the live rays of its window to a list in index
//     order, so no lane tests boxes for a dead ray (bounce rays are live
//     in scattered runs);
//   - the 48 used floats of each box row are staged in shared memory in
//     tiles of kTileRows rows (a scene with more rows takes several tiles);
//   - the near and far planes of an ordered box come by the signs of the
//     ray's inverse direction (its octant): the near plane of axis a is the
//     lo plane where inv[a] >= 0 and the hi plane otherwise. Rounding is
//     monotone, so for an ordered box that gives the plain version's
//     min/max pairs' distances, up to the sign of a zero distance, which no
//     test or slot can see; for a NaN box some distance is NaN on each
//     side, as with the pairs. 5 min/max a test where the pairs took 11;
//   - nmin/nmax are one min.NaN / max.NaN instruction each (sm_80 and
//     later), where the compare-and-select form took three;
//   - the hit test and the last-slot test are one compare;
//   - each ray reads its near and far fields of four treelets as 16-byte
//     vectors (field f of lanes 4h .. 4h + 3 is float4 2f + h of a row).
// Several rays a thread share no loads in the octant form and measured
// slower; 128 threads and 128-row tiles measured fastest (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 3.0e38f;
constexpr float kBig = 1.0e30f;
constexpr float kDenormMin = 1.4e-45f;        // the least float above 0
constexpr int kMaxK = 8;
constexpr int kThreads = 128;                 // threads a block, one ray each
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 128;                // box rows a shared-memory tile holds
constexpr int kRowVecs = 12;                  // float4s of a row's 48 used floats

__device__ __forceinline__ float inv_dir(float d) {
    return d == 0.0f ? kBig : 1.0f / d;
}

// NaN in either operand gives NaN, as jnp.minimum / torch.minimum do
__device__ __forceinline__ float nmin(float a, float b) {
    float r;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}

__device__ __forceinline__ float nmax(float a, float b) {
    float r;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}

__device__ __forceinline__ float lane_of(const float4& v, int k) {
    return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

struct Ray {
    float o[3], inv[3];
    int near[3];          // float4 offset in a row of the near plane's field, axis a
};

// The insertion network: the candidate takes the first slot whose distance
// is strictly larger, and the entry it displaces moves on down.
template <int K>
__device__ __forceinline__ void insert(float (&te)[K + 1], int (&tid)[K + 1], float cte,
                                       int ctid) {
#pragma unroll
    for (int k = 0; k <= K; ++k) {
        if (cte < te[k]) {
            const float sv = te[k];
            const int st = tid[k];
            te[k] = cte;
            tid[k] = ctid;
            cte = sv;
            ctid = st;
        }
    }
}

// Tests the staged rows [r0, r0 + rows) against the ray, in treelet order.
// A staged row's fields are the kRowVecs float4s at box + (r - r0) * kRowVecs:
// field f (lo x, y, z, hi x, y, z) of lanes 4h .. 4h + 3 at 2f + h.
template <int K>
__device__ __forceinline__ void test_rows(const Ray& s, float (&te)[K + 1], int (&tid)[K + 1],
                                          const float4* box, int r0, int rows) {
    for (int rr = 0; rr < rows; ++rr) {
        const float4* row = box + rr * kRowVecs;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            float4 nf[6];         // near x, y, z, far x, y, z fields of lanes 4h .. 4h + 3
#pragma unroll
            for (int a = 0; a < 3; ++a) {
                nf[a] = row[s.near[a] + h];
                nf[3 + a] = row[(s.near[a] + 6) % kRowVecs + h];
            }
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const float tn0 = (lane_of(nf[0], c) - s.o[0]) * s.inv[0];
                const float tf0 = (lane_of(nf[3], c) - s.o[0]) * s.inv[0];
                const float tn1 = (lane_of(nf[1], c) - s.o[1]) * s.inv[1];
                const float tf1 = (lane_of(nf[4], c) - s.o[1]) * s.inv[1];
                const float tn2 = (lane_of(nf[2], c) - s.o[2]) * s.inv[2];
                const float tf2 = (lane_of(nf[5], c) - s.o[2]) * s.inv[2];
                const float t_near = nmax(nmax(tn0, tn1), tn2);
                const float t_far = nmin(nmin(tf0, tf1), tf2);
                // a hit (t_near <= t_far, t_far > 0) whose clamped entry is
                // below the last slot: max(t_near, the least float) <= t_far
                // is the hit test exactly (NaN fails both), and <= te[K]
                // keeps every candidate of the strict test; the insertion
                // re-tests with the strict <, so a box let through by the
                // <= moves nothing
                if (nmax(t_near, kDenormMin) <= nmin(t_far, te[K]))
                    insert<K>(te, tid, nmax(t_near, 0.0f), 8 * (r0 + rr) + 4 * h + c);
            }
        }
    }
}

template <int K>
__global__ void __launch_bounds__(kThreads) treelet_phase_a_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const bool* __restrict__ alive, long long n,
    const float4* __restrict__ tboxes, int t_rows,
    int* __restrict__ tids, float* __restrict__ bound) {
    __shared__ int s_list[kThreads];              // window offsets of the live rays
    __shared__ int s_count[kWarps + 1];           // live rays of each warp, then offsets
    __shared__ float4 s_box[kTileRows * kRowVecs];
    const long long b0 = (long long)blockIdx.x * kThreads;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

    // 1. dead rays get the sentinel; the live rays are packed to a list in
    // index order
    const long long i = b0 + t;
    const bool in = i < n;
    const bool live = in && alive[i];
    if (in && !live) {
#pragma unroll
        for (int k = 0; k < K; ++k) tids[(long long)k * n + i] = -1;
        bound[i] = kInf;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, live);
    if (lane == 0) s_count[warp] = __popc(mask);
    __syncthreads();
    if (t == 0) {
        int sum = 0;
        for (int w = 0; w < kWarps; ++w) {
            const int c = s_count[w];
            s_count[w] = sum;
            sum += c;
        }
        s_count[kWarps] = sum;
    }
    __syncthreads();
    if (live) s_list[s_count[warp] + __popc(mask & ((1u << lane) - 1u))] = t;
    const int live_n = s_count[kWarps];
    if (live_n == 0) return;                     // block-uniform
    __syncthreads();

    // 2. thread t takes the t-th live ray and tests it against every box
    const long long ray = t < live_n ? b0 + s_list[t] : -1;
    const bool has = ray >= 0;
    Ray s;
    const float* org[3] = {ox, oy, oz};
    const float* dir[3] = {dx, dy, dz};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        s.o[a] = has ? org[a][ray] : 0.0f;
        s.inv[a] = has ? inv_dir(dir[a][ray]) : 0.0f;
        s.near[a] = s.inv[a] >= 0.0f ? 2 * a : 6 + 2 * a;
    }
    float te[K + 1];
    int tid[K + 1];
#pragma unroll
    for (int k = 0; k <= K; ++k) {
        te[k] = kInf;
        tid[k] = -1;
    }
    for (int r0 = 0; r0 < t_rows; r0 += kTileRows) {
        const int rows = min(kTileRows, t_rows - r0);
        if (r0 > 0) __syncthreads();             // the last tile is no longer read
        for (int q = t; q < rows * kRowVecs; q += kThreads)
            s_box[q] = __ldg(tboxes + (long long)(r0 + q / kRowVecs) * 32 + q % kRowVecs);
        __syncthreads();
        if (has) test_rows<K>(s, te, tid, s_box, r0, rows);
    }
    if (!has) return;
#pragma unroll
    for (int k = 0; k < K; ++k) tids[(long long)k * n + ray] = tid[k];
    bound[ray] = te[K];
}

template <int K>
int launch(const float* ox, const float* oy, const float* oz,
           const float* dx, const float* dy, const float* dz,
           const bool* alive, long long n, const float* tboxes, int t_rows,
           int* tids, float* bound, cudaStream_t stream) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    treelet_phase_a_kernel<K><<<(unsigned)blocks, kThreads, 0, stream>>>(
        ox, oy, oz, dx, dy, dz, alive, n, reinterpret_cast<const float4*>(tboxes), t_rows,
        tids, bound);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int atray_treelet_phase_a_max_k() { return kMaxK; }

// Launches on ``stream``; returns cudaGetLastError() of the launch
// (cudaErrorInvalidValue for k outside 1..kMaxK).
extern "C" int atray_treelet_phase_a(
    const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz,
    const bool* alive, long long n, const float* tboxes, int t_rows, int k,
    int* tids, float* bound, void* stream) {
    if (n <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    switch (k) {
        case 1: return launch<1>(ox, oy, oz, dx, dy, dz, alive, n, tboxes, t_rows, tids, bound, s);
        case 2: return launch<2>(ox, oy, oz, dx, dy, dz, alive, n, tboxes, t_rows, tids, bound, s);
        case 3: return launch<3>(ox, oy, oz, dx, dy, dz, alive, n, tboxes, t_rows, tids, bound, s);
        case 4: return launch<4>(ox, oy, oz, dx, dy, dz, alive, n, tboxes, t_rows, tids, bound, s);
        case 5: return launch<5>(ox, oy, oz, dx, dy, dz, alive, n, tboxes, t_rows, tids, bound, s);
        case 6: return launch<6>(ox, oy, oz, dx, dy, dz, alive, n, tboxes, t_rows, tids, bound, s);
        case 7: return launch<7>(ox, oy, oz, dx, dy, dz, alive, n, tboxes, t_rows, tids, bound, s);
        case 8: return launch<8>(ox, oy, oz, dx, dy, dz, alive, n, tboxes, t_rows, tids, bound, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
