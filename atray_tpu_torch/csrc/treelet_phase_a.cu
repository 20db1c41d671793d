// Pair-binned traversal, Phase A: each live ray's K nearest treelet
// candidates by box entry distance, one thread per ray.
//
// Replaces atray_tpu/kernels/treelet_pairs.py::_phase_a_kernel. The TPU
// kernel streams the packed treelet boxes past blocks of 8x128 rays and
// keeps K+1 slot planes in vector registers; here every thread streams the
// same boxes (warp-uniform addresses, served from L1) and keeps its K+1
// (entry distance, treelet id) slots in registers.
//
// Tables (accel/shaded.py): tboxes (t_rows, 128) f32, 8 treelets per row,
// field f (lo x, y, z, hi x, y, z) of lane c at 8f + c; treelet id = 8r + c.
// Empty treelets and row-pad lanes are NaN. The slab test therefore uses
// NaN-propagating min/max (nmin/nmax below, like jnp.minimum and
// torch.minimum): with fminf/fmaxf a NaN box would turn into an
// everything-box and every pad lane would become a candidate at distance 0.
//
// Slots: the reference's insertion network. Candidates stream in tid
// order into K+1 slots sorted by entry distance; a candidate takes the
// first slot whose distance is strictly larger, and the entry it displaces
// moves on down by the same rule. The slots hold the K+1 smallest
// distances; among equal ones the ids are those the reference keeps.
// tids (K, n) receive the first K slots (-1 = none) and bound (n,) the
// (K+1)-th entry distance (3e38 = none). Dead rays get no candidates.
//
// What bounds it: operations. Each (ray, treelet) test is about 45 float
// ops (slab, clamp and a usually skipped insertion) against 24 B of box
// that every thread of the warp reads at once; with K+1 slots in registers
// nothing but the ray's planes and outputs touches device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 3.0e38f;
constexpr float kBig = 1.0e30f;
constexpr int kMaxK = 8;

__device__ __forceinline__ float inv_dir(float d) {
    return d == 0.0f ? kBig : 1.0f / d;
}

// NaN in either operand gives NaN, as jnp.minimum / torch.minimum do
__device__ __forceinline__ float nmin(float a, float b) {
    return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float nmax(float a, float b) {
    return (a > b || a != a) ? a : b;
}

template <int K>
__global__ void treelet_phase_a_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const bool* __restrict__ alive, long long n,
    const float* __restrict__ tboxes, int t_rows,
    int* __restrict__ tids, float* __restrict__ bound) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float te[K + 1];
    int tid[K + 1];
#pragma unroll
    for (int k = 0; k <= K; ++k) {
        te[k] = kInf;
        tid[k] = -1;
    }
    if (alive[i]) {
        const float rox = ox[i], roy = oy[i], roz = oz[i];
        const float idx = inv_dir(dx[i]), idy = inv_dir(dy[i]), idz = inv_dir(dz[i]);
        for (int r = 0; r < t_rows; ++r) {
            const float* row = tboxes + (long long)r * 128;
#pragma unroll
            for (int c = 0; c < 8; ++c) {
                const float tx0 = (row[c] - rox) * idx;
                const float tx1 = (row[24 + c] - rox) * idx;
                const float ty0 = (row[8 + c] - roy) * idy;
                const float ty1 = (row[32 + c] - roy) * idy;
                const float tz0 = (row[16 + c] - roz) * idz;
                const float tz1 = (row[40 + c] - roz) * idz;
                const float t_near = nmax(nmax(nmin(tx0, tx1), nmin(ty0, ty1)),
                                          nmin(tz0, tz1));
                const float t_far = nmin(nmin(nmax(tx0, tx1), nmax(ty0, ty1)),
                                         nmax(tz0, tz1));
                if (!(t_near <= t_far && t_far > 0.0f)) continue;
                float cte = nmax(t_near, 0.0f);
                // the slots are sorted: a candidate not below the last one
                // moves nothing
                if (!(cte < te[K])) continue;
                int ctid = 8 * r + c;
#pragma unroll
                for (int k = 0; k <= K; ++k) {
                    if (cte < te[k]) {
                        const float s = te[k];
                        const int st = tid[k];
                        te[k] = cte;
                        tid[k] = ctid;
                        cte = s;
                        ctid = st;
                    }
                }
            }
        }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) tids[(long long)k * n + i] = tid[k];
    bound[i] = te[K];
}

template <int K>
int launch(const float* ox, const float* oy, const float* oz,
           const float* dx, const float* dy, const float* dz,
           const bool* alive, long long n, const float* tboxes, int t_rows,
           int* tids, float* bound, cudaStream_t stream) {
    const int threads = 128;
    const long long blocks = (n + threads - 1) / threads;
    treelet_phase_a_kernel<K><<<(unsigned)blocks, threads, 0, stream>>>(
        ox, oy, oz, dx, dy, dz, alive, n, tboxes, t_rows, tids, bound);
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
