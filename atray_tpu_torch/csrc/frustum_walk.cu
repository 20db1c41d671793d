// Nearest triangle hit (t, u, v, face id) over a TreePack by the frustum
// walk: the bundle's interval bounds walk the skip links warp-uniformly,
// overlapping leaves queue up, and a flush of 8 tests them against every
// lane.
//
// Replaces atray_tpu/kernels/frustum_pallas.py::_frustum_kernel. The TPU
// kernel summarizes a block of 1024 rays once by interval bounds (12
// reductions), walks the skip links on the scalar unit with the interval
// slab test of the bundle against each node box bounded by [0, tmax],
// queues overlapping leaves with their entry bound tlo (LEAF_BATCH = 8),
// and at a flush re-checks tlo <= tmax and tests each queued leaf's records
// against the block, then sets tmax = max(best_t). Here the bundle is a
// warp of 32 rays:
//   - the 12 bounds are warp shuffles over the live lanes (lineage.cuh),
//     so every lane computes the walk's scalars identically;
//   - the queue of 8 (leaf row, tlo) lives in registers, entry q in lane q,
//     and a flush reads it back with __shfl_sync;
//   - tmax is the warp max of best_t over the live lanes after each flush.
// The re-check tlo <= tmax never drops a leaf (tmax changes only at a
// flush, which empties the queue); it is kept as the reference has it.
//
// Tables as in packet_walk.cu. NaN: see or_fill in lineage.cuh.
//
// What bounds it: the interval test of a bundle is looser than any of its
// rays' own slab tests. A coherent warp (neighbouring primaries) culls
// nearly as well as one ray; an incoherent one (bounce rays) passes nearly
// every box and tests every leaf's records on all 32 lanes, so its work is
// leaves x records x 32 ray-triangle tests.

#include "lineage.cuh"

using namespace lineage;

namespace {

constexpr int kLeafBatch = 8;

__global__ void frustum_walk_kernel(
    const float* __restrict__ orig, const float* __restrict__ dirn, long long n,
    const float* __restrict__ nodebox, const int* __restrict__ ctrl, int num_nodes,
    const float* __restrict__ tris, const int* __restrict__ tris_i, int leaf_size,
    float* __restrict__ t_out, float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ id_out, unsigned long long* __restrict__ stats) {
    const long long base = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / kWarp * kWarp;
    if (base >= n) return;                       // the whole warp is past the end
    const int lane = threadIdx.x % kWarp;
    const long long i = base + lane;
    const bool live = i < n;
    const Ray r = load_ray(orig, dirn, i, live);
    const Bundle b = bundle_setup(r, live);
    const long long k = num_nodes;
    const float neg_inf = __int_as_float(0xff800000);

    Hit h;
    unsigned long long nodes = 0, records = 0;
    float tmax = kInf;
    int q_row = 0;          // this lane's queue entry (lane q holds entry q)
    float q_tlo = 0.0f;
    int cnt = 0;
    int node = 0;
    while (node >= 0) {
        ++nodes;
        float tlo, hi3;
        box_bounds(b, nodebox[node], nodebox[k + node], nodebox[2 * k + node],
                   nodebox[3 * k + node], nodebox[4 * k + node], nodebox[5 * k + node],
                   tlo, hi3);
        const bool overlap = tlo <= fminf(hi3, tmax);
        const int miss = ctrl[node];
        const int leaf_row = ctrl[k + node];
        if (overlap && leaf_row >= 0) {
            if (lane == cnt) {
                q_row = leaf_row;
                q_tlo = tlo;
            }
            ++cnt;
        }
        const int nxt = (overlap && leaf_row < 0) ? node + 1 : miss;
        if (cnt >= kLeafBatch || (nxt < 0 && cnt > 0)) {
            for (int q = 0; q < cnt; ++q) {
                const int row = __shfl_sync(kFull, q_row, q);
                const float qt = __shfl_sync(kFull, q_tlo, q);
                if (qt <= tmax) {
                    leaf_test(tris, tris_i, row, leaf_size, r, h);
                    records += leaf_size;
                }
            }
            tmax = warp_max(live ? h.t : neg_inf);
            cnt = 0;
        }
        node = nxt;
    }
    if (live) store_hit(h, i, t_out, u_out, v_out, id_out);
    add_stats(stats, lane, base, n, nodes, records);
}

}  // namespace

// Launches on ``stream``; ``stats`` (2 int64, or null) gains the visit
// counts. Returns cudaGetLastError() of the launch.
extern "C" int atray_frustum_walk(
    const float* orig, const float* dirn, long long n,
    const float* nodebox, const int* ctrl, int num_nodes,
    const float* tris, int leaf_size,
    float* t_out, float* u_out, float* v_out, int* id_out,
    unsigned long long* stats, void* stream) {
    if (n <= 0) return 0;
    const int threads = 128;
    const long long blocks = (n + threads - 1) / threads;
    frustum_walk_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        orig, dirn, n, nodebox, ctrl, num_nodes,
        tris, reinterpret_cast<const int*>(tris), leaf_size,
        t_out, u_out, v_out, id_out, stats);
    return (int)cudaGetLastError();
}
