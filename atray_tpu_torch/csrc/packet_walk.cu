// Nearest triangle hit (t, u, v, face id) over a TreePack by a coherent
// packet walk: one warp of 32 rays shares one node cursor over the skip
// links.
//
// Replaces atray_tpu/kernels/traverse_pallas.py::_traverse_kernel. The TPU
// kernel walks a block of 16x128 rays in lockstep with one scalar cursor
// and descends where any ray of the block enters the box with t_near < its
// best t; at a leaf it tests every record against the whole block. Here the
// bundle is a warp:
//   any live lane hits the box (slab test, t_near < best_t) -> __any_sync;
//   interior node hit  -> node + 1;
//   leaf hit           -> every lane tests the leaf's leaf_size records
//                         (broadcast loads), then the miss link;
//   no lane hits       -> the miss link; a link below 0 ends the walk.
// Lanes past the end of the rays (the ragged last warp) vote false, which
// replaces the TPU kernel's padding with far rays.
//
// Tables (accel/pack.py): nodebox (6, K) f32, ctrl (2, K) i32 (miss link,
// leaf row or -1), leaf rows of 128 floats with 8 stride-16 records. Node
// boxes are finite, so fminf/fmaxf are safe in the slab.
//
// What bounds it: the lockstep union. A warp visits every node any of its
// rays enters, so incoherent rays pay for the union of 32 walks, and every
// lane tests every record of a hit leaf; dependent node loads (one per
// step, broadcast to the warp) set the latency of a step.

#include "lineage.cuh"

using namespace lineage;

namespace {

__global__ void packet_walk_kernel(
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
    const float idx = inv_dir(r.dx), idy = inv_dir(r.dy), idz = inv_dir(r.dz);
    const long long k = num_nodes;

    Hit h;
    unsigned long long nodes = 0, records = 0;
    int node = 0;
    while (node >= 0) {
        ++nodes;
        const float tx0 = (nodebox[node] - r.ox) * idx;
        const float tx1 = (nodebox[3 * k + node] - r.ox) * idx;
        const float ty0 = (nodebox[k + node] - r.oy) * idy;
        const float ty1 = (nodebox[4 * k + node] - r.oy) * idy;
        const float tz0 = (nodebox[2 * k + node] - r.oz) * idz;
        const float tz1 = (nodebox[5 * k + node] - r.oz) * idz;
        const float t_near = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
        const float t_far = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
        const bool bhit = live && t_near <= t_far && t_far > 0.0f && t_near < h.t;
        const bool any = __any_sync(kFull, bhit);
        const int miss = ctrl[node];
        const int leaf_row = ctrl[k + node];
        if (any && leaf_row >= 0) {
            leaf_test(tris, tris_i, leaf_row, leaf_size, r, h);
            records += leaf_size;
        }
        node = (any && leaf_row < 0) ? node + 1 : miss;
    }
    if (live) store_hit(h, i, t_out, u_out, v_out, id_out);
    add_stats(stats, lane, base, n, nodes, records);
}

}  // namespace

// Launches on ``stream``; ``stats`` (2 int64, or null) gains the visit
// counts. Returns cudaGetLastError() of the launch.
extern "C" int atray_packet_walk(
    const float* orig, const float* dirn, long long n,
    const float* nodebox, const int* ctrl, int num_nodes,
    const float* tris, int leaf_size,
    float* t_out, float* u_out, float* v_out, int* id_out,
    unsigned long long* stats, void* stream) {
    if (n <= 0) return 0;
    const int threads = 128;
    const long long blocks = (n + threads - 1) / threads;
    packet_walk_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        orig, dirn, n, nodebox, ctrl, num_nodes,
        tris, reinterpret_cast<const int*>(tris), leaf_size,
        t_out, u_out, v_out, id_out, stats);
    return (int)cudaGetLastError();
}
