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
// Tables (accel/pack.py): cnodes, one 32-byte record a node in DFS preorder
// (pack_node_records: lo xyz, hi xyz, miss link, leaf row or -1), read as
// two 16-byte loads of one sector where nodebox and ctrl spread it over
// eight planes; leaf rows of 128 floats with 8 stride-16 records, read as
// 16-byte words two records at a time (lineage.cuh's leaf_test_pairs: both
// dets first, v and t only where u is in [0, 1]). Node boxes are finite,
// so fminf/fmaxf are safe in the slab.
//
// What bounds it: the lockstep union. A warp visits every node any of its
// rays enters, so incoherent rays pay for the union of 32 walks, and every
// lane tests every record of a hit leaf; dependent node loads (one per
// step, broadcast to the warp) set the latency of a step.

#include "lineage.cuh"

using namespace lineage;

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) packet_walk_kernel(
    const float* __restrict__ orig, const float* __restrict__ dirn, long long n,
    const int4* __restrict__ nodes, const float4* __restrict__ tris4, int leaf_size,
    float* __restrict__ t_out, float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ id_out, unsigned long long* __restrict__ stats) {
    const long long base = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / kWarp * kWarp;
    if (base >= n) return;                       // the whole warp is past the end
    const int lane = threadIdx.x % kWarp;
    const long long i = base + lane;
    const bool live = i < n;
    const Ray r = load_ray(orig, dirn, i, live);
    const float idx = inv_dir(r.dx), idy = inv_dir(r.dy), idz = inv_dir(r.dz);

    Hit h;
    unsigned long long steps = 0, records = 0;
    int node = 0;
    while (node >= 0) {
        ++steps;
        const int4 a = __ldg(nodes + 2 * node);      // lo x, y, z, hi x
        const int4 c = __ldg(nodes + 2 * node + 1);  // hi y, z, miss link, leaf row
        const float tx0 = (__int_as_float(a.x) - r.ox) * idx;
        const float tx1 = (__int_as_float(a.w) - r.ox) * idx;
        const float ty0 = (__int_as_float(a.y) - r.oy) * idy;
        const float ty1 = (__int_as_float(c.x) - r.oy) * idy;
        const float tz0 = (__int_as_float(a.z) - r.oz) * idz;
        const float tz1 = (__int_as_float(c.y) - r.oz) * idz;
        const float t_near = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
        const float t_far = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
        const bool bhit = live && t_near <= t_far && t_far > 0.0f && t_near < h.t;
        const bool any = __any_sync(kFull, bhit);
        if (any && c.w >= 0) {
            leaf_test_pairs<true>(tris4 + (long long)c.w * 32, leaf_size, r, h);
            records += leaf_size;
        }
        node = (any && c.w < 0) ? node + 1 : c.z;
    }
    if (live) store_hit(h, i, t_out, u_out, v_out, id_out);
    add_stats(stats, lane, base, n, steps, records);
}

}  // namespace

// Launches on ``stream``; ``nodes`` is the pack's cnodes table, ``tris`` its
// stride-16 leaf records; ``stats`` (2 int64, or null) gains the visit
// counts. Returns cudaGetLastError() of the launch.
extern "C" int atray_packet_walk(
    const float* orig, const float* dirn, long long n, const int* nodes, const float* tris,
    int leaf_size, float* t_out, float* u_out, float* v_out, int* id_out,
    unsigned long long* stats, void* stream) {
    if (n <= 0) return 0;
    const long long blocks = (n + kThreads - 1) / kThreads;
    packet_walk_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        orig, dirn, n, reinterpret_cast<const int4*>(nodes),
        reinterpret_cast<const float4*>(tris), leaf_size,
        t_out, u_out, v_out, id_out, stats);
    return (int)cudaGetLastError();
}
