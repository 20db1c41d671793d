// Nearest triangle hit (t, u, v, face id) over a TreePack, one thread per
// ray, stackless over the skip links.
//
// Replaces atray_tpu/kernels/persistent_packet.py::_ppacket_kernel. The TPU
// kernel walks a block of 8x128 rays in lockstep with one scalar node
// cursor, descending where ANY ray of the block enters the box with
// t_near < its best t, so every ray sees a superset of its own nodes and
// keeps the same nearest hit. Here each ray walks only its own nodes:
//   hit at an interior node -> node + 1;
//   hit at a leaf           -> test its leaf_size records, then follow the
//                              miss link;
//   miss                    -> follow the miss link;
//   a link below 0 ends the walk.
// The hit test is (t_near <= t_far) & (t_far > 0) & (t_near < best_t).
//
// What bounds it: a warp's lanes walk apart. On the slice's bounce rays a
// lane does 14% of its warp's node steps and 10% of its leaf tests (the
// warp's mean over its max, PERF.md), so the warp issues the slab test and,
// above all, the 8-record leaf test for one or a few lanes at a time; every
// step also waits for a node whose index came out of the step before (L2:
// the slice's tables fit the H100's 50 MB). The design:
//   - a node is one 32-byte record of the derived table cnodes
//     (accel/pack.py::pack_node_records: lo xyz, hi xyz, miss link, leaf
//     row), read as two 16-byte loads from one sector, where nodebox and
//     ctrl spread the same 32 bytes over eight planes and eight sectors;
//   - while-while: a lane walks interior nodes until it enters a leaf or
//     its walk ends, and the leaves are tested when the warp's lanes have
//     all stopped, so a warp runs one leaf test for all its lanes that
//     entered one. Each ray still takes its own nodes in its own order,
//     each leaf tested before the next node (t_near < best_t sees the same
//     best_t), so the visits are those of the plain version;
//   - a leaf's records come from the stride-16 rows two at a time: their
//     p0, e1 and e2 first (three 16-byte loads a record), then both dets,
//     then each front-facing record's u, and v and t only where u is in
//     [0, 1] (u > 1 with v >= 0 makes u + v > 1: no hit either way);
//   - blocks of 64 threads with registers capped for 20 resident blocks an
//     SM (48 registers, a spill of a few words; 21 blocks, 42 warps, where
//     the 54 registers it takes uncapped allow 36 warps).
// Measured and dropped (PERF.md holds the ladder): leaf planes (cleaves),
// groups of 1 and 4, the full test per record, loading both next records
// (or only node + 1, or the miss record at a leaf) before the test,
// prefetching them to L1, tighter register caps (40 registers), 32- and
// 128-thread blocks, and persistent warps that refill finished lanes.
//
// Order (that of the TPU kernel and of the plain version ppacket_ref, per
// ray): the nodes in skip-link order; a leaf's records in record order,
// strict t < best_t, so the first of equal hits wins.
//
// Numerics: the TPU kernel's op order, one-sided Moller-Trumbore
// (det > 1e-12), 1e30 for zero direction components; built with
// --fmad=false and no fast-math or flush-to-zero, so each operation is the
// IEEE op of the plain version. Node boxes are finite, so fminf/fmaxf are
// safe in the slab. Face ids are int32 bits in word 9 of the stride-16
// records (denormal floats): read once, through the int view, after the
// walk.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 3.0e38f;
constexpr float kTMin = 1.0e-4f;
constexpr float kBig = 1.0e30f;
constexpr int kThreads = 64;       // threads a block
constexpr int kMinBlocks = 20;     // resident blocks an SM the registers must allow
constexpr int kGroup = 2;          // leaf records a load round

__device__ __forceinline__ float inv_dir(float d) {
    return d == 0.0f ? kBig : 1.0f / d;
}

struct Ray {
    float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

struct Best {
    float t = kInf, u = 0.0f, v = 0.0f;
    long long rec = -1;    // the winner's record, counted in stride-16 records
};

// Node `node` of cnodes: lo xyz, hi x | hi yz, miss link, leaf row.
__device__ __forceinline__ void load_node(const int4* __restrict__ nodes, int node, int4& a,
                                          int4& c) {
    a = __ldg(nodes + 2 * node);
    c = __ldg(nodes + 2 * node + 1);
}

__device__ __forceinline__ bool box_hit(const Ray& r, const int4& a, const int4& c,
                                        float best_t) {
    const float tx0 = (__int_as_float(a.x) - r.ox) * r.ix;
    const float tx1 = (__int_as_float(a.w) - r.ox) * r.ix;
    const float ty0 = (__int_as_float(a.y) - r.oy) * r.iy;
    const float ty1 = (__int_as_float(c.x) - r.oy) * r.iy;
    const float tz0 = (__int_as_float(a.z) - r.oz) * r.iz;
    const float tz1 = (__int_as_float(c.y) - r.oz) * r.iz;
    const float t_near = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
    const float t_far = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
    return t_near <= t_far && t_far > 0.0f && t_near < best_t;
}

// The leaf at stride-16 row `row`: record k is floats 16 k .. 16 k + 8 past
// the row's start (a leaf of more than 8 records spans consecutive rows).
__device__ __forceinline__ void test_leaf(const Ray& r, Best& b, const float4* __restrict__ tris4,
                                          long long row, int leaf_size) {
    const long long rec0 = row * 8;
    for (int k0 = 0; k0 < leaf_size; k0 += kGroup) {
        float4 V[kGroup][3];   // floats 0-11 of each record: p0, e1, e2, the id, pad
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
            const float4* q = tris4 + (rec0 + k0 + j) * 4;
            V[j][0] = __ldg(q);
            V[j][1] = __ldg(q + 1);
            V[j][2] = __ldg(q + 2);
        }
        float pv[kGroup][3], det[kGroup];
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
            const float e1x = V[j][0].w, e1y = V[j][1].x, e1z = V[j][1].y;
            const float e2x = V[j][1].z, e2y = V[j][1].w, e2z = V[j][2].x;
            pv[j][0] = r.dy * e2z - r.dz * e2y;
            pv[j][1] = r.dz * e2x - r.dx * e2z;
            pv[j][2] = r.dx * e2y - r.dy * e2x;
            det[j] = e1x * pv[j][0] + e1y * pv[j][1] + e1z * pv[j][2];
        }
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
            // one-sided; past an odd leaf_size the row holds a pad record
            if (!(det[j] > 1.0e-12f) || k0 + j >= leaf_size) continue;
            const float e1x = V[j][0].w, e1y = V[j][1].x, e1z = V[j][1].y;
            const float e2x = V[j][1].z, e2y = V[j][1].w, e2z = V[j][2].x;
            const float inv_det = 1.0f / det[j];
            const float tvx = r.ox - V[j][0].x;
            const float tvy = r.oy - V[j][0].y;
            const float tvz = r.oz - V[j][0].z;
            const float uu = (tvx * pv[j][0] + tvy * pv[j][1] + tvz * pv[j][2]) * inv_det;
            if (!(uu >= 0.0f && uu <= 1.0f)) continue;
            const float qvx = tvy * e1z - tvz * e1y;
            const float qvy = tvz * e1x - tvx * e1z;
            const float qvz = tvx * e1y - tvy * e1x;
            const float vv = (r.dx * qvx + r.dy * qvy + r.dz * qvz) * inv_det;
            const float tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
            if (uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f && tt > kTMin && tt < b.t) {
                b.t = tt;
                b.u = uu;
                b.v = vv;
                b.rec = rec0 + k0 + j;
            }
        }
    }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) ppacket_kernel(
    const float* __restrict__ orig,     // (n, 3)
    const float* __restrict__ dirn,     // (n, 3)
    long long n,
    const int4* __restrict__ nodes,     // accel/pack.py::pack_node_records, 2 int4 a node
    const float4* __restrict__ tris4,   // the stride-16 records
    int leaf_size,
    float* __restrict__ t_out, float* __restrict__ u_out,
    float* __restrict__ v_out, int* __restrict__ id_out) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    Ray r;
    r.ox = orig[3 * i];
    r.oy = orig[3 * i + 1];
    r.oz = orig[3 * i + 2];
    r.dx = dirn[3 * i];
    r.dy = dirn[3 * i + 1];
    r.dz = dirn[3 * i + 2];
    r.ix = inv_dir(r.dx);
    r.iy = inv_dir(r.dy);
    r.iz = inv_dir(r.dz);

    Best b;
    int node = 0;
    int4 a, c;
    load_node(nodes, node, a, c);
    while (true) {
        // interior nodes until this lane enters a leaf (c is then the
        // leaf's record) or its walk ends
        bool at_leaf = false;
        while (true) {
            const bool hit = box_hit(r, a, c, b.t);
            if (hit && c.w >= 0) {
                at_leaf = true;
                break;
            }
            if (!hit && c.z < 0) break;
            node = hit ? node + 1 : c.z;
            load_node(nodes, node, a, c);
        }
        if (!at_leaf) break;
        test_leaf(r, b, tris4, c.w, leaf_size);
        if (c.z < 0) break;
        node = c.z;
        load_node(nodes, node, a, c);
    }
    t_out[i] = b.t;
    u_out[i] = b.u;
    v_out[i] = b.v;
    id_out[i] = b.rec >= 0 ? __ldg(reinterpret_cast<const int*>(tris4) + b.rec * 16 + 9) : -1;
}

}  // namespace

// Launches on ``stream``; returns cudaGetLastError() of the launch.
// ``nodes`` is the pack's cnodes table, ``tris`` its stride-16 leaf records.
extern "C" int atray_ppacket(
    const float* orig, const float* dirn, long long n, const int* nodes, const float* tris,
    int leaf_size, float* t_out, float* u_out, float* v_out, int* id_out, void* stream) {
    if (n <= 0) return 0;
    const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
    ppacket_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        orig, dirn, n, reinterpret_cast<const int4*>(nodes), reinterpret_cast<const float4*>(tris),
        leaf_size, t_out, u_out, v_out, id_out);
    return (int)cudaGetLastError();
}
