// Nearest triangle hit (t, u, v, face id) over a TreePack, one thread per
// ray, stackless over the skip links.
//
// Replaces atray_tpu/kernels/persistent_packet.py::_ppacket_kernel. The TPU
// kernel walks a block of 8x128 rays in lockstep with one scalar node
// cursor, descending where ANY ray of the block enters the box with
// t_near < its best t, so every ray sees a superset of its own nodes and
// keeps the same nearest hit. Here each ray walks only its own nodes:
//   hit at an interior node -> node + 1;
//   hit at a leaf           -> test its leaf_size stride-16 records, then
//                              follow the miss link;
//   miss                    -> follow the miss link;
//   a link below 0 ends the walk.
// The hit test is (t_near <= t_far) & (t_far > 0) & (t_near < best_t).
//
// Tables (accel/pack.py): nodebox (6, K) f32 (min x, y, z, max x, y, z),
// ctrl (2, K) i32 (miss link, leaf row or -1), leaf rows of 128 floats with
// 8 records [p0, e1, e2, face id as int bits, pad]. Node boxes are finite,
// so fminf/fmaxf are safe in the slab.
//
// Numerics: the TPU kernel's op order, one-sided Moller-Trumbore
// (det > 1e-12), 1e30 for zero direction components, strict t < best_t (the
// first of equal hits in record order wins); built with --fmad=false and no
// fast-math or flush-to-zero, so each operation is the IEEE op of the plain
// version (ppacket_ref).
//
// What bounds it: dependent loads. Every step reads one node (six floats in
// six planes and two links) whose index comes from the step before; the
// slice's tables (about 10 MB at 139k triangles, leaf_size 8) stay in L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 3.0e38f;
constexpr float kTMin = 1.0e-4f;
constexpr float kBig = 1.0e30f;

__device__ __forceinline__ float inv_dir(float d) {
    return d == 0.0f ? kBig : 1.0f / d;
}

__global__ void ppacket_kernel(
    const float* __restrict__ orig,     // (n, 3)
    const float* __restrict__ dirn,     // (n, 3)
    long long n,
    const float* __restrict__ nodebox,  // (6, K)
    const int* __restrict__ ctrl,       // (2, K)
    int num_nodes,
    const float* __restrict__ tris,     // stride-16 records
    const int* __restrict__ tris_i,     // the same memory, int view
    int leaf_size,
    float* __restrict__ t_out, float* __restrict__ u_out,
    float* __restrict__ v_out, int* __restrict__ id_out) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float rox = orig[3 * i], roy = orig[3 * i + 1], roz = orig[3 * i + 2];
    const float rdx = dirn[3 * i], rdy = dirn[3 * i + 1], rdz = dirn[3 * i + 2];
    const float idx = inv_dir(rdx), idy = inv_dir(rdy), idz = inv_dir(rdz);
    const long long k = num_nodes;

    float best_t = kInf, best_u = 0.0f, best_v = 0.0f;
    int best_id = -1;
    int node = 0;
    while (node >= 0) {
        const float tx0 = (nodebox[node] - rox) * idx;
        const float tx1 = (nodebox[3 * k + node] - rox) * idx;
        const float ty0 = (nodebox[k + node] - roy) * idy;
        const float ty1 = (nodebox[4 * k + node] - roy) * idy;
        const float tz0 = (nodebox[2 * k + node] - roz) * idz;
        const float tz1 = (nodebox[5 * k + node] - roz) * idz;
        const float t_near = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                                   fminf(tz0, tz1));
        const float t_far = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                                  fmaxf(tz0, tz1));
        const bool bhit = t_near <= t_far && t_far > 0.0f && t_near < best_t;
        const int miss = ctrl[node];
        const int leaf_row = ctrl[k + node];
        if (bhit && leaf_row >= 0) {
            const long long base = (long long)leaf_row * 128;
            for (int r = 0; r < leaf_size; ++r) {
                const float* rec = tris + base + 16 * r;
                const float e2x = rec[6], e2y = rec[7], e2z = rec[8];
                const float e1x = rec[3], e1y = rec[4], e1z = rec[5];
                const float pvx = rdy * e2z - rdz * e2y;
                const float pvy = rdz * e2x - rdx * e2z;
                const float pvz = rdx * e2y - rdy * e2x;
                const float det = e1x * pvx + e1y * pvy + e1z * pvz;
                if (!(det > 1.0e-12f)) continue;   // one-sided test
                const float inv_det = 1.0f / det;
                const float tvx = rox - rec[0];
                const float tvy = roy - rec[1];
                const float tvz = roz - rec[2];
                const float uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
                const float qvx = tvy * e1z - tvz * e1y;
                const float qvy = tvz * e1x - tvx * e1z;
                const float qvz = tvx * e1y - tvy * e1x;
                const float vv = (rdx * qvx + rdy * qvy + rdz * qvz) * inv_det;
                const float tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
                if (uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f &&
                    tt > kTMin && tt < best_t) {
                    best_t = tt;
                    best_u = uu;
                    best_v = vv;
                    best_id = tris_i[base + 16 * r + 9];
                }
            }
        }
        node = (bhit && leaf_row < 0) ? node + 1 : miss;
    }
    t_out[i] = best_t;
    u_out[i] = best_u;
    v_out[i] = best_v;
    id_out[i] = best_id;
}

}  // namespace

// Launches on ``stream``; returns cudaGetLastError() of the launch.
extern "C" int atray_ppacket(
    const float* orig, const float* dirn, long long n,
    const float* nodebox, const int* ctrl, int num_nodes,
    const float* tris, int leaf_size,
    float* t_out, float* u_out, float* v_out, int* id_out, void* stream) {
    if (n <= 0) return 0;
    const int threads = 128;
    const long long blocks = (n + threads - 1) / threads;
    ppacket_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        orig, dirn, n, nodebox, ctrl, num_nodes,
        tris, reinterpret_cast<const int*>(tris), leaf_size,
        t_out, u_out, v_out, id_out);
    return (int)cudaGetLastError();
}
