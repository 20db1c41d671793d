// Nearest triangle hit (t, u, v, face id) over an unshaded WideBVH, one
// thread per ray.
//
// Replaces atray_tpu/kernels/wide_exact.py::_wide_exact_kernel and
// atray_tpu/kernels/wide_exact2.py::_wide_exact2_kernel. Both TPU kernels
// compute this one function: a block of 8x128 rays walks the 8-wide tree in
// lockstep, each ray's 8 child-box hit bits OR-reduced into one block mask
// per node (one vector->scalar sync per eight children), and the second
// kernel interleaves two blocks to hide those syncs. Neither the lockstep
// nor the interleave has a purpose on a GPU, so this kernel walks per ray:
// its own stack, its own exact child mask.
//
// Tables (accel/wide.py): cboxes (W, 128) f32 with field f of child c at
// lane 8f + c; clinks (8, W) i32 (>= 0 node, -(leaf_row + 1) leaf, INT32_MIN
// empty); leaf rows of 128 floats holding 8 stride-16 records
// [p0, e1, e2, face id as int bits, pad] (accel/pack.py).
//
// Order (that of the TPU kernels, per ray): pop a node, test its 8 child
// boxes against best_t as it stood at the pop, then for c = 0..7 push an
// interior child or test a leaf child at once. Strict t < best_t, so among
// equal t the first record tested wins.
//
// Hazards kept from wide_shade.cu: one-sided Moller-Trumbore (det > 1e-12);
// 1e30 for zero direction components (0 * inf would be NaN in the slab);
// empty slots guarded by the link, because their inverted boxes pass every
// slab test; face ids read as int bits (denormal floats); built with
// --fmad=false and no fast-math or flush-to-zero, so each operation is the
// IEEE op of the plain version (wide_exact_ref) in the same order.
//
// What bounds it: dependent loads, as in wide_shade.cu. Each step reads a
// cboxes row or a leaf (up to 16 records of 64 B) whose address comes from
// the previous load; at 139k triangles the tables fit the 50 MB L2
// (chip_smoke.py prints their size). The design keeps ray state in
// registers and the stack in local memory and relies on many resident
// warps to hide the latency.

#include <cuda_runtime.h>
#include <stdint.h>

#define ATRAY_EXACT_STACK_CAP 128

namespace {

constexpr float kInf = 3.0e38f;
constexpr float kTMin = 1.0e-4f;
constexpr float kBig = 1.0e30f;

__device__ __forceinline__ float inv_dir(float d) {
    return d == 0.0f ? kBig : 1.0f / d;
}

__global__ void wide_exact_kernel(
    const float* __restrict__ orig,     // (n, 3)
    const float* __restrict__ dirn,     // (n, 3)
    long long n,
    const float* __restrict__ cboxes,   // (W, 128)
    const int* __restrict__ clinks,     // (8, W)
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

    float best_t = kInf, best_u = 0.0f, best_v = 0.0f;
    int best_id = -1;

    int stack[ATRAY_EXACT_STACK_CAP];
    int sp = 0;
    stack[sp++] = 0;
    while (sp > 0) {
        const int node = stack[--sp];
        const float* row = cboxes + (long long)node * 128;
        unsigned mask = 0u;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
            float tx0 = (row[c] - rox) * idx;
            float tx1 = (row[24 + c] - rox) * idx;
            float ty0 = (row[8 + c] - roy) * idy;
            float ty1 = (row[32 + c] - roy) * idy;
            float tz0 = (row[16 + c] - roz) * idz;
            float tz1 = (row[40 + c] - roz) * idz;
            float t_near = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                                 fminf(tz0, tz1));
            float t_far = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                                fmaxf(tz0, tz1));
            if (t_near <= t_far && t_far > 0.0f && t_near < best_t) mask |= 1u << c;
        }
        for (int c = 0; c < 8; ++c) {
            if (!((mask >> c) & 1u)) continue;
            const int link = clinks[(long long)c * num_nodes + node];
            if (link >= 0) {
                if (sp < ATRAY_EXACT_STACK_CAP) stack[sp++] = link;
                continue;
            }
            if (link <= -2147483647) continue;   // empty slot: INT32_MIN
            const long long base = (long long)(-(link + 1)) * 128;
            for (int k = 0; k < leaf_size; ++k) {
                const float* rec = tris + base + 16 * k;
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
                    best_id = tris_i[base + 16 * k + 9];
                }
            }
        }
    }
    t_out[i] = best_t;
    u_out[i] = best_u;
    v_out[i] = best_v;
    id_out[i] = best_id;
}

}  // namespace

extern "C" int atray_wide_exact_stack_cap() { return ATRAY_EXACT_STACK_CAP; }

// Launches on ``stream``; returns cudaGetLastError() of the launch.
extern "C" int atray_wide_exact(
    const float* orig, const float* dirn, long long n,
    const float* cboxes, const int* clinks, int num_nodes,
    const float* tris, int leaf_size,
    float* t_out, float* u_out, float* v_out, int* id_out, void* stream) {
    if (n <= 0) return 0;
    const int threads = 128;
    const long long blocks = (n + threads - 1) / threads;
    wide_exact_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        orig, dirn, n, cboxes, clinks, num_nodes,
        tris, reinterpret_cast<const int*>(tris), leaf_size,
        t_out, u_out, v_out, id_out);
    return (int)cudaGetLastError();
}
