// Fused nearest hit + shading data over a ShadedWideBVH, one thread per ray.
//
// Replaces atray_tpu/kernels/wide_shade.py::_wide_shade_kernel. The TPU
// kernel walks blocks of 8x128 rays in lockstep (a block-wide union of
// node visits, a scalar-core stack, pair interleaving, multi-pop); this
// kernel computes the same function per ray instead: each thread walks the
// 8-wide tree with its own stack and tests leaves with one-sided
// Moller-Trumbore on the stride-32 shaded records (accel/shaded.py).
//
// What bounds it: dependent loads. Every step is a cboxes row (8 child
// boxes, 192 B used) or a 16-record leaf (2 KB) whose address comes from
// the previous load, so the walk is latency-bound through L1/L2, not by
// bandwidth or arithmetic. At the slice's 139k triangles the tables hold
// 27.7 MB (chip_smoke.py prints the size), which fits the H100's 50 MB L2
// and stays resident across a bounce. The design
// keeps per-ray state in registers, the stack in local memory (L1), and
// relies on many resident warps to hide the load latency.
//
// Numerics: built with --fmad=false and no fast-math, so every operation
// is the IEEE op of the plain PyTorch version (wide_shade_planes_ref) in
// the same order; face ids are read as int bits, never through float math
// (they are denormals; a flushing flag would zero them).
//
// Order: children of a node are stored sorted by centroid along
// caxis[node]; they are visited from index 7 down to 0 when the ray's own
// direction along that axis is positive (so the near child is pushed last
// and popped first), 0 up to 7 otherwise. Leaves are tested in that visit
// order, interior children pushed. The 8 child boxes are tested against
// best_t as it stood when the node was popped.

#include <cuda_runtime.h>
#include <stdint.h>

#define ATRAY_STACK_CAP 128

namespace {

constexpr float kInf = 3.0e38f;
constexpr float kTMin = 1.0e-4f;
constexpr float kBig = 1.0e30f;

__device__ __forceinline__ float inv_dir(float d) {
    // zero components give 1e30, not inf: 0 * inf would be NaN in the slab
    return d == 0.0f ? kBig : 1.0f / d;
}

__global__ void wide_shade_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const bool* __restrict__ alive, long long n,
    const float* __restrict__ cboxes,   // (W, 128)
    const int* __restrict__ clinks,     // (8, W)
    const int* __restrict__ caxis,      // (W,)
    int num_nodes,
    const float* __restrict__ tris,     // stride-32 records
    const int* __restrict__ tris_i,     // the same memory, int view
    int leaf_size,
    float* __restrict__ t_out, int* __restrict__ id_out,
    float* __restrict__ nx_out, float* __restrict__ ny_out,
    float* __restrict__ nz_out, int* __restrict__ mat_out) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    if (!alive[i]) {
        t_out[i] = kInf;
        id_out[i] = -1;
        nx_out[i] = 0.0f;
        ny_out[i] = 0.0f;
        nz_out[i] = 0.0f;
        mat_out[i] = 0;
        return;
    }
    const float rox = ox[i], roy = oy[i], roz = oz[i];
    const float rdx = dx[i], rdy = dy[i], rdz = dz[i];
    const float idx = inv_dir(rdx), idy = inv_dir(rdy), idz = inv_dir(rdz);

    float best_t = kInf;
    int best_id = -1;
    float bnx = 0.0f, bny = 0.0f, bnz = 0.0f, bmat = 0.0f;

    int stack[ATRAY_STACK_CAP];
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
            if (t_near <= fminf(t_far, best_t) && t_far > 0.0f) mask |= 1u << c;
        }
        const int axis = caxis[node];
        const float da = axis == 0 ? rdx : (axis == 1 ? rdy : rdz);
        const int d7 = da > 0.0f ? 7 : 0;
        for (int cc = 0; cc < 8; ++cc) {
            const int c = cc ^ d7;
            if (!((mask >> c) & 1u)) continue;
            const int link = clinks[(long long)c * num_nodes + node];
            if (link >= 0) {
                if (sp < ATRAY_STACK_CAP) stack[sp++] = link;
                continue;
            }
            if (link <= -2147483647) continue;   // empty slot: INT32_MIN
            const long long base = (long long)(-(link + 1)) * 128;
            for (int k = 0; k < leaf_size; ++k) {
                const float* rec = tris + base + 32 * k;
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
                    const float w0 = 1.0f - uu - vv;
                    best_t = tt;
                    best_id = tris_i[base + 32 * k + 9];
                    bnx = w0 * rec[10] + uu * rec[13] + vv * rec[16];
                    bny = w0 * rec[11] + uu * rec[14] + vv * rec[17];
                    bnz = w0 * rec[12] + uu * rec[15] + vv * rec[18];
                    bmat = rec[19];
                }
            }
        }
    }
    // normalize once at write-out; misses keep zero normals
    const float rlen = rsqrtf(fmaxf(bnx * bnx + bny * bny + bnz * bnz, 1.0e-20f));
    t_out[i] = best_t;
    id_out[i] = best_id;
    nx_out[i] = bnx * rlen;
    ny_out[i] = bny * rlen;
    nz_out[i] = bnz * rlen;
    mat_out[i] = (int)bmat;
}

}  // namespace

extern "C" int atray_wide_shade_stack_cap() { return ATRAY_STACK_CAP; }

// Launches on ``stream``; returns cudaGetLastError() of the launch.
extern "C" int atray_wide_shade(
    const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz,
    const bool* alive, long long n,
    const float* cboxes, const int* clinks, const int* caxis, int num_nodes,
    const float* tris, int leaf_size,
    float* t_out, int* id_out, float* nx_out, float* ny_out, float* nz_out,
    int* mat_out, void* stream) {
    if (n <= 0) return 0;
    const int threads = 128;
    const long long blocks = (n + threads - 1) / threads;
    wide_shade_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        ox, oy, oz, dx, dy, dz, alive, n, cboxes, clinks, caxis, num_nodes,
        tris, reinterpret_cast<const int*>(tris), leaf_size,
        t_out, id_out, nx_out, ny_out, nz_out, mat_out);
    return (int)cudaGetLastError();
}
