// Pair-binned traversal, Phase B: the nearest hit of each (ray, treelet)
// pair among that treelet's records, with shading data, one thread per pair.
//
// Replaces atray_tpu/kernels/treelet_pairs.py::_phase_b_kernel. The TPU
// kernel streams every treelet of a 1024-pair block's [min tid, max tid]
// range and lets a lane accept hits only from its own treelet, a lockstep
// device; per pair it computes exactly this: the records of the pair's own
// treelet, leaves_per_treelet leaves of leaf_size stride-32 records
// (accel/shaded.py), tested in record order with a strict t < best_t.
//
// Numerics are those of wide_shade.cu, so a winning hit is bit-identical to
// the walk's: one-sided Moller-Trumbore (det > 1e-12) in the same op order,
// the barycentric normal normalized once with rsqrtf(fmaxf(n.n, 1e-20)),
// face ids read as int bits; built with --fmad=false and no fast-math or
// flush-to-zero. A dead slot (tid < 0) gives the miss sentinel
// (3e38, -1, 0, 0, 0, 0).
//
// What bounds it: operations, about 52 per record tested. The pairs arrive
// sorted by treelet, so a warp's threads mostly read the same records at
// the same time (broadcast loads), and the slice's 25 MB of records stay in
// the 50 MB L2 across the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 3.0e38f;
constexpr float kTMin = 1.0e-4f;

__global__ void treelet_phase_b_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const int* __restrict__ ptid, long long n,
    const float* __restrict__ tris, const int* __restrict__ tris_i,
    int leaf_size, int rows_per_leaf, int leaves_per_treelet,
    float* __restrict__ t_out, int* __restrict__ id_out,
    float* __restrict__ nx_out, float* __restrict__ ny_out,
    float* __restrict__ nz_out, int* __restrict__ mat_out) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int tid = ptid[i];
    float best_t = kInf;
    int best_id = -1;
    float bnx = 0.0f, bny = 0.0f, bnz = 0.0f, bmat = 0.0f;
    if (tid >= 0) {
        const float rox = ox[i], roy = oy[i], roz = oz[i];
        const float rdx = dx[i], rdy = dy[i], rdz = dz[i];
        const long long first_row = (long long)tid * rows_per_leaf * leaves_per_treelet;
        for (int leaf = 0; leaf < leaves_per_treelet; ++leaf) {
            const long long base = (first_row + (long long)leaf * rows_per_leaf) * 128;
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
    const float rlen = rsqrtf(fmaxf(bnx * bnx + bny * bny + bnz * bnz, 1.0e-20f));
    t_out[i] = best_t;
    id_out[i] = best_id;
    nx_out[i] = bnx * rlen;
    ny_out[i] = bny * rlen;
    nz_out[i] = bnz * rlen;
    mat_out[i] = (int)bmat;
}

}  // namespace

// Launches on ``stream``; returns cudaGetLastError() of the launch.
extern "C" int atray_treelet_phase_b(
    const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz,
    const int* ptid, long long n, const float* tris,
    int leaf_size, int rows_per_leaf, int leaves_per_treelet,
    float* t_out, int* id_out, float* nx_out, float* ny_out, float* nz_out,
    int* mat_out, void* stream) {
    if (n <= 0) return 0;
    const int threads = 128;
    const long long blocks = (n + threads - 1) / threads;
    treelet_phase_b_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        ox, oy, oz, dx, dy, dz, ptid, n, tris, reinterpret_cast<const int*>(tris),
        leaf_size, rows_per_leaf, leaves_per_treelet,
        t_out, id_out, nx_out, ny_out, nz_out, mat_out);
    return (int)cudaGetLastError();
}
