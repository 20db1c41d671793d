// Pair-binned traversal, Phase B: the nearest hit of each (ray, treelet)
// pair among that treelet's records, with shading data, one thread per pair.
//
// Replaces atray_tpu/kernels/treelet_pairs.py::_phase_b_kernel. The TPU
// kernel streams every treelet of a 1024-pair block's [min tid, max tid]
// range and lets a lane accept hits only from its own treelet, a lockstep
// device; per pair it computes exactly this: the records of the pair's own
// treelet, leaves_per_treelet leaves of leaf_size records, tested in record
// order with a strict t < best_t.
//
// Numerics are those of wide_shade.cu, so a winning hit is bit-identical to
// the walk's: one-sided Moller-Trumbore (det > 1e-12) in the same op order,
// the barycentric normal w0 n0 + u n1 + v n2 (w0 = 1 - u - v) normalized
// once with rsqrtf(fmaxf(n.n, 1e-20)), face ids read as int bits; built
// with --fmad=false and no fast-math or flush-to-zero. A dead slot (tid < 0)
// gives the miss sentinel (3e38, -1, 0, 0, 0, 0).
//
// What bounds it: instruction issue, and the branches that skip it. A
// record's det takes 15 float instructions, a front-facing record's
// divide and u 12 more, and v, t and the hit test where u is in [0, 1]
// 26 more (chip_smoke.py counts these for its bound). The pairs
// arrive sorted by treelet (bin_pairs), so a warp's lanes mostly test the
// same record with rays that enter the treelet alike: whole warps skip a
// record that faces away or lies outside u in [0, 1] (pad records at a
// leaf's end have det 0). Any ptid order and dead slots anywhere are still
// right, only slower. So:
//   - records are tested in groups of four: e1, e2 and p0 of the group come
//     first, from the leaf planes cleaves (accel/shaded.py::leaf_planes; a
//     treelet's leaves are consecutive leaf slots, slot tid *
//     leaves_per_treelet + leaf), one 16-byte load a float, 9 loads for
//     four records; then every record's det, then each front-facing one's
//     divide and u, and v and t only where u is in [0, 1] (u > 1 with
//     v >= 0 makes u + v > 1: no hit either way);
//   - the loop keeps only the winner's record, u and v; its face id, its
//     normals and its material are read from the stride-32 records once
//     after the loop and blended in the same op order as a win in the walk.
// The leaf planes and the stride-32 records measured the same in this
// loop, and groups of four and 128 threads measured fastest (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 3.0e38f;
constexpr float kTMin = 1.0e-4f;
constexpr int kThreads = 128;     // threads a block, one pair each
constexpr int kGroup = 4;         // records a load round: one float4 a plane

struct Best {
    float t = kInf, u = 0.0f, v = 0.0f;
    long long rec = -1;   // float4 offset of the winner's record in recs
};

// Floats q0 .. q0 + n - 1 (0-2 p0, 3-5 e1, 6-8 e2) of records k .. k + 3 of
// leaf slot `slot` into f[q][j], one 16-byte load from the planes a float.
template <int n>
__device__ __forceinline__ void load_group(float (&f)[n][kGroup], int q0,
                                           const float* __restrict__ planes, long long slot,
                                           int rpl, int k) {
#pragma unroll
    for (int q = 0; q < n; ++q) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(
            planes + (slot * 9 + q0 + q) * rpl * 4 + k));
        f[q][0] = v.x;
        f[q][1] = v.y;
        f[q][2] = v.z;
        f[q][3] = v.w;
    }
}

__global__ void __launch_bounds__(kThreads) treelet_phase_b_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const int* __restrict__ ptid, long long n,
    const float* __restrict__ planes,    // accel/shaded.py::leaf_planes
    const float* __restrict__ recs,      // the stride-32 shaded records
    int leaf_size, int leaves_per_treelet,
    float* __restrict__ t_out, int* __restrict__ id_out,
    float* __restrict__ nx_out, float* __restrict__ ny_out,
    float* __restrict__ nz_out, int* __restrict__ mat_out) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int tid = ptid[i];
    Best best;
    if (tid >= 0) {
        const float rox = ox[i], roy = oy[i], roz = oz[i];
        const float rdx = dx[i], rdy = dy[i], rdz = dz[i];
        // a leaf slot holds rpl rows of 4 records; plane q of slot s holds
        // float q of its 4 rpl records at planes + (s * 9 + q) * 4 rpl
        const int rpl = leaf_size <= 4 ? 1 : leaf_size / 4;
        const long long slot0 = (long long)tid * leaves_per_treelet;
        for (int leaf = 0; leaf < leaves_per_treelet; ++leaf) {
            const long long slot = slot0 + leaf;
            for (int k0 = 0; k0 < leaf_size; k0 += kGroup) {
                float E[6][kGroup];   // e1 x, y, z, e2 x, y, z
                load_group<6>(E, 3, planes, slot, rpl, k0);
                float pv[kGroup][3], det[kGroup];
                unsigned front = 0u;
#pragma unroll
                for (int j = 0; j < kGroup; ++j) {
                    pv[j][0] = rdy * E[5][j] - rdz * E[4][j];
                    pv[j][1] = rdz * E[3][j] - rdx * E[5][j];
                    pv[j][2] = rdx * E[4][j] - rdy * E[3][j];
                    det[j] = E[0][j] * pv[j][0] + E[1][j] * pv[j][1] + E[2][j] * pv[j][2];
                    // one-sided; past leaf_size (< 4) the row holds pad records
                    if (det[j] > 1.0e-12f && k0 + j < leaf_size) front |= 1u << j;
                }
                float P[3][kGroup];   // p0 x, y, z
                load_group<3>(P, 0, planes, slot, rpl, k0);
#pragma unroll
                for (int j = 0; j < kGroup; ++j) {
                    if (!((front >> j) & 1u)) continue;
                    const float tvx = rox - P[0][j];
                    const float tvy = roy - P[1][j];
                    const float tvz = roz - P[2][j];
                    const float inv_det = 1.0f / det[j];
                    const float uu = (tvx * pv[j][0] + tvy * pv[j][1] + tvz * pv[j][2]) * inv_det;
                    if (!(uu >= 0.0f && uu <= 1.0f)) continue;
                    const float qvx = tvy * E[2][j] - tvz * E[1][j];
                    const float qvy = tvz * E[0][j] - tvx * E[2][j];
                    const float qvz = tvx * E[1][j] - tvy * E[0][j];
                    const float vv = (rdx * qvx + rdy * qvy + rdz * qvz) * inv_det;
                    const float tt = (E[3][j] * qvx + E[4][j] * qvy + E[5][j] * qvz) * inv_det;
                    if (uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f && tt > kTMin &&
                        tt < best.t) {
                        best.t = tt;
                        best.u = uu;
                        best.v = vv;
                        best.rec = slot * rpl * 32 + 8 * (k0 + j);
                    }
                }
            }
        }
    }
    float bnx = 0.0f, bny = 0.0f, bnz = 0.0f, bmat = 0.0f;
    int best_id = -1;
    if (best.rec >= 0) {
        // floats 8-19 of the winner's stride-32 record: e2z, the id bits,
        // n0, n1, n2 (xyz each), the material
        const float4* rec = reinterpret_cast<const float4*>(recs) + best.rec;
        const float4 f8 = __ldg(rec + 2);
        const float4 f12 = __ldg(rec + 3);
        const float4 f16 = __ldg(rec + 4);
        const float w0 = 1.0f - best.u - best.v;
        best_id = __float_as_int(f8.y);
        bnx = w0 * f8.z + best.u * f12.y + best.v * f16.x;
        bny = w0 * f8.w + best.u * f12.z + best.v * f16.y;
        bnz = w0 * f12.x + best.u * f12.w + best.v * f16.z;
        bmat = f16.w;
    }
    const float rlen = rsqrtf(fmaxf(bnx * bnx + bny * bny + bnz * bnz, 1.0e-20f));
    t_out[i] = best.t;
    id_out[i] = best_id;
    nx_out[i] = bnx * rlen;
    ny_out[i] = bny * rlen;
    nz_out[i] = bnz * rlen;
    mat_out[i] = (int)bmat;
}

}  // namespace

// Launches on ``stream``; returns cudaGetLastError() of the launch.
// ``leaves`` is the accel's cleaves table, ``tris`` its shaded records.
extern "C" int atray_treelet_phase_b(
    const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz,
    const int* ptid, long long n, const float* leaves, const float* tris,
    int leaf_size, int leaves_per_treelet,
    float* t_out, int* id_out, float* nx_out, float* ny_out, float* nz_out,
    int* mat_out, void* stream) {
    if (n <= 0) return 0;
    const long long blocks = (n + kThreads - 1) / kThreads;
    treelet_phase_b_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        ox, oy, oz, dx, dy, dz, ptid, n, leaves, tris, leaf_size, leaves_per_treelet,
        t_out, id_out, nx_out, ny_out, nz_out, mat_out);
    return (int)cudaGetLastError();
}
