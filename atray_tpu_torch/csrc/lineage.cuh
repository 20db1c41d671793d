// Shared device code of the four lineage walks (packet_walk.cu,
// frustum_walk.cu, wide_frustum.cu, persistent_wide.cu): the bundle (one
// warp of 32 consecutive rays), its interval bounds, the slab test and the
// leaf record test.
//
// Numerics follow the plain versions (kernels/_plain.py) op for op; the
// library is built with --fmad=false and no fast-math or flush-to-zero
// (face ids ride the f32 leaf rows as denormal bit patterns), so every
// operation is the IEEE op of the plain version and the two agree bit for
// bit.
//
// Lanes whose ray index is >= n are dead: they load no ray and take part
// in no vote, bound or result. They stay in the loops, so every
// __*_sync below runs with the full mask.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lineage {

constexpr float kInf = 3.0e38f;      // miss distance and the interval test's infinite bound
constexpr float kTMin = 1.0e-4f;
constexpr float kBig = 1.0e30f;      // 1/d of a zero direction component
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;

struct Ray {
    float ox, oy, oz, dx, dy, dz;
};

struct Hit {
    float t = kInf, u = 0.0f, v = 0.0f;
    int id = -1;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ orig,
                                        const float* __restrict__ dirn, long long i, bool live) {
    Ray r{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (live) {
        r.ox = orig[3 * i];
        r.oy = orig[3 * i + 1];
        r.oz = orig[3 * i + 2];
        r.dx = dirn[3 * i];
        r.dy = dirn[3 * i + 1];
        r.dz = dirn[3 * i + 2];
    }
    return r;
}

__device__ __forceinline__ void store_hit(const Hit& h, long long i, float* t_out,
                                          float* u_out, float* v_out, int* id_out) {
    t_out[i] = h.t;
    u_out[i] = h.u;
    v_out[i] = h.v;
    id_out[i] = h.id;
}

__device__ __forceinline__ float inv_dir(float d) {
    return d == 0.0f ? kBig : 1.0f / d;
}

// One-sided Moller-Trumbore (det > 1e-12) of one stride-16 record [p0, e1,
// e2, face id bits] against one ray, ppacket.cu's op order; the running
// best takes the record on a strict t < best.t.
__device__ __forceinline__ void record_test(const float* __restrict__ rec,
                                            const int* __restrict__ rec_i, const Ray& r,
                                            Hit& h) {
    const float e2x = rec[6], e2y = rec[7], e2z = rec[8];
    const float e1x = rec[3], e1y = rec[4], e1z = rec[5];
    const float pvx = r.dy * e2z - r.dz * e2y;
    const float pvy = r.dz * e2x - r.dx * e2z;
    const float pvz = r.dx * e2y - r.dy * e2x;
    const float det = e1x * pvx + e1y * pvy + e1z * pvz;
    if (!(det > 1.0e-12f)) return;
    const float inv_det = 1.0f / det;
    const float tvx = r.ox - rec[0];
    const float tvy = r.oy - rec[1];
    const float tvz = r.oz - rec[2];
    const float uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
    const float qvx = tvy * e1z - tvz * e1y;
    const float qvy = tvz * e1x - tvx * e1z;
    const float qvz = tvx * e1y - tvy * e1x;
    const float vv = (r.dx * qvx + r.dy * qvy + r.dz * qvz) * inv_det;
    const float tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
    if (uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f && tt > kTMin && tt < h.t) {
        h.t = tt;
        h.u = uu;
        h.v = vv;
        h.id = rec_i[9];
    }
}

// Every record of the leaf starting at ``leaf_row`` (8 records a row; a
// leaf of 16 spans two rows), in record order. All lanes read the same
// addresses, so each load is a broadcast.
__device__ __forceinline__ void leaf_test(const float* __restrict__ tris,
                                          const int* __restrict__ tris_i, int leaf_row,
                                          int leaf_size, const Ray& r, Hit& h) {
    const long long base = (long long)leaf_row * 128;
    for (int k = 0; k < leaf_size; ++k) {
        record_test(tris + base + 16 * k, tris_i + base + 16 * k, r, h);
    }
}

// The same leaf test over a leaf's records read as 16-byte words (each
// record [p0.xyz e1.x | e1.yz e2.xy | e2.z id pad pad | pad], 4 float4s),
// from global memory (kGlobal) or from a shared-memory copy. Records go two
// at a time: both dets first, then u, and v and t only where u is in [0, 1]
// (u > 1 with v >= 0 makes u + v > 1: no hit either way). Each record's
// IEEE operations are record_test's, in its order, and the running best
// takes records in record order with a strict t < best.t, so the result is
// record_test's bit for bit.
template <bool kGlobal>
__device__ __forceinline__ void leaf_test_pairs(const float4* __restrict__ rec, int leaf_size,
                                                const Ray& r, Hit& h) {
    for (int k0 = 0; k0 < leaf_size; k0 += 2) {
        float4 V[2][3];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                V[j][c] = kGlobal ? __ldg(rec + 4 * (k0 + j) + c) : rec[4 * (k0 + j) + c];
            }
        }
        float pv[2][3], det[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            const float e2x = V[j][1].z, e2y = V[j][1].w, e2z = V[j][2].x;
            const float e1x = V[j][0].w, e1y = V[j][1].x, e1z = V[j][1].y;
            pv[j][0] = r.dy * e2z - r.dz * e2y;
            pv[j][1] = r.dz * e2x - r.dx * e2z;
            pv[j][2] = r.dx * e2y - r.dy * e2x;
            det[j] = e1x * pv[j][0] + e1y * pv[j][1] + e1z * pv[j][2];
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            // one-sided; past an odd leaf_size the second record is not the leaf's
            if (!(det[j] > 1.0e-12f) || k0 + j >= leaf_size) continue;
            const float e2x = V[j][1].z, e2y = V[j][1].w, e2z = V[j][2].x;
            const float e1x = V[j][0].w, e1y = V[j][1].x, e1z = V[j][1].y;
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
            if (uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f && tt > kTMin && tt < h.t) {
                h.t = tt;
                h.u = uu;
                h.v = vv;
                h.id = __float_as_int(V[j][2].y);
            }
        }
    }
}

__device__ __forceinline__ float warp_min(float x) {
    for (int s = kWarp / 2; s > 0; s >>= 1) x = fminf(x, __shfl_xor_sync(kFull, x, s));
    return x;
}

__device__ __forceinline__ float warp_max(float x) {
    for (int s = kWarp / 2; s > 0; s >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, s));
    return x;
}

// The bundle's interval bounds: origin box [ol, oh] and direction box
// [dl, dh] per axis over the live lanes (12 warp reductions), with the
// selectors and safe reciprocals of frustum_pallas.py:78-83. Every lane
// holds the same values, so the walk below is warp-uniform.
struct Bundle {
    float ol[3], oh[3], idl[3], idh[3];
    bool dl_pos[3], dl_neg[3], dh_pos[3], dh_neg[3];
};

__device__ __forceinline__ Bundle bundle_setup(const Ray& r, bool live) {
    const float inf = __int_as_float(0x7f800000);
    const float o[3] = {r.ox, r.oy, r.oz};
    const float d[3] = {r.dx, r.dy, r.dz};
    Bundle b;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        b.ol[a] = warp_min(live ? o[a] : inf);
        b.oh[a] = warp_max(live ? o[a] : -inf);
        const float dl = warp_min(live ? d[a] : inf);
        const float dh = warp_max(live ? d[a] : -inf);
        b.dl_pos[a] = dl > 0.0f;
        b.dl_neg[a] = dl < 0.0f;
        b.dh_pos[a] = dh > 0.0f;
        b.dh_neg[a] = dh < 0.0f;
        b.idl[a] = dl != 0.0f ? 1.0f / dl : 0.0f;
        b.idh[a] = dh != 0.0f ? 1.0f / dh : 0.0f;
    }
    return b;
}

// NaN hazard: c * (1/d) is NaN where c == 0 and 1/d overflowed (a denormal
// direction bound). The reference's jnp.maximum/minimum would carry the
// NaN into the overlap test and cull a box that a ray of the bundle can
// hit. Here a NaN bound is no constraint (-kInf for a lower bound, kInf
// for an upper one), chosen before any max/min, so the test stays
// conservative and fminf/fmaxf (which drop NaN) see none.
__device__ __forceinline__ float or_fill(float x, float fill) {
    return x != x ? fill : x;
}

// t-interval of axis ``a`` in which [ol + t*dl, oh + t*dh] can meet the slab
// [bl, bh]: constraint 1, ol + t*dl <= bh, and constraint 2, oh + t*dh >=
// bl, each a bound chosen by the sign of its direction bound
// (frustum_pallas.py:89-101; _plain.axis_t_bounds).
__device__ __forceinline__ void axis_t_bounds(const Bundle& b, int a, float bl, float bh,
                                              float& lo, float& hi) {
    const float c1 = bh - b.ol[a];
    const float ub1 = b.dl_pos[a] ? or_fill(c1 * b.idl[a], kInf)
                                  : (b.dl_neg[a] ? kInf : (c1 >= 0.0f ? kInf : -kInf));
    const float lb1 = b.dl_neg[a] ? or_fill(c1 * b.idl[a], -kInf) : -kInf;
    const float c2 = bl - b.oh[a];
    const float lb2 = b.dh_pos[a] ? or_fill(c2 * b.idh[a], -kInf)
                                  : (b.dh_neg[a] ? -kInf : (c2 <= 0.0f ? -kInf : kInf));
    const float ub2 = b.dh_neg[a] ? or_fill(c2 * b.idh[a], kInf) : kInf;
    lo = fmaxf(lb1, lb2);
    hi = fminf(ub1, ub2);
}

// Entry bound tlo and the min of the three axis upper bounds of one box.
__device__ __forceinline__ void box_bounds(const Bundle& b, float lx, float ly, float lz,
                                           float hx, float hy, float hz, float& tlo,
                                           float& hix_hiy_hiz) {
    float lox, hix, loy, hiy, loz, hiz;
    axis_t_bounds(b, 0, lx, hx, lox, hix);
    axis_t_bounds(b, 1, ly, hy, loy, hiy);
    axis_t_bounds(b, 2, lz, hz, loz, hiz);
    tlo = fmaxf(fmaxf(lox, loy), fmaxf(loz, 0.0f));
    hix_hiy_hiz = fminf(fminf(hix, hiy), hiz);
}

// Visit counts of one warp, added to ``stats`` (when given) as the plain
// versions count them: node visits and records tested per live ray.
__device__ __forceinline__ void add_stats(unsigned long long* stats, int lane, long long base,
                                          long long n, unsigned long long nodes,
                                          unsigned long long records) {
    if (stats != nullptr && lane == 0) {
        const unsigned long long live = (unsigned long long)(n - base < kWarp ? n - base : kWarp);
        atomicAdd(stats, nodes * live);
        atomicAdd(stats + 1, records * live);
    }
}

}  // namespace lineage
