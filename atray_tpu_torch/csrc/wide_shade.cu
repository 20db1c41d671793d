// Fused nearest hit + shading data over a ShadedWideBVH, one thread per ray.
//
// Replaces atray_tpu/kernels/wide_shade.py::_wide_shade_kernel. The TPU
// kernel walks blocks of 8x128 rays in lockstep (a block-wide union of
// node visits, a scalar-core stack, pair interleaving, multi-pop); this
// kernel computes the same function per ray instead: each thread walks the
// 8-wide tree with its own stack and tests leaves with one-sided
// Moller-Trumbore against the leaf geometry.
//
// What bounds it: the latency of dependent loads. Every step reads a node
// record or a leaf whose address came out of the step before, from L2 (the
// tables of the slice's 139k triangles fit the H100's 50 MB L2), and a
// thread has nothing else to do while it waits; at the slice's sizes the
// walk sits 10-20x above both the byte and the operation bound (PERF.md).
// So the design cuts the load rounds a step waits on and the bytes each
// round moves, and keeps enough warps resident to cover the rest:
//   - a node is one 256-byte record of the derived table cnodes
//     (accel/shaded.py::node_records: 48 box floats, 8 links, the axis),
//     read as 16-byte vectors, where the cboxes/clinks/caxis tables cost
//     about 11 lines and one more dependent load per hit child's link;
//   - a leaf's p0, e1 and e2 come from the derived planes cleaves
//     (accel/shaded.py::leaf_planes, 576 bytes a 16-record leaf, where the
//     stride-32 records spread the same floats over 2 KB), four records'
//     copy of one float in one 16-byte vector; the face id, the normals and
//     the material are read from the shaded records only on a win;
//   - a node's interior children are pushed before its leaves are tested,
//     and the next node (the last child pushed, kept in a register, not on
//     the stack) is prefetched into L1 first, so its record arrives while
//     the leaves are tested;
//   - 7 resident blocks of 128 threads per SM (72 registers a thread): the
//     register cap that measured fastest; the stack stays in local memory.
// Measured and not kept (PERF.md): a stack top in shared memory (no
// change), persistent warps that refill finished lanes from a counter
// (slower but on full-width bounce rays: the lanes stop sharing node
// loads), prefetching the leaves too, 256-thread blocks.
//
// Stats (template parameter kStats): node_visits counts the nodes a ray
// popped, leaf_visits the leaves whose records it tested; the instantiation
// without stats carries no counter code.
//
// Numerics: built with --fmad=false and no fast-math, so every operation
// is the IEEE op of the plain PyTorch version (wide_shade_planes_ref) in
// the same order (the slab's near and far fold one axis at a time in the
// plain version's order); face ids are read as int bits, never through
// float math (they are denormals; a flushing flag would zero them).
//
// Order: children of a node are stored sorted by centroid along
// caxis[node]; they are visited from index 7 down to 0 when the ray's own
// direction along that axis is positive (so the near child is pushed last
// and popped first), 0 up to 7 otherwise. Interior children are pushed and
// leaves tested in that visit order; pushes and leaf tests do not depend
// on each other, because the 8 child boxes are tested against best_t as it
// stood when the node was popped. Empty slots are skipped by their
// INT32_MIN link, never by their boxes (pad boxes are NaN or inverted).

#include <cuda_runtime.h>
#include <stdint.h>

#define ATRAY_STACK_CAP 128

namespace {

constexpr float kInf = 3.0e38f;
constexpr float kTMin = 1.0e-4f;
constexpr float kBig = 1.0e30f;
constexpr int kThreads = 128;      // threads a block
constexpr int kMinBlocks = 7;      // resident blocks per SM the registers must allow
constexpr int kNodeVecs = 16;      // 16-byte vectors of one node record (64 words)
constexpr int kEmptyGuard = -2147483647;   // links <= this are empty slots

__device__ __forceinline__ float inv_dir(float d) {
    // zero components give 1e30, not inf: 0 * inf would be NaN in the slab
    return d == 0.0f ? kBig : 1.0f / d;
}

__device__ __forceinline__ float lane_of(const float4& v, int k) {
    return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

__device__ __forceinline__ int lane_of(const int4& v, int k) {
    return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

struct Walk {
    float ox, oy, oz, dx, dy, dz, ix, iy, iz;
    float best_t, bnx, bny, bnz, bmat;
    int best_id;
    int node;    // the node to pop next, -1 when the walk is over
    int sp;      // stack entries below it
    int nv, lv;  // node and leaf visits (stats)
};

struct Stack {   // in local memory: it is indexed by sp
    int slot[ATRAY_STACK_CAP];

    __device__ __forceinline__ void push(int& sp, int v) {
        // the wrapper checks 8 * (max_depth + 2) <= ATRAY_STACK_CAP
        if (sp < ATRAY_STACK_CAP) slot[sp++] = v;
    }
};

// Asks L1 for both lines of a node record that the walk pops next.
__device__ __forceinline__ void prefetch_node(const float4* __restrict__ nodes, int node) {
    const char* p = reinterpret_cast<const char*>(nodes + (long long)node * kNodeVecs);
    asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
    asm volatile("prefetch.global.L1 [%0];" ::"l"(p + 128));
}

// The leaf at row `row` of the shaded records: its records' p0, e1, e2
// from the planes (float p of records 4 g .. 4 g + 3 at float4
// row * 9 + p * rpl + g), in order; strict < keeps the first of equal t.
__device__ __forceinline__ void test_leaf(Walk& w, const float4* __restrict__ planes,
                                          const float4* __restrict__ recs, long long row,
                                          int leaf_size) {
    const int rpl = leaf_size <= 4 ? 1 : leaf_size / 4;
    const float4* lp = planes + row * 9;
    for (int g = 0; g < rpl; ++g) {
        float4 P[9];
#pragma unroll
        for (int q = 0; q < 9; ++q) P[q] = __ldg(lp + q * rpl + g);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int k = 4 * g + j;
            if (k >= leaf_size) break;
            const float p0x = lane_of(P[0], j), p0y = lane_of(P[1], j), p0z = lane_of(P[2], j);
            const float e1x = lane_of(P[3], j), e1y = lane_of(P[4], j), e1z = lane_of(P[5], j);
            const float e2x = lane_of(P[6], j), e2y = lane_of(P[7], j), e2z = lane_of(P[8], j);
            const float pvx = w.dy * e2z - w.dz * e2y;
            const float pvy = w.dz * e2x - w.dx * e2z;
            const float pvz = w.dx * e2y - w.dy * e2x;
            const float det = e1x * pvx + e1y * pvy + e1z * pvz;
            if (!(det > 1.0e-12f)) continue;   // one-sided test
            const float inv_det = 1.0f / det;
            const float tvx = w.ox - p0x;
            const float tvy = w.oy - p0y;
            const float tvz = w.oz - p0z;
            const float uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
            const float qvx = tvy * e1z - tvz * e1y;
            const float qvy = tvz * e1x - tvx * e1z;
            const float qvz = tvx * e1y - tvy * e1x;
            const float vv = (w.dx * qvx + w.dy * qvy + w.dz * qvz) * inv_det;
            const float tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
            if (uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f && tt > kTMin && tt < w.best_t) {
                // floats 8-19 of the stride-32 record: e2z, the id bits,
                // n0, n1, n2 (xyz each), the material
                const float4* rec = recs + row * 32 + 8 * k;
                const float4 f8 = __ldg(rec + 2);
                const float4 f12 = __ldg(rec + 3);
                const float4 f16 = __ldg(rec + 4);
                const float w0 = 1.0f - uu - vv;
                w.best_t = tt;
                w.best_id = __float_as_int(f8.y);
                w.bnx = w0 * f8.z + uu * f12.y + vv * f16.x;
                w.bny = w0 * f8.w + uu * f12.z + vv * f16.y;
                w.bnz = w0 * f12.x + uu * f12.w + vv * f16.z;
                w.bmat = f16.w;
            }
        }
    }
}

// Pops w.node: tests its 8 child boxes, pushes the interior children hit,
// prefetches the next node, tests the leaves hit, and moves to the next.
template <bool kStats>
__device__ __forceinline__ void step(Walk& w, Stack& st, const float4* __restrict__ nodes,
                                     const float4* __restrict__ recs,
                                     const float4* __restrict__ planes, int leaf_size) {
    const float4* rec = nodes + (long long)w.node * kNodeVecs;
    const int4 la = __ldg(reinterpret_cast<const int4*>(rec) + 12);   // links of children 0-3
    const int4 lb = __ldg(reinterpret_cast<const int4*>(rec) + 13);   // links of children 4-7
    const int axis = __ldg(reinterpret_cast<const int*>(rec) + 56);
    if (kStats) ++w.nv;
    // one axis at a time: field f (lo x, y, z, hi x, y, z) of child c is
    // word 8 f + c, lane c % 4 of vector 2 f + c / 4
    float t_near[8], t_far[8];
#pragma unroll
    for (int f = 0; f < 3; ++f) {
        const float o = f == 0 ? w.ox : (f == 1 ? w.oy : w.oz);
        const float inv = f == 0 ? w.ix : (f == 1 ? w.iy : w.iz);
        const float4 lo0 = __ldg(rec + 2 * f), lo1 = __ldg(rec + 2 * f + 1);
        const float4 hi0 = __ldg(rec + 6 + 2 * f), hi1 = __ldg(rec + 7 + 2 * f);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
            const float t0 = (lane_of(c < 4 ? lo0 : lo1, c % 4) - o) * inv;
            const float t1 = (lane_of(c < 4 ? hi0 : hi1, c % 4) - o) * inv;
            if (f == 0) {
                t_near[c] = fminf(t0, t1);
                t_far[c] = fmaxf(t0, t1);
            } else {
                t_near[c] = fmaxf(t_near[c], fminf(t0, t1));
                t_far[c] = fminf(t_far[c], fmaxf(t0, t1));
            }
        }
    }
    unsigned mask = 0u;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
        if (t_near[c] <= fminf(t_far[c], w.best_t) && t_far[c] > 0.0f) mask |= 1u << c;
    }
    const float da = axis == 0 ? w.dx : (axis == 1 ? w.dy : w.dz);
    const int d7 = da > 0.0f ? 7 : 0;
    int next = -1;           // the last interior child pushed: the next node popped
    unsigned leaves = 0u;    // visit positions cc of the leaves hit
#pragma unroll
    for (int cc = 0; cc < 8; ++cc) {
        const int c = cc ^ d7;
        if (!((mask >> c) & 1u)) continue;
        const int link = lane_of(c < 4 ? la : lb, c & 3);
        if (link >= 0) {
            if (next >= 0) st.push(w.sp, next);
            next = link;
        } else if (link > kEmptyGuard) {
            leaves |= 1u << cc;
        }
    }
    if (next >= 0) prefetch_node(nodes, next);
    for (; leaves != 0u; leaves &= leaves - 1u) {
        const int c = (__ffs(leaves) - 1) ^ d7;
        if (kStats) ++w.lv;
        test_leaf(w, planes, recs, (long long)(-(lane_of(c < 4 ? la : lb, c & 3) + 1)),
                  leaf_size);
    }
    w.node = next >= 0 ? next : (w.sp > 0 ? st.slot[--w.sp] : -1);
}

template <bool kStats>
__global__ void __launch_bounds__(kThreads, kMinBlocks) wide_shade_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const bool* __restrict__ alive, long long n,
    const float4* __restrict__ nodes,   // accel/shaded.py::node_records
    const float4* __restrict__ recs,    // the stride-32 shaded records
    const float4* __restrict__ planes,  // accel/shaded.py::leaf_planes
    int leaf_size,
    float* __restrict__ t_out, int* __restrict__ id_out,
    float* __restrict__ nx_out, float* __restrict__ ny_out,
    float* __restrict__ nz_out, int* __restrict__ mat_out,
    int* __restrict__ node_visits, int* __restrict__ leaf_visits) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    if (!alive[i]) {
        t_out[i] = kInf;
        id_out[i] = -1;
        nx_out[i] = 0.0f;
        ny_out[i] = 0.0f;
        nz_out[i] = 0.0f;
        mat_out[i] = 0;
        if (kStats) {
            node_visits[i] = 0;
            leaf_visits[i] = 0;
        }
        return;
    }
    Walk w;
    w.ox = ox[i];
    w.oy = oy[i];
    w.oz = oz[i];
    w.dx = dx[i];
    w.dy = dy[i];
    w.dz = dz[i];
    w.ix = inv_dir(w.dx);
    w.iy = inv_dir(w.dy);
    w.iz = inv_dir(w.dz);
    w.best_t = kInf;
    w.best_id = -1;
    w.bnx = 0.0f;
    w.bny = 0.0f;
    w.bnz = 0.0f;
    w.bmat = 0.0f;
    w.node = 0;
    w.sp = 0;
    w.nv = 0;
    w.lv = 0;
    Stack st;
    while (w.node >= 0) step<kStats>(w, st, nodes, recs, planes, leaf_size);
    // normalize once at write-out; misses keep zero normals
    const float rlen = rsqrtf(fmaxf(w.bnx * w.bnx + w.bny * w.bny + w.bnz * w.bnz, 1.0e-20f));
    t_out[i] = w.best_t;
    id_out[i] = w.best_id;
    nx_out[i] = w.bnx * rlen;
    ny_out[i] = w.bny * rlen;
    nz_out[i] = w.bnz * rlen;
    mat_out[i] = (int)w.bmat;
    if (kStats) {
        node_visits[i] = w.nv;
        leaf_visits[i] = w.lv;
    }
}

}  // namespace

extern "C" int atray_wide_shade_stack_cap() { return ATRAY_STACK_CAP; }

// Launches on ``stream``; returns cudaGetLastError() of the launch.
// ``nodes`` and ``leaves`` are the accel's cnodes and cleaves tables,
// ``tris`` its shaded records; ``node_visits`` and ``leaf_visits`` are both
// null (no stats) or both (n,) int32.
extern "C" int atray_wide_shade(
    const float* ox, const float* oy, const float* oz,
    const float* dx, const float* dy, const float* dz,
    const bool* alive, long long n, const int* nodes, const float* tris, const float* leaves,
    int leaf_size, float* t_out, int* id_out, float* nx_out, float* ny_out, float* nz_out,
    int* mat_out, int* node_visits, int* leaf_visits, void* stream) {
    if (n <= 0) return 0;
    if ((node_visits == nullptr) != (leaf_visits == nullptr)) return (int)cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
    cudaStream_t s = (cudaStream_t)stream;
    const float4* nodes4 = reinterpret_cast<const float4*>(nodes);
    const float4* recs = reinterpret_cast<const float4*>(tris);
    const float4* planes = reinterpret_cast<const float4*>(leaves);
    if (node_visits != nullptr) {
        wide_shade_kernel<true><<<blocks, kThreads, 0, s>>>(
            ox, oy, oz, dx, dy, dz, alive, n, nodes4, recs, planes, leaf_size,
            t_out, id_out, nx_out, ny_out, nz_out, mat_out, node_visits, leaf_visits);
    } else {
        wide_shade_kernel<false><<<blocks, kThreads, 0, s>>>(
            ox, oy, oz, dx, dy, dz, alive, n, nodes4, recs, planes, leaf_size,
            t_out, id_out, nx_out, ny_out, nz_out, mat_out, nullptr, nullptr);
    }
    return (int)cudaGetLastError();
}
