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
// What bounds it: the latency of dependent loads. Every step reads a node
// record or a leaf whose address came out of the step before, from L2 (the
// tables of the slice's 139k triangles fit the H100's 50 MB L2), and a
// thread has nothing else to do while it waits; the walk sits 10-100x above
// its byte and operation bounds (PERF.md). The trainer's launches are
// small (65,536 rays) and walk a refit accel whose widened boxes send each
// ray through many leaves. The design follows csrc/wide_shade.cu:
//   - a node is one 256-byte record of the derived table cnodes
//     (accel/wide.py::node_records: 48 box floats, 8 links, the axis), read
//     as 16-byte vectors; the links sit in the record, so a hit child costs
//     no further dependent load (the cboxes row and the (8, W) clinks table
//     cost about 11 lines and one more load per hit child);
//   - a leaf's p0, e1 and e2 come from the derived planes cleaves
//     (accel/wide.py::leaf_planes, 576 bytes a 16-record leaf, where the
//     stride-16 records spread the same floats over 1 KB), four records'
//     copy of one float in one 16-byte vector; the face id is read from
//     word 9 of the stride-16 record, through the int view, only on a win;
//   - a node's interior children are pushed before its leaves are tested,
//     and the next node (the last child pushed, kept in a register, not on
//     the stack) is prefetched into L1 first, so its record arrives while
//     the leaves are tested;
//   - blocks of 64 threads with registers capped for 14 resident blocks an
//     SM (72 registers): 28 warps an SM keep more loads in flight on
//     launches of millions of rays, and the trainer's 65,536 rays spread
//     over 1,024 blocks (PERF.md holds the ladder of shapes tried).
//
// Order (that of the TPU kernels and of the plain version wide_exact_ref,
// per ray): pop a node, test its 8 child boxes against best_t as it stood
// at the pop; interior children are pushed for c = 0..7 (so popped from 7
// down) and leaves tested for c ascending. Pushing every interior child
// before testing any leaf changes neither order, because the pushes do not
// depend on the leaf tests. Strict t < best_t, so among equal t the first
// record tested wins.
//
// Hazards: one-sided Moller-Trumbore (det > 1e-12); 1e30 for zero
// direction components (0 * inf would be NaN in the slab); empty slots
// guarded by their INT32_MIN link, because their inverted boxes pass every
// slab test; face ids read as int bits (denormal floats); built with
// --fmad=false and no fast-math or flush-to-zero, so each operation is the
// IEEE op of the plain version in the same order.

#include <cuda_runtime.h>
#include <stdint.h>

#define ATRAY_EXACT_STACK_CAP 128

namespace {

constexpr float kInf = 3.0e38f;
constexpr float kTMin = 1.0e-4f;
constexpr float kBig = 1.0e30f;
constexpr int kNodeVecs = 16;      // 16-byte vectors of one node record (64 words)
constexpr int kLeafVecs = 18;      // float4s of one leaf row's planes: 9 planes x 8 records / 4
constexpr int kEmptyGuard = -2147483647;   // links <= this are empty slots
constexpr int kThreads = 64;       // threads a block
constexpr int kMinBlocks = 14;     // resident blocks an SM the registers must allow

__device__ __forceinline__ float inv_dir(float d) {
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
    float best_t, best_u, best_v;
    int best_id;
    int node;    // the node to pop next, -1 when the walk is over
    int sp;      // stack entries below it
};

struct Stack {   // in local memory: it is indexed by sp
    int slot[ATRAY_EXACT_STACK_CAP];

    __device__ __forceinline__ void push(int& sp, int v) {
        // the wrapper checks 8 * (max_depth + 2) <= ATRAY_EXACT_STACK_CAP
        if (sp < ATRAY_EXACT_STACK_CAP) slot[sp++] = v;
    }
};

// Asks L1 for both lines of a node record that the walk pops next.
__device__ __forceinline__ void prefetch_node(const float4* __restrict__ nodes, int node) {
    const char* p = reinterpret_cast<const char*>(nodes + (long long)node * kNodeVecs);
    asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
    asm volatile("prefetch.global.L1 [%0];" ::"l"(p + 128));
}

// The leaf at row `row` of the stride-16 records: its records' p0, e1, e2
// from the planes (float p of records 4 g .. 4 g + 3 at float4
// row * 18 + p * 2 rows_per_leaf + g), four records at a time, in order;
// strict < keeps the first of equal t. Rows hold 8 records, so a leaf of
// fewer pads its row and only k < leaf_size is tested.
__device__ __forceinline__ void test_leaf(Walk& w, const float4* __restrict__ planes,
                                          const int* __restrict__ tris_i, long long row,
                                          int leaf_size) {
    const int per_plane = leaf_size <= 8 ? 2 : leaf_size / 4;   // float4s a plane
    const float4* lp = planes + row * kLeafVecs;
    for (int g = 0; 4 * g < leaf_size; ++g) {
        float4 P[9];
#pragma unroll
        for (int q = 0; q < 9; ++q) P[q] = __ldg(lp + q * per_plane + g);
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
                w.best_t = tt;
                w.best_u = uu;
                w.best_v = vv;
                w.best_id = __ldg(tris_i + row * 128 + 16 * k + 9);
            }
        }
    }
}

// Pops w.node: tests its 8 child boxes, pushes the interior children hit,
// prefetches the next node, tests the leaves hit, and moves to the next.
__device__ __forceinline__ void step(Walk& w, Stack& st, const float4* __restrict__ nodes,
                                     const float4* __restrict__ planes,
                                     const int* __restrict__ tris_i, int leaf_size) {
    const float4* rec = nodes + (long long)w.node * kNodeVecs;
    const int4 la = __ldg(reinterpret_cast<const int4*>(rec) + 12);   // links of children 0-3
    const int4 lb = __ldg(reinterpret_cast<const int4*>(rec) + 13);   // links of children 4-7
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
    int next = -1;           // the last interior child pushed: the next node popped
    unsigned leaves = 0u;    // the leaf children hit
#pragma unroll
    for (int c = 0; c < 8; ++c) {
        if (!(t_near[c] <= t_far[c] && t_far[c] > 0.0f && t_near[c] < w.best_t)) continue;
        const int link = lane_of(c < 4 ? la : lb, c & 3);
        if (link >= 0) {
            if (next >= 0) st.push(w.sp, next);
            next = link;
        } else if (link > kEmptyGuard) {
            leaves |= 1u << c;
        }
    }
    if (next >= 0) prefetch_node(nodes, next);
    for (; leaves != 0u; leaves &= leaves - 1u) {
        const int c = __ffs(leaves) - 1;
        test_leaf(w, planes, tris_i, (long long)(-(lane_of(c < 4 ? la : lb, c & 3) + 1)),
                  leaf_size);
    }
    w.node = next >= 0 ? next : (w.sp > 0 ? st.slot[--w.sp] : -1);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) wide_exact_kernel(
    const float* __restrict__ orig,     // (n, 3)
    const float* __restrict__ dirn,     // (n, 3)
    long long n,
    const float4* __restrict__ nodes,   // accel/wide.py::node_records
    const float4* __restrict__ planes,  // accel/wide.py::leaf_planes
    const int* __restrict__ tris_i,     // the stride-16 records, int view
    int leaf_size,
    float* __restrict__ t_out, float* __restrict__ u_out,
    float* __restrict__ v_out, int* __restrict__ id_out) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    Walk w;
    w.ox = orig[3 * i];
    w.oy = orig[3 * i + 1];
    w.oz = orig[3 * i + 2];
    w.dx = dirn[3 * i];
    w.dy = dirn[3 * i + 1];
    w.dz = dirn[3 * i + 2];
    w.ix = inv_dir(w.dx);
    w.iy = inv_dir(w.dy);
    w.iz = inv_dir(w.dz);
    w.best_t = kInf;
    w.best_u = 0.0f;
    w.best_v = 0.0f;
    w.best_id = -1;
    w.node = 0;
    w.sp = 0;
    Stack st;
    while (w.node >= 0) step(w, st, nodes, planes, tris_i, leaf_size);
    t_out[i] = w.best_t;
    u_out[i] = w.best_u;
    v_out[i] = w.best_v;
    id_out[i] = w.best_id;
}

}  // namespace

extern "C" int atray_wide_exact_stack_cap() { return ATRAY_EXACT_STACK_CAP; }

// Launches on ``stream``; returns cudaGetLastError() of the launch.
// ``nodes`` and ``leaves`` are the accel's cnodes and cleaves tables,
// ``tris`` its stride-16 leaf records.
extern "C" int atray_wide_exact(
    const float* orig, const float* dirn, long long n,
    const int* nodes, const float* tris, const float* leaves, int leaf_size,
    float* t_out, float* u_out, float* v_out, int* id_out, void* stream) {
    if (n <= 0) return 0;
    const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
    wide_exact_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        orig, dirn, n, reinterpret_cast<const float4*>(nodes),
        reinterpret_cast<const float4*>(leaves), reinterpret_cast<const int*>(tris), leaf_size,
        t_out, u_out, v_out, id_out);
    return (int)cudaGetLastError();
}
