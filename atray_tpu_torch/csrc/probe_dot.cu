// Probe kernels P1-P5: what one block pays for a small matrix product,
// repeated ``reps`` times into a float32 sum, out = sum over reps of a . b.
//
// Replaces the TPU probes of the lane routing's matrix-unit cost:
//   P1 scripts/probe_r18.py:22 _kern_t      out += a . b^T (b contracted on dim 1)
//   P2 scripts/probe_r18.py:31 _kern_n      out += a . b
//   P3 scripts/probe_r18.py:82 _kern_bf16   out += a . b, bf16 operands, f32 sum
//   P4 scripts/probe_r19.py:25 _kern_k      out += a . b over a contraction of K
//   P5 scripts/probe_r19.py:34 _kern_indep  four 128-deep products into four sums
// Each TPU kernel runs on one core with no grid, so each port runs one block:
// the question is one core's cost, and the answer here is one SM's.
//
// f32 (P1, P2, P4, P5) is full float32 FFMA (fmaf, built with --fmad=false),
// never TF32; one SM's float32 rate bounds it (67 TFLOP/s / 132 SMs: 0.904 us
// a (14, 128) x (128, 128) product). The rep loop is outermost: every rep
// forms the product from the operands in shared memory and adds it to a
// float32 sum, as the TPU kernel's fori_loop adds dot(a, b) to its carry.
//
// P1 and P2 (probe_dot_resident_kernel): a (M, 128) and b (128, 128) sit in
// shared memory for all reps, beside the warps' carries (130,048 B in all
// at M=14, 139,264 at M=16).
// - 256 threads: eight warps split the contraction, warp w taking rows
//   [16 w, 16 w + 16) of it; a lane holds a register tile of all M rows x 4
//   adjacent columns (col = 4 lane). Per 4-deep step a lane makes four
//   16-byte loads of b and one broadcast 16-byte load of a's row i for each
//   i: 18 shared loads feed 4 M x 4 FFMA, two warps a scheduler.
// - P2 reads b's row k at col (a warp reads the whole 512-byte row, and no
//   other warp reads it). P1 reads b as stored, (n, k), along its rows: a lane
//   needs b[col + j, k .. k + 3], four 16-byte loads. b is staged at a row
//   stride of 128 words with row n's 16-byte chunk c at chunk c ^ ((n >> 2) &
//   7), so a quarter warp's eight loads (rows 4 l + j at one chunk) fall on
//   32 distinct banks; each row stays a row.
// - A rep: __syncwarp, a memory barrier among the warp's lanes that ptxas
//   does not move the rep's shared loads across (the empty asm with a memory
//   clobber binds only the front end: with it alone ptxas hoisted the
//   unrolled product out of the rep loop), then the warp's 16-deep share,
//   unrolled, its first step multiplies in place of FFMA with zero.
// - Order: a warp sums each run of 16 reps' partial products in registers,
//   then adds the run to its carry, which lies in shared memory. One carry a
//   warp for every rep fails the check: a share's partial can exceed the
//   whole product where the shares cancel, and 64 reps of it in one float32
//   sum reached 1.3-2.3x the tolerance (rtol 1e-5, atol 1e-5 x reps) on the
//   script's normal inputs. After the last rep the eight carries are summed
//   in a fixed order, warp 0 first. The carries in shared memory leave the
//   registers to the tile and the run (186 at M=14 for P2, none spilled).
// PERF.md (the P1/P2 ladder) has the other shapes: 4, 12 or 16 warps, 2
// columns a lane, unroll 1 or 2, zeroing, the run's length, carries in
// registers, b^T staged once, no swizzle, and the FFMA loop alone.
//
// P3 (probe_dot_bf16_kernel<N>) runs on the tensor cores, wgmma.mma_async
// bf16 -> f32, which takes 64 rows of A: a (M <= 64 rows) as A would waste
// most of them, so the block computes the product transposed, out^T = b^T .
// a^T. b, staged once as stored (k, n), is the A operand, read MN-major
// through the descriptor's transpose bit as two 64-row tiles, one a
// warpgroup; a, its rows padded with zero rows to N = M rounded up to 8 (an
// instance per N), is the B operand, K-major. A rep is 8 wgmma m64nNk16 a
// warpgroup (eight 16-deep steps, scale-d 0 on the first) in one commit
// group, then one __fadd_rn per accumulator into the float32 carry, the
// plain version's acc + p. The stages are the canonical 8 x 8 core-matrix
// layout without swizzle (a core matrix is 128 contiguous bytes, read
// without bank conflicts). Measured (PERF.md, the P3 ladder): M=56 runs at
// its one-SM bound, while M=14's 16 wgmma of N=16 take two thirds of the
// time of M=56's of N=56; a second accumulator set to overlap the adds did
// not pay (and across loop iterations ptxas serialized the wgmma), nor did
// one warpgroup for both tiles, the swizzle, A from registers or the
// untransposed product.
//
// P4 and P5 (probe_dot_stream_kernel): at K=4096 b alone is 2 MiB, far above
// the 227 KB a block can have, so a and b pass through shared memory in
// 128-deep slices on every rep (72,704 B a slice at M=14, 73,728 at M=16).
// - Eight consumer warps split every slice over K as P1-P2's warps do, with
//   the same M x 4 tile.
// - A ninth warp produces into a ring of three one-slice stages. Each stage
//   has a full mbarrier (a's M rows as 16-byte cp.async pieces over the
//   warp's lanes, then expect-tx and one bulk copy of b's slice) and an
//   empty mbarrier on which each consumer warp arrives after its last read
//   of the stage; the producer waits on it before a refill. No block-wide
//   barrier sits in the loop. Where the slices fit the stages (K <= 384) a
//   separate instance fills them once and never refills them, as the TPU
//   kernel's operands sat in VMEM every rep.
// - The rep loop is outermost: each rep a warp forms its partial product from
//   zero over its share of every slice and adds it to its own carry. After
//   the last rep the carries meet in shared memory (the ring is free by then)
//   and are summed in a fixed order, warp 0 first. P5 is the same kernel with
//   the warps in four groups of two, group j taking slice j (32 rows a warp),
//   so group j's carries sum to acc_j and out = ((acc_0 + acc_1) + acc_2) +
//   acc_3, the plain version's order.
// - P4 and P5 also need 72.7 KB of L2-to-SM stream a slice: this ring alone,
//   with no FFMA, moves a slice in 0.39 us (186 GB/s into one SM; a bulk copy
//   for each of a's rows instead took 0.71 us), against about 0.9 us of FFMA
//   at the one-SM bound (PERF.md, the P4/P5 ladder).
//
// P3's bound is the bf16 tensor rate of one SM; the card bound over 132 SMs
// is reported beside each one-SM bound.

#include <cuda_runtime.h>
#include <stdint.h>

#include "probe.cuh"

namespace {

constexpr int kN = 128;        // output columns
constexpr int kS = 128;        // contraction slice

enum Variant { kNormal = 0, kTransposed = 1, kStreamK = 2, kIndep = 3 };

// P1's stage of b (n, k): row n at a stride of 128 words, its 16-byte chunk
// c at chunk c ^ ((n >> 2) & 7). Returns the word of b[n, k].
__host__ __device__ __forceinline__ int swizzled(int n, int k) {
    return n * kN + 4 * ((k >> 2) ^ ((n >> 2) & 7)) + (k & 3);
}

// One 4-deep step at k of p[i][j] += a[i, k + q] b(k + q, col + j), a_s with
// row stride 128. b(k, n) is b_s[k * 128 + n]; with ROWS (P1) it is b[n, k]
// of P1's stage, b_s pointing at row col and key = (col >> 2) & 7. FIRST:
// the step's products start p (no add to zero).
template <int M, bool ROWS, bool FIRST>
__device__ __forceinline__ void step_product(const float* __restrict__ a_s,
                                             const float* __restrict__ b_s, int k, int col,
                                             int key, float (&p)[M][4]) {
    float bq[4][4];                                 // b(k + q, col + j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(
            ROWS ? b_s + q * kN + 4 * ((k >> 2) ^ key) : b_s + (k + q) * kN + col);
        const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            if (ROWS) {
                bq[j][q] = e[j];                    // row col + q is column col + q
            } else {
                bq[q][j] = e[j];
            }
        }
    }
#pragma unroll
    for (int i = 0; i < M; ++i) {
        const float4 av = *reinterpret_cast<const float4*>(a_s + i * kS + k);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            p[i][j] = FIRST ? __fmul_rn(av.x, bq[0][j]) : fmaf(av.x, bq[0][j], p[i][j]);
            p[i][j] = fmaf(av.y, bq[1][j], p[i][j]);
            p[i][j] = fmaf(av.z, bq[2][j], p[i][j]);
            p[i][j] = fmaf(av.w, bq[3][j], p[i][j]);
        }
    }
}

// p[i][j] += a[i, k] b(k, col + j) over the E-deep share [k0, k0 + E) of a_s
// (row stride 128) and b_s as step_product reads them, U steps unrolled.
// FIRST: the share's products start p.
template <int M, int E, bool ROWS = false, bool FIRST = false, int U = 1>
__device__ __forceinline__ void share_product(const float* __restrict__ a_s,
                                              const float* __restrict__ b_s, int col,
                                              float (&p)[M][4], int k0 = 0, int key = 0) {
    int k = k0;
    if (FIRST) {
        step_product<M, ROWS, true>(a_s, b_s, k, col, key, p);
        k += 4;
    }
#pragma unroll U
    for (; k < k0 + E; k += 4) step_product<M, ROWS, false>(a_s, b_s, k, col, key, p);
}

// P1 (TRANS) and P2: a (M, 128) and b (128, 128) resident in shared memory.
constexpr int kResWarps = 8;
constexpr int kResThreads = 32 * kResWarps;
constexpr int kResShare = kS / kResWarps;          // rows of the contraction a warp
constexpr int kRun = 16;                           // reps a run sums before the carry

// Dynamic shared memory of P1 and P2: a, b, then the warps' carries.
template <int M>
__host__ __device__ constexpr int resident_smem() {
    return (M * kS + kS * kN + kResWarps * M * kN) * 4;
}

template <int M, bool TRANS>
__global__ void __launch_bounds__(kResThreads, 1)
    probe_dot_resident_kernel(const float* __restrict__ a, const float* __restrict__ b,
                              float* __restrict__ out, int reps) {
    extern __shared__ __align__(16) float res_smem[];
    float* a_s = res_smem;                         // (M, 128)
    float* b_s = a_s + M * kS;                     // (128, 128), P1's rows swizzled
    float* carries = b_s + kS * kN;                // (kResWarps, M, 128), warp order
    const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, col = 4 * lane;
    for (int i = tid; i < M * kS; i += kResThreads) a_s[i] = a[i];
    for (int i = tid; i < kS * kN; i += kResThreads)
        b_s[TRANS ? swizzled(i / kS, i % kS) : i] = b[i];
    float* carry = carries + w * M * kN + col;     // this lane's tile, row stride 128
#pragma unroll
    for (int i = 0; i < M; ++i)
        *reinterpret_cast<float4*>(carry + i * kN) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    __syncthreads();
    const float* b_w = TRANS ? b_s + col * kN : b_s;  // P1: this lane's first row
    for (int r0 = 0; r0 < reps; r0 += kRun) {
        const int r1 = min(r0 + kRun, reps);
        float run[M][4];
#pragma unroll
        for (int i = 0; i < M; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) run[i][j] = 0.0f;
        for (int r = r0; r < r1; ++r) {
            asm volatile("" ::: "memory");
            __syncwarp();
            float p[M][4];
            share_product<M, kResShare, TRANS, true, kResShare / 4>(a_s, b_w, col, p,
                                                                  w * kResShare, lane & 7);
#pragma unroll
            for (int i = 0; i < M; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) run[i][j] = __fadd_rn(run[i][j], p[i][j]);
        }
#pragma unroll
        for (int i = 0; i < M; ++i) {
            float4 c = *reinterpret_cast<float4*>(carry + i * kN);
            c = make_float4(__fadd_rn(c.x, run[i][0]), __fadd_rn(c.y, run[i][1]),
                            __fadd_rn(c.z, run[i][2]), __fadd_rn(c.w, run[i][3]));
            *reinterpret_cast<float4*>(carry + i * kN) = c;
        }
    }
    __syncthreads();
    for (int e = tid; e < M * kN; e += kResThreads) {
        float o = carries[e];
        for (int q = 1; q < kResWarps; ++q) o = __fadd_rn(o, carries[q * M * kN + e]);
        out[e] = o;
    }
}

// P4 and P5: consumer warps, the producer warp, and the ring's stages.
constexpr int kWarps = 8;                          // consumer warps
constexpr int kStages = 3;                         // one 128-deep slice a stage
constexpr int kStreamThreads = 32 * (kWarps + 1);  // and the producer warp

// Floats of a stage: a's (M, 128) slice, then b's (128, 128) slice.
template <int M>
__host__ __device__ constexpr int stage_floats() {
    return M * kS + kS * kN;
}

// Dynamic shared memory of P4 and P5: the stages, then the full and empty
// barriers.
template <int M>
__host__ __device__ constexpr int stream_smem() {
    return kStages * stage_floats<M>() * 4 + 2 * kStages * 8;
}

// The producer warp's lanes: slice s of a (M, K) and b (K, 128) into a
// stage. a's M rows go as 16-byte cp.async pieces spread over the lanes
// (bulk copies are issued one after another, and a bulk copy for each
// 512-byte row took as long as b's whole 64 KB one), tracked by the full
// barrier; lane 0 then adds b's slice as one bulk copy.
template <int M>
__device__ __forceinline__ void issue_slice(const float* a, const float* b, int k, int s,
                                            float* stage, uint64_t* full, int lane) {
    constexpr int kRow = kS / 4;                   // 16-byte pieces a row
    for (int p = lane; p < M * kRow; p += 32)
        cp_async_16(stage + (p / kRow) * kS + (p % kRow) * 4,
                    a + (long long)(p / kRow) * k + s * kS + (p % kRow) * 4);
    cp_async_mbar_arrive(full);
    __syncwarp();
    if (lane == 0) {
        mbar_expect_tx(full, kS * kN * 4);
        bulk_g2s(stage + M * kS, b + (long long)s * kS * kN, kS * kN * 4, full);
    }
}

// P4 (G = 1): per rep each warp's partial product over its 16-deep share of
// every slice, added to its carry; out = the carries summed, warp 0 first.
// P5 (G = 4, K = 512): warp group j (two warps) takes slice j; out =
// ((acc_0 + acc_1) + acc_2) + acc_3, acc_j the sum of group j's carries.
// RING: the slices outnumber the stages, so stages are refilled; otherwise
// each slice has its own stage, filled once (a separate instance, free of
// the ring's bookkeeping).
template <int M, int G, bool RING>
__global__ void __launch_bounds__(kStreamThreads, 1)
    probe_dot_stream_kernel(const float* __restrict__ a, const float* __restrict__ b,
                            float* __restrict__ out, int k, int reps) {
    extern __shared__ __align__(128) float ring_smem[];
    constexpr int kStage = stage_floats<M>();
    constexpr int kGroup = kWarps / G;             // warps a group
    constexpr int kShare = kS / kGroup;            // rows of a slice a warp
    static_assert(kWarps % G == 0 && kShare % 4 == 0, "a warp's share is whole 4-row steps");
    static_assert(kWarps * M * kN <= kStages * kStage, "the carries fit the ring");
    uint64_t* full = reinterpret_cast<uint64_t*>(ring_smem + kStages * kStage);
    uint64_t* empty = full + kStages;
    const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
    const int slices = k / kS;
    const long long issued = reps > 0 ? (RING ? (long long)reps * slices : slices) : 0;
    if (tid == 0) {
        for (int s = 0; s < kStages; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], kWarps);
        }
        fence_mbar_init();
    }
    __syncthreads();
    const int g = w / kGroup, share = w % kGroup, col = lane * 4;
    float carry[M][4];
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) carry[i][j] = 0.0f;

    if (w == kWarps) {
        // the producer: slice it % slices into stage it % kStages, once the
        // consumers have released that stage's previous slice
        int st = 0;
        uint32_t ph = 0;
        for (long long it = 0; it < issued; ++it) {
            if (it >= kStages) mbar_wait(&empty[st], ph ^ 1u);
            issue_slice<M>(a, b, k, (int)(it % slices), ring_smem + st * kStage, &full[st], lane);
            if (++st == kStages) {
                st = 0;
                ph ^= 1u;
            }
        }
    } else {
        // Every warp waits on every slice's full barrier (also those of
        // another group's slices) and releases every stage it waited on, so
        // no barrier runs a phase ahead of a warp's parity.
        int st = 0;
        uint32_t ph = 0;
        for (int r = 0; r < reps; ++r) {
            asm volatile("" ::: "memory");
            float p[M][4];
#pragma unroll
            for (int i = 0; i < M; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) p[i][j] = 0.0f;
            for (int s = 0; s < slices; ++s) {
                const int stg = RING ? st : s;
                mbar_wait(&full[stg], RING ? ph : 0u);
                if (s % G == g) {
                    const float* stage = ring_smem + stg * kStage;
                    share_product<M, kShare>(stage + share * kShare,
                                             stage + M * kS + share * kShare * kN, col, p);
                }
                if (RING) {
                    __syncwarp();
                    if (lane == 0) mbar_arrive(&empty[stg]);
                    if (++st == kStages) {
                        st = 0;
                        ph ^= 1u;
                    }
                }
            }
#pragma unroll
            for (int i = 0; i < M; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) carry[i][j] = __fadd_rn(carry[i][j], p[i][j]);
        }
    }
    // every issued copy was waited on, so the ring is free for the carries
    __syncthreads();
    fence_proxy_async();
    float* red = ring_smem;                        // (kWarps, M, 128), warp order
    if (w < kWarps) {
#pragma unroll
        for (int i = 0; i < M; ++i)
            *reinterpret_cast<float4*>(red + (w * M + i) * kN + col) =
                make_float4(carry[i][0], carry[i][1], carry[i][2], carry[i][3]);
    }
    __syncthreads();
    for (int e = tid; e < M * kN; e += kStreamThreads) {
        float o = 0.0f;
#pragma unroll
        for (int j = 0; j < G; ++j) {
            float acc = red[j * kGroup * M * kN + e];
#pragma unroll
            for (int q = 1; q < kGroup; ++q) acc = __fadd_rn(acc, red[(j * kGroup + q) * M * kN + e]);
            o = j == 0 ? acc : __fadd_rn(o, acc);
        }
        out[e] = o;
    }
}

// P3: bf16 a (m, 128) and b (128, 128) resident; two warpgroups compute the
// product transposed, out^T (128, N) = b^T (128, 128) . a^T (128, N), on
// wgmma.mma_async m64nNk16 (f32 accumulators), N = m rounded up to 8;
// warpgroup g owns the 64-row tile g of out^T (columns [64 g, 64 g + 64) of
// out).
constexpr int kBfThreads = 256;   // two warpgroups

// Element offset of b[k, n] in the A operand's stage: b^T read MN-major
// (the transpose bit), no swizzle. 8 x 8 core matrices of 128 B, row k % 8
// holding n .. n + 7 of one k; core (k / 8, n / 8) at core index 16 (k / 8)
// + n / 8, so an n group's stride (SBO) is 128 B and a k group's (LBO) 2 KiB.
__device__ __forceinline__ int bf_b_stage(int k, int n) {
    return (((k >> 3) * 16 + (n >> 3)) << 6) + ((k & 7) << 3) + (n & 7);
}

// Element offset of a[i, k] (i < N; rows i >= m are zero) in the B
// operand's stage, K-major: core (i / 8, k / 8) at core index (k / 8) (N /
// 8) + i / 8, row i % 8 holding k .. k + 7; an i group's stride (SBO) 128
// B, a k group's (LBO) N / 8 x 128 B.
template <int N>
__device__ __forceinline__ int bf_a_stage(int i, int k) {
    return (((k >> 3) * (N / 8) + (i >> 3)) << 6) + ((i & 7) << 3) + (k & 7);
}

// A shared-memory matrix descriptor, no swizzle: the start address, the
// leading (LBO) and stride (SBO) byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
    return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
           (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Ties each register to this point of the program: reads of the
// accumulators after their wait stay after the wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N tile, N / 2 floats a thread) = A . B (+ d if acc): one
// wgmma.mma_async m64nNk16, A from descriptor da (MN-major: imm-trans-a 1),
// B from db (K-major).
template <int N>
__device__ __forceinline__ void wgmma_tile(float (&d)[N / 2], uint64_t da, uint64_t db, int acc);

template <>
__device__ __forceinline__ void wgmma_tile<8>(float (&d)[4], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_tile<16>(float (&d)[8], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_tile<24>(float (&d)[12], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, %12, %13, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_tile<32>(float (&d)[16], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15}, %16, %17, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_tile<40>(float (&d)[20], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15, %16, %17, %18, %19}, %20, %21, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19])
        : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_tile<48>(float (&d)[24], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_tile<56>(float (&d)[28], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %30, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27}, %28, %29, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
        : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_tile<64>(float (&d)[32], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "l"(da), "l"(db), "r"(acc));
}

template <int N>
__global__ void __launch_bounds__(kBfThreads, 1)
    probe_dot_bf16_kernel(const uint16_t* __restrict__ a, const uint16_t* __restrict__ b,
                          float* __restrict__ out, int m, int reps) {
    extern __shared__ __align__(128) uint16_t hsmem[];
    uint16_t* b_s = hsmem;                         // A operand, (128, 128)
    uint16_t* a_s = hsmem + kS * kN;               // B operand, (N, 128)
    const int tid = threadIdx.x, g = tid >> 7;
    for (int e = tid; e < kS * kN; e += kBfThreads) b_s[bf_b_stage(e >> 7, e & 127)] = b[e];
    for (int e = tid; e < N * kS; e += kBfThreads)
        a_s[bf_a_stage<N>(e >> 7, e & 127)] = (e >> 7) < m ? a[e] : (uint16_t)0;
    fence_proxy_async();                           // the stores, visible to wgmma's reads
    __syncthreads();
    // descriptors in 16-byte units: tile g's rows start at core 8 g, k step s
    // at core 32 s of b's stage and core 2 s N / 8 of a's
    const uint64_t da = smem_desc(b_s, 16 * 128, 128) + 64 * g;
    const uint64_t db = smem_desc(a_s, N / 8 * 128, 128);
    float carry[N / 2], d[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) carry[i] = 0.0f;
    for (int r = 0; r < reps; ++r) {
        // the rep's product from zero: 8 k steps, the first with scale-d 0
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < kS / 16; ++s) wgmma_tile<N>(d, da + 256 * s, db + 2 * N * s, s > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(d);
#pragma unroll
        for (int i = 0; i < N / 2; ++i) carry[i] = __fadd_rn(carry[i], d[i]);
    }
    // the fragment: warp w of the warpgroup, lane l holds rows 16 w + l / 4
    // (+ 8) of its tile and columns 8 j + 2 (l % 4) (+ 1); row n of out^T is
    // column n of out, column i its row i
    const int w = (tid >> 5) & 3, l = tid & 31;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int n = 64 * g + 16 * w + (l >> 2) + 8 * (q >> 1);
            const int i = 8 * j + 2 * (l & 3) + (q & 1);
            if (i < m) out[i * kN + n] = carry[4 * j + q];
        }
}

template <int M>
int launch_f32(const float* a, const float* b, float* out, int k, int reps, int variant,
               cudaStream_t stream) {
    switch (variant) {
        case kNormal:
            return launch_block(probe_dot_resident_kernel<M, false>, kResThreads,
                                resident_smem<M>(), stream, a, b, out, reps);
        case kTransposed:
            return launch_block(probe_dot_resident_kernel<M, true>, kResThreads,
                                resident_smem<M>(), stream, a, b, out, reps);
        case kStreamK:
            if (k / kS > kStages)
                return launch_block(probe_dot_stream_kernel<M, 1, true>, kStreamThreads,
                                    stream_smem<M>(), stream, a, b, out, k, reps);
            return launch_block(probe_dot_stream_kernel<M, 1, false>, kStreamThreads,
                                stream_smem<M>(), stream, a, b, out, k, reps);
        case kIndep:  // K = 512: always more slices than stages
            return launch_block(probe_dot_stream_kernel<M, 4, true>, kStreamThreads,
                                stream_smem<M>(), stream, a, b, out, k, reps);
    }
    return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of P3 at N: b, then a padded to N rows.
__host__ __device__ constexpr int bf16_smem(int n) {
    return (kS * kN + n * kS) * 2;
}

template <int N>
int launch_bf16(const uint16_t* a, const uint16_t* b, float* out, int m, int reps,
                cudaStream_t stream) {
    return launch_block(probe_dot_bf16_kernel<N>, kBfThreads, bf16_smem(N), stream, a, b, out,
                        m, reps);
}

}  // namespace

// f32 probes. variant 0: P2 (a . b, K = 128); 1: P1 (a . b^T, K = 128);
// 2: P4 (a . b, K a multiple of 128); 3: P5 (K = 512). m is 14 or 16.
// Launches one block on ``stream``; returns cudaGetLastError() of the launch.
extern "C" int atray_probe_dot(const float* a, const float* b, float* out, int m, int k, int reps,
                               int variant, void* stream) {
    if ((variant == kNormal || variant == kTransposed) && k != kS) return (int)cudaErrorInvalidValue;
    if (variant == kIndep && k != 4 * kS) return (int)cudaErrorInvalidValue;
    if (k <= 0 || k % kS || reps < 0) return (int)cudaErrorInvalidValue;
    if ((variant == kStreamK || variant == kIndep) && ((uintptr_t)a | (uintptr_t)b) % 16)
        return (int)cudaErrorMisalignedAddress;          // bulk copies move 16-byte units
    cudaStream_t s = (cudaStream_t)stream;
    if (m == 14) return launch_f32<14>(a, b, out, k, reps, variant, s);
    if (m == 16) return launch_f32<16>(a, b, out, k, reps, variant, s);
    return (int)cudaErrorInvalidValue;
}

// The launch shape of a variant (0-3) at m rows: threads a block, dynamic
// shared memory in bytes and (P4, P5) the ring's stages, into shape[0..2].
extern "C" int atray_probe_dot_shape(int m, int variant, int* shape) {
    if (m != 14 && m != 16) return (int)cudaErrorInvalidValue;
    const bool stream = variant == kStreamK || variant == kIndep;
    shape[0] = stream ? kStreamThreads : kResThreads;
    shape[2] = stream ? kStages : 0;
    if (stream) {
        shape[1] = m == 14 ? stream_smem<14>() : stream_smem<16>();
    } else {
        shape[1] = m == 14 ? resident_smem<14>() : resident_smem<16>();
    }
    return 0;
}

// P3: bf16 a (m, 128) with m in [1, 64], b (128, 128); out (m, 128) f32.
// The instance N = m rounded up to 8.
extern "C" int atray_probe_dot_bf16(const void* a, const void* b, float* out, int m, int reps,
                                    void* stream) {
    if (m < 1 || m > 64 || reps < 0) return (int)cudaErrorInvalidValue;
    const uint16_t* ha = static_cast<const uint16_t*>(a);
    const uint16_t* hb = static_cast<const uint16_t*>(b);
    cudaStream_t s = (cudaStream_t)stream;
    switch ((m + 7) / 8) {
        case 1: return launch_bf16<8>(ha, hb, out, m, reps, s);
        case 2: return launch_bf16<16>(ha, hb, out, m, reps, s);
        case 3: return launch_bf16<24>(ha, hb, out, m, reps, s);
        case 4: return launch_bf16<32>(ha, hb, out, m, reps, s);
        case 5: return launch_bf16<40>(ha, hb, out, m, reps, s);
        case 6: return launch_bf16<48>(ha, hb, out, m, reps, s);
        case 7: return launch_bf16<56>(ha, hb, out, m, reps, s);
        default: return launch_bf16<64>(ha, hb, out, m, reps, s);
    }
}

// P3's launch shape at m rows: threads, dynamic shared memory in bytes and
// the instance's N, into shape[0..2].
extern "C" int atray_probe_dot_bf16_shape(int m, int* shape) {
    if (m < 1 || m > 64) return (int)cudaErrorInvalidValue;
    const int n = (m + 7) / 8 * 8;
    shape[0] = kBfThreads;
    shape[1] = bf16_smem(n);
    shape[2] = n;
    return 0;
}
