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
// Layout: out is (M, 128); thread n of 128 owns column n and holds the M
// sums in registers. Each rep re-reads the operands from shared memory (an
// empty asm with a memory clobber keeps the compiler from hoisting the
// loop-invariant product out of the rep loop), forms the product p = a . b
// from zero and adds it to the sum, as the TPU kernel adds dot(a, b) to its
// carry.
//
// f32 (P1, P2, P4, P5) is full float32 FFMA, never TF32. P1 and P2 differ
// only in where b is read: P2 reads row k of the staged b (neighbouring
// threads on neighbouring words), P1 reads row n of the staged b at column k,
// with the row stride padded to 129 words so that a warp's 32 rows fall on
// 32 banks. P3 runs on the tensor cores, mma.sync m16n8k16 bf16 -> f32, the
// M=14 case padded to 16 rows with zero registers (the inputs stay 14 rows).
//
// Shared memory: P1-P3 keep a and b resident (b is 64 KiB). For P4 at K=4096
// b alone is 2 MiB, far above the 227 KB a block can have, so P4 and P5
// stream 128-deep K-slices of a and b (72 KiB a slice) through a
// double-buffered ring of bulk copies (probe.cuh) on every rep: one wide
// product becomes K/128 narrow ones fed from L2, and its cost per slice is
// the L2-to-SM rate against the FFMA rate of one SM.
//
// What bounds it: float32 (P3: bf16 tensor) operations of one SM; the card
// bound over 132 SMs is reported beside the one-SM bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "probe.cuh"

namespace {

constexpr int kN = 128;        // output columns
constexpr int kS = 128;        // contraction slice
constexpr int kThreads = 128;  // one thread per output column
constexpr int kPad = kS + 1;   // P1's staged row stride (bank-conflict free)

enum Variant { kNormal = 0, kTransposed = 1, kStreamK = 2, kIndep = 3 };

// p[i] += a[i, k] * b(k, n) over one 128-deep slice; a_s is (M, 128).
template <int M, bool TRANS>
__device__ __forceinline__ void slice_product(const float* __restrict__ a_s,
                                              const float* __restrict__ b_s, int n,
                                              float (&p)[M]) {
#pragma unroll 2
    for (int k = 0; k < kS; k += 4) {
        float bk[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) bk[q] = TRANS ? b_s[n * kPad + k + q] : b_s[(k + q) * kN + n];
#pragma unroll
        for (int i = 0; i < M; ++i) {
            const float4 av = *reinterpret_cast<const float4*>(a_s + i * kS + k);
            p[i] = fmaf(av.x, bk[0], p[i]);
            p[i] = fmaf(av.y, bk[1], p[i]);
            p[i] = fmaf(av.z, bk[2], p[i]);
            p[i] = fmaf(av.w, bk[3], p[i]);
        }
    }
}

// P1 (TRANS) and P2: a (M, 128) and b (128, 128) resident in shared memory.
template <int M, bool TRANS>
__global__ void __launch_bounds__(kThreads)
    probe_dot_resident_kernel(const float* __restrict__ a, const float* __restrict__ b,
                              float* __restrict__ out, int reps) {
    extern __shared__ __align__(16) float res_smem[];
    float* a_s = res_smem;
    float* b_s = res_smem + M * kS;
    const int n = threadIdx.x;
    for (int i = n; i < M * kS; i += kThreads) a_s[i] = a[i];
    for (int i = n; i < kS * kN; i += kThreads) b_s[TRANS ? (i / kS) * kPad + i % kS : i] = b[i];
    __syncthreads();
    float acc[M];
#pragma unroll
    for (int i = 0; i < M; ++i) acc[i] = 0.0f;
    for (int r = 0; r < reps; ++r) {
        asm volatile("" ::: "memory");
        float p[M];
#pragma unroll
        for (int i = 0; i < M; ++i) p[i] = 0.0f;
        slice_product<M, TRANS>(a_s, b_s, n, p);
#pragma unroll
        for (int i = 0; i < M; ++i) acc[i] = __fadd_rn(acc[i], p[i]);
    }
#pragma unroll
    for (int i = 0; i < M; ++i) out[i * kN + n] = acc[i];
}

// Thread 0: slice s of a (M, K) and b (K, 128) into one stage of the ring.
template <int M>
__device__ __forceinline__ void issue_slice(const float* a, const float* b, int k, int s,
                                            float* a_s, float* b_s, uint64_t* bar) {
    mbar_expect_tx(bar, (M * kS + kS * kN) * 4);
    bulk_g2s(b_s, b + (long long)s * kS * kN, kS * kN * 4, bar);
    for (int i = 0; i < M; ++i) bulk_g2s(a_s + i * kS, a + (long long)i * k + s * kS, kS * 4, bar);
}

// P4 (INDEP false): per rep p = a . b over all K/128 slices, then acc += p.
// P5 (INDEP true, K = 512): per rep acc_j += a_j . b_j for the four slices,
// and out = acc_0 + acc_1 + acc_2 + acc_3 at the end.
template <int M, bool INDEP>
__global__ void __launch_bounds__(kThreads)
    probe_dot_stream_kernel(const float* __restrict__ a, const float* __restrict__ b,
                            float* __restrict__ out, int k, int reps) {
    extern __shared__ __align__(128) float ring_smem[];
    __shared__ __align__(8) uint64_t bar[2];
    constexpr int kStage = M * kS + kS * kN;  // floats: a slice, then b slice
    const int n = threadIdx.x;
    const int slices = k / kS;
    const long long total = (long long)reps * slices;
    if (n == 0) {
        mbar_init(&bar[0], 1);
        mbar_init(&bar[1], 1);
        fence_mbar_init();
    }
    __syncthreads();
    if (n == 0 && total > 0) issue_slice<M>(a, b, k, 0, ring_smem, ring_smem + M * kS, &bar[0]);

    float acc[INDEP ? 4 : 1][M];
    float p[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
        p[i] = 0.0f;
#pragma unroll
        for (int j = 0; j < (INDEP ? 4 : 1); ++j) acc[j][i] = 0.0f;
    }
    uint32_t phase = 0;  // bit st: the parity stage st waits on next
    for (long long it = 0; it < total; ++it) {
        const int st = (int)(it & 1);
        const int s = (int)(it % slices);
        float* a_s = ring_smem + st * kStage;
        if (n == 0 && it + 1 < total) {
            float* a_next = ring_smem + (st ^ 1) * kStage;
            issue_slice<M>(a, b, k, (int)((it + 1) % slices), a_next, a_next + M * kS, &bar[st ^ 1]);
        }
        mbar_wait(&bar[st], (phase >> st) & 1u);
        phase ^= 1u << st;
        slice_product<M, false>(a_s, a_s + M * kS, n, p);
        if constexpr (INDEP) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                if (s == j) {
#pragma unroll
                    for (int i = 0; i < M; ++i) acc[j][i] = __fadd_rn(acc[j][i], p[i]);
                }
            }
#pragma unroll
            for (int i = 0; i < M; ++i) p[i] = 0.0f;
        } else if (s == slices - 1) {
#pragma unroll
            for (int i = 0; i < M; ++i) {
                acc[0][i] = __fadd_rn(acc[0][i], p[i]);
                p[i] = 0.0f;
            }
        }
        __syncthreads();  // the stage is free for the copy issued next
    }
#pragma unroll
    for (int i = 0; i < M; ++i) {
        if constexpr (INDEP) {
            out[i * kN + n] =
                __fadd_rn(__fadd_rn(__fadd_rn(acc[0][i], acc[1][i]), acc[2][i]), acc[3][i]);
        } else {
            out[i * kN + n] = acc[0][i];
        }
    }
}

// P3: bf16 a (m, 128) and b (128, 128) resident; MT 16-row tiles of a.
// Warp w owns the four 8-column tiles of columns [32 w, 32 w + 32).
constexpr int kBfStride = kS + 8;  // staged row stride in bf16 (bank-conflict free)

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

template <int MT>
__global__ void __launch_bounds__(kThreads)
    probe_dot_bf16_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
                          float* __restrict__ out, int m, int reps) {
    extern __shared__ __align__(16) __nv_bfloat16 hsmem[];
    __nv_bfloat16* a_s = hsmem;                   // (m, kBfStride)
    __nv_bfloat16* bt_s = hsmem + MT * 16 * kBfStride;  // b transposed, (128, kBfStride)
    const int tid = threadIdx.x;
    for (int i = tid; i < m * kS; i += kThreads) a_s[(i / kS) * kBfStride + i % kS] = a[i];
    for (int i = tid; i < kS * kN; i += kThreads) bt_s[(i % kN) * kBfStride + i / kN] = b[i];
    __syncthreads();
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    float acc[MT][4][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[mt][j][q] = 0.0f;
    for (int r = 0; r < reps; ++r) {
        asm volatile("" ::: "memory");
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
            const int row0 = mt * 16 + g, row1 = row0 + 8;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int col = (warp * 4 + j) * 8 + g;  // b column of this lane's B fragment
                float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f, d3 = 0.0f;
#pragma unroll
                for (int ks = 0; ks < kS; ks += 16) {
                    const int kk = ks + 2 * t;
                    const uint32_t a0 = row0 < m ? ld_pair(a_s + row0 * kBfStride + kk) : 0u;
                    const uint32_t a1 = row1 < m ? ld_pair(a_s + row1 * kBfStride + kk) : 0u;
                    const uint32_t a2 = row0 < m ? ld_pair(a_s + row0 * kBfStride + kk + 8) : 0u;
                    const uint32_t a3 = row1 < m ? ld_pair(a_s + row1 * kBfStride + kk + 8) : 0u;
                    const uint32_t b0 = ld_pair(bt_s + col * kBfStride + kk);
                    const uint32_t b1 = ld_pair(bt_s + col * kBfStride + kk + 8);
                    asm volatile(
                        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                        : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
                        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
                }
                acc[mt][j][0] = __fadd_rn(acc[mt][j][0], d0);
                acc[mt][j][1] = __fadd_rn(acc[mt][j][1], d1);
                acc[mt][j][2] = __fadd_rn(acc[mt][j][2], d2);
                acc[mt][j][3] = __fadd_rn(acc[mt][j][3], d3);
            }
        }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
        const int row0 = mt * 16 + g, row1 = row0 + 8;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int c0 = (warp * 4 + j) * 8 + 2 * t;
            if (row0 < m) {
                out[row0 * kN + c0] = acc[mt][j][0];
                out[row0 * kN + c0 + 1] = acc[mt][j][1];
            }
            if (row1 < m) {
                out[row1 * kN + c0] = acc[mt][j][2];
                out[row1 * kN + c0 + 1] = acc[mt][j][3];
            }
        }
    }
}

template <int M>
int launch_f32(const float* a, const float* b, float* out, int k, int reps, int variant,
               cudaStream_t stream) {
    const int resident = (M * kS + kS * kN) * 4;
    const int transposed = (M * kS + kS * kPad) * 4;
    const int ring = 2 * (M * kS + kS * kN) * 4;
    switch (variant) {
        case kNormal:
            return launch_block(probe_dot_resident_kernel<M, false>, kThreads, resident, stream, a,
                                b, out, reps);
        case kTransposed:
            return launch_block(probe_dot_resident_kernel<M, true>, kThreads, transposed, stream, a,
                                b, out, reps);
        case kStreamK:
            return launch_block(probe_dot_stream_kernel<M, false>, kThreads, ring, stream, a, b, out,
                                k, reps);
        case kIndep:
            return launch_block(probe_dot_stream_kernel<M, true>, kThreads, ring, stream, a, b, out,
                                k, reps);
    }
    return (int)cudaErrorInvalidValue;
}

template <int MT>
int launch_bf16(const __nv_bfloat16* a, const __nv_bfloat16* b, float* out, int m, int reps,
                cudaStream_t stream) {
    const int smem = (MT * 16 + kS) * kBfStride * 2;
    return launch_block(probe_dot_bf16_kernel<MT>, kThreads, smem, stream, a, b, out, m, reps);
}

}  // namespace

// f32 probes. variant 0: P2 (a . b, K = 128); 1: P1 (a . b^T, K = 128);
// 2: P4 (a . b, K a multiple of 128); 3: P5 (K = 512). m is 14 or 16.
// Launches one block on ``stream``; returns cudaGetLastError() of the launch.
extern "C" int atray_probe_dot(const float* a, const float* b, float* out, int m, int k, int reps,
                               int variant, void* stream) {
    if ((variant == kNormal || variant == kTransposed) && k != kS) return (int)cudaErrorInvalidValue;
    if (variant == kIndep && k != 4 * kS) return (int)cudaErrorInvalidValue;
    if (k <= 0 || k % kS) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (m == 14) return launch_f32<14>(a, b, out, k, reps, variant, s);
    if (m == 16) return launch_f32<16>(a, b, out, k, reps, variant, s);
    return (int)cudaErrorInvalidValue;
}

// P3: bf16 a (m, 128) with m in [1, 64], b (128, 128); out (m, 128) f32.
extern "C" int atray_probe_dot_bf16(const void* a, const void* b, float* out, int m, int reps,
                                    void* stream) {
    if (m < 1 || m > 64) return (int)cudaErrorInvalidValue;
    const __nv_bfloat16* ha = static_cast<const __nv_bfloat16*>(a);
    const __nv_bfloat16* hb = static_cast<const __nv_bfloat16*>(b);
    cudaStream_t s = (cudaStream_t)stream;
    switch ((m + 15) / 16) {
        case 1: return launch_bf16<1>(ha, hb, out, m, reps, s);
        case 2: return launch_bf16<2>(ha, hb, out, m, reps, s);
        case 3: return launch_bf16<3>(ha, hb, out, m, reps, s);
        default: return launch_bf16<4>(ha, hb, out, m, reps, s);
    }
}
