// Probe kernels P6-P9: what one step of a lane-routing loop costs, piece by
// piece, with the loop bound read at run time.
//
// Replaces the TPU probes of scripts/probe_r20.py:
//   P6 :34  make_kern(variant, unroll).kern  a loop of n steps on a (14, 128)
//           sum: empty; iota (+1 each step); dot (+ win[:, 0, :] . I);
//           build+dot (+ win[:, 0, :] . OH_r); unroll 1, 4 or 8 steps a trip
//   P7 :118 _kern_dyn       build+dot with window row r % 16
//   P8 :163 _kern_nested    outer rows jj < n of min(jj % 7 + 1, inner) steps;
//           when_store writes the row's sum (x2 on odd rows), carry6 carries
//           six scalars
//   P9 :235 _kern_bigread   per row jj: rel = idx[(7 jj) % rows], the sum
//           gathers window row jj % 16 at rel; store_dyn also writes the sum
//           to slab row (13 jj) % 450 of half jj % 2
//
// The TPU routes lanes with a one-hot product, blk . OH_r where
// OH_r[k, l] = (k + r == rel[l]), because its vector unit cannot gather. That
// product is a gather: acc[c, l] += blk[c, rel[l] - r] where
// 0 <= rel[l] - r < 128, else nothing. A GPU lane gathers, so these kernels
// compute that function directly (the "build" is each lane's range test,
// the "dot" its 14 loads and adds), with the plain versions' op order, so
// the sums are exact against them.
//
// Launch shape: one block of 128 threads, thread l owning lane l and the 14
// sums in registers. The step count n is read from device memory inside
// the kernel, as the TPU read it from SMEM, so the compiler cannot unroll
// the loop by a known count. P6 empty stages the (14, 16, 128) f32 window,
// 114,688 B, into shared memory (what the TPU kept in VMEM) and walks its
// trips; iota and dot read no staged window. P6 build+dot and P7 add a lane's
// at most 128 terms in a walk over the window columns (routed_walk), from
// row 0 staged alone (7,168 B) or from the whole window staged column by
// column. P8 stages the window and its (14, 128) out block (7,168 B more)
// when it stores; P9's idx table (8.3 MB) and slab (6.45 MB) stay in device
// memory, the next rows' index words in flight. Where the TPU kernel's
// output is undefined (P8 without when_store) the sums are kept live by an
// empty asm and never stored; P8's six carries are written to carry_out so
// that they are computed at all.
//
// What bounds it: one warp scheduler's issue rate over a loop-carried
// chain. probe_r20.issue_instr counts the instructions the function needs
// on the busiest of the four warps (the adds of distinct sums: 14 for each
// term of the warp's busiest lane, since one instruction serves all 32
// lanes; the stores, the carries); the card bound (operations over 67
// TFLOP/s, or the bytes) is reported beside it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "probe.cuh"

namespace {

constexpr int kC = 14;
constexpr int kRows = 16;
constexpr int kLane = 128;
constexpr int kWinFloats = kC * kRows * kLane;
constexpr int kSlabRows = 450;

enum LoopVariant { kEmpty = 0, kIota = 1, kDot = 2, kBuildDot = 3 };

__device__ __forceinline__ void stage_win(const float* __restrict__ win, float* win_s) {
    for (int i = threadIdx.x; i < kWinFloats; i += blockDim.x) win_s[i] = win[i];
    __syncthreads();
}

__device__ __forceinline__ float win_at(const float* win_s, int c, int row, int k) {
    return win_s[(c * kRows + row) * kLane + k];
}

// acc[c] += win[c, row, rel - r] where 0 <= rel - r < 128 (P9's row step).
__device__ __forceinline__ void routed_step(const float* win_s, int row, int k, float (&acc)[kC]) {
    if ((unsigned)k < (unsigned)kLane) {
#pragma unroll
        for (int c = 0; c < kC; ++c) acc[c] = __fadd_rn(acc[c], win_at(win_s, c, row, k));
    }
}

// P6 build+dot's window: row 0 alone as [c][k], 16-byte loads, all in flight.
constexpr int kRow0Floats = kC * kLane;

__device__ __forceinline__ void stage_row0(const float* __restrict__ win, float* row0_s) {
    constexpr int kQuads = kRow0Floats / 4;                       // 448
    constexpr int kPer = (kQuads + kLane - 1) / kLane;            // 4
    float4 v[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
        const int i = threadIdx.x + j * kLane;
        if (i < kQuads)
            v[j] = *reinterpret_cast<const float4*>(win + (i >> 5) * kRows * kLane + 4 * (i & 31));
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
        const int i = threadIdx.x + j * kLane;
        if (i < kQuads) reinterpret_cast<float4*>(row0_s)[i] = v[j];
    }
    __syncthreads();
}

// P7's window as [c][k][row], row fastest: the at most 16 rows that a warp
// reads at one column k lie in 16 banks, (16 k + row) % 32. A warp moves a
// group of two 16-byte column quads of one channel, lane = row + 16 x
// quad's parity, 8 groups (32 registers) in flight a batch; its scalar
// stores meet two lanes a bank.
__device__ __forceinline__ void stage_win_krow(const float* __restrict__ win, float* win_s) {
    constexpr int kGroups = kC * kLane / 8;                       // 224: (c, pair of quads)
    constexpr int kPerWarp = kGroups / (kLane / 32);              // 56
    constexpr int kBatch = 8;
    const int lane = threadIdx.x & 31;
    const int row = lane & (kRows - 1);
    const int g_end = (threadIdx.x >> 5) * kPerWarp + kPerWarp;
    for (int g0 = g_end - kPerWarp; g0 < g_end; g0 += kBatch) {
        float4 v[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
            const int g = g0 + b, c = g >> 4, q = ((g & 15) << 1) | (lane >> 4);
            v[b] = *reinterpret_cast<const float4*>(win + (c * kRows + row) * kLane + 4 * q);
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
            const int g = g0 + b, c = g >> 4, q = ((g & 15) << 1) | (lane >> 4);
            float* dst = win_s + (c * kLane + 4 * q) * kRows + row;
            dst[0] = v[b].x;
            dst[kRows] = v[b].y;
            dst[2 * kRows] = v[b].z;
            dst[3 * kRows] = v[b].w;
        }
    }
    __syncthreads();
}

// P6 build+dot (DYN false, row 0 as [c][k]) and P7 (DYN true, [c][k][row]).
// Lane l adds win[c, row(r), rel - r] for the steps r < steps with
// 0 <= rel - r < 128, in increasing r: k = rel - r from khi = min(rel, 127)
// down to klo = max(rel - steps + 1, 0), at most 128 terms. The warp walks
// k from its lanes' largest khi down to their smallest klo; at a k outside
// its own range a lane adds +0.0, as the plain version does: a sum that
// starts at +0.0 never becomes -0.0 under round-to-nearest, so adding +0.0
// leaves its bits as they are. Every column's loads are in the window, and
// the select keeps the walk free of branches, so ptxas keeps the loads of
// the unrolled columns in flight together (with `if (ok)` it put each
// column's loads and adds behind a branch: 10.8 us against 7.9 for P6 on
// the H100, 18.2 against 12.4 for P7).
template <bool DYN>
__device__ __forceinline__ void routed_walk(const float* win_s, int rl, long long steps,
                                            float (&acc)[kC]) {
    constexpr int kStride = DYN ? kLane * kRows : kLane;          // one channel to the next
    const int khi = min(rl, kLane - 1);
    const int klo = (int)min(max((long long)rl - steps + 1, 0LL), (long long)kLane);
    const bool any = klo <= khi;
    const int kmax = __reduce_max_sync(0xffffffffu, any ? khi : -1);
    const int kmin = __reduce_min_sync(0xffffffffu, any ? klo : kLane);
#pragma unroll 4
    for (int k = kmax; k >= kmin; --k) {
        const bool ok = klo <= k && k <= khi;
        const float* w =
            DYN ? win_s + k * kRows + (((unsigned)rl - (unsigned)k) & (kRows - 1)) : win_s + k;
#pragma unroll
        for (int c = 0; c < kC; ++c) {
            const float v = w[c * kStride];
            acc[c] = __fadd_rn(acc[c], ok ? v : 0.0f);
        }
    }
}

// P6 iota: its 14 sums are equal, so one sum of 1.0 a step serves them all,
// in kIotaChains partial chains (exact integers below 2^24, the plain
// version's limit, so their sum has the bits of one chain's), 128 steps a
// trip.
constexpr int kIotaChains = 8;

__device__ __forceinline__ float iota_sum(long long steps) {
    float part[kIotaChains];
#pragma unroll
    for (int p = 0; p < kIotaChains; ++p) part[p] = 0.0f;
    long long s = 0;
#pragma unroll 16
    for (; s + kIotaChains <= steps; s += kIotaChains) {
#pragma unroll
        for (int p = 0; p < kIotaChains; ++p) part[p] = __fadd_rn(part[p], 1.0f);
    }
    for (; s < steps; ++s) part[0] = __fadd_rn(part[0], 1.0f);
#pragma unroll
    for (int w = kIotaChains / 2; w > 0; w /= 2) {
#pragma unroll
        for (int p = 0; p < w; ++p) part[p] = __fadd_rn(part[p], part[p + w]);
    }
    return part[0];
}

template <int V, int UNROLL>
__global__ void __launch_bounds__(kLane)
    probe_route_loop_kernel(const int* __restrict__ n_ptr, const float* __restrict__ win,
                            const int* __restrict__ rel, float* __restrict__ out) {
    extern __shared__ __align__(16) float loop_win_s[];
    const int l = threadIdx.x;
    float acc[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[c] = 0.0f;
    if constexpr (V == kEmpty) {
        // n trips of UNROLL empty steps: the trips are what it prices
        stage_win(win, loop_win_s);
        const int n = *n_ptr;
        for (int i = 0; i < n; ++i) {
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) asm volatile("");
        }
    } else if constexpr (V == kIota) {
        const float t = iota_sum((long long)*n_ptr * UNROLL);
#pragma unroll
        for (int c = 0; c < kC; ++c) acc[c] = t;
    } else if constexpr (V == kDot) {
        // the product with the identity: each lane adds its own word of
        // row 0 every step, in step order; the words stay in registers, 16
        // steps a trip (4 cost 17% more on the H100)
        float w[kC];
#pragma unroll
        for (int c = 0; c < kC; ++c) w[c] = win[c * kRows * kLane + l];
        const long long steps = (long long)*n_ptr * UNROLL;
#pragma unroll 16
        for (long long s = 0; s < steps; ++s) {
#pragma unroll
            for (int c = 0; c < kC; ++c) acc[c] = __fadd_rn(acc[c], w[c]);
        }
    } else {
        stage_row0(win, loop_win_s);
        routed_walk<false>(loop_win_s, rel[l], (long long)*n_ptr * UNROLL, acc);
    }
#pragma unroll
    for (int c = 0; c < kC; ++c) out[c * kLane + l] = acc[c];
}

__global__ void __launch_bounds__(kLane)
    probe_route_dyn_kernel(const int* __restrict__ n_ptr, const float* __restrict__ win,
                           const int* __restrict__ rel, float* __restrict__ out) {
    extern __shared__ __align__(16) float dyn_win_s[];
    stage_win_krow(win, dyn_win_s);
    const int l = threadIdx.x;
    float acc[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[c] = 0.0f;
    routed_walk<true>(dyn_win_s, rel[l], *n_ptr, acc);
#pragma unroll
    for (int c = 0; c < kC; ++c) out[c * kLane + l] = acc[c];
}

// +0.0f that neither compiler can see as a constant, and that differs from
// row to row as far as they know: the launch has one block, so
// blockIdx.x * jj is 0. P8's rows start from it. A row's terms do not
// change from row to row, so from a literal zero ptxas forms the first
// step's sums once, before the row loop (an asm mov of 0 is folded alike).
__device__ __forceinline__ float row_zero(int jj) { return __int_as_float((int)blockIdx.x * jj); }

// A shared-memory store that ptxas cannot drop as dead (the TPU kernel's
// store of every row into its VMEM out block), and its load back.
__device__ __forceinline__ void sts_kept(uint32_t addr, float v) {
    asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(v));
}

__device__ __forceinline__ float lds_kept(uint32_t addr) {
    float v;
    asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
    return v;
}

constexpr int kMaxSteps = 7;    // a P8 row takes min(jj % 7 + 1, inner) <= 7 steps

// One P8 row of q steps from ``zero``, then its store into the out tile
// (doubled on an odd row) or, without the store, its fold into ``sink``.
template <bool WHEN_STORE>
__device__ __forceinline__ void nested_row(const float (&word)[kMaxSteps][kC], int q, bool odd,
                                           float zero, uint32_t out_addr, int& sink) {
    float acc[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[c] = zero;
#pragma unroll
    for (int r = 0; r < kMaxSteps; ++r) {
        if (r >= q) break;
#pragma unroll
        for (int c = 0; c < kC; ++c) acc[c] = __fadd_rn(acc[c], word[r][c]);
    }
    if constexpr (WHEN_STORE) {
#pragma unroll
        for (int c = 0; c < kC; ++c)
            sts_kept(out_addr + c * kLane * 4, odd ? __fmul_rn(acc[c], 2.0f) : acc[c]);
    } else {
#pragma unroll
        for (int c = 0; c < kC; ++c) sink ^= __float_as_int(acc[c]);
    }
}

struct Carries {
    int a = 0, b = 0, c = 0, d = 0, e = 0, f = 0;
};

constexpr int kRowBlock = 14;   // rows a trip: jj % 7 and jj % 2 are constants of the unrolled row

// P8's rows in blocks of 14 from jj = 0, unrolled, so that a row's step
// count and parity are constants: with FULL (inner >= 7) a row's q is
// jj % 7 + 1 and its code has no branch; otherwise min(jj % 7 + 1, inner).
template <bool WHEN_STORE, bool CARRY6, bool FULL>
__device__ __forceinline__ void nested_rows(const float (&word)[kMaxSteps][kC], int n, int inner,
                                            uint32_t out_addr, int& sink, Carries& cs) {
    int mod3 = 0;     // jj % 3
    for (int j0 = 0; j0 < n; j0 += kRowBlock) {
#pragma unroll
        for (int u = 0; u < kRowBlock; ++u) {
            const int jj = j0 + u;
            if (jj >= n) break;
            const int q = FULL ? u % 7 + 1 : min(u % 7 + 1, inner);
            nested_row<WHEN_STORE>(word, q, u & 1, row_zero(jj), out_addr, sink);
            if constexpr (CARRY6) {
                cs.a += 1;
                cs.b += jj;
                cs.c ^= jj;
                cs.d += 2;
                cs.e += 3;
                cs.f += mod3;
                mod3 = mod3 == 2 ? 0 : mod3 + 1;
            }
        }
    }
}

// P8. A row of q steps adds, for r < q, the lane's gathered word of step r
// (window row r, k = rel - r) where it falls in the window. Those words do
// not change from row to row, so each lane gathers its 7 x 14 once into
// registers, +0.0 where it does not gather, as the plain version adds
// where(ok, word, 0): a sum that starts at +0.0 never becomes -0.0, so
// adding +0.0 leaves it unchanged and the sums stay exact. Every row starts
// from ``row_zero`` and adds its q terms again.
//
// The TPU kernel stores every row's sum into its (14, 128) out block in
// VMEM, which reaches device memory once, after the kernel; so does this
// one: the block is a shared-memory tile beside the window, lane l writes
// column l of each channel (no bank conflict, 14 STS a row), and after the
// row loop each lane copies its column to ``out`` (coalesced). The tile
// starts at zero, so n == 0 leaves ``out`` zero. Without the store the sums
// are folded into a word that is stored only where clock64() is negative,
// which it never is: an empty asm keeps them from the C++ compiler but not
// from ptxas, which dropped the whole row loop. The six carries stay in
// registers and lane 0 writes them at the end.
template <bool WHEN_STORE, bool CARRY6>
__global__ void __launch_bounds__(kLane)
    probe_route_nested_kernel(const int* __restrict__ n_ptr, const float* __restrict__ win,
                              const int* __restrict__ rel, float* __restrict__ out,
                              int* __restrict__ carry_out, int inner) {
    extern __shared__ __align__(16) float nest_win_s[];
    stage_win(win, nest_win_s);
    const int l = threadIdx.x;
    const int rl = rel[l];
    const int n = *n_ptr;
    float word[kMaxSteps][kC];
#pragma unroll
    for (int r = 0; r < kMaxSteps; ++r) {
        const int k = rl - r;
        const bool ok = (unsigned)k < (unsigned)kLane;
        const int kin = ok ? k : 0;     // a load in the window either way
#pragma unroll
        for (int c = 0; c < kC; ++c) word[r][c] = ok ? win_at(nest_win_s, c, r, kin) : 0.0f;
    }
    const uint32_t out_addr = smem_addr(nest_win_s + kWinFloats + l);    // column l of the tile
    if constexpr (WHEN_STORE) {
#pragma unroll
        for (int c = 0; c < kC; ++c) sts_kept(out_addr + c * kLane * 4, 0.0f);
    }
    int sink = 0;
    Carries cs;
    if (inner >= kMaxSteps)
        nested_rows<WHEN_STORE, CARRY6, true>(word, n, inner, out_addr, sink, cs);
    else
        nested_rows<WHEN_STORE, CARRY6, false>(word, n, inner, out_addr, sink, cs);
    if constexpr (WHEN_STORE) {
#pragma unroll
        for (int c = 0; c < kC; ++c) out[c * kLane + l] = lds_kept(out_addr + c * kLane * 4);
    } else {
        if (clock64() < 0) out[l] = __int_as_float(sink);
    }
    if (CARRY6 && l == 0) {
        carry_out[0] = cs.a;
        carry_out[1] = cs.b;
        carry_out[2] = cs.c;
        carry_out[3] = cs.d;
        carry_out[4] = cs.e;
        carry_out[5] = cs.f;
    }
}

// P9. A row's index word depends on jj alone, never on the sums, so the
// words of the next kDepth rows are in flight while the chain of sums runs
// as before. Each lane copies its own word of a row into a per-lane ring
// of kDepth slots by a 4-byte cp.async, one commit group a row, and waits
// on the groups in order (cp.async.wait_group kDepth - 2): the word of row
// jj + 1 is read one row ahead, so its shared-memory load overlaps row jj's
// gathers, and row jj's slot is refilled with row jj + kDepth. What is
// left is the gathers' bank conflicts (32 lanes at random k, about 3.5
// wavefronts a load). A queue in registers did not hide the latency; a
// channel-inner window with 16- or 8-byte loads, and gathering a row ahead,
// did not pay (the P9 ladder in PERF.md §6). The loop is unrolled by kDepth
// so that every slot index is a constant; (7 jj) % rows and (13 jj) % 450
// advance by a step and a wrap.
constexpr int kDepth = 16;

__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

template <bool STORE_DYN>
__global__ void __launch_bounds__(kLane)
    probe_route_bigread_kernel(const int* __restrict__ n_ptr, const int* __restrict__ idx,
                               int idx_rows, const float* __restrict__ win, float* __restrict__ out,
                               float* __restrict__ oslab) {
    extern __shared__ __align__(16) float big_win_s[];
    int* ring = reinterpret_cast<int*>(big_win_s + kWinFloats);    // (kDepth, 128)
    stage_win(win, big_win_s);
    const int l = threadIdx.x;
    const int n = *n_ptr;
    const int step = 7 % idx_rows;
    const int* col = idx + l;
    int next = 0;     // (7 j) % idx_rows of the next row j to copy
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
        cp_async_4(ring + u * kLane + l, col + (long long)next * kLane);
        cp_async_commit();
        next += step;
        if (next >= idx_rows) next -= idx_rows;
    }
    cp_async_wait<kDepth - 1>();
    int rl = ring[l];
    int orow = 0;     // (13 jj) % 450
    float acc[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[c] = 0.0f;
    for (int j0 = 0; j0 < n; j0 += kDepth) {
#pragma unroll
        for (int u = 0; u < kDepth; ++u) {
            const int jj = j0 + u;
            if (jj < n) {
                cp_async_wait<kDepth - 2>();
                const int rl_next = ring[((u + 1) % kDepth) * kLane + l];
                cp_async_4(ring + u * kLane + l, col + (long long)next * kLane);
                cp_async_commit();
                next += step;
                if (next >= idx_rows) next -= idx_rows;
                routed_step(big_win_s, jj & (kRows - 1), rl, acc);
                if constexpr (STORE_DYN) {
                    float* dst = oslab + ((long long)(jj & 1) * kC * kSlabRows + orow) * kLane + l;
#pragma unroll
                    for (int c = 0; c < kC; ++c) dst[(long long)c * kSlabRows * kLane] = acc[c];
                    orow += 13;
                    if (orow >= kSlabRows) orow -= kSlabRows;
                }
                rl = rl_next;
            }
        }
    }
    cp_async_wait<0>();
#pragma unroll
    for (int c = 0; c < kC; ++c) out[c * kLane + l] = acc[c];
}

constexpr int kWinBytes = kWinFloats * 4;
constexpr int kNestedBytes = kWinBytes + kC * kLane * 4;    // the window and the out tile
constexpr int kBigreadBytes = kWinBytes + kDepth * kLane * 4;  // the window and the ring

template <typename Kernel, typename... Args>
int launch_one(Kernel kernel, cudaStream_t stream, Args... args) {
    return launch_block(kernel, kLane, kWinBytes, stream, args...);
}

template <typename Kernel, typename... Args>
int launch_nested(Kernel kernel, cudaStream_t stream, Args... args) {
    return launch_block(kernel, kLane, kNestedBytes, stream, args...);
}

constexpr int kRow0Bytes = kRow0Floats * 4;

// A P6 variant's dynamic shared memory: empty stages the window, build+dot
// row 0, iota and dot nothing.
constexpr int loop_smem(int v) { return v == kEmpty ? kWinBytes : v == kBuildDot ? kRow0Bytes : 0; }

// P6 build+dot and P7 stage win by 16-byte loads.
bool quad_aligned(const float* p) { return ((uintptr_t)p & 15) == 0; }

template <int V>
int launch_loop(int unroll, cudaStream_t s, const int* n, const float* win, const int* rel,
                float* out) {
    constexpr int m = loop_smem(V);
    switch (unroll) {
        case 1: return launch_block(probe_route_loop_kernel<V, 1>, kLane, m, s, n, win, rel, out);
        case 4: return launch_block(probe_route_loop_kernel<V, 4>, kLane, m, s, n, win, rel, out);
        case 8: return launch_block(probe_route_loop_kernel<V, 8>, kLane, m, s, n, win, rel, out);
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// Each launcher runs one block on ``stream`` and returns cudaGetLastError()
// of the launch. n_ptr is a device int (the trip count); win is (14, 16, 128)
// f32, rel (128,) i32, out (14, 128) f32; P6 build+dot and P7 return
// cudaErrorMisalignedAddress unless win starts on a 16-byte boundary.

// P6: variant 0 empty, 1 iota, 2 dot, 3 build+dot; unroll 1, 4 or 8 steps a trip.
extern "C" int atray_probe_route_loop(const int* n_ptr, const float* win, const int* rel,
                                      float* out, int variant, int unroll, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (variant == kBuildDot && !quad_aligned(win)) return (int)cudaErrorMisalignedAddress;
    switch (variant) {
        case kEmpty: return launch_loop<kEmpty>(unroll, s, n_ptr, win, rel, out);
        case kIota: return launch_loop<kIota>(unroll, s, n_ptr, win, rel, out);
        case kDot: return launch_loop<kDot>(unroll, s, n_ptr, win, rel, out);
        case kBuildDot: return launch_loop<kBuildDot>(unroll, s, n_ptr, win, rel, out);
    }
    return (int)cudaErrorInvalidValue;
}

// P7.
extern "C" int atray_probe_route_dyn(const int* n_ptr, const float* win, const int* rel,
                                     float* out, void* stream) {
    if (!quad_aligned(win)) return (int)cudaErrorMisalignedAddress;
    return launch_one(probe_route_dyn_kernel, (cudaStream_t)stream, n_ptr, win, rel, out);
}

// P8: carry_out (6,) i32 receives the six carries when carry6 is set.
extern "C" int atray_probe_route_nested(const int* n_ptr, const float* win, const int* rel,
                                        float* out, int* carry_out, int inner, int when_store,
                                        int carry6, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (when_store && carry6)
        return launch_nested(probe_route_nested_kernel<true, true>, s, n_ptr, win, rel, out,
                             carry_out, inner);
    if (when_store)
        return launch_nested(probe_route_nested_kernel<true, false>, s, n_ptr, win, rel, out,
                             carry_out, inner);
    if (carry6)
        return launch_one(probe_route_nested_kernel<false, true>, s, n_ptr, win, rel, out,
                          carry_out, inner);
    return launch_one(probe_route_nested_kernel<false, false>, s, n_ptr, win, rel, out, carry_out,
                      inner);
}

// P9: idx (idx_rows, 128) i32 with values in [0, 128); oslab (2, 14, 450, 128)
// f32, written when store_dyn is set.
extern "C" int atray_probe_route_bigread(const int* n_ptr, const int* idx, int idx_rows,
                                         const float* win, float* out, float* oslab,
                                         int store_dyn, void* stream) {
    if (idx_rows <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (store_dyn)
        return launch_block(probe_route_bigread_kernel<true>, kLane, kBigreadBytes, s, n_ptr, idx,
                            idx_rows, win, out, oslab);
    return launch_block(probe_route_bigread_kernel<false>, kLane, kBigreadBytes, s, n_ptr, idx,
                        idx_rows, win, out, oslab);
}

// Launch shapes: out[0] threads a block, out[1] P8's dynamic shared memory
// with when_store (window and out tile; the window alone without), out[2]
// P9's, out[3] P9's index rows in flight, out[4] P6 build+dot's (row 0),
// out[5] P7's (the window).
extern "C" int atray_probe_route_shape(int* out) {
    out[0] = kLane;
    out[1] = kNestedBytes;
    out[2] = kBigreadBytes;
    out[3] = kDepth;
    out[4] = kRow0Bytes;
    out[5] = kWinBytes;
    return 0;
}
