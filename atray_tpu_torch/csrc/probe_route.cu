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
// the "dot" its 14 loads and adds), with the plain versions' op order: one
// selected term added per step, so the sums are exact against them.
//
// Launch shape: one block of 128 threads, thread l owning lane l and the 14
// sums in registers; win (14, 16, 128) f32 = 114,688 B sits in shared memory
// (what the TPU kept in VMEM); P9's idx table (8.3 MB) and slab (6.45 MB)
// stay in device memory. The step count n is read from device memory inside
// the kernel, as the TPU read it from SMEM, so the compiler cannot unroll the
// loop by a known count. Where the TPU kernel's output is undefined (P8
// without when_store) the sums are kept live by an empty asm and never
// stored; P8's six carries are written to carry_out so that they are
// computed at all.
//
// What bounds it: one SM's issue rate over a loop-carried chain; the card
// bound (operations the function needs over 67 TFLOP/s, or its bytes) is
// reported with the one-SM bound (x 132).

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

// acc[c] += win[c, row, rel - r] where 0 <= rel - r < 128.
__device__ __forceinline__ void routed_step(const float* win_s, int row, int k, float (&acc)[kC]) {
    if ((unsigned)k < (unsigned)kLane) {
#pragma unroll
        for (int c = 0; c < kC; ++c) acc[c] = __fadd_rn(acc[c], win_at(win_s, c, row, k));
    }
}

template <int V>
__device__ __forceinline__ void loop_step(const float* win_s, int r, int rl, int l,
                                          float (&acc)[kC]) {
    if constexpr (V == kEmpty) {
        asm volatile("");
    } else if constexpr (V == kIota) {
        // row 0 of the one-hot, times 0, plus 1
        const float oh = (r == rl) ? 1.0f : 0.0f;
        const float t = __fadd_rn(__fmul_rn(oh, 0.0f), 1.0f);
#pragma unroll
        for (int c = 0; c < kC; ++c) acc[c] = __fadd_rn(acc[c], t);
    } else if constexpr (V == kDot) {
        // the product with the identity: each lane adds its own column
#pragma unroll
        for (int c = 0; c < kC; ++c) acc[c] = __fadd_rn(acc[c], win_at(win_s, c, 0, l));
    } else {
        routed_step(win_s, 0, rl - r, acc);
    }
}

template <int V, int UNROLL>
__global__ void __launch_bounds__(kLane)
    probe_route_loop_kernel(const int* __restrict__ n_ptr, const float* __restrict__ win,
                            const int* __restrict__ rel, float* __restrict__ out) {
    extern __shared__ __align__(16) float loop_win_s[];
    stage_win(win, loop_win_s);
    const int l = threadIdx.x;
    const int rl = rel[l];
    const int n = *n_ptr;
    float acc[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[c] = 0.0f;
    for (int i = 0; i < n; ++i) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) loop_step<V>(loop_win_s, i * UNROLL + u, rl, l, acc);
    }
#pragma unroll
    for (int c = 0; c < kC; ++c) out[c * kLane + l] = acc[c];
}

__global__ void __launch_bounds__(kLane)
    probe_route_dyn_kernel(const int* __restrict__ n_ptr, const float* __restrict__ win,
                           const int* __restrict__ rel, float* __restrict__ out) {
    extern __shared__ __align__(16) float dyn_win_s[];
    stage_win(win, dyn_win_s);
    const int l = threadIdx.x;
    const int rl = rel[l];
    const int n = *n_ptr;
    float acc[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[c] = 0.0f;
    for (int r = 0; r < n; ++r) routed_step(dyn_win_s, r & (kRows - 1), rl - r, acc);
#pragma unroll
    for (int c = 0; c < kC; ++c) out[c * kLane + l] = acc[c];
}

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
    int ca = 0, cb = 0, cc = 0, cd = 0, ce = 0, cf = 0;
    for (int jj = 0; jj < n; ++jj) {
        const int q = min(jj % 7 + 1, inner);
        float acc[kC];
#pragma unroll
        for (int c = 0; c < kC; ++c) acc[c] = 0.0f;
        for (int r = 0; r < q; ++r) routed_step(nest_win_s, r & (kRows - 1), rl - r, acc);
        if constexpr (WHEN_STORE) {
            const bool odd = (jj & 1) != 0;
#pragma unroll
            for (int c = 0; c < kC; ++c) out[c * kLane + l] = odd ? __fmul_rn(acc[c], 2.0f) : acc[c];
        } else {
#pragma unroll
            for (int c = 0; c < kC; ++c) asm volatile("" ::"f"(acc[c]));
        }
        if constexpr (CARRY6) {
            ca += 1;
            cb += jj;
            cc ^= jj;
            cd += 2;
            ce += 3;
            cf += jj % 3;
        }
    }
    if (CARRY6 && l == 0) {
        carry_out[0] = ca;
        carry_out[1] = cb;
        carry_out[2] = cc;
        carry_out[3] = cd;
        carry_out[4] = ce;
        carry_out[5] = cf;
    }
}

template <bool STORE_DYN>
__global__ void __launch_bounds__(kLane)
    probe_route_bigread_kernel(const int* __restrict__ n_ptr, const int* __restrict__ idx,
                               int idx_rows, const float* __restrict__ win, float* __restrict__ out,
                               float* __restrict__ oslab) {
    extern __shared__ __align__(16) float big_win_s[];
    stage_win(win, big_win_s);
    const int l = threadIdx.x;
    const int n = *n_ptr;
    float acc[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[c] = 0.0f;
    for (int jj = 0; jj < n; ++jj) {
        const int j = (int)(((long long)jj * 7) % idx_rows);
        const int rl = idx[(long long)j * kLane + l];
        routed_step(big_win_s, jj & (kRows - 1), rl, acc);
        if constexpr (STORE_DYN) {
            const int orow = (int)(((long long)jj * 13) % kSlabRows);
            float* dst = oslab + ((long long)(jj & 1) * kC * kSlabRows + orow) * kLane + l;
#pragma unroll
            for (int c = 0; c < kC; ++c) dst[(long long)c * kSlabRows * kLane] = acc[c];
        }
    }
#pragma unroll
    for (int c = 0; c < kC; ++c) out[c * kLane + l] = acc[c];
}

constexpr int kWinBytes = kWinFloats * 4;

template <typename Kernel, typename... Args>
int launch_one(Kernel kernel, cudaStream_t stream, Args... args) {
    return launch_block(kernel, kLane, kWinBytes, stream, args...);
}

template <int V>
int launch_loop(int unroll, cudaStream_t s, const int* n, const float* win, const int* rel,
                float* out) {
    switch (unroll) {
        case 1: return launch_one(probe_route_loop_kernel<V, 1>, s, n, win, rel, out);
        case 4: return launch_one(probe_route_loop_kernel<V, 4>, s, n, win, rel, out);
        case 8: return launch_one(probe_route_loop_kernel<V, 8>, s, n, win, rel, out);
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// Each launcher runs one block on ``stream`` and returns cudaGetLastError()
// of the launch. n_ptr is a device int (the trip count); win is (14, 16, 128)
// f32, rel (128,) i32, out (14, 128) f32.

// P6: variant 0 empty, 1 iota, 2 dot, 3 build+dot; unroll 1, 4 or 8 steps a trip.
extern "C" int atray_probe_route_loop(const int* n_ptr, const float* win, const int* rel,
                                      float* out, int variant, int unroll, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
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
    return launch_one(probe_route_dyn_kernel, (cudaStream_t)stream, n_ptr, win, rel, out);
}

// P8: carry_out (6,) i32 receives the six carries when carry6 is set.
extern "C" int atray_probe_route_nested(const int* n_ptr, const float* win, const int* rel,
                                        float* out, int* carry_out, int inner, int when_store,
                                        int carry6, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (when_store && carry6)
        return launch_one(probe_route_nested_kernel<true, true>, s, n_ptr, win, rel, out, carry_out,
                          inner);
    if (when_store)
        return launch_one(probe_route_nested_kernel<true, false>, s, n_ptr, win, rel, out,
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
        return launch_one(probe_route_bigread_kernel<true>, s, n_ptr, idx, idx_rows, win, out,
                          oslab);
    return launch_one(probe_route_bigread_kernel<false>, s, n_ptr, idx, idx_rows, win, out, oslab);
}
