// The GroupNorm + SiLU epilogue of the network's hidden layers, shared by K1
// dense_gn_silu, K13 dense_gn_silu_int8 and K14 chain_link's GN mode:
//   y = SiLU(GN_GS(c + tp) * gamma + beta) [+ residual]
// on the 64x64 fp32 tile a GEMM main loop left in shared memory.
//
// Warp w takes tile rows w, w+8, ...; lane l holds columns l and l+32, so a
// group of GS consecutive features is GS consecutive lanes and its two-pass
// mean and variance are warp shuffles. The per-column rows (time projection,
// GN affine) are read once into registers, and the warp's residual values are
// all requested before the first is used.
//
// K13 and K1 take gn_silu_epilogue_q: the same arithmetic with the warp's
// sixteen (row, half) chains interleaved shuffle by shuffle, the per-column
// rows read beforehand (load_cols: before the wait of a programmatic
// launch), and an optional copy of what it stores, taken after the
// residual: for K13 int8, out_q[r, c] = quant8(y, qnext[c]), for K1 bf16,
// out_q[r, c] = __float2bfloat16_rn(y).
// Either is the next layer's input, which that layer's main loop reads by
// TMA as it is (dense_wgmma_int8.cuh, dense_wgmma_ss.cuh) and which
// quantizing or rounding the fp32 out would give, bit for bit.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>

#include "dense_gemm.cuh"

namespace dposer {
namespace dense {

// kStore: out = y + residual. kUpdate: out = 0.5*out + 1e-3*y, the
// microbenchmarks' state update (unfused multiplies and add, as the plain
// version rounds them; residual unused).
enum class Out { kStore, kUpdate };

// c: the tile [BM][C_LD] fp32 in shared memory. tp, gamma, beta: [N] rows, or
// nullptr for 0, 1 and 0. residual: [B, N] or nullptr; out [B, N] may alias it.
template <int GS, Out MODE>
__device__ __forceinline__ void gn_silu_epilogue(const float* c, const float* __restrict__ tp,
                                                 const float* __restrict__ gamma,
                                                 const float* __restrict__ beta,
                                                 const float* residual, float* out, int row0,
                                                 int col0, int B, int N) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  constexpr int ROWS_PER_WARP = BM / (THREADS / 32);
  constexpr float inv_gs = 1.0f / GS;
  float tpv[2], gv[2], bv[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int gc = col0 + half * 32 + lane;
    tpv[half] = tp != nullptr ? tp[gc] : 0.0f;
    gv[half] = gamma != nullptr ? gamma[gc] : 1.0f;
    bv[half] = beta != nullptr ? beta[gc] : 0.0f;
  }
  const float* prev = MODE == Out::kUpdate ? out : residual;
  float res[ROWS_PER_WARP][2];
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int gr = row0 + warp + i * (THREADS / 32);
#pragma unroll
    for (int half = 0; half < 2; ++half)
      res[i][half] = (prev != nullptr && gr < B)
                         ? prev[static_cast<size_t>(gr) * N + col0 + half * 32 + lane]
                         : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int r = warp + i * (THREADS / 32);
    const int gr = row0 + r;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int cc = half * 32 + lane;
      const float v = c[r * C_LD + cc] + tpv[half];
      const float mean = group_sum<GS>(v) * inv_gs;
      const float d = v - mean;
      const float var = group_sum<GS>(d * d) * inv_gs;
      float y = d * rsqrtf(var + GN_EPS) * gv[half] + bv[half];
      if constexpr (MODE == Out::kStore) {
        y = y / (1.0f + __expf(-y)) + res[i][half];
      } else {
        y = y / (1.0f + __expf(-y));
        y = __fadd_rn(__fmul_rn(0.5f, res[i][half]), __fmul_rn(1e-3f, y));
      }
      if (gr < B) out[static_cast<size_t>(gr) * N + col0 + cc] = y;
    }
  }
}

// The GS-lane group sums of M values at once, level by level: each value
// gets group_sum<GS>'s adds in group_sum's order, and the M shuffles of a
// level are independent, so their latencies overlap.
template <int GS, int M>
__device__ __forceinline__ void group_sums(float (&v)[M]) {
#pragma unroll
  for (int off = GS / 2; off > 0; off >>= 1)
#pragma unroll
    for (int k = 0; k < M; ++k) v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
}

// The per-column rows of the epilogue in a thread's two columns col0 + lane
// and col0 + 32 + lane: the time projection, the GroupNorm affine and, for
// an int8 copy, the next layer's quantization row. They are a launch's
// constants (tables built with the sampler), so a programmatic launch
// (mbarrier.cuh) reads them before its wait and keeps them in registers
// through its main loop.
struct Cols {
  float tp[2], g[2], b[2], qn[2];
};

template <class T>
__device__ __forceinline__ Cols load_cols(const float* __restrict__ tp,
                                          const float* __restrict__ gamma,
                                          const float* __restrict__ beta, int col0,
                                          const float* __restrict__ qnext, const T* out_q) {
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  const int lane = threadIdx.x % 32;
  Cols c;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int gc = col0 + half * 32 + lane;
    c.tp[half] = tp != nullptr ? tp[gc] : 0.0f;
    c.g[half] = gamma != nullptr ? gamma[gc] : 1.0f;
    c.b[half] = beta != nullptr ? beta[gc] : 0.0f;
    c.qn[half] = kInt8 && out_q != nullptr ? qnext[gc] : 0.0f;
  }
  return c;
}

// The epilogue of K13 and K1: gn_silu_epilogue<GS, Out::kStore>'s arithmetic
// on the warp's rows and columns, the sixteen GroupNorm chains of a warp
// interleaved (one chain's ten dependent shuffles at a time leave the warp
// waiting on each), and the copy of out for the next layer: T = int8_t
// (K13) with qnext [N] and out_q [B, N] int8 (out_q nullable) its int8
// copy; T = __nv_bfloat16 (K1) with out_q [B, N] bf16 (nullable; qnext not
// read) its bf16 copy, and out nullable (a layer whose fp32 output nothing
// reads writes the copy alone). `cols`: load_cols of the same rows.
template <int GS, class T>
__device__ __forceinline__ void gn_silu_epilogue_q(const float* c, const Cols& cols,
                                                   const float* residual, float* out, int row0,
                                                   int col0, int B, int N, T* out_q) {
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  static_assert(kInt8 || std::is_same<T, __nv_bfloat16>::value, "an int8 or a bf16 copy");
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  constexpr int WARPS = THREADS / 32;
  constexpr int M = 2 * (BM / WARPS);  // (row, half) pairs a warp: k = 2 i + half
  constexpr float inv_gs = 1.0f / GS;
  float res[M], v[M], s[M];
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const int r = warp + (k / 2) * WARPS, gr = row0 + r, cc = (k % 2) * 32 + lane;
    res[k] = (residual != nullptr && gr < B) ? residual[static_cast<size_t>(gr) * N + col0 + cc]
                                             : 0.0f;
    v[k] = c[r * C_LD + cc] + cols.tp[k % 2];
    s[k] = v[k];
  }
  group_sums<GS>(s);
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const float mean = s[k] * inv_gs;
    v[k] = v[k] - mean;  // d
    s[k] = v[k] * v[k];
  }
  group_sums<GS>(s);
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const int r = warp + (k / 2) * WARPS, gr = row0 + r, half = k % 2;
    const float var = s[k] * inv_gs;
    float y = v[k] * rsqrtf(var + GN_EPS) * cols.g[half] + cols.b[half];
    y = y / (1.0f + __expf(-y)) + res[k];
    if (gr < B) {
      const size_t o = static_cast<size_t>(gr) * N + col0 + half * 32 + lane;
      if constexpr (kInt8) {
        out[o] = y;
        if (out_q != nullptr) out_q[o] = static_cast<int8_t>(quant8(y, cols.qn[half]));
      } else {
        if (out != nullptr) out[o] = y;
        if (out_q != nullptr) out_q[o] = __float2bfloat16_rn(y);
      }
    }
  }
}

}  // namespace dense
}  // namespace dposer
