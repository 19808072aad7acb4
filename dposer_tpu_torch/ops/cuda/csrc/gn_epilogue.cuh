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
#pragma once

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

}  // namespace dense
}  // namespace dposer
