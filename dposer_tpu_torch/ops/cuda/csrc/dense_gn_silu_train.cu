// K10 dense_gn_silu_train: one layer of the score network's training forward,
//   h    = bf16(A) @ W + proj[row]              (proj bf16 [B, N], per row)
//   xhat = GN32(h), y = xhat * gamma + beta
//   out  = dropout(SiLU(y)) [+ residual]
// writing out (fp32), bf16(out) (the next dense layer's input, which the
// weight-gradient GEMMs read), bf16(xhat) and rstd per (row, group) for the
// backward kernel K12.
//
// Replaces: stack_fwd of the TPU train kernel,
// dposer_tpu/ops/pallas/fused_train.py::_make_kernel (:132-149), with the
// stash_in writes of :170-176; the on-core PRNG mask is dropout_hash.cuh's.
//
// Bound on the H100: at the flagship hidden layer ([1280, 1024] x
// [1024, 1024]) the call moves ~20 MB (A and out fp32, W, proj, the two bf16
// stashes, the residual where there is one) against 2.7 GFLOP: ~6 us of HBM
// time vs ~2.7 us of bf16 tensor-core time, bytes bound.
//
// Design: K1's block tile (dense_gemm.cuh: 64x64 outputs, bf16 WMMA,
// register-staged loads two K-steps ahead). A GroupNorm group is N/32
// consecutive features, so a 64-wide tile holds whole groups; the epilogue
// reduces each group with warp shuffles (two-pass mean and variance in fp32,
// as K1), applies the affine, SiLU and the dropout mask, and writes the four
// outputs once. The time term is a per-row bf16 tile, read in the epilogue.
// Not yet: cp.async/TMA pipelines, wgmma, reading the bf16 stash as A.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dense_gemm.cuh"
#include "dropout_hash.cuh"

namespace {

using namespace dposer::dense;
namespace dr = dposer::dropout;

template <int GS, bool VEC>
__global__ void __launch_bounds__(THREADS)
dense_gn_silu_train_kernel(const float* __restrict__ A, const __nv_bfloat16* __restrict__ W,
                           const __nv_bfloat16* __restrict__ proj,
                           const float* __restrict__ gamma, const float* __restrict__ beta,
                           const float* residual, float* out, __nv_bfloat16* __restrict__ stash,
                           __nv_bfloat16* __restrict__ xhat_out, float* __restrict__ rstd_out,
                           uint32_t seed, int layer, uint32_t keep_thresh, float inv_keep, int B,
                           int K, int N) {
  __shared__ __align__(128) Smem sm;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  gemm_tile<VEC, false>(sm, A, nullptr, W, row0, col0, B, K, N);

  // Epilogue: warp w takes rows w, w+8, ...; lane l holds columns l and l+32,
  // so a group of GS features is GS consecutive lanes. The warp's proj and
  // residual values are all requested before the first is used.
  constexpr int ROWS_PER_WARP = BM / (THREADS / 32);
  constexpr float inv_gs = 1.0f / GS;
  const bool use_dropout = keep_thresh < dr::KEEP_ALL;
  const uint32_t lkey = dr::layer_key(seed, layer);
  float gv[2], bv[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    gv[half] = gamma[col0 + half * 32 + lane];
    bv[half] = beta[col0 + half * 32 + lane];
  }
  float pj[ROWS_PER_WARP][2], res[ROWS_PER_WARP][2];
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int gr = row0 + warp + i * (THREADS / 32);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const size_t o = static_cast<size_t>(gr) * N + col0 + half * 32 + lane;
      pj[i][half] = gr < B ? __bfloat162float(proj[o]) : 0.0f;
      res[i][half] = (residual != nullptr && gr < B) ? residual[o] : 0.0f;
    }
  }
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int r = warp + i * (THREADS / 32);
    const int gr = row0 + r;
    if (gr >= B) continue;  // uniform across the warp
    const uint32_t rkey = dr::row_key(lkey, gr);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gc = col0 + half * 32 + lane;
      const float v = sm.c[r * C_LD + half * 32 + lane] + pj[i][half];
      const float mean = group_sum<GS>(v) * inv_gs;
      const float d = v - mean;
      const float var = group_sum<GS>(d * d) * inv_gs;
      const float rs = rsqrtf(var + GN_EPS);
      const float xh = d * rs;
      const float y = xh * gv[half] + bv[half];
      float s = y / (1.0f + __expf(-y));
      if (use_dropout) s *= dr::keep(rkey, gc, keep_thresh) ? inv_keep : 0.0f;
      const float o = s + res[i][half];
      const size_t off = static_cast<size_t>(gr) * N + gc;
      out[off] = o;
      stash[off] = __float2bfloat16_rn(o);
      xhat_out[off] = __float2bfloat16_rn(xh);
      if (gc % GS == 0) rstd_out[static_cast<size_t>(gr) * 32 + gc / GS] = rs;
    }
  }
}

template <int GS, bool VEC>
void launch(const float* A, const __nv_bfloat16* W, const __nv_bfloat16* proj,
            const float* gamma, const float* beta, const float* residual, float* out,
            __nv_bfloat16* stash, __nv_bfloat16* xhat, float* rstd, uint32_t seed, int layer,
            uint32_t keep_thresh, float inv_keep, int B, int K, int N, cudaStream_t stream) {
  const dim3 grid(N / BN, (B + BM - 1) / BM);
  dense_gn_silu_train_kernel<GS, VEC><<<grid, THREADS, 0, stream>>>(
      A, W, proj, gamma, beta, residual, out, stash, xhat, rstd, seed, layer, keep_thresh,
      inv_keep, B, K, N);
}

template <int GS>
void launch_gs(bool vec, const float* A, const __nv_bfloat16* W, const __nv_bfloat16* proj,
               const float* gamma, const float* beta, const float* residual, float* out,
               __nv_bfloat16* stash, __nv_bfloat16* xhat, float* rstd, uint32_t seed, int layer,
               uint32_t keep_thresh, float inv_keep, int B, int K, int N, cudaStream_t stream) {
  if (vec)
    launch<GS, true>(A, W, proj, gamma, beta, residual, out, stash, xhat, rstd, seed, layer,
                     keep_thresh, inv_keep, B, K, N, stream);
  else
    launch<GS, false>(A, W, proj, gamma, beta, residual, out, stash, xhat, rstd, seed, layer,
                      keep_thresh, inv_keep, B, K, N, stream);
}

}  // namespace

// A [B, K] fp32, W [K, N] bf16, proj [B, N] bf16, gamma/beta [N] fp32,
// residual (nullable) and out [B, N] fp32 (out may alias residual), stash and
// xhat [B, N] bf16, rstd [B, 32] fp32. N/32 (the group size) must be a power
// of two <= 32 and N a multiple of 64. Returns cudaGetLastError().
extern "C" int dposer_dense_gn_silu_train(const float* A, const void* W, const void* proj,
                                          const float* gamma, const float* beta,
                                          const float* residual, float* out, void* stash,
                                          void* xhat, float* rstd, unsigned int seed, int layer,
                                          unsigned int keep_thresh, float inv_keep, int B, int K,
                                          int N, void* stream) {
  const auto* w = static_cast<const __nv_bfloat16*>(W);
  const auto* p = static_cast<const __nv_bfloat16*>(proj);
  auto* st = static_cast<__nv_bfloat16*>(stash);
  auto* xh = static_cast<__nv_bfloat16*>(xhat);
  const auto s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || K <= 0 || N % BN != 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(W) % 16 == 0;
  switch (N / 32) {
    case 2: launch_gs<2>(vec, A, w, p, gamma, beta, residual, out, st, xh, rstd, seed, layer, keep_thresh, inv_keep, B, K, N, s); break;
    case 4: launch_gs<4>(vec, A, w, p, gamma, beta, residual, out, st, xh, rstd, seed, layer, keep_thresh, inv_keep, B, K, N, s); break;
    case 8: launch_gs<8>(vec, A, w, p, gamma, beta, residual, out, st, xh, rstd, seed, layer, keep_thresh, inv_keep, B, K, N, s); break;
    case 16: launch_gs<16>(vec, A, w, p, gamma, beta, residual, out, st, xh, rstd, seed, layer, keep_thresh, inv_keep, B, K, N, s); break;
    case 32: launch_gs<32>(vec, A, w, p, gamma, beta, residual, out, st, xh, rstd, seed, layer, keep_thresh, inv_keep, B, K, N, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
