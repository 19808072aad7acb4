// K7 dense_gn_silu_jvp: one hidden layer of the score network with its
// forward-mode tangent,
//   h  = bf16(A) @ W + tp            dh  = bf16(dA) @ W
//   y  = GN32(h) * gamma + beta      dy  = its tangent along dh
//   out = SiLU(y) [+ residual]       dout = SiLU'(y) * dy [+ dresidual]
//
// Replaces: one layer of dposer_tpu/ops/pallas/score_net.py::bind_fwd_jvp
// (mm, gnorm_jvp, silu_jvp and the block's h + h2, dh + dh2) inside the TPU
// likelihood kernel, dposer_tpu/ops/pallas/fused_lik.py::_make_kernel. The
// tangent rules, written out by hand as there:
//   GN:   mu = mean_g(h), d = h - mu, a = rsqrt(mean_g(d^2) + eps)
//         dmu = mean_g(dh), dvar = 2 * mean_g(d * dh), da = -a^3 * dvar / 2
//         dy = ((dh - dmu) * a + d * da) * gamma
//   SiLU: sig = sigmoid(y); dout = sig * (1 + y * (1 - sig)) * dy
// mean_g(d * dh) equals the TPU kernel's mean_g(h * dh) - mu * dmu without its
// cancellation, and the variance is the two-pass form K1 uses.
//
// Bound on the H100: at the likelihood's layer ([50, 1024] pair x
// [1024, 1024]) the call moves ~3.3 MB (W bf16 2.1 MB; A, dA, out, dout and
// the residual pair fp32) against 0.21 GFLOP: ~1.0 us of HBM time vs ~0.2 us
// of bf16 tensor-core time: bytes bound, and the weights are most of the bytes.
//
// Design: dense_gemm.cuh's 64x64 block tile in its stacked form: tile rows
// 0..31 are 32 rows of A and tile rows 32..63 the same rows of dA, so every W
// tile staged in shared memory feeds the primal and the tangent product, and
// the kernel keeps K1's 36 KB of static shared memory (two full 64-row fp32
// accumulator tiles beside K1's staging buffers would pass the 48 KB limit;
// the tile was shrunk to 32 primal rows instead of opting in to dynamic shared
// memory). 50 rows are two such tiles: 32 blocks. The epilogue reads a row's
// h and dh 32 tile rows apart and reduces the four group sums (h, d^2, dh,
// d*dh) with warp shuffles over the group's GS consecutive lanes.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dense_gemm.cuh"

namespace {

using namespace dposer::dense;

constexpr int ROWS = BM / 2;  // primal rows of a block

template <int GS, bool VEC>
__global__ void __launch_bounds__(THREADS)
dense_gn_silu_jvp_kernel(const float* __restrict__ A, const float* __restrict__ dA,
                         const __nv_bfloat16* __restrict__ W, const float* __restrict__ tp,
                         const float* __restrict__ gamma, const float* __restrict__ beta,
                         const float* residual, const float* dresidual, float* out,
                         float* dout, int B, int K, int N) {
  __shared__ __align__(128) Smem sm;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = blockIdx.y * ROWS;
  const int col0 = blockIdx.x * BN;
  gemm_tile<VEC, true>(sm, A, dA, W, row0, col0, B, K, N);

  // Epilogue: warp w takes rows w, w+8, ... of the 32; lane l holds columns l
  // and l+32, so a group of GS features is GS consecutive lanes.
  constexpr int ROWS_PER_WARP = ROWS / (THREADS / 32);
  constexpr float inv_gs = 1.0f / GS;
  float tpv[2], gv[2], bv[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int gc = col0 + half * 32 + lane;
    tpv[half] = tp[gc];
    gv[half] = gamma[gc];
    bv[half] = beta[gc];
  }
  float res[ROWS_PER_WARP][2], dres[ROWS_PER_WARP][2];
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int gr = row0 + warp + i * (THREADS / 32);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const size_t o = static_cast<size_t>(gr) * N + col0 + half * 32 + lane;
      const bool live = residual != nullptr && gr < B;
      res[i][half] = live ? residual[o] : 0.0f;
      dres[i][half] = live ? dresidual[o] : 0.0f;
    }
  }
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int r = warp + i * (THREADS / 32);
    const int gr = row0 + r;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = half * 32 + lane;
      const float h = sm.c[r * C_LD + c] + tpv[half];
      const float dh = sm.c[(r + ROWS) * C_LD + c];
      const float mu = group_sum<GS>(h) * inv_gs;
      const float d = h - mu;
      const float var = group_sum<GS>(d * d) * inv_gs;
      const float a = rsqrtf(var + GN_EPS);
      const float dmu = group_sum<GS>(dh) * inv_gs;
      const float dvar = 2.0f * group_sum<GS>(d * dh) * inv_gs;
      const float da = -0.5f * a * a * a * dvar;
      const float y = d * a * gv[half] + bv[half];
      const float dy = ((dh - dmu) * a + d * da) * gv[half];
      const float sig = 1.0f / (1.0f + __expf(-y));
      if (gr < B) {
        const size_t o = static_cast<size_t>(gr) * N + col0 + c;
        out[o] = y * sig + res[i][half];
        dout[o] = sig * (1.0f + y * (1.0f - sig)) * dy + dres[i][half];
      }
    }
  }
}

template <int GS>
void launch(bool vec, const float* A, const float* dA, const __nv_bfloat16* W, const float* tp,
            const float* gamma, const float* beta, const float* residual,
            const float* dresidual, float* out, float* dout, int B, int K, int N,
            cudaStream_t stream) {
  const dim3 grid(N / BN, (B + ROWS - 1) / ROWS);
  if (vec)
    dense_gn_silu_jvp_kernel<GS, true><<<grid, THREADS, 0, stream>>>(
        A, dA, W, tp, gamma, beta, residual, dresidual, out, dout, B, K, N);
  else
    dense_gn_silu_jvp_kernel<GS, false><<<grid, THREADS, 0, stream>>>(
        A, dA, W, tp, gamma, beta, residual, dresidual, out, dout, B, K, N);
}

}  // namespace

// A, dA [B, K] fp32, W [K, N] bf16, tp/gamma/beta [N] fp32; residual and
// dresidual (both or neither nullable), out and dout [B, N] fp32; out may
// alias residual and dout dresidual. N/32 (the group size) must be a power of
// two <= 32 and N a multiple of 64. Returns cudaGetLastError().
extern "C" int dposer_dense_gn_silu_jvp(const float* A, const float* dA, const void* W,
                                        const float* tp, const float* gamma,
                                        const float* beta, const float* residual,
                                        const float* dresidual, float* out, float* dout, int B,
                                        int K, int N, void* stream) {
  const auto* w = static_cast<const __nv_bfloat16*>(W);
  const auto s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || K <= 0 || N % BN != 0 || (residual == nullptr) != (dresidual == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dA) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(W) % 16 == 0;
  switch (N / 32) {
    case 2: launch<2>(vec, A, dA, w, tp, gamma, beta, residual, dresidual, out, dout, B, K, N, s); break;
    case 4: launch<4>(vec, A, dA, w, tp, gamma, beta, residual, dresidual, out, dout, B, K, N, s); break;
    case 8: launch<8>(vec, A, dA, w, tp, gamma, beta, residual, dresidual, out, dout, B, K, N, s); break;
    case 16: launch<16>(vec, A, dA, w, tp, gamma, beta, residual, dresidual, out, dout, B, K, N, s); break;
    case 32: launch<32>(vec, A, dA, w, tp, gamma, beta, residual, dresidual, out, dout, B, K, N, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
