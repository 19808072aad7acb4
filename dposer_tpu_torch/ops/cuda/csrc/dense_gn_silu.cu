// K1 dense_gn_silu: y = SiLU(GN32(bf16(A) @ W + tp) * gamma + beta) [+ residual]
//
// Replaces: one layer of the network forward inside the TPU reverse-diffusion
// kernel, dposer_tpu/ops/pallas/fused_em.py::_make_kernel via
// dposer_tpu/ops/pallas/score_net.py::bind_fwd (the bf16 dense matmul, the
// time-projection row add, group_norm_vpu and SiLU, and the block's h + h2).
//
// Bound on the H100: at the flagship layer ([500, 1024] x [1024, 1024]) the
// call moves ~6 MB (A fp32, W bf16, out fp32) against ~1.07 GFLOP, i.e.
// ~1.8 us of HBM time vs ~1.1 us of bf16 tensor-core time: bytes bound. The
// TPU kernel kept all weights on-core for the whole loop; 8 MB of bf16
// weights do not fit an SM's shared memory, so each layer is one launch and
// the weights are re-read from the 50 MB L2 every step.
//
// Design: the GEMM is dense_wgmma.cuh's Hopper main loop (a TMA ring with
// mbarriers, a producer warp, wgmma m64n64k16 with A from registers) wherever
// TMA can address A and W: every K = 1024 layer. The pre layer (A [B, 63], a 252-byte row
// stride TMA cannot take) and any misaligned operand go through
// dense_gemm.cuh's element-load loop (64x64 tile, bf16 WMMA). A GroupNorm
// group is N/32 consecutive features, so with N/32 <= 32 a 64-wide tile
// holds whole groups in the natural feature order: the epilogue
// (gn_epilogue.cuh, shared with K13 and K14) adds the time row, reduces each
// group with warp shuffles (two-pass mean/variance in fp32), applies the
// affine and SiLU and the residual, and writes fp32 once.
// Not yet: a persistent kernel whose epilogue overlaps the next tile's
// loads; a bf16 copy of the activations for the next layer.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dense_gemm.cuh"
#include "dense_wgmma.cuh"
#include "gn_epilogue.cuh"

namespace {

using namespace dposer::dense;

// The element-load path (K % 4 != 0 or misaligned operands).
template <int GS>
__global__ void __launch_bounds__(THREADS)
dense_gn_silu_kernel(const float* __restrict__ A, const __nv_bfloat16* __restrict__ W,
                     const float* __restrict__ tp, const float* __restrict__ gamma,
                     const float* __restrict__ beta, const float* residual, float* out,
                     int B, int K, int N) {
  __shared__ __align__(128) Smem sm;

  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  gemm_tile<false, false>(sm, A, nullptr, W, row0, col0, B, K, N);

  gn_silu_epilogue<GS, Out::kStore>(sm.c, tp, gamma, beta, residual, out, row0, col0, B, N);
}

// The Hopper path, on ring shape R.
template <int GS, class R>
__global__ void __launch_bounds__(THREADS)
dense_gn_silu_wgmma_kernel(const __grid_constant__ CUtensorMap tmA,
                           const __grid_constant__ CUtensorMap tmW,
                           const float* __restrict__ tp, const float* __restrict__ gamma,
                           const float* __restrict__ beta, const float* residual, float* out,
                           int B, int K, int N) {
  extern __shared__ uint8_t smem[];

  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const float* c = dposer::wgmma::gemm_tile<R>(smem, &tmA, &tmW, row0, col0, K);

  gn_silu_epilogue<GS, Out::kStore>(c, tp, gamma, beta, residual, out, row0, col0, B, N);
}

template <int GS, class R>
int launch_wgmma(dim3 grid, const float* A, const __nv_bfloat16* W, const float* tp,
                 const float* gamma, const float* beta, const float* residual, float* out, int B,
                 int K, int N, cudaStream_t stream) {
  CUtensorMap ma, mw;
  const int e = dposer::wgmma::gemm_maps<R>(&ma, &mw, A, W, B, K, N);
  if (e != 0) return e;
  return dposer::wgmma::launch<R, dense_gn_silu_wgmma_kernel<GS, R>>(
      grid, stream, ma, mw, tp, gamma, beta, residual, out, B, K, N);
}

template <int GS>
int launch(const float* A, const __nv_bfloat16* W, const float* tp, const float* gamma,
           const float* beta, const float* residual, float* out, int B, int K, int N,
           cudaStream_t stream) {
  const dim3 grid(N / BN, (B + BM - 1) / BM);
  if (!dposer::wgmma::tma_ok(A, W, K, N)) {
    dense_gn_silu_kernel<GS><<<grid, THREADS, 0, stream>>>(A, W, tp, gamma, beta, residual,
                                                            out, B, K, N);
    return static_cast<int>(cudaGetLastError());
  }
  return dposer::wgmma::one_wave(grid.x * grid.y)
             ? launch_wgmma<GS, dposer::wgmma::Wide>(grid, A, W, tp, gamma, beta, residual, out,
                                                     B, K, N, stream)
             : launch_wgmma<GS, dposer::wgmma::Narrow>(grid, A, W, tp, gamma, beta, residual,
                                                       out, B, K, N, stream);
}

}  // namespace

// A [B, K] fp32, W [K, N] bf16, tp/gamma/beta [N] fp32, residual (nullable)
// and out [B, N] fp32; out may alias residual. N/32 (the group size) must be
// a power of two <= 32 and N a multiple of 64. Returns 0, the error of a
// failed tensor-map encode, or cudaGetLastError() after the launch.
extern "C" int dposer_dense_gn_silu(const float* A, const void* W, const float* tp,
                                    const float* gamma, const float* beta,
                                    const float* residual, float* out, int B, int K, int N,
                                    void* stream) {
  const auto* w = static_cast<const __nv_bfloat16*>(W);
  const auto s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || K <= 0 || N % BN != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (N / 32) {
    case 2: return launch<2>(A, w, tp, gamma, beta, residual, out, B, K, N, s);
    case 4: return launch<4>(A, w, tp, gamma, beta, residual, out, B, K, N, s);
    case 8: return launch<8>(A, w, tp, gamma, beta, residual, out, B, K, N, s);
    case 16: return launch<16>(A, w, tp, gamma, beta, residual, out, B, K, N, s);
    case 32: return launch<32>(A, w, tp, gamma, beta, residual, out, B, K, N, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
