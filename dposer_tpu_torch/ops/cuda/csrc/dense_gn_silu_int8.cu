// K13 dense_gn_silu_int8: y = SiLU(GN32(float(q(A) @ Wq^T) * qs + tp) * gamma + beta)
//                              [+ residual],  q(a) = clamp(rint(a * qinv), -127, 127)
//
// Replaces: one hidden layer of the TPU reverse-diffusion kernel in its opt-in
// W8A8 serving mode, dposer_tpu/ops/pallas/fused_em.py::_make_kernel (its
// quant_inv refs, :62, :104-110) via dposer_tpu/ops/pallas/score_net.py::
// bind_fwd's quant ``mm`` (:337-360): per-output-column int8 weights, the
// activation quantized by a per-tensor immediate or a per-channel smooth_fold
// row (one row layout here serves both), int32 accumulation, one fp32 rescale
// row, then the time row, GroupNorm, SiLU and the block's residual.
//
// Bound on the H100: at the flagship layer ([500, 1024] x [1024, 1024] +
// residual) the call moves ~7.2 MB (A, residual and out fp32, Wq int8) against
// ~1.07 G int8 operations: ~2.15 us of HBM time vs ~0.54 us at the int8 tensor
// rate, so bytes bound, as K1 is. Int8 weights save 1 MB of K1's 6 MB: the
// gain is bounded by the fp32 activations, which stay fp32 in device memory
// because GroupNorm and the residual need them.
//
// Design: dense_gemm_int8.cuh's main loop (K1's 64x64 tile and register
// staging, quantizing A as it is staged, mma.sync m16n8k32 s8) and K1's
// epilogue (gn_epilogue.cuh). Not yet: wgmma, TMA, an int8 copy of the
// activations written by the previous layer's epilogue.

#include <cstdint>

#include <cuda_runtime.h>

#include "dense_gemm_int8.cuh"
#include "gn_epilogue.cuh"

namespace {

using dposer::dense::BM;
using dposer::dense::BN;
using dposer::dense::Out;
using dposer::dense::THREADS;

template <int GS, bool VEC>
__global__ void __launch_bounds__(THREADS)
dense_gn_silu_int8_kernel(const float* __restrict__ A, const int8_t* __restrict__ Wq,
                          const float* __restrict__ qinv, const float* __restrict__ qs,
                          const float* __restrict__ tp, const float* __restrict__ gamma,
                          const float* __restrict__ beta, const float* residual, float* out,
                          int B, int K, int N) {
  __shared__ __align__(128) dposer::dense8::Smem sm;

  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  dposer::dense8::gemm_tile_int8<VEC>(sm, A, qinv, Wq, qs, row0, col0, B, K);
  dposer::dense::gn_silu_epilogue<GS, Out::kStore>(sm.c, tp, gamma, beta, residual, out, row0,
                                                   col0, B, N);
}

template <int GS>
void launch_gs(bool vec, const float* A, const int8_t* Wq, const float* qinv, const float* qs,
               const float* tp, const float* gamma, const float* beta, const float* residual,
               float* out, int B, int K, int N, cudaStream_t stream) {
  const dim3 grid(N / BN, (B + BM - 1) / BM);
  if (vec)
    dense_gn_silu_int8_kernel<GS, true><<<grid, THREADS, 0, stream>>>(
        A, Wq, qinv, qs, tp, gamma, beta, residual, out, B, K, N);
  else
    dense_gn_silu_int8_kernel<GS, false><<<grid, THREADS, 0, stream>>>(
        A, Wq, qinv, qs, tp, gamma, beta, residual, out, B, K, N);
}

}  // namespace

// A [B, K] fp32, Wq [N, K] int8, qinv [K] fp32 (the activation quantization
// row), qs [N] fp32 (the rescale row), tp/gamma/beta [N] fp32, residual
// (nullable) and out [B, N] fp32; out may alias residual. N/32 (the group
// size) must be a power of two <= 32 and N a multiple of 64; K <= 1024 keeps
// the int32 sums exact in fp32. Returns cudaGetLastError().
extern "C" int dposer_dense_gn_silu_int8(const float* A, const void* Wq, const float* qinv,
                                         const float* qs, const float* tp, const float* gamma,
                                         const float* beta, const float* residual, float* out,
                                         int B, int K, int N, void* stream) {
  const auto* w = static_cast<const int8_t*>(Wq);
  const auto s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || K <= 0 || K > 1024 || N % BN != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = K % 16 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(Wq) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(qinv) % 16 == 0;
  switch (N / 32) {
    case 2: launch_gs<2>(vec, A, w, qinv, qs, tp, gamma, beta, residual, out, B, K, N, s); break;
    case 4: launch_gs<4>(vec, A, w, qinv, qs, tp, gamma, beta, residual, out, B, K, N, s); break;
    case 8: launch_gs<8>(vec, A, w, qinv, qs, tp, gamma, beta, residual, out, B, K, N, s); break;
    case 16: launch_gs<16>(vec, A, w, qinv, qs, tp, gamma, beta, residual, out, B, K, N, s); break;
    case 32: launch_gs<32>(vec, A, w, qinv, qs, tp, gamma, beta, residual, out, B, K, N, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
