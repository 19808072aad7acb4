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
// Bound on the H100: bytes. At the flagship block layer ([500, 1024] x [1024,
// 1024] + residual) the call moves ~6.2 MB on the Hopper route (Aq int8, Wq
// int8, the residual and the fp32 out, the int8 copy for the next layer)
// against ~1.07 G int8 operations: ~1.85 us of HBM time vs ~0.54 us at the
// int8 tensor rate. (The register route read A as fp32: ~7.2 MB, 2.15 us.)
// The fp32 out stays, because GroupNorm's next residual and the bf16 head
// read it.
//
// Design: two routes, chosen by the operand, never as a fallback:
// - Aq given (the int8 copy an earlier layer's epilogue wrote; every K =
//   1024 layer of the int8 forward): dense_wgmma_int8.cuh, TMA copies of Aq
//   and Wq and wgmma s8 from shared memory. An Aq that TMA cannot address
//   (K % 16 != 0, a misaligned pointer) is refused.
// - Aq absent (the pre layer, whose input is the fp32 state x at K = 63):
//   dense_gemm_int8.cuh, K1's register-staged tile quantizing A as it is
//   staged, mma.sync m16n8k32 s8.
// Both end in K1's epilogue arithmetic (gn_epilogue.cuh, gn_silu_epilogue_q:
// the warp's GroupNorm chains interleaved) with its int8 option: given
// qinv_next and out_q, it also writes q(out, qinv_next), the next layer's Aq,
// on the value it stores.

#include <cstdint>

#include <cuda_runtime.h>

#include "dense_gemm_int8.cuh"
#include "dense_wgmma_int8.cuh"
#include "gn_epilogue.cuh"

namespace {

using dposer::Programmatic;
using dposer::dense::BM;
using dposer::dense::BN;
using dposer::dense::Cols;
using dposer::dense::THREADS;
using dposer::dense::load_cols;

// Both routes are programmatic launches (mbarrier.cuh): the time row, the
// GroupNorm affine and the next layer's quantization row (cols), the
// rescale row and Wq's first tiles are read before the wait for the
// launches before it, A (or Aq) and the residual after it.

template <int GS, bool VEC>
__global__ void __launch_bounds__(THREADS)
dense_gn_silu_int8_kernel(const float* A, const int8_t* __restrict__ Wq,
                          const float* __restrict__ qinv, const float* __restrict__ qs,
                          const float* __restrict__ tp, const float* __restrict__ gamma,
                          const float* __restrict__ beta, const float* residual, float* out,
                          const float* __restrict__ qnext, int8_t* out_q, int B,
                          int K, int N) {
  __shared__ __align__(128) dposer::dense8::Smem sm;

  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const Cols cols = load_cols(tp, gamma, beta, col0, qnext, out_q);
  dposer::dense8::gemm_tile_int8<VEC, Programmatic>(sm, A, qinv, Wq, qs, row0, col0, B, K);
  dposer::dense::gn_silu_epilogue_q<GS>(sm.c, cols, residual, out, row0, col0, B, N, out_q);
}

template <int GS>
__global__ void __launch_bounds__(THREADS)
dense_gn_silu_int8_wgmma8_kernel(const __grid_constant__ CUtensorMap tmA,
                                 const __grid_constant__ CUtensorMap tmW,
                                 const float* __restrict__ qs, const float* __restrict__ tp,
                                 const float* __restrict__ gamma,
                                 const float* __restrict__ beta, const float* residual,
                                 float* out, const float* __restrict__ qnext, int8_t* out_q,
                                 int B, int K, int N) {
  extern __shared__ uint8_t smem[];
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const Cols cols = load_cols(tp, gamma, beta, col0, qnext, out_q);
  const float* c = dposer::wgmma8::gemm_tile<Programmatic>(smem, &tmA, &tmW, qs, row0, col0, K);
  dposer::dense::gn_silu_epilogue_q<GS>(c, cols, residual, out, row0, col0, B, N, out_q);
}

// The main loop's product alone, float(Aq @ Wq^T) * qs, stored as it leaves
// the loop: the exact check of the loop inside this library.
__global__ void __launch_bounds__(THREADS)
dense_int8_product_wgmma8_kernel(const __grid_constant__ CUtensorMap tmA,
                                 const __grid_constant__ CUtensorMap tmW,
                                 const float* __restrict__ qs, float* __restrict__ out, int B,
                                 int K, int N) {
  extern __shared__ uint8_t smem[];
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const float* c = dposer::wgmma8::gemm_tile(smem, &tmA, &tmW, qs, row0, col0, K);
  for (int idx = threadIdx.x; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN, cc = idx % BN;
    if (row0 + r < B)
      out[static_cast<size_t>(row0 + r) * N + col0 + cc] = c[r * dposer::dense::C_LD + cc];
  }
}

struct Args {
  const float* A;
  const void* Aq;
  const int8_t* Wq;
  const float *qinv, *qs, *tp, *gamma, *beta, *residual;
  float* out;
  const float* qnext;
  int8_t* out_q;
  int B, K, N;
  cudaStream_t stream;
};

template <int GS>
int launch_gs(const Args& a) {
  const dim3 grid(a.N / BN, (a.B + BM - 1) / BM);
  if (a.Aq != nullptr) {
    CUtensorMap ma, mw;
    const int e = dposer::wgmma8::gemm_maps(&ma, &mw, a.Aq, a.Wq, a.B, a.K, a.N);
    if (e != 0) return e;
    return dposer::wgmma8::launch<dense_gn_silu_int8_wgmma8_kernel<GS>, Programmatic>(
        grid, a.K, a.stream, ma, mw, a.qs, a.tp, a.gamma, a.beta, a.residual, a.out, a.qnext,
        a.out_q, a.B, a.K, a.N);
  }
  const bool vec = a.K % 16 == 0 && reinterpret_cast<uintptr_t>(a.A) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.Wq) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.qinv) % 16 == 0;
  const auto kernel =
      vec ? &dense_gn_silu_int8_kernel<GS, true> : &dense_gn_silu_int8_kernel<GS, false>;
  const cudaError_t e = dposer::launch_programmatic(
      kernel, grid, THREADS, 0, a.stream, a.A, a.Wq, a.qinv, a.qs, a.tp, a.gamma, a.beta,
      a.residual, a.out, a.qnext, a.out_q, a.B, a.K, a.N);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

// A [B, K] fp32 (read on the register route only) or Aq [B, K] int8 (the
// Hopper route; K % 16 == 0 and Aq, Wq 16-byte aligned, else refused), Wq
// [N, K] int8, qinv [K] fp32 (the activation quantization row, register
// route), qs [N] fp32 (the rescale row), tp/gamma/beta [N] fp32, residual
// (nullable) and out [B, N] fp32; out may alias residual. qinv_next [N] fp32
// and out_q [B, N] int8 (both or neither): the int8 copy of out for the next
// layer. N/32 (the group size) must be a power of two <= 32 and N a multiple
// of 64; K <= 1024 keeps the int32 sums exact in fp32. Returns 0, the error
// of a failed tensor-map encode, or cudaGetLastError() after the launch.
extern "C" int dposer_dense_gn_silu_int8(const float* A, const void* Aq, const void* Wq,
                                         const float* qinv, const float* qs, const float* tp,
                                         const float* gamma, const float* beta,
                                         const float* residual, float* out,
                                         const float* qinv_next, void* out_q, int B, int K,
                                         int N, void* stream) {
  const Args a{A, Aq, static_cast<const int8_t*>(Wq), qinv, qs, tp, gamma, beta, residual, out,
               qinv_next, static_cast<int8_t*>(out_q), B, K, N,
               static_cast<cudaStream_t>(stream)};
  if (B <= 0 || K <= 0 || K > 1024 || N % BN != 0 || (out_q == nullptr) != (qinv_next == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (Aq != nullptr ? !dposer::wgmma8::tma_ok(Aq, Wq, K) : (A == nullptr || qinv == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (N / 32) {
    case 2: return launch_gs<2>(a);
    case 4: return launch_gs<4>(a);
    case 8: return launch_gs<8>(a);
    case 16: return launch_gs<16>(a);
    case 32: return launch_gs<32>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The Hopper main loop's product alone into out [B, N] fp32 (Aq, Wq and qs
// as above; N a multiple of 64): the exact check of the loop K13 runs.
extern "C" int dposer_dense_gn_silu_int8_product(const void* Aq, const void* Wq,
                                                 const float* qs, float* out, int B, int K,
                                                 int N, void* stream) {
  if (B <= 0 || K <= 0 || N % BN != 0 || !dposer::wgmma8::tma_ok(Aq, Wq, K))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ma, mw;
  const int e = dposer::wgmma8::gemm_maps(&ma, &mw, Aq, Wq, B, K, N);
  if (e != 0) return e;
  const dim3 grid(N / BN, (B + BM - 1) / BM);
  return dposer::wgmma8::launch<dense_int8_product_wgmma8_kernel>(
      grid, K, static_cast<cudaStream_t>(stream), ma, mw, qs, out, B, K, N);
}
