// K14 chain_link: one matmul of the microbenchmarks' dependent chains,
//   h = op(A @ W)   or, on a chain's last link,   x = 0.5*x + 1e-3*op(A @ W)
// with op one of four modes:
//   0 bf16:      bf16(A) @ W, fp32 accumulation and output (K1's main loop);
//   1 bf16-out:  the same, the output rounded to bf16 (Hopper's MMA has no
//                bf16 accumulator: the TPU row "acc=bf16" becomes fp32
//                accumulation rounded once);
//   2 int8:      float(q(A) @ Wq^T) * qs, q(a) = clamp(rint(a * qinv), +-127)
//                (K13's main loop; the benchmark passes qinv = 21 and
//                qs = 1/(21*127) rows);
//   3 gn-silu:   SiLU(GN_{N/32}(bf16(A) @ W)), no affine, no time row (K1's
//                epilogue with gamma 1, beta 0).
//
// Replaces: the two microbenchmark kernels of the TPU package,
// benchmarks/mxu_micro.py:61 (1000 x 6 dependent [512,1024]x[1024,1024]
// matmuls in bf16 with fp32 or bf16 accumulation, or int8 with the per-pass
// requantization, then x = 0.5x + 1e-3h) and benchmarks/ilp_probe.py:85 (the
// same chain with lane-strided GroupNorm and SiLU after each matmul, on 1, 2
// or 4 interleaved row chains). The TPU runs the whole 1000-iteration loop in
// one program; here a link is a launch and the host walks the chain.
//
// Bound on the H100: a bf16 link at [512,1024]x[1024,1024] moves ~6.3 MB
// (A and out fp32, W bf16), ~1.88 us, against ~1.07 GFLOP, ~1.09 us at the
// bf16 tensor rate; an int8 link ~5.2 MB, ~1.56 us, against ~0.54 us: both
// bytes bound, so the card's answer to "how much faster is int8" is at best
// the ratio of bytes, not of tensor-core rates.
//
// Design: the main loops of dense_gemm.cuh and dense_gemm_int8.cuh and the
// epilogue of gn_epilogue.cuh, unchanged, so a link times exactly what K1 and
// K13 spend on their matmuls. The state update is unfused multiplies and an
// add, as the plain version rounds them.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dense_gemm.cuh"
#include "dense_gemm_int8.cuh"
#include "gn_epilogue.cuh"

namespace {

using dposer::dense::BM;
using dposer::dense::BN;
using dposer::dense::C_LD;
using dposer::dense::Out;
using dposer::dense::THREADS;

enum Mode { kBf16 = 0, kBf16Out = 1, kInt8 = 2, kGnSilu = 3 };

// The tile in sm.c to out, for the modes without GroupNorm.
template <int MODE, bool UPDATE>
__device__ __forceinline__ void store_plain(const float* c, float* out, int row0, int col0,
                                            int B, int N) {
  for (int idx = threadIdx.x; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN, cc = idx % BN;
    const int gr = row0 + r;
    if (gr >= B) continue;
    float y = c[r * C_LD + cc];
    if constexpr (MODE == kBf16Out) y = __bfloat162float(__float2bfloat16_rn(y));
    const size_t o = static_cast<size_t>(gr) * N + col0 + cc;
    if constexpr (UPDATE) y = __fadd_rn(__fmul_rn(0.5f, out[o]), __fmul_rn(1e-3f, y));
    out[o] = y;
  }
}

template <int MODE, int GS, bool UPDATE>
__global__ void __launch_bounds__(THREADS)
chain_link_kernel(const float* __restrict__ A, const void* __restrict__ W,
                  const float* __restrict__ qinv, const float* __restrict__ qs, float* out,
                  int B, int K, int N) {
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  if constexpr (MODE == kInt8) {
    __shared__ __align__(128) dposer::dense8::Smem sm;
    dposer::dense8::gemm_tile_int8<true>(sm, A, qinv, static_cast<const int8_t*>(W), qs, row0,
                                         col0, B, K);
    store_plain<MODE, UPDATE>(sm.c, out, row0, col0, B, N);
  } else {
    __shared__ __align__(128) dposer::dense::Smem sm;
    dposer::dense::gemm_tile<true, false>(sm, A, nullptr, static_cast<const __nv_bfloat16*>(W),
                                          row0, col0, B, K, N);
    if constexpr (MODE == kGnSilu)
      dposer::dense::gn_silu_epilogue<GS, UPDATE ? Out::kUpdate : Out::kStore>(
          sm.c, nullptr, nullptr, nullptr, nullptr, out, row0, col0, B, N);
    else
      store_plain<MODE, UPDATE>(sm.c, out, row0, col0, B, N);
  }
}

template <int MODE, int GS>
void launch(bool update, const float* A, const void* W, const float* qinv, const float* qs,
            float* out, int B, int K, int N, cudaStream_t stream) {
  const dim3 grid(N / BN, (B + BM - 1) / BM);
  if (update)
    chain_link_kernel<MODE, GS, true><<<grid, THREADS, 0, stream>>>(A, W, qinv, qs, out, B, K, N);
  else
    chain_link_kernel<MODE, GS, false><<<grid, THREADS, 0, stream>>>(A, W, qinv, qs, out, B, K,
                                                                     N);
}

}  // namespace

// A [B, K] fp32; W [K, N] bf16 (modes 0, 1, 3) or [N, K] int8 (mode 2, with
// qinv [K] and qs [N] fp32); out [B, N] fp32, the chain's state x when
// update != 0 (then read and rewritten in place; it must not alias A). K a
// multiple of 16 (<= 1024 in mode 2), N of 64, 16-byte aligned operands; in
// mode 3 N/32 a power of two <= 32. Returns cudaGetLastError().
extern "C" int dposer_chain_link(const float* A, const void* W, const float* qinv,
                                 const float* qs, float* out, int mode, int update, int B, int K,
                                 int N, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const bool aligned = reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(W) % 16 == 0 &&
                       (mode != kInt8 || reinterpret_cast<uintptr_t>(qinv) % 16 == 0);
  if (B <= 0 || K <= 0 || K % 16 != 0 || N % BN != 0 || !aligned ||
      (mode == kInt8 && K > 1024))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool up = update != 0;
  switch (mode) {
    case kBf16: launch<kBf16, 32>(up, A, W, qinv, qs, out, B, K, N, s); break;
    case kBf16Out: launch<kBf16Out, 32>(up, A, W, qinv, qs, out, B, K, N, s); break;
    case kInt8: launch<kInt8, 32>(up, A, W, qinv, qs, out, B, K, N, s); break;
    case kGnSilu:
      switch (N / 32) {
        case 2: launch<kGnSilu, 2>(up, A, W, qinv, qs, out, B, K, N, s); break;
        case 4: launch<kGnSilu, 4>(up, A, W, qinv, qs, out, B, K, N, s); break;
        case 8: launch<kGnSilu, 8>(up, A, W, qinv, qs, out, B, K, N, s); break;
        case 16: launch<kGnSilu, 16>(up, A, W, qinv, qs, out, B, K, N, s); break;
        case 32: launch<kGnSilu, 32>(up, A, W, qinv, qs, out, B, K, N, s); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
      }
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
