// K14 chain_link: one matmul of the microbenchmarks' dependent chains,
//   h = op(A @ W)   or, on a chain's last link,   x = 0.5*x + 1e-3*op(A @ W)
// with op one of four modes:
//   0 bf16:      bf16(A) @ W, fp32 accumulation and output (K1's main loop);
//   1 bf16-out:  the same, the output rounded to bf16 (Hopper's MMA has no
//                bf16 accumulator: the TPU row "acc=bf16" becomes fp32
//                accumulation rounded once);
//   2 int8:      float(q(A) @ Wq^T) * qs, q(a) = clamp(rint(a * qinv), +-127)
//                (K13's main loops; the benchmark passes qinv = 21 and
//                qs = 1/(21*127) rows). The link takes A as the int8 copy
//                Aq = q(A) the previous link wrote, or as fp32 A (a call's
//                first link), and writes the next link's Aq, q(h * qinv_next)
//                (the TPU benchmark's per-pass requantization): an inner link
//                writes only that; a chain's last link writes the state and
//                q(x_new * qinv_next) for the next iteration's first link;
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
// bf16 tensor rate; an int8 link with int8 in and out ~2.1 MB, ~0.63 us
// (the last link, which also reads and writes the fp32 state, ~6.3 MB, ~1.88
// us), against ~0.54 us: all bytes bound, so the card's answer to "how much
// faster is int8" is at best the ratio of bytes, not of tensor-core rates.
//
// Design: the bf16 modes run dense_wgmma.cuh's Hopper main loop (a TMA ring
// with mbarriers, a producer warp, wgmma with A from registers), and the
// gn-silu mode adds gn_epilogue.cuh, so a link times a matmul from fp32 A
// and K1's epilogue. The int8
// mode runs K13's loops: dense_wgmma_int8.cuh (TMA, wgmma s8 from shared
// memory) on an int8 Aq, dense_gemm_int8.cuh on a fp32 A. The state update
// is unfused multiplies and an add, as the plain version rounds them.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dense_gemm.cuh"
#include "dense_gemm_int8.cuh"
#include "dense_wgmma.cuh"
#include "dense_wgmma_int8.cuh"
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

// The int8 tile in sm.c: the fp32 output h (or the state update) to out
// when out is given, and q(h, qnext) (q(x_new, qnext) when UPDATE) to out_q
// when out_q is given. A thread takes four neighbouring columns: 16-byte
// loads and stores of the fp32 values, one 4-byte store of the int8 ones.
template <bool UPDATE>
__device__ __forceinline__ void store_int8(const float* c, float* out, int8_t* out_q,
                                           const float* __restrict__ qnext, int row0, int col0,
                                           int B, int N) {
  using dposer::dense::quant8;
  for (int idx = threadIdx.x; idx < BM * BN / 4; idx += THREADS) {
    const int r = idx / (BN / 4), cc = 4 * (idx % (BN / 4));
    const int gr = row0 + r;
    if (gr >= B) continue;
    float4 y = *reinterpret_cast<const float4*>(&c[r * C_LD + cc]);
    const size_t o = static_cast<size_t>(gr) * N + col0 + cc;
    if constexpr (UPDATE) {
      const float4 x = *reinterpret_cast<const float4*>(&out[o]);
      y = make_float4(__fadd_rn(__fmul_rn(0.5f, x.x), __fmul_rn(1e-3f, y.x)),
                      __fadd_rn(__fmul_rn(0.5f, x.y), __fmul_rn(1e-3f, y.y)),
                      __fadd_rn(__fmul_rn(0.5f, x.z), __fmul_rn(1e-3f, y.z)),
                      __fadd_rn(__fmul_rn(0.5f, x.w), __fmul_rn(1e-3f, y.w)));
    }
    if (out != nullptr) *reinterpret_cast<float4*>(&out[o]) = y;
    if (out_q != nullptr) {
      const float4 q = *reinterpret_cast<const float4*>(&qnext[col0 + cc]);
      *reinterpret_cast<uint32_t*>(&out_q[o]) = dposer::dense8::pack4(
          quant8(y.x, q.x), quant8(y.y, q.y), quant8(y.z, q.z), quant8(y.w, q.w));
    }
  }
}

// The int8 mode on a fp32 A: the register-staged loop quantizes it.
template <bool UPDATE>
__global__ void __launch_bounds__(THREADS)
chain_link_int8_kernel(const float* __restrict__ A, const int8_t* __restrict__ Wq,
                       const float* __restrict__ qinv, const float* __restrict__ qs,
                       const float* __restrict__ qnext, float* out, int8_t* out_q, int B, int K,
                       int N) {
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  __shared__ __align__(128) dposer::dense8::Smem sm;
  dposer::dense8::gemm_tile_int8<true>(sm, A, qinv, Wq, qs, row0, col0, B, K);
  store_int8<UPDATE>(sm.c, out, out_q, qnext, row0, col0, B, N);
}

// The int8 mode on an int8 Aq: the Hopper loop.
template <bool UPDATE>
__global__ void __launch_bounds__(THREADS)
chain_link_wgmma8_kernel(const __grid_constant__ CUtensorMap tmA,
                         const __grid_constant__ CUtensorMap tmW, const float* __restrict__ qs,
                         const float* __restrict__ qnext, float* out, int8_t* out_q, int B,
                         int K, int N) {
  extern __shared__ uint8_t smem[];
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const float* c = dposer::wgmma8::gemm_tile(smem, &tmA, &tmW, qs, row0, col0, K);
  store_int8<UPDATE>(c, out, out_q, qnext, row0, col0, B, N);
}

// The bf16 modes, on ring shape R.
template <int MODE, int GS, bool UPDATE, class R>
__global__ void __launch_bounds__(THREADS)
chain_link_wgmma_kernel(const __grid_constant__ CUtensorMap tmA,
                        const __grid_constant__ CUtensorMap tmW, float* out, int B, int K,
                        int N) {
  extern __shared__ uint8_t smem[];
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const float* c = dposer::wgmma::gemm_tile<R>(smem, &tmA, &tmW, row0, col0, K);
  if constexpr (MODE == kGnSilu)
    dposer::dense::gn_silu_epilogue<GS, UPDATE ? Out::kUpdate : Out::kStore>(
        c, nullptr, nullptr, nullptr, nullptr, out, row0, col0, B, N);
  else
    store_plain<MODE, UPDATE>(c, out, row0, col0, B, N);
}

int launch_int8(bool update, const float* A, const void* Aq, const void* W,
                const float* qinv, const float* qs, const float* qnext, float* out,
                void* out_q, int B, int K, int N, cudaStream_t stream) {
  const dim3 grid(N / BN, (B + BM - 1) / BM);
  const auto* wq = static_cast<const int8_t*>(W);
  auto* oq = static_cast<int8_t*>(out_q);
  if (Aq != nullptr) {
    CUtensorMap ma, mw;
    const int e = dposer::wgmma8::gemm_maps(&ma, &mw, Aq, W, B, K, N);
    if (e != 0) return e;
    if (update)
      return dposer::wgmma8::launch<chain_link_wgmma8_kernel<true>>(grid, K, stream, ma, mw, qs,
                                                                   qnext, out, oq, B, K, N);
    return dposer::wgmma8::launch<chain_link_wgmma8_kernel<false>>(grid, K, stream, ma, mw, qs,
                                                                  qnext, out, oq, B, K, N);
  }
  if (update)
    chain_link_int8_kernel<true><<<grid, THREADS, 0, stream>>>(A, wq, qinv, qs, qnext, out, oq,
                                                               B, K, N);
  else
    chain_link_int8_kernel<false><<<grid, THREADS, 0, stream>>>(A, wq, qinv, qs, qnext, out, oq,
                                                                B, K, N);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE, int GS, class R>
int launch_ring(bool update, dim3 grid, const float* A, const void* W, float* out, int B, int K,
                int N, cudaStream_t stream) {
  CUtensorMap ma, mw;
  const int e = dposer::wgmma::gemm_maps<R>(&ma, &mw, A, W, B, K, N);
  if (e != 0) return e;
  if (update)
    return dposer::wgmma::launch<R, chain_link_wgmma_kernel<MODE, GS, true, R>>(
        grid, stream, ma, mw, out, B, K, N);
  return dposer::wgmma::launch<R, chain_link_wgmma_kernel<MODE, GS, false, R>>(
      grid, stream, ma, mw, out, B, K, N);
}

template <int MODE, int GS>
int launch_bf16(bool update, const float* A, const void* W, float* out, int B, int K, int N,
                cudaStream_t stream) {
  const dim3 grid(N / BN, (B + BM - 1) / BM);
  if (dposer::wgmma::one_wave(grid.x * grid.y))
    return launch_ring<MODE, GS, dposer::wgmma::Wide>(update, grid, A, W, out, B, K, N, stream);
  return launch_ring<MODE, GS, dposer::wgmma::Narrow>(update, grid, A, W, out, B, K, N, stream);
}

}  // namespace

// A [B, K] fp32; W [K, N] bf16 (modes 0, 1, 3) or [N, K] int8 (mode 2, with
// qs [N] fp32); out [B, N] fp32, the chain's state x when update != 0 (then
// read and rewritten in place; it must not alias A). Mode 2 takes either A
// with qinv [K] fp32 (the register route) or Aq [B, K] int8 (the Hopper
// route; A and qinv unused), and writes out and/or out_q [B, N] int8 (with
// qinv_next [N] fp32: the next link's Aq); at least one of them, out when
// update != 0. K a multiple of 16 (<= 1024 in mode 2), N of 64, 16-byte
// aligned operands (qinv_next too); in mode 3 N/32 a power of two <= 32. Returns 0, the
// error of a failed tensor-map encode, or cudaGetLastError() after the launch.
extern "C" int dposer_chain_link(const float* A, const void* Aq, const void* W,
                                 const float* qinv, const float* qs, const float* qinv_next,
                                 float* out, void* out_q, int mode, int update, int B, int K,
                                 int N, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto al = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (B <= 0 || K <= 0 || K % 16 != 0 || N % BN != 0 || !al(W))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool up = update != 0;
  if (mode == kInt8) {
    const bool operand_ok = Aq != nullptr ? al(Aq) : (A != nullptr && al(A) && al(qinv));
    const bool outputs_ok = (out != nullptr || out_q != nullptr) && (out != nullptr || !up) &&
                            (out_q == nullptr) == (qinv_next == nullptr) && al(out) &&
                            al(out_q) && al(qinv_next);
    if (K > 1024 || !operand_ok || !outputs_ok) return static_cast<int>(cudaErrorInvalidValue);
    return launch_int8(up, A, Aq, W, qinv, qs, qinv_next, out, out_q, B, K, N, s);
  }
  if (Aq != nullptr || out_q != nullptr || A == nullptr || out == nullptr || !al(A))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case kBf16: return launch_bf16<kBf16, 32>(up, A, W, out, B, K, N, s);
    case kBf16Out: return launch_bf16<kBf16Out, 32>(up, A, W, out, B, K, N, s);
    case kGnSilu:
      switch (N / 32) {
        case 2: return launch_bf16<kGnSilu, 2>(up, A, W, out, B, K, N, s);
        case 4: return launch_bf16<kGnSilu, 4>(up, A, W, out, B, K, N, s);
        case 8: return launch_bf16<kGnSilu, 8>(up, A, W, out, B, K, N, s);
        case 16: return launch_bf16<kGnSilu, 16>(up, A, W, out, B, K, N, s);
        case 32: return launch_bf16<kGnSilu, 32>(up, A, W, out, B, K, N, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
      }
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
