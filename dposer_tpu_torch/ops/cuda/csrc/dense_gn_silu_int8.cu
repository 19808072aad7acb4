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
// Design: three routes, chosen by the operand, never as a fallback:
// - Aq given (the int8 copy an earlier layer's epilogue wrote; every K =
//   1024 layer of the int8 forward): dense_wgmma_int8.cuh, TMA copies of Aq
//   and Wq and wgmma s8 from shared memory. An Aq that TMA cannot address
//   (K % 16 != 0, a misaligned pointer) is refused.
// - fp32 A at K <= 64 (the pre layer, whose input is the [B, 63] fp32
//   state: a 252-byte row stride TMA cannot take, whatever A's alignment):
//   the pre route (namespace pre, below).
// - fp32 A at K > 64 (no caller in the program's forward; kept for any
//   fp32 input wider than the state): dense_gemm_int8.cuh, K1's
//   register-staged tile quantizing A as it is staged, mma.sync m16n8k32 s8.
// All end in K1's epilogue arithmetic (gn_epilogue.cuh, gn_silu_epilogue_q:
// the warp's GroupNorm chains interleaved) with its int8 option: given
// qinv_next and out_q, it also writes q(out, qinv_next), the next layer's Aq,
// on the value it stores. The int32 sums are exact on every route, and each
// rescales them by __fmul_rn(float(sum), qs[c]), so the three give the same
// bits on the same operands.
// The pre route, the int8 counterpart of K1's (dense_gn_silu.cu): before the
// wait for the launches before it (only constants are read there), one
// thread bulk-copies Wq's rows col0 .. col0 + 63 (one contiguous span of
// 64 x K bytes at offset col0 * K; 4,032 = 16 x 252 bytes at K = 63, so it
// is 16-byte aligned wherever Wq is; TMA cannot take Wq's 63-byte rows), and
// all eight warps lay it into the K-major int8 tile wgmma reads (128-byte
// swizzle, column 63 zero) while the quantization row, the rescale row and
// the epilogue's rows load. After the wait one bulk copy brings the
// state's 64-row span (64 x 252 bytes; a misaligned span by coalesced loads
// of every thread), all eight warps quantize it once into the swizzled A
// tile with the register route's own quantizer (dense_gemm.cuh's quant8;
// column 63 and the rows past B zero), warps 0-3 run two wgmma m64n64k32 s8
// from shared memory (dense_wgmma_int8.cuh's descriptors, the first two
// k32 steps of its stage), and all eight the epilogue. A launch reserves
// dynamic shared memory (read by none) so that an SM holds one CTA where
// the grid fits the SMs once (500 rows) and two beyond (1,000 rows: 256
// CTAs, one wave), the rule K1's pre route measured. 86-88 registers, no
// spills, 37,904 bytes of static shared memory. Bound: bytes, 2.77 MB at
// 500 rows with the copy (0.83 us), 5.46 MB at 1,000 (1.63 us).
// On the card (NVIDIA H100 80GB HBM3 at 700 W, CUDA-graph replay of
// programmatic launches, benchmarks/k1_pre.py) the pre layer takes 4.6-4.9
// us at 500 rows and 6.0-6.2 at 1,000 (the register route 5.6-5.9 and
// 10.9-11.3), followed by a block's first layer 10.9-11.3 and 18.2-18.8
// (11.8-12.1 and 22.9-23.5); an int8 generation call at 500 rows 33.1-33.6
// ms (34.2-34.5). Left out after measurement there: two CTAs an SM at 500
// rows too (the same 4.6-4.8 us alone, but 11.7-12.0 with the block layer
// and 33.5-33.7 ms a call), as for K1.

#include <cstdint>

#include <cuda_runtime.h>

#include "dense_gemm_int8.cuh"
#include "dense_wgmma_int8.cuh"
#include "dense_wgmma_ss.cuh"
#include "gn_epilogue.cuh"

namespace {

using dposer::Programmatic;
using dposer::dense::BM;
using dposer::dense::BN;
using dposer::dense::Cols;
using dposer::dense::THREADS;
using dposer::dense::load_cols;

// Every route is a programmatic launch (mbarrier.cuh): the time row, the
// GroupNorm affine and the next layer's quantization row (cols), the
// rescale row and Wq's first tiles (the pre route: all of Wq's span, laid
// out) are read before the wait for the launches before it, A (or Aq) and
// the residual after it.

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

namespace pre {

// The pre route's shared memory, at offsets from a 1024-byte aligned base:
// the int8 A tile and Wq's tile (64 rows of 128 bytes each, one 128-byte
// swizzle atom a row, as TMA would write them; K-columns 64-127 are never
// read), Wq's span as it lies in memory (64 rows x K bytes, K <= 64), A's
// fp32 rows as they lie (64 x K) and the two barriers that count the spans
// in (Wq's, A's). The epilogue's fp32 tile [BM][C_LD] overlays the first
// three once the product is done.
constexpr int KMAX = 64;
constexpr int TILE_A = 0;
constexpr int TILE_W = TILE_A + BM * 128;
constexpr int RAW_W = TILE_W + BN * 128;
constexpr int RAW_A = RAW_W + BN * KMAX;
constexpr int BAR = RAW_A + BM * KMAX * 4;
constexpr int SMEM = 1024 + BAR + 16;  // static; aligned by hand
static_assert(BM * dposer::dense::C_LD * 4 <= RAW_A, "the epilogue's tile must fit below A's rows");

using dposer::bulk_copy;
using dposer::mbar_expect_tx;
using dposer::mbar_init;
using dposer::mbar_wait;
using dposer::smem_u32;
using dposer::dense::quant8;
using dposer::dense8::pack4;

// The 16 int8 values v as one 16-byte chunk.
__device__ __forceinline__ uint4 pack16(const int (&v)[16]) {
  return make_uint4(pack4(v[0], v[1], v[2], v[3]), pack4(v[4], v[5], v[6], v[7]),
                    pack4(v[8], v[9], v[10], v[11]), pack4(v[12], v[13], v[14], v[15]));
}

// The route for fp32 A with K <= 64 (the pre layer, A = the [B, 63] state;
// the file's head says why). Thread t owns the 16-byte chunk (r, c) =
// (t % 64, t / 64) of both tiles: K-columns 16c .. 16c + 15 of row r, stored
// at chunk c ^ (r % 8) of the row (the 128-byte swizzle). A warp reads 32
// rows at one column of A's rows (stride K, odd at K = 63: distinct banks)
// and stores 8 distinct chunks of 8 rows a quarter: no bank conflicts.
template <int GS>
__global__ void __launch_bounds__(THREADS, 2)
dense_gn_silu_int8_kernel(const float* A, const int8_t* __restrict__ Wq,
                          const float* __restrict__ qinv, const float* __restrict__ qs,
                          const float* __restrict__ tp, const float* __restrict__ gamma,
                          const float* __restrict__ beta, const float* residual, float* out,
                          const float* __restrict__ qnext, int8_t* out_q, int B, int K, int N) {
  __shared__ __align__(128) uint8_t smem_raw[SMEM];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sm_s = smem_u32(sm), bar_w = sm_s + BAR, bar_a = bar_w + 8;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int rows = min(BM, B - row0), n = rows * K;  // the state span's fp32 values
  const int n_w = BN * K;                              // Wq's span's bytes
  const int r = tid % BM, c = tid / BM, k0 = 16 * c;  // this thread's chunk
  const Cols cols = load_cols(tp, gamma, beta, col0, qnext, out_q);
  const int8_t* wspan = Wq + static_cast<size_t>(col0) * K;
  const float* span = A + static_cast<size_t>(row0) * K;
  const int w_bulk = reinterpret_cast<uintptr_t>(wspan) % 16 == 0 ? n_w & ~15 : 0;
  const int n_bulk = reinterpret_cast<uintptr_t>(span) % 16 == 0 ? n & ~3 : 0;
  int8_t* raw_w = reinterpret_cast<int8_t*>(sm + RAW_W);
  if (tid == 0) {
    mbar_init(bar_w, 1);
    mbar_init(bar_a, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(bar_w, static_cast<uint32_t>(w_bulk));
    if (w_bulk > 0) bulk_copy(sm_s + RAW_W, wspan, w_bulk, bar_w);
    mbar_expect_tx(bar_a, static_cast<uint32_t>(4 * n_bulk));
  }
  for (int i = w_bulk + tid; i < n_w; i += THREADS) raw_w[i] = wspan[i];
  float qi[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) qi[j] = k0 + j < K ? qinv[k0 + j] : 0.0f;
  // warps 0-3 hold the wgmma fragment's rescale values: columns 8j + 2(lane % 4) (+1)
  float s0[8], s1[8];
  if (warp < 4) {
    const int t = lane & 3;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s0[j] = qs[col0 + 8 * j + 2 * t];
      s1[j] = qs[col0 + 8 * j + 2 * t + 1];
    }
  }
  __syncthreads();  // the barriers are in place, the threads' bytes of Wq are in
  mbar_wait(bar_w, 0);
  {
    int v[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = k0 + j < K ? raw_w[r * K + k0 + j] : 0;
    *reinterpret_cast<uint4*>(sm + TILE_W + r * 128 + ((c ^ (r & 7)) << 4)) = pack16(v);
  }
  Programmatic{}();  // the launches before this one are done: A is written
  span = dposer::after_wait(span);
  float* raw = reinterpret_cast<float*>(sm + RAW_A);
  if (tid == 0 && n_bulk > 0) bulk_copy(sm_s + RAW_A, span, 4 * n_bulk, bar_a);
  for (int i = n_bulk + tid; i < n; i += THREADS) raw[i] = span[i];
  __syncthreads();  // the threads' values are in
  mbar_wait(bar_a, 0);
  {
    int v[16];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      v[j] = r < rows && k0 + j < K ? quant8(raw[r * K + k0 + j], qi[j]) : 0;
    *reinterpret_cast<uint4*>(sm + TILE_A + r * 128 + ((c ^ (r & 7)) << 4)) = pack16(v);
  }
  // the tiles' generic stores become visible to wgmma's reads (async proxy)
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  float* tile = reinterpret_cast<float*>(sm);
  if (warp < 4) {
    namespace w8 = dposer::wgmma8;
    using dposer::wgmma::desc_k;
    int acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0;
#pragma unroll
    for (int i = 0; i < 32; ++i) w8::keep(acc[i]);
    dposer::wgmma::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KMAX / 32; ++kk)
      w8::wgmma_m64n64k32_s8(acc, desc_k(sm_s + TILE_A + 32 * kk),
                             desc_k(sm_s + TILE_W + 32 * kk));
    dposer::wgmma::wgmma_commit();
    dposer::wgmma::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 32; ++i) w8::keep(acc[i]);
    // every consumer's wgmma is done with the tiles before they become the tile
    asm volatile("bar.sync 1, 128;" ::: "memory");
    constexpr int C_LD = dposer::dense::C_LD;
    const int r0 = 16 * warp + (lane >> 2), t = lane & 3;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int cc = 8 * j + 2 * t;
      *reinterpret_cast<float2*>(&tile[r0 * C_LD + cc]) =
          make_float2(__fmul_rn(static_cast<float>(acc[4 * j]), s0[j]),
                      __fmul_rn(static_cast<float>(acc[4 * j + 1]), s1[j]));
      *reinterpret_cast<float2*>(&tile[(r0 + 8) * C_LD + cc]) =
          make_float2(__fmul_rn(static_cast<float>(acc[4 * j + 2]), s0[j]),
                      __fmul_rn(static_cast<float>(acc[4 * j + 3]), s1[j]));
    }
  }
  __syncthreads();
  dposer::dense::gn_silu_epilogue_q<GS>(tile, cols, residual, out, row0, col0, B, N, out_q);
}

// The CTAs an SM a grid of the pre route may hold: one where the grid fits
// the SMs once, two beyond.
inline int ctas_per_sm(bool one_wave) { return one_wave ? 1 : 2; }

// The dynamic shared memory a launch reserves (the kernel reads none of it)
// so that an SM of the current device holds `ctas` of its CTAs and no more.
inline int reserve(int ctas) {
  static int per_sm = 0, per_block = 0;
  if (per_sm == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    cudaDeviceGetAttribute(&per_block, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  }
  // a CTA then takes more than 1/(ctas + 1) of the SM's shared memory
  return per_sm / (ctas + 1) + 1024 - SMEM - per_block;
}

}  // namespace pre

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
int launch_pre(const Args& a, dim3 grid) {
  const auto kernel = pre::dense_gn_silu_int8_kernel<GS>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pre::reserve(1));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int dyn = pre::reserve(pre::ctas_per_sm(dposer::wgmma::one_wave(grid.x * grid.y)));
  const cudaError_t e = dposer::launch_programmatic(
      kernel, grid, THREADS, dyn, a.stream, a.A, a.Wq, a.qinv, a.qs, a.tp, a.gamma, a.beta,
      a.residual, a.out, a.qnext, a.out_q, a.B, a.K, a.N);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

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
  if (a.K <= pre::KMAX) return launch_pre<GS>(a, grid);
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

// A [B, K] fp32 (the pre route at K <= 64, the register route beyond) or Aq
// [B, K] int8 (the Hopper route; K % 16 == 0 and Aq, Wq 16-byte aligned,
// else refused), Wq [N, K] int8, qinv [K] fp32 (the activation quantization
// row, read from fp32 A), qs [N] fp32 (the rescale row), tp/gamma/beta [N] fp32, residual
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
  return dposer::wgss::by_group_size(N,
                                     [&](auto gs) { return launch_gs<decltype(gs)::value>(a); });
}

// The pre route at B rows and width N as it launches on this card, for
// reports: out = {threads, static shared memory a CTA, the dynamic shared
// memory it reserves, registers a thread, local memory a thread (spills),
// CTAs an SM holds at once}. Returns 0 or a CUDA error.
extern "C" int dposer_dense_gn_silu_int8_pre_launch_info(int B, int N, int* out) {
  const bool one_wave = dposer::wgmma::one_wave((N / BN) * ((B + BM - 1) / BM));
  return dposer::wgss::by_group_size(N, [&](auto gs) {
    const auto kernel = pre::dense_gn_silu_int8_kernel<decltype(gs)::value>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         pre::reserve(1));
    cudaFuncAttributes at{};
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&at, kernel);
    if (e != cudaSuccess) return static_cast<int>(e);
    out[0] = THREADS;
    out[1] = static_cast<int>(at.sharedSizeBytes);
    out[2] = pre::reserve(pre::ctas_per_sm(one_wave));
    out[3] = at.numRegs;
    out[4] = static_cast<int>(at.localSizeBytes);
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[5], kernel, THREADS, out[2]));
  });
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
