// K1 dense_gn_silu: y = SiLU(GN32(bf16(A) @ W + tp) * gamma + beta) [+ residual]
//
// Replaces: one layer of the network forward inside the TPU reverse-diffusion
// kernel, dposer_tpu/ops/pallas/fused_em.py::_make_kernel via
// dposer_tpu/ops/pallas/score_net.py::bind_fwd (the bf16 dense matmul, the
// time-projection row add, group_norm_vpu and SiLU, and the block's h + h2).
//
// Bound on the H100: bytes. A block layer at [500, 1024] x [1024, 1024] with
// its residual moves ~8.2 MB on the bf16 route (the bf16 copy of A 1 MB, W
// 2 MB, the residual and the fp32 out 2 MB each, the bf16 copy of out 1 MB):
// 2.46 us at 3.35 TB/s, against ~1.07 GFLOP, 1.1 us at the bf16 tensor rate.
// A block's first layer writes its copy alone: ~4.2 MB, 1.24 us. The TPU
// kernel kept all weights on-core for the whole loop; 8 MB of bf16 weights
// do not fit an SM's shared memory, so each layer is one launch and the
// weights are re-read from the 50 MB L2 every step.
//
// Design: three routes, chosen by the operand, never as a fallback.
// - Given Ab, the bf16 copy of A that the layer before wrote (every K = 1024
//   layer of network_hidden), the bf16 route: dense_wgmma_ss.cuh's loop
//   (warp 4 starts TMA copies of the copy and W into a ring of 64-column
//   stages; warps 0-3, one warpgroup, run wgmma m64n64k16 with both operands
//   from shared memory), the sums written to a tile in the ring's memory,
//   and all eight warps in the epilogue. No register holds an operand, so
//   no instruction defines a wgmma input while one is in flight: no
//   serialized wgmma (C7513), and a group may be left in flight.
// - Given fp32 A that TMA can address (K % 4 == 0, aligned), the fp32 route:
//   dense_wgmma.cuh's loop, which rounds A to bf16 in registers (direct
//   wrapper calls; K14 runs the same loop).
// - Otherwise (the pre layer, A [B, 63], a 252-byte row stride TMA cannot
//   take) dense_gemm.cuh's element-load loop (64x64 tile, bf16 WMMA).
// A GroupNorm group is N/32 consecutive features, so with N/32 <= 32 a
// 64-wide tile holds whole groups in the natural feature order. Every route
// ends in gn_epilogue.cuh::gn_silu_epilogue_q (K13's: each warp's sixteen
// GroupNorm chains interleaved, two-pass fp32 mean and variance) with its
// bf16 instantiation: it adds the time row, applies the affine, SiLU and
// the residual, writes the fp32 out (unless nothing reads it) and, given
// out_b, out_b = __float2bfloat16_rn(out): the next layer's Ab, the
// rounding that layer made of the fp32 out, so the products are the same.
// The bf16 route adds them in the fp32 route's order: the outputs are
// bit-equal.
//
// What bounds the bf16 route: not the MMAs, nor HBM. A 500-row layer is 128
// CTAs, one an SM, each reading 256 KB of the copy and W from L2 through
// its ring; on the card (NVIDIA H100 80GB HBM3 at 700 W, CUDA-graph replay,
// chip_smoke.py and benchmarks/k1_rings.py) a block's first layer takes
// 7.4-7.5 us, with the residual 8.0-8.1, at 1,000 rows 10.6-11.9; the fp32
// route at the same shapes 8.8-9.2, 9.3 and 13.8-14.3, and before the
// interleaved epilogue 10.77, 11.08 and 14.91. K13 moves half the bytes
// through its loop in 7.0 us, so most of what is left is the launch, the
// ring's fill and the epilogue, not the stream of tiles.
// Rings tried (benchmarks/k1_rings.py, the three variants):
// - the deep ring, 8 stages of 16 KB (129 KB, one CTA an SM) with one wgmma
//   group left in flight: 7.4 / 8.1 us at 500 rows; waiting on each group
//   8.2-8.4 / 8.6-8.8; 12 stages (193 KB) 8.1-8.3 / 8.7-8.9: deeper does
//   not help, a group in flight does;
// - the shallow ring, 4 stages (65 KB; all 256 CTAs of 1,000 rows resident,
//   up to three an SM): each group waited on 11.4-11.9 us, one left in
//   flight 11.6-11.9, a wash in two runs; it waits, as K10's ring does.
//   Under programmatic launch (below) three an SM made the completion
//   solve at 1,000 rows slower than plain launches (12.4-12.5 ms against
//   11.8-11.9; H100 80GB HBM3 at 700 W, CUDA-graph replay), most likely as
//   the next layer's CTAs take a free third slot on each SM early and two
//   more wherever a layer's CTAs leave first: three an SM there, one
//   elsewhere. So the shallow ring takes 5 stages (81 KB, two CTAs an SM at
//   most): 10.7 ms a solve.
// So a grid that fits the SMs once takes the deep ring, a larger one the
// shallow ring; both add the same products in the same order.
// Programmatic dependent launch (mbarrier.cuh): every route is launched
// with programmatic stream serialization, so in a sampler's chain a layer's
// CTAs are scheduled while the launch before it drains. Each reads first
// what that launch cannot have written (the time row, the GroupNorm affine,
// and W: the producer sets its barriers up and starts W's boxes of the
// ring's first stages, each stage expecting A's bytes and W's together),
// then waits (griddepcontrol.wait) for the launches before it, then
// triggers the next launch's scheduling and only then starts A's boxes;
// the residual and every write come after the wait. The wait orders all
// memory, so the early trigger is safe, and the sums, their order and the
// rounding are those of a plain launch: the outputs are bit-equal.
// Not yet: a persistent kernel whose epilogue overlaps the next tile's
// loads.

#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dense_gemm.cuh"
#include "dense_wgmma.cuh"
#include "dense_wgmma_ss.cuh"
#include "gn_epilogue.cuh"

namespace {

using namespace dposer::dense;
namespace ss = dposer::wgss;

// What every route's epilogue takes: tp/gamma/beta [N], residual (nullable),
// out [B, N] fp32 and out_b [B, N] bf16 (either nullable, not both).
struct Epilogue {
  const float *tp, *gamma, *beta, *residual;
  float* out;
  __nv_bfloat16* out_b;
  int B, K, N;
};

// Every route is a programmatic launch (mbarrier.cuh): the time row and the
// GroupNorm affine (cols) and W's first stages are read before the wait for
// the launches before it, A (or its copy) and the residual after it.
using dposer::Programmatic;

__device__ __forceinline__ Cols cols_of(const Epilogue& p, int col0) {
  return load_cols(p.tp, p.gamma, p.beta, col0, nullptr, p.out_b);
}

template <int GS>
__device__ __forceinline__ void epilogue(const float* c, const Cols& cols, const Epilogue& p,
                                         int row0, int col0) {
  gn_silu_epilogue_q<GS>(c, cols, p.residual, p.out, row0, col0, p.B, p.N, p.out_b);
}

// The element-load path (fp32 A that TMA cannot address: K % 4 != 0 or a
// misaligned operand).
template <int GS>
__global__ void __launch_bounds__(THREADS)
dense_gn_silu_kernel(const float* A, const __nv_bfloat16* __restrict__ W,
                     const Epilogue p) {
  __shared__ __align__(128) Smem sm;

  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const Cols cols = cols_of(p, col0);
  gemm_tile<false, false, Programmatic>(sm, A, nullptr, W, row0, col0, p.B, p.K, p.N);
  epilogue<GS>(sm.c, cols, p, row0, col0);
}

// The Hopper path from fp32 A, on dense_wgmma.cuh's ring shape R.
template <int GS, class R>
__global__ void __launch_bounds__(THREADS)
dense_gn_silu_wgmma_kernel(const __grid_constant__ CUtensorMap tmA,
                           const __grid_constant__ CUtensorMap tmW, const Epilogue p) {
  extern __shared__ uint8_t smem[];

  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const Cols cols = cols_of(p, col0);
  const float* c = dposer::wgmma::gemm_tile<R, Programmatic>(smem, &tmA, &tmW, row0, col0, p.K);
  epilogue<GS>(c, cols, p, row0, col0);
}

// The bf16 route's rings (dense_wgmma_ss.cuh, one consumer warpgroup, one
// 64 x 64 tile a CTA, 64 K-columns a stage): a grid that fits the SMs once
// takes the deep ring (8 stages, one wgmma group left in flight, one CTA an
// SM), a larger one the shallow ring (5 stages, each group waited on, two
// CTAs an SM at most).
using DeepRing = ss::Ring<1, 8, 1, 1>;
using ShallowRing = ss::Ring<1, 5, 2, 0>;

namespace handoff {

// The Hopper path from the bf16 copy of A that the layer before wrote, on
// dense_wgmma_ss.cuh's ring R: warp 4 produces (TMA of the copy and W),
// warps 0-3 multiply (wgmma with both operands from shared memory) and leave
// the tile in the ring's memory, and all eight warps run the epilogue.
template <int GS, class R>
__global__ void __launch_bounds__(THREADS, R::MIN_BLOCKS)
dense_gn_silu_wgmma_kernel(const __grid_constant__ CUtensorMap tmA,
                           const __grid_constant__ CUtensorMap tmW, const Epilogue p) {
  static_assert(R::WG == 1 && R::PRODUCER_WARP == 4, "one consumer warpgroup, warps 0-3");
  static_assert(BM * C_LD * 4 <= R::RING_BYTES, "the epilogue's tile must fit the ring");
  extern __shared__ uint8_t smem_raw[];
  const ss::Loop<R> loop(smem_raw, p.K);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const bool producer = warp == R::PRODUCER_WARP && lane == 0;
  const Cols cols = cols_of(p, col0);
  if (producer) loop.start_w(&tmA, &tmW, row0, col0, p.B);
  Programmatic{}();  // the launches before this one are done: A's copy is written
  if (producer) loop.start_a(&tmA, row0, p.B);
  __syncthreads();  // the barriers are in place
  float* c = reinterpret_cast<float*>(loop.ring);
  if (warp == R::PRODUCER_WARP) {
    if (lane == 0) loop.produce(&tmA, &tmW, row0, col0, p.B);
    __syncwarp();
  } else if (warp < 4) {
    float acc[32];
    loop.consume(acc, 0, lane);
    // every consumer is done with the ring before it becomes the tile
    asm volatile("bar.sync 1, 128;" ::: "memory");
    const int r0 = 16 * warp + (lane >> 2), t = lane & 3;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<float2*>(&c[r0 * C_LD + 8 * j + 2 * t]) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(&c[(r0 + 8) * C_LD + 8 * j + 2 * t]) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  __syncthreads();
  epilogue<GS>(c, cols, p, row0, col0);
}

}  // namespace handoff

template <int GS, class R>
int launch_wgmma(dim3 grid, const float* A, const __nv_bfloat16* W, const Epilogue& p,
                 cudaStream_t stream) {
  CUtensorMap ma, mw;
  const int e = dposer::wgmma::gemm_maps<R>(&ma, &mw, A, W, p.B, p.K, p.N);
  if (e != 0) return e;
  return dposer::wgmma::launch<R, dense_gn_silu_wgmma_kernel<GS, R>, Programmatic>(grid, stream,
                                                                                   ma, mw, p);
}

template <int GS, class R>
int launch_bf16(dim3 grid, const void* Ab, const void* W, const Epilogue& p,
                cudaStream_t stream) {
  CUtensorMap ma, mw;
  const int e = ss::maps(&ma, &mw, Ab, W, p.B, p.K, p.N);
  if (e != 0) return e;
  return dposer::wgmma::launch<R, handoff::dense_gn_silu_wgmma_kernel<GS, R>, Programmatic>(
      grid, stream, ma, mw, p);
}

template <int GS>
int launch(const float* A, const void* Ab, const __nv_bfloat16* W, const Epilogue& p,
           cudaStream_t stream) {
  const dim3 grid(p.N / BN, (p.B + BM - 1) / BM);
  const bool one_wave = dposer::wgmma::one_wave(grid.x * grid.y);
  if (Ab != nullptr)
    return one_wave ? launch_bf16<GS, DeepRing>(grid, Ab, W, p, stream)
                    : launch_bf16<GS, ShallowRing>(grid, Ab, W, p, stream);
  if (!dposer::wgmma::tma_ok(A, W, p.K, p.N)) {
    const cudaError_t e =
        dposer::launch_programmatic(dense_gn_silu_kernel<GS>, grid, THREADS, 0, stream, A, W, p);
    return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
  }
  return one_wave ? launch_wgmma<GS, dposer::wgmma::Wide>(grid, A, W, p, stream)
                  : launch_wgmma<GS, dposer::wgmma::Narrow>(grid, A, W, p, stream);
}

template <int GS, class R>
int bf16_launch_info(int* out) {
  const auto kernel = handoff::dense_gn_silu_wgmma_kernel<GS, R>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  out[0] = THREADS;
  out[1] = R::SMEM_BYTES;
  out[2] = R::STAGES;
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], kernel, THREADS, R::SMEM_BYTES));
}

}  // namespace

// A [B, K] fp32 (the fp32 routes) or Ab [B, K] bf16 (the bf16 route: the
// copy of A that the layer before wrote; K % 8 == 0, Ab and W 16-byte
// aligned, else refused), W [K, N] bf16, tp/gamma/beta [N] fp32, residual
// (nullable) and out [B, N] fp32 (out may alias residual), out_b [B, N] bf16:
// the copy of out for the next layer. out and out_b are each nullable, not
// both. N/32 (the group size) must be a power of two <= 32 and N a multiple
// of 64. Returns 0, the error of a failed tensor-map encode, or
// cudaGetLastError() after the launch.
extern "C" int dposer_dense_gn_silu(const float* A, const void* Ab, const void* W,
                                    const float* tp, const float* gamma, const float* beta,
                                    const float* residual, float* out, void* out_b, int B,
                                    int K, int N, void* stream) {
  const Epilogue p{tp, gamma, beta, residual, out, static_cast<__nv_bfloat16*>(out_b), B, K, N};
  const auto* w = static_cast<const __nv_bfloat16*>(W);
  const auto s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || K <= 0 || N % BN != 0 || (out == nullptr && out_b == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (Ab != nullptr ? !ss::tma_ok(Ab, W, K, N) : A == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return ss::by_group_size(N, [&](auto gs) {
    return launch<decltype(gs)::value>(A, Ab, w, p, s);
  });
}

// The bf16 route at B rows and width N as it launches on this card, for
// reports: out = {threads, dynamic shared memory a CTA, ring stages, CTAs an
// SM holds at once}. Returns 0 or a CUDA error.
extern "C" int dposer_dense_gn_silu_bf16_launch_info(int B, int N, int* out) {
  const bool one_wave = dposer::wgmma::one_wave((N / BN) * ((B + BM - 1) / BM));
  return ss::by_group_size(N, [&](auto gs) {
    constexpr int GS = decltype(gs)::value;
    return one_wave ? bf16_launch_info<GS, DeepRing>(out) : bf16_launch_info<GS, ShallowRing>(out);
  });
}
