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
// Design: two routes, chosen by the operand, never as a fallback.
// - Given Ab, the bf16 copy of A that the layer before wrote (every K = 1024
//   layer of network_hidden), the bf16 route: dense_wgmma_ss.cuh's loop
//   (warp 4 starts TMA copies of the copy and W into a ring of 64-column
//   stages; warps 0-3, one warpgroup, run wgmma m64n64k16 with both operands
//   from shared memory), the sums written to a tile in the ring's memory,
//   and all eight warps in the epilogue. No register holds an operand, so
//   no instruction defines a wgmma input while one is in flight: no
//   serialized wgmma (C7513), and a group may be left in flight.
// - Given fp32 A with K <= 128 (the pre layer, A = the [B, 63] state of
//   axis-angle poses or the [B, 126] one of rot6d poses, a 252- or 504-byte
//   row stride TMA cannot take; whatever A's alignment), the pre route
//   (namespace pre, below): one 64-deep K-tile at K <= 64, two beyond.
// Any other operand is refused: a caller with fp32 A at K > 128 passes its
// bf16 copy.
// A GroupNorm group is N/32 consecutive features, so with N/32 <= 32 a
// 64-wide tile holds whole groups in the natural feature order. Both routes
// end in gn_epilogue.cuh::gn_silu_epilogue_q (K13's: each warp's sixteen
// GroupNorm chains interleaved, two-pass fp32 mean and variance) with its
// bf16 instantiation: it adds the time row, applies the affine, SiLU and
// the residual, writes the fp32 out (unless nothing reads it) and, given
// out_b, out_b = __float2bfloat16_rn(out): the next layer's Ab, the
// rounding that layer would make of the fp32 out, so the products are the
// same.
//
// What bounds the bf16 route: not the MMAs, nor HBM. A 500-row layer is 128
// CTAs, one an SM, each reading 256 KB of the copy and W from L2 through
// its ring; on the card (NVIDIA H100 80GB HBM3 at 700 W, CUDA-graph replay,
// chip_smoke.py and benchmarks/k1_rings.py) a block's first layer takes
// 7.4-7.5 us, with the residual 8.0-8.1, at 1,000 rows 10.6-11.9; the
// route it replaced (fp32 A rounded to bf16 in registers, dense_wgmma.cuh's
// loop) at the same shapes 8.8-9.2, 9.3 and 13.8-14.3, and before the
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
// The pre route: a 64-row block of the [B, K] state is one contiguous span
// (64 x 252 = 16,128 bytes at K = 63, 16-byte aligned wherever the base is;
// 64 x 504 = 32,256 at rot6d's K = 126, the two-tile instantiation below).
// One thread starts W's 64 x 64 box by TMA (row 63 reads as zero) before the
// wait and the span by one bulk copy after it; all eight warps round it once
// into the swizzled bf16 tile wgmma reads (column 63 and the rows past B
// zero), warps 0-3 run four wgmma m64n64k16 from shared memory. The products
// and their order are this route's on A and W zero-padded to K = 64 and the
// bf16 route's on their copies, so the outputs are those routes' bit for
// bit. 72-78 registers, no spills, 33.8 KB of static shared memory: the
// registers would let three CTAs share an SM, and a launch reserves dynamic
// shared memory (read by none) so that an SM holds one where the grid fits
// the SMs once (500 rows) and two beyond (1,000 rows: 256 CTAs, one wave). Bound: bytes, 3.34 MB at 500 rows with the copy (1.00 us), 6.54
// MB at 1,000 (1.95 us); what is left is the latency of the span's load after
// the wait and the epilogue. On the card (NVIDIA H100 80GB HBM3 at 700 W,
// CUDA-graph replay of programmatic launches, benchmarks/k1_pre.py) the pre
// layer takes 4.28-4.42 us at 500 rows and 5.70-5.82 at 1,000 (the element
// loads it replaced, dense_gemm.cuh's WMMA loop, 5.12-5.22 and 9.97-10.20:
// 254 registers, one CTA an SM, two waves at 1,000 rows), followed by a
// block's first layer 11.43-11.70 and 15.39-15.68 (12.10-12.31 and
// 20.40-20.68); a generation call at 500 rows 36.52-36.68 ms (37.15-37.21)
// and a completion solve at 1,000 rows 10.03-10.31 (11.05-11.28).
// Left out after measurement there: two CTAs an SM at 500 rows too
// (12.31-12.54 us with the block layer, 37.06-37.17 ms a call; most likely as
// a programmatic launch's CTAs are placed while the launch before drains, two
// an SM on the SMs that free first, so half the SMs run the layer), no
// reservation (three an SM: 7.19-7.39 us alone at 1,000 rows, 10.38-10.72 ms
// a solve), and 16-byte loads of every thread in place of the bulk copy
// (5.26-5.62 and 6.63-6.74 us alone); a misaligned span takes every thread's
// 4-byte loads.
// Programmatic dependent launch (mbarrier.cuh): both routes are launched
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
// The two-tile instantiation (64 < K <= 128, rot6d's 126): the same body
// over two 64-deep K-tiles: W's two 64 x 64 boxes (rows past K read as
// zeros), the span rounded into two swizzled bf16 tiles (columns past K
// zero), eight wgmma m64n64k16. Its 66.6 KB of shared memory (the span alone
// 32 KB) is past what a CTA may declare statically, so it takes dynamic
// shared memory, as large as the reservation that sets the CTAs an SM
// holds; the one-tile instantiation keeps its static shared memory and
// its reservation. Bound: bytes, 3.59 MB at 500 rows with the copy (1.07 us).
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

// What both routes' epilogues take: tp/gamma/beta [N], residual (nullable),
// out [B, N] fp32 and out_b [B, N] bf16 (either nullable, not both).
struct Epilogue {
  const float *tp, *gamma, *beta, *residual;
  float* out;
  __nv_bfloat16* out_b;
  int B, K, N;
};

// Both routes are programmatic launches (mbarrier.cuh): the time row and the
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

namespace pre {

// The pre layer's shared memory for KT 64-deep K-tiles, at offsets from a
// 1024-byte aligned base: the bf16 A tiles (each 64 rows of 64 K-columns,
// one 128-byte swizzle atom a row, as TMA would write it), W's boxes (each
// 64 K-rows x 64 columns, MN-major, written by TMA; together the K-rows in
// order), A's fp32 rows as they lie in memory (64 x K, K <= 64 KT) and the
// barrier that counts W's boxes and A's bulk copy in. The epilogue's fp32
// tile [BM][C_LD] overlays the first three once the product is done. One
// tile: static shared memory; two: dynamic (past the static 48 KB).
constexpr int KTILE = 64;  // K-columns a tile, W's K-rows a box
template <int KT>
struct Smem {
  static constexpr int KMAX = KTILE * KT;
  static constexpr int A_TILE = BM * KTILE * 2, W_BOX = KTILE * BN * 2;
  static constexpr int TILE_A = 0;
  static constexpr int TILE_W = TILE_A + KT * A_TILE;
  static constexpr int RAW = TILE_W + KT * W_BOX;
  static constexpr int BAR = RAW + BM * KMAX * 4;
  static constexpr int SMEM = 1024 + BAR + 8;  // aligned by hand
  static constexpr bool STATIC = KT == 1;
  static_assert(BM * C_LD * 4 <= BAR, "the epilogue's tile must fit below the barrier");
};

using dposer::bulk_copy;
using dposer::mbar_expect_tx;
using dposer::mbar_init;
using dposer::mbar_wait;
using dposer::smem_u32;
using dposer::tma_load;

// The route for fp32 A with K <= 64 KT (the pre layer, A = the [B, 63] or
// [B, 126] state): a 64-row block of A is one contiguous span. One thread
// starts W's KT boxes (TMA; rows past K read as zeros) before the wait for
// the launches before this one and A's span after it (one bulk copy where
// the span starts 16-byte aligned, its last values under 16 bytes and a
// misaligned span by coalesced loads of every thread). All eight warps round
// the span into the KT swizzled bf16 tiles once (columns past K and rows
// past B zero), warps 0-3 run 4 KT wgmma m64n64k16 with both operands from
// shared memory, and all eight the epilogue. The products and their order
// are this route's on A and W zero-padded to K = 64 KT and the bf16 route's
// on their copies.
template <int GS, int KT>
__global__ void __launch_bounds__(THREADS, 2)
dense_gn_silu_kernel(const float* A, const __grid_constant__ CUtensorMap tmW, const Epilogue p) {
  using S = Smem<KT>;
  uint8_t* base;
  if constexpr (S::STATIC) {
    __shared__ __align__(128) uint8_t smem_raw[S::SMEM];
    base = smem_raw;
  } else {
    extern __shared__ __align__(128) uint8_t smem_dyn[];
    base = smem_dyn;
  }
  uint8_t* sm = base + ((1024 - (smem_u32(base) & 1023)) & 1023);
  const uint32_t sm_s = smem_u32(sm), bar = sm_s + S::BAR;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int rows = min(BM, p.B - row0), n = rows * p.K;  // the span's fp32 values
  const Cols cols = cols_of(p, col0);
  const float* span = A + static_cast<size_t>(row0) * p.K;
  const int n_bulk = reinterpret_cast<uintptr_t>(span) % 16 == 0 ? n & ~3 : 0;
  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tmW)) : "memory");
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(bar, static_cast<uint32_t>(KT * S::W_BOX + 4 * n_bulk));
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) tma_load(sm_s + S::TILE_W + kt * S::W_BOX, &tmW, bar, col0,
                                             KTILE * kt);
  }
  Programmatic{}();  // the launches before this one are done: A is written
  span = dposer::after_wait(span);
  float* raw = reinterpret_cast<float*>(sm + S::RAW);
  if (tid == 0 && n_bulk > 0) bulk_copy(sm_s + S::RAW, span, 4 * n_bulk, bar);
  for (int i = n_bulk + tid; i < n; i += THREADS) raw[i] = span[i];
  __syncthreads();  // the barrier is in place, the threads' values are in
  mbar_wait(bar, 0);
  // In K-tile kt, thread t rounds the 16-byte chunks (r, c) = (q % 64,
  // q / 64) of q = t, t + 256: eight K-columns 64 kt + 8c.. of row r, stored
  // at chunk c ^ (r % 8) of the tile's row (the 128-byte swizzle). A warp
  // reads 32 rows at one column (stride K, odd at K = 63: distinct banks; at
  // K = 126 two rows a bank) and stores 8 distinct chunks of 8 rows a
  // quarter: no bank conflicts.
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = tid + THREADS * i, r = q % BM, c = q / BM;
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = KTILE * kt + 8 * c + j;
        v[j] = r < rows && k < p.K ? raw[r * p.K + k] : 0.0f;
      }
      using dposer::wgmma::pack_bf16;
      *reinterpret_cast<uint4*>(sm + S::TILE_A + kt * S::A_TILE + r * 128 +
                                ((c ^ (r & 7)) << 4)) =
          make_uint4(pack_bf16(make_float2(v[0], v[1])), pack_bf16(make_float2(v[2], v[3])),
                     pack_bf16(make_float2(v[4], v[5])), pack_bf16(make_float2(v[6], v[7])));
    }
  }
  // the tile's generic stores become visible to wgmma's reads (async proxy)
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  float* c = reinterpret_cast<float*>(sm);
  if (warp < 4) {
    using namespace dposer::wgmma;
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < 32; ++i) keep(acc[i]);
    wgmma_fence();
    // k-step kk: A's tile kk / 4 at 32 bytes a step into its swizzle row,
    // W's K-rows 16 kk.. (the boxes lie one after the other)
#pragma unroll
    for (int kk = 0; kk < S::KMAX / 16; ++kk)
      wgmma_m64n64k16_ss(acc, desc_k(sm_s + S::TILE_A + (kk / 4) * S::A_TILE + 32 * (kk % 4)),
                         desc_b(sm_s + S::TILE_W + kk * 2048));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 32; ++i) keep(acc[i]);
    // every consumer's wgmma is done with the tiles before they become c
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

// W's map (64 K-rows x 64 columns a box, so rows past K read as zeros) for
// W 16-byte aligned, K <= 128 and N % 8 == 0; else the route does not apply.
inline bool ok(const void* W, int K, int N) {
  return K <= Smem<2>::KMAX && N % 8 == 0 && reinterpret_cast<uintptr_t>(W) % 16 == 0;
}

// The CTAs an SM a grid of the pre route may hold: one where the grid fits
// the SMs once, two beyond.
inline int ctas_per_sm(bool one_wave) { return one_wave ? 1 : 2; }

// The dynamic shared memory a launch of the KT-tile kernel takes so that an
// SM of the current device holds `ctas` of its CTAs and no more: with one
// tile a reservation the kernel reads none of, with two its own shared
// memory grown to that size.
template <int KT>
inline int reserve(int ctas) {
  static int per_sm = 0, per_block = 0;
  if (per_sm == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    cudaDeviceGetAttribute(&per_block, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  }
  using S = Smem<KT>;
  // a CTA then takes more than 1/(ctas + 1) of the SM's shared memory
  const int dyn = per_sm / (ctas + 1) + 1024 - (S::STATIC ? S::SMEM : 0) - per_block;
  return S::STATIC || dyn > S::SMEM ? dyn : S::SMEM;
}

}  // namespace pre

template <int GS, class R>
int launch_bf16(dim3 grid, const void* Ab, const void* W, const Epilogue& p,
                cudaStream_t stream) {
  CUtensorMap ma, mw;
  const int e = ss::maps(&ma, &mw, Ab, W, p.B, p.K, p.N);
  if (e != 0) return e;
  return dposer::wgmma::launch<R, handoff::dense_gn_silu_wgmma_kernel<GS, R>, Programmatic>(
      grid, stream, ma, mw, p);
}

template <int GS, int KT>
int launch_pre(dim3 grid, bool one_wave, const float* A, const __nv_bfloat16* W,
               const Epilogue& p, cudaStream_t stream) {
  const auto kernel = pre::dense_gn_silu_kernel<GS, KT>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pre::reserve<KT>(1));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap mw;
  const int e = dposer::tensor_map(&mw, W, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.N, p.K, BN,
                                   pre::KTILE);
  if (e != 0) return e;
  const int dyn = pre::reserve<KT>(pre::ctas_per_sm(one_wave));
  const cudaError_t l =
      dposer::launch_programmatic(kernel, grid, THREADS, dyn, stream, A, mw, p);
  return static_cast<int>(l != cudaSuccess ? l : cudaGetLastError());
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

// Ab [B, K] bf16 (the bf16 route: the copy of A that the layer before
// wrote; K % 8 == 0, Ab and W 16-byte aligned) or, with Ab null, A [B, K]
// fp32 at K <= 128 (the pre route, one K-tile at K <= 64, two beyond; W
// 16-byte aligned), else refused
// (cudaErrorInvalidValue); W [K, N] bf16, tp/gamma/beta [N] fp32, residual
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
  if (Ab != nullptr ? !ss::tma_ok(Ab, W, K, N) : (A == nullptr || !pre::ok(W, K, N)))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(N / BN, (B + BM - 1) / BM);
  const bool one_wave = dposer::wgmma::one_wave(grid.x * grid.y);
  return ss::by_group_size(N, [&](auto gs) {
    constexpr int GS = decltype(gs)::value;
    if (Ab == nullptr)
      return K <= pre::KTILE ? launch_pre<GS, 1>(grid, one_wave, A, w, p, s)
                             : launch_pre<GS, 2>(grid, one_wave, A, w, p, s);
    return one_wave ? launch_bf16<GS, DeepRing>(grid, Ab, W, p, s)
                    : launch_bf16<GS, ShallowRing>(grid, Ab, W, p, s);
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

// The pre route at B rows and width N as it launches on this card, for
// reports: out = {threads, static shared memory a CTA, the dynamic shared
// memory it reserves, registers a thread, local memory a thread (spills),
// CTAs an SM holds at once}. Returns 0 or a CUDA error. The pre2 entry: its
// two-tile instantiation (64 < K <= 128), whose dynamic shared memory is its
// own.
template <int KT>
int pre_launch_info(int B, int N, int* out) {
  const bool one_wave = dposer::wgmma::one_wave((N / BN) * ((B + BM - 1) / BM));
  return ss::by_group_size(N, [&](auto gs) {
    const auto kernel = pre::dense_gn_silu_kernel<decltype(gs)::value, KT>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         pre::reserve<KT>(1));
    cudaFuncAttributes a{};
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, kernel);
    if (e != cudaSuccess) return static_cast<int>(e);
    out[0] = THREADS;
    out[1] = static_cast<int>(a.sharedSizeBytes);
    out[2] = pre::reserve<KT>(pre::ctas_per_sm(one_wave));
    out[3] = a.numRegs;
    out[4] = static_cast<int>(a.localSizeBytes);
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[5], kernel, THREADS, out[2]));
  });
}

extern "C" int dposer_dense_gn_silu_pre_launch_info(int B, int N, int* out) {
  return pre_launch_info<1>(B, N, out);
}

extern "C" int dposer_dense_gn_silu_pre2_launch_info(int B, int N, int* out) {
  return pre_launch_info<2>(B, N, out);
}
