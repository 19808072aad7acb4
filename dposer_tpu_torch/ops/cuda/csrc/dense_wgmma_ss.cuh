// The Hopper GEMM main loop of the train step's layer kernels, shared by K10
// dense_gn_silu_train (every layer whose input is the bf16 copy the layer
// before wrote: the four K = 1024 layers of a step) and K12
// dense_gn_silu_bwd (every hop), and of K1 dense_gn_silu's bf16 route (the
// four K = 1024 layers of a sampler's forward, on rings of its own:
// dense_gn_silu.cu):
//   C[r, c] = sum_k A[r, k] * W[k, c]
// with A bf16 [B, K] (K contiguous) and W bf16 [K, N] (N contiguous),
// fp32 accumulation. Nothing is converted in the loop: both operands go
// from TMA straight into wgmma.
//
// Replaces, on the TPU: the bf16 matmuls of the train kernel's stack_fwd
// and stack_bwd, dposer_tpu/ops/pallas/fused_train.py::_make_kernel
// (:132-149, :151-166, the mm(., W^T) hops of :193-206).
//
// Design (one CTA = one 64 x WG rows by 64 columns output tile):
// - Warp 4 * WG is the producer: one lane starts TMA copies into a ring of
//   STAGES stages, each A's WG boxes of 64 rows x 64 bf16 (one 128-byte
//   swizzle atom a row; rows past the batch read as zeros, and a box wholly
//   past it is not copied) and one W box of 64 K-rows x 64 columns, both with
//   the 128-byte swizzle. A "full" mbarrier a stage counts the bytes in, an
//   "empty" one the consumer warps out.
// - Warpgroup g (warps 4g .. 4g + 3) multiplies A's box g by the W box:
//   wgmma m64n64k16 with both operands from shared memory (A K-major through
//   dense_wgmma.cuh::desc_k, W MN-major through desc_b), fp32 sums in
//   registers. Each stage is its own wgmma group. K10 waits on it before
//   releasing the stage; K12 leaves it running while the next stage's
//   group is issued (Ring::IN_FLIGHT = 1) and releases a stage once its
//   group is done. Nothing but the wgmmas defines the accumulators while a
//   group runs, which keeps ptxas from serializing them (C7515).
// - The sums stay in registers: to_rows turns the wgmma accumulator layout
//   into the row layout the epilogues work in (one lane swap a column pair),
//   in which thread (w, lane) of a warpgroup holds one tile row,
//   16 w + lane / 4 + 8 (lane & 1), at the 32 columns 8 j + 4 h + q
//   (h = (lane >> 1) & 1, j < 8, q < 4). So every lane loads and stores its
//   row's operands 16 (fp32) or 8 (bf16) bytes at a time, and a GroupNorm
//   group of GS consecutive columns is in-lane sums plus, for GS >= 8, one
//   shuffle with lane ^ 2 (row_group_sums).
// - K1's bf16 route, a programmatic launch (mbarrier.cuh), starts its ring
//   in two parts around the wait for the launches before it: start_w sets
//   the barriers up and starts W's boxes of the first stages, each stage's
//   barrier expecting A's bytes and W's together; start_a, after the wait,
//   starts A's boxes (the copy the layer before wrote). W may be fetched
//   before the wait because no launch of a sampler's loop writes it. K10 and
//   K12 keep start and their plain launch (launch below).
// TMA needs 16-byte aligned rows and bases: K % 8 == 0 (a ragged last
// 64-deep box reads zeros past K) and N % 8 == 0.
//
// Bound on the H100: both kernels are bytes bound (their headers), and at
// 1,280 rows one wave of 320 tiles, three CTAs an SM, takes each CTA's
// 256 KB of A and W from L2. What the loop adds to a launch: K12's hidden
// hop (K = 1024) takes 6.6 us more than its first (K = 64), whose epilogue
// moves the same bytes (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W).
//
// Kept out after measurement (dposer_tpu_torch/benchmarks/train_rings.py,
// NVIDIA H100 80GB HBM3 at 700 W, CUDA-graph replay; K10's block layer with
// its residual / K12's hidden hop with the carried gradient, at [1280, 1024]
// x [1024, 1024]; the shipped loops 18.1 / 18.7 us):
// - 128-row tiles (two consumer warpgroups, 160 CTAs, two an SM): 19.5 /
//   24.7 us;
// - 6 stages and two CTAs an SM: 22.9 / 26.5 us; 3 stages and four CTAs an
//   SM: 17.8 / 22.6 us;
// - K10 with one wgmma group left in flight (wait_group 1): 18.1 us, and
//   its block layer without the fp32 output 15.4 against 15.2, a wash, so
//   K10 waits on each group as K7's loop does; K12 waiting on each group:
//   19.2 us (its first hop 11.0 against 10.9), so K12 leaves one in flight.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dense_wgmma.cuh"
#include "mbarrier.cuh"
#include "tensor_map.cuh"

namespace dposer {
namespace wgss {

constexpr int BN = 64;            // output columns a CTA
constexpr int KSTAGE = 64;        // K-columns a stage
constexpr int BOX = 64 * 128;     // one A or W box: 64 rows x 128 bytes
constexpr int RED_LD = BN + 4;    // fp32 row stride of an epilogue's reduction tile

// The ring's shape: WG consumer warpgroups (tile rows 64 * WG), STAGES
// stages; MIN_BLOCKS the CTAs an SM should hold at once (the register cap);
// IN_FLIGHT the wgmma groups (0 or 1) a consumer leaves running when it
// waits: with 1, stage kt is released once stage kt + 1's group is issued.
template <int WG_, int STAGES_, int MIN_BLOCKS_, int IN_FLIGHT_ = 0>
struct Ring {
  static constexpr int WG = WG_;
  static constexpr int STAGES = STAGES_;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int IN_FLIGHT = IN_FLIGHT_;
  static_assert(IN_FLIGHT == 0 || IN_FLIGHT == 1, "one group in flight at most");
  static constexpr int BM = 64 * WG;
  static constexpr int CONSUMERS = 128 * WG;
  static constexpr int THREADS = CONSUMERS + 32;
  static constexpr int PRODUCER_WARP = 4 * WG;
  static constexpr int A_BYTES = WG * BOX;
  static constexpr int STAGE_BYTES = A_BYTES + BOX;
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  // slack to align the ring to the swizzle's 1024 bytes, the ring, the full
  // and empty barriers
  static constexpr int SMEM_BYTES = 1024 + RING_BYTES + 2 * STAGES * 8;
};

// ---------------------------------------------------------------------------
// device side
// ---------------------------------------------------------------------------

// The ring in a CTA's dynamic shared memory and its barriers.
template <class R>
struct Loop {
  uint8_t* ring;
  uint32_t ring_s, full0, empty0;
  int n_k;

  __device__ __forceinline__ Loop(uint8_t* smem_raw, int K) {
    ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    ring_s = smem_u32(ring);
    full0 = ring_s + R::RING_BYTES;
    empty0 = full0 + R::STAGES * 8;
    n_k = (K + KSTAGE - 1) / KSTAGE;
  }

  // Start the copies of K-tile kt into its stage (the stage is free); A's
  // boxes wholly past the batch's B rows are left out.
  __device__ __forceinline__ void copy_stage(const CUtensorMap* tmA, const CUtensorMap* tmW,
                                             int row0, int col0, int B, int kt) const {
    const int s = kt % R::STAGES;
    const uint32_t stage = ring_s + s * R::STAGE_BYTES, full = full0 + 8 * s;
    const int boxes = min(R::WG, (B - row0 + 63) / 64);
    mbar_expect_tx(full, static_cast<uint32_t>(boxes * BOX + BOX));
    for (int g = 0; g < boxes; ++g) tma_load(stage + g * BOX, tmA, full, kt * KSTAGE, row0 + 64 * g);
    tma_load(stage + R::A_BYTES, tmW, full, col0, kt * KSTAGE);
  }

  // The producer lane: fetch the tensor maps and set the barriers up.
  __device__ __forceinline__ void init(const CUtensorMap* tmA, const CUtensorMap* tmW) const {
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(tmA)) : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(tmW)) : "memory");
    for (int s = 0; s < R::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * R::WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  // The producer lane, before the block barrier that publishes the
  // barriers: set them up and start the first stages' copies.
  __device__ __forceinline__ void start(const CUtensorMap* tmA, const CUtensorMap* tmW, int row0,
                                        int col0, int B) const {
    init(tmA, tmW);
    for (int kt = 0; kt < R::STAGES && kt < n_k; ++kt) copy_stage(tmA, tmW, row0, col0, B, kt);
  }

  // The producer lane of a programmatic launch (mbarrier.cuh), split around
  // the wait for the launches before it: start_w sets the barriers up and
  // starts W's boxes of the first stages, each stage expecting W's bytes and
  // A's together (the weights are the launch's constants, so they are
  // fetched under the tail of the launch before); start_a, after the wait,
  // starts A's boxes of those stages (A: the copy that launch wrote).
  __device__ __forceinline__ void start_w(const CUtensorMap* tmA, const CUtensorMap* tmW, int row0,
                                          int col0, int B) const {
    init(tmA, tmW);
    const int boxes = min(R::WG, (B - row0 + 63) / 64);
    for (int kt = 0; kt < R::STAGES && kt < n_k; ++kt) {
      const uint32_t full = full0 + 8 * kt;
      mbar_expect_tx(full, static_cast<uint32_t>(boxes * BOX + BOX));
      tma_load(ring_s + kt * R::STAGE_BYTES + R::A_BYTES, tmW, full, col0, kt * KSTAGE);
    }
  }

  __device__ __forceinline__ void start_a(const CUtensorMap* tmA, int row0, int B) const {
    const int boxes = min(R::WG, (B - row0 + 63) / 64);
    for (int kt = 0; kt < R::STAGES && kt < n_k; ++kt)
      for (int g = 0; g < boxes; ++g)
        tma_load(ring_s + kt * R::STAGE_BYTES + g * BOX, tmA, full0 + 8 * kt, kt * KSTAGE,
                 row0 + 64 * g);
  }

  // The producer lane, after the block barrier: each further stage once the
  // consumers have released it.
  __device__ __forceinline__ void produce(const CUtensorMap* tmA, const CUtensorMap* tmW, int row0,
                                          int col0, int B) const {
    for (int kt = R::STAGES; kt < n_k; ++kt) {
      mbar_wait(empty0 + 8 * (kt % R::STAGES), ((kt / R::STAGES) & 1) ^ 1);
      copy_stage(tmA, tmW, row0, col0, B, kt);
    }
  }

  // A consumer warp of warpgroup g: its share of box g's 64 x 64 product in
  // the wgmma accumulator layout.
  __device__ __forceinline__ void consume(float (&acc)[32], int g, int lane) const {
    using namespace dposer::wgmma;
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
    for (int kt = 0; kt < n_k; ++kt) {
      const int s = kt % R::STAGES;
      mbar_wait(full0 + 8 * s, (kt / R::STAGES) & 1);
      __syncwarp();  // the warp converged again for the .aligned wgmma instructions
      const uint32_t a = ring_s + s * R::STAGE_BYTES + g * BOX;
      const uint32_t w = ring_s + s * R::STAGE_BYTES + R::A_BYTES;
      if constexpr (R::IN_FLIGHT == 0) {  // no group runs here: the sums may be pinned
#pragma unroll
        for (int i = 0; i < 32; ++i) keep(acc[i]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KSTAGE / 16; ++kk)
        wgmma_m64n64k16_ss(acc, desc_k(a + 32 * kk), desc_b(w + kk * 2048));
      wgmma_commit();
      wgmma_wait<R::IN_FLIGHT>();
      __syncwarp();
      if (lane == 0 && kt >= R::IN_FLIGHT)  // the stage whose group is done
        mbar_arrive(empty0 + 8 * ((kt - R::IN_FLIGHT) % R::STAGES));
    }
    if constexpr (R::IN_FLIGHT != 0) wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 32; ++i) keep(acc[i]);
  }
};

// Named barrier over the CTA's consumer warps (the producer warp is not
// waited for).
template <class R>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(R::CONSUMERS) : "memory");
}

// This thread's tile row and column half in the row layout (w: the warp in
// its warpgroup).
__device__ __forceinline__ int row_of(int w, int lane) { return 16 * w + (lane >> 2) + 8 * (lane & 1); }
__device__ __forceinline__ int half_of(int lane) { return (lane >> 1) & 1; }

// The accumulators of an m64n64 wgmma (rows r0 = 16 w + lane / 4 and r0 + 8,
// columns 8 j + 2 t, + 1, t = lane % 4) in the row layout: e[4 j + q] at
// column 8 j + 4 h + q of row row_of(w, lane). Lanes t and t ^ 1 swap
// halves: the even lane keeps row r0, the odd one row r0 + 8.
__device__ __forceinline__ void to_rows(const float (&acc)[32], float (&e)[32], int lane) {
  const bool odd = lane & 1;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float x0 = __shfl_xor_sync(0xffffffffu, odd ? acc[4 * j] : acc[4 * j + 2], 1);
    const float x1 = __shfl_xor_sync(0xffffffffu, odd ? acc[4 * j + 1] : acc[4 * j + 3], 1);
    e[4 * j] = odd ? x0 : acc[4 * j];
    e[4 * j + 1] = odd ? x1 : acc[4 * j + 1];
    e[4 * j + 2] = odd ? acc[4 * j + 2] : x0;
    e[4 * j + 3] = odd ? acc[4 * j + 3] : x1;
  }
}

// The GroupNorm groups of GS consecutive columns in the row layout: PER of
// a group's values lie in one lane (value indices g * PER ..), NG groups
// touch a lane. Groups of GS >= 8 span the two halves (lanes l and l ^ 2).
template <int GS>
struct Groups {
  static constexpr int PER = GS >= 8 ? GS / 2 : GS;
  static constexpr int NG = 32 / PER;
  static_assert(GS == 2 || GS == 4 || GS == 8 || GS == 16 || GS == 32, "group size");

  // the tile column of value i of a lane in half h
  __device__ static __forceinline__ int col(int i, int h) { return 8 * (i / 4) + 4 * h + i % 4; }
  // whether this lane stores the per-group values (one lane a group)
  __device__ static __forceinline__ bool owner(int h) { return GS < 8 || h == 0; }
};

// In-lane group sums s[m][g] (each the sum of a group's values in this
// lane, in column order) to whole-group sums in every lane that holds part
// of the group: for GS >= 8 the other half's (lane ^ 2) sum is added. Both
// lanes add the same two numbers, so they hold the same bits.
template <int GS, int SETS>
__device__ __forceinline__ void across_halves(float (&s)[SETS][Groups<GS>::NG]) {
  if constexpr (GS >= 8) {
#pragma unroll
    for (int m = 0; m < SETS; ++m)
#pragma unroll
      for (int g = 0; g < Groups<GS>::NG; ++g) s[m][g] += __shfl_xor_sync(0xffffffffu, s[m][g], 2);
  }
}

// The sums of each of SETS value sets over every group, in every lane that
// holds part of the group: in-lane sums in column order, then across_halves.
template <int GS, int SETS>
__device__ __forceinline__ void row_group_sums(const float (&e)[SETS][32],
                                               float (&s)[SETS][Groups<GS>::NG]) {
  using G = Groups<GS>;
#pragma unroll
  for (int m = 0; m < SETS; ++m)
#pragma unroll
    for (int g = 0; g < G::NG; ++g) {
      float v = e[m][g * G::PER];
#pragma unroll
      for (int i = 1; i < G::PER; ++i) v += e[m][g * G::PER + i];
      s[m][g] = v;
    }
  across_halves<GS, SETS>(s);
}

// Four bf16 values (8 bytes) to fp32 and back, round to nearest even.
__device__ __forceinline__ float4 bf16x4_to_float4(uint2 u) {
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &u.x, 4);
  memcpy(&hi, &u.y, 4);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ uint2 float4_to_bf16x4(float a, float b, float c, float d) {
  return make_uint2(dposer::wgmma::pack_bf16(make_float2(a, b)),
                    dposer::wgmma::pack_bf16(make_float2(c, d)));
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// TMA addresses A's and W's rows with 16-byte aligned strides and bases.
inline bool tma_ok(const void* A, const void* W, int K, int N) {
  return K % 8 == 0 && N % 8 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(W) % 16 == 0;
}

// The maps of one call: A bf16 [B, K] in boxes of 64 x 64, W bf16 [K, N]
// in boxes of 64 x 64. Out-of-range rows and columns read as 0.
inline int maps(CUtensorMap* ma, CUtensorMap* mw, const void* A, const void* W, int B, int K,
                int N) {
  const int e = tensor_map(ma, A, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, K, B, 64, 64);
  return e != 0 ? e : tensor_map(mw, W, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, N, K, BN, KSTAGE);
}

// f(std::integral_constant<int, GS>) at the group size GS = N / 32 of a
// GroupNorm of 32 groups over N features (2, 4, 8, 16 or 32); else
// cudaErrorInvalidValue.
template <class F>
int by_group_size(int N, F f) {
  switch (N / 32) {
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Launch KERNEL over `grid` with R::THREADS threads and R::SMEM_BYTES of
// dynamic shared memory (allowed once per kernel, on its first launch).
template <class R, auto KERNEL, typename... Args>
int launch(dim3 grid, cudaStream_t stream, Args... args) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, R::SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  KERNEL<<<grid, R::THREADS, R::SMEM_BYTES, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// How KERNEL launches, for reports: out = {threads, dynamic shared memory a
// CTA, tile rows, CTAs an SM holds at once}. Returns 0 or a CUDA error.
template <class R, auto KERNEL>
int launch_info(int* out) {
  const cudaError_t attr = cudaFuncSetAttribute(
      KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, R::SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  out[0] = R::THREADS;
  out[1] = R::SMEM_BYTES;
  out[2] = R::BM;
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], KERNEL, R::THREADS, R::SMEM_BYTES));
}

}  // namespace wgss
}  // namespace dposer
