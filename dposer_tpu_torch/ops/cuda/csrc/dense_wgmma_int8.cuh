// The Hopper int8 GEMM main loop of the network's hidden layers, shared by
// K13 dense_gn_silu_int8 (every layer whose int8 input an earlier layer's
// epilogue wrote: all K = 1024 layers) and K14 chain_link's int8 mode (every
// link but a call's first):
//   C[r, c] = float(sum_k Aq[r, k] * Wq[c, k]) * qs[c]
// with Aq int8 [B, K] (already quantized) and Wq int8 [N, K], both
// row-major, int32 accumulation, exact for K <= 1024 (|sum| <= K * 127^2 <
// 2^24). It computes what dense_gemm_int8.cuh::gemm_tile_int8 computes from
// the fp32 A that Aq quantizes, bit for bit, and leaves the 64x64 fp32 tile
// in shared memory as [BM][C_LD], where gn_epilogue.cuh and K14's stores
// read it unchanged.
//
// Replaces, on the TPU: the quant ``mm`` of
// dposer_tpu/ops/pallas/score_net.py:348-360 (int8 x int8 -> int32, the
// rescale row) inside dposer_tpu/ops/pallas/fused_em.py::_make_kernel, and
// the int8 chain matmul of benchmarks/mxu_micro.py:46-49 with its per-pass
// requantization. The quantization itself moved into the epilogue of the
// layer that produces the activation (gn_epilogue.cuh, QOUT), where the TPU
// kernel runs it at the head of the consuming matmul.
//
// Bound on the H100: bytes. A block layer at [500,1024]x[1024,1024] with
// its residual moves ~6.2 MB (Aq 0.5 MB, Wq 1 MB, the residual and the fp32
// out 2 MB each, the int8 copy 0.5 MB): ~1.85 us at 3.35 TB/s, against
// ~1.07 G int8 operations, ~0.54 us at the int8 tensor rate. Reading A as
// int8 instead of fp32 cuts A's bytes fourfold.
//
// Design (one block = one 64x64 output tile, 256 threads):
// - Warp 4 is the producer: one lane sets up one "full" mbarrier per stage
//   and starts every TMA copy of the block at once: per 128 K-columns a
//   stage of Aq [64 rows x 128 B] and Wq [64 N-rows x 128 B], both K-major,
//   one 128-byte swizzle atom per row (16-byte chunk c of row r lands at
//   chunk c ^ (r % 8)). At K = 1024 the whole K extent of both operands is 8
//   stages x 16 KB = 128 KB, so there is no ring: no empty barriers, no slot
//   reuse, nothing for the consumers to release. The launch sizes the
//   dynamic shared memory to K (ceil(K / 128) stages, the epilogue's 17 KB
//   tile in room of its own, the barriers): 146 KB at K = 1024, one block
//   an SM; the 128 blocks of a 500-row layer fit the 132 SMs once.
// - Warps 0-3, one warpgroup, are the consumer: per stage, wait on its full
//   barrier, then 4 wgmma.mma_async m64n64k32 s32.s8.s8 with both operands
//   from shared memory through descriptors, one commit_group, then
//   wait_group 0 before the next stage's barrier: the MMAs of a stage run
//   while later copies land, and finish before the next stage does (a
//   group left in flight across the barrier's spin loop made ptxas
//   serialize every wgmma, C7520). 8-bit wgmma takes both operands K-major
//   only, and they are: Aq is [B, K], Wq is [N, K]. A descriptor of a
//   128-byte-swizzled K-major operand: stride byte offset 1024 B (one 8-row
//   group), leading byte offset unused (1), start address advanced 32 B per
//   k32 step inside the atom (the swizzle is a function of the address bits,
//   so the step's chunks are found where TMA put them): dense_wgmma.cuh's
//   desc_k.
// - Nothing is converted in the loop: no register holds an operand, so no
//   instruction can define a wgmma input while one is in flight (ptxas
//   C7513, which serialized the bf16 loop's first version).
// - 32 int32 accumulators a thread, in the fp32 m64n64 fragment layout: rows
//   16w + lane/4 (+8), columns 8j + 2(lane%4) (+1). Each goes to the tile as
//   __fmul_rn(float(acc), qs[c]), the rounding of the register-staged loop.
//   The thread's 16 qs values are loaded while the copies fly.
// - Tensor maps (int8 [B, K] and [N, K], boxes of 128 x 64, the 128-byte
//   swizzle) are encoded on the host and cached (tensor_map.cuh), as K1's.
// - K13 launches programmatically (Dep = Programmatic, mbarrier.cuh): the
//   producer starts Wq's boxes of every stage, each stage expecting both
//   operands' bytes, then every thread waits for the launches before it
//   (griddepcontrol.wait) and triggers the next one's scheduling, and only
//   then does the producer start Aq's boxes, the copy the layer before
//   wrote. Wq may be fetched before the wait because no launch of a
//   sampler's loop writes it; the epilogue's rows (gn_epilogue.cuh's
//   load_cols) are read before it too, the residual and every write after.
//   K14's int8 links keep the plain launch (Dep = Serial).
// TMA needs 16-byte aligned rows and pointers: K % 16 == 0 and Aq, Wq
// 16-byte aligned. The pre layer (K = 63, fp32 state) takes K13's pre route
// (dense_gn_silu_int8.cu), which runs this file's wgmma s8 on tiles it lays
// out itself; a chain's first link (fp32 A) goes through
// dense_gemm_int8.cuh: the route follows the operand, and the C entries
// refuse an Aq that TMA cannot address.
#pragma once

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

#include "dense_gemm.cuh"
#include "dense_wgmma.cuh"
#include "mbarrier.cuh"
#include "tensor_map.cuh"

namespace dposer {
namespace wgmma8 {

using dense::BM;
using dense::BN;
using dense::C_LD;
using dense::THREADS;

constexpr int KSTAGE = 128;  // int8 K-columns a stage: one 128-byte swizzle atom a row
constexpr int MAX_K = 1024;  // the int32 sums stay exact in fp32
constexpr int A_BYTES = BM * KSTAGE;
constexpr int W_BYTES = BN * KSTAGE;
constexpr int STAGE_BYTES = A_BYTES + W_BYTES;
constexpr int TILE_BYTES = BM * C_LD * 4;
constexpr int PRODUCER_WARP = 4;
static_assert(BM == 64 && BN == 64 && THREADS == 256, "the layout below");
static_assert(TILE_BYTES % 8 == 0, "the barriers follow the tile");

__host__ __device__ constexpr int stages(int K) { return (K + KSTAGE - 1) / KSTAGE; }

// Dynamic shared memory of a block at depth K: slack to align the stages to
// the swizzle's 1024 bytes, the stages, the epilogue's tile, the barriers.
__host__ __device__ constexpr int smem_bytes(int K) {
  return 1024 + stages(K) * STAGE_BYTES + TILE_BYTES + 8 * stages(K);
}

__device__ __forceinline__ void keep(int& r) { asm volatile("" : "+r"(r)::"memory"); }

// d += A(descriptor a) * B(descriptor b), m64n64k32, s8 x s8 -> s32, both K-major.
__device__ __forceinline__ void wgmma_m64n64k32_s8(int (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n\t}"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// The block's 64x64 tile of float(Aq @ Wq^T) * qs at rows row0.. and
// columns col0.., returned as fp32 [BM][C_LD] in shared memory. Every thread
// of the block calls it, in a launch with smem_bytes(K) of dynamic shared
// memory; it ends on a block barrier. Dep (mbarrier.cuh) is called by every
// thread once the producer has started Wq's boxes of every stage and before
// it starts Aq's: a programmatic launch fetches its weights under the tail of
// the launch before it.
template <class Dep = Serial>
__device__ __forceinline__ const float* gemm_tile(uint8_t* smem_raw, const CUtensorMap* tmA,
                                                  const CUtensorMap* tmW,
                                                  const float* __restrict__ qs, int row0,
                                                  int col0, int K) {
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base_s = smem_u32(base);
  const int n_k = stages(K);
  float* tile = reinterpret_cast<float*>(base + n_k * STAGE_BYTES);
  const uint32_t full0 = base_s + n_k * STAGE_BYTES + TILE_BYTES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // The producer lane sets the barriers up and starts every copy before the
  // block barrier that publishes the barriers (a programmatic launch: Wq's
  // before Dep, each stage expecting both operands' bytes, Aq's after it).
  const bool producer = warp == PRODUCER_WARP && lane == 0;
  if (producer) {
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(tmA)) : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(tmW)) : "memory");
    for (int s = 0; s < n_k; ++s) mbar_init(full0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int kt = 0; kt < n_k; ++kt) {
      const uint32_t stage = base_s + kt * STAGE_BYTES, full = full0 + 8 * kt;
      mbar_expect_tx(full, STAGE_BYTES);
      if constexpr (!Dep::kProgrammatic) tma_load(stage, tmA, full, kt * KSTAGE, row0);
      tma_load(stage + A_BYTES, tmW, full, kt * KSTAGE, col0);
    }
  }
  if constexpr (Dep::kProgrammatic) {
    Dep{}();
    if (producer)
      for (int kt = 0; kt < n_k; ++kt)
        tma_load(base_s + kt * STAGE_BYTES, tmA, full0 + 8 * kt, kt * KSTAGE, row0);
  }
  __syncthreads();

  if (warp < 4) {
    int acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0;
    const int r0 = 16 * warp + (lane >> 2), t = lane & 3;
    float s0[8], s1[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s0[j] = qs[col0 + 8 * j + 2 * t];
      s1[j] = qs[col0 + 8 * j + 2 * t + 1];
    }
    for (int kt = 0; kt < n_k; ++kt) {
      mbar_wait(full0 + 8 * kt, 0);
      __syncwarp();  // the warp converged again for the .aligned wgmma instructions
      const uint32_t a = base_s + kt * STAGE_BYTES, b = a + A_BYTES;
      wgmma::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KSTAGE / 32; ++kk)
        wgmma_m64n64k32_s8(acc, wgmma::desc_k(a + 32 * kk), wgmma::desc_k(b + 32 * kk));
      wgmma::wgmma_commit();
      // no group stays in flight across the next barrier wait: a wgmma in
      // flight across that divergent spin made ptxas serialize every wgmma
      // (C7520); a stage's MMAs end well before the next stage lands
      wgmma::wgmma_wait<0>();
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) keep(acc[i]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * t;
      *reinterpret_cast<float2*>(&tile[r0 * C_LD + c]) =
          make_float2(__fmul_rn(static_cast<float>(acc[4 * j]), s0[j]),
                      __fmul_rn(static_cast<float>(acc[4 * j + 1]), s1[j]));
      *reinterpret_cast<float2*>(&tile[(r0 + 8) * C_LD + c]) =
          make_float2(__fmul_rn(static_cast<float>(acc[4 * j + 2]), s0[j]),
                      __fmul_rn(static_cast<float>(acc[4 * j + 3]), s1[j]));
    }
  }
  __syncthreads();
  return tile;
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// TMA addresses Aq's and Wq's rows with 16-byte aligned strides and bases.
inline bool tma_ok(const void* Aq, const void* Wq, int K) {
  return K % 16 == 0 && K <= MAX_K && reinterpret_cast<uintptr_t>(Aq) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(Wq) % 16 == 0;
}

// The maps of one call: Aq int8 [B, K] and Wq int8 [N, K], each in boxes of
// 128 K-columns x 64 rows. Out-of-range rows and columns read as 0.
inline int gemm_maps(CUtensorMap* ma, CUtensorMap* mw, const void* Aq, const void* Wq, int B,
                     int K, int N) {
  const int e = tensor_map(ma, Aq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, B, KSTAGE, BM);
  return e != 0 ? e : tensor_map(mw, Wq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, N, KSTAGE, BN);
}

// Launch KERNEL over `grid` with smem_bytes(K) of dynamic shared memory (up
// to smem_bytes(MAX_K) allowed once per kernel, on its first launch),
// following the launch before it as Dep says (mbarrier.cuh).
template <auto KERNEL, class Dep = Serial, typename... Args>
int launch(dim3 grid, int K, cudaStream_t stream, Args... args) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(MAX_K));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if constexpr (Dep::kProgrammatic) {
    const cudaError_t e = launch_programmatic(KERNEL, grid, THREADS, smem_bytes(K), stream, args...);
    if (e != cudaSuccess) return static_cast<int>(e);
  } else {
    KERNEL<<<grid, THREADS, smem_bytes(K), stream>>>(args...);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wgmma8
}  // namespace dposer

// The dynamic shared memory a block of the int8 main loop takes at depth K
// (0 for a K it does not take), for the build report.
extern "C" int dposer_wgmma8_smem_bytes(int K) {
  return K > 0 && K <= dposer::wgmma8::MAX_K ? dposer::wgmma8::smem_bytes(K) : 0;
}
