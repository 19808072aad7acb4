// The Hopper GEMM main loop from fp32 A, run by K14 chain_link (modes bf16,
// bf16-out and gn-silu; K1 dense_gn_silu reads the bf16 copy the layer
// before wrote instead, on dense_wgmma_ss.cuh's ring, and takes this
// header's launch helpers and wgmma wrappers):
//   C[r, c] = sum_k bf16_rne(A[r, k]) * W[k, c]
// with A fp32 [B, K] and W bf16 [K, N], both row-major, fp32 accumulation.
// It computes what dense_gemm.cuh::gemm_tile<VEC, false> computes (the sum
// order differs) and leaves the 64x64 fp32 tile in shared memory as
// [BM][C_LD], where gn_epilogue.cuh and K14's plain store read it unchanged.
//
// Replaces, on the TPU: the bf16 matmul of
// dposer_tpu/ops/pallas/score_net.py::bind_fwd inside
// dposer_tpu/ops/pallas/fused_em.py::_make_kernel, and the chain matmul of
// benchmarks/mxu_micro.py:36-52.
//
// Bound on the H100: bytes. A block layer at [500,1024]x[1024,1024] with its
// residual moves ~8.2 MB from HBM (A and out fp32, W bf16, the residual):
// 2.46 us at 3.35 TB/s, against ~1.07 GFLOP, 1.1 us at the bf16 tensor rate.
// What bounds it is the consumer's chain below; the bf16 copy of A, read by
// TMA and wgmma from shared memory (dense_wgmma_ss.cuh), has no such chain:
// K1's block layer with its residual 8.0-8.1 us there against 9.3 here, at
// 1,000 rows 10.6-11.9 against 13.8-14.3, with the same epilogue (NVIDIA
// H100 80GB HBM3 at 700 W, CUDA-graph replay; dense_gn_silu.cu).
//
// Design (one block = one 64x64 output tile, 256 threads):
// - Warp 4 is the producer: one lane starts TMA copies into a ring of
//   stages, each A fp32 64 x KSTAGE (boxes of 64 rows x 32 fp32, one 128-byte
//   swizzle span) and W bf16 KSTAGE x 64 (one box, 128-byte rows), all with
//   the 128-byte swizzle. A "full" mbarrier per stage counts the bytes in, an
//   "empty" one the four consumer warps out. The lane sets the barriers up
//   and starts the first stages before the block barrier.
// - Warps 0-3, one warpgroup, are the consumer: wgmma.mma_async m64n64k16,
//   bf16 in, fp32 accumulators in registers. W is operand B straight from
//   the ring through a descriptor: [K][N] with N contiguous is MN-major
//   (tnspB = 1), one swizzle atom wide, 1024 bytes between 8-row K groups.
//   A is operand A from registers: each thread reads its m64k16 fragments as
//   fp32 pairs from the ring and rounds them with __float2bfloat16_rn, the
//   rounding of every other path. Registers were chosen over a bf16 copy of
//   A in shared memory, which costs a second pass through shared memory, a
//   proxy fence and a warpgroup barrier a stage; the register layout is the
//   mma.m16n8k16 one. Lanes with (lane & 2) read their two K-steps' chunks
//   in the other order and swap them with selects, so each 8-byte load of a
//   half-warp hits eight distinct 16-byte chunks: no bank conflicts.
// - One wgmma group is in flight at a time. The next stage's fp32 values are
//   loaded while it runs and rounded only after wgmma.wait_group 0: an
//   instruction that defines a register-A input while a wgmma is in flight
//   makes ptxas serialize every wgmma (C7513), which two alternating
//   fragment sets with one group left in flight did.
// - A stage costs one consumer warp's chain of instructions (the
//   conversions, the barrier wait, the fragment loads, the release), not
//   bytes: on the card, dropping A's copies or the fragment loads did not
//   move a 64-column stage's time, nor did more stages or a second consumer
//   warpgroup, and the MMAs finish inside the chain. So a grid that fits the
//   SMs once takes 128-column stages (Wide: half the waits and releases a
//   K-column, 145 KB and ~145 registers), a larger one 64-column stages
//   (Narrow: 97 KB, ~95 registers, two blocks an SM). Both add the same
//   products in the same order.
// - Clusters of 2 or 4 blocks along N, each stage's A multicast to the
//   cluster (A's L2 traffic cut 2- or 4-fold), were tried in a first version
//   of this loop and were slower at 500 and at 1,000 rows: the loop is not
//   bound by L2, so there are no clusters.
// - The fp32 tile for the epilogue aliases stage 0 of the ring once the
//   consumers are done.
// - Tensor maps are encoded on the host (tensor_map.cuh:
//   cuTensorMapEncodeTiled, found with cudaGetDriverEntryPoint, so no -lcuda)
//   and cached by (pointer, dims, stride, box): the samplers' loops launch
//   with a handful of maps and encode each once. They reach the kernel as
//   __grid_constant__ parameters.
// TMA needs 16-byte aligned rows and pointers.
#pragma once

#include <cstdint>
#include <cstring>
#include <mutex>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dense_gemm.cuh"
#include "mbarrier.cuh"
#include "tensor_map.cuh"

namespace dposer {
namespace wgmma {

using dense::BM;
using dense::BN;
using dense::C_LD;
using dense::THREADS;

constexpr int A_BOX_BYTES = BM * 32 * 4;  // 64 rows x 32 fp32: one 128-byte swizzle span
constexpr int PRODUCER_WARP = 4;
static_assert(BM == 64 && BN == 64 && THREADS == 256, "the layout below");

// The ring's shape: KSTAGE K-columns a stage, STAGES stages.
template <int KSTAGE_, int STAGES_>
struct Ring {
  static constexpr int KSTAGE = KSTAGE_;
  static constexpr int STAGES = STAGES_;
  static constexpr int KSTEPS = KSTAGE / 16;    // wgmma K-steps a stage
  static constexpr int BOXES = KSTAGE / 32;     // A boxes a stage
  static constexpr int A_BYTES = BOXES * A_BOX_BYTES;
  static constexpr int W_BYTES = KSTAGE * BN * 2;
  static constexpr int STAGE_BYTES = A_BYTES + W_BYTES;
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  // slack to align the ring to the swizzle's 1024 bytes, then the ring and
  // the full and empty barriers
  static constexpr int SMEM_BYTES = 1024 + RING_BYTES + 2 * STAGES * 8;
  static_assert(BM * C_LD * 4 <= STAGE_BYTES, "the epilogue's tile must fit stage 0");
};
// A grid of at most one block an SM takes the deep stages (145 KB, ~145
// registers a thread: half as many barrier waits and releases a K-column);
// a larger one the shallow stages (97 KB, ~95 registers), so two blocks
// share an SM. Both add the same products in the same order.
using Wide = Ring<128, 3>;
using Narrow = Ring<64, 4>;

// ---------------------------------------------------------------------------
// device side (the mbarrier and copy wrappers are mbarrier.cuh's)
// ---------------------------------------------------------------------------

// Descriptor of a bf16 B operand, MN-major, 128-byte swizzle, one atom (64
// columns) wide: 8-row K groups 1024 bytes apart (the stride byte offset;
// the leading one, the next atom along N, is never read at n = 64, and is
// set to the same 1024).
__device__ __forceinline__ uint64_t desc_b(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// Descriptor of a K-major operand in shared memory with the 128-byte swizzle
// (rows of 128 bytes: 64 bf16 or 128 int8 values along K): 8-row groups
// 1024 bytes apart (the stride byte offset); the leading byte offset is not
// read for a swizzled K-major operand whose K-step (32 bytes: k16 of bf16,
// k32 of int8) lies inside the atom, and is set to 1. A K-step inside the
// atom advances the start address by 32 bytes. The int8 loop
// (dense_wgmma_int8.cuh) and K7's bf16 loop (dense_gn_silu_jvp.cu) read
// both or one operand through it.
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// An empty asm that reads and rewrites `r`: `r` is computed before this point
// and its later uses stay after it. It orders plain register work around the
// wgmma instructions, whose asynchronous register reads the compiler does not
// see.
__device__ __forceinline__ void keep(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }
__device__ __forceinline__ void keep(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void keep(uint64_t& r) { asm volatile("" : "+l"(r)::"memory"); }

// d += A(registers a) * B(descriptor), m64n64k16, bf16 in, fp32 out, B MN-major.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A(descriptor a) * B(descriptor b), m64n64k16, bf16 in, fp32 out, A
// K-major (desc_k), B MN-major (desc_b).
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float2 v) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);  // .x (the lower column) low
  uint32_t u;
  memcpy(&u, &h, 4);
  return u;
}

// This thread's A values of one 32-column box of a stage (K-steps 2q and
// 2q+1), as fp32 pairs: rows r0 and r0 + 8 (r0 = 16 * warp + lane / 4),
// columns 2t, 2t+1 ("lo") and 2t+8, 2t+9 ("hi") of each step (t = lane %
// 4). The box holds 64 rows x 32 fp32, 16-byte chunk c of row r stored at
// chunk c ^ (r % 8). The two steps' chunks are c and c + 4 (c = t / 2, or
// t / 2 + 2 for hi). Lanes with t / 2 == 1 load the odd step's chunk first,
// so each 8-byte load of a half-warp touches 8 distinct chunks: no bank
// conflicts. raw[i] holds, for i = (part * 2 + rr) * 2 + j, load j of
// (lo/hi part, row r0 + 8 * rr).
__device__ __forceinline__ void load_a_raw(float2 (&raw)[8], const float* box, int r0,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3, p = t >> 1;
#pragma unroll
  for (int part = 0; part < 2; ++part) {
    const int c0 = 2 * part + 5 * p;      // the even step if p == 0, else the odd one
    const int c1 = 2 * part + 4 - 3 * p;  // the other step
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float* row = box + (r0 + 8 * rr) * 32 + 2 * (t & 1);
      const int i = (part * 2 + rr) * 2;
      raw[i] = *reinterpret_cast<const float2*>(row + ((c0 ^ g) << 2));
      raw[i + 1] = *reinterpret_cast<const float2*>(row + ((c1 ^ g) << 2));
    }
  }
}

// Box q's two wgmma A fragments from raw, rounded to bf16: a[2q + j] =
// {(r0, lo), (r0 + 8, lo), (r0, hi), (r0 + 8, hi)} of the box's K-step j.
template <int KSTEPS>
__device__ __forceinline__ void convert_a(uint32_t (&a)[KSTEPS][4], int q,
                                          const float2 (&raw)[8], int lane) {
  const bool swap = (lane & 2) != 0;
#pragma unroll
  for (int part = 0; part < 2; ++part)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int i = (part * 2 + rr) * 2;
      a[2 * q][2 * part + rr] = pack_bf16(swap ? raw[i + 1] : raw[i]);
      a[2 * q + 1][2 * part + rr] = pack_bf16(swap ? raw[i] : raw[i + 1]);
    }
}

// The block's 64x64 tile of bf16(A) @ W at rows row0.. and columns col0..,
// returned as fp32 [BM][C_LD] in shared memory (stage 0 of the ring). Every
// thread of the block calls it, in a launch with R::SMEM_BYTES of dynamic
// shared memory; it ends on a block barrier. Dep (mbarrier.cuh) is called
// by every thread once the producer has started W's boxes of the first
// stages and before it starts A's: a programmatic launch fetches its
// weights under the tail of the launch before it.
template <class R, class Dep = Serial>
__device__ __forceinline__ const float* gemm_tile(uint8_t* smem_raw, const CUtensorMap* tmA,
                                                  const CUtensorMap* tmW, int row0, int col0,
                                                  int K) {
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t ring_s = smem_u32(ring);
  const uint32_t full0 = ring_s + R::RING_BYTES;
  const uint32_t empty0 = full0 + R::STAGES * 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_k = (K + R::KSTAGE - 1) / R::KSTAGE;

  // Start the copies of K-tile kt into its stage (the stage is free).
  auto copy_a = [&](int kt) {
    const uint32_t stage = ring_s + (kt % R::STAGES) * R::STAGE_BYTES;
    const uint32_t full = full0 + 8 * (kt % R::STAGES);
#pragma unroll
    for (int q = 0; q < R::BOXES; ++q)
      tma_load(stage + q * A_BOX_BYTES, tmA, full, kt * R::KSTAGE + 32 * q, row0);
  };
  auto copy_stage = [&](int kt) {
    const uint32_t stage = ring_s + (kt % R::STAGES) * R::STAGE_BYTES;
    const uint32_t full = full0 + 8 * (kt % R::STAGES);
    mbar_expect_tx(full, R::STAGE_BYTES);
    copy_a(kt);
    tma_load(stage + R::A_BYTES, tmW, full, col0, kt * R::KSTAGE);
  };
  // A first stage's bytes expected and its W box started: A's box follows
  // once the launches before this one are done (Dep), the stage's barrier
  // counting both.
  auto copy_w = [&](int kt) {
    const uint32_t stage = ring_s + kt * R::STAGE_BYTES, full = full0 + 8 * kt;
    mbar_expect_tx(full, R::STAGE_BYTES);
    tma_load(stage + R::A_BYTES, tmW, full, col0, kt * R::KSTAGE);
  };
  // The producer lane sets the barriers up and starts the first stages'
  // copies before the block barrier that publishes the barriers: W's boxes
  // before Dep, A's after it.
  const bool producer = warp == PRODUCER_WARP && lane == 0;
  if (producer) {
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(tmA)) : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(tmW)) : "memory");
    for (int s = 0; s < R::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if constexpr (Dep::kProgrammatic) {
      for (int kt = 0; kt < R::STAGES && kt < n_k; ++kt) copy_w(kt);
    } else {
      for (int kt = 0; kt < R::STAGES && kt < n_k; ++kt) copy_stage(kt);
    }
  }
  if constexpr (Dep::kProgrammatic) {
    Dep{}();
    if (producer)
      for (int kt = 0; kt < R::STAGES && kt < n_k; ++kt) copy_a(kt);
  }
  __syncthreads();

  if (warp == PRODUCER_WARP) {
    if (lane == 0) {
      for (int kt = R::STAGES; kt < n_k; ++kt) {
        mbar_wait(empty0 + 8 * (kt % R::STAGES), ((kt / R::STAGES) & 1) ^ 1);
        copy_stage(kt);
      }
    }
    __syncwarp();
  } else if (warp < 4) {
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
    const int r0 = 16 * warp + (lane >> 2);
    auto box_a = [&](int kt, int q) {
      return reinterpret_cast<const float*>(ring + (kt % R::STAGES) * R::STAGE_BYTES +
                                            q * A_BOX_BYTES);
    };
    auto wait_full = [&](int kt) {
      mbar_wait(full0 + 8 * (kt % R::STAGES), (kt / R::STAGES) & 1);
      __syncwarp();  // the warp converged again for the .aligned wgmma instructions
    };

    float2 raw[R::BOXES][8];
    wait_full(0);
#pragma unroll
    for (int q = 0; q < R::BOXES; ++q) load_a_raw(raw[q], box_a(0, q), r0, lane);
    for (int kt = 0; kt < n_k; ++kt) {
      const int s = kt % R::STAGES;
      uint32_t f[R::KSTEPS][4];
#pragma unroll
      for (int q = 0; q < R::BOXES; ++q)
        convert_a(f, q, raw[q], lane);
      uint64_t db[R::KSTEPS];
#pragma unroll
      for (int kk = 0; kk < R::KSTEPS; ++kk)
        db[kk] = desc_b(ring_s + s * R::STAGE_BYTES + R::A_BYTES + kk * 2048);
      // Every input of the group exists before the fence: ptxas serializes
      // the wgmma pipeline when an instruction defines a wgmma input while
      // one is in flight.
#pragma unroll
      for (int kk = 0; kk < R::KSTEPS; ++kk) {
        keep(db[kk]);
#pragma unroll
        for (int j = 0; j < 4; ++j) keep(f[kk][j]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < R::KSTEPS; ++kk) wgmma_m64n64k16(acc, f[kk], db[kk]);
      wgmma_commit();
      // the next stage's fp32 values load while the MMAs run; they become
      // wgmma inputs only after the wait
      if (kt + 1 < n_k) {
        wait_full(kt + 1);
#pragma unroll
        for (int q = 0; q < R::BOXES; ++q) load_a_raw(raw[q], box_a(kt + 1, q), r0, lane);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int q = 0; q < R::BOXES; ++q)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          keep(raw[q][i].x);
          keep(raw[q][i].y);
        }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) keep(acc[i]);

    // every consumer is done with the ring before stage 0 becomes the tile
    asm volatile("bar.sync 1, 128;" ::: "memory");
    float* c = reinterpret_cast<float*>(ring);
    const int t = lane & 3;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<float2*>(&c[r0 * C_LD + 8 * j + 2 * t]) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(&c[(r0 + 8) * C_LD + 8 * j + 2 * t]) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  __syncthreads();
  return reinterpret_cast<const float*>(ring);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Whether a grid of `blocks` fits the current device's SMs once (then the
// Wide ring).
inline bool one_wave(int blocks) {
  static int sms[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return false;
  if (sms[dev] == 0) cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return blocks <= sms[dev];
}

// The maps of one call: A fp32 [B, K] in boxes of 32 x 64, W bf16 [K, N] in
// boxes of 64 x R::KSTAGE. Out-of-range rows and columns read as 0.
template <class R>
int gemm_maps(CUtensorMap* ma, CUtensorMap* mw, const float* A, const void* W, int B, int K,
              int N) {
  const int e = tensor_map(ma, A, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, K, B, 32, BM);
  return e != 0 ? e : tensor_map(mw, W, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, N, K, BN, R::KSTAGE);
}

// Launch KERNEL over `grid` with R::SMEM_BYTES of dynamic shared memory
// (allowed once per kernel, on its first launch), following the launch
// before it as Dep says (mbarrier.cuh: Serial, or Programmatic for a
// kernel whose loop is built with the same tag).
template <class R, auto KERNEL, class Dep = Serial, typename... Args>
int launch(dim3 grid, cudaStream_t stream, Args... args) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, R::SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if constexpr (Dep::kProgrammatic) {
    const cudaError_t e = launch_programmatic(KERNEL, grid, THREADS, R::SMEM_BYTES, stream, args...);
    if (e != cudaSuccess) return static_cast<int>(e);
  } else {
    KERNEL<<<grid, THREADS, R::SMEM_BYTES, stream>>>(args...);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wgmma
}  // namespace dposer

// Statistics of the library this header is compiled into (one translation
// unit a library): tensor maps encoded so far (the cache's misses), and the
// dynamic shared memory a block of the main loop takes.
extern "C" long long dposer_tma_encodes(void) {
  dposer::MapCache& c = dposer::map_cache();
  std::lock_guard<std::mutex> lock(c.mu);
  return c.encodes;
}

extern "C" int dposer_wgmma_smem_bytes(int wide) {
  return wide ? dposer::wgmma::Wide::SMEM_BYTES : dposer::wgmma::Narrow::SMEM_BYTES;
}
