// The register-staged int8 GEMM main loop of K14 chain_link's int8 mode
// where A is fp32 (a chain's first link) and of K13 dense_gn_silu_int8 on
// fp32 A at K > 64 (no caller in the program's forward: K13's pre layer, the
// state x at K = 63, runs K13's pre route, dense_gn_silu_int8.cu):
//   C[r, c] = float(sum_k q(A[r, k]) * Wq[c, k]) * qs[c],
//   q(a) = clamp(rint(a * qinv[k]), -127, 127)
// (the TPU kernel's quant ``mm``, dposer_tpu/ops/pallas/score_net.py:337-360).
// Every later layer or link reads the int8 copy of its input that the
// previous epilogue wrote, through dense_wgmma_int8.cuh, which computes the
// same sums.
//
// dense_gemm.cuh's block tile with 8-bit operands: a block owns a 64x64 output
// tile (8 warps, 32x16 each) and walks K in steps of 64, with the A and W tiles
// loaded into registers two K-steps ahead. A is read in fp32 and quantized as
// it is staged (round half to even, clamped to +-127). The MMA is
// mma.sync.m16n8k32 s8 x s8 -> s32, which wants B K-contiguous: Wq is stored
// [N, K] (nn.Linear's [out, in]) and its tile is staged [n][k]. Both shared
// tiles pad their 64-byte rows to 80 bytes, so a fragment's eight rows of four
// words fall on 32 distinct banks. The int32 sums are exact (|sum| <= K *
// 127^2 < 2^24 for K <= 1024), converted to fp32 and scaled by the column's
// rescale row as the tile is left in shared memory for the caller's epilogue.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "dense_gemm.cuh"
#include "mbarrier.cuh"

namespace dposer {
namespace dense8 {

using dense::BK;
using dense::BM;
using dense::BN;
using dense::C_LD;
using dense::THREADS;
using dense::quant8;

constexpr int A_LD = BK + 16;  // int8 elements (bytes)
constexpr int W_LD = BK + 16;

struct Stage {
  int8_t a[BM * A_LD];  // [row][k]
  int8_t w[BN * W_LD];  // [n][k]
};

union Smem {
  Stage stage[2];
  float c[BM * C_LD];
};

// One K-step's operands in registers. VEC: 16-byte loads (K % 16 == 0 and
// A, Wq, qinv 16-byte aligned); else element loads. Every A element a thread
// loads lies in one column (its K index), so one quantization scale each.
template <bool VEC>
struct Regs {
  float a[BM * BK / THREADS];
  float qi;
  int8_t w[BN * BK / THREADS];
};

template <>
struct Regs<true> {
  float4 a[BM * BK / 4 / THREADS];
  float4 qi;
  uint4 w;
};

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (static_cast<uint32_t>(a) & 0xffu) | ((static_cast<uint32_t>(b) & 0xffu) << 8) |
         ((static_cast<uint32_t>(c) & 0xffu) << 16) | ((static_cast<uint32_t>(d) & 0xffu) << 24);
}

// One K-step's operands in registers, in two parts: the launch's constants,
// Wq's tile and the quantization row (load_wq), which a programmatic launch
// (mbarrier.cuh) loads before its wait for the launches before it, and A's
// tile (load_a), which it loads after; load_tile, both.
template <bool VEC>
__device__ __forceinline__ void load_wq(Regs<VEC>& r, const float* __restrict__ qinv,
                                        const int8_t* __restrict__ W, int col0, int k0, int K,
                                        int tid) {
  if constexpr (VEC) {
    const int gc = k0 + (tid % (BK / 4)) * 4;
    r.qi = gc < K ? *reinterpret_cast<const float4*>(qinv + gc) : make_float4(0.f, 0.f, 0.f, 0.f);
    const int n = tid / (BK / 16), gk = k0 + (tid % (BK / 16)) * 16;
    r.w = gk < K ? *reinterpret_cast<const uint4*>(W + static_cast<size_t>(col0 + n) * K + gk)
                 : make_uint4(0u, 0u, 0u, 0u);
  } else {
    const int gk = k0 + tid % BK;
    r.qi = gk < K ? qinv[gk] : 0.0f;
#pragma unroll
    for (int i = 0; i < BM * BK / THREADS; ++i) {
      const int row = (tid + i * THREADS) / BK;
      r.w[i] = gk < K ? W[static_cast<size_t>(col0 + row) * K + gk] : int8_t(0);
    }
  }
}

template <bool VEC>
__device__ __forceinline__ void load_a(Regs<VEC>& r, const float* __restrict__ A, int row0,
                                       int k0, int B, int K, int tid) {
  if constexpr (VEC) {
    const int gc = k0 + (tid % (BK / 4)) * 4;
#pragma unroll
    for (int i = 0; i < BM * BK / 4 / THREADS; ++i) {
      const int gr = row0 + (tid + i * THREADS) / (BK / 4);
      r.a[i] = (gr < B && gc < K)
                   ? *reinterpret_cast<const float4*>(A + static_cast<size_t>(gr) * K + gc)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    const int gk = k0 + tid % BK;
#pragma unroll
    for (int i = 0; i < BM * BK / THREADS; ++i) {
      const int gr = row0 + (tid + i * THREADS) / BK;
      r.a[i] = (gr < B && gk < K) ? A[static_cast<size_t>(gr) * K + gk] : 0.0f;
    }
  }
}

template <bool VEC>
__device__ __forceinline__ void load_tile(Regs<VEC>& r, const float* __restrict__ A,
                                          const float* __restrict__ qinv,
                                          const int8_t* __restrict__ W, int row0, int col0,
                                          int k0, int B, int K, int tid) {
  load_a<VEC>(r, A, row0, k0, B, K, tid);
  load_wq<VEC>(r, qinv, W, col0, k0, K, tid);
}

template <bool VEC>
__device__ __forceinline__ void store_tile(const Regs<VEC>& r, Stage& s, int tid) {
  if constexpr (VEC) {
    const int c = (tid % (BK / 4)) * 4;
#pragma unroll
    for (int i = 0; i < BM * BK / 4 / THREADS; ++i) {
      const int row = (tid + i * THREADS) / (BK / 4);
      const float4 a = r.a[i];
      *reinterpret_cast<uint32_t*>(&s.a[row * A_LD + c]) =
          pack4(quant8(a.x, r.qi.x), quant8(a.y, r.qi.y), quant8(a.z, r.qi.z),
                quant8(a.w, r.qi.w));
    }
    const int n = tid / (BK / 16), kc = (tid % (BK / 16)) * 16;
    *reinterpret_cast<uint4*>(&s.w[n * W_LD + kc]) = r.w;
  } else {
    const int k = tid % BK;
#pragma unroll
    for (int i = 0; i < BM * BK / THREADS; ++i) {
      const int row = (tid + i * THREADS) / BK;
      s.a[row * A_LD + k] = static_cast<int8_t>(quant8(r.a[i], r.qi));
      s.w[row * W_LD + k] = r.w[i];
    }
  }
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += this warp's 32x16 share of one staged BM x BK by BK x BN product:
// two m16 row tiles by two n8 column tiles, two k32 steps. Fragment layouts
// of the PTX ISA for m16n8k32 with 8-bit operands: g = lane/4, t = lane%4; A
// registers hold rows g, g+8 at k = 4t.., 16+4t..; B registers column g at
// k = 4t.., 16+4t..; C registers rows g, g+8 at columns 2t, 2t+1.
__device__ __forceinline__ void mma_stage(int (&acc)[2][2][4], const Stage& s, int wm, int wn,
                                          int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 32) {
    uint32_t a[2][4], b[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int8_t* p = s.a + (wm * 32 + mt * 16 + g) * A_LD + kk + t * 4;
      a[mt][0] = ld32(p);
      a[mt][1] = ld32(p + 8 * A_LD);
      a[mt][2] = ld32(p + 16);
      a[mt][3] = ld32(p + 8 * A_LD + 16);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int8_t* p = s.w + (wn * 16 + nt * 8 + g) * W_LD + kk + t * 4;
      b[nt][0] = ld32(p);
      b[nt][1] = ld32(p + 16);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) mma_s8(acc[mt][nt], a[mt], b[nt]);
  }
}

// The block's 64x64 tile of the quantized product at rows row0.. and columns
// col0.., scaled by qs[col], left in sm.c as fp32 [BM][C_LD]. Every thread of
// the block calls it; it ends on a barrier. Dep (mbarrier.cuh) comes between
// the first two K-steps' Wq tiles and their A tiles.
template <bool VEC, class Dep = Serial>
__device__ __forceinline__ void gemm_tile_int8(Smem& sm, const float* __restrict__ A,
                                               const float* __restrict__ qinv,
                                               const int8_t* __restrict__ W,
                                               const float* __restrict__ qs, int row0,
                                               int col0, int B, int K) {
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4;  // warp's 32-row half of the tile
  const int wn = warp % 4;  // warp's 16-column quarter

  int acc[2][2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;

  const int n_k = (K + BK - 1) / BK;
  Regs<VEC> r0, r1;
  if constexpr (Dep::kProgrammatic) {
    load_wq<VEC>(r0, qinv, W, col0, 0, K, tid);
    if (n_k > 1) load_wq<VEC>(r1, qinv, W, col0, BK, K, tid);
    Dep{}();
    A = after_wait(A);  // A's loads stay after the wait (mbarrier.cuh)
    load_a<VEC>(r0, A, row0, 0, B, K, tid);
    if (n_k > 1) load_a<VEC>(r1, A, row0, BK, B, K, tid);
  } else {
    load_tile<VEC>(r0, A, qinv, W, row0, col0, 0, B, K, tid);
    if (n_k > 1) load_tile<VEC>(r1, A, qinv, W, row0, col0, BK, B, K, tid);
  }
  store_tile<VEC>(r0, sm.stage[0], tid);
  __syncthreads();

  for (int kt = 0; kt < n_k; kt += 2) {
    // even step: stage 0 holds tile kt, r1 tile kt+1
    if (kt + 2 < n_k) load_tile<VEC>(r0, A, qinv, W, row0, col0, (kt + 2) * BK, B, K, tid);
    mma_stage(acc, sm.stage[0], wm, wn, lane);
    if (kt + 1 < n_k) store_tile<VEC>(r1, sm.stage[1], tid);
    __syncthreads();
    if (kt + 1 >= n_k) break;
    // odd step: stage 1 holds tile kt+1, r0 tile kt+2
    if (kt + 3 < n_k) load_tile<VEC>(r1, A, qinv, W, row0, col0, (kt + 3) * BK, B, K, tid);
    mma_stage(acc, sm.stage[1], wm, wn, lane);
    if (kt + 2 < n_k) store_tile<VEC>(r0, sm.stage[0], tid);
    __syncthreads();
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int row = wm * 32 + mt * 16 + g, col = wn * 16 + nt * 8 + t * 2;
      const float s0 = qs[col0 + col], s1 = qs[col0 + col + 1];
      sm.c[row * C_LD + col] = __fmul_rn(static_cast<float>(acc[mt][nt][0]), s0);
      sm.c[row * C_LD + col + 1] = __fmul_rn(static_cast<float>(acc[mt][nt][1]), s1);
      sm.c[(row + 8) * C_LD + col] = __fmul_rn(static_cast<float>(acc[mt][nt][2]), s0);
      sm.c[(row + 8) * C_LD + col + 1] = __fmul_rn(static_cast<float>(acc[mt][nt][3]), s1);
    }
  __syncthreads();
}

}  // namespace dense8
}  // namespace dposer
