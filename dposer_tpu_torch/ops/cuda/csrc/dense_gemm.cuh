// The register-staged GEMM main loop of the network's hidden layers as
// device code:
//   C[r, c] = sum_k bf16(A[r, k]) * W[k, c]
// Its users: K7 dense_gn_silu_jvp (STACKED) and K10 dense_gn_silu_train on
// their register routes (fp32 A: the pre layer at K = 63); K14's bf16 modes
// run dense_wgmma.cuh, K1's, K10's bf16 layers and K12 dense_wgmma_ss.cuh,
// and K1's pre layer its own one-stage tile (dense_gn_silu.cu).
// Its constants (BM, BN, C_LD, THREADS), group_sum and quant8 are those of
// gn_epilogue.cuh, dense_wgmma.cuh and the int8 loops (dense_gemm_int8.cuh,
// dense_wgmma_int8.cuh) too.
//
// A block owns a 64x64 output tile (8 warps, 32x16 each, bf16 WMMA 16x16x16
// with fp32 accumulation) and walks K in steps of 64. A and W tiles are loaded
// into registers (16-byte loads where K % 4 == 0) two steps ahead, so each
// load has two K-steps to arrive; a loaded tile is stored into the shared
// buffer the previous step has finished with: one barrier per K-step. A is
// rounded to bf16 (round-to-nearest-even) as it is staged. The tile ends in
// shared memory as fp32, where the caller's epilogue reads it.
//
// STACKED: the tile's rows 0..31 come from A and its rows 32..63 from a second
// matrix dA, both at rows row0..row0+31. Every staged W tile then feeds the
// primal and the tangent product of a forward-mode layer, and the epilogue
// finds a row's tangent 32 rows below its primal.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "mbarrier.cuh"

namespace dposer {
namespace dense {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int A_LD = BK + 8;  // bf16 elements; keeps WMMA tile pointers 32-byte aligned
constexpr int W_LD = BN + 8;
constexpr int C_LD = BN + 4;  // fp32 elements
constexpr float GN_EPS = 1e-5f;

// per thread and K-step: A 64x64 fp32 = 4 float4, W 64x64 bf16 = 2 x 8 bf16
constexpr int A_VECS = BM * BK / 4 / THREADS;
constexpr int W_VECS = BK * BN / 8 / THREADS;
constexpr int A_ELEMS = BM * BK / THREADS;
constexpr int W_ELEMS = BK * BN / THREADS;

struct Stage {
  __nv_bfloat16 a[BM * A_LD];
  __nv_bfloat16 w[BK * W_LD];
};

union Smem {
  Stage stage[2];
  float c[BM * C_LD];
};

// Sum over the GS consecutive lanes of a GroupNorm group, in every lane of it.
template <int GS>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = GS / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The int8 activation quantizer of K13 and K14's int8 mode:
// clamp(rint(a * qinv), -127, 127), the product rounded once, then half to
// even (the TPU kernel's jnp.round, quant.py::quantize_act).
__device__ __forceinline__ int quant8(float a, float qinv) {
  const float v = rintf(__fmul_rn(a, qinv));
  return static_cast<int>(fminf(fmaxf(v, -127.0f), 127.0f));
}

// One K-step's operands in registers. VEC: 16-byte loads (K % 4 == 0,
// N % 8 == 0, 16-byte aligned pointers); else element loads.
template <bool VEC>
struct Regs {
  float a[A_ELEMS];
  __nv_bfloat16 w[W_ELEMS];
};

template <>
struct Regs<true> {
  float4 a[A_VECS];
  uint4 w[W_VECS];
};

// Where tile row `row` of the A operand lives: (matrix, global row).
template <bool STACKED>
__device__ __forceinline__ const float* a_source(const float* A, const float* dA, int row0,
                                                 int row, int& gr) {
  if constexpr (STACKED) {
    gr = row0 + (row % (BM / 2));
    return row < BM / 2 ? A : dA;
  } else {
    gr = row0 + row;
    return A;
  }
}

// One K-step's A tile (load_a) and W tile (load_w) into registers;
// load_tile, both, A first.
template <bool VEC, bool STACKED>
__device__ __forceinline__ void load_a(Regs<VEC>& r, const float* __restrict__ A,
                                       const float* __restrict__ dA, int row0, int k0, int B,
                                       int K, int tid) {
  if constexpr (VEC) {
#pragma unroll
    for (int i = 0; i < A_VECS; ++i) {
      const int q = tid + i * THREADS;
      const int row = q / (BK / 4), gc = k0 + (q % (BK / 4)) * 4;
      int gr;
      const float* src = a_source<STACKED>(A, dA, row0, row, gr);
      r.a[i] = (gr < B && gc < K)
                   ? *reinterpret_cast<const float4*>(src + static_cast<size_t>(gr) * K + gc)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
#pragma unroll
    for (int i = 0; i < A_ELEMS; ++i) {
      const int q = tid + i * THREADS;
      const int gc = k0 + q % BK;
      int gr;
      const float* src = a_source<STACKED>(A, dA, row0, q / BK, gr);
      r.a[i] = (gr < B && gc < K) ? src[static_cast<size_t>(gr) * K + gc] : 0.0f;
    }
  }
}

template <bool VEC>
__device__ __forceinline__ void load_w(Regs<VEC>& r, const __nv_bfloat16* __restrict__ W,
                                       int col0, int k0, int K, int N, int tid) {
  if constexpr (VEC) {
#pragma unroll
    for (int i = 0; i < W_VECS; ++i) {
      const int q = tid + i * THREADS;
      const int row = q / (BN / 8), c = (q % (BN / 8)) * 8;
      const int gk = k0 + row;
      r.w[i] = gk < K ? *reinterpret_cast<const uint4*>(W + static_cast<size_t>(gk) * N + col0 + c)
                      : make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < W_ELEMS; ++i) {
      const int q = tid + i * THREADS;
      const int gk = k0 + q / BN;
      r.w[i] = gk < K ? W[static_cast<size_t>(gk) * N + col0 + q % BN] : __float2bfloat16_rn(0.0f);
    }
  }
}

template <bool VEC, bool STACKED>
__device__ __forceinline__ void load_tile(Regs<VEC>& r, const float* __restrict__ A,
                                          const float* __restrict__ dA,
                                          const __nv_bfloat16* __restrict__ W, int row0,
                                          int col0, int k0, int B, int K, int N, int tid) {
  load_a<VEC, STACKED>(r, A, dA, row0, k0, B, K, tid);
  load_w<VEC>(r, W, col0, k0, K, N, tid);
}

template <bool VEC>
__device__ __forceinline__ void store_tile(const Regs<VEC>& r, Stage& s, int tid) {
  if constexpr (VEC) {
#pragma unroll
    for (int i = 0; i < A_VECS; ++i) {
      const int q = tid + i * THREADS;
      const int row = q / (BK / 4), c = (q % (BK / 4)) * 4;
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(&s.a[row * A_LD + c]);
      dst[0] = __floats2bfloat162_rn(r.a[i].x, r.a[i].y);
      dst[1] = __floats2bfloat162_rn(r.a[i].z, r.a[i].w);
    }
#pragma unroll
    for (int i = 0; i < W_VECS; ++i) {
      const int q = tid + i * THREADS;
      const int row = q / (BN / 8), c = (q % (BN / 8)) * 8;
      *reinterpret_cast<uint4*>(&s.w[row * W_LD + c]) = r.w[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < A_ELEMS; ++i) {
      const int q = tid + i * THREADS;
      s.a[(q / BK) * A_LD + q % BK] = __float2bfloat16_rn(r.a[i]);
    }
#pragma unroll
    for (int i = 0; i < W_ELEMS; ++i) {
      const int q = tid + i * THREADS;
      s.w[(q / BN) * W_LD + q % BN] = r.w[i];
    }
  }
}

using AccTile = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>;

// acc += this warp's 32x16 share of one staged BM x BK by BK x BN product
__device__ __forceinline__ void mma_stage(AccTile (&acc)[2], const Stage& s, int wm, int wn) {
  using namespace nvcuda;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wmma::load_matrix_sync(a[i], s.a + (wm * 32 + i * 16) * A_LD + kk, A_LD);
    wmma::load_matrix_sync(b, s.w + kk * W_LD + wn * 16, W_LD);
#pragma unroll
    for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i], a[i], b, acc[i]);
  }
}

// The block's 64x64 tile of A @ W (STACKED: of [A; dA] @ W) at rows row0.. and
// columns col0.., left in sm.c as fp32 [BM][C_LD]. Every thread of the block
// calls it; it ends on a barrier. Dep (mbarrier.cuh) comes between the first
// two K-steps' W tiles and their A tiles: a programmatic launch loads its
// weights under the tail of the launch before it.
template <bool VEC, bool STACKED, class Dep = Serial>
__device__ __forceinline__ void gemm_tile(Smem& sm, const float* __restrict__ A,
                                          const float* __restrict__ dA,
                                          const __nv_bfloat16* __restrict__ W, int row0,
                                          int col0, int B, int K, int N) {
  using namespace nvcuda;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 4;  // warp's 32-row half of the tile
  const int wn = warp % 4;  // warp's 16-column quarter

  AccTile acc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) wmma::fill_fragment(acc[i], 0.0f);

  // Two register sets: the tile two K-steps ahead loads while the next one
  // waits in registers and the current one is multiplied from shared memory.
  const int n_k = (K + BK - 1) / BK;
  Regs<VEC> r0, r1;
  if constexpr (Dep::kProgrammatic) {
    load_w<VEC>(r0, W, col0, 0, K, N, tid);
    if (n_k > 1) load_w<VEC>(r1, W, col0, BK, K, N, tid);
    Dep{}();
    A = after_wait(A);  // A's loads stay after the wait (mbarrier.cuh)
    dA = after_wait(dA);
    load_a<VEC, STACKED>(r0, A, dA, row0, 0, B, K, tid);
    if (n_k > 1) load_a<VEC, STACKED>(r1, A, dA, row0, BK, B, K, tid);
  } else {
    load_tile<VEC, STACKED>(r0, A, dA, W, row0, col0, 0, B, K, N, tid);
    if (n_k > 1) load_tile<VEC, STACKED>(r1, A, dA, W, row0, col0, BK, B, K, N, tid);
  }
  store_tile<VEC>(r0, sm.stage[0], tid);
  __syncthreads();

  for (int kt = 0; kt < n_k; kt += 2) {
    // even step: stage 0 holds tile kt, r1 tile kt+1
    if (kt + 2 < n_k)
      load_tile<VEC, STACKED>(r0, A, dA, W, row0, col0, (kt + 2) * BK, B, K, N, tid);
    mma_stage(acc, sm.stage[0], wm, wn);
    if (kt + 1 < n_k) store_tile<VEC>(r1, sm.stage[1], tid);
    __syncthreads();
    if (kt + 1 >= n_k) break;
    // odd step: stage 1 holds tile kt+1, r0 tile kt+2
    if (kt + 3 < n_k)
      load_tile<VEC, STACKED>(r1, A, dA, W, row0, col0, (kt + 3) * BK, B, K, N, tid);
    mma_stage(acc, sm.stage[1], wm, wn);
    if (kt + 2 < n_k) store_tile<VEC>(r0, sm.stage[0], tid);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
    wmma::store_matrix_sync(sm.c + (wm * 32 + i * 16) * C_LD + wn * 16, acc[i], C_LD,
                            wmma::mem_row_major);
  __syncthreads();
}

}  // namespace dense
}  // namespace dposer
