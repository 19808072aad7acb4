// K1 dense_gn_silu: y = SiLU(GN32(bf16(A) @ W + tp) * gamma + beta) [+ residual]
//
// Replaces: one layer of the network forward inside the TPU reverse-diffusion
// kernel, dposer_tpu/ops/pallas/fused_em.py::_make_kernel via
// dposer_tpu/ops/pallas/score_net.py::bind_fwd (the bf16 dense matmul, the
// time-projection row add, group_norm_vpu and SiLU, and the block's h + h2).
//
// Bound on the H100: at the flagship layer ([500, 1024] x [1024, 1024]) the
// call moves ~6 MB (A fp32, W bf16, out fp32) against ~1.07 GFLOP, i.e.
// ~1.8 us of HBM time vs ~1.1 us of bf16 tensor-core time: bytes bound. The
// TPU kernel kept all weights on-core for the whole loop; 8 MB of bf16
// weights do not fit an SM's shared memory, so each layer is one launch and
// the weights are re-read from the 50 MB L2 every step.
//
// Design: a 64x64 output tile per block (8 warps, 32x16 each, bf16 WMMA
// 16x16x16 with fp32 accumulation), K in steps of 64. A and W tiles are
// loaded into registers (16-byte loads where K % 4 == 0) two steps ahead, so
// each load has two K-steps to arrive; a loaded tile is stored into the
// shared buffer the previous step has finished with: one barrier per K-step.
// A is rounded to bf16 (round-to-nearest-even) as it is staged, as the plain
// version does. A GroupNorm group is N/32 consecutive
// features, so with N/32 <= 32 a 64-wide tile holds whole groups in the
// natural feature order: the epilogue adds the time row, reduces each group
// with warp shuffles (two-pass mean/variance in fp32), applies the affine
// and SiLU and the residual, and writes fp32 once.
// Not yet: cp.async/TMA multi-stage pipelines, wgmma, a bf16 copy of the
// activations for the next layer.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

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

template <int GS>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = GS / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
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

template <bool VEC>
__device__ __forceinline__ void load_tile(Regs<VEC>& r, const float* __restrict__ A,
                                          const __nv_bfloat16* __restrict__ W, int row0,
                                          int col0, int k0, int B, int K, int N, int tid) {
  if constexpr (VEC) {
#pragma unroll
    for (int i = 0; i < A_VECS; ++i) {
      const int q = tid + i * THREADS;
      const int row = q / (BK / 4), c = (q % (BK / 4)) * 4;
      const int gr = row0 + row, gc = k0 + c;
      r.a[i] = (gr < B && gc < K)
                   ? *reinterpret_cast<const float4*>(A + static_cast<size_t>(gr) * K + gc)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
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
    for (int i = 0; i < A_ELEMS; ++i) {
      const int q = tid + i * THREADS;
      const int gr = row0 + q / BK, gc = k0 + q % BK;
      r.a[i] = (gr < B && gc < K) ? A[static_cast<size_t>(gr) * K + gc] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < W_ELEMS; ++i) {
      const int q = tid + i * THREADS;
      const int gk = k0 + q / BN;
      r.w[i] = gk < K ? W[static_cast<size_t>(gk) * N + col0 + q % BN] : __float2bfloat16_rn(0.0f);
    }
  }
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

using AccTile = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// acc += this warp's 32x16 share of one staged BM x BK by BK x BN product
__device__ __forceinline__ void mma_stage(AccTile (&acc)[2], const Stage& s, int wm, int wn) {
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

template <int GS, bool VEC>
__global__ void __launch_bounds__(THREADS)
dense_gn_silu_kernel(const float* __restrict__ A, const __nv_bfloat16* __restrict__ W,
                     const float* __restrict__ tp, const float* __restrict__ gamma,
                     const float* __restrict__ beta, const float* residual, float* out,
                     int B, int K, int N) {
  __shared__ __align__(128) Smem sm;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int wm = warp / 4;  // warp's 32-row half of the tile
  const int wn = warp % 4;  // warp's 16-column quarter

  AccTile acc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) wmma::fill_fragment(acc[i], 0.0f);

  // Two register sets: the tile two K-steps ahead loads while the next one
  // waits in registers and the current one is multiplied from shared memory.
  const int n_k = (K + BK - 1) / BK;
  Regs<VEC> r0, r1;
  load_tile<VEC>(r0, A, W, row0, col0, 0, B, K, N, tid);
  if (n_k > 1) load_tile<VEC>(r1, A, W, row0, col0, BK, B, K, N, tid);
  store_tile<VEC>(r0, sm.stage[0], tid);
  __syncthreads();

  for (int kt = 0; kt < n_k; kt += 2) {
    // even step: stage 0 holds tile kt, r1 tile kt+1
    if (kt + 2 < n_k) load_tile<VEC>(r0, A, W, row0, col0, (kt + 2) * BK, B, K, N, tid);
    mma_stage(acc, sm.stage[0], wm, wn);
    if (kt + 1 < n_k) store_tile<VEC>(r1, sm.stage[1], tid);
    __syncthreads();
    if (kt + 1 >= n_k) break;
    // odd step: stage 1 holds tile kt+1, r0 tile kt+2
    if (kt + 3 < n_k) load_tile<VEC>(r1, A, W, row0, col0, (kt + 3) * BK, B, K, N, tid);
    mma_stage(acc, sm.stage[1], wm, wn);
    if (kt + 2 < n_k) store_tile<VEC>(r0, sm.stage[0], tid);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
    wmma::store_matrix_sync(sm.c + (wm * 32 + i * 16) * C_LD + wn * 16, acc[i], C_LD,
                            wmma::mem_row_major);
  __syncthreads();

  // Epilogue: warp w takes rows w, w+8, ...; lane l holds columns l and l+32,
  // so a group of GS features is GS consecutive lanes. The per-column rows
  // (time projection, GN affine) are read once into registers, and the
  // warp's residual values are all requested before the first is used.
  constexpr int ROWS_PER_WARP = BM / (THREADS / 32);
  constexpr float inv_gs = 1.0f / GS;
  float tpv[2], gv[2], bv[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int gc = col0 + half * 32 + lane;
    tpv[half] = tp[gc];
    gv[half] = gamma[gc];
    bv[half] = beta[gc];
  }
  float res[ROWS_PER_WARP][2];
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int gr = row0 + warp + i * (THREADS / 32);
#pragma unroll
    for (int half = 0; half < 2; ++half)
      res[i][half] = (residual != nullptr && gr < B)
                         ? residual[static_cast<size_t>(gr) * N + col0 + half * 32 + lane]
                         : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int r = warp + i * (THREADS / 32);
    const int gr = row0 + r;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = half * 32 + lane;
      const float v = sm.c[r * C_LD + c] + tpv[half];
      const float mean = group_sum<GS>(v) * inv_gs;
      const float d = v - mean;
      const float var = group_sum<GS>(d * d) * inv_gs;
      float y = d * rsqrtf(var + GN_EPS) * gv[half] + bv[half];
      y = y / (1.0f + __expf(-y)) + res[i][half];
      if (gr < B) out[static_cast<size_t>(gr) * N + col0 + c] = y;
    }
  }
}

template <int GS, bool VEC>
void launch(const float* A, const __nv_bfloat16* W, const float* tp, const float* gamma,
            const float* beta, const float* residual, float* out, int B, int K, int N,
            cudaStream_t stream) {
  const dim3 grid(N / BN, (B + BM - 1) / BM);
  dense_gn_silu_kernel<GS, VEC><<<grid, THREADS, 0, stream>>>(A, W, tp, gamma, beta, residual,
                                                               out, B, K, N);
}

template <int GS>
void launch_gs(bool vec, const float* A, const __nv_bfloat16* W, const float* tp,
               const float* gamma, const float* beta, const float* residual, float* out, int B,
               int K, int N, cudaStream_t stream) {
  if (vec)
    launch<GS, true>(A, W, tp, gamma, beta, residual, out, B, K, N, stream);
  else
    launch<GS, false>(A, W, tp, gamma, beta, residual, out, B, K, N, stream);
}

}  // namespace

// A [B, K] fp32, W [K, N] bf16, tp/gamma/beta [N] fp32, residual (nullable)
// and out [B, N] fp32; out may alias residual. N/32 (the group size) must be
// a power of two <= 32 and N a multiple of 64. Returns cudaGetLastError().
extern "C" int dposer_dense_gn_silu(const float* A, const void* W, const float* tp,
                                    const float* gamma, const float* beta,
                                    const float* residual, float* out, int B, int K, int N,
                                    void* stream) {
  const auto* w = static_cast<const __nv_bfloat16*>(W);
  const auto s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || K <= 0 || N % BN != 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(W) % 16 == 0;
  switch (N / 32) {
    case 2: launch_gs<2>(vec, A, w, tp, gamma, beta, residual, out, B, K, N, s); break;
    case 4: launch_gs<4>(vec, A, w, tp, gamma, beta, residual, out, B, K, N, s); break;
    case 8: launch_gs<8>(vec, A, w, tp, gamma, beta, residual, out, B, K, N, s); break;
    case 16: launch_gs<16>(vec, A, w, tp, gamma, beta, residual, out, B, K, N, s); break;
    case 32: launch_gs<32>(vec, A, w, tp, gamma, beta, residual, out, B, K, N, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
