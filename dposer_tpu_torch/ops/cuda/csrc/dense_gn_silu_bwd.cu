// K12 dense_gn_silu_bwd: one hop of the score network's backward data chain,
//   g     = dh_next @ Wt [+ g_res]       (dh_next [B, K] bf16, Wt [K, N] bf16)
//   g_gn  = SiLU'(y) * dropout(g),       y = xhat * gamma + beta
//   g_pre = rstd * (g_xhat - mean_g(g_xhat) - xhat * mean_g(g_xhat * xhat)),
//           g_xhat = g_gn * gamma
// writing g (fp32, where the residual stream carries it on), dh = bf16(g_pre)
// and per-row-block partial sums of dgamma = sum_rows g_gn * xhat and
// dbeta = sum_rows g_gn, which the wrapper reduces with one fixed-order
// torch.sum: a step is deterministic, and a resumed run repeats it exactly.
//
// Replaces: stack_bwd of the TPU train kernel with the mm(., W^T) hop before
// it, dposer_tpu/ops/pallas/fused_train.py::_make_kernel (:151-166, :193-206).
// The dropout mask is regenerated from dropout_hash.cuh, as K10 drew it.
//
// Bound on the H100: at the flagship hop ([1280, 1024] x [1024, 1024]) the
// call moves ~15 MB (dh_next, xhat and dh bf16, W, g_res and g fp32) against
// 2.7 GFLOP: ~4.5 us of HBM time vs ~2.7 us of bf16 tensor-core time, bytes
// bound.
//
// Design: dense_gemm.cuh's 64x64 block tile and WMMA stage, with the A
// operand read as bf16 (16-byte loads, K a multiple of 64: the first hop's
// dout is zero-padded from 63 to 64 columns by the wrapper). Wt is the
// torch Linear weight [out, in] of the next layer as it is: the transpose the
// TPU kernel was handed is free here. The epilogue holds whole GroupNorm
// groups in the 64-wide tile and reduces them with warp shuffles; dgamma and
// dbeta are summed over the block's rows in registers, then across its warps
// through shared memory in a fixed order.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "dense_gemm.cuh"
#include "dropout_hash.cuh"

namespace {

using namespace dposer::dense;
namespace dr = dposer::dropout;

constexpr int A16_VECS = BM * BK / 8 / THREADS;  // 8 bf16 per 16-byte load
constexpr int N_WARPS = THREADS / 32;

struct Regs16 {
  uint4 a[A16_VECS];
  uint4 w[W_VECS];
};

__device__ __forceinline__ void load_tile16(Regs16& r, const __nv_bfloat16* __restrict__ A,
                                            const __nv_bfloat16* __restrict__ W, int row0,
                                            int col0, int k0, int B, int K, int N, int tid) {
#pragma unroll
  for (int i = 0; i < A16_VECS; ++i) {
    const int q = tid + i * THREADS;
    const int row = q / (BK / 8), c = (q % (BK / 8)) * 8;
    const int gr = row0 + row;
    r.a[i] = gr < B ? *reinterpret_cast<const uint4*>(A + static_cast<size_t>(gr) * K + k0 + c)
                    : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int i = 0; i < W_VECS; ++i) {
    const int q = tid + i * THREADS;
    const int row = q / (BN / 8), c = (q % (BN / 8)) * 8;
    r.w[i] = *reinterpret_cast<const uint4*>(W + static_cast<size_t>(k0 + row) * N + col0 + c);
  }
}

__device__ __forceinline__ void store_tile16(const Regs16& r, Stage& s, int tid) {
#pragma unroll
  for (int i = 0; i < A16_VECS; ++i) {
    const int q = tid + i * THREADS;
    const int row = q / (BK / 8), c = (q % (BK / 8)) * 8;
    *reinterpret_cast<uint4*>(&s.a[row * A_LD + c]) = r.a[i];
  }
#pragma unroll
  for (int i = 0; i < W_VECS; ++i) {
    const int q = tid + i * THREADS;
    const int row = q / (BN / 8), c = (q % (BN / 8)) * 8;
    *reinterpret_cast<uint4*>(&s.w[row * W_LD + c]) = r.w[i];
  }
}

// dense_gemm.cuh's gemm_tile with a bf16 A operand and K % BK == 0.
__device__ __forceinline__ void gemm_tile16(Smem& sm, const __nv_bfloat16* __restrict__ A,
                                            const __nv_bfloat16* __restrict__ W, int row0,
                                            int col0, int B, int K, int N) {
  using namespace nvcuda;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 4;
  const int wn = warp % 4;

  AccTile acc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) wmma::fill_fragment(acc[i], 0.0f);

  const int n_k = K / BK;
  Regs16 r0, r1;
  load_tile16(r0, A, W, row0, col0, 0, B, K, N, tid);
  if (n_k > 1) load_tile16(r1, A, W, row0, col0, BK, B, K, N, tid);
  store_tile16(r0, sm.stage[0], tid);
  __syncthreads();

  for (int kt = 0; kt < n_k; kt += 2) {
    if (kt + 2 < n_k) load_tile16(r0, A, W, row0, col0, (kt + 2) * BK, B, K, N, tid);
    mma_stage(acc, sm.stage[0], wm, wn);
    if (kt + 1 < n_k) store_tile16(r1, sm.stage[1], tid);
    __syncthreads();
    if (kt + 1 >= n_k) break;
    if (kt + 3 < n_k) load_tile16(r1, A, W, row0, col0, (kt + 3) * BK, B, K, N, tid);
    mma_stage(acc, sm.stage[1], wm, wn);
    if (kt + 2 < n_k) store_tile16(r0, sm.stage[0], tid);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
    wmma::store_matrix_sync(sm.c + (wm * 32 + i * 16) * C_LD + wn * 16, acc[i], C_LD,
                            wmma::mem_row_major);
  __syncthreads();
}

template <int GS>
__global__ void __launch_bounds__(THREADS)
dense_gn_silu_bwd_kernel(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ W,
                         const float* g_res, float* g_out, const __nv_bfloat16* __restrict__ xhat,
                         const float* __restrict__ rstd, const float* __restrict__ gamma,
                         const float* __restrict__ beta, __nv_bfloat16* __restrict__ dh,
                         float* __restrict__ dgamma_part, float* __restrict__ dbeta_part,
                         uint32_t seed, int layer, uint32_t keep_thresh, float inv_keep, int B,
                         int K, int N) {
  __shared__ __align__(128) Smem sm;
  __shared__ float red[2][N_WARPS][BN];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  gemm_tile16(sm, A, W, row0, col0, B, K, N);

  // Epilogue: warp w takes rows w, w+8, ...; lane l holds columns l and l+32.
  constexpr int ROWS_PER_WARP = BM / N_WARPS;
  constexpr float inv_gs = 1.0f / GS;
  const bool use_dropout = keep_thresh < dr::KEEP_ALL;
  const uint32_t lkey = dr::layer_key(seed, layer);
  float gv[2], bv[2], acc_g[2] = {0.0f, 0.0f}, acc_b[2] = {0.0f, 0.0f};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    gv[half] = gamma[col0 + half * 32 + lane];
    bv[half] = beta[col0 + half * 32 + lane];
  }
  float res[ROWS_PER_WARP][2], xs[ROWS_PER_WARP][2];
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int gr = row0 + warp + i * N_WARPS;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const size_t o = static_cast<size_t>(gr) * N + col0 + half * 32 + lane;
      res[i][half] = (g_res != nullptr && gr < B) ? g_res[o] : 0.0f;
      xs[i][half] = gr < B ? __bfloat162float(xhat[o]) : 0.0f;
    }
  }
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int r = warp + i * N_WARPS;
    const int gr = row0 + r;
    if (gr >= B) continue;  // uniform across the warp
    const uint32_t rkey = dr::row_key(lkey, gr);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gc = col0 + half * 32 + lane;
      const size_t off = static_cast<size_t>(gr) * N + gc;
      float g = sm.c[r * C_LD + half * 32 + lane] + res[i][half];
      if (g_out != nullptr) g_out[off] = g;
      if (use_dropout) g *= dr::keep(rkey, gc, keep_thresh) ? inv_keep : 0.0f;
      const float xh = xs[i][half];
      const float y = xh * gv[half] + bv[half];
      const float sig = 1.0f / (1.0f + __expf(-y));
      const float g_gn = sig * (1.0f + y * (1.0f - sig)) * g;
      acc_g[half] += g_gn * xh;
      acc_b[half] += g_gn;
      const float gx = g_gn * gv[half];
      const float m1 = group_sum<GS>(gx) * inv_gs;
      const float m2 = group_sum<GS>(gx * xh) * inv_gs;
      const float rs = rstd[static_cast<size_t>(gr) * 32 + gc / GS];
      dh[off] = __float2bfloat16_rn(rs * (gx - m1 - xh * m2));
    }
  }

  // the block's column sums over its rows: warp partials, then a fixed-order sum
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    red[0][warp][half * 32 + lane] = acc_g[half];
    red[1][warp][half * 32 + lane] = acc_b[half];
  }
  __syncthreads();
  if (threadIdx.x < 2 * BN) {
    const int which = threadIdx.x / BN, c = threadIdx.x % BN;
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < N_WARPS; ++w) s += red[which][w][c];
    float* part = which == 0 ? dgamma_part : dbeta_part;
    part[static_cast<size_t>(blockIdx.y) * N + col0 + c] = s;
  }
}

}  // namespace

// A [B, K] bf16 (K a multiple of 64), W [K, N] bf16, g_res and g_out
// (nullable; g_out may alias g_res) [B, N] fp32, xhat [B, N] bf16, rstd
// [B, 32] fp32, gamma/beta [N] fp32; writes dh [B, N] bf16 and
// dgamma_part/dbeta_part [ceil(B/64), N] fp32. N/32 must be a power of two
// <= 32 and N a multiple of 64; A and W 16-byte aligned. Returns
// cudaGetLastError().
extern "C" int dposer_dense_gn_silu_bwd(const void* A, const void* W, const float* g_res,
                                        float* g_out, const void* xhat, const float* rstd,
                                        const float* gamma, const float* beta, void* dh,
                                        float* dgamma_part, float* dbeta_part,
                                        unsigned int seed, int layer, unsigned int keep_thresh,
                                        float inv_keep, int B, int K, int N, void* stream) {
  if (B <= 0 || K <= 0 || K % BK != 0 || N % BN != 0 ||
      reinterpret_cast<uintptr_t>(A) % 16 != 0 || reinterpret_cast<uintptr_t>(W) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* a = static_cast<const __nv_bfloat16*>(A);
  const auto* w = static_cast<const __nv_bfloat16*>(W);
  const auto* xh = static_cast<const __nv_bfloat16*>(xhat);
  auto* d = static_cast<__nv_bfloat16*>(dh);
  const dim3 grid(N / BN, (B + BM - 1) / BM);
  const auto s = static_cast<cudaStream_t>(stream);
#define DPOSER_BWD_LAUNCH(GS)                                                                \
  dense_gn_silu_bwd_kernel<GS><<<grid, THREADS, 0, s>>>(a, w, g_res, g_out, xh, rstd, gamma, \
                                                        beta, d, dgamma_part, dbeta_part,   \
                                                        seed, layer, keep_thresh, inv_keep,  \
                                                        B, K, N)
  switch (N / 32) {
    case 2: DPOSER_BWD_LAUNCH(2); break;
    case 4: DPOSER_BWD_LAUNCH(4); break;
    case 8: DPOSER_BWD_LAUNCH(8); break;
    case 16: DPOSER_BWD_LAUNCH(16); break;
    case 32: DPOSER_BWD_LAUNCH(32); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DPOSER_BWD_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
