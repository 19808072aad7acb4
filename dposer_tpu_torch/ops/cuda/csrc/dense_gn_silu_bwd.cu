// K12 dense_gn_silu_bwd: one hop of the score network's backward data chain,
//   g     = dh_next @ Wt [+ g_res]       (dh_next [B, K] bf16, Wt [K, N] bf16)
//   g_gn  = SiLU'(y) * dropout(g),       y = xhat * gamma + beta
//   g_pre = rstd * (g_xhat - mean_g(g_xhat) - xhat * mean_g(g_xhat * xhat)),
//           g_xhat = g_gn * gamma
// writing g (fp32, where the residual stream carries it on), dh = bf16(g_pre)
// and dgamma = sum_rows g_gn * xhat, dbeta = sum_rows g_gn, summed in a fixed
// order: a step is deterministic, and a resumed run repeats it exactly.
//
// Replaces: stack_bwd of the TPU train kernel with the mm(., W^T) hop before
// it, dposer_tpu/ops/pallas/fused_train.py::_make_kernel (:151-166, :193-206).
// The dropout mask is regenerated from dropout_hash.cuh, as K10 drew it.
//
// Bound on the H100: bytes. At the flagship hop with the carried gradient
// ([1280, 1024] x [1024, 1024]) the call moves ~21 MB (dh_next, xhat and dh
// bf16 2.6 MB each, W 2.1 MB, g_res and g fp32 5.2 MB each, rstd and the
// partials): 6.2 us at 3.35 TB/s, against 2.7 GFLOP, 2.7 us at the bf16
// tensor rate.
//
// Design: dense_wgmma_ss.cuh's loop on every hop (TMA of dh_next and Wt into
// a 4-stage ring, wgmma m64n64k16 with both operands from shared memory, one
// group left in flight while the next is issued),
// one 64 x 64 tile a CTA, 160 threads, three CTAs an SM. The first hop's
// dout is zero-padded from 63 to 64 columns by the wrapper, so its 128-byte
// rows are TMA's too: one stage. Wt is the torch Linear weight [out, in] of
// the next layer as it is: the transpose the TPU kernel was handed is free
// here. The epilogue runs in the loop's row layout: each thread's operands
// (xhat, g_res, rstd) are loaded before its main loop starts, gamma and beta
// once a CTA into shared memory; a lane's two group means, mean_g(g_xhat)
// and mean_g(g_xhat * xhat), are in-lane adds and at most one shuffle each,
// all of its groups at once; g is stored 16 bytes a lane and dh 8. dgamma
// and dbeta: every thread writes its row's terms into a tile in the ring's
// memory, 128 threads sum the tile's columns over its 64 rows in row order
// into the row block's partials, and the last CTA of each column tile to
// finish (a counter in device memory, reset by that CTA) adds the row
// blocks' partials in row-block order: the same bits on every call, with no
// second kernel.
// The register-staged loop this kernel ran before (dense_gemm.cuh with a
// bf16 A) is gone: every operand it took, this route takes.
// Kept out after measurement (chip_smoke.py's train kernels, NVIDIA H100
// 80GB HBM3 at 700 W, at 1,280 rows): the row blocks' partials summed by a
// second kernel (torch.sum over them): the hidden hop with the carried
// gradient 21.5 us against 19.2, the first hop 13.1 against 11.5 (before
// the wgmma pipeline below); that sum's loop unrolled by 8 (train_rings.py):
// 19.4 against 18.7 us, 11.6 against 10.9; and the ring shapes and the
// pipeline depths of dense_wgmma_ss.cuh's header.

#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dense_wgmma_ss.cuh"
#include "dropout_hash.cuh"

namespace {

namespace dr = dposer::dropout;
namespace ss = dposer::wgss;

// one consumer warpgroup, 4 stages, 3 CTAs an SM, one wgmma group left in
// flight (dense_wgmma_ss.cuh's header)
using BwdRing = ss::Ring<1, 4, 3, 1>;

// CTAs of each column tile that have written their partials in the running
// launch; the tile's last CTA sets its count back to 0. Launches of this
// kernel on one device must not overlap (the train step issues them on one
// stream, one after another).
constexpr int MAX_COL_TILES = 64;
__device__ unsigned int col_tiles_done[MAX_COL_TILES];

struct Params {
  const float* g_res;
  float* g_out;
  const __nv_bfloat16* xhat;
  const float *rstd, *gamma, *beta;
  __nv_bfloat16* dh;
  float *dgamma_part, *dbeta_part;
  uint32_t seed;
  int layer;
  uint32_t keep_thresh;
  float inv_keep;
  int B, K, N;
};

// A thread's epilogue operands at row gr, columns col0 + Groups::col(i, h):
// xhat, the carried gradient and rstd of its groups (0 where absent or past
// the batch).
template <int GS>
struct Operands {
  uint2 xs[8];
  float4 gres[8];
  float rs[ss::Groups<GS>::NG];
};

template <int GS>
__device__ __forceinline__ void load_operands(const Params& p, int gr, int h, int col0,
                                              Operands<GS>& o) {
  using G = ss::Groups<GS>;
  const bool live = gr < p.B;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const size_t off = static_cast<size_t>(gr) * p.N + col0 + 4 * h + 8 * j;
    o.xs[j] = live ? *reinterpret_cast<const uint2*>(p.xhat + off) : make_uint2(0u, 0u);
    o.gres[j] = (live && p.g_res != nullptr) ? *reinterpret_cast<const float4*>(p.g_res + off)
                                              : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int g = 0; g < G::NG; ++g)
    o.rs[g] = live ? p.rstd[static_cast<size_t>(gr) * 32 + (col0 + G::col(g * G::PER, h)) / GS]
                   : 0.0f;
}

template <int GS, class R>
__global__ void __launch_bounds__(R::THREADS, R::MIN_BLOCKS)
dense_gn_silu_bwd_kernel(const __grid_constant__ CUtensorMap tmA,
                         const __grid_constant__ CUtensorMap tmW, const Params p) {
  using G = ss::Groups<GS>;
  static_assert(2 * R::BM * ss::RED_LD * 4 <= R::RING_BYTES, "the reduction tile fits the ring");
  extern __shared__ uint8_t smem_raw[];
  __shared__ float4 gb[2][16];
  const ss::Loop<R> loop(smem_raw, p.K);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.y * R::BM, col0 = blockIdx.x * ss::BN;
  if (warp == R::PRODUCER_WARP) {
    if (lane == 0) loop.start(&tmA, &tmW, row0, col0, p.B);
    const float* src = lane < 16 ? p.gamma : p.beta;
    gb[lane / 16][lane % 16] = *reinterpret_cast<const float4*>(src + col0 + 4 * (lane % 16));
  }
  __syncthreads();  // the barriers and gamma, beta are in place
  if (warp == R::PRODUCER_WARP) {
    if (lane == 0) loop.produce(&tmA, &tmW, row0, col0, p.B);
    return;
  }
  const int wg = warp / 4;
  const int r = 64 * wg + ss::row_of(warp % 4, lane), h = ss::half_of(lane), gr = row0 + r;
  const bool live = gr < p.B;
  Operands<GS> o;
  load_operands<GS>(p, gr, h, col0, o);  // in flight while the loop runs
  float acc[32], e[32];
  loop.consume(acc, wg, lane);
  ss::to_rows(acc, e, lane);
  // every consumer is done with the ring, which now holds the tile of this
  // CTA's dgamma and dbeta terms [2][BM][RED_LD]
  ss::consumers_sync<R>();
  float* red = reinterpret_cast<float*>(loop.ring);

  const bool use_dropout = p.keep_thresh < dr::KEEP_ALL;
  const uint32_t rkey = dr::row_key(dr::layer_key(p.seed, p.layer), gr);
  const size_t row = static_cast<size_t>(gr) * p.N + col0 + 4 * h;
  // gx: g_xhat; m: the in-lane group sums of g_xhat and g_xhat * xhat, in
  // column order as the terms are made
  float gx[32], m[2][G::NG];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 gv = gb[0][2 * j + h], bv = gb[1][2 * j + h];
    const float gq[4] = {gv.x, gv.y, gv.z, gv.w}, bq[4] = {bv.x, bv.y, bv.z, bv.w};
    const float rq[4] = {o.gres[j].x, o.gres[j].y, o.gres[j].z, o.gres[j].w};
    const float4 x4 = ss::bf16x4_to_float4(o.xs[j]);
    const float xq[4] = {x4.x, x4.y, x4.z, x4.w};
    float g4[4], pg[4], pb[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = 4 * j + q;
      float g = e[i] + rq[q];
      g4[q] = g;
      if (use_dropout)
        g *= dr::keep(rkey, col0 + G::col(i, h), p.keep_thresh) ? p.inv_keep : 0.0f;
      const float y = xq[q] * gq[q] + bq[q];
      const float sig = 1.0f / (1.0f + __expf(-y));
      const float g_gn = live ? sig * (1.0f + y * (1.0f - sig)) * g : 0.0f;
      pg[q] = g_gn * xq[q];
      pb[q] = g_gn;
      gx[i] = g_gn * gq[q];
      const int k = i / G::PER;
      m[0][k] = i % G::PER == 0 ? gx[i] : m[0][k] + gx[i];
      m[1][k] = i % G::PER == 0 ? gx[i] * xq[q] : m[1][k] + gx[i] * xq[q];
    }
    if (p.g_out != nullptr && live)
      *reinterpret_cast<float4*>(p.g_out + row + 8 * j) = make_float4(g4[0], g4[1], g4[2], g4[3]);
    *reinterpret_cast<float4*>(&red[r * ss::RED_LD + 8 * j + 4 * h]) =
        make_float4(pg[0], pg[1], pg[2], pg[3]);
    *reinterpret_cast<float4*>(&red[(R::BM + r) * ss::RED_LD + 8 * j + 4 * h]) =
        make_float4(pb[0], pb[1], pb[2], pb[3]);
  }
  ss::across_halves<GS, 2>(m);
  constexpr float inv_gs = 1.0f / GS;
  if (live) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 x4 = ss::bf16x4_to_float4(o.xs[j]);
      const float xq[4] = {x4.x, x4.y, x4.z, x4.w};
      float d4[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 4 * j + q, k = i / G::PER;
        d4[q] = o.rs[k] * (gx[i] - m[0][k] * inv_gs - xq[q] * (m[1][k] * inv_gs));
      }
      *reinterpret_cast<uint2*>(p.dh + row + 8 * j) = ss::float4_to_bf16x4(d4[0], d4[1], d4[2], d4[3]);
    }
  }

  // the tile's column sums over its rows, in row order, into this row
  // block's partials
  ss::consumers_sync<R>();
  const int which = threadIdx.x / ss::BN, c = threadIdx.x % ss::BN;
  float* part = (which == 0 ? p.dgamma_part : p.dbeta_part) + col0 + c;
  if (threadIdx.x < 2 * ss::BN) {
    const float* col = red + which * R::BM * ss::RED_LD + c;
    float s = 0.0f;
#pragma unroll 16
    for (int rr = 0; rr < R::BM; ++rr) s += col[rr * ss::RED_LD];
    part[static_cast<size_t>(blockIdx.y) * p.N] = s;
    __threadfence();  // the partial is visible device-wide before the count
  }
  // the column tile's last CTA to finish adds every row block's partials in
  // row-block order into row 0: the same bits whichever CTA is last
  __shared__ bool last;
  ss::consumers_sync<R>();
  if (threadIdx.x == 0) last = atomicAdd(&col_tiles_done[blockIdx.x], 1u) == gridDim.y - 1;
  ss::consumers_sync<R>();
  if (!last) return;
  if (threadIdx.x < 2 * ss::BN) {
    __threadfence();
    float s = 0.0f;
    for (int b = 0; b < static_cast<int>(gridDim.y); ++b)
      s += __ldcg(part + static_cast<size_t>(b) * p.N);
    part[0] = s;
  }
  if (threadIdx.x == 0) col_tiles_done[blockIdx.x] = 0;  // ready for the next launch
}

}  // namespace

// A [B, K] bf16 (K % 8 == 0; the rows of a ragged last 64-deep box past K
// read as zeros), W [K, N] bf16, both 16-byte aligned; g_res and g_out
// (nullable; g_out may alias g_res) [B, N] fp32, xhat [B, N] bf16, rstd
// [B, 32] fp32, gamma/beta [N] fp32; writes dh [B, N] bf16 and
// dgamma_part/dbeta_part [ceil(B / dposer_dense_gn_silu_bwd_tile_rows()),
// N] fp32, the row blocks' partial sums, whose row 0 holds dgamma and dbeta
// (the sums over every row block) when the kernel ends. N/32 must be a
// power of two <= 32 and N a multiple of 64; the [B, N] operands 16-byte
// aligned. Returns 0, the error of a failed tensor-map encode, or
// cudaGetLastError() after the launch.
extern "C" int dposer_dense_gn_silu_bwd(const void* A, const void* W, const float* g_res,
                                        float* g_out, const void* xhat, const float* rstd,
                                        const float* gamma, const float* beta, void* dh,
                                        float* dgamma_part, float* dbeta_part,
                                        unsigned int seed, int layer, unsigned int keep_thresh,
                                        float inv_keep, int B, int K, int N, void* stream) {
  using R = BwdRing;
  if (B <= 0 || K <= 0 || N % ss::BN != 0 || N / ss::BN > MAX_COL_TILES ||
      !ss::tma_ok(A, W, K, N))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{g_res, g_out, static_cast<const __nv_bfloat16*>(xhat), rstd, gamma, beta,
                 static_cast<__nv_bfloat16*>(dh), dgamma_part, dbeta_part, seed, layer,
                 keep_thresh, inv_keep, B, K, N};
  CUtensorMap ma, mw;
  const int e = ss::maps(&ma, &mw, A, W, B, K, N);
  if (e != 0) return e;
  const dim3 grid(N / ss::BN, (B + R::BM - 1) / R::BM);
  const auto s = static_cast<cudaStream_t>(stream);
  return ss::by_group_size(N, [&](auto gs) {
    return ss::launch<R, dense_gn_silu_bwd_kernel<decltype(gs)::value, R>>(grid, s, ma, mw, p);
  });
}

// The rows of the tile a CTA reduces dgamma and dbeta over: the partials
// have ceil(B / this) rows.
extern "C" int dposer_dense_gn_silu_bwd_tile_rows(void) { return BwdRing::BM; }

// The launch at width N (ss::launch_info), for reports.
extern "C" int dposer_dense_gn_silu_bwd_launch_info(int N, int* out) {
  return ss::by_group_size(N, [&](auto gs) {
    return ss::launch_info<BwdRing, dense_gn_silu_bwd_kernel<decltype(gs)::value, BwdRing>>(out);
  });
}
