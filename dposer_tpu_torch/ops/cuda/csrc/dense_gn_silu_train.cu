// K10 dense_gn_silu_train: one layer of the score network's training forward,
//   h    = bf16(A) @ W + proj[row]              (proj bf16 [B, N], per row)
//   xhat = GN32(h), y = xhat * gamma + beta
//   out  = dropout(SiLU(y)) [+ residual]
// writing out (fp32; skipped when out is null), bf16(out) (the stash: the
// next dense layer's A, and the input the weight-gradient GEMMs read),
// bf16(xhat) and rstd per (row, group) for the backward kernel K12.
//
// Replaces: stack_fwd of the TPU train kernel,
// dposer_tpu/ops/pallas/fused_train.py::_make_kernel (:132-149), with the
// stash_in writes of :170-176; the on-core PRNG mask is dropout_hash.cuh's.
//
// Bound on the H100: bytes. At the flagship block layer with its residual
// ([1280, 1024] x [1024, 1024]) the call moves ~23 MB on the Hopper route
// (the bf16 stash as A 2.6 MB, W 2.1 MB, proj 2.6 MB, the residual and out
// 5.2 MB each, the bf16 stash and xhat 2.6 MB each): 6.9 us at 3.35 TB/s,
// against 2.7 GFLOP, 2.7 us at the bf16 tensor rate. (fp32 A: 7.7 us.)
//
// Design: two routes, chosen by the operand, never as a fallback.
// - Given the bf16 copy of A (Ab: the stash the layer before wrote; every
//   K = 1024 layer of a step), the Hopper route: dense_wgmma_ss.cuh's loop
//   (TMA of the copy and W into a 4-stage ring, wgmma m64n64k16 with both
//   operands from shared memory), one 64 x 64 tile a CTA, 160 threads, 66 KB
//   of shared memory, so three CTAs share an SM and one CTA's epilogue
//   overlaps the others' loops. 1,280 rows make 320 tiles: one wave.
// - Given fp32 A (the pre layer, whose input is the perturbed pose at K =
//   63, which TMA cannot address in 252-byte rows; or a caller without the
//   copy), the register route: dense_gemm.cuh's 64 x 64 tile, A rounded to
//   bf16 as it is staged.
// Both end in the same epilogue, in dense_wgmma_ss.cuh's row layout (a
// lane holds one row at 32 columns, 4 consecutive ones at a time): each
// thread's epilogue operands (proj, the residual) are loaded before the
// Hopper route's main loop starts, and gamma and beta once a CTA into
// shared memory; the
// GroupNorm sums of a lane's groups are in-lane adds and at most one shuffle
// each, all of the lane's groups at once; out, the stash and xhat are stored
// 16, 8 and 8 bytes a lane. The arithmetic is the plain version's: two-pass
// fp32 mean and variance, GN_EPS, SiLU, the dropout_hash.cuh mask.
// Kept out after measurement (chip_smoke.py's train kernels, NVIDIA H100
// 80GB HBM3 at 700 W, [1280, 1024] x [1024, 1024]):
// - the block layers on the register route from fp32 A: 50.8 us with the
//   residual, against 18.4 on the Hopper route;
// - the fp32 output of a block's first layer, which only its stash is read
//   of: 16.0 us written, 15.5 not;
// - the ring shapes and the deeper wgmma pipeline of dense_wgmma_ss.cuh's
//   header.
// The register route's element loads (the pre layer, K = 63) take 246
// registers, so one CTA an SM: 320 tiles in three waves.

#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dense_gemm.cuh"
#include "dense_wgmma_ss.cuh"
#include "dropout_hash.cuh"

namespace {

using namespace dposer::dense;
namespace dr = dposer::dropout;
namespace ss = dposer::wgss;

// The Hopper route's ring: one consumer warpgroup, 4 stages, 3 CTAs an SM.
using TrainRing = ss::Ring<1, 4, 3>;

struct Params {
  const __nv_bfloat16* proj;
  const float *gamma, *beta, *residual;
  float* out;
  __nv_bfloat16 *stash, *xhat;
  float* rstd;
  uint32_t seed;
  int layer;
  uint32_t keep_thresh;
  float inv_keep;
  int B, K, N;
};

// A thread's epilogue operands at row gr, columns c0 + 8 j .. + 3 (c0 =
// col0 + 4 h): proj and the residual (0 where absent or past the batch).
struct Operands {
  uint2 pj[8];
  float4 res[8];
};

__device__ __forceinline__ void load_operands(const Params& p, int gr, int c0, Operands& o) {
  const bool live = gr < p.B;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const size_t off = static_cast<size_t>(gr) * p.N + c0 + 8 * j;
    o.pj[j] = live ? *reinterpret_cast<const uint2*>(p.proj + off) : make_uint2(0u, 0u);
    o.res[j] = (live && p.residual != nullptr) ? *reinterpret_cast<const float4*>(p.residual + off)
                                                : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// gamma and beta at the CTA's 64 columns into shared memory: lanes 0-15 of
// one warp gamma, 16-31 beta, a float4 each.
__device__ __forceinline__ void load_affine(const Params& p, int col0, float4 (&gb)[2][16],
                                            int lane) {
  const float* src = lane < 16 ? p.gamma : p.beta;
  gb[lane / 16][lane % 16] = *reinterpret_cast<const float4*>(src + col0 + 4 * (lane % 16));
}

// The epilogue of one thread's row gr at columns col0 + Groups::col(i, h):
// e holds bf16(A) @ W there.
template <int GS>
__device__ __forceinline__ void epilogue(float (&e)[32], const Operands& o,
                                         const float4 (&gb)[2][16], const Params& p, int gr, int h,
                                         int col0) {
  using G = ss::Groups<GS>;
  constexpr float inv_gs = 1.0f / GS;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 pj = ss::bf16x4_to_float4(o.pj[j]);
    e[4 * j] += pj.x;
    e[4 * j + 1] += pj.y;
    e[4 * j + 2] += pj.z;
    e[4 * j + 3] += pj.w;
  }
  float v[1][32], s[1][G::NG];
#pragma unroll
  for (int i = 0; i < 32; ++i) v[0][i] = e[i];
  ss::row_group_sums<GS, 1>(v, s);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    e[i] -= s[0][i / G::PER] * inv_gs;  // d
    v[0][i] = e[i] * e[i];
  }
  ss::row_group_sums<GS, 1>(v, s);
  float rs[G::NG];
#pragma unroll
  for (int g = 0; g < G::NG; ++g) rs[g] = rsqrtf(s[0][g] * inv_gs + GN_EPS);
  if (gr >= p.B) return;
  const bool use_dropout = p.keep_thresh < dr::KEEP_ALL;
  const uint32_t rkey = dr::row_key(dr::layer_key(p.seed, p.layer), gr);
  const size_t row = static_cast<size_t>(gr) * p.N + col0 + 4 * h;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 gv = gb[0][2 * j + h], bv = gb[1][2 * j + h];
    const float gq[4] = {gv.x, gv.y, gv.z, gv.w}, bq[4] = {bv.x, bv.y, bv.z, bv.w};
    const float rq[4] = {o.res[j].x, o.res[j].y, o.res[j].z, o.res[j].w};
    float out4[4], xh4[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = 4 * j + q;
      const float xh = e[i] * rs[i / G::PER];
      const float y = xh * gq[q] + bq[q];
      float sv = y / (1.0f + __expf(-y));
      if (use_dropout)
        sv *= dr::keep(rkey, col0 + G::col(i, h), p.keep_thresh) ? p.inv_keep : 0.0f;
      out4[q] = sv + rq[q];
      xh4[q] = xh;
    }
    if (p.out != nullptr)
      *reinterpret_cast<float4*>(p.out + row + 8 * j) =
          make_float4(out4[0], out4[1], out4[2], out4[3]);
    *reinterpret_cast<uint2*>(p.stash + row + 8 * j) =
        ss::float4_to_bf16x4(out4[0], out4[1], out4[2], out4[3]);
    *reinterpret_cast<uint2*>(p.xhat + row + 8 * j) =
        ss::float4_to_bf16x4(xh4[0], xh4[1], xh4[2], xh4[3]);
  }
  if (G::owner(h)) {
#pragma unroll
    for (int g = 0; g < G::NG; ++g)
      p.rstd[static_cast<size_t>(gr) * 32 + (col0 + G::col(g * G::PER, h)) / GS] = rs[g];
  }
}

// ---------------------------------------------------------------------------
// the register route
// ---------------------------------------------------------------------------

template <int GS, bool VEC>
__global__ void __launch_bounds__(THREADS)
dense_gn_silu_train_kernel(const float* __restrict__ A, const __nv_bfloat16* __restrict__ W,
                           const Params p) {
  __shared__ __align__(128) Smem sm;
  __shared__ float4 gb[2][16];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  if (warp == 4) load_affine(p, col0, gb, lane);
  gemm_tile<VEC, false>(sm, A, nullptr, W, row0, col0, p.B, p.K, p.N);  // ends on a barrier
  if (warp >= 4) return;
  // warps 0-3 finish the tile in the row layout, as the Hopper route's
  // consumer warpgroup does; the operands load after the loop, which holds
  // two register sets of tiles (at the pre layer's K = 63 it is one step)
  const int r = ss::row_of(warp, lane), h = ss::half_of(lane), gr = row0 + r;
  Operands o;
  load_operands(p, gr, col0 + 4 * h, o);
  float e[32];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 c = *reinterpret_cast<const float4*>(&sm.c[r * C_LD + 8 * j + 4 * h]);
    e[4 * j] = c.x;
    e[4 * j + 1] = c.y;
    e[4 * j + 2] = c.z;
    e[4 * j + 3] = c.w;
  }
  epilogue<GS>(e, o, gb, p, gr, h, col0);
}

// ---------------------------------------------------------------------------
// the Hopper route
// ---------------------------------------------------------------------------

template <int GS, class R>
__global__ void __launch_bounds__(R::THREADS, R::MIN_BLOCKS)
dense_gn_silu_train_wgmma_kernel(const __grid_constant__ CUtensorMap tmA,
                                 const __grid_constant__ CUtensorMap tmW, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ float4 gb[2][16];
  const ss::Loop<R> loop(smem_raw, p.K);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.y * R::BM, col0 = blockIdx.x * ss::BN;
  if (warp == R::PRODUCER_WARP) {
    if (lane == 0) loop.start(&tmA, &tmW, row0, col0, p.B);
    load_affine(p, col0, gb, lane);
  }
  __syncthreads();  // the barriers and gamma, beta are in place
  if (warp == R::PRODUCER_WARP) {
    if (lane == 0) loop.produce(&tmA, &tmW, row0, col0, p.B);
    return;
  }
  const int g = warp / 4;
  const int r = 64 * g + ss::row_of(warp % 4, lane), h = ss::half_of(lane), gr = row0 + r;
  Operands o;
  load_operands(p, gr, col0 + 4 * h, o);  // in flight while the loop runs
  float acc[32], e[32];
  loop.consume(acc, g, lane);
  ss::to_rows(acc, e, lane);
  epilogue<GS>(e, o, gb, p, gr, h, col0);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

int launch_register(const float* A, const __nv_bfloat16* W, const Params& p, cudaStream_t s) {
  const dim3 grid(p.N / BN, (p.B + BM - 1) / BM);
  const bool vec = p.K % 4 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(W) % 16 == 0;
  return ss::by_group_size(p.N, [&](auto gs) {
    constexpr int GS = decltype(gs)::value;
    if (vec)
      dense_gn_silu_train_kernel<GS, true><<<grid, THREADS, 0, s>>>(A, W, p);
    else
      dense_gn_silu_train_kernel<GS, false><<<grid, THREADS, 0, s>>>(A, W, p);
    return static_cast<int>(cudaGetLastError());
  });
}

template <class R>
int launch_wgmma(const void* Ab, const void* W, const Params& p, cudaStream_t s) {
  CUtensorMap ma, mw;
  const int e = ss::maps(&ma, &mw, Ab, W, p.B, p.K, p.N);
  if (e != 0) return e;
  const dim3 grid(p.N / ss::BN, (p.B + R::BM - 1) / R::BM);
  return ss::by_group_size(p.N, [&](auto gs) {
    return ss::launch<R, dense_gn_silu_train_wgmma_kernel<decltype(gs)::value, R>>(grid, s, ma,
                                                                                    mw, p);
  });
}

}  // namespace

// A [B, K] fp32 (the register route) or Ab [B, K] bf16 (the Hopper route:
// K % 8 == 0, Ab and W 16-byte aligned; else refused), W [K, N] bf16, proj
// [B, N] bf16, gamma/beta [N] fp32, residual (nullable) and out (nullable:
// not written) [B, N] fp32 (out may alias residual), stash and xhat [B, N]
// bf16, rstd [B, 32] fp32. N/32 (the group size) must be a power of two
// <= 32 and N a multiple of 64; proj, residual, out, stash and xhat 16-byte
// aligned. Returns 0, the error of a failed tensor-map encode, or
// cudaGetLastError() after the launch.
extern "C" int dposer_dense_gn_silu_train(const float* A, const void* Ab, const void* W,
                                          const void* proj, const float* gamma,
                                          const float* beta, const float* residual, float* out,
                                          void* stash, void* xhat, float* rstd,
                                          unsigned int seed, int layer, unsigned int keep_thresh,
                                          float inv_keep, int B, int K, int N, void* stream) {
  if (B <= 0 || K <= 0 || N % BN != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{static_cast<const __nv_bfloat16*>(proj), gamma, beta, residual, out,
                 static_cast<__nv_bfloat16*>(stash), static_cast<__nv_bfloat16*>(xhat), rstd,
                 seed, layer, keep_thresh, inv_keep, B, K, N};
  const auto s = static_cast<cudaStream_t>(stream);
  if (Ab != nullptr) {
    if (!ss::tma_ok(Ab, W, K, N)) return static_cast<int>(cudaErrorInvalidValue);
    return launch_wgmma<TrainRing>(Ab, W, p, s);
  }
  if (A == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_register(A, static_cast<const __nv_bfloat16*>(W), p, s);
}

// The Hopper route's launch at width N (ss::launch_info), for reports.
extern "C" int dposer_dense_gn_silu_train_launch_info(int N, int* out) {
  return ss::by_group_size(N, [&](auto gs) {
    return ss::launch_info<TrainRing,
                           dense_gn_silu_train_wgmma_kernel<decltype(gs)::value, TrainRing>>(out);
  });
}
