// K7 dense_gn_silu_jvp: one hidden layer of the score network with its
// forward-mode tangent,
//   h  = bf16(A) @ W + tp            dh  = bf16(dA) @ W
//   y  = GN32(h) * gamma + beta      dy  = its tangent along dh
//   out = SiLU(y) [+ residual]       dout = SiLU'(y) * dy [+ dresidual]
// and, when asked, bf16 copies of out and dout (round to nearest even): the
// next layer's A and dA, since its product rounds them to bf16 anyway.
//
// Replaces: one layer of dposer_tpu/ops/pallas/score_net.py::bind_fwd_jvp
// (mm, gnorm_jvp, silu_jvp and the block's h + h2, dh + dh2) inside the TPU
// likelihood kernel, dposer_tpu/ops/pallas/fused_lik.py::_make_kernel. The
// tangent rules, written out by hand as there:
//   GN:   mu = mean_g(h), d = h - mu, a = rsqrt(mean_g(d^2) + eps)
//         dmu = mean_g(dh), dvar = 2 * mean_g(d * dh), da = -a^3 * dvar / 2
//         dy = ((dh - dmu) * a + d * da) * gamma
//   SiLU: sig = sigmoid(y); dout = sig * (1 + y * (1 - sig)) * dy
// mean_g(d * dh) equals the TPU kernel's mean_g(h * dh) - mu * dmu without its
// cancellation, and the variance is the two-pass form K1 uses.
//
// Bound on the H100: at the likelihood's block layer ([50, 1024] pair x
// [1024, 1024] + the residual pair) the call moves ~3.3 MB on the Hopper
// route (W bf16 2.1 MB; the bf16 A pair 0.2 MB; the residual pair, the fp32
// out pair and the bf16 copies 1.0 MB) against 0.21 GFLOP: ~1.0 us of HBM
// time vs ~0.2 us of bf16 tensor-core time. Bytes bound, and the weights
// are most of the bytes. (The register route reads A as fp32: ~3.5 MB.)
//
// Design: two routes, chosen by the operand, never as a fallback.
// - Given bf16 A and dA (Ab, dAb: the copies the layer before wrote; every
//   K = 1024 layer of the likelihood), the Hopper route, split-K over a
//   thread-block cluster:
//   - A cluster of SPLIT CTAs owns one 64-column tile of up to 64 poses;
//     CTA `rank` takes the depth slice [rank * KC, (rank + 1) * KC), KC =
//     K / SPLIT. At K = 1024 SPLIT is 4 (KC = 256): at 50 rows the grid is
//     16 column tiles x 4 = 64 CTAs, each taking 32 KB of W and 64 KB of the
//     A pair, where the register route gave 32 blocks each walking all of K.
//     W is read from L2 once a row tile (2 MB at <= 64 poses).
//   - One thread starts every copy at once, all on one mbarrier: the A and
//     dA slices as TMA boxes of 64 rows x 64 bf16 (one 128-byte swizzle
//     atom a row; rows past the batch read as zeros), the W slice as one box
//     of KC rows x 64 columns, both with the 128-byte swizzle. There is no
//     ring: the whole slice fits.
//   - Warpgroup 0 multiplies A's rows, warpgroup 1 dA's (the stacked 128
//     rows: a pose's primal and tangent rows are the same row of the two
//     m64 tiles): wgmma m64n64k16, both operands from shared memory (A
//     K-major through desc_k, W MN-major through desc_b), fp32 sums. Nothing
//     is converted in the loop.
//   - The CTA of rank q finishes poses [q * RPC, (q + 1) * RPC), RPC = 64 /
//     SPLIT, with their tangents. Each thread stores its accumulators of
//     those rows straight from registers into the finishing CTA's shared
//     memory (st.async, 16 bytes each after a swap with the neighbouring
//     lane, counted in on that CTA's partials mbarrier, which expects the
//     rows inside the batch from all SPLIT ranks), at [its rank]; the
//     finishing CTA adds them in rank order: no atomics, the same bits on
//     every call. As in head_cluster.cuh, one relaxed cluster arrive after
//     the barriers are set up, waited on before the first push, is the only
//     cluster barrier.
//   - While the copies fly, each thread loads its epilogue operands (the
//     time row, the GN affine, the residual pair of its rows).
// - Given fp32 A and dA (the pre layer, whose input is the state x at K =
//   63, which TMA cannot address in 252-byte rows; or any caller without
//   copies), the register route: dense_gemm.cuh's 64x64 tile in its STACKED
//   form (tile rows 0..31 are 32 rows of A, rows 32..63 the same rows of dA,
//   so every staged W tile feeds both products), 36 KB of static shared
//   memory, A rounded to bf16 as it is staged.
// Both end in the same epilogue: warp w finishes rows w, w + 8, ... of the
// CTA's rows, lane l columns l and l + 32, so a group of GS = N/32 features
// is GS consecutive lanes; the four group sums (h, dh, then d^2, d*dh) of
// the warp's rows go up the shuffle tree together, the chains interleaved
// as in gn_epilogue.cuh::gn_silu_epilogue_q.
// Measured on the card at the likelihood's 50 rows and kept out:
// - clusters of 8 at K = 1024 (128 CTAs of 128-deep slices): slower than 4
//   (PERF.md), the partials' DSMEM traffic doubling (every CTA sends its
//   whole 128 x 64 tile); so split_for takes the fewest CTAs whose slices
//   fit, and 8 only where K is deeper than 1024;
// - 8-byte pushes of every tile row, the 14 padding rows included: slower
//   than 16-byte pushes of the rows inside the batch;
// - one mbarrier a 64-deep box, each box's MMAs starting as it lands: no
//   gain at clusters of 4 (the MMAs are a small part of the time).

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dense_gemm.cuh"
#include "dense_wgmma.cuh"
#include "mbarrier.cuh"
#include "tensor_map.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace dposer::dense;
using dposer::smem_u32;

constexpr int ROWS = BM / 2;   // primal rows of a register-route block
constexpr int WARPS = THREADS / 32;
constexpr int A_BOX = BM * 128;  // one bf16 A box: 64 rows x 64 values
constexpr int MAX_KC = 256;      // the deepest slice a CTA takes
constexpr int RECV_BYTES = 2 * BM * BN * 4;  // a CTA's rows' partials from every rank

// Dynamic shared memory of a Hopper-route CTA at slice depth KC: slack to
// align to the swizzle's 1024 bytes, the A and dA boxes, the W box, the
// received partials, two mbarriers.
__host__ __device__ constexpr int smem_bytes(int KC) {
  return 1024 + 2 * (KC / 64) * A_BOX + KC * BN * 2 + RECV_BYTES + 16;
}

// Sum over the gs consecutive lanes of a GroupNorm group, in every lane of
// it, for each of the M values: the chains go up the tree together.
template <int M>
__device__ __forceinline__ void group_sums(float (&v)[M], int gs) {
  for (int off = gs / 2; off > 0; off >>= 1)
#pragma unroll
    for (int k = 0; k < M; ++k) v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
}

// The GN-JVP epilogue of a lane's M = 2 * rows elements, element k at row
// gr[k / 2] and column col0 + (k % 2) * 32 + lane: h (v, before the time
// row) and dh (dv) in, out and dout (and their bf16 copies, when out_b is
// given) stored.
template <int M>
__device__ __forceinline__ void jvp_epilogue(float (&v)[M], float (&dv)[M],
                                             const float (&res)[M], const float (&dres)[M],
                                             const int (&gr)[M / 2], const float (&tpv)[2],
                                             const float (&gv)[2], const float (&bv)[2],
                                             float* out, float* dout, __nv_bfloat16* out_b,
                                             __nv_bfloat16* dout_b, int col0, int B, int N) {
  const int lane = threadIdx.x % 32, gs = N / 32;
  const float inv_gs = 1.0f / gs;
  float s[2 * M], dmu[M];
#pragma unroll
  for (int k = 0; k < M; ++k) {
    v[k] += tpv[k % 2];
    s[k] = v[k];
    s[M + k] = dv[k];
  }
  group_sums(s, gs);
#pragma unroll
  for (int k = 0; k < M; ++k) {
    v[k] -= s[k] * inv_gs;  // d
    dmu[k] = s[M + k] * inv_gs;
    s[k] = v[k] * v[k];
    s[M + k] = v[k] * dv[k];
  }
  group_sums(s, gs);
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const int half = k % 2;
    const float a = rsqrtf(s[k] * inv_gs + GN_EPS);
    const float dvar = 2.0f * s[M + k] * inv_gs;
    const float da = -0.5f * a * a * a * dvar;
    const float y = v[k] * a * gv[half] + bv[half];
    const float dy = ((dv[k] - dmu[k]) * a + v[k] * da) * gv[half];
    const float sig = 1.0f / (1.0f + __expf(-y));
    const float o = y * sig + res[k];
    const float od = sig * (1.0f + y * (1.0f - sig)) * dy + dres[k];
    if (gr[k / 2] < B) {
      const size_t idx = static_cast<size_t>(gr[k / 2]) * N + col0 + half * 32 + lane;
      out[idx] = o;
      dout[idx] = od;
      if (out_b != nullptr) {
        out_b[idx] = __float2bfloat16_rn(o);
        dout_b[idx] = __float2bfloat16_rn(od);
      }
    }
  }
}

// A lane's GN rows (time row, gamma, beta) at its two columns, and the
// residual pair at its M elements (0 where absent or past the batch).
template <int M>
__device__ __forceinline__ void load_operands(const float* __restrict__ tp,
                                              const float* __restrict__ gamma,
                                              const float* __restrict__ beta,
                                              const float* residual, const float* dresidual,
                                              const int (&gr)[M / 2], int col0, int B, int N,
                                              float (&tpv)[2], float (&gv)[2], float (&bv)[2],
                                              float (&res)[M], float (&dres)[M]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int gc = col0 + half * 32 + lane;
    tpv[half] = tp[gc];
    gv[half] = gamma[gc];
    bv[half] = beta[gc];
  }
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const bool live = residual != nullptr && gr[k / 2] < B;
    const size_t o = static_cast<size_t>(gr[k / 2]) * N + col0 + (k % 2) * 32 + lane;
    res[k] = live ? residual[o] : 0.0f;
    dres[k] = live ? dresidual[o] : 0.0f;
  }
}

// ---------------------------------------------------------------------------
// the register route
// ---------------------------------------------------------------------------

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
dense_gn_silu_jvp_kernel(const float* __restrict__ A, const float* __restrict__ dA,
                         const __nv_bfloat16* __restrict__ W, const float* __restrict__ tp,
                         const float* __restrict__ gamma, const float* __restrict__ beta,
                         const float* residual, const float* dresidual, float* out,
                         float* dout, __nv_bfloat16* out_b, __nv_bfloat16* dout_b, int B,
                         int K, int N) {
  __shared__ __align__(128) Smem sm;
  constexpr int M = 2 * (ROWS / WARPS);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.y * ROWS;
  const int col0 = blockIdx.x * BN;
  gemm_tile<VEC, true>(sm, A, dA, W, row0, col0, B, K, N);

  // warp w takes tile rows w, w + 8, ... of the 32; a row's tangent is 32
  // tile rows below it
  int gr[M / 2];
#pragma unroll
  for (int i = 0; i < M / 2; ++i) gr[i] = row0 + warp + i * WARPS;
  float tpv[2], gv[2], bv[2], res[M], dres[M], v[M], dv[M];
  load_operands(tp, gamma, beta, residual, dresidual, gr, col0, B, N, tpv, gv, bv, res, dres);
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const int r = warp + (k / 2) * WARPS, c = (k % 2) * 32 + lane;
    v[k] = sm.c[r * C_LD + c];
    dv[k] = sm.c[(r + ROWS) * C_LD + c];
  }
  jvp_epilogue(v, dv, res, dres, gr, tpv, gv, bv, out, dout, out_b, dout_b, col0, B, N);
}

// ---------------------------------------------------------------------------
// the Hopper route
// ---------------------------------------------------------------------------

// (launched in clusters of SPLIT CTAs: dposer::launch_cluster)
template <int SPLIT>
__global__ void __launch_bounds__(THREADS)
dense_gn_silu_jvp_wgmma_kernel(const __grid_constant__ CUtensorMap tmA,
                               const __grid_constant__ CUtensorMap tmdA,
                               const __grid_constant__ CUtensorMap tmW,
                               const float* __restrict__ tp, const float* __restrict__ gamma,
                               const float* __restrict__ beta, const float* residual,
                               const float* dresidual, float* out, float* dout,
                               __nv_bfloat16* out_b, __nv_bfloat16* dout_b, int B, int K,
                               int N) {
  using namespace dposer::wgmma;
  constexpr int RPC = BM / SPLIT;      // poses this CTA finishes
  constexpr int M = 2 * (RPC / WARPS);  // (row, half) elements a lane finishes
  static_assert(RPC % WARPS == 0, "a warp finishes whole rows");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int KC = K / SPLIT, boxes = KC / 64;
  const uint32_t a_s = smem_u32(base), w_s = a_s + 2 * boxes * A_BOX;
  float* recv = reinterpret_cast<float*>(base + 2 * boxes * A_BOX + KC * BN * 2);
  const uint32_t bar = smem_u32(recv + RECV_BYTES / 4), recv_bar = bar + 8;
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int col0 = (blockIdx.x / SPLIT) * BN, row0 = blockIdx.y * BM, k0 = rank * KC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tmA)) : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tmdA)) : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tmW)) : "memory");
    dposer::mbar_init(bar, 1);
    dposer::mbar_init(recv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    // the partials of this CTA's rows inside the batch, from every rank
    const int rows = min(max(B - row0 - rank * RPC, 0), RPC);
    dposer::mbar_expect_tx(recv_bar, static_cast<uint32_t>(rows * SPLIT * 2 * BN * 4));
    dposer::mbar_expect_tx(bar, static_cast<uint32_t>(2 * boxes * A_BOX + KC * BN * 2));
    for (int q = 0; q < boxes; ++q) {
      dposer::tma_load(a_s + q * A_BOX, &tmA, bar, k0 + 64 * q, row0);
      dposer::tma_load(a_s + (boxes + q) * A_BOX, &tmdA, bar, k0 + 64 * q, row0);
    }
    dposer::tma_load(w_s, &tmW, bar, col0, k0);
  }
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  __syncthreads();  // the barriers are initialized

  // the epilogue's operands while the copies fly: warp w finishes this CTA's
  // rows w, w + 8, ... (tile rows rank * RPC + those)
  int gr[M / 2];
#pragma unroll
  for (int i = 0; i < M / 2; ++i) gr[i] = row0 + rank * RPC + warp + i * WARPS;
  float tpv[2], gv[2], bv[2], res[M], dres[M];
  load_operands(tp, gamma, beta, residual, dresidual, gr, col0, B, N, tpv, gv, bv, res, dres);

  // the product: warpgroup g multiplies operand tile g (0: A, 1: dA) by the W slice
  const int g = warp / 4;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  dposer::mbar_wait(bar, 0);
  __syncwarp();  // the warp converged again for the .aligned wgmma instructions
  // one wgmma group a 64-deep box, waited on before the next: with the
  // accumulators carried across a runtime loop's back edge inside one group,
  // ptxas serialized every wgmma (C7515)
  const uint32_t at = a_s + g * boxes * A_BOX;
  for (int q = 0; q < boxes; ++q) {
#pragma unroll
    for (int i = 0; i < 32; ++i) keep(acc[i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16_ss(acc, desc_k(at + q * A_BOX + 32 * kk),
                         desc_b(w_s + (4 * q + kk) * 2048));
    wgmma_commit();
    wgmma_wait<0>();
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) keep(acc[i]);

  // push: rows of operand tile g to the CTA that finishes them, at [this
  // rank][g][row among its RPC], rows past the batch's end left out. Lanes t
  // and t ^ 1 (t = lane % 4) hold columns 2t, 2t + 1 and their neighbours of
  // rows r0 and r0 + 8; they swap halves so that each sends 16-byte pieces,
  // the even lane row r0's columns 2t .. 2t + 3, the odd lane row r0 + 8's
  // columns 2t - 2 .. 2t + 1.
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");  // peers' barriers exist
  const int t = lane & 3, odd = t & 1;
  const int r = 16 * (warp % 4) + (lane >> 2) + 8 * odd, owner = r / RPC;
  const uint32_t dst = dposer::mapa(
      smem_u32(recv + ((rank * 2 + g) * RPC + r % RPC) * BN + 2 * (t - odd)), owner);
  const uint32_t rb = dposer::mapa(recv_bar, owner);
  const bool live = row0 + r < B;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float x0 = __shfl_xor_sync(0xffffffffu, odd ? acc[4 * j] : acc[4 * j + 2], 1);
    const float x1 = __shfl_xor_sync(0xffffffffu, odd ? acc[4 * j + 1] : acc[4 * j + 3], 1);
    const float4 v = odd ? make_float4(x0, x1, acc[4 * j + 2], acc[4 * j + 3])
                         : make_float4(acc[4 * j], acc[4 * j + 1], x0, x1);
    if (live) dposer::st_async(dst + 4 * 8 * j, v, rb);
  }

  // finish this CTA's rows: every rank's partials, added in rank order
  dposer::mbar_wait_cluster(recv_bar, 0);
  float v[M], dv[M];
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const int lr = warp + (k / 2) * WARPS, c = (k % 2) * 32 + lane;
    float s = 0.0f, ds = 0.0f;
#pragma unroll
    for (int q = 0; q < SPLIT; ++q) {
      s += recv[((q * 2) * RPC + lr) * BN + c];
      ds += recv[((q * 2 + 1) * RPC + lr) * BN + c];
    }
    v[k] = s;
    dv[k] = ds;
  }
  jvp_epilogue(v, dv, res, dres, gr, tpv, gv, bv, out, dout, out_b, dout_b, col0, B, N);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

struct Args {
  const float *A, *dA;
  const void *Ab, *dAb, *W;
  const float *tp, *gamma, *beta, *residual, *dresidual;
  float *out, *dout;
  __nv_bfloat16 *out_b, *dout_b;
  int B, K, N;
  cudaStream_t stream;
};

// The Hopper route's cluster size at depth K: the fewest CTAs, of 1, 2, 4
// and 8, whose slices are whole 64-deep boxes at most MAX_KC deep (K = 1024:
// 4 CTAs of 256); 0 where none is.
int split_for(int K) {
  for (int split = 1; split <= 8; split *= 2)
    if (K % (64 * split) == 0 && K / split <= MAX_KC) return split;
  return 0;
}

// The Hopper route takes a depth split_for cuts, and operands TMA can address.
bool wgmma_ok(const Args& a) {
  return split_for(a.K) != 0 && a.dAb != nullptr && reinterpret_cast<uintptr_t>(a.Ab) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(a.dAb) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(a.W) % 16 == 0;
}

// More than 48 KB of dynamic shared memory a CTA, allowed once a kernel.
template <int SPLIT>
cudaError_t allow_smem() {
  static const cudaError_t attr =
      cudaFuncSetAttribute(dense_gn_silu_jvp_wgmma_kernel<SPLIT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(MAX_KC));
  return attr;
}

template <int SPLIT>
int launch_wgmma(const Args& a) {
  const cudaError_t attr = allow_smem<SPLIT>();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int KC = a.K / SPLIT;
  CUtensorMap ma, mda, mw;
  int e = dposer::tensor_map(&ma, a.Ab, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.K, a.B, 64, BM);
  if (e == 0)
    e = dposer::tensor_map(&mda, a.dAb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.K, a.B, 64, BM);
  if (e == 0)
    e = dposer::tensor_map(&mw, a.W, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.N, a.K, BN, KC);
  if (e != 0) return e;
  const dim3 grid(a.N / BN * SPLIT, (a.B + BM - 1) / BM);
  const cudaError_t err = dposer::launch_cluster(
      dense_gn_silu_jvp_wgmma_kernel<SPLIT>, grid, THREADS, smem_bytes(KC), a.stream, SPLIT, ma,
      mda, mw, a.tp, a.gamma, a.beta, a.residual, a.dresidual, a.out, a.dout, a.out_b,
      a.dout_b, a.B, a.K, a.N);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

int launch_register(const Args& a) {
  const dim3 grid(a.N / BN, (a.B + ROWS - 1) / ROWS);
  const auto* w = static_cast<const __nv_bfloat16*>(a.W);
  const bool vec = a.K % 4 == 0 && reinterpret_cast<uintptr_t>(a.A) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.dA) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.W) % 16 == 0;
  if (vec)
    dense_gn_silu_jvp_kernel<true><<<grid, THREADS, 0, a.stream>>>(
        a.A, a.dA, w, a.tp, a.gamma, a.beta, a.residual, a.dresidual, a.out, a.dout, a.out_b,
        a.dout_b, a.B, a.K, a.N);
  else
    dense_gn_silu_jvp_kernel<false><<<grid, THREADS, 0, a.stream>>>(
        a.A, a.dA, w, a.tp, a.gamma, a.beta, a.residual, a.dresidual, a.out, a.dout, a.out_b,
        a.dout_b, a.B, a.K, a.N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A, dA [B, K] fp32 (the register route) or Ab, dAb [B, K] bf16 (the Hopper
// route, split over clusters of split_for(K) CTAs: K a multiple of 64 that
// 1, 2, 4 or 8 CTAs cut into slices of at most 256, Ab, dAb and W 16-byte
// aligned; else refused), W [K, N] bf16, tp/gamma/beta [N] fp32; residual and
// dresidual (both or neither nullable), out and dout [B, N] fp32; out may
// alias residual and dout dresidual. out_b, dout_b [B, N] bf16 (both or
// neither nullable): the bf16 copies of out and dout. N/32 (the group size)
// must be a power of two <= 32 and N a multiple of 64. Returns 0, the error
// of a failed tensor-map encode, or cudaGetLastError() after the launch.
extern "C" int dposer_dense_gn_silu_jvp(const float* A, const float* dA, const void* Ab,
                                        const void* dAb, const void* W, const float* tp,
                                        const float* gamma, const float* beta,
                                        const float* residual, const float* dresidual,
                                        float* out, float* dout, void* out_b, void* dout_b,
                                        int B, int K, int N, void* stream) {
  const Args a{A, dA, Ab, dAb, W, tp, gamma, beta, residual, dresidual, out, dout,
               static_cast<__nv_bfloat16*>(out_b), static_cast<__nv_bfloat16*>(dout_b), B, K, N,
               static_cast<cudaStream_t>(stream)};
  const int gs = N / 32;
  if (B <= 0 || K <= 0 || N % BN != 0 || (gs & (gs - 1)) != 0 || gs > 32 ||
      (residual == nullptr) != (dresidual == nullptr) || (out_b == nullptr) != (dout_b == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (Ab == nullptr) {
    if (A == nullptr || dA == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return launch_register(a);
  }
  if (!wgmma_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  switch (split_for(K)) {
    case 1: return launch_wgmma<1>(a);
    case 2: return launch_wgmma<2>(a);
    case 4: return launch_wgmma<4>(a);
    default: return launch_wgmma<8>(a);
  }
}

// The Hopper route's launch at B rows, depth K and width N, for reports: grid CTAs, cluster size, threads and dynamic shared
// memory a CTA, and the clusters the current device holds at once
// (cudaOccupancyMaxActiveClusters). Returns 0 or a CUDA error code.
template <int SPLIT>
static int launch_info(int B, int K, int N, int* out) {
  const cudaError_t attr = allow_smem<SPLIT>();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(N / BN * SPLIT, (B + BM - 1) / BM);
  out[0] = static_cast<int>(grid.x * grid.y);
  out[1] = SPLIT;
  out[2] = THREADS;
  out[3] = smem_bytes(K / SPLIT);
  return static_cast<int>(dposer::active_clusters(
      &out[4], dense_gn_silu_jvp_wgmma_kernel<SPLIT>, grid, THREADS, out[3], SPLIT));
}

extern "C" int dposer_dense_gn_silu_jvp_launch_info(int B, int K, int N, int* out) {
  if (B <= 0 || N % BN != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (split_for(K)) {
    case 1: return launch_info<1>(B, K, N, out);
    case 2: return launch_info<2>(B, K, N, out);
    case 4: return launch_info<4>(B, K, N, out);
    case 8: return launch_info<8>(B, K, N, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
