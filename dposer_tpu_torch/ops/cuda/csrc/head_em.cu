// K2 head_em: out = bf16(h) @ Wpost + bpost, then the step's update.
//   EM mode (0):    x_mean = cx*x + cout*out; x <- x_mean + cn*z
//                   (x_mean also written when requested: the denoised result)
//   score mode (1): score = s*out and per-row |score|^2, for the corrector
//
// Replaces: the output head and the EM update inside the TPU
// reverse-diffusion kernel, dposer_tpu/ops/pallas/fused_em.py::_make_kernel
// (fwd's post-dense, :199-206) and the corrector's score (:178), with the
// on-core Box-Muller draw (score_net.py::box_muller) replaced by Philox.
//
// Bound on the H100: [500, 1024] x [1024, 63] is 64.5 MFLOP (~0.07 us of
// bf16 tensor-core time) against ~2.4 MB moved (h fp32 read once, x read and
// written): bytes bound, ~0.7 us.
//
// Design: a block owns 16 rows and all 64 (zero-padded) output columns. It
// stages its rows of h as bf16 in shared memory with 16-byte loads, all of a
// thread's loads in flight at once. 16 warps split the work 4 column tiles x
// 4 quarters of the depth, each a chain of bf16 WMMA 16x16x16 steps with
// fp32 accumulation that reads Wpost from L2; the four partial sums meet in
// shared memory. The update runs in the epilogue, so out never goes to
// device memory; in score mode warp r owns row r and reduces its norm with
// shuffles. The step's scalars are read from the device coefficient table,
// so the host loop never synchronizes.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int ROWS = 16;
constexpr int DP = 64;  // padded output width of Wpost / bpost
constexpr int THREADS = 512;
constexpr int N_WARPS = THREADS / 32;
constexpr int K_SPLIT = N_WARPS / (DP / 16);  // 4 quarters of the depth
constexpr int C_LD = DP + 4;
constexpr int N_COEFS = 8;  // cx, cout, cnoise, score_scale, alpha, (imputation x2), pad
constexpr int STAGE_CHUNK = 8;  // float4 loads a thread keeps in flight

__global__ void __launch_bounds__(THREADS)
head_em_kernel(const float* __restrict__ h, const __nv_bfloat16* __restrict__ Wpost,
               const float* __restrict__ bpost, const float* __restrict__ coefs, int step,
               int mode, float* x, float* x_mean, float* score, float* score_sq,
               const float* __restrict__ noise, unsigned long long seed, int slab, int B,
               int H, int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int a_ld = H + 8;
  auto* As = reinterpret_cast<__nv_bfloat16*>(smem);
  auto* Cs = reinterpret_cast<float*>(smem);  // the partial sums, after the MMAs

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = blockIdx.x * ROWS;

  // stage h [ROWS, H] as bf16: 16-byte loads, STAGE_CHUNK in flight
  const int h4 = H / 4;
  for (int q0 = tid; q0 < ROWS * h4; q0 += THREADS * STAGE_CHUNK) {
    float4 v[STAGE_CHUNK];
#pragma unroll
    for (int u = 0; u < STAGE_CHUNK; ++u) {
      const int q = q0 + u * THREADS;
      const int r = q / h4, gr = row0 + r;
      v[u] = (q < ROWS * h4 && gr < B)
                 ? *reinterpret_cast<const float4*>(h + static_cast<size_t>(gr) * H + (q % h4) * 4)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < STAGE_CHUNK; ++u) {
      const int q = q0 + u * THREADS;
      if (q < ROWS * h4) {
        auto* dst = reinterpret_cast<__nv_bfloat162*>(As + (q / h4) * a_ld + (q % h4) * 4);
        dst[0] = __floats2bfloat162_rn(v[u].x, v[u].y);
        dst[1] = __floats2bfloat162_rn(v[u].z, v[u].w);
      }
    }
  }
  __syncthreads();

  // warp = (depth quarter kq, column tile ct)
  const int ct = warp % (DP / 16);
  const int kq = warp / (DP / 16);
  const int k_len = H / K_SPLIT;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.0f);
#pragma unroll 4
  for (int k = kq * k_len; k < (kq + 1) * k_len; k += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
    wmma::load_matrix_sync(b, Wpost + static_cast<size_t>(k) * DP + ct * 16, DP);
    wmma::load_matrix_sync(a, As + k, a_ld);
    wmma::mma_sync(acc, a, b, acc);
  }
  __syncthreads();  // every warp is done with As: its space takes the partial sums
  wmma::store_matrix_sync(Cs + kq * ROWS * C_LD + ct * 16, acc, C_LD, wmma::mem_row_major);
  __syncthreads();

  const float* cf = coefs + static_cast<size_t>(step) * N_COEFS;
  auto head_out = [&](int r, int c) {
    float v = bpost[c];
#pragma unroll
    for (int s = 0; s < K_SPLIT; ++s) v += Cs[s * ROWS * C_LD + r * C_LD + c];
    return v;
  };
  if (mode == 0) {
    const float cx = cf[0], cout = cf[1], cn = cf[2];
    for (int idx = tid; idx < ROWS * D; idx += THREADS) {
      const int r = idx / D, c = idx % D;
      const int gr = row0 + r;
      if (gr >= B) continue;
      const size_t o = static_cast<size_t>(gr) * D + c;
      const float xm = cx * x[o] + cout * head_out(r, c);
      const float z = dposer::draw_normal(noise, seed, step, slab, gr, c, D);
      if (x_mean != nullptr) x_mean[o] = xm;
      x[o] = xm + cn * z;
    }
  } else {
    const float s = cf[3];
    const int r = warp;  // N_WARPS == ROWS: warp r owns row r
    const int gr = row0 + r;
    if (gr < B) {  // uniform across the warp
      float sq = 0.0f;
      for (int c = lane; c < D; c += 32) {
        const float v = s * head_out(r, c);
        score[static_cast<size_t>(gr) * D + c] = v;
        sq += v * v;
      }
      sq = dposer::warp_sum(sq);
      if (lane == 0) score_sq[gr] = sq;
    }
  }
}

static_assert(N_WARPS == ROWS, "score mode gives each warp one row");
static_assert(K_SPLIT * (DP / 16) == N_WARPS, "warps tile columns x depth");

}  // namespace

// h [B, H] fp32, Wpost [H, 64] bf16 (columns >= D zero), bpost [64] fp32,
// coefs [N, 8] fp32. EM mode: x [B, D] updated in place, x_mean (nullable)
// [B, D]; score mode: score [B, D], score_sq [B]. noise [B, D] (nullable:
// then the normals are drawn in-kernel from seed/step/slab). H must be a
// multiple of 64 and <= 1024, h and Wpost 16-byte aligned; D <= 64.
// Returns cudaGetLastError().
extern "C" int dposer_head_em(const float* h, const void* Wpost, const float* bpost,
                              const float* coefs, int step, int mode, float* x,
                              float* x_mean, float* score, float* score_sq,
                              const float* noise, unsigned long long seed, int slab, int B,
                              int H, int D, void* stream) {
  if (B <= 0 || H % (16 * K_SPLIT) != 0 || H > 1024 || D > DP || D <= 0 ||
      (mode != 0 && mode != 1) || reinterpret_cast<uintptr_t>(h) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(Wpost) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t a_bytes = static_cast<size_t>(ROWS) * (H + 8) * 2;
  const size_t c_bytes = static_cast<size_t>(K_SPLIT) * ROWS * C_LD * sizeof(float);
  const size_t smem = a_bytes > c_bytes ? a_bytes : c_bytes;
  const dim3 grid((B + ROWS - 1) / ROWS);
  head_em_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      h, static_cast<const __nv_bfloat16*>(Wpost), bpost, coefs, step, mode, x, x_mean, score,
      score_sq, noise, seed, slab, B, H, D);
  return static_cast<int>(cudaGetLastError());
}
