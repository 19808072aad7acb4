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
// Design: the head itself is head_gemm.cuh's block tile (16 rows x 64 padded
// columns, bf16 WMMA, partial sums in shared memory). The update runs in the
// epilogue, so out never goes to device memory; in score mode warp r owns row
// r and reduces its norm with shuffles. The step's scalars are read from the
// device coefficient table, so the host loop never synchronizes.

#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"
#include "head_gemm.cuh"

namespace {

using namespace dposer::head;

constexpr int N_COEFS = 8;  // cx, cout, cnoise, score_scale, alpha, (imputation x2), pad

__global__ void __launch_bounds__(THREADS)
head_em_kernel(const float* __restrict__ h, const __nv_bfloat16* __restrict__ Wpost,
               const float* __restrict__ bpost, const float* __restrict__ coefs, int step,
               int mode, float* x, float* x_mean, float* score, float* score_sq,
               const float* __restrict__ noise, unsigned long long seed, int slab, int B,
               int H, int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = blockIdx.x * ROWS;
  const float* Cs = gemm_tile(h, Wpost, smem, row0, B, H);

  const float* cf = coefs + static_cast<size_t>(step) * N_COEFS;
  auto head_out = [&](int r, int c) { return out_at(Cs, bpost, r, c); };
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
  if (!operands_ok(h, Wpost, B, H, D) || (mode != 0 && mode != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  head_em_kernel<<<grid_blocks(B), THREADS, smem_bytes(H), static_cast<cudaStream_t>(stream)>>>(
      h, static_cast<const __nv_bfloat16*>(Wpost), bpost, coefs, step, mode, x, x_mean, score,
      score_sq, noise, seed, slab, B, H, D);
  return static_cast<int>(cudaGetLastError());
}
