// K11 head_dsm: the score network's output head and the DSM loss seed,
//   out      = bf16(h) @ Wpost + bpost
//   r        = a * out + v * z            (per-row coefficients a, v, s)
//   loss_row = s * sum_c r^2,   dout = 2 * s * a * r
//
// Replaces: the post-dense, the loss and the adjoint seed of the TPU train
// kernel, dposer_tpu/ops/pallas/fused_train.py::_make_kernel (:177-188). The
// wrapper folds the score scaling, the reduce mode and the likelihood
// weighting into (a, v, s) as the JAX wrapper does (:456-469).
//
// Bound on the H100: [1280, 1024] x [1024, 63] is 0.17 GFLOP (~0.2 us of bf16
// tensor-core time) against ~6 MB moved (h fp32 5.2 MB, z and dout): bytes
// bound, ~1.8 us.
//
// Design: head_gemm.cuh's block tile (16 rows x 64 padded columns, bf16 WMMA,
// partial sums in shared memory), as K2, K6 and K8. Warp r owns row r: it
// forms the residual, writes dout and reduces the row's loss with shuffles,
// so the head's output never goes to device memory. The batch sum of the
// per-row losses is one torch.sum, in a fixed order.

#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"
#include "head_gemm.cuh"

namespace {

using namespace dposer::head;

__global__ void __launch_bounds__(THREADS)
head_dsm_kernel(const float* __restrict__ h, const __nv_bfloat16* __restrict__ Wpost,
                const float* __restrict__ bpost, const float* __restrict__ coefs,
                const float* __restrict__ z, float* __restrict__ loss_rows,
                float* __restrict__ dout, int B, int H, int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * ROWS;
  const float* Cs = gemm_tile(h, Wpost, smem, row0, B, H);

  const int gr = row0 + warp;  // N_WARPS == ROWS: warp r owns row r
  if (gr >= B) return;         // uniform across the warp
  const float a = coefs[gr * 3 + 0], v = coefs[gr * 3 + 1], s = coefs[gr * 3 + 2];
  float sq = 0.0f;
  for (int c = lane; c < D; c += 32) {
    const size_t o = static_cast<size_t>(gr) * D + c;
    const float r = a * out_at(Cs, bpost, warp, c) + v * z[o];
    sq += r * r;
    dout[o] = 2.0f * s * a * r;
  }
  sq = dposer::warp_sum(sq);
  if (lane == 0) loss_rows[gr] = s * sq;
}

static_assert(N_WARPS == ROWS, "each warp owns one row");

}  // namespace

// h [B, H] fp32, Wpost [H, 64] bf16 (columns >= D zero), bpost [64] fp32,
// coefs [B, 3] fp32 (a, v, s), z [B, D] fp32; writes loss_rows [B] and dout
// [B, D] fp32. H must be a multiple of 64 and <= 1024, h and Wpost 16-byte
// aligned; D <= 64. Returns cudaGetLastError().
extern "C" int dposer_head_dsm(const float* h, const void* Wpost, const float* bpost,
                               const float* coefs, const float* z, float* loss_rows, float* dout,
                               int B, int H, int D, void* stream) {
  if (!operands_ok(h, Wpost, B, H, D)) return static_cast<int>(cudaErrorInvalidValue);
  head_dsm_kernel<<<grid_blocks(B), THREADS, smem_bytes(H), static_cast<cudaStream_t>(stream)>>>(
      h, static_cast<const __nv_bfloat16*>(Wpost), bpost, coefs, z, loss_rows, dout, B, H, D);
  return static_cast<int>(cudaGetLastError());
}
