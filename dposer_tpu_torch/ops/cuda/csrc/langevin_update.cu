// K3 langevin_update: one langevin corrector step on the whole batch.
//   g = mean_b sqrt(score_sq[b]),  n = mean_b |z_b|,
//   step = 2*alpha*(snr*n/g)^2,    x <- x + step*score + sqrt(2*step)*z
//
// Replaces: the langevin corrector inside the TPU reverse-diffusion kernel,
// dposer_tpu/ops/pallas/fused_em.py::_make_kernel (:176-190), whose
// batch-mean row norms over real rows forced the TPU kernel to widen its
// block to the whole batch (:29-35).
//
// Bound on the H100: ~0.4 MB moved (x read and written, score, score_sq)
// and a few flops per element: bytes bound, ~0.1 us; in practice the
// launch, the single block's two passes and the normal draws set its time.
//
// Design: the step size needs two batch-wide means before any element can
// move, so one block of 1024 threads covers the [B, D] batch (B = 500 at
// the flagship). Threads walk groups of four columns of a row. Pass 1 draws
// each group's normals (one Philox call gives four) and adds its |z|^2 to
// the row's sum in shared memory; the row norms of score and z are then
// reduced over the block. Pass 2 redraws the same groups from their counters
// instead of storing them, and applies the update.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int N_COEFS = 8;

__device__ __forceinline__ float4 group_normals(const float* __restrict__ noise,
                                                unsigned long long seed, int step, int slab,
                                                int row, int col0, int D) {
  if (noise == nullptr) return dposer::philox_normal4(seed, step, slab, row, col0);
  const float* p = noise + static_cast<size_t>(row) * D + col0;
  return make_float4(p[0], col0 + 1 < D ? p[1] : 0.0f, col0 + 2 < D ? p[2] : 0.0f,
                     col0 + 3 < D ? p[3] : 0.0f);
}

__global__ void __launch_bounds__(THREADS)
langevin_update_kernel(float* x, const float* __restrict__ score,
                       const float* __restrict__ score_sq, const float* __restrict__ coefs,
                       int step, float snr, const float* __restrict__ noise,
                       unsigned long long seed, int slab, float* step_out, int B, int D) {
  extern __shared__ float row_zsq[];  // [B]
  __shared__ float red_g[THREADS / 32];
  __shared__ float red_z[THREADS / 32];
  __shared__ float s_step;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int groups = (D + 3) / 4;  // four-column groups per row

  for (int r = tid; r < B; r += THREADS) row_zsq[r] = 0.0f;
  __syncthreads();
  for (int q = tid; q < B * groups; q += THREADS) {
    const int r = q / groups, c0 = (q % groups) * 4;
    const float4 z = group_normals(noise, seed, step, slab, r, c0, D);
    float zz = z.x * z.x;
    if (c0 + 1 < D) zz += z.y * z.y;
    if (c0 + 2 < D) zz += z.z * z.z;
    if (c0 + 3 < D) zz += z.w * z.w;
    atomicAdd(&row_zsq[r], zz);
  }
  __syncthreads();

  float g = 0.0f, zn = 0.0f;
  for (int r = tid; r < B; r += THREADS) {
    g += sqrtf(score_sq[r]);
    zn += sqrtf(row_zsq[r]);
  }
  g = dposer::warp_sum(g);
  zn = dposer::warp_sum(zn);
  if (lane == 0) {
    red_g[warp] = g;
    red_z[warp] = zn;
  }
  __syncthreads();
  if (warp == 0) {
    g = dposer::warp_sum(red_g[lane]);
    zn = dposer::warp_sum(red_z[lane]);
    if (lane == 0) {
      const float ratio = snr * (zn / B) / (g / B);
      const float st = ratio * ratio * 2.0f * coefs[static_cast<size_t>(step) * N_COEFS + 4];
      s_step = st;
      if (step_out != nullptr) *step_out = st;
    }
  }
  __syncthreads();

  const float st = s_step;
  const float amp = sqrtf(2.0f * st);
  for (int q = tid; q < B * groups; q += THREADS) {
    const int r = q / groups, c0 = (q % groups) * 4;
    const float4 z = group_normals(noise, seed, step, slab, r, c0, D);
    const float zs[4] = {z.x, z.y, z.z, z.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (c0 + u < D) {
        const size_t o = static_cast<size_t>(r) * D + c0 + u;
        x[o] = x[o] + st * score[o] + amp * zs[u];
      }
    }
  }
}

}  // namespace

// x [B, D] fp32 updated in place; score [B, D], score_sq [B] from head_em's
// score mode; coefs [N, 8] (column 4: alpha); noise [B, D] (nullable: drawn
// in-kernel from seed/step/slab); step_out (nullable) receives the step
// size. B <= 12288. Returns cudaGetLastError().
extern "C" int dposer_langevin_update(float* x, const float* score, const float* score_sq,
                                      const float* coefs, int step, float snr,
                                      const float* noise, unsigned long long seed, int slab,
                                      float* step_out, int B, int D, void* stream) {
  if (B <= 0 || D <= 0 || B > 12288) return static_cast<int>(cudaErrorInvalidValue);
  langevin_update_kernel<<<1, THREADS, B * sizeof(float), static_cast<cudaStream_t>(stream)>>>(
      x, score, score_sq, coefs, step, snr, noise, seed, slab, step_out, B, D);
  return static_cast<int>(cudaGetLastError());
}
