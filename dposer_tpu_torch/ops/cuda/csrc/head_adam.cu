// K6 head_adam: raw = bf16(h) @ Wpost + bpost, then one Adam step of pose
// completion on the accumulator tile, all in place:
//   x0_hat = ca*pert + cb*raw                    (one-step denoise, detached)
//   g      = cd*m*(x - obs) + cp*(x - x0_hat)    (masked data + prior gradient)
//   m1 <- 0.9*m1 + 0.1*g;  v <- 0.999*v + 0.001*g*g
//   x  <- x - clr * m1 / (sqrt(v*cv) + 1e-8)
// and, on the solver's last step (paste != 0), x <- obs*m + x*(1-m).
//
// Replaces: the body of the Adam loop of the TPU completion kernel after the
// network's hidden layers, dposer_tpu/ops/pallas/fused_comp.py::_make_kernel
// (:118-127, and the final paste :131); the hidden layers are K1's. The
// step's scalars ca, cb, cd, cp, clr, cv are columns 2..7 of its row of
// coefs [T, 8]; clr and cv fold Adam's bias corrections.
//
// Bound on the H100: [1000, 1024] x [1024, 63] is 129 MFLOP (~0.13 us of
// bf16 tensor-core time) against ~5.9 MB moved (h fp32 read once; x, m1 and v
// read and written; pert, obs and mask read): bytes bound, ~1.8 us.
//
// Design: the head is head_gemm.cuh's block tile (16 rows x 64 padded
// columns a block, bf16 WMMA, fp32 partial sums in shared memory); K2, K8,
// K9 and K11 run head_cluster.cuh instead. The Adam step is the epilogue over the tile's [16, D]
// elements, so the head's output and the gradient never go to device memory.
// v*cv stays under the square root, as the TPU kernel and optax have it.

#include <cstdint>

#include <cuda_runtime.h>

#include "head_gemm.cuh"

namespace {

using namespace dposer::head;

constexpr int N_COEFS = 8;  // c_m, c_s, ca, cb, cd, cp, clr, cv
// 1 - b1 and 1 - b2 as fp32 roundings of the exact values, not of 1 - fp32(b):
// 1 - 0.999f is off by 1.3e-5 relative
constexpr float ADAM_B1 = 0.9f, ADAM_1MB1 = 0.1f, ADAM_B2 = 0.999f, ADAM_1MB2 = 0.001f;
constexpr float ADAM_EPS = 1e-8f;

__global__ void __launch_bounds__(THREADS)
head_adam_kernel(const float* __restrict__ h, const __nv_bfloat16* __restrict__ Wpost,
                 const float* __restrict__ bpost, const float* __restrict__ coefs, int step,
                 float* x, const float* __restrict__ pert, const float* __restrict__ obs,
                 const float* __restrict__ mask, float* m1, float* v, int paste, int B, int H,
                 int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int row0 = blockIdx.x * ROWS;
  const float* Cs = gemm_tile(h, Wpost, smem, row0, B, H);

  const float* cf = coefs + static_cast<size_t>(step) * N_COEFS;
  const float ca = cf[2], cb = cf[3], cd = cf[4], cp = cf[5], clr = cf[6], cv = cf[7];
  for (int idx = threadIdx.x; idx < ROWS * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    const int gr = row0 + r;
    if (gr >= B) continue;
    const size_t o = static_cast<size_t>(gr) * D + c;
    const float xo = x[o], ob = obs[o], mk = mask[o];
    const float x0_hat = ca * pert[o] + cb * out_at(Cs, bpost, r, c);
    const float g = cd * (mk * (xo - ob)) + cp * (xo - x0_hat);
    const float mo = ADAM_B1 * m1[o] + ADAM_1MB1 * g;
    const float vo = ADAM_B2 * v[o] + ADAM_1MB2 * (g * g);
    m1[o] = mo;
    v[o] = vo;
    const float xn = xo - clr * mo / (sqrtf(vo * cv) + ADAM_EPS);
    x[o] = paste ? ob * mk + xn * (1.0f - mk) : xn;
  }
}

}  // namespace

// h [B, H] fp32, Wpost [H, 64] bf16 (columns >= D zero), bpost [64] fp32,
// coefs [T, 8] fp32; x, m1, v [B, D] updated in place; pert, obs, mask
// [B, D]. H a multiple of 64 and <= 1024, h and Wpost 16-byte aligned,
// D <= 64. Returns cudaGetLastError().
extern "C" int dposer_head_adam(const float* h, const void* Wpost, const float* bpost,
                                const float* coefs, int step, float* x, const float* pert,
                                const float* obs, const float* mask, float* m1, float* v,
                                int paste, int B, int H, int D, void* stream) {
  if (!operands_ok(h, Wpost, B, H, D)) return static_cast<int>(cudaErrorInvalidValue);
  head_adam_kernel<<<grid_blocks(B), THREADS, smem_bytes(H), static_cast<cudaStream_t>(stream)>>>(
      h, static_cast<const __nv_bfloat16*>(Wpost), bpost, coefs, step, x, pert, obs, mask, m1, v,
      paste, B, H, D);
  return static_cast<int>(cudaGetLastError());
}
