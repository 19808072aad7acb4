// K8 head_rk4 and K9 head_rk4_jvp: out = bf16(h) @ Wpost + bpost, then one
// stage of the fixed-grid RK4 integration of the probability-flow ODE
//   dx/dt = a1(t) * x + a2(t) * out(x, t)
// on the accumulator tile. With k = a1*xs + a2*out at the stage's state xs:
//   stage 0: acc = k;       xs = x + h/2 * k
//   stage 1: acc += 2k;     xs = x + h/2 * k
//   stage 2: acc += 2k;     xs = x + h * k
//   stage 3: x += h/6 * (acc + k);  xs = x
//   stage 4 (K8 only, the final denoise): x = cdx*x + cdo*out
// K9 also carries the log-density change of the likelihood: with
// dout = bf16(dh) @ Wpost, the tangent of out along the Hutchinson probe e,
//   kl = a1 * sum_c(e^2) + a2 * sum_c(dout * e)
// goes through the same four stages into lp [B] with its accumulator lacc [B].
//
// Replaces: fwd's post-dense and the RK4 step of the TPU PF-ODE sampler,
// dposer_tpu/ops/pallas/fused_ode.py::_make_kernel (:87-96, denoise :101-107),
// and, for K9, fwd_jvp's post-dense pair, rhs and the RK4 step of the TPU
// likelihood kernel, dposer_tpu/ops/pallas/fused_lik.py::_make_kernel
// (:75-79, :91-102). The TPU kernels run the whole integration as one program;
// here a stage is the hidden layers' launches and this one.
//
// Bound on the H100: K8 at [500, 1024] x [1024, 63] is 64.5 MFLOP (~0.07 us of
// bf16 tensor-core time) against ~2.8 MB moved (h fp32 read once; x read, xs
// and acc read and written): bytes bound, ~0.8 us. K9 at [50, 1024] pair is
// 12.9 MFLOP against ~0.6 MB (h and dh; Wpost 0.13 MB): bytes bound, ~0.2 us.
//
// Design: the head is head_gemm.cuh's block tile (16 rows x 64 padded columns,
// bf16 WMMA, partial sums in shared memory); K9 runs it twice through the one
// staging buffer, for h and for dh. The RK4 bookkeeping is the epilogue over
// the tile's [16, D] elements, so neither out nor k reaches device memory. A
// tile holds whole rows, so in K9 warp r owns row r and reduces its two row
// sums with shuffles. The grid point's scalars (a1, a2, h, cdx, cdo) are read
// from the device table coefs [G, 8] at row j, so the host loop never
// synchronizes.

#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"
#include "head_gemm.cuh"

namespace {

using namespace dposer::head;

constexpr int N_COEFS = 8;  // a1, a2, h, cdx, cdo, pad x3
constexpr int DENOISE = 4;

// One RK4 stage on a state element: x (the step's start), its accumulator and
// the slope k at the stage's state. Returns the next stage's state.
__device__ __forceinline__ float rk4_stage(int stage, float hstep, float k, float& x,
                                           float& acc) {
  switch (stage) {
    case 0: acc = k; return x + (0.5f * hstep) * k;
    case 1: acc += 2.0f * k; return x + (0.5f * hstep) * k;
    case 2: acc += 2.0f * k; return x + hstep * k;
    default: x += (hstep / 6.0f) * (acc + k); return x;
  }
}

template <bool JVP>
__global__ void __launch_bounds__(THREADS)
head_rk4_kernel(const float* __restrict__ h, const float* __restrict__ dh,
                const __nv_bfloat16* __restrict__ Wpost, const float* __restrict__ bpost,
                const float* __restrict__ coefs, int j, int stage, float* x, float* xs,
                float* acc, const float* __restrict__ eps, float* lp, float* lacc, int B, int H,
                int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * ROWS;
  const float* Cs = JVP ? gemm_tile_pair(h, dh, Wpost, smem, row0, B, H)
                        : gemm_tile(h, Wpost, smem, row0, B, H);

  const float* cf = coefs + static_cast<size_t>(j) * N_COEFS;
  const float a1 = cf[0], a2 = cf[1], hstep = cf[2];
  for (int idx = tid; idx < ROWS * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    const int gr = row0 + r;
    if (gr >= B) continue;
    const size_t o = static_cast<size_t>(gr) * D + c;
    const float out = out_at(Cs, bpost, r, c);
    if (stage == DENOISE) {
      x[o] = cf[3] * x[o] + cf[4] * out;
      continue;
    }
    float xo = x[o], ao = stage == 0 ? 0.0f : acc[o];
    const float k = a1 * xs[o] + a2 * out;
    xs[o] = rk4_stage(stage, hstep, k, xo, ao);
    if (stage == 3)
      x[o] = xo;
    else
      acc[o] = ao;
  }

  if constexpr (JVP) {
    const int warp = tid / 32, lane = tid % 32;
    const int r = warp;  // N_WARPS == ROWS: warp r owns row r
    const int gr = row0 + r;
    if (gr < B) {  // uniform across the warp
      float dot = 0.0f, ee = 0.0f;
      for (int c = lane; c < D; c += 32) {
        const float e = eps[static_cast<size_t>(gr) * D + c];
        dot += tangent_at(Cs, r, c) * e;
        ee += e * e;
      }
      dot = dposer::warp_sum(dot);
      ee = dposer::warp_sum(ee);
      if (lane == 0) {
        float lo = lp[gr], ao = stage == 0 ? 0.0f : lacc[gr];
        rk4_stage(stage, hstep, a1 * ee + a2 * dot, lo, ao);
        if (stage == 3)
          lp[gr] = lo;
        else
          lacc[gr] = ao;
      }
    }
  }
}

static_assert(N_WARPS == ROWS, "the tangent's row sums give each warp one row");

}  // namespace

// K8. h [B, H] fp32, Wpost [H, 64] bf16 (columns >= D zero), bpost [64] fp32,
// coefs [G, 8] fp32 read at row j; x, xs, acc [B, D] updated in place as the
// stage (0..3, or 4 for the denoise, which touches x only) says. H a multiple
// of 64 and <= 1024, h and Wpost 16-byte aligned, D <= 64. Returns
// cudaGetLastError().
extern "C" int dposer_head_rk4(const float* h, const void* Wpost, const float* bpost,
                               const float* coefs, int j, int stage, float* x, float* xs,
                               float* acc, int B, int H, int D, void* stream) {
  if (!operands_ok(h, Wpost, B, H, D) || stage < 0 || stage > DENOISE)
    return static_cast<int>(cudaErrorInvalidValue);
  head_rk4_kernel<false>
      <<<grid_blocks(B), THREADS, smem_bytes(H), static_cast<cudaStream_t>(stream)>>>(
          h, nullptr, static_cast<const __nv_bfloat16*>(Wpost), bpost, coefs, j, stage, x, xs,
          acc, nullptr, nullptr, nullptr, B, H, D);
  return static_cast<int>(cudaGetLastError());
}

// K9. As K8 (stages 0..3), with the tangent dh [B, H] fp32 (16-byte aligned),
// the probe eps [B, D], and lp, lacc [B] updated in place.
extern "C" int dposer_head_rk4_jvp(const float* h, const float* dh, const void* Wpost,
                                   const float* bpost, const float* coefs, int j, int stage,
                                   float* x, float* xs, float* acc, const float* eps, float* lp,
                                   float* lacc, int B, int H, int D, void* stream) {
  if (!operands_ok(h, Wpost, B, H, D) || reinterpret_cast<uintptr_t>(dh) % 16 != 0 ||
      stage < 0 || stage >= DENOISE)
    return static_cast<int>(cudaErrorInvalidValue);
  head_rk4_kernel<true>
      <<<grid_blocks(B), THREADS, smem_bytes_pair(H), static_cast<cudaStream_t>(stream)>>>(
          h, dh, static_cast<const __nv_bfloat16*>(Wpost), bpost, coefs, j, stage, x, xs, acc,
          eps, lp, lacc, B, H, D);
  return static_cast<int>(cudaGetLastError());
}
