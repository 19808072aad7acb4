// The two elementwise passes of pose completion over a [R, D] pose state.
//
// K4 masked_renoise: x <- x*(1-m) + (mc*obs + sd*z)*m, in place.
//   Replaces: the masked re-noise and overwrite of the observed dims before
//   and after the predictor inside the TPU reverse-diffusion kernel,
//   dposer_tpu/ops/pallas/fused_em.py::_make_kernel (:192-197, :208-211).
//   mc and sd are columns 5 and 6 of the step's row of coefs [N, 8]. K2's
//   imputation epilogue (head_em.cu) runs the same re-noise after the EM
//   update, and the next step's before its predictor, where no corrector
//   comes between; K4 runs it at a call's first step and after the
//   langevin corrector (K3).
// K5 comp_perturb: pert <- c_m*x + c_s*z, into a second buffer (x is needed
//   again by K6 head_adam).
//   Replaces: the marginal perturbation that opens every Adam step of the TPU
//   completion kernel, dposer_tpu/ops/pallas/fused_comp.py::_make_kernel
//   (:116-117). c_m and c_s are columns 0 and 1 of the step's row of its
//   coefs [T, 8]. K6's perturbing instantiation (head_adam.cu) writes every
//   later step's perturbation from the new x in its epilogue; K5 runs at a
//   solve's first step.
//
// z is the host slab noise [R, D] or, when that is null, the Philox normal
// keyed by (seed, step, slab, row, column): the same stream K2 and K3 draw
// from, so a slab index of its own keeps each draw apart from theirs. The
// seed is read from device memory (a broadcast load a warp, before the
// draw), so a CUDA graph that captured the launch draws with the seed
// written before each replay.
//
// Bound on the H100: at [1000, 63] K4 moves 4 arrays (x read and written,
// obs, mask; 1.0 MB) and K5 2 (0.5 MB), with a few flops and one Box-Muller
// draw (~110 fp32 operations) per element: bytes bound in host-noise mode,
// ~0.3 us and ~0.15 us; with in-kernel normals the draws' ~7 MFLOP are under
// that too. Either is far below the cost of a launch.
//
// Design: one thread per element, 256 threads a block, the step's scalars
// read from the device table so the host loop never synchronizes. Nothing is
// staged: every byte is touched once. K4's and K5's arithmetic is common.cuh's
// masked_renoise and comp_perturb, which round each operation on their own.
// K5 opens a solve's chain of programmatic launches (mbarrier.cuh): it loads
// the step's scalars and draws its in-kernel normal before its wait for the
// launches before it, then reads x; K4 is a plain stream launch.

#include <cuda_runtime.h>

#include "common.cuh"
#include "mbarrier.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int N_COEFS = 8;

__global__ void __launch_bounds__(THREADS)
masked_renoise_kernel(float* x, const float* __restrict__ obs, const float* __restrict__ mask,
                      const float* __restrict__ coefs, int step,
                      const float* __restrict__ noise, const unsigned long long* __restrict__ seed,
                      int slab, int R, int D) {
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= R * D) return;
  const float* cf = coefs + static_cast<size_t>(step) * N_COEFS;
  const float z = dposer::draw_normal(noise, dposer::load_seed(seed), step, slab, idx / D,
                                      idx % D, D);
  x[idx] = dposer::masked_renoise(x[idx], mask[idx], obs[idx], cf[5], cf[6], z);
}

__global__ void __launch_bounds__(THREADS)
comp_perturb_kernel(const float* x, float* pert, const float* __restrict__ coefs, int step,
                    const float* noise, const unsigned long long* __restrict__ seed, int slab,
                    int R, int D) {
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= R * D) return;
  const float* cf = coefs + static_cast<size_t>(step) * N_COEFS;
  const float cm = cf[0], cs = cf[1];
  float z = noise == nullptr
                ? dposer::philox_normal(dposer::load_seed(seed), step, slab, idx / D, idx % D)
                : 0.0f;
  dposer::Programmatic{}();  // x is the state the launches before this one left
  if (noise != nullptr) z = noise[idx];
  pert[idx] = dposer::comp_perturb(cm, x[idx], cs, z);
}

inline int blocks_for(int R, int D) { return (R * D + THREADS - 1) / THREADS; }

}  // namespace

// x [R, D] fp32 updated in place; obs, mask [R, D]; coefs [N, 8] (columns 5,
// 6: the imputation mean coefficient and std); noise [R, D] (nullable: then
// drawn in-kernel from *seed/step/slab, seed in device memory; null with
// noise). Returns cudaGetLastError().
extern "C" int dposer_masked_renoise(float* x, const float* obs, const float* mask,
                                     const float* coefs, int step, const float* noise,
                                     const unsigned long long* seed, int slab, int R, int D,
                                     void* stream) {
  if (R <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  masked_renoise_kernel<<<blocks_for(R, D), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, obs, mask, coefs, step, noise, seed, slab, R, D);
  return static_cast<int>(cudaGetLastError());
}

// x [R, D] fp32 read, pert [R, D] written (not x itself); coefs [T, 8]
// (columns 0, 1: c_m, c_s); noise [R, D] (nullable: drawn in-kernel from
// *seed, as dposer_masked_renoise). A programmatic launch: coefs and *seed
// are read before its wait for the launch before it on the stream, so that
// launch must not write them. Returns the launch's error or
// cudaGetLastError().
extern "C" int dposer_comp_perturb(const float* x, float* pert, const float* coefs, int step,
                                   const float* noise, const unsigned long long* seed, int slab,
                                   int R, int D, void* stream) {
  if (R <= 0 || D <= 0 || x == pert) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = dposer::launch_programmatic(
      comp_perturb_kernel, dim3(blocks_for(R, D)), THREADS, 0, static_cast<cudaStream_t>(stream),
      x, pert, coefs, step, noise, seed, slab, R, D);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
