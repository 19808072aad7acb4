// K2 head_em: out = bf16(h) @ Wpost + bpost, then the step's update.
//   EM mode (0):    x_mean = cx*x + cout*out; x <- x_mean + cn*z
//                   (x_mean also written when requested: the denoised result)
//   score mode (1): score = s*out and per-row |score|^2, for the corrector
//   imputation (head_em_impute_kernel, EM mode): after the update, the masked
//                   re-noise of the observed dims, x <- x*(1-m) + (mc*obs +
//                   sd*z)*m, with the step's coefficients and, as a second
//                   pass, with the next step's (its re-noise before its
//                   predictor, where no corrector comes between): what K4
//                   after K2 did, bit for bit (common.cuh::masked_renoise)
//
// Replaces: the output head and the EM update inside the TPU
// reverse-diffusion kernel, dposer_tpu/ops/pallas/fused_em.py::_make_kernel
// (fwd's post-dense, :199-206) and the corrector's score (:178), with the
// on-core Box-Muller draw (score_net.py::box_muller) replaced by Philox; the
// imputation instantiation also the masked re-noise after the predictor
// (:208-211) and the next step's before it (:192-197).
//
// Bound on the H100: [500, 1024] x [1024, 63] is 64.5 MFLOP (~0.07 us of
// bf16 tensor-core time) against ~2.4 MB moved (h fp32 read once, x read and
// written): bytes bound, ~0.7 us.
//
// Design: the head is head_cluster.cuh's split-K over a cluster of 4 CTAs a
// 16-row tile (128 CTAs at 500 rows), its partials pushed through
// distributed shared memory (st.async onto the receiver's mbarrier) to the
// CTA that finishes their rows and summed there in a fixed order. The update
// runs in that epilogue, so out never goes to device memory: the CTA of rank
// q finishes rows 4q .. 4q+3 of its tile, its epilogue warp 4 + e row
// 4q + e, each lane columns lane and lane + 32; in score mode the warp
// reduces the row's norm with shuffles. The epilogue warps load x, the bias
// and the step's scalars and draw the normals while the head's copies fly
// (at 500 rows 6 MB from L2, two thirds of it the 32 KB Wpost slice each
// CTA reads) and the MMA warps wait for them. The
// step's scalars are read from the device coefficient table, so the host
// loop never synchronizes. In-kernel normals are philox_normal(seed, step,
// slab, row, col), one Philox call an element, as in every earlier version;
// the seed is read from device memory (each epilogue warp loads it once,
// before its draws), so a CUDA graph that captured the launch draws with the
// seed written before each replay. The imputation instantiation also loads
// the row's obs and mask and draws each pass's normals (step + p, its slab)
// while the copies fly; x_mean stays the state before the re-noise.
// Both instantiations are programmatic launches (mbarrier.cuh): warp 0 sets
// the barriers up and starts Wpost's box under the tail of the launch before
// it (the last hidden layer), waits for it and starts h's copies; the
// epilogue warps wait first, then load and draw while the copies fly, as
// before. (Their loads and draws overlap the copies and the MMAs either way;
// moving them before the wait changed the bits of K6's Adam step, whose
// epilogue is built the same way: head_adam.cu.)
// head_em_kernel is the body without it, so modes 0 and 1 compile as they
// would if the imputation did not exist (chip_smoke.py holds its SASS to a
// recorded digest).

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "head_cluster.cuh"

namespace {

using namespace dposer::head_cluster;

using T = Tile<4>;  // 16 poses a tile, 4 CTAs a cluster

constexpr int N_COEFS = 8;  // cx, cout, cnoise, score_scale, alpha, (imputation x2), pad

// The masked re-noise after the EM update of the imputation instantiation:
// pass p (p < passes) re-noises with row step + p of coefs and the normals
// noise[p] (host, [B, D]) or, where that is null, the draw (seed, step + p,
// slab[p], row, col): K4's at that step and slab.
struct Renoise {
  const float* obs;
  const float* mask;
  const float* noise[2];
  int slab[2];
  int passes;
};

template <bool IMPUTE>
__device__ __forceinline__ void head_em_body(const float* __restrict__ h, const CUtensorMap& tmW,
                                             const float* __restrict__ bpost,
                                             const float* __restrict__ coefs, int step, int mode,
                                             float* x, float* x_mean, float* score,
                                             float* score_sq, const float* noise,
                                             const unsigned long long* __restrict__ seed_ptr,
                                             int slab, int B, int H, int D,
                                             const Renoise& rn) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout<T> L(smem, H);
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int row0 = (blockIdx.x / T::SPLIT) * ROWS;
  start_copies<T, dposer::Programmatic>(h, nullptr, &tmW, L, row0, rank, B, H);
  cluster_arrive_relaxed();  // the barriers are set up; waited on before the first push
  __syncthreads();  // the barriers are initialized, the zeroed rows written
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp < MMA_WARPS) {
    send_partials<T>(L, rank, H);
    return;
  }

  // The epilogue warps: warp MMA_WARPS + e finishes row rank * ROWS_PER_CTA
  // + e of the tile, each lane columns lane and lane + 32. Once the launches
  // before this one are done, while the copies fly, it loads the seed, x,
  // the bias and the step's scalars and draws the normals.
  dposer::grid_dependency_wait();
  const unsigned long long seed = dposer::load_seed(seed_ptr);
  const int e = warp - MMA_WARPS;
  const int r = rank * T::ROWS_PER_CTA + e;
  const int gr = row0 + r;
  const bool has_row = e < T::ROWS_PER_CTA && gr < B;  // uniform across the warp
  const float* cf = coefs + static_cast<size_t>(step) * N_COEFS;
  float cx = 0.0f, cout = 0.0f, cn = 0.0f, s = 0.0f;
  float bias[2] = {0.0f, 0.0f}, xin[2] = {0.0f, 0.0f}, z[2] = {0.0f, 0.0f};
  // the imputation's operands: obs, mask, and each pass's coefficients and normals
  float ob[2] = {}, mk[2] = {}, mc[2] = {}, sd[2] = {}, zr[2][2] = {};
  if constexpr (IMPUTE) {
    if (has_row) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        if (p >= rn.passes) continue;
        mc[p] = cf[p * N_COEFS + 5];
        sd[p] = cf[p * N_COEFS + 6];
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c = lane + 32 * u;
        if (c >= D) continue;
        const size_t o = static_cast<size_t>(gr) * D + c;
        ob[u] = rn.obs[o];
        mk[u] = rn.mask[o];
#pragma unroll
        for (int p = 0; p < 2; ++p)
          if (p < rn.passes)
            zr[p][u] = dposer::draw_normal(rn.noise[p], seed, step + p, rn.slab[p], gr, c, D);
      }
    }
  }
  if (has_row) {
    if (mode == 0) {
      cx = cf[0];
      cout = cf[1];
      cn = cf[2];
    } else {
      s = cf[3];
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = lane + 32 * u;
      if (c >= D) continue;
      bias[u] = bpost[c];
      if (mode != 0) continue;
      xin[u] = x[static_cast<size_t>(gr) * D + c];
      z[u] = dposer::draw_normal(noise, seed, step, slab, gr, c, D);
    }
  }
  wait_partials<T>(L);  // every epilogue warp waits: peers push into this CTA until then

  if (has_row) {
    float v[2] = {0.0f, 0.0f};  // out at columns lane, lane + 32
#pragma unroll
    for (int u = 0; u < 2; ++u)
      if (lane + 32 * u < D) v[u] = out_at<T>(L, bias[u], e, lane + 32 * u);
    if (mode == 0) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c = lane + 32 * u;
        if (c >= D) continue;
        const size_t o = static_cast<size_t>(gr) * D + c;
        const float xm = cx * xin[u] + cout * v[u];
        if (x_mean != nullptr) x_mean[o] = xm;
        float xn = xm + cn * z[u];
        if constexpr (IMPUTE) {
#pragma unroll
          for (int p = 0; p < 2; ++p)
            if (p < rn.passes)
              xn = dposer::masked_renoise(xn, mk[u], ob[u], mc[p], sd[p], zr[p][u]);
        }
        x[o] = xn;
      }
    } else {
      float sq = 0.0f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c = lane + 32 * u;
        if (c >= D) continue;
        const float val = s * v[u];
        score[static_cast<size_t>(gr) * D + c] = val;
        sq += val * val;
      }
      sq = dposer::warp_sum(sq);
      if (lane == 0) score_sq[gr] = sq;
    }
  }
}

__global__ void __cluster_dims__(T::SPLIT, 1, 1) __launch_bounds__(THREADS)
head_em_kernel(const float* __restrict__ h, const __grid_constant__ CUtensorMap tmW,
               const float* __restrict__ bpost, const float* __restrict__ coefs, int step,
               int mode, float* x, float* x_mean, float* score, float* score_sq,
               const float* noise, const unsigned long long* __restrict__ seed,
               int slab, int B, int H, int D) {
  head_em_body<false>(h, tmW, bpost, coefs, step, mode, x, x_mean, score, score_sq, noise, seed,
                      slab, B, H, D, Renoise{});
}

__global__ void __cluster_dims__(T::SPLIT, 1, 1) __launch_bounds__(THREADS)
head_em_impute_kernel(const float* __restrict__ h, const __grid_constant__ CUtensorMap tmW,
                      const float* __restrict__ bpost, const float* __restrict__ coefs, int step,
                      float* x, float* x_mean, const float* noise,
                      const unsigned long long* __restrict__ seed, int slab, int B, int H,
                      int D,
                      const __grid_constant__ Renoise rn) {
  head_em_body<true>(h, tmW, bpost, coefs, step, 0, x, x_mean, nullptr, nullptr, noise, seed,
                     slab, B, H, D, rn);
}

// More than 48 KB of dynamic shared memory a CTA, allowed once a kernel.
template <class Kernel>
cudaError_t allow_smem_of(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_bytes<T>(1024)));
}

cudaError_t allow_smem() {
  static const cudaError_t attr = allow_smem_of(head_em_kernel);
  return attr;
}

cudaError_t allow_smem_impute() {
  static const cudaError_t attr = allow_smem_of(head_em_impute_kernel);
  return attr;
}

}  // namespace

// h [B, H] fp32, Wpost [H, 64] bf16 (columns >= D zero), bpost [64] fp32,
// coefs [N, 8] fp32. EM mode: x [B, D] updated in place, x_mean (nullable)
// [B, D]; score mode: score [B, D], score_sq [B]. noise [B, D] (nullable:
// then the normals are drawn in-kernel from *seed/step/slab: seed points to
// device memory, and may be null with noise). H must be a
// multiple of 64 and <= 1024, h and Wpost 16-byte aligned; D <= 64. A
// programmatic launch: Wpost is read before its wait for the launch before
// it on the stream, so that launch must not write it. Returns the launch's
// error or cudaGetLastError().
extern "C" int dposer_head_em(const float* h, const void* Wpost, const float* bpost,
                              const float* coefs, int step, int mode, float* x,
                              float* x_mean, float* score, float* score_sq,
                              const float* noise, const unsigned long long* seed, int slab,
                              int B, int H, int D, void* stream) {
  if (!operands_ok<T>(h, Wpost, B, H, D) || (mode != 0 && mode != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t attr = allow_smem();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap tmW;
  const int e = wpost_map<T>(&tmW, Wpost, H);
  if (e != 0) return e;
  const cudaError_t err = dposer::launch_programmatic(
      head_em_kernel, dim3(grid_blocks<T>(B)), THREADS, smem_bytes<T>(H),
      static_cast<cudaStream_t>(stream), h, tmW, bpost, coefs, step, mode, x, x_mean, score,
      score_sq, noise, seed, slab, B, H, D);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The launch of a call at B rows and depth H, for reports: grid CTAs,
// cluster size, threads a CTA, dynamic shared memory a CTA, and the clusters
// the current device can hold at once (cudaOccupancyMaxActiveClusters).
// Returns 0 or a CUDA error code.
extern "C" int dposer_head_em_launch_info(int B, int H, int* out) {
  const cudaError_t attr = allow_smem();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  return launch_info<T>(head_em_kernel, B, H, out);
}

// The imputation instantiation: EM mode as dposer_head_em, then `passes` (1
// or 2) masked re-noises of x's observed dims, obs and mask [B, D]: pass p
// with coefs row step + p (columns 5, 6; step + passes - 1 < N) and the host
// normals renoise_p [B, D] or, when null, the in-kernel draw (*seed, step + p,
// slab_p). x_mean (nullable) receives the state before the re-noise.
// Returns cudaGetLastError().
extern "C" int dposer_head_em_impute(const float* h, const void* Wpost, const float* bpost,
                                     const float* coefs, int step, float* x, float* x_mean,
                                     const float* noise, const unsigned long long* seed, int slab,
                                     const float* obs, const float* mask, const float* renoise0,
                                     int slab0, const float* renoise1, int slab1, int passes,
                                     int B, int H, int D, void* stream) {
  if (!operands_ok<T>(h, Wpost, B, H, D) || obs == nullptr || mask == nullptr || passes < 1 ||
      passes > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t attr = allow_smem_impute();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap tmW;
  const int e = wpost_map<T>(&tmW, Wpost, H);
  if (e != 0) return e;
  const Renoise rn{obs, mask, {renoise0, renoise1}, {slab0, slab1}, passes};
  const cudaError_t err = dposer::launch_programmatic(
      head_em_impute_kernel, dim3(grid_blocks<T>(B)), THREADS, smem_bytes<T>(H),
      static_cast<cudaStream_t>(stream), h, tmW, bpost, coefs, step, x, x_mean, noise, seed, slab,
      B, H, D, rn);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The imputation instantiation's launch at B rows and depth H, for reports,
// as dposer_head_em_launch_info.
extern "C" int dposer_head_em_impute_launch_info(int B, int H, int* out) {
  const cudaError_t attr = allow_smem_impute();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  return launch_info<T>(head_em_impute_kernel, B, H, out);
}
