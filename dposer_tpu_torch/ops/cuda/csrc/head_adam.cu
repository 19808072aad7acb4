// K6 head_adam: raw = bf16(h) @ Wpost + bpost, then one Adam step of pose
// completion on the accumulator tile, all in place:
//   x0_hat = ca*pert + cb*raw                    (one-step denoise, detached)
//   g      = cd*m*(x - obs) + cp*(x - x0_hat)    (masked data + prior gradient)
//   m1 <- 0.9*m1 + 0.1*g;  v <- 0.999*v + 0.001*g*g
//   x  <- x - clr * m1 / (sqrt(v*cv) + 1e-8)
// and, on the solver's last step (paste != 0), x <- obs*m + x*(1-m).
// The perturbing instantiation (head_adam_perturb_kernel) then writes the
// next step's perturbation of the new x, what K5 at step + 1 did, bit for bit
// (common.cuh::comp_perturb):
//   pert <- c_m'*x + c_s'*z'    (c_m', c_s': columns 0, 1 of row step + 1)
//
// Replaces: the body of the Adam loop of the TPU completion kernel after the
// network's hidden layers, dposer_tpu/ops/pallas/fused_comp.py::_make_kernel
// (:118-127, and the final paste :131); the hidden layers are K1's; the
// perturbing instantiation also the next step's perturbation (:116-117). The
// step's scalars ca, cb, cd, cp, clr, cv are columns 2..7 of its row of
// coefs [T, 8]; clr and cv fold Adam's bias corrections.
//
// Bound on the H100: [1000, 1024] x [1024, 63] is 129 MFLOP (~0.13 us of
// bf16 tensor-core time) against ~6.5 MB moved (h fp32 read once, 4 MB; x,
// m1 and v read and written; pert, obs and mask read): bytes bound, ~1.9 us;
// the perturbing instantiation also writes pert (and reads the host normals
// on host slabs): ~6.7 MB (7.0), ~2.0 us (2.1).
//
// Design: the head is head_cluster.cuh's split-K over a thread-block cluster,
// as K2's and K8's: Tile<4>, 16 poses a tile over 4 CTAs, each copying a
// 256-deep slice (16 KB of h, 32 KB of Wpost), 63 tiles x 4 = 252 CTAs at
// 1,000 rows, 73,232 B of shared memory a CTA, so three fit on an SM and all
// are resident at once. The partials of a row are pushed through distributed
// shared memory (st.async onto the finishing CTA's mbarrier) and summed there
// in rank order, so every call gives the same bits. Epilogue warp e of the
// CTA of rank q finishes pose 4q + e of the tile, each lane columns lane and
// lane + 32: while the copies fly it loads the step's scalars, the bias and
// the pose's x, pert, obs, mask, m1 and v (six reads an element, K6's the
// widest epilogue of the cluster heads); after the partials arrive it runs
// the denoise, the gradient and the Adam step on them, so neither the head's
// output nor g reaches device memory. v*cv stays under the square root, as
// the TPU kernel and optax have it. The 16-row block tile this replaced
// (one CTA a tile staging its rows of h through registers: 63 CTAs at 1,000
// rows, under half of the 132 SMs) took 11.05 us (PERF.md).
// The perturbing instantiation loads step + 1's c_m and c_s and loads or
// draws its normals (Philox at (seed, step + 1, slab, row, col), K5's key)
// beside the six state loads, while the copies fly, and writes pert in place
// after x: one launch a step instead of K5's and K6's. head_adam_kernel is the
// body without it.
// Both instantiations are programmatic launches (mbarrier.cuh), as K2's:
// warp 0 starts Wpost's box, waits for the launches before it (the last
// hidden layer's h) and starts h's copies; the epilogue warps wait first,
// then load and draw while the copies fly, as before. (A first version that
// loaded the step's scalars and drew before the wait gave the solver other
// last bits: the same counts of fused and plain multiplies and adds in its
// SASS, so the compiler fused other products of the Adam step. The loads
// overlap the copies and the MMAs either way.)

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "common.cuh"
#include "head_cluster.cuh"

namespace {

namespace hc = dposer::head_cluster;

constexpr int N_COEFS = 8;  // c_m, c_s, ca, cb, cd, cp, clr, cv
// 1 - b1 and 1 - b2 as fp32 roundings of the exact values, not of 1 - fp32(b):
// 1 - 0.999f is off by 1.3e-5 relative
constexpr float ADAM_B1 = 0.9f, ADAM_1MB1 = 0.1f, ADAM_B2 = 0.999f, ADAM_1MB2 = 0.001f;
constexpr float ADAM_EPS = 1e-8f;

// pert as the body reads it: the perturbing instantiation writes it too.
template <bool PERTURB>
using PertPtr = std::conditional_t<PERTURB, float*, const float*>;

// K6 over a cluster of T::SPLIT CTAs a tile of T::POSES poses; with PERTURB
// also step + 1's perturbation of the new x into pert, from the host normals
// next_noise [B, D] or, where that is null, the draw (seed, step + 1, slab)
// with the seed read from device memory (*seed_ptr; each epilogue warp
// loads it once, before its draws), so a CUDA graph that captured the
// launch draws with the seed written before each replay.
template <class T, bool PERTURB>
__device__ __forceinline__ void head_adam_body(
    const float* __restrict__ h, const CUtensorMap& tmW, const float* __restrict__ bpost,
    const float* __restrict__ coefs, int step, float* x, PertPtr<PERTURB> pert,
    const float* obs, const float* mask, float* m1, float* v, int paste, int B, int H, int D,
    const float* next_noise, const unsigned long long* __restrict__ seed_ptr, int slab) {
  extern __shared__ __align__(128) unsigned char smem[];
  const hc::Layout<T> L(smem, H);
  const int rank = static_cast<int>(hc::cg::this_cluster().block_rank());
  const int pose0 = (blockIdx.x / T::SPLIT) * T::POSES;
  hc::start_copies<T, dposer::Programmatic>(h, nullptr, &tmW, L, pose0, rank, B, H);
  hc::cluster_arrive_relaxed();  // the barriers are set up; waited on before the first push
  __syncthreads();  // the barriers are initialized, the zeroed rows written
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp < hc::MMA_WARPS) {
    hc::send_partials<T>(L, rank, H);
    return;
  }

  // The epilogue warps: warp MMA_WARPS + e finishes pose rank * PPC + e of
  // the tile, each lane columns lane and lane + 32. Once the launches before
  // this one are done, while the copies fly, it loads the step's scalars,
  // the bias and the pose's state (and, with PERTURB, the next step's
  // scalars and normals).
  dposer::grid_dependency_wait();
  const int e = warp - hc::MMA_WARPS;
  const int gr = pose0 + rank * T::PPC + e;
  const bool has_row = e < T::PPC && gr < B;  // uniform across the warp
  const float* cf = coefs + static_cast<size_t>(step) * N_COEFS;
  float ca = 0.0f, cb = 0.0f, cd = 0.0f, cp = 0.0f, clr = 0.0f, cv = 0.0f;
  float bias[2] = {}, xo[2] = {}, pe[2] = {}, ob[2] = {}, mk[2] = {}, mo[2] = {}, vo[2] = {};
  if (has_row) {
    ca = cf[2];
    cb = cf[3];
    cd = cf[4];
    cp = cf[5];
    clr = cf[6];
    cv = cf[7];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = lane + 32 * u;
      if (c >= D) continue;
      const size_t o = static_cast<size_t>(gr) * D + c;
      bias[u] = bpost[c];
      xo[u] = x[o];
      pe[u] = pert[o];
      ob[u] = obs[o];
      mk[u] = mask[o];
      mo[u] = m1[o];
      vo[u] = v[o];
    }
  }
  // step + 1's c_m, c_s and normals: they do not depend on the partials
  float cm = 0.0f, cs = 0.0f, zn[2] = {};
  if constexpr (PERTURB) {
    if (has_row) {
      const unsigned long long seed = dposer::load_seed(seed_ptr);
      cm = cf[N_COEFS + 0];
      cs = cf[N_COEFS + 1];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c = lane + 32 * u;
        if (c >= D) continue;
        zn[u] = dposer::draw_normal(next_noise, seed, step + 1, slab, gr, c, D);
      }
    }
  }
  hc::wait_partials<T>(L);  // every epilogue warp waits: peers push into this CTA until then

  if (has_row) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = lane + 32 * u;
      if (c >= D) continue;
      const size_t o = static_cast<size_t>(gr) * D + c;
      const float x0_hat = ca * pe[u] + cb * hc::out_at<T>(L, bias[u], e, c);
      const float g = cd * (mk[u] * (xo[u] - ob[u])) + cp * (xo[u] - x0_hat);
      const float mn = ADAM_B1 * mo[u] + ADAM_1MB1 * g;
      const float vn = ADAM_B2 * vo[u] + ADAM_1MB2 * (g * g);
      m1[o] = mn;
      v[o] = vn;
      const float xn = xo[u] - clr * mn / (sqrtf(vn * cv) + ADAM_EPS);
      x[o] = paste ? ob[u] * mk[u] + xn * (1.0f - mk[u]) : xn;
      // In place: this lane read pert[o] for this step's x0_hat above, no
      // other CTA or lane touches element o, and step's K1 launches read
      // pert before this launch in stream order.
      if constexpr (PERTURB) pert[o] = dposer::comp_perturb(cm, xn, cs, zn[u]);
    }
  }
}

// K6 (launched in clusters of T::SPLIT CTAs: dposer::launch_cluster)
template <class T>
__global__ void __launch_bounds__(hc::THREADS)
head_adam_kernel(const float* __restrict__ h, const __grid_constant__ CUtensorMap tmW,
                 const float* __restrict__ bpost, const float* __restrict__ coefs, int step,
                 float* x, const float* pert, const float* obs, const float* mask, float* m1,
                 float* v, int paste, int B, int H,
                 int D) {
  head_adam_body<T, false>(h, tmW, bpost, coefs, step, x, pert, obs, mask, m1, v, paste, B, H,
                           D, nullptr, nullptr, 0);
}

// K6 with step + 1's perturbation (the solver's steps before its last; no
// paste)
template <class T>
__global__ void __launch_bounds__(hc::THREADS)
head_adam_perturb_kernel(const float* __restrict__ h, const __grid_constant__ CUtensorMap tmW,
                         const float* __restrict__ bpost, const float* __restrict__ coefs,
                         int step, float* x, float* pert, const float* obs, const float* mask,
                         float* m1, float* v, int B, int H, int D, const float* next_noise,
                         const unsigned long long* __restrict__ seed,
                         int slab) {
  head_adam_body<T, true>(h, tmW, bpost, coefs, step, x, pert, obs, mask, m1, v, 0, B, H, D,
                          next_noise, seed, slab);
}

// K6's cluster: K2's grid, 16 poses a tile over 4 CTAs.
using Adam = hc::Tile<4>;

// More than 48 KB of dynamic shared memory a CTA, allowed once a kernel.
template <class Kernel>
cudaError_t allow_smem_of(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(hc::smem_bytes<Adam>(1024)));
}

cudaError_t allow_smem() {
  static const cudaError_t attr = allow_smem_of(head_adam_kernel<Adam>);
  return attr;
}

cudaError_t allow_smem_perturb() {
  static const cudaError_t attr = allow_smem_of(head_adam_perturb_kernel<Adam>);
  return attr;
}

}  // namespace

// h [B, H] fp32, Wpost [H, 64] bf16 (columns >= D zero), bpost [64] fp32,
// coefs [T, 8] fp32; x, m1, v [B, D] updated in place; pert, obs, mask
// [B, D]; over clusters of 4 CTAs. H a multiple of 64 and <= 1024, h and
// Wpost 16-byte aligned, D <= 64. A programmatic launch: Wpost is read
// before its wait for the launch before it on the stream, so that launch
// must not write it. Returns 0, the error of a failed tensor-map encode, or
// cudaGetLastError() after the launch.
extern "C" int dposer_head_adam(const float* h, const void* Wpost, const float* bpost,
                                const float* coefs, int step, float* x, const float* pert,
                                const float* obs, const float* mask, float* m1, float* v,
                                int paste, int B, int H, int D, void* stream) {
  if (!hc::operands_ok<Adam>(h, Wpost, B, H, D)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t attr = allow_smem();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap tmW;
  const int e = hc::wpost_map<Adam>(&tmW, Wpost, H);
  if (e != 0) return e;
  const cudaError_t err = dposer::launch_cluster<dposer::Programmatic>(
      head_adam_kernel<Adam>, dim3(hc::grid_blocks<Adam>(B)), hc::THREADS,
      hc::smem_bytes<Adam>(H), static_cast<cudaStream_t>(stream), Adam::SPLIT, h, tmW, bpost,
      coefs, step, x, pert, obs, mask, m1, v, paste, B, H, D);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// K6's launch at B rows and depth H, for reports: grid CTAs, cluster size,
// threads and dynamic shared memory a CTA, and the clusters the current
// device holds at once. Returns 0 or a CUDA error code.
extern "C" int dposer_head_adam_launch_info(int B, int H, int* out) {
  const cudaError_t attr = allow_smem();
  return attr != cudaSuccess ? static_cast<int>(attr)
                             : hc::launch_info<Adam>(head_adam_kernel<Adam>, B, H, out);
}

// The perturbing instantiation: the Adam step as dposer_head_adam without
// the paste, then pert [B, D] (read at step, written in place) <- step + 1's
// perturbation of the new x, with coefs row step + 1 (columns 0, 1; step + 1
// < T) and the host normals next_noise [B, D] or, when null, the in-kernel
// draw (*seed, step + 1, slab), seed in device memory (null with
// next_noise). pert must not alias x. Returns as
// dposer_head_adam.
extern "C" int dposer_head_adam_perturb(const float* h, const void* Wpost, const float* bpost,
                                        const float* coefs, int step, float* x, float* pert,
                                        const float* obs, const float* mask, float* m1,
                                        float* v, const float* next_noise,
                                        const unsigned long long* seed, int slab, int B, int H,
                                        int D,
                                        void* stream) {
  if (!hc::operands_ok<Adam>(h, Wpost, B, H, D) || pert == x)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t attr = allow_smem_perturb();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap tmW;
  const int e = hc::wpost_map<Adam>(&tmW, Wpost, H);
  if (e != 0) return e;
  const cudaError_t err = dposer::launch_cluster<dposer::Programmatic>(
      head_adam_perturb_kernel<Adam>, dim3(hc::grid_blocks<Adam>(B)), hc::THREADS,
      hc::smem_bytes<Adam>(H), static_cast<cudaStream_t>(stream), Adam::SPLIT, h, tmW, bpost,
      coefs, step, x, pert, obs, mask, m1, v, B, H, D, next_noise, seed, slab);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The perturbing instantiation's launch at B rows and depth H, for reports,
// as dposer_head_adam_launch_info.
extern "C" int dposer_head_adam_perturb_launch_info(int B, int H, int* out) {
  const cudaError_t attr = allow_smem_perturb();
  return attr != cudaSuccess
             ? static_cast<int>(attr)
             : hc::launch_info<Adam>(head_adam_perturb_kernel<Adam>, B, H, out);
}
