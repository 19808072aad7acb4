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
// bf16 tensor-core time) against ~2.8 MB moved (h fp32 read once, 2 MB;
// x read, xs and acc read and written): bytes bound, ~0.84 us. K9 at [50,
// 1024] pair is 12.9 MFLOP against ~0.6 MB (h and dh; Wpost 0.13 MB): bytes
// bound, ~0.2 us.
//
// Design: both heads are head_cluster.cuh's split-K over a thread-block
// cluster, the partials of a row pushed through distributed shared memory
// (st.async onto the finishing CTA's mbarrier) and summed there in rank
// order, so every call gives the same bits.
// - K8: Tile<4>, K2's grid: 16 poses a tile over 4 CTAs, each copying a
//   256-deep slice (16 KB of h, 32 KB of Wpost), 32 tiles x 4 = 128 CTAs at
//   500 rows (the heads' first design, a 16-row block tile, gave 32 blocks,
//   each staging its 64 KB of h through registers and reading all of Wpost
//   from L2 inside its WMMA loop). Epilogue warp e of the CTA of rank q finishes
//   pose 4q + e of the tile, each lane columns lane and lane + 32: while the
//   copies fly it loads the grid row's scalars, the bias and the pose's x,
//   xs and acc (x alone for the denoise, no acc at stage 0); after the
//   partials arrive it runs the RK4 stage or the denoise on them, so neither
//   out nor k reaches device memory. Clusters of 8 (256 CTAs) measured
//   slower on the card (3.8 us against 3.5, PERF.md).
// - K9: Tile<8, true> (4 where H does not cut into 8 slices), its tile a
//   PAIR: 8 poses' h rows and the same poses' dh rows, so one mma row tile
//   carries the primal and the tangent product (at 50 rows 7 tiles x 8 CTAs
//   = 56 CTAs, each copying a 128-deep slice: 16 KB of Wpost, 8 KB of h and
//   dh; the first design's 16-row block tile gave 4 blocks, each staging
//   all of Wpost and running the head twice). The partials of a
//   pose's two rows go to the CTA that finishes the pose and are summed there
//   in rank order (the same bits on every call). Its epilogue warp e, while
//   the copies fly, loads the pose's x, xs, acc, probe row, lp and lacc; then
//   it forms out and dout, k_x = a1*xs + a2*out and the row sums of k_lp =
//   a1*sum(e^2) + a2*sum(dout*e) with shuffles, and runs the RK4 bookkeeping
//   on x and on delta_logp.
// The grid point's scalars (a1, a2, h, cdx, cdo) are read from the device
// table coefs [G, 8] at row j, so the host loop never synchronizes.

#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"
#include "head_cluster.cuh"

namespace {

namespace hc = dposer::head_cluster;

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

// K8 over a cluster of T::SPLIT CTAs a tile of T::POSES poses.
// (launched in clusters of T::SPLIT CTAs: dposer::launch_cluster)
template <class T>
__global__ void __launch_bounds__(hc::THREADS)
head_rk4_kernel(const float* __restrict__ h, const __grid_constant__ CUtensorMap tmW,
                const float* __restrict__ bpost, const float* __restrict__ coefs, int j,
                int stage, float* x, float* xs, float* acc, int B, int H, int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  const hc::Layout<T> L(smem, H);
  const int rank = static_cast<int>(hc::cg::this_cluster().block_rank());
  const int pose0 = (blockIdx.x / T::SPLIT) * T::POSES;
  hc::start_copies<T>(h, nullptr, &tmW, L, pose0, rank, B, H);
  hc::cluster_arrive_relaxed();  // the barriers are set up; waited on before the first push
  __syncthreads();  // the barriers are initialized, the zeroed rows written
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp < hc::MMA_WARPS) {
    hc::send_partials<T>(L, rank, H);
    return;
  }

  // The epilogue warps: warp MMA_WARPS + e finishes pose rank * PPC + e of
  // the tile, each lane columns lane and lane + 32. While the copies fly it
  // loads the grid row's scalars, the bias and the pose's state.
  const int e = warp - hc::MMA_WARPS;
  const int gr = pose0 + rank * T::PPC + e;
  const bool has_row = e < T::PPC && gr < B;  // uniform across the warp
  const float* cf = coefs + static_cast<size_t>(j) * N_COEFS;
  float a1 = 0.0f, a2 = 0.0f, hstep = 0.0f;
  float bias[2] = {}, xo[2] = {}, xso[2] = {}, ao[2] = {};
  if (has_row) {
    if (stage == DENOISE) {
      a1 = cf[3];  // cdx, cdo
      a2 = cf[4];
    } else {
      a1 = cf[0];
      a2 = cf[1];
      hstep = cf[2];
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = lane + 32 * u;
      if (c >= D) continue;
      const size_t o = static_cast<size_t>(gr) * D + c;
      bias[u] = bpost[c];
      xo[u] = x[o];
      if (stage == DENOISE) continue;
      xso[u] = xs[o];
      ao[u] = stage == 0 ? 0.0f : acc[o];
    }
  }
  hc::wait_partials<T>(L);  // every epilogue warp waits: peers push into this CTA until then

  if (has_row) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = lane + 32 * u;
      if (c >= D) continue;
      const size_t o = static_cast<size_t>(gr) * D + c;
      const float out = hc::out_at<T>(L, bias[u], e, c);
      if (stage == DENOISE) {
        x[o] = a1 * xo[u] + a2 * out;
        continue;
      }
      xs[o] = rk4_stage(stage, hstep, a1 * xso[u] + a2 * out, xo[u], ao[u]);
      if (stage == 3)
        x[o] = xo[u];
      else
        acc[o] = ao[u];
    }
  }
}

// K9 over a cluster of T::SPLIT CTAs a tile of T::POSES poses (T a PAIR).
// (launched in clusters of T::SPLIT CTAs: dposer::launch_cluster)
template <class T>
__global__ void __launch_bounds__(hc::THREADS)
head_rk4_jvp_kernel(const float* __restrict__ h, const float* __restrict__ dh,
                    const __grid_constant__ CUtensorMap tmW, const float* __restrict__ bpost,
                    const float* __restrict__ coefs, int j, int stage, float* x, float* xs,
                    float* acc, const float* __restrict__ eps, float* lp, float* lacc, int B,
                    int H, int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  const hc::Layout<T> L(smem, H);
  const int rank = static_cast<int>(hc::cg::this_cluster().block_rank());
  const int pose0 = (blockIdx.x / T::SPLIT) * T::POSES;
  hc::start_copies<T>(h, dh, &tmW, L, pose0, rank, B, H);
  hc::cluster_arrive_relaxed();  // the barriers are set up; waited on before the first push
  __syncthreads();  // the barriers are initialized, the zeroed rows written
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp < hc::MMA_WARPS) {
    hc::send_partials<T>(L, rank, H);
    return;
  }

  // The epilogue warps: warp MMA_WARPS + e finishes pose rank * PPC + e of
  // the tile (its rows e and PPC + e among the received ones), each lane
  // columns lane and lane + 32. While the copies fly it loads the pose's
  // state, probe row and scalars.
  const int e = warp - hc::MMA_WARPS;
  const int gr = pose0 + rank * T::PPC + e;
  const bool has_row = e < T::PPC && gr < B;  // uniform across the warp
  const float* cf = coefs + static_cast<size_t>(j) * N_COEFS;
  float a1 = 0.0f, a2 = 0.0f, hstep = 0.0f, lo = 0.0f, la = 0.0f;
  float bias[2] = {}, xo[2] = {}, xso[2] = {}, ao[2] = {}, ev[2] = {};
  if (has_row) {
    a1 = cf[0];
    a2 = cf[1];
    hstep = cf[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = lane + 32 * u;
      if (c >= D) continue;
      const size_t o = static_cast<size_t>(gr) * D + c;
      bias[u] = bpost[c];
      xo[u] = x[o];
      xso[u] = xs[o];
      ao[u] = stage == 0 ? 0.0f : acc[o];
      ev[u] = eps[o];
    }
    lo = lp[gr];
    la = stage == 0 ? 0.0f : lacc[gr];
  }
  hc::wait_partials<T>(L);  // every epilogue warp waits: peers push into this CTA until then

  if (has_row) {
    float dot = 0.0f, ee = 0.0f;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = lane + 32 * u;
      if (c >= D) continue;
      const size_t o = static_cast<size_t>(gr) * D + c;
      const float out = hc::out_at<T>(L, bias[u], e, c);
      const float dout = hc::out_at<T>(L, 0.0f, T::PPC + e, c);
      xs[o] = rk4_stage(stage, hstep, a1 * xso[u] + a2 * out, xo[u], ao[u]);
      if (stage == 3)
        x[o] = xo[u];
      else
        acc[o] = ao[u];
      dot += dout * ev[u];
      ee += ev[u] * ev[u];
    }
    dot = dposer::warp_sum(dot);
    ee = dposer::warp_sum(ee);
    if (lane == 0) {
      rk4_stage(stage, hstep, a1 * ee + a2 * dot, lo, la);
      if (stage == 3)
        lp[gr] = lo;
      else
        lacc[gr] = la;
    }
  }
}

// K8's cluster: K2's grid, 16 poses a tile over 4 CTAs.
using Rk4 = hc::Tile<4>;

// K9's cluster sizes: 8 CTAs where H cuts into 8 whole 16-deep slices (56
// CTAs at 50 rows, where 4 gave 28 and was slower), else 4 (H = 64, 192, ...).
using Jvp8 = hc::Tile<8, true>;
using Jvp4 = hc::Tile<4, true>;
inline bool takes_jvp8(int H) { return H % (16 * Jvp8::SPLIT) == 0; }

// More than 48 KB of dynamic shared memory a CTA, allowed once a kernel.
template <class T>
cudaError_t allow_smem_jvp() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      head_rk4_jvp_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(hc::smem_bytes<T>(1024)));
  return attr;
}

cudaError_t allow_smem_rk4() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      head_rk4_kernel<Rk4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(hc::smem_bytes<Rk4>(1024)));
  return attr;
}

template <class T>
int launch_jvp(const float* h, const float* dh, const void* Wpost, const float* bpost,
               const float* coefs, int j, int stage, float* x, float* xs, float* acc,
               const float* eps, float* lp, float* lacc, int B, int H, int D,
               cudaStream_t stream) {
  if (!hc::operands_ok<T>(h, Wpost, B, H, D)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t attr = allow_smem_jvp<T>();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap tmW;
  const int e = hc::wpost_map<T>(&tmW, Wpost, H);
  if (e != 0) return e;
  const cudaError_t err = dposer::launch_cluster(
      head_rk4_jvp_kernel<T>, dim3(hc::grid_blocks<T>(B)), hc::THREADS, hc::smem_bytes<T>(H),
      stream, T::SPLIT, h, dh, tmW, bpost, coefs, j, stage, x, xs, acc, eps, lp, lacc, B, H, D);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// K8. h [B, H] fp32, Wpost [H, 64] bf16 (columns >= D zero), bpost [64] fp32,
// coefs [G, 8] fp32 read at row j; x, xs, acc [B, D] updated in place as the
// stage (0..3, or 4 for the denoise, which touches x only) says; over
// clusters of 4 CTAs. H a multiple of 64 and <= 1024, h and Wpost 16-byte
// aligned, D <= 64. Returns 0, the error of a failed tensor-map encode, or
// cudaGetLastError() after the launch.
extern "C" int dposer_head_rk4(const float* h, const void* Wpost, const float* bpost,
                               const float* coefs, int j, int stage, float* x, float* xs,
                               float* acc, int B, int H, int D, void* stream) {
  if (!hc::operands_ok<Rk4>(h, Wpost, B, H, D) || stage < 0 || stage > DENOISE)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t attr = allow_smem_rk4();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap tmW;
  const int e = hc::wpost_map<Rk4>(&tmW, Wpost, H);
  if (e != 0) return e;
  const cudaError_t err = dposer::launch_cluster(
      head_rk4_kernel<Rk4>, dim3(hc::grid_blocks<Rk4>(B)), hc::THREADS, hc::smem_bytes<Rk4>(H),
      static_cast<cudaStream_t>(stream), Rk4::SPLIT, h, tmW, bpost, coefs, j, stage, x, xs, acc,
      B, H, D);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// K8's launch at B rows and depth H, for reports: grid CTAs, cluster size,
// threads and dynamic shared memory a CTA, and the clusters the current
// device holds at once. Returns 0 or a CUDA error code.
extern "C" int dposer_head_rk4_launch_info(int B, int H, int* out) {
  const cudaError_t attr = allow_smem_rk4();
  return attr != cudaSuccess ? static_cast<int>(attr)
                             : hc::launch_info<Rk4>(head_rk4_kernel<Rk4>, B, H, out);
}

// K9. As K8 (stages 0..3), with the tangent dh [B, H] fp32 (16-byte aligned),
// the probe eps [B, D], and lp, lacc [B] updated in place; over clusters of
// 8 CTAs where H is a multiple of 128, else of 4 (H a multiple of 64).
extern "C" int dposer_head_rk4_jvp(const float* h, const float* dh, const void* Wpost,
                                   const float* bpost, const float* coefs, int j, int stage,
                                   float* x, float* xs, float* acc, const float* eps, float* lp,
                                   float* lacc, int B, int H, int D, void* stream) {
  if (reinterpret_cast<uintptr_t>(dh) % 16 != 0 || stage < 0 || stage >= DENOISE)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (takes_jvp8(H))
    return launch_jvp<Jvp8>(h, dh, Wpost, bpost, coefs, j, stage, x, xs, acc, eps, lp, lacc, B, H, D, s);
  return launch_jvp<Jvp4>(h, dh, Wpost, bpost, coefs, j, stage, x, xs, acc, eps, lp, lacc, B, H, D, s);
}

// K9's launch at B rows and depth H, for reports: grid CTAs, cluster size,
// threads and dynamic shared memory a CTA, and the clusters the current
// device holds at once. Returns 0 or a CUDA error code.
extern "C" int dposer_head_rk4_jvp_launch_info(int B, int H, int* out) {
  if (takes_jvp8(H)) {
    const cudaError_t attr = allow_smem_jvp<Jvp8>();
    return attr != cudaSuccess ? static_cast<int>(attr)
                               : hc::launch_info<Jvp8>(head_rk4_jvp_kernel<Jvp8>, B, H, out);
  }
  const cudaError_t attr = allow_smem_jvp<Jvp4>();
  return attr != cudaSuccess ? static_cast<int>(attr)
                             : hc::launch_info<Jvp4>(head_rk4_jvp_kernel<Jvp4>, B, H, out);
}
