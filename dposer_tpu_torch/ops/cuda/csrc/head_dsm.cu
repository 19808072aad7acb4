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
// tensor-core time) against ~3.4 MB moved (h as the train step's bf16 stash,
// 2.6 MB; Wpost, z, dout, the coefficients and the loss rows): bytes bound,
// ~1.0 us. From fp32 h (5.2 MB) it is ~6 MB and ~1.8 us.
//
// Design: the head is head_cluster.cuh's split-K over a thread-block cluster
// of 4 CTAs a 16-row tile (80 tiles x 4 = 320 CTAs at 1,280 rows, each
// copying a 256-deep slice: 8 KB of the bf16 stash, 32 KB of Wpost; 64,784 B
// of shared memory, and the H100 holds 92 such clusters at once, so the grid
// runs in one wave), its
// partials pushed through distributed shared memory to the CTA that finishes
// their rows and summed there in rank order: the same bits on every call.
// The train step hands the kernel its stash of the last block's output
// (bf16, what the head would round h to), so the rows arrive at half the
// bytes and need no conversion; fp32 h takes the same cluster head with the
// rounding in registers and gives the same bits. Epilogue warp e of the CTA
// of rank q finishes row 4q + e of the tile, each lane columns lane and
// lane + 32: while the copies fly it loads the row's (a, v, s), z and the
// bias; after the partials arrive it forms the residual, writes dout and
// reduces s * sum r^2 with shuffles, so the head's output never goes to
// device memory. The batch sum of the per-row losses is one torch.sum, in a
// fixed order. Kept out after measurement on the card (PERF.md): clusters of
// 8 CTAs (640 CTAs of ~43 KB), 6.6 us against 4.4 on the stash.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "head_cluster.cuh"

namespace {

namespace hc = dposer::head_cluster;

constexpr int SPLIT = 4;  // CTAs a cluster
using TileF = hc::Tile<SPLIT, false, float>;
using TileB = hc::Tile<SPLIT, false, __nv_bfloat16>;

// (launched in clusters of T::SPLIT CTAs: dposer::launch_cluster)
template <class T>
__global__ void __launch_bounds__(hc::THREADS)
head_dsm_kernel(const typename T::A* __restrict__ h, const __grid_constant__ CUtensorMap tmW,
                const float* __restrict__ bpost, const float* __restrict__ coefs,
                const float* __restrict__ z, float* __restrict__ loss_rows,
                float* __restrict__ dout, int B, int H, int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  const hc::Layout<T> L(smem, H);
  const int rank = static_cast<int>(hc::cg::this_cluster().block_rank());
  const int row0 = (blockIdx.x / T::SPLIT) * T::POSES;
  hc::start_copies<T>(h, nullptr, &tmW, L, row0, rank, B, H);
  hc::cluster_arrive_relaxed();  // the barriers are set up; waited on before the first push
  __syncthreads();  // the barriers are initialized, the zeroed rows written
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp < hc::MMA_WARPS) {
    hc::send_partials<T>(L, rank, H);
    return;
  }

  // The epilogue warps: warp MMA_WARPS + e finishes row rank * PPC + e of
  // the tile, each lane columns lane and lane + 32. While the copies fly it
  // loads the row's coefficients, z and the bias.
  const int e = warp - hc::MMA_WARPS;
  const int gr = row0 + rank * T::PPC + e;
  const bool has_row = e < T::PPC && gr < B;  // uniform across the warp
  float a = 0.0f, v = 0.0f, s = 0.0f, bias[2] = {}, zv[2] = {};
  if (has_row) {
    a = coefs[gr * 3 + 0];
    v = coefs[gr * 3 + 1];
    s = coefs[gr * 3 + 2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = lane + 32 * u;
      if (c >= D) continue;
      bias[u] = bpost[c];
      zv[u] = z[static_cast<size_t>(gr) * D + c];
    }
  }
  hc::wait_partials<T>(L);  // every epilogue warp waits: peers push into this CTA until then

  if (has_row) {
    float sq = 0.0f;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = lane + 32 * u;
      if (c >= D) continue;
      const float r = a * hc::out_at<T>(L, bias[u], e, c) + v * zv[u];
      sq += r * r;
      dout[static_cast<size_t>(gr) * D + c] = 2.0f * s * a * r;
    }
    sq = dposer::warp_sum(sq);
    if (lane == 0) loss_rows[gr] = s * sq;
  }
}

// More than 48 KB of dynamic shared memory a CTA, allowed once a kernel.
template <class T>
cudaError_t allow_smem() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      head_dsm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(hc::smem_bytes<T>(1024)));
  return attr;
}

template <class T>
int launch(const void* h, const void* Wpost, const float* bpost, const float* coefs,
           const float* z, float* loss_rows, float* dout, int B, int H, int D,
           cudaStream_t stream) {
  if (!hc::operands_ok<T>(h, Wpost, B, H, D)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t attr = allow_smem<T>();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap tmW;
  const int e = hc::wpost_map<T>(&tmW, Wpost, H);
  if (e != 0) return e;
  const cudaError_t err = dposer::launch_cluster(
      head_dsm_kernel<T>, dim3(hc::grid_blocks<T>(B)), hc::THREADS, hc::smem_bytes<T>(H),
      stream, T::SPLIT, static_cast<const typename T::A*>(h), tmW, bpost, coefs, z, loss_rows,
      dout, B, H, D);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// h [B, H] bf16 (h_bf16 != 0: the train step's stash) or fp32 (h_bf16 == 0),
// Wpost [H, 64] bf16 (columns >= D zero), bpost [64] fp32, coefs [B, 3] fp32
// (a, v, s), z [B, D] fp32; writes loss_rows [B] and dout [B, D] fp32. H must
// be a multiple of 64 and <= 1024, h and Wpost 16-byte aligned; D <= 64. Both
// types give the same bits when the bf16 h is the fp32 one rounded (RNE).
// Returns 0, the error of a failed tensor-map encode, or cudaGetLastError()
// after the launch.
extern "C" int dposer_head_dsm(const void* h, int h_bf16, const void* Wpost, const float* bpost,
                               const float* coefs, const float* z, float* loss_rows, float* dout,
                               int B, int H, int D, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (h_bf16) return launch<TileB>(h, Wpost, bpost, coefs, z, loss_rows, dout, B, H, D, s);
  return launch<TileF>(h, Wpost, bpost, coefs, z, loss_rows, dout, B, H, D, s);
}

// The launch at B rows and depth H with h in bf16 (h_bf16 != 0) or fp32, for
// reports: grid CTAs, cluster size, threads and dynamic shared memory a CTA,
// and the clusters the current device holds at once. Returns 0 or a CUDA
// error code.
extern "C" int dposer_head_dsm_launch_info(int B, int H, int h_bf16, int* out) {
  const cudaError_t attr = h_bf16 ? allow_smem<TileB>() : allow_smem<TileF>();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  return h_bf16 ? hc::launch_info<TileB>(head_dsm_kernel<TileB>, B, H, out)
                : hc::launch_info<TileF>(head_dsm_kernel<TileF>, B, H, out);
}
