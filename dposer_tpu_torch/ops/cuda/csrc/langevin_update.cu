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
// launch, the barriers and the normal draws set its time.
//
// Design: the step size needs two batch-wide means before any element can
// move. One cluster of 16 CTAs (past the portable 8: the H100 allows it)
// owns the batch, each CTA a contiguous range of rows; a half-warp owns a
// row at a time, each lane a group of four columns (63 columns: 16 lanes).
// - Pass 1 draws each group's normals once (philox_normal4: one Philox call
//   gives the four, keyed by (seed, step, slab, row, column / 4) as in every
//   earlier version; the seed read from device memory, so a CUDA graph that
//   captured the launch draws with the seed written before each replay),
//   loads its x and score, and keeps all of them in
//   registers for the half-warp's first CACHED rows (2,048 rows a cluster):
//   pass 2 then waits on no load. Rows past those, and groups past a row's
//   16th, are reloaded and redrawn from their counters in pass 2 (large
//   batches). A row's |z|^2 is a half-warp shuffle sum.
// - The CTA's partial sums of sqrt(score_sq) and |z| (shuffles, then its
//   warps in order) go to every peer's shared memory through distributed
//   shared memory (st.async, counted in on the peer's mbarrier); once its
//   barrier has all CLUSTER of them, each CTA adds them in rank order, so
//   every CTA computes the bit-identical step size, and the same on every
//   run (no atomics). CTA 0 writes step_out. The one cluster barrier, arrived
//   at once the mbarriers are set up and waited on before the first push,
//   makes sure every peer's mbarrier exists; no CTA reads a peer.
// - Pass 2 applies the update to the CTA's rows.
// - Measured on the card at 500 rows and kept out: 8 CTAs (the portable
//   size), slower by about the Philox draws of twice the rows a CTA, and a
//   second cluster barrier in place of the mbarrier.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "mbarrier.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int CLUSTER = 16;  // CTAs of the one cluster
constexpr int THREADS = 512;
constexpr int N_WARPS = THREADS / 32;
constexpr int N_HALVES = THREADS / 16;  // half-warps: rows in flight a CTA
constexpr int CACHED = 4;  // rows a half-warp keeps in registers
constexpr int N_COEFS = 8;

__device__ __forceinline__ float4 group_normals(const float* __restrict__ noise,
                                                unsigned long long seed, int step, int slab,
                                                int row, int col0, int D) {
  if (noise == nullptr) return dposer::philox_normal4(seed, step, slab, row, col0);
  const float* p = noise + static_cast<size_t>(row) * D + col0;
  return make_float4(p[0], col0 + 1 < D ? p[1] : 0.0f, col0 + 2 < D ? p[2] : 0.0f,
                     col0 + 3 < D ? p[3] : 0.0f);
}

__device__ __forceinline__ float4 load4(const float* __restrict__ p, int row, int col0, int D) {
  const float* q = p + static_cast<size_t>(row) * D + col0;
  return make_float4(q[0], col0 + 1 < D ? q[1] : 0.0f, col0 + 2 < D ? q[2] : 0.0f,
                     col0 + 3 < D ? q[3] : 0.0f);
}

__device__ __forceinline__ float group_sq(float4 z, int col0, int D) {
  float zz = z.x * z.x;
  if (col0 + 1 < D) zz += z.y * z.y;
  if (col0 + 2 < D) zz += z.z * z.z;
  if (col0 + 3 < D) zz += z.w * z.w;
  return zz;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Args {
  float* x;
  const float* __restrict__ score;
  const float* __restrict__ score_sq;
  const float* __restrict__ noise;
  unsigned long long seed;
  int step, slab, D;
};

// A half-warp's rows: the j-th is begin + half + N_HALVES * j while < end.
struct Rows {
  int begin, end, half, lane16;
  __device__ __forceinline__ int row(int j) const { return begin + half + N_HALVES * j; }
};

// One row's operands on this lane: its first column group (columns
// 4*lane16 .. +3): the normals, x and score, and (lane16 0) score_sq.
struct Slot {
  float4 z, x, s;
  float score_sq;
};

__device__ __forceinline__ void fetch(const Args& a, const Rows& rs, int j, Slot& sl) {
  const int r = rs.row(j);
  if (r >= rs.end) return;
  const int c0 = 4 * rs.lane16;
  if (c0 < a.D) {
    sl.z = group_normals(a.noise, a.seed, a.step, a.slab, r, c0, a.D);
    sl.x = load4(a.x, r, c0, a.D);
    sl.s = load4(a.score, r, c0, a.D);
  }
  if (rs.lane16 == 0) sl.score_sq = a.score_sq[r];
}

// The row's |z| (its groups past the 16th redrawn) and sqrt(score_sq), added
// to the half-warp's sums on lane16 0. Every lane of the warp calls it.
__device__ __forceinline__ void norms(const Args& a, const Rows& rs, int j, const Slot& sl,
                                      float& g_sum, float& z_sum) {
  const int r = rs.row(j);
  const bool valid = r < rs.end;
  const int groups = (a.D + 3) / 4;
  float zz = valid && rs.lane16 < groups ? group_sq(sl.z, 4 * rs.lane16, a.D) : 0.0f;
  for (int g = rs.lane16 + 16; g - rs.lane16 < groups; g += 16)
    if (valid && g < groups)
      zz += group_sq(group_normals(a.noise, a.seed, a.step, a.slab, r, 4 * g, a.D), 4 * g, a.D);
  zz = half_warp_sum(zz);
  if (valid && rs.lane16 == 0) {
    z_sum += sqrtf(zz);
    g_sum += sqrtf(sl.score_sq);
  }
}

// x <- x + st*score + amp*z on the row: the first group from the slot, the
// rest reloaded and redrawn.
__device__ __forceinline__ void update(const Args& a, const Rows& rs, int j, const Slot& sl,
                                       float st, float amp) {
  const int r = rs.row(j);
  if (r >= rs.end) return;
  for (int g = rs.lane16; 4 * g < a.D; g += 16) {
    const bool first = g == rs.lane16;
    const float4 z = first ? sl.z : group_normals(a.noise, a.seed, a.step, a.slab, r, 4 * g, a.D);
    const float4 xv = first ? sl.x : load4(a.x, r, 4 * g, a.D);
    const float4 sv = first ? sl.s : load4(a.score, r, 4 * g, a.D);
    const float zs[4] = {z.x, z.y, z.z, z.w}, xs[4] = {xv.x, xv.y, xv.z, xv.w},
                ss[4] = {sv.x, sv.y, sv.z, sv.w};
    float* xr = a.x + static_cast<size_t>(r) * a.D + 4 * g;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (4 * g + u < a.D) xr[u] = xs[u] + st * ss[u] + amp * zs[u];
  }
}

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
langevin_update_kernel(float* x, const float* __restrict__ score,
                       const float* __restrict__ score_sq, const float* __restrict__ coefs,
                       int step, float snr, const float* __restrict__ noise,
                       const unsigned long long* __restrict__ seed, int slab, float* step_out,
                       int B, int D) {
  __shared__ float red_g[N_WARPS], red_z[N_WARPS];
  __shared__ float2 sums[CLUSTER];  // each CTA's (sum sqrt(score_sq), sum |z|), by rank
  __shared__ uint64_t sums_bar;      // counts the CLUSTER pushed sums in

  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const uint32_t bar = dposer::smem_u32(&sums_bar);
  if (threadIdx.x == 0) {
    dposer::mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    dposer::mbar_expect_tx(bar, CLUSTER * sizeof(float2));
  }
  // the barrier is set up; every CTA waits on this before its first push
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");

  // the seed in device memory: each thread loads it once, before its draws
  const Args a{x, score, score_sq, noise, dposer::load_seed(seed), step, slab, D};
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int per_cta = (B + CLUSTER - 1) / CLUSTER;
  Rows rs;
  rs.begin = rank * per_cta;
  rs.end = min(B, rs.begin + per_cta);
  rs.half = threadIdx.x / 16;
  rs.lane16 = lane & 15;
  // the warp's loops run while its first half has a row: uniform per warp
  const int warp_rows = rs.end - (rs.begin + 2 * warp);
  const int n_slots = warp_rows > 0 ? (warp_rows + N_HALVES - 1) / N_HALVES : 0;
  const float alpha = coefs[static_cast<size_t>(step) * N_COEFS + 4];

  // the kept rows' loads and draws first (independent of each other), then
  // their norms; rows past CACHED fetch into a scratch slot, twice
  Slot kept[CACHED];
#pragma unroll
  for (int j = 0; j < CACHED; ++j)
    if (j < n_slots) fetch(a, rs, j, kept[j]);
  float g_sum = 0.0f, z_sum = 0.0f;
#pragma unroll
  for (int j = 0; j < CACHED; ++j)
    if (j < n_slots) norms(a, rs, j, kept[j], g_sum, z_sum);
  for (int j = CACHED; j < n_slots; ++j) {
    Slot sl;
    fetch(a, rs, j, sl);
    norms(a, rs, j, sl, g_sum, z_sum);
  }

  // the CTA's sums: the two halves of each warp, then the warps in order
  g_sum += __shfl_down_sync(0xffffffffu, g_sum, 16);
  z_sum += __shfl_down_sync(0xffffffffu, z_sum, 16);
  if (lane == 0) {
    red_g[warp] = g_sum;
    red_z[warp] = z_sum;
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  if (threadIdx.x < CLUSTER) {  // thread q pushes the CTA's sums to CTA q
    float g = 0.0f, zn = 0.0f;
    for (int w = 0; w < N_WARPS; ++w) {
      g += red_g[w];
      zn += red_z[w];
    }
    dposer::st_async(dposer::mapa(dposer::smem_u32(&sums[rank]), threadIdx.x),
                     make_float2(g, zn), dposer::mapa(bar, threadIdx.x));
  }
  dposer::mbar_wait_cluster(bar, 0);  // every CTA's sums are here

  float g = 0.0f, zn = 0.0f;
#pragma unroll
  for (int q = 0; q < CLUSTER; ++q) {
    g += sums[q].x;
    zn += sums[q].y;
  }
  const float ratio = snr * (zn / B) / (g / B);
  const float st = ratio * ratio * 2.0f * alpha;
  if (rank == 0 && threadIdx.x == 0 && step_out != nullptr) *step_out = st;
  const float amp = sqrtf(2.0f * st);

#pragma unroll
  for (int j = 0; j < CACHED; ++j)
    if (j < n_slots) update(a, rs, j, kept[j], st, amp);
  for (int j = CACHED; j < n_slots; ++j) {
    Slot sl;
    fetch(a, rs, j, sl);
    update(a, rs, j, sl, st, amp);
  }
}

// A cluster of 16 CTAs is past the portable 8, so the kernel allows it
// explicitly, once.
cudaError_t allow_cluster() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      langevin_update_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return attr;
}

}  // namespace

// x [B, D] fp32 updated in place; score [B, D], score_sq [B] from head_em's
// score mode; coefs [N, 8] (column 4: alpha); noise [B, D] (nullable: drawn
// in-kernel from *seed/step/slab, seed in device memory, null with noise);
// step_out (nullable) receives the step size. B <= 12288. Returns
// cudaGetLastError().
extern "C" int dposer_langevin_update(float* x, const float* score, const float* score_sq,
                                      const float* coefs, int step, float snr,
                                      const float* noise, const unsigned long long* seed,
                                      int slab, float* step_out, int B, int D, void* stream) {
  if (B <= 0 || D <= 0 || B > 12288) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t attr = allow_cluster();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  langevin_update_kernel<<<CLUSTER, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, score, score_sq, coefs, step, snr, noise, seed, slab, step_out, B, D);
  return static_cast<int>(cudaGetLastError());
}

// The launch, for reports: grid CTAs (one cluster), cluster size, threads
// and dynamic shared memory a CTA, and the clusters the current device holds
// at once. Returns 0 or a CUDA error code.
extern "C" int dposer_langevin_update_launch_info(int* out) {
  const cudaError_t attr = allow_cluster();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute cl;
  cl.id = cudaLaunchAttributeClusterDimension;
  cl.val.clusterDim.x = CLUSTER;
  cl.val.clusterDim.y = 1;
  cl.val.clusterDim.z = 1;
  cfg.gridDim = dim3(CLUSTER);
  cfg.blockDim = dim3(THREADS);
  cfg.attrs = &cl;
  cfg.numAttrs = 1;
  int clusters = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(&clusters, langevin_update_kernel, &cfg);
  out[0] = CLUSTER;
  out[1] = CLUSTER;
  out[2] = THREADS;
  out[3] = 0;
  out[4] = clusters;
  return static_cast<int>(e);
}
