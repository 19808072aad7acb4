// The output head of the score network split over a thread-block cluster,
// for K2 head_em, K6 head_adam, K8 head_rk4, K9 head_rk4_jvp and K11
// head_dsm, every kernel that fuses an update into the head:
//   out[r, c] = sum_k bf16_rne(h[r, k]) * Wpost[k, c] + bpost[c]
// with h [B, H] fp32 or bf16, Wpost bf16 [H, 64] (zero-padded columns),
// fp32 sums.
//
// Bound on the H100: at [500, 1024] x [1024, 63] the head reads 2 MB of h
// once and does 64.5 MFLOP (~0.07 us of bf16 tensor-core time): bytes. One
// block a 16-row tile, the heads' first design, gave 32 blocks at 500 rows,
// a quarter of the 132 SMs, each staging 64 KB through registers before its
// first MMA.
//
// A tile is one mma row tile of ROWS = 16 rows. Tile<SPLIT, PAIR, A> says
// how it is cut and what its rows hold: SPLIT CTAs a cluster, whether its
// rows are 16 poses of h (K2, K6, K8, K11) or a PAIR, 8 poses of h at rows 0-7
// and the same poses' tangent dh at rows 8-15 (K9: the forward-mode head of
// the likelihood, whose epilogue needs out and dout of a pose together; the
// m16n8k16 A fragment then puts a pose's primal and tangent rows in one
// thread, rows g and g + 8), and the rows' type A: fp32 (K2, K6, K8, K9), which
// the MMA warps round to bf16 in registers, or bf16 already rounded (K11 on
// the train step's stash, which is bf16_rne(h) bit for bit), copied at half
// the bytes and loaded as packed pairs.
//
// Design (split-K over a cluster):
// - A cluster of SPLIT CTAs owns one tile; CTA `rank` takes the depth slice
//   [rank * H/SPLIT, (rank + 1) * H/SPLIT). At 500 rows K2's grid is 32
//   tiles x 4 = 128 CTAs, each reading a 16 KB slice of h and a 32 KB slice
//   of Wpost; at 50 rows K9's is 7 tiles x 8 = 56 CTAs, each 8 KB of h and
//   dh and 16 KB of Wpost.
// - Both slices arrive on one mbarrier. h's (and dh's) by cp.async.bulk, one
//   copy a row (1 KB of fp32 at H = 1024 over 4 CTAs), into rows KC + 8
//   elements apart, so the A fragment loads go without bank conflicts: fp32
//   pairs (8-byte loads; a half-warp's four rows g land on four distinct
//   groups of 8 banks), rounded to bf16 (RNE) in registers as every other
//   path rounds h, or bf16 pairs (4-byte loads at word g * (KC/2 + 4) + t:
//   KC/2 + 4 is 4 times an odd number, so the eight rows g fall on eight
//   distinct groups of 4 banks). Wpost's as one TMA box with the 128-byte
//   swizzle (chunk c of row k at c ^ (k & 7)): its rows are 128 bytes, so
//   an ldmatrix.trans of eight rows at one column would otherwise hit one
//   bank group eight times. The tensor map is encoded once a pointer
//   (tensor_map.cuh). Each warp copying its own rows with 16-byte cp.async
//   into the same swizzle landed later. At 500 rows K2's 128 CTAs read 6 MB
//   from L2 (4 MB of it Wpost, each CTA its slice), and that bounds the
//   copies.
// - Each of the 4 MMA warps takes every 4th k-step of the slice across all 8
//   column tiles (8 independent accumulators).
// - 4 more warps load the epilogue's operands (and K2 draws its normals:
//   in the MMA warps the Philox draws delayed the MMAs or the finish,
//   wherever they went) while the copies fly, then wait for the rows' partials
//   and finish them.
// - The CTA of rank q finishes poses [q*PPC, (q+1)*PPC) of the tile (PPC =
//   poses / SPLIT), with their tangent rows for a PAIR. Each CTA adds its
//   warps' partials in warp order in its own shared memory, then stores each
//   row of the sum straight into the finishing CTA's shared memory (DSMEM)
//   with st.async, at [its rank], each 16-byte store counted in on that
//   CTA's partials mbarrier, which expects all SPLIT of them. CTA q waits on
//   that barrier alone and adds them in rank order: no atomics, the same bits
//   on every run. No cluster barrier waits on the data: the one cluster
//   barrier, arrived at (relaxed) once the mbarriers are set up and waited on
//   before the first push, makes sure every peer's mbarriers exist. A CTA may
//   exit once its rows are done: every byte sent to it has arrived, and it
//   reads no peer.
// - Measured on the card at 500 rows and kept out for K2: 8 CTAs a cluster
//   (24 KB a CTA, 256 CTAs), 8 warps a CTA, warps owning 16 columns over the
//   whole slice (a longer MMA chain), 32-row tiles over 8 CTAs, reading the
//   partials from the peers (two cluster barriers), plain remote stores
//   published by a cluster barrier, and st.async of each warp's partial
//   (4x the pushes) were each slower. K9 takes 8 CTAs a cluster (56 CTAs at
//   50 rows, where 4 gives 28 and was slower, PERF.md) wherever H allows.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mbarrier.cuh"
#include "tensor_map.cuh"

namespace dposer {
namespace head_cluster {

namespace cg = cooperative_groups;

constexpr int ROWS = 16;  // rows of a tile: one mma row tile
constexpr int DP = 64;    // padded output width of Wpost / bpost
constexpr int MMA_WARPS = 4;  // warps 0-3: the copies' wait, the MMAs and the push
constexpr int EPI_WARPS = 4;  // warps 4-7: the epilogue's loads and draws, then the rows
constexpr int THREADS = 32 * (MMA_WARPS + EPI_WARPS);
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int P_LD = DP + 8;  // row stride of a warp's partial (floats): conflict-free stores
constexpr int P_BYTES = MMA_WARPS * ROWS * P_LD * 4;  // the warps' partials [warp][ROWS][P_LD]
// the partials a CTA receives for its rows: [SPLIT ranks][ROWS / SPLIT][DP],
// ROWS x DP floats whatever the split
constexpr int RECV_BYTES = ROWS * DP * 4;

static_assert(ROWS * DP / 4 == 2 * MMA_THREADS, "the push: two float4 a thread");

template <int SPLIT_, bool PAIR_ = false, class A_ = float>
struct Tile {
  static constexpr int SPLIT = SPLIT_;  // CTAs a cluster, each a 1/SPLIT slice of the depth
  static constexpr bool PAIR = PAIR_;
  using A = A_;  // the rows' type: float (rounded in registers) or __nv_bfloat16
  static_assert(std::is_same_v<A, float> || std::is_same_v<A, __nv_bfloat16>,
                "rows of fp32 or bf16");
  static constexpr int POSES = PAIR ? ROWS / 2 : ROWS;  // poses a tile
  static constexpr int PPC = POSES / SPLIT;             // poses a CTA finishes
  static constexpr int ROWS_PER_CTA = ROWS / SPLIT;     // rows a CTA finishes
  static_assert(PPC >= 1 && PPC <= EPI_WARPS, "an epilogue warp finishes one pose");

  // The CTA that finishes tile row r, and r's row among the rows it
  // receives: its poses' primal rows, then (PAIR) their tangent rows.
  __device__ static __forceinline__ int owner(int r) { return (r % POSES) / PPC; }
  __device__ static __forceinline__ int local(int r) {
    return (r / POSES) * PPC + (r % POSES) % PPC;
  }
};

// Shared memory of a CTA for depth slice KC = H / SPLIT, from the first
// 1024-byte boundary (the swizzle's atom): the swizzled Wpost slice [KC][64]
// bf16, the tile's slice [ROWS][KC + 8] of T::A, its warps' partials, the
// partials of its rows that the cluster sends it, and two mbarriers: the
// copies' and the received partials'.
__host__ __device__ constexpr int w_bytes(int KC) { return KC * DP * 2; }
__host__ __device__ constexpr int a_ld(int KC) { return KC + 8; }  // elements
template <class T>
__host__ __device__ constexpr int a_bytes(int KC) {
  return ROWS * a_ld(KC) * static_cast<int>(sizeof(typename T::A));
}
template <class T>
inline size_t smem_bytes(int H) {
  const int KC = H / T::SPLIT;
  return 1024 + w_bytes(KC) + a_bytes<T>(KC) + P_BYTES + RECV_BYTES + 16;
}

template <class T>
struct Layout {
  unsigned char* w;  // 1024-byte aligned
  typename T::A* a;
  float* part;  // the warps' partials
  float* recv;  // the received CTA partials
  uint64_t* bar;  // [0] the copies, [1] the received partials
  __device__ __forceinline__ Layout(unsigned char* smem, int H) {
    const int KC = H / T::SPLIT;
    w = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
    a = reinterpret_cast<typename T::A*>(w + w_bytes(KC));
    part = reinterpret_cast<float*>(a + ROWS * a_ld(KC));
    recv = part + P_BYTES / 4;
    bar = reinterpret_cast<uint64_t*>(recv + RECV_BYTES / 4);
  }
};

template <class T>
inline int grid_blocks(int B) {
  return (B + T::POSES - 1) / T::POSES * T::SPLIT;
}

// H a multiple of 16 * SPLIT and <= 1024 (so a slice is whole k-steps), h
// and Wpost 16-byte aligned, D <= 64.
template <class T>
inline bool operands_ok(const void* h, const void* Wpost, int B, int H, int D) {
  return B > 0 && H > 0 && H % (16 * T::SPLIT) == 0 && H <= 1024 && D > 0 && D <= DP &&
         reinterpret_cast<uintptr_t>(h) % 16 == 0 && reinterpret_cast<uintptr_t>(Wpost) % 16 == 0;
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a * b, m16n8k16, bf16 in, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float2 v) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.x, v.y);  // .x in the low half
  return *reinterpret_cast<const uint32_t*>(&b);
}

// Arrive without ordering memory: "this CTA has started".
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Set up this CTA's two mbarriers and start its copies for the tile whose
// first pose is pose0: Wpost's slice as one TMA box with the 128-byte
// swizzle (chunk c of row k at c ^ (k & 7)), the rows' slices as one bulk
// copy a row of KC elements of T::A (tile row r is h's row pose0 + r, or for
// a PAIR h's row pose0 + r below POSES and dh's row pose0 + r - POSES from
// there); rows past the batch's end are zeroed. The partials' barrier
// expects RECV_BYTES. Every thread calls it, then arrives on the cluster
// barrier (cluster_arrive_relaxed: the barriers are initialized), may issue
// its own loads, and must pass a __syncthreads() before send_partials.
// Dep (mbarrier.cuh) is called by warp 0 between Wpost's box and the rows'
// copies: a programmatic launch fetches its weights under the tail of the
// launch before it. Warp 0 then waits; no other MMA warp reads or writes
// global memory, and the epilogue warps wait on their own, after loading
// the launch's constants, before they read what earlier launches wrote.
template <class T, class Dep = Serial>
__device__ __forceinline__ void start_copies(const typename T::A* __restrict__ h,
                                             const typename T::A* __restrict__ dh,
                                             const CUtensorMap* tmW, const Layout<T>& L,
                                             int pose0, int rank, int B, int H) {
  using A = typename T::A;
  constexpr int A_BYTES = static_cast<int>(sizeof(A));
  const int KC = H / T::SPLIT, k0 = rank * KC, ald = a_ld(KC);
  const int lane = threadIdx.x % 32;
  const uint32_t bar = smem_u32(L.bar), recv_bar = smem_u32(L.bar + 1);
  const int poses = min(T::POSES, B - pose0);
  const int gaps = T::POSES - poses;  // zeroed rows at the end of each half of the tile
  if (threadIdx.x < 32) {
    if (lane == 0) {
      mbar_init(bar, 1);
      mbar_init(recv_bar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      mbar_expect_tx(recv_bar, static_cast<uint32_t>(RECV_BYTES));
      mbar_expect_tx(bar,
                     static_cast<uint32_t>(w_bytes(KC) + (ROWS / T::POSES) * poses * KC * A_BYTES));
      tma_load(smem_u32(L.w), tmW, bar, 0, k0);
    }
    __syncwarp();
    Dep{}();
    if (lane < ROWS && lane % T::POSES < poses) {
      const A* src = T::PAIR && lane >= T::POSES ? dh : h;
      bulk_copy(smem_u32(L.a + lane * ald), src + static_cast<size_t>(pose0 + lane % T::POSES) * H + k0,
                static_cast<uint32_t>(KC * A_BYTES), bar);
    }
  }
  const A zero = 0.0f;
#pragma unroll
  for (int half = 0; half < ROWS / T::POSES; ++half)
    for (int i = threadIdx.x; i < gaps * KC; i += THREADS)
      L.a[(half * T::POSES + poses + i / KC) * ald + i % KC] = zero;
}

// Warps 0 .. MMA_WARPS-1, after start_copies, the relaxed cluster arrive
// and a __syncthreads(): the
// CTA's partial sums of the tile over its depth slice (each warp's k-steps,
// then the warps added in order), each row's sent to the CTA that finishes
// the row (T::owner), into that CTA's received partials at [this rank]
// (row T::local), counted in on that CTA's partials barrier (st.async). It
// waits on the cluster barrier before the first push: every peer's barriers
// are initialized. Then wait_partials, and out_at reads this CTA's rows from
// its own shared memory.
template <class T>
__device__ __forceinline__ void send_partials(const Layout<T>& L, int rank, int H) {
  const int KC = H / T::SPLIT, ald = a_ld(KC);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint32_t w_s = smem_u32(L.w);
  mbar_wait(smem_u32(L.bar), 0);

  float acc[8][4] = {};
  const int g = lane / 4, t = lane % 4;
#pragma unroll 4
  for (int s = warp; s < KC / 16; s += MMA_WARPS) {
    const int kk = 16 * s;
    const typename T::A* lo = L.a + g * ald + kk + 2 * t;  // row g; row g + 8 is 8 * ald on
    uint32_t a[4];
    if constexpr (std::is_same_v<typename T::A, float>) {
      a[0] = pack_bf16(*reinterpret_cast<const float2*>(lo));
      a[1] = pack_bf16(*reinterpret_cast<const float2*>(lo + 8 * ald));
      a[2] = pack_bf16(*reinterpret_cast<const float2*>(lo + 8));
      a[3] = pack_bf16(*reinterpret_cast<const float2*>(lo + 8 * ald + 8));
    } else {  // bf16 pairs, the lower column in the low half as the mma takes them
      a[0] = *reinterpret_cast<const uint32_t*>(lo);
      a[1] = *reinterpret_cast<const uint32_t*>(lo + 8 * ald);
      a[2] = *reinterpret_cast<const uint32_t*>(lo + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(lo + 8 * ald + 8);
    }
    // ldmatrix.x4.trans: lanes 0-15 address rows kk..kk+15 of column tile
    // 2p, lanes 16-31 the same rows of tile 2p + 1
    const int r = kk + (lane & 15);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int c = 2 * p + (lane >> 4);
      uint32_t b[4];
      ldmatrix_x4_trans(b, w_s + r * 128 + ((c ^ (r & 7)) << 4));
      mma_bf16(acc[2 * p], a, b[0], b[1]);
      mma_bf16(acc[2 * p + 1], a, b[2], b[3]);
    }
  }
  // the CTA's partial: the warps' sums added in warp order
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float* p = L.part + (warp * ROWS + g) * P_LD + 8 * j + 2 * t;
    *reinterpret_cast<float2*>(p) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(p + 8 * P_LD) = make_float2(acc[j][2], acc[j][3]);
  }
  asm volatile("bar.sync 1, %0;" ::"n"(MMA_THREADS) : "memory");  // the MMA warps only
  cluster_wait();  // every peer's barriers are initialized
  // float4 f (of 16 a row) of row f / 16, for f = tid and tid + MMA_THREADS:
  // summed, then sent to the CTA that finishes the row
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int f = threadIdx.x + MMA_THREADS * u, row = f / 16, col = 4 * (f % 16);
    float4 v = *reinterpret_cast<const float4*>(L.part + row * P_LD + col);
#pragma unroll
    for (int w = 1; w < MMA_WARPS; ++w) {
      const float4 o = *reinterpret_cast<const float4*>(L.part + (w * ROWS + row) * P_LD + col);
      v.x += o.x;
      v.y += o.y;
      v.z += o.z;
      v.w += o.w;
    }
    const int owner = T::owner(row);
    st_async(mapa(smem_u32(L.recv + (rank * T::ROWS_PER_CTA + T::local(row)) * DP + col), owner),
             v, mapa(smem_u32(L.bar + 1), owner));
  }
}

// Wait until every partial of this CTA's rows has arrived.
template <class T>
__device__ __forceinline__ void wait_partials(const Layout<T>& L) {
  mbar_wait_cluster(smem_u32(L.bar + 1), 0);
}

// Element (lr, c) of the rows this CTA finishes (lr = T::local of the tile
// row), after wait_partials: the bias (bpost[c], or 0 for a tangent row),
// then the received CTA partials in rank order.
template <class T>
__device__ __forceinline__ float out_at(const Layout<T>& L, float bias, int lr, int c) {
  float v = bias;
#pragma unroll
  for (int q = 0; q < T::SPLIT; ++q) v += L.recv[(q * T::ROWS_PER_CTA + lr) * DP + c];
  return v;
}

// Host side: Wpost [H, 64] bf16 as a tensor map of [H/SPLIT, 64] boxes,
// from the library's map cache. Returns 0 or a CUDA error code.
template <class T>
inline int wpost_map(CUtensorMap* out, const void* Wpost, int H) {
  return tensor_map(out, Wpost, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, DP, H, DP, H / T::SPLIT);
}

// The launch of KERNEL (a Tile T kernel) at B rows and depth H, for reports:
// grid CTAs, cluster size, threads a CTA, dynamic shared memory a CTA, and
// the clusters the current device can hold at once
// (cudaOccupancyMaxActiveClusters). Returns 0 or a CUDA error code.
template <class T, class Kernel>
inline int launch_info(Kernel kernel, int B, int H, int* out) {
  out[0] = grid_blocks<T>(B);
  out[1] = T::SPLIT;
  out[2] = THREADS;
  out[3] = static_cast<int>(smem_bytes<T>(H));
  return static_cast<int>(
      active_clusters(&out[4], kernel, dim3(out[0]), THREADS, out[3], T::SPLIT));
}

}  // namespace head_cluster
}  // namespace dposer
