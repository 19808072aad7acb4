// The output head of the score network as device code for a kernel that
// fuses an update into its epilogue: K6 head_adam, its one user (K2, K8, K9
// and K11 run head_cluster.cuh's split-K over a cluster):
//   out[r, c] = sum_k bf16(h[r, k]) * Wpost[k, c] + bpost[c]
//
// A block owns 16 rows and all 64 (zero-padded) output columns. It stages its
// rows of h as bf16 in shared memory with 16-byte loads, all of a thread's
// loads in flight at once. 16 warps split the work 4 column tiles x 4 quarters
// of the depth, each a chain of bf16 WMMA 16x16x16 steps with fp32
// accumulation that reads Wpost from L2; the four partial sums meet in shared
// memory, where the caller's epilogue reads them through `out_at`. The head's
// output never goes to device memory.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace dposer {
namespace head {

constexpr int ROWS = 16;
constexpr int DP = 64;  // padded output width of Wpost / bpost
constexpr int THREADS = 512;
constexpr int N_WARPS = THREADS / 32;
constexpr int K_SPLIT = N_WARPS / (DP / 16);  // 4 quarters of the depth
constexpr int C_LD = DP + 4;
constexpr int STAGE_CHUNK = 8;  // float4 loads a thread keeps in flight

static_assert(K_SPLIT * (DP / 16) == N_WARPS, "warps tile columns x depth");

using Acc = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>;

// Stage rows row0 .. row0+ROWS-1 of h [B, H] as bf16 into As [ROWS][H + 8]:
// 16-byte loads, STAGE_CHUNK in flight. No barrier.
__device__ __forceinline__ void stage_rows(const float* __restrict__ h, __nv_bfloat16* As,
                                           int row0, int B, int H) {
  const int a_ld = H + 8;
  const int tid = threadIdx.x;
  const int h4 = H / 4;
  for (int q0 = tid; q0 < ROWS * h4; q0 += THREADS * STAGE_CHUNK) {
    float4 v[STAGE_CHUNK];
#pragma unroll
    for (int u = 0; u < STAGE_CHUNK; ++u) {
      const int q = q0 + u * THREADS;
      const int r = q / h4, gr = row0 + r;
      v[u] = (q < ROWS * h4 && gr < B)
                 ? *reinterpret_cast<const float4*>(h + static_cast<size_t>(gr) * H + (q % h4) * 4)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < STAGE_CHUNK; ++u) {
      const int q = q0 + u * THREADS;
      if (q < ROWS * h4) {
        auto* dst = reinterpret_cast<__nv_bfloat162*>(As + (q / h4) * a_ld + (q % h4) * 4);
        dst[0] = __floats2bfloat162_rn(v[u].x, v[u].y);
        dst[1] = __floats2bfloat162_rn(v[u].z, v[u].w);
      }
    }
  }
}

// acc = this warp's share of As @ Wpost: warp = (depth quarter kq, column tile ct)
__device__ __forceinline__ void mma_rows(Acc& acc, const __nv_bfloat16* As,
                                         const __nv_bfloat16* __restrict__ Wpost, int H) {
  using namespace nvcuda;
  const int warp = threadIdx.x / 32;
  const int ct = warp % (DP / 16);
  const int kq = warp / (DP / 16);
  const int k_len = H / K_SPLIT;
  const int a_ld = H + 8;
  wmma::fill_fragment(acc, 0.0f);
#pragma unroll 4
  for (int k = kq * k_len; k < (kq + 1) * k_len; k += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
    wmma::load_matrix_sync(b, Wpost + static_cast<size_t>(k) * DP + ct * 16, DP);
    wmma::load_matrix_sync(a, As + k, a_ld);
    wmma::mma_sync(acc, a, b, acc);
  }
}

// This warp's partial sums into the `part`-th [K_SPLIT][ROWS][C_LD] fp32 block of Cs
__device__ __forceinline__ void store_partial(float* Cs, const Acc& acc, int part) {
  const int warp = threadIdx.x / 32;
  const int ct = warp % (DP / 16);
  const int kq = warp / (DP / 16);
  nvcuda::wmma::store_matrix_sync(Cs + (part * K_SPLIT + kq) * ROWS * C_LD + ct * 16, acc, C_LD,
                                  nvcuda::wmma::mem_row_major);
}

// The block's partial sums for rows row0 .. row0+ROWS-1 of h [B, H], left in
// `smem` (smem_bytes(H) bytes, 128-byte aligned) as [K_SPLIT][ROWS][C_LD]
// fp32. Every thread of the block calls it; it ends on a barrier.
__device__ __forceinline__ const float* gemm_tile(const float* __restrict__ h,
                                                  const __nv_bfloat16* __restrict__ Wpost,
                                                  unsigned char* smem, int row0, int B, int H) {
  auto* As = reinterpret_cast<__nv_bfloat16*>(smem);
  auto* Cs = reinterpret_cast<float*>(smem);  // the partial sums, after the MMAs
  Acc acc;
  stage_rows(h, As, row0, B, H);
  __syncthreads();
  mma_rows(acc, As, Wpost, H);
  __syncthreads();  // every warp is done with As: its space takes the partial sums
  store_partial(Cs, acc, 0);
  __syncthreads();
  return Cs;
}

// Element (r, c) of the block's head output, from gemm_tile's partial sums.
__device__ __forceinline__ float out_at(const float* Cs, const float* __restrict__ bpost, int r,
                                        int c) {
  float v = bpost[c];
#pragma unroll
  for (int s = 0; s < K_SPLIT; ++s) v += Cs[s * ROWS * C_LD + r * C_LD + c];
  return v;
}

// Host side: the dynamic shared memory of a block, the grid, and the operand
// checks (H a multiple of 64 and <= 1024, h and Wpost 16-byte aligned, D <= 64).
inline size_t smem_bytes(int H) {
  const size_t a_bytes = static_cast<size_t>(ROWS) * (H + 8) * 2;
  const size_t c_bytes = static_cast<size_t>(K_SPLIT) * ROWS * C_LD * sizeof(float);
  return a_bytes > c_bytes ? a_bytes : c_bytes;
}

inline int grid_blocks(int B) { return (B + ROWS - 1) / ROWS; }

inline bool operands_ok(const void* h, const void* Wpost, int B, int H, int D) {
  return B > 0 && H % (16 * K_SPLIT) == 0 && H <= 1024 && D > 0 && D <= DP &&
         reinterpret_cast<uintptr_t>(h) % 16 == 0 && reinterpret_cast<uintptr_t>(Wpost) % 16 == 0;
}

}  // namespace head
}  // namespace dposer
