// PTX wrappers for Hopper's asynchronous copies and the shared-memory
// barriers (mbarriers) that count them in, shared by the Hopper main loops
// dense_wgmma.cuh (K1, K14), dense_wgmma_int8.cuh (K13, K14),
// dense_wgmma_ss.cuh (K10, K12), head_cluster.cuh (K2, K6, K8, K9, K11) and K7's
// (dense_gn_silu_jvp.cu). Addresses are 32-bit
// shared-window addresses (smem_u32). And launch_cluster, the host's launch
// of a kernel over clusters whose size the launch chooses.
#pragma once

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

namespace dposer {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// The same, with acquire at cluster scope: for bytes that cluster peers
// stored with st_async.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Copy `bytes` (a multiple of 16; both addresses 16-byte aligned) from
// global memory into this block's shared memory, counted in on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The address of `addr` (in this block's shared memory) in the shared
// memory of the cluster's block `rank`.
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// Store `v` at `addr` (16-byte aligned) in a cluster peer's shared memory,
// counted in as 16 bytes on the peer's mbarrier `bar` (both addresses from
// mapa); and the same for two floats (8 bytes).
__device__ __forceinline__ void st_async(uint32_t addr, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_async(uint32_t addr, float2 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];" ::"r"(
          addr),
      "f"(v.x), "f"(v.y), "r"(bar)
      : "memory");
}

// Copy the box at (c0, c1) (c0 along the contiguous dimension) of the
// tensor `map` into this block's shared memory, counted in on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// A launch over `grid` in clusters of `cluster` CTAs along x, `threads` a
// CTA and `smem` bytes of dynamic shared memory, on `stream`; `at` holds
// the cluster attribute `cfg` points to.
inline cudaLaunchConfig_t cluster_config(cudaLaunchAttribute& at, dim3 grid, int threads,
                                         size_t smem, cudaStream_t stream, int cluster) {
  at.id = cudaLaunchAttributeClusterDimension;
  at.val.clusterDim.x = cluster;
  at.val.clusterDim.y = 1;
  at.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &at;
  cfg.numAttrs = 1;
  return cfg;
}

// Launch `kernel` so (a kernel without __cluster_dims__: the cluster size is
// the launch's).
template <typename... KArgs, typename... Args>
cudaError_t launch_cluster(void (*kernel)(KArgs...), dim3 grid, int threads, size_t smem,
                           cudaStream_t stream, int cluster, Args... args) {
  cudaLaunchAttribute at;
  const cudaLaunchConfig_t cfg = cluster_config(at, grid, threads, smem, stream, cluster);
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The clusters of `kernel` launched so that the current device holds at
// once (cudaOccupancyMaxActiveClusters), into *clusters: for reports.
template <typename Kernel>
cudaError_t active_clusters(int* clusters, Kernel kernel, dim3 grid, int threads, size_t smem,
                            int cluster) {
  cudaLaunchAttribute at;
  const cudaLaunchConfig_t cfg = cluster_config(at, grid, threads, smem, nullptr, cluster);
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

}  // namespace dposer
