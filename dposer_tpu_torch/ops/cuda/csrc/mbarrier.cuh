// PTX wrappers for Hopper's asynchronous copies and the shared-memory
// barriers (mbarriers) that count them in, shared by the Hopper main loops
// dense_wgmma.cuh (K14), dense_wgmma_int8.cuh (K13, K14),
// dense_wgmma_ss.cuh (K1, K10, K12), head_cluster.cuh (K2, K6, K8, K9, K11) and K7's
// (dense_gn_silu_jvp.cu). Addresses are 32-bit
// shared-window addresses (smem_u32). And the launches: launch_cluster, the
// host's launch of a kernel over clusters whose size the launch chooses, and
// programmatic dependent launch (PDL), the overlap of a launch's prologue
// with the tail of the launch before it on the stream (below).
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

// Programmatic dependent launch. A kernel launched with the attribute
// cudaLaunchAttributeProgrammaticStreamSerialization may be scheduled while
// the kernel before it on the stream still runs, once every CTA of that one
// has called launch_dependents() or exited. Its CTAs then run their
// prologue on the SMs that free up, and block in grid_dependency_wait()
// until every kernel before it has completed and its memory is visible.
// So a programmatic kernel reads before its wait only what no launch of its
// stream writes while the loop runs (its weights and tables, built once),
// and waits before its first read of anything an earlier launch wrote and
// before its first global write (the loops reuse their buffers in place).
// A kernel launched without the attribute returns from the wait at once.
// The wait of every launch of a chain makes the chain transitive: a
// launch's completion implies its predecessor's.
// The wait is an asm that names no memory, and the compiler may move a
// load or store through a __restrict__ pointer across it (restrict says
// nothing else touches that memory while the kernel runs): no pointer a
// programmatic kernel reads or writes after its wait is __restrict__, and
// a main loop shared with plain launches reads its operand after the wait
// through after_wait's copy of it.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// `p` passed through an empty asm (after a wait): the compiler cannot
// trace the copy to a __restrict__ parameter, and every access through it
// depends on the asm, so none moves above it.
template <class T>
__device__ __forceinline__ T* after_wait(T* p) {
  asm volatile("" : "+l"(p)::"memory");
  return p;
}

__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// How a kernel follows the launch before it, as a compile-time tag of the
// launch helpers and of the main loops they run. Serial: a plain stream
// launch, which starts once the launch before it has completed; its loops
// call nothing. Programmatic: launched with programmatic stream
// serialization; its loops call the tag between the loads that depend on
// no earlier launch (the weights' first stages) and those that do: the
// wait, then the trigger of the next launch (early: the next launch's own
// wait still orders all memory).
struct Serial {
  static constexpr bool kProgrammatic = false;
  __device__ __forceinline__ void operator()() const {}
};

struct Programmatic {
  static constexpr bool kProgrammatic = true;
  __device__ __forceinline__ void operator()() const {
    grid_dependency_wait();
    launch_dependents();
  }
};

// A launch over `grid`, `threads` a CTA and `smem` bytes of dynamic shared
// memory, on `stream`: in clusters of `cluster` CTAs along x where cluster >
// 0 (0: no cluster attribute; a kernel with __cluster_dims__ keeps its own),
// and with programmatic stream serialization where `programmatic`. `at`
// holds the attributes `cfg` points to.
inline cudaLaunchConfig_t cluster_config(cudaLaunchAttribute (&at)[2], dim3 grid, int threads,
                                         size_t smem, cudaStream_t stream, int cluster,
                                         bool programmatic = false) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = at;
  cfg.numAttrs = 0;
  if (cluster > 0) {
    cudaLaunchAttribute& c = at[cfg.numAttrs++];
    c.id = cudaLaunchAttributeClusterDimension;
    c.val.clusterDim.x = cluster;
    c.val.clusterDim.y = 1;
    c.val.clusterDim.z = 1;
  }
  if (programmatic) {
    cudaLaunchAttribute& p = at[cfg.numAttrs++];
    p.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    p.val.programmaticStreamSerializationAllowed = 1;
  }
  return cfg;
}

// Launch `kernel` so (a kernel without __cluster_dims__: the cluster size is
// the launch's), following the launch before it as Dep says.
template <class Dep = Serial, typename... KArgs, typename... Args>
cudaError_t launch_cluster(void (*kernel)(KArgs...), dim3 grid, int threads, size_t smem,
                           cudaStream_t stream, int cluster, Args... args) {
  cudaLaunchAttribute at[2];
  const cudaLaunchConfig_t cfg =
      cluster_config(at, grid, threads, smem, stream, cluster, Dep::kProgrammatic);
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// Launch `kernel` with programmatic stream serialization and no cluster
// attribute (a kernel with __cluster_dims__ keeps its own clusters).
template <typename... KArgs, typename... Args>
cudaError_t launch_programmatic(void (*kernel)(KArgs...), dim3 grid, int threads, size_t smem,
                                cudaStream_t stream, Args... args) {
  return launch_cluster<Programmatic>(kernel, grid, threads, smem, stream, 0, args...);
}

// The clusters of `kernel` launched so that the current device holds at
// once (cudaOccupancyMaxActiveClusters), into *clusters: for reports.
template <typename Kernel>
cudaError_t active_clusters(int* clusters, Kernel kernel, dim3 grid, int threads, size_t smem,
                            int cluster) {
  cudaLaunchAttribute at[2];
  const cudaLaunchConfig_t cfg = cluster_config(at, grid, threads, smem, nullptr, cluster);
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

}  // namespace dposer
