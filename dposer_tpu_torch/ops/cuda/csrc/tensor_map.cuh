// Host side of the TMA copies: 2-D tensor maps with the 128-byte swizzle,
// encoded with cuTensorMapEncodeTiled (found with cudaGetDriverEntryPoint,
// so no -lcuda) and cached by (pointer, dims, stride, box), since the
// samplers' loops launch with a handful of maps: each is encoded once. Used
// by the Hopper main loops (dense_wgmma*.cuh, K7's) and head_cluster.cuh (K2,
// K8, K9, K11). One cache a library (translation unit).
#pragma once

#include <cstdint>
#include <mutex>

#include <cuda.h>
#include <cuda_runtime.h>

namespace dposer {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                : nullptr;
  }();
  return fn;
}

struct MapKey {
  const void* ptr;
  uint64_t dim0, dim1, stride;
  uint32_t box0, box1;
  int dtype;
};

struct MapCache {
  static constexpr int SLOTS = 64;
  MapKey key[SLOTS];
  CUtensorMap map[SLOTS];
  int used = 0, next = 0;
  long long encodes = 0;
  std::mutex mu;
};

inline MapCache& map_cache() {
  static MapCache cache;
  return cache;
}

// A 2-D row-major map (dim0 contiguous) with the 128-byte swizzle, from the
// cache or encoded into it. Returns 0 or a CUDA error code.
inline int tensor_map(CUtensorMap* out, const void* ptr, CUtensorMapDataType dtype,
                      int elem_bytes, uint64_t dim0, uint64_t dim1, uint32_t box0,
                      uint32_t box1) {
  const MapKey k{ptr, dim0, dim1, dim0 * elem_bytes, box0, box1, static_cast<int>(dtype)};
  MapCache& c = map_cache();
  std::lock_guard<std::mutex> lock(c.mu);
  for (int i = 0; i < c.used; ++i) {
    const MapKey& h = c.key[i];
    if (h.ptr == k.ptr && h.dim0 == k.dim0 && h.dim1 == k.dim1 && h.stride == k.stride &&
        h.box0 == k.box0 && h.box1 == k.box1 && h.dtype == k.dtype) {
      *out = c.map[i];
      return 0;
    }
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[2] = {dim0, dim1};
  const cuuint64_t strides[1] = {k.stride};
  const cuuint32_t box[2] = {box0, box1};
  const cuuint32_t elem[2] = {1, 1};
  const int slot = c.used < MapCache::SLOTS ? c.used++ : (c.next++ % MapCache::SLOTS);
  const CUresult r = encode(&c.map[slot], dtype, 2, const_cast<void*>(ptr), dims, strides, box,
                            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) {
    c.key[slot].ptr = nullptr;  // never matches: the slot holds no valid map
    return static_cast<int>(cudaErrorInvalidValue);
  }
  c.key[slot] = k;
  ++c.encodes;
  *out = c.map[slot];
  return 0;
}

}  // namespace dposer
