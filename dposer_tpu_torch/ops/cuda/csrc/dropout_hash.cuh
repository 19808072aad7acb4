// The training kernels' dropout mask as a counter-based hash of
// (seed, layer, row, column), so that the backward kernel regenerates the
// forward kernel's mask without a stash (the TPU train kernel re-seeds its
// on-core PRNG per block and layer for the same reason,
// dposer_tpu/ops/pallas/fused_train.py::_make_kernel mask_for).
//
// Every step is murmur3's 32-bit finaliser (fmix32) on XORs and products
// taken modulo 2^32, so the plain PyTorch version
// (ops/cuda/fused_train.py::dropout_keep) computes the same bits in int64
// arithmetic. An element is kept when the top 24 bits of its hash lie below
// keep_thresh = round(keep * 2^24); keep_thresh >= 2^24 turns dropout off.
#pragma once

#include <cstdint>

namespace dposer {
namespace dropout {

constexpr uint32_t KEEP_ALL = 1u << 24;
constexpr uint32_t GOLDEN = 0x9E3779B9u;
constexpr uint32_t COL_MUL = 0x85EBCA6Bu;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t layer_key(uint32_t seed, int layer) {
  return fmix32(seed ^ fmix32(static_cast<uint32_t>(layer) + GOLDEN));
}

__device__ __forceinline__ uint32_t row_key(uint32_t lkey, int row) {
  return fmix32(lkey ^ (static_cast<uint32_t>(row) * GOLDEN));
}

__device__ __forceinline__ bool keep(uint32_t rkey, int col, uint32_t keep_thresh) {
  return (fmix32(rkey ^ (static_cast<uint32_t>(col) * COL_MUL)) >> 8) < keep_thresh;
}

}  // namespace dropout
}  // namespace dposer
