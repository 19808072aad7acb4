// Shared device helpers for the reverse-diffusion kernels: warp sums and the
// counter-based normal draw that replaces the TPU's on-core PRNG
// (dposer_tpu/ops/pallas/score_net.py::box_muller).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace dposer {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Philox-4x32-10 (Salmon et al., SC'11): ten rounds of a keyed bijection on
// a 128-bit counter; every (counter, key) gives independent 32-bit words.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

// Standard normal for element (row, col) of noise slab `slab` at sampler
// step `step` (Box-Muller, cos branch). The counter names the element, so
// any thread can redraw it, and no two steps or slabs share a stream.
__device__ __forceinline__ float philox_normal(unsigned long long seed, int step,
                                               int slab, int row, int col) {
  const uint4 ctr = make_uint4(static_cast<uint32_t>(col), static_cast<uint32_t>(row),
                               static_cast<uint32_t>(step), static_cast<uint32_t>(slab));
  const uint2 key = make_uint2(static_cast<uint32_t>(seed),
                               static_cast<uint32_t>(seed >> 32));
  const uint4 r = philox4x32_10(ctr, key);
  const float u1 = static_cast<float>((r.x >> 8) + 1u) * (1.0f / 16777216.0f);  // (0, 1]
  const float u2 = static_cast<float>(r.y >> 8) * (1.0f / 16777216.0f);         // [0, 1)
  return sqrtf(-2.0f * logf(u1)) * cospif(2.0f * u2);
}

// Four standard normals for elements (row, col0 .. col0+3) of noise slab
// `slab` at sampler step `step`: one Philox call, both Box-Muller branches of
// two uniform pairs. The counter names the group, so a second pass can
// redraw it.
__device__ __forceinline__ float4 philox_normal4(unsigned long long seed, int step, int slab,
                                                 int row, int col0) {
  const uint4 ctr = make_uint4(static_cast<uint32_t>(col0 / 4), static_cast<uint32_t>(row),
                               static_cast<uint32_t>(step), static_cast<uint32_t>(slab));
  const uint2 key = make_uint2(static_cast<uint32_t>(seed),
                               static_cast<uint32_t>(seed >> 32));
  const uint4 r = philox4x32_10(ctr, key);
  const float scale = 1.0f / 16777216.0f;
  const float ra = sqrtf(-2.0f * logf(static_cast<float>((r.x >> 8) + 1u) * scale));
  const float rb = sqrtf(-2.0f * logf(static_cast<float>((r.z >> 8) + 1u) * scale));
  float sa, ca, sb, cb;
  sincospif(2.0f * static_cast<float>(r.y >> 8) * scale, &sa, &ca);
  sincospif(2.0f * static_cast<float>(r.w >> 8) * scale, &sb, &cb);
  return make_float4(ra * ca, ra * sa, rb * cb, rb * sb);
}

// The step's normal for element (row, col): the host-supplied slab
// [B, D] when `noise` is given, else the in-kernel draw.
__device__ __forceinline__ float draw_normal(const float* noise, unsigned long long seed,
                                             int step, int slab, int row, int col, int D) {
  return noise != nullptr ? noise[static_cast<size_t>(row) * D + col]
                          : philox_normal(seed, step, slab, row, col);
}

}  // namespace dposer
