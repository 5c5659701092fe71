// Device code shared by the fused-block kernels (fused_block.cu) and the
// entry-block kernels (entry_block.cu): the counter-based dropout generator,
// the four-channel mask step and the sigmoid. Both families key the mask on
// (seed, global element index of the [B, T, F, C] activation / 4), so a fused
// entry block with a seed drops exactly what conv -> fused block drops with
// that seed, and ops/fused_block.py:dropout_keep_mask is the CPU twin of all
// of them.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint4 philox4x32_10(unsigned long long counter,
                                               unsigned long long seed) {
  uint32_t c0 = (uint32_t)counter, c1 = (uint32_t)(counter >> 32), c2 = 0u, c3 = 0u;
  uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

// Multiply the four values at px (neighbouring channels whose first has the
// global element index `element`, a multiple of 4) by keep-mask * keep_scale.
__device__ __forceinline__ void mask4_at(float* px, long long element, unsigned long long seed,
                                         uint32_t threshold, float keep_scale) {
  const uint4 r = philox4x32_10((unsigned long long)element >> 2, seed);
  px[0] *= r.x >= threshold ? keep_scale : 0.0f;
  px[1] *= r.y >= threshold ? keep_scale : 0.0f;
  px[2] *= r.z >= threshold ? keep_scale : 0.0f;
  px[3] *= r.w >= threshold ? keep_scale : 0.0f;
}

// The same for tile element `e` (a multiple of 4; C % 4 == 0) of a tile that
// is one contiguous run of the activation starting at element `tile_base`.
__device__ __forceinline__ void mask4(float* xs, int CP, int C, int e, long long tile_base,
                                      unsigned long long seed, uint32_t threshold,
                                      float keep_scale) {
  mask4_at(xs + (e / C) * CP + (e % C), tile_base + e, seed, threshold, keep_scale);
}

}  // namespace
