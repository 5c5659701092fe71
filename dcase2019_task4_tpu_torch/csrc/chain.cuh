// Device code shared by the fused-block kernels (fused_block.cu) and the
// entry-block kernels (entry_block.cu): the counter-based dropout generator,
// its four-channel draw (keep_values4) and the sigmoid. Both families key the mask on
// (seed, global element index of the [B, T, F, C] activation), so a fused
// entry block with a seed drops exactly what conv -> fused block drops with
// that seed, and ops/fused_block.py:dropout_keep_mask is the CPU twin of all
// of them.
//
// Two draws (a mode bit of the kernels, DCASE_DROPOUT_PACK in
// ops/fused_block.py; the JAX package's _dropout_mask, fused_block.py:146):
//   32-bit: element e keeps iff word e % 4 of Philox(e / 4) >= threshold
//           (min(rate * 2^32, 2^32 - 1));
//   packed: element e keeps iff byte e % 4 of word (e / 4) % 4 of
//           Philox(e / 16) >= threshold (t8 = min(round(rate * 256), 255)):
//           one 32-bit word covers four neighbouring channels, as one TPU
//           word covers four elements.
// Kept values are scaled by keep_scale = 1 / (1 - rate) in both draws. The
// packed draw keeps the mask free of tiling too; its kernels call Philox once
// for each group of four elements, as the 32-bit draw does, and keep one word
// of the four (the generator is a few percent of a fused kernel's work on this
// card, so sharing one call across sixteen elements is left for later).

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

// A kernel's dropout. mode 0: none; 1: 32-bit draw; 2: packed 8-bit draw.
struct Dropout {
  const long long* seed;  // one int64 in device memory (read only when mode != 0)
  uint32_t threshold;     // keep iff the element's random value >= threshold
  float keep_scale;       // 1 / (1 - rate)
  int mode;
};

// The C entries' dropout arguments: threshold 0 without `packed` means no
// dropout; with `packed` the dropout is on whatever t8 is (t8 = 0 keeps every
// element and still scales it).
inline Dropout dropout_of(const void* seed, unsigned int threshold, float keep_scale, int packed) {
  return Dropout{static_cast<const long long*>(seed), threshold, keep_scale,
                 packed ? 2 : (threshold != 0u ? 1 : 0)};
}

__device__ __forceinline__ unsigned long long seed_of(const Dropout& d) {
  return d.mode != 0 ? (unsigned long long)d.seed[0] : 0ull;
}

// The random values that decide the four elements whose first has the global
// element index `element` (a multiple of 4).
__device__ __forceinline__ uint4 keep_values4(long long element, unsigned long long seed, int mode) {
  if (mode != 2) return philox4x32_10((unsigned long long)element >> 2, seed);
  const uint4 r = philox4x32_10((unsigned long long)element >> 4, seed);
  const int q = (int)((element >> 2) & 3);
  const uint32_t w = q == 0 ? r.x : q == 1 ? r.y : q == 2 ? r.z : r.w;
  return make_uint4(w & 0xFFu, (w >> 8) & 0xFFu, (w >> 16) & 0xFFu, w >> 24);
}

}  // namespace
