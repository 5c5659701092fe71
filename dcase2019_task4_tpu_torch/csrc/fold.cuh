// Fixed-order fold of per-block partial sums, shared by the kernels whose TPU
// originals carry an accumulator across the sequential Pallas grid
// (fused_block.py dw/db/s1/s2 and sum/sq refs, packed_conv.py dparts/db
// refs). On the card blocks run in no order, so each block writes its sums to
// its own slot and this kernel adds the slots in slot order, in double: no
// float atomics, and a run repeats bit for bit.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kFoldThreads = 256;

// out[k] = sum over s = 0 .. slots-1, in that order, of partials[s][k].
template <typename TIn>
__global__ void __launch_bounds__(kFoldThreads)
fold_kernel(const TIn* __restrict__ partials, float* __restrict__ out, int slots, int width) {
  const int k = blockIdx.x * kFoldThreads + threadIdx.x;
  if (k >= width) return;
  double t = 0.0;
  for (int s = 0; s < slots; ++s) t += (double)partials[(long long)s * width + k];
  out[k] = (float)t;
}

template <typename TIn>
cudaError_t launch_fold(const TIn* partials, float* out, int slots, int width,
                        cudaStream_t stream) {
  fold_kernel<TIn><<<(width + kFoldThreads - 1) / kFoldThreads, kFoldThreads, 0, stream>>>(
      partials, out, slots, width);
  return cudaGetLastError();
}

}  // namespace
