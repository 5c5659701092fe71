// Fixed-order fold of per-block partial sums, shared by the kernels whose TPU
// originals carry an accumulator across the sequential Pallas grid
// (fused_block.py dw/db/s1/s2 and sum/sq refs, packed_conv.py dparts/db
// refs). On the card blocks run in no order, so each block writes its sums to
// its own slot and this kernel adds the slots in slot order, in double: no
// float atomics, and a run repeats bit for bit.
//
// Where the TPU original rounds a carried sum to bfloat16 in parts before it
// adds the parts (a weight gradient in a lane-packed basis: one part per lane
// copy, or per batch half), fold_classes_kernel keeps one float32 sum per
// part ("class"), rounds each to the compute dtype and adds the rounded sums
// in class order; fold_classes_warps_kernel does so with a warp a column, for
// many slots (one a block of a wave).

#pragma once

#include <cuda_runtime.h>

#include "dtype.cuh"

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

// out[k] = the sum over the slots of partials[s][k], a warp a column: lane l
// adds slots l, l + 32, ... in that order in double, then the warp adds its
// lanes' sums in a fixed tree of shuffles. A fixed order (a run repeats bit
// for bit) with the slots' loads spread over 32 lanes: for many slots
// (one a block of a wave) where fold_kernel's one thread a column waits on
// each load in turn.
template <typename TIn>
__global__ void __launch_bounds__(kFoldThreads)
fold_warps_kernel(const TIn* __restrict__ partials, float* __restrict__ out, int slots, int width) {
  const int k = blockIdx.x * (kFoldThreads / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (k >= width) return;  // the whole warp
  double t = 0.0;
#pragma unroll 4
  for (int s = lane; s < slots; s += 32) t += (double)partials[(long long)s * width + k];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  if (lane == 0) out[k] = (float)t;
}

template <typename TIn>
cudaError_t launch_fold_warps(const TIn* partials, float* out, int slots, int width, cudaStream_t stream) {
  constexpr int kCols = kFoldThreads / 32;
  fold_warps_kernel<TIn><<<(width + kCols - 1) / kCols, kFoldThreads, 0, stream>>>(partials, out, slots, width);
  return cudaGetLastError();
}

// out[k] = sum over classes c = 0 .. classes-1, in that order, of R(sum over
// s = 0 .. slots-1, in that order, in double, of partials[c * class_stride +
// s * slot_stride + k]), where R rounds to TR (and widens back) for
// k < n_round and is the identity after (sums the original keeps in float32).
template <typename TIn, typename TR>
__global__ void __launch_bounds__(kFoldThreads)
fold_classes_kernel(const TIn* __restrict__ partials, float* __restrict__ out, int slots, int width,
                    int classes, long long slot_stride, long long class_stride, int n_round) {
  const int k = blockIdx.x * kFoldThreads + threadIdx.x;
  if (k >= width) return;
  float total = 0.0f;
  for (int c = 0; c < classes; ++c) {
    const TIn* p = partials + c * class_stride + k;
    double t = 0.0;
    for (int s = 0; s < slots; ++s) t += (double)p[s * slot_stride];
    total += k < n_round ? rounded<TR>((float)t) : (float)t;
  }
  out[k] = total;
}

// fold_classes_kernel's function in fold_warps_kernel's order: a warp a
// column; for each class lane l adds slots l, l + 32, ... in that order in
// double, the warp adds its lanes' sums in the fixed tree of shuffles, and
// the class's sum is rounded (k < n_round) and added in class order.
template <typename TIn, typename TR>
__global__ void __launch_bounds__(kFoldThreads)
fold_classes_warps_kernel(const TIn* __restrict__ partials, float* __restrict__ out, int slots, int width,
                          int classes, long long slot_stride, long long class_stride, int n_round) {
  const int k = blockIdx.x * (kFoldThreads / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (k >= width) return;  // the whole warp
  float total = 0.0f;
  for (int c = 0; c < classes; ++c) {
    const TIn* p = partials + c * class_stride + k;
    double t = 0.0;
#pragma unroll 4
    for (int s = lane; s < slots; s += 32) t += (double)p[s * slot_stride];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    total += k < n_round ? rounded<TR>((float)t) : (float)t;
  }
  if (lane == 0) out[k] = total;
}

template <typename TIn, typename TR>
cudaError_t launch_fold_classes_warps(const TIn* partials, float* out, int slots, int width, int classes,
                                      long long slot_stride, long long class_stride, int n_round,
                                      cudaStream_t stream) {
  constexpr int kCols = kFoldThreads / 32;
  fold_classes_warps_kernel<TIn, TR><<<(width + kCols - 1) / kCols, kFoldThreads, 0, stream>>>(
      partials, out, slots, width, classes, slot_stride, class_stride, n_round);
  return cudaGetLastError();
}

template <typename TIn, typename TR>
cudaError_t launch_fold_classes(const TIn* partials, float* out, int slots, int width, int classes,
                                long long slot_stride, long long class_stride, int n_round,
                                cudaStream_t stream) {
  fold_classes_kernel<TIn, TR><<<(width + kFoldThreads - 1) / kFoldThreads, kFoldThreads, 0, stream>>>(
      partials, out, slots, width, classes, slot_stride, class_stride, n_round);
  return cudaGetLastError();
}

}  // namespace
