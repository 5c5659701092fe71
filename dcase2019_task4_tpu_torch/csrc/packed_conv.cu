// K3 forward: 3x3, stride 1, same-padding convolution on NHWC float32,
// for Hopper (sm_90a).
//
// Replaces: dcase2019_task4_tpu/ops/packed_conv.py:_conv_kernel (via
// _run_conv / conv2d_packed), the Pallas kernel that runs the interior
// convolutions of CRNN blocks 2 and 3 as nine row-shifted matmuls in the
// TPU's lane-packed layout. The packing (kron-embedded part weights, 8-row
// halo blocks, freq-edge row masks) is TPU layout and is not carried over:
// this kernel works on plain NHWC.
//
// Function: out[b,t,f,co] = bias[co]
//   + sum_{dt,df in 0..2} sum_ci x[b, t+dt-1, f+df-1, ci] * w[dt, df, ci, co]
// with zeros outside the time and frequency edges.
//
// Bound: compute. At the flagship shapes ([24,432,16,64] and
// [24,216,4,64]) the two convolutions are 5.4 and 2.7 GFLOP against 42 and
// 11 MB of activations, far above the card's FLOP-per-byte balance, so the
// FP32 FMA rate of the CUDA cores is the limit.
//
// Design: implicit GEMM, one block per (tile of whole time rows holding up
// to 128 pixels, clip, slice of 64 output channels). The block stages its
// input rows plus a one-row, one-column halo in shared memory once; the
// halo cells outside the tensor are written as zeros by bounds checks (no
// padded copy in device memory). The pixel stride in shared memory is
// Cin + 1 floats so that neighbouring pixels fall in different banks. For
// each of the nine taps the block stages that tap's [Cin, 64] weight slice
// (16 KB at C = 64) and every thread accumulates 8 pixels x 4 output
// channels in registers. Plain FP32 FMAs: no TF32, no tensor cores yet.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 128;   // output pixels per block
constexpr int kCoTile = 64; // output channels per block

__global__ void __launch_bounds__(kThreads)
conv3x3_nhwc_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ out,
                    int T, int F, int Cin, int Cout, int rows) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * rows;
  const int b = blockIdx.y;
  const int co0 = blockIdx.z * kCoTile;
  const int W2 = F + 2;   // halo-padded freq width
  const int CP = Cin + 1; // padded pixel stride
  float* xs = smem;                        // [(rows+2) * W2][CP]
  float* ws = xs + (rows + 2) * W2 * CP;   // [Cin][kCoTile]

  const int n_x = (rows + 2) * W2 * Cin;
  for (int i = tid; i < n_x; i += kThreads) {
    const int ci = i % Cin;
    const int cell = i / Cin;
    const int fc = cell % W2, tr = cell / W2;
    const int t = t0 - 1 + tr, f = fc - 1;
    float v = 0.0f;
    if (t >= 0 && t < T && f >= 0 && f < F)
      v = x[(((long long)b * T + t) * F + f) * Cin + ci];
    xs[cell * CP + ci] = v;
  }

  // thread -> 8 pixels (pg + 16*i) x 4 output channels (cg + 16*j)
  const int cg = tid % 16, pg = tid / 16;
  const int npix = rows * F;
  int pbase[8];
  bool pval[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p = pg + 16 * i;
    pval[i] = p < npix && t0 + p / F < T;
    const int pp = pval[i] ? p : 0;
    pbase[i] = ((pp / F) * W2 + (pp % F)) * CP;  // top-left tap of the window
  }
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int tap = 0; tap < 9; ++tap) {
    const int dt = tap / 3, df = tap % 3;
    __syncthreads();  // xs staged / previous tap's weights fully read
    for (int i = tid; i < Cin * kCoTile; i += kThreads) {
      const int ci = i / kCoTile, c = i % kCoTile;
      ws[i] = co0 + c < Cout ? w[((long long)tap * Cin + ci) * Cout + co0 + c] : 0.0f;
    }
    __syncthreads();
    const int toff = (dt * W2 + df) * CP;
    for (int ci = 0; ci < Cin; ++ci) {
      float a[8], wv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = xs[pbase[i] + toff + ci];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = ws[ci * kCoTile + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], wv[j], acc[i][j]);
    }
  }

  float* ob = out + ((long long)b * T + t0) * F * Cout;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (!pval[i]) continue;
    const int p = pg + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + cg + 16 * j;
      if (co < Cout) ob[(long long)p * Cout + co] = acc[i][j] + bias[co];
    }
  }
}

}  // namespace

extern "C" {

// x: [B, T, F, Cin]; w: [3, 3, Cin, Cout] (HWIO); bias: [Cout];
// out: [B, T, F, Cout]; all float32, contiguous. F <= 128 (one block's
// pixel tile holds whole frequency rows); the caller checks that the
// shared memory below fits (ops/packed_conv.py:applicable).
int dcase_conv3x3(const void* x, const void* w, const void* bias, void* out, int B,
                  int T, int F, int Cin, int Cout, void* stream) {
  const int rows = kPix / F;
  const size_t smem =
      sizeof(float) * ((size_t)(rows + 2) * (F + 2) * (Cin + 1) + (size_t)Cin * kCoTile);
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_nhwc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + rows - 1) / rows, B, (Cout + kCoTile - 1) / kCoTile);
  conv3x3_nhwc_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out), T, F, Cin, Cout, rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
