// K3: 3x3, stride 1, same-padding convolution on NHWC float32 or bfloat16,
// forward, input gradient and weight gradient, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of dcase2019_task4_tpu/ops/packed_conv.py:
//   conv3x3_nhwc_kernel    _conv_kernel (via _run_conv / conv2d_packed), which
//                          runs the interior convolutions of CRNN blocks 2 and
//                          3 as nine row-shifted matmuls in the TPU's
//                          lane-packed layout; the input gradient is the same
//                          kernel on flipped, transposed weights
//                          (_packed_conv_bwd with flip_parts), here too
//   conv3x3_wgrad_kernel   _wgrad_kernel (via _run_wgrad)
// The packing (kron-embedded part weights, 8-row halo blocks, freq-edge row
// masks) is TPU layout and is not carried over: these kernels work on plain
// NHWC.
//
// Function: out[b,t,f,co] = bias[co]
//   + sum_{dt,df in 0..2} sum_ci x[b, t+dt-1, f+df-1, ci] * w[dt, df, ci, co]
// with zeros outside the time and frequency edges.
//
// Element type: each kernel is instantiated for float32 and for bfloat16
// activations (the model's compute dtype). In bfloat16 it rounds where the
// JAX kernel rounds (_conv_kernel, _wgrad_kernel): x, dy and the weights are
// bfloat16 operands (the wrapper hands the weights over already rounded,
// as float32), every product of two bfloat16 values is exact in float32 and
// accumulates in float32, the float32 bias is added, and out / dx are
// stored in bfloat16; dW and db stay float32. Staged in shared memory as
// float32 either way: the same tiles, the same arithmetic.
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
//
// Weight gradient: dW[dt, df, ci, co] = sum_{b,t,f} x[b, t+dt-1, f+df-1, ci]
// * dy[b, t, f, co] with zeros outside the tensor, db[co] = sum dy. Bound:
// compute, the same 5.4 and 2.7 GFLOP as the forward. One block per (run of
// pixel tiles, clip, time tap dt x 64-wide ci tile x 64-wide co tile): it
// stages the dy tile and the x rows shifted by dt - 1 with a one-column halo
// (zeros outside the tensor) and every thread keeps a 4 x 4 patch of dW for
// each of the three frequency taps in registers (48 accumulators) across all
// tiles of its run. The TPU kernel carries dW across its sequential grid;
// here each block writes its patch to its own slot of a workspace (the number
// of slots is bounded by the wrapper: a slot is 9*C*C + C floats, 147 KB at
// C = 64) and fold_kernel (fold.cuh) adds the slots in a fixed order in
// double precision: no float atomics, so a run repeats bit for bit.
//
// Lane copies of the weight gradient (bfloat16): at C < 128 the TPU kernel
// packs k = 128 / C frequency columns into one 128-lane row, so each weight
// appears k times in its part-weights, once per output-frequency class
// f mod k, and the VJP rounds each copy's float32 sum to bfloat16 before it
// folds the copies onto w (packed_conv.py:47-70,281). With `classes` = k the
// kernel keeps one sum per class (a block takes the output frequencies of
// one class: grid.z runs over the classes too), each slot holds the k class
// sums side by side, and fold_classes_kernel rounds each class's total to
// the compute dtype and adds the rounded totals (db is not rounded).

#include <cuda_runtime.h>

#include "dtype.cuh"
#include "fold.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 128;   // output pixels per block
constexpr int kCoTile = 64; // output channels per block

template <typename TX>
__global__ void __launch_bounds__(kThreads)
conv3x3_nhwc_kernel(const TX* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias, TX* __restrict__ out,
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
      v = to_float(x[(((long long)b * T + t) * F + f) * Cin + ci]);
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

  TX* ob = out + ((long long)b * T + t0) * F * Cout;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (!pval[i]) continue;
    const int p = pg + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + cg + 16 * j;
      if (co < Cout) ob[(long long)p * Cout + co] = from_float<TX>(acc[i][j] + bias[co]);
    }
  }
}

// grid: (runs of tiles, B, classes * 3 * n_ct * n_ct); slot = b * gridDim.x
// + run, of classes * (9*C*C + C) floats: one sum per output-frequency class.
template <typename TX>
__global__ void __launch_bounds__(kThreads)
conv3x3_wgrad_kernel(const TX* __restrict__ x, const TX* __restrict__ dy,
                     float* __restrict__ partials, int T, int F, int C, int rows,
                     int tiles_per_block, int n_ct, int classes) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int per_class = 3 * n_ct * n_ct;
  const int cls = blockIdx.z / per_class;  // output frequencies f = cls mod classes
  const int dt = (blockIdx.z % per_class) % 3;
  const int ct = (blockIdx.z % per_class) / 3;
  const int ci0 = (ct / n_ct) * kCoTile, co0 = (ct % n_ct) * kCoTile;
  const int W2 = F + 2;
  const int CP = kCoTile + 1;
  float* xs = smem;                  // [rows * W2][CP]: x rows t + dt - 1, freq halo
  float* dys = xs + rows * W2 * CP;  // [kPix][CP]

  // thread -> 4 input channels (ca + 16 i) x 4 output channels (cb + 16 j)
  const int cb = tid % 16, ca = tid / 16;
  float acc[3][4][4];
  float dbv[4];
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[d][i][j] = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) dbv[j] = 0.0f;
  const bool owns_db = dt == 0 && ci0 == 0 && ca == 0;

  const int n_tiles = (T + rows - 1) / rows;
  const int first = blockIdx.x * tiles_per_block;
  const int last = min(n_tiles, first + tiles_per_block);
  for (int tile = first; tile < last; ++tile) {
    const int t0 = tile * rows;
    const int trows = min(rows, T - t0);
    __syncthreads();  // previous tile's products done
    for (int i = tid; i < rows * W2 * kCoTile; i += kThreads) {
      const int c = i % kCoTile, cell = i / kCoTile;
      const int fc = cell % W2, r = cell / W2;
      const int t = t0 + r + dt - 1, f = fc - 1, ci = ci0 + c;
      float v = 0.0f;
      if (r < trows && t >= 0 && t < T && f >= 0 && f < F && ci < C)
        v = to_float(x[(((long long)b * T + t) * F + f) * C + ci]);
      xs[cell * CP + c] = v;
    }
    for (int i = tid; i < trows * F * kCoTile; i += kThreads) {
      const int c = i % kCoTile, p = i / kCoTile;
      const int co = co0 + c;
      dys[p * CP + c] = co < C ? to_float(dy[(((long long)b * T + t0) * F + p) * C + co]) : 0.0f;
    }
    __syncthreads();
    for (int r = 0; r < trows; ++r)
      for (int f = cls; f < F; f += classes) {
        const float* xc = xs + (r * W2 + f) * CP + ca;
        const float* dc = dys + (r * F + f) * CP + cb;
        float dv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) dv[j] = dc[16 * j];
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          float xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) xv[i] = xc[d * CP + 16 * i];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[d][i][j] = fmaf(xv[i], dv[j], acc[d][i][j]);
        }
        if (owns_db) {
#pragma unroll
          for (int j = 0; j < 4; ++j) dbv[j] += dv[j];
        }
      }
  }

  const int slot = b * gridDim.x + blockIdx.x;
  float* ps = partials + ((long long)slot * classes + cls) * (9 * C * C + C);
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ci = ci0 + ca + 16 * i, co = co0 + cb + 16 * j;
        if (ci < C && co < C) ps[((long long)(dt * 3 + d) * C + ci) * C + co] = acc[d][i][j];
      }
  if (owns_db) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (co0 + cb + 16 * j < C) ps[9 * C * C + co0 + cb + 16 * j] = dbv[j];
  }
}

template <typename TX>
int launch_conv(const void* x, const void* w, const void* bias, void* out, int B, int T, int F,
                int Cin, int Cout, cudaStream_t stream) {
  const int rows = kPix / F;
  const size_t smem =
      sizeof(float) * ((size_t)(rows + 2) * (F + 2) * (Cin + 1) + (size_t)Cin * kCoTile);
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_nhwc_kernel<TX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + rows - 1) / rows, B, (Cout + kCoTile - 1) / kCoTile);
  conv3x3_nhwc_kernel<TX><<<grid, kThreads, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<TX*>(out), T, F, Cin, Cout, rows);
  return (int)cudaGetLastError();
}

template <typename TX>
int launch_wgrad(const void* x, const void* dy, void* partials, void* out, int B, int T, int F,
                 int C, int tiles_per_block, int classes, cudaStream_t st) {
  const int rows = kPix / F;
  const size_t smem =
      sizeof(float) * ((size_t)rows * (F + 2) + (size_t)kPix) * (kCoTile + 1);
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_wgrad_kernel<TX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (T + rows - 1) / rows;
  const int n_ct = (C + kCoTile - 1) / kCoTile;
  const int n_classes = classes > 0 ? classes : 1;
  const dim3 grid((n_tiles + tiles_per_block - 1) / tiles_per_block, B, n_classes * 3 * n_ct * n_ct);
  conv3x3_wgrad_kernel<TX><<<grid, kThreads, smem, st>>>(
      static_cast<const TX*>(x), static_cast<const TX*>(dy), static_cast<float*>(partials), T, F, C,
      rows, tiles_per_block, n_ct, n_classes);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const auto* pa = static_cast<const float*>(partials);
  auto* o = static_cast<float*>(out);
  const int width = 9 * C * C + C;
  if (classes == 0)  // one float32 sum, not rounded
    return (int)launch_fold<float>(pa, o, (int)(grid.x * grid.y), width, st);
  return (int)launch_fold_classes<float, TX>(pa, o, (int)(grid.x * grid.y), width, classes,
                                             (long long)classes * width, width, 9 * C * C, st);
}

}  // namespace

extern "C" {

// x: [B, T, F, Cin]; w: [3, 3, Cin, Cout] (HWIO); bias: [Cout];
// out: [B, T, F, Cout]; contiguous. x and out float32, or bfloat16 when
// bf16 != 0; w (already rounded to the compute dtype) and bias float32.
// F <= 128 (one block's pixel tile holds whole frequency rows); the caller
// checks that the shared memory below fits (ops/packed_conv.py:applicable).
int dcase_conv3x3(const void* x, const void* w, const void* bias, void* out, int B,
                  int T, int F, int Cin, int Cout, int bf16, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_conv<__nv_bfloat16>(x, w, bias, out, B, T, F, Cin, Cout, st)
              : launch_conv<float>(x, w, bias, out, B, T, F, Cin, Cout, st);
}

// x, dy: [B, T, F, C], float32 or (bf16 != 0) bfloat16; partials:
// [B * ceil(tiles / tiles_per_block), max(classes, 1) * (9*C*C + C)] float32
// scratch; out: [9*C*C + C] float32 = dW [3, 3, C, C] (HWIO) | db [C]; all
// contiguous. F <= 128. classes 0: dW is the float32 sum; classes k >= 1:
// dW is the sum over output-frequency classes f mod k of each class's sum
// rounded to the element type (the gradient of the compute-dtype weights as
// the lane-packed original folds it); db is never rounded.
int dcase_conv3x3_wgrad(const void* x, const void* dy, void* partials, void* out, int B,
                        int T, int F, int C, int tiles_per_block, int bf16, int classes,
                        void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_wgrad<__nv_bfloat16>(x, dy, partials, out, B, T, F, C, tiles_per_block,
                                            classes, st)
              : launch_wgrad<float>(x, dy, partials, out, B, T, F, C, tiles_per_block, classes, st);
}

// Pixel tiles per clip of the kernels above (tiles of whole frequency rows).
int dcase_conv3x3_tiles(int T, int F) {
  const int rows = kPix / F;
  return (T + rows - 1) / rows;
}

}  // extern "C"
