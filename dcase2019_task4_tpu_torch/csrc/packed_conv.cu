// K3: 3x3, stride 1, same-padding convolution on NHWC float32 or bfloat16,
// forward, input gradient and weight gradient, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of dcase2019_task4_tpu/ops/packed_conv.py,
// which run the interior convolutions of CRNN blocks 2 and 3 as nine
// row-shifted matmuls in the TPU's lane-packed layout:
//   _conv_kernel (:122, via _run_conv :208)   forward; the input gradient is
//                                             the same kernel on flipped,
//                                             transposed weights
//                                             (_packed_conv_bwd :276)
//     float32:  conv3x3_nhwc_kernel
//     bfloat16: conv3x3_bf16_kernel
//   _wgrad_kernel (:147, via _run_wgrad :228) weight gradient
//     float32:  conv3x3_wgrad_kernel
//     bfloat16: conv3x3_wgrad_bf16_kernel
// The packing (kron-embedded part weights, 8-row halo blocks, freq-edge row
// masks) is TPU layout and is not carried over: these kernels work on plain
// NHWC.
//
// Function: out[b,t,f,co] = bias[co]
//   + sum_{dt,df in 0..2} sum_ci x[b, t+dt-1, f+df-1, ci] * w[dt, df, ci, co]
// with zeros outside the time and frequency edges; dW[dt, df, ci, co] =
// sum_{b,t,f} x[b, t+dt-1, f+df-1, ci] * dy[b, t, f, co], db[co] = sum dy.
//
// ---- bfloat16: tensor cores ----
//
// Roundings, where the JAX kernels put them (packed_conv.py:100-107, 133,
// 135, 143-144, 169-171, 281): x, dy and the weights enter the products as
// bfloat16 (the wrapper rounds the float32 weights to bfloat16, as the JAX
// model casts its part-weights); each product of two bfloat16 values is
// exact and the products accumulate in float32 (the bf16 -> f32 MMA);
// the float32 bias is added to the float32 sum, which is rounded once to
// bfloat16 on store (out, dx); dW and db stay float32, and in bfloat16 the
// fold rounds each output-frequency class's dW sum before it adds them (see
// "Lane copies" below).
//
// Bound: operations on the bfloat16 tensor cores (989 TFLOP/s). A 3x3 conv
// with Cin = Cout = C does 2 * 9 * C flops per output value against 4 bytes
// of activation in and out: 576 flops a byte at C = 128, 288 at C = 64,
// against the card's 295 flops a byte of bf16 balance. At batch 24 the
// scaled configuration's two shapes ([24,432,32,128], [24,216,8,128]) are
// 97.8 + 12.2 GFLOP, a bound of 0.1113 ms; the flagship bf16 shapes
// ([24,432,16,64], [24,216,4,64]) 12.2 + 1.5 GFLOP, 0.0139 ms, on the
// balance point (their bytes take 0.0143 ms at 3.35 TB/s). The weight
// gradient does the same products.
//
// Design, forward / dx (conv3x3_bf16_kernel): an implicit GEMM with
// M = output pixels, N = Cout, K = 9 * Cin. One block takes a tile of whole
// frequency rows holding 128 output pixels (64 where 128-pixel tiles would
// give fewer than two waves of blocks: the flagship's F = 4 shape) and 64
// or 128 output channels; each warp a 32-pixel x 64-channel tile
// (2 x 8 fragments of mma.sync m16n8k16). The block stages its input rows
// plus a one-row, one-column halo in shared memory once, as bfloat16, the
// halo cells outside the tensor and channels past Cin as zeros: no padded
// copy in device memory. The pixel stride is Cin rounded up to 16, plus 8
// values: an odd number of 16-byte units, so the eight row addresses of one
// ldmatrix fall in distinct banks wherever eight neighbouring pixels lie on
// one frequency row. The A fragments are an im2col done by ldmatrix: each
// lane names one pixel's row, shifted by the tap (dt, df), and lands on the
// zero halo at the edges; the same code takes any F <= 128. The weights
// stream through two shared buffers of one tap's [64-channel slice of Cin,
// N] each (cp.async, the next slice loads while this one multiplies) and
// reach the MMA through ldmatrix.trans. Epilogue: the float32 bias is added,
// each value rounded once to bfloat16, the tile staged in shared memory and
// stored 16 bytes a thread. No FP32-FMA loop remains: every product is an
// HMMA. (A wgmma variant, B through a K-major shared-memory descriptor, was
// slower at every main-path shape: PERF.md section 6.)
//
// Design, weight gradient (conv3x3_wgrad_bf16_kernel): nine GEMMs
// dW[dt, df] = X_shifted^T . dY whose K runs over the pixels of one
// output-frequency class. One block owns all nine taps of one 64-wide Cin
// slice x 32-wide Cout slice for one class and a run of pixel tiles; warp
// tap (0..8) keeps its 64 x 32 sum in 64 float32 registers a thread. Per
// pixel tile the block stages the x slab (its Cin slice, with the time and
// frequency halo) and the dy tile (its Cout slice) once, as bfloat16, into
// one of two buffers (cp.async: the next tile loads while this one
// multiplies), and all nine warps multiply from them: the A fragments (x
// shifted, transposed)
// and the B fragments (dy) come through ldmatrix.trans, one row address a
// pixel, read from a table of the class's pixels that applies the class
// selection (f = c mod k), the tap's shift and the halo; the tail of the
// table points at zero rows. The warp of tap 0 in the first Cin slice also
// sums db with an MMA against a fragment of ones. A block writes its sums
// to its own slot of the workspace; fold.cuh folds the slots in a fixed
// order, so a run repeats bit for bit.
//
// The accumulators: 128 output pixels a tile, tiles_per_block tiles a block
// (the wrapper bounds the slots), so one float32 register sums at most a few
// thousand products before the fold adds the slots in double precision.
//
// ---- float32: CUDA cores ----
//
// Bound: compute on the FP32 CUDA cores (67 TFLOP/s): the flagship float32
// shapes are 12.2 + 1.5 GFLOP against 42 and 11 MB of activations.
//
// Design, forward and dx (conv3x3_nhwc_kernel): an implicit GEMM on FP32
// FMAs with M = output pixels, N = 64 output channels, K = 9 * Cin. One block
// of four warps takes a tile of whole frequency rows holding 128 output
// pixels (64 where 128-pixel tiles would give fewer than two blocks an SM:
// the flagship's F = 4 shape) and a 64-wide slice of the output channels;
// each thread an 8 x 8 register tile (4 x 8 at 64 pixels): pixels pg + 16 i
// and channels 4 cg + j, 32 + 4 cg + j. The block stages its input rows plus
// a one-row, one-column halo once, by cp.async, with zeros outside the
// tensor; a pixel's channels are one shared row, its stride an odd number of
// 16-byte units. The weights stream through two buffers of one tap's slice
// of at most 64 input channels (cp.async: the next slice loads while this
// one multiplies). Per four input channels a thread reads its eight pixels'
// float4 (the eight lanes that share a pixel read one address) and the
// slice's eight float4 (eight neighbouring float4 across the lanes) and does
// 256 FMAs: 16 FMAs a 16-byte shared load, against the four FFMAs an SM
// issues for each shared load. The input gradient is the same kernel
// reading the forward weights flipped in both taps and transposed, by index
// (kFlip: the slice is staged [output channel][input channel], rows
// contiguous in the forward weights, and a thread takes channels cg + 8 j
// so that its eight float4 come from eight neighbouring rows), with no
// bias: a dx call launches this kernel and nothing else.
//
// Weight gradient (conv3x3_wgrad_kernel): the structure of the bfloat16
// weight gradient above, on FP32 FMAs. Nine GEMMs dW[dt, df] = X_shifted^T
// . dY whose K runs over the pixels. One block of 18 warps owns all nine taps of one
// 64-wide Cin slice x 64-wide Cout slice for one clip and a run of pixel
// tiles; warp w takes tap w % 9 and the 32-wide half w / 9 of the Cout
// slice, each thread an 8 ci x 8 co register tile of it (lane % 8 picks the
// input channels 4 (lane % 8) + i and 32 + 4 (lane % 8) + i, lane / 8 the
// output channels 4 (lane / 8) + j and 16 + 4 (lane / 8) + j of the half).
// Per 128-pixel tile the block stages the x slab (its Cin slice with the
// one-row, one-column halo, zeros outside the tensor) and the dy tile (its
// Cout slice) once, by cp.async, into one of two buffers (one where two do
// not fit the shared memory: F = 1 or F > 112), the next tile loading while this one
// multiplies; rows of 64 floats, so a warp quarter's eight x loads are
// eight neighbouring float4 and its dy loads one broadcast float4. Each
// pixel then feeds 64 FMAs a thread from four LDS.128 (the FP32-FMA kernel
// it replaces staged the slab and dy once per time tap and fed 48 FMAs from
// 16 scalar loads). The blocks of the first Cin slice also sum db, every
// thread one channel over a ninth of each dy tile's pixels (summed by the
// tap-0 warps alone, it made them pace the block: 6 % slower). 18 warps
// share an SM's four register files as 5 + 5 + 4 + 4, so ptxas caps a
// thread at 96 registers (12 bytes of spill). A
// block writes its sums to its own slot; fold_kernel adds the slots in a
// fixed order, so a run repeats bit for bit. The wrapper sizes the slots
// for about two waves of one block an SM (ops/packed_conv.wgrad_workspace:
// 264 slots, so at the flagship [24, 432, 16, 64] a block sums 5 tiles and
// one float32 register at most 640 products before the fold adds the slots
// in double precision).
//
// Lane copies of the weight gradient (bfloat16): at C < 128 the TPU kernel
// packs k = 128 / C frequency columns into one 128-lane row, so each weight
// appears k times in its part-weights, once per output-frequency class
// f mod k, and the VJP rounds each copy's float32 sum to bfloat16 before it
// folds the copies onto w (packed_conv.py:47-70,281). With `classes` = k the
// kernel keeps one sum per class (grid.z runs over the classes too), each
// slot holds the k class sums side by side, and fold_classes_kernel rounds
// each class's total to bfloat16 and adds the rounded totals (db is not
// rounded).

#include <cstdint>

#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "dtype.cuh"
#include "fold.cuh"
#include "mma.cuh"

namespace {

constexpr int kPix = 128;   // output pixels per tile

// ---- float32 kernels ----

// Four floats into 16 aligned bytes of shared memory: the first n (0..4)
// from src, zeros after; one 16-byte copy where src is 16-byte aligned (vec:
// C % 4 == 0 and aligned tensors), else four of 4 bytes.
__device__ __forceinline__ void stage4(float* dst, const float* src, int n, bool vec) {
  if (vec) {
    cp_async16(dst, src, 4 * n);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) cp_async4(dst + i, i < n ? src + i : src, i < n ? 4 : 0);
}

__device__ __forceinline__ float part(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

constexpr int kCvThreads = 128;  // float32 forward / dx: four warps
constexpr int kCvN = 64;         // output channels a block

// Row stride in floats of a shared operand whose rows hold n values: n
// rounded up to 4, plus 4 where that is an even number of 16-byte units, so
// that neighbouring rows start in different 16-byte bank groups.
__host__ __device__ inline int odd_stride4(int n) {
  const int r4 = (n + 3) / 4 * 4;
  return (r4 / 4) % 2 ? r4 : r4 + 4;
}

// Dynamic shared memory of conv3x3_nhwc_kernel: the slab [(rows+2) * (F+2)]
// [odd_stride4(Cin)] and two weight buffers of 64 * odd_stride4(kc) floats
// (ops/packed_conv.conv_plan computes the same).
size_t conv_f32_smem(int rows, int F, int Cin, int kc) {
  return sizeof(float) *
         ((size_t)(rows + 2) * (F + 2) * odd_stride4(Cin) + 2 * (size_t)kCvN * odd_stride4(kc));
}

// grid: (time tiles of `rows` whole frequency rows, B, ceil(Cout / 64)), 128
// threads. Thread (pg, cg) = (tid / 8, tid % 8) holds pixels pg + 16 i (i <
// MI: 16 * MI pixels a tile) x 8 output channels: 4 cg + j and 32 + 4 cg + j
// (forward) or cg + 8 j (kFlip). kc: input channels a weight slice, a power
// of two from 4 to 64. bias may be null (no bias).
template <int MI, bool kFlip>
__global__ void __launch_bounds__(kCvThreads, 2)
conv3x3_nhwc_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ out, int T, int F, int Cin,
                    int Cout, int rows, int kc, int vec_x, int vec_w, int vec_o) {
  extern __shared__ __align__(16) float smem_c[];
  const int tid = threadIdx.x, cg = tid % 8, pg = tid / 8;
  const int t0 = blockIdx.x * rows, b = blockIdx.y, co0 = blockIdx.z * kCvN;
  const int W2 = F + 2;
  const int r4 = (Cin + 3) / 4 * 4;  // input channels in whole chunks of four
  const int CS = odd_stride4(Cin), WS = odd_stride4(kc);
  const int n_cells = (rows + 2) * W2;
  const int nks = (r4 + kc - 1) / kc;  // weight slices a tap
  const int n_stages = 9 * nks;
  float* xs = smem_c;             // the slab [n_cells][CS]
  float* ws = xs + n_cells * CS;  // [2][64 * WS]

  // the slab: input rows t0 - 1 .. t0 + rows, columns -1 .. F, zeros outside;
  // thread -> chunk q of four channels of every (128 / Q)-th cell, the cell's
  // row and column carried by counters (no division in the loop)
  {
    const int Q = r4 / 4;
    const int dq = kCvThreads % Q, dcell = kCvThreads / Q;
    const int dr = dcell / W2, df = dcell % W2;
    int q = tid % Q, cell = tid / Q;
    int r = cell / W2, f = cell % W2;
    while (cell < n_cells) {
      const int t = t0 - 1 + r, fi = f - 1, ci = 4 * q;
      int n = 0;
      const float* src = x;
      if (t >= 0 && t < T && fi >= 0 && fi < F) {
        n = min(4, Cin - ci);
        src = x + (((long long)b * T + t) * F + fi) * Cin + ci;
      }
      stage4(xs + cell * CS + ci, src, n, vec_x);
      q += dq;
      cell += dcell;
      r += dr;
      f += df;
      if (q >= Q) {
        q -= Q;
        ++cell;
        ++f;
      }
      if (f >= W2) {
        f -= W2;
        ++r;
      }
    }
  }

  // weight slice s (tap s / nks, input channels k0 = (s % nks) * kc ..) into
  // buffer buf: forward [kc][64] (row k: input channel k0 + k, its 64 output
  // channels); kFlip [64][WS] (row n: output channel co0 + n of dx, its kc
  // input channels, read from the forward weights flipped in both taps and
  // transposed: w[8 - tap][n][k], w being the forward conv's [3, 3, Cout, Cin])
  auto load_w = [&](int s, int buf) {
    const int tap = s / nks, k0 = (s % nks) * kc;
    float* dst = ws + buf * kCvN * WS;
    if constexpr (!kFlip) {
      const int q = tid % (kCvN / 4), co = co0 + 4 * q;
      for (int k = tid / (kCvN / 4); k < kc; k += kCvThreads / (kCvN / 4)) {
        const int ci = k0 + k;
        int n = 0;
        const float* src = w;
        if (ci < Cin && co < Cout) {
          n = min(4, Cout - co);
          src = w + ((long long)tap * Cin + ci) * Cout + co;
        }
        stage4(dst + k * kCvN + 4 * q, src, n, vec_w);
      }
    } else {
      const int Qk = kc / 4, q = tid % Qk, ci = k0 + 4 * q;
      for (int n = tid / Qk; n < kCvN; n += kCvThreads / Qk) {
        const int co = co0 + n;
        int cnt = 0;
        const float* src = w;
        if (co < Cout && ci < Cin) {
          cnt = min(4, Cin - ci);
          src = w + ((long long)(8 - tap) * Cout + co) * Cin + ci;
        }
        stage4(dst + n * WS + 4 * q, src, cnt, vec_w);
      }
    }
  };
  load_w(0, 0);
  cp_async_commit();

  // each pixel's top-left tap x[t - 1, f - 1] in the slab; pixels past the
  // tile read pixel 0 (their sums are not stored)
  const int npix = rows * F;
  int abase[MI];
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    int p = pg + 16 * i;
    if (p >= npix) p = 0;
    abase[i] = ((p / F) * W2 + p % F) * CS;
  }
  float acc[MI][8];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait_all();
    __syncthreads();  // slice s (and the slab) landed; every warp is done with slice s - 1's buffer
    if (s + 1 < n_stages) {  // the next slice loads while this one multiplies
      load_w(s + 1, (s + 1) & 1);
      cp_async_commit();
    }
    const int tap = s / nks, k0 = (s % nks) * kc;
    const int kn = min(kc, r4 - k0) / 4;
    const float* xa = xs + ((tap / 3) * W2 + tap % 3) * CS + k0;  // the tap's shift
    const float* wb = ws + (s & 1) * kCvN * WS;
    for (int kq = 0; kq < kn; ++kq) {
      float4 a[MI];
#pragma unroll
      for (int i = 0; i < MI; ++i) a[i] = *reinterpret_cast<const float4*>(xa + abase[i] + 4 * kq);
      if constexpr (!kFlip) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* wr = wb + (4 * kq + kk) * kCvN + 4 * cg;
          const float4 b0 = *reinterpret_cast<const float4*>(wr);
          const float4 b1 = *reinterpret_cast<const float4*>(wr + kCvN / 2);
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            const float av = part(a[i], kk);
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
          }
        }
      } else {
        float4 bq[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) bq[j] = *reinterpret_cast<const float4*>(wb + (cg + 8 * j) * WS + 4 * kq);
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[i][j] = fmaf(a[i].x, bq[j].x, acc[i][j]);
            acc[i][j] = fmaf(a[i].y, bq[j].y, acc[i][j]);
            acc[i][j] = fmaf(a[i].z, bq[j].z, acc[i][j]);
            acc[i][j] = fmaf(a[i].w, bq[j].w, acc[i][j]);
          }
      }
    }
  }

  const int valid = min(npix, (T - t0) * F);  // the tile's pixels inside the tensor
  float* ob = out + ((long long)b * T + t0) * F * Cout;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int p = pg + 16 * i;
    if (p >= valid) continue;
    float* orow = ob + (long long)p * Cout;
    if constexpr (!kFlip) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int co = co0 + h * (kCvN / 2) + 4 * cg;
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = acc[i][4 * h + e] + (bias != nullptr && co + e < Cout ? bias[co + e] : 0.0f);
        if (vec_o && co + 4 <= Cout) {
          *reinterpret_cast<float4*>(orow + co) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (co + e < Cout) orow[co + e] = v[e];
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int co = co0 + cg + 8 * j;
        if (co < Cout) orow[co] = acc[i][j] + (bias != nullptr ? bias[co] : 0.0f);
      }
    }
  }
}

constexpr int kWfWarps = 18;               // two a tap: one per 32-wide half of the Cout slice
constexpr int kWfThreads = 32 * kWfWarps;
constexpr int kWfC = 64;                   // a block's Cin and Cout slices; floats a shared row
static_assert(kWfThreads == 9 * kWfC, "db: one thread a channel and pixel class mod 9");

// grid: (runs of tiles, B, n_ci * n_co); slot = b * gridDim.x + run, of
// 9*C*C + C floats. Dynamic shared memory: `buffers` (1 or 2) copies of the
// x slab [(rows+2) * (F+2)][64] and of the dy tile [rows * F][64], float32.
__global__ void __launch_bounds__(kWfThreads, 1)
conv3x3_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                     float* __restrict__ partials, int T, int F, int C, int rows,
                     int tiles_per_block, int n_co, int buffers, int vec) {
  extern __shared__ __align__(16) float smem_f[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tap = warp % 9, half = warp / 9;
  const int b = blockIdx.y;
  const int ci0 = (blockIdx.z / n_co) * kWfC, co0 = (blockIdx.z % n_co) * kWfC;
  const int W2 = F + 2;
  const int n_cells = (rows + 2) * W2;  // time halo rows included
  const int x_buf = n_cells * kWfC, y_buf = rows * F * kWfC;
  float* xs = smem_f;                   // [buffers][x_buf]
  float* ys = xs + buffers * x_buf;     // [buffers][y_buf]

  // pixel tile `tile` (its x slab and dy tile) into buffer buf
  auto stage_tile = [&](int tile, int buf) {
    const int t0 = tile * rows, trows = min(rows, T - t0);
    float* xb = xs + buf * x_buf;
    float* yb = ys + buf * y_buf;
    for (int i = tid; i < n_cells * (kWfC / 4); i += kWfThreads) {
      const int q = i % (kWfC / 4), cell = i / (kWfC / 4);
      const int t = t0 - 1 + cell / W2, f = cell % W2 - 1, ci = ci0 + 4 * q;
      int n = 0;
      const float* src = x;
      if (t >= 0 && t < T && f >= 0 && f < F && ci < C) {
        n = min(4, C - ci);
        src = x + (((long long)b * T + t) * F + f) * C + ci;
      }
      stage4(xb + cell * kWfC + 4 * q, src, n, vec);
    }
    for (int i = tid; i < trows * F * (kWfC / 4); i += kWfThreads) {
      const int q = i % (kWfC / 4), p = i / (kWfC / 4), co = co0 + 4 * q;
      int n = 0;
      const float* src = dy;
      if (co < C) {
        n = min(4, C - co);
        src = dy + (((long long)b * T + t0) * F + p) * C + co;
      }
      stage4(yb + p * kWfC + 4 * q, src, n, vec);
    }
  };

  const int cg = lane % 8, og = lane / 8;
  float acc[8][8];  // [ci: 4 cg + i, then 32 + 4 cg + i][co: 4 og + j, then 16 + 4 og + j]
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  // db (the first Cin slice's blocks): thread -> output channel tid % 64 of
  // the pixels p = tid / 64 (mod 9) of each dy tile, so every warp adds the
  // same few sums and none paces the block
  const bool owns_db = ci0 == 0;
  const int db_co = tid % kWfC, db_first = tid / kWfC;
  float db_sum = 0.0f;
  const int toff = ((tap / 3) * W2 + tap % 3) * kWfC + 4 * cg;  // the tap's shift: x[t + dt - 1, f + df - 1]
  const int yoff = 32 * half + 4 * og;

  const int n_tiles = (T + rows - 1) / rows;
  const int first = blockIdx.x * tiles_per_block;
  const int last = min(n_tiles, first + tiles_per_block);
  if (first < last) stage_tile(first, 0);
  cp_async_commit();
  for (int tile = first; tile < last; ++tile) {
    const int buf = buffers == 2 ? (tile - first) & 1 : 0;
    cp_async_wait_all();
    __syncthreads();  // this tile landed; every warp is done with the other buffer
    if (buffers == 2 && tile + 1 < last) {  // the next tile loads while this one multiplies
      stage_tile(tile + 1, buf ^ 1);
      cp_async_commit();
    }
    const int trows = min(rows, T - tile * rows);
    const float* xb = xs + buf * x_buf + toff;
    const float* yb = ys + buf * y_buf + yoff;
    for (int r = 0; r < trows; ++r) {
      const float* xr = xb + r * W2 * kWfC;
      const float* yr = yb + r * F * kWfC;
#pragma unroll 1  // one pixel at a time: two spilled 36 bytes, not 12, and ran no faster
      for (int f = 0; f < F; ++f) {
        const float4 a0 = *reinterpret_cast<const float4*>(xr + f * kWfC);
        const float4 a1 = *reinterpret_cast<const float4*>(xr + f * kWfC + 32);
        const float4 d0 = *reinterpret_cast<const float4*>(yr + f * kWfC);
        const float4 d1 = *reinterpret_cast<const float4*>(yr + f * kWfC + 16);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float dv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], dv[j], acc[i][j]);
      }
    }
    if (owns_db) {
      const float* yt = ys + buf * y_buf + db_co;
      for (int p = db_first; p < trows * F; p += 9) db_sum += yt[p * kWfC];
    }
    if (buffers == 1 && tile + 1 < last) {
      __syncthreads();  // every warp is done with the only buffer
      stage_tile(tile + 1, 0);
      cp_async_commit();
    }
  }

  const int slot = b * gridDim.x + blockIdx.x;
  float* ps = partials + (long long)slot * (9LL * C * C + C);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int ci = ci0 + (i < 4 ? 0 : 32) + 4 * cg + i % 4;
    if (ci >= C) continue;
    float* row = ps + ((long long)tap * C + ci) * C;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = co0 + yoff + 16 * h;
      if (vec && co + 4 <= C) {
        *reinterpret_cast<float4*>(row + co) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (co + e < C) row[co + e] = acc[i][4 * h + e];
      }
    }
  }
  if (owns_db) {  // the nine pixel classes' sums of each channel, added in class order
    __syncthreads();  // every warp is done with the tiles
    smem_f[tid] = db_sum;
    __syncthreads();
    if (tid < kWfC && co0 + tid < C) {
      float total = 0.0f;
      for (int g = 0; g < kWfThreads / kWfC; ++g) total += smem_f[g * kWfC + tid];
      ps[9LL * C * C + co0 + tid] = total;
    }
  }
}

// ---- bfloat16 kernels: mma.sync m16n8k16 (bf16 x bf16 -> f32, mma.cuh) ----

using bf16 = __nv_bfloat16;
constexpr int kRowPad = 8;  // bfloat16 values past each shared row: an odd number of 16-byte units

// Eight bfloat16 values into 16 aligned bytes of shared memory: the first n
// (0..8) from src, zeros after. With vec (src 16-byte aligned) and n == 8 an
// asynchronous copy, else loads of the n values and one 16-byte store.
__device__ __forceinline__ void stage8(bf16* dst, const bf16* src, int n, bool vec) {
  if (vec && n == 8) {
    cp_async16(dst, src, 16);
    return;
  }
  const auto* s = reinterpret_cast<const unsigned short*>(src);
  uint32_t v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = 2 * i < n ? s[2 * i] : 0u;
    const uint32_t hi = 2 * i + 1 < n ? s[2 * i + 1] : 0u;
    v[i] = lo | (hi << 16);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
}

// One block: WM x WN warps, each a 32-pixel x 64-channel tile; kM = 32 WM
// pixels (whole frequency rows: rows = kM / F), kN = 64 WN output channels.
// Dynamic shared memory: the x slab [(rows+2) * (F+2)][cin_p + 8] and two
// weight buffers [kc][kN + 8], bfloat16; the output tile [kM][kN + 8]
// reuses it after the products.
template <int WM, int WN>
__global__ void __launch_bounds__(32 * WM * WN, 2)
conv3x3_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    const float* __restrict__ bias, bf16* __restrict__ out, int T, int F, int Cin,
                    int Cout, int rows, int cin_p, int kc, int vec_x, int vec_w, int vec_o) {
  constexpr int kM = 32 * WM, kN = 64 * WN, kThr = 32 * WM * WN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int t0 = blockIdx.x * rows, b = blockIdx.y, co0 = blockIdx.z * kN;
  const int W2 = F + 2;
  const int XS = cin_p + kRowPad, WS = kN + kRowPad;
  const int n_cells = (rows + 2) * W2;
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ws = xs + n_cells * XS;
  const int nkc = cin_p / kc;  // weight slices per tap
  const int n_stages = 9 * nkc;

  // the slab: input rows t0 - 1 .. t0 + rows, columns -1 .. F, zeros outside
  const int c8 = cin_p / 8;
  for (int i = tid; i < n_cells * c8; i += kThr) {
    const int ch = i % c8, cell = i / c8;
    const int t = t0 - 1 + cell / W2, f = cell % W2 - 1;
    int n = 0;
    const bf16* src = x;
    if (t >= 0 && t < T && f >= 0 && f < F) {
      n = min(8, Cin - ch * 8);
      src = x + (((long long)b * T + t) * F + f) * Cin + ch * 8;
    }
    stage8(xs + cell * XS + ch * 8, src, n, vec_x);
  }
  // weight slice s (tap s / nkc, input channels (s % nkc) * kc ..) into buffer buf
  auto load_w = [&](int s, int buf) {
    const int tap = s / nkc, ci0 = (s % nkc) * kc;
    bf16* dst = ws + buf * kc * WS;
    constexpr int n8 = kN / 8;
    for (int i = tid; i < kc * n8; i += kThr) {
      const int ch = i % n8, r = i / n8;
      const int ci = ci0 + r, co = co0 + ch * 8;
      int n = 0;
      const bf16* src = w;
      if (ci < Cin && co < Cout) {
        n = min(8, Cout - co);
        src = w + ((long long)tap * Cin + ci) * Cout + co;
      }
      stage8(dst + r * WS + ch * 8, src, n, vec_w);
    }
  };
  load_w(0, 0);
  cp_async_commit();

  // A (pixels x input channels): lane -> pixel row lane % 16 of each
  // 16-pixel fragment, channel offset (lane / 16) * 8; pixels past the tile
  // read pixel 0 (their sums are not stored)
  const int wm = warp % WM, wn = warp / WM;
  const int npix = rows * F;
  int acell[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    int p = wm * 32 + mt * 16 + lane % 16;
    if (p >= npix) p = 0;
    acell[mt] = (p / F) * W2 + p % F;
  }
  const int a_off = (lane / 16) * 8;
  // B (input channels x output channels, row-major in shared memory): lane ->
  // k row (lane % 8) + 8 ((lane / 8) % 2), column offset 8 (lane / 16)
  const int b_row = lane % 8 + ((lane / 8) % 2) * 8;
  const int b_col = wn * 64 + (lane / 16) * 8;

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait_all();
    __syncthreads();  // slice s landed; every warp is done with slice s - 1's buffer
    if (s + 1 < n_stages) {
      load_w(s + 1, (s + 1) & 1);
      cp_async_commit();
    }
    const int tap = s / nkc, ci0 = (s % nkc) * kc;
    const int toff = (tap / 3) * W2 + tap % 3;
    const bf16* wb = ws + (s & 1) * kc * WS;
    uint32_t a_base[2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) a_base[mt] = smem_addr(xs + (acell[mt] + toff) * XS + ci0 + a_off);
    const uint32_t b_base = smem_addr(wb + b_row * WS + b_col);
    for (int k = 0; k < kc; k += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) ldmatrix_x4(a[mt], a_base[mt] + 2 * k);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bq[4];
        ldmatrix_x4_trans(bq, b_base + 2 * (k * WS + np * 16));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], bq[0], bq[1]);
          mma_bf16(acc[mt][2 * np + 1], a[mt], bq[2], bq[3]);
        }
      }
    }
  }

  // epilogue: + bias, one rounding to bfloat16, staged, 16 bytes a thread
  __syncthreads();  // every warp is done reading the slab and the weights
  bf16* os = xs;    // [kM][kN + 8]
  const int OS = kN + kRowPad;
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = wn * 64 + nt * 8 + 2 * q;
    const float b0 = co0 + col < Cout ? bias[co0 + col] : 0.0f;
    const float b1 = co0 + col + 1 < Cout ? bias[co0 + col + 1] : 0.0f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int row = wm * 32 + mt * 16 + g;
      *reinterpret_cast<__nv_bfloat162*>(os + row * OS + col) =
          __floats2bfloat162_rn(acc[mt][nt][0] + b0, acc[mt][nt][1] + b1);
      *reinterpret_cast<__nv_bfloat162*>(os + (row + 8) * OS + col) =
          __floats2bfloat162_rn(acc[mt][nt][2] + b0, acc[mt][nt][3] + b1);
    }
  }
  __syncthreads();
  constexpr int n8 = kN / 8;
  for (int i = tid; i < kM * n8; i += kThr) {
    const int ch = i % n8, p = i / n8;
    const int co = co0 + ch * 8;
    if (p >= npix || t0 + p / F >= T || co >= Cout) continue;
    bf16* dst = out + (((long long)b * T + t0) * F + p) * Cout + co;
    const bf16* src = os + p * OS + ch * 8;
    if (vec_o && co + 8 <= Cout) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int j = 0; j < min(8, Cout - co); ++j) dst[j] = src[j];
    }
  }
}

constexpr int kWgWarps = 9;                // one warp per tap
constexpr int kWgThreads = 32 * kWgWarps;
constexpr int kWgCi = 64, kWgCo = 32;      // a block's input x output channel slice
constexpr int kWgXS = kWgCi + kRowPad;     // shared row strides (bfloat16)
constexpr int kWgYS = kWgCo + kRowPad;

// grid: (runs of tiles, B, classes * n_ci * n_co); slot = b * gridDim.x +
// run, of classes * (9*C*C + C) floats: one sum per output-frequency class.
// Dynamic shared memory: two buffers each of the x slab [(rows+2) * (F+2) +
// 1][72] (a zero cell last) and of the dy tile [kPix + 1][40] (a zero row
// last), bfloat16, and the class's pixel table (x cell, dy row) [kPix] x 2
// ints.
__global__ void __launch_bounds__(kWgThreads, 2)
conv3x3_wgrad_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                          float* __restrict__ partials, int T, int F, int C, int rows,
                          int tiles_per_block, int n_ci, int n_co, int classes, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid % 32, tap = tid / 32;
  const int b = blockIdx.y;
  const int per_class = n_ci * n_co;
  const int cls = blockIdx.z / per_class;
  const int ci0 = ((blockIdx.z % per_class) / n_co) * kWgCi;
  const int co0 = ((blockIdx.z % per_class) % n_co) * kWgCo;
  const int W2 = F + 2;
  const int n_cells = (rows + 2) * W2;  // time halo rows included
  const int zero_cell = n_cells;        // a zero cell follows the slab
  const int x_buf = (n_cells + 1) * kWgXS, y_buf = (kPix + 1) * kWgYS;
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [2][x_buf]
  bf16* ys = xs + 2 * x_buf;                     // [2][y_buf]
  int* xcell = reinterpret_cast<int*>(ys + 2 * y_buf);
  int* yrow = xcell + kPix;

  // the class's pixels of a tile, in order; past them -1 (the zero cell)
  // and the zero row
  const int per_row = F / classes;
  const int cnt = rows * per_row;
  for (int j = tid; j < kPix; j += kWgThreads) {
    if (j < cnt) {
      const int r = j / per_row, f = cls + classes * (j % per_row);
      xcell[j] = r * W2 + f;  // top-left tap of the window: x[t - 1, f - 1]
      yrow[j] = r * F + f;
    } else {
      xcell[j] = -1;
      yrow[j] = kPix;
    }
  }
  for (int i = tid; i < 2 * (kWgXS / 8); i += kWgThreads)
    *reinterpret_cast<uint4*>(xs + (i / (kWgXS / 8)) * x_buf + zero_cell * kWgXS + (i % (kWgXS / 8)) * 8) =
        make_uint4(0, 0, 0, 0);
  for (int i = tid; i < 2 * (kWgYS / 8); i += kWgThreads)
    *reinterpret_cast<uint4*>(ys + (i / (kWgYS / 8)) * y_buf + kPix * kWgYS + (i % (kWgYS / 8)) * 8) =
        make_uint4(0, 0, 0, 0);

  // pixel tile `tile` (its x slab and dy tile) into buffer buf
  auto stage_tile = [&](int tile, int buf) {
    const int t0 = tile * rows, trows = min(rows, T - t0);
    bf16* xb = xs + buf * x_buf;
    bf16* yb = ys + buf * y_buf;
    for (int i = tid; i < n_cells * (kWgCi / 8); i += kWgThreads) {
      const int ch = i % (kWgCi / 8), cell = i / (kWgCi / 8);
      const int t = t0 - 1 + cell / W2, f = cell % W2 - 1, ci = ci0 + ch * 8;
      int n = 0;
      const bf16* src = x;
      if (t >= 0 && t < T && f >= 0 && f < F && ci < C) {
        n = min(8, C - ci);
        src = x + (((long long)b * T + t) * F + f) * C + ci;
      }
      stage8(xb + cell * kWgXS + ch * 8, src, n, vec);
    }
    for (int i = tid; i < kPix * (kWgCo / 8); i += kWgThreads) {
      const int ch = i % (kWgCo / 8), p = i / (kWgCo / 8), co = co0 + ch * 8;
      int n = 0;
      const bf16* src = dy;
      if (p < trows * F && co < C) {
        n = min(8, C - co);
        src = dy + (((long long)b * T + t0) * F + p) * C + co;
      }
      stage8(yb + p * kWgYS + ch * 8, src, n, vec);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
  float dbacc[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dbacc[nt][e] = 0.0f;
  const bool owns_db = tap == 0 && ci0 == 0;
  const uint32_t ones[4] = {0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u};  // bfloat16 1.0

  const int toff = (tap / 3) * W2 + tap % 3;
  // A = x^T (input channels x pixels): lane -> pixel (lane % 8) + 8 (lane / 16),
  // channel offset 8 ((lane / 8) % 2); B = dy (pixels x output channels): lane
  // -> pixel (lane % 8) + 8 ((lane / 8) % 2), channel offset 8 (lane / 16)
  const int a_pix = lane % 8 + (lane / 16) * 8, a_off = ((lane / 8) % 2) * 8;
  const int b_pix = lane % 8 + ((lane / 8) % 2) * 8, b_off = (lane / 16) * 8;

  const int n_tiles = (T + rows - 1) / rows;
  const int first = blockIdx.x * tiles_per_block;
  const int last = min(n_tiles, first + tiles_per_block);
  if (first < last) stage_tile(first, 0);
  cp_async_commit();
  for (int tile = first; tile < last; ++tile) {
    const int buf = (tile - first) & 1;
    cp_async_wait_all();
    __syncthreads();  // this tile landed; every warp is done with the other buffer
    if (tile + 1 < last) {  // the next tile loads while this one multiplies
      stage_tile(tile + 1, buf ^ 1);
      cp_async_commit();
    }
    const bf16* xb = xs + buf * x_buf;
    const bf16* yb = ys + buf * y_buf;
    const int steps = (min(rows, T - tile * rows) * per_row + 15) / 16;
    for (int ks = 0; ks < steps; ++ks) {
      const int xc = xcell[ks * 16 + a_pix];
      const uint32_t a_base = smem_addr(xb + (xc < 0 ? zero_cell : xc + toff) * kWgXS + a_off);
      const uint32_t b_base = smem_addr(yb + yrow[ks * 16 + b_pix] * kWgYS + b_off);
      uint32_t bq[2][4];
#pragma unroll
      for (int np = 0; np < 2; ++np) ldmatrix_x4_trans(bq[np], b_base + 2 * 16 * np);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, a_base + 2 * 16 * mt);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          mma_bf16(acc[mt][2 * np], a, bq[np][0], bq[np][1]);
          mma_bf16(acc[mt][2 * np + 1], a, bq[np][2], bq[np][3]);
        }
      }
      if (owns_db) {
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          mma_bf16(dbacc[2 * np], ones, bq[np][0], bq[np][1]);
          mma_bf16(dbacc[2 * np + 1], ones, bq[np][2], bq[np][3]);
        }
      }
    }
  }

  // row g (input channel), columns 2q, 2q + 1 (output channels) of each fragment
  const int slot = b * gridDim.x + blockIdx.x;
  const long long width = 9LL * C * C + C;
  float* ps = partials + ((long long)slot * classes + cls) * width;
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ci = ci0 + mt * 16 + g + 8 * h, co = co0 + nt * 8 + 2 * q;
        if (ci >= C) continue;
        float* dst = ps + ((long long)tap * C + ci) * C + co;
        if (co < C) dst[0] = acc[mt][nt][2 * h];
        if (co + 1 < C) dst[1] = acc[mt][nt][2 * h + 1];
      }
  if (owns_db && g == 0) {  // every row of ones . dy holds the column sums
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int co = co0 + nt * 8 + 2 * q;
      if (co < C) ps[9LL * C * C + co] = dbacc[nt][0];
      if (co + 1 < C) ps[9LL * C * C + co + 1] = dbacc[nt][1];
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int MI, bool kFlip>
int launch_conv_f32_tile(const float* x, const float* w, const float* bias, float* out, int B, int T,
                         int F, int Cin, int Cout, int kc, cudaStream_t stream) {
  const int rows = 16 * MI / F;
  const size_t smem = conv_f32_smem(rows, F, Cin, kc);
  cudaError_t err = cudaFuncSetAttribute(conv3x3_nhwc_kernel<MI, kFlip>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + rows - 1) / rows, B, (Cout + kCvN - 1) / kCvN);
  const int wrow = kFlip ? Cin : Cout;  // the weights' contiguous dimension
  conv3x3_nhwc_kernel<MI, kFlip><<<grid, kCvThreads, smem, stream>>>(
      x, w, bias, out, T, F, Cin, Cout, rows, kc, Cin % 4 == 0 && aligned16(x),
      wrow % 4 == 0 && aligned16(w), Cout % 4 == 0 && aligned16(out));
  return (int)cudaGetLastError();
}

// pix: output pixels a tile (128, or 64 where F <= 64); kc: input channels
// a weight slice (a power of two from 4 to 64); both from
// ops/packed_conv.conv_plan.
int launch_conv_f32(const void* xv, const void* wv, const void* biasv, void* outv, int B, int T,
                    int F, int Cin, int Cout, int flip, int pix, int kc, cudaStream_t st) {
  if ((pix != 128 && pix != 64) || F > pix || kc < 4 || kc > 64 || (kc & (kc - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const auto* x = static_cast<const float*>(xv);
  const auto* w = static_cast<const float*>(wv);
  const auto* bias = static_cast<const float*>(biasv);
  auto* out = static_cast<float*>(outv);
  if (pix == 128)
    return flip ? launch_conv_f32_tile<8, true>(x, w, bias, out, B, T, F, Cin, Cout, kc, st)
                : launch_conv_f32_tile<8, false>(x, w, bias, out, B, T, F, Cin, Cout, kc, st);
  return flip ? launch_conv_f32_tile<4, true>(x, w, bias, out, B, T, F, Cin, Cout, kc, st)
              : launch_conv_f32_tile<4, false>(x, w, bias, out, B, T, F, Cin, Cout, kc, st);
}

template <int WM, int WN>
int launch_conv_bf16_tile(const bf16* x, const bf16* w, const float* bias, bf16* out, int B,
                          int T, int F, int Cin, int Cout, cudaStream_t stream) {
  constexpr int kM = 32 * WM, kN = 64 * WN;
  const int rows = kM / F;
  // input channels padded to a multiple of 16 (32 above 64) and taken in slices of at most 64
  const int cin_p = Cin <= 64 ? (Cin + 15) / 16 * 16 : (Cin + 31) / 32 * 32;
  const int kc = cin_p <= 64 ? cin_p : cin_p / 2;
  const size_t body = 2 * ((size_t)(rows + 2) * (F + 2) * (cin_p + kRowPad) +
                           2 * (size_t)kc * (kN + kRowPad));
  const size_t tile = 2 * (size_t)kM * (kN + kRowPad);
  const size_t smem = body > tile ? body : tile;
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_bf16_kernel<WM, WN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + rows - 1) / rows, B, (Cout + kN - 1) / kN);
  conv3x3_bf16_kernel<WM, WN><<<grid, 32 * WM * WN, smem, stream>>>(
      x, w, bias, out, T, F, Cin, Cout, rows, cin_p, kc, Cin % 8 == 0 && aligned16(x),
      Cout % 8 == 0 && aligned16(w), Cout % 8 == 0 && aligned16(out));
  return (int)cudaGetLastError();
}

int launch_conv_bf16(const void* xv, const void* wv, const void* biasv, void* outv, int B, int T,
                     int F, int Cin, int Cout, cudaStream_t st) {
  const auto* x = static_cast<const bf16*>(xv);
  const auto* w = static_cast<const bf16*>(wv);
  const auto* bias = static_cast<const float*>(biasv);
  auto* out = static_cast<bf16*>(outv);
  const bool wide = Cout > 64;  // 128 output channels a block, else 64
  const int rows = kPix / F, kN = wide ? 128 : 64;
  const long long blocks = (long long)((T + rows - 1) / rows) * B * ((Cout + kN - 1) / kN);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const bool half = F <= 64 && blocks < 2 * sms;  // 64-pixel tiles: more blocks
  if (wide)
    return half ? launch_conv_bf16_tile<2, 2>(x, w, bias, out, B, T, F, Cin, Cout, st)
                : launch_conv_bf16_tile<4, 2>(x, w, bias, out, B, T, F, Cin, Cout, st);
  return half ? launch_conv_bf16_tile<2, 1>(x, w, bias, out, B, T, F, Cin, Cout, st)
              : launch_conv_bf16_tile<4, 1>(x, w, bias, out, B, T, F, Cin, Cout, st);
}

int launch_wgrad(const void* x, const void* dy, void* partials, void* out, int B, int T, int F,
                 int C, int tiles_per_block, int bf16_mode, int classes, int buffers,
                 cudaStream_t st) {
  const int rows = kPix / F;
  const int n_tiles = (T + rows - 1) / rows;
  const int n_classes = classes > 0 ? classes : 1;
  const int runs = (n_tiles + tiles_per_block - 1) / tiles_per_block;
  cudaError_t err;
  if (bf16_mode) {
    const size_t smem = 4 * ((size_t)((rows + 2) * (F + 2) + 1) * kWgXS + (size_t)(kPix + 1) * kWgYS) +
                        2 * sizeof(int) * kPix;  // two buffers of bfloat16, the pixel table
    err = cudaFuncSetAttribute(conv3x3_wgrad_bf16_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int n_ci = (C + kWgCi - 1) / kWgCi, n_co = (C + kWgCo - 1) / kWgCo;
    const dim3 grid(runs, B, n_classes * n_ci * n_co);
    conv3x3_wgrad_bf16_kernel<<<grid, kWgThreads, smem, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(dy), static_cast<float*>(partials),
        T, F, C, rows, tiles_per_block, n_ci, n_co, n_classes,
        C % 8 == 0 && aligned16(x) && aligned16(dy));
  } else {
    if (buffers != 1 && buffers != 2) return (int)cudaErrorInvalidValue;
    const size_t smem =
        sizeof(float) * buffers * ((size_t)(rows + 2) * (F + 2) + (size_t)rows * F) * kWfC;
    err = cudaFuncSetAttribute(conv3x3_wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int n_c = (C + kWfC - 1) / kWfC;
    const dim3 grid(runs, B, n_c * n_c);
    conv3x3_wgrad_kernel<<<grid, kWfThreads, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), static_cast<float*>(partials),
        T, F, C, rows, tiles_per_block, n_c, buffers,
        C % 4 == 0 && aligned16(x) && aligned16(dy) && aligned16(partials));
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const auto* pa = static_cast<const float*>(partials);
  auto* o = static_cast<float*>(out);
  const int width = 9 * C * C + C;
  const int slots = runs * B;
  if (classes == 0)  // one float32 sum, not rounded
    return (int)launch_fold<float>(pa, o, slots, width, st);
  return (int)launch_fold_classes<float, bf16>(pa, o, slots, width, classes,
                                               (long long)classes * width, width, 9 * C * C, st);
}

}  // namespace

extern "C" {

// x: [B, T, F, Cin]; w: [3, 3, Cin, Cout] (HWIO); bias: [Cout];
// out: [B, T, F, Cout]; contiguous. x, w and out float32, or bfloat16 when
// bf16 != 0; bias float32. F <= 128 (one block's pixel tile holds whole
// frequency rows); the caller checks that the shared memory fits
// (ops/packed_conv.py:applicable). float32 only: flip != 0 runs the input
// gradient's conv, out = dx [B, T, F, Cout] of dy = x [B, T, F, Cin] through
// the forward conv whose weights w are [3, 3, Cout, Cin], read flipped in
// both taps and transposed, by index; bias may be null (no bias); pix and kc
// are the launch plan (ops/packed_conv.conv_plan). bfloat16 ignores flip,
// pix and kc and takes a bias.
int dcase_conv3x3(const void* x, const void* w, const void* bias, void* out, int B,
                  int T, int F, int Cin, int Cout, int bf16, int flip, int pix, int kc,
                  void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_conv_bf16(x, w, bias, out, B, T, F, Cin, Cout, st)
              : launch_conv_f32(x, w, bias, out, B, T, F, Cin, Cout, flip, pix, kc, st);
}

// x, dy: [B, T, F, C], float32 or (bf16 != 0) bfloat16; partials:
// [B * ceil(tiles / tiles_per_block), max(classes, 1) * (9*C*C + C)] float32
// scratch, tiles = ceil(T / (128 / F)); out: [9*C*C + C] float32 = dW
// [3, 3, C, C] (HWIO) | db [C]; all contiguous. F <= 128. classes 0 (float32
// only): dW is the float32 sum; classes k >= 1 (bfloat16 only): dW is the sum
// over output-frequency classes f mod k of each class's sum rounded to
// bfloat16 (the gradient of the bfloat16 weights as the lane-packed original
// folds it); db is never rounded. buffers (float32 only): the shared tile
// buffers, 2 where they fit the block's shared memory, else 1
// (ops/packed_conv.wgrad_buffers).
int dcase_conv3x3_wgrad(const void* x, const void* dy, void* partials, void* out, int B,
                        int T, int F, int C, int tiles_per_block, int bf16, int classes,
                        int buffers, void* stream) {
  if ((bf16 != 0) != (classes > 0)) return (int)cudaErrorInvalidValue;
  return launch_wgrad(x, dy, partials, out, B, T, F, C, tiles_per_block, bf16, classes, buffers,
                      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
