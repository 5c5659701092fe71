// K4 / K5 / K6: the first CRNN block, conv 3x3 from ONE input channel ->
// BatchNorm -> GLU -> dropout -> average pool, forward and backward, on
// float32 or bfloat16 activations, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of
//   dcase2019_task4_tpu/ops/entry_conv.py         _fwd_kernel, _wgrad_kernel
//   dcase2019_task4_tpu/ops/fused_entry_block.py  _stats_kernel, _fwd_kernel,
//                                                 _bwd_reduce_kernel, _bwd_wgrad_kernel
//   dcase2019_task4_tpu/ops/crows_block.py        the same four functions with
//                                                 channels on TPU sublanes
// by one kernel family:
//   entry_conv_kernel<MODE>        conv + bias, y stored, per-channel sum y and
//                                  sum y^2 (K4f), float32; MODE 1 compiles the
//                                  store out (statistics of a y that is never
//                                  written: entry_conv_stats, the ablation of
//                                  K5s); MODE 2 and 3 are the ablations of
//                                  tools/bench_entry_conv_torch.py
//   entry_conv_run_kernel<TX, kStore>
//                                  the same over one wave of equal runs: on
//                                  bfloat16 x K4f (kStore) and K5s / K6s (no
//                                  store), on float32 x K5s / K6s
//   entry_conv_dw_f32_kernel       dW = patches^T . dy, db = sum dy (K4w) over one
//                                  wave of equal runs, float32, FP32 FMAs;
//                                  entry_conv_dw_bf16_kernel on bfloat16 x,
//                                  on the tensor cores
//   entry_block_fwd_f32_kernel     conv -> BN -> GLU -> dropout -> pool (K5f),
//                                  float32, on FP32 register tiles;
//                                  entry_block_fwd_bf16_kernel on bfloat16 x,
//                                  on the tensor cores
//   entry_block_bwd_reduce_f32_kernel
//                                  recompute; d glu_w, d glu_b, S1, S2 (K5b1),
//                                  float32, on FP32 register tiles;
//                                  entry_block_bwd_reduce_bf16_kernel on
//                                  bfloat16 x, on the tensor cores
//   entry_block_bwd_wgrad_f32_kernel
//                                  recompute; dy over the y tile; dW, d conv_b
//                                  (K5b2), float32, on FP32 register tiles;
//                                  entry_block_bwd_wgrad_bf16_kernel on
//                                  bfloat16 x, on the tensor cores
//   dropout_mask_kernel            the keep-mask alone, for tests
// The parity planes, the [12, 128] patch basis, the 8-row halo blocks, the
// shifted row copies and lane rolls, the 0/1 pooling matrices and the
// block-diagonal GLU weights of the originals are TPU layout and are not
// carried over: the kernels read x [B, T, F] and logical [3, 3, 1, C], [C]
// and [C, C] parameters. The features carry no gradient, so there is no dx.
//
// Function, per pixel (t, f) of clip b, channel c (zeros outside the tensor):
//   y[c] = cb[c] + sum_{dt, df} x[t + dt - 1, f + df - 1] * w[dt, df, c]
// then the chain of fused_block.cu (xh, xn, lin, sig, g, mask, pool) on y.
// Backward, with dh, dlin, dxn as there, in two passes with a host-side step
// between (a, b2 from the folded S1, S2):
//   pass 1: d glu_w += xn^T . dlin; d glu_b += dlin; S1 += dxn; S2 += dxn * xh
//   pass 2: dy = rsqrt(var + eps) * scale * dxn - a - (y - mean) * b2
//           dW[dt, df, c] += x[t + dt - 1, f + df - 1] * dy[c]; d cb += dy
// Neither y nor dy ever reaches device memory in K5. The dropout mask is the
// one of fused_block.cu (chain.cuh): Philox4x32-10 on (seed, global element
// index of [B, T, F, C] / 4), or / 16 in the packed 8-bit draw
// (DCASE_DROPOUT_PACK), regenerated in both backward passes.
//
// Bound at the flagship shape (x [24, 864, 64], C = 64): K4f writes y (340 MB,
// 0.10 ms at 3.35 TB/s; bfloat16 170 MB, 0.05 ms) for 1.8 GFLOP: bytes. K4w
// reads dy: bytes. K5s moves 5 MB for 1.8 GFLOP with the sums: operations
// (0.03 ms at the FP32 rate; in bfloat16 0.005 ms at the tensor cores' rate,
// below the 0.03 ms that its conv in conv9's order of FP32 FMAs, on which K5f
// bfloat16's bits rest, can reach). K5f moves 48 MB for
// the conv and one 64x64 channel product per pixel (13.4 GFLOP with the
// elementwise chain, 0.20 ms at 67 TFLOP/s): operations. Pass 1 needs the
// conv once and three channel products (lin, dxn, d glu_w: 36.0 GFLOP with
// the chain, 0.54 ms), pass 2 the conv, dW and two products (lin, dxn:
// 26.8 GFLOP, 0.40 ms): operations. In bfloat16 the channel products and dW
// take the tensor cores (989 TFLOP/s): the element chain at the FP32 rate
// then bounds the forward and both passes (0.03-0.06 ms each).
//
// Design: a tile is whole time rows of up to 128 pixels, whole pooling rows
// in the fused kernels (the tiling of fused_block.cu). Per tile a block
// stages x with a one-cell halo, zeros outside the tensor, into shared
// memory: (rows + 2) x (F + 2) floats. K4f in float32 takes one block per
// (run of pixel tiles, clip): a thread owns four neighbouring channels (their
// 36 weights in registers) of every (256 / (C / 4))-th pixel, stores y as
// float4 and sums in double. K5s in both types and K4f in bfloat16 run one
// wave of equal runs of time rows in tiles of several rows, x a tile ahead,
// each thread forming runs of four pixels from one shared window and summing
// in float32 a tile (see entry_conv_run_kernel). K4w runs one wave of equal
// runs of time rows too, dy streamed a tile ahead by cp.async (see
// entry_conv_dw_f32_kernel). The six K5 kernels with a channel product
// compute y once a tile, in conv9's order (K4f's), into the tile their K2
// counterpart stages y into, and run that counterpart's per-tile code on it,
// over one wave of the resident blocks in equal runs of the batch's tiles:
// in float32 K2's FP32 register-tile code (f32_tile.cuh: K5f K2f's forward,
// K5b1 K2b's reduce pass, K5b2 the recompute fixup's dxn and dy, then dW
// from the dy tile; see the comments at entry_block_bwd_reduce_f32_kernel
// and entry_block_fwd_f32_kernel), in bfloat16 K2's tensor-core tile code
// (bf16_tile.cuh, mma.sync; see the comments at entry_block_fwd_bf16_kernel
// and bwd_bf16_body). So each pass computes the conv once, as the bound
// counts it. Sums across blocks go to one slot per block and fold_kernel
// adds the slots in slot order in double: no float atomics, a run repeats
// bit for bit. Plain FP32 FMAs, no TF32, but for the bfloat16 products.
//
// Element type: every function is computed for float32 and for bfloat16
// (the model's compute dtype, `act_bf16` / `lp` in the originals). In
// bfloat16 the arithmetic stays float32 and rounds where the JAX kernels
// round (entry_conv.py:84,109-148, fused_entry_block.py:97-236,
// crows_block.py:176-290): x is read as bfloat16 (the features rounded once,
// as make_parity_planes does) and the conv weights come rounded from the
// wrapper, so every conv product is exact in float32; the float32 conv bias
// is added and y is rounded to bfloat16, which K4f stores, and whose rounded
// values every sum and every later step reads (K5s's sums, xn, x-hat, dy);
// xn and W enter lin = xn . W, dlin and W enter dxn = dlin . W^T, and xn and
// dlin enter d glu_w, as bfloat16; d glu_b, S1, S2, d conv_b and the sums of
// y stay float32. The pooled output is stored in bfloat16, after one of the
// originals' two window sums: the planes kernel (fused_entry_block.py, via
// fused_block._pool_mxu) rounds each pt-row column sum of g to bfloat16 and
// adds the columns, as K2 does; the crows kernel (crows_block.py:240-245)
// rounds every g to bfloat16 and adds the window (pool_elems). The weight
// gradient (K4w, K5b2) multiplies the rounded x by dy rounded to bfloat16
// and comes out as the gradient of the bfloat16 weights the originals
// differentiate, which they round to bfloat16 in two parts before the parts
// fold onto w: by output-frequency parity in the parity-plane basis
// (entry_conv.py:65-77,232, fused_entry_block.py:416), by batch half in the
// crows basis (crows_block.py:105-115,535). The kernels keep the parts apart
// (K4w and K5b2: the pixels in class order; K5b2 in the crows basis the blocks
// in batch halves) and fold_classes_kernel (K4w: fold_classes_warps_kernel)
// rounds each part's sum and adds the rounded parts.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bf16_tile.cuh"
#include "chain.cuh"
#include "cp_async.cuh"
#include "dtype.cuh"
#include "f32_tile.cuh"
#include "fold.cuh"
#include "mma.cuh"

namespace {

constexpr int kHalo = 4 * kPix; // floats of a staged x tile: (rows + 2) * (F + 2) <= 390

// Time rows per tile: whole pooling rows, up to kPix pixels (pt * F <= kPix).
int rows_per_tile(int F, int pt) { return pt * (kPix / (pt * F)); }

// x[b, t0 - 1 .. t0 + trows, -1 .. F] -> xt [trows + 2][F + 2], zeros outside.
__device__ __forceinline__ void stage_x(float* xt, const float* __restrict__ x, int b, int T,
                                        int F, int t0, int trows) {
  const int FW = F + 2;
  const int n = (trows + 2) * FW;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / FW, q = i % FW;
    const int t = t0 - 1 + r, f = q - 1;
    xt[i] = (t >= 0 && t < T && f >= 0 && f < F) ? x[((long long)b * T + t) * F + f] : 0.0f;
  }
}

// One conv output: r points at the top-left cell of the pixel's 3x3 patch in
// the staged tile (row stride FW); w holds one channel's nine taps.
__device__ __forceinline__ float conv9(const float* r, int FW, const float (&w)[9], float cb) {
  float y = cb;
#pragma unroll
  for (int dt = 0; dt < 3; ++dt)
#pragma unroll
    for (int df = 0; df < 3; ++df) y = fmaf(r[dt * FW + df], w[dt * 3 + df], y);
  return y;
}

// ------------------------------------------------------- K4: the conv alone

// Float32. MODE 0: store y and emit the sums. MODE 1: the sums only (y never
// written). MODE 2: one tap instead of nine (no patch). MODE 3: write the
// bias only. bfloat16 x, and K5s on float32 x, go to entry_conv_run_kernel
// below.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
entry_conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ cb, float* __restrict__ y,
                  double* __restrict__ partials, int T, int F, int C, int rows,
                  int tiles_per_block) {
  __shared__ float xt[kHalo];
  extern __shared__ double dred[];  // [groups][2 * C]
  const int tid = threadIdx.x;
  const int lanes = C / 4, groups = kThreads / lanes;
  const int lane = tid % lanes, grp = tid / lanes;
  const bool active = grp < groups;
  const int b = blockIdx.y;
  const int FW = F + 2;

  float wr[4][9], br[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    br[k] = cb[4 * lane + k];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) wr[k][tap] = w[tap * C + 4 * lane + k];
  }
  double s[4] = {0.0, 0.0, 0.0, 0.0}, q[4] = {0.0, 0.0, 0.0, 0.0};

  const int n_tiles = (T + rows - 1) / rows;
  const int first = blockIdx.x * tiles_per_block;
  const int last = min(n_tiles, first + tiles_per_block);
  for (int tile = first; tile < last; ++tile) {
    const int t0 = tile * rows;
    const int trows = min(rows, T - t0);
    const int tpix = trows * F;
    __syncthreads();  // the previous tile's patches are read
    if (MODE != 3) stage_x(xt, x, b, T, F, t0, trows);
    __syncthreads();
    if (!active) continue;
    for (int p = grp; p < tpix; p += groups) {
      const float* r = xt + (p / F) * FW + (p % F);
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (MODE == 3) v[k] = br[k];
        else if (MODE == 2) v[k] = fmaf(r[FW + 1], wr[k][4], br[k]);
        else v[k] = conv9(r, FW, wr[k], br[k]);
      }
      if (MODE != 1)
        Vec4<float>::store(y + (((long long)b * T + t0) * F + p) * C + 4 * lane,
                        make_float4(v[0], v[1], v[2], v[3]));
      if (MODE != 3) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          s[k] += v[k];
          q[k] += (double)v[k] * v[k];
        }
      }
    }
  }

  if (active) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      dred[grp * 2 * C + 4 * lane + k] = s[k];
      dred[grp * 2 * C + C + 4 * lane + k] = q[k];
    }
  }
  __syncthreads();
  const int slot = blockIdx.y * gridDim.x + blockIdx.x;
  for (int i = tid; i < 2 * C; i += kThreads) {
    double t = 0.0;
    for (int g = 0; g < groups; ++g) t += dred[g * 2 * C + i];
    partials[(long long)slot * 2 * C + i] = t;
  }
}

// ------------------------------------------------------ K4w: one wave of runs

// dW[tap][c] = sum x[t + dt - 1, f + df - 1] dy[t, f, c] (tap 3 dt + df) and
// db[c] = sum dy[t, f, c], zeros outside the tensor: on float32 x and dy in
// FP32 FMAs (entry_conv_dw_f32_kernel), on bfloat16 x and dy on mma.sync
// with every product exact (entry_conv_dw_bf16_kernel), the bfloat16 dW in
// the parts the original rounds apart (output-frequency parity, F even). K4w
// reads dy once: bytes bound it (340 MB in float32, 170 MB in bfloat16 at the
// flagship shape: 0.103 / 0.052 ms at 3.35 TB/s; its 1.53 GFLOP take 0.023 ms
// at the FP32 rate).
//
// Launch plan of both: one wave of the resident blocks (the wrapper sizes it
// from dcase_entry_conv_wgrad_resident), block k of G taking time rows [k n /
// G, (k + 1) n / G) of the n = B T rows of the batch, clip after clip, cut
// into tiles of up to `rows` rows inside a clip (at most kDwTilePix pixels;
// a clip's or a run's last tile shorter). A tile's dy is one stretch of
// device memory; it goes into shared memory by 16-byte cp.async (8-byte in
// bfloat16 where C % 8 == 4) a tile ahead, into the other of two buffers, so
// that a whole tile is in flight while the block multiplies the one before:
// one barrier a tile. Three blocks an SM at the flagship shape (tiles of two
// rows, 32 KB of dy in float32, 16 KB in bfloat16; ops/entry_conv.wgrad_plan).
// Each block writes one slot, classes x [9 C dW (tap-major) | C db];
// fold_classes_warps_kernel adds the slots in a fixed order (a warp a
// column): a run repeats bit for bit.
//
// float32: the tile's x with its one-cell halo [trows + 2][F + 2] comes by
// cp.async beside its dy; dW and db from the dy tile with K5b2 float32's loop
// (add_dw_f32): thread (s, q) takes the ten rows (nine taps, db) for channels
// 4 q .. 4 q + 3 of the pixels s, s + S, ... (S = 256 / (C / 4)): 40 sums in
// registers, dy by LDS.128 once a pixel, the patch from the staged x.
//
// bfloat16: dW = patches^T . dy on mma.sync m16n8k16 (M: the nine taps, a row
// of ones for db, zeros to 16; N: channels; K: the tile's pixels). x is
// bfloat16, so each patch value is exact in the operand; dy is read as
// stored. Under the parity partition pixel p is column k = (p % 2) H + p / 2
// of both operands (H = kDwTilePix / 2; dy's rows land there by cp.async),
// so the k-chunks below H hold even output frequencies and those above odd
// ones, summed apart to the slot; else k = p. A tile's patch matrix is
// gathered from x into registers while the tile before multiplies and stored
// after it, into the other of two buffers.
constexpr int kDwThreads = 256;        // threads of a block
constexpr int kDwTilePix = 128;        // pixels of a tile, at most: the bfloat16 product's K
constexpr int kDwKS = kDwTilePix + 8;  // row stride of the patch matrix: an odd number of 16-byte units

// Floats of a staged x tile with its halo, rounded up to four.
__host__ __device__ inline int dw_halo(int F, int rows) { return 4 * (((rows + 2) * (F + 2) + 3) / 4); }

// Pixel shares of the float32 kernel's threads.
__host__ __device__ inline int dw_shares(int C) { return kDwThreads / (C / 4); }

// Dynamic shared memory of the float32 kernel at tiles of `rows` rows
// (ops/entry_conv.wgrad_plan computes the same): two dy tiles [rows F][C] (at
// the end the shares' sums [S][10][C], where they take more) and two x tiles.
size_t dw_f32_smem(int F, int C, int rows) {
  const size_t tiles = 2 * (size_t)rows * F * C, shares = (size_t)dw_shares(C) * 10 * C;
  return 4 * ((tiles > shares ? tiles : shares) + 2 * (size_t)dw_halo(F, rows));
}

// Dynamic shared memory of the bfloat16 kernel at CP = 64 or 128 padded
// channels (ops/entry_conv.wgrad_plan computes the same): two dy tiles
// [kDwTilePix][CP + 8] and two patch matrices [16][kDwKS], bfloat16.
template <int CP>
constexpr size_t dw_bf16_smem() {
  return 2 * (2 * (size_t)kDwTilePix * (CP + 8) + 2 * 16 * (size_t)kDwKS);
}

// dW[row0 + k][4 sq + e] += x[p + tap] dy[p][4 sq + e] for the R rows row0 ..
// row0 + R - 1 (row 9: d conv_b, x = 1) over the pixels p = sh, sh + S, ... <
// tpix of a tile: dy's rows at dyt + p ds, x with its halo in xt [rows + 2][F
// + 2], off[k] the place of row row0 + k's tap in a pixel's patch. K5b2
// float32 takes five rows a thread (its two thread halves), K4w float32 all
// ten.
template <int R>
__device__ __forceinline__ void add_dw_f32(float (&dw)[4][R], const float* dyt, int ds, const float* xt,
                                           const int (&off)[R], int F, int tpix, int sh, int S, int sq, int row0) {
  const int FW = F + 2, dpr = S / F, dpc = S % F;  // a pixel step of S in rows and columns
  int pr = sh / F, pc = sh % F;
  for (int p = sh; p < tpix; p += S) {
    const float4 d4 = ld4(dyt + p * ds + 4 * sq);
    const float d[4] = {d4.x, d4.y, d4.z, d4.w};
    const float* r = xt + pr * FW + pc;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const float xv = k == R - 1 && row0 + k == 9 ? 1.0f : r[off[k]];
#pragma unroll
      for (int e = 0; e < 4; ++e) dw[e][k] = fmaf(xv, d[e], dw[e][k]);
    }
    pc += dpc;
    pr += dpr;
    if (pc >= F) {
      pc -= F;
      ++pr;
    }
  }
}

// x, dy float32 [B, T, F], [B, T, F, C]; a slot [10 C] a block.
__global__ void __launch_bounds__(kDwThreads)
entry_conv_dw_f32_kernel(const float* __restrict__ x, const float* __restrict__ dy, float* __restrict__ partials,
                         int B, int T, int F, int C, int rows) {
  extern __shared__ __align__(16) float smem_e[];
  const int tid = threadIdx.x, FW = F + 2, Q = C / 4, S = dw_shares(C);
  const int sq = tid % Q, sh = tid / Q;  // channels 4 sq .. of the pixels sh, sh + S, ...
  const int tile = rows * F * C, halo = dw_halo(F, rows);
  float* dys = smem_e;  // [2][rows F][C]: dy (at the end [S][10][C]: the shares' sums)
  float* xts = dys + (2 * tile > S * 10 * C ? 2 * tile : S * 10 * C);  // [2][halo]: x with its halo
  int off[10];      // tap k at r[off[k]] of a pixel's patch r
  float dw[4][10];  // this thread's share of dW[k][4 sq + e] (of db at row 9)
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    off[k] = k < 9 ? (k / 3) * FW + k % 3 : 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) dw[e][k] = 0.0f;
  }

  // this block's time rows: the tile it multiplies starts at cur, the next
  // one to load at ahead
  const long long n = (long long)B * T;
  const int r_end = (int)((blockIdx.x + 1) * n / gridDim.x);
  int cur = (int)(blockIdx.x * n / gridDim.x), ahead = cur;
  auto trows_at = [&](int r) { return min(min(rows, T - r % T), r_end - r); };
  // dy of the tile at row `ahead` (contiguous) and x with its halo into
  // buffer buf by cp.async, as one group (empty past the run)
  auto stage = [&](int buf) {
    if (ahead < r_end) {
      const int b = ahead / T, t0 = ahead % T, trows = trows_at(ahead);
      const float* src = dy + (long long)ahead * F * C;
      float* dst = dys + buf * tile;
      for (int i = tid; i < trows * F * C / 4; i += kDwThreads) cp_async16(dst + 4 * i, src + 4 * i, 16);
      float* xt = xts + buf * halo;
      for (int i = tid; i < (trows + 2) * FW; i += kDwThreads) {
        const int t = t0 - 1 + i / FW, f = i % FW - 1;
        const bool ok = t >= 0 && t < T && f >= 0 && f < F;
        cp_async4(xt + i, ok ? x + ((long long)b * T + t) * F + f : x, ok ? 4 : 0);
      }
      ahead += trows;
    }
    cp_async_commit();
  };

  stage(0);
  for (int buf = 0; cur < r_end; buf ^= 1) {
    const int trows = trows_at(cur);
    cp_async_wait_all();
    __syncthreads();  // this tile's dy and x landed; every thread is done with the other buffers
    stage(buf ^ 1);   // the next tile loads while this one multiplies
    if (sh < S) add_dw_f32<10>(dw, dys + buf * tile, C, xts + buf * halo, off, F, trows * F, sh, S, sq, 0);
    cur += trows;
  }

  // the block's slot: the S shares added in share order, over the dy tiles' memory
  cp_async_wait_all();
  __syncthreads();  // every thread is done with the last tile
  float* red = smem_e;  // [S][10][C]
  if (sh < S) {
#pragma unroll
    for (int k = 0; k < 10; ++k)
      st4(red + (sh * 10 + k) * C + 4 * sq, make_float4(dw[0][k], dw[1][k], dw[2][k], dw[3][k]));
  }
  __syncthreads();
  float* ps = partials + (long long)blockIdx.x * 10 * C;
  for (int i = tid; i < 10 * C; i += kDwThreads) {
    float v = 0.0f;
    for (int g = 0; g < S; ++g) v += red[g * 10 * C + i];
    ps[i] = v;
  }
}

// x, dy bfloat16 [B, T, F], [B, T, F, C], C <= CP (64 or 128); a slot
// classes x [10 C] a block (classes 2 under parity: F even).
template <int CP>
__global__ void __launch_bounds__(kDwThreads)
entry_conv_dw_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy, float* __restrict__ partials,
                          int B, int T, int F, int C, int rows, int parity) {
  constexpr int RS = CP + 8;              // row stride of a dy tile: an odd number of 16-byte units
  constexpr int NW = kDwThreads / 32, NP = CP / 16, NS = NW / NP;  // warps: channel pairs of fragments, k-slices
  constexpr int H = kDwTilePix / 2, NG = (9 * H + kDwThreads - 1) / kDwThreads;  // a thread's patch pairs
  static_assert(NW % NP == 0 && (H / 16) % NS == 0, "warp layout");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* dys = reinterpret_cast<bf16*>(smem_raw);  // [2][kDwTilePix][RS]: dy, rows in k order
  bf16* pms = dys + 2 * kDwTilePix * RS;          // [2][16][kDwKS]: patches^T, columns in k order
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, g = lane / 4, q = lane % 4;
  auto pixel = [&](int k) { return parity ? 2 * (k % H) + k / H : k; };

  // rows 9 (ones: db) to 15 (zeros) of both patch matrices, once
  for (int i = tid; i < 2 * 7 * kDwKS; i += kDwThreads) {
    const int m = i / (7 * kDwKS), j = i % (7 * kDwKS);
    pms[(m * 16 + 9) * kDwKS + j] = __float2bfloat16_rn(j < kDwKS ? 1.0f : 0.0f);
  }

  // this block's time rows: the tile it multiplies starts at cur, the next
  // one to load at ahead
  const long long n = (long long)B * T;
  const int r_end = (int)((blockIdx.x + 1) * n / gridDim.x);
  int cur = (int)(blockIdx.x * n / gridDim.x), ahead = cur;
  auto trows_at = [&](int r) { return min(min(rows, T - r % T), r_end - r); };
  // dy of the tile at row `ahead` into buffer buf by cp.async, pixel p at row
  // k, zeros at the rows of no pixel of the tile, as one group (empty past
  // the run): thread tid copies column chunk tid % per of rows tid / per, +
  // 256 / per, ...
  const int cw = C % 8 == 0 ? 8 : 4, per = C / cw;  // 16-byte copies of 8 channels, else 8-byte of 4
  const int kstep = kDwThreads / per, c_own = cw * (tid % per), k_own = tid / per;
  auto stage = [&](int buf) {
    if (ahead < r_end) {
      const int tpix = trows_at(ahead) * F;
      const bf16* src = dy + (long long)ahead * F * C + c_own;
      bf16* dst = dys + buf * kDwTilePix * RS + c_own;
      for (int k = k_own; k < kDwTilePix && tid < kstep * per; k += kstep) {
        const int p = pixel(k);
        const bool ok = p < tpix;
        if (cw == 8) cp_async16(dst + k * RS, ok ? src + p * C : dy, ok ? 16 : 0);
        else cp_async8(dst + k * RS, ok ? src + p * C : dy, ok ? 8 : 0);
      }
      ahead += trows_at(ahead);
    }
    cp_async_commit();
  };
  // the pairs (tap, k, k + 1), i = tid + 256 j = tap H + k / 2, of the patch
  // matrix of a tile: x at the patch of pixel(k + e), zeros outside the
  // tensor and past the tile. Per pair and element, fixed over the tiles:
  // the tap's row dt, the pixel's time row in the tile (prow; past any tile
  // where the tap's column lies outside the tensor) and x's offset from the
  // tile's first pixel.
  int g_dt[NG], g_prow[NG][2], g_off[NG][2];
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    const int i = tid + j * kDwThreads, tap = (i < 9 * H ? i : 0) / H, k = 2 * (i % H);
    g_dt[j] = tap / 3;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int p = pixel(k + e), f = p % F + tap % 3 - 1;
      g_prow[j][e] = i < 9 * H && f >= 0 && f < F ? p / F : kDwTilePix;
      g_off[j][e] = (p / F + tap / 3 - 1) * F + f;
    }
  }
  auto gather = [&](uint32_t (&pv)[NG], int r) {
    const int t0 = r % T, trows = trows_at(r);
    const unsigned short* xb = xs + (long long)r * F;  // the tile's first pixel
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      uint32_t v = 0;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = t0 + g_prow[j][e] + g_dt[j] - 1;
        if (g_prow[j][e] < trows && t >= 0 && t < T) v |= (uint32_t)xb[g_off[j][e]] << (16 * e);
      }
      pv[j] = v;
    }
  };
  auto place = [&](const uint32_t (&pv)[NG], int buf) {
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      const int i = tid + j * kDwThreads;
      if (i < 9 * H) *reinterpret_cast<uint32_t*>(pms + (buf * 16 + i / H) * kDwKS + 2 * (i % H)) = pv[j];
    }
  };

  // dW of rows 0-15 x this warp's 16 channels, k < H and k >= H apart
  const int np = warp % NP, sl = warp / NP;
  float acc[2][2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  const int a_lane = (lane % 16) * kDwKS + (lane / 16) * 8;
  const int b_lane = (lane % 8 + 8 * ((lane / 8) % 2)) * RS + np * 16 + (lane / 16) * 8;

  stage(0);
  uint32_t pv[NG];
  if (cur < r_end) {
    gather(pv, cur);
    place(pv, 0);
  }
  for (int buf = 0; cur < r_end; buf ^= 1) {
    const int next = cur + trows_at(cur);
    cp_async_wait_all();
    __syncthreads();  // this tile's dy and patches in place; every warp is done with the other buffers
    stage(buf ^ 1);   // the next tile's dy loads, and its patches gather, while this one multiplies
    if (next < r_end) gather(pv, next);
    const uint32_t a0 = smem_addr(pms + buf * 16 * kDwKS + a_lane);
    const uint32_t b0 = smem_addr(dys + buf * kDwTilePix * RS + b_lane);
#pragma unroll
    for (int j = 0; j < kDwTilePix / 16 / NS; ++j) {
      const int kc = sl + NS * j;  // k-chunk; kc < H / 16 iff NS j < H / 16
      uint32_t af[4], bq[4];
      ldmatrix_x4(af, a0 + 2 * (kc * 16));
      ldmatrix_x4_trans(bq, b0 + 2 * (kc * 16 * RS));
      mma_bf16(acc[(NS * j) / (H / 16)][0], af, bq[0], bq[1]);
      mma_bf16(acc[(NS * j) / (H / 16)][1], af, bq[2], bq[3]);
    }
    if (next < r_end) place(pv, buf ^ 1);
    cur = next;
  }

  // the k-slices' sums added in slice order, over the dy tiles' memory
  cp_async_wait_all();
  __syncthreads();  // every warp is done with the last tile
  float* red = reinterpret_cast<float*>(smem_raw);  // [NS][2][10][CP]
#pragma unroll
  for (int hk = 0; hk < 2; ++hk)
#pragma unroll
    for (int nf = 0; nf < 2; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = g + 8 * (e / 2), c = np * 16 + nf * 8 + 2 * q + e % 2;
        if (row < 10) red[((sl * 2 + hk) * 10 + row) * CP + c] = acc[hk][nf][e];
      }
  __syncthreads();
  float* ps = partials + (long long)blockIdx.x * (parity ? 2 : 1) * 10 * C;
  for (int i = tid; i < 10 * C; i += kDwThreads) {
    const int row = i / C, c = i % C;
    float h[2] = {0.0f, 0.0f};
#pragma unroll
    for (int hk = 0; hk < 2; ++hk)
#pragma unroll
      for (int s = 0; s < NS; ++s) h[hk] += red[((s * 2 + hk) * 10 + row) * CP + c];
    if (parity) {
      ps[i] = h[0];
      ps[10 * C + i] = h[1];
    } else {
      ps[i] = h[0] + h[1];
    }
  }
}
static_assert((8 * 16 / 64) * 2 * 10 * 64 * 4 <= 2 * 2 * kDwTilePix * (64 + 8) &&
                  (8 * 16 / 128) * 2 * 10 * 128 * 4 <= 2 * 2 * kDwTilePix * (128 + 8),
              "the bfloat16 kernel's slot scratch fits two of its dy tiles");

// ------------------------------------------ K4f / K5s: one wave of runs

// y = conv9 + cb of x, stored (kStore: K4f, bfloat16 only) or not (K5s, K6's
// statistics), with the per-channel sums of y: on bfloat16 x, y = bf16(conv9
// + cb) of the weights rounded to bfloat16 and the sums of the rounded y; on
// float32 x, the weights as given and y unrounded. The function of
// entry_conv_kernel<0 | 1>, which it replaces in bfloat16 and for K5s in
// float32 (float32 K4f, whose store bounds it, stays there); y is the same
// bits (the FMAs in conv9's order; in bfloat16 on exact products), the sums
// differ in their last bits (another order of the float32 and float64
// additions).
//
// Launch plan: one wave of the resident blocks (the wrapper sizes it from
// dcase_entry_conv_bf16_resident, the fewer of the two bfloat16 modes', so
// K4f and K5s split alike and give the same sums, or from
// dcase_entry_conv_f32_resident), block k of G taking time rows
// [k n / G, (k + 1) n / G) of the n = B T rows of the batch, clip after
// clip, cut into tiles of up to `rows` rows that stay inside a clip (a run's
// last tile of a clip, and the clip's last tile, shorter). In bfloat16 the
// kernel rounds the float32 weights itself. Per tile: x with its one-cell
// halo, zeros outside the tensor, as float32 [trows + 2][FS] (FS =
// conv_stride(F): every run's window in the row, a multiple of four floats)
// in one of two buffers, loaded into registers during the previous tile; one
// barrier. A thread owns kConvChans neighbouring channels (their 9
// kConvChans weights in registers) and takes runs of kConvRun pixels along
// f: it reads the run's 3 x (kConvRun + 2) window with three 16-byte and
// three 8-byte shared loads and forms kConvChans kConvRun outputs from it
// (conv_run), stores each pixel's kConvChans channels at once (8 bytes) and
// sums y and y^2 in float32 (a thread's pixels of one tile: 104 at the
// flagship shape, at most kConvHalo). Once
// a tile it adds those sums to its float64 sums in shared memory; at the end
// the block adds its threads' sums in a fixed order into its slot [2C]
// (float64), which fold_warps_kernel adds in a fixed order. A run repeats
// bit for bit.
constexpr int kConvThreads = 128;  // threads of a block
constexpr int kConvRun = 4;        // neighbouring pixels along f a thread forms from one window
constexpr int kConvChans = 4;      // neighbouring channels a thread forms
constexpr int kConvHalo = 1024;    // floats of a staged x tile, at most
constexpr int kConvNX = kConvHalo / kConvThreads;  // x values a thread loads a tile ahead

// Row stride of a staged x tile: the runs' windows of a row (kConvRun
// ceil(F / kConvRun) + 2 floats), rounded up to four.
__host__ __device__ inline int conv_stride(int F) { return kConvRun * ((F + kConvRun - 1) / kConvRun) + 4; }

// One run of kConvRun pixels from its window win [3][kConvRun + 2]: every
// tap of all kConvRun x kConvChans outputs before the next (kConvRun
// kConvChans independent FMA chains; each output still adds the bias, then
// the taps dt-major: conv9's order), then per pixel y (in bfloat16 bf16(y),
// its kConvChans channels stored at yp + j C under kStore) added to the
// float32 sums s (y) and q (y^2). N: the pixels kept, kConvRun, or 0 for the
// first n of them (a run cut by F; past F the window holds zeros and the
// outputs are dropped).
template <typename TX, bool kStore, int N>
__device__ __forceinline__ void conv_run(const float (&win)[3][kConvRun + 2], const float (&wr)[kConvChans][9],
                                         const float (&br)[kConvChans], float (&s)[kConvChans],
                                         float (&q)[kConvChans], TX* yp, int C, int n = kConvRun) {
  float acc[kConvRun][kConvChans];
#pragma unroll
  for (int j = 0; j < kConvRun; ++j)
#pragma unroll
    for (int k = 0; k < kConvChans; ++k) acc[j][k] = br[k];
#pragma unroll
  for (int dt = 0; dt < 3; ++dt)
#pragma unroll
    for (int df = 0; df < 3; ++df)
#pragma unroll
      for (int j = 0; j < kConvRun; ++j)
#pragma unroll
        for (int k = 0; k < kConvChans; ++k) acc[j][k] = fmaf(win[dt][j + df], wr[k][dt * 3 + df], acc[j][k]);
#pragma unroll
  for (int j = 0; j < kConvRun; ++j) {
    if (N == 0 && j >= n) break;
    if constexpr (std::is_same<TX, float>::value) {  // y unrounded, never stored
#pragma unroll
      for (int k = 0; k < kConvChans; ++k) {
        s[k] += acc[j][k];
        q[k] = fmaf(acc[j][k], acc[j][k], q[k]);
      }
    } else {
      uint32_t packed[kConvChans / 2];
#pragma unroll
      for (int k = 0; k < kConvChans; k += 2) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(acc[j][k], acc[j][k + 1]);
        const uint32_t u = *reinterpret_cast<const uint32_t*>(&h);
        packed[k / 2] = u;
        const float lo = __uint_as_float(u << 16), hi = __uint_as_float(u & 0xffff0000u);  // y as stored
        s[k] += lo;
        q[k] = fmaf(lo, lo, q[k]);
        s[k + 1] += hi;
        q[k + 1] = fmaf(hi, hi, q[k + 1]);
      }
      if constexpr (kStore) *reinterpret_cast<uint2*>(yp + j * C) = make_uint2(packed[0], packed[1]);
    }
  }
}

// 4 blocks an SM (up to 128 registers). tools/bench_k5_torch.py --variants
// times eight channels a thread (16-byte stores, two blocks an SM) as an
// edit of this source.
template <typename TX, bool kStore>
__global__ void __launch_bounds__(kConvThreads, 4)
entry_conv_run_kernel(const TX* __restrict__ x, const float* __restrict__ w, const float* __restrict__ cb,
                      TX* __restrict__ y, double* __restrict__ partials, int B, int T, int F, int C, int rows) {
  static_assert(std::is_same<TX, bf16>::value || !kStore, "float32 K4f stays on entry_conv_kernel<0>");
  __shared__ __align__(16) float xs[2][kConvHalo];
  __shared__ double dsum[2 * kConvChans][kConvThreads];  // per thread: its float64 sums of y, then of y^2
  const int tid = threadIdx.x;
  const int lanes = C / kConvChans, groups = kConvThreads / lanes;
  const int c0 = kConvChans * (tid % lanes), grp = tid / lanes;
  const bool active = grp < groups;
  const int FS = conv_stride(F), RW = (F + kConvRun - 1) / kConvRun;

  float wr[kConvChans][9], br[kConvChans];  // the weights (in bfloat16 rounded: exact products with x), the bias
#pragma unroll
  for (int k = 0; k < kConvChans; ++k) {
    br[k] = active ? cb[c0 + k] : 0.0f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) wr[k][tap] = active ? rounded<TX>(w[tap * C + c0 + k]) : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < 2 * kConvChans; ++k) dsum[k][tid] = 0.0;

  // this block's time rows and its first tile
  const long long n = (long long)B * T;
  const int r_end = (int)((blockIdx.x + 1) * n / gridDim.x);
  int cur = (int)(blockIdx.x * n / gridDim.x);
  auto trows_at = [&](int r) { return min(min(rows, T - r % T), r_end - r); };

  // x of the tile at row r into registers: cell i = tid + j kConvThreads of
  // the [trows + 2][FS] tile, at (i / FS, i % FS), stepped without a divide
  const int r_first = tid / FS, q_first = tid % FS, dr = kConvThreads / FS, dq = kConvThreads % FS;
  auto load = [&](float (&xr)[kConvNX], int r) {
    const int b = r / T, t0 = r % T, cells = (trows_at(r) + 2) * FS;
    const TX* xb = x + (long long)b * T * F;
    int rr = r_first, q = q_first;
#pragma unroll
    for (int j = 0; j < kConvNX; ++j) {
      const int t = t0 - 1 + rr, f = q - 1;
      xr[j] = tid + j * kConvThreads < cells && t >= 0 && t < T && f >= 0 && f < F
                  ? to_float(xb[t * F + f]) : 0.0f;
      rr += dr;
      q += dq;
      if (q >= FS) {
        q -= FS;
        ++rr;
      }
    }
  };

  float xr[kConvNX];
  if (cur < r_end) load(xr, cur);
  for (int buf = 0; cur < r_end; buf ^= 1) {
    const int b = cur / T, t0 = cur % T, trows = trows_at(cur);
    float* xt = xs[buf];
#pragma unroll
    for (int j = 0; j < kConvNX; ++j)
      if (tid + j * kConvThreads < (trows + 2) * FS) xt[tid + j * kConvThreads] = xr[j];
    __syncthreads();  // x in place; every thread is done with this buffer's tile before last
    cur += trows;
    if (cur < r_end) load(xr, cur);  // the next tile's x, in flight during this tile
    if (!active) continue;

    float s[kConvChans], q[kConvChans];
#pragma unroll
    for (int k = 0; k < kConvChans; ++k) s[k] = q[k] = 0.0f;
    // runs u = grp, grp + groups, ... of the tile's trows RW: row u / RW, first pixel kConvRun (u % RW)
    int row = grp / RW, col = grp % RW;
    const int drow = groups / RW, dcol = groups % RW;
    for (; row < trows;) {
      const float* xw = xt + row * FS + kConvRun * col;
      float win[3][kConvRun + 2];
#pragma unroll
      for (int dt = 0; dt < 3; ++dt) {
        const float4 a = *reinterpret_cast<const float4*>(xw + dt * FS);
        const float2 e = *reinterpret_cast<const float2*>(xw + dt * FS + 4);
        win[dt][0] = a.x;
        win[dt][1] = a.y;
        win[dt][2] = a.z;
        win[dt][3] = a.w;
        win[dt][4] = e.x;
        win[dt][5] = e.y;
      }
      const int f0 = kConvRun * col;
      TX* yp = kStore ? y + (((long long)b * T + t0 + row) * F + f0) * C + c0 : nullptr;
      if (f0 + kConvRun <= F)
        conv_run<TX, kStore, kConvRun>(win, wr, br, s, q, yp, C);
      else  // the row's last run, cut by F
        conv_run<TX, kStore, 0>(win, wr, br, s, q, yp, C, F - f0);
      row += drow;
      col += dcol;
      if (col >= RW) {
        col -= RW;
        ++row;
      }
    }
#pragma unroll
    for (int k = 0; k < kConvChans; ++k) {  // this tile's float32 sums into the thread's float64 ones
      dsum[k][tid] += (double)s[k];
      dsum[kConvChans + k][tid] += (double)q[k];
    }
  }

  // the block's slot: its threads' sums, added in group order
  __syncthreads();
  for (int i = tid; i < 2 * C; i += kConvThreads) {
    const int sq = i / C, c = i % C, l = c / kConvChans, k = c % kConvChans;
    double t = 0.0;
    for (int g = 0; g < groups; ++g) t += dsum[sq * kConvChans + k][g * lanes + l];
    partials[(long long)blockIdx.x * 2 * C + i] = t;
  }
}

// --------------------------------- K5b1 in float32: K2b's register tiles

// Pass 1 in float32 runs K2b's float32 reduce pass (f32_tile.cuh) on a tile
// it computes itself. Per tile: x with its one-cell halo [trows + 2][F + 2]
// and the tile's pooled rows of dout staged by cp.async a tile ahead (where
// two buffers fit); y = conv9 + cb once, in conv9's order (K4f's), centred as
// it is written: x-hat = (y - mean) inv straight into the [kPix][KS] tile
// that K2b's reduce pass stages y into and centres in place (the same float
// values); then reduce_tile_f32 (lin, the gate, dxn on 8-channel FP32
// register tiles; S1, S2, db and M = x-hat^T . dlin) and at the end of each
// of its slots write_reduce_slot_f32 (dW = scale M + bias db). Thread tid
// computes the conv of channels 4 (tid % (CP / 4)) .. + 3, their 36 weights
// in registers, for every (256 / (CP / 4))-th pixel. Slots: K2b's reduce
// pass's per-clip plan, runs of tiles_per_slot tiles of one clip (the last
// of a clip shorter), nb = ceil(tiles / tiles_per_slot) a clip, folded in
// slot order (fold.cuh); each slot sums its own tiles in K2b's order, so the
// pass gives K4f -> K2b's bits. Launch plan: one wave of the resident blocks
// (one block of 8 warps an SM: M, the gate's accumulators and the sums take
// more than 128 registers a thread), block k of G taking slots [k S / G, (k
// + 1) S / G) of the S = B nb slots of the batch, that is a run of
// consecutive tiles, clip after clip. One slot a block (equal runs of the
// batch's tiles, 1.3508 ms at the flagship shape on an NVIDIA H100 80GB
// HBM3, 700.00 W, tools/bench_k5_torch.py) summed runs four times as long as
// K2b's slots and drifted 5e-7 to 9e-7 of max from K2b's sums.

// Dynamic shared memory of the float32 pass 1 (ops/fused_entry_block.
// f32_reduce_plan computes the same): the x-hat and dlin tiles [kPix][KS],
// `buffers` tiles of dout rows [drows][KS] (drows = 0: dout is read from
// device memory), W [CP][CP], seven vectors [CP], the conv weights [9][CP]
// and bias [CP], `buffers` x tiles [kHalo] and two tables [kPix] (int).
template <int NJ>
size_t red_entry_smem(int buffers, int drows) {
  using P = RedPlan<NJ>;
  return sizeof(float) * ((2 * kPix + (size_t)buffers * drows) * P::KS + P::CP * P::CP + 17 * P::CP +
                          (size_t)buffers * kHalo + 2 * kPix);
}

// x[b, t0 - 1 .. t0 + trows, -1 .. F] -> xt [trows + 2][F + 2] by cp.async,
// zeros outside the tensor (stage_x's tile)
__device__ __forceinline__ void stage_x_async(float* xt, const float* __restrict__ x, const TilePos& tp, int T,
                                              int F) {
  const int FW = F + 2, n = (tp.trows + 2) * FW;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int t = tp.t0 - 1 + i / FW, f = i % FW - 1;
    const bool ok = t >= 0 && t < T && f >= 0 && f < F;
    cp_async4(xt + i, ok ? x + (tp.row0 - tp.t0 + t) * F + f : x, ok ? 4 : 0);
  }
}

// y - mean = conv9 + cb - mean of the tile's pixels (conv9's order, K4f's),
// times inv where kInv (x-hat), into xb [kPix][CP + 4]: the float values K2
// forms in place from a staged y. Zeros past the tile, and past C (the
// weights, bias and mean are zeros there). Thread tid of NT computes channels
// 4 (tid % (CP / 4)) .. + 3, their 36 weights in registers, of every (NT /
// (CP / 4))-th pixel.
template <int CP, int NT, bool kInv>
__device__ __forceinline__ void conv_centred(float* xb, const float* xt, const float* cws, const float* cbs,
                                             const float* vmean, const float* vinv, int F, int tpix) {
  constexpr int Q = CP / 4, DP = NT / Q, KS = CP + 4;
  const int sq = threadIdx.x % Q, FW = F + 2;
  float w[4][9], cbv[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    cbv[e] = cbs[4 * sq + e];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) w[e][tap] = cws[tap * CP + 4 * sq + e];
  }
  const float4 m = ld4(vmean + 4 * sq), iv = kInv ? ld4(vinv + 4 * sq) : m;
  for (int p = threadIdx.x / Q; p < kPix; p += DP) {
    float4 u = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (p < tpix) {
      const float* rr = xt + (p / F) * FW + p % F;
      u = make_float4(conv9(rr, FW, w[0], cbv[0]) - m.x, conv9(rr, FW, w[1], cbv[1]) - m.y,
                      conv9(rr, FW, w[2], cbv[2]) - m.z, conv9(rr, FW, w[3], cbv[3]) - m.w);
      if constexpr (kInv) u = make_float4(u.x * iv.x, u.y * iv.y, u.z * iv.z, u.w * iv.w);
    }
    st4(xb + p * KS + 4 * sq, u);
  }
}

// The conv weights [9][CP] and bias [CP] of a fused kernel into shared
// memory, zeros past C.
template <int CP, int NT>
__device__ __forceinline__ void stage_conv(float* cws, float* cbs, const float* __restrict__ cw,
                                           const float* __restrict__ cb, int C) {
  for (int i = threadIdx.x; i < 10 * CP; i += NT) {
    const int tap = i / CP, c = i % CP;
    const float u = c < C ? (tap < 9 ? cw[tap * C + c] : cb[c]) : 0.0f;
    (tap < 9 ? cws[i] : cbs[c]) = u;
  }
}

// A slot: [C*C d glu_w | C d glu_b | C S1 | C S2].
template <int NJ>
__global__ void __launch_bounds__(kThreads)
entry_block_bwd_reduce_f32_kernel(const float* __restrict__ x, const float* __restrict__ dout,
                                  const float* __restrict__ cw, const float* __restrict__ cb,
                                  const float* __restrict__ scale, const float* __restrict__ bias,
                                  const float* __restrict__ mean, const float* __restrict__ var,
                                  const float* __restrict__ glu_w, const float* __restrict__ glu_b,
                                  float* __restrict__ partials, int B, int T, int F, int C, int pt, int pf, float eps,
                                  Dropout dr, int tiles_per_slot, int buffers, int drows, int vec) {
  using P = RedPlan<NJ>;
  constexpr int CP = P::CP, KS = P::KS;
  extern __shared__ __align__(16) float smem_e[];
  float* xb = smem_e;                       // [kPix][KS]: x-hat (with ds: the slot's scratch at the end)
  float* ds = xb + kPix * KS;               // [kPix][KS]: dlin
  float* dsm = ds + kPix * KS;              // [buffers][drows][KS]: the tile's rows of dout
  float* wsw = dsm + buffers * drows * KS;  // [CP][CP]: W (in, out), chunks swizzled
  RedVecs v;                                // [CP] each, zeros past C
  float* cws = carve_red_vecs(v, wsw + CP * CP, CP);  // [9][CP]: conv weights, zeros past C
  float* cbs = cws + 9 * CP;                          // [CP]: conv bias
  float* xts = cbs + CP;                              // [buffers][kHalo]: x with its halo
  int* tab_y = reinterpret_cast<int*>(xts + buffers * kHalo);  // [kPix]: the global pixel of tile pixel p
  int* tab_d = tab_y + kPix;  // [kPix]: its row of dout (of the staged rows, or of dout where drows == 0)

  const int tid = threadIdx.x;
  const unsigned long long seed = seed_of(dr);
  const int Tp = T / pt, Fp = F / pf;
  const float inv_win = 1.0f / (float)(pt * pf);
  stage_w_swizzled<CP>(wsw, glu_w, C);  // once a block
  stage_red_vecs<CP>(v, scale, bias, mean, var, glu_b, C, eps);
  stage_conv<CP, kThreads>(cws, cbs, cw, cb, C);

  // this block's slots [s0, s1) of the batch's n = B nb, and their tiles
  // [first, last) of the batch's, clip after clip
  const Tile tl = tile_of(F, pt, pf);
  const int n_tiles = tiles_per_clip(T, F, pt, pf), nb = (n_tiles + tiles_per_slot - 1) / tiles_per_slot;
  const long long n = (long long)B * nb;
  const int s0 = (int)(blockIdx.x * n / gridDim.x), s1 = (int)((blockIdx.x + 1) * n / gridDim.x);
  auto slot_end = [&](int s) { return (s / nb) * n_tiles + min(n_tiles, (s % nb + 1) * tiles_per_slot); };
  const int first = s0 < s1 ? (s0 / nb) * n_tiles + (s0 % nb) * tiles_per_slot : 0;
  const int last = s0 < s1 ? slot_end(s1 - 1) : 0;
  int slot = s0, slot_last = s0 < s1 ? slot_end(s0) : 0;
  auto pos = [&](int t) { return tile_pos(t % n_tiles, t / n_tiles, T, F, tl); };
  // x and the dout rows of tile t into buffer buf by cp.async
  auto stage = [&](int t, int buf) {
    const TilePos tp = pos(t);
    stage_x_async(xts + buf * kHalo, x, tp, T, F);
    if (drows > 0) stage_dout_f32<CP>(dsm + buf * drows * KS, dout, tp, t / n_tiles, Tp, Fp, pt, pf, C, vec != 0);
  };

  RedCarry r;
  zero_carry(r);
  if (first < last) stage(first, 0);
  cp_async_commit();
  for (int t = first; t < last; ++t) {
    const int buf = buffers == 2 ? (t - first) & 1 : 0;
    const TilePos tp = pos(t);
    const int tpix = tp.trows * tp.fcols;
    cp_async_wait_all();
    __syncthreads();  // this tile's x and dout landed; every warp is done with the previous tile
    if (buffers == 2 && t + 1 < last) {  // the next tile loads while this one multiplies
      stage(t + 1, buf ^ 1);
      cp_async_commit();
    }
    const float* xt = xts + buf * kHalo;
    const float* dtile = dsm + buf * drows * KS;
    conv_centred<CP, kThreads, true>(xb, xt, cws, cbs, v.vmean, v.vinv, F, tpix);  // x-hat
    tile_tables(tab_y, tab_d, tp, tpix, t / n_tiles, F, Tp, Fp, pt, pf, drows);
    __syncthreads();  // x-hat and the tables complete
    reduce_tile_f32<NJ>(r, xb, ds, dtile, dout, wsw, v, tab_y, tab_d, nullptr, tpix, C, drows, vec != 0, inv_win, dr,
                        seed);
    if (t + 1 == slot_last) {  // the slot's last tile: its sums out, the next slot's from zero
      write_reduce_slot_f32<NJ>(partials + (long long)slot * (C * C + 3 * C), r, xb, v, C);
      zero_carry(r);
      if (++slot < s1) slot_last = slot_end(slot);
    }
    if (buffers == 1 && t + 1 < last) {
      __syncthreads();  // every warp is done with the only buffers
      stage(t + 1, 0);
      cp_async_commit();
    }
  }
}

// ------------------------ K5f and K5b2 in float32: K2's register tiles

// The float32 forward and pass 2 run their K2 counterparts' float32 per-tile
// code (f32_tile.cuh) on a y tile they compute once, as K5b1 does. Per tile:
// x with its one-cell halo [trows + 2][F + 2] (and in pass 2 the tile's
// pooled rows of dout) by cp.async a tile ahead; y - mean = conv9 + cb - mean
// (conv_centred) straight into the [kPix][KS] tile in which K2 centres the y
// it stages, the same float values; then
//   K5f: K2f's FwdTile::glu_pool: lin = x-hat . W' on FwdPlan's register
//     tiles (W' = diag(inv scale) W and b' = b + bias . W formed once a
//     block), g = (lin + b') sig, the mask and the pool (warp shuffles at
//     block 1's geometry). So K5f gives K4f -> K2f's bits. One y tile
//     (computed, not loaded, so K2f's second buffer has no load to hide): 58
//     KB and two blocks of 8 warps an SM at C <= 64.
//   K5b2: the recompute fixup's lin_f32, gate_f32, dxn_f32 and dy_f32 (dy =
//     inv scale dxn - a - (y - mean) b2, the fixup's dy), dy written over the
//     y - mean tile by its owner; then dW[tap][c] += x[p + tap] dy[p][c] and
//     d conv_b += dy[p][c] (tap 9, x = 1) from shared memory: thread (g, s,
//     q) = (tid / 128, (tid % 128) / Q, tid % Q), Q = CP / 4, takes taps 5 g
//     .. 5 g + 4 of channels 4 q .. 4 q + 3 of the pixels p = s (mod S = 128
//     / Q), 20 sums carried over its tiles in registers (all ten taps a
//     thread spilled at C <= 64), the x patch read from the staged halo
//     tile. dW is 7 % of the pass's FMAs; kept out of the products'
//     registers, the fixup's 128 registers and two blocks of 8 warps an SM
//     hold at C <= 64 (104 KB with two buffers). dW formed in registers as
//     dy is (80 sums a thread, one block an SM) read 1.2356-1.2658 ms at the
//     flagship shape against 1.0480-1.0635 (CUDA events, NVIDIA H100 80GB
//     HBM3, 700.00 W, tools/bench_k5_torch.py --variants). At
//     the end of its run each block writes its slot [9 C dW | C d conv_b],
//     the S shares added in share order, and fold_kernel adds the slots in
//     slot order in double: a run repeats bit for bit.
// Launch plan of both: one wave of the resident blocks over the batch's
// tiles, block k of G taking tiles [k n / G, (k + 1) n / G) of the n = B *
// tiles, clip after clip (the wrapper sizes G from the occupancy
// calculator). The crows layout launches the same kernels: in float32 the
// two layouts are one function.

// Dynamic shared memory of the float32 forward (ops/fused_entry_block.
// fwd_f32_plan computes the same): the x-hat tile [kPix][KS], W' [CP][CP],
// four vectors [CP], the conv weights [9][CP] and bias [CP], two x tiles
// [kHalo] and the pixel table [kPix] (int).
template <int NJ>
constexpr size_t fwd_entry_smem() {
  using P = FwdPlan<NJ>;
  return sizeof(float) * ((size_t)kPix * P::KS + P::CP * P::CP + 14 * P::CP + 2 * kHalo + kPix);
}

template <int NJ>
__global__ void __launch_bounds__(FwdPlan<NJ>::NT, FwdPlan<NJ>::MIN_BLOCKS)
entry_block_fwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ cw, const float* __restrict__ cb,
                           const float* __restrict__ scale, const float* __restrict__ bias,
                           const float* __restrict__ mean, const float* __restrict__ var,
                           const float* __restrict__ glu_w, const float* __restrict__ glu_b, float* __restrict__ out,
                           int B, int T, int F, int C, int pt, int pf, float eps, Dropout dr, int vec) {
  using P = FwdPlan<NJ>;
  constexpr int CP = P::CP, KS = P::KS, NT = P::NT;
  extern __shared__ __align__(16) float smem_e[];
  float* xb = smem_e;           // [kPix][KS]: x-hat, then g
  float* ws = xb + kPix * KS;   // [CP][CP]: W' (in, out)
  float* vgain = ws + CP * CP;  // [CP] each, zeros past C: G, mean, bias, b'
  float* vmean = vgain + CP;
  float* vbias = vmean + CP;
  float* vgb = vbias + CP;
  float* cws = vgb + CP;                                 // [9][CP]: conv weights, zeros past C
  float* cbs = cws + 9 * CP;                             // [CP]: conv bias
  float* xts = cbs + CP;                                 // [2][kHalo]: x with its halo
  int* tab_y = reinterpret_cast<int*>(xts + 2 * kHalo);  // [kPix]: the global pixel of tile pixel p

  const unsigned long long seed = seed_of(dr);
  const int Tp = T / pt, Fp = F / pf;
  const float inv_win = 1.0f / (float)(pt * pf);
  FwdTile<NJ>::stage_consts(ws, vgain, vmean, vbias, vgb, scale, bias, mean, var, glu_w, glu_b, C, eps);
  stage_conv<CP, NT>(cws, cbs, cw, cb, C);

  const Tile tl = tile_of(F, pt, pf);
  const int n_tiles = tiles_per_clip(T, F, pt, pf);
  const long long n = (long long)B * n_tiles;
  const int first = (int)(blockIdx.x * n / gridDim.x), last = (int)((blockIdx.x + 1) * n / gridDim.x);
  auto pos = [&](int t) { return tile_pos(t % n_tiles, t / n_tiles, T, F, tl); };
  if (first < last) stage_x_async(xts, x, pos(first), T, F);
  cp_async_commit();
  for (int t = first; t < last; ++t) {
    const int buf = (t - first) & 1;
    const TilePos tp = pos(t);
    const int tpix = tp.trows * tp.fcols;
    cp_async_wait_all();
    __syncthreads();  // this tile's x landed; every warp is done with the previous tile
    if (t + 1 < last) {  // the next tile's x loads while this one multiplies
      stage_x_async(xts + (buf ^ 1) * kHalo, x, pos(t + 1), T, F);
      cp_async_commit();
    }
    conv_centred<CP, NT, false>(xb, xts + buf * kHalo, cws, cbs, vmean, nullptr, F, tpix);  // x-hat = y - mean
    for (int p = threadIdx.x; p < kPix; p += NT) tab_y[p] = p < tpix ? (int)tp.pixel(p) : 0;
    __syncthreads();  // x-hat and the table complete
    FwdTile<NJ>::glu_pool(xb, ws, vgain, vbias, vgb, tab_y, tp, t / n_tiles, tpix, C, pt, pf, Tp, Fp, inv_win, dr,
                          seed, out, vec);
  }
}

// Dynamic shared memory of the float32 pass 2 (ops/fused_entry_block.
// f32_wgrad_plan computes the same): the y - mean (then dy) and dlin tiles
// [kPix][KS], `buffers` tiles of dout rows [drows][KS] (drows = 0: dout is
// read from device memory), W [CP][CP], six vectors [CP], the conv weights
// [9][CP] and bias [CP], `buffers` x tiles [kHalo] and two tables [kPix] (int).
template <int NJ>
size_t wgrad_entry_smem(int buffers, int drows) {
  using P = RedPlan<NJ>;
  return sizeof(float) * ((2 * kPix + (size_t)buffers * drows) * P::KS + P::CP * P::CP + 16 * P::CP +
                          (size_t)buffers * kHalo + 2 * kPix);
}

// A slot: [9 C dW (tap-major) | C d conv_b].
template <int NJ>
__global__ void __launch_bounds__(kThreads, NJ == 4 ? 2 : 1)
entry_block_bwd_wgrad_f32_kernel(const float* __restrict__ x, const float* __restrict__ dout,
                                 const float* __restrict__ cw, const float* __restrict__ cb,
                                 const float* __restrict__ scale, const float* __restrict__ bias,
                                 const float* __restrict__ mean, const float* __restrict__ var,
                                 const float* __restrict__ glu_w, const float* __restrict__ glu_b,
                                 const float* __restrict__ a, const float* __restrict__ b2,
                                 float* __restrict__ partials, int B, int T, int F, int C, int pt, int pf, float eps,
                                 Dropout dr, int buffers, int drows, int vec) {
  using P = RedPlan<NJ>;
  constexpr int CP = P::CP, CG = P::CG, MI = P::MI, KS = P::KS;
  constexpr int Q = CP / 4, S = kThreads / 2 / Q;  // dW: see the comment above
  extern __shared__ __align__(16) float smem_e[];
  float* xb = smem_e;                       // [kPix][KS]: y - mean, then dy (with ds: the slot's scratch at the end)
  float* ds = xb + kPix * KS;               // [kPix][KS]: dlin
  float* dsm = ds + kPix * KS;              // [buffers][drows][KS]: the tile's rows of dout
  float* wsw = dsm + buffers * drows * KS;  // [CP][CP]: W (in, out), chunks swizzled
  float* vmean = wsw + CP * CP;             // [CP] each, zeros past C
  float* vgain = vmean + CP;                // inv * scale
  float* vbias = vgain + CP;
  float* vgb = vbias + CP;
  float* va = vgb + CP;
  float* vb2 = va + CP;
  float* cws = vb2 + CP;                                       // [9][CP]: conv weights, zeros past C
  float* cbs = cws + 9 * CP;                                   // [CP]: conv bias
  float* xts = cbs + CP;                                       // [buffers][kHalo]: x with its halo
  int* tab_y = reinterpret_cast<int*>(xts + buffers * kHalo);  // [kPix]: the global pixel of tile pixel p
  int* tab_d = tab_y + kPix;  // [kPix]: its row of dout (of the staged rows, or of dout where drows == 0)

  const int tid = threadIdx.x, FW = F + 2;
  const unsigned long long seed = seed_of(dr);
  const int Tp = T / pt, Fp = F / pf;
  const float inv_win = 1.0f / (float)(pt * pf);
  stage_w_swizzled<CP>(wsw, glu_w, C);  // once a block
  for (int c = tid; c < CP; c += kThreads) {
    const bool in = c < C;
    vmean[c] = in ? mean[c] : 0.0f;
    vgain[c] = in ? rsqrtf(var[c] + eps) * scale[c] : 0.0f;
    vbias[c] = in ? bias[c] : 0.0f;
    vgb[c] = in ? glu_b[c] : 0.0f;
    va[c] = in ? a[c] : 0.0f;
    vb2[c] = in ? b2[c] : 0.0f;
  }
  stage_conv<CP, kThreads>(cws, cbs, cw, cb, C);

  const Tile tl = tile_of(F, pt, pf);
  const int n_tiles = tiles_per_clip(T, F, pt, pf);
  const long long n = (long long)B * n_tiles;
  const int first = (int)(blockIdx.x * n / gridDim.x), last = (int)((blockIdx.x + 1) * n / gridDim.x);
  auto pos = [&](int t) { return tile_pos(t % n_tiles, t / n_tiles, T, F, tl); };
  // x and the dout rows of tile t into buffer buf by cp.async
  auto stage = [&](int t, int buf) {
    const TilePos tp = pos(t);
    stage_x_async(xts + buf * kHalo, x, tp, T, F);
    if (drows > 0) stage_dout_f32<CP>(dsm + buf * drows * KS, dout, tp, t / n_tiles, Tp, Fp, pt, pf, C, vec != 0);
  };

  const int cg = tid % CG, pg = tid / CG;
  const int tg = tid / (kThreads / 2), sq = tid % Q, sh = (tid % (kThreads / 2)) / Q;  // taps 5 tg .. 5 tg + 4
  const bool dw_on = 4 * sq < C;
  int off[5];                          // tap 5 tg + k at r[off[k]] of a pixel's patch r; tap 9 is d conv_b
  float dw[4][5];                      // this thread's share of dW[5 tg + k][4 sq + e] (of d conv_b at tap 9)
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int tap = 5 * tg + k;
    off[k] = tap < 9 ? (tap / 3) * FW + tap % 3 : 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) dw[e][k] = 0.0f;
  }

  if (first < last) stage(first, 0);
  cp_async_commit();
  for (int t = first; t < last; ++t) {
    const int buf = buffers == 2 ? (t - first) & 1 : 0;
    const TilePos tp = pos(t);
    const int tpix = tp.trows * tp.fcols;
    cp_async_wait_all();
    __syncthreads();  // this tile's x and dout landed; every warp is done with the previous tile
    if (buffers == 2 && t + 1 < last) {  // the next tile loads while this one multiplies
      stage(t + 1, buf ^ 1);
      cp_async_commit();
    }
    const float* xt = xts + buf * kHalo;
    conv_centred<CP, kThreads, false>(xb, xt, cws, cbs, vmean, nullptr, F, tpix);  // y - mean
    tile_tables(tab_y, tab_d, tp, tpix, t / n_tiles, F, Tp, Fp, pt, pf, drows);
    __syncthreads();  // y - mean and the tables complete

    float acc[MI][8];
    lin_f32<NJ>(acc, xb, wsw, vgain, vbias, pg, cg);
    gate_f32<NJ>(acc, xb, ds, dsm + buf * drows * KS, dout, tab_y, tab_d, vgain, vbias, vgb, tpix, C, drows, vec != 0,
                 inv_win, dr, seed, pg, cg, [](int, float) {});
    __syncthreads();  // dlin complete (and every read of another thread's y - mean done)
    dxn_f32<NJ>(acc, ds, wsw, pg, cg);
    dy_f32<NJ>(acc, xb, vgain, va, vb2, tpix, C, pg, cg, [&](int p, int c0, float4 d) { st4(xb + p * KS + c0, d); });
    __syncthreads();  // dy complete
    if (dw_on) add_dw_f32<5>(dw, xb, KS, xt, off, F, tpix, sh, S, sq, 5 * tg);  // dW and d conv_b, this share's pixels
    if (buffers == 1 && t + 1 < last) {
      __syncthreads();  // every warp is done with the only buffers
      stage(t + 1, 0);
      cp_async_commit();
    }
  }

  // the block's slot: the S shares added in share order, over the tiles' memory
  __syncthreads();  // every warp is done with the last tile
  float* red = smem_e;  // [S][10][CP]
  if (dw_on) {
#pragma unroll
    for (int k = 0; k < 5; ++k)
      st4(red + (sh * 10 + 5 * tg + k) * CP + 4 * sq, make_float4(dw[0][k], dw[1][k], dw[2][k], dw[3][k]));
  }
  __syncthreads();
  float* ps = partials + (long long)blockIdx.x * 10 * C;
  for (int i = tid; i < 10 * C; i += kThreads) {
    const int k = i / C, c = i % C;
    float v = 0.0f;
    for (int g = 0; g < S; ++g) v += red[(g * 10 + k) * CP + c];
    ps[i] = v;
  }
}
static_assert(8 * 10 * 64 <= 2 * kPix * (64 + 4) && 4 * 10 * 128 <= 2 * kPix * (128 + 4),
              "pass 2's slot scratch fits the y - mean and dlin tiles");

// ----------------------------------- K5's backward in bfloat16: tensor cores

// The two bfloat16 passes run K2's bfloat16 tile code (bf16_tile.cuh) on a y
// tile they compute themselves. Per tile: x with its one-cell halo (float32
// [trows + 2][F + 2], loaded into registers during the previous tile at CP =
// 64); y =
// bf16(conv + bias) once, conv9's order with the float32 bias first, into a
// bfloat16 tile [kPix][RS] that every later step reads; the tile's pooled
// rows of dout by cp.async a tile ahead; the keep bits and the dout-row
// table; A = bf16(xn) (form_a); then pass 1 is K2b's reduce pass without
// dy_partial (reduce_tile_bf16), and pass 2 takes dxn (dxn_bf16), forms dy
// = inv scale dxn - a - (y - mean) b2 in the fragments' registers, sums d
// conv_b from the float32 dy and writes bf16(dy) over A in the class order
// below, and multiplies dW = patches^T . bf16(dy) on mma.sync (M: the nine
// taps padded to 16, N: channels, K: the tile's pixels). x is bfloat16, so
// each patch value is exact in the bfloat16 operand.
//
// Launch plan: one wave of the resident blocks over the batch's tiles, block
// k of G taking tiles [k n / G, (k + 1) n / G) of the n = B * tiles (clip
// after clip), and under the crows partition blocks [0, G / 2) the first
// half of the clips, [G / 2, G) the second (the slots' two classes). One
// partial slot a block, folded in slot order (fold.cuh).
//
// dW's parts: under the parity partition (F even; a tile is whole rows, so
// a pixel p's output-frequency parity is p's) pixel p goes to row k = (p %
// 2) 64 + p / 2 of the dy tile and the patch matrix, so the k-chunks 0-3
// hold even frequencies and 4-7 odd ones; else k = p. Each warp keeps the
// sums of k < 64 and k >= 64 apart (both halves of a class-free partition
// are added at the end).

// the warps of both passes: 16 at CP = 128 (one block an SM), 8 at CP = 64
// (two blocks an SM; 16 % faster at the flagship shape than one block of 16,
// tools/bench_k5b_bf16_torch.py --variants), 128 registers a thread
template <int CP>
constexpr int kEntryWarps = CP == 128 ? 16 : 8;
constexpr int kKS = kPix + 8;  // row stride of the patch matrix: an odd number of 16-byte units
constexpr int kHalfK = kPix / 2;

// Dynamic shared memory of pass `pass` (1 or 2) of the bfloat16 kernels
// (ops/fused_entry_block.bf16_bwd_plan computes the same): the y, A and D
// tiles [kPix][RS], `buffers` tiles of dout rows [drows][RS] and W [CP][RS]
// in bfloat16, pass 2's patch matrix [16][kKS] too; the conv weights [9][CP]
// and bias [CP], six per-channel vectors [CP] (eight in pass 2: a, b2), the
// sums of the pixel warp rows (pass 1: db, S1, S2 [3][WM][CP]; pass 2: d
// conv_b [WM][CP]) and the x tile [kHalo] in float32; the keep bits
// [kPix][MS] and the dout-row table [kPix].
template <int CP, int NW>
size_t bwd_bf16_smem(int pass, int buffers, int drows) {
  using P = BfPlan<CP, NW>;
  const size_t halves = (size_t)P::RS * (3 * kPix + (size_t)buffers * drows + CP) + (pass == 2 ? 16 * (size_t)kKS : 0);
  const size_t floats = (size_t)CP * (10 + (pass == 2 ? 8 : 6) + (pass == 2 ? 1 : 3) * P::WM) + kHalo;
  return 2 * halves + 4 * floats + (size_t)kPix * P::MS + 4 * kPix;
}

// x of a tile into registers: xr[j] = x[b, t0 - 1 + i / FW, i % FW - 1] for
// i = threadIdx.x + j NTHR < (trows + 2) FW (FW = F + 2), zeros outside the
// tensor; store_x puts them into the tile xt [trows + 2][FW] (stage_x's).
template <int NX, int NTHR>
__device__ __forceinline__ void load_x(float (&xr)[NX], const bf16* __restrict__ x, const TilePos& tp, int b, int T,
                                       int F) {
  const int FW = F + 2, n = (tp.trows + 2) * FW;
#pragma unroll
  for (int j = 0; j < NX; ++j) {
    const int i = threadIdx.x + j * NTHR, t = tp.t0 - 1 + i / FW, f = i % FW - 1;
    xr[j] = (i < n && t >= 0 && t < T && f >= 0 && f < F) ? __bfloat162float(x[((long long)b * T + t) * F + f]) : 0.0f;
  }
}

template <int NX, int NTHR>
__device__ __forceinline__ void store_x(float* xt, const float (&xr)[NX], int n) {
#pragma unroll
  for (int j = 0; j < NX; ++j)
    if (threadIdx.x + j * NTHR < n) xt[threadIdx.x + j * NTHR] = xr[j];
}

// y = bf16(conv9 + bias) of the tile's pixels into yb [kPix][RS], zeros past
// the tile and past C: a thread takes four channels 4 (tid % (CP / 4)), their
// 36 weights in registers, of every (NTHR / (CP / 4))-th pixel. With
// kPatches also the patch matrix pm [16][kKS] of rows 0-8 (tap 3 dt + df):
// column k holds the tile pixel of k (see above), zero past the tile.
template <int CP, int NW, bool kPatches>
__device__ __forceinline__ void conv_tile_bf16(bf16* yb, bf16* pm, const float* xt, const float* cw, const float* cbv,
                                               int F, int tpix, int C, bool parity) {
  constexpr int RS = BfPlan<CP, NW>::RS, NQ = CP / 4, NTHR = 32 * NW;
  const int FW = F + 2, c = 4 * (threadIdx.x % NQ);
  float w[4][9], cb[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    cb[e] = cbv[c + e];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) w[e][tap] = cw[tap * CP + c + e];
  }
  for (int p = threadIdx.x / NQ; p < kPix; p += NTHR / NQ) {
    uint2 v = make_uint2(0u, 0u);
    if (p < tpix && c < C) {
      const float* r = xt + (p / F) * FW + p % F;
      const __nv_bfloat162 lo = __floats2bfloat162_rn(conv9(r, FW, w[0], cb[0]), conv9(r, FW, w[1], cb[1]));
      const __nv_bfloat162 hi = __floats2bfloat162_rn(conv9(r, FW, w[2], cb[2]), conv9(r, FW, w[3], cb[3]));
      v = make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
    }
    *reinterpret_cast<uint2*>(yb + p * RS + c) = v;
  }
  if constexpr (kPatches) {
    for (int i = threadIdx.x; i < 9 * kHalfK; i += NTHR) {
      const int tap = i / kHalfK, k = 2 * (i % kHalfK), dt = tap / 3, df = tap % 3;
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int p = parity ? 2 * ((k + e) % kHalfK) + (k + e) / kHalfK : k + e;
        v[e] = p < tpix ? xt[(p / F + dt) * FW + p % F + df] : 0.0f;
      }
      st_bf2(pm + tap * kKS + k, v[0], v[1]);
    }
  }
}

// The two passes' body; PASS 1 writes the slot [C*C d glu_w | C d glu_b | C
// S1 | C S2], PASS 2 the slot's classes [9 C dW (tap-major) | C d conv_b]
// (two classes under the parity partition, d conv_b whole in the first).
// halves: the crows partition (blocks split between the batch's halves).
template <int CP, int NW, int PASS>
__device__ __forceinline__ void bwd_bf16_body(
    const bf16* __restrict__ x, const bf16* __restrict__ dout, const float* __restrict__ cw,
    const float* __restrict__ cb, const float* __restrict__ scale, const float* __restrict__ bias,
    const float* __restrict__ mean, const float* __restrict__ var, const float* __restrict__ glu_w,
    const float* __restrict__ glu_b, const float* __restrict__ a, const float* __restrict__ b2,
    float* __restrict__ partials, int B, int T, int F, int C, int pt, int pf, float eps, Dropout dr, int buffers,
    int drows, int mode, bool parity, bool halves) {
  using P = BfPlan<CP, NW>;
  constexpr int RS = P::RS, MS = P::MS, NTHR = P::NTHR, NX = (kHalo + NTHR - 1) / NTHR;
  // the next tile's x is loaded into registers during this tile at CP = 64;
  // at CP = 128 pass 1's accumulators leave no room (8 bytes spilled), and
  // x is loaded at the top of its tile
  constexpr bool kPrefetchX = CP == 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* yb = reinterpret_cast<bf16*>(smem_raw);  // [kPix][RS]: y
  bf16* dsm = yb + kPix * RS;                     // [buffers][drows][RS]: the tile's rows of dout
  BfShared sh;
  sh.A = dsm + buffers * drows * RS;  // [kPix][RS]: bf16(xn), in pass 2 then bf16(dy) by class order
  sh.D = sh.A + kPix * RS;            // [kPix][RS]: bf16(dlin)
  sh.ws = sh.D + kPix * RS;           // [CP][RS]: W (in, out)
  bf16* pm = sh.ws + CP * RS;         // pass 2: [16][kKS] patches^T
  float* cws = reinterpret_cast<float*>(pm + (PASS == 2 ? 16 * kKS : 0));  // [9][CP] conv weights
  float* cbs = cws + 9 * CP;                                                 // [CP] conv bias
  sh.vmean = cbs + CP;
  sh.vinv = sh.vmean + CP;
  sh.vscale = sh.vinv + CP;
  sh.vbias = sh.vscale + CP;
  sh.vgb = sh.vbias + CP;
  sh.vgain = sh.vgb + CP;
  float* va = sh.vgain + CP;                                 // pass 2: [CP] a, b2
  float* vb2 = va + CP;
  float* sums = PASS == 2 ? vb2 + CP : va;                   // [3 or 1][WM][CP]
  float* xt = sums + (PASS == 2 ? 1 : 3) * P::WM * CP;       // [kHalo]
  sh.mbits = reinterpret_cast<unsigned char*>(xt + kHalo);   // [kPix][MS]
  sh.tab_d = reinterpret_cast<int*>(sh.mbits + kPix * MS);   // [kPix]
  stage_bf16_consts<CP>(sh.ws, sh.vmean, sh.vinv, sh.vscale, sh.vbias, sh.vgb, sh.vgain, glu_w, scale, bias, mean, var,
                        glu_b, C, eps);
  stage_conv<CP, NTHR>(cws, cbs, cw, cb, C);
  for (int i = threadIdx.x; i < (PASS == 2 ? 1 : 3) * P::WM * CP; i += NTHR) sums[i] = 0.0f;
  if constexpr (PASS == 2) {
    for (int c = threadIdx.x; c < CP; c += NTHR) {
      va[c] = c < C ? a[c] : 0.0f;
      vb2[c] = c < C ? b2[c] : 0.0f;
    }
    for (int i = threadIdx.x; i < 7 * kKS; i += NTHR) pm[9 * kKS + i] = __float2bfloat16_rn(0.0f);  // taps 9-15
  }

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp / P::WN, wn = warp % P::WN, g = lane / 4, q = lane % 4;
  const unsigned long long seed = seed_of(dr);
  const int Tp = T / pt, Fp = F / pf;
  const float inv_win = 1.0f / (float)(pt * pf);
  const Tile tl = tile_of(F, pt, pf);
  const int n_tiles = tiles_per_clip(T, F, pt, pf);
  // this block's run of the batch's tiles (of its half of the clips under halves)
  const int groups = halves ? 2 : 1, G = gridDim.x / groups, grp = blockIdx.x / G, kb = blockIdx.x % G;
  const long long n = (long long)(B / groups) * n_tiles;
  const int first = (int)(grp * n + kb * n / G), last = (int)(grp * n + (kb + 1) * n / G);
  auto pos = [&](int t) { return tile_pos(t % n_tiles, t / n_tiles, T, F, tl); };
  auto stage_dout = [&](int t, int buf) {
    const TilePos tp = pos(t);
    bf16* db_ = dsm + buf * drows * RS;
    if (mode == 2) stage_dout_rows<CP, 8>(db_, dout, tp, t / n_tiles, Tp, Fp, pt, pf, C, mode);
    else stage_dout_rows<CP, 4>(db_, dout, tp, t / n_tiles, Tp, Fp, pt, pf, C, mode);
  };

  // pass 1: d glu_w as K2b's reduce pass holds it (see BfPlan)
  float accw[PASS == 1 ? P::MTW : 1][PASS == 1 ? P::NTW : 2][4];
  // pass 2: dW of taps 0-15 (rows) x this warp's 16 channels, k < 64 and k >= 64 apart
  constexpr int NP = CP / 16, NS = NW / NP;  // channel pairs of fragments; k-slices, warp / NP
  static_assert(NW % NP == 0 && 4 % NS == 0, "pass 2 warp layout");
  float accd[2][2][4];
#pragma unroll
  for (int i = 0; i < (PASS == 1 ? P::MTW : 1); ++i)
#pragma unroll
    for (int j = 0; j < (PASS == 1 ? P::NTW : 2); ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) accw[i][j][e] = 0.0f;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) accd[i][j][e] = 0.0f;

  float xr[NX];
  if (first < last) {
    if (kPrefetchX) load_x<NX, NTHR>(xr, x, pos(first), first / n_tiles, T, F);
    stage_dout(first, 0);
  }
  cp_async_commit();
  for (int t = first; t < last; ++t) {
    const int buf = buffers == 2 ? (t - first) & 1 : 0;
    const TilePos tp = pos(t);
    const int tpix = tp.trows * tp.fcols;
    if (!kPrefetchX) load_x<NX, NTHR>(xr, x, tp, t / n_tiles, T, F);
    store_x<NX, NTHR>(xt, xr, (tp.trows + 2) * (F + 2));  // every warp is past the previous tile's conv
    cp_async_wait_all();
    __syncthreads();  // x and dout of this tile in place; every warp is done with the previous tile
    if (t + 1 < last) {  // the next tile's x into registers, its dout into the other buffer
      if (kPrefetchX) load_x<NX, NTHR>(xr, x, pos(t + 1), (t + 1) / n_tiles, T, F);
      if (buffers == 2) {
        stage_dout(t + 1, buf ^ 1);
        cp_async_commit();
      }
    }
    const bf16* dtile = dsm + buf * drows * RS;
    conv_tile_bf16<CP, NW, PASS == 2>(yb, pm, xt, cws, cbs, F, tpix, C, parity);
    dout_rows_of(sh.tab_d, tp, tpix, pt, pf);
    if (dr.mode != 0) keep_bits<CP>(sh.mbits, tp, tpix, C, seed, dr);
    __syncthreads();  // y, the patches, the table and the mask complete
    form_a<CP>(sh.A, yb, sh.vmean, sh.vinv, sh.vscale, sh.vbias, tpix);
    __syncthreads();  // A complete

    if constexpr (PASS == 1) {
      reduce_tile_bf16<CP, NW, CP == 128 ? 2 : 1>(accw, sh, yb, dtile, sums, tpix, inv_win, dr, false);
    } else {
      constexpr int MT = P::MT;
      float acc[MT][4][4];
      dxn_bf16<CP, NW, MT>(acc, sh, yb, dtile, 0, inv_win, dr, [](float, float, int) {});
      // dy in the fragments; d conv_b from the float32 dy; bf16(dy) over A (read
      // only before dxn_bf16's barrier) at row k of its pixel
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = wn * 32 + nt * 8 + 2 * q;
        const float2 m = ld2(sh.vmean + c), gn = ld2(sh.vgain + c), av = ld2(va + c), bv = ld2(vb2 + c);
        float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = wm * 16 * MT + mt * 16 + g + 8 * h;
            const float2 yv = ld_bf2(yb + p * RS + c);
            float d0 = __fsub_rn(__fsub_rn(__fmul_rn(gn.x, acc[mt][nt][2 * h]), av.x), __fmul_rn(yv.x - m.x, bv.x));
            float d1 = __fsub_rn(__fsub_rn(__fmul_rn(gn.y, acc[mt][nt][2 * h + 1]), av.y), __fmul_rn(yv.y - m.y, bv.y));
            if (p >= tpix) d0 = d1 = 0.0f;
            s0 += d0;
            s1 += d1;
            st_bf2(sh.A + (parity ? (p % 2) * kHalfK + p / 2 : p) * RS + c, d0, d1);
          }
        add_warp_sums(sums + wm * CP, s0, s1, c, g);
      }
      __syncthreads();  // the dy tile complete
      // dW[tap][c] += sum_k patches[tap][k] dy[k][c]: warp (slice, channel pair) = (warp / NP, warp % NP)
      const int np = warp % NP, sl = warp / NP;
      const uint32_t a0 = smem_addr(pm + (lane % 16) * kKS + (lane / 16) * 8);
      const uint32_t b0 = smem_addr(sh.A + (lane % 8 + ((lane / 8) % 2) * 8) * RS + np * 16 + (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < kPix / 16 / NS; ++j) {
        const int kc = sl + NS * j;  // k-chunk; kc < 4 iff NS j < 4
        uint32_t af[4], bq[4];
        ldmatrix_x4(af, a0 + 2 * (kc * 16));
        ldmatrix_x4_trans(bq, b0 + 2 * (kc * 16 * RS));
        mma_bf16(accd[(NS * j) / 4][0], af, bq[0], bq[1]);
        mma_bf16(accd[(NS * j) / 4][1], af, bq[2], bq[3]);
      }
    }
    if (buffers == 1 && t + 1 < last) {
      __syncthreads();  // every warp is done with the only dout tile
      stage_dout(t + 1, 0);
      cp_async_commit();
    }
  }

  if constexpr (PASS == 1) {
    write_reduce_slot<CP, NW>(partials + (long long)blockIdx.x * (C * C + 3 * C), accw, sums, C);
  } else {
    // the k-slices' dW sums added in slice order, over the tiles' memory
    __syncthreads();  // every warp is done with the last tile
    float* red = reinterpret_cast<float*>(smem_raw);  // [NS][2][9][CP]
    const int np = warp % NP, sl = warp / NP;
#pragma unroll
    for (int hk = 0; hk < 2; ++hk)
#pragma unroll
      for (int nf = 0; nf < 2; ++nf)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tap = g + 8 * (e / 2), c = np * 16 + nf * 8 + 2 * q + e % 2;
          if (tap < 9) red[((sl * 2 + hk) * 9 + tap) * CP + c] = accd[hk][nf][e];
        }
    __syncthreads();
    const int classes = parity ? 2 : 1;
    float* ps = partials + (long long)blockIdx.x * classes * 10 * C;
    for (int i = threadIdx.x; i < 9 * C; i += NTHR) {
      const int tap = i / C, c = i % C;
      float h[2] = {0.0f, 0.0f};
#pragma unroll
      for (int hk = 0; hk < 2; ++hk)
        for (int s = 0; s < NS; ++s) h[hk] += red[((s * 2 + hk) * 9 + tap) * CP + c];
      if (parity) {
        ps[i] = h[0];
        ps[10 * C + i] = h[1];
      } else {
        ps[i] = h[0] + h[1];
      }
    }
    for (int c = threadIdx.x; c < C; c += NTHR) {
      float s = 0.0f;
      for (int w = 0; w < P::WM; ++w) s += sums[w * CP + c];
      ps[9 * C + c] = s;
      if (parity) ps[19 * C + c] = 0.0f;
    }
  }
}

// K5b1 in bfloat16: x [B, T, F], dout [B, T/pt, F/pf, C] bfloat16; one slot a block.
template <int CP, int NW>
__global__ void __launch_bounds__(32 * NW, NW == 8 ? 2 : 1)
entry_block_bwd_reduce_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dout,
                                   const float* __restrict__ cw, const float* __restrict__ cb,
                                   const float* __restrict__ scale, const float* __restrict__ bias,
                                   const float* __restrict__ mean, const float* __restrict__ var,
                                   const float* __restrict__ glu_w, const float* __restrict__ glu_b,
                                   float* __restrict__ partials, int B, int T, int F, int C, int pt, int pf, float eps,
                                   Dropout dr, int buffers, int drows, int mode) {
  bwd_bf16_body<CP, NW, 1>(x, dout, cw, cb, scale, bias, mean, var, glu_w, glu_b, nullptr, nullptr, partials, B, T, F, C,
                           pt, pf, eps, dr, buffers, drows, mode, false, false);
}

// K5b2 in bfloat16: as K5b1, with a, b2 [C]; partition 1 parity, 2 batch halves.
template <int CP, int NW>
__global__ void __launch_bounds__(32 * NW, NW == 8 ? 2 : 1)
entry_block_bwd_wgrad_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dout,
                                  const float* __restrict__ cw, const float* __restrict__ cb,
                                  const float* __restrict__ scale, const float* __restrict__ bias,
                                  const float* __restrict__ mean, const float* __restrict__ var,
                                  const float* __restrict__ glu_w, const float* __restrict__ glu_b,
                                  const float* __restrict__ a, const float* __restrict__ b2,
                                  float* __restrict__ partials, int B, int T, int F, int C, int pt, int pf, float eps,
                                  Dropout dr, int buffers, int drows, int mode, int partition) {
  bwd_bf16_body<CP, NW, 2>(x, dout, cw, cb, scale, bias, mean, var, glu_w, glu_b, a, b2, partials, B, T, F, C, pt, pf,
                           eps, dr, buffers, drows, mode, partition == 1, partition == 2);
}

// ------------------------------------ K5f in bfloat16: K2f's tensor-core tile

// The bfloat16 forward runs K2f's bfloat16 tile code (bf16_tile.cuh) on a y
// tile it computes itself. Per tile: x with its one-cell halo (float32
// [trows + 2][F + 2], loaded into registers during the previous tile); y =
// bf16(conv9 + cb) once (conv_tile_bf16, the order of K4f and of the
// backward passes) into the bfloat16 tile [kPix][RS] that K2f's forward
// stages y into; A = bf16(xn) (form_a); lin = A . W on mma.sync
// (product_w); then glu_pool_bf16: g in the fragments' registers, g in
// float32 over the y tile and A, and per window and four channels the mask
// and the pool in the planes rounding (K2's: each pt-row column sum rounded)
// or, with pool_elems, the crows rounding (every g rounded). 8 warps and two
// blocks an SM at CP = 64, 16 warps at CP = 128 (K2f's). Launch plan: a
// grid of `gridDim.x` blocks, block k taking tiles [k n / G, (k + 1) n / G)
// of the n = B * tiles of the batch, clip after clip (the wrapper sizes it);
// no output depends on it.
template <int CP>
constexpr int kFwdWarps = CP == 128 ? 16 : 8;

// Dynamic shared memory of the bfloat16 forward (ops/fused_entry_block.
// fwd_bf16_plan computes the same): the y and A tiles [kPix][RS] and W
// [CP][RS] in bfloat16; five vectors [CP], the conv weights [9][CP] and bias
// [CP] and the x tile [kHalo] in float32.
template <int CP>
constexpr size_t fwd_bf16_smem() {
  return 2 * (size_t)BfPlan<CP, kFwdWarps<CP>>::RS * (2 * kPix + CP) + 4 * (15 * (size_t)CP + kHalo);
}

template <int CP, int NW>
__global__ void __launch_bounds__(32 * NW, NW == 8 ? 2 : 1)
entry_block_fwd_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ cw, const float* __restrict__ cb,
                            const float* __restrict__ scale, const float* __restrict__ bias,
                            const float* __restrict__ mean, const float* __restrict__ var,
                            const float* __restrict__ glu_w, const float* __restrict__ glu_b, bf16* __restrict__ out,
                            int B, int T, int F, int C, int pt, int pf, float eps, Dropout dr, int pool_elems) {
  using P = BfPlan<CP, NW>;
  constexpr int RS = P::RS, MT = P::MT, NTHR = P::NTHR, NX = (kHalo + NTHR - 1) / NTHR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* yb = reinterpret_cast<bf16*>(smem_raw);  // [kPix][RS]: y (with A, the float32 g tile [kPix][GS])
  bf16* A = yb + kPix * RS;                       // [kPix][RS]: bf16(xn)
  bf16* ws = A + kPix * RS;                       // [CP][RS]: W (in, out)
  float* vmean = reinterpret_cast<float*>(ws + CP * RS);
  float* vinv = vmean + CP;
  float* vscale = vinv + CP;
  float* vbias = vscale + CP;
  float* vgb = vbias + CP;
  float* cws = vgb + CP;      // [9][CP]: conv weights, zeros past C
  float* cbs = cws + 9 * CP;  // [CP]: conv bias
  float* xt = cbs + CP;       // [kHalo]: x with its halo
  stage_bf16_consts<CP>(ws, vmean, vinv, vscale, vbias, vgb, nullptr, glu_w, scale, bias, mean, var, glu_b, C, eps);
  stage_conv<CP, NTHR>(cws, cbs, cw, cb, C);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, wm = warp / P::WN, wn = warp % P::WN;
  const unsigned long long seed = seed_of(dr);
  const int Fp = F / pf;
  const float inv_win = 1.0f / (float)(pt * pf);
  const Tile tl = tile_of(F, pt, pf);
  const int n_tiles = tiles_per_clip(T, F, pt, pf);
  const long long n = (long long)B * n_tiles;
  const int first = (int)(blockIdx.x * n / gridDim.x), last = (int)((blockIdx.x + 1) * n / gridDim.x);
  auto pos = [&](int t) { return tile_pos(t % n_tiles, t / n_tiles, T, F, tl); };

  float xr[NX];
  if (first < last) load_x<NX, NTHR>(xr, x, pos(first), first / n_tiles, T, F);
  for (int t = first; t < last; ++t) {
    const TilePos tp = pos(t);
    const int tpix = tp.trows * tp.fcols;
    store_x<NX, NTHR>(xt, xr, (tp.trows + 2) * (F + 2));  // every warp is past the previous tile's conv
    __syncthreads();  // x in place; every warp is done with the previous tile's pool
    if (t + 1 < last) load_x<NX, NTHR>(xr, x, pos(t + 1), (t + 1) / n_tiles, T, F);
    conv_tile_bf16<CP, NW, false>(yb, nullptr, xt, cws, cbs, F, tpix, C, false);
    __syncthreads();  // y complete
    form_a<CP>(A, yb, vmean, vinv, vscale, vbias, tpix);
    __syncthreads();  // A complete
    float acc[MT][4][4];
    zero_acc(acc);
    product_w<CP, NW, true>(acc, A, ws, wm, wn, lane);
    glu_pool_bf16<CP, NW>(acc, yb, reinterpret_cast<float*>(yb), vmean, vinv, vscale, vbias, vgb, tp, C, pt, pf, Fp,
                          inv_win, dr, seed, pool_elems != 0, out);
  }
}

// ---------------------------------------------------------- the mask alone

// out[e] = 1 where element e is kept, else 0 (the draw of chain.cuh:
// keep_values4; dr.mode 1 or 2).
__global__ void __launch_bounds__(kThreads)
dropout_mask_kernel(float* __restrict__ out, long long n, Dropout dr) {
  const unsigned long long seed = seed_of(dr);
  const uint32_t threshold = dr.threshold;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; 4 * i < n; i += stride) {
    const uint4 r = keep_values4(4 * i, seed, dr.mode);
    const uint32_t words[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (4 * i + k < n) out[4 * i + k] = words[k] >= threshold ? 1.0f : 0.0f;
  }
}

// ----------------------------------------------------------------- launches

dim3 tile_grid(int B, int T, int rows, int tiles_per_block) {
  const int n_tiles = (T + rows - 1) / rows;
  return dim3((n_tiles + tiles_per_block - 1) / tiles_per_block, B);
}

// The fold of K5b2 bfloat16's slots: the parts' sums rounded to bfloat16 and
// added. parts: 1, 2 (the two halves of each slot, by output-frequency
// parity) or -2 (two classes of slots: the first and the second half of the
// clips).
cudaError_t fold_wgrad_bf16(const float* partials, float* out, int slots, int width, int n_round, int parts,
                            cudaStream_t stream) {
  if (parts == -2)
    return launch_fold_classes<float, bf16>(partials, out, slots / 2, width, 2, width,
                                            (long long)(slots / 2) * width, n_round, stream);
  return launch_fold_classes<float, bf16>(partials, out, slots, width, parts, (long long)parts * width,
                                          width, n_round, stream);
}

template <int MODE>
int launch_entry_conv(const void* x, const float* w, const float* cb, void* y,
                      double* partials, float* sums, int B, int T, int F, int C,
                      int tiles_per_block, cudaStream_t stream) {
  const int rows = rows_per_tile(F, 1);
  const dim3 grid = tile_grid(B, T, rows, tiles_per_block);
  const int groups = kThreads / (C / 4);
  const size_t smem = sizeof(double) * (size_t)groups * 2 * C;
  entry_conv_kernel<MODE><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), w, cb, static_cast<float*>(y), partials, T, F, C, rows, tiles_per_block);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_fold<double>(partials, sums, (int)(grid.x * grid.y), 2 * C, stream);
}

int launch_entry_conv_f32(int mode, const void* x, const float* w, const float* cb, void* y, double* partials,
                          float* sums, int B, int T, int F, int C, int tiles_per_block, cudaStream_t st) {
  switch (mode) {
    case 0: return launch_entry_conv<0>(x, w, cb, y, partials, sums, B, T, F, C, tiles_per_block, st);
    case 1: return launch_entry_conv<1>(x, w, cb, y, partials, sums, B, T, F, C, tiles_per_block, st);
    case 2: return launch_entry_conv<2>(x, w, cb, y, partials, sums, B, T, F, C, tiles_per_block, st);
    case 3: return launch_entry_conv<3>(x, w, cb, y, partials, sums, B, T, F, C, tiles_per_block, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Blocks of entry_conv_run_kernel that one SM holds (registers; the shared
// memory is static): in bfloat16 the fewer of its two modes', in float32 of
// its one mode (the sums).
cudaError_t conv_run_resident(bool bf16_x, int* resident) {
  int stored = 0, sums_only = 0;
  if (!bf16_x)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, entry_conv_run_kernel<float, false>,
                                                         kConvThreads, 0);
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&stored, entry_conv_run_kernel<bf16, true>,
                                                                  kConvThreads, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&sums_only, entry_conv_run_kernel<bf16, false>,
                                                        kConvThreads, 0);
  *resident = stored < sums_only ? stored : sums_only;
  return err;
}

// blocks: the grid (one slot each); rows: a tile's time rows, (rows + 2)
// conv_stride(F) <= kConvHalo: the plan of ops/entry_conv.conv_run_plan;
// store: bfloat16 only
int launch_entry_conv_run(bool bf16_x, bool store, const void* x, const float* w, const float* cb, void* y,
                          double* partials, float* sums, int B, int T, int F, int C, int blocks, int rows,
                          cudaStream_t st) {
  if (blocks < 1 || rows < 1 || (rows + 2) * conv_stride(F) > kConvHalo || C % kConvChans != 0 ||
      (long long)B * T >= (1LL << 31) || (store && !bf16_x))
    return (int)cudaErrorInvalidValue;
  if (!bf16_x)
    entry_conv_run_kernel<float, false><<<blocks, kConvThreads, 0, st>>>(
        static_cast<const float*>(x), w, cb, nullptr, partials, B, T, F, C, rows);
  else if (store)
    entry_conv_run_kernel<bf16, true><<<blocks, kConvThreads, 0, st>>>(
        static_cast<const bf16*>(x), w, cb, static_cast<bf16*>(y), partials, B, T, F, C, rows);
  else
    entry_conv_run_kernel<bf16, false><<<blocks, kConvThreads, 0, st>>>(
        static_cast<const bf16*>(x), w, cb, nullptr, partials, B, T, F, C, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_fold_warps<double>(partials, sums, blocks, 2 * C, st);
}

// K4w's shared memory set at F, C and tiles of `rows` rows (bfloat16 x: the
// kernel of CP = 64 or 128); its blocks an SM into *resident where that is not
// null (registers and shared memory).
cudaError_t dw_attrs(bool bf16_x, int F, int C, int rows, int* resident) {
  const void* fn = !bf16_x ? reinterpret_cast<const void*>(entry_conv_dw_f32_kernel)
                   : C <= 64 ? reinterpret_cast<const void*>(entry_conv_dw_bf16_kernel<64>)
                             : reinterpret_cast<const void*>(entry_conv_dw_bf16_kernel<128>);
  const size_t smem = !bf16_x ? dw_f32_smem(F, C, rows) : C <= 64 ? dw_bf16_smem<64>() : dw_bf16_smem<128>();
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess || resident == nullptr) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, fn, kDwThreads, smem);
}

// blocks: the grid (one slot each); rows: a tile's time rows, at most
// kDwTilePix pixels (ops/entry_conv.wgrad_plan); classes 1, or 2 (bfloat16, F
// even: dW by output-frequency parity)
template <typename TX>
int launch_entry_conv_wgrad(const void* x, const void* dy, float* partials, float* out, int B, int T, int F, int C,
                            int blocks, int rows, int classes, cudaStream_t st) {
  constexpr bool kBf16 = !std::is_same<TX, float>::value;
  if (blocks < 1 || F < 1 || F > kDwTilePix || C < 4 || C > 128 || C % 4 != 0 || rows < 1 ||
      rows * F > kDwTilePix || (classes != 1 && (classes != 2 || !kBf16 || F % 2 != 0)) ||
      (long long)B * T >= (1LL << 31) || reinterpret_cast<uintptr_t>(dy) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = dw_attrs(kBf16, F, C, rows, nullptr);
  if (err != cudaSuccess) return (int)err;
  if constexpr (!kBf16)
    entry_conv_dw_f32_kernel<<<blocks, kDwThreads, dw_f32_smem(F, C, rows), st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), partials, B, T, F, C, rows);
  else if (C <= 64)
    entry_conv_dw_bf16_kernel<64><<<blocks, kDwThreads, dw_bf16_smem<64>(), st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(dy), partials, B, T, F, C, rows, classes == 2);
  else
    entry_conv_dw_bf16_kernel<128><<<blocks, kDwThreads, dw_bf16_smem<128>(), st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(dy), partials, B, T, F, C, rows, classes == 2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_fold_classes_warps<float, TX>(partials, out, blocks, 10 * C, classes, (long long)classes * 10 * C,
                                                   10 * C, 9 * C, st);
}

// The parameters of a fused first-block launch, shared by the K5 kernels.
struct BlockArgs {
  const void* x;
  const void* dout;
  const float *cw, *cb, *scale, *bias, *mean, *var, *glu_w, *glu_b, *a, *b2;
  int B, T, F, C, pt, pf;
  float eps;
  Dropout dr;
};

// The float32 forward's shared memory set; its blocks an SM into *resident
// where that is not null (registers and shared memory).
template <int NJ>
cudaError_t fwd_entry_attrs(int* resident) {
  constexpr size_t smem = fwd_entry_smem<NJ>();
  cudaError_t err = cudaFuncSetAttribute(entry_block_fwd_f32_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess || resident == nullptr) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, entry_block_fwd_f32_kernel<NJ>, FwdPlan<NJ>::NT,
                                                       smem);
}

template <int NJ>
int launch_block_fwd(const BlockArgs& g, void* out, int blocks, cudaStream_t stream) {
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = fwd_entry_attrs<NJ>(nullptr);
  if (err != cudaSuccess) return (int)err;
  const int vec = reinterpret_cast<uintptr_t>(out) % 16 == 0;
  entry_block_fwd_f32_kernel<NJ><<<blocks, FwdPlan<NJ>::NT, fwd_entry_smem<NJ>(), stream>>>(
      static_cast<const float*>(g.x), g.cw, g.cb, g.scale, g.bias, g.mean, g.var, g.glu_w, g.glu_b,
      static_cast<float*>(out), g.B, g.T, g.F, g.C, g.pt, g.pf, g.eps, g.dr, vec);
  return (int)cudaGetLastError();
}

// The float32 pass 1's shared memory set; its blocks an SM into *resident
// where that is not null (registers and shared memory).
template <int NJ>
cudaError_t red_entry_attrs(int buffers, int drows, int* resident) {
  const size_t smem = red_entry_smem<NJ>(buffers, drows);
  cudaError_t err = cudaFuncSetAttribute(entry_block_bwd_reduce_f32_kernel<NJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess || resident == nullptr) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, entry_block_bwd_reduce_f32_kernel<NJ>, kThreads,
                                                       smem);
}

// blocks: the grid; buffers 1 or 2 with drows = kPix / (pt pf), or one
// buffer and drows 0 (dout read from device memory): the plan of
// ops/fused_entry_block.f32_reduce_plan
template <int NJ>
int launch_bwd_reduce_f32(const BlockArgs& g, float* partials, float* sums, int blocks, int tiles_per_slot,
                          int buffers, int drows, cudaStream_t stream) {
  const int rows = kPix / (g.pt * g.pf);
  if (blocks < 1 || tiles_per_slot < 1 || !((buffers == 1 || buffers == 2) && drows == rows) &&
      !(buffers == 1 && drows == 0))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = red_entry_attrs<NJ>(buffers, drows, nullptr);
  if (err != cudaSuccess) return (int)err;
  const bool vec = reinterpret_cast<uintptr_t>(g.dout) % 16 == 0;
  entry_block_bwd_reduce_f32_kernel<NJ><<<blocks, kThreads, red_entry_smem<NJ>(buffers, drows), stream>>>(
      static_cast<const float*>(g.x), static_cast<const float*>(g.dout), g.cw, g.cb, g.scale, g.bias, g.mean,
      g.var, g.glu_w, g.glu_b, partials, g.B, g.T, g.F, g.C, g.pt, g.pf, g.eps, g.dr, tiles_per_slot, buffers, drows,
      (int)vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = tiles_per_clip(g.T, g.F, g.pt, g.pf);
  const int slots = g.B * ((n_tiles + tiles_per_slot - 1) / tiles_per_slot);
  return (int)launch_fold<float>(partials, sums, slots, g.C * g.C + 3 * g.C, stream);
}

// The float32 pass 2's shared memory set; its blocks an SM into *resident
// where that is not null (registers and shared memory).
template <int NJ>
cudaError_t wgrad_entry_attrs(int buffers, int drows, int* resident) {
  const size_t smem = wgrad_entry_smem<NJ>(buffers, drows);
  cudaError_t err = cudaFuncSetAttribute(entry_block_bwd_wgrad_f32_kernel<NJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess || resident == nullptr) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, entry_block_bwd_wgrad_f32_kernel<NJ>, kThreads,
                                                       smem);
}

// blocks: the grid, one slot each; buffers 1 or 2 with drows = kPix / (pt
// pf), or one buffer and drows 0 (dout read from device memory): the plan of
// ops/fused_entry_block.f32_wgrad_plan
template <int NJ>
int launch_bwd_wgrad_f32(const BlockArgs& g, float* partials, float* sums, int blocks, int buffers, int drows,
                         cudaStream_t stream) {
  const int rows = kPix / (g.pt * g.pf);
  if (blocks < 1 || !((buffers == 1 || buffers == 2) && drows == rows) && !(buffers == 1 && drows == 0))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = wgrad_entry_attrs<NJ>(buffers, drows, nullptr);
  if (err != cudaSuccess) return (int)err;
  const bool vec = reinterpret_cast<uintptr_t>(g.dout) % 16 == 0;
  entry_block_bwd_wgrad_f32_kernel<NJ><<<blocks, kThreads, wgrad_entry_smem<NJ>(buffers, drows), stream>>>(
      static_cast<const float*>(g.x), static_cast<const float*>(g.dout), g.cw, g.cb, g.scale, g.bias, g.mean,
      g.var, g.glu_w, g.glu_b, g.a, g.b2, partials, g.B, g.T, g.F, g.C, g.pt, g.pf, g.eps, g.dr, buffers, drows,
      (int)vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_fold<float>(partials, sums, blocks, 10 * g.C, stream);
}

// The bfloat16 forward's shared memory set; its blocks an SM into *resident
// where that is not null (registers and shared memory).
template <int CP>
cudaError_t fwd_bf16_attrs(int* resident) {
  constexpr int NW = kFwdWarps<CP>;
  constexpr size_t smem = fwd_bf16_smem<CP>();
  cudaError_t err = cudaFuncSetAttribute(entry_block_fwd_bf16_kernel<CP, NW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess || resident == nullptr) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, entry_block_fwd_bf16_kernel<CP, NW>, 32 * NW, smem);
}

template <int CP>
int launch_fwd_bf16(const BlockArgs& g, void* out, int blocks, int pool_elems, cudaStream_t stream) {
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  constexpr int NW = kFwdWarps<CP>;
  cudaError_t err = fwd_bf16_attrs<CP>(nullptr);
  if (err != cudaSuccess) return (int)err;
  entry_block_fwd_bf16_kernel<CP, NW><<<blocks, 32 * NW, fwd_bf16_smem<CP>(), stream>>>(
      static_cast<const bf16*>(g.x), g.cw, g.cb, g.scale, g.bias, g.mean, g.var, g.glu_w, g.glu_b,
      static_cast<bf16*>(out), g.B, g.T, g.F, g.C, g.pt, g.pf, g.eps, g.dr, pool_elems);
  return (int)cudaGetLastError();
}

// How a bfloat16 pass copies rows of dout: 2, 16-byte cp.async (C % 8 == 0,
// 16-byte aligned); 1, 8-byte cp.async; 0, loads of the values.
int dout_mode(int C, const void* dout) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(dout);
  return C % 8 == 0 && p % 16 == 0 ? 2 : p % 8 == 0 ? 1 : 0;
}

// A bfloat16 pass's shared memory set; its blocks an SM into *resident
// where that is not null (registers and shared memory).
template <int CP, int PASS>
cudaError_t bwd_bf16_attrs(int buffers, int drows, int* resident) {
  constexpr int NW = kEntryWarps<CP>;
  const void* fn = PASS == 1 ? reinterpret_cast<const void*>(entry_block_bwd_reduce_bf16_kernel<CP, NW>)
                             : reinterpret_cast<const void*>(entry_block_bwd_wgrad_bf16_kernel<CP, NW>);
  const size_t smem = bwd_bf16_smem<CP, NW>(PASS, buffers, drows);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess || resident == nullptr) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, fn, 32 * NW, smem);
}

// blocks: the grid; buffers 1 or 2 and drows = kPix / (pt pf), the plan of
// ops/fused_entry_block.bf16_bwd_plan
template <int CP>
int launch_bwd_reduce_bf16(const BlockArgs& g, float* partials, float* sums, int blocks, int buffers, int drows,
                           cudaStream_t st) {
  if (blocks < 1 || (buffers != 1 && buffers != 2) || drows != kPix / (g.pt * g.pf)) return (int)cudaErrorInvalidValue;
  cudaError_t err = bwd_bf16_attrs<CP, 1>(buffers, drows, nullptr);
  if (err != cudaSuccess) return (int)err;
  entry_block_bwd_reduce_bf16_kernel<CP, kEntryWarps<CP>>
      <<<blocks, 32 * kEntryWarps<CP>, bwd_bf16_smem<CP, kEntryWarps<CP>>(1, buffers, drows), st>>>(
          static_cast<const bf16*>(g.x), static_cast<const bf16*>(g.dout), g.cw, g.cb, g.scale, g.bias, g.mean, g.var,
          g.glu_w, g.glu_b, partials, g.B, g.T, g.F, g.C, g.pt, g.pf, g.eps, g.dr, buffers, drows,
          dout_mode(g.C, g.dout));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_fold<float>(partials, sums, blocks, g.C * g.C + 3 * g.C, st);
}

// partition 0: one part; 1: output-frequency parity (F even); 2: batch
// halves (B and blocks even)
template <int CP>
int launch_bwd_wgrad_bf16(const BlockArgs& g, float* partials, float* sums, int blocks, int buffers, int drows,
                          int partition, cudaStream_t st) {
  if (blocks < 1 || (buffers != 1 && buffers != 2) || drows != kPix / (g.pt * g.pf) || partition < 0 ||
      partition > 2 || (partition == 1 && g.F % 2 != 0) || (partition == 2 && (g.B % 2 != 0 || blocks % 2 != 0)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = bwd_bf16_attrs<CP, 2>(buffers, drows, nullptr);
  if (err != cudaSuccess) return (int)err;
  entry_block_bwd_wgrad_bf16_kernel<CP, kEntryWarps<CP>>
      <<<blocks, 32 * kEntryWarps<CP>, bwd_bf16_smem<CP, kEntryWarps<CP>>(2, buffers, drows), st>>>(
          static_cast<const bf16*>(g.x), static_cast<const bf16*>(g.dout), g.cw, g.cb, g.scale, g.bias, g.mean, g.var,
          g.glu_w, g.glu_b, g.a, g.b2, partials, g.B, g.T, g.F, g.C, g.pt, g.pf, g.eps, g.dr, buffers, drows,
          dout_mode(g.C, g.dout), partition);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int parts = partition == 0 ? 1 : partition == 1 ? 2 : -2;
  return (int)fold_wgrad_bf16(partials, sums, blocks, 10 * g.C, 9 * g.C, parts, st);
}

BlockArgs block_args(const void* x, const void* dout, const void* cw, const void* cb, const void* scale,
                     const void* bias, const void* mean, const void* var, const void* glu_w,
                     const void* glu_b, const void* a, const void* b2, int B, int T, int F, int C,
                     int pt, int pf, float eps, const Dropout& dr) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  return BlockArgs{x, dout, f(cw), f(cb), f(scale), f(bias), f(mean), f(var), f(glu_w), f(glu_b),
                   f(a), f(b2), B, T, F, C, pt, pf, eps, dr};
}

inline const float* fp(const void* p) { return static_cast<const float*>(p); }

}  // namespace

extern "C" {

// x: [B, T, F] float32, or bfloat16 when bf16 != 0; w: [3, 3, 1, C] float32
// (rounded to bfloat16 by the caller or, in bfloat16, by the kernel); cb: [C]
// float32; y: [B, T, F, C] in x's type (unused in mode 1); sums: [2, C]
// float32 = sum y | sum y^2 of y as stored. F <= 128, C % 4 == 0, C <= 128
// (ops/entry_conv.py:entry_conv_packable). mode: 0 full, 1 sums only, 2 one
// tap, 3 bias write only (2 and 3 in float32 only).
// rows 0 (float32 only): entry_conv_kernel<mode>; grid: the tiles of a clip
// a block takes (tiles = dcase_bn_glu_pool_tiles(T, F, 1, 1)); partials: [B
// * ceil(tiles / grid), 2C] float64 scratch.
// rows > 0: entry_conv_run_kernel (bfloat16 in modes 0 and 1, float32 in
// mode 1); grid: the blocks (one wave of equal runs of the batch's time
// rows); partials: [grid, 2C] float64 scratch; rows: a tile's time rows
// (ops/entry_conv.conv_run_plan).
int dcase_entry_conv(const void* x, const void* w, const void* cb, void* y, void* partials,
                     void* sums, int B, int T, int F, int C, int mode, int grid, int bf16, int rows,
                     void* stream) {
  auto* pa = static_cast<double*>(partials);
  auto* su = static_cast<float*>(sums);
  auto st = static_cast<cudaStream_t>(stream);
  if (!bf16 && rows == 0) return launch_entry_conv_f32(mode, x, fp(w), fp(cb), y, pa, su, B, T, F, C, grid, st);
  if (mode != 0 && mode != 1) return (int)cudaErrorInvalidValue;
  return launch_entry_conv_run(bf16 != 0, mode == 0, x, fp(w), fp(cb), y, pa, su, B, T, F, C, grid, rows, st);
}

// Blocks of the one-wave conv that one SM of the current device holds (0 on
// an error), on bfloat16 x in both modes, on float32 x (the sums); the
// wrapper sizes the grid from it.
int dcase_entry_conv_bf16_resident() {
  int resident = 0;
  return conv_run_resident(true, &resident) == cudaSuccess ? resident : 0;
}

int dcase_entry_conv_f32_resident() {
  int resident = 0;
  return conv_run_resident(false, &resident) == cudaSuccess ? resident : 0;
}

// Blocks of K4w that one SM of the current device holds at F, C and tiles of
// `rows` rows, on bfloat16 x when bf16 != 0 (0 on an error); the wrapper
// sizes the grid from it.
int dcase_entry_conv_wgrad_resident(int bf16, int F, int C, int rows) {
  int resident = 0;
  return dw_attrs(bf16 != 0, F, C, rows, &resident) == cudaSuccess ? resident : 0;
}

// x, dy: [B, T, F], [B, T, F, C] in one type (float32, or bfloat16 when
// bf16 != 0), dy 16-byte aligned; blocks: the grid, one wave of equal runs
// of the batch's time rows; rows: a tile's time rows (ops/entry_conv.
// wgrad_plan); partials: [blocks, classes * 10C] float32; out: [10C] = dW
// [3, 3, 1, C] | db [C], folded from the slots in a fixed order. classes 1,
// or 2 (bfloat16, F even): dW as the sum over the output-frequency parities
// of each parity's sum. In bfloat16 each part's dW is rounded to bfloat16
// before the parts are added (the gradient of the bfloat16 weights); db is
// not rounded.
int dcase_entry_conv_wgrad(const void* x, const void* dy, void* partials, void* out, int B, int T, int F, int C,
                           int blocks, int rows, int bf16, int classes, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto* pa = static_cast<float*>(partials);
  auto* o = static_cast<float*>(out);
  return bf16 ? launch_entry_conv_wgrad<__nv_bfloat16>(x, dy, pa, o, B, T, F, C, blocks, rows, classes, st)
              : launch_entry_conv_wgrad<float>(x, dy, pa, o, B, T, F, C, blocks, rows, classes, st);
}

// Blocks of the float32 forward that one SM of the current device holds at
// C channels (0 on an error); the wrapper sizes the grid from it.
int dcase_entry_block_fwd_resident(int C) {
  int resident = 0;
  const cudaError_t err = C <= 64 ? fwd_entry_attrs<4>(&resident) : fwd_entry_attrs<8>(&resident);
  return err == cudaSuccess ? resident : 0;
}

// x: [B, T, F]; out: [B, T/pt, F/pf, C], both float32; cw: [3, 3, 1, C];
// cb, scale, bias, mean, var, glu_b: [C]; glu_w: [C, C] (in, out); the
// parameters float32, all contiguous. T % pt == 0, F % pf == 0,
// pt * F <= 128, C % 4 == 0, C <= 128
// (ops/fused_entry_block.py:entry_block_applicable). seed, threshold,
// keep_scale, packed as in dcase_bn_glu_pool; blocks: the grid, each block
// an equal run of the batch's tiles.
int dcase_entry_block_fwd(const void* x, const void* cw, const void* cb, const void* scale,
                          const void* bias, const void* mean, const void* var,
                          const void* glu_w, const void* glu_b, void* out, int B, int T, int F,
                          int C, int pt, int pf, float eps, const void* seed,
                          unsigned int threshold, float keep_scale, int packed, int blocks,
                          void* stream) {
  const BlockArgs g = block_args(x, nullptr, cw, cb, scale, bias, mean, var, glu_w, glu_b, nullptr, nullptr,
                                 B, T, F, C, pt, pf, eps, dropout_of(seed, threshold, keep_scale, packed));
  auto st = static_cast<cudaStream_t>(stream);
  return C <= 64 ? launch_block_fwd<4>(g, out, blocks, st) : launch_block_fwd<8>(g, out, blocks, st);
}

// Blocks of the bfloat16 forward that one SM of the current device holds at
// C channels (0 on an error); the wrapper sizes the grid from it.
int dcase_entry_block_fwd_bf16_resident(int C) {
  int resident = 0;
  const cudaError_t err = C <= 64 ? fwd_bf16_attrs<64>(&resident) : fwd_bf16_attrs<128>(&resident);
  return err == cudaSuccess ? resident : 0;
}

// The forward in bfloat16: x [B, T, F] and out [B, T/pt, F/pf, C] bfloat16
// (cw rounded to bfloat16 by the caller), the rest as in
// dcase_entry_block_fwd; blocks: the grid, each block an equal run of the
// batch's tiles. pool_elems: round each g of a window before the window sum
// (the crows layout) instead of each pt-row column sum (the planes layout).
int dcase_entry_block_fwd_bf16(const void* x, const void* cw, const void* cb, const void* scale, const void* bias,
                               const void* mean, const void* var, const void* glu_w, const void* glu_b, void* out,
                               int B, int T, int F, int C, int pt, int pf, float eps, const void* seed,
                               unsigned int threshold, float keep_scale, int packed, int blocks, int pool_elems,
                               void* stream) {
  const BlockArgs g = block_args(x, nullptr, cw, cb, scale, bias, mean, var, glu_w, glu_b, nullptr, nullptr,
                                 B, T, F, C, pt, pf, eps, dropout_of(seed, threshold, keep_scale, packed));
  auto st = static_cast<cudaStream_t>(stream);
  return C <= 64 ? launch_fwd_bf16<64>(g, out, blocks, pool_elems, st)
                 : launch_fwd_bf16<128>(g, out, blocks, pool_elems, st);
}

// Blocks of the float32 pass 1 that one SM of the current device holds at C
// channels under (buffers, drows) (0 on an error); the wrapper sizes the
// grid from it.
int dcase_entry_block_bwd_reduce_resident(int C, int buffers, int drows) {
  int resident = 0;
  const cudaError_t err = C <= 64 ? red_entry_attrs<4>(buffers, drows, &resident)
                                  : red_entry_attrs<8>(buffers, drows, &resident);
  return err == cudaSuccess ? resident : 0;
}

// First backward pass in float32. dout: [B, T/pt, F/pf, C] float32;
// tiles_per_slot: the tiles of a clip each slot sums (runs of a clip, the
// last shorter; K2b's reduce pass's tiles_per_block gives its slots);
// blocks: the grid, one wave over the batch's slots in equal runs;
// partials: [B * ceil(tiles / tiles_per_slot), C*C + 3C]; sums: [C*C + 3C]
// = d glu_w | d glu_b | S1 | S2, folded in slot order, float32; buffers,
// drows: the x and dout tiles in shared memory
// (ops/fused_entry_block.f32_reduce_plan).
int dcase_entry_block_bwd_reduce(const void* x, const void* dout, const void* cw,
                                 const void* cb, const void* scale, const void* bias,
                                 const void* mean, const void* var, const void* glu_w,
                                 const void* glu_b, void* partials, void* sums, int B, int T,
                                 int F, int C, int pt, int pf, float eps, const void* seed,
                                 unsigned int threshold, float keep_scale, int packed,
                                 int blocks, int tiles_per_slot, int buffers, int drows, void* stream) {
  const BlockArgs g = block_args(x, dout, cw, cb, scale, bias, mean, var, glu_w, glu_b, nullptr, nullptr,
                                 B, T, F, C, pt, pf, eps, dropout_of(seed, threshold, keep_scale, packed));
  auto* pa = static_cast<float*>(partials);
  auto* su = static_cast<float*>(sums);
  auto st = static_cast<cudaStream_t>(stream);
  return C <= 64 ? launch_bwd_reduce_f32<4>(g, pa, su, blocks, tiles_per_slot, buffers, drows, st)
                 : launch_bwd_reduce_f32<8>(g, pa, su, blocks, tiles_per_slot, buffers, drows, st);
}

// Blocks of the float32 pass 2 that one SM of the current device holds at C
// channels under (buffers, drows) (0 on an error); the wrapper sizes the
// grid from it.
int dcase_entry_block_bwd_wgrad_resident(int C, int buffers, int drows) {
  int resident = 0;
  const cudaError_t err = C <= 64 ? wgrad_entry_attrs<4>(buffers, drows, &resident)
                                  : wgrad_entry_attrs<8>(buffers, drows, &resident);
  return err == cudaSuccess ? resident : 0;
}

// Second backward pass in float32. a, b2: [C], from S1 and S2 (fused_block.py:
// bwd_coefficients); blocks: the grid, one wave over the batch's tiles in
// equal runs; partials: [blocks, 10C]; sums: [10C] = dW [3, 3, 1, C] | d
// conv_b [C], folded in slot order; buffers, drows: the x and dout tiles in
// shared memory (ops/fused_entry_block.f32_wgrad_plan).
int dcase_entry_block_bwd_wgrad(const void* x, const void* dout, const void* cw, const void* cb,
                                const void* scale, const void* bias, const void* mean,
                                const void* var, const void* glu_w, const void* glu_b,
                                const void* a, const void* b2, void* partials, void* sums,
                                int B, int T, int F, int C, int pt, int pf, float eps,
                                const void* seed, unsigned int threshold, float keep_scale,
                                int packed, int blocks, int buffers, int drows, void* stream) {
  const BlockArgs g = block_args(x, dout, cw, cb, scale, bias, mean, var, glu_w, glu_b, a, b2,
                                 B, T, F, C, pt, pf, eps, dropout_of(seed, threshold, keep_scale, packed));
  auto* pa = static_cast<float*>(partials);
  auto* su = static_cast<float*>(sums);
  auto st = static_cast<cudaStream_t>(stream);
  return C <= 64 ? launch_bwd_wgrad_f32<4>(g, pa, su, blocks, buffers, drows, st)
                 : launch_bwd_wgrad_f32<8>(g, pa, su, blocks, buffers, drows, st);
}

// Blocks of bfloat16 pass `pass` (1 or 2) that one SM of the current device
// holds at C channels under (buffers, drows) (0 on an error); the wrapper
// sizes the grid from it.
int dcase_entry_block_bwd_bf16_resident(int C, int pass, int buffers, int drows) {
  int resident = 0;
  cudaError_t err;
  if (pass == 1)
    err = C <= 64 ? bwd_bf16_attrs<64, 1>(buffers, drows, &resident) : bwd_bf16_attrs<128, 1>(buffers, drows, &resident);
  else
    err = C <= 64 ? bwd_bf16_attrs<64, 2>(buffers, drows, &resident) : bwd_bf16_attrs<128, 2>(buffers, drows, &resident);
  return err == cudaSuccess ? resident : 0;
}

// First backward pass in bfloat16: x [B, T, F] and dout [B, T/pt, F/pf, C]
// bfloat16, the rest as in dcase_entry_block_bwd_reduce; blocks: the grid,
// one wave over the batch's tiles in equal runs; partials: [blocks, C*C +
// 3C]; buffers, drows: the dout tiles in shared memory
// (ops/fused_entry_block.bf16_bwd_plan).
int dcase_entry_block_bwd_reduce_bf16(const void* x, const void* dout, const void* cw, const void* cb,
                                      const void* scale, const void* bias, const void* mean, const void* var,
                                      const void* glu_w, const void* glu_b, void* partials, void* sums, int B, int T,
                                      int F, int C, int pt, int pf, float eps, const void* seed,
                                      unsigned int threshold, float keep_scale, int packed, int blocks, int buffers,
                                      int drows, void* stream) {
  const BlockArgs g = block_args(x, dout, cw, cb, scale, bias, mean, var, glu_w, glu_b, nullptr, nullptr,
                                 B, T, F, C, pt, pf, eps, dropout_of(seed, threshold, keep_scale, packed));
  auto* pa = static_cast<float*>(partials);
  auto* su = static_cast<float*>(sums);
  auto st = static_cast<cudaStream_t>(stream);
  return C <= 64 ? launch_bwd_reduce_bf16<64>(g, pa, su, blocks, buffers, drows, st)
                 : launch_bwd_reduce_bf16<128>(g, pa, su, blocks, buffers, drows, st);
}

// Second backward pass in bfloat16, arguments as in the first with a, b2
// [C]; partials: [blocks, parts * 10C] (parts 2 under partition 1); sums:
// [10C] = dW [3, 3, 1, C] | d conv_b [C]. partition 0: one part; 1:
// output-frequency parity (F even); 2: batch halves (B and blocks even, the
// first half of the slots the first half of the clips). Each part's dW is
// rounded to bfloat16 before the parts are added; d conv_b is not rounded.
int dcase_entry_block_bwd_wgrad_bf16(const void* x, const void* dout, const void* cw, const void* cb,
                                     const void* scale, const void* bias, const void* mean, const void* var,
                                     const void* glu_w, const void* glu_b, const void* a, const void* b2,
                                     void* partials, void* sums, int B, int T, int F, int C, int pt, int pf, float eps,
                                     const void* seed, unsigned int threshold, float keep_scale, int packed,
                                     int blocks, int buffers, int drows, int partition, void* stream) {
  const BlockArgs g = block_args(x, dout, cw, cb, scale, bias, mean, var, glu_w, glu_b, a, b2,
                                 B, T, F, C, pt, pf, eps, dropout_of(seed, threshold, keep_scale, packed));
  auto* pa = static_cast<float*>(partials);
  auto* su = static_cast<float*>(sums);
  auto st = static_cast<cudaStream_t>(stream);
  return C <= 64 ? launch_bwd_wgrad_bf16<64>(g, pa, su, blocks, buffers, drows, partition, st)
                 : launch_bwd_wgrad_bf16<128>(g, pa, su, blocks, buffers, drows, partition, st);
}

// out: [n] float32 0/1 keep-mask of (seed, element index, threshold) in the
// 32-bit draw, or in the packed 8-bit draw when packed != 0; seed: one int64
// in device memory.
int dcase_dropout_mask(void* out, long long n, const void* seed, unsigned int threshold, int packed,
                       void* stream) {
  long long blocks = ((n + 3) / 4 + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  dropout_mask_kernel<<<(int)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), n, dropout_of(seed, threshold, 1.0f, packed ? 1 : 0));
  return (int)cudaGetLastError();
}

}  // extern "C"
