// K2: BatchNorm -> GLU -> dropout -> average pool, forward and backward, and
// the per-channel batch statistics, fused, on float32 or bfloat16
// activations, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of dcase2019_task4_tpu/ops/fused_block.py:
//   bn_glu_pool_kernel       _fwd_kernel (via _fwd_pallas), eval and train,
//                            float32 y; bn_glu_pool_bf16_kernel on bfloat16 y
//   bn_glu_pool_bwd_kernel   _bwd_reduce_kernel (first pass of _bwd_pallas),
//                            float32 y; bn_glu_pool_bwd_bf16_kernel on bfloat16 y
//   bn_bwd_fixup_kernel      _bwd_fixup_kernel (second pass of _bwd_pallas)
//   bn_bwd_fixup_recompute_kernel
//                            _bwd_fixup_recompute_kernel (second pass of
//                            _bwd_pallas under DCASE_FUSED_BWD_RECOMPUTE=1,
//                            whose first pass writes no dy_partial), float32
//                            y; bn_bwd_fixup_recompute_bf16_kernel on
//                            bfloat16 y
//   stats_kernel             _stats_kernel (batch_stats), float32 y;
//                            stats_bf16_kernel on bfloat16 y
//   fold_kernel (fold.cuh)   the carried accumulators of the sequential TPU
//                            grid (dw_ref, db_ref, s1_ref, s2_ref, sum_ref)
// The lane packing (kron(I_k, W), 0/1 pooling matrices on the MXU, per-tile
// PRNG seeds) is TPU layout and is not carried over: these kernels work on
// plain NHWC.
//
// Function, per pixel of y [B, T, F, C]:
//   xh = (y - mean) * rsqrt(var + eps);  xn = xh * scale + bias
//   lin[co] = sum_ci xn[ci] * W[ci, co] + b[co];  sig = sigmoid(xn)
//   g = lin * sig * (keep-mask / (1 - rate))
// then the mean of g over each (pt, pf) window -> out [B, T/pt, F/pf, C].
// Backward, per pixel, with dh = upsample(dout) / (pt * pf) * mask / keep:
//   dlin = dh * sig;  dxn = dlin . W^T + dh * lin * sig * (1 - sig)
//   dW += xn^T . dlin;  db += dlin;  S1 += dxn;  S2 += dxn * xh
//   dy_partial = rsqrt(var + eps) * scale * dxn
// and, once S1 and S2 are whole, dy = dy_partial - a - (y - mean) * b with
// a = inv * scale * S1 / N, b = inv^2 * scale * S2 / N (the wrapper forms a
// and b from the folded sums). The recompute variant stores no dy_partial:
// its second pass rebuilds dxn from y and dout (the first pass's tile code:
// lin_f32, gate_f32, dxn_f32 in float32; form_a, product_w, gate_bf16 in
// bfloat16) and writes dy = inv * scale * dxn - a - (y - mean) * b, rounded
// once, so in bfloat16 it is another function than the default, whose dy
// rounds through a bfloat16 dy_partial.
//
// Dropout: Philox4x32-10 keyed on the 64-bit seed, counter = global element
// index of y divided by 4; the four output words mask four neighbouring
// channels (or, in the packed 8-bit draw of DCASE_DROPOUT_PACK, counter =
// element / 16 and the four bytes of one word mask four channels:
// chain.cuh). The mask therefore depends only on (seed, element, rate, draw),
// never on tiling or launch geometry; it is never stored, and the backward
// regenerates it bit for bit. The seed is read from device memory, so the
// host never has to know it.
//
// At C = 128 the float32 forward's shared memory is 199 KB (two y buffers,
// one block an SM; 86 KB and two blocks an SM at C = 64), the float32 reduce
// pass's 209-214 KB (205 KB where dout stays in device memory) and the
// float32 recompute fixup's 200-208 KB (one y buffer; 91 KB and two blocks of
// 8 warps an SM at C = 64); the bfloat16 forward's 139 KB (two y buffers, one
// block of 16 warps an SM; 64 KB and 8 warps at C = 64), the bfloat16 reduce
// pass's 193 KB at pool (2, 4) (two buffers, 16 warps; 96 KB at C = 64) and
// the bfloat16 recompute fixup's 188 KB (two buffers, 16 warps; 91 KB and two
// blocks of 8 warps an SM at C = 64).
//
// Bound: at block 1 of the flagship shape (y = [24, 864, 64, 64], 340 MB)
// the forward reads y once (0.10 ms at 3.35 TB/s) and its 64x64 channel mix
// is 10.9 GFLOP (0.16 ms at the 67 TFLOP/s FP32 peak of the CUDA cores), so
// in plain FP32 the channel mix binds. The backward does three such
// products (lin, dlin . W^T, xn^T . dlin: 32.6 GFLOP, 0.49 ms) and moves
// 340 MB in and 340 MB out (0.20 ms): operations bind it too. The fixup and
// the statistics are pure streams (1019 MB and 340 MB). The recompute fixup
// moves y and dout in and dy out (0.21 ms) for two products (lin and dxn:
// 21.7 GFLOP, 0.33 ms): operations in float32; it spends them to save the
// default's dy_partial round trip (680 MB). In bfloat16 its products take the
// tensor cores (0.02 ms at block 1 of the scaled shape) and the bytes bind.
//
// Element type: every function takes float32 or bfloat16 y (the model's
// compute dtype). In bfloat16 the arithmetic outside the channel products
// stays float32 and rounds where the JAX kernels round (_chain_fwd,
// _pool_mxu, _recompute_dxn, _bwd_reduce_kernel with lp): xn and W enter the
// GLU product as bfloat16 (the sigmoid and the gate take the float32 xn);
// each window's pt-row time sum is rounded to bfloat16 before the frequency
// sum; dlin and W enter dxn = dlin . W^T, and xn and dlin enter dW, as
// bfloat16 (db sums the float32 dlin); the pooled output, dy_partial and dy
// are stored in bfloat16; dW, db, S1, S2 and the statistics stay float32.
// The bfloat16 forward, reduce pass and recompute fixup take those products
// on the tensor cores (mma.sync m16n8k16, bfloat16 operands, float32 sums:
// exactly the rounding of JAX's bf16 dot_general with a float32 result);
// only the order of the sums inside a product differs from the plain
// version's.
//
// Design: one block per (run of pixel tiles, clip). A pixel tile holds up to
// 128 pixels in whole pooling windows: whole pooling rows (pt time rows x F)
// where pt * F <= 128, else pt time rows x the most whole windows that fit
// (at 128 mels and pool (2, 4): 2 x 64). The dropout mask is keyed on the
// global element index, so the tiling does not change it. The tiles of a
// block are consecutive (frequency segments within a row pair, then time),
// so the block loads W and the per-channel vectors into shared memory once.
// Forward in float32 (bn_glu_pool_kernel): BN's scale folded into the
// weights once a block (W' = diag(inv * scale) W, b' = b + bias . W); per
// tile, y staged by cp.async a tile ahead and centred in place (x-hat = y -
// mean), the product x-hat . W' on 4 x 8 (C <= 64) or 8 x 8 (C <= 128)
// register tiles fed by 16-byte shared loads, the gate, the fast sigmoid and
// the four-channel mask in registers; each window summed by warp shuffles at
// block 1's geometry, elsewhere from g written over the tile by float4; only
// the pooled tile is written (see the comment at the kernel); its per-tile
// steps (FwdTile, f32_tile.cuh) are K5f's float32 forward's too. Backward
// reduce pass in float32 (bwd_reduce_f32): three channel products on
// 8-channel register
// tiles fed by 16-byte shared loads (a Hopper SM issues one shared load for
// four FFMAs), y and dout staged by cp.async a tile ahead, x-hat kept in shared memory so
// that S2 needs no second read of y, and a fast sigmoid (__expf and
// __fdividef: the full-precision exp and division took a tenth of the
// pass): see the comment at the function. The float32 recompute fixup
// (bn_bwd_fixup_recompute_kernel) runs the same tile code without the third
// product and the sums, on y - mean in place (so dy's (y - mean) b term is the
// plain version's), and writes dy by float4. That float32 tile code lives
// in f32_tile.cuh, which K5's float32 passes in entry_block.cu share. The
// four sums of a reduce pass's block go to its own slot of a workspace and
// fold_kernel adds the slots in a fixed order in double precision: no float
// atomics, so a run repeats bit for bit. The statistics of bfloat16 y
// (stats_bf16_kernel) stream y over one wave of equal runs of rows, 16-byte
// loads a few rows ahead, float32 sums over bounded runs (see the comment at
// the kernel). Plain FP32 FMAs in float32 (no TF32). The bfloat16
// forward, reduce pass and recompute fixup (see the comments at
// bn_glu_pool_bf16_kernel, bn_glu_pool_bwd_bf16_kernel and
// bn_bwd_fixup_recompute_bf16_kernel; their tile code, and the pixel
// tiles, live in bf16_tile.cuh, which K5's bfloat16 forward and backward
// passes in entry_block.cu share) keep the tiles in bfloat16, staged by
// cp.async a tile ahead, and multiply on mma.sync: at the scaled shapes their products take 0.1 and 0.3 ms at the
// tensor cores' rate where FP32 FMAs need 1.5 and 4.5 ms, so the bytes, the
// generator and the element steps bound them. The generator, the
// four-channel mask step and the sigmoid live in chain.cuh, shared with the
// entry-block kernels.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_tile.cuh"
#include "chain.cuh"
#include "cp_async.cuh"
#include "dtype.cuh"
#include "f32_tile.cuh"
#include "fold.cuh"
#include "mma.cuh"

namespace {

// ------------------------------------------------- float32: register tiles

// Dynamic shared memory of the float32 reduce pass (ops/fused_block.reduce_plan
// computes the same): `buffers` (1 or 2) x-hat tiles [kPix][KS], the dlin
// tile [kPix][KS], `buffers` dout tiles [drows][KS] (drows = 0: dout is read
// from device memory), W [CP][CP], seven vectors [CP], two tables [kPix] (int).
template <int NJ>
size_t red_f32_smem(int buffers, int drows) {
  using P = RedPlan<NJ>;
  return sizeof(float) * ((size_t)(buffers + 1) * kPix * P::KS + (size_t)buffers * drows * P::KS +
                          P::CP * P::CP + 7 * P::CP + 2 * kPix);
}

// y of a tile into xb [kPix][CP + 4] by cp.async, zeros past the tile and
// past C: thread tid of NT copies chunk tid % Q (four channels) of every (NT
// / Q)-th pixel row, the row's place carried by counters (no division a row).
template <int CP, int NT = kThreads>
__device__ __forceinline__ void stage_y_f32(float* xb, const float* __restrict__ y, const TilePos& tp, int F,
                                            int C, bool vec) {
  constexpr int Q = CP / 4, DP = NT / Q, KS = CP + 4;
  const int sq = threadIdx.x % Q, tpix = tp.trows * tp.fcols;
  int p = threadIdx.x / Q;
  int pr = p / tp.fcols, pc = p % tp.fcols;
  const int dpr = DP / tp.fcols, dpc = DP % tp.fcols;
  for (; p < kPix; p += DP) {
    const bool ok = p < tpix && 4 * sq < C;
    stage_row4(xb + p * KS + 4 * sq, ok ? y + ((tp.row0 + pr) * F + tp.f0 + pc) * C + 4 * sq : y, ok, vec);
    pc += dpc;
    pr += dpr;
    if (pc >= tp.fcols) {
      pc -= tp.fcols;
      ++pr;
    }
  }
}

// ------------------------------------------------------------------ forward

// FwdPlan<NJ>, the float32 forward's plan, and its per-tile steps (FwdTile)
// live in f32_tile.cuh, which K5f's float32 forward shares.

// Dynamic shared memory of the float32 forward (ops/fused_block.forward_plan
// computes the same): two buffers, each a y tile [kPix][KS] (then x-hat, then
// g) and its pixel table [kPix] (int); W' [CP][CP], four vectors [CP]: 86 KB
// at C <= 64 (two blocks an SM), 199 KB at C <= 128.
template <int NJ>
constexpr size_t fwd_f32_smem() {
  using P = FwdPlan<NJ>;
  return sizeof(float) * (2 * (kPix * P::KS + kPix) + P::CP * P::CP + 4 * P::CP);
}
static_assert(fwd_f32_smem<8>() <= 232448, "two y tiles of the float32 forward fit a block at C = 128");

// The float32 forward, eval and train. BN's scale is folded into the
// product: with G = inv * scale, xn = x-hat G + bias and lin = xn . W + b =
// x-hat . W' + b' for W' = diag(G) W and b' = b + bias . W, both formed once a
// block. The mean is subtracted in place as a tile lands, as the plain
// version does, so no sum cancels a mean * G term (folding the mean into b'
// too would lose float32 digits in proportion to |mean| / std). Per tile of
// up to 128 pixels (whole pooling windows): y staged by cp.async with its
// pixel table (the next tile's while this one multiplies), x-hat = y - mean
// formed in place by float4; lin on register tiles: thread (pg, cg) = (tid / CG, tid % CG) holds pixels pg + PG
// i (i < MI) x channels h H + 4 cg + j (h < 2, j < 4) and reads, per four
// input channels, MI float4 of y and eight of W' (row k, chunks cg and cg +
// CG: distinct 16-byte chunks across a quarter warp) for 32 MI FMAs; then in
// registers g = (lin + b') * sigmoid(x-hat G + bias) (the reduce pass's fast
// sigmoid) and, in train mode, the keep-mask of each float4 channel
// group, whose four channels are the four words of one Philox call
// (keep_values4 on the global element index); g goes over y, and per
// window and four channels a float4 sum over its pt x pf pixels, scaled by
// 1 / (pt pf), is stored in 16 bytes. At block 1's geometry (C <= 64, a tile
// of 2 x 64 pixels at pool (2, 4)) the windows are summed in registers and
// across the warp by shuffles instead: thread pixel pg + 32 i is (row i / 2,
// column pg + 32 (i % 2)), and a window's four columns are the pixel groups
// 4k .. 4k + 3 of one warp (lanes 8 (pg % 4) + cg); this saves g's round trip
// and two barriers a tile. Rows and windows are carried by counters and
// pixels read from a per-tile table: no division an element. Two blocks an
// SM at C <= 64 (the registers and the shared memory allow it).
template <int NJ>
__global__ void __launch_bounds__(FwdPlan<NJ>::NT, FwdPlan<NJ>::MIN_BLOCKS)
bn_glu_pool_kernel(const float* __restrict__ y, const float* __restrict__ scale, const float* __restrict__ bias,
                   const float* __restrict__ mean, const float* __restrict__ var, const float* __restrict__ glu_w,
                   const float* __restrict__ glu_b, float* __restrict__ out, int T, int F, int C, int pt, int pf,
                   float eps, Tile tl, int tiles_per_block, Dropout dr, int vec) {
  using P = FwdPlan<NJ>;
  constexpr int CP = P::CP, KS = P::KS, NT = P::NT;
  constexpr int Q = CP / 4, DP = NT / Q;  // centring: chunk tid % Q of every DP-th row
  extern __shared__ __align__(16) float smem_f[];
  float* xs = smem_f;               // [2][kPix][KS]: y, then x-hat, then g
  float* ws = xs + 2 * kPix * KS;   // [CP][CP]: W' (in, out)
  float* vgain = ws + CP * CP;      // [CP] each, zeros past C: G, mean, bias, b'
  float* vmean = vgain + CP;
  float* vbias = vmean + CP;
  float* vgb = vbias + CP;
  int* tabs = reinterpret_cast<int*>(vgb + CP);  // [2][kPix]: the global pixel of tile pixel p

  const int tid = threadIdx.x, b = blockIdx.y;
  const unsigned long long seed = seed_of(dr);
  const int Tp = T / pt, Fp = F / pf;
  const float inv_win = 1.0f / (float)(pt * pf);
  FwdTile<NJ>::stage_consts(ws, vgain, vmean, vbias, vgb, scale, bias, mean, var, glu_w, glu_b, C, eps);

  const int sq = tid % Q;
  const int n_tiles = tiles_per_clip(T, F, pt, pf);
  const int first = blockIdx.x * tiles_per_block;
  const int last = min(n_tiles, first + tiles_per_block);
  // y of tile `tile` into buffer buf by cp.async, and its pixel table
  auto stage = [&](int tile, int buf) {
    const TilePos tp = tile_pos(tile, b, T, F, tl);
    stage_y_f32<CP, NT>(xs + buf * kPix * KS, y, tp, F, C, vec != 0);
    for (int p = tid; p < kPix; p += NT) tabs[buf * kPix + p] = p < tp.trows * tp.fcols ? (int)tp.pixel(p) : 0;
  };
  if (first < last) stage(first, 0);
  cp_async_commit();
  for (int tile = first; tile < last; ++tile) {
    const int buf = (tile - first) & 1;
    const TilePos tp = tile_pos(tile, b, T, F, tl);
    const int tpix = tp.trows * tp.fcols;
    cp_async_wait_all();
    __syncthreads();  // this tile landed; every warp is done with the previous tile
    if (tile + 1 < last) {  // the next tile loads while this one multiplies
      stage(tile + 1, buf ^ 1);
      cp_async_commit();
    }
    float* xb = xs + buf * kPix * KS;
    const int* tab_y = tabs + buf * kPix;
    {  // x-hat = y - mean in place (rows past the tile stay as staged: nothing reads their result)
      const float4 mu = ld4(vmean + 4 * sq);
      for (int p = tid / Q; p < tpix; p += DP) {
        float4 v = ld4(xb + p * KS + 4 * sq);
        v = make_float4(v.x - mu.x, v.y - mu.y, v.z - mu.z, v.w - mu.w);
        st4(xb + p * KS + 4 * sq, v);
      }
    }
    __syncthreads();  // x-hat complete
    FwdTile<NJ>::glu_pool(xb, ws, vgain, vbias, vgb, tab_y, tp, b, tpix, C, pt, pf, Tp, Fp, inv_win, dr, seed, out,
                          vec);
  }
}

// ----------------------------------------------------------------- backward

// The float32 backward's per-tile code (f32_tile.cuh), shared by the reduce
// pass (bwd_reduce_f32), the recompute fixup (bn_bwd_fixup_recompute_kernel)
// and K5b1's float32 pass (entry_block.cu): all rebuild dxn per tile (the
// JAX package's _recompute_dxn). Thread (pg, cg) = (tid / CG, tid % CG) of
// RedPlan<NJ> holds, for both channel products and the element steps, pixels
// pg + PG i (i < MI) x channels h H + 4 cg + j (h < 2, j < 4).

// The float32 reduce pass. Per tile of up to 128 pixels (whole pooling
// windows): y and the tile's rows of dout are staged by cp.async (the next
// tile's while this one multiplies, where two buffers fit), y normalised in
// place into x-hat = (y - mean) * inv; then f32_tile.cuh's reduce_tile_f32:
// lin = xn . W + b with xn = x-hat * scale + bias formed from the x-hat
// operand as it is read; per element the gate term and dlin = dh * sig; dxn
// = dlin . W^T + gate; S1 += dxn, S2 += dxn * x-hat, dy_partial = inv *
// scale * dxn; M += x-hat^T . dlin, so that the block's dW = xn^T . dlin =
// scale[ci] M + bias[ci] db (write_reduce_slot_f32). W is stored once, chunk
// q (four channels) of row r at position q ^ ((r >> 2) & 7), so that lin's
// loads (row k, chunks cg and cg + CG) and dxn's loads (rows h H + 4 cg + j,
// chunk k) are each eight distinct 16-byte bank groups across a quarter
// warp: both products read float4, MI + 8 of them per 32 MI FMAs. M: thread
// (wg, wa, wb) keeps an 8 x 8 register tile, input channels h H + 4 wa + i x
// output channels h H + 4 wb + j, over the pixels p = wg (mod DG) of each
// tile, four float4 per 64 FMAs; the DG groups are added in group order at
// the block's end. db, S1 and S2 are summed by every thread over its pixels
// and added over the pixel groups in order.
template <int NJ>
__device__ __forceinline__ void bwd_reduce_f32(const float* __restrict__ y, const float* __restrict__ dout,
                                               const float* __restrict__ scale, const float* __restrict__ bias,
                                               const float* __restrict__ mean, const float* __restrict__ var,
                                               const float* __restrict__ glu_w, const float* __restrict__ glu_b,
                                               float* __restrict__ dyp, float* __restrict__ partials, int T,
                                               int F, int C, int pt, int pf, float eps, Tile tl,
                                               int tiles_per_block, Dropout dr, int buffers, int drows, bool vec) {
  using P = RedPlan<NJ>;
  constexpr int CP = P::CP, KS = P::KS;
  constexpr int Q = CP / 4, DP = kThreads / Q;  // staging: chunk tid % Q of every DP-th row
  extern __shared__ __align__(16) float smem_r[];
  float* xs = smem_r;                        // [buffers][kPix][KS]: y, then x-hat
  float* ds = xs + buffers * kPix * KS;      // [kPix][KS]: dlin
  float* dsm = ds + kPix * KS;               // [buffers][drows][KS]: the tile's rows of dout
  float* wsw = dsm + buffers * drows * KS;   // [CP][CP]: W (in, out), chunks swizzled
  RedVecs v;                                 // [CP] each, zeros past C
  int* tab_y = reinterpret_cast<int*>(carve_red_vecs(v, wsw + CP * CP, CP));  // [kPix]: the global pixel of tile pixel p
  int* tab_d = tab_y + kPix;  // [kPix]: its row of dout (of the staged rows, or of dout where drows == 0)

  const int tid = threadIdx.x, b = blockIdx.y;
  const unsigned long long seed = seed_of(dr);
  const int Tp = T / pt, Fp = F / pf;
  const float inv_win = 1.0f / (float)(pt * pf);

  stage_w_swizzled<CP>(wsw, glu_w, C);  // once a block
  stage_red_vecs<CP>(v, scale, bias, mean, var, glu_b, C, eps);

  // y and the dout rows of tile `tile` into buffer buf by cp.async, zeros
  // past the tile and past C
  const int sq = tid % Q;
  auto stage = [&](int tile, int buf) {
    const TilePos tp = tile_pos(tile, b, T, F, tl);
    stage_y_f32<CP>(xs + buf * kPix * KS, y, tp, F, C, vec);
    if (drows > 0) stage_dout_f32<CP>(dsm + buf * drows * KS, dout, tp, b, Tp, Fp, pt, pf, C, vec);
  };

  RedCarry r;
  zero_carry(r);
  const int n_tiles = tiles_per_clip(T, F, pt, pf);
  const int first = blockIdx.x * tiles_per_block;
  const int last = min(n_tiles, first + tiles_per_block);
  if (first < last) stage(first, 0);
  cp_async_commit();
  for (int tile = first; tile < last; ++tile) {
    const int buf = buffers == 2 ? (tile - first) & 1 : 0;
    const TilePos tp = tile_pos(tile, b, T, F, tl);
    const int tpix = tp.trows * tp.fcols;
    cp_async_wait_all();
    __syncthreads();  // this tile landed; every warp is done with the previous tile
    if (buffers == 2 && tile + 1 < last) {  // the next tile loads while this one multiplies
      stage(tile + 1, buf ^ 1);
      cp_async_commit();
    }
    float* xb = xs + buf * kPix * KS;
    const float* dtile = dsm + buf * drows * KS;
    {  // x-hat = (y - mean) * inv in place, zeros past the tile and past C
      const float4 m = ld4(v.vmean + 4 * sq), iv = ld4(v.vinv + 4 * sq);
      for (int p = tid / Q; p < kPix; p += DP) {
        float4 u4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (p < tpix) {
          const float4 u = ld4(xb + p * KS + 4 * sq);
          u4 = make_float4((u.x - m.x) * iv.x, (u.y - m.y) * iv.y, (u.z - m.z) * iv.z, (u.w - m.w) * iv.w);
        }
        st4(xb + p * KS + 4 * sq, u4);
      }
    }
    tile_tables(tab_y, tab_d, tp, tpix, b, F, Tp, Fp, pt, pf, drows);
    __syncthreads();  // x-hat and the tables complete
    reduce_tile_f32<NJ>(r, xb, ds, dtile, dout, wsw, v, tab_y, tab_d, dyp, tpix, C, drows, vec, inv_win, dr, seed);
    if (buffers == 1 && tile + 1 < last) {
      __syncthreads();  // every warp is done with the only buffers
      stage(tile + 1, 0);
      cp_async_commit();
    }
  }

  // the block's slot [C*C dW | C db | C S1 | C S2]; the tiles are scratch now
  const int slot = blockIdx.y * gridDim.x + blockIdx.x;
  write_reduce_slot_f32<NJ>(partials + (long long)slot * (C * C + 3 * C), r, xs, v, C);
}

// The float32 reduce pass. Workspace slot of a block: [C*C dW | C db | C S1 |
// C S2]. dyp == nullptr: no dy_partial (the recompute fixup rebuilds dxn
// instead). `buffers` (1 or 2) tiles, `drows` staged rows of dout a tile (0:
// read from device memory) and `vec` (y, dout and dyp 16-byte aligned).
template <int NJ>
__global__ void __launch_bounds__(kThreads)
bn_glu_pool_bwd_kernel(const float* __restrict__ y, const float* __restrict__ dout,
                       const float* __restrict__ scale, const float* __restrict__ bias,
                       const float* __restrict__ mean, const float* __restrict__ var,
                       const float* __restrict__ glu_w, const float* __restrict__ glu_b,
                       float* __restrict__ dyp, float* __restrict__ partials, int T, int F,
                       int C, int pt, int pf, float eps, Tile tl, int tiles_per_block,
                       Dropout dr, int buffers, int drows, int vec) {
  bwd_reduce_f32<NJ>(y, dout, scale, bias, mean, var, glu_w, glu_b, dyp, partials, T, F, C, pt, pf, eps, tl,
                     tiles_per_block, dr, buffers, drows, vec != 0);
}

// Dynamic shared memory of the float32 recompute fixup (ops/fused_block.
// fixup_plan computes the same): the y tile [kPix][KS], the dlin tile
// [kPix][KS], the dout tile [drows][KS] (drows = 0: dout is read from device
// memory), W [CP][CP], six vectors [CP], two tables [kPix] (int).
template <int NJ>
size_t fix_f32_smem(int drows) {
  using P = RedPlan<NJ>;
  return sizeof(float) * (2 * kPix * P::KS + (size_t)drows * P::KS + P::CP * P::CP + 6 * P::CP + 2 * kPix);
}

// The float32 recompute fixup (the JAX package's _bwd_fixup_recompute_kernel,
// under DCASE_FUSED_BWD_RECOMPUTE: the reduce pass stored no dy_partial). Per
// tile, the reduce pass's plan and device code without its third product and
// its sums: y and the tile's rows of dout staged by cp.async, y - mean formed
// in place as the plain version forms it (so the epilogue's (y - mean) b2
// loses no digits to a large mean); lin = xn . W with xn = (y - mean) inv
// scale + bias formed from the operand as it is read; the gate term and dlin
// in registers, dlin into shared memory; dxn = gate + dlin . W^T; then dy =
// inv scale dxn - a - (y - mean) b2 in float32, written by float4. a, b2: [C]
// from the folded S1, S2. Without the reduce pass's M tile (64 registers) a
// thread fits in 128 registers, so at C <= 64 two blocks of 8 warps share an
// SM, each with one y buffer (91 KB): one block's loads overlap the other's
// products. A second buffer (the next tile's y loading while one multiplies,
// as in the reduce pass) leaves one block an SM and read 1.1344 ms at block 1
// of the flagship shape against 0.9533 (NVIDIA H100 80GB HBM3, 700.00 W,
// tools/bench_k2b_fixup_torch.py --variants before it was removed).
template <int NJ>
__global__ void __launch_bounds__(kThreads, NJ == 4 ? 2 : 1)
bn_bwd_fixup_recompute_kernel(const float* __restrict__ y, const float* __restrict__ dout,
                              const float* __restrict__ scale, const float* __restrict__ bias,
                              const float* __restrict__ mean, const float* __restrict__ var,
                              const float* __restrict__ glu_w, const float* __restrict__ glu_b,
                              const float* __restrict__ a, const float* __restrict__ b2, float* __restrict__ dy,
                              int B, int T, int F, int C, int pt, int pf, float eps, Tile tl, Dropout dr, int drows,
                              int vec) {
  using P = RedPlan<NJ>;
  constexpr int CP = P::CP, CG = P::CG, MI = P::MI, KS = P::KS;
  constexpr int Q = CP / 4, DP = kThreads / Q;  // centring: chunk tid % Q of every DP-th row
  extern __shared__ __align__(16) float smem_x[];
  float* xb = smem_x;                        // [kPix][KS]: y, then y - mean
  float* ds = xb + kPix * KS;                // [kPix][KS]: dlin
  float* dtile = ds + kPix * KS;             // [drows][KS]: the tile's rows of dout
  float* wsw = dtile + drows * KS;           // [CP][CP]: W (in, out), chunks swizzled
  float* vmean = wsw + CP * CP;              // [CP] each, zeros past C
  float* vgain = vmean + CP;                 // inv * scale
  float* vbias = vgain + CP;
  float* vgb = vbias + CP;
  float* va = vgb + CP;
  float* vb2 = va + CP;
  int* tab_y = reinterpret_cast<int*>(vb2 + CP);  // [kPix]: the global pixel of tile pixel p
  int* tab_d = tab_y + kPix;                      // [kPix]: its row of dout

  const int tid = threadIdx.x;
  const unsigned long long seed = seed_of(dr);
  const int Tp = T / pt, Fp = F / pf;
  const float inv_win = 1.0f / (float)(pt * pf);
  const bool vec4 = vec != 0;

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
  // block k takes tiles [k n / G, (k + 1) n / G) of the n = B * tiles of the
  // batch, clip after clip: one wave of G resident blocks, within one tile of
  // each other
  const int n_tiles = tiles_per_clip(T, F, pt, pf);
  const long long total = (long long)B * n_tiles;
  const int first = (int)(blockIdx.x * total / gridDim.x), last = (int)((blockIdx.x + 1) * total / gridDim.x);
  auto stage = [&](int t) {
    const int bt = t / n_tiles;
    const TilePos tp = tile_pos(t - bt * n_tiles, bt, T, F, tl);
    stage_y_f32<CP>(xb, y, tp, F, C, vec4);
    if (drows > 0) stage_dout_f32<CP>(dtile, dout, tp, bt, Tp, Fp, pt, pf, C, vec4);
    cp_async_commit();
  };

  const int cg = tid % CG, pg = tid / CG, sq = tid % Q;
  if (first < last) stage(first);
  for (int t = first; t < last; ++t) {
    const int b = t / n_tiles;
    const TilePos tp = tile_pos(t - b * n_tiles, b, T, F, tl);
    const int tpix = tp.trows * tp.fcols;
    cp_async_wait_all();
    __syncthreads();  // this tile landed
    {  // y - mean in place (rows past the tile stay as staged, zeros: their dh is 0)
      const float4 m = ld4(vmean + 4 * sq);
      for (int p = tid / Q; p < tpix; p += DP) {
        const float4 u = ld4(xb + p * KS + 4 * sq);
        st4(xb + p * KS + 4 * sq, make_float4(u.x - m.x, u.y - m.y, u.z - m.z, u.w - m.w));
      }
    }
    tile_tables(tab_y, tab_d, tp, tpix, b, F, Tp, Fp, pt, pf, drows);
    __syncthreads();  // y - mean and the tables complete

    float acc[MI][8];
    lin_f32<NJ>(acc, xb, wsw, vgain, vbias, pg, cg);
    gate_f32<NJ>(acc, xb, ds, dtile, dout, tab_y, tab_d, vgain, vbias, vgb, tpix, C, drows, vec4, inv_win, dr, seed,
                 pg, cg, [](int, float) {});
    __syncthreads();  // dlin complete
    dxn_f32<NJ>(acc, ds, wsw, pg, cg);
    // dy = inv * scale * dxn - a - (y - mean) * b2
    dy_f32<NJ>(acc, xb, vgain, va, vb2, tpix, C, pg, cg, [&](int p, int c0, float4 out) {
      float* dst = dy + (long long)tab_y[p] * C + c0;
      if (vec4) {
        st4(dst, out);
      } else {
        dst[0] = out.x;
        dst[1] = out.y;
        dst[2] = out.z;
        dst[3] = out.w;
      }
    });
    if (t + 1 < last) {
      __syncthreads();  // every warp is done with the tiles
      stage(t + 1);
    }
  }
}

// ------------------------------------ bfloat16: products on the tensor cores

// the warps of each kernel (see BfPlan)
template <int CP>
constexpr int kFwdWarps = CP == 128 ? 16 : 8;
template <int CP>
constexpr int kBwdWarps = 16;

// Dynamic shared memory of the bfloat16 forward: two y tiles and the A tile,
// [kPix][RS] bfloat16 each (y0, A, y1: the float32 g tile [kPix][GS]
// overlays the current y tile and A), W [CP][RS] bfloat16, five vectors [CP]
// float; 139 KB at CP = 128.
template <int CP>
size_t fwd_bf16_smem() {
  using P = BfPlan<CP, kFwdWarps<CP>>;
  return 2 * (size_t)P::RS * (3 * (size_t)kPix + CP) + 4 * 5 * (size_t)CP;
}

// Dynamic shared memory of the bfloat16 reduce pass (ops/fused_block.
// bf16_reduce_plan computes the same): per buffer (1 or 2) the
// y tile [kPix][RS] and the tile's rows of dout [drows][RS]; A, D [kPix][RS]
// and W [CP][RS] (bfloat16); six vectors [CP] and the block's db, S1, S2 per
// pixel warp row [3][WM][CP] float (WM CP = 32 NW); the keep-mask [kPix][MS]
// bytes; the dout-row table [kPix] int.
template <int CP>
size_t bwd_bf16_smem(int buffers, int drows) {
  using P = BfPlan<CP, kBwdWarps<CP>>;
  return 2 * (size_t)P::RS * ((size_t)buffers * (kPix + drows) + 2 * kPix + CP) +
         4 * (6 + 3 * (size_t)P::WM) * CP + (size_t)kPix * P::MS + 4 * kPix;
}


// The bfloat16 forward (bn_glu_pool_kernel's function on bfloat16 y, the
// JAX package's _fwd_kernel with lp). Per tile of up to 128 pixels (whole
// pooling windows): y staged by cp.async (the next tile's while this one
// multiplies), A = bf16(xn) formed once, lin = A . W
// on mma.sync; then bf16_tile.cuh's glu_pool_bf16 (shared with K5's
// bfloat16 forward): in the fragment's registers g = (lin + b) * sigmoid(xn)
// with the float32 xn rebuilt from the staged y; g to shared memory in
// float32 over the y tile and A; then per window and four channels the
// keep-mask (keep_values4's draw, on the global element index) and the pool, each
// column's pt-row time sum rounded to bfloat16 before the frequency sum;
// 8-byte stores.
template <int CP, int NW>
__global__ void __launch_bounds__(32 * NW, NW == 8 ? 2 : 1)
bn_glu_pool_bf16_kernel(const bf16* __restrict__ y, const float* __restrict__ scale, const float* __restrict__ bias,
                        const float* __restrict__ mean, const float* __restrict__ var,
                        const float* __restrict__ glu_w, const float* __restrict__ glu_b, bf16* __restrict__ out,
                        int T, int F, int C, int pt, int pf, float eps, Tile tl, int tiles_per_block, Dropout dr,
                        int mode) {
  using P = BfPlan<CP, NW>;
  constexpr int RS = P::RS, MT = P::MT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* tiles = reinterpret_cast<bf16*>(smem_raw);  // [3][kPix][RS]: y0, A, y1
  bf16* A = tiles + kPix * RS;
  bf16* ws = tiles + 3 * kPix * RS;                 // [CP][RS]
  float* vmean = reinterpret_cast<float*>(ws + CP * RS);
  float* vinv = vmean + CP;
  float* vscale = vinv + CP;
  float* vbias = vscale + CP;
  float* vgb = vbias + CP;
  stage_bf16_consts<CP>(ws, vmean, vinv, vscale, vbias, vgb, nullptr, glu_w, scale, bias, mean, var, glu_b, C, eps);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp / P::WN, wn = warp % P::WN;
  const int b = blockIdx.y;
  const unsigned long long seed = seed_of(dr);
  const int Fp = F / pf;
  const float inv_win = 1.0f / (float)(pt * pf);
  const int n_tiles = tiles_per_clip(T, F, pt, pf);
  const int first = blockIdx.x * tiles_per_block;
  const int last = min(n_tiles, first + tiles_per_block);
  auto stage = [&](int tile, int buf) {
    const TilePos tp = tile_pos(tile, b, T, F, tl);
    bf16* yb = tiles + 2 * buf * kPix * RS;
    if (mode == 2) stage_y_rows<CP, 8>(yb, y, tp, tp.trows * tp.fcols, C, mode);
    else stage_y_rows<CP, 4>(yb, y, tp, tp.trows * tp.fcols, C, mode);
  };

  if (first < last) stage(first, 0);
  cp_async_commit();
  for (int tile = first; tile < last; ++tile) {
    const int buf = (tile - first) & 1;
    const TilePos tp = tile_pos(tile, b, T, F, tl);
    const int tpix = tp.trows * tp.fcols;
    cp_async_wait_all();
    __syncthreads();  // this tile landed; every warp is done with the previous tile
    if (tile + 1 < last) {  // the next tile loads while this one multiplies
      stage(tile + 1, buf ^ 1);
      cp_async_commit();
    }
    const bf16* yb = tiles + 2 * buf * kPix * RS;
    form_a<CP>(A, yb, vmean, vinv, vscale, vbias, tpix);
    __syncthreads();  // A complete

    float acc[MT][4][4];
    zero_acc(acc);
    product_w<CP, NW, true>(acc, A, ws, wm, wn, lane);
    // g = (lin + b) * sigmoid(xn) over the y tile and A, then the mask and the pool
    glu_pool_bf16<CP, NW>(acc, yb, reinterpret_cast<float*>(tiles + buf * kPix * RS), vmean, vinv, vscale, vbias,
                          vgb, tp, C, pt, pf, Fp, inv_win, dr, seed, false, out);
  }
}

// The bfloat16 reduce pass (bn_glu_pool_bwd_kernel's function on bfloat16 y,
// the JAX package's _bwd_reduce_kernel with lp). Per tile of up to 128
// pixels: y and the tile's pooled rows of dout staged by cp.async (the next
// tile's while this one multiplies, where two buffers fit); the keep-mask
// bits of the tile (one Philox call per four channels, on the global element
// index); A = bf16(xn); then bf16_tile.cuh's reduce_tile_bf16: lin = A . W on
// mma.sync; in the fragment's registers dh = dout / (pt pf) * mask *
// keep_scale, sig from the float32 xn, the gate term dh (lin + b) sig (1 -
// sig) kept as dxn's first term, dlin = dh sig summed into db in float32 and
// stored as D = bf16(dlin); dxn = gate + D . W^T on mma.sync (W by ldmatrix
// without .trans: lin's and dxn's fragments cover the same pixels and
// channels); S1 += dxn and S2 += dxn * x-hat from the staged y; dy_partial =
// bf16(inv scale dxn) written over the y tile and stored in 16- or 8-byte
// chunks (not at all when dyp == nullptr); dW += A^T . D on mma.sync (A and D
// by ldmatrix.trans), its float32 sums in registers across the block's
// tiles. At the end the block's slot [C*C dW | C db | C S1 | C S2]
// (write_reduce_slot): dW from its fragments; db, S1 and S2 of each tile
// added over the eight g lanes of a warp by shuffles into the block's sums of
// its pixel warp row in shared memory, and at the end over the pixel warps in
// order.
template <int CP, int NW>
__global__ void __launch_bounds__(32 * NW, 1)
bn_glu_pool_bwd_bf16_kernel(const bf16* __restrict__ y, const bf16* __restrict__ dout,
                            const float* __restrict__ scale, const float* __restrict__ bias,
                            const float* __restrict__ mean, const float* __restrict__ var,
                            const float* __restrict__ glu_w, const float* __restrict__ glu_b, bf16* __restrict__ dyp,
                            float* __restrict__ partials, int T, int F, int C, int pt, int pf, float eps, Tile tl,
                            int tiles_per_block, Dropout dr, int buffers, int drows, int mode) {
  using P = BfPlan<CP, NW>;
  constexpr int RS = P::RS, MS = P::MS;
  // lin and dxn over NH passes of kPix / NH pixels each: two at CP = 128
  constexpr int NH = CP == 128 ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ys = reinterpret_cast<bf16*>(smem_raw);  // [buffers][kPix][RS]: y, then dy_partial
  bf16* dsm = ys + buffers * kPix * RS;          // [buffers][drows][RS]: the tile's rows of dout
  BfShared sh;
  sh.A = dsm + buffers * drows * RS;  // [kPix][RS]: bf16(xn)
  sh.D = sh.A + kPix * RS;            // [kPix][RS]: bf16(dlin)
  sh.ws = sh.D + kPix * RS;           // [CP][RS]: W (in, out)
  sh.vmean = reinterpret_cast<float*>(sh.ws + CP * RS);
  sh.vinv = sh.vmean + CP;
  sh.vscale = sh.vinv + CP;
  sh.vbias = sh.vscale + CP;
  sh.vgb = sh.vbias + CP;
  sh.vgain = sh.vgb + CP;
  float* sums = sh.vgain + CP;  // [3][WM][CP]: the block's db, S1, S2 of each pixel warp row
  sh.mbits = reinterpret_cast<unsigned char*>(sums + 3 * P::WM * CP);  // [kPix][MS]: keep bits of 4 channels
  sh.tab_d = reinterpret_cast<int*>(sh.mbits + kPix * MS);            // [kPix]: the dout row of pixel p, or -1
  stage_bf16_consts<CP>(sh.ws, sh.vmean, sh.vinv, sh.vscale, sh.vbias, sh.vgb, sh.vgain, glu_w, scale, bias, mean, var,
                        glu_b, C, eps);
  for (int i = threadIdx.x; i < 3 * P::WM * CP; i += P::NTHR) sums[i] = 0.0f;

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const unsigned long long seed = seed_of(dr);
  const int Tp = T / pt, Fp = F / pf;
  const float inv_win = 1.0f / (float)(pt * pf);
  const int n_tiles = tiles_per_clip(T, F, pt, pf);
  const int first = blockIdx.x * tiles_per_block;
  const int last = min(n_tiles, first + tiles_per_block);
  auto stage = [&](int tile, int buf) {
    const TilePos tp = tile_pos(tile, b, T, F, tl);
    bf16* yb = ys + buf * kPix * RS;
    bf16* db_ = dsm + buf * drows * RS;
    if (mode == 2) {
      stage_y_rows<CP, 8>(yb, y, tp, tp.trows * tp.fcols, C, mode);
      stage_dout_rows<CP, 8>(db_, dout, tp, b, Tp, Fp, pt, pf, C, mode);
    } else {
      stage_y_rows<CP, 4>(yb, y, tp, tp.trows * tp.fcols, C, mode);
      stage_dout_rows<CP, 4>(db_, dout, tp, b, Tp, Fp, pt, pf, C, mode);
    }
  };

  // dW: input channels wmw 16 MTW + 16 mt + g (+ 8) x output channels wnw CP / 4 + 8 nt + 2 q (+ 1)
  float accw[P::MTW][P::NTW][4];
#pragma unroll
  for (int mt = 0; mt < P::MTW; ++mt)
#pragma unroll
    for (int nt = 0; nt < P::NTW; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) accw[mt][nt][e] = 0.0f;

  if (first < last) stage(first, 0);
  cp_async_commit();
  for (int tile = first; tile < last; ++tile) {
    const int buf = buffers == 2 ? (tile - first) & 1 : 0;
    const TilePos tp = tile_pos(tile, b, T, F, tl);
    const int tpix = tp.trows * tp.fcols;
    cp_async_wait_all();
    __syncthreads();  // this tile landed; every warp is done with the previous tile
    if (buffers == 2 && tile + 1 < last) {  // the next tile loads while this one multiplies
      stage(tile + 1, buf ^ 1);
      cp_async_commit();
    }
    bf16* yb = ys + buf * kPix * RS;
    const bf16* dtile = dsm + buf * drows * RS;
    dout_rows_of(sh.tab_d, tp, tpix, pt, pf);
    if (dr.mode != 0) keep_bits<CP>(sh.mbits, tp, tpix, C, seed, dr);
    form_a<CP>(sh.A, yb, sh.vmean, sh.vinv, sh.vscale, sh.vbias, tpix);
    __syncthreads();  // A, the table and the mask complete
    reduce_tile_bf16<CP, NW, NH>(accw, sh, yb, dtile, sums, tpix, inv_win, dr, dyp != nullptr);
    if (dyp != nullptr) {  // the tile's dy_partial, 16 or 8 bytes a store
      __syncthreads();
      const int ch = mode == 2 ? 8 : 4, nq = CP / ch;
      for (int i = tid; i < tpix * nq; i += P::NTHR) {
        const int p = i / nq, k = i % nq;
        if (k * ch >= C) continue;
        bf16* dst = dyp + tp.pixel(p) * C + k * ch;
        const bf16* src = yb + p * RS + k * ch;
        if (mode == 2) *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        else *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
      }
    }
    if (buffers == 1 && tile + 1 < last) {
      __syncthreads();  // every warp is done with the only y and dout tiles
      stage(tile + 1, 0);
      cp_async_commit();
    }
  }

  // the block's slot [C*C dW | C db | C S1 | C S2]
  const int slot = blockIdx.y * gridDim.x + blockIdx.x;
  write_reduce_slot<CP, NW>(partials + (long long)slot * (C * C + 3 * C), accw, sums, C);
}

// the warps of the bfloat16 recompute fixup: 16 at CP = 128 (one block an SM),
// 8 at CP = 64 (two blocks an SM in 128 registers a thread)
template <int CP>
constexpr int kFixWarps = CP == 128 ? 16 : 8;

// Dynamic shared memory of the bfloat16 recompute fixup (ops/fused_block.
// fixup_plan computes the same): per buffer (1 or 2) the y tile [kPix][RS]
// (then dy) and the tile's pooled rows of dout [drows][RS]; A, D [kPix][RS]
// and W [CP][RS] (bfloat16); eight vectors [CP] float; the keep bits
// [kPix][MS] bytes; the dout-row table [kPix] int. 188 KB at CP = 128 and
// pool (2, 4) with two buffers, 91 KB at CP = 64.
template <int CP>
size_t fix_bf16_smem(int buffers, int drows) {
  using P = BfPlan<CP, kFixWarps<CP>>;
  return 2 * (size_t)P::RS * ((size_t)buffers * (kPix + drows) + 2 * kPix + CP) + 4 * 8 * (size_t)CP +
         (size_t)kPix * P::MS + 4 * kPix;
}

// The bfloat16 recompute fixup (bn_bwd_fixup_recompute_kernel's function on
// bfloat16 y, the JAX package's _bwd_fixup_recompute_kernel with lp). Per
// tile, the bfloat16 reduce pass's plan and device code without its dW
// product and its sums: y and the tile's pooled rows of dout staged by
// cp.async (the next tile's while this one multiplies), the tile's keep bits
// (one Philox call per four channels), A = bf16(xn), lin = A . W on
// mma.sync; in the fragments' registers dh, sig from the float32 xn, the gate
// term and dlin = dh sig, stored as D = bf16(dlin); dxn = gate + D . W^T on
// mma.sync; then dy = inv scale dxn - a - (y - mean) b2 in float32 from the
// staged y, rounded once to bfloat16, written over the y tile and stored in
// 16- or 8-byte chunks (bf16_tile.cuh's dxn_bf16). Without dW's
// accumulators a warp takes its MT fragments of the whole tile in one pass
// (the reduce pass needs two at CP = 128).
template <int CP, int NW>
__global__ void __launch_bounds__(32 * NW, NW == 8 ? 2 : 1)
bn_bwd_fixup_recompute_bf16_kernel(const bf16* __restrict__ y, const bf16* __restrict__ dout,
                                   const float* __restrict__ scale, const float* __restrict__ bias,
                                   const float* __restrict__ mean, const float* __restrict__ var,
                                   const float* __restrict__ glu_w, const float* __restrict__ glu_b,
                                   const float* __restrict__ a, const float* __restrict__ b2, bf16* __restrict__ dy,
                                   int B, int T, int F, int C, int pt, int pf, float eps, Tile tl, Dropout dr,
                                   int buffers, int drows, int mode) {
  using P = BfPlan<CP, NW>;
  constexpr int RS = P::RS, MS = P::MS, MT = P::MT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ys = reinterpret_cast<bf16*>(smem_raw);  // [buffers][kPix][RS]: y, then dy
  bf16* dsm = ys + buffers * kPix * RS;          // [buffers][drows][RS]: the tile's rows of dout
  BfShared sh;
  sh.A = dsm + buffers * drows * RS;  // [kPix][RS]: bf16(xn)
  sh.D = sh.A + kPix * RS;            // [kPix][RS]: bf16(dlin)
  sh.ws = sh.D + kPix * RS;           // [CP][RS]: W (in, out)
  sh.vmean = reinterpret_cast<float*>(sh.ws + CP * RS);
  sh.vinv = sh.vmean + CP;
  sh.vscale = sh.vinv + CP;
  sh.vbias = sh.vscale + CP;
  sh.vgb = sh.vbias + CP;
  sh.vgain = sh.vgb + CP;
  float* va = sh.vgain + CP;
  float* vb2 = va + CP;
  sh.mbits = reinterpret_cast<unsigned char*>(vb2 + CP);  // [kPix][MS]: keep bits of 4 channels
  sh.tab_d = reinterpret_cast<int*>(sh.mbits + kPix * MS);  // [kPix]: the dout row of pixel p, or -1
  stage_bf16_consts<CP>(sh.ws, sh.vmean, sh.vinv, sh.vscale, sh.vbias, sh.vgb, sh.vgain, glu_w, scale, bias, mean, var,
                        glu_b, C, eps);
  for (int c = threadIdx.x; c < CP; c += P::NTHR) {
    va[c] = c < C ? a[c] : 0.0f;
    vb2[c] = c < C ? b2[c] : 0.0f;
  }

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / P::WN, wn = warp % P::WN, g = lane / 4, q = lane % 4;
  const unsigned long long seed = seed_of(dr);
  const int Tp = T / pt, Fp = F / pf;
  const float inv_win = 1.0f / (float)(pt * pf);
  // block k takes tiles [k n / G, (k + 1) n / G) of the n = B * tiles of the batch
  const int n_tiles = tiles_per_clip(T, F, pt, pf);
  const long long total = (long long)B * n_tiles;
  const int first = (int)(blockIdx.x * total / gridDim.x), last = (int)((blockIdx.x + 1) * total / gridDim.x);
  auto stage = [&](int t, int buf) {
    const int bt = t / n_tiles;
    const TilePos tp = tile_pos(t - bt * n_tiles, bt, T, F, tl);
    bf16* yb = ys + buf * kPix * RS;
    bf16* db_ = dsm + buf * drows * RS;
    if (mode == 2) {
      stage_y_rows<CP, 8>(yb, y, tp, tp.trows * tp.fcols, C, mode);
      stage_dout_rows<CP, 8>(db_, dout, tp, bt, Tp, Fp, pt, pf, C, mode);
    } else {
      stage_y_rows<CP, 4>(yb, y, tp, tp.trows * tp.fcols, C, mode);
      stage_dout_rows<CP, 4>(db_, dout, tp, bt, Tp, Fp, pt, pf, C, mode);
    }
  };

  if (first < last) stage(first, 0);
  cp_async_commit();
  for (int t = first; t < last; ++t) {
    const int buf = buffers == 2 ? (t - first) & 1 : 0;
    const int b = t / n_tiles;
    const TilePos tp = tile_pos(t - b * n_tiles, b, T, F, tl);
    const int tpix = tp.trows * tp.fcols;
    cp_async_wait_all();
    __syncthreads();  // this tile landed; every warp is done with the previous tile
    if (buffers == 2 && t + 1 < last) {  // the next tile loads while this one multiplies
      stage(t + 1, buf ^ 1);
      cp_async_commit();
    }
    bf16* yb = ys + buf * kPix * RS;
    const bf16* dtile = dsm + buf * drows * RS;
    dout_rows_of(sh.tab_d, tp, tpix, pt, pf);
    if (dr.mode != 0) keep_bits<CP>(sh.mbits, tp, tpix, C, seed, dr);
    form_a<CP>(sh.A, yb, sh.vmean, sh.vinv, sh.vscale, sh.vbias, tpix);
    __syncthreads();  // A, the table and the mask complete

    float acc[MT][4][4];
    dxn_bf16<CP, NW, MT>(acc, sh, yb, dtile, 0, inv_win, dr, [](float, float, int) {});
    // dy = inv * scale * dxn - a - (y - mean) * b2, rounded once, over the y tile
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int c = wn * 32 + nt * 8 + 2 * q;
      const float2 m = ld2(sh.vmean + c), gn = ld2(sh.vgain + c), av = ld2(va + c), bv = ld2(vb2 + c);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = wm * 16 * MT + mt * 16 + g + 8 * h;
          const float2 yv = ld_bf2(yb + p * RS + c);
          st_bf2(yb + p * RS + c, gn.x * acc[mt][nt][2 * h] - av.x - (yv.x - m.x) * bv.x,
                 gn.y * acc[mt][nt][2 * h + 1] - av.y - (yv.y - m.y) * bv.y);
        }
    }
    __syncthreads();  // the tile's dy complete
    {  // 16 or 8 bytes a store (mode 0: y, dout or dy not 8-byte aligned, two bytes a store)
      const int ch = mode == 2 ? 8 : 4, nq = CP / ch;
      for (int i = tid; i < tpix * nq; i += P::NTHR) {
        const int p = i / nq, k = i % nq;
        if (k * ch >= C) continue;
        bf16* dst = dy + tp.pixel(p) * C + k * ch;
        const bf16* src = yb + p * RS + k * ch;
        if (mode == 2) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else if (mode == 1) {
          *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) dst[e] = src[e];
        }
      }
    }
    if (buffers == 1 && t + 1 < last) {
      __syncthreads();  // every warp is done with the only y and dout tiles
      stage(t + 1, 0);
      cp_async_commit();
    }
  }
}

// dy = dy_partial - a - (y - mean) * b, in place over dy_partial (C % 4 == 0).
template <typename TY>
__global__ void __launch_bounds__(kThreads)
bn_bwd_fixup_kernel(const TY* __restrict__ y, TY* dyp, const float* __restrict__ a,
                    const float* __restrict__ b, const float* __restrict__ mean,
                    long long n4, int C) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n4; i += stride) {
    const int c = (int)((i * 4) % C);
    const float4 yv = Vec4<TY>::load(y + 4 * i);
    float4 d = Vec4<TY>::load(dyp + 4 * i);
    d.x = d.x - a[c] - (yv.x - mean[c]) * b[c];
    d.y = d.y - a[c + 1] - (yv.y - mean[c + 1]) * b[c + 1];
    d.z = d.z - a[c + 2] - (yv.z - mean[c + 2]) * b[c + 2];
    d.w = d.w - a[c + 3] - (yv.w - mean[c + 3]) * b[c + 3];
    Vec4<TY>::store(dyp + 4 * i, d);
  }
}

// --------------------------------------------------------------- statistics

// Block `blockIdx.x` sums rows [r0, r1) of y [rows, C] per channel in double
// and writes [C sums | C sums of squares] to its slot. A thread owns four
// neighbouring channels of every (kThreads / (C / 4))-th row (C % 4 == 0).
// float32 y; bfloat16 y goes to stats_bf16_kernel below.
template <typename TY>
__global__ void __launch_bounds__(kThreads)
stats_kernel(const TY* __restrict__ y, double* __restrict__ partials, long long rows,
             int C, long long rows_per_block) {
  extern __shared__ double dred[];  // [groups][2 * C]
  const int lanes = C / 4;
  const int groups = kThreads / lanes;  // row groups in flight (>= 1: C <= 1024)
  const int lane = threadIdx.x % lanes, grp = threadIdx.x / lanes;
  const long long r0 = blockIdx.x * rows_per_block;
  const long long r1 = min(rows, r0 + rows_per_block);
  double s[4] = {0.0, 0.0, 0.0, 0.0}, q[4] = {0.0, 0.0, 0.0, 0.0};
  if (grp < groups) {
    for (long long r = r0 + grp; r < r1; r += groups) {
      const float4 v = Vec4<TY>::load(y + (r * lanes + lane) * 4);
      s[0] += v.x; q[0] += (double)v.x * v.x;
      s[1] += v.y; q[1] += (double)v.y * v.y;
      s[2] += v.z; q[2] += (double)v.z * v.z;
      s[3] += v.w; q[3] += (double)v.w * v.w;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      dred[grp * 2 * C + lane * 4 + k] = s[k];
      dred[grp * 2 * C + C + lane * 4 + k] = q[k];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * C; i += kThreads) {
    double t = 0.0;
    for (int g = 0; g < groups; ++g) t += dred[g * 2 * C + i];
    partials[(long long)blockIdx.x * 2 * C + i] = t;
  }
}

// The same function on bfloat16 y as a streaming reduction, bound by reading
// y (3 flops an element against 2 bytes: 170 MB, 0.05 ms at 3.35 TB/s at the
// flagship's block 1). Launch plan (ops/fused_block.stats_bf16_plan): one
// wave of at most the resident blocks, block k of G taking rows [k rows / G,
// (k + 1) rows / G), and no more blocks than give each thread kStatsUnroll
// rows. A thread owns V neighbouring channels (V = 8: one 16-byte load a row,
// C % 8 == 0 and y 16-byte aligned; else V = 4, 8 bytes) of every
// (kStatsThreads / (C / V))-th row of its block's run, in batches of
// kStatsUnroll rows: it issues the loads of the next batch before it adds the
// current one, so a batch is always in flight. It sums y and y^2 in float32 (y^2
// of a bfloat16 value is exact, one FMA rounding) over runs of kStatsRun of
// its rows and adds each run into its float64 sums in shared memory once: no
// float64 per element. Sum y carries the exact rounding error of each float32
// add (TwoSum, six FADDs; their float32 sum e, added into float64 with s), as
// each channel is held within 1e-6 relative of float64 sums of y: where a
// channel's sum y nearly cancels (0.415 over 1.3 M standard-normal values at
// the flagship's block 1), plain float32 runs missed it by 2.1e-6, 5e-6
// relative, on an NVIDIA H100 80GB HBM3, and Kahan's compensation still by
// about 7e-7 in a numpy emulation of this order; with TwoSum the emulation
// is exact. Sum y^2 adds no cancellation, and the bound on the run keeps its
// float32 partials within a few ulp. At the end the block adds its threads'
// float64 sums in a fixed order into its slot [2C], which fold_warps_kernel
// adds in a fixed order: a run repeats bit for bit. Two batches of 8 rows in
// registers (128 a thread at V = 8, no spill) and two blocks an SM: 0.0654 ms
// at the flagship's block 1, 78 % of the bound, on an NVIDIA H100 80GB HBM3
// (700 W), where batches of 4 rows with registers capped for three blocks an
// SM spilled and read 0.0710, and one batch of 4 rows in flight at a time
// 0.1007 (tools/bench_k2_bf16_torch.py --stats, PERF.md).
constexpr int kStatsThreads = 256;  // threads of a block
constexpr int kStatsBlocks = 2;     // blocks an SM at least (registers capped for it)
constexpr int kStatsUnroll = 8;     // rows of a batch: loaded together, in flight while the previous batch adds
constexpr int kStatsRun = 64;       // rows a thread sums in float32 before it adds them into float64
static_assert(kStatsRun % kStatsUnroll == 0, "a run is whole batches of loads");

template <int V>
struct StatsRow;  // V bfloat16 of one row, as loaded
template <>
struct StatsRow<8> {
  uint4 u;
  __device__ __forceinline__ void load(const bf16* p) { u = *reinterpret_cast<const uint4*>(p); }
  __device__ __forceinline__ void zero() { u = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ uint32_t word(int i) const { return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w; }
};
template <>
struct StatsRow<4> {
  uint2 u;
  __device__ __forceinline__ void load(const bf16* p) { u = *reinterpret_cast<const uint2*>(p); }
  __device__ __forceinline__ void zero() { u = make_uint2(0u, 0u); }
  __device__ __forceinline__ uint32_t word(int i) const { return i == 0 ? u.x : u.y; }
};

template <int V>
__global__ void __launch_bounds__(kStatsThreads, kStatsBlocks)
stats_bf16_kernel(const bf16* __restrict__ y, double* __restrict__ partials, long long rows, int C) {
  __shared__ double dsum[2 * V][kStatsThreads];  // per thread: its float64 sums of y, then of y^2
  const int tid = threadIdx.x;
  const int lanes = C / V, groups = kStatsThreads / lanes;  // groups >= 1: C <= 1024
  const int lane = tid % lanes, grp = tid / lanes;
  const long long r1 = (blockIdx.x + 1) * rows / gridDim.x;
  long long r = blockIdx.x * rows / gridDim.x + grp;
  const long long step = (long long)groups * kStatsUnroll;
  const bf16* yl = y + (long long)lane * V;
#pragma unroll
  for (int k = 0; k < 2 * V; ++k) dsum[k][tid] = 0.0;
  auto load = [&](StatsRow<V> (&v)[kStatsUnroll], long long r0) {  // rows past the run's end add zeros
#pragma unroll
    for (int u = 0; u < kStatsUnroll; ++u) {
      const long long ru = r0 + (long long)u * groups;
      if (ru < r1) v[u].load(yl + ru * C);
      else v[u].zero();
    }
  };
  if (grp < groups) {
    float s[V], e[V], q[V];  // e: the rounding errors of the float32 sum s so far (TwoSum), exact each
#pragma unroll
    for (int k = 0; k < V; ++k) s[k] = e[k] = q[k] = 0.0f;
    StatsRow<V> cur[kStatsUnroll], nxt[kStatsUnroll];
    load(cur, r);
    for (int n = 1; r < r1; ++n) {
      load(nxt, r + step);  // in flight while this batch adds
#pragma unroll
      for (int u = 0; u < kStatsUnroll; ++u)
#pragma unroll
        for (int i = 0; i < V / 2; ++i) {
          const uint32_t w = cur[u].word(i);
          const float pair[2] = {__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u)};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k = 2 * i + h;
            const float x = pair[h], t = s[k] + x, xb = t - s[k];
            e[k] += (s[k] - (t - xb)) + (x - xb);
            s[k] = t;
            q[k] = fmaf(x, x, q[k]);
          }
        }
#pragma unroll
      for (int u = 0; u < kStatsUnroll; ++u) cur[u] = nxt[u];
      r += step;
      if (n == kStatsRun / kStatsUnroll || r >= r1) {  // the run into the thread's float64 sums
#pragma unroll
        for (int k = 0; k < V; ++k) {
          dsum[k][tid] += (double)s[k] + (double)e[k];
          dsum[V + k][tid] += (double)q[k];
          s[k] = e[k] = q[k] = 0.0f;
        }
        n = 0;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < 2 * C; i += kStatsThreads) {  // the block's slot: its threads' sums in group order
    const int sq = i / C, c = i % C, l = c / V, k = c % V;
    double t = 0.0;
    for (int g = 0; g < groups; ++g) t += dsum[sq * V + k][g * lanes + l];
    partials[(long long)blockIdx.x * 2 * C + i] = t;
  }
}

// Channels a thread of stats_bf16_kernel owns: 8 where C % 8 == 0 and y is
// 16-byte aligned, else 4 (y 8-byte aligned; 0: not taken).
int stats_bf16_vec(const void* y, int C) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(y);
  if (C % 8 == 0 && a % 16 == 0) return 8;
  return C % 4 == 0 && a % 8 == 0 ? 4 : 0;
}

// Arguments shared by the forward and both backward passes.
struct BlockArgs {
  const void* y;
  const float *scale, *bias, *mean, *var, *glu_w, *glu_b;
  int B, T, F, C, pt, pf;
  float eps;
  int tiles_per_block;
  Dropout dr;
};

dim3 block_grid(const BlockArgs& a) {
  const int n_tiles = tiles_per_clip(a.T, a.F, a.pt, a.pf);
  return dim3((n_tiles + a.tiles_per_block - 1) / a.tiles_per_block, a.B);
}

bool aligned(const void* p, int bytes) { return (reinterpret_cast<uintptr_t>(p) % bytes) == 0; }
bool aligned16(const void* p) { return aligned(p, 16); }

// The float32 forward's shared memory set; its blocks an SM into *resident
// where that is not null (registers and shared memory).
template <int NJ>
cudaError_t fwd_f32_attrs(int* resident) {
  constexpr size_t smem = fwd_f32_smem<NJ>();
  cudaError_t err = cudaFuncSetAttribute(bn_glu_pool_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess || resident == nullptr) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, bn_glu_pool_kernel<NJ>, FwdPlan<NJ>::NT, smem);
}

template <int NJ>
int launch_fwd(const BlockArgs& a, void* out, cudaStream_t stream) {
  const cudaError_t err = fwd_f32_attrs<NJ>(nullptr);
  if (err != cudaSuccess) return (int)err;
  bn_glu_pool_kernel<NJ><<<block_grid(a), FwdPlan<NJ>::NT, fwd_f32_smem<NJ>(), stream>>>(
      static_cast<const float*>(a.y), a.scale, a.bias, a.mean, a.var, a.glu_w, a.glu_b, static_cast<float*>(out),
      a.T, a.F, a.C, a.pt, a.pf, a.eps, tile_of(a.F, a.pt, a.pf), a.tiles_per_block, a.dr,
      (int)(aligned16(a.y) && aligned16(out)));
  return (int)cudaGetLastError();
}

// How the bfloat16 kernels copy rows of C channels: 2, 16-byte cp.async (C % 8
// == 0, every pointer 16-byte aligned); 1, 8-byte cp.async (8-byte aligned);
// 0, loads of the values.
int bf16_mode(int C, const void* y, const void* dout, const void* dyp) {
  auto all = [&](int bytes) {
    return aligned(y, bytes) && (dout == nullptr || aligned(dout, bytes)) && (dyp == nullptr || aligned(dyp, bytes));
  };
  return C % 8 == 0 && all(16) ? 2 : all(8) ? 1 : 0;
}

template <int CP>
int launch_fwd_bf16(const BlockArgs& a, void* out, cudaStream_t stream) {
  constexpr int NW = kFwdWarps<CP>;
  const size_t smem = fwd_bf16_smem<CP>();
  cudaError_t err = cudaFuncSetAttribute(bn_glu_pool_bf16_kernel<CP, NW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  bn_glu_pool_bf16_kernel<CP, NW><<<block_grid(a), 32 * NW, smem, stream>>>(
      static_cast<const bf16*>(a.y), a.scale, a.bias, a.mean, a.var, a.glu_w, a.glu_b, static_cast<bf16*>(out),
      a.T, a.F, a.C, a.pt, a.pf, a.eps, tile_of(a.F, a.pt, a.pf), a.tiles_per_block, a.dr,
      bf16_mode(a.C, a.y, nullptr, out));
  return (int)cudaGetLastError();
}

template <int NJ>
int launch_bwd(const BlockArgs& a, const void* dout, void* dyp, float* partials, float* sums, int buffers,
               int drows, cudaStream_t stream) {
  if ((buffers != 1 && buffers != 2) || drows < 0 || drows * a.pt * a.pf > kPix) return (int)cudaErrorInvalidValue;
  const size_t smem = red_f32_smem<NJ>(buffers, drows);
  cudaError_t err = cudaFuncSetAttribute(bn_glu_pool_bwd_kernel<NJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = block_grid(a);
  const bool vec = aligned16(a.y) && aligned16(dout) && (dyp == nullptr || aligned16(dyp));
  bn_glu_pool_bwd_kernel<NJ><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(a.y), static_cast<const float*>(dout), a.scale, a.bias, a.mean, a.var,
      a.glu_w, a.glu_b, static_cast<float*>(dyp), partials, a.T, a.F, a.C, a.pt, a.pf, a.eps,
      tile_of(a.F, a.pt, a.pf), a.tiles_per_block, a.dr, buffers, drows, (int)vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_fold<float>(partials, sums, (int)(grid.x * grid.y), a.C * a.C + 3 * a.C, stream);
}

// drows: the pooled rows of a tile, kPix / (pt * pf)
template <int CP>
int launch_bwd_bf16(const BlockArgs& a, const void* dout, void* dyp, float* partials, float* sums, int buffers,
                    int drows, cudaStream_t stream) {
  if ((buffers != 1 && buffers != 2) || drows != kPix / (a.pt * a.pf)) return (int)cudaErrorInvalidValue;
  constexpr int NW = kBwdWarps<CP>;
  const size_t smem = bwd_bf16_smem<CP>(buffers, drows);
  cudaError_t err = cudaFuncSetAttribute(bn_glu_pool_bwd_bf16_kernel<CP, NW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = block_grid(a);
  bn_glu_pool_bwd_bf16_kernel<CP, NW><<<grid, 32 * NW, smem, stream>>>(
      static_cast<const bf16*>(a.y), static_cast<const bf16*>(dout), a.scale, a.bias, a.mean, a.var, a.glu_w,
      a.glu_b, static_cast<bf16*>(dyp), partials, a.T, a.F, a.C, a.pt, a.pf, a.eps, tile_of(a.F, a.pt, a.pf),
      a.tiles_per_block, a.dr, buffers, drows, bf16_mode(a.C, a.y, dout, dyp));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_fold<float>(partials, sums, (int)(grid.x * grid.y), a.C * a.C + 3 * a.C, stream);
}

// The recompute fixups' shared memory set; their blocks an SM into *resident
// where that is not null (registers and shared memory).
template <int NJ>
cudaError_t fix_f32_attrs(int drows, int* resident) {
  const size_t smem = fix_f32_smem<NJ>(drows);
  cudaError_t err = cudaFuncSetAttribute(bn_bwd_fixup_recompute_kernel<NJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess || resident == nullptr) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, bn_bwd_fixup_recompute_kernel<NJ>, kThreads, smem);
}

template <int CP>
cudaError_t fix_bf16_attrs(int buffers, int drows, int* resident) {
  constexpr int NW = kFixWarps<CP>;
  const size_t smem = fix_bf16_smem<CP>(buffers, drows);
  cudaError_t err = cudaFuncSetAttribute(bn_bwd_fixup_recompute_bf16_kernel<CP, NW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess || resident == nullptr) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, bn_bwd_fixup_recompute_bf16_kernel<CP, NW>,
                                                       32 * NW, smem);
}

// buffers, drows: one or two buffers of drows = kPix / (pt pf) rows in
// bfloat16; one buffer of those rows or none (dout read from device memory)
// in float32
bool fixup_plan_ok(int buffers, int drows, int pt, int pf, bool bf16) {
  if (bf16) return (buffers == 1 || buffers == 2) && drows == kPix / (pt * pf);
  return buffers == 1 && (drows == 0 || drows == kPix / (pt * pf));
}

// blocks: the grid, one dimension; each block a run of the batch's tiles
template <int NJ>
int launch_fixup_f32(const BlockArgs& g, const void* dout, const float* av, const float* b2, void* dy, int blocks,
                     int buffers, int drows, cudaStream_t stream) {
  if (!fixup_plan_ok(buffers, drows, g.pt, g.pf, false)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = fix_f32_attrs<NJ>(drows, nullptr);
  if (err != cudaSuccess) return (int)err;
  const bool vec = aligned16(g.y) && aligned16(dout) && aligned16(dy);
  bn_bwd_fixup_recompute_kernel<NJ><<<blocks, kThreads, fix_f32_smem<NJ>(drows), stream>>>(
      static_cast<const float*>(g.y), static_cast<const float*>(dout), g.scale, g.bias, g.mean, g.var, g.glu_w,
      g.glu_b, av, b2, static_cast<float*>(dy), g.B, g.T, g.F, g.C, g.pt, g.pf, g.eps, tile_of(g.F, g.pt, g.pf),
      g.dr, drows, (int)vec);
  return (int)cudaGetLastError();
}

template <int CP>
int launch_fixup_bf16(const BlockArgs& g, const void* dout, const float* av, const float* b2, void* dy, int blocks,
                      int buffers, int drows, cudaStream_t stream) {
  if (!fixup_plan_ok(buffers, drows, g.pt, g.pf, true)) return (int)cudaErrorInvalidValue;
  constexpr int NW = kFixWarps<CP>;
  const cudaError_t err = fix_bf16_attrs<CP>(buffers, drows, nullptr);
  if (err != cudaSuccess) return (int)err;
  bn_bwd_fixup_recompute_bf16_kernel<CP, NW><<<blocks, 32 * NW, fix_bf16_smem<CP>(buffers, drows), stream>>>(
      static_cast<const bf16*>(g.y), static_cast<const bf16*>(dout), g.scale, g.bias, g.mean, g.var, g.glu_w,
      g.glu_b, av, b2, static_cast<bf16*>(dy), g.B, g.T, g.F, g.C, g.pt, g.pf, g.eps, tile_of(g.F, g.pt, g.pf),
      g.dr, buffers, drows, bf16_mode(g.C, g.y, dout, dy));
  return (int)cudaGetLastError();
}

template <typename TY>
int launch_stats(const void* y, void* partials, void* out, long long rows, int C, int blocks,
                 cudaStream_t st) {
  const int groups = kThreads / (C / 4);
  const size_t smem = sizeof(double) * (size_t)groups * 2 * C;
  cudaError_t err = cudaFuncSetAttribute(
      stats_kernel<TY>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long rows_per_block = (rows + blocks - 1) / blocks;
  stats_kernel<TY><<<blocks, kThreads, smem, st>>>(static_cast<const TY*>(y),
                                                   static_cast<double*>(partials), rows, C,
                                                   rows_per_block);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_fold<double>(static_cast<const double*>(partials),
                                  static_cast<float*>(out), blocks, 2 * C, st);
}

// blocks: the grid (one slot each), ops/fused_block.stats_bf16_plan
int launch_stats_bf16(const void* y, void* partials, void* out, long long rows, int C, int blocks,
                      cudaStream_t st) {
  const int vec = stats_bf16_vec(y, C);
  if (vec == 0 || blocks < 1 || C > 1024) return (int)cudaErrorInvalidValue;
  auto* yb = static_cast<const bf16*>(y);
  auto* pa = static_cast<double*>(partials);
  if (vec == 8)
    stats_bf16_kernel<8><<<blocks, kStatsThreads, 0, st>>>(yb, pa, rows, C);
  else
    stats_bf16_kernel<4><<<blocks, kStatsThreads, 0, st>>>(yb, pa, rows, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_fold_warps<double>(pa, static_cast<float*>(out), blocks, 2 * C, st);
}

template <typename TY>
int launch_fixup(const void* y, void* dyp, const void* a, const void* b, const void* mean,
                 long long n, int C, cudaStream_t st) {
  const long long n4 = n / 4;
  long long blocks = (n4 + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond 16 blocks per SM
  if (blocks < 1) blocks = 1;
  bn_bwd_fixup_kernel<TY><<<(int)blocks, kThreads, 0, st>>>(
      static_cast<const TY*>(y), static_cast<TY*>(dyp), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const float*>(mean), n4, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Pixel tiles per clip of the fused-block kernels (the wrapper sizes
// tiles_per_block from it), and of the entry-block kernels (entry_block.cu),
// which tile whole pooling rows: their gates keep pt * F <= 128, where the
// two tilings are one.
int dcase_bn_glu_pool_tiles(int T, int F, int pt, int pf) { return tiles_per_clip(T, F, pt, pf); }

// Blocks of the float32 forward that one SM of the current device holds at
// C channels (0 on an error); the wrapper sizes its grid from it.
int dcase_bn_glu_pool_resident(int C) {
  int resident = 0;
  const cudaError_t err = C <= 64 ? fwd_f32_attrs<4>(&resident) : fwd_f32_attrs<8>(&resident);
  return err == cudaSuccess ? resident : 0;
}

// y: [B, T, F, C]; scale, bias, mean, var, glu_b: [C]; glu_w: [C, C] (in,
// out); out: [B, T/pt, F/pf, C]; contiguous; y and out float32, or
// bfloat16 when bf16 != 0, the rest float32. T % pt == 0, F % pf == 0,
// pt * pf <= 128, C <= 128, C % 4 == 0 (ops/fused_block.py:applicable).
// seed: one int64 in device memory. packed == 0: threshold 0 means no
// dropout, else keep iff the element's 32 random bits >= threshold; packed
// != 0: dropout on, keep iff its 8 random bits >= threshold (chain.cuh). The
// kept are scaled by keep_scale.
int dcase_bn_glu_pool(const void* y, const void* scale, const void* bias, const void* mean,
                      const void* var, const void* glu_w, const void* glu_b, void* out,
                      int B, int T, int F, int C, int pt, int pf, float eps,
                      const void* seed, unsigned int threshold, float keep_scale, int packed,
                      int tiles_per_block, int bf16, void* stream) {
  const BlockArgs a{y, static_cast<const float*>(scale), static_cast<const float*>(bias),
                    static_cast<const float*>(mean), static_cast<const float*>(var),
                    static_cast<const float*>(glu_w), static_cast<const float*>(glu_b),
                    B, T, F, C, pt, pf, eps, tiles_per_block,
                    dropout_of(seed, threshold, keep_scale, packed)};
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return C <= 64 ? launch_fwd_bf16<64>(a, out, st) : launch_fwd_bf16<128>(a, out, st);
  return C <= 64 ? launch_fwd<4>(a, out, st) : launch_fwd<8>(a, out, st);
}

// First backward pass. dout: [B, T/pt, F/pf, C]; dyp: [B, T, F, C] (both in
// y's dtype), or null for no dy_partial (the recompute fixup follows);
// partials: [slots, C*C + 3C] float32 with slots = B * ceil(tiles /
// tiles_per_block); sums: [C*C + 3C] float32 = dW | db | S1 | S2, folded
// from the slots in slot order. Dropout as in dcase_bn_glu_pool. buffers,
// drows: the tiles of y and of dout in shared memory, 2 where they fit, else
// 1, and the rows of dout a tile stages, 128 / (pt * pf), or in float32 0 to
// read dout from device memory (ops/fused_block.reduce_plan,
// bf16_reduce_plan).
int dcase_bn_glu_pool_bwd(const void* y, const void* dout, const void* scale,
                          const void* bias, const void* mean, const void* var,
                          const void* glu_w, const void* glu_b, void* dyp, void* partials,
                          void* sums, int B, int T, int F, int C, int pt, int pf, float eps,
                          const void* seed, unsigned int threshold, float keep_scale, int packed,
                          int tiles_per_block, int bf16, int buffers, int drows, void* stream) {
  const BlockArgs a{y, static_cast<const float*>(scale), static_cast<const float*>(bias),
                    static_cast<const float*>(mean), static_cast<const float*>(var),
                    static_cast<const float*>(glu_w), static_cast<const float*>(glu_b),
                    B, T, F, C, pt, pf, eps, tiles_per_block,
                    dropout_of(seed, threshold, keep_scale, packed)};
  auto* pa = static_cast<float*>(partials);
  auto* su = static_cast<float*>(sums);
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return C <= 64 ? launch_bwd_bf16<64>(a, dout, dyp, pa, su, buffers, drows, st)
                   : launch_bwd_bf16<128>(a, dout, dyp, pa, su, buffers, drows, st);
  return C <= 64 ? launch_bwd<4>(a, dout, dyp, pa, su, buffers, drows, st)
                 : launch_bwd<8>(a, dout, dyp, pa, su, buffers, drows, st);
}

// Blocks of a recompute fixup that one SM of the current device holds at C
// channels, bf16 and (buffers, drows) (0 on an error); the wrapper sizes its
// grid from it.
int dcase_bn_bwd_fixup_recompute_resident(int C, int bf16, int buffers, int drows) {
  int resident = 0;
  cudaError_t err;
  if (bf16)
    err = C <= 64 ? fix_bf16_attrs<64>(buffers, drows, &resident) : fix_bf16_attrs<128>(buffers, drows, &resident);
  else
    err = C <= 64 ? fix_f32_attrs<4>(drows, &resident) : fix_f32_attrs<8>(drows, &resident);
  return err == cudaSuccess ? resident : 0;
}

// Second backward pass without dy_partial: dy [B, T, F, C] in y's dtype from
// y, dout and a, b2 [C] (float32, from the folded S1, S2); the other
// arguments as in dcase_bn_glu_pool_bwd, with the same dropout (the mask is
// regenerated bit for bit); blocks: the grid (1 to B * tiles), each block a
// run of the batch's tiles; buffers, drows: the tiles of y and of dout in
// shared memory (ops/fused_block.fixup_plan).
int dcase_bn_bwd_fixup_recompute(const void* y, const void* dout, const void* scale,
                                 const void* bias, const void* mean, const void* var,
                                 const void* glu_w, const void* glu_b, const void* a,
                                 const void* b2, void* dy, int B, int T, int F, int C, int pt,
                                 int pf, float eps, const void* seed, unsigned int threshold,
                                 float keep_scale, int packed, int blocks, int bf16,
                                 int buffers, int drows, void* stream) {
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  const BlockArgs g{y, static_cast<const float*>(scale), static_cast<const float*>(bias),
                    static_cast<const float*>(mean), static_cast<const float*>(var),
                    static_cast<const float*>(glu_w), static_cast<const float*>(glu_b),
                    B, T, F, C, pt, pf, eps, 0,
                    dropout_of(seed, threshold, keep_scale, packed)};
  const auto* av = static_cast<const float*>(a);
  const auto* bv = static_cast<const float*>(b2);
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return C <= 64 ? launch_fixup_bf16<64>(g, dout, av, bv, dy, blocks, buffers, drows, st)
                   : launch_fixup_bf16<128>(g, dout, av, bv, dy, blocks, buffers, drows, st);
  return C <= 64 ? launch_fixup_f32<4>(g, dout, av, bv, dy, blocks, buffers, drows, st)
                 : launch_fixup_f32<8>(g, dout, av, bv, dy, blocks, buffers, drows, st);
}

// Second backward pass, in place over dyp. n: elements of y; C % 4 == 0; y
// and dyp float32, or bfloat16 when bf16 != 0.
int dcase_bn_bwd_fixup(const void* y, void* dyp, const void* a, const void* b,
                       const void* mean, long long n, int C, int bf16, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_fixup<__nv_bfloat16>(y, dyp, a, b, mean, n, C, st)
              : launch_fixup<float>(y, dyp, a, b, mean, n, C, st);
}

// y: [rows, C] float32, or bfloat16 when bf16 != 0 (C % 4 == 0, C <= 1024);
// partials: [blocks, 2C] float64 scratch; out: [2, C] float32 = sums | sums
// of squares. float32: stats_kernel, rows_per_block = ceil(rows / blocks);
// bfloat16: stats_bf16_kernel, blocks from ops/fused_block.stats_bf16_plan
// (y 8-byte aligned; V = 8 channels a thread where C % 8 == 0 and y is
// 16-byte aligned).
int dcase_batch_stats(const void* y, void* partials, void* out, long long rows, int C,
                      int blocks, int bf16, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_stats_bf16(y, partials, out, rows, C, blocks, st)
              : launch_stats<float>(y, partials, out, rows, C, blocks, st);
}

// Blocks of stats_bf16_kernel<vec> (vec 8 or 4 channels a thread) that one SM
// of the current device holds (0 on an error); the wrapper sizes the grid
// from it.
int dcase_batch_stats_bf16_resident(int vec) {
  int resident = 0;
  const cudaError_t err = vec == 8
      ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, stats_bf16_kernel<8>, kStatsThreads, 0)
      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, stats_bf16_kernel<4>, kStatsThreads, 0);
  return err == cudaSuccess && (vec == 8 || vec == 4) ? resident : 0;
}

}  // extern "C"
