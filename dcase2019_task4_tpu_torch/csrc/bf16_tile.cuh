// The pixel tiles of the fused-block kernels and the bfloat16 tile code on
// the tensor cores that K2's bfloat16 kernels (fused_block.cu) and K5's
// bfloat16 backward passes (entry_block.cu) share.
//
// A tile holds up to kPix pixels in whole pooling windows (Tile, TilePos;
// the float32 kernels of fused_block.cu tile so too). On a tile whose y is
// staged in bfloat16 in shared memory (rows of RS = CP + 8 values, channels
// padded to CP = 64 or 128 with zeros), the backward passes form A =
// bf16(xn) once (form_a), take lin = A . W and dxn = gate + bf16(dlin) . W^T
// on mma.sync m16n8k16 with the element steps in the fragments' registers
// (dxn_bf16: product_w, gate_bf16), and the reduce pass adds S1, S2, db and
// dW = A^T . bf16(dlin) (reduce_tile_bf16, write_reduce_slot). The forwards
// (K2's and K5's) take lin = A . W likewise and form g and the pool in
// glu_pool_bf16. Every rounding is the plain version's (see xn_of and
// gate_bf16).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "chain.cuh"
#include "cp_async.cuh"
#include "dtype.cuh"
#include "mma.cuh"

namespace {

constexpr int kPix = 128;  // pixels per tile

// A pixel tile: `rows` time rows (a multiple of pt) x `cols` frequency columns
// (a multiple of pf), at most kPix pixels; pt * pf <= kPix.
struct Tile {
  int rows, cols;
};

__host__ __device__ inline Tile tile_of(int F, int pt, int pf) {
  if (pt * F <= kPix) return {pt * (kPix / (pt * F)), F};  // whole pooling rows
  return {pt, pf * (kPix / (pt * pf))};                    // whole windows of one row pair
}

__host__ __device__ inline int tiles_per_clip(int T, int F, int pt, int pf) {
  const Tile tl = tile_of(F, pt, pf);
  return ((T + tl.rows - 1) / tl.rows) * ((F + tl.cols - 1) / tl.cols);
}

// Where tile `tile` of clip b sits: its first time row t0 and frequency
// column f0, its size, and the global pixel index of its pixel p.
struct TilePos {
  int t0, f0, trows, fcols;
  long long row0;  // b * T + t0
  int F;
  __device__ __forceinline__ long long pixel(int p) const {
    return fcols == F ? row0 * F + p : (row0 + p / fcols) * F + f0 + p % fcols;
  }
};

__device__ __forceinline__ TilePos tile_pos(int tile, int b, int T, int F, Tile tl) {
  const int n_ft = (F + tl.cols - 1) / tl.cols;
  TilePos tp;
  tp.t0 = (tile / n_ft) * tl.rows;
  tp.f0 = (tile % n_ft) * tl.cols;
  tp.trows = min(tl.rows, T - tp.t0);  // a multiple of pt (T % pt == 0)
  tp.fcols = min(tl.cols, F - tp.f0);  // a multiple of pf (F % pf == 0)
  tp.row0 = (long long)b * T + tp.t0;
  tp.F = F;
  return tp;
}

// ------------------------------------ bfloat16: products on the tensor cores

using bf16 = __nv_bfloat16;

// Plan of the bfloat16 kernels at CP = 64 (C <= 64) or 128 padded
// channels and NW (8 or 16) warps; channels past C are zeros in every shared
// operand. For lin and dxn warp (wm, wn) = (warp / WN, warp % WN) holds
// pixels wm 16 MT .. of the tile x channels wn 32 .. (MT 16-pixel x 4
// 8-channel fragments); for dW warp (warp / 4, warp % 4) holds input
// channels (warp / 4) 16 MTW .. x output channels (warp % 4) CP / 4 .. (MTW
// x NTW fragments). A thread holds 128 CP / (32 NW) accumulators of lin or
// dxn and CP^2 / (32 NW) of dW. 16 warps an SM, in one block (at most 128
// registers a thread, no spill), except the forward at CP = 64 (two blocks
// of 8 warps): the reduce pass at CP = 128 took 3.10 ms at 16 warps against
// 4.08 at 8 (scaled block 1, NVIDIA H100 80GB HBM3, 700.00 W,
// tools/bench_k2_bf16_torch.py --ablations), its lin and dxn then taken over
// the tile's two pixel halves in turn to stay within the registers.
template <int CP, int NW>
struct BfPlan {
  static constexpr int NTHR = 32 * NW;
  static constexpr int RS = CP + 8;            // bfloat16 row stride: an odd number of 16-byte units
  static constexpr int GS = CP + 8;            // float32 row stride of the forward's g tile
  static constexpr int WN = CP / 32, WM = NW / WN;
  static constexpr int MT = kPix / (16 * WM);
  static constexpr int WMW = NW / 4, MTW = CP / (16 * WMW), NTW = CP / 32;
  static constexpr int KG = CP / 4;            // four-channel groups of a row
  static constexpr int MS = KG + 4;            // mask row stride, bytes: an odd number of words
  static_assert(WM * WN == NW && MT >= 1 && MTW >= 1 && NTW % 2 == 0, "warp layout");
};

__device__ __forceinline__ float2 ld_bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void st_bf2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }

// xn = ((y - mean) * inv) * scale + bias, each step rounded (no FMA), as the
// plain version's elementwise ops round it: one formula for the bfloat16
// operand and the float32 value the sigmoid takes. A last-bit difference in
// xn or in the sigmoid would move a bfloat16 operand to its other neighbour
// now and then, and one such operand moves a dW element by about 2e-4 of
// dW's largest: so the sigmoid is chain.cuh's sigmoidf, 1 / (1 + expf(-x))
// with the IEEE division, as torch.sigmoid computes it on the card (an
// __expf / __fdividef sigmoid saved 0.33 and 0.64 ms of the forward and the
// reduce pass at scaled block 1; __frcp_rn, the same bits, was slower).
__device__ __forceinline__ float xn_of(float y, float m, float iv, float sc, float bi) {
  return __fadd_rn(__fmul_rn(__fmul_rn(y - m, iv), sc), bi);
}

// CH (8 or 4) bfloat16 values into CH aligned slots of shared memory: `n` (0
// or CH) from src, zeros past them. mode 2: one 16-byte cp.async (CH 8), 1:
// one 8-byte cp.async (CH 4), 0: loads of the values and one store (a source
// without the alignment of a copy).
template <int CH>
__device__ __forceinline__ void copy_bf(bf16* dst, const bf16* src, int n, int mode) {
  if (mode != 0) {
    if constexpr (CH == 8) cp_async16(dst, src, 2 * n);
    else cp_async8(dst, src, 2 * n);
    return;
  }
  const auto* s = reinterpret_cast<const unsigned short*>(src);
  uint32_t v[CH / 2];
#pragma unroll
  for (int i = 0; i < CH / 2; ++i) v[i] = n ? ((uint32_t)s[2 * i] | ((uint32_t)s[2 * i + 1] << 16)) : 0u;
  if constexpr (CH == 8) *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
  else *reinterpret_cast<uint2*>(dst) = make_uint2(v[0], v[1]);
}

// y of a tile into yb [kPix][RS]: zeros past the tile and past C
template <int CP, int CH>
__device__ __forceinline__ void stage_y_rows(bf16* yb, const bf16* __restrict__ y, const TilePos& tp, int tpix,
                                             int C, int mode) {
  constexpr int NQ = CP / CH;
  for (int i = threadIdx.x; i < kPix * NQ; i += blockDim.x) {
    const int p = i / NQ, k = i % NQ;
    const bool ok = p < tpix && k * CH < C;
    copy_bf<CH>(yb + p * BfPlan<CP, 8>::RS + k * CH, ok ? y + tp.pixel(p) * C + k * CH : y, ok ? CH : 0, mode);
  }
}

// the tile's pooled rows of dout into db [drows][RS]: window w = (w / wcols,
// w % wcols) of the tile; zeros past C
template <int CP, int CH>
__device__ __forceinline__ void stage_dout_rows(bf16* db, const bf16* __restrict__ dout, const TilePos& tp, int b,
                                                int Tp, int Fp, int pt, int pf, int C, int mode) {
  constexpr int NQ = CP / CH;
  const int wcols = tp.fcols / pf, nw = (tp.trows / pt) * wcols;
  for (int i = threadIdx.x; i < nw * NQ; i += blockDim.x) {
    const int w = i / NQ, k = i % NQ;
    const bool ok = k * CH < C;
    const long long row = ((long long)b * Tp + tp.t0 / pt + w / wcols) * Fp + tp.f0 / pf + w % wcols;
    copy_bf<CH>(db + w * BfPlan<CP, 8>::RS + k * CH, ok ? dout + row * C + k * CH : dout, ok ? CH : 0, mode);
  }
}

// Once a block: W = bf16(glu_w) into ws [CP][RS] (in, out), and the vectors
// mean, inv, scale, bias, glu_b (and inv * scale where vgain != nullptr),
// zeros past C.
template <int CP>
__device__ __forceinline__ void stage_bf16_consts(bf16* ws, float* vmean, float* vinv, float* vscale, float* vbias,
                                                  float* vgb, float* vgain, const float* __restrict__ glu_w,
                                                  const float* __restrict__ scale, const float* __restrict__ bias,
                                                  const float* __restrict__ mean, const float* __restrict__ var,
                                                  const float* __restrict__ glu_b, int C, float eps) {
  constexpr int H = CP / 2;
  for (int i = threadIdx.x; i < CP * H; i += blockDim.x) {
    const int r = i / H, c = 2 * (i % H);
    const bool ok = r < C && c < C;  // C even: c + 1 < C too
    st_bf2(ws + r * BfPlan<CP, 8>::RS + c, ok ? glu_w[r * C + c] : 0.0f, ok ? glu_w[r * C + c + 1] : 0.0f);
  }
  for (int c = threadIdx.x; c < CP; c += blockDim.x) {
    const bool in = c < C;
    const float iv = in ? rsqrtf(var[c] + eps) : 0.0f;
    vmean[c] = in ? mean[c] : 0.0f;
    vinv[c] = iv;
    vscale[c] = in ? scale[c] : 0.0f;
    vbias[c] = in ? bias[c] : 0.0f;
    vgb[c] = in ? glu_b[c] : 0.0f;
    if (vgain != nullptr) vgain[c] = in ? iv * scale[c] : 0.0f;
  }
}

// A = bf16(xn) of the y tile yb, zeros past the tile: thread tid takes one
// 8-channel chunk of every (threads / (CP / 8))-th pixel row
template <int CP>
__device__ __forceinline__ void form_a(bf16* A, const bf16* yb, const float* vmean, const float* vinv,
                                       const float* vscale, const float* vbias, int tpix) {
  constexpr int RS = BfPlan<CP, 8>::RS, NQ = CP / 8;
  const int c = 8 * (threadIdx.x % NQ);
  float m[8], iv[8], sc[8], bi[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    m[e] = vmean[c + e];
    iv[e] = vinv[c + e];
    sc[e] = vscale[c + e];
    bi[e] = vbias[c + e];
  }
  for (int p = threadIdx.x / NQ; p < kPix; p += blockDim.x / NQ) {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (p < tpix) {
      const uint4 raw = *reinterpret_cast<const uint4*>(yb + p * RS + c);
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
      uint32_t o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
        const __nv_bfloat162 r =
            __floats2bfloat162_rn(xn_of(f.x, m[2 * j], iv[2 * j], sc[2 * j], bi[2 * j]),
                                  xn_of(f.y, m[2 * j + 1], iv[2 * j + 1], sc[2 * j + 1], bi[2 * j + 1]));
        o[j] = *reinterpret_cast<const uint32_t*>(&r);
      }
      v = make_uint4(o[0], o[1], o[2], o[3]);
    }
    *reinterpret_cast<uint4*>(A + p * RS + c) = v;
  }
}

// acc += X . B on the tensor cores for a warp's MT x 4 fragments: X [kPix][RS]
// row-major (A or D), fragment (mt, nt) = pixels wm 16 MT + 16 mt + g (+ 8) x
// channels wn 32 + 8 nt + 2 q (+ 1), g = lane / 4, q = lane % 4. B from W
// [in][out]: kTrans, lin = A . W (B [k][n] = W, ldmatrix.trans); else dxn =
// D . W^T (B [n][k] = W, ldmatrix), so both products leave the same pixels
// and channels in the same registers. MT: the warp's 16-pixel fragments
// (rows from X).
template <int CP, int NW, bool kTrans, int MT = BfPlan<CP, NW>::MT>
__device__ __forceinline__ void product_w(float (&acc)[MT][4][4], const bf16* X, const bf16* ws, int wm, int wn,
                                          int lane) {
  constexpr int RS = BfPlan<CP, NW>::RS;
  const uint32_t a0 = smem_addr(X + (wm * 16 * MT + lane % 16) * RS + (lane / 16) * 8);
  const uint32_t b0 = kTrans ? smem_addr(ws + (lane % 8 + ((lane / 8) % 2) * 8) * RS + wn * 32 + (lane / 16) * 8)
                             : smem_addr(ws + (wn * 32 + lane % 8 + (lane / 16) * 8) * RS + ((lane / 8) % 2) * 8);
#pragma unroll
  for (int kk = 0; kk < CP / 16; ++kk) {
    uint32_t bq[2][4];
    if constexpr (kTrans) {
      ldmatrix_x4_trans(bq[0], b0 + 2 * (kk * 16 * RS));
      ldmatrix_x4_trans(bq[1], b0 + 2 * (kk * 16 * RS + 16));
    } else {
      ldmatrix_x4(bq[0], b0 + 2 * (kk * 16));
      ldmatrix_x4(bq[1], b0 + 2 * (16 * RS + kk * 16));
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t a[4];
      ldmatrix_x4(a, a0 + 2 * (mt * 16 * RS + kk * 16));
      mma_bf16(acc[mt][0], a, bq[0][0], bq[0][1]);
      mma_bf16(acc[mt][1], a, bq[0][2], bq[0][3]);
      mma_bf16(acc[mt][2], a, bq[1][0], bq[1][1]);
      mma_bf16(acc[mt][3], a, bq[1][2], bq[1][3]);
    }
  }
}

template <int MT>
__device__ __forceinline__ void zero_acc(float (&acc)[MT][4][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
}

// Per element of lin's fragments in acc (a warp's MT x 4 fragments of
// pixels p0 + 16 mt + g (+ 8) x channels wn 32 + 8 nt + 2 q (+ 1)): dh =
// dout / (pt pf) * mask * keep_scale (the tile's keep bits), sig from the
// float32 xn rebuilt from the staged y, the gate term dh (lin + b) sig (1 -
// sig) into acc (dxn's first term), dlin = dh sig stored as D = bf16(dlin);
// on_db(db0, db1, c) with the float32 sums of dlin over the thread's pixels
// of channels c, c + 1 (the reduce pass's db).
template <int CP, int MT, typename OnDb>
__device__ __forceinline__ void gate_bf16(float (&acc)[MT][4][4], bf16* D, const bf16* yb, const bf16* dtile,
                                          const int* tab_d, const unsigned char* mbits, const float* vmean,
                                          const float* vinv, const float* vscale, const float* vbias,
                                          const float* vgb, int p0, int wn, int g, int q, float inv_win,
                                          const Dropout& dr, OnDb on_db) {
  constexpr int RS = BfPlan<CP, 8>::RS, MS = BfPlan<CP, 8>::MS;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int c = wn * 32 + nt * 8 + 2 * q;
    const float2 m = ld2(vmean + c), iv = ld2(vinv + c), sc = ld2(vscale + c), bi = ld2(vbias + c),
                 gb = ld2(vgb + c);
    float db0 = 0.0f, db1 = 0.0f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = p0 + mt * 16 + g + 8 * h;
        const int r = tab_d[p];
        float2 dh = make_float2(0.0f, 0.0f);
        if (r >= 0) {
          dh = ld_bf2(dtile + r * RS + c);
          dh.x *= inv_win;
          dh.y *= inv_win;
          if (dr.mode != 0) {
            const int bits = mbits[p * MS + c / 4] >> (c & 3);
            dh.x *= (bits & 1) ? dr.keep_scale : 0.0f;
            dh.y *= (bits & 2) ? dr.keep_scale : 0.0f;
          }
        }
        const float2 yv = ld_bf2(yb + p * RS + c);
        const float sg0 = sigmoidf(xn_of(yv.x, m.x, iv.x, sc.x, bi.x));
        const float sg1 = sigmoidf(xn_of(yv.y, m.y, iv.y, sc.y, bi.y));
        acc[mt][nt][2 * h] = dh.x * (acc[mt][nt][2 * h] + gb.x) * sg0 * (1.0f - sg0);
        acc[mt][nt][2 * h + 1] = dh.y * (acc[mt][nt][2 * h + 1] + gb.y) * sg1 * (1.0f - sg1);
        const float d0 = dh.x * sg0, d1 = dh.y * sg1;
        db0 += d0;
        db1 += d1;
        st_bf2(D + p * RS + c, d0, d1);
      }
    on_db(db0, db1, c);
  }
}

// The bfloat16 forward's element steps and pool on one tile, once lin = A .
// W lies in acc (a warp's MT x 4 fragments, as product_w lays them out): g
// = (lin + b) * sigmoid(xn) in the fragments' registers, with the float32
// xn rebuilt from the y tile yb at the fragment's pixel and channel; a
// barrier (every read of yb and A done); g in float32 into gs [kPix][GS],
// which may overlay yb and A; a barrier; then per window and four channels
// the keep-mask (keep_values4 on the global element index) and the mean over
// the window into out [.., F / pf, C] in bfloat16, 8 bytes a store. The sum
// rounds as one of the JAX package's two pools: pool_elems false, each
// pt-row column sum rounded to bfloat16 before the frequency sum (K2's
// _pool_mxu, the planes layout); true, every g rounded to bfloat16 before
// the window sum (the crows layout, crows_block.py:240-245). K2's and K5's
// bfloat16 forwards share it.
template <int CP, int NW>
__device__ __forceinline__ void glu_pool_bf16(float (&acc)[BfPlan<CP, NW>::MT][4][4], const bf16* yb, float* gs,
                                              const float* vmean, const float* vinv, const float* vscale,
                                              const float* vbias, const float* vgb, const TilePos& tp, int C, int pt,
                                              int pf, int Fp, float inv_win, const Dropout& dr,
                                              unsigned long long seed, bool pool_elems, bf16* __restrict__ out) {
  using P = BfPlan<CP, NW>;
  constexpr int RS = P::RS, GS = P::GS, MT = P::MT, KG = P::KG;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / P::WN, wn = warp % P::WN, g = lane / 4, q = lane % 4;
  // g = (lin + b) * sigmoid(xn), xn from the staged y at the fragment's pixel and channel
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int c = wn * 32 + nt * 8 + 2 * q;
    const float2 m = ld2(vmean + c), iv = ld2(vinv + c), sc = ld2(vscale + c), bi = ld2(vbias + c),
                 gb = ld2(vgb + c);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = wm * 16 * MT + mt * 16 + g + 8 * h;
        const float2 yv = ld_bf2(yb + p * RS + c);
        acc[mt][nt][2 * h] = (acc[mt][nt][2 * h] + gb.x) * sigmoidf(xn_of(yv.x, m.x, iv.x, sc.x, bi.x));
        acc[mt][nt][2 * h + 1] =
            (acc[mt][nt][2 * h + 1] + gb.y) * sigmoidf(xn_of(yv.y, m.y, iv.y, sc.y, bi.y));
      }
  }
  __syncthreads();  // every read of the y tile and of A done: g goes over them
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = wm * 16 * MT + mt * 16 + g + 8 * h, c = wn * 32 + nt * 8 + 2 * q;
        *reinterpret_cast<float2*>(gs + p * GS + c) = make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
  __syncthreads();  // g complete

  // per window and four channels: the mask, then pt-row time sums rounded
  // to bfloat16 and the frequency sum, or every g rounded and the window sum
  const int wcols = tp.fcols / pf, n_win = (tp.trows / pt) * wcols;
  for (int i = tid; i < n_win * KG; i += P::NTHR) {
    const int c = 4 * (i % KG), win = i / KG;
    if (c >= C) continue;
    const int wt = win / wcols, wf = win % wcols;
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int df = 0; df < pf; ++df) {
      float4 st = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int dt = 0; dt < pt; ++dt) {
        const int p = (wt * pt + dt) * tp.fcols + wf * pf + df;
        float4 v = *reinterpret_cast<const float4*>(gs + p * GS + c);
        if (dr.mode != 0) {
          const uint4 r = keep_values4(tp.pixel(p) * C + c, seed, dr.mode);
          v.x *= r.x >= dr.threshold ? dr.keep_scale : 0.0f;
          v.y *= r.y >= dr.threshold ? dr.keep_scale : 0.0f;
          v.z *= r.z >= dr.threshold ? dr.keep_scale : 0.0f;
          v.w *= r.w >= dr.threshold ? dr.keep_scale : 0.0f;
        }
        if (pool_elems) {
          s.x += rounded<bf16>(v.x);
          s.y += rounded<bf16>(v.y);
          s.z += rounded<bf16>(v.z);
          s.w += rounded<bf16>(v.w);
        } else {
          st.x += v.x;
          st.y += v.y;
          st.z += v.z;
          st.w += v.w;
        }
      }
      if (!pool_elems) {
        s.x += rounded<bf16>(st.x);
        s.y += rounded<bf16>(st.y);
        s.z += rounded<bf16>(st.z);
        s.w += rounded<bf16>(st.w);
      }
    }
    // row0 / pt = b T / pt + t0 / pt: T and t0 are multiples of pt
    Vec4<bf16>::store(out + ((tp.row0 / pt + wt) * Fp + tp.f0 / pf + wf) * C + c,
                      make_float4(s.x * inv_win, s.y * inv_win, s.z * inv_win, s.w * inv_win));
  }
}

// The tile's keep bits into mbits [kPix][MS]: one Philox call a four-channel
// group of each pixel (keep_values4 on the global element index), bit e of
// byte k for channel 4 k + e.
template <int CP>
__device__ __forceinline__ void keep_bits(unsigned char* mbits, const TilePos& tp, int tpix, int C,
                                          unsigned long long seed, const Dropout& dr) {
  constexpr int KG = BfPlan<CP, 8>::KG, MS = BfPlan<CP, 8>::MS;
  for (int i = threadIdx.x; i < tpix * KG; i += blockDim.x) {
    const int p = i / KG, k = i % KG;
    if (4 * k >= C) continue;
    const uint4 r = keep_values4(tp.pixel(p) * C + 4 * k, seed, dr.mode);
    mbits[p * MS + k] = (unsigned char)((r.x >= dr.threshold ? 1 : 0) | (r.y >= dr.threshold ? 2 : 0) |
                                        (r.z >= dr.threshold ? 4 : 0) | (r.w >= dr.threshold ? 8 : 0));
  }
}

// The tile's dout-row table: tab_d[p], the staged dout row of tile pixel p,
// or -1 past the tile.
__device__ __forceinline__ void dout_rows_of(int* tab_d, const TilePos& tp, int tpix, int pt, int pf) {
  if (threadIdx.x < kPix) {
    const int p = threadIdx.x;
    tab_d[p] = p < tpix ? (p / tp.fcols / pt) * (tp.fcols / pf) + (p % tp.fcols) / pf : -1;
  }
}

// The shared operands of the bfloat16 backward tile passes: A = bf16(xn)
// and D = bf16(dlin) [kPix][RS], W [CP][RS] (in, out), the per-channel
// vectors [CP] (zeros past C; vgain = inv * scale), the tile's keep bits
// [kPix][MS] and its dout-row table [kPix].
struct BfShared {
  bf16 *A, *D, *ws;
  float *vmean, *vinv, *vscale, *vbias, *vgb, *vgain;
  unsigned char* mbits;
  int* tab_d;
};

// dxn of the tile's pixels row0 .. row0 + 16 MT WM - 1, once A, the keep
// bits and the dout-row table are formed: lin = A . W on mma.sync, the gate
// (gate_bf16: D = bf16(dlin), on_db with db's float32 sums), a barrier (D
// complete), dxn = gate + D . W^T on mma.sync. On return acc holds the
// warp's MT x 4 fragments of dxn: pixels row0 + wm 16 MT + 16 mt + g (+ 8) x
// channels wn 32 + 8 nt + 2 q (+ 1), as product_w lays them out. A is read
// only before the barrier.
template <int CP, int NW, int MT, typename OnDb>
__device__ __forceinline__ void dxn_bf16(float (&acc)[MT][4][4], const BfShared& s, const bf16* yb, const bf16* dtile,
                                         int row0, float inv_win, const Dropout& dr, OnDb on_db) {
  using P = BfPlan<CP, NW>;
  constexpr int RS = P::RS;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp / P::WN, wn = warp % P::WN;
  zero_acc(acc);
  product_w<CP, NW, true, MT>(acc, s.A + row0 * RS, s.ws, wm, wn, lane);
  gate_bf16<CP>(acc, s.D, yb, dtile, s.tab_d, s.mbits, s.vmean, s.vinv, s.vscale, s.vbias, s.vgb, row0 + wm * 16 * MT,
                wn, lane / 4, lane % 4, inv_win, dr, on_db);
  __syncthreads();  // D of these pixels complete
  product_w<CP, NW, false, MT>(acc, s.D + row0 * RS, s.ws, wm, wn, lane);  // dxn = gate + D . W^T
}

// A tile's sums t0, t1 of channels c, c + 1 over this thread's pixels (g =
// lane / 4), added over the warp's g lanes by shuffles, then by lane g = 0
// into row[c], row[c + 1] (one warp owns a row's channels c, c + 1).
__device__ __forceinline__ void add_warp_sums(float* row, float t0, float t1, int c, int g) {
#pragma unroll
  for (int off = 4; off < 32; off *= 2) {
    t0 += __shfl_xor_sync(0xffffffffu, t0, off);
    t1 += __shfl_xor_sync(0xffffffffu, t1, off);
  }
  if (g == 0) {
    row[c] += t0;
    row[c + 1] += t1;
  }
}

// The bfloat16 reduce pass on one tile once A, the keep bits and the
// dout-row table are formed (K2b's bn_glu_pool_bwd_bf16_kernel and K5b1's
// entry_block_bwd_reduce_bf16_kernel): over NH passes of kPix / NH pixels,
// dxn_bf16 with db summed; S1 += dxn and S2 += dxn * x-hat from the staged y
// yb; where write_dyp, dy_partial = bf16(inv * scale * dxn) over yb; then dW
// += A^T . D on mma.sync (A and D by ldmatrix.trans) into accw, whose
// float32 sums carry across the block's tiles. sums [3][WM][CP]: the block's
// db, S1, S2 of each pixel warp row (shuffles over a warp's g lanes, then
// shared memory: the three sums of a thread's channels would have to live
// across the products in registers). NH = 2 at CP = 128 keeps the gate's
// accumulators and dW's within 128 registers at 16 warps.
template <int CP, int NW, int NH>
__device__ __forceinline__ void reduce_tile_bf16(float (&accw)[BfPlan<CP, NW>::MTW][BfPlan<CP, NW>::NTW][4],
                                                 const BfShared& s, bf16* yb, const bf16* dtile, float* sums, int tpix,
                                                 float inv_win, const Dropout& dr, bool write_dyp) {
  using P = BfPlan<CP, NW>;
  constexpr int RS = P::RS, MTW = P::MTW, NTW = P::NTW, MT = P::MT / NH, HP = kPix / NH;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp / P::WN, wn = warp % P::WN, g = lane / 4, q = lane % 4;
  const int wmw = warp / 4, wnw = warp % 4;
  for (int hp = 0; hp < NH; ++hp) {  // the pixels hp HP ..
    float acc[MT][4][4];
    dxn_bf16<CP, NW, MT>(acc, s, yb, dtile, hp * HP, inv_win, dr,
                         [&](float db0, float db1, int c) { add_warp_sums(sums + wm * CP, db0, db1, c, g); });
    // S1 += dxn, S2 += dxn * x-hat; dy_partial = bf16(inv * scale * dxn) over the y tile
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int c = wn * 32 + nt * 8 + 2 * q;
      const float2 m = ld2(s.vmean + c), iv = ld2(s.vinv + c), gn = ld2(s.vgain + c);
      float s10 = 0.0f, s11 = 0.0f, s20 = 0.0f, s21 = 0.0f;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = hp * HP + wm * 16 * MT + mt * 16 + g + 8 * h;
          const float2 yv = ld_bf2(yb + p * RS + c);
          const float d0 = acc[mt][nt][2 * h], d1 = acc[mt][nt][2 * h + 1];
          s10 += d0;
          s11 += d1;
          s20 = fmaf(d0, (yv.x - m.x) * iv.x, s20);
          s21 = fmaf(d1, (yv.y - m.y) * iv.y, s21);
          if (write_dyp) st_bf2(yb + p * RS + c, gn.x * d0, gn.y * d1);
        }
      add_warp_sums(sums + (P::WM + wm) * CP, s10, s11, c, g);
      add_warp_sums(sums + (2 * P::WM + wm) * CP, s20, s21, c, g);
    }
  }
  // dW += A^T . D over the tile's pixels
  const uint32_t a0 = smem_addr(s.A + (lane % 8 + (lane / 16) * 8) * RS + wmw * 16 * MTW + ((lane / 8) % 2) * 8);
  const uint32_t b0 = smem_addr(s.D + (lane % 8 + ((lane / 8) % 2) * 8) * RS + wnw * (CP / 4) + (lane / 16) * 8);
  const int ksteps = (tpix + 15) / 16;
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t bq[NTW / 2][4];
#pragma unroll
    for (int np = 0; np < NTW / 2; ++np) ldmatrix_x4_trans(bq[np], b0 + 2 * (ks * 16 * RS + np * 16));
#pragma unroll
    for (int mt = 0; mt < MTW; ++mt) {
      uint32_t a[4];
      ldmatrix_x4_trans(a, a0 + 2 * (ks * 16 * RS + mt * 16));
#pragma unroll
      for (int np = 0; np < NTW / 2; ++np) {
        mma_bf16(accw[mt][2 * np], a, bq[np][0], bq[np][1]);
        mma_bf16(accw[mt][2 * np + 1], a, bq[np][2], bq[np][3]);
      }
    }
  }
}

// A reduce pass's block slot ps [C*C dW | C db | C S1 | C S2]: dW from the
// fragments in accw, then (after a barrier) db, S1 and S2 as the sums of
// the pixel warp rows of sums [3][WM][CP], added in row order.
template <int CP, int NW>
__device__ __forceinline__ void write_reduce_slot(float* ps, const float (&accw)[BfPlan<CP, NW>::MTW][BfPlan<CP, NW>::NTW][4],
                                                  const float* sums, int C) {
  using P = BfPlan<CP, NW>;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, g = lane / 4, q = lane % 4;
  const int wmw = warp / 4, wnw = warp % 4;
#pragma unroll
  for (int mt = 0; mt < P::MTW; ++mt)
#pragma unroll
    for (int nt = 0; nt < P::NTW; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ci = wmw * 16 * P::MTW + mt * 16 + g + 8 * h, co = wnw * (CP / 4) + nt * 8 + 2 * q;
        if (ci < C && co < C)  // C even: co + 1 < C too
          *reinterpret_cast<float2*>(ps + (long long)ci * C + co) =
              make_float2(accw[mt][nt][2 * h], accw[mt][nt][2 * h + 1]);
      }
  // db, S1, S2: the pixel warp rows' sums added in order
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * CP; i += P::NTHR) {
    const int which = i / CP, c = i % CP;
    if (c >= C) continue;
    float t = 0.0f;
#pragma unroll
    for (int w = 0; w < P::WM; ++w) t += sums[(which * P::WM + w) * CP + c];
    ps[C * C + which * C + c] = t;
  }
}

}  // namespace
