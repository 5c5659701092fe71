// The float32 tile code on the CUDA cores that K2's float32 kernels
// (fused_block.cu: the forward, the reduce pass and the recompute fixup) and
// K5's float32 kernels on a conv tile (entry_block.cu: the forward, pass 1
// and pass 2) share. The forward's (FwdPlan, FwdTile) is at the end.
//
// On a tile of up to kPix pixels whose operand (x-hat = (y - mean) inv in the
// reduce passes, y - mean in the fixup) lies in shared memory in rows of KS =
// CP + 4 floats (channels padded to CP = 64 or 128 with zeros), lin = xn . W
// and dxn = gate + dlin . W^T run on 8-channel FP32 register tiles fed by
// 16-byte shared loads (lin_f32, gate_f32, dxn_f32), and the reduce passes
// add S1, S2, db and M = x-hat^T . dlin, whose block sums give dW = scale M +
// bias db (reduce_tile_f32, write_reduce_slot_f32). Thread (pg, cg) = (tid /
// CG, tid % CG) of RedPlan<NJ> holds, for both channel products and the
// element steps, pixels pg + PG i (i < MI) x channels h H + 4 cg + j (h < 2,
// j < 4); dy_f32 forms the fixup's dy from dxn. Plain FP32 FMAs (no TF32).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_tile.cuh"
#include "chain.cuh"
#include "cp_async.cuh"

namespace {

constexpr int kThreads = 256;  // threads of a block of the float32 tile code (and of the kernels beside it)

// Channel plan of the float32 reduce pass for C <= 16 * NJ (NJ = 4: C <= 64,
// NJ = 8: C <= 128); channels past C are zeros in every shared operand.
template <int NJ>
struct RedPlan {
  static constexpr int CP = 16 * NJ;              // padded channels: 64 or 128
  static constexpr int H = CP / 2;                // a thread's second channel half starts here
  static constexpr int CG = CP / 8;               // channel groups of a product tile: 8 or 16
  static constexpr int PG = kThreads / CG;        // pixel groups: 32 or 16
  static constexpr int MI = kPix / PG;            // pixels a thread: 4 or 8
  static constexpr int KS = CP + 4;               // row stride of the tiles: an odd number of 16-byte units
  static constexpr int DG = kThreads / (CG * CG); // dW groups, each a share of a tile's pixels: 4 or 1
  static_assert(CG % 8 == 0 && DG >= 1, "a quarter warp spans eight channel groups");
};

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ float& at(float4& v, int i) { return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w; }

// Four neighbouring floats from device memory into 16 aligned bytes of shared
// memory by cp.async: one 16-byte copy where vec (the tensor is 16-byte
// aligned; C % 4 == 0 keeps every row so), else four of 4 bytes; zeros
// unless ok.
__device__ __forceinline__ void stage_row4(float* dst, const float* src, bool ok, bool vec) {
  if (vec) {
    cp_async16(dst, src, ok ? 16 : 0);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) cp_async4(dst + e, ok ? src + e : src, ok ? 4 : 0);
}

// The per-channel vectors of the reduce passes [CP] each, zeros past C:
// mean, inv = rsqrt(var + eps), scale, bias, glu_b, gain = inv * scale, and
// the block's db (written at its end by write_reduce_slot_f32).
struct RedVecs {
  float *vmean, *vinv, *vscale, *vbias, *vgb, *vgain, *vdb;
};

__device__ __forceinline__ float* carve_red_vecs(RedVecs& v, float* p, int CP) {
  v.vmean = p;
  v.vinv = p + CP;
  v.vscale = p + 2 * CP;
  v.vbias = p + 3 * CP;
  v.vgb = p + 4 * CP;
  v.vgain = p + 5 * CP;
  v.vdb = p + 6 * CP;
  return p + 7 * CP;
}

template <int CP>
__device__ __forceinline__ void stage_red_vecs(const RedVecs& v, const float* __restrict__ scale,
                                               const float* __restrict__ bias, const float* __restrict__ mean,
                                               const float* __restrict__ var, const float* __restrict__ glu_b, int C,
                                               float eps) {
  for (int c = threadIdx.x; c < CP; c += kThreads) {
    const bool in = c < C;
    const float iv = in ? rsqrtf(var[c] + eps) : 0.0f;
    v.vmean[c] = in ? mean[c] : 0.0f;
    v.vinv[c] = iv;
    v.vscale[c] = in ? scale[c] : 0.0f;
    v.vbias[c] = in ? bias[c] : 0.0f;
    v.vgb[c] = in ? glu_b[c] : 0.0f;
    v.vgain[c] = in ? iv * scale[c] : 0.0f;
  }
}

// Once a block: W into wsw [CP][CP] (in, out), zeros past C, chunk q (four
// channels) of row r at position q ^ ((r >> 2) & 7), so that lin's loads
// (row k, chunks cg and cg + CG) and dxn's loads (rows h H + 4 cg + j, chunk
// k) are each eight distinct 16-byte bank groups across a quarter warp.
template <int CP>
__device__ __forceinline__ void stage_w_swizzled(float* wsw, const float* __restrict__ glu_w, int C) {
  constexpr int Q = CP / 4;
  for (int i = threadIdx.x; i < CP * Q; i += kThreads) {
    const int r = i / Q, q = i % Q;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < C && 4 * q < C) v = make_float4(glu_w[r * C + 4 * q], glu_w[r * C + 4 * q + 1], glu_w[r * C + 4 * q + 2],
                                            glu_w[r * C + 4 * q + 3]);
    st4(wsw + r * CP + 4 * (q ^ ((r >> 2) & 7)), v);
  }
}

// The tile's pooled rows of dout into dst [drows][CP + 4] by cp.async, zeros
// past C: window w = (w / wcols, w % wcols) of the tile, rows carried by
// counters (no division a row).
template <int CP>
__device__ __forceinline__ void stage_dout_f32(float* dst, const float* __restrict__ dout, const TilePos& tp, int b,
                                               int Tp, int Fp, int pt, int pf, int C, bool vec) {
  constexpr int Q = CP / 4, DP = kThreads / Q, KS = CP + 4;
  const int sq = threadIdx.x % Q;
  const int wcols = tp.fcols / pf, nw = (tp.trows / pt) * wcols;
  int w = threadIdx.x / Q;
  int wr = w / wcols, wc = w % wcols;
  const int dwr = DP / wcols, dwc = DP % wcols;
  for (; w < nw; w += DP) {
    const bool ok = 4 * sq < C;
    const long long row = ((long long)b * Tp + tp.t0 / pt + wr) * Fp + tp.f0 / pf + wc;
    stage_row4(dst + w * KS + 4 * sq, ok ? dout + row * C + 4 * sq : dout, ok, vec);
    wc += dwc;
    wr += dwr;
    if (wc >= wcols) {
      wc -= wcols;
      ++wr;
    }
  }
}

// Per tile pixel p (one division a pixel): tab_y[p], its global pixel;
// tab_d[p], its row of the staged dout rows (drows > 0) or of dout.
__device__ __forceinline__ void tile_tables(int* tab_y, int* tab_d, const TilePos& tp, int tpix, int b, int F,
                                            int Tp, int Fp, int pt, int pf, int drows) {
  if (threadIdx.x < kPix) {
    const int p = threadIdx.x;
    int gy = 0, gd = 0;
    if (p < tpix) {
      const int pr = p / tp.fcols, pc = p % tp.fcols;
      gy = (int)((tp.row0 + pr) * F + tp.f0 + pc);
      gd = drows > 0 ? (pr / pt) * (tp.fcols / pf) + pc / pf
                     : (b * Tp + (tp.t0 + pr) / pt) * Fp + (tp.f0 + pc) / pf;
    }
    tab_y[p] = gy;
    tab_d[p] = gd;
  }
}

// lin = xn . W (b added by the element step) into acc, with xn = u * vs + vb
// formed from each staged operand u as it is read (the reduce passes stage
// x-hat and take vs = scale, the fixup y - mean and vs = inv * scale)
template <int NJ>
__device__ __forceinline__ void lin_f32(float (&acc)[RedPlan<NJ>::MI][8], const float* xb, const float* wsw,
                                        const float* vs, const float* vb, int pg, int cg) {
  using P = RedPlan<NJ>;
  constexpr int CP = P::CP, CG = P::CG, PG = P::PG, MI = P::MI, KS = P::KS, Q = CP / 4;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  const float* xa = xb + pg * KS;
  for (int kq = 0; kq < Q; ++kq) {
    const float4 sk = ld4(vs + 4 * kq), bk = ld4(vb + 4 * kq);
    float4 a[MI];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const float4 u = ld4(xa + i * PG * KS + 4 * kq);
      a[i] = make_float4(fmaf(u.x, sk.x, bk.x), fmaf(u.y, sk.y, bk.y), fmaf(u.z, sk.z, bk.z), fmaf(u.w, sk.w, bk.w));
    }
    const int s = kq & 7;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* wr = wsw + (4 * kq + kk) * CP;
      const float4 b0 = ld4(wr + 4 * (cg ^ s)), b1 = ld4(wr + 4 * ((cg + CG) ^ s));
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const float av = at(a[i], kk);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
      }
    }
  }
}

// Per element, over lin in acc: dh = dout / (pt pf), masked (keep_values4 on
// float4 channel groups: four channels a Philox call); xn = u * vs + vb from
// the staged operand; the gate term dh (lin + b) sig (1 - sig) into acc
// (dxn's first term); dlin = dh sig into ds, and on_dlin(j, dlin) for
// register j of the thread's eight channels (the reduce passes sum db there).
template <int NJ, typename OnDlin>
__device__ __forceinline__ void gate_f32(float (&acc)[RedPlan<NJ>::MI][8], const float* xb, float* ds,
                                         const float* dtile, const float* __restrict__ dout, const int* tab_y,
                                         const int* tab_d, const float* vs, const float* vb, const float* vgb,
                                         int tpix, int C, int drows, bool vec, float inv_win, const Dropout& dr,
                                         unsigned long long seed, int pg, int cg, OnDlin on_dlin) {
  using P = RedPlan<NJ>;
  constexpr int H = P::H, PG = P::PG, MI = P::MI, KS = P::KS;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c0 = h * H + 4 * cg;
    float4 sc = ld4(vs + c0), bi = ld4(vb + c0), gb = ld4(vgb + c0);
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int p = pg + PG * i;
      float4 xh = ld4(xb + p * KS + c0);
      float4 dh = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (p < tpix && c0 < C) {
        dh = drows > 0 ? ld4(dtile + tab_d[p] * KS + c0)
                       : (vec ? __ldg(reinterpret_cast<const float4*>(dout + (long long)tab_d[p] * C + c0))
                              : make_float4(dout[(long long)tab_d[p] * C + c0], dout[(long long)tab_d[p] * C + c0 + 1],
                                            dout[(long long)tab_d[p] * C + c0 + 2],
                                            dout[(long long)tab_d[p] * C + c0 + 3]));
        dh = make_float4(dh.x * inv_win, dh.y * inv_win, dh.z * inv_win, dh.w * inv_win);
        if (dr.mode != 0) {
          const uint4 r = keep_values4((long long)tab_y[p] * C + c0, seed, dr.mode);
          dh.x *= r.x >= dr.threshold ? dr.keep_scale : 0.0f;
          dh.y *= r.y >= dr.threshold ? dr.keep_scale : 0.0f;
          dh.z *= r.z >= dr.threshold ? dr.keep_scale : 0.0f;
          dh.w *= r.w >= dr.threshold ? dr.keep_scale : 0.0f;
        }
      }
      float4 dl;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float xn = fmaf(at(xh, e), at(sc, e), at(bi, e));
        const float sig = __fdividef(1.0f, 1.0f + __expf(-xn));
        const float d = at(dh, e);
        acc[i][4 * h + e] = d * (acc[i][4 * h + e] + at(gb, e)) * sig * (1.0f - sig);
        at(dl, e) = d * sig;
        on_dlin(4 * h + e, at(dl, e));
      }
      st4(ds + p * KS + c0, dl);
    }
  }
}

// acc += dlin . W^T: row h H + 4 cg + j of W, chunk kq at kq ^ (cg & 7)
template <int NJ>
__device__ __forceinline__ void dxn_f32(float (&acc)[RedPlan<NJ>::MI][8], const float* ds, const float* wsw, int pg,
                                        int cg) {
  using P = RedPlan<NJ>;
  constexpr int CP = P::CP, H = P::H, PG = P::PG, MI = P::MI, KS = P::KS, Q = CP / 4;
  const float* da = ds + pg * KS;
  for (int kq = 0; kq < Q; ++kq) {
    float4 a[MI], bq[8];
#pragma unroll
    for (int i = 0; i < MI; ++i) a[i] = ld4(da + i * PG * KS + 4 * kq);
#pragma unroll
    for (int j = 0; j < 8; ++j) bq[j] = ld4(wsw + ((j / 4) * H + 4 * cg + j % 4) * CP + 4 * (kq ^ (cg & 7)));
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

// The registers a reduce pass carries across its block's tiles: M [input
// channel (i / 4) H + 4 wa + i % 4][output channel (j / 4) H + 4 wb + j % 4]
// of thread (wg, wa, wb) = (tid / CG^2, (tid / CG) % CG, tid % CG), and db,
// S1, S2 of channels (j / 4) H + 4 cg + j % 4 over this thread's pixels.
struct RedCarry {
  float mw[8][8];
  float dbs[8], s1[8], s2[8];
};

__device__ __forceinline__ void zero_carry(RedCarry& r) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    r.dbs[i] = r.s1[i] = r.s2[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) r.mw[i][j] = 0.0f;
  }
}

// The reduce pass on one tile once x-hat = (y - mean) inv lies in xb
// [kPix][KS] (zeros past the tile and past C) with the tile's tables and
// dout rows: lin = xn . W, xn = x-hat * scale + bias; the gate term, dlin
// over ds, db += dlin; a barrier (dlin complete); dxn = gate + dlin . W^T;
// S1 += dxn, S2 += dxn * x-hat and, where dyp != nullptr, dy_partial = inv *
// scale * dxn stored at the tile's global pixels (by float4 where vec); M +=
// x-hat^T . dlin over the pixels p = wg (mod DG). Every thread of the block
// calls it.
template <int NJ>
__device__ __forceinline__ void reduce_tile_f32(RedCarry& r, const float* xb, float* ds, const float* dtile,
                                                const float* __restrict__ dout, const float* wsw, const RedVecs& v,
                                                const int* tab_y, const int* tab_d, float* __restrict__ dyp, int tpix,
                                                int C, int drows, bool vec, float inv_win, const Dropout& dr,
                                                unsigned long long seed) {
  using P = RedPlan<NJ>;
  constexpr int H = P::H, CG = P::CG, PG = P::PG, MI = P::MI, KS = P::KS, DG = P::DG;
  const int tid = threadIdx.x, cg = tid % CG, pg = tid / CG;
  const int wa = (tid / CG) % CG, wb = tid % CG, wg = tid / (CG * CG);
  float acc[MI][8];
  lin_f32<NJ>(acc, xb, wsw, v.vscale, v.vbias, pg, cg);
  gate_f32<NJ>(acc, xb, ds, dtile, dout, tab_y, tab_d, v.vscale, v.vbias, v.vgb, tpix, C, drows, vec, inv_win, dr,
               seed, pg, cg, [&](int j, float d) { r.dbs[j] += d; });
  __syncthreads();  // dlin complete
  dxn_f32<NJ>(acc, ds, wsw, pg, cg);
  // S1 += dxn, S2 += dxn * x-hat, dy_partial = inv * scale * dxn
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c0 = h * H + 4 * cg;
    if (c0 >= C) continue;
    float4 g = ld4(v.vgain + c0);
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int p = pg + PG * i;
      if (p >= tpix) continue;
      float4 xh = ld4(xb + p * KS + c0), out;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float dxn = acc[i][4 * h + e];
        r.s1[4 * h + e] += dxn;
        r.s2[4 * h + e] = fmaf(dxn, at(xh, e), r.s2[4 * h + e]);
        at(out, e) = at(g, e) * dxn;
      }
      if (dyp != nullptr) {
        float* dst = dyp + (long long)tab_y[p] * C + c0;
        if (vec) {
          st4(dst, out);
        } else {
          dst[0] = out.x;
          dst[1] = out.y;
          dst[2] = out.z;
          dst[3] = out.w;
        }
      }
    }
  }

  // M += x-hat^T . dlin over this group's pixels
  for (int p = wg; p < tpix; p += DG) {
    const float* xr = xb + p * KS;
    const float* dr_ = ds + p * KS;
    const float4 x0 = ld4(xr + 4 * wa), x1 = ld4(xr + H + 4 * wa);
    const float4 d0 = ld4(dr_ + 4 * wb), d1 = ld4(dr_ + H + 4 * wb);
    const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
    const float dv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) r.mw[i][j] = fmaf(xv[i], dv[j], r.mw[i][j]);
  }
}

// A reduce pass's block slot ps [C*C dW | C db | C S1 | C S2] once every
// warp is done with its tiles: db, S1, S2 of the pixel groups added in group
// order through red [3][PG][CP] (scratch of at least max(3 PG, (DG - 1) CP)
// CP floats that nothing else reads now), db into v.vdb; the M groups added
// in group order; then dW = xn^T . dlin = scale[ci] M + bias[ci] db.
template <int NJ>
__device__ __forceinline__ void write_reduce_slot_f32(float* ps, RedCarry& r, float* red, const RedVecs& v, int C) {
  using P = RedPlan<NJ>;
  constexpr int CP = P::CP, H = P::H, CG = P::CG, PG = P::PG, DG = P::DG;
  const int tid = threadIdx.x, cg = tid % CG, pg = tid / CG;
  const int wa = (tid / CG) % CG, wb = tid % CG, wg = tid / (CG * CG);
  __syncthreads();  // every warp is done with the tiles
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = (j / 4) * H + 4 * cg + j % 4;
    red[(0 * PG + pg) * CP + c] = r.dbs[j];
    red[(1 * PG + pg) * CP + c] = r.s1[j];
    red[(2 * PG + pg) * CP + c] = r.s2[j];
  }
  __syncthreads();
  for (int i = tid; i < 3 * CP; i += kThreads) {
    const int which = i / CP, c = i % CP;
    float s = 0.0f;
    for (int g = 0; g < PG; ++g) s += red[(which * PG + g) * CP + c];
    if (which == 0) v.vdb[c] = s;
    if (c < C) ps[C * C + which * C + c] = s;
  }
  __syncthreads();  // the sums above are read; vdb complete
  if constexpr (DG > 1) {  // the M groups, added in group order
    float* wred = red;  // [DG - 1][CP][CP]
    if (wg > 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          st4(wred + ((wg - 1) * CP + (i / 4) * H + 4 * wa + i % 4) * CP + h * H + 4 * wb,
              make_float4(r.mw[i][4 * h], r.mw[i][4 * h + 1], r.mw[i][4 * h + 2], r.mw[i][4 * h + 3]));
    }
    __syncthreads();
    if (wg == 0) {
      for (int g = 1; g < DG; ++g)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float4 u = ld4(wred + ((g - 1) * CP + (i / 4) * H + 4 * wa + i % 4) * CP + h * H + 4 * wb);
            r.mw[i][4 * h] += u.x;
            r.mw[i][4 * h + 1] += u.y;
            r.mw[i][4 * h + 2] += u.z;
            r.mw[i][4 * h + 3] += u.w;
          }
    }
  }
  if (wg == 0) {  // dW = xn^T . dlin = scale[ci] M + bias[ci] db
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int ci = (i / 4) * H + 4 * wa + i % 4;
      if (ci >= C) continue;
      const float sc = v.vscale[ci], bi = v.vbias[ci];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int co = h * H + 4 * wb;
        if (co >= C) continue;
        const float4 dbv = ld4(v.vdb + co);
        st4(ps + (long long)ci * C + co,
            make_float4(fmaf(sc, r.mw[i][4 * h], bi * dbv.x), fmaf(sc, r.mw[i][4 * h + 1], bi * dbv.y),
                        fmaf(sc, r.mw[i][4 * h + 2], bi * dbv.z), fmaf(sc, r.mw[i][4 * h + 3], bi * dbv.w)));
      }
    }
  }
}

// ------------------------------------------------------------------ forward

// Plan of the float32 forward for C <= 16 * NJ: the reduce pass's channels
// (CP, H, CG, KS) and register tiles of MI pixels x 8 channels a thread, so
// NT = 16 CG MI threads cover a tile of kPix pixels: 4 x 8 at C <= 64 (256
// threads, two blocks an SM in 128 registers), 8 x 8 at C <= 128. 8 x 8 at
// C <= 64 (128 threads) read 0.5103 ms at block 1 of the flagship shape
// against 0.4162, and 4 x 8 without the register bound (one block an SM)
// 0.5291 (NVIDIA H100 80GB HBM3, 700.00 W, CUDA events,
// tools/bench_k2f_f32_torch.py --variants).
template <int NJ>
struct FwdPlan {
  static constexpr int CP = 16 * NJ, H = CP / 2, CG = CP / 8, KS = CP + 4;
  static constexpr int MI = NJ == 4 ? 4 : 8;          // pixels a thread
  static constexpr int PG = kPix / MI;                // pixel groups
  static constexpr int NT = PG * CG;                  // threads
  static constexpr int MIN_BLOCKS = NJ == 4 ? 2 : 1;  // the blocks an SM that the registers must allow
};

// The per-tile steps of the float32 forward (fused_block.cu
// bn_glu_pool_kernel, K2f) that K5f's float32 forward (entry_block.cu
// entry_block_fwd_f32_kernel) runs on the y tile it computes: W' = diag(G)
// W and b' = b + bias . W formed once a block (stage_consts), and per tile,
// once x-hat = y - mean lies in xb [kPix][KS] with the tile's pixel table,
// the product, the gate, the mask and the pool (glu_pool). See the comment
// at bn_glu_pool_kernel.
template <int NJ>
struct FwdTile {
  using P = FwdPlan<NJ>;
  static constexpr int CP = P::CP, H = P::H, CG = P::CG, PG = P::PG, MI = P::MI, KS = P::KS, NT = P::NT;
  static constexpr int Q = CP / 4, DP = NT / Q;  // the pool: chunk tid % Q of every DP-th window

  // Once a block: vgain = G = inv * scale, vmean, vbias [CP] (zeros past C),
  // then W' into ws [CP][CP] and b' into vgb [CP].
  static __device__ __forceinline__ void stage_consts(float* ws, float* vgain, float* vmean, float* vbias, float* vgb,
                                                      const float* __restrict__ scale, const float* __restrict__ bias,
                                                      const float* __restrict__ mean, const float* __restrict__ var,
                                                      const float* __restrict__ glu_w,
                                                      const float* __restrict__ glu_b, int C, float eps) {
    const int tid = threadIdx.x;
    for (int c = tid; c < CP; c += NT) {  // once a block: G, mean, bias, then W' and b'
      vgain[c] = c < C ? rsqrtf(var[c] + eps) * scale[c] : 0.0f;
      vmean[c] = c < C ? mean[c] : 0.0f;
      vbias[c] = c < C ? bias[c] : 0.0f;
    }
    __syncthreads();
    for (int i = tid; i < CP * Q; i += NT) {
      const int r = i / Q, q = i % Q;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (r < C && 4 * q < C) {
        const float g = vgain[r];
        v = make_float4(g * glu_w[r * C + 4 * q], g * glu_w[r * C + 4 * q + 1], g * glu_w[r * C + 4 * q + 2],
                        g * glu_w[r * C + 4 * q + 3]);
      }
      st4(ws + r * CP + 4 * q, v);
    }
    for (int c = tid; c < CP; c += NT) {
      float s = 0.0f;
      if (c < C) {
        s = glu_b[c];
        for (int r = 0; r < C; ++r) s = fmaf(vbias[r], glu_w[r * C + c], s);
      }
      vgb[c] = s;
    }
  }

  // One tile of clip b at tp (tpix pixels) once x-hat lies in xb and the
  // pixel table in tab_y (after a barrier): lin, g and the mask in
  // registers, then the pooled windows into out; g goes over xb where the
  // pool reads it from shared memory. Every thread of the block calls it.
  static __device__ __forceinline__ void glu_pool(float* xb, const float* ws, const float* vgain, const float* vbias,
                                                  const float* vgb, const int* tab_y, const TilePos& tp, int b,
                                                  int tpix, int C, int pt, int pf, int Tp, int Fp, float inv_win,
                                                  const Dropout& dr, unsigned long long seed,
                                                  float* __restrict__ out, int vec) {
    const int tid = threadIdx.x, cg = tid % CG, pg = tid / CG, sq = tid % Q;
    const int nq = C / 4;  // chunks of four input channels below C

    // lin - b' = x-hat . W' over the input channels below C (W's rows past C are zeros)
    float acc[MI][8];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    {
      const float* xa = xb + pg * KS;
      const float* wc = ws + 4 * cg;
      for (int kq = 0; kq < nq; ++kq) {
        float4 a[MI];
#pragma unroll
        for (int i = 0; i < MI; ++i) a[i] = ld4(xa + i * PG * KS + 4 * kq);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* wr = wc + (4 * kq + kk) * CP;
          const float4 b0 = ld4(wr), b1 = ld4(wr + H);
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            const float av = at(a[i], kk);
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
          }
        }
      }
    }

    // per element: g = (lin + b') * sigmoid(x-hat G + bias), masked four channels a Philox call
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c0 = h * H + 4 * cg;
      float4 gb = ld4(vgb + c0), gn = ld4(vgain + c0), of = ld4(vbias + c0);
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int p = pg + PG * i;
        float4 yv = ld4(xb + p * KS + c0);
        float4 g;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float xn = fmaf(at(yv, e), at(gn, e), at(of, e));
          at(g, e) = (acc[i][4 * h + e] + at(gb, e)) * __fdividef(1.0f, 1.0f + __expf(-xn));
        }
        if (dr.mode != 0 && p < tpix && c0 < C) {
          const uint4 r = keep_values4((long long)tab_y[p] * C + c0, seed, dr.mode);
          g.x *= r.x >= dr.threshold ? dr.keep_scale : 0.0f;
          g.y *= r.y >= dr.threshold ? dr.keep_scale : 0.0f;
          g.z *= r.z >= dr.threshold ? dr.keep_scale : 0.0f;
          g.w *= r.w >= dr.threshold ? dr.keep_scale : 0.0f;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][4 * h + e] = at(g, e);
      }
    }
    // a window's four channels, summed, into out
    auto put = [&](int wr, int wc, int c0, float4 v) {
      float* dst = out + (((long long)b * Tp + tp.t0 / pt + wr) * Fp + tp.f0 / pf + wc) * C + c0;
      v = make_float4(v.x * inv_win, v.y * inv_win, v.z * inv_win, v.w * inv_win);
      if (vec) {
        st4(dst, v);
      } else {
        dst[0] = v.x;
        dst[1] = v.y;
        dst[2] = v.z;
        dst[3] = v.w;
      }
    };
    bool by_shuffles = false;
    if constexpr (PG == 32 && CG == 8) by_shuffles = pt == 2 && pf == 4 && tp.trows == 2 && tp.fcols == 2 * PG;
    if (by_shuffles) {  // block 1's geometry: rows i / 2 of column pg + 32 (i % 2), then the warp's four columns
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c0 = h * H + 4 * cg;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          float4 v;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float u = acc[k][4 * h + e] + acc[k + 2][4 * h + e];
            u += __shfl_xor_sync(0xffffffffu, u, 8);
            u += __shfl_xor_sync(0xffffffffu, u, 16);
            at(v, e) = u;
          }
          if ((pg & 3) == 0 && c0 < C) put(0, pg / 4 + 8 * k, c0, v);
        }
      }
    } else {
      __syncthreads();  // every read of y done: g goes over it
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < MI; ++i)
          st4(xb + (pg + PG * i) * KS + h * H + 4 * cg,
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]));
      __syncthreads();  // g complete

      // the pool: window w = (wr, wc) of the tile's (trows / pt) x (fcols / pf), carried by counters
      if (4 * sq < C) {
        const int wcols = tp.fcols / pf, n_win = (tp.trows / pt) * wcols;
        const int dwr = DP / wcols, dwc = DP % wcols;
        int w = tid / Q;
        int wr = w / wcols, wc = w % wcols;
        for (; w < n_win; w += DP) {
          const float* src = xb + (wr * pt * tp.fcols + wc * pf) * KS + 4 * sq;
          float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          for (int dt = 0; dt < pt; ++dt)
            for (int df = 0; df < pf; ++df) {
              const float4 u = ld4(src + (dt * tp.fcols + df) * KS);
              v.x += u.x;
              v.y += u.y;
              v.z += u.z;
              v.w += u.w;
            }
          put(wr, wc, 4 * sq, v);
          wc += dwc;
          wr += dwr;
          if (wc >= wcols) {
            wc -= wcols;
            ++wr;
          }
        }
      }
    }
  }
};

// ------------------------------------------------- recompute fixup's epilogue

// dy = inv scale dxn - a - (y - mean) b2 of this thread's elements (dxn in
// acc, y - mean in xb [kPix][KS]), handed to put(p, c0, dy4) per pixel p <
// tpix and four channels c0 < C: the recompute fixup (fused_block.cu) stores
// it, K5b2's float32 pass (entry_block.cu) writes it over xb.
template <int NJ, typename Put>
__device__ __forceinline__ void dy_f32(const float (&acc)[RedPlan<NJ>::MI][8], const float* xb, const float* vgain,
                                       const float* va, const float* vb2, int tpix, int C, int pg, int cg, Put put) {
  using P = RedPlan<NJ>;
  constexpr int H = P::H, PG = P::PG, MI = P::MI, KS = P::KS;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c0 = h * H + 4 * cg;
    if (c0 >= C) continue;
    float4 g = ld4(vgain + c0), av = ld4(va + c0), bv = ld4(vb2 + c0);
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int p = pg + PG * i;
      if (p >= tpix) continue;
      float4 yc = ld4(xb + p * KS + c0);
      float4 out;
#pragma unroll
      for (int e = 0; e < 4; ++e) at(out, e) = at(g, e) * acc[i][4 * h + e] - at(av, e) - at(yc, e) * at(bv, e);
      put(p, c0, out);
    }
  }
}

}  // namespace
