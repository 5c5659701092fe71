// K2: BatchNorm -> GLU -> dropout -> average pool, forward and backward, and
// the per-channel batch statistics, fused, float32, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of dcase2019_task4_tpu/ops/fused_block.py:
//   bn_glu_pool_kernel       _fwd_kernel (via _fwd_pallas), eval and train
//   bn_glu_pool_bwd_kernel   _bwd_reduce_kernel (first pass of _bwd_pallas)
//   bn_bwd_fixup_kernel      _bwd_fixup_kernel (second pass of _bwd_pallas)
//   stats_kernel             _stats_kernel (batch_stats)
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
// and b from the folded sums).
//
// Dropout: Philox4x32-10 keyed on the 64-bit seed, counter = global element
// index of y divided by 4; the four output words mask four neighbouring
// channels. The mask therefore depends only on (seed, element, rate), never
// on tiling or launch geometry; it is never stored, and the backward
// regenerates it bit for bit. The seed is read from device memory, so the
// host never has to know it.
//
// Bound: at block 1 of the flagship shape (y = [24, 864, 64, 64], 340 MB)
// the forward reads y once (0.10 ms at 3.35 TB/s) and its 64x64 channel mix
// is 10.9 GFLOP (0.16 ms at the 67 TFLOP/s FP32 peak of the CUDA cores), so
// in plain FP32 the channel mix binds. The backward does three such
// products (lin, dlin . W^T, xn^T . dlin: 32.6 GFLOP, 0.49 ms) and moves
// 340 MB in and 340 MB out (0.20 ms): operations bind it too. The fixup and
// the statistics are pure streams (1019 MB and 340 MB).
//
// Design: one block per (run of pixel tiles, clip). A pixel tile is a whole
// number of pooling rows (pt time rows x F) holding up to 128 pixels; the
// tiles of a block are consecutive in time, so the block loads W and the
// per-channel vectors into shared memory once. Forward, per tile: read the
// slab once, normalise it into shared memory (pixel stride C + 1 against
// bank conflicts), mix channels with each thread holding 8 pixels x 4
// channels (8 when C > 64) in registers, gate, write g back over the slab,
// mask it four channels per Philox call, and average each pooling window
// from there. Only the pooled tile is written. Backward, per tile: the same
// staging, dh (with the mask) staged beside it, lin in registers, dlin
// written over dh, the second product against W^T (W rows padded to C + 1
// so the transposed read is conflict-free), dy_partial written from
// registers; then xn^T . dlin with each thread holding a 4 x 4 (8 x 8) patch
// of dW in registers across all tiles of the block. The four sums of a
// block go to its own slot of a workspace and fold_kernel adds the slots in
// a fixed order in double precision: no float atomics, so a run repeats bit
// for bit. Plain FP32 FMAs: no TF32, no tensor cores yet.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fold.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 128;  // pixels per tile

// Time rows per tile: whole pooling rows, up to kPix pixels (pt * F <= kPix).
int rows_per_tile(int F, int pt) { return pt * (kPix / (pt * F)); }

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

// Multiply four neighbouring channels starting at tile element `e` (a
// multiple of 4; C % 4 == 0) by keep-mask * keep_scale.
__device__ __forceinline__ void mask4(float* xs, int CP, int C, int e, long long tile_base,
                                      unsigned long long seed, uint32_t threshold,
                                      float keep_scale) {
  const uint4 r = philox4x32_10((unsigned long long)(tile_base + e) >> 2, seed);
  float* px = xs + (e / C) * CP + (e % C);
  px[0] *= r.x >= threshold ? keep_scale : 0.0f;
  px[1] *= r.y >= threshold ? keep_scale : 0.0f;
  px[2] *= r.z >= threshold ? keep_scale : 0.0f;
  px[3] *= r.w >= threshold ? keep_scale : 0.0f;
}

// ------------------------------------------------------------------ forward

// NJ: output channels per thread / 16 (C <= 16 * NJ).
template <int NJ>
__global__ void __launch_bounds__(kThreads)
bn_glu_pool_kernel(const float* __restrict__ y, const float* __restrict__ scale,
                   const float* __restrict__ bias, const float* __restrict__ mean,
                   const float* __restrict__ var, const float* __restrict__ glu_w,
                   const float* __restrict__ glu_b, float* __restrict__ out, int T,
                   int F, int C, int pt, int pf, float eps, int rows,
                   int tiles_per_block, const long long* __restrict__ seed_ptr,
                   uint32_t threshold, float keep_scale) {
  extern __shared__ float smem[];
  const int CP = C + 1;
  float* xs = smem;              // [kPix][CP]: xn, then g
  float* ws = xs + kPix * CP;    // [C][C] (in, out)
  float* s_scale = ws + C * C;   // [C] each
  float* s_bias = s_scale + C;
  float* s_mean = s_bias + C;
  float* s_inv = s_mean + C;
  float* s_gb = s_inv + C;

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const bool drop = threshold != 0u;
  const unsigned long long seed = drop ? (unsigned long long)seed_ptr[0] : 0ull;
  for (int i = tid; i < C * C; i += kThreads) ws[i] = glu_w[i];
  for (int c = tid; c < C; c += kThreads) {
    s_scale[c] = scale[c];
    s_bias[c] = bias[c];
    s_mean[c] = mean[c];
    s_inv[c] = rsqrtf(var[c] + eps);
    s_gb[c] = glu_b[c];
  }

  const int cg = tid % 16, pg = tid / 16;
  const int Tp = T / pt, Fp = F / pf;
  const int n_tiles = (T + rows - 1) / rows;
  const int first = blockIdx.x * tiles_per_block;
  const int last = min(n_tiles, first + tiles_per_block);
  const float inv_win = 1.0f / (float)(pt * pf);

  for (int tile = first; tile < last; ++tile) {
    const int t0 = tile * rows;
    const int trows = min(rows, T - t0);  // a multiple of pt (T % pt == 0)
    const int tpix = trows * F;
    const long long tile_base = ((long long)b * T + t0) * F * C;
    const float* yt = y + tile_base;

    __syncthreads();  // weights staged / previous tile's pool read done
    for (int i = tid; i < tpix * C; i += kThreads) {
      const int p = i / C, c = i % C;
      xs[p * CP + c] = (yt[i] - s_mean[c]) * s_inv[c] * s_scale[c] + s_bias[c];
    }
    __syncthreads();

    float acc[8][NJ];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
    for (int ci = 0; ci < C; ++ci) {
      float a[8], wv[NJ];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = xs[(pg + 16 * i) * CP + ci];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int co = cg + 16 * j;
        wv[j] = co < C ? ws[ci * C + co] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], wv[j], acc[i][j]);
    }
    float g[8][NJ];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int p = pg + 16 * i, co = cg + 16 * j;
        g[i][j] = 0.0f;
        if (p < tpix && co < C) {
          const float xn = xs[p * CP + co];
          g[i][j] = (acc[i][j] + s_gb[co]) * sigmoidf(xn);
        }
      }
    __syncthreads();  // every xn read; overwrite the slab with g
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int p = pg + 16 * i, co = cg + 16 * j;
        if (p < tpix && co < C) xs[p * CP + co] = g[i][j];
      }
    __syncthreads();
    if (drop) {
      for (int e = 4 * tid; e < tpix * C; e += 4 * kThreads)
        mask4(xs, CP, C, e, tile_base, seed, threshold, keep_scale);
      __syncthreads();
    }

    const int n_out = (trows / pt) * Fp * C;
    for (int o = tid; o < n_out; o += kThreads) {
      const int c = o % C, win = o / C;
      const int wf = win % Fp, wt = win / Fp;
      float s = 0.0f;
      for (int dt = 0; dt < pt; ++dt)
        for (int df = 0; df < pf; ++df)
          s += xs[((wt * pt + dt) * F + wf * pf + df) * CP + c];
      out[(((long long)b * Tp + t0 / pt + wt) * Fp + wf) * C + c] = s * inv_win;
    }
  }
}

// ----------------------------------------------------------------- backward

// Workspace slot of a block: [C*C dW | C db | C S1 | C S2].
template <int NJ>
__global__ void __launch_bounds__(kThreads)
bn_glu_pool_bwd_kernel(const float* __restrict__ y, const float* __restrict__ dout,
                       const float* __restrict__ scale, const float* __restrict__ bias,
                       const float* __restrict__ mean, const float* __restrict__ var,
                       const float* __restrict__ glu_w, const float* __restrict__ glu_b,
                       float* __restrict__ dyp, float* __restrict__ partials, int T, int F,
                       int C, int pt, int pf, float eps, int rows, int tiles_per_block,
                       const long long* __restrict__ seed_ptr, uint32_t threshold,
                       float keep_scale) {
  extern __shared__ float smem[];
  const int CP = C + 1;
  float* xs = smem;               // [kPix][CP]: xn
  float* ds = xs + kPix * CP;     // [kPix][CP]: dh, then dlin
  float* ws = ds + kPix * CP;     // [C][CP] (in, out), rows padded
  float* s_scale = ws + C * CP;   // [C] each
  float* s_bias = s_scale + C;
  float* s_mean = s_bias + C;
  float* s_inv = s_mean + C;
  float* s_gb = s_inv + C;
  float* red = s_gb + C;          // [16][2][16 * NJ]: S1/S2 by pixel group

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const bool drop = threshold != 0u;
  const unsigned long long seed = drop ? (unsigned long long)seed_ptr[0] : 0ull;
  for (int i = tid; i < C * C; i += kThreads) ws[(i / C) * CP + i % C] = glu_w[i];
  for (int c = tid; c < C; c += kThreads) {
    s_scale[c] = scale[c];
    s_bias[c] = bias[c];
    s_mean[c] = mean[c];
    s_inv[c] = rsqrtf(var[c] + eps);
    s_gb[c] = glu_b[c];
  }

  const int cg = tid % 16, pg = tid / 16;
  const int Tp = T / pt, Fp = F / pf;
  const int n_tiles = (T + rows - 1) / rows;
  const int first = blockIdx.x * tiles_per_block;
  const int last = min(n_tiles, first + tiles_per_block);
  const float inv_win = 1.0f / (float)(pt * pf);

  // carried over all tiles of the block
  float dw[NJ][NJ];  // dW[cg_a + 16 i][cg + 16 j], cg_a = pg
  float dbv[NJ], s1[NJ], s2[NJ];
#pragma unroll
  for (int i = 0; i < NJ; ++i) {
    dbv[i] = s1[i] = s2[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) dw[i][j] = 0.0f;
  }

  for (int tile = first; tile < last; ++tile) {
    const int t0 = tile * rows;
    const int trows = min(rows, T - t0);
    const int tpix = trows * F;
    const long long tile_base = ((long long)b * T + t0) * F * C;
    const float* yt = y + tile_base;

    __syncthreads();  // constants staged / previous tile's products done
    for (int i = tid; i < kPix * C; i += kThreads) {
      const int p = i / C, c = i % C;
      float xn = 0.0f, dh = 0.0f;
      if (p < tpix) {
        xn = (yt[i] - s_mean[c]) * s_inv[c] * s_scale[c] + s_bias[c];
        const int t = p / F, f = p % F;
        dh = dout[(((long long)b * Tp + (t0 + t) / pt) * Fp + f / pf) * C + c] * inv_win;
      }
      xs[p * CP + c] = xn;
      ds[p * CP + c] = dh;
    }
    __syncthreads();
    if (drop) {
      for (int e = 4 * tid; e < tpix * C; e += 4 * kThreads)
        mask4(ds, CP, C, e, tile_base, seed, threshold, keep_scale);
    }

    // lin = xn . W + b (reads xs and ws only: no barrier needed before it)
    float acc[8][NJ];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
    for (int ci = 0; ci < C; ++ci) {
      float a[8], wv[NJ];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = xs[(pg + 16 * i) * CP + ci];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int co = cg + 16 * j;
        wv[j] = co < C ? ws[ci * CP + co] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], wv[j], acc[i][j]);
    }
    __syncthreads();  // masked dh complete
    // gate term into acc, dlin over dh (each element owned by one thread)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int p = pg + 16 * i, co = cg + 16 * j;
        float gate = 0.0f;
        if (co < C) {
          const float sig = sigmoidf(xs[p * CP + co]);
          const float dh = ds[p * CP + co];
          gate = dh * (acc[i][j] + s_gb[co]) * sig * (1.0f - sig);
          ds[p * CP + co] = dh * sig;
        }
        acc[i][j] = gate;
      }
    __syncthreads();  // dlin complete

    // dxn = dlin . W^T + gate; thread holds (pixel pg + 16 i, channel cg + 16 j)
    for (int co = 0; co < C; ++co) {
      float a[8], wv[NJ];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = ds[(pg + 16 * i) * CP + co];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int ci = cg + 16 * j;
        wv[j] = ci < C ? ws[ci * CP + co] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], wv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = pg + 16 * i;
      if (p >= tpix) continue;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = cg + 16 * j;
        if (c >= C) continue;
        const float dxn = acc[i][j];
        const float xh = (yt[p * C + c] - s_mean[c]) * s_inv[c];
        s1[j] += dxn;
        s2[j] = fmaf(dxn, xh, s2[j]);
        dyp[tile_base + (long long)p * C + c] = s_inv[c] * s_scale[c] * dxn;
      }
    }

    // dW += xn^T . dlin, db += sum dlin; thread holds (ci = pg + 16 i, co = cg + 16 j)
    for (int p = 0; p < tpix; ++p) {
      float xv[NJ], dv[NJ];
#pragma unroll
      for (int i = 0; i < NJ; ++i) xv[i] = xs[p * CP + ((pg + 16 * i) < C ? pg + 16 * i : 0)];
#pragma unroll
      for (int j = 0; j < NJ; ++j) dv[j] = ds[p * CP + ((cg + 16 * j) < C ? cg + 16 * j : 0)];
#pragma unroll
      for (int i = 0; i < NJ; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) dw[i][j] = fmaf(xv[i], dv[j], dw[i][j]);
      if (pg == 0) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) dbv[j] += dv[j];
      }
    }
  }

  // the block's slot: dW and db straight from their owners, S1 and S2 after a
  // fixed-order sum over the 16 pixel groups
  const int slot = blockIdx.y * gridDim.x + blockIdx.x;
  float* ps = partials + (long long)slot * (C * C + 3 * C);
#pragma unroll
  for (int i = 0; i < NJ; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int ci = pg + 16 * i, co = cg + 16 * j;
      if (ci < C && co < C) ps[ci * C + co] = dw[i][j];
    }
  if (pg == 0) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (cg + 16 * j < C) ps[C * C + cg + 16 * j] = dbv[j];
  }
  __syncthreads();
  const int RW = 16 * NJ;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    red[(pg * 2 + 0) * RW + cg + 16 * j] = s1[j];
    red[(pg * 2 + 1) * RW + cg + 16 * j] = s2[j];
  }
  __syncthreads();
  for (int i = tid; i < 2 * C; i += kThreads) {
    const int which = i / C, c = i % C;
    float s = 0.0f;
    for (int g = 0; g < 16; ++g) s += red[(g * 2 + which) * RW + c];
    ps[C * C + C + which * C + c] = s;
  }
}

// dy = dy_partial - a - (y - mean) * b, in place over dy_partial (C % 4 == 0).
__global__ void __launch_bounds__(kThreads)
bn_bwd_fixup_kernel(const float4* __restrict__ y, float4* dyp, const float* __restrict__ a,
                    const float* __restrict__ b, const float* __restrict__ mean,
                    long long n4, int C) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n4; i += stride) {
    const int c = (int)((i * 4) % C);
    const float4 yv = y[i];
    float4 d = dyp[i];
    d.x = d.x - a[c] - (yv.x - mean[c]) * b[c];
    d.y = d.y - a[c + 1] - (yv.y - mean[c + 1]) * b[c + 1];
    d.z = d.z - a[c + 2] - (yv.z - mean[c + 2]) * b[c + 2];
    d.w = d.w - a[c + 3] - (yv.w - mean[c + 3]) * b[c + 3];
    dyp[i] = d;
  }
}

// --------------------------------------------------------------- statistics

// Block `blockIdx.x` sums rows [r0, r1) of y [rows, C] per channel in double
// and writes [C sums | C sums of squares] to its slot. A thread owns four
// neighbouring channels of every (kThreads / (C / 4))-th row (C % 4 == 0).
__global__ void __launch_bounds__(kThreads)
stats_kernel(const float4* __restrict__ y, double* __restrict__ partials, long long rows,
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
      const float4 v = y[r * lanes + lane];
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

size_t fwd_smem(int C) {
  return sizeof(float) * ((size_t)kPix * (C + 1) + (size_t)C * C + 5 * (size_t)C);
}

size_t bwd_smem(int C, int NJ) {
  return sizeof(float) * (2 * (size_t)kPix * (C + 1) + (size_t)C * (C + 1) + 5 * (size_t)C +
                          (size_t)16 * 2 * 16 * NJ);
}

template <int NJ>
int launch_fwd(const float* y, const float* scale, const float* bias, const float* mean,
               const float* var, const float* glu_w, const float* glu_b, float* out, int B,
               int T, int F, int C, int pt, int pf, float eps, int tiles_per_block,
               const long long* seed, uint32_t threshold, float keep_scale,
               cudaStream_t stream) {
  const size_t smem = fwd_smem(C);
  cudaError_t err = cudaFuncSetAttribute(bn_glu_pool_kernel<NJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = rows_per_tile(F, pt);
  const int n_tiles = (T + rows - 1) / rows;
  const dim3 grid((n_tiles + tiles_per_block - 1) / tiles_per_block, B);
  bn_glu_pool_kernel<NJ><<<grid, kThreads, smem, stream>>>(
      y, scale, bias, mean, var, glu_w, glu_b, out, T, F, C, pt, pf, eps, rows,
      tiles_per_block, seed, threshold, keep_scale);
  return (int)cudaGetLastError();
}

template <int NJ>
int launch_bwd(const float* y, const float* dout, const float* scale, const float* bias,
               const float* mean, const float* var, const float* glu_w, const float* glu_b,
               float* dyp, float* partials, float* sums, int B, int T, int F, int C, int pt,
               int pf, float eps, int tiles_per_block, const long long* seed,
               uint32_t threshold, float keep_scale, cudaStream_t stream) {
  const size_t smem = bwd_smem(C, NJ);
  cudaError_t err = cudaFuncSetAttribute(bn_glu_pool_bwd_kernel<NJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = rows_per_tile(F, pt);
  const int n_tiles = (T + rows - 1) / rows;
  const dim3 grid((n_tiles + tiles_per_block - 1) / tiles_per_block, B);
  bn_glu_pool_bwd_kernel<NJ><<<grid, kThreads, smem, stream>>>(
      y, dout, scale, bias, mean, var, glu_w, glu_b, dyp, partials, T, F, C, pt, pf, eps,
      rows, tiles_per_block, seed, threshold, keep_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_fold<float>(partials, sums, (int)(grid.x * grid.y), C * C + 3 * C, stream);
}

}  // namespace

extern "C" {

// Pixel tiles per clip (the wrapper sizes tiles_per_block from it).
int dcase_bn_glu_pool_tiles(int T, int F, int pt) {
  const int rows = rows_per_tile(F, pt);
  return (T + rows - 1) / rows;
}

// y: [B, T, F, C]; scale, bias, mean, var, glu_b: [C]; glu_w: [C, C] (in,
// out); out: [B, T/pt, F/pf, C]; all float32, contiguous. T % pt == 0,
// F % pf == 0, pt * F <= 128, C <= 128, C % 4 == 0
// (ops/fused_block.py:applicable). seed: one int64 in device memory;
// threshold 0 means no dropout, else keep iff bits >= threshold and scale the
// kept by keep_scale.
int dcase_bn_glu_pool(const void* y, const void* scale, const void* bias, const void* mean,
                      const void* var, const void* glu_w, const void* glu_b, void* out,
                      int B, int T, int F, int C, int pt, int pf, float eps,
                      const void* seed, unsigned int threshold, float keep_scale,
                      int tiles_per_block, void* stream) {
  const auto* yp = static_cast<const float*>(y);
  const auto* sc = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  const auto* mu = static_cast<const float*>(mean);
  const auto* va = static_cast<const float*>(var);
  const auto* gw = static_cast<const float*>(glu_w);
  const auto* gb = static_cast<const float*>(glu_b);
  const auto* sd = static_cast<const long long*>(seed);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (C <= 64)
    return launch_fwd<4>(yp, sc, bi, mu, va, gw, gb, o, B, T, F, C, pt, pf, eps,
                         tiles_per_block, sd, threshold, keep_scale, st);
  return launch_fwd<8>(yp, sc, bi, mu, va, gw, gb, o, B, T, F, C, pt, pf, eps,
                       tiles_per_block, sd, threshold, keep_scale, st);
}

// First backward pass. dout: [B, T/pt, F/pf, C]; dyp: [B, T, F, C];
// partials: [slots, C*C + 3C] with slots = B * ceil(tiles / tiles_per_block);
// sums: [C*C + 3C] = dW | db | S1 | S2, folded from the slots in slot order.
int dcase_bn_glu_pool_bwd(const void* y, const void* dout, const void* scale,
                          const void* bias, const void* mean, const void* var,
                          const void* glu_w, const void* glu_b, void* dyp, void* partials,
                          void* sums, int B, int T, int F, int C, int pt, int pf, float eps,
                          const void* seed, unsigned int threshold, float keep_scale,
                          int tiles_per_block, void* stream) {
  const auto* yp = static_cast<const float*>(y);
  const auto* dp = static_cast<const float*>(dout);
  const auto* sc = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  const auto* mu = static_cast<const float*>(mean);
  const auto* va = static_cast<const float*>(var);
  const auto* gw = static_cast<const float*>(glu_w);
  const auto* gb = static_cast<const float*>(glu_b);
  const auto* sd = static_cast<const long long*>(seed);
  auto* dy = static_cast<float*>(dyp);
  auto* pa = static_cast<float*>(partials);
  auto* su = static_cast<float*>(sums);
  auto st = static_cast<cudaStream_t>(stream);
  if (C <= 64)
    return launch_bwd<4>(yp, dp, sc, bi, mu, va, gw, gb, dy, pa, su, B, T, F, C, pt, pf, eps,
                         tiles_per_block, sd, threshold, keep_scale, st);
  return launch_bwd<8>(yp, dp, sc, bi, mu, va, gw, gb, dy, pa, su, B, T, F, C, pt, pf, eps,
                       tiles_per_block, sd, threshold, keep_scale, st);
}

// Second backward pass, in place over dyp. n: elements of y; C % 4 == 0.
int dcase_bn_bwd_fixup(const void* y, void* dyp, const void* a, const void* b,
                       const void* mean, long long n, int C, void* stream) {
  const long long n4 = n / 4;
  long long blocks = (n4 + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond 16 blocks per SM
  if (blocks < 1) blocks = 1;
  bn_bwd_fixup_kernel<<<(int)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(y), static_cast<float4*>(dyp),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(mean), n4, C);
  return (int)cudaGetLastError();
}

// y: [rows, C] float32 (C % 4 == 0, C <= 1024); partials: [blocks, 2C]
// float64 scratch; out: [2, C] float32 = sums | sums of squares.
int dcase_batch_stats(const void* y, void* partials, void* out, long long rows, int C,
                      int blocks, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const int groups = kThreads / (C / 4);
  const size_t smem = sizeof(double) * (size_t)groups * 2 * C;
  cudaError_t err = cudaFuncSetAttribute(
      stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long rows_per_block = (rows + blocks - 1) / blocks;
  stats_kernel<<<blocks, kThreads, smem, st>>>(static_cast<const float4*>(y),
                                               static_cast<double*>(partials), rows, C,
                                               rows_per_block);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_fold<double>(static_cast<const double*>(partials),
                                  static_cast<float*>(out), blocks, 2 * C, st);
}

}  // extern "C"
