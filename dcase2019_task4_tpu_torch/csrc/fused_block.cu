// K2 forward, eval mode: BatchNorm (running statistics) -> GLU -> average
// pool, fused, float32, for Hopper (sm_90a).
//
// Replaces: dcase2019_task4_tpu/ops/fused_block.py:_fwd_kernel (via
// _fwd_pallas / fused_bn_glu_dropout_pool with train=False, rate=0), the
// Pallas kernel that runs each CRNN block's post-conv chain in one pass.
// The lane packing (kron(I_k, W), 0/1 pooling matrices on the MXU) is TPU
// layout and is not carried over: this kernel works on plain NHWC.
//
// Function, per pixel of y [B, T, F, C]:
//   xn = (y - mean) * rsqrt(var + eps) * scale + bias
//   g[co] = (sum_ci xn[ci] * W[ci, co] + b[co]) * sigmoid(xn[co])
// then the mean of g over each (pt, pf) window -> out [B, T/pt, F/pf, C].
//
// Bound: at block 1 of the flagship shape (y = [24, 864, 64, 64], 340 MB)
// the read of y takes about 0.1 ms at 3.35 TB/s, and the GLU's 64x64
// channel mix is 10.9 GFLOP, about 0.16 ms at the 67 TFLOP/s FP32 peak of
// the CUDA cores. In plain FP32 the channel mix is therefore the limit;
// once it moves to the tensor cores the kernel is bound by the one read of
// y, which is the point of the fusion on both machines.
//
// Design: one block per (run of pixel tiles, clip). A pixel tile is a
// whole number of pooling rows (pt time rows x F) holding up to 128
// pixels; the tiles of a block are consecutive in time, so the block loads
// W (16 KB at C = 64) and the per-channel vectors into shared memory once.
// Per tile: read the [rows, F, C] slab once, normalise it into shared
// memory (pixel stride C + 1 against bank conflicts), mix channels with
// each thread holding 8 pixels x 4 channels (8 when C > 64) in registers,
// gate, write g back over the slab, and average each pooling window from
// there. Only the pooled tile is written; the full-resolution GLU output
// never reaches device memory. Plain FP32 FMAs: no TF32, no tensor cores
// yet.
//
// Train mode (dropout from a counter-based generator keyed on the element
// index, batch statistics) and the backward kernels are later work; the
// Python wrapper refuses a dropout rate other than 0.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 128;  // pixels per tile

// Time rows per tile: whole pooling rows, up to kPix pixels (pt * F <= kPix).
int rows_per_tile(int F, int pt) { return pt * (kPix / (pt * F)); }

// NJ: output channels per thread / 16 (C <= 16 * NJ).
template <int NJ>
__global__ void __launch_bounds__(kThreads)
bn_glu_pool_eval_kernel(const float* __restrict__ y, const float* __restrict__ scale,
                        const float* __restrict__ bias, const float* __restrict__ mean,
                        const float* __restrict__ var, const float* __restrict__ glu_w,
                        const float* __restrict__ glu_b, float* __restrict__ out, int T,
                        int F, int C, int pt, int pf, float eps, int rows,
                        int tiles_per_block) {
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
    const float* yt = y + ((long long)b * T + t0) * F * C;

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
          g[i][j] = (acc[i][j] + s_gb[co]) * (1.0f / (1.0f + expf(-xn)));
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

template <int NJ>
int launch(const float* y, const float* scale, const float* bias, const float* mean,
           const float* var, const float* glu_w, const float* glu_b, float* out, int B,
           int T, int F, int C, int pt, int pf, float eps, int tiles_per_block,
           size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(bn_glu_pool_eval_kernel<NJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = rows_per_tile(F, pt);
  const int n_tiles = (T + rows - 1) / rows;
  const dim3 grid((n_tiles + tiles_per_block - 1) / tiles_per_block, B);
  bn_glu_pool_eval_kernel<NJ><<<grid, kThreads, smem, stream>>>(
      y, scale, bias, mean, var, glu_w, glu_b, out, T, F, C, pt, pf, eps, rows,
      tiles_per_block);
  return (int)cudaGetLastError();
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
// F % pf == 0, pt * F <= 128 and C <= 128 (ops/fused_block.py:applicable).
int dcase_bn_glu_pool_eval(const void* y, const void* scale, const void* bias,
                           const void* mean, const void* var, const void* glu_w,
                           const void* glu_b, void* out, int B, int T, int F, int C,
                           int pt, int pf, float eps, int tiles_per_block,
                           void* stream) {
  const size_t smem = sizeof(float) * ((size_t)kPix * (C + 1) + (size_t)C * C + 5 * (size_t)C);
  const auto* yp = static_cast<const float*>(y);
  const auto* sc = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  const auto* mu = static_cast<const float*>(mean);
  const auto* va = static_cast<const float*>(var);
  const auto* gw = static_cast<const float*>(glu_w);
  const auto* gb = static_cast<const float*>(glu_b);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (C <= 64)
    return launch<4>(yp, sc, bi, mu, va, gw, gb, o, B, T, F, C, pt, pf, eps,
                     tiles_per_block, smem, st);
  return launch<8>(yp, sc, bi, mu, va, gw, gb, o, B, T, F, C, pt, pf, eps,
                   tiles_per_block, smem, st);
}

}  // extern "C"
