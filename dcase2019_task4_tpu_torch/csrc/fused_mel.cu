// K1: fused STFT -> magnitude -> mel, float32, for Hopper (sm_90a).
//
// Replaces: dcase2019_task4_tpu/ops/fused_mel.py:_kernel (via fused_stft_mel),
// the Pallas kernel that turns hop-row audio chunks into a linear mel
// spectrogram without writing frames or the spectrum to memory.
//
// Function: for clip b and frame t, the frame is the n_fft samples that
// start at t*hop in the clip's flattened hop-row buffer (librosa framing
// after the centre padding). With windowed real-DFT bases cos/sin
// [n_fft, NB] (NB = bins the mel matrix reads) and the mel matrix [NB, M]:
//   re[t,k] = sum_n x[t*hop+n] cos[n,k],  im[t,k] = sum_n x[t*hop+n] sin[n,k]
//   mel[t,m] = sum_k sqrt(re^2 + im^2) mel_fb[k,m]
//
// Bound: compute. At the flagship shape (B=24, T=864, n_fft=2048, NB=1024)
// the DFT is 24*864*2048*1024*2*2 ~ 174 GFLOP per batch, against ~42 MB
// of audio in and 5 MB of mel out, so the FP32 FMA rate of the CUDA cores
// is the limit (about 67 TFLOP/s at 700 W).
//
// Design: one block per (frame tile of TT frames, clip). The block stages
// the tile's audio span ((TT-1)*hop + n_fft samples, int16 dequantized on
// load) in shared memory once, then walks the bins in chunks of KB. For
// each chunk it accumulates re and im in registers (each thread owns 4
// frames x 4 bins of both) over the window in stages of NK basis rows that
// are staged in shared memory, takes the magnitude into a small shared
// tile, and adds the chunk's contribution to the [TT, M] mel tile that
// lives in registers for the whole block. The spectrum never reaches
// device memory. The bases (16 MB) are re-read by every block and stay in
// the 50 MB L2. Plain FP32 FMAs: no TF32, no tensor cores yet.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTT = 32;         // frames per block
constexpr int kKB = 128;        // bins per chunk
constexpr int kNK = 16;         // basis rows per shared-memory stage
constexpr int kMelPerThread = 16;  // kTT * M <= kThreads * 16  =>  M <= 128

__device__ __forceinline__ float load_sample(const float* p, float) { return *p; }
__device__ __forceinline__ float load_sample(const int16_t* p, float scale) {
  return static_cast<float>(*p) * scale;
}

template <typename In>
__global__ void __launch_bounds__(kThreads)
fused_stft_mel_kernel(const In* __restrict__ audio, long long clip_stride,
                      long long clip_len, float in_scale, const float* __restrict__ cosb,
                      const float* __restrict__ sinb,
                      const float* __restrict__ melfb, float* __restrict__ out,
                      int T, int hop, int n_fft, int NB, int M) {
  extern __shared__ float smem[];
  const int span = (kTT - 1) * hop + n_fft;
  float* xs = smem;                  // [span] audio of this frame tile
  float* cs = xs + span;             // [kNK][kKB] cos stage
  float* ss = cs + kNK * kKB;        // [kNK][kKB] sin stage
  float* mag = ss + kNK * kKB;       // [kTT][kKB] magnitude of one chunk

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kTT;
  const int b = blockIdx.y;
  const In* clip = audio + (long long)b * clip_stride;

  const long long start = (long long)t0 * hop;
  for (int i = tid; i < span; i += kThreads) {
    const long long idx = start + i;
    xs[i] = idx < clip_len ? load_sample(clip + idx, in_scale) : 0.0f;
  }

  // DFT mapping: warp ty owns frames ty + 8*i, lane tx owns bins tx + 32*j.
  const int ty = tid / 32;
  const int tx = tid % 32;

  float mel_acc[kMelPerThread];
#pragma unroll
  for (int q = 0; q < kMelPerThread; ++q) mel_acc[q] = 0.0f;

  for (int kc = 0; kc < NB; kc += kKB) {
    float re[4][4], im[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = 0.0f;

    for (int n0 = 0; n0 < n_fft; n0 += kNK) {
      __syncthreads();  // previous stage fully read (and xs staged)
      for (int i = tid; i < kNK * kKB; i += kThreads) {
        const int r = i / kKB, c = i % kKB;
        const int n = n0 + r, k = kc + c;
        const bool ok = n < n_fft && k < NB;
        cs[i] = ok ? cosb[(long long)n * NB + k] : 0.0f;
        ss[i] = ok ? sinb[(long long)n * NB + k] : 0.0f;
      }
      __syncthreads();
      const int rows = min(kNK, n_fft - n0);
      for (int r = 0; r < rows; ++r) {
        float xv[4], cv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = xs[(ty + 8 * i) * hop + n0 + r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          cv[j] = cs[r * kKB + tx + 32 * j];
          sv[j] = ss[r * kKB + tx + 32 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            re[i][j] = fmaf(xv[i], cv[j], re[i][j]);
            im[i][j] = fmaf(xv[i], sv[j], im[i][j]);
          }
      }
    }

    // mag is free: the last reader was the previous chunk's mel loop, and
    // the stage loop above synchronised after it.
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mag[(ty + 8 * i) * kKB + tx + 32 * j] =
            sqrtf(re[i][j] * re[i][j] + im[i][j] * im[i][j]);
    __syncthreads();

    const int kn = min(kKB, NB - kc);
#pragma unroll
    for (int q = 0; q < kMelPerThread; ++q) {
      const int o = tid + q * kThreads;
      if (o < kTT * M) {
        const int f = o / M, m = o % M;
        const float* mrow = mag + f * kKB;
        const float* fb = melfb + (long long)kc * M + m;
        float acc = mel_acc[q];
        for (int k = 0; k < kn; ++k) acc = fmaf(mrow[k], fb[(long long)k * M], acc);
        mel_acc[q] = acc;
      }
    }
  }

#pragma unroll
  for (int q = 0; q < kMelPerThread; ++q) {
    const int o = tid + q * kThreads;
    if (o < kTT * M) {
      const int f = o / M, m = o % M;
      if (t0 + f < T) out[((long long)b * T + t0 + f) * M + m] = mel_acc[q];
    }
  }
}

template <typename In>
int launch(const void* audio, long long clip_stride, long long clip_len, float in_scale,
           const float* cosb, const float* sinb, const float* melfb, float* out,
           int B, int T, int hop, int n_fft, int NB, int M, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(kTT - 1) * hop + n_fft + 2 * kNK * kKB + kTT * kKB);
  cudaError_t err = cudaFuncSetAttribute(fused_stft_mel_kernel<In>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + kTT - 1) / kTT, B);
  fused_stft_mel_kernel<In><<<grid, kThreads, smem, stream>>>(
      static_cast<const In*>(audio), clip_stride, clip_len, in_scale, cosb, sinb, melfb, out,
      T, hop, n_fft, NB, M);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes (the wrapper checks it against the
// device limit before launching).
long long dcase_fused_stft_mel_smem(int hop, int n_fft) {
  return (long long)sizeof(float) *
         ((long long)(kTT - 1) * hop + n_fft + 2 * kNK * kKB + kTT * kKB);
}

int dcase_fused_stft_mel_max_mels() { return kThreads * kMelPerThread / kTT; }

// audio: B clips of clip_len contiguous samples, clip_stride samples apart,
// int16 (in_is_int16 = 1) or float32. cosb, sinb: [n_fft, NB];
// melfb: [NB, M]; out: [B, T, M]; all float32, contiguous.
int dcase_fused_stft_mel(const void* audio, int in_is_int16, long long clip_stride,
                         long long clip_len,
                         const void* cosb, const void* sinb, const void* melfb,
                         void* out, int B, int T, int hop, int n_fft, int NB, int M,
                         void* stream) {
  const auto* c = static_cast<const float*>(cosb);
  const auto* s = static_cast<const float*>(sinb);
  const auto* fb = static_cast<const float*>(melfb);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (in_is_int16)
    return launch<int16_t>(audio, clip_stride, clip_len, 1.0f / 32768.0f, c, s, fb, o, B, T, hop,
                           n_fft, NB, M, st);
  return launch<float>(audio, clip_stride, clip_len, 1.0f, c, s, fb, o, B, T, hop, n_fft, NB,
                       M, st);
}

}  // extern "C"
