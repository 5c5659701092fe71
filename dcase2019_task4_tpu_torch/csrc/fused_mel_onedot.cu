// K1, the fused cos||sin variant: STFT -> magnitude -> mel through one
// windowed DFT basis, float32, for Hopper (sm_90a).
//
// Replaces: dcase2019_task4_tpu/ops/fused_mel.py:_kernel_onedot (via
// fused_stft_mel with OnedotBases), the Pallas kernel that
// DCASE_FUSED_MEL_ONEDOT=1 selects (ops/mel.py:245): per frame tile, one
// [tt, hop] x [hop, 2*NB] product per hop part against the cos||sin basis,
// the re/im split at NB, the magnitude and the mel product.
//
// Function: for clip b and frame t, the frame is the n_fft samples that
// start at t*hop in the clip's flattened hop-row buffer (librosa framing
// after the centre padding). With the windowed basis dft [n_fft, 2*NB]
// (columns 0..NB-1 cosine, NB..2NB-1 sine; NB = bins the mel matrix reads)
// and the mel matrix [NB, M]:
//   reim[t, j] = sum_n x[t*hop + n] dft[n, j]
//   mel[t, m]  = sum_k sqrt(reim[t, k]^2 + reim[t, NB + k]^2) mel_fb[k, m]
//
// Bound: operations. At the flagship shape (B = 24, T = 864, n_fft = 2048,
// NB = 1024) the product is 24 * 864 * 2048 * 2048 * 2 = 174 GFLOP a batch
// against 42 MB of audio, the 16 MB basis and 5 MB of mel, so the FP32 FMA
// rate of the CUDA cores (67 TFLOP/s at 700 W) is the limit: 2.6 ms. The FFT
// kernel (fused_mel.cu) computes the same function in a tenth of the
// operations; this kernel exists because the JAX package has this variant.
//
// Design: one block per (frame tile of kTT frames, clip). The block stages
// the tile's audio span ((kTT - 1) * hop + n_fft samples, int16 dequantized
// on load) in shared memory once, then walks the bins in chunks of kKB. For
// each chunk it accumulates the chunk's 2 * kKB columns of the fused basis
// (kKB cosine columns and their kKB sine partners) in ONE register tile
// (each thread: 4 frames x (4 + 4) columns) over the window, in stages of
// kNK basis rows staged in shared memory; then it splits the tile at kKB,
// takes the magnitude into a small shared tile and adds the chunk's share
// to the [kTT, M] mel tile, which lives in registers for the whole block.
// The spectrum never reaches device memory; the basis is re-read by every
// block from the 50 MB L2. Plain FP32 FMAs: no TF32, no tensor cores.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTT = 32;            // frames per block
constexpr int kKB = 128;           // bins per chunk (2 * kKB basis columns)
constexpr int kNK = 16;            // basis rows per shared-memory stage
constexpr int kMelPerThread = 16;  // kTT * M <= kThreads * 16  =>  M <= 128
constexpr size_t kMaxSmem = 232448;

__device__ __forceinline__ float load_sample(const float* p, float) { return *p; }
__device__ __forceinline__ float load_sample(const int16_t* p, float scale) {
  return static_cast<float>(*p) * scale;
}

size_t smem_bytes(int hop, int n_fft) {
  return sizeof(float) * ((size_t)(kTT - 1) * hop + n_fft + (size_t)kNK * 2 * kKB + (size_t)kTT * kKB);
}

template <typename In>
__global__ void __launch_bounds__(kThreads)
fused_stft_mel_onedot_kernel(const In* __restrict__ audio, long long clip_stride, long long clip_len,
                             float in_scale, const float* __restrict__ dft,
                             const float* __restrict__ melfb, float* __restrict__ out, int T,
                             int hop, int n_fft, int NB, int M) {
  extern __shared__ float smem[];
  const int span = (kTT - 1) * hop + n_fft;
  float* xs = smem;               // [span] audio of this frame tile
  float* bs = xs + span;          // [kNK][2 * kKB] basis stage: cosine | sine columns
  float* mag = bs + kNK * 2 * kKB;  // [kTT][kKB] magnitude of one chunk

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kTT;
  const int b = blockIdx.y;
  const In* clip = audio + (long long)b * clip_stride;
  const long long NB2 = 2LL * NB;

  const long long start = (long long)t0 * hop;
  for (int i = tid; i < span; i += kThreads) {
    const long long idx = start + i;
    xs[i] = idx < clip_len ? load_sample(clip + idx, in_scale) : 0.0f;
  }

  // product mapping: warp ty owns frames ty + 8 i, lane tx owns chunk bins
  // tx + 32 j: columns tx + 32 j (cosine) and kKB + tx + 32 j (sine)
  const int ty = tid / 32;
  const int tx = tid % 32;

  float mel_acc[kMelPerThread];
#pragma unroll
  for (int q = 0; q < kMelPerThread; ++q) mel_acc[q] = 0.0f;

  for (int kc = 0; kc < NB; kc += kKB) {
    float acc[4][8];  // [frame i][column: 4 cosine, then 4 sine]
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

    for (int n0 = 0; n0 < n_fft; n0 += kNK) {
      __syncthreads();  // previous stage fully read (and xs staged)
      for (int i = tid; i < kNK * 2 * kKB; i += kThreads) {
        const int r = i / (2 * kKB), c = i % (2 * kKB);
        const int n = n0 + r, k = kc + (c % kKB);
        const bool ok = n < n_fft && k < NB;
        bs[i] = ok ? dft[(long long)n * NB2 + (c < kKB ? k : NB + k)] : 0.0f;
      }
      __syncthreads();
      const int rows = min(kNK, n_fft - n0);
      for (int r = 0; r < rows; ++r) {
        float xv[4], bv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = xs[(ty + 8 * i) * hop + n0 + r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bv[j] = bs[r * 2 * kKB + tx + 32 * j];
          bv[4 + j] = bs[r * 2 * kKB + kKB + tx + 32 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
      }
    }

    // split at kKB: mag is free (its last reader was the previous chunk's mel
    // loop, and the stage loop above synchronised after it)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mag[(ty + 8 * i) * kKB + tx + 32 * j] =
            sqrtf(acc[i][j] * acc[i][j] + acc[i][4 + j] * acc[i][4 + j]);
    __syncthreads();

    const int kn = min(kKB, NB - kc);
#pragma unroll
    for (int q = 0; q < kMelPerThread; ++q) {
      const int o = tid + q * kThreads;
      if (o < kTT * M) {
        const int f = o / M, m = o % M;
        const float* mrow = mag + f * kKB;
        const float* fb = melfb + (long long)kc * M + m;
        float s = mel_acc[q];
        for (int k = 0; k < kn; ++k) s = fmaf(mrow[k], fb[(long long)k * M], s);
        mel_acc[q] = s;
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
           const float* dft, const float* melfb, float* out, int B, int T, int hop, int n_fft,
           int NB, int M, cudaStream_t stream) {
  const size_t smem = smem_bytes(hop, n_fft);
  if (smem > kMaxSmem || M < 1 || M > kThreads * kMelPerThread / kTT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(fused_stft_mel_onedot_kernel<In>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + kTT - 1) / kTT, B);
  fused_stft_mel_onedot_kernel<In><<<grid, kThreads, smem, stream>>>(
      static_cast<const In*>(audio), clip_stride, clip_len, in_scale, dft, melfb, out, T, hop, n_fft,
      NB, M);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// audio: B clips of clip_len contiguous samples, clip_stride samples apart,
// int16 (in_is_int16 = 1) or float32. dft: [n_fft, 2 * NB] windowed cosine |
// sine basis; melfb: [NB, M] (M <= 128); out: [B, T, M]; all float32,
// contiguous. Returns cudaErrorInvalidValue when the frame tile's audio span
// ((32 - 1) * hop + n_fft samples) does not fit the block's shared memory.
int dcase_fused_stft_mel_onedot(const void* audio, int in_is_int16, long long clip_stride,
                                long long clip_len, const void* dft, const void* melfb, void* out,
                                int B, int T, int hop, int n_fft, int NB, int M, void* stream) {
  const auto* d = static_cast<const float*>(dft);
  const auto* fb = static_cast<const float*>(melfb);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (in_is_int16)
    return launch<int16_t>(audio, clip_stride, clip_len, 1.0f / 32768.0f, d, fb, o, B, T, hop, n_fft,
                           NB, M, st);
  return launch<float>(audio, clip_stride, clip_len, 1.0f, d, fb, o, B, T, hop, n_fft, NB, M, st);
}

}  // extern "C"
