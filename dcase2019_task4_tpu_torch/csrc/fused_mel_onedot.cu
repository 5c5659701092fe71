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
// Design: an SGEMM-class product on the FP32 FMAs (no TF32, no tensor
// cores) with the magnitude and the mel product fused into its epilogue.
// - Block tile: 128 frames of one clip x 256 basis columns, the cosine
//   columns of 128 bins and their 128 sine partners. 256 threads, each an
//   8 frames x (8 cosine + 8 sine) register tile of the same 8 bins, so the
//   magnitude needs no exchange between threads. Every k step feeds 128
//   FMAs a thread from six 16-byte shared loads (LDS.128): the frame slice
//   and the basis slice are both stored k-major, and a warp is 4 x 8
//   threads, so each quarter of it reads one broadcast float4 of the frames
//   and eight neighbouring float4 of the basis: no bank conflicts. (An
//   8 x 8 tile, 64 bins a block, fed 64 FMAs from four loads and ran 4-8 %
//   slower: PERF.md section 6.)
// - Staging: k slices of 32 window samples through a ring of three stages,
//   one barrier a slice. The basis slice arrives by cp.async (16 bytes a
//   copy where NB % 4 == 0, else 4), two slices ahead. The frame slice is
//   Toeplitz (frame t starts at sample t*hop, and hop = 511 is odd, so no
//   frame start is 16-byte aligned): float32 samples arrive by 4-byte
//   cp.async beside the basis; int16 ones are loaded into registers two
//   slices ahead, converted, and stored after the current slice has been
//   multiplied. The A row stride is 132 floats, so a warp's stores of one
//   slice hit each bank at most twice.
// - Registers: the 128 sums and the fragments take about 250 registers a
//   thread, one block an SM (8 warps), no spill.
// - Waves: the flagship's 7 frame tiles a clip x 24 clips alone would fill
//   the 132 SMs 1.3 times, so the bins are split across blocks too: 8
//   chunks of 128 bins, 1344 blocks (about 10 waves of one an SM). Blocks
//   that share a frame tile run next to each other (the chunk is the
//   fastest grid index), and the 16.8 MB basis stays in the 50 MB L2.
// - Epilogue: the block's [128, 128] magnitudes go to shared memory, and
//   each mel band the chunk's bins reach gets the chunk's share of its sum,
//   over the band's own bins only, written to the band's slot in a workspace
//   [B * T, slots] of partial mel sums. A band reaches at most a few
//   chunks (the mel matrix is banded: each bin feeds at most two bands), so
//   the slots of all chunks (ops/fused_mel.onedot_plan, built with the
//   basis) number 78 at 64 mels and 141 at 128: 6.5 MB of workspace at the
//   flagship shape, against 42 MB for one [B * T, M] slab per chunk.
//   onedot_fold_kernel then adds each band's chunk sums in chunk order: no
//   float atomics, so two calls on the same input give the same bits.

#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

#include "cp_async.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;           // frames per block
constexpr int kBins = 128;         // bins per block: 128 cosine and 128 sine columns
constexpr int kBN = 2 * kBins;     // basis columns per block
constexpr int kBK = 32;            // window samples (basis rows) per stage
constexpr int kStages = 3;         // the ring: two slices load while one multiplies
constexpr int kALoads = kBK * kBM / kThreads;  // frame samples a thread stages a slice
constexpr int kAS = kBM + 4;       // frame-slice row stride (floats)
constexpr int kBS = kBN;           // basis-slice row stride (floats)
constexpr int kStage = kBK * (kAS + kBS);  // floats a stage
constexpr int kMagS = kBins + 1;   // magnitude-tile row stride (floats)
constexpr size_t kSmem = sizeof(float) * kStages * kStage;
static_assert(kBM * kMagS <= kStages * kStage, "the magnitude tile reuses the stages");
static_assert(kThreads == 16 * (kBM / 8) && kThreads == 16 * (kBins / 8), "8 x 16 tiles");
static_assert(kALoads == 16 && kBK == 32, "frame-slice loads: two halves of 16 samples");

// float32 frames are staged by 4-byte cp.async like the basis; int16 ones
// through registers, where they are converted
template <typename In>
constexpr bool kAsyncFrames = std::is_same<In, float>::value;

// grid: (bin chunks, frame tiles of a clip, clips). chunks [n_chunks, 3]:
// first band, band count, slot offset; bands [M, 4]: first bin, end bin,
// first chunk, end chunk. ws: [B * T, slots]. Each clip holds the
// (T - 1) * hop + n_fft samples its frames read. The samples enter the
// product unscaled and the magnitudes are scaled by in_scale (int16:
// 2^-15, a power of two, so the result is that of scaling each sample).
template <typename In>
__global__ void __launch_bounds__(kThreads, 1)
fused_stft_mel_onedot_kernel(const In* __restrict__ audio, long long clip_stride, float in_scale,
                             const float* __restrict__ dft,
                             const float* __restrict__ melfb, const int* __restrict__ chunks,
                             const int* __restrict__ bands, float* __restrict__ ws, int slots, int T,
                             int hop, int n_fft, int NB, int M, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int chunk = blockIdx.x, kc = chunk * kBins;
  const int t0 = blockIdx.y * kBM;
  const int b = blockIdx.z;
  const In* clip = audio + (long long)b * clip_stride;
  const long long NB2 = 2LL * NB;
  const int n_slices = (n_fft + kBK - 1) / kBK;

  // frame-slice loads: thread -> samples ak and 16 + ak of frames af + 16 q;
  // a frame past T (the last tile's) reads frame T - 1, and its sums are
  // never stored
  const int ak = tid % 16, af = tid / 16;
  const In* aclip = clip + ak;
  int aoff[kALoads / 2];  // a frame's first sample (at most T * hop: an int)
#pragma unroll
  for (int q = 0; q < kALoads / 2; ++q) aoff[q] = min(t0 + af + 16 * q, T - 1) * hop;
  float areg[kALoads];
  auto load_a = [&](int s) {
    const int n = s * kBK;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool in = n + 16 * h + ak < n_fft;
#pragma unroll
      for (int q = 0; q < kALoads / 2; ++q)
        areg[2 * q + h] = in ? static_cast<float>(aclip[aoff[q] + n + 16 * h]) : 0.0f;
    }
  };
  auto store_a = [&](int buf) {
    float* as = smem + buf * kStage;
#pragma unroll
    for (int j = 0; j < kALoads; ++j) as[(ak + 16 * (j % 2)) * kAS + af + 16 * (j / 2)] = areg[j];
  };
  auto copy_a = [&](int s, int buf) {  // float32: straight into the stage
    float* as = smem + buf * kStage;
    const int n = s * kBK;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool in = n + 16 * h + ak < n_fft;
#pragma unroll
      for (int q = 0; q < kALoads / 2; ++q)
        cp_async4(as + (ak + 16 * h) * kAS + af + 16 * q, aclip + aoff[q] + n + 16 * h, in ? 4 : 0);
    }
  };
  // basis slice s: rows s*kBK.., this chunk's cosine columns then its sine columns
  auto load_b = [&](int s, int buf) {
    float* bs = smem + buf * kStage + kBK * kAS;
    const int n0 = s * kBK;
    if (vec) {
      for (int e = tid; e < kBK * kBN / 4; e += kThreads) {
        const int r = e / (kBN / 4), c = 4 * (e % (kBN / 4));
        const int bin = kc + c % kBins;
        const bool ok = n0 + r < n_fft && bin < NB;  // NB % 4 == 0: all four or none
        const float* src = ok ? dft + (long long)(n0 + r) * NB2 + (c < kBins ? 0 : NB) + bin : dft;
        cp_async16(bs + r * kBS + c, src, ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < kBK * kBN; e += kThreads) {
        const int r = e / kBN, c = e % kBN;
        const int bin = kc + c % kBins;
        const bool ok = n0 + r < n_fft && bin < NB;
        const float* src = ok ? dft + (long long)(n0 + r) * NB2 + (c < kBins ? 0 : NB) + bin : dft;
        cp_async4(bs + r * kBS + c, src, ok ? 4 : 0);
      }
    }
  };

  // product mapping: thread (ty, tx) -> frames 4 ty + i and 64 + 4 ty + i,
  // cosine columns 4 tx + j and their sine partners 64 + 4 tx + j (bins 4 tx
  // + j); a warp is 4 ty x 8 tx, so each quarter of it reads one broadcast
  // float4 of the frames and eight neighbouring float4 of the basis
  const int warp = tid / 32, lane = tid % 32;
  const int ty = (warp % 4) * 4 + lane / 8, tx = (warp / 4) * 8 + lane % 8;
  float acc[8][16];  // [frame][column: 8 cosine (bins 4 tx + j, 64 + 4 tx + j), then their 8 sine]
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_slices) {
      load_b(s, s);
      if constexpr (kAsyncFrames<In>) {
        copy_a(s, s);
      } else {
        load_a(s);
        store_a(s);
      }
    }
    cp_async_commit();
  }
  for (int s = 0; s < n_slices; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slice s landed; every thread is done with slice s - 1's stage
    const int ahead = s + kStages - 1;
    const bool more = ahead < n_slices;
    if (more) {
      load_b(ahead, ahead % kStages);
      if constexpr (kAsyncFrames<In>)
        copy_a(ahead, ahead % kStages);
      else
        load_a(ahead);  // into registers: the loads fly while this slice multiplies
    }
    cp_async_commit();
    const float* as = smem + (s % kStages) * kStage;
    const float* bs = as + kBK * kAS;
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + k * kAS + 4 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(as + k * kAS + kBM / 2 + 4 * ty);
      const float* br = bs + k * kBS + 4 * tx;
      const float4 b0 = *reinterpret_cast<const float4*>(br);
      const float4 b1 = *reinterpret_cast<const float4*>(br + kBins / 2);
      const float4 b2 = *reinterpret_cast<const float4*>(br + kBins);
      const float4 b3 = *reinterpret_cast<const float4*>(br + kBins + kBins / 2);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[16] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w,
                            b2.x, b2.y, b2.z, b2.w, b3.x, b3.y, b3.z, b3.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 16; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (!kAsyncFrames<In> && more) store_a(ahead % kStages);  // its last reader passed this slice's barrier
  }

  // epilogue: magnitudes into shared memory (over the stages), then this
  // chunk's share of each band it reaches
  cp_async_wait_all();
  __syncthreads();
  float* mag = smem;  // [kBM][kMagS]
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int f = (i < 4 ? 0 : kBM / 2) + 4 * ty + i % 4;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      mag[f * kMagS + (j < 4 ? 0 : kBins / 2) + 4 * tx + j % 4] =
          in_scale * sqrtf(acc[i][j] * acc[i][j] + acc[i][8 + j] * acc[i][8 + j]);
  }
  __syncthreads();
  const int m_lo = chunks[3 * chunk], n_bands = chunks[3 * chunk + 1], off = chunks[3 * chunk + 2];
  for (int o = tid; o < kBM * n_bands; o += kThreads) {
    const int f = o / n_bands, m = m_lo + o % n_bands;
    if (t0 + f >= T) continue;
    const int lo = max(bands[4 * m], kc), hi = min(bands[4 * m + 1], kc + kBins);
    float s = 0.0f;
    for (int k = lo; k < hi; ++k) s = fmaf(mag[f * kMagS + k - kc], melfb[(long long)k * M + m], s);
    ws[((long long)b * T + t0 + f) * slots + off + (m - m_lo)] = s;
  }
}

// out[g, m] = sum over the chunks c that reach band m, in chunk order, of
// ws[g, slot of (c, m)]
__global__ void __launch_bounds__(kThreads)
onedot_fold_kernel(const float* __restrict__ ws, const int* __restrict__ chunks,
                   const int* __restrict__ bands, float* __restrict__ out, long long n_out, int M,
                   int slots) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n_out) return;
  const long long g = idx / M;
  const int m = (int)(idx % M);
  const float* row = ws + g * slots;
  float s = 0.0f;
  for (int c = bands[4 * m + 2]; c < bands[4 * m + 3]; ++c) s += row[chunks[3 * c + 2] + m - chunks[3 * c]];
  out[idx] = s;
}

template <typename In>
int launch(const void* audio, long long clip_stride, float in_scale, const float* dft,
           const float* melfb, const int* chunks, const int* bands, float* ws, int slots, float* out,
           int B, int T, int hop, int n_fft, int NB, int M, cudaStream_t stream) {
  if (M < 1 || NB < 1 || slots < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(fused_stft_mel_onedot_kernel<In>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  const int vec = NB % 4 == 0 && (reinterpret_cast<uintptr_t>(dft) & 15) == 0;
  const dim3 grid((NB + kBins - 1) / kBins, (T + kBM - 1) / kBM, B);
  fused_stft_mel_onedot_kernel<In><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const In*>(audio), clip_stride, in_scale, dft, melfb, chunks, bands, ws,
      slots, T, hop, n_fft, NB, M, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n_out = (long long)B * T * M;
  onedot_fold_kernel<<<(unsigned)((n_out + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      ws, chunks, bands, out, n_out, M, slots);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// audio: B clips of clip_len >= (T - 1) * hop + n_fft contiguous samples
// (the wrapper checks it), clip_stride samples apart, int16 (in_is_int16 =
// 1) or float32. dft: [n_fft, 2 * NB] windowed cosine |
// sine basis; melfb: [NB, M]; chunks [ceil(NB / 64), 3] and bands [M, 4]
// int32, the plan of ops/fused_mel.onedot_plan; ws: [B * T, slots] float32
// scratch; out: [B, T, M]; all contiguous.
int dcase_fused_stft_mel_onedot(const void* audio, int in_is_int16, long long clip_stride,
                                long long clip_len, const void* dft, const void* melfb,
                                const void* chunks, const void* bands, void* ws, int slots,
                                void* out, int B, int T, int hop, int n_fft, int NB, int M,
                                void* stream) {
  const auto* d = static_cast<const float*>(dft);
  const auto* fb = static_cast<const float*>(melfb);
  const auto* ch = static_cast<const int*>(chunks);
  const auto* bd = static_cast<const int*>(bands);
  auto* w = static_cast<float*>(ws);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (clip_len < (long long)(T - 1) * hop + n_fft) return (int)cudaErrorInvalidValue;
  if (in_is_int16)
    return launch<int16_t>(audio, clip_stride, 1.0f / 32768.0f, d, fb, ch, bd, w, slots, o, B, T, hop,
                           n_fft, NB, M, st);
  return launch<float>(audio, clip_stride, 1.0f, d, fb, ch, bd, w, slots, o, B, T, hop, n_fft, NB, M,
                       st);
}

}  // extern "C"
