// K1: fused STFT -> magnitude -> mel, float32, for Hopper (sm_90a).
//
// Replaces: dcase2019_task4_tpu/ops/fused_mel.py:_kernel (via fused_stft_mel),
// the Pallas kernel that turns hop-row audio chunks into a linear mel
// spectrogram without writing frames or the spectrum to memory.
//
// Function: for clip b and frame t, the frame is the n_fft samples that
// start at t*hop in the clip's flattened hop-row buffer (librosa framing
// after the centre padding). With the symmetric Hamming window w, the real
// DFT X[k] of the windowed frame for the NB bins the mel matrix reads, and
// the mel matrix [NB, M]:
//   mel[t,m] = sum_k |X[k]| mel_fb[k,m]
//
// Algorithm: the TPU kernel computes X as two DFT products on the MXU (the
// only unit it has for this), 4*n_fft*NB flops a frame. Here a frame is a
// real FFT: pack z[m] = w[2m]x[2m] + i w[2m+1]x[2m+1] (N = n_fft/2 points),
// take the N-point complex FFT Z in shared memory (Stockham passes, see
// Design), and split
//   X[k] = (Z[k] + conj Z[N-k])/2 - i e^{-2 pi i k/n_fft} (Z[k] - conj Z[N-k])/2,
// with Z[N] = Z[0]. The mel matrix is triangles (at most 2 nonzeros a bin,
// 1982 of 1024 x 64 at the flagship shape), so each output is a short sum
// over its band from a table built on the host: first bin, length and the
// float32 weights of mel_fb itself (skipped entries are exact zeros).
// Twiddles come from a host table built in float64 (the radix-16 split's own
// from float32 literals); no fast-math intrinsics.
//
// Bound: operations, counted conventionally: 2.5 n_fft log2 n_fft flops a
// frame for the real transform, 4 NB for the magnitude and 2 nnz(mel_fb)
// for the band sums, about 1.34 GFLOP a batch of 24 x 864 frames (0.020 ms
// at 67 TFLOP/s), against 47.9 MB of float32 audio and mel (0.014 ms; int16
// audio 26.6 MB). The DFT-as-matmul kernel that this design replaced did
// 176.7 GFLOP of FMAs and took 10.40 ms by CUDA events, 10.28 ms on the
// device, on an H100 at 700 W. An FFT does so little arithmetic that what
// limits it is the shared-memory passes: every pass reads and writes each
// point once (plus its twiddles), with a block-wide barrier after each.
//
// Design: one block per (tile of TT frames, clip). The block stages the
// tile's audio span ((TT-1)*hop + n_fft samples, int16 dequantized on
// load, coalesced) and the twiddles of its FFT passes in shared memory
// once. It then transforms the tile in rounds of FR = kPoints / N frames
// (4 at n_fft 2048). The passes are radix 16 where they can be (a 4 x 4
// split in registers) and radix 4 last, so 1024 points take three passes
// (16, 16, 4) and six barriers a round: each pass reads its points into
// registers (16 a thread), syncs, and writes them back in place, so one
// 34 KB buffer serves the round; the first pass reads the windowed samples
// straight from the staged audio, and a pad slot after every 16 points
// keeps the radix-16 writes off a single bank. The last pass gives each
// thread the butterflies j and N/4 - j, which hold the partners Z[k] and
// Z[N-k] of the real split, so it writes magnitudes, not points: they
// overwrite the buffer, and the band sums read them there (a thread sums
// a short band and a long one): the spectrum never reaches device memory.
// Registers bound the occupancy: 16 points a thread and the 4 x 4 split
// need more than the 80 registers that three blocks an SM would leave, so
// the kernel asks for two (128 registers); TT is then the largest of 16, 8,
// 4, 2 whose shared memory stays within kSmemBudget (two blocks an SM): 16
// at the flagship shape (82 KB), 1 only where a long hop or n_fft allows
// no more.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 16;                  // points a thread holds in a pass
constexpr int kPoints = kThreads * kPerThread;  // complex points a round transforms
constexpr int kPadded = kPoints + kPoints / 16; // one pad slot after every 16 points
constexpr int kMaxTT = 16;
constexpr int kMinFft = 64, kMaxFft = 4096;
constexpr int kMaxMels = 128;
constexpr int kMaxRoundFrames = kPoints / (kMinFft / 2);
constexpr long long kSmemBudget = 110 * 1024;   // two blocks an SM

__device__ __forceinline__ float load_sample(const float* p, float) { return *p; }
__device__ __forceinline__ float load_sample(const int16_t* p, float scale) {
  return static_cast<float>(*p) * scale;
}

// Point e of the round's buffer: the pad slot spreads a thread's 16 outputs
// of a radix-16 pass at Ns = 1 (16 points apart) over distinct banks.
__device__ __forceinline__ int at(int e) { return e + (e >> 4); }

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// W_N^e = e^{-2 pi i e/N} for e in [0, N), from tw[m] = e^{-2 pi i m/(2N)}, m < N
__device__ __forceinline__ float2 twiddle(const float2* __restrict__ tw, int N, int e) {
  const int two = 2 * e;
  if (two < N) return __ldg(tw + two);
  const float2 t = __ldg(tw + two - N);
  return make_float2(-t.x, -t.y);
}

__device__ __forceinline__ void dft4(float2& v0, float2& v1, float2& v2, float2& v3) {
  const float2 a0 = make_float2(v0.x + v2.x, v0.y + v2.y);
  const float2 a1 = make_float2(v0.x - v2.x, v0.y - v2.y);
  const float2 a2 = make_float2(v1.x + v3.x, v1.y + v3.y);
  const float2 a3 = make_float2(v1.y - v3.y, v3.x - v1.x);  // -i (v1 - v3)
  v0 = make_float2(a0.x + a2.x, a0.y + a2.y);
  v1 = make_float2(a1.x + a3.x, a1.y + a3.y);
  v2 = make_float2(a0.x - a2.x, a0.y - a2.y);
  v3 = make_float2(a1.x - a3.x, a1.y - a3.y);
}

// W_16^e for the products b*c (b, c in 1..3) of the 4 x 4 split, e != 4:
// float32 roundings of cos and sin of multiples of pi/8
__device__ __forceinline__ float2 w16(int e) {
  constexpr float c = 0.923879532511286756f, s = 0.382683432365089772f, h = 0.707106781186547524f;
  switch (e) {
    case 1: return make_float2(c, -s);
    case 2: return make_float2(h, -h);
    case 3: return make_float2(s, -c);
    case 6: return make_float2(-h, -h);
    default: return make_float2(-c, s);  // 9
  }
}

// In-place DFT of v[0..R-1]; output q lands in v[slot<R>(q)].
template <int R>
__device__ __forceinline__ constexpr int slot(int q) {
  return R == 16 ? 4 * (q & 3) + (q >> 2) : q;
}

template <int R>
__device__ __forceinline__ void dft(float2 (&v)[R]) {
  if constexpr (R == 2) {
    const float2 a = v[0], b = v[1];
    v[0] = make_float2(a.x + b.x, a.y + b.y);
    v[1] = make_float2(a.x - b.x, a.y - b.y);
  } else if constexpr (R == 4) {
    dft4(v[0], v[1], v[2], v[3]);
  } else {
    // n = 4a + b, m = c + 4d: W16^{nm} = W4^{ac} W16^{bc} W4^{bd}
#pragma unroll
    for (int b = 0; b < 4; ++b) dft4(v[b], v[4 + b], v[8 + b], v[12 + b]);  // over a: v[b + 4c]
#pragma unroll
    for (int b = 1; b < 4; ++b)
#pragma unroll
      for (int c = 1; c < 4; ++c) {
        float2& x = v[b + 4 * c];
        x = b * c == 4 ? make_float2(x.y, -x.x) : cmul(x, w16(b * c));
      }
#pragma unroll
    for (int c = 0; c < 4; ++c) dft4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);  // over b: v[4c + d]
  }
}

// One Stockham pass of radix R over `frames` transforms of N points in buf
// (frame-major): butterfly j of a frame combines the points j + q*N/R of
// Ns-point sub-transforms into an (Ns*R)-point one and writes them to
// (j - k)*R + k + q*Ns, k = j mod Ns, after multiplying point q by
// W_{Ns*R}^{kq} = ptw[(q-1)*Ns + k]. The first pass (Ns = 1, no twiddles)
// packs its points from the staged audio: z[n] = w[2n]x[2n] + i w[2n+1]x[2n+1].
template <int R, bool First>
__device__ __forceinline__ void fft_pass(float2* buf, const float2* ptw, const float* xs,
                                         const float2* __restrict__ win, int hop, int frame0,
                                         int frames, int log2N, int log2Ns) {
  constexpr int kBf = kPerThread / R;
  constexpr int kLog2R = R == 16 ? 4 : R == 4 ? 2 : 1;
  const int log2nr = log2N - kLog2R;
  const int nr = 1 << log2nr, Ns = 1 << log2Ns;
  const int total = frames << log2nr;
  float2 v[kBf][R];
#pragma unroll
  for (int i = 0; i < kBf; ++i) {
    const int u = threadIdx.x + i * kThreads;
    if (u < total) {
      const int f = u >> log2nr, j = u & (nr - 1), k = j & (Ns - 1);
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int idx = j + q * nr;
        if constexpr (First) {
          const float* x = xs + (frame0 + f) * hop + 2 * idx;
          const float2 w = __ldg(win + idx);
          v[i][q] = make_float2(w.x * x[0], w.y * x[1]);
        } else {
          v[i][q] = buf[at((f << log2N) + idx)];
          if (q > 0) v[i][q] = cmul(v[i][q], ptw[((q - 1) << log2Ns) + k]);
        }
      }
      dft<R>(v[i]);
    }
  }
  __syncthreads();  // every point of the pass read before any is overwritten
#pragma unroll
  for (int i = 0; i < kBf; ++i) {
    const int u = threadIdx.x + i * kThreads;
    if (u < total) {
      const int f = u >> log2nr, j = u & (nr - 1), k = j & (Ns - 1);
      const int base = (f << log2N) + ((j - k) << kLog2R) + k;
#pragma unroll
      for (int q = 0; q < R; ++q) buf[at(base + (q << log2Ns))] = v[i][slot<R>(q)];
    }
  }
  __syncthreads();
}

// |X[k]| from Z[k] and c = Z[N-k]: X = (Z + conj c)/2 - i W (Z - conj c)/2,
// W = e^{-2 pi i k/n_fft} = tw[k]
__device__ __forceinline__ float split_magnitude(float2 z, float2 c, float2 w) {
  const float er = 0.5f * (z.x + c.x), ei = 0.5f * (z.y - c.y);
  const float or_ = 0.5f * (z.x - c.x), oi = 0.5f * (z.y + c.y);
  const float xr = er + w.x * oi + w.y * or_;
  const float xi = ei - w.x * or_ + w.y * oi;
  return sqrtf(xr * xr + xi * xi);
}

// The last pass (radix 4 at Ns = N/4, twiddles W_N^{jq} = ptw[(q-1)N/4 + j])
// with the real split: butterfly j yields Z[j + qN/4], and the partner bin
// N - k of k = j + qN/4 is N/4 - j + (3 - q)N/4, in butterfly N/4 - j. So a
// slot s < N/8 takes the butterflies s and N/4 - s (slot 0: 0 and N/8, each
// its own partner) and holds both bins of every pair it needs. After the
// pass's barrier it writes its 8 magnitudes (and slot 0 |X[N]| = |Re Z[0] -
// Im Z[0]|) as rows of N + 1 floats over the buffer.
__device__ __forceinline__ void last_pass(float2* buf, const float2* ptw,
                                          const float2* __restrict__ twiddles, float* nyq,
                                          int frames, int log2N) {
  constexpr int kSlots = kPerThread / 8;
  const int N = 1 << log2N, nq = N / 4, log2slots = log2N - 3;
  const int total = frames << log2slots;
  float mag[kSlots][8];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int u = threadIdx.x + i * kThreads;
    if (u < total) {
      const int f = u >> log2slots, s = u & ((1 << log2slots) - 1);
      const int jb[2] = {s, s == 0 ? N / 8 : nq - s};
      float2 z[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          z[h][q] = buf[at((f << log2N) + jb[h] + q * nq)];
          if (q > 0) z[h][q] = cmul(z[h][q], ptw[(q - 1) * nq + jb[h]]);
        }
        dft4(z[h][0], z[h][1], z[h][2], z[h][3]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 ca = s == 0 ? z[0][(4 - q) & 3] : z[1][3 - q];
        const float2 cb = s == 0 ? z[1][3 - q] : z[0][3 - q];
        mag[i][q] = split_magnitude(z[0][q], ca, __ldg(twiddles + jb[0] + q * nq));
        mag[i][4 + q] = split_magnitude(z[1][q], cb, __ldg(twiddles + jb[1] + q * nq));
      }
      if (s == 0) nyq[f] = fabsf(z[0][0].x - z[0][0].y);
    }
  }
  __syncthreads();  // every point read before the magnitudes overwrite them
  float* mag_out = reinterpret_cast<float*>(buf);
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int u = threadIdx.x + i * kThreads;
    if (u < total) {
      const int f = u >> log2slots, s = u & ((1 << log2slots) - 1);
      float* row = mag_out + f * (N + 1);
      const int jb1 = s == 0 ? N / 8 : nq - s;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        row[s + q * nq] = mag[i][q];
        row[jb1 + q * nq] = mag[i][4 + q];
      }
    }
  }
  if (threadIdx.x < frames) mag_out[threadIdx.x * (N + 1) + N] = nyq[threadIdx.x];
  __syncthreads();
}

// The passes for N = 2^log2N points, in order, as visit(R, log2Ns): a
// first pass (Ns = 1) of radix 16, 2 or 4, or radix 2 then 4, that leaves
// 2 + a multiple of 4 bits; radix-16 passes; the last, radix 4 at Ns = N/4.
// A pass after the first takes (R - 1) * Ns twiddles (less than N in all).
template <typename Visit>
__device__ __forceinline__ void for_each_pass(int log2N, Visit visit) {
  const int r = (log2N - 2) & 3;
  int log2Ns = 0;
  if (r == 0) {
    visit(16, 0);
    log2Ns = 4;
  } else {
    visit(r == 2 ? 4 : 2, 0);
    log2Ns = r == 2 ? 2 : 1;
    if (r == 3) {
      visit(4, 1);
      log2Ns = 3;
    }
  }
  for (; log2Ns < log2N - 2; log2Ns += 4) visit(16, log2Ns);
  visit(4, log2Ns);
}

template <typename In>
__global__ void __launch_bounds__(kThreads, 2)
fused_stft_mel_kernel(const In* __restrict__ audio, long long clip_stride, long long clip_len,
                      float in_scale, const float* __restrict__ window,
                      const float2* __restrict__ twiddles, const int* __restrict__ bands,
                      const float* __restrict__ weights, float* __restrict__ out, int T, int hop,
                      int n_fft, int M, int TT) {
  extern __shared__ float4 smem4[];
  const int N = n_fft / 2;
  const int log2N = __ffs(N) - 1;
  const int span = (TT - 1) * hop + n_fft;
  const int FR = min(kPoints / N, TT);  // frames a round transforms
  float2* buf = reinterpret_cast<float2*>(smem4);  // [FR][N] points (padded), then [FR][N+1] magnitudes
  float2* ptw = buf + kPadded;                     // [< N] twiddles of the passes after the first
  float* nyq = reinterpret_cast<float*>(ptw + N);  // [FR] |X[N]|
  float* xs = nyq + kMaxRoundFrames;               // [span] audio of this frame tile

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * TT;
  const int b = blockIdx.y;
  const In* clip = audio + (long long)b * clip_stride;
  const long long start = (long long)t0 * hop;
  for (int i = tid; i < span; i += kThreads) {
    const long long idx = start + i;
    xs[i] = idx < clip_len ? load_sample(clip + idx, in_scale) : 0.0f;
  }
  {
    int off = 0;
    for_each_pass(log2N, [&](int R, int log2Ns) {
      if (log2Ns == 0) return;
      const int shift = log2N - log2Ns - (R == 16 ? 4 : 2);  // W_{Ns*R}^{kq} = W_N^{kq << shift}
      const int n = (R - 1) << log2Ns;
      for (int i = tid; i < n; i += kThreads)
        ptw[off + i] = twiddle(twiddles, N, ((i & ((1 << log2Ns) - 1)) * ((i >> log2Ns) + 1)) << shift);
      off += n;
    });
  }
  __syncthreads();

  const auto* win = reinterpret_cast<const float2*>(window);
  const float* mag = reinterpret_cast<const float*>(buf);
  const int pairs = (M + 1) / 2;
  for (int frame0 = 0; frame0 < TT; frame0 += FR) {
    // the transform and magnitudes; the first pass's barrier also orders it
    // after the last round's band sums
    int off = 0;
    for_each_pass(log2N, [&](int R, int log2Ns) {
      if (log2Ns == 0) {
        if (R == 16) fft_pass<16, true>(buf, nullptr, xs, win, hop, frame0, FR, log2N, 0);
        else if (R == 4) fft_pass<4, true>(buf, nullptr, xs, win, hop, frame0, FR, log2N, 0);
        else fft_pass<2, true>(buf, nullptr, xs, win, hop, frame0, FR, log2N, 0);
        return;
      }
      if (log2Ns == log2N - 2) last_pass(buf, ptw + off, twiddles, nyq, FR, log2N);
      else if (R == 16) fft_pass<16, false>(buf, ptw + off, xs, win, hop, frame0, FR, log2N, log2Ns);
      else fft_pass<4, false>(buf, ptw + off, xs, win, hop, frame0, FR, log2N, log2Ns);
      off += (R - 1) << log2Ns;
    });

    // band sums: a thread takes bands p and M-1-p of one frame, so that the
    // short low bands pair with the long high ones
    for (int o = tid; o < FR * pairs; o += kThreads) {
      const int f = o / pairs, p = o - f * pairs;
      const int t = t0 + frame0 + f;
      auto band_sum = [&](int mb) {
        const float* row = mag + f * (N + 1) + __ldg(bands + 3 * mb);
        const float* wt = weights + __ldg(bands + 3 * mb + 2);
        const int len = __ldg(bands + 3 * mb + 1);
        float acc = 0.0f;
        for (int j = 0; j < len; ++j) acc = fmaf(row[j], __ldg(wt + j), acc);
        if (t < T) out[((long long)b * T + t) * M + mb] = acc;
      };
      band_sum(p);
      if (M - 1 - p != p) band_sum(M - 1 - p);
    }
  }
}

bool supported(int n_fft) {
  return n_fft >= kMinFft && n_fft <= kMaxFft && (n_fft & (n_fft - 1)) == 0;
}

long long smem_bytes(int tt, int hop, int n_fft) {
  const long long span = (long long)(tt - 1) * hop + n_fft;
  return (long long)sizeof(float2) * (kPadded + n_fft / 2) +
         (long long)sizeof(float) * (kMaxRoundFrames + span);
}

int tile_frames(int hop, int n_fft) {
  int tt = kMaxTT;
  while (tt > 1 && smem_bytes(tt, hop, n_fft) > kSmemBudget) tt /= 2;
  return tt;
}

template <typename In>
int launch(const void* audio, long long clip_stride, long long clip_len, float in_scale,
           const float* window, const float2* twiddles, const int* bands, const float* weights,
           float* out, int B, int T, int hop, int n_fft, int M, cudaStream_t stream) {
  const int tt = tile_frames(hop, n_fft);
  const long long smem = smem_bytes(tt, hop, n_fft);
  cudaError_t err = cudaFuncSetAttribute(fused_stft_mel_kernel<In>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + tt - 1) / tt, B);
  fused_stft_mel_kernel<In><<<grid, kThreads, smem, stream>>>(
      static_cast<const In*>(audio), clip_stride, clip_len, in_scale, window, twiddles, bands,
      weights, out, T, hop, n_fft, M, tt);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// audio: B clips of clip_len contiguous samples, clip_stride samples apart,
// int16 (in_is_int16 = 1) or float32. window: [n_fft]; twiddles: [n_fft/2]
// (re, im) pairs e^{-2 pi i m/n_fft}; bands: [M][3] int32 (first bin, length,
// offset into weights); weights: the bands' mel_fb values; out: [B, T, M].
// All float32 unless stated, contiguous. n_fft: a power of two from 64 to
// 4096; M <= 128; anything else returns cudaErrorInvalidValue unlaunched.
int dcase_fused_stft_mel(const void* audio, int in_is_int16, long long clip_stride,
                         long long clip_len, const void* window, const void* twiddles,
                         const void* bands, const void* weights, void* out, int B, int T, int hop,
                         int n_fft, int M, void* stream) {
  if (!supported(n_fft) || M < 1 || M > kMaxMels || hop < 1) return (int)cudaErrorInvalidValue;
  const auto* w = static_cast<const float*>(window);
  const auto* tw = static_cast<const float2*>(twiddles);
  const auto* bd = static_cast<const int*>(bands);
  const auto* wt = static_cast<const float*>(weights);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (in_is_int16)
    return launch<int16_t>(audio, clip_stride, clip_len, 1.0f / 32768.0f, w, tw, bd, wt, o, B, T,
                           hop, n_fft, M, st);
  return launch<float>(audio, clip_stride, clip_len, 1.0f, w, tw, bd, wt, o, B, T, hop, n_fft, M,
                       st);
}

}  // extern "C"
