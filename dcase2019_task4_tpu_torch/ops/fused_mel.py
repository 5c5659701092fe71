"""K1: fused STFT→mel, audio hop-rows in, linear mel out.

PyTorch counterpart of dcase2019_task4_tpu/ops/fused_mel.py. On a CPU
tensor `fused_stft_mel` runs `fused_stft_mel_reference`, the plain chunked
DFT of the JAX package's "chunked" path (ops/mel.py:292-314, then the mel
product). On a CUDA tensor it launches the hand-written kernel in
csrc/fused_mel.cu, which computes the same function as a real FFT per frame
in shared memory (the JAX package's "fft" STFT mode, ops/mel.py:276) and
sums each mel band over its own bins; frames and spectrum stay on chip.

The constants are trimmed to the bins the mel matrix reads (1024 of 1025
at 44.1 kHz / 2048 / 64 mels: the Nyquist triangle weight is ~1e-15, so
the trim is lossless to float tolerance). The plain version reads the
windowed-DFT bases whole ([n_fft, NB]); the kernel reads the window, a
float64-built twiddle table and the mel matrix as a table of bands, all
built once on the host by `build_bases`.

DCASE_FUSED_MEL_ONEDOT=1, read at import into ONEDOT as the JAX package
reads it (fused_mel.py:60), selects that package's other K1 kernel,
`_kernel_onedot`: the DFT as one product against the windowed cos‖sin
basis [n_fft, 2·NB] (`OnedotBases`, `build_onedot_bases`), the re/im split
at NB, the magnitude and the mel product. `fused_stft_mel_onedot` launches
its hand-written kernel (csrc/fused_mel_onedot.cu: an SGEMM-class FP32
product whose blocks each take 64 bins, the magnitude and each mel band's
share of those bins in its epilogue, then a fold of the shares in a fixed
order; `onedot_plan` lays out the shares) on a CUDA tensor and runs
`fused_stft_mel_onedot_reference` on a CPU tensor; `ops/mel.py:MelFrontend`
picks it at construction, as the JAX frontend does. Float32 only: under a
bfloat16 model K1 stays float32 in either variant.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from dcase2019_task4_tpu_torch.ops import _build

FFT_SIZES = (64, 4096)  # the kernel's n_fft: a power of two in this range
MAX_MELS = 128

# the JAX package's knob, read at import as there (fused_mel.py:60)
ONEDOT = os.environ.get("DCASE_FUSED_MEL_ONEDOT") == "1"


class FusedMelBases(NamedTuple):
    """Constants for the kernel (numpy arrays or tensors on one device).

    cos, sin: [n_fft, NB] windowed-DFT bases trimmed to NB bins (the plain
              version's).
    mel_fb:   [NB, M] Slaney mel matrix trimmed to NB bins.
    The kernel's (None where a caller built only the first three; the CPU
    path does not read them):
    window:   [n_fft] the Hamming window, cos[:, 0] bit for bit.
    twiddle:  [n_fft/2, 2] e^{-2πim/n_fft} as (re, im), from float64.
    bands:    [M, 3] int32 per band: first bin, length, offset into
              band_weights.
    band_weights: the bands' float32 values of mel_fb, one after another.
    """

    cos: object
    sin: object
    mel_fb: object
    window: object = None
    twiddle: object = None
    bands: object = None
    band_weights: object = None


def trimmed_bins(mel_fb_full: np.ndarray, tol: float = 1e-8) -> int:
    """Number of leading spectrogram bins with non-negligible mel weight
    (tolerance relative to the peak weight; a dropped bin perturbs the mel
    output by ≤ tol·|mag|)."""
    w = np.abs(mel_fb_full).sum(axis=1)
    nz = np.nonzero(w > tol * max(np.abs(mel_fb_full).max(), 1e-30))[0]
    return int(nz[-1]) + 1 if nz.size else 1


def twiddle_table(n_fft: int) -> np.ndarray:
    """[n_fft/2, 2] float32 (re, im) of e^{-2πim/n_fft}, m < n_fft/2,
    computed in float64 and rounded once."""
    ang = 2.0 * np.pi * np.arange(n_fft // 2, dtype=np.float64) / n_fft
    return np.stack([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)


def band_table(mel_fb: np.ndarray) -> tuple:
    """[NB, M] mel matrix → (bands [M, 3] int32: first bin, length, offset;
    weights float32): each band runs from its first to its last nonzero
    weight (an empty band has length 0), so the table rebuilds mel_fb
    exactly."""
    bands, weights, offset = [], [], 0
    for m in range(mel_fb.shape[1]):
        nz = np.flatnonzero(mel_fb[:, m])
        first, n = (int(nz[0]), int(nz[-1] - nz[0]) + 1) if nz.size else (0, 0)
        bands.append((first, n, offset))
        weights.append(mel_fb[first:first + n, m])
        offset += n
    return np.asarray(bands, np.int32).reshape(-1, 3), np.concatenate(weights).astype(np.float32)


def build_bases(cos_full: np.ndarray, sin_full: np.ndarray, mel_fb_full: np.ndarray) -> FusedMelBases:
    """Trim the [n_fft, n_bins] bases and the [n_bins, M] mel matrix to the
    mel-reachable bins and build the kernel's window, twiddle and band
    tables (contiguous numpy arrays)."""
    nb = trimmed_bins(mel_fb_full)
    mel_fb = np.ascontiguousarray(mel_fb_full[:nb], np.float32)
    bands, band_weights = band_table(mel_fb)
    return FusedMelBases(
        cos=np.ascontiguousarray(cos_full[:, :nb], np.float32),
        sin=np.ascontiguousarray(sin_full[:, :nb], np.float32),
        mel_fb=mel_fb,
        window=np.ascontiguousarray(cos_full[:, 0], np.float32),  # bin 0's cosine is 1
        twiddle=twiddle_table(cos_full.shape[0]),
        bands=bands,
        band_weights=band_weights,
    )


def check_kernel_args(n_fft: int, n_bins: int, n_mels: int):
    """Raise ValueError for what the kernel does not take."""
    lo, hi = FFT_SIZES
    if not (lo <= n_fft <= hi and n_fft & (n_fft - 1) == 0):
        raise ValueError(f"n_fft={n_fft}: the kernel takes a power of two from {lo} to {hi}")
    if not 1 <= n_mels <= MAX_MELS:
        raise ValueError(f"{n_mels} mel bands: the kernel takes 1 to {MAX_MELS}")
    if not 1 <= n_bins <= n_fft // 2 + 1:
        raise ValueError(f"{n_bins} bins: a real FFT of {n_fft} points has {n_fft // 2 + 1}")


def extra_rows(n_fft: int, hop: int) -> int:
    """Hop-chunk rows a frame reads beyond its own row."""
    p_full, tail = n_fft // hop, n_fft % hop
    return p_full if tail else p_full - 1


def _dequantize(chunks: torch.Tensor) -> torch.Tensor:
    if chunks.dtype == torch.int16:
        return chunks.to(torch.float32) * (1.0 / 32768.0)
    return chunks.to(torch.float32)


def fused_stft_mel_reference(chunks: torch.Tensor, bases: FusedMelBases, *, n_fft: int, hop: int, T: int) -> torch.Tensor:
    """Plain PyTorch twin: frames assembled from shifted hop-row slices,
    windowed DFT as two matmuls, magnitude, mel matmul. [B, R, hop] →
    [B, T, M] float32, any device."""
    p_full, tail = n_fft // hop, n_fft % hop
    rows = _dequantize(chunks)
    parts = [rows[:, p : p + T, :] for p in range(p_full)]
    if tail:
        parts.append(rows[:, p_full : p_full + T, :tail])
    frames = torch.cat(parts, dim=-1)  # [B, T, n_fft]
    re = frames @ bases.cos
    im = frames @ bases.sin
    return torch.sqrt(re * re + im * im) @ bases.mel_fb


def fused_stft_mel(chunks: torch.Tensor, bases: FusedMelBases, *, n_fft: int, hop: int, T: int) -> torch.Tensor:
    """chunks [B, R, hop] (R ≥ T + extra_rows; int16 PCM or float32) →
    linear mel [B, T, M] float32. CPU: the plain twin. CUDA: the FFT
    kernel, which needs the tables of `build_bases`."""
    B, R, hop_in = chunks.shape
    if hop_in != hop or R < T + extra_rows(n_fft, hop):
        raise ValueError(f"chunks {tuple(chunks.shape)} do not cover T={T} frames of n_fft={n_fft}, hop={hop}")
    if chunks.device.type == "cpu":
        return fused_stft_mel_reference(chunks, bases, n_fft=n_fft, hop=hop, T=T)
    if chunks.device.type != "cuda":
        raise ValueError(f"fused_stft_mel runs on cpu or cuda tensors, got {chunks.device}")
    if chunks.dtype not in (torch.float32, torch.int16) or chunks.stride()[1:] != (hop, 1):
        # each clip's rows must be one contiguous run (the hop-row view of a
        # longer buffer qualifies); clips may sit any distance apart
        raise ValueError(f"chunks must be float32 or int16 with contiguous clips, got {chunks.dtype}, "
                         f"strides {chunks.stride()}")
    nb, M = bases.mel_fb.shape
    check_kernel_args(n_fft, nb, M)
    tables = (("window", bases.window, torch.float32, (n_fft,)),
              ("twiddle", bases.twiddle, torch.float32, (n_fft // 2, 2)),
              ("bands", bases.bands, torch.int32, (M, 3)),
              ("band_weights", bases.band_weights, torch.float32, None))
    for name, t, dtype, shape in tables:
        if t is None:
            raise ValueError(f"bases.{name} is missing: the kernel needs the tables of build_bases")
        if (t.device != chunks.device or t.dtype != dtype or not t.is_contiguous() or t.data_ptr() % 8
                or (shape is not None and tuple(t.shape) != shape)):
            raise ValueError(f"{name} must be a contiguous, 8-byte aligned {dtype} tensor of shape "
                             f"{shape or '[n]'} on {chunks.device}")
    out = torch.empty((B, T, M), dtype=torch.float32, device=chunks.device)
    status = _build.library().dcase_fused_stft_mel(
        chunks.data_ptr(), int(chunks.dtype == torch.int16), chunks.stride(0), R * hop,
        bases.window.data_ptr(), bases.twiddle.data_ptr(), bases.bands.data_ptr(),
        bases.band_weights.data_ptr(), out.data_ptr(), B, T, hop, n_fft, M,
        _build.stream_handle(chunks.device),
    )
    _build.check(status, "fused_stft_mel")
    fused_stft_mel.launches += 1
    return out


fused_stft_mel.launches = 0


# ------------------------------------------------ the cos‖sin basis variant


class OnedotBases(NamedTuple):
    """Constants of the onedot kernel (numpy arrays or tensors on one device).

    dft:    [n_fft, 2·NB] windowed cosine ‖ sine basis trimmed to NB bins
            (the JAX package's dft_main parts and dft_tail, stacked back).
    mel_fb: [NB, M] Slaney mel matrix trimmed to NB bins.
    The kernel's plan (`onedot_plan`; None where a caller built only the
    first two: the CPU path does not read it):
    chunks: [ceil(NB / ONEDOT_BINS), 3] int32 per bin chunk: first band,
            band count, slot offset.
    bands:  [M, 4] int32 per band: first bin, end bin, first chunk, end chunk.
    slots:  the partial mel sums a frame keeps, one per (chunk, band it
            reaches).
    """

    dft: object
    mel_fb: object
    chunks: object = None
    bands: object = None
    slots: int = 0


ONEDOT_BINS = 128  # bins a block of the onedot kernel takes (kBins in csrc/fused_mel_onedot.cu)


def onedot_plan(mel_fb: np.ndarray) -> tuple:
    """The onedot kernel's split of the bins across blocks and of the mel
    sums across slots, from the [NB, M] mel matrix → (chunks [n_chunks, 3]
    int32: first band, band count, slot offset; bands [M, 4] int32: first
    bin, end bin, first chunk, end chunk; slots). Chunk c holds bins
    c·ONEDOT_BINS up to NB; band m's nonzero weights lie in [first bin, end
    bin), which the chunks [first chunk, end chunk) cover; each chunk keeps
    one slot per band from its first to its last such band (an empty band
    has no bins and no chunk), so the kernel writes each share once and the
    fold adds a band's shares from its own chunks."""
    nb, M = mel_fb.shape
    n_chunks = -(-nb // ONEDOT_BINS)
    bands = np.zeros((M, 4), np.int32)
    for m in range(M):
        nz = np.flatnonzero(mel_fb[:, m])
        if nz.size:
            first, end = int(nz[0]), int(nz[-1]) + 1
            bands[m] = (first, end, first // ONEDOT_BINS, (end - 1) // ONEDOT_BINS + 1)
    chunks, slots = np.zeros((n_chunks, 3), np.int32), 0
    for c in range(n_chunks):
        reached = np.flatnonzero((bands[:, 2] <= c) & (c < bands[:, 3]))
        n = int(reached[-1] - reached[0]) + 1 if reached.size else 0
        chunks[c] = (reached[0] if reached.size else 0, n, slots)
        slots += n
    return chunks, bands, slots


def build_onedot_bases(cos_full: np.ndarray, sin_full: np.ndarray, mel_fb_full: np.ndarray) -> OnedotBases:
    """The cos‖sin basis and the mel matrix trimmed to the mel-reachable
    bins, float32, as the JAX package's build_onedot_bases builds them in
    float32 (fused_mel.py:76), with the kernel's `onedot_plan`."""
    nb = trimmed_bins(mel_fb_full)
    dft = np.concatenate([cos_full[:, :nb], sin_full[:, :nb]], axis=1)
    mel_fb = np.ascontiguousarray(mel_fb_full[:nb], np.float32)
    chunks, bands, slots = onedot_plan(mel_fb)
    return OnedotBases(dft=np.ascontiguousarray(dft, np.float32), mel_fb=mel_fb, chunks=chunks, bands=bands,
                       slots=slots)


def fused_stft_mel_onedot_reference(chunks: torch.Tensor, bases: OnedotBases, *, n_fft: int, hop: int,
                                    T: int) -> torch.Tensor:
    """Plain PyTorch twin of the onedot kernel: frames from shifted hop-row
    slices, one product against the cos‖sin basis, the split at NB, the
    magnitude, the mel product. [B, R, hop] → [B, T, M] float32."""
    p_full, tail = n_fft // hop, n_fft % hop
    rows = _dequantize(chunks)
    parts = [rows[:, p : p + T, :] for p in range(p_full)]
    if tail:
        parts.append(rows[:, p_full : p_full + T, :tail])
    reim = torch.cat(parts, dim=-1) @ bases.dft  # [B, T, 2·NB]
    nb = reim.shape[-1] // 2
    re, im = reim[..., :nb], reim[..., nb:]
    return torch.sqrt(re * re + im * im) @ bases.mel_fb


def fused_stft_mel_onedot(chunks: torch.Tensor, bases: OnedotBases, *, n_fft: int, hop: int, T: int) -> torch.Tensor:
    """chunks [B, R, hop] (R ≥ T + extra_rows; int16 PCM or float32) →
    linear mel [B, T, M] float32 through the cos‖sin basis. CPU: the plain
    twin. CUDA: the onedot kernel, which computes the product in its own
    body (no cuBLAS) and needs the plan of `build_onedot_bases`; its
    partial mel sums take a [B·T, slots] float32 workspace."""
    B, R, hop_in = chunks.shape
    if hop_in != hop or R < T + extra_rows(n_fft, hop):
        raise ValueError(f"chunks {tuple(chunks.shape)} do not cover T={T} frames of n_fft={n_fft}, hop={hop}")
    if chunks.device.type == "cpu":
        return fused_stft_mel_onedot_reference(chunks, bases, n_fft=n_fft, hop=hop, T=T)
    if chunks.device.type != "cuda":
        raise ValueError(f"fused_stft_mel_onedot runs on cpu or cuda tensors, got {chunks.device}")
    if chunks.dtype not in (torch.float32, torch.int16) or chunks.stride()[1:] != (hop, 1):
        raise ValueError(f"chunks must be float32 or int16 with contiguous clips, got {chunks.dtype}, "
                         f"strides {chunks.stride()}")
    nb, M = bases.mel_fb.shape
    if not 1 <= M <= MAX_MELS:
        raise ValueError(f"{M} mel bands: the kernel takes 1 to {MAX_MELS}")
    tables = (("dft", bases.dft, torch.float32, (n_fft, 2 * nb)), ("mel_fb", bases.mel_fb, torch.float32, (nb, M)),
              ("chunks", bases.chunks, torch.int32, (-(-nb // ONEDOT_BINS), 3)),
              ("bands", bases.bands, torch.int32, (M, 4)))
    for name, t, dtype, shape in tables:
        if t is None:
            raise ValueError(f"bases.{name} is missing: the kernel needs the plan of build_onedot_bases")
        if t.device != chunks.device or t.dtype != dtype or not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be a contiguous {dtype} tensor of shape {shape} on {chunks.device}")
    if bases.slots < 1:
        raise ValueError(f"bases.slots is {bases.slots}: the plan of build_onedot_bases has at least one")
    out = torch.empty((B, T, M), dtype=torch.float32, device=chunks.device)
    work = torch.empty((B * T, bases.slots), dtype=torch.float32, device=chunks.device)
    status = _build.library().dcase_fused_stft_mel_onedot(
        chunks.data_ptr(), int(chunks.dtype == torch.int16), chunks.stride(0), R * hop,
        bases.dft.data_ptr(), bases.mel_fb.data_ptr(), bases.chunks.data_ptr(), bases.bands.data_ptr(),
        work.data_ptr(), bases.slots, out.data_ptr(), B, T, hop, n_fft, nb, M,
        _build.stream_handle(chunks.device),
    )
    _build.check(status, "fused_stft_mel_onedot")
    fused_stft_mel_onedot.launches += 1
    return out


fused_stft_mel_onedot.launches = 0


# ------------------------------------------------------ torch.library ops
#
# The serving forward reaches K1 only through these custom ops
# (ops/mel.py `MelFrontend.linear_mel`), so torch.export can trace it:
# the ctypes launch above passes raw pointers, which export cannot follow.
# Each op's one implementation is the wrapper, which dispatches by the
# tensor's device (the plain version on the CPU, the kernel on cuda, and
# raises on any other); the fake gives the output's shape and dtype.


@torch.library.custom_op("dcase19_torch::fused_stft_mel", mutates_args=())
def fused_stft_mel_op(chunks: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, mel_fb: torch.Tensor,
                      window: torch.Tensor, twiddle: torch.Tensor, bands: torch.Tensor, band_weights: torch.Tensor,
                      n_fft: int, hop: int, T: int) -> torch.Tensor:
    """`fused_stft_mel` with `FusedMelBases` unpacked into its tensors."""
    bases = FusedMelBases(cos, sin, mel_fb, window, twiddle, bands, band_weights)
    return fused_stft_mel(chunks, bases, n_fft=n_fft, hop=hop, T=T)


@fused_stft_mel_op.register_fake
def _(chunks, cos, sin, mel_fb, window, twiddle, bands, band_weights, n_fft, hop, T):
    return chunks.new_empty((chunks.shape[0], T, mel_fb.shape[1]), dtype=torch.float32)


@torch.library.custom_op("dcase19_torch::fused_stft_mel_onedot", mutates_args=())
def fused_stft_mel_onedot_op(chunks: torch.Tensor, dft: torch.Tensor, mel_fb: torch.Tensor, plan_chunks: torch.Tensor,
                             plan_bands: torch.Tensor, slots: int, n_fft: int, hop: int, T: int) -> torch.Tensor:
    """`fused_stft_mel_onedot` with `OnedotBases` unpacked."""
    bases = OnedotBases(dft, mel_fb, plan_chunks, plan_bands, slots)
    return fused_stft_mel_onedot(chunks, bases, n_fft=n_fft, hop=hop, T=T)


@fused_stft_mel_onedot_op.register_fake
def _(chunks, dft, mel_fb, plan_chunks, plan_bands, slots, n_fft, hop, T):
    return chunks.new_empty((chunks.shape[0], T, mel_fb.shape[1]), dtype=torch.float32)
