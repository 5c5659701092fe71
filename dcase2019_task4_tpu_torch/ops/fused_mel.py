"""K1: fused STFT→mel, audio hop-rows in, linear mel out.

PyTorch counterpart of dcase2019_task4_tpu/ops/fused_mel.py. On a CUDA
tensor `fused_stft_mel` launches the hand-written kernel in
csrc/fused_mel.cu (frames and spectrum stay on chip); on a CPU tensor it
runs `fused_stft_mel_reference`, the plain chunked DFT of the JAX
package's "chunked" path (ops/mel.py:292-314, then the mel product).

The constants are trimmed to the bins the mel matrix reads (1024 of 1025
at 44.1 kHz / 2048 / 64 mels: the Nyquist triangle weight is ~1e-15, so
the trim is lossless to float tolerance). Unlike the TPU kernel, the bases
are kept whole ([n_fft, NB]) instead of split into hop-wide parts: frame t
is the contiguous window starting at t·hop of the flattened hop-row
buffer, so the part split is TPU layout, not function.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dcase2019_task4_tpu_torch.ops import _build


class FusedMelBases(NamedTuple):
    """Constants for the kernel (numpy arrays or tensors on one device).

    cos, sin: [n_fft, NB] windowed-DFT bases trimmed to NB bins.
    mel_fb:   [NB, M] Slaney mel matrix trimmed to NB bins.
    """

    cos: object
    sin: object
    mel_fb: object


def trimmed_bins(mel_fb_full: np.ndarray, tol: float = 1e-8) -> int:
    """Number of leading spectrogram bins with non-negligible mel weight
    (tolerance relative to the peak weight; a dropped bin perturbs the mel
    output by ≤ tol·|mag|)."""
    w = np.abs(mel_fb_full).sum(axis=1)
    nz = np.nonzero(w > tol * max(np.abs(mel_fb_full).max(), 1e-30))[0]
    return int(nz[-1]) + 1 if nz.size else 1


def build_bases(cos_full: np.ndarray, sin_full: np.ndarray, mel_fb_full: np.ndarray) -> FusedMelBases:
    """Trim the [n_fft, n_bins] bases and the [n_bins, M] mel matrix to the
    mel-reachable bins (float32, contiguous)."""
    nb = trimmed_bins(mel_fb_full)
    return FusedMelBases(
        cos=np.ascontiguousarray(cos_full[:, :nb], np.float32),
        sin=np.ascontiguousarray(sin_full[:, :nb], np.float32),
        mel_fb=np.ascontiguousarray(mel_fb_full[:nb], np.float32),
    )


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
    linear mel [B, T, M] float32. CPU: the plain twin. CUDA: the kernel."""
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
    cos, sin, mel_fb = bases
    nb, M = mel_fb.shape
    for name, t, shape in (("cos", cos, (n_fft, nb)), ("sin", sin, (n_fft, nb)), ("mel_fb", mel_fb, (nb, M))):
        if (t.device != chunks.device or t.dtype != torch.float32 or not t.is_contiguous()
                or tuple(t.shape) != shape):
            raise ValueError(f"{name} must be a contiguous float32 {shape} tensor on {chunks.device}")
    lib = _build.library()
    if M > lib.dcase_fused_stft_mel_max_mels():
        raise ValueError(f"{M} mel bins exceed the kernel's {lib.dcase_fused_stft_mel_max_mels()}")
    smem = lib.dcase_fused_stft_mel_smem(hop, n_fft)
    if smem > _build.max_shared_bytes(chunks.device):
        raise ValueError(f"n_fft={n_fft}, hop={hop} need {smem} bytes of shared memory per block")
    out = torch.empty((B, T, M), dtype=torch.float32, device=chunks.device)
    status = lib.dcase_fused_stft_mel(
        chunks.data_ptr(), int(chunks.dtype == torch.int16), chunks.stride(0), R * hop,
        cos.data_ptr(), sin.data_ptr(), mel_fb.data_ptr(), out.data_ptr(),
        B, T, hop, n_fft, nb, M, _build.stream_handle(chunks.device),
    )
    _build.check(status, "fused_stft_mel")
    fused_stft_mel.launches += 1
    return out


fused_stft_mel.launches = 0
