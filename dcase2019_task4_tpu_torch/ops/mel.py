"""On-device log-mel frontend (PyTorch counterpart of
dcase2019_task4_tpu/ops/mel.py).

    audio [B, L] → reflect pad (host) → hop-row view → fused STFT→mel
        (K1, ops/fused_mel.py; its cos‖sin basis variant under
        DCASE_FUSED_MEL_ONEDOT=1) → amplitude_to_db (per-clip top_db 80 over
        valid frames) → zeroed padding frames

The numpy constant builders are framework-free copies of the JAX module's
(that module imports jax at import time, so the port cannot import them):
symmetric Hamming window, Slaney mel filterbank with no normalisation,
windowed real-DFT bases, librosa's centre-padded framing.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from dcase2019_task4_tpu_torch.ops import fused_mel
from dcase2019_task4_tpu_torch.ops.fused_mel import (
    FusedMelBases,
    OnedotBases,
    build_bases,
    build_onedot_bases,
    extra_rows,
)


# --------------------------------------------------------------------------
# Filterbank / window construction (host-side, once)
# --------------------------------------------------------------------------

def hz_to_mel_slaney(f):
    """Slaney mel scale (librosa htk=False): linear below 1 kHz, log above."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mel = f / f_sp
    log_region = f >= min_log_hz
    mel = np.where(log_region, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mel)
    return mel


def mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    f = m * f_sp
    log_region = m >= min_log_mel
    f = np.where(log_region, min_log_hz * np.exp(logstep * (m - min_log_mel)), f)
    return f


def mel_filterbank(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    f_min: float,
    f_max: float,
) -> np.ndarray:
    """Triangular Slaney-scale mel filterbank, **no normalization**
    (the reference's `htk=False, norm=None`). Returns [n_bins, n_mels]."""
    n_bins = 1 + n_fft // 2
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_bins)
    mel_pts = mel_to_hz_slaney(
        np.linspace(hz_to_mel_slaney(f_min), hz_to_mel_slaney(f_max), n_mels + 2)
    )
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    return weights.T.astype(np.float32)  # [n_bins, n_mels]


def hamming_window(n: int) -> np.ndarray:
    """Symmetric Hamming window, the reference's `np.hamming(n_window)`."""
    k = np.arange(n, dtype=np.float64)
    return (0.54 - 0.46 * np.cos(2.0 * np.pi * k / (n - 1))).astype(np.float32)


def dft_bases(n_fft: int, window: np.ndarray) -> tuple:
    """Windowed real-DFT bases as two [n_fft, n_bins] matrices."""
    n_bins = 1 + n_fft // 2
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_bins, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    cos_b = (np.cos(ang) * window[:, None].astype(np.float64)).astype(np.float32)
    sin_b = (-np.sin(ang) * window[:, None].astype(np.float64)).astype(np.float32)
    return cos_b, sin_b


def num_frames(length, hop_length: int):
    """librosa center=True frame count: 1 + length // hop."""
    return 1 + length // hop_length


def host_reflect_pad(audio_list, max_samples: int, n_fft: int, hop_length: int, max_frames: int) -> tuple:
    """Host-side packing of variable-length clips.

    Each clip is reflect-padded by n_fft//2 around its own boundaries and
    written into a [B, max_samples + n_fft] zero buffer; returns
    (padded [B, L+n_fft], n_valid_frames [B])."""
    p = n_fft // 2
    B = len(audio_list)
    out = np.zeros((B, max_samples + 2 * p), dtype=np.float32)
    frames = np.zeros(B, dtype=np.int32)
    for b, a in enumerate(audio_list):
        a = np.asarray(a, dtype=np.float32)
        frames[b] = min(max_frames, 1 + a.shape[0] // hop_length)
        if a.shape[0] > max_samples + p:  # enough tail for the last frame
            a = a[: max_samples + p]
        padded = np.pad(a, (p, p), mode="reflect")
        out[b, : min(padded.shape[0], out.shape[1])] = padded[: out.shape[1]]
    return out, frames


# --------------------------------------------------------------------------
# Device frontend
# --------------------------------------------------------------------------

class MelFrontend(nn.Module):
    """Holds K1's constants as buffers on `device` and featurizes padded
    audio batches. Arguments mirror DSPConfig. The trimmed DFT bases and
    the mel matrix serve the plain version (CPU tensors); the window,
    twiddle and band tables serve the FFT kernel (CUDA tensors). All are
    built once here, the kernel's as non-persistent buffers. `onedot`
    (default `fused_mel.ONEDOT`, read here, as the JAX frontend picks its
    bases at construction) selects the cos‖sin basis variant of K1 instead:
    its basis [n_fft, 2·NB] is one more non-persistent buffer, so a
    checkpoint does not change with the choice."""

    def __init__(
        self,
        sample_rate: int = 44100,
        n_window: int = 2048,
        hop_length: int = 511,
        n_mels: int = 64,
        f_min: float = 0.0,
        f_max: float = 22050.0,
        max_frames: int = 864,
        amin: float = 1e-5,
        top_db: float = 80.0,
        device=None,
        onedot: Optional[bool] = None,
    ):
        super().__init__()
        self.sample_rate = sample_rate
        self.n_window = n_window
        self.hop_length = hop_length
        self.n_mels = n_mels
        self.max_frames = max_frames
        self.amin = amin
        self.top_db = top_db
        fb = mel_filterbank(sample_rate, n_window, n_mels, f_min, f_max)
        cos_b, sin_b = dft_bases(n_window, hamming_window(n_window))
        bases = build_bases(cos_b, sin_b, fb)
        self.register_buffer("cos_basis", torch.as_tensor(bases.cos, device=device))
        self.register_buffer("sin_basis", torch.as_tensor(bases.sin, device=device))
        self.register_buffer("mel_fb", torch.as_tensor(bases.mel_fb, device=device))
        for name in ("window", "twiddle", "bands", "band_weights"):
            self.register_buffer(name, torch.as_tensor(getattr(bases, name), device=device), persistent=False)
        self.onedot = fused_mel.ONEDOT if onedot is None else bool(onedot)
        if self.onedot:
            ob = build_onedot_bases(cos_b, sin_b, fb)
            self.register_buffer("onedot_basis", torch.as_tensor(ob.dft, device=device), persistent=False)
            self.register_buffer("onedot_chunks", torch.as_tensor(ob.chunks, device=device), persistent=False)
            self.register_buffer("onedot_bands", torch.as_tensor(ob.bands, device=device), persistent=False)
            self.onedot_slots = ob.slots

    def bases(self) -> FusedMelBases:
        """K1's constants as the wrapper takes them."""
        return FusedMelBases(self.cos_basis, self.sin_basis, self.mel_fb, self.window, self.twiddle,
                             self.bands, self.band_weights)

    def onedot_bases(self) -> OnedotBases:
        """The onedot variant's constants (a frontend built with onedot)."""
        return OnedotBases(self.onedot_basis, self.mel_fb, self.onedot_chunks, self.onedot_bands, self.onedot_slots)

    def _hop_chunks(self, padded: torch.Tensor) -> torch.Tensor:
        """[B, Lp] → hop-row view [B, T + extra_rows, hop] in the input
        dtype (a reshape plus zero-fill to the row boundary)."""
        B = padded.shape[0]
        hop = self.hop_length
        rows = self.max_frames + extra_rows(self.n_window, hop)
        need = rows * hop
        if padded.shape[1] < need:
            padded = nn.functional.pad(padded, (0, need - padded.shape[1]))
        return padded[:, :need].reshape(B, rows, hop)

    def linear_mel(self, padded: torch.Tensor) -> torch.Tensor:
        """Padded audio [B, Lp] (float32, or int16 PCM) → linear mel
        [B, T, n_mels] through the fused STFT→mel kernel (K1), or its onedot
        variant in a frontend built with it, each called as its torch.library
        op (ops/fused_mel.py), so that torch.export traces it."""
        chunks, dims = self._hop_chunks(padded), (self.n_window, self.hop_length, self.max_frames)
        if self.onedot:
            return torch.ops.dcase19_torch.fused_stft_mel_onedot(chunks, *self.onedot_bases(), *dims)
        return torch.ops.dcase19_torch.fused_stft_mel(chunks, *self.bases(), *dims)

    def amplitude_to_db(self, mel: torch.Tensor, frame_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """librosa amplitude_to_db with ref=1: 20·log10(max(amin, x)), then
        clamp at per-clip max − top_db, the max taken over valid frames."""
        db = 20.0 * torch.log10(torch.clamp(mel, min=self.amin))
        masked = db if frame_mask is None else db.masked_fill(~frame_mask[..., None], -float("inf"))
        peak = masked.amax(dim=(-2, -1), keepdim=True)
        return torch.maximum(db, peak - self.top_db)

    def frame_mask(self, n_valid_frames: torch.Tensor) -> torch.Tensor:
        """[B] valid frame counts → [B, T] bool mask."""
        t = torch.arange(self.max_frames, device=n_valid_frames.device)[None, :]
        return t < n_valid_frames[:, None]

    def log_mel(self, padded: torch.Tensor, n_valid_frames: torch.Tensor) -> torch.Tensor:
        """Padded audio [B, Lp] → log-mel [B, T, M] with zeroed padding
        frames (the reference pads zeros after the log)."""
        mel = self.linear_mel(padded)
        mask = self.frame_mask(n_valid_frames)
        db = self.amplitude_to_db(mel, mask)
        return torch.where(mask[..., None], db, torch.zeros((), dtype=db.dtype, device=db.device))

    def log_mel_pair(self, padded: torch.Tensor, n_valid_frames: torch.Tensor,
                     generator: torch.Generator, noise_std: float = 0.25,
                     teacher_padded: Optional[torch.Tensor] = None) -> tuple:
        """(student, teacher) features of the Mean-Teacher step, the noise
        drawn from `generator`: standard normals of the linear mel's shape
        [B, T, M], made on the generator's device and moved to the audio's
        (see `log_mel_pair_with_noise`)."""
        shape = (padded.shape[0], self.max_frames, self.n_mels)
        noise = torch.randn(shape, generator=generator, device=generator.device, dtype=torch.float32)
        return self.log_mel_pair_with_noise(padded, n_valid_frames, noise, noise_std, teacher_padded)

    def log_mel_pair_with_noise(self, padded: torch.Tensor, n_valid_frames: torch.Tensor,
                                noise: torch.Tensor, noise_std: float = 0.25,
                                teacher_padded: Optional[torch.Tensor] = None) -> tuple:
        """(student, teacher) features from given standard-normal `noise`
        [B, T, M]. |noise_std · noise| is added to the teacher's *linear*
        mel (the reference's AugmentGaussianNoise); the student gets the
        clean tensor; dB, top_db and the padding mask then run on both. With
        `teacher_padded` the teacher's linear mel comes from that second
        audio view (a second K1 launch) and the noise still goes on top. No
        gradient flows into the frontend."""
        with torch.no_grad():
            mel = self.linear_mel(padded)
            mask = self.frame_mask(n_valid_frames)
            zero = torch.zeros((), dtype=mel.dtype, device=mel.device)
            student = torch.where(mask[..., None], self.amplitude_to_db(mel, mask), zero)
            t_mel = mel if teacher_padded is None else self.linear_mel(teacher_padded)
            teacher_mel = t_mel + (noise_std * noise.to(mel.device)).abs()
            teacher = torch.where(mask[..., None], self.amplitude_to_db(teacher_mel, mask), zero)
        return student, teacher


def median_filter_binary(x: torch.Tensor, window: int = 5) -> torch.Tensor:
    """Median filter over the time axis of a binary [..., T, C] grid with
    scipy's 'reflect' edges ((b a | a b c d)), matching
    scipy.ndimage.median_filter(size=(window, 1)): over an odd window the
    median of 0/1 values is `sum > window // 2`."""
    half = window // 2
    if half == 0:
        return x.clone()
    pad_lo = x[..., :half, :].flip(-2)
    pad_hi = x[..., -half:, :].flip(-2)
    xp = torch.cat([pad_lo, x, pad_hi], dim=-2)
    T = x.shape[-2]
    windows = sum(xp[..., i : i + T, :] for i in range(window))
    return (windows > half).to(x.dtype)
