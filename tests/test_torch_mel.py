"""Port parity: the log-mel frontend and K1 (fused STFT→mel).

The same numpy inputs go through the JAX package's MelFrontend (K1 in
Pallas interpret mode, and the plain "chunked" XLA path) and through the
port's MelFrontend on CPU tensors, where K1's wrapper runs its plain twin.
Tolerances: linear mel 1e-5·max (float32 sums taken in another order),
log-mel 1e-3 dB.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcase2019_task4_tpu.config import DSPConfig
from dcase2019_task4_tpu.ops import fused_mel as jfm
from dcase2019_task4_tpu.ops import mel as jmel
from dcase2019_task4_tpu_torch.ops import fused_mel as tfm
from dcase2019_task4_tpu_torch.ops import mel as tmel

TINY = dict(sample_rate=16000, n_window=32, hop_length=12, n_mels=8, f_min=0.0, f_max=8000.0,
            max_frames=8)
_D = DSPConfig(max_len_seconds=1.11)  # the dryrun geometry: T = 96 frames
DRYRUN = dict(sample_rate=_D.sample_rate, n_window=_D.n_window, hop_length=_D.hop_length,
              n_mels=_D.n_mels, f_min=_D.f_min, f_max=_D.f_max, max_frames=_D.max_frames)
GEOMS = {"tiny": TINY, "dryrun": DRYRUN}


def _max_samples(kw):
    return kw["hop_length"] * (kw["max_frames"] - 1)


def _padded_batch(kw, seed, lengths):
    rng = np.random.default_rng(seed)
    clips = [0.3 * rng.standard_normal(n).astype(np.float32) for n in lengths]
    return jmel.host_reflect_pad(clips, _max_samples(kw), kw["n_window"], kw["hop_length"],
                                 kw["max_frames"])


@pytest.mark.parametrize("name,args", [
    ("hz_to_mel_slaney", (np.linspace(0, 22050, 257),)),
    ("mel_to_hz_slaney", (np.linspace(0, 40, 257),)),
    ("mel_filterbank", (44100, 2048, 64, 0.0, 22050.0)),
    ("mel_filterbank", (16000, 32, 8, 0.0, 8000.0)),
    ("hamming_window", (2048,)),
    ("num_frames", (np.arange(0, 5000, 37), 511)),
])
def test_builders_equal_bitwise(name, args):
    np.testing.assert_array_equal(getattr(tmel, name)(*args), getattr(jmel, name)(*args))


def test_dft_bases_equal_bitwise():
    w = jmel.hamming_window(2048)
    for a, b in zip(tmel.dft_bases(2048, w), jmel.dft_bases(2048, w)):
        np.testing.assert_array_equal(a, b)


def test_host_reflect_pad_equal_bitwise():
    rng = np.random.default_rng(0)
    clips = [rng.standard_normal(n).astype(np.float32) for n in (900, 1400, 2000)]
    for a, b in zip(tmel.host_reflect_pad(clips, 1200, 64, 20, 61),
                    jmel.host_reflect_pad(clips, 1200, 64, 20, 61)):
        np.testing.assert_array_equal(a, b)


def test_trimmed_bins_and_bases_match_jax():
    fb = jmel.mel_filterbank(44100, 2048, 64, 0.0, 22050.0)
    assert tfm.trimmed_bins(fb) == jfm.trimmed_bins(fb) == 1024
    assert tfm.extra_rows(2048, 511) == jfm.extra_rows(2048, 511) == 4
    cos, sin = jmel.dft_bases(2048, jmel.hamming_window(2048))
    ours = tfm.build_bases(cos, sin, fb)
    theirs = jfm.build_bases(cos, sin, fb, 511, jnp.float32)
    # the TPU kernel's hop-wide parts + tail are a split of the same rows
    for whole, main, tail in ((ours.cos, theirs.cos_main, theirs.cos_tail),
                              (ours.sin, theirs.sin_main, theirs.sin_tail)):
        joined = np.concatenate([*np.asarray(main), np.asarray(tail)])
        np.testing.assert_array_equal(whole, joined)
    np.testing.assert_array_equal(ours.mel_fb, np.asarray(theirs.mel_fb))


@pytest.mark.parametrize("geom", ["tiny", "dryrun"])
@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("jax_mode", ["pallas_interpret", "chunked"])
def test_linear_mel_matches_jax(geom, dtype, jax_mode):
    kw = GEOMS[geom]
    T, hop = kw["max_frames"], kw["hop_length"]
    padded, _ = _padded_batch(kw, 1, [hop * T, hop * (T - 3) + 5])
    if dtype == "int16":
        padded = np.clip(np.round(padded * 32768), -32768, 32767).astype(np.int16)
    if jax_mode == "pallas_interpret":
        fe_j = jmel.MelFrontend(pallas_interpret=True, **kw)
        assert fe_j.stft_mode == "pallas"
    else:
        fe_j = jmel.MelFrontend(stft_mode="chunked", **kw)
    ref = np.asarray(fe_j.linear_mel(jnp.asarray(padded)))
    out = tmel.MelFrontend(**kw).linear_mel(torch.from_numpy(padded)).numpy()
    assert out.shape == ref.shape == (2, T, kw["n_mels"])
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("geom", ["tiny", "dryrun"])
def test_log_mel_matches_jax(geom):
    kw = GEOMS[geom]
    T, hop = kw["max_frames"], kw["hop_length"]
    padded, frames = _padded_batch(kw, 2, [hop * T, hop * (T // 2), hop * (T - 2) + 3])
    fe_j = jmel.MelFrontend(pallas_interpret=True, **kw)
    ref = np.asarray(fe_j.log_mel(jnp.asarray(padded), jnp.asarray(frames)))
    out = tmel.MelFrontend(**kw).log_mel(torch.from_numpy(padded), torch.from_numpy(frames)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-3)
    short = int(frames[1])
    assert short < T and np.all(out[1, short:] == 0.0)


@pytest.mark.parametrize("window", [1, 3, 5, 7])
def test_median_filter_binary_matches_jax(window):
    rng = np.random.default_rng(window)
    x = (rng.random((3, 12, 10)) > 0.5).astype(np.float32)
    ref = np.asarray(jmel.median_filter_binary(jnp.asarray(x), window))
    out = tmel.median_filter_binary(torch.from_numpy(x), window).numpy()
    np.testing.assert_array_equal(out, ref)


def test_fused_stft_mel_refuses_short_chunks_and_other_devices():
    kw = TINY
    fe = tmel.MelFrontend(**kw)
    bases = tfm.FusedMelBases(fe.cos_basis, fe.sin_basis, fe.mel_fb)
    args = dict(n_fft=kw["n_window"], hop=kw["hop_length"], T=kw["max_frames"])
    short = torch.zeros(1, kw["max_frames"], kw["hop_length"])
    with pytest.raises(ValueError, match="do not cover"):
        tfm.fused_stft_mel(short, bases, **args)
    rows = kw["max_frames"] + tfm.extra_rows(kw["n_window"], kw["hop_length"])
    with pytest.raises(ValueError, match="cpu or cuda"):
        tfm.fused_stft_mel(torch.zeros(1, rows, kw["hop_length"], device="meta"), bases, **args)
