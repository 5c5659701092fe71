"""Port parity: K1's cos‖sin basis variant (DCASE_FUSED_MEL_ONEDOT).

The port's onedot frontend (`MelFrontend(onedot=True)`: the plain version
`fused_stft_mel_onedot_reference` on CPU tensors) against the JAX frontend
with `fused_mel.ONEDOT` patched True and `pallas_interpret=True` (its
`_kernel_onedot` interpreted), at the three geometries of
tests/test_fused_mel.py::test_interpret_onedot_matches_chunked (a tail part,
no tail, 128 mels), on int16 input: linear mel within 1e-5 of its max,
log-mel with the frame mask within 1e-4 (absolute, in dB), padding frames
zero. The basis is built bit for bit as JAX's `build_onedot_bases` builds
it in float32. A checkpoint stored without the knob predicts with it set:
the basis is a non-persistent buffer and the function is the same.
"""

import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcase2019_task4_tpu.ops import fused_mel as jfm
from dcase2019_task4_tpu.ops import mel as jmel
from dcase2019_task4_tpu_torch.ops import fused_mel as tfm
from dcase2019_task4_tpu_torch.ops import mel as tmel

TINY = dict(sample_rate=16000, n_window=32, hop_length=12, n_mels=8, f_min=0.0, f_max=8000.0, max_frames=8)
GEOMETRIES = [
    {},  # tail part present (hop 12, n_fft 32)
    {"n_window": 32, "hop_length": 16, "max_frames": 8},  # no tail
    {"n_mels": 128, "f_max": 8000.0},  # wide mel (scaled geometry)
]


@pytest.mark.parametrize("over", GEOMETRIES)
def test_onedot_frontend_matches_jax_interpreted(monkeypatch, over):
    monkeypatch.setattr(jfm, "ONEDOT", True)
    kw = dict(TINY, **over)
    fe_j = jmel.MelFrontend(stft_mode="auto", pallas_interpret=True, **kw)
    assert isinstance(fe_j._fused_bases, jfm.OnedotBases)
    fe_t = tmel.MelFrontend(**kw, onedot=True)
    rng = np.random.default_rng(7)
    a16 = (rng.standard_normal((3, 150)) * 9000).astype(np.int16)
    want = np.asarray(fe_j.linear_mel(jnp.asarray(a16)))
    got = fe_t.linear_mel(torch.from_numpy(a16)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    frames = np.asarray([8, 5, 8])
    lw = np.asarray(fe_j.log_mel(jnp.asarray(a16), jnp.asarray(frames)))
    lg = fe_t.log_mel(torch.from_numpy(a16), torch.from_numpy(frames)).numpy()
    np.testing.assert_allclose(lg, lw, rtol=0, atol=1e-4)
    assert np.all(lg[1, 5:] == 0.0)


@pytest.mark.parametrize("over", GEOMETRIES)
def test_onedot_bases_equal_jax_bit_for_bit(over):
    kw = dict(TINY, **over)
    n_fft, hop = kw["n_window"], kw["hop_length"]
    fb = jmel.mel_filterbank(kw["sample_rate"], n_fft, kw["n_mels"], kw["f_min"], kw["f_max"])
    cos_b, sin_b = jmel.dft_bases(n_fft, jmel.hamming_window(n_fft))
    jb = jfm.build_onedot_bases(cos_b, sin_b, fb, hop, jnp.float32)
    parts = [np.asarray(jb.dft_main).reshape(-1, jb.dft_main.shape[-1])]
    if jb.dft_tail is not None:
        parts.append(np.asarray(jb.dft_tail))
    jdft = np.concatenate(parts)
    # the port builds from its own copies of the constant builders
    tfb_ = tmel.mel_filterbank(kw["sample_rate"], n_fft, kw["n_mels"], kw["f_min"], kw["f_max"])
    tcos, tsin = tmel.dft_bases(n_fft, tmel.hamming_window(n_fft))
    tb = tfm.build_onedot_bases(tcos, tsin, tfb_)
    assert tb.dft.dtype == np.float32 and tb.dft.shape == jdft.shape
    np.testing.assert_array_equal(tb.dft, jdft)
    np.testing.assert_array_equal(tb.mel_fb, np.asarray(jb.mel_fb))
    fe = tmel.MelFrontend(**kw, onedot=True)
    np.testing.assert_array_equal(fe.onedot_basis.numpy(), jdft)


def test_frontend_reads_the_module_constant_at_construction(monkeypatch):
    monkeypatch.setattr(tfm, "ONEDOT", True)
    on = tmel.MelFrontend(**TINY)
    monkeypatch.setattr(tfm, "ONEDOT", False)
    off = tmel.MelFrontend(**TINY)
    assert on.onedot and not off.onedot
    assert set(on.state_dict()) == set(off.state_dict())  # the basis is not persistent
    a = torch.from_numpy((np.random.default_rng(3).standard_normal((2, 150)) * 9000).astype(np.int16))
    ref = off.linear_mel(a)
    torch.testing.assert_close(on.linear_mel(a), ref, rtol=0, atol=1e-5 * ref.abs().max().item())


def test_onedot_reference_equals_the_chunked_plain_version_at_the_flagship_geometry():
    """At the flagship's n_fft 2048, hop 511, 64 mels (a tail part): the
    onedot plain version against the default plain version on the same
    chunks, within 1e-5 of max."""
    fe = tmel.MelFrontend(max_frames=12, onedot=True)
    rng = np.random.default_rng(11)
    audio = torch.from_numpy((0.1 * rng.standard_normal((2, 12 * 511 + 2048))).astype(np.float32))
    chunks = fe._hop_chunks(audio)
    kw = dict(n_fft=2048, hop=511, T=12)
    got = tfm.fused_stft_mel_onedot(chunks, fe.onedot_bases(), **kw)
    want = tfm.fused_stft_mel_reference(chunks, fe.bases(), **kw)
    assert got.shape == (2, 12, 64)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())


def test_a_checkpoint_stored_without_the_knob_predicts_with_it(monkeypatch, tmp_path):
    """A port checkpoint written with the knob unset, predicted on the CPU
    with the knob off and on: the same strong probabilities within 1e-5."""
    from dcase2019_task4_tpu_torch import cli
    from dcase2019_task4_tpu_torch.config import DEFAULT_CLASSES, Config, DSPConfig, ModelConfig
    from dcase2019_task4_tpu_torch.data.audio_io import synth_clip, write_wav
    from dcase2019_task4_tpu_torch.data.encoder import LabelCodec
    from dcase2019_task4_tpu_torch.models.crnn import CRNN, seeded_init_
    from dcase2019_task4_tpu_torch.train import checkpoints as ckpt

    cfg = Config(dsp=DSPConfig(max_len_seconds=1.11), model=ModelConfig(nb_filters=(16, 16, 16), n_rnn_cell=16))
    d = cfg.dsp
    wav_dir = tmp_path / "wavs"
    wav_dir.mkdir()
    for i in range(3):
        name = f"clip_{i}.wav"
        write_wav(str(wav_dir / name), synth_clip(name, [(i, 0.1, 0.9)], d.max_len_seconds, d.sample_rate),
                  d.sample_rate)
    params, bn_state = ckpt.params_to_jax(seeded_init_(CRNN(cfg.model), 2))
    meta = {"epoch": 0, "valid_metric": {}, "pooling_time_ratio": cfg.model.pooling_time_ratio,
            "scaler": {"mean_": [-40.0] * d.n_mels, "mean_of_square_": [1825.0] * d.n_mels},
            "many_hot_encoder": LabelCodec(DEFAULT_CLASSES, d.max_frames // 8).state_dict(),
            "config": dataclasses.asdict(cfg), "mean_teacher": True}
    model = str(tmp_path / "model.npz")
    ckpt.save_inference_checkpoint(model, params, bn_state, meta)
    strong = []
    for onedot in (False, True):
        monkeypatch.setattr(tfm, "ONEDOT", onedot)
        res = cli.predict(["-m", model, "-i", str(wav_dir), "-p", str(tmp_path / f"events_{onedot}.tsv"),
                           "--device", "cpu"])
        strong.append(res["strong"])
    assert strong[0].shape == (3, d.max_frames // 8, 10) and np.isfinite(strong[1]).all()
    np.testing.assert_allclose(strong[1], strong[0], rtol=0, atol=1e-5)


# the configurations' frontends (flagship 64 mels, scaled 128) and the tiny geometries above
PLAN_GEOMETRIES = [dict(n_mels=64), dict(n_mels=128)] + [dict(TINY, **over) for over in GEOMETRIES]


def _mel_fb(kw):
    d = dict(sample_rate=44100, n_window=2048, f_min=0.0, f_max=22050.0)
    d.update(kw)
    fb_full = tmel.mel_filterbank(d["sample_rate"], d["n_window"], d["n_mels"], d["f_min"], d["f_max"])
    return np.ascontiguousarray(fb_full[: tfm.trimmed_bins(fb_full)], np.float32)


@pytest.mark.parametrize("kw", PLAN_GEOMETRIES)
def test_onedot_plan_covers_every_bin_and_band_once(kw):
    """The onedot kernel's plan: the chunks tile the bins, each band's bin
    range is its nonzero weights and its chunks cover them, every (chunk,
    band) share has its own slot, and the fold of the shares, mirrored in
    float64, is the mel product."""
    fb = _mel_fb(kw)
    nb, M = fb.shape
    chunks, bands, slots = tfm.onedot_plan(fb)
    n_chunks = -(-nb // tfm.ONEDOT_BINS)
    assert chunks.shape == (n_chunks, 3) and bands.shape == (M, 4)
    assert chunks.dtype == bands.dtype == np.int32
    assert np.array_equal(chunks[:, 2], np.concatenate([[0], np.cumsum(chunks[:, 1])[:-1]]))
    # each share the fold reads has a slot; where no band is empty (the
    # configurations' frontends) every slot is such a share
    reads = (bands[:, 3] - bands[:, 2]).sum()
    assert reads <= slots == chunks[:, 1].sum() <= n_chunks * M
    if (bands[:, 1] > bands[:, 0]).all():
        assert slots == reads
    for m in range(M):
        nz = np.flatnonzero(fb[:, m])
        first, end, cf, ce = bands[m]
        assert (first, end) == ((nz[0], nz[-1] + 1) if nz.size else (0, 0))
        assert cf * tfm.ONEDOT_BINS <= first and end <= ce * tfm.ONEDOT_BINS
        for c in range(cf, ce):  # each chunk of the band keeps a slot for it
            assert chunks[c, 0] <= m < chunks[c, 0] + chunks[c, 1]
    rng = np.random.default_rng(3)
    mag = rng.random((5, nb))
    work = np.zeros((5, slots))
    for c, (m_lo, n, off) in enumerate(chunks):  # the kernel's epilogue
        for m in range(m_lo, m_lo + n):
            lo, hi = max(bands[m, 0], c * tfm.ONEDOT_BINS), min(bands[m, 1], (c + 1) * tfm.ONEDOT_BINS)
            work[:, off + m - m_lo] = mag[:, lo:hi] @ fb[lo:hi, m] if lo < hi else 0.0
    folded = np.stack([sum((work[:, chunks[c, 2] + m - chunks[c, 0]] for c in range(bands[m, 2], bands[m, 3])),
                           np.zeros(5)) for m in range(M)], axis=1)
    np.testing.assert_allclose(folded, mag @ fb.astype(np.float64), rtol=1e-12, atol=1e-12)


def test_onedot_plan_of_the_configurations():
    """The workspace the flagship (64 mels) and scaled (128 mels) frontends
    give the kernel: 8 chunks of 128 bins, 78 and 141 slots a frame."""
    for n_mels, want in ((64, 78), (128, 141)):
        chunks, _, slots = tfm.onedot_plan(_mel_fb(dict(n_mels=n_mels)))
        assert (len(chunks), slots) == (8, want)


def test_onedot_kernel_constants_fit_the_card():
    """The kernel's tile constants: its bins a block are ONEDOT_BINS, its
    ring of stages (and the magnitude tile over them) fits a block's share
    of an H100's shared memory, and its frame tiles cover every frame of
    the configurations' clips once."""
    src = (Path(tfm.__file__).parent.parent / "csrc" / "fused_mel_onedot.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kBins"] == tfm.ONEDOT_BINS
    stage = const["kBK"] * ((const["kBM"] + 4) + 2 * const["kBins"])
    smem = 4 * const["kStages"] * stage
    assert smem <= 232448 and const["kBM"] * (const["kBins"] + 1) <= const["kStages"] * stage
    for T in (864, 37, 96, 8):
        tiles = -(-T // const["kBM"])
        assert (tiles - 1) * const["kBM"] < T <= tiles * const["kBM"]


def test_onedot_bases_carry_the_plan():
    fe = tmel.MelFrontend(max_frames=12, onedot=True)
    ob = fe.onedot_bases()
    chunks, bands, slots = tfm.onedot_plan(fe.mel_fb.numpy())
    assert np.array_equal(ob.chunks.numpy(), chunks) and np.array_equal(ob.bands.numpy(), bands)
    assert ob.slots == slots and ob.chunks.dtype == torch.int32
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        tfm.fused_stft_mel_onedot(torch.zeros((1, 16, 511), device="meta"), ob, n_fft=2048, hop=511, T=12)
