"""K1's FFT design on the CPU: the kernel's tables and a mirror of its arithmetic.

The CUDA kernel (csrc/fused_mel.cu) computes each frame's real DFT as an
n_fft/2-point complex FFT of the packed, windowed samples (Stockham passes,
mostly of radix 16, the last of radix 4), splits the real
spectrum, and sums each mel band over its own bins. It runs only on the
card; here `_mirror_linear_mel` repeats those steps in torch with the same
tables and the same index arithmetic, and is held to the port's plain DFT
version (both against a float64 DFT of the same bases at the dryrun
geometry) and to the JAX package's "fft" STFT mode. Tolerances: the tables
exact (twiddles within 1 ulp of float64); the mirror 1e-5 of the output's
max (float32 sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcase2019_task4_tpu.config import DSPConfig
from dcase2019_task4_tpu.ops import mel as jmel
from dcase2019_task4_tpu_torch.ops import fused_mel as tfm
from dcase2019_task4_tpu_torch.ops import mel as tmel

TINY = dict(sample_rate=16000, n_window=32, hop_length=12, n_mels=8, f_min=0.0, f_max=8000.0,
            max_frames=8)
_D = DSPConfig(max_len_seconds=1.11)  # the dryrun geometry: T = 96 frames
DRYRUN = dict(sample_rate=_D.sample_rate, n_window=_D.n_window, hop_length=_D.hop_length,
              n_mels=_D.n_mels, f_min=_D.f_min, f_max=_D.f_max, max_frames=_D.max_frames)
# (sample rate, n_fft, mels, f_min, f_max): the flagship, the scaled configuration, the tiny one
FILTERBANKS = {"flagship": (44100, 2048, 64, 0.0, 22050.0), "scaled": (44100, 2048, 128, 0.0, 22050.0),
               "tiny": (16000, 32, 8, 0.0, 8000.0)}


def _bases(sample_rate, n_fft, n_mels, f_min, f_max):
    fb = tmel.mel_filterbank(sample_rate, n_fft, n_mels, f_min, f_max)
    cos, sin = tmel.dft_bases(n_fft, tmel.hamming_window(n_fft))
    return tfm.build_bases(cos, sin, fb)


def _plan(log2n: int) -> list:
    """The kernel's passes (radix, log2 Ns): a first pass of radix 16, 2 or
    4, or radix 2 then 4, that leaves 2 + a multiple of 4 bits; radix-16
    passes; the last, radix 4 at Ns = N/4 (where the kernel also splits the
    real spectrum)."""
    passes = {0: [(16, 0)], 1: [(2, 0)], 2: [(4, 0)], 3: [(2, 0), (4, 1)]}[(log2n - 2) % 4]
    bits = sum(r.bit_length() - 1 for r, _ in passes)
    while bits < log2n - 2:
        passes.append((16, bits))
        bits += 4
    return passes + [(4, bits)]


def _dft4(v0, v1, v2, v3):
    a0, a1, a2, a3 = v0 + v2, v0 - v2, v1 + v3, -1j * (v1 - v3)
    return [a0 + a2, a1 + a3, a0 - a2, a1 - a3]


W16 = torch.tensor(np.exp(-2j * np.pi * np.arange(16) / 16), dtype=torch.complex64)


def _dft(v: list) -> list:
    """The kernel's in-register DFT of radix 2, 4 or 16 (16 as a 4 × 4
    split: n = 4a + b, m = c + 4d)."""
    if len(v) == 2:
        return [v[0] + v[1], v[0] - v[1]]
    if len(v) == 4:
        return _dft4(*v)
    cols = [_dft4(v[b], v[4 + b], v[8 + b], v[12 + b]) for b in range(4)]  # cols[b][c]
    rows = [_dft4(*[cols[b][c] * W16[b * c] for b in range(4)]) for c in range(4)]  # rows[c][d]
    return [rows[q % 4][q // 4] for q in range(16)]


def _stockham(z: torch.Tensor, twiddle: np.ndarray) -> torch.Tensor:
    """The kernel's FFT passes on z [..., N] complex64: the pass of radix r
    at sub-transform size Ns reads j + q·N/r, multiplies point q by
    W_{Ns·r}^{kq} (k = j mod Ns; W_N^e read from the table of W_2N^m, m < N,
    at 2e, negated past N) and writes (j − k)·r + k + q·Ns."""
    N = z.shape[-1]
    L = N.bit_length() - 1
    table = torch.complex(torch.from_numpy(twiddle[:, 0]), torch.from_numpy(twiddle[:, 1]))

    def w_n(e):
        two = 2 * e
        return torch.where(two < N, table[two.clamp(max=N - 1)], -table[(two - N).clamp(min=0)])

    for r, log2ns in _plan(L):
        Ns, nr = 1 << log2ns, N // r
        j = torch.arange(nr)
        k = j & (Ns - 1)
        shift = L - log2ns - (r.bit_length() - 1)
        v = [z[..., j + q * nr] for q in range(r)]
        if Ns > 1:
            v = [v[0]] + [v[q] * w_n((k * q) << shift) for q in range(1, r)]
        out = torch.empty_like(z)
        base = (j - k) * r + k
        for q, y in enumerate(_dft(v)):
            out[..., base + q * Ns] = y
        z = out
    return z


def _mirror_linear_mel(chunks: torch.Tensor, bases, *, n_fft: int, hop: int, T: int) -> torch.Tensor:
    """Half-length complex FFT → even/odd split → twiddles → magnitude →
    band sums, in float32 from the kernel's tables."""
    x = chunks.to(torch.float32) * (1.0 / 32768.0) if chunks.dtype == torch.int16 else chunks.to(torch.float32)
    frames = x.reshape(x.shape[0], -1).unfold(1, n_fft, hop)[:, :T]  # [B, T, n_fft]
    window = torch.from_numpy(bases.window)
    z = torch.complex(window[0::2] * frames[..., 0::2], window[1::2] * frames[..., 1::2])
    Z = _stockham(z, bases.twiddle)
    N = n_fft // 2
    k = torch.arange(bases.mel_fb.shape[0])
    a, b = Z[..., k % N], torch.conj(Z[..., (N - k) % N])
    table = torch.complex(torch.from_numpy(bases.twiddle[:, 0]), torch.from_numpy(bases.twiddle[:, 1]))
    w = torch.where(k < N, table[k.clamp(max=N - 1)], torch.tensor(-1.0 + 0j, dtype=table.dtype))
    mag = (0.5 * (a + b) - 1j * w * (0.5 * (a - b))).abs()
    weights = torch.from_numpy(bases.band_weights)
    return torch.stack([(mag[..., first:first + n] * weights[off:off + n]).sum(-1)
                        for first, n, off in bases.bands.tolist()], dim=-1)


def _padded(kw, seed, dtype):
    rng = np.random.default_rng(seed)
    T, hop = kw["max_frames"], kw["hop_length"]
    clips = [0.3 * rng.standard_normal(n).astype(np.float32) for n in (hop * T, hop * (T - 3) + 5)]
    padded, _ = jmel.host_reflect_pad(clips, hop * (T - 1), kw["n_window"], hop, T)
    if dtype == "int16":
        padded = np.clip(np.round(padded * 32768), -32768, 32767).astype(np.int16)
    return padded


@pytest.mark.parametrize("name", sorted(FILTERBANKS))
def test_band_table_rebuilds_mel_fb(name):
    bases = _bases(*FILTERBANKS[name])
    nb, M = bases.mel_fb.shape
    assert bases.bands.shape == (M, 3) and bases.bands.dtype == np.int32
    dense = np.zeros_like(bases.mel_fb)
    for m, (first, n, off) in enumerate(bases.bands.tolist()):
        assert 0 <= first and first + n <= nb and off + n <= bases.band_weights.size
        dense[first:first + n, m] = bases.band_weights[off:off + n]
    np.testing.assert_array_equal(dense, bases.mel_fb)
    assert bases.band_weights.size == int(bases.bands[:, 1].sum())
    assert (np.count_nonzero(bases.mel_fb, axis=1) <= 2).all()  # triangles: at most two bands a bin
    if name == "flagship":
        assert bases.band_weights.size == np.count_nonzero(bases.mel_fb) == 1982


@pytest.mark.parametrize("n_fft", [32, 2048])
def test_window_is_hamming_and_bin0_cosine_bitwise(n_fft):
    cos, _ = tmel.dft_bases(n_fft, tmel.hamming_window(n_fft))
    fb = tmel.mel_filterbank(44100, n_fft, 8, 0.0, 22050.0)
    window = tfm.build_bases(cos, cos, fb).window
    assert window.dtype == np.float32 and window.shape == (n_fft,)
    np.testing.assert_array_equal(window, tmel.hamming_window(n_fft))
    np.testing.assert_array_equal(window, jmel.hamming_window(n_fft))
    np.testing.assert_array_equal(window, cos[:, 0])


@pytest.mark.parametrize("n_fft", [64, 2048, 4096])
def test_twiddle_table_within_one_ulp_of_float64(n_fft):
    tw = tfm.twiddle_table(n_fft)
    assert tw.shape == (n_fft // 2, 2) and tw.dtype == np.float32
    ang = 2.0 * np.pi * np.arange(n_fft // 2) / n_fft
    for got, want in ((tw[:, 0], np.cos(ang)), (tw[:, 1], -np.sin(ang))):
        ulp = np.spacing(np.abs(want).astype(np.float32))
        assert (np.abs(got.astype(np.float64) - want) <= ulp).all()


@pytest.mark.parametrize("n_fft,plan", [
    (64, [(2, 0), (4, 1), (4, 3)]), (128, [(16, 0), (4, 4)]), (256, [(2, 0), (16, 1), (4, 5)]),
    (512, [(4, 0), (16, 2), (4, 6)]), (1024, [(2, 0), (4, 1), (16, 3), (4, 7)]),
    (2048, [(16, 0), (16, 4), (4, 8)]), (4096, [(2, 0), (16, 1), (16, 5), (4, 9)]),
])
def test_stockham_passes_match_torch_fft(n_fft, plan):
    assert _plan(n_fft.bit_length() - 2) == plan
    rng = np.random.default_rng(n_fft)
    z = torch.from_numpy((rng.standard_normal((3, n_fft // 2)) + 1j * rng.standard_normal((3, n_fft // 2)))
                         .astype(np.complex64))
    want = torch.fft.fft(z.to(torch.complex128))
    got = _stockham(z, tfm.twiddle_table(n_fft)).to(torch.complex128)
    assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()


def _dft64(chunks: torch.Tensor, bases, *, n_fft: int, hop: int, T: int) -> torch.Tensor:
    """The plain version's DFT (frames from the hop rows, the cos and sin
    bases, magnitude, the mel matrix) in float64: the oracle both float32
    engines are held to."""
    rows = tfm._dequantize(chunks).double()
    p_full, tail = n_fft // hop, n_fft % hop
    frames = torch.cat([rows[:, p:p + T, :] for p in range(p_full)]
                       + ([rows[:, p_full:p_full + T, :tail]] if tail else []), dim=-1)
    re, im = frames @ bases.cos.double(), frames @ bases.sin.double()
    return torch.sqrt(re * re + im * im) @ bases.mel_fb.double()


@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_mirror_matches_plain_dft_at_dryrun_geometry(dtype):
    """The mirror and the plain float32 DFT, each against the float64 DFT
    of the same bases within 1e-5 of the output's max (typically 0.013 and
    0.04 of that bar): each engine's own error, not their difference."""
    kw = DRYRUN
    fe = tmel.MelFrontend(**kw)
    chunks = fe._hop_chunks(torch.from_numpy(_padded(kw, 3, dtype)))
    args = dict(n_fft=kw["n_window"], hop=kw["hop_length"], T=kw["max_frames"])
    bases = _bases(kw["sample_rate"], kw["n_window"], kw["n_mels"], kw["f_min"], kw["f_max"])
    want = _dft64(chunks, fe.bases(), **args)
    plain = tfm.fused_stft_mel_reference(chunks, fe.bases(), **args)
    got = _mirror_linear_mel(chunks, bases, **args)
    assert got.shape == plain.shape == want.shape == (2, kw["max_frames"], kw["n_mels"])
    tol = 1e-5 * want.abs().max().item()
    errs = {name: (side.double() - want).abs() for name, side in (("mirror", got), ("plain DFT", plain))}
    shown = ", ".join(f"{name} {e.max().item():.3e} ({int((e > tol).sum())} elements over, worst at "
                      f"{tuple(np.unravel_index(int(e.argmax()), e.shape))})" for name, e in errs.items())
    assert all(e.max().item() <= tol for e in errs.values()), f"against the float64 DFT, bar {tol:.3e}: {shown}"


@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("f_max,n_mels", [(8000.0, 8), (9000.0, 6)])
def test_mirror_matches_jax_fft_mode_at_tiny_geometry(dtype, f_max, n_mels):
    # 9 kHz puts mel weight on the Nyquist bin; the JAX frontend's jit cache
    # keys on n_mels but not on f_max, so that case also takes other n_mels
    kw = dict(TINY, f_max=f_max, n_mels=n_mels)
    padded = _padded(kw, 4, dtype)
    want = np.asarray(jmel.MelFrontend(stft_mode="fft", **kw).linear_mel(jnp.asarray(padded)))
    fe = tmel.MelFrontend(**kw)
    bases = _bases(kw["sample_rate"], kw["n_window"], kw["n_mels"], kw["f_min"], kw["f_max"])
    assert bases.mel_fb.shape[0] == kw["n_window"] // 2 + (f_max > kw["sample_rate"] / 2)
    got = _mirror_linear_mel(fe._hop_chunks(torch.from_numpy(padded)), bases, n_fft=kw["n_window"],
                             hop=kw["hop_length"], T=kw["max_frames"]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("n_fft,n_bins,n_mels,message", [
    (2000, 1001, 64, "power of two"),
    (32, 17, 8, "power of two from 64 to 4096"),
    (8192, 1024, 64, "power of two from 64 to 4096"),
    (2048, 1024, 129, "1 to 128"),
    (2048, 1026, 64, "1025"),
])
def test_kernel_args_refused(n_fft, n_bins, n_mels, message):
    with pytest.raises(ValueError, match=message):
        tfm.check_kernel_args(n_fft, n_bins, n_mels)


@pytest.mark.parametrize("n_fft,n_mels", [(64, 8), (2048, 64), (2048, 128), (4096, 128)])
def test_kernel_args_taken(n_fft, n_mels):
    tfm.check_kernel_args(n_fft, n_fft // 2 + 1, n_mels)


def test_frontend_holds_the_tables_outside_its_state_dict():
    fe = tmel.MelFrontend(**TINY)
    assert sorted(fe.state_dict()) == ["cos_basis", "mel_fb", "sin_basis"]
    bases = fe.bases()
    assert bases.bands.dtype == torch.int32 and bases.twiddle.shape == (TINY["n_window"] // 2, 2)
    np.testing.assert_array_equal(bases.window.numpy(), bases.cos[:, 0].numpy())
    # the three-field construction of the plain version still runs on the CPU
    chunks = fe._hop_chunks(torch.from_numpy(_padded(TINY, 5, "float32")))
    args = dict(n_fft=TINY["n_window"], hop=TINY["hop_length"], T=TINY["max_frames"])
    three = tfm.FusedMelBases(fe.cos_basis, fe.sin_basis, fe.mel_fb)
    torch.testing.assert_close(tfm.fused_stft_mel(chunks, three, **args), tfm.fused_stft_mel(chunks, bases, **args),
                               rtol=0, atol=0)
