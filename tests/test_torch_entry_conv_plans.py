"""K4f and K5s in bfloat16 (csrc/entry_block.cu entry_conv_bf16_kernel) on
the host: the kernel's plan and how it splits the batch, and the plain
bfloat16 conv and its sums against the JAX package.

The kernel runs only on the card, where tests/test_torch_kernels_gpu.py and
chip_smoke.py hold it to its plain version, to a y formed in conv9's order
and to K2s's sums of its y. Here:

  * `entry_conv.conv_bf16_plan` (tile rows, staged x floats, static shared
    memory) is the kernel's own formulas, read from the source, and fits
    every width `entry_conv_packable` admits;
  * the launch is one wave of the resident blocks, each an equal run of the
    batch's time rows, clip after clip, cut into tiles of at most `rows`
    rows inside a clip (`_tiles` writes out the kernel's loop), at a T that
    leaves a short last tile; K4f and K5s take one grid (the resident entry
    is the fewer of the two modes'), so their sums are the same bits;
  * the port's plain bfloat16 y and sums against the JAX package where
    tests/test_torch_entry_bf16.py (C = 64, F = 64, JAX's `entry_conv` in
    interpret mode) does not reach, each y element within one bfloat16 ulp,
    the sums within 1e-5 of their max: at C = 36 (a width the kernel takes
    in four-channel groups) the sums against the crows block's statistics
    kernel in interpret mode (the JAX planes kernels take C = 64 only). No
    JAX kernel returns y at C = 36 or runs at all at an odd F (63:
    `entry_conv` and `entry_block_stats` take even F only, the latter
    returns NaN there): there y is held to the JAX package's conv layer on
    the same rounded operands in float32, the float32 bias added, then
    rounded, and at F = 63 the sums to the float32 sums of that y.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcase2019_task4_tpu.models import layers as jlayers
from dcase2019_task4_tpu.ops import crows_block as jcr
from dcase2019_task4_tpu_torch.ops import _build
from dcase2019_task4_tpu_torch.ops import entry_conv as tec

SRC = (Path(tec.__file__).parent.parent / "csrc" / "entry_block.cu").read_text()
FREQS = [1, 7, 63, 64, 128]
CHANNELS = [4, 36, 64, 96, 128]


def _smem():
    """The kernel's static shared memory, written out: two x tiles [1024]
    float32 and the threads' float64 sums [2 · 4 channels][128]."""
    return 2 * 1024 * 4 + 2 * 4 * 128 * 8


def test_conv_bf16_plan_matches_the_kernel_source():
    for line in ("constexpr int kConvThreads = 128;", "constexpr int kConvRun = 4;", "constexpr int kConvChans = 4;",
                 "constexpr int kConvHalo = 1024;", "constexpr int kConvNX = kConvHalo / kConvThreads;",
                 "__host__ __device__ inline int conv_stride(int F) { return kConvRun * ((F + kConvRun - 1) / kConvRun) + 4; }",
                 "__shared__ __align__(16) float xs[2][kConvHalo];",
                 "__shared__ double dsum[2 * kConvChans][kConvThreads];",
                 "if (blocks < 1 || rows < 1 || (rows + 2) * conv_stride(F) > kConvHalo || C % kConvChans != 0 ||",
                 "const int lanes = C / kConvChans, groups = kConvThreads / lanes;",
                 "*resident = stored < sums_only ? stored : sums_only;"):
        assert line in SRC, line
    assert tec._CONV_THREADS == int(re.search(r"constexpr int kConvThreads = (\d+);", SRC).group(1))
    assert tec._CONV_RUN == int(re.search(r"constexpr int kConvRun = (\d+);", SRC).group(1))
    assert tec._CONV_CHANS == int(re.search(r"constexpr int kConvChans = (\d+);", SRC).group(1))
    assert tec._CONV_HALO == int(re.search(r"constexpr int kConvHalo = (\d+);", SRC).group(1))
    for F in FREQS:
        assert tec.conv_stride(F) == 4 * -(-F // 4) + 4
    assert tec.conv_bf16_plan(64, 64) == (13, 1020, _smem())
    assert "__launch_bounds__(kConvThreads, 4)\nentry_conv_bf16_kernel(" in SRC


@pytest.mark.parametrize("F", FREQS)
def test_conv_bf16_plan_fits_every_admitted_width(F, monkeypatch):
    """Every run's window (4 ceil(F / 4) + 2 floats) in a row of the staged
    tile, rows + 2 of them within the kernel's 1024 floats; four channels a
    thread, at most 32 lanes; the static shared memory under the 48 KB a
    block takes without opting in; about 1024 pixels a tile where the halo
    allows, and so under the shorter tiles the probe times (512 and 256
    pixels); a C that is no multiple of four refused."""
    for pixels in (1024, 512, 256):
        monkeypatch.setattr(tec, "_CONV_TILE_PIXELS", pixels)
        for C in CHANNELS:
            assert tec.entry_conv_packable(F, C, 7)
            stride = tec.conv_stride(F)
            assert stride % 4 == 0 and 4 * -(-F // 4) + 2 <= stride
            rows, halo, smem = tec.conv_bf16_plan(F, C)
            assert 1 <= C // 4 <= 32
            assert rows >= 1 and halo == (rows + 2) * stride <= 1024
            assert rows == max(1, min(pixels // F, 1024 // stride - 2))
            assert smem == _smem() <= 48 * 1024
    with pytest.raises(ValueError):
        tec.conv_bf16_plan(F, 6)


def _tiles(G, B, T, rows):
    """The kernel's tiles, block by block: block k takes the batch's time rows
    [k n / G, (k + 1) n / G) (n = B T) and cuts them into tiles of up to
    `rows` rows that end at its run's end or the clip's → [[(b, t0,
    trows), ...] per block]."""
    n, out = B * T, []
    for k in range(G):
        cur, end, tiles = k * n // G, (k + 1) * n // G, []
        while cur < end:
            trows = min(rows, T - cur % T, end - cur)
            tiles.append((cur // T, cur % T, trows))
            cur += trows
        out.append(tiles)
    return out


@pytest.mark.parametrize("resident,B,T,F", [(528, 24, 864, 64), (396, 24, 50, 64), (264, 3, 37, 128), (8, 2, 11, 7),
                                            (132, 1, 300, 1)])
def test_conv_bf16_splits_the_batch_in_one_wave_of_equal_runs(resident, B, T, F):
    """One wave of the resident blocks, never more than the batch's rows; the
    runs differ by at most one row and cover every row of every clip once,
    in order; every tile lies in one clip and has at most `rows` rows, and
    at a T that is no multiple of `rows` a clip ends in a short tile."""
    rows = tec.conv_bf16_plan(F, 64)[0]
    G = _build.wave_grid(resident, B, T)
    assert G == min(resident, B * T)
    blocks = _tiles(G, B, T, rows)
    lengths = [sum(tr for _, _, tr in tiles) for tiles in blocks]
    assert min(lengths) >= 1 and max(lengths) - min(lengths) <= 1
    seen = [(b, t0 + i) for tiles in blocks for b, t0, tr in tiles for i in range(tr)]
    assert seen == [(b, t) for b in range(B) for t in range(T)]
    assert all(1 <= tr <= rows and t0 + tr <= T for tiles in blocks for _, t0, tr in tiles)
    if T % rows:
        assert any(t0 + tr == T and tr < rows for tiles in blocks for _, t0, tr in tiles)
    for line in ("const int r_end = (int)((blockIdx.x + 1) * n / gridDim.x);",
                 "int cur = (int)(blockIdx.x * n / gridDim.x);",
                 "auto trows_at = [&](int r) { return min(min(rows, T - r % T), r_end - r); };",
                 "    cur += trows;\n"):
        assert line in SRC, line


# --------------------------------------------- plain versions against JAX


def _ulp(a):
    """The bfloat16 spacing at |a| (floored at the smallest normal)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126))) - 7)


def _inputs(shape, C, seed):
    rng = np.random.default_rng(seed)
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return f(rng.standard_normal(shape + (1,))), f(0.3 * rng.standard_normal((3, 3, 1, C))), f(0.1 * rng.standard_normal(C))


def _held(y, s1, s2, y_ref, s_ref, sq_ref):
    y, y_ref = y.float().numpy(), np.asarray(jnp.asarray(y_ref, jnp.float32))
    assert y.shape == y_ref.shape
    diff = np.abs(y - y_ref)
    assert not (diff > _ulp(np.maximum(np.abs(y), np.abs(y_ref)))).any(), f"y beyond one bfloat16 ulp: {diff.max()}"
    for name, got, want in (("sum y", s1, s_ref), ("sum y^2", s2, sq_ref)):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max(), err_msg=name)


def _jax_conv_bf16(x, w, b):
    """The JAX package's conv layer on the rounded operands in float32, the
    float32 bias added, then rounded: the function of its bfloat16 entry
    kernels, where none of them returns y at this width."""
    r = lambda a: jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32)  # noqa: E731
    return jlayers.conv2d_apply({"w": r(w), "b": jnp.asarray(b)}, r(x)).astype(jnp.bfloat16)


@pytest.mark.parametrize("case", ["C36 crows_stats", "F63 conv layer"])
def test_plain_bf16_conv_and_sums_match_jax(case):
    shape, C = {"C36 crows_stats": ((2, 8, 64), 36), "F63 conv layer": ((2, 8, 63), 64)}[case]
    x, w, b = _inputs(shape, C, sum(shape) + C)
    conv = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    y, s1, s2 = tec.entry_conv_forward({"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                                       torch.from_numpy(x[..., 0]).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16 and s1.dtype == s2.dtype == torch.float32
    if case.startswith("C36"):
        s_ref, sq_ref = jcr.crows_stats_apply(conv, jnp.asarray(x), compute_dtype=jnp.bfloat16, interpret=True)
        y_ref = _jax_conv_bf16(x, w, b)
    else:
        y_ref = _jax_conv_bf16(x, w, b)
        yf = y_ref.astype(jnp.float32)
        s_ref, sq_ref = jnp.sum(yf, axis=(0, 1, 2)), jnp.sum(yf * yf, axis=(0, 1, 2))
    _held(y, s1, s2, y_ref, s_ref, sq_ref)
