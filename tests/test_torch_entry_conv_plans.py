"""The one-wave conv (csrc/entry_block.cu entry_conv_run_kernel: K4f and K5s
in bfloat16, K5s in float32) on the host: the kernel's plan and how it
splits the batch, and the plain conv and its sums against the JAX package.

The kernel runs only on the card, where tests/test_torch_kernels_gpu.py and
chip_smoke.py hold it to its plain version, to a y formed in conv9's order
and to K2s's sums of its y. Here:

  * `entry_conv.conv_run_plan` (tile rows, staged x floats, static shared
    memory) is the kernel's own formulas, read from the source, and fits
    every width `entry_conv_packable` admits; x is staged as float32 in
    both types, so one plan serves both;
  * the launch is one wave of the resident blocks, each an equal run of the
    batch's time rows, clip after clip, cut into tiles of at most `rows`
    rows inside a clip (`_tiles` writes out the kernel's loop), at a T that
    leaves a short last tile; K4f and K5s take one grid (the resident entry
    is the fewer of the two modes'), so their sums are the same bits; in
    float32 K5s alone takes it (its own resident entry), the ablation
    entry_conv_stats and K4f keep K4f's kernel, and the wrapper hands the
    kernel this plan (a recording stand-in for the library);
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
    rounded, and at F = 63 the sums to the float32 sums of that y;
  * the port's plain float32 statistics against the JAX package's in
    interpret mode where tests/test_torch_entry_block.py and
    tests/test_torch_crows_block.py (C = 64 at F = 8 and 64) do not reach:
    C = 36 against the crows statistics, F = 32 against `entry_block_stats`,
    within 1e-5 of their max.
"""

import inspect
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcase2019_task4_tpu.models import layers as jlayers
from dcase2019_task4_tpu.ops import crows_block as jcr
from dcase2019_task4_tpu.ops import fused_entry_block as jfe
from dcase2019_task4_tpu_torch.ops import _build
from dcase2019_task4_tpu_torch.ops import entry_conv as tec
from dcase2019_task4_tpu_torch.ops import fused_entry_block as tfe

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
                 "*resident = stored < sums_only ? stored : sums_only;",
                 "float (&q)[kConvChans], TX* yp, int C, int n = kConvRun) {"):
        assert line in SRC, line
    assert tec._CONV_THREADS == int(re.search(r"constexpr int kConvThreads = (\d+);", SRC).group(1))
    assert tec._CONV_RUN == int(re.search(r"constexpr int kConvRun = (\d+);", SRC).group(1))
    assert tec._CONV_CHANS == int(re.search(r"constexpr int kConvChans = (\d+);", SRC).group(1))
    assert tec._CONV_HALO == int(re.search(r"constexpr int kConvHalo = (\d+);", SRC).group(1))
    for F in FREQS:
        assert tec.conv_stride(F) == 4 * -(-F // 4) + 4
    assert tec.conv_run_plan(64, 64) == (13, 1020, _smem())
    assert "__launch_bounds__(kConvThreads, 4)\nentry_conv_run_kernel(" in SRC


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
            rows, halo, smem = tec.conv_run_plan(F, C)
            assert 1 <= C // 4 <= 32
            assert rows >= 1 and halo == (rows + 2) * stride <= 1024
            assert rows == max(1, min(pixels // F, 1024 // stride - 2))
            assert smem == _smem() <= 48 * 1024
    with pytest.raises(ValueError):
        tec.conv_run_plan(F, 6)


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
    rows = tec.conv_run_plan(F, 64)[0]
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


# ------------------------------------------------ K5s in float32, one wave


def test_float32_statistics_take_the_one_wave_conv():
    """K5s in float32 runs entry_conv_run_kernel<float, false> (no store:
    float32 K4f keeps entry_conv_kernel<0>), its grid from its own resident
    entry, and the C entry sends float32 x there when the wrapper hands it a
    tile height (rows > 0), else to entry_conv_kernel<mode>."""
    for line in ('static_assert(std::is_same<TX, bf16>::value || !kStore, "float32 K4f stays on entry_conv_kernel<0>");',
                 "    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, entry_conv_run_kernel<float, false>,",
                 "    entry_conv_run_kernel<float, false><<<blocks, kConvThreads, 0, st>>>(",
                 "  if (!bf16 && rows == 0) return launch_entry_conv_f32(mode, x, fp(w), fp(cb), y, pa, su, B, T, F, C, grid, st);",
                 "(long long)B * T >= (1LL << 31) || (store && !bf16_x))",
                 "int dcase_entry_conv_f32_resident() {",
                 "    for (int tap = 0; tap < 9; ++tap) wr[k][tap] = active ? rounded<TX>(w[tap * C + c0 + k]) : 0.0f;",
                 "                  ? to_float(xb[t * F + f]) : 0.0f;"):
        assert line in SRC, line
    assert _build.RESIDENT_ENTRIES["conv_f32"] == "dcase_entry_conv_f32_resident"
    assert "dcase_entry_conv_f32_resident" in _build.SIGNATURES
    assert 'wave=True' in inspect.getsource(tfe.entry_block_stats_apply)
    assert 'wave=True' not in inspect.getsource(tec.entry_conv_stats)


class _Recorder:
    """A stand-in for the kernel library that records dcase_entry_conv's
    arguments (B, T, F, C, mode, grid, bf16, rows) and the slots of its
    partials."""

    def __init__(self):
        self.calls = []

    def dcase_entry_conv(self, x, w, cb, y, partials, sums, B, T, F, C, mode, grid, bf16, rows, stream):
        self.calls.append((B, T, F, C, mode, grid, bf16, rows))
        return 0

    def dcase_bn_glu_pool_tiles(self, T, F, pt, pf):
        return -(-T // (128 // F))


@pytest.mark.parametrize("resident,B,T,F,C", [(528, 24, 864, 64, 64), (396, 3, 37, 64, 36), (8, 2, 11, 7, 4),
                                              (264, 2, 45, 128, 128)])
def test_float32_statistics_launch_one_wave_of_equal_runs(resident, B, T, F, C, monkeypatch):
    """The wrapper hands K5s float32 the plan of the one-wave conv: mode 1,
    a grid of `wave_grid(resident)` blocks (the float32 entry's), a tile
    height from `conv_run_plan`, one float64 slot a block; the kernel's
    split of that grid (`_tiles`) covers every time row of every clip
    once, in runs that differ by at most a row, in tiles inside a clip,
    with a short last tile where T is no multiple of the tile height. The
    ablation entry_conv_stats keeps K4f's kernel (rows 0) and its per-clip
    grid; bfloat16 x takes the bfloat16 entry's count."""
    rec = _Recorder()
    monkeypatch.setattr(_build, "library", lambda: rec)
    monkeypatch.setattr(_build, "resident", lambda index, kernel, *plan: {"conv_f32": resident,
                                                                         "conv_bf16": resident // 2}[kernel])
    monkeypatch.setattr(_build, "stream_handle", lambda device: 0)
    monkeypatch.setattr(tec, "_check_cuda", lambda x, C, what: None)
    rng = np.random.default_rng(B + T + F + C)
    params = {"w": torch.from_numpy(rng.standard_normal((3, 3, 1, C)).astype(np.float32)),
              "b": torch.from_numpy(rng.standard_normal(C).astype(np.float32))}
    x = torch.from_numpy(rng.standard_normal((B, T, F)).astype(np.float32))
    _, s1, s2 = tec._launch(params, x, "stats_only", "entry_block_stats_apply", wave=True)
    tec._launch(params, x, "stats_only", "entry_conv_stats")
    tec._launch(params, x.to(torch.bfloat16), "stats_only", "entry_block_stats_apply", wave=True)
    rows = tec.conv_run_plan(F, C)[0]
    G = _build.wave_grid(resident, B, T)
    tiles_per_block = max(1, -(-rec.dcase_bn_glu_pool_tiles(T, F, 1, 1) * B // tec._TARGET_BLOCKS))
    assert rec.calls == [(B, T, F, C, 1, G, 0, rows), (B, T, F, C, 1, tiles_per_block, 0, 0),
                         (B, T, F, C, 1, _build.wave_grid(resident // 2, B, T), 1, rows)]
    assert s1.shape == s2.shape == (C,)
    blocks = _tiles(G, B, T, rows)
    lengths = [sum(tr for _, _, tr in tiles) for tiles in blocks]
    assert max(lengths) - min(lengths) <= 1
    assert [(b, t0 + i) for tiles in blocks for b, t0, tr in tiles for i in range(tr)] == \
        [(b, t) for b in range(B) for t in range(T)]
    assert all(1 <= tr <= rows and t0 + tr <= T for tiles in blocks for _, t0, tr in tiles)
    if T % rows:
        assert any(t0 + tr == T and tr < rows for tiles in blocks for _, t0, tr in tiles)
    with pytest.raises(ValueError):
        tec._launch(params, x, "full", "entry_conv_forward", wave=True)


@pytest.mark.parametrize("case", ["C36 crows_stats", "F32 entry_block_stats"])
def test_plain_float32_statistics_match_jax(case):
    """The port's plain float32 statistics (what K5s computes) against the
    JAX package's statistics kernels in interpret mode, within 1e-5 of
    their max."""
    shape, C = {"C36 crows_stats": ((2, 8, 64), 36), "F32 entry_block_stats": ((2, 16, 32), 64)}[case]
    x, w, b = _inputs(shape, C, sum(shape) + C + 1)
    conv = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    s1, s2 = tfe.entry_block_stats_apply({"w": torch.from_numpy(w), "b": torch.from_numpy(b)}, torch.from_numpy(x))
    assert s1.dtype == s2.dtype == torch.float32
    if case.startswith("C36"):
        s_ref, sq_ref = jcr.crows_stats_apply(conv, jnp.asarray(x), compute_dtype=jnp.float32, interpret=True)
    else:
        s_ref, sq_ref = jfe.entry_block_stats_apply(conv, jnp.asarray(x), interpret=True)
    for name, got, want in (("sum y", s1, s_ref), ("sum y^2", s2, sq_ref)):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max(), err_msg=name)
