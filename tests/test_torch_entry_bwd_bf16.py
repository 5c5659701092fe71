"""K5's two bfloat16 backward passes on the host: their launch plan, and
their plain versions against the JAX package at widths the kernels pad.

The CUDA kernels (csrc/entry_block.cu: entry_block_bwd_reduce_bf16_kernel,
K5b1, and entry_block_bwd_wgrad_bf16_kernel, K5b2) run only on the card,
where tests/test_torch_kernels_gpu.py and chip_smoke.py hold them to their
plain versions. Here:

  * the shared-memory plan (`fused_entry_block.bf16_bwd_plan`) fits a block
    at every width and pool the fused first block admits, and is the
    kernel's own formula;
  * the grid (`wave_grid`): one wave of the resident blocks, never more
    blocks than tiles, even under the crows partition, and the kernel's run
    split covers the batch's tiles once, each half of the clips by its own
    half of the blocks;
  * at C = 36 and 96 (padded to 64 and 128 channels in the kernels) the
    port's plain passes against the JAX package's fused block run in
    interpret mode on the port's conv output with its recompute fixup
    patched on (`_RECOMPUTE_FIXUP`: dy rounded once, as K5b2 rounds it for
    dW), at rate 0: d glu_w within 1e-5 of its max plus one bfloat16
    operand flip, d glu_b, S1, S2 within 1e-4 of their max (sums of
    bfloat16-rounded terms; the bars of tests/test_torch_fixup_recompute.py);
    bf16(dy) within two bfloat16 ulps plus what one bfloat16 operand of lin
    or dxn rounding the other way moves it by (where dy's terms cancel), at
    most 1e-3 of the elements beyond one ulp; dW against patchesᵀ · (JAX's
    dy) in float64, rounded in its two output-frequency parts: each element
    within one ulp of itself plus one of each part's sum plus one dy flip
    (ulp(max|dy|)·max|x|).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcase2019_task4_tpu.ops import fused_block as jfb
from dcase2019_task4_tpu_torch.ops import _build
from dcase2019_task4_tpu_torch.ops import entry_conv as tec
from dcase2019_task4_tpu_torch.ops import fused_block as tfb
from dcase2019_task4_tpu_torch.ops import fused_entry_block as tfe

POOL = (2, 4)
EPS = 1e-3
CSRC = Path(tfe.__file__).parent.parent / "csrc"


def _size(C, pool, which, buffers):
    """csrc/entry_block.cu bwd_bf16_smem, written out."""
    cp = 64 if C <= 64 else 128
    rs, wm, drows = cp + 8, 4, 128 // (pool[0] * pool[1])  # four warp rows: 8 warps at CP = 64, 16 at 128
    halves = rs * (3 * 128 + buffers * drows + cp) + (16 * 136 if which == 2 else 0)
    floats = cp * (10 + (8 if which == 2 else 6) + (1 if which == 2 else 3) * wm) + 512
    return 2 * halves + 4 * floats + 128 * (cp // 4 + 4) + 4 * 128


@pytest.mark.parametrize("pool", [(2, 4), (2, 8), (2, 2), (1, 1), (1, 2), (4, 4)])
@pytest.mark.parametrize("which", [1, 2])
def test_bf16_bwd_plan_fits_every_admitted_width(pool, which):
    """Two dout buffers where they fit a block, else one; the bytes are the
    kernel's layout, within the 232448 bytes a block may take."""
    for C in range(4, 129, 4):
        assert tfe.entry_block_applicable((1, 8 * pool[0], 128 // pool[0], 1), pool, C)
        buffers = 2 if _size(C, pool, which, 2) <= _build.MAX_SHARED else 1
        plan = tfe.bf16_bwd_plan(C, pool, which)
        assert plan == (buffers, 128 // (pool[0] * pool[1]), _size(C, pool, which, buffers))
        assert plan[2] <= _build.MAX_SHARED


@pytest.mark.parametrize("C,pool,which,want", [
    (64, (2, 4), 1, (2, 16, 81408)), (64, (2, 4), 2, (2, 16, 84224)), (16, (2, 4), 2, (2, 16, 84224)),
    (96, (2, 4), 1, (2, 16, 169472)), (128, (1, 1), 1, (2, 128, 230400)), (128, (1, 1), 2, (2, 128, 231680)),
])
def test_bf16_bwd_plan_at_the_main_path(C, pool, which, want):
    """The flagship's C = 64 at pool (2, 4): 80 and 82 KB, both passes with
    two dout buffers, two blocks of 8 warps an SM; at C = 128 and pool
    (1, 1) a tile's 128 rows of dout still leave room for two buffers."""
    assert tfe.bf16_bwd_plan(C, pool, which) == want


def test_bf16_bwd_plan_matches_the_kernel_source():
    src = (CSRC / "entry_block.cu").read_text()
    tile = (CSRC / "bf16_tile.cuh").read_text()
    assert re.search(r"constexpr int kPix = (\d+);", tile).group(1) == str(tfe._TILE_PIXELS)
    for line in ("static constexpr int RS = CP + 8;", "static constexpr int WN = CP / 32, WM = NW / WN;",
                 "static constexpr int MS = KG + 4;"):
        assert line in tile, line
    for line in ("constexpr int kEntryWarps = CP == 128 ? 16 : 8;", "constexpr int kKS = kPix + 8;",
                 "constexpr int kHalo = 4 * kPix;",
                 "const size_t halves = (size_t)P::RS * (3 * kPix + (size_t)buffers * drows + CP) + "
                 "(pass == 2 ? 16 * (size_t)kKS : 0);",
                 "const size_t floats = (size_t)CP * (10 + (pass == 2 ? 8 : 6) + (pass == 2 ? 1 : 3) * P::WM) + kHalo;",
                 "return 2 * halves + 4 * floats + (size_t)kPix * P::MS + 4 * kPix;",
                 "drows != kPix / (g.pt * g.pf)"):
        assert line in src, line


def _runs(G, B, tiles, halves):
    """The kernel's split (csrc/entry_block.cu bwd_bf16_body): block k of
    each group of G / groups blocks takes tiles [k n / G', (k + 1) n / G')
    of its group's n tiles."""
    groups = 2 if halves else 1
    g, n = G // groups, (B // groups) * tiles
    return [(grp * n + k * n // g, grp * n + (k + 1) * n // g) for grp in range(groups) for k in range(g)]


@pytest.mark.parametrize("resident,B,tiles,halves,want", [
    (132, 24, 432, False, 132), (132, 24, 432, True, 132), (133, 24, 432, True, 132), (264, 24, 432, False, 264),
    (132, 2, 6, False, 12), (132, 2, 6, True, 12), (132, 2, 7, True, 14), (1, 2, 6, True, 2), (132, 1, 1, False, 1),
])
def test_bf16_bwd_grid_is_one_wave_of_equal_runs(resident, B, tiles, halves, want):
    G = _build.wave_grid(resident, B, tiles, halves)
    assert G == want
    runs = _runs(G, B, tiles, halves)
    assert [a for a, _ in runs[1:]] == [b for _, b in runs[:-1]]  # consecutive runs
    assert runs[0][0] == 0 and runs[-1][1] == B * tiles  # every tile once
    assert max(b - a for a, b in runs) - min(b - a for a, b in runs) <= 1  # equal runs
    assert min(b - a for a, b in runs) >= 1  # no idle block
    if halves:  # the first half of the blocks holds the first half of the clips
        assert runs[G // 2 - 1][1] == runs[G // 2][0] == (B // 2) * tiles


def _ulp(a):
    """The bfloat16 spacing at |a| (floored at the smallest normal)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126))) - 7)


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _wgrad_parts(x, dy):
    """Σ x[t + dt − 1, f + df − 1]·dy[t, f, c] in float64 over the even and
    the odd output frequencies apart → [2, 3, 3, 1, C]."""
    B, T, Fq, C = dy.shape
    xp = np.pad(x.astype(np.float64), ((0, 0), (1, 1), (1, 1)))
    out = np.zeros((2, 3, 3, 1, C))
    for parity in range(2):
        for dt in range(3):
            for df in range(3):
                patch = xp[:, dt:dt + T, df:df + Fq][:, :, parity::2]
                out[parity, dt, df, 0] = np.einsum("btf,btfc->c", patch, dy[:, :, parity::2].astype(np.float64))
    return out


@pytest.mark.parametrize("C", [36, 96])
def test_plain_bf16_passes_match_jax_at_padded_widths(monkeypatch, C):
    B, T, Fq = 2, 8, 64
    rng = np.random.default_rng(C + 5)
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    x = torch.from_numpy(f(rng.standard_normal((B, T, Fq)))).to(torch.bfloat16)
    conv = {"w": torch.from_numpy(_bf16(0.3 * rng.standard_normal((3, 3, 1, C)))),
            "b": torch.from_numpy(f(0.1 * rng.standard_normal(C)))}
    scale, bias = (torch.from_numpy(f(v)) for v in (1 + 0.1 * rng.standard_normal(C), 0.1 * rng.standard_normal(C)))
    gw = torch.from_numpy(f(rng.standard_normal((C, C)) / np.sqrt(C)))
    gb = torch.from_numpy(f(0.1 * rng.standard_normal(C)))
    dout = torch.from_numpy(f(rng.standard_normal((B, T // 2, Fq // 4, C)))).to(torch.bfloat16)
    y = tec.entry_conv_reference(conv, x)[0]
    yd = y.double().reshape(-1, C)
    mean, var = yd.mean(0).float(), yd.var(0, unbiased=False).float()
    n = B * T * Fq

    monkeypatch.setattr(jfb, "_RECOMPUTE_FIXUP", True)
    j = [jnp.asarray(v.float().numpy()) for v in (scale, bias, mean, var, gw, gb)]
    dy_j, dscale_j, dbias_j, dw_j, db_j = (np.asarray(jnp.asarray(v, jnp.float32)) for v in jfb._bwd_pallas(
        jnp.asarray(y.float().numpy(), jnp.bfloat16), jnp.asarray(dout.float().numpy(), jnp.bfloat16), *j,
        jnp.int32(0), 0.0, POOL, EPS, True, interpret=True))

    block = (conv["w"], conv["b"], scale, bias, mean, var, gw, gb)
    dgw, dgb, s1, s2 = tfe.entry_block_bwd_reduce(x, dout, *block, POOL, EPS)
    xn = (yd.reshape(B, T, Fq, C) - mean.double()) / torch.sqrt(var.double() + EPS) * scale + bias
    dlin = (dout.double().abs().max() / (POOL[0] * POOL[1])).item()
    flip_w = _ulp(xn.abs().max().item()) * dlin + _ulp(dlin) * xn.abs().max().item()
    for name, got, want, rel, extra in (("d glu_w", dgw, dw_j, 1e-5, flip_w), ("d glu_b", dgb, db_j, 1e-4, 0.0),
                                        ("S1", s1, dbias_j, 1e-4, 0.0), ("S2", s2, dscale_j, 1e-4, 0.0)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=rel * np.abs(want).max() + extra, err_msg=name)

    a, b2 = tfb.bwd_coefficients(scale, var, EPS, s1, s2, n)
    dy = tfe._pass2_dy(x, dout, *block, a, b2, POOL, EPS, None, 1.0)[0]
    dy16 = dy.to(torch.bfloat16).float().numpy()
    # where dy's terms cancel, one bfloat16 operand of lin or dxn rounding the
    # other way between the engines moves dy by more than its own ulps
    gain = (scale / torch.sqrt(var + EPS)).abs().max().item()
    w_max = gw.abs().max().item()
    flip_dy = gain * w_max * (_ulp(dlin) + dlin / 4 * _ulp(xn.abs().max().item()))
    diff, ulp = np.abs(dy16 - dy_j), _ulp(np.maximum(np.abs(dy16), np.abs(dy_j)))
    assert (diff > 2 * ulp + flip_dy).sum() == 0 and (diff > ulp).mean() <= 1e-3, "bf16(dy)"

    dw, _ = tfe.entry_block_bwd_wgrad(x, dout, *block, a, b2, POOL, EPS)
    parts = _wgrad_parts(x.float().numpy(), dy_j)
    want = sum(_bf16(p) for p in parts)
    flip = _ulp(np.abs(dy_j).max()) * x.float().abs().max().item()
    diff = np.abs(dw.numpy() - want)
    limit = _ulp(np.maximum(np.abs(dw.numpy()), np.abs(want))) + sum(_ulp(p) for p in parts) + flip
    assert (diff <= limit).all(), f"dW: {(diff > limit).sum()} elements beyond one ulp + the parts' + one dy flip"
