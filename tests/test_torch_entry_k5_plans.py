"""K5's kernels on K2's tile code, on the host: their launch plans, and
their plain versions against the JAX package at widths the kernels pad.

The CUDA kernels (csrc/entry_block.cu: entry_block_bwd_reduce_f32_kernel,
K2b's float32 reduce pass on a conv tile; entry_block_fwd_f32_kernel and
entry_block_fwd_bf16_kernel, K2f's float32 and bfloat16 forward on a conv
tile; entry_block_bwd_wgrad_f32_kernel, the recompute fixup's float32 tile
code on a conv tile, then dW from the dy tile) run only on the card, where
tests/test_torch_kernels_gpu.py and chip_smoke.py hold them to their plain
versions and to K4f -> K2. Here:

  * the shared-memory plans (`fused_entry_block.f32_reduce_plan`,
    `fwd_f32_plan`, `f32_wgrad_plan`, `fwd_bf16_plan`) fit a block at every
    width and pool the fused first block admits, and are the kernels' own
    formulas, read from the source;
  * the grid (`wave_grid`): one wave of the resident blocks in equal runs
    that cover the batch's tiles once, as the kernels split them, in the
    crows layout too (neither kernel splits the batch into halves: pass 1
    has no parts, and the forward no sums); pass 1 in float32 sums into the
    slots of K2b's float32 reduce pass (so it gives K4f -> K2b's bits);
  * at C = 36 and 96 (padded to 64 and 128 channels in the kernels) the
    port's plain versions against the JAX package's kernels in interpret
    mode, at rate 0. The JAX fused first block in the planes layout takes C
    = 64 only, so the planes side is its fused block (K2, the function K5
    fuses) on the port's conv output, and the crows side its crows block
    itself. Pass 1 in float32: d glu_w, d glu_b, S1, S2 within 1e-4 of
    their max (the bars of tests/test_torch_entry_block.py), against K2's
    reduce pass and against the crows block's VJP (d glu_w, d glu_b, d bias
    = S1, d scale = S2). The forward in bfloat16: each element within one
    bfloat16 ulp of itself plus one ulp of the largest pt-row column sum
    (planes) or of the largest g (crows) of its window over pt·pf, at most
    1e-3 of the elements beyond the one ulp alone (the bars of
    tests/test_torch_entry_bf16.py). The forward in float32: within 1e-5
    of the JAX fused block on the port's conv output and of the crows block.
    Pass 2 in float32 (a and b2 from pass 1's plain version): dW and d conv_b
    within 1e-4 of their max of the JAX crows block's VJP, d conv_b (a gauge
    leaf: zero in exact arithmetic) with a floor of 1e-6 of the largest
    gradient compared.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcase2019_task4_tpu.ops import crows_block as jcr
from dcase2019_task4_tpu.ops import fused_block as jfb
from dcase2019_task4_tpu_torch.ops import _build
from dcase2019_task4_tpu_torch.ops import entry_conv as tec
from dcase2019_task4_tpu_torch.ops import fused_block as tfb
from dcase2019_task4_tpu_torch.ops import fused_entry_block as tfe

POOL = (2, 4)
EPS = 1e-3
CSRC = Path(tfe.__file__).parent.parent / "csrc"
POOLS = [(2, 4), (2, 8), (2, 2), (1, 1), (1, 2), (4, 4)]


def _f32_size(C, pool, buffers, drows):
    """csrc/entry_block.cu red_entry_smem, written out."""
    cp = 64 if C <= 64 else 128
    return 4 * ((2 * 128 + buffers * drows) * (cp + 4) + cp * cp + 17 * cp + buffers * 512 + 2 * 128)


def _fwd_f32_size(C):
    """csrc/entry_block.cu fwd_entry_smem, written out."""
    cp = 64 if C <= 64 else 128
    return 4 * (128 * (cp + 4) + cp * cp + 14 * cp + 2 * 512 + 128)


def _wgrad_size(C, buffers, drows):
    """csrc/entry_block.cu wgrad_entry_smem, written out."""
    cp = 64 if C <= 64 else 128
    return 4 * ((2 * 128 + buffers * drows) * (cp + 4) + cp * cp + 16 * cp + buffers * 512 + 2 * 128)


def _fwd_size(C):
    """csrc/entry_block.cu fwd_bf16_smem, written out."""
    cp = 64 if C <= 64 else 128
    return 2 * (cp + 8) * (2 * 128 + cp) + 4 * (15 * cp + 512)


@pytest.mark.parametrize("pool", POOLS)
def test_f32_reduce_plan_fits_every_admitted_width(pool):
    """Two buffers of the x and dout tiles where they fit a block, else one,
    else one with dout read from device memory; the bytes are the kernel's
    layout, within the 232448 bytes a block may take."""
    rows = 128 // (pool[0] * pool[1])
    for C in range(4, 129, 4):
        assert tfe.entry_block_applicable((1, 8 * pool[0], 128 // pool[0], 1), pool, C)
        want = next((b, d) for b, d in ((2, rows), (1, rows), (1, 0)) if _f32_size(C, pool, b, d) <= _build.MAX_SHARED)
        plan = tfe.f32_reduce_plan(C, pool)
        assert plan == (*want, _f32_size(C, pool, *want)) and plan[2] <= _build.MAX_SHARED


@pytest.mark.parametrize("C,pool,want", [
    (64, (2, 4), (2, 16, 104192)), (16, (2, 4), (2, 16, 104192)), (128, (2, 4), (2, 16, 231424)),
    (128, (2, 2), (1, 32, 229376)), (128, (1, 1), (1, 0, 212480)), (96, (2, 8), (2, 8, 222976)),
])
def test_f32_reduce_plan_at_the_main_path(C, pool, want):
    """The flagship's C = 64 at pool (2, 4): 104192 bytes, two buffers (room
    for two blocks an SM; the registers of M, the gate and the sums keep it
    at one); at C = 128 two buffers still fit at pool (2, 4), one at (2, 2),
    and at (1, 1) dout stays in device memory."""
    assert tfe.f32_reduce_plan(C, pool) == want


def test_f32_reduce_plan_matches_the_kernel_source():
    src = (CSRC / "entry_block.cu").read_text()
    tile = (CSRC / "f32_tile.cuh").read_text() + (CSRC / "bf16_tile.cuh").read_text()
    assert re.search(r"constexpr int kPix = (\d+);", tile).group(1) == str(tfe._TILE_PIXELS)
    for line in ("static constexpr int CP = 16 * NJ;", "static constexpr int KS = CP + 4;",
                 "constexpr int kThreads = 256;"):
        assert line in tile, line
    for line in ("constexpr int kHalo = 4 * kPix;",
                 "return sizeof(float) * ((2 * kPix + (size_t)buffers * drows) * P::KS + P::CP * P::CP + 17 * P::CP +\n"
                 "                          (size_t)buffers * kHalo + 2 * kPix);",
                 "if (blocks < 1 || tiles_per_slot < 1 || !((buffers == 1 || buffers == 2) && drows == rows) &&\n"
                 "      !(buffers == 1 && drows == 0))",
                 "__launch_bounds__(kThreads)\nentry_block_bwd_reduce_f32_kernel(",
                 "C <= 64 ? launch_bwd_reduce_f32<4>(g, pa, su, blocks, tiles_per_slot, buffers, drows, st)"):
        assert line in src, line


@pytest.mark.parametrize("pool", POOLS)
def test_f32_fwd_and_wgrad_plans_fit_every_admitted_width(pool):
    """The float32 forward: one x-hat tile, the pool not in its bytes; pass 2:
    two buffers of the x and dout tiles where they fit a block, else one,
    else one with dout read from device memory. Both the kernels' layouts,
    within the 232448 bytes a block may take."""
    rows = 128 // (pool[0] * pool[1])
    for C in range(4, 129, 4):
        assert tfe.fwd_f32_plan(C) == _fwd_f32_size(C) <= _build.MAX_SHARED
        want = next((b, d) for b, d in ((2, rows), (1, rows), (1, 0)) if _wgrad_size(C, b, d) <= _build.MAX_SHARED)
        assert tfe.f32_wgrad_plan(C, pool) == (*want, _wgrad_size(C, *want))


@pytest.mark.parametrize("C,pool,fwd,wgrad", [
    (64, (2, 4), 59392, (2, 16, 103936)), (4, (2, 4), 59392, (2, 16, 103936)), (128, (2, 4), 144896, (2, 16, 230912)),
    (96, (2, 2), 144896, (1, 32, 228864)), (128, (1, 1), 144896, (1, 0, 211968)), (64, (1, 1), 59392, (2, 128, 164864)),
])
def test_f32_fwd_and_wgrad_plans_at_the_main_path(C, pool, fwd, wgrad):
    """The flagship's C = 64 at pool (2, 4): the forward 59392 bytes and pass
    2 103936 with two buffers, both room for two blocks of 8 warps an SM
    (233472 bytes, 1 KB reserved a block), as their 128-register bound
    allows; at C = 128 one block an SM."""
    assert tfe.fwd_f32_plan(C) == fwd and tfe.f32_wgrad_plan(C, pool) == wgrad
    if C <= 64 and pool == (2, 4):
        assert 2 * (fwd + 1024) <= 233472 and 2 * (wgrad[2] + 1024) <= 233472


def test_f32_fwd_and_wgrad_plans_match_the_kernel_source():
    src = (CSRC / "entry_block.cu").read_text()
    tile = (CSRC / "f32_tile.cuh").read_text() + (CSRC / "bf16_tile.cuh").read_text()
    for line in ("static constexpr int CP = 16 * NJ, H = CP / 2, CG = CP / 8, KS = CP + 4;",
                 "static constexpr int MI = NJ == 4 ? 4 : 8;", "static constexpr int NT = PG * CG;",
                 "static constexpr int MIN_BLOCKS = NJ == 4 ? 2 : 1;", "constexpr int kPix = 128;"):
        assert line in tile, line
    for line in ("return sizeof(float) * ((size_t)kPix * P::KS + P::CP * P::CP + 14 * P::CP + 2 * kHalo + kPix);",
                 "return sizeof(float) * ((2 * kPix + (size_t)buffers * drows) * P::KS + P::CP * P::CP + 16 * P::CP +\n"
                 "                          (size_t)buffers * kHalo + 2 * kPix);",
                 "__launch_bounds__(FwdPlan<NJ>::NT, FwdPlan<NJ>::MIN_BLOCKS)\nentry_block_fwd_f32_kernel(",
                 "__launch_bounds__(kThreads, NJ == 4 ? 2 : 1)\nentry_block_bwd_wgrad_f32_kernel(",
                 "if (blocks < 1 || !((buffers == 1 || buffers == 2) && drows == rows) && !(buffers == 1 && drows == 0))",
                 "C <= 64 ? launch_block_fwd<4>(g, out, blocks, st) : launch_block_fwd<8>(g, out, blocks, st)",
                 "C <= 64 ? launch_bwd_wgrad_f32<4>(g, pa, su, blocks, buffers, drows, st)",
                 "int dcase_entry_block_fwd_resident(int C) {",
                 "int dcase_entry_block_bwd_wgrad_resident(int C, int buffers, int drows) {"):
        assert line in src, line
    for gone in ("entry_block_fwd_kernel", "entry_block_bwd_wgrad_kernel", "mix_rows", "conv_to_xn"):
        assert gone not in src, gone


@pytest.mark.parametrize("C,want", [(64, 51968), (4, 51968), (68, 114176), (128, 114176)])
def test_fwd_bf16_plan_fits_every_admitted_width(C, want):
    """The bytes are the kernel's layout at every C the block admits; at C ≤
    64 two blocks of 8 warps fit an SM's 233472 bytes (1 KB reserved a
    block), at C ≤ 128 one of 16 warps."""
    for c in range(4, 129, 4):
        assert tfe.fwd_bf16_plan(c) == _fwd_size(c) <= _build.MAX_SHARED
    assert tfe.fwd_bf16_plan(C) == want
    if C <= 64:
        assert 2 * (want + 1024) <= 233472


def test_fwd_bf16_plan_matches_the_kernel_source():
    src = (CSRC / "entry_block.cu").read_text()
    tile = (CSRC / "bf16_tile.cuh").read_text()
    for line in ("static constexpr int RS = CP + 8;", "static constexpr int GS = CP + 8;"):
        assert line in tile, line
    for line in ("constexpr int kFwdWarps = CP == 128 ? 16 : 8;",
                 "return 2 * (size_t)BfPlan<CP, kFwdWarps<CP>>::RS * (2 * kPix + CP) + 4 * (15 * (size_t)CP + kHalo);",
                 "__launch_bounds__(32 * NW, NW == 8 ? 2 : 1)\nentry_block_fwd_bf16_kernel(",
                 "C <= 64 ? launch_fwd_bf16<64>(g, out, blocks, pool_elems, st)"):
        assert line in src, line


def _kernel_body(name):
    src = (CSRC / "entry_block.cu").read_text()
    body = src[src.index(name + "("):]
    return body[:body.index("\n}\n")]


def test_both_kernels_split_the_batch_in_equal_runs():
    """Block k of G takes [k n / G, (k + 1) n / G) of the batch's n units,
    clip after clip (`_runs` below writes it out): tiles in the forward,
    K2b's slots in pass 1."""
    fwd = _kernel_body("entry_block_fwd_bf16_kernel")
    assert "const long long n = (long long)B * n_tiles;" in fwd
    assert "const int first = (int)(blockIdx.x * n / gridDim.x), last = (int)((blockIdx.x + 1) * n / gridDim.x);" in fwd
    red = _kernel_body("entry_block_bwd_reduce_f32_kernel")
    for line in ("nb = (n_tiles + tiles_per_slot - 1) / tiles_per_slot;", "const long long n = (long long)B * nb;",
                 "const int s0 = (int)(blockIdx.x * n / gridDim.x), s1 = (int)((blockIdx.x + 1) * n / gridDim.x);",
                 "auto slot_end = [&](int s) { return (s / nb) * n_tiles + min(n_tiles, (s % nb + 1) * tiles_per_slot); };",
                 "const int first = s0 < s1 ? (s0 / nb) * n_tiles + (s0 % nb) * tiles_per_slot : 0;",
                 "write_reduce_slot_f32<NJ>(partials + (long long)slot * (C * C + 3 * C), r, xb, v, C);"):
        assert line in red, line


@pytest.mark.parametrize("kernel", ["entry_block_fwd_f32_kernel", "entry_block_bwd_wgrad_f32_kernel"])
def test_f32_fwd_and_wgrad_split_the_batch_in_equal_runs(kernel):
    """The float32 forward and pass 2 split the batch's tiles as the bfloat16
    forward does (the runs `_runs` writes out); pass 2 writes one slot a
    block, its sums over its run."""
    body = _kernel_body(kernel)
    assert "const long long n = (long long)B * n_tiles;" in body
    assert "const int first = (int)(blockIdx.x * n / gridDim.x), last = (int)((blockIdx.x + 1) * n / gridDim.x);" in body
    if kernel == "entry_block_bwd_wgrad_f32_kernel":
        assert "float* ps = partials + (long long)blockIdx.x * 10 * C;" in body


def _runs(G, n):
    return [(k * n // G, (k + 1) * n // G) for k in range(G)]


@pytest.mark.parametrize("resident,B,tiles", [(132, 24, 432), (132, 2, 6), (132, 1, 3), (132, 24, 49), (4, 3, 50)])
def test_reduce_f32_slots_are_k2b_blocks(resident, B, tiles):
    """Pass 1 in float32 sums into the slots of K2b's float32 reduce pass:
    runs of tpb = `fused_block._tiles_per_block(tiles, B, 528)` tiles of a
    clip (the last shorter), slot b·nb + j for run j of clip b, as K2b's
    block (j, b) writes slot b·gridDim.x + j. One wave of blocks takes equal
    runs of the slots, each a run of consecutive tiles; together they cover
    every tile once, in slot order."""
    tps = tfb._tiles_per_block(tiles, B, tfb._TARGET_BLOCKS_BWD)
    nb = -(-tiles // tps)
    k2b = [(b * tiles + j * tps, b * tiles + min(tiles, (j + 1) * tps)) for b in range(B) for j in range(nb)]
    slot = [((s // nb) * tiles + (s % nb) * tps, (s // nb) * tiles + min(tiles, (s % nb + 1) * tps))
            for s in range(B * nb)]
    assert slot == k2b
    G = _build.wave_grid(resident, 1, B * nb)
    assert G == min(resident, B * nb)
    covered = []
    for s0, s1 in _runs(G, B * nb):
        assert s1 > s0 and all(slot[s][1] == slot[s + 1][0] for s in range(s0, s1 - 1))  # consecutive tiles
        covered += slot[s0:s1]
    assert covered == slot and covered[0][0] == 0 and covered[-1][1] == B * tiles


@pytest.mark.parametrize("resident,B,tiles,want", [
    (132, 24, 432, 132), (264, 24, 432, 264), (132, 2, 6, 12), (264, 1, 1, 1), (132, 2, 37, 74), (1, 4, 3, 1),
])
def test_wave_grid_is_one_wave_of_equal_runs(resident, B, tiles, want):
    """One wave of the resident blocks (132 at the float32 pass 1's one
    block an SM, 264 at the forward's two), never more blocks than tiles;
    the runs cover every tile once, are consecutive and differ by at most
    one tile; the crows layout (an even batch) takes the same grid."""
    G = _build.wave_grid(resident, B, tiles)
    assert G == want
    runs = _runs(G, B * tiles)
    assert runs[0][0] == 0 and runs[-1][1] == B * tiles
    assert [a for a, _ in runs[1:]] == [b for _, b in runs[:-1]]
    assert max(b - a for a, b in runs) - min(b - a for a, b in runs) <= 1 and min(b - a for a, b in runs) >= 1


# --------------------------------------------- plain versions against JAX


def _ulp(a):
    """The bfloat16 spacing at |a| (floored at the smallest normal)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126))) - 7)


def _inputs(C, seed):
    """x [2, 8, 64, 1], the conv, the block's parameters and a cotangent,
    numpy float32 from a seed (the crows original takes F = 64 only)."""
    rng = np.random.default_rng(seed)
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(x=f(rng.standard_normal((2, 8, 64, 1))), w=f(0.3 * rng.standard_normal((3, 3, 1, C))),
                b=f(0.1 * rng.standard_normal(C)), scale=f(rng.uniform(0.5, 1.5, C)), bias=f(0.1 * rng.standard_normal(C)),
                gw=f(rng.standard_normal((C, C)) / np.sqrt(C)), gb=f(0.1 * rng.standard_normal(C)),
                ct=f(rng.standard_normal((2, 4, 16, C))), run_mean=f(0.2 * rng.standard_normal(C)),
                run_var=f(rng.uniform(0.5, 2.0, C)))


def _batch_moments(d, dtype=torch.float32):
    """mean, var of the port's conv output (x cast to `dtype`) over the batch."""
    x = torch.from_numpy(d["x"][..., 0]).to(dtype)
    y = tec.entry_conv_reference({"w": torch.from_numpy(d["w"]), "b": torch.from_numpy(d["b"])}, x)[0]
    yd = y.double().reshape(-1, y.shape[-1])
    return yd.mean(0).float(), yd.var(0, unbiased=False).float(), y


@pytest.mark.parametrize("C", [36, 96])
def test_plain_f32_reduce_matches_jax_at_padded_widths(C):
    d = _inputs(C, C + 31)
    mean, var, y = _batch_moments(d)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    x = t["x"][..., 0]
    dgw, dgb, s1, s2 = tfe.entry_block_bwd_reduce(x, t["ct"], t["w"], t["b"], t["scale"], t["bias"], mean, var,
                                                  t["gw"], t["gb"], POOL, EPS)

    def close(got, want, what):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max(), err_msg=what)

    # the JAX fused block's reduce pass (K2b) on the port's conv output
    j = [jnp.asarray(v) for v in (d["scale"], d["bias"], mean.numpy(), var.numpy(), d["gw"], d["gb"])]
    _, dscale, dbias, dw, db = jfb._bwd_pallas(jnp.asarray(y.numpy()), jnp.asarray(d["ct"]), *j, jnp.int32(0), 0.0,
                                               POOL, EPS, True, interpret=True)
    for name, got, want in (("d glu_w", dgw, dw), ("d glu_b", dgb, db), ("S1", s1, dbias), ("S2", s2, dscale)):
        close(got, want, f"{name} against the fused block")

    # the JAX crows block's VJP at the same (detached) mean and var
    def loss(gw, gb, scale, bias):
        out = jcr.crows_apply({"w": jnp.asarray(d["w"]), "b": jnp.asarray(d["b"])}, scale, bias,
                              jnp.asarray(mean.numpy()), jnp.asarray(var.numpy()), gw, gb, jnp.asarray(d["x"]),
                              jnp.int32(0), 0.0, POOL, EPS, True, interpret=True)
        return jnp.sum(out * jnp.asarray(d["ct"]))

    g_gw, g_gb, g_scale, g_bias = jax.grad(loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(d[k])
                                                                          for k in ("gw", "gb", "scale", "bias")))
    for name, got, want in (("d glu_w", dgw, g_gw), ("d glu_b", dgb, g_gb), ("S1", s1, g_bias), ("S2", s2, g_scale)):
        close(got, want, f"{name} against the crows block")


@pytest.mark.parametrize("layout", ["planes", "crows"])
@pytest.mark.parametrize("C", [36, 96])
def test_plain_fwd_bf16_matches_jax_at_padded_widths(C, layout):
    d = _inputs(C, C + 37)
    mean, var = (torch.from_numpy(d[k]) for k in ("run_mean", "run_var"))
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    x = t["x"][..., 0].to(torch.bfloat16)
    got = tfe.entry_block_fwd(x, t["w"], t["b"], t["scale"], t["bias"], mean, var, t["gw"], t["gb"], POOL, EPS,
                              layout=layout)
    assert got.dtype == torch.bfloat16
    j = [jnp.asarray(v) for v in (d["scale"], d["bias"], d["run_mean"], d["run_var"], d["gw"], d["gb"])]
    y = tec.entry_conv_reference({"w": t["w"], "b": t["b"]}, x)[0]
    if layout == "planes":  # the JAX fused block (K2) in bfloat16 on the port's bfloat16 conv output
        want = jfb.fused_bn_glu_dropout_pool(jnp.asarray(y.float().numpy(), jnp.bfloat16), *j, jnp.int32(0), 0.0,
                                             POOL, EPS, False, True)
    else:
        want = jcr.crows_apply({"w": jnp.asarray(d["w"]), "b": jnp.asarray(d["b"])}, *j[:4], *j[4:],
                               jnp.asarray(d["x"]), jnp.int32(0), 0.0, POOL, EPS, False, compute_dtype=jnp.bfloat16,
                               interpret=True)
    assert want.dtype == jnp.bfloat16
    want = np.asarray(jnp.asarray(want, jnp.float32))
    g = tfb.glu_gate(y, t["scale"], t["bias"], mean, var, t["gw"], t["gb"], EPS).numpy()
    win = g.reshape(2, 4, 2, 16, 4, C)
    top = np.abs(win.sum(axis=2)).max(axis=3) if layout == "planes" else np.abs(win).max(axis=(2, 4))
    slack = _ulp(top) / 8
    got = got.float().numpy()
    diff, own = np.abs(got - want), _ulp(np.maximum(np.abs(got), np.abs(want)))
    assert not (diff > own + slack).any(), f"{(diff > own + slack).sum()} elements beyond one ulp + slack"
    assert (diff > own).sum() <= np.ceil(1e-3 * diff.size), "share beyond one bfloat16 ulp"


@pytest.mark.parametrize("C", [36, 96])
def test_plain_f32_fwd_matches_jax_at_padded_widths(C):
    """K5f's plain float32 version in eval and in train mode at rate 0, against
    the JAX fused block (K2) on the port's conv output and against the JAX
    crows block, 1e-5."""
    d = _inputs(C, C + 41)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    x = t["x"][..., 0]
    mean, var, y = _batch_moments(d)
    for train, (mu, va) in ((False, (t["run_mean"], t["run_var"])), (True, (mean, var))):
        got = tfe.entry_block_fwd(x, t["w"], t["b"], t["scale"], t["bias"], mu, va, t["gw"], t["gb"], POOL, EPS)
        j = [jnp.asarray(v) for v in (d["scale"], d["bias"], mu.numpy(), va.numpy(), d["gw"], d["gb"])]
        planes = jfb.fused_bn_glu_dropout_pool(jnp.asarray(y.numpy()), *j, jnp.int32(0), 0.0, POOL, EPS, train, True)
        crows = jcr.crows_apply({"w": jnp.asarray(d["w"]), "b": jnp.asarray(d["b"])}, *j, jnp.asarray(d["x"]),
                                jnp.int32(0), 0.0, POOL, EPS, train, interpret=True)
        for name, want in (("fused block", planes), ("crows block", crows)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5,
                                       err_msg=f"{name}, train {train}")


@pytest.mark.parametrize("C", [36, 96])
def test_plain_f32_wgrad_matches_jax_at_padded_widths(C):
    d = _inputs(C, C + 43)
    mean, var, _ = _batch_moments(d)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    x = t["x"][..., 0]
    args = (x, t["ct"], t["w"], t["b"], t["scale"], t["bias"], mean, var, t["gw"], t["gb"])
    dgw, dgb, s1, s2 = tfe.entry_block_bwd_reduce(*args, POOL, EPS)
    a, b2 = tfb.bwd_coefficients(t["scale"], var, EPS, s1, s2, x.numel())
    dw, dcb = tfe.entry_block_bwd_wgrad(*args, a, b2, POOL, EPS)

    def loss(w, b):
        j = [jnp.asarray(v) for v in (d["scale"], d["bias"], mean.numpy(), var.numpy(), d["gw"], d["gb"])]
        out = jcr.crows_apply({"w": w, "b": b}, *j, jnp.asarray(d["x"]), jnp.int32(0), 0.0, POOL, EPS, True,
                              interpret=True)
        return jnp.sum(out * jnp.asarray(d["ct"]))

    g_w, g_b = (np.asarray(g) for g in jax.grad(loss, argnums=(0, 1))(jnp.asarray(d["w"]), jnp.asarray(d["b"])))
    top = max(np.abs(v).max() for v in (g_w, g_b, dgw.numpy(), dgb.numpy(), s1.numpy(), s2.numpy()))
    np.testing.assert_allclose(dw.numpy(), g_w, rtol=0, atol=1e-4 * np.abs(g_w).max(), err_msg="dW")
    np.testing.assert_allclose(dcb.numpy(), g_b, rtol=0, atol=1e-4 * np.abs(g_b).max() + 1e-6 * top,
                               err_msg="d conv_b")
