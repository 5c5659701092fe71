"""Port parity: K2 forward in eval mode (BN running stats → GLU → avg-pool).

The JAX side runs the Pallas kernel in interpret mode
(fused_bn_glu_dropout_pool(..., train=False, interpret=True)); the port's
wrapper gets CPU tensors and runs its plain twin. Running statistics are
non-trivial. Tolerance 1e-5 absolute (float32 GLU sums of C terms and
pooling sums taken in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcase2019_task4_tpu.ops import fused_block as jfb
from dcase2019_task4_tpu_torch.ops import fused_block as tfb

POOL = (2, 4)
EPS = 1e-3


def _kernel_source() -> str:
    """csrc/fused_block.cu with the tile code it includes (csrc/bf16_tile.cuh,
    csrc/f32_tile.cuh)."""
    from pathlib import Path

    csrc = Path(tfb.__file__).parent.parent / "csrc"
    return "".join((csrc / name).read_text() for name in ("fused_block.cu", "bf16_tile.cuh", "f32_tile.cuh"))


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    C = shape[-1]
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return (
        f(rng.standard_normal(shape)),
        f(1 + 0.1 * rng.standard_normal(C)),      # scale
        f(0.1 * rng.standard_normal(C)),          # bias
        f(0.3 * rng.standard_normal(C)),          # running mean
        f(rng.uniform(0.5, 2.0, C)),              # running var
        f(rng.standard_normal((C, C)) / np.sqrt(C)),  # glu_w [in, out]
        f(0.1 * rng.standard_normal(C)),          # glu_b
    )


# C = 16 at the flagship's three block geometries; the flagship's C = 64 at
# them (tiny T), and C = 20 (not a multiple of 8)
@pytest.mark.parametrize("shape", [(2, 96, 64, 16), (2, 48, 16, 16), (2, 24, 4, 16), (1, 8, 64, 64), (1, 16, 16, 64),
                                   (2, 8, 4, 20)])
def test_eval_block_matches_jax_interpret(shape):
    y, scale, bias, mean, var, w, b = _inputs(shape, sum(shape))
    ref = np.asarray(jfb.fused_bn_glu_dropout_pool(
        *(jnp.asarray(a) for a in (y, scale, bias, mean, var, w, b)), jnp.int32(0),
        0.0, POOL, EPS, False, True,
    ))
    out = tfb.fused_bn_glu_pool(*(torch.from_numpy(a) for a in (y, scale, bias, mean, var, w, b)),
                                POOL, EPS).numpy()
    assert out.shape == ref.shape == (shape[0], shape[1] // 2, shape[2] // 4, shape[3])
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_reference_block_matches_jax_twin():
    args = _inputs((2, 8, 8, 16), 3)
    ref = np.asarray(jfb.reference_block(*(jnp.asarray(a) for a in args), None, 1.0, POOL, EPS))
    out = tfb.reference_block(*(torch.from_numpy(a) for a in args), POOL, EPS).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape,ok", [
    ((2, 864, 64, 64), True), ((2, 216, 4, 64), True), ((2, 863, 64, 64), False),
    ((2, 864, 66, 64), False), ((2, 864, 128, 64), True), ((2, 864, 64, 256), False),
])
def test_applicable_geometries(shape, ok):
    """A pooling row of 2 × 128 pixels is taken in tiles of whole windows."""
    assert tfb.applicable(shape, POOL) is ok


def test_train_mode_dropout_is_refused():
    """Train-mode dropout is not refused: only a rate outside [0, 1) is, and
    rate 0.5 changes the pooled output."""
    args = [torch.from_numpy(a) for a in _inputs((1, 4, 8, 8), 0)]
    for bad in (1.0, -0.1):
        with pytest.raises(ValueError):
            tfb.fused_bn_glu_pool(*args, POOL, EPS, rate=bad)
    kept = tfb.fused_bn_glu_pool(*args, POOL, EPS, rate=0.5, seed=3)
    full = tfb.fused_bn_glu_pool(*args, POOL, EPS)
    assert kept.shape == full.shape and not torch.equal(kept, full)


@pytest.mark.parametrize("pool", [(2, 4), (2, 8), (1, 1), (1, 2), (4, 4)])
def test_reduce_plan_fits_every_admitted_width(pool):
    """The float32 reduce pass's shared memory fits a block at every C the
    fused block admits (C ≤ 128, C % 4 == 0): two buffers of the y and dout
    tiles wherever they fit, else one, else dout read from device memory;
    the bytes are the kernel's layout (csrc/fused_block.cu red_f32_smem)."""
    rows = 128 // (pool[0] * pool[1])
    for C in range(4, 129, 4):
        assert tfb.applicable((1, 8 * pool[0], 8 * pool[1], C), pool)
        buffers, drows, nbytes = tfb.reduce_plan(C, pool)
        cp = 64 if C <= 64 else 128

        def size(b, d):
            return 4 * ((b + 1) * 128 * (cp + 4) + b * d * (cp + 4) + cp * cp + 7 * cp + 2 * 128)

        assert nbytes == size(buffers, drows) <= tfb._MAX_SHARED
        assert drows in (0, rows)
        assert (buffers, drows) == ((2, rows) if size(2, rows) <= tfb._MAX_SHARED
                                    else (1, rows) if size(1, rows) <= tfb._MAX_SHARED else (1, 0))


@pytest.mark.parametrize("C,pool,want", [
    (64, (2, 4), (2, 16, 132352)), (16, (2, 4), (2, 16, 132352)), (128, (2, 4), (1, 16, 213760)),
    (128, (2, 8), (1, 8, 209536)), (128, (1, 2), (1, 0, 205312)),
])
def test_reduce_plan_at_the_main_path(C, pool, want):
    """The flagship's C = 64 at pool (2, 4) takes two buffers (the next
    tile's y and dout load while one multiplies), 132352 bytes: one block an
    SM; C = 128 one; at C = 128 and pool (1, 2) dout stays in device memory."""
    assert tfb.reduce_plan(C, pool) == want


@pytest.mark.parametrize("pool", [(2, 4), (2, 8), (1, 1), (1, 2), (4, 4)])
def test_bf16_reduce_plan_fits_every_admitted_width(pool):
    """The bfloat16 reduce pass's shared memory fits a block at every C the
    fused block admits: two buffers of the y tile and the tile's pooled rows
    of dout where they fit a block, else one, with db, S1, S2 per pixel warp
    row of its 16 warps (csrc/fused_block.cu bwd_bf16_smem)."""
    rows = 128 // (pool[0] * pool[1])
    for C in range(4, 129, 4):
        assert tfb.applicable((1, 8 * pool[0], 8 * pool[1], C), pool)
        cp = 64 if C <= 64 else 128
        rs = cp + 8

        def size(b):
            return 2 * rs * (b * (128 + rows) + 256 + cp) + 4 * (6 * cp + 3 * 32 * 16) + 128 * (cp // 4 + 4) + 512

        want = 2 if size(2) <= tfb._MAX_SHARED else 1
        assert tfb.bf16_reduce_plan(C, pool) == (want, rows, size(want)) and size(want) <= tfb._MAX_SHARED


@pytest.mark.parametrize("C,pool,want", [
    (128, (2, 4), (2, 16, 197120)), (128, (2, 8), (2, 8, 192768)), (64, (2, 4), (2, 16, 98304)),
    (20, (2, 4), (2, 16, 98304)), (128, (1, 1), (1, 128, 188416)),
])
def test_bf16_reduce_plan_at_the_main_path(C, pool, want):
    """The scaled model's C = 128 takes two buffers, 197120 bytes at pool
    (2, 4) (one block of 16 warps an SM); the flagship's C = 64 two buffers;
    at pool (1, 1) a tile's 128 rows of dout leave room for one buffer."""
    assert tfb.bf16_reduce_plan(C, pool) == want


def test_bf16_plans_match_the_kernel_source():
    src = _kernel_source()
    for line in ("static constexpr int RS = CP + 8;", "static constexpr int KG = CP / 4;",
                 "static constexpr int MS = KG + 4;", "static constexpr int WN = CP / 32, WM = NW / WN;",
                 "constexpr int kFwdWarps = CP == 128 ? 16 : 8;", "constexpr int kBwdWarps = 16;",
                 "return 2 * (size_t)P::RS * (3 * (size_t)kPix + CP) + 4 * 5 * (size_t)CP;",
                 "return 2 * (size_t)P::RS * ((size_t)buffers * (kPix + drows) + 2 * kPix + CP) +\n"
                 "         4 * (6 + 3 * (size_t)P::WM) * CP + (size_t)kPix * P::MS + 4 * kPix;",
                 "using P = BfPlan<CP, kBwdWarps<CP>>;", "drows != kPix / (a.pt * a.pf)"):
        assert line in src, line


def test_reduce_plan_matches_the_kernel_source():
    import re

    src = _kernel_source()
    assert re.search(r"constexpr int kPix = (\d+);", src).group(1) == str(tfb._TILE_PIXELS)
    assert "static constexpr int KS = CP + 4;" in src
    assert ("(size_t)(buffers + 1) * kPix * P::KS + (size_t)buffers * drows * P::KS +\n"
            "                          P::CP * P::CP + 7 * P::CP + 2 * kPix") in src


def test_forward_plan_fits_every_admitted_width():
    """The float32 forward's shared memory (two y tiles) fits a block at
    every C and pool the fused block admits (C ≤ 128, C % 4 == 0, pt·pf ≤
    128); the bytes are the kernel's layout (csrc/fused_block.cu
    fwd_f32_smem), the pool does not enter them."""
    for C in range(4, 129, 4):
        for pool in ((2, 4), (2, 8), (2, 2), (1, 1), (4, 4), (8, 16)):
            assert tfb.applicable((1, 8 * pool[0], 8 * pool[1], C), pool)
        cp = 64 if C <= 64 else 128
        nbytes = tfb.forward_plan(C)
        assert nbytes == 4 * (2 * (128 * (cp + 4) + 128) + cp * cp + 4 * cp) <= tfb._MAX_SHARED


@pytest.mark.parametrize("C,want", [(64, 88064), (20, 88064), (4, 88064), (128, 203776), (100, 203776), (68, 203776)])
def test_forward_plan_at_the_main_path(C, want):
    """The flagship's C = 64 takes 88064 bytes: two blocks an SM (228 KB);
    C = 128 (and 100, the <8> plan) 203776 bytes: one."""
    assert tfb.forward_plan(C) == want


def test_forward_plan_matches_the_kernel_source():
    src = _kernel_source()
    for line in ("return sizeof(float) * (2 * (kPix * P::KS + kPix) + P::CP * P::CP + 4 * P::CP);",
                 "static constexpr int KS = CP + 4;", "static constexpr int CP = 16 * NJ;",
                 "__launch_bounds__(FwdPlan<NJ>::NT, FwdPlan<NJ>::MIN_BLOCKS)\nbn_glu_pool_kernel(",
                 "static constexpr int MIN_BLOCKS = NJ == 4 ? 2 : 1;",
                 "C <= 64 ? launch_fwd<4>(a, out, st) : launch_fwd<8>(a, out, st)",
                 "static_assert(fwd_f32_smem<8>() <= 232448,"):
        assert line in src, line
    assert f"static_assert(fwd_f32_smem<8>() <= {tfb._MAX_SHARED}," in src


def test_fixup_plan_fits_every_admitted_width():
    """The recompute fixup's shared memory fits a block at every C and pool
    the fused block admits, in both element types: float32 one y buffer with
    the tile's dout rows where they fit, else dout read from device memory;
    bfloat16 two buffers where they fit, else one; the bytes are the kernels'
    layouts (csrc/fused_block.cu fix_f32_smem, fix_bf16_smem); at the main
    paths' C = 64 (pool (2, 4)) both leave room for two blocks an SM."""
    for pool in ((2, 4), (2, 8), (2, 2), (1, 1), (1, 2), (4, 4), (8, 16)):
        rows = 128 // (pool[0] * pool[1])
        for C in range(4, 129, 4):
            assert tfb.applicable((1, 8 * pool[0], 8 * pool[1], C), pool)
            cp = 64 if C <= 64 else 128
            rs = cp + 8

            def f32(d):
                return 4 * (2 * 128 * (cp + 4) + d * (cp + 4) + cp * cp + 6 * cp + 2 * 128)

            def bf16(b):
                return 2 * rs * (b * (128 + rows) + 256 + cp) + 4 * 8 * cp + 128 * (cp // 4 + 4) + 512

            drows = rows if f32(rows) <= tfb._MAX_SHARED else 0
            assert tfb.fixup_plan(C, pool) == (1, drows, f32(drows)) and f32(drows) <= tfb._MAX_SHARED
            buffers = 2 if bf16(2) <= tfb._MAX_SHARED else 1
            assert tfb.fixup_plan(C, pool, torch.bfloat16) == (buffers, rows, bf16(buffers))
            assert bf16(buffers) <= tfb._MAX_SHARED
    assert 2 * (tfb.fixup_plan(64, (2, 4))[2] + 1024) <= 233472
    assert 2 * (tfb.fixup_plan(64, (2, 4), torch.bfloat16)[2] + 1024) <= 233472


def test_fixup_plan_matches_the_kernel_source():
    src = _kernel_source()
    for line in ("return sizeof(float) * (2 * kPix * P::KS + (size_t)drows * P::KS + P::CP * P::CP + 6 * P::CP + 2 * kPix);",
                 "return 2 * (size_t)P::RS * ((size_t)buffers * (kPix + drows) + 2 * kPix + CP) + 4 * 8 * (size_t)CP +\n"
                 "         (size_t)kPix * P::MS + 4 * kPix;",
                 "constexpr int kFixWarps = CP == 128 ? 16 : 8;", "static constexpr int MS = KG + 4;",
                 "__launch_bounds__(kThreads, NJ == 4 ? 2 : 1)\nbn_bwd_fixup_recompute_kernel(",
                 "__launch_bounds__(32 * NW, NW == 8 ? 2 : 1)\nbn_bwd_fixup_recompute_bf16_kernel(",
                 "if (bf16) return (buffers == 1 || buffers == 2) && drows == kPix / (pt * pf);",
                 "return buffers == 1 && (drows == 0 || drows == kPix / (pt * pf));"):
        assert line in src, line
