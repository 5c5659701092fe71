"""Port parity: K3 forward (3×3 s1 p1 Cin == Cout conv on NHWC).

The JAX side runs the Pallas kernel in interpret mode
(conv2d_packed(..., interpret=True)); the port's wrapper gets CPU tensors
and runs its plain twin (F.conv2d). Tolerance 1e-5 absolute: float32 sums
of 144 terms of O(1) taken in another order.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcase2019_task4_tpu.ops import packed_conv as jpc
from dcase2019_task4_tpu_torch.ops import packed_conv as tpc


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    C = shape[-1]
    lim = np.sqrt(2.0) * np.sqrt(6.0 / (18 * C))
    w = rng.uniform(-lim, lim, (3, 3, C, C)).astype(np.float32)
    b = (0.1 * rng.standard_normal(C)).astype(np.float32)
    x = rng.standard_normal(shape).astype(np.float32)
    return w, b, x


@pytest.mark.parametrize("shape", [(2, 48, 16, 16), (2, 24, 4, 16)])
def test_conv2d_packed_matches_jax_interpret(shape):
    w, b, x = _inputs(shape, sum(shape))
    ref = np.asarray(jpc.conv2d_packed({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                       jnp.asarray(x), interpret=True))
    out = tpc.conv2d_packed({"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                            torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("freq,channels,ok", [
    (16, 64, True), (4, 64, True), (128, 64, True), (32, 128, True), (256, 64, False), (16, 256, False),
])
def test_applicable_geometries(freq, channels, ok):
    assert tpc.applicable(freq, channels) is ok


def test_conv2d_packed_refuses_bad_weights_and_devices():
    w, b, x = _inputs((1, 8, 4, 8), 0)
    with pytest.raises(ValueError, match=r"w \[3,3,C,C\]"):
        tpc.conv2d_packed({"w": torch.from_numpy(w[:, :, :4]), "b": torch.from_numpy(b)},
                          torch.from_numpy(x))
    with pytest.raises(ValueError, match="cpu or cuda"):
        tpc.conv2d_packed({"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                          torch.from_numpy(x).to("meta"))


# the four activations the models send to K3 (batch 24, NHWC): the scaled
# configuration's blocks 2 and 3, the flagship bf16's
MAIN_PATH = [(24, 432, 32, 128), (24, 216, 8, 128), (24, 432, 16, 64), (24, 216, 4, 64)]


@pytest.mark.parametrize("shape", MAIN_PATH)
def test_applicable_takes_the_main_path_shapes(shape):
    assert tpc.applicable(shape[2], shape[3])


@pytest.mark.parametrize("freq,channels,ok", [
    (1, 64, True), (2, 128, True), (128, 64, True), (129, 64, False), (64, 129, False),
    # 128 rows of 3 halo-padded cells, or 3 rows of 130, do not fit a block's float32 slab
    (1, 128, False), (128, 128, False),
])
def test_applicable_edges(freq, channels, ok):
    assert tpc.applicable(freq, channels) is ok


@pytest.mark.parametrize("shape,dtype,want", [
    ((24, 432, 32, 128), torch.bfloat16, (1, 108, 21, 144)),
    ((24, 216, 8, 128), torch.bfloat16, (1, 14, 3, 120)),
    ((24, 432, 16, 64), torch.bfloat16, (2, 54, 21, 72)),
    ((24, 216, 4, 64), torch.bfloat16, (2, 7, 3, 72)),
    # float32: about two waves of one block an SM (264 slots)
    ((24, 432, 16, 64), torch.float32, (1, 54, 5, 264)),
    ((24, 216, 4, 64), torch.float32, (1, 7, 1, 168)),
    ((2, 37, 32, 16), torch.float32, (1, 10, 1, 20)),
    ((1, 9, 128, 64), torch.float32, (1, 9, 1, 9)),
    ((1, 37, 3, 24), torch.bfloat16, (1, 1, 1, 1)),
])
def test_wgrad_workspace(shape, dtype, want):
    """(classes k, pixel tiles per clip, tiles a block sums, slots): the
    runs of tiles cover every tile once, and a slot holds k sums."""
    k, tiles, per_block, slots = tpc.wgrad_workspace(shape, dtype)
    assert (k, tiles, per_block, slots) == want
    B, T, Fq, C = shape
    assert k == (tpc.pack_factor(Fq, C) if dtype == torch.bfloat16 else 1)
    rows = tpc._PIX_TILE // Fq
    assert (tiles - 1) * rows < T <= tiles * rows
    runs = slots // B
    assert slots % B == 0 and (runs - 1) * per_block < tiles <= runs * per_block


def test_pixel_tile_matches_the_kernels():
    src = (Path(tpc.__file__).parent.parent / "csrc" / "packed_conv.cu").read_text()
    assert re.search(r"constexpr int kPix = (\d+);", src).group(1) == str(tpc._PIX_TILE)


@pytest.mark.parametrize("shape", [(24, 432, 16, 64), (24, 216, 4, 64), (2, 37, 32, 16), (1, 9, 128, 64),
                                   (1, 300, 1, 8), (3, 11, 113, 128), (2, 50, 3, 24)])
def test_wgrad_float32_plan_fits_and_bounds_its_slots(shape):
    """The float32 weight gradient's launch plan: its shared buffers fit a
    block (two where they fit, so the main path's F = 16 and 4 overlap the
    next tile's copy), the runs of tiles cover every pixel row once, and
    the slots stay within the target plus one partial run a clip."""
    B, T, Fq, C = shape
    buffers, nbytes = tpc.wgrad_buffers(Fq)
    assert nbytes <= tpc._MAX_SHARED
    rows = tpc._PIX_TILE // Fq
    one = 4 * ((rows + 2) * (Fq + 2) + rows * Fq) * tpc._WGRAD_ROW
    assert nbytes == buffers * one and (buffers == 2) == (2 * one <= tpc._MAX_SHARED)
    if shape in MAIN_PATH:
        assert buffers == 2
    k, tiles, per_block, slots = tpc.wgrad_workspace(shape, torch.float32)
    assert k == 1 and (tiles - 1) * rows < T <= tiles * rows
    runs = slots // B
    assert slots % B == 0 and (runs - 1) * per_block < tiles <= runs * per_block
    assert slots <= tpc._WGRAD_SLOTS_F32 + B


def test_wgrad_float32_row_matches_the_kernel():
    src = (Path(tpc.__file__).parent.parent / "csrc" / "packed_conv.cu").read_text()
    assert re.search(r"constexpr int kWfC = (\d+);", src).group(1) == str(tpc._WGRAD_ROW)


def test_conv_plan_fits_every_admitted_shape():
    """The float32 forward / dx kernel's plan fits a block's shared memory
    at every (F, C) that `applicable` admits, with whole frequency rows in
    its pixel tile and a weight slice of a power of two from 4 to 64 input
    channels; the bytes are the kernel's layout (conv_f32_smem)."""
    for Fq in range(1, 129):
        for C in range(1, 129):
            if not tpc.applicable(Fq, C):
                continue
            for B, T in ((1, 7), (24, 432)):
                pix, kc, nbytes = tpc.conv_plan((B, T, Fq, C))
                assert pix in (64, 128) and Fq <= pix and kc in (4, 8, 16, 32, 64)
                rows = pix // Fq
                assert nbytes == 4 * ((rows + 2) * (Fq + 2) * tpc._odd_stride4(C) + 2 * 64 * tpc._odd_stride4(kc))
                assert nbytes <= tpc._MAX_SHARED


@pytest.mark.parametrize("shape,want", [
    # block 2: 1296 tiles of 128 pixels, about ten waves of 132 SMs
    ((24, 432, 16, 64), (128, 64, 83776)),
    # block 3: 162 tiles of 128 pixels would fill the card 1.2 times; 324 of 64
    ((24, 216, 4, 64), (64, 64, 64192)),
    ((1, 9, 32, 128), (64, 64, 106624)),
    ((1, 3, 128, 64), (128, 64, 140896)),
    # three rows of 126 halo-padded cells of 132 floats leave room for a 32-wide slice only
    ((1, 3, 124, 128), (128, 32, 218016)),
])
def test_conv_plan_at_the_main_path(shape, want):
    assert tpc.conv_plan(shape) == want


@pytest.mark.parametrize("n,want", [(1, 4), (4, 4), (8, 12), (16, 20), (18, 20), (64, 68), (124, 124), (128, 132)])
def test_odd_stride4(n, want):
    """A shared row of n floats: whole 16-byte units, an odd number of them."""
    assert tpc._odd_stride4(n) == want and (want // 4) % 2 == 1


def test_conv_plan_matches_the_kernel_source():
    src = (Path(tpc.__file__).parent.parent / "csrc" / "packed_conv.cu").read_text()
    assert re.search(r"constexpr int kCvN = (\d+);", src).group(1) == str(tpc._CONV_N)
    assert "return (r4 / 4) % 2 ? r4 : r4 + 4;" in src
    assert "(size_t)(rows + 2) * (F + 2) * odd_stride4(Cin) + 2 * (size_t)kCvN * odd_stride4(kc)" in src
