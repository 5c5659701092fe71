"""The hand-written CUDA kernels against their plain twins, on the card.

Marked `gpu`: each test skips (inside the `cuda` fixture, never at import)
when torch sees no CUDA device. On a GPU machine:

    python -m pytest tests/test_torch_kernels_gpu.py -q

Shapes are small and odd-sized (partial tiles, C = 16, 64 and 128) to
exercise the kernels' bounds checks; chip_smoke.py covers the flagship
shapes. Forward (the float32 kernel's register tiles also at C 12 to 128,
F = 128 window tiles, pools (2, 2) to (4, 4), ragged last tiles, both
draws and an unaligned y), train-mode dropout (mask bit-equal to the plain Philox),
batch statistics, both backward passes (the float32 reduce pass also at C
4 to 128, partial and window tiles, both draws and the recompute knob),
conv dx and wgrad (the float32 forward and dx also at F 1 to 128, C 16 to
128, the flagship shapes and other launch plans; the float32 wgrad at its
tile edges, its part sum read from its slots), the entry-block
family (K4 conv with sums and weight gradient, K5 statistics, forward and
two-pass backward, at small shapes and at the flagship block-1 shape), the
keep-mask kernel, and one whole training step per first-block
configuration, float32 with TF32 off on both sides; then the bfloat16
modes of K3 (its weight gradient rounded per output-frequency class where
the original packs lane copies; its tensor-core tiling at F 4-32, C 64 and
128, one and three clips, ragged last tiles and two waves of 128-pixel
tiles) and K2 (window tiles included; its tensor-core kernels also at C 20,
64 and 100, ragged last tiles of one clip, the packed draw, the recompute
knob's first pass and an unaligned y), and of the
entry-block family (K4, K5 and the crows layout of K6, at small shapes and
the flagship block-1 shape; K4w in both types also at C 4 to 128, F 1 to
128, short tiles and a misaligned dy; K4f / K5s bf16 also at F 1 to 128, C 4 to 128
and short last tiles, y bit for bit the conv9-order y and the two modes'
sums the same bits; K5s float32 on the same one-wave kernel at those
widths, its sums within 1e-6 of max of K2s of K4f's y; K2s on bfloat16 y
at the flagship's and the scaled configuration's shapes, C = 36 and an
8-byte-aligned y, within 1e-6 relative of float64 sums; K5b1 float32, K5f float32 and bf16 and K5b2
float32 also at their tile edges and against K4f -> K2b, K4f -> K2f and K4f
-> the recompute fixup -> K4w with the same seed, K6 float32 bit for bit
as K5), against their plain versions, one
scaled-configuration step and one flagship bfloat16 step per first-block
configuration against the CPU. Last, the JAX package's three A/B knobs:
K1's onedot kernel (1e-5 of max of the plain version, and of a float64 DFT
at its tile edges, twice bit for bit), K2b's first pass without dy_partial and
the recompute fixup (float32 1e-4 of max, also where y lies 20 std from 0,
and the autograd Function with the mode on within 1e-6 of max of its dy with
it off; bfloat16 one ulp plus the slack of dxn's products; both at C 16 to
128, pools (2, 2) to (2, 8), window and ragged tiles, both draws, an
unaligned y and dout bit-equal), the packed keep-mask kernel bit for bit, K2 and
K5 with the packed draw against their plain versions with that mask, and
one training step with all three knobs on against the CPU, its launches
counted. Then the eval-mode forward's torch.library ops (`dcase19_torch::`
K1 both variants, K3f, K2f eval in both types, K4f, K5f, K6), each the bits
of its wrapper with one launch of its kernel, and `torch.library.opcheck`
on cuda; and the flagship's serving artifact exported and loaded on the
card at batch 24 (within 1e-6 of max of the direct path, K1 1, K3f 2, K2f
3 launches a call). And DCASE_FLAT_OPT=1: one training step under each
setting, bit for bit the same, and its flat checkpoint restored on the card
leaf for leaf, for plain and ramped Adam.
"""

import numpy as np
import pytest
import torch

from dcase2019_task4_tpu_torch.ops import crows_block, entry_conv, fused_block, fused_entry_block, fused_mel, packed_conv
from dcase2019_task4_tpu_torch.ops.mel import MelFrontend

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _t(a, device):
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


# n_fft -> hop (odd hops: unaligned frames); the n_fft cover every pass plan of the kernel
HOPS = {64: 25, 256: 100, 512: 129, 1024: 257, 2048: 511, 4096: 1023}


def _mel_inputs(cuda, n_fft, frames, audio):
    """K1's frontend at n_fft and its chunks of `audio` [B, L] (float32 or int16)."""
    fe = MelFrontend(n_window=n_fft, hop_length=HOPS[n_fft], max_frames=frames, device=cuda)
    return fe, fe._hop_chunks(audio), dict(n_fft=n_fft, hop=HOPS[n_fft], T=frames)


@pytest.mark.parametrize("n_fft", sorted(HOPS))
@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("frames", [96, 37])  # 37: a partial last tile
def test_fused_stft_mel(cuda, dtype, frames, n_fft):
    rng = np.random.default_rng(frames + n_fft)
    audio = _t(0.2 * rng.standard_normal((3, HOPS[n_fft] * frames + n_fft)), cuda)
    if dtype == "int16":
        audio = torch.round(audio * 32768).clamp(-32768, 32767).to(torch.int16)
    fe, chunks, kw = _mel_inputs(cuda, n_fft, frames, audio)
    before = fused_mel.fused_stft_mel.launches
    out = fused_mel.fused_stft_mel(chunks, fe.bases(), **kw)
    ref = fused_mel.fused_stft_mel_reference(chunks, fe.bases(), **kw)
    assert fused_mel.fused_stft_mel.launches == before + 1
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4 * ref.abs().max().item())


@pytest.mark.parametrize("hz", [440.0, 1000.0, 5000.0])
def test_fused_stft_mel_pure_tone_peaks_in_its_band(cuda, hz):
    t = np.arange(511 * 37 + 2048) / 44100.0
    fe, chunks, kw = _mel_inputs(cuda, 2048, 37, _t(0.5 * np.sin(2 * np.pi * hz * t)[None], cuda))
    out = fused_mel.fused_stft_mel(chunks, fe.bases(), **kw)
    band = fe.mel_fb[int(round(hz * 2048 / 44100.0))].argmax().item()  # the band weighting the tone's bin most
    assert (out.argmax(-1) == band).all()
    ref = fused_mel.fused_stft_mel_reference(chunks, fe.bases(), **kw)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4 * ref.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.int16])
def test_fused_stft_mel_silence_is_exact_zeros(cuda, dtype):
    fe, chunks, kw = _mel_inputs(cuda, 2048, 37, torch.zeros((2, 511 * 37 + 2048), dtype=dtype, device=cuda))
    out = fused_mel.fused_stft_mel(chunks, fe.bases(), **kw)
    assert torch.equal(out, torch.zeros_like(out))


def test_fused_stft_mel_full_scale_int16(cuda):
    rng = np.random.default_rng(7)
    pcm = np.where(rng.random((2, 511 * 96 + 2048)) < 0.5, -32768, 32767).astype(np.int16)
    fe, chunks, kw = _mel_inputs(cuda, 2048, 96, torch.as_tensor(pcm, device=cuda))
    out = fused_mel.fused_stft_mel(chunks, fe.bases(), **kw)
    ref = fused_mel.fused_stft_mel_reference(chunks, fe.bases(), **kw)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4 * ref.abs().max().item())


def test_fused_stft_mel_refuses_bases_without_the_kernel_tables(cuda):
    fe, chunks, kw = _mel_inputs(cuda, 2048, 37, torch.zeros((1, 511 * 37 + 2048), device=cuda))
    before = fused_mel.fused_stft_mel.launches
    with pytest.raises(ValueError, match="tables of build_bases"):
        fused_mel.fused_stft_mel(chunks, fused_mel.FusedMelBases(fe.cos_basis, fe.sin_basis, fe.mel_fb), **kw)
    assert fused_mel.fused_stft_mel.launches == before


# K3's float32 forward / dx tiles (whole frequency rows of 128 or 64 pixels): F 1 to 128, C 16 to 128 (20: not a
# multiple of the 64-wide channel slice or of 16), T not a multiple of the tile's rows, the flagship's blocks 2, 3
K3_F32_EDGES = [(1, 150, 1, 16), (2, 45, 3, 20), (1, 37, 4, 64), (1, 11, 5, 20), (1, 3, 128, 64), (1, 19, 16, 128)]
K3_F32_FLAGSHIP = [(24, 432, 16, 64), (24, 216, 4, 64)]


@pytest.mark.parametrize("shape", [(2, 48, 16, 16), (2, 24, 4, 16), (1, 13, 8, 64), (1, 9, 32, 128)]
                         + K3_F32_EDGES + K3_F32_FLAGSHIP)
def test_conv2d_packed(cuda, shape):
    rng = np.random.default_rng(sum(shape))
    C = shape[-1]
    params = {"w": _t(rng.uniform(-0.1, 0.1, (3, 3, C, C)), cuda), "b": _t(rng.standard_normal(C), cuda)}
    x = _t(rng.standard_normal(shape), cuda)
    before = packed_conv.conv2d_forward.launches
    out = packed_conv.conv2d_packed(params, x)
    assert packed_conv.conv2d_forward.launches == before + 1
    torch.testing.assert_close(out, packed_conv.conv2d_reference(params, x), rtol=0, atol=1e-4)


@pytest.mark.parametrize("shape", [(2, 96, 64, 16), (2, 24, 4, 16), (1, 14, 8, 64), (1, 8, 16, 128), (1, 14, 16, 20),
                                   (2, 10, 24, 100)])
def test_fused_bn_glu_pool(cuda, shape):
    rng = np.random.default_rng(sum(shape))
    C = shape[-1]
    y = _t(rng.standard_normal(shape), cuda)
    args = (_t(1 + 0.1 * rng.standard_normal(C), cuda), _t(0.1 * rng.standard_normal(C), cuda),
            _t(0.2 * rng.standard_normal(C), cuda), _t(rng.uniform(0.5, 2.0, C), cuda),
            _t(rng.standard_normal((C, C)) / np.sqrt(C), cuda), _t(0.1 * rng.standard_normal(C), cuda))
    fn = fused_block.fused_bn_glu_pool
    before = (fn.launches_eval, fn.launches_train)
    out = fn(y, *args, (2, 4), 1e-3)
    assert (fn.launches_eval, fn.launches_train) == (before[0] + 1, before[1])
    ref = fused_block.reference_block(y, *args, (2, 4), 1e-3)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)


def _block_args(rng, C, device):
    return (_t(1 + 0.1 * rng.standard_normal(C), device), _t(0.1 * rng.standard_normal(C), device),
            _t(0.2 * rng.standard_normal(C), device), _t(rng.uniform(0.5, 2.0, C), device),
            _t(rng.standard_normal((C, C)) / np.sqrt(C), device), _t(0.1 * rng.standard_normal(C), device))


# T not a multiple of the pixel tile's rows (partial last tile), C = 16 and 64
TRAIN_SHAPES = [(2, 98, 64, 16), (3, 26, 4, 16), (1, 14, 8, 64), (2, 38, 16, 64), (1, 8, 16, 128)]


@pytest.mark.parametrize("shape", TRAIN_SHAPES)
def test_fused_bn_glu_pool_train_mask_is_bit_equal(cuda, shape):
    rng = np.random.default_rng(sum(shape))
    y = _t(rng.standard_normal(shape), cuda)
    args = _block_args(rng, shape[-1], cuda)
    seed = torch.tensor([123456789 + shape[1]])  # a CPU tensor, as the model hands it
    fn = fused_block.fused_bn_glu_pool
    before = (fn.launches_eval, fn.launches_train)
    out = fn(y, *args, (2, 4), 1e-3, rate=0.5, seed=seed)
    assert (fn.launches_eval, fn.launches_train) == (before[0], before[1] + 1)
    mask = fused_block.dropout_keep_mask(seed, shape, 0.5, device=cuda)
    ref = fused_block.reference_block(y, *args, (2, 4), 1e-3, mask, 0.5)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
    # the mask alone: y = 0 gives xn = 0 and σ = 1/2 exactly; a GLU of weight 0
    # and bias 1 then gives g = mask exactly at rate 1/2, so the pooled sum
    # counts the kept elements
    C = shape[-1]
    unit = (torch.ones(C, device=cuda), torch.zeros(C, device=cuda), torch.zeros(C, device=cuda),
            torch.ones(C, device=cuda), torch.zeros(C, C, device=cuda), torch.ones(C, device=cuda))
    pooled = fused_block.fused_bn_glu_pool(torch.zeros(shape, device=cuda), *unit, (2, 4), 1e-3, rate=0.5, seed=seed)
    kept = pooled.double().sum().item() * 8
    assert round(kept) == int(mask.sum(dtype=torch.float64).item())


@pytest.mark.parametrize("shape", TRAIN_SHAPES)
def test_batch_stats(cuda, shape):
    y = _t(3.0 + np.random.default_rng(sum(shape)).standard_normal(shape), cuda)
    before = fused_block.batch_stats.launches
    s, sq = fused_block.batch_stats(y)
    assert fused_block.batch_stats.launches == before + 1
    rs, rsq = (t.sum(dim=(0, 1, 2)) for t in (y.double(), y.double() ** 2))
    torch.testing.assert_close(s.double(), rs, rtol=1e-6, atol=0)
    torch.testing.assert_close(sq.double(), rsq, rtol=1e-6, atol=0)
    s2, sq2 = fused_block.batch_stats(y)
    assert torch.equal(s, s2) and torch.equal(sq, sq2)


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("shape", TRAIN_SHAPES)
def test_fused_block_backward(cuda, shape, rate):
    rng = np.random.default_rng(sum(shape) + 1)
    C = shape[-1]
    y = _t(rng.standard_normal(shape), cuda)
    scale, bias, _, _, w, b = _block_args(rng, C, cuda)
    s, sq = fused_block.batch_stats(y)
    n = y.numel() // C
    mean = s / n
    var = sq / n - mean * mean
    dout = _t(rng.standard_normal((shape[0], shape[1] // 2, shape[2] // 4, C)), cuda)
    seed = torch.tensor([77])
    mask = fused_block.dropout_keep_mask(seed, shape, rate, device=cuda) if rate else None
    ref = fused_block.bwd_reference(y, dout, scale, bias, mean, var, w, b, (2, 4), 1e-3, mask, 1.0 - rate)

    def run():
        leaves = [t.clone().requires_grad_(True) for t in (y, scale, bias, w, b)]
        out = fused_block.fused_bn_glu_dropout_pool(leaves[0], leaves[1], leaves[2], mean, var, leaves[3],
                                                    leaves[4], seed, rate, (2, 4), 1e-3, True)
        out.backward(dout)
        return [t.grad for t in leaves]

    dy, dscale, dbias, dw, db = run()
    for name, got, want in zip(("dy", "dscale", "dbias", "dw", "db"), (dy, dscale, dbias, dw, db), ref):
        tol = 1e-4 * want.abs().max().item()
        assert (got - want).abs().max().item() <= tol, name
    again = run()
    for got, rerun in zip((dy, dscale, dbias, dw, db), again):
        assert torch.equal(got, rerun)  # fixed-order folds: bit-equal on a repeat


@pytest.mark.parametrize("shape", [(2, 48, 16, 16), (3, 26, 4, 16), (1, 13, 8, 64), (2, 37, 16, 64), (1, 9, 32, 128)]
                         + K3_F32_EDGES + K3_F32_FLAGSHIP)
def test_conv2d_packed_gradients(cuda, shape):
    rng = np.random.default_rng(sum(shape) + 2)
    C = shape[-1]
    w = _t(rng.uniform(-0.1, 0.1, (3, 3, C, C)), cuda).requires_grad_(True)
    b = _t(rng.standard_normal(C), cuda).requires_grad_(True)
    x = _t(rng.standard_normal(shape), cuda).requires_grad_(True)
    dy = _t(rng.standard_normal(shape), cuda)
    counts = (packed_conv.conv2d_forward.launches, packed_conv.conv2d_dx.launches, packed_conv.conv2d_wgrad.launches)
    packed_conv.conv2d_packed({"w": w, "b": b}, x).backward(dy)
    assert (packed_conv.conv2d_forward.launches, packed_conv.conv2d_dx.launches,
            packed_conv.conv2d_wgrad.launches) == tuple(c + 1 for c in counts)
    dx_ref = packed_conv.conv2d_dx_reference(w.detach(), dy)
    dw_ref, db_ref = packed_conv.conv2d_wgrad_reference(x.detach(), dy)
    for got, want in ((x.grad, dx_ref), (w.grad, dw_ref), (b.grad, db_ref)):
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    dw2, db2 = packed_conv.conv2d_wgrad(x.detach(), dy)
    assert torch.equal(dw2, w.grad) and torch.equal(db2, b.grad)


@pytest.mark.parametrize("plan", [(128, 64), (128, 16), (64, 32), (64, 4)])
@pytest.mark.parametrize("shape", [(1, 37, 16, 64), (2, 13, 5, 20), (1, 9, 32, 128), (1, 40, 3, 18)])
def test_conv2d_float32_tile_plans(cuda, shape, plan, monkeypatch):
    """The float32 forward and dx kernel under launch plans other than the
    one `conv_plan` picks: both pixel tiles (8 × 8 and 4 × 8 register
    tiles) and weight slices from 64 down to 4 input channels (several
    slices a tap), C = 18 (4-byte copies); each launch counted."""
    pix, kc = plan
    monkeypatch.setattr(packed_conv, "conv_plan", lambda shape, sms=None: (pix, kc, 0))
    rng = np.random.default_rng(sum(shape) + pix + kc)
    C = shape[-1]
    w, b = _t(rng.uniform(-0.1, 0.1, (3, 3, C, C)), cuda), _t(rng.standard_normal(C), cuda)
    x = _t(rng.standard_normal(shape), cuda)
    before = (packed_conv.conv2d_forward.launches, packed_conv.conv2d_dx.launches)
    out, dx = packed_conv.conv2d_forward({"w": w, "b": b}, x), packed_conv.conv2d_dx(w, x)
    assert (packed_conv.conv2d_forward.launches, packed_conv.conv2d_dx.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(out, packed_conv.conv2d_reference({"w": w, "b": b}, x), rtol=0, atol=1e-4)
    want = packed_conv.conv2d_dx_reference(w, x)
    assert (dx - want).abs().max().item() <= 1e-4 * want.abs().max().item()


# K2b's float32 reduce pass: C 4 to 128 (padded to 64 or 128 channels), partial last tiles of whole pooling rows
# (8 rows of 16, 4 of 32, 4 of 24), window tiles (2 × 64 of a 2 × 128 row), both draws, the recompute knob
FUSED_F32_TILES = [((2, 38, 16, 4), (2, 4)), ((1, 26, 32, 16), (2, 4)), ((2, 6, 128, 64), (2, 4)),
                   ((1, 14, 24, 128), (2, 8))]


@pytest.mark.parametrize("recompute", [False, True])
@pytest.mark.parametrize("rate,pack", [(0.0, False), (0.5, False), (0.5, True)])
@pytest.mark.parametrize("shape,pool", FUSED_F32_TILES)
def test_fused_block_backward_float32_tiles(cuda, shape, pool, rate, pack, recompute):
    """The whole float32 backward through the autograd Function against the
    formulas (1e-4 of max on dy, dscale, dbias, dw, db), bit for bit on a
    repeat, its first pass and its second counted."""
    rng = np.random.default_rng(sum(shape) + 11)
    C = shape[-1]
    y = _t(rng.standard_normal(shape), cuda)
    scale, bias, _, _, w, b = _block_args(rng, C, cuda)
    s, sq = fused_block.batch_stats(y)
    n = y.numel() // C
    mean = s / n
    var = sq / n - mean * mean
    dout = _t(rng.standard_normal((shape[0], shape[1] // pool[0], shape[2] // pool[1], C)), cuda)
    seed = torch.tensor([91])
    fb = fused_block
    mask = fb.dropout_keep_mask(seed, shape, rate, device=cuda, pack_bits=pack) if rate else None
    ref = fb.bwd_reference(y, dout, scale, bias, mean, var, w, b, pool, 1e-3, mask, 1.0 - rate)

    def run():
        leaves = [t.clone().requires_grad_(True) for t in (y, scale, bias, w, b)]
        out = fb.fused_bn_glu_dropout_pool(leaves[0], leaves[1], leaves[2], mean, var, leaves[3], leaves[4], seed,
                                           rate, pool, 1e-3, True, pack_bits=pack, recompute=recompute)
        out.backward(dout)
        return [t.grad for t in leaves]

    first = "launches_nodyp" if recompute else "launches"
    second = fb.bwd_fixup_recompute if recompute else fb.bwd_fixup
    before = (getattr(fb.bwd_reduce, first), second.launches)
    grads = run()
    assert (getattr(fb.bwd_reduce, first), second.launches) == (before[0] + 1, before[1] + 1)
    for name, got, want in zip(("dy", "dscale", "dbias", "dw", "db"), grads, ref):
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item(), name
    for got, rerun in zip(grads, run()):
        assert torch.equal(got, rerun)  # fixed-order folds: bit-equal on a repeat


# K3's float32 weight gradient (nine taps a block, 8 × 8 register tiles): F 4 to 32 at the main path's C = 64,
# ragged last time tiles, C not a multiple of the 64-wide channel slice (80, 24) or of 4 (18: 4-byte copies),
# one clip, and F = 1 and 128, where one shared buffer takes the place of two
WGRAD_F32_SHAPES = [(1, 37, 16, 64), (2, 45, 4, 64), (1, 13, 32, 64), (1, 21, 16, 80), (2, 19, 4, 24),
                    (1, 40, 3, 18), (1, 5, 128, 64), (1, 150, 1, 16)]


@pytest.mark.parametrize("shape", WGRAD_F32_SHAPES)
def test_conv2d_wgrad_float32_tiles(cuda, shape):
    """dW and db within 1e-4 of their max of the plain version's, the
    kernel's one part sum (read from its slots) dW bit for bit, and a second
    call the same bits."""
    rng = np.random.default_rng(sum(shape) + 5)
    x, dy = _t(rng.standard_normal(shape), cuda), _t(rng.standard_normal(shape), cuda)
    before = packed_conv.conv2d_wgrad.launches
    dw, db, parts = packed_conv.conv2d_wgrad_parts(x, dy)
    assert packed_conv.conv2d_wgrad.launches == before + 1
    dw_ref, db_ref = packed_conv.conv2d_wgrad_reference(x, dy)
    for got, want in ((dw, dw_ref), (db, db_ref)):
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    assert parts.shape == (1, *dw.shape) and torch.equal(parts[0], dw)
    again = packed_conv.conv2d_wgrad(x, dy)
    assert torch.equal(again[0], dw) and torch.equal(again[1], db)


# x [B, T, F] and C: partial last tiles, F from 4 to 128, C = 8 to 128, and the flagship block-1 shape
ENTRY_SHAPES = [((2, 98, 64), 16), ((3, 26, 4), 16), ((1, 14, 8), 64), ((2, 38, 16), 64), ((1, 9, 128), 8),
                ((1, 8, 16), 128), ((24, 864, 64), 64)]


def _entry_params(rng, C, device):
    return {"w": _t(0.3 * rng.standard_normal((3, 3, 1, C)), device), "b": _t(0.1 * rng.standard_normal(C), device)}


@pytest.mark.parametrize("shape,C", ENTRY_SHAPES)
def test_entry_conv_forward_stats_and_wgrad(cuda, shape, C):
    rng = np.random.default_rng(sum(shape) + C)
    params = _entry_params(rng, C, cuda)
    x = _t(rng.standard_normal(shape), cuda)
    dy = _t(rng.standard_normal(shape + (C,)), cuda)
    counts = (entry_conv.entry_conv_forward.launches, entry_conv.entry_conv_wgrad.launches)
    w, b = (params[k].clone().requires_grad_(True) for k in ("w", "b"))
    y, s1, s2 = entry_conv.entry_conv_apply({"w": w, "b": b}, x[..., None], want_stats=True)
    y.backward(dy)
    assert (entry_conv.entry_conv_forward.launches, entry_conv.entry_conv_wgrad.launches) == (counts[0] + 1, counts[1] + 1)
    y_ref, _, _ = entry_conv.entry_conv_reference(params, x)
    torch.testing.assert_close(y.detach(), y_ref, rtol=0, atol=1e-5)
    for got, want in ((s1, y_ref.double().sum(dim=(0, 1, 2))), (s2, (y_ref.double() ** 2).sum(dim=(0, 1, 2)))):
        assert (got.double() - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    dw_ref, db_ref = entry_conv.entry_conv_wgrad_reference(x, dy)
    for got, want in ((w.grad, dw_ref), (b.grad, db_ref)):
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    # the statistics-only mode and a repeat: the same bits
    before = entry_conv.entry_conv_stats.launches
    only = entry_conv.entry_conv_stats(params, x)
    assert entry_conv.entry_conv_stats.launches == before + 1
    assert torch.equal(only[0], s1) and torch.equal(only[1], s2)
    dw2, db2 = entry_conv.entry_conv_wgrad(x, dy)
    assert torch.equal(dw2, w.grad) and torch.equal(db2, b.grad)
    for mode in ("no_patch", "write_only"):
        torch.testing.assert_close(entry_conv.entry_conv_ablation(params, x, mode),
                                   entry_conv.entry_conv_ablation_reference(params, x, mode), rtol=0, atol=1e-6)


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("shape,C", [sc for sc in ENTRY_SHAPES if sc[0][1] % 2 == 0 and sc[0][2] * 2 <= 128])
def test_entry_block_forward_and_backward(cuda, shape, C, rate):
    """K5s, K5f, K5b1, K5b2 through the autograd Function against the
    formulas, the mask shared with K2f (conv2d → fused block, same seed), and
    bit-equal repeats."""
    rng = np.random.default_rng(sum(shape) + C + 1)
    B, T, Fq = shape
    conv = _entry_params(rng, C, cuda)
    scale, bias, _, _, gw, gb = _block_args(rng, C, cuda)
    x = _t(rng.standard_normal(shape), cuda)
    dout = _t(rng.standard_normal((B, T // 2, Fq // 4, C)), cuda)
    seed = torch.tensor([4242 + T])
    fe = fused_entry_block
    counts = (fe.entry_block_stats_apply.launches, fe.entry_block_fwd.launches_eval, fe.entry_block_fwd.launches_train,
              fe.entry_block_bwd_reduce.launches, fe.entry_block_bwd_wgrad.launches)

    def run():
        leaves = [t.clone().requires_grad_(True) for t in (conv["w"], conv["b"], scale, bias, gw, gb)]
        w, b, sc, bi, w2, b2 = leaves
        s, sq = fe.entry_block_stats_apply({"w": w, "b": b}, x)
        mean = s / (B * T * Fq)
        var = sq / (B * T * Fq) - mean * mean
        out = fe.entry_block_apply({"w": w, "b": b}, sc, bi, mean, var, w2, b2, x, seed, rate, (2, 4), 1e-3, True)
        out.backward(dout)
        return out.detach(), mean, var, [t.grad for t in leaves]

    out, mean, var, grads = run()
    assert counts == (fe.entry_block_stats_apply.launches - 1, fe.entry_block_fwd.launches_eval - (rate == 0.0),
                      fe.entry_block_fwd.launches_train - (rate > 0.0), fe.entry_block_bwd_reduce.launches - 1,
                      fe.entry_block_bwd_wgrad.launches - 1)
    mask = fused_block.dropout_keep_mask(seed, shape + (C,), rate, device=cuda) if rate else None
    ref = fe.reference_entry_block(x, conv["w"], conv["b"], scale, bias, mean, var, gw, gb, (2, 4), 1e-3, mask, 1.0 - rate)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
    y = entry_conv.entry_conv_reference(conv, x)[0]
    pair = fused_block.fused_bn_glu_pool(y, scale, bias, mean, var, gw, gb, (2, 4), 1e-3, rate=rate, seed=seed)
    torch.testing.assert_close(out, pair, rtol=0, atol=1e-5)
    # the formulas in float64: d conv_b is zero in exact arithmetic under
    # through-statistics BatchNorm, and at the flagship shape a float32 plain
    # version's own rounding noise there (85 M addends) exceeds the kernel's
    dbl = [t.double() for t in (x, dout, conv["w"], conv["b"], scale, bias, mean, var, gw, gb)]
    want = fe.entry_block_bwd_reference(*dbl, (2, 4), 1e-3, None if mask is None else mask.double(), 1.0 - rate)
    top = max(w.abs().max().item() for w in want)
    for name, got, w in zip(("dw", "dcb", "dscale", "dbias", "dgw", "dgb"), grads, want):
        limit = 1e-4 * w.abs().max().item() + (1e-6 * top if name == "dcb" else 0.0)  # the gauge leaf's noise floor
        assert (got.double() - w).abs().max().item() <= limit, name
    out2, _, _, grads2 = run()
    assert torch.equal(out, out2) and all(torch.equal(a, b) for a, b in zip(grads, grads2))


def test_crows_entries_count_their_launches(cuda):
    rng = np.random.default_rng(5)
    B, T, Fq, C = 2, 12, 64, 64
    conv = _entry_params(rng, C, cuda)
    scale, bias, _, _, gw, gb = _block_args(rng, C, cuda)
    gw.requires_grad_(True)
    x = _t(rng.standard_normal((B, T, Fq, 1)), cuda)
    cr, fe = crows_block, fused_entry_block
    names = ("launches_eval", "launches_train", "launches_bwd_reduce", "launches_bwd_wgrad")
    before = [getattr(cr.crows_apply, n) for n in names] + [cr.crows_stats_apply.launches]
    kernel_before = (fe.entry_block_stats_apply.launches, fe.entry_block_fwd.launches_train)
    s, sq = cr.crows_stats_apply(conv, x)
    mean = s / (B * T * Fq)
    out = cr.crows_apply(conv, scale, bias, mean, sq / (B * T * Fq) - mean * mean, gw, gb, x, 3, 0.5, (2, 4), 1e-3, True)
    out.sum().backward()
    cr.crows_apply(conv, scale, bias, mean, torch.ones_like(mean), gw, gb, x, 0, 0.5, (2, 4), 1e-3, False)
    after = [getattr(cr.crows_apply, n) for n in names] + [cr.crows_stats_apply.launches]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1, 1, 1]
    assert (fe.entry_block_stats_apply.launches, fe.entry_block_fwd.launches_train) == (kernel_before[0] + 1, kernel_before[1] + 1)
    ref = fe.entry_block_apply(conv, scale, bias, mean, sq / (B * T * Fq) - mean * mean, gw, gb, x, 3, 0.5, (2, 4), 1e-3, True)
    assert torch.equal(out, ref)  # one kernel family behind both entries


@pytest.mark.parametrize("rate", [0.5, 0.25])
@pytest.mark.parametrize("shape", [(2, 6, 8, 16), (777,), (3, 38, 16, 64), (4, 512, 128)])
def test_dropout_mask_kernel_is_bit_equal_to_the_plain_mask(cuda, shape, rate):
    seed = torch.tensor([2019 + len(shape)])
    before = fused_block.dropout_mask.launches
    got = fused_block.dropout_mask(seed, shape, rate, cuda)
    assert fused_block.dropout_mask.launches == before + 1
    assert torch.equal(got, fused_block.dropout_keep_mask(seed, shape, rate, device=cuda))
    assert torch.equal(got.cpu(), fused_block.dropout_keep_mask(seed, shape, rate))
    n = got.numel()
    if n >= 100_000:
        assert abs(got.mean().item() - (1.0 - rate)) < 5.0 * np.sqrt(rate * (1 - rate) / n)


def test_train_step_on_the_card_repeats_a_cpu_step(cuda):
    """One Mean-Teacher step at a small geometry on the card (kernels) and on
    the CPU (plain versions) from the same state and a CPU generator."""
    _step_on_the_card_against_the_cpu(cuda, None)


@pytest.mark.parametrize("flag", ["entry_conv_pallas", "entry_block_pallas", "entry_block_crows"])
def test_train_step_under_a_first_block_flag_repeats_a_cpu_step(cuda, flag):
    _step_on_the_card_against_the_cpu(cuda, flag)


def _step_on_the_card_against_the_cpu(cuda, flag):
    import copy

    from dcase2019_task4_tpu_torch.config import ModelConfig
    from dcase2019_task4_tpu_torch.train import steps

    filters = (64, 16, 16) if flag == "entry_block_crows" else (16, 16, 16)
    cfg = ModelConfig(nb_filters=filters, n_rnn_cell=16, **({flag: True} if flag else {}))
    base = steps.init_train_state(cfg, lambda p: torch.optim.Adam(p, lr=1e-3), torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    audio = (0.1 * torch.randn(8, 95 * 511 + 2048, generator=g) * 32768).clamp(-32768, 32767).to(torch.int16)
    batch = {"audio": audio, "frames": torch.full((8,), 96), "target": (torch.rand(8, 12, 10, generator=g) > 0.8).float()}
    results = []
    for device in (torch.device("cpu"), cuda):
        state = steps.TrainState(copy.deepcopy(base.student).to(device), copy.deepcopy(base.teacher).to(device), None)
        state.optimizer = torch.optim.Adam(state.student.parameters(), lr=1e-3)
        step = steps.make_train_step(slice(0, 2), slice(6, 8), rampup_length=10,
                                     frontend=MelFrontend(max_frames=96, device=device))
        _, metrics, _ = step(state, {k: v.to(device) for k, v in batch.items()},
                             torch.Generator().manual_seed(2), step.zero_metrics(device))
        results.append(({k: v.item() for k, v in metrics.items()},
                        [p.grad.cpu() for p in state.student.parameters()]))
    (m_cpu, g_cpu), (m_gpu, g_gpu) = results
    for k in m_cpu:
        assert abs(m_cpu[k] - m_gpu[k]) <= 1e-4, k
    # 1e-4 of each leaf's max, above a float32 noise floor of 1e-6 of the
    # step's largest gradient (conv biases ahead of a BatchNorm and the
    # attention logits are sums that cancel to rounding noise)
    floor = 1e-6 * max(a.abs().max().item() for a in g_cpu)
    for a, b in zip(g_cpu, g_gpu):
        assert (a - b).abs().max().item() <= 1e-4 * a.abs().max().item() + floor


@pytest.mark.parametrize("ramped", [False, True], ids=["adam", "ramped_adam"])
def test_flat_step_one_is_the_per_leaf_step_on_the_card(cuda, monkeypatch, tmp_path, ramped):
    """DCASE_FLAT_OPT=1 on the card: one Mean-Teacher step from one state
    with the switch unset and set gives the same loss, metrics, student and
    teacher parameters bit for bit (tests/test_torch_flat_opt.py's CPU pin),
    and the flat checkpoint after it restores into a fresh state on the card
    leaf for leaf, for plain and ramped Adam; under cuDNN's deterministic
    algorithms (block 1's conv), which a bit-for-bit claim needs."""
    import copy

    from dcase2019_task4_tpu_torch.config import ModelConfig
    from dcase2019_task4_tpu_torch.train import checkpoints, schedules, steps

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cfg = ModelConfig(nb_filters=(16, 16, 16), n_rnn_cell=16)
    base = steps.init_train_state(cfg, lambda p: torch.optim.Adam(p, lr=1e-3), torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    audio = (0.1 * torch.randn(8, 95 * 511 + 2048, generator=g) * 32768).clamp(-32768, 32767).to(torch.int16)
    batch = {"audio": audio.to(cuda), "frames": torch.full((8,), 96, device=cuda),
             "target": (torch.rand(8, 12, 10, generator=g) > 0.8).float().to(cuda)}

    def fresh():
        state = steps.TrainState(copy.deepcopy(base.student).to(cuda), copy.deepcopy(base.teacher).to(cuda), None)
        if ramped:
            state.optimizer, set_step = schedules.meanteacher_adam(state.student.parameters(), 40, 20)
            set_step(0)
        else:
            state.optimizer = torch.optim.Adam(state.student.parameters(), lr=1e-3)
        return state

    results = []
    for flat in (False, True):
        monkeypatch.setenv("DCASE_FLAT_OPT", "1" if flat else "0")
        state = fresh()
        step = steps.make_train_step(slice(0, 2), slice(6, 8), rampup_length=10,
                                     frontend=MelFrontend(max_frames=96, device=cuda))
        _, metrics, _ = step(state, batch, torch.Generator().manual_seed(2), step.zero_metrics(cuda))
        results.append((metrics, [p.detach().clone() for p in state.student.parameters()],
                        [p.detach().clone() for p in state.teacher.parameters()]))
    (m_tree, s_tree, t_tree), (m_flat, s_flat, t_flat) = results
    for k in m_tree:
        assert torch.equal(m_tree[k], m_flat[k]), k
    for a, b in zip(s_tree + t_tree, s_flat + t_flat):
        assert torch.equal(a, b)
    path = str(tmp_path / "flat.npz")
    checkpoints.save_checkpoint(path, state, {"epoch": 0}, ramped_adam=ramped)
    other = fresh()
    checkpoints.restore_checkpoint(path, other, ramped_adam=ramped)
    want, got = checkpoints.train_state_leaves(state, ramped), checkpoints.train_state_leaves(other, ramped)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(want, got):
        if "hyperparams[" not in k:  # read from the param groups, set by the schedule
            np.testing.assert_array_equal(b, a, err_msg=k)


def test_wrappers_refuse_non_contiguous_input(cuda):
    x = torch.zeros(1, 8, 16, 8, device=cuda).transpose(1, 2)
    params = {"w": torch.zeros(3, 3, 8, 8, device=cuda), "b": torch.zeros(8, device=cuda)}
    with pytest.raises(ValueError, match="contiguous"):
        packed_conv.conv2d_packed(params, x)


# ------------------------------------------------------------ bfloat16 modes
#
# The bfloat16 kernels against the plain versions, which round where the
# kernels round and compute in float32 (float32 TF32 off). Each element of a
# bfloat16 output is held to one bfloat16 ulp plus a slack: the float32
# rounding of the sums (an output that cancels to near zero differs by many
# of its own ulps), one bf16 operand rounding the other way (its float32
# value differs in the last bits between the two versions), and for the
# pooled output one ulp of the window's largest pt-row column sum over
# pt·pf; at most 1e-3 of the elements may lie beyond the one ulp alone. dy =
# dy_partial − a − (y − mean)·b gets one ulp of dy_partial on top. float32
# outputs: 1e-4 of each output's max.


def _ulp(t):
    """The bfloat16 spacing at |t| (floored at the smallest normal)."""
    return torch.exp2(torch.floor(torch.log2(t.abs().float().clamp_min(2.0 ** -126))) - 7)


def _within_ulps(got, want, what, extra=0.0, share_rule=True):
    got, want = got.float(), want.float()
    ulp = _ulp(torch.maximum(got.abs(), want.abs()))
    share = ((got - want).abs() > ulp).sum().item() / got.numel()
    assert share <= 1e-3 or not share_rule, f"{what}: {share:.2e} of the elements beyond one ulp"
    limit = ulp + extra
    over = (got - want).abs() - limit
    bad = int((over > 0).sum().item())
    if bad:
        i = int(over.argmax().item())
        where = np.unravel_index(i, tuple(got.shape))
        raise AssertionError(f"{what}: {bad} elements beyond the limit; the worst at {where}: "
                             f"{got.flatten()[i].item()} against {want.flatten()[i].item()} "
                             f"(limit {limit.flatten()[i].item()})")


def _sum_slack(n, a, b):
    """The float32 rounding of a sum of n products of |a|·|b| at most."""
    return n * a.abs().max().item() * b.abs().max().item() * 2.0 ** -24


def _flip_slack(a, b):
    """One bf16 operand of a product rounding to the other neighbour."""
    return _ulp(a.abs().max()).item() * b.abs().max().item()


def _pool_slack(y, scale, bias, mean, var, w, b, pool, mask=None, keep=1.0):
    """One bfloat16 ulp of each window's largest pt-row column sum over
    pt·pf, plus one xn operand of lin = xn·W flipping and the sums' float32
    rounding, carried to the window mean."""
    xn = (y.float() - mean) * torch.rsqrt(var + 1e-3) * scale + bias
    g = (xn.bfloat16().float() @ w.bfloat16().float() + b) * torch.sigmoid(xn)
    if mask is not None:
        g = g * mask / keep
    B, T, F, C = g.shape
    pt, pf = pool
    cols = g.reshape(B, T // pt, pt, F // pf, pf, C).sum(dim=2).abs().amax(dim=3)
    return _ulp(cols) / (pt * pf) + (_flip_slack(xn, w) + _sum_slack(C, xn, w)) / (keep * pt * pf)


def _dyp_slack(y, dout, scale, bias, mean, var, w, pool, keep=1.0):
    """dy_partial = inv·γ·(dlin·Wᵀ + dh·lin·σ'): one dlin or xn operand
    flipping and the float32 rounding of both channel sums, times inv·γ."""
    inv = torch.rsqrt(var + 1e-3)
    xn = (y.float() - mean) * inv * scale + bias
    dh = dout.float().abs().max() / (pool[0] * pool[1] * keep)
    C = w.shape[0]
    return (inv * scale).abs().max().item() * (_flip_slack(dh, w) + dh.item() * _flip_slack(xn, w) / 4
                                                 + 2 * _sum_slack(C, torch.maximum(xn.abs().max(), dh), w))


# scaled-shaped K2 geometries: whole pooling rows, window tiles of a 2 × 128
# pooling row, a partial frequency tile (F = 96: tiles of 64 and 32), pool (2, 8);
# then the edges of the tensor-core kernels: the flagship's C = 64, C = 20 and
# 100 (channels not a multiple of 16, 8-byte copies), one clip with T not a
# multiple of the tile's rows (last tiles of 6 of 8 and of 6 of 16 rows)
BF16_BLOCKS = [((2, 10, 32, 16), (2, 4)), ((2, 10, 128, 16), (2, 4)), ((1, 6, 96, 128), (2, 4)),
               ((2, 16, 8, 128), (2, 8)), ((1, 4, 128, 128), (2, 4)),
               ((2, 12, 64, 64), (2, 4)), ((1, 14, 16, 20), (2, 4)), ((2, 10, 24, 100), (2, 4)),
               ((1, 22, 8, 64), (2, 8))]


@pytest.mark.parametrize("shape", [(2, 48, 16, 16), (1, 13, 8, 64), (1, 9, 32, 128), (2, 37, 8, 128)])
def test_conv2d_packed_bf16(cuda, shape):
    _conv2d_bf16_case(cuda, shape, dw_sum_slack=False)


# K3's bfloat16 kernels on the tensor cores at the edges of their tiling: the
# frequency widths and channel counts the models send (F 4, 8, 16, 32; C 64,
# 128), one clip and three, T = 37 (the last pixel tile ragged at every
# width, and too few blocks for 128-pixel tiles: the forward takes 64), and
# with three clips a T of 88 128-pixel tiles and one row (two waves of
# 128-pixel tiles, the last ragged)
K3_BF16_EDGES = [(B, 37, Fq, C) for Fq in (4, 8, 16, 32) for C in (64, 128) for B in (1, 3)]
K3_BF16_WAVES = [(3, 88 * (128 // Fq) + 1, Fq, C) for Fq in (4, 8, 16, 32) for C in (64, 128)]


@pytest.mark.parametrize("shape", K3_BF16_EDGES + K3_BF16_WAVES)
def test_conv2d_bf16_tensor_core_tiles(cuda, shape):
    _conv2d_bf16_case(cuda, shape, dw_sum_slack=True)


def _conv2d_bf16_case(cuda, shape, dw_sum_slack):
    """K3 in bfloat16 through the autograd Function against the plain
    versions: each kernel launched once; out and dx within one ulp plus the
    float32 rounding of the sums (dx also against float64); dW's class sums
    as the kernel folded them within 1e-4 of their max and dW their rounded
    sum bit for bit; db 1e-4 of its max; a second wgrad gives the same bits.
    dW element by element: one ulp of itself plus one of each class sum, and
    with `dw_sum_slack` also 1e-4 of the class sums' max per class, with no
    share asked (chip_smoke.py's bar for K3w: a class sum that cancels to
    near zero differs between two float32 summation orders by many of its
    own ulps; more likely the more elements a test has)."""
    rng = np.random.default_rng(sum(shape) + 3)
    C = shape[-1]
    w = _t(rng.uniform(-0.1, 0.1, (3, 3, C, C)), cuda).requires_grad_(True)
    b = _t(rng.standard_normal(C), cuda).requires_grad_(True)
    x = _t(rng.standard_normal(shape), cuda).bfloat16().requires_grad_(True)
    dy = _t(rng.standard_normal(shape), cuda).bfloat16()
    fns = (packed_conv.conv2d_forward, packed_conv.conv2d_dx, packed_conv.conv2d_wgrad)
    counts = [(f.launches, f.launches_bf16) for f in fns]
    out = packed_conv.conv2d_packed({"w": w, "b": b}, x)
    out.backward(dy)
    assert [(f.launches, f.launches_bf16) for f in fns] == [(a, c + 1) for a, c in counts]
    assert out.dtype == x.grad.dtype == torch.bfloat16 and w.grad.dtype == torch.float32
    wb = w.detach().bfloat16()
    _within_ulps(out, packed_conv.conv2d_reference({"w": w.detach(), "b": b.detach()}, x.detach()), "out",
                 _sum_slack(9 * C, x.detach(), wb))
    # dx against the transpose conv in float64 on the rounded operands, rounded once
    T, Fq = shape[1], shape[2]
    dyp = torch.nn.functional.pad(dy.double(), (0, 0, 1, 1, 1, 1))
    w64 = w.detach().bfloat16().double()
    exact = sum(dyp[:, 2 - dt: 2 - dt + T, 2 - df: 2 - df + Fq, :] @ w64[dt, df].t()
                for dt in range(3) for df in range(3))
    _within_ulps(x.grad, exact.bfloat16(), "dx against float64", _sum_slack(9 * C, dy, wb))
    _within_ulps(x.grad, packed_conv.conv2d_dx_reference(w.detach(), dy), "dx", 2 * _sum_slack(9 * C, dy, wb))
    # the gradient of the bfloat16 weights: each output-frequency class's sum
    # rounded where the original packs k lane copies (one rounding at k = 1)
    k = packed_conv.pack_factor(shape[2], C)
    dw, db, parts = packed_conv.conv2d_wgrad_parts(x.detach(), dy)
    assert torch.equal(w.grad, dw) and torch.equal(b.grad, db)
    want_parts = packed_conv.conv2d_wgrad_parts_reference(x.detach(), dy)
    assert len(want_parts) == k
    _check_parts(dw, parts, want_parts, "dW class sums")
    dw_ref, db_ref = packed_conv.conv2d_wgrad_reference(x.detach(), dy)
    assert (db - db_ref).abs().max().item() <= 1e-4 * db_ref.abs().max().item()
    if dw_sum_slack:
        _within_ulps(dw, dw_ref, "dW per class", sum(_ulp(p) for p in want_parts)
                     + k * 1e-4 * want_parts.abs().max().item(), share_rule=False)
    else:
        _within_ulps(dw, dw_ref, "dW per class", sum(_ulp(p) for p in want_parts))
    assert all(torch.equal(p, q) for p, q in zip(packed_conv.conv2d_wgrad(x.detach(), dy), (dw, db)))


def _check_parts(dw, parts, want, what, extra=0.0):
    """A bfloat16 weight gradient's float32 part sums, as the kernel folded
    them (`*_wgrad_parts`), against the plain version's: as many parts,
    each within 1e-4 of the parts' max plus `extra`; and dW, bit for bit,
    the sum of the parts each rounded to bfloat16 in part order. A kernel
    that splits the sum otherwise than the original, or rounds the whole
    sum once, fails here."""
    want = torch.stack(list(want))
    assert parts.shape == want.shape, what
    err, limit = (parts - want).abs().max().item(), 1e-4 * want.abs().max().item() + extra
    assert err <= limit, f"{what}: {err} exceeds {limit}"
    assert torch.equal(dw, sum(p.bfloat16().float() for p in parts)), f"{what}: dW is not the rounded parts' sum"


@pytest.mark.parametrize("shape,pool", BF16_BLOCKS)
def test_fused_block_bf16_forward(cuda, shape, pool):
    rng = np.random.default_rng(sum(shape) + 4)
    y = _t(rng.standard_normal(shape), cuda).bfloat16()
    args = _block_args(rng, shape[-1], cuda)
    fn = fused_block.fused_bn_glu_pool
    seed = torch.tensor([4321])
    for rate in (0.0, 0.5):
        name = "launches_train_bf16" if rate else "launches_eval_bf16"
        before = getattr(fn, name)
        out = fn(y, *args, pool, 1e-3, rate=rate, seed=seed)
        assert getattr(fn, name) == before + 1 and out.dtype == torch.bfloat16
        mask = fused_block.dropout_keep_mask(seed, shape, rate, device=cuda) if rate else None
        ref = fused_block.reference_block(y, *args, pool, 1e-3, mask, 1.0 - rate)
        _within_ulps(out, ref, f"pooled output, rate {rate}", _pool_slack(y, *args, pool, mask, 1.0 - rate))


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("shape,pool", BF16_BLOCKS)
def test_fused_block_bf16_backward(cuda, shape, pool, rate):
    rng = np.random.default_rng(sum(shape) + 5)
    C = shape[-1]
    y = _t(rng.standard_normal(shape), cuda).bfloat16()
    scale, bias, _, _, w, b = _block_args(rng, C, cuda)
    before = (fused_block.batch_stats.launches_bf16, fused_block.bwd_reduce.launches_bf16,
              fused_block.bwd_fixup.launches_bf16)
    s, sq = fused_block.batch_stats(y)
    rs, rsq = (t.sum(dim=(0, 1, 2)) for t in (y.double(), y.double() ** 2))
    torch.testing.assert_close(s.double(), rs, rtol=1e-6, atol=0)
    torch.testing.assert_close(sq.double(), rsq, rtol=1e-6, atol=0)
    n = y.numel() // C
    mean, var = s / n, sq / n - (s / n) ** 2
    dout = _t(rng.standard_normal((shape[0], shape[1] // pool[0], shape[2] // pool[1], C)), cuda).bfloat16()
    seed = torch.tensor([99])
    mask = fused_block.dropout_keep_mask(seed, shape, rate, device=cuda) if rate else None
    dyp_ref = fused_block.bwd_reduce_reference(y, dout, scale, bias, mean, var, w, b, pool, 1e-3, mask, 1.0 - rate)[0]
    ref = fused_block.bwd_reference(y, dout, scale, bias, mean, var, w, b, pool, 1e-3, mask, 1.0 - rate)
    dyp = fused_block.bwd_reduce(y, dout, scale, bias, mean, var, w, b, pool, 1e-3, rate=rate, seed=seed)[0]
    slack = _dyp_slack(y, dout, scale, bias, mean, var, w, pool, 1.0 - rate)
    _within_ulps(dyp, dyp_ref, "dy_partial", slack)

    def run():
        leaves = [t.clone().requires_grad_(True) for t in (y, scale, bias, w, b)]
        fused_block.fused_bn_glu_dropout_pool(leaves[0], leaves[1], leaves[2], mean, var, leaves[3], leaves[4],
                                              seed, rate, pool, 1e-3, True).backward(dout)
        return [t.grad for t in leaves]

    grads = run()
    assert (fused_block.batch_stats.launches_bf16, fused_block.bwd_reduce.launches_bf16,
            fused_block.bwd_fixup.launches_bf16) == (before[0] + 1, before[1] + 2, before[2] + 1)
    assert grads[0].dtype == torch.bfloat16
    _within_ulps(grads[0], ref[0], "dy", _ulp(dyp_ref.float()) + slack + 2.0 ** -20 * dyp_ref.float().abs().max())
    for name, got, want in zip(("dscale", "dbias", "dw", "db"), grads[1:], ref[1:]):
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item(), name
    for got, rerun in zip(grads, run()):
        assert torch.equal(got, rerun)  # fixed-order folds: bit-equal on a repeat


def _unaligned(t):
    """A copy of t whose storage starts one element in: no 8- or 16-byte copies."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 8 != 0
    return view


# K2's bfloat16 tensor-core kernels with the packed draw, in the recompute
# knob's first pass, and on a y whose storage starts one element in (no copy
# alignment: the kernels stage by loads)
K2_BF16_EDGES = [((2, 12, 64, 64), (2, 4)), ((1, 14, 16, 20), (2, 4)), ((2, 10, 24, 100), (2, 4)),
                 ((1, 6, 96, 128), (2, 4))]


@pytest.mark.parametrize("shape,pool", K2_BF16_EDGES)
def test_k2_bf16_packed_draw_recompute_pass_and_unaligned_y(cuda, shape, pool):
    """The forward with the packed draw within the bars of
    test_fused_block_bf16_forward against the plain version with the packed
    mask; the reduce pass with it, dy_partial within its bar and the four
    sums within 1e-4 of their max; the recompute first pass (no dy_partial)
    with dW, db, S1 and S2 bit-equal to the default pass's; both kernels on
    an unaligned y (and dout) bit-equal to their run on an aligned copy."""
    rng = np.random.default_rng(sum(shape) + 13)
    C = shape[-1]
    y = _t(rng.standard_normal(shape), cuda).bfloat16()
    scale, bias, mean, var, w, b = _block_args(rng, C, cuda)
    dout = _t(rng.standard_normal((shape[0], shape[1] // pool[0], shape[2] // pool[1], C)), cuda).bfloat16()
    seed, rate = torch.tensor([5150]), 0.5
    fb = fused_block
    mask = fb.dropout_keep_mask(seed, shape, rate, device=cuda, pack_bits=True)
    kw = dict(rate=rate, seed=seed, pack_bits=True)
    packed = fb.fused_bn_glu_pool.launches_packed
    out = fb.fused_bn_glu_pool(y, scale, bias, mean, var, w, b, pool, 1e-3, **kw)
    assert fb.fused_bn_glu_pool.launches_packed == packed + 1
    ref = fb.reference_block(y, scale, bias, mean, var, w, b, pool, 1e-3, mask, 1.0 - rate)
    _within_ulps(out, ref, "pooled output, packed draw", _pool_slack(y, scale, bias, mean, var, w, b, pool, mask, 0.5))
    got = fb.bwd_reduce(y, dout, scale, bias, mean, var, w, b, pool, 1e-3, recompute=False, **kw)
    want = fb.bwd_reduce_reference(y, dout, scale, bias, mean, var, w, b, pool, 1e-3, mask, 1.0 - rate)
    _within_ulps(got[0], want[0], "dy_partial, packed draw", _dyp_slack(y, dout, scale, bias, mean, var, w, pool, 0.5))
    for name, g, r in zip(("dw", "db", "S1", "S2"), got[1:], want[1:]):
        assert (g - r).abs().max().item() <= 1e-4 * r.abs().max().item(), name
    nodyp = fb.bwd_reduce.launches_nodyp_bf16
    first = fb.bwd_reduce(y, dout, scale, bias, mean, var, w, b, pool, 1e-3, recompute=True, **kw)
    assert fb.bwd_reduce.launches_nodyp_bf16 == nodyp + 1 and first[0] is None
    assert all(torch.equal(g, f) for g, f in zip(got[1:], first[1:]))

    assert torch.equal(fb.fused_bn_glu_pool(_unaligned(y), scale, bias, mean, var, w, b, pool, 1e-3, **kw), out)
    again = fb.bwd_reduce(_unaligned(y), _unaligned(dout), scale, bias, mean, var, w, b, pool, 1e-3, recompute=False,
                          **kw)
    assert all(torch.equal(g, a) for g, a in zip(got, again))


# K2f's float32 register tiles: C = 20 and 12 (padded inside a 64-channel tile), C = 100 and 128 (the <8> plan),
# F = 64 and 128 at pool (2, 4) (tiles of one row pair: the pool by shuffles at C <= 64), pools (2, 2), (2, 8) and
# (4, 4) (F = 40: a ragged last column tile), ragged last time tiles (T = 74 of 8-row tiles, 26 of 32, 10 of 4)
FWD_F32_EDGES = [((1, 14, 16, 20), (2, 4)), ((2, 10, 24, 100), (2, 4)), ((1, 6, 128, 64), (2, 4)),
                 ((2, 6, 64, 20), (2, 4)),
                 ((2, 12, 32, 64), (2, 2)), ((1, 10, 64, 128), (2, 8)), ((1, 8, 40, 12), (4, 4)),
                 ((1, 74, 16, 64), (2, 4)), ((3, 26, 4, 16), (2, 4))]


@pytest.mark.parametrize("shape,pool", FWD_F32_EDGES)
def test_fused_bn_glu_pool_float32_tiles(cuda, shape, pool):
    """The float32 forward in eval mode and with both draws against the
    plain version (1e-5), each launch counted; the kept elements counted by
    the kernel equal to `dropout_keep_mask`'s; and on a y whose storage
    starts one element in (4-byte cp.async copies) bit-equal to its run on
    the aligned y."""
    rng = np.random.default_rng(sum(shape) + sum(pool))
    C = shape[-1]
    y = _t(rng.standard_normal(shape), cuda)
    args = _block_args(rng, C, cuda)
    fn = fused_block.fused_bn_glu_pool
    seed = torch.tensor([2718 + shape[1]])
    unit = (torch.ones(C, device=cuda), torch.zeros(C, device=cuda), torch.zeros(C, device=cuda),
            torch.ones(C, device=cuda), torch.zeros(C, C, device=cuda), torch.ones(C, device=cuda))
    buf = torch.empty(y.numel() + 1, device=cuda)
    unaligned = buf[1:].view(shape)
    unaligned.copy_(y)
    assert unaligned.is_contiguous() and unaligned.data_ptr() % 16 != 0
    for rate, pack in ((0.0, False), (0.5, False), (0.5, True)):
        before = (fn.launches_eval, fn.launches_train, fn.launches_packed)
        out = fn(y, *args, pool, 1e-3, rate=rate, seed=seed, pack_bits=pack)
        assert (fn.launches_eval, fn.launches_train, fn.launches_packed) == \
            (before[0] + (rate == 0), before[1] + (rate > 0), before[2] + pack)
        mask = fused_block.dropout_keep_mask(seed, shape, rate, device=cuda, pack_bits=pack) if rate else None
        ref = fused_block.reference_block(y, *args, pool, 1e-3, mask, 1.0 - rate)
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
        assert torch.equal(fn(unaligned, *args, pool, 1e-3, rate=rate, seed=seed, pack_bits=pack), out)
        if rate:  # y = 0, a GLU of weight 0 and bias 1: g = mask exactly, the pooled sum counts the kept
            zeros = fn(torch.zeros(shape, device=cuda), *unit, pool, 1e-3, rate=rate, seed=seed, pack_bits=pack)
            assert round(zeros.double().sum().item() * pool[0] * pool[1]) == int(mask.sum(dtype=torch.float64).item())


# y with a per-channel offset of several std (a conv output's bias): (offset, std) of 20 and 3, and 100 and 1
@pytest.mark.parametrize("offset,std", [(20.0, 3.0), (100.0, 1.0)])
@pytest.mark.parametrize("shape,pool", [((2, 8, 64, 64), (2, 4)), ((1, 10, 64, 128), (2, 8)), ((1, 14, 16, 20), (2, 4))])
def test_fused_bn_glu_pool_float32_channel_offset(cuda, shape, pool, offset, std):
    """The float32 forward, eval and train, where y's mean lies many std from
    0 and BN's mean and var are y's own: held to the plain version at the
    same 1e-5 (the mean is subtracted before the product, so no float32 sum
    cancels it)."""
    rng = np.random.default_rng(sum(shape) + int(offset))
    C = shape[-1]
    yn = offset + std * rng.standard_normal(shape) * rng.uniform(0.5, 2.0, C)
    y = _t(yn, cuda)
    scale, bias, _, _, w, b = _block_args(rng, C, cuda)
    mean, var = _t(yn.mean(axis=(0, 1, 2)), cuda), _t(yn.var(axis=(0, 1, 2)), cuda)
    args = (scale, bias, mean, var, w, b)
    seed = torch.tensor([3141 + shape[1]])
    for rate in (0.0, 0.5):
        out = fused_block.fused_bn_glu_pool(y, *args, pool, 1e-3, rate=rate, seed=seed)
        mask = fused_block.dropout_keep_mask(seed, shape, rate, device=cuda) if rate else None
        ref = fused_block.reference_block(y, *args, pool, 1e-3, mask, 1.0 - rate)
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)


def test_fused_block_float32_in_window_tiles(cuda):
    """The float32 kernels at a pooling row of 2 × 128 pixels (window tiles)."""
    rng = np.random.default_rng(6)
    shape, pool = (2, 6, 128, 64), (2, 4)
    y = _t(rng.standard_normal(shape), cuda)
    args = _block_args(rng, 64, cuda)
    out = fused_block.fused_bn_glu_pool(y, *args, pool, 1e-3)
    torch.testing.assert_close(out, fused_block.reference_block(y, *args, pool, 1e-3), rtol=0, atol=1e-5)
    scale, bias, mean, var, w, b = args
    dout = _t(rng.standard_normal((2, 3, 32, 64)), cuda)
    got = fused_block.bwd_reduce(y, dout, scale, bias, mean, var, w, b, pool, 1e-3)
    want = fused_block.bwd_reduce_reference(y, dout, scale, bias, mean, var, w, b, pool, 1e-3)
    for g, r in zip(got, want):
        assert (g - r).abs().max().item() <= 1e-4 * r.abs().max().item()


def test_scaled_train_step_on_the_card_repeats_a_cpu_step(cuda):
    """One Mean-Teacher step of a small scaled-shaped bfloat16 model (128
    mels, pooling (2, 4) (2, 4) (2, 8), SpecAugment) on the card and on the
    CPU from the same state and a CPU generator: metrics 1e-4, gradient
    leaves 2e-2 of their max plus 1e-6 of the largest (bfloat16 roundings
    that flip between two float32 sums in another order; tests/
    test_torch_scaled.py states the bars against JAX), gauge leaves 1e-3 of
    the largest."""
    import copy

    from dcase2019_task4_tpu_torch.config import ModelConfig, scaled_config
    from dcase2019_task4_tpu_torch.train import steps

    sc = scaled_config()
    cfg = ModelConfig(nb_filters=(24, 24, 24), n_rnn_cell=16, pooling=sc.model.pooling, compute_dtype="bfloat16")
    sa = dict(time_masks=sc.train.sa_time_masks, max_time_width=sc.train.sa_max_time_width,
              freq_masks=sc.train.sa_freq_masks, max_freq_width=sc.train.sa_max_freq_width)
    base = steps.init_train_state(cfg, lambda p: torch.optim.Adam(p, lr=1e-3), torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    audio = (0.1 * torch.randn(4, 95 * 511 + 2048, generator=g) * 32768).clamp(-32768, 32767).to(torch.int16)
    batch = {"audio": audio, "frames": torch.full((4,), 96), "target": (torch.rand(4, 12, 10, generator=g) > 0.8).float()}
    results = []
    for device in (torch.device("cpu"), cuda):
        state = steps.TrainState(copy.deepcopy(base.student).to(device), copy.deepcopy(base.teacher).to(device), None)
        state.optimizer = torch.optim.Adam(state.student.parameters(), lr=1e-3)
        step = steps.make_train_step(slice(0, 1), slice(3, 4), rampup_length=10, spec_augment_cfg=sa,
                                     frontend=MelFrontend(n_mels=128, max_frames=96, device=device))
        _, metrics, _ = step(state, {k: v.to(device) for k, v in batch.items()},
                             torch.Generator().manual_seed(2), step.zero_metrics(device))
        results.append(({k: v.item() for k, v in metrics.items()},
                        {n: p.grad.cpu() for n, p in state.student.named_parameters()}))
    (m_cpu, g_cpu), (m_gpu, g_gpu) = results
    for k in m_cpu:
        assert abs(m_cpu[k] - m_gpu[k]) <= 1e-4, k
    top = max(a.abs().max().item() for a in g_cpu.values())
    for name, a in g_cpu.items():
        gauge = name.endswith(".conv.bias") or name.startswith("dense_softmax.")
        limit = 2e-2 * a.abs().max().item() + (1e-3 if gauge else 1e-6) * top
        assert (a - g_gpu[name]).abs().max().item() <= limit, name


# ------------------------------------------------- bfloat16 entry-block family
#
# K4, K5 and the crows layout of K6 in bfloat16 against their plain versions.
# On top of the rules above: a conv output y (a sum of nine exact products)
# may round to the other bfloat16 neighbour where the two versions' float32
# sums differ in the last bit, which moves xn by ulp(y)·inv·γ; dW, the
# gradient of the bfloat16 weights, is rounded in two parts before they are
# added, so each element is held to one ulp of itself plus one of each
# part's sum, plus one dy element of pass 2 rounding the other way
# (ulp(max|dy|)·max|x|). No share of elements is asked of dW: where the parts
# nearly cancel, each rounding that flips between the two versions' float32
# part sums moves an element by more than its own ulp, and dW has few
# elements (9·C). That rule alone cannot tell the partition from one
# rounding of the whole sum, so `_check_parts` holds the kernel's own part
# sums and its rounding of them. d conv_b, zero in exact arithmetic, is held
# to 1e-4 of its max plus the float32 rounding of a sum over the pixels,
# n·max|dy|·2^-24.


def _y_flip(y, scale, bias, mean, var, w, b):
    """One y element rounding the other way, carried to g: Δxn = ulp(y)·inv·γ
    moves lin by Δxn·|W| and the gate by Δxn·|lin|/4."""
    inv = torch.rsqrt(var + 1e-3) * scale
    dxn = _ulp(y.float().abs().max()).item() * inv.abs().max().item()
    xn = (y.float() - mean) * torch.rsqrt(var + 1e-3) * scale + bias
    lin = (xn.bfloat16().float() @ w.bfloat16().float() + b).abs().max().item()
    return dxn * (w.abs().max().item() + lin / 4)


def _entry_pool_slack(y, scale, bias, mean, var, w, b, layout, mask=None, keep=1.0, pool=(2, 4)):
    """The pooled output's slack: one rounding after a float32 sum flipped
    (a pt-row column sum under "planes", a g under "crows"), one xn operand
    flip, the sums' float32 rounding and one y flip, carried to the window
    mean."""
    pt, pf = pool
    if layout == "planes":
        base = _pool_slack(y, scale, bias, mean, var, w, b, pool, mask, keep)
    else:
        xn = (y.float() - mean) * torch.rsqrt(var + 1e-3) * scale + bias
        g = (xn.bfloat16().float() @ w.bfloat16().float() + b) * torch.sigmoid(xn)
        if mask is not None:
            g = g * mask / keep
        B, T, F, C = g.shape
        top = g.reshape(B, T // pt, pt, F // pf, pf, C).abs().amax(dim=(2, 4))
        base = _ulp(top) + (_flip_slack(xn, w) + _sum_slack(C, xn, w)) / (keep * pt * pf)
    return base + _y_flip(y, scale, bias, mean, var, w, b) / (keep * pt * pf)


def _parts_rule(got, want, parts, what, extra=0.0):
    _within_ulps(got, want, what, sum(_ulp(p) for p in parts) + extra, share_rule=False)


# x [B, T, F] and C: partial tiles, an odd F (one part), and the flagship block-1 shape
ENTRY_BF16_SHAPES = [((2, 98, 64), 16), ((3, 26, 4), 16), ((2, 38, 16), 64), ((1, 9, 11), 8), ((24, 864, 64), 64)]


@pytest.mark.parametrize("shape,C", ENTRY_BF16_SHAPES)
def test_entry_conv_bf16(cuda, shape, C):
    rng = np.random.default_rng(sum(shape) + C + 7)
    params = _entry_params(rng, C, cuda)
    x = _t(rng.standard_normal(shape), cuda).bfloat16()
    dy = _t(rng.standard_normal(shape + (C,)), cuda).bfloat16()
    fns = (entry_conv.entry_conv_forward, entry_conv.entry_conv_wgrad)
    counts = [(f.launches, f.launches_bf16) for f in fns]
    w, b = (params[k].clone().requires_grad_(True) for k in ("w", "b"))
    y, s1, s2 = entry_conv.entry_conv_apply({"w": w, "b": b}, x[..., None], want_stats=True)
    y.backward(dy)
    assert [(f.launches, f.launches_bf16) for f in fns] == [(a, c + 1) for a, c in counts]
    assert y.dtype == torch.bfloat16 and w.grad.dtype == b.grad.dtype == torch.float32
    y_ref, _, _ = entry_conv.entry_conv_reference(params, x)
    _within_ulps(y, y_ref, "y", _sum_slack(9, x, params["w"].bfloat16()))
    yd = y.detach().double()
    for got, want in ((s1, yd.sum(dim=(0, 1, 2))), (s2, (yd ** 2).sum(dim=(0, 1, 2)))):
        assert (got.double() - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    dw_ref, db_ref = entry_conv.entry_conv_wgrad_reference(x, dy)
    parts = entry_conv.entry_conv_wgrad_parts_reference(x, dy)
    assert len(parts) == (2 if shape[2] % 2 == 0 else 1)
    _parts_rule(w.grad, dw_ref, parts, "dW")
    dw_k, db_k, parts_k = entry_conv.entry_conv_wgrad_parts(x, dy)
    assert torch.equal(dw_k, w.grad) and torch.equal(db_k, b.grad)
    _check_parts(dw_k, parts_k, parts, "dW parity sums")
    assert (b.grad - db_ref).abs().max().item() <= 1e-4 * db_ref.abs().max().item()
    # a repeat, and the statistics-only mode (K5s): the same bits
    assert all(torch.equal(p, q) for p, q in zip(entry_conv.entry_conv_wgrad(x, dy), (w.grad, b.grad)))
    s_only = fused_entry_block.entry_block_stats_apply(params, x)
    assert torch.equal(s_only[0], s1) and torch.equal(s_only[1], s2)


# K4w's one-wave kernels (x [B, T, F], C): C = 36, F = 63, a T that leaves a
# short tile (tiles of 4 rows at F = 32, C = 12), C = 128, F = 1 and 128, and
# the flagship block-1 shape
WGRAD_SHAPES = [((2, 37, 64), 36), ((2, 37, 63), 64), ((2, 37, 32), 12), ((3, 29, 64), 128), ((2, 45, 128), 128),
                ((1, 300, 1), 4), ((24, 864, 64), 64)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,C", WGRAD_SHAPES)
def test_entry_conv_wgrad_one_wave(cuda, shape, C, dtype):
    """K4w (entry_conv_dw_f32_kernel, entry_conv_dw_bf16_kernel) against its
    plain version: float32 dW and db within 1e-4 of their max; bfloat16 dW
    within one ulp of each parity part of the plain version's, the kernel's
    part sums (read from its slots) within 1e-4 of their max and dW their
    rounded sum bit for bit, db within 1e-5 of its max. One launch a call, a
    repeat bit for bit, and a dy that is not 16-byte aligned gives the same
    bits."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(sum(shape) + C + len(dtype))
    x = _t(rng.standard_normal(shape), cuda).to(dt)
    dy = _t(rng.standard_normal(shape + (C,)), cuda).to(dt)
    fn = entry_conv.entry_conv_wgrad
    before = (fn.launches, fn.launches_bf16)
    dw, db = fn(x, dy)
    assert (fn.launches, fn.launches_bf16) == (before[0] + (dt == torch.float32), before[1] + (dt == torch.bfloat16))
    dw_ref, db_ref = entry_conv.entry_conv_wgrad_reference(x, dy)
    assert dw.shape == (3, 3, 1, C) and db.shape == (C,) and dw.dtype == db.dtype == torch.float32
    if dt == torch.float32:
        for got, want in ((dw, dw_ref), (db, db_ref)):
            assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    else:
        parts = entry_conv.entry_conv_wgrad_parts_reference(x, dy)
        assert len(parts) == (2 if shape[2] % 2 == 0 else 1)
        _parts_rule(dw, dw_ref, parts, "dW")
        dw_k, db_k, parts_k = entry_conv.entry_conv_wgrad_parts(x, dy)
        assert torch.equal(dw_k, dw) and torch.equal(db_k, db)
        _check_parts(dw_k, parts_k, parts, "dW parity sums")
        assert (db - db_ref).abs().max().item() <= 1e-5 * db_ref.abs().max().item()
    assert all(torch.equal(p, q) for p, q in zip(fn(x, dy), (dw, db)))
    if x.numel() < 10 ** 6:
        store = torch.empty(dy.numel() + 1, dtype=dt, device=cuda)
        shifted = store[1:].view(dy.shape)
        shifted.copy_(dy)
        assert shifted.data_ptr() % 16
        assert all(torch.equal(p, q) for p, q in zip(fn(x, shifted), (dw, db)))


def _conv9_order_bf16(params, x):
    """y = bf16(((cb + x00 w00) + x01 w01) + ...), the taps dt-major as the
    kernels' conv9 adds them, in float32 tensor operations: a product of a
    bfloat16 x and a bfloat16-rounded weight is exact, so each step rounds
    once, as an FMA does."""
    B, T, Fq = x.shape
    w = params["w"].bfloat16().float()
    xp = torch.nn.functional.pad(x.float(), (1, 1, 1, 1))
    y = params["b"].float().expand(B, T, Fq, -1).contiguous()
    for dt in range(3):
        for df in range(3):
            y = y + xp[:, dt:dt + T, df:df + Fq, None] * w[dt, df, 0]
    return y.bfloat16()


# x [B, T, F] and C at the bfloat16 conv's edges: F 1 to 128 (runs cut by F
# % 4, tiles of 4 to 126 rows), C 4 to 128 (1 to 32 lanes of four channels),
# T leaving a short last tile, and the flagship block-1 shape
ENTRY_CONV_BF16_EDGES = [((2, 131, 1), 4), ((3, 37, 7), 36), ((2, 45, 63), 64), ((2, 27, 64), 96), ((1, 21, 128), 128),
                         ((2, 19, 64), 36), ((24, 864, 64), 64)]


@pytest.mark.parametrize("shape,C", ENTRY_CONV_BF16_EDGES)
def test_entry_conv_bf16_kernel(cuda, shape, C):
    """K4f and K5s in bfloat16 (entry_conv_bf16_kernel): y bit for bit the y
    formed in conv9's order (so K5f bf16 = K4f -> K2f bf16 keeps holding),
    and within one ulp plus the float32 sum's slack of the plain version;
    K5s's sums K4f's bits, within 1e-6 of max of K2s's sums of the stored
    y, a repeat the same bits, the crows entry K5s's bits; each launch
    counted."""
    rng = np.random.default_rng(sum(shape) + C + 29)
    params = _entry_params(rng, C, cuda)
    x = _t(rng.standard_normal(shape), cuda).bfloat16()
    fwd, stats = entry_conv.entry_conv_forward, fused_entry_block.entry_block_stats_apply
    counts = (fwd.launches_bf16, stats.launches_bf16, fwd.launches, stats.launches)
    y, s1, s2 = fwd(params, x)
    sums = stats(params, x)
    assert (fwd.launches_bf16, stats.launches_bf16, fwd.launches, stats.launches) == \
        (counts[0] + 1, counts[1] + 1, counts[2], counts[3])
    assert y.dtype == torch.bfloat16 and s1.dtype == torch.float32
    assert torch.equal(y, _conv9_order_bf16(params, x)), "y against the y formed in conv9's order"
    _within_ulps(y, entry_conv.entry_conv_reference(params, x)[0], "y", _sum_slack(9, x, params["w"].bfloat16()))
    assert torch.equal(sums[0], s1) and torch.equal(sums[1], s2), "K5s's sums against K4f's"
    for got, want in zip((s1, s2), fused_block.batch_stats(y)):
        assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()
    again = fwd(params, x)
    assert all(torch.equal(p, q) for p, q in zip(again, (y, s1, s2)))
    assert all(torch.equal(p, q) for p, q in zip(crows_block.crows_stats_apply(params, x), sums))


@pytest.mark.parametrize("shape,C", ENTRY_CONV_BF16_EDGES)
def test_entry_stats_f32_kernel(cuda, shape, C):
    """K5s in float32 on the one-wave conv (entry_conv_run_kernel<float,
    false>): its sums within 1e-6 of max of K2s's sums of K4f's y and
    within 1e-5 of max of the float64 sums of that y (it sums in float32 a
    tile, so not K4f's bits), a repeat the same bits, the crows entry K5s's
    bits; each launch counted on K5s's float32 counter alone (the ablation
    entry_conv_stats keeps K4f's kernel)."""
    rng = np.random.default_rng(sum(shape) + C + 31)
    params = _entry_params(rng, C, cuda)
    x = _t(rng.standard_normal(shape), cuda)
    stats = fused_entry_block.entry_block_stats_apply
    counts = (stats.launches, stats.launches_bf16, entry_conv.entry_conv_stats.launches)
    s1, s2 = stats(params, x)
    assert (stats.launches, stats.launches_bf16, entry_conv.entry_conv_stats.launches) == \
        (counts[0] + 1, counts[1], counts[2])
    assert s1.dtype == s2.dtype == torch.float32
    y = entry_conv.entry_conv_forward(params, x)[0]
    yd = y.double()
    for got, want, exact in zip((s1, s2), fused_block.batch_stats(y), (yd.sum(dim=(0, 1, 2)), (yd * yd).sum(dim=(0, 1, 2)))):
        assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()
        assert (got.double() - exact).abs().max().item() <= 1e-5 * exact.abs().max().item()
    again = stats(params, x)
    assert torch.equal(again[0], s1) and torch.equal(again[1], s2)
    assert all(torch.equal(p, q) for p, q in zip(crows_block.crows_stats_apply(params, x), (s1, s2)))


# y of K2s on bfloat16 y: the flagship's three blocks, the scaled
# configuration's three, C = 36 (four channels a thread) at two sizes, (offset
# 4) a y 8- but not 16-byte aligned, four channels a thread at C = 64, and
# (cancel) channel 0 made to sum to under a bfloat16 ulp of its partial sums
STATS_BF16_SHAPES = [((24, 864, 64, 64), 0, False), ((24, 432, 16, 64), 0, False), ((24, 216, 4, 64), 0, False),
                     ((24, 864, 128, 128), 0, False), ((24, 432, 32, 128), 0, False), ((24, 216, 8, 128), 0, False),
                     ((24, 216, 4, 36), 0, False), ((3, 37, 7, 36), 0, False), ((2, 19, 64, 64), 4, False),
                     ((24, 864, 64, 64), 0, True), ((24, 216, 4, 36), 0, True)]


@pytest.mark.parametrize("shape,offset,cancel", STATS_BF16_SHAPES)
def test_k2s_bf16_kernel(cuda, shape, offset, cancel):
    """K2s on bfloat16 y (stats_bf16_kernel): each channel's sums within
    1e-6 relative of the float64 sums of y (where a channel nearly cancels
    too: the kernel carries each float32 add's rounding error) and within
    1e-5 of max of the plain version, a repeat the same bits, one launch
    counted on the bfloat16 counter."""
    gen = torch.Generator(device=cuda).manual_seed(sum(shape) + 41)
    n = int(np.prod(shape))
    y = torch.randn(n + offset, generator=gen, device=cuda).bfloat16()[offset:].view(shape)
    if cancel:  # channel 0 centred, then its last value set to minus the sum of the rest
        col = y.view(-1, shape[-1])
        col[:, 0] = (col[:, 0].double() - col[:, 0].double().mean()).bfloat16()
        col[-1, 0] = -col[:-1, 0].double().sum()
        assert abs(col[:, 0].double().sum().item()) < 1e-5 * col[:, 0].double().abs().sum().item()
    counts = (fused_block.batch_stats.launches, fused_block.batch_stats.launches_bf16)
    s, sq = fused_block.batch_stats(y)
    assert (fused_block.batch_stats.launches, fused_block.batch_stats.launches_bf16) == (counts[0], counts[1] + 1)
    yd = y.double()
    for got, exact in zip((s, sq), (yd.sum(dim=(0, 1, 2)), (yd * yd).sum(dim=(0, 1, 2)))):
        torch.testing.assert_close(got.double(), exact, rtol=1e-6, atol=0)
    del yd
    for got, want in zip((s, sq), fused_block.batch_stats_reference(y)):
        assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    again = fused_block.batch_stats(y)
    assert torch.equal(again[0], s) and torch.equal(again[1], sq)


@pytest.mark.parametrize("layout", ["planes", "crows"])
@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("shape,C", [((2, 98, 64), 16), ((2, 38, 16), 64), ((2, 12, 64), 64), ((24, 864, 64), 64)])
def test_entry_block_bf16(cuda, shape, C, rate, layout):
    """K5f, K5b1, K5b2 in bfloat16 through the autograd Function, in both
    layouts, against the plain versions; bit-equal repeats."""
    rng = np.random.default_rng(sum(shape) + C + 8)
    B, T, Fq = shape
    conv = _entry_params(rng, C, cuda)
    scale, bias, _, _, gw, gb = _block_args(rng, C, cuda)
    x = _t(rng.standard_normal(shape), cuda).bfloat16()
    dout = _t(rng.standard_normal((B, T // 2, Fq // 4, C)), cuda).bfloat16()
    seed = torch.tensor([77 + T])
    fe = fused_entry_block
    s, sq = fe.entry_block_stats_apply(conv, x)
    mean = s / (B * T * Fq)
    var = sq / (B * T * Fq) - mean * mean
    counts = (fe.entry_block_fwd.launches_train_bf16 + fe.entry_block_fwd.launches_eval_bf16,
              fe.entry_block_bwd_reduce.launches_bf16, fe.entry_block_bwd_wgrad.launches_bf16)

    def run():
        leaves = [t.clone().requires_grad_(True) for t in (conv["w"], conv["b"], scale, bias, gw, gb)]
        w, b, sc, bi, w2, b2 = leaves
        out = fe.entry_block_apply({"w": w, "b": b}, sc, bi, mean, var, w2, b2, x, seed, rate, (2, 4), 1e-3, True,
                                   layout=layout)
        out.backward(dout)
        return out.detach(), [t.grad for t in leaves]

    out, grads = run()
    assert (fe.entry_block_fwd.launches_train_bf16 + fe.entry_block_fwd.launches_eval_bf16,
            fe.entry_block_bwd_reduce.launches_bf16, fe.entry_block_bwd_wgrad.launches_bf16) == tuple(c + 1 for c in counts)
    assert out.dtype == torch.bfloat16
    mask = fused_block.dropout_keep_mask(seed, shape + (C,), rate, device=cuda) if rate else None
    keep = 1.0 - rate
    vecs = (conv["w"], conv["b"], scale, bias, mean, var, gw, gb)
    ref = fe.reference_entry_block(x, *vecs, (2, 4), 1e-3, mask, keep, layout)
    y = entry_conv.entry_conv_reference(conv, x)[0]
    _within_ulps(out, ref, "pooled output", _entry_pool_slack(y, scale, bias, mean, var, gw, gb, layout, mask, keep))
    want = fe.entry_block_bwd_reference(x, dout, *vecs, (2, 4), 1e-3, mask, keep, layout)
    red = fe.entry_block_bwd_reduce_reference(x, dout, *vecs, (2, 4), 1e-3, mask, keep)
    a, b2 = fused_block.bwd_coefficients(scale, var, 1e-3, red[2], red[3], B * T * Fq)
    dy = fe._pass2_dy(x, dout, *vecs, a, b2, (2, 4), 1e-3, mask, keep)[0]
    parts = fe.entry_block_bwd_wgrad_parts_reference(x, dout, *vecs, a, b2, (2, 4), 1e-3, mask, keep, layout)
    flip = _ulp(dy.abs().max()).item() * x.float().abs().max().item()
    _parts_rule(grads[0], want[0], parts, "dW", flip)
    # the kernel's own part sums, at the coefficients of its own pass 1
    s1_k, s2_k = fe.entry_block_bwd_reduce(x, dout, *vecs, (2, 4), 1e-3, rate=rate, seed=seed)[2:]
    a_k, b2_k = fused_block.bwd_coefficients(scale, var, 1e-3, s1_k, s2_k, B * T * Fq)
    dw_k, dcb_k, parts_k = fe.entry_block_bwd_wgrad_parts(x, dout, *vecs, a_k, b2_k, (2, 4), 1e-3, rate=rate,
                                                          seed=seed, layout=layout)
    assert torch.equal(dw_k, grads[0]) and torch.equal(dcb_k, grads[1])
    want_k = fe.entry_block_bwd_wgrad_parts_reference(x, dout, *vecs, a_k, b2_k, (2, 4), 1e-3, mask, keep, layout)
    _check_parts(dw_k, parts_k, want_k, f"dW parts ({layout})", flip)
    for name, got, w in zip(("dcb", "dscale", "dbias", "dgw", "dgb"), grads[1:], want[1:]):
        limit = 1e-4 * w.abs().max().item() + (_sum_slack(B * T * Fq, dy, torch.ones(1)) if name == "dcb" else 0.0)
        if name == "dgw":  # one bfloat16 operand of xn^T . dlin rounding the other way
            xn = (y.float() - mean) * torch.rsqrt(var + 1e-3) * scale + bias
            dlin = dout.float().abs().max() / (8 * keep)
            limit += _ulp(xn.abs().max()).item() * dlin.item() + _ulp(dlin).item() * xn.abs().max().item()
        assert (got - w).abs().max().item() <= limit, name
    out2, grads2 = run()
    assert torch.equal(out, out2) and all(torch.equal(p, q) for p, q in zip(grads, grads2))
    if layout == "crows" and crows_block.crows_applicable((*shape, 1), (2, 4)):
        # the crows entry reaches the same kernels with the same mode bits
        ref_out = crows_block.crows_apply(conv, scale, bias, mean, var, gw, gb, x[..., None], seed, rate, (2, 4),
                                          1e-3, True)
        assert torch.equal(ref_out, out)


# K5's bfloat16 passes at their tile edges: a ragged last tile at C = 16, F = 16, whole tiles, C = 96 (padded to 128)
ENTRY_BWD_BF16_SHAPES = [((2, 98, 64), 16), ((2, 38, 16), 64), ((2, 12, 64), 64), ((2, 14, 64), 96)]


@pytest.mark.parametrize("pack", [False, True])
@pytest.mark.parametrize("layout", ["planes", "crows"])
@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("shape,C", ENTRY_BWD_BF16_SHAPES)
def test_entry_bwd_bf16_passes(cuda, shape, C, rate, layout, pack):
    """K5b1 and K5b2 in bfloat16 (entry_block_bwd_reduce_bf16_kernel,
    entry_block_bwd_wgrad_bf16_kernel) called alone, without dropout and
    with either draw (mask modes 1 and 2), against their
    plain versions under chip_smoke.py's bars: pass 1 1e-4 of each output's
    max (d glu_w plus one bfloat16 operand flip); pass 2's dW parts as
    `check_parts` holds them and dW one ulp of itself plus one of each
    part's sum plus one dy flip; d conv_b, zero in exact arithmetic, at
    each side's own pass-1 coefficients, 1e-4 of its max plus the float32
    rounding of its sum; each a bit-equal repeat. Then pass 1 against K4f ->
    K2b's bfloat16 reduce pass without dy_partial with the same seed: the
    same tile code on the same y, summed over other runs of tiles."""
    rng = np.random.default_rng(sum(shape) + C + 15)
    B, T, Fq = shape
    fe = fused_entry_block
    conv = _entry_params(rng, C, cuda)
    scale, bias, _, _, gw, gb = _block_args(rng, C, cuda)
    x = _t(rng.standard_normal(shape), cuda).bfloat16()
    dout = _t(rng.standard_normal((B, T // 2, Fq // 4, C)), cuda).bfloat16()
    seed = torch.tensor([41 + T])
    s, sq = fe.entry_block_stats_apply(conv, x)
    n = B * T * Fq
    mean = s / n
    var = sq / n - mean * mean
    vecs = (conv["w"], conv["b"], scale, bias, mean, var, gw, gb)
    keep = 1.0 - rate
    mask = fused_block.dropout_keep_mask(seed, shape + (C,), rate, device=cuda, pack_bits=pack) if rate else None
    kw = dict(rate=rate, seed=seed, pack_bits=pack)
    packed = int(pack and rate > 0.0)  # at rate 0 neither draw runs
    counts = (fe.entry_block_bwd_reduce.launches_bf16, fe.entry_block_bwd_wgrad.launches_bf16,
              fe.entry_block_bwd_reduce.launches_packed, fe.entry_block_bwd_wgrad.launches_packed)

    red = fe.entry_block_bwd_reduce(x, dout, *vecs, (2, 4), 1e-3, **kw)
    want = fe.entry_block_bwd_reduce_reference(x, dout, *vecs, (2, 4), 1e-3, mask, keep)
    y = entry_conv.entry_conv_reference(conv, x)[0]
    xn = (y.float() - mean) * torch.rsqrt(var + 1e-3) * scale + bias
    dlin = dout.float().abs().max() / (8 * keep)
    for name, got, w in zip(("d glu_w", "d glu_b", "S1", "S2"), red, want):
        limit = 1e-4 * w.abs().max().item()
        if name == "d glu_w":  # one bfloat16 operand of xn^T . dlin rounding the other way
            limit += _ulp(xn.abs().max()).item() * dlin.item() + _ulp(dlin).item() * xn.abs().max().item()
        assert (got - w).abs().max().item() <= limit, name
    assert all(torch.equal(p, q) for p, q in zip(red, fe.entry_block_bwd_reduce(x, dout, *vecs, (2, 4), 1e-3, **kw)))

    a, b2 = fused_block.bwd_coefficients(scale, var, 1e-3, red[2], red[3], n)
    dw, dcb, parts = fe.entry_block_bwd_wgrad_parts(x, dout, *vecs, a, b2, (2, 4), 1e-3, layout=layout, **kw)
    dy = fe._pass2_dy(x, dout, *vecs, a, b2, (2, 4), 1e-3, mask, keep)[0]
    flip = _ulp(dy.abs().max()).item() * x.float().abs().max().item()
    want_parts = fe.entry_block_bwd_wgrad_parts_reference(x, dout, *vecs, a, b2, (2, 4), 1e-3, mask, keep, layout)
    _check_parts(dw, parts, want_parts, f"dW parts ({layout})", flip)
    dw_ref = fe.entry_block_bwd_wgrad_reference(x, dout, *vecs, a, b2, (2, 4), 1e-3, mask, keep, layout)[0]
    _parts_rule(dw, dw_ref, want_parts, "dW", flip)
    # d conv_b is zero in exact arithmetic (a holds S1): each side at its own
    # pass 1's coefficients, held to the float32 rounding of its sum
    a_p, b2_p = fused_block.bwd_coefficients(scale, var, 1e-3, want[2], want[3], n)
    dcb_ref = fe.entry_block_bwd_wgrad_reference(x, dout, *vecs, a_p, b2_p, (2, 4), 1e-3, mask, keep, layout)[1]
    limit = 1e-4 * dcb_ref.abs().max().item() + _sum_slack(n, dy, torch.ones(1))
    assert (dcb - dcb_ref).abs().max().item() <= limit, "d conv_b"
    again = fe.entry_block_bwd_wgrad(x, dout, *vecs, a, b2, (2, 4), 1e-3, layout=layout, **kw)
    assert torch.equal(again[0], dw) and torch.equal(again[1], dcb)
    assert (fe.entry_block_bwd_reduce.launches_bf16, fe.entry_block_bwd_wgrad.launches_bf16,
            fe.entry_block_bwd_reduce.launches_packed, fe.entry_block_bwd_wgrad.launches_packed) == \
        (counts[0] + 2, counts[1] + 2, counts[2] + 2 * packed, counts[3] + 2 * packed)

    # pass 1 against K4f -> K2b reduce bfloat16 without dy_partial, same seed and draw
    y_k = entry_conv.entry_conv_forward(conv, x)[0]
    pair = fused_block.bwd_reduce(y_k, dout, scale, bias, mean, var, gw, gb, (2, 4), 1e-3, recompute=True, **kw)[1:]
    same = all(torch.equal(p, q) for p, q in zip(red, pair))
    worst = max((p - q).abs().max().item() / max(q.abs().max().item(), 1e-30) for p, q in zip(red, pair))
    print(f"K5b1 bf16 {shape} C={C} rate {rate} {'packed' if pack else '32-bit'}: against K4f -> K2b reduce "
          f"{'bit-equal' if same else f'largest difference {worst:.3e} of max'}")
    assert worst <= 1e-4


# K5b1 in float32 and K5f in bfloat16 at their tile edges, as x [B, T, F], C and the pool: a ragged last tile
# (T not a multiple of the tile's rows) at F = 16 and F = 1, F = 128 (one row a tile), C = 20 and 36 (padded to
# 64), 96 (padded to 128), 128 with one dout buffer (pool (2, 2)) and with dout read from device memory (pool
# (1, 1)), and the flagship block-1 shape. C = 18 is not a width the fused block admits (C % 4 == 0).
K5_EDGES = [((2, 38, 16), 16, (2, 4)), ((1, 150, 1), 20, (2, 1)), ((2, 38, 16), 36, (2, 4)), ((1, 9, 128), 64, (1, 4)),
            ((2, 12, 64), 96, (2, 4)), ((1, 14, 32), 128, (2, 2)), ((1, 10, 8), 128, (1, 1)),
            ((24, 864, 64), 64, (2, 4))]


def _k5_inputs(rng, shape, C, pool, cuda, dtype):
    """x [B, T, F] in `dtype`, the conv, the batch statistics of its output,
    the block's parameters and dout [B, T/pt, F/pf, C] in `dtype`."""
    B, T, Fq = shape
    conv = _entry_params(rng, C, cuda)
    scale, bias, _, _, gw, gb = _block_args(rng, C, cuda)
    x = _t(rng.standard_normal(shape), cuda).to(dtype)
    dout = _t(rng.standard_normal((B, T // pool[0], Fq // pool[1], C)), cuda).to(dtype)
    s, sq = fused_entry_block.entry_block_stats_apply(conv, x)
    n = B * T * Fq
    mean = s / n
    var = sq / n - mean * mean
    return x, dout, conv, (conv["w"], conv["b"], scale, bias, mean, var, gw, gb)


@pytest.mark.parametrize("rate,pack", [(0.0, False), (0.5, False), (0.5, True)])
@pytest.mark.parametrize("shape,C,pool", K5_EDGES)
def test_entry_reduce_f32_pass(cuda, shape, C, pool, rate, pack):
    """K5b1 in float32 (entry_block_bwd_reduce_f32_kernel: K2b's float32
    reduce pass on a conv tile) against its plain version, 1e-4 of each
    output's max, with either draw, and a bit-equal repeat; then against K4f
    -> K2b's float32 reduce pass without dy_partial with the same seed and
    draw: the same tile code on the same y, summed into K2b's slots, so bit
    for bit."""
    rng = np.random.default_rng(sum(shape) + C + 21)
    fe = fused_entry_block
    x, dout, conv, vecs = _k5_inputs(rng, shape, C, pool, cuda, torch.float32)
    seed = torch.tensor([53 + shape[1]])
    kw = dict(rate=rate, seed=seed, pack_bits=pack)
    before = (fe.entry_block_bwd_reduce.launches, fe.entry_block_bwd_reduce.launches_packed)
    red = fe.entry_block_bwd_reduce(x, dout, *vecs, pool, 1e-3, **kw)
    assert (fe.entry_block_bwd_reduce.launches, fe.entry_block_bwd_reduce.launches_packed) == \
        (before[0] + 1, before[1] + int(pack and rate > 0.0))
    mask = fused_block.dropout_keep_mask(seed, shape + (C,), rate, device=cuda, pack_bits=pack) if rate else None
    want = fe.entry_block_bwd_reduce_reference(x, dout, *vecs, pool, 1e-3, mask, 1.0 - rate)
    for name, got, w in zip(("d glu_w", "d glu_b", "S1", "S2"), red, want):
        assert (got - w).abs().max().item() <= 1e-4 * w.abs().max().item(), name
    assert all(torch.equal(p, q) for p, q in zip(red, fe.entry_block_bwd_reduce(x, dout, *vecs, pool, 1e-3, **kw)))

    y = entry_conv.entry_conv_forward(conv, x)[0]
    pair = fused_block.bwd_reduce(y, dout, *vecs[2:], pool, 1e-3, recompute=True, **kw)[1:]
    worst = max((p - q).abs().max().item() / max(q.abs().max().item(), 1e-30) for p, q in zip(red, pair))
    assert all(torch.equal(p, q) for p, q in zip(red, pair)), f"against K4f -> K2b reduce: {worst:.3e} of max"


@pytest.mark.parametrize("rate,pack", [(0.0, False), (0.5, False), (0.5, True)])
@pytest.mark.parametrize("shape,C,pool", K5_EDGES)
def test_entry_fwd_bf16_kernel(cuda, shape, C, pool, rate, pack):
    """K5f in bfloat16 (entry_block_fwd_bf16_kernel: K2f's bfloat16 forward
    on a conv tile), planes layout: bit for bit K4f -> K2f in bfloat16 with
    the same seed and draw (y is the same bfloat16 value, and neither the
    product per pixel nor the pool window depends on the tiling), and within
    one ulp plus the stated slack of the plain version; the crows layout
    (every g rounded before the window sum) against its plain version under
    the same bars; bit-equal repeats and the launches counted."""
    rng = np.random.default_rng(sum(shape) + C + 22)
    fe = fused_entry_block
    x, _, conv, vecs = _k5_inputs(rng, shape, C, pool, cuda, torch.bfloat16)
    seed = torch.tensor([61 + shape[1]])
    kw = dict(rate=rate, seed=seed, pack_bits=pack)
    fn = fe.entry_block_fwd
    counter = "launches_train_bf16" if rate > 0.0 else "launches_eval_bf16"
    before = getattr(fn, counter)
    out = fn(x, *vecs, pool, 1e-3, **kw)
    assert getattr(fn, counter) == before + 1 and out.dtype == torch.bfloat16
    y = entry_conv.entry_conv_forward(conv, x)[0]
    pair = fused_block.fused_bn_glu_pool(y, *vecs[2:], pool, 1e-3, **kw)
    assert torch.equal(out, pair), f"K5f bf16 against K4f -> K2f bf16: {(out.float() - pair.float()).abs().max().item()}"
    mask = fused_block.dropout_keep_mask(seed, shape + (C,), rate, device=cuda, pack_bits=pack) if rate else None
    keep = 1.0 - rate
    y_ref = entry_conv.entry_conv_reference(conv, x)[0]
    for layout in ("planes", "crows"):
        got = out if layout == "planes" else fn(x, *vecs, pool, 1e-3, layout=layout, **kw)
        ref = fe.reference_entry_block(x, *vecs, pool, 1e-3, mask, keep, layout)
        _within_ulps(got, ref, f"pooled output ({layout})",
                     _entry_pool_slack(y_ref, *vecs[2:], layout, mask, keep, pool))
        assert torch.equal(got, fn(x, *vecs, pool, 1e-3, layout=layout, **kw)), layout


@pytest.mark.parametrize("rate,pack", [(0.0, False), (0.5, False), (0.5, True)])
@pytest.mark.parametrize("shape,C,pool", K5_EDGES)
def test_entry_fwd_f32_kernel(cuda, shape, C, pool, rate, pack):
    """K5f in float32 (entry_block_fwd_f32_kernel: K2f's float32 forward on a
    conv tile): bit for bit K4f -> K2f in float32 with the same seed and draw
    (y - mean is the same float value, and neither the product per pixel nor
    the pool window depends on the tiling); within 1e-5 of the plain version;
    a bit-equal repeat and the launch counted."""
    rng = np.random.default_rng(sum(shape) + C + 23)
    fe = fused_entry_block
    x, _, conv, vecs = _k5_inputs(rng, shape, C, pool, cuda, torch.float32)
    seed = torch.tensor([67 + shape[1]])
    kw = dict(rate=rate, seed=seed, pack_bits=pack)
    fn = fe.entry_block_fwd
    counter = "launches_train" if rate > 0.0 else "launches_eval"
    before = getattr(fn, counter)
    out = fn(x, *vecs, pool, 1e-3, **kw)
    assert getattr(fn, counter) == before + 1
    y = entry_conv.entry_conv_forward(conv, x)[0]
    pair = fused_block.fused_bn_glu_pool(y, *vecs[2:], pool, 1e-3, **kw)
    assert torch.equal(out, pair), f"K5f float32 against K4f -> K2f float32: {(out - pair).abs().max().item()}"
    mask = fused_block.dropout_keep_mask(seed, shape + (C,), rate, device=cuda, pack_bits=pack) if rate else None
    ref = fe.reference_entry_block(x, *vecs, pool, 1e-3, mask, 1.0 - rate)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
    assert torch.equal(out, fn(x, *vecs, pool, 1e-3, **kw))


@pytest.mark.parametrize("rate,pack", [(0.0, False), (0.5, False), (0.5, True)])
@pytest.mark.parametrize("shape,C,pool", K5_EDGES)
def test_entry_wgrad_f32_pass(cuda, shape, C, pool, rate, pack):
    """K5b2 in float32 (entry_block_bwd_wgrad_f32_kernel: the recompute
    fixup's float32 tile code on a conv tile, then dW from the dy tile), a
    and b2 from K5b1: against K4f -> the float32 recompute fixup (dy) -> K4w
    in float32 (dW, d conv_b) with the same seed and draw, the same dy summed
    in another order: dW within 1e-6 of its max, d conv_b (a gauge leaf, zero
    in exact arithmetic) within 1e-6 of its max plus 1e-6 of dW's; against
    the formulas in float64 within 1e-4 of max (d conv_b with the same
    floor); a bit-equal repeat and the launch counted."""
    rng = np.random.default_rng(sum(shape) + C + 24)
    fe = fused_entry_block
    x, dout, conv, vecs = _k5_inputs(rng, shape, C, pool, cuda, torch.float32)
    seed = torch.tensor([71 + shape[1]])
    kw = dict(rate=rate, seed=seed, pack_bits=pack)
    red = fe.entry_block_bwd_reduce(x, dout, *vecs, pool, 1e-3, **kw)
    a, b2 = fused_block.bwd_coefficients(vecs[2], vecs[5], 1e-3, red[2], red[3], x.numel())
    fn = fe.entry_block_bwd_wgrad
    before = (fn.launches, fn.launches_packed)
    dw, dcb = fn(x, dout, *vecs, a, b2, pool, 1e-3, **kw)
    assert (fn.launches, fn.launches_packed) == (before[0] + 1, before[1] + int(pack and rate > 0.0))
    y = entry_conv.entry_conv_forward(conv, x)[0]
    dy = fused_block.bwd_fixup_recompute(y, dout, *vecs[2:], a, b2, pool, 1e-3, **kw)
    del y
    want = entry_conv.entry_conv_wgrad(x, dy)
    del dy
    floor = 1e-6 * want[0].abs().max().item()
    for name, got, w, extra in (("dW", dw, want[0], 0.0), ("d conv_b", dcb, want[1], floor)):
        err = (got - w).abs().max().item()
        assert err <= 1e-6 * w.abs().max().item() + extra, f"{name} against K4f -> fixup -> K4w: {err}"
    mask = fused_block.dropout_keep_mask(seed, shape + (C,), rate, device=cuda, pack_bits=pack) if rate else None
    dbl = [t.double() for t in (x, dout, *vecs, a, b2)]
    ref = fe.entry_block_bwd_wgrad_reference(*dbl, pool, 1e-3, None if mask is None else mask.double(), 1.0 - rate)
    for name, got, w, extra in (("dW", dw, ref[0], 0.0), ("d conv_b", dcb, ref[1], floor)):
        assert (got.double() - w).abs().max().item() <= 1e-4 * w.abs().max().item() + extra, name
    again = fn(x, dout, *vecs, a, b2, pool, 1e-3, **kw)
    assert torch.equal(again[0], dw) and torch.equal(again[1], dcb)


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("B,T", [(2, 38), (24, 864)])
def test_crows_float32_equals_the_fused_entry_block(cuda, B, T, rate):
    """K6 in float32 through ops/crows_block.py (F = 64, pool (2, 4), an even
    batch) launches K5's float32 kernels with no mode bit: its output and
    all six gradients are K5's bits, through the autograd Functions."""
    rng = np.random.default_rng(B + T + int(10 * rate))
    C, Fq = 64, 64
    conv = _entry_params(rng, C, cuda)
    scale, bias, _, _, gw, gb = _block_args(rng, C, cuda)
    x = _t(rng.standard_normal((B, T, Fq, 1)), cuda)
    dout = _t(rng.standard_normal((B, T // 2, Fq // 4, C)), cuda)
    s, sq = fused_entry_block.entry_block_stats_apply(conv, x)
    mean = s / (B * T * Fq)
    var = sq / (B * T * Fq) - mean * mean

    def run(apply):
        leaves = [t.clone().requires_grad_(True) for t in (conv["w"], conv["b"], scale, bias, gw, gb)]
        w, b, sc, bi, w2, b2 = leaves
        out = apply({"w": w, "b": b}, sc, bi, mean, var, w2, b2, x, 9, rate, (2, 4), 1e-3, True)
        out.backward(dout)
        return [out.detach()] + [t.grad for t in leaves]

    names = ("out", "dW", "d conv_b", "d scale", "d bias", "d glu_w", "d glu_b")
    for name, k6, k5 in zip(names, run(crows_block.crows_apply), run(fused_entry_block.entry_block_apply)):
        assert torch.equal(k6, k5), name


@pytest.mark.parametrize("flag", [None, "entry_conv_pallas", "entry_block_pallas", "entry_block_crows"])
def test_flagship_bf16_train_step_repeats_a_cpu_step(cuda, flag):
    """One Mean-Teacher step of a bfloat16 model with the flagship's widths
    (64 mels, 64 channels) at 96 frames, on the card and on the CPU: metrics
    1e-4, gradient leaves 2e-2 of their max plus 1e-6 of the largest, gauge
    leaves 1e-3 of the largest (bfloat16 roundings that flip between two
    float32 sums in another order). Under the crows flag block 1's conv
    weight is a gauge leaf too: its two batch-half sums, each rounded to
    bfloat16 as the original rounds them, nearly cancel (the features' mean
    times each half's Σdy, which the other half's takes back), so one
    rounding of a half flipping is large against their sum."""
    import copy

    from dcase2019_task4_tpu_torch.config import ModelConfig
    from dcase2019_task4_tpu_torch.train import steps

    cfg = ModelConfig(nb_filters=(64, 64, 64), n_rnn_cell=16, compute_dtype="bfloat16", **({flag: True} if flag else {}))
    base = steps.init_train_state(cfg, lambda p: torch.optim.Adam(p, lr=1e-3), torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    audio = (0.1 * torch.randn(4, 95 * 511 + 2048, generator=g) * 32768).clamp(-32768, 32767).to(torch.int16)
    batch = {"audio": audio, "frames": torch.full((4,), 96), "target": (torch.rand(4, 12, 10, generator=g) > 0.8).float()}
    results = []
    for device in (torch.device("cpu"), cuda):
        state = steps.TrainState(copy.deepcopy(base.student).to(device), copy.deepcopy(base.teacher).to(device), None)
        state.optimizer = torch.optim.Adam(state.student.parameters(), lr=1e-3)
        step = steps.make_train_step(slice(0, 1), slice(3, 4), rampup_length=10,
                                     frontend=MelFrontend(max_frames=96, device=device))
        _, metrics, _ = step(state, {k: v.to(device) for k, v in batch.items()},
                             torch.Generator().manual_seed(2), step.zero_metrics(device))
        results.append(({k: v.item() for k, v in metrics.items()},
                        {n: p.grad.cpu() for n, p in state.student.named_parameters()}))
    (m_cpu, g_cpu), (m_gpu, g_gpu) = results
    for k in m_cpu:
        assert abs(m_cpu[k] - m_gpu[k]) <= 1e-4, k
    top = max(a.abs().max().item() for a in g_cpu.values())
    for name, a in g_cpu.items():
        gauge = name.endswith(".conv.bias") or name.startswith("dense_softmax.") or (
            flag == "entry_block_crows" and name == "cnn.0.conv.weight")
        limit = 2e-2 * a.abs().max().item() + (1e-3 if gauge else 1e-6) * top
        assert (a - g_gpu[name]).abs().max().item() <= limit, name


# ------------------------------------------- the knobs: onedot K1, recompute
# fixup, packed dropout (DCASE_FUSED_MEL_ONEDOT, DCASE_FUSED_BWD_RECOMPUTE,
# DCASE_DROPOUT_PACK), each against its plain version


@pytest.mark.parametrize("n_fft,n_mels", [(64, 8), (512, 64), (2048, 64), (2048, 128), (4096, 64)])
@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("frames", [96, 37])  # 37: a partial last tile
def test_fused_stft_mel_onedot(cuda, dtype, frames, n_fft, n_mels):
    fe = MelFrontend(n_window=n_fft, hop_length=HOPS[n_fft], n_mels=n_mels, max_frames=frames, device=cuda,
                     onedot=True)
    rng = np.random.default_rng(n_fft + frames)
    audio = _t(0.2 * rng.standard_normal((3, (frames - 1) * HOPS[n_fft] + n_fft)), cuda)
    if dtype == "int16":
        audio = torch.clamp(torch.round(audio * 32768.0), -32768, 32767).to(torch.int16)
    chunks = fe._hop_chunks(audio)
    kw = dict(n_fft=n_fft, hop=HOPS[n_fft], T=frames)
    before = (fused_mel.fused_stft_mel_onedot.launches, fused_mel.fused_stft_mel.launches)
    out = fused_mel.fused_stft_mel_onedot(chunks, fe.onedot_bases(), **kw)
    assert (fused_mel.fused_stft_mel_onedot.launches, fused_mel.fused_stft_mel.launches) == (before[0] + 1, before[1])
    ref = fused_mel.fused_stft_mel_onedot_reference(chunks, fe.onedot_bases(), **kw)
    assert out.shape == ref.shape == (3, frames, n_mels)
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    # the frontend built with onedot launches it, and K1's FFT kernel not
    mel = fe.linear_mel(audio)
    assert (fused_mel.fused_stft_mel_onedot.launches, fused_mel.fused_stft_mel.launches) == (before[0] + 2, before[1])
    assert torch.equal(mel, out)


# the onedot kernel's tiles at the flagship geometry (n_fft 2048, hop 511) with 64 mels and the scaled
# frontend's 128: frame counts off the 128-frame tile, one clip, the full 864 frames
@pytest.mark.parametrize("n_mels", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("clips,frames", [(1, 200), (2, 129), (1, 864)])
def test_fused_stft_mel_onedot_tiles(cuda, dtype, clips, frames, n_mels):
    """Within 1e-5 of max of the plain version and of a float64 DFT of the
    same frames, and a second call the same bits."""
    fe = MelFrontend(n_mels=n_mels, max_frames=frames, device=cuda, onedot=True)
    rng = np.random.default_rng(frames + n_mels)
    audio = _t(0.2 * rng.standard_normal((clips, (frames - 1) * 511 + 2048)), cuda)
    if dtype == "int16":
        audio = torch.clamp(torch.round(audio * 32768.0), -32768, 32767).to(torch.int16)
    chunks = fe._hop_chunks(audio)
    kw = dict(n_fft=2048, hop=511, T=frames)
    out = fused_mel.fused_stft_mel_onedot(chunks, fe.onedot_bases(), **kw)
    assert torch.equal(fused_mel.fused_stft_mel_onedot(chunks, fe.onedot_bases(), **kw), out)
    ref = fused_mel.fused_stft_mel_onedot_reference(chunks, fe.onedot_bases(), **kw)
    assert out.shape == ref.shape == (clips, frames, n_mels)
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    nb = fe.mel_fb.shape[0]
    frames64 = fused_mel._dequantize(chunks).double().reshape(clips, -1).unfold(1, 2048, 511)[:, :frames]
    exact = torch.fft.rfft(frames64 * fe.window.double(), dim=-1)[..., :nb].abs() @ fe.mel_fb.double()
    assert (out.double() - exact).abs().max().item() <= 1e-5 * exact.abs().max().item()


def _fixup_inputs(rng, shape, pool, cuda, dtype):
    C = shape[-1]
    y = _t(rng.standard_normal(shape), cuda).to(dtype)
    scale, bias, _, _, w, b = _block_args(rng, C, cuda)
    s, sq = fused_block.batch_stats(y)
    n = y.numel() // C
    mean, var = s / n, sq / n - (s / n) ** 2
    dout = _t(rng.standard_normal((shape[0], shape[1] // pool[0], shape[2] // pool[1], C)), cuda).to(dtype)
    return y, dout, (scale, bias, mean, var, w, b)


# the recompute fixups' tiles beyond TRAIN_SHAPES at pool (2, 4): C = 20 and 100 (padded channels), C = 128 and F =
# 128 (window tiles of 2 x 64), pools (2, 2) and (2, 8), ragged last tiles (T = 10 of 4-row tiles, 38 of 8)
FIXUP_EDGES = [((1, 14, 16, 20), (2, 4)), ((2, 10, 24, 100), (2, 4)), ((1, 6, 128, 128), (2, 4)),
               ((1, 6, 128, 64), (2, 4)), ((2, 12, 32, 64), (2, 2)), ((1, 8, 32, 128), (2, 2)),
               ((1, 10, 64, 128), (2, 8)), ((2, 38, 16, 64), (2, 8))]


@pytest.mark.parametrize("pack", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("shape,pool", [(s, (2, 4)) for s in TRAIN_SHAPES] + FIXUP_EDGES)
def test_bwd_fixup_recompute_float32(cuda, shape, pool, rate, pack):
    """K2b without dy_partial: both passes against the plain versions (1e-4
    of max), the fixup on an unaligned y and dout bit-equal to its aligned
    run, and the autograd Function with the mode on against itself with it
    off (dy within 1e-6 of max; the other gradients bit for bit: the same
    first-pass kernel)."""
    rng = np.random.default_rng(sum(shape) + 7)
    y, dout, vecs = _fixup_inputs(rng, shape, pool, cuda, torch.float32)
    seed = torch.tensor([31 + shape[1]])
    fb = fused_block
    kw = dict(rate=rate, seed=seed, pack_bits=pack)
    before = (fb.bwd_reduce.launches, fb.bwd_reduce.launches_nodyp, fb.bwd_fixup_recompute.launches,
              fb.bwd_reduce.launches_packed, fb.bwd_fixup_recompute.launches_packed)
    dyp, dw, db, s1, s2 = fb.bwd_reduce(y, dout, *vecs, pool, 1e-3, recompute=True, **kw)
    assert dyp is None
    a, b2 = fb.bwd_coefficients(vecs[0], vecs[3], 1e-3, s1, s2, y.numel() // shape[-1])
    dy = fb.bwd_fixup_recompute(y, dout, *vecs, a, b2, pool, 1e-3, **kw)
    packed = int(pack and rate > 0)
    assert (fb.bwd_reduce.launches, fb.bwd_reduce.launches_nodyp, fb.bwd_fixup_recompute.launches,
            fb.bwd_reduce.launches_packed, fb.bwd_fixup_recompute.launches_packed) == (
        before[0], before[1] + 1, before[2] + 1, before[3] + packed, before[4] + packed)
    mask = fb.dropout_keep_mask(seed, shape, rate, device=cuda, pack_bits=pack) if rate else None
    want = fb.bwd_fixup_recompute_reference(y, dout, *vecs, a, b2, pool, 1e-3, mask, 1.0 - rate)
    assert (dy - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    assert torch.equal(fb.bwd_fixup_recompute(_unaligned(y), _unaligned(dout), *vecs, a, b2, pool, 1e-3, **kw), dy)
    ref = fb.bwd_reduce_reference(y, dout, *vecs, pool, 1e-3, mask, 1.0 - rate)
    for name, got, w in zip(("dw", "db", "S1", "S2"), (dw, db, s1, s2), ref[1:]):
        assert (got - w).abs().max().item() <= 1e-4 * w.abs().max().item(), name

    def run(recompute):
        leaves = [t.clone().requires_grad_(True) for t in (y, vecs[0], vecs[1], vecs[4], vecs[5])]
        fb.fused_bn_glu_dropout_pool(leaves[0], leaves[1], leaves[2], vecs[2], vecs[3], leaves[3], leaves[4], seed,
                                     rate, pool, 1e-3, True, pack_bits=pack, recompute=recompute).backward(dout)
        return [t.grad for t in leaves]

    on, off = run(True), run(False)
    assert (on[0] - off[0]).abs().max().item() <= 1e-6 * off[0].abs().max().item()
    assert all(torch.equal(p, q) for p, q in zip(on[1:], off[1:]))
    assert all(torch.equal(p, q) for p, q in zip(on, run(True)))  # a repeat: the same bits


@pytest.mark.parametrize("shape,pool", [((2, 8, 64, 64), (2, 4)), ((1, 10, 64, 128), (2, 8)), ((1, 14, 16, 20), (2, 4))])
def test_bwd_fixup_recompute_float32_channel_offset(cuda, shape, pool):
    """The float32 recompute fixup where y lies 20 ± 3 std from 0 per channel
    and BN's mean and var are y's own, with and without the packed draw: dy
    within the same 1e-4 of max (dy carries (y - mean) b2; the kernel forms y
    - mean as the plain version does)."""
    rng = np.random.default_rng(sum(shape) + 20)
    C = shape[-1]
    yn = 20.0 + 3.0 * rng.standard_normal(shape) * rng.uniform(0.5, 2.0, C)
    y = _t(yn, cuda)
    scale, bias, _, _, w, b = _block_args(rng, C, cuda)
    vecs = (scale, bias, _t(yn.mean(axis=(0, 1, 2)), cuda), _t(yn.var(axis=(0, 1, 2)), cuda), w, b)
    dout = _t(rng.standard_normal((shape[0], shape[1] // pool[0], shape[2] // pool[1], C)), cuda)
    seed, fb = torch.tensor([2020 + shape[1]]), fused_block
    for rate, pack in ((0.0, False), (0.5, True)):
        kw = dict(rate=rate, seed=seed, pack_bits=pack)
        _, _, _, s1, s2 = fb.bwd_reduce(y, dout, *vecs, pool, 1e-3, recompute=True, **kw)
        a, b2 = fb.bwd_coefficients(vecs[0], vecs[3], 1e-3, s1, s2, y.numel() // C)
        dy = fb.bwd_fixup_recompute(y, dout, *vecs, a, b2, pool, 1e-3, **kw)
        mask = fb.dropout_keep_mask(seed, shape, rate, device=cuda, pack_bits=pack) if rate else None
        want = fb.bwd_fixup_recompute_reference(y, dout, *vecs, a, b2, pool, 1e-3, mask, 1.0 - rate)
        assert (dy - want).abs().max().item() <= 1e-4 * want.abs().max().item(), rate


@pytest.mark.parametrize("rate,pack", [(0.0, False), (0.5, False), (0.5, True)])
@pytest.mark.parametrize("shape,pool", BF16_BLOCKS + [((2, 38, 16, 64), (2, 4)), ((2, 12, 32, 64), (2, 2)),
                                                      ((1, 8, 32, 128), (2, 2))])
def test_bwd_fixup_recompute_bf16(cuda, shape, pool, rate, pack):
    """The bfloat16 recompute fixup against its plain version: dy within one
    ulp plus the slack of dxn's two channel products (at most 1e-3 of the
    elements beyond one ulp), rounded once; a repeat, and a run on an
    unaligned y and dout (staged by loads, stored two bytes at a time), the
    same bits."""
    rng = np.random.default_rng(sum(shape) + 8)
    y, dout, vecs = _fixup_inputs(rng, shape, pool, cuda, torch.bfloat16)
    seed = torch.tensor([57])
    fb = fused_block
    kw = dict(rate=rate, seed=seed, pack_bits=pack)
    before = (fb.bwd_reduce.launches_nodyp_bf16, fb.bwd_fixup_recompute.launches_bf16)
    _, dw, db, s1, s2 = fb.bwd_reduce(y, dout, *vecs, pool, 1e-3, recompute=True, **kw)
    a, b2 = fb.bwd_coefficients(vecs[0], vecs[3], 1e-3, s1, s2, y.numel() // shape[-1])
    dy = fb.bwd_fixup_recompute(y, dout, *vecs, a, b2, pool, 1e-3, **kw)
    assert (fb.bwd_reduce.launches_nodyp_bf16, fb.bwd_fixup_recompute.launches_bf16) == (before[0] + 1, before[1] + 1)
    assert dy.dtype == torch.bfloat16
    mask = fb.dropout_keep_mask(seed, shape, rate, device=cuda, pack_bits=pack) if rate else None
    want = fb.bwd_fixup_recompute_reference(y, dout, *vecs, a, b2, pool, 1e-3, mask, 1.0 - rate)
    slack = _dyp_slack(y, dout, vecs[0], vecs[1], vecs[2], vecs[3], vecs[4], pool, 1.0 - rate)
    _within_ulps(dy, want, "dy", slack + 2.0 ** -20 * want.float().abs().max())
    assert torch.equal(dy, fb.bwd_fixup_recompute(y, dout, *vecs, a, b2, pool, 1e-3, **kw))
    assert torch.equal(dy, fb.bwd_fixup_recompute(_unaligned(y), _unaligned(dout), *vecs, a, b2, pool, 1e-3, **kw))


@pytest.mark.parametrize("rate", [0.5, 0.3])
@pytest.mark.parametrize("shape", [(2, 6, 8, 16), (777,), (3, 38, 16, 64), (4, 512, 128)])
def test_packed_dropout_mask_kernel_is_bit_equal_to_the_plain_mask(cuda, shape, rate):
    seed = torch.tensor([2020 + len(shape)])
    before = (fused_block.dropout_mask.launches, fused_block.dropout_mask.launches_packed)
    got = fused_block.dropout_mask(seed, shape, rate, cuda, pack_bits=True)
    assert (fused_block.dropout_mask.launches, fused_block.dropout_mask.launches_packed) == (before[0] + 1,
                                                                                             before[1] + 1)
    assert torch.equal(got, fused_block.dropout_keep_mask(seed, shape, rate, device=cuda, pack_bits=True))
    assert torch.equal(got.cpu(), fused_block.dropout_keep_mask(seed, shape, rate, pack_bits=True))
    assert not torch.equal(got, fused_block.dropout_mask(seed, shape, rate, cuda, pack_bits=False))
    n = got.numel()
    if n >= 100_000:
        p = 1.0 - fused_block.dropout_threshold(rate, True) / 256.0
        assert abs(got.mean().item() - p) < 5.0 * np.sqrt(p * (1 - p) / n)


@pytest.mark.parametrize("shape", TRAIN_SHAPES)
def test_fused_block_with_the_packed_mask(cuda, shape):
    """K2f and both backward passes with the packed draw against the plain
    versions with the packed mask injected."""
    rng = np.random.default_rng(sum(shape) + 9)
    y, dout, vecs = _fixup_inputs(rng, shape, (2, 4), cuda, torch.float32)
    seed, rate = torch.tensor([123 + shape[1]]), 0.3
    fb = fused_block
    mask = fb.dropout_keep_mask(seed, shape, rate, device=cuda, pack_bits=True)
    before = (fb.fused_bn_glu_pool.launches_packed, fb.bwd_reduce.launches_packed)
    out = fb.fused_bn_glu_pool(y, *vecs, (2, 4), 1e-3, rate=rate, seed=seed, pack_bits=True)
    torch.testing.assert_close(out, fb.reference_block(y, *vecs, (2, 4), 1e-3, mask, 1.0 - rate), rtol=0, atol=1e-5)
    leaves = [t.clone().requires_grad_(True) for t in (y, vecs[0], vecs[1], vecs[4], vecs[5])]
    fb.fused_bn_glu_dropout_pool(leaves[0], leaves[1], leaves[2], vecs[2], vecs[3], leaves[3], leaves[4], seed, rate,
                                 (2, 4), 1e-3, True, pack_bits=True).backward(dout)
    assert (fb.fused_bn_glu_pool.launches_packed, fb.bwd_reduce.launches_packed) == (before[0] + 2, before[1] + 1)
    ref = fb.bwd_reference(y, dout, *vecs, (2, 4), 1e-3, mask, 1.0 - rate)
    for name, leaf, w in zip(("dy", "dscale", "dbias", "dw", "db"), leaves, ref):
        assert (leaf.grad - w).abs().max().item() <= 1e-4 * w.abs().max().item(), name


@pytest.mark.parametrize("shape,C", [((2, 98, 64), 16), ((2, 38, 16), 64), ((24, 864, 64), 64)])
def test_entry_block_with_the_packed_mask(cuda, shape, C):
    """K5f, K5b1 and K5b2 with the packed draw against the plain versions
    with the packed mask, and K5f against conv2d → K2f with the same seed
    and draw."""
    rng = np.random.default_rng(sum(shape) + C + 2)
    B, T, Fq = shape
    conv = _entry_params(rng, C, cuda)
    scale, bias, _, _, gw, gb = _block_args(rng, C, cuda)
    x = _t(rng.standard_normal(shape), cuda)
    dout = _t(rng.standard_normal((B, T // 2, Fq // 4, C)), cuda)
    seed, rate = torch.tensor([77 + T]), 0.5
    fe = fused_entry_block
    s, sq = fe.entry_block_stats_apply(conv, x)
    mean = s / (B * T * Fq)
    var = sq / (B * T * Fq) - mean * mean
    mask = fused_block.dropout_keep_mask(seed, shape + (C,), rate, device=cuda, pack_bits=True)
    block = (conv["w"], conv["b"], scale, bias, mean, var, gw, gb)
    before = (fe.entry_block_fwd.launches_packed, fe.entry_block_bwd_reduce.launches_packed,
              fe.entry_block_bwd_wgrad.launches_packed)
    out = fe.entry_block_fwd(x, *block, (2, 4), 1e-3, rate=rate, seed=seed, pack_bits=True)
    torch.testing.assert_close(out, fe.reference_entry_block(x, *block, (2, 4), 1e-3, mask, 1.0 - rate), rtol=0,
                               atol=1e-5)
    y = entry_conv.entry_conv_reference(conv, x)[0]
    pair = fused_block.fused_bn_glu_pool(y, scale, bias, mean, var, gw, gb, (2, 4), 1e-3, rate=rate, seed=seed,
                                         pack_bits=True)
    torch.testing.assert_close(out, pair, rtol=0, atol=1e-5)
    got = fe.entry_block_bwd_reduce(x, dout, *block, (2, 4), 1e-3, rate=rate, seed=seed, pack_bits=True)
    want = fe.entry_block_bwd_reduce_reference(x, dout, *block, (2, 4), 1e-3, mask, 1.0 - rate)
    for name, g, w in zip(("dgw", "dgb", "S1", "S2"), got, want):
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item(), name
    a, b2 = fused_block.bwd_coefficients(scale, var, 1e-3, got[2], got[3], B * T * Fq)
    dw, _ = fe.entry_block_bwd_wgrad(x, dout, *block, a, b2, (2, 4), 1e-3, rate=rate, seed=seed, pack_bits=True)
    dw_ref, _ = fe.entry_block_bwd_wgrad_reference(x, dout, *block, a, b2, (2, 4), 1e-3, mask, 1.0 - rate)
    assert (dw - dw_ref).abs().max().item() <= 1e-4 * dw_ref.abs().max().item()
    assert (fe.entry_block_fwd.launches_packed, fe.entry_block_bwd_reduce.launches_packed,
            fe.entry_block_bwd_wgrad.launches_packed) == tuple(b + 1 for b in before)


@pytest.mark.parametrize("flag", [None, "entry_block_pallas"])
def test_train_step_with_the_three_knobs_repeats_a_cpu_step(cuda, flag, monkeypatch):
    """One Mean-Teacher step with all three knobs on (onedot K1, the
    recompute fixup, the packed draw), on the card against the CPU; the
    card's launches: onedot K1 and no FFT K1, the recompute fixup and no
    stored one, every dropout launch packed."""
    monkeypatch.setattr(fused_mel, "ONEDOT", True)
    monkeypatch.setattr(fused_block, "RECOMPUTE_FIXUP", True)
    monkeypatch.setattr(fused_block, "PACK_BITS", True)
    fb, fe = fused_block, fused_entry_block
    counters = ((fused_mel.fused_stft_mel_onedot, "launches"), (fused_mel.fused_stft_mel, "launches"),
                (fb.bwd_fixup, "launches"), (fb.bwd_fixup_recompute, "launches"), (fb.bwd_reduce, "launches"),
                (fb.bwd_reduce, "launches_nodyp"), (fb.fused_bn_glu_pool, "launches_train"),
                (fb.fused_bn_glu_pool, "launches_packed"), (fe.entry_block_fwd, "launches_train"),
                (fe.entry_block_fwd, "launches_packed"))
    before = [getattr(f, n) for f, n in counters]
    _step_on_the_card_against_the_cpu(cuda, flag)
    d = dict(zip([f"{f.__name__}.{n}" for f, n in counters], (getattr(f, n) - b for (f, n), b in zip(counters, before))))
    blocks = 2 if flag else 3  # the fused K2 blocks; block 1 is K5 under the flag
    assert d["fused_stft_mel_onedot.launches"] == 1 and d["fused_stft_mel.launches"] == 0, d
    assert d["bwd_fixup.launches"] == 0 and d["bwd_reduce.launches"] == 0, d
    assert d["bwd_fixup_recompute.launches"] == d["bwd_reduce.launches_nodyp"] == blocks, d
    assert d["fused_bn_glu_pool.launches_packed"] == d["fused_bn_glu_pool.launches_train"] == 2 * blocks, d
    assert d["entry_block_fwd.launches_packed"] == d["entry_block_fwd.launches_train"] == (2 if flag else 0), d


# ------------------------------------------- the serving ops and the export


def _op_cases_on(device, bf16_y: bool = False):
    """name -> (op, args, wrapper call, (wrapper, counter)) of every
    `dcase19_torch` op at small shapes on `device`."""
    rng = np.random.default_rng(11)
    fe = MelFrontend(sample_rate=8000, n_window=256, hop_length=101, n_mels=16, f_max=4000.0, max_frames=37,
                     device=device, onedot=True)
    chunks = fe._hop_chunks(_t(0.1 * rng.standard_normal((3, 37 * 101 + 256)), device))
    dims = (256, 101, 37)
    kw = dict(n_fft=256, hop=101, T=37)
    C, pool = 16, [2, 4]
    scale, bias, mean, var, gw, gb = _block_args(rng, C, device)
    vecs = (scale, bias, mean, var, gw, gb)
    y = _t(rng.standard_normal((3, 10, 20, C)), device)
    x3 = _t(rng.standard_normal((3, 10, 20)), device)
    conv = _entry_params(rng, C, device)
    w3 = _t(0.2 * rng.standard_normal((3, 3, C, C)), device)
    c64 = _entry_params(rng, 64, device)
    vec64 = _block_args(rng, 64, device)
    x64 = _t(rng.standard_normal((2, 10, 64)), device)
    fb, fe_block = fused_block, fused_entry_block
    return {
        "fused_stft_mel": (fused_mel.fused_stft_mel_op, (chunks, *fe.bases(), *dims),
                           lambda: fused_mel.fused_stft_mel(chunks, fe.bases(), **kw), (fused_mel.fused_stft_mel, "launches")),
        "fused_stft_mel_onedot": (fused_mel.fused_stft_mel_onedot_op, (chunks, *fe.onedot_bases(), *dims),
                                  lambda: fused_mel.fused_stft_mel_onedot(chunks, fe.onedot_bases(), **kw),
                                  (fused_mel.fused_stft_mel_onedot, "launches")),
        "conv2d_forward": (packed_conv.conv2d_forward_op, (y, w3, gb),
                           lambda: packed_conv.conv2d_forward({"w": w3, "b": gb}, y), (packed_conv.conv2d_forward, "launches")),
        "fused_bn_glu_pool_eval": (fb.fused_bn_glu_pool_eval, (y, *vecs, pool, 1e-3),
                                   lambda: fb.fused_bn_glu_pool(y, *vecs, pool, 1e-3), (fb.fused_bn_glu_pool, "launches_eval")),
        "fused_bn_glu_pool_eval_bf16": (fb.fused_bn_glu_pool_eval, (y.bfloat16(), *vecs, pool, 1e-3),
                                        lambda: fb.fused_bn_glu_pool(y.bfloat16(), *vecs, pool, 1e-3),
                                        (fb.fused_bn_glu_pool, "launches_eval_bf16")),
        "entry_conv_forward": (entry_conv.entry_conv_forward_op, (x3, conv["w"], conv["b"]),
                               lambda: entry_conv.entry_conv_forward(conv, x3), (entry_conv.entry_conv_forward, "launches")),
        "entry_block_fwd_eval": (fe_block.entry_block_fwd_eval, (x3, conv["w"], conv["b"], *vecs, pool, 1e-3),
                                 lambda: fe_block.entry_block_fwd(x3, conv["w"], conv["b"], *vecs, pool, 1e-3),
                                 (fe_block.entry_block_fwd, "launches_eval")),
        "crows_block_fwd_eval": (crows_block.crows_block_fwd_eval, (x64, c64["w"], c64["b"], *vec64, [2, 4], 1e-3),
                                 lambda: fe_block.entry_block_fwd(x64, c64["w"], c64["b"], *vec64, [2, 4], 1e-3,
                                                                  layout="crows"),
                                 (crows_block.crows_apply, "launches_eval")),
    }


SERVING_OPS = ("fused_stft_mel", "fused_stft_mel_onedot", "conv2d_forward", "fused_bn_glu_pool_eval",
               "fused_bn_glu_pool_eval_bf16", "entry_conv_forward", "entry_block_fwd_eval", "crows_block_fwd_eval")


@pytest.mark.parametrize("name", SERVING_OPS)
def test_serving_op_is_its_wrapper_on_the_card(cuda, name):
    """Each torch.library op on cuda: its wrapper's bits, one launch of the
    wrapper's kernel a call (K6's on crows' own counter), and opcheck."""
    op, args, wrapper_call, (counted, counter) = _op_cases_on(cuda)[name]
    before = getattr(counted, counter)
    got = op(*args)
    torch.cuda.synchronize()
    assert getattr(counted, counter) == before + 1
    want = wrapper_call()
    if name == "entry_conv_forward":
        want = want[0]  # y; the op leaves the sums to training
    for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        assert g.device == w.device and g.dtype == w.dtype and torch.equal(g, w), name
    torch.library.opcheck(op, args)


def test_flagship_default_artifact_on_the_card(cuda, tmp_path):
    """The flagship `Config()` (seeded weights, batch 24) exported on the
    card and loaded back: platforms ["cuda"], strong and weak within 1e-6
    of the evaluator's direct path on the same batch, and one call
    launches K1 once, K3f twice and K2f eval three times."""
    from dcase2019_task4_tpu_torch.config import DEFAULT_CLASSES, Config
    from dcase2019_task4_tpu_torch.data.encoder import LabelCodec
    from dcase2019_task4_tpu_torch.eval.evaluate import CheckpointEvaluator
    from dcase2019_task4_tpu_torch.eval.export import export_serving, load_serving
    from dcase2019_task4_tpu_torch.models.crnn import CRNN, seeded_init_
    from dcase2019_task4_tpu_torch.ops.mel import host_reflect_pad
    from dcase2019_task4_tpu_torch.utils.scaler import Scaler

    cfg = Config()
    d = cfg.dsp
    scaler = Scaler().load_state_dict({"mean_": [-40.0] * d.n_mels, "mean_of_square_": [1700.0] * d.n_mels})
    meta = {"epoch": 0, "pooling_time_ratio": 8, "mean_teacher": True}
    ev = CheckpointEvaluator(device=cuda, _prebuilt=(cfg, seeded_init_(CRNN(cfg.model), 0), scaler,
                                                      LabelCodec(DEFAULT_CLASSES, d.max_frames // 8), meta))
    path = str(tmp_path / "flagship.dc19serve")
    header = export_serving(ev, path)
    assert header["platforms"] == ["cuda"] and header["batch_size"] == 24
    served = load_serving(path)
    rng = np.random.default_rng(3)
    padded, frames = host_reflect_pad([0.1 * rng.standard_normal(int(d.sample_rate * s)) for s in np.linspace(2, 10, 24)],
                                      d.max_samples, d.n_window, d.hop_length, d.max_frames)
    audio = np.clip(np.round(padded * 32768.0), -32768, 32767).astype(np.int16)
    counters = ((fused_mel.fused_stft_mel, "launches"), (packed_conv.conv2d_forward, "launches"),
                (fused_block.fused_bn_glu_pool, "launches_eval"))
    before = [getattr(f, n) for f, n in counters]
    strong, weak = served(audio, frames)
    torch.cuda.synchronize()
    assert [getattr(f, n) - b for (f, n), b in zip(counters, before)] == [1, 2, 3]
    want_strong, want_weak = ev._predict(ev.features(audio, frames))
    assert strong.device.type == "cuda" and strong.shape == (24, 108, 10) and weak.shape == (24, 10)
    for got, want in ((strong, want_strong), (weak, want_weak)):
        assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()
