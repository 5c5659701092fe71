"""The hand-written CUDA kernels against their plain twins, on the card.

Marked `gpu`: each test skips (inside the `cuda` fixture, never at import)
when torch sees no CUDA device. On a GPU machine:

    python -m pytest tests/test_torch_kernels_gpu.py -q

Shapes are small and odd-sized (partial tiles, C = 16, 64 and 128) to
exercise the kernels' bounds checks; chip_smoke.py covers the flagship
shapes. Forward, train-mode dropout (mask bit-equal to the plain Philox),
batch statistics, both backward passes, conv dx and wgrad, and one whole
training step. float32
with TF32 off on both sides.
"""

import numpy as np
import pytest
import torch

from dcase2019_task4_tpu_torch.ops import fused_block, fused_mel, packed_conv
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


@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("frames", [96, 37])
def test_fused_stft_mel(cuda, dtype, frames):
    fe = MelFrontend(max_frames=frames, device=cuda)
    rng = np.random.default_rng(frames)
    audio = _t(0.2 * rng.standard_normal((3, 511 * frames + 2048)), cuda)
    if dtype == "int16":
        audio = torch.round(audio * 32768).clamp(-32768, 32767).to(torch.int16)
    chunks = fe._hop_chunks(audio)
    bases = fused_mel.FusedMelBases(fe.cos_basis, fe.sin_basis, fe.mel_fb)
    kw = dict(n_fft=2048, hop=511, T=frames)
    before = fused_mel.fused_stft_mel.launches
    out = fused_mel.fused_stft_mel(chunks, bases, **kw)
    ref = fused_mel.fused_stft_mel_reference(chunks, bases, **kw)
    assert fused_mel.fused_stft_mel.launches == before + 1
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4 * ref.abs().max().item())


@pytest.mark.parametrize("shape", [(2, 48, 16, 16), (2, 24, 4, 16), (1, 13, 8, 64), (1, 9, 32, 128)])
def test_conv2d_packed(cuda, shape):
    rng = np.random.default_rng(sum(shape))
    C = shape[-1]
    params = {"w": _t(rng.uniform(-0.1, 0.1, (3, 3, C, C)), cuda), "b": _t(rng.standard_normal(C), cuda)}
    x = _t(rng.standard_normal(shape), cuda)
    before = packed_conv.conv2d_forward.launches
    out = packed_conv.conv2d_packed(params, x)
    assert packed_conv.conv2d_forward.launches == before + 1
    torch.testing.assert_close(out, packed_conv.conv2d_reference(params, x), rtol=0, atol=1e-4)


@pytest.mark.parametrize("shape", [(2, 96, 64, 16), (2, 24, 4, 16), (1, 14, 8, 64), (1, 8, 16, 128)])
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


@pytest.mark.parametrize("shape", [(2, 48, 16, 16), (3, 26, 4, 16), (1, 13, 8, 64), (2, 37, 16, 64), (1, 9, 32, 128)])
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


def test_train_step_on_the_card_repeats_a_cpu_step(cuda):
    """One Mean-Teacher step at a small geometry on the card (kernels) and on
    the CPU (plain versions) from the same state and a CPU generator."""
    import copy

    from dcase2019_task4_tpu_torch.config import ModelConfig
    from dcase2019_task4_tpu_torch.train import steps

    cfg = ModelConfig(nb_filters=(16, 16, 16), n_rnn_cell=16)
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


def test_wrappers_refuse_non_contiguous_input(cuda):
    x = torch.zeros(1, 8, 16, 8, device=cuda).transpose(1, 2)
    params = {"w": torch.zeros(3, 3, 8, 8, device=cuda), "b": torch.zeros(8, device=cuda)}
    with pytest.raises(ValueError, match="contiguous"):
        packed_conv.conv2d_packed(params, x)
