"""The hand-written CUDA kernels against their plain twins, on the card.

Marked `gpu`: each test skips (inside the `cuda` fixture, never at import)
when torch sees no CUDA device. On a GPU machine:

    python -m pytest tests/test_torch_kernels_gpu.py -q

Shapes are small and odd-sized (partial tiles, C < 64) to exercise the
kernels' bounds checks; chip_smoke.py covers the flagship shapes. float32
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
    out = packed_conv.conv2d_packed(params, x)
    torch.testing.assert_close(out, packed_conv.conv2d_reference(params, x), rtol=0, atol=1e-4)


@pytest.mark.parametrize("shape", [(2, 96, 64, 16), (2, 24, 4, 16), (1, 14, 8, 64), (1, 8, 16, 128)])
def test_fused_bn_glu_pool(cuda, shape):
    rng = np.random.default_rng(sum(shape))
    C = shape[-1]
    y = _t(rng.standard_normal(shape), cuda)
    args = (_t(1 + 0.1 * rng.standard_normal(C), cuda), _t(0.1 * rng.standard_normal(C), cuda),
            _t(0.2 * rng.standard_normal(C), cuda), _t(rng.uniform(0.5, 2.0, C), cuda),
            _t(rng.standard_normal((C, C)) / np.sqrt(C), cuda), _t(0.1 * rng.standard_normal(C), cuda))
    out = fused_block.fused_bn_glu_pool(y, *args, (2, 4), 1e-3)
    ref = fused_block.reference_block(y, *args, (2, 4), 1e-3)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)


def test_wrappers_refuse_non_contiguous_input(cuda):
    x = torch.zeros(1, 8, 16, 8, device=cuda).transpose(1, 2)
    params = {"w": torch.zeros(3, 3, 8, 8, device=cuda), "b": torch.zeros(8, device=cuda)}
    with pytest.raises(ValueError, match="contiguous"):
        packed_conv.conv2d_packed(params, x)
