"""K3 forward: 3×3 stride-1 same-padding convolution on NHWC.

PyTorch counterpart of dcase2019_task4_tpu/ops/packed_conv.py, which runs
CRNN blocks 2 and 3's convolutions in the TPU's lane-packed layout. On a
CUDA tensor `conv2d_packed` launches the hand-written kernel in
csrc/packed_conv.cu; on a CPU tensor it runs `conv2d_reference`, plain
`F.conv2d` after a permute. The lane packing is TPU layout and is not
ported: the name is kept so each counterpart sits at the same path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dcase2019_task4_tpu_torch.ops import _build

_MAX_SHARED = 232448  # opt-in shared memory per block on an H100


def applicable(freq: int, channels: int) -> bool:
    """Whether the kernel takes a [., ., freq, channels] activation: one
    block's pixel tile holds whole frequency rows (freq ≤ 128) and its
    input slab plus a weight slice fits shared memory."""
    if freq > 128 or channels > 128:
        return False
    rows = 128 // freq
    smem = 4 * ((rows + 2) * (freq + 2) * (channels + 1) + channels * 64)
    return smem <= _MAX_SHARED


def conv2d_reference(params, x: torch.Tensor) -> torch.Tensor:
    """Plain twin. x [B, T, F, C] NHWC, params["w"] [3, 3, Cin, Cout] HWIO,
    params["b"] [Cout] → [B, T, F, Cout]."""
    w = params["w"].permute(3, 2, 0, 1)  # HWIO → OIHW
    y = F.conv2d(x.permute(0, 3, 1, 2), w, params["b"], stride=1, padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


def conv2d_packed(params, x: torch.Tensor) -> torch.Tensor:
    """3×3 s1 p1 conv with Cin == Cout on NHWC x [B, T, F, C] (float32).
    params: {"w": [3, 3, C, C] HWIO, "b": [C]} (the JAX layout). CPU: the
    plain twin. CUDA: the kernel."""
    w, b = params["w"], params["b"]
    if x.dim() != 4 or tuple(w.shape) != (3, 3, x.shape[-1], x.shape[-1]):
        raise ValueError(f"conv2d_packed takes x [B,T,F,C] and w [3,3,C,C], got {tuple(x.shape)}, {tuple(w.shape)}")
    if x.device.type == "cpu":
        return conv2d_reference(params, x)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_packed runs on cpu or cuda tensors, got {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous float32, got {x.dtype}")
    B, T, Fq, C = x.shape
    if not applicable(Fq, C):
        raise ValueError(f"conv2d_packed kernel does not take freq={Fq}, channels={C}")
    w = w.to(device=x.device, dtype=torch.float32).contiguous()
    b = b.to(device=x.device, dtype=torch.float32).contiguous()
    if tuple(b.shape) != (C,):
        raise ValueError(f"bias must be [{C}], got {tuple(b.shape)}")
    lib = _build.library()
    out = torch.empty_like(x)
    status = lib.dcase_conv3x3(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
        B, T, Fq, C, C, _build.stream_handle(x.device),
    )
    _build.check(status, "conv2d_packed")
    conv2d_packed.launches += 1
    return out


conv2d_packed.launches = 0
