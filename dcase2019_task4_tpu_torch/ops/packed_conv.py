"""K3: 3×3 stride-1 same-padding convolution on NHWC, with its gradients.

PyTorch counterpart of dcase2019_task4_tpu/ops/packed_conv.py, which runs
CRNN blocks 2 and 3's convolutions in the TPU's lane-packed layout. On a
CUDA tensor each wrapper launches a hand-written kernel of
csrc/packed_conv.cu (or raises); on a CPU tensor it runs the plain version
beside it:

  wrapper          kernel                            plain version
  conv2d_forward   conv3x3_nhwc_kernel               conv2d_reference
  conv2d_dx        conv3x3_nhwc_kernel on flipped,   conv2d_dx_reference
                   transposed weights, zero bias
  conv2d_wgrad     conv3x3_wgrad_kernel + fold       conv2d_wgrad_reference

`conv2d_packed` ties them into one `torch.autograd.Function`. The lane
packing is TPU layout and is not ported: the name is kept so each
counterpart sits at the same path.
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


def conv2d_dx_reference(w: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Plain version of the input gradient: the transpose convolution as
    nine shifted slices of dy against w[dt, df]ᵀ. w [3, 3, Cin, Cout],
    dy [B, T, F, Cout] → dx [B, T, F, Cin]."""
    B, T, Fq, _ = dy.shape
    dyp = F.pad(dy, (0, 0, 1, 1, 1, 1))
    dx = torch.zeros((B, T, Fq, w.shape[2]), dtype=dy.dtype, device=dy.device)
    for dt in range(3):
        for df in range(3):
            # x[t, f] reaches y[t − dt + 1, f − df + 1] through w[dt, df]
            dx = dx + dyp[:, 2 - dt: 2 - dt + T, 2 - df: 2 - df + Fq, :] @ w[dt, df].t()
    return dx


def conv2d_wgrad_reference(x: torch.Tensor, dy: torch.Tensor):
    """Plain version of the weight gradient: dW[dt, df] = Σ shifted-xᵀ·dy
    with zeros outside the tensor, db = Σdy. x [B, T, F, Cin], dy
    [B, T, F, Cout] → (dW [3, 3, Cin, Cout], db [Cout])."""
    B, T, Fq, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    dw = torch.stack([
        torch.stack([torch.einsum("btfi,btfo->io", xp[:, dt: dt + T, df: df + Fq, :], dy) for df in range(3)])
        for dt in range(3)
    ])
    return dw, dy.sum(dim=(0, 1, 2))


_WGRAD_SLOTS = 128  # partial-sum slots of the weight gradient (9·C·C + C floats each)


def _check_cuda(x: torch.Tensor, what: str):
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda tensors, got {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{what}: tensors must be contiguous float32, got {x.dtype}")
    if not applicable(x.shape[2], x.shape[3]):
        raise ValueError(f"{what} kernel does not take freq={x.shape[2]}, channels={x.shape[3]}")


def _launch_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, what: str) -> torch.Tensor:
    _check_cuda(x, what)
    B, T, Fq, C = x.shape
    w = w.detach().to(device=x.device, dtype=torch.float32).contiguous()
    b = b.detach().to(device=x.device, dtype=torch.float32).contiguous()
    if tuple(b.shape) != (C,):
        raise ValueError(f"bias must be [{C}], got {tuple(b.shape)}")
    out = torch.empty_like(x)
    status = _build.library().dcase_conv3x3(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
        B, T, Fq, C, C, _build.stream_handle(x.device),
    )
    _build.check(status, what)
    return out


def _check_shapes(w, x, what: str):
    if x.dim() != 4 or tuple(w.shape) != (3, 3, x.shape[-1], x.shape[-1]):
        raise ValueError(f"{what} takes x [B,T,F,C] and w [3,3,C,C], got {tuple(x.shape)}, {tuple(w.shape)}")


def conv2d_forward(params, x: torch.Tensor) -> torch.Tensor:
    """K3 forward, no graph: 3×3 s1 p1 conv with Cin == Cout on NHWC x
    [B, T, F, C] (float32). params: {"w": [3, 3, C, C] HWIO, "b": [C]}.
    CPU: the plain version. CUDA: the kernel."""
    _check_shapes(params["w"], x, "conv2d_forward")
    if x.device.type == "cpu":
        return conv2d_reference(params, x)
    out = _launch_conv(x, params["w"], params["b"], "conv2d_forward")
    conv2d_forward.launches += 1
    return out


conv2d_forward.launches = 0


def conv2d_dx(w: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """K3 input gradient: the forward kernel on the weights flipped in both
    taps and transposed in (Cin, Cout), with zero bias (built on the
    device). CPU: the plain version."""
    _check_shapes(w, dy, "conv2d_dx")
    if dy.device.type == "cpu":
        return conv2d_dx_reference(w, dy)
    wt = w.detach().to(dy.device).flip(0, 1).transpose(2, 3).contiguous()
    out = _launch_conv(dy, wt, torch.zeros(dy.shape[-1], dtype=torch.float32, device=dy.device), "conv2d_dx")
    conv2d_dx.launches += 1
    return out


conv2d_dx.launches = 0


def conv2d_wgrad(x: torch.Tensor, dy: torch.Tensor):
    """K3 weight gradient → (dW [3, 3, C, C], db [C]). Per-block partial
    sums are folded in a fixed order (no float atomics), so a run repeats
    bit for bit. CPU: the plain version."""
    if x.dim() != 4 or x.shape != dy.shape:
        raise ValueError(f"conv2d_wgrad takes x and dy of one [B,T,F,C] shape, got {tuple(x.shape)}, {tuple(dy.shape)}")
    if x.device.type == "cpu":
        return conv2d_wgrad_reference(x, dy)
    _check_cuda(x, "conv2d_wgrad")
    _check_cuda(dy, "conv2d_wgrad")
    B, T, Fq, C = x.shape
    lib = _build.library()
    tiles = lib.dcase_conv3x3_tiles(T, Fq)
    tiles_per_block = max(1, -(-tiles * B // _WGRAD_SLOTS))
    slots = -(-tiles // tiles_per_block) * B
    width = 9 * C * C + C
    partials = torch.empty((slots, width), dtype=torch.float32, device=x.device)
    out = torch.empty(width, dtype=torch.float32, device=x.device)
    status = lib.dcase_conv3x3_wgrad(x.data_ptr(), dy.data_ptr(), partials.data_ptr(), out.data_ptr(),
                                     B, T, Fq, C, tiles_per_block, _build.stream_handle(x.device))
    _build.check(status, "conv2d_wgrad")
    conv2d_wgrad.launches += 1
    return out[: 9 * C * C].view(3, 3, C, C), out[9 * C * C:]


conv2d_wgrad.launches = 0


class _PackedConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return conv2d_forward({"w": w, "b": b}, x)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = conv2d_dx(w, dy) if ctx.needs_input_grad[0] else None
        dw, db = conv2d_wgrad(x, dy)
        return dx, dw, db


def conv2d_packed(params, x: torch.Tensor) -> torch.Tensor:
    """3×3 s1 p1 conv with Cin == Cout on NHWC x [B, T, F, C] (float32),
    differentiable in x, w and b through the kernels above.
    params: {"w": [3, 3, C, C] HWIO, "b": [C]} (the JAX layout)."""
    _check_shapes(params["w"], x, "conv2d_packed")
    return _PackedConv.apply(x, params["w"], params["b"])
