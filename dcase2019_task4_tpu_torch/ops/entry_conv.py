"""K4: the entry 3×3 convolution (one input channel, stride 1, zero padding 1)
with the per-channel Σy and Σy² of its output, and its weight gradient.

PyTorch counterpart of dcase2019_task4_tpu/ops/entry_conv.py. On a CUDA
tensor every wrapper launches its hand-written kernel in csrc/entry_block.cu
(or raises); on a CPU tensor it runs the plain PyTorch version beside it:

  wrapper              kernel                              plain version
  entry_conv_forward   entry_conv_kernel<0> + fold         entry_conv_reference
  entry_conv_stats     entry_conv_kernel<1> + fold         entry_conv_reference (sums only)
  entry_conv_wgrad     entry_conv_wgrad_kernel + fold      entry_conv_wgrad_reference
  entry_conv_ablation  entry_conv_kernel<2>, <3>           entry_conv_ablation_reference

`entry_conv_apply` ties forward and weight gradient into one
`torch.autograd.Function` that returns (y, Σy, Σy²) with the sums marked
non-differentiable: under `ModelConfig.entry_conv_pallas` the training CRNN
takes block 1's batch statistics from them and runs no separate statistics
pass over y. The features carry no gradient (first layer), so there is no
input gradient. The parity planes, the [12, 128] patch basis and the k = 2
lane packing of the original are TPU layout and are not ported: the kernels
read x [B, T, F] and the logical [3, 3, 1, C] weight.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dcase2019_task4_tpu_torch.ops import _build

_TILE_PIXELS = 128  # csrc/entry_block.cu kPix
_TARGET_BLOCKS = 1056  # 8 resident blocks on each of the H100's 132 SMs
_WGRAD_SLOTS = 528  # partial-sum slots of the weight gradient (10·C floats each)
_MODES = {"full": 0, "stats_only": 1, "no_patch": 2, "write_only": 3}


def entry_conv_packable(freq: int, channels: int, frames: int) -> bool:
    """Whether the kernels take x [., frames, freq] and a [3, 3, 1, channels]
    weight: a pixel tile holds whole frequency rows (freq ≤ 128) and a thread
    owns four neighbouring channels (channels a multiple of 4, up to 128).
    The original's gate (entry_conv.py:264-266: 128 // channels == 2, even
    freq, a multiple-of-8 tile dividing frames) describes the TPU's k = 2
    lane packing and its 8-row halo blocks; none of it binds a kernel that
    stages its own halo, so any number of frames is taken here."""
    return 1 <= freq <= _TILE_PIXELS and channels % 4 == 0 and 4 <= channels <= 128 and frames >= 1


def check_float32(compute_dtype, what: str):
    """The port's kernels are float32 only; bf16 (`act_bf16` in the original)
    comes with the scaled configuration."""
    if compute_dtype is not None and compute_dtype not in (torch.float32, "float32"):
        raise NotImplementedError(f"{what}: compute dtype {compute_dtype!r} is not ported; float32 only")


def _features(x: torch.Tensor) -> torch.Tensor:
    """[B, T, F, 1] or [B, T, F] → [B, T, F]."""
    if x.dim() == 4 and x.shape[-1] == 1:
        x = x[..., 0]
    if x.dim() != 3:
        raise ValueError(f"the entry conv takes one-channel features [B, T, F(, 1)], got {tuple(x.shape)}")
    return x


# --------------------------------------------------------- plain versions


def entry_conv_reference(params, x: torch.Tensor):
    """Plain version of K4f: x [B, T, F(, 1)], params["w"] [3, 3, 1, C] HWIO,
    params["b"] [C] → (y [B, T, F, C], Σy [C], Σy² [C])."""
    x = _features(x)
    w = params["w"].permute(3, 2, 0, 1)  # HWIO → OIHW
    y = F.conv2d(x[:, None], w, params["b"], stride=1, padding=1).permute(0, 2, 3, 1).contiguous()
    yd = y.detach()
    return y, yd.sum(dim=(0, 1, 2)), (yd * yd).sum(dim=(0, 1, 2))


def entry_conv_wgrad_reference(x: torch.Tensor, dy: torch.Tensor):
    """Plain version of K4w: dW[dt, df, 0, c] = Σ x[t+dt−1, f+df−1]·dy[t, f, c]
    with zeros outside the tensor, db = Σdy. x [B, T, F(, 1)], dy [B, T, F, C]
    → (dW [3, 3, 1, C], db [C])."""
    x = _features(x)
    B, T, Fq = x.shape
    xp = F.pad(x, (1, 1, 1, 1))
    dw = torch.stack([
        torch.stack([torch.einsum("btf,btfc->c", xp[:, dt: dt + T, df: df + Fq], dy) for df in range(3)])
        for dt in range(3)
    ])
    return dw[:, :, None, :], dy.sum(dim=(0, 1, 2))


def entry_conv_ablation_reference(params, x: torch.Tensor, mode: str) -> torch.Tensor:
    """What the kernel's ablation modes write: the centre tap alone plus the
    bias ("no_patch") or the bias alone ("write_only")."""
    x = _features(x)
    C = params["b"].shape[0]
    if mode == "no_patch":
        return x[..., None] * params["w"][1, 1, 0] + params["b"]
    if mode == "write_only":
        return params["b"].expand(*x.shape, C).contiguous()
    raise ValueError(f"unknown ablation mode {mode!r}")


# ------------------------------------------------------ kernel wrappers


def _check_cuda(x: torch.Tensor, C: int, what: str):
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda tensors, got {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"{what}: tensors must be float32, got {x.dtype}")
    if not entry_conv_packable(x.shape[2], C, x.shape[1]):
        raise ValueError(f"{what} kernel does not take freq={x.shape[2]}, channels={C}")


def _params_on(params, x):
    w = params["w"].detach().to(device=x.device, dtype=torch.float32).contiguous()
    b = params["b"].detach().to(device=x.device, dtype=torch.float32).contiguous()
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, 1) or tuple(b.shape) != (w.shape[-1],):
        raise ValueError(f"the entry conv takes w [3, 3, 1, C] and b [C], got {tuple(w.shape)}, {tuple(b.shape)}")
    return w, b


def _launch(params, x: torch.Tensor, mode: str, what: str):
    """One launch of entry_conv_kernel<mode> + fold → (y or None, Σy, Σy²)."""
    x = _features(x).detach().contiguous()
    w, b = _params_on(params, x)
    B, T, Fq = x.shape
    C = w.shape[-1]
    _check_cuda(x, C, what)
    lib = _build.library()
    tiles = lib.dcase_bn_glu_pool_tiles(T, Fq, 1, 1)
    tpb = max(1, -(-tiles * B // _TARGET_BLOCKS))
    slots = -(-tiles // tpb) * B
    partials = torch.empty((slots, 2 * C), dtype=torch.float64, device=x.device)
    sums = torch.empty((2, C), dtype=torch.float32, device=x.device)
    y = None if mode == "stats_only" else torch.empty((B, T, Fq, C), dtype=torch.float32, device=x.device)
    status = lib.dcase_entry_conv(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), 0 if y is None else y.data_ptr(), partials.data_ptr(),
        sums.data_ptr(), B, T, Fq, C, _MODES[mode], tpb, _build.stream_handle(x.device),
    )
    _build.check(status, what)
    return y, sums[0], sums[1]


def entry_conv_forward(params, x: torch.Tensor):
    """K4f, no graph: x [B, T, F(, 1)] → (y [B, T, F, C], Σy [C], Σy² [C]),
    the sums of y as stored, accumulated in double and folded in a fixed
    order (a run repeats bit for bit). CPU: the plain version."""
    if x.device.type == "cpu":
        y, s1, s2 = entry_conv_reference(params, x)
        return y.detach(), s1, s2
    out = _launch(params, x, "full", "entry_conv_forward")
    entry_conv_forward.launches += 1
    return out


entry_conv_forward.launches = 0


def entry_conv_stats(params, x: torch.Tensor):
    """The statistics-only mode of the K4f kernel as an ablation: (Σy, Σy²)
    of a conv output that is never written (the fused first block launches
    the same mode through `fused_entry_block.entry_block_stats_apply`). CPU:
    the plain version."""
    if x.device.type == "cpu":
        _, s1, s2 = entry_conv_reference(params, x)
        return s1, s2
    _, s1, s2 = _launch(params, x, "stats_only", "entry_conv_stats")
    entry_conv_stats.launches += 1
    return s1, s2


entry_conv_stats.launches = 0


def entry_conv_ablation(params, x: torch.Tensor, mode: str) -> torch.Tensor:
    """The K4f kernel with parts compiled out, for
    tools/bench_entry_conv_torch.py: "no_patch" (one tap instead of nine) and
    "write_only" (the bias broadcast, no conv, no sums). CPU: the plain
    version."""
    if mode not in ("no_patch", "write_only"):
        raise ValueError(f"unknown ablation mode {mode!r}")
    if x.device.type == "cpu":
        return entry_conv_ablation_reference(params, x, mode)
    y, _, _ = _launch(params, x, mode, f"entry_conv_ablation[{mode}]")
    entry_conv_ablation.launches += 1
    return y


entry_conv_ablation.launches = 0


def entry_conv_wgrad(x: torch.Tensor, dy: torch.Tensor):
    """K4w → (dW [3, 3, 1, C], db [C]). Per-block partial sums are folded in
    a fixed order (no float atomics), so a run repeats bit for bit. CPU: the
    plain version."""
    x = _features(x)
    if dy.dim() != 4 or tuple(dy.shape[:3]) != tuple(x.shape):
        raise ValueError(f"entry_conv_wgrad takes x [B,T,F] and dy [B,T,F,C], got {tuple(x.shape)}, {tuple(dy.shape)}")
    if x.device.type == "cpu":
        return entry_conv_wgrad_reference(x, dy)
    B, T, Fq = x.shape
    C = dy.shape[-1]
    x = x.detach().contiguous()
    _check_cuda(x, C, "entry_conv_wgrad")
    if dy.device != x.device or dy.dtype != torch.float32 or not dy.is_contiguous():
        raise ValueError("entry_conv_wgrad: dy must be contiguous float32 on x's device")
    lib = _build.library()
    tiles = lib.dcase_bn_glu_pool_tiles(T, Fq, 1, 1)
    tpb = max(1, -(-tiles * B // _WGRAD_SLOTS))
    slots = -(-tiles // tpb) * B
    partials = torch.empty((slots, 10 * C), dtype=torch.float32, device=x.device)
    out = torch.empty(10 * C, dtype=torch.float32, device=x.device)
    status = lib.dcase_entry_conv_wgrad(x.data_ptr(), dy.data_ptr(), partials.data_ptr(), out.data_ptr(),
                                        B, T, Fq, C, tpb, _build.stream_handle(x.device))
    _build.check(status, "entry_conv_wgrad")
    entry_conv_wgrad.launches += 1
    return out[: 9 * C].view(3, 3, 1, C), out[9 * C:]


entry_conv_wgrad.launches = 0


# ------------------------------------------------------- autograd Function


class _EntryConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x)
        y, s1, s2 = entry_conv_forward({"w": w, "b": b}, x)
        ctx.mark_non_differentiable(s1, s2)
        return y, s1, s2

    @staticmethod
    def backward(ctx, dy, _ds1, _ds2):
        (x,) = ctx.saved_tensors
        dw, db = entry_conv_wgrad(x, dy.contiguous())
        return None, dw, db  # the features carry no gradient


def entry_conv_apply(params, x: torch.Tensor, compute_dtype=None, want_stats: bool = False):
    """Drop-in for the entry conv: x [B, T, F, 1] (or [B, T, F]) → y
    [B, T, F, C], differentiable in params["w"] [3, 3, 1, C] and params["b"].
    With `want_stats` also the per-channel (Σy, Σy²) of y, without a graph:
    the BatchNorm batch statistics with no extra pass over y (the fused
    block's backward carries the through-statistics terms)."""
    check_float32(compute_dtype, "entry_conv_apply")
    y, s1, s2 = _EntryConv.apply(_features(x), params["w"], params["b"])
    return (y, s1, s2) if want_stats else y
