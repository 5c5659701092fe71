"""K3: 3×3 stride-1 same-padding convolution on NHWC, with its gradients.

PyTorch counterpart of dcase2019_task4_tpu/ops/packed_conv.py, which runs
CRNN blocks 2 and 3's convolutions in the TPU's lane-packed layout. On a
CUDA tensor each wrapper launches a hand-written kernel of
csrc/packed_conv.cu (or raises); on a CPU tensor it runs the plain version
beside it:

  wrapper          kernel (float32 / bfloat16)       plain version
  conv2d_forward   conv3x3_nhwc_kernel /             conv2d_reference
                   conv3x3_bf16_kernel
  conv2d_dx        the same, reading the weights     conv2d_dx_reference
                   flipped and transposed, no bias
  conv2d_wgrad     conv3x3_wgrad_kernel /            conv2d_wgrad_reference
                   conv3x3_wgrad_bf16_kernel + fold
  conv2d_wgrad_parts  the same launch                conv2d_wgrad_parts_reference

The bfloat16 kernels multiply on the tensor cores (mma.sync, bf16 products
summed in float32); the float32 ones on the CUDA cores' FP32 FMAs, with 8 × 8
register tiles fed by 16-byte shared loads from cp.async-staged tiles: the
forward / dx as an implicit GEMM over pixel tiles (`conv_plan` plans its
launch; in dx the kernel reads the forward weights flipped and transposed by
index, so a float32 dx call launches the kernel and nothing else), the
weight gradient with all nine taps a block (`wgrad_workspace` and
`wgrad_buffers` plan its launch).

`conv2d_packed` ties them into one `torch.autograd.Function`. The lane
packing is TPU layout and is not ported: the name is kept so each
counterpart sits at the same path.

The compute dtype is x's (float32 or bfloat16), as in the JAX model, which
casts x to its compute dtype before the conv. In bfloat16 every function
rounds where the JAX kernels round (packed_conv.py:100-107,133,155,169):
x, dy and the weights enter the products as bfloat16, products accumulate
in float32, the float32 bias is added, and the forward and dx outputs are
stored in bfloat16; dW and db come out of the wgrad in float32. The
autograd Function then takes dW as the gradient of the bfloat16 copy of
the weights, rounded where JAX rounds it: at C < 128 the original packs
k = 128 // C frequency columns into one 128-lane row (`pack_factor`), so
each weight has k copies in its part-weights, one per output-frequency
class f mod k, and `_packed_conv_bwd` rounds each copy's float32 sum to
bfloat16 (`dparts.astype(parts.dtype)`) before the copies fold onto w. So
`conv2d_wgrad` in bfloat16 returns dW = Σ over the k classes of bf16(that
class's sum), added in float32; at C = 128, k = 1 and dW is the sum rounded
once. `conv2d_wgrad_parts` also returns the class sums themselves, for
checks of the partition on the card. The plain versions compute in float32
on the rounded operands.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dcase2019_task4_tpu_torch.ops import _build

_MAX_SHARED = _build.MAX_SHARED


LANES = 128  # lanes of the TPU's vector registers, which the original packs


def pack_factor(freq: int, channels: int) -> int:
    """k: the frequency columns the original packs into one 128-lane row
    (a copy of dcase2019_task4_tpu/ops/packed_conv.py:pack_factor); the
    number of output-frequency classes its bfloat16 weight gradient rounds
    apart."""
    k = LANES // channels if channels <= LANES and LANES % channels == 0 else 1
    return k if freq % k == 0 else 1


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
    params["b"] [Cout] → [B, T, F, Cout] in x's dtype."""
    w = _build.round_to(params["w"], x.dtype).permute(3, 2, 0, 1)  # HWIO → OIHW
    y = F.conv2d(x.to(torch.float32).permute(0, 3, 1, 2), w, params["b"].to(torch.float32), stride=1, padding=1)
    return y.permute(0, 2, 3, 1).contiguous().to(x.dtype)


def conv2d_dx_reference(w: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Plain version of the input gradient: the transpose convolution as
    nine shifted slices of dy against w[dt, df]ᵀ. w [3, 3, Cin, Cout],
    dy [B, T, F, Cout] → dx [B, T, F, Cin] in dy's dtype."""
    B, T, Fq, _ = dy.shape
    w = _build.round_to(w, dy.dtype)
    dyp = F.pad(dy.to(torch.float32), (0, 0, 1, 1, 1, 1))
    dx = torch.zeros((B, T, Fq, w.shape[2]), dtype=torch.float32, device=dy.device)
    for dt in range(3):
        for df in range(3):
            # x[t, f] reaches y[t − dt + 1, f − df + 1] through w[dt, df]
            dx = dx + dyp[:, 2 - dt: 2 - dt + T, 2 - df: 2 - df + Fq, :] @ w[dt, df].t()
    return dx.to(dy.dtype)


def _classes(x: torch.Tensor) -> int:
    """The output-frequency classes whose weight-gradient sums are rounded
    apart: `pack_factor` in bfloat16, one (not rounded) in float32."""
    return pack_factor(x.shape[2], x.shape[3]) if x.dtype == torch.bfloat16 else 1


def conv2d_wgrad_parts_reference(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Plain version of the weight gradient's class sums: [k, 3, 3, Cin,
    Cout] float32, dW[dt, df] = Σ shifted-xᵀ·dy with zeros outside the
    tensor, over the output frequencies f ≡ c (mod k) for class c (k =
    `_classes(x)`; in float32 one class, the whole sum). x [B, T, F, Cin],
    dy [B, T, F, Cout]."""
    B, T, Fq, _ = x.shape
    k = _classes(x)
    x, dy = x.to(torch.float32), dy.to(torch.float32)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    parts = []
    for c in range(k):
        only = dy
        if k > 1:
            only = torch.zeros_like(dy)
            only[:, :, c::k] = dy[:, :, c::k]
        parts.append(torch.stack([
            torch.stack([torch.einsum("btfi,btfo->io", xp[:, dt: dt + T, df: df + Fq, :], only) for df in range(3)])
            for dt in range(3)
        ]))
    return torch.stack(parts)


def conv2d_wgrad_reference(x: torch.Tensor, dy: torch.Tensor):
    """Plain version of the weight gradient → (dW [3, 3, Cin, Cout], db
    [Cout]) in float32, as `conv2d_wgrad` rounds it: float32, the sum;
    bfloat16, Σ over the classes of `conv2d_wgrad_parts_reference` of each
    rounded to bfloat16, in class order."""
    parts = conv2d_wgrad_parts_reference(x, dy)
    db = dy.to(torch.float32).sum(dim=(0, 1, 2))
    if x.dtype == torch.float32:
        return parts[0], db
    return sum(_build.round_to(p, x.dtype) for p in parts), db


_WGRAD_SLOTS = 128  # partial-sum slots of the bfloat16 weight gradient (k·(9·C·C + C) floats each)
# ... of the float32 one: two waves of its 576-thread blocks, one an SM on an H100's 132 SMs
_WGRAD_SLOTS_F32 = 264
_PIX_TILE = 128  # output pixels per tile of the kernels (whole frequency rows; kPix in csrc/packed_conv.cu)
_WGRAD_ROW = 64  # floats a shared row of the float32 weight gradient (kWfC in csrc/packed_conv.cu)


def wgrad_workspace(shape, dtype):
    """The weight gradient's workspace for x of `shape` [B, T, F, C] and
    `dtype` → (k, tiles, tiles_per_block, slots): k output-frequency
    classes (`_classes`), pixel tiles per clip (whole frequency rows,
    `_PIX_TILE` pixels), the tiles one block sums, and the slots, each of
    k·(9·C·C + C) float32 sums (`_WGRAD_SLOTS` / k slots in bfloat16,
    `_WGRAD_SLOTS_F32` in float32, rounded up to whole runs of tiles per
    clip)."""
    B, T, Fq, C = shape
    k = pack_factor(Fq, C) if dtype == torch.bfloat16 else 1
    tiles = -(-T // (_PIX_TILE // Fq))
    target = _WGRAD_SLOTS // k if dtype == torch.bfloat16 else _WGRAD_SLOTS_F32  # a slot holds k sums
    tiles_per_block = max(1, -(-tiles * B // target))
    return k, tiles, tiles_per_block, -(-tiles // tiles_per_block) * B


def wgrad_buffers(freq: int) -> tuple:
    """The float32 weight gradient's shared tile buffers at `freq` → (buffers,
    bytes): two copies of the x slab [(rows + 2)·(freq + 2)][64] and the dy
    tile [rows·freq][64] (rows = `_PIX_TILE` // freq) where they fit a
    block's shared memory, so the next tile loads while one multiplies; one
    where they do not (freq 1 or above 112)."""
    rows = _PIX_TILE // freq
    one = 4 * ((rows + 2) * (freq + 2) + rows * freq) * _WGRAD_ROW
    return (2, 2 * one) if 2 * one <= _MAX_SHARED else (1, one)


DTYPES = (torch.float32, torch.bfloat16)  # the compute dtypes the kernels take


def _check_dtype(x: torch.Tensor, what: str):
    if x.dtype not in DTYPES:
        raise ValueError(f"{what}: compute dtype float32 or bfloat16, got {x.dtype}")


def _check_cuda(x: torch.Tensor, what: str):
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda tensors, got {x.device}")
    if x.dtype not in DTYPES or not x.is_contiguous():
        raise ValueError(f"{what}: tensors must be contiguous float32 or bfloat16, got {x.dtype}")
    if not applicable(x.shape[2], x.shape[3]):
        raise ValueError(f"{what} kernel does not take freq={x.shape[2]}, channels={x.shape[3]}")


_SMS = 132  # streaming multiprocessors of an H100 SXM: the plan's default
_CONV_N = 64  # output channels a block of the float32 forward / dx (kCvN in csrc/packed_conv.cu)


def _odd_stride4(n: int) -> int:
    """odd_stride4 of csrc/packed_conv.cu: a shared row of n floats rounded up
    to 4, plus 4 where that is an even number of 16-byte units."""
    r4 = -(-n // 4) * 4
    return r4 if (r4 // 4) % 2 else r4 + 4


def conv_plan(shape, sms: int = _SMS):
    """The float32 forward / dx kernel's launch for x of `shape` [B, T, F, C]
    → (pix, kc, bytes): output pixels a tile (whole frequency rows: 128, or
    64 where F ≤ 64 and 128-pixel tiles would give fewer than two blocks an
    SM, as at the flagship's [24, 216, 4, 64]), input channels a weight
    slice (64, halved while the shared memory does not fit), and the dynamic
    shared memory: the slab [(rows + 2)·(F + 2)][_odd_stride4(C)] and two
    weight buffers [64][_odd_stride4(kc)], float32."""
    B, T, Fq, C = shape
    blocks = -(-T // (_PIX_TILE // Fq)) * B * -(-C // _CONV_N)
    pix = 64 if Fq <= 64 and blocks < 2 * sms else _PIX_TILE
    kc = min(64, 1 << max(2, (C - 1).bit_length()))
    while True:
        rows = pix // Fq
        nbytes = 4 * ((rows + 2) * (Fq + 2) * _odd_stride4(C) + 2 * _CONV_N * _odd_stride4(kc))
        if nbytes <= _MAX_SHARED or kc == 4:
            return pix, kc, nbytes
        kc //= 2


def _launch_conv(x: torch.Tensor, w: torch.Tensor, b, what: str, flip: bool = False) -> torch.Tensor:
    """One launch of the forward kernel on x; float32 `flip`: the input
    gradient's conv, w the forward weights read flipped and transposed, and
    b None (no bias)."""
    _check_cuda(x, what)
    B, T, Fq, C = x.shape
    bf16 = x.dtype == torch.bfloat16
    w = w.detach().to(device=x.device, dtype=x.dtype).contiguous()  # the kernel reads weights in x's dtype
    if b is not None:
        b = b.detach().to(device=x.device, dtype=torch.float32).contiguous()
        if tuple(b.shape) != (C,):
            raise ValueError(f"bias must be [{C}], got {tuple(b.shape)}")
    pix, kc, _ = (0, 0, 0) if bf16 else conv_plan(x.shape, _build.sm_count(x.device.index))
    out = torch.empty_like(x)
    status = _build.library().dcase_conv3x3(
        x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(), out.data_ptr(),
        B, T, Fq, C, C, int(bf16), int(flip), pix, kc, _build.stream_handle(x.device),
    )
    _build.check(status, what)
    return out


def _check_shapes(w, x, what: str):
    if x.dim() != 4 or tuple(w.shape) != (3, 3, x.shape[-1], x.shape[-1]):
        raise ValueError(f"{what} takes x [B,T,F,C] and w [3,3,C,C], got {tuple(x.shape)}, {tuple(w.shape)}")


def conv2d_forward(params, x: torch.Tensor) -> torch.Tensor:
    """K3 forward, no graph: 3×3 s1 p1 conv with Cin == Cout on NHWC x
    [B, T, F, C] (float32 or bfloat16) → x's dtype. params: {"w": [3, 3,
    C, C] HWIO, "b": [C]} (float32). CPU: the plain version. CUDA: the
    kernel."""
    _check_shapes(params["w"], x, "conv2d_forward")
    if x.device.type == "cpu":
        return conv2d_reference(params, x)
    out = _launch_conv(x, params["w"], params["b"], "conv2d_forward")
    _build.count_launch(conv2d_forward, "launches", x.dtype)
    return out


conv2d_forward.launches = 0  # float32 launches
conv2d_forward.launches_bf16 = 0  # bfloat16 launches


@torch.library.custom_op("dcase19_torch::conv2d_forward", mutates_args=())
def conv2d_forward_op(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`conv2d_forward` as a torch.library op, the eval-mode CRNN's and the
    serving export's only way to K3 (the training forward keeps the
    autograd Function below): the wrapper dispatches by x's device."""
    return conv2d_forward({"w": w, "b": b}, x)


@conv2d_forward_op.register_fake
def _(x, w, b):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def conv2d_dx(w: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """K3 input gradient: the forward kernel on the weights flipped in both
    taps and transposed in (Cin, Cout), without bias; dy's dtype in and
    out. float32: the kernel reads w flipped and transposed by index, so
    the call launches it and nothing else; bfloat16: the flipped,
    transposed weights and a zero bias are built on the device. CPU: the
    plain version."""
    _check_shapes(w, dy, "conv2d_dx")
    if dy.device.type == "cpu":
        return conv2d_dx_reference(w, dy)
    if dy.dtype == torch.float32:
        out = _launch_conv(dy, w, None, "conv2d_dx", flip=True)
    else:
        wt = w.detach().to(dy.device).flip(0, 1).transpose(2, 3)
        out = _launch_conv(dy, wt, torch.zeros(dy.shape[-1], dtype=torch.float32, device=dy.device), "conv2d_dx")
    _build.count_launch(conv2d_dx, "launches", dy.dtype)
    return out


conv2d_dx.launches = 0
conv2d_dx.launches_bf16 = 0


def _check_wgrad(x: torch.Tensor, dy: torch.Tensor, what: str):
    if x.dim() != 4 or x.shape != dy.shape or x.dtype != dy.dtype:
        raise ValueError(f"{what} takes x and dy of one [B,T,F,C] shape and dtype, got "
                         f"{tuple(x.shape)} {x.dtype}, {tuple(dy.shape)} {dy.dtype}")
    _check_dtype(x, what)


def _launch_wgrad(x: torch.Tensor, dy: torch.Tensor):
    """The kernel and its fold → (dW, db, the per-block slots [classes,
    slots, 9·C·C + C] float32 the fold read)."""
    _check_cuda(x, "conv2d_wgrad")
    _check_cuda(dy, "conv2d_wgrad")
    B, T, Fq, C = x.shape
    bf16 = x.dtype == torch.bfloat16
    k, _, tiles_per_block, slots = wgrad_workspace(x.shape, x.dtype)
    width = 9 * C * C + C
    partials = torch.empty((slots, k * width), dtype=torch.float32, device=x.device)
    out = torch.empty(width, dtype=torch.float32, device=x.device)
    # classes 0: one float32 sum, not rounded; k ≥ 1: each class's sum rounded to bfloat16
    status = _build.library().dcase_conv3x3_wgrad(
        x.data_ptr(), dy.data_ptr(), partials.data_ptr(), out.data_ptr(), B, T, Fq, C, tiles_per_block,
        int(bf16), k if bf16 else 0, 0 if bf16 else wgrad_buffers(Fq)[0], _build.stream_handle(x.device))
    _build.check(status, "conv2d_wgrad")
    _build.count_launch(conv2d_wgrad, "launches", x.dtype)
    return out[: 9 * C * C].view(3, 3, C, C), out[9 * C * C:], partials.view(slots, k, width).transpose(0, 1)


def conv2d_wgrad(x: torch.Tensor, dy: torch.Tensor):
    """K3 weight gradient → (dW [3, 3, C, C], db [C]) in float32 from x and
    dy of one dtype. float32: dW is the float32 sum. bfloat16: dW is the
    gradient of the bfloat16 weights as the lane-packed original folds it,
    the sum over the output-frequency classes f mod k (k = `pack_factor`)
    of each class's sum rounded to bfloat16, added in float32. db is the
    float32 sum either way. Per-block partial sums are folded in a fixed
    order (no float atomics), so a run repeats bit for bit. CPU: the plain
    version."""
    _check_wgrad(x, dy, "conv2d_wgrad")
    if x.device.type == "cpu":
        return conv2d_wgrad_reference(x, dy)
    return _launch_wgrad(x, dy)[:2]


def conv2d_wgrad_parts(x: torch.Tensor, dy: torch.Tensor):
    """`conv2d_wgrad`'s (dW, db) and, from the same launch, the float32 dW
    sums of the classes it rounds apart, [k, 3, 3, C, C], folded from the
    kernel's per-block slots by `_build.fold_parts`: dW is, bit for bit,
    the sum in class order of each class sum rounded to x's dtype. For
    checks on the card that the kernel splits the sum as the original does.
    CPU: the plain versions."""
    _check_wgrad(x, dy, "conv2d_wgrad_parts")
    if x.device.type == "cpu":
        return (*conv2d_wgrad_reference(x, dy), conv2d_wgrad_parts_reference(x, dy))
    dw, db, slots = _launch_wgrad(x, dy)
    C = x.shape[3]
    return dw, db, _build.fold_parts(slots)[:, : 9 * C * C].view(-1, 3, 3, C, C)


conv2d_wgrad.launches = 0
conv2d_wgrad.launches_bf16 = 0


class _PackedConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return conv2d_forward({"w": w, "b": b}, x)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        dx = conv2d_dx(w, dy) if ctx.needs_input_grad[0] else None
        dw, db = conv2d_wgrad(x, dy)
        return dx, dw, db


def conv2d_packed(params, x: torch.Tensor) -> torch.Tensor:
    """3×3 s1 p1 conv with Cin == Cout on NHWC x [B, T, F, C] (float32 or
    bfloat16: the compute dtype), differentiable in x, w and b through the
    kernels above. params: {"w": [3, 3, C, C] HWIO, "b": [C]} (the JAX
    layout, float32)."""
    _check_shapes(params["w"], x, "conv2d_packed")
    _check_dtype(x, "conv2d_packed")
    return _PackedConv.apply(x, params["w"], params["b"])
