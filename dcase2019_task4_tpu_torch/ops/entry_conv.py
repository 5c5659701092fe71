"""K4: the entry 3×3 convolution (one input channel, stride 1, zero padding 1)
with the per-channel Σy and Σy² of its output, and its weight gradient.

PyTorch counterpart of dcase2019_task4_tpu/ops/entry_conv.py. On a CUDA
tensor every wrapper launches its hand-written kernel in csrc/entry_block.cu
(or raises); on a CPU tensor it runs the plain PyTorch version beside it:

  wrapper              kernel                              plain version
  entry_conv_forward   entry_conv_kernel<0> + fold         entry_conv_reference
                       (bfloat16: entry_conv_run_kernel<bf16, true> + fold_warps)
  entry_conv_stats     entry_conv_kernel<1> + fold         entry_conv_reference (sums only)
                       (bfloat16: entry_conv_run_kernel<bf16, false> + fold_warps)
  entry_conv_wgrad     entry_conv_dw_f32_kernel + fold     entry_conv_wgrad_reference
                       (bfloat16: entry_conv_dw_bf16_kernel<CP>; both + fold_classes_warps)
  entry_conv_wgrad_parts  the same launch                 entry_conv_wgrad_parts_reference
  entry_conv_ablation  entry_conv_kernel<2>, <3>           entry_conv_ablation_reference

`entry_conv_apply` ties forward and weight gradient into one
`torch.autograd.Function` that returns (y, Σy, Σy²) with the sums marked
non-differentiable: under `ModelConfig.entry_conv_pallas` the training CRNN
takes block 1's batch statistics from them and runs no separate statistics
pass over y. The features carry no gradient (first layer), so there is no
input gradient. The parity planes, the [12, 128] patch basis and the k = 2
lane packing of the original are TPU layout and are not ported: the kernels
read x [B, T, F] and the logical [3, 3, 1, C] weight.

The compute dtype is x's: float32, or bfloat16 in a bfloat16 model
(`entry_conv_apply` casts the features to it, as the original's
`make_parity_planes(x, dtype)` does). In bfloat16 the functions round where
the original rounds (entry_conv.py:109-148,163-262): the features and the
weights enter the products as bfloat16, products and sums are float32, the
float32 bias is added, y is stored in bfloat16 and Σy, Σy² are the float32
sums of y as stored. The weight gradient multiplies the bfloat16 features
by dy in bfloat16 and gives the gradient of the bfloat16 weights as the
original folds it: its [12, 128] basis holds every weight twice, once per
output-frequency parity (output frequency 2·f2 + h), and it rounds each
copy's float32 sum to bfloat16 before the copies fold onto w, so
dW = bf16(Σ over even f) + bf16(Σ over odd f), added in float32 (one
rounding of the whole sum where F is odd, which the original does not
take). db stays the float32 sum.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dcase2019_task4_tpu_torch.ops import _build

_TILE_PIXELS = 128  # csrc/entry_block.cu kPix
_TARGET_BLOCKS = 1056  # float32 conv: 8 resident blocks on each of the H100's 132 SMs
_CONV_THREADS = 128  # csrc/entry_block.cu kConvThreads: threads of a block of the one-wave conv
_CONV_RUN = 4  # kConvRun: pixels along f a thread of the one-wave conv forms at once
_CONV_CHANS = 4  # kConvChans: channels a thread of the one-wave conv forms
_CONV_HALO = 1024  # kConvHalo: floats of its staged x tile, at most
_CONV_TILE_PIXELS = 1024  # the pixels its tile aims at (the halo caps it: 13 rows at F = 64)
_DW_THREADS = 256  # csrc/entry_block.cu kDwThreads: threads of a block of the weight gradient
_DW_TILE_PIXELS = 128  # kDwTilePix: pixels a tile of the weight gradient, at most (the bfloat16 product's K)
_DW_TILE_BYTES = 32768  # the bytes of dy its tile aims at
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


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}  # the compute dtypes the kernels take


def compute_dtype_of(compute_dtype, x: torch.Tensor) -> torch.dtype:
    """The compute dtype a call asks for (a torch dtype or its name), x's
    dtype when None; ValueError for any but float32 and bfloat16."""
    dt = x.dtype if compute_dtype is None else DTYPES.get(compute_dtype, compute_dtype)
    if dt not in DTYPES.values():
        raise ValueError(f"compute dtype {compute_dtype!r}: float32 or bfloat16")
    return dt


def wgrad_parts(dy: torch.Tensor, partition: str):
    """dy [B, T, F, C] split into the parts whose weight-gradient sums the
    original rounds apart: by output-frequency parity ("parity", the
    parity-plane basis; one part where F is odd) or by batch half
    ("halves", the crows basis). Each part is dy with zeros elsewhere."""
    B, _, Fq, _ = dy.shape
    if partition == "parity":
        if Fq % 2:
            return [dy]
        cut = [(slice(None), slice(None), slice(h, None, 2)) for h in (0, 1)]
    elif partition == "halves":
        cut = [(slice(0, B // 2),), (slice(B // 2, None),)]
    else:
        raise ValueError(f"unknown partition {partition!r}")
    parts = []
    for index in cut:
        part = torch.zeros_like(dy)
        part[index] = dy[index]
        parts.append(part)
    return parts


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
    params["b"] [C] → (y [B, T, F, C] in x's dtype, Σy [C], Σy² [C]); in
    bfloat16 the conv of the rounded weights in float32, y rounded, the sums
    float32 over y as stored."""
    x = _features(x)
    if x.dtype == torch.bfloat16:
        w = _build.round_to(params["w"], x.dtype).permute(3, 2, 0, 1)
        y = F.conv2d(x.float()[:, None], w, params["b"].float(), stride=1, padding=1)
        y = y.permute(0, 2, 3, 1).contiguous().to(x.dtype)
        yd = y.detach().float()
        return y, yd.sum(dim=(0, 1, 2)), (yd * yd).sum(dim=(0, 1, 2))
    w = params["w"].permute(3, 2, 0, 1)  # HWIO → OIHW
    y = F.conv2d(x[:, None], w, params["b"], stride=1, padding=1).permute(0, 2, 3, 1).contiguous()
    yd = y.detach()
    return y, yd.sum(dim=(0, 1, 2)), (yd * yd).sum(dim=(0, 1, 2))


def entry_conv_wgrad_reference(x: torch.Tensor, dy: torch.Tensor, partition: str = "parity"):
    """Plain version of K4w: dW[dt, df, 0, c] = Σ x[t+dt−1, f+df−1]·dy[t, f, c]
    with zeros outside the tensor, db = Σdy. x [B, T, F(, 1)], dy [B, T, F, C]
    → (dW [3, 3, 1, C], db [C]). bfloat16 x and dy: dW = Σ over the parts of
    `wgrad_parts(dy, partition)` of bf16(that part's sum), in float32."""
    x = _features(x)
    if x.dtype != torch.bfloat16:
        return _wgrad(F.pad(x, (1, 1, 1, 1)), dy), dy.sum(dim=(0, 1, 2))
    dw = sum(_build.round_to(part, x.dtype) for part in entry_conv_wgrad_parts_reference(x, dy, partition))
    return dw, dy.to(torch.float32).sum(dim=(0, 1, 2))


def _wgrad(xp, dy):
    """dW [3, 3, 1, C] of the padded features xp [B, T + 2, F + 2] and dy."""
    _, T, Fq, _ = dy.shape
    return torch.stack([
        torch.stack([torch.einsum("btf,btfc->c", xp[:, dt: dt + T, df: df + Fq], dy) for df in range(3)])
        for dt in range(3)
    ])[:, :, None, :]


def entry_conv_wgrad_parts_reference(x: torch.Tensor, dy: torch.Tensor, partition: str = "parity"):
    """The float32 weight-gradient sums of the parts of
    `wgrad_parts(dy, partition)`, each [3, 3, 1, C], before any rounding:
    what the original's packed basis accumulates per copy of a weight."""
    x = _features(x).to(torch.float32)
    xp = F.pad(x, (1, 1, 1, 1))
    return [_wgrad(xp, part) for part in wgrad_parts(dy.to(torch.float32), partition)]


def entry_conv_ablation_reference(params, x: torch.Tensor, mode: str) -> torch.Tensor:
    """What the kernel's ablation modes write (float32): the centre tap alone
    plus the bias ("no_patch") or the bias alone ("write_only")."""
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
    if x.dtype not in DTYPES.values():
        raise ValueError(f"{what}: tensors must be float32 or bfloat16, got {x.dtype}")
    if not entry_conv_packable(x.shape[2], C, x.shape[1]):
        raise ValueError(f"{what} kernel does not take freq={x.shape[2]}, channels={C}")


def _params_on(params, x, rounded: bool = True):
    """The weights rounded to x's dtype (held in float32; unrounded where
    not `rounded`: the bfloat16 conv kernel rounds them itself) and the
    float32 bias, on x's device."""
    w = params["w"].detach().to(device=x.device, dtype=torch.float32)
    w = (_build.round_to(w, x.dtype) if rounded else w).contiguous()
    b = params["b"].detach().to(device=x.device, dtype=torch.float32).contiguous()
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, 1) or tuple(b.shape) != (w.shape[-1],):
        raise ValueError(f"the entry conv takes w [3, 3, 1, C] and b [C], got {tuple(w.shape)}, {tuple(b.shape)}")
    return w, b


def conv_stride(freq: int) -> int:
    """Row stride of the one-wave conv's staged x tile, in floats: every
    run's window of a row (4·ceil(F / 4) + 2), rounded up to four
    (csrc/entry_block.cu conv_stride)."""
    return _CONV_RUN * -(-freq // _CONV_RUN) + 4


def conv_run_plan(freq: int, channels: int):
    """The plan of the one-wave conv (entry_conv_run_kernel: K4f / K5s in
    bfloat16, K5s in float32; x is staged as float32 in both types, so one
    plan serves both) at F = `freq` and C = `channels` → (rows, halo,
    smem): tiles of `rows` time rows (about _CONV_TILE_PIXELS pixels, at
    least one row) whose staged x, halo = (rows + 2)·conv_stride(F) floats,
    stays within kConvHalo = 1024 (4 KB); smem, the block's static shared
    memory in bytes: two x tiles [1024] float32 and each of the 128
    threads' float64 sums of y and y² [2·4] (four channels a thread, C a
    multiple of four). On an NVIDIA H100 80GB HBM3 (700 W) at x [24, 864,
    64] bfloat16, C = 64, 13-row tiles read fastest and four channels a
    thread tie with eight; on float32 x (K5s) 13-row tiles read fastest too
    and eight channels a thread slower (PERF.md, tools/bench_k5_torch.py
    --variants)."""
    if channels % _CONV_CHANS:
        raise ValueError(f"the one-wave conv takes C a multiple of {_CONV_CHANS}, got {channels}")
    stride = conv_stride(freq)
    rows = max(1, min(_CONV_TILE_PIXELS // freq, _CONV_HALO // stride - 2))
    return rows, (rows + 2) * stride, 2 * _CONV_HALO * 4 + 2 * _CONV_CHANS * _CONV_THREADS * 8


def _launch(params, x: torch.Tensor, mode: str, what: str, wave: bool = False):
    """One launch of the conv kernel in `mode` + fold → (y or None, Σy,
    Σy²): float32 entry_conv_kernel<mode> over blocks of (clip, run of
    tiles); bfloat16, and float32 statistics under `wave`, the one-wave
    entry_conv_run_kernel over the resident blocks, each an equal run of
    the batch's time rows (`conv_run_plan`)."""
    x = _features(x).detach().contiguous()
    bf16 = x.dtype == torch.bfloat16
    w, b = _params_on(params, x, rounded=not bf16)
    B, T, Fq = x.shape
    C = w.shape[-1]
    _check_cuda(x, C, what)
    if wave and not bf16 and mode != "stats_only":
        raise ValueError(f"{what}: the one-wave conv takes float32 x for the statistics only")
    lib = _build.library()
    if bf16 or wave:
        rows = conv_run_plan(Fq, C)[0]
        grid = slots = _build.wave_grid(_build.resident(x.device.index, "conv_bf16" if bf16 else "conv_f32"), B, T)
    else:
        tiles = lib.dcase_bn_glu_pool_tiles(T, Fq, 1, 1)
        grid = max(1, -(-tiles * B // _TARGET_BLOCKS))  # tiles a block
        slots, rows = -(-tiles // grid) * B, 0
    partials = torch.empty((slots, 2 * C), dtype=torch.float64, device=x.device)
    sums = torch.empty((2, C), dtype=torch.float32, device=x.device)
    y = None if mode == "stats_only" else torch.empty((B, T, Fq, C), dtype=x.dtype, device=x.device)
    status = lib.dcase_entry_conv(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), 0 if y is None else y.data_ptr(), partials.data_ptr(),
        sums.data_ptr(), B, T, Fq, C, _MODES[mode], grid, int(bf16), rows, _build.stream_handle(x.device),
    )
    _build.check(status, what)
    return y, sums[0], sums[1]


def entry_conv_forward(params, x: torch.Tensor):
    """K4f, no graph: x [B, T, F(, 1)] (float32 or bfloat16) → (y [B, T, F, C]
    in x's dtype, Σy [C], Σy² [C]), the float32 sums of y as stored,
    accumulated in double (in bfloat16 in float32 over a thread's pixels of
    a tile first) and folded in a fixed order (a run repeats bit for bit).
    CPU: the plain version."""
    if x.device.type == "cpu":
        y, s1, s2 = entry_conv_reference(params, x)
        return y.detach(), s1, s2
    out = _launch(params, x, "full", "entry_conv_forward")
    _build.count_launch(entry_conv_forward, "launches", x.dtype)
    return out


entry_conv_forward.launches = 0  # float32 launches
entry_conv_forward.launches_bf16 = 0  # bfloat16 launches


@torch.library.custom_op("dcase19_torch::entry_conv_forward", mutates_args=())
def entry_conv_forward_op(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`entry_conv_forward` as a torch.library op, the eval-mode CRNN's and
    the serving export's only way to K4f: → y (the kernel's Σy, Σy² serve
    the training BatchNorm, which does not call the op). The wrapper
    dispatches by x's device."""
    return entry_conv_forward({"w": w, "b": b}, x)[0]


@entry_conv_forward_op.register_fake
def _(x, w, b):
    return x.new_empty((*_features(x).shape, w.shape[-1]))


def entry_conv_stats(params, x: torch.Tensor):
    """The statistics-only mode of the K4f kernel as an ablation: (Σy, Σy²)
    of a conv output that is never written, on K4f's own kernel and grid
    (so in float32 K4f's sums bit for bit; the fused first block's
    statistics, `fused_entry_block.entry_block_stats_apply`, run the
    one-wave kernel, in bfloat16 the same launch as this). CPU: the plain
    version."""
    if x.device.type == "cpu":
        _, s1, s2 = entry_conv_reference(params, x)
        return s1, s2
    _, s1, s2 = _launch(params, x, "stats_only", "entry_conv_stats")
    _build.count_launch(entry_conv_stats, "launches", x.dtype)
    return s1, s2


entry_conv_stats.launches = 0
entry_conv_stats.launches_bf16 = 0


def entry_conv_ablation(params, x: torch.Tensor, mode: str) -> torch.Tensor:
    """The K4f kernel with parts compiled out, for
    tools/bench_entry_conv_torch.py: "no_patch" (one tap instead of nine) and
    "write_only" (the bias broadcast, no conv, no sums). CPU: the plain
    version."""
    if mode not in ("no_patch", "write_only"):
        raise ValueError(f"unknown ablation mode {mode!r}")
    if x.dtype != torch.float32:
        raise ValueError(f"the ablation modes are float32 only, got {x.dtype}")
    if x.device.type == "cpu":
        return entry_conv_ablation_reference(params, x, mode)
    y, _, _ = _launch(params, x, mode, f"entry_conv_ablation[{mode}]")
    entry_conv_ablation.launches += 1
    return y


entry_conv_ablation.launches = 0


def _wgrad_args(x: torch.Tensor, dy: torch.Tensor, what: str):
    x = _features(x)
    if dy.dim() != 4 or tuple(dy.shape[:3]) != tuple(x.shape) or dy.dtype != x.dtype:
        raise ValueError(f"{what} takes x [B,T,F] and dy [B,T,F,C] of one dtype, got "
                         f"{tuple(x.shape)} {x.dtype}, {tuple(dy.shape)} {dy.dtype}")
    return x


def wgrad_plan(freq: int, channels: int, dtype) -> tuple:
    """The plan of K4w (entry_conv_dw_f32_kernel, entry_conv_dw_bf16_kernel)
    at F = `freq`, C = `channels` and x's dtype → (rows, smem): tiles of
    `rows` time rows, about _DW_TILE_BYTES of dy (at least one row, at most
    _DW_TILE_PIXELS pixels), and the block's dynamic shared memory in bytes
    (csrc/entry_block.cu dw_f32_smem, dw_bf16_smem): float32, two dy tiles
    [rows·F][C] (or, where they take more, the thread shares' sums
    [S][10][C], S = 256 // (C / 4), written there at the end) and two x
    tiles with their halo, (rows + 2)·(F + 2) floats rounded up to four;
    bfloat16, two dy tiles [_DW_TILE_PIXELS][CP + 8] and two patch matrices
    [16][_DW_TILE_PIXELS + 8], CP = 64 (C ≤ 64) or 128. The card's
    occupancy calculator turns smem into blocks an SM (`_build.resident(...,
    "conv_wgrad", bf16, F, C, rows)`). On an NVIDIA H100 80GB HBM3 (700 W) at
    x [24, 864, 64], C = 64, tiles of two rows read fastest in both types,
    at three blocks an SM; tiles of one row and fewer blocks an SM slower
    (PERF.md, tools/bench_k5_torch.py --variants k4w)."""
    if channels % 4 or not 4 <= channels <= 128:
        raise ValueError(f"K4w takes C a multiple of 4 up to 128, got {channels}")
    bf16 = dtype == torch.bfloat16
    rows = max(1, min(_DW_TILE_BYTES // (freq * channels * (2 if bf16 else 4)), _DW_TILE_PIXELS // freq))
    if bf16:
        cp = 64 if channels <= 64 else 128
        return rows, 2 * (2 * _DW_TILE_PIXELS * (cp + 8) + 2 * 16 * (_DW_TILE_PIXELS + 8))
    halo = 4 * -(-(rows + 2) * (freq + 2) // 4)
    shares = _DW_THREADS // (channels // 4)
    return rows, 4 * (max(2 * rows * freq * channels, shares * 10 * channels) + 2 * halo)


def _launch_wgrad(x: torch.Tensor, dy: torch.Tensor):
    """The kernel and its fold → (dW, db, the per-block slots [parts,
    slots, 10·C] float32 the fold read): one wave of the resident blocks,
    each an equal run of the batch's time rows (`wgrad_plan`)."""
    B, T, Fq = x.shape
    C = dy.shape[-1]
    x = x.detach().contiguous()
    _check_cuda(x, C, "entry_conv_wgrad")
    if dy.device != x.device or not dy.is_contiguous():
        raise ValueError("entry_conv_wgrad: dy must be contiguous on x's device")
    if dy.data_ptr() % 16:
        dy = dy.clone()  # the kernel copies dy by 16-byte cp.async
    bf16 = x.dtype == torch.bfloat16
    classes = 2 if bf16 and Fq % 2 == 0 else 1
    rows = wgrad_plan(Fq, C, x.dtype)[0]
    blocks = _build.wave_grid(_build.resident(x.device.index, "conv_wgrad", int(bf16), Fq, C, rows), B, T)
    lib = _build.library()
    partials = torch.empty((blocks, classes * 10 * C), dtype=torch.float32, device=x.device)
    out = torch.empty(10 * C, dtype=torch.float32, device=x.device)
    status = lib.dcase_entry_conv_wgrad(x.data_ptr(), dy.data_ptr(), partials.data_ptr(), out.data_ptr(),
                                        B, T, Fq, C, blocks, rows, int(bf16), classes, _build.stream_handle(x.device))
    _build.check(status, "entry_conv_wgrad")
    _build.count_launch(entry_conv_wgrad, "launches", x.dtype)
    return out[: 9 * C].view(3, 3, 1, C), out[9 * C:], partials.view(blocks, classes, 10 * C).transpose(0, 1)


def entry_conv_wgrad(x: torch.Tensor, dy: torch.Tensor):
    """K4w → (dW [3, 3, 1, C], db [C]) in float32 from x and dy of one dtype.
    bfloat16: dW = bf16(Σ over even output frequencies) + bf16(Σ over odd
    ones) (one part where F is odd), the gradient of the bfloat16 weights.
    Per-block partial sums are folded in a fixed order (no float atomics),
    so a run repeats bit for bit. CPU: the plain version."""
    x = _wgrad_args(x, dy, "entry_conv_wgrad")
    if x.device.type == "cpu":
        return entry_conv_wgrad_reference(x, dy)
    return _launch_wgrad(x, dy)[:2]


def entry_conv_wgrad_parts(x: torch.Tensor, dy: torch.Tensor):
    """`entry_conv_wgrad`'s (dW, db) and, from the same launch, the float32
    dW sums of the parts it rounds apart, [parts, 3, 3, 1, C], folded from
    the kernel's per-block slots by `_build.fold_parts` (in the order of the
    kernel's fold, a warp a column): dW is, bit for
    bit, the sum in part order of each part rounded to x's dtype. For
    checks on the card that the kernel splits the sum as the original does.
    CPU: the plain versions."""
    x = _wgrad_args(x, dy, "entry_conv_wgrad_parts")
    if x.device.type == "cpu":
        dw, db = entry_conv_wgrad_reference(x, dy)
        return dw, db, torch.stack(entry_conv_wgrad_parts_reference(x, dy) if x.dtype == torch.bfloat16 else [dw])
    dw, db, slots = _launch_wgrad(x, dy)
    C = dy.shape[-1]
    return dw, db, _build.fold_parts(slots, warps=True)[:, : 9 * C].view(-1, 3, 3, 1, C)


entry_conv_wgrad.launches = 0  # float32 launches
entry_conv_wgrad.launches_bf16 = 0  # bfloat16 launches


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
        dw, db = entry_conv_wgrad(x, dy.to(x.dtype).contiguous())
        return None, dw, db  # the features carry no gradient


def entry_conv_apply(params, x: torch.Tensor, compute_dtype=None, want_stats: bool = False):
    """Drop-in for the entry conv: x [B, T, F, 1] (or [B, T, F]) → y
    [B, T, F, C] in the compute dtype (x's when None; the features are cast
    to it), differentiable in params["w"] [3, 3, 1, C] and params["b"].
    With `want_stats` also the per-channel (Σy, Σy²) of y, without a graph:
    the BatchNorm batch statistics with no extra pass over y (the fused
    block's backward carries the through-statistics terms)."""
    x = _features(x)
    x = x.to(compute_dtype_of(compute_dtype, x))
    y, s1, s2 = _EntryConv.apply(x, params["w"], params["b"])
    return (y, s1, s2) if want_stats else y
