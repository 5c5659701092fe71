"""K5: the whole first CRNN block, conv(1 → C) → BatchNorm → GLU → dropout →
avg-pool, as fused kernels whose conv output never reaches device memory,
forward and backward.

PyTorch counterpart of dcase2019_task4_tpu/ops/fused_entry_block.py. On a
CUDA tensor every wrapper launches its hand-written kernel in
csrc/entry_block.cu (or raises); on a CPU tensor it runs the plain PyTorch
version beside it:

  wrapper                  kernel                                  plain version
  entry_block_stats_apply  entry_conv_run_kernel<float, false>     entry_conv_reference (sums)
                           + fold_warps (bfloat16: <bf16, false>)
  entry_block_fwd          entry_block_fwd_f32_kernel              reference_entry_block
                           (bfloat16: entry_block_fwd_bf16_kernel)
  entry_block_bwd_reduce   entry_block_bwd_reduce_f32_kernel + fold  entry_block_bwd_reduce_reference
                           (bfloat16: entry_block_bwd_reduce_bf16_kernel)
  entry_block_bwd_wgrad    entry_block_bwd_wgrad_f32_kernel + fold entry_block_bwd_wgrad_reference
                           (bfloat16: entry_block_bwd_wgrad_bf16_kernel)
  entry_block_bwd_wgrad_parts  the same launch                     entry_block_bwd_wgrad_parts_reference

The forward and both passes compute the conv once into a tile and run
their K2 counterpart's per-tile code on it: in float32 K2's FP32
register-tile code (csrc/f32_tile.cuh): the forward K2f's float32 forward
(`fwd_f32_plan`), pass 1 K2b's float32 reduce pass (`f32_reduce_plan`), pass
2 the recompute fixup's dxn and dy, then dW and d conv_b from the dy tile
(`f32_wgrad_plan`); in bfloat16 K2's tile code on the tensor cores
(csrc/bf16_tile.cuh; `fwd_bf16_plan`, `bf16_bwd_plan`). Their launch plan is
one wave of the resident blocks over the batch's tiles in equal runs
(`_build.wave_grid`, from the CUDA occupancy calculator); pass 1 in float32
sums into the slots of K2b's float32 reduce pass (runs of a clip's tiles,
equal runs of them a block), so it gives K4f → K2b's bits, and the float32
forward gives K4f → K2f's.

`entry_block_apply` ties them into one `torch.autograd.Function` with the
contract of `fused_block.fused_bn_glu_dropout_pool`: mean and var come in
detached (the batch statistics from `entry_block_stats_apply`, or the
running ones in eval mode) and the backward carries the whole
BatchNorm-training backward. It runs in two passes with a host-side step
between them, `fused_block.bwd_coefficients` on the folded S1 and S2, which
is where a data-parallel run would all-reduce them. d scale = S2 and
d bias = S1. The features carry no gradient.

The dropout mask is the fused block's: Philox4x32-10 on (seed, global
element index of the [B, T, F, C] conv output / 4), or the packed 8-bit draw
under DCASE_DROPOUT_PACK (`pack_bits=`, default `fused_block.PACK_BITS`,
recorded by the autograd Function at its forward; packed launches counted
in `launches_packed`). So this block with a seed equals conv →
`fused_bn_glu_dropout_pool` with that seed and draw, outputs and gradients,
and `fused_block.dropout_keep_mask` is the CPU twin of both. The
parity planes, the patch basis and the lane-tiled, block-diagonal
parameters of the original are TPU layout and are not ported.

The compute dtype is x's: float32, or bfloat16 in a bfloat16 model (the
entry points cast the features to it, as `make_parity_planes(x, dtype)`
does). In bfloat16 every function rounds where the original's `act_bf16` /
`lp` mode rounds (fused_entry_block.py:97-236): the features and the conv
weights enter the conv as bfloat16 and y is rounded to bfloat16 in every
pass, so the statistics sum the rounded values; xn and glu_w enter the GLU
product, dlin and glu_w enter dxn, and xn and dlin enter d glu_w as
bfloat16 (K2's bfloat16 mode); the pooled output is bfloat16; dW takes the
features and dy as bfloat16 and is the gradient of the bfloat16 weights,
rounded in two parts before they are added; d conv_b, S1, S2 and the
statistics are float32. Two of those roundings differ between the
original's two layouts, and `layout` picks one:

  * "planes" (this module's original): the pool rounds each pt-row column
    sum of g to bfloat16 and adds the columns (`_pool_mxu`, as K2), and
    dW's parts are the output-frequency parities (the [12, 128] basis
    holds each weight once per parity, fused_entry_block.py:416);
  * "crows" (ops/crows_block.py's original, crows_block.py:240-245,535):
    the pool rounds every g to bfloat16 before the window sum, and dW's
    parts are the two batch halves its [2C, 18] basis packs.

Its upsample of the pooled cotangent scales by 1/(pt·pf) before rounding
(crows_block.py:250-255), the planes kernel after; under the crows gate
pt·pf is a power of two (pt = 2, pf divides F = 64), so both give the same
values. In float32 the layouts give the same bits.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import torch

from dcase2019_task4_tpu_torch.ops import _build, entry_conv, fused_block

_TILE_PIXELS = fused_block._TILE_PIXELS  # csrc/bf16_tile.cuh kPix


def entry_block_applicable(shape, pool: Tuple[int, int], channels: int = 64) -> bool:
    """Whether the fused first block takes features [B, T, F, 1] with this
    pooling and `channels` filters: one input channel, whole pooling windows,
    a pooling row of at most one pixel tile (pt · F ≤ 128), and channels in
    whole groups of four up to 128 (the fused block's geometry). The
    original also asks for even F and pf and a multiple-of-8 time tile
    (fused_entry_block.py:80-91): the TPU's k = 2 parity packing and 8-row
    halo blocks, which the Hopper kernel has no use for."""
    B, T, Fq, cin = shape
    return cin == 1 and pool[0] * Fq <= 128 and fused_block.applicable((B, T, Fq, channels), tuple(pool))


# --------------------------------------------------------- plain versions


def _conv(x, conv_w, conv_b):
    return entry_conv.entry_conv_reference({"w": conv_w, "b": conv_b}, x)[0]


LAYOUTS = ("planes", "crows")


def _check_layout(layout: str):
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")


def reference_entry_block(x, conv_w, conv_b, scale, bias, mean, var, glu_w, glu_b, pool, eps,
                          mask=None, keep: float = 1.0, layout: str = "planes"):
    """Plain version of K5f: x [B, T, F(, 1)], conv_w [3, 3, 1, C] → pooled
    [B, T/pt, F/pf, C] in x's dtype (conv, then `fused_block.reference_block`;
    in bfloat16 under "crows" every g rounded before the window sum)."""
    _check_layout(layout)
    y = _conv(x, conv_w, conv_b)
    if layout == "planes" or y.dtype != torch.bfloat16:
        return fused_block.reference_block(y, scale, bias, mean, var, glu_w, glu_b, pool, eps, mask, keep)
    g = _build.round_to(fused_block.glu_gate(y, scale, bias, mean, var, glu_w, glu_b, eps, mask, keep), y.dtype)
    B, T, Fq, C = g.shape
    pt, pf = pool
    return (g.reshape(B, T // pt, pt, Fq // pf, pf, C).sum(dim=(2, 4)) * (1.0 / (pt * pf))).to(y.dtype)


def entry_block_bwd_reduce_reference(x, dout, conv_w, conv_b, scale, bias, mean, var, glu_w, glu_b, pool, eps,
                                     mask=None, keep: float = 1.0):
    """Plain version of pass 1, in formulas: → (d glu_w [C, C], d glu_b, S1 =
    Σdxn, S2 = Σdxn·x̂)."""
    y = _conv(x, conv_w, conv_b).detach()
    _, dgw, dgb, s1, s2 = fused_block.bwd_reduce_reference(y, dout, scale, bias, mean, var, glu_w, glu_b,
                                                           pool, eps, mask, keep)
    return dgw, dgb, s1, s2


def _pass2_dy(x, dout, conv_w, conv_b, scale, bias, mean, var, glu_w, glu_b, a, b2, pool, eps, mask, keep):
    """dy = inv·γ·dxn − a − (y − mean)·b2 in float32, and y's dtype."""
    y = _conv(x, conv_w, conv_b).detach()
    dyp = fused_block.bwd_reduce_terms(y, dout, scale, bias, mean, var, glu_w, glu_b, pool, eps, mask, keep)[0]
    return dyp.to(torch.float32) - a - (y.to(torch.float32) - mean) * b2, y.dtype


def entry_block_bwd_wgrad_reference(x, dout, conv_w, conv_b, scale, bias, mean, var, glu_w, glu_b, a, b2,
                                    pool, eps, mask=None, keep: float = 1.0, layout: str = "planes"):
    """Plain version of pass 2: dy = inv·γ·dxn − a − (y − mean)·b2 (float32),
    then dW = patchesᵀ·dy and d conv_b = Σdy → (dW [3, 3, 1, C], d conv_b
    [C]). bfloat16: dW on dy rounded to bfloat16, in the parts of `layout`
    (`entry_conv.wgrad_parts`), each rounded; d conv_b on the float32 dy."""
    _check_layout(layout)
    dy, dtype = _pass2_dy(x, dout, conv_w, conv_b, scale, bias, mean, var, glu_w, glu_b, a, b2, pool, eps, mask, keep)
    if dtype != torch.bfloat16:
        return entry_conv.entry_conv_wgrad_reference(x, dy)
    partition = "parity" if layout == "planes" else "halves"
    dw = entry_conv.entry_conv_wgrad_reference(x, dy.to(dtype), partition)[0]
    return dw, dy.sum(dim=(0, 1, 2))


def entry_block_bwd_wgrad_parts_reference(x, dout, conv_w, conv_b, scale, bias, mean, var, glu_w, glu_b, a, b2,
                                          pool, eps, mask=None, keep: float = 1.0, layout: str = "planes"):
    """Pass 2's dW as the float32 sums of its two parts under `layout`
    (output-frequency parity, or batch halves under "crows"), before they
    are rounded, with dy rounded to x's dtype: what the original's packed
    basis accumulates per copy of a weight."""
    _check_layout(layout)
    dy, dtype = _pass2_dy(x, dout, conv_w, conv_b, scale, bias, mean, var, glu_w, glu_b, a, b2, pool, eps, mask, keep)
    partition = "parity" if layout == "planes" else "halves"
    return entry_conv.entry_conv_wgrad_parts_reference(x, dy.to(dtype), partition)


def entry_block_bwd_reference(x, dout, conv_w, conv_b, scale, bias, mean, var, glu_w, glu_b, pool, eps,
                              mask=None, keep: float = 1.0, layout: str = "planes"):
    """The whole backward in formulas (no autograd), with mean/var the batch
    statistics of the conv output: → (dW, d conv_b, dscale, dbias, d glu_w,
    d glu_b); the two passes' plain versions with the coefficients between
    them."""
    dgw, dgb, s1, s2 = entry_block_bwd_reduce_reference(x, dout, conv_w, conv_b, scale, bias, mean, var, glu_w,
                                                        glu_b, pool, eps, mask, keep)
    x3 = entry_conv._features(x)
    a, b2 = fused_block.bwd_coefficients(scale, var, eps, s1, s2, x3.numel())
    dw, dcb = entry_block_bwd_wgrad_reference(x, dout, conv_w, conv_b, scale, bias, mean, var, glu_w, glu_b, a, b2,
                                              pool, eps, mask, keep, layout)
    return dw, dcb, s2, s1, dgw, dgb


# ------------------------------------------------------ kernel wrappers


_entry = None  # the entry point a call came through, where that keeps counts of its own


@contextlib.contextmanager
def called_through(entry):
    """Launches made inside are counted on `entry` too (ops/crows_block.py
    wraps its calls in this; the backward of a block built inside repeats it)."""
    global _entry
    prev, _entry = _entry, entry
    try:
        yield
    finally:
        _entry = prev


def _tally(fn, counter: str, entry_counter: str = "", dtype=torch.float32):
    """One launch: on the wrapper's own count and, inside `called_through`,
    on that entry's `entry_counter` (named as `counter` when empty); the
    bfloat16 instantiation's on the counters named with `_bf16` added."""
    _build.count_launch(fn, counter, dtype)
    if _entry is not None:
        _build.count_launch(_entry, entry_counter or counter, dtype)


def _prepare(x, conv_w, conv_b, vecs, glu_w, pool, what: str):
    """Checked, contiguous device copies of what a kernel reads: x in its
    compute dtype, the conv weights rounded to it, the rest float32."""
    x = entry_conv._features(x).detach()
    C = conv_w.shape[-1]
    pool = tuple(int(p) for p in pool)
    if not entry_block_applicable((*x.shape, 1), pool, C):
        raise ValueError(f"{what} does not take x {tuple(x.shape)} with pool {pool} and {C} channels")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda tensors, got {x.device}")
    if x.device.type == "cpu":
        return x, conv_w, conv_b, vecs, glu_w, pool
    if x.dtype not in entry_conv.DTYPES.values():
        raise ValueError(f"{what}: x must be float32 or bfloat16, got {x.dtype}")
    w, cb = entry_conv._params_on({"w": conv_w, "b": conv_b}, x)
    vecs = [v.detach().to(device=x.device, dtype=torch.float32).contiguous() for v in vecs]
    gw = glu_w.detach().to(device=x.device, dtype=torch.float32).contiguous()
    if any(tuple(v.shape) != (C,) for v in vecs) or tuple(gw.shape) != (C, C):
        raise ValueError(f"{what}: per-channel vectors must be [{C}] and glu_w [{C}, {C}]")
    return x.contiguous(), w, cb, vecs, gw, pool


def _mask(seed, x, C, rate, pack_bits):
    return fused_block.dropout_keep_mask(seed, (*x.shape, C), rate, pack_bits=pack_bits) if rate > 0.0 else None


def entry_block_stats_apply(conv_params, x, compute_dtype=None):
    """K5s: x [B, T, F, 1] → per-channel (Σy, Σy²) of the entry conv output
    in the compute dtype (x's when None; the features are cast to it),
    float32, no graph, y never written (callers form mean and var from them
    and pass those on detached): the one-wave conv (`entry_conv.
    conv_run_plan`), the float32 sums of a thread's pixels of a tile added
    into float64 once a tile, folded in a fixed order (a run repeats bit for
    bit; in float32 not K4f's bits, whose kernel sums in float64 per pixel).
    CPU: the plain version."""
    x = entry_conv._features(x)
    x = x.to(entry_conv.compute_dtype_of(compute_dtype, x))
    if x.device.type == "cpu":
        return entry_conv.entry_conv_reference(conv_params, x)[1:]
    _, s1, s2 = entry_conv._launch(conv_params, x, "stats_only", "entry_block_stats_apply", wave=True)
    _tally(entry_block_stats_apply, "launches", dtype=x.dtype)
    return s1, s2


entry_block_stats_apply.launches = 0
entry_block_stats_apply.launches_bf16 = 0


def entry_block_fwd(x, conv_w, conv_b, scale, bias, mean, var, glu_w, glu_b, pool, eps, *,
                    rate: float = 0.0, seed=0, layout: str = "planes", pack_bits: Optional[bool] = None):
    """K5f, no graph: x [B, T, F(, 1)] features (float32 or bfloat16: the
    compute dtype) → pooled [B, T/pt, F/pf, C] in x's dtype; conv_w
    [3, 3, 1, C]; BN with the given mean/var; glu_w [C, C] as (in, out);
    dropout at `rate` from `seed` (int or integer tensor) when rate > 0, in
    the packed draw when `pack_bits`; `layout` picks the bfloat16 pool
    rounding. CPU: the plain version. CUDA: the kernel."""
    _check_layout(layout)
    x, w, cb, vecs, gw, pool = _prepare(x, conv_w, conv_b, (scale, bias, mean, var, glu_b), glu_w, pool,
                                        "entry_block_fwd")
    pack_bits = fused_block.pack_mode(pack_bits)
    threshold, keep_scale, packed = fused_block.dropout_args(rate, pack_bits)
    B, T, Fq = x.shape
    C = w.shape[-1]
    if x.device.type == "cpu":
        s, bi, mu, va, gb = vecs
        return reference_entry_block(x, w, cb, s, bi, mu, va, gw, gb, pool, eps, _mask(seed, x, C, rate, pack_bits),
                                     1.0 - rate, layout).detach()
    pt, pf = pool
    lib = _build.library()
    tiles = lib.dcase_bn_glu_pool_tiles(T, Fq, pt, pf)
    out = torch.empty((B, T // pt, Fq // pf, C), dtype=x.dtype, device=x.device)
    seed_t = fused_block._seed_tensor(seed, x.device)
    args = (x.data_ptr(), w.data_ptr(), cb.data_ptr(), *(v.data_ptr() for v in vecs[:4]), gw.data_ptr(),
            vecs[4].data_ptr(), out.data_ptr(), B, T, Fq, C, pt, pf, float(eps), seed_t.data_ptr(), threshold,
            keep_scale, packed)
    if x.dtype == torch.bfloat16:
        blocks = _build.wave_grid(_build.resident(x.device.index, "fwd_bf16", C), B, tiles)
        status = lib.dcase_entry_block_fwd_bf16(*args, blocks, int(layout == "crows"), _build.stream_handle(x.device))
    else:
        blocks = _build.wave_grid(_build.resident(x.device.index, "fwd_f32", C), B, tiles)
        status = lib.dcase_entry_block_fwd(*args, blocks, _build.stream_handle(x.device))
    _build.check(status, "entry_block_fwd")
    counter = "launches_train" if rate > 0.0 else "launches_eval"
    _tally(entry_block_fwd, counter, dtype=x.dtype)
    fused_block.count_packed(entry_block_fwd, packed)
    return out


entry_block_fwd.launches_eval = 0  # launches of the float32 forward kernel without dropout
entry_block_fwd.launches_train = 0  # launches with the dropout on (train mode)
entry_block_fwd.launches_eval_bf16 = 0  # the same, of the bfloat16 kernel
entry_block_fwd.launches_train_bf16 = 0
entry_block_fwd.launches_packed = 0  # train launches of either dtype that drew the packed mask


def _fwd_eval_fake(x, conv_w, conv_b, scale, bias, mean, var, glu_w, glu_b, pool, eps):
    B, T, Fq = entry_conv._features(x).shape
    return x.new_empty((B, T // pool[0], Fq // pool[1], conv_w.shape[-1]))


@torch.library.custom_op("dcase19_torch::entry_block_fwd_eval", mutates_args=())
def entry_block_fwd_eval(x: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, glu_w: torch.Tensor,
                         glu_b: torch.Tensor, pool: List[int], eps: float) -> torch.Tensor:
    """K5f at rate 0, layout "planes", as a torch.library op: the eval-mode
    CRNN's and the serving export's only way to the fused first block under
    `entry_block_pallas` (training keeps `entry_block_apply`); x in the
    compute dtype. The wrapper dispatches by x's device."""
    return entry_block_fwd(x, conv_w, conv_b, scale, bias, mean, var, glu_w, glu_b, pool, eps, layout="planes")


entry_block_fwd_eval.register_fake(_fwd_eval_fake)


def bf16_bwd_plan(channels: int, pool, which: int):
    """Shared memory of bfloat16 pass `which` (1: K5b1, 2: K5b2) at
    `channels` C and `pool` (pt, pf) → (buffers, drows, bytes), the channels
    padded to CP = 64 (C ≤ 64) or 128 in bfloat16 rows of RS = CP + 8
    (csrc/entry_block.cu bwd_bf16_smem): the y, A and D tiles [128][RS],
    `buffers` tiles of the pooled rows of dout [drows][RS] (drows =
    128 // (pt·pf)) and W [CP][RS], pass 2's patch matrix [16][136] too; the
    conv weights and bias [10][CP], six per-channel vectors [CP] (pass 2:
    eight), the pixel warp rows' sums [3][WM][CP] (pass 2: [WM][CP]; WM = 4
    warp rows) and the x tile [512] in float32; the keep
    bits [128][CP/4 + 4] bytes and the dout-row table [128] int32. Two dout
    buffers where they fit a block, else one."""
    cp = 64 if channels <= 64 else 128
    rs, wm = cp + 8, 4  # 8 warps at CP = 64, 16 at 128: cp / 32 warp columns, four warp rows
    drows = _TILE_PIXELS // (pool[0] * pool[1])
    for buffers in (2, 1):
        halves = rs * (3 * _TILE_PIXELS + buffers * drows + cp) + (16 * (_TILE_PIXELS + 8) if which == 2 else 0)
        floats = cp * (10 + (8 if which == 2 else 6) + (1 if which == 2 else 3) * wm) + 4 * _TILE_PIXELS
        nbytes = 2 * halves + 4 * floats + _TILE_PIXELS * (cp // 4 + 4) + 4 * _TILE_PIXELS
        if nbytes <= _build.MAX_SHARED:
            return buffers, drows, nbytes
    raise ValueError(f"bfloat16 pass {which} does not fit {channels} channels at pool {tuple(pool)}")


def f32_reduce_plan(channels: int, pool):
    """Shared memory of the float32 pass 1 (K5b1) at `channels` C and `pool`
    (pt, pf) → (buffers, drows, bytes), the channels padded to CP = 64 (C ≤
    64) or 128 in rows of KS = CP + 4 floats (csrc/entry_block.cu
    red_entry_smem): the x-hat and dlin tiles [128][KS], `buffers` tiles of
    the pooled rows of dout [drows][KS] (drows = 128 // (pt·pf)), W
    [CP][CP], seven per-channel vectors [CP], the conv weights and bias
    [10][CP], `buffers` x tiles [512] and two pixel tables [128] of int32.
    Two buffers where they fit a block, else one, else one with drows = 0
    (dout read from device memory)."""
    cp = 64 if channels <= 64 else 128
    rows = _TILE_PIXELS // (pool[0] * pool[1])
    for buffers, drows in ((2, rows), (1, rows), (1, 0)):
        nbytes = 4 * ((2 * _TILE_PIXELS + buffers * drows) * (cp + 4) + cp * cp + 17 * cp + buffers * 4 * _TILE_PIXELS
                      + 2 * _TILE_PIXELS)
        if nbytes <= _build.MAX_SHARED:
            return buffers, drows, nbytes
    raise ValueError(f"the float32 pass 1 does not fit {channels} channels at pool {tuple(pool)}")


def f32_wgrad_plan(channels: int, pool):
    """Shared memory of the float32 pass 2 (K5b2) at `channels` C and `pool`
    (pt, pf) → (buffers, drows, bytes), the channels padded to CP = 64 (C ≤
    64) or 128 in rows of KS = CP + 4 floats (csrc/entry_block.cu
    wgrad_entry_smem): the y − mean (then dy) and dlin tiles [128][KS],
    `buffers` tiles of the pooled rows of dout [drows][KS] (drows = 128 //
    (pt·pf)), W [CP][CP], six per-channel vectors [CP], the conv weights and
    bias [10][CP], `buffers` x tiles [512] and two pixel tables [128] of
    int32. Two buffers where they fit a block, else one, else one with drows
    = 0 (dout read from device memory). At C ≤ 64 two blocks of 8 warps fit
    an SM with two buffers."""
    cp = 64 if channels <= 64 else 128
    rows = _TILE_PIXELS // (pool[0] * pool[1])
    for buffers, drows in ((2, rows), (1, rows), (1, 0)):
        nbytes = 4 * ((2 * _TILE_PIXELS + buffers * drows) * (cp + 4) + cp * cp + 16 * cp + buffers * 4 * _TILE_PIXELS
                      + 2 * _TILE_PIXELS)
        if nbytes <= _build.MAX_SHARED:
            return buffers, drows, nbytes
    raise ValueError(f"the float32 pass 2 does not fit {channels} channels at pool {tuple(pool)}")


def fwd_f32_plan(channels: int) -> int:
    """Shared memory of the float32 forward (K5f) at `channels` C, in bytes,
    the channels padded to CP = 64 (C ≤ 64) or 128 in rows of CP + 4 floats
    (csrc/entry_block.cu fwd_entry_smem): one x-hat tile [128] rows (the
    conv computes it, so no second buffer hides a load), W' [CP][CP], four
    per-channel vectors, the conv weights and bias [14][CP], two x tiles
    [512] and the pixel table [128] of int32. The pool does not enter it.
    58 KB at C ≤ 64 (two blocks an SM, as the registers allow), 142 KB at
    C ≤ 128."""
    cp = 64 if channels <= 64 else 128
    return 4 * (_TILE_PIXELS * (cp + 4) + cp * cp + 14 * cp + 2 * 4 * _TILE_PIXELS + _TILE_PIXELS)


def fwd_bf16_plan(channels: int) -> int:
    """Shared memory of the bfloat16 forward (K5f) at `channels` C, in bytes,
    the channels padded to CP = 64 (C ≤ 64) or 128 in bfloat16 rows of RS =
    CP + 8 (csrc/entry_block.cu fwd_bf16_smem): the y and A tiles [128][RS]
    (the float32 g tile overlays both) and W [CP][RS]; five per-channel
    vectors, the conv weights and bias [15][CP] and the x tile [512] in
    float32. The pool does not enter it."""
    cp = 64 if channels <= 64 else 128
    return 2 * (cp + 8) * (2 * _TILE_PIXELS + cp) + 4 * (15 * cp + 4 * _TILE_PIXELS)


def _check_dout(x, dout, pool, C):
    B, T, Fq = x.shape
    if tuple(dout.shape) != (B, T // pool[0], Fq // pool[1], C):
        raise ValueError(f"dout {tuple(dout.shape)} is not the pooled shape of x {tuple(x.shape)} with {C} channels")
    return dout.detach().to(x.dtype).contiguous()


def entry_block_bwd_reduce(x, dout, conv_w, conv_b, scale, bias, mean, var, glu_w, glu_b, pool, eps, *,
                           rate: float = 0.0, seed=0, pack_bits: Optional[bool] = None):
    """K5b1: recompute conv, chain and mask per pixel tile → (d glu_w [C, C],
    d glu_b, S1, S2 [C]) in float32; dout comes in x's dtype. Per-slot
    partial sums are folded in a fixed order (no float atomics): in float32
    the slots of K2b's float32 reduce pass (`fused_block.bwd_reduce`), whose
    bits it gives on the same y, dout and seed; in bfloat16 one a block. CPU:
    the plain version."""
    x, w, cb, vecs, gw, pool = _prepare(x, conv_w, conv_b, (scale, bias, mean, var, glu_b), glu_w, pool,
                                        "entry_block_bwd_reduce")
    pack_bits = fused_block.pack_mode(pack_bits)
    threshold, keep_scale, packed = fused_block.dropout_args(rate, pack_bits)
    B, T, Fq = x.shape
    C = w.shape[-1]
    dout = _check_dout(x, dout, pool, C)
    if x.device.type == "cpu":
        s, bi, mu, va, gb = vecs
        return entry_block_bwd_reduce_reference(x, dout, w, cb, s, bi, mu, va, gw, gb, pool, eps,
                                                _mask(seed, x, C, rate, pack_bits), 1.0 - rate)
    pt, pf = pool
    lib = _build.library()
    bf16 = x.dtype == torch.bfloat16
    tiles = lib.dcase_bn_glu_pool_tiles(T, Fq, pt, pf)
    if bf16:
        buffers, drows, _ = bf16_bwd_plan(C, pool, 1)
        resident = _build.resident(x.device.index, "bwd_bf16", C, 1, buffers, drows)
        blocks = slots = _build.wave_grid(resident, B, tiles)
        plan = (blocks, buffers, drows)
    else:  # the slots of K2b's float32 reduce pass, over one wave of blocks
        buffers, drows, _ = f32_reduce_plan(C, pool)
        tps = fused_block._tiles_per_block(tiles, B, fused_block._TARGET_BLOCKS_BWD)
        slots = B * -(-tiles // tps)
        blocks = _build.wave_grid(_build.resident(x.device.index, "reduce_f32", C, buffers, drows), 1, slots)
        plan = (blocks, tps, buffers, drows)
    width = C * C + 3 * C
    partials = torch.empty((slots, width), dtype=torch.float32, device=x.device)
    sums = torch.empty(width, dtype=torch.float32, device=x.device)
    seed_t = fused_block._seed_tensor(seed, x.device)
    args = (x.data_ptr(), dout.data_ptr(), w.data_ptr(), cb.data_ptr(), *(v.data_ptr() for v in vecs[:4]),
            gw.data_ptr(), vecs[4].data_ptr(), partials.data_ptr(), sums.data_ptr(), B, T, Fq, C, pt, pf, float(eps),
            seed_t.data_ptr(), threshold, keep_scale, packed)
    entry = lib.dcase_entry_block_bwd_reduce_bf16 if bf16 else lib.dcase_entry_block_bwd_reduce
    status = entry(*args, *plan, _build.stream_handle(x.device))
    _build.check(status, "entry_block_bwd_reduce")
    _tally(entry_block_bwd_reduce, "launches", "launches_bwd_reduce", x.dtype)
    fused_block.count_packed(entry_block_bwd_reduce, packed)
    return sums[: C * C].view(C, C), sums[C * C: C * C + C], sums[C * C + C: C * C + 2 * C], sums[C * C + 2 * C:]


entry_block_bwd_reduce.launches = 0
entry_block_bwd_reduce.launches_bf16 = 0
entry_block_bwd_reduce.launches_packed = 0


def _launch_bwd_wgrad(x, dout, conv_w, conv_b, scale, bias, mean, var, glu_w, glu_b, a, b2, pool, eps, rate, seed,
                      layout, pack_bits):
    """Check, launch the kernel and its fold → (dW, d conv_b, the per-block
    slots [parts, slots, 10·C] float32 the fold read); on a CPU tensor
    (None, the arguments the plain versions take)."""
    _check_layout(layout)
    x, w, cb, vecs, gw, pool = _prepare(x, conv_w, conv_b, (scale, bias, mean, var, glu_b, a, b2), glu_w, pool,
                                        "entry_block_bwd_wgrad")
    pack_bits = fused_block.pack_mode(pack_bits)
    threshold, keep_scale, packed = fused_block.dropout_args(rate, pack_bits)
    B, T, Fq = x.shape
    C = w.shape[-1]
    dout = _check_dout(x, dout, pool, C)
    if x.device.type == "cpu":
        s, bi, mu, va, gb, av, bv = vecs
        return None, (x, dout, w, cb, s, bi, mu, va, gw, gb, av, bv, pool, eps, _mask(seed, x, C, rate, pack_bits),
                      1.0 - rate, layout)
    pt, pf = pool
    bf16 = x.dtype == torch.bfloat16
    # 0: one part; 1: output-frequency parity; 2: batch halves (kernel and fold)
    partition = 0 if not bf16 else 2 if layout == "crows" else 1 if Fq % 2 == 0 else 0
    if partition == 2 and B % 2:
        raise ValueError(f"entry_block_bwd_wgrad: the crows layout splits an even batch, got {B} clips")
    lib = _build.library()
    tiles = lib.dcase_bn_glu_pool_tiles(T, Fq, pt, pf)
    if bf16:
        buffers, drows, _ = bf16_bwd_plan(C, pool, 2)
        resident = _build.resident(x.device.index, "bwd_bf16", C, 2, buffers, drows)
        slots = _build.wave_grid(resident, B, tiles, partition == 2)
    else:
        buffers, drows, _ = f32_wgrad_plan(C, pool)
        slots = _build.wave_grid(_build.resident(x.device.index, "wgrad_f32", C, buffers, drows), B, tiles)
    partials = torch.empty((slots, (2 if partition == 1 else 1) * 10 * C), dtype=torch.float32, device=x.device)
    sums = torch.empty(10 * C, dtype=torch.float32, device=x.device)
    seed_t = fused_block._seed_tensor(seed, x.device)
    args = (x.data_ptr(), dout.data_ptr(), w.data_ptr(), cb.data_ptr(), *(v.data_ptr() for v in vecs[:4]),
            gw.data_ptr(), vecs[4].data_ptr(), vecs[5].data_ptr(), vecs[6].data_ptr(), partials.data_ptr(),
            sums.data_ptr(), B, T, Fq, C, pt, pf, float(eps), seed_t.data_ptr(), threshold, keep_scale, packed)
    if bf16:
        status = lib.dcase_entry_block_bwd_wgrad_bf16(*args, slots, buffers, drows, partition,
                                                      _build.stream_handle(x.device))
    else:
        status = lib.dcase_entry_block_bwd_wgrad(*args, slots, buffers, drows, _build.stream_handle(x.device))
    _build.check(status, "entry_block_bwd_wgrad")
    _tally(entry_block_bwd_wgrad, "launches", "launches_bwd_wgrad", x.dtype)
    fused_block.count_packed(entry_block_bwd_wgrad, packed)
    if partition == 2:  # the slots of the first half of the clips, then of the second
        parts = partials.view(2, slots // 2, 10 * C)
    else:
        parts = partials.view(slots, -1, 10 * C).transpose(0, 1)
    return (sums[: 9 * C].view(3, 3, 1, C), sums[9 * C:], parts), None


def entry_block_bwd_wgrad(x, dout, conv_w, conv_b, scale, bias, mean, var, glu_w, glu_b, a, b2, pool, eps, *,
                          rate: float = 0.0, seed=0, layout: str = "planes", pack_bits: Optional[bool] = None):
    """K5b2: recompute conv, chain, mask and dxn; dy = inv·γ·dxn − a −
    (y − mean)·b2 stays on the chip → (dW [3, 3, 1, C], d conv_b [C]) in
    float32, one slot a block folded in slot order. bfloat16: dW is the gradient of the
    bfloat16 weights, rounded in the two parts of `layout` (output-frequency
    parity, or batch halves under "crows") before they are added. CPU: the
    plain version."""
    out, plain = _launch_bwd_wgrad(x, dout, conv_w, conv_b, scale, bias, mean, var, glu_w, glu_b, a, b2, pool, eps,
                                   rate, seed, layout, pack_bits)
    return entry_block_bwd_wgrad_reference(*plain) if out is None else out[:2]


def entry_block_bwd_wgrad_parts(x, dout, conv_w, conv_b, scale, bias, mean, var, glu_w, glu_b, a, b2, pool, eps, *,
                                rate: float = 0.0, seed=0, layout: str = "planes", pack_bits: Optional[bool] = None):
    """`entry_block_bwd_wgrad`'s (dW, d conv_b) and, from the same launch,
    the float32 dW sums of the parts it rounds apart, [parts, 3, 3, 1, C],
    folded from the kernel's per-block slots by `_build.fold_parts`: dW is,
    bit for bit, the sum in part order of each part rounded to x's dtype.
    For checks on the card that the kernel splits the sum as the original
    does. CPU: the plain versions."""
    out, plain = _launch_bwd_wgrad(x, dout, conv_w, conv_b, scale, bias, mean, var, glu_w, glu_b, a, b2, pool, eps,
                                   rate, seed, layout, pack_bits)
    if out is None:
        dw, dcb = entry_block_bwd_wgrad_reference(*plain)
        parts = entry_block_bwd_wgrad_parts_reference(*plain) if plain[0].dtype == torch.bfloat16 else [dw]
        return dw, dcb, torch.stack(parts)
    dw, dcb, slots = out
    C = dw.shape[-1]
    return dw, dcb, _build.fold_parts(slots)[:, : 9 * C].view(-1, 3, 3, 1, C)


entry_block_bwd_wgrad.launches = 0
entry_block_bwd_wgrad.launches_bf16 = 0
entry_block_bwd_wgrad.launches_packed = 0


# ------------------------------------------------------- autograd Function


class _EntryBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, conv_w, conv_b, scale, bias, mean, var, glu_w, glu_b, seed, rate, pool, eps, train, layout,
                pack_bits, mesh):
        rate = float(rate) if train else 0.0
        seed = torch.as_tensor(seed, dtype=torch.int64).reshape(1).clone()
        ctx.save_for_backward(x, conv_w, conv_b, scale, bias, mean, var, glu_w, glu_b, seed)
        ctx.rate, ctx.pool, ctx.eps, ctx.entry = rate, tuple(int(p) for p in pool), float(eps), _entry
        ctx.layout, ctx.pack_bits = layout, bool(pack_bits)  # the backward regenerates this forward's mask
        ctx.mesh = mesh
        return entry_block_fwd(x, conv_w, conv_b, scale, bias, mean, var, glu_w, glu_b, pool, eps,
                               rate=rate, seed=seed, layout=layout, pack_bits=ctx.pack_bits)

    @staticmethod
    def backward(ctx, dout):
        x, conv_w, conv_b, scale, bias, mean, var, glu_w, glu_b, seed = ctx.saved_tensors
        args = (x, dout.to(x.dtype).contiguous(), conv_w, conv_b, scale, bias, mean, var, glu_w, glu_b)
        kw = dict(rate=ctx.rate, seed=seed, pack_bits=ctx.pack_bits)
        with called_through(ctx.entry):
            dgw, dgb, s1, s2 = entry_block_bwd_reduce(*args, ctx.pool, ctx.eps, **kw)
            # between the passes: the through-statistics coefficients from the
            # global batch's S1, S2 and n (JAX fused_entry_block.py:352-356)
            s1g, s2g, n = fused_block.global_sums(s1, s2, x.numel(), ctx.mesh)
            a, b2 = fused_block.bwd_coefficients(scale.detach().to(torch.float32), var.to(torch.float32), ctx.eps,
                                                 s1g, s2g, n)
            dw, dcb = entry_block_bwd_wgrad(*args, a, b2, ctx.pool, ctx.eps, layout=ctx.layout, **kw)
        # x carries no gradient; dscale = S2, dbias = S1 (this rank's sums);
        # mean/var are detached inputs; seed, rate, pool, eps, train, layout,
        # pack_bits and the mesh take none
        return None, dw, dcb, s2, s1, None, None, dgw, dgb, None, None, None, None, None, None, None, None


def entry_block_apply(conv_params, scale, bias, mean, var, glu_w, glu_b, x, seed, rate: float,
                      pool: Tuple[int, int], eps: float, train: bool, compute_dtype=None, layout: str = "planes",
                      pack_bits: Optional[bool] = None, mesh=None):
    """The fused first block with its exact backward: x [B, T, F, 1] + conv
    {"w": [3, 3, 1, C], "b": [C]} + [C] BatchNorm vectors + [C, C] GLU
    weight (in, out) → pooled [B, T/pt, F/pf, C] in the compute dtype (x's
    when None; the features are cast to it).

    mean/var: the batch statistics of the conv output (from
    `entry_block_stats_apply`) or the running ones, passed WITHOUT a graph.
    seed: int or integer tensor, new each step; `train` switches the dropout
    on (rate is ignored in eval mode). `layout`: whose bfloat16 roundings to
    reproduce, "planes" (this module's original) or "crows". `pack_bits`:
    the dropout draw (default `fused_block.PACK_BITS`, read here). Under a
    data-parallel `mesh` mean/var are the global batch's, and the backward
    sums S1, S2 over the ranks between K5b1 and K5b2."""
    _check_layout(layout)
    if mean.requires_grad or var.requires_grad:
        raise ValueError("mean and var must be detached: the backward already carries the "
                         "through-statistics terms")
    x = entry_conv._features(x)
    x = x.to(entry_conv.compute_dtype_of(compute_dtype, x))
    return _EntryBlock.apply(x, conv_params["w"], conv_params["b"], scale, bias, mean, var,
                             glu_w, glu_b, seed, rate, pool, eps, train, layout, fused_block.pack_mode(pack_bits), mesh)
