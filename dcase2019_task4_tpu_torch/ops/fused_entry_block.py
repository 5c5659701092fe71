"""K5: the whole first CRNN block, conv(1 → C) → BatchNorm → GLU → dropout →
avg-pool, as fused kernels whose conv output never reaches device memory,
forward and backward.

PyTorch counterpart of dcase2019_task4_tpu/ops/fused_entry_block.py. On a
CUDA tensor every wrapper launches its hand-written kernel in
csrc/entry_block.cu (or raises); on a CPU tensor it runs the plain PyTorch
version beside it:

  wrapper                  kernel                                  plain version
  entry_block_stats_apply  entry_conv_kernel<1> + fold             entry_conv_reference (sums)
  entry_block_fwd          entry_block_fwd_kernel                  reference_entry_block
  entry_block_bwd_reduce   entry_block_bwd_reduce_kernel + fold    entry_block_bwd_reduce_reference
  entry_block_bwd_wgrad    entry_block_bwd_wgrad_kernel + fold     entry_block_bwd_wgrad_reference

`entry_block_apply` ties them into one `torch.autograd.Function` with the
contract of `fused_block.fused_bn_glu_dropout_pool`: mean and var come in
detached (the batch statistics from `entry_block_stats_apply`, or the
running ones in eval mode) and the backward carries the whole
BatchNorm-training backward. It runs in two passes with a host-side step
between them, `fused_block.bwd_coefficients` on the folded S1 and S2, which
is where a data-parallel run would all-reduce them. d scale = S2 and
d bias = S1. The features carry no gradient.

The dropout mask is the fused block's: Philox4x32-10 on (seed, global
element index of the [B, T, F, C] conv output / 4). So this block with a
seed equals conv → `fused_bn_glu_dropout_pool` with that seed, outputs and
gradients, and `fused_block.dropout_keep_mask` is the CPU twin of both. The
parity planes, the patch basis and the lane-tiled, block-diagonal
parameters of the original are TPU layout and are not ported.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import torch

from dcase2019_task4_tpu_torch.ops import _build, entry_conv, fused_block

_TARGET_BLOCKS = 1056  # forward: 8 resident blocks on each of the H100's 132 SMs
_TARGET_BLOCKS_BWD = 528  # backward: one partial slot per block, folded in fixed order


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


def reference_entry_block(x, conv_w, conv_b, scale, bias, mean, var, glu_w, glu_b, pool, eps,
                          mask=None, keep: float = 1.0):
    """Plain version of K5f: x [B, T, F(, 1)], conv_w [3, 3, 1, C] → pooled
    [B, T/pt, F/pf, C] (conv, then `fused_block.reference_block`)."""
    return fused_block.reference_block(_conv(x, conv_w, conv_b), scale, bias, mean, var, glu_w, glu_b,
                                       pool, eps, mask, keep)


def entry_block_bwd_reduce_reference(x, dout, conv_w, conv_b, scale, bias, mean, var, glu_w, glu_b, pool, eps,
                                     mask=None, keep: float = 1.0):
    """Plain version of pass 1, in formulas: → (d glu_w [C, C], d glu_b, S1 =
    Σdxn, S2 = Σdxn·x̂)."""
    y = _conv(x, conv_w, conv_b).detach()
    _, dgw, dgb, s1, s2 = fused_block.bwd_reduce_reference(y, dout, scale, bias, mean, var, glu_w, glu_b,
                                                           pool, eps, mask, keep)
    return dgw, dgb, s1, s2


def entry_block_bwd_wgrad_reference(x, dout, conv_w, conv_b, scale, bias, mean, var, glu_w, glu_b, a, b2,
                                    pool, eps, mask=None, keep: float = 1.0):
    """Plain version of pass 2: dy = inv·γ·dxn − a − (y − mean)·b2, then
    dW = patchesᵀ·dy and d conv_b = Σdy → (dW [3, 3, 1, C], d conv_b [C])."""
    y = _conv(x, conv_w, conv_b).detach()
    dyp = fused_block.bwd_reduce_reference(y, dout, scale, bias, mean, var, glu_w, glu_b, pool, eps, mask, keep)[0]
    return entry_conv.entry_conv_wgrad_reference(x, fused_block.bwd_fixup_reference(y, dyp, a, b2, mean))


def entry_block_bwd_reference(x, dout, conv_w, conv_b, scale, bias, mean, var, glu_w, glu_b, pool, eps,
                              mask=None, keep: float = 1.0):
    """The whole backward in formulas (no autograd), with mean/var the batch
    statistics of the conv output: → (dW, d conv_b, dscale, dbias, d glu_w,
    d glu_b)."""
    y = _conv(x, conv_w, conv_b).detach()
    dy, dscale, dbias, dgw, dgb = fused_block.bwd_reference(y, dout, scale, bias, mean, var, glu_w, glu_b,
                                                            pool, eps, mask, keep)
    dw, dcb = entry_conv.entry_conv_wgrad_reference(x, dy)
    return dw, dcb, dscale, dbias, dgw, dgb


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


def _tally(fn, counter: str, entry_counter: str = ""):
    """One launch: on the wrapper's own count and, inside `called_through`,
    on that entry's `entry_counter` (named as `counter` when empty)."""
    setattr(fn, counter, getattr(fn, counter) + 1)
    if _entry is not None:
        entry_counter = entry_counter or counter
        setattr(_entry, entry_counter, getattr(_entry, entry_counter) + 1)


def _prepare(x, conv_w, conv_b, vecs, glu_w, pool, what: str):
    """Checked, contiguous float32 device copies of what a kernel reads."""
    x = entry_conv._features(x).detach()
    C = conv_w.shape[-1]
    pool = tuple(int(p) for p in pool)
    if not entry_block_applicable((*x.shape, 1), pool, C):
        raise ValueError(f"{what} does not take x {tuple(x.shape)} with pool {pool} and {C} channels")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda tensors, got {x.device}")
    if x.device.type == "cpu":
        return x, conv_w, conv_b, vecs, glu_w, pool
    if x.dtype != torch.float32:
        raise ValueError(f"{what}: x must be float32, got {x.dtype}")
    w, cb = entry_conv._params_on({"w": conv_w, "b": conv_b}, x)
    vecs = [v.detach().to(device=x.device, dtype=torch.float32).contiguous() for v in vecs]
    gw = glu_w.detach().to(device=x.device, dtype=torch.float32).contiguous()
    if any(tuple(v.shape) != (C,) for v in vecs) or tuple(gw.shape) != (C, C):
        raise ValueError(f"{what}: per-channel vectors must be [{C}] and glu_w [{C}, {C}]")
    return x.contiguous(), w, cb, vecs, gw, pool


def _dropout_args(rate: float):
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    return (fused_block.dropout_threshold(rate) if rate > 0.0 else 0), float(1.0 / (1.0 - rate))


def _mask(seed, x, C, rate):
    return fused_block.dropout_keep_mask(seed, (*x.shape, C), rate) if rate > 0.0 else None


def entry_block_stats_apply(conv_params, x, compute_dtype=None):
    """K5s: x [B, T, F, 1] → per-channel (Σy, Σy²) of the entry conv output,
    float32, no graph, y never written (callers form mean and var from them
    and pass those on detached). CPU: the plain version."""
    entry_conv.check_float32(compute_dtype, "entry_block_stats_apply")
    if x.device.type == "cpu":
        return entry_conv.entry_conv_reference(conv_params, x)[1:]
    _, s1, s2 = entry_conv._launch(conv_params, x, "stats_only", "entry_block_stats_apply")
    _tally(entry_block_stats_apply, "launches")
    return s1, s2


entry_block_stats_apply.launches = 0


def entry_block_fwd(x, conv_w, conv_b, scale, bias, mean, var, glu_w, glu_b, pool, eps, *,
                    rate: float = 0.0, seed=0):
    """K5f, no graph: x [B, T, F(, 1)] features → pooled [B, T/pt, F/pf, C];
    conv_w [3, 3, 1, C]; BN with the given mean/var; glu_w [C, C] as (in,
    out); dropout at `rate` from `seed` (int or integer tensor) when
    rate > 0. CPU: the plain version. CUDA: the kernel."""
    x, w, cb, vecs, gw, pool = _prepare(x, conv_w, conv_b, (scale, bias, mean, var, glu_b), glu_w, pool,
                                        "entry_block_fwd")
    threshold, keep_scale = _dropout_args(rate)
    B, T, Fq = x.shape
    C = w.shape[-1]
    if x.device.type == "cpu":
        s, bi, mu, va, gb = vecs
        return reference_entry_block(x, w, cb, s, bi, mu, va, gw, gb, pool, eps, _mask(seed, x, C, rate),
                                     1.0 - rate).detach()
    pt, pf = pool
    lib = _build.library()
    out = torch.empty((B, T // pt, Fq // pf, C), dtype=torch.float32, device=x.device)
    seed_t = fused_block._seed_tensor(seed, x.device)
    status = lib.dcase_entry_block_fwd(
        x.data_ptr(), w.data_ptr(), cb.data_ptr(), *(v.data_ptr() for v in vecs[:4]), gw.data_ptr(),
        vecs[4].data_ptr(), out.data_ptr(), B, T, Fq, C, pt, pf, float(eps), seed_t.data_ptr(), threshold,
        keep_scale, fused_block._tiles_per_block(lib.dcase_bn_glu_pool_tiles(T, Fq, pt, pf), B, _TARGET_BLOCKS),
        _build.stream_handle(x.device),
    )
    _build.check(status, "entry_block_fwd")
    counter = "launches_train" if rate > 0.0 else "launches_eval"
    _tally(entry_block_fwd, counter)
    return out


entry_block_fwd.launches_eval = 0  # launches of the forward kernel without dropout
entry_block_fwd.launches_train = 0  # launches with the dropout on (train mode)


def _bwd_launch_geometry(lib, B, T, Fq, pool):
    tiles = lib.dcase_bn_glu_pool_tiles(T, Fq, *pool)
    tpb = fused_block._tiles_per_block(tiles, B, _TARGET_BLOCKS_BWD)
    return tpb, -(-tiles // tpb) * B


def _check_dout(x, dout, pool, C):
    B, T, Fq = x.shape
    if tuple(dout.shape) != (B, T // pool[0], Fq // pool[1], C):
        raise ValueError(f"dout {tuple(dout.shape)} is not the pooled shape of x {tuple(x.shape)} with {C} channels")
    return dout.detach().to(torch.float32).contiguous()


def entry_block_bwd_reduce(x, dout, conv_w, conv_b, scale, bias, mean, var, glu_w, glu_b, pool, eps, *,
                           rate: float = 0.0, seed=0):
    """K5b1: recompute conv, chain and mask per pixel tile → (d glu_w [C, C],
    d glu_b, S1, S2 [C]). Per-block partial sums are folded in a fixed order
    (no float atomics). CPU: the plain version."""
    x, w, cb, vecs, gw, pool = _prepare(x, conv_w, conv_b, (scale, bias, mean, var, glu_b), glu_w, pool,
                                        "entry_block_bwd_reduce")
    threshold, keep_scale = _dropout_args(rate)
    B, T, Fq = x.shape
    C = w.shape[-1]
    dout = _check_dout(x, dout, pool, C)
    if x.device.type == "cpu":
        s, bi, mu, va, gb = vecs
        return entry_block_bwd_reduce_reference(x, dout, w, cb, s, bi, mu, va, gw, gb, pool, eps,
                                                _mask(seed, x, C, rate), 1.0 - rate)
    pt, pf = pool
    lib = _build.library()
    tpb, slots = _bwd_launch_geometry(lib, B, T, Fq, pool)
    width = C * C + 3 * C
    partials = torch.empty((slots, width), dtype=torch.float32, device=x.device)
    sums = torch.empty(width, dtype=torch.float32, device=x.device)
    seed_t = fused_block._seed_tensor(seed, x.device)
    status = lib.dcase_entry_block_bwd_reduce(
        x.data_ptr(), dout.data_ptr(), w.data_ptr(), cb.data_ptr(), *(v.data_ptr() for v in vecs[:4]),
        gw.data_ptr(), vecs[4].data_ptr(), partials.data_ptr(), sums.data_ptr(), B, T, Fq, C, pt, pf, float(eps),
        seed_t.data_ptr(), threshold, keep_scale, tpb, _build.stream_handle(x.device),
    )
    _build.check(status, "entry_block_bwd_reduce")
    _tally(entry_block_bwd_reduce, "launches", "launches_bwd_reduce")
    return sums[: C * C].view(C, C), sums[C * C: C * C + C], sums[C * C + C: C * C + 2 * C], sums[C * C + 2 * C:]


entry_block_bwd_reduce.launches = 0


def entry_block_bwd_wgrad(x, dout, conv_w, conv_b, scale, bias, mean, var, glu_w, glu_b, a, b2, pool, eps, *,
                          rate: float = 0.0, seed=0):
    """K5b2: recompute conv, chain, mask and dxn; dy = inv·γ·dxn − a −
    (y − mean)·b2 stays in registers → (dW [3, 3, 1, C], d conv_b [C]), folded
    in a fixed order. CPU: the plain version."""
    x, w, cb, vecs, gw, pool = _prepare(x, conv_w, conv_b, (scale, bias, mean, var, glu_b, a, b2), glu_w, pool,
                                        "entry_block_bwd_wgrad")
    threshold, keep_scale = _dropout_args(rate)
    B, T, Fq = x.shape
    C = w.shape[-1]
    dout = _check_dout(x, dout, pool, C)
    if x.device.type == "cpu":
        s, bi, mu, va, gb, av, bv = vecs
        return entry_block_bwd_wgrad_reference(x, dout, w, cb, s, bi, mu, va, gw, gb, av, bv, pool, eps,
                                               _mask(seed, x, C, rate), 1.0 - rate)
    pt, pf = pool
    lib = _build.library()
    tpb, slots = _bwd_launch_geometry(lib, B, T, Fq, pool)
    partials = torch.empty((slots, 10 * C), dtype=torch.float32, device=x.device)
    sums = torch.empty(10 * C, dtype=torch.float32, device=x.device)
    seed_t = fused_block._seed_tensor(seed, x.device)
    status = lib.dcase_entry_block_bwd_wgrad(
        x.data_ptr(), dout.data_ptr(), w.data_ptr(), cb.data_ptr(), *(v.data_ptr() for v in vecs[:4]),
        gw.data_ptr(), vecs[4].data_ptr(), vecs[5].data_ptr(), vecs[6].data_ptr(), partials.data_ptr(),
        sums.data_ptr(), B, T, Fq, C, pt, pf, float(eps), seed_t.data_ptr(), threshold, keep_scale, tpb,
        _build.stream_handle(x.device),
    )
    _build.check(status, "entry_block_bwd_wgrad")
    _tally(entry_block_bwd_wgrad, "launches", "launches_bwd_wgrad")
    return sums[: 9 * C].view(3, 3, 1, C), sums[9 * C:]


entry_block_bwd_wgrad.launches = 0


# ------------------------------------------------------- autograd Function


class _EntryBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, conv_w, conv_b, scale, bias, mean, var, glu_w, glu_b, seed, rate, pool, eps, train):
        rate = float(rate) if train else 0.0
        seed = torch.as_tensor(seed, dtype=torch.int64).reshape(1).clone()
        ctx.save_for_backward(x, conv_w, conv_b, scale, bias, mean, var, glu_w, glu_b, seed)
        ctx.rate, ctx.pool, ctx.eps, ctx.entry = rate, tuple(int(p) for p in pool), float(eps), _entry
        return entry_block_fwd(x, conv_w, conv_b, scale, bias, mean, var, glu_w, glu_b, pool, eps,
                               rate=rate, seed=seed)

    @staticmethod
    def backward(ctx, dout):
        x, conv_w, conv_b, scale, bias, mean, var, glu_w, glu_b, seed = ctx.saved_tensors
        args = (x, dout.contiguous(), conv_w, conv_b, scale, bias, mean, var, glu_w, glu_b)
        kw = dict(rate=ctx.rate, seed=seed)
        with called_through(ctx.entry):
            dgw, dgb, s1, s2 = entry_block_bwd_reduce(*args, ctx.pool, ctx.eps, **kw)
            # between the passes: the through-statistics coefficients from the
            # whole S1, S2 (a data-parallel run all-reduces them here)
            a, b2 = fused_block.bwd_coefficients(scale.detach().to(torch.float32), var.to(torch.float32), ctx.eps,
                                                 s1, s2, x.numel())
            dw, dcb = entry_block_bwd_wgrad(*args, a, b2, ctx.pool, ctx.eps, **kw)
        # x carries no gradient; dscale = S2, dbias = S1; mean/var are
        # detached inputs; seed, rate, pool, eps, train take none
        return None, dw, dcb, s2, s1, None, None, dgw, dgb, None, None, None, None, None


def entry_block_apply(conv_params, scale, bias, mean, var, glu_w, glu_b, x, seed, rate: float,
                      pool: Tuple[int, int], eps: float, train: bool, compute_dtype=None):
    """The fused first block with its exact backward: x [B, T, F, 1] + conv
    {"w": [3, 3, 1, C], "b": [C]} + [C] BatchNorm vectors + [C, C] GLU
    weight (in, out) → pooled [B, T/pt, F/pf, C].

    mean/var: the batch statistics of the conv output (from
    `entry_block_stats_apply`) or the running ones, passed WITHOUT a graph.
    seed: int or integer tensor, new each step; `train` switches the dropout
    on (rate is ignored in eval mode)."""
    entry_conv.check_float32(compute_dtype, "entry_block_apply")
    if mean.requires_grad or var.requires_grad:
        raise ValueError("mean and var must be detached: the backward already carries the "
                         "through-statistics terms")
    return _EntryBlock.apply(entry_conv._features(x), conv_params["w"], conv_params["b"], scale, bias, mean, var,
                             glu_w, glu_b, seed, rate, pool, eps, train)
