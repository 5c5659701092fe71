"""K2: BatchNorm → GLU → dropout → avg-pool, forward and backward, and the
per-channel batch statistics that feed it.

PyTorch counterpart of dcase2019_task4_tpu/ops/fused_block.py. On a CUDA
tensor every wrapper launches its hand-written kernel in
csrc/fused_block.cu (or raises); on a CPU tensor it runs the plain PyTorch
version beside it:

  wrapper                     kernel(s)                      plain version
  fused_bn_glu_pool           bn_glu_pool_kernel             reference_block
  batch_stats                 stats_kernel + fold            batch_stats_reference
  bwd_reduce                  bn_glu_pool_bwd_kernel + fold  bwd_reference (first half)
  bwd_fixup                   bn_bwd_fixup_kernel            bwd_reference (second half)

`fused_bn_glu_dropout_pool` ties them into one `torch.autograd.Function`
with the JAX contract: mean and var come in detached (the batch statistics
of y, or the running ones in eval mode) and the backward carries the whole
BatchNorm-training backward, through-statistics terms included, so callers
must not also differentiate the statistics.

Dropout: the keep-mask comes from Philox4x32-10 keyed on the seed, with the
counter the global element index of y divided by four (one call gives the
mask of four neighbouring channels). It depends on nothing but (seed,
element index, rate): not on tiling, launch geometry or device. The mask is
never stored; the backward regenerates it. `dropout_keep_mask` is the same
generator in integer tensor ops and is bit-equal to the kernels' mask. It
matches neither of the JAX package's masks (TPU hardware bits compiled, a
hash in the packed layout interpreted), so parity with JAX is held at rate 0
or with an injected mask.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from dcase2019_task4_tpu_torch.ops import _build

_TILE_PIXELS = 128  # csrc/fused_block.cu kPix
_TARGET_BLOCKS = 1056  # forward: 8 resident blocks on each of the H100's 132 SMs
_TARGET_BLOCKS_BWD = 528  # backward and statistics: partial slots folded in fixed order

_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF


def applicable(shape, pool: Tuple[int, int]) -> bool:
    """Whether the fused block takes a [B, T, F, C] activation: whole
    pooling windows (T % pt == F % pf == 0), a pooling row of at most one
    pixel tile, and C ≤ 128 in whole groups of four (one Philox call masks
    four channels)."""
    B, T, Fq, C = shape
    pt, pf = pool
    return T % pt == 0 and Fq % pf == 0 and pt * Fq <= _TILE_PIXELS and C <= 128 and C % 4 == 0


# --------------------------------------------------------- plain versions


def _mulhilo(a: torch.Tensor, m: int):
    """32×32 → (high, low) 32-bit halves of the product, on uint32 values
    held in int64 tensors (16-bit split keeps every term below 2**63)."""
    p0 = (a & 0xFFFF) * m
    p1 = (a >> 16) * m
    low = ((p1 & 0xFFFF) << 16) + p0
    return (p1 >> 16) + (low >> 32), low & _U32


def philox4x32(counter: torch.Tensor, seed) -> torch.Tensor:
    """Philox4x32-10 on counters (c, c >> 32, 0, 0) with key (seed,
    seed >> 32): int64 [n] → uint32 words in an int64 [n, 4] tensor. `seed`
    is an int or an integer tensor (any device; moved to the counters')."""
    seed = torch.as_tensor(seed, dtype=torch.int64).to(counter.device).reshape(())
    k0, k1 = seed & _U32, (seed >> 32) & _U32
    c0, c1 = counter & _U32, (counter >> 32) & _U32
    c2, c3 = torch.zeros_like(c0), torch.zeros_like(c0)
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, _PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W0) & _U32, (k1 + _PHILOX_W1) & _U32
    return torch.stack([c0, c1, c2, c3], dim=-1)


def dropout_threshold(rate: float) -> int:
    """An element is kept iff its 32 random bits are ≥ this (P = 1 − rate)."""
    return min(int(rate * 2 ** 32), 2 ** 32 - 1)


def dropout_keep_mask(seed, shape, rate: float, device=None) -> torch.Tensor:
    """The kernels' keep-mask as a float32 0/1 tensor of `shape`: element e
    (row-major index) reads word e % 4 of philox4x32(e // 4, seed)."""
    n = 1
    for s in shape:
        n *= int(s)
    if device is None:
        device = seed.device if isinstance(seed, torch.Tensor) else "cpu"
    counters = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    bits = philox4x32(counters, seed).reshape(-1)[:n]
    return (bits >= dropout_threshold(rate)).to(torch.float32).reshape(tuple(shape))


def reference_block(y, scale, bias, mean, var, glu_w, glu_b, pool, eps, mask=None, keep: float = 1.0):
    """Plain version: BN→GLU→(given mask) dropout→avg-pool on [B, T, F, C]
    (glu_w [in, out])."""
    inv = torch.rsqrt(var + eps)
    xn = (y - mean) * inv * scale + bias
    g = (xn @ glu_w + glu_b) * torch.sigmoid(xn)
    if mask is not None:
        g = g * mask / keep
    B, T, Fq, C = g.shape
    pt, pf = pool
    return g.reshape(B, T // pt, pt, Fq // pf, pf, C).mean(dim=(2, 4))


def batch_stats_reference(y: torch.Tensor):
    """Plain version of K2s: per-channel (Σy, Σy²) of [B, T, F, C], float32."""
    yf = y.to(torch.float32)
    return yf.sum(dim=(0, 1, 2)), (yf * yf).sum(dim=(0, 1, 2))


def _upsample(dout, pool):
    pt, pf = pool
    return dout.repeat_interleave(pt, dim=1).repeat_interleave(pf, dim=2) * (1.0 / (pt * pf))


def bwd_reduce_reference(y, dout, scale, bias, mean, var, glu_w, glu_b, pool, eps, mask=None, keep: float = 1.0):
    """First half of the backward, written out step by step (no autograd):
    → (dy_partial, dw, db, S1, S2) with S1 = Σdxn, S2 = Σdxn·x̂."""
    inv = torch.rsqrt(var + eps)
    xhat = (y - mean) * inv
    xn = (y - mean) * inv * scale + bias
    lin = xn @ glu_w + glu_b
    sig = torch.sigmoid(xn)
    dh = _upsample(dout, pool)
    if mask is not None:
        dh = dh * mask * (1.0 / keep)
    dlin = dh * sig
    dxn = dlin @ glu_w.t() + dh * lin * sig * (1.0 - sig)
    C = y.shape[-1]
    dw = xn.reshape(-1, C).t() @ dlin.reshape(-1, C)
    db = dlin.sum(dim=(0, 1, 2))
    s1 = dxn.sum(dim=(0, 1, 2))
    s2 = (dxn * xhat).sum(dim=(0, 1, 2))
    return inv * scale * dxn, dw, db, s1, s2


def bwd_coefficients(scale, var, eps, s1, s2, n: int):
    """Through-statistics coefficients of the fixup pass:
    a = inv·γ·S1/N, b = inv²·γ·S2/N."""
    inv = torch.rsqrt(var + eps)
    return inv * scale * s1 / n, inv * inv * scale * s2 / n


def bwd_fixup_reference(y, dy_partial, a, b, mean):
    """Second half: dy = dy_partial − a − (y − mean)·b."""
    return dy_partial - a - (y - mean) * b


def bwd_reference(y, dout, scale, bias, mean, var, glu_w, glu_b, pool, eps, mask=None, keep: float = 1.0):
    """The whole backward in formulas: → (dy, dscale, dbias, dw, db), the
    BN-training backward with mean/var the batch statistics of y."""
    dyp, dw, db, s1, s2 = bwd_reduce_reference(y, dout, scale, bias, mean, var, glu_w, glu_b, pool, eps, mask, keep)
    B, T, Fq, _ = y.shape
    a, b = bwd_coefficients(scale, var, eps, s1, s2, B * T * Fq)
    return bwd_fixup_reference(y, dyp, a, b, mean), s2, s1, dw, db


# ------------------------------------------------------ kernel wrappers


def _check(y, pool, what: str):
    if y.dim() != 4 or not applicable(y.shape, pool):
        raise ValueError(f"{what} does not take y {tuple(y.shape)} with pool {pool}")
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda tensors, got {y.device}")
    if y.device.type == "cuda" and (y.dtype != torch.float32 or not y.is_contiguous()):
        raise ValueError(f"y must be contiguous float32, got {y.dtype}")


def _vectors(y, vecs, glu_w):
    C = y.shape[-1]
    out = [v.detach().to(device=y.device, dtype=torch.float32).contiguous() for v in vecs]
    w = glu_w.detach().to(device=y.device, dtype=torch.float32).contiguous()
    if any(tuple(v.shape) != (C,) for v in out) or tuple(w.shape) != (C, C):
        raise ValueError(f"per-channel vectors must be [{C}] and glu_w [{C}, {C}]")
    return out, w


def _seed_tensor(seed, device) -> torch.Tensor:
    """The seed as an int64 [1] tensor on `device` (a host→device copy at
    most; never a read back from the device)."""
    return torch.as_tensor(seed, dtype=torch.int64).reshape(1).to(device)


def _tiles_per_block(lib, B, T, Fq, pt, target) -> int:
    tiles = lib.dcase_bn_glu_pool_tiles(T, Fq, pt)
    return max(1, -(-tiles * B // target))


def fused_bn_glu_pool(y, scale, bias, mean, var, glu_w, glu_b, pool, eps, *, rate: float = 0.0, seed=0):
    """K2 forward, no graph: y [B, T, F, C] conv output → pooled
    [B, T/pt, F/pf, C]; BN with the given mean/var; glu_w [C, C] as (in,
    out); dropout at `rate` from `seed` (int or integer tensor) when
    rate > 0. CPU: the plain version. CUDA: the kernel."""
    pool = tuple(int(p) for p in pool)
    _check(y, pool, "fused_bn_glu_pool")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    if y.device.type == "cpu":
        mask = dropout_keep_mask(seed, y.shape, rate) if rate > 0.0 else None
        return reference_block(y, scale, bias, mean, var, glu_w, glu_b, pool, eps, mask, 1.0 - rate)
    B, T, Fq, C = y.shape
    (s, bi, mu, va, gb), w = _vectors(y, (scale, bias, mean, var, glu_b), glu_w)
    pt, pf = pool
    lib = _build.library()
    out = torch.empty((B, T // pt, Fq // pf, C), dtype=torch.float32, device=y.device)
    seed_t = _seed_tensor(seed, y.device)
    status = lib.dcase_bn_glu_pool(
        y.data_ptr(), s.data_ptr(), bi.data_ptr(), mu.data_ptr(), va.data_ptr(),
        w.data_ptr(), gb.data_ptr(), out.data_ptr(), B, T, Fq, C, pt, pf, float(eps),
        seed_t.data_ptr(), dropout_threshold(rate) if rate > 0.0 else 0, float(1.0 / (1.0 - rate)),
        _tiles_per_block(lib, B, T, Fq, pt, _TARGET_BLOCKS), _build.stream_handle(y.device),
    )
    _build.check(status, "fused_bn_glu_pool")
    if rate > 0.0:
        fused_bn_glu_pool.launches_train += 1
    else:
        fused_bn_glu_pool.launches_eval += 1
    return out


fused_bn_glu_pool.launches_eval = 0  # launches of the forward kernel without dropout
fused_bn_glu_pool.launches_train = 0  # launches with the dropout on (train mode)


def batch_stats(y: torch.Tensor):
    """K2s: per-channel (Σy, Σy²) of y [B, T, F, C] as two float32 [C]
    tensors without a graph. Each block sums a contiguous run of pixels in
    double precision and the per-block partials are folded in a fixed
    order, so a run repeats bit for bit. CPU: the plain version."""
    if y.dim() != 4:
        raise ValueError(f"batch_stats takes [B, T, F, C], got {tuple(y.shape)}")
    y = y.detach()
    if y.device.type == "cpu":
        return batch_stats_reference(y)
    if y.device.type != "cuda":
        raise ValueError(f"batch_stats runs on cpu or cuda tensors, got {y.device}")
    C = y.shape[-1]
    if y.dtype != torch.float32 or not y.is_contiguous() or C % 4 != 0 or C > 1024:
        raise ValueError(f"y must be contiguous float32 with C a multiple of 4 up to 1024, got {y.dtype}, C={C}")
    rows = y.numel() // C
    lib = _build.library()
    blocks = max(1, min(_TARGET_BLOCKS_BWD, -(-rows // 64)))
    partials = torch.empty((blocks, 2 * C), dtype=torch.float64, device=y.device)
    out = torch.empty((2, C), dtype=torch.float32, device=y.device)
    status = lib.dcase_batch_stats(y.data_ptr(), partials.data_ptr(), out.data_ptr(), rows, C, blocks,
                                   _build.stream_handle(y.device))
    _build.check(status, "batch_stats")
    batch_stats.launches += 1
    return out[0], out[1]


batch_stats.launches = 0


def bwd_reduce(y, dout, scale, bias, mean, var, glu_w, glu_b, pool, eps, *, rate: float = 0.0, seed=0):
    """K2b, first pass: recompute the chain and the mask per pixel tile;
    → (dy_partial [B,T,F,C], dw [C,C], db, S1, S2 [C]). Per-block partial
    sums are folded in a fixed order (no float atomics). CPU: the plain
    version."""
    pool = tuple(int(p) for p in pool)
    _check(y, pool, "bwd_reduce")
    B, T, Fq, C = y.shape
    pt, pf = pool
    if tuple(dout.shape) != (B, T // pt, Fq // pf, C):
        raise ValueError(f"dout {tuple(dout.shape)} is not the pooled shape of y {tuple(y.shape)}")
    if y.device.type == "cpu":
        mask = dropout_keep_mask(seed, y.shape, rate) if rate > 0.0 else None
        return bwd_reduce_reference(y, dout, scale, bias, mean, var, glu_w, glu_b, pool, eps, mask, 1.0 - rate)
    (s, bi, mu, va, gb), w = _vectors(y, (scale, bias, mean, var, glu_b), glu_w)
    dout = dout.to(torch.float32).contiguous()
    lib = _build.library()
    tpb = _tiles_per_block(lib, B, T, Fq, pt, _TARGET_BLOCKS_BWD)
    slots = -(-lib.dcase_bn_glu_pool_tiles(T, Fq, pt) // tpb) * B
    width = C * C + 3 * C
    partials = torch.empty((slots, width), dtype=torch.float32, device=y.device)
    sums = torch.empty(width, dtype=torch.float32, device=y.device)
    dyp = torch.empty_like(y)
    seed_t = _seed_tensor(seed, y.device)
    status = lib.dcase_bn_glu_pool_bwd(
        y.data_ptr(), dout.data_ptr(), s.data_ptr(), bi.data_ptr(), mu.data_ptr(), va.data_ptr(),
        w.data_ptr(), gb.data_ptr(), dyp.data_ptr(), partials.data_ptr(), sums.data_ptr(),
        B, T, Fq, C, pt, pf, float(eps), seed_t.data_ptr(),
        dropout_threshold(rate) if rate > 0.0 else 0, float(1.0 / (1.0 - rate)), tpb,
        _build.stream_handle(y.device),
    )
    _build.check(status, "bwd_reduce")
    bwd_reduce.launches += 1
    dw, db, s1, s2 = sums[: C * C].view(C, C), sums[C * C: C * C + C], sums[C * C + C: C * C + 2 * C], sums[C * C + 2 * C:]
    return dyp, dw, db, s1, s2


bwd_reduce.launches = 0


def bwd_fixup(y, dy_partial, a, b, mean):
    """K2b, second pass: dy = dy_partial − a − (y − mean)·b, written over
    dy_partial on the card (in place: dy_partial is scratch of the
    backward). CPU: the plain version."""
    if y.shape != dy_partial.shape:
        raise ValueError(f"dy_partial {tuple(dy_partial.shape)} does not match y {tuple(y.shape)}")
    if y.device.type == "cpu":
        return bwd_fixup_reference(y, dy_partial, a, b, mean)
    if y.device.type != "cuda":
        raise ValueError(f"bwd_fixup runs on cpu or cuda tensors, got {y.device}")
    C = y.shape[-1]
    for t in (y, dy_partial):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("y and dy_partial must be contiguous float32")
    vecs = [v.detach().to(device=y.device, dtype=torch.float32).contiguous() for v in (a, b, mean)]
    if any(tuple(v.shape) != (C,) for v in vecs) or C % 4 != 0:
        raise ValueError(f"a, b, mean must be [{C}] with C a multiple of 4")
    lib = _build.library()
    status = lib.dcase_bn_bwd_fixup(y.data_ptr(), dy_partial.data_ptr(), vecs[0].data_ptr(), vecs[1].data_ptr(),
                                    vecs[2].data_ptr(), y.numel(), C, _build.stream_handle(y.device))
    _build.check(status, "bwd_fixup")
    bwd_fixup.launches += 1
    return dy_partial


bwd_fixup.launches = 0


# ------------------------------------------------------- autograd Function


class _FusedBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, scale, bias, mean, var, glu_w, glu_b, seed, rate, pool, eps, train):
        rate = float(rate) if train else 0.0
        seed = torch.as_tensor(seed, dtype=torch.int64).reshape(1).clone()
        ctx.save_for_backward(y, scale, bias, mean, var, glu_w, glu_b, seed)
        ctx.rate, ctx.pool, ctx.eps = rate, tuple(int(p) for p in pool), float(eps)
        return fused_bn_glu_pool(y, scale, bias, mean, var, glu_w, glu_b, pool, eps, rate=rate, seed=seed)

    @staticmethod
    def backward(ctx, dout):
        y, scale, bias, mean, var, glu_w, glu_b, seed = ctx.saved_tensors
        dyp, dw, db, s1, s2 = bwd_reduce(y, dout.contiguous(), scale, bias, mean, var, glu_w, glu_b,
                                         ctx.pool, ctx.eps, rate=ctx.rate, seed=seed)
        B, T, Fq, _ = y.shape
        a, b = bwd_coefficients(scale.detach().to(torch.float32), var.to(torch.float32), ctx.eps, s1, s2, B * T * Fq)
        dy = bwd_fixup(y, dyp, a, b, mean)
        # dscale = S2, dbias = S1; mean/var are detached inputs; seed, rate,
        # pool, eps, train take no gradient
        return dy, s2, s1, None, None, dw, db, None, None, None, None, None


def fused_bn_glu_dropout_pool(y, scale, bias, mean, var, glu_w, glu_b, seed, rate: float,
                              pool: Tuple[int, int], eps: float, train: bool):
    """Fused BN→GLU→dropout→avg-pool with its exact backward.

    y [B, T, F, C] conv output; mean/var the batch statistics of y (or the
    running ones), passed WITHOUT a graph: the backward holds the full
    BN-training backward and returns (dy, dscale, dbias, None, None, dw,
    db). seed: int or integer tensor, new each step; `train` switches the
    dropout on (rate is ignored in eval mode)."""
    if mean.requires_grad or var.requires_grad:
        raise ValueError("mean and var must be detached: the backward already carries the "
                         "through-statistics terms")
    return _FusedBlock.apply(y, scale, bias, mean, var, glu_w, glu_b, seed, rate, pool, eps, train)
