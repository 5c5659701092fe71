"""K2: BatchNorm → GLU → dropout → avg-pool, forward and backward, and the
per-channel batch statistics that feed it.

PyTorch counterpart of dcase2019_task4_tpu/ops/fused_block.py. On a CUDA
tensor every wrapper launches its hand-written kernel in
csrc/fused_block.cu (or raises); on a CPU tensor it runs the plain PyTorch
version beside it:

  wrapper                     kernel(s)                      plain version
  fused_bn_glu_pool           bn_glu_pool_kernel (float32),  reference_block
                              bn_glu_pool_bf16_kernel
  batch_stats                 stats_kernel + fold            batch_stats_reference
                              (bfloat16: stats_bf16_kernel + fold_warps)
  bwd_reduce                  bn_glu_pool_bwd_kernel         bwd_reference (first half)
                              (float32),
                              bn_glu_pool_bwd_bf16_kernel;
                              + fold
  bwd_fixup                   bn_bwd_fixup_kernel            bwd_reference (second half)
  bwd_fixup_recompute         bn_bwd_fixup_recompute_kernel  bwd_fixup_recompute_reference
                              (float32),
                              bn_bwd_fixup_recompute_bf16_kernel
  dropout_mask                dropout_mask_kernel (a test    dropout_keep_mask
                              helper, csrc/entry_block.cu)

`fused_bn_glu_dropout_pool` ties them into one `torch.autograd.Function`
with the JAX contract: mean and var come in detached (the batch statistics
of y, or the running ones in eval mode) and the backward carries the whole
BatchNorm-training backward, through-statistics terms included, so callers
must not also differentiate the statistics.

The compute dtype is y's: float32, or bfloat16 in a bfloat16 model. In
bfloat16 every function rounds where the JAX kernels round
(fused_block.py:121-127,134,216-219,276-280,312-316): xn and glu_w enter
the GLU product as bfloat16 (the sigmoid and the gate take the float32
xn); each window's pt-row time sum is rounded to bfloat16 before the
frequency sum; dlin and glu_w enter dxn, and xn and dlin enter dW, as
bfloat16; the pooled output, dy_partial and dy are stored in y's dtype; dW,
db, S1, S2 and the batch statistics are float32. The plain versions round
the operands and multiply in float32 (no bfloat16 matmul, whose
accumulation order is unspecified). On the card the bfloat16 forward and
reduce pass and recompute fixup take the channel products on the tensor
cores (mma.sync, bfloat16 operands, float32 sums: the same roundings, the
sums inside a product in another order); the float32 kernels multiply on
FP32 FMAs.

Dropout: the keep-mask comes from Philox4x32-10 keyed on the seed, with the
counter the global element index of y divided by four (one call gives the
mask of four neighbouring channels). It depends on nothing but (seed,
element index, rate): not on tiling, launch geometry or device. The mask is
never stored; the backward regenerates it. `dropout_keep_mask` is the same
generator in integer tensor ops and is bit-equal to the kernels' mask. It
matches neither of the JAX package's masks (TPU hardware bits compiled, a
hash in the packed layout interpreted), so parity with JAX is held at rate 0
or with an injected mask.

Two A/B knobs of the JAX package (fused_block.py:56,169) are read from the
environment at import, under the same names, into module constants that
every wrapper takes as the default of an explicit keyword argument:

  DCASE_FUSED_BWD_RECOMPUTE=1 → RECOMPUTE_FIXUP (`recompute=`): the first
      backward pass stores no dy_partial (counted in
      `bwd_reduce.launches_nodyp`) and `bwd_fixup_recompute` rebuilds dxn
      from y and dout: dy = inv·γ·dxn − a − (y − mean)·b in float32, rounded
      once, so in bfloat16 it is another function than the default's.
  DCASE_DROPOUT_PACK=1 → PACK_BITS (`pack_bits=`): each element draws 8
      random bits instead of 32 (byte e % 4 of word (e / 4) % 4 of
      Philox(e / 16)), kept iff ≥ t8 = min(round(rate·256), 255), the kept
      scaled by 1/(1 − rate) as in JAX. JAX packs only where a tile's row
      count is a multiple of 4 and falls back to 32 bits elsewhere; the
      port's mask has no tiles, so it packs always. Every dropping kernel
      (K2f, K2b, K5, K6) takes the mode and counts its packed launches in
      `launches_packed`.

`_FusedBlock` records both modes at its forward, so its backward
regenerates the forward's mask whatever the constants are by then.
"""

from __future__ import annotations

import functools
import os
from typing import List, Optional, Tuple

import torch

from dcase2019_task4_tpu_torch.ops import _build
from dcase2019_task4_tpu_torch.parallel.mesh import all_reduce_

_TILE_PIXELS = 128  # csrc/fused_block.cu kPix
_TARGET_BLOCKS = 1056  # bfloat16 forward: 8 resident blocks on each of the H100's 132 SMs
_TARGET_BLOCKS_BWD = 528  # backward and float32 statistics: partial slots folded in fixed order
_STATS_THREADS = 256  # csrc/fused_block.cu kStatsThreads: threads of a block of the bfloat16 statistics
_STATS_UNROLL = 8  # kStatsUnroll: rows of a thread's batch of loads

_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF


DTYPES = (torch.float32, torch.bfloat16)  # the compute dtypes the kernels take

# the JAX package's knobs, read at import as there (see the module docstring)
RECOMPUTE_FIXUP = os.environ.get("DCASE_FUSED_BWD_RECOMPUTE", "0") == "1"
PACK_BITS = os.environ.get("DCASE_DROPOUT_PACK") == "1"


def pack_mode(pack_bits: Optional[bool] = None) -> bool:
    """A wrapper's dropout draw: `pack_bits`, or PACK_BITS when None."""
    return PACK_BITS if pack_bits is None else bool(pack_bits)


def recompute_mode(recompute: Optional[bool] = None) -> bool:
    """A backward's second pass: `recompute`, or RECOMPUTE_FIXUP when None."""
    return RECOMPUTE_FIXUP if recompute is None else bool(recompute)


def applicable(shape, pool: Tuple[int, int]) -> bool:
    """Whether the fused block takes a [B, T, F, C] activation: whole
    pooling windows (T % pt == F % pf == 0), a window of at most one pixel
    tile (a tile holds whole pooling rows where they fit, else whole windows
    of one row pair), and C ≤ 128 in whole groups of four (one Philox call
    masks four channels)."""
    B, T, Fq, C = shape
    pt, pf = pool
    return T % pt == 0 and Fq % pf == 0 and pt * pf <= _TILE_PIXELS and C <= 128 and C % 4 == 0


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


def dropout_threshold(rate: float, pack_bits: bool = False) -> int:
    """An element is kept iff its random value is ≥ this: its 32 random bits
    against min(rate·2³², 2³² − 1), or its 8 packed bits against
    t8 = min(round(rate·256), 255) (the JAX package's, fused_block.py:170)."""
    if pack_bits:
        return min(int(round(rate * 256)), 255)
    return min(int(rate * 2 ** 32), 2 ** 32 - 1)


def dropout_args(rate: float, pack_bits: bool):
    """A kernel's dropout arguments (threshold, keep_scale, packed) at
    `rate`: no dropout at rate 0; the kept scaled by 1/(1 − rate) in both
    draws."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    if rate == 0.0:
        return 0, 1.0, 0
    return dropout_threshold(rate, pack_bits), float(1.0 / (1.0 - rate)), int(pack_bits)


def dropout_keep_mask(seed, shape, rate: float, device=None, pack_bits: Optional[bool] = None) -> torch.Tensor:
    """The kernels' keep-mask as a float32 0/1 tensor of `shape`: element e
    (row-major index) reads word e % 4 of philox4x32(e // 4, seed), or in
    the packed draw byte e % 4 of word (e // 4) % 4 of philox4x32(e // 16,
    seed)."""
    pack_bits = pack_mode(pack_bits)
    n = 1
    for s in shape:
        n *= int(s)
    if device is None:
        device = seed.device if isinstance(seed, torch.Tensor) else "cpu"
    per_call = 16 if pack_bits else 4
    counters = torch.arange((n + per_call - 1) // per_call, dtype=torch.int64, device=device)
    words = philox4x32(counters, seed).reshape(-1)
    if pack_bits:
        shifts = torch.tensor([0, 8, 16, 24], dtype=torch.int64, device=device)
        bits = ((words[:, None] >> shifts) & 0xFF).reshape(-1)[:n]
    else:
        bits = words[:n]
    return (bits >= dropout_threshold(rate, pack_bits)).to(torch.float32).reshape(tuple(shape))


def count_packed(wrapper, packed) -> None:
    """One launch of `wrapper`'s kernel that drew the packed mask."""
    if packed:
        wrapper.launches_packed += 1


def dropout_mask(seed, shape, rate: float, device, pack_bits: Optional[bool] = None) -> torch.Tensor:
    """The keep-mask written by a kernel of its own (csrc/entry_block.cu
    dropout_mask_kernel): what every fused kernel multiplies by, laid bare so
    that a test can hold it bit-equal to `dropout_keep_mask` on the card and
    check its distribution. CPU: `dropout_keep_mask`."""
    device = torch.device(device)
    pack_bits = pack_mode(pack_bits)
    if device.type == "cpu":
        return dropout_keep_mask(seed, shape, rate, device=device, pack_bits=pack_bits)
    if device.type != "cuda":
        raise ValueError(f"dropout_mask runs on cpu or cuda, got {device}")
    out = torch.empty(tuple(int(s) for s in shape), dtype=torch.float32, device=device)
    seed_t = _seed_tensor(seed, device)
    status = _build.library().dcase_dropout_mask(out.data_ptr(), out.numel(), seed_t.data_ptr(),
                                                 dropout_threshold(rate, pack_bits), int(pack_bits),
                                                 _build.stream_handle(device))
    _build.check(status, "dropout_mask")
    dropout_mask.launches += 1
    count_packed(dropout_mask, pack_bits)
    return out


dropout_mask.launches = 0
dropout_mask.launches_packed = 0


def glu_gate(y, scale, bias, mean, var, glu_w, glu_b, eps, mask=None, keep: float = 1.0):
    """BN→GLU→(given mask) dropout on [B, T, F, C], before the pool: g in
    float32, with xn and glu_w rounded to y's dtype as operands of the GLU
    product."""
    dtype = y.dtype
    inv = torch.rsqrt(var + eps)
    xn = (y.to(torch.float32) - mean) * inv * scale + bias
    g = (_build.round_to(xn, dtype) @ _build.round_to(glu_w, dtype) + glu_b) * torch.sigmoid(xn)
    if mask is not None:
        g = g * mask * (1.0 / keep)
    return g


def reference_block(y, scale, bias, mean, var, glu_w, glu_b, pool, eps, mask=None, keep: float = 1.0):
    """Plain version: BN→GLU→(given mask) dropout→avg-pool on [B, T, F, C]
    (glu_w [in, out]) → [B, T/pt, F/pf, C] in y's dtype."""
    dtype = y.dtype
    g = glu_gate(y, scale, bias, mean, var, glu_w, glu_b, eps, mask, keep)
    B, T, Fq, C = g.shape
    pt, pf = pool
    if dtype == torch.float32:
        return g.reshape(B, T // pt, pt, Fq // pf, pf, C).mean(dim=(2, 4))
    # each column's pt-row time sum rounds to the compute dtype before the frequency sum
    col = _build.round_to(g.reshape(B, T // pt, pt, Fq // pf, pf, C).sum(dim=2), dtype)
    return (col.sum(dim=3) * (1.0 / (pt * pf))).to(dtype)


def batch_stats_reference(y: torch.Tensor):
    """Plain version of K2s: per-channel (Σy, Σy²) of [B, T, F, C], float32."""
    yf = y.to(torch.float32)
    return yf.sum(dim=(0, 1, 2)), (yf * yf).sum(dim=(0, 1, 2))


def _upsample(dout, pool):
    pt, pf = pool
    return dout.repeat_interleave(pt, dim=1).repeat_interleave(pf, dim=2) * (1.0 / (pt * pf))


def bwd_reduce_reference(y, dout, scale, bias, mean, var, glu_w, glu_b, pool, eps, mask=None, keep: float = 1.0):
    """First half of the backward, written out step by step (no autograd):
    → (dy_partial in y's dtype, dw, db, S1, S2 in float32) with S1 = Σdxn,
    S2 = Σdxn·x̂."""
    dyp, dw, db, s1, s2 = bwd_reduce_terms(y, dout, scale, bias, mean, var, glu_w, glu_b, pool, eps, mask, keep)
    return dyp.to(y.dtype), dw, db, s1, s2


def _recompute_dxn(y, dout, scale, bias, mean, var, glu_w, glu_b, pool, eps, mask, keep):
    """What both backward passes recompute from y and dout (the JAX
    package's _recompute_dxn): → (x̂, xn, dlin, dxn) in float32, with the
    compute dtype's roundings of the operands."""
    dtype = y.dtype
    y = y.to(torch.float32)
    inv = torch.rsqrt(var + eps)
    xhat = (y - mean) * inv
    xn = (y - mean) * inv * scale + bias
    w = _build.round_to(glu_w, dtype)
    lin = _build.round_to(xn, dtype) @ w + glu_b
    sig = torch.sigmoid(xn)
    dh = _upsample(dout.to(torch.float32), pool)
    if mask is not None:
        dh = dh * mask * (1.0 / keep)
    dlin = dh * sig
    dxn = _build.round_to(dlin, dtype) @ w.t() + dh * lin * sig * (1.0 - sig)
    return xhat, xn, dlin, dxn


def bwd_reduce_terms(y, dout, scale, bias, mean, var, glu_w, glu_b, pool, eps, mask=None, keep: float = 1.0):
    """`bwd_reduce_reference` with dy_partial = inv·γ·dxn left in float32
    (a fused first block keeps it in registers)."""
    dtype = y.dtype
    xhat, xn, dlin, dxn = _recompute_dxn(y, dout, scale, bias, mean, var, glu_w, glu_b, pool, eps, mask, keep)
    inv = torch.rsqrt(var + eps)
    C = y.shape[-1]
    dw = _build.round_to(xn, dtype).reshape(-1, C).t() @ _build.round_to(dlin, dtype).reshape(-1, C)
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
    """Second half: dy = dy_partial − a − (y − mean)·b, in y's dtype."""
    return (dy_partial.to(torch.float32) - a - (y.to(torch.float32) - mean) * b).to(y.dtype)


def bwd_fixup_recompute_reference(y, dout, scale, bias, mean, var, glu_w, glu_b, a, b, pool, eps, mask=None,
                                  keep: float = 1.0):
    """Second half without dy_partial (the JAX package's
    _bwd_fixup_recompute_kernel): dxn rebuilt from y and dout as the first
    half builds it, then dy = inv·γ·dxn − a − (y − mean)·b in float32,
    rounded once to y's dtype."""
    _, _, _, dxn = _recompute_dxn(y, dout, scale, bias, mean, var, glu_w, glu_b, pool, eps, mask, keep)
    inv = torch.rsqrt(var + eps)
    return (inv * scale * dxn - a - (y.to(torch.float32) - mean) * b).to(y.dtype)


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
    if y.dtype not in DTYPES:
        raise ValueError(f"{what}: y must be float32 or bfloat16, got {y.dtype}")
    if y.device.type == "cuda" and not y.is_contiguous():
        raise ValueError(f"{what}: y must be contiguous")


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


_MAX_SHARED = _build.MAX_SHARED


def reduce_plan(channels: int, pool):
    """The float32 reduce pass's shared memory at `channels` C and `pool`
    (pt, pf) → (buffers, drows, bytes): the channels padded to CP = 64 (C ≤
    64) or 128 in rows of CP + 4 floats; `buffers` tiles of y (x-hat) [128]
    rows and of dout [drows] rows, two where they fit (the next tile loads
    while one multiplies: C ≤ 64), else one; drows = 128 // (pt·pf), the
    pooled rows of a tile, or 0 where even one buffer of them does not fit
    (C > 64 and pt·pf ≤ 2: dout is then read from device memory); and the
    dlin tile [128], W [CP][CP], seven per-channel vectors [CP] and two
    pixel tables [128] of int32 (csrc/fused_block.cu red_f32_smem)."""
    cp = 64 if channels <= 64 else 128
    rows = _TILE_PIXELS // (pool[0] * pool[1])
    for buffers, drows in ((2, rows), (1, rows), (1, 0)):
        nbytes = 4 * ((buffers + 1) * _TILE_PIXELS * (cp + 4) + buffers * drows * (cp + 4) + cp * cp + 7 * cp
                      + 2 * _TILE_PIXELS)
        if nbytes <= _MAX_SHARED:
            return buffers, drows, nbytes
    raise ValueError(f"the float32 reduce pass does not fit {channels} channels")


def forward_plan(channels: int) -> int:
    """The float32 forward's shared memory at `channels` C, in bytes: the
    channels padded to CP = 64 (C ≤ 64) or 128 in rows of CP + 4 floats; two
    y tiles [128] rows (the next tile loads while one multiplies) with their
    pixel tables [128] of int32; W' = diag(inv·γ)·W [CP][CP] and four
    per-channel vectors [CP] (csrc/fused_block.cu fwd_f32_smem). The pool
    does not enter it: each window is summed from the tile or across a warp.
    86 KB at C ≤ 64 (two blocks an SM), 199 KB at C ≤ 128."""
    cp = 64 if channels <= 64 else 128
    return 4 * (2 * _TILE_PIXELS * (cp + 5) + cp * cp + 4 * cp)


@functools.cache
def _forward_blocks(index: int, channels: int) -> int:
    """Blocks of the float32 forward that device `index` holds at once: what
    one SM holds (registers and shared memory, from the CUDA occupancy
    calculator) times its SMs."""
    with torch.cuda.device(index):
        resident = _build.library().dcase_bn_glu_pool_resident(channels)
    if resident < 1:
        raise _build.KernelError(f"the float32 forward does not fit an SM at {channels} channels")
    return resident * _build.sm_count(index)


def bf16_reduce_plan(channels: int, pool):
    """The bfloat16 reduce pass's shared memory at `channels` C and `pool`
    (pt, pf) → (buffers, drows, bytes), the channels padded to CP = 64 (C ≤
    64) or 128 in bfloat16 rows of RS = CP + 8 (csrc/fused_block.cu
    bwd_bf16_smem): per buffer the y tile and the tile's pooled rows of dout
    (drows = 128 // (pt·pf)); A, D [128][RS] and W [CP][RS]; six vectors
    [CP] and the block's db, S1, S2 per pixel warp row [3][32 NW] float32
    (NW = 16 warps); the keep-mask [128][CP/4 + 4] bytes and the dout-row
    table [128] int32. Two buffers where they fit a block, else one."""
    cp = 64 if channels <= 64 else 128
    rs = cp + 8
    drows = _TILE_PIXELS // (pool[0] * pool[1])
    for buffers in (2, 1):
        nbytes = (2 * rs * (buffers * (_TILE_PIXELS + drows) + 2 * _TILE_PIXELS + cp) + 4 * (6 * cp + 96 * 16)
                  + _TILE_PIXELS * (cp // 4 + 4) + 4 * _TILE_PIXELS)
        if nbytes <= _MAX_SHARED:
            return buffers, drows, nbytes
    raise ValueError(f"the bfloat16 reduce pass does not fit {channels} channels at pool {pool}")


def fixup_plan(channels: int, pool, dtype=torch.float32):
    """The recompute fixup's shared memory at `channels` C, `pool` (pt, pf)
    and y's `dtype` → (buffers, drows, bytes), the channels padded to CP =
    64 (C ≤ 64) or 128 and drows = 128 // (pt·pf), the pooled rows of a
    tile. float32 (csrc/fused_block.cu fix_f32_smem): the reduce pass's
    layout with one buffer and six vectors for its seven: the y tile [128]
    rows and the dout tile [drows] rows of CP + 4 floats, the dlin tile
    [128], W [CP][CP], six per-channel vectors [CP] and two pixel tables
    [128] of int32; drows = 0 where the dout rows do not fit (dout then read
    from device memory). One buffer leaves room for two blocks an SM at C ≤
    64. bfloat16 (fix_bf16_smem): per buffer the y tile and the tile's
    pooled rows of dout in bfloat16 rows of RS = CP + 8; A, D [128][RS] and
    W [CP][RS]; eight vectors [CP] float32; the keep bits [128][CP/4 + 4]
    bytes and the dout-row table [128] int32; two buffers where they fit,
    else one."""
    cp = 64 if channels <= 64 else 128
    rows = _TILE_PIXELS // (pool[0] * pool[1])
    if dtype == torch.bfloat16:
        plans = [(buffers, rows, 2 * (cp + 8) * (buffers * (_TILE_PIXELS + rows) + 2 * _TILE_PIXELS + cp) + 4 * 8 * cp
                  + _TILE_PIXELS * (cp // 4 + 4) + 4 * _TILE_PIXELS) for buffers in (2, 1)]
    else:
        plans = [(1, drows, 4 * (2 * _TILE_PIXELS * (cp + 4) + drows * (cp + 4) + cp * cp + 6 * cp + 2 * _TILE_PIXELS))
                 for drows in (rows, 0)]
    for plan in plans:
        if plan[2] <= _MAX_SHARED:
            return plan
    raise ValueError(f"the recompute fixup does not fit {channels} channels at pool {pool} in {dtype}")


@functools.cache
def _fixup_blocks(index: int, channels: int, bf16: bool, buffers: int, drows: int) -> int:
    """Blocks of the recompute fixup that device `index` holds at once under
    its plan: what one SM holds (registers and shared memory, from the CUDA
    occupancy calculator) times its SMs. The fixup keeps no partial sums, so
    its grid is one wave of long-lived blocks, each an equal run of the
    batch's tiles (clip after clip)."""
    with torch.cuda.device(index):
        resident = _build.library().dcase_bn_bwd_fixup_recompute_resident(channels, int(bf16), buffers, drows)
    if resident < 1:
        raise _build.KernelError(f"the recompute fixup does not fit an SM at {channels} channels")
    return resident * _build.sm_count(index)


def _tiles_per_block(tiles: int, B: int, target: int) -> int:
    """Pixel tiles each block takes so that `tiles` a clip over B clips make
    about `target` blocks."""
    return max(1, -(-tiles * B // target))


def fused_bn_glu_pool(y, scale, bias, mean, var, glu_w, glu_b, pool, eps, *, rate: float = 0.0, seed=0,
                      pack_bits: Optional[bool] = None):
    """K2 forward, no graph: y [B, T, F, C] conv output (float32 or
    bfloat16) → pooled [B, T/pt, F/pf, C] in y's dtype; BN with the given
    mean/var; glu_w [C, C] as (in, out); dropout at `rate` from `seed` (int
    or integer tensor) when rate > 0, in the packed draw when `pack_bits`
    (default PACK_BITS). CPU: the plain version. CUDA: the kernel."""
    pool = tuple(int(p) for p in pool)
    _check(y, pool, "fused_bn_glu_pool")
    pack_bits = pack_mode(pack_bits)
    threshold, keep_scale, packed = dropout_args(rate, pack_bits)
    if y.device.type == "cpu":
        mask = dropout_keep_mask(seed, y.shape, rate, pack_bits=pack_bits) if rate > 0.0 else None
        return reference_block(y, scale, bias, mean, var, glu_w, glu_b, pool, eps, mask, 1.0 - rate)
    B, T, Fq, C = y.shape
    (s, bi, mu, va, gb), w = _vectors(y, (scale, bias, mean, var, glu_b), glu_w)
    pt, pf = pool
    lib = _build.library()
    bf16 = y.dtype == torch.bfloat16
    target = _TARGET_BLOCKS if bf16 else _forward_blocks(y.device.index, C)
    out = torch.empty((B, T // pt, Fq // pf, C), dtype=y.dtype, device=y.device)
    seed_t = _seed_tensor(seed, y.device)
    status = lib.dcase_bn_glu_pool(
        y.data_ptr(), s.data_ptr(), bi.data_ptr(), mu.data_ptr(), va.data_ptr(),
        w.data_ptr(), gb.data_ptr(), out.data_ptr(), B, T, Fq, C, pt, pf, float(eps),
        seed_t.data_ptr(), threshold, keep_scale, packed,
        _tiles_per_block(lib.dcase_bn_glu_pool_tiles(T, Fq, pt, pf), B, target), int(bf16),
        _build.stream_handle(y.device),
    )
    _build.check(status, "fused_bn_glu_pool")
    _build.count_launch(fused_bn_glu_pool, "launches_train" if rate > 0.0 else "launches_eval", y.dtype)
    count_packed(fused_bn_glu_pool, packed)
    return out


fused_bn_glu_pool.launches_eval = 0  # launches of the float32 forward kernel without dropout
fused_bn_glu_pool.launches_train = 0  # launches with the dropout on (train mode)
fused_bn_glu_pool.launches_eval_bf16 = 0  # the same, of the bfloat16 kernel
fused_bn_glu_pool.launches_train_bf16 = 0
fused_bn_glu_pool.launches_packed = 0  # train launches of either dtype that drew the packed mask


@torch.library.custom_op("dcase19_torch::fused_bn_glu_pool_eval", mutates_args=())
def fused_bn_glu_pool_eval(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
                           var: torch.Tensor, glu_w: torch.Tensor, glu_b: torch.Tensor, pool: List[int],
                           eps: float) -> torch.Tensor:
    """K2f at rate 0 (BatchNorm with the given, running, statistics) as a
    torch.library op: the eval-mode CRNN's and the serving export's only way
    to K2's forward (training keeps `fused_bn_glu_dropout_pool`); the
    wrapper dispatches by y's device."""
    return fused_bn_glu_pool(y, scale, bias, mean, var, glu_w, glu_b, pool, eps)


@fused_bn_glu_pool_eval.register_fake
def _(y, scale, bias, mean, var, glu_w, glu_b, pool, eps):
    B, T, Fq, C = y.shape
    return y.new_empty((B, T // pool[0], Fq // pool[1], C))


def stats_bf16_vec(channels: int, aligned16: bool = True) -> int:
    """Channels a thread of K2s on bfloat16 y owns (csrc/fused_block.cu
    stats_bf16_vec): 8, one 16-byte load a row, where C % 8 == 0 and y is
    16-byte aligned, else 4 (8 bytes)."""
    return 8 if channels % 8 == 0 and aligned16 else 4


def stats_bf16_plan(channels: int, rows: int, resident: int, vec: int) -> int:
    """The grid of K2s on bfloat16 y (stats_bf16_kernel) for y [rows,
    `channels`] at `vec` channels a thread, so C / vec threads a row and
    groups = 256 // (C / vec) rows in flight a block: one wave of at most
    the `resident` blocks the card holds, each an equal run of the rows,
    and no more than give each thread _STATS_UNROLL rows (one batch of
    loads): at the flagship's block 3 ([24, 216, 4, 64], 20 736 rows) 81
    blocks, not 528 blocks of a few dozen rows."""
    groups = _STATS_THREADS // (channels // vec)
    return max(1, min(resident, -(-rows // (groups * _STATS_UNROLL))))


def batch_stats(y: torch.Tensor):
    """K2s: per-channel (Σy, Σy²) of y [B, T, F, C] (float32 or bfloat16)
    as two float32 [C] tensors without a graph. float32: each block sums a
    contiguous run of pixels in double precision. bfloat16: one wave of
    equal runs of rows (`stats_bf16_plan`), 16-byte loads several rows
    ahead, y and y² summed in float32 over runs of 64 of a thread's rows,
    each run added into double. The per-block partials are folded in a
    fixed order, so a run repeats bit for bit. CPU: the plain version."""
    if y.dim() != 4:
        raise ValueError(f"batch_stats takes [B, T, F, C], got {tuple(y.shape)}")
    y = y.detach()
    if y.device.type == "cpu":
        return batch_stats_reference(y)
    if y.device.type != "cuda":
        raise ValueError(f"batch_stats runs on cpu or cuda tensors, got {y.device}")
    C = y.shape[-1]
    if y.dtype not in DTYPES or not y.is_contiguous() or C % 4 != 0 or C > 1024:
        raise ValueError(f"y must be contiguous float32 or bfloat16 with C a multiple of 4 up to 1024, "
                         f"got {y.dtype}, C={C}")
    rows = y.numel() // C
    lib = _build.library()
    if y.dtype == torch.bfloat16:
        if y.data_ptr() % 8:
            raise ValueError("batch_stats of bfloat16 y takes y 8-byte aligned")
        vec = stats_bf16_vec(C, y.data_ptr() % 16 == 0)
        blocks = stats_bf16_plan(C, rows, _build.resident(y.device.index, "stats_bf16", vec), vec)
    else:
        blocks = max(1, min(_TARGET_BLOCKS_BWD, -(-rows // 64)))
    partials = torch.empty((blocks, 2 * C), dtype=torch.float64, device=y.device)
    out = torch.empty((2, C), dtype=torch.float32, device=y.device)
    status = lib.dcase_batch_stats(y.data_ptr(), partials.data_ptr(), out.data_ptr(), rows, C, blocks,
                                   int(y.dtype == torch.bfloat16), _build.stream_handle(y.device))
    _build.check(status, "batch_stats")
    _build.count_launch(batch_stats, "launches", y.dtype)
    return out[0], out[1]


batch_stats.launches = 0  # float32 launches
batch_stats.launches_bf16 = 0  # bfloat16 launches


def _check_dout(y, dout, pool, what: str):
    B, T, Fq, C = y.shape
    pt, pf = pool
    if tuple(dout.shape) != (B, T // pt, Fq // pf, C):
        raise ValueError(f"{what}: dout {tuple(dout.shape)} is not the pooled shape of y {tuple(y.shape)}")


def bwd_reduce(y, dout, scale, bias, mean, var, glu_w, glu_b, pool, eps, *, rate: float = 0.0, seed=0,
               pack_bits: Optional[bool] = None, recompute: Optional[bool] = None):
    """K2b, first pass: recompute the chain and the mask per pixel tile;
    → (dy_partial [B,T,F,C] in y's dtype, dw [C,C], db, S1, S2 [C] in
    float32). dout comes in y's dtype. Per-block partial sums are folded in
    a fixed order (no float atomics). With `recompute` (default
    RECOMPUTE_FIXUP) no dy_partial is stored and the first output is None:
    `bwd_fixup_recompute` follows. CPU: the plain version."""
    pool = tuple(int(p) for p in pool)
    _check(y, pool, "bwd_reduce")
    _check_dout(y, dout, pool, "bwd_reduce")
    pack_bits, recompute = pack_mode(pack_bits), recompute_mode(recompute)
    threshold, keep_scale, packed = dropout_args(rate, pack_bits)
    B, T, Fq, C = y.shape
    pt, pf = pool
    if y.device.type == "cpu":
        mask = dropout_keep_mask(seed, y.shape, rate, pack_bits=pack_bits) if rate > 0.0 else None
        dyp, dw, db, s1, s2 = bwd_reduce_reference(y, dout, scale, bias, mean, var, glu_w, glu_b, pool, eps,
                                                   mask, 1.0 - rate)
        return (None if recompute else dyp), dw, db, s1, s2
    (s, bi, mu, va, gb), w = _vectors(y, (scale, bias, mean, var, glu_b), glu_w)
    dout = dout.to(y.dtype).contiguous()
    bf16 = y.dtype == torch.bfloat16
    lib = _build.library()
    tiles = lib.dcase_bn_glu_pool_tiles(T, Fq, pt, pf)
    tpb = _tiles_per_block(tiles, B, _TARGET_BLOCKS_BWD)
    slots = -(-tiles // tpb) * B
    width = C * C + 3 * C
    partials = torch.empty((slots, width), dtype=torch.float32, device=y.device)
    sums = torch.empty(width, dtype=torch.float32, device=y.device)
    dyp = None if recompute else torch.empty_like(y)
    seed_t = _seed_tensor(seed, y.device)
    status = lib.dcase_bn_glu_pool_bwd(
        y.data_ptr(), dout.data_ptr(), s.data_ptr(), bi.data_ptr(), mu.data_ptr(), va.data_ptr(),
        w.data_ptr(), gb.data_ptr(), None if dyp is None else dyp.data_ptr(), partials.data_ptr(),
        sums.data_ptr(), B, T, Fq, C, pt, pf, float(eps), seed_t.data_ptr(), threshold, keep_scale, packed, tpb,
        int(bf16), *(bf16_reduce_plan(C, pool) if bf16 else reduce_plan(C, pool))[:2],
        _build.stream_handle(y.device),
    )
    _build.check(status, "bwd_reduce")
    _build.count_launch(bwd_reduce, "launches_nodyp" if recompute else "launches", y.dtype)
    count_packed(bwd_reduce, packed)
    dw, db, s1, s2 = sums[: C * C].view(C, C), sums[C * C: C * C + C], sums[C * C + C: C * C + 2 * C], sums[C * C + 2 * C:]
    return dyp, dw, db, s1, s2


bwd_reduce.launches = 0  # float32 launches that store dy_partial
bwd_reduce.launches_bf16 = 0
bwd_reduce.launches_nodyp = 0  # launches that store none (the recompute fixup follows)
bwd_reduce.launches_nodyp_bf16 = 0
bwd_reduce.launches_packed = 0  # launches of any mode that drew the packed mask


def bwd_fixup_recompute(y, dout, scale, bias, mean, var, glu_w, glu_b, a, b, pool, eps, *, rate: float = 0.0,
                        seed=0, pack_bits: Optional[bool] = None):
    """K2b, second pass without dy_partial: dxn rebuilt per pixel tile from
    y and dout (the first pass's tiles, mask and roundings), then dy =
    inv·γ·dxn − a − (y − mean)·b in float32, rounded once to y's dtype; a, b
    from `bwd_coefficients`. The same rate, seed and draw as the first pass.
    CPU: the plain version."""
    pool = tuple(int(p) for p in pool)
    _check(y, pool, "bwd_fixup_recompute")
    _check_dout(y, dout, pool, "bwd_fixup_recompute")
    pack_bits = pack_mode(pack_bits)
    threshold, keep_scale, packed = dropout_args(rate, pack_bits)
    if y.device.type == "cpu":
        mask = dropout_keep_mask(seed, y.shape, rate, pack_bits=pack_bits) if rate > 0.0 else None
        return bwd_fixup_recompute_reference(y, dout, scale, bias, mean, var, glu_w, glu_b, a, b, pool, eps, mask,
                                             1.0 - rate)
    B, T, Fq, C = y.shape
    pt, pf = pool
    (s, bi, mu, va, gb, av, bv), w = _vectors(y, (scale, bias, mean, var, glu_b, a, b), glu_w)
    dout = dout.to(y.dtype).contiguous()
    lib = _build.library()
    bf16 = y.dtype == torch.bfloat16
    buffers, drows, _ = fixup_plan(C, pool, y.dtype)
    blocks = min(_fixup_blocks(y.device.index, C, bf16, buffers, drows), B * lib.dcase_bn_glu_pool_tiles(T, Fq, pt, pf))
    dy = torch.empty_like(y)
    seed_t = _seed_tensor(seed, y.device)
    status = lib.dcase_bn_bwd_fixup_recompute(
        y.data_ptr(), dout.data_ptr(), s.data_ptr(), bi.data_ptr(), mu.data_ptr(), va.data_ptr(), w.data_ptr(),
        gb.data_ptr(), av.data_ptr(), bv.data_ptr(), dy.data_ptr(), B, T, Fq, C, pt, pf, float(eps),
        seed_t.data_ptr(), threshold, keep_scale, packed, blocks, int(bf16), buffers, drows,
        _build.stream_handle(y.device),
    )
    _build.check(status, "bwd_fixup_recompute")
    _build.count_launch(bwd_fixup_recompute, "launches", y.dtype)
    count_packed(bwd_fixup_recompute, packed)
    return dy


bwd_fixup_recompute.launches = 0
bwd_fixup_recompute.launches_bf16 = 0
bwd_fixup_recompute.launches_packed = 0


def bwd_fixup(y, dy_partial, a, b, mean):
    """K2b, second pass: dy = dy_partial − a − (y − mean)·b in y's dtype,
    written over dy_partial on the card (in place: dy_partial is scratch of
    the backward). CPU: the plain version."""
    if y.shape != dy_partial.shape:
        raise ValueError(f"dy_partial {tuple(dy_partial.shape)} does not match y {tuple(y.shape)}")
    if y.device.type == "cpu":
        return bwd_fixup_reference(y, dy_partial, a, b, mean)
    if y.device.type != "cuda":
        raise ValueError(f"bwd_fixup runs on cpu or cuda tensors, got {y.device}")
    C = y.shape[-1]
    for t in (y, dy_partial):
        if t.dtype != y.dtype or y.dtype not in DTYPES or not t.is_contiguous():
            raise ValueError("y and dy_partial must be contiguous, of one dtype, float32 or bfloat16")
    vecs = [v.detach().to(device=y.device, dtype=torch.float32).contiguous() for v in (a, b, mean)]
    if any(tuple(v.shape) != (C,) for v in vecs) or C % 4 != 0:
        raise ValueError(f"a, b, mean must be [{C}] with C a multiple of 4")
    lib = _build.library()
    status = lib.dcase_bn_bwd_fixup(y.data_ptr(), dy_partial.data_ptr(), vecs[0].data_ptr(), vecs[1].data_ptr(),
                                    vecs[2].data_ptr(), y.numel(), C, int(y.dtype == torch.bfloat16),
                                    _build.stream_handle(y.device))
    _build.check(status, "bwd_fixup")
    _build.count_launch(bwd_fixup, "launches", y.dtype)
    return dy_partial


bwd_fixup.launches = 0
bwd_fixup.launches_bf16 = 0


# ------------------------------------------------------- autograd Function


class _FusedBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, scale, bias, mean, var, glu_w, glu_b, seed, rate, pool, eps, train, pack_bits, recompute,
                mesh):
        rate = float(rate) if train else 0.0
        seed = torch.as_tensor(seed, dtype=torch.int64).reshape(1).clone()
        ctx.save_for_backward(y, scale, bias, mean, var, glu_w, glu_b, seed)
        ctx.rate, ctx.pool, ctx.eps = rate, tuple(int(p) for p in pool), float(eps)
        # the modes this forward ran under: the backward regenerates its mask
        ctx.pack_bits, ctx.recompute = pack_mode(pack_bits), recompute_mode(recompute)
        ctx.mesh = mesh
        return fused_bn_glu_pool(y, scale, bias, mean, var, glu_w, glu_b, pool, eps, rate=rate, seed=seed,
                                 pack_bits=ctx.pack_bits)

    @staticmethod
    def backward(ctx, dout):
        y, scale, bias, mean, var, glu_w, glu_b, seed = ctx.saved_tensors
        dout = dout.to(y.dtype).contiguous()
        kw = dict(rate=ctx.rate, seed=seed, pack_bits=ctx.pack_bits)
        dyp, dw, db, s1, s2 = bwd_reduce(y, dout, scale, bias, mean, var, glu_w, glu_b, ctx.pool, ctx.eps,
                                         recompute=ctx.recompute, **kw)
        B, T, Fq, _ = y.shape
        # the forward normalised with the global batch's statistics, so the
        # coefficients take the global S1, S2 and n (JAX fused_block.py:529-536)
        s1g, s2g, n = global_sums(s1, s2, B * T * Fq, ctx.mesh)
        a, b = bwd_coefficients(scale.detach().to(torch.float32), var.to(torch.float32), ctx.eps, s1g, s2g, n)
        if ctx.recompute:
            dy = bwd_fixup_recompute(y, dout, scale, bias, mean, var, glu_w, glu_b, a, b, ctx.pool, ctx.eps, **kw)
        else:
            dy = bwd_fixup(y, dyp, a, b, mean)
        # dscale = S2, dbias = S1 and dw, db stay this rank's sums (the step's
        # gradient mean makes them the global batch's); mean/var are detached
        # inputs; seed, rate, pool, eps, train, the modes and the mesh take no
        # gradient
        return dy, s2, s1, None, None, dw, db, None, None, None, None, None, None, None, None


def global_sums(s1, s2, n: int, mesh):
    """S1, S2 and the element count of the global batch: under a
    data-parallel mesh S1 and S2 summed over the ranks in one all-reduce and
    n = local · world; without one, as given."""
    if mesh is None:
        return s1, s2, n
    s1, s2 = all_reduce_(torch.cat([s1, s2]), mesh, "bn_backward").split(s1.numel())
    return s1, s2, n * mesh.world_size


def fused_bn_glu_dropout_pool(y, scale, bias, mean, var, glu_w, glu_b, seed, rate: float,
                              pool: Tuple[int, int], eps: float, train: bool, *,
                              pack_bits: Optional[bool] = None, recompute: Optional[bool] = None, mesh=None):
    """Fused BN→GLU→dropout→avg-pool with its exact backward.

    y [B, T, F, C] conv output (float32 or bfloat16: the compute dtype,
    which the output and dy keep); mean/var the batch statistics of y (or
    the running ones), passed WITHOUT a graph: the backward holds the full
    BN-training backward and returns (dy, dscale, dbias, None, None, dw,
    db). seed: int or integer tensor, new each step; `train` switches the
    dropout on (rate is ignored in eval mode). `pack_bits` and `recompute`
    (default PACK_BITS and RECOMPUTE_FIXUP, read here) are recorded for the
    backward. Under a data-parallel `mesh` mean/var are the global batch's,
    and the backward sums S1, S2 over the ranks between its passes: only
    the fixup runs after the collective."""
    if mean.requires_grad or var.requires_grad:
        raise ValueError("mean and var must be detached: the backward already carries the "
                         "through-statistics terms")
    return _FusedBlock.apply(y, scale, bias, mean, var, glu_w, glu_b, seed, rate, pool, eps, train,
                             pack_mode(pack_bits), recompute_mode(recompute), mesh)
