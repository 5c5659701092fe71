"""K2 forward, eval mode: BatchNorm (running statistics) → GLU → avg-pool.

PyTorch counterpart of dcase2019_task4_tpu/ops/fused_block.py
(fused_bn_glu_dropout_pool with train=False). On a CUDA tensor
`fused_bn_glu_pool` launches the hand-written kernel in
csrc/fused_block.cu, which reads each activation slab once and writes only
the pooled output; on a CPU tensor it runs `reference_block`, the plain
chain. Train mode (batch statistics, dropout) and the backward are later
work: `rate` and `seed` hold their place in the signature, and a rate
other than 0 is refused.
"""

from __future__ import annotations

from typing import Tuple

import torch

from dcase2019_task4_tpu_torch.ops import _build

_TILE_PIXELS = 128  # csrc/fused_block.cu kPix
_TARGET_BLOCKS = 1056  # 8 resident blocks on each of the H100's 132 SMs


def applicable(shape, pool: Tuple[int, int]) -> bool:
    """Whether the fused block takes a [B, T, F, C] activation: whole
    pooling windows (T % pt == F % pf == 0), a pooling row of at most one
    pixel tile, and C ≤ 128."""
    B, T, Fq, C = shape
    pt, pf = pool
    return T % pt == 0 and Fq % pf == 0 and pt * Fq <= _TILE_PIXELS and C <= 128


def reference_block(y, scale, bias, mean, var, glu_w, glu_b, pool, eps):
    """Plain twin: BN→GLU→avg-pool on [B, T, F, C] (glu_w [in, out])."""
    inv = torch.rsqrt(var + eps)
    xn = (y - mean) * inv * scale + bias
    g = (xn @ glu_w + glu_b) * torch.sigmoid(xn)
    B, T, Fq, C = g.shape
    pt, pf = pool
    return g.reshape(B, T // pt, pt, Fq // pf, pf, C).mean(dim=(2, 4))


def fused_bn_glu_pool(y, scale, bias, mean, var, glu_w, glu_b, pool, eps, *, rate: float = 0.0, seed: int = 0):
    """y [B, T, F, C] conv output → pooled [B, T/pt, F/pf, C]; eval-mode BN
    with running mean/var; glu_w [C, C] as (in, out). CPU: the plain twin.
    CUDA: the kernel."""
    if rate != 0.0:
        raise NotImplementedError("train-mode dropout is not ported yet (rate must be 0)")
    pool = tuple(int(p) for p in pool)
    if y.dim() != 4 or not applicable(y.shape, pool):
        raise ValueError(f"fused_bn_glu_pool does not take y {tuple(y.shape)} with pool {pool}")
    if y.device.type == "cpu":
        return reference_block(y, scale, bias, mean, var, glu_w, glu_b, pool, eps)
    if y.device.type != "cuda":
        raise ValueError(f"fused_bn_glu_pool runs on cpu or cuda tensors, got {y.device}")
    if y.dtype != torch.float32 or not y.is_contiguous():
        raise ValueError(f"y must be contiguous float32, got {y.dtype}")
    B, T, Fq, C = y.shape
    vecs = [v.to(device=y.device, dtype=torch.float32).contiguous() for v in (scale, bias, mean, var, glu_b)]
    w = glu_w.to(device=y.device, dtype=torch.float32).contiguous()
    if any(tuple(v.shape) != (C,) for v in vecs) or tuple(w.shape) != (C, C):
        raise ValueError(f"per-channel vectors must be [{C}] and glu_w [{C}, {C}]")
    pt, pf = pool
    lib = _build.library()
    tiles = lib.dcase_bn_glu_pool_tiles(T, Fq, pt)
    tiles_per_block = max(1, -(-tiles * B // _TARGET_BLOCKS))
    out = torch.empty((B, T // pt, Fq // pf, C), dtype=torch.float32, device=y.device)
    s, bi, mu, va, gb = vecs
    status = lib.dcase_bn_glu_pool_eval(
        y.data_ptr(), s.data_ptr(), bi.data_ptr(), mu.data_ptr(), va.data_ptr(),
        w.data_ptr(), gb.data_ptr(), out.data_ptr(), B, T, Fq, C, pt, pf, float(eps),
        tiles_per_block, _build.stream_handle(y.device),
    )
    _build.check(status, "fused_bn_glu_pool")
    fused_bn_glu_pool.launches += 1
    return out


fused_bn_glu_pool.launches = 0
