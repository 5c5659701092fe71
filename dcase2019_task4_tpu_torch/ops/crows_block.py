"""K6: the fused first block under `ModelConfig.entry_block_crows`.

PyTorch counterpart of dcase2019_task4_tpu/ops/crows_block.py. The original
is the third TPU formulation of the first CRNN block (conv 1 → C →
BatchNorm → GLU → dropout → avg-pool): the same four functions as
ops/fused_entry_block.py (statistics, forward, two-pass backward) with
channels on TPU sublanes, pixels on lanes and the batch split in halves.
That orientation, its three shifted row copies, lane rolls, 0/1 pooling
matrices and block-diagonal weights are TPU layout. On Hopper the function
has one kernel family, csrc/entry_block.cu, and this module dispatches to
it: it holds the original's gate, the logical-parameter entry points, and
launch counters of its own (`crows_stats_apply.launches`,
`crows_apply.launches_eval`, `.launches_train`, `.launches_bwd_reduce`,
`.launches_bwd_wgrad`), raised where a kernel is launched on a call that
came through here, beside the kernels' own counters (with `_bf16` added
for the bfloat16 kernels). CPU tensors run the plain versions of
ops/fused_entry_block.py.

In float32 this entry gives the bits of the fused entry block's own
wrappers. In bfloat16 it passes layout="crows", two mode bits of the same
kernels that reproduce where the original rounds apart from
ops/fused_entry_block.py's: every GLU output g is rounded to bfloat16 before
the pool's window sum (crows_block.py:240-245; the planes kernel rounds
pt-row column sums), and dW is rounded to bfloat16 in batch halves, the two
halves of its [2C, 18] packed weight (crows_block.py:105-115,535; the
planes kernel rounds per output-frequency parity). Every other rounding of
the original matches the planes kernel's: the conv on bfloat16 features and
weights with y rounded to bfloat16 (`_conv_tile`); the GLU product, dxn and
d glu_w on bfloat16 operands (`_chain_fwd_cs`, `_recompute_dxn_cs`,
`_contract_lanes`, which rounds both operands as the planes kernel's lp
products do); dy rounded for dW, float32 for d conv_b; the upsample of the
pooled cotangent (`_upsample_cs`) scales by 1/(pt·pf) before it rounds, which
is exact here: pt = 2 and pf divides F = 64, so pt·pf is a power of two.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from dcase2019_task4_tpu_torch.ops import fused_entry_block


def crows_applicable(shape, pool: Tuple[int, int]) -> bool:
    """[B, T, F, 1] features + pool → does this configuration take them? The
    function-level conditions of the original (crows_block.py:66-71): one
    input channel, F = 64, a time pool of 2, whole frequency windows, an
    even batch and an even number of frames. Its lane-tile search
    (`_pick_l`) is TPU tiling and is not asked for here."""
    B, T, Fq, cin = shape
    pt, pf = pool
    return cin == 1 and Fq == 64 and pt == 2 and Fq % pf == 0 and B % 2 == 0 and T % 2 == 0


def crows_stats_apply(conv_params, x, compute_dtype=None):
    """x [B, T, F, 1] → per-channel (Σy, Σy²) of the entry conv output,
    float32, no graph (the statistics-only mode of the conv kernel)."""
    with fused_entry_block.called_through(crows_stats_apply):
        return fused_entry_block.entry_block_stats_apply(conv_params, x, compute_dtype)


crows_stats_apply.launches = 0
crows_stats_apply.launches_bf16 = 0


def crows_apply(conv_params, scale, bias, mean, var, glu_w, glu_b, x, seed, rate: float,
                pool: Tuple[int, int], eps: float, train: bool, compute_dtype=None, pack_bits=None, mesh=None):
    """Logical-parameter entry: x [B, T, F, 1] + conv {"w": [3, 3, 1, C], "b":
    [C]} + [C] BatchNorm vectors + [C, C] GLU weight → pooled
    [B, T/pt, F/pf, C], with the contract of
    `fused_entry_block.entry_block_apply` (detached mean/var, the two-pass
    backward inside, its S1, S2 summed over the ranks of a data-parallel
    `mesh` between the passes; `pack_bits` the dropout draw, default
    `fused_block.PACK_BITS`)."""
    if not crows_applicable((*x.shape[:3], 1), pool):
        raise ValueError(f"crows_apply does not take x {tuple(x.shape)} with pool {tuple(pool)}")
    with fused_entry_block.called_through(crows_apply):
        return fused_entry_block.entry_block_apply(conv_params, scale, bias, mean, var, glu_w, glu_b, x, seed, rate,
                                                   pool, eps, train, compute_dtype, layout="crows",
                                                   pack_bits=pack_bits, mesh=mesh)


crows_apply.launches_eval = 0
crows_apply.launches_train = 0
crows_apply.launches_bwd_reduce = 0
crows_apply.launches_bwd_wgrad = 0
crows_apply.launches_eval_bf16 = 0
crows_apply.launches_train_bf16 = 0
crows_apply.launches_bwd_reduce_bf16 = 0
crows_apply.launches_bwd_wgrad_bf16 = 0


@torch.library.custom_op("dcase19_torch::crows_block_fwd_eval", mutates_args=())
def crows_block_fwd_eval(x: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, glu_w: torch.Tensor,
                         glu_b: torch.Tensor, pool: List[int], eps: float) -> torch.Tensor:
    """K6's forward at rate 0 (K5's kernel with layout "crows", counted on
    `crows_apply.launches_eval` too) as a torch.library op: the eval-mode
    CRNN's and the serving export's only way to the first block under
    `entry_block_crows`; x in the compute dtype. The wrapper dispatches by
    x's device."""
    if not crows_applicable((*x.shape[:3], 1), pool):
        raise ValueError(f"crows_block_fwd_eval does not take x {tuple(x.shape)} with pool {tuple(pool)}")
    with fused_entry_block.called_through(crows_apply):
        return fused_entry_block.entry_block_fwd(x, conv_w, conv_b, scale, bias, mean, var, glu_w, glu_b, pool, eps,
                                                 layout="crows")


crows_block_fwd_eval.register_fake(fused_entry_block._fwd_eval_fake)
