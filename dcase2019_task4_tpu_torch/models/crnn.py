"""The CRNN: conv-BN-GLU-pool ×3 → BiGRU ×2 → strong/weak heads, in eval and
in training mode.

PyTorch counterpart of dcase2019_task4_tpu/models/crnn.py. Inputs and
outputs keep the JAX layout: x [B, T, F] → strong [B, T', nclass], weak
[B, nclass]. Per block:

  * block 1 (one input channel, 3×3 s1 p1), in the JAX model's order of
    precedence: with `entry_block_crows` or `entry_block_pallas` the whole
    block as fused kernels (ops/crows_block.py, ops/fused_entry_block.py:
    statistics without a stored y, forward, two-pass backward); with
    `entry_conv_pallas` K4 (ops/entry_conv.py), whose forward also hands
    Σy, Σy² to the fused block so that block 1 runs no statistics pass; by
    default `F.conv2d` with autograd — the JAX package computes that one
    outside any Pallas kernel (layers.conv2d_entry_packed). Where a gate
    says a shape does not apply, the next path runs;
  * blocks with a 3×3 s1 p1 Cin == Cout conv (blocks 2 and 3): K3
    (ops/packed_conv.py: forward, dx and wgrad kernels);
  * any other conv: `F.conv2d`;
  * then, where the geometry allows, K2 (ops/fused_block.py) for
    BN → GLU → dropout → pool in one pass each way; otherwise BatchNorm,
    activation, dropout, pool in plain ops.

Compute dtype (`ModelConfig.compute_dtype`, as the JAX model,
crnn.py:86-92,201,218,222,253): float32, or bfloat16, in which x is cast to
bfloat16 before each conv and the conv stack's activations stay bfloat16
(the convs and the fused blocks take and give bfloat16, accumulating in
float32); parameters, BatchNorm statistics, the GRU (its input is cast back
to float32), the heads and the probabilities stay float32. The first-block
kernels (K4-K6) take the compute dtype too (the JAX model hands it to
entry_conv_apply, entry_block_apply and crows_apply, crnn.py:103-199), and
each reproduces its own original's bfloat16 roundings. The bfloat16 model
runs through the fused kernels only: the plain BatchNorm branch raises
NotImplementedError.

In training mode (`model.train()`) each fused block takes the batch Σy and
Σy² from K2s, forms mean, biased variance and the unbiased running update
as the JAX model does (crnn.py:321-351), draws one dropout seed from the
caller's generator, and calls the fused Function with the statistics
detached: its backward already carries the through-statistics terms. The
BatchNorm buffers are updated in place and belong to this module alone, so
a student and an EMA teacher keep their own. Dropout follows the GRU.

Data parallel (`forward(..., mesh=)`, the JAX model's batch_axis /
axis_size): every training BatchNorm takes the global batch's statistics.
The fused blocks' Σy, Σy² are summed over the ranks in one buffer with
n = local · world (`_batch_moments`), and each fused Function sums its
backward's S1, S2 over the ranks between its two passes; the plain
BatchNorm sums through a differentiable all-reduce (models/layers.py).

In eval mode every kernel is reached through its torch.library op (the
`dcase19_torch` namespace, registered beside each wrapper in ops/): K3f
`conv2d_forward`, K2f `fused_bn_glu_pool_eval`, and for block 1 under the
flags K4f `entry_conv_forward`, K5f `entry_block_fwd_eval` or K6
`crows_block_fwd_eval`, so that predict, evaluate and the serving export
(eval/export.py, torch.export) run one code path. The training forward
keeps the autograd Functions.

The attention head keeps the reference's semantics: softmax over the
class axis, normalisation summed over time (models/CRNN.py:77-83).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from dcase2019_task4_tpu_torch.config import ModelConfig
from dcase2019_task4_tpu_torch.models import layers as L
from dcase2019_task4_tpu_torch.ops import crows_block, entry_conv, fused_block, fused_entry_block, packed_conv
from dcase2019_task4_tpu_torch.ops.gru import bigru, bigru_init_
from dcase2019_task4_tpu_torch.parallel.mesh import all_reduce_

_SEED_HIGH = 2 ** 31 - 2 ** 20  # dropout seeds are drawn from [0, _SEED_HIGH), as in the JAX model
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    """The torch dtype of `cfg.compute_dtype`; ValueError for any other."""
    if cfg.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: float32 or bfloat16")
    return COMPUTE_DTYPES[cfg.compute_dtype]


class ConvBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, cfg: ModelConfig, i: int, device=None):
        super().__init__()
        k = cfg.kernel_size[i]
        self.conv = nn.Conv2d(in_ch, out_ch, k, stride=cfg.stride[i], padding=cfg.padding[i],
                              device=device)
        self.bn = nn.BatchNorm2d(out_ch, eps=cfg.bn_eps, momentum=cfg.bn_momentum, device=device)
        self.act = nn.Linear(out_ch, out_ch, device=device) if cfg.activation in ("glu", "cg") else None


class CRNN(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype(cfg)
        blocks = []
        in_ch = cfg.n_in_channel
        for i, out_ch in enumerate(cfg.nb_filters):
            blocks.append(ConvBlock(in_ch, out_ch, cfg, i, device=device))
            in_ch = out_ch
        self.cnn = nn.ModuleList(blocks)
        self.rnn = bigru(cfg.nb_filters[-1], cfg.n_rnn_cell, cfg.n_layers_rnn, device=device)
        self.dense = nn.Linear(cfg.n_rnn_cell * 2, cfg.nclass, device=device)
        self.dense_softmax = (
            nn.Linear(cfg.n_rnn_cell * 2, cfg.nclass, device=device) if cfg.attention else None
        )

    def _use_fused(self) -> bool:
        # auto: the fused block exists for GLU only (as in the JAX package)
        if self.cfg.fused_block is None:
            return self.cfg.activation == "glu"
        return bool(self.cfg.fused_block)

    def _draw_seed(self, generator: torch.Generator) -> torch.Tensor:
        """One dropout seed for a fused block, from the caller's generator."""
        return L.draw(lambda shape, **kw: torch.randint(0, _SEED_HIGH, shape, dtype=torch.int64, **kw),
                      (1,), generator, generator.device)

    def _batch_moments(self, bn, s, sq, n: int, mesh):
        """Σy, Σy² → (mean, biased var = Σy²/n − mean²) as the JAX model forms
        them, with the running buffers updated in place. Under a mesh the
        sums are the global batch's (one all-reduce of both, no graph) and
        n = local · world, in the unbiased factor too."""
        if mesh is not None:
            s, sq = all_reduce_(torch.cat([s, sq]), mesh, "bn_stats").split(s.numel())
            n *= mesh.world_size
        mean = s / n
        var = sq / n - mean * mean
        L.update_running_stats(bn.running_mean, bn.running_var, mean, var, n, self.cfg.bn_momentum)
        return mean, var

    def _entry_engine(self, block: ConvBlock, x: torch.Tensor, use_fused: bool):
        """(statistics pass, fused block, its eval-mode op) of the entries
        that run the whole first block as fused kernels under this
        configuration and input, or None: crows before planes, as in the JAX
        model."""
        cfg = self.cfg
        if not (use_fused and cfg.activation == "glu"):
            return None
        pool, C0 = tuple(cfg.pooling[0]), block.conv.out_channels
        if cfg.entry_block_crows and C0 == 64 and crows_block.crows_applicable(x.shape, pool):
            return crows_block.crows_stats_apply, crows_block.crows_apply, torch.ops.dcase19_torch.crows_block_fwd_eval
        if cfg.entry_block_pallas and fused_entry_block.entry_block_applicable(x.shape, pool, C0):
            return (fused_entry_block.entry_block_stats_apply, fused_entry_block.entry_block_apply,
                    torch.ops.dcase19_torch.entry_block_fwd_eval)
        return None

    def _entry_block(self, block: ConvBlock, x: torch.Tensor, engine,
                     generator: Optional[torch.Generator], mesh) -> torch.Tensor:
        """First block as one kernel family: batch statistics from the
        statistics pass over a conv output that is never stored, the
        running-stat update, one dropout seed, then the fused Function; in
        eval mode the entry's op on the running statistics (rate 0)."""
        cfg, bn = self.cfg, block.bn
        stats_apply, apply, eval_op = engine
        cd = self.compute_dtype
        conv = {"w": block.conv.weight.permute(2, 3, 1, 0), "b": block.conv.bias}
        if not self.training:
            return eval_op(x[..., 0].to(cd), conv["w"], conv["b"], bn.weight, bn.bias, bn.running_mean,
                           bn.running_var, block.act.weight.t(), block.act.bias, list(cfg.pooling[0]), cfg.bn_eps)
        s, sq = stats_apply(conv, x, cd)
        mean, var = self._batch_moments(bn, s, sq, x.shape[0] * x.shape[1] * x.shape[2], mesh)
        return apply(conv, bn.weight, bn.bias, mean, var, block.act.weight.t(), block.act.bias, x,
                     self._draw_seed(generator), cfg.dropout, tuple(cfg.pooling[0]), cfg.bn_eps, True,
                     compute_dtype=cd, mesh=mesh)

    def _block(self, i: int, block: ConvBlock, x: torch.Tensor, use_fused: bool,
               generator: Optional[torch.Generator], mesh) -> torch.Tensor:
        cfg = self.cfg
        conv = block.conv
        train = self.training
        rate = cfg.dropout if train else 0.0
        same_3x3 = cfg.kernel_size[i] == 3 and cfg.stride[i] == 1 and cfg.padding[i] == 1
        pool = tuple(cfg.pooling[i])
        entry_stats = None
        cd = self.compute_dtype
        entry = i == 0 and same_3x3 and x.shape[-1] == 1 and conv.in_channels == 1
        if entry:
            engine = self._entry_engine(block, x, use_fused)
            if engine is not None:
                return self._entry_block(block, x, engine, generator, mesh)
        if (
            entry
            and use_fused
            and cfg.entry_conv_pallas
            and entry_conv.entry_conv_packable(x.shape[2], conv.out_channels, x.shape[1])
        ):
            # K4: the conv kernel emits Σy, Σy² with its forward; in training
            # the fused block takes block 1's statistics from there
            params = {"w": conv.weight.permute(2, 3, 1, 0), "b": conv.bias}
            want_stats = train and cfg.activation == "glu" and fused_block.applicable(
                (x.shape[0], x.shape[1], x.shape[2], conv.out_channels), pool)
            if not train:
                x = torch.ops.dcase19_torch.entry_conv_forward(x[..., 0].to(cd), params["w"], params["b"])
            elif want_stats:
                x, *entry_stats = entry_conv.entry_conv_apply(params, x, compute_dtype=cd, want_stats=True)
            else:
                x = entry_conv.entry_conv_apply(params, x, compute_dtype=cd)
        elif (
            use_fused
            and same_3x3
            and conv.in_channels == conv.out_channels
            and packed_conv.applicable(x.shape[2], x.shape[3])
        ):
            w = conv.weight.permute(2, 3, 1, 0)
            x = x.to(cd).contiguous()
            x = (packed_conv.conv2d_packed({"w": w, "b": conv.bias}, x) if train
                 else torch.ops.dcase19_torch.conv2d_forward(x, w, conv.bias))
        else:
            x = L.conv2d(conv.weight, conv.bias, x.to(cd), cfg.stride[i], cfg.padding[i])
        bn = block.bn
        if use_fused and cfg.activation == "glu" and fused_block.applicable(x.shape, pool):
            x = x.contiguous()
            if not train:
                return torch.ops.dcase19_torch.fused_bn_glu_pool_eval(
                    x, bn.weight, bn.bias, bn.running_mean, bn.running_var, block.act.weight.t(), block.act.bias,
                    list(pool), cfg.bn_eps)
            # Σy, Σy² without a graph (K2s, or K4f's own sums); var = Σy²/n − mean² as in the JAX model
            s, sq = entry_stats if entry_stats is not None else fused_block.batch_stats(x)
            mean, var = self._batch_moments(bn, s, sq, x.numel() // x.shape[-1], mesh)
            return fused_block.fused_bn_glu_dropout_pool(
                x, bn.weight, bn.bias, mean, var, block.act.weight.t(), block.act.bias,
                self._draw_seed(generator), rate, pool, cfg.bn_eps, True, mesh=mesh,
            )
        if cd != torch.float32:
            raise NotImplementedError(f"compute_dtype {cfg.compute_dtype!r}: block {i + 1} of shape "
                                      f"{tuple(x.shape)} needs the fused block, which does not take it")
        if train:
            x = L.batchnorm_train(x, bn.weight, bn.bias, bn.running_mean, bn.running_var,
                                  cfg.bn_eps, cfg.bn_momentum, mesh)
        else:
            x = L.batchnorm_eval(x, bn.weight, bn.bias, bn.running_mean, bn.running_var, cfg.bn_eps)
        act = block.act
        x = L.activation(cfg.activation, x, act.weight if act else None, act.bias if act else None)
        if rate > 0.0:
            x = L.dropout(x, rate, generator)
        return L.avg_pool(x, pool)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None, mesh=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, T, F] (or [B, T, F, 1]) features → (strong, weak). In
        training mode `generator` feeds every dropout draw (the global CPU
        generator when None) and the BatchNorm buffers are updated, with the
        statistics of the global batch under a data-parallel `mesh`
        (parallel/mesh.py). Eval mode is inference: it runs without a graph
        and needs no mesh."""
        if not self.training:
            with torch.no_grad():
                return self._forward(x, None, None)
        return self._forward(x, torch.default_generator if generator is None else generator, mesh)

    def _forward(self, x, generator, mesh):
        if x.dim() == 3:
            x = x[..., None]
        use_fused = self._use_fused()
        for i, block in enumerate(self.cnn):
            x = self._block(i, block, x, use_fused, generator, mesh)
        B, T, Fq, C = x.shape
        x = x[:, :, 0, :] if Fq == 1 else x.permute(0, 1, 3, 2).reshape(B, T, C * Fq)
        x, _ = self.rnn(x.to(torch.float32).contiguous())
        if self.training and self.cfg.dropout > 0:
            x = L.dropout(x, self.cfg.dropout, generator)
        strong = torch.sigmoid(self.dense(x))
        if self.dense_softmax is None:
            return strong, strong.mean(dim=1)
        sof = torch.softmax(self.dense_softmax(x), dim=-1).clamp(1e-7, 1.0)
        weak = (strong * sof).sum(dim=1) / sof.sum(dim=1)
        return strong, weak


def init_(model: CRNN, generator: torch.Generator) -> CRNN:
    """The training initialisation, with the JAX package's distributions
    (not its random numbers): Xavier-uniform gain √2 convs with zero bias,
    BatchNorm scale N(1, 0.02) / bias 0 / mean 0 / var 1, GLU and head
    linears N(0, 0.01) with zero bias, orthogonal GRU gate blocks with
    U(±1/√H) biases. Every draw comes from `generator`."""
    for block in model.cnn:
        L.conv2d_init_(block.conv.weight, block.conv.bias, generator)
        L.batchnorm_init_(block.bn, generator)
        if block.act is not None:
            L.linear_init_(block.act, generator)
    bigru_init_(model.rnn, generator)
    L.linear_init_(model.dense, generator)
    if model.dense_softmax is not None:
        L.linear_init_(model.dense_softmax, generator)
    return model


def count_params(model: CRNN) -> int:
    """Trainable parameter count (BatchNorm running statistics excluded),
    equal to the JAX package's count_params over the params pytree."""
    return sum(p.numel() for p in model.parameters())


def seeded_init_(model: CRNN, seed: int) -> CRNN:
    """Fill every parameter and BatchNorm statistic from one explicit
    generator: Xavier-uniform (gain √2) convs, BN scale N(1, 0.02) and bias
    N(0, 0.02), running mean N(0, 0.1) and var U(0.5, 2), linear weights
    N(0, 1/in), GRU weights U(±1/√H). Random weights for smoke runs and
    tests, not the training init."""
    g = torch.Generator().manual_seed(seed)

    def fill(t, sample):
        with torch.no_grad():
            t.copy_(sample(tuple(t.shape)).to(t.dtype))

    def normal(std, mean=0.0):
        return lambda shape: mean + std * torch.randn(shape, generator=g)

    def uniform(lo, hi):
        return lambda shape: lo + (hi - lo) * torch.rand(shape, generator=g)

    for block in model.cnn:
        w = block.conv.weight
        fan_in, fan_out = w.shape[1] * w.shape[2] * w.shape[3], w.shape[0] * w.shape[2] * w.shape[3]
        lim = (2.0 ** 0.5) * (6.0 / (fan_in + fan_out)) ** 0.5
        fill(w, uniform(-lim, lim))
        fill(block.conv.bias, normal(0.02))
        fill(block.bn.weight, normal(0.02, 1.0))
        fill(block.bn.bias, normal(0.02))
        fill(block.bn.running_mean, normal(0.1))
        fill(block.bn.running_var, uniform(0.5, 2.0))
        if block.act is not None:
            fill(block.act.weight, normal(block.act.in_features ** -0.5))
            fill(block.act.bias, normal(0.02))
    bound = model.cfg.n_rnn_cell ** -0.5
    for p in model.rnn.parameters():
        fill(p, uniform(-bound, bound))
    for head in (model.dense, model.dense_softmax):
        if head is not None:
            fill(head.weight, normal(head.in_features ** -0.5))
            fill(head.bias, normal(0.02))
    return model
