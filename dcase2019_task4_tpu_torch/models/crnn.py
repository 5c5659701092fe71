"""The CRNN: conv-BN-GLU-pool ×3 → BiGRU ×2 → strong/weak heads, in eval and
in training mode.

PyTorch counterpart of dcase2019_task4_tpu/models/crnn.py. Inputs and
outputs keep the JAX layout: x [B, T, F] → strong [B, T', nclass], weak
[B, nclass]. Per block:

  * block 1 (one input channel, 3×3 s1 p1): `F.conv2d` with autograd — the
    JAX package computes it outside any Pallas kernel
    (layers.conv2d_entry_packed);
  * blocks with a 3×3 s1 p1 Cin == Cout conv (blocks 2 and 3): K3
    (ops/packed_conv.py: forward, dx and wgrad kernels);
  * any other conv: `F.conv2d`;
  * then, where the geometry allows, K2 (ops/fused_block.py) for
    BN → GLU → dropout → pool in one pass each way; otherwise BatchNorm,
    activation, dropout, pool in plain ops.

In training mode (`model.train()`) each fused block takes the batch Σy and
Σy² from K2s, forms mean, biased variance and the unbiased running update
as the JAX model does (crnn.py:321-351), draws one dropout seed from the
caller's generator, and calls the fused Function with the statistics
detached: its backward already carries the through-statistics terms. The
BatchNorm buffers are updated in place and belong to this module alone, so
a student and an EMA teacher keep their own. Dropout follows the GRU.

The attention head keeps the reference's semantics: softmax over the
class axis, normalisation summed over time (models/CRNN.py:77-83).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from dcase2019_task4_tpu_torch.config import ModelConfig
from dcase2019_task4_tpu_torch.models import layers as L
from dcase2019_task4_tpu_torch.ops import fused_block, packed_conv
from dcase2019_task4_tpu_torch.ops.gru import bigru, bigru_init_

_SEED_HIGH = 2 ** 31 - 2 ** 20  # dropout seeds are drawn from [0, _SEED_HIGH), as in the JAX model


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

    def _block(self, i: int, block: ConvBlock, x: torch.Tensor, use_fused: bool,
               generator: Optional[torch.Generator]) -> torch.Tensor:
        cfg = self.cfg
        conv = block.conv
        train = self.training
        rate = cfg.dropout if train else 0.0
        same_3x3 = cfg.kernel_size[i] == 3 and cfg.stride[i] == 1 and cfg.padding[i] == 1
        if (
            use_fused
            and same_3x3
            and conv.in_channels == conv.out_channels
            and packed_conv.applicable(x.shape[2], x.shape[3])
        ):
            x = packed_conv.conv2d_packed({"w": conv.weight.permute(2, 3, 1, 0), "b": conv.bias}, x.contiguous())
        else:
            x = L.conv2d(conv.weight, conv.bias, x, cfg.stride[i], cfg.padding[i])
        pool = tuple(cfg.pooling[i])
        bn = block.bn
        if use_fused and cfg.activation == "glu" and fused_block.applicable(x.shape, pool):
            x = x.contiguous()
            if train:
                # Σy, Σy² without a graph; var = Σy²/n − mean² as in the JAX model
                s, sq = fused_block.batch_stats(x)
                n = x.numel() // x.shape[-1]
                mean = s / n
                var = sq / n - mean * mean
                L.update_running_stats(bn.running_mean, bn.running_var, mean, var, n, cfg.bn_momentum)
                seed = L.draw(lambda shape, **kw: torch.randint(0, _SEED_HIGH, shape, dtype=torch.int64, **kw),
                              (1,), generator, generator.device)
            else:
                mean, var, seed = bn.running_mean, bn.running_var, 0
            return fused_block.fused_bn_glu_dropout_pool(
                x, bn.weight, bn.bias, mean, var, block.act.weight.t(), block.act.bias,
                seed, rate, pool, cfg.bn_eps, train,
            )
        if train:
            x = L.batchnorm_train(x, bn.weight, bn.bias, bn.running_mean, bn.running_var,
                                  cfg.bn_eps, cfg.bn_momentum)
        else:
            x = L.batchnorm_eval(x, bn.weight, bn.bias, bn.running_mean, bn.running_var, cfg.bn_eps)
        act = block.act
        x = L.activation(cfg.activation, x, act.weight if act else None, act.bias if act else None)
        if rate > 0.0:
            x = L.dropout(x, rate, generator)
        return L.avg_pool(x, pool)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, T, F] (or [B, T, F, 1]) features → (strong, weak). In
        training mode `generator` feeds every dropout draw (the global CPU
        generator when None) and the BatchNorm buffers are updated. Eval
        mode is inference: it runs without a graph."""
        if not self.training:
            with torch.no_grad():
                return self._forward(x, None)
        return self._forward(x, torch.default_generator if generator is None else generator)

    def _forward(self, x, generator):
        if x.dim() == 3:
            x = x[..., None]
        use_fused = self._use_fused()
        for i, block in enumerate(self.cnn):
            x = self._block(i, block, x, use_fused, generator)
        B, T, Fq, C = x.shape
        x = x[:, :, 0, :] if Fq == 1 else x.permute(0, 1, 3, 2).reshape(B, T, C * Fq)
        x, _ = self.rnn(x.contiguous())
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
