"""Layers on NHWC tensors and the parameter initialisers (counterpart of
dcase2019_task4_tpu/models/layers.py).

The entry conv (block 1, one input channel) is an XLA im2col in the JAX
package, not a Pallas kernel, so here it is `F.conv2d` (with autograd), in
the model's compute dtype.
BatchNorm (running or batch statistics), GLU, context gating, dropout and
average pooling serve the geometries where the fused kernels do not apply.
Layout is NHWC ([batch, time, freq, channel]) at every function boundary,
as in the JAX package. Every random draw takes an explicit
`torch.Generator`, is made on the generator's device and moved to the
tensor's, so a run on the card with a CPU generator repeats a CPU run.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dcase2019_task4_tpu_torch.parallel.mesh import all_reduce_sum


def conv2d(weight, bias, x: torch.Tensor, stride: int = 1, padding: int = 1) -> torch.Tensor:
    """NHWC conv with an OIHW weight (nn.Conv2d layout) → NHWC, contiguous,
    in x's dtype. Runs in channels-last memory so the result is NHWC without
    a copy.

    In bfloat16 (x bfloat16, weight and bias float32) it rounds as the JAX
    package's conv of a bfloat16 model does (layers.conv2d_apply,
    conv2d_entry_packed): the weight is cast to bfloat16, the products
    accumulate in float32 and round once to bfloat16 (cuDNN on the card,
    oneDNN on the CPU), and the bias, cast to bfloat16, is added in
    bfloat16. Autograd gives the weight the gradient of its bfloat16 copy."""
    low = x.dtype == torch.bfloat16
    xc = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    y = F.conv2d(xc, weight.to(x.dtype), None if low else bias, stride=stride, padding=padding)
    y = y.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
    return y + bias.to(x.dtype) if low else y


def batchnorm_eval(x, scale, bias, mean, var, eps: float):
    """BatchNorm over the channel axis with running statistics."""
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def batchnorm_train(x, scale, bias, running_mean, running_var, eps: float, momentum: float, mesh=None):
    """BatchNorm over all axes but the channel with batch statistics, in the
    graph (torch BatchNorm2d semantics): biased variance to normalise,
    unbiased for the running update, running ← (1−m)·running + m·batch,
    written into the two buffers in place.

    Under a data-parallel `mesh` of more than one rank the statistics are
    the global batch's, as the JAX layer forms them (layers.py:176-181):
    Σx and Σx² summed over the ranks in one buffer, n = local · world,
    var = Σx²/n − mean². The sum is differentiable: its backward sums the
    cotangent over the ranks. At world size 1 the single-process formulas
    above stand, whose bits Σx²/n − mean² would not repeat."""
    axes = tuple(range(x.dim() - 1))
    n = x.numel() // x.shape[-1]
    if mesh is not None and mesh.world_size > 1:
        s, sq = all_reduce_sum(torch.cat([x.sum(dim=axes), (x * x).sum(dim=axes)]), mesh).split(x.shape[-1])
        n *= mesh.world_size
        mean = s / n
        var = sq / n - mean * mean
    else:
        mean = x.mean(dim=axes)
        var = x.var(dim=axes, unbiased=False)
    update_running_stats(running_mean, running_var, mean, var, n, momentum)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


@torch.no_grad()
def update_running_stats(running_mean, running_var, mean, var, n: int, momentum: float):
    """running ← (1−m)·running + m·batch, the variance unbiased (·n/(n−1))."""
    unbiased = var * (n / max(n - 1, 1))
    running_mean.mul_(1.0 - momentum).add_(mean.detach(), alpha=momentum)
    running_var.mul_(1.0 - momentum).add_(unbiased.detach(), alpha=momentum)


def draw(sample, shape, generator: torch.Generator, device) -> torch.Tensor:
    """`sample(shape, generator=..., device=...)` on the generator's device,
    moved to `device`."""
    return sample(tuple(shape), generator=generator, device=generator.device).to(device)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout with a keep-mask drawn from `generator`."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = draw(torch.rand, x.shape, generator, x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def glu(x, weight, bias):
    """Reference GLU (models/CNN.py:5-16): linear(x) · σ(x) over channels;
    weight [out, in] (nn.Linear layout)."""
    return F.linear(x, weight, bias) * torch.sigmoid(x)


def context_gating(x, weight, bias):
    """Reference ContextGating (models/CNN.py:19-30): x · σ(linear(x))."""
    return x * torch.sigmoid(F.linear(x, weight, bias))


def activation(kind: str, x, weight=None, bias=None):
    if kind == "glu":
        return glu(x, weight, bias)
    if kind == "cg":
        return context_gating(x, weight, bias)
    if kind == "relu":
        return F.relu(x)
    if kind == "leakyrelu":
        return F.leaky_relu(x, 0.2)
    raise ValueError(f"unknown activation: {kind}")


def avg_pool(x, pool):
    """Mean pooling with window = stride = (pt, pf) over (time, freq) of
    NHWC; trailing rows or columns that do not fill a window are dropped
    (VALID)."""
    pt, pf = pool
    B, T, Fq, C = x.shape
    x = x[:, : T - T % pt, : Fq - Fq % pf]
    return x.reshape(B, T // pt, pt, Fq // pf, pf, C).mean(dim=(2, 4))


# ------------------------------------------------------------ initialisers


@torch.no_grad()
def conv2d_init_(weight, bias, generator: torch.Generator):
    """Xavier-uniform with gain √2 on an OIHW kernel, zero bias."""
    out_ch, in_ch, kh, kw = weight.shape
    limit = (2.0 ** 0.5) * (6.0 / ((in_ch + out_ch) * kh * kw)) ** 0.5
    weight.copy_((draw(torch.rand, weight.shape, generator, weight.device) * 2.0 - 1.0) * limit)
    bias.zero_()


@torch.no_grad()
def batchnorm_init_(bn, generator: torch.Generator):
    """Scale N(1, 0.02), zero bias, running mean 0 and variance 1."""
    bn.weight.copy_(1.0 + 0.02 * draw(torch.randn, bn.weight.shape, generator, bn.weight.device))
    bn.bias.zero_()
    bn.running_mean.zero_()
    bn.running_var.fill_(1.0)


@torch.no_grad()
def linear_init_(linear, generator: torch.Generator):
    """N(0, 0.01) weight, zero bias."""
    linear.weight.copy_(0.01 * draw(torch.randn, linear.weight.shape, generator, linear.weight.device))
    linear.bias.zero_()
