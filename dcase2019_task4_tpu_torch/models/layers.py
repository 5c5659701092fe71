"""Eval-mode layers on NHWC tensors (counterpart of
dcase2019_task4_tpu/models/layers.py).

The entry conv (block 1, one input channel) is an XLA im2col in the JAX
package, not a Pallas kernel, so here it is `F.conv2d`. Eval BatchNorm,
GLU, context gating and average pooling serve the geometries where the
fused kernels do not apply. Layout is NHWC ([batch, time, freq, channel])
at every function boundary, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d(weight, bias, x: torch.Tensor, stride: int = 1, padding: int = 1) -> torch.Tensor:
    """NHWC conv with an OIHW weight (nn.Conv2d layout) → NHWC, contiguous.
    Runs in channels-last memory so the result is NHWC without a copy."""
    xc = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    y = F.conv2d(xc, weight, bias, stride=stride, padding=padding)
    return y.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)


def batchnorm_eval(x, scale, bias, mean, var, eps: float):
    """BatchNorm over the channel axis with running statistics."""
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


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
