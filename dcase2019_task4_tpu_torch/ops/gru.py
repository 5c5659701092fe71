"""Bidirectional multi-layer GRU.

The JAX package writes the BiGRU as a `lax.scan` with PyTorch's exact cell
math and weight layout (dcase2019_task4_tpu/ops/gru.py:107-158: w_ih
[3H, in], w_hh [3H, H], gates r, z, n), not as a Pallas kernel, so
`nn.GRU(bidirectional=True, batch_first=True)` is a faithful port. This
module builds it, initialises it as the JAX package does (each gate's
block of w_ih and w_hh orthogonal, biases U(±1/√H)) and maps its weights to
and from the JAX pytree (a list over layers of {"fwd": {...}, "bwd":
{...}}). Training goes through cuDNN's GRU backward.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
from torch import nn

_KEYS = (("w_ih", "weight_ih"), ("w_hh", "weight_hh"), ("b_ih", "bias_ih"), ("b_hh", "bias_hh"))
_DIRS = (("fwd", ""), ("bwd", "_reverse"))


def bigru(input_size: int, hidden: int, num_layers: int, device=None) -> nn.GRU:
    """[B, T, in] → [B, T, 2H]; no inter-layer dropout (the reference's
    dropout_recurrent is 0)."""
    return nn.GRU(input_size, hidden, num_layers=num_layers, bidirectional=True,
                  batch_first=True, device=device)


def _orthogonal(rows: int, cols: int, generator: torch.Generator) -> torch.Tensor:
    """torch.nn.init.orthogonal_ semantics from an explicit generator:
    orthonormal rows if rows ≤ cols, else orthonormal columns."""
    a = torch.randn((max(rows, cols), min(rows, cols)), generator=generator, device=generator.device)
    q, r = torch.linalg.qr(a.cpu())
    q = q * torch.sign(torch.diagonal(r))
    return q if rows >= cols else q.t()


@torch.no_grad()
def bigru_init_(gru: nn.GRU, generator: torch.Generator) -> nn.GRU:
    """Orthogonal init of every gate block ([H, in] and [H, H], gates r, z,
    n stacked on rows), biases U(±1/√H)."""
    H = gru.hidden_size
    bound = H ** -0.5
    for layer in range(gru.num_layers):
        for _, suf in _DIRS:
            for name in ("weight_ih", "weight_hh"):
                w = getattr(gru, f"{name}_l{layer}{suf}")
                w.copy_(torch.cat([_orthogonal(H, w.shape[1], generator) for _ in range(3)], dim=0))
            for name in ("bias_ih", "bias_hh"):
                b = getattr(gru, f"{name}_l{layer}{suf}")
                u = torch.rand(b.shape, generator=generator, device=generator.device)
                b.copy_((u * 2.0 - 1.0) * bound)
    return gru


def state_from_jax(rnn_params: List[Dict], prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX BiGRU params → nn.GRU state_dict entries (layouts already agree)."""
    sd = {}
    for layer, p in enumerate(rnn_params):
        for d, suf in _DIRS:
            for jk, tk in _KEYS:
                sd[f"{prefix}{tk}_l{layer}{suf}"] = torch.from_numpy(np.array(p[d][jk], np.float32))
    return sd


def state_to_jax(gru: nn.GRU) -> List[Dict]:
    """nn.GRU weights → the JAX BiGRU pytree (numpy float32)."""
    out = []
    for layer in range(gru.num_layers):
        entry = {}
        for d, suf in _DIRS:
            entry[d] = {
                jk: getattr(gru, f"{tk}_l{layer}{suf}").detach().cpu().numpy().astype(np.float32)
                for jk, tk in _KEYS
            }
        out.append(entry)
    return out
