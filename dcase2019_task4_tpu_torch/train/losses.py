"""Losses of the Mean-Teacher objective (counterpart of
dcase2019_task4_tpu/train/losses.py).

  * weak BCE on the weak slice of the batch: BCE(weak_pred, max_t target)
  * strong BCE on the synthetic slice: BCE(strong_pred, target)
  * MSE consistency between student and (detached) teacher over the whole
    batch, for both heads

All reductions are means, like torch's BCELoss/MSELoss defaults. Streams
are selected with static batch slices (the fixed multi-stream layout).
"""

from __future__ import annotations

import torch

EPS = 1e-7


def bce(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy on probabilities, mean reduction; predictions
    are clamped to [EPS, 1 − EPS]."""
    p = pred.clamp(EPS, 1.0 - EPS)
    return -(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p)).mean()


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a - b) ** 2).mean()


def weak_bce(weak_pred, target, weak_slice: slice):
    """target is the [B, T, C] strong grid; the weak target is its max over
    time."""
    target_weak = target.amax(dim=-2)
    return bce(weak_pred[weak_slice], target_weak[weak_slice])


def strong_bce(strong_pred, target, strong_slice: slice):
    return bce(strong_pred[strong_slice], target[strong_slice])


def consistency(strong_pred, weak_pred, strong_teacher, weak_teacher, weight):
    """weight · (MSE_strong + MSE_weak) over the whole batch. The teacher
    tensors must carry no graph."""
    return weight * mse(strong_pred, strong_teacher) + weight * mse(weak_pred, weak_teacher)
