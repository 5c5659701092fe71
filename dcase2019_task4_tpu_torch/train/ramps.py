"""Hyperparameter ramp schedules (counterpart of
dcase2019_task4_tpu/train/ramps.py; same curves as the reference's
utils/ramps.py).

Each function takes the current step as a Python number or a tensor and
returns the same kind: tensors stay on their device, so a step counter kept
on the card never has to be read back.
"""

from __future__ import annotations

import math

import torch


def _clip01(x):
    if isinstance(x, torch.Tensor):
        return x.clamp(0.0, 1.0)
    return min(max(float(x), 0.0), 1.0)


def _exp(x):
    return torch.exp(x) if isinstance(x, torch.Tensor) else math.exp(x)


def _one(current):
    return torch.ones_like(current, dtype=torch.float32) if isinstance(current, torch.Tensor) else 1.0


def sigmoid_rampup(current, rampup_length):
    """exp(−5·(1−t)²) rampup; 1.0 when rampup_length == 0."""
    if rampup_length == 0:
        return _one(current)
    phase = 1.0 - _clip01(current / rampup_length)
    return _exp(-5.0 * phase * phase)


def linear_rampup(current, rampup_length):
    if rampup_length == 0:
        return _one(current)
    return _clip01(current / rampup_length)


def cosine_rampdown(current, rampdown_length):
    t = _clip01(current / rampdown_length)
    cos = torch.cos(math.pi * t) if isinstance(t, torch.Tensor) else math.cos(math.pi * t)
    return 0.5 * (cos + 1.0)


def sigmoid_rampdown(current, rampdown_length):
    if rampdown_length == 0:
        return _one(current)
    phase = 1.0 - _clip01(current / rampdown_length)
    return _exp(-12.5 * phase * phase)
