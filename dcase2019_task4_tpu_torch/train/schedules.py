"""Optimizer hyperparameter schedules (counterpart of
dcase2019_task4_tpu/train/schedules.py).

The reference's ramped Adam (adjust_learning_rate, main.py:32-42):

  lr = rampup · rampdown · max_learning_rate
  β1 = rampdown · β1_before + (1 − rampdown) · β1_after
  β2 = (1 − rampup) · β2_during + rampup · β2_after

The JAX package injects these per step into optax.adam, whose bias
correction then uses the step's β (1 − β_now**count). torch.optim.Adam
reads `lr` and `betas` from the parameter group at each step and forms the
same correction (1 − β**step), so setting them before `optimizer.step()`
gives the same update.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

from dcase2019_task4_tpu_torch.train.ramps import cosine_rampdown, sigmoid_rampup


def meanteacher_adam(
    params: Iterable,
    total_steps: int,
    rampup_steps: int,
    rampdown_steps: Optional[int] = None,
    max_learning_rate: float = 1e-3,
    beta1_before_rampdown: float = 0.9,
    beta1_after_rampdown: float = 0.5,
    beta2_during_rampup: float = 0.99,
    beta2_after_rampup: float = 0.999,
    eps: float = 1e-8,
) -> Tuple[torch.optim.Adam, Callable[[int], Dict[str, float]]]:
    """→ (optimizer, set_step). Call `set_step(count)` with the number of
    updates already taken (0 before the first) ahead of each
    `optimizer.step()`; it writes that step's lr and betas into every
    parameter group and returns them."""
    rampdown_steps = rampdown_steps or total_steps

    def hyperparams(step: int) -> Dict[str, float]:
        up = sigmoid_rampup(float(step), rampup_steps)
        down = cosine_rampdown(float(step), rampdown_steps)
        return {
            "learning_rate": up * down * max_learning_rate,
            "b1": down * beta1_before_rampdown + (1.0 - down) * beta1_after_rampdown,
            "b2": (1.0 - up) * beta2_during_rampup + up * beta2_after_rampup,
        }

    first = hyperparams(0)
    optimizer = torch.optim.Adam(params, lr=first["learning_rate"], betas=(first["b1"], first["b2"]), eps=eps)

    def set_step(step: int) -> Dict[str, float]:
        h = hyperparams(step)
        for group in optimizer.param_groups:
            group["lr"] = h["learning_rate"]
            group["betas"] = (h["b1"], h["b2"])
        return h

    return optimizer, set_step
