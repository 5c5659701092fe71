"""Training-loop callbacks and running meters (counterpart of
dcase2019_task4_tpu/utils/meters.py, numpy only).

Same semantics as the reference's utilities (utils/utils.py:242-394):
  * AverageMeter / AverageMeterSet — running means, sci-notation under 0.01
  * SaveBest — sup/inf comparison; epoch 0 always saves (utils.py:276-277)
  * EarlyStopping — patience on a monitored metric
"""

from __future__ import annotations

import numpy as np


class AverageMeter:
    """Stores current value, sum, count, average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / self.count

    def __format__(self, format_spec):
        return "{self.avg:{f}}".format(self=self, f=format_spec)


class AverageMeterSet:
    def __init__(self):
        self.meters = {}

    def __getitem__(self, key):
        return self.meters[key]

    def update(self, name, value, n: int = 1):
        self.meters.setdefault(name, AverageMeter()).update(value, n)

    def reset(self):
        for m in self.meters.values():
            m.reset()

    def averages(self, postfix: str = "/avg"):
        return {name + postfix: m.avg for name, m in self.meters.items()}

    def __str__(self):
        parts = []
        for name, m in self.meters.items():
            fmt = ".4f" if m.val >= 0.01 else ".2E"
            parts.append("{} {:{fmt}} \t".format(name, m.val, fmt=fmt))
        return "".join(parts)


class SaveBest:
    """Track the best value of a metric ("sup" = higher is better)."""

    def __init__(self, val_comp: str = "inf"):
        if val_comp not in ("inf", "sup"):
            raise ValueError("val_comp must be 'inf' or 'sup'")
        self.comp = val_comp
        self.best_val = np.inf if val_comp == "inf" else 0.0
        self.best_epoch = 0
        self.current_epoch = 0

    def apply(self, value) -> bool:
        decision = self.current_epoch == 0
        improved = (self.comp == "inf" and value < self.best_val) or (
            self.comp == "sup" and value > self.best_val
        )
        if improved:
            self.best_epoch = self.current_epoch
            self.best_val = value
            decision = True
        self.current_epoch += 1
        return decision


class EarlyStopping:
    """Stop after `patience` epochs without improvement."""

    def __init__(self, patience: int, val_comp: str = "inf"):
        if val_comp not in ("inf", "sup"):
            raise ValueError("val_comp must be 'inf' or 'sup'")
        self.patience = patience
        self.comp = val_comp
        self.best_val = np.inf if val_comp == "inf" else 0.0
        self.best_epoch = 0
        self.current_epoch = 0

    def apply(self, value) -> bool:
        improved = (self.comp == "inf" and value < self.best_val) or (
            self.comp == "sup" and value > self.best_val
        )
        if improved:
            self.best_val = value
            self.best_epoch = self.current_epoch
        elif self.current_epoch - self.best_epoch > self.patience:
            return True
        self.current_epoch += 1
        return False
