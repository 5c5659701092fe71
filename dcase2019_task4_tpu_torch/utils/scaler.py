"""Dataset-level standardization (per-mel-bin mean/std).

Same math as the reference Scaler (utils/Scaler.py:9-130): accumulate the
per-clip mean and mean-of-square reduced over every axis except the last
(→ one vector per mel bin), average over clips with equal weight,
var = E[x²] − E[x]², normalize = (x − μ)/σ. State round-trips through the
same JSON layout {"mean_", "mean_of_square_"}.

`fit_batched` computes the same moments in one device pass over batched
[B, T, F] feature arrays — all clips share the fixed 864-frame layout, so
the equal-weight-per-clip average equals a flat mean over (clip, time).
"""

from __future__ import annotations

import json

import numpy as np


class Scaler:
    def __init__(self):
        self.mean_ = None
        self.mean_of_square_ = None
        self.std_ = None

    # ------------------------------------------------------------- fitting

    def fit_iter(self, samples) -> "Scaler":
        """Fit from an iterable of per-clip feature arrays [..., F]
        (or (features, label) tuples), reference-style incremental mean."""
        total = None
        total_sq = None
        count = 0
        for sample in samples:
            x = sample[0] if isinstance(sample, (tuple, list)) else sample
            x = np.asarray(x, dtype=np.float64)
            m = x.reshape(-1, x.shape[-1]).mean(axis=0)
            msq = (x.reshape(-1, x.shape[-1]) ** 2).mean(axis=0)
            total = m if total is None else total + m
            total_sq = msq if total_sq is None else total_sq + msq
            count += 1
        self.mean_ = total / count
        self.mean_of_square_ = total_sq / count
        self._finalize()
        return self

    def fit_batched(self, batches) -> "Scaler":
        """Fit from an iterable of [B, ..., F] batches (device or host)."""
        total = None
        total_sq = None
        count = 0
        for x in batches:
            x = np.asarray(x, dtype=np.float64)
            flat = x.reshape(x.shape[0], -1, x.shape[-1])
            total_b = flat.mean(axis=1).sum(axis=0)
            total_sq_b = (flat**2).mean(axis=1).sum(axis=0)
            total = total_b if total is None else total + total_b
            total_sq = total_sq_b if total_sq is None else total_sq + total_sq_b
            count += x.shape[0]
        self.mean_ = total / count
        self.mean_of_square_ = total_sq / count
        self._finalize()
        return self

    def _finalize(self):
        variance = self.mean_of_square_ - self.mean_**2
        self.std_ = np.sqrt(np.maximum(variance, 0.0))

    # ----------------------------------------------------------- applying

    def normalize(self, x):
        return (x - self.mean_) / self.std_

    @property
    def mean_std_f32(self):
        return (
            np.asarray(self.mean_, dtype=np.float32),
            np.asarray(self.std_, dtype=np.float32),
        )

    # -------------------------------------------------------------- state

    def state_dict(self):
        return {
            "mean_": np.asarray(self.mean_).tolist(),
            "mean_of_square_": np.asarray(self.mean_of_square_).tolist(),
        }

    def load_state_dict(self, state):
        self.mean_ = np.array(state["mean_"])
        self.mean_of_square_ = np.array(state["mean_of_square_"])
        self._finalize()
        return self

    def save(self, path):
        with open(path, "w") as f:
            json.dump(self.state_dict(), f)

    def load(self, path):
        with open(path) as f:
            return self.load_state_dict(json.load(f))
