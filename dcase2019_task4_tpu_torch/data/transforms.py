"""Host-side sample transforms (the port's copy of
dcase2019_task4_tpu/data/transforms.py, which is framework-free).

The hot path applies these operations on the device (ops/mel.py,
train/steps.py); this module provides the same operations as composable
host-side numpy transforms for offline feature work, notebooks and parity
experiments, the counterpart of the reference's transform classes
(DataLoad.py:157-380: AugmentGaussianNoise, ApplyLog, PadOrTrunc, ToTensor,
Normalize, Compose and get_transforms, utils/utils.py:397-412). `Normalize`
takes the port's utils/scaler.py `Scaler`.

A sample is (features, label) or (features, noisy_features, label); every
transform maps sample → sample, applying to all elements but the last.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np


def _amplitude_to_db(x, amin=1e-5, top_db=80.0):
    db = 20.0 * np.log10(np.maximum(amin, x))
    return np.maximum(db, db.max() - top_db)


def pad_trunc_seq(x: np.ndarray, max_len: int) -> np.ndarray:
    """Pad with zeros / truncate along axis 0 (DataLoad.py:210-230)."""
    n = x.shape[0]
    if n < max_len:
        pad = np.zeros((max_len - n,) + x.shape[1:], dtype=x.dtype)
        return np.concatenate([x, pad], axis=0)
    return x[:max_len]


class Transform:
    def apply(self, data):
        raise NotImplementedError

    def __call__(self, sample):
        sample = list(sample)
        for i in range(len(sample) - 1):
            sample[i] = self.apply(sample[i])
        return sample


class ApplyLog(Transform):
    """amplitude_to_db on linear mel (DataLoad.py:189-207)."""

    def apply(self, data):
        return _amplitude_to_db(data)


class PadOrTrunc(Transform):
    def __init__(self, nb_frames: int):
        self.nb_frames = nb_frames

    def apply(self, data):
        return pad_trunc_seq(data, self.nb_frames)


class Normalize(Transform):
    def __init__(self, scaler):
        self.scaler = scaler

    def apply(self, data):
        return self.scaler.normalize(data)


class GaussianNoise(Transform):
    """Additive |N(0, std²)| on every element (DataLoad.py:157-186)."""

    def __init__(self, mean: float = 0.0, std: float = 0.25, rng: Optional[np.random.Generator] = None):
        self.mean = mean
        self.std = std
        self.rng = rng or np.random.default_rng()

    def apply(self, data):
        return data + np.abs(self.rng.normal(self.mean, self.std, data.shape))


class AugmentGaussianNoise:
    """(features, label) → (clean, noisy, label): the Mean-Teacher pair —
    clean to the student, noisy to the teacher (DataLoad.py:262-287,
    main.py:73 unpack order)."""

    def __init__(self, mean: float = 0.0, std: float = 0.25, rng: Optional[np.random.Generator] = None):
        self.mean = mean
        self.std = std
        self.rng = rng or np.random.default_rng()

    def __call__(self, sample):
        features, label = sample
        noisy = features + np.abs(self.rng.normal(self.mean, self.std, features.shape))
        return [features, noisy, label]


class Compose:
    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def add_transform(self, t):
        return Compose(self.transforms + [t])

    def __call__(self, sample):
        for t in self.transforms:
            sample = t(sample)
        return sample


def get_transforms(
    frames: int,
    scaler=None,
    augment_type: Optional[str] = None,
    noise_std: float = 0.25,
    rng: Optional[np.random.Generator] = None,
) -> Compose:
    """Reference-ordered composition (utils/utils.py:397-412):
    [noise] → log → pad/trunc → [normalize]."""
    transf: List[Callable] = []
    if augment_type == "noise":
        transf.append(AugmentGaussianNoise(std=noise_std, rng=rng))
    transf.extend([ApplyLog(), PadOrTrunc(frames)])
    if scaler is not None:
        transf.append(Normalize(scaler))
    return Compose(transf)
