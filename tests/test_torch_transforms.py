"""The port's host-side transforms (dcase2019_task4_tpu_torch/data/transforms.py)
against the JAX package's (dcase2019_task4_tpu/data/transforms.py): each
transform and `get_transforms` bit for bit on seeded numpy inputs, the
noise drawn from equal `default_rng`s, `Normalize` over each package's
own Scaler with the same state."""

import numpy as np
import pytest

from dcase2019_task4_tpu.data import transforms as jt
from dcase2019_task4_tpu.utils.scaler import Scaler as JaxScaler
from dcase2019_task4_tpu_torch.data import transforms as tt
from dcase2019_task4_tpu_torch.utils.scaler import Scaler

FRAMES, MELS = 40, 16
SCALER_STATE = {"mean_": np.linspace(-50.0, -20.0, MELS).tolist(),
                "mean_of_square_": (np.linspace(-50.0, -20.0, MELS) ** 2 + 16.0).tolist()}


def _mel(n_frames: int, seed: int = 0) -> np.ndarray:
    return np.abs(np.random.default_rng(seed).standard_normal((n_frames, MELS))).astype(np.float32) * 3.0


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)


@pytest.mark.parametrize("n_frames", [FRAMES - 7, FRAMES, FRAMES + 5])
def test_each_transform(n_frames):
    label = np.arange(10.0)
    sample = (_mel(n_frames), label)
    for make in (lambda m: m.ApplyLog(), lambda m: m.PadOrTrunc(FRAMES)):
        _equal(make(tt)(sample), make(jt)(sample))
    _equal(tt.Normalize(Scaler().load_state_dict(SCALER_STATE))(sample),
           jt.Normalize(JaxScaler().load_state_dict(SCALER_STATE))(sample))
    _equal(tt.GaussianNoise(std=0.3, rng=np.random.default_rng(5))(sample),
           jt.GaussianNoise(std=0.3, rng=np.random.default_rng(5))(sample))
    _equal(tt.AugmentGaussianNoise(mean=0.1, std=0.25, rng=np.random.default_rng(6))(sample),
           jt.AugmentGaussianNoise(mean=0.1, std=0.25, rng=np.random.default_rng(6))(sample))
    assert np.array_equal(tt.pad_trunc_seq(sample[0], FRAMES), jt.pad_trunc_seq(sample[0], FRAMES))


@pytest.mark.parametrize("augment", [None, "noise"])
@pytest.mark.parametrize("with_scaler", [False, True])
def test_get_transforms(augment, with_scaler):
    sample = (_mel(FRAMES + 3, seed=1), np.ones(10))
    got = tt.get_transforms(FRAMES, Scaler().load_state_dict(SCALER_STATE) if with_scaler else None, augment,
                            rng=np.random.default_rng(7))
    want = jt.get_transforms(FRAMES, JaxScaler().load_state_dict(SCALER_STATE) if with_scaler else None, augment,
                             rng=np.random.default_rng(7))
    assert [type(t).__name__ for t in got.transforms] == [type(t).__name__ for t in want.transforms]
    _equal(got(sample), want(sample))
    extended = got.add_transform(tt.PadOrTrunc(FRAMES // 2))
    assert len(extended.transforms) == len(got.transforms) + 1
