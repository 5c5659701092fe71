"""The Experiment's other compositions against the JAX package's, built
but not trained: the supervised recipe ([weak ½ | synthetic ½]), the
supervised recipe without weak labels ([synthetic]) and Mean-Teacher
without synthetic labels ([weak ¼ | unlabeled ¾]). Each holds the stream
layout, the per-stream files and targets (bit-equal), the loss slices, the
step's metric keys, the epoch length and the ramp length to the JAX
package's; and a batch larger than a stream fails loudly in both. Tiny
configuration of tests/test_e2e.py (1 s clips, batch 8), 12 files a set.
"""

import json

import pytest
import torch

from dcase2019_task4_tpu.config import Config as JConfig
from dcase2019_task4_tpu.config import DSPConfig as JDSP
from dcase2019_task4_tpu.config import ModelConfig as JModel
from dcase2019_task4_tpu.config import TrainConfig as JTrain
from dcase2019_task4_tpu.train.experiment import Experiment as JExperiment
from dcase2019_task4_tpu_torch.config import Config, DSPConfig, ModelConfig, TrainConfig
from dcase2019_task4_tpu_torch.train.experiment import Experiment


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for torch: the suite runs several workers on the
    machine's cores, and tiny CPU steps only lose to thread contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny(C, D, M, T, batch=8):
    return C(dsp=D(max_len_seconds=1.0), model=M(nclass=10, nb_filters=(16, 16, 16), n_rnn_cell=16),
             train=T(batch_size=batch, n_epoch=1, num_prefetch=1))


COMPOSITIONS = {
    "supervised": (dict(mean_teacher=False), ["weak", "synthetic"], [4, 4]),
    "supervised_no_weak": (dict(mean_teacher=False, no_weak=True), ["synthetic"], [8]),
    "no_synthetic": (dict(mean_teacher=True, no_synthetic=True), ["weak", "unlabeled"], [2, 6]),
}


@pytest.mark.parametrize("name", sorted(COMPOSITIONS))
def test_composition_matches_jax(name):
    kw, streams, sizes = COMPOSITIONS[name]
    theirs = JExperiment(tiny(JConfig, JDSP, JModel, JTrain), subpart_data=12, synthetic_audio=True, seed=0,
                         **kw).build()
    mine = Experiment(tiny(Config, DSPConfig, ModelConfig, TrainConfig), subpart_data=12, synthetic_audio=True,
                      seed=0, device="cpu", **kw).build()
    assert [s.name for s in mine.pipeline.streams] == [s.name for s in theirs.pipeline.streams] == streams
    assert mine.pipeline.sampler.batch_sizes == theirs.pipeline.sampler.batch_sizes == sizes
    for a, b in zip(mine.pipeline.streams, theirs.pipeline.streams):
        assert a.filenames == b.filenames
        assert (a.targets == b.targets).all()
    assert (mine.weak_slice, mine.strong_slice) == (theirs.weak_slice, theirs.strong_slice)
    assert mine.train_step.metric_keys == theirs.train_step.metric_keys
    assert len(mine.pipeline) == len(theirs.pipeline) > 0
    assert (mine.state.teacher is None) == (not kw["mean_teacher"])
    for a, b in zip(mine.pipeline.sampler.epoch_batches(1), theirs.pipeline.sampler.epoch_batches(1)):
        assert (a == b).all()


def test_zero_steps_fail_loudly_in_both():
    with pytest.raises(ValueError, match="0 steps/epoch"):
        JExperiment(tiny(JConfig, JDSP, JModel, JTrain, batch=64), subpart_data=4, synthetic_audio=True).build()
    with pytest.raises(ValueError, match="0 steps/epoch"):
        Experiment(tiny(Config, DSPConfig, ModelConfig, TrainConfig, batch=64), subpart_data=4,
                   synthetic_audio=True, device="cpu").build()


def test_the_scaler_cache_is_keyed_as_the_jax_packages(tmp_path, monkeypatch):
    """DCASE_SCALER_CACHE: the first build writes the moments under the
    JAX package's key for the same run, the second loads them."""
    monkeypatch.setenv("DCASE_SCALER_CACHE", str(tmp_path))
    kw = dict(subpart_data=12, synthetic_audio=True, mean_teacher=False, no_weak=True)
    mine = Experiment(tiny(Config, DSPConfig, ModelConfig, TrainConfig), device="cpu", **kw).build()
    theirs = JExperiment(tiny(JConfig, JDSP, JModel, JTrain), **kw)
    theirs.pipeline = mine.pipeline  # the key reads the streams' names and files only
    key = mine._scaler_cache_key()
    assert key == JExperiment._scaler_cache_key(theirs)
    assert sorted(p.name for p in tmp_path.iterdir()) == [f"scaler_{key}.json"]
    cached = tmp_path / f"scaler_{key}.json"
    doc = json.loads(cached.read_text())
    cached.write_text(json.dumps({k: [v + 1.0 for v in vals] for k, vals in doc.items()}))
    again = Experiment(tiny(Config, DSPConfig, ModelConfig, TrainConfig), device="cpu", **kw).build()
    assert again.scaler.mean_.tolist() == [v + 1.0 for v in doc["mean_"]]  # read, not fitted again
