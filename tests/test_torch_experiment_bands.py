"""Port parity: the Experiment's unlabeled cap and nuisance bands
(`subpart_unlabeled`, `synthetic_bands`), against the JAX Experiment.

Both packages build the tiny Mean-Teacher run of tests/test_torch_experiment.py
(1 s clips, filters (16, 16, 16), GRU 16, batch 8, dropout 0, noise 0) with
`subpart_data=12, subpart_unlabeled=20, synthetic_variability=1.0,
synthetic_bands={"weak": (0.4, 0.6), "synthetic": (0.4, 0.6)},
paired_teacher_view=True`: the arguments tools/ablate_ssl_torch.py gives
its mt_nv arm under --nuisance_shift 0.4,0.6, cut small.

Held:
- every stream's file list (training and validation) equal to JAX's, the
  unlabeled stream holding 20 clips where the labeled streams are capped
  at 12;
- both views' rendered audio bit for bit JAX's on each stream's first
  clips, the banded streams unlike the same clips rendered without bands
  (the unlabeled and validation streams alike);
- the scaler cache key equal to JAX's with bands and without; without
  bands the port's key is the one it had before bands existed (the same
  hash, recomputed here from its definition);
- one epoch from the JAX initial state and scaler (carried through a JAX
  checkpoint): every loss key within 2e-4 (the bar of RESULTS.md:346-370).
"""

import hashlib

import numpy as np
import pytest
import torch

from dcase2019_task4_tpu.config import Config as JConfig
from dcase2019_task4_tpu.config import DSPConfig as JDSP
from dcase2019_task4_tpu.config import ModelConfig as JModel
from dcase2019_task4_tpu.config import TrainConfig as JTrain
from dcase2019_task4_tpu.train import checkpoints as jckpt
from dcase2019_task4_tpu.train.experiment import Experiment as JExperiment
from dcase2019_task4_tpu_torch.config import Config, DSPConfig, ModelConfig, TrainConfig
from dcase2019_task4_tpu_torch.train.experiment import Experiment
from tests.test_torch_experiment import LOSS_TOL

BANDS = {"weak": (0.4, 0.6), "synthetic": (0.4, 0.6)}
OPTIONS = dict(mean_teacher=True, subpart_data=12, subpart_unlabeled=20, synthetic_audio=True,
               synthetic_variability=1.0, seed=0, paired_teacher_view=True)
FIRST = 2  # clips of each stream compared sample for sample


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for torch: the suite runs several workers on the
    machine's cores, and tiny CPU steps only lose to thread contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny(C, D, M, T):
    return C(dsp=D(max_len_seconds=1.0), model=M(nclass=10, nb_filters=(16, 16, 16), n_rnn_cell=16, dropout=0.0),
             train=T(batch_size=8, n_epoch=1, num_prefetch=1, noise_std=0.0))


def streams(exp):
    return list(exp.pipeline.streams) + [exp.valid_synth_stream, exp.valid_weak_stream]


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bands")
    jexp = JExperiment(tiny(JConfig, JDSP, JModel, JTrain), synthetic_bands=BANDS, **OPTIONS).build()
    texp = Experiment(tiny(Config, DSPConfig, ModelConfig, TrainConfig), synthetic_bands=BANDS, device="cpu",
                      **OPTIONS).build()
    plain = Experiment(tiny(Config, DSPConfig, ModelConfig, TrainConfig), device="cpu", **OPTIONS).build()
    jplain = JExperiment(tiny(JConfig, JDSP, JModel, JTrain), **OPTIONS)
    jplain.pipeline = jexp.pipeline  # the key reads the streams' file lists, which bands do not change
    init = str(tmp / "jax_init.npz")
    jckpt.save_checkpoint(init, jexp.state, jexp.checkpoint_metadata(-1, {}))
    texp.restore(init)
    return {"jexp": jexp, "texp": texp, "plain": plain, "jplain": jplain}


def test_the_file_lists_are_the_jax_packages(built):
    jexp, texp = built["jexp"], built["texp"]
    assert [s.name for s in streams(texp)] == [s.name for s in streams(jexp)]
    for mine, theirs in zip(streams(texp), streams(jexp)):
        assert mine.filenames == theirs.filenames, mine.name
    sizes = {s.name: len(s.filenames) for s in texp.pipeline.streams}
    assert sizes["unlabeled"] == 20 and texp.subpart_unlabeled == 20
    assert len(built["plain"].pipeline.streams[1].filenames) == 20


def test_both_views_render_the_jax_audio_bit_for_bit(built):
    jexp, texp, plain = built["jexp"], built["texp"], built["plain"]
    for mine, theirs, unbanded in zip(streams(texp), streams(jexp), streams(plain)):
        for i in range(FIRST):
            for view in ("get_audio", "get_audio2"):
                if view == "get_audio2" and mine.source2 is None:
                    assert theirs.source2 is None, mine.name
                    continue
                got, want = getattr(mine, view)(i), getattr(theirs, view)(i)
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want, err_msg=f"{mine.name} {view} {i}")
                other = getattr(unbanded, view)(i)
                if mine.name in BANDS:
                    assert not np.array_equal(got, other), f"{mine.name}: the band changed nothing"
                else:
                    np.testing.assert_array_equal(got, other, err_msg=f"{mine.name}: a band reached it")


def _key_before_bands(exp) -> str:
    """The port's `_scaler_cache_key` as it was before bands existed."""
    h = hashlib.sha1()
    h.update(repr(exp.cfg.dsp).encode())
    h.update(repr(bool(exp.synthetic_audio)).encode())
    h.update(repr(float(exp.synthetic_variability)).encode())
    for s in exp.pipeline.streams:
        h.update(s.name.encode())
        for fn in s.filenames:
            h.update(fn.encode())
    return h.hexdigest()[:16]


def test_the_scaler_cache_keys_are_the_jax_packages(built):
    jexp, texp, plain = built["jexp"], built["texp"], built["plain"]
    assert texp._scaler_cache_key() == jexp._scaler_cache_key()
    assert plain._scaler_cache_key() == built["jplain"]._scaler_cache_key() == _key_before_bands(plain)
    assert texp._scaler_cache_key() != plain._scaler_cache_key()


def test_one_epoch_is_within_the_bar(built):
    jexp, texp = built["jexp"], built["texp"]
    theirs = {k: m.avg for k, m in jexp.train_epoch(0).meters.items()}
    mine = {k: m.avg for k, m in texp.train_epoch(0).meters.items()}
    assert set(mine) == set(theirs) and len(theirs) == 8
    for k in theirs:
        assert abs(mine[k] - theirs[k]) <= LOSS_TOL, (k, mine[k], theirs[k])
