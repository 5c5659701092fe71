"""Port parity: the Experiment's run options, against the JAX package.

The tiny Mean-Teacher run of tests/test_torch_experiment.py (1 s clips,
filters (16, 16, 16), GRU 16, batch 8, `subpart_data=12`, dropout 0 and
`noise_std` 0, the JAX initial state and scaler carried across), now with
the options a user adds to it:

- ramped Adam (`--ramped_adam`): lr and betas set before each update, on a
  schedule over the config's 6 epochs (18 steps, ramp-up 9);
- the teacher on a second render of each clip (`--paired_teacher_view`);
- validation, checkpoints and SaveBest every second epoch and the last
  (`--eval_every 2`), with a record of the losses alone in between;
- early stopping with patience 0 (`--early_stopping 0`).

Both packages run `Experiment.run` for at most six epochs. Held: the same
metrics.jsonl records, epoch for epoch (which epochs were validated, and
the epoch the run stopped at, before the sixth); every loss key within
2e-4 (the bar of RESULTS.md:346-370); the validation F1s equal, unless a
probability within 1e-5 of the 0.5 threshold flipped (the test names it);
the same epochs saved as best; the restored best state's step equal.
"""

import os

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
from dcase2019_task4_tpu_torch.utils.metrics_writer import read_metrics
from tests.test_torch_experiment import LOSS_TOL, _flips_near_threshold, recording

EPOCHS = 6
OPTIONS = dict(mean_teacher=True, subpart_data=12, synthetic_audio=True, seed=0, ramped_adam=True,
               paired_teacher_view=True)
RUN = dict(n_epoch=EPOCHS, eval_every=2, early_stopping=0)
PORT_ONLY = {"steps_per_s", "queue_wait_share"}  # the loop's own numbers


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
             train=T(batch_size=8, n_epoch=EPOCHS, num_prefetch=1, noise_std=0.0))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("options")
    jexp = JExperiment(tiny(JConfig, JDSP, JModel, JTrain), **OPTIONS)
    jexp.build()
    texp = Experiment(tiny(Config, DSPConfig, ModelConfig, TrainConfig), device="cpu", **OPTIONS)
    texp.build()
    init = str(tmp / "jax_init.npz")
    jckpt.save_checkpoint(init, jexp.state, jexp.checkpoint_metadata(-1, {}))
    texp.restore(init)
    probs = {"jax": [], "port": []}
    jexp.predict_step = recording(jexp.predict_step, probs["jax"])
    texp.predict_step = recording(texp.predict_step, probs["port"])
    jexp.run(store_dir=str(tmp / "jax"), **RUN)
    texp.run(store_dir=str(tmp / "port"), **RUN)
    return {"jexp": jexp, "texp": texp, "probs": probs, "tmp": tmp,
            "jax": read_metrics(str(tmp / "jax" / "metrics.jsonl")),
            "port": read_metrics(str(tmp / "port" / "metrics.jsonl"))}


def test_the_records_are_the_jax_packages(runs):
    theirs, mine = runs["jax"], runs["port"]
    assert [r["epoch"] for r in mine] == [r["epoch"] for r in theirs]
    # the options ran: a record without validation, and a stop before the end
    assert "event_macro_f1" not in theirs[0] and "event_macro_f1" in theirs[1]
    assert len(theirs) < EPOCHS
    for t, m in zip(theirs, mine):
        assert set(m) - PORT_ONLY == set(t), t["epoch"]
    assert all(s.source2 is not None for s in runs["texp"].pipeline.streams)
    assert runs["texp"]._set_step is not None


def test_every_epoch_loss_within_the_bar(runs):
    for theirs, mine in zip(runs["jax"], runs["port"]):
        losses = [k for k in theirs if "loss" in k or k.startswith("consistency_")]
        assert len(losses) == 8  # the eight metric keys of the Mean-Teacher step
        for k in losses:
            assert abs(mine[k] - theirs[k]) <= LOSS_TOL, (theirs["epoch"], k, mine[k], theirs[k])


def test_validation_f1s_and_best_epoch_are_the_same(runs):
    validated = [(t, m) for t, m in zip(runs["jax"], runs["port"]) if "event_macro_f1" in t]
    n_calls = len(runs["probs"]["jax"])
    assert len(runs["probs"]["port"]) == n_calls and n_calls % len(validated) == 0
    per_validation = n_calls // len(validated)
    for v, (theirs, mine) in enumerate(validated):
        for k in ("event_macro_f1", "weak_macro_f1", "global_valid"):
            if mine[k] != theirs[k]:
                lo, hi = v * per_validation, (v + 1) * per_validation
                flips = _flips_near_threshold(runs["probs"]["jax"][lo:hi], runs["probs"]["port"][lo:hi])
                assert flips, f"epoch {theirs['epoch']} {k}: {mine[k]} != {theirs[k]} with no probability near 0.5"
                print(f"epoch {theirs['epoch']} {k}: {mine[k]} != {theirs[k]}; flipped at (jax, port) {flips}")
        assert mine["saved_best"] == theirs["saved_best"], theirs["epoch"]
    for a, b in zip(runs["probs"]["jax"], runs["probs"]["port"]):
        np.testing.assert_allclose(b[0], a[0], rtol=0, atol=1e-4)
        np.testing.assert_allclose(b[1], a[1], rtol=0, atol=1e-4)
    assert int(runs["texp"].state.step) == int(runs["jexp"].state.step) > 0
    assert os.path.exists(runs["tmp"] / "port" / "model" / "baseline_best")
