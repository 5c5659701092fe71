"""Port parity: the Mean-Teacher Experiment end to end, two epochs.

Both packages build the tiny Mean-Teacher run of tests/test_e2e.py
(1 s clips, filters (16, 16, 16), GRU 16, batch 8 = [2 | 4 | 2],
`subpart_data=12`, synthetic audio) with dropout 0 and `noise_std` 0, so
neither package's random draws change a number. The JAX Experiment's
initial TrainState and scaler cross into the port's through a JAX
checkpoint (`Experiment.restore`), then each runs two epochs with
validation, SaveBest and checkpoints. JAX matmul precision is `highest`
(tests/conftest.py).

Held: the scaler moments of the two separate fits within 1e-5 of their
largest; every per-epoch loss key of metrics.jsonl within 2e-4 (the bar
of RESULTS.md:346-370); the validation F1s equal, unless a probability
within 1e-5 of the 0.5 threshold flipped (the test names it); the same
epoch saved as best; the restored best state's parameters within 1e-5 of
the JAX run's largest parameter. Five leaves are gauge directions whose
gradient is rounding noise that Adam scales up: the conv biases ahead of a
train-mode BatchNorm and the attention head's weight and bias. They are
named and held in function space instead: both best models' strong and
weak outputs on a validation batch agree within 1e-5, in train and in eval
mode.
"""

import copy
import os

import jax
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
from dcase2019_task4_tpu_torch.models.crnn import CRNN
from dcase2019_task4_tpu_torch.train import checkpoints as tckpt
from dcase2019_task4_tpu_torch.train.experiment import Experiment
from dcase2019_task4_tpu_torch.utils.metrics_writer import read_metrics

LOSS_TOL = 2e-4
FLIP_TOL = 1e-5
PARAM_TOL = 1e-5
GAUGE = ("['cnn'][0]['conv']['b']", "['cnn'][1]['conv']['b']", "['cnn'][2]['conv']['b']",
         "['dense_softmax']['w']", "['dense_softmax']['b']")


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


def recording(predict, log):
    """Wrap a predict step so each call's (strong, weak) lands in `log`."""

    def call(*args):
        strong, weak = predict(*args)
        log.append((np.asarray(strong.cpu() if isinstance(strong, torch.Tensor) else strong),
                    np.asarray(weak.cpu() if isinstance(weak, torch.Tensor) else weak)))
        return strong, weak

    return call


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("experiment")
    jexp = JExperiment(tiny(JConfig, JDSP, JModel, JTrain), mean_teacher=True, subpart_data=12,
                       synthetic_audio=True, seed=0)
    jexp.build()
    texp = Experiment(tiny(Config, DSPConfig, ModelConfig, TrainConfig), mean_teacher=True, subpart_data=12,
                      synthetic_audio=True, seed=0, device="cpu")
    texp.build()
    fitted = {k: (np.array(getattr(jexp.scaler, k)), np.array(getattr(texp.scaler, k)))
              for k in ("mean_", "mean_of_square_")}
    init = str(tmp / "jax_init.npz")
    jckpt.save_checkpoint(init, jexp.state, jexp.checkpoint_metadata(-1, {}))
    texp.restore(init)
    probs = {"jax": [], "port": []}
    jexp.predict_step = recording(jexp.predict_step, probs["jax"])
    texp.predict_step = recording(texp.predict_step, probs["port"])
    jexp.run(store_dir=str(tmp / "jax"), n_epoch=2)
    texp.run(store_dir=str(tmp / "port"), n_epoch=2)
    return {"jexp": jexp, "texp": texp, "fitted": fitted, "probs": probs, "tmp": tmp,
            "jax": read_metrics(str(tmp / "jax" / "metrics.jsonl")),
            "port": read_metrics(str(tmp / "port" / "metrics.jsonl"))}


def test_the_scalers_fitted_apart_agree(runs):
    for key, (theirs, mine) in runs["fitted"].items():
        assert mine.shape == theirs.shape == (64,)
        np.testing.assert_allclose(mine, theirs, rtol=0, atol=1e-5 * np.abs(theirs).max(), err_msg=key)


def test_layout_and_splits_are_the_jax_packages(runs):
    jexp, texp = runs["jexp"], runs["texp"]
    assert [s.name for s in texp.pipeline.streams] == [s.name for s in jexp.pipeline.streams]
    for mine, theirs in zip(texp.pipeline.streams, jexp.pipeline.streams):
        assert mine.filenames == theirs.filenames
        np.testing.assert_array_equal(mine.targets, theirs.targets)
    assert texp.valid_synth_stream.filenames == jexp.valid_synth_stream.filenames
    assert texp.valid_weak_stream.filenames == jexp.valid_weak_stream.filenames
    assert (texp.weak_slice, texp.strong_slice) == (jexp.weak_slice, jexp.strong_slice)
    assert len(texp.pipeline) == len(jexp.pipeline) == 3


def test_every_epoch_loss_within_the_bar(runs):
    assert len(runs["port"]) == len(runs["jax"]) == 2
    for theirs, mine in zip(runs["jax"], runs["port"]):
        assert mine["epoch"] == theirs["epoch"]
        losses = [k for k in theirs if "loss" in k or k.startswith("consistency_")]
        assert len(losses) == 8  # the eight metric keys of the Mean-Teacher step
        for k in losses:
            assert abs(mine[k] - theirs[k]) <= LOSS_TOL, (theirs["epoch"], k, mine[k], theirs[k])
        assert set(theirs) - {"ts"} <= set(mine)
        assert 0.0 <= mine["queue_wait_share"] <= 1.0 and mine["steps_per_s"] > 0


def _flips_near_threshold(jax_probs, port_probs):
    """Probabilities on opposite sides of 0.5, both within FLIP_TOL of it."""
    out = []
    for (js, jw), (ts, tw) in zip(jax_probs, port_probs):
        for a, b in ((js, ts), (jw, tw)):
            flip = ((a > 0.5) != (b > 0.5)) & (np.abs(a - 0.5) <= FLIP_TOL) & (np.abs(b - 0.5) <= FLIP_TOL)
            out += [(float(x), float(y)) for x, y in zip(a[flip], b[flip])]
    return out


def test_validation_f1s_and_best_epoch_are_the_same(runs):
    per_epoch = len(runs["probs"]["jax"]) // 2
    assert per_epoch >= 2 and len(runs["probs"]["port"]) == len(runs["probs"]["jax"])
    for e, (theirs, mine) in enumerate(zip(runs["jax"], runs["port"])):
        for k in ("event_macro_f1", "weak_macro_f1", "global_valid"):
            if mine[k] != theirs[k]:
                lo, hi = e * per_epoch, (e + 1) * per_epoch
                flips = _flips_near_threshold(runs["probs"]["jax"][lo:hi], runs["probs"]["port"][lo:hi])
                assert flips, f"epoch {e} {k}: {mine[k]} != {theirs[k]} with no probability near 0.5"
                print(f"epoch {e} {k}: {mine[k]} != {theirs[k]}; flipped at (jax, port) {flips}")
        assert mine["saved_best"] == theirs["saved_best"], e
    for a, b in zip(runs["probs"]["jax"], runs["probs"]["port"]):
        np.testing.assert_allclose(b[0], a[0], rtol=0, atol=1e-4)
        np.testing.assert_allclose(b[1], a[1], rtol=0, atol=1e-4)
    assert os.path.exists(runs["tmp"] / "port" / "model" / "baseline_best")
    assert os.path.exists(runs["tmp"] / "port" / "model" / "baseline_epoch_1")


def test_best_checkpoint_params_match(runs):
    jexp, texp = runs["jexp"], runs["texp"]
    theirs = jax.tree.map(np.asarray, jexp.state.params)
    mine = tckpt.params_to_jax(texp.state.student)[0]
    flat_t = dict((jax.tree_util.keystr(k), v) for k, v in jax.tree_util.tree_flatten_with_path(mine)[0])
    flat_j = jax.tree_util.tree_flatten_with_path(theirs)[0]
    largest = max(np.abs(v).max() for _, v in flat_j)
    assert int(texp.state.step) == int(jexp.state.step) > 0  # the best epoch's state, restored
    for k, v in flat_j:
        name = jax.tree_util.keystr(k)
        if name in GAUGE:
            continue
        np.testing.assert_allclose(flat_t[name], v, rtol=0, atol=PARAM_TOL * largest, err_msg=name)
    # the gauge leaves, in function space
    ref = CRNN(texp.cfg.model)
    ref.load_state_dict(tckpt.params_from_jax(theirs, jax.tree.map(np.asarray, jexp.state.bn_state)))
    batch, _, _ = next(texp._eval_batches(texp.valid_synth_stream))
    x = texp.eval_features(torch.as_tensor(batch["audio"]), torch.as_tensor(batch["frames"]))
    for mode in ("train", "eval"):
        a, b = copy.deepcopy(texp.state.student), copy.deepcopy(ref)
        getattr(a, mode)()
        getattr(b, mode)()
        with torch.no_grad():
            out_a = a(x, torch.Generator().manual_seed(0))
            out_b = b(x, torch.Generator().manual_seed(0))
        for got, want in zip(out_a, out_b):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=PARAM_TOL, err_msg=mode)
