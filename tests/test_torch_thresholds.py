"""Port parity: threshold tuning (eval/thresholds.py) and
`evaluate --tune_thresholds --save_thresholds`.

The tuners against the JAX package's on the cases of
tests/test_decode.py (a separable weak set; the engineered three-class
event set, with window lists in and out of order, so the `best_win` start
is exercised; random grids through the per-class decode): the same
thresholds and windows, F1s within 1e-12, the same event rows. Then a tiny
`test_model(tune_thresholds=True)` as tests/test_e2e.py runs it, on one
JAX-written checkpoint (1 s clips, filters (16, 16, 16), GRU 16, batch 8,
6 validation clips of synthetic audio) through both evaluators, and the
port's CLI writing the three JSON files. Its precondition: every
probability of the port lies more than 1e-5 from every grid threshold and
within 1e-6 of the JAX package's, so no decision flips on float noise.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch

from dcase2019_task4_tpu.config import DEFAULT_CLASSES
from dcase2019_task4_tpu.config import Config as JConfig
from dcase2019_task4_tpu.config import DSPConfig as JDSP
from dcase2019_task4_tpu.config import ModelConfig as JModel
from dcase2019_task4_tpu.config import TrainConfig as JTrain
from dcase2019_task4_tpu.data.encoder import LabelCodec as JCodec
from dcase2019_task4_tpu.eval import thresholds as jth
from dcase2019_task4_tpu.eval.decode import grids_to_dataframe
from dcase2019_task4_tpu.eval.evaluate import CheckpointEvaluator as JEvaluator
from dcase2019_task4_tpu.models.crnn import CRNN as JCRNN
from dcase2019_task4_tpu.train import checkpoints as jckpt
from dcase2019_task4_tpu.train.steps import init_train_state
from dcase2019_task4_tpu_torch import cli
from dcase2019_task4_tpu_torch.data.encoder import LabelCodec
from dcase2019_task4_tpu_torch.eval import thresholds as tth
from dcase2019_task4_tpu_torch.eval.evaluate import CheckpointEvaluator
from dcase2019_task4_tpu_torch.models.crnn import CRNN, seeded_init_
from dcase2019_task4_tpu_torch.train.checkpoints import params_to_jax

CLASSES = ["Cat", "Dog", "Speech"]
F1_TOL = 1e-12


def rows_of(df: pd.DataFrame):
    return [tuple(r) for r in df[["event_label", "onset", "offset", "filename"]].itertuples(index=False)]


def test_tune_weak_thresholds_matches_jax():
    rng = np.random.default_rng(0)
    n = 400
    y = (rng.random((n, 2)) > 0.5).astype(np.int32)
    probs = np.zeros((n, 2), np.float32)
    probs[:, 0] = np.where(y[:, 0] == 1, 0.35, 0.25) + rng.normal(0, 0.01, n)
    probs[:, 1] = np.where(y[:, 1] == 1, 0.75, 0.65) + rng.normal(0, 0.01, n)
    strong_y = np.repeat(y[:, None, :], 5, axis=1)
    for targets in (y, strong_y):
        th, f1 = tth.tune_weak_thresholds(probs, targets)
        want_th, want_f1 = jth.tune_weak_thresholds(probs, targets)
        np.testing.assert_array_equal(th, want_th)
        np.testing.assert_allclose(f1, want_f1, rtol=0, atol=F1_TOL)
    assert 0.25 < th[0] < 0.35 and 0.65 < th[1] < 0.75 and (f1 > 0.95).all()
    grid = np.linspace(0.2, 0.8, 7)
    np.testing.assert_array_equal(tth.tune_weak_thresholds(probs, y, grid)[0],
                                  jth.tune_weak_thresholds(probs, y, grid)[0])


@pytest.mark.parametrize("thresholds, windows", [
    (0.5, 5),
    (np.asarray([0.3, 0.5, 0.6]), np.asarray([3, 5, 7])),
    (np.asarray([0.45, 0.55, 0.15]), np.asarray([5, 1, 5])),
], ids=["scalar", "per_class", "shared_window_groups"])
def test_decode_events_per_class_matches_jax(thresholds, windows):
    rng = np.random.default_rng(3)
    probs = rng.random((4, 54, 3)).astype(np.float32)
    names = [f"f{i}.wav" for i in range(4)]
    got = tth.decode_events_per_class(probs, names, LabelCodec(CLASSES, n_frames=54), 44100, 511, 8,
                                      thresholds, windows)
    want = jth.decode_events_per_class(probs, names, JCodec(CLASSES, n_frames=54), 44100, 511, 8,
                                       thresholds, windows)
    assert len(got) > 10 and got == rows_of(want)


def _tuner_fixture():
    """tests/test_decode.py's three classes: Cat already perfect at 0.5,
    Dog found only below 0.5, Speech healed only by a window of 5 or
    more; the truth decoded from clean grids."""
    T = 54
    probs = np.zeros((3, T, 3), np.float32)
    truth = np.zeros((3, T, 3), np.float32)
    for b in range(3):
        truth[b, 10:21, 0] = 1
        probs[b, :, 0] = 0.3
        probs[b, 10:21, 0] = 0.7
        truth[b, 30:41, 1] = 1
        probs[b, :, 1] = 0.05
        probs[b, 30:41, 1] = 0.45
        truth[b, 10:31, 2] = 1
        probs[b, 10:31, 2] = 0.8
        probs[b, 19:21, 2] = 0.0
    names = [f"f{i}.wav" for i in range(3)]
    gt = grids_to_dataframe(truth, names, JCodec(CLASSES, n_frames=T), 44100, 511, 8)
    return probs, names, gt


@pytest.mark.parametrize("windows", [None, (3, 5), (3, 5, 7), (7, 5, 3)], ids=["default", "3_5", "3_5_7", "7_5_3"])
def test_tune_event_thresholds_matches_jax(windows):
    probs, names, gt = _tuner_fixture()
    want = jth.tune_event_thresholds(probs, names, gt, JCodec(CLASSES, n_frames=54), median_windows=windows)
    got = tth.tune_event_thresholds(probs, names, rows_of(gt), LabelCodec(CLASSES, n_frames=54),
                                    median_windows=windows)
    for k in ("thresholds", "windows"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("f1", "default_f1"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=F1_TOL, err_msg=k)
    for k in ("macro_f1", "default_macro_f1"):
        assert abs(got[k] - want[k]) <= F1_TOL, k
    if windows is not None and len(windows) == 3:
        assert got["windows"][2] >= 5 and got["thresholds"][1] < 0.45 and got["macro_f1"] > got["default_macro_f1"]


def test_an_unfound_class_keeps_the_first_window_given():
    """The JAX package's `best_win` start is `median_windows[0]` as given
    (a known reference defect, kept): a class no grid point finds reports
    it."""
    probs, names, gt = _tuner_fixture()
    probs[..., 1] = 0.0
    for windows in ((7, 5, 3), (5, 3)):
        got = tth.tune_event_thresholds(probs, names, rows_of(gt), LabelCodec(CLASSES, n_frames=54),
                                        median_windows=windows)
        assert got["f1"][1] == 0.0 and got["windows"][1] == windows[0] and got["thresholds"][1] == 0.5


TINY = JConfig(dsp=JDSP(max_len_seconds=1.0), model=JModel(nclass=10, nb_filters=(16, 16, 16), n_rnn_cell=16),
               train=JTrain(batch_size=8))
SEED = 0
SUBPART = 6
GRIDS = np.concatenate([np.linspace(0.05, 0.95, 19), np.linspace(0.1, 0.9, 17), [0.5]])


@pytest.fixture(scope="module")
def tuned(tmp_path_factory):
    """One seeded checkpoint written by the JAX package, tuned on six
    validation clips by both evaluators and by the port's CLI."""
    tmp = tmp_path_factory.mktemp("tune")
    d = TINY.dsp
    state = init_train_state(JCRNN(TINY.model), optax.adam(1e-3), jax.random.PRNGKey(SEED))
    params, bn_state = params_to_jax(seeded_init_(CRNN(TINY.model), SEED))
    params["dense"]["w"] = params["dense"]["w"] * 8  # strong probabilities spread over (0, 1)
    state = state._replace(params=jax.tree.map(jnp.asarray, params), bn_state=jax.tree.map(jnp.asarray, bn_state))
    meta = {"epoch": 1, "valid_metric": {}, "pooling_time_ratio": 8,
            "scaler": {"mean_": [-40.0] * d.n_mels, "mean_of_square_": [1825.0] * d.n_mels},
            "many_hot_encoder": JCodec(DEFAULT_CLASSES, d.max_frames // 8).state_dict(),
            "config": jckpt.config_to_dict(TINY), "mean_teacher": True}
    path = str(tmp / "model.npz")
    jckpt.save_checkpoint(path, state, meta)
    validation = TINY.paths.validation
    seen = {"port": [], "jax": []}

    def recording(predict, log):
        def call(*args):
            strong, weak = predict(*args)
            log.append(np.concatenate([np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t).reshape(len(t), -1)
                                       for t in (strong, weak)], axis=1))
            return strong, weak

        return call

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ev = CheckpointEvaluator(path, device="cpu", synthetic_audio=True)
        ev._predict = recording(ev._predict, seen["port"])
        mine = ev.test_model(validation, SUBPART, tune_thresholds=True)
        jev = JEvaluator(path, synthetic_audio=True)
        jev.predict = recording(jev.predict, seen["jax"])
        theirs = jev.test_model(validation, SUBPART, tune_thresholds=True)
        saved = str(tmp / "tuned.json")
        res = cli.evaluate(["-m", path, "--synthetic_audio", "-s", str(SUBPART), "--sets", validation,
                            "--tune_thresholds", "--save_thresholds", saved, "--device", "cpu"])
    finally:
        torch.set_num_threads(n)
    return {"mine": mine, "theirs": theirs, "cli": res[validation], "saved": saved, "path": path,
            "probs": {k: np.concatenate(v)[:SUBPART] for k, v in seen.items()}}


def test_the_probabilities_keep_clear_of_every_grid_threshold(tuned):
    """The precondition: no strong or weak probability of either package
    lies within 1e-5 of a grid threshold, and the two agree within 1e-6."""
    mine, theirs = tuned["probs"]["port"], tuned["probs"]["jax"]
    assert mine.shape == theirs.shape == (SUBPART, 10 * 10 + 10)
    assert np.abs(mine - theirs).max() <= 1e-6
    margin = np.abs(mine.reshape(-1)[:, None] - GRIDS[None]).min()
    assert margin > 1e-5, margin


def test_test_model_tunes_as_the_jax_package_does(tuned):
    mine, theirs = tuned["mine"], tuned["theirs"]
    for k in ("tuned_thresholds", "tuned_event_thresholds", "tuned_event_windows"):
        assert len(mine[k]) == 10 and mine[k] == theirs[k], k
    for k in ("tuned_weak_macro_f1", "tuned_event_macro_f1", "event_macro_f1", "weak_macro_f1"):
        assert abs(mine[k] - theirs[k]) <= F1_TOL, k
    assert mine["tuned_weak_macro_f1"] >= mine["weak_macro_f1"] - 1e-9


def test_evaluate_cli_saves_the_three_json_files(tuned):
    mine, res, saved = tuned["mine"], tuned["cli"], tuned["saved"]
    for k in ("tuned_thresholds", "tuned_event_thresholds", "tuned_event_windows", "tuned_event_macro_f1"):
        assert res[k] == mine[k], k
    root, ext = os.path.splitext(saved)
    for path, key in ((saved, "tuned_thresholds"), (f"{root}.event{ext}", "tuned_event_thresholds"),
                      (f"{root}.event_windows{ext}", "tuned_event_windows")):
        with open(path) as f:
            got = json.load(f)
        assert list(got) == list(DEFAULT_CLASSES) and list(got.values()) == mine[key], path
    ev = CheckpointEvaluator(tuned["path"], device="cpu", synthetic_audio=True)
    np.testing.assert_array_equal(ev.load_thresholds(f"{root}.event{ext}"), mine["tuned_event_thresholds"])
    np.testing.assert_array_equal(ev.load_windows(f"{root}.event_windows{ext}"), mine["tuned_event_windows"])
