"""Port parity: long-clip predict (`predict --long [--overlap]`) and
`merge_window_events`.

`merge_window_events` against the JAX package's on the cases of
tests/test_e2e.py: the same rows in the same order. Then one JAX-written
checkpoint at the tiny geometry of tests/test_e2e.py (1 s windows, filters
(16, 16, 16), GRU 16, batch 8) through both evaluators' `predict_long` on
synthetic wavs of 2.5 s, 0.7 s and 1.0 s, in both modes, with the default
threshold, an always-on threshold and per-class median windows: the same
window count, the same event rows (labels, files, order), onsets and
offsets within 1e-6 s, the windows' strong probabilities within 1e-6 of
JAX's and none within 1e-5 of the 0.5 threshold (so no row flips on float
noise). Then `cli.predict --long` on the CPU.
"""

import csv

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
from dcase2019_task4_tpu.eval.decode import merge_window_events as jmerge
from dcase2019_task4_tpu.eval.evaluate import CheckpointEvaluator as JEvaluator
from dcase2019_task4_tpu.models.crnn import CRNN as JCRNN
from dcase2019_task4_tpu.train import checkpoints as jckpt
from dcase2019_task4_tpu.train.steps import init_train_state
from dcase2019_task4_tpu_torch import cli
from dcase2019_task4_tpu_torch.data.audio_io import synth_clip, write_wav
from dcase2019_task4_tpu_torch.eval.decode import merge_window_events
from dcase2019_task4_tpu_torch.eval.evaluate import CheckpointEvaluator
from dcase2019_task4_tpu_torch.models.crnn import CRNN, seeded_init_
from dcase2019_task4_tpu_torch.train.checkpoints import params_to_jax

COLUMNS = ["event_label", "onset", "offset", "filename"]
MERGE_ROWS = [
    ("Dog", 8.0, 10.01, "a.wav"),  # abutting fragments across a window boundary: merged
    ("Dog", 10.0, 12.0, "a.wav"),
    ("Dog", 14.0, 15.0, "a.wav"),  # gap 0.15 <= merge_gap 0.2: merged
    ("Dog", 15.15, 16.0, "a.wav"),
    ("Dog", 20.0, 21.0, "a.wav"),  # gap 0.5: kept apart
    ("Cat", 9.9, 10.0, "a.wav"),  # another class or file never merges
    ("Dog", 9.9, 10.05, "b.wav"),
]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for torch: the suite runs several workers on the
    machine's cores, and one thread count gives one set of bits."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rows_of(df: pd.DataFrame):
    return [tuple(r) for r in df[COLUMNS].itertuples(index=False)]


@pytest.mark.parametrize("order", ["as_written", "reversed", "interleaved"])
@pytest.mark.parametrize("gap", [0.2, 0.0, 1.0])
def test_merge_window_events_matches_jax(order, gap):
    rows = {"as_written": MERGE_ROWS, "reversed": MERGE_ROWS[::-1],
            "interleaved": MERGE_ROWS[::2] + MERGE_ROWS[1::2]}[order]
    want = rows_of(jmerge(pd.DataFrame(rows, columns=COLUMNS), merge_gap=gap))
    assert merge_window_events(rows, gap) == want
    if gap == 0.2:
        assert [(on, off) for label, on, off, f in want if f == "a.wav" and label == "Dog"] == [
            (8.0, 12.0), (14.0, 16.0), (20.0, 21.0)]
    assert merge_window_events([], gap) == [] and jmerge(pd.DataFrame(columns=COLUMNS)).empty


TINY = JConfig(dsp=JDSP(max_len_seconds=1.0), model=JModel(nclass=10, nb_filters=(16, 16, 16), n_rnn_cell=16),
               train=JTrain(batch_size=8))
SEED = 0
DURATIONS = {"long.wav": 2.5, "short.wav": 0.7, "one.wav": 1.0}
CASES = {
    "plain": dict(overlap=False),
    "plain_always_on": dict(overlap=False, threshold=-1.0),
    "plain_gap_0": dict(overlap=False, merge_gap=0.0),
    "overlap": dict(overlap=True),
    "overlap_always_on": dict(overlap=True, threshold=-1.0),
    "overlap_per_class_windows": dict(overlap=True, median_window=np.asarray([1, 3, 5, 7, 3, 5, 1, 3, 5, 7])),
}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("long")
    d = TINY.dsp
    wav_dir = tmp / "wavs"
    wav_dir.mkdir()
    lengths = {}
    for i, (name, dur) in enumerate(DURATIONS.items()):
        events = [(i, 0.1, min(dur, 0.9)), (i + 3, 0.4 * dur, 0.9 * dur)]
        audio = synth_clip(name, events, dur, d.sample_rate)
        write_wav(str(wav_dir / name), audio, d.sample_rate)
        lengths[name] = len(audio) / d.sample_rate
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
    jev = JEvaluator(path)
    jax_strong = []
    predict = jev.predict

    def recording(*args):
        strong, weak = predict(*args)
        jax_strong.append(np.asarray(strong))
        return strong, weak

    jev.predict = recording
    out = {"tmp": tmp, "wavs": str(wav_dir), "path": path, "lengths": lengths}
    ev = CheckpointEvaluator(path, device="cpu")
    for case, kw in CASES.items():
        jax_strong.clear()
        theirs = jev.predict_long(str(wav_dir), str(tmp / f"{case}_jax.tsv"), **kw)
        mine = ev.predict_long(str(wav_dir), str(tmp / f"{case}_port.tsv"), **kw)
        out[case] = (theirs, mine, np.concatenate(jax_strong)[: theirs["n_windows"]])
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_predict_long_matches_jax(setup, case):
    theirs, mine, jax_strong = setup[case]
    overlap = CASES[case]["overlap"]
    # 1 s windows: 3 + 1 + 1 cut end to end; at a half-window hop of 5
    # pooled frames (20440 samples) the 2.5 s file takes 5
    assert mine["n_files"] == theirs["n_files"] == 3
    assert mine["n_windows"] == theirs["n_windows"] == (7 if overlap else 5)
    assert mine["strong"].shape == jax_strong.shape == (mine["n_windows"], 10, 10)
    assert np.abs(mine["strong"] - jax_strong).max() <= 1e-6
    assert np.abs(mine["strong"] - 0.5).min() > 1e-5
    want = rows_of(theirs["predictions"])
    got = mine["events"]
    assert len(got) == len(want) > 0
    assert [(r[0], r[3]) for r in got] == [(r[0], r[3]) for r in want]
    np.testing.assert_allclose([r[1:3] for r in got], [r[1:3] for r in want], rtol=0, atol=1e-6)
    for label, on, off, fname in got:
        assert 0.0 <= on < off <= DURATIONS[fname] + 1e-9
    if CASES[case].get("threshold") == -1.0:
        # every class on everywhere: one event a class and file from 0 to the
        # file's end (clamped), or to the last window's 10 pooled frames
        # (0.927 s) where those end first, as in the 1 s file
        assert len(got) == 10 * len(DURATIONS)
        covered = dict(setup["lengths"], **{"one.wav": 10 * 8 * 511 / 44100})
        for _, on, off, f in got:
            assert on == 0.0 and off == pytest.approx(covered[f], abs=1e-6), (f, off)
    with open(setup["tmp"] / f"{case}_port.tsv", newline="") as f:
        assert len(list(csv.DictReader(f, delimiter="\t"))) == len(got)


def test_predict_long_through_the_cli(setup, tmp_path):
    out = str(tmp_path / "long.tsv")
    for flags, case in (([], "plain"), (["--overlap"], "overlap"), (["--merge_gap", "0.0"], "plain_gap_0")):
        res = cli.predict(["-m", setup["path"], "-i", setup["wavs"], "-p", out, "--long", "--device", "cpu", *flags])
        mine = setup[case][1]
        assert res["n_windows"] == mine["n_windows"] and res["n_files"] == 3
        np.testing.assert_array_equal(res["strong"], mine["strong"])
        with open(out, newline="") as f:
            rows = list(csv.DictReader(f, delimiter="\t"))
        assert [(r["event_label"], float(r["onset"]), float(r["offset"]), r["filename"]) for r in rows] == [
            (label, float(f"{on}"), float(f"{off}"), fn) for label, on, off, fn in mine["events"]]
    with pytest.raises(SystemExit):
        cli.predict(["-m", setup["path"], "-i", setup["wavs"], "-p", out, "--long", "--weak_fname", "tags.tsv",
                     "--device", "cpu"])
