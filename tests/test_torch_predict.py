"""Port parity end to end: checkpoint + wav directory → events TSV.

One JAX-written checkpoint at the dryrun geometry (T = 96 frames, 16
filters, 16 GRU cells, eval batch 4) goes through the JAX package's
CheckpointEvaluator.predict_set and through the port's
`cli.predict([... "--device", "cpu", "--synthetic_audio"])` on the same 7
synthetic clips (one full batch and a padded tail). Strong probabilities
agree within 1e-4, the events and weak-tag TSVs hold the same rows, and
both score the same event macro-F1. The seed keeps every probability more
than 1e-4 away from each decision threshold, so no row can flip on
float noise.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest

from dcase2019_task4_tpu.config import DEFAULT_CLASSES, Config, DSPConfig, ModelConfig, TrainConfig
from dcase2019_task4_tpu.data.audio_io import SyntheticAudioSource, synth_clip, write_wav
from dcase2019_task4_tpu.data.encoder import LabelCodec
from dcase2019_task4_tpu.config import PathsConfig
from dcase2019_task4_tpu.data.manifests import Manifest, load_manifest
from dcase2019_task4_tpu.data.pipeline import Stream, iter_eval_batches
from dcase2019_task4_tpu.eval.evaluate import CheckpointEvaluator as JaxEvaluator
from dcase2019_task4_tpu.eval.sed_scores import compute_strong_metrics
from dcase2019_task4_tpu.models.crnn import CRNN
from dcase2019_task4_tpu.train import checkpoints as jckpt
from dcase2019_task4_tpu.train.steps import init_train_state
from dcase2019_task4_tpu_torch import cli
from dcase2019_task4_tpu_torch.data.manifests import load_manifest as read_manifest
from dcase2019_task4_tpu_torch.eval.evaluate import CheckpointEvaluator, resolve_device
from dcase2019_task4_tpu_torch.models.crnn import CRNN as TorchCRNN
from dcase2019_task4_tpu_torch.models.crnn import seeded_init_
from dcase2019_task4_tpu_torch.train.checkpoints import params_to_jax

SEED = 2
N_CLIPS = 7
CFG = Config(dsp=DSPConfig(max_len_seconds=1.11),
             model=ModelConfig(nb_filters=(16, 16, 16), n_rnn_cell=16),
             train=TrainConfig(batch_size=4))
THRESHOLDS = [0.35, 0.4, 0.45, 0.5, 0.55, 0.6, 0.65, 0.5, 0.45, 0.4]
WINDOWS = [1, 3, 5, 7, 3, 5, 1, 3, 5, 7]
VARIANTS = {
    "scalar": dict(threshold=0.5, median_window=None, port_flags=[]),
    "per_class_thresholds": dict(threshold=np.asarray(THRESHOLDS), median_window=None,
                                 port_flags=["--thresholds_json", "thresholds.json"]),
    "per_class_windows": dict(threshold=0.5, median_window=np.asarray(WINDOWS),
                              port_flags=["--median_windows_json", "windows.json"]),
}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    work = tmp_path_factory.mktemp("predict")
    d = CFG.dsp
    wav_dir = work / "wavs"
    wav_dir.mkdir()
    names = [f"clip_{i}.wav" for i in range(N_CLIPS)]
    for i, name in enumerate(names):
        write_wav(str(wav_dir / name), synth_clip(name, [(i, 0.1, 0.9)], d.max_len_seconds, d.sample_rate),
                  d.sample_rate)
    (work / "thresholds.json").write_text(json.dumps(dict(zip(DEFAULT_CLASSES, THRESHOLDS))))
    (work / "windows.json").write_text(json.dumps(WINDOWS))

    # JAX TrainState carrying seeded weights large enough to spread the heads
    state = init_train_state(CRNN(CFG.model), optax.adam(1e-3), jax.random.PRNGKey(SEED))
    params, bn_state = params_to_jax(seeded_init_(TorchCRNN(CFG.model), SEED))
    params["dense"]["w"] = params["dense"]["w"] * 8  # strong probabilities spread over (0, 1)
    state = state._replace(params=jax.tree.map(jnp.asarray, params),
                           bn_state=jax.tree.map(jnp.asarray, bn_state))
    meta = {
        "epoch": 1, "valid_metric": {}, "pooling_time_ratio": CFG.model.pooling_time_ratio,
        "scaler": {"mean_": [-40.0] * d.n_mels, "mean_of_square_": [1825.0] * d.n_mels},
        "many_hot_encoder": LabelCodec(DEFAULT_CLASSES, d.max_frames // 8).state_dict(),
        "config": jckpt.config_to_dict(CFG), "mean_teacher": True,
    }
    ckpt_path = str(work / "model.npz")
    jckpt.save_checkpoint(ckpt_path, state, meta)

    jev = JaxEvaluator(ckpt_path, synthetic_audio=True)
    manifest = Manifest(kind="unlabeled", filenames=names, df=pd.DataFrame({"filename": names}))
    src = SyntheticAudioSource(manifest, jev.codec.labels, d.sample_rate, d.max_len_seconds)
    stream = Stream("predict", manifest, src, jev.codec, d.sample_rate, d.hop_length, 8)
    strong = []
    for batch in iter_eval_batches(stream, 4, d.max_samples, d.n_window, d.hop_length, d.max_frames):
        s, _ = jev.predict(jev.state.params, jev.state.bn_state,
                           jev.eval_features(batch["audio"], batch["frames"]))
        strong.append(np.asarray(s)[: batch["n_valid"]])
    gt = pd.DataFrame(
        [(f, on, off, DEFAULT_CLASSES[c]) for f in names for c, on, off in src._events[f]],
        columns=["filename", "onset", "offset", "event_label"],
    )
    return {"work": work, "wav_dir": str(wav_dir), "ckpt": ckpt_path, "jev": jev,
            "jax_strong": np.concatenate(strong), "gt": gt}


def _rows(path):
    df = pd.read_csv(path, sep="\t")
    return sorted(df.itertuples(index=False, name=None), key=str)


def _port(setup, tag, flags):
    work = setup["work"]
    out, tags = str(work / f"port_{tag}.tsv"), str(work / f"port_{tag}_tags.tsv")
    flags = [str(work / f) if f.endswith(".json") else f for f in flags]
    res = cli.predict(["-m", setup["ckpt"], "-i", setup["wav_dir"], "-p", out, "--weak_fname", tags,
                       "--device", "cpu", "--synthetic_audio", *flags])
    return res, out, tags


def test_probabilities_clear_every_threshold(setup):
    s = setup["jax_strong"]
    assert s.shape == (N_CLIPS, 12, 10)
    assert np.abs(s - 0.5).min() > 1e-4
    assert np.abs(s - np.asarray(THRESHOLDS)).min() > 1e-4
    assert 0.05 < (s > 0.5).mean() < 0.95  # events exist and are not everywhere


def test_strong_probabilities_match(setup):
    res, _, _ = _port(setup, "probs", [])
    assert res["n_files"] == N_CLIPS
    np.testing.assert_allclose(res["strong"], setup["jax_strong"], rtol=0, atol=1e-4)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_events_tags_and_f1_match(setup, variant):
    v = VARIANTS[variant]
    work = setup["work"]
    jax_out, jax_tags = str(work / f"jax_{variant}.tsv"), str(work / f"jax_{variant}_tags.tsv")
    jres = setup["jev"].predict_set(setup["wav_dir"], jax_out, weak_fname=jax_tags,
                                    threshold=v["threshold"], median_window=v["median_window"])
    _, out, tags = _port(setup, variant, v["port_flags"])
    ours, theirs = _rows(out), _rows(jax_out)
    assert len(theirs) > 0 and ours == theirs
    assert _rows(tags) == _rows(jax_tags)
    f1 = [compute_strong_metrics(p, setup["gt"]).results_class_wise_average_metrics()
          ["f_measure"]["f_measure"]
          for p in (pd.read_csv(out, sep="\t"), jres["predictions"])]
    assert f1[0] == f1[1]


def test_cuda_request_without_a_card_raises(setup):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        CheckpointEvaluator(setup["ckpt"], device="cuda")


@pytest.mark.parametrize("tsv", ["validation", "weak", "unlabel"])
def test_read_manifest_matches_jax(tsv):
    """The pandas-free TSV reader sees the same schema, files and labels
    (what SyntheticAudioSource renders from) as data.manifests."""
    path = getattr(PathsConfig(), tsv)
    ours, theirs = read_manifest(path), load_manifest(path)
    assert ours.kind == theirs.kind and ours.filenames == theirs.filenames
    if theirs.kind == "strong":
        assert ours.events == theirs.events
    if theirs.kind == "weak":
        assert ours.weak_labels == theirs.weak_labels
