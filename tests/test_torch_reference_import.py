"""Reference-checkpoint import (dcase2019_task4_tpu_torch/train/torch_import.py)
against the JAX package's (dcase2019_task4_tpu/train/torch_import.py).

A reference-layout state dict ({"cnn": conv{i} / batchnorm{i} / glu{i} or
cg{i}, "rnn": rnn.weight_ih_l{k}[_reverse] ..., "dense"}, no attention head,
as the reference's torch.save writes it, main.py:293-309) is drawn with
numpy from a seed. Imported by both packages, every leaf the reference
stores is bit for bit the same (`params_to_jax` of the port's model
against the JAX pytrees), at the flagship ModelConfig and with context
gating. A torch.save file of it goes through both packages'
`CheckpointEvaluator.from_torch_checkpoint` on three synthetic clips:
strong probabilities within 1e-4, and weak ones within 1e-4 once the port
takes the JAX package's attention head (the one leaf the file does not
hold, which each package initialises its own way). Then the port's CLI
`evaluate` and `predict` with `--torch_checkpoint`.
"""

import jax
import numpy as np
import pytest
import torch

from dcase2019_task4_tpu.config import ModelConfig as JaxModelConfig
from dcase2019_task4_tpu.eval.evaluate import CheckpointEvaluator as JaxEvaluator
from dcase2019_task4_tpu.models.crnn import CRNN as JaxCRNN
from dcase2019_task4_tpu.train import torch_import as jimport
from dcase2019_task4_tpu_torch import cli
from dcase2019_task4_tpu_torch.config import DEFAULT_CLASSES, ModelConfig
from dcase2019_task4_tpu_torch.data.audio_io import synth_clip
from dcase2019_task4_tpu_torch.data.encoder import LabelCodec
from dcase2019_task4_tpu_torch.data.pipeline import quantize_audio_int16
from dcase2019_task4_tpu_torch.eval.evaluate import CheckpointEvaluator
from dcase2019_task4_tpu_torch.models.crnn import CRNN, seeded_init_
from dcase2019_task4_tpu_torch.ops.mel import host_reflect_pad
from dcase2019_task4_tpu_torch.train import torch_import as timport
from dcase2019_task4_tpu_torch.train.checkpoints import params_to_jax

TOL = 1e-4
VALIDATION = "dataset_metadata/validation/validation.tsv"
SMALL = {"nb_filters": [16, 16, 16], "n_RNN_cell": 16}  # reference kwargs of the file the evaluators read


def reference_state_dict(kwargs: dict, seed: int) -> dict:
    """A reference CRNN state_dict in its serialized layout, drawn with numpy."""
    rng = np.random.default_rng(seed)
    t = lambda *shape, s=1.0, m=0.0: torch.from_numpy((m + s * rng.standard_normal(shape)).astype(np.float32))  # noqa: E731
    act = "cg" if kwargs.get("activation") == "cg" else "glu"
    filters, H = kwargs.get("nb_filters", [64, 64, 64]), kwargs.get("n_RNN_cell", 64)
    cnn, c_in = {}, 1
    for i, c in enumerate(filters):
        cnn.update({f"conv{i}.weight": t(c, c_in, 3, 3, s=0.3), f"conv{i}.bias": t(c, s=0.05),
                    f"batchnorm{i}.weight": t(c, s=0.1, m=1.0), f"batchnorm{i}.bias": t(c, s=0.1),
                    f"batchnorm{i}.running_mean": t(c, s=0.3),
                    f"batchnorm{i}.running_var": torch.from_numpy(rng.uniform(0.5, 2.0, c).astype(np.float32)),
                    f"batchnorm{i}.num_batches_tracked": torch.tensor(7),
                    f"{act}{i}.linear.weight": t(c, c, s=c ** -0.5), f"{act}{i}.linear.bias": t(c, s=0.05)})
        c_in = c
    rnn, d_in = {}, filters[-1]
    for k in range(kwargs.get("n_layers_RNN", 2)):
        for suf in ("", "_reverse"):
            rnn.update({f"rnn.weight_ih_l{k}{suf}": t(3 * H, d_in, s=H ** -0.5),
                        f"rnn.weight_hh_l{k}{suf}": t(3 * H, H, s=H ** -0.5),
                        f"rnn.bias_ih_l{k}{suf}": t(3 * H, s=0.1), f"rnn.bias_hh_l{k}{suf}": t(3 * H, s=0.1)})
        d_in = 2 * H
    dense = {"weight": t(kwargs.get("nclass", 10), 2 * H, s=(2 * H) ** -0.5 * 4), "bias": t(kwargs.get("nclass", 10))}
    return {"cnn": cnn, "rnn": rnn, "dense": dense}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _leaves(tree[key], f"{prefix}/{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, item in enumerate(tree) for k, v in _leaves(item, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("activation", ["glu", "cg"])
def test_leaves_equal_the_jax_import_bit_for_bit(activation):
    kwargs = {"activation": activation}
    sd = reference_state_dict(kwargs, 3)
    jcfg = JaxModelConfig(activation=activation)
    jmodel = JaxCRNN(jcfg)
    params, bn_state = jimport.import_model_state_dict(sd, *jmodel.init(jax.random.PRNGKey(0)))
    port = timport.import_model_state_dict(sd, seeded_init_(CRNN(ModelConfig(activation=activation)), 0))
    tparams, tbn = params_to_jax(port)
    want, got = _leaves({"params": params, "bn": bn_state}), _leaves({"params": tparams, "bn": tbn})
    assert set(got) == set(want)
    stored = [k for k in want if "dense_softmax" not in k]
    assert len(stored) == len(want) - 2
    for k in stored:
        assert got[k].dtype == np.float32 and np.array_equal(got[k], np.asarray(want[k], np.float32)), k


@pytest.fixture(scope="module")
def reference_file(tmp_path_factory):
    work = tmp_path_factory.mktemp("reference")
    kwargs = dict(SMALL, nclass=10)
    n_mels, frames = 64, 864 // 8
    state = {
        "model": {"name": "CRNN", "args": [], "kwargs": kwargs, "state_dict": reference_state_dict(kwargs, 5)},
        "scaler": {"mean_": [-40.0] * n_mels, "mean_of_square_": [1700.0] * n_mels},
        "many_hot_encoder": LabelCodec(DEFAULT_CLASSES, frames).state_dict(),
        "pooling_time_ratio": 8,
    }
    path = str(work / "baseline_best")
    torch.save(state, path)
    return work, path


def _clips(n: int):
    from dcase2019_task4_tpu_torch.config import Config

    d = Config().dsp
    rng = np.random.default_rng(4)
    clips = [synth_clip(f"clip_{i}.wav", [(int(rng.integers(10)), 0.5, 6.0)], d.max_len_seconds, d.sample_rate)
             for i in range(n)]
    padded, frames = host_reflect_pad(clips, d.max_samples, d.n_window, d.hop_length, d.max_frames)
    return quantize_audio_int16(padded), frames


def test_from_torch_checkpoint_matches_the_jax_package(reference_file):
    _, path = reference_file
    audio, frames = _clips(3)
    jev = JaxEvaluator.from_torch_checkpoint(path)
    j_strong, j_weak = jev.predict(jev.state.params, jev.state.bn_state, jev.eval_features(audio, frames))
    ev = CheckpointEvaluator.from_torch_checkpoint(path, device="cpu")
    assert ev.meta == {"epoch": "torch-import", "pooling_time_ratio": 8, "mean_teacher": True}
    strong, weak = ev._predict(ev.features(audio, frames))
    np.testing.assert_allclose(strong.numpy(), np.asarray(j_strong), rtol=0, atol=TOL)
    # the file holds no attention head: with the JAX package's, the weak probabilities agree too
    head = jev.state.params["dense_softmax"]
    with torch.no_grad():
        ev.model.dense_softmax.weight.copy_(torch.from_numpy(np.asarray(head["w"]).T.copy()))
        ev.model.dense_softmax.bias.copy_(torch.from_numpy(np.asarray(head["b"])))
    strong_aligned, weak = ev._predict(ev.features(audio, frames))
    assert torch.equal(strong_aligned, strong)
    np.testing.assert_allclose(weak.numpy(), np.asarray(j_weak), rtol=0, atol=TOL)


def test_cli_evaluate_and_predict_take_a_torch_checkpoint(reference_file):
    work, path = reference_file
    ev = CheckpointEvaluator.from_torch_checkpoint(path, device="cpu", synthetic_audio=True)
    want = ev.test_model(VALIDATION, 2)
    res = cli.evaluate(["-m", path, "--torch_checkpoint", "--synthetic_audio", "-s", "2", "--sets", VALIDATION,
                        "--device", "cpu"])
    assert res[VALIDATION] == {k: v for k, v in want.items() if k not in ("predictions", "strong")}
    out = str(work / "events.tsv")
    pred = cli.predict(["-m", path, "--torch_checkpoint", "--synthetic_audio", "-i", VALIDATION, "-s", "2",
                        "-p", out, "--device", "cpu"])
    assert pred["n_files"] == 2 and np.array_equal(pred["strong"], want["strong"])
