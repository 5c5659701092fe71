"""The port's serving export (dcase2019_task4_tpu_torch/eval/export.py)
against the JAX package's (dcase2019_task4_tpu/eval/export.py), and the
forward kernels' torch.library ops it traces.

One checkpoint of seeded weights at tests/test_export.py's tiny geometry
(1 s clips, 8 filters, 8 GRU cells, 4 classes, batch 2) is written by the
JAX package's writer and read by both evaluators (its configuration runs
the JAX package's Pallas kernels in interpret mode, as that package's CPU
tests run them, where the port holds its kernels' roundings; the port
ignores the field); each package exports
and loads its own artifact, and both run the same int16 batch: strong and
weak probabilities within 1e-4, in float32 and in bfloat16 (at 1.11 s
clips, T = 96 frames: the bfloat16 model runs only through the fused
blocks, which take whole pooling windows). On the CPU the port's artifact
runs the ops' plain versions and gives the direct path's bits. Also: the
batch shape is enforced, each loader refuses the other's artifact, the
headers' keys are equal, `evaluate --export --export_batch`, and
`torch.library.opcheck` on every op at small CPU shapes.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dcase2019_task4_tpu.config import Config, DSPConfig, ModelConfig, TrainConfig
from dcase2019_task4_tpu.data.encoder import LabelCodec
from dcase2019_task4_tpu.eval import export as jexport
from dcase2019_task4_tpu.eval.evaluate import CheckpointEvaluator as JaxEvaluator
from dcase2019_task4_tpu.models.crnn import CRNN
from dcase2019_task4_tpu.train import checkpoints as jckpt
from dcase2019_task4_tpu.train.steps import init_train_state
from dcase2019_task4_tpu_torch import cli
from dcase2019_task4_tpu_torch.config import ModelConfig as TorchModelConfig
from dcase2019_task4_tpu_torch.eval import export as texport
from dcase2019_task4_tpu_torch.eval.evaluate import CheckpointEvaluator
from dcase2019_task4_tpu_torch.models.crnn import CRNN as TorchCRNN
from dcase2019_task4_tpu_torch.models.crnn import seeded_init_
from dcase2019_task4_tpu_torch.ops import crows_block, entry_conv, fused_block, fused_entry_block, fused_mel
from dcase2019_task4_tpu_torch.ops import packed_conv
from dcase2019_task4_tpu_torch.ops.mel import MelFrontend, host_reflect_pad
from dcase2019_task4_tpu_torch.train.checkpoints import params_to_jax

TOL = 1e-4
GEOMETRY = {"float32": 1.0, "bfloat16": 1.11}  # seconds a clip


def _cfg(dtype: str) -> Config:
    return Config(dsp=DSPConfig(max_len_seconds=GEOMETRY[dtype]),
                  model=ModelConfig(nclass=4, nb_filters=(8, 8, 8), n_rnn_cell=8, compute_dtype=dtype,
                                    fused_interpret=True),
                  train=TrainConfig(batch_size=2))


def _checkpoint(path, dtype: str) -> str:
    """Seeded weights in a JAX TrainState checkpoint both packages read."""
    cfg = _cfg(dtype)
    state = init_train_state(CRNN(cfg.model), optax.adam(1e-3), jax.random.PRNGKey(0))
    tcfg = TorchModelConfig(nclass=4, nb_filters=(8, 8, 8), n_rnn_cell=8, compute_dtype=dtype)
    params, bn_state = params_to_jax(seeded_init_(TorchCRNN(tcfg), 1))
    state = state._replace(params=jax.tree.map(jnp.asarray, params), bn_state=jax.tree.map(jnp.asarray, bn_state))
    n_mels = cfg.dsp.n_mels
    meta = {
        "epoch": 1, "valid_metric": {}, "pooling_time_ratio": 8,
        "scaler": {"mean_": np.linspace(-40.0, -10.0, n_mels).tolist(),
                   "mean_of_square_": (np.linspace(-40.0, -10.0, n_mels) ** 2 + 9.0).tolist()},
        "many_hot_encoder": LabelCodec(["a", "b", "c", "d"], cfg.dsp.max_frames // 8).state_dict(),
        "config": jckpt.config_to_dict(cfg), "mean_teacher": True,
    }
    out = str(path / f"model_{dtype}.npz")
    jckpt.save_checkpoint(out, state, meta)
    return out


def _batch(d, batch: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    clips = [rng.standard_normal(int(d.sample_rate * s)).astype(np.float32) * 0.1
             for s in np.linspace(0.4, d.max_len_seconds, batch)]
    padded, frames = host_reflect_pad(clips, d.max_samples, d.n_window, d.hop_length, d.max_frames)
    return np.clip(np.round(padded * 32768.0), -32768, 32767).astype(np.int16), frames


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def artifacts(request, tmp_path_factory):
    dtype = request.param
    work = tmp_path_factory.mktemp(f"export_{dtype}")
    ckpt = _checkpoint(work, dtype)
    jev = JaxEvaluator(ckpt)
    jpath, tpath = str(work / "jax.dc19serve"), str(work / "torch.dc19serve")
    jheader = jexport.export_serving(jev, jpath, batch_size=2)
    ev = CheckpointEvaluator(ckpt, device="cpu")
    theader = texport.export_serving(ev, tpath, batch_size=2)
    audio, frames = _batch(ev.cfg.dsp, 2)
    return {"dtype": dtype, "work": work, "ckpt": ckpt, "ev": ev, "jax": (jpath, jheader), "torch": (tpath, theader),
            "audio": audio, "frames": frames}


def test_artifacts_agree_with_the_jax_package(artifacts):
    audio, frames = artifacts["audio"], artifacts["frames"]
    j_strong, j_weak = jexport.load_serving(artifacts["jax"][0])(audio, frames)
    served = texport.load_serving(artifacts["torch"][0])
    t_strong, t_weak = served(audio, frames)
    assert served.header["platforms"] == ["cpu"] and served.header["pooling_time_ratio"] == 8
    assert t_strong.shape == (2, artifacts["ev"].codec.n_frames, 4) and t_weak.shape == (2, 4)
    np.testing.assert_allclose(t_strong.numpy(), np.asarray(j_strong), rtol=0, atol=TOL)
    np.testing.assert_allclose(t_weak.numpy(), np.asarray(j_weak), rtol=0, atol=TOL)
    assert 0.0 <= float(t_weak.min()) and float(t_weak.max()) <= 1.0


def test_artifact_gives_the_direct_path_bits(artifacts):
    ev, audio, frames = artifacts["ev"], artifacts["audio"], artifacts["frames"]
    want_strong, want_weak = ev._predict(ev.features(audio, frames))
    got_strong, got_weak = texport.load_serving(artifacts["torch"][0])(audio, frames)
    assert torch.equal(got_strong, want_strong) and torch.equal(got_weak, want_weak)


def test_batch_shape_is_enforced(artifacts):
    audio, frames = _batch(artifacts["ev"].cfg.dsp, 4)
    with pytest.raises(ValueError, match="Shape mismatch"):
        texport.load_serving(artifacts["torch"][0])(audio, frames)


def test_each_loader_refuses_the_others_artifact(artifacts):
    with open(artifacts["torch"][0], "rb") as f:
        assert f.read(16) == b"DC19TORCHSERVE1\n"
    with pytest.raises(ValueError, match="serving artifact"):
        jexport.load_serving(artifacts["torch"][0])
    with pytest.raises(ValueError, match="serving artifact"):
        texport.load_serving(artifacts["jax"][0])


def test_headers_have_the_jax_keys(artifacts):
    (_, jheader), (_, theader) = artifacts["jax"], artifacts["torch"]
    assert list(theader) == list(jheader)
    assert {k: v for k, v in theader.items() if k != "platforms"} == \
           {k: v for k, v in jheader.items() if k != "platforms"}
    assert jheader["platforms"] == ["cpu"] and theader["platforms"] == ["cpu"]


def test_cli_evaluate_export_with_its_batch(tmp_path):
    ckpt = _checkpoint(tmp_path, "float32")
    out = str(tmp_path / "cli.dc19serve")
    header = cli.evaluate(["-m", ckpt, "--export", out, "--export_batch", "3", "--device", "cpu"])
    assert header["batch_size"] == 3 and header["audio_shape"][0] == 3
    served = texport.load_serving(out)
    assert json.loads(json.dumps(served.header)) == header
    ev = CheckpointEvaluator(ckpt, device="cpu")
    audio, frames = _batch(ev.cfg.dsp, 3, seed=1)
    strong, weak = served(audio, frames)
    want_strong, want_weak = ev._predict(ev.features(audio, frames))
    assert torch.equal(strong, want_strong) and torch.equal(weak, want_weak)


# ------------------------------------------------------------------ opcheck


def _vectors(rng, C):
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    return (t(1 + 0.1 * rng.standard_normal(C)), t(0.1 * rng.standard_normal(C)), t(0.1 * rng.standard_normal(C)),
            t(rng.uniform(0.5, 2.0, C)), t(rng.standard_normal((C, C)) / C ** 0.5), t(0.1 * rng.standard_normal(C)))


def _op_cases():
    rng = np.random.default_rng(0)
    t = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a)).to(dt)  # noqa: E731
    fe = MelFrontend(sample_rate=8000, n_window=256, hop_length=101, n_mels=16, f_max=4000.0, max_frames=12,
                     onedot=True)
    chunks = fe._hop_chunks(t(rng.standard_normal((2, 12 * 101 + 256)) * 0.1))
    dims = (256, 101, 12)
    C, pool = 8, [2, 4]
    scale, bias, mean, var, glu_w, glu_b = _vectors(rng, C)
    y = t(rng.standard_normal((2, 8, 16, C)))
    x3 = t(rng.standard_normal((2, 8, 16)))
    wc, bc = t(rng.standard_normal((3, 3, 1, C)) * 0.3), t(0.1 * rng.standard_normal(C))
    vecs = (scale, bias, mean, var, glu_w, glu_b)
    return {
        "fused_stft_mel": (fused_mel.fused_stft_mel_op, (chunks, *fe.bases(), *dims)),
        "fused_stft_mel_onedot": (fused_mel.fused_stft_mel_onedot_op, (chunks, *fe.onedot_bases(), *dims)),
        "conv2d_forward": (packed_conv.conv2d_forward_op, (y, t(rng.standard_normal((3, 3, C, C)) * 0.2), bias)),
        "fused_bn_glu_pool_eval": (fused_block.fused_bn_glu_pool_eval, (y, *vecs, pool, 1e-5)),
        "fused_bn_glu_pool_eval_bf16": (fused_block.fused_bn_glu_pool_eval, (y.bfloat16(), *vecs, pool, 1e-5)),
        "entry_conv_forward": (entry_conv.entry_conv_forward_op, (x3, wc, bc)),
        "entry_block_fwd_eval": (fused_entry_block.entry_block_fwd_eval, (x3, wc, bc, *vecs, pool, 1e-5)),
        "crows_block_fwd_eval": (crows_block.crows_block_fwd_eval,
                                 (t(rng.standard_normal((2, 8, 64))), t(rng.standard_normal((3, 3, 1, 64)) * 0.3),
                                  t(0.1 * rng.standard_normal(64)), *_vectors(rng, 64), [2, 4], 1e-5)),
    }


OPS = ("fused_stft_mel", "fused_stft_mel_onedot", "conv2d_forward", "fused_bn_glu_pool_eval",
       "fused_bn_glu_pool_eval_bf16", "entry_conv_forward", "entry_block_fwd_eval", "crows_block_fwd_eval")


def test_every_op_is_checked():
    assert tuple(_op_cases()) == OPS
    assert {n.removesuffix("_bf16") for n in OPS} == {
        name for name in dir(torch.ops.dcase19_torch) if not name.startswith("_") and name not in ("name",)
        and isinstance(getattr(torch.ops.dcase19_torch, name), torch._ops.OpOverloadPacket)}


@pytest.mark.parametrize("name", OPS)
def test_opcheck(name):
    op, args = _op_cases()[name]
    torch.library.opcheck(op, args)
    out = op(*args)
    assert all(torch.isfinite(o.float()).all() for o in (out if isinstance(out, tuple) else (out,)))
