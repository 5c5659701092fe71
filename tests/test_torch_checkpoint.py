"""Port parity: reading the JAX package's v2 checkpoints without jax.

A checkpoint written by the JAX package's save_checkpoint (the full
TrainState from init_train_state, metadata as the experiment writes it)
loads through the port's load_inference_state with params and bn_state
equal leaf for leaf; the port's writer round-trips through the port.
"""

import dataclasses
import json

import jax
import numpy as np
import optax
import pytest

from dcase2019_task4_tpu.config import DEFAULT_CLASSES, Config, DSPConfig, ModelConfig
from dcase2019_task4_tpu.data.encoder import LabelCodec
from dcase2019_task4_tpu.eval.evaluate import config_from_metadata as jax_config_from_metadata
from dcase2019_task4_tpu.models.crnn import CRNN
from dcase2019_task4_tpu.train import checkpoints as jckpt
from dcase2019_task4_tpu.train.steps import init_train_state
from dcase2019_task4_tpu.utils.scaler import Scaler
from dcase2019_task4_tpu_torch.eval.evaluate import config_from_metadata
from dcase2019_task4_tpu_torch.models.crnn import CRNN as TorchCRNN
from dcase2019_task4_tpu_torch.models.crnn import seeded_init_
from dcase2019_task4_tpu_torch.train import checkpoints as tckpt

CFG = Config(dsp=DSPConfig(max_len_seconds=1.11),
             model=ModelConfig(nb_filters=(16, 16, 16), n_rnn_cell=16))


def _metadata(cfg):
    scaler = Scaler()
    scaler.mean_, scaler.mean_of_square_ = np.full(64, -30.0), np.full(64, 1000.0)
    return {
        "epoch": 3,
        "valid_metric": {"event_macro_f1": 0.1, "weak_macro_f1": 0.2},
        "pooling_time_ratio": cfg.model.pooling_time_ratio,
        "scaler": scaler.state_dict(),
        "many_hot_encoder": LabelCodec(DEFAULT_CLASSES, 12).state_dict(),
        "config": jckpt.config_to_dict(cfg),
        "mean_teacher": True,
    }


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    state = init_train_state(CRNN(CFG.model), optax.adam(1e-3), jax.random.PRNGKey(0))
    path = str(tmp_path_factory.mktemp("ckpt") / "model.npz")
    jckpt.save_checkpoint(path, state, _metadata(CFG))
    return path, state


def _assert_trees_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb) > 0
    for u, v in zip(la, lb):
        assert np.asarray(u).shape == np.asarray(v).shape
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


def test_jax_checkpoint_loads_leaf_for_leaf(jax_checkpoint):
    path, state = jax_checkpoint
    params, bn_state = tckpt.load_inference_state(path)
    assert jax.tree.structure(params) == jax.tree.structure(jax.tree.map(np.asarray, state.params))
    _assert_trees_equal(params, state.params)
    _assert_trees_equal(bn_state, state.bn_state)


def test_metadata_and_config_match_jax(jax_checkpoint):
    path, _ = jax_checkpoint
    meta = tckpt.read_metadata(path)
    assert meta == jckpt.read_metadata(path)
    # the port's Config is its own dataclass: equal field for field
    assert jax_config_from_metadata(meta) == CFG
    assert dataclasses.asdict(config_from_metadata(meta)) == dataclasses.asdict(CFG)


def test_jax_checkpoint_feeds_the_port_model(jax_checkpoint):
    path, state = jax_checkpoint
    model = TorchCRNN(CFG.model)
    model.load_state_dict(tckpt.params_from_jax(*tckpt.load_inference_state(path)))
    p2, s2 = tckpt.params_to_jax(model)
    _assert_trees_equal(p2, state.params)
    _assert_trees_equal(s2, state.bn_state)


def test_port_writer_round_trips(tmp_path):
    model = seeded_init_(TorchCRNN(CFG.model), 5)
    params, bn_state = tckpt.params_to_jax(model)
    path = str(tmp_path / "port.npz")
    meta = _metadata(CFG)
    tckpt.save_inference_checkpoint(path, params, bn_state, meta)
    p2, s2 = tckpt.load_inference_state(path)
    _assert_trees_equal(p2, params)
    _assert_trees_equal(s2, bn_state)
    # JSON turns the config's tuples into lists
    assert tckpt.read_metadata(path) == jckpt.read_metadata(path) == json.loads(json.dumps(meta))


def test_port_writer_layout_matches_jax_writer(tmp_path, jax_checkpoint):
    """Same leaf paths and shapes as the JAX writer's params/bn_state leaves."""
    _, state = jax_checkpoint
    path = str(tmp_path / "port.npz")
    tckpt.save_inference_checkpoint(path, jax.tree.map(np.asarray, state.params),
                                    jax.tree.map(np.asarray, state.bn_state), _metadata(CFG))
    ours = tckpt._load(path, want_leaves=False)[1]
    full = jckpt._leaf_paths(state)
    keep = [i for i, p in enumerate(full) if p.startswith((".params", ".bn_state"))]
    assert ours["leaf_paths"] == [full[i] for i in keep]
    assert ours["leaf_shapes"] == [list(np.shape(jax.tree.leaves(state)[i])) for i in keep]


def test_bfloat16_leaves_widen_exactly(tmp_path):
    import jax.numpy as jnp

    from dcase2019_task4_tpu.train.steps import TrainState

    params = {"dense": {"w": jnp.asarray([[1.5, -2.25], [3.0, 0.0078125]], jnp.bfloat16)}}
    bn_state = {"cnn": [{"mean": jnp.zeros(2), "var": jnp.ones(2)}]}
    state = TrainState(params, bn_state, None, None, None, jnp.int32(0))
    path = str(tmp_path / "bf16.npz")
    jckpt.save_checkpoint(path, state, {"epoch": 0})
    loaded, _ = tckpt.load_inference_state(path)
    np.testing.assert_array_equal(loaded["dense"]["w"], np.asarray(params["dense"]["w"], np.float32))
    assert loaded["dense"]["w"].dtype == np.float32
