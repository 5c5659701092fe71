"""Whole-TrainState checkpoints across the two packages.

A JAX checkpoint of a TrainState with seeded weights, teacher, BatchNorm
buffers, Adam moments and counters, restored by the port, gives the same
numbers bit for bit; a port checkpoint restores into the JAX package's
template, bit for bit. Plain Adam (optax.adam's state) and the ramped Adam
(optax.inject_hyperparams' state) keep the JAX layout leaf for leaf; the
supervised state has no teacher. Small model: filters (16, 16, 16), GRU 16.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dcase2019_task4_tpu.config import Config as JConfig
from dcase2019_task4_tpu.config import ModelConfig as JModel
from dcase2019_task4_tpu.models.crnn import CRNN as JCRNN
from dcase2019_task4_tpu.train import checkpoints as jckpt
from dcase2019_task4_tpu.train import schedules as jschedules
from dcase2019_task4_tpu.train import steps as jsteps
from dcase2019_task4_tpu_torch.config import Config, ModelConfig
from dcase2019_task4_tpu_torch.train import checkpoints as tckpt
from dcase2019_task4_tpu_torch.train import schedules as tschedules
from dcase2019_task4_tpu_torch.train import steps as tsteps

SMALL = dict(nb_filters=(16, 16, 16), n_rnn_cell=16)
TOTAL, RAMPUP = 40, 20


def jax_optimizer(ramped):
    return jschedules.meanteacher_adam(TOTAL, RAMPUP) if ramped else optax.adam(1e-3)


def port_state(ramped, with_ema, cfg=None):
    holder = {}

    def make(params):
        if ramped:
            opt, holder["set_step"] = tschedules.meanteacher_adam(params, TOTAL, RAMPUP)
            return opt
        return torch.optim.Adam(params, lr=1e-3)

    state = tsteps.init_train_state(cfg or ModelConfig(**SMALL), make, torch.Generator().manual_seed(1),
                                    with_ema=with_ema, device="cpu")
    return state, holder.get("set_step")


def seeded_jax_state(ramped, with_ema, seed=0):
    """A JAX TrainState whose every leaf is seeded noise of its own shape
    and dtype (counters 7, as after seven updates)."""
    state = jsteps.init_train_state(JCRNN(JModel(**SMALL)), jax_optimizer(ramped), jax.random.PRNGKey(seed),
                                    with_ema=with_ema)
    rng = np.random.default_rng(seed)

    def fill(leaf):
        leaf = np.asarray(leaf)
        if leaf.dtype == np.int32:
            return jnp.asarray(np.int32(7))
        return jnp.asarray(rng.standard_normal(leaf.shape).astype(leaf.dtype) * 0.1 + (leaf.ndim == 0) * 0.9)

    state = jax.tree.map(fill, state)
    # Adam's second moments are non-negative
    return state._replace(opt_state=jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.abs(x) if ".nu" in jax.tree_util.keystr(p) else x, state.opt_state))


def jax_leaves(state):
    flat = jax.tree_util.tree_flatten_with_path(state)[0]
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in flat}


def meta():
    return {"epoch": 3, "config": tckpt.config_to_dict(Config(model=ModelConfig(**SMALL)))}


def as_stored(doc):
    return json.loads(json.dumps(doc))  # tuples come back as lists


@pytest.mark.parametrize("ramped", [False, True], ids=["adam", "ramped_adam"])
@pytest.mark.parametrize("with_ema", [True, False], ids=["mean_teacher", "supervised"])
def test_jax_checkpoint_restores_into_the_port_bit_for_bit(tmp_path, ramped, with_ema):
    jstate = seeded_jax_state(ramped, with_ema)
    path = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(path, jstate, meta())
    state, _ = port_state(ramped, with_ema)
    state, got_meta = tckpt.restore_checkpoint(path, state, ramped_adam=ramped)
    assert got_meta == as_stored(meta()) and state.step == 7 and tckpt.adam_count(state.optimizer) == 7
    want = jax_leaves(jstate)
    mine = dict(tckpt.train_state_leaves(state, ramped))
    assert list(mine) == list(want)
    for k, v in want.items():
        if "hyperparams[" in k:
            continue  # the values the last update used: the port reads them from its param groups
        assert mine[k].dtype == v.dtype, k
        np.testing.assert_array_equal(mine[k], v, err_msg=k)
    assert (state.teacher is None) == (not with_ema)


@pytest.mark.parametrize("ramped", [False, True], ids=["adam", "ramped_adam"])
@pytest.mark.parametrize("with_ema", [True, False], ids=["mean_teacher", "supervised"])
def test_port_checkpoint_restores_into_the_jax_template(tmp_path, ramped, with_ema):
    state, set_step = port_state(ramped, with_ema)
    src = seeded_jax_state(ramped, with_ema, seed=3)
    path = str(tmp_path / "src.npz")
    jckpt.save_checkpoint(path, src, meta())
    tckpt.restore_checkpoint(path, state, ramped_adam=ramped)
    if ramped:
        set_step(6)  # the hyperparameters of the seventh update, as optax stores them after it
    out = str(tmp_path / "port.npz")
    tckpt.save_checkpoint(out, state, meta(), ramped_adam=ramped)
    template = jsteps.init_train_state(JCRNN(JModel(**SMALL)), jax_optimizer(ramped), jax.random.PRNGKey(9),
                                       with_ema=with_ema)
    restored, got_meta = jckpt.restore_checkpoint(out, template)
    assert got_meta == as_stored(meta())
    got, want = jax_leaves(restored), jax_leaves(src)
    assert list(got) == list(want)
    for k, v in want.items():
        if "hyperparams[" in k:
            continue
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    if ramped:  # the param groups' values, in float32
        for name, value in set_step(6).items():
            assert got[f".opt_state.hyperparams['{name}']"] == np.float32(value), name


def test_the_restored_state_takes_the_same_step_as_the_saved_one(tmp_path):
    """Restore is complete: from a port checkpoint a fresh state takes the
    same Adam step as the state that wrote it."""
    state, _ = port_state(False, True)
    for p in state.student.parameters():
        p.grad = torch.full_like(p, 0.01)
    state.optimizer.step()
    state.step = 1
    path = str(tmp_path / "one.npz")
    tckpt.save_checkpoint(path, state, meta())
    other, _ = port_state(False, True)
    tckpt.restore_checkpoint(path, other)
    for st in (state, other):
        for p in st.student.parameters():
            p.grad = torch.linspace(-1, 1, p.numel()).reshape(p.shape)
        st.optimizer.step()
    for (name, a), b in zip(state.student.named_parameters(), other.student.parameters()):
        assert torch.equal(a, b), name
    for a, b in zip(state.teacher.state_dict().values(), other.teacher.state_dict().values()):
        assert torch.equal(a, b)


def test_a_different_model_is_refused(tmp_path):
    state, _ = port_state(False, True)
    path = str(tmp_path / "small.npz")
    tckpt.save_checkpoint(path, state, meta())
    wider, _ = port_state(False, True, ModelConfig(**dict(SMALL, nb_filters=(16, 16, 24))))
    with pytest.raises(ValueError, match="does not match"):
        tckpt.restore_checkpoint(path, wider)
    supervised, _ = port_state(False, False)
    with pytest.raises(ValueError, match="does not match"):
        tckpt.restore_checkpoint(path, supervised)


def test_config_to_dict_is_the_jax_packages():
    assert tckpt.config_to_dict(Config()) == jckpt.config_to_dict(JConfig())
    assert tckpt.config_to_dict(Config()) == dataclasses.asdict(Config())


@pytest.mark.parametrize("saved_ramped", [False, True], ids=["adam", "ramped_adam"])
def test_the_other_optimizer_is_refused(tmp_path, saved_ramped):
    """A run restores only its own optimizer's state, as the JAX template
    restore demands."""
    state, _ = port_state(saved_ramped, True)
    path = str(tmp_path / "state.npz")
    tckpt.save_checkpoint(path, state, meta(), ramped_adam=saved_ramped)
    other, _ = port_state(not saved_ramped, True)
    with pytest.raises(ValueError, match="holds the state of"):
        tckpt.restore_checkpoint(path, other, ramped_adam=not saved_ramped)
    jtemplate = jsteps.init_train_state(JCRNN(JModel(**SMALL)), jax_optimizer(not saved_ramped),
                                        jax.random.PRNGKey(0), with_ema=True)
    with pytest.raises(ValueError, match="the configs differ"):
        jckpt.restore_checkpoint(path, jtemplate)
    same, _ = port_state(saved_ramped, True)
    tckpt.restore_checkpoint(path, same, ramped_adam=saved_ramped)
    assert tckpt.adam_count(same.optimizer) == tckpt.adam_count(state.optimizer)
