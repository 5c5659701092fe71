"""The flat update tail's layout (DCASE_FLAT_OPT=1) and legacy v1 checkpoints.

The JAX package's switch runs its update tail over one raveled buffer
(optax.flatten), which is the per-leaf update element by element; what it
changes is the optimizer state's layout on disk. The port keeps its
per-leaf tail and reads the switch where it writes and restores a
checkpoint (train/checkpoints.py): Adam's moments as one 1-D leaf each.
Held here, at the dryrun geometry of tests/test_torch_train_step.py:

* one Mean-Teacher step from one state under either setting is bit for
  bit the same (the JAX package's own pin, tests/test_train_step.py), for
  plain and ramped Adam, and the flat leaves are ravel_pytree's raveling
  of the per-leaf moments;
* three steps track the JAX flat step: parameters and flat moments 1e-6,
  losses 1e-5;
* flat checkpoints cross between the packages both ways bit for bit, and a
  file of the other layout is refused naming both;
* a v1 pickle checkpoint is refused without the opt-in, read with
  `allow_legacy_pickle=True` or DCASE_ALLOW_LEGACY_PICKLE=1, and its
  unpickler names any class outside numpy and builtins without importing
  it;
* the tiny Experiment trains two epochs under either setting with the same
  metrics, writes its checkpoints in the setting's layout, and resumes
  only a checkpoint of its own setting.
"""

import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

from dcase2019_task4_tpu.train import checkpoints as jckpt
from dcase2019_task4_tpu.train import steps as jsteps
from dcase2019_task4_tpu_torch.train import checkpoints as tckpt
from dcase2019_task4_tpu_torch.train import schedules as tschedules
from dcase2019_task4_tpu_torch.train import steps as tsteps
from tests.test_torch_train_checkpoint import as_stored, jax_leaves, meta, port_state, seeded_jax_state
from tests.test_torch_train_step import (LR, STRONG, WEAK, _batch, _cfg, _feature_batches, _frontends, _jax_state,
                                         _jb, _moments, _np_tree, _tb, _torch_state)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOTAL, RAMPUP = 40, 20


def _one_step(monkeypatch, flat, ramped):
    """One MT step of the port, built under the given setting, from the
    state bridged from one seeded JAX state (moments seeded, count 3) →
    (state, metrics)."""
    if flat:
        monkeypatch.setenv("DCASE_FLAT_OPT", "1")
    else:
        monkeypatch.delenv("DCASE_FLAT_OPT", raising=False)
    cfg = _cfg(True)
    _, jstate = _jax_state(cfg, 3, optax.adam(LR))
    mu, nu = _moments(jstate.params, 6)
    holder = {}

    def make(params):
        if ramped:
            opt, holder["set_step"] = tschedules.meanteacher_adam(params, TOTAL, RAMPUP)
            return opt
        return torch.optim.Adam(params, lr=LR, betas=(0.9, 0.999), eps=1e-8)

    state = tsteps.init_train_state(cfg, make, torch.Generator().manual_seed(0))
    tckpt.train_state_from_jax(state, _np_tree(jstate.params), _np_tree(jstate.bn_state),
                               _np_tree(jstate.ema_params), _np_tree(jstate.ema_bn_state), mu, nu, step=3)
    _, tfe = _frontends(interpret=True)
    batch = _batch(5)
    step = tsteps.make_train_step(WEAK, STRONG, frontend=tfe, mean_teacher=True, rampup_length=10,
                                  max_consistency_cost=2.0, ema_alpha=0.999, noise_std=0.0)
    if ramped:
        holder["set_step"](state.step)
    state, metrics, _ = step(state, _tb(batch), torch.Generator().manual_seed(0), step.zero_metrics())
    return state, metrics


@pytest.mark.parametrize("ramped", [False, True], ids=["adam", "ramped_adam"])
def test_step_one_is_bit_for_bit_the_per_leaf_step(monkeypatch, ramped):
    tree, m_tree = _one_step(monkeypatch, False, ramped)
    flat, m_flat = _one_step(monkeypatch, True, ramped)
    assert m_tree["loss"].item() == m_flat["loss"].item()
    for k in m_tree:
        assert torch.equal(m_tree[k], m_flat[k]), k
    for model in ("student", "teacher"):
        for (name, a), b in zip(getattr(tree, model).named_parameters(), getattr(flat, model).parameters()):
            assert torch.equal(a, b), f"{model} {name}"
    want, got = tckpt.train_state_to_jax(tree), tckpt.train_state_to_jax(flat)
    inner = ".opt_state.inner_state[0]" if ramped else ".opt_state[0]"
    leaves = dict(tckpt.train_state_leaves(flat, ramped))  # under DCASE_FLAT_OPT=1
    n = sum(p.numel() for p in flat.student.parameters())
    for key in ("mu", "nu"):
        np.testing.assert_array_equal(ravel_pytree(got[key])[0], ravel_pytree(want[key])[0], err_msg=key)
        assert leaves[f"{inner}.{key}"].shape == (n,)
        np.testing.assert_array_equal(leaves[f"{inner}.{key}"], np.asarray(ravel_pytree(want[key])[0]), err_msg=key)
    assert tckpt.adam_count(flat.optimizer) == tckpt.adam_count(tree.optimizer) == 4
    if ramped:
        assert flat.optimizer.param_groups[0]["lr"] == tree.optimizer.param_groups[0]["lr"]
        assert flat.optimizer.param_groups[0]["betas"] == tree.optimizer.param_groups[0]["betas"]


def test_three_flat_steps_track_the_jax_flat_step(monkeypatch):
    """Both packages built under DCASE_FLAT_OPT=1, from one state with
    seeded moments: after each of three steps the losses within 1e-5, the
    student and EMA parameters and the flat moments (the port's read in the
    file's order) within 1e-6."""
    monkeypatch.setenv("DCASE_FLAT_OPT", "1")
    cfg = _cfg(False)
    opt = optax.adam(LR, b1=0.9, b2=0.999, eps=1e-8)
    model, jstate = _jax_state(cfg, 7, opt)
    mu, nu = _moments(jstate.params, 8)
    adam, rest = jsteps.wrap_optimizer(opt).init(jstate.params)
    assert adam.mu.ndim == 1  # the JAX side is flat too
    jstate = jstate._replace(opt_state=(adam._replace(count=jnp.int32(3), mu=jnp.asarray(ravel_pytree(mu)[0]),
                                                      nu=jnp.asarray(ravel_pytree(nu)[0])), rest),
                             step=jnp.int32(3))
    state = _torch_state(cfg, jstate, mu, nu, step=3)
    common = dict(mean_teacher=True, rampup_length=10, max_consistency_cost=2.0, ema_alpha=0.999, noise_std=0.0)
    jstep = jsteps.make_train_step(model, opt, WEAK, STRONG, donate=False, **common)
    tstep = tsteps.make_train_step(WEAK, STRONG, **common)
    jacc, acc = jstep.zero_metrics(), tstep.zero_metrics()
    rng, gen = jax.random.PRNGKey(0), torch.Generator().manual_seed(0)
    for i, batch in enumerate(_feature_batches(3, 11, teacher=True)):
        jstate, jm, jacc = jstep(jstate, _jb(batch), rng, jacc)
        state, tm, acc = tstep(state, _tb(batch), gen, acc)
        assert abs(tm["loss"].item() - float(jm["loss"])) <= 1e-5, i
        mine = dict(tckpt.train_state_leaves(state))
        want = jax_leaves(jstate)
        assert list(mine) == list(want)
        for k, v in want.items():
            if k.startswith((".params", ".ema_params", ".opt_state")):
                np.testing.assert_allclose(mine[k], v, rtol=0, atol=1e-6, err_msg=f"step {i} {k}")


# ------------------------------------------------------ flat checkpoints


@pytest.mark.parametrize("ramped", [False, True], ids=["adam", "ramped_adam"])
def test_flat_checkpoints_cross_both_ways_bit_for_bit(tmp_path, monkeypatch, ramped):
    monkeypatch.setenv("DCASE_FLAT_OPT", "1")
    src = seeded_jax_state(ramped, True, seed=2)
    assert jax_leaves(src)[".opt_state.inner_state[0].mu" if ramped else ".opt_state[0].mu"].ndim == 1
    path = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(path, src, meta())
    state, set_step = port_state(ramped, True)
    state, got_meta = tckpt.restore_checkpoint(path, state, ramped_adam=ramped)
    assert got_meta == as_stored(meta()) and state.step == 7 and tckpt.adam_count(state.optimizer) == 7
    want, mine = jax_leaves(src), dict(tckpt.train_state_leaves(state, ramped))
    assert list(mine) == list(want)
    for k, v in want.items():
        if "hyperparams[" not in k:  # the port reads them from its param groups
            assert mine[k].dtype == v.dtype, k
            np.testing.assert_array_equal(mine[k], v, err_msg=k)
    # and back: the port's file restores into the JAX flat template
    if ramped:
        set_step(6)
    out = str(tmp_path / "port.npz")
    tckpt.save_checkpoint(out, state, meta(), ramped_adam=ramped)
    template = seeded_jax_state(ramped, True, seed=5)
    restored, _ = jckpt.restore_checkpoint(out, template)
    got = jax_leaves(restored)
    for k, v in want.items():
        if "hyperparams[" not in k:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("saved_flat", [True, False], ids=["flat_file", "per_leaf_file"])
def test_a_file_of_the_other_layout_is_refused(tmp_path, monkeypatch, saved_flat):
    monkeypatch.setenv("DCASE_FLAT_OPT", "1" if saved_flat else "0")
    state, _ = port_state(False, True)
    path = str(tmp_path / "state.npz")
    tckpt.save_checkpoint(path, state, meta())
    monkeypatch.setenv("DCASE_FLAT_OPT", "0" if saved_flat else "1")
    other, _ = port_state(False, True)
    with pytest.raises(ValueError, match="optimizer layout") as err:
        tckpt.restore_checkpoint(path, other)
    assert "per-leaf (DCASE_FLAT_OPT unset)" in str(err.value) and "flat (DCASE_FLAT_OPT=1)" in str(err.value)


# ------------------------------------------------------ legacy v1 files


def _v1_file(tmp_path, leaves, metadata, name="ck_v1"):
    """A v1 checkpoint as the JAX package wrote it (its tests' recipe)."""
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        pickle.dump({"version": 1, "leaves": leaves, "metadata": metadata}, f)
    return path


@pytest.mark.parametrize("ramped", [False, True], ids=["adam", "ramped_adam"])
def test_a_v1_checkpoint_restores_only_behind_the_opt_in(tmp_path, monkeypatch, ramped):
    monkeypatch.delenv("DCASE_ALLOW_LEGACY_PICKLE", raising=False)
    src = seeded_jax_state(ramped, True, seed=4)
    leaves = [np.asarray(a) for a in jax.tree.leaves(src)]
    path = _v1_file(tmp_path, leaves, meta())
    fresh = lambda: port_state(ramped, True)[0]  # noqa: E731
    for call in (lambda: tckpt.restore_checkpoint(path, fresh(), ramped_adam=ramped),
                 lambda: tckpt.read_metadata(path), lambda: tckpt.load_inference_state(path)):
        with pytest.raises(ValueError, match="allow_legacy_pickle=True or setting DCASE_ALLOW_LEGACY_PICKLE=1"):
            call()
    want = jax_leaves(src)
    for how in ("argument", "environment"):
        kw = {"allow_legacy_pickle": True} if how == "argument" else {}
        if how == "environment":
            monkeypatch.setenv("DCASE_ALLOW_LEGACY_PICKLE", "1")
        state, got_meta = tckpt.restore_checkpoint(path, fresh(), ramped_adam=ramped, **kw)
        assert got_meta == meta() and tckpt.read_metadata(path, **kw) == meta(), how
        mine = dict(tckpt.train_state_leaves(state, ramped))
        assert list(mine) == list(want)
        for k, v in want.items():
            if "hyperparams[" not in k:
                np.testing.assert_array_equal(mine[k], v, err_msg=f"{how} {k}")
        params, bn_state = tckpt.load_inference_state(path, **kw)
        got = []
        tckpt._flatten(params, ".params", got)
        tckpt._flatten(bn_state, ".bn_state", got)
        assert [k for k, _ in got] == [k for k in want if k.startswith((".params", ".bn_state"))]
        for k, v in got:
            np.testing.assert_array_equal(v, want[k], err_msg=f"{how} {k}")
    # a v1 file of the other optimizer has another leaf count
    with pytest.raises(ValueError, match="configs differ"):
        tckpt.restore_checkpoint(path, port_state(not ramped, True)[0], ramped_adam=not ramped)


def test_the_v1_unpickler_names_foreign_classes_without_importing_them(tmp_path):
    """A v1 file whose metadata pickled a JAX-package object is refused by
    the class's name, in a fresh interpreter that then still has not
    imported the JAX package; so are os.system and a bfloat16 leaf."""
    from dcase2019_task4_tpu.config import ModelConfig as JModel

    src = seeded_jax_state(False, True)
    leaves = [np.asarray(a) for a in jax.tree.leaves(src)]
    foreign = _v1_file(tmp_path, leaves, {"epoch": 1, "model": JModel()}, "foreign")
    code = (
        "import sys\n"
        "from dcase2019_task4_tpu_torch.train import checkpoints as c\n"
        "try:\n"
        f"    c.read_metadata({foreign!r}, allow_legacy_pickle=True)\n"
        "except Exception as e:\n"
        "    print(type(e).__name__, e)\n"
        "print('imported:', any(m.split('.')[0] == 'dcase2019_task4_tpu' for m in sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    assert "dcase2019_task4_tpu.config.ModelConfig" in out.stdout and "imported: False" in out.stdout, out.stdout

    class Boom:
        def __reduce__(self):
            return (os.system, ("echo should-not-run",))

    boom = _v1_file(tmp_path, leaves, {"epoch": Boom()}, "boom")
    with pytest.raises(pickle.UnpicklingError, match="system"):
        tckpt.read_metadata(boom, allow_legacy_pickle=True)
    bf16 = _v1_file(tmp_path, [np.asarray(jnp.zeros(3, jnp.bfloat16))], {"epoch": 1}, "bf16")
    with pytest.raises(pickle.UnpicklingError, match="ml_dtypes"):
        tckpt.read_metadata(bf16, allow_legacy_pickle=True)


# ------------------------------------------------------ the Experiment


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_experiment_trains_saves_and_resumes_under_either_layout(tmp_path, monkeypatch, one_thread):
    """The tiny Mean-Teacher Experiment of tests/test_torch_experiment.py,
    two epochs under each setting: the same metrics bit for bit (the switch
    leaves the step alone), the best checkpoint in the setting's layout,
    resumed for a third epoch under its own setting and refused under the
    other."""
    from dcase2019_task4_tpu_torch.config import Config, DSPConfig, ModelConfig, TrainConfig
    from dcase2019_task4_tpu_torch.train.experiment import Experiment
    from dcase2019_task4_tpu_torch.utils.metrics_writer import read_metrics
    from tests.test_torch_experiment import tiny

    def experiment():
        return Experiment(tiny(Config, DSPConfig, ModelConfig, TrainConfig), mean_teacher=True, subpart_data=12,
                          synthetic_audio=True, seed=0, device="cpu")

    metrics = {}
    for setting in ("0", "1"):
        monkeypatch.setenv("DCASE_FLAT_OPT", setting)
        exp = experiment()
        exp.run(store_dir=str(tmp_path / setting), n_epoch=2)
        metrics[setting] = read_metrics(str(tmp_path / setting / "metrics.jsonl"))
        with np.load(str(tmp_path / setting / "model" / "baseline_best")) as z:
            paths = json.loads(bytes(z["__meta__"]).decode())["leaf_paths"]
        assert (".opt_state[0].mu" in paths) == (setting == "1")
    def numbers(record):  # all but the clock's
        return {k: v for k, v in record.items() if k != "ts" and not k.endswith(("_s", "_share"))}

    assert len(metrics["0"]) == len(metrics["1"]) == 2
    for a, b in zip(metrics["0"], metrics["1"]):
        assert numbers(a) == numbers(b)
    best = str(tmp_path / "1" / "model" / "baseline_best")
    exp = experiment()
    exp.run(store_dir=str(tmp_path / "resumed"), n_epoch=3, resume_from=best)
    start = tckpt.read_metadata(best)["epoch"] + 1
    assert [r["epoch"] for r in read_metrics(str(tmp_path / "resumed" / "metrics.jsonl"))] == list(range(start, 3))
    assert exp.state.step > 0
    monkeypatch.setenv("DCASE_FLAT_OPT", "0")
    with pytest.raises(ValueError, match=r"holds the flat \(DCASE_FLAT_OPT=1\) optimizer layout"):
        experiment().restore(best)
