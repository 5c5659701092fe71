"""Port parity: the CRNN eval forward and the weight bridge.

Dryrun geometry (T = 96 frames, 16 filters, 16 GRU cells, B = 2). The JAX
side is CRNN.apply(train=False), with the fused Pallas kernels in
interpret mode or on its plain XLA path; the port's CRNN gets the same
weights through params_from_jax (or hands its own seeded weights to JAX
through params_to_jax) and runs on CPU tensors, where each kernel wrapper
runs its plain twin. Tolerance 2e-5 on strong and weak.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcase2019_task4_tpu.config import ModelConfig
from dcase2019_task4_tpu.models import crnn as jcrnn
from dcase2019_task4_tpu_torch.models import crnn as tcrnn
from dcase2019_task4_tpu_torch.train.checkpoints import params_from_jax, params_to_jax

T, F = 96, 64


def _cfg(fused: bool) -> ModelConfig:
    return ModelConfig(nb_filters=(16, 16, 16), n_rnn_cell=16, fused_block=fused,
                       fused_interpret=fused)


def _jax_weights(cfg, seed):
    params, state = jcrnn.CRNN(cfg).init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    # non-trivial running statistics
    state = {"cnn": [{"mean": jnp.asarray(0.2 * rng.standard_normal(s["mean"].shape), jnp.float32),
                      "var": jnp.asarray(rng.uniform(0.5, 2.0, s["var"].shape), jnp.float32)}
                     for s in state["cnn"]]}
    return params, state


def _x(seed, B=2):
    return np.random.default_rng(seed).standard_normal((B, T, F)).astype(np.float32)


def _leaves_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for u, v in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


def test_params_round_trip_every_leaf():
    cfg = _cfg(True)
    params, state = _jax_weights(cfg, 0)
    model = tcrnn.CRNN(cfg)
    model.load_state_dict(params_from_jax(params, state))
    assert tcrnn.count_params(model) == jcrnn.count_params(params)
    p2, s2 = params_to_jax(model)
    assert jax.tree.structure(p2) == jax.tree.structure(jax.tree.map(np.asarray, params))
    _leaves_equal(p2, params)
    _leaves_equal(s2, state)


@pytest.mark.parametrize("fused", [True, False])
def test_eval_forward_matches_jax_from_jax_weights(fused):
    cfg = _cfg(fused)
    params, state = _jax_weights(cfg, 1)
    x = _x(1)
    s_ref, w_ref, _ = jcrnn.CRNN(cfg).apply(params, state, jnp.asarray(x), train=False)
    model = tcrnn.CRNN(cfg).eval()
    model.load_state_dict(params_from_jax(params, state))
    strong, weak = model(torch.from_numpy(x))
    assert strong.shape == (2, T // 8, 10) and weak.shape == (2, 10)
    np.testing.assert_allclose(strong.numpy(), np.asarray(s_ref), rtol=0, atol=2e-5)
    np.testing.assert_allclose(weak.numpy(), np.asarray(w_ref), rtol=0, atol=2e-5)


@pytest.mark.parametrize("fused", [True, False])
def test_eval_forward_matches_jax_from_seeded_port_weights(fused):
    """Larger weights than the JAX init (N(0, 1/in) linear layers), so the
    heads are far from their 0.5 resting point."""
    cfg = _cfg(fused)
    model = tcrnn.seeded_init_(tcrnn.CRNN(cfg), 2).eval()
    params, state = params_to_jax(model)
    x = _x(2, B=3)
    s_ref, w_ref, _ = jcrnn.CRNN(cfg).apply(params, state, jnp.asarray(x), train=False)
    strong, weak = model(torch.from_numpy(x))
    assert np.ptp(np.asarray(s_ref)) > 0.1
    np.testing.assert_allclose(strong.numpy(), np.asarray(s_ref), rtol=0, atol=2e-5)
    np.testing.assert_allclose(weak.numpy(), np.asarray(w_ref), rtol=0, atol=2e-5)


def test_training_mode_is_refused():
    model = tcrnn.CRNN(_cfg(True))
    with pytest.raises(RuntimeError, match="eval mode"):
        model(torch.zeros(1, T, F))
