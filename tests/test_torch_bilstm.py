"""Port parity: `ops/gru.BiLSTM` against the JAX package's bilstm_apply.

The JAX BiLSTM (dcase2019_task4_tpu/ops/gru.py:160-240) is a plain
`lax.scan` with torch's cell math and weight layout, so the port's BiLSTM
is `nn.LSTM(bidirectional=True, batch_first=True)` and `ops/gru.state_from_jax`
carries the JAX pytree onto it (`bilstm_from_jax` below). Held: the output of every carried model
against `bilstm_apply` on the same seeded input, rtol 1e-3 and atol 5e-5
(the bar of tests/test_surface_parity.py:42, the JAX BiLSTM against
`nn.LSTM`), at one and two layers and two widths; the carried model has the
JAX layout's input size, hidden size and layer count, and its weights are
the JAX leaves bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcase2019_task4_tpu.ops.gru import bilstm_apply, bilstm_init
from dcase2019_task4_tpu_torch.ops.gru import BiLSTM, state_from_jax

def bilstm_from_jax(params):
    """The JAX BiLSTM pytree (a list over layers of {"fwd": {w_ih, w_hh,
    b_ih, b_hh}, "bwd": {...}}) → a BiLSTM of its input size, hidden size
    and layer count holding those weights."""
    first = params[0]["fwd"]
    model = BiLSTM(np.shape(first["w_ih"])[1], np.shape(first["w_hh"])[1], len(params))
    model.lstm.load_state_dict(state_from_jax(params))
    return model


CASES = [(2, 11, 32, 16, 2), (3, 7, 24, 8, 1), (1, 20, 16, 32, 2)]  # B, T, in, H, layers


@pytest.mark.parametrize("B, T, IN, H, layers", CASES)
def test_bilstm_matches_bilstm_apply(B, T, IN, H, layers):
    params = bilstm_init(jax.random.PRNGKey(0), IN, H, layers)
    x = np.random.default_rng(0).standard_normal((B, T, IN)).astype(np.float32)
    want = np.asarray(jax.jit(bilstm_apply)(params, jnp.asarray(x)))
    model = bilstm_from_jax(params).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (B, T, 2 * H)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=5e-5)


@pytest.mark.parametrize("B, T, IN, H, layers", CASES)
def test_carried_model_has_the_jax_layout(B, T, IN, H, layers):
    params = bilstm_init(jax.random.PRNGKey(1), IN, H, layers)
    model = bilstm_from_jax(params)
    assert isinstance(model, BiLSTM)
    lstm = model.lstm
    assert (lstm.input_size, lstm.hidden_size, lstm.num_layers) == (IN, H, layers)
    assert lstm.bidirectional and lstm.batch_first
    for layer, p in enumerate(params):
        for d, suf in (("fwd", ""), ("bwd", "_reverse")):
            for jk, tk in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"), ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
                np.testing.assert_array_equal(getattr(lstm, f"{tk}_l{layer}{suf}").detach().numpy(),
                                              np.asarray(p[d][jk]))
