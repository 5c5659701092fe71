"""Port parity: K4, the entry conv with its statistics and weight gradient.

The same numpy-seeded inputs go through the JAX package's
`entry_conv_apply` (Pallas kernels in interpret mode, as
tests/test_entry_conv.py runs them, at its shape B, T, F, C = 2, 32, 64, 64)
and through the port's, which on CPU tensors runs its plain versions.
Tolerances: forward 1e-5; Σy, Σy² rtol 1e-5 atol 1e-4; dW and db through
`jax.grad` against the port's autograd 1e-4 (float32 sums in another
order). The CRNN under `entry_conv_pallas` is held to the JAX CRNN with the
same flag (eval 2e-5, train mode at dropout 0 3e-5, BatchNorm buffers 1e-5)
and to the port without the flag.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcase2019_task4_tpu.config import ModelConfig
from dcase2019_task4_tpu.models import crnn as jcrnn
from dcase2019_task4_tpu.ops import entry_conv as jec
from dcase2019_task4_tpu_torch.models import crnn as tcrnn
from dcase2019_task4_tpu_torch.ops import entry_conv as tec
from dcase2019_task4_tpu_torch.ops import fused_block as tfb
from dcase2019_task4_tpu_torch.train.checkpoints import params_from_jax, params_to_jax

B, T, F, C = 2, 32, 64, 64


def _inputs(seed=0, shape=(B, T, F), channels=C):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.standard_normal(shape + (1,)).astype(np.float32),
        w=(rng.standard_normal((3, 3, 1, channels)) * 0.2).astype(np.float32),
        b=(rng.standard_normal(channels) * 0.1).astype(np.float32),
        ct=rng.standard_normal(shape + (channels,)).astype(np.float32),
    )


def _tparams(d, grad=False):
    return {k: torch.from_numpy(d[k]).requires_grad_(grad) for k in ("w", "b")}


def _jparams(d):
    return {k: jnp.asarray(d[k]) for k in ("w", "b")}


def test_packable_gate():
    """The Hopper gate: whole frequency rows in a 128-pixel tile and channels
    in groups of four; the TPU's k = 2 packing and 8-row halo do not bind."""
    assert tec.entry_conv_packable(64, 64, 864) and jec.entry_conv_packable(64, 64, 864)
    assert tec.entry_conv_packable(64, 128, 864) and not jec.entry_conv_packable(64, 128, 864)
    assert tec.entry_conv_packable(63, 64, 864) and tec.entry_conv_packable(64, 64, 108)
    assert not tec.entry_conv_packable(256, 64, 864)  # a frequency row exceeds the tile
    assert not tec.entry_conv_packable(64, 6, 864)  # channels not in fours
    assert not tec.entry_conv_packable(64, 256, 864)


def test_forward_matches_jax_interpret():
    d = _inputs()
    want = jec.entry_conv_apply(_jparams(d), jnp.asarray(d["x"]), interpret=True)
    got = tec.entry_conv_apply(_tparams(d), torch.from_numpy(d["x"]))
    assert got.shape == (B, T, F, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_stats_match_jax_interpret_and_batch_stats():
    d = _inputs(1)
    _, s1_ref, s2_ref = jec.entry_conv_apply(_jparams(d), jnp.asarray(d["x"]), interpret=True, want_stats=True)
    y, s1, s2 = tec.entry_conv_apply(_tparams(d, grad=True), torch.from_numpy(d["x"]), want_stats=True)
    assert y.requires_grad and not s1.requires_grad and not s2.requires_grad
    np.testing.assert_allclose(s1.numpy(), np.asarray(s1_ref), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(s2.numpy(), np.asarray(s2_ref), rtol=1e-5, atol=1e-4)
    s, sq = tfb.batch_stats(y.detach())
    np.testing.assert_allclose(s1.numpy(), s.numpy(), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(s2.numpy(), sq.numpy(), rtol=1e-6, atol=1e-5)
    only = tec.entry_conv_stats(_tparams(d), torch.from_numpy(d["x"]))
    assert torch.equal(only[0], s1) and torch.equal(only[1], s2)


def test_gradients_match_jax_grad():
    d = _inputs(2)
    ct = jnp.asarray(d["ct"])
    want = jax.grad(lambda p: jnp.sum(jec.entry_conv_apply(p, jnp.asarray(d["x"]), interpret=True) * ct))(_jparams(d))
    params = _tparams(d, grad=True)
    x = torch.from_numpy(d["x"]).requires_grad_(True)
    (tec.entry_conv_apply(params, x) * torch.from_numpy(d["ct"])).sum().backward()
    assert x.grad is None  # the features carry no gradient
    np.testing.assert_allclose(params["w"].grad.numpy(), np.asarray(want["w"]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(params["b"].grad.numpy(), np.asarray(want["b"]), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape,channels", [((2, 32, 64), 64), ((3, 7, 5), 8), ((1, 9, 128), 16)])
def test_wgrad_reference_matches_autograd_of_conv2d(shape, channels):
    """The written-out nine-tap sums against autograd through F.conv2d, at
    odd sizes too (edges: the zero padding on both axes)."""
    d = _inputs(3, shape, channels)
    params = _tparams(d, grad=True)
    y, _, _ = tec.entry_conv_reference(params, torch.from_numpy(d["x"]))
    (y * torch.from_numpy(d["ct"])).sum().backward()
    dw, db = tec.entry_conv_wgrad_reference(torch.from_numpy(d["x"]), torch.from_numpy(d["ct"]))
    assert dw.shape == (3, 3, 1, channels)
    for got, want in ((dw, params["w"].grad), (db, params["b"].grad)):
        assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_ablation_modes_plain_versions():
    d = _inputs(4, (1, 6, 8), 8)
    p, x = _tparams(d), torch.from_numpy(d["x"])
    no_patch = tec.entry_conv_ablation(p, x, "no_patch")
    assert torch.allclose(no_patch, x * p["w"][1, 1, 0] + p["b"])
    assert torch.equal(tec.entry_conv_ablation(p, x, "write_only"), p["b"].expand(1, 6, 8, 8))
    with pytest.raises(ValueError, match="ablation"):
        tec.entry_conv_ablation(p, x, "full")


def test_other_dtypes_and_shapes_are_refused():
    """float32 and bfloat16 are the compute dtypes (bfloat16 gives y in
    bfloat16); any other dtype and a features tensor of more than one
    channel are refused."""
    d = _inputs(5, (1, 6, 8), 8)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tec.entry_conv_apply(_tparams(d), torch.from_numpy(d["x"]), compute_dtype=torch.float16)
    assert tec.entry_conv_apply(_tparams(d), torch.from_numpy(d["x"]), compute_dtype="bfloat16").dtype == torch.bfloat16
    with pytest.raises(ValueError, match="one-channel"):
        tec.entry_conv_apply(_tparams(d), torch.zeros(1, 6, 8, 2))
    assert tec.entry_conv_apply(_tparams(d), torch.from_numpy(d["x"]), compute_dtype=torch.float32).shape == (1, 6, 8, 8)


# ------------------------------------------------------------- the CRNN

TM = 96


def _cfg(**kw) -> ModelConfig:
    return ModelConfig(fused_block=True, fused_interpret=True, **kw)


def _jax_weights(cfg, seed):
    params, state = jcrnn.CRNN(cfg).init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    state = {"cnn": [{"mean": jnp.asarray(0.2 * rng.standard_normal(s["mean"].shape), jnp.float32),
                      "var": jnp.asarray(rng.uniform(0.5, 2.0, s["var"].shape), jnp.float32)}
                     for s in state["cnn"]]}
    return params, state


def _port(cfg, params, state):
    model = tcrnn.CRNN(cfg)
    model.load_state_dict(params_from_jax(params, state))
    return model


def test_crnn_eval_matches_jax_with_the_flag():
    cfg = _cfg(entry_conv_pallas=True)
    params, state = _jax_weights(cfg, 1)
    x = np.random.default_rng(1).standard_normal((2, TM, 64)).astype(np.float32)
    s_ref, w_ref, _ = jcrnn.CRNN(cfg).apply(params, state, jnp.asarray(x), train=False)
    strong, weak = _port(cfg, params, state).eval()(torch.from_numpy(x))
    np.testing.assert_allclose(strong.numpy(), np.asarray(s_ref), rtol=0, atol=2e-5)
    np.testing.assert_allclose(weak.numpy(), np.asarray(w_ref), rtol=0, atol=2e-5)


def test_crnn_train_mode_matches_jax_with_the_flag():
    cfg = _cfg(entry_conv_pallas=True, dropout=0.0)
    params, state = _jax_weights(cfg, 2)
    x = np.random.default_rng(2).standard_normal((2, TM, 64)).astype(np.float32) * 2.0 + 0.5
    s_ref, w_ref, bn_ref = jcrnn.CRNN(cfg).apply(params, state, jnp.asarray(x), train=True,
                                                 rng=jax.random.PRNGKey(0))
    net = _port(cfg, params, state).train()
    strong, weak = net(torch.from_numpy(x), torch.Generator().manual_seed(0))
    np.testing.assert_allclose(strong.detach().numpy(), np.asarray(s_ref), rtol=0, atol=3e-5)
    np.testing.assert_allclose(weak.detach().numpy(), np.asarray(w_ref), rtol=0, atol=3e-5)
    _, bn = params_to_jax(net)
    for got, want in zip(jax.tree.leaves(bn), jax.tree.leaves(bn_ref)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=1e-5)


def test_crnn_with_the_flag_equals_the_port_without_it():
    """Dropout 0.5 and one generator seed: the same seeds are drawn at the
    same places, so outputs, BatchNorm buffers and every gradient agree; the
    statistics come from K4f's sums, so block 1 asks for no batch_stats."""
    cfg = dataclasses.replace(_cfg(entry_conv_pallas=True), nb_filters=(16, 16, 16), n_rnn_cell=16)
    base = tcrnn.init_(tcrnn.CRNN(cfg), torch.Generator().manual_seed(3))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, TM, 64)).astype(np.float32))
    results = []
    for flag in (True, False):
        net = tcrnn.CRNN(dataclasses.replace(cfg, entry_conv_pallas=flag)).train()
        net.load_state_dict(base.state_dict())
        calls = []
        real = tfb.batch_stats
        tfb.batch_stats = lambda y: (calls.append(tuple(y.shape)), real(y))[1]
        try:
            strong, weak = net(x, torch.Generator().manual_seed(7))
        finally:
            tfb.batch_stats = real
        (strong.sum() + weak.sum()).backward()
        results.append((strong.detach(), weak.detach(), [p.grad.clone() for p in net.parameters()],
                        [b.clone() for b in net.buffers()], calls))
    (s1, w1, g1, b1, calls1), (s0, w0, g0, b0, calls0) = results
    assert len(calls0) == 3 and len(calls1) == 2 and calls0[1:] == calls1
    assert torch.allclose(s1, s0, atol=1e-6) and torch.allclose(w1, w0, atol=1e-6)
    for a, b in zip(b1, b0):
        assert torch.allclose(a, b, atol=1e-6)
    top = max(g.abs().max().item() for g in g0)
    for a, b in zip(g1, g0):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item() + 1e-6 * top
