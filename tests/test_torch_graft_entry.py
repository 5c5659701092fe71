"""Port parity: graft_entry_torch.py's entry points on the CPU.

- `entry(device="cpu")` against __graft_entry__.py's `entry()`: the same
  inputs (seeded normal audio × 0.1, batch 4, every frame valid) and the
  JAX package's weights carried onto the port's model by
  `checkpoints.params_from_jax`; strong and weak within 2e-5 in eval mode
  (the CRNN bar of RESULTS.md:346-370). The port's own weights are
  `seeded_init_(model, 0)`, its model in eval mode, its outputs finite and
  of the flagship's shapes.
- `dryrun_multichip(2)`: two Gloo ranks, one Mean-Teacher step each at the
  tiny shapes of __graft_entry__.py's dry run, from its global batch (drawn
  as it draws it); a finite loss, equal on both ranks, is returned and
  printed. Its default device is the card, which raises without one.
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__
import graft_entry_torch
from dcase2019_task4_tpu_torch.train.checkpoints import params_from_jax

TOL = 2e-5


@pytest.fixture(scope="module")
def entries():
    jforward, jargs = __graft_entry__.entry()
    jstrong, jweak = jax.jit(jforward)(*jargs)
    forward, args = graft_entry_torch.entry(device="cpu")
    return {"jax": (np.asarray(jstrong), np.asarray(jweak)), "jargs": jargs, "forward": forward, "args": args}


def test_the_inputs_are_the_jax_entrys(entries):
    _, _, jpadded, jframes = entries["jargs"]
    model, frontend, padded, frames = entries["args"]
    np.testing.assert_array_equal(padded.numpy(), np.asarray(jpadded))
    np.testing.assert_array_equal(frames.numpy(), np.asarray(jframes))
    assert not model.training and padded.shape == (graft_entry_torch.BATCH, padded.shape[1])


def test_the_seeded_forward_is_finite(entries):
    strong, weak = entries["forward"](*entries["args"])
    assert strong.shape == entries["jax"][0].shape and weak.shape == entries["jax"][1].shape
    assert torch.isfinite(strong).all() and torch.isfinite(weak).all()


def test_entry_with_the_jax_weights_matches_the_jax_entry(entries):
    params, bn_state, _, _ = entries["jargs"]
    model, frontend, padded, frames = entries["args"]
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, bn_state)))
    strong, weak = entries["forward"](model.eval(), frontend, padded, frames)
    jstrong, jweak = entries["jax"]
    np.testing.assert_allclose(strong.numpy(), jstrong, rtol=0, atol=TOL)
    np.testing.assert_allclose(weak.numpy(), jweak, rtol=0, atol=TOL)


def test_dryrun_multichip_on_two_gloo_ranks(capsys):
    loss = graft_entry_torch.dryrun_multichip(2, device="cpu")
    assert np.isfinite(loss)
    assert f"dryrun_multichip(2): OK, loss={loss:.4f}" in capsys.readouterr().out


def test_dryrun_multichip_defaults_to_the_card(monkeypatch):
    """With no card the default device raises before any rank starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        graft_entry_torch.dryrun_multichip(2)


def test_dryrun_batch_is_the_jax_dryruns():
    """The global batch as __graft_entry__.py draws it (rng 0: audio, then
    targets), per-rank layout [2 | 4 | 2]."""
    b = graft_entry_torch.dryrun_batch(2)
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal(b["audio"].shape) * 0.1).astype(np.float32)
    target = rng.integers(0, 2, b["target"].shape).astype(np.float32)
    np.testing.assert_array_equal(b["audio"], audio)
    np.testing.assert_array_equal(b["target"], target)
    assert b["audio"].shape[0] == 16 and b["target"].shape[1:] == (12, 10)
    assert (graft_entry_torch.WEAK, graft_entry_torch.STRONG) == (slice(0, 2), slice(6, 8))
