"""Port parity: K3's gradients (input gradient, weight gradient, bias
gradient) against `jax.vjp` of the Pallas conv in interpret mode and of the
plain XLA conv (`layers.conv2d_apply`). CPU tensors run the port's plain
versions (`conv2d_dx_reference`, `conv2d_wgrad_reference`), which are also
held against torch.autograd of `F.conv2d`. Tolerance 1e-5 of each
gradient's max (float32 sums of up to 9·C·T·F terms in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcase2019_task4_tpu.models import layers as jlayers
from dcase2019_task4_tpu.ops import packed_conv as jpc
from dcase2019_task4_tpu_torch.ops import packed_conv as tpc

SHAPES = [(2, 48, 16, 16), (2, 24, 4, 16)]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    C = shape[-1]
    lim = np.sqrt(2.0) * np.sqrt(6.0 / (18 * C))
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return (f(rng.uniform(-lim, lim, (3, 3, C, C))), f(0.1 * rng.standard_normal(C)),
            f(rng.standard_normal(shape)), f(rng.standard_normal(shape)))


def _torch_grads(w, b, x, dy):
    wt, bt, xt = (torch.from_numpy(a).requires_grad_(True) for a in (w, b, x))
    tpc.conv2d_packed({"w": wt, "b": bt}, xt).backward(torch.from_numpy(dy))
    return xt.grad.numpy(), wt.grad.numpy(), bt.grad.numpy()


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("reference", ["pallas_interpret", "xla_conv"])
@pytest.mark.parametrize("shape", SHAPES)
def test_gradients_match_jax_vjp(shape, reference):
    w, b, x, dy = _inputs(shape, sum(shape))
    if reference == "pallas_interpret":
        fn = lambda w_, b_, x_: jpc.conv2d_packed({"w": w_, "b": b_}, x_, interpret=True)  # noqa: E731
    else:
        fn = lambda w_, b_, x_: jlayers.conv2d_apply({"w": w_, "b": b_}, x_)  # noqa: E731
    _, vjp = jax.vjp(fn, jnp.asarray(w), jnp.asarray(b), jnp.asarray(x))
    dw_ref, db_ref, dx_ref = vjp(jnp.asarray(dy))
    dx, dw, db = _torch_grads(w, b, x, dy)
    _close(dx, dx_ref, "dx")
    _close(dw, dw_ref, "dw")
    _close(db, db_ref, "db")


@pytest.mark.parametrize("shape", SHAPES + [(1, 5, 3, 8)])
def test_plain_versions_match_autograd_of_conv2d(shape):
    w, b, x, dy = _inputs(shape, sum(shape) + 1)
    wt, bt, xt = (torch.from_numpy(a).requires_grad_(True) for a in (w, b, x))
    tpc.conv2d_reference({"w": wt, "b": bt}, xt).backward(torch.from_numpy(dy))
    dx, dw, db = _torch_grads(w, b, x, dy)
    _close(dx, xt.grad.numpy(), "dx")
    _close(dw, wt.grad.numpy(), "dw")
    _close(db, bt.grad.numpy(), "db")


def test_forward_wrapper_carries_no_graph_and_function_does():
    w, b, x, _ = _inputs((1, 8, 4, 8), 2)
    wt = torch.from_numpy(w).requires_grad_(True)
    params = {"w": wt, "b": torch.from_numpy(b)}
    assert tpc.conv2d_packed(params, torch.from_numpy(x)).requires_grad
    # an input that needs no gradient gets none
    xt = torch.from_numpy(x)
    tpc.conv2d_packed(params, xt).sum().backward()
    assert xt.grad is None and wt.grad is not None


def test_wgrad_refuses_mismatched_shapes():
    with pytest.raises(ValueError, match="one \\[B,T,F,C\\] shape"):
        tpc.conv2d_wgrad(torch.zeros(1, 8, 4, 8), torch.zeros(1, 8, 4, 4))
