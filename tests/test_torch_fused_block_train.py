"""Port parity: K2 in train mode — forward with dropout, the backward
formulas, the autograd Function, the Philox mask and the batch statistics.

Dropout masks match nothing in JAX (TPU hardware bits compiled, a hash in
the packed layout interpreted), so the forward is held against the JAX
`reference_block` with an injected mask, and the backward against autodiff
of that reference with the batch statistics as functions of y (which is
what BatchNorm in training differentiates) and against the Pallas backward
in interpret mode at rate 0. All inputs come from numpy seeds; CPU tensors
run the port's plain versions. Tolerances: 1e-5 absolute on forwards, 1e-5
of each output's max on gradients (float32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcase2019_task4_tpu.ops import fused_block as jfb
from dcase2019_task4_tpu_torch.ops import fused_block as tfb

POOL = (2, 4)
EPS = 1e-3
SHAPES = [(2, 96, 64, 16), (2, 48, 16, 16), (2, 24, 4, 16)]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    C = shape[-1]
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    y = f(0.3 + 1.5 * rng.standard_normal(shape))
    mean = y.reshape(-1, C).mean(0)
    var = y.reshape(-1, C).var(0)
    return dict(
        y=y, scale=f(1 + 0.1 * rng.standard_normal(C)), bias=f(0.1 * rng.standard_normal(C)),
        mean=f(mean), var=f(var), w=f(rng.standard_normal((C, C)) / np.sqrt(C)),
        b=f(0.1 * rng.standard_normal(C)),
        dout=f(rng.standard_normal((shape[0], shape[1] // 2, shape[2] // 4, C))),
        mask=f(rng.random(shape) < 0.5),
    )


def _t(d, *names):
    return [torch.from_numpy(d[n]) for n in names]


def _j(d, *names):
    return [jnp.asarray(d[n]) for n in names]


def _close(got, want, rel, what=""):
    want = np.asarray(want)
    tol = rel * max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol, err_msg=what)


ARGS = ("y", "scale", "bias", "mean", "var", "w", "b")


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_with_injected_mask_matches_jax_reference(shape):
    d = _inputs(shape, sum(shape))
    ref = jfb.reference_block(*_j(d, *ARGS), jnp.asarray(d["mask"]), 0.5, POOL, EPS)
    out = tfb.reference_block(*_t(d, *ARGS), POOL, EPS, torch.from_numpy(d["mask"]), 0.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def _jax_autodiff(d, mask, keep):
    """Gradients of Σ(block · dout) with the batch statistics in the graph."""
    C = d["y"].shape[-1]

    def f(y, scale, bias, w, b):
        flat = y.reshape(-1, C)
        mean = flat.mean(0)
        var = (flat * flat).mean(0) - mean * mean
        out = jfb.reference_block(y, scale, bias, mean, var, w, b, mask, keep, POOL, EPS)
        return jnp.sum(out * jnp.asarray(d["dout"]))

    return jax.grad(f, argnums=(0, 1, 2, 3, 4))(*_j(d, "y", "scale", "bias", "w", "b"))


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_reference_matches_jax_autodiff(shape, rate):
    d = _inputs(shape, sum(shape) + 1)
    mask = None if rate == 0.0 else d["mask"]
    want = _jax_autodiff(d, None if mask is None else jnp.asarray(mask), 1.0 - rate)
    got = tfb.bwd_reference(*_t(d, "y", "dout", "scale", "bias", "mean", "var", "w", "b"), POOL, EPS,
                            None if mask is None else torch.from_numpy(mask), 1.0 - rate)
    for name, g, w in zip(("dy", "dscale", "dbias", "dw", "db"), got, want):
        _close(g.numpy(), w, 1e-5, name)


@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_reference_matches_pallas_backward_interpreted(shape):
    d = _inputs(shape, sum(shape) + 2)
    want = jfb._bwd_pallas(*_j(d, "y", "dout", "scale", "bias", "mean", "var", "w", "b"), jnp.int32(0),
                           0.0, POOL, EPS, True, interpret=True)
    got = tfb.bwd_reference(*_t(d, "y", "dout", "scale", "bias", "mean", "var", "w", "b"), POOL, EPS)
    for name, g, w in zip(("dy", "dscale", "dbias", "dw", "db"), got, want):
        _close(g.numpy(), w, 1e-5, name)


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("shape", SHAPES)
def test_function_gradients_match_autograd_of_plain_forward(shape, rate):
    """The autograd.Function (detached statistics, formulas in its backward)
    against torch.autograd through the plain forward with the statistics in
    the graph; at rate 0.5 both use the Philox mask of one seed."""
    d = _inputs(shape, sum(shape) + 3)
    seed, C = 1234, shape[-1]
    dout = torch.from_numpy(d["dout"])
    leaves = [t.requires_grad_(True) for t in _t(d, "y", "scale", "bias", "w", "b")]
    y, scale, bias, w, b = leaves
    flat = y.reshape(-1, C)
    mean = flat.mean(0)
    var = (flat * flat).mean(0) - mean * mean
    mask = tfb.dropout_keep_mask(seed, shape, rate) if rate else None
    (tfb.reference_block(y, scale, bias, mean, var, w, b, POOL, EPS, mask, 1.0 - rate) * dout).sum().backward()
    want = [t.grad.clone() for t in leaves]
    for t in leaves:
        t.grad = None
    out = tfb.fused_bn_glu_dropout_pool(y, scale, bias, mean.detach(), var.detach(), w, b, seed, rate, POOL, EPS, True)
    (out * dout).sum().backward()
    for name, t, g in zip(("dy", "dscale", "dbias", "dw", "db"), leaves, want):
        _close(t.grad.numpy(), g.numpy(), 1e-5, name)


def test_function_refuses_statistics_with_a_graph():
    d = _inputs((1, 4, 8, 8), 0)
    y, scale, bias, mean, var, w, b = _t(d, *ARGS)
    with pytest.raises(ValueError, match="detached"):
        tfb.fused_bn_glu_dropout_pool(y, scale, bias, mean.requires_grad_(True), var, w, b, 0, 0.0, POOL, EPS, True)


def test_eval_mode_ignores_the_rate():
    d = _inputs((1, 4, 8, 8), 1)
    args = _t(d, *ARGS)
    out = tfb.fused_bn_glu_dropout_pool(*args, 7, 0.5, POOL, EPS, False)
    assert torch.equal(out, tfb.fused_bn_glu_pool(*args, POOL, EPS))


def test_dropout_keep_mask_is_deterministic_and_tiling_free():
    a = tfb.dropout_keep_mask(99, (2, 6, 8, 16), 0.5)
    assert torch.equal(a, tfb.dropout_keep_mask(torch.tensor([99]), (2, 6, 8, 16), 0.5))
    assert not torch.equal(a, tfb.dropout_keep_mask(100, (2, 6, 8, 16), 0.5))
    # the mask is a function of (seed, flat element index) alone: any other
    # shape of the same elements, and any prefix of them, gives the same bits
    assert torch.equal(a.reshape(-1), tfb.dropout_keep_mask(99, (12, 128), 0.5).reshape(-1))
    assert torch.equal(a.reshape(-1)[:777], tfb.dropout_keep_mask(99, (777,), 0.5))
    assert set(a.unique().tolist()) == {0.0, 1.0}


@pytest.mark.parametrize("rate", [0.5, 0.25])
def test_dropout_keep_share(rate):
    mask = tfb.dropout_keep_mask(2019, (1_000_000,), rate)
    assert abs(mask.mean().item() - (1.0 - rate)) <= 0.01


def test_philox_known_answers():
    """Philox4x32-10 against the Random123 distribution's test vector for a
    zero counter and key, and the 64-bit counter and key splits."""
    zero = tfb.philox4x32(torch.zeros(1, dtype=torch.int64), 0)[0].tolist()
    assert zero == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    # counter (c, c >> 32, 0, 0) with c = 2**32 + 5 and key (7, 9): words differ per lane and stay 32-bit
    out = tfb.philox4x32(torch.tensor([2 ** 32 + 5, 2 ** 32 + 6]), 7 + (9 << 32))
    assert out.shape == (2, 4) and int(out.min()) >= 0 and int(out.max()) < 2 ** 32
    assert not torch.equal(out[0], out[1])


@pytest.mark.parametrize("shape", SHAPES)
def test_batch_stats_match_jax_interpret(shape):
    y = _inputs(shape, sum(shape) + 4)["y"]
    mean_ref, var_ref = jfb.batch_stats(jnp.asarray(y), pool_f=POOL[1], interpret=True)
    s, sq = tfb.batch_stats(torch.from_numpy(y))
    assert not s.requires_grad and not sq.requires_grad
    n = y.size // shape[-1]
    mean = s / n
    var = sq / n - mean * mean
    _close(mean.numpy(), mean_ref, 1e-5)
    _close(var.numpy(), var_ref, 1e-5)


def test_batch_stats_carry_no_graph():
    y = torch.from_numpy(_inputs((1, 4, 8, 8), 5)["y"]).requires_grad_(True)
    s, sq = tfb.batch_stats(y * 2.0)
    assert not s.requires_grad and not sq.requires_grad
