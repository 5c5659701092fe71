"""Port parity: K2 forward in eval mode (BN running stats → GLU → avg-pool).

The JAX side runs the Pallas kernel in interpret mode
(fused_bn_glu_dropout_pool(..., train=False, interpret=True)); the port's
wrapper gets CPU tensors and runs its plain twin. Running statistics are
non-trivial. Tolerance 1e-5 absolute (float32 GLU sums of C terms and
pooling sums taken in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcase2019_task4_tpu.ops import fused_block as jfb
from dcase2019_task4_tpu_torch.ops import fused_block as tfb

POOL = (2, 4)
EPS = 1e-3


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    C = shape[-1]
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return (
        f(rng.standard_normal(shape)),
        f(1 + 0.1 * rng.standard_normal(C)),      # scale
        f(0.1 * rng.standard_normal(C)),          # bias
        f(0.3 * rng.standard_normal(C)),          # running mean
        f(rng.uniform(0.5, 2.0, C)),              # running var
        f(rng.standard_normal((C, C)) / np.sqrt(C)),  # glu_w [in, out]
        f(0.1 * rng.standard_normal(C)),          # glu_b
    )


@pytest.mark.parametrize("shape", [(2, 96, 64, 16), (2, 48, 16, 16), (2, 24, 4, 16)])
def test_eval_block_matches_jax_interpret(shape):
    y, scale, bias, mean, var, w, b = _inputs(shape, sum(shape))
    ref = np.asarray(jfb.fused_bn_glu_dropout_pool(
        *(jnp.asarray(a) for a in (y, scale, bias, mean, var, w, b)), jnp.int32(0),
        0.0, POOL, EPS, False, True,
    ))
    out = tfb.fused_bn_glu_pool(*(torch.from_numpy(a) for a in (y, scale, bias, mean, var, w, b)),
                                POOL, EPS).numpy()
    assert out.shape == ref.shape == (shape[0], shape[1] // 2, shape[2] // 4, shape[3])
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_reference_block_matches_jax_twin():
    args = _inputs((2, 8, 8, 16), 3)
    ref = np.asarray(jfb.reference_block(*(jnp.asarray(a) for a in args), None, 1.0, POOL, EPS))
    out = tfb.reference_block(*(torch.from_numpy(a) for a in args), POOL, EPS).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape,ok", [
    ((2, 864, 64, 64), True), ((2, 216, 4, 64), True), ((2, 863, 64, 64), False),
    ((2, 864, 66, 64), False), ((2, 864, 128, 64), False), ((2, 864, 64, 256), False),
])
def test_applicable_geometries(shape, ok):
    assert tfb.applicable(shape, POOL) is ok


def test_train_mode_dropout_is_refused():
    """Train-mode dropout is not refused: only a rate outside [0, 1) is, and
    rate 0.5 changes the pooled output."""
    args = [torch.from_numpy(a) for a in _inputs((1, 4, 8, 8), 0)]
    for bad in (1.0, -0.1):
        with pytest.raises(ValueError):
            tfb.fused_bn_glu_pool(*args, POOL, EPS, rate=bad)
    kept = tfb.fused_bn_glu_pool(*args, POOL, EPS, rate=0.5, seed=3)
    full = tfb.fused_bn_glu_pool(*args, POOL, EPS)
    assert kept.shape == full.shape and not torch.equal(kept, full)
