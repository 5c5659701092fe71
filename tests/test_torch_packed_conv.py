"""Port parity: K3 forward (3×3 s1 p1 Cin == Cout conv on NHWC).

The JAX side runs the Pallas kernel in interpret mode
(conv2d_packed(..., interpret=True)); the port's wrapper gets CPU tensors
and runs its plain twin (F.conv2d). Tolerance 1e-5 absolute: float32 sums
of 144 terms of O(1) taken in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcase2019_task4_tpu.ops import packed_conv as jpc
from dcase2019_task4_tpu_torch.ops import packed_conv as tpc


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    C = shape[-1]
    lim = np.sqrt(2.0) * np.sqrt(6.0 / (18 * C))
    w = rng.uniform(-lim, lim, (3, 3, C, C)).astype(np.float32)
    b = (0.1 * rng.standard_normal(C)).astype(np.float32)
    x = rng.standard_normal(shape).astype(np.float32)
    return w, b, x


@pytest.mark.parametrize("shape", [(2, 48, 16, 16), (2, 24, 4, 16)])
def test_conv2d_packed_matches_jax_interpret(shape):
    w, b, x = _inputs(shape, sum(shape))
    ref = np.asarray(jpc.conv2d_packed({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                       jnp.asarray(x), interpret=True))
    out = tpc.conv2d_packed({"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                            torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("freq,channels,ok", [
    (16, 64, True), (4, 64, True), (128, 64, True), (32, 128, True), (256, 64, False), (16, 256, False),
])
def test_applicable_geometries(freq, channels, ok):
    assert tpc.applicable(freq, channels) is ok


def test_conv2d_packed_refuses_bad_weights_and_devices():
    w, b, x = _inputs((1, 8, 4, 8), 0)
    with pytest.raises(ValueError, match=r"w \[3,3,C,C\]"):
        tpc.conv2d_packed({"w": torch.from_numpy(w[:, :, :4]), "b": torch.from_numpy(b)},
                          torch.from_numpy(x))
    with pytest.raises(ValueError, match="cpu or cuda"):
        tpc.conv2d_packed({"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                          torch.from_numpy(x).to("meta"))
