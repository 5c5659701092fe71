"""Port: the packed 8-bit dropout draw (DCASE_DROPOUT_PACK).

The JAX package's packed draw takes 8 hardware random bits per element and
keeps an element iff its byte is ≥ t8 = min(round(rate·256), 255), scaling
the kept by 1/(1 − rate) (fused_block.py:146,169-177). Its interpret mode
ignores the knob, so no JAX mask can be matched: the semantics are held
instead. The port's draw: element e keeps iff byte e % 4 of word
(e // 4) % 4 of Philox4x32-10(e // 16, seed) is ≥ t8.

  * the threshold at rates 0.5, 0.3 and 0.999 (128, 77, 255);
  * the plain mask is that byte rule, deterministic, and depends on the
    element index alone (a prefix of a longer mask, any shape);
  * the keep share within 5σ of 1 − t8/256, and the four byte planes (and
    the four word planes) pairwise decorrelated (|r| < 0.02, as the JAX
    package's own TPU check of its planes);
  * K2's forward and backward with the packed mask against the JAX
    package's `reference_block` and its autodiff with the same mask
    injected (1e-5, as tests/test_torch_fused_block_train.py);
  * the fused entry block's packed mask equals that of conv → K2, and the
    crows entry gives the entry block's bits;
  * the autograd Functions record the draw at their forward;
  * one subprocess test: a fresh interpreter reads each of the three knobs
    of this slice into the port's module constant as the JAX package reads
    its own, with the variable set and unset.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcase2019_task4_tpu.ops import fused_block as jfb
from dcase2019_task4_tpu_torch.ops import crows_block as tcr
from dcase2019_task4_tpu_torch.ops import entry_conv as tec
from dcase2019_task4_tpu_torch.ops import fused_block as tfb
from dcase2019_task4_tpu_torch.ops import fused_entry_block as tfe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POOL = (2, 4)
EPS = 1e-3


@pytest.mark.parametrize("rate,t8", [(0.5, 128), (0.3, 77), (0.999, 255), (0.001, 0)])
def test_packed_threshold(rate, t8):
    assert tfb.dropout_threshold(rate, pack_bits=True) == t8
    assert tfb.dropout_args(rate, True) == (t8, pytest.approx(1.0 / (1.0 - rate)), 1)


def test_packed_mask_is_the_byte_rule():
    seed, n = 20190415, 16 * 37 + 5
    words = tfb.philox4x32(torch.arange(-(-n // 16), dtype=torch.int64), seed).numpy()  # [calls, 4]
    e = np.arange(n)
    byte = (words[e // 16, (e // 4) % 4] >> (8 * (e % 4))) & 0xFF
    for rate in (0.5, 0.3):
        want = (byte >= tfb.dropout_threshold(rate, True)).astype(np.float32)
        got = tfb.dropout_keep_mask(seed, (n,), rate, pack_bits=True).numpy()
        np.testing.assert_array_equal(got, want)


def test_packed_mask_is_deterministic_and_tiling_free():
    seed = torch.tensor([987654321])
    shape = (2, 6, 8, 16)
    a = tfb.dropout_keep_mask(seed, shape, 0.5, pack_bits=True)
    assert torch.equal(a, tfb.dropout_keep_mask(seed, shape, 0.5, pack_bits=True))
    n = a.numel()
    longer = tfb.dropout_keep_mask(seed, (n + 37,), 0.5, pack_bits=True)
    assert torch.equal(a.reshape(-1), longer[:n])  # a prefix: the element index decides alone
    assert torch.equal(a.reshape(-1, 16), tfb.dropout_keep_mask(seed, (n // 16, 16), 0.5, pack_bits=True))
    other = tfb.dropout_keep_mask(seed + 1, shape, 0.5, pack_bits=True)
    assert not torch.equal(a, other)
    assert not torch.equal(a, tfb.dropout_keep_mask(seed, shape, 0.5, pack_bits=False))  # another draw


@pytest.mark.parametrize("rate", [0.5, 0.3, 0.1])
def test_packed_keep_share_and_plane_independence(rate):
    n = 1 << 20
    m = tfb.dropout_keep_mask(77, (n,), rate, pack_bits=True).numpy()
    assert set(np.unique(m)) <= {0.0, 1.0}
    p = 1.0 - tfb.dropout_threshold(rate, True) / 256.0
    assert abs(m.mean() - p) < 5.0 * np.sqrt(p * (1 - p) / n)
    for planes in (m.reshape(-1, 4), m.reshape(-1, 4, 4)[:, :, 0]):  # byte planes, word planes
        for i in range(4):
            for j in range(i + 1, 4):
                r = np.corrcoef(planes[:, i], planes[:, j])[0, 1]
                assert abs(r) < 0.02, (i, j, r)


def test_dropout_mask_wrapper_on_the_cpu_is_the_plain_mask():
    seed = torch.tensor([5])
    for pack in (False, True):
        got = tfb.dropout_mask(seed, (3, 10, 4, 16), 0.3, "cpu", pack_bits=pack)
        assert torch.equal(got, tfb.dropout_keep_mask(seed, (3, 10, 4, 16), 0.3, pack_bits=pack))


# ------------------------------------------------- K2 with the packed mask

SHAPES = [(2, 48, 16, 16), (2, 24, 4, 16), (1, 16, 8, 64)]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    C = shape[-1]
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(y=f(0.3 + 1.5 * rng.standard_normal(shape)), scale=f(1 + 0.1 * rng.standard_normal(C)),
                bias=f(0.1 * rng.standard_normal(C)), w=f(rng.standard_normal((C, C)) / np.sqrt(C)),
                b=f(0.1 * rng.standard_normal(C)),
                dout=f(rng.standard_normal((shape[0], shape[1] // 2, shape[2] // 4, C))))


def _stats(y):
    C = y.shape[-1]
    flat = y.reshape(-1, C)
    mean = flat.mean(0)
    return mean, (flat * flat).mean(0) - mean * mean


@pytest.mark.parametrize("rate", [0.5, 0.3])
@pytest.mark.parametrize("shape", SHAPES)
def test_k2_forward_and_backward_with_the_packed_mask_match_jax_reference(shape, rate):
    d = _inputs(shape, sum(shape))
    seed = 31337
    mask = tfb.dropout_keep_mask(seed, shape, rate, pack_bits=True)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    mean, var = _stats(t["y"])
    out = tfb.fused_bn_glu_pool(t["y"], t["scale"], t["bias"], mean, var, t["w"], t["b"], POOL, EPS, rate=rate,
                                seed=seed, pack_bits=True)
    jmask = jnp.asarray(mask.numpy())
    ref = jfb.reference_block(*(jnp.asarray(v) for v in (d["y"], d["scale"], d["bias"], mean.numpy(), var.numpy(),
                                                           d["w"], d["b"])), jmask, 1.0 - rate, POOL, EPS)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)

    def f(y, scale, bias, w, b):  # the batch statistics in the graph, as BatchNorm in training
        m, v = _stats(y)
        return jnp.sum(jfb.reference_block(y, scale, bias, m, v, w, b, jmask, 1.0 - rate, POOL, EPS)
                       * jnp.asarray(d["dout"]))

    want = jax.grad(f, argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(d[k]) for k in ("y", "scale", "bias", "w", "b")))
    leaves = [t[k].clone().requires_grad_(True) for k in ("y", "scale", "bias", "w", "b")]
    tfb.fused_bn_glu_dropout_pool(leaves[0], leaves[1], leaves[2], mean, var, leaves[3], leaves[4], seed, rate,
                                  POOL, EPS, True, pack_bits=True).backward(t["dout"])
    for name, leaf, w in zip(("dy", "dscale", "dbias", "dw", "db"), leaves, want):
        w = np.asarray(w)
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=name)


def test_functions_record_the_draw_at_their_forward(monkeypatch):
    """K2's and K5's autograd Functions regenerate the mask of the draw
    their forward ran under, whatever PACK_BITS is by the backward."""
    shape = (2, 16, 8, 16)
    d = _inputs(shape, 3)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    mean, var = _stats(t["y"])
    seed, rate = 99, 0.5
    for pack in (True, False):
        monkeypatch.setattr(tfb, "PACK_BITS", pack)
        leaf = t["y"].clone().requires_grad_(True)
        out = tfb.fused_bn_glu_dropout_pool(leaf, t["scale"], t["bias"], mean, var, t["w"], t["b"], seed, rate, POOL,
                                            EPS, True)
        monkeypatch.setattr(tfb, "PACK_BITS", not pack)
        out.backward(t["dout"])
        mask = tfb.dropout_keep_mask(seed, shape, rate, pack_bits=pack)
        want = tfb.bwd_reference(t["y"], t["dout"], t["scale"], t["bias"], mean, var, t["w"], t["b"], POOL, EPS,
                                 mask, 1.0 - rate)[0]
        assert torch.equal(leaf.grad, want), pack

    x, conv, vecs = _entry_inputs((2, 12, 16), 16, 4)
    for pack in (True, False):
        monkeypatch.setattr(tfb, "PACK_BITS", pack)
        w = conv["w"].clone().requires_grad_(True)
        out = tfe.entry_block_apply({"w": w, "b": conv["b"]}, *vecs[:4], *vecs[4:], x, seed, rate, POOL, EPS, True)
        monkeypatch.setattr(tfb, "PACK_BITS", not pack)
        out.backward(torch.ones_like(out))
        w2 = conv["w"].clone().requires_grad_(True)
        tfe.entry_block_apply({"w": w2, "b": conv["b"]}, *vecs[:4], *vecs[4:], x, seed, rate, POOL, EPS, True,
                              pack_bits=pack).backward(torch.ones_like(out))
        assert torch.equal(w.grad, w2.grad), pack


# ------------------------------------------ the entry blocks' packed mask


def _entry_inputs(xshape, C, seed):
    rng = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    x = f(rng.standard_normal(xshape))
    conv = {"w": f(rng.uniform(-0.5, 0.5, (3, 3, 1, C))), "b": f(0.1 * rng.standard_normal(C))}
    y = tec.entry_conv_reference(conv, x)[0]
    mean, var = _stats(y)
    vecs = [f(1 + 0.1 * rng.standard_normal(C)), f(0.1 * rng.standard_normal(C)), mean, var,
            f(rng.standard_normal((C, C)) / np.sqrt(C)), f(0.1 * rng.standard_normal(C))]
    return x, conv, vecs


@pytest.mark.parametrize("rate", [0.5, 0.3])
@pytest.mark.parametrize("xshape,C", [((2, 12, 16), 16), ((2, 8, 64), 64)])
def test_entry_block_packed_mask_equals_conv_then_k2(xshape, C, rate):
    x, conv, (scale, bias, mean, var, gw, gb) = _entry_inputs(xshape, C, sum(xshape))
    seed = 4242
    y = tec.entry_conv_reference(conv, x)[0]
    fused = tfe.entry_block_fwd(x, conv["w"], conv["b"], scale, bias, mean, var, gw, gb, POOL, EPS, rate=rate,
                                seed=seed, pack_bits=True)
    pair = tfb.fused_bn_glu_pool(y, scale, bias, mean, var, gw, gb, POOL, EPS, rate=rate, seed=seed, pack_bits=True)
    np.testing.assert_allclose(fused.numpy(), pair.numpy(), rtol=0, atol=1e-5)
    dout = torch.from_numpy(np.random.default_rng(1).standard_normal(pair.shape).astype(np.float32))
    got = tfe.entry_block_bwd_reduce(x, dout, conv["w"], conv["b"], scale, bias, mean, var, gw, gb, POOL, EPS,
                                     rate=rate, seed=seed, pack_bits=True)
    want = tfb.bwd_reduce(y, dout, scale, bias, mean, var, gw, gb, POOL, EPS, rate=rate, seed=seed,
                          pack_bits=True)[1:]
    for name, g, w in zip(("d glu_w", "d glu_b", "S1", "S2"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5 * w.abs().max().item(), err_msg=name)
    # the packed draw is not the 32-bit one
    unpacked = tfe.entry_block_fwd(x, conv["w"], conv["b"], scale, bias, mean, var, gw, gb, POOL, EPS, rate=rate,
                                   seed=seed, pack_bits=False)
    assert not torch.equal(fused, unpacked)


def test_crows_entry_gives_the_entry_block_bits_with_the_packed_mask():
    x, conv, (scale, bias, mean, var, gw, gb) = _entry_inputs((2, 8, 64), 64, 11)
    args = (scale, bias, mean, var, gw, gb, x[..., None], 17, 0.5, (2, 4), EPS, True)
    out = tcr.crows_apply(conv, *args, pack_bits=True)
    ref = tfe.entry_block_apply(conv, *args, pack_bits=True)
    assert torch.equal(out, ref)


# ------------------------------------------------ the knobs from the environment

KNOBS = {
    "DCASE_FUSED_BWD_RECOMPUTE": ("dcase2019_task4_tpu.ops.fused_block", "_RECOMPUTE_FIXUP",
                                  "dcase2019_task4_tpu_torch.ops.fused_block", "RECOMPUTE_FIXUP"),
    "DCASE_DROPOUT_PACK": ("dcase2019_task4_tpu.ops.fused_block", "_PACK_BITS",
                           "dcase2019_task4_tpu_torch.ops.fused_block", "PACK_BITS"),
    "DCASE_FUSED_MEL_ONEDOT": ("dcase2019_task4_tpu.ops.fused_mel", "ONEDOT",
                               "dcase2019_task4_tpu_torch.ops.fused_mel", "ONEDOT"),
}


@pytest.mark.parametrize("value", ["1", None])
def test_a_fresh_interpreter_reads_each_knob_as_the_jax_package_does(value):
    env = {k: v for k, v in os.environ.items() if k not in KNOBS}
    env.update(PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    if value is not None:
        env.update({k: value for k in KNOBS})
    code = "import importlib, json\nout = {}\n"
    for name, (jmod, jattr, tmod, tattr) in KNOBS.items():
        code += (f"out[{name!r}] = [getattr(importlib.import_module({jmod!r}), {jattr!r}), "
                 f"getattr(importlib.import_module({tmod!r}), {tattr!r})]\n")
    code += "print(json.dumps(out))\n"
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    import json

    read = json.loads(proc.stdout.strip().splitlines()[-1])
    for name, (jax_value, port_value) in read.items():
        assert jax_value == port_value == (value is not None), (name, jax_value, port_value)
