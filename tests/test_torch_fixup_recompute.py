"""Port parity: K2b's recompute fixup (DCASE_FUSED_BWD_RECOMPUTE).

Under the knob the JAX package's first backward pass stores no dy_partial
and its second pass (`_bwd_fixup_recompute_kernel`) rebuilds dxn from y and
dout: dy = inv·γ·dxn − a − (y − mean)·b in float32, rounded once to y's
dtype. The port's `bwd_reduce(recompute=True)` and `bwd_fixup_recompute`
(plain versions on CPU tensors) are held to JAX's `_bwd_pallas` run in
interpret mode with `_RECOMPUTE_FIXUP` patched True, at rate 0 (no JAX mask
can be matched):

  * float32: dy within 1e-5 of its max, and dscale, dbias, dW, db within
    1e-5 of theirs (float32 sums in another order);
  * bfloat16: each dy element within one bfloat16 ulp, at most 1e-3 of them
    beyond it; and the port's dy equals JAX's recompute dy in clearly more
    elements (at least 0.1 of them more) than JAX's default dy, which
    rounds through a bfloat16 dy_partial (the two JAX variants differ in
    about 28 % of the elements at these shapes); dscale, dbias and db,
    float32 sums over terms of bfloat16-rounded products, within 1e-4 of
    their max (one dlin operand rounding to the other bfloat16 neighbour
    between the two engines moves a term by ulp·|W|), and dW within 1e-5 of
    its max plus what one of its bfloat16 operands rounding the other way
    moves an element by (the rule of tests/test_torch_bf16_kernels.py).

The autograd Function with the mode on is held to itself with the mode off
at rate 0.5 with the Philox mask: float32 gradients within 1e-6 of each
leaf's max. Inputs come from numpy seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcase2019_task4_tpu.ops import fused_block as jfb
from dcase2019_task4_tpu_torch.ops import fused_block as tfb

POOL = (2, 4)
EPS = 1e-3
SHAPES = [(2, 16, 8, 64), (2, 16, 8, 16), (1, 8, 8, 128)]
VECS = ("scale", "bias", "mean", "var", "w", "b")


def _bf16_values(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).to(torch.float32).numpy()


def _ulp(a):
    """The bfloat16 spacing at |a| (floored at the smallest normal)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126))) - 7)


def _inputs(shape, seed, bf16):
    rng = np.random.default_rng(seed)
    C = shape[-1]
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    y = f(0.3 + 1.5 * rng.standard_normal(shape))
    dout = f(rng.standard_normal((shape[0], shape[1] // POOL[0], shape[2] // POOL[1], C)))
    if bf16:
        y, dout = _bf16_values(y), _bf16_values(dout)
    return dict(y=y, dout=dout, mean=f(y.reshape(-1, C).mean(0)), var=f(y.reshape(-1, C).var(0)),
                scale=f(1 + 0.1 * rng.standard_normal(C)), bias=f(0.1 * rng.standard_normal(C)),
                w=f(rng.standard_normal((C, C)) / np.sqrt(C)), b=f(0.1 * rng.standard_normal(C)))


def _jax_backward(monkeypatch, d, recompute, bf16):
    """JAX's whole backward, interpreted, with the fixup variant chosen."""
    monkeypatch.setattr(jfb, "_RECOMPUTE_FIXUP", recompute)
    dt = jnp.bfloat16 if bf16 else jnp.float32
    out = jfb._bwd_pallas(jnp.asarray(d["y"], dt), jnp.asarray(d["dout"], dt), *(jnp.asarray(d[k]) for k in VECS),
                          jnp.int32(0), 0.0, POOL, EPS, True, interpret=True)
    return [np.asarray(jnp.asarray(v, jnp.float32)) for v in out]  # dy, dscale, dbias, dw, db


def _port_backward(d, bf16):
    """The port's two recompute passes (plain versions) → dy, dscale, dbias, dw, db."""
    dt = torch.bfloat16 if bf16 else torch.float32
    y, dout = torch.from_numpy(d["y"]).to(dt), torch.from_numpy(d["dout"]).to(dt)
    scale, bias, mean, var, w, b = (torch.from_numpy(d[k]) for k in VECS)
    dyp, dw, db, s1, s2 = tfb.bwd_reduce(y, dout, scale, bias, mean, var, w, b, POOL, EPS, recompute=True)
    assert dyp is None  # no dy_partial in this mode
    a, b2 = tfb.bwd_coefficients(scale, var, EPS, s1, s2, y.numel() // y.shape[-1])
    dy = tfb.bwd_fixup_recompute(y, dout, scale, bias, mean, var, w, b, a, b2, POOL, EPS)
    assert dy.dtype == dt
    return [v.to(torch.float32).numpy() for v in (dy, s2, s1, dw, db)]


@pytest.mark.parametrize("shape", SHAPES)
def test_float32_matches_jax_recompute_backward_interpreted(monkeypatch, shape):
    d = _inputs(shape, sum(shape), bf16=False)
    want = _jax_backward(monkeypatch, d, True, bf16=False)
    got = _port_backward(d, bf16=False)
    for name, g, w in zip(("dy", "dscale", "dbias", "dw", "db"), got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_matches_jax_recompute_and_not_the_default(monkeypatch, shape):
    d = _inputs(shape, sum(shape) + 1, bf16=True)
    recompute = _jax_backward(monkeypatch, d, True, bf16=True)
    default = _jax_backward(monkeypatch, d, False, bf16=True)
    got = _port_backward(d, bf16=True)
    dy, want = got[0], recompute[0]
    diff = np.abs(dy - want)
    ulp = _ulp(np.maximum(np.abs(dy), np.abs(want)))
    assert (diff > 2 * ulp).sum() == 0, f"dy: {(diff > 2 * ulp).sum()} elements beyond two bfloat16 ulps"
    share = (diff > ulp).mean()
    assert share <= 1e-3, f"dy: {share:.2e} of the elements beyond one bfloat16 ulp"
    same_recompute, same_default = (dy == want).mean(), (dy == default[0]).mean()
    assert same_recompute >= same_default + 0.1, (same_recompute, same_default)
    for name, g, w in zip(("dscale", "dbias", "dw", "db"), got[1:], recompute[1:]):
        atol = 1e-5 * np.abs(w).max() + _dw_slack(d) if name == "dw" else 1e-4 * np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=name)


def _dw_slack(d):
    """ulp(max|xn|)·max|dlin| + ulp(max|dlin|)·max|xn|: one bfloat16 operand
    of dW = Σ xnᵀ·dlin rounding to the other neighbour."""
    y = d["y"].astype(np.float64)
    xn = (y - d["mean"]) / np.sqrt(d["var"].astype(np.float64) + EPS) * d["scale"] + d["bias"]
    pt, pf = POOL
    dh = np.repeat(np.repeat(d["dout"], pt, axis=1), pf, axis=2) / (pt * pf)
    dlin = np.abs(dh / (1.0 + np.exp(-xn))).max()
    xmax = np.abs(xn).max()
    return _ulp(xmax) * dlin + _ulp(dlin) * xmax


def _function_grads(d, seed, rate, recompute):
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    leaves = [t[k].clone().requires_grad_(True) for k in ("y", "scale", "bias", "w", "b")]
    out = tfb.fused_bn_glu_dropout_pool(leaves[0], leaves[1], leaves[2], t["mean"], t["var"], leaves[3], leaves[4],
                                        seed, rate, POOL, EPS, True, recompute=recompute)
    out.backward(t["dout"])
    return [v.grad for v in leaves]


@pytest.mark.parametrize("pack_bits", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_function_recompute_mode_matches_default_mode_with_dropout(shape, pack_bits, monkeypatch):
    """The autograd Function with the recompute fixup against itself with
    the stored one, rate 0.5, the Philox mask of one seed (either draw)."""
    monkeypatch.setattr(tfb, "PACK_BITS", pack_bits)
    d = _inputs(shape, sum(shape) + 2, bf16=False)
    on = _function_grads(d, 4321, 0.5, True)
    off = _function_grads(d, 4321, 0.5, False)
    for name, a, b in zip(("dy", "dscale", "dbias", "dw", "db"), on, off):
        assert (a - b).abs().max().item() <= 1e-6 * b.abs().max().item(), name


def test_function_records_the_mode_at_its_forward(monkeypatch):
    """The Function's backward runs the fixup its forward ran under, even
    when the module constant changes between the two: in bfloat16 the two
    fixups give different bits, so the recorded one shows."""
    shape = (2, 16, 8, 64)
    d = _inputs(shape, 9, bf16=True)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    y = t["y"].to(torch.bfloat16)
    dout = t["dout"].to(torch.bfloat16)
    vec = [t[k] for k in VECS]
    for recompute in (True, False):
        monkeypatch.setattr(tfb, "RECOMPUTE_FIXUP", recompute)
        leaf = y.clone().requires_grad_(True)
        out = tfb.fused_bn_glu_dropout_pool(leaf, vec[0], vec[1], vec[2], vec[3], vec[4], vec[5], 0, 0.0, POOL, EPS,
                                            True)
        monkeypatch.setattr(tfb, "RECOMPUTE_FIXUP", not recompute)
        out.backward(dout)
        dyp, _, _, s1, s2 = tfb.bwd_reduce_reference(y, dout, *vec, POOL, EPS)
        a, b2 = tfb.bwd_coefficients(vec[0], vec[3], EPS, s1, s2, y.numel() // shape[-1])
        if recompute:
            want = tfb.bwd_fixup_recompute_reference(y, dout, *vec, a, b2, POOL, EPS)
        else:
            want = tfb.bwd_fixup_reference(y, dyp, a, b2, vec[2])
        assert torch.equal(leaf.grad, want), recompute


def test_recompute_plain_versions_differ_only_by_the_bf16_rounding():
    """The two fixups' plain versions: within 1e-6 of max in float32; in
    bfloat16 the recompute one differs from the stored one where the stored
    one's second rounding moved an element, by at most one ulp of dy_partial
    and one of dy."""
    shape = (2, 16, 8, 64)
    for bf16 in (False, True):
        d = _inputs(shape, 5, bf16)
        dt = torch.bfloat16 if bf16 else torch.float32
        t = {k: torch.from_numpy(v) for k, v in d.items()}
        y, dout, vec = t["y"].to(dt), t["dout"].to(dt), [t[k] for k in VECS]
        dyp, _, _, s1, s2 = tfb.bwd_reduce_reference(y, dout, *vec, POOL, EPS)
        a, b2 = tfb.bwd_coefficients(vec[0], vec[3], EPS, s1, s2, y.numel() // shape[-1])
        stored = tfb.bwd_fixup_reference(y, dyp, a, b2, vec[2]).float().numpy()
        rebuilt = tfb.bwd_fixup_recompute_reference(y, dout, *vec, a, b2, POOL, EPS).float().numpy()
        if not bf16:
            np.testing.assert_allclose(rebuilt, stored, rtol=0, atol=1e-6 * np.abs(stored).max())
            continue
        limit = _ulp(np.maximum(np.abs(stored), np.abs(rebuilt))) + _ulp(dyp.float().numpy())
        assert (np.abs(rebuilt - stored) <= limit).all()
        assert (rebuilt != stored).mean() > 0.1
