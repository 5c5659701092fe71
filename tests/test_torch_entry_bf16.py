"""Port parity: the bfloat16 modes of the first-block family, K4 (entry
conv), K5 (fused first block, the parity-plane original) and K6 (the crows
original), and the flagship bfloat16 CRNN under each first-block flag,
against the JAX package with its Pallas kernels in interpret mode on
XLA:CPU.

Inputs come from numpy seeds. The port's CPU tensors run its plain
versions, which round where each original rounds; the CUDA kernels are held
to them on the card (chip_smoke.py). Both sides take the same mean and var
(the JAX statistics kernel's), so a comparison of the block holds the block
alone.

Bars, each stated where it is checked:
  * a bfloat16 output: each element within one bfloat16 ulp of itself plus
    the stated slack, and at most 1e-3 of the elements beyond the one ulp
    alone (rounded up: one element of an output under 1000). The slack of
    the pooled output is what one rounding that follows a float32 sum may
    flip: one ulp of the largest pt-row column sum ("planes") or of the
    largest g ("crows") of the window, over pt·pf;
  * float32 outputs (the statistics, d conv_b, d scale, d bias, d glu_w, d
    glu_b): 1e-4 of the output's max. d glu_w sums products of bfloat16 xn
    and dlin, whose float32 values differ in their last bits between the
    two sides, so now and then one operand rounds the other way: it gets
    the size of one such flip on top (as tests/test_torch_bf16_kernels.py);
  * dW, the gradient of the bfloat16 weights, which both sides round in two
    parts before adding them: each element within one bfloat16 ulp of
    itself plus one of each part's sum at that element, and at most 1e-3 of
    the elements beyond one ulp of themselves. Where dy is computed inside
    the block, a dy element may round the other way too: one such flip,
    ulp(max|dy|)·max|x|, on top. The JAX side is its own entry point's VJP
    (`entry_conv_apply`, `entry_block_apply`, `crows_apply` in bfloat16),
    which rounds the parts itself;
  * a part's float32 sum against the original's accumulator folded by
    position: 1e-5 of its max, plus one dy flip where dy is computed;
  * the CRNN and the MT step: the bars of tests/test_torch_scaled.py
    (probabilities 1e-5, metrics 1e-5, BatchNorm means 1e-4 of the block's
    largest standard deviation and variances 1e-4 of its largest, 5e-4 after
    a step; each gradient leaf 2e-2 of its own max plus 1e-6 of the step's
    largest gradient, the gauge leaves 1e-3 of the largest).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dcase2019_task4_tpu import config as jconfig
from dcase2019_task4_tpu.models import crnn as jcrnn
from dcase2019_task4_tpu.ops import crows_block as jcr
from dcase2019_task4_tpu.ops import entry_conv as jec
from dcase2019_task4_tpu.ops import fused_block as jfb
from dcase2019_task4_tpu.ops import fused_entry_block as jfe
from dcase2019_task4_tpu.train import steps as jsteps
from dcase2019_task4_tpu_torch import config as tconfig
from dcase2019_task4_tpu_torch.models import crnn as tcrnn
from dcase2019_task4_tpu_torch.ops import crows_block as tcr
from dcase2019_task4_tpu_torch.ops import entry_conv as tec
from dcase2019_task4_tpu_torch.ops import fused_block as tfb
from dcase2019_task4_tpu_torch.ops import fused_entry_block as tfe
from dcase2019_task4_tpu_torch.train import checkpoints as tckpt
from dcase2019_task4_tpu_torch.train import steps as tsteps

BF16 = torch.bfloat16
B, T, F, C = 2, 8, 64, 64  # the flagship's 64 mels and 64 channels; crows takes F = 64 only
POOL = (2, 4)
EPS = 1e-3
SEED = 23
NAMES = ("w", "b", "scale", "bias", "gw", "gb")


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _ulp(a):
    """The bfloat16 spacing at |a| (floored at the smallest normal)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126))) - 7)


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16).float().numpy()


def _ulp_rule(got, want, what, slack=0.0):
    """Each element within one bfloat16 ulp of itself plus `slack`; at most
    1e-3 of the elements (rounded up) beyond the one ulp alone."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    diff, own = np.abs(got - want), _ulp(np.maximum(np.abs(got), np.abs(want)))
    bad = diff > own + slack
    assert not bad.any(), f"{what}: {bad.sum()} elements beyond one ulp + slack, worst {diff.max()}"
    beyond = int((diff > own).sum())
    assert beyond <= np.ceil(1e-3 * diff.size), f"{what}: {beyond} of {diff.size} elements beyond one bfloat16 ulp"


def _close(got, want, what, rel=1e-4, extra=0.0):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=rel * np.abs(want).max() + extra, err_msg=what)


def _dw_rule(got, want, parts, what, extra=0.0):
    """dW of the bfloat16 weights: one ulp of itself plus one of each part's
    sum (plus `extra`), at most 1e-3 of the elements beyond one ulp."""
    slack = sum(_ulp(np.abs(_np(p))) for p in parts) + extra
    _ulp_rule(got, want, what, slack)


def _inputs(seed, shape=(B, T, F)):
    rng = np.random.default_rng(seed)
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    Bn, Tn, Fn = shape
    return dict(
        x=f(rng.standard_normal(shape + (1,))),
        w=f(rng.standard_normal((3, 3, 1, C)) * 0.3),
        b=f(rng.standard_normal(C) * 0.1),
        scale=f(rng.uniform(0.5, 1.5, C)),
        bias=f(rng.standard_normal(C) * 0.1),
        gw=f(rng.standard_normal((C, C)) * 0.1),
        gb=f(rng.standard_normal(C) * 0.1),
        dy=_bf16(rng.standard_normal((Bn, Tn, Fn, C))),
        ct=_bf16(rng.standard_normal((Bn, Tn // POOL[0], Fn // POOL[1], C))),
        run_mean=f(0.2 * rng.standard_normal(C)),
        run_var=f(rng.uniform(0.5, 2.0, C)),
    )


def _t(d, *names, grad=False):
    return [torch.from_numpy(d[n]).requires_grad_(grad) for n in names]


def _j(d, *names):
    return [jnp.asarray(d[n]) for n in names]


def _dy_flip(dy_max, x):
    """One bfloat16 dy element rounding the other way in dW = Σ x·dy."""
    return float(_ulp(dy_max)) * float(np.abs(_bf16(x)).max())


# ----------------------------------------------------------------- K4


def test_entry_conv_forward_and_stats_match_jax_interpret():
    d = _inputs(1)
    fn = jax.jit(lambda w, b, x: jec.entry_conv_apply({"w": w, "b": b}, x, compute_dtype=jnp.bfloat16,
                                                       interpret=True, want_stats=True))
    y_ref, s1_ref, s2_ref = fn(*_j(d, "w", "b", "x"))
    y, s1, s2 = tec.entry_conv_apply(dict(zip("wb", _t(d, "w", "b"))), torch.from_numpy(d["x"]),
                                     compute_dtype="bfloat16", want_stats=True)
    assert y.dtype == BF16 and y_ref.dtype == jnp.bfloat16 and s1.dtype == torch.float32
    _ulp_rule(y, y_ref, "y")
    _close(s1, s1_ref, "sum y")
    _close(s2, s2_ref, "sum y^2")


@jax.jit
def _jax_entry_conv_vjp(w, b, x, dy):
    """The original's (dW, db) and its float32 accumulator dW2 [12, 128]
    (parity-plane basis) before the rounding: the custom VJP of `entry_conv`
    with a float32 W2."""
    fn = lambda w_, b_: jec.entry_conv_apply({"w": w_, "b": b_}, x, compute_dtype=jnp.bfloat16,  # noqa: E731
                                             interpret=True)
    dw, db = jax.vjp(fn, w, b)[1](dy)
    ev, od = jec.make_parity_planes(x[..., 0], jnp.bfloat16)
    f2 = lambda w2_: jec.entry_conv(ev, od, w2_, jnp.tile(b, 2), jnp.bfloat16, jnp.bfloat16, True)[0]  # noqa: E731
    Bn, Tn, Fn, _ = dy.shape
    (dw2,) = jax.vjp(f2, jec.build_w2(w, 2))[1](dy.reshape(Bn, Tn, Fn // 2, 2 * C))
    return dw, db, dw2


def _fold_parity(dw2):
    """[12, 128] parity-plane accumulator → its two output-frequency parities'
    [3, 3, 1, C] sums: W2[(dt, df + h), h·C + c] holds w[dt, df, 0, c]."""
    return [np.stack([np.stack([dw2[4 * dt + df + h, h * C:(h + 1) * C] for df in range(3)]) for dt in range(3)])
            [:, :, None, :] for h in (0, 1)]


def test_entry_conv_vjp_matches_jax_interpret():
    """dW = bf16(Σ even output frequencies) + bf16(Σ odd ones), db float32;
    and the port's two float32 parts (output-frequency parity) against the
    original's dW2 folded by position, 1e-5 of each part's max."""
    d = _inputs(2)
    dw_ref, db_ref, dw2 = _jax_entry_conv_vjp(*_j(d, "w", "b", "x"), jnp.asarray(d["dy"], jnp.bfloat16))
    w, b = _t(d, "w", "b", grad=True)
    x, dy = torch.from_numpy(d["x"]), torch.from_numpy(d["dy"]).to(BF16)
    y = tec.entry_conv_apply({"w": w, "b": b}, x, compute_dtype=torch.bfloat16)
    y.backward(dy)
    parts = _fold_parity(np.asarray(dw2))
    _dw_rule(w.grad, dw_ref, parts, "dW")
    _close(b.grad, db_ref, "db")
    got = tec.entry_conv_wgrad_parts_reference(x.to(BF16), dy, "parity")
    assert len(got) == 2
    for h, (g, want) in enumerate(zip(got, parts)):
        _close(g, want, f"parity {h}", rel=1e-5)
    # the wrapper that reads the parts (on the card, from the kernel's slots)
    dw_p, db_p, parts_p = tec.entry_conv_wgrad_parts(x.to(BF16), dy)
    assert torch.equal(dw_p, w.grad) and torch.equal(db_p, b.grad) and torch.equal(parts_p, torch.stack(got))
    assert torch.equal(dw_p, sum(p.to(BF16).float() for p in parts_p))
    # the rounding in parts is what sets it apart from one rounding of the sum
    whole = _bf16(sum(parts))
    assert (np.abs(whole - _np(dw_ref)) > _ulp(np.abs(_np(dw_ref)))).any()


# ----------------------------------------------------------------- K5, K6


def _moments(s, sq, n):
    mean = s / n
    return mean, sq / n - mean * mean


def _jax_stats(d, crows):
    conv = {"w": jnp.asarray(d["w"]), "b": jnp.asarray(d["b"])}
    stats = jcr.crows_stats_apply if crows else jfe.entry_block_stats_apply
    return stats(conv, jnp.asarray(d["x"]), compute_dtype=jnp.bfloat16, interpret=True)


def _batch_moments(d):
    """mean, var from the original's statistics kernel, as numpy float32."""
    s, sq = _jax_stats(d, False)
    n = np.prod(d["x"].shape[:3])
    return [np.asarray(v, np.float32) for v in _moments(np.asarray(s), np.asarray(sq), n)]


def _jax_apply(crows):
    return jcr.crows_apply if crows else jfe.entry_block_apply


def _port_apply(crows):
    return tcr.crows_apply if crows else tfe.entry_block_apply


def _gate_slack(d, mean, var, layout, mask=None, keep=1.0):
    """One rounding after a float32 sum, flipped: one ulp of the largest
    pt-row column sum (planes) or of the largest g (crows) of each window,
    over pt·pf; g from the plain formula."""
    x = torch.from_numpy(d["x"]).to(BF16)
    y = tec.entry_conv_reference({"w": torch.from_numpy(d["w"]), "b": torch.from_numpy(d["b"])}, x)[0]
    g = tfb.glu_gate(y, *(torch.from_numpy(v) for v in (d["scale"], d["bias"], mean, var, d["gw"], d["gb"])), EPS,
                     mask, keep).numpy()
    Bn, Tn, Fn, Cn = g.shape
    pt, pf = POOL
    win = g.reshape(Bn, Tn // pt, pt, Fn // pf, pf, Cn)
    top = np.abs(win.sum(axis=2)).max(axis=3) if layout == "planes" else np.abs(win).max(axis=(2, 4))
    return _ulp(top) / (pt * pf)


@pytest.mark.parametrize("crows", [False, True])
def test_stats_match_jax_interpret(crows):
    d = _inputs(4)
    s_ref, sq_ref = _jax_stats(d, crows)
    stats = tcr.crows_stats_apply if crows else tfe.entry_block_stats_apply
    s, sq = stats(dict(zip("wb", _t(d, "w", "b"))), torch.from_numpy(d["x"]), compute_dtype="bfloat16")
    assert s.dtype == torch.float32
    _close(s, s_ref, "sum y")
    _close(sq, sq_ref, "sum y^2")
    # the sums of y as stored: those of K4's bfloat16 y
    y = tec.entry_conv_forward(dict(zip("wb", _t(d, "w", "b"))), torch.from_numpy(d["x"]).to(BF16))[0]
    _close(s, y.float().sum(dim=(0, 1, 2)), "sum of the stored y", rel=1e-6)


@pytest.mark.parametrize("crows", [False, True])
def test_eval_forward_matches_jax_interpret(crows):
    """Eval mode (running statistics); the train forward at rate 0 is held
    in the VJP test below."""
    d = _inputs(5)
    mean, var = d["run_mean"], d["run_var"]
    fn = jax.jit(lambda w, b, scale, bias, gw, gb, m, v, x: _jax_apply(crows)(
        {"w": w, "b": b}, scale, bias, m, v, gw, gb, x, jnp.int32(SEED), 0.0, POOL, EPS, False,
        compute_dtype=jnp.bfloat16, interpret=True))
    want = fn(*_j(d, *NAMES, "run_mean", "run_var", "x"))
    w, b, scale, bias, gw, gb = _t(d, *NAMES)
    got = _port_apply(crows)({"w": w, "b": b}, scale, bias, torch.from_numpy(mean), torch.from_numpy(var), gw, gb,
                             torch.from_numpy(d["x"]), SEED, 0.5, POOL, EPS, False, compute_dtype="bfloat16")
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    layout = "crows" if crows else "planes"
    _ulp_rule(got, want, f"pooled output ({layout})", _gate_slack(d, mean, var, layout))


def _jax_interpret_crows_mask(shape, seed, rate):
    """The crows kernel's keep-mask in interpret mode (`_dropout_mask` with
    interp=True on its [2C, L] tile), rebuilt in numpy: a hash of the
    element's place in the tile (row = batch half · C + channel, lane =
    t·F + f within the lane tile) and of seed + b2·nt + lane tile."""
    Bn, Tn, Fn, Cn = shape
    L = jcr._pick_l(Tn * Fn, POOL[0] * POOL[1])
    nt = Tn * Fn // L
    n, t, f, c = np.meshgrid(np.arange(Bn), np.arange(Tn), np.arange(Fn), np.arange(Cn), indexing="ij")
    lane = t * Fn + f
    row = (n // (Bn // 2)) * Cn + c
    idx = (row * L + lane % L).astype(np.uint32)
    sv = (seed + (n % (Bn // 2)) * nt + lane // L).astype(np.uint32)
    with np.errstate(over="ignore"):
        h = idx ^ (sv * np.uint32(2654435761))
        h = (h ^ (h >> np.uint32(16))) * np.uint32(0x7FEB352D)
        h = (h ^ (h >> np.uint32(15))) * np.uint32(0x846CA68B)
        bits = h ^ (h >> np.uint32(16))
    return (bits >= np.uint32(min(int(rate * 2 ** 32), 2 ** 32 - 1))).astype(np.float32)


def _jax_block_grads(d, mean, var, crows, rate=0.0):
    """Forward and parameter cotangents of the original's own entry point
    (`entry_block_apply`, `crows_apply`) in bfloat16 at the given mean and
    var. It casts the packed conv weight to bfloat16, so its dW is the
    original's own sum of the per-copy roundings (`dw2.astype(w2.dtype)`
    folded onto w)."""
    m, v, x = jnp.asarray(mean), jnp.asarray(var), jnp.asarray(d["x"])

    def fn(w, cb, s, be, g, gb_):
        return _jax_apply(crows)({"w": w, "b": cb}, s, be, m, v, g, gb_, x, jnp.int32(SEED), rate, POOL, EPS, True,
                                 compute_dtype=jnp.bfloat16, interpret=True)

    run = jax.jit(lambda *args: (lambda out, vjp: (out, vjp(jnp.asarray(d["ct"], jnp.bfloat16))))(*jax.vjp(fn, *args)))
    out, grads = run(*_j(d, *NAMES))
    return (out, *(np.asarray(g) for g in grads))


def _jax_dw_parts(d, mean, var, crows):
    """The original's float32 packed conv-weight cotangent at rate 0, before
    its rounding (the kernel called on a float32 packed weight), folded into
    its two parts by position."""
    x, cd = jnp.asarray(d["x"]), jnp.bfloat16
    m, v = jnp.asarray(mean), jnp.asarray(var)
    w, b, scale, bias, gw, gb = _j(d, *NAMES)
    if crows:
        xm, x0, xp = jcr.make_shifted_rows(x[..., 0], cd)
        pv = jcr.pack_vec

        def fn(w2):
            out = jcr.crows_entry_block(xm, x0, xp, w2, pv(b), pv(scale), pv(bias), pv(m), pv(v), jcr.pack_glu_w(gw),
                                        pv(gb), jnp.int32(SEED), 0.0, POOL, EPS, True, cd, True, True)
            return jcr.unpack_pooled(out, F // POOL[1])

        w2 = jcr.pack_conv_w(w)
    else:
        ev, od = jec.make_parity_planes(x[..., 0], cd)
        tk = lambda a: jfb._tile_k(a, 2)  # noqa: E731

        def fn(w2):
            return jfe.fused_entry_block(ev, od, w2, tk(b), tk(scale), tk(bias), tk(m), tk(v), jfb._pack_w(gw, 2),
                                         tk(gb), jnp.int32(SEED), 0.0, POOL, EPS, True, cd, True, True)

        w2 = jec.build_w2(w, 2)
    (dw2,) = jax.jit(lambda w2_: jax.vjp(fn, w2_)[1](jnp.asarray(d["ct"], cd)))(w2)
    dw2 = np.asarray(dw2)
    if crows:  # [2C, 18]: half 0 at rows c, even columns; half 1 at rows C + c, odd columns; column (df·3 + dt)
        return [np.stack([np.stack([dw2[h * C:(h + 1) * C, 2 * (df * 3 + dt) + h] for df in range(3)])
                          for dt in range(3)])[:, :, None, :] for h in (0, 1)]
    return _fold_parity(dw2)


def _port_grads(d, mean, var, crows, rate=0.0, mask=None):
    """The port's block and its gradients: through the autograd Function at
    rate 0, through the plain formulas with an injected mask otherwise."""
    layout = "crows" if crows else "planes"
    m, v = torch.from_numpy(mean), torch.from_numpy(var)
    x, ct = torch.from_numpy(d["x"]).to(BF16), torch.from_numpy(d["ct"]).to(BF16)
    if mask is None:
        leaves = _t(d, *NAMES, grad=True)
        w, b, scale, bias, gw, gb = leaves
        out = _port_apply(crows)({"w": w, "b": b}, scale, bias, m, v, gw, gb, x, SEED, rate, POOL, EPS, True,
                                 compute_dtype=BF16)
        out.backward(ct)
        return out, [leaf.grad for leaf in leaves]
    w, b, scale, bias, gw, gb = _t(d, *NAMES)
    keep = 1.0 - rate
    out = tfe.reference_entry_block(x, w, b, scale, bias, m, v, gw, gb, POOL, EPS, mask, keep, layout)
    dw, dcb, dscale, dbias, dgw, dgb = tfe.entry_block_bwd_reference(x, ct, w, b, scale, bias, m, v, gw, gb, POOL, EPS,
                                                                     mask, keep, layout)
    return out, [dw, dcb, dscale, dbias, dgw, dgb]


def _dgw_flip(d, mean, var, keep=1.0):
    """One bfloat16 operand of d glu_w = Σ xnᵀ·dlin rounding the other way."""
    y = tec.entry_conv_reference({"w": torch.from_numpy(d["w"]), "b": torch.from_numpy(d["b"])},
                                 torch.from_numpy(d["x"]).to(BF16))[0].float().numpy()
    xn = np.abs((y - mean) / np.sqrt(var + EPS) * d["scale"] + d["bias"]).max()
    dlin = np.abs(d["ct"]).max() / (POOL[0] * POOL[1] * keep)
    return float(_ulp(xn) * dlin + _ulp(dlin) * xn)


def _check_grads(d, mean, var, crows, got, want, mask=None, keep=1.0):
    """The pooled output under the ulp rule, dW under the dW rule (its slack
    from the port's two float32 part sums) plus one dy flip, the float32
    gradients 1e-4 of their max (d conv_b, a gauge leaf, plus 1e-6 of the
    block's largest gradient; d glu_w plus one operand flip)."""
    out_ref, dw_ref, db, dscale, dbias, dgw, dgb = want
    out, (dw, dcb, gscale, gbias, ggw, ggb) = got
    layout = "crows" if crows else "planes"
    _ulp_rule(out, out_ref, f"pooled output ({layout})", _gate_slack(d, mean, var, layout, mask, keep))
    flip, parts = _pass2(d, mean, var, layout, mask, keep)
    _dw_rule(dw, dw_ref, parts, f"dW ({layout})", flip)
    top = max(np.abs(_np(v)).max() for v in (dgw, dscale, dbias))
    for name, g, w in (("d scale", gscale, dscale), ("d bias", gbias, dbias), ("d glu_b", ggb, dgb)):
        _close(g, w, f"{name} ({layout})")
    _close(dcb, db, f"d conv_b ({layout})", extra=1e-6 * top)
    _close(ggw, dgw, f"d glu_w ({layout})", extra=_dgw_flip(d, mean, var, keep))


def _pass2(d, mean, var, layout, mask=None, keep=1.0):
    """One bfloat16 dy element of pass 2 rounding the other way, times the
    largest feature (the largest dy from the plain formula); and the port's
    float32 sums of pass 2's two dW parts under `layout`."""
    x = torch.from_numpy(d["x"]).to(BF16)
    vecs = [torch.from_numpy(v) for v in (d["w"], d["b"], d["scale"], d["bias"], mean, var, d["gw"], d["gb"])]
    ct = torch.from_numpy(d["ct"]).to(BF16)
    _, _, s1, s2 = tfe.entry_block_bwd_reduce_reference(x, ct, *vecs, POOL, EPS, mask, keep)
    a, b2 = tfb.bwd_coefficients(vecs[2], vecs[5], EPS, s1, s2, x[..., 0].numel())
    dy, _ = tfe._pass2_dy(x, ct, *vecs, a, b2, POOL, EPS, mask, keep)
    parts = tfe.entry_block_bwd_wgrad_parts_reference(x, ct, *vecs, a, b2, POOL, EPS, mask, keep, layout)
    return _dy_flip(np.abs(dy.numpy()).max(), d["x"]), parts


@pytest.mark.parametrize("crows", [False, True])
def test_train_vjp_at_rate_0_matches_jax_interpret(crows):
    """Train mode at rate 0 with the batch statistics: the pooled output and
    every parameter gradient through the autograd Function; and the port's
    two float32 parts of pass 2's dW (output-frequency parity for the planes
    original, batch halves for crows) against the original's float32 packed
    accumulator folded by position, 1e-5 of each part's max plus one dy
    flip."""
    d = _inputs(7)
    mean, var = _batch_moments(d)
    want = _jax_block_grads(d, mean, var, crows)
    got = _port_grads(d, mean, var, crows)
    _check_grads(d, mean, var, crows, got, want)
    layout = "crows" if crows else "planes"
    flip, parts = _pass2(d, mean, var, layout)
    for h, (g, w) in enumerate(zip(parts, _jax_dw_parts(d, mean, var, crows))):
        _close(g, w, f"{layout} part {h}", rel=1e-5, extra=flip)


def test_crows_dropout_with_the_injected_jax_mask_matches_jax_interpret():
    """Rate 0.5: the crows kernel's interpret-mode mask, rebuilt, handed to
    the port's plain versions (the two packages' generators differ by
    design)."""
    d = _inputs(8)
    mean, var = _batch_moments(d)
    rate = 0.5
    mask = torch.from_numpy(_jax_interpret_crows_mask((B, T, F, C), SEED, rate))
    want = _jax_block_grads(d, mean, var, True, rate)
    got = _port_grads(d, mean, var, True, rate, mask)
    _check_grads(d, mean, var, True, got, want, mask, 1.0 - rate)


# ----------------------------------------------------------------- the CRNN

TM = 32  # frames: 16 and 8 at blocks 2 and 3, which every JAX tiling takes
FLAGS = ("entry_block_pallas", "entry_block_crows", "entry_conv_pallas")


def _model_kw(**kw):
    return dict(nb_filters=(C, C, C), n_rnn_cell=16, compute_dtype="bfloat16", **kw)


def _jax_weights(cfg, seed):
    params, state = jcrnn.CRNN(cfg).init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    state = {"cnn": [{"mean": jnp.asarray(0.2 * rng.standard_normal(s["mean"].shape), jnp.float32),
                      "var": jnp.asarray(rng.uniform(0.5, 2.0, s["var"].shape), jnp.float32)}
                     for s in state["cnn"]]}
    return params, state


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


@pytest.mark.parametrize("flag", (None,) + FLAGS)
def test_flagship_bf16_crnn_eval_matches_jax(flag):
    """The flagship's widths in bfloat16 (64 mels, 64 channels) at 2 clips of
    32 frames, under the default first block and each flag: the JAX model
    with its kernels interpreted against the port's plain versions."""
    flags = {flag: True} if flag else {}
    jcfg = jconfig.ModelConfig(fused_block=True, fused_interpret=True, **_model_kw(**flags))
    params, state = _jax_weights(jcfg, 1)
    x = np.random.default_rng(2).standard_normal((2, TM, F)).astype(np.float32)
    s_ref, w_ref, _ = jax.jit(jcrnn.CRNN(jcfg).apply, static_argnames="train")(params, state, jnp.asarray(x),
                                                                              train=False)
    net = tcrnn.CRNN(tconfig.ModelConfig(**_model_kw(**flags)))
    net.load_state_dict(tckpt.params_from_jax(_np_tree(params), _np_tree(state)))
    # the eval-mode model reaches the first-block kernels through its ops,
    # whose implementations are the forward wrappers: K5f (with the layout
    # the entry asks for) and K4f
    calls = []
    spied = ((tfe, "entry_block_fwd"), (tec, "entry_conv_forward"))
    real = {name: getattr(mod, name) for mod, name in spied}

    def spy(*a, _n, **kw):
        calls.append(f"{_n}[{kw['layout']}]" if _n == "entry_block_fwd" else _n)
        return real[_n](*a, **kw)

    try:
        for mod, name in spied:
            setattr(mod, name, functools.partial(spy, _n=name))
        strong, weak = net.eval()(torch.from_numpy(x))
    finally:
        for mod, name in spied:
            setattr(mod, name, real[name])
    expected = {None: [], "entry_block_pallas": ["entry_block_fwd[planes]"],
                "entry_block_crows": ["entry_block_fwd[crows]"],
                "entry_conv_pallas": ["entry_conv_forward"]}[flag]
    assert calls == expected
    np.testing.assert_allclose(strong.numpy(), np.asarray(s_ref), rtol=0, atol=1e-5)
    np.testing.assert_allclose(weak.numpy(), np.asarray(w_ref), rtol=0, atol=1e-5)


# ----------------------------------------------------------------- the MT step

SB = 4  # [weak 1 | unlabeled 2 | synthetic 1]
WEAK, STRONG = slice(0, 1), slice(3, 4)
NCLASS = 10


def _grad_probe():
    zeros = lambda tree: jax.tree.map(jnp.zeros_like, tree)  # noqa: E731
    return optax.GradientTransformation(zeros, lambda g, s, p=None: (zeros(g), g))


def _check_bn(got, want, what, tol):
    for i, (g, w) in enumerate(zip(got["cnn"], want["cnn"])):
        var = np.asarray(w["var"])
        np.testing.assert_allclose(g["var"], var, rtol=0, atol=tol * var.max(), err_msg=f"{what} {i} var")
        np.testing.assert_allclose(g["mean"], np.asarray(w["mean"]), rtol=0, atol=tol * np.sqrt(var.max()),
                                   err_msg=f"{what} {i} mean")


def _is_gauge_leaf(name):
    return name.endswith(".conv.bias") or name.startswith("dense_softmax.")


@pytest.mark.parametrize("flag", ["entry_block_pallas", "entry_conv_pallas"])
def test_one_mt_step_matches_jax(flag):
    """One Mean-Teacher step of the flagship bfloat16 model at dropout 0 on
    the same normalised features (4 clips of 32 frames; the frontends are
    held to each other elsewhere): metrics, every gradient leaf, both
    models' BatchNorm buffers."""
    rng = np.random.default_rng(5)
    target = (rng.random((SB, TM // 8, NCLASS)) > 0.8).astype(np.float32)
    target[1:3] = -1.0
    batch = {"features": (1.2 * rng.standard_normal((SB, TM, F))).astype(np.float32), "target": target}
    common = dict(mean_teacher=True, rampup_length=10, max_consistency_cost=2.0, ema_alpha=0.999)

    model = jcrnn.CRNN(jconfig.ModelConfig(fused_block=True, fused_interpret=True, dropout=0.0,
                                           **_model_kw(**{flag: True})))
    jstate = jsteps.init_train_state(model, _grad_probe(), jax.random.PRNGKey(3))
    jstate = jstate._replace(step=jnp.int32(3))
    jstep = jsteps.make_train_step(model, _grad_probe(), WEAK, STRONG, donate=False, **common)
    jnew, jmetrics, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0),
                              jstep.zero_metrics())

    cfg = tconfig.ModelConfig(dropout=0.0, **_model_kw(**{flag: True}))
    state = tsteps.init_train_state(cfg, lambda p: torch.optim.SGD(p, lr=0.0), torch.Generator().manual_seed(0))
    state = tckpt.train_state_from_jax(state, _np_tree(jstate.params), _np_tree(jstate.bn_state),
                                       _np_tree(jstate.ema_params), _np_tree(jstate.ema_bn_state), step=3)
    tstep = tsteps.make_train_step(WEAK, STRONG, **common)
    state, metrics, _ = tstep(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                              torch.Generator().manual_seed(0), tstep.zero_metrics())

    assert list(metrics) == list(jstep.metric_keys)
    for k in metrics:
        assert abs(metrics[k].item() - float(jmetrics[k])) <= 1e-5, k
    got = {name: p.grad for name, p in state.student.named_parameters()}
    want = tckpt._named_from_jax(_np_tree(jnew.opt_state))
    top = max(np.abs(w.numpy()).max() for w in want.values())
    for name, g in got.items():
        w = want[name].numpy()
        atol = 2e-2 * np.abs(w).max() + (1e-3 if _is_gauge_leaf(name) else 1e-6) * top
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=atol, err_msg=name)
    out = tckpt.train_state_to_jax(state)
    _check_bn(out["bn_state"], jnew.bn_state, "student", 5e-4)
    _check_bn(out["ema_bn_state"], jnew.ema_bn_state, "teacher", 5e-4)


# ----------------------------------------------------------------- checkpoint


def test_bf16_flagged_checkpoint_round_trips(tmp_path):
    """A flagship bfloat16 checkpoint stored with a first-block flag: the
    configuration and the float32 leaves come back as written, through the
    port's reader and the JAX package's."""
    from dcase2019_task4_tpu.eval.evaluate import config_from_metadata as jax_config_from_metadata
    from dcase2019_task4_tpu.train import checkpoints as jckpt
    from dcase2019_task4_tpu_torch.eval.evaluate import config_from_metadata

    base = tconfig.Config()
    cfg = dataclasses.replace(base, model=dataclasses.replace(base.model, compute_dtype="bfloat16",
                                                              entry_block_pallas=True))
    net = tcrnn.seeded_init_(tcrnn.CRNN(cfg.model), 6)
    params, bn = tckpt.params_to_jax(net)
    meta = {"epoch": 0, "valid_metric": {}, "pooling_time_ratio": 8,
            "scaler": {"mean_": [-40.0] * F, "mean_of_square_": [1825.0] * F},
            "many_hot_encoder": {"labels": list(jconfig.DEFAULT_CLASSES), "n_frames": 108},
            "config": dataclasses.asdict(cfg), "mean_teacher": True}
    path = str(tmp_path / "flagship_bf16.npz")
    tckpt.save_inference_checkpoint(path, params, bn, meta)
    back = tckpt.read_metadata(path)
    assert config_from_metadata(back) == cfg
    jcfg = jax_config_from_metadata(jckpt.read_metadata(path))
    assert (jcfg.model.compute_dtype, jcfg.model.entry_block_pallas) == ("bfloat16", True)
    for a, b in zip(jax.tree.leaves(tckpt.load_inference_state(path)), jax.tree.leaves((params, bn))):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    loaded = tcrnn.CRNN(config_from_metadata(back).model)
    loaded.load_state_dict(tckpt.params_from_jax(*tckpt.load_inference_state(path)))
    assert loaded.compute_dtype == BF16 and loaded.cfg.entry_block_pallas


def test_fold_parts_adds_each_parts_slots_in_float64():
    """`_build.fold_parts`, which reads a kernel's part sums from its slots:
    [parts, slots, width] → each part's slots added in float64, then float32."""
    from dcase2019_task4_tpu_torch.ops import _build

    slots = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 5, 7)).astype(np.float32))
    got = _build.fold_parts(slots)
    assert got.dtype == torch.float32 and got.shape == (2, 7)
    assert torch.equal(got, torch.from_numpy(slots.numpy().astype(np.float64).sum(axis=1).astype(np.float32)))
