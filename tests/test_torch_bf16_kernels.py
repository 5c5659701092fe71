"""Port parity: the bfloat16 modes of K3 (3×3 conv forward, dx, wgrad) and
K2 (BN → GLU → dropout → pool forward, its two-pass backward, the batch
statistics) against the JAX package's Pallas kernels in interpret mode on
XLA:CPU, with bfloat16 activations as a bfloat16 model hands them over.

Inputs come from numpy seeds. CPU tensors run the port's plain versions,
which round where the JAX kernels round and compute in float32; the CUDA
kernels are held to these plain versions on the card
(tests/test_torch_kernels_gpu.py, chip_smoke.py). Dropout: the JAX
kernel's interpret-mode mask (a hash of the seed, the grid position and the
element's place in its tile) is rebuilt here in numpy and handed to the
port's plain versions.

Tolerances (measured and stated per check):
  * bfloat16 outputs of a rounding that both sides share (conv out, dx,
    dy_partial): within one bfloat16 ulp of each element — float32 sums in
    another order flip a rounding now and then;
  * the pooled output, which rounds twice (each pt-row column sum, then the
    window mean): one bfloat16 ulp of the output plus one of the window's
    largest column sum over pt·pf (a flipped column rounding, carried
    through the mean);
  * dy = dy_partial − a − (y − mean)·b, which cancels: within one bfloat16
    ulp of dy_partial's element, plus one of dy's;
  * float32 outputs (dW, db, S1, S2, dscale, dbias, the statistics): 1e-5
    of each output's max. K2's dW sums products of bfloat16-rounded xn and
    dlin, and the two sides' float32 xn and dlin differ in their last bits
    (sigmoid and rsqrt are other formulas), so now and then one operand
    rounds the other way: dW gets the size of one such flip on top,
    ulp(max|xn|)·max|dlin| + ulp(max|dlin|)·max|xn|. K3's VJP gives dW as
    the gradient of the bfloat16 weights, rounded to bfloat16 on both sides
    (JAX packs no lanes at C = 128): within two bfloat16 ulps of its max.
  * K3's dW at C = 64, where JAX packs two lane copies (k = 2) and rounds
    each output-frequency class's sum (f even, f odd) to bfloat16 before it
    adds them: each element within one bfloat16 ulp of itself plus one of
    each class sum at that element (a class sum whose float32 value lies
    next to a rounding boundary may round the other way), and at most 1e-3
    of the elements beyond one ulp of themselves. One rounding of the whole
    sum instead puts most elements beyond that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcase2019_task4_tpu.ops import fused_block as jfb
from dcase2019_task4_tpu.ops import packed_conv as jpc
from dcase2019_task4_tpu_torch.ops import fused_block as tfb
from dcase2019_task4_tpu_torch.ops import packed_conv as tpc

EPS = 1e-3
BF16 = torch.bfloat16


def _np(a):
    """A JAX or torch array as a float32 numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _bf16_values(a):
    """float32 numpy values rounded to bfloat16 (and held in float32)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16).to(torch.float32).numpy()


def _ulp(a):
    """The bfloat16 spacing at |a| (floored at the smallest normal)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126))) - 7)


def _within_ulps(got, want, what, extra=0.0):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    limit = _ulp(np.maximum(np.abs(got), np.abs(want))) + extra
    bad = np.abs(got - want) > limit
    assert not bad.any(), f"{what}: {bad.sum()} elements beyond one bfloat16 ulp, worst {np.abs(got - want).max()}"


def _close(got, want, rel, what):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30), err_msg=what)


# ------------------------------------------------------------------- K3


def _conv_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    C = shape[-1]
    lim = np.sqrt(2.0) * np.sqrt(6.0 / (18 * C))
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return (f(rng.uniform(-lim, lim, (3, 3, C, C))), f(0.1 * rng.standard_normal(C)),
            _bf16_values(rng.standard_normal(shape)), _bf16_values(rng.standard_normal(shape)))


# JAX packs no lanes at the scaled configuration's C = 128 (k = 1)
CONV_SHAPES = [(1, 16, 8, 128)]


@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv_forward_and_vjp_match_jax_interpret(shape):
    w, b, x, dy = _conv_inputs(shape, sum(shape))
    fn = lambda w_, b_, x_: jpc.conv2d_packed({"w": w_, "b": b_}, x_, compute_dtype=jnp.bfloat16,  # noqa: E731
                                              interpret=True)
    out_ref, vjp = jax.vjp(fn, jnp.asarray(w), jnp.asarray(b), jnp.asarray(x, jnp.bfloat16))
    dw_ref, db_ref, dx_ref = vjp(jnp.asarray(dy, jnp.bfloat16))
    wt, bt = torch.from_numpy(w).requires_grad_(True), torch.from_numpy(b).requires_grad_(True)
    xt = torch.from_numpy(x).to(BF16).requires_grad_(True)
    out = tpc.conv2d_packed({"w": wt, "b": bt}, xt)
    assert out.dtype == BF16 and out_ref.dtype == jnp.bfloat16
    _within_ulps(out, out_ref, "conv out")
    out.backward(torch.from_numpy(dy).to(BF16))
    assert xt.grad.dtype == BF16 and wt.grad.dtype == torch.float32
    _within_ulps(xt.grad, dx_ref, "dx")
    assert jpc.pack_factor(shape[2], shape[3]) == 1
    dw_ref = _np(dw_ref)
    np.testing.assert_allclose(_np(wt.grad), dw_ref, rtol=0, atol=2 * _ulp(np.abs(dw_ref).max()), err_msg="dW")
    _close(bt.grad, db_ref, 1e-5, "db")


# the flagship's C = 64, where JAX packs two frequency columns per row (k = 2):
# block 2's and block 3's frequency widths at a few clips
PACKED_SHAPES = [(1, 16, 8, 64), (1, 8, 4, 64)]


def _class_sums(x, dy, k):
    """The weight gradient's k output-frequency class sums (f ≡ c mod k), in
    float64: [k, 3, 3, C, C]."""
    x, dy = x.astype(np.float64), dy.astype(np.float64)
    B, T, F, C = x.shape
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    out = np.zeros((k, 3, 3, C, C))
    for c in range(k):
        d = np.zeros_like(dy)
        d[:, :, c::k] = dy[:, :, c::k]
        for dt in range(3):
            for df in range(3):
                out[c, dt, df] = np.einsum("btfi,btfo->io", xp[:, dt: dt + T, df: df + F], d)
    return out


@pytest.mark.parametrize("shape", PACKED_SHAPES)
def test_conv_vjp_at_two_lane_copies_matches_jax_interpret(shape):
    """Forward, dx and dW at C = 64 against `conv2d_packed` interpreted:
    dW = Σ over the two output-frequency classes of bf16(class sum)."""
    w, b, x, dy = _conv_inputs(shape, sum(shape) + 64)
    fn = lambda w_, b_, x_: jpc.conv2d_packed({"w": w_, "b": b_}, x_, compute_dtype=jnp.bfloat16,  # noqa: E731
                                              interpret=True)
    out_ref, vjp = jax.vjp(fn, jnp.asarray(w), jnp.asarray(b), jnp.asarray(x, jnp.bfloat16))
    dw_ref, db_ref, dx_ref = vjp(jnp.asarray(dy, jnp.bfloat16))
    k = jpc.pack_factor(shape[2], shape[3])
    assert k == 2
    wt, bt = torch.from_numpy(w).requires_grad_(True), torch.from_numpy(b).requires_grad_(True)
    xt = torch.from_numpy(x).to(BF16).requires_grad_(True)
    out = tpc.conv2d_packed({"w": wt, "b": bt}, xt)
    _within_ulps(out, out_ref, "conv out")
    out.backward(torch.from_numpy(dy).to(BF16))
    _within_ulps(xt.grad, dx_ref, "dx")
    _close(bt.grad, db_ref, 1e-5, "db")
    got, want = _np(wt.grad), _np(dw_ref)
    own = _ulp(np.maximum(np.abs(got), np.abs(want)))
    classes = np.abs(_class_sums(x, dy, k))
    limit = own + sum(_ulp(classes[c]) for c in range(k))
    diff = np.abs(got - want)
    assert not (diff > limit).any(), f"dW: {(diff > limit).sum()} elements beyond the class rule, worst {diff.max()}"
    share = (diff > own).mean()
    assert share <= 1e-3, f"dW: {share:.2e} of the elements beyond one bfloat16 ulp"
    assert tpc.pack_factor(shape[2], shape[3]) == k


@pytest.mark.parametrize("shape,k", [((1, 6, 4, 64), 2), ((1, 6, 4, 8), 1)])
def test_conv_wgrad_rounds_each_class_sum_in_bfloat16(shape, k):
    """bfloat16: dW is Σ over the k = pack_factor(F, C) output-frequency
    classes f mod k of bf16(class sum), added in class order (at k = 1 the
    sum rounded once); `conv2d_wgrad_parts` returns the class sums (1e-5 of
    their max against float64) beside the same dW. float32: the sum,
    unrounded, as one class."""
    _, _, x, dy = _conv_inputs(shape, 5)
    assert tpc.pack_factor(shape[2], shape[3]) == k
    xt, dyt = torch.from_numpy(x).to(BF16), torch.from_numpy(dy).to(BF16)
    dw, db, parts = tpc.conv2d_wgrad_parts(xt, dyt)
    assert parts.shape == (k,) + tuple(dw.shape) and parts.dtype == torch.float32
    _close(parts, _class_sums(x, dy, k), 1e-5, "class sums")
    assert torch.equal(dw, sum(p.to(BF16).float() for p in parts))
    got = tpc.conv2d_wgrad(xt, dyt)
    assert torch.equal(got[0], dw) and torch.equal(got[1], db)
    whole = parts.sum(0)
    assert torch.equal(dw, whole.to(BF16).float()) == (k == 1)
    dw32, db32, parts32 = tpc.conv2d_wgrad_parts(torch.from_numpy(x), torch.from_numpy(dy))
    assert parts32.shape == (1,) + tuple(dw.shape) and torch.equal(parts32[0], dw32)
    _close(dw32, _class_sums(x, dy, 1)[0], 1e-5, "float32 dW")
    _close(db32, db, 1e-6, "db")


def test_conv_wgrad_matches_the_jax_kernel_before_its_rounding():
    """The wgrad's own float32 sum (its one class at k = 1): JAX `_run_wgrad`,
    before the VJP rounds it to the weights' bfloat16."""
    shape = CONV_SHAPES[0]
    _, _, x, dy = _conv_inputs(shape, 7)
    B, T, F, C = shape
    dparts, db_ref = jpc._run_wgrad(jnp.asarray(x, jnp.bfloat16), jnp.asarray(dy, jnp.bfloat16), tt=jpc._pick_tile(T),
                                    F2=F, L=C, dtype=jnp.bfloat16, interpret=True)
    _, db, parts = tpc.conv2d_wgrad_parts(torch.from_numpy(x).to(BF16), torch.from_numpy(dy).to(BF16))
    dw = parts[0]  # one class at k = 1
    assert dw.dtype == db.dtype == torch.float32
    # dparts[dt, g + 1] holds w[dt, g + 1] at k = 1
    _close(dw, dparts, 1e-5, "dW")
    _close(db, db_ref, 1e-5, "db")


def test_conv_plain_versions_round_their_operands():
    """bfloat16 in, bfloat16 out; the weights enter as bfloat16 (a weight
    change below bfloat16's resolution changes nothing) and the sums are
    those of float32 arithmetic on the rounded operands."""
    w, b, x, dy = _conv_inputs((1, 6, 4, 8), 3)
    xt, wt = torch.from_numpy(x).to(BF16), torch.from_numpy(w)
    out = tpc.conv2d_forward({"w": wt, "b": torch.from_numpy(b)}, xt)
    assert out.dtype == BF16
    nudged = tpc.conv2d_forward({"w": wt.to(BF16).to(torch.float32) * (1 + 2.0 ** -12), "b": torch.from_numpy(b)}, xt)
    assert torch.equal(out, nudged)
    ref = torch.nn.functional.conv2d(xt.double().permute(0, 3, 1, 2), wt.to(BF16).double().permute(3, 2, 0, 1),
                                     torch.from_numpy(b).double(), padding=1).permute(0, 2, 3, 1)
    _within_ulps(out, ref.to(BF16), "conv against float64")
    dx = tpc.conv2d_dx(wt, torch.from_numpy(dy).to(BF16))
    assert dx.dtype == BF16
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tpc.conv2d_packed({"w": wt, "b": torch.from_numpy(b)}, xt.to(torch.float16))


# ------------------------------------------------------------------- K2


# scaled block geometries at a few channels: block 1 (a pooling row of 2 × 128
# pixels: the window-tiled gate), block 2, block 3 (pool (2, 8)); and the
# flagship's width, C = 64 at pool (2, 4)
BLOCKS = [((2, 16, 128, 16), (2, 4)), ((2, 8, 32, 16), (2, 4)), ((2, 16, 8, 16), (2, 8)), ((2, 8, 16, 64), (2, 4))]


def _block_inputs(shape, pool, seed):
    rng = np.random.default_rng(seed)
    C = shape[-1]
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    y = _bf16_values(0.3 + 1.5 * rng.standard_normal(shape))
    flat = y.reshape(-1, C).astype(np.float64)
    return dict(
        y=y, scale=f(1 + 0.1 * rng.standard_normal(C)), bias=f(0.1 * rng.standard_normal(C)),
        mean=f(flat.mean(0)), var=f(flat.var(0)), w=f(rng.standard_normal((C, C)) / np.sqrt(C)),
        b=f(0.1 * rng.standard_normal(C)),
        dout=_bf16_values(rng.standard_normal((shape[0], shape[1] // pool[0], shape[2] // pool[1], C))),
    )


VECS = ("scale", "bias", "mean", "var", "w", "b")


def _jax_interpret_mask(shape, seed, rate):
    """The keep-mask of the JAX kernel in interpret mode (`_dropout_mask`
    with interp=True), rebuilt: a murmur-style hash of the element's index
    in its [tt·F, C] tile (the same in the packed layout) and of seed + the
    tile's grid position b·nt + t."""
    B, T, F, C = shape
    tt = jfb._pick_tile(T, F, C)
    t, f, c = np.meshgrid(np.arange(T), np.arange(F), np.arange(C), indexing="ij")
    idx = (((t % tt) * F + f) * C + c).astype(np.uint32)
    out = np.empty(shape, np.float32)
    with np.errstate(over="ignore"):
        for b in range(B):
            sv = (seed + b * (T // tt) + t // tt).astype(np.uint32)
            x = idx ^ (sv * np.uint32(2654435761))
            x = (x ^ (x >> np.uint32(16))) * np.uint32(0x7FEB352D)
            x = (x ^ (x >> np.uint32(15))) * np.uint32(0x846CA68B)
            bits = x ^ (x >> np.uint32(16))
            out[b] = bits >= np.uint32(min(int(rate * 2 ** 32), 2 ** 32 - 1))
    return out


def _pool_slack(d, pool, mask=None, keep=1.0):
    """One bfloat16 ulp of each window's largest pt-row column sum over
    pt·pf: what one flipped rounding of a column sum moves the window mean
    by. The column sums come from the function in float64."""
    y = d["y"].astype(np.float64)
    xn = (y - d["mean"]) / np.sqrt(d["var"].astype(np.float64) + EPS) * d["scale"] + d["bias"]
    g = _bf16_values(xn).astype(np.float64) @ _bf16_values(d["w"]).astype(np.float64) + d["b"]
    g = g / (1.0 + np.exp(-xn))
    if mask is not None:
        g = g * mask / keep
    B, T, F, C = y.shape
    pt, pf = pool
    cols = g.reshape(B, T // pt, pt, F // pf, pf, C).sum(axis=2)
    return _ulp(np.abs(cols).max(axis=3)) / (pt * pf)


def _dw_slack(d, pool, mask=None, keep=1.0):
    """What one bfloat16 operand of K2's dW = Σ xnᵀ·dlin rounding the other
    way moves an element by: ulp(max|xn|)·max|dlin| + ulp(max|dlin|)·max|xn|."""
    y = d["y"].astype(np.float64)
    xn = (y - d["mean"]) / np.sqrt(d["var"].astype(np.float64) + EPS) * d["scale"] + d["bias"]
    pt, pf = pool
    dh = np.repeat(np.repeat(d["dout"], pt, axis=1), pf, axis=2) / (pt * pf)
    if mask is not None:
        dh = dh * mask / keep
    dlin = np.abs(dh / (1.0 + np.exp(-xn))).max()
    xmax = np.abs(xn).max()
    return _ulp(xmax) * dlin + _ulp(dlin) * xmax


def _jax_block(d, pool, seed, rate, train):
    return lambda y, scale, bias, w, b: jfb.fused_bn_glu_dropout_pool(
        y, scale, bias, jnp.asarray(d["mean"]), jnp.asarray(d["var"]), w, b, jnp.int32(seed), rate, pool, EPS,
        train, True)


@pytest.mark.parametrize("shape,pool", BLOCKS)
def test_fused_block_eval_forward_matches_jax_interpret(shape, pool):
    d = _block_inputs(shape, pool, sum(shape))
    ref = jfb.fused_bn_glu_dropout_pool(jnp.asarray(d["y"], jnp.bfloat16), *(jnp.asarray(d[k]) for k in VECS),
                                        jnp.int32(0), 0.0, pool, EPS, False, True)
    assert tfb.applicable(shape, pool)
    out = tfb.fused_bn_glu_pool(torch.from_numpy(d["y"]).to(BF16), *(torch.from_numpy(d[k]) for k in VECS), pool, EPS)
    assert out.dtype == BF16 and ref.dtype == jnp.bfloat16
    _within_ulps(out, ref, "pooled output", extra=_pool_slack(d, pool))


@pytest.mark.parametrize("shape,pool,rate", [(s, p, 0.0) for s, p in BLOCKS] + [(*BLOCKS[0], 0.5)])
def test_fused_block_train_vjp_matches_jax_interpret(shape, pool, rate):
    """Forward with dropout and the whole backward (both passes) against
    jax.vjp of the interpreted kernel; at rate 0.5 the JAX mask is handed to
    the port's plain versions."""
    d = _block_inputs(shape, pool, sum(shape) + 1)
    seed = 11
    fn = _jax_block(d, pool, seed, rate, True)
    args = (jnp.asarray(d["y"], jnp.bfloat16), *(jnp.asarray(d[k]) for k in ("scale", "bias", "w", "b")))
    out_ref, vjp = jax.vjp(fn, *args)
    dy_ref, dscale_ref, dbias_ref, dw_ref, db_ref = vjp(jnp.asarray(d["dout"], jnp.bfloat16))
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    y = t["y"].to(BF16)
    dout = t["dout"].to(BF16)
    if rate == 0.0:
        leaves = [y.clone().requires_grad_(True)] + [t[k].clone().requires_grad_(True) for k in ("scale", "bias", "w", "b")]
        out = tfb.fused_bn_glu_dropout_pool(leaves[0], leaves[1], leaves[2], t["mean"], t["var"], leaves[3], leaves[4],
                                            seed, rate, pool, EPS, True)
        out.backward(dout)
        grads = [v.grad for v in leaves]
        dyp = tfb.bwd_reduce(y, dout, t["scale"], t["bias"], t["mean"], t["var"], t["w"], t["b"], pool, EPS)[0]
        slack, dw_slack = _pool_slack(d, pool), _dw_slack(d, pool)
    else:
        mask_np = _jax_interpret_mask(shape, seed, rate)
        slack, dw_slack = _pool_slack(d, pool, mask_np, 1.0 - rate), _dw_slack(d, pool, mask_np, 1.0 - rate)
        mask = torch.from_numpy(mask_np)
        vec = [t[k] for k in VECS]
        out = tfb.reference_block(y, *vec, pool, EPS, mask, 1.0 - rate)
        dyp = tfb.bwd_reduce_reference(y, dout, *vec, pool, EPS, mask, 1.0 - rate)[0]
        grads = tfb.bwd_reference(y, dout, *vec, pool, EPS, mask, 1.0 - rate)
        grads = [grads[0], grads[1], grads[2], grads[3], grads[4]]
    assert out.dtype == grads[0].dtype == dyp.dtype == BF16
    _within_ulps(out, out_ref, "pooled output", extra=slack)
    _within_ulps(grads[0], dy_ref, "dy", extra=_ulp(_np(dyp)))
    for name, got, want in zip(("dscale", "dbias", "dw", "db"), grads[1:], (dscale_ref, dbias_ref, dw_ref, db_ref)):
        assert got.dtype == torch.float32, name
        want = _np(want)
        atol = 1e-5 * np.abs(want).max() + (dw_slack if name == "dw" else 0.0)
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("shape,pool", BLOCKS[:1])
def test_batch_stats_of_bfloat16_y_match_jax_interpret(shape, pool):
    d = _block_inputs(shape, pool, 5)
    mean_ref, var_ref = jfb.batch_stats(jnp.asarray(d["y"], jnp.bfloat16), pool[1], interpret=True)
    s, sq = tfb.batch_stats(torch.from_numpy(d["y"]).to(BF16))
    assert s.dtype == sq.dtype == torch.float32
    n = np.prod(shape[:3])
    _close(s / n, mean_ref, 1e-5, "mean")
    _close(sq / n - (s / n) ** 2, var_ref, 1e-5, "var")


def test_window_tiled_gate():
    """Block 1 of the scaled configuration ([B, 864, 128, 128], pool (2, 4):
    a pooling row of 256 pixels) is taken in tiles of whole windows; a
    window above one tile is not."""
    assert tfb.applicable((24, 864, 128, 128), (2, 4))
    assert tfb.applicable((24, 216, 8, 128), (2, 8))
    assert not tfb.applicable((2, 32, 32, 16), (16, 16))
    assert not tfb.applicable((2, 16, 128, 16), (2, 3))
