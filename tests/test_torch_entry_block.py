"""Port parity: K5, the fused first block (conv → BN → GLU → dropout → pool).

The same numpy-seeded inputs go through the JAX package's
ops/fused_entry_block.py (Pallas kernels in interpret mode, as
tests/test_fused_entry_block.py runs them, at its shape B, T, F, C = 2, 24,
8, 64) and through the port's, which on CPU tensors runs its plain
versions. Tolerances: statistics rtol 1e-5 atol 1e-4; eval forward and
train forward at rate 0 1e-5; gradients of conv, scale, bias, glu_w, glu_b
at rate 0 with batch statistics rtol 1e-4 atol 1e-4 (d conv_b is rounding
noise under through-statistics BatchNorm, so the atol is what holds it).
The two packages' dropout masks differ by design, so train mode is compared
across packages at rate 0 only; inside the port the block with rate 0.5 and
a seed must equal conv2d → fused block with that seed (one Philox mask).
The CRNN under `entry_block_pallas`: eval 2e-5, train mode at dropout 0
3e-5, BatchNorm buffers 1e-5 against the JAX CRNN with the same flag.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcase2019_task4_tpu.config import ModelConfig
from dcase2019_task4_tpu.models import crnn as jcrnn
from dcase2019_task4_tpu.ops import fused_entry_block as jfe
from dcase2019_task4_tpu_torch.models import crnn as tcrnn
from dcase2019_task4_tpu_torch.models import layers as TL
from dcase2019_task4_tpu_torch.ops import fused_block as tfb
from dcase2019_task4_tpu_torch.ops import fused_entry_block as tfe
from dcase2019_task4_tpu_torch.train import checkpoints as tckpt

B, T, F, C = 2, 24, 8, 64
POOL = (2, 4)
EPS = 1e-3
SEED = 11
NAMES = ("w", "b", "scale", "bias", "gw", "gb")


def _inputs(seed=0, shape=(B, T, F), channels=C):
    rng = np.random.default_rng(seed)
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(
        x=f(rng.standard_normal(shape + (1,))),
        w=f(rng.standard_normal((3, 3, 1, channels)) * 0.3),
        b=f(rng.standard_normal(channels) * 0.1),
        scale=f(rng.uniform(0.5, 1.5, channels)),
        bias=f(rng.standard_normal(channels) * 0.1),
        gw=f(rng.standard_normal((channels, channels)) * 0.1),
        gb=f(rng.standard_normal(channels) * 0.1),
        ct=f(rng.standard_normal((shape[0], shape[1] // POOL[0], shape[2] // POOL[1], channels))),
        run_mean=f(0.2 * rng.standard_normal(channels)),
        run_var=f(rng.uniform(0.5, 2.0, channels)),
    )


def _t(d, *names, grad=False):
    return [torch.from_numpy(d[n]).requires_grad_(grad) for n in names]


def _j(d, *names):
    return [jnp.asarray(d[n]) for n in names]


def _moments(s, sq, n):
    mean = s / n
    return mean, sq / n - mean * mean


def _jax_loss(d, rate_train):
    """Σ(block · ct) through the JAX package's kernels (interpret), the batch
    statistics from its statistics kernel and detached, as its CRNN does."""
    x, ct = jnp.asarray(d["x"]), jnp.asarray(d["ct"])
    n = x.shape[0] * x.shape[1] * x.shape[2]

    def loss(args):
        w, b, scale, bias, gw, gb = args
        conv = {"w": w, "b": b}
        s, sq = jfe.entry_block_stats_apply(conv, x, interpret=True)
        mean, var = _moments(s, sq, n)
        out = jfe.entry_block_apply(conv, scale, bias, jax.lax.stop_gradient(mean), jax.lax.stop_gradient(var),
                                    gw, gb, x, jnp.int32(SEED), 0.0, POOL, EPS, rate_train, interpret=True)
        return jnp.sum(out * ct)

    return loss


def _port_out(d, leaves, rate, train, seed=SEED, apply=None, stats_apply=None):
    """The port's block with batch statistics from its statistics pass."""
    w, b, scale, bias, gw, gb = leaves
    x = torch.from_numpy(d["x"])
    conv = {"w": w, "b": b}
    s, sq = (stats_apply or tfe.entry_block_stats_apply)(conv, x)
    assert not s.requires_grad and not sq.requires_grad
    mean, var = _moments(s, sq, x.shape[0] * x.shape[1] * x.shape[2])
    return (apply or tfe.entry_block_apply)(conv, scale, bias, mean, var, gw, gb, x, seed, rate, POOL, EPS, train)


def test_applicable_gate():
    assert tfe.entry_block_applicable((2, 24, 8, 1), (2, 4)) and jfe.entry_block_applicable((2, 24, 8, 1), (2, 4))
    assert tfe.entry_block_applicable((24, 864, 64, 1), (2, 4))
    assert not tfe.entry_block_applicable((2, 25, 8, 1), (2, 4))  # T % pt
    assert not tfe.entry_block_applicable((2, 24, 9, 1), (2, 4))  # F % pf
    assert not tfe.entry_block_applicable((2, 24, 8, 2), (2, 4))  # two input channels
    assert not tfe.entry_block_applicable((2, 24, 128, 1), (2, 4))  # a pooling row exceeds the pixel tile
    assert not tfe.entry_block_applicable((2, 24, 8, 1), (2, 4), channels=6)
    # the TPU's parity packing (even F and pf) does not bind the Hopper kernel
    assert tfe.entry_block_applicable((2, 24, 9, 1), (2, 3)) and not jfe.entry_block_applicable((2, 24, 9, 1), (2, 3))


def test_stats_match_jax_interpret():
    d = _inputs(1)
    s_ref, sq_ref = jfe.entry_block_stats_apply({"w": jnp.asarray(d["w"]), "b": jnp.asarray(d["b"])},
                                                jnp.asarray(d["x"]), interpret=True)
    s, sq = tfe.entry_block_stats_apply(dict(zip("wb", _t(d, "w", "b"))), torch.from_numpy(d["x"]))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(sq.numpy(), np.asarray(sq_ref), rtol=1e-5, atol=1e-4)


def test_eval_forward_matches_jax_interpret():
    d = _inputs(2)
    w, b, scale, bias, gw, gb = _j(d, *NAMES)
    want = jfe.entry_block_apply({"w": w, "b": b}, scale, bias, *_j(d, "run_mean", "run_var"), gw, gb,
                                 jnp.asarray(d["x"]), jnp.int32(SEED), 0.0, POOL, EPS, False, interpret=True)
    w, b, scale, bias, gw, gb = _t(d, *NAMES)
    got = tfe.entry_block_apply({"w": w, "b": b}, scale, bias, *_t(d, "run_mean", "run_var"), gw, gb,
                                torch.from_numpy(d["x"]), SEED, 0.5, POOL, EPS, False)  # eval ignores the rate
    assert got.shape == (B, T // 2, F // 4, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_train_forward_and_gradients_at_rate_0_match_jax_interpret():
    d = _inputs(3)
    loss = _jax_loss(d, True)
    want_loss = float(loss(tuple(_j(d, *NAMES))))
    want = jax.grad(loss)(tuple(_j(d, *NAMES)))
    leaves = _t(d, *NAMES, grad=True)
    out = _port_out(d, leaves, 0.0, True)
    got_loss = (out * torch.from_numpy(d["ct"])).sum()
    got_loss.backward()
    assert abs(got_loss.item() - want_loss) <= 1e-5 * max(1.0, abs(want_loss))
    for name, leaf, ref in zip(NAMES, leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4, err_msg=name)


def test_train_forward_at_rate_0_matches_jax_elementwise():
    d = _inputs(4)
    x = jnp.asarray(d["x"])
    w, b, scale, bias, gw, gb = _j(d, *NAMES)
    s, sq = jfe.entry_block_stats_apply({"w": w, "b": b}, x, interpret=True)
    mean, var = _moments(s, sq, B * T * F)
    want = jfe.entry_block_apply({"w": w, "b": b}, scale, bias, mean, var, gw, gb, x, jnp.int32(SEED),
                                 0.0, POOL, EPS, True, interpret=True)
    got = _port_out(d, _t(d, *NAMES), 0.0, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("shape,channels", [((2, 24, 8), 64), ((3, 6, 16), 16), ((1, 8, 64), 8)])
def test_block_with_a_seed_equals_conv2d_then_fused_block_with_that_seed(shape, channels, rate):
    """Same Philox mask, keyed on (seed, element index of [B, T, F, C]):
    forward and every parameter gradient of the fused entry block equal
    those of F.conv2d → fused_bn_glu_dropout_pool (1e-5 of each leaf's max,
    d conv_b above a floor of 1e-6 of the largest gradient: it cancels to
    rounding noise under through-statistics BatchNorm)."""
    d = _inputs(5 + shape[1], shape, channels)
    ct = torch.from_numpy(d["ct"])
    leaves = _t(d, *NAMES, grad=True)
    out = _port_out(d, leaves, rate, True)
    (out * ct).sum().backward()
    got = [leaf.grad.clone() for leaf in leaves]

    w, b, scale, bias, gw, gb = _t(d, *NAMES, grad=True)
    y = TL.conv2d(w.permute(3, 2, 0, 1), b, torch.from_numpy(d["x"]))
    s, sq = tfb.batch_stats(y)
    mean, var = _moments(s, sq, y.numel() // channels)
    ref = tfb.fused_bn_glu_dropout_pool(y, scale, bias, mean, var, gw, gb, SEED, rate, POOL, EPS, True)
    (ref * ct).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), rtol=0, atol=1e-5)
    if rate:
        assert not torch.allclose(out, _port_out(d, _t(d, *NAMES), rate, True, seed=SEED + 1))
    top = max(leaf.grad.abs().max().item() for leaf in (w, b, scale, bias, gw, gb))
    for name, g, leaf in zip(NAMES, got, (w, b, scale, bias, gw, gb)):
        limit = 1e-5 * leaf.grad.abs().max().item() + (1e-6 * top if name == "b" else 0.0)
        assert (g - leaf.grad).abs().max().item() <= limit, name


@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_written_out_backward_matches_autograd_with_statistics_in_the_graph(rate):
    """`entry_block_bwd_reference` and the two pass references (formulas, no
    autograd) against torch.autograd through the plain forward with mean and
    var as functions of the conv output."""
    d = _inputs(6)
    x, ct = torch.from_numpy(d["x"]), torch.from_numpy(d["ct"])
    leaves = _t(d, *NAMES, grad=True)
    w, b, scale, bias, gw, gb = leaves
    y = tfe._conv(x, w, b)
    flat = y.reshape(-1, C)
    mean = flat.mean(0)
    var = (flat * flat).mean(0) - mean * mean
    mask = tfb.dropout_keep_mask(SEED, y.shape, rate) if rate else None
    (tfb.reference_block(y, scale, bias, mean, var, gw, gb, POOL, EPS, mask, 1.0 - rate) * ct).sum().backward()
    want = dict(zip(NAMES, (leaf.grad for leaf in leaves)))
    det = [leaf.detach() for leaf in leaves]
    args = (x, ct, det[0], det[1], det[2], det[3], mean.detach(), var.detach(), det[4], det[5])
    dw, dcb, dscale, dbias, dgw, dgb = tfe.entry_block_bwd_reference(*args, POOL, EPS, mask, 1.0 - rate)
    top = max(g.abs().max().item() for g in want.values())
    for name, got in zip(NAMES, (dw, dcb, dscale, dbias, dgw, dgb)):
        limit = 1e-5 * want[name].abs().max().item() + (1e-6 * top if name == "b" else 0.0)
        assert (got - want[name]).abs().max().item() <= limit, name
    # the two passes with the host-side step between them
    dgw1, dgb1, s1, s2 = tfe.entry_block_bwd_reduce_reference(*args, POOL, EPS, mask, 1.0 - rate)
    a, b2 = tfb.bwd_coefficients(det[2], var.detach(), EPS, s1, s2, B * T * F)
    dw2, dcb2 = tfe.entry_block_bwd_wgrad_reference(*args, a, b2, POOL, EPS, mask, 1.0 - rate)
    for got, ref in ((dgw1, dgw), (dgb1, dgb), (s2, dscale), (s1, dbias), (dw2, dw), (dcb2, dcb)):
        assert torch.equal(got, ref)


def test_kernel_wrappers_run_their_plain_versions_on_cpu_tensors():
    d = _inputs(7)
    x, ct = torch.from_numpy(d["x"]), torch.from_numpy(d["ct"])
    w, b, scale, bias, gw, gb = _t(d, *NAMES)
    mean, var = _t(d, "run_mean", "run_var")
    before = (tfe.entry_block_fwd.launches_eval, tfe.entry_block_fwd.launches_train,
              tfe.entry_block_bwd_reduce.launches, tfe.entry_block_bwd_wgrad.launches,
              tfe.entry_block_stats_apply.launches)
    out = tfe.entry_block_fwd(x, w, b, scale, bias, mean, var, gw, gb, POOL, EPS, rate=0.5, seed=SEED)
    mask = tfb.dropout_keep_mask(SEED, (B, T, F, C), 0.5)
    assert torch.equal(out, tfe.reference_entry_block(x, w, b, scale, bias, mean, var, gw, gb, POOL, EPS, mask, 0.5))
    red = tfe.entry_block_bwd_reduce(x, ct, w, b, scale, bias, mean, var, gw, gb, POOL, EPS, rate=0.5, seed=SEED)
    ref = tfe.entry_block_bwd_reduce_reference(x, ct, w, b, scale, bias, mean, var, gw, gb, POOL, EPS, mask, 0.5)
    assert all(torch.equal(g, r) for g, r in zip(red, ref))
    a, b2 = tfb.bwd_coefficients(scale, var, EPS, red[2], red[3], B * T * F)
    got = tfe.entry_block_bwd_wgrad(x, ct, w, b, scale, bias, mean, var, gw, gb, a, b2, POOL, EPS, rate=0.5, seed=SEED)
    ref = tfe.entry_block_bwd_wgrad_reference(x, ct, w, b, scale, bias, mean, var, gw, gb, a, b2, POOL, EPS, mask, 0.5)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    # no kernel was launched for CPU tensors
    assert before == (tfe.entry_block_fwd.launches_eval, tfe.entry_block_fwd.launches_train,
                      tfe.entry_block_bwd_reduce.launches, tfe.entry_block_bwd_wgrad.launches,
                      tfe.entry_block_stats_apply.launches)


def test_refusals():
    d = _inputs(8)
    w, b, scale, bias, gw, gb = _t(d, *NAMES)
    mean, var = _t(d, "run_mean", "run_var")
    x = torch.from_numpy(d["x"])
    conv = {"w": w, "b": b}
    with pytest.raises(ValueError, match="detached"):
        tfe.entry_block_apply(conv, scale, bias, mean.clone().requires_grad_(True), var, gw, gb, x, 0, 0.0, POOL, EPS, True)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tfe.entry_block_apply(conv, scale, bias, mean, var, gw, gb, x, 0, 0.0, POOL, EPS, True, compute_dtype="float16")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tfe.entry_block_stats_apply(conv, x, compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="layout"):
        tfe.entry_block_apply(conv, scale, bias, mean, var, gw, gb, x, 0, 0.0, POOL, EPS, True, layout="rows")
    with pytest.raises(ValueError, match="does not take"):
        tfe.entry_block_fwd(x[:, :23], w, b, scale, bias, mean, var, gw, gb, POOL, EPS)
    with pytest.raises(ValueError, match="rate"):
        tfe.entry_block_fwd(x, w, b, scale, bias, mean, var, gw, gb, POOL, EPS, rate=1.0)
    with pytest.raises(ValueError, match="pooled shape"):
        tfe.entry_block_bwd_reduce(x, torch.zeros(B, T, F, C), w, b, scale, bias, mean, var, gw, gb, POOL, EPS)


# ----------------------------------------------------- the dropout mask


@pytest.mark.parametrize("rate", [0.5, 0.25])
def test_dropout_keep_mask_statistics(rate):
    """Distribution of the mask every fused kernel applies (the plain
    version is bit-equal to the kernels'): the comparisons above share the
    mask on both sides and could not catch a broken generator. Keep rate
    within 5σ, row quarters pairwise decorrelated, different seeds differ."""
    R, L, NT = 512, 128, 4
    m = tfb.dropout_mask(77, (NT, R, L), rate, "cpu").numpy()
    assert set(np.unique(m)) <= {0.0, 1.0}
    assert abs(m.mean() - (1.0 - rate)) < 5.0 * np.sqrt(rate * (1 - rate) / m.size)
    q = m.reshape(NT, 4, R // 4, L)
    for i in range(4):
        for j in range(i + 1, 4):
            c = np.corrcoef(q[:, i].ravel(), q[:, j].ravel())[0, 1]
            assert abs(c) < 0.02, (i, j, c)
    # the four words of one Philox call mask four neighbouring channels
    words = m.reshape(-1, 4)
    for i in range(4):
        for j in range(i + 1, 4):
            assert abs(np.corrcoef(words[:, i], words[:, j])[0, 1]) < 0.02
    for t in range(1, NT):  # one seed: distinct parts of the counter range differ
        assert np.any(m[0] != m[t])
    other = tfb.dropout_mask(78, (NT, R, L), rate, "cpu").numpy()
    assert abs((m != other).mean() - 2 * rate * (1 - rate)) < 0.01  # independent masks


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
    model.load_state_dict(tckpt.params_from_jax(params, state))
    return model


def _spy(module, name, calls):
    real = getattr(module, name)

    def wrapped(*a, **kw):
        calls.append(name)
        return real(*a, **kw)

    setattr(module, name, wrapped)
    return real


def test_crnn_eval_matches_jax_with_the_flag():
    cfg = _cfg(entry_block_pallas=True)
    params, state = _jax_weights(cfg, 1)
    x = np.random.default_rng(1).standard_normal((2, TM, 64)).astype(np.float32)
    s_ref, w_ref, _ = jcrnn.CRNN(cfg).apply(params, state, jnp.asarray(x), train=False)
    strong, weak = _port(cfg, params, state).eval()(torch.from_numpy(x))
    np.testing.assert_allclose(strong.numpy(), np.asarray(s_ref), rtol=0, atol=2e-5)
    np.testing.assert_allclose(weak.numpy(), np.asarray(w_ref), rtol=0, atol=2e-5)


def test_crnn_train_mode_matches_jax_with_the_flag():
    cfg = _cfg(entry_block_pallas=True, dropout=0.0)
    params, state = _jax_weights(cfg, 2)
    x = np.random.default_rng(2).standard_normal((2, TM, 64)).astype(np.float32) * 2.0 + 0.5
    s_ref, w_ref, bn_ref = jcrnn.CRNN(cfg).apply(params, state, jnp.asarray(x), train=True,
                                                 rng=jax.random.PRNGKey(0))
    net = _port(cfg, params, state).train()
    strong, weak = net(torch.from_numpy(x), torch.Generator().manual_seed(0))
    np.testing.assert_allclose(strong.detach().numpy(), np.asarray(s_ref), rtol=0, atol=3e-5)
    np.testing.assert_allclose(weak.detach().numpy(), np.asarray(w_ref), rtol=0, atol=3e-5)
    _, bn = tckpt.params_to_jax(net)
    for got, want in zip(jax.tree.leaves(bn), jax.tree.leaves(bn_ref)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("train", [False, True])
def test_crnn_with_the_flag_equals_the_port_without_it(train):
    """Dropout 0.5 from one generator seed: the first block draws its seed at
    the same place in the stream, so outputs, BatchNorm buffers and every
    gradient agree with the default path; the flag's path goes through the
    entry block's entries (in eval mode its op, which calls the K5f wrapper
    `entry_block_fwd`) and never through F.conv2d or K2 for block 1."""
    cfg = dataclasses.replace(_cfg(entry_block_pallas=True), nb_filters=(16, 16, 16), n_rnn_cell=16)
    base = tcrnn.seeded_init_(tcrnn.CRNN(cfg), 3)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, TM, 64)).astype(np.float32))
    results = []
    for flag in (True, False):
        net = tcrnn.CRNN(dataclasses.replace(cfg, entry_block_pallas=flag)).train(train)
        net.load_state_dict(base.state_dict())
        calls = []
        real = [(tfe, n, _spy(tfe, n, calls)) for n in ("entry_block_stats_apply", "entry_block_apply",
                                                        "entry_block_fwd")]
        real.append((tfb, "batch_stats", _spy(tfb, "batch_stats", calls)))
        real.append((TL, "conv2d", _spy(TL, "conv2d", calls)))
        try:
            strong, weak = net(x, torch.Generator().manual_seed(7))
        finally:
            for module, name, fn in real:
                setattr(module, name, fn)
        grads = []
        if train:
            (strong.sum() + weak.sum()).backward()
            grads = [p.grad.clone() for p in net.parameters()]
        results.append((strong.detach(), weak.detach(), grads, [b.clone() for b in net.buffers()], calls))
    (s1, w1, g1, b1, calls1), (s0, w0, g0, b0, calls0) = results
    if train:
        assert calls1 == ["entry_block_stats_apply", "entry_block_apply", "entry_block_fwd", "batch_stats",
                          "batch_stats"]
        assert calls0 == ["conv2d", "batch_stats", "batch_stats", "batch_stats"]
    else:
        assert calls1 == ["entry_block_fwd"] and calls0 == ["conv2d"]
    assert torch.allclose(s1, s0, atol=2e-6) and torch.allclose(w1, w0, atol=2e-6)
    for a, b in zip(b1, b0):
        assert torch.allclose(a, b, atol=1e-6)
    if train:
        top = max(g.abs().max().item() for g in g0)
        for a, b in zip(g1, g0):
            assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item() + 1e-6 * top


def test_gate_falls_through_to_the_default_path():
    """Where the gate says a shape does not apply (an odd number of frames
    under a time pool of 2), the default path runs, as in the JAX model; with
    16 filters the crows gate (64) does not apply either, and the planes
    entry takes the block (in eval mode through its op, which calls the K5f
    wrapper `entry_block_fwd` in the planes layout)."""
    cfg = dataclasses.replace(_cfg(entry_block_pallas=True, entry_block_crows=True), nb_filters=(16, 16, 16),
                              n_rnn_cell=16)
    net = tcrnn.seeded_init_(tcrnn.CRNN(cfg), 4).eval()
    calls = []
    real = [(tfe, "entry_block_fwd", _spy(tfe, "entry_block_fwd", calls)), (TL, "conv2d", _spy(TL, "conv2d", calls))]
    try:
        net(torch.zeros(1, TM, 64))
        assert calls == ["entry_block_fwd"]
        net(torch.zeros(1, TM + 1, 64))
        assert calls == ["entry_block_fwd", "conv2d"]
    finally:
        for module, name, fn in real:
            setattr(module, name, fn)


def test_checkpoint_leaves_are_the_same_with_and_without_the_flag(tmp_path):
    """The parameters are the same under every first-block configuration: a
    checkpoint written from a model with the flag has the leaves of one
    without, and loads into either."""
    small = dict(nb_filters=(16, 16, 16), n_rnn_cell=16)
    with_flag = tcrnn.seeded_init_(tcrnn.CRNN(_cfg(entry_block_pallas=True, **small)), 5)
    without = tcrnn.CRNN(_cfg(**small))
    assert [(k, tuple(v.shape)) for k, v in with_flag.state_dict().items()] == \
           [(k, tuple(v.shape)) for k, v in without.state_dict().items()]
    params, bn_state = tckpt.params_to_jax(with_flag)
    path = str(tmp_path / "model.npz")
    tckpt.save_inference_checkpoint(path, params, bn_state, {"config": {"model": {"entry_block_pallas": True}}})
    assert tckpt.read_metadata(path)["config"]["model"]["entry_block_pallas"] is True
    p2, s2 = tckpt.load_inference_state(path)
    without.load_state_dict(tckpt.params_from_jax(p2, s2))
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, TM, 64)).astype(np.float32))
    a, b = with_flag.eval()(x), without.eval()(x)
    assert torch.allclose(a[0], b[0], atol=2e-6) and torch.allclose(a[1], b[1], atol=2e-6)
