"""Port parity: K6, the first block under `entry_block_crows`.

The JAX package's ops/crows_block.py is the same four functions as its
ops/fused_entry_block.py in another TPU layout (channels on sublanes, the
batch in halves); the port dispatches both to one kernel family. The same
numpy-seeded inputs go through the JAX crows kernels (interpret mode, as
tests/test_crows_block.py runs them, at its shape B, T, F, C = 4, 16, 64,
64) and through the port's `crows_*` entries, which on CPU tensors run the
plain versions. Tolerances: statistics (as mean and variance) rtol 1e-4
atol 1e-5; eval forward and train forward at rate 0 1e-5; gradients of
conv, scale, bias, glu_w, glu_b at rate 0 with batch statistics rtol 1e-4
atol 1e-4 (d conv_b is rounding noise against rounding noise). The CRNN
under the flag: eval 2e-5, train mode at dropout 0 3e-5, BatchNorm buffers
1e-5 against the JAX CRNN with the same flag.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcase2019_task4_tpu.config import ModelConfig
from dcase2019_task4_tpu.models import crnn as jcrnn
from dcase2019_task4_tpu.ops import crows_block as jcr
from dcase2019_task4_tpu_torch.models import crnn as tcrnn
from dcase2019_task4_tpu_torch.ops import crows_block as tcr
from dcase2019_task4_tpu_torch.ops import fused_entry_block as tfe
from dcase2019_task4_tpu_torch.train import checkpoints as tckpt

B, T, F, C = 4, 16, 64, 64
POOL = (2, 4)
EPS = 1e-3
SEED = 17
NAMES = ("w", "b", "scale", "bias", "gw", "gb")


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(
        x=f(rng.standard_normal((B, T, F, 1))),
        w=f(rng.standard_normal((3, 3, 1, C)) * 0.2),
        b=f(rng.standard_normal(C) * 0.1),
        scale=f(rng.uniform(0.5, 1.5, C)),
        bias=f(rng.standard_normal(C) * 0.1),
        gw=f(rng.standard_normal((C, C)) * 0.1),
        gb=f(rng.standard_normal(C) * 0.1),
        ct=f(rng.standard_normal((B, T // POOL[0], F // POOL[1], C))),
        run_mean=f(0.2 * rng.standard_normal(C)),
        run_var=f(rng.uniform(0.5, 2.0, C)),
    )


def _t(d, *names, grad=False):
    return [torch.from_numpy(d[n]).requires_grad_(grad) for n in names]


def _j(d, *names):
    return [jnp.asarray(d[n]) for n in names]


def _moments(s, sq):
    mean = s / (B * T * F)
    return mean, sq / (B * T * F) - mean * mean


def _jax_out(d, args, train, mean_var=None):
    w, b, scale, bias, gw, gb = args
    conv, x = {"w": w, "b": b}, jnp.asarray(d["x"])
    if mean_var is None:
        s, sq = jcr.crows_stats_apply(conv, x, compute_dtype=jnp.float32, interpret=True)
        mean_var = tuple(jax.lax.stop_gradient(v) for v in _moments(s, sq))
    return jcr.crows_apply(conv, scale, bias, *mean_var, gw, gb, x, jnp.int32(SEED), 0.0, POOL, EPS, train,
                           compute_dtype=jnp.float32, interpret=True)


def _port_out(d, leaves, rate, train, mean_var=None, seed=SEED):
    w, b, scale, bias, gw, gb = leaves
    conv, x = {"w": w, "b": b}, torch.from_numpy(d["x"])
    if mean_var is None:
        mean_var = _moments(*tcr.crows_stats_apply(conv, x))
    return tcr.crows_apply(conv, scale, bias, *mean_var, gw, gb, x, seed, rate, POOL, EPS, train)


def test_applicable_gate():
    """The function-level conditions of the original, one by one."""
    shape = (B, T, F, 1)
    assert tcr.crows_applicable(shape, POOL) and jcr.crows_applicable(shape, POOL)
    for bad_shape, bad_pool in (((3, T, F, 1), POOL), ((B, T, 32, 1), POOL), ((B, T, F, 1), (4, 2)),
                                ((B, T + 1, F, 1), POOL), ((B, T, F, 2), POOL), ((B, T, F, 1), (2, 3))):
        assert not tcr.crows_applicable(bad_shape, bad_pool)
        assert not jcr.crows_applicable(bad_shape, bad_pool)
    assert tcr.crows_applicable((24, 864, 64, 1), POOL) and jcr.crows_applicable((24, 864, 64, 1), POOL)
    # the original's lane-tile search is TPU tiling: 2·4099 frames have no legal tile there
    assert tcr.crows_applicable((2, 8198, 64, 1), POOL) and not jcr.crows_applicable((2, 8198, 64, 1), POOL)
    with pytest.raises(ValueError, match="does not take"):
        d = _inputs(0)
        _port_out(dict(d, x=d["x"][:3]), _t(d, *NAMES), 0.0, False, _t(d, "run_mean", "run_var"))


def test_stats_match_jax_interpret():
    d = _inputs(1)
    s_ref, sq_ref = jcr.crows_stats_apply({"w": jnp.asarray(d["w"]), "b": jnp.asarray(d["b"])}, jnp.asarray(d["x"]),
                                          compute_dtype=jnp.float32, interpret=True)
    s, sq = tcr.crows_stats_apply(dict(zip("wb", _t(d, "w", "b"))), torch.from_numpy(d["x"]))
    for got, want in zip(_moments(s, sq), _moments(s_ref, sq_ref)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_jax_interpret(train):
    d = _inputs(2)
    stats = None if train else ("run_mean", "run_var")
    want = _jax_out(d, _j(d, *NAMES), train, None if train else tuple(_j(d, *stats)))
    got = _port_out(d, _t(d, *NAMES), 0.0 if train else 0.5, train, None if train else _t(d, *stats))
    assert got.shape == (B, T // 2, F // 4, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_gradients_at_rate_0_match_jax_interpret():
    d = _inputs(3)
    ct = jnp.asarray(d["ct"])
    want = jax.grad(lambda args: jnp.sum(_jax_out(d, args, True) * ct))(tuple(_j(d, *NAMES)))
    leaves = _t(d, *NAMES, grad=True)
    (_port_out(d, leaves, 0.0, True) * torch.from_numpy(d["ct"])).sum().backward()
    for name, leaf, ref in zip(NAMES, leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4, err_msg=name)


def test_crows_and_planes_entries_are_one_function():
    """Both flags reach the same kernels: same outputs and gradients bit for
    bit, dropout on, from the same seed; another seed gives another mask."""
    d = _inputs(4)
    ct = torch.from_numpy(d["ct"])
    outs = []
    for module_apply, stats in ((tcr.crows_apply, tcr.crows_stats_apply),
                                (tfe.entry_block_apply, tfe.entry_block_stats_apply)):
        leaves = _t(d, *NAMES, grad=True)
        w, b, scale, bias, gw, gb = leaves
        conv, x = {"w": w, "b": b}, torch.from_numpy(d["x"])
        out = module_apply(conv, scale, bias, *_moments(*stats(conv, x)), gw, gb, x, SEED, 0.5, POOL, EPS, True)
        (out * ct).sum().backward()
        outs.append([out.detach()] + [leaf.grad for leaf in leaves])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert not torch.equal(outs[0][0], _port_out(d, _t(d, *NAMES), 0.5, True, seed=SEED + 3))
    assert torch.equal(outs[0][0], _port_out(d, _t(d, *NAMES), 0.5, True))  # deterministic per seed


def test_counters_stay_put_on_cpu_tensors():
    d = _inputs(5)
    names = ("launches_eval", "launches_train", "launches_bwd_reduce", "launches_bwd_wgrad")
    before = [getattr(tcr.crows_apply, n) for n in names] + [tcr.crows_stats_apply.launches]
    leaves = _t(d, *NAMES, grad=True)
    _port_out(d, leaves, 0.5, True).sum().backward()
    assert before == [getattr(tcr.crows_apply, n) for n in names] + [tcr.crows_stats_apply.launches]
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tcr.crows_stats_apply(dict(zip("wb", _t(d, "w", "b"))), torch.from_numpy(d["x"]), compute_dtype="float16")
    tcr.crows_stats_apply(dict(zip("wb", _t(d, "w", "b"))), torch.from_numpy(d["x"]), compute_dtype="bfloat16")
    assert before == [getattr(tcr.crows_apply, n) for n in names] + [tcr.crows_stats_apply.launches]


@pytest.mark.parametrize("through_crows", [True, False])
def test_launch_sites_see_which_entry_a_call_came_through(monkeypatch, through_crows):
    """A kernel wrapper counts a launch on the crows entry too when the call
    came through it: the statistics, the forward, and both backward passes,
    which run after `crows_apply` has returned. Outside such a call the tag
    is clear, and a call through the planes entry never sets it."""
    d = _inputs(6)
    seen, reduce = [], tfe.entry_block_bwd_reduce
    for name in ("entry_block_fwd", "entry_block_bwd_reduce", "entry_block_bwd_wgrad"):
        real = getattr(tfe, name)
        monkeypatch.setattr(tfe, name, lambda *a, _fn=real, _n=name, **kw: (seen.append((_n, tfe._entry)), _fn(*a, **kw))[1])
    leaves = _t(d, *NAMES, grad=True)
    w, b, scale, bias, gw, gb = leaves
    conv, x = {"w": w, "b": b}, torch.from_numpy(d["x"])
    stats, apply = (tcr.crows_stats_apply, tcr.crows_apply) if through_crows else \
        (tfe.entry_block_stats_apply, tfe.entry_block_apply)
    out = apply(conv, scale, bias, *_moments(*stats(conv, x)), gw, gb, x, SEED, 0.5, POOL, EPS, True)
    assert tfe._entry is None
    out.sum().backward()
    assert tfe._entry is None
    entry = tcr.crows_apply if through_crows else None
    assert seen == [(n, entry) for n in ("entry_block_fwd", "entry_block_bwd_reduce", "entry_block_bwd_wgrad")]
    # the counting itself: both counts rise inside, the wrapper's alone outside
    before = (reduce.launches, tcr.crows_apply.launches_bwd_reduce)
    with tfe.called_through(tcr.crows_apply):
        tfe._tally(reduce, "launches", "launches_bwd_reduce")
    tfe._tally(reduce, "launches", "launches_bwd_reduce")
    after = (reduce.launches, tcr.crows_apply.launches_bwd_reduce)
    reduce.launches, tcr.crows_apply.launches_bwd_reduce = before
    assert after == (before[0] + 2, before[1] + 1)


# ------------------------------------------------------------- the CRNN

TM = 96


def _cfg(**kw) -> ModelConfig:
    return ModelConfig(fused_block=True, fused_interpret=True, entry_block_crows=True, **kw)


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


def test_crnn_eval_matches_jax_with_the_flag():
    cfg = _cfg()
    params, state = _jax_weights(cfg, 1)
    x = np.random.default_rng(1).standard_normal((2, TM, 64)).astype(np.float32)
    s_ref, w_ref, _ = jcrnn.CRNN(cfg).apply(params, state, jnp.asarray(x), train=False)
    strong, weak = _port(cfg, params, state).eval()(torch.from_numpy(x))
    np.testing.assert_allclose(strong.numpy(), np.asarray(s_ref), rtol=0, atol=2e-5)
    np.testing.assert_allclose(weak.numpy(), np.asarray(w_ref), rtol=0, atol=2e-5)


def test_crnn_train_mode_matches_jax_with_the_flag():
    cfg = _cfg(dropout=0.0)
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


def test_crnn_with_the_flag_equals_the_port_without_it_and_takes_precedence():
    """Crows before planes before the default, as in the JAX model: with both
    block flags set the crows entries run; outputs, buffers and gradients
    equal the default path's (dropout 0.5, one generator seed). An odd batch
    falls through to the planes entry."""
    cfg = dataclasses.replace(_cfg(entry_block_pallas=True), n_rnn_cell=16)
    base = tcrnn.seeded_init_(tcrnn.CRNN(cfg), 3)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, TM, 64)).astype(np.float32))
    results = []
    for flags in (True, False):
        net = tcrnn.CRNN(dataclasses.replace(cfg, entry_block_crows=flags, entry_block_pallas=flags)).train()
        net.load_state_dict(base.state_dict())
        calls = []
        real = {(m, n): getattr(m, n) for m, n in ((tcr, "crows_apply"), (tcr, "crows_stats_apply"))}
        for (m, n), fn in real.items():
            setattr(m, n, lambda *a, _fn=fn, _n=n, **kw: (calls.append(_n), _fn(*a, **kw))[1])
        try:
            strong, weak = net(x, torch.Generator().manual_seed(7))
            if flags:
                assert calls == ["crows_stats_apply", "crows_apply"]
                net(x[:1], torch.Generator().manual_seed(7))  # odd batch: not through crows
                assert calls == ["crows_stats_apply", "crows_apply"]
                net.load_state_dict(base.state_dict())  # undo that call's buffer update
                strong, weak = net(x, torch.Generator().manual_seed(7))
        finally:
            for (m, n), fn in real.items():
                setattr(m, n, fn)
        (strong.sum() + weak.sum()).backward()
        results.append((strong.detach(), weak.detach(), [p.grad.clone() for p in net.parameters()],
                        [b.clone() for b in net.buffers()]))
    (s1, w1, g1, b1), (s0, w0, g0, b0) = results
    assert torch.allclose(s1, s0, atol=2e-6) and torch.allclose(w1, w0, atol=2e-6)
    for a, b in zip(b1, b0):
        assert torch.allclose(a, b, atol=1e-6)
    top = max(g.abs().max().item() for g in g0)
    for a, b in zip(g1, g0):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item() + 1e-6 * top
