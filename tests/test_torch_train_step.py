"""Port parity: the Mean-Teacher training step and what it is made of.

Dryrun geometry (1.11 s clips → T = 96 frames → 12 pooled, 16 filters, 16
GRU cells, batch 8 = [weak 2 | unlabeled 4 | synthetic 2]). Inputs come
from numpy seeds and go through the JAX function and its counterpart; state
crosses through the numpy bridge (train/checkpoints.py). Dropout is 0 and
the teacher noise is 0 or injected wherever the two frameworks' random
numbers would differ. JAX matmul precision is `highest` (tests/conftest.py).

Tolerances: scalar schedules 1e-6 (losses 2e-6 relative); train-mode forward 3e-5; one step with
the JAX Pallas kernels interpreted — metrics 1e-5, gradient leaves 1e-5 of
their max (the gauge leaves below with a noise floor, and again in function
space), BatchNorm buffers 1e-5, EMA and
student parameters 1e-6; 20
steps against the JAX plain path — loss within 2e-4 per step (float32
trajectories under Adam, the bar of tests/test_training_dynamics.py).

Every gradient leaf is held to 1e-5 of its own max. Five leaves, pinned by
name, are sums that cancel almost completely: the conv biases ahead of a
BatchNorm (gauge directions, zero in exact arithmetic) and the attention
head's weight and bias (an additive offset changes nothing, and at the
N(0, 0.01) init the softmax is near uniform). Their float32 values carry
rounding noise of a few ulps of the terms summed, which is large against
their own max but about 3e-7 of the step's largest gradient; against a
float64 run of the same step the JAX package's own two paths sit as far from
the exact gradient as the port does. These five alone get 1e-6 of the step's
largest gradient on top of 1e-5 of their max, and are compared again in
function space: a fresh Adam's first update taken from either side's
gradients must leave the student's outputs within 1e-5. The 20-step tests do
the same at length, with Adam started from zero moments.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dcase2019_task4_tpu.config import DSPConfig, ModelConfig
from dcase2019_task4_tpu.models import crnn as jcrnn
from dcase2019_task4_tpu.ops import mel as jmel
from dcase2019_task4_tpu.train import losses as jlosses
from dcase2019_task4_tpu.train import ramps as jramps
from dcase2019_task4_tpu.train import schedules as jschedules
from dcase2019_task4_tpu.train import steps as jsteps
from dcase2019_task4_tpu_torch.models import crnn as tcrnn
from dcase2019_task4_tpu_torch.ops import mel as tmel
from dcase2019_task4_tpu_torch.train import checkpoints as tckpt
from dcase2019_task4_tpu_torch.train import losses as tlosses
from dcase2019_task4_tpu_torch.train import ramps as tramps
from dcase2019_task4_tpu_torch.train import schedules as tschedules
from dcase2019_task4_tpu_torch.train import steps as tsteps

DSP = DSPConfig(max_len_seconds=1.11)
T, TP, NCLASS, B = DSP.max_frames, DSP.max_frames // 8, 10, 8
WEAK, STRONG = slice(0, 2), slice(6, 8)
LR = 1e-3


def _cfg(fused: bool, **kw) -> ModelConfig:
    return ModelConfig(nb_filters=(16, 16, 16), n_rnn_cell=16, dropout=0.0, fused_block=fused,
                       fused_interpret=fused, **kw)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _batch(seed, audio2=False):
    rng = np.random.default_rng(seed)
    audio = np.clip(np.round(0.1 * rng.standard_normal((B, DSP.max_samples + DSP.n_window)) * 32768),
                    -32768, 32767).astype(np.int16)
    frames = np.full(B, T, np.int32)
    frames[1] = T - 7
    target = (rng.random((B, TP, NCLASS)) > 0.8).astype(np.float32)
    target[2:6] = -1.0  # unlabeled
    out = {"audio": audio, "frames": frames, "target": target}
    if audio2:
        out["audio2"] = np.roll(audio, 3, axis=0)
    return out


def _frontends(interpret: bool):
    kw = dict(sample_rate=DSP.sample_rate, n_window=DSP.n_window, hop_length=DSP.hop_length,
              n_mels=DSP.n_mels, f_min=DSP.f_min, f_max=DSP.f_max, max_frames=DSP.max_frames)
    return jmel.MelFrontend(pallas_interpret=interpret, **kw), tmel.MelFrontend(**kw)


def _jax_state(cfg, seed, optimizer):
    model = jcrnn.CRNN(cfg)
    return model, jsteps.init_train_state(model, optimizer, jax.random.PRNGKey(seed))


def _torch_state(cfg, jstate, mu=None, nu=None, step=0):
    state = tsteps.init_train_state(cfg, lambda p: torch.optim.Adam(p, lr=LR, betas=(0.9, 0.999), eps=1e-8),
                                    torch.Generator().manual_seed(0), with_ema=jstate.ema_params is not None)
    has_ema = jstate.ema_params is not None
    return tckpt.train_state_from_jax(
        state, _np_tree(jstate.params), _np_tree(jstate.bn_state),
        _np_tree(jstate.ema_params) if has_ema else None, _np_tree(jstate.ema_bn_state) if has_ema else None,
        mu, nu, step)


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _leaves_close(got, want, tol, what):
    lg, lw = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(lg) == len(lw)
    for i, (g, w) in enumerate(zip(lg, lw)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0, atol=tol, err_msg=f"{what} leaf {i}")


# ------------------------------------------------------ scalar schedules


@pytest.mark.parametrize("name", ["sigmoid_rampup", "linear_rampup", "cosine_rampdown", "sigmoid_rampdown"])
def test_ramps_match_jax_on_a_grid(name):
    for length in (0, 10, 137):
        if name == "cosine_rampdown" and length == 0:
            continue
        for step in (0, 1, 5, 10, 50, 137, 500):
            want = float(getattr(jramps, name)(jnp.float32(step), length))
            assert abs(getattr(tramps, name)(float(step), length) - want) <= 1e-6
            got = getattr(tramps, name)(torch.tensor(float(step)), length)
            assert isinstance(got, torch.Tensor) and abs(got.item() - want) <= 1e-6


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    strong = rng.random((B, TP, NCLASS)).astype(np.float32)
    strong[0, 0, :3] = (0.0, 1.0, 1e-9)  # the clamp
    weak = rng.random((B, NCLASS)).astype(np.float32)
    strong_t, weak_t = rng.random(strong.shape).astype(np.float32), rng.random(weak.shape).astype(np.float32)
    target = _batch(1)["target"]
    t = torch.from_numpy
    pairs = [
        (tlosses.bce(t(strong), t((target > 0.5).astype(np.float32))), jlosses.bce(strong, (target > 0.5).astype(np.float32))),
        (tlosses.mse(t(strong), t(strong_t)), jlosses.mse(strong, strong_t)),
        (tlosses.weak_bce(t(weak), t(target), WEAK), jlosses.weak_bce(weak, target, WEAK)),
        (tlosses.strong_bce(t(strong), t(target), STRONG), jlosses.strong_bce(strong, target, STRONG)),
        (tlosses.consistency(t(strong), t(weak), t(strong_t), t(weak_t), 1.7),
         jlosses.consistency(strong, weak, strong_t, weak_t, 1.7)),
    ]
    for got, want in pairs:  # means of up to 960 float32 terms in another order: a few ulps
        assert abs(got.item() - float(want)) <= 2e-6 * max(1.0, abs(float(want)))


def test_ema_update_matches_jax_on_a_grid():
    cfg = _cfg(False)
    _, jstate = _jax_state(cfg, 0, optax.adam(LR))
    for step in (0, 1, 7, 998, 5000):
        state = _torch_state(cfg, jstate)
        want = jsteps.ema_update(jstate.params, jstate.ema_params, jnp.int32(step), 0.999)
        tsteps.ema_update(state.student, state.teacher, step, 0.999)
        got, bn = tckpt.params_to_jax(state.teacher)
        _leaves_close(got, want, 1e-6, f"ema step {step}")
        _leaves_close(bn, _np_tree(jstate.ema_bn_state), 0, "teacher BN buffers stay its own")
    assert abs(tsteps.ema_alpha_at(0) - 0.5) < 1e-12 and tsteps.ema_alpha_at(10 ** 6) == 0.999


def test_meanteacher_adam_hyperparameters_and_three_steps_match_optax():
    kw = dict(total_steps=40, rampup_steps=5, max_learning_rate=1e-2)
    jopt = jschedules.meanteacher_adam(**kw)
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((4, 3)).astype(np.float32)
    grads = [rng.standard_normal((4, 3)).astype(np.float32) for _ in range(3)]
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    topt, set_step = tschedules.meanteacher_adam([param], **kw)
    jparams = {"p": jnp.asarray(p0)}
    jstate = jopt.init(jparams)
    for step, g in enumerate(grads):
        hyper = set_step(step)
        param.grad = torch.from_numpy(g.copy())
        topt.step()
        updates, jstate = jopt.update({"p": jnp.asarray(g)}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        want = jstate.hyperparams  # the values this update used
        assert abs(hyper["learning_rate"] - float(want["learning_rate"])) <= 1e-6 * 1e-2
        assert abs(hyper["b1"] - float(want["b1"])) <= 1e-6 and abs(hyper["b2"] - float(want["b2"])) <= 1e-6
        # bias correction with a β that changes per step: 1 − β_now**count on both sides
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(jparams["p"]), rtol=0, atol=1e-6)
    for step in (0, 3, 5, 20, 39, 60):
        h = set_step(step)
        assert abs(h["b1"] - float(0.5 * (np.cos(np.pi * min(step / 40, 1.0)) + 1) * 0.4 + 0.5)) <= 1e-6


# ------------------------------------------------------ model and frontend


@pytest.mark.parametrize("fused", [True, False])
def test_train_mode_forward_and_running_stats_match_jax(fused):
    cfg = _cfg(fused)
    model, jstate = _jax_state(cfg, 1, optax.adam(LR))
    x = np.random.default_rng(2).standard_normal((B, T, 64)).astype(np.float32) * 3.0 + 1.0
    s_ref, w_ref, bn_ref = model.apply(jstate.params, jstate.bn_state, jnp.asarray(x), train=True,
                                       rng=jax.random.PRNGKey(0))
    net = _torch_state(cfg, jstate).student.train()
    strong, weak = net(torch.from_numpy(x), torch.Generator().manual_seed(0))
    np.testing.assert_allclose(strong.detach().numpy(), np.asarray(s_ref), rtol=0, atol=3e-5)
    np.testing.assert_allclose(weak.detach().numpy(), np.asarray(w_ref), rtol=0, atol=3e-5)
    _, bn = tckpt.params_to_jax(net)
    _leaves_close(bn, bn_ref, 3e-5, "running statistics")


def test_dropout_draws_come_from_the_generator():
    cfg = dataclasses.replace(_cfg(True), dropout=0.5)
    net = tcrnn.init_(tcrnn.CRNN(cfg), torch.Generator().manual_seed(0)).train()
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, T, 64)).astype(np.float32))
    a, _ = net(x, torch.Generator().manual_seed(5))
    b, _ = net(x, torch.Generator().manual_seed(5))
    c, _ = net(x, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_init_distributions():
    net = tcrnn.init_(tcrnn.CRNN(ModelConfig()), torch.Generator().manual_seed(0))
    w = net.cnn[1].conv.weight
    limit = np.sqrt(2.0) * np.sqrt(6.0 / (2 * 64 * 9))
    assert w.abs().max().item() <= limit and w.abs().max().item() > 0.95 * limit
    assert abs(w.std().item() - limit / np.sqrt(3.0)) < 0.02 * limit
    assert all(float(blk.conv.bias.abs().max()) == 0.0 and float(blk.bn.bias.abs().max()) == 0.0 for blk in net.cnn)
    assert abs(net.cnn[0].bn.weight.mean().item() - 1.0) < 0.02 and 0.005 < net.cnn[0].bn.weight.std().item() < 0.04
    assert float(net.cnn[0].bn.running_mean.abs().max()) == 0.0 and float((net.cnn[0].bn.running_var - 1).abs().max()) == 0.0
    for lin in (net.cnn[0].act, net.dense, net.dense_softmax):
        assert abs(lin.weight.std().item() - 0.01) < 0.002 and float(lin.bias.abs().max()) == 0.0
    H = 64
    for name in ("weight_ih_l0", "weight_hh_l0_reverse", "weight_ih_l1"):
        w = getattr(net.rnn, name)
        for gate in range(3):
            blk = w[gate * H:(gate + 1) * H]
            gram = blk @ blk.t() if blk.shape[0] <= blk.shape[1] else blk.t() @ blk
            assert torch.allclose(gram, torch.eye(gram.shape[0]), atol=1e-5)
    assert net.rnn.bias_ih_l0.abs().max().item() <= H ** -0.5
    # student and teacher of one generator differ (independent initialisation)
    st = tsteps.init_train_state(_cfg(True), lambda p: torch.optim.Adam(p, lr=LR), torch.Generator().manual_seed(0))
    assert not torch.equal(st.student.dense.weight, st.teacher.dense.weight)
    assert all(not p.requires_grad for p in st.teacher.parameters())


@pytest.mark.parametrize("second_view", [False, True])
def test_log_mel_pair_with_injected_noise_matches_jax(second_view):
    jfe, tfe = _frontends(interpret=True)
    batch = _batch(4, audio2=second_view)
    key = jax.random.PRNGKey(11)
    noise = np.asarray(jax.random.normal(key, (B, T, DSP.n_mels), dtype=jnp.float32))
    s_ref, t_ref = jfe.log_mel_pair(jnp.asarray(batch["audio"]), jnp.asarray(batch["frames"]), key, 0.25,
                                    teacher_padded=jnp.asarray(batch["audio2"]) if second_view else None)
    s, t = tfe.log_mel_pair_with_noise(torch.from_numpy(batch["audio"]), torch.from_numpy(batch["frames"]),
                                       torch.from_numpy(noise), 0.25,
                                       torch.from_numpy(batch["audio2"]) if second_view else None)
    for got, want in ((s, s_ref), (t, t_ref)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert not np.allclose(np.asarray(s_ref), np.asarray(t_ref))
    # the generator path: deterministic per seed, clean student
    a = tfe.log_mel_pair(torch.from_numpy(batch["audio"]), torch.from_numpy(batch["frames"]),
                         torch.Generator().manual_seed(1))
    b = tfe.log_mel_pair(torch.from_numpy(batch["audio"]), torch.from_numpy(batch["frames"]),
                         torch.Generator().manual_seed(1))
    assert torch.equal(a[1], b[1]) and torch.equal(a[0], s if not second_view else a[0])


# ------------------------------------------------------------- the step


def _grad_probe():
    """An optax 'optimizer' that leaves the parameters alone and keeps the
    gradients as its state: the JAX step's gradients, exactly."""
    zeros = lambda tree: jax.tree.map(jnp.zeros_like, tree)  # noqa: E731
    return optax.GradientTransformation(zeros, lambda g, s, p=None: (zeros(g), g))


def _is_gauge_leaf(name):
    """Leaves whose gradient is rounding noise (see the module docstring)."""
    return name.endswith(".conv.bias") or name.startswith("dense_softmax.")


def _check_grads(net, jgrads, tol):
    """Every leaf within `tol` of its own max; the gauge leaves alone get a
    float32 noise floor of 1e-6 of the step's largest gradient on top.
    → (port gradients, JAX gradients) by parameter name."""
    got = {name: p.grad.detach().clone() for name, p in net.named_parameters()}
    want = tckpt._named_from_jax(_np_tree(jgrads))
    assert set(got) == set(want)
    assert sorted(n for n in got if _is_gauge_leaf(n)) == [
        "cnn.0.conv.bias", "cnn.1.conv.bias", "cnn.2.conv.bias", "dense_softmax.bias", "dense_softmax.weight"]
    floor = 1e-6 * max(np.abs(w.numpy()).max() for w in want.values())
    for name in got:
        g, w = got[name].numpy(), want[name].numpy()
        atol = tol * np.abs(w).max() + (floor if _is_gauge_leaf(name) else 0.0)
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=name)
    return got, want


def _check_gauge_leaves_in_function_space(before, got, want, x, tol):
    """The gauge leaves, compared where their noise could matter: a fresh
    Adam divides a gradient by its own size, so it moves these leaves by
    about the learning rate whatever the noise says. That update, taken from
    the port's gradients and from JAX's on two copies of the student as it
    was before the step, must leave the train-mode outputs on x within
    `tol` of each other."""
    outs = []
    for grads in (got, want):
        net = copy.deepcopy(before).train()
        with torch.no_grad():
            for name, p in net.named_parameters():
                if _is_gauge_leaf(name):
                    g = grads[name].to(p.dtype)
                    p -= LR * g / (g.abs() + 1e-8)
            outs.append(net(x, torch.Generator().manual_seed(0)))
    for a, b in zip(*outs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=tol)


def _moments(jparams, seed):
    """Seeded, well-conditioned Adam moments in the JAX layout."""
    rng = np.random.default_rng(seed)
    mu = jax.tree.map(lambda a: (1e-3 * rng.standard_normal(a.shape)).astype(np.float32), _np_tree(jparams))
    nu = jax.tree.map(lambda a: rng.uniform(1e-4, 2e-4, a.shape).astype(np.float32), _np_tree(jparams))
    return mu, nu


def _with_moments(jstate, opt, mu, nu, step):
    adam, rest = opt.init(jstate.params)
    adam = adam._replace(count=jnp.int32(step), mu=jax.tree.map(jnp.asarray, mu), nu=jax.tree.map(jnp.asarray, nu))
    return jstate._replace(opt_state=(adam, rest), step=jnp.int32(step))


def test_one_mt_step_matches_jax_with_interpreted_kernels():
    cfg = _cfg(True)
    jfe, tfe = _frontends(interpret=True)
    batch = _batch(5)
    opt = optax.adam(LR, b1=0.9, b2=0.999, eps=1e-8)
    model, jstate = _jax_state(cfg, 3, opt)
    mu, nu = _moments(jstate.params, 6)
    start = 3
    # features normalised per mel bin, as training does with its fitted scaler
    feats = tfe.log_mel(tsteps.dequantize_audio(torch.from_numpy(batch["audio"])), torch.from_numpy(batch["frames"]))
    common = dict(mean_teacher=True, rampup_length=10, max_consistency_cost=2.0, ema_alpha=0.999,
                  noise_std=0.0, scaler_mean=feats.mean(dim=(0, 1)).numpy(), scaler_std=feats.std(dim=(0, 1)).numpy())
    rng = jax.random.PRNGKey(0)  # dropout 0, noise 0: consumed but inert

    # the JAX gradients, through a probe optimizer
    probe = jsteps.make_train_step(model, _grad_probe(), WEAK, STRONG, frontend=jfe, donate=False, **common)
    pstate = jstate._replace(opt_state=_grad_probe().init(jstate.params), step=jnp.int32(start))
    pstate, _, _ = probe(pstate, _jb(batch), rng, probe.zero_metrics())
    jgrads = pstate.opt_state

    jstep = jsteps.make_train_step(model, opt, WEAK, STRONG, frontend=jfe, donate=False, **common)
    jnew, jmetrics, jacc = jstep(_with_moments(jstate, opt, mu, nu, start), _jb(batch), rng, jstep.zero_metrics())

    state = _torch_state(cfg, jstate, mu, nu, start)
    before = copy.deepcopy(state.student)
    tstep = tsteps.make_train_step(WEAK, STRONG, frontend=tfe, **common)
    assert tstep.metric_keys == tuple(jstep.metric_keys)
    acc = tstep.zero_metrics()
    state, metrics, acc = tstep(state, _tb(batch), torch.Generator().manual_seed(0), acc)

    assert list(metrics) == list(jstep.metric_keys) == list(acc)
    for k in metrics:
        assert abs(metrics[k].item() - float(jmetrics[k])) <= 1e-5, k
        assert abs(acc[k].item() - float(jacc[k])) <= 1e-5, k
    got, want = _check_grads(state.student, jgrads, 1e-5)
    normed = (feats - feats.mean(dim=(0, 1))) / feats.std(dim=(0, 1))
    _check_gauge_leaves_in_function_space(before, got, want, normed, 1e-5)
    out = tckpt.train_state_to_jax(state)
    assert out["step"] == int(jnew.step) == start + 1
    _leaves_close(out["bn_state"], jnew.bn_state, 1e-5, "student BN buffers")
    _leaves_close(out["ema_bn_state"], jnew.ema_bn_state, 1e-5, "teacher BN buffers")
    _leaves_close(out["params"], jnew.params, 1e-6, "student parameters")
    _leaves_close(out["ema_params"], jnew.ema_params, 1e-6, "EMA parameters")
    _leaves_close(out["mu"], jnew.opt_state[0].mu, 1e-6, "Adam first moment")
    _leaves_close(out["nu"], jnew.opt_state[0].nu, 1e-6, "Adam second moment")
    # the student and the teacher keep their own, different buffers
    assert not np.allclose(out["bn_state"]["cnn"][0]["var"], out["ema_bn_state"]["cnn"][0]["var"])


def _run_both(cfg, batches, mean_teacher, frontends=None, **step_kw):
    """n steps on both sides from one bridged initial state → (jax losses,
    torch losses, last metrics of both)."""
    opt = optax.adam(LR, b1=0.9, b2=0.999, eps=1e-8)
    model, jstate = _jax_state(cfg, 7, opt)
    state = _torch_state(cfg, jstate)
    jfe, tfe = frontends if frontends is not None else (None, None)
    common = dict(mean_teacher=mean_teacher, rampup_length=10, max_consistency_cost=2.0, ema_alpha=0.999,
                  noise_std=0.0, **step_kw)
    jstep = jsteps.make_train_step(model, opt, WEAK, STRONG, frontend=jfe, donate=False, **common)
    tstep = tsteps.make_train_step(WEAK, STRONG, frontend=tfe, **common)
    jacc, acc = jstep.zero_metrics(), tstep.zero_metrics()
    rng, gen = jax.random.PRNGKey(0), torch.Generator().manual_seed(0)
    jl, tl = [], []
    for batch in batches:
        jstate, jm, jacc = jstep(jstate, _jb(batch), rng, jacc)
        state, tm, acc = tstep(state, _tb(batch), gen, acc)
        jl.append(float(jm["loss"]))
        tl.append(tm["loss"].item())
    return np.asarray(jl), np.asarray(tl), jm, tm


def _feature_batches(n, seed, teacher=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = _batch(int(rng.integers(1 << 30)))
        feats = {"features": rng.standard_normal((B, T, 64)).astype(np.float32), "target": b["target"]}
        if teacher:
            feats["features_teacher"] = feats["features"] + np.abs(0.25 * rng.standard_normal((B, T, 64))).astype(np.float32)
        out.append(feats)
    return out


@pytest.mark.parametrize("mean_teacher", [True, False])
def test_20_steps_track_the_jax_plain_path(mean_teacher):
    """The port (its fused Function on the plain versions) against the JAX
    plain path (fused_block=False): 20 Adam steps, per-step loss 2e-4."""
    batches = _feature_batches(20, 8, teacher=mean_teacher)
    jl, tl, _, _ = _run_both(_cfg(False), batches, mean_teacher)
    # the port side runs its fused block (auto); the JAX side its plain path
    assert np.isfinite(tl).all() and tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=0, atol=2e-4)


def test_port_fused_and_plain_blocks_take_the_same_20_steps():
    batches = _feature_batches(20, 9, teacher=True)
    results = []
    for fused in (None, False):
        cfg = dataclasses.replace(_cfg(False), fused_block=fused)
        state = tsteps.init_train_state(cfg, lambda p: torch.optim.Adam(p, lr=LR), torch.Generator().manual_seed(1))
        step = tsteps.make_train_step(WEAK, STRONG, rampup_length=10, noise_std=0.0)
        acc, gen, losses = step.zero_metrics(), torch.Generator().manual_seed(0), []
        for batch in batches:
            state, m, acc = step(state, _tb(batch), gen, acc)
            losses.append(m["loss"].item())
        results.append(np.asarray(losses))
    np.testing.assert_allclose(results[0], results[1], rtol=0, atol=2e-4)


@pytest.mark.parametrize("mode", ["precomputed", "precomputed_teacher", "audio2", "supervised_frontend"])
def test_other_modes_one_step(mode):
    if mode.startswith("precomputed"):
        batches = _feature_batches(1, 10, teacher=mode.endswith("teacher"))
        jl, tl, jm, tm = _run_both(_cfg(False), batches, True)
    elif mode == "audio2":
        jl, tl, jm, tm = _run_both(_cfg(False), [_batch(11, audio2=True)], True, _frontends(interpret=False))
    else:
        jl, tl, jm, tm = _run_both(_cfg(False), [_batch(12)], False, _frontends(interpret=False))
        assert list(tm) == ["loss", "weak_class_loss", "strong_class_loss"]
    assert sorted(tm) == sorted(jm)  # a jitted dict comes back sorted; the order is held in the one-step test
    for k in tm:
        assert abs(tm[k].item() - float(jm[k])) <= 1e-5, k


def test_scaler_and_metric_accumulator():
    _, tfe = _frontends(interpret=False)
    batch = _tb(_batch(13))
    mean, std = np.full(64, -30.0, np.float32), np.full(64, 12.0, np.float32)
    cfg = _cfg(False)
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    make = lambda: tsteps.init_train_state(cfg, lambda p: torch.optim.Adam(p, lr=LR), gen())  # noqa: E731
    plain = tsteps.make_train_step(WEAK, STRONG, frontend=tfe, noise_std=0.0)
    scaled = tsteps.make_train_step(WEAK, STRONG, frontend=tfe, noise_std=0.0, scaler_mean=mean, scaler_std=std)
    _, m0, _ = plain(make(), batch, gen(), plain.zero_metrics())
    state, m1, acc = scaled(make(), batch, gen(), scaled.zero_metrics())
    assert m0["loss"].item() != m1["loss"].item()
    state, m2, acc = scaled(state, batch, gen(), acc)
    assert state.step == 2
    for k in scaled.metric_keys:
        assert abs(acc[k].item() - (m1[k].item() + m2[k].item())) <= 1e-6
    # the features the step saw are those of make_eval_features
    feats = tsteps.make_eval_features(tfe, mean, std)(batch["audio"], batch["frames"])
    want = (tfe.log_mel(tsteps.dequantize_audio(batch["audio"]), batch["frames"]) - torch.from_numpy(mean)) / torch.from_numpy(std)
    assert torch.allclose(feats, want, atol=1e-6)
    s, sq = tsteps.make_scaler_stats(tfe)(batch["audio"], batch["frames"], 5)
    raw = tfe.log_mel(tsteps.dequantize_audio(batch["audio"]), batch["frames"])[:5]
    assert torch.allclose(s, raw.mean(dim=1).sum(dim=0), atol=1e-3) and torch.allclose(sq, (raw * raw).mean(dim=1).sum(dim=0), rtol=1e-5)
    strong, weak = tsteps.make_predict_step(state.student)(feats)
    assert strong.shape == (B, TP, NCLASS) and weak.shape == (B, NCLASS) and not strong.requires_grad


def test_mesh_and_specaugment_are_refused():
    with pytest.raises(NotImplementedError, match="mesh"):
        tsteps.make_train_step(WEAK, STRONG, mesh=object())
    with pytest.raises(NotImplementedError, match="SpecAugment"):
        tsteps.make_train_step(WEAK, STRONG, spec_augment_cfg={"time_masks": 2})
    assert tsteps.make_train_step(WEAK, STRONG, spec_augment_cfg={}).metric_keys[0] == "loss"


def test_train_state_bridge_round_trip():
    cfg = _cfg(True)
    _, jstate = _jax_state(cfg, 14, optax.adam(LR))
    mu, nu = _moments(jstate.params, 15)
    out = tckpt.train_state_to_jax(_torch_state(cfg, jstate, mu, nu, 9))
    assert out["step"] == 9
    for key, want in (("params", jstate.params), ("bn_state", jstate.bn_state), ("ema_params", jstate.ema_params),
                      ("ema_bn_state", jstate.ema_bn_state), ("mu", mu), ("nu", nu)):
        assert jax.tree.structure(out[key]) == jax.tree.structure(_np_tree(want))
        _leaves_close(out[key], want, 0, key)
    fresh = tckpt.train_state_to_jax(_torch_state(cfg, jstate))
    assert all(float(np.abs(leaf).max()) == 0.0 for leaf in jax.tree.leaves(fresh["mu"]))
