"""Port parity: the scaled configuration (`scaled_config()`: bfloat16
compute, 128 mels, 128-channel convs, a 128-cell BiGRU, pooling (2, 4)
(2, 4) (2, 8), SpecAugment on the student features) against the JAX
package.

A small scaled-shaped model keeps the configuration's mels, pooling,
compute dtype and SpecAugment and cuts the widths (16 filters, 16 GRU
cells) and the clips (1.11 s → T = 96 frames, which every JAX tiling
takes: 96, 48 and 24 frames at the three blocks). Inputs come from numpy
seeds; the JAX side runs its Pallas kernels in interpret mode on XLA:CPU
(`fused_interpret=True`, `pallas_interpret=True`), the port's CPU tensors
its plain versions, which round where the kernels round. JAX matmul
precision is `highest` (tests/conftest.py).

Bars, each above what was measured on this geometry:
  * SpecAugment with injected masks: exact;
  * the CRNN, eval and train mode (dropout 0): strong and weak
    probabilities 1e-5 (measured 6e-8); BatchNorm running variances 1e-4 of
    the block's largest, running means 1e-4 of its largest standard
    deviation (measured 1.1e-5: where an element of one block's bfloat16
    output rounds to the other neighbour, the next conv's outputs around it
    move, and so do their means, which are small against their spread);
  * one Mean-Teacher step with SpecAugment (masks injected on both sides)
    in fused-frontend mode: metrics 1e-5; BatchNorm buffers as above at
    5e-4 (measured 1.2e-4: the features of the two float32 frontends differ
    in their last bits, so some round to the other bfloat16 neighbour at
    block 1's input already); every gradient leaf within 2e-2 of its own max plus 1e-6 of the
    step's largest gradient (measured: at most 3.4e-3 of its own max for
    the conv and GLU weights and the GRU, up to 1.6e-2 for the small
    BatchNorm and GLU biases of blocks 1 and 2, whose sums cancel: a float32
    difference in the last bit rounds a bfloat16 activation or gradient
    element the other way now and then, and each block's dy is stored in
    bfloat16); the five gauge leaves (conv biases ahead of a BatchNorm, the
    attention logits: rounding noise) within 1e-3 of the step's largest;
  * K1 under the bfloat16 model: the port keeps its float32 FFT and returns
    float32 features, as the JAX frontend returns them under a bfloat16
    model, whose DFT runs on bfloat16 operands: linear mel within 2e-2 of
    max of JAX's, log-mel within 0.5 dB, and the port's error against a
    float64 DFT below JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dcase2019_task4_tpu import config as jconfig
from dcase2019_task4_tpu.models import crnn as jcrnn
from dcase2019_task4_tpu.ops import mel as jmel
from dcase2019_task4_tpu.ops import specaugment as jsa
from dcase2019_task4_tpu.train import checkpoints as jckpt
from dcase2019_task4_tpu.train import steps as jsteps
from dcase2019_task4_tpu_torch import cli
from dcase2019_task4_tpu_torch import config as tconfig
from dcase2019_task4_tpu_torch.eval.evaluate import CheckpointEvaluator, config_from_metadata
from dcase2019_task4_tpu_torch.models import crnn as tcrnn
from dcase2019_task4_tpu_torch.ops import fused_block as tfb
from dcase2019_task4_tpu_torch.ops import mel as tmel
from dcase2019_task4_tpu_torch.ops import packed_conv as tpc
from dcase2019_task4_tpu_torch.ops import specaugment as tsa
from dcase2019_task4_tpu_torch.train import checkpoints as tckpt
from dcase2019_task4_tpu_torch.train import steps as tsteps

DSP = jconfig.DSPConfig(n_mels=128, max_len_seconds=1.11)
T, M, NCLASS = DSP.max_frames, DSP.n_mels, 10
B = 4  # [weak 1 | unlabeled 2 | synthetic 1]
WEAK, STRONG = slice(0, 1), slice(3, 4)
SCALED = jconfig.scaled_config()
SA = dict(time_masks=SCALED.train.sa_time_masks, max_time_width=SCALED.train.sa_max_time_width,
          freq_masks=SCALED.train.sa_freq_masks, max_freq_width=SCALED.train.sa_max_freq_width)


def _model_kw(**kw):
    m = SCALED.model
    return dict(nb_filters=(24, 24, 24), n_rnn_cell=16, pooling=m.pooling, compute_dtype=m.compute_dtype, **kw)


def _jax_cfg(dropout=0.0):
    return jconfig.ModelConfig(fused_block=True, fused_interpret=True, dropout=dropout, **_model_kw())


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _port_model(jparams, jbn):
    net = tcrnn.CRNN(tconfig.ModelConfig(**_model_kw(dropout=0.0)))
    net.load_state_dict(tckpt.params_from_jax(_np_tree(jparams), _np_tree(jbn)))
    return net


def _masks(seed):
    """Two time spans and two frequency spans per clip, from numpy."""
    rng = np.random.default_rng(seed)

    def spans(size, width):
        idx = np.arange(size)
        starts, widths = rng.integers(0, size, (B, 2)), rng.integers(0, width + 1, (B, 2))
        return ((idx >= starts[..., None]) & (idx < (starts + widths)[..., None])).any(axis=1)

    return spans(T, SA["max_time_width"]), spans(M, SA["max_freq_width"])


def _inject_jax_masks(monkeypatch, tm, fm):
    """The JAX function's draws replaced by the given masks (by axis size)."""
    monkeypatch.setattr(jsa, "_axis_mask", lambda rng, batch, size, n, w: jnp.asarray(tm if size == T else fm))


# ---------------------------------------------------------- configuration


def test_scaled_config_equals_the_jax_one_field_for_field():
    port, ref = tconfig.scaled_config(), jconfig.scaled_config()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert (port.model.compute_dtype, port.dsp.n_mels, port.model.nb_filters, port.model.n_rnn_cell,
            port.model.pooling, port.train.spec_augment) == (
        "bfloat16", 128, (128, 128, 128), 128, ((2, 4), (2, 4), (2, 8)), True)
    assert tcrnn.CRNN(port.model, device="meta").compute_dtype == torch.bfloat16


# ---------------------------------------------------------- SpecAugment


def test_spec_augment_with_injected_masks_matches_jax(monkeypatch):
    x = np.random.default_rng(0).standard_normal((B, T, M)).astype(np.float32)
    tm, fm = _masks(1)
    _inject_jax_masks(monkeypatch, tm, fm)
    ref = jsa.spec_augment(jax.random.PRNGKey(0), jnp.asarray(x), **SA)
    out = tsa.apply_masks(torch.from_numpy(x), torch.from_numpy(tm), torch.from_numpy(fm))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert (out.numpy() == 0).any() and not np.array_equal(out.numpy(), x)


def test_spec_augment_draws_from_the_generator():
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((8, T, M)).astype(np.float32)) + 5.0
    a = tsa.spec_augment(x, torch.Generator().manual_seed(3), **SA)
    assert torch.equal(a, tsa.spec_augment(x, torch.Generator().manual_seed(3), **SA))
    assert not torch.equal(a, tsa.spec_augment(x, torch.Generator().manual_seed(4), **SA))
    tm, fm = tsa.draw_masks(torch.Generator().manual_seed(3), x.shape, device=x.device, **SA)
    assert torch.equal(a, tsa.apply_masks(x, tm, fm))
    assert tm.shape == (8, T) and fm.shape == (8, M) and tm.dtype == torch.bool
    # at most two spans per clip, each at most the configured width
    for mask, width in ((tm, SA["max_time_width"]), (fm, SA["max_freq_width"])):
        for row in mask.numpy():
            runs = np.diff(np.concatenate([[0], row.astype(int), [0]]))
            lengths = np.flatnonzero(runs == -1) - np.flatnonzero(runs == 1)
            assert len(lengths) <= 2 and (lengths <= 2 * width).all()
    assert tsa.spec_augment(x, torch.Generator().manual_seed(3), time_masks=0, freq_masks=0).equal(x)


# ---------------------------------------------------------- the CRNN


@pytest.fixture(scope="module")
def jax_model():
    model = jcrnn.CRNN(_jax_cfg())
    params, bn = model.init(jax.random.PRNGKey(0))
    x = (np.random.default_rng(1).standard_normal((B, T, M)) * 1.5 + 0.2).astype(np.float32)
    return model, params, bn, x


@pytest.mark.parametrize("train", [False, True])
def test_crnn_matches_jax(jax_model, train):
    model, params, bn, x = jax_model
    apply = jax.jit(model.apply, static_argnames="train")
    strong_ref, weak_ref, bn_ref = apply(params, bn, jnp.asarray(x), train=train, rng=jax.random.PRNGKey(1))
    # the forward wrappers, which the training Functions and the eval-mode
    # ops both call
    calls = {"k2": [], "k3": []}
    real_k2, real_k3 = tfb.fused_bn_glu_pool, tpc.conv2d_forward
    tfb.fused_bn_glu_pool = lambda y, *a, **kw: (calls["k2"].append(y.dtype), real_k2(y, *a, **kw))[1]
    tpc.conv2d_forward = lambda p, x_: (calls["k3"].append(x_.dtype), real_k3(p, x_))[1]
    try:
        net = _port_model(params, bn).train(train)
        strong, weak = net(torch.from_numpy(x), torch.Generator().manual_seed(0))
    finally:
        tfb.fused_bn_glu_pool, tpc.conv2d_forward = real_k2, real_k3
    # the fused block at all three blocks and K3 at blocks 2 and 3, in bfloat16
    assert calls == {"k2": [torch.bfloat16] * 3, "k3": [torch.bfloat16] * 2}
    assert strong.dtype == weak.dtype == torch.float32
    np.testing.assert_allclose(strong.detach().numpy(), np.asarray(strong_ref), rtol=0, atol=1e-5)
    np.testing.assert_allclose(weak.detach().numpy(), np.asarray(weak_ref), rtol=0, atol=1e-5)
    _check_bn(tckpt.params_to_jax(net)[1], bn_ref, "running statistics")


def test_bfloat16_model_runs_through_the_fused_kernels_only():
    """Without the fused block a bfloat16 model is refused. The first-block
    flags run in bfloat16: at this geometry (24 filters, 128 mels) the fused
    first block's gates do not take block 1, so the pallas and crows flags
    give the default model's bits, and the entry conv kernel runs."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, T, M)).astype(np.float32))
    with pytest.raises(NotImplementedError, match="fused block"):
        tcrnn.CRNN(tconfig.ModelConfig(fused_block=False, **_model_kw())).eval()(x)
    base = tcrnn.seeded_init_(tcrnn.CRNN(tconfig.ModelConfig(**_model_kw())), 0).eval()
    strong_ref, _ = base(x)
    for flag in ("entry_block_pallas", "entry_block_crows", "entry_conv_pallas"):
        net = tcrnn.CRNN(tconfig.ModelConfig(**_model_kw(**{flag: True}))).eval()
        net.load_state_dict(base.state_dict())
        strong, weak = net(x)
        assert strong.dtype == weak.dtype == torch.float32 and torch.isfinite(strong).all(), flag
        if flag != "entry_conv_pallas":
            assert torch.equal(strong, strong_ref), flag
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tcrnn.CRNN(tconfig.ModelConfig(**dict(_model_kw(), compute_dtype="float16")))


# ---------------------------------------------------------- the MT step


def _grad_probe():
    zeros = lambda tree: jax.tree.map(jnp.zeros_like, tree)  # noqa: E731
    return optax.GradientTransformation(zeros, lambda g, s, p=None: (zeros(g), g))


def _check_bn(got, want, what, tol=1e-4):
    """BatchNorm buffers of each block: the mean within `tol` of the block's
    largest standard deviation, the variance within `tol` of its largest
    variance."""
    for i, (g, w) in enumerate(zip(got["cnn"], want["cnn"])):
        var = np.asarray(w["var"])
        np.testing.assert_allclose(g["var"], var, rtol=0, atol=tol * var.max(), err_msg=f"{what} {i} var")
        np.testing.assert_allclose(g["mean"], np.asarray(w["mean"]), rtol=0, atol=tol * np.sqrt(var.max()),
                                   err_msg=f"{what} {i} mean")


def _is_gauge_leaf(name):
    return name.endswith(".conv.bias") or name.startswith("dense_softmax.")


def test_one_mt_step_with_spec_augment_matches_jax(monkeypatch):
    """Fused-frontend MT mode with SpecAugment on the student's normalised
    features, masks injected on both sides; both frontends compute in
    float32 (the bfloat16 frontend's divergence is the next test's), the
    teacher noise is 0 and dropout 0."""
    rng = np.random.default_rng(5)
    audio = np.clip(np.round(0.1 * rng.standard_normal((B, DSP.max_samples + DSP.n_window)) * 32768),
                    -32768, 32767).astype(np.int16)
    frames = np.full(B, T, np.int32)
    frames[1] = T - 7
    target = (rng.random((B, T // 8, NCLASS)) > 0.8).astype(np.float32)
    target[1:3] = -1.0
    batch = {"audio": audio, "frames": frames, "target": target}
    fe_kw = dict(sample_rate=DSP.sample_rate, n_window=DSP.n_window, hop_length=DSP.hop_length, n_mels=M,
                 f_min=DSP.f_min, f_max=DSP.f_max, max_frames=T)
    jfe, tfe = jmel.MelFrontend(pallas_interpret=True, **fe_kw), tmel.MelFrontend(**fe_kw)
    feats = tfe.log_mel(tsteps.dequantize_audio(torch.from_numpy(audio)), torch.from_numpy(frames))
    common = dict(mean_teacher=True, rampup_length=10, max_consistency_cost=2.0, ema_alpha=0.999, noise_std=0.0,
                  scaler_mean=feats.mean(dim=(0, 1)).numpy(), scaler_std=feats.std(dim=(0, 1)).numpy(),
                  spec_augment_cfg=SA)
    tm, fm = _masks(6)
    _inject_jax_masks(monkeypatch, tm, fm)
    monkeypatch.setattr(tsteps, "spec_augment",
                        lambda x, gen, **kw: tsa.apply_masks(x, torch.from_numpy(tm), torch.from_numpy(fm)))

    model = jcrnn.CRNN(_jax_cfg())
    jstate = jsteps.init_train_state(model, _grad_probe(), jax.random.PRNGKey(3))
    jstate = jstate._replace(step=jnp.int32(3))
    jstep = jsteps.make_train_step(model, _grad_probe(), WEAK, STRONG, frontend=jfe, donate=False, **common)
    jnew, jmetrics, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0),
                              jstep.zero_metrics())
    jgrads = jnew.opt_state

    cfg = tconfig.ModelConfig(**_model_kw(dropout=0.0))
    state = tsteps.init_train_state(cfg, lambda p: torch.optim.SGD(p, lr=0.0), torch.Generator().manual_seed(0))
    state = tckpt.train_state_from_jax(state, _np_tree(jstate.params), _np_tree(jstate.bn_state),
                                       _np_tree(jstate.ema_params), _np_tree(jstate.ema_bn_state), step=3)
    tstep = tsteps.make_train_step(WEAK, STRONG, frontend=tfe, **common)
    state, metrics, _ = tstep(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                              torch.Generator().manual_seed(0), tstep.zero_metrics())

    assert list(metrics) == list(jstep.metric_keys)
    for k in metrics:
        assert abs(metrics[k].item() - float(jmetrics[k])) <= 1e-5, k
    got = {name: p.grad for name, p in state.student.named_parameters()}
    want = tckpt._named_from_jax(_np_tree(jgrads))
    top = max(np.abs(w.numpy()).max() for w in want.values())
    for name, g in got.items():
        w = want[name].numpy()
        atol = 2e-2 * np.abs(w).max() + (1e-3 if _is_gauge_leaf(name) else 1e-6) * top
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=atol, err_msg=name)
    out = tckpt.train_state_to_jax(state)
    _check_bn(out["bn_state"], jnew.bn_state, "student", 5e-4)
    _check_bn(out["ema_bn_state"], jnew.ema_bn_state, "teacher", 5e-4)


# ---------------------------------------------------------- K1 under bf16


def test_frontend_under_the_bfloat16_model_keeps_float32_and_beats_jax_against_float64():
    rng = np.random.default_rng(7)
    audio = (0.1 * rng.standard_normal((2, DSP.max_samples + DSP.n_window))).astype(np.float32)
    fe_kw = dict(sample_rate=DSP.sample_rate, n_window=DSP.n_window, hop_length=DSP.hop_length, n_mels=M,
                 f_min=DSP.f_min, f_max=DSP.f_max, max_frames=T)
    jfe = jmel.MelFrontend(pallas_interpret=True, compute_dtype=jnp.bfloat16, **fe_kw)
    tfe = tmel.MelFrontend(**fe_kw)
    ref = np.asarray(jfe.linear_mel(jnp.asarray(audio)))
    got = tfe.linear_mel(torch.from_numpy(audio))
    # the JAX frontend of a bfloat16 model returns float32 features; so does the port's
    assert ref.dtype == np.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-2 * np.abs(ref).max())
    frames = np.lib.stride_tricks.sliding_window_view(audio.astype(np.float64), DSP.n_window, axis=1)
    frames = frames[:, :: DSP.hop_length][:, :T]
    spec = np.abs(np.fft.rfft(frames * tfe.window.double().numpy(), axis=-1))[..., : tfe.mel_fb.shape[0]]
    exact = spec @ tfe.mel_fb.double().numpy()
    err_port, err_jax = np.abs(got.double().numpy() - exact).max(), np.abs(ref - exact).max()
    assert err_port < err_jax, (err_port, err_jax)
    n = torch.full((2,), T, dtype=torch.int32)
    db_ref = np.asarray(jfe.log_mel(jnp.asarray(audio), jnp.asarray(n.numpy())))
    np.testing.assert_allclose(tfe.log_mel(torch.from_numpy(audio), n).numpy(), db_ref, rtol=0, atol=0.5)


# ---------------------------------------------------------- checkpoint and predict


def _meta(cfg_dict):
    return {"epoch": 0, "valid_metric": {}, "pooling_time_ratio": 8,
            "scaler": {"mean_": [-40.0] * M, "mean_of_square_": [1825.0] * M},
            "many_hot_encoder": {"labels": list(jconfig.DEFAULT_CLASSES), "n_frames": T // 8},
            "config": cfg_dict, "mean_teacher": True}


def test_scaled_checkpoint_round_trips_and_predicts(tmp_path, jax_model):
    """A scaled checkpoint written by the port: the JAX package reads its
    configuration back as `scaled_config()` and its leaves as written, and
    one written by the JAX package loads into the port leaf for leaf; the
    port's evaluator builds the bfloat16 model from it and `cli.predict`
    gives that model's probabilities."""
    cfg = dataclasses.replace(tconfig.scaled_config(), dsp=dataclasses.replace(tconfig.scaled_config().dsp,
                                                                                max_len_seconds=1.11),
                              model=tconfig.ModelConfig(**_model_kw()))
    net = tcrnn.seeded_init_(tcrnn.CRNN(cfg.model), 4)
    params, bn = tckpt.params_to_jax(net)
    path = str(tmp_path / "scaled.npz")
    tckpt.save_inference_checkpoint(path, params, bn, _meta(dataclasses.asdict(cfg)))
    from dcase2019_task4_tpu.eval.evaluate import config_from_metadata as jax_config_from_metadata

    meta = jckpt.read_metadata(path)
    assert dataclasses.asdict(jax_config_from_metadata(meta)) == dataclasses.asdict(cfg)
    assert config_from_metadata(meta) == cfg
    for a, b in zip(jax.tree.leaves(tckpt.load_inference_state(path)), jax.tree.leaves((params, bn))):
        np.testing.assert_array_equal(a, b)
    # and the other way: the JAX model's parameters, written by the JAX package, feed the port's model
    _, jparams, jbn, _ = jax_model
    jstate = jsteps.TrainState(jparams, jbn, None, None, None, jnp.int32(0))
    jpath = str(tmp_path / "jax_scaled.npz")
    jckpt.save_checkpoint(jpath, jstate, meta)
    assert config_from_metadata(tckpt.read_metadata(jpath)) == cfg
    loaded = tcrnn.CRNN(cfg.model)
    loaded.load_state_dict(tckpt.params_from_jax(*tckpt.load_inference_state(jpath)))
    for a, b in zip(jax.tree.leaves(tckpt.params_to_jax(loaded)), jax.tree.leaves((jstate.params, jstate.bn_state))):
        np.testing.assert_array_equal(a, np.asarray(b))

    from dcase2019_task4_tpu_torch.data.audio_io import synth_clip, write_wav

    wav_dir = tmp_path / "wavs"
    wav_dir.mkdir()
    for i in range(3):
        write_wav(str(wav_dir / f"c{i}.wav"), synth_clip(f"c{i}.wav", [(i, 0.1, 0.9)], 1.11, DSP.sample_rate),
                  DSP.sample_rate)
    res = cli.predict(["-m", path, "-i", str(wav_dir), "-p", str(tmp_path / "ev.tsv"), "--device", "cpu"])
    ev = CheckpointEvaluator(path, device="cpu")
    assert ev.model.compute_dtype == torch.bfloat16
    from dcase2019_task4_tpu_torch.data.pipeline import iter_eval_batches

    d = cfg.dsp
    b = next(iter_eval_batches(ev._stream(str(wav_dir)), 24, d.max_samples, d.n_window, d.hop_length, d.max_frames))
    strong, _ = ev._predict(ev.features(b["audio"], b["frames"]))
    np.testing.assert_array_equal(res["strong"], strong[: b["n_valid"]].numpy())
    assert res["strong"].shape == (3, T // 8, NCLASS) and np.isfinite(res["strong"]).all()
    # any other compute dtype is refused
    other = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, compute_dtype="float16"))
    tckpt.save_inference_checkpoint(str(tmp_path / "f16.npz"), params, bn, _meta(dataclasses.asdict(other)))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        CheckpointEvaluator(str(tmp_path / "f16.npz"), device="cpu")
