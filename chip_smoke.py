#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dcase2019_task4_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero without
printing a result:

  1. card   — nvidia-smi's name and power limit, torch's device name;
  2. build  — compile csrc/*.cu with nvcc for sm_90a, one compiler per source
     in parallel (ptxas report printed);
  3. kernels — each hand-written kernel against its plain PyTorch version on
     the card, at the flagship shapes, float32 with TF32 off: max abs error
     against a stated tolerance, median time over 10 runs after 3 warm-ups
     (CUDA events) for the kernel, for the plain version and, where one
     PyTorch call computes the same function, for that call; the kernel's
     bound (the larger of its bytes over 3.35 TB/s and its operations over
     67 TFLOP/s, float32 outside the tensor cores). K2b, K2s and K3w run
     twice and must repeat bit for bit;
  4. predict — 48 synthetic 10 s wavs (two batches of 24) and a checkpoint
     of a seeded flagship CRNN written by the port's own writer, through
     `cli.predict(... --device cuda)`: the TSVs parse, every kernel of the
     path was launched and no training kernel was, strong probabilities are finite and agree with the same
     run on `--device cpu` (the plain versions) within 1e-4; clips/s of a
     second, warm CUDA pass;
  5. train — five Mean-Teacher steps at the flagship `Config()`, batch 24
     laid out [weak 6 | unlabeled 12 | synthetic 6], int16 audio of 24 seeded
     synthetic clips, state from a seeded CPU generator, Adam(1e-3): losses
     finite and falling, every training kernel launched on every step, the
     EMA and both models' BatchNorm buffers as they should be, and no eval
     kernel launched; then steps 1 and 2 again on the CPU (plain versions,
     same state, same generator seed) must give the same loss and metrics
     within 1e-4, and step 1 every gradient leaf within 1e-4 of its max (the
     gauge leaves alone, conv biases ahead of a BatchNorm and the attention
     logits, get a noise floor of 1e-6 of the largest gradient on top, and
     step 2 holds them in function space); ms per step, a torch.profiler
     breakdown of one warm step, and ms per step with the random generator
     on the card.

The line before the last is {"kernels": [...]}: every number in it is one
this run measured (launches on both paths as counted, the largest error
beside the limit it was held to, the bound per shape with what binds it);
the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports only the port: neither jax, nor pandas, nor the JAX package.
"""

from __future__ import annotations

import copy
import csv
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple, Optional

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
N_CLIPS = 48
STRONG_TOL = 1e-4
TRAIN_STEPS = 5
TRAIN_TOL = 1e-4
GRAD_FLOOR = 1e-6  # float32 noise floor of a gauge leaf's gradient, as a share of the step's largest gradient
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FP32_FLOPS = 67e12     # float32 outside the tensor cores
CSRC = "dcase2019_task4_tpu_torch/csrc/"
JAX_OPS = "dcase2019_task4_tpu/ops/"

# name -> (source, TPU kernel it replaces); every row of the kernels line
KERNELS = {
    "fused_stft_mel": (CSRC + "fused_mel.cu", JAX_OPS + "fused_mel.py:174"),
    "conv2d_forward": (CSRC + "packed_conv.cu", JAX_OPS + "packed_conv.py:122"),
    "conv2d_dx": (CSRC + "packed_conv.cu", JAX_OPS + "packed_conv.py:276"),
    "conv2d_wgrad": (CSRC + "packed_conv.cu", JAX_OPS + "packed_conv.py:147"),
    "fused_bn_glu_pool_eval": (CSRC + "fused_block.cu", JAX_OPS + "fused_block.py:243"),
    "fused_bn_glu_pool_train": (CSRC + "fused_block.cu", JAX_OPS + "fused_block.py:243"),
    "batch_stats": (CSRC + "fused_block.cu", JAX_OPS + "fused_block.py:591"),
    "bwd_reduce": (CSRC + "fused_block.cu", JAX_OPS + "fused_block.py:289"),
    "bwd_fixup": (CSRC + "fused_block.cu", JAX_OPS + "fused_block.py:332"),
}
# launches each path must make: at least these on predict (two batches) and
# on one MT step, and none of a kernel the path has no entry for
PREDICT_MIN = {"fused_stft_mel": 2, "conv2d_forward": 4, "fused_bn_glu_pool_eval": 6}
STEP_MIN = {"fused_stft_mel": 1, "conv2d_forward": 4, "conv2d_dx": 2, "conv2d_wgrad": 2,
            "fused_bn_glu_pool_train": 6, "batch_stats": 6, "bwd_reduce": 3, "bwd_fixup": 3}


def wrappers():
    """name -> (wrapper, the attribute of it that counts that kernel's launches)."""
    from dcase2019_task4_tpu_torch.ops import fused_block, fused_mel, packed_conv

    return {
        "fused_stft_mel": (fused_mel.fused_stft_mel, "launches"),
        "conv2d_forward": (packed_conv.conv2d_forward, "launches"),
        "conv2d_dx": (packed_conv.conv2d_dx, "launches"),
        "conv2d_wgrad": (packed_conv.conv2d_wgrad, "launches"),
        "fused_bn_glu_pool_eval": (fused_block.fused_bn_glu_pool, "launches_eval"),
        "fused_bn_glu_pool_train": (fused_block.fused_bn_glu_pool, "launches_train"),
        "batch_stats": (fused_block.batch_stats, "launches"),
        "bwd_reduce": (fused_block.bwd_reduce, "launches"),
        "bwd_fixup": (fused_block.bwd_fixup, "launches"),
    }


def zero_launches():
    for fn, counter in wrappers().values():
        setattr(fn, counter, 0)


def read_launches():
    """Launches of every kernel since `zero_launches`."""
    return {name: getattr(fn, counter) for name, (fn, counter) in wrappers().items()}


def check_launches(launches, least, times: int, path: str):
    """Every kernel of the path launched at least `times` × its minimum, and
    every kernel that is not of the path launched no time."""
    for name, count in launches.items():
        if name in least and count < times * least[name]:
            raise AssertionError(f"{name} launched {count} times on {path} (expected >= {times * least[name]})")
        if name not in least and count != 0:
            raise AssertionError(f"{name} launched {count} times on {path}, which has no use for it")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, warmup: int = 3, runs: int = 10) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound_ms(n_bytes: float, n_ops: float):
    """The least time the card could take: each input read once and each
    output written once at the HBM rate, or the operations at the FP32 rate."""
    by_bytes, by_ops = 1e3 * n_bytes / PEAK_BYTES_PER_S, 1e3 * n_ops / PEAK_FP32_FLOPS
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


class Result(NamedTuple):
    """One comparison: the largest error with the limit it was held to, and
    the median times."""
    err: float
    limit: float
    ms: float
    plain_ms: float
    library_ms: Optional[float]


class Row:
    """One row of the kernels line, summed over the shapes it was run at."""

    def __init__(self):
        self.err, self.limit, self.ms, self.plain_ms, self.library_ms = 0.0, 0.0, 0.0, 0.0, None
        self.shapes = []  # per shape: what binds it and its bound

    def note_err(self, res: Result):
        if res.err >= self.err:
            self.err, self.limit = res.err, res.limit

    def add(self, shape, res: Result, n_bytes, n_ops):
        b, by = bound_ms(n_bytes, n_ops)
        self.note_err(res)
        self.ms, self.plain_ms = self.ms + res.ms, self.plain_ms + res.plain_ms
        self.shapes.append({"shape": list(shape), "bound_by": by, "bound_ms": b})
        if res.library_ms is not None:
            self.library_ms = (self.library_ms or 0.0) + res.library_ms

    @property
    def bound(self) -> float:
        return sum(s["bound_ms"] for s in self.shapes)

    @property
    def bound_by(self) -> str:
        """The limit that makes up the larger part of the summed bound."""
        by_ops = sum(s["bound_ms"] for s in self.shapes if s["bound_by"] == "operations")
        return "operations" if by_ops > self.bound - by_ops else "bytes"


def compare(name, kernel_fn, plain_fn, atol=None, rtol_of_max=None, library_fn=None, repeat=False) -> Result:
    """Run kernel and plain version once, check every output's error, then
    time both (and the library call). Functions return a tensor or a tuple.
    With `repeat` the kernel runs again and must give the same bits."""
    import torch

    def as_list(out):
        return [out] if isinstance(out, torch.Tensor) else list(out)

    outs, refs = as_list(kernel_fn()), as_list(plain_fn())
    torch.cuda.synchronize()
    worst, worst_limit, report = 0.0, 0.0, []
    for out, ref in zip(outs, refs):
        if out.shape != ref.shape:
            raise AssertionError(f"{name}: shape {tuple(out.shape)} != plain {tuple(ref.shape)}")
        if not torch.isfinite(out).all():
            raise AssertionError(f"{name}: non-finite output")
        err = (out - ref).abs().max().item()
        limit = atol if atol is not None else rtol_of_max * ref.abs().max().item()
        report.append(f"{err:.3e}/{limit:.3e}")
        if not err <= limit:
            raise AssertionError(f"{name}: max abs error {err} exceeds {limit}")
        if err >= worst:
            worst, worst_limit = err, limit
    if repeat:
        for out, again in zip(outs, as_list(kernel_fn())):
            if not torch.equal(out, again):
                raise AssertionError(f"{name}: a second run on the same inputs gave other bits")
    del outs, refs
    ms, plain_ms = time_ms(kernel_fn), time_ms(plain_fn)
    library_ms = time_ms(library_fn) if library_fn is not None else None
    lib = f", library {library_ms:.4f} ms" if library_ms is not None else ""
    print(f"  {name}: err/limit {' '.join(report)}{', repeats bit for bit' if repeat else ''}; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{lib}")
    return Result(worst, worst_limit, ms, plain_ms, library_ms)


def flagship_frontend(device):
    from dcase2019_task4_tpu_torch.config import Config
    from dcase2019_task4_tpu_torch.ops.mel import MelFrontend

    d = Config().dsp
    return MelFrontend(sample_rate=d.sample_rate, n_window=d.n_window, hop_length=d.hop_length,
                       n_mels=d.n_mels, f_min=d.f_min, f_max=d.f_max, max_frames=d.max_frames,
                       amin=d.amin, top_db=d.top_db, device=device)


def phase_kernels(device):
    import torch
    import torch.nn.functional as F

    from dcase2019_task4_tpu_torch.config import Config
    from dcase2019_task4_tpu_torch.ops import fused_block as fb
    from dcase2019_task4_tpu_torch.ops import fused_mel
    from dcase2019_task4_tpu_torch.ops import packed_conv as pc

    cfg = Config()
    d, m = cfg.dsp, cfg.model
    B = cfg.train.batch_size
    rng = np.random.default_rng(SEED)
    rows = {name: Row() for name in KERNELS}

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    # K1 at the shape the frontend hands it: [B, T + extra_rows, hop]
    fe = flagship_frontend(device)
    audio = (0.1 * rng.standard_normal((B, d.max_samples + d.n_window))).astype(np.float32)
    bases = fused_mel.FusedMelBases(fe.cos_basis, fe.sin_basis, fe.mel_fb)
    kw = dict(n_fft=d.n_window, hop=d.hop_length, T=d.max_frames)
    nb, M = fe.mel_fb.shape
    for dtype in ("float32", "int16"):
        a = torch.as_tensor(audio, device=device)
        if dtype == "int16":
            a = torch.clamp(torch.round(a * 32768.0), -32768, 32767).to(torch.int16)
        chunks = fe._hop_chunks(a)
        library_fn = None
        if dtype == "float32":  # timed for the row; the train step hands K1 int16
            frames = chunks.reshape(B, -1).unfold(1, d.n_window, d.hop_length)[:, : d.max_frames].contiguous()
            both = torch.cat([fe.cos_basis, fe.sin_basis], dim=1)
            library_fn = lambda: torch.matmul(frames, both)  # noqa: E731 — both DFT products as one SGEMM
        res = compare(f"K1 fused_stft_mel {dtype} {list(chunks.shape)}",
                      lambda: fused_mel.fused_stft_mel(chunks, bases, **kw),
                      lambda: fused_mel.fused_stft_mel_reference(chunks, bases, **kw),
                      rtol_of_max=1e-4, library_fn=library_fn)
        if dtype == "float32":
            n_bytes = chunks.numel() * 4 + (2 * d.n_window * nb + nb * M) * 4 + B * d.max_frames * M * 4
            n_ops = 2.0 * B * d.max_frames * nb * (2 * d.n_window + M)
            rows["fused_stft_mel"].add(chunks.shape, res, n_bytes, n_ops)
            del frames, both
        else:
            rows["fused_stft_mel"].note_err(res)

    C = m.nb_filters[1]
    pool = tuple(m.pooling[0])
    geometries = ((d.max_frames, d.n_mels), (d.max_frames // 2, d.n_mels // 4), (d.max_frames // 4, d.n_mels // 16))

    # K3 forward, dx and wgrad at blocks 2 and 3: [B, 432, 16, 64] and [B, 216, 4, 64]
    for T, Fq in geometries[1:]:
        lim = np.sqrt(2.0) * np.sqrt(6.0 / (18 * C))
        w, b = t(rng.uniform(-lim, lim, (3, 3, C, C))), t(0.1 * rng.standard_normal(C))
        params = {"w": w, "b": b}
        x, dy = t(rng.standard_normal((B, T, Fq, C))), t(rng.standard_normal((B, T, Fq, C)))
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        x_cl, dy_cl = (v.permute(0, 3, 1, 2) for v in (x, dy))  # NCHW views in channels-last memory
        act_bytes, conv_ops = x.numel() * 4, 2.0 * x.numel() * 9 * C
        shape = list(x.shape)
        res = compare(f"K3f conv2d_forward {shape}", lambda: pc.conv2d_forward(params, x),
                      lambda: pc.conv2d_reference(params, x), atol=1e-4,
                      library_fn=lambda: F.conv2d(x_cl, w_oihw, b, padding=1))
        rows["conv2d_forward"].add(shape, res, 2 * act_bytes + w.numel() * 4, conv_ops)
        res = compare(f"K3dx conv2d_dx {shape}", lambda: pc.conv2d_dx(w, dy),
                      lambda: pc.conv2d_dx_reference(w, dy), rtol_of_max=1e-4,
                      library_fn=lambda: torch.nn.grad.conv2d_input(x_cl.shape, w_oihw, dy_cl, padding=1))
        rows["conv2d_dx"].add(shape, res, 2 * act_bytes + w.numel() * 4, conv_ops)
        res = compare(f"K3w conv2d_wgrad {shape}", lambda: pc.conv2d_wgrad(x, dy),
                      lambda: pc.conv2d_wgrad_reference(x, dy), rtol_of_max=1e-4, repeat=True,
                      library_fn=lambda: torch.nn.grad.conv2d_weight(x_cl, w_oihw.shape, dy_cl, padding=1))
        rows["conv2d_wgrad"].add(shape, res, 2 * act_bytes + w.numel() * 4, conv_ops)
        del x, dy, x_cl, dy_cl

    # K2 at the three block geometries: eval and train forward, statistics, backward
    seed = torch.tensor([20190415], dtype=torch.int64)  # a CPU tensor, as the model hands it
    rate = m.dropout
    for T, Fq in geometries:
        y = t(rng.standard_normal((B, T, Fq, C)))
        scale, bias = t(1 + 0.1 * rng.standard_normal(C)), t(0.1 * rng.standard_normal(C))
        w, gb = t(rng.standard_normal((C, C)) / np.sqrt(C)), t(0.1 * rng.standard_normal(C))
        run_mean, run_var = t(0.2 * rng.standard_normal(C)), t(rng.uniform(0.5, 2.0, C))
        dout = t(rng.standard_normal((B, T // pool[0], Fq // pool[1], C)))
        shape, pixels = list(y.shape), B * T * Fq
        y_bytes, out_bytes, small = y.numel() * 4, dout.numel() * 4, (C * C + 5 * C) * 4
        mix_ops = 2.0 * pixels * C * C  # one C×C channel product per pixel

        res = compare(f"K2f fused_bn_glu_pool eval {shape}",
                      lambda: fb.fused_bn_glu_pool(y, scale, bias, run_mean, run_var, w, gb, pool, m.bn_eps),
                      lambda: fb.reference_block(y, scale, bias, run_mean, run_var, w, gb, pool, m.bn_eps),
                      atol=1e-5)
        rows["fused_bn_glu_pool_eval"].add(shape, res, y_bytes + out_bytes + small, mix_ops + 12.0 * y.numel())

        res = compare(f"K2s batch_stats {shape}", lambda: fb.batch_stats(y), lambda: fb.batch_stats_reference(y),
                      rtol_of_max=1e-5, repeat=True)
        rows["batch_stats"].add(shape, res, y_bytes + 2 * C * 4, 3.0 * y.numel())
        s, sq = fb.batch_stats(y)
        mean = s / pixels
        var = sq / pixels - mean * mean

        mask = fb.dropout_keep_mask(seed, y.shape, rate, device=device)
        res = compare(f"K2f fused_bn_glu_pool train rate {rate} {shape}",
                      lambda: fb.fused_bn_glu_pool(y, scale, bias, mean, var, w, gb, pool, m.bn_eps, rate=rate, seed=seed),
                      lambda: fb.reference_block(y, scale, bias, mean, var, w, gb, pool, m.bn_eps, mask, 1.0 - rate),
                      atol=1e-5)
        rows["fused_bn_glu_pool_train"].add(shape, res, y_bytes + out_bytes + small, mix_ops + 14.0 * y.numel())
        # the mask alone: y = 0 gives xn = 0 and σ = 1/2 exactly; a GLU of weight
        # 0 and bias 1 then gives g = mask / (2·keep), and the pooled sum counts
        # the kept elements (exactly so at rate 1/2)
        unit = (torch.ones(C, device=device), torch.zeros(C, device=device), torch.zeros(C, device=device),
                torch.ones(C, device=device), torch.zeros(C, C, device=device), torch.ones(C, device=device))
        pooled = fb.fused_bn_glu_pool(torch.zeros_like(y), *unit, pool, m.bn_eps, rate=rate, seed=seed)
        kept = pooled.double().sum().item() * pool[0] * pool[1] * 2.0 * (1.0 - rate)
        n_kept = int(mask.sum(dtype=torch.float64).item())
        if round(kept) != n_kept:
            raise AssertionError(f"K2f train {shape}: kernel kept {kept} elements, dropout_keep_mask {n_kept}")
        print(f"  K2f train {shape}: kept {n_kept} of {mask.numel()} elements, as dropout_keep_mask")

        res = compare(f"K2b bwd_reduce rate {rate} {shape} (dy_partial, dw, db, S1, S2)",
                      lambda: fb.bwd_reduce(y, dout, scale, bias, mean, var, w, gb, pool, m.bn_eps, rate=rate, seed=seed),
                      lambda: fb.bwd_reduce_reference(y, dout, scale, bias, mean, var, w, gb, pool, m.bn_eps, mask, 1.0 - rate),
                      rtol_of_max=1e-4, repeat=True)
        rows["bwd_reduce"].add(shape, res, 2 * y_bytes + out_bytes + 2 * small, 3 * mix_ops + 30.0 * y.numel())
        dyp, _, _, s1, s2 = fb.bwd_reduce(y, dout, scale, bias, mean, var, w, gb, pool, m.bn_eps, rate=rate, seed=seed)
        a, b2 = fb.bwd_coefficients(scale, var, m.bn_eps, s1, s2, pixels)
        res = compare(f"K2b bwd_fixup {shape}", lambda: fb.bwd_fixup(y, dyp.clone(), a, b2, mean),
                      lambda: fb.bwd_fixup_reference(y, dyp.clone(), a, b2, mean), rtol_of_max=1e-4, repeat=True)
        # both timed with a clone of dy_partial (the kernel writes in place); take it off
        clone_ms = time_ms(lambda: dyp.clone())
        res = res._replace(ms=max(res.ms - clone_ms, 0.0), plain_ms=max(res.plain_ms - clone_ms, 0.0))
        rows["bwd_fixup"].add(shape, res, 3 * y_bytes, 3.0 * y.numel())
        print(f"  K2b bwd_fixup {shape}: clone of dy_partial {clone_ms:.4f} ms taken off both times")

        # the whole backward through the autograd Function against the formulas
        leaves = [v.clone().requires_grad_(True) for v in (y, scale, bias, w, gb)]
        fb.fused_bn_glu_dropout_pool(leaves[0], leaves[1], leaves[2], mean, var, leaves[3], leaves[4],
                                     seed, rate, pool, m.bn_eps, True).backward(dout)
        ref = fb.bwd_reference(y, dout, scale, bias, mean, var, w, gb, pool, m.bn_eps, mask, 1.0 - rate)
        for name, leaf, want in zip(("dy", "dscale", "dbias", "dw", "db"), leaves, ref):
            err, limit = (leaf.grad - want).abs().max().item(), 1e-4 * want.abs().max().item()
            if not err <= limit:
                raise AssertionError(f"K2b Function {shape}: {name} error {err} exceeds {limit}")
        del y, dout, mask, dyp, leaves, ref, pooled
        torch.cuda.empty_cache()
    return rows


def make_clips(n: int, rng):
    """n seeded synthetic 10 s clips → (names, events per clip, audio)."""
    from dcase2019_task4_tpu_torch.config import DEFAULT_CLASSES, Config
    from dcase2019_task4_tpu_torch.data.audio_io import synth_clip

    d = Config().dsp
    names, all_events, clips = [], [], []
    for i in range(n):
        events = []
        for _ in range(int(rng.integers(1, 4))):
            on = float(rng.uniform(0, 8))
            events.append((int(rng.integers(0, len(DEFAULT_CLASSES))), on, on + float(rng.uniform(0.5, 10 - on))))
        name = f"clip_{i:03d}.wav"
        names.append(name)
        all_events.append(events)
        clips.append(np.clip(synth_clip(name, events, d.max_len_seconds, d.sample_rate), -1, 1))
    return names, all_events, clips


def pack_clips(clips):
    """→ (int16 reflect-padded audio [B, Lp], valid frames [B]) as the data
    pipeline packs a batch."""
    from dcase2019_task4_tpu_torch.config import Config
    from dcase2019_task4_tpu_torch.data.pipeline import quantize_audio_int16
    from dcase2019_task4_tpu_torch.ops.mel import host_reflect_pad

    d = Config().dsp
    padded, frames = host_reflect_pad(clips, d.max_samples, d.n_window, d.hop_length, d.max_frames)
    return quantize_audio_int16(padded), frames


def fit_scaler(frontend, audio_i16, frames, device):
    """Scaler state fitted on one batch's log-mel features."""
    import torch

    audio = torch.as_tensor(audio_i16, device=device).to(torch.float32) / 32768.0
    feats = frontend.log_mel(audio, torch.as_tensor(frames, device=device)).double().cpu().numpy()
    return {"mean_": feats.mean(axis=(0, 1)).tolist(),
            "mean_of_square_": (feats ** 2).mean(axis=(0, 1)).tolist()}


def write_inputs(workdir: str, device):
    """48 synthetic wavs, and a checkpoint of a seeded flagship CRNN whose
    scaler is fitted on the first batch's log-mel features."""
    from dcase2019_task4_tpu_torch.config import DEFAULT_CLASSES, Config
    from dcase2019_task4_tpu_torch.data.audio_io import write_wav
    from dcase2019_task4_tpu_torch.data.encoder import LabelCodec
    from dcase2019_task4_tpu_torch.models.crnn import CRNN, seeded_init_
    from dcase2019_task4_tpu_torch.train import checkpoints as ckpt

    cfg = Config()
    d = cfg.dsp
    wav_dir = os.path.join(workdir, "wavs")
    os.makedirs(wav_dir)
    names, _, clips = make_clips(N_CLIPS, np.random.default_rng(SEED))
    for name, audio in zip(names, clips):
        write_wav(os.path.join(wav_dir, name), audio, d.sample_rate)
    audio_i16, frames = pack_clips(clips[: cfg.train.batch_size])
    scaler = fit_scaler(flagship_frontend(device), audio_i16, frames, device)

    model = seeded_init_(CRNN(cfg.model), SEED)
    params, bn_state = ckpt.params_to_jax(model)
    meta = {
        "epoch": 0,
        "valid_metric": {},
        "pooling_time_ratio": cfg.model.pooling_time_ratio,
        "scaler": scaler,
        "many_hot_encoder": LabelCodec(DEFAULT_CLASSES, d.max_frames // cfg.model.pooling_time_ratio).state_dict(),
        "config": dataclasses.asdict(cfg),
        "mean_teacher": True,
    }
    path = os.path.join(workdir, "model.npz")
    ckpt.save_inference_checkpoint(path, params, bn_state, meta)
    return wav_dir, path


def read_tsv(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f, delimiter="\t"))


def phase_predict(device, card: str):
    import torch

    from dcase2019_task4_tpu_torch import cli

    with tempfile.TemporaryDirectory() as work:
        wav_dir, model = write_inputs(work, device)
        out, tags = os.path.join(work, "events.tsv"), os.path.join(work, "tags.tsv")
        argv = ["-m", model, "-i", wav_dir, "-p", out, "--weak_fname", tags]

        zero_launches()
        res = cli.predict(argv + ["--device", "cuda"])
        torch.cuda.synchronize()
        launches = read_launches()
        print(f"  launches during predict: {launches}")
        check_launches(launches, PREDICT_MIN, 1, "the predict run")
        strong = res["strong"]
        if res["n_files"] != N_CLIPS or strong.shape != (N_CLIPS, 108, 10) or not np.isfinite(strong).all():
            raise AssertionError(f"strong probabilities: n_files {res['n_files']}, shape {strong.shape}")
        events, tag_rows = read_tsv(out), read_tsv(tags)
        if len(tag_rows) != N_CLIPS or any(set(r) != {"event_label", "onset", "offset", "filename"} for r in events):
            raise AssertionError("events / tags TSV malformed")
        for r in events:
            if not 0.0 <= float(r["onset"]) < float(r["offset"]):
                raise AssertionError(f"bad event row {r}")
        print(f"  events TSV: {len(events)} rows; tags TSV: {len(tag_rows)} rows")

        t0 = time.perf_counter()
        cli.predict(argv + ["--device", "cuda"])
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        clips_per_s = N_CLIPS / warm_s
        print(f"  warm CUDA predict: {N_CLIPS} clips in {warm_s:.3f} s = {clips_per_s:.2f} clips/s "
              f"(checkpoint load, wav decode, features, model, decode, TSV writes) on {card}")

        cpu = cli.predict(argv + ["--device", "cpu"])
        diff = float(np.abs(cpu["strong"] - strong).max())
        print(f"  CUDA vs CPU (plain versions) strong max abs diff: {diff:.3e} (limit {STRONG_TOL})")
        if not diff <= STRONG_TOL:
            raise AssertionError(f"CUDA and CPU strong probabilities differ by {diff}")
    return launches, clips_per_s


def train_batch(cfg, n_weak: int, n_unlabel: int, n_strong: int):
    """A packed training batch [weak | unlabeled | synthetic] of seeded
    synthetic clips: int16 audio, valid frames, targets from the LabelCodec
    (weak tags on every frame, −1 for unlabeled, event grids for strong)."""
    from dcase2019_task4_tpu_torch.config import DEFAULT_CLASSES
    from dcase2019_task4_tpu_torch.data.encoder import LabelCodec, events_to_frames

    d, ptr = cfg.dsp, cfg.model.pooling_time_ratio
    codec = LabelCodec(DEFAULT_CLASSES, d.max_frames // ptr)
    _, all_events, clips = make_clips(n_weak + n_unlabel + n_strong, np.random.default_rng(SEED + 1))
    targets = []
    for i, events in enumerate(all_events):
        if i < n_weak:
            targets.append(codec.encode_strong(sorted({DEFAULT_CLASSES[c] for c, _, _ in events})))
        elif i < n_weak + n_unlabel:
            targets.append(codec.encode_strong("empty"))
        else:
            on, off = events_to_frames([e[1] for e in events], [e[2] for e in events],
                                       d.sample_rate, d.hop_length, ptr)
            targets.append(codec.encode_strong([(DEFAULT_CLASSES[e[0]], a, b) for e, a, b in zip(events, on, off)]))
    audio, frames = pack_clips(clips)
    return audio, frames, np.stack(targets).astype(np.float32)


def is_gauge_leaf(name: str) -> bool:
    """Parameters whose step-1 gradient is rounding noise: conv biases ahead
    of a BatchNorm (which takes the batch mean off again) and the attention
    head's logits."""
    return name.endswith(".conv.bias") or name.startswith("dense_softmax.")


def compare_metrics(step: int, on_card: dict, on_cpu: dict):
    for k, v in on_cpu.items():
        if not abs(v.item() - on_card[k]) <= TRAIN_TOL:
            raise AssertionError(f"step {step} {k}: CUDA {on_card[k]} vs CPU {v.item()}")


def phase_train(device, card: str):
    import torch

    from dcase2019_task4_tpu_torch.config import Config
    from dcase2019_task4_tpu_torch.train import steps
    from dcase2019_task4_tpu_torch.utils.scaler import Scaler

    cfg = Config()
    tr = cfg.train
    n_weak, n_unlabel, n_strong = tr.batch_size // 4, tr.batch_size // 2, tr.batch_size // 4
    weak_slice, strong_slice = slice(0, n_weak), slice(n_weak + n_unlabel, tr.batch_size)
    audio, frames, target = train_batch(cfg, n_weak, n_unlabel, n_strong)
    mean, std = Scaler().load_state_dict(fit_scaler(flagship_frontend(device), audio, frames, device)).mean_std_f32

    def adam(params):
        return torch.optim.Adam(params, lr=tr.lr, betas=(tr.beta1, tr.beta2), eps=tr.adam_eps)

    def build(dev):
        step = steps.make_train_step(
            weak_slice, strong_slice, mean_teacher=True, rampup_length=10,
            max_consistency_cost=tr.max_consistency_cost, ema_alpha=tr.ema_alpha,
            frontend=flagship_frontend(dev), scaler_mean=mean, scaler_std=std, noise_std=tr.noise_std)
        batch = {"audio": torch.as_tensor(audio, device=dev), "frames": torch.as_tensor(frames, device=dev),
                 "target": torch.as_tensor(target, device=dev)}
        return step, batch

    base = steps.init_train_state(cfg.model, adam, torch.Generator().manual_seed(SEED))
    state = steps.TrainState(copy.deepcopy(base.student).to(device), copy.deepcopy(base.teacher).to(device), None)
    state.optimizer = adam(state.student.parameters())
    step, batch = build(device)
    generator = torch.Generator().manual_seed(SEED + 2)
    acc = step.zero_metrics(device)

    def buffers(model):
        return [b.detach().clone() for blk in model.cnn for b in (blk.bn.running_mean, blk.bn.running_var)]

    teacher_before = [p.detach().clone() for p in state.teacher.parameters()]
    buf_before = buffers(state.student), buffers(state.teacher)
    history, step_ms, first_grads = [], [], None
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics, acc = step(state, batch, generator, acc)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        history.append({k: v.item() for k, v in metrics.items()})  # read outside the step
        print(f"  step {i + 1}: {step_ms[-1]:.2f} ms, " + ", ".join(f"{k} {v:.5f}" for k, v in history[-1].items()))
        if i == 0:
            first_grads = [p.grad.detach().cpu().clone() for p in state.student.parameters()]
            alpha = steps.ema_alpha_at(0, tr.ema_alpha)
            for old, new, cur in zip(teacher_before, state.teacher.parameters(), state.student.parameters()):
                want = alpha * old + (1.0 - alpha) * cur.detach()
                if not torch.allclose(new, want, rtol=1e-6, atol=1e-7):
                    raise AssertionError("teacher parameters are not α·old + (1−α)·student after step 1")
            if all(torch.equal(a, b) for a, b in zip(teacher_before, state.teacher.parameters())):
                raise AssertionError("teacher parameters did not move")
    launches = read_launches()
    print(f"  launches during {TRAIN_STEPS} train steps: {launches}")
    check_launches(launches, STEP_MIN, TRAIN_STEPS, f"{TRAIN_STEPS} train steps")
    if not all(np.isfinite(v) for h in history for v in h.values()):
        raise AssertionError("a training metric is not finite")
    if not history[-1]["loss"] < history[0]["loss"]:
        raise AssertionError(f"loss did not fall: {history[0]['loss']} -> {history[-1]['loss']}")
    sums = {k: v.item() for k, v in acc.items()}
    for k in step.metric_keys:
        if abs(sums[k] - sum(h[k] for h in history)) > 1e-4:
            raise AssertionError(f"metric accumulator {k} is not the sum of the steps' metrics")
    buf_after = buffers(state.student), buffers(state.teacher)
    for before, after in zip(buf_before, buf_after):
        if any(torch.equal(a, b) for a, b in zip(before, after)):
            raise AssertionError("a BatchNorm buffer did not move")
    if all(torch.equal(a, b) for a, b in zip(*buf_after)):
        raise AssertionError("student and teacher BatchNorm buffers are equal")
    warm_ms = float(np.median(step_ms[1:]))
    print(f"  MT step: {warm_ms:.3f} ms per step (median of steps 2-{TRAIN_STEPS}, synchronised; "
          f"first step {step_ms[0]:.1f} ms) on {card}")
    print(f"  peak device memory over the steps: {torch.cuda.max_memory_allocated() / 2 ** 20:.0f} MiB")
    profile_step(step, state, batch, generator, acc, card, warm_ms,
                 noise_shape=(tr.batch_size, cfg.dsp.max_frames, cfg.dsp.n_mels))

    # the same steps with the generator on the card: no draw on the host, no
    # copy of the noise (not repeatable against the CPU, so checked for finite
    # losses only)
    card_generator = torch.Generator(device=device).manual_seed(SEED + 3)
    card_ms = []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics, acc = step(state, batch, card_generator, acc)
        torch.cuda.synchronize()
        card_ms.append(1e3 * (time.perf_counter() - t0))
    if not all(np.isfinite(v.item()) for v in metrics.values()):
        raise AssertionError("a training metric is not finite with the generator on the card")
    print(f"  MT step with the generator on the card: {float(np.median(card_ms[1:])):.3f} ms per step "
          f"(median of {TRAIN_STEPS - 1}; {warm_ms:.3f} ms with the CPU generator) on {card}")

    # steps 1 and 2 again on the CPU: plain versions, same state, same generator seed
    cpu_state = steps.TrainState(base.student, base.teacher, base.optimizer)
    cpu_step, cpu_batch = build(torch.device("cpu"))
    cpu_generator, cpu_acc = torch.Generator().manual_seed(SEED + 2), cpu_step.zero_metrics()
    t0 = time.perf_counter()
    cpu_state, cpu_metrics, cpu_acc = cpu_step(cpu_state, cpu_batch, cpu_generator, cpu_acc)
    print(f"  CPU step 1 (plain versions): {time.perf_counter() - t0:.1f} s")
    compare_metrics(1, history[0], cpu_metrics)
    names = [n for n, _ in cpu_state.student.named_parameters()]
    cpu_grads = dict(zip(names, (p.grad.detach().clone() for p in cpu_state.student.parameters())))
    gpu_grads = dict(zip(names, first_grads))
    # Every leaf within 1e-4 of its own max. The gauge leaves alone get a
    # float32 noise floor of 1e-6 of the step's largest gradient on top: a conv
    # bias ahead of a BatchNorm has a zero gradient in exact arithmetic, and
    # the attention head's logits (near-uniform softmax at this init) have
    # sums that cancel almost completely, so what float32 leaves there is
    # rounding noise of the terms summed. Those are held in function space
    # instead: Adam divides such noise by its own size and moves these leaves
    # by about the learning rate in either run, and step 2, taken after that
    # update, must give the same loss and metrics in both.
    top = max(g.abs().max().item() for g in cpu_grads.values())
    worst, worst_gauge, failures = 0.0, 0.0, []
    print(f"  step 1 gradients, CUDA against CPU (largest gradient {top:.3e}):")
    for name in names:
        a, b = cpu_grads[name], gpu_grads[name]
        err, own = (a - b).abs().max().item(), a.abs().max().item()
        gauge = is_gauge_leaf(name)
        limit = TRAIN_TOL * own + (GRAD_FLOOR * top if gauge else 0.0)
        print(f"    {name:28s} max {own:.3e}  err {err:.3e}  err/max {err / max(own, 1e-30):.2e}  "
              f"err/largest {err / top:.2e}  err/limit {err / max(limit, 1e-300):.2f}{'  (gauge: floor applies)' if gauge else ''}")
        if gauge:
            worst_gauge = max(worst_gauge, err / max(limit, 1e-300))
        else:
            worst = max(worst, err / max(limit, 1e-300))
        if not err <= limit:
            failures.append(f"{name}: CUDA and CPU differ by {err:.3e} (limit {limit:.3e})")
    if failures:
        raise AssertionError("step 1 gradients:\n  " + "\n  ".join(failures))
    t0 = time.perf_counter()
    cpu_state, cpu_metrics2, cpu_acc = cpu_step(cpu_state, cpu_batch, cpu_generator, cpu_acc)
    print(f"  CPU step 2 (plain versions, after the first update): {time.perf_counter() - t0:.1f} s")
    compare_metrics(2, history[1], cpu_metrics2)
    print(f"  CUDA vs CPU: step 1 loss {history[0]['loss']:.6f} vs {cpu_metrics['loss'].item():.6f}, "
          f"step 2 loss {history[1]['loss']:.6f} vs {cpu_metrics2['loss'].item():.6f} (limit {TRAIN_TOL}); "
          f"worst gradient leaf at {worst:.2f} of its limit ({TRAIN_TOL} of its max), worst gauge leaf at "
          f"{worst_gauge:.2f} of its ({TRAIN_TOL} of its max + {GRAD_FLOOR} of the largest)")
    return launches, warm_ms


def profile_step(step, state, batch, generator, acc, card: str, step_ms: float, noise_shape):
    """torch.profiler over one warm step: device time by kernel (kernel
    events only: an operator's row repeats the time of the kernels it
    launched), and the device's idle share of an unprofiled step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, batch, generator, acc)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not events:
        raise AssertionError("torch.profiler recorded no device time")
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"  profile of one warm step on {card}: wall {wall_ms:.2f} ms (profiler on), "
          f"device busy {busy_ms:.3f} ms in {sum(e.count for e in events)} kernels and copies = "
          f"{100.0 * busy_ms / step_ms:.1f} % of the {step_ms:.3f} ms step (idle {100.0 * (1.0 - busy_ms / step_ms):.1f} %)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:24]:
        print(f"    {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:90]}")
    host = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU]
    print("  the same step on the host, by self CPU time (profiler on):")
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:10]:
        print(f"    {e.self_cpu_time_total / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:90]}")
    # the step's one large host-side draw: the teacher's noise from the CPU generator
    t0 = time.perf_counter()
    for _ in range(5):
        torch.randn(noise_shape, generator=generator, device=generator.device)
    print(f"  host: drawing the teacher's noise {list(noise_shape)} from the CPU generator takes "
          f"{1e3 * (time.perf_counter() - t0) / 5:.3f} ms per step, during which the card waits")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from dcase2019_task4_tpu_torch.ops import _build

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    print("== phase 1: card")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}, "
          f"count {torch.cuda.device_count()}")

    print("== phase 2: build")
    info = _build.build()
    print(f"  built {os.path.relpath(info['path'], REPO)} in {info['seconds']:.2f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")
    _build.library()

    print("== phase 3: kernels against their plain versions (float32, TF32 off)")
    rows = phase_kernels(device)

    print("== phase 4: predict through the CLI")
    predict_launches, clips_per_s = phase_predict(device, card)

    print("== phase 5: Mean-Teacher training steps")
    train_launches, step_ms = phase_train(device, card)

    report = []
    for name, (src, replaces) in KERNELS.items():
        row = rows[name]
        on_path = predict_launches[name] if name in PREDICT_MIN else train_launches[name]
        if on_path < 1:
            raise AssertionError(f"{name} was launched no time on its path")
        report.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": on_path, "max_abs_err": row.err, "err_limit": row.limit,
            "ms": row.ms, "plain_ms": row.plain_ms,
            "bound_ms": row.bound, "bound_by": row.bound_by, "library_ms": row.library_ms,
            "bound_by_shape": row.shapes,
            "launches_predict": predict_launches[name], "launches_train": train_launches[name],
        })
    print(f"  predict clips/s (warm): {clips_per_s:.2f}; MT step {step_ms:.3f} ms on {card}; "
          f"whole script {time.perf_counter() - t_start:.0f} s")
    print(card)
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
