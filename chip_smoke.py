#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dcase2019_task4_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero without
printing a result:

  1. card   — nvidia-smi's name and power limit, torch's device name;
  2. build  — compile csrc/*.cu with nvcc for sm_90a (ptxas report printed);
  3. kernels — each hand-written kernel against its plain PyTorch twin on
     the card, at the flagship shapes, float32 with TF32 off: max abs and
     relative error, median time over 10 runs after 3 warm-ups (CUDA
     events) for the kernel and for the twin;
  4. predict — 48 synthetic 10 s wavs (two batches of 24) and a checkpoint
     of a seeded flagship CRNN written by the port's own writer, through
     `cli.predict(... --device cuda)`: the TSVs parse, every kernel's launch
     counter rose, strong probabilities are finite and agree with the same
     run on `--device cpu` (the plain twins) within 1e-4; clips/s of a
     second, warm CUDA pass.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports neither jax nor pandas.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
N_CLIPS = 48
STRONG_TOL = 1e-4


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


def compare(name, kernel_fn, plain_fn, atol=None, rtol_of_max=None):
    """Run kernel and twin once, check the error, then time both."""
    import torch

    out = kernel_fn()
    ref = plain_fn()
    torch.cuda.synchronize()
    if out.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(out.shape)} != twin {tuple(ref.shape)}")
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (out - ref).abs().max().item()
    scale = ref.abs().max().item()
    limit = atol if atol is not None else rtol_of_max * scale
    ms, plain_ms = time_ms(kernel_fn), time_ms(plain_fn)
    print(f"  {name}: max_abs_err {err:.3e} (limit {limit:.3e}), rel {err / max(scale, 1e-30):.3e}, "
          f"kernel {ms:.4f} ms, twin {plain_ms:.4f} ms")
    if not err <= limit:
        raise AssertionError(f"{name}: max abs error {err} exceeds {limit}")
    return err, ms, plain_ms


def phase_kernels(device):
    import torch

    from dcase2019_task4_tpu.config import Config
    from dcase2019_task4_tpu_torch.ops import fused_block, fused_mel, packed_conv
    from dcase2019_task4_tpu_torch.ops.mel import MelFrontend

    cfg = Config()
    d, m = cfg.dsp, cfg.model
    B = cfg.train.batch_size
    rng = np.random.default_rng(SEED)
    results = {}

    # K1 at the shape the frontend hands it: [B, T + extra_rows, hop]
    fe = MelFrontend(sample_rate=d.sample_rate, n_window=d.n_window, hop_length=d.hop_length,
                     n_mels=d.n_mels, f_min=d.f_min, f_max=d.f_max, max_frames=d.max_frames,
                     device=device)
    audio = (0.1 * rng.standard_normal((B, d.max_samples + d.n_window))).astype(np.float32)
    bases = fused_mel.FusedMelBases(fe.cos_basis, fe.sin_basis, fe.mel_fb)
    kw = dict(n_fft=d.n_window, hop=d.hop_length, T=d.max_frames)
    errs, ms, pms = [], 0.0, 0.0
    for dtype in ("float32", "int16"):
        a = torch.as_tensor(audio, device=device)
        if dtype == "int16":
            a = torch.clamp(torch.round(a * 32768.0), -32768, 32767).to(torch.int16)
        chunks = fe._hop_chunks(a)
        e, k_ms, p_ms = compare(
            f"K1 fused_stft_mel {dtype} {list(chunks.shape)}",
            lambda: fused_mel.fused_stft_mel(chunks, bases, **kw),
            lambda: fused_mel.fused_stft_mel_reference(chunks, bases, **kw),
            rtol_of_max=1e-4,
        )
        errs.append(e)
        if dtype == "float32":  # the serving path hands K1 float32
            ms, pms = k_ms, p_ms
    results["fused_stft_mel"] = (max(errs), ms, pms)

    # K3 at blocks 2 and 3: [B, 432, 16, 64] and [B, 216, 4, 64]
    C = m.nb_filters[1]
    errs, ms, pms = [], 0.0, 0.0
    for T, Fq in ((d.max_frames // 2, d.n_mels // 4), (d.max_frames // 4, d.n_mels // 16)):
        lim = np.sqrt(2.0) * np.sqrt(6.0 / (18 * C))
        params = {
            "w": torch.as_tensor(rng.uniform(-lim, lim, (3, 3, C, C)).astype(np.float32), device=device),
            "b": torch.as_tensor(0.1 * rng.standard_normal(C).astype(np.float32), device=device),
        }
        x = torch.as_tensor(rng.standard_normal((B, T, Fq, C)).astype(np.float32), device=device)
        e, k_ms, p_ms = compare(
            f"K3 conv2d_packed {list(x.shape)}",
            lambda: packed_conv.conv2d_packed(params, x),
            lambda: packed_conv.conv2d_reference(params, x),
            atol=1e-4,
        )
        errs.append(e)
        ms, pms = ms + k_ms, pms + p_ms
    results["conv2d_packed"] = (max(errs), ms, pms)

    # K2 eval at the three block geometries
    errs, ms, pms = [], 0.0, 0.0
    for T, Fq in ((d.max_frames, d.n_mels), (d.max_frames // 2, d.n_mels // 4),
                  (d.max_frames // 4, d.n_mels // 16)):
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
        y = t(rng.standard_normal((B, T, Fq, C)))
        args = (t(1 + 0.1 * rng.standard_normal(C)), t(0.1 * rng.standard_normal(C)),
                t(0.2 * rng.standard_normal(C)), t(rng.uniform(0.5, 2.0, C)),
                t(rng.standard_normal((C, C)) / np.sqrt(C)), t(0.1 * rng.standard_normal(C)))
        pool = tuple(m.pooling[0])
        e, k_ms, p_ms = compare(
            f"K2 fused_bn_glu_pool {list(y.shape)}",
            lambda: fused_block.fused_bn_glu_pool(y, *args, pool, m.bn_eps),
            lambda: fused_block.reference_block(y, *args, pool, m.bn_eps),
            atol=1e-5,
        )
        errs.append(e)
        ms, pms = ms + k_ms, pms + p_ms
    results["fused_bn_glu_pool"] = (max(errs), ms, pms)
    return results


def write_inputs(workdir: str, device):
    """48 synthetic wavs, and a checkpoint of a seeded flagship CRNN whose
    scaler is fitted on the first batch's log-mel features."""
    import torch

    from dcase2019_task4_tpu.config import DEFAULT_CLASSES, Config
    from dcase2019_task4_tpu_torch._host import LabelCodec, synth_clip, write_wav
    from dcase2019_task4_tpu_torch.data.pipeline import quantize_audio_int16
    from dcase2019_task4_tpu_torch.models.crnn import CRNN, seeded_init_
    from dcase2019_task4_tpu_torch.ops.mel import MelFrontend, host_reflect_pad
    from dcase2019_task4_tpu_torch.train import checkpoints as ckpt

    cfg = Config()
    d = cfg.dsp
    rng = np.random.default_rng(SEED)
    wav_dir = os.path.join(workdir, "wavs")
    os.makedirs(wav_dir)
    clips = []
    for i in range(N_CLIPS):
        events = []
        for _ in range(int(rng.integers(1, 4))):
            on = float(rng.uniform(0, 8))
            events.append((int(rng.integers(0, len(DEFAULT_CLASSES))), on, on + float(rng.uniform(0.5, 10 - on))))
        name = f"clip_{i:03d}.wav"
        audio = synth_clip(name, events, d.max_len_seconds, d.sample_rate)
        write_wav(os.path.join(wav_dir, name), audio, d.sample_rate)
        clips.append(np.clip(audio, -1, 1))

    fe = MelFrontend(sample_rate=d.sample_rate, n_window=d.n_window, hop_length=d.hop_length,
                     n_mels=d.n_mels, f_min=d.f_min, f_max=d.f_max, max_frames=d.max_frames,
                     device=device)
    padded, frames = host_reflect_pad(clips[: cfg.train.batch_size], d.max_samples, d.n_window,
                                      d.hop_length, d.max_frames)
    audio = torch.as_tensor(quantize_audio_int16(padded), device=device).to(torch.float32) / 32768.0
    feats = fe.log_mel(audio, torch.as_tensor(frames, device=device)).double().cpu().numpy()
    scaler = {"mean_": feats.mean(axis=(0, 1)).tolist(),
              "mean_of_square_": (feats ** 2).mean(axis=(0, 1)).tolist()}

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
    from dcase2019_task4_tpu_torch.ops import fused_block, fused_mel, packed_conv

    wrappers = {"fused_stft_mel": fused_mel.fused_stft_mel, "conv2d_packed": packed_conv.conv2d_packed,
                "fused_bn_glu_pool": fused_block.fused_bn_glu_pool}
    minimum = {"fused_stft_mel": 2, "conv2d_packed": 4, "fused_bn_glu_pool": 6}
    with tempfile.TemporaryDirectory() as work:
        wav_dir, model = write_inputs(work, device)
        out, tags = os.path.join(work, "events.tsv"), os.path.join(work, "tags.tsv")
        argv = ["-m", model, "-i", wav_dir, "-p", out, "--weak_fname", tags]

        for w in wrappers.values():
            w.launches = 0
        res = cli.predict(argv + ["--device", "cuda"])
        torch.cuda.synchronize()
        launches = {name: w.launches for name, w in wrappers.items()}
        print(f"  launches during predict: {launches}")
        for name, n in launches.items():
            if n < minimum[name]:
                raise AssertionError(f"{name} launched {n} times in the predict run (expected >= {minimum[name]})")
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
        print(f"  CUDA vs CPU (plain twins) strong max abs diff: {diff:.3e} (limit {STRONG_TOL})")
        if not diff <= STRONG_TOL:
            raise AssertionError(f"CUDA and CPU strong probabilities differ by {diff}")
    return launches, clips_per_s


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

    print("== phase 3: kernels against their plain twins (float32, TF32 off)")
    kernels = phase_kernels(device)

    print("== phase 4: predict through the CLI")
    launches, clips_per_s = phase_predict(device, card)

    sources = {
        "fused_stft_mel": ("dcase2019_task4_tpu_torch/csrc/fused_mel.cu", "dcase2019_task4_tpu/ops/fused_mel.py:174"),
        "conv2d_packed": ("dcase2019_task4_tpu_torch/csrc/packed_conv.cu", "dcase2019_task4_tpu/ops/packed_conv.py:122"),
        "fused_bn_glu_pool": ("dcase2019_task4_tpu_torch/csrc/fused_block.cu", "dcase2019_task4_tpu/ops/fused_block.py:243"),
    }
    report = []
    for name, (err, ms, plain_ms) in kernels.items():
        src, replaces = sources[name]
        report.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                       "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(f"  predict clips/s (warm): {clips_per_s:.2f} on {card}")
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
