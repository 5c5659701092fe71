"""Warm `cli.predict` of the PyTorch/CUDA port on one card, this checkout
beside another, and the host cost of calling the forward kernels through
their torch.library ops.

    python tools/bench_predict_dispatch_torch.py [--against DIR]

Writes 48 seeded synthetic 10 s wavs and a checkpoint of a seeded flagship
CRNN (`Config()`, float32) once, then in a child process per checkout (the
checkout's own package first on the path, its kernels built there) runs
`cli.predict -m CKPT -i WAVS -p OUT --device cuda` once cold and 5 times
warm, each timed on the host clock from the call to its return
(evaluator build, wav decode, features, model, decode, TSV writes; the same
reading as chip_smoke.py phase 4). With `--against DIR` (another checkout,
e.g. a parent unpacked by `git archive`) the children run in the order DIR,
this, this, DIR. This checkout's child also times, at the flagship's
block-2 shapes, 200 calls of each eval-mode op (`dcase19_torch::conv2d_forward`,
`dcase19_torch::fused_bn_glu_pool_eval`) against 200 calls of its wrapper
on the same tensors: host µs a call to enqueue (no synchronisation inside
the loop), so the difference is the dispatcher's cost. Prints the card's
name and power limit, each child's JSON line, and one JSON line of all of
them last. Without a card `main` returns 2.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_CLIPS = 48
RUNS = 5  # warm predict calls a checkout


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "nvidia-smi: no reading"


def write_inputs(work: str):
    """48 seeded synthetic wavs and a seeded flagship checkpoint, written by
    this checkout's package (both checkouts read the format)."""
    import numpy as np

    sys.path.insert(0, REPO)
    from dcase2019_task4_tpu_torch.config import DEFAULT_CLASSES, Config
    from dcase2019_task4_tpu_torch.data.audio_io import synth_clip, write_wav
    from dcase2019_task4_tpu_torch.data.encoder import LabelCodec
    from dcase2019_task4_tpu_torch.models.crnn import CRNN, seeded_init_
    from dcase2019_task4_tpu_torch.train import checkpoints as ckpt

    cfg = Config()
    d = cfg.dsp
    wav_dir = os.path.join(work, "wavs")
    os.makedirs(wav_dir)
    rng = np.random.default_rng(0)
    for i in range(N_CLIPS):
        on = float(rng.uniform(0, 8))
        events = [(int(rng.integers(len(DEFAULT_CLASSES))), on, on + float(rng.uniform(0.5, 10 - on)))]
        name = f"clip_{i:03d}.wav"
        write_wav(os.path.join(wav_dir, name), np.clip(synth_clip(name, events, d.max_len_seconds, d.sample_rate), -1, 1),
                  d.sample_rate)
    params, bn_state = ckpt.params_to_jax(seeded_init_(CRNN(cfg.model), 0))
    meta = {"epoch": 0, "valid_metric": {}, "pooling_time_ratio": 8,
            "scaler": {"mean_": [-40.0] * d.n_mels, "mean_of_square_": [1700.0] * d.n_mels},
            "many_hot_encoder": LabelCodec(DEFAULT_CLASSES, d.max_frames // 8).state_dict(),
            "config": ckpt.config_to_dict(cfg), "mean_teacher": True}
    model = os.path.join(work, "model.npz")
    ckpt.save_inference_checkpoint(model, params, bn_state, meta)
    return wav_dir, model


def _dispatch_us(device) -> dict:
    """Host µs a call: each eval-mode op against its wrapper, 200 calls
    each at the flagship's block-2 shapes, after 20 warm-up calls."""
    import numpy as np
    import torch

    from dcase2019_task4_tpu_torch.ops import fused_block, packed_conv

    rng = np.random.default_rng(1)
    t = lambda *shape, s=1.0: torch.as_tensor((s * rng.standard_normal(shape)).astype(np.float32), device=device)  # noqa: E731
    C = 64
    y = t(24, 432, 16, C)
    w, b = t(3, 3, C, C, s=0.05), t(C, s=0.1)
    vecs = (1 + t(C, s=0.1), t(C, s=0.1), t(C, s=0.1), 1 + t(C, s=0.1).abs(), t(C, C, s=C ** -0.5), t(C, s=0.1))
    calls = {
        "conv2d_forward": (lambda: torch.ops.dcase19_torch.conv2d_forward(y, w, b),
                           lambda: packed_conv.conv2d_forward({"w": w, "b": b}, y)),
        "fused_bn_glu_pool_eval": (lambda: torch.ops.dcase19_torch.fused_bn_glu_pool_eval(y, *vecs, [2, 4], 1e-3),
                                   lambda: fused_block.fused_bn_glu_pool(y, *vecs, (2, 4), 1e-3)),
    }
    out = {}
    for name, (op, wrapper) in calls.items():
        row = {}
        for kind, fn in (("op", op), ("wrapper", wrapper), ("op_again", op), ("wrapper_again", wrapper)):
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            row[kind] = 1e6 * (time.perf_counter() - t0) / 200
            torch.cuda.synchronize()
        out[name] = row
    return out


def measure(repo: str, wav_dir: str, model: str) -> dict:
    """In a child: `cli.predict` of `repo`'s package, one cold and RUNS
    warm calls, host ms each; this checkout's op dispatch costs."""
    sys.path.insert(0, repo)
    import torch

    from dcase2019_task4_tpu_torch import cli

    out = os.path.join(tempfile.mkdtemp(), "events.tsv")
    argv = ["-m", model, "-i", wav_dir, "-p", out, "--device", "cuda"]
    times = []
    for _ in range(1 + RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli.predict(argv)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    result = {"repo": repo, "cold_ms": times[0], "warm_ms": times[1:], "median_warm_ms": sorted(times[1:])[RUNS // 2]}
    if hasattr(torch.ops.dcase19_torch, "conv2d_forward"):
        result["dispatch_us"] = _dispatch_us(torch.device("cuda"))
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--against", type=str, default=None, help="another checkout, timed beside this one")
    p.add_argument("--measure", nargs=3, metavar=("REPO", "WAV_DIR", "MODEL"), help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("bench_predict_dispatch_torch.py runs on a card; torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if args.measure:
        print(json.dumps(measure(*args.measure)))
        return 0
    card = _card()
    print(card)
    work = tempfile.mkdtemp(prefix="bench_predict_dispatch_")
    wav_dir, model = write_inputs(work)
    order = [REPO] if args.against is None else [os.path.abspath(args.against), REPO, REPO,
                                                   os.path.abspath(args.against)]
    results = []
    for repo in order:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", repo, wav_dir, model],
                              cwd=repo, capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            print(proc.stdout[-2000:], proc.stderr[-4000:])
            raise SystemExit(f"the child for {repo} exited {proc.returncode}")
        results.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(results[-1]))
    print(json.dumps({"card": card, "runs": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
