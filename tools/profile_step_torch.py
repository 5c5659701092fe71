"""Profile warm Mean-Teacher steps of the PyTorch/CUDA port on one card
(the port's counterpart of tools/profile_step.py, which profiles the JAX
step through jax.profiler).

    python tools/profile_step_torch.py [--batch 24] [--entry_block | --crows] [--scaled] [--no_dropout]
                                       [--trace_dir DIR]

Builds the step of `train/steps.py` at the flagship `Config()` (float32,
the port's default path; `--scaled` the scaled configuration), weights from
the training init of a seeded generator and a seeded int16 batch laid out
[weak B/4 | unlabeled B/2 | synthetic B/4], the generator on the card;
warms it up, times 20 steps (host clock, synchronised), then traces 5
steps with `utils/profiling.trace` (into a new temporary directory, or
`--trace_dir`) and prints the device time a step, the device ops grouped
by kernel name and one by one
(`utils/profiling.top_device_ops`), and as its last line one JSON object
with the same numbers. `--entry_block` / `--crows` select the fused first
block (`entry_block_pallas` / `entry_block_crows`), `--no_dropout` runs at
dropout 0. The JAX tool's `--unroll` sets its GRU scan's unroll; the port's
GRU is cuDNN's and has none, so the flag fails. Without a card `main`
returns 2.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import re
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TIMED_STEPS, TRACED_STEPS = 20, 5  # as tools/profile_step.py


def _args(argv):
    p = argparse.ArgumentParser(prog="profile_step_torch.py", description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=24)
    p.add_argument("--entry_block", action="store_true")
    p.add_argument("--crows", action="store_true")
    p.add_argument("--scaled", action="store_true")
    p.add_argument("--no_dropout", action="store_true")
    p.add_argument("--unroll", type=int, default=None)
    p.add_argument("--trace_dir", type=str, default=None)
    args = p.parse_args(argv)
    if args.unroll is not None:
        p.error("--unroll has no counterpart in the port: its GRU is cuDNN's (ops/gru.py), which has no scan "
                "to unroll")
    if args.batch % 4:
        p.error(f"--batch must be a multiple of 4 ([weak B/4 | unlabeled B/2 | synthetic B/4]), got {args.batch}")
    return args


def _config(args):
    from dcase2019_task4_tpu_torch.config import Config, scaled_config

    cfg = scaled_config() if args.scaled else Config()
    model = {"entry_block_pallas": args.entry_block, "entry_block_crows": args.crows}
    if args.no_dropout:
        model["dropout"] = 0.0
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **model))


def group_name(name: str) -> str:
    """A device op's name without its return type, anonymous namespace,
    template and argument lists."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name, maxsplit=1)[0].strip()


def main(argv=None) -> int:
    args = _args(sys.argv[1:] if argv is None else argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_step_torch.py profiles the step on a card; torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    from dcase2019_task4_tpu_torch.ops.mel import MelFrontend
    from dcase2019_task4_tpu_torch.train import steps
    from dcase2019_task4_tpu_torch.utils.profiling import top_device_ops, trace

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _config(args)
    d, tr = cfg.dsp, cfg.train
    dev = torch.device("cuda")
    B, q = args.batch, args.batch // 4

    def adam(params):
        return torch.optim.Adam(params, lr=tr.lr, betas=(tr.beta1, tr.beta2), eps=tr.adam_eps)

    state = steps.init_train_state(cfg.model, adam, torch.Generator().manual_seed(0), device=dev)
    frontend = MelFrontend(sample_rate=d.sample_rate, n_window=d.n_window, hop_length=d.hop_length,
                           n_mels=d.n_mels, f_min=d.f_min, f_max=d.f_max, max_frames=d.max_frames,
                           amin=d.amin, top_db=d.top_db, device=dev)
    sa = dict(time_masks=tr.sa_time_masks, max_time_width=tr.sa_max_time_width, freq_masks=tr.sa_freq_masks,
              max_freq_width=tr.sa_max_freq_width) if tr.spec_augment else None
    step = steps.make_train_step(slice(0, q), slice(3 * q, B), mean_teacher=True, rampup_length=100 * 300,
                                 frontend=frontend, scaler_mean=np.zeros(d.n_mels, np.float32),
                                 scaler_std=np.ones(d.n_mels, np.float32), noise_std=tr.noise_std,
                                 spec_augment_cfg=sa)
    rng = np.random.default_rng(0)
    Lp = d.max_samples + d.n_window
    batch = {"audio": torch.as_tensor((rng.standard_normal((B, Lp)) * 5000).astype(np.int16), device=dev),
             "frames": torch.full((B,), d.max_frames, dtype=torch.int32, device=dev),
             "target": torch.zeros((B, d.max_frames // cfg.model.pooling_time_ratio, cfg.model.nclass),
                                   device=dev)}
    generator = torch.Generator(device=dev).manual_seed(1)
    acc = step.zero_metrics(dev)
    print(f"config: scaled {args.scaled}, compute {cfg.model.compute_dtype}, entry_block_pallas {args.entry_block}, "
          f"entry_block_crows {args.crows}, dropout {cfg.model.dropout}, batch {B}; on {torch.cuda.get_device_name(0)}")
    for _ in range(3):
        step(state, batch, generator, acc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        step(state, batch, generator, acc)
    torch.cuda.synchronize()
    ms_step = 1e3 * (time.perf_counter() - t0) / TIMED_STEPS
    print(f"ms/step: {ms_step:.3f} ({TIMED_STEPS} warm steps, host clock, synchronised)")

    trace_dir = args.trace_dir or tempfile.mkdtemp(prefix="profile_step_torch_")
    with trace(trace_dir, cuda=True):
        for _ in range(TRACED_STEPS):
            step(state, batch, generator, acc)
    ops = top_device_ops(trace_dir, top=400)
    per_step = [(name, ms / TRACED_STEPS, shape) for name, ms, shape in ops]
    total = sum(ms for _, ms, _ in per_step)
    print(f"total device ms/step: {total:.3f} ({TRACED_STEPS} traced steps; trace in {trace_dir})")
    groups = collections.defaultdict(float)
    for name, ms, _ in per_step:
        groups[group_name(name)] += ms
    print("--- grouped ---")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1])[:20]:
        print(f"{ms:8.3f} ms  {g}")
    print("--- top ops ---")
    for name, ms, shape in per_step[:30]:
        print(f"{ms:8.3f} ms  {name[:100]}  {shape}")
    print(json.dumps({"device": torch.cuda.get_device_name(0), "batch": B, "ms_per_step": ms_step,
                      "device_ms_per_step": total, "groups": dict(groups),
                      "ops": [[name, ms, shape] for name, ms, shape in per_step]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
