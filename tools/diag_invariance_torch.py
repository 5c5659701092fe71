"""Nuisance invariance of trained checkpoints, measured through the
PyTorch/CUDA port (the counterpart of tools/diag_invariance.py).

    python tools/diag_invariance_torch.py --ckpt NAME=PATH [--ckpt ...] [--renders 4] [--device cuda] [--out FILE]

Renders the same validation clips under K independent nuisance draws
(distinct synthetic salts, full band, identical event content and labels)
and measures how much each checkpoint's predictions move across renders:

  strong_std   mean over (clip, frame, class) of the std of the strong
               probability across the K renders
  weak_std     the same for the clip-level (attention-pooled) probabilities
  flip_rate    share of (clip, frame, class) cells whose 0.5-threshold
               decision is not unanimous across renders

The clips are the ablation's synthetic validation split (subpart draw,
then the 80/20 split with seed 26), rendered with the salts "desed-synth"
(k = 0) and "desed-synth/diag{k}". The decision is `S >= 0.5`, as the JAX
tool takes it, though decode thresholds with `>`: a known reference defect
kept so that both tools count the same flips.

Each checkpoint's numbers, its epoch and the card they were measured on
accumulate in --out (a checkpoint already there is skipped, for the same
renders, subpart and variability). Without a card, and without --device
cpu, `main` returns 2.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def probabilities(ckpt_path: str, renders: int, subpart: int, variability: float, device="cuda"):
    """→ (strong [K, N, T', C], weak [K, N, C], the checkpoint's epoch): the
    checkpoint's probabilities on the K renders of the validation clips."""
    import numpy as np

    from dcase2019_task4_tpu_torch.data.audio_io import SyntheticAudioSource
    from dcase2019_task4_tpu_torch.data.manifests import load_manifest, split_synthetic, subpart_manifest
    from dcase2019_task4_tpu_torch.data.pipeline import Stream, iter_eval_batches
    from dcase2019_task4_tpu_torch.eval.evaluate import CheckpointEvaluator

    ev = CheckpointEvaluator(ckpt_path, device=device, synthetic_audio=True)
    cfg = ev.cfg
    d, t = cfg.dsp, cfg.train
    # the ablation's validation synthetic split (Experiment.build: the
    # subpart draw, then the 80/20 split with seed 26)
    synth_m = subpart_manifest(load_manifest(cfg.paths.synthetic), subpart, t.subpart_seed)
    _, valid_m = split_synthetic(synth_m, 1 - t.valid_fraction, t.split_seed)

    probs_s, probs_w = [], []  # per render: [N, T', C] / [N, C]
    for k in range(renders):
        salt = "desed-synth" if k == 0 else f"desed-synth/diag{k}"
        src = SyntheticAudioSource(valid_m, ev.codec.labels, d.sample_rate, d.max_len_seconds,
                                   variability=variability, seed_salt=salt)
        stream = Stream("diag", valid_m, src, ev.codec, d.sample_rate, d.hop_length, ev.meta["pooling_time_ratio"])
        ss, ww = [], []
        for batch in iter_eval_batches(stream, t.batch_size, d.max_samples, d.n_window, d.hop_length,
                                       d.max_frames):
            s, w = ev._predict(ev.features(batch["audio"], batch["frames"]))
            n = batch["n_valid"]
            ss.append(s[:n].cpu().numpy())
            ww.append(w[:n].cpu().numpy())
        probs_s.append(np.concatenate(ss))
        probs_w.append(np.concatenate(ww))
    return np.stack(probs_s), np.stack(probs_w), ev.meta.get("epoch")


def dispersion(S, W, epoch) -> dict:
    """The three numbers of the module docstring from the K renders'
    probabilities (strong [K, N, T', C], weak [K, N, C]), with the clip and
    render counts and the checkpoint's epoch."""
    import numpy as np

    dec = S >= 0.5  # the JAX tool's decision, kept (module docstring)
    unanimous = np.all(dec == dec[:1], axis=0)
    return {
        "n_clips": int(S.shape[1]),
        "renders": int(S.shape[0]),
        "strong_std": float(S.std(axis=0, ddof=0).mean()),
        "weak_std": float(W.std(axis=0, ddof=0).mean()),
        "flip_rate": float(1.0 - unanimous.mean()),
        "epoch": epoch,
    }


def measure(ckpt_path: str, renders: int, subpart: int, variability: float, device="cuda"):
    """The checkpoint's dispersion across `renders` nuisance renders
    (`dispersion` of `probabilities`)."""
    return dispersion(*probabilities(ckpt_path, renders, subpart, variability, device))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="diag_invariance_torch.py", description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", action="append", required=True, metavar="NAME=PATH",
                    help="checkpoint to measure (repeatable)")
    ap.add_argument("--renders", type=int, default=4, help="independent nuisance renders per clip")
    ap.add_argument("--subpart", type=int, default=120, help="synthetic-manifest cap (match the ablation run)")
    ap.add_argument("--variability", type=float, default=1.0)
    ap.add_argument("--out", default=os.path.join(REPO, "DIAG_invariance_torch.json"))
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("diag_invariance_torch.py measures on a card by default and torch.cuda.is_available() is False; "
              "pass --device cpu to measure on the CPU", file=sys.stderr)
        return 2
    from dcase2019_task4_tpu_torch.utils.profiling import card_line

    card = card_line(args.device)
    results = {}
    if os.path.exists(args.out):  # accumulate (crash-safe across checkpoints)
        with open(args.out) as f:
            prev = json.load(f)
        if (prev.get("renders"), prev.get("subpart"), prev.get("variability")) == (
                args.renders, args.subpart, args.variability):
            results = prev.get("checkpoints", {})

    for spec in args.ckpt:
        name, path = spec.split("=", 1)
        if name in results:
            print(f"{name}: already measured, skipping")
            continue
        print(f"=== {name}: {path} on {card}", flush=True)
        results[name] = dict(measure(path, args.renders, args.subpart, args.variability, args.device), card=card)
        print(json.dumps({name: results[name]}), flush=True)
        with open(args.out, "w") as f:
            json.dump({"renders": args.renders, "subpart": args.subpart, "variability": args.variability,
                       "checkpoints": results}, f, indent=1)

    print("\n=== prediction dispersion across nuisance renders ===")
    print(f"{'ckpt':<14s} {'strong_std':>10s} {'weak_std':>9s} {'flip_rate':>9s}")
    for name, r in results.items():
        print(f"{name:<14s} {r['strong_std']:>10.4f} {r['weak_std']:>9.4f} {r['flip_rate']:>9.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
