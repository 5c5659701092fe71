"""Semi-supervised value ablation through the PyTorch/CUDA port (the
counterpart of tools/ablate_ssl.py, which trains through the JAX package):
does the Mean-Teacher consistency term do work?

    python tools/ablate_ssl_torch.py [--device cuda] [--seeds 1] [--nuisance_shift LO,HI] [--out FILE]

The same arms at an equal labeled budget (the same --subpart cap on the
weak and synthetic manifests, the same split seeds), each an `Experiment`
of `dcase2019_task4_tpu_torch.train.experiment` with synthetic audio:

  supervised  labeled streams only ([weak 1/2 | synthetic 1/2], no teacher)
  mt          Mean-Teacher with the unlabeled stream ([1/4 | 1/2 | 1/4])
  mt_cc0      `mt` with max_consistency_cost = 0: the teacher and EMA run,
              the consistency gradient is zero
  mt_nv       `mt` with the teacher on an independent nuisance render of
              each clip (`paired_teacher_view=True`)

`--nuisance_shift LO,HI` confines the labeled training streams (weak and
synthetic) to that quantile band of the synthetic source's nuisance draws
(`Experiment(synthetic_bands=)`), while the unlabeled stream and both
validation streams span the full band. `--subpart_unlabeled` caps the
unlabeled manifest apart (`Experiment(subpart_unlabeled=)`), toward the
real dataset's 5:1 unlabeled:labeled ratio. The defaults are the JAX
tool's (--epochs 250 --subpart 120 --subpart_unlabeled 600 --eval_every 10
--variability 1.0); the training set is resident on the device
(`device_cache`) unless --no_device_cache.

Each arm trains --epochs epochs with validation every --eval_every epochs
and reports the best validation event-based macro F1, weak macro F1 and
SaveBest criterion over the run (from its metrics.jsonl), its steps an
epoch, its clip counts, its wall time and the card it ran on. The arm's
log goes to `<store>/<arm>_s<seed>/train.log`. Results accumulate in
--out after every arm, so a cut run resumes arm by arm; a file that holds
another configuration's runs is refused (exit 2).

Exit status: 0 if the mean best event F1 of `mt` beats `supervised` by
more than --margin (and, with --strict_consistency, `mt` >= `mt_cc0` -
--tolerance), 1 if not, 2 for a refused --out or a missing card.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

ARMS = {
    "supervised": dict(mean_teacher=False, max_cc=2.0),
    "mt": dict(mean_teacher=True, max_cc=2.0),
    "mt_cc0": dict(mean_teacher=True, max_cc=0.0),
    "mt_nv": dict(mean_teacher=True, max_cc=2.0, paired=True),
}


def arm_config(epochs: int, max_cc: float):
    """The flagship `Config()` with the arm's epochs and consistency cost and
    no per-epoch checkpoints (metrics.jsonl is the record)."""
    from dcase2019_task4_tpu_torch.config import Config, TrainConfig

    return Config(train=TrainConfig(n_epoch=epochs, max_consistency_cost=max_cc, checkpoint_epochs=0))


def arm_experiment(mean_teacher, max_cc, subpart, epochs, seed, variability=0.0, subpart_unlabeled=None,
                   device_cache=True, labeled_band=None, paired_view=False, device="cuda", logger=None):
    """The arm's Experiment, not built (the JAX tool's `run_arm` arguments)."""
    from dcase2019_task4_tpu_torch.train.experiment import Experiment

    cfg = arm_config(epochs, max_cc)
    bands = None if labeled_band is None else {"weak": labeled_band, "synthetic": labeled_band}
    return Experiment(cfg, mean_teacher=mean_teacher, subpart_data=subpart, subpart_unlabeled=subpart_unlabeled,
                      synthetic_audio=True, synthetic_variability=variability, synthetic_bands=bands,
                      logger=logger, seed=seed, device_cache=device_cache, paired_teacher_view=paired_view,
                      device=device)


def _file_logger(name: str, path: str) -> logging.Logger:
    logger = logging.getLogger(f"ablate_ssl_torch.{name}")
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    handler = logging.FileHandler(path)
    handler.setFormatter(logging.Formatter("%(asctime)s - %(levelname)s - %(message)s"))
    logger.addHandler(handler)
    return logger


def run_arm(name, mean_teacher, max_cc, subpart, epochs, seed, store_root, variability=0.0,
            subpart_unlabeled=None, eval_every=1, device_cache=True, labeled_band=None, paired_view=False,
            device="cuda", card="cpu"):
    """Train one arm in `<store_root>/<name>_s<seed>` → its record."""
    from dcase2019_task4_tpu_torch.utils.metrics_writer import read_metrics

    store = os.path.join(store_root, f"{name}_s{seed}")
    if os.path.exists(store):  # leftover from an interrupted run: start clean
        shutil.rmtree(store)
    os.makedirs(store)
    logger = _file_logger(f"{name}_s{seed}", os.path.join(store, "train.log"))
    try:
        exp = arm_experiment(mean_teacher, max_cc, subpart, epochs, seed, variability, subpart_unlabeled,
                             device_cache, labeled_band, paired_view, device, logger)
        t0 = time.time()
        exp.run(store_dir=store, n_epoch=epochs, eval_every=eval_every)
        wall = time.time() - t0
    finally:
        for handler in list(logger.handlers):
            logger.removeHandler(handler)
            handler.close()
    # best-over-run validation numbers from the structured history
    records = read_metrics(os.path.join(store, "metrics.jsonl"))
    best = {k: max([0.0] + [r.get(k, 0.0) for r in records])
            for k in ("event_macro_f1", "weak_macro_f1", "global_valid")}
    streams = exp.pipeline.streams
    return {
        "arm": name, "seed": seed,
        "best_event_macro_f1": round(best["event_macro_f1"], 4),
        "best_weak_macro_f1": round(best["weak_macro_f1"], 4),
        "best_global_valid": round(best["global_valid"], 4),
        "steps_per_epoch": len(exp.pipeline),
        "n_labeled_clips": sum(len(s) for s in streams if s.name in ("weak", "synthetic")),
        "n_unlabeled_clips": sum(len(s) for s in streams if s.name == "unlabeled"),
        "wall_s": round(wall, 1),
        "card": card,
    }


def _args(argv):
    ap = argparse.ArgumentParser(prog="ablate_ssl_torch.py", description=__doc__.split("\n\n")[0])
    ap.add_argument("--subpart", type=int, default=120, help="per-manifest file cap = the labeled budget knob")
    ap.add_argument("--epochs", type=int, default=250,
                    help="at 16 steps an epoch a 4000-step budget: the EMA alpha cap binds at 25%% of training")
    ap.add_argument("--subpart_unlabeled", type=int, default=600,
                    help="separate cap for the unlabeled manifest (~5:1 unlabeled:labeled)")
    ap.add_argument("--eval_every", type=int, default=10, help="validate every Nth epoch (and the last)")
    ap.add_argument("--no_device_cache", action="store_true", default=False,
                    help="stream batches through the batch queue instead of keeping the set on the device")
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--seed_base", type=int, default=0, help="first seed: run seeds [base, base + seeds)")
    ap.add_argument("--margin", type=float, default=0.02, help="mt must beat supervised by this much (event F1)")
    ap.add_argument("--strict_consistency", action="store_true", help="also require mt >= mt_cc0 - tolerance")
    ap.add_argument("--tolerance", type=float, default=0.0,
                    help="mt may trail mt_cc0 by this much under --strict_consistency")
    ap.add_argument("--variability", type=float, default=1.0,
                    help="synthetic-source nuisance variation strength (audio_io.synth_clip)")
    ap.add_argument("--nuisance_shift", default=None, metavar="LO,HI",
                    help="confine the labeled train streams to this quantile band of the nuisance draws; "
                         "unlabeled and validation span the full band. E.g. --nuisance_shift 0.4,0.6")
    ap.add_argument("--store", default=os.path.join(tempfile.gettempdir(), "ablate_ssl_torch"))
    ap.add_argument("--out", default=os.path.join(REPO, "ABLATION_ssl_torch.json"))
    ap.add_argument("--arms", default="supervised,mt,mt_cc0")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    unknown = [a for a in args.arms.split(",") if a not in ARMS]
    if unknown:
        ap.error(f"unknown arm(s) {unknown}; the arms are {sorted(ARMS)}")
    return args


def _config(args):
    """What a results file must match to be resumed (the JAX tool's tuple)."""
    return (args.subpart, args.epochs, args.variability, args.subpart_unlabeled, args.eval_every,
            args.nuisance_shift)


def verdict(summary, margin: float, strict: bool, tolerance: float) -> int:
    """The exit check over the per-arm summary → 0 or 1, with its lines
    printed."""

    def have(*arms):
        return all(a in summary and summary[a]["event_f1"] is not None for a in arms)

    ok = True
    if have("mt", "supervised"):
        gain = summary["mt"]["event_f1"] - summary["supervised"]["event_f1"]
        ssl_ok = gain > margin
        ok = ok and ssl_ok
        print(f"semi-supervised value (mt - supervised event F1): {gain:+.4f}")
        print("CHECK", "PASS" if ssl_ok else "FAIL", ": the unlabeled stream",
              "is worth real F1 at equal labeled budget" if ssl_ok
              else "adds nothing: the Mean-Teacher recipe is broken")
    if have("mt", "mt_cc0"):
        gap = summary["mt"]["event_f1"] - summary["mt_cc0"]["event_f1"]
        print(f"consistency-gradient contribution (mt - mt_cc0 event F1): {gap:+.4f}")
        if strict:
            c_ok = gap >= -tolerance
            ok = ok and c_ok
            print("STRICT CHECK", "PASS" if c_ok else "FAIL", ": zeroing the consistency weight",
                  "degrades (or ties)" if c_ok else "improves")
    return 0 if ok else 1


def main(argv=None) -> int:
    args = _args(sys.argv[1:] if argv is None else argv)
    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("ablate_ssl_torch.py trains on a card by default and torch.cuda.is_available() is False; "
              "pass --device cpu to train on the CPU", file=sys.stderr)
        return 2
    from dcase2019_task4_tpu_torch.utils.profiling import card_line

    card = card_line(args.device)
    labeled_band = None
    if args.nuisance_shift:
        lo, hi = (float(x) for x in args.nuisance_shift.split(","))
        labeled_band = (lo, hi)

    results = []
    if os.path.exists(args.out):  # accumulate across invocations of the same configuration
        with open(args.out) as f:
            prev = json.load(f)
        prev_cfg = (prev.get("subpart"), prev.get("epochs"), prev.get("variability", 0.0),
                    prev.get("subpart_unlabeled"), prev.get("eval_every", 1), prev.get("nuisance_shift"))
        if prev_cfg != _config(args):
            # never overwrite another configuration's accumulated runs
            print(f"ERROR: {args.out} holds results for (subpart, epochs, variability, subpart_unlabeled, "
                  f"eval_every, nuisance_shift)={prev_cfg}, requested {_config(args)}. Pass a different --out "
                  "(or matching configuration flags).", file=sys.stderr)
            return 2
        results = prev.get("runs", [])
        if results:
            print(f"resuming: {len(results)} arm-runs already in {args.out}")

    def mean_of(arm, key):
        vals = [r[key] for r in results if r["arm"] == arm]
        return sum(vals) / len(vals) if vals else None

    def write_doc():
        # every arm present in the accumulated runs (an invocation adding
        # seeds for a subset keeps the others)
        arms_present = list(dict.fromkeys(args.arms.split(",") + [r["arm"] for r in results]))
        summary = {a: {"event_f1": mean_of(a, "best_event_macro_f1"), "weak_f1": mean_of(a, "best_weak_macro_f1")}
                   for a in arms_present}
        doc = {"subpart": args.subpart, "epochs": args.epochs, "variability": args.variability,
               "subpart_unlabeled": args.subpart_unlabeled, "eval_every": args.eval_every,
               "nuisance_shift": args.nuisance_shift, "seeds": len({r["seed"] for r in results}),
               "summary": summary, "runs": results}
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1)
        return summary

    for seed in range(args.seed_base, args.seed_base + args.seeds):
        for arm in args.arms.split(","):
            if any(r["arm"] == arm and r["seed"] == seed for r in results):
                continue  # done in an earlier invocation
            d = ARMS[arm]
            print(f"=== arm {arm} seed {seed} on {card} ===", flush=True)
            r = run_arm(arm, d["mean_teacher"], d["max_cc"], args.subpart, args.epochs, seed, args.store,
                        variability=args.variability, subpart_unlabeled=args.subpart_unlabeled,
                        eval_every=args.eval_every, device_cache=not args.no_device_cache,
                        labeled_band=labeled_band, paired_view=d.get("paired", False), device=args.device,
                        card=card)
            print(json.dumps(r), flush=True)
            results.append(r)
            write_doc()  # crash-safe: partial results land after every arm

    summary = write_doc()
    print("\n=== ablation summary (best validation F1, mean over seeds) ===")
    for a, s in summary.items():
        ev = "n/a" if s["event_f1"] is None else f"{s['event_f1']:.4f}"
        wk = "n/a" if s["weak_f1"] is None else f"{s['weak_f1']:.4f}"
        print(f"  {a:<11s} event {ev}  weak {wk}")
    return verdict(summary, args.margin, args.strict_consistency, args.tolerance)


if __name__ == "__main__":
    sys.exit(main())
