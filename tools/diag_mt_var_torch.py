"""Dissect a trained Mean-Teacher checkpoint of the port without training
again (the counterpart of tools/diag_mt_var.py):

  1. the student, eval-mode BN (running statistics): what validation reads
  2. the student, batch-statistics BN: isolates running-statistic skew
  3. the teacher (EMA), eval-mode BN: is the teacher healthier?
  4. the scaler moments of each arm's checkpoint
  5. the weak F1 on the training weak stream: the train / valid gap

plus each BatchNorm's running statistics.

    python tools/diag_mt_var_torch.py [--ckpt_root DIR] [--subpart 120] [--variability 1.0] [--seed 0] [--device cuda]

The checkpoints are `<ckpt_root>/<arm>_s<seed>/model/baseline_best`, as
tools/ablate_ssl_torch.py stores them (its default --store is the default
root here). The Experiment is the mt arm's at dropout 0, so the
batch-statistics rows differ from eval mode by BatchNorm alone; they run on
a copy of the model, whose running statistics the pass would move. Without
a card, and without --device cpu, `main` returns 2.
"""

from __future__ import annotations

import argparse
import copy
import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def weak_f1_variant(exp, stream, model, mode: str) -> float:
    """Weak tagging macro F1 of `model` over `stream`, BatchNorm from the
    running statistics ("eval") or from each batch ("train")."""
    import torch

    from dcase2019_task4_tpu_torch.data.pipeline import iter_eval_batches
    from dcase2019_task4_tpu_torch.eval.tagging import TaggingF1

    d = exp.cfg.dsp
    acc = TaggingF1(len(exp.classes))
    model = model.eval() if mode == "eval" else copy.deepcopy(model).train()
    generator = torch.Generator(device=exp.device).manual_seed(0)
    for batch in iter_eval_batches(stream, exp.pipeline.batch_size, d.max_samples, d.n_window, d.hop_length,
                                   d.max_frames):
        x = exp.eval_features(torch.as_tensor(batch["audio"], device=exp.device),
                              torch.as_tensor(batch["frames"], device=exp.device))
        with torch.no_grad():
            _, weak = model(x, generator)
        nv = batch["n_valid"]
        acc.update(weak[:nv].cpu().numpy(), batch["target"][:nv])
    return float(np.mean(acc.per_class_f1()))


def mt_config():
    """The flagship `Config()` at dropout 0, no per-epoch checkpoints."""
    from dcase2019_task4_tpu_torch.config import Config, ModelConfig, TrainConfig

    return Config(model=ModelConfig(dropout=0.0), train=TrainConfig(n_epoch=80, checkpoint_epochs=0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="diag_mt_var_torch.py", description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt_root", default=os.path.join(tempfile.gettempdir(), "ablate_ssl_torch"))
    ap.add_argument("--subpart", type=int, default=120)
    ap.add_argument("--variability", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("diag_mt_var_torch.py runs on a card by default and torch.cuda.is_available() is False; "
              "pass --device cpu to run on the CPU", file=sys.stderr)
        return 2
    from dcase2019_task4_tpu_torch.train import checkpoints as ckpt
    from dcase2019_task4_tpu_torch.train.experiment import Experiment
    from dcase2019_task4_tpu_torch.utils.profiling import card_line

    print(f"on {card_line(args.device)}")
    # ---- scaler moments per arm (from the checkpoints' metadata)
    for arm in ("supervised", "mt", "mt_cc0", "mt_nv"):
        path = os.path.join(args.ckpt_root, f"{arm}_s{args.seed}", "model", "baseline_best")
        if not os.path.exists(path):
            continue
        meta = ckpt.read_metadata(path)
        sc = meta["scaler"]
        m = np.asarray(sc["mean_"])
        s = np.sqrt(np.maximum(np.asarray(sc["mean_of_square_"]) - m ** 2, 0))
        print(f"[scaler] {arm}_s{args.seed}: mean [{m.min():+.2f},{m.max():+.2f}] avg {m.mean():+.2f} | "
              f"std [{s.min():.2f},{s.max():.2f}] avg {s.mean():.2f} | best epoch {meta['epoch']} "
              f"valid {meta['valid_metric']}")

    # ---- the mt arm's Experiment at dropout 0, the mt checkpoint restored
    exp = Experiment(mt_config(), mean_teacher=True, subpart_data=args.subpart, synthetic_audio=True,
                     synthetic_variability=args.variability, seed=args.seed, device=args.device)
    exp.build()
    mt_path = os.path.join(args.ckpt_root, f"mt_s{args.seed}", "model", "baseline_best")
    meta = exp.restore(mt_path)
    print(f"[restore] {mt_path} epoch {meta['epoch']} valid {meta['valid_metric']}")

    st = exp.state
    names = [s.name for s in exp.pipeline.streams]
    train_weak = exp.pipeline.streams[names.index("weak")]
    rows = [
        ("student/eval-BN/valid", st.student, exp.valid_weak_stream, "eval"),
        ("student/batch-BN/valid", st.student, exp.valid_weak_stream, "train"),
        ("teacher/eval-BN/valid", st.teacher, exp.valid_weak_stream, "eval"),
        ("student/eval-BN/TRAIN-weak", st.student, train_weak, "eval"),
        ("student/batch-BN/TRAIN-weak", st.student, train_weak, "train"),
    ]
    for label, model, stream, mode in rows:
        print(f"[weak-F1] {label:28s} {weak_f1_variant(exp, stream, model, mode):.4f}")

    # ---- BatchNorm running statistics per conv block
    for name, buf in st.student.named_buffers():
        if "running_" in name:
            a = buf.detach().cpu().numpy()
            print(f"[bn] {name}: shape {a.shape} min {a.min():+.3f} max {a.max():+.3f} mean {a.mean():+.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
