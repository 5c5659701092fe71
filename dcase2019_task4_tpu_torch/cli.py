"""Command-line entry points of the PyTorch/CUDA port.

    python -m dcase2019_task4_tpu_torch.cli predict -m CKPT -i WAV_DIR_OR_TSV -p OUT.tsv
        [--weak_fname TAGS.tsv] [--threshold T | --thresholds_json F]
        [--median_windows_json F] [--synthetic_audio] [--device cuda]

`dcase19-torch-predict` is the same `predict` as a console script.
"""

from __future__ import annotations

import argparse
import sys


def predict(argv=None):
    """Groundtruth-free batched inference: checkpoint + wav dir (or filename
    TSV) → event predictions TSV (+ optional weak clip-tag TSV).

    Called with an argument list it returns the evaluator's result without
    the event list (n_files and the strong and weak probabilities). Called
    from the command line (argv None) it returns None, so the console
    script exits 0."""
    parser = argparse.ArgumentParser(prog="dcase19-torch-predict",
                                     description="Batched inference to a predictions TSV")
    parser.add_argument("-m", "--model_path", type=str, required=True)
    parser.add_argument("-i", "--input", type=str, required=True,
                        help="Directory of wavs, or a filename TSV.")
    parser.add_argument("-p", "--save_predictions_fname", type=str, required=True)
    parser.add_argument("--weak_fname", type=str, default=None,
                        help="Also write clip-level tags (filename⇥event_labels).")
    parser.add_argument("--weak_threshold", type=float, default=0.5)
    parser.add_argument("--weak_thresholds_json", type=str, default=None,
                        help="Per-class clip-tagging thresholds JSON. Overrides --weak_threshold.")
    parser.add_argument("--threshold", type=float, default=0.5,
                        help="Strong-decode binarization threshold.")
    parser.add_argument("--thresholds_json", type=str, default=None,
                        help="Per-class decode thresholds JSON (dict or [C] list). Overrides --threshold.")
    parser.add_argument("--median_windows_json", type=str, default=None,
                        help="Per-class decode median-window JSON ([C] odd ints or {class: w}).")
    parser.add_argument("--synthetic_audio", action="store_true", default=False)
    parser.add_argument("--device", type=str, default="cuda",
                        help="Torch device. 'cuda' without a card raises; there is no CPU fallback.")
    args = parser.parse_args(argv)

    from dcase2019_task4_tpu_torch.eval.evaluate import CheckpointEvaluator

    ev = CheckpointEvaluator(args.model_path, device=args.device, synthetic_audio=args.synthetic_audio)
    threshold = ev.load_thresholds(args.thresholds_json) if args.thresholds_json else args.threshold
    median_window = ev.load_windows(args.median_windows_json) if args.median_windows_json else None
    weak_threshold = (ev.load_thresholds(args.weak_thresholds_json) if args.weak_thresholds_json
                      else args.weak_threshold)
    res = ev.predict_set(
        args.input, args.save_predictions_fname, weak_fname=args.weak_fname,
        weak_threshold=weak_threshold, threshold=threshold, median_window=median_window,
    )
    if argv is None:
        return None
    return {k: v for k, v in res.items() if k != "events"}


COMMANDS = {"predict": predict}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in COMMANDS:
        sys.exit(f"usage: python -m dcase2019_task4_tpu_torch.cli {{{','.join(COMMANDS)}}} ...")
    COMMANDS[argv[0]](argv[1:])
    return 0


if __name__ == "__main__":
    main()
