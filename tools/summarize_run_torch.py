#!/usr/bin/env python
"""Render a port run's metrics.jsonl as a compact table (the counterpart of
tools/summarize_run.py, over the port's `utils/metrics_writer.read_metrics`).

    python tools/summarize_run_torch.py <store_dir_or_metrics.jsonl> [--every N]

Prints epoch, train loss, event / weak macro F1, the SaveBest criterion,
the epoch's wall time, and flags the best epochs: the table of a run that
`Experiment.run` (train_meanteacher, train_crnn, tools/ablate_ssl_torch.py)
wrote. Reads a file only, on no device. Returns 1 for a file without
records, 2 for a path that does not exist.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    from dcase2019_task4_tpu_torch.utils.metrics_writer import read_metrics

    ap = argparse.ArgumentParser(prog="summarize_run_torch.py", description=__doc__.split("\n\n")[0])
    ap.add_argument("path", help="store_dir or a metrics.jsonl file")
    ap.add_argument("--every", type=int, default=1, help="print every Nth epoch")
    args = ap.parse_args(argv)
    path = args.path
    if os.path.isdir(path):
        path = os.path.join(path, "metrics.jsonl")
    if not os.path.exists(path):
        print(f"no such file: {path}", file=sys.stderr)
        return 2
    recs = read_metrics(path)
    if not recs:
        print("no records")
        return 1
    print(f"{'epoch':>5}  {'loss':>8}  {'event_F1':>8}  {'weak_F1':>7}  {'criterion':>9}  {'time_s':>7}  best")
    best_epoch = max(recs, key=lambda r: r.get("global_valid", 0.0))["epoch"]
    for r in recs:
        if r["epoch"] % args.every and r["epoch"] != best_epoch and not r.get("saved_best"):
            continue
        print(f"{r['epoch']:>5}  {r.get('loss', float('nan')):>8.4f}  "
              f"{r.get('event_macro_f1', float('nan')):>8.4f}  "
              f"{r.get('weak_macro_f1', float('nan')):>7.4f}  "
              f"{r.get('global_valid', float('nan')):>9.4f}  "
              f"{r.get('epoch_time_s', float('nan')):>7.1f}  "
              f"{'*' if r.get('saved_best') else ''}")
    print(f"\nbest criterion at epoch {best_epoch}; {len(recs)} epochs logged")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
