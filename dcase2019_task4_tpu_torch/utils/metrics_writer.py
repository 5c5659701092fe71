"""Structured per-epoch metrics history (JSONL; counterpart of
dcase2019_task4_tpu/utils/metrics_writer.py).

The reference's observability is log-line greps (AverageMeterSet strings at
main.py:161-165 and sed_eval report dumps); there is no machine-readable
training history. Production runs need one: every `Experiment.run` appends
one JSON object per epoch to `<store_dir>/metrics.jsonl` — training-loss
meter averages, validation F1s, the SaveBest criterion, wall-clock — so
dashboards/regression tooling can consume a run without parsing logs.
Append-mode so a `--resume` run extends the same file.
"""

from __future__ import annotations

import json
import time
from typing import Dict, Optional


def _to_jsonable(v):
    """numpy scalars/arrays → native python (json.dumps chokes on np types)."""
    if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
        return v.item()
    if hasattr(v, "tolist"):
        return v.tolist()
    return v


class MetricsWriter:
    """Append one JSON line per record; flushed per write so a killed run
    keeps everything up to its last completed epoch."""

    def __init__(self, path: Optional[str]):
        self.path = path
        self._f = open(path, "a") if path else None

    def write(self, record: Dict) -> None:
        if self._f is None:
            return
        rec = {"ts": round(time.time(), 3)}
        rec.update({k: _to_jsonable(v) for k, v in record.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_metrics(path: str):
    """Load a metrics.jsonl back into a list of dicts."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
