"""Clip-level (weak) tagging metrics without pandas (counterpart of
dcase2019_task4_tpu/eval/tagging.py).

Re-design of the reference's audio-tagging F1 path
(get_f_measure_by_class / intermediate_at_measures / macro_f_measure,
evaluation_measures.py:19-102,185-200): binarize weak probabilities at a
global 0.5 threshold (or per-class thresholds), accumulate per-class
tp/fp/fn/tn confusion counts, then F = 2tp/(2tp+fp+fn) with zero-count
classes scored 0. Event tables are sequences of rows: dicts with
`filename` and `event_label` (strong) or `event_labels` (weak, comma-joined),
or the decoder's (event_label, onset, offset, filename) tuples.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from dcase2019_task4_tpu_torch.eval.sed_scores import records


def binarize(probs: np.ndarray, thresholds=0.5) -> np.ndarray:
    """Global or per-class thresholding (dcase_util
    ProbabilityEncoder.binarization contract: strictly greater)."""
    t = np.asarray(thresholds)
    return (np.asarray(probs) > t).astype(np.int32)


def confusion_counts(ref: np.ndarray, est: np.ndarray):
    """Per-class (tp, fp, fn, tn) like intermediate_at_measures
    (evaluation_measures.py:86-102)."""
    ref = np.asarray(ref)
    est = np.asarray(est)
    tp = ((est + ref) == 2).sum(axis=0)
    fp = ((est - ref) == 1).sum(axis=0)
    fn = ((ref - est) == 1).sum(axis=0)
    tn = ((est + ref) == 0).sum(axis=0)
    return tp, fp, fn, tn


def macro_f_measure(tp, fp, fn) -> np.ndarray:
    """Per-class F1, zero where 2tp+fp+fn == 0
    (evaluation_measures.py:185-200)."""
    tp = np.asarray(tp, dtype=np.float64)
    denom = 2 * tp + np.asarray(fp) + np.asarray(fn)
    f = np.zeros(tp.shape[-1])
    mask = denom != 0
    f[mask] = 2 * tp[mask] / denom[mask]
    return f


class TaggingF1:
    """Streaming accumulator over batches of (weak_probs, weak_targets)."""

    def __init__(self, nclass: int, thresholds=0.5):
        self.thresholds = thresholds
        self.tp = np.zeros(nclass)
        self.fp = np.zeros(nclass)
        self.fn = np.zeros(nclass)
        self.tn = np.zeros(nclass)

    def update(self, weak_probs, weak_targets):
        """weak_targets may be a [B, T, C] strong grid (max over time, then
        0.5-binarized, evaluation_measures.py:53-57) or a [B, C] k-hot."""
        y = np.asarray(weak_targets)
        if y.ndim == 3:
            y = y.max(axis=1)
        y = (y > 0.5).astype(np.int32)
        p = np.asarray(weak_probs)
        if p.ndim == 3:
            p = p.max(axis=1)
        est = binarize(p, self.thresholds)
        tp, fp, fn, tn = confusion_counts(y, est)
        self.tp += tp
        self.fp += fp
        self.fn += fn
        self.tn += tn

    def per_class_f1(self) -> np.ndarray:
        return macro_f_measure(self.tp, self.fp, self.fn)

    def macro_f1(self) -> float:
        return float(np.mean(self.per_class_f1()))


def _labels(row: Dict) -> List[str]:
    """The labels a row carries: its event_label, or its event_labels split."""
    if "event_label" in row:
        return [] if row["event_label"] is None else [row["event_label"]]
    labs = row.get("event_labels")
    return labs.split(",") if isinstance(labs, str) and labs else []


def weak_labels_from_df(rows, classes: Sequence[str]) -> np.ndarray:
    """Per unique filename (in order of appearance), k-hot of present
    classes — the table-vs-table tagging comparison path
    (audio_tagging_results, evaluation_measures.py:259-294)."""
    rows = records(rows)
    cindex = {c: i for i, c in enumerate(classes)}
    findex = {f: i for i, f in enumerate(dict.fromkeys(r["filename"] for r in rows))}
    y = np.zeros((len(findex), len(classes)), dtype=np.int32)
    for r in rows:
        for lab in _labels(r):
            if lab in cindex:
                y[findex[r["filename"]], cindex[lab]] = 1
    return y


def audio_tagging_results(reference, estimated) -> Dict[str, float]:
    """Tagging F1 per class between two event tables, aligned on the union
    of filenames (missing side = all-zero), mirroring audio_tagging_results
    (evaluation_measures.py:259-294); the classes are the reference's,
    sorted."""
    reference, estimated = records(reference), records(estimated)
    classes = sorted({lab for r in reference for lab in _labels(r)})
    files = list(dict.fromkeys([r["filename"] for r in reference] + [r["filename"] for r in estimated]))
    findex = {f: i for i, f in enumerate(files)}

    def khot(rows):
        part = weak_labels_from_df(rows, classes)
        out = np.zeros((len(files), len(classes)), dtype=np.int32)
        for i, f in enumerate(dict.fromkeys(r["filename"] for r in rows)):
            out[findex[f]] = part[i]
        return out

    tp, fp, fn, _ = confusion_counts(khot(reference), khot(estimated))
    return dict(zip(classes, macro_f_measure(tp, fp, fn).tolist()))
