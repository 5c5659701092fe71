"""Per-class threshold tuning without pandas (counterpart of
dcase2019_task4_tpu/eval/thresholds.py).

  * tune_weak_thresholds — grid search of the per-class clip threshold
    that maximizes per-class clip-tagging F1;
  * decode_events_per_class — the strong decode with per-class thresholds
    and per-class median windows (scipy's median per window group);
  * tune_event_thresholds — grid search of the per-class strong-decode
    threshold and median window that maximize per-class event-based F1
    through the whole decode → collar-matching chain.

The grids, the loop order and the tie rule are the JAX package's, the
`best_win` start included: it is `median_windows[0]` as given, not the
smallest window (a known defect of the reference, kept for parity). Event
rows are the decoder's (event_label, onset, offset, filename) tuples.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from dcase2019_task4_tpu_torch.eval.decode import Event, grids_to_events
from dcase2019_task4_tpu_torch.eval.sed_scores import event_based_metrics


def tune_weak_thresholds(weak_probs: np.ndarray, weak_targets: np.ndarray,
                         grid: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
    """weak_probs [N, C] in [0, 1]; weak_targets [N, C] (0/1, or [N, T, C]
    strong grids, maxed over time) → (thresholds [C], f1 [C]): per class
    the grid threshold of the largest F1, ties to the lower threshold."""
    probs = np.asarray(weak_probs)
    y = np.asarray(weak_targets)
    if y.ndim == 3:
        y = y.max(axis=1)
    y = (y > 0.5).astype(np.int32)
    if grid is None:
        grid = np.linspace(0.05, 0.95, 19)
    est = probs[None, :, :] > grid[:, None, None]  # [G, N, C]
    tp = (est & (y[None] == 1)).sum(axis=1).astype(np.float64)
    fp = (est & (y[None] == 0)).sum(axis=1).astype(np.float64)
    fn = ((~est) & (y[None] == 1)).sum(axis=1).astype(np.float64)
    denom = 2 * tp + fp + fn
    f1 = np.where(denom > 0, 2 * tp / np.maximum(denom, 1e-12), 0.0)  # [G, C]
    best = f1.argmax(axis=0)
    return grid[best], f1[best, np.arange(probs.shape[1])]


def decode_events_per_class(strong_probs: np.ndarray, filenames: List[str], codec, sample_rate: int,
                            hop_length: int, pooling_time_ratio: int, thresholds, windows) -> List[Event]:
    """Strong probabilities [N, T, C] → event rows, with a threshold and an
    odd median window per class (scalars broadcast): binarize against the
    float64 thresholds, scipy's median over time per group of classes that
    share a window, run-length decode to seconds."""
    from scipy.ndimage import median_filter

    probs = np.asarray(strong_probs)
    th = np.broadcast_to(np.asarray(thresholds, np.float64), (probs.shape[-1],))
    win = np.broadcast_to(np.asarray(windows, np.int64), (probs.shape[-1],))
    binary = (probs > th).astype(np.float32)
    out = np.empty_like(binary)
    for w in np.unique(win):
        cols = np.nonzero(win == w)[0]
        out[..., cols] = median_filter(binary[..., cols], size=(1, int(w), 1))
    return grids_to_events(out, filenames, codec, sample_rate, hop_length, pooling_time_ratio)


def _class_f1(metrics, labels: Sequence[str]) -> np.ndarray:
    return np.asarray([metrics.counts[c].f_measure if c in metrics.counts else 0.0 for c in labels])


def tune_event_thresholds(
    strong_probs: np.ndarray,
    filenames: List[str],
    groundtruth,
    codec,
    sample_rate: int = 44100,
    hop_length: int = 511,
    pooling_time_ratio: int = 8,
    grid: Optional[np.ndarray] = None,
    median_windows: Optional[Sequence[int]] = None,
    t_collar: float = 0.200,
    percentage_of_length: float = 0.2,
) -> Dict:
    """Grid search of per-class strong-decode thresholds (and median
    windows) maximizing per-class event-based F1 against `groundtruth` (the
    set's reference event rows, seconds). Every (window, threshold) point
    runs the whole decode and the collar-matched scoring; windows in the
    outer loop, ascending, thresholds inside; a point replaces a class's
    best only where its F1 is larger by more than 1e-12.

    Returns {"thresholds" [C], "windows" [C], "f1" [C], "macro_f1" (of a
    re-decode with the tuned vectors), "default_f1" [C] and
    "default_macro_f1" (the decode at 0.5 / 5)}, classes in codec order."""
    if grid is None:
        grid = np.linspace(0.1, 0.9, 17)
    if median_windows is None:
        median_windows = [5]
    labels = list(codec.labels)
    C = len(labels)
    best_f1 = np.zeros(C)
    best_th = np.full(C, 0.5)
    best_win = np.full(C, int(median_windows[0]), np.int64)

    def score(g, w):
        rows = decode_events_per_class(strong_probs, filenames, codec, sample_rate, hop_length,
                                       pooling_time_ratio, g, w)
        return _class_f1(event_based_metrics(groundtruth, rows, t_collar, percentage_of_length), labels)

    default_f1 = score(0.5, 5)
    for w in sorted(int(x) for x in median_windows):
        for g in grid:
            f1 = score(float(g), w)
            better = f1 > best_f1 + 1e-12  # a tie keeps the earlier point
            best_f1 = np.where(better, f1, best_f1)
            best_th = np.where(better, float(g), best_th)
            best_win = np.where(better, w, best_win)
    tuned = decode_events_per_class(strong_probs, filenames, codec, sample_rate, hop_length, pooling_time_ratio,
                                    best_th, best_win)
    macro = float(np.mean(_class_f1(event_based_metrics(groundtruth, tuned, t_collar, percentage_of_length),
                                    labels)))
    return {
        "thresholds": best_th,
        "windows": best_win,
        "f1": best_f1,
        "macro_f1": macro,
        "default_f1": default_f1,
        "default_macro_f1": float(np.mean(default_f1)),
    }
