"""Event decoding without pandas: probabilities → events → TSV
(counterpart of dcase2019_task4_tpu/eval/decode.py).

Binarise [B, T, C] strong probabilities with a scalar or per-class
threshold, median-filter over time with a scalar or per-class odd window
(scipy's reflect edges), run-length decode with LabelCodec, and scale
pooled frames to seconds by `frames · pooling_time_ratio / (sample_rate /
hop_length)`. The TSV has the reference's columns
`event_label onset offset filename`, tab-separated. `merge_window_events`
stitches the per-window events of a long file (predict --long).
"""

from __future__ import annotations

import csv
from typing import List, Optional, Tuple

import numpy as np
import torch

from dcase2019_task4_tpu_torch.data.encoder import LabelCodec
from dcase2019_task4_tpu_torch.ops.mel import median_filter_binary

COLUMNS = ("event_label", "onset", "offset", "filename")
Event = Tuple[str, float, float, str]


def binarize_and_median(strong_probs: torch.Tensor, threshold=0.5, window=5) -> torch.Tensor:
    """[B, T, C] probabilities → median-filtered binary grid (float32).
    `threshold`: scalar or [C]; `window`: odd scalar or [C] odd ints."""
    th = torch.as_tensor(np.asarray(threshold, dtype=np.float64), dtype=strong_probs.dtype,
                         device=strong_probs.device)
    binary = (strong_probs > th).to(torch.float32)
    if np.ndim(window) == 0:
        return median_filter_binary(binary, int(window))
    wins = [int(w) for w in np.asarray(window).reshape(-1)]
    if len(wins) != strong_probs.shape[-1]:
        raise ValueError(f"per-class windows {len(wins)} != classes {strong_probs.shape[-1]}")
    if any(w % 2 == 0 for w in wins):
        raise ValueError(f"windows must be odd, got {wins}")
    filt = {w: median_filter_binary(binary, w) for w in sorted(set(wins))}
    return torch.cat([filt[w][..., c : c + 1] for c, w in enumerate(wins)], dim=-1)


def grids_to_events(grids: np.ndarray, filenames: List[str], codec: LabelCodec, sample_rate: int,
                    hop_length: int, pooling_time_ratio: int) -> List[Event]:
    """Binary [B, T, C] grids → [(label, onset_s, offset_s, filename)]."""
    scale = pooling_time_ratio / (sample_rate / hop_length)
    rows = []
    for fname, events in zip(filenames, codec.decode_strong_batch(np.asarray(grids))):
        for label, on, off in events:
            rows.append((label, on * scale, off * scale, fname))
    return rows


def decode_batch(strong_probs, filenames: List[str], codec: LabelCodec, sample_rate: int = 44100,
                 hop_length: int = 511, pooling_time_ratio: int = 8, threshold=0.5,
                 median_window=5) -> List[Event]:
    """Full decode: probs [B, T, C] (tensor or array) → event rows."""
    grids = binarize_and_median(torch.as_tensor(strong_probs), threshold, median_window)
    return grids_to_events(grids.cpu().numpy(), filenames, codec, sample_rate, hop_length,
                           pooling_time_ratio)


def write_events_tsv(rows: List[Event], path: Optional[str]) -> List[Event]:
    """Event rows → a TSV with the reference's header (with a path), and
    the rows back (the JAX package's `predictions_to_tsv`, over rows)."""
    if path is not None:
        with open(path, "w", newline="") as f:
            w = csv.writer(f, delimiter="\t", lineterminator="\n")
            w.writerow(COLUMNS)
            w.writerows(rows)
    return rows


def merge_window_events(rows: List[Event], merge_gap: float = 0.2) -> List[Event]:
    """Stitch per-window events into file-level events (long-audio decode;
    JAX eval/decode.py:118-144). Rows hold onsets and offsets in file
    seconds. Within each (filename, class), in order of first appearance,
    events sorted by onset merge while the next onset lies within
    `merge_gap` seconds of the running offset: a window is decoded on its
    own, so an event across a window boundary arrives as two fragments.
    The result is sorted by (filename, onset, event_label)."""
    groups = {}
    for label, on, off, fname in rows:
        groups.setdefault((fname, label), []).append((on, off))
    out = []
    for (fname, label), spans in groups.items():
        spans.sort(key=lambda s: s[0])
        cur_on, cur_off = spans[0]
        for on, off in spans[1:]:
            if on <= cur_off + merge_gap:
                cur_off = max(cur_off, off)
            else:
                out.append((label, cur_on, cur_off, fname))
                cur_on, cur_off = on, off
        out.append((label, cur_on, cur_off, fname))
    return sorted(out, key=lambda r: (r[3], r[1], r[0]))
