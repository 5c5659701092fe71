"""Label codec: many-hot encoding of weak/strong labels, run-length decode.

Re-design of the reference `ManyHotEncoder`
(reference baseline utils/utils.py:22-172):

  * weak labels  → k-hot vector [C]
  * strong events→ frame-activity grid [T, C] at pooled-frame resolution
  * "unlabeled"  → all −1 sentinel (so streams concatenate into one batch
    tensor and loss masking is a static slice under jit)
  * decode: binary [T, C] grid → [(label, onset_frame, offset_frame)] via a
    vectorized diff-based run-length scan (replaces dcase_util
    DecisionEncoder.find_contiguous_regions).

Everything here is pure numpy operating on whole datasets at once — encoding
is a one-time host-side packing step; the hot path consumes the packed
arrays directly.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


class LabelCodec:
    """Encode/decode event labels.

    Args:
        labels: ordered class names (index == class id).
        n_frames: pooled time resolution for strong grids (reference uses
            max_frames // pooling_time_ratio = 864 // 8 = 108, main.py:210).
    """

    def __init__(self, labels: Sequence[str], n_frames: int | None = None):
        self.labels: List[str] = [str(l) for l in labels]
        self.n_frames = n_frames
        self._index = {l: i for i, l in enumerate(self.labels)}

    # ------------------------------------------------------------------ weak

    def encode_weak(self, labels) -> np.ndarray:
        """k-hot [C] from an iterable of label strings.

        The sentinel string "empty" yields all −1 (unlabeled stream), matching
        utils.py:53-57.
        """
        if isinstance(labels, str):
            if labels == "empty":
                return np.full(len(self.labels), -1.0)
            labels = [labels]
        y = np.zeros(len(self.labels))
        for label in labels:
            if label is None:
                continue
            if isinstance(label, float) and np.isnan(label):
                continue
            y[self._index[label]] = 1.0
        return y

    def decode_weak(self, encoded: np.ndarray) -> List[str]:
        return [self.labels[i] for i in np.flatnonzero(np.asarray(encoded) == 1)]

    # ---------------------------------------------------------------- strong

    def encode_strong(self, events) -> np.ndarray:
        """Frame grid [n_frames, C].

        `events` is one of (mirroring utils.py:70-126's accepted inputs):
          * "empty"                         → all −1 (unlabeled)
          * iterable of label strings       → active on every frame (weak-as-strong)
          * iterable of (label, onset, offset) with frame units, offset
            exclusive → active on [onset, offset)
        """
        assert self.n_frames is not None, "n_frames required for strong encoding"
        if isinstance(events, str):
            if events == "empty":
                return np.full((self.n_frames, len(self.labels)), -1.0)
            events = [events]
        y = np.zeros((self.n_frames, len(self.labels)))
        for ev in events:
            if isinstance(ev, str):
                if ev != "":
                    y[:, self._index[ev]] = 1.0
            else:
                label, onset, offset = ev[0], int(ev[1]), int(ev[2])
                if label != "" and label is not None:
                    onset = max(0, onset)
                    offset = min(self.n_frames, offset)
                    y[onset:offset, self._index[label]] = 1.0
        return y

    def decode_strong(self, grid: np.ndarray) -> List[Tuple[str, int, int]]:
        """Binary grid [T, C] → [(label, onset, offset)] with offset exclusive.

        Vectorized run-length decode: pad each class column with zeros and
        diff; +1 marks onsets, −1 offsets. Replaces the per-class
        find_contiguous_regions loop of the reference (utils.py:146-162).
        Results are ordered class-major then by onset, like the reference.
        """
        grid = np.asarray(grid)
        padded = np.zeros((grid.shape[0] + 2, grid.shape[1]), dtype=np.int8)
        padded[1:-1] = grid > 0.5
        d = np.diff(padded, axis=0)
        out: List[Tuple[str, int, int]] = []
        for c in range(grid.shape[1]):
            onsets = np.flatnonzero(d[:, c] == 1)
            offsets = np.flatnonzero(d[:, c] == -1)
            for o, f in zip(onsets, offsets):
                out.append((self.labels[c], int(o), int(f)))
        return out

    def decode_strong_batch(self, grids: np.ndarray) -> List[List[Tuple[str, int, int]]]:
        """Batched decode of [B, T, C] binary grids (single vectorized diff)."""
        grids = np.asarray(grids)
        B, T, C = grids.shape
        padded = np.zeros((B, T + 2, C), dtype=np.int8)
        padded[:, 1:-1] = grids > 0.5
        d = np.diff(padded, axis=1)
        bs, ts, cs = np.nonzero(d == 1)
        be, te, ce = np.nonzero(d == -1)
        # onsets/offsets pair up in order within each (batch, class) column
        out: List[List[Tuple[str, int, int]]] = [[] for _ in range(B)]
        # sort class-major within batch to mirror decode_strong's ordering
        order_s = np.lexsort((ts, cs, bs))
        order_e = np.lexsort((te, ce, be))
        for (b, t0, c), (b2, t1, c2) in zip(
            zip(bs[order_s], ts[order_s], cs[order_s]),
            zip(be[order_e], te[order_e], ce[order_e]),
        ):
            out[int(b)].append((self.labels[int(c)], int(t0), int(t1)))
        return out

    # ------------------------------------------------------------- state

    def state_dict(self):
        return {"labels": list(self.labels), "n_frames": self.n_frames}

    @classmethod
    def load_state_dict(cls, state):
        return cls(state["labels"], state["n_frames"])


def events_to_frames(
    onsets_sec: np.ndarray,
    offsets_sec: np.ndarray,
    sample_rate: int,
    hop_length: int,
    pooling_time_ratio: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Seconds → pooled-frame indices, with the reference's exact floor-div
    arithmetic (main.py:227-228: `onset * sr // hop // ptr`)."""
    on = np.asarray(onsets_sec, dtype=np.float64) * sample_rate // hop_length // pooling_time_ratio
    off = np.asarray(offsets_sec, dtype=np.float64) * sample_rate // hop_length // pooling_time_ratio
    return on.astype(np.int64), off.astype(np.int64)


def frames_to_seconds(frames, sample_rate: int, hop_length: int, pooling_time_ratio: int):
    """Pooled frames → seconds (evaluation_measures.py:226-227:
    `frames * ptr / (sr / hop)`)."""
    return np.asarray(frames, dtype=np.float64) * pooling_time_ratio / (sample_rate / hop_length)
