"""TSV manifests for the three DESED label schemas, without pandas
(counterpart of dcase2019_task4_tpu/data/manifests.py).

A `Manifest` keeps the TSV's rows as a list of dicts in file order, where
the JAX package keeps a DataFrame, and packs labels into dense numpy arrays
once, so the training hot path is pure array gathers.

Schemas (reference README.md:106-133):
  * unlabeled: `filename`
  * weak:      `filename ⇥ event_labels` (comma-joined)
  * strong:    `filename ⇥ onset ⇥ offset ⇥ event_label` (one row per event)

A row's empty field reads as None (pandas reads NaN): a strong row with no
`event_label` marks a file without events, which stays in the manifest.
`onset` and `offset` are floats.

The splits draw what pandas draws. `sample(k, random_state=s)` takes the
positions `np.random.RandomState(s).permutation(n)[:k]`, in that order, and
`sample(frac=f)` takes k = round(f · n) (Python's round). Subparts and the
synthetic split keep the kept files' rows in file order (pandas `isin`);
the weak split keeps its train rows in sampled order.
"""

from __future__ import annotations

import csv
import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from dcase2019_task4_tpu_torch.data.encoder import LabelCodec, events_to_frames

Row = Dict[str, object]


@dataclasses.dataclass
class Manifest:
    """One dataset split: unique filenames + per-file labels.

    kind is one of "unlabeled" | "weak" | "strong".
    For "strong", events hold (label, onset_sec, offset_sec) per file.
    """

    kind: str
    filenames: List[str]
    rows: List[Row]  # the TSV's rows in order (for scoring / TSV round-trips)
    columns: List[str]  # the TSV's header
    # weak: list (per file) of class-name lists
    weak_labels: Optional[List[List[str]]] = None
    # strong: list (per file) of (label, onset_sec, offset_sec) tuples
    events: Optional[List[List[tuple]]] = None

    def __len__(self) -> int:
        return len(self.filenames)

    def encode_targets(
        self,
        codec: LabelCodec,
        sample_rate: int,
        hop_length: int,
        pooling_time_ratio: int,
    ) -> np.ndarray:
        """Pack this split's labels into one [N, n_frames, C] float array.

        * unlabeled → all −1 (the concat-and-mask trick of DataLoad.py:104)
        * weak      → each present class active on every frame
        * strong    → event spans converted sec→pooled frames with the
          reference's floor-div arithmetic (main.py:227-228)
        """
        N, T, C = len(self), codec.n_frames, len(codec.labels)
        y = np.zeros((N, T, C), dtype=np.float32)
        if self.kind == "unlabeled":
            y.fill(-1.0)
            return y
        if self.kind == "weak":
            for i, labels in enumerate(self.weak_labels):
                for l in labels:
                    y[i, :, codec._index[l]] = 1.0
            return y
        for i, evs in enumerate(self.events):
            if not evs:
                continue
            labels = [e[0] for e in evs]
            on, off = events_to_frames(
                np.array([e[1] for e in evs]),
                np.array([e[2] for e in evs]),
                sample_rate,
                hop_length,
                pooling_time_ratio,
            )
            for l, o, f in zip(labels, on, off):
                y[i, max(0, o) : min(T, f), codec._index[l]] = 1.0
        return y


_POW10 = [float(f"1e{k}") for k in range(309)]


def parse_float(text: str) -> float:
    """A decimal string → float as pandas' default C parser reads it
    (`precise_xstrtod`): the first 17 digits, leading zeros included, summed
    as n·10 + d in float64, then one multiply or divide by a power of ten.
    Python's float() rounds correctly and so differs in the last bit for
    some 17-digit values of the DESED TSVs."""
    p = text.strip()
    negative = p[:1] == "-"
    if p[:1] in "+-":
        p = p[1:]
    i = n_digits = exponent = 0
    number = 0.0
    while i < len(p) and p[i].isdigit():
        if n_digits < 17:
            number = number * 10.0 + (ord(p[i]) - 48)
            n_digits += 1
        else:
            exponent += 1
        i += 1
    if i < len(p) and p[i] == ".":
        i += 1
        n_decimals = 0
        while n_digits < 17 and i < len(p) and p[i].isdigit():
            number = number * 10.0 + (ord(p[i]) - 48)
            n_digits += 1
            n_decimals += 1
            i += 1
        while i < len(p) and p[i].isdigit():
            i += 1
        exponent -= n_decimals
    if n_digits == 0:
        raise ValueError(f"not a number: {text!r}")
    if negative:
        number = -number
    if i < len(p):
        if p[i] not in "eE":
            raise ValueError(f"not a number: {text!r}")
        exponent += int(p[i + 1 :])
    if exponent > 308:
        return number * float("inf") if number else 0.0
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -308:
        return 0.0 if exponent < -616 else number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _cell(key: str, value: Optional[str]):
    if value is None or value == "":
        return None
    if key in ("onset", "offset"):
        return parse_float(value)
    return value


def read_rows(tsv_path: str):
    """(rows, columns) of a TSV: rows as dicts, empty fields None,
    onset/offset floats."""
    with open(tsv_path, newline="") as f:
        reader = csv.DictReader(f, delimiter="\t")
        rows = [{k: _cell(k, v) for k, v in r.items()} for r in reader]
        return rows, list(reader.fieldnames or [])


def load_manifest(tsv_path: str) -> Manifest:
    """Parse a TSV into a Manifest, auto-detecting the schema."""
    rows, columns = read_rows(tsv_path)
    cols = set(columns)
    if not ({"onset", "offset", "event_label"} <= cols or "event_labels" in cols or "filename" in cols):
        raise ValueError(f"Unrecognized manifest schema: {sorted(cols)}")
    return manifest_from_rows(rows, columns)


def manifest_from_rows(rows: List[Row], columns: Optional[Sequence[str]] = None) -> Manifest:
    """Rows (in order) → Manifest. The schema comes from `columns`, or from
    the first row's keys."""
    columns = list(columns if columns is not None else (rows[0] if rows else ["filename"]))
    cols = set(columns)
    filenames = list(dict.fromkeys(r["filename"] for r in rows))
    if {"onset", "offset", "event_label"} <= cols:
        events: Dict[str, list] = {f: [] for f in filenames}
        for r in rows:
            if r["event_label"] is not None:
                events[r["filename"]].append((r["event_label"], float(r["onset"]), float(r["offset"])))
        return Manifest("strong", filenames, rows, columns, events=[events[f] for f in filenames])
    if "event_labels" in cols:
        first: Dict[str, object] = {}
        for r in rows:
            first.setdefault(r["filename"], r["event_labels"])
        labels = [str(first[f]).split(",") if first[f] else [] for f in filenames]
        return Manifest("weak", filenames, rows, columns, weak_labels=labels)
    return Manifest("unlabeled", filenames, rows, columns)


def _subset(m: Manifest, rows: List[Row]) -> Manifest:
    return manifest_from_rows(rows, m.columns)


def _keep_files(m: Manifest, keep) -> List[Row]:
    keep = set(keep)
    return [r for r in m.rows if r["filename"] in keep]


def _sample_positions(n: int, k: int, seed: int) -> np.ndarray:
    """pandas `sample(k, random_state=seed)` over n items: the positions."""
    return np.random.RandomState(seed).permutation(n)[:k]


def subpart_manifest(m: Manifest, subpart_data: Optional[int], seed: int = 10) -> Manifest:
    """Subsample to `subpart_data` files (reference get_subpart_data,
    DatasetDcase2019Task4.py:122-129: sample unique filenames, seed 10)."""
    if subpart_data is None or subpart_data > len(m.filenames):
        return m
    pos = _sample_positions(len(m.filenames), subpart_data, seed)
    return _subset(m, _keep_files(m, (m.filenames[i] for i in pos)))


def shard_manifest(m: Manifest, process_index: int, process_count: int) -> Manifest:
    """Every process_count-th unique filename, from the process_index-th
    (round-robin), with their rows in file order: one process's share of
    an evaluation set. Event, segment and tagging counts are additive over
    any partition of the files (eval/sed_scores.py count_vector), so the
    merged numbers are exact."""
    if process_count <= 1:
        return m
    return _subset(m, _keep_files(m, m.filenames[process_index::process_count]))


def split_weak(m: Manifest, frac: float = 0.8, seed: int = 26):
    """80/20 split of a weak manifest by row (reference main.py:215-218):
    train rows in sampled order, valid rows in file order."""
    n = len(m.rows)
    pos = _sample_positions(n, round(frac * n), seed)
    taken = set(pos.tolist())
    train = [m.rows[i] for i in pos]
    valid = [r for i, r in enumerate(m.rows) if i not in taken]
    return _subset(m, train), _subset(m, valid)


def split_synthetic(m: Manifest, frac: float = 0.8, seed: int = 26):
    """80/20 split of a strong manifest by unique filename
    (reference main.py:221-223); both sides in file order."""
    n = len(m.filenames)
    keep = {m.filenames[i] for i in _sample_positions(n, round(frac * n), seed)}
    train = [r for r in m.rows if r["filename"] in keep]
    valid = [r for r in m.rows if r["filename"] not in keep]
    return _subset(m, train), _subset(m, valid)


def random_split(m: Manifest, lengths: Sequence[int], seed: int = 0):
    """Split by unique file into non-overlapping manifests of the given
    sizes (reference random_split, DataLoad.py:461-477)."""
    if sum(lengths) != len(m.filenames):
        raise ValueError("Sum of input lengths does not equal the manifest length")
    perm = np.random.default_rng(seed).permutation(len(m.filenames))
    out, start = [], 0
    for n in lengths:
        out.append(_subset(m, _keep_files(m, (m.filenames[i] for i in perm[start : start + n]))))
        start += n
    return out


def train_valid_split(m: Manifest, validation_amount: float, seed: int = 0):
    """(train, valid) split (reference train_valid_split,
    DataLoad.py:480-485)."""
    n_valid = int(validation_amount * len(m.filenames))
    train, valid = random_split(m, [len(m.filenames) - n_valid, n_valid], seed)
    return train, valid


def classes_from_manifests(manifests: Sequence[Manifest]) -> List[str]:
    """Union of classes across manifests (reference get_classes,
    DatasetDcase2019Task4.py:108-120). Sorted for determinism."""
    classes = set()
    for m in manifests:
        if m.kind == "strong":
            for evs in m.events:
                classes.update(e[0] for e in evs)
        elif m.kind == "weak":
            for ls in m.weak_labels:
                classes.update(ls)
    return sorted(classes)
