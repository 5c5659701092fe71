"""Self-contained SED scoring without pandas: event-based and
segment-based macro F1 (counterpart of dcase2019_task4_tpu/eval/sed_scores.py,
the same definitions and the same greedy order).

The reference delegates scoring to the external `sed_eval` package
(evaluation_measures.py:124-182): EventBasedMetrics with a 200 ms onset
collar and an offset collar of max(200 ms, 20 % of the reference event
length), and SegmentBasedMetrics at 1 s resolution. This module implements
the same definitions natively so the framework has no unpackaged
dependencies; it is the scoring oracle for training-time validation and the
evaluate CLI.

Definitions implemented (matching the sed_eval conventions the reference
relies on — this module is sed_eval-EQUIVALENT, including its greedy
matching order, not merely collar-compatible):

  * Event-based, class-wise: within each file and class, a reference event
    CAN match an estimated event iff |onset_ref − onset_est| ≤ t_collar AND
    |offset_ref − offset_est| ≤ max(t_collar, percentage_of_length ·
    (offset_ref − onset_ref)). The default pairing reproduces sed_eval's
    algorithm exactly: iterate reference events in event-list (dataframe
    row) order and, for each, take the FIRST still-unmatched estimated
    event in row order that satisfies the collars (greedy first-fit — NOT
    globally optimal; `matching="bipartite"` selects the optimal 1-1
    pairing, which can only score ≥ the sed_eval number and is kept as an
    explicitly-named research option). Per class: P = tp/n_sys,
    R = tp/n_ref, F = 2PR/(P+R); undefined → 0 (the reference's
    empty_system_output_handling='zero_score'). Macro F averages over the
    class list (union of reference and estimated labels, like
    evaluation_measures.py:138-141). Overall (micro) counts additionally
    track substitutions — unmatched reference/estimated pairs whose collars
    hold but labels differ, greedily paired like sed_eval — giving the
    error-rate decomposition ER = (S + D + I) / N of the sed_eval report.
  * Segment-based: per file, time is cut into `time_resolution` segments up
    to the max offset seen in either list (sed_eval's evaluated_length when
    no file-length metadata is supplied, as in the reference); a class is
    active in a segment if any of its events overlaps it
    (floor(onset/res) .. ceil(offset/res), sed_eval's event-roll encoding);
    per-class tp/fp/fn accumulate over files, and per-segment
    S = min(fn_t, fp_t) / D = fn_t − S / I = fp_t − S accumulate the
    overall error rate.

Both accept event tables as sequences of rows (`records`): dicts with
filename, onset, offset and event_label (seconds; a None label marks a file
without events), the decoder's (event_label, onset, offset, filename)
tuples, or a Manifest (its rows). Row order is the order of the table.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

COLUMNS = ("event_label", "onset", "offset", "filename")


# ---------------------------------------------------------------- helpers


def records(table) -> List[Dict]:
    """An event table → its rows as dicts, in order: a Manifest's rows,
    dicts as they are, (event_label, onset, offset, filename) tuples as
    dicts of those keys."""
    rows = getattr(table, "rows", table)
    return [r if isinstance(r, dict) else dict(zip(COLUMNS, r)) for r in rows]


def _labels_of(rows: List[Dict]) -> set:
    return {r["event_label"] for r in rows if r.get("event_label") is not None}


def _events_by_file_class(rows: List[Dict]) -> Dict:
    """{filename: {class: [(onset, offset), ...]}}"""
    out: Dict = {}
    for row in rows:
        label = row.get("event_label")
        if label is None:
            continue
        out.setdefault(row["filename"], {}).setdefault(label, []).append(
            (float(row["onset"]), float(row["offset"]))
        )
    return out


def _max_matching(hits: np.ndarray) -> int:
    """Maximum bipartite matching size on a boolean [n_ref, n_est] hit
    matrix (augmenting paths — deterministic, optimal 1-1 pairing).
    Research option only; sed_eval's actual algorithm is _greedy_matching."""
    n_ref, n_est = hits.shape
    match_est = np.full(n_est, -1)

    def try_assign(r, seen):
        for e in range(n_est):
            if hits[r, e] and not seen[e]:
                seen[e] = True
                if match_est[e] == -1 or try_assign(match_est[e], seen):
                    match_est[e] = r
                    return True
        return False

    count = 0
    for r in range(n_ref):
        if try_assign(r, np.zeros(n_est, dtype=bool)):
            count += 1
    return count


def _greedy_matching(hits: np.ndarray):
    """sed_eval's pairing: for each reference event in list order, take the
    FIRST still-unmatched estimated event in list order whose collars hold.
    Returns (n_matched, ref_matched mask, est_matched mask) — the masks feed
    the substitution count of the overall error rate."""
    n_ref, n_est = hits.shape
    ref_matched = np.zeros(n_ref, dtype=bool)
    est_matched = np.zeros(n_est, dtype=bool)
    for r in range(n_ref):
        for e in range(n_est):
            if hits[r, e] and not est_matched[e]:
                ref_matched[r] = True
                est_matched[e] = True
                break
    return int(ref_matched.sum()), ref_matched, est_matched


@dataclasses.dataclass
class ClassCounts:
    tp: float = 0.0
    n_ref: float = 0.0
    n_sys: float = 0.0

    @property
    def precision(self):
        return self.tp / self.n_sys if self.n_sys > 0 else 0.0

    @property
    def recall(self):
        return self.tp / self.n_ref if self.n_ref > 0 else 0.0

    @property
    def f_measure(self):
        p, r = self.precision, self.recall
        return 2 * p * r / (p + r) if (p + r) > 0 else 0.0

    @property
    def fp(self):
        return self.n_sys - self.tp

    @property
    def fn(self):
        return self.n_ref - self.tp


class SedMetrics:
    """Accumulated class-wise counts + report (sed_eval-style interface:
    `results_class_wise_average_metrics()['f_measure']['f_measure']` is the
    macro F1 the reference's SaveBest criterion reads, main.py:347-349)."""

    def __init__(self, classes: List[str], name: str):
        self.classes = list(classes)
        self.name = name
        self.counts = {c: ClassCounts() for c in self.classes}
        # overall (micro) counts + the sed_eval error-rate decomposition:
        # event-based fills n_subs (time-matched, label-mismatched pairs);
        # segment-based fills seg_S/seg_D/seg_I (per-segment min/fn/fp split)
        self.overall = ClassCounts()
        self.n_subs = 0.0
        self.seg_S = 0.0
        self.seg_D = 0.0
        self.seg_I = 0.0
        self._segment_based = False

    # ---- additive count state (distributed evaluation) ----
    #
    # All scoring state is per-file-additive: matching runs per file, so
    # per-class (tp, n_ref, n_sys), the overall counts, and the error-rate
    # decomposition sum exactly over any partition of the evaluated files.
    # count_vector/from_counts serialize that state onto a FIXED class list
    # so shards that saw different class subsets merge correctly — the
    # multi-host eval path scores every Pth file per host and all-sums the
    # vectors (parallel/multihost.py all_sum_hosts).

    def count_vector(self, classes: List[str]) -> np.ndarray:
        """Flatten counts onto `classes` (superset of self.classes):
        [tp,n_ref,n_sys]·len(classes) ++ [overall tp,n_ref,n_sys] ++
        [n_subs, seg_S, seg_D, seg_I]."""
        v = np.zeros(3 * len(classes) + 7, np.float64)
        for i, c in enumerate(classes):
            cc = self.counts.get(c)
            if cc is not None:
                v[3 * i : 3 * i + 3] = (cc.tp, cc.n_ref, cc.n_sys)
        v[-7:-4] = (self.overall.tp, self.overall.n_ref, self.overall.n_sys)
        v[-4:] = (self.n_subs, self.seg_S, self.seg_D, self.seg_I)
        return v

    @classmethod
    def from_counts(cls, classes: List[str], name: str, vec: np.ndarray,
                    segment_based: bool = False,
                    drop_absent: bool = True) -> "SedMetrics":
        """Rebuild from a (merged) count vector. drop_absent removes classes
        with zero counts everywhere, reproducing the direct-scoring (and
        sed_eval) convention that the class list is the union of labels
        PRESENT in reference+estimate — otherwise the macro average would
        differ from an unsharded run whenever a class is entirely absent."""
        vec = np.asarray(vec, np.float64)
        kept = [
            c for i, c in enumerate(classes)
            if not drop_absent or vec[3 * i : 3 * i + 3].any()
        ]
        m = cls(kept, name)
        for i, c in enumerate(classes):
            if c in m.counts:
                m.counts[c] = ClassCounts(*vec[3 * i : 3 * i + 3])
        m.overall = ClassCounts(*vec[-7:-4])
        m.n_subs, m.seg_S, m.seg_D, m.seg_I = vec[-4:]
        m._segment_based = segment_based
        return m

    def class_wise_f_measure(self) -> Dict[str, float]:
        return {c: self.counts[c].f_measure for c in self.classes}

    def macro_f_measure(self) -> float:
        if not self.classes:
            return 0.0
        return float(np.mean([self.counts[c].f_measure for c in self.classes]))

    def results_class_wise_average_metrics(self):
        f = self.macro_f_measure()
        p = float(np.mean([self.counts[c].precision for c in self.classes])) if self.classes else 0.0
        r = float(np.mean([self.counts[c].recall for c in self.classes])) if self.classes else 0.0
        return {"f_measure": {"f_measure": f, "precision": p, "recall": r}}

    def results_overall_metrics(self):
        """Micro-averaged counts + the sed_eval error-rate decomposition
        (ER = (S + D + I) / Nref; sed_eval's overall report section)."""
        o = self.overall
        if self._segment_based:
            S, D, I = self.seg_S, self.seg_D, self.seg_I
        else:
            S = self.n_subs
            D = o.fn - S  # deletions: unmatched, unsubstituted reference events
            I = o.fp - S  # insertions: unmatched, unsubstituted system events
        n = o.n_ref
        return {
            "f_measure": {
                "f_measure": o.f_measure,
                "precision": o.precision,
                "recall": o.recall,
            },
            "error_rate": {
                "error_rate": (S + D + I) / n if n > 0 else 0.0,
                "substitution_rate": S / n if n > 0 else 0.0,
                "deletion_rate": D / n if n > 0 else 0.0,
                "insertion_rate": I / n if n > 0 else 0.0,
            },
        }

    def results(self):
        return {
            "overall": self.results_overall_metrics(),
            "class_wise_average": self.results_class_wise_average_metrics(),
            "class_wise": {
                c: {
                    "f_measure": self.counts[c].f_measure,
                    "precision": self.counts[c].precision,
                    "recall": self.counts[c].recall,
                    "tp": self.counts[c].tp,
                    "n_ref": self.counts[c].n_ref,
                    "n_sys": self.counts[c].n_sys,
                }
                for c in self.classes
            },
        }

    def __str__(self):
        ov = self.results_overall_metrics()
        lines = [
            f"{self.name} metrics",
            f"  macro F1: {100*self.macro_f_measure():.2f}%",
            f"  overall F1: {100*ov['f_measure']['f_measure']:.2f}%  "
            f"ER: {ov['error_rate']['error_rate']:.2f} "
            f"(S {ov['error_rate']['substitution_rate']:.2f}, "
            f"D {ov['error_rate']['deletion_rate']:.2f}, "
            f"I {ov['error_rate']['insertion_rate']:.2f})",
        ]
        for c in self.classes:
            cc = self.counts[c]
            lines.append(
                f"  {c:<28s} F1 {100*cc.f_measure:6.2f}%  P {100*cc.precision:6.2f}%  "
                f"R {100*cc.recall:6.2f}%  (ref {int(cc.n_ref)}, sys {int(cc.n_sys)})"
            )
        return "\n".join(lines)


# ----------------------------------------------------------- event-based


def _events_by_file(rows: List[Dict]) -> Dict:
    """{filename: [(onset, offset, label), ...]} in table row order (the
    order sed_eval sees via df.to_dict('records'),
    evaluation_measures.py:105-121 — greedy matching is order-sensitive)."""
    out: Dict = {}
    for row in rows:
        label = row.get("event_label")
        if label is None:
            continue
        out.setdefault(row["filename"], []).append(
            (float(row["onset"]), float(row["offset"]), label)
        )
    return out


def _collar_hit(r_on, r_off, e_on, e_off, t_collar, percentage_of_length) -> bool:
    off_collar = max(t_collar, percentage_of_length * (r_off - r_on))
    return abs(r_on - e_on) <= t_collar and abs(r_off - e_off) <= off_collar


def event_based_metrics(
    reference,
    estimated,
    t_collar: float = 0.200,
    percentage_of_length: float = 0.2,
    matching: str = "greedy",
) -> SedMetrics:
    """Collar-matched event scoring over all files in `reference`
    (evaluation_measures.py:124-157 contract).

    matching="greedy" (default) reproduces sed_eval's first-fit pairing in
    event-list order exactly — the number the challenge reports.
    matching="bipartite" substitutes the optimal 1-1 pairing (scores ≥ the
    sed_eval number; research option, NOT official)."""
    assert matching in ("greedy", "bipartite"), matching
    reference, estimated = records(reference), records(estimated)
    classes = sorted(_labels_of(reference) | _labels_of(estimated))
    metrics = SedMetrics(classes, "Event-based")
    ref_map = _events_by_file(reference)
    est_map = _events_by_file(estimated)
    for fname in dict.fromkeys(r["filename"] for r in reference):
        ref_evs = ref_map.get(fname, [])
        est_evs = est_map.get(fname, [])
        metrics.overall.n_ref += len(ref_evs)
        metrics.overall.n_sys += len(est_evs)
        ref_matched = np.zeros(len(ref_evs), dtype=bool)
        est_matched = np.zeros(len(est_evs), dtype=bool)
        for c in classes:
            r_idx = [i for i, ev in enumerate(ref_evs) if ev[2] == c]
            e_idx = [j for j, ev in enumerate(est_evs) if ev[2] == c]
            cc = metrics.counts[c]
            cc.n_ref += len(r_idx)
            cc.n_sys += len(e_idx)
            if not r_idx or not e_idx:
                continue
            hits = np.zeros((len(r_idx), len(e_idx)), dtype=bool)
            for a, i in enumerate(r_idx):
                r_on, r_off, _ = ref_evs[i]
                for b, j in enumerate(e_idx):
                    e_on, e_off, _ = est_evs[j]
                    hits[a, b] = _collar_hit(
                        r_on, r_off, e_on, e_off, t_collar, percentage_of_length
                    )
            if matching == "greedy":
                tp, rm, em = _greedy_matching(hits)
                # matched flags in whole-file coordinates drive substitutions
                for a, i in enumerate(r_idx):
                    ref_matched[i] = rm[a]
                for b, j in enumerate(e_idx):
                    est_matched[j] = em[b]
            else:
                tp = _max_matching(hits)
            cc.tp += tp
            metrics.overall.tp += tp
        if matching == "greedy":
            # substitutions: unmatched ref × unmatched est pairs whose
            # collars hold but labels differ, greedily paired in file order
            # (sed_eval's event-based error-rate decomposition)
            for i, (r_on, r_off, r_lab) in enumerate(ref_evs):
                if ref_matched[i]:
                    continue
                for j, (e_on, e_off, e_lab) in enumerate(est_evs):
                    if est_matched[j] or e_lab == r_lab:
                        continue
                    if _collar_hit(r_on, r_off, e_on, e_off, t_collar, percentage_of_length):
                        est_matched[j] = True
                        metrics.n_subs += 1
                        break
    return metrics


# --------------------------------------------------------- segment-based


def segment_based_metrics(
    reference,
    estimated,
    time_resolution: float = 1.0,
) -> SedMetrics:
    """Fixed-grid segment scoring (evaluation_measures.py:160-182 contract)."""
    reference, estimated = records(reference), records(estimated)
    classes = sorted(_labels_of(reference) | _labels_of(estimated))
    metrics = SedMetrics(classes, "Segment-based")
    metrics._segment_based = True
    cindex = {c: i for i, c in enumerate(classes)}
    ref_map = _events_by_file_class(reference)
    est_map = _events_by_file_class(estimated)
    for fname in dict.fromkeys(r["filename"] for r in reference):
        ref_classes = ref_map.get(fname, {})
        est_classes = est_map.get(fname, {})
        max_off = 0.0
        for evs in list(ref_classes.values()) + list(est_classes.values()):
            for _, off in evs:
                max_off = max(max_off, off)
        n_seg = int(np.ceil(max_off / time_resolution))
        if n_seg == 0:
            continue
        ref_act = np.zeros((n_seg, len(classes)), dtype=bool)
        est_act = np.zeros((n_seg, len(classes)), dtype=bool)
        for act, cmap in [(ref_act, ref_classes), (est_act, est_classes)]:
            for c, evs in cmap.items():
                ci = cindex[c]
                for on, off in evs:
                    lo = int(np.floor(on / time_resolution))
                    hi = int(np.ceil(off / time_resolution))
                    act[max(0, lo) : min(n_seg, hi), ci] = True
        for c in classes:
            ci = cindex[c]
            cc = metrics.counts[c]
            cc.tp += float(np.sum(ref_act[:, ci] & est_act[:, ci]))
            cc.n_ref += float(np.sum(ref_act[:, ci]))
            cc.n_sys += float(np.sum(est_act[:, ci]))
        # per-segment error decomposition (sed_eval segment-based ER):
        # S_t = min(fn_t, fp_t), D_t = fn_t − S_t, I_t = fp_t − S_t
        tp_t = np.sum(ref_act & est_act, axis=1).astype(float)
        fn_t = np.sum(ref_act, axis=1) - tp_t
        fp_t = np.sum(est_act, axis=1) - tp_t
        s_t = np.minimum(fn_t, fp_t)
        metrics.seg_S += float(np.sum(s_t))
        metrics.seg_D += float(np.sum(fn_t - s_t))
        metrics.seg_I += float(np.sum(fp_t - s_t))
    # overall (micro) counts are the class-count sums
    metrics.overall.tp = sum(metrics.counts[c].tp for c in classes)
    metrics.overall.n_ref = sum(metrics.counts[c].n_ref for c in classes)
    metrics.overall.n_sys = sum(metrics.counts[c].n_sys for c in classes)
    return metrics


def compute_strong_metrics(predictions, valid_df, logger=None):
    """Event+segment scoring with the reference's parameters
    (compute_strong_metrics, evaluation_measures.py:234-246); returns the
    event-based metrics object (the SaveBest criterion source)."""
    metric_event = event_based_metrics(valid_df, predictions, 0.200, 0.2)
    metric_segment = segment_based_metrics(valid_df, predictions, 1.0)
    if logger is not None:
        logger.info(str(metric_event))
        logger.info(str(metric_segment))
    return metric_event
