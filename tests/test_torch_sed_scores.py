"""The port's pandas-free scorer against the JAX package's scorer.

Every scoring call in the cases of tests/test_sed_scores.py,
tests/test_sed_eval_derived.py, tests/test_sed_fuzz.py (every seed of
every parametrised case) and tests/test_tagging.py goes through both
scorers: each test function runs with the JAX functions it imported
replaced by duals that score the same tables with the port too (the
DataFrames turned into rows, NaN into None), hold the two results to each
other and hand the JAX result back, so the case's own assertions still
run. Counts must be equal (per class tp / n_ref / n_sys, the overall
counts, the substitutions and the segment error split), the class lists
equal, and every F1, precision, recall and rate within 1e-12.
"""

import inspect

import numpy as np
import pandas as pd
import pytest

import test_sed_eval_derived
import test_sed_fuzz
import test_sed_scores
import test_tagging
from dcase2019_task4_tpu.eval import sed_scores as jsed
from dcase2019_task4_tpu.eval import tagging as jtag
from dcase2019_task4_tpu_torch.eval import sed_scores as tsed
from dcase2019_task4_tpu_torch.eval import tagging as ttag

F_TOL = 1e-12
CALLS = {"scored": 0}


def rows_of(df: pd.DataFrame):
    """A DataFrame → the port's rows: dicts in row order, NaN → None."""
    return [{k: (None if isinstance(v, float) and np.isnan(v) else v) for k, v in r.items()}
            for r in df.to_dict("records")]


def _close(a, b, where):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _close(a[k], b[k], f"{where}.{k}")
    else:
        assert abs(a - b) <= F_TOL, (where, a, b)


def same_metrics(theirs: jsed.SedMetrics, mine: tsed.SedMetrics):
    assert mine.classes == theirs.classes
    for c in theirs.classes:
        t, m = theirs.counts[c], mine.counts[c]
        assert (m.tp, m.n_ref, m.n_sys) == (t.tp, t.n_ref, t.n_sys), c
    o, p = theirs.overall, mine.overall
    assert (p.tp, p.n_ref, p.n_sys) == (o.tp, o.n_ref, o.n_sys)
    assert (mine.n_subs, mine.seg_S, mine.seg_D, mine.seg_I) == (theirs.n_subs, theirs.seg_S, theirs.seg_D,
                                                                  theirs.seg_I)
    _close(theirs.results(), mine.results(), "results")
    assert abs(mine.macro_f_measure() - theirs.macro_f_measure()) <= F_TOL
    assert str(mine) == str(theirs)
    CALLS["scored"] += 1


def dual_event(ref, est, *args, **kw):
    theirs = jsed.event_based_metrics(ref, est, *args, **kw)
    same_metrics(theirs, tsed.event_based_metrics(rows_of(ref), rows_of(est), *args, **kw))
    return theirs


def dual_segment(ref, est, *args, **kw):
    theirs = jsed.segment_based_metrics(ref, est, *args, **kw)
    same_metrics(theirs, tsed.segment_based_metrics(rows_of(ref), rows_of(est), *args, **kw))
    return theirs


def dual_strong(predictions, valid, logger=None):
    theirs = jsed.compute_strong_metrics(predictions, valid)
    same_metrics(theirs, tsed.compute_strong_metrics(rows_of(predictions), rows_of(valid)))
    return theirs


def dual_array(name):
    def call(*args, **kw):
        theirs = getattr(jtag, name)(*args, **kw)
        mine = getattr(ttag, name)(*args, **kw)
        for a, b in zip(theirs if isinstance(theirs, tuple) else (theirs,), mine if isinstance(mine, tuple) else (mine,)):
            np.testing.assert_array_equal(b, a)
        CALLS["scored"] += 1
        return theirs

    return call


class DualTaggingF1:
    def __init__(self, *args, **kw):
        self.theirs, self.mine = jtag.TaggingF1(*args, **kw), ttag.TaggingF1(*args, **kw)

    def update(self, *args):
        self.theirs.update(*args)
        self.mine.update(*args)

    def per_class_f1(self):
        np.testing.assert_array_equal(self.mine.per_class_f1(), self.theirs.per_class_f1())
        CALLS["scored"] += 1
        return self.theirs.per_class_f1()


def dual_tagging_results(ref, est):
    theirs = jtag.audio_tagging_results(ref, est)
    mine = ttag.audio_tagging_results(rows_of(ref), rows_of(est))
    assert list(mine) == list(theirs.index)
    for c in theirs.index:
        assert abs(mine[c] - theirs[c]) <= F_TOL, c
    CALLS["scored"] += 1
    return theirs


DUALS = {"event_based_metrics": dual_event, "segment_based_metrics": dual_segment,
         "compute_strong_metrics": dual_strong, "audio_tagging_results": dual_tagging_results,
         "TaggingF1": DualTaggingF1, "binarize": dual_array("binarize"),
         "confusion_counts": dual_array("confusion_counts"), "macro_f_measure": dual_array("macro_f_measure")}
# cases that score nothing through these functions: the matcher brute
# force, SedMetrics.from_counts alone (both held below) and the host all-sum
NOT_SCORING = {"test_matching_vs_bruteforce_property", "test_all_sum_hosts_single_process_identity",
               "test_macro_f_zero_when_no_support", "test_from_counts_drop_absent_semantics"}


def _cases():
    out = []
    for module in (test_sed_scores, test_sed_eval_derived, test_sed_fuzz, test_tagging):
        for name, fn in inspect.getmembers(module, inspect.isfunction):
            if name.startswith("test_") and fn.__module__ == module.__name__ and name not in NOT_SCORING:
                out.append(pytest.param(module, name, id=f"{module.__name__}::{name}"))
    return out


def _calls(fn):
    """Every argument set the case is parametrised with (none: one call)."""
    marks = [m for m in getattr(fn, "pytestmark", []) if m.name == "parametrize"]
    calls = [{}]
    for m in marks:
        names = [n.strip() for n in m.args[0].split(",")] if isinstance(m.args[0], str) else list(m.args[0])
        values = m.args[1]
        calls = [dict(c, **dict(zip(names, v if len(names) > 1 else (v,)))) for c in calls for v in values]
    return calls


@pytest.mark.parametrize("module, name", _cases())
def test_the_case_scores_the_same(monkeypatch, module, name):
    for attr, dual in DUALS.items():
        if hasattr(module, attr):
            monkeypatch.setattr(module, attr, dual)
    fn = getattr(module, name)
    before, ran = CALLS["scored"], 0
    for kw in _calls(fn):
        try:
            fn(**kw)
            ran += 1
        except pytest.skip.Exception:
            pass  # the case's own skip (an event boundary exactly on a segment edge)
    assert ran > 0
    assert CALLS["scored"] > before, "the case scored nothing through the duals"


@pytest.mark.parametrize("seed", range(0, 300, 10))
def test_count_vector_shard_merge_matches_jax(seed):
    """The port's count_vector / from_counts over file shards give the JAX
    package's merged metrics, event- and segment-based."""
    ref, est = test_sed_fuzz.make_case(seed)
    classes = sorted(set(ref.event_label.dropna()) | set(est.event_label.dropna()) | {"Absent"})
    files = list(ref.filename.unique())
    for jscore, tscore, seg in ((jsed.event_based_metrics, tsed.event_based_metrics, False),
                                (jsed.segment_based_metrics, tsed.segment_based_metrics, True)):
        jvec, tvec = np.zeros(3 * len(classes) + 7), np.zeros(3 * len(classes) + 7)
        for part in (files[0::2], files[1::2]):
            r = ref[ref.filename.isin(part)].reset_index(drop=True)
            e = est[est.filename.isin(part)].reset_index(drop=True)
            jvec += jscore(r, e).count_vector(classes)
            tvec += tscore(rows_of(r), rows_of(e)).count_vector(classes)
        np.testing.assert_array_equal(tvec, jvec)
        kind = "Segment-based" if seg else "Event-based"
        same_metrics(jsed.SedMetrics.from_counts(classes, kind, jvec, segment_based=seg),
                     tsed.SedMetrics.from_counts(classes, kind, tvec, segment_based=seg))


@pytest.mark.parametrize("drop_absent", [True, False])
def test_from_counts_drop_absent_matches_jax(drop_absent):
    vec = np.zeros(3 * 3 + 7)
    vec[0:3] = (1.0, 1.0, 1.0)  # class a perfect, b absent, c missed
    vec[6:9] = (0.0, 2.0, 1.0)
    vec[-7:] = (1.0, 3.0, 2.0, 1.0, 0.0, 0.0, 0.0)
    args = (["a", "b", "c"], "Event-based", vec)
    same_metrics(jsed.SedMetrics.from_counts(*args, drop_absent=drop_absent),
                 tsed.SedMetrics.from_counts(*args, drop_absent=drop_absent))


def test_bipartite_matcher_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(200):
        hits = rng.random((int(rng.integers(0, 6)), int(rng.integers(0, 6)))) < 0.4
        assert tsed._max_matching(hits) == jsed._max_matching(hits)
        for a, b in zip(tsed._greedy_matching(hits), jsed._greedy_matching(hits)):
            np.testing.assert_array_equal(a, b)


def test_the_decoders_tuples_and_a_manifest_score_as_dicts(tmp_path):
    """The port scores the decoder's (event_label, onset, offset, filename)
    rows and a Manifest as it scores their dicts."""
    from dcase2019_task4_tpu_torch.data.manifests import load_manifest

    path = tmp_path / "ref.tsv"
    path.write_text("filename\tonset\toffset\tevent_label\na.wav\t1.0\t2.0\tDog\nb.wav\t\t\t\n"
                    "c.wav\t0.5\t3.25\tCat\n")
    est = [("Dog", 1.1, 2.05, "a.wav"), ("Cat", 0.0, 1.0, "b.wav"), ("Cat", 0.6, 3.0, "c.wav")]
    manifest = load_manifest(str(path))
    jref = pd.read_csv(path, sep="\t")
    jest = pd.DataFrame([dict(zip(tsed.COLUMNS, r)) for r in est])
    for score in ("event_based_metrics", "segment_based_metrics"):
        same_metrics(getattr(jsed, score)(jref, jest), getattr(tsed, score)(manifest, est))
    assert manifest.filenames == ["a.wav", "b.wav", "c.wav"] and manifest.events[1] == []
