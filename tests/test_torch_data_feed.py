"""The port's pandas-free data feed against the JAX package's.

Manifests, splits and subparts from the repo's own dataset_metadata TSVs
(seeds 10 and 26, subpart sizes 12, 24, 96 and 150, and none): the same
filenames in the same order, the same events or tags, and bit-equal encoded
targets. The sampler's epoch batches bit-equal for several epochs and
stream layouts. `BatchPipeline.assemble` over synthetic streams of 1 s
clips (and a wav tree through the C++ packer, and a second view): int16
audio, frames and targets bit-equal. Then what only the port has: the
worker's error re-raised in the consumer, `device_prefetch` on the CPU.
"""

import functools

import numpy as np
import pandas as pd
import pytest

from dcase2019_task4_tpu.data import audio_io as jaudio
from dcase2019_task4_tpu.data import manifests as jman
from dcase2019_task4_tpu.data import pipeline as jpipe
from dcase2019_task4_tpu.data import sampler as jsampler
from dcase2019_task4_tpu.data.encoder import LabelCodec as JCodec
from dcase2019_task4_tpu_torch.config import Config, DSPConfig
from dcase2019_task4_tpu_torch.data import audio_io as taudio
from dcase2019_task4_tpu_torch.data import manifests as tman
from dcase2019_task4_tpu_torch.data import pipeline as tpipe
from dcase2019_task4_tpu_torch.data import sampler as tsampler
from dcase2019_task4_tpu_torch.data.encoder import LabelCodec

PATHS = Config().paths
CLASSES = list(Config().classes)
D = DSPConfig(max_len_seconds=1.0)


@functools.lru_cache(maxsize=None)
def loaded(name: str):
    """(JAX manifest, port manifest) of a repo TSV, read once."""
    path = getattr(PATHS, name)
    return jman.load_manifest(path), tman.load_manifest(path)


def same_manifest(theirs, mine, targets: bool = False):
    assert mine.kind == theirs.kind
    assert mine.filenames == theirs.filenames
    assert mine.events == theirs.events and mine.weak_labels == theirs.weak_labels
    if targets:
        want = theirs.encode_targets(JCodec(CLASSES, 108), 44100, 511, 8)
        got = mine.encode_targets(LabelCodec(CLASSES, 108), 44100, 511, 8)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["weak", "unlabel", "synthetic", "validation", "eval_desed", "eval2018"])
def test_load_manifest(name):
    same_manifest(*loaded(name))


def test_onsets_are_read_as_pandas_reads_them():
    """pandas' parser is not Python's float() in the last bit for some of
    the DESED onsets; the port reads them as pandas does."""
    for name in ("synthetic", "validation", "eval_desed", "eval2018", "test2018"):
        path = getattr(PATHS, name)
        df = pd.read_csv(path, sep="\t")
        rows = tman.load_manifest(path).rows
        for col in ("onset", "offset"):
            want = df[col].to_numpy()
            got = np.array([np.nan if r[col] is None else r[col] for r in rows])
            np.testing.assert_array_equal(got.view(np.int64)[~np.isnan(want)], want.view(np.int64)[~np.isnan(want)])
            assert (np.isnan(got) == np.isnan(want)).all()


@pytest.mark.parametrize("subpart", [None, 12, 24, 96, 150])
@pytest.mark.parametrize("seed", [10, 26])
def test_subparts_and_splits(subpart, seed):
    for name in ("weak", "synthetic", "unlabel", "validation"):
        theirs, mine = (man.subpart_manifest(m, subpart, seed) for man, m in zip((jman, tman), loaded(name)))
        small = subpart is not None and subpart <= 24
        same_manifest(theirs, mine, targets=small and name != "unlabel")
        if name == "weak":
            for t, m in zip(jman.split_weak(theirs, 0.8, seed), tman.split_weak(mine, 0.8, seed)):
                same_manifest(t, m, targets=small)
        if name in ("synthetic", "validation"):
            for t, m in zip(jman.split_synthetic(theirs, 0.8, seed), tman.split_synthetic(mine, 0.8, seed)):
                same_manifest(t, m, targets=small)


def test_random_and_train_valid_splits_and_classes():
    theirs, mine = (man.subpart_manifest(m, 60, 10) for man, m in zip((jman, tman), loaded("synthetic")))
    for t, m in zip(jman.random_split(theirs, [20, 30, 10], seed=3), tman.random_split(mine, [20, 30, 10], seed=3)):
        same_manifest(t, m)
    for t, m in zip(jman.train_valid_split(theirs, 0.25, seed=4), tman.train_valid_split(mine, 0.25, seed=4)):
        same_manifest(t, m)
    with pytest.raises(ValueError):
        tman.random_split(mine, [1, 2], seed=0)
    jweak, tweak = loaded("weak")
    assert tman.classes_from_manifests([mine, tweak]) == jman.classes_from_manifests([theirs, jweak])


def test_a_file_without_events_stays(tmp_path):
    path = tmp_path / "s.tsv"
    path.write_text("filename\tonset\toffset\tevent_label\na.wav\t0.5\t1.0\tDog\nb.wav\t\t\t\nc.wav\t0\t1\tCat\n")
    theirs, mine = jman.load_manifest(str(path)), tman.load_manifest(str(path))
    same_manifest(theirs, mine, targets=True)
    assert mine.filenames == ["a.wav", "b.wav", "c.wav"] and mine.events[1] == []
    for t, m in zip(jman.split_synthetic(theirs, 0.67, 1), tman.split_synthetic(mine, 0.67, 1)):
        same_manifest(t, m)


@pytest.mark.parametrize("sizes, batch", [([100, 200, 50], [6, 12, 6]), ([77, 96, 77], [6, 12, 6]),
                                          ([10, 12, 10], [2, 4, 2]), ([31, 90], [6, 18]), ([40, 40], [12, 12]),
                                          ([61], [24])])
def test_sampler_epoch_batches_bit_equal(sizes, batch):
    mine, theirs = tsampler.MultiStreamSampler(sizes, batch, seed=5), jsampler.MultiStreamSampler(sizes, batch, seed=5)
    assert len(mine) == len(theirs) and mine.stream_slices() == theirs.stream_slices()
    for epoch in range(4):
        np.testing.assert_array_equal(mine.epoch_batches(epoch), theirs.epoch_batches(epoch))
    a = tsampler.ClusterRandomSampler(sizes, batch, seed=2)
    b = jsampler.ClusterRandomSampler(sizes, batch, seed=2)
    assert len(a) == len(b)
    for epoch in range(2):
        for x, y in zip(a.epoch_batches(epoch), b.epoch_batches(epoch)):
            np.testing.assert_array_equal(x, y)


def _streams(ns, codec_t, codec_j, pipe, audio_io, man, variability=0.0, second=False):
    streams = []
    for name, tsv in (("weak", "weak"), ("unlabeled", "unlabel"), ("synthetic", "synthetic")):
        m = man.subpart_manifest(loaded(tsv)[man is tman], ns, 10)
        src = audio_io.SyntheticAudioSource(m, CLASSES, D.sample_rate, D.max_len_seconds, variability=variability)
        src2 = (audio_io.SyntheticAudioSource(m, CLASSES, D.sample_rate, D.max_len_seconds, variability=variability,
                                              seed_salt="desed-synth/v2") if second else None)
        codec = codec_t if pipe is tpipe else codec_j
        streams.append(pipe.Stream(name, m, src, codec, D.sample_rate, D.hop_length, 8, cache_audio=name != "unlabeled",
                                   source2=src2))
    return streams


@pytest.mark.parametrize("variability, second", [(0.0, False), (0.7, True)])
def test_assemble_bit_equal(variability, second):
    codec_t, codec_j = LabelCodec(CLASSES, D.max_frames // 8), JCodec(CLASSES, D.max_frames // 8)
    kw = (D.max_samples, D.n_window, D.hop_length, D.max_frames)
    mine = tpipe.BatchPipeline(_streams(8, codec_t, codec_j, tpipe, taudio, tman, variability, second), [2, 4, 2],
                               *kw, seed=3)
    theirs = jpipe.BatchPipeline(_streams(8, codec_t, codec_j, jpipe, jaudio, jman, variability, second), [2, 4, 2],
                                 *kw, seed=3)
    assert len(mine) == len(theirs) == 2 and mine.stream_slices() == theirs.stream_slices()
    for epoch in (0, 1):
        got = list(mine.iter_epoch(epoch, prefetch=2))
        want = list(theirs.iter_epoch(epoch, prefetch=2))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w) == sorted(["audio", "frames", "target"] + (["audio2"] if second else []))
            for k in w:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_assemble_through_the_native_packer_bit_equal(tmp_path):
    from dcase2019_task4_tpu_torch import native

    if not native.available():
        pytest.skip("no C++ toolchain for the native packer")
    rng = np.random.default_rng(0)
    names = [f"c{i}.wav" for i in range(6)]
    for i, n in enumerate(names):  # uneven lengths: short clips pad, long ones cut
        taudio.write_wav(str(tmp_path / n), np.clip(rng.standard_normal(int(44100 * (0.5 + 0.2 * i))) * 0.1, -1, 1),
                         44100)
    m_t, m_j = tpipe.dir_manifest(names), jman.Manifest("unlabeled", names, pd.DataFrame({"filename": names}))
    codec_t, codec_j = LabelCodec(CLASSES, D.max_frames // 8), JCodec(CLASSES, D.max_frames // 8)
    s_t = tpipe.Stream("w", m_t, taudio.WavAudioSource(str(tmp_path)), codec_t, D.sample_rate, D.hop_length, 8)
    s_j = jpipe.Stream("w", m_j, jaudio.WavAudioSource(str(tmp_path)), codec_j, D.sample_rate, D.hop_length, 8)
    kw = (D.max_samples, D.n_window, D.hop_length, D.max_frames)
    pairs = np.array([[0, i] for i in (5, 0, 3, 1)])
    g = tpipe.BatchPipeline([s_t], [4], *kw).assemble(pairs)
    w = jpipe.BatchPipeline([s_j], [4], *kw).assemble(pairs)
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    for gb, wb in zip(tpipe.iter_eval_batches(s_t, 4, *kw), jpipe.iter_eval_batches(s_j, 4, *kw)):
        assert gb["filenames"] == wb["filenames"] and gb["n_valid"] == wb["n_valid"]
        for k in ("audio", "frames", "target"):
            np.testing.assert_array_equal(gb[k], wb[k], err_msg=k)


class _Broken:
    def get_audio(self, name):
        if name.endswith("3.wav"):
            raise ValueError(f"cannot decode {name}")
        return np.zeros(441, np.float32)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_a_failing_worker_raises_in_the_consumer(prefetch):
    """The JAX worker ends the epoch quietly when assemble raises; the
    port's raises the error after the batches made before it."""
    names = [f"c{i}.wav" for i in range(8)]
    s = tpipe.Stream("b", tpipe.dir_manifest(names), _Broken(), LabelCodec(CLASSES, 10), D.sample_rate,
                     D.hop_length, 8)
    bp = tpipe.BatchPipeline([s], [2], D.max_samples, D.n_window, D.hop_length, D.max_frames, seed=0)
    got = []
    with pytest.raises(ValueError, match="cannot decode"):
        for b in bp.iter_epoch(0, prefetch=prefetch):
            got.append(b)
    assert len(got) < len(bp)


class _Silent:
    def get_audio(self, name):
        return np.zeros(441, np.float32)


def test_an_epoch_closed_early_stops_its_worker():
    """A consumer that stops (a failed loss check, say) closes the epoch's
    generator: the worker blocked on the full queue ends and lets its
    batches go."""
    import threading

    codec = LabelCodec(CLASSES, D.max_frames // 8)
    names = [f"c{i}.wav" for i in range(12)]
    s = tpipe.Stream("b", tpipe.dir_manifest(names), _Silent(), codec, D.sample_rate, D.hop_length, 8)
    bp = tpipe.BatchPipeline([s], [1], D.max_samples, D.n_window, D.hop_length, D.max_frames, seed=0)

    def workers():
        return [t for t in threading.enumerate() if t.name == "BatchPipeline.iter_epoch" and t.is_alive()]

    before = len(workers())
    it = bp.iter_epoch(0, prefetch=1)
    next(it)
    assert len(workers()) == before + 1  # the worker waits on the full queue
    it.close()
    assert len(workers()) == before


def test_device_prefetch_on_the_cpu_keeps_order_and_wraps():
    import torch

    batches = [{"audio": np.full((2, 3), i, np.int16), "n": i} for i in range(5)]
    before = tpipe.device_prefetch.batches
    for depth in (1, 2, 8):
        out = list(tpipe.device_prefetch(iter(batches), depth, "cpu"))
        assert [o["n"] for o in out] == list(range(5))
        assert all(isinstance(o["audio"], torch.Tensor) and o["audio"].dtype == torch.int16 for o in out)
        np.testing.assert_array_equal(out[3]["audio"].numpy(), batches[3]["audio"])
    assert tpipe.device_prefetch.batches == before  # it counts copies to a card only
    assert list(tpipe.device_prefetch(iter([]), 2, "cpu")) == []
