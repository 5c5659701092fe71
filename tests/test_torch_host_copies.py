"""The port's own copies of the host modules against their originals.

The port imports nothing of dcase2019_task4_tpu; it keeps copies of the
host-side modules it needs (config, logger, scaler, label codec, audio IO,
the native wav packer). Each copy is held to its original here on seeded
numpy inputs: equal outputs, bit for bit where the arithmetic is the same.
"""

import dataclasses
import importlib.util
import os
import shutil
import subprocess
import sysconfig

import numpy as np
import pytest

from dcase2019_task4_tpu import config as jconfig
from dcase2019_task4_tpu import native as jnative
from dcase2019_task4_tpu.data import audio_io as jaudio
from dcase2019_task4_tpu.data import encoder as jencoder
from dcase2019_task4_tpu.data import transforms as jtransforms
from dcase2019_task4_tpu.utils import logger as jlogger
from dcase2019_task4_tpu.utils import scaler as jscaler
from dcase2019_task4_tpu_torch import config as tconfig
from dcase2019_task4_tpu_torch import native as tnative
from dcase2019_task4_tpu_torch.data import audio_io as taudio
from dcase2019_task4_tpu_torch.data import encoder as tencoder
from dcase2019_task4_tpu_torch.data import transforms as ttransforms
from dcase2019_task4_tpu_torch.utils import logger as tlogger
from dcase2019_task4_tpu_torch.utils import scaler as tscaler

CLASSES = jconfig.DEFAULT_CLASSES


def _events(rng, n):
    out = []
    for _ in range(n):
        on = float(rng.uniform(0, 8))
        out.append((int(rng.integers(0, len(CLASSES))), on, on + float(rng.uniform(0.3, 10 - on))))
    return out


def test_the_copies_are_separate_modules():
    for mine, theirs in ((tconfig, jconfig), (tnative, jnative), (taudio, jaudio), (tencoder, jencoder),
                         (tlogger, jlogger), (tscaler, jscaler), (ttransforms, jtransforms)):
        assert mine.__file__ != theirs.__file__
        assert "dcase2019_task4_tpu_torch" in mine.__file__


def test_transforms_are_the_original_code():
    """data/transforms.py is framework-free: the copy is the original's
    code under its own docstring (tests/test_torch_transforms.py holds
    each transform to the original's outputs bit for bit)."""
    def body(module):
        with open(module.__file__) as f:
            text = f.read()
        return text[text.index('"""', 3) + 3:]

    assert body(ttransforms) == body(jtransforms)


@pytest.mark.parametrize("make", ["Config", "scaled_config"])
def test_config_equal_field_for_field(make):
    mine, theirs = getattr(tconfig, make)(), getattr(jconfig, make)()
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert [f.name for f in dataclasses.fields(mine.model)] == [f.name for f in dataclasses.fields(theirs.model)]
    assert mine.dsp.max_frames == theirs.dsp.max_frames == 864
    assert mine.dsp.max_samples == theirs.dsp.max_samples
    assert mine.model.pooling_time_ratio == theirs.model.pooling_time_ratio == 8
    assert tconfig.DEFAULT_CLASSES == jconfig.DEFAULT_CLASSES


def test_config_classes_and_paths_without_pandas():
    mine, theirs = tconfig.Config(), jconfig.Config()
    assert mine.classes == theirs.classes == CLASSES
    for name in ("weak", "unlabel", "synthetic", "validation", "test2018", "eval2018", "eval_desed"):
        assert getattr(mine.paths, name) == getattr(theirs.paths, name)
    assert mine.paths.audio_dir_for_meta(mine.paths.validation) == theirs.paths.audio_dir_for_meta(theirs.paths.validation)
    assert mine.with_classes(("a", "b")).classes == ("a", "b")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_label_codec_encode_decode_state(seed):
    rng = np.random.default_rng(seed)
    mine, theirs = tencoder.LabelCodec(CLASSES, 108), jencoder.LabelCodec(CLASSES, 108)
    labels = [CLASSES[i] for i in rng.choice(len(CLASSES), 3, replace=False)]
    np.testing.assert_array_equal(mine.encode_weak(labels), theirs.encode_weak(labels))
    np.testing.assert_array_equal(mine.encode_weak("empty"), theirs.encode_weak("empty"))
    np.testing.assert_array_equal(mine.encode_strong(labels), theirs.encode_strong(labels))
    np.testing.assert_array_equal(mine.encode_strong("empty"), theirs.encode_strong("empty"))
    events = [(CLASSES[c], int(on * 10), int(off * 10)) for c, on, off in _events(rng, 4)]
    grid = mine.encode_strong(events)
    np.testing.assert_array_equal(grid, theirs.encode_strong(events))
    assert mine.decode_strong(grid) == theirs.decode_strong(grid)
    grids = (rng.random((3, 108, len(CLASSES))) > 0.7).astype(np.float32)
    assert mine.decode_strong_batch(grids) == theirs.decode_strong_batch(grids)
    assert mine.decode_weak(mine.encode_weak(labels)) == theirs.decode_weak(theirs.encode_weak(labels))
    assert mine.state_dict() == theirs.state_dict()
    assert tencoder.LabelCodec.load_state_dict(theirs.state_dict()).state_dict() == mine.state_dict()
    on, off = rng.uniform(0, 5, 6), rng.uniform(5, 10, 6)
    for a, b in zip(tencoder.events_to_frames(on, off, 44100, 511, 8), jencoder.events_to_frames(on, off, 44100, 511, 8)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tencoder.frames_to_seconds(np.arange(20), 44100, 511, 8),
                                  jencoder.frames_to_seconds(np.arange(20), 44100, 511, 8))


def test_scaler_state_round_trip_and_mean_std():
    rng = np.random.default_rng(3)
    mean = rng.standard_normal(64)
    state = {"mean_": mean.tolist(), "mean_of_square_": (mean ** 2 + 0.5 + rng.random(64) * 3).tolist()}
    mine, theirs = tscaler.Scaler().load_state_dict(state), jscaler.Scaler().load_state_dict(state)
    assert mine.state_dict() == theirs.state_dict() == state
    for a, b in zip(mine.mean_std_f32, theirs.mean_std_f32):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    x = rng.standard_normal((3, 20, 64)).astype(np.float32)
    np.testing.assert_array_equal(mine.normalize(x), theirs.normalize(x))


@pytest.mark.parametrize("variability", [0.0, 0.7])
def test_synth_clip_bit_equal(variability):
    rng = np.random.default_rng(4)
    for i in range(3):
        events = _events(rng, 2)
        a = taudio.synth_clip(f"clip_{i}.wav", events, 1.5, 44100, variability=variability)
        b = jaudio.synth_clip(f"clip_{i}.wav", events, 1.5, 44100, variability=variability)
        np.testing.assert_array_equal(a, b)


def test_write_wav_and_wav_source_round_trip(tmp_path):
    rng = np.random.default_rng(5)
    audio = np.clip(taudio.synth_clip("a.wav", _events(rng, 2), 1.0, 44100), -1, 1)
    taudio.write_wav(str(tmp_path / "mine.wav"), audio, 44100)
    jaudio.write_wav(str(tmp_path / "theirs.wav"), audio, 44100)
    assert (tmp_path / "mine.wav").read_bytes() == (tmp_path / "theirs.wav").read_bytes()
    mine, theirs = taudio.WavAudioSource(str(tmp_path), 44100), jaudio.WavAudioSource(str(tmp_path), 44100)
    got = mine.get_audio("mine.wav")
    np.testing.assert_array_equal(got, theirs.get_audio("mine.wav"))
    np.testing.assert_allclose(got, audio, rtol=0, atol=2.0 / 32768)  # 16-bit PCM, scaled by 32767
    assert mine.path_for("mine.wav") == theirs.path_for("mine.wav")


def test_logger_contract():
    log = tlogger.get_logger("torch_host_copy_test")
    assert log is tlogger.get_logger("torch_host_copy_test")
    assert len(log.handlers) == len(jlogger.get_logger("jax_host_copy_test").handlers)


def _original_packer(tmp_path):
    """The JAX package's wavpack.cpp built by this test alone, with its
    loader's own flags, into `tmp_path` (written under a temporary name and
    renamed into place), and loaded: the package's shared `_wavpack.so`
    next to its source is rebuilt in place by whichever process finds it
    stale, so a test worker that loads it may read a half-written file."""
    so = str(tmp_path / "_wavpack.so")
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", f"-I{sysconfig.get_paths()['include']}",
                    jnative._SRC, "-o", so + ".tmp"], check=True, capture_output=True, timeout=120)
    os.replace(so + ".tmp", so)
    spec = importlib.util.spec_from_file_location("_wavpack", so)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_native_packer_equals_the_original(tmp_path, monkeypatch):
    if shutil.which("g++") is None:
        # the documented host-side behaviour: no toolchain, no native packer
        assert not tnative.available()
        return
    monkeypatch.setattr(jnative, "_module", _original_packer(tmp_path))
    monkeypatch.setattr(jnative, "_tried", True)
    assert tnative.available() and jnative.available()
    assert "build" in tnative._SO and tnative._SO != jnative._SO
    rng = np.random.default_rng(6)
    paths = []
    for i, seconds in enumerate((1.0, 0.4, 1.3)):
        audio = np.clip(taudio.synth_clip(f"n{i}.wav", _events(rng, 2), seconds, 44100), -1, 1)
        paths.append(str(tmp_path / f"n{i}.wav"))
        taudio.write_wav(paths[-1], audio, 44100)
    mine = tnative.pack_batch(paths, 44100, 2048, 511, 44100)
    theirs = jnative.pack_batch(paths, 44100, 2048, 511, 44100)
    np.testing.assert_array_equal(mine[0], theirs[0])
    np.testing.assert_array_equal(mine[1], theirs[1])
    assert list(mine[2]) == list(theirs[2]) == ["", "", ""]
    a, sr, err = tnative.decode_wav(paths[0], 44100)
    b, sr2, err2 = jnative.decode_wav(paths[0], 44100)
    np.testing.assert_array_equal(a, b)
    assert (sr, err) == (sr2, err2)


@pytest.mark.parametrize("comp", ["sup", "inf"])
def test_meters_save_best_and_early_stopping(comp):
    from dcase2019_task4_tpu.utils import meters as jmeters
    from dcase2019_task4_tpu_torch.utils import meters as tmeters

    values = np.random.default_rng(6).random(12).round(2).tolist() + [0.5, 0.5, 0.5, 0.5]
    mine, theirs = tmeters.SaveBest(comp), jmeters.SaveBest(comp)
    stop_m, stop_t = tmeters.EarlyStopping(2, comp), jmeters.EarlyStopping(2, comp)
    for v in values:
        assert mine.apply(v) == theirs.apply(v)
        assert stop_m.apply(v) == stop_t.apply(v)
        assert (mine.best_val, mine.best_epoch, stop_m.best_epoch) == (theirs.best_val, theirs.best_epoch,
                                                                      stop_t.best_epoch)
    a, b = tmeters.AverageMeterSet(), jmeters.AverageMeterSet()
    for i, v in enumerate(values):
        for m in (a, b):
            m.update("loss", v, i + 1)
            m.update("tiny", v * 1e-3)
    assert a.averages() == b.averages() and a.averages("") == b.averages("") and str(a) == str(b)
    with pytest.raises(ValueError):
        tmeters.SaveBest("max")


def test_metrics_writer_round_trip(tmp_path):
    from dcase2019_task4_tpu.utils import metrics_writer as jwriter
    from dcase2019_task4_tpu_torch.utils import metrics_writer as twriter

    record = {"epoch": np.int64(3), "loss": np.float32(0.25), "f1": np.array([0.5, 1.0]), "best": True}
    for mod, name in ((twriter, "mine.jsonl"), (jwriter, "theirs.jsonl")):
        with mod.MetricsWriter(str(tmp_path / name)) as w:
            w.write(record)
            w.write({"epoch": 4})
        mod.MetricsWriter(None).write(record)  # no path: writes nothing
    mine, theirs = twriter.read_metrics(str(tmp_path / "mine.jsonl")), jwriter.read_metrics(str(tmp_path / "theirs.jsonl"))
    for a, b in zip(mine, theirs):
        a.pop("ts"), b.pop("ts")
        assert a == b
    assert mine[0] == {"epoch": 3, "loss": 0.25, "f1": [0.5, 1.0], "best": True}


def test_drop_missing_audio(tmp_path):
    from dcase2019_task4_tpu.data import features_cache as jcache
    from dcase2019_task4_tpu.data import manifests as jman
    from dcase2019_task4_tpu_torch.data import features_cache as tcache
    from dcase2019_task4_tpu_torch.data import manifests as tman

    tsv = tmp_path / "weak.tsv"
    tsv.write_text("filename\tevent_labels\na.wav\tDog\nb.wav\tCat,Dog\nc.wav\t\n")
    taudio.write_wav(str(tmp_path / "a.wav"), np.zeros(100, np.float32), 44100)
    taudio.write_wav(str(tmp_path / "c.wav"), np.zeros(100, np.float32), 44100)
    mine = tcache.drop_missing_audio(tman.load_manifest(str(tsv)), taudio.WavAudioSource(str(tmp_path)))
    theirs = jcache.drop_missing_audio(jman.load_manifest(str(tsv)), jaudio.WavAudioSource(str(tmp_path)))
    assert mine.filenames == theirs.filenames == ["a.wav", "c.wav"]
    assert mine.weak_labels == theirs.weak_labels == [["Dog"], []]
    whole = tman.load_manifest(str(tsv))
    (tmp_path / "b.wav").write_bytes((tmp_path / "a.wav").read_bytes())
    assert tcache.drop_missing_audio(whole, taudio.WavAudioSource(str(tmp_path))) is whole
