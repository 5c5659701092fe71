"""The port's downloader (dcase2019_task4_tpu_torch/data/download.py) against
the JAX package's (dcase2019_task4_tpu/data/download.py), offline.

Every case of tests/test_download_fetch.py runs against the port with that
file's fake youtube_dl-compatible backend (a deterministic source wave per
video id, a failing id): fetch, crop, resample, 16-bit save, temporary-file
clean-up, per-file fault isolation, skip-existing, the Pool fan-out. Then
`download_sets` of both packages (their Pools run in this process) on one
set TSV whose fetches fail with
error texts that hold a tab, a quote and a line end: the
`missing_files_<set>.tsv` files are byte-equal (the JAX package writes its
own with pandas' `to_csv`, the port with the csv module).
"""

import dataclasses
import multiprocessing
import os

import numpy as np
import pytest

from dcase2019_task4_tpu.config import Config as JaxConfig
from dcase2019_task4_tpu.config import PathsConfig as JaxPathsConfig
from dcase2019_task4_tpu.data import download as jdl
from dcase2019_task4_tpu_torch import cli
from dcase2019_task4_tpu_torch.config import Config, PathsConfig
from dcase2019_task4_tpu_torch.data import download as dl
from dcase2019_task4_tpu_torch.data.audio_io import read_wav, write_wav
from tests import test_download_fetch as fetch

fake_backend = fetch.fake_backend


def test_fetch_crop_save(tmp_path):
    assert dl.download_file("Yabc123_2.0_7.0.wav", str(tmp_path), backend=fake_backend) is None
    audio, sr = read_wav(str(tmp_path / "Yabc123_2.0_7.0.wav"))
    assert sr == 44100 and len(audio) == 5 * 44100
    expected = fetch._source_audio("abc123")[2 * 44100: 7 * 44100]
    np.testing.assert_allclose(audio, expected, atol=4 / 32767)  # two 16-bit quantizations, as there
    assert not any(".src" in f for f in os.listdir(tmp_path))


def test_fetch_resamples_source(tmp_path):
    assert dl.download_file("Ylowsr_1.0_4.0.wav", str(tmp_path), backend=fake_backend) is None
    audio, sr = read_wav(str(tmp_path / "Ylowsr_1.0_4.0.wav"))
    assert sr == 44100 and len(audio) == 3 * 44100


def test_fetch_failure_isolated(tmp_path):
    err = dl.download_file("Yfailme_0.0_5.0.wav", str(tmp_path), backend=fake_backend)
    assert err is not None and "simulated fetch failure" in err
    assert not os.path.exists(tmp_path / "Yfailme_0.0_5.0.wav")
    assert not any(".src" in f for f in os.listdir(tmp_path))


def test_bad_filename_is_an_error_not_a_crash(tmp_path):
    err = dl.download_file("not_audioset.wav", str(tmp_path), backend=fake_backend)
    assert err is not None and "not an AudioSet segment" in err


def test_segment_beyond_source_errors(tmp_path):
    err = dl.download_file("Yabc123_20.0_25.0.wav", str(tmp_path), backend=fake_backend)
    assert err is not None and "beyond source length" in err


def test_skip_existing(tmp_path):
    p = tmp_path / "Yabc123_0.0_1.0.wav"
    write_wav(str(p), np.zeros(10), 44100)
    before = p.stat().st_mtime_ns
    assert dl.download_file("Yabc123_0.0_1.0.wav", str(tmp_path), backend=fake_backend) is None
    assert p.stat().st_mtime_ns == before


def test_parse_and_no_backend(tmp_path, monkeypatch):
    assert dl.parse_audioset_filename("Y-x_y_1.5_11.0.wav") == jdl.parse_audioset_filename("Y-x_y_1.5_11.0.wav")
    monkeypatch.setattr(dl, "_backend", lambda: None)
    assert dl.download_file("Yabc_0.0_1.0.wav", str(tmp_path)) == \
        "no downloader backend (youtube_dl/yt_dlp not installed)"
    assert dl.download(["Yabc_0.0_1.0.wav"], str(tmp_path)) == [("Yabc_0.0_1.0.wav", "no downloader backend")]


class _InProcessPool:
    """multiprocessing.Pool's starmap in this process: the manifest cases
    below need the failures, not another fan-out (the test above has it)."""

    def __init__(self, n_jobs):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def starmap(self, fn, args, chunksize=1):
        return [fn(*a) for a in args]


class _Unquotable:
    """A backend whose every fetch fails with a text csv must quote."""

    class YoutubeDL(fetch.FakeYoutubeDL):
        def download(self, urls):
            ytid = urls[0].split("v=")[1]
            raise RuntimeError({"tab": "video\tunavailable", "quote": 'the "uploader" removed it',
                                "line": "first\nsecond"}.get(ytid, f"plain {ytid}"))


@pytest.mark.skipif(multiprocessing.get_start_method() != "fork",
                    reason="the Pool workers inherit the patched backend by fork, as in test_download_fetch.py")
def test_download_pool_manifest(tmp_path, monkeypatch):
    monkeypatch.setattr(dl, "_backend", lambda: fake_backend)
    files = ["Yaaa_0.0_3.0.wav", "Ybbb_1.0_2.0.wav", "Yfailme_0.0_5.0.wav"]
    missing = dl.download(files, str(tmp_path), n_jobs=2, chunk_size=1)
    assert sorted(os.listdir(tmp_path)) == ["Yaaa_0.0_3.0.wav", "Ybbb_1.0_2.0.wav"]
    assert [f for f, _ in missing] == ["Yfailme_0.0_5.0.wav"]
    assert "simulated fetch failure" in missing[0][1]
    missing2 = dl.download(files, str(tmp_path), n_jobs=2, chunk_size=1)
    assert [f for f, _ in missing2] == ["Yfailme_0.0_5.0.wav"]

    # the sets' manifests, through both packages and the port's CLI command
    for module in (dl, jdl):
        monkeypatch.setattr(module, "_backend", lambda: _Unquotable)
        monkeypatch.setattr(module.multiprocessing, "Pool", _InProcessPool)
    meta = tmp_path / "meta" / "validation"
    meta.mkdir(parents=True)
    tsv = meta / "validation.tsv"
    names = ["Ytab_0.0_1.0.wav", "Yquote_0.0_1.0.wav", "Yline_0.0_1.0.wav", "Yok_0.0_1.0.wav"]
    tsv.write_text("filename\tonset\toffset\tevent_label\n"
                   + "".join(f"{n}\t0.0\t1.0\tSpeech\n" for n in names + names[:1]))
    out = {}
    for tag, cfg_type, paths_type, module in (("jax", JaxConfig, JaxPathsConfig, jdl),
                                              ("port", Config, PathsConfig, dl)):
        paths = paths_type(metadata_dir=str(tmp_path / "meta"), audio_dir=str(tmp_path / f"audio_{tag}"))
        cfg = dataclasses.replace(cfg_type(), paths=paths)
        result = module.download_sets(cfg, [str(tsv)], n_jobs=2, chunk_size=1)
        out[tag] = (result["validation"], (tmp_path / f"audio_{tag}" / "missing_files_validation.tsv").read_bytes())
    assert out["port"][1] == out["jax"][1]
    assert out["port"][0] == list(out["jax"][0].itertuples(index=False, name=None))
    assert b'\t"RuntimeError: video\tunavailable"\n' in out["port"][1] and b'""uploader""' in out["port"][1]

    monkeypatch.setattr(cli, "Config", lambda: dataclasses.replace(
        Config(), paths=PathsConfig(metadata_dir=str(tmp_path / "meta"), audio_dir=str(tmp_path / "audio_cli"))))
    result = cli.download(["--sets", str(tsv), "--n_jobs", "2", "--chunk_size", "1"])
    assert result["validation"] == out["port"][0]
    assert (tmp_path / "audio_cli" / "missing_files_validation.tsv").read_bytes() == out["port"][1]
