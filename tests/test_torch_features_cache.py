"""Port parity: the feature cache (data/features_cache.py) and the
`precompute` command.

On the cases of tests/test_features_cache.py (1 s clips of noise in a wav
directory, some names without a wav): the same cache directory name, the
same files cached and skipped, each cached log-mel (and linear mel under
`--nolog`) within 1e-5 of the max of the JAX package's (K1's CPU bar);
files already cached are not computed again; `NpyFeatureSource` reads
them back; `drop_missing_audio` keeps the same rows. Then
`cli.precompute` on the CPU.
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

from dcase2019_task4_tpu.config import Config as JConfig
from dcase2019_task4_tpu.config import DSPConfig as JDSP
from dcase2019_task4_tpu.data import features_cache as jfc
from dcase2019_task4_tpu.data.audio_io import WavAudioSource as JWavSource
from dcase2019_task4_tpu.data.manifests import manifest_from_df
from dcase2019_task4_tpu_torch import cli
from dcase2019_task4_tpu_torch.config import Config, DSPConfig
from dcase2019_task4_tpu_torch.data import features_cache as tfc
from dcase2019_task4_tpu_torch.data.audio_io import WavAudioSource, write_wav
from dcase2019_task4_tpu_torch.data.manifests import load_manifest, manifest_from_rows, subpart_manifest

JCFG = JConfig(dsp=JDSP(max_len_seconds=1.0))
CFG = Config(dsp=DSPConfig(max_len_seconds=1.0))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def setup_wavs(tmp_path, n=3, missing=0):
    rng = np.random.default_rng(0)
    names = []
    for i in range(n):
        name = f"clip{i}.wav"
        write_wav(str(tmp_path / name), rng.standard_normal(CFG.dsp.max_samples).astype(np.float32) * 0.1, 44100)
        names.append(name)
    names += [f"missing{i}.wav" for i in range(missing)]
    return (manifest_from_df(pd.DataFrame({"filename": names})), JWavSource(str(tmp_path), 44100),
            manifest_from_rows([{"filename": n} for n in names], ["filename"]), WavAudioSource(str(tmp_path), 44100))


def test_cache_dir_name_is_the_jax_packages():
    for log in (True, False):
        assert tfc.cache_dir_name(CFG.dsp, log) == jfc.cache_dir_name(JCFG.dsp, log)
    assert tfc.cache_dir_name(CFG.dsp) == "sr44100_win2048_hop511_mels64"
    assert tfc.cache_dir_name(DSPConfig(n_mels=128), False) == jfc.cache_dir_name(JDSP(n_mels=128), False)


@pytest.mark.parametrize("log, n, missing, batch", [(True, 3, 0, 2), (True, 2, 1, 24), (False, 3, 1, 2)],
                         ids=["log_mel", "a_missing_file", "nolog"])
def test_precompute_matches_jax(tmp_path, log, n, missing, batch):
    jm, jsrc, tm, tsrc = setup_wavs(tmp_path, n, missing)
    theirs = jfc.precompute_features(jm, jsrc, JCFG, str(tmp_path / "jax"), save_log_feature=log, batch_size=batch)
    mine = tfc.precompute_features(tm, tsrc, CFG, str(tmp_path / "port"), save_log_feature=log, batch_size=batch,
                                   device="cpu")
    assert mine == theirs and len(mine) == n
    reader = tfc.NpyFeatureSource(CFG, str(tmp_path / "port"), save_log_feature=log)
    jreader = jfc.NpyFeatureSource(JCFG, str(tmp_path / "jax"), save_log_feature=log)
    assert os.path.relpath(reader.dir, tmp_path / "port") == os.path.relpath(jreader.dir, tmp_path / "jax")
    assert sorted(os.listdir(reader.dir)) == sorted(os.listdir(jreader.dir)) == sorted(
        f"clip{i}.npy" for i in range(n))
    n_frames = 1 + CFG.dsp.max_samples // CFG.dsp.hop_length
    for name in mine:
        got, want = reader.get_features(name), jreader.get_features(name)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (n_frames, 64)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max(), err_msg=name)


def test_files_already_cached_are_not_computed_again(tmp_path, monkeypatch):
    _, _, tm, tsrc = setup_wavs(tmp_path, 3)
    base = str(tmp_path / "port")
    first = tfc.precompute_features(tm, tsrc, CFG, base, batch_size=2, device="cpu")
    path = os.path.join(tfc.NpyFeatureSource(CFG, base).dir, "clip1.npy")
    np.save(path, np.zeros((2, 64), np.float32))
    monkeypatch.setattr(tsrc, "get_audio", lambda name: pytest.fail(f"{name} read again"))
    assert tfc.precompute_features(tm, tsrc, CFG, base, batch_size=2, device="cpu") == first
    assert np.load(path).shape == (2, 64)


def test_drop_missing_audio_is_the_jax_packages(tmp_path):
    jm, jsrc, tm, tsrc = setup_wavs(tmp_path, 2, missing=2)
    mine, theirs = tfc.drop_missing_audio(tm, tsrc), jfc.drop_missing_audio(jm, jsrc)
    assert mine.filenames == list(theirs.filenames) == ["clip0.wav", "clip1.wav"]
    assert tfc.drop_missing_audio(mine, tsrc) is mine


def test_precompute_through_the_cli(tmp_path, monkeypatch):
    _, _, tm, tsrc = setup_wavs(tmp_path, 3, missing=1)
    tsv = tmp_path / "set.tsv"
    tsv.write_text("filename\n" + "".join(f"{n}\n" for n in tm.filenames))
    paths = CFG.paths
    monkeypatch.setattr(type(paths), "audio_dir_for_meta", lambda self, meta: str(tmp_path))
    monkeypatch.setattr(cli, "Config", lambda: CFG)
    feat = str(tmp_path / "features")
    res = cli.precompute(["--sets", str(tsv), "--feature_dir", feat, "--device", "cpu"])
    assert res == {str(tsv): ["clip0.wav", "clip1.wav", "clip2.wav"]}
    want = tfc.precompute_features(tm, tsrc, CFG, str(tmp_path / "direct"), device="cpu")
    for name in want:
        np.testing.assert_array_equal(tfc.NpyFeatureSource(CFG, feat).get_features(name),
                                      tfc.NpyFeatureSource(CFG, str(tmp_path / "direct")).get_features(name))
    res = cli.precompute(["--sets", str(tsv), "-s", "2", "--feature_dir", feat, "--nolog", "--device", "cpu"])
    drawn = [n for n in subpart_manifest(load_manifest(str(tsv)), 2).filenames if not n.startswith("missing")]
    assert res == {str(tsv): drawn}
    assert sorted(os.listdir(tfc.NpyFeatureSource(CFG, feat, save_log_feature=False).dir)) == sorted(
        n.replace(".wav", ".npy") for n in drawn)
