"""Port parity: the device-resident training epoch (`--device_cache`).

At the tiny geometry of tests/test_device_cache.py (1 s clips, filters
(16, 16, 16), GRU 16, batch 8 = [2 | 4 | 2], `subpart_data=12`, synthetic
audio with variability 1):

  * the resident rows against the JAX package's DeviceResidentData built
    over the same streams: data, offsets and n_real bit for bit, with and
    without a second (paired) view; `epoch_indices` equal for epochs 0
    and 1; the size guard raises at 1 KiB; inside a process group of more
    than one process it raises, naming ROADMAP Queue 1 item 6;
  * resident against streamed in the port: two epochs of the Mean-Teacher
    run with dropout 0.3 and teacher noise on, every batch the step
    received equal bit for bit, every epoch metric within 1e-5 (the bar of
    tests/test_device_cache.py), `validate` after a resident epoch;
  * resident against JAX's resident Experiment: dropout 0 and noise 0, the
    JAX initial state crossing by checkpoint as in
    tests/test_torch_experiment.py, the scaler moments of the two resident
    fits within 1e-5 of their largest, every per-epoch loss within 2e-4;
  * `train_crnn --device_cache` through the CLI on the CPU.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from dcase2019_task4_tpu.config import Config as JConfig
from dcase2019_task4_tpu.config import DSPConfig as JDSP
from dcase2019_task4_tpu.config import ModelConfig as JModel
from dcase2019_task4_tpu.config import TrainConfig as JTrain
from dcase2019_task4_tpu.data import audio_io as jaudio
from dcase2019_task4_tpu.data import manifests as jman
from dcase2019_task4_tpu.data import pipeline as jpipe
from dcase2019_task4_tpu.data.encoder import LabelCodec as JCodec
from dcase2019_task4_tpu.train import checkpoints as jckpt
from dcase2019_task4_tpu.train.experiment import Experiment as JExperiment
from dcase2019_task4_tpu_torch import cli
from dcase2019_task4_tpu_torch.config import Config, DSPConfig, ModelConfig, TrainConfig
from dcase2019_task4_tpu_torch.data import audio_io as taudio
from dcase2019_task4_tpu_torch.data import manifests as tman
from dcase2019_task4_tpu_torch.data import pipeline as tpipe
from dcase2019_task4_tpu_torch.data.encoder import LabelCodec
from dcase2019_task4_tpu_torch.parallel.mesh import Mesh
from dcase2019_task4_tpu_torch.train import steps as tsteps
from dcase2019_task4_tpu_torch.train.experiment import Experiment
from dcase2019_task4_tpu_torch.utils.metrics_writer import read_metrics

LOSS_TOL = 2e-4


def tiny(C, D, M, T, dropout=0.3, noise_std=0.25, n_epoch=2):
    return C(dsp=D(max_len_seconds=1.0), model=M(nclass=10, nb_filters=(16, 16, 16), n_rnn_cell=16, dropout=dropout),
             train=T(batch_size=8, n_epoch=n_epoch, num_prefetch=1, noise_std=noise_std))


TINY = tiny(Config, DSPConfig, ModelConfig, TrainConfig)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for torch: the suite runs several workers on the
    machine's cores, and tiny CPU steps only lose to thread contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pipelines(paired: bool, subpart: int = 12):
    """The Mean-Teacher training streams of `subpart_data` in both
    packages, built the same way, with a second view when `paired`."""
    d, t, p = TINY.dsp, TINY.train, TINY.paths
    classes = list(TINY.classes)
    out = []
    for man, audio, pipe, codec in ((jman, jaudio, jpipe, JCodec), (tman, taudio, tpipe, LabelCodec)):
        codec = codec(classes, n_frames=d.max_frames // 8)
        streams = []
        for name, tsv in (("weak", p.weak), ("unlabeled", p.unlabel), ("synthetic", p.synthetic)):
            m = man.subpart_manifest(man.load_manifest(tsv), subpart, t.subpart_seed)
            if name == "weak":
                m = man.split_weak(m, 1 - t.valid_fraction, t.split_seed)[0]
            elif name == "synthetic":
                m = man.split_synthetic(m, 1 - t.valid_fraction, t.split_seed)[0]
            src = [audio.SyntheticAudioSource(m, classes, d.sample_rate, d.max_len_seconds, variability=1.0,
                                              seed_salt=salt) for salt in ("desed-synth", "desed-synth/v2")]
            streams.append(pipe.Stream(name, m, src[0], codec, d.sample_rate, d.hop_length, 8,
                                       source2=src[1] if paired else None))
        out.append(pipe.BatchPipeline(streams, [2, 4, 2], d.max_samples, d.n_window, d.hop_length, d.max_frames))
    return out


@pytest.mark.parametrize("paired, subpart", [(False, 12), (False, 13), (True, 13)],
                         ids=["one_view_32_rows", "one_view_padded", "paired_views_padded"])
def test_resident_rows_are_the_jax_packages(paired, subpart):
    jp, tp = pipelines(paired, subpart)
    theirs, mine = jpipe.DeviceResidentData(jp), tpipe.DeviceResidentData(tp, "cpu")
    assert sorted(mine.data) == sorted(theirs.data) == sorted(["audio", "frames", "target"]
                                                             + (["audio2"] if paired else []))
    for k, v in theirs.data.items():
        want = np.asarray(v)
        got = mine.data[k].numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    assert mine.n_real == theirs.n_real and mine.nbytes == theirs.nbytes
    rows = mine.data["audio"].shape[0]
    assert rows % 8 == 0 and rows - mine.n_real == (7 if subpart == 13 else 0)
    np.testing.assert_array_equal(mine.offsets, theirs.offsets)
    for epoch in (0, 1):
        want = theirs.epoch_indices(jp.sampler, epoch)
        got = mine.epoch_indices(tp.sampler, epoch)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_the_size_guard_and_the_sharded_branch_raise():
    _, tp = pipelines(False)
    with pytest.raises(ValueError, match="GiB"):
        tpipe.DeviceResidentData(tp, "cpu", max_bytes=1024)
    # data parallel is ported: under a mesh of one process a card the rows
    # stay whole on each card and a rank gathers its cut; only a multi-host
    # mesh raises, as the JAX package refuses several processes
    # (tests/test_torch_parallel_experiment.py runs the group itself)
    mesh = Mesh(None, None, 0, 2, torch.device("cpu"), "gloo", multihost=True)
    with pytest.raises(ValueError, match="multi-host"):
        tpipe.DeviceResidentData(tp, "cpu", mesh=mesh)
    dd = tpipe.DeviceResidentData(tp, "cpu", mesh=dataclasses.replace(mesh, multihost=False))
    assert dd.n_real == sum(len(s) for s in tp.streams)


@pytest.fixture(scope="module")
def twins():
    """Streamed and resident port Experiments, two epochs each, with every
    batch a step received recorded."""
    received = []
    real = tsteps.TrainStep.__call__

    def call(self, state, batch, generator, acc):
        received.append({k: v.numpy().copy() for k, v in batch.items()})
        return real(self, state, batch, generator, acc)

    mp = pytest.MonkeyPatch()
    mp.setattr(tsteps.TrainStep, "__call__", call)
    exps, batches, meters = {}, {}, {}
    for cache in (False, True):
        exp = Experiment(TINY, mean_teacher=True, subpart_data=12, synthetic_audio=True, synthetic_variability=1.0,
                         seed=0, device="cpu", device_cache=cache).build()
        received.clear()
        meters[cache] = [exp.train_epoch(epoch) for epoch in range(2)]
        exps[cache], batches[cache] = exp, list(received)
    mp.undo()
    return exps, batches, meters


def test_each_resident_batch_is_the_streamed_batch_bit_for_bit(twins):
    exps, batches, _ = twins
    assert len(batches[True]) == len(batches[False]) == 2 * len(exps[False].pipeline) == 6
    for streamed, resident in zip(batches[False], batches[True]):
        assert sorted(resident) == sorted(streamed) == ["audio", "frames", "target"]
        for k in streamed:
            assert resident[k].dtype == streamed[k].dtype, k
            np.testing.assert_array_equal(resident[k], streamed[k], err_msg=k)


def test_epoch_metrics_match_the_streamed_run(twins):
    exps, _, meters = twins
    for epoch, (m_s, m_r) in enumerate(zip(meters[False], meters[True])):
        assert sorted(m_r.meters) == sorted(m_s.meters) and len(m_s.meters) == 8
        for k, meter in m_s.meters.items():
            assert m_r.meters[k].avg == pytest.approx(meter.avg, abs=1e-5), (epoch, k)
    resident = exps[True]
    assert [s["queue_wait_s"] for s in resident.epoch_stats] == [0.0, 0.0]
    assert [s["steps"] for s in resident.epoch_stats] == [3, 3]
    assert resident.state.step == exps[False].state.step == 6


def test_validate_works_after_a_resident_epoch(twins):
    exps, _, _ = twins
    metrics = exps[True].validate(1)
    assert 0.0 <= metrics["event_macro_f1"] <= 1.0
    assert 0.0 <= metrics["weak_macro_f1"] <= 1.0


@pytest.fixture(scope="module")
def against_jax(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("resident")
    kw = dict(dropout=0.0, noise_std=0.0)
    jexp = JExperiment(tiny(JConfig, JDSP, JModel, JTrain, **kw), mean_teacher=True, subpart_data=12,
                       synthetic_audio=True, seed=0, device_cache=True)
    jexp.build()
    texp = Experiment(tiny(Config, DSPConfig, ModelConfig, TrainConfig, **kw), mean_teacher=True, subpart_data=12,
                      synthetic_audio=True, seed=0, device="cpu", device_cache=True)
    texp.build()
    fitted = {k: (np.array(getattr(jexp.scaler, k)), np.array(getattr(texp.scaler, k)))
              for k in ("mean_", "mean_of_square_")}
    init = str(tmp / "jax_init.npz")
    jckpt.save_checkpoint(init, jexp.state, jexp.checkpoint_metadata(-1, {}))
    texp.restore(init)
    means = [(jexp.train_epoch(e).averages(""), texp.train_epoch(e).averages("")) for e in range(2)]
    return {"fitted": fitted, "means": means, "texp": texp}


def test_the_resident_scaler_fits_agree(against_jax):
    for key, (theirs, mine) in against_jax["fitted"].items():
        assert mine.shape == theirs.shape == (64,)
        np.testing.assert_allclose(mine, theirs, rtol=0, atol=1e-5 * np.abs(theirs).max(), err_msg=key)


def test_every_resident_epoch_loss_within_the_bar_of_jax(against_jax):
    assert len(against_jax["means"]) == 2
    for epoch, (theirs, mine) in enumerate(against_jax["means"]):
        assert sorted(mine) == sorted(theirs) and len(theirs) == 8
        for k in theirs:
            assert abs(mine[k] - theirs[k]) <= LOSS_TOL, (epoch, k, mine[k], theirs[k])
    assert against_jax["texp"].epoch_stats[-1]["queue_wait_s"] == 0.0


def test_train_crnn_device_cache_through_the_cli(tmp_path, monkeypatch):
    seen = []
    run = Experiment.run

    def recorded(self, *args, **kwargs):
        seen.append(self)
        return run(self, *args, **kwargs)

    monkeypatch.setattr(Experiment, "run", recorded)
    monkeypatch.setattr(cli, "Config", lambda: dataclasses.replace(TINY, train=dataclasses.replace(TINY.train,
                                                                                                   n_epoch=1)))
    store = str(tmp_path / "crnn")
    assert cli.main(["train_crnn", "--synthetic_audio", "-s", "12", "--epochs", "1", "--store_dir", store,
                     "--device", "cpu", "--device_cache"]) == 0
    exp = seen[0]
    assert exp.device_cache and exp._device_data is not None
    assert exp._device_data.n_real == sum(len(s) for s in exp.pipeline.streams)
    (record,) = read_metrics(os.path.join(store, "metrics.jsonl"))
    assert np.isfinite(record["loss"]) and record["loss"] > 0
    assert record["queue_wait_share"] == 0.0 and record["steps_per_s"] > 0
    for k in ("weak_class_loss", "strong_class_loss", "event_macro_f1", "weak_macro_f1", "saved_best"):
        assert k in record, k
    assert os.path.exists(os.path.join(store, "model", "baseline_best"))


def test_the_ramped_adam_schedule_is_set_before_each_resident_step():
    """`--ramped_adam` sets the optimizer's hyperparameters before every
    step; the resident epoch does it as the streamed loop does: the same
    metrics within 1e-5, the same learning rate after the epoch, and that
    rate the schedule's at the last step."""
    cfg = dataclasses.replace(TINY, train=dataclasses.replace(TINY.train, n_epoch=1))
    runs = {}
    for cache in (False, True):
        exp = Experiment(cfg, mean_teacher=False, subpart_data=12, synthetic_audio=True, seed=0, device="cpu",
                         ramped_adam=True, device_cache=cache).build()
        meters = exp.train_epoch(0)
        runs[cache] = (meters, [g["lr"] for g in exp.state.optimizer.param_groups], exp.state.step)
        exp._set_step(exp.state.step - 1)  # the schedule the last step was taken with
        assert [g["lr"] for g in exp.state.optimizer.param_groups] == runs[cache][1], cache
    (m_s, lr_s, step_s), (m_r, lr_r, step_r) = runs[False], runs[True]
    assert step_s == step_r > 0 and lr_r == lr_s and 0 < lr_r[0] < cfg.train.lr
    for k, meter in m_s.meters.items():
        assert m_r.meters[k].avg == pytest.approx(meter.avg, abs=1e-5), k
