"""Port parity: the data-parallel Experiment, `--device_cache` under a group
and `evaluate --data_parallel`, on two Gloo ranks.

The tiny Mean-Teacher run of tests/test_torch_experiment.py (1 s clips,
filters (16, 16, 16), GRU 16, `subpart_data=12`, synthetic audio, dropout
and noise 0) with a rank's batch of 4 = [1 | 2 | 1], so the global batch is
8. Three runs start from one state, the JAX Experiment's initial
checkpoint (weights and scaler): the port on two ranks
(tests/torch_parallel_ranks.py, spawned once for the module, a `file://`
store under tmp_path), the port in one process with the batch of 8, and
the JAX Experiment over a 2-device mesh with its per-device batch of 4.
The ranks' draws differ from the single process's only in distribution;
at dropout and noise 0 they change no number.

Held: every epoch's loss means within 2e-4 of both; the validation F1s
and the epoch saved as best equal; every rank logs the same validation
numbers and scores its own half of the files; rank 0 alone writes
metrics.jsonl and the checkpoints. The resident rows gather, batch for
batch, the bits of the streamed cut. `evaluate`, `predict` (with the weak
tags) and `predict --long --overlap` with `--data_parallel` on the two
ranks return the single-process results and write its TSVs.
"""

import dataclasses
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from dcase2019_task4_tpu.config import Config as JConfig
from dcase2019_task4_tpu.config import DSPConfig as JDSP
from dcase2019_task4_tpu.config import ModelConfig as JModel
from dcase2019_task4_tpu.config import TrainConfig as JTrain
from dcase2019_task4_tpu.parallel.mesh import make_mesh as jax_mesh
from dcase2019_task4_tpu.train import checkpoints as jckpt
from dcase2019_task4_tpu.train.experiment import Experiment as JExperiment
from dcase2019_task4_tpu_torch import cli
from dcase2019_task4_tpu_torch.config import Config, DSPConfig, ModelConfig, TrainConfig
from dcase2019_task4_tpu_torch.data import pipeline as tpipe
from dcase2019_task4_tpu_torch.data.manifests import load_manifest, subpart_manifest
from dcase2019_task4_tpu_torch.parallel.mesh import Mesh
from dcase2019_task4_tpu_torch.train.experiment import Experiment
from dcase2019_task4_tpu_torch.utils.metrics_writer import read_metrics

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_parallel_ranks import spawn  # noqa: E402

LOSS_TOL = 2e-4
RANK_BATCH, SUBPART = 4, 12


def tiny(C, D, M, T, batch):
    return C(dsp=D(max_len_seconds=1.0), model=M(nclass=10, nb_filters=(16, 16, 16), n_rnn_cell=16, dropout=0.0),
             train=T(batch_size=batch, n_epoch=1, num_prefetch=1, noise_std=0.0))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def commands(best, tmp, who):
    """The evaluate, predict and long-predict argument lists, writing under
    `tmp` with `who` in the file names."""
    tsv, common = Config().paths.validation, ["-m", str(best), "--synthetic_audio", "-s", str(SUBPART)]
    return {"evaluate": common + ["--sets", tsv, "-p", str(tmp / f"{who}_eval.tsv")],
            "predict": common + ["-i", tsv, "-p", str(tmp / f"{who}_predict.tsv"), "--weak_fname",
                                 str(tmp / f"{who}_weak.tsv")],
            "predict_long": common + ["-i", tsv, "-p", str(tmp / f"{who}_long.tsv"), "--long", "--overlap"]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_experiment")
    jexp = JExperiment(tiny(JConfig, JDSP, JModel, JTrain, RANK_BATCH), mean_teacher=True, subpart_data=SUBPART,
                       synthetic_audio=True, seed=0, mesh=jax_mesh(jax.devices()[:2]))
    jexp.build()
    init = str(tmp / "jax_init.npz")
    jckpt.save_checkpoint(init, jexp.state, jexp.checkpoint_metadata(-1, {}))
    store = tmp / "ranks"
    wait = spawn("experiment", tmp, args=json.dumps({
        "init": init, "store": str(store), "batch": RANK_BATCH, "subpart": SUBPART,
        **commands(store / "model" / "baseline_best", tmp, "ranks")}))
    texp = Experiment(tiny(Config, DSPConfig, ModelConfig, TrainConfig, 2 * RANK_BATCH), mean_teacher=True,
                      subpart_data=SUBPART, synthetic_audio=True, seed=0, device="cpu").build()
    texp.restore(init)
    texp.run(store_dir=str(tmp / "port"), n_epoch=2)
    jexp.run(store_dir=str(tmp / "jax"), n_epoch=2)
    ranks = wait()
    single = {command: (cli.evaluate if command == "evaluate" else cli.predict)(argv + ["--device", "cpu"])
              for command, argv in commands(store / "model" / "baseline_best", tmp, "single").items()}
    return {"ranks": ranks, "texp": texp, "tmp": tmp, "store": store, "single": single,
            "jax": read_metrics(str(tmp / "jax" / "metrics.jsonl")),
            "port": read_metrics(str(tmp / "port" / "metrics.jsonl")),
            "dp": read_metrics(str(store / "metrics.jsonl"))}


def test_two_ranks_train_as_one_process_and_the_jax_mesh(runs):
    r0, _ = runs["ranks"]
    assert r0["n_steps"] == len(runs["texp"].pipeline) == 3
    assert r0["slices"] == (slice(0, 1), slice(3, 4))  # a rank's [1 | 2 | 1]
    assert len(runs["dp"]) == len(runs["port"]) == len(runs["jax"]) == 2
    for dp, port, theirs in zip(runs["dp"], runs["port"], runs["jax"]):
        losses = [k for k in theirs if "loss" in k or k.startswith("consistency_")]
        assert len(losses) == 8
        for k in losses:
            assert abs(dp[k] - port[k]) <= LOSS_TOL, (dp["epoch"], k, dp[k], port[k])
            assert abs(dp[k] - theirs[k]) <= LOSS_TOL, (dp["epoch"], k, dp[k], theirs[k])
        for k in ("event_macro_f1", "weak_macro_f1", "global_valid", "saved_best"):
            assert dp[k] == port[k] == theirs[k], (dp["epoch"], k, dp[k], port[k], theirs[k])


def test_every_rank_logs_the_same_numbers_and_scores_its_own_files(runs):
    r0, r1 = runs["ranks"]
    assert r0["valid"] == r1["valid"] and len(r0["valid"]) == 2
    assert r0["loss_means"] == r1["loss_means"]
    texp = runs["texp"]
    mine, theirs = set(r0["valid_files"]), set(r1["valid_files"])
    assert not mine & theirs
    assert mine | theirs == set(texp.valid_synth_stream.filenames) | set(texp.valid_weak_stream.filenames)


def test_only_rank_zero_writes(runs):
    r0, r1 = runs["ranks"]
    assert r1["saved"] == [] and "baseline_best" in r0["saved"] and "baseline_epoch_1" in r0["saved"]
    assert [r["epoch"] for r in runs["dp"]] == [0, 1]  # one record an epoch: rank 0's
    assert os.path.exists(runs["store"] / "model" / "baseline_best")


def test_device_cache_under_a_group_gathers_the_streamed_cut(runs):
    for r in runs["ranks"]:
        assert r["resident_same"] and r["resident_batches"] == 2 * r["n_steps"]


@pytest.mark.parametrize("command, files", [("evaluate", ("eval",)), ("predict", ("predict", "weak")),
                                             ("predict_long", ("long",))])
def test_data_parallel_inference_gives_the_single_process_results(runs, command, files):
    """Each rank infers its half of the files; the gathered results and the
    TSVs rank 0 writes are one process's, in its file order."""
    want = runs["single"][command]
    for got in (r[command] for r in runs["ranks"]):
        assert set(got) == set(want)
        for k, v in want.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(got[k], v, err_msg=k)
            else:
                assert got[k] == v, k
    for name in files:
        with open(runs["tmp"] / f"ranks_{name}.tsv") as a, open(runs["tmp"] / f"single_{name}.tsv") as b:
            assert a.read() == b.read(), name


def test_device_resident_data_under_multihost_still_raises():
    """As the JAX package refuses several processes; a data-parallel mesh
    of one process a card is taken."""
    exp = Experiment(tiny(Config, DSPConfig, ModelConfig, TrainConfig, RANK_BATCH), mean_teacher=True,
                     subpart_data=SUBPART, synthetic_audio=True, seed=0, device="cpu")
    d, paths = exp.cfg.dsp, exp.cfg.paths
    streams = [exp._make_stream("weak", subpart_manifest(load_manifest(paths.weak), SUBPART), paths.weak)]
    pipe = tpipe.BatchPipeline(streams, [2], d.max_samples, d.n_window, d.hop_length, d.max_frames,
                               n_shards=2, process_index=0, process_count=2)
    mesh = Mesh(None, None, 0, 2, torch.device("cpu"), "gloo", multihost=True)
    with pytest.raises(ValueError, match="multi-host"):
        tpipe.DeviceResidentData(pipe, "cpu", mesh=mesh)
    assert tpipe.DeviceResidentData(pipe, "cpu", mesh=dataclasses.replace(mesh, multihost=False)).n_real == 12

