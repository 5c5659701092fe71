"""The port's training and scoring CLIs, through `cli.main`, on the CPU.

The configuration is patched to the tiny one of tests/test_e2e.py (1 s
clips, filters (16, 16, 16), GRU 16, batch 8). `train_meanteacher` (two
epochs, then `--resume` for a third) and `train_crnn` (one epoch) leave the
best checkpoint, metrics.jsonl and both prediction TSVs; the scoring
`evaluate` reads the checkpoint back and writes the validation predictions
the final test wrote, and its F1s and rows are the JAX package's
`CheckpointEvaluator.test_model` on the same checkpoint (the rows' times
equal, the F1s equal). The data-parallel flags reach the process group's
set-up. A legacy v1 (pickle) copy of a checkpoint is refused by
`evaluate`, `predict` and `--resume` without DCASE_ALLOW_LEGACY_PICKLE=1
and read as the npz is with it.
"""

import csv
import dataclasses
import os

import numpy as np
import pytest
import torch

from dcase2019_task4_tpu_torch import cli
from dcase2019_task4_tpu_torch.config import Config, DSPConfig, ModelConfig, TrainConfig
from dcase2019_task4_tpu_torch.utils.metrics_writer import read_metrics

TINY_CFG = Config(
    dsp=DSPConfig(max_len_seconds=1.0),
    model=ModelConfig(nclass=10, nb_filters=(16, 16, 16), n_rnn_cell=16, dropout=0.3),
    train=TrainConfig(batch_size=8, n_epoch=1, num_prefetch=1),
)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for torch: the suite runs several workers on the
    machine's cores, and tiny CPU steps only lose to thread contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def read_tsv(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f, delimiter="\t"))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setattr(cli, "Config", lambda: TINY_CFG)
    tmp = tmp_path_factory.mktemp("cli")
    mt, crnn = str(tmp / "mt"), str(tmp / "crnn")
    assert cli.main(["train_meanteacher", "--synthetic_audio", "-s", "12", "--epochs", "2", "--store_dir", mt,
                     "--device", "cpu"]) == 0
    assert cli.main(["train_crnn", "--synthetic_audio", "-s", "12", "--epochs", "1", "--store_dir", crnn,
                     "--device", "cpu"]) == 0
    yield {"mt": mt, "crnn": crnn, "tmp": tmp, "mp": mp}
    mp.undo()


@pytest.mark.parametrize("run, epochs", [("mt", 2), ("crnn", 1)])
def test_the_store_directory_holds_the_run(trained, run, epochs):
    store = trained[run]
    for f in ("model/baseline_best", "model/baseline_epoch_0", "metrics.jsonl",
              "predictions/baseline_validation.tsv", "predictions/baseline_eval2019.tsv"):
        assert os.path.exists(os.path.join(store, f)), f
    records = read_metrics(os.path.join(store, "metrics.jsonl"))
    assert [r["epoch"] for r in records] == list(range(epochs))
    for r in records:
        assert np.isfinite(r["loss"]) and r["loss"] > 0
        for k in ("event_macro_f1", "weak_macro_f1", "global_valid", "saved_best", "epoch_time_s",
                  "steps_per_s", "queue_wait_share"):
            assert k in r, k
        if run == "mt":
            assert {"consistency_strong", "weak_ema_class_loss", "strong_ema_class_loss"} <= set(r)
        else:
            assert "consistency_strong" not in r and {"weak_class_loss", "strong_class_loss"} <= set(r)
    header = read_tsv(os.path.join(store, "predictions", "baseline_validation.tsv"))
    assert all(set(row) == {"event_label", "onset", "offset", "filename"} for row in header)


def test_resume_continues_after_the_saved_epoch(trained):
    mt = trained["mt"]
    assert cli.main(["train_meanteacher", "--synthetic_audio", "-s", "12", "--epochs", "3", "--store_dir", mt,
                     "--device", "cpu", "--resume", os.path.join(mt, "model", "baseline_epoch_1")]) == 0
    assert [r["epoch"] for r in read_metrics(os.path.join(mt, "metrics.jsonl"))] == [0, 1, 2]


def test_evaluate_reads_the_checkpoint_back_as_the_jax_evaluator_does(trained, tmp_path):
    from dcase2019_task4_tpu.eval.evaluate import CheckpointEvaluator as JEvaluator

    mt = trained["mt"]
    best = os.path.join(mt, "model", "baseline_best")
    out = str(tmp_path / "valid.tsv")
    validation = TINY_CFG.paths.validation
    res = cli.evaluate(["-m", best, "--synthetic_audio", "-s", "12", "--sets", validation, "-p", out,
                        "--device", "cpu"])
    assert list(res) == [validation] and set(res[validation]) == {"event_macro_f1", "weak_macro_f1"}
    mine = read_tsv(out)
    assert mine == read_tsv(os.path.join(mt, "predictions", "baseline_validation.tsv"))
    theirs = JEvaluator(best, synthetic_audio=True).test_model(validation, 12)
    assert res[validation]["event_macro_f1"] == theirs["event_macro_f1"]
    assert res[validation]["weak_macro_f1"] == theirs["weak_macro_f1"]
    want = theirs["predictions"]
    assert [r["event_label"] for r in mine] == list(want["event_label"])
    assert [r["filename"] for r in mine] == list(want["filename"])
    np.testing.assert_array_equal([float(r["onset"]) for r in mine], want["onset"].to_numpy())
    np.testing.assert_array_equal([float(r["offset"]) for r in mine], want["offset"].to_numpy())


def test_the_clis_read_a_v1_checkpoint_behind_the_switch(trained, tmp_path, monkeypatch):
    """The epoch-1 checkpoint rewritten as a legacy v1 pickle (its leaves in
    order and its metadata): `evaluate`, `predict` and `--resume` refuse it
    without DCASE_ALLOW_LEGACY_PICKLE=1 and, with it, give what the npz
    gives."""
    import json
    import pickle

    mt = trained["mt"]
    npz = os.path.join(mt, "model", "baseline_epoch_1")
    with np.load(npz, allow_pickle=False) as z:
        doc = json.loads(bytes(z["__meta__"]).decode("utf-8"))
        leaves = [z[f"leaf_{i:05d}"] for i in range(doc["n_leaves"])]
    v1 = str(tmp_path / "baseline_epoch_1.v1")
    with open(v1, "wb") as f:
        pickle.dump({"version": 1, "leaves": leaves, "metadata": doc["metadata"]}, f)
    validation = TINY_CFG.paths.validation

    def evaluate(path, name):
        out = str(tmp_path / f"{name}.tsv")
        res = cli.evaluate(["-m", path, "--synthetic_audio", "-s", "12", "--sets", validation, "-p", out,
                            "--device", "cpu"])
        return res, read_tsv(out)

    def predict(path, name):
        res = cli.predict(["-m", path, "-i", validation, "-s", "12", "--synthetic_audio",
                           "-p", str(tmp_path / f"{name}.pred.tsv"), "--device", "cpu"])
        return res, read_tsv(str(tmp_path / f"{name}.pred.tsv"))

    def resume(path, name):
        store = str(tmp_path / name)
        assert cli.main(["train_meanteacher", "--synthetic_audio", "-s", "12", "--epochs", "3", "--store_dir", store,
                         "--device", "cpu", "--resume", path]) == 0
        return [{k: v for k, v in r.items() if k != "ts" and not k.endswith(("_s", "_share"))}
                for r in read_metrics(os.path.join(store, "metrics.jsonl"))]

    monkeypatch.delenv("DCASE_ALLOW_LEGACY_PICKLE", raising=False)
    for run in (evaluate, predict, resume):
        with pytest.raises(ValueError, match="DCASE_ALLOW_LEGACY_PICKLE=1"):
            run(v1, f"refused_{run.__name__}")
    want = {run.__name__: run(npz, f"npz_{run.__name__}") for run in (evaluate, predict, resume)}
    monkeypatch.setenv("DCASE_ALLOW_LEGACY_PICKLE", "1")
    got = {run.__name__: run(v1, f"v1_{run.__name__}") for run in (evaluate, predict, resume)}
    assert got["evaluate"] == want["evaluate"]
    assert got["predict"][1] == want["predict"][1] and got["predict"][0]["n_files"] == want["predict"][0]["n_files"]
    for key in ("strong", "weak"):
        np.testing.assert_array_equal(got["predict"][0][key], want["predict"][0][key])
    assert [r["epoch"] for r in got["resume"]] == [2] and got["resume"] == want["resume"]


# a bf16 model runs every block through the fused kernel, whose pool takes
# whole windows: 1.11 s clips give T = 96 frames (1 s clips give 87)
TINY_FOR_BF16 = dataclasses.replace(TINY_CFG, dsp=DSPConfig(max_len_seconds=1.11))
TINY_SCALED = Config(
    dsp=DSPConfig(n_mels=128, max_len_seconds=1.11),
    model=ModelConfig(nclass=10, nb_filters=(24, 24, 24), n_rnn_cell=16, pooling=((2, 4), (2, 4), (2, 8)),
                      compute_dtype="bfloat16"),
    train=TrainConfig(batch_size=8, n_epoch=1, num_prefetch=1, spec_augment=True),
)


@pytest.mark.parametrize("flags", [["--paired_teacher_view", "--bf16"], ["--scaled"]], ids=["paired_bf16", "scaled"])
def test_the_model_flags_train_through_the_cli(tmp_path, monkeypatch, flags):
    """`--paired_teacher_view` with `--bf16`, and `--scaled` (patched to a
    small scaled-shaped config: 128 mels, pooling (2,4)(2,4)(2,8),
    SpecAugment, bf16), reach the Experiment and train one Mean-Teacher
    epoch (two steps) on the CPU to a checkpoint of that configuration."""
    from dcase2019_task4_tpu_torch import config as tconfig
    from dcase2019_task4_tpu_torch.train import checkpoints as tckpt
    from dcase2019_task4_tpu_torch.train.experiment import Experiment

    monkeypatch.setattr(cli, "Config", lambda: TINY_FOR_BF16)
    monkeypatch.setattr(tconfig, "scaled_config", lambda: TINY_SCALED)
    seen = []
    run = Experiment.run

    def recorded(self, *args, **kwargs):
        seen.append(self)
        return run(self, *args, **kwargs)

    monkeypatch.setattr(Experiment, "run", recorded)
    store = str(tmp_path / "run")
    assert cli.main(["train_meanteacher", "--synthetic_audio", "-s", "8", "--epochs", "1", "--store_dir", store,
                     "--device", "cpu", *flags]) == 0
    exp = seen[0]
    assert exp.cfg.model.compute_dtype == "bfloat16"
    if "--scaled" in flags:
        assert exp.cfg == TINY_SCALED and exp.train_step is not None
    else:
        assert exp.paired_teacher_view and all(s.source2 is not None for s in exp.pipeline.streams)
    (record,) = read_metrics(os.path.join(store, "metrics.jsonl"))
    assert np.isfinite(record["loss"]) and record["loss"] > 0
    meta = tckpt.read_metadata(os.path.join(store, "model", "baseline_best"))
    assert meta["config"]["model"]["compute_dtype"] == "bfloat16"
    assert meta["config"]["train"]["spec_augment"] == ("--scaled" in flags)
    assert os.path.exists(os.path.join(store, "predictions", "baseline_eval2019.tsv"))


class _Reached(Exception):
    """The mesh was made: the command stops there."""


TORCHRUN = ("127.0.0.1:29500", 1, 0)  # the address is handed on, never opened


@pytest.mark.parametrize("argv, called, multihost", [
    (["train_meanteacher", "--data_parallel"], TORCHRUN, False),
    (["train_meanteacher", "--multihost"], (None, None, None), True),
    (["train_meanteacher", "--coordinator_address", "localhost:1234"], ("localhost:1234", None, None), True),
    (["train_crnn", "--num_processes", "2"], (None, 2, None), True),
    (["train_crnn", "--process_id", "0"], (None, None, 0), True),
    (["evaluate", "-m", "x", "--data_parallel"], TORCHRUN, False),
])
def test_parallel_flags_reach_the_group_set_up(tmp_path, monkeypatch, argv, called, multihost):
    """The five data-parallel flags are ported: `--data_parallel` brings the
    group up from torchrun's environment, the multi-host flags from
    themselves, both through `multihost.initialize`, which stands in here
    for a group of world size 1 at a `file://` store; the command stops
    once its mesh is made."""
    import torch.distributed as dist

    from dcase2019_task4_tpu_torch.parallel import mesh, multihost as mh

    for key, value in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0"), ("MASTER_ADDR", "127.0.0.1"),
                       ("MASTER_PORT", "29500")):
        monkeypatch.setenv(key, value)
    calls, meshes = [], []
    real_init, real_mesh = mh.initialize, mesh.make_mesh

    def initialize(address, n, pid, backend=None, device="cuda"):
        calls.append((address, n, pid, str(device)))
        return real_init(f"file://{tmp_path / 'store'}", 1, 0, backend="gloo", device="cpu")

    def make_mesh(*args, **kwargs):
        meshes.append(real_mesh(*args, **kwargs))
        raise _Reached

    monkeypatch.setattr(mh, "initialize", initialize)
    monkeypatch.setattr(mesh, "make_mesh", make_mesh)
    try:
        with pytest.raises(_Reached):
            cli.main(argv + ["--device", "cpu"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert calls == [(*called, "cpu")]
    (m,) = meshes
    assert (m.rank, m.world_size, m.backend, m.device.type, m.multihost) == (0, 1, "gloo", "cpu", multihost)


def test_multihost_flags_come_together():
    from dcase2019_task4_tpu_torch.parallel import multihost as mh

    with pytest.raises(ValueError, match="--coordinator_address, --num_processes and --process_id"):
        mh.initialize("localhost:1234", None, None, device="cpu")
    with pytest.raises(ValueError, match="process_id 2"):
        mh.initialize("localhost:1234", 2, 2, device="cpu")


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["train_crnn", "--synthetic_audio", "-s", "12"])
