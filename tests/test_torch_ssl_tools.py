"""The port's semi-supervised study tools on the CPU, against the JAX tools.

The tools' flagship configuration is patched to the tiny one of
tests/test_torch_experiment.py (1 s clips, filters (16, 16, 16), GRU 16,
batch 8), as tests/test_torch_train_cli.py patches the CLI's. Held:

- `tools/ablate_ssl_torch.py`, two arms (supervised, mt) for one epoch
  under --nuisance_shift 0.4,0.6 with --subpart 12 --subpart_unlabeled 20:
  exit 0 or 1 (a verdict, not a failure); the JSON's keys are the JAX
  tool's (read from its committed ABLATION_ssl_shift.json), each run record
  with the card line beside them; a second invocation resumes and trains
  no arm that is done; a file of another configuration gives exit 2 and is
  left as it was; the exit check follows --margin, --strict_consistency
  and --tolerance on a finished file.
- `tools/diag_invariance_torch.measure` on the mt arm's best checkpoint,
  2 renders, against the JAX tool's `measure` on the same checkpoint: the
  two stds within 1e-5, the flip rate and the counts equal.
- `tools/twin_epochs_torch.py` fresh mode, one tiny epoch: `ok`; its twin
  model's forward bit for bit that of tests/test_crnn_parity.TorchCRNN on
  the same weights.
- `tools/diag_mt_var_torch.py` on the tiny arms: exit 0 and its five
  weak-F1 rows; `tools/summarize_run_torch.py` prints the JAX tool's table
  of the same metrics.jsonl.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from dcase2019_task4_tpu_torch.config import Config, DSPConfig, ModelConfig, TrainConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import ablate_ssl_torch  # noqa: E402
import diag_invariance_torch  # noqa: E402
import diag_mt_var_torch  # noqa: E402
import summarize_run_torch  # noqa: E402
import twin_epochs_torch  # noqa: E402

STD_TOL = 1e-5
ABLATE = ["--subpart", "12", "--subpart_unlabeled", "20", "--epochs", "1", "--eval_every", "1",
          "--nuisance_shift", "0.4,0.6", "--arms", "supervised,mt", "--device", "cpu"]


def jax_tool(name: str):
    """A JAX-side tool module, loaded from its file under its own name."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def tiny_config(epochs: int, max_cc: float = 2.0):
    return Config(dsp=DSPConfig(max_len_seconds=1.0),
                  model=ModelConfig(nclass=10, nb_filters=(16, 16, 16), n_rnn_cell=16, dropout=0.0),
                  train=TrainConfig(batch_size=8, n_epoch=epochs, max_consistency_cost=max_cc, checkpoint_epochs=0,
                                    save_best=True, num_prefetch=1))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for torch: the suite runs several workers on the
    machine's cores, and tiny CPU steps only lose to thread contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def study(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ablate")
    mp = pytest.MonkeyPatch()
    mp.setattr(ablate_ssl_torch, "arm_config", tiny_config)
    mp.setattr(diag_mt_var_torch, "mt_config", lambda: tiny_config(1))
    calls = []
    real = ablate_ssl_torch.run_arm
    mp.setattr(ablate_ssl_torch, "run_arm", lambda name, *a, **kw: calls.append(name) or real(name, *a, **kw))
    out, store = str(tmp / "abl.json"), str(tmp / "store")
    rc = ablate_ssl_torch.main(ABLATE + ["--store", store, "--out", out])
    yield {"rc": rc, "out": out, "store": store, "calls": calls, "tmp": tmp}
    mp.undo()


def _doc(path):
    with open(path) as f:
        return json.load(f)


def test_ablation_json_has_the_jax_schema(study):
    assert study["rc"] in (0, 1)
    assert study["calls"] == ["supervised", "mt"]
    doc, theirs = _doc(study["out"]), _doc(os.path.join(ROOT, "ABLATION_ssl_shift.json"))
    assert set(doc) == set(theirs)
    assert set(doc["summary"]) == {"supervised", "mt"} and set(doc["summary"]["mt"]) == set(theirs["summary"]["mt"])
    assert (doc["nuisance_shift"], doc["subpart_unlabeled"], doc["seeds"]) == ("0.4,0.6", 20, 1)
    for run in doc["runs"]:
        assert set(run) == set(theirs["runs"][0]) | {"card"} and run["card"] == "cpu"
        assert 0.0 <= run["best_event_macro_f1"] <= 1.0 and run["wall_s"] > 0
    sup, mt = doc["runs"]
    assert (sup["arm"], mt["arm"]) == ("supervised", "mt")
    assert (sup["n_unlabeled_clips"], mt["n_unlabeled_clips"]) == (0, 20)
    assert sup["n_labeled_clips"] == mt["n_labeled_clips"] > 0
    assert sup["steps_per_epoch"] > 0 and mt["steps_per_epoch"] > 0
    for arm in ("supervised", "mt"):
        assert os.path.exists(os.path.join(study["store"], f"{arm}_s0", "model", "baseline_best"))
        assert os.path.getsize(os.path.join(study["store"], f"{arm}_s0", "train.log")) > 0


def test_ablation_resumes_without_training_a_done_arm(study):
    before = list(study["calls"])
    rc = ablate_ssl_torch.main(ABLATE + ["--store", study["store"], "--out", study["out"]])
    assert rc == study["rc"]
    assert study["calls"] == before
    assert [r["arm"] for r in _doc(study["out"])["runs"]] == ["supervised", "mt"]


def test_ablation_refuses_another_configurations_file(study):
    with open(study["out"]) as f:
        before = f.read()
    argv = [a if a != "1" else "2" for a in ABLATE]  # --epochs 2 --eval_every 2
    assert ablate_ssl_torch.main(argv + ["--store", study["store"], "--out", study["out"]]) == 2
    with open(study["out"]) as f:
        assert f.read() == before


@pytest.mark.parametrize("flags, rc", [([], 0), (["--margin", "0.3"], 1), (["--strict_consistency"], 1),
                                       (["--strict_consistency", "--tolerance", "0.15"], 0)])
def test_the_exit_check_follows_margin_and_strict_consistency(tmp_path, flags, rc):
    """A finished file (mt beats supervised by 0.2 and trails mt_cc0 by 0.1):
    every arm is skipped, and the exit code is the check's."""
    runs = [{"arm": arm, "seed": 0, "best_event_macro_f1": f1, "best_weak_macro_f1": 0.5}
            for arm, f1 in (("supervised", 0.3), ("mt", 0.5), ("mt_cc0", 0.6))]
    out = tmp_path / "done.json"
    out.write_text(json.dumps({"subpart": 12, "epochs": 1, "variability": 1.0, "subpart_unlabeled": 20,
                               "eval_every": 1, "nuisance_shift": "0.4,0.6", "runs": runs}))
    argv = [a if a != "supervised,mt" else "supervised,mt,mt_cc0" for a in ABLATE]
    assert ablate_ssl_torch.main(argv + ["--out", str(out), "--store", str(tmp_path)] + flags) == rc


def test_diag_invariance_matches_the_jax_tool(study):
    ckpt = os.path.join(study["store"], "mt_s0", "model", "baseline_best")
    mine = diag_invariance_torch.measure(ckpt, 2, 12, 1.0, device="cpu")
    theirs = jax_tool("diag_invariance").measure(ckpt, 2, 12, 1.0)
    assert set(mine) == set(theirs)
    for k in ("n_clips", "renders", "epoch", "flip_rate"):
        assert mine[k] == theirs[k], k
    for k in ("strong_std", "weak_std"):
        assert abs(mine[k] - theirs[k]) <= STD_TOL, (k, mine[k], theirs[k])
    assert mine["n_clips"] > 0 and mine["strong_std"] > 0


def test_diag_invariance_writes_and_skips(study, capsys):
    ckpt = os.path.join(study["store"], "mt_s0", "model", "baseline_best")
    out = str(study["tmp"] / "diag.json")
    argv = ["--ckpt", f"mt={ckpt}", "--renders", "2", "--subpart", "12", "--device", "cpu", "--out", out]
    assert diag_invariance_torch.main(argv) == 0
    first = _doc(out)
    assert first["checkpoints"]["mt"]["card"] == "cpu" and first["renders"] == 2
    assert diag_invariance_torch.main(argv) == 0
    assert "mt: already measured, skipping" in capsys.readouterr().out
    assert _doc(out) == first


def test_twin_epochs_fresh_mode_is_ok(tmp_path, monkeypatch):
    monkeypatch.setattr(twin_epochs_torch, "twin_config", lambda epochs: tiny_config(epochs))
    out = str(tmp_path / "twin.json")
    assert twin_epochs_torch.main(["--epochs", "1", "--subpart", "12", "--device", "cpu", "--out", out]) == 0
    doc = _doc(out)
    assert doc["ok"] is True and len(doc["per_epoch"]) == 1 and doc["card"] == "cpu"
    row = doc["per_epoch"][0]
    assert abs(row["ours"]["loss"] - row["torch"]["loss"]) / row["ours"]["loss"] <= 0.15


def test_twin_model_is_the_parity_tests_twin():
    from dcase2019_task4_tpu.config import ModelConfig as JModel
    from tests.test_crnn_parity import TorchCRNN

    cfg = JModel(nclass=10, nb_filters=(16, 16, 16), n_rnn_cell=16)
    torch.manual_seed(0)
    theirs = TorchCRNN(cfg).eval()
    mine = twin_epochs_torch.TorchCRNN(cfg).eval()
    mine.load_state_dict(theirs.state_dict())
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 1, 96, 64)).astype(np.float32))
    with torch.no_grad():
        for got, want in zip(mine(x), theirs(x)):
            assert torch.equal(got, want)


def test_diag_mt_var_runs_its_five_rows(study, capsys):
    assert diag_mt_var_torch.main(["--ckpt_root", study["store"], "--subpart", "12", "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    for label in ("student/eval-BN/valid", "student/batch-BN/valid", "teacher/eval-BN/valid",
                  "student/eval-BN/TRAIN-weak", "student/batch-BN/TRAIN-weak"):
        assert f"[weak-F1] {label}" in text
    assert "[scaler] supervised_s0" in text and "[scaler] mt_s0" in text


def test_summarize_run_prints_the_jax_tools_table(study, capsys):
    store = os.path.join(study["store"], "mt_s0")
    assert summarize_run_torch.main([store]) == 0
    mine = capsys.readouterr().out
    assert jax_tool("summarize_run").main([store]) == 0
    assert mine == capsys.readouterr().out and "best criterion at epoch 0" in mine
    assert summarize_run_torch.main([os.path.join(store, "missing")]) == 2
