"""The port imports neither jax nor pandas.

Each check runs in a fresh interpreter, so modules the test process has
already loaded (jax, pandas) cannot hide an import.
"""

import os
import pkgutil
import subprocess
import sys

import pytest

import dcase2019_task4_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = sorted(
    m.name for m in pkgutil.walk_packages(dcase2019_task4_tpu_torch.__path__, "dcase2019_task4_tpu_torch.")
)


def _run(code: str, *args: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, *args] if args else [sys.executable, "-c", code],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)


def test_every_module_is_listed():
    for name in ("cli", "ops.fused_mel", "ops.packed_conv", "ops.fused_block", "ops.mel", "ops.gru",
                 "models.crnn", "models.layers", "train.checkpoints", "data.pipeline",
                 "eval.decode", "eval.evaluate"):
        assert f"dcase2019_task4_tpu_torch.{name}" in MODULES


@pytest.mark.parametrize("target", ["package", "chip_smoke"])
def test_no_jax_and_no_pandas(target):
    if target == "package":
        imports = "\n".join(f"import {m}" for m in MODULES)
    else:  # what chip_smoke.py reaches: its module and every port module it calls
        imports = "import chip_smoke\n" + "\n".join(f"import {m}" for m in MODULES)
    proc = _run(imports + "\nimport sys\nprint(sorted(m for m in ('jax', 'pandas') if m in sys.modules))")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_predict_help_runs():
    proc = _run("", "-m", "dcase2019_task4_tpu_torch.cli", "predict", "--help")
    assert proc.returncode == 0, proc.stderr
    assert "--device" in proc.stdout and "--weak_fname" in proc.stdout


def test_unknown_command_exits_nonzero():
    proc = _run("", "-m", "dcase2019_task4_tpu_torch.cli", "train")
    assert proc.returncode != 0 and "usage" in proc.stderr


def test_chip_smoke_refuses_without_a_gpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _run("", os.path.join(ROOT, "chip_smoke.py"))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
