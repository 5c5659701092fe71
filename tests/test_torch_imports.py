"""The port imports neither jax, nor pandas, nor the JAX package.

Each check runs in a fresh interpreter, so modules the test process has
already loaded (jax, pandas, dcase2019_task4_tpu) cannot hide an import. A
source scan backs it: no file of the port, nor chip_smoke.py, imports
dcase2019_task4_tpu or reads its location (docstrings that name a
counterpart path are fine).
"""

import glob
import os
import pkgutil
import re
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
                 "eval.decode", "eval.evaluate", "config", "utils.logger", "utils.scaler",
                 "data.encoder", "data.audio_io", "native", "train.ramps", "train.losses",
                 "train.schedules", "train.steps", "ops.entry_conv", "ops.fused_entry_block", "ops.crows_block",
                 "data.manifests", "data.sampler", "data.features_cache", "eval.sed_scores", "eval.tagging",
                 "utils.meters", "utils.metrics_writer", "train.experiment", "eval.thresholds", "parallel.mesh",
                 "parallel.multihost", "eval.export", "train.torch_import", "data.download", "data.transforms",
                 "utils.profiling", "utils.cost_model"):
        assert f"dcase2019_task4_tpu_torch.{name}" in MODULES


# the tools and graft entry points, each run as far as it goes without a card, with
# the arguments it needs to get there (summarize_run_torch needs no card: it
# reads a file, and a missing one gives 2)
TOOL_ARGS = {"bench_entry_conv_torch": [], "profile_step_torch": [], "ablate_ssl_torch": [],
             "diag_invariance_torch": ["--ckpt", "x=missing"], "twin_epochs_torch": [], "diag_mt_var_torch": [],
             "summarize_run_torch": ["missing"], "graft_entry_torch": []}


@pytest.mark.parametrize("target", ["package", "chip_smoke", *TOOL_ARGS])
def test_no_jax_and_no_pandas(target):
    if target == "package":
        imports = "\n".join(f"import {m}" for m in MODULES)
    elif target == "chip_smoke":  # what chip_smoke.py reaches: its module and every port module it calls
        imports = "import chip_smoke\n" + "\n".join(f"import {m}" for m in MODULES)
    else:  # a tool, run as far as it goes without a card (it imports what it uses inside main)
        imports = (f"import sys; sys.path.insert(0, 'tools')\nimport {target}\n"
                   f"rc = {target}.main({TOOL_ARGS[target]!r})\n"
                   "import torch\nassert rc == 2 or torch.cuda.is_available(), rc")
    proc = _run(imports + "\nimport sys\nprint(sorted(m for m in sys.modules if m in ('jax', 'pandas') "
                          "or m == 'dcase2019_task4_tpu' or m.startswith('dcase2019_task4_tpu.')))")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_host_loader_module_is_gone():
    assert "dcase2019_task4_tpu_torch._host" not in MODULES
    assert not os.path.exists(os.path.join(ROOT, "dcase2019_task4_tpu_torch", "_host.py"))


_JAX_PACKAGE_USE = re.compile(
    r"^\s*(import\s+dcase2019_task4_tpu(\s|\.|,|$)|from\s+dcase2019_task4_tpu(\.\S*)?\s+import)"
    r"|dcase2019_task4_tpu\.__file__|import_module\(\s*[\"']dcase2019_task4_tpu[\"'.]", re.MULTILINE)


def _port_sources():
    files = glob.glob(os.path.join(ROOT, "dcase2019_task4_tpu_torch", "**", "*.py"), recursive=True)
    return sorted(files) + [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "graft_entry_torch.py")] + [
        os.path.join(ROOT, "tools", f"{tool}.py") for tool in TOOL_ARGS if tool != "graft_entry_torch"]


def test_source_scan_finds_no_import_of_the_jax_package():
    files = _port_sources()
    assert len(files) > 20
    for path in files:
        with open(path) as f:
            hit = _JAX_PACKAGE_USE.search(f.read())
        assert hit is None, f"{os.path.relpath(path, ROOT)}: {hit.group(0)!r}"


def test_source_scan_catches_what_it_should():
    for bad in ("import dcase2019_task4_tpu\n", "  from dcase2019_task4_tpu import native\n",
                "from dcase2019_task4_tpu.config import Config\n", "import dcase2019_task4_tpu.utils.scaler\n",
                "p = dcase2019_task4_tpu.__file__\n", "importlib.import_module('dcase2019_task4_tpu.config')\n"):
        assert _JAX_PACKAGE_USE.search(bad), bad
    for fine in ("from dcase2019_task4_tpu_torch.config import Config\n", "import dcase2019_task4_tpu_torch\n",
                 "counterpart of dcase2019_task4_tpu/config.py\n"):
        assert not _JAX_PACKAGE_USE.search(fine), fine


def test_chip_smoke_names_every_kernel_of_its_kernels_line():
    """Every row of the {"kernels": [...]} line comes from chip_smoke.KERNELS:
    each names its source in the repo and the TPU kernel it replaces, has a
    launch counter, and belongs to a path whose launches are checked."""
    proc = _run("import json, chip_smoke\n"
                "print(json.dumps({'kernels': chip_smoke.KERNELS, 'wrappers': sorted(chip_smoke.wrappers()),\n"
                "                  'paths': sorted(set().union(*chip_smoke.PATHS.values())),\n"
                "                  'row_path': chip_smoke.ROW_PATH, 'path_names': sorted(chip_smoke.PATHS),\n"
                "                  'default': sorted(set(chip_smoke.PREDICT_MIN) | set(chip_smoke.STEP_MIN))}))")
    assert proc.returncode == 0, proc.stderr
    import json

    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    names = sorted(doc["kernels"])
    assert names == doc["wrappers"] == doc["paths"] == sorted(doc["row_path"])
    assert set(doc["row_path"].values()) <= set(doc["path_names"])
    default = ("fused_stft_mel", "conv2d_forward", "conv2d_dx", "conv2d_wgrad", "fused_bn_glu_pool_eval",
               "fused_bn_glu_pool_train", "batch_stats", "bwd_reduce", "bwd_fixup")
    assert doc["default"] == sorted(default)  # the default paths launch what they launched
    for want in default + ("entry_conv", "entry_conv_wgrad", "entry_block_stats", "entry_block_fwd_eval",
                           "entry_block_fwd_train", "entry_block_bwd_reduce", "entry_block_bwd_wgrad",
                           "crows_stats", "crows_fwd", "crows_bwd_reduce", "crows_bwd_wgrad"):
        assert want in names
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        source = f.read()
    for name, (src, replaces) in doc["kernels"].items():
        assert f'"{name}"' in source
        assert os.path.exists(os.path.join(ROOT, src)), src
        jax_file, line = replaces.rsplit(":", 1)
        with open(os.path.join(ROOT, jax_file)) as f:
            assert int(line) <= len(f.readlines()), replaces
    for key in ('"launches"', '"max_abs_err"', '"plain_ms"', '"bound_ms"', '"bound_by"', '"library_ms"',
                '"route"', '"source"', '"replaces"'):
        assert key in source


def test_predict_help_runs():
    proc = _run("", "-m", "dcase2019_task4_tpu_torch.cli", "predict", "--help")
    assert proc.returncode == 0, proc.stderr
    assert "--device" in proc.stdout and "--weak_fname" in proc.stdout
    assert all(flag in proc.stdout for flag in ("--long", "--overlap", "--merge_gap", "--subpart_data"))


def test_precompute_help_runs():
    proc = _run("", "-m", "dcase2019_task4_tpu_torch.cli", "precompute", "--help")
    assert proc.returncode == 0, proc.stderr
    assert all(flag in proc.stdout for flag in ("--device", "--feature_dir", "--nolog", "--sets"))


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
