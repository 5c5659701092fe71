"""The port's step cost model (dcase2019_task4_tpu_torch/utils/cost_model.py)
against the JAX package's (dcase2019_task4_tpu/utils/cost_model.py):
`model_flops` and `_param_count` equal for the flagship, scaled and tiny
configurations, with and without the teacher; `hbm_bytes` item by item
against a count by hand at one tiny configuration; the peaks are the
H100's that chip_smoke.py bounds kernels by."""

import dataclasses

import pytest

import chip_smoke
from dcase2019_task4_tpu import config as jconfig
from dcase2019_task4_tpu.utils import cost_model as jcm
from dcase2019_task4_tpu_torch import config as tconfig
from dcase2019_task4_tpu_torch.models.crnn import CRNN, count_params
from dcase2019_task4_tpu_torch.utils import cost_model as cm

TINY = {"dsp": {"max_len_seconds": 1.11}, "model": {"nb_filters": (8, 8, 8), "n_rnn_cell": 8, "nclass": 4}}


def _configs(package):
    tiny = package.Config(dsp=package.DSPConfig(**TINY["dsp"]), model=package.ModelConfig(**TINY["model"]))
    bf16 = dataclasses.replace(package.Config(), model=package.ModelConfig(compute_dtype="bfloat16"))
    return {"flagship": package.Config(), "bf16": bf16, "scaled": package.scaled_config(), "tiny": tiny}


@pytest.mark.parametrize("name", ["flagship", "bf16", "scaled", "tiny"])
@pytest.mark.parametrize("mean_teacher", [True, False])
def test_flops_and_params_equal_the_jax_model(name, mean_teacher):
    mine, theirs = _configs(tconfig)[name], _configs(jconfig)[name]
    for batch in (4, 24):
        assert cm.model_flops(mine, batch, mean_teacher) == jcm.model_flops(theirs, batch, mean_teacher)
    assert cm._param_count(mine) == jcm._param_count(theirs)
    # the count of the port's own model (BatchNorm's four vectors a block counted there as parameters too)
    assert cm._param_count(mine) == count_params(CRNN(mine.model)) + 2 * sum(mine.model.nb_filters)


def test_peaks_are_chip_smokes():
    assert (cm.H100_PEAK_HBM_BYTES_PER_S, cm.H100_PEAK_FLOPS_FP32, cm.H100_PEAK_FLOPS_BF16) == \
           (chip_smoke.PEAK_BYTES_PER_S, chip_smoke.PEAK_FP32_FLOPS, chip_smoke.PEAK_BF16_FLOPS)


@pytest.mark.parametrize("recompute", [False, True])
@pytest.mark.parametrize("mean_teacher", [True, False])
def test_hbm_bytes_by_hand_at_the_tiny_config(recompute, mean_teacher):
    cfg = _configs(tconfig)["tiny"]
    B, n = 4, 2 if mean_teacher else 1
    # T = 96 frames, 64 mels, 8 channels, pool (2, 4) a block, float32; samples = 48951 + 2048
    samples = 48951 + 2048
    assert cfg.dsp.max_samples + cfg.dsp.n_window == samples and cfg.dsp.max_frames == 96
    feats = B * 96 * 64 * 4
    x1, y1 = B * 96 * 64 * 4, B * 96 * 64 * 8 * 4
    p1 = y1 // 8
    y2, p2 = B * 48 * 16 * 8 * 4, B * 48 * 16 * 8 * 4 // 8
    y3, p3 = B * 24 * 4 * 8 * 4, B * 24 * 4 * 8 * 4 // 8
    bwd = (lambda y, p: 3 * y + 2 * p) if recompute else (lambda y, p: 5 * y + p)
    want = {
        "frontend": B * samples * 2 + 2 * B * samples * 4 + 2 * feats + 2 * n * feats,
        "entry_conv_fwd": n * (x1 + y1),
        "entry_conv_bwd": x1 + y1,
        "block1_fwd": n * (y1 + p1),
        "block1_bwd": bwd(y1, p1),
        "interior_blocks": sum(n * (x + 2 * y + p) + bwd(y, p) + 2 * (y + x) for x, y, p in ((p1, y2, p2), (p2, y3, p3))),
        "batch_stats": n * (y1 + y2 + y3),
        "small_allowance": 10 * cm._param_count(cfg) * 4 + 20 * B * 12 * 2 * 8 * 4,
    }
    want["total"] = sum(want.values())
    assert cm.hbm_bytes(cfg, B, mean_teacher, recompute) == want


def test_step_utilization():
    flagship = tconfig.Config()
    u = cm.step_utilization(flagship, 24, step_seconds=0.01)
    assert u["flops_per_step"] == cm.model_flops(flagship, 24)["total"]
    assert u["mfu_pct"] == round(100 * u["flops_per_step"] / 0.01 / cm.H100_PEAK_FLOPS_FP32, 2)
    assert u["hbm_util_pct"] == round(100 * u["hbm_bytes_per_step"] / 0.01 / cm.H100_PEAK_HBM_BYTES_PER_S, 2)
    bf16 = _configs(tconfig)["bf16"]
    ub = cm.step_utilization(bf16, 24, step_seconds=0.01)
    assert ub["mfu_pct"] == round(100 * ub["flops_per_step"] / 0.01 / cm.H100_PEAK_FLOPS_BF16, 2)
    assert cm.hbm_bytes(bf16, 24)["total"] < cm.hbm_bytes(flagship, 24)["total"]
