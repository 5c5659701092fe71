"""The port's profiling hooks (dcase2019_task4_tpu_torch/utils/profiling.py):
`top_device_ops` on a hand-written torch.profiler chrome trace (names,
sums, order, launch shapes; host events ignored; the newest trace read),
`trace` on a CPU forward writes a trace that reads back, and `Throughput`
equals the JAX package's under a patched clock; `card_line` picks the
card of a device by its UUID under a patched torch and nvidia-smi."""

import gzip
import json
import os
import subprocess
import time
import types

import pytest
import torch

from dcase2019_task4_tpu.utils import profiling as jprof
from dcase2019_task4_tpu_torch.utils import profiling as prof


def _event(name, cat, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": 0, "dur": dur, "args": args}


def _trace():
    return {"traceEvents": [
        _event("void conv3x3_nhwc_kernel<64>(float const*)", "kernel", 120.0, grid=[132, 1, 1], block=[128, 1, 1]),
        _event("aten::conv2d", "cpu_op", 5000.0),
        _event("bn_glu_pool_kernel", "kernel", 300.0, grid=[264, 1, 1], block=[256, 1, 1]),
        _event("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 40.0, bytes=4096),
        _event("void conv3x3_nhwc_kernel<64>(float const*)", "kernel", 130.0, grid=[66, 1, 1], block=[128, 1, 1]),
        _event("Memset (Device)", "gpu_memset", 2.5),
        _event("cudaLaunchKernel", "cuda_runtime", 900.0),
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 1},
    ]}


def test_top_device_ops_sums_by_name_in_order(tmp_path):
    old, new = tmp_path / "a.pt.trace.json", tmp_path / "sub" / "b.pt.trace.json.gz"
    old.write_text(json.dumps({"traceEvents": [_event("stale_kernel", "kernel", 1e6)]}))
    os.makedirs(new.parent)
    with gzip.open(new, "wt") as f:
        json.dump(_trace(), f)
    os.utime(old, (time.time() - 60, time.time() - 60))
    ops = prof.top_device_ops(str(tmp_path))
    assert ops == [
        ("bn_glu_pool_kernel", 0.3, "grid [264, 1, 1] block [256, 1, 1]"),
        ("void conv3x3_nhwc_kernel<64>(float const*)", 0.25, "grid [132, 1, 1] block [128, 1, 1]"),
        ("Memcpy HtoD (Pageable -> Device)", 0.04, ""),
        ("Memset (Device)", 0.0025, ""),
    ]
    assert prof.top_device_ops(str(tmp_path), top=2) == ops[:2]
    assert prof.top_device_ops(str(tmp_path / "empty")) == []


def test_trace_of_a_cpu_forward_reads_back(tmp_path):
    net = torch.nn.Sequential(torch.nn.Linear(16, 16), torch.nn.ReLU())
    with prof.trace(str(tmp_path), cuda=False):
        net(torch.randn(4, 16)).sum()
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(tmp_path / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::linear" for e in events)
    assert prof.top_device_ops(str(tmp_path)) == []  # no device events on the CPU


@pytest.mark.parametrize("warmup", [1, 3])
def test_throughput_equals_the_jax_meter(monkeypatch, warmup):
    clock = iter([100.0, 100.0, 104.0, 104.0] + [110.0] * 8)
    monkeypatch.setattr(time, "time", lambda: next(clock))
    meters = (prof.Throughput(warmup), jprof.Throughput(warmup))
    assert [m.items_per_sec for m in meters] == [0.0, 0.0]
    for n in (8, 16, 24, 32, 40):
        for m in meters:
            m.update(n)
    got, want = meters[0].items_per_sec, meters[1].items_per_sec
    assert got == want and got > 0.0


def test_the_step_tools_groups_name_kernels_plainly():
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
    import profile_step_torch

    assert [profile_step_torch.group_name(n) for n in (
        "void (anonymous namespace)::bn_glu_pool_bwd_kernel<4>(float const*, float const*)",
        "(anonymous namespace)::conv3x3_wgrad_kernel(float const*, float const*, float*, int)",
        "void at::native::elementwise_kernel<128, 2, at::native::CUDAFunctor_add<float>>(int)",
        "Memcpy DtoD (Device -> Device)", "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n")] == [
        "bn_glu_pool_bwd_kernel", "conv3x3_wgrad_kernel", "at::native::elementwise_kernel", "Memcpy DtoD",
        "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n"]


SMI = ("GPU-aaaaaaaa-0000-0000-0000-000000000000, NVIDIA H100 80GB HBM3, 700.00 W\n"
       "GPU-BBBBBBBB-1111-1111-1111-111111111111, NVIDIA H100 80GB HBM3, 500.00 W\n")


@pytest.mark.parametrize("index, uuid, want", [
    (0, "bbbbbbbb-1111-1111-1111-111111111111", "NVIDIA H100 80GB HBM3, 500.00 W"),  # CUDA_VISIBLE_DEVICES=1
    (1, "aaaaaaaa-0000-0000-0000-000000000000", "NVIDIA H100 80GB HBM3, 700.00 W"),  # CUDA_VISIBLE_DEVICES=1,0
])
def test_card_line_finds_the_card_by_uuid(monkeypatch, index, uuid, want):
    """torch's index counts only the visible cards; nvidia-smi's line is
    found by the card's UUID, whatever its place in the output."""
    seen = {}

    def run(cmd, **kw):
        seen["cmd"] = cmd
        return types.SimpleNamespace(stdout=SMI)

    monkeypatch.setattr(subprocess, "run", run)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: types.SimpleNamespace(uuid=uuid) if i == index else None)
    assert prof.card_line(torch.device("cuda", index)) == want
    assert seen["cmd"][1] == "--query-gpu=uuid,name,power.limit"
    assert prof.card_line("cpu") == "cpu"


def test_card_line_raises_for_a_card_nvidia_smi_does_not_list(monkeypatch):
    monkeypatch.setattr(subprocess, "run", lambda cmd, **kw: types.SimpleNamespace(stdout=SMI))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: types.SimpleNamespace(uuid="cccccccc-2222-2222-2222-222222222222"))
    with pytest.raises(RuntimeError, match="no card of UUID"):
        prof.card_line("cuda:0")
