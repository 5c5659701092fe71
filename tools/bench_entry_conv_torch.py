"""Microbenchmark and ablations of the entry-conv kernels (K4) of the
PyTorch/CUDA port, on one NVIDIA GPU.

    python tools/bench_entry_conv_torch.py [--batch 24] [--runs 20]

Counterpart of tools/bench_entry_conv.py. At the flagship block-1 shape
(x [B, 864, 64] → y [B, 864, 64, 64], float32, TF32 off) it times, with CUDA
events around one call (median of `--runs` after 3 warm-ups; this includes
the gaps in which the card waits for the wrapper's host-side work) and with
torch.profiler (the device time of the call's kernels alone):

  * forward: `entry_conv_forward` (K4f: y, Σy, Σy²) against cuDNN's
    `F.conv2d` on the same input, and against `F.conv2d` followed by the
    statistics pass (K2s) that K4f makes unnecessary;
  * forward + weight gradient: K4f + `entry_conv_wgrad` (K4w) against
    `F.conv2d` + `torch.nn.grad.conv2d_weight` + the bias gradient;
  * the ablations of `entry_conv_kernel`, which isolate where its time goes:
      stats_only  — conv and Σ/Σ², no [B, T, F, C] store (the K5s mode)
      no_patch    — store and sums, one tap instead of nine (no 3×3 patch)
      write_only  — only the bias broadcast is written (pure store cost)

Every line carries the bound of the full kernel beside it (340 MB written at
3.35 TB/s for batch 24), and the first line printed is the card's name and
power limit as nvidia-smi gives them. Imports the port only; needs a card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3


def time_ms(fn, runs: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, runs: int = 5) -> float:
    """What the card itself spends on one call: torch.profiler's sum over the
    kernels and copies the call launches, mean of `runs` calls. Leaves out
    the gaps in which the card waits for the wrapper's host-side work."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    total = sum(float(e.self_device_time_total) for e in prof.events() if e.device_type == DeviceType.CUDA)
    return total / runs / 1e3


def main(argv=None) -> int:
    import torch
    import torch.nn.functional as F

    from dcase2019_task4_tpu_torch.models import layers as L
    from dcase2019_task4_tpu_torch.ops import entry_conv as ec
    from dcase2019_task4_tpu_torch.ops import fused_block as fb

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=24)
    ap.add_argument("--frames", type=int, default=864)
    ap.add_argument("--mels", type=int, default=64)
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--runs", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_entry_conv_torch: torch.cuda.is_available() is False; this tool needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)

    B, T, Fq, C = args.batch, args.frames, args.mels, args.channels
    rng = np.random.default_rng(0)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    x = t(rng.standard_normal((B, T, Fq)))
    params = {"w": t(rng.standard_normal((3, 3, 1, C)) * 0.2), "b": t(rng.standard_normal(C) * 0.1)}
    dy = t(rng.standard_normal((B, T, Fq, C)))
    w_oihw = params["w"].permute(3, 2, 0, 1).contiguous()
    x_cl = x[:, None].contiguous(memory_format=torch.channels_last)
    dy_cl = dy.permute(0, 3, 1, 2)
    bound = 1e3 * (x.numel() + dy.numel()) * 4 / PEAK_BYTES_PER_S
    print(f"x {list(x.shape)} -> y {list(dy.shape)}, float32, TF32 off, median of {args.runs}; "
          f"bound of the full kernel {bound:.4f} ms (bytes)")

    y, s1, s2 = ec.entry_conv_forward(params, x)
    ref = ec.entry_conv_reference(params, x)
    print(f"K4f against its plain version: y {float((y - ref[0]).abs().max()):.2e}, "
          f"sums {float((s1 - ref[1]).abs().max() / ref[1].abs().max()):.2e} of max")
    del ref

    def cudnn_fwd():
        return F.conv2d(x_cl, w_oihw, params["b"], padding=1)

    def cudnn_fwd_stats():
        return fb.batch_stats(L.conv2d(w_oihw, params["b"], x[..., None]))  # the default path's block-1 conv

    def cudnn_fwd_bwd():
        cudnn_fwd()
        return torch.nn.grad.conv2d_weight(x_cl, w_oihw.shape, dy_cl, padding=1), dy.sum(dim=(0, 1, 2))

    def kernel_fwd_bwd():
        ec.entry_conv_forward(params, x)
        return ec.entry_conv_wgrad(x, dy)

    rows = [
        ("cuDNN F.conv2d fwd", cudnn_fwd),
        ("cuDNN F.conv2d fwd + K2s statistics", cudnn_fwd_stats),
        ("K4f entry_conv_forward (y, sums)", lambda: ec.entry_conv_forward(params, x)),
        ("cuDNN fwd + conv2d_weight + bias gradient", cudnn_fwd_bwd),
        ("K4f + K4w entry_conv_wgrad", kernel_fwd_bwd),
        ("K4w entry_conv_wgrad alone", lambda: ec.entry_conv_wgrad(x, dy)),
        ("ablation stats_only (no store)", lambda: ec.entry_conv_stats(params, x)),
        ("ablation no_patch (one tap)", lambda: ec.entry_conv_ablation(params, x, "no_patch")),
        ("ablation write_only (bias broadcast)", lambda: ec.entry_conv_ablation(params, x, "write_only")),
    ]
    print(f"{'':44s} {'events':>9s}  {'on device':>9s}   (ms per call: CUDA events around one call; profiler's device time)")
    for name, fn in rows:
        print(f"{name:44s} {time_ms(fn, args.runs):9.4f}  {device_ms(fn):9.4f}   on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
