"""K5's redesigned kernels alone, on one NVIDIA GPU: the forward in float32
and bfloat16 (`entry_block_fwd_f32_kernel`, `entry_block_fwd_bf16_kernel`,
K5f: K2f's float32 / bfloat16 forward on a conv tile), pass 1 in float32
(`entry_block_bwd_reduce_f32_kernel`, K5b1: K2b's float32 reduce pass on a
conv tile), pass 2 in float32 (`entry_block_bwd_wgrad_f32_kernel`, K5b2:
the recompute fixup's float32 tile code on a conv tile, then dW from the
dy tile), the two bfloat16 backward passes
(`entry_block_bwd_reduce_bf16_kernel`, `entry_block_bwd_wgrad_bf16_kernel`)
and the one-wave conv with and without its store (`entry_conv_run_kernel`:
K4f bf16, and K5s in bfloat16 and float32, which K6's statistics launch
too) and K4w, the entry conv's weight gradient (`entry_conv_dw_f32_kernel`,
`entry_conv_dw_bf16_kernel`), all of csrc/entry_block.cu.

    python tools/bench_k5_torch.py [--no-tests] [--variants [k4w]] [--against DIR]

Prints the card's name and power limit; the ptxas report (registers,
stack, spill) of every kernel of csrc/entry_block.cu and of K2's kernels
whose tile code they share (csrc/f32_tile.cuh, csrc/bf16_tile.cuh; a spill
of one of those fails the run at its end), and the nine kernels'
instruction mix (`cuobjdump -sass` of the built library, through
chip_smoke.py's `check_mma`: FFMA and no HMMA in the float32 ones and the
one-wave conv, HMMA in the other bfloat16 ones); runs their GPU tests
(`pytest tests/test_torch_kernels_gpu.py -k "entry_reduce_f32 or
entry_fwd_f32 or entry_wgrad_f32 or crows_float32 or entry_fwd_bf16 or
entry_bwd_bf16 or entry_block_bf16 or entry_conv_bf16 or
entry_stats_f32 or entry_conv_wgrad or
entry_conv_forward_stats_and_wgrad"`) unless
--no-tests; then chip_smoke.py's phase-3 rows of
the entry-block family at the flagship's block-1 shape (x [24, 864, 64], C =
64; `chip_smoke.entry_kernels` in float32 and `entry_bf16_kernels`, under
their bars) with device ms, bound, share of bound and the earlier kernels'
recorded reading.

With --against DIR (a checkout of another commit, e.g. the parent's `git
archive` under a directory that .gitignore lists) it measures DIR's package
and this one in the order DIR, this, this, DIR, each in a process of its own
that builds its package's kernels: the kernels' device ms at the flagship
block-1 shape (K5f float32 eval, dropout and crows, K5b2 float32; K5b1
float32; K5f bf16 eval and dropout, both layouts; K5b2 bf16 in both
partitions; K4f bf16, K5s bf16, K5s float32; K4w float32 and bf16); the
SHA-256 of the outputs of every kernel of csrc/fused_block.cu and
csrc/entry_block.cu but K5f float32, K5b2 float32 and the sums below (K2
in float32 and bfloat16 but K2s bf16, K4f, K5b1 float32, K5f bfloat16, K5's bfloat16 passes; of K4f
bf16 its y; the K5 kernels take mean and var from K2s float32 of K4f's y,
in bfloat16 from float64 sums of y, the same bits in both trees), which
must be the same in both trees, and the sums of K4f bf16, K5s in both
types and K2s bf16, which must agree within 1e-6 of their max, and K4w's
outputs (float32 dW and db; bfloat16 each parity part's float32 dW sum and
db), within 1e-5; the device time of one warm predict call from a
float32 `entry_block_pallas` checkpoint (chip_smoke.py's 48 clips); and the
device time of one traced MT step of the flagship under
`entry_block_pallas` and `entry_block_crows`, in float32 (B, R), and in
bfloat16 under the default (F) and those and `entry_conv_pallas` (FB, FR,
FC), the generator on
the card (chip_smoke.knob_card_steps, the knobs off), with block 1's device
time in a second traced step (chip_smoke.block1_device_ms).

With --variants it times other launch plans at the flagship shape: K4w
float32 and bfloat16 with tiles of 16 and 8 KB of dy and one or two blocks
an SM, and as source edits K4w streaming alone and the bfloat16 K4w at four
blocks an SM (`--variants k4w`: these alone); K5f
float32 with 1056 blocks (the earlier kernel's per-clip grid; the output
held bit for bit: it does not depend on the grid), K5b2 float32 with 528
blocks (the earlier kernel's count of slots) and with one dout buffer (dW
and d conv_b held to 1e-6 of max: a grid of other runs sums in another
order), K4f and K5s bf16 and K5s float32 with tiles of 512 and of 256
pixels (y held bit for bit, the sums to 1e-6 of max), each timed by the
profiler and by CUDA events around ten calls in a row, in turn and again
in reverse order; and, as source edits built apart, K5b2 float32 with dW
formed in registers as dy is (`DW_IN_REGISTERS`) and the one-wave conv
(K4f / K5s bf16, K5s float32) with eight channels a thread
(`CONV_EIGHT_CHANNELS`), each beside the as-built kernel, by CUDA
events. About twenty minutes of card time with both
options. Imports the port only; needs a card; exits non-zero when a bar
fails.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("entry_block_fwd_f32_kernel", "entry_block_bwd_reduce_f32_kernel", "entry_block_bwd_wgrad_f32_kernel",
           "entry_block_fwd_bf16_kernel", "entry_block_bwd_reduce_bf16_kernel", "entry_block_bwd_wgrad_bf16_kernel",
           "entry_conv_run_kernel", "entry_conv_dw_f32_kernel", "entry_conv_dw_bf16_kernel")
# K2's kernels whose tile code the six share (no name a substring of another listed one)
SHARED = ("bn_glu_pool_kernel", "bn_glu_pool_bwd_kernel", "bn_bwd_fixup_recompute_kernel", "bn_glu_pool_bf16_kernel",
          "bn_glu_pool_bwd_bf16_kernel", "bn_bwd_fixup_recompute_bf16_kernel")
ROWS = ("entry_block_fwd_eval", "entry_block_fwd_train", "crows_fwd", "entry_block_bwd_reduce", "entry_block_bwd_wgrad",
        "entry_block_fwd_eval_bf16", "entry_block_fwd_train_bf16", "crows_fwd_bf16", "entry_block_bwd_reduce_bf16",
        "entry_block_bwd_wgrad_bf16", "crows_bwd_wgrad_bf16", "entry_conv_bf16", "entry_block_stats_bf16",
        "crows_stats_bf16", "entry_block_stats", "crows_stats", "entry_conv_wgrad", "entry_conv_wgrad_bf16")
# the earlier kernels' device ms (PERF.md §6: chip_smoke.py, NVIDIA H100 80GB
# HBM3, 700.00 W): K5f and K5b2 float32, K5b1 float32 and K5f bfloat16 as
# first ported (scalar FP32 FMAs, the conv twice in K5f and K5b2 float32),
# the bfloat16 passes on the tensor cores, the bfloat16 conv as first ported
# (entry_conv_kernel<0 | 1, bf16>), K5s / K6s float32 on entry_conv_kernel<1>,
# K4w in both types on entry_conv_wgrad_kernel<TX> (528 blocks, one dy load in
# flight a thread)
RECORDED = {"entry_block_fwd_eval": 0.9370, "entry_block_fwd_train": 1.0405, "crows_fwd": 1.0390,
            "entry_block_bwd_reduce": 3.0876, "entry_block_bwd_wgrad": 2.5580, "entry_block_fwd_eval_bf16": 1.1587,
            "entry_block_fwd_train_bf16": 1.2577, "crows_fwd_bf16": 1.2235, "entry_block_bwd_reduce_bf16": 0.7042,
            "entry_block_bwd_wgrad_bf16": 0.6904, "crows_bwd_wgrad_bf16": 0.6798, "entry_conv_bf16": 0.1893,
            "entry_block_stats_bf16": 0.1373, "crows_stats_bf16": 0.1375, "entry_block_stats": 0.1267,
            "crows_stats": 0.1273, "entry_conv_wgrad": 0.2284, "entry_conv_wgrad_bf16": 0.1854}
# one traced MT step per first-block path: (flag, compute dtype); the default
# bfloat16 path (F, no flag) for K2s bf16 at all three blocks
STEP_PATHS = {"step_bf16": (None, "bfloat16"), "step_entry_block": ("entry_block_pallas", "float32"),
              "step_crows": ("entry_block_crows", "float32"),
              "step_bf16_entry_block": ("entry_block_pallas", "bfloat16"),
              "step_bf16_crows": ("entry_block_crows", "bfloat16"),
              "step_bf16_entry_conv": ("entry_conv_pallas", "bfloat16")}
SEED = 20190415
# the bar of a redesigned sum against DIR's (--against), of its max: 1e-6,
# and for K4w's dW and db 1e-5 (float32 sums of 1.3 M products a channel,
# each block's run of 52-79 time rows added in float32 before the fold;
# another plan of one tree already moves them by up to 1.7e-6)
SUM_BARS = {"K4w": 1e-5}


def flagship_inputs(device, dtype):
    """The flagship block-1 inputs in `dtype` (x [24, 864, 64], C = 64, pool
    (2, 4), dout in `dtype`) with the batch statistics of its conv, the
    model's dropout and a seed: (x, dout, vecs, pool, eps, rate, seed)."""
    import torch

    from dcase2019_task4_tpu_torch.config import Config
    from dcase2019_task4_tpu_torch.ops import fused_entry_block as fe

    cfg = Config()
    d, m = cfg.dsp, cfg.model
    B, T, Fq, C = cfg.train.batch_size, d.max_frames, d.n_mels, m.nb_filters[0]
    pool, eps, rate = tuple(m.pooling[0]), m.bn_eps, m.dropout
    rng = np.random.default_rng(SEED)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    x = t(rng.standard_normal((B, T, Fq))).to(dtype)
    lim = np.sqrt(2.0) * np.sqrt(6.0 / (9 * (1 + C)))
    conv = {"w": t(rng.uniform(-lim, lim, (3, 3, 1, C))), "b": t(0.1 * rng.standard_normal(C))}
    s1, s2 = fe.entry_block_stats_apply(conv, x)
    mean = s1 / float(B * T * Fq)
    var = s2 / float(B * T * Fq) - mean * mean
    vecs = (conv["w"], conv["b"], t(1 + 0.1 * rng.standard_normal(C)), t(0.1 * rng.standard_normal(C)), mean, var,
            t(rng.standard_normal((C, C)) / np.sqrt(C)), t(0.1 * rng.standard_normal(C)))
    dout = t(rng.standard_normal((B, T // pool[0], Fq // pool[1], C))).to(dtype)
    return x, dout, vecs, pool, eps, rate, torch.tensor([SEED], dtype=torch.int64)


def kernel_calls(device):
    """{name: call} of the kernels at the flagship shape: K5f float32
    eval, with dropout, and with dropout in the crows layout (the same
    function in float32); K5b1 float32; K5b2 float32, a and b2 from K5b1
    float32's sums; K5f bf16 eval and with dropout (planes), with dropout
    (crows); K5b1 bf16; K5b2 bf16 in the planes layout (output-frequency
    parity) and the crows layout (batch halves), a and b2 from K5b1's
    sums; K4f bf16, K5s bf16 and K5s float32; K4w float32 and bf16 on a
    seeded dy [24, 864, 64, 64] (the same numbers in both trees)."""
    import torch

    from dcase2019_task4_tpu_torch.ops import entry_conv as ec
    from dcase2019_task4_tpu_torch.ops import fused_block as fb
    from dcase2019_task4_tpu_torch.ops import fused_entry_block as fe

    x32, dout32, vecs32, pool, eps, rate, seed = flagship_inputs(device, torch.float32)
    x, dout, vecs, _, _, _, _ = flagship_inputs(device, torch.bfloat16)
    conv = {"w": vecs[0], "b": vecs[1]}
    kw = dict(rate=rate, seed=seed)
    red = fe.entry_block_bwd_reduce(x, dout, *vecs, pool, eps, **kw)
    a, b2 = fb.bwd_coefficients(vecs[2], vecs[5], eps, red[2], red[3], x.numel())
    red32 = fe.entry_block_bwd_reduce(x32, dout32, *vecs32, pool, eps, **kw)
    a32, b32 = fb.bwd_coefficients(vecs32[2], vecs32[5], eps, red32[2], red32[3], x32.numel())
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    dy32 = torch.randn(x32.shape + (vecs32[0].shape[-1],), generator=gen, device=device)
    dy = dy32.bfloat16()
    return {
        "K5f entry_block_fwd float32 eval": lambda: fe.entry_block_fwd(x32, *vecs32, pool, eps),
        "K5f entry_block_fwd float32 dropout": lambda: fe.entry_block_fwd(x32, *vecs32, pool, eps, **kw),
        "K5f entry_block_fwd float32 dropout crows": lambda: fe.entry_block_fwd(x32, *vecs32, pool, eps,
                                                                                layout="crows", **kw),
        "K5b1 entry_block_bwd_reduce float32": lambda: fe.entry_block_bwd_reduce(x32, dout32, *vecs32, pool, eps, **kw),
        "K5b2 entry_block_bwd_wgrad float32": lambda: fe.entry_block_bwd_wgrad(x32, dout32, *vecs32, a32, b32, pool,
                                                                               eps, **kw),
        "K5f entry_block_fwd bf16 eval": lambda: fe.entry_block_fwd(x, *vecs, pool, eps),
        "K5f entry_block_fwd bf16 dropout planes": lambda: fe.entry_block_fwd(x, *vecs, pool, eps, **kw),
        "K5f entry_block_fwd bf16 dropout crows": lambda: fe.entry_block_fwd(x, *vecs, pool, eps, layout="crows",
                                                                             **kw),
        "K5b1 entry_block_bwd_reduce bf16": lambda: fe.entry_block_bwd_reduce(x, dout, *vecs, pool, eps, **kw),
        "K5b2 entry_block_bwd_wgrad bf16 planes": lambda: fe.entry_block_bwd_wgrad(x, dout, *vecs, a, b2, pool, eps,
                                                                                   **kw),
        "K5b2 entry_block_bwd_wgrad bf16 crows": lambda: fe.entry_block_bwd_wgrad(x, dout, *vecs, a, b2, pool, eps,
                                                                                  layout="crows", **kw),
        "K4f entry_conv bf16": lambda: ec.entry_conv_forward(conv, x),
        "K5s entry_block_stats bf16": lambda: fe.entry_block_stats_apply(conv, x),
        "K5s entry_block_stats float32": lambda: fe.entry_block_stats_apply(conv, x32),
        "K4w entry_conv_wgrad float32": lambda: ec.entry_conv_wgrad(x32, dy32),
        "K4w entry_conv_wgrad bf16": lambda: ec.entry_conv_wgrad(x, dy),
    }


def spills(log: str) -> list:
    """The kernels (mangled names) of csrc/entry_block.cu and
    csrc/fused_block.cu whose ptxas report shows a spill."""
    lines, out = log.splitlines(), []
    for i, line in enumerate(lines):
        if "Compiling entry" in line and ("entry_block_cu" in line or "fused_block_cu" in line):
            report = " ".join(s.strip() for s in lines[i + 1:i + 4] if "spill" in s)
            if "0 bytes spill stores, 0 bytes spill loads" not in report:
                out.append(line.split("'")[1] + ": " + report)
    return out


def ptxas_report(log: str) -> int:
    """Print the ptxas lines of every kernel of csrc/entry_block.cu and of
    K2's kernels that share its tile code; → the number of instantiations of
    the four kernels and of those K2 kernels that spill (the others' spills
    are printed, and --against prints DIR's beside them)."""
    lines, spilled, seen = log.splitlines(), 0, 0
    for i, line in enumerate(lines):
        if "Compiling entry" in line and ("entry_block_cu" in line or any(k in line for k in SHARED)):
            seen += 1
            report = " ".join(s.strip() for s in lines[i + 1:i + 4] if "bytes" in s or "registers" in s)
            print(line.strip()[:150])
            print("  ", report)
            if "0 bytes spill stores, 0 bytes spill loads" not in report and any(k in line for k in KERNELS + SHARED):
                spilled += 1
    if not seen:
        raise AssertionError("no ptxas report of csrc/entry_block.cu in the build log")
    return spilled


def digest(outs) -> str:
    """The first 16 hex digits of the SHA-256 of the outputs' bytes."""
    import torch

    h = hashlib.sha256()
    for t in outs if isinstance(outs, (tuple, list)) else (outs,):
        if t is not None:
            h.update(t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def other_kernels(device, sums: dict) -> dict:
    """{call: digest} of every kernel of csrc/fused_block.cu and
    csrc/entry_block.cu but K5f float32 and K5b2 float32, on seeded
    inputs: K2 in float32 and bfloat16 at the flagship block-1 shape (C =
    64) and in bfloat16 at the scaled configuration's (C = 128), forward
    eval and train in both draws, K2s float32, the reduce pass with and
    without dy_partial, the fixup and the recompute fixup; K4's conv and
    weight gradient, K5b1 float32, K5f bfloat16 (eval, train in both draws
    and both layouts) and K5's two bfloat16 passes (K5b2 in both
    partitions) at the flagship block-1 shape. Pass 2 takes seeded a and
    b2. Of K4f bf16 the digest holds y alone: its sums, K5s's in both types
    and K2s bf16's go into `sums` as lists ({call: [Σy, Σy²]}), to be held
    to 1e-6 of max, and so do K4w's outputs (float32 [dW, db]; bfloat16
    [each parity part's float32 dW sum, db]: its rounded dW may flip an
    ulp of a part), to 1e-5 of max (SUM_BARS); the K5 kernels take their mean and var from K2s
    float32's sums of K4f's y, in bfloat16 from the float64 sums of K4f's
    y (the same bits in both trees)."""
    import torch

    from dcase2019_task4_tpu_torch.ops import entry_conv as ec
    from dcase2019_task4_tpu_torch.ops import fused_block as fb
    from dcase2019_task4_tpu_torch.ops import fused_entry_block as fe

    gen = torch.Generator(device=device).manual_seed(SEED + 1)  # the same numbers in both trees' processes
    seed = torch.tensor([SEED], dtype=torch.int64)
    out = {}

    def t(*shape, scale=1.0, shift=0.0):
        return shift + scale * torch.randn(shape, generator=gen, device=device)

    for dtype, (B, T, Fq, C) in ((torch.float32, (24, 864, 64, 64)), (torch.bfloat16, (24, 864, 64, 64)),
                                 (torch.bfloat16, (24, 864, 128, 128))):
        y = t(B, T, Fq, C).to(dtype)
        dout = t(B, T // 2, Fq // 4, C).to(dtype)
        yh = y.double()
        vecs = (t(C, scale=0.1, shift=1.0), t(C, scale=0.1), yh.mean(dim=(0, 1, 2)).float(),
                yh.var(dim=(0, 1, 2), unbiased=False).float(), t(C, C, scale=C ** -0.5), t(C, scale=0.1))
        del yh
        tag = f"{str(dtype)[6:]} {[B, T, Fq, C]}"
        if dtype == torch.float32:
            out[f"K2s {tag}"] = digest(fb.batch_stats(y))
        else:
            sums[f"K2s {tag}"] = [t.tolist() for t in fb.batch_stats(y)]
        out[f"K2f eval {tag}"] = digest(fb.fused_bn_glu_pool(y, *vecs, (2, 4), 1e-3))
        for pack in (False, True):
            kw = dict(rate=0.5, seed=seed, pack_bits=pack)
            out[f"K2f train {tag} pack {pack}"] = digest(fb.fused_bn_glu_pool(y, *vecs, (2, 4), 1e-3, **kw))
            dyp, dw, db, s1, s2 = fb.bwd_reduce(y, dout, *vecs, (2, 4), 1e-3, recompute=False, **kw)
            out[f"K2b reduce {tag} pack {pack}"] = digest((dyp, dw, db, s1, s2))
            out[f"K2b reduce nodyp {tag} pack {pack}"] = digest(
                fb.bwd_reduce(y, dout, *vecs, (2, 4), 1e-3, recompute=True, **kw))
            a, b2 = fb.bwd_coefficients(vecs[0], vecs[3], 1e-3, s1, s2, B * T * Fq)
            out[f"K2b fixup recompute {tag} pack {pack}"] = digest(
                fb.bwd_fixup_recompute(y, dout, *vecs, a, b2, (2, 4), 1e-3, **kw))
            out[f"K2b fixup {tag} pack {pack}"] = digest(fb.bwd_fixup(y, dyp, a, b2, vecs[2]))
        del y, dout, dyp
        torch.cuda.empty_cache()

    B, T, Fq, C = 24, 864, 64, 64
    conv = {"w": t(3, 3, 1, C, scale=0.3), "b": t(C, scale=0.1)}
    vecs = (t(C, scale=0.1, shift=1.0), t(C, scale=0.1))
    gw, gb = t(C, C, scale=C ** -0.5), t(C, scale=0.1)
    a, b2 = t(C, scale=1e-3), t(C, scale=1e-3)
    for dtype in (torch.float32, torch.bfloat16):
        x = t(B, T, Fq).to(dtype)
        dy = t(B, T, Fq, C).to(dtype)
        dout = t(B, T // 2, Fq // 4, C).to(dtype)
        tag = str(dtype)[6:]
        y, s1, s2 = ec.entry_conv_forward(conv, x)
        dw, db, parts = ec.entry_conv_wgrad_parts(x, dy)
        sums[f"K4w {tag}"] = [t.flatten().tolist() for t in ((dw,) if dtype == torch.float32 else tuple(parts)) + (db,)]
        if dtype == torch.bfloat16:
            out[f"K4f {tag} y"] = digest(y)
            sums[f"K4f {tag}"] = [s1.tolist(), s2.tolist()]
            yd = y.double()  # the K5 kernels' batch statistics: the same bits in both trees
            s1, s2 = yd.sum(dim=(0, 1, 2)).float(), (yd * yd).sum(dim=(0, 1, 2)).float()
            del yd
        else:
            out[f"K4f {tag}"] = digest((y, s1, s2))
            s1, s2 = fb.batch_stats(y)  # K2s float32 of K4f's y: the same bits in both trees
        sums[f"K5s {tag}"] = [t.tolist() for t in fe.entry_block_stats_apply(conv, x)]
        del y
        mean = s1 / float(B * T * Fq)
        var = s2 / float(B * T * Fq) - mean * mean
        block = (conv["w"], conv["b"], *vecs, mean, var, gw, gb)
        if dtype == torch.bfloat16:
            out[f"K5f eval {tag}"] = digest(fe.entry_block_fwd(x, *block, (2, 4), 1e-3))
        for pack in (False, True):
            kw = dict(rate=0.5, seed=seed, pack_bits=pack)
            out[f"K5b1 {tag} pack {pack}"] = digest(fe.entry_block_bwd_reduce(x, dout, *block, (2, 4), 1e-3, **kw))
            if dtype == torch.bfloat16:
                for layout in ("planes", "crows"):
                    out[f"K5f train {tag} {layout} pack {pack}"] = digest(
                        fe.entry_block_fwd(x, *block, (2, 4), 1e-3, layout=layout, **kw))
                    out[f"K5b2 {tag} {layout} pack {pack}"] = digest(
                        fe.entry_block_bwd_wgrad(x, dout, *block, a, b2, (2, 4), 1e-3, layout=layout, **kw))
        del x, dy, dout
        torch.cuda.empty_cache()
    return out


def predict_device_ms(device):
    """Device time (torch.profiler) of one warm `cli.predict` call of
    chip_smoke.py's 48 synthetic clips from its checkpoint stored with
    `entry_block_pallas=True` (float32 B: K5f once a batch): {"all": every
    kernel and copy, "K5f": the float32 forward's kernels, "copies": the
    memory copies, "rest"}, or None where the profiler gave no trace."""
    import tempfile

    import torch
    from torch.autograd import DeviceType

    import chip_smoke as cs
    from dcase2019_task4_tpu_torch import cli

    with tempfile.TemporaryDirectory() as work:
        wav_dir, (_, model_entry_block, _, _) = cs.write_inputs(work, device)
        argv = ["-m", model_entry_block, "-i", wav_dir, "-p", os.path.join(work, "events.tsv"), "--weak_fname",
                os.path.join(work, "tags.tsv"), "--device", "cuda"]
        cli.predict(argv)
        torch.cuda.synchronize()
        cs.PROFILER["lost"] = False
        prof = cs.profiled(lambda: cli.predict(argv))
    if prof is None:
        return None
    events = [(e.name, cs.event_us(e) / 1e3) for e in prof.events() if e.device_type == DeviceType.CUDA]
    parts = {"all": sum(ms for _, ms in events),
             "K5f": sum(ms for name, ms in events if "entry_block_fwd" in name),
             "copies": sum(ms for name, ms in events if "memcpy" in name.lower())}
    parts["rest"] = parts["all"] - parts["K5f"] - parts["copies"]
    return parts


def rows_from(root: str) -> int:
    """In a process of its own: the readings of the package at `root`
    (built there), as one JSON line."""
    sys.path.insert(0, root)
    import dataclasses

    import torch

    import chip_smoke as cs
    from dcase2019_task4_tpu_torch.config import Config
    from dcase2019_task4_tpu_torch.ops import _build
    from dcase2019_task4_tpu_torch.ops import fused_block as fb
    from dcase2019_task4_tpu_torch.ops import fused_mel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fused_mel.ONEDOT = fb.RECOMPUTE_FIXUP = fb.PACK_BITS = False
    log = _build.build()["log"] or (_build.BUILD_DIR / "build.log").read_text()
    device = torch.device("cuda", 0)
    card = cs.card_line()
    sums = {}
    got = {"root": root, "kernels": {}, "kernel_digests": {}, "digests": other_kernels(device, sums), "sums": sums,
           "steps": {}, "block1": {}, "spills": spills(log), "predict": predict_device_ms(device)}
    for name, call in kernel_calls(device).items():
        got["kernel_digests"][name] = digest(call())
        cs.PROFILER["lost"] = False
        got["kernels"][name] = cs.device_ms(call)
    torch.cuda.empty_cache()
    cfg = Config()
    for path, (flag, dtype) in STEP_PATHS.items():
        model = dataclasses.replace(cfg.model, compute_dtype=dtype, **({flag: True} if flag else {}))
        run = dataclasses.replace(cfg, model=model)
        cs.PROFILER["lost"] = False
        _, _, _, on_device, state = cs.knob_card_steps(device, run, path, 2, False, cs.step_data(run, device))
        got["steps"][path] = on_device
        cs.PROFILER["lost"] = False
        step, st, batch, generator, acc = state
        got["block1"][path] = cs.block1_device_ms(step, st, batch, generator, acc, path, card)
        del state, step, st, batch, generator, acc
        torch.cuda.empty_cache()
    print(json.dumps(got))
    return 0


def against(other: str) -> bool:
    """DIR's readings and this tree's, in the order DIR, this, this, DIR;
    → whether every other kernel's outputs are the same bits in both."""
    runs = []
    for root in (other, REPO, REPO, other):
        done = subprocess.run([sys.executable, os.path.abspath(__file__), "--rows-from", os.path.abspath(root)],
                              cwd=root, capture_output=True, text=True)
        lines = [line for line in done.stdout.splitlines() if line.startswith("{")]
        if done.returncode != 0 or not lines:
            print(done.stdout[-3000:], done.stderr[-3000:])
            raise AssertionError(f"measuring {root} failed")
        runs.append(json.loads(lines[-1]))

    def medians(vals):  # the median of each tree's two runs (DIR, this), or None
        for pair in ((vals[0], vals[3]), (vals[1], vals[2])):
            got = [v for v in pair if v is not None]
            yield float(np.median(got)) if got else None

    def med(key, name):
        return medians([r[key][name] for r in runs])

    def shown(v):
        return "not measured" if v is None else f"{v:.4f}"

    print(f"  {other} against this tree (medians of two runs each, device ms; DIR, this, this, DIR):")
    print("  the six kernels at the flagship block-1 shape (their outputs' SHA-256 in each run):")
    for name in runs[0]["kernels"]:
        old, new = med("kernels", name)
        ratio = f" ({old / new:.2f}x)" if old and new else ""
        repeat = all(runs[i]["kernel_digests"][name] == runs[j]["kernel_digests"][name] for i, j in ((0, 3), (1, 2)))
        print(f"    {name}: {shown(old)} -> {shown(new)}{ratio}; each tree's runs "
              f"{'bit-equal' if repeat else 'DIFFER'}; runs " + ", ".join(shown(r["kernels"][name]) for r in runs))
    differ = [name for name in runs[0]["digests"] if len({r["digests"][name] for r in runs}) != 1]
    print(f"  every other kernel of fused_block.cu and entry_block.cu, {len(runs[0]['digests'])} calls: outputs "
          + ("bit-identical in all four runs" if not differ else "DIFFER in " + ", ".join(differ)))
    for name in runs[0]["sums"]:  # the redesigned sums: near DIR's (SUM_BARS), the same bits in a tree's runs
        want = [np.asarray(v, np.float64) for v in runs[0]["sums"][name]]
        errs = [max(np.abs(np.asarray(g) - w).max() / np.abs(w).max() for g, w in zip(r["sums"][name], want))
                for r in runs]
        same = all(r["sums"][name] == runs[j]["sums"][name] for r, j in ((runs[1], 2), (runs[3], 0)))
        bar = SUM_BARS.get(name.split()[0], 1e-6)
        print(f"    {name} sums against DIR's: {max(errs):.3e} of max (bar {bar:.0e}); each tree's runs "
              f"{'bit-equal' if same else 'DIFFER'}")
        if not (max(errs) <= bar and same):
            differ.append(name)
    for label, run in (("DIR", runs[0]), ("this tree", runs[1])):
        print(f"  kernels of entry_block.cu and fused_block.cu that spill in {label}: "
              + ("; ".join(run["spills"]) or "none"))
    print("  one traced MT step's device time (chip_smoke.knob_card_steps, card generator, knobs off), and block 1:")
    for path in STEP_PATHS:
        old, new = med("steps", path)
        b_old, b_new = med("block1", path)
        delta = f" ({new - old:+.3f})" if old is not None and new is not None else ""
        print(f"    {path}: step {shown(old)} -> {shown(new)}{delta}; runs "
              + ", ".join(shown(r["steps"][path]) for r in runs)
              + f"; block 1 {shown(b_old)} -> {shown(b_new)}; runs " + ", ".join(shown(r["block1"][path]) for r in runs))
    print("  one warm predict call from a float32 entry_block_pallas checkpoint (48 clips), device time:")
    for part in ("all", "K5f", "copies", "rest"):
        vals = [r["predict"] and r["predict"][part] for r in runs]
        old, new = medians(vals)
        print(f"    {part}: {shown(old)} -> {shown(new)}; runs " + ", ".join(shown(v) for v in vals))
    return not differ


def kernel_rows(device):
    """chip_smoke.py's phase-3 rows of the entry-block family at the
    flagship's block-1 shape, float32 and bfloat16, each held to its plain
    version under chip_smoke.py's bars; the redesigned kernels' rows
    printed."""
    import torch

    import chip_smoke as cs

    rows = collections.defaultdict(cs.Row)
    cs.entry_kernels(device, rows, np.random.default_rng(cs.SEED + 6))
    torch.cuda.empty_cache()
    cs.entry_bf16_kernels(device, rows, np.random.default_rng(cs.SEED + 7))
    torch.cuda.empty_cache()
    print("row: device ms (events ms), bound ms, share of bound; plain ms; the earlier kernel (recorded)")
    for name in ROWS:
        row = rows[name]
        share = f"{100.0 * row.bound / row.device_ms:.1f} %" if row.device_ms else "not measured"
        print(f"  {name}: {cs.shown(row.device_ms)} ({row.ms:.4f}), {row.bound:.4f} by {row.bound_by}, {share}; "
              f"plain {row.plain_ms:.4f}; earlier {RECORDED[name]:.4f} ({100.0 * row.bound / RECORDED[name]:.1f} %)")


# The other placement of K5b2 float32's dW (--variants): each thread keeps
# dW of its own dy elements (MI pixels x 8 channels) in 80 registers and adds
# x[p + tap] dy over its pixels as dy is formed, with no dy tile, no barrier
# and no dW phase; one block an SM (the registers), the pixel groups' sums
# added in group order at the end. Edits of csrc/entry_block.cu (text,
# replacement, count), built apart by bench_k2_bf16_torch.ablation_libraries.
DW_IN_REGISTERS = (
    ("__launch_bounds__(kThreads, NJ == 4 ? 2 : 1)\nentry_block_bwd_wgrad_f32_kernel(",
     "__launch_bounds__(kThreads, 1)\nentry_block_bwd_wgrad_f32_kernel(", 1),
    ("  int off[5];                          // tap", """  float rw[8][9], rb[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    rb[j] = 0.0f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) rw[j][tap] = 0.0f;
  }
  int off[5];                          // tap""", 1),
    ("    dy_f32<NJ>(acc, xb, vgain, va, vb2, tpix, C, pg, cg, [&](int p, int c0, float4 d) { st4(xb + p * KS + c0, d); });\n"
     "    __syncthreads();  // dy complete\n    if (dw_on) add_dw_f32<5>(", """#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int p = pg + P::PG * i;
      if (p >= tpix) continue;
      const float* r = xt + (p / F) * FW + p % F;
      float patch[9];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) patch[tap] = r[(tap / 3) * FW + tap % 3];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c0 = h * P::H + 4 * cg;
        if (c0 >= C) continue;
        float4 g = ld4(vgain + c0), av = ld4(va + c0), bv = ld4(vb2 + c0), yc = ld4(xb + p * KS + c0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float d = at(g, e) * acc[i][4 * h + e] - at(av, e) - at(yc, e) * at(bv, e);
          rb[4 * h + e] += d;
#pragma unroll
          for (int tap = 0; tap < 9; ++tap) rw[4 * h + e][tap] = fmaf(patch[tap], d, rw[4 * h + e][tap]);
        }
      }
    }
    if (false) add_dw_f32<5>(""", 1),
    ("  float* red = smem_e;  // [S][10][CP]\n", """  {
    float* rr = smem_e;  // [PG][10][CP]
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = (j / 4) * P::H + 4 * cg + j % 4;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) rr[(pg * 10 + tap) * CP + c] = rw[j][tap];
      rr[(pg * 10 + 9) * CP + c] = rb[j];
    }
    __syncthreads();
    float* ps = partials + (long long)blockIdx.x * 10 * C;
    for (int i = tid; i < 10 * C; i += kThreads) {
      float v = 0.0f;
      for (int g = 0; g < P::PG; ++g) v += rr[(g * 10 + i / C) * CP + i % C];
      ps[i] = v;
    }
    return;
  }
  float* red = smem_e;  // [S][10][CP]
""", 1),
)

# Eight channels a thread in the one-wave conv (--variants): 72 weights and
# 32 outputs a run in registers, two blocks an SM, each pixel's channels in
# one 16-byte store. Edits of csrc/entry_block.cu, as above.
CONV_EIGHT_CHANNELS = (
    ("constexpr int kConvChans = 4;", "constexpr int kConvChans = 8;", 1),
    ("__launch_bounds__(kConvThreads, 4)\nentry_conv_run_kernel(",
     "__launch_bounds__(kConvThreads, 2)\nentry_conv_run_kernel(", 1),
    ("*reinterpret_cast<uint2*>(yp + j * C) = make_uint2(packed[0], packed[1]);",
     "*reinterpret_cast<uint4*>(yp + j * C) = make_uint4(packed[0], packed[1], packed[2], packed[3]);", 1),
)


# K4w streaming alone (--variants, an ablation: outputs not held): float32
# with its dW loop compiled out (dy and x still staged by cp.async a tile
# ahead), bfloat16 without the patches' gather and the products (dy still
# staged). Edits of csrc/entry_block.cu, as above.
K4W_STREAM_ONLY = (
    ("    if (sh < S) add_dw_f32<10>(", "    if (false) add_dw_f32<10>(", 1),
    ("    if (next < r_end) gather(pv, next);", "    if (false) gather(pv, next);", 1),
    ("    for (int j = 0; j < kDwTilePix / 16 / NS; ++j) {", "    for (int j = 0; j < 0; ++j) {", 1),
)
# The bfloat16 K4w with registers capped for four blocks an SM (--variants),
# as above.
K4W_BF16_FOUR_BLOCKS = (
    ("__launch_bounds__(kDwThreads)\nentry_conv_dw_bf16_kernel(",
     "__launch_bounds__(kDwThreads, 4)\nentry_conv_dw_bf16_kernel(", 1),
)


class _Swapped:
    """A library whose `entries` come from `variant`, the rest from
    `main`."""

    def __init__(self, variant, main, entries):
        self.variant, self.main, self.entries = variant, main, entries

    def __getattr__(self, name):
        return getattr(self.variant if name in self.entries else self.main, name)


def ablation_bounds():
    """Print the bounds of the three ablation modes of K4f's kernel
    (`entry_conv_kernel<MODE>`, the Pallas ablations of
    tools/bench_entry_conv.py:171, timed by tools/bench_entry_conv_torch.py)
    at the flagship block-1 shape, from chip_smoke.py's byte and operation
    counts of K4f and K5s: statistics only (x read; the conv and the sums,
    as K5s), one tap (x read, y written; one FMA an element and the sums)
    and the bias written alone (y written)."""
    import chip_smoke as cs
    from dcase2019_task4_tpu_torch.config import Config

    cfg = Config()
    B, T, Fq, C = cfg.train.batch_size, cfg.dsp.max_frames, cfg.dsp.n_mels, cfg.model.nb_filters[0]
    pixels = B * T * Fq
    x_bytes, y_bytes, small = pixels * 4, pixels * C * 4, (10 * C + C * C + 5 * C) * 4
    modes = (("stats only (K5s's counts)", x_bytes + small, 2.0 * 9 * pixels * C + 3.0 * pixels * C),
             ("one tap", x_bytes + y_bytes + small, 2.0 * pixels * C + 3.0 * pixels * C),
             ("write only", y_bytes + small, 0.0))
    print(f"  ablation bounds of entry_conv_kernel at {[B, T, Fq, C]}: " + "; ".join(
        f"{name} {cs.bound_ms(n_bytes, n_ops)[0]:.4f} ms by {cs.bound_ms(n_bytes, n_ops)[1]}"
        for name, n_bytes, n_ops in modes))


def variants(device):
    """Device ms (the profiler) and ms (CUDA events around ten calls in a
    row, a tenth of it) of other launch plans at the flagship shape, each
    plan in turn and then in reverse order: K5f float32 with 1056 blocks
    (the earlier kernel's per-clip grid), K5b2 float32 with 528 blocks (the
    earlier kernel's slots) and with one dout buffer; K4f and K5s bf16 with
    tiles of 512 and 256 pixels; then, each from its own library beside the
    as-built kernel, by CUDA events: K5b2 float32 with dW in registers
    (DW_IN_REGISTERS) and K4f / K5s bf16 with eight channels a thread
    (CONV_EIGHT_CHANNELS). K5f's output and K4f's y held to the
    as-built kernel's bits, K5b2's dW and d conv_b and the conv's sums to
    1e-6 of their max (d conv_b with a floor of 1e-6 of dW's: another plan
    sums in another order)."""
    import torch

    import chip_smoke as cs
    from dcase2019_task4_tpu_torch.ops import _build
    from dcase2019_task4_tpu_torch.ops import fused_block as fb
    from dcase2019_task4_tpu_torch.ops import fused_entry_block as fe

    x, dout, vecs, pool, eps, rate, seed = flagship_inputs(device, torch.float32)
    kw = dict(rate=rate, seed=seed)
    forward = lambda: fe.entry_block_fwd(x, *vecs, pool, eps, **kw)  # noqa: E731
    red = fe.entry_block_bwd_reduce(x, dout, *vecs, pool, eps, **kw)
    a, b2 = fb.bwd_coefficients(vecs[2], vecs[5], eps, red[2], red[3], x.numel())
    wgrad = lambda: fe.entry_block_bwd_wgrad(x, dout, *vecs, a, b2, pool, eps, **kw)  # noqa: E731
    built = {"K5f float32 dropout": [forward()], "K5b2 float32": wgrad()}

    def held(name, outs):
        outs = outs if isinstance(outs, (tuple, list)) else [outs]
        if name.startswith("K5f"):
            if not all(torch.equal(p, q) for p, q in zip(outs, built[name])):
                raise AssertionError(f"{name} depends on its launch plan")
            return "bit-equal to the as-built kernel"
        floor = 1e-6 * built[name][0].abs().max().item()
        errs = [(p - q).abs().max().item() / (1e-6 * q.abs().max().item() + (floor if k else 0.0))
                for k, (p, q) in enumerate(zip(outs, built[name]))]
        if not max(errs) <= 1.0:
            raise AssertionError(f"{name}: another plan moves dW or d conv_b by more than 1e-6 of max")
        return f"within {max(errs):.3f} of the 1e-6-of-max bar of the as-built kernel"

    def timed(fn):
        return cs.time_ms(lambda: [fn() for _ in range(10)]) / 10

    grid, plan = _build.wave_grid, fe.f32_wgrad_plan
    one_buffer = lambda C, p: (1,) + plan(C, p)[1:]  # noqa: E731
    cases = (("K5f float32 dropout", forward, "as built (one wave)", grid, plan),
             ("K5f float32 dropout", forward, "1056 blocks (the earlier per-clip grid)", lambda *a, **k: 1056, plan),
             ("K5b2 float32", wgrad, "as built (one wave)", grid, plan),
             ("K5b2 float32", wgrad, "528 blocks (the earlier kernel's slots)", lambda *a, **k: 528, plan),
             ("K5b2 float32", wgrad, "one dout buffer", grid, one_buffer))
    print("  launch plans at the flagship shape, each timed in turn and again in reverse order (device ms from "
          "the profiler; ms by CUDA events around ten calls in a row):")
    try:
        for name, call, label, g, p in cases + cases[::-1]:
            _build.wave_grid, fe.f32_wgrad_plan = g, p
            cs.PROFILER["lost"] = False
            print(f"    {name}, {label}: device {cs.shown(cs.device_ms(call))}, events {timed(call):.4f} "
                  f"({held(name, call())})")
    finally:
        _build.wave_grid, fe.f32_wgrad_plan = grid, plan

    # the one-wave conv (K4f, K5s bf16; K5s float32): channels a thread and
    # tile heights; y does not depend on the plan, the sums are held to 1e-6
    # of max of the as-built plan's
    from dcase2019_task4_tpu_torch.ops import entry_conv as ec

    xb = flagship_inputs(device, torch.bfloat16)[0]
    conv = {"w": vecs[0], "b": vecs[1]}
    k4f, k5s = lambda: ec.entry_conv_forward(conv, xb), lambda: fe.entry_block_stats_apply(conv, xb)  # noqa: E731
    k5s32 = lambda: fe.entry_block_stats_apply(conv, x)  # noqa: E731
    y0, s0, q0 = k4f()
    sums32 = k5s32()

    def conv_held(out):
        y, s1, s2 = out if len(out) == 3 else (y0, *out)
        if not torch.equal(y, y0):
            raise AssertionError("K4f bf16's y depends on its plan")
        return sums_held((s1, s2), (s0, q0))

    def sums_held(got, want):
        err = max((p - q).abs().max().item() / q.abs().max().item() for p, q in zip(got, want))
        if not err <= 1e-6:
            raise AssertionError(f"the one-wave conv's sums move by {err:.3e} of max under another plan")
        return f"sums within {err:.2e} of max of the as-built kernel's"

    pixels = ec._CONV_TILE_PIXELS
    heights = (("as built", pixels), ("tiles of 512 pixels", 512), ("tiles of 256 pixels", 256))
    convs = (("K4f bf16", k4f, lambda: "y bit-equal, " + conv_held(k4f())),
             ("K5s bf16", k5s, lambda: conv_held(k5s())), ("K5s float32", k5s32, lambda: sums_held(k5s32(), sums32)))
    print("  the one-wave conv's tile heights at the flagship shape (as above):")
    try:
        for label, tile_pixels in heights + heights[::-1]:
            ec._CONV_TILE_PIXELS = tile_pixels
            for name, call, check in convs:
                cs.PROFILER["lost"] = False
                print(f"    {name}, {label} ({ec.conv_run_plan(xb.shape[2], 64)[0]} rows): device "
                      f"{cs.shown(cs.device_ms(call))}, events {timed(call):.4f} ({check()})")
    finally:
        ec._CONV_TILE_PIXELS = pixels

    # edits of the source, each from its own library (built together: one
    # library path each), by CUDA events only (the profiler traces nothing
    # once a second CUDA library is loaded), in turn with the as-built kernel
    # and again in reverse order: K5b2 float32's dW in registers, the
    # one-wave conv's eight channels a thread
    import bench_k2_bf16_torch as k2

    main_lib = _build.library
    edited = {  # label: (edits, the library's entries they change, (name, call, check) of the timed calls)
        "K5b2 float32 with dW in registers (one block an SM)": (
            DW_IN_REGISTERS, ("dcase_entry_block_bwd_wgrad", "dcase_entry_block_bwd_wgrad_resident"),
            (("K5b2 float32", wgrad, lambda: held("K5b2 float32", wgrad())),)),
        "K4f / K5s bf16, K5s float32 with eight channels a thread (16-byte stores)": (
            CONV_EIGHT_CHANNELS,
            ("dcase_entry_conv", "dcase_entry_conv_bf16_resident", "dcase_entry_conv_f32_resident"),
            convs),
    }
    libraries = k2.ablation_libraries(tuple((label, edits) for label, (edits, _, _) in edited.items()), "entry_",
                                      "entry_block.cu")
    for label, lib, ptxas in libraries:
        _, entries, calls = edited[label]
        spills = [line for line in ptxas if "0 bytes spill stores, 0 bytes spill loads" not in line]
        print(f"  {label}: ptxas of {len(ptxas)} kernels of entry_block.cu, spills: " + ("; ".join(spills) or "none"))
        if lib is None:
            continue
        swapped = _Swapped(lib, main_lib(), entries)
        if "dcase_entry_conv_bf16_resident" in entries:
            print(f"    blocks an SM, bfloat16 / float32: {lib.dcase_entry_conv_bf16_resident()} / "
                  f"{lib.dcase_entry_conv_f32_resident()} (as built {main_lib().dcase_entry_conv_bf16_resident()} / "
                  f"{main_lib().dcase_entry_conv_f32_resident()})")
        try:
            for as_built in (True, False, False, True):
                _build.library = main_lib if as_built else (lambda: swapped)
                _build.resident.cache_clear()
                for name, call, check in calls:
                    print(f"    {name}, {'as built' if as_built else 'the edit'}: events {timed(call):.4f} ({check()})")
        finally:
            _build.library = main_lib
            _build.resident.cache_clear()


def wgrad_variants(device):
    """K4w's launch plans at the flagship shape (x [24, 864, 64], C = 64,
    the dy of `kernel_calls`), each timed by the profiler (device ms, the
    fold included) and by CUDA events around ten calls in a row, in turn and
    again in reverse order: tiles of 16 and 8 KB of dy beside the as-built
    32 KB (float32 one row against two; bfloat16 tiles hold at most 128
    pixels, two rows, so there 8 KB is one row), and the as-built plan on one
    or two blocks an SM (the grid cut). Outputs held to the as-built
    plan's: float32 dW and db, bfloat16 each parity part's float32 sum and
    db, within 1e-5 of their max (another plan sums in another order). Then
    the as-built kernels beside their streaming alone (K4W_STREAM_ONLY) and
    the bfloat16 kernel at four blocks an SM (K4W_BF16_FOUR_BLOCKS), each
    built apart, by CUDA events."""
    import torch

    import chip_smoke as cs
    from dcase2019_task4_tpu_torch.ops import _build
    from dcase2019_task4_tpu_torch.ops import entry_conv as ec

    x32 = flagship_inputs(device, torch.float32)[0]
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    dy32 = torch.randn(x32.shape + (64,), generator=gen, device=device)
    inputs = {"float32": (x32, dy32), "bf16": (x32.bfloat16(), dy32.bfloat16())}
    sm = _build.sm_count(0)

    def outs(x, dy):
        dw, db, parts = ec.entry_conv_wgrad_parts(x, dy)
        return [dw] + [db] if x.dtype == torch.float32 else list(parts) + [db]

    def timed(fn):
        return cs.time_ms(lambda: [fn() for _ in range(10)]) / 10

    tile_bytes, resident = ec._DW_TILE_BYTES, _build.resident
    plans = [("as built", tile_bytes, None)] + [(f"tiles of {b // 1024} KB", b, None) for b in (16384, 8192)]
    plans += [(f"as built, {k} block(s) an SM", tile_bytes, k) for k in (1, 2)]
    print("  K4w's launch plans at the flagship shape, in turn and again in reverse order (device ms from the "
          "profiler, the fold included; ms by CUDA events around ten calls in a row):")
    for dtype, (x, dy) in inputs.items():
        built = outs(x, dy)
        try:
            for label, b, blocks in plans + plans[::-1]:
                ec._DW_TILE_BYTES = b
                _build.resident = resident if blocks is None else (lambda *a, k=blocks: k * sm)
                rows, smem = ec.wgrad_plan(x.shape[2], 64, x.dtype)
                got = outs(x, dy)
                err = max((p - q).abs().max().item() / q.abs().max().item() for p, q in zip(got, built))
                if not err <= 1e-5:
                    raise AssertionError(f"K4w {dtype} under {label}: {err:.3e} of max from the as-built plan")
                call = lambda: ec.entry_conv_wgrad(x, dy)  # noqa: E731
                cs.PROFILER["lost"] = False
                held = _build.wave_grid(_build.resident(0, "conv_wgrad", int(dtype == "bf16"), 64, 64, rows),
                                        x.shape[0], x.shape[1])
                print(f"    K4w {dtype}, {label} ({rows} row(s), {smem} bytes, {held} blocks): device "
                      f"{cs.shown(cs.device_ms(call))}, events {timed(call):.4f} (within {err:.1e} of max)")
        finally:
            ec._DW_TILE_BYTES, _build.resident = tile_bytes, resident

    # the streaming floor of the as-built plan (K4w with its products
    # compiled out, K4W_STREAM_ONLY) and the bfloat16 kernel at four blocks
    # an SM (K4W_BF16_FOUR_BLOCKS), each built apart and timed by CUDA events
    # beside the as-built kernel (no profiler once a second library is
    # loaded); the four-block kernel's outputs held as above
    import bench_k2_bf16_torch as k2

    main_lib = _build.library
    edited = {"K4w streaming alone": (K4W_STREAM_ONLY, ("float32", "bf16")),
              "K4w bf16 at four blocks an SM": (K4W_BF16_FOUR_BLOCKS, ("bf16",))}
    want = {dtype: outs(x, dy) for dtype, (x, dy) in inputs.items()}
    libraries = k2.ablation_libraries(tuple((label, edits) for label, (edits, _) in edited.items()),
                                      "entry_conv_dw_", "entry_block.cu")
    for label, lib, ptxas in libraries:
        print(f"  {label}: ptxas " + "; ".join(ptxas))
        if lib is None:
            continue
        swapped = _Swapped(lib, main_lib(), ("dcase_entry_conv_wgrad", "dcase_entry_conv_wgrad_resident"))
        try:
            for as_built in (True, False, False, True):
                _build.library = main_lib if as_built else (lambda: swapped)
                _build.resident.cache_clear()
                for dtype in edited[label][1]:
                    x, dy = inputs[dtype]
                    rows = ec.wgrad_plan(64, 64, x.dtype)[0]
                    blocks = _build.wave_grid(_build.resident(0, "conv_wgrad", int(dtype == "bf16"), 64, 64, rows),
                                              x.shape[0], x.shape[1])
                    note = ""
                    if label != "K4w streaming alone":  # an ablation's outputs are not the function's
                        err = max((p - q).abs().max().item() / q.abs().max().item()
                                  for p, q in zip(outs(x, dy), want[dtype]))
                        if not err <= 1e-5:
                            raise AssertionError(f"K4w {dtype}, {label}: {err:.3e} of max from the as-built kernel")
                        note = f"; within {err:.1e} of max"
                    print(f"    K4w {dtype}, {'as built' if as_built else label} ({blocks} blocks): events "
                          f"{timed(lambda: ec.entry_conv_wgrad(x, dy)):.4f}{note}")
        finally:
            _build.library = main_lib
            _build.resident.cache_clear()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--no-tests", action="store_true", help="skip the kernels' GPU tests")
    parser.add_argument("--variants", nargs="?", const="all", choices=("all", "k4w"),
                        help="also time other launch plans (k4w: K4w's alone)")
    parser.add_argument("--against", metavar="DIR", help="also measure the package in DIR beside this one")
    parser.add_argument("--rows-from", metavar="DIR", help=argparse.SUPPRESS)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bench_k5_torch: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if args.rows_from:
        return rows_from(args.rows_from)
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from dcase2019_task4_tpu_torch.ops import _build
    from dcase2019_task4_tpu_torch.ops import fused_block as fb
    from dcase2019_task4_tpu_torch.ops import fused_entry_block as fe
    from dcase2019_task4_tpu_torch.ops import fused_mel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fused_mel.ONEDOT = fb.RECOMPUTE_FIXUP = fb.PACK_BITS = False
    print(cs.card_line())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    info = _build.build()
    print(f"built in {info['seconds']:.1f} s")
    log = info["log"] or (_build.BUILD_DIR / "build.log").read_text()
    spilled = ptxas_report(log)
    cs.check_mma(info["path"])
    mix = ("HMMA", "FFMA", "FADD", "FMUL", "MUFU", "LDS", "LDSM", "LDGSTS", "STS", "LDG", "STG", "BAR", "SHFL")
    for name, counts in _build.sass_counts(info["path"], KERNELS, mix).items():
        print(f"{name[:90]}: " + ", ".join(f"{k} {v}" for k, v in counts.items()))

    if not args.no_tests:
        tests = subprocess.run([sys.executable, "-m", "pytest", "tests/test_torch_kernels_gpu.py", "-q", "-s",
                                "-p", "no:randomly", "-k",
                                "entry_reduce_f32 or entry_fwd_f32 or entry_wgrad_f32 or crows_float32 or "
                                "entry_fwd_bf16 or entry_bwd_bf16 or entry_block_bf16 or entry_conv_bf16 or "
                                "entry_stats_f32 or entry_conv_wgrad or entry_conv_forward_stats_and_wgrad"],
                               cwd=REPO, capture_output=True, text=True)
        print(tests.stdout[-3000:], tests.stderr[-2000:])
        if tests.returncode != 0:
            return tests.returncode

    device = torch.device("cuda", 0)
    sm = _build.sm_count(0)
    for C in (16, 64, 96, 128):
        for pool in ((2, 4), (1, 1)):
            for what, planned, kernel in (("K5b1", fe.f32_reduce_plan, "reduce_f32"),
                                          ("K5b2", fe.f32_wgrad_plan, "wgrad_f32")):
                buffers, drows, nbytes = planned(C, pool)
                print(f"{what} float32 at C = {C}, pool {pool}: {buffers} buffer(s) of {drows} dout rows, {nbytes} "
                      f"bytes; {_build.resident(0, kernel, C, buffers, drows)} blocks held at once on {sm} SMs")
        print(f"K5f float32 at C = {C}: {fe.fwd_f32_plan(C)} bytes; {_build.resident(0, 'fwd_f32', C)} blocks held "
              f"at once; K5f bf16: {fe.fwd_bf16_plan(C)} bytes; {_build.resident(0, 'fwd_bf16', C)} blocks held at once")
    from dcase2019_task4_tpu_torch.ops import entry_conv as ec

    print(f"K4f / K5s bf16, K5s float32 at F = 64, C = 64: (rows, halo, smem) {ec.conv_run_plan(64, 64)}; "
          f"{_build.resident(0, 'conv_bf16')} / {_build.resident(0, 'conv_f32')} blocks held at once")
    for dtype in (torch.float32, torch.bfloat16):
        rows, smem = ec.wgrad_plan(64, 64, dtype)
        print(f"K4w {str(dtype)[6:]} at F = 64, C = 64: {rows} row(s) a tile, {smem} bytes; "
              f"{_build.resident(0, 'conv_wgrad', int(dtype == torch.bfloat16), 64, 64, rows)} blocks held at once")
    kernel_rows(device)
    ablation_bounds()
    same = True
    if args.against:
        same = against(args.against)
    if args.variants:
        wgrad_variants(device)
    if args.variants == "all":
        variants(device)
    print(cs.card_line())
    if spilled:
        print(f"bench_k5_torch: {spilled} instantiation(s) spill", file=sys.stderr)
        return 1
    if not same:
        print("bench_k5_torch: another kernel's outputs differ from DIR's", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
