"""K3's float32 forward / dx kernel (`conv3x3_nhwc_kernel`,
csrc/packed_conv.cu) and K2b's float32 reduce pass (`bn_glu_pool_bwd_kernel`,
csrc/fused_block.cu) alone, on one NVIDIA GPU.

    python tools/bench_k3f_k2b_torch.py [--no-tests] [--variants]

Prints the card's name and power limit; the ptxas report (registers,
stack, spill) of every instantiation of the two kernels and their HGMMA /
HMMA / FFMA counts with the rest of their instruction mix (`cuobjdump
-sass` of the built library, through chip_smoke.py's `check_mma`, which
fails on a tensor-core instruction there); runs their GPU tests (`pytest
tests/test_torch_kernels_gpu.py -k "conv2d_packed or fused_block_backward
or bwd_fixup_recompute_float32 or fused_block_float32"`) unless
--no-tests; then chip_smoke.py's phase-3 rows of the two
(`chip_smoke.k3_f32_kernels` for the forward and dx at the flagship's
blocks 2 and 3 against cuDNN's `F.conv2d` and `conv2d_input`;
`chip_smoke.k2_f32_kernels` for the reduce pass alone at the three block
geometries), each against its plain version under chip_smoke.py's bars,
and a summary of device ms, bound, share of bound and the library's device
ms. With --variants it also times other launch plans of the two at the
same shapes, each held to its plain version first: the conv's pixel tile
(128 or 64) and weight slice (64 or 32 input channels); the reduce pass
with one buffer of y and dout instead of two, and with dout read from
device memory, each also without dropout. About three minutes of card time.
Imports the port only; needs a card; exits non-zero when a bar fails.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

KERNELS = ("conv3x3_nhwc_kernel", "bn_glu_pool_bwd_kernel")


def variants(device):
    """Device ms of other launch plans at the main path's shapes, each
    output first held to its plain version (the bars of chip_smoke.py)."""
    import torch

    import chip_smoke as cs
    from dcase2019_task4_tpu_torch.config import Config
    from dcase2019_task4_tpu_torch.ops import _build
    from dcase2019_task4_tpu_torch.ops import fused_block as fb
    from dcase2019_task4_tpu_torch.ops import packed_conv as pc

    cfg = Config()
    d, m, B = cfg.dsp, cfg.model, cfg.train.batch_size
    C = m.nb_filters[1]
    rng = np.random.default_rng(cs.SEED + 7)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    planned, reduce_planned = pc.conv_plan, fb.reduce_plan
    try:
        for T, Fq in ((d.max_frames // 2, d.n_mels // 4), (d.max_frames // 4, d.n_mels // 16)):
            w, b = t(rng.uniform(-0.1, 0.1, (3, 3, C, C))), t(0.1 * rng.standard_normal(C))
            x = t(rng.standard_normal((B, T, Fq, C)))
            want_f, want_dx = pc.conv2d_reference({"w": w, "b": b}, x), pc.conv2d_dx_reference(w, x)
            plan = planned(x.shape, _build.sm_count(device.index))[:2]
            print(f"  conv plans at {list(x.shape)} (the plan: {plan}): pix, kc -> forward / dx device ms")
            for pix, kc in ((128, 64), (128, 32), (64, 64), (64, 32)):
                pc.conv_plan = lambda shape, sms=None, pix=pix, kc=kc: (pix, kc, 0)
                fwd, dx = pc.conv2d_forward({"w": w, "b": b}, x), pc.conv2d_dx(w, x)
                e_f = (fwd - want_f).abs().max().item()
                e_dx = (dx - want_dx).abs().max().item() / want_dx.abs().max().item()
                if not (e_f <= 1e-4 and e_dx <= 1e-4):
                    raise AssertionError(f"conv plan ({pix}, {kc}) at {list(x.shape)}: errors {e_f}, {e_dx}")
                f_ms = cs.device_ms(lambda: pc.conv2d_forward({"w": w, "b": b}, x))
                dx_ms = cs.device_ms(lambda: pc.conv2d_dx(w, x))
                print(f"    {pix}, {kc}: {cs.shown(f_ms)} / {cs.shown(dx_ms)}")
            pc.conv_plan = planned
        pool, eps, rate = tuple(m.pooling[0]), m.bn_eps, m.dropout
        seed = torch.tensor([20190415], dtype=torch.int64)
        for T, Fq in ((d.max_frames, d.n_mels), (d.max_frames // 2, d.n_mels // 4)):
            y = t(rng.standard_normal((B, T, Fq, C)))
            vecs = (t(1 + 0.1 * rng.standard_normal(C)), t(0.1 * rng.standard_normal(C)))
            w, gb = t(rng.standard_normal((C, C)) / np.sqrt(C)), t(0.1 * rng.standard_normal(C))
            dout = t(rng.standard_normal((B, T // pool[0], Fq // pool[1], C)))
            s, sq = fb.batch_stats(y)
            mean = s / y[..., 0].numel()
            var = sq / y[..., 0].numel() - mean * mean
            args = (y, dout, *vecs, mean, var, w, gb, pool, eps)
            mask = fb.dropout_keep_mask(seed, y.shape, rate, device=device)
            ref = fb.bwd_reduce_reference(*args, mask, 1.0 - rate)
            plan = reduce_planned(C, pool)
            print(f"  reduce-pass plans at {list(y.shape)} (the plan: {plan[0]} buffers, {plan[1]} dout rows): "
                  f"device ms at rate {rate} and 0")
            for buffers, drows in ((2, plan[1]), (1, plan[1]), (1, 0)):
                fb.reduce_plan = lambda c, p, buffers=buffers, drows=drows: (buffers, drows, 0)
                got = fb.bwd_reduce(*args, rate=rate, seed=seed)
                for name, g, r in zip(("dy_partial", "dw", "db", "S1", "S2"), got, ref):
                    err, limit = (g - r).abs().max().item(), 1e-4 * r.abs().max().item()
                    if not err <= limit:
                        raise AssertionError(f"reduce pass, {buffers} buffers, {drows} dout rows, {name}: "
                                             f"{err} exceeds {limit}")
                ms = [cs.device_ms(lambda: fb.bwd_reduce(*args, rate=r, seed=seed), only="bn_glu_pool_bwd_kernel")
                      for r in (rate, 0.0)]
                print(f"    {buffers} buffer(s), {drows} dout rows: {cs.shown(ms[0])}, {cs.shown(ms[1])}")
            fb.reduce_plan = reduce_planned
            del y, dout, mask, ref, args
            torch.cuda.empty_cache()
    finally:
        pc.conv_plan, fb.reduce_plan = planned, reduce_planned


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--no-tests", action="store_true", help="skip the GPU tests of the two kernels")
    parser.add_argument("--variants", action="store_true", help="also time other launch plans of the two")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bench_k3f_k2b_torch: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from dcase2019_task4_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    info = _build.build()
    print(f"built in {info['seconds']:.1f} s")
    lines = info["log"].splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and any(k in line for k in KERNELS):
            print(line.strip())
            print("  ", " ".join(s.strip() for s in lines[i + 1:i + 4] if "bytes" in s or "registers" in s))
    cs.check_mma(info["path"])
    mix = ("FFMA", "LDS", "LDG", "LDGSTS", "STS", "STG", "BAR", "I2F", "IMAD", "ISETP")
    for name, counts in _build.sass_counts(info["path"], KERNELS, mix).items():
        print(f"{name[:90]}: " + ", ".join(f"{k} {v}" for k, v in counts.items()))

    if not args.no_tests:
        tests = subprocess.run([sys.executable, "-m", "pytest", "tests/test_torch_kernels_gpu.py", "-q",
                                "-p", "no:randomly", "-k", "conv2d_packed or fused_block_backward or "
                                "bwd_fixup_recompute_float32 or fused_block_float32"],
                               cwd=REPO, capture_output=True, text=True)
        print(tests.stdout[-3000:], tests.stderr[-2000:])
        if tests.returncode != 0:
            return tests.returncode

    device = torch.device("cuda", 0)
    rows = {name: cs.Row() for name in cs.KERNELS}
    rng = np.random.default_rng(cs.SEED)
    cs.k3_f32_kernels(device, rows, rng, which=("conv",))
    cs.k2_f32_kernels(device, rows, rng, only="reduce")
    print("row: device ms (events ms), bound ms, share of bound, library device ms")
    for name, row in rows.items():
        if not row.shapes:
            continue
        share = f"{100.0 * row.bound / row.device_ms:.1f} %" if row.device_ms else "not measured"
        print(f"  {name}: {cs.shown(row.device_ms)} ({row.ms:.4f}), {row.bound:.4f} by {row.bound_by}, {share}, "
              f"library {cs.shown(row.library_device_ms)}")
    if args.variants:
        variants(device)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
