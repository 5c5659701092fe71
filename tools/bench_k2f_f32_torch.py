"""K2's float32 forward (`bn_glu_pool_kernel`, csrc/fused_block.cu: BN ->
GLU -> dropout -> pool, eval and train) alone, on one NVIDIA GPU.

    python tools/bench_k2f_f32_torch.py [--no-tests] [--variants] [--against DIR]

Prints the card's name and power limit; the ptxas report (registers,
stack, spill) of both instantiations (a spill fails the run at its end) and
their FFMA / HMMA / HGMMA counts with the rest of their instruction mix
(`cuobjdump -sass` of the built library, through chip_smoke.py's
`check_mma`, which fails on a tensor-core instruction there or without
FFMA); runs the kernel's GPU tests (`pytest tests/test_torch_kernels_gpu.py
-k "fused_bn_glu_pool or fused_block_float32_in_window"`) unless
--no-tests; then chip_smoke.py's phase-3 K2f rows (`chip_smoke.
k2_f32_kernels(only="forward")`: eval and train at the flagship's three
block geometries, [24, 864, 64, 64], [24, 432, 16, 64], [24, 216, 4, 64],
against `reference_block` at 1e-5, the kept count against
`dropout_keep_mask`'s) and a summary of device ms, bound and share of bound
beside the earlier design's recorded reading. With --against DIR (a checkout of
another commit, e.g. the parent's `git archive` under a directory that
.gitignore lists) it times the eval and train forward of DIR's package and
of this one on the same inputs, in the order DIR, this, this, DIR, each in
a process of its own that builds its package's kernels. With --variants it
times, at block 1's shape, source variants of the kernel (`VARIANTS`: 8 x 8
tiles, the pool from shared memory instead of by shuffles, the product
loop unrolled by two, no register bound, the IEEE sigmoid, the sigmoid,
the product or the centring left out), each csrc/fused_block.cu edited
and built alone into a library of its own (all compilers started
together); a variant that computes the function is first held to the plain
version at 1e-5; both are timed by CUDA events around ten calls in a row
(the profiler traces nothing once a second library is loaded, and drops
events now and then). Two
to five minutes of card time. Imports the port only; needs a card; exits
non-zero when a bar fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL = "bn_glu_pool_kernel"
ROWS = ("fused_bn_glu_pool_eval", "fused_bn_glu_pool_train")
# the earlier design (one shared-memory product of 8 pixels x 4 channels a thread; PERF.md §6: chip_smoke.py,
# NVIDIA H100 80GB HBM3, 700.00 W), device ms over the three shapes
RECORDED = {"fused_bn_glu_pool_eval": 0.9195, "fused_bn_glu_pool_train": 1.0365}
SEED = 20190413

# (name, computes the function, edits): each edit (text, replacement, count) applied to csrc/fused_block.cu
VARIANTS = (
    ("as built", True, ()),
    ("8 x 8 register tiles, 128 threads at C <= 64", True,
     (("static constexpr int MI = NJ == 4 ? 4 : 8;", "static constexpr int MI = 8;", 1),)),
    ("the pool from shared memory at block 1's geometry too", True,
     (("if constexpr (PG == 32 && CG == 8) by_shuffles =", "if constexpr (false) by_shuffles =", 1),)),
    ("sigmoid by expf and a true division (IEEE)", True,
     (("at(gb, e)) * __fdividef(1.0f, 1.0f + __expf(-xn))", "at(gb, e)) * sigmoidf(xn)", 1),)),
    ("the product loop unrolled by two", True,
     (("      for (int kq = 0; kq < nq; ++kq) {\n        float4 a[MI];",
       "#pragma unroll 2\n      for (int kq = 0; kq < nq; ++kq) {\n        float4 a[MI];", 1),)),
    ("no register bound for two blocks an SM at C <= 64", True,
     (("static constexpr int MIN_BLOCKS = NJ == 4 ? 2 : 1;", "static constexpr int MIN_BLOCKS = 1;", 1),)),
    ("without the sigmoid (g = (lin + b) xn)", False,
     (("at(gb, e)) * __fdividef(1.0f, 1.0f + __expf(-xn))", "at(gb, e)) * xn", 1),)),
    ("without lin", False, (("for (int kq = 0; kq < nq; ++kq) {\n        float4 a[MI];",
                             "for (int kq = 0; kq < 0; ++kq) {\n        float4 a[MI];", 1),)),
    ("without the centring (y read as x-hat)", False,
     (("for (int p = tid / Q; p < tpix; p += DP) {", "for (int p = tid / Q; p < 0; p += DP) {", 1),)),
)


def geometries():
    """(B, T, F, C, pool, eps, rate) at the flagship's three blocks."""
    from dcase2019_task4_tpu_torch.config import Config

    cfg = Config()
    d, m = cfg.dsp, cfg.model
    B, C = cfg.train.batch_size, m.nb_filters[1]
    shapes = ((d.max_frames, d.n_mels), (d.max_frames // 2, d.n_mels // 4), (d.max_frames // 4, d.n_mels // 16))
    return [(B, T, Fq, C, tuple(m.pooling[0]), m.bn_eps, m.dropout) for T, Fq in shapes]


def inputs(device):
    """[(y, (scale, bias, mean, var, glu_w, glu_b), pool, eps, rate)] at the
    three geometries, from SEED."""
    import torch

    rng = np.random.default_rng(SEED)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    out = []
    for B, T, Fq, C, pool, eps, rate in geometries():
        y = t(rng.standard_normal((B, T, Fq, C)))
        vecs = (t(1 + 0.1 * rng.standard_normal(C)), t(0.1 * rng.standard_normal(C)), t(0.2 * rng.standard_normal(C)),
                t(rng.uniform(0.5, 2.0, C)), t(rng.standard_normal((C, C)) / np.sqrt(C)), t(0.1 * rng.standard_normal(C)))
        out.append((y, vecs, pool, eps, rate))
    return out


def rows_from(root: str) -> int:
    """In a process of its own: the eval and train forward of the package at
    `root` (built there), device ms (profiler) and ms (CUDA events) summed
    over the three shapes, as one JSON line."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from dcase2019_task4_tpu_torch.ops import _build
    from dcase2019_task4_tpu_torch.ops import fused_block as fb

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    seed = torch.tensor([SEED], dtype=torch.int64)
    got = {"root": root, "device_ms": {}, "ms": {}}
    for name, train in zip(ROWS, (False, True)):
        dev, ev = 0.0, 0.0
        for y, vecs, pool, eps, rate in inputs(torch.device("cuda", 0)):
            r = rate if train else 0.0
            call = lambda: fb.fused_bn_glu_pool(y, *vecs, pool, eps, rate=r, seed=seed)  # noqa: E731
            d = cs.device_ms(call, only=KERNEL)
            dev = None if dev is None or d is None else dev + d
            ev += cs.time_ms(call)
        got["device_ms"][name], got["ms"][name] = dev, ev
    print(json.dumps(got))
    return 0


def against(other: str):
    """DIR's forward and this package's, in the order DIR, this, this, DIR."""
    print(f"  the eval / train forward of {other} and of this tree: device ms (events ms), summed over the three shapes")
    for root in (other, REPO, REPO, other):
        done = subprocess.run([sys.executable, os.path.abspath(__file__), "--rows-from", os.path.abspath(root)],
                              cwd=root, capture_output=True, text=True)
        lines = [line for line in done.stdout.splitlines() if line.startswith("{")]
        if done.returncode != 0 or not lines:
            print(done.stdout[-2000:], done.stderr[-3000:])
            raise AssertionError(f"timing the forward of {root} failed")
        got = json.loads(lines[-1])
        label = "this tree" if os.path.abspath(root) == os.path.abspath(REPO) else root
        shown = ["not measured" if got["device_ms"][n] is None else f"{got['device_ms'][n]:.4f}" for n in ROWS]
        print(f"    {label}: eval {shown[0]} ({got['ms'][ROWS[0]]:.4f}), train {shown[1]} ({got['ms'][ROWS[1]]:.4f})")


def ptxas_report(log: str) -> int:
    """Print the ptxas lines of the kernel's instantiations; the number that
    spill."""
    lines, spilled, seen = log.splitlines(), 0, 0
    for i, line in enumerate(lines):
        if "Compiling entry" in line and KERNEL in line:
            seen += 1
            report = " ".join(s.strip() for s in lines[i + 1:i + 4] if "bytes" in s or "registers" in s)
            print(line.strip()[:150])
            print("  ", report)
            if "0 bytes spill stores, 0 bytes spill loads" not in report:
                spilled += 1
    if seen != 2:
        raise AssertionError(f"{seen} ptxas reports of {KERNEL}, expected 2 (<4> and <8>)")
    return spilled


def source_variants(device):
    """ms of each VARIANTS build at block 1's shape, eval / train: CUDA events
    around ten calls in a row (the card's time: the wrapper's host work
    overlaps the previous call), a tenth of it; a variant that computes the
    function held to the plain version first."""
    import torch

    sys.path.insert(0, os.path.join(REPO, "tools"))
    import bench_k2_bf16_torch as k2b
    import chip_smoke as cs
    from dcase2019_task4_tpu_torch.ops import _build
    from dcase2019_task4_tpu_torch.ops import fused_block as fb

    seed = torch.tensor([SEED], dtype=torch.int64)
    data = inputs(device)[:1]
    refs = []
    for y, v, p, e, rate in data:
        mask = fb.dropout_keep_mask(seed, y.shape, rate, device=device)
        refs.append([fb.reference_block(y, *v, p, e), fb.reference_block(y, *v, p, e, mask, 1.0 - rate)])
        del mask
    library = _build.library
    print(f"  source variants at {list(data[0][0].shape)}: eval / train ms (CUDA events, ten calls in a row); ptxas")
    try:
        for (name, exact, _), (_, lib, ptxas) in zip(VARIANTS, k2b.ablation_libraries(
                tuple((n, edits) for n, _, edits in VARIANTS), KERNEL)):
            if lib is None:
                continue
            _build.library = lambda lib=lib: lib
            total, worst = [0.0, 0.0], 0.0
            for (y, v, p, e, rate), ref in zip(data, refs):
                for k, r in enumerate((0.0, rate)):
                    fn = lambda: fb.fused_bn_glu_pool(y, *v, p, e, rate=r, seed=seed)  # noqa: E731
                    if exact:
                        worst = max(worst, (fn() - ref[k]).abs().max().item())
                    total[k] += cs.time_ms(lambda: [fn() for _ in range(10)]) / 10
            held = f", largest error {worst:.3e} of 1e-5" if exact else " (computes something else)"
            print(f"    {name}: {total[0]:.4f} / {total[1]:.4f}{held}; ptxas " + "; ".join(ptxas))
            if exact and not worst <= 1e-5:
                raise AssertionError(f"variant {name!r}: error {worst} exceeds 1e-5")
    finally:
        _build.library = library


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--no-tests", action="store_true", help="skip the kernel's GPU tests")
    parser.add_argument("--variants", action="store_true", help="also time source variants of the kernel")
    parser.add_argument("--against", metavar="DIR", help="also time the forward of the package in DIR beside this one")
    parser.add_argument("--rows-from", metavar="DIR", help=argparse.SUPPRESS)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bench_k2f_f32_torch: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if args.rows_from:
        return rows_from(args.rows_from)
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from dcase2019_task4_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    info = _build.build()
    print(f"built in {info['seconds']:.1f} s")
    log = info["log"] or (_build.BUILD_DIR / "build.log").read_text()
    spilled = ptxas_report(log)
    cs.check_mma(info["path"])
    mix = ("FFMA", "FADD", "FMUL", "MUFU", "LDS", "LDGSTS", "STS", "STG", "BAR", "IMAD", "LOP3", "SHFL", "I2F")
    for name, counts in _build.sass_counts(info["path"], (KERNEL,), mix).items():
        print(f"{name[:90]}: " + ", ".join(f"{k} {v}" for k, v in counts.items()))

    if not args.no_tests:
        tests = subprocess.run([sys.executable, "-m", "pytest", "tests/test_torch_kernels_gpu.py", "-q",
                                "-p", "no:randomly", "-k", "fused_bn_glu_pool or fused_block_float32_in_window"],
                               cwd=REPO, capture_output=True, text=True)
        print(tests.stdout[-3000:], tests.stderr[-2000:])
        if tests.returncode != 0:
            return tests.returncode

    device = torch.device("cuda", 0)
    from dcase2019_task4_tpu_torch.ops import fused_block as fb

    C = geometries()[0][3]
    print(f"plan at C = {C}: {fb.forward_plan(C)} bytes of shared memory a block; "
          f"{fb._forward_blocks(0, C)} blocks held at once on {_build.sm_count(0)} SMs")
    rows = {name: cs.Row() for name in cs.KERNELS}
    cs.k2_f32_kernels(device, rows, np.random.default_rng(cs.SEED), only="forward")
    print("row: device ms (events ms), bound ms, share of bound; the earlier design (recorded)")
    for name in ROWS:
        row = rows[name]
        share = f"{100.0 * row.bound / row.device_ms:.1f} %" if row.device_ms else "not measured"
        print(f"  {name}: {cs.shown(row.device_ms)} ({row.ms:.4f}), {row.bound:.4f} by {row.bound_by}, {share}; "
              f"earlier {RECORDED[name]:.4f} ({100.0 * row.bound / RECORDED[name]:.1f} %)")
    if args.against:
        against(args.against)
    if args.variants:
        source_variants(device)
    print(cs.card_line())
    if spilled:
        print(f"bench_k2f_f32_torch: {spilled} instantiation(s) of {KERNEL} spill", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
