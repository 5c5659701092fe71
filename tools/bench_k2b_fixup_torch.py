"""K2b's recompute fixup, float32 (`bn_bwd_fixup_recompute_kernel`) and
bfloat16 (`bn_bwd_fixup_recompute_bf16_kernel`) of csrc/fused_block.cu,
alone, on one NVIDIA GPU.

    python tools/bench_k2b_fixup_torch.py [--no-tests] [--variants] [--against DIR]

Prints the card's name and power limit; the ptxas report (registers,
stack, spill) of every instantiation of the two fixups and of the two
reduce passes that share their tile code (a spill fails the run at its
end) and the fixups' HGMMA / HMMA / FFMA counts with the rest of their
instruction mix (`cuobjdump -sass` of the built library, through
chip_smoke.py's `check_mma`: FFMA and no tensor-core instruction in the
float32 fixup, HMMA or HGMMA in the bfloat16 one); runs their GPU tests
(`pytest tests/test_torch_kernels_gpu.py -k fixup_recompute`) unless
--no-tests; then the three fixup rows of chip_smoke.py's phase 3
(`chip_smoke.fixup_recompute_row`, the packed draw at the model's dropout,
under chip_smoke.py's bars): float32 at the flagship's three block shapes
(batch 24, C = 64), bfloat16 at the scaled configuration's (C = 128) and at
the flagship's in bfloat16 (C = 64), with device ms, bound, share of bound
and the earlier kernel's recorded reading.

With --against DIR (a checkout of another commit, e.g. the parent's `git
archive` under a directory that .gitignore lists) it measures DIR's package
and this one in the order DIR, this, this, DIR, each in a process of its own
that builds its package's kernels: the fixups' device ms at each of the
nine shapes; the reduce passes' (float32 with and without dy_partial, the
bfloat16 one at both widths) device ms and the SHA-256 of every output,
which must be the same in both trees; and the device time of one traced
knobs step (chip_smoke.knob_card_steps, the three knobs on, the generator on
the card) of the flagship in float32 (K), of the scaled configuration (KS)
and of the flagship in bfloat16 (KF).

With --variants it times other plans of the two fixups at block 1 of their
configurations, each output first held to the as-built kernel's bit for bit
or else to the plain version under the row's bar: launch plans (bfloat16
one buffer; the grid at half and twice the resident blocks) through the
wrappers, and a source variant (the bfloat16 fixup's pixels a warp: 8
warps at C = 128, 16 at C = 64), csrc/fused_block.cu edited and built
alone into a library of its own (all compilers started together), timed by
CUDA events around ten calls in a row (the profiler traces nothing once a
second library is loaded). About five minutes of card time, ten with
--against. Imports the port only; needs a card; exits non-zero when a bar
fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("bn_bwd_fixup_recompute_kernel", "bn_bwd_fixup_recompute_bf16_kernel")
REDUCE_KERNELS = ("bn_glu_pool_bwd_kernel", "bn_glu_pool_bwd_bf16_kernel")
ROWS = ("bwd_fixup_recompute", "bwd_fixup_recompute_bf16", "bwd_fixup_recompute_bf16_flagship")
# the earlier kernel (PR 8's tile_dxn: scalar shared loads, FP32 FMAs in both
# element types; PERF.md §6: chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W),
# device ms over each row's three shapes
RECORDED = {"bwd_fixup_recompute": 2.8525, "bwd_fixup_recompute_bf16": 20.9993,
            "bwd_fixup_recompute_bf16_flagship": 3.0610}
KNOB_PATHS = ("step_knobs", "step_knobs_scaled", "step_knobs_bf16")
SEED = 20190414

# source variants for --variants: (name, edits), each edit (text, replacement, count) applied to csrc/fused_block.cu
SOURCE_VARIANTS = (
    ("as built", ()),
    ("bfloat16: 8 warps at C = 128, 16 at C = 64",
     (("constexpr int kFixWarps = CP == 128 ? 16 : 8;", "constexpr int kFixWarps = CP == 128 ? 8 : 16;", 1),)),
)


def configs():
    """(row, configuration) of the three fixup rows."""
    from dcase2019_task4_tpu_torch.config import Config, scaled_config

    cfg = Config()
    bf16 = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, compute_dtype="bfloat16"))
    return (("bwd_fixup_recompute", cfg), ("bwd_fixup_recompute_bf16", scaled_config()),
            ("bwd_fixup_recompute_bf16_flagship", bf16))


def inputs(cfg, device, blocks=3):
    """[(y, dout, (scale, bias, mean, var, glu_w, glu_b), pool, eps, rate)] at
    the first `blocks` block shapes of `cfg`, batch 24, y in its compute
    dtype and mean, var y's own (float64 on the host), from SEED."""
    import torch

    import chip_smoke as cs

    m = cfg.model
    B, C, eps, rate = cfg.train.batch_size, m.nb_filters[1], m.bn_eps, m.dropout
    dtype = torch.bfloat16 if m.compute_dtype == "bfloat16" else torch.float32
    rng = np.random.default_rng(SEED)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    out = []
    for (T, Fq), pool in list(zip(cs.block_geometries(cfg), [tuple(p) for p in m.pooling]))[:blocks]:
        y = t(rng.standard_normal((B, T, Fq, C))).to(dtype)
        yh = y.double().cpu()
        mean, var = yh.mean(dim=(0, 1, 2)), yh.var(dim=(0, 1, 2), unbiased=False)
        vecs = (t(1 + 0.1 * rng.standard_normal(C)), t(0.1 * rng.standard_normal(C)), mean.float().to(device),
                var.float().to(device), t(rng.standard_normal((C, C)) / np.sqrt(C)), t(0.1 * rng.standard_normal(C)))
        dout = t(rng.standard_normal((B, T // pool[0], Fq // pool[1], C))).to(dtype)
        out.append((y, dout, vecs, pool, eps, rate))
    return out


def ptxas_report(log: str) -> int:
    """Print the ptxas lines of the fixups and the reduce passes; the number
    of instantiations that spill."""
    lines, spilled, seen = log.splitlines(), 0, 0
    for i, line in enumerate(lines):
        if "Compiling entry" in line and any(k in line for k in KERNELS + REDUCE_KERNELS):
            seen += 1
            report = " ".join(s.strip() for s in lines[i + 1:i + 4] if "bytes" in s or "registers" in s)
            print(line.strip()[:150])
            print("  ", report)
            if "0 bytes spill stores, 0 bytes spill loads" not in report:
                spilled += 1
    if seen != 8:
        raise AssertionError(f"{seen} ptxas reports of the fixups and reduce passes, expected 8 (two of each)")
    return spilled


def digest(outs) -> str:
    """The first 16 hex digits of the SHA-256 of the outputs' bytes."""
    import torch

    h = hashlib.sha256()
    for t in outs:
        if t is not None:
            h.update(t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def rows_from(root: str) -> int:
    """In a process of its own: the fixups', reduce passes' and knobs steps'
    readings of the package at `root` (built there), as one JSON line."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from dcase2019_task4_tpu_torch.ops import _build
    from dcase2019_task4_tpu_torch.ops import fused_block as fb
    from dcase2019_task4_tpu_torch.ops import fused_mel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fused_mel.ONEDOT = fb.RECOMPUTE_FIXUP = fb.PACK_BITS = False
    _build.build()
    device = torch.device("cuda", 0)
    seed = torch.tensor([SEED], dtype=torch.int64)
    got = {"root": root, "fixup": {}, "reduce": {}, "digests": {}, "steps": {}}
    for row, cfg in configs():
        for y, dout, vecs, pool, eps, rate in inputs(cfg, device):
            key = f"{row} {list(y.shape)}"
            packed = dict(rate=rate, seed=seed, pack_bits=True)
            for recompute in (False, True):
                outs = fb.bwd_reduce(y, dout, *vecs, pool, eps, recompute=recompute, **packed)
                name = f"{key} {'nodyp' if recompute else 'dyp'}"
                got["digests"][name] = digest(outs)
                cs.PROFILER["lost"] = False
                got["reduce"][name] = cs.device_ms(
                    lambda r=recompute: fb.bwd_reduce(y, dout, *vecs, pool, eps, recompute=r, **packed),
                    only="bn_glu_pool_bwd")
            _, _, _, s1, s2 = outs
            a, b2 = fb.bwd_coefficients(vecs[0], vecs[3], eps, s1, s2, y.numel() // y.shape[-1])
            cs.PROFILER["lost"] = False
            got["fixup"][key] = cs.device_ms(lambda: fb.bwd_fixup_recompute(y, dout, *vecs, a, b2, pool, eps, **packed),
                                             only="fixup_recompute")
            del outs
        torch.cuda.empty_cache()
    for path, (_, cfg) in zip(KNOB_PATHS, configs()):
        cs.PROFILER["lost"] = False
        got["steps"][path] = cs.knob_card_steps(device, cfg, path, 2, True, cs.step_data(cfg, device))[3]
        torch.cuda.empty_cache()
    print(json.dumps(got))
    return 0


def against(other: str) -> bool:
    """DIR's readings and this tree's, in the order DIR, this, this, DIR;
    → whether the reduce passes' outputs are the same bits in both."""
    runs = []
    for root in (other, REPO, REPO, other):
        done = subprocess.run([sys.executable, os.path.abspath(__file__), "--rows-from", os.path.abspath(root)],
                              cwd=root, capture_output=True, text=True)
        lines = [line for line in done.stdout.splitlines() if line.startswith("{")]
        if done.returncode != 0 or not lines:
            print(done.stdout[-3000:], done.stderr[-3000:])
            raise AssertionError(f"measuring {root} failed")
        runs.append(json.loads(lines[-1]))

    def med(key, name):  # the median of the two runs of a tree, or None
        for pair in ((runs[0], runs[3]), (runs[1], runs[2])):
            vals = [r[key][name] for r in pair if r[key][name] is not None]
            yield float(np.median(vals)) if vals else None

    def shown(v):
        return "not measured" if v is None else f"{v:.4f}"

    print(f"  {other} against this tree (medians of two runs each, device ms; DIR, this, this, DIR):")
    print("  the recompute fixups:")
    totals = {}
    for name in runs[0]["fixup"]:
        old, new = med("fixup", name)
        row = name.split(" ")[0]
        if old is not None and new is not None:
            t = totals.setdefault(row, [0.0, 0.0])
            t[0], t[1] = t[0] + old, t[1] + new
        verdict = "faster" if old is not None and new is not None and new < old else "NOT faster or not measured"
        print(f"    {name}: {shown(old)} -> {shown(new)} ({verdict})")
    for row, (old, new) in totals.items():
        print(f"    {row}, summed: {old:.4f} -> {new:.4f} ({old / new:.2f}x)")
    print("  the reduce passes (their outputs' SHA-256 in each run):")
    same = True
    for name in runs[0]["reduce"]:
        old, new = med("reduce", name)
        digests = {r["digests"][name] for r in runs}
        same = same and len(digests) == 1
        print(f"    {name}: {shown(old)} -> {shown(new)}; outputs {'bit-identical' if len(digests) == 1 else 'DIFFER'}")
    print("  one traced knobs step's device time (chip_smoke.knob_card_steps):")
    for path in KNOB_PATHS:
        old, new = med("steps", path)
        print(f"    {path}: {shown(old)} -> {shown(new)}; runs " + ", ".join(shown(r["steps"][path]) for r in runs))
    return same


def fixup_rows(device):
    """chip_smoke.py's three fixup rows at their nine shapes, each held to
    its plain version under chip_smoke.py's bars."""
    import torch

    import chip_smoke as cs
    from dcase2019_task4_tpu_torch.ops import fused_block as fb

    rows = {name: cs.Row() for name in ROWS}
    seed = torch.tensor([SEED], dtype=torch.int64)
    for row, cfg in configs():
        for y, dout, vecs, pool, eps, rate in inputs(cfg, device):
            mask = fb.dropout_keep_mask(seed, y.shape, rate, device=device, pack_bits=True)
            cs.fixup_recompute_row(rows[row], y, dout, vecs, pool, eps, rate, seed, mask)
            del mask
        torch.cuda.empty_cache()
    print("row: device ms (events ms), bound ms, share of bound; the earlier kernel (recorded)")
    for name in ROWS:
        row = rows[name]
        share = f"{100.0 * row.bound / row.device_ms:.1f} %" if row.device_ms else "not measured"
        print(f"  {name}: {cs.shown(row.device_ms)} ({row.ms:.4f}), {row.bound:.4f} by {row.bound_by}, {share}; "
              f"earlier {RECORDED[name]:.4f} ({100.0 * row.bound / RECORDED[name]:.1f} %)")


def held(dy, want, built, what: str):
    """A variant's dy: the as-built kernel's bits, or within the row's bar of
    the plain version (float32 1e-4 of max; bfloat16 one ulp of the larger
    value plus 2^-8 of max, at most 1e-3 of the elements beyond the ulp)."""
    import torch

    import chip_smoke as cs

    if torch.equal(dy, built):
        return "bit-equal to the as-built kernel"
    d, w = dy.float(), want.float()
    err = (d - w).abs()
    if dy.dtype == torch.float32:
        if not err.max().item() <= 1e-4 * w.abs().max().item():
            raise AssertionError(f"{what}: error {err.max().item()} exceeds 1e-4 of max")
        return f"error {err.max().item():.3e} (1e-4 of max)"
    ulp = cs.bf16_ulp(torch.maximum(d.abs(), w.abs()))
    share = (err > ulp).float().mean().item()
    if share > 1e-3 or (err > ulp + 2.0 ** -8 * w.abs().max()).any():
        raise AssertionError(f"{what}: {share:.2e} of the elements beyond one ulp, or beyond one ulp + slack")
    return f"{share:.1e} of the elements beyond one ulp"


def variants(device):
    """ms of other plans of the two fixups at block 1 of each configuration
    (CUDA events around ten calls in a row, a tenth of it), each output held
    first (`held`)."""
    import torch

    sys.path.insert(0, os.path.join(REPO, "tools"))
    import bench_k2_bf16_torch as k2b
    import chip_smoke as cs
    from dcase2019_task4_tpu_torch.ops import _build
    from dcase2019_task4_tpu_torch.ops import fused_block as fb

    seed = torch.tensor([SEED], dtype=torch.int64)
    cases = []
    for row, cfg in configs():
        y, dout, vecs, pool, eps, rate = inputs(cfg, device, blocks=1)[0]
        packed = dict(rate=rate, seed=seed, pack_bits=True)
        _, _, _, s1, s2 = fb.bwd_reduce(y, dout, *vecs, pool, eps, recompute=True, **packed)
        a, b2 = fb.bwd_coefficients(vecs[0], vecs[3], eps, s1, s2, y.numel() // y.shape[-1])
        mask = fb.dropout_keep_mask(seed, y.shape, rate, device=device, pack_bits=True)
        want = fb.bwd_fixup_recompute_reference(y, dout, *vecs, a, b2, pool, eps, mask, 1.0 - rate)
        del mask
        fn = lambda y=y, dout=dout, vecs=vecs, a=a, b2=b2, pool=pool, eps=eps, packed=packed: \
            fb.bwd_fixup_recompute(y, dout, *vecs, a, b2, pool, eps, **packed)  # noqa: E731
        cases.append((row, list(y.shape), fn, want, fn()))

    def timed(fn):
        return cs.time_ms(lambda: [fn() for _ in range(10)]) / 10

    print("  launch plans at block 1 (ms, CUDA events, ten calls in a row):")
    planned, blocks = fb.fixup_plan, fb._fixup_blocks

    def one_buffer(channels, pool, dtype=torch.float32):  # the bfloat16 fixup's y and dout tiles in one buffer
        return (1,) + planned(channels, pool, dtype)[1:]

    plans = (("as planned", planned, 1.0), ("bfloat16 one buffer", one_buffer, 1.0),
             ("grid at half the resident blocks", planned, 0.5), ("grid at twice the resident blocks", planned, 2.0))
    try:
        for name, plan, waves in plans:
            fb.fixup_plan = plan
            fb._fixup_blocks = lambda *args, w=waves: max(1, int(w * blocks(*args)))
            shown = []
            for row, shape, fn, want, built in cases:
                verdict = held(fn(), want, built, f"{name}, {row}")
                shown.append(f"{row} {shape} {timed(fn):.4f} ({verdict})")
            print(f"    {name}: " + "; ".join(shown))
    finally:
        fb.fixup_plan, fb._fixup_blocks = planned, blocks

    print("  source variants at block 1 (ms, CUDA events, ten calls in a row); ptxas of the fixups")
    library = _build.library
    try:
        for name, lib, ptxas in k2b.ablation_libraries(SOURCE_VARIANTS, "fixup_recompute"):
            if lib is None:
                continue
            _build.library = lambda lib=lib: lib
            fb._fixup_blocks.cache_clear()
            shown = []
            for row, shape, fn, want, built in cases:
                verdict = held(fn(), want, built, f"{name}, {row}")
                shown.append(f"{row} {timed(fn):.4f} ({verdict})")
            print(f"    {name}: " + "; ".join(shown) + "; ptxas " + "; ".join(ptxas))
    finally:
        _build.library = library
        fb._fixup_blocks.cache_clear()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--no-tests", action="store_true", help="skip the fixups' GPU tests")
    parser.add_argument("--variants", action="store_true", help="also time other plans of the fixups")
    parser.add_argument("--against", metavar="DIR", help="also measure the package in DIR beside this one")
    parser.add_argument("--rows-from", metavar="DIR", help=argparse.SUPPRESS)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bench_k2b_fixup_torch: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if args.rows_from:
        return rows_from(args.rows_from)
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from dcase2019_task4_tpu_torch.ops import _build
    from dcase2019_task4_tpu_torch.ops import fused_block as fb
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
    mix = ("HMMA", "FFMA", "FADD", "FMUL", "MUFU", "LDS", "LDSM", "LDGSTS", "STS", "STG", "BAR", "IMAD", "SHFL")
    for name, counts in _build.sass_counts(info["path"], KERNELS, mix).items():
        print(f"{name[:90]}: " + ", ".join(f"{k} {v}" for k, v in counts.items()))

    if not args.no_tests:
        tests = subprocess.run([sys.executable, "-m", "pytest", "tests/test_torch_kernels_gpu.py", "-q",
                                "-p", "no:randomly", "-k", "fixup_recompute"], cwd=REPO, capture_output=True, text=True)
        print(tests.stdout[-3000:], tests.stderr[-2000:])
        if tests.returncode != 0:
            return tests.returncode

    device = torch.device("cuda", 0)
    for C in (64, 128):
        for dtype in (torch.float32, torch.bfloat16):
            buffers, drows, nbytes = fb.fixup_plan(C, (2, 4), dtype)
            print(f"plan at C = {C}, {dtype}, pool (2, 4): {buffers} buffer(s), {drows} dout rows, {nbytes} bytes; "
                  f"{fb._fixup_blocks(0, C, dtype == torch.bfloat16, buffers, drows)} blocks held at once on "
                  f"{_build.sm_count(0)} SMs")
    fixup_rows(device)
    same = True
    if args.against:
        same = against(args.against)
    if args.variants:
        variants(device)
    print(cs.card_line())
    if spilled:
        print(f"bench_k2b_fixup_torch: {spilled} instantiation(s) spill", file=sys.stderr)
        return 1
    if not same:
        print("bench_k2b_fixup_torch: a reduce pass's outputs differ from DIR's", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
