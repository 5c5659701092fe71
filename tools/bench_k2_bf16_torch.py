"""K2's two bfloat16 kernels on the tensor cores, the forward
(`bn_glu_pool_bf16_kernel`) and the reduce pass (`bn_glu_pool_bwd_bf16_kernel`)
of csrc/fused_block.cu, alone, on one NVIDIA GPU; with --stats, K2s on
bfloat16 y (`stats_bf16_kernel`) instead.

    python tools/bench_k2_bf16_torch.py [--no-tests] [--variants] [--ablations]
    python tools/bench_k2_bf16_torch.py --stats [--no-tests] [--variants] [--against DIR]

Prints the card's name and power limit; the ptxas report (registers,
stack, spill) of every instantiation of the two (a spill fails the run at
its end) and their HGMMA / HMMA / FFMA counts with the rest of their
instruction mix (`cuobjdump -sass` of the built library, through
chip_smoke.py's `check_mma`, which fails without a tensor-core instruction
there); runs their GPU tests (`pytest tests/test_torch_kernels_gpu.py -k
"fused_block_bf16 or k2_bf16"`) unless --no-tests; then chip_smoke.py's
phase-3 bfloat16 K2 rows (`chip_smoke.bf16_block_kernels` without K3's
rows) at the scaled configuration's three blocks (C = 128) and the
flagship's (C = 64), each against its plain version under chip_smoke.py's
bars, and a summary of device ms, bound and share of bound. With
--variants it also times other launch plans of the two at block 1 of both
configurations, rate 0.5: the forward with tiles a block for 528, 1056 or
2112 blocks; the reduce pass with one or two buffers and tiles a block for
264, 528 or 1056 blocks; each
output first held to the plan's (the forward and dy_partial bit for bit,
the sums within 1e-4 of their max). With --ablations it times source
variants of the two at block 1 of the scaled shape (`ABLATIONS`: a piece
left out or done another way), each csrc/fused_block.cu edited and built
alone into a library of its own (all compilers started together) that the
wrappers then call; times by CUDA events and ptxas lines only, no bars (a
variant that leaves work out computes something else). About three minutes of card
time, five with --ablations. Imports the port only; needs a card; exits
non-zero when a bar fails.

--stats: the ptxas report of `stats_bf16_kernel` (a spill fails the run),
its GPU tests (`-k k2s_bf16`) unless --no-tests, then at each shape it runs
at (`STATS_SHAPES`: the flagship's three blocks, C = 64; the scaled
configuration's three, C = 128; C = 36, four channels a thread) the sums
held to the float64 sums of y (each channel within 1e-6 relative,
chip_smoke.stats_bf16_exact), the device ms (the kernel and its fold),
the ms by CUDA events, the bound (y read once) and the share. With
--variants: one wave of 2 and of 4 blocks an SM against the occupancy
calculator's (sums within 1e-6 of max of the as-built plan's), by the
profiler; and as source edits built apart, batches of 4 and 16 rows a
thread (`kStatsUnroll`, registers capped for 2 and 1 blocks an SM,
`kStatsBlocks`) beside the as-built 8 (2 blocks), by CUDA events in turn
and in reverse order. With --against DIR (e.g. the parent's `git archive` under a
directory that .gitignore lists): DIR's K2s and this tree's at the same
shapes on the same y, each in a process of its own that builds its package,
in the order DIR, this, this, DIR, device ms medians, and the sums of the
two trees within 1e-6 of max of each other. About four minutes of card time
with both options.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

KERNELS = ("bn_glu_pool_bf16_kernel", "bn_glu_pool_bwd_bf16_kernel")
ROWS = ("fused_bn_glu_pool_eval_bf16", "fused_bn_glu_pool_train_bf16", "bwd_reduce_bf16")
# K2s on bfloat16 y: the flagship's three blocks (batch 24, C = 64), the
# scaled configuration's (C = 128), and C = 36 at the flagship's block 3
STATS_SHAPES = ((24, 864, 64, 64), (24, 432, 16, 64), (24, 216, 4, 64), (24, 864, 128, 128), (24, 432, 32, 128),
                (24, 216, 8, 128), (24, 216, 4, 36))
STATS_SEED = 20190419


def configs():
    """(suffix, configuration) of the two bfloat16 models: the scaled one
    (C = 128) and the flagship under `--bf16` (C = 64)."""
    from dcase2019_task4_tpu_torch.config import Config, scaled_config

    cfg = Config()
    flagship = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, compute_dtype="bfloat16"))
    return (("", scaled_config()), ("_flagship", flagship))


def ptxas_report(log: str) -> int:
    """Print the ptxas lines of the two kernels; the number of instantiations
    that spill."""
    lines, spilled = log.splitlines(), 0
    for i, line in enumerate(lines):
        if "Compiling entry" in line and any(k in line for k in KERNELS):
            report = " ".join(s.strip() for s in lines[i + 1:i + 4] if "bytes" in s or "registers" in s)
            print(line.strip()[:150])
            print("  ", report)
            if "0 bytes spill stores, 0 bytes spill loads" not in report:
                spilled += 1
    return spilled


# Source variants for --ablations: (name, edits), each edit
# (text, replacement, count) applied to csrc/fused_block.cu or the headers it
# includes (count -1: every occurrence; the forward comes before the reduce
# pass in the file; the reduce pass's tile code is in bf16_tile.cuh, shared
# with the recompute fixup and K5's bfloat16 passes)
FAST_SIGMOID = "__device__ __forceinline__ float fsig(float x) { return __fdividef(1.0f, 1.0f + __expf(-x)); }\n"
ABLATIONS = (
    ("as built", ()),
    ("sigmoid by __expf and __fdividef",
     (("// xn = ((y - mean) * inv)", FAST_SIGMOID + "// xn = ((y - mean) * inv)", 1), ("sigmoidf(xn_of(", "fsig(xn_of(", -1))),
    ("sigmoid by __frcp_rn (the same bits)",
     (("// xn = ((y - mean) * inv)", "__device__ __forceinline__ float rsig(float x) { return __frcp_rn(1.0f + expf(-x)); }\n"
       "// xn = ((y - mean) * inv)", 1), ("sigmoidf(xn_of(", "rsig(xn_of(", -1))),
    ("forward without lin", (("    product_w<CP, NW, true>(acc, A, ws, wm, wn, lane);\n    // g =", "    // g =", 1),)),
    ("forward without the pool", (("i < n_win * KG; i += P::NTHR", "i < 0; i += P::NTHR", 1),)),
    ("reduce without dW", (("ks < ksteps; ++ks", "ks < 0; ++ks", 1),)),
    ("reduce without dxn", (("  product_w<CP, NW, false, MT>(acc, s.D + row0 * RS, s.ws, wm, wn, lane);", "", 1),)),
    ("reduce without the mask pass", (("i < tpix * KG; i += blockDim.x", "i < 0; i += blockDim.x", 1),)),
    ("reduce without the dy_partial stores", (("if (dyp != nullptr) {  // the tile's", "if (false) {  // the tile's", 1),)),
    ("reduce, 8 warps at C = 128, the tile's pixels in one pass",
     (("constexpr int kBwdWarps = 16;", "constexpr int kBwdWarps = CP == 64 ? 16 : 8;", 1),
      ("constexpr int NH = CP == 128 ? 2 : 1;", "constexpr int NH = 1;", 1))),
    ("reduce, 16 warps at C = 128, the tile's pixels in one pass",
     (("constexpr int NH = CP == 128 ? 2 : 1;", "constexpr int NH = 1;", 1),)),
)


def ablation_libraries(ablations=ABLATIONS, kernel="bf16_kernel", source="fused_block.cu"):
    """Build each variant of csrc/`source` in `ablations` (ABLATIONS' form;
    an edit applies to `source` or, where the text is there, to the headers
    it includes: count -1 in every file that holds it, else in the first)
    alone into its own library under the build directory, all compilers at
    once; → [(name, ctypes library or None, ptxas lines of the kernels whose
    name holds `kernel`)]."""
    import ctypes
    import shutil

    from dcase2019_task4_tpu_torch.ops import _build

    names = [source] + sorted(h.name for h in _build.CSRC_DIR.glob("*.cuh"))
    texts = {n: (_build.CSRC_DIR / n).read_text() for n in names}
    jobs = []
    for k, (name, edits) in enumerate(ablations):
        work = _build.BUILD_DIR / "ablations" / str(k)
        if work.exists():
            shutil.rmtree(work)
        work.mkdir(parents=True)
        files = dict(texts)
        for old, new, count in edits:
            holding = [n for n in names if old in files[n]]
            if not holding:
                raise AssertionError(f"ablation {name!r}: {old[:60]!r} not in {source} or its headers")
            for n in holding if count == -1 else holding[:1]:
                files[n] = files[n].replace(old, new, count)
        for n, text in files.items():
            (work / n).write_text(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-o", str(work / "lib.so"), str(work / source)]
        jobs.append((name, work, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    out = []
    for name, work, proc in jobs:
        log, _ = proc.communicate()
        lines = log.splitlines()
        ptxas = [" ".join(s.strip() for s in lines[i:i + 3] if "registers" in s or "spill" in s)
                 for i, line in enumerate(lines) if "Compiling entry" in line and kernel in line]
        lib = None
        if proc.returncode == 0:
            lib = ctypes.CDLL(str(work / "lib.so"))
            for fn, (restype, argtypes) in _build.SIGNATURES.items():
                if hasattr(lib, fn):
                    getattr(lib, fn).restype, getattr(lib, fn).argtypes = restype, argtypes
        else:
            print(f"  ablation {name!r} did not build:\n{log[-2000:]}")
        out.append((name, lib, ptxas))
    return out


def ablations(device):
    """ms of each ABLATIONS variant at block 1 of the scaled shape by CUDA
    events (`chip_smoke.time_ms`: torch.profiler traces nothing once a
    second library with its own CUDA runtime is loaded): the forward at rate
    0 and 0.5, the reduce pass at 0.5."""
    import torch

    import chip_smoke as cs
    from dcase2019_task4_tpu_torch.config import scaled_config
    from dcase2019_task4_tpu_torch.ops import _build
    from dcase2019_task4_tpu_torch.ops import fused_block as fb

    cfg = scaled_config()
    m, d = cfg.model, cfg.dsp
    B, C, eps, rate, pool = cfg.train.batch_size, m.nb_filters[0], m.bn_eps, m.dropout, tuple(m.pooling[0])
    rng = np.random.default_rng(cs.SEED + 13)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    y = t(rng.standard_normal((B, d.max_frames, d.n_mels, C))).to(torch.bfloat16)
    vecs = (t(1 + 0.1 * rng.standard_normal(C)), t(0.1 * rng.standard_normal(C)), t(0.2 * rng.standard_normal(C)),
            t(rng.uniform(0.5, 2.0, C)), t(rng.standard_normal((C, C)) / np.sqrt(C)), t(0.1 * rng.standard_normal(C)))
    dout = t(rng.standard_normal((B, y.shape[1] // pool[0], y.shape[2] // pool[1], C))).to(torch.bfloat16)
    seed = torch.tensor([20190415], dtype=torch.int64)
    library = _build.library
    print(f"  source variants at {list(y.shape)} pool {pool}: forward eval / train, reduce pass (ms, CUDA events)")
    try:
        for name, lib, ptxas in ablation_libraries():
            if lib is None:
                continue
            _build.library = lambda lib=lib: lib
            ms = [cs.time_ms(lambda r=r: fb.fused_bn_glu_pool(y, *vecs, pool, eps, rate=r, seed=seed))
                  for r in (0.0, rate)]
            ms.append(cs.time_ms(lambda: fb.bwd_reduce(y, dout, *vecs, pool, eps, rate=rate, seed=seed)))
            print(f"    {name}: {' / '.join(f'{v:.4f}' for v in ms)}; ptxas " + "; ".join(ptxas))
    finally:
        _build.library = library


def variants(device):
    """Device ms of other launch plans at block 1 of both configurations,
    each output first held to the plan's."""
    import torch

    import chip_smoke as cs
    from dcase2019_task4_tpu_torch.ops import fused_block as fb

    planned, targets = fb.bf16_reduce_plan, (fb._TARGET_BLOCKS, fb._TARGET_BLOCKS_BWD)
    rng = np.random.default_rng(cs.SEED + 12)
    seed = torch.tensor([20190415], dtype=torch.int64)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    try:
        for _, cfg in configs():
            m, d = cfg.model, cfg.dsp
            B, C, eps, rate, pool = cfg.train.batch_size, m.nb_filters[0], m.bn_eps, m.dropout, tuple(m.pooling[0])
            y = t(rng.standard_normal((B, d.max_frames, d.n_mels, C))).to(torch.bfloat16)
            vecs = (t(1 + 0.1 * rng.standard_normal(C)), t(0.1 * rng.standard_normal(C)),
                    t(0.2 * rng.standard_normal(C)), t(rng.uniform(0.5, 2.0, C)))
            w, gb = t(rng.standard_normal((C, C)) / np.sqrt(C)), t(0.1 * rng.standard_normal(C))
            dout = t(rng.standard_normal((B, y.shape[1] // pool[0], y.shape[2] // pool[1], C))).to(torch.bfloat16)
            fwd_args = (y, *vecs, w, gb, pool, eps)
            bwd_args = (y, dout, *vecs, w, gb, pool, eps)
            want_fwd = fb.fused_bn_glu_pool(*fwd_args, rate=rate, seed=seed)
            want_bwd = fb.bwd_reduce(*bwd_args, rate=rate, seed=seed)
            mask = fb.dropout_keep_mask(seed, y.shape, rate, device=device)
            plain = fb.bwd_reduce_reference(*bwd_args[:2], *vecs, w, gb, pool, eps, mask, 1.0 - rate)
            del mask
            print(f"  {list(y.shape)} pool {pool} (the plan: reduce {planned(C, pool)[0]} buffer(s); targets "
                  f"{targets[0]} / {targets[1]} blocks): device ms")
            for target in (528, 1056, 2112):
                fb._TARGET_BLOCKS = target
                if not torch.equal(fb.fused_bn_glu_pool(*fwd_args, rate=rate, seed=seed), want_fwd):
                    raise AssertionError(f"forward, {target} blocks: other bits than the plan's")
                ms = cs.device_ms(lambda: fb.fused_bn_glu_pool(*fwd_args, rate=rate, seed=seed),
                                  only="bn_glu_pool_bf16_kernel")
                print(f"    forward, {target} blocks: {cs.shown(ms)}")
            fb._TARGET_BLOCKS = targets[0]
            for buffers in (1, 2):
                for target in (264, 528, 1056):
                    def plan(c, p, b=buffers):
                        got = planned(c, p)
                        return b, got[1], got[2]

                    fb.bf16_reduce_plan, fb._TARGET_BLOCKS_BWD = plan, target
                    got = fb.bwd_reduce(*bwd_args, rate=rate, seed=seed)
                    if not torch.equal(got[0], want_bwd[0]):
                        raise AssertionError(f"reduce pass, {buffers} buffer(s), {target} blocks: dy_partial differs")
                    for name, g, r in zip(("dw", "db", "S1", "S2"), got[1:], plain[1:]):
                        err, limit = (g - r).abs().max().item(), 1e-4 * r.abs().max().item()
                        if not err <= limit:
                            raise AssertionError(f"reduce pass, {buffers} buffer(s), {target} blocks, {name}: "
                                                 f"{err} exceeds {limit}")
                    ms = cs.device_ms(lambda: fb.bwd_reduce(*bwd_args, rate=rate, seed=seed),
                                      only="bn_glu_pool_bwd_bf16_kernel")
                    print(f"    reduce pass, {buffers} buffer(s), {target} blocks: {cs.shown(ms)}")
            fb.bf16_reduce_plan, fb._TARGET_BLOCKS_BWD = planned, targets[1]
            del y, dout, want_fwd, want_bwd, plain, fwd_args, bwd_args
            torch.cuda.empty_cache()
    finally:
        fb.bf16_reduce_plan, (fb._TARGET_BLOCKS, fb._TARGET_BLOCKS_BWD) = planned, targets


def stats_inputs(device):
    """{shape: y} of K2s at STATS_SHAPES, bfloat16, from a generator on the
    card (the same y in every process on the card)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(STATS_SEED)
    return {shape: torch.randn(shape, generator=gen, device=device).bfloat16() for shape in STATS_SHAPES}


def stats_from(root: str) -> int:
    """In a process of its own: K2s of the package at `root` (built there)
    at STATS_SHAPES, device ms and sums, as one JSON line."""
    import json

    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from dcase2019_task4_tpu_torch.ops import _build
    from dcase2019_task4_tpu_torch.ops import fused_block as fb

    _build.build()
    got = {"root": root, "ms": {}, "sums": {}}
    for shape, y in stats_inputs(torch.device("cuda", 0)).items():
        got["sums"][str(shape)] = [t.tolist() for t in fb.batch_stats(y)]
        cs.PROFILER["lost"] = False
        got["ms"][str(shape)] = cs.device_ms(lambda: fb.batch_stats(y))
    print(json.dumps(got))
    return 0


def stats_against(other: str) -> bool:
    """DIR's K2s and this tree's, in the order DIR, this, this, DIR; → whether
    the two trees' sums agree within 1e-6 of max and each tree's runs are
    the same bits."""
    import json

    runs = []
    for root in (other, REPO, REPO, other):
        done = subprocess.run([sys.executable, os.path.abspath(__file__), "--stats-from", os.path.abspath(root)],
                              cwd=root, capture_output=True, text=True)
        lines = [line for line in done.stdout.splitlines() if line.startswith("{")]
        if done.returncode != 0 or not lines:
            print(done.stdout[-3000:], done.stderr[-3000:])
            raise AssertionError(f"measuring {root} failed")
        runs.append(json.loads(lines[-1]))

    def shown(v):
        return "not measured" if v is None else f"{v:.4f}"

    def median(vals):
        vals = [v for v in vals if v is not None]
        return float(np.median(vals)) if vals else None

    ok, totals = True, {"DIR": 0.0, "this": 0.0}
    print(f"  K2s bf16, {other} against this tree (device ms, medians of two runs each; runs DIR, this, this, DIR):")
    for key in runs[0]["ms"]:
        old, new = median([runs[0]["ms"][key], runs[3]["ms"][key]]), median([runs[1]["ms"][key], runs[2]["ms"][key]])
        want = [np.asarray(v, np.float64) for v in runs[0]["sums"][key]]
        err = max(np.abs(np.asarray(g) - w).max() / np.abs(w).max() for g, w in zip(runs[1]["sums"][key], want))
        same = runs[0]["sums"][key] == runs[3]["sums"][key] and runs[1]["sums"][key] == runs[2]["sums"][key]
        ok = ok and err <= 1e-6 and same
        if key.endswith(", 64)") and old is not None and new is not None:
            totals["DIR"] += old
            totals["this"] += new
        ratio = f" ({old / new:.2f}x)" if old and new else ""
        print(f"    {key}: {shown(old)} -> {shown(new)}{ratio}; runs " + ", ".join(shown(r["ms"][key]) for r in runs)
              + f"; sums {err:.2e} of max of DIR's, each tree's runs {'bit-equal' if same else 'DIFFER'}")
    print(f"    the flagship's three shapes (C = 64) summed: {totals['DIR']:.4f} -> {totals['this']:.4f}")
    return ok


def stats_variants(device, inputs):
    """Other plans of K2s bf16 at STATS_SHAPES: one wave of 2 and 4 blocks an
    SM against the occupancy calculator's count (device ms), then as source
    edits batches of 4 rows (registers capped for 2 blocks an SM) and of 16
    (for 1) against the as-built 8 (for 2), by CUDA events, in turn and in
    reverse order."""
    import chip_smoke as cs
    from dcase2019_task4_tpu_torch.ops import _build
    from dcase2019_task4_tpu_torch.ops import fused_block as fb

    built = {shape: fb.batch_stats(y) for shape, y in inputs.items()}

    def held(shape, got):
        err = max((p - q).abs().max().item() / q.abs().max().item() for p, q in zip(got, built[shape]))
        if not err <= 1e-6:
            raise AssertionError(f"K2s bf16 {shape}: another plan moves the sums by {err:.3e} of max")
        return f"{err:.1e} of max of the as-built plan's"

    resident = _build.resident
    sm = _build.sm_count(0)
    plans = (("as built", None), ("2 blocks an SM", 2), ("4 blocks an SM", 4))
    print(f"  K2s bf16 launch plans (device ms; as built {resident(0, 'stats_bf16', 8)} blocks of 8 channels a "
          f"thread, {resident(0, 'stats_bf16', 4)} of 4, on {sm} SMs):")
    try:
        for label, per_sm in plans + plans[::-1]:
            _build.resident = resident if per_sm is None else (lambda *a, n=per_sm: n * sm)
            for shape, y in inputs.items():
                cs.PROFILER["lost"] = False
                print(f"    {shape}, {label}: {cs.shown(cs.device_ms(lambda: fb.batch_stats(y)))} "
                      f"({held(shape, fb.batch_stats(y))})")
    finally:
        _build.resident = resident

    edits = tuple((f"batches of {u} rows, registers capped for {b} blocks an SM",
                   (("constexpr int kStatsUnroll = 8;", f"constexpr int kStatsUnroll = {u};", 1),
                    ("constexpr int kStatsBlocks = 2;", f"constexpr int kStatsBlocks = {b};", 1)))
                  for u, b in ((4, 2), (16, 1)))
    main_lib = _build.library
    for label, lib, ptxas in ablation_libraries(edits, "stats_bf16_kernel"):
        print(f"  {label}: ptxas " + "; ".join(ptxas))
        if lib is None:
            continue
        try:
            for as_built in (True, False, False, True):
                _build.library = main_lib if as_built else (lambda lib=lib: lib)
                _build.resident.cache_clear()
                for shape, y in inputs.items():
                    ms = cs.time_ms(lambda: [fb.batch_stats(y) for _ in range(10)]) / 10
                    print(f"    {shape}, {'as built' if as_built else 'the edit'}: events {ms:.4f} "
                          f"({held(shape, fb.batch_stats(y))})")
        finally:
            _build.library = main_lib
            _build.resident.cache_clear()


def stats_main(args) -> int:
    """The --stats mode (see the module's docstring)."""
    import torch

    import chip_smoke as cs
    from dcase2019_task4_tpu_torch.ops import _build
    from dcase2019_task4_tpu_torch.ops import fused_block as fb

    print(cs.card_line())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    info = _build.build()
    log = info["log"] or (_build.BUILD_DIR / "build.log").read_text()
    lines, spilled, seen = log.splitlines(), 0, 0
    for i, line in enumerate(lines):
        if "Compiling entry" in line and "stats_bf16_kernel" in line:
            seen += 1
            report = " ".join(s.strip() for s in lines[i + 1:i + 4] if "bytes" in s or "registers" in s)
            print(line.strip()[:150])
            print("  ", report)
            spilled += "0 bytes spill stores, 0 bytes spill loads" not in report
    if not seen:
        print("bench_k2_bf16_torch: no ptxas report of stats_bf16_kernel", file=sys.stderr)
        return 1
    mix = ("LDG", "STG", "FADD", "FFMA", "DADD", "F2F", "IMAD", "LDS", "STS", "BAR")
    for name, counts in _build.sass_counts(info["path"], ("stats_bf16_kernel",), mix).items():
        print(f"{name[:90]}: " + ", ".join(f"{k} {v}" for k, v in counts.items()))
    if not args.no_tests:
        tests = subprocess.run([sys.executable, "-m", "pytest", "tests/test_torch_kernels_gpu.py", "-q",
                                "-p", "no:randomly", "-k", "k2s_bf16 or batch_stats or fused_block_bf16_backward"],
                               cwd=REPO, capture_output=True, text=True)
        print(tests.stdout[-3000:], tests.stderr[-2000:])
        if tests.returncode != 0:
            return tests.returncode
    device = torch.device("cuda", 0)
    inputs = stats_inputs(device)
    print("K2s bf16: device ms (events ms), bound ms, share of bound")
    for shape, y in inputs.items():
        sums = fb.batch_stats(y)
        cs.stats_bf16_exact(y, sums)
        cs.PROFILER["lost"] = False
        dev = cs.device_ms(lambda: fb.batch_stats(y))
        bound = cs.bound_ms(y.numel() * 2 + 2 * shape[-1] * 4, 3.0 * y.numel())[0]
        share = f"{100.0 * bound / dev:.1f} %" if dev else "not measured"
        events = cs.time_ms(lambda: fb.batch_stats(y))
        print(f"  {shape}: {cs.shown(dev)} ({events:.4f}), {bound:.4f} by bytes, {share}")
    ok = True
    if args.against:
        ok = stats_against(args.against)
    if args.variants:
        stats_variants(device, inputs)
    print(cs.card_line())
    if spilled:
        print("bench_k2_bf16_torch: stats_bf16_kernel spills", file=sys.stderr)
        return 1
    if not ok:
        print("bench_k2_bf16_torch: K2s sums differ from DIR's beyond 1e-6 of max, or a run repeats other bits",
              file=sys.stderr)
        return 1
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--no-tests", action="store_true", help="skip the GPU tests of the two kernels")
    parser.add_argument("--variants", action="store_true", help="also time other launch plans of the two")
    parser.add_argument("--ablations", action="store_true", help="also time source variants of the two")
    parser.add_argument("--stats", action="store_true", help="K2s on bfloat16 y instead of the two")
    parser.add_argument("--against", metavar="DIR", help="with --stats: also measure DIR's K2s beside this one")
    parser.add_argument("--stats-from", metavar="DIR", help=argparse.SUPPRESS)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bench_k2_bf16_torch: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if args.stats_from:
        return stats_from(args.stats_from)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.stats:
        return stats_main(args)
    import chip_smoke as cs
    from dcase2019_task4_tpu_torch.ops import _build

    print(cs.card_line())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    info = _build.build()
    print(f"built in {info['seconds']:.1f} s")
    log = info["log"]
    if not log:  # the library was already built: its compilers' output is kept beside it
        log = (_build.BUILD_DIR / "build.log").read_text()
    spilled = ptxas_report(log)
    if not any("bf16_kernel" in line and "Compiling entry" in line for line in log.splitlines()):
        print("bench_k2_bf16_torch: no ptxas report of the two kernels", file=sys.stderr)
        return 1
    cs.check_mma(info["path"])
    mix = ("HMMA", "FFMA", "LDSM", "LDS", "STS", "LDGSTS", "LDG", "STG", "SHFL", "BAR", "MUFU", "IMAD")
    for name, counts in _build.sass_counts(info["path"], KERNELS, mix).items():
        print(f"{name[:90]}: " + ", ".join(f"{k} {v}" for k, v in counts.items()))

    if not args.no_tests:
        tests = subprocess.run([sys.executable, "-m", "pytest", "tests/test_torch_kernels_gpu.py", "-q",
                                "-p", "no:randomly", "-k", "fused_block_bf16 or k2_bf16"],
                               cwd=REPO, capture_output=True, text=True)
        print(tests.stdout[-3000:], tests.stderr[-2000:])
        if tests.returncode != 0:
            return tests.returncode

    device = torch.device("cuda", 0)
    rows = {name: cs.Row() for name in cs.KERNELS}
    rng = np.random.default_rng(cs.SEED)
    for suffix, cfg in configs():
        cs.bf16_block_kernels(device, rows, rng, cfg, suffix, with_k3=False)
    print("row: device ms (events ms), bound ms, share of bound")
    for suffix, _ in configs():
        for name in (r + suffix for r in ROWS):
            row = rows[name]
            share = f"{100.0 * row.bound / row.device_ms:.1f} %" if row.device_ms else "not measured"
            print(f"  {name}: {cs.shown(row.device_ms)} ({row.ms:.4f}), {row.bound:.4f} by {row.bound_by}, {share}")
    if args.variants:
        variants(device)
    if args.ablations:
        ablations(device)
    print(cs.card_line())
    if spilled:
        print(f"bench_k2_bf16_torch: {spilled} instantiation(s) of the two kernels spill", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
