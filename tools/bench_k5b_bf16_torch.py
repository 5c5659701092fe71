"""K5's two bfloat16 backward passes (`entry_block_bwd_reduce_bf16_kernel`,
K5b1, and `entry_block_bwd_wgrad_bf16_kernel`, K5b2, of
csrc/entry_block.cu) alone, on one NVIDIA GPU.

    python tools/bench_k5b_bf16_torch.py [--no-tests] [--variants] [--against DIR]

Prints the card's name and power limit; the ptxas report (registers,
stack, spill) of every kernel of csrc/entry_block.cu and of K2's bfloat16
reduce pass and recompute fixup, whose tile code the two passes share
(csrc/bf16_tile.cuh; a spill fails the run at its end), and the two
passes' instruction mix (`cuobjdump -sass` of the built library, through
chip_smoke.py's `check_mma`: HMMA or HGMMA in both); runs their GPU tests
(`pytest tests/test_torch_kernels_gpu.py -k "entry_bwd_bf16 or
entry_block_bf16"`) unless --no-tests; then chip_smoke.py's phase-3 rows of
the entry-block family in bfloat16 at the flagship's block-1 shape (x [24,
864, 64], C = 64; `chip_smoke.entry_bf16_kernels`, under its bars) with
device ms, bound, share of bound and the earlier kernels' recorded reading.

With --against DIR (a checkout of another commit, e.g. the parent's `git
archive` under a directory that .gitignore lists) it measures DIR's package
and this one in the order DIR, this, this, DIR, each in a process of its own
that builds its package's kernels: the two passes' device ms at the flagship
block-1 shape (K5b2 in both partitions); the SHA-256 of the outputs of every
other kernel of csrc/fused_block.cu and csrc/entry_block.cu (K2 in float32
and bfloat16, K4, K5s, K5f, K5's float32 passes), which must be the same in
both trees; and the device time of one traced MT step of the flagship in
bfloat16 under `entry_block_pallas` (FB) and `entry_block_crows` (FR), the
generator on the card (chip_smoke.knob_card_steps, the knobs off), with
block 1's device time in a second traced step (chip_smoke.block1_device_ms).

With --variants it times other plans of the two passes at the flagship
shape, each output first held to the as-built kernel's bit for bit or else
to the plain version under chip_smoke.py's bars: launch plans through the
wrappers (one dout buffer; the grid at half and twice the resident blocks)
and source variants (16 warps a block at C = 64, one block an SM; no
prefetch of the next tile's x), csrc/entry_block.cu edited and built alone into a library
of its own (all compilers started together), timed by CUDA events around
ten calls in a row (the profiler traces nothing once a second library is
loaded). About ten minutes of card time with both options. Imports the port
only; needs a card; exits non-zero when a bar fails.
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
KERNELS = ("entry_block_bwd_reduce_bf16_kernel", "entry_block_bwd_wgrad_bf16_kernel")
SHARED = ("bn_glu_pool_bwd_bf16_kernel", "bn_bwd_fixup_recompute_bf16_kernel")
ROWS = ("entry_block_bwd_reduce_bf16", "entry_block_bwd_wgrad_bf16", "crows_bwd_wgrad_bf16")
# the earlier kernels (entry_block_bwd_*_kernel<4, __nv_bfloat16>, scalar FP32
# FMAs; PERF.md §6: chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W), device ms
RECORDED = {"entry_block_bwd_reduce_bf16": 3.6486, "entry_block_bwd_wgrad_bf16": 2.7656,
            "crows_bwd_wgrad_bf16": 2.7498}
STEP_PATHS = {"step_bf16_entry_block": "entry_block_pallas", "step_bf16_crows": "entry_block_crows"}
SEED = 20190415

# source variants for --variants: (name, edits), each edit (text, replacement, count) applied to csrc/entry_block.cu
SOURCE_VARIANTS = (
    ("as built", ()),
    ("16 warps a block at C = 64, one block an SM",
     (("constexpr int kEntryWarps = CP == 128 ? 16 : 8;", "constexpr int kEntryWarps = 16;", 1),)),
    ("no prefetch of the next tile's x", (("constexpr bool kPrefetchX = CP == 64;", "constexpr bool kPrefetchX = false;", 1),)),
)


def flagship_inputs(device):
    """The flagship block-1 inputs in bfloat16 (x [24, 864, 64], C = 64,
    pool (2, 4), dout bfloat16) with the batch statistics of its conv, the
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

    x = t(rng.standard_normal((B, T, Fq))).bfloat16()
    lim = np.sqrt(2.0) * np.sqrt(6.0 / (9 * (1 + C)))
    conv = {"w": t(rng.uniform(-lim, lim, (3, 3, 1, C))), "b": t(0.1 * rng.standard_normal(C))}
    s1, s2 = fe.entry_block_stats_apply(conv, x)
    mean = s1 / float(B * T * Fq)
    var = s2 / float(B * T * Fq) - mean * mean
    vecs = (conv["w"], conv["b"], t(1 + 0.1 * rng.standard_normal(C)), t(0.1 * rng.standard_normal(C)), mean, var,
            t(rng.standard_normal((C, C)) / np.sqrt(C)), t(0.1 * rng.standard_normal(C)))
    dout = t(rng.standard_normal((B, T // pool[0], Fq // pool[1], C))).bfloat16()
    return x, dout, vecs, pool, eps, rate, torch.tensor([SEED], dtype=torch.int64)


def pass_calls(device):
    """{name: call} of the two passes at the flagship shape: K5b1, K5b2 in
    the planes layout (output-frequency parity) and in the crows layout
    (batch halves), a and b2 from K5b1's sums."""
    from dcase2019_task4_tpu_torch.ops import fused_block as fb
    from dcase2019_task4_tpu_torch.ops import fused_entry_block as fe

    x, dout, vecs, pool, eps, rate, seed = flagship_inputs(device)
    kw = dict(rate=rate, seed=seed)
    red = fe.entry_block_bwd_reduce(x, dout, *vecs, pool, eps, **kw)
    a, b2 = fb.bwd_coefficients(vecs[2], vecs[5], eps, red[2], red[3], x.numel())
    return {
        "K5b1 entry_block_bwd_reduce bf16": lambda: fe.entry_block_bwd_reduce(x, dout, *vecs, pool, eps, **kw),
        "K5b2 entry_block_bwd_wgrad bf16 planes": lambda: fe.entry_block_bwd_wgrad(x, dout, *vecs, a, b2, pool, eps,
                                                                                   **kw),
        "K5b2 entry_block_bwd_wgrad bf16 crows": lambda: fe.entry_block_bwd_wgrad(x, dout, *vecs, a, b2, pool, eps,
                                                                                  layout="crows", **kw),
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
    K2's bfloat16 reduce pass and recompute fixup; → the number of the two
    passes' and those two kernels' instantiations that spill (the others'
    spills are printed, and --against prints DIR's beside them)."""
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


def other_kernels(device) -> dict:
    """{call: digest} of every kernel of csrc/fused_block.cu and
    csrc/entry_block.cu but K5's two bfloat16 passes, on seeded inputs:
    K2 in float32 and bfloat16 at the flagship block-1 shape (C = 64) and
    in bfloat16 at the scaled configuration's (C = 128), forward eval and
    train in both draws, K2s, the reduce pass with and without dy_partial,
    the fixup and the recompute fixup; K4's conv and weight gradient, K5s,
    K5f (both layouts in bfloat16) and K5's float32 passes at the flagship
    block-1 shape."""
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
        out[f"K2s {tag}"] = digest(fb.batch_stats(y))
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
    for dtype in (torch.float32, torch.bfloat16):
        x = t(B, T, Fq).to(dtype)
        dy = t(B, T, Fq, C).to(dtype)
        dout = t(B, T // 2, Fq // 4, C).to(dtype)
        tag = str(dtype)[6:]
        out[f"K4f {tag}"] = digest(ec.entry_conv_forward(conv, x))
        out[f"K4w {tag}"] = digest(ec.entry_conv_wgrad(x, dy))
        s1, s2 = fe.entry_block_stats_apply(conv, x)
        out[f"K5s {tag}"] = digest((s1, s2))
        mean = s1 / float(B * T * Fq)
        var = s2 / float(B * T * Fq) - mean * mean
        block = (conv["w"], conv["b"], *vecs, mean, var, gw, gb)
        for layout in ("planes", "crows") if dtype == torch.bfloat16 else ("planes",):
            out[f"K5f eval {tag} {layout}"] = digest(fe.entry_block_fwd(x, *block, (2, 4), 1e-3, layout=layout))
            for pack in (False, True):
                out[f"K5f train {tag} {layout} pack {pack}"] = digest(
                    fe.entry_block_fwd(x, *block, (2, 4), 1e-3, rate=0.5, seed=seed, layout=layout, pack_bits=pack))
        if dtype == torch.float32:
            for pack in (False, True):
                kw = dict(rate=0.5, seed=seed, pack_bits=pack)
                red = fe.entry_block_bwd_reduce(x, dout, *block, (2, 4), 1e-3, **kw)
                out[f"K5b1 float32 pack {pack}"] = digest(red)
                a, b2 = fb.bwd_coefficients(vecs[0], var, 1e-3, red[2], red[3], B * T * Fq)
                out[f"K5b2 float32 pack {pack}"] = digest(
                    fe.entry_block_bwd_wgrad(x, dout, *block, a, b2, (2, 4), 1e-3, **kw))
        del x, dy, dout
        torch.cuda.empty_cache()
    return out


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
    got = {"root": root, "passes": {}, "pass_digests": {}, "digests": other_kernels(device), "steps": {},
           "block1": {}, "spills": spills(log)}
    for name, call in pass_calls(device).items():
        got["pass_digests"][name] = digest(call())
        cs.PROFILER["lost"] = False
        got["passes"][name] = cs.device_ms(call)
    torch.cuda.empty_cache()
    cfg = Config()
    for path, flag in STEP_PATHS.items():
        model = dataclasses.replace(cfg.model, compute_dtype="bfloat16", **{flag: True})
        run = dataclasses.replace(cfg, model=model)
        cs.PROFILER["lost"] = False
        _, _, _, on_device, state = cs.knob_card_steps(device, run, path, 2, False, cs.step_data(run, device))
        got["steps"][path] = on_device
        cs.PROFILER["lost"] = False
        step, st, batch, generator, acc = state
        got["block1"][path] = cs.block1_device_ms(step, st, batch, generator, acc, path, card)
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

    def med(key, name):  # the median of the two runs of a tree, or None
        for pair in ((runs[0], runs[3]), (runs[1], runs[2])):
            vals = [r[key][name] for r in pair if r[key][name] is not None]
            yield float(np.median(vals)) if vals else None

    def shown(v):
        return "not measured" if v is None else f"{v:.4f}"

    print(f"  {other} against this tree (medians of two runs each, device ms; DIR, this, this, DIR):")
    print("  the two passes at the flagship block-1 shape (their outputs' SHA-256 in each run):")
    for name in runs[0]["passes"]:
        old, new = med("passes", name)
        ratio = f" ({old / new:.2f}x)" if old and new else ""
        repeat = all(runs[i]["pass_digests"][name] == runs[j]["pass_digests"][name] for i, j in ((0, 3), (1, 2)))
        print(f"    {name}: {shown(old)} -> {shown(new)}{ratio}; each tree's runs "
              f"{'bit-equal' if repeat else 'DIFFER'}; runs " + ", ".join(shown(r["passes"][name]) for r in runs))
    same = True
    differ = []
    for name in runs[0]["digests"]:
        digests = {r["digests"][name] for r in runs}
        if len(digests) != 1:
            same = False
            differ.append(name)
    print(f"  every other kernel of fused_block.cu and entry_block.cu, {len(runs[0]['digests'])} calls: outputs "
          + ("bit-identical in all four runs" if same else "DIFFER in " + ", ".join(differ)))
    for label, run in (("DIR", runs[0]), ("this tree", runs[1])):
        print(f"  kernels of entry_block.cu and fused_block.cu that spill in {label}: "
              + ("; ".join(run["spills"]) or "none"))
    print("  one traced MT step's device time, flagship bf16 (chip_smoke.knob_card_steps, knobs off), and block 1:")
    for path in STEP_PATHS:
        old, new = med("steps", path)
        b_old, b_new = med("block1", path)
        delta = f" ({new - old:+.3f})" if old is not None and new is not None else ""
        print(f"    {path}: step {shown(old)} -> {shown(new)}{delta}; runs "
              + ", ".join(shown(r["steps"][path]) for r in runs)
              + f"; block 1 {shown(b_old)} -> {shown(b_new)}; runs " + ", ".join(shown(r["block1"][path]) for r in runs))
    return same


def pass_rows(device):
    """chip_smoke.py's phase-3 rows of the entry-block family in bfloat16 at
    the flagship's block-1 shape, each held to its plain version under
    chip_smoke.py's bars; the two passes' rows printed."""
    import torch

    import chip_smoke as cs

    rows = collections.defaultdict(cs.Row)
    cs.entry_bf16_kernels(device, rows, np.random.default_rng(cs.SEED + 7))
    torch.cuda.empty_cache()
    print("row: device ms (events ms), bound ms, share of bound; the earlier kernel (recorded)")
    for name in ROWS:
        row = rows[name]
        share = f"{100.0 * row.bound / row.device_ms:.1f} %" if row.device_ms else "not measured"
        print(f"  {name}: {cs.shown(row.device_ms)} ({row.ms:.4f}), {row.bound:.4f} by {row.bound_by}, {share}; "
              f"plain {row.plain_ms:.4f}; earlier {RECORDED[name]:.4f} ({100.0 * row.bound / RECORDED[name]:.1f} %)")


def variants(device):
    """ms of other plans of the two passes at the flagship shape (CUDA events
    around ten calls in a row, a tenth of it), each output held first to the
    as-built kernel's bits or to the plain version (chip_smoke.py's bars:
    K5b1 1e-4 of max; K5b2 dW within one ulp plus the parts' and a dy
    flip; d conv_b, zero in exact arithmetic, within the float32 rounding of
    its sum and the as-built kernel's)."""
    import torch

    sys.path.insert(0, os.path.join(REPO, "tools"))
    import bench_k2_bf16_torch as k2b
    import chip_smoke as cs
    from dcase2019_task4_tpu_torch.ops import _build
    from dcase2019_task4_tpu_torch.ops import fused_block as fb
    from dcase2019_task4_tpu_torch.ops import fused_entry_block as fe

    x, dout, vecs, pool, eps, rate, seed = flagship_inputs(device)
    mask = fb.dropout_keep_mask(seed, (*x.shape, vecs[0].shape[-1]), rate, device=device)
    keep = 1.0 - rate
    red_want = fe.entry_block_bwd_reduce_reference(x, dout, *vecs, pool, eps, mask, keep)
    calls = pass_calls(device)
    # pass 2 at the coefficients pass_calls gives it: those of K5b1's own sums
    red = fe.entry_block_bwd_reduce(x, dout, *vecs, pool, eps, rate=rate, seed=seed)
    a, b2 = fb.bwd_coefficients(vecs[2], vecs[5], eps, red[2], red[3], x.numel())
    wants = {}
    for name in calls:
        if "K5b1" in name:
            wants[name] = red_want
        else:
            layout = "crows" if "crows" in name else "planes"
            dw, dcb = fe.entry_block_bwd_wgrad_reference(x, dout, *vecs, a, b2, pool, eps, mask, keep, layout)
            parts = fe.entry_block_bwd_wgrad_parts_reference(x, dout, *vecs, a, b2, pool, eps, mask, keep, layout)
            wants[name] = (dw, dcb, parts)
    dy_max = fe._pass2_dy(x, dout, *vecs, a, b2, pool, eps, mask, keep)[0].abs().max()
    del mask
    flip = cs.bf16_ulp(dy_max).item() * x.float().abs().max().item()
    built = {name: call() for name, call in calls.items()}

    def held(name, outs):
        if all(torch.equal(p, q) for p, q in zip(outs, built[name])):
            return "bit-equal to the as-built kernel"
        if "K5b1" in name:
            err = max((p - q).abs().max().item() / q.abs().max().item() for p, q in zip(outs, wants[name]))
            if not err <= 1e-4:
                raise AssertionError(f"{name}: {err} of max exceeds 1e-4")
            return f"{err:.2e} of max"
        dw, _, parts = wants[name]
        slack = sum(cs.bf16_ulp(p) for p in parts) + flip
        over = ((outs[0] - dw).abs() - cs.bf16_ulp(torch.maximum(outs[0].abs(), dw.abs())) - slack).max().item()
        # d conv_b is zero in exact arithmetic: against the as-built kernel's, both sums' float32 rounding
        dcb_err = (outs[1] - built[name][1]).abs().max().item()
        if over > 0 or dcb_err > 2 * cs.sum_slack(x.numel(), dy_max.item(), 1.0):
            raise AssertionError(f"{name}: dW beyond one ulp + slack by {over}, or d conv_b off by {dcb_err}")
        return "within the bars"

    def timed(fn):
        return cs.time_ms(lambda: [fn() for _ in range(10)]) / 10

    print("  launch plans at the flagship shape (ms, CUDA events, ten calls in a row):")
    planned, resident = fe.bf16_bwd_plan, fe._bf16_resident

    def one_buffer(channels, pool, which):
        return (1,) + planned(channels, pool, which)[1:]

    plans = (("as planned", planned, 1.0), ("one dout buffer", one_buffer, 1.0),
             ("grid at half the resident blocks", planned, 0.5), ("grid at twice the resident blocks", planned, 2.0))
    try:
        for name, plan, waves in plans:
            fe.bf16_bwd_plan = plan
            fe._bf16_resident = lambda *args, w=waves: max(2, int(w * resident(*args)))
            print(f"    {name}: " + "; ".join(f"{call_name} {timed(call):.4f} ({held(call_name, call())})"
                                              for call_name, call in calls.items()))
    finally:
        fe.bf16_bwd_plan, fe._bf16_resident = planned, resident

    print("  source variants at the flagship shape (ms, CUDA events, ten calls in a row); ptxas of the two passes")
    library = _build.library
    main = library()

    class Both:  # a variant's entry-block entries, the rest (the tile count) from the library as built
        def __init__(self, lib):
            self.lib = lib

        def __getattr__(self, name):
            return getattr(self.lib if hasattr(self.lib, name) else main, name)

    try:
        for name, lib, ptxas in k2b.ablation_libraries(SOURCE_VARIANTS, "bf16_kernel", "entry_block.cu"):
            if lib is None:
                continue
            _build.library = lambda lib=lib: Both(lib)
            fe._bf16_resident.cache_clear()
            print(f"    {name}: " + "; ".join(f"{call_name} {timed(call):.4f} ({held(call_name, call())})"
                                              for call_name, call in calls.items()) + "; ptxas " + "; ".join(ptxas))
    finally:
        _build.library = library
        fe._bf16_resident.cache_clear()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--no-tests", action="store_true", help="skip the passes' GPU tests")
    parser.add_argument("--variants", action="store_true", help="also time other plans of the passes")
    parser.add_argument("--against", metavar="DIR", help="also measure the package in DIR beside this one")
    parser.add_argument("--rows-from", metavar="DIR", help=argparse.SUPPRESS)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bench_k5b_bf16_torch: needs an NVIDIA GPU", file=sys.stderr)
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
                                "-p", "no:randomly", "-k", "entry_bwd_bf16 or entry_block_bf16"],
                               cwd=REPO, capture_output=True, text=True)
        print("\n".join(line for line in tests.stdout.splitlines() if "K5b1 bf16" in line))
        print(tests.stdout[-3000:], tests.stderr[-2000:])
        if tests.returncode != 0:
            return tests.returncode

    device = torch.device("cuda", 0)
    for C in (16, 64, 96, 128):
        for which in (1, 2):
            buffers, drows, nbytes = fe.bf16_bwd_plan(C, (2, 4), which)
            print(f"pass {which} at C = {C}, pool (2, 4): {buffers} dout buffer(s) of {drows} rows, {nbytes} bytes; "
                  f"{fe._bf16_resident(0, C, which, buffers, drows)} blocks held at once on {_build.sm_count(0)} SMs")
    pass_rows(device)
    same = True
    if args.against:
        same = against(args.against)
    if args.variants:
        variants(device)
    print(cs.card_line())
    if spilled:
        print(f"bench_k5b_bf16_torch: {spilled} instantiation(s) spill", file=sys.stderr)
        return 1
    if not same:
        print("bench_k5b_bf16_torch: another kernel's outputs differ from DIR's", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
