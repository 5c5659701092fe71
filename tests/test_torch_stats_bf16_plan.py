"""K2s on bfloat16 y (csrc/fused_block.cu stats_bf16_kernel) on the host:
its launch plan, how it splits the rows, the order of its sums, and the
plain version against the JAX package.

The kernel runs only on the card, where tests/test_torch_kernels_gpu.py
(`-k k2s_bf16`) and chip_smoke.py hold it to the float64 sums of y. Here:

  * `fused_block.stats_bf16_vec` and `stats_bf16_plan` are the kernel's own
    constants and formulas, read from the source: 8 channels a thread
    (16-byte loads) where C % 8 == 0 and y is 16-byte aligned, else 4;
    one wave of at most the resident blocks, and no more blocks than give
    a thread kStatsUnroll rows (81 at the flagship's block 3, not 528);
  * the kernel's loop, written out (`_thread_rows`): block k takes rows
    [k n / G, (k + 1) n / G), a thread every groups-th row of it, so every
    row is read once by each lane, the blocks' runs differ by at most a
    row, and a thread's float32 runs hold at most 64 rows, at C = 64 (the
    flagship's three row counts), 128, 36 (four channels a thread) and
    1024;
  * that order of float32 runs (Σy with each add's exact rounding error,
    TwoSum) and float64 adds, emulated in numpy on standard-normal bfloat16
    y with one channel whose Σy nearly cancels, at block 3's geometry (C =
    64 and 36; eight rows a thread) and at block 1's (one lane of C = 64;
    runs of 64 rows, where plain float32 runs miss the bar), is within
    1e-6 relative of the float64 sums, the bar the card holds the kernel
    to;
  * the port's plain batch_stats of bfloat16 y against the JAX package's
    `batch_stats` in interpret mode at block 3's geometry (F = 4, C = 64),
    which tests/test_torch_bf16_kernels.py (its first block only) does not
    reach, and at C = 32.
"""

import inspect
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcase2019_task4_tpu.ops import fused_block as jfb
from dcase2019_task4_tpu_torch.ops import _build
from dcase2019_task4_tpu_torch.ops import fused_block as tfb

SRC = (Path(tfb.__file__).parent.parent / "csrc" / "fused_block.cu").read_text()
RUN = 64  # kStatsRun: rows a thread sums in float32 before it adds them into float64


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def test_stats_bf16_plan_matches_the_kernel_source():
    assert tfb._STATS_THREADS == _const("kStatsThreads") == 256
    assert tfb._STATS_UNROLL == _const("kStatsUnroll") == 8
    assert _const("kStatsRun") == RUN
    for line in ("  __shared__ double dsum[2 * V][kStatsThreads];  // per thread: its float64 sums of y, then of y^2",
                 "  const int lanes = C / V, groups = kStatsThreads / lanes;  // groups >= 1: C <= 1024",
                 "  const long long r1 = (blockIdx.x + 1) * rows / gridDim.x;",
                 "  long long r = blockIdx.x * rows / gridDim.x + grp;",
                 "  const long long step = (long long)groups * kStatsUnroll;",
                 "      const long long ru = r0 + (long long)u * groups;",
                 "    load(cur, r);\n    for (int n = 1; r < r1; ++n) {\n      load(nxt, r + step);",
                 "      if (n == kStatsRun / kStatsUnroll || r >= r1) {  // the run into the thread's float64 sums",
                 "__global__ void __launch_bounds__(kStatsThreads, kStatsBlocks)\nstats_bf16_kernel(",
                 "  if (C % 8 == 0 && a % 16 == 0) return 8;",
                 "  return C % 4 == 0 && a % 8 == 0 ? 4 : 0;",
                 "  return bf16 ? launch_stats_bf16(y, partials, out, rows, C, blocks, st)",
                 "  return (int)launch_fold_warps<double>(pa, static_cast<float*>(out), blocks, 2 * C, st);"):
        assert line in SRC, line
    assert _build.RESIDENT_ENTRIES["stats_bf16"] == "dcase_batch_stats_bf16_resident"
    assert "dcase_batch_stats_bf16_resident" in _build.SIGNATURES
    source = inspect.getsource(tfb.batch_stats)
    assert "vec = stats_bf16_vec(C, y.data_ptr() % 16 == 0)" in source
    assert 'stats_bf16_plan(C, rows, _build.resident(y.device.index, "stats_bf16", vec), vec)' in source
    for C in (4, 12, 36, 64, 128, 1024):
        assert tfb.stats_bf16_vec(C) == (8 if C % 8 == 0 else 4)
        assert tfb.stats_bf16_vec(C, aligned16=False) == 4


def _thread_rows(rows, C, vec, blocks):
    """The kernel's loop written out: {(block, thread): [its float32 runs,
    each a list of rows]} of the threads that read (lane 0's group of each
    row group), and the row groups of a block."""
    lanes = C // vec
    groups = tfb._STATS_THREADS // lanes
    out = {}
    for k in range(blocks):
        r0, r1 = k * rows // blocks, (k + 1) * rows // blocks
        for grp in range(groups):
            r, runs = r0 + grp, []
            while r < r1:
                run = []
                for _ in range(RUN // tfb._STATS_UNROLL):
                    if r >= r1:
                        break
                    run += [r + u * groups for u in range(tfb._STATS_UNROLL) if r + u * groups < r1]
                    r += groups * tfb._STATS_UNROLL
                runs.append(run)
            out[(k, grp)] = runs
    return out


# (rows, C, resident): the flagship's three blocks at batch 24 (C = 64), the
# scaled configuration's block 3 (C = 128), block 3's rows at C = 36, a
# small y, and the widest C the wrapper takes
SPLITS = [(24 * 864 * 64, 64, 528), (24 * 432 * 16, 64, 528), (24 * 216 * 4, 64, 528), (24 * 216 * 8, 128, 396),
          (24 * 216 * 4, 36, 528), (2 * 19 * 7, 36, 528), (3 * 37, 1024, 264)]


@pytest.mark.parametrize("rows,C,resident", SPLITS)
def test_stats_bf16_splits_the_rows_in_one_wave_of_equal_runs(rows, C, resident):
    vec = tfb.stats_bf16_vec(C)
    blocks = tfb.stats_bf16_plan(C, rows, resident, vec)
    groups = tfb._STATS_THREADS // (C // vec)
    assert groups >= 1 and blocks == max(1, min(resident, -(-rows // (groups * tfb._STATS_UNROLL))))
    if rows == 24 * 216 * 4 and C == 64:
        assert blocks == 81  # block 3: each thread one batch of eight loads
    runs = [k * rows // blocks for k in range(blocks + 1)]
    lengths = [b - a for a, b in zip(runs, runs[1:])]
    assert max(lengths) - min(lengths) <= 1 and min(lengths) >= 1
    if rows >= resident * groups * tfb._STATS_UNROLL:
        assert blocks == resident
    per_thread = _thread_rows(rows, C, vec, blocks)
    seen = sorted(r for runs in per_thread.values() for run in runs for r in run)
    assert seen == list(range(rows))
    assert all(len(run) <= RUN for runs in per_thread.values() for run in runs)


def _kernel_order_sums(y, C, vec, blocks, two_sum=True):
    """Σy, Σy² of y [rows, n] (float32 values of bfloat16; n = C, or the
    channels of one lane) in the kernel's order at C channels: per thread
    over each run a float32 Σy with the float32 sum of each add's exact
    rounding error (TwoSum; plain float32 adds without `two_sum`) and a
    float32 Σ fma(y, y), each run added into float64, the threads and
    blocks added in float64 (their order moves the float64 sums by far less
    than the bar)."""
    rows, n_ch = y.shape
    groups = tfb._STATS_THREADS // (C // vec)
    s, q = np.zeros(n_ch), np.zeros(n_ch)
    for k in range(blocks):
        r0, r1 = k * rows // blocks, (k + 1) * rows // blocks
        block = y[r0:r1]
        n = -(-block.shape[0] // groups)
        pad = np.zeros((n * groups, n_ch), np.float32)
        pad[:block.shape[0]] = block
        per = pad.reshape(n, groups, n_ch)  # [the thread's j-th row, thread, channel]
        for j0 in range(0, n, RUN):
            run = per[j0:j0 + RUN]
            fs, fe, fq = (np.zeros((groups, n_ch), np.float32) for _ in range(3))
            for v in run:
                t = fs + v
                if two_sum:
                    vb = t - fs
                    fe = fe + ((fs - (t - vb)) + (v - vb))
                fs = t
                fq = (fq.astype(np.float64) + v.astype(np.float64) * v).astype(np.float32)  # one rounding, as fmaf
            s += (fs.astype(np.float64) + fe.astype(np.float64)).sum(axis=0)
            q += fq.astype(np.float64).sum(axis=0)
    return s.astype(np.float32), q.astype(np.float32)


def _cancelled(a):
    """bfloat16 values of a [rows, n] (as float32), column 0 centred first,
    with a[-1, 0] then set to the bfloat16 value nearest minus the sum of
    the rest of column 0, so that column 0 sums to at most half a bfloat16
    ulp of that sum."""
    a = np.array(a, np.float64)
    a[:, 0] -= a[:, 0].mean()
    y = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    y[-1, 0] = -y[:-1, 0].double().sum()
    return y.float().numpy()


def _relative_error(got, want):
    return (np.abs(got.astype(np.float32).astype(np.float64) - want) / np.abs(want)).max()


@pytest.mark.parametrize("rows,C,n_ch", [(24 * 216 * 4, 64, 64), (24 * 216 * 4, 36, 36), (24 * 864 * 64, 64, 8)])
def test_stats_bf16_order_stays_within_the_bar(rows, C, n_ch):
    """The kernel's order on standard-normal bfloat16 y [rows, n_ch] at C
    channels (block 3's geometry in full; block 1's for one lane of eight
    channels), channel 0's last value set to cancel the others' sum to
    within a bfloat16 rounding (`_cancelled`): each channel's sums, as
    float32, within 1e-6 relative of the float64 sums. At block 1, where
    runs hold 64 rows, plain float32 adds (no TwoSum) miss the bar on that
    channel."""
    y = _cancelled(np.random.default_rng(C + n_ch + 7).standard_normal((rows, n_ch)))
    yd = y.astype(np.float64)
    assert abs(yd[:, 0].sum()) < 1e-5 * np.abs(yd[:, 0]).sum()
    vec = tfb.stats_bf16_vec(C)
    blocks = tfb.stats_bf16_plan(C, rows, 528, vec)
    s, q = _kernel_order_sums(y, C, vec, blocks)
    assert _relative_error(s, yd.sum(axis=0)) <= 1e-6 and _relative_error(q, (yd * yd).sum(axis=0)) <= 1e-6
    if rows > 1e6:
        assert _relative_error(_kernel_order_sums(y, C, vec, blocks, two_sum=False)[0], yd.sum(axis=0)) > 1e-6


@pytest.mark.parametrize("shape,pool", [((2, 16, 4, 64), (2, 4)), ((2, 8, 16, 32), (2, 4))])
def test_plain_bf16_batch_stats_match_jax_interpret(shape, pool):
    """The port's plain K2s of bfloat16 y against the JAX package's
    batch_stats in interpret mode: mean and biased variance within 1e-5 of
    their max."""
    y = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    mean_ref, var_ref = jfb.batch_stats(jnp.asarray(y, jnp.bfloat16), pool[1], interpret=True)
    s, sq = tfb.batch_stats(torch.from_numpy(y).to(torch.bfloat16))
    assert s.dtype == sq.dtype == torch.float32
    n = float(np.prod(shape[:3]))
    for name, got, want in (("mean", s / n, mean_ref), ("var", sq / n - (s / n) ** 2, var_ref)):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max(), err_msg=name)
