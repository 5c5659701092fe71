"""K4w, the entry conv's weight gradient (csrc/entry_block.cu
entry_conv_dw_f32_kernel and entry_conv_dw_bf16_kernel), on the host: the
kernels' plan and how they split the batch, the bfloat16 kernel's class
order, and the plain weight gradient against the JAX package.

The kernels run only on the card, where tests/test_torch_kernels_gpu.py and
chip_smoke.py hold them to the plain version. Here:

  * `entry_conv.wgrad_plan` (tile rows, about 32 KB of dy, at most the
    kernels' 128 pixels; dynamic shared memory) is the kernels' own
    formulas, read from the source, and fits every width
    `entry_conv_packable` admits, in both types;
  * the launch is one wave of the resident blocks, each an equal run of the
    batch's time rows, clip after clip, cut into tiles of at most `rows`
    rows inside a clip, at a T that leaves a short last tile; the wrapper
    hands the kernel that plan (a recording stand-in for the library) and a
    16-byte-aligned dy;
  * the float32 kernel's threads take every (pixel, channel, row) of a tile
    once; the bfloat16 kernel's order of a tile's pixels (k = (p % 2) H +
    p / 2 under the parity partition) puts exactly the pixels of
    `wgrad_parts(dy, "parity")` in each half: its tiles, patches, dy rows
    and two half-sums, written out in numpy, give the plain version's part
    sums (one part where F is odd);
  * the plain K4w against `jax.vjp` of the JAX package's conv layer on the
    same rounded operands where tests/test_torch_entry_conv.py and
    tests/test_torch_entry_bf16.py (C = 64, F = 64, T a multiple of the
    tiles) do not reach: C = 36, F = 63, and a T that leaves a short tile.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcase2019_task4_tpu.models import layers as jlayers
from dcase2019_task4_tpu_torch.ops import _build
from dcase2019_task4_tpu_torch.ops import entry_conv as tec

SRC = (Path(tec.__file__).parent.parent / "csrc" / "entry_block.cu").read_text()
FREQS = [1, 7, 63, 64, 128]
CHANNELS = [4, 36, 64, 96, 128]
DTYPES = [torch.float32, torch.bfloat16]


def _body(name):
    """The source of kernel `name`, from its name to its closing brace."""
    start = SRC.index(f"\n{name}(")
    return SRC[start:SRC.index("\n}\n", start)]


def _smem(F, C, dtype, rows):
    """The kernels' dynamic shared memory, written out: float32, two dy tiles
    [rows F][C] or the shares' sums [S][10][C], whichever is more, and two x
    tiles with their halo; bfloat16, two dy tiles [128][CP + 8] and two patch
    matrices [16][136]."""
    if dtype == torch.bfloat16:
        cp = 64 if C <= 64 else 128
        return 2 * (2 * 128 * (cp + 8) + 2 * 16 * 136)
    halo = 4 * ((((rows + 2) * (F + 2)) + 3) // 4)
    return 4 * (max(2 * rows * F * C, (256 // (C // 4)) * 10 * C) + 2 * halo)


def test_wgrad_plan_matches_the_kernel_source():
    for line in ("constexpr int kDwThreads = 256;", "constexpr int kDwTilePix = 128;",
                 "constexpr int kDwKS = kDwTilePix + 8;", "return 4 * (((rows + 2) * (F + 2) + 3) / 4);",
                 "__host__ __device__ inline int dw_shares(int C) { return kDwThreads / (C / 4); }",
                 "size_t dw_f32_smem(int F, int C, int rows) {",
                 "const size_t tiles = 2 * (size_t)rows * F * C, shares = (size_t)dw_shares(C) * 10 * C;",
                 "return 4 * ((tiles > shares ? tiles : shares) + 2 * (size_t)dw_halo(F, rows));",
                 "return 2 * (2 * (size_t)kDwTilePix * (CP + 8) + 2 * 16 * (size_t)kDwKS);",
                 "C % 4 != 0 || rows < 1 ||\n      rows * F > kDwTilePix ||",
                 "const size_t smem = !bf16_x ? dw_f32_smem(F, C, rows) : C <= 64 ? dw_bf16_smem<64>() : "
                 "dw_bf16_smem<128>();",
                 "int dcase_entry_conv_wgrad_resident(int bf16, int F, int C, int rows) {"):
        assert line in SRC, line
    for name, value in (("kDwThreads", tec._DW_THREADS), ("kDwTilePix", tec._DW_TILE_PIXELS)):
        assert value == int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))
    # the flagship: tiles of two rows, 32 KB of dy in float32, 16 KB in bfloat16
    assert tec.wgrad_plan(64, 64, torch.float32) == (2, 4 * (2 * 8192 + 2 * 264))
    assert tec.wgrad_plan(64, 64, torch.bfloat16) == (2, 2 * (2 * 128 * 72 + 2 * 16 * 136))
    assert _build.RESIDENT_ENTRIES["conv_wgrad"] == "dcase_entry_conv_wgrad_resident"
    assert "dcase_entry_conv_wgrad_resident" in _build.SIGNATURES
    assert "entry_conv_wgrad_kernel" not in SRC and not hasattr(tec, "_WGRAD_SLOTS")


@pytest.mark.parametrize("F", FREQS)
def test_wgrad_plan_fits_every_admitted_width(F, monkeypatch):
    """At least one row a tile, whole rows of at most 128 pixels (the
    bfloat16 product's K), about 32 KB of dy unless one row is more (and
    so under the 16 KB tiles the probe times), the shared memory within
    the 227 KB a block may opt into, the float32 shares' sums and the
    bfloat16 slot scratch within it; a C that is no multiple of four
    refused."""
    for C in CHANNELS:
        assert tec.entry_conv_packable(F, C, 7)
        for dtype in DTYPES:
            esize = 2 if dtype == torch.bfloat16 else 4
            for target in (32768, 16384):
                monkeypatch.setattr(tec, "_DW_TILE_BYTES", target)
                rows, smem = tec.wgrad_plan(F, C, dtype)
                assert rows == max(1, min(target // (F * C * esize), 128 // F))
                assert rows * F <= 128 and (rows * F * C * esize <= target or rows == 1)
                assert smem == _smem(F, C, dtype, rows) <= _build.MAX_SHARED
            if dtype == torch.float32:
                assert (256 // (C // 4)) * 10 * C * 4 <= smem
            else:
                cp = 64 if C <= 64 else 128
                assert (16 * 8 // cp) * 2 * 10 * cp * 4 <= 2 * 128 * (cp + 8) * 2
    with pytest.raises(ValueError):
        tec.wgrad_plan(F, 6, torch.float32)


def _tiles(G, B, T, rows):
    """The kernels' tiles, block by block: block k takes the batch's time rows
    [k n / G, (k + 1) n / G) (n = B T) and cuts them into tiles of up to
    `rows` rows that end at its run's end or the clip's → [[(b, t0,
    trows), ...] per block]."""
    n, out = B * T, []
    for k in range(G):
        cur, end, tiles = k * n // G, (k + 1) * n // G, []
        while cur < end:
            trows = min(rows, T - cur % T, end - cur)
            tiles.append((cur // T, cur % T, trows))
            cur += trows
        out.append(tiles)
    return out


SPLITS = [(528, 24, 864, 64, 64), (396, 3, 37, 64, 36), (8, 2, 11, 7, 4), (264, 2, 45, 128, 128), (132, 1, 300, 1, 8)]


@pytest.mark.parametrize("resident,B,T,F,C", SPLITS)
def test_wgrad_splits_the_batch_in_one_wave_of_equal_runs(resident, B, T, F, C):
    """In both types: one wave of the resident blocks, never more than the
    batch's rows; the runs differ by at most one row and cover every row of
    every clip once, in order; every tile lies in one clip and has at most
    `rows` rows, and at a T that is no multiple of `rows` a clip ends in a
    short tile."""
    for dtype in DTYPES:
        rows = tec.wgrad_plan(F, C, dtype)[0]
        G = _build.wave_grid(resident, B, T)
        assert G == min(resident, B * T)
        blocks = _tiles(G, B, T, rows)
        lengths = [sum(tr for _, _, tr in tiles) for tiles in blocks]
        assert min(lengths) >= 1 and max(lengths) - min(lengths) <= 1
        seen = [(b, t0 + i) for tiles in blocks for b, t0, tr in tiles for i in range(tr)]
        assert seen == [(b, t) for b in range(B) for t in range(T)]
        assert all(1 <= tr <= rows and t0 + tr <= T for tiles in blocks for _, t0, tr in tiles)
        if T % rows:
            assert any(t0 + tr == T and tr < rows for tiles in blocks for _, t0, tr in tiles)
    for name in ("entry_conv_dw_f32_kernel", "entry_conv_dw_bf16_kernel"):
        body = _body(name)
        for line in ("const int r_end = (int)((blockIdx.x + 1) * n / gridDim.x);",
                     "int cur = (int)(blockIdx.x * n / gridDim.x), ahead = cur;",
                     "auto trows_at = [&](int r) { return min(min(rows, T - r % T), r_end - r); };",
                     "ahead += trows", "  stage(0);\n", "for (int buf = 0; cur < r_end; buf ^= 1) {",
                     "cp_async_wait_all();\n    __syncthreads();", "stage(buf ^ 1);"):
            assert line in body, (name, line)
        assert body.count("__syncthreads()") == 3, name  # one a tile, two for the slot


@pytest.mark.parametrize("C", CHANNELS)
def test_float32_threads_take_every_pixel_channel_and_row_once(C):
    """Thread tid of the float32 kernel takes the ten rows (nine taps, then
    db) of channels 4 (tid % Q) .. (Q = C / 4) of the pixels tid / Q, + S,
    ... (S = 256 // Q; tid / Q ≥ S idle): every (pixel, channel, row) of a
    tile once; K5b2 float32 takes five rows a thread in two halves of the
    same loop."""
    body = _body("entry_conv_dw_f32_kernel")
    assert "const int sq = tid % Q, sh = tid / Q;" in body
    assert "if (sh < S) add_dw_f32<10>(dw, dys + buf * tile, C, xts + buf * halo, off, F, trows * F, sh, S, sq, 0);" \
        in body
    assert "if (dw_on) add_dw_f32<5>(dw, xb, KS, xt, off, F, tpix, sh, S, sq, 5 * tg);" in SRC
    Q, tpix = C // 4, 130
    S = 256 // Q
    seen = np.zeros((tpix, C, 10), np.int64)
    for tid in range(256):
        sq, sh = tid % Q, tid // Q
        if sh >= S:
            continue
        for p in range(sh, tpix, S):
            seen[p, 4 * sq: 4 * sq + 4, :] += 1
    assert (seen == 1).all()


def _emulate_bf16(x, dy, G, parity):
    """The bfloat16 kernel written out in numpy (float64 sums): per block its
    tiles; per tile the patch matrix [16][128] (rows 0-8 the taps of
    pixel(k), zeros outside the tensor and past the tile; row 9 ones) and the
    dy tile [128][C] (row k pixel(k)'s dy, zeros past the tile), pixel(k) =
    2 (k % 64) + k / 64 under parity, else k; the slot's two half-sums of
    patches^T · dy over k < 64 and k ≥ 64 → [G, 2, 10, C]."""
    B, T, F = x.shape
    C = dy.shape[-1]
    rows = tec.wgrad_plan(F, C, torch.bfloat16)[0]
    K, H = tec._DW_TILE_PIXELS, tec._DW_TILE_PIXELS // 2
    assert ("auto pixel = [&](int k) { return parity ? 2 * (k % H) + k / H : k; };" in
            _body("entry_conv_dw_bf16_kernel"))
    ks = np.arange(K)
    pix = 2 * (ks % H) + ks // H if parity else ks
    slots = np.zeros((G, 2, 10, C))
    for blk, tiles in enumerate(_tiles(G, B, T, rows)):
        for b, t0, tr in tiles:
            inside = pix < tr * F
            pm = np.zeros((10, K))
            pm[9] = 1.0
            dyt = np.zeros((K, C))
            t, f = t0 + pix // F, pix % F
            dyt[inside] = dy[b, t[inside], f[inside]]
            for tap in range(9):
                tt, ff = t + tap // 3 - 1, f + tap % 3 - 1
                ok = inside & (tt >= 0) & (tt < T) & (ff >= 0) & (ff < F)
                pm[tap, ok] = x[b, tt[ok], ff[ok]]
            for h in range(2):
                slots[blk, h] += pm[:, h * H:(h + 1) * H] @ dyt[h * H:(h + 1) * H]
    return slots


@pytest.mark.parametrize("shape,C,G", [((2, 37, 64), 36, 7), ((2, 9, 63), 16, 3), ((1, 11, 8), 8, 4),
                                       ((2, 5, 128), 12, 2)])
def test_bf16_class_order_gives_the_parity_parts(shape, C, G):
    """The kernel's halves of k hold the output-frequency parities of
    `wgrad_parts(dy, "parity")` (F even: even frequencies below 64, odd
    above; F odd: one part, the two halves added), and the ones row db:
    the emulated slots, summed, give the plain version's part sums and db,
    both in float64, within 1e-12 of their max."""
    rng = np.random.default_rng(sum(shape) + C)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()
    dy = torch.from_numpy(rng.standard_normal(shape + (C,)).astype(np.float32)).bfloat16()
    parity = shape[2] % 2 == 0
    slots = _emulate_bf16(x.double().numpy(), dy.double().numpy(), G, parity).sum(axis=0)
    xp = torch.nn.functional.pad(x.double(), (1, 1, 1, 1))  # the plain version's sums, in float64
    want = [tec._wgrad(xp, part)[:, :, 0].reshape(9, C).numpy() for part in tec.wgrad_parts(dy.double(), "parity")]
    got = [slots[0, :9], slots[1, :9]] if parity else [slots[0, :9] + slots[1, :9]]
    assert len(got) == len(want) == (2 if parity else 1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12 * np.abs(w).max())
    db = dy.double().sum(dim=(0, 1, 2)).numpy()
    np.testing.assert_allclose(slots[0, 9] + slots[1, 9], db, rtol=0, atol=1e-12 * np.abs(db).max())


class _Recorder:
    """A stand-in for the kernel library that records dcase_entry_conv_wgrad's
    arguments (B, T, F, C, blocks, rows, bf16, classes), whether dy was
    16-byte aligned, and its partials' shape."""

    def __init__(self):
        self.calls = []

    def dcase_entry_conv_wgrad(self, x, dy, partials, out, B, T, F, C, blocks, rows, bf16, classes, stream):
        self.calls.append((B, T, F, C, blocks, rows, bf16, classes, dy % 16 == 0))
        return 0


@pytest.mark.parametrize("resident,B,T,F,C", SPLITS[1:])
def test_wgrad_launches_one_wave_of_equal_runs(resident, B, T, F, C, monkeypatch):
    """The wrapper hands K4w a grid of `wave_grid(resident)` blocks (the
    resident entry asked with the type, F, C and the tile height), the tile
    height of `wgrad_plan`, two classes in bfloat16 at an even F (else one), and a dy
    that is 16-byte aligned (a misaligned dy is copied first); the slots
    come back [classes, blocks, 10 C], one launch counted."""
    rec = _Recorder()
    asked = []
    monkeypatch.setattr(_build, "library", lambda: rec)
    monkeypatch.setattr(_build, "resident", lambda index, kernel, *plan: asked.append((kernel, plan)) or resident)
    monkeypatch.setattr(_build, "stream_handle", lambda device: 0)
    monkeypatch.setattr(tec, "_check_cuda", lambda x, C, what: None)
    rng = np.random.default_rng(B + T + F + C)
    for dtype in DTYPES:
        x = torch.from_numpy(rng.standard_normal((B, T, F)).astype(np.float32)).to(dtype)
        store = torch.zeros(B * T * F * C + 1, dtype=dtype)
        dy = store[1:].view(B, T, F, C)  # 2 or 4 bytes past an aligned start
        assert dy.is_contiguous() and dy.data_ptr() % 16
        before = (tec.entry_conv_wgrad.launches, tec.entry_conv_wgrad.launches_bf16)
        dw, db, slots = tec._launch_wgrad(x, dy)
        bf16 = dtype == torch.bfloat16
        classes = 2 if bf16 and F % 2 == 0 else 1
        G = _build.wave_grid(resident, B, T)
        rows = tec.wgrad_plan(F, C, dtype)[0]
        assert rec.calls[-1] == (B, T, F, C, G, rows, int(bf16), classes, True)
        assert asked[-1] == ("conv_wgrad", (int(bf16), F, C, rows))
        assert dw.shape == (3, 3, 1, C) and db.shape == (C,) and slots.shape == (classes, G, 10 * C)
        after = (tec.entry_conv_wgrad.launches, tec.entry_conv_wgrad.launches_bf16)
        assert after == (before[0] + (not bf16), before[1] + bf16)


# --------------------------------------------- plain versions against JAX


def _ulp(a):
    """The bfloat16 spacing at |a| (floored at the smallest normal)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126))) - 7)


def _jax_wgrad(x, dy):
    """dW [3, 3, 1, C], db [C] by jax.vjp of the JAX package's conv layer at
    x [B, T, F] and dy [B, T, F, C] (float32 arrays), in float32."""
    C = dy.shape[-1]
    params = {"w": jnp.zeros((3, 3, 1, C), jnp.float32), "b": jnp.zeros((C,), jnp.float32)}
    _, vjp = jax.vjp(lambda p: jlayers.conv2d_apply(p, jnp.asarray(x)[..., None]), params)
    (grads,) = vjp(jnp.asarray(dy))
    return np.asarray(grads["w"]), np.asarray(grads["b"])


CASES = {"C36": ((2, 37, 64), 36), "F63": ((2, 37, 63), 64), "C128": ((1, 9, 16), 128), "short tile": ((2, 37, 32), 12)}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
def test_plain_wgrad_matches_jax(case, dtype):
    """float32: dW and db within 1e-5 of their max of JAX's. bfloat16: the
    JAX vjp on the rounded operands, in float32, with dy cut into the parts
    of `wgrad_parts(dy, "parity")`: each part's float32 sum within 1e-5 of
    the parts' max, dW within one bfloat16 ulp of each part of the sum of
    JAX's parts each rounded to bfloat16, db within 1e-5 of its max. "short
    tile" leaves a short last tile in both types (T = 37 against tiles of 4
    rows), C36 and F63 in bfloat16 (tiles of 2 rows)."""
    shape, C = CASES[case]
    rng = np.random.default_rng(sum(shape) + C + len(case))
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    dy = torch.from_numpy(rng.standard_normal(shape + (C,)).astype(np.float32)).to(dtype)
    assert case != "short tile" or shape[1] % tec.wgrad_plan(shape[2], C, dtype)[0]
    dw, db = tec.entry_conv_wgrad(x, dy)
    assert dw.dtype == db.dtype == torch.float32 and dw.shape == (3, 3, 1, C)
    xf, dyf = x.float().numpy(), dy.float().numpy()
    want_w, want_b = _jax_wgrad(xf, dyf)
    np.testing.assert_allclose(db.numpy(), want_b, rtol=0, atol=1e-5 * np.abs(want_b).max())
    if dtype == torch.float32:
        np.testing.assert_allclose(dw.numpy(), want_w, rtol=0, atol=1e-5 * np.abs(want_w).max())
        return
    _, _, parts = tec.entry_conv_wgrad_parts(x, dy)
    jparts = [_jax_wgrad(xf, p.float().numpy())[0] for p in tec.wgrad_parts(dy, "parity")]
    assert parts.shape[0] == len(jparts) == (2 if shape[2] % 2 == 0 else 1)
    top = max(np.abs(p).max() for p in jparts)
    for got, want in zip(parts.numpy(), jparts):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * top)
    rounded = lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    want = sum(rounded(p) for p in jparts)
    limit = sum(_ulp(p) for p in jparts)
    assert (np.abs(dw.numpy() - want) <= limit).all()


def test_fold_parts_in_the_warp_order():
    """`_build.fold_parts(slots, warps=True)`, which reads K4w's part sums
    from its slots, adds them in fold_classes_warps_kernel's order: lane l
    of 32 adds slots l, l + 32, ... in float64, then each lane adds lane l ^
    o's sum for o = 16, 8, 4, 2, 1, and lane 0's sum is rounded to float32;
    within 1e-6 of the slot-order fold."""
    fold = (Path(tec.__file__).parent.parent / "csrc" / "fold.cuh").read_text()
    for line in ("for (int s = lane; s < slots; s += 32) t += (double)p[s * slot_stride];",
                 "for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);",
                 "total += k < n_round ? rounded<TR>((float)t) : (float)t;"):
        assert line in fold, line
    assert "launch_fold_classes_warps<float, TX>(partials, out, blocks, 10 * C, classes" in SRC
    slots = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 75, 7)).astype(np.float32))
    got = _build.fold_parts(slots, warps=True)
    lanes = np.zeros((2, 32, 7))
    for s in range(75):
        lanes[:, s % 32] += slots[:, s].double().numpy()
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, np.arange(32) ^ o]
    assert got.dtype == torch.float32 and torch.equal(got, torch.from_numpy(lanes[:, 0].astype(np.float32)))
    in_order = _build.fold_parts(slots)
    assert (got - in_order).abs().max().item() <= 1e-6 * in_order.abs().max().item()
