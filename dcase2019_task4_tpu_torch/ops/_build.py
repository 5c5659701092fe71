"""Build and load the package's CUDA kernels (csrc/*.cu).

Every source compiles with its own nvcc process, all started together, and
the objects link into one shared library with a plain C interface, loaded
with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC
         -Xptxas -v -c csrc/<name>.cu -o build/<tmp>/<name>.o     (one per source)
    nvcc -shared -o build/libdcase_kernels_<hash>.so build/<tmp>/*.o

The build runs at first use, into `dcase2019_task4_tpu_torch/build/`
(listed in .gitignore), keyed by a hash of the sources so an edited source
rebuilds and an unchanged one is loaded as is. Only sources in the
repository are compiled. The library's C entries take device pointers and
the stream as `void*` and return `cudaGetLastError()` after the launch;
`check` turns a non-zero value into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

MAX_SHARED = 232448  # opt-in dynamic shared memory a block may use on an H100, bytes

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_U = ctypes.c_uint

# C signature of every entry the sources export: name -> (restype, argtypes)
SIGNATURES = {
    "dcase_fused_stft_mel": (
        _I, [_P, _I, _LL, _LL, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    ),
    "dcase_fused_stft_mel_onedot": (_I, [_P, _I, _LL, _LL, _P, _P, _P, _P, _P, _I, _P] + [_I] * 6 + [_P]),
    "dcase_conv3x3": (_I, [_P, _P, _P, _P] + [_I] * 9 + [_P]),
    "dcase_bn_glu_pool_tiles": (_I, [_I, _I, _I, _I]),
    "dcase_bn_glu_pool_resident": (_I, [_I]),
    "dcase_conv3x3_wgrad": (_I, [_P, _P, _P, _P] + [_I] * 8 + [_P]),
    # dropout arguments of every kernel that drops: seed, threshold, keep_scale, packed
    "dcase_bn_glu_pool": (_I, [_P] * 8 + [_I] * 6 + [_F, _P, _U, _F, _I, _I, _I, _P]),
    "dcase_bn_glu_pool_bwd": (_I, [_P] * 11 + [_I] * 6 + [_F, _P, _U, _F, _I, _I, _I, _I, _I, _P]),
    "dcase_bn_bwd_fixup_recompute": (_I, [_P] * 11 + [_I] * 6 + [_F, _P, _U, _F, _I, _I, _I, _I, _I, _P]),
    "dcase_bn_bwd_fixup_recompute_resident": (_I, [_I, _I, _I, _I]),
    "dcase_bn_bwd_fixup": (_I, [_P, _P, _P, _P, _P, _LL, _I, _I, _P]),
    "dcase_batch_stats": (_I, [_P, _P, _P, _LL, _I, _I, _I, _P]),
    "dcase_batch_stats_bf16_resident": (_I, [_I]),
    "dcase_entry_conv": (_I, [_P] * 6 + [_I] * 8 + [_P]),
    "dcase_entry_conv_bf16_resident": (_I, []),
    "dcase_entry_conv_f32_resident": (_I, []),
    "dcase_entry_conv_wgrad": (_I, [_P] * 4 + [_I] * 8 + [_P]),
    "dcase_entry_conv_wgrad_resident": (_I, [_I] * 4),
    "dcase_entry_block_fwd_resident": (_I, [_I]),
    "dcase_entry_block_fwd": (_I, [_P] * 10 + [_I] * 6 + [_F, _P, _U, _F, _I, _I, _P]),
    "dcase_entry_block_fwd_bf16_resident": (_I, [_I]),
    "dcase_entry_block_fwd_bf16": (_I, [_P] * 10 + [_I] * 6 + [_F, _P, _U, _F, _I, _I, _I, _P]),
    "dcase_entry_block_bwd_reduce_resident": (_I, [_I] * 3),
    "dcase_entry_block_bwd_reduce": (_I, [_P] * 12 + [_I] * 6 + [_F, _P, _U, _F, _I, _I, _I, _I, _I, _P]),
    "dcase_entry_block_bwd_wgrad_resident": (_I, [_I] * 3),
    "dcase_entry_block_bwd_wgrad": (_I, [_P] * 14 + [_I] * 6 + [_F, _P, _U, _F, _I, _I, _I, _I, _P]),
    "dcase_entry_block_bwd_bf16_resident": (_I, [_I] * 4),
    "dcase_entry_block_bwd_reduce_bf16": (_I, [_P] * 12 + [_I] * 6 + [_F, _P, _U, _F, _I, _I, _I, _I, _P]),
    "dcase_entry_block_bwd_wgrad_bf16": (_I, [_P] * 14 + [_I] * 6 + [_F, _P, _U, _F, _I, _I, _I, _I, _I, _P]),
    "dcase_dropout_mask": (_I, [_P, _LL, _P, _U, _I, _P]),
}


class KernelError(RuntimeError):
    """A kernel failed to build, or a launch returned a CUDA error."""


def sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise KernelError("nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin, PATH)")
    return found


def library_path() -> Path:
    return BUILD_DIR / f"libdcase_kernels_{source_hash()}.so"


@functools.cache
def build() -> dict:
    """Compile the sources unless a library for this source hash exists.
    Returns {"path", "seconds", "log"} (log: nvcc's output, with ptxas's
    register and shared-memory report per kernel; empty when cached)."""
    target = library_path()
    if target.exists():
        return {"path": str(target), "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objdir:
        jobs = []
        for src in sources():
            obj = os.path.join(objdir, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj]
            jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = "", []
        for cmd, _, proc in jobs:  # wait for every compiler before judging any
            out, _ = proc.communicate()
            log += out
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
        if failed:
            raise KernelError("\n".join(failed))
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, "-shared", "-o", tmp, *(obj for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise KernelError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    seconds = time.perf_counter() - t0
    os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
    (BUILD_DIR / "build.log").write_text(log)
    return {"path": str(target), "seconds": seconds, "log": log}


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(build()["path"])
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def sass_counts(path, names, opcodes=("HGMMA", "HMMA", "FFMA")) -> dict:
    """Opcodes in the machine code of the built library at `path`
    (`cuobjdump -sass`): {mangled kernel name: {opcode: count}} for each
    kernel whose name holds one of `names`. HGMMA is `wgmma`, HMMA
    `mma.sync` (tensor cores), FFMA a float32 FMA on the CUDA cores."""
    cuobjdump = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True, check=True).stdout
    counts, current = {}, None
    for line in out.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            current = counts.setdefault(name, dict.fromkeys(opcodes, 0)) if any(n in name for n in names) else None
        elif current is not None and "*/" in line:
            # "/*0c10*/  @P0 HMMA.16816.F32.BF16 R24, R4, R20, R24 ;"
            words = line.split("*/", 1)[1].split()
            if words and words[0].startswith("@"):
                words = words[1:]
            op = words[0].split(".")[0] if words else ""
            if op in current:
                current[op] += 1
    return counts


def check(status: int, what: str):
    if status != 0:
        raise KernelError(f"{what}: CUDA error {status}")


def round_to(t, dtype):
    """t rounded to `dtype` and held in float32 (t itself for float32): an
    operand of a product that a kernel takes in `dtype`."""
    return t.to(dtype).float()


def fold_parts(slots, warps: bool = False):
    """[parts, slots, width] per-block partial sums of a weight gradient →
    [parts, width] float32: each part's slots added in float64, then rounded
    to float32, in the order fold.cuh adds them before it rounds each part:
    in slot order (fold_classes_kernel), or under `warps` in
    fold_classes_warps_kernel's (lane l of 32 adds slots l, l + 32, ... in
    order, then lane l adds lane l ^ o's sum for o = 16, 8, 4, 2, 1; lane
    0's). So the kernel's folded output is, bit for bit, the sum over the
    parts in part order of each part rounded to the compute dtype; and each
    part shows whether the kernel split the sum as the original does."""
    import torch

    lanes = 32 if warps else 1
    total = torch.zeros((slots.shape[0], lanes, slots.shape[2]), dtype=torch.float64, device=slots.device)
    for s in range(slots.shape[1]):
        total[:, s % lanes] += slots[:, s].double()
    lane = torch.arange(lanes, device=slots.device)
    o = lanes // 2
    while o:
        total = total + total[:, lane ^ o]
        o //= 2
    return total[:, 0].float()


def count_launch(wrapper, name: str, dtype) -> None:
    """One launch of `wrapper`'s kernel: added to its counter `name`, or to
    `name`_bf16 for the bfloat16 instantiation of a kernel that has both."""
    import torch

    if dtype == torch.bfloat16:
        name += "_bf16"
    setattr(wrapper, name, getattr(wrapper, name) + 1)


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device `index` (132 on an H100)."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def wave_grid(resident: int, B: int, tiles: int, halves: bool = False) -> int:
    """Blocks of a kernel launched as one wave: the `resident` blocks the
    card holds, each an equal run of the batch's B · `tiles` tiles (clip
    after clip; never more blocks than tiles), one partial slot each where
    it sums. Under `halves` (the crows layout's dW in batch halves) an even
    number, half of them over each half of the clips."""
    if halves:
        return 2 * max(1, min(resident // 2, (B // 2) * tiles))
    return max(1, min(resident, B * tiles))


# the library's entry that counts the blocks an SM holds, by kernel
RESIDENT_ENTRIES = {"fwd_f32": "dcase_entry_block_fwd_resident", "fwd_bf16": "dcase_entry_block_fwd_bf16_resident",
                    "reduce_f32": "dcase_entry_block_bwd_reduce_resident",
                    "wgrad_f32": "dcase_entry_block_bwd_wgrad_resident",
                    "bwd_bf16": "dcase_entry_block_bwd_bf16_resident",
                    "conv_bf16": "dcase_entry_conv_bf16_resident", "conv_f32": "dcase_entry_conv_f32_resident",
                    "conv_wgrad": "dcase_entry_conv_wgrad_resident", "stats_bf16": "dcase_batch_stats_bf16_resident"}


@functools.cache
def resident(index: int, kernel: str, *plan) -> int:
    """Blocks of `kernel` ("fwd_f32" / "fwd_bf16": K5f in float32 /
    bfloat16, (C,); "reduce_f32" / "wgrad_f32": pass 1 / pass 2 in float32,
    (C, buffers, drows); "bwd_bf16": a bfloat16 pass, (C, which, buffers,
    drows); "conv_bf16": K4f / K5s in bfloat16, (), the fewer of its two
    modes'; "conv_f32": K5s in float32, (); "conv_wgrad": K4w, (bfloat16
    0 or 1, F, C, rows); "stats_bf16": K2s on bfloat16 y, (channels a thread,))
    that device `index` holds at once under its
    plan: what one SM holds (registers and shared memory, from the CUDA
    occupancy calculator) times its SMs."""
    import torch

    with torch.cuda.device(index):
        blocks = getattr(library(), RESIDENT_ENTRIES[kernel])(*plan)
    if blocks < 1:
        raise KernelError(f"{kernel} does not fit an SM under {plan}")
    return blocks * sm_count(index)


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
