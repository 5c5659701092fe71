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

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_U = ctypes.c_uint

# C signature of every entry the sources export: name -> (restype, argtypes)
SIGNATURES = {
    "dcase_fused_stft_mel_smem": (_LL, [_I, _I]),
    "dcase_fused_stft_mel_max_mels": (_I, []),
    "dcase_fused_stft_mel": (
        _I, [_P, _I, _LL, _LL, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    ),
    "dcase_conv3x3": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "dcase_bn_glu_pool_tiles": (_I, [_I, _I, _I]),
    "dcase_conv3x3_tiles": (_I, [_I, _I]),
    "dcase_conv3x3_wgrad": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "dcase_bn_glu_pool": (
        _I, [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P, _U, _F, _I, _P],
    ),
    "dcase_bn_glu_pool_bwd": (
        _I, [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P, _U, _F, _I, _P],
    ),
    "dcase_bn_bwd_fixup": (_I, [_P, _P, _P, _P, _P, _LL, _I, _P]),
    "dcase_batch_stats": (_I, [_P, _P, _P, _LL, _I, _I, _P]),
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


def check(status: int, what: str):
    if status != 0:
        raise KernelError(f"{what}: CUDA error {status}")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def max_shared_bytes(device) -> int:
    """Opt-in shared memory per block (232,448 bytes on an H100)."""
    import torch

    props = torch.cuda.get_device_properties(device)
    return int(getattr(props, "shared_memory_per_block_optin", 232448))
