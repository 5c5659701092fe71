"""Native host-side audio batcher (C++ extension, built on demand).

The port's own copy of dcase2019_task4_tpu/native: builds
dcase2019_task4_tpu_torch/csrc/wavpack.cpp into `build/_wavpack_<hash>.so`
(never next to the source) with the system toolchain the first time it is
requested; like the CUDA library of ops/_build.py the file is keyed by a
hash of its source, so an edited source rebuilds. A machine without g++ uses the pure-Python packer instead
(data/pipeline.py) — host-side semantics shared with the JAX package, not a
device fallback. See wavpack.cpp for what it accelerates and why.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sysconfig
import threading
from typing import List, Optional, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BUILD_DIR = os.path.join(_PKG, "build")
_SRC = os.path.join(_PKG, "csrc", "wavpack.cpp")
with open(_SRC, "rb") as _f:
    _SO = os.path.join(_BUILD_DIR, f"_wavpack_{hashlib.sha256(_f.read()).hexdigest()[:16]}.so")
_lock = threading.Lock()
_module = None
_tried = False


def _build() -> bool:
    include = sysconfig.get_paths()["include"]
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-std=c++17",
        f"-I{include}", _SRC, "-o", tmp,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError):
        if os.path.exists(tmp):
            os.unlink(tmp)
        return False
    os.replace(tmp, _SO)  # atomic: a concurrent loader sees all or nothing
    return True


def _load():
    global _module, _tried
    with _lock:
        if _module is not None or _tried:
            return _module
        _tried = True
        if not os.path.exists(_SO) and not _build():
            return None
        spec = importlib.util.spec_from_file_location("_wavpack", _SO)
        try:
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _module = mod
        except Exception:
            _module = None
        return _module


def available() -> bool:
    return _load() is not None


def decode_wav(path: str, target_sr: int) -> Tuple[np.ndarray, int, str]:
    """→ (int16 mono samples, sample_rate, error string ('' on success))."""
    mod = _load()
    buf, sr, err = mod.decode_wav(path, target_sr)
    return np.frombuffer(buf, dtype=np.int16), sr, err


def pack_batch(
    paths: List[str],
    max_samples: int,
    n_fft: int,
    hop: int,
    target_sr: int,
    n_threads: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """Decode + mono-mix + reflect-pad + pack a whole batch in C++.

    → (int16 [B, max_samples + n_fft], int32 frames [B], per-file errors).
    Rows with a non-empty error are zero-filled; callers fall back to the
    Python path for those files (resampling, exotic encodings)."""
    mod = _load()
    n_threads = n_threads or min(8, os.cpu_count() or 1)
    buf, frames, errors = mod.pack_batch(
        list(paths), int(max_samples), int(n_fft), int(hop), int(target_sr), int(n_threads)
    )
    row = max_samples + n_fft
    audio = np.frombuffer(buf, dtype=np.int16).reshape(len(paths), row)
    return audio, np.frombuffer(frames, dtype=np.int32), errors
