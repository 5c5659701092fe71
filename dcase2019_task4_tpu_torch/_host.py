"""Host modules of the JAX package that the port reuses, loaded without pandas.

`dcase2019_task4_tpu/data/encoder.py` and `data/audio_io.py` need only
numpy (scipy lazily), but `dcase2019_task4_tpu/data/__init__.py` imports
`data.manifests`, which imports pandas at module level; a plain
`import dcase2019_task4_tpu.data.encoder` therefore needs pandas, and the
GPU machine has none. This module executes those two files of the JAX
package as they are (the same code, not a copy) under private module
names, without running the subpackage's `__init__`. The other reused
modules (`config`, `utils.scaler`, `utils.logger`, `native`) import
normally: their packages' `__init__` files pull in neither jax nor pandas.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import dcase2019_task4_tpu

_JAX_PKG = Path(dcase2019_task4_tpu.__file__).resolve().parent


def _load(relpath: str):
    name = f"{__name__}.{Path(relpath).stem}"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, _JAX_PKG / relpath)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


encoder = _load("data/encoder.py")
audio_io = _load("data/audio_io.py")

LabelCodec = encoder.LabelCodec
SyntheticAudioSource = audio_io.SyntheticAudioSource
WavAudioSource = audio_io.WavAudioSource
synth_clip = audio_io.synth_clip
write_wav = audio_io.write_wav
