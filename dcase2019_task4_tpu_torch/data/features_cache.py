"""The on-disk feature cache in the reference's .npy layout (counterpart of
dcase2019_task4_tpu/data/features_cache.py).

For workflows that want the reference's precomputed features
(DatasetDcase2019Task4.extract_features_from_meta,
DatasetDcase2019Task4.py:233-269), `precompute_features` featurizes clips
in batches on the device (K1: log-mel, or the linear mel) and writes one
`<clip>.npy` per file under
  <feature_dir>/sr44100_win2048_hop511_mels64[_nolog]/features/
(the reference's directory scheme, DatasetDcase2019Task4.py:82-87);
`NpyFeatureSource` reads them back. `drop_missing_audio` is the training
path's tolerance of absent wavs.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from dcase2019_task4_tpu_torch.data.manifests import manifest_from_rows
from dcase2019_task4_tpu_torch.utils.logger import get_logger


def cache_dir_name(dsp, save_log_feature: bool = True) -> str:
    name = f"sr{dsp.sample_rate}_win{dsp.n_window}_hop{dsp.hop_length}_mels{dsp.n_mels}"
    return name if save_log_feature else name + "_nolog"


def precompute_features(manifest, source, cfg, base_feature_dir: Optional[str] = None,
                        save_log_feature: bool = True, batch_size: int = 24, device="cuda") -> List[str]:
    """Featurize every clip of `manifest` on `device` in batches of
    `batch_size` and cache each as float32 [valid frames, n_mels] .npy.
    Audio that cannot be read is skipped with a logged error (the
    reference's behaviour); files already cached are not computed again.
    Returns the filenames cached, in manifest order of their batches."""
    import torch

    from dcase2019_task4_tpu_torch.eval.evaluate import resolve_device
    from dcase2019_task4_tpu_torch.ops.mel import MelFrontend, host_reflect_pad

    log = get_logger()
    device = resolve_device(str(device))
    d = cfg.dsp
    out_dir = os.path.join(base_feature_dir or cfg.paths.feature_dir, cache_dir_name(d, save_log_feature),
                           "features")
    os.makedirs(out_dir, exist_ok=True)
    fe = MelFrontend(sample_rate=d.sample_rate, n_window=d.n_window, hop_length=d.hop_length, n_mels=d.n_mels,
                     f_min=d.f_min, f_max=d.f_max, max_frames=d.max_frames, amin=d.amin, top_db=d.top_db,
                     device=device)
    done: List[str] = []
    pending: List[tuple] = []

    def npy(name: str) -> str:
        return os.path.join(out_dir, os.path.splitext(name)[0] + ".npy")

    def flush():
        if not pending:
            return
        names, clips = zip(*pending)
        padded, frames = host_reflect_pad(list(clips), d.max_samples, d.n_window, d.hop_length, d.max_frames)
        padded = torch.as_tensor(padded, device=device)
        with torch.no_grad():
            if save_log_feature:
                feats = fe.log_mel(padded, torch.as_tensor(frames, device=device))
            else:
                feats = fe.linear_mel(padded)
        for name, nf, feat in zip(names, frames, feats.cpu().numpy()):
            np.save(npy(name), feat[:nf].astype(np.float32))
            done.append(name)
        pending.clear()

    for name in manifest.filenames:
        if os.path.exists(npy(name)):
            done.append(name)
            continue
        try:
            clip = source.get_audio(name)
        except (FileNotFoundError, ValueError, OSError) as e:
            log.error(f"File {name} is in the tsv file but audio is unavailable: {e}")
            continue
        pending.append((name, clip))
        if len(pending) >= batch_size:
            flush()
    flush()
    return done


class NpyFeatureSource:
    """Reads cached features (the reference's get_feature_file,
    DatasetDcase2019Task4.py:183-195): `get_features`, not audio."""

    def __init__(self, cfg, base_feature_dir: Optional[str] = None, save_log_feature: bool = True):
        base = base_feature_dir or cfg.paths.feature_dir
        self.dir = os.path.join(base, cache_dir_name(cfg.dsp, save_log_feature), "features")

    def get_features(self, filename: str) -> np.ndarray:
        return np.load(os.path.join(self.dir, os.path.splitext(filename)[0] + ".npy"))


def drop_missing_audio(manifest, source, logger=None):
    """Drop manifest rows whose audio is unreadable, with an error log per
    file — the reference's tolerance behaviour
    (DatasetDcase2019Task4.py:254-262). Returns a filtered Manifest."""
    log = logger or get_logger()
    missing = []
    for name in manifest.filenames:
        try:
            if hasattr(source, "path_for"):
                if not os.path.isfile(source.path_for(name)):
                    raise FileNotFoundError(source.path_for(name))
            else:
                source.get_audio(name)
        except (FileNotFoundError, ValueError, OSError):
            log.error(f"File {name} is in the tsv file but the audio is not present!")
            missing.append(name)
    if not missing:
        return manifest
    gone = set(missing)
    return manifest_from_rows([r for r in manifest.rows if r["filename"] not in gone], manifest.columns)
