"""Eval batch assembly, without pandas (counterpart of the inference part
of dcase2019_task4_tpu/data/pipeline.py, which imports the jax frontend).

Batches are fixed-size int16 PCM buffers, reflect-padded per clip on the
host exactly as librosa's centre padding (ops/mel.host_reflect_pad); the
evaluator dequantizes them on the device. Plain wav sources go through the
C++ batch packer (dcase2019_task4_tpu_torch.native, built with g++ on
first use), as the JAX package's BatchPipeline._pack_audio does; other
sources, and machines without g++, through Python.
"""

from __future__ import annotations

import csv
from types import SimpleNamespace
from typing import Dict, Iterator, List

import numpy as np

from dcase2019_task4_tpu_torch.ops.mel import host_reflect_pad


def quantize_audio_int16(audio: np.ndarray) -> np.ndarray:
    """f32 [-1, 1] → int16 PCM (bit-exact for audio that was 16-bit wav)."""
    return np.clip(np.round(audio * 32768.0), -32768, 32767).astype(np.int16)


def read_manifest(tsv_path: str) -> SimpleNamespace:
    """A filename TSV → the fields SyntheticAudioSource reads: `kind`
    ("strong" with onset/offset/event_label, "weak" with event_labels,
    otherwise "unlabeled"), unique `filenames` in order of appearance, and
    per-file `events` [(label, onset, offset)] or `weak_labels`. Same
    schema detection as data/manifests.load_manifest."""
    with open(tsv_path, newline="") as f:
        rows = list(csv.DictReader(f, delimiter="\t"))
    cols = set(rows[0]) if rows else set()
    if "filename" not in cols:
        raise ValueError(f"{tsv_path}: no filename column ({sorted(cols)})")
    filenames: List[str] = list(dict.fromkeys(r["filename"] for r in rows))
    if {"onset", "offset", "event_label"} <= cols:
        events: Dict[str, list] = {f: [] for f in filenames}
        for r in rows:
            if r["event_label"]:
                events[r["filename"]].append((r["event_label"], float(r["onset"]), float(r["offset"])))
        return SimpleNamespace(kind="strong", filenames=filenames,
                               events=[events[f] for f in filenames])
    if "event_labels" in cols:
        first = {}
        for r in rows:
            first.setdefault(r["filename"], r["event_labels"])
        return SimpleNamespace(kind="weak", filenames=filenames,
                               weak_labels=[first[f].split(",") if first[f] else [] for f in filenames])
    return SimpleNamespace(kind="unlabeled", filenames=filenames)


def dir_manifest(names: List[str]) -> SimpleNamespace:
    """Minimal manifest for a directory of wavs (no labels)."""
    return SimpleNamespace(kind="unlabeled", filenames=list(names))


class Stream:
    """Filenames plus the audio source that renders or reads them."""

    def __init__(self, manifest, source):
        self.filenames = list(manifest.filenames)
        self.source = source

    def __len__(self):
        return len(self.filenames)

    def get_audio(self, idx: int) -> np.ndarray:
        return self.source.get_audio(self.filenames[idx])


def _native_pack(stream: Stream, idx: List[int], max_samples: int, n_fft: int, hop_length: int):
    """(audio, frames, bad rows) from the C++ packer, or None when it does
    not apply (no toolchain, or a source that is not a wav directory)."""
    if not hasattr(stream.source, "path_for"):
        return None
    from dcase2019_task4_tpu_torch import native

    if not native.available():
        return None
    paths = [stream.source.path_for(stream.filenames[i]) for i in idx]
    audio, frames, errors = native.pack_batch(paths, max_samples, n_fft, hop_length, 44100)
    return np.array(audio), np.array(frames), [k for k, e in enumerate(errors) if e]


def pack_audio(stream: Stream, idx: List[int], max_samples: int, n_fft: int, hop_length: int,
               max_frames: int):
    """Clips idx → (int16 [B, max_samples + n_fft], int32 valid frames [B])."""
    packed = _native_pack(stream, idx, max_samples, n_fft, hop_length)
    if packed is None:
        padded, frames = host_reflect_pad(
            [stream.get_audio(i) for i in idx], max_samples, n_fft, hop_length, max_frames
        )
        return quantize_audio_int16(padded), frames
    audio, frames, bad = packed
    if bad:  # rows the packer could not decode (resampling, exotic codecs)
        padded, f2 = host_reflect_pad(
            [stream.get_audio(idx[k]) for k in bad], max_samples, n_fft, hop_length, max_frames
        )
        audio[bad] = quantize_audio_int16(padded)
        frames[bad] = f2
    return audio, frames


def iter_eval_batches(
    stream: Stream,
    batch_size: int,
    max_samples: int,
    n_fft: int,
    hop_length: int,
    max_frames: int,
) -> Iterator[Dict]:
    """Fixed-size batches over a stream; the last batch is padded by
    repeating the final clip (callers slice by `n_valid`)."""
    n = len(stream)
    for start in range(0, n, batch_size):
        idx = list(range(start, min(start + batch_size, n)))
        n_valid = len(idx)
        idx += [idx[-1]] * (batch_size - n_valid)
        audio, frames = pack_audio(stream, idx, max_samples, n_fft, hop_length, max_frames)
        yield {
            "audio": audio,
            "frames": frames,
            "filenames": [stream.filenames[i] for i in idx[:n_valid]],
            "n_valid": n_valid,
        }
