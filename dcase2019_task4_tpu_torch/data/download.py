"""AudioSet clip acquisition, host-side and IO-bound (counterpart of
dcase2019_task4_tpu/data/download.py, which reads and writes its tables
with pandas; this one has none).

The reference downloader's contract (download_data.py:27-178): for each
`Y<id>_<start>_<end>.wav` filename of a metadata TSV, fetch the YouTube
source audio, crop [start, end], save a 44.1 kHz wav into the audio
directory the TSV maps to; skip files already on disk; write the failures
(all files, when no downloader backend is installed) to
`missing_files_<set>.tsv`, so runs degrade gracefully.

The fetch needs the optional `yt_dlp` (or `youtube_dl`) package and
network access; without them this module still writes the missing-files
manifests, the part the training pipeline consumes. Set TSVs are read with
data/manifests.py, and a manifest is written as pandas' `to_csv(sep="\\t",
index=False)` writes it: the csv module with QUOTE_MINIMAL and "\\n" line
ends, so an error text holding a tab, a quote or a line end is quoted the
same way.
"""

from __future__ import annotations

import csv
import multiprocessing
import os
import re
from typing import List, Optional, Tuple

from dcase2019_task4_tpu_torch.data.manifests import load_manifest
from dcase2019_task4_tpu_torch.utils.logger import get_logger

LOG = get_logger()


def parse_audioset_filename(filename: str) -> Tuple[str, float, float]:
    """'Y<ytid>_<start>_<end>.wav' → (ytid, start_sec, end_sec)
    (download_data.py:34-43 naming convention)."""
    m = re.match(r"^Y(.+)_([0-9.]+)_([0-9.]+)\.wav$", filename)
    if not m:
        raise ValueError(f"not an AudioSet segment filename: {filename}")
    return m.group(1), float(m.group(2)), float(m.group(3))


def _backend():
    """The installed downloader module: yt_dlp, else youtube_dl, else None."""
    try:
        import yt_dlp as ydl  # noqa

        return ydl
    except ImportError:
        pass
    try:
        import youtube_dl as ydl  # noqa

        return ydl
    except ImportError:
        return None


def download_file(filename: str, result_dir: str, sample_rate: int = 44100,
                  backend=None) -> Optional[str]:
    """Fetch and crop one clip. Returns None on success, else an error
    string (per-file fault isolation, download_data.py:97-109).

    The backend is asked for bestaudio converted to wav (FFmpegExtractAudio),
    then the segment [start, end) the filename names is cropped at
    `sample_rate` and written as 16-bit PCM. `backend` injects a
    youtube_dl-compatible module (None: the installed one)."""
    out_path = os.path.join(result_dir, filename)
    if os.path.exists(out_path):
        return None
    ydl = backend if backend is not None else _backend()
    if ydl is None:
        return "no downloader backend (youtube_dl/yt_dlp not installed)"
    tmp = out_path + ".src.wav"
    try:
        ytid, start, end = parse_audioset_filename(filename)
        opts = {
            "format": "bestaudio/best",
            # %(ext)s resolves to wav after the extract-audio postprocess
            "outtmpl": out_path + ".src.%(ext)s",
            "postprocessors": [
                {"key": "FFmpegExtractAudio", "preferredcodec": "wav"},
            ],
            "quiet": True,
            "no_warnings": True,
        }
        with ydl.YoutubeDL(opts) as y:
            y.download([f"https://www.youtube.com/watch?v={ytid}"])
        from dcase2019_task4_tpu_torch.data.audio_io import read_wav, write_wav

        audio, sr = read_wav(tmp, sample_rate)
        lo, hi = int(start * sr), int(end * sr)
        if lo >= len(audio):
            raise ValueError(
                f"segment start {start}s beyond source length {len(audio)/sr:.1f}s")
        write_wav(out_path, audio[lo:hi], sr)
        return None
    except Exception as e:  # noqa: BLE001 — per-file isolation by design
        return f"{type(e).__name__}: {e}"
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def download(
    filenames: List[str],
    result_dir: str,
    n_jobs: int = 3,
    chunk_size: int = 10,
    sample_rate: int = 44100,
) -> List[Tuple[str, str]]:
    """Parallel download with skip-existing resume (download_data.py:112-178)
    → the missing files as (filename, error) rows, in `filenames` order."""
    os.makedirs(result_dir, exist_ok=True)
    todo = [f for f in filenames if not os.path.exists(os.path.join(result_dir, f))]
    LOG.info(f"download: {len(filenames)} files, {len(todo)} to fetch → {result_dir}")
    errors = []
    if todo:
        if _backend() is None:
            LOG.warning("no downloader backend available; emitting missing-files manifest only")
            errors = [(f, "no downloader backend") for f in todo]
        else:
            with multiprocessing.Pool(n_jobs) as pool:
                results = pool.starmap(
                    download_file,
                    [(f, result_dir, sample_rate) for f in todo],
                    chunksize=chunk_size,
                )
            errors = [(f, err) for f, err in zip(todo, results) if err is not None]
    return errors


def write_missing(path: str, rows: List[Tuple[str, str]]):
    """The missing-files manifest, byte for byte as pandas'
    `DataFrame(rows, columns=["filename", "error"]).to_csv(path, sep="\\t",
    index=False)` writes it."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t", lineterminator="\n", quoting=csv.QUOTE_MINIMAL, quotechar='"',
                       doublequote=True)
        w.writerow(("filename", "error"))
        w.writerows(rows)


def download_sets(cfg, tsv_paths: List[str], n_jobs: int = 3, chunk_size: int = 10):
    """Download every set's audio; write missing_files_<set>.tsv beside the
    audio tree (download_data.py:158-168, 193-235). → {set: missing rows}."""
    out = {}
    for tsv in tsv_paths:
        filenames = load_manifest(tsv).filenames
        audio_dir = cfg.paths.audio_dir_for_meta(tsv)
        missing = download(filenames, audio_dir, n_jobs, chunk_size, cfg.dsp.sample_rate)
        set_name = os.path.splitext(os.path.basename(tsv))[0]
        if missing:
            os.makedirs(cfg.paths.audio_dir, exist_ok=True)
            manifest_path = os.path.join(cfg.paths.audio_dir, f"missing_files_{set_name}.tsv")
            write_missing(manifest_path, missing)
            LOG.warning(f"{set_name}: {len(missing)} files missing → {manifest_path}")
        out[set_name] = missing
    return out
