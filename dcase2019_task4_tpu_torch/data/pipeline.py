"""Host→device data pipeline without pandas: packed streams, batch
assembly, prefetch (counterpart of dcase2019_task4_tpu/data/pipeline.py).

  * labels for each stream are packed ONCE into a dense [N, T', C] array
    (Manifest.encode_targets): the hot path is pure array gathers;
  * audio is reflect-padded on the host into fixed int16 [B, L + n_fft]
    buffers, exactly as librosa's centre padding (ops/mel.host_reflect_pad),
    and featurized on the device inside the step. Plain wav sources go
    through the C++ batch packer (dcase2019_task4_tpu_torch.native, built
    with g++ on first use); other sources, and machines without g++,
    through Python;
  * a background thread assembles batches ahead of the step, and
    `device_prefetch` copies them to the card `depth` batches ahead from
    pinned host memory, without blocking the host;
  * `DeviceResidentData` (`--device_cache`) instead renders a small
    training set once and keeps every row on the device, where each
    epoch's batches are gathered there by index;
  * data parallel: every rank draws the same global batch from the shared
    seed, reorders it shard-major and builds only its own cut.

A worker that fails re-raises its error in the consumer after the batches
it made (the JAX package's worker ends the epoch quietly instead).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from dcase2019_task4_tpu_torch.data.encoder import LabelCodec
from dcase2019_task4_tpu_torch.data.manifests import Manifest
from dcase2019_task4_tpu_torch.data.sampler import MultiStreamSampler
from dcase2019_task4_tpu_torch.ops.mel import host_reflect_pad
from dcase2019_task4_tpu_torch.parallel.mesh import interleave_for_sharding
from dcase2019_task4_tpu_torch.parallel.multihost import host_shard_pairs


def quantize_audio_int16(audio: np.ndarray) -> np.ndarray:
    """f32 [-1, 1] → int16 PCM (bit-exact for audio that was 16-bit wav)."""
    return np.clip(np.round(audio * 32768.0), -32768, 32767).astype(np.int16)


def dir_manifest(names: List[str]) -> Manifest:
    """Minimal manifest for a directory of wavs (no labels)."""
    return Manifest("unlabeled", list(names), [{"filename": n} for n in names], ["filename"])


class Stream:
    """One data stream (weak / unlabeled / synthetic): filenames, packed
    targets (with a `codec`), the audio source, an optional in-memory audio
    cache and an optional second view `source2` (same labels, an independent
    render of every clip)."""

    def __init__(self, name: str, manifest: Manifest, source, codec: Optional[LabelCodec] = None,
                 sample_rate: int = 44100, hop_length: int = 511, pooling_time_ratio: int = 8,
                 cache_audio: bool = False, source2=None):
        self.name = name
        self.manifest = manifest
        self.filenames = list(manifest.filenames)
        self.source = source
        self.source2 = source2
        self.targets = (None if codec is None else
                        manifest.encode_targets(codec, sample_rate, hop_length, pooling_time_ratio))
        self._cache: Optional[dict] = {} if cache_audio else None
        self._cache2: Optional[dict] = {} if cache_audio else None

    def __len__(self):
        return len(self.filenames)

    def _get(self, source, cache, idx: int) -> np.ndarray:
        if cache is not None and idx in cache:
            return cache[idx]
        a = source.get_audio(self.filenames[idx])
        if cache is not None:
            cache[idx] = a
        return a

    def get_audio(self, idx: int) -> np.ndarray:
        return self._get(self.source, self._cache, idx)

    def get_audio2(self, idx: int) -> np.ndarray:
        assert self.source2 is not None, f"stream {self.name} has no view-2 source"
        return self._get(self.source2, self._cache2, idx)


def _native_paths(items):
    """Wav paths of the (stream, idx) items for the C++ packer, or None when
    it does not apply (no toolchain, or a source that is not a wav tree)."""
    if not all(hasattr(s.source, "path_for") for s, _ in items):
        return None
    from dcase2019_task4_tpu_torch import native

    if not native.available():
        return None
    return [s.source.path_for(s.filenames[i]) for s, i in items]


def pack_items(items, max_samples: int, n_fft: int, hop_length: int, max_frames: int):
    """[(stream, idx)] → (int16 [B, max_samples + n_fft], int32 valid frames [B])."""
    paths = _native_paths(items)
    if paths is None:
        padded, frames = host_reflect_pad([s.get_audio(i) for s, i in items], max_samples, n_fft,
                                          hop_length, max_frames)
        return quantize_audio_int16(padded), frames
    from dcase2019_task4_tpu_torch import native

    audio, frames, errors = native.pack_batch(paths, max_samples, n_fft, hop_length, 44100)
    audio, frames = np.array(audio), np.array(frames)
    bad = [k for k, e in enumerate(errors) if e]
    if bad:  # rows the packer could not decode (resampling, exotic codecs)
        padded, f2 = host_reflect_pad([items[k][0].get_audio(items[k][1]) for k in bad], max_samples,
                                      n_fft, hop_length, max_frames)
        audio[bad] = quantize_audio_int16(padded)
        frames[bad] = f2
    return audio, frames


def pack_audio(stream: Stream, idx: List[int], max_samples: int, n_fft: int, hop_length: int,
               max_frames: int):
    """Clips idx of one stream → (int16 audio, int32 valid frames)."""
    return pack_items([(stream, i) for i in idx], max_samples, n_fft, hop_length, max_frames)


def pin_batch(batch: Dict) -> Dict:
    """Arrays of a batch as tensors in pinned (page-locked) host memory."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory() if isinstance(v, np.ndarray) else v
            for k, v in batch.items()}


def device_prefetch(batch_iter, depth: int = 2, device="cuda") -> Iterator[Dict]:
    """Copy each batch's arrays to `device` `depth` batches ahead of the
    consumer. On a card the copy is `non_blocking`, which overlaps the host
    only from pinned memory (`BatchPipeline.iter_epoch(pin=True)` pins in its
    worker thread); `device_prefetch.batches` counts the batches copied to a
    card and `device_prefetch.pinned` those whose every array came from
    pinned memory. On the CPU the arrays are wrapped, not copied."""
    import collections

    device = torch.device(device)

    def put(b):
        out, pinned = {}, True
        for k, v in b.items():
            if isinstance(v, np.ndarray):
                v = torch.from_numpy(v)
            if isinstance(v, torch.Tensor):
                if device.type != "cpu":
                    pinned = pinned and v.is_pinned()
                v = v.to(device, non_blocking=True)
            out[k] = v
        if device.type != "cpu":
            device_prefetch.batches += 1
            device_prefetch.pinned += int(pinned)
        return out

    buf = collections.deque()
    it = iter(batch_iter)
    for b in it:
        buf.append(put(b))
        if len(buf) >= depth:
            break
    while buf:
        out = buf.popleft()
        for b in it:
            buf.append(put(b))
            break
        yield out


device_prefetch.batches = 0
device_prefetch.pinned = 0


class BatchPipeline:
    """Assembles [weak | unlabeled | synthetic] batches for the train step.

    Batch layout follows the reference's MultiStreamBatchSampler composition
    (main.py:238-247): contiguous per-stream sub-batches so loss masks are
    static slices.

    `batch_sizes` are per-shard sizes. With `n_shards` > 1 the sampler
    draws the global batch, that layout tiled `n_shards` times
    ([w·n | u·n | s·n]), and `local_pairs` reorders it shard-major
    (`interleave_for_sharding`: each contiguous 1/n_shards chunk is a whole
    [w | u | s] layout) and keeps this process's contiguous
    1/process_count cut (`host_shard_pairs`). Every process runs the same
    sampler from the same seed, so the processes' cuts, in process order,
    are the shard-major global batch. With one process a card, n_shards =
    process_count = the world size.
    """

    def __init__(
        self,
        streams: Sequence[Stream],
        batch_sizes: Sequence[int],
        max_samples: int,
        n_fft: int,
        hop_length: int,
        max_frames: int,
        seed: int = 0,
        n_shards: int = 1,
        process_index: int = 0,
        process_count: int = 1,
    ):
        if n_shards % process_count:
            raise ValueError(f"{n_shards} shards do not divide over {process_count} processes")
        self.streams = list(streams)
        self.batch_sizes = list(batch_sizes)
        self.n_shards, self.process_index, self.process_count = n_shards, process_index, process_count
        self.sampler = MultiStreamSampler([len(s) for s in streams], [b * n_shards for b in batch_sizes], seed)
        self.max_samples = max_samples
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.max_frames = max_frames
        # paired-teacher-view mode: every training stream carries a second
        # independently-rendered view; batches gain an "audio2" array the
        # step's teacher pass featurizes instead of the student's audio
        self.paired_views = len(self.streams) > 0 and all(s.source2 is not None for s in self.streams)
        assert self.paired_views or not any(s.source2 is not None for s in self.streams), (
            "paired views must be all-streams-or-none (mixed batches would "
            "silently hand some teacher rows the student view)")

    def __len__(self):
        return len(self.sampler)

    @property
    def batch_size(self):
        """The global batch size."""
        return self.sampler.batch_size

    def stream_slices(self):
        """Per-shard stream slices (the global ones with one shard)."""
        slices, start = [], 0
        for b in self.batch_sizes:
            slices.append(slice(start, start + b))
            start += b
        return slices

    def local_pairs(self, pairs: np.ndarray) -> np.ndarray:
        """A global [batch, 2] of (stream_id, idx) → this process's cut of
        its shard-major order (the pairs themselves with one shard)."""
        if self.n_shards > 1:
            pairs = interleave_for_sharding(pairs, self.batch_sizes, self.n_shards)
        if self.process_count > 1:
            pairs = host_shard_pairs(pairs, self.process_index, self.process_count)
        return pairs

    def assemble(self, pairs: np.ndarray) -> Dict[str, np.ndarray]:
        """pairs: a global [batch, 2] of (stream_id, idx) → this process's
        batch dict (int16 audio)."""
        items = [(self.streams[s], i) for s, i in self.local_pairs(pairs)]
        audio, frames = pack_items(items, self.max_samples, self.n_fft, self.hop_length, self.max_frames)
        batch = {"audio": audio, "frames": frames, "target": np.stack([s.targets[i] for s, i in items])}
        if self.paired_views:
            padded, _ = host_reflect_pad([s.get_audio2(i) for s, i in items], self.max_samples, self.n_fft,
                                         self.hop_length, self.max_frames)
            batch["audio2"] = quantize_audio_int16(padded)
        return batch

    def iter_epoch(self, epoch: int, prefetch: int = 2, pin: bool = False) -> Iterator[Dict]:
        """The epoch's batches, assembled by a background thread up to
        `prefetch` ahead (none with prefetch 0), their arrays in pinned
        tensors with `pin`. An error of the worker is raised here. Closing
        the generator early (or dropping it) stops the worker."""
        batches = self.sampler.epoch_batches(epoch)
        make = (lambda b: pin_batch(self.assemble(b))) if pin else self.assemble
        if prefetch <= 0:
            for b in batches:
                yield make(b)
            return
        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        stop = object()
        failed: List[BaseException] = []
        cancel = threading.Event()

        def put(item) -> bool:
            while not cancel.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for b in batches:
                    if not put(make(b)):
                        return
            except BaseException as e:  # handed to the consumer
                failed.append(e)
            finally:
                put(stop)

        t = threading.Thread(target=worker, name="BatchPipeline.iter_epoch", daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                yield item
        finally:
            cancel.set()
            t.join()
        if failed:
            raise failed[0]


class DeviceResidentData:
    """The whole (small) training set resident in device memory (the JAX
    package's DeviceResidentData, data/pipeline.py:279-405, on one device).

    Every stream's clips are rendered once, reflect-padded and quantized to
    int16 on the host exactly as `BatchPipeline.assemble` does, stacked in
    stream order with their frame counts and float32 targets (and "audio2"
    with paired views), the rows padded to a multiple of max(batch, 8) by
    repeating the last row, then copied to `device` one array at a time.
    `epoch_indices` maps the sampler's (stream, index) pairs to these rows,
    so a gathered batch is bit for bit the streamed one.

    `max_bytes` (8 GiB, as in JAX) guards the size: the full DESED training
    set at 44.1 kHz is about 16 GiB of int16 and is refused with a
    ValueError, not left to run out of memory.

    Data parallel (the JAX package's `DeviceResidentData(mesh=)`): every
    rank keeps the whole row store on its card and gathers its cut of each
    shard-major global batch (`BatchPipeline.local_pairs`), so the size
    guard is a card's. A multi-host `mesh` is refused, as the JAX package
    refuses several processes (its hosts stream their cuts)."""

    def __init__(self, pipeline: BatchPipeline, device="cuda", max_bytes: int = 8 << 30, mesh=None):
        if mesh is not None and mesh.multihost:
            raise ValueError("device-resident data is not multi-host: under --multihost each process streams "
                             "its cut of the batches")
        self._local_pairs = pipeline.local_pairs
        sizes = [len(s) for s in pipeline.streams]
        n_total = sum(sizes)
        self.offsets = np.cumsum([0] + sizes[:-1]).astype(np.int32)
        pad_len = pipeline.max_samples + pipeline.n_fft  # host_reflect_pad's layout
        t_shape = pipeline.streams[0].targets.shape[1:]
        est = n_total * (pad_len * 2 * (2 if pipeline.paired_views else 1) + 4 + int(np.prod(t_shape)) * 4)
        if est > max_bytes:
            raise ValueError(
                f"device-resident dataset would need ~{est / 2**30:.1f} GiB "
                f"(> {max_bytes / 2**30:.1f} GiB cap) for {n_total} clips — "
                "use the streamed pipeline (or raise max_bytes)"
            )
        pad_args = (pipeline.max_samples, pipeline.n_fft, pipeline.hop_length, pipeline.max_frames)
        audio_rows, audio2_rows, frame_rows, target_rows = [], [], [], []
        chunk = 64  # bounds the host's float32 staging memory
        for s in pipeline.streams:
            for lo in range(0, len(s), chunk):
                idx = range(lo, min(lo + chunk, len(s)))
                padded, frames = host_reflect_pad([s.get_audio(i) for i in idx], *pad_args)
                audio_rows.append(quantize_audio_int16(padded))
                frame_rows.append(frames)
                if pipeline.paired_views:
                    padded2, _ = host_reflect_pad([s.get_audio2(i) for i in idx], *pad_args)
                    audio2_rows.append(quantize_audio_int16(padded2))
            target_rows.append(s.targets)
        arrays = {"audio": np.concatenate(audio_rows), "frames": np.concatenate(frame_rows),
                  "target": np.concatenate(target_rows).astype(np.float32)}
        if audio2_rows:
            arrays["audio2"] = np.concatenate(audio2_rows)
        # rows to a multiple of the batch (the last repeated): the scaler's
        # pass reads fixed [B] chunks and masks the tail by n_real; the
        # sampler never emits a row at or past n_real
        self.n_real = n_total
        pad = (-n_total) % max(pipeline.sampler.batch_size, 8)
        if pad:
            arrays = {k: np.concatenate([v, np.repeat(v[-1:], pad, 0)]) for k, v in arrays.items()}
        device = torch.device(device)
        self.data = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
        self.nbytes = est

    def epoch_indices(self, sampler: MultiStreamSampler, epoch: int) -> np.ndarray:
        """[steps, B] int32 rows of one epoch: this process's cut of the
        sampler's (stream_id, index) pairs through the stream offsets."""
        pairs = sampler.epoch_batches(epoch)
        if len(pairs):
            pairs = np.stack([self._local_pairs(p) for p in pairs])
        return (self.offsets[pairs[..., 0]] + pairs[..., 1]).astype(np.int32)

    def iter_epoch(self, sampler: MultiStreamSampler, epoch: int) -> Iterator[Dict[str, torch.Tensor]]:
        """One epoch's batches gathered on the device: the `epoch_indices`
        rows uploaded once, every resident array `index_select`ed by each
        step's row (the JAX package's make_device_epoch gathers inside its
        scan). The batches equal `BatchPipeline.iter_epoch`'s bit for bit."""
        rows = torch.as_tensor(self.epoch_indices(sampler, epoch), dtype=torch.int64,
                               device=self.data["audio"].device)
        for r in rows:
            yield {k: v.index_select(0, r) for k, v in self.data.items()}


def iter_eval_batches(
    stream: Stream,
    batch_size: int,
    max_samples: int,
    n_fft: int,
    hop_length: int,
    max_frames: int,
) -> Iterator[Dict]:
    """Fixed-size batches over a stream; the last batch is padded by
    repeating the final clip (callers slice by `n_valid`). Holds the
    targets where the stream has them."""
    n = len(stream)
    for start in range(0, n, batch_size):
        idx = list(range(start, min(start + batch_size, n)))
        n_valid = len(idx)
        idx += [idx[-1]] * (batch_size - n_valid)
        audio, frames = pack_audio(stream, idx, max_samples, n_fft, hop_length, max_frames)
        batch = {
            "audio": audio,
            "frames": frames,
            "filenames": [stream.filenames[i] for i in idx[:n_valid]],
            "n_valid": n_valid,
        }
        if stream.targets is not None:
            batch["target"] = np.stack([stream.targets[i] for i in idx])
        yield batch
