"""Checkpoint evaluation (counterpart of dcase2019_task4_tpu/eval/evaluate.py,
the reference's TestModel.py:25-62): rebuild config, scaler, codec,
frontend and model from a checkpoint on an explicit device, run batched
inference over a wav directory or filename TSV, write the events TSV (and
optionally the weak clip-tag TSV), and with `test_model` score a labelled
set: event- and segment-based F1 and weak tagging F1, and with
`tune_thresholds` the tuned per-class thresholds and median windows
(eval/thresholds.py). `predict_long` serves wavs of any length in windows
of the model's clip length. No jax and no pandas.

Data parallel (`mesh`, parallel/mesh.py; the JAX evaluator's mesh, which
shards each batch over devices): each rank infers every world-th file
(`shard_manifest`), and the ranks' probabilities are gathered on every
rank (`all_gather_objects`, host tensors) in the file order of a
single-process run. Decoding, scoring, threshold tuning and the results are
then the single-process ones on every rank; rank 0 alone writes the TSVs.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from dcase2019_task4_tpu_torch.config import Config, DSPConfig, ModelConfig, PathsConfig, TrainConfig
from dcase2019_task4_tpu_torch.data.audio_io import SyntheticAudioSource, WavAudioSource
from dcase2019_task4_tpu_torch.data.encoder import LabelCodec
from dcase2019_task4_tpu_torch.data.manifests import load_manifest, shard_manifest, subpart_manifest
from dcase2019_task4_tpu_torch.data.pipeline import Stream, dir_manifest, iter_eval_batches, quantize_audio_int16
from dcase2019_task4_tpu_torch.eval.decode import (
    decode_batch,
    grids_to_events,
    merge_window_events,
    write_events_tsv,
)
from dcase2019_task4_tpu_torch.eval.sed_scores import compute_strong_metrics
from dcase2019_task4_tpu_torch.eval.tagging import TaggingF1
from dcase2019_task4_tpu_torch.models.crnn import CRNN
from dcase2019_task4_tpu_torch.ops.mel import MelFrontend, host_reflect_pad
from dcase2019_task4_tpu_torch.parallel.mesh import all_gather_objects
from dcase2019_task4_tpu_torch.train import checkpoints as ckpt
from dcase2019_task4_tpu_torch.train.steps import make_eval_features, make_predict_step
from dcase2019_task4_tpu_torch.utils.logger import get_logger
from dcase2019_task4_tpu_torch.utils.scaler import Scaler


def config_from_metadata(meta: Dict) -> Config:
    c = meta["config"]
    return Config(
        paths=PathsConfig(**c["paths"]),
        dsp=DSPConfig(**c["dsp"]),
        model=ModelConfig(
            **{
                k: (tuple(tuple(x) if isinstance(x, list) else x for x in v) if isinstance(v, list) else v)
                for k, v in c["model"].items()
            }
        ),
        train=TrainConfig(**c["train"]),
    )


def resolve_device(name: str) -> torch.device:
    """A torch device; "cuda" without a usable card raises (never falls
    back to the CPU)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False")
    return device


class CheckpointEvaluator:
    def __init__(self, ckpt_path: Optional[str] = None, device="cuda", synthetic_audio: bool = False, logger=None,
                 mesh=None, _prebuilt=None):
        """From a checkpoint of either package at `ckpt_path`, or from a
        built (cfg, model, scaler, codec, meta) in `_prebuilt` (as
        `from_torch_checkpoint` builds it; the JAX evaluator's hook)."""
        self.log = logger or get_logger()
        self.device = resolve_device(str(device))
        self.mesh = mesh
        # float32 work (the whole float32 model; the GRU, heads and features of
        # a bfloat16 one) in full float32 on the card: cuDNN convolutions
        # default to TF32 (about three decimal digits), which the reference
        # does not use. The model takes float32 and bfloat16 compute and
        # raises for any other.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if _prebuilt is not None:
            self.cfg, model, self.scaler, self.codec, self.meta = _prebuilt
            self.model = model.to(self.device)
        else:
            meta = ckpt.read_metadata(ckpt_path)
            self.meta = meta
            self.cfg = config_from_metadata(meta)
            self.codec = LabelCodec.load_state_dict(meta["many_hot_encoder"])
            self.scaler = Scaler().load_state_dict(meta["scaler"])
            self.model = CRNN(self.cfg.model, device=self.device)
            params, bn_state = ckpt.load_inference_state(ckpt_path)
            self.model.load_state_dict(ckpt.params_from_jax(params, bn_state))
        self.model.eval()
        d = self.cfg.dsp
        self.frontend = MelFrontend(
            sample_rate=d.sample_rate, n_window=d.n_window, hop_length=d.hop_length,
            n_mels=d.n_mels, f_min=d.f_min, f_max=d.f_max, max_frames=d.max_frames,
            amin=d.amin, top_db=d.top_db, device=self.device,
        )
        mean, std = self.scaler.mean_std_f32
        self._features = make_eval_features(self.frontend, mean, std)
        self._predict = make_predict_step(self.model)
        self.synthetic_audio = synthetic_audio
        self.log.info(f"Model loaded at epoch: {self.meta['epoch']} on {self.device}")

    @classmethod
    def from_torch_checkpoint(cls, path: str, device="cuda", synthetic_audio: bool = False, logger=None,
                              mesh=None) -> "CheckpointEvaluator":
        """Evaluate a reference torch.save checkpoint (TestModel.py's input
        format) by importing its weights (train/torch_import.py). The
        reference stores no attention head: the model keeps its own seeded
        one (train/torch_import.py)."""
        from dcase2019_task4_tpu_torch.train.torch_import import import_reference_checkpoint

        model, scaler, codec, ptr = import_reference_checkpoint(path)
        cfg = Config(model=model.cfg)
        meta = {"epoch": "torch-import", "pooling_time_ratio": ptr, "mean_teacher": True}
        return cls(device=device, synthetic_audio=synthetic_audio, logger=logger, mesh=mesh,
                   _prebuilt=(cfg, model, scaler, codec, meta))

    def features(self, audio: np.ndarray, frames: np.ndarray) -> torch.Tensor:
        """int16 padded audio [B, Lp] + valid frames [B] → normalised
        log-mel [B, T, M] on the device (dequantized there)."""
        return self._features(torch.as_tensor(audio, device=self.device),
                              torch.as_tensor(frames, device=self.device))

    def load_thresholds(self, path: str) -> np.ndarray:
        """Per-class threshold vector from JSON: a {class: threshold} dict
        (keys matched to the codec's label order) or a bare [C] list."""
        with open(path) as f:
            raw = json.load(f)
        if isinstance(raw, dict):
            missing = [c for c in self.codec.labels if c not in raw]
            if missing:
                raise ValueError(f"thresholds file {path} missing classes: {missing}")
            return np.asarray([float(raw[c]) for c in self.codec.labels])
        th = np.asarray(raw, dtype=np.float64)
        if th.shape != (len(self.codec.labels),):
            raise ValueError(
                f"thresholds list has shape {th.shape}, expected ({len(self.codec.labels)},)"
            )
        return th

    def load_windows(self, path: str) -> np.ndarray:
        """Per-class odd median windows from JSON ({class: window} or [C])."""
        with open(path) as f:
            raw = json.load(f)
        if isinstance(raw, dict):
            missing = [c for c in self.codec.labels if c not in raw]
            if missing:
                raise ValueError(f"windows file {path} missing classes: {missing}")
            w = np.asarray([int(raw[c]) for c in self.codec.labels])
        else:
            w = np.asarray(raw, dtype=np.int64)
            if w.shape != (len(self.codec.labels),):
                raise ValueError(
                    f"windows list has shape {w.shape}, expected ({len(self.codec.labels)},)"
                )
        if np.any(w % 2 == 0):
            raise ValueError(f"median windows must be odd, got {w.tolist()}")
        return w

    def _stream(self, source_path: str, subpart: Optional[int] = None) -> Stream:
        """A wav directory or a filename TSV (`subpart` files of it by the
        subpart draw) → a Stream with the codec's targets."""
        d = self.cfg.dsp
        if os.path.isdir(source_path):
            names = sorted(f for f in os.listdir(source_path) if f.lower().endswith(".wav"))
            manifest = dir_manifest(names)
            audio_dir = source_path
        else:
            manifest = load_manifest(source_path)
            audio_dir = self.cfg.paths.audio_dir_for_meta(source_path)
        manifest = subpart_manifest(manifest, subpart)
        if self.synthetic_audio:
            src = SyntheticAudioSource(manifest, self.codec.labels, d.sample_rate, d.max_len_seconds)
        else:
            src = WavAudioSource(audio_dir, d.sample_rate)
        return Stream("eval", manifest, src, self.codec, d.sample_rate, d.hop_length,
                      self.meta["pooling_time_ratio"])

    def _share(self, stream: Stream) -> Stream:
        """This rank's files of `stream` (every world-th, round-robin), or
        the stream itself without a mesh."""
        if self.mesh is None:
            return stream
        manifest = shard_manifest(stream.manifest, self.mesh.rank, self.mesh.world_size)
        return Stream("eval", manifest, stream.source, self.codec, self.cfg.dsp.sample_rate, self.cfg.dsp.hop_length,
                      self.meta["pooling_time_ratio"])

    def _gathered(self, stream: Stream, per_file: Dict[str, tuple]) -> Dict[str, tuple]:
        """{file: what this rank inferred for it} → the same for every file
        of `stream`, in its file order, from all the ranks."""
        if self.mesh is None:
            return per_file
        merged = {}
        for part in all_gather_objects(per_file, self.mesh):
            merged.update(part)
        return {f: merged[f] for f in stream.filenames}

    def _batches(self, stream: Stream):
        """(filenames, strong [n, T', C] on the CPU, weak [n, C] numpy,
        targets [n, ...]) of each eval batch of `stream`. Under a mesh the
        rank infers its share and the ranks' results come back as one item:
        every file of the stream, in its order."""
        d = self.cfg.dsp
        per_file = {}
        for batch in iter_eval_batches(self._share(stream), self.cfg.train.batch_size, d.max_samples, d.n_window,
                                       d.hop_length, d.max_frames):
            strong, weak = self._predict(self.features(batch["audio"], batch["frames"]))
            nv = batch["n_valid"]
            item = (batch["filenames"], strong[:nv].cpu(), weak[:nv].cpu().numpy(), batch["target"][:nv])
            if self.mesh is None:
                yield item
            else:
                per_file.update((f, (s, w, t)) for f, s, w, t in zip(item[0], *item[1:]))
        if self.mesh is not None:
            rows = self._gathered(stream, per_file)
            if rows:
                strong, weak, target = zip(*rows.values())
                yield list(rows), torch.stack(strong), np.stack(weak), np.stack(target)

    def is_writer(self) -> bool:
        """Whether this process writes the files (rank 0, or the only one)."""
        return self.mesh is None or self.mesh.rank == 0

    def predict_set(self, source_path: str, save_predictions_fname: str, subpart: Optional[int] = None,
                    weak_fname: Optional[str] = None, weak_threshold=0.5,
                    threshold=0.5, median_window=None) -> Dict:
        """Groundtruth-free batched inference over a wav directory or a
        filename TSV (labels, if present, are ignored except to render
        synthetic audio). Writes the strong events TSV and, with
        `weak_fname`, a `filename⇥event_labels` TSV of the classes whose
        clip probability clears `weak_threshold` (scalar or [C]). Returns
        the events, the clip count and the strong/weak probabilities."""
        d = self.cfg.dsp
        stream = self._stream(source_path, subpart)
        ptr = self.meta["pooling_time_ratio"]
        window = self.cfg.train.median_window if median_window is None else median_window
        events, weak_rows, strong_all, weak_all = [], [], [], []
        for filenames, strong, weak, _ in self._batches(stream):
            events += decode_batch(strong, filenames, self.codec, d.sample_rate,
                                   d.hop_length, ptr, threshold=threshold, median_window=window)
            strong_all.append(strong.numpy())
            weak_all.append(weak)
            if weak_fname:
                for fname, probs in zip(filenames, weak):
                    tags = [self.codec.labels[i] for i in np.nonzero(probs > weak_threshold)[0]]
                    weak_rows.append((fname, ",".join(tags)))
        self.log.info(f"Saving predictions at: {save_predictions_fname}")
        write_events_tsv(events, save_predictions_fname if self.is_writer() else None)
        if weak_fname and self.is_writer():
            with open(weak_fname, "w", newline="") as f:
                w = csv.writer(f, delimiter="\t", lineterminator="\n")
                w.writerow(("filename", "event_labels"))
                w.writerows(weak_rows)
            self.log.info(f"Saving weak tags at: {weak_fname}")
        n_cls = len(self.codec.labels)
        return {
            "events": events,
            "n_files": len(stream),
            "strong": np.concatenate(strong_all) if strong_all else np.zeros((0, 0, n_cls), np.float32),
            "weak": np.concatenate(weak_all) if weak_all else np.zeros((0, n_cls), np.float32),
        }

    def predict_long(self, source_path: str, save_predictions_fname: str, subpart: Optional[int] = None,
                     threshold=0.5, merge_gap: float = 0.2, overlap: bool = False,
                     median_window=None) -> Dict:
        """Inference over wavs of any length (JAX eval/evaluate.py:246-405).

        Each file is cut into windows of the model's `max_len_seconds`
        (the model's static shape), the windows of all files are batched,
        each window is decoded on its own, its events shifted by the
        window's start and stitched across boundaries within `merge_gap`
        seconds (`merge_window_events`). With `overlap` the windows advance
        by half a window on the pooled-frame grid, the probabilities are
        averaged where windows overlap, and each file is decoded once over
        its whole timeline (scipy's median, scalar or per-class window; no
        stitching). Events are cut at the file's length. Writes the events
        TSV; returns the events, the file and window counts and the
        windows' strong probabilities [n_windows, T', C] in window order."""
        from scipy.ndimage import median_filter

        d = self.cfg.dsp
        stream = self._stream(source_path, subpart)
        window = d.max_samples
        ptr = self.meta["pooling_time_ratio"]
        frame_samples = d.hop_length * ptr  # samples a pooled output frame
        win_frames = d.max_frames // ptr  # pooled frames a window
        # half a window, snapped to the pooled-frame grid, so window outputs
        # land on whole frames of the file's timeline
        hop_samples = max(1, win_frames // 2) * frame_samples if overlap else window
        mw = self.cfg.train.median_window if median_window is None else median_window
        jobs, durations = [], {}  # (filename, start s, start pooled frame, audio)
        for fname in self._share(stream).filenames:
            audio = np.asarray(stream.source.get_audio(fname), dtype=np.float32)
            durations[fname] = len(audio) / d.sample_rate
            for w in range(1 + max(0, -(-(len(audio) - window) // hop_samples))):
                s0 = w * hop_samples
                jobs.append((fname, s0 / d.sample_rate, s0 // frame_samples, audio[s0:s0 + window]))
        B = self.cfg.train.batch_size
        probs = []
        for start in range(0, len(jobs), B):
            chunk = jobs[start:start + B]
            n_valid = len(chunk)
            chunk += [chunk[-1]] * (B - n_valid)  # the tail batch padded, sliced off below
            padded, frames = host_reflect_pad([c[3] for c in chunk], window, d.n_window, d.hop_length,
                                              d.max_frames)
            strong, _ = self._predict(self.features(quantize_audio_int16(padded), frames))
            probs += list(strong[:n_valid].cpu().numpy())
        # {file: (duration, [(start s, start pooled frame, probabilities) a window])}, every file's
        # under a mesh, in file order
        windows = {f: (durations[f], []) for f in durations}
        for (fname, t0, sf, _), p in zip(jobs, probs):
            windows[fname][1].append((t0, int(sf), p))
        windows = self._gathered(stream, windows)
        durations = {f: dur for f, (dur, _) in windows.items()}
        jobs = [(f, t0, sf, p) for f, (_, ws) in windows.items() for t0, sf, p in ws]
        strong_all = np.stack([p for *_, p in jobs]) if jobs else np.zeros((0, win_frames, len(self.codec.labels)),
                                                                             np.float32)
        events = []
        if not overlap and jobs:
            # each window's row key is its place in the list
            for label, on, off, k in decode_batch(strong_all, list(range(len(jobs))), self.codec, d.sample_rate,
                                                  d.hop_length, ptr, threshold=threshold, median_window=mw):
                fname, t0 = jobs[k][0], jobs[k][1]
                events.append((label, on + t0, off + t0, fname))
        if overlap:
            th = np.asarray(threshold)
            for fname, (_, ws) in windows.items():
                entries = [(sf, p) for _, sf, p in ws]
                if not entries:
                    continue
                n_frames = max(sf for sf, _ in entries) + win_frames
                buf = np.zeros((n_frames, len(self.codec.labels)), dtype=np.float64)
                cnt = np.zeros((n_frames, 1), dtype=np.float64)
                for sf, p in entries:
                    buf[sf:sf + win_frames] += p
                    cnt[sf:sf + win_frames] += 1.0
                binary = (buf / np.maximum(cnt, 1.0) > th).astype(np.float32)
                if np.ndim(mw) == 0:
                    med = median_filter(binary, size=(int(mw), 1))
                else:  # per-class windows: each column on its own
                    med = np.stack([median_filter(binary[:, c], size=int(w))
                                    for c, w in enumerate(np.asarray(mw).reshape(-1))], axis=1)
                events += grids_to_events(med[None], [fname], self.codec, d.sample_rate, d.hop_length, ptr)
        else:
            events = merge_window_events(events, merge_gap)
        events = [(label, on, min(off, durations[f]), f) for label, on, off, f in events if on < durations[f]]
        self.log.info(f"Saving predictions at: {save_predictions_fname}")
        write_events_tsv(events, save_predictions_fname if self.is_writer() else None)
        return {"events": events, "n_files": len(stream), "n_windows": len(jobs), "strong": strong_all}

    def test_model(self, tsv_path: str, subpart: Optional[int] = None,
                   save_predictions_fname: Optional[str] = None, tune_thresholds: bool = False,
                   threshold=0.5, median_window=None) -> Dict:
        """Full evaluation of one TSV set (reference test_model,
        TestModel.py:25-62): strong decode, event- and segment-based
        metrics, weak tagging F1. `median_window` is a scalar or a
        per-class [C] vector (None: the config's). Returns the two macro F1s,
        the prediction rows and the strong probabilities. `tune_thresholds`
        also grid-searches per-class weak tagging thresholds and per-class
        strong-decode thresholds and median windows (3, 5, 7) on this set
        (eval/thresholds.py) and returns them with their macro F1s."""
        if median_window is None:
            median_window = self.cfg.train.median_window
        self.log.info(tsv_path)
        stream = self._stream(tsv_path, subpart)
        d = self.cfg.dsp
        predictions, strong_all, acc = [], [], TaggingF1(len(self.codec.labels))
        weak_probs, weak_targets, strong_fnames = [], [], []
        for filenames, strong, weak, target in self._batches(stream):
            predictions += decode_batch(strong, filenames, self.codec, d.sample_rate, d.hop_length,
                                        self.meta["pooling_time_ratio"], threshold=threshold,
                                        median_window=median_window)
            acc.update(weak, target)
            strong_all.append(strong.numpy())
            if tune_thresholds:
                weak_probs.append(weak)
                weak_targets.append(target)
                strong_fnames += filenames
        if save_predictions_fname and self.is_writer():
            self.log.info(f"Saving predictions at: {save_predictions_fname}")
            write_events_tsv(predictions, save_predictions_fname)
        event_metric = compute_strong_metrics(predictions, stream.manifest.rows, self.log)
        weak_f1 = acc.per_class_f1()
        self.log.info(f"Weak F1-score per class: {dict(zip(self.codec.labels, np.round(weak_f1 * 100, 2)))}")
        self.log.info(f"Weak F1-score macro averaged: {np.mean(weak_f1):.4f}")
        out = {
            "event_macro_f1": event_metric.results_class_wise_average_metrics()["f_measure"]["f_measure"],
            "weak_macro_f1": float(np.mean(weak_f1)),
            "predictions": predictions,
            "strong": np.concatenate(strong_all) if strong_all else np.zeros((0, 0, len(self.codec.labels)),
                                                                             np.float32),
        }
        if tune_thresholds and weak_probs:
            out.update(self._tune(np.concatenate(weak_probs), np.concatenate(weak_targets), out["strong"],
                                  strong_fnames, stream.manifest))
        return out

    def _tune(self, weak_probs, weak_targets, strong, fnames, groundtruth) -> Dict:
        """The tuned weak thresholds and event thresholds and windows of one
        set, with their macro F1s (JAX eval/evaluate.py:472-497)."""
        from dcase2019_task4_tpu_torch.eval.thresholds import tune_event_thresholds, tune_weak_thresholds

        d, labels = self.cfg.dsp, self.codec.labels
        th, tuned_f1 = tune_weak_thresholds(weak_probs, weak_targets)
        self.log.info(f"Tuned per-class thresholds: {dict(zip(labels, np.round(th, 2)))}")
        self.log.info(f"Tuned weak F1 macro averaged: {np.mean(tuned_f1):.4f}")
        ev = tune_event_thresholds(strong, fnames, groundtruth, self.codec, d.sample_rate, d.hop_length,
                                   self.meta["pooling_time_ratio"], median_windows=(3, 5, 7))
        self.log.info(f"Tuned per-class EVENT thresholds: {dict(zip(labels, np.round(ev['thresholds'], 2)))} "
                      f"windows {dict(zip(labels, ev['windows'].tolist()))}")
        self.log.info(f"Tuned event F1 macro averaged: {ev['macro_f1']:.4f} "
                      f"(decode-default 0.5/5: {ev['default_macro_f1']:.4f})")
        return {
            "tuned_thresholds": th.tolist(),
            "tuned_weak_macro_f1": float(np.mean(tuned_f1)),
            "tuned_event_thresholds": np.asarray(ev["thresholds"]).tolist(),
            "tuned_event_windows": np.asarray(ev["windows"]).tolist(),
            "tuned_event_macro_f1": ev["macro_f1"],
        }
