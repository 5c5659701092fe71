"""Checkpoint inference (counterpart of the serving part of
dcase2019_task4_tpu/eval/evaluate.py): rebuild config, scaler, codec,
frontend and model from a checkpoint on an explicit device, run batched
inference over a wav directory or filename TSV, and write the events TSV
(and optionally the weak clip-tag TSV). No jax and no pandas.
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
from dcase2019_task4_tpu_torch.data.pipeline import Stream, dir_manifest, iter_eval_batches, read_manifest
from dcase2019_task4_tpu_torch.eval.decode import decode_batch, write_events_tsv
from dcase2019_task4_tpu_torch.models.crnn import CRNN
from dcase2019_task4_tpu_torch.ops.mel import MelFrontend
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
    def __init__(self, ckpt_path: str, device="cuda", synthetic_audio: bool = False, logger=None):
        self.log = logger or get_logger()
        self.device = resolve_device(str(device))
        meta = ckpt.read_metadata(ckpt_path)
        self.meta = meta
        self.cfg = config_from_metadata(meta)
        if self.cfg.model.compute_dtype != "float32":
            raise NotImplementedError(f"compute_dtype {self.cfg.model.compute_dtype!r}: only float32 is ported")
        self.codec = LabelCodec.load_state_dict(meta["many_hot_encoder"])
        self.scaler = Scaler().load_state_dict(meta["scaler"])
        # f32 model: keep every matmul and cuDNN op (the entry conv, the GRU)
        # in full float32 on the card. cuDNN convolutions default to TF32
        # (about three decimal digits), which the f32 reference does not use.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
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
        self.log.info(f"Model loaded at epoch: {meta['epoch']} on {self.device}")

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

    def _stream(self, source_path: str) -> Stream:
        d = self.cfg.dsp
        if os.path.isdir(source_path):
            names = sorted(f for f in os.listdir(source_path) if f.lower().endswith(".wav"))
            manifest = dir_manifest(names)
            audio_dir = source_path
        else:
            manifest = read_manifest(source_path)
            audio_dir = self.cfg.paths.audio_dir_for_meta(source_path)
        if self.synthetic_audio:
            src = SyntheticAudioSource(manifest, self.codec.labels, d.sample_rate, d.max_len_seconds)
        else:
            src = WavAudioSource(audio_dir, d.sample_rate)
        return Stream(manifest, src)

    def predict_set(self, source_path: str, save_predictions_fname: str,
                    weak_fname: Optional[str] = None, weak_threshold=0.5,
                    threshold=0.5, median_window=None) -> Dict:
        """Groundtruth-free batched inference over a wav directory or a
        filename TSV (labels, if present, are ignored except to render
        synthetic audio). Writes the strong events TSV and, with
        `weak_fname`, a `filename⇥event_labels` TSV of the classes whose
        clip probability clears `weak_threshold` (scalar or [C]). Returns
        the events, the clip count and the strong/weak probabilities."""
        d = self.cfg.dsp
        stream = self._stream(source_path)
        ptr = self.meta["pooling_time_ratio"]
        window = self.cfg.train.median_window if median_window is None else median_window
        events, weak_rows, strong_all, weak_all = [], [], [], []
        for batch in iter_eval_batches(stream, self.cfg.train.batch_size, d.max_samples,
                                       d.n_window, d.hop_length, d.max_frames):
            strong, weak = self._predict(self.features(batch["audio"], batch["frames"]))
            nv = batch["n_valid"]
            strong = strong[:nv].cpu()
            weak = weak[:nv].cpu().numpy()
            events += decode_batch(strong, batch["filenames"], self.codec, d.sample_rate,
                                   d.hop_length, ptr, threshold=threshold, median_window=window)
            strong_all.append(strong.numpy())
            weak_all.append(weak)
            if weak_fname:
                for fname, probs in zip(batch["filenames"], weak):
                    tags = [self.codec.labels[i] for i in np.nonzero(probs > weak_threshold)[0]]
                    weak_rows.append((fname, ",".join(tags)))
        self.log.info(f"Saving predictions at: {save_predictions_fname}")
        write_events_tsv(events, save_predictions_fname)
        if weak_fname:
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
