"""Ahead-of-time serving export through torch.export (counterpart of
dcase2019_task4_tpu/eval/export.py, which writes a jax.export/StableHLO
artifact).

Serializes the complete serving function, int16 or float32 PCM audio in
and event probabilities out, as one artifact: the log-mel frontend (K1),
the dataset scaler's normalisation and the CRNN forward in eval mode
(BatchNorm on its running statistics) are traced once by `torch.export`
with the checkpoint's weights in the program, and written with
`torch.export.save`. The kernels enter the traced program as the
`dcase19_torch` torch.library ops the eval-mode forward calls
(ops/fused_mel.py, packed_conv.py, fused_block.py, entry_conv.py,
fused_entry_block.py, crows_block.py); their ctypes launches cannot be
traced, the ops can.

Input contract (as the eval pipeline packs a batch, data/pipeline.py):
`audio` is [B, max_samples + n_window] int16 PCM (or float32 in [-1, 1]),
each clip reflect-padded by n_window // 2 around its own boundary
(ops/mel.py `host_reflect_pad`); `frames` is [B] int32 valid-frame
counts. Outputs: (strong [B, T / pool, nclass], weak [B, nclass])
probabilities. The batch is fixed at export (the checkpoint's batch size
unless given), as in the JAX package.

Container, the JAX package's: a magic line (the port's own, so each
package's loader refuses the other's artifact), an 8-byte little-endian
header length, the JSON header with the JAX package's keys (`platforms`
is ["cuda"] or ["cpu"], the device the program was exported on), then
the `torch.export.save` bytes.

`load_serving` needs torch and the port's op library: it imports the ops
modules, which register the ops, and nothing of the port's models, train,
data or eval packages but this module (the JAX artifact needs only jax).
An artifact exported on cuda loads only where a card is.
"""

from __future__ import annotations

import io
import json
from typing import Optional, Tuple

import torch
from torch import nn

_MAGIC = b"DC19TORCHSERVE1\n"

# the modules whose import registers the ops a serving program calls
_OP_MODULES = ("fused_mel", "packed_conv", "fused_block", "entry_conv", "fused_entry_block", "crows_block")


class _Serve(nn.Module):
    """The serving computation as one module of (audio, frames): frontend,
    scaler normalisation, the CRNN in eval mode."""

    def __init__(self, model, frontend, scaler_mean, scaler_std):
        super().__init__()
        device = frontend.mel_fb.device
        self.model = model.eval()
        self.frontend = frontend
        self.register_buffer("mean", torch.as_tensor(scaler_mean, dtype=torch.float32, device=device))
        self.register_buffer("std", torch.as_tensor(scaler_std, dtype=torch.float32, device=device))

    def forward(self, audio: torch.Tensor, frames: torch.Tensor):
        if audio.dtype == torch.int16:  # as train/steps.py dequantize_audio
            audio = audio.to(torch.float32) * (1.0 / 32768.0)
        x = (self.frontend.log_mel(audio, frames) - self.mean) / self.std
        return self.model(x)


def build_serve_fn(model, frontend, scaler_mean, scaler_std) -> nn.Module:
    """The full serving computation as a module of (audio, frames) → (strong,
    weak); the model holds its weights (eval mode), the scaler's mean and
    std are buffers."""
    return _Serve(model, frontend, scaler_mean, scaler_std)


def export_serving(evaluator, out_path: str, batch_size: Optional[int] = None,
                   audio_dtype=torch.int16) -> dict:
    """Export `evaluator`'s serving function (a CheckpointEvaluator, built
    from a port, JAX or imported reference checkpoint) on its device to
    `out_path`. Returns the artifact's header (shapes, classes, frame
    math)."""
    cfg = evaluator.cfg
    d = cfg.dsp
    B = int(batch_size or cfg.train.batch_size)
    mean, std = evaluator.scaler.mean_std_f32
    serve = build_serve_fn(evaluator.model, evaluator.frontend, mean, std)
    device = evaluator.device
    audio = torch.zeros((B, d.max_samples + d.n_window), dtype=audio_dtype, device=device)
    frames = torch.full((B,), d.max_frames, dtype=torch.int32, device=device)
    program = torch.export.export(serve, (audio, frames), strict=False)
    program.example_inputs = None  # else the zero batch (21 MB of audio at the flagship) is saved with it
    header = {
        "batch_size": B,
        "audio_shape": [B, d.max_samples + d.n_window],
        "audio_dtype": str(audio_dtype).removeprefix("torch."),
        "n_frames_max": d.max_frames,
        "pooling_time_ratio": int(evaluator.meta["pooling_time_ratio"]),
        "frames_per_second": d.frames_per_second,
        "labels": list(evaluator.codec.labels),
        "platforms": [device.type],
    }
    blob = io.BytesIO()
    torch.export.save(program, blob)
    hdr = json.dumps(header).encode()
    with open(out_path, "wb") as f:
        f.write(_MAGIC)
        f.write(len(hdr).to_bytes(8, "little"))
        f.write(hdr)
        f.write(blob.getvalue())
    return header


class ServingModel:
    """A loaded serving artifact: `header` and `__call__(audio, frames) →
    (strong_probs, weak_probs)` on the artifact's device."""

    def __init__(self, header: dict, program):
        self.header = header
        self.program = program
        self.device = torch.device(header["platforms"][0])
        self._call = program.module()

    def __call__(self, audio, frames) -> Tuple[torch.Tensor, torch.Tensor]:
        audio = torch.as_tensor(audio, device=self.device)
        frames = torch.as_tensor(frames, device=self.device).to(torch.int32)
        want = tuple(self.header["audio_shape"])
        if tuple(audio.shape) != want or tuple(frames.shape) != want[:1]:
            raise ValueError(f"Shape mismatch: the artifact takes audio {list(want)} and frames [{want[0]}], got "
                             f"{list(audio.shape)} and {list(frames.shape)}")
        with torch.no_grad():
            return self._call(audio, frames)


def load_serving(path: str) -> ServingModel:
    """Load an artifact written by `export_serving`: torch and the port's op
    library only, no model classes, configs or checkpoint readers."""
    import importlib

    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic != _MAGIC:
            raise ValueError(f"{path} is not a dcase19 torch serving artifact")
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n).decode())
        blob = f.read()
    if "cuda" in header["platforms"] and not torch.cuda.is_available():
        raise RuntimeError(f"{path} was exported for cuda, and torch.cuda.is_available() is False")
    for name in _OP_MODULES:
        importlib.import_module(f"dcase2019_task4_tpu_torch.ops.{name}")
    return ServingModel(header, torch.export.load(io.BytesIO(blob)))
