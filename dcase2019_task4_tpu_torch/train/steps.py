"""Training and inference steps (counterpart of
dcase2019_task4_tpu/train/steps.py).

One Mean-Teacher step: featurize on the device (optional) → teacher
forward in train mode without a graph → student forward → masked losses →
backward → Adam → EMA of the parameters → metric sums. Nothing is read back
from the device inside the step: the packed batch goes in, and the metrics
stay device tensors until the caller fetches them (once per epoch from the
accumulator).

Where the JAX step is a pure function of an immutable TrainState, the port
updates in place: the student and teacher modules, their BatchNorm buffers
and the optimizer state are mutated, and the step returns the same
TrainState object. The step counter is a Python int on the host, so the
consistency ramp and the EMA warm-up are host arithmetic.

Randomness: every draw of a step comes from the one `torch.Generator` the
caller passes, in a fixed order (teacher noise, teacher dropout seeds and
mask, student dropout seeds and mask), each made on the generator's device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from dcase2019_task4_tpu_torch.models.crnn import CRNN, init_
from dcase2019_task4_tpu_torch.train import losses
from dcase2019_task4_tpu_torch.train.ramps import sigmoid_rampup


def dequantize_audio(audio: torch.Tensor) -> torch.Tensor:
    """Audio crosses the host↔device link as int16 PCM; dequantize on the
    device."""
    if audio.dtype == torch.int16:
        return audio.to(torch.float32) * (1.0 / 32768.0)
    return audio


@dataclasses.dataclass
class TrainState:
    student: CRNN
    teacher: Optional[CRNN]
    optimizer: torch.optim.Optimizer
    step: int = 0


def init_train_state(model_cfg, make_optimizer: Callable, generator: torch.Generator,
                     with_ema: bool = True, device=None) -> TrainState:
    """Student and teacher are *independently* initialised from successive
    draws of `generator`, like the reference's two weights_init calls; the
    EMA warm-up pulls the teacher onto the student within a few steps.
    `make_optimizer(params)` builds the optimizer over the student's
    parameters."""
    student = init_(CRNN(model_cfg, device=device), generator).train()
    teacher = init_(CRNN(model_cfg, device=device), generator).train() if with_ema else None
    if teacher is not None:
        teacher.requires_grad_(False)
    return TrainState(student, teacher, make_optimizer(student.parameters()), 0)


def ema_alpha_at(step: int, alpha_max: float = 0.999) -> float:
    """α = min(1 − 1/(g+1), α_max), g the post-increment global step
    (g = step + 1)."""
    g = step + 1
    return min(1.0 - 1.0 / (g + 1.0), alpha_max)


@torch.no_grad()
def ema_update(student: CRNN, teacher: CRNN, step: int, alpha_max: float = 0.999):
    """teacher ← α·teacher + (1 − α)·student over the **parameters** only,
    in place; each model's BatchNorm buffers stay its own."""
    alpha = ema_alpha_at(step, alpha_max)
    ema, cur = list(teacher.parameters()), [p.detach() for p in student.parameters()]
    torch._foreach_mul_(ema, alpha)
    torch._foreach_add_(ema, cur, alpha=1.0 - alpha)


class TrainStep:
    """Callable with the metric-sum accumulator contract:
    `step(state, batch, generator, acc)` → (state, metrics, acc + metrics),
    `acc` built by `zero_metrics(device)`. The sums live on the device;
    fetch them once per epoch and divide by the step count."""

    def __init__(self, fn, metric_keys):
        self._fn = fn
        self.metric_keys = tuple(metric_keys)

    def zero_metrics(self, device=None) -> Dict[str, torch.Tensor]:
        return {k: torch.zeros((), dtype=torch.float32, device=device) for k in self.metric_keys}

    def __call__(self, state, batch, generator, acc):
        return self._fn(state, batch, generator, acc)


def make_train_step(
    weak_slice: Optional[slice],
    strong_slice: Optional[slice],
    mean_teacher: bool = True,
    rampup_length: int = 0,
    max_consistency_cost: float = 2.0,
    ema_alpha: float = 0.999,
    frontend=None,
    scaler_mean=None,
    scaler_std=None,
    noise_std: float = 0.25,
    spec_augment_cfg: Optional[Dict] = None,
    mesh=None,
):
    """Build the step. The arguments are those of the JAX make_train_step
    without `model` and `optimizer` (they live in the TrainState) and without
    `donate` and `axis_name`; `mesh` and a non-empty `spec_augment_cfg` are
    refused: data-parallel training and SpecAugment are not ported yet.

    Batch dict (tensors on the compute device):
      * fused-frontend mode (frontend given): {"audio": [B, Lp] reflect-padded
        (int16 or f32), "frames": [B] valid frame counts, "target": [B, T', C]},
        optional "audio2" (the teacher featurizes this second view);
      * precomputed mode: {"features": [B, T, F] normalised log-mel, optional
        "features_teacher", "target"}.

    Returns a TrainStep. After a step the student's `.grad` fields hold that
    step's gradients."""
    if mesh is not None:
        raise NotImplementedError("make_train_step: data-parallel training (mesh=) is not ported yet")
    if spec_augment_cfg:
        raise NotImplementedError("make_train_step: SpecAugment (spec_augment_cfg) is not ported yet")

    # static metric-key set, in the JAX step's order
    metric_keys = ["loss"]
    if weak_slice is not None:
        metric_keys.append("weak_class_loss")
    if strong_slice is not None:
        metric_keys.append("strong_class_loss")
    if mean_teacher:
        metric_keys += ["consistency_strong", "consistency_weak", "consistency_weight"]
        if weak_slice is not None:
            metric_keys.append("weak_ema_class_loss")
        if strong_slice is not None:
            metric_keys.append("strong_ema_class_loss")

    if scaler_mean is not None and frontend is not None:
        scaler_mean = torch.as_tensor(scaler_mean, dtype=torch.float32, device=frontend.mel_fb.device)
        scaler_std = torch.as_tensor(scaler_std, dtype=torch.float32, device=frontend.mel_fb.device)

    def scale(x):
        return x if scaler_mean is None else (x - scaler_mean) / scaler_std

    def featurize(batch, generator):
        if frontend is None:
            student = batch["features"]
            return student, batch.get("features_teacher", student)
        audio = batch["audio"]  # K1 dequantizes int16 itself, on the device
        if mean_teacher:
            student, teacher = frontend.log_mel_pair(audio, batch["frames"], generator, noise_std,
                                                     teacher_padded=batch.get("audio2"))
        else:
            with torch.no_grad():
                student = frontend.log_mel(audio, batch["frames"])
            teacher = student
        return scale(student), scale(teacher)

    def step_fn(state: TrainState, batch: Dict, generator: torch.Generator, acc: Dict):
        # float32 model: keep cuDNN's conv and GRU (forward and backward) and
        # every matmul out of TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        student, teacher = state.student, state.teacher
        student.train()
        student_x, teacher_x = featurize(batch, generator)
        target = batch["target"]
        metrics: Dict[str, torch.Tensor] = {}

        if mean_teacher:
            teacher.train()  # batch statistics and dropout, as the reference's EMA model
            with torch.no_grad():
                strong_t, weak_t = teacher(teacher_x, generator)
            cons_weight = max_consistency_cost * sigmoid_rampup(float(state.step), rampup_length)

        strong_s, weak_s = student(student_x, generator)
        loss = torch.zeros((), dtype=torch.float32, device=strong_s.device)
        if weak_slice is not None:
            metrics["weak_class_loss"] = losses.weak_bce(weak_s, target, weak_slice)
            loss = loss + metrics["weak_class_loss"]
        if strong_slice is not None:
            metrics["strong_class_loss"] = losses.strong_bce(strong_s, target, strong_slice)
            loss = loss + metrics["strong_class_loss"]
        if mean_teacher:
            metrics["consistency_strong"] = cons_weight * losses.mse(strong_s, strong_t)
            metrics["consistency_weak"] = cons_weight * losses.mse(weak_s, weak_t)
            metrics["consistency_weight"] = torch.full((), cons_weight, dtype=torch.float32, device=loss.device)
            loss = loss + metrics["consistency_strong"] + metrics["consistency_weak"]
        metrics["loss"] = loss

        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()

        if mean_teacher:
            # the EMA sees the *updated* student and the pre-increment step
            ema_update(student, teacher, state.step, ema_alpha)
            # teacher-side losses, metered like the reference; no gradient
            with torch.no_grad():
                if weak_slice is not None:
                    metrics["weak_ema_class_loss"] = losses.weak_bce(weak_t, target, weak_slice)
                if strong_slice is not None:
                    metrics["strong_ema_class_loss"] = losses.strong_bce(strong_t, target, strong_slice)

        state.step += 1
        metrics = {k: metrics[k].detach() for k in metric_keys}
        new_acc = {k: acc[k] + metrics[k] for k in metric_keys}
        return state, metrics, new_acc

    return TrainStep(step_fn, metric_keys)


def make_eval_features(frontend, scaler_mean=None, scaler_std=None):
    """Inference featurization (no augmentation): (audio [B, Lp] int16 or
    f32, frames [B]) on the frontend's device → normalised log-mel."""

    device = frontend.mel_fb.device
    if scaler_mean is not None:
        scaler_mean = torch.as_tensor(scaler_mean, dtype=torch.float32, device=device)
        scaler_std = torch.as_tensor(scaler_std, dtype=torch.float32, device=device)

    @torch.no_grad()
    def featurize(audio, frames):
        x = frontend.log_mel(dequantize_audio(audio), frames)
        if scaler_mean is not None:
            x = (x - scaler_mean) / scaler_std
        return x

    return featurize


def make_scaler_stats(frontend):
    """Per-batch moment reduction for scaler fitting: featurize and reduce
    to (Σ per bin, Σ² per bin) of the per-clip time means on the device;
    `n_valid` masks the repeated-tail rows of a last batch."""

    @torch.no_grad()
    def stats(audio, frames, n_valid):
        x = frontend.log_mel(dequantize_audio(audio), frames)
        mask = (torch.arange(x.shape[0], device=x.device) < n_valid)[:, None].to(torch.float32)
        return (x.mean(dim=1) * mask).sum(dim=0), ((x * x).mean(dim=1) * mask).sum(dim=0)

    return stats


def make_predict_step(model: CRNN):
    """Batched inference: features → (strong probs, weak probs), eval mode,
    no graph."""

    @torch.no_grad()
    def predict(features):
        model.eval()
        return model(features)

    return predict
