"""Configuration of the PyTorch/CUDA port (the port's own copy of
dcase2019_task4_tpu/config.py, field for field, so a checkpoint's
``meta["config"]`` round-trips between the two packages).

Mirrors the constants of the reference flat config module
(reference baseline config.py:1-59) but as typed dataclasses so the
whole configuration travels with checkpoints and can be overridden per run.
The 10 event classes are derived from the validation TSV, like the
reference's import-time side effect (config.py:51), but lazily and with
the standard library's csv reader. The TPU-only model switches
(`fused_interpret`, `entry_conv_pallas`, `entry_block_pallas`,
`entry_block_crows`) are kept as fields and read by nothing in the port.
"""

from __future__ import annotations

import csv
import dataclasses
import math
import os
from functools import cached_property
from typing import Sequence

_REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@dataclasses.dataclass(frozen=True)
class PathsConfig:
    """Dataset/metadata locations (reference config.py:5-13)."""

    workspace: str = _REPO_ROOT
    metadata_dir: str = os.path.join(_REPO_ROOT, "dataset_metadata")
    audio_dir: str = os.path.join(_REPO_ROOT, "dataset_audio")
    feature_dir: str = os.path.join(_REPO_ROOT, "dataset_features")
    store_dir: str = os.path.join(_REPO_ROOT, "stored_data")

    @property
    def weak(self) -> str:
        return os.path.join(self.metadata_dir, "train", "weak.tsv")

    @property
    def unlabel(self) -> str:
        return os.path.join(self.metadata_dir, "train", "unlabel_in_domain.tsv")

    @property
    def synthetic(self) -> str:
        return os.path.join(self.metadata_dir, "train", "synthetic.tsv")

    @property
    def validation(self) -> str:
        return os.path.join(self.metadata_dir, "validation", "validation.tsv")

    @property
    def test2018(self) -> str:
        return os.path.join(self.metadata_dir, "validation", "test_dcase2018.tsv")

    @property
    def eval2018(self) -> str:
        return os.path.join(self.metadata_dir, "validation", "eval_dcase2018.tsv")

    @property
    def eval_desed(self) -> str:
        return os.path.join(self.metadata_dir, "eval", "public.tsv")

    def audio_dir_for_meta(self, tsv_path: str) -> str:
        """Map a metadata TSV path to its audio directory.

        Same contract as the reference
        (DatasetDcase2019Task4.get_audio_dir_path_from_meta,
        DatasetDcase2019Task4.py:148-164): metadata→audio, and validation
        TSVs all share the parent `validation/` audio dir.
        """
        rel = os.path.relpath(os.path.abspath(tsv_path), self.metadata_dir)
        base = os.path.splitext(rel)[0]
        parts = base.split(os.sep)
        if len(parts) >= 2 and parts[-2] == "validation":
            parts = parts[:-1]
        return os.path.join(self.audio_dir, *parts)


@dataclasses.dataclass(frozen=True)
class DSPConfig:
    """Log-mel frontend parameters (reference config.py:16-24).

    The reference computes librosa STFT (hamming window, center/reflect
    padding) → Slaney mel (htk=False, norm=None) → amplitude_to_db; the same
    math runs fused on device here (ops/mel.py).
    """

    sample_rate: int = 44100
    n_window: int = 2048
    hop_length: int = 511
    n_mels: int = 64
    max_len_seconds: float = 10.0
    f_min: float = 0.0
    f_max: float = 22050.0
    # amplitude_to_db conventions (librosa defaults used by the reference)
    amin: float = 1e-5
    top_db: float = 80.0

    @property
    def max_frames(self) -> int:
        # reference config.py:22
        return math.ceil(self.max_len_seconds * self.sample_rate / self.hop_length)

    @property
    def max_samples(self) -> int:
        return int(self.max_len_seconds * self.sample_rate)

    @property
    def frames_per_second(self) -> float:
        return self.sample_rate / self.hop_length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """CRNN hyperparameters (reference config.py:53-59 crnn_kwargs)."""

    n_in_channel: int = 1
    nclass: int = 10
    attention: bool = True
    n_rnn_cell: int = 64
    n_layers_rnn: int = 2
    activation: str = "glu"
    dropout: float = 0.5
    kernel_size: Sequence[int] = (3, 3, 3)
    padding: Sequence[int] = (1, 1, 1)
    stride: Sequence[int] = (1, 1, 1)
    nb_filters: Sequence[int] = (64, 64, 64)
    pooling: Sequence[Sequence[int]] = ((2, 4), (2, 4), (2, 4))
    dropout_recurrent: float = 0.0
    # BatchNorm conventions (reference models/CNN.py:52)
    bn_eps: float = 1e-3
    bn_momentum: float = 0.99
    # compute dtype of conv/GLU ("bfloat16" | "float32"); params, BN
    # statistics, recurrence, heads and losses stay float32. The port runs
    # float32 only so far.
    compute_dtype: str = "float32"
    # fused BN→GLU→dropout→pool block (ops/fused_block.py):
    # True | False | None = auto (on with GLU)
    fused_block: "bool | None" = None
    # Switches of the JAX package's Pallas variants. The port keeps the
    # fields so that configs stored in checkpoints load; it reads none.
    fused_interpret: bool = False
    entry_conv_pallas: bool = False
    entry_block_pallas: bool = False
    entry_block_crows: bool = False

    @property
    def pooling_time_ratio(self) -> int:
        # reference config.py:59 — product of time poolings (2*2*2)
        r = 1
        for p in self.pooling:
            r *= p[0]
        return r


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training loop constants (reference config.py:27-48, main.py:288)."""

    batch_size: int = 24
    n_epoch: int = 100
    lr: float = 1e-3  # Adam lr used by main.py:288 (optim_kwargs)
    beta1: float = 0.9
    beta2: float = 0.999
    adam_eps: float = 1e-8
    max_consistency_cost: float = 2.0
    ema_alpha: float = 0.999
    median_window: int = 5
    checkpoint_epochs: int = 1
    save_best: bool = True
    # noise augmentation for the teacher input (reference DataLoad.py:283-287:
    # np.random.normal(0, 0.5**2) → std is 0.25, faithfully kept)
    noise_std: float = 0.25
    # splits
    valid_fraction: float = 0.2
    split_seed: int = 26  # reference main.py:215,221
    subpart_seed: int = 10  # reference DatasetDcase2019Task4.py:125
    num_prefetch: int = 2
    # SpecAugment on the student features (scaled config; off for parity)
    spec_augment: bool = False
    sa_time_masks: int = 2
    sa_max_time_width: int = 64
    sa_freq_masks: int = 2
    sa_max_freq_width: int = 16


@dataclasses.dataclass(frozen=True)
class Config:
    paths: PathsConfig = dataclasses.field(default_factory=PathsConfig)
    dsp: DSPConfig = dataclasses.field(default_factory=DSPConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)

    @cached_property
    def classes(self) -> tuple:
        """The event classes, derived from validation.tsv like the
        reference's `cfg.classes` (config.py:51): sorted unique labels."""
        with open(self.paths.validation, newline="") as f:
            labels = {row["event_label"] for row in csv.DictReader(f, delimiter="\t")}
        return tuple(sorted(label for label in labels if label))

    def with_classes(self, classes) -> "Config":
        """A copy whose `classes` are pinned (e.g. derived from custom
        manifests via data.manifests.classes_from_manifests instead of
        validation.tsv)."""
        cfg = Config(paths=self.paths, dsp=self.dsp, model=self.model, train=self.train)
        cfg.__dict__["classes"] = tuple(classes)
        return cfg


def scaled_config() -> "Config":
    """The scaled throughput/quality config (BASELINE.json config 5):
    128 mel bins, 128-channel convs, 128-cell BiGRU, SpecAugment on the
    student features, bf16 compute. The port does not run it yet."""
    return Config(
        dsp=DSPConfig(n_mels=128),
        model=ModelConfig(
            nb_filters=(128, 128, 128),
            n_rnn_cell=128,
            pooling=((2, 4), (2, 4), (2, 8)),  # freq 128 → 1, time ÷8
            compute_dtype="bfloat16",
        ),
        train=TrainConfig(spec_augment=True),
    )


DEFAULT_CLASSES = (
    "Alarm_bell_ringing",
    "Blender",
    "Cat",
    "Dishes",
    "Dog",
    "Electric_shaver_toothbrush",
    "Frying",
    "Running_water",
    "Speech",
    "Vacuum_cleaner",
)
