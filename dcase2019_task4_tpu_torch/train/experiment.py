"""End-to-end experiment assembly without jax and pandas (counterpart of
dcase2019_task4_tpu/train/experiment.py):

  TSV manifests → packed streams → pinned host batches → [device] K1
  frontend → CRNN → losses, Adam and EMA (train/steps.py) → batched
  inference → decode → SED scoring → checkpoints and SaveBest.

Stream composition, splits, seeds, loss masks, ramp lengths, optimizer and
EMA hyperparameters all follow the JAX package (and with it the reference
recipe). `device_cache` keeps the whole training set on the
device (data.pipeline.DeviceResidentData) and gathers each epoch's
batches there: the same batches and draws as the streamed loop, and no
batch queue.

Every tensor lives on `device` (the card unless the caller passes
"cpu"). The initial weights come from a CPU generator seeded with `seed`,
so a run on the card and one on the CPU start from the same state; each
epoch's draws (teacher noise, SpecAugment, dropout) come from one
`torch.Generator` on the device, seeded with hash((seed, epoch)) % 2**31
as the JAX package seeds its key.

Data parallel (`mesh`, parallel/mesh.py; one process a card): the batch
size is a rank's, and every rank draws the same global batch and trains on
its shard-major cut with the per-rank loss slices; rank 0's state is
broadcast after the build and after a restore; rank r > 0 seeds its
epoch's generator from (seed, epoch, r), so the ranks' draws are
equivalent to the JAX package's per-device draws in distribution only.
Each rank validates every world-th file (`shard_manifest`) and the
additive event, segment and tagging counts are summed over the ranks, so
every rank logs the same numbers and SaveBest reads them. Rank 0 alone
writes metrics.jsonl and the checkpoints; the others wait for them before
reading one.
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from dcase2019_task4_tpu_torch.config import Config
from dcase2019_task4_tpu_torch.data.audio_io import SyntheticAudioSource, WavAudioSource
from dcase2019_task4_tpu_torch.data.encoder import LabelCodec
from dcase2019_task4_tpu_torch.data.manifests import (
    Manifest,
    load_manifest,
    shard_manifest,
    split_synthetic,
    split_weak,
    subpart_manifest,
)
from dcase2019_task4_tpu_torch.data.pipeline import (
    BatchPipeline,
    DeviceResidentData,
    Stream,
    device_prefetch,
    iter_eval_batches,
)
from dcase2019_task4_tpu_torch.eval.decode import decode_batch, write_events_tsv
from dcase2019_task4_tpu_torch.eval.evaluate import resolve_device
from dcase2019_task4_tpu_torch.eval.sed_scores import (
    SedMetrics,
    compute_strong_metrics,
    event_based_metrics,
    segment_based_metrics,
)
from dcase2019_task4_tpu_torch.eval.tagging import TaggingF1, macro_f_measure
from dcase2019_task4_tpu_torch.ops.mel import MelFrontend
from dcase2019_task4_tpu_torch.parallel.mesh import replicate_state
from dcase2019_task4_tpu_torch.parallel.multihost import all_sum_hosts, sync_hosts
from dcase2019_task4_tpu_torch.train import checkpoints as ckpt
from dcase2019_task4_tpu_torch.train.steps import (
    init_train_state,
    make_eval_features,
    make_predict_step,
    make_scaler_stats,
    make_train_step,
)
from dcase2019_task4_tpu_torch.utils.logger import get_logger
from dcase2019_task4_tpu_torch.utils.meters import AverageMeterSet, EarlyStopping, SaveBest
from dcase2019_task4_tpu_torch.utils.metrics_writer import MetricsWriter
from dcase2019_task4_tpu_torch.utils.scaler import Scaler


def epoch_seed(seed: int, epoch: int, rank: int = 0) -> int:
    """The seed of an epoch's generator: hash((seed, epoch)) % 2**31 on
    rank 0, as the JAX package seeds its key, and from (seed, epoch, rank)
    on the other ranks of a data-parallel run."""
    return hash((seed, epoch) if rank == 0 else (seed, epoch, rank)) % (2**31)


class Experiment:
    def __init__(
        self,
        cfg: Config,
        mean_teacher: bool = True,
        no_synthetic: bool = False,
        no_weak: bool = False,
        subpart_data: Optional[int] = None,
        subpart_unlabeled: Optional[int] = None,
        synthetic_audio: bool = False,
        synthetic_variability: float = 0.0,
        synthetic_bands: Optional[Dict] = None,
        logger=None,
        seed: int = 0,
        ramped_adam: bool = False,
        paired_teacher_view: bool = False,
        device="cuda",
        device_cache: bool = False,
        mesh=None,
    ):
        self.cfg = cfg
        self.device = resolve_device(str(device))
        self.mesh = mesh
        self.process_index = 0 if mesh is None else mesh.rank
        self.process_count = 1 if mesh is None else mesh.world_size
        self.ramped_adam = ramped_adam
        # the whole training set resident on the device, each epoch gathered
        # there by index: the same batches and draws as the streamed path
        self.device_cache = device_cache
        self._device_data: Optional[DeviceResidentData] = None
        self.mean_teacher = mean_teacher
        self.no_synthetic = no_synthetic
        self.no_weak = no_weak
        self.subpart_data = subpart_data
        # a separate cap for the unlabeled manifest (default: subpart_data):
        # the semi-supervised ablation (tools/ablate_ssl_torch.py) keeps the
        # labeled budget and raises only this, toward the real ~5:1 ratio
        self.subpart_unlabeled = subpart_unlabeled if subpart_unlabeled is not None else subpart_data
        self.synthetic_audio = synthetic_audio
        self.synthetic_variability = synthetic_variability
        # {stream_name: (lo, hi)}: the synthetic source's nuisance quantile
        # band for that stream (audio_io.synth_clip `nuisance_band`), the
        # full band for a stream not listed; both views of a stream take it
        self.synthetic_bands = dict(synthetic_bands or {})
        # the teacher featurizes an independent second render of each clip
        self.paired_teacher_view = paired_teacher_view
        if paired_teacher_view:
            assert synthetic_audio and mean_teacher, (
                "paired_teacher_view needs --synthetic_audio (a second view "
                "is rendered, not recorded) and the Mean-Teacher recipe"
            )
        self.log = logger or get_logger()
        self.seed = seed
        self.classes = list(cfg.classes)
        ptr = cfg.model.pooling_time_ratio
        self.codec = LabelCodec(self.classes, n_frames=cfg.dsp.max_frames // ptr)
        d = cfg.dsp
        # K1 stays float32 under a bfloat16 model (a kept divergence: the
        # JAX frontend follows the compute dtype)
        self.frontend = MelFrontend(
            sample_rate=d.sample_rate, n_window=d.n_window, hop_length=d.hop_length, n_mels=d.n_mels,
            f_min=d.f_min, f_max=d.f_max, max_frames=d.max_frames, amin=d.amin, top_db=d.top_db,
            device=self.device,
        )
        # float32 work in full float32 on the card (cuDNN defaults to TF32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.scaler = Scaler()
        self.epoch_stats: List[Dict] = []
        self._set_step = None
        self._built = False

    # ------------------------------------------------------------ sources

    def _source_for(self, manifest: Manifest, tsv_path: str, stream_name: str = "",
                    view_salt: str = "desed-synth"):
        if self.synthetic_audio:
            return SyntheticAudioSource(
                manifest, self.classes, self.cfg.dsp.sample_rate, self.cfg.dsp.max_len_seconds,
                variability=self.synthetic_variability, nuisance_band=self.synthetic_bands.get(stream_name),
                seed_salt=view_salt,
            )
        return WavAudioSource(self.cfg.paths.audio_dir_for_meta(tsv_path), self.cfg.dsp.sample_rate)

    def _make_stream(self, name: str, manifest: Manifest, tsv_path: str, cache=True) -> Stream:
        d = self.cfg.dsp
        source = self._source_for(manifest, tsv_path, stream_name=name)
        source2 = None
        if self.paired_teacher_view:
            # same manifest, band and variability, distinct salt → an
            # independent nuisance render of every clip (same labels)
            source2 = self._source_for(manifest, tsv_path, stream_name=name, view_salt="desed-synth/v2")
        if not self.synthetic_audio:
            # drop rows whose wav is absent, with a logged error per file
            # (reference DatasetDcase2019Task4.py:254-262)
            from dcase2019_task4_tpu_torch.data.features_cache import drop_missing_audio

            manifest = drop_missing_audio(manifest, source, self.log)
        return Stream(name, manifest, source, self.codec, d.sample_rate, d.hop_length,
                      self.cfg.model.pooling_time_ratio, cache_audio=cache, source2=source2)

    # -------------------------------------------------------------- build

    def build(self):
        """Load manifests, make splits (reference seeds), build streams,
        fit the scaler on the device, build the steps and the state."""
        cfg, t = self.cfg, self.cfg.train
        p = cfg.paths
        weak_m = subpart_manifest(load_manifest(p.weak), self.subpart_data, t.subpart_seed)
        unlabel_m = subpart_manifest(load_manifest(p.unlabel), self.subpart_unlabeled, t.subpart_seed)
        synth_m = subpart_manifest(load_manifest(p.synthetic), self.subpart_data, t.subpart_seed)

        # 80/20 splits, seed 26 (main.py:215-223)
        train_weak_m, valid_weak_m = split_weak(weak_m, 1 - t.valid_fraction, t.split_seed)
        train_synth_m, valid_synth_m = split_synthetic(synth_m, 1 - t.valid_fraction, t.split_seed)
        self.valid_weak_m = valid_weak_m

        bs = t.batch_size
        if self.no_weak:
            # main_simple_CRNN.py -n: synthetic only
            streams = [self._make_stream("synthetic", train_synth_m, p.synthetic)]
            batch_sizes = [bs]
        elif not self.mean_teacher:
            # main_simple_CRNN.py default: [weak ½ | synthetic ½]
            streams = [
                self._make_stream("weak", train_weak_m, p.weak),
                self._make_stream("synthetic", train_synth_m, p.synthetic),
            ]
            batch_sizes = [bs // 2, bs // 2]
        elif self.no_synthetic:
            # main.py -n: [weak ¼ | unlabeled ¾] (main.py:242-245)
            streams = [
                self._make_stream("weak", train_weak_m, p.weak),
                self._make_stream("unlabeled", unlabel_m, p.unlabel, cache=False),
            ]
            batch_sizes = [bs // 4, 3 * bs // 4]
        else:
            # main.py default: [weak ¼ | unlabeled ½ | synthetic ¼]
            streams = [
                self._make_stream("weak", train_weak_m, p.weak),
                self._make_stream("unlabeled", unlabel_m, p.unlabel, cache=False),
                self._make_stream("synthetic", train_synth_m, p.synthetic),
            ]
            batch_sizes = [bs // 4, bs // 2, bs // 4]
        d = cfg.dsp
        # data parallel: every rank draws the global batch (the per-rank
        # layout tiled world times) and builds its shard-major cut
        self.pipeline = BatchPipeline(streams, batch_sizes, d.max_samples, d.n_window, d.hop_length,
                                      d.max_frames, seed=self.seed, n_shards=self.process_count,
                                      process_index=self.process_index, process_count=self.process_count)
        # loss masks = static per-rank slices of the stream layout (main.py:238-247)
        slices = self.pipeline.stream_slices()
        names = [s.name for s in streams]
        self.weak_slice = slices[names.index("weak")] if "weak" in names else None
        self.strong_slice = slices[names.index("synthetic")] if "synthetic" in names else None
        # data parallel: each rank validates every world-th file; validate()
        # sums the additive counts over the ranks
        valid_synth_m = shard_manifest(valid_synth_m, self.process_index, self.process_count)
        valid_weak_m = shard_manifest(valid_weak_m, self.process_index, self.process_count)
        self.valid_synth_rows = valid_synth_m.rows
        self.valid_synth_stream = self._make_stream("valid_synth", valid_synth_m, p.synthetic)
        self.valid_weak_stream = self._make_stream("valid_weak", valid_weak_m, p.weak)
        if self.device_cache:
            t0 = time.time()
            self._device_data = DeviceResidentData(self.pipeline, self.device, mesh=self.mesh)
            self.log.info(f"device-resident dataset: {self._device_data.nbytes / 2**20:.0f} MiB pinned in "
                          f"{time.time() - t0:.1f}s (one gathered batch a step, no batch queue)")
        self._fit_scaler()
        self._build_steps()
        self._built = True
        return self

    def _scaler_cache_key(self) -> str:
        """Hash over everything that determines the scaler moments: the
        per-stream file lists, the DSP config, the audio-source kind (with
        the variability and any nuisance bands), and each real wav's (size,
        mtime_ns). The same key as the JAX package's for the same run."""
        h = hashlib.sha1()
        h.update(repr(self.cfg.dsp).encode())
        h.update(repr(bool(self.synthetic_audio)).encode())
        if self.synthetic_audio:
            h.update(repr(float(self.synthetic_variability)).encode())
            if self.synthetic_bands:
                h.update(repr(sorted(self.synthetic_bands.items())).encode())
        for s in self.pipeline.streams:
            h.update(s.name.encode())
            for fn in s.filenames:
                h.update(fn.encode())
                if not self.synthetic_audio:
                    st = os.stat(s.source.path_for(fn))
                    h.update(f"{st.st_size},{st.st_mtime_ns}".encode())
        return h.hexdigest()[:16]

    def _fit_scaler(self):
        """Dataset-moment pass on the device over all training streams
        (reference Scaler.calculate_scaler over the ConcatDataset,
        main.py:249-250: equal weight per clip, features without noise).
        Only two [n_mels] vectors come back per batch, summed in float64;
        under `device_cache` the batches are slices of the resident rows.
        DCASE_SCALER_CACHE=<dir> memoizes the fit (`_scaler_cache_key`)."""
        cache_dir = os.environ.get("DCASE_SCALER_CACHE")
        cache_path = None
        if cache_dir:
            cache_path = os.path.join(cache_dir, f"scaler_{self._scaler_cache_key()}.json")
            if os.path.exists(cache_path):
                self.scaler.load(cache_path)
                self.log.info(f"scaler stats loaded from cache: {cache_path}")
                return
        self.log.info("fitting scaler (device pass over training features)")
        t0 = time.time()
        stats = make_scaler_stats(self.frontend)
        B = max(self.pipeline.batch_size, 8)
        d = self.cfg.dsp
        total = total_sq = None
        count = 0
        if self._device_data is not None:  # the resident rows in [B] slices, the tail masked by n_valid
            dd = self._device_data
            batches = ((dd.data["audio"][lo:lo + B], dd.data["frames"][lo:lo + B], min(dd.n_real - lo, B))
                       for lo in range(0, dd.n_real, B))
        else:
            batches = ((b["audio"], b["frames"], b["n_valid"]) for stream in self.pipeline.streams
                       for b in iter_eval_batches(stream, B, d.max_samples, d.n_window, d.hop_length, d.max_frames))
        for audio, frames, nv in batches:
            s, sq = stats(torch.as_tensor(audio, device=self.device), torch.as_tensor(frames, device=self.device), nv)
            s, sq = s.cpu().numpy().astype(np.float64), sq.cpu().numpy().astype(np.float64)
            total = s if total is None else total + s
            total_sq = sq if total_sq is None else total_sq + sq
            count += nv
        self.scaler.mean_ = total / count
        self.scaler.mean_of_square_ = total_sq / count
        self.scaler._finalize()
        self.log.info(f"scaler fit in {time.time() - t0:.1f}s ({count} clips)")
        if cache_path and self.process_index == 0:
            os.makedirs(cache_dir, exist_ok=True)
            self.scaler.save(cache_path)
            self.log.info(f"scaler stats cached: {cache_path}")

    def _build_steps(self):
        t = self.cfg.train
        if len(self.pipeline) == 0:
            sizes = {s.name: len(s) for s in self.pipeline.streams}
            raise ValueError(
                f"0 steps/epoch: global batch {self.pipeline.batch_size} "
                f"(per-stream {self.pipeline.sampler.batch_sizes}, the batch of each of "
                f"{self.process_count} ranks) exceeds the available stream sizes {sizes}: "
                "lower the batch size or the world size, or raise --subpart_data"
            )
        # rampup_length = steps/epoch · the config's n_epoch / 2 (main.py:72)
        rampup_length = len(self.pipeline) * t.n_epoch // 2
        self._set_step = None
        if self.ramped_adam:
            # the reference's (commented-out) adjust_learning_rate recipe
            # (main.py:32-42,81), set before each update
            from dcase2019_task4_tpu_torch.train.schedules import meanteacher_adam

            total_steps = len(self.pipeline) * t.n_epoch

            def make_optimizer(params):
                optimizer, self._set_step = meanteacher_adam(params, total_steps, rampup_length,
                                                             max_learning_rate=t.lr)
                return optimizer

            self.log.info("using ramped-Adam schedule (train/schedules.py)")
        else:
            def make_optimizer(params):
                return torch.optim.Adam(params, lr=t.lr, betas=(t.beta1, t.beta2), eps=t.adam_eps)

        mean, std = self.scaler.mean_std_f32
        sa_cfg = None
        if t.spec_augment:
            sa_cfg = dict(time_masks=t.sa_time_masks, max_time_width=t.sa_max_time_width,
                          freq_masks=t.sa_freq_masks, max_freq_width=t.sa_max_freq_width)
        self.train_step = make_train_step(
            self.weak_slice,
            self.strong_slice,
            mean_teacher=self.mean_teacher,
            rampup_length=rampup_length,
            max_consistency_cost=t.max_consistency_cost,
            ema_alpha=t.ema_alpha,
            frontend=self.frontend,
            scaler_mean=mean,
            scaler_std=std,
            noise_std=t.noise_std if self.mean_teacher else 0.0,
            spec_augment_cfg=sa_cfg,
            mesh=self.mesh,
        )
        self.eval_features = make_eval_features(self.frontend, mean, std)
        self.state = init_train_state(self.cfg.model, make_optimizer, torch.Generator().manual_seed(self.seed),
                                      with_ema=self.mean_teacher, device=self.device)
        if self.mesh is not None:
            replicate_state(self.state, self.mesh)
        self.predict_step = make_predict_step(self.state.student)

    # -------------------------------------------------------------- train

    def train_epoch(self, epoch: int) -> AverageMeterSet:
        """One epoch (reference train(), main.py:52-165): the multi-stream
        batches through the step, the metric sums fetched once, the loss
        asserted sane on the host at the first, every 20th and the last
        step (main.py:147-148). Under `device_cache` the batches are
        gathered from the resident rows instead. `epoch_stats` gains the
        epoch's wall time, steps and the seconds the loop waited on the
        batch queue (0.0 with resident rows). Data parallel: the metric sums
        are averaged over the ranks once, at the epoch's end."""
        meters = AverageMeterSet()
        generator = torch.Generator(device=self.device).manual_seed(epoch_seed(self.seed, epoch,
                                                                               self.process_index))
        start = time.time()
        n, wait = 0, 0.0
        acc = self.train_step.zero_metrics(self.device)
        if self._device_data is not None:  # gathered on the device: no batch queue to wait on
            host_iter = None
            feed = self._device_data.iter_epoch(self.pipeline.sampler, epoch)
        else:
            prefetch = self.cfg.train.num_prefetch
            host_iter = self.pipeline.iter_epoch(epoch, prefetch=prefetch, pin=self.device.type == "cuda")
            feed = device_prefetch(host_iter, prefetch, self.device)
        try:
            while True:
                t0 = time.time()
                batch = next(feed, None)
                if host_iter is not None:
                    wait += time.time() - t0
                if batch is None:
                    break
                if self._set_step is not None:
                    self._set_step(self.state.step)
                self.state, metrics, acc = self.train_step(self.state, batch, generator, acc)
                n += 1
                if n == 1 or n % 20 == 0 or n == len(self.pipeline):
                    loss = float(metrics["loss"])
                    assert not (np.isnan(loss) or loss > 1e5), f"Loss explosion: {loss}"
                    assert loss >= 0, "Loss problem, cannot be negative"
        finally:
            if host_iter is not None:
                host_iter.close()  # an epoch left early stops the batch worker
        # exact per-batch epoch means from the on-device metric sums — one
        # fetch per epoch (main.py:106-150)
        if n:
            keys = self.train_step.metric_keys
            acc = self.train_step.mean_over_ranks(acc)
            sums = torch.stack([acc[k] for k in keys]).cpu().tolist()
            for k, v in zip(keys, sums):
                meters.update(k, v / n, n)
        seconds = time.time() - start
        self.epoch_stats.append({"epoch": epoch, "seconds": seconds, "steps": n, "queue_wait_s": wait})
        self.log.info(f"Epoch: {epoch}\tTime {seconds:.2f}\t{meters}")
        return meters

    # ---------------------------------------------------------- validate

    def _eval_batches(self, stream: Stream):
        d = self.cfg.dsp
        for batch in iter_eval_batches(stream, self.pipeline.batch_size, d.max_samples, d.n_window,
                                       d.hop_length, d.max_frames):
            x = self.eval_features(torch.as_tensor(batch["audio"], device=self.device),
                                   torch.as_tensor(batch["frames"], device=self.device))
            strong, weak = self.predict_step(x)
            nv = batch["n_valid"]
            yield batch, strong[:nv], weak[:nv]

    def predict_dataframe(self, stream: Stream, save_predictions: Optional[str] = None):
        """Batched inference + decode over a stream → event rows
        (event_label, onset, offset, filename) in seconds (replaces
        get_predictions, evaluation_measures.py:203-231)."""
        d = self.cfg.dsp
        rows = []
        for batch, strong, _ in self._eval_batches(stream):
            rows += decode_batch(strong, batch["filenames"], self.codec, d.sample_rate, d.hop_length,
                                 self.cfg.model.pooling_time_ratio, threshold=0.5,
                                 median_window=self.cfg.train.median_window)
        return write_events_tsv(rows, save_predictions)

    def weak_f1(self, stream: Stream) -> np.ndarray:
        """Per-class weak tagging F1 over a stream (get_f_measure_by_class,
        evaluation_measures.py:19-83). Data parallel: the confusion counts
        summed over the ranks (exact for a sharded stream, and for one every
        rank scores whole, since F1 does not change with the counts'
        scale)."""
        acc = TaggingF1(len(self.classes))
        for batch, _, weak in self._eval_batches(stream):
            acc.update(weak.cpu().numpy(), batch["target"][: batch["n_valid"]])
        if self.mesh is None:
            return acc.per_class_f1()
        tp, fp, fn = all_sum_hosts(np.stack([acc.tp, acc.fp, acc.fn]), self.mesh)
        return macro_f_measure(tp, fp, fn)

    def _merged_strong_metrics(self, predictions):
        """Data parallel: this rank's files scored, the additive count
        vectors summed over the ranks and the metrics rebuilt, so every rank
        logs the numbers of an unsharded run."""
        ev_local = event_based_metrics(self.valid_synth_rows, predictions, 0.200, 0.2)
        seg_local = segment_based_metrics(self.valid_synth_rows, predictions, 1.0)
        ev = SedMetrics.from_counts(self.classes, "Event-based",
                                    all_sum_hosts(ev_local.count_vector(self.classes), self.mesh))
        seg = SedMetrics.from_counts(self.classes, "Segment-based",
                                     all_sum_hosts(seg_local.count_vector(self.classes), self.mesh), segment_based=True)
        self.log.info(str(ev))
        self.log.info(str(seg))
        return ev

    def _log_weak(self, weak: np.ndarray):
        self.log.info(f"Weak F1 per class: {dict(zip(self.classes, np.round(weak * 100, 2)))}")
        self.log.info(f"Weak F1 macro averaged: {np.mean(weak):.4f}")

    def validate(self, epoch: int) -> Dict[str, float]:
        if not self.mean_teacher:
            # the supervised recipe also reports per-epoch TRAIN-set metrics
            # (main_simple_CRNN.py:236-252)
            names = [s.name for s in self.pipeline.streams]
            if "synthetic" in names:
                self.log.info("Training synthetic metric:")
                train_stream = self.pipeline.streams[names.index("synthetic")]
                compute_strong_metrics(self.predict_dataframe(train_stream), train_stream.manifest.rows, self.log)
            if "weak" in names:
                self.log.info("Training weak metric:")
                self._log_weak(self.weak_f1(self.pipeline.streams[names.index("weak")]))
        self.log.info("### Valid synthetic metric ###")
        predictions = self.predict_dataframe(self.valid_synth_stream)
        if self.mesh is None:
            event_metric = compute_strong_metrics(predictions, self.valid_synth_rows, self.log)
        else:
            event_metric = self._merged_strong_metrics(predictions)
        self.log.info("### Valid weak metric ###")
        weak = self.weak_f1(self.valid_weak_stream)
        self._log_weak(weak)
        event_macro = event_metric.results_class_wise_average_metrics()["f_measure"]["f_measure"]
        return {"event_macro_f1": event_macro, "weak_macro_f1": float(np.mean(weak))}

    # ----------------------------------------------------------- full run

    def checkpoint_metadata(self, epoch: int, valid: Dict) -> Dict:
        return {
            "epoch": epoch,
            "valid_metric": valid,
            "pooling_time_ratio": self.cfg.model.pooling_time_ratio,
            "scaler": self.scaler.state_dict(),
            "many_hot_encoder": self.codec.state_dict(),
            "config": ckpt.config_to_dict(self.cfg),
            "mean_teacher": self.mean_teacher,
        }

    def _save(self, path: str, meta: Dict):
        """Rank 0 writes; the ranks hold the same state."""
        if self.process_index == 0:
            ckpt.save_checkpoint(path, self.state, meta, ramped_adam=self.ramped_adam)

    def run(
        self,
        store_dir: Optional[str] = None,
        n_epoch: Optional[int] = None,
        resume_from: Optional[str] = None,
        early_stopping: Optional[int] = None,
        eval_every: int = 1,
    ) -> Dict:
        """The reference's epoch loop with per-epoch validation,
        checkpointing and SaveBest on event-F1 + weak-F1 (main.py:316-354).
        `resume_from` restores a checkpoint (weights, EMA, optimizer, step,
        scaler) and continues after its epoch; `early_stopping` is the
        patience in epochs on the SaveBest criterion; `eval_every`
        validates, checkpoints and runs SaveBest every Nth epoch and the
        last. Each epoch appends a record to `<store_dir>/metrics.jsonl`:
        the JAX package's keys, and the port's `steps_per_s` and
        `queue_wait_share` (the share of the epoch the loop waited on the
        batch queue). The best checkpoint is restored at the end."""
        if not self._built:
            self.build()
        t = self.cfg.train
        n_epoch = n_epoch if n_epoch is not None else t.n_epoch
        store_dir = store_dir or os.path.join(self.cfg.paths.store_dir, "run")
        model_dir = os.path.join(store_dir, "model")
        os.makedirs(model_dir, exist_ok=True)
        save_best = SaveBest("sup")
        stopper = EarlyStopping(early_stopping, "sup") if early_stopping is not None else None
        best_path = os.path.join(model_dir, "baseline_best")
        last_valid: Dict = {}
        start_epoch = 0
        if resume_from is not None:
            meta = self.restore(resume_from)
            start_epoch = int(meta["epoch"]) + 1
            self.log.info(f"resumed from {resume_from} at epoch {start_epoch}")
        writer = MetricsWriter(os.path.join(store_dir, "metrics.jsonl") if self.process_index == 0 else None)
        for epoch in range(start_epoch, n_epoch):
            t0 = time.time()
            meters = self.train_epoch(epoch)
            stats = self.epoch_stats[-1]
            loop = {"steps_per_s": stats["steps"] / stats["seconds"],
                    "queue_wait_share": stats["queue_wait_s"] / stats["seconds"]}
            if eval_every > 1 and (epoch + 1) % eval_every != 0 and epoch != n_epoch - 1:
                writer.write({"epoch": epoch, "epoch_time_s": round(time.time() - t0, 2),
                              **meters.averages(""), **loop})
                continue
            last_valid = self.validate(epoch)
            if self.strong_slice is not None:
                global_valid = last_valid["event_macro_f1"] + last_valid["weak_macro_f1"]
            else:
                global_valid = last_valid["weak_macro_f1"]
            meta = self.checkpoint_metadata(epoch, last_valid)
            if t.checkpoint_epochs and (epoch + 1) % t.checkpoint_epochs == 0:
                self._save(os.path.join(model_dir, f"baseline_epoch_{epoch}"), meta)
            is_best = bool(t.save_best and save_best.apply(global_valid))
            if is_best:
                self._save(best_path, meta)
            writer.write({
                "epoch": epoch,
                "epoch_time_s": round(time.time() - t0, 2),
                **meters.averages(""),
                **last_valid,
                "global_valid": global_valid,
                "saved_best": is_best,
                **loop,
            })
            if stopper is not None and stopper.apply(global_valid):
                self.log.info(
                    f"early stopping at epoch {epoch}: no improvement over "
                    f"{stopper.best_val:.4f} (epoch {stopper.best_epoch}) for "
                    f"{early_stopping} epochs"
                )
                break
        writer.close()
        sync_hosts(self.mesh)  # rank 0's checkpoints are on disk before any rank reads one
        if t.save_best and os.path.exists(best_path):
            self.state, meta = ckpt.restore_checkpoint(best_path, self.state, self.ramped_adam)
            if self.mesh is not None:
                replicate_state(self.state, self.mesh)
            self.log.info(f"testing model: {best_path} (epoch {meta['epoch']})")
        return last_valid

    # ------------------------------------------------------------ resume

    def restore(self, path: str):
        """Restore a checkpoint into this experiment: scaler moments first,
        then the step closures rebuilt around them, then the train state."""
        if not self._built:
            self.build()
        meta = ckpt.read_metadata(path)
        self.scaler.load_state_dict(meta["scaler"])
        self._build_steps()
        self.state, _ = ckpt.restore_checkpoint(path, self.state, self.ramped_adam)
        if self.mesh is not None:
            replicate_state(self.state, self.mesh)
        return meta
