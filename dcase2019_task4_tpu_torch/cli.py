"""Command-line entry points of the PyTorch/CUDA port.

    python -m dcase2019_task4_tpu_torch.cli train_meanteacher [-s N] [--epochs E] [--store_dir DIR]
        [--synthetic_audio] [-n] [--bf16 | --scaled] [--resume CKPT] [--early_stopping P]
        [--eval_every K] [--ramped_adam] [--device_cache] [--device cuda]
        [--data_parallel | --multihost --coordinator_address H:P --num_processes N --process_id I]
    python -m dcase2019_task4_tpu_torch.cli train_crnn ... [-n]
    python -m dcase2019_task4_tpu_torch.cli evaluate -m CKPT [--torch_checkpoint] [-s N] [-p OUT.tsv]
        [--sets TSV ...] [--tune_thresholds [--save_thresholds F.json]] [--synthetic_audio] [--device cuda]
        [--data_parallel] [--export ARTIFACT [--export_batch B]]
    python -m dcase2019_task4_tpu_torch.cli predict -m CKPT [--torch_checkpoint] -i WAV_DIR_OR_TSV -p OUT.tsv
        [-s N] [--weak_fname TAGS.tsv] [--threshold T | --thresholds_json F]
        [--median_windows_json F] [--long [--overlap] [--merge_gap G]] [--synthetic_audio]
        [--device cuda] [--data_parallel]
    python -m dcase2019_task4_tpu_torch.cli precompute [--sets TSV ...] [-s N] [--feature_dir DIR]
        [--nolog] [--device cuda]
    python -m dcase2019_task4_tpu_torch.cli download [--sets TSV ...] [--n_jobs J] [--chunk_size K]

The console scripts `dcase19-torch-train-meanteacher`, `dcase19-torch-train-crnn`,
`dcase19-torch-evaluate`, `dcase19-torch-predict`,
`dcase19-torch-extract-features` (precompute) and `dcase19-torch-download`
are the same commands. The flags are the JAX package's
(dcase2019_task4_tpu/cli.py), plus `--device`.

Data parallel, one process a card: `torchrun --nproc_per_node=<cards> -m
dcase2019_task4_tpu_torch.cli <command> ... --data_parallel` (each rank
reads torchrun's RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT
and takes cuda:LOCAL_RANK, or the CPU with `--device cpu`); or, for the
training commands, one process a card started by hand with `--multihost
--coordinator_address HOST:PORT --num_processes N --process_id I`
(which implies `--data_parallel`). The batch size is a rank's. A caller
that brought up its process group itself keeps it.
"""

from __future__ import annotations

import argparse
import os
import sys

from dcase2019_task4_tpu_torch.config import Config
from dcase2019_task4_tpu_torch.utils.logger import get_logger

def _device_arg(parser):
    parser.add_argument("--device", type=str, default="cuda",
                        help="Torch device. 'cuda' without a card raises; there is no CPU fallback.")


def _torch_checkpoint_arg(parser):
    parser.add_argument("--torch_checkpoint", action="store_true", default=False,
                        help="model_path is a reference torch.save checkpoint (imported by "
                        "train/torch_import.py; the reference stores no attention head, the model keeps "
                        "its own seeded one).")


def _evaluator(args, mesh):
    """The CheckpointEvaluator of `args.model_path`: a checkpoint of either
    package, or with `--torch_checkpoint` a reference torch.save file."""
    from dcase2019_task4_tpu_torch.eval.evaluate import CheckpointEvaluator

    kw = dict(device=args.device, synthetic_audio=args.synthetic_audio, mesh=mesh)
    if args.torch_checkpoint:
        return CheckpointEvaluator.from_torch_checkpoint(args.model_path, **kw)
    return CheckpointEvaluator(args.model_path, **kw)


def _data_parallel_arg(parser):
    parser.add_argument("--data_parallel", action="store_true", default=False,
                        help="One process a card in a torch.distributed group (run under torchrun): BatchNorm "
                        "statistics and gradients of the global batch, validation sharded by file.")


def _mesh(args):
    """The data-parallel mesh the flags ask for, or None. The group comes
    up through `multihost.initialize`: from the multi-host flags (any of
    them selects multi-host), or from torchrun's environment; a group the
    caller already brought up is kept.
    `args.device` becomes this rank's device (cuda:LOCAL_RANK unless it
    names a card)."""
    multihost = bool(getattr(args, "multihost", False) or getattr(args, "coordinator_address", None)
                     or getattr(args, "num_processes", None) is not None
                     or getattr(args, "process_id", None) is not None)
    if not (multihost or args.data_parallel):
        return None
    import torch
    import torch.distributed as dist

    from dcase2019_task4_tpu_torch.eval.evaluate import resolve_device
    from dcase2019_task4_tpu_torch.parallel import mesh, multihost as mh

    device = resolve_device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    args.device = str(device)
    if not dist.is_initialized():
        if multihost:
            mh.initialize(args.coordinator_address, args.num_processes, args.process_id, device=device)
        else:
            missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT") if k not in os.environ]
            if missing:
                raise RuntimeError(f"--data_parallel runs under torchrun: {', '.join(missing)} not set "
                                   "(or give --multihost with its flags)")
            mh.initialize(f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}", int(os.environ["WORLD_SIZE"]),
                          int(os.environ["RANK"]), device=device)
    m = mesh.make_mesh(device, multihost=multihost)
    get_logger().info(f"data parallel: rank {m.rank} of {m.world_size} on {device} over {m.backend}")
    return m


def _common_train_args(parser):
    parser.add_argument("-s", "--subpart_data", type=int, default=None,
                        help="Number of files per set (smoke-scale runs).")
    parser.add_argument("--epochs", type=int, default=None, help="Override n_epoch.")
    parser.add_argument("--store_dir", type=str, default=None)
    parser.add_argument("--synthetic_audio", action="store_true", default=False,
                        help="Fabricate class-consistent audio instead of reading wavs.")
    parser.add_argument("--synthetic_variability", type=float, default=0.0,
                        help="With --synthetic_audio: nuisance variation strength (0 = the "
                        "deterministic tone-bank source).")
    parser.add_argument("--paired_teacher_view", action="store_true", default=False,
                        help="Mean-Teacher only, with --synthetic_audio: the teacher featurizes an "
                        "independent render of each training clip.")
    _data_parallel_arg(parser)
    parser.add_argument("--bf16", action="store_true", default=False,
                        help="bfloat16 conv compute.")
    parser.add_argument("--scaled", action="store_true", default=False,
                        help="Scaled config: 128 mels, 128-ch convs, 128-cell BiGRU, SpecAugment, bf16.")
    parser.add_argument("--resume", type=str, default=None,
                        help="Checkpoint to resume training from (either package's).")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--early_stopping", type=int, default=None,
                        help="Stop after N epochs without improvement of the SaveBest criterion.")
    parser.add_argument("--ramped_adam", action="store_true", default=False,
                        help="Ramped Adam hyperparameter schedule (train/schedules.py).")
    parser.add_argument("--device_cache", action="store_true", default=False,
                        help="Keep the whole training set on the device and gather each batch there "
                        "(small sets; the same batches and draws as the streamed pipeline).")
    parser.add_argument("--eval_every", type=int, default=1,
                        help="Validate/checkpoint/SaveBest every Nth epoch (and the last).")
    parser.add_argument("--multihost", action="store_true", default=False,
                        help="One process a card started by hand: bring up the process group from the three "
                        "flags below (parallel/multihost.py); implies --data_parallel.")
    parser.add_argument("--coordinator_address", type=str, default=None,
                        help="host:port where process 0 listens (multi-host).")
    parser.add_argument("--num_processes", type=int, default=None, help="Processes in all (multi-host).")
    parser.add_argument("--process_id", type=int, default=None, help="This process's index (multi-host).")
    _device_arg(parser)


def _build_experiment(args, mean_teacher: bool, no_synthetic=False, no_weak=False):
    import dataclasses

    from dcase2019_task4_tpu_torch.train.experiment import Experiment

    mesh = _mesh(args)
    if args.scaled:
        from dcase2019_task4_tpu_torch.config import scaled_config

        cfg = scaled_config()
    else:
        cfg = Config()
    if args.bf16:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, compute_dtype="bfloat16"))
    return Experiment(
        cfg,
        mean_teacher=mean_teacher,
        no_synthetic=no_synthetic,
        no_weak=no_weak,
        subpart_data=args.subpart_data,
        synthetic_audio=args.synthetic_audio,
        synthetic_variability=args.synthetic_variability,
        seed=args.seed,
        ramped_adam=args.ramped_adam,
        paired_teacher_view=args.paired_teacher_view,
        device=args.device,
        device_cache=args.device_cache,
        mesh=mesh,
    )


def _train(argv, mean_teacher: bool):
    if mean_teacher:
        parser = argparse.ArgumentParser(prog="dcase19-torch-train-meanteacher",
                                         description="Mean-Teacher CRNN training (main.py parity)")
        _common_train_args(parser)
        parser.add_argument("-n", "--no_synthetic", action="store_true", default=False,
                            help="Not using synthetic labels during training")
    else:
        parser = argparse.ArgumentParser(prog="dcase19-torch-train-crnn",
                                         description="Supervised CRNN training (main_simple_CRNN.py parity)")
        _common_train_args(parser)
        parser.add_argument("-n", "--no_weak", action="store_true", default=False,
                            help="Not using weak labels during training")
    args = parser.parse_args(argv)
    log = get_logger()
    if mean_teacher:
        log.info("MEAN TEACHER")
        log.info(f"subpart_data = {args.subpart_data}")
        log.info(f"Using synthetic data = {not args.no_synthetic}")
        store = args.store_dir or os.path.join(
            Config().paths.store_dir, "MeanTeacher" + ("_no_synthetic" if args.no_synthetic else "_with_synthetic"))
        exp = _build_experiment(args, mean_teacher=True, no_synthetic=args.no_synthetic)
    else:
        log.info("Simple CRNNs")
        store = args.store_dir or os.path.join(
            Config().paths.store_dir, "simple_CRNN" + ("_synthetic_only" if args.no_weak else "_with_weak"))
        exp = _build_experiment(args, mean_teacher=False, no_weak=args.no_weak)
    exp.build()
    result = exp.run(store_dir=store, n_epoch=args.epochs, resume_from=args.resume,
                     early_stopping=args.early_stopping, eval_every=args.eval_every)
    # final test on validation + public eval (main.py:356-373)
    _final_test(exp, store, args)
    return result if argv is not None else None  # a console script exits 0


def train_meanteacher(argv=None):
    """Mean-Teacher training (main.py parity); returns the last validation
    metrics when called with an argument list."""
    return _train(argv, mean_teacher=True)


def train_crnn(argv=None):
    """Supervised CRNN training (main_simple_CRNN.py parity); returns the
    last validation metrics when called with an argument list."""
    return _train(argv, mean_teacher=False)


def _final_test(exp, store, args):
    """The best checkpoint's predictions on the validation and public-eval
    sets, under `<store>/predictions/`."""
    from dcase2019_task4_tpu_torch.eval.evaluate import CheckpointEvaluator

    best = os.path.join(store, "model", "baseline_best")
    if not os.path.exists(best):
        return
    pred_dir = os.path.join(store, "predictions")
    os.makedirs(pred_dir, exist_ok=True)
    ev = CheckpointEvaluator(best, device=args.device, synthetic_audio=args.synthetic_audio, mesh=exp.mesh)
    ev.test_model(exp.cfg.paths.validation, args.subpart_data, os.path.join(pred_dir, "baseline_validation.tsv"))
    ev.test_model(exp.cfg.paths.eval_desed, args.subpart_data, os.path.join(pred_dir, "baseline_eval2019.tsv"))


def evaluate(argv=None):
    """Checkpoint evaluation (TestModel.py parity): each set's event- and
    segment-based F1 and weak tagging F1. Returns {set: {event_macro_f1,
    weak_macro_f1}} when called with an argument list."""
    parser = argparse.ArgumentParser(prog="dcase19-torch-evaluate",
                                     description="Checkpoint evaluation (TestModel.py parity)")
    parser.add_argument("-m", "--model_path", type=str, required=True, help="Checkpoint to evaluate.")
    parser.add_argument("-s", "--subpart_data", type=int, default=None)
    parser.add_argument("-p", "--save_predictions_fname", type=str, default=None,
                        help="Predictions TSV of the last set.")
    parser.add_argument("--synthetic_audio", action="store_true", default=False)
    _torch_checkpoint_arg(parser)
    parser.add_argument("--sets", type=str, nargs="*", default=None,
                        help="TSV paths; default: eval2018, validation, public eval")
    parser.add_argument("--tune_thresholds", action="store_true", default=False,
                        help="Also grid-search per-class weak thresholds and event thresholds and median "
                        "windows on each set, and report their F1s.")
    parser.add_argument("--save_thresholds", type=str, default=None,
                        help="With --tune_thresholds: write the last set's tuned weak thresholds as "
                        "{class: threshold} JSON to this path, and its event thresholds and windows "
                        "beside it (<root>.event<ext>, <root>.event_windows<ext>).")
    parser.add_argument("--threshold", type=float, default=0.5, help="Strong-decode binarization threshold.")
    parser.add_argument("--thresholds_json", type=str, default=None,
                        help="Per-class decode thresholds JSON (dict or [C] list). Overrides --threshold.")
    parser.add_argument("--median_windows_json", type=str, default=None,
                        help="Per-class decode median-window JSON ([C] odd ints or {class: w}).")
    _data_parallel_arg(parser)
    parser.add_argument("--export", type=str, default=None,
                        help="Instead of evaluating, export the serving function (audio → event probabilities, "
                        "weights and scaler in the program) as a torch.export artifact at this path "
                        "(eval/export.py; load with eval.export.load_serving, which needs torch and the "
                        "port's op library).")
    parser.add_argument("--export_batch", type=int, default=None,
                        help="Batch size the artifact is traced at (default: the checkpoint's batch size).")
    _device_arg(parser)
    args = parser.parse_args(argv)

    mesh = _mesh(args)
    ev = _evaluator(args, mesh)
    if args.export:
        from dcase2019_task4_tpu_torch.eval.export import export_serving

        header = export_serving(ev, args.export, batch_size=args.export_batch)
        print(f"exported serving artifact → {args.export} "
              f"(batch {header['batch_size']}, platforms {header['platforms']})")
        return header if argv is not None else None
    paths = ev.cfg.paths
    sets = args.sets or [paths.eval2018, paths.validation, paths.eval_desed]
    threshold = ev.load_thresholds(args.thresholds_json) if args.thresholds_json else args.threshold
    median_window = ev.load_windows(args.median_windows_json) if args.median_windows_json else None
    results = {}
    for i, tsv in enumerate(sets):
        save = args.save_predictions_fname if i == len(sets) - 1 else None
        res = ev.test_model(tsv, args.subpart_data, save, tune_thresholds=args.tune_thresholds,
                            threshold=threshold, median_window=median_window)
        results[tsv] = {k: v for k, v in res.items() if k not in ("predictions", "strong")}
        if args.save_thresholds and "tuned_thresholds" in res and ev.is_writer():
            _save_thresholds(args.save_thresholds, ev.codec.labels, res)
    return results if argv is not None else None


def _save_thresholds(path: str, labels, res):
    """The tuned weak thresholds at `path`, and the event thresholds and
    windows beside it, each as {class: value} JSON (the formats
    --weak_thresholds_json, --thresholds_json and --median_windows_json
    read)."""
    import json

    root, ext = os.path.splitext(path)
    for out, key in ((path, "tuned_thresholds"), (f"{root}.event{ext or '.json'}", "tuned_event_thresholds"),
                     (f"{root}.event_windows{ext or '.json'}", "tuned_event_windows")):
        with open(out, "w") as f:
            json.dump(dict(zip(labels, res[key])), f, indent=1)


def predict(argv=None):
    """Groundtruth-free batched inference: checkpoint + wav dir (or filename
    TSV) → event predictions TSV (+ optional weak clip-tag TSV).

    Called with an argument list it returns the evaluator's result without
    the event list (n_files and the strong and weak probabilities). Called
    from the command line (argv None) it returns None, so the console
    script exits 0."""
    parser = argparse.ArgumentParser(prog="dcase19-torch-predict",
                                     description="Batched inference to a predictions TSV")
    parser.add_argument("-m", "--model_path", type=str, required=True)
    parser.add_argument("-i", "--input", type=str, required=True,
                        help="Directory of wavs, or a filename TSV.")
    parser.add_argument("-p", "--save_predictions_fname", type=str, required=True)
    parser.add_argument("-s", "--subpart_data", type=int, default=None)
    parser.add_argument("--weak_fname", type=str, default=None,
                        help="Also write clip-level tags (filename⇥event_labels).")
    parser.add_argument("--weak_threshold", type=float, default=0.5)
    parser.add_argument("--weak_thresholds_json", type=str, default=None,
                        help="Per-class clip-tagging thresholds JSON. Overrides --weak_threshold.")
    parser.add_argument("--threshold", type=float, default=0.5,
                        help="Strong-decode binarization threshold.")
    parser.add_argument("--thresholds_json", type=str, default=None,
                        help="Per-class decode thresholds JSON (dict or [C] list). Overrides --threshold.")
    parser.add_argument("--median_windows_json", type=str, default=None,
                        help="Per-class decode median-window JSON ([C] odd ints or {class: w}).")
    parser.add_argument("--synthetic_audio", action="store_true", default=False)
    _torch_checkpoint_arg(parser)
    parser.add_argument("--long", action="store_true", default=False,
                        help="Wavs of any length: cut into windows of the model's clip length, decode each "
                        "window, stitch events across the boundaries.")
    parser.add_argument("--merge_gap", type=float, default=0.2,
                        help="With --long: stitch same-class events whose gap is at most this many seconds.")
    parser.add_argument("--overlap", action="store_true", default=False,
                        help="With --long: half-window hop, probabilities averaged where windows overlap, "
                        "one decode per file over its whole timeline (no stitching).")
    _data_parallel_arg(parser)
    _device_arg(parser)
    args = parser.parse_args(argv)
    if args.long and args.weak_fname:
        parser.error("--weak_fname is per-clip; not defined under --long")
    mesh = _mesh(args)
    ev = _evaluator(args, mesh)
    threshold = ev.load_thresholds(args.thresholds_json) if args.thresholds_json else args.threshold
    median_window = ev.load_windows(args.median_windows_json) if args.median_windows_json else None
    if args.long:
        res = ev.predict_long(args.input, args.save_predictions_fname, subpart=args.subpart_data,
                              threshold=threshold, merge_gap=args.merge_gap, overlap=args.overlap,
                              median_window=median_window)
    else:
        weak_threshold = (ev.load_thresholds(args.weak_thresholds_json) if args.weak_thresholds_json
                          else args.weak_threshold)
        res = ev.predict_set(
            args.input, args.save_predictions_fname, subpart=args.subpart_data, weak_fname=args.weak_fname,
            weak_threshold=weak_threshold, threshold=threshold, median_window=median_window,
        )
    if argv is None:
        return None
    return {k: v for k, v in res.items() if k != "events"}


def precompute(argv=None):
    """Log-mel features of each set's clips to the reference's .npy layout
    (data/features_cache.py), computed on the device. Returns {set: the
    filenames cached} when called with an argument list."""
    parser = argparse.ArgumentParser(prog="dcase19-torch-extract-features",
                                     description="Precompute log-mel features to .npy")
    parser.add_argument("--sets", type=str, nargs="*", default=None,
                        help="TSV paths; default: weak, unlabeled, synthetic, validation")
    parser.add_argument("-s", "--subpart_data", type=int, default=None)
    parser.add_argument("--feature_dir", type=str, default=None)
    parser.add_argument("--nolog", action="store_true", default=False,
                        help="Store the linear mel (the reference's save_log_feature=False).")
    _device_arg(parser)
    args = parser.parse_args(argv)
    from dcase2019_task4_tpu_torch.data.audio_io import WavAudioSource
    from dcase2019_task4_tpu_torch.data.features_cache import precompute_features
    from dcase2019_task4_tpu_torch.data.manifests import load_manifest, subpart_manifest

    cfg = Config()
    sets = args.sets or [cfg.paths.weak, cfg.paths.unlabel, cfg.paths.synthetic, cfg.paths.validation]
    log = get_logger()
    results = {}
    for tsv in sets:
        m = subpart_manifest(load_manifest(tsv), args.subpart_data)
        src = WavAudioSource(cfg.paths.audio_dir_for_meta(tsv), cfg.dsp.sample_rate)
        results[tsv] = precompute_features(m, src, cfg, args.feature_dir, save_log_feature=not args.nolog,
                                           device=args.device)
        log.info(f"{tsv}: cached {len(results[tsv])}/{len(m)} files")
    return results if argv is not None else None


def download(argv=None):
    """DESED audio download (download_data.py parity): each set's clips
    fetched from YouTube into the audio directory its TSV maps to, and a
    `missing_files_<set>.tsv` of what failed. Returns {set: [(filename,
    error), ...]} when called with an argument list."""
    parser = argparse.ArgumentParser(prog="dcase19-torch-download",
                                     description="DESED audio download (download_data.py parity)")
    parser.add_argument("--sets", type=str, nargs="*", default=None,
                        help="TSV paths; default: validation, weak, unlabeled")
    parser.add_argument("--n_jobs", type=int, default=3)
    parser.add_argument("--chunk_size", type=int, default=10)
    args = parser.parse_args(argv)
    from dcase2019_task4_tpu_torch.data.download import download_sets

    cfg = Config()
    sets = args.sets or [cfg.paths.validation, cfg.paths.weak, cfg.paths.unlabel]
    result = download_sets(cfg, sets, n_jobs=args.n_jobs, chunk_size=args.chunk_size)
    return result if argv is not None else None


COMMANDS = {"train_meanteacher": train_meanteacher, "train_crnn": train_crnn, "evaluate": evaluate,
            "predict": predict, "precompute": precompute, "download": download}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in COMMANDS:
        sys.exit(f"usage: python -m dcase2019_task4_tpu_torch.cli {{{','.join(COMMANDS)}}} ...")
    COMMANDS[argv[0]](argv[1:])
    return 0


if __name__ == "__main__":
    main()
