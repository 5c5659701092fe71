#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dcase2019_task4_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero without
printing a result:

  1. card   — nvidia-smi's name and power limit, torch's device name;
  2. build  — compile csrc/*.cu with nvcc for sm_90a, one compiler per source
     in parallel (ptxas report printed; K4w's two kernels' registers and
     spills printed apart, and a spill of either fails); the product
     instruction of K3's, K2's and K5f / K5b1 / K5b2's and K4w's bfloat16
     kernels read from the library's machine code (HGMMA or HMMA, with the
     FFMA count; a kernel with neither fails), and of the FP32 product
     kernels (onedot K1, K3's float32 kernels, K2f's and K2b's float32
     kernels, K5's three float32 kernels, K4w's float32 kernel: FFMA, and a
     kernel with HGMMA or HMMA fails);
  3. kernels — each hand-written kernel against its plain PyTorch version on
     the card, at the flagship shapes, float32 with TF32 off: max abs error
     against a stated tolerance, median time over 10 runs after 3 warm-ups
     (CUDA events) for the kernel, for the plain version and, where one
     PyTorch call computes the same function, for that call (K2s:
     `torch.var_mean`); the kernel's
     bound (the larger of its bytes over 3.35 TB/s and its operations over
     67 TFLOP/s, float32 outside the tensor cores). Every kernel that folds
     per-block sums (K2b, K2s, K3w, K4f, K4w, K5s, K5b1, K5b2) runs twice and
     must repeat bit for bit. The entry-block family runs at the block-1
     shape: K4f's and K5s's sums are also held to K2s's on the stored y, K5f
     with a seed to F.conv2d -> K2f with that seed and to K4f -> K2f (bit
     for bit at rate 0 and the model's: the shared tile code on the same y),
     K5b1 to K4f -> K2b's float32 reduce pass without dy_partial with the
     same seed (bit for bit: the shared tile code, summed into K2b's slots),
     K5b2 to K4f -> K2b's float32 recompute fixup -> K4w (1e-6 of max: the
     same dy summed in another order; d conv_b with the gauge floor), the
     crows entries
     (statistics, forward, and both backward passes through their autograd
     Function) bit for bit to the fused entry block's own wrappers and to
     the plain versions on their own, and the keep-mask kernel bit for bit
     to `dropout_keep_mask`. K4w's library time is autograd through the
     model's own conv, as the default path reaches cuDNN; K3w float32's is
     `conv2d_weight`, with autograd through `F.conv2d` to w and b (the
     default step's cuDNN weight gradient) held to the kernel and timed
     beside it. K1 (the FFT
     kernel) is also held to a float64 DFT of the same frames: its error
     there may be at most twice the float32 plain version's; its library
     time is one `torch.fft.rfft` of the windowed frames (the transform
     alone), and one SGEMM of the TPU design's two DFT products is printed
     beside it; its bound is recounted from what the function needs. Then
     the bfloat16 modes of K3 (forward, dx, wgrad) and K2 (forward eval and
     dropout, K2s, both backward passes) at the scaled configuration's
     shapes (batch 24, 128 channels; K2 at [24, 864, 128, 128] in window
     tiles, [24, 432, 32, 128] and [24, 216, 8, 128] with pool (2, 8)),
     against the plain versions, which round where the kernels round:
     each bfloat16 output element within one bfloat16 ulp plus a stated
     slack (what one bf16 operand rounding the other way, a second rounding
     that follows, and the float32 rounding of the sums may add: an output
     that cancels to near zero differs by many of its own ulps), and at most
     1e-3 of the elements beyond the one ulp alone; float32 outputs 1e-4 of
     max; the
     library call is cuDNN's bfloat16 conv for K3; the bounds count the
     channel products on bfloat16 operands at the tensor cores' 989 TFLOP/s
     and the rest at 67 TFLOP/s, the bytes of bfloat16 tensors at two a value.
     Then the same bfloat16 K3 and K2 rows at the flagship's shapes (64
     channels, the `_flagship` rows; K3's weight gradient there is the
     gradient of the bfloat16 weights, each output-frequency class's sum
     rounded, held element by element to one ulp of itself plus one of each
     class sum), and the bfloat16 modes of the entry-block family at the
     flagship block-1 shape: K4f (y bfloat16, its float32 sums, against
     cuDNN's bfloat16 conv), K5s, K4w and K5b2 (dW in output-frequency
     parities), K5f eval and dropout (also against K4f -> K2f with the same
     seed, bit for bit at rate 0 and at the model's rate: the shared tile
     code on the same bfloat16 y), K5b1 (also against K4f -> K2b's bfloat16 reduce pass without
     dy_partial with the same seed: the shared tile code), and the crows
     entries in their own mode (each g rounded
     before the pool, dW in batch halves: bit for bit as the fused entry
     block's wrappers with layout "crows", and held to the plain versions);
  4. predict — 48 synthetic 10 s wavs (two batches of 24) and a checkpoint
     of a seeded flagship CRNN written by the port's own writer, through
     `cli.predict(... --device cuda)`: the TSVs parse, every kernel of the
     path was launched and no training kernel was, strong probabilities are finite and agree with the same
     run on `--device cpu` (the plain versions) within 1e-4; clips/s of a
     second, warm CUDA pass, and the device time of a third (torch.profiler). Then the same weights in a checkpoint whose
     stored configuration has `entry_block_pallas=True`: the fused first
     block launches once per batch, block 1 launches no K2 forward, and the
     strong probabilities agree with the default configuration's and with
     that checkpoint's CPU run within 1e-4. Then a checkpoint of a seeded
     CRNN stored with `scaled_config()` (bfloat16, 128 mels, 128 channels,
     pooling (2, 4) (2, 4) (2, 8)): launch counts exact (bfloat16 K3 and K2
     at every block, no float32 K2 or K3, no plain block), strong
     probabilities of the CUDA run within 5e-3 of the CPU run's (largest
     difference and differing event rows printed), clips/s and the device
     time of a warm call; the same for a flagship checkpoint stored with
     bfloat16 compute and `entry_block_pallas=True` (the fused first block
     in bfloat16 once per batch, bfloat16 K3 and K2 at blocks 2 and 3);
  5. train — five Mean-Teacher steps at the flagship `Config()`, batch 24
     laid out [weak 6 | unlabeled 12 | synthetic 6], int16 audio of 24 seeded
     synthetic clips, state from a seeded CPU generator, Adam(1e-3): losses
     finite and falling, every training kernel launched on every step, the
     EMA and both models' BatchNorm buffers as they should be, and no eval
     kernel launched; then steps 1 and 2 again on the CPU (plain versions,
     same state, same generator seed) must give the same loss and metrics
     within 1e-4, and step 1 every gradient leaf within 1e-4 of its max (the
     gauge leaves alone, conv biases ahead of a BatchNorm and the attention
     logits, get a noise floor of 1e-6 of the largest gradient on top, and
     step 2 holds them in function space); ms per step, a torch.profiler
     breakdown of one warm step, and ms per step with the random generator
     on the card. Then the same state and seeds under each first-block
     configuration: `entry_block_pallas` (five steps; launches per step
     counted exactly; step 1 against the default configuration's step 1 and
     against its own CPU step), `entry_block_crows` and `entry_conv_pallas`
     (three steps each, step 1 against the default's), each with ms per step
     with the generator on the card and the device time of block 1 in one
     profiled step beside the default's. Then the scaled configuration with
     SpecAugment: step 1 at a batch of 4 clips [1|2|1] on the card and on
     the CPU from one state and CPU generator (metrics 1e-4; gradient leaves
     2e-2 of their max plus 1e-6 of the largest, gauge leaves 1e-3 of the
     largest: bfloat16 roundings that flip between float32 sums in another
     order), then five steps at the full batch of 24 with the generator on
     the card: launches per step exact, ms per step, a torch.profiler
     breakdown of one warm step with K3's share of its device time, peak
     memory. Then the flagship `Config()`
     in bfloat16 under the default first block and each first-block flag:
     step 1 at [1|2|1] on the card against its own CPU run (the scaled
     bars; under the crows flag block 1's conv weight is held as a gauge
     leaf: its two batch-half sums nearly cancel), three steps at batch 24
     with the generator on the card (launches per step exact, ms per step,
     peak memory, block 1's device time), and the gap of each flag's step-1
     loss to the bfloat16 default printed as information. Then the knobs
     path: the JAX package's three A/B knobs (DCASE_FUSED_MEL_ONEDOT,
     DCASE_FUSED_BWD_RECOMPUTE, DCASE_DROPOUT_PACK) on, as the port's module
     constants (the default paths run with them off): the flagship float32
     step 1 at [1|2|1] on the card against the CPU with the same knobs (the
     float32 bars above), then steps at batch 24 with the generator on the
     card, in turns with the default (default, knobs, knobs, default; three
     steps each): launches per step exact (K1's onedot kernel and no FFT K1,
     K2b's first pass without dy_partial, the recompute fixup and no stored
     one, every dropout launch packed), ms per step, one traced step's
     device time and peak memory beside the default's; two steps each of
     the knobs under `entry_block_pallas`, of the scaled configuration and
     of the flagship in bfloat16, launches exact.
  6. train through the CLI — `train_meanteacher --synthetic_audio -s 96
     --epochs 2` at the flagship `Config()` on the card (77 weak, 96
     unlabeled and 77 synthetic training clips, 8 steps an epoch at
     [6|12|6], validation, checkpoints, SaveBest, the final test on 96
     validation and 96 public-eval clips), then `train_crnn` for one epoch:
     every batch a step receives lies on the card and was copied from
     pinned memory, every kernel of the predict and step paths launched
     and no other, the training kernels exactly their count a step,
     every epoch's losses finite and every record key written; each
     epoch's time, steps a second and queue-wait share printed. The best
     checkpoint through the CheckpointEvaluator on the card and on the CPU:
     strong probabilities of 24 validation clips within 1e-4. Then one
     short epoch of the Experiment (`-s 24`, 2 steps, dropout and noise 0)
     on the card and on the CPU from the same state: the batches bit for
     bit, the scaler moments within 1e-5 of their largest, the epoch's loss
     means and the validation probabilities within 1e-4.
  7. the rest of the user paths, through the CLI on the card —
     (a) `train_meanteacher --synthetic_audio -s 96 --epochs 2
     --device_cache`, phase 6's run with the training set resident on the
     card: the resident MiB, each epoch's loop seconds and steps a second
     (no batch queue), epoch 0's gathered batches bit for bit the streamed
     pipeline's, each epoch's loss means within 1e-4 of phase 6's, the
     training kernels exactly their count a step and no batch copied from
     the host; (b) `evaluate --tune_thresholds --save_thresholds` on its
     best checkpoint (24 validation clips): the three JSON files with the
     ten classes, then `predict --thresholds_json --median_windows_json`
     reads them back and its events are the decode of its probabilities
     under them; (c) `predict --long` and `--long --overlap` with those
     files on wavs of 25, 7 and 10 s: the JAX package's window count, strong
     probabilities within 1e-4 of the CPU run's and the same TSV rows
     (unless a probability within their difference of a threshold flipped,
     which is printed); (d) `precompute` of 48 synthetic 10 s clips laid
     out as a user lays out a set (a TSV under dataset_metadata, its wavs
     where the configuration maps it, both removed after): the .npy files
     within 1e-5 of max of the CPU run's. Each path's launches are exact per
     batch (per step for training) and nothing else launches.
  8. data parallel — (a) phase 6's `train_meanteacher --synthetic_audio -s 96
     --epochs 2` with `--data_parallel` in a child process whose environment
     is torchrun's for one rank (RANK=0, WORLD_SIZE=1, LOCAL_RANK=0, a free
     MASTER_PORT on the loopback): the group's backend is NCCL, each epoch's
     loss means within 1e-4 of phase 6's, the training kernels exactly their
     count a step, every step's collectives 6 BatchNorm-statistics, 3 S1 / S2
     and 1 gradient all-reduce, steps a second beside phase 6's; (b) two ranks
     on the one card over Gloo (NCCL refuses two ranks on one device; the
     backend is named in `multihost.initialize`), children of this script
     (`--child ranks`), each on its shard-major [6|12|6] cut of 48 seeded
     clips, against one process on the card over the 48, one Mean-Teacher step
     from one seeded state at dropout and noise 0, under the default path,
     `entry_block_pallas`, `entry_block_crows` and `entry_conv_pallas` in
     float32 and the default in bf16: metrics within 1e-4, every gradient
     leaf within 1e-4 of its max with phase 5's gauge floor (bf16: phase 5's
     bf16 bars, 2e-2 of its max), both models' BatchNorm buffers within 1e-5,
     the ranks' parameters bit-equal after the step, each rank's launches
     exact (the forward kernels counted in their eval form at dropout 0) and
     its collectives as in (a); (c) `evaluate --data_parallel --threshold
     0.05 --tune_thresholds` on those ranks on (a)'s best checkpoint (24
     validation clips) against one process: results and TSV rows equal.
     Two ranks that share a card show correctness, not scaling.
     `python3 chip_smoke.py --cards N` runs (b) and (c) alone with one NCCL
     rank a card on N cards, against one process on the first, on phase 4's
     seeded flagship checkpoint.
  9. serving — (a) `evaluate --export` at batch 24 on the card of phase 4's
     default and `entry_block_pallas` checkpoints, each artifact loaded in a
     child (`--child serve`) that imports torch and `eval.export` and no
     port models / train / data module, called on 24 seeded int16 clips:
     launches exact (default K1 1, K3f 2, K2f eval 3; B K1 1, K5f 1, K3f 2,
     K2f 2), strong and weak within 1e-6 of max of the evaluator's direct
     path, size, export time and warm ms beside the direct path's; then the
     same weights stored with `entry_conv_pallas` and `entry_block_crows`
     and phase 4's bfloat16 `entry_block_pallas` checkpoint, exported and
     loaded here, held alike; (b) a reference-layout torch.save file of the
     default weights (the reference's names, no attention head) through
     `evaluate` and `predict --torch_checkpoint` on 24 synthetic validation
     clips: strong probabilities bit for bit the port checkpoint's, weak
     within 1e-6 (the heads are both `seeded_init_` seed 0), evaluate's F1s
     equal, launches exact; (c) `tools/profile_step_torch.py --batch 24` in
     a child beside (a)'s children: exit 0, every kernel of the default
     step named with time, its device ms a step beside phase 5's.
 10. study — the semi-supervised study's tools and the graft entry points:
     (a) `graft_entry_torch.entry()` on the card (the flagship forward at
     batch 4, seeded weights): launches exact (K1 1, K3f 2, K2f eval 3),
     strong and weak within 1e-4 of the same forward on the CPU; then
     `dryrun_multichip(2)` on two Gloo ranks sharing the card: a finite
     loss, equal on both; (b) `tools/ablate_ssl_torch.py` on its four arms,
     seed 0, `--subpart 24 --subpart_unlabeled 96 --epochs 3 --eval_every 1
     --nuisance_shift 0.4,0.6`, the training set resident on the card: exit
     0 or 1 (printed: at 3 epochs the F1 check is a verdict, not a
     failure), the JSON holding the four arms, each arm's steps an epoch and
     clip counts those of the same arguments' Experiment built on the CPU,
     every loss mean finite, every default predict and step kernel launched
     (the counts zeroed just before the run, read just after); (c)
     `tools/diag_invariance_torch.py`'s measurement with 2 renders on (b)'s
     mt and mt_nv best checkpoints, on the card and on the CPU: the two
     stds within 1e-4, the flip rate equal unless a probability lies
     within 1e-5 of 0.5 (each such flip printed); (d)
     `tools/twin_epochs_torch.py --epochs 1 --subpart 24` at the flagship on
     the card, both twins there: `ok`.
 11. flat-layout checkpoint — `DCASE_FLAT_OPT=1` at the flagship (float32,
     TF32 off, cuDNN's deterministic algorithms): one Mean-Teacher step at
     batch 24 from one state with the switch unset and set, every metric
     and the student's and teacher's parameters bit for bit; the flat
     checkpoint after it (Adam's moments one 1-D leaf each) restored on the
     card and on the CPU, then three more steps at a batch of 4 on both,
     each step's metrics within TRAIN_TOL; that checkpoint restored into a
     fresh state on the card and one step taken from both bit for bit; a
     plain-Adam v1 pickle refused without the opt-in and restored behind
     it leaf for leaf; the launches of the Adam and EMA tail from the
     profiler.

Phase 3 also holds the knobs' kernels at the flagship shapes (`knob_kernels`:
K1 onedot against its plain version and a float64 DFT, 1e-5 of max, twice
bit for bit, with one cuBLAS SGEMM of the same product as its library time; K2f, K2b's first pass
and the recompute fixup with the packed draw, and the autograd Function with
the fixup mode on against itself with it off, dy 1e-6 of max; K5f and K5b1
with the packed draw; the packed keep-mask kernel bit for bit with its keep
share within 5 sigma of 1 - t8/256), the bfloat16 recompute fixup at the
scaled and the C = 64 shapes, and the bfloat16 fixup at C = 64 with its
inputs rotated through more than twice the 50 MB L2 (`cold_fixup_device_ms`).
Phase 4 also predicts from the default checkpoint with K1's onedot knob on
(launches exact, within 1e-4 of its own CPU run and of the FFT K1's).

The line before the last is {"kernels": [...], "helpers": [...],
"parallel": {...}, "serving": {...}, "study": {...}}: every number in it is one this run measured (launches on
both paths as counted, the largest error beside the limit it was held to, the
bound per shape with what binds it; phase 8's collectives a step);
the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports only the port: neither jax, nor pandas, nor the JAX package.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple, Optional

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
N_CLIPS = 48
STRONG_TOL = 1e-4
TRAIN_STEPS = 5
TRAIN_TOL = 1e-4
GRAD_FLOOR = 1e-6  # float32 noise floor of a gauge leaf's gradient, as a share of the step's largest gradient
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FP32_FLOPS = 67e12     # float32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12    # bfloat16 products on the tensor cores (dense)
SCALED_STRONG_TOL = 5e-3    # bfloat16 model, card against CPU
EPS32 = 2.0 ** -24          # float32 unit roundoff
FLIP_SHARE = 1e-3           # share of a bfloat16 output's elements that may lie beyond one ulp
SCALED_GRAD_TOL, SCALED_GRAD_FLOOR, SCALED_GAUGE_FLOOR = 2e-2, 1e-6, 1e-3
CSRC = "dcase2019_task4_tpu_torch/csrc/"
JAX_OPS = "dcase2019_task4_tpu/ops/"

# name -> (source, TPU kernel it replaces); every row of the kernels line
KERNELS = {
    "fused_stft_mel": (CSRC + "fused_mel.cu", JAX_OPS + "fused_mel.py:174"),
    "conv2d_forward": (CSRC + "packed_conv.cu", JAX_OPS + "packed_conv.py:122"),
    "conv2d_dx": (CSRC + "packed_conv.cu", JAX_OPS + "packed_conv.py:276"),
    "conv2d_wgrad": (CSRC + "packed_conv.cu", JAX_OPS + "packed_conv.py:147"),
    "fused_bn_glu_pool_eval": (CSRC + "fused_block.cu", JAX_OPS + "fused_block.py:243"),
    "fused_bn_glu_pool_train": (CSRC + "fused_block.cu", JAX_OPS + "fused_block.py:243"),
    "batch_stats": (CSRC + "fused_block.cu", JAX_OPS + "fused_block.py:591"),
    "bwd_reduce": (CSRC + "fused_block.cu", JAX_OPS + "fused_block.py:289"),
    "bwd_fixup": (CSRC + "fused_block.cu", JAX_OPS + "fused_block.py:332"),
    "entry_conv": (CSRC + "entry_block.cu", JAX_OPS + "entry_conv.py:181"),
    "entry_conv_wgrad": (CSRC + "entry_block.cu", JAX_OPS + "entry_conv.py:214"),
    "entry_block_stats": (CSRC + "entry_block.cu", JAX_OPS + "fused_entry_block.py:255"),
    "entry_block_fwd_eval": (CSRC + "entry_block.cu", JAX_OPS + "fused_entry_block.py:283"),
    "entry_block_fwd_train": (CSRC + "entry_block.cu", JAX_OPS + "fused_entry_block.py:283"),
    "entry_block_bwd_reduce": (CSRC + "entry_block.cu", JAX_OPS + "fused_entry_block.py:325"),
    "entry_block_bwd_wgrad": (CSRC + "entry_block.cu", JAX_OPS + "fused_entry_block.py:361"),
    # the same four functions in the JAX package's other TPU layout: the same
    # kernels, counted where a call came through ops/crows_block.py
    "crows_stats": (CSRC + "entry_block.cu", JAX_OPS + "crows_block.py:375"),
    "crows_fwd": (CSRC + "entry_block.cu", JAX_OPS + "crows_block.py:404"),
    "crows_bwd_reduce": (CSRC + "entry_block.cu", JAX_OPS + "crows_block.py:442"),
    "crows_bwd_wgrad": (CSRC + "entry_block.cu", JAX_OPS + "crows_block.py:479"),
    # the bfloat16 modes the scaled configuration runs: the same kernels
    # instantiated for bfloat16 activations, counted apart
    "conv2d_forward_bf16": (CSRC + "packed_conv.cu", JAX_OPS + "packed_conv.py:122"),
    "conv2d_dx_bf16": (CSRC + "packed_conv.cu", JAX_OPS + "packed_conv.py:276"),
    "conv2d_wgrad_bf16": (CSRC + "packed_conv.cu", JAX_OPS + "packed_conv.py:147"),
    "fused_bn_glu_pool_eval_bf16": (CSRC + "fused_block.cu", JAX_OPS + "fused_block.py:243"),
    "fused_bn_glu_pool_train_bf16": (CSRC + "fused_block.cu", JAX_OPS + "fused_block.py:243"),
    "batch_stats_bf16": (CSRC + "fused_block.cu", JAX_OPS + "fused_block.py:591"),
    "bwd_reduce_bf16": (CSRC + "fused_block.cu", JAX_OPS + "fused_block.py:289"),
    "bwd_fixup_bf16": (CSRC + "fused_block.cu", JAX_OPS + "fused_block.py:332"),
    # the same bfloat16 kernels at the flagship's shapes (64 channels; K3's
    # weight gradient rounded per output-frequency class, k = 2)
    "conv2d_forward_bf16_flagship": (CSRC + "packed_conv.cu", JAX_OPS + "packed_conv.py:122"),
    "conv2d_dx_bf16_flagship": (CSRC + "packed_conv.cu", JAX_OPS + "packed_conv.py:276"),
    "conv2d_wgrad_bf16_flagship": (CSRC + "packed_conv.cu", JAX_OPS + "packed_conv.py:147"),
    "fused_bn_glu_pool_eval_bf16_flagship": (CSRC + "fused_block.cu", JAX_OPS + "fused_block.py:243"),
    "fused_bn_glu_pool_train_bf16_flagship": (CSRC + "fused_block.cu", JAX_OPS + "fused_block.py:243"),
    "batch_stats_bf16_flagship": (CSRC + "fused_block.cu", JAX_OPS + "fused_block.py:591"),
    "bwd_reduce_bf16_flagship": (CSRC + "fused_block.cu", JAX_OPS + "fused_block.py:289"),
    "bwd_fixup_bf16_flagship": (CSRC + "fused_block.cu", JAX_OPS + "fused_block.py:332"),
    # the bfloat16 modes of the entry-block family, run by the flagship
    # bfloat16 model under the first-block flags
    "entry_conv_bf16": (CSRC + "entry_block.cu", JAX_OPS + "entry_conv.py:181"),
    "entry_conv_wgrad_bf16": (CSRC + "entry_block.cu", JAX_OPS + "entry_conv.py:214"),
    "entry_block_stats_bf16": (CSRC + "entry_block.cu", JAX_OPS + "fused_entry_block.py:255"),
    "entry_block_fwd_eval_bf16": (CSRC + "entry_block.cu", JAX_OPS + "fused_entry_block.py:283"),
    "entry_block_fwd_train_bf16": (CSRC + "entry_block.cu", JAX_OPS + "fused_entry_block.py:283"),
    "entry_block_bwd_reduce_bf16": (CSRC + "entry_block.cu", JAX_OPS + "fused_entry_block.py:325"),
    "entry_block_bwd_wgrad_bf16": (CSRC + "entry_block.cu", JAX_OPS + "fused_entry_block.py:361"),
    "crows_stats_bf16": (CSRC + "entry_block.cu", JAX_OPS + "crows_block.py:375"),
    "crows_fwd_bf16": (CSRC + "entry_block.cu", JAX_OPS + "crows_block.py:404"),
    "crows_bwd_reduce_bf16": (CSRC + "entry_block.cu", JAX_OPS + "crows_block.py:442"),
    "crows_bwd_wgrad_bf16": (CSRC + "entry_block.cu", JAX_OPS + "crows_block.py:479"),
    # the JAX package's three A/B knobs (DCASE_FUSED_MEL_ONEDOT,
    # DCASE_FUSED_BWD_RECOMPUTE, DCASE_DROPOUT_PACK): K1 through the cos‖sin
    # basis; K2b's first pass without dy_partial and the recompute fixup; the
    # packed draw in K2f and in K5's forward and first backward pass
    "fused_stft_mel_onedot": (CSRC + "fused_mel_onedot.cu", JAX_OPS + "fused_mel.py:213"),
    "bwd_reduce_nodyp": (CSRC + "fused_block.cu", JAX_OPS + "fused_block.py:289"),
    "bwd_fixup_recompute": (CSRC + "fused_block.cu", JAX_OPS + "fused_block.py:341"),
    "fused_bn_glu_pool_train_packed": (CSRC + "fused_block.cu", JAX_OPS + "fused_block.py:169"),
    "entry_block_fwd_train_packed": (CSRC + "entry_block.cu", JAX_OPS + "fused_block.py:169"),
    "entry_block_bwd_reduce_packed": (CSRC + "entry_block.cu", JAX_OPS + "fused_block.py:169"),
    "bwd_fixup_recompute_bf16": (CSRC + "fused_block.cu", JAX_OPS + "fused_block.py:341"),
    "bwd_fixup_recompute_bf16_flagship": (CSRC + "fused_block.cu", JAX_OPS + "fused_block.py:341"),
}
SCALED_ROWS = ("conv2d_forward_bf16", "conv2d_dx_bf16", "conv2d_wgrad_bf16", "fused_bn_glu_pool_eval_bf16",
               "fused_bn_glu_pool_train_bf16", "batch_stats_bf16", "bwd_reduce_bf16", "bwd_fixup_bf16")
# a flagship row counts its kernel's launches on the counter of the scaled row
ALIASES = {name + "_flagship": name for name in SCALED_ROWS + ("bwd_fixup_recompute_bf16",)}
# a crows row names the kernel it launches; phase 3 calls the crows entries
# themselves and holds them bit for bit to that kernel's own wrapper
SAME_KERNEL = {"crows_stats": "entry_block_stats", "crows_fwd": "entry_block_fwd_train",
               "crows_bwd_reduce": "entry_block_bwd_reduce", "crows_bwd_wgrad": "entry_block_bwd_wgrad",
               "crows_bwd_reduce_bf16": "entry_block_bwd_reduce_bf16"}
# the CUDA kernel of a row of the conv alone (in csrc/entry_block.cu)
KERNEL_NAMES = {"entry_conv": "entry_conv_kernel<0>", "entry_block_stats": "entry_conv_run_kernel<float, false>",
                "crows_stats": "entry_conv_run_kernel<float, false>",
                "entry_conv_bf16": "entry_conv_run_kernel<bf16, true>",
                "entry_block_stats_bf16": "entry_conv_run_kernel<bf16, false>",
                "crows_stats_bf16": "entry_conv_run_kernel<bf16, false>", "batch_stats": "stats_kernel<float>",
                "batch_stats_bf16": "stats_bf16_kernel", "batch_stats_bf16_flagship": "stats_bf16_kernel",
                "entry_conv_wgrad": "entry_conv_dw_f32_kernel",
                "entry_conv_wgrad_bf16": "entry_conv_dw_bf16_kernel<64>"}
# Launches each path makes: exactly these on predict (two batches) and on one
# MT step (teacher forward, student forward and backward), and none of a
# kernel the path has no entry for.
PREDICT_MIN = {"fused_stft_mel": 2, "conv2d_forward": 4, "fused_bn_glu_pool_eval": 6}
STEP_MIN = {"fused_stft_mel": 1, "conv2d_forward": 4, "conv2d_dx": 2, "conv2d_wgrad": 2,
            "fused_bn_glu_pool_train": 6, "batch_stats": 6, "bwd_reduce": 3, "bwd_fixup": 3}
# the fused first block takes block 1 off K2 and cuDNN
PREDICT_ENTRY_BLOCK = {"fused_stft_mel": 2, "conv2d_forward": 4, "fused_bn_glu_pool_eval": 4,
                       "entry_block_fwd_eval": 2}
STEP_ENTRY_BLOCK = {"fused_stft_mel": 1, "conv2d_forward": 4, "conv2d_dx": 2, "conv2d_wgrad": 2,
                    "fused_bn_glu_pool_train": 4, "batch_stats": 4, "bwd_reduce": 2, "bwd_fixup": 2,
                    "entry_block_stats": 2, "entry_block_fwd_train": 2, "entry_block_bwd_reduce": 1,
                    "entry_block_bwd_wgrad": 1}
STEP_CROWS = dict(STEP_ENTRY_BLOCK, crows_stats=2, crows_fwd=2, crows_bwd_reduce=1, crows_bwd_wgrad=1)
# K4f hands its sums to the fused block: no K2s launch for block 1
STEP_ENTRY_CONV = dict(STEP_MIN, batch_stats=4, entry_conv=2, entry_conv_wgrad=1)
# the scaled configuration: the bfloat16 kernels at every block, no float32 one
PREDICT_SCALED = {"fused_stft_mel": 2, "conv2d_forward_bf16": 4, "fused_bn_glu_pool_eval_bf16": 6}
STEP_SCALED = {"fused_stft_mel": 1, "conv2d_forward_bf16": 4, "conv2d_dx_bf16": 2, "conv2d_wgrad_bf16": 2,
               "fused_bn_glu_pool_train_bf16": 6, "batch_stats_bf16": 6, "bwd_reduce_bf16": 3, "bwd_fixup_bf16": 3}
# the flagship in bfloat16: the default first block (cuDNN's bfloat16 conv),
# then each flag in bfloat16
PREDICT_BF16_ENTRY_BLOCK = {"fused_stft_mel": 2, "conv2d_forward_bf16": 4, "fused_bn_glu_pool_eval_bf16": 4,
                            "entry_block_fwd_eval_bf16": 2}
STEP_BF16 = dict(STEP_SCALED)
# the flagship rows are counted on these paths, under their scaled rows' counters
STEP_BF16.update({alias: STEP_BF16[name] for alias, name in ALIASES.items() if name in STEP_BF16})
PREDICT_BF16_ENTRY_BLOCK["fused_bn_glu_pool_eval_bf16_flagship"] = PREDICT_BF16_ENTRY_BLOCK["fused_bn_glu_pool_eval_bf16"]
STEP_BF16_ENTRY_BLOCK = {"fused_stft_mel": 1, "conv2d_forward_bf16": 4, "conv2d_dx_bf16": 2, "conv2d_wgrad_bf16": 2,
                         "fused_bn_glu_pool_train_bf16": 4, "batch_stats_bf16": 4, "bwd_reduce_bf16": 2,
                         "bwd_fixup_bf16": 2, "entry_block_stats_bf16": 2, "entry_block_fwd_train_bf16": 2,
                         "entry_block_bwd_reduce_bf16": 1, "entry_block_bwd_wgrad_bf16": 1}
STEP_BF16_CROWS = dict(STEP_BF16_ENTRY_BLOCK, crows_stats_bf16=2, crows_fwd_bf16=2, crows_bwd_reduce_bf16=1,
                       crows_bwd_wgrad_bf16=1)
STEP_BF16_ENTRY_CONV = dict(STEP_BF16, batch_stats_bf16=4, entry_conv_bf16=2, entry_conv_wgrad_bf16=1)
# the three knobs on: K1 onedot; K2b's first pass without dy_partial, the
# recompute fixup and no stored one; every dropout launch packed (the
# `*_packed` counters equal the dropping kernels' own)
PREDICT_ONEDOT = {"fused_stft_mel_onedot": 2, "conv2d_forward": 4, "fused_bn_glu_pool_eval": 6}
STEP_KNOBS = {"fused_stft_mel_onedot": 1, "conv2d_forward": 4, "conv2d_dx": 2, "conv2d_wgrad": 2,
              "fused_bn_glu_pool_train": 6, "fused_bn_glu_pool_train_packed": 6, "batch_stats": 6,
              "bwd_reduce_nodyp": 3, "bwd_fixup_recompute": 3}
STEP_KNOBS_ENTRY_BLOCK = {"fused_stft_mel_onedot": 1, "conv2d_forward": 4, "conv2d_dx": 2, "conv2d_wgrad": 2,
                          "fused_bn_glu_pool_train": 4, "fused_bn_glu_pool_train_packed": 4, "batch_stats": 4,
                          "bwd_reduce_nodyp": 2, "bwd_fixup_recompute": 2, "entry_block_stats": 2,
                          "entry_block_fwd_train": 2, "entry_block_fwd_train_packed": 2, "entry_block_bwd_reduce": 1,
                          "entry_block_bwd_reduce_packed": 1, "entry_block_bwd_wgrad": 1}
STEP_KNOBS_SCALED = {"fused_stft_mel_onedot": 1, "conv2d_forward_bf16": 4, "conv2d_dx_bf16": 2,
                     "conv2d_wgrad_bf16": 2, "fused_bn_glu_pool_train_bf16": 6, "fused_bn_glu_pool_train_packed": 6,
                     "batch_stats_bf16": 6, "bwd_fixup_recompute_bf16": 3}
STEP_KNOBS_BF16 = dict(STEP_KNOBS_SCALED, bwd_fixup_recompute_bf16_flagship=3)
# Counters of a mode that no row of the kernels line reads: on a knobs path
# every first backward pass stores no dy_partial and every dropout launch is
# packed; every other path must count none of them.
MODES = {"step_knobs": {"bwd_reduce_packed": 3, "bwd_fixup_recompute_packed": 3},
         "step_knobs_entry_block": {"bwd_reduce_packed": 2, "bwd_fixup_recompute_packed": 2,
                                    "entry_block_bwd_wgrad_packed": 1},
         "step_knobs_scaled": {"bwd_reduce_nodyp_bf16": 3, "bwd_reduce_packed": 3, "bwd_fixup_recompute_packed": 3}}
MODES["step_knobs_bf16"] = MODES["step_knobs_scaled"]
PATHS = {"predict": PREDICT_MIN, "predict_entry_block": PREDICT_ENTRY_BLOCK, "step": STEP_MIN,
         "step_entry_block": STEP_ENTRY_BLOCK, "step_crows": STEP_CROWS, "step_entry_conv": STEP_ENTRY_CONV,
         "predict_scaled": PREDICT_SCALED, "step_scaled": STEP_SCALED,
         "predict_bf16_entry_block": PREDICT_BF16_ENTRY_BLOCK, "step_bf16": STEP_BF16,
         "step_bf16_entry_block": STEP_BF16_ENTRY_BLOCK, "step_bf16_crows": STEP_BF16_CROWS,
         "step_bf16_entry_conv": STEP_BF16_ENTRY_CONV, "predict_onedot": PREDICT_ONEDOT, "step_knobs": STEP_KNOBS,
         "step_knobs_entry_block": STEP_KNOBS_ENTRY_BLOCK, "step_knobs_scaled": STEP_KNOBS_SCALED,
         "step_knobs_bf16": STEP_KNOBS_BF16}
# the path whose run gives a row its `launches`
ROW_PATH = {name: "predict" if name in PREDICT_MIN else "step" for name in list(PREDICT_MIN) + list(STEP_MIN)}
ROW_PATH.update({"entry_block_fwd_eval": "predict_entry_block", "entry_conv": "step_entry_conv",
                 "entry_conv_wgrad": "step_entry_conv", "entry_block_stats": "step_entry_block",
                 "entry_block_fwd_train": "step_entry_block", "entry_block_bwd_reduce": "step_entry_block",
                 "entry_block_bwd_wgrad": "step_entry_block", "crows_stats": "step_crows", "crows_fwd": "step_crows",
                 "crows_bwd_reduce": "step_crows", "crows_bwd_wgrad": "step_crows"})
ROW_PATH.update({name: "predict_scaled" if name in PREDICT_SCALED else "step_scaled" for name in SCALED_ROWS})
ROW_PATH.update({alias: "predict_bf16_entry_block" if name in PREDICT_BF16_ENTRY_BLOCK else "step_bf16"
                 for alias, name in ALIASES.items()})
ROW_PATH.update({"entry_block_fwd_eval_bf16": "predict_bf16_entry_block", "entry_conv_bf16": "step_bf16_entry_conv",
                 "entry_conv_wgrad_bf16": "step_bf16_entry_conv", "entry_block_stats_bf16": "step_bf16_entry_block",
                 "entry_block_fwd_train_bf16": "step_bf16_entry_block",
                 "entry_block_bwd_reduce_bf16": "step_bf16_entry_block",
                 "entry_block_bwd_wgrad_bf16": "step_bf16_entry_block", "crows_stats_bf16": "step_bf16_crows",
                 "crows_fwd_bf16": "step_bf16_crows", "crows_bwd_reduce_bf16": "step_bf16_crows",
                 "crows_bwd_wgrad_bf16": "step_bf16_crows"})
ROW_PATH.update({"fused_stft_mel_onedot": "predict_onedot", "bwd_reduce_nodyp": "step_knobs",
                 "bwd_fixup_recompute": "step_knobs", "fused_bn_glu_pool_train_packed": "step_knobs",
                 "entry_block_fwd_train_packed": "step_knobs_entry_block",
                 "entry_block_bwd_reduce_packed": "step_knobs_entry_block",
                 "bwd_fixup_recompute_bf16": "step_knobs_scaled", "bwd_fixup_recompute_bf16_flagship": "step_knobs_bf16"})
FIRST_BLOCK_FLAGS = {"step_entry_block": "entry_block_pallas", "step_crows": "entry_block_crows",
                     "step_entry_conv": "entry_conv_pallas", "step_bf16_entry_block": "entry_block_pallas",
                     "step_bf16_crows": "entry_block_crows", "step_bf16_entry_conv": "entry_conv_pallas"}


def wrappers():
    """name -> (wrapper, the attribute of it that counts that kernel's launches)."""
    from dcase2019_task4_tpu_torch.ops import (crows_block, entry_conv, fused_block, fused_entry_block, fused_mel,
                                               packed_conv)

    counters = {
        "fused_stft_mel": (fused_mel.fused_stft_mel, "launches"),
        "conv2d_forward": (packed_conv.conv2d_forward, "launches"),
        "conv2d_dx": (packed_conv.conv2d_dx, "launches"),
        "conv2d_wgrad": (packed_conv.conv2d_wgrad, "launches"),
        "fused_bn_glu_pool_eval": (fused_block.fused_bn_glu_pool, "launches_eval"),
        "fused_bn_glu_pool_train": (fused_block.fused_bn_glu_pool, "launches_train"),
        "batch_stats": (fused_block.batch_stats, "launches"),
        "bwd_reduce": (fused_block.bwd_reduce, "launches"),
        "bwd_fixup": (fused_block.bwd_fixup, "launches"),
        "entry_conv": (entry_conv.entry_conv_forward, "launches"),
        "entry_conv_wgrad": (entry_conv.entry_conv_wgrad, "launches"),
        "entry_block_stats": (fused_entry_block.entry_block_stats_apply, "launches"),
        "entry_block_fwd_eval": (fused_entry_block.entry_block_fwd, "launches_eval"),
        "entry_block_fwd_train": (fused_entry_block.entry_block_fwd, "launches_train"),
        "entry_block_bwd_reduce": (fused_entry_block.entry_block_bwd_reduce, "launches"),
        "entry_block_bwd_wgrad": (fused_entry_block.entry_block_bwd_wgrad, "launches"),
        "crows_stats": (crows_block.crows_stats_apply, "launches"),
        "crows_fwd": (crows_block.crows_apply, "launches_train"),
        "crows_bwd_reduce": (crows_block.crows_apply, "launches_bwd_reduce"),
        "crows_bwd_wgrad": (crows_block.crows_apply, "launches_bwd_wgrad"),
        "conv2d_forward_bf16": (packed_conv.conv2d_forward, "launches_bf16"),
        "conv2d_dx_bf16": (packed_conv.conv2d_dx, "launches_bf16"),
        "conv2d_wgrad_bf16": (packed_conv.conv2d_wgrad, "launches_bf16"),
        "fused_bn_glu_pool_eval_bf16": (fused_block.fused_bn_glu_pool, "launches_eval_bf16"),
        "fused_bn_glu_pool_train_bf16": (fused_block.fused_bn_glu_pool, "launches_train_bf16"),
        "batch_stats_bf16": (fused_block.batch_stats, "launches_bf16"),
        "bwd_reduce_bf16": (fused_block.bwd_reduce, "launches_bf16"),
        "bwd_fixup_bf16": (fused_block.bwd_fixup, "launches_bf16"),
        "entry_conv_bf16": (entry_conv.entry_conv_forward, "launches_bf16"),
        "entry_conv_wgrad_bf16": (entry_conv.entry_conv_wgrad, "launches_bf16"),
        "entry_block_stats_bf16": (fused_entry_block.entry_block_stats_apply, "launches_bf16"),
        "entry_block_fwd_eval_bf16": (fused_entry_block.entry_block_fwd, "launches_eval_bf16"),
        "entry_block_fwd_train_bf16": (fused_entry_block.entry_block_fwd, "launches_train_bf16"),
        "entry_block_bwd_reduce_bf16": (fused_entry_block.entry_block_bwd_reduce, "launches_bf16"),
        "entry_block_bwd_wgrad_bf16": (fused_entry_block.entry_block_bwd_wgrad, "launches_bf16"),
        "crows_stats_bf16": (crows_block.crows_stats_apply, "launches_bf16"),
        "crows_fwd_bf16": (crows_block.crows_apply, "launches_train_bf16"),
        "crows_bwd_reduce_bf16": (crows_block.crows_apply, "launches_bwd_reduce_bf16"),
        "crows_bwd_wgrad_bf16": (crows_block.crows_apply, "launches_bwd_wgrad_bf16"),
        # the knobs' kernels and modes
        "fused_stft_mel_onedot": (fused_mel.fused_stft_mel_onedot, "launches"),
        "bwd_reduce_nodyp": (fused_block.bwd_reduce, "launches_nodyp"),
        "bwd_fixup_recompute": (fused_block.bwd_fixup_recompute, "launches"),
        "bwd_fixup_recompute_bf16": (fused_block.bwd_fixup_recompute, "launches_bf16"),
        "fused_bn_glu_pool_train_packed": (fused_block.fused_bn_glu_pool, "launches_packed"),
        "entry_block_fwd_train_packed": (fused_entry_block.entry_block_fwd, "launches_packed"),
        "entry_block_bwd_reduce_packed": (fused_entry_block.entry_block_bwd_reduce, "launches_packed"),
    }
    counters.update({alias: counters[name] for alias, name in ALIASES.items()})  # a flagship row: its scaled row's counter
    return counters


def mode_counters():
    """name -> (wrapper, attribute) of the counters in MODES."""
    from dcase2019_task4_tpu_torch.ops import fused_block, fused_entry_block

    return {"bwd_reduce_nodyp_bf16": (fused_block.bwd_reduce, "launches_nodyp_bf16"),
            "bwd_reduce_packed": (fused_block.bwd_reduce, "launches_packed"),
            "bwd_fixup_recompute_packed": (fused_block.bwd_fixup_recompute, "launches_packed"),
            "entry_block_bwd_wgrad_packed": (fused_entry_block.entry_block_bwd_wgrad, "launches_packed")}


def zero_launches():
    for fn, counter in (*wrappers().values(), *mode_counters().values()):
        setattr(fn, counter, 0)


def read_launches():
    """Launches of every kernel, and the mode counters, since `zero_launches`."""
    return {name: getattr(fn, counter) for name, (fn, counter) in {**wrappers(), **mode_counters()}.items()}


def expected(path: str):
    """What one run of `path` launches: its kernels and its mode counters."""
    return {**PATHS[path], **MODES.get(path, {})}


def check_launches(launches, per_run, times: int, path: str):
    """Every kernel of the path launched exactly `times` × its count, and
    every kernel that is not of the path launched no time."""
    for name, count in launches.items():
        if name in ALIASES:
            continue  # counted under its scaled row's name
        if name in per_run and count != times * per_run[name]:
            raise AssertionError(f"{name} launched {count} times on {path} (expected {times * per_run[name]})")
        if name not in per_run and count != 0:
            raise AssertionError(f"{name} launched {count} times on {path}, which has no use for it")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, warmup: int = 3, runs: int = 10) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def event_us(e) -> float:
    """Device time of one profiler event, in microseconds."""
    for attr in ("self_device_time_total", "device_time_total", "cuda_time_total"):
        v = getattr(e, attr, None)
        if v:
            return float(v)
    return float(e.time_range.elapsed_us())


def shown(ms, digits: int = 4) -> str:
    """A profiler reading for a printed line; None is one that was not taken."""
    return "not measured" if ms is None else f"{ms:.{digits}f}"


PROFILER = {"lost": False}  # set once every try of one reading came back without its device events


def profiled(fn, with_host: bool = False, complete=None, tries: int = 3, retry: bool = False):
    """`fn()` under torch.profiler → the profile, or None. A trace can come
    back without some or all of its device events (seen on an H100 in three
    of nine runs of this script: empty traces, and traces that held a third
    of their kernels). One that holds no device event, or that
    `complete(prof)` rejects, is taken again, `tries` times in all. When all
    of them fail the reading is given up as None ("not measured" in the
    lines that print it) and later readings get one try each (all `tries`
    with `retry`): the profiler only adds readings beside the CUDA-event
    times, and no check of a kernel or a path rests on it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if with_host else [])
    tries = 1 if PROFILER["lost"] and not retry else tries
    for attempt in range(tries):
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            fn()
            torch.cuda.synchronize()
        on_device = [e for e in prof.events() if e.device_type == DeviceType.CUDA and event_us(e) > 0]
        if on_device and (complete is None or complete(prof)):
            return prof
        first = min(on_device, key=lambda e: e.time_range.start).name[:40] if on_device else ""
        print(f"  torch.profiler lost device events (attempt {attempt + 1} of {tries}: {len(on_device)} device events"
              f"{', not every kernel (' + complete.__name__ + '), the first ' + first if on_device else ''})")
    PROFILER["lost"] = True
    print("  torch.profiler recorded no device time, or not every kernel: this reading is not measured")
    return None


def device_ms(fn, runs: int = 5, only: Optional[str] = None) -> Optional[float]:
    """What the card itself spends on one call of `fn`: torch.profiler's sum
    over every kernel and copy the call puts on the device (those whose name
    holds `only`, where given), median over `runs` traces of one call each.
    A trace can come back without some of its kernels (seen on an H100: the
    main kernel of a call lost, its fold kept), so only the traces that hold
    every kernel any of the traces holds, as often, are counted; and each
    trace opens with a short spin kernel, not counted, so that a kernel the
    tracer drops at the start of a trace is not one of the call's. Unlike
    `time_ms` it leaves out the gaps in which the device waits for the
    wrapper's host-side work (argument checks, allocations, the copy of the
    seed), which move with the host's load from call to call. None when the
    profiler gave no usable trace."""
    from collections import Counter

    import torch
    from torch.autograd import DeviceType

    def spin_then_call():
        torch.cuda._sleep(20000)
        fn()

    fn()
    traces = []
    for _ in range(runs):
        prof = profiled(spin_then_call)
        if prof is None:
            return None
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.name
                  and (only is None or only in e.name)]
        traces.append((Counter(e.name for e in events), sum(event_us(e) for e in events)))
    every = Counter()
    for names, _ in traces:
        every |= names
    complete = [total for names, total in traces if names == every]
    if not complete:
        print(f"  torch.profiler: none of {runs} traces held every kernel of the call; not measured")
        return None
    return float(np.median(complete)) / 1e3


def bound_ms(n_bytes: float, n_ops: float, n_ops_bf16: float = 0.0):
    """The least time the card could take: each input read once and each
    output written once at the HBM rate, or the operations at the peak rate
    of their type (float32 outside the tensor cores; products of bfloat16
    operands on the tensor cores)."""
    by_bytes = 1e3 * n_bytes / PEAK_BYTES_PER_S
    by_ops = 1e3 * n_ops / PEAK_FP32_FLOPS + 1e3 * n_ops_bf16 / PEAK_BF16_FLOPS
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


class Result(NamedTuple):
    """One comparison: the largest error with the limit it was held to, and
    the median times."""
    err: float
    limit: float
    ms: float
    plain_ms: float
    library_ms: Optional[float]
    device_ms: Optional[float] = 0.0
    library_device_ms: Optional[float] = None


class Row:
    """One row of the kernels line, summed over the shapes it was run at."""

    def __init__(self):
        self.err, self.limit, self.ms, self.plain_ms, self.library_ms = 0.0, 0.0, 0.0, 0.0, None
        # the kernels' own time on the card (profiler), without the wrapper's host gaps; None once a shape's is missing
        self.device_ms = 0.0
        self.library_device_ms = None  # the same reading of the library call
        self.shapes = []  # per shape: what binds it and its bound

    def note_err(self, res: Result):
        if res.err >= self.err:
            self.err, self.limit = res.err, res.limit

    def add(self, shape, res: Result, n_bytes, n_ops, n_ops_bf16=0.0):
        b, by = bound_ms(n_bytes, n_ops, n_ops_bf16)
        self.note_err(res)
        self.ms, self.plain_ms = self.ms + res.ms, self.plain_ms + res.plain_ms
        on_device = res.device_ms
        if on_device is not None and on_device < b:
            # below the least time the card could take: the traces lost the main
            # kernel (seen on an H100: every trace of a call held its fold alone)
            print(f"  {list(shape)}: device reading {on_device:.4f} ms is below the bound {b:.4f} ms; not measured")
            on_device = None
        self.device_ms = None if self.device_ms is None or on_device is None else self.device_ms + on_device
        self.shapes.append({"shape": list(shape), "bound_by": by, "bound_ms": b})
        if res.library_ms is not None:
            first = self.library_ms is None
            self.library_ms = (self.library_ms or 0.0) + res.library_ms
            if first:
                self.library_device_ms = res.library_device_ms
            elif self.library_device_ms is not None and res.library_device_ms is not None:
                self.library_device_ms += res.library_device_ms
            else:
                self.library_device_ms = None

    @property
    def bound(self) -> float:
        return sum(s["bound_ms"] for s in self.shapes)

    @property
    def bound_by(self) -> str:
        """The limit that makes up the larger part of the summed bound."""
        by_ops = sum(s["bound_ms"] for s in self.shapes if s["bound_by"] == "operations")
        return "operations" if by_ops > self.bound - by_ops else "bytes"


def compare(name, kernel_fn, plain_fn, atol=None, rtol_of_max=None, library_fn=None, repeat=False,
            tols=None, exact_fn=None, device_only=None) -> Result:
    """Run kernel and plain version once, check every output's error, then
    time both (and the library call). Functions return a tensor or a tuple.
    With `repeat` the kernel runs again and must give the same bits. `tols`:
    one ("abs", v) or ("max", v) per output where they differ, else `atol` or
    `rtol_of_max` holds every output. `exact_fn`: a float64 run of the plain
    version to hold the outputs to instead (`plain_fn` is still what is
    timed); it returns (outputs, floor per output), the floor added to that
    output's limit. `device_only`: the kernel's device time counts only the
    kernels whose name holds it (a call that also copies its input).
    ("ulp", slack): a bfloat16 output, held element by
    element to one bfloat16 ulp of the larger of the two values plus `slack`
    (a number or a tensor of the output's shape: what one operand rounding
    the other way and the float32 rounding of the sums may add), with at
    most FLIP_SHARE of the elements beyond the one ulp alone; its limit is
    reported as the largest of the element limits. ("parts", slack): the
    same element rule with no share asked, for a weight gradient summed from
    parts that are each rounded to bfloat16 (few elements, and where the
    parts nearly cancel a flipped rounding of a part exceeds the element's
    own ulp)."""
    import torch

    def as_list(out):
        return [out] if isinstance(out, torch.Tensor) else list(out)

    outs = as_list(kernel_fn())
    if exact_fn is not None:
        refs, floors = exact_fn()
        refs = as_list(refs)
    else:
        refs = as_list(plain_fn())
        floors = [0.0] * len(refs)
    torch.cuda.synchronize()
    if tols is None:
        tols = [("abs", atol) if atol is not None else ("max", rtol_of_max)] * len(refs)
    if not len(outs) == len(refs) == len(tols):
        raise AssertionError(f"{name}: {len(outs)} outputs, {len(refs)} references, {len(tols)} tolerances")
    worst, worst_limit, report = 0.0, 0.0, []
    for out, ref, (kind, tol), floor in zip(outs, refs, tols, floors):
        if out.shape != ref.shape:
            raise AssertionError(f"{name}: shape {tuple(out.shape)} != plain {tuple(ref.shape)}")
        if not torch.isfinite(out).all():
            raise AssertionError(f"{name}: non-finite output")
        if kind in ("ulp", "parts"):
            o, r = out.float(), ref.float()
            diff = (o - r).abs()
            ulp = bf16_ulp(torch.maximum(o.abs(), r.abs()))
            beyond = int((diff > ulp).sum().item())
            lim = ulp + tol
            bad = int((diff > lim).sum().item())
            err, limit = diff.max().item(), lim.max().item()
            del o, r, diff, lim, ulp
            share = beyond / out.numel()
            report.append(f"{err:.3e}/(one bfloat16 ulp + slack; {beyond} elements beyond one ulp, share {share:.1e})")
            if bad or (kind == "ulp" and share > FLIP_SHARE):
                raise AssertionError(f"{name}: {bad} elements beyond one bfloat16 ulp + slack, {beyond} beyond one ulp "
                                     f"(share {share:.2e}, at most {FLIP_SHARE}; largest error {err})")
        else:
            err = (out.to(ref.dtype) - ref).abs().max().item()
            limit = (tol if kind == "abs" else tol * ref.abs().max().item()) + floor
            report.append(f"{err:.3e}/{limit:.3e}")
            if not err <= limit:
                raise AssertionError(f"{name}: max abs error {err} exceeds {limit}")
        if err >= worst:
            worst, worst_limit = err, limit
    if repeat:
        for out, again in zip(outs, as_list(kernel_fn())):
            if not torch.equal(out, again):
                raise AssertionError(f"{name}: a second run on the same inputs gave other bits")
    del outs, refs
    ms, plain_ms = time_ms(kernel_fn), time_ms(plain_fn)
    library_ms = time_ms(library_fn) if library_fn is not None else None
    on_device = device_ms(kernel_fn, only=device_only)
    library_on_device = device_ms(library_fn) if library_fn is not None else None
    lib = f", library {library_ms:.4f} ms ({shown(library_on_device)} on the device)" if library_ms is not None else ""
    print(f"  {name}: err/limit {' '.join(report)}{', repeats bit for bit' if repeat else ''}; "
          f"kernel {ms:.4f} ms ({shown(on_device)} ms of it on the device), plain {plain_ms:.4f} ms{lib}")
    return Result(worst, worst_limit, ms, plain_ms, library_ms, on_device, library_on_device)


def bf16_ulp(t):
    """The bfloat16 spacing at |t| (floored at the smallest normal)."""
    import torch

    return torch.exp2(torch.floor(torch.log2(t.abs().float().clamp_min(2.0 ** -126))) - 7)


def check_parts(name, parts_fn, want, extra=0.0):
    """A bfloat16 weight gradient's partition, read from the kernel itself.
    `parts_fn` (a `*_wgrad_parts` wrapper) returns dW, its second output and
    the float32 part sums the kernel's fold read; each part is held to the
    plain version's (`want`) within 1e-4 of the parts' max plus `extra`,
    and dW must be, bit for bit, the sum of the parts each rounded to
    bfloat16 in part order. A kernel that splits the sum otherwise than the
    original, or rounds the whole sum once, fails here."""
    import torch

    dw, _, parts = parts_fn()
    want = torch.stack(list(want))
    if parts.shape != want.shape:
        raise AssertionError(f"{name}: part sums {tuple(parts.shape)} != plain {tuple(want.shape)}")
    err, limit = (parts - want).abs().max().item(), 1e-4 * want.abs().max().item() + extra
    if not err <= limit:
        raise AssertionError(f"{name}: the kernel's part sums differ from the plain version's by {err} > {limit}")
    if not torch.equal(dw, sum(p.bfloat16().float() for p in parts)):
        raise AssertionError(f"{name}: dW is not the sum of the kernel's part sums each rounded to bfloat16")
    once = int((dw != parts.sum(0).bfloat16().float()).sum().item())
    print(f"  {name}: {parts.shape[0]} part sums, err/limit {err:.3e}/{limit:.3e}; dW is their bfloat16 sum bit "
          f"for bit ({once} of {dw.numel()} elements differ from one rounding of the whole sum)")


def sum_slack(n: int, a_max: float, b_max: float) -> float:
    """The float32 rounding of a sum of n products |a·b| ≤ a_max·b_max, in
    either of two orders: n · a_max · b_max · 2^-24 (what an output that
    cancels to near zero may differ by, many of its own ulps)."""
    return n * a_max * b_max * EPS32


def flip_slack(a_max: float, b_max: float) -> float:
    """One bfloat16 operand of a product rounding to the other neighbour
    (its float32 value differs in the last bits between two versions):
    ulp(a_max) · b_max."""
    import torch

    return bf16_ulp(torch.tensor(a_max)).item() * b_max


def pool_slack(y, scale, bias, mean, var, w, b, pool, eps, mask=None, keep=1.0):
    """Slack of K2's bf16 pooled output: one pt-row column sum rounding to
    the other bfloat16 neighbour moves a window mean by one bfloat16 ulp of
    the window's largest column sum over pt·pf (column sums from the plain
    formula in float32); one bf16 xn operand of lin = xn·W flipping moves one
    element of the window by ulp(max|xn|)·max|W| / keep; the sums add their
    float32 rounding."""
    import torch

    xn = (y.float() - mean) * torch.rsqrt(var + eps) * scale + bias
    xn_max = xn.abs().max().item()
    g = (xn.bfloat16().float() @ w.bfloat16().float() + b) * torch.sigmoid(xn)
    del xn
    if mask is not None:
        g = g * mask * (1.0 / keep)
    B, T, F, C = g.shape
    pt, pf = pool
    cols = g.reshape(B, T // pt, pt, F // pf, pf, C).sum(dim=2).abs().amax(dim=3)
    w_max = w.abs().max().item()
    lin = (flip_slack(xn_max, w_max) + sum_slack(C, xn_max, w_max)) / (keep * pt * pf)
    return bf16_ulp(cols) / (pt * pf) + lin


def dyp_slack(y, dout, scale, bias, mean, var, w, pool, eps, keep=1.0):
    """Slack of K2b's bf16 dy_partial = inv·γ·(dlin·Wᵀ + dh·lin·σ'): one bf16
    dlin operand flipping (ulp(max|dlin|)·max|W|), one bf16 xn operand of lin
    flipping (max|dh|·ulp(max|xn|)·max|W| / 4, σ' ≤ 1/4), and the float32
    rounding of both channel sums, all times max|inv·γ|."""
    import torch

    inv = torch.rsqrt(var + eps)
    xn_max = ((y.float() - mean) * inv * scale + bias).abs().max().item()
    dh_max = dout.float().abs().max().item() / (pool[0] * pool[1] * keep)
    w_max, C = w.abs().max().item(), w.shape[0]
    return (inv * scale).abs().max().item() * (flip_slack(dh_max, w_max) + dh_max * flip_slack(xn_max, w_max) / 4
                                                 + 2 * sum_slack(C, max(dh_max, xn_max), w_max))


def flagship_frontend(device, cfg=None, onedot=None):
    """The frontend of `cfg` (the flagship Config() by default) on `device`
    (K1's onedot variant with `onedot`; the module constant when None)."""
    from dcase2019_task4_tpu_torch.config import Config
    from dcase2019_task4_tpu_torch.ops.mel import MelFrontend

    d = (cfg or Config()).dsp
    return MelFrontend(sample_rate=d.sample_rate, n_window=d.n_window, hop_length=d.hop_length,
                       n_mels=d.n_mels, f_min=d.f_min, f_max=d.f_max, max_frames=d.max_frames,
                       amin=d.amin, top_db=d.top_db, device=device, onedot=onedot)


@contextlib.contextmanager
def knobs(on: bool = True, onedot: Optional[bool] = None):
    """The JAX package's three A/B knobs (DCASE_FUSED_MEL_ONEDOT,
    DCASE_FUSED_BWD_RECOMPUTE, DCASE_DROPOUT_PACK) set to `on` inside, as
    the variables set them at import: the port's module constants, which a
    frontend reads when it is built and the fused Functions at their
    forward. `onedot` sets K1's knob apart (predict has no other)."""
    from dcase2019_task4_tpu_torch.ops import fused_block, fused_mel

    saved = fused_mel.ONEDOT, fused_block.RECOMPUTE_FIXUP, fused_block.PACK_BITS
    fused_mel.ONEDOT = on if onedot is None else onedot
    fused_block.RECOMPUTE_FIXUP = fused_block.PACK_BITS = on
    try:
        yield
    finally:
        fused_mel.ONEDOT, fused_block.RECOMPUTE_FIXUP, fused_block.PACK_BITS = saved


def k3_f32_kernels(device, rows, rng, which=("conv", "wgrad")):
    """Phase 3 for K3 in float32 at the flagship's blocks 2 and 3 ([B, 432,
    16, 64] and [B, 216, 4, 64]): forward (cuDNN `F.conv2d` as its library
    call) and dx (`conv2d_input`), "conv"; the weight gradient
    (`conv2d_weight` as its library call; autograd through `F.conv2d` to w
    and b, x not requiring grad, as the default step reaches cuDNN's weight
    gradient, held to the kernel at 1e-4 of max and timed beside it),
    "wgrad". The probes run one of the two."""
    import torch
    import torch.nn.functional as F

    from dcase2019_task4_tpu_torch.config import Config
    from dcase2019_task4_tpu_torch.ops import packed_conv as pc

    cfg = Config()
    d, C, B = cfg.dsp, cfg.model.nb_filters[1], cfg.train.batch_size

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    for T, Fq in ((d.max_frames // 2, d.n_mels // 4), (d.max_frames // 4, d.n_mels // 16)):
        lim = np.sqrt(2.0) * np.sqrt(6.0 / (18 * C))
        w, b = t(rng.uniform(-lim, lim, (3, 3, C, C))), t(0.1 * rng.standard_normal(C))
        params = {"w": w, "b": b}
        x, dy = t(rng.standard_normal((B, T, Fq, C))), t(rng.standard_normal((B, T, Fq, C)))
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        x_cl, dy_cl = (v.permute(0, 3, 1, 2) for v in (x, dy))  # NCHW views in channels-last memory
        act_bytes, conv_ops = x.numel() * 4, 2.0 * x.numel() * 9 * C
        shape = list(x.shape)
        if "conv" in which:
            res = compare(f"K3f conv2d_forward {shape}", lambda: pc.conv2d_forward(params, x),
                          lambda: pc.conv2d_reference(params, x), atol=1e-4,
                          library_fn=lambda: F.conv2d(x_cl, w_oihw, b, padding=1))
            rows["conv2d_forward"].add(shape, res, 2 * act_bytes + w.numel() * 4, conv_ops)
            res = compare(f"K3dx conv2d_dx {shape}", lambda: pc.conv2d_dx(w, dy),
                          lambda: pc.conv2d_dx_reference(w, dy), rtol_of_max=1e-4,
                          library_fn=lambda: torch.nn.grad.conv2d_input(x_cl.shape, w_oihw, dy_cl, padding=1))
            rows["conv2d_dx"].add(shape, res, 2 * act_bytes + w.numel() * 4, conv_ops)
        if "wgrad" not in which:
            del x, dy, x_cl, dy_cl
            continue
        res = compare(f"K3w conv2d_wgrad {shape}", lambda: pc.conv2d_wgrad(x, dy),
                      lambda: pc.conv2d_wgrad_reference(x, dy), rtol_of_max=1e-4, repeat=True,
                      library_fn=lambda: torch.nn.grad.conv2d_weight(x_cl, w_oihw.shape, dy_cl, padding=1))
        rows["conv2d_wgrad"].add(shape, res, 2 * act_bytes + w.numel() * 4, conv_ops)
        # the library as the default step reaches it: autograd through F.conv2d to w and b
        w_leaf, b_leaf = w_oihw.clone().requires_grad_(True), b.clone().requires_grad_(True)
        y_graph = F.conv2d(x_cl, w_leaf, b_leaf, padding=1)

        def library_wgrad():
            return torch.autograd.grad(y_graph, (w_leaf, b_leaf), dy_cl, retain_graph=True)

        (lib_dw, lib_db), (dw, db) = library_wgrad(), pc.conv2d_wgrad(x, dy)
        for what, got, want in (("dW", dw, lib_dw.permute(2, 3, 1, 0)), ("db", db, lib_db)):  # OIHW → HWIO
            err, limit = (got - want).abs().max().item(), 1e-4 * want.abs().max().item()
            if not err <= limit:
                raise AssertionError(f"K3w {shape} {what} against autograd through F.conv2d: {err} exceeds {limit}")
        print(f"  K3w library {shape}: autograd through F.conv2d (dW and db, x not requiring grad) "
              f"{time_ms(library_wgrad):.4f} ms ({shown(device_ms(library_wgrad))} on the device), "
              f"beside conv2d_weight alone (dW only) {res.library_ms:.4f} ms ({shown(res.library_device_ms)})")
        del x, dy, x_cl, dy_cl, y_graph, w_leaf, b_leaf, lib_dw, lib_db


def k2_f32_kernels(device, rows, rng, only: Optional[str] = None):
    """Phase 3 for K2 in float32 at the flagship's three block geometries
    ([B, 864, 64, 64], [B, 432, 16, 64], [B, 216, 4, 64]): eval and train
    forward, statistics, the backward's two passes and the whole backward
    through the autograd Function. `only`: "forward" runs the eval and train
    forward alone, "reduce" the first backward pass alone (their probes)."""
    import torch

    from dcase2019_task4_tpu_torch.config import Config
    from dcase2019_task4_tpu_torch.ops import fused_block as fb

    cfg = Config()
    d, m = cfg.dsp, cfg.model
    B, C = cfg.train.batch_size, m.nb_filters[1]
    pool = tuple(m.pooling[0])
    geometries = ((d.max_frames, d.n_mels), (d.max_frames // 2, d.n_mels // 4), (d.max_frames // 4, d.n_mels // 16))

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    # K2 at the three block geometries: eval and train forward, statistics, backward
    seed = torch.tensor([20190415], dtype=torch.int64)  # a CPU tensor, as the model hands it
    rate = m.dropout
    for T, Fq in geometries:
        y = t(rng.standard_normal((B, T, Fq, C)))
        scale, bias = t(1 + 0.1 * rng.standard_normal(C)), t(0.1 * rng.standard_normal(C))
        w, gb = t(rng.standard_normal((C, C)) / np.sqrt(C)), t(0.1 * rng.standard_normal(C))
        run_mean, run_var = t(0.2 * rng.standard_normal(C)), t(rng.uniform(0.5, 2.0, C))
        dout = t(rng.standard_normal((B, T // pool[0], Fq // pool[1], C)))
        shape, pixels = list(y.shape), B * T * Fq
        y_bytes, out_bytes, small = y.numel() * 4, dout.numel() * 4, (C * C + 5 * C) * 4
        mix_ops = 2.0 * pixels * C * C  # one C×C channel product per pixel

        if only == "reduce":  # the statistics the backward takes, then its first pass alone
            s, sq = fb.batch_stats(y)
            mean = s / pixels
            var = sq / pixels - mean * mean
            mask = fb.dropout_keep_mask(seed, y.shape, rate, device=device)
            res = compare(f"K2b bwd_reduce rate {rate} {shape} (dy_partial, dw, db, S1, S2)",
                          lambda: fb.bwd_reduce(y, dout, scale, bias, mean, var, w, gb, pool, m.bn_eps, rate=rate,
                                                seed=seed),
                          lambda: fb.bwd_reduce_reference(y, dout, scale, bias, mean, var, w, gb, pool, m.bn_eps, mask,
                                                          1.0 - rate),
                          rtol_of_max=1e-4, repeat=True)
            rows["bwd_reduce"].add(shape, res, 2 * y_bytes + out_bytes + 2 * small, 3 * mix_ops + 30.0 * y.numel())
            del y, dout, mask
            torch.cuda.empty_cache()
            continue

        res = compare(f"K2f fused_bn_glu_pool eval {shape}",
                      lambda: fb.fused_bn_glu_pool(y, scale, bias, run_mean, run_var, w, gb, pool, m.bn_eps),
                      lambda: fb.reference_block(y, scale, bias, run_mean, run_var, w, gb, pool, m.bn_eps),
                      atol=1e-5)
        rows["fused_bn_glu_pool_eval"].add(shape, res, y_bytes + out_bytes + small, mix_ops + 12.0 * y.numel())

        if only is None:
            res = compare(f"K2s batch_stats {shape}", lambda: fb.batch_stats(y), lambda: fb.batch_stats_reference(y),
                          rtol_of_max=1e-5, repeat=True,
                          library_fn=lambda: torch.var_mean(y, dim=(0, 1, 2), correction=0))
            rows["batch_stats"].add(shape, res, y_bytes + 2 * C * 4, 3.0 * y.numel())
        s, sq = fb.batch_stats(y)
        mean = s / pixels
        var = sq / pixels - mean * mean

        mask = fb.dropout_keep_mask(seed, y.shape, rate, device=device)
        res = compare(f"K2f fused_bn_glu_pool train rate {rate} {shape}",
                      lambda: fb.fused_bn_glu_pool(y, scale, bias, mean, var, w, gb, pool, m.bn_eps, rate=rate, seed=seed),
                      lambda: fb.reference_block(y, scale, bias, mean, var, w, gb, pool, m.bn_eps, mask, 1.0 - rate),
                      atol=1e-5)
        rows["fused_bn_glu_pool_train"].add(shape, res, y_bytes + out_bytes + small, mix_ops + 14.0 * y.numel())
        # the mask alone: y = 0 gives xn = 0 and σ = 1/2 exactly; a GLU of weight
        # 0 and bias 1 then gives g = mask / (2·keep), and the pooled sum counts
        # the kept elements (exactly so at rate 1/2)
        unit = (torch.ones(C, device=device), torch.zeros(C, device=device), torch.zeros(C, device=device),
                torch.ones(C, device=device), torch.zeros(C, C, device=device), torch.ones(C, device=device))
        pooled = fb.fused_bn_glu_pool(torch.zeros_like(y), *unit, pool, m.bn_eps, rate=rate, seed=seed)
        kept = pooled.double().sum().item() * pool[0] * pool[1] * 2.0 * (1.0 - rate)
        n_kept = int(mask.sum(dtype=torch.float64).item())
        if round(kept) != n_kept:
            raise AssertionError(f"K2f train {shape}: kernel kept {kept} elements, dropout_keep_mask {n_kept}")
        print(f"  K2f train {shape}: kept {n_kept} of {mask.numel()} elements, as dropout_keep_mask")
        if only == "forward":
            del y, dout, mask, pooled
            torch.cuda.empty_cache()
            continue

        res = compare(f"K2b bwd_reduce rate {rate} {shape} (dy_partial, dw, db, S1, S2)",
                      lambda: fb.bwd_reduce(y, dout, scale, bias, mean, var, w, gb, pool, m.bn_eps, rate=rate, seed=seed),
                      lambda: fb.bwd_reduce_reference(y, dout, scale, bias, mean, var, w, gb, pool, m.bn_eps, mask, 1.0 - rate),
                      rtol_of_max=1e-4, repeat=True)
        rows["bwd_reduce"].add(shape, res, 2 * y_bytes + out_bytes + 2 * small, 3 * mix_ops + 30.0 * y.numel())
        dyp, _, _, s1, s2 = fb.bwd_reduce(y, dout, scale, bias, mean, var, w, gb, pool, m.bn_eps, rate=rate, seed=seed)
        a, b2 = fb.bwd_coefficients(scale, var, m.bn_eps, s1, s2, pixels)
        res = compare(f"K2b bwd_fixup {shape}", lambda: fb.bwd_fixup(y, dyp.clone(), a, b2, mean),
                      lambda: fb.bwd_fixup_reference(y, dyp.clone(), a, b2, mean), rtol_of_max=1e-4, repeat=True,
                      device_only="bn_bwd_fixup_kernel")
        # both timed with a clone of dy_partial (the kernel writes in place); take it
        # off the event times (the device time counts the fixup kernel alone)
        clone_ms = time_ms(lambda: dyp.clone())
        res = res._replace(ms=max(res.ms - clone_ms, 0.0), plain_ms=max(res.plain_ms - clone_ms, 0.0))
        rows["bwd_fixup"].add(shape, res, 3 * y_bytes, 3.0 * y.numel())
        print(f"  K2b bwd_fixup {shape}: clone of dy_partial {clone_ms:.4f} ms taken off both times")

        # the whole backward through the autograd Function against the formulas
        leaves = [v.clone().requires_grad_(True) for v in (y, scale, bias, w, gb)]
        fb.fused_bn_glu_dropout_pool(leaves[0], leaves[1], leaves[2], mean, var, leaves[3], leaves[4],
                                     seed, rate, pool, m.bn_eps, True).backward(dout)
        ref = fb.bwd_reference(y, dout, scale, bias, mean, var, w, gb, pool, m.bn_eps, mask, 1.0 - rate)
        for name, leaf, want in zip(("dy", "dscale", "dbias", "dw", "db"), leaves, ref):
            err, limit = (leaf.grad - want).abs().max().item(), 1e-4 * want.abs().max().item()
            if not err <= limit:
                raise AssertionError(f"K2b Function {shape}: {name} error {err} exceeds {limit}")
        del y, dout, mask, dyp, leaves, ref, pooled
        torch.cuda.empty_cache()


def phase_kernels(device):
    import torch

    from dcase2019_task4_tpu_torch.config import Config
    from dcase2019_task4_tpu_torch.ops import fused_mel

    cfg = Config()
    d, m = cfg.dsp, cfg.model
    B = cfg.train.batch_size
    rng = np.random.default_rng(SEED)
    rows = {name: Row() for name in KERNELS}

    # K1 at the shape the frontend hands it: [B, T + extra_rows, hop]
    fe = flagship_frontend(device)
    audio = (0.1 * rng.standard_normal((B, d.max_samples + d.n_window))).astype(np.float32)
    bases = fe.bases()
    kw = dict(n_fft=d.n_window, hop=d.hop_length, T=d.max_frames)
    nb, M = fe.mel_fb.shape

    def frames_of(chunks):  # [B, T, n_fft] views of the hop rows
        return chunks.reshape(B, -1).unfold(1, d.n_window, d.hop_length)[:, : d.max_frames]

    for dtype in ("float32", "int16"):
        a = torch.as_tensor(audio, device=device)
        if dtype == "int16":
            a = torch.clamp(torch.round(a * 32768.0), -32768, 32767).to(torch.int16)
        chunks = fe._hop_chunks(a)
        # the function in float64: the same window and mel weights, an exact DFT
        x64 = fused_mel._dequantize(chunks).double()
        spec64 = torch.fft.rfft(frames_of(x64) * fe.window.double(), dim=-1)[..., :nb].abs()
        exact = spec64 @ fe.mel_fb.double()
        del x64, spec64
        errs = [(fn(chunks, bases, **kw).double() - exact).abs().max().item()
                for fn in (fused_mel.fused_stft_mel, fused_mel.fused_stft_mel_reference)]
        scale = exact.abs().max().item()
        print(f"  K1 {dtype} against a float64 DFT: kernel {errs[0]:.3e}, plain float32 version {errs[1]:.3e} "
              f"({errs[0] / scale:.2e} and {errs[1] / scale:.2e} of max)")
        if not errs[0] <= 2.0 * errs[1]:
            raise AssertionError(f"K1 {dtype}: error {errs[0]} against float64 exceeds twice the plain version's {errs[1]}")
        del exact
        library_fn = None
        if dtype == "float32":  # timed for the row; the train step hands K1 int16
            frames = (frames_of(chunks) * fe.window).contiguous()  # windowed frames, made outside the timed call
            library_fn = lambda: torch.fft.rfft(frames, dim=-1)  # noqa: E731 — the transform alone
            both = torch.cat([fe.cos_basis, fe.sin_basis], dim=1)
            raw = frames_of(chunks).contiguous()
            print(f"  K1 yardstick: one cuBLAS SGEMM of both DFT products {list(raw.shape)} @ {list(both.shape)}: "
                  f"{time_ms(lambda: torch.matmul(raw, both)):.4f} ms "
                  f"({shown(device_ms(lambda: torch.matmul(raw, both)))} on the device)")

            def by_library():  # the whole function as PyTorch calls: window, rfft, magnitude, mel product
                return torch.fft.rfft(frames_of(chunks) * fe.window, dim=-1)[..., :nb].abs() @ fe.mel_fb

            print(f"  K1 yardstick: the whole function as PyTorch calls (window, rfft, |.|, mel matmul): "
                  f"{time_ms(by_library):.4f} ms ({shown(device_ms(by_library))} on the device)")
            del both, raw
        res = compare(f"K1 fused_stft_mel {dtype} {list(chunks.shape)} (library: torch.fft.rfft, the transform alone)",
                      lambda: fused_mel.fused_stft_mel(chunks, bases, **kw),
                      lambda: fused_mel.fused_stft_mel_reference(chunks, bases, **kw),
                      rtol_of_max=1e-4, library_fn=library_fn)
        # what the function needs: a real FFT per frame (2.5 n log2 n, the
        # conventional count), the magnitudes, the band sums; the audio in its
        # own dtype, the mel out and the band table
        n_frames = B * d.max_frames
        n_ops = n_frames * (2.5 * d.n_window * np.log2(d.n_window) + 4 * nb + 2 * bases.band_weights.numel())
        n_bytes = (chunks.numel() * chunks.element_size() + n_frames * M * 4
                   + (bases.band_weights.numel() + bases.bands.numel()) * 4)
        bound, by = bound_ms(n_bytes, n_ops)
        print(f"  K1 {dtype} bound: {n_ops / 1e9:.3f} GFLOP, {n_bytes / 1e6:.1f} MB -> {bound:.4f} ms by {by}")
        if dtype == "float32":
            rows["fused_stft_mel"].add(chunks.shape, res, n_bytes, n_ops)
            del frames
        else:
            rows["fused_stft_mel"].note_err(res)

    k3_f32_kernels(device, rows, rng)
    k2_f32_kernels(device, rows, rng)
    helpers = entry_kernels(device, rows, rng)
    from dcase2019_task4_tpu_torch.config import scaled_config

    bf16_block_kernels(device, rows, rng, scaled_config())
    flagship = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, compute_dtype="bfloat16"))
    bf16_block_kernels(device, rows, rng, flagship, "_flagship")
    entry_bf16_kernels(device, rows, rng)
    helpers += knob_kernels(device, rows, rng)
    return rows, helpers


def entry_kernels(device, rows, rng):
    """Phase 3 for the entry-block family at the flagship block-1 shape:
    x [B, 864, 64] -> y [B, 864, 64, 64] -> pooled [B, 432, 16, 64]. Returns
    the helper kernels' readings (kernels no path runs)."""
    import torch
    import torch.nn.functional as F

    from dcase2019_task4_tpu_torch.config import Config
    from dcase2019_task4_tpu_torch.models import layers as L
    from dcase2019_task4_tpu_torch.ops import crows_block as cr
    from dcase2019_task4_tpu_torch.ops import entry_conv as ec
    from dcase2019_task4_tpu_torch.ops import fused_block as fb
    from dcase2019_task4_tpu_torch.ops import fused_entry_block as fe

    cfg = Config()
    d, m = cfg.dsp, cfg.model
    B, T, Fq, C = cfg.train.batch_size, d.max_frames, d.n_mels, m.nb_filters[0]
    pool, eps, rate = tuple(m.pooling[0]), m.bn_eps, m.dropout

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    x = t(rng.standard_normal((B, T, Fq)))
    lim = np.sqrt(2.0) * np.sqrt(6.0 / (9 * (1 + C)))
    conv = {"w": t(rng.uniform(-lim, lim, (3, 3, 1, C))), "b": t(0.1 * rng.standard_normal(C))}
    scale, bias = t(1 + 0.1 * rng.standard_normal(C)), t(0.1 * rng.standard_normal(C))
    gw, gb = t(rng.standard_normal((C, C)) / np.sqrt(C)), t(0.1 * rng.standard_normal(C))
    run_mean, run_var = t(0.2 * rng.standard_normal(C)), t(rng.uniform(0.5, 2.0, C))
    dy = t(rng.standard_normal((B, T, Fq, C)))
    dout = t(rng.standard_normal((B, T // pool[0], Fq // pool[1], C)))
    seed = torch.tensor([20190415], dtype=torch.int64)
    pixels = B * T * Fq
    shape = [B, T, Fq, C]
    x_bytes, y_bytes, out_bytes = x.numel() * 4, pixels * C * 4, dout.numel() * 4
    small = (10 * C + C * C + 5 * C) * 4
    conv_ops, mix_ops = 2.0 * 9 * pixels * C, 2.0 * pixels * C * C
    # What the function needs beside the nine-tap and C×C products, per element
    # of the [pixels, C] conv output, one count per step of the chain:
    #   up to lin: conv bias 1, x̂ = (y − mean)·inv 2, xn = x̂·γ + β 2,
    #     σ(xn) = 1 / (1 + exp(−xn)) 4, lin + glu_b 1                          = 10
    #   forward: g = lin·σ 1, pooling sum 1 (= 12); dropout compare and scale 2 (= 14)
    #   back to dxn: dout·mask·scale 2, dlin = dg·σ 1, dσ = dg·lin 1,
    #     σ' = σ·(1 − σ) 2, dxn = dlin·Wᵀ + dσ·σ' 2                             = 8
    #   pass 1 sums: d glu_b 1, S1 1, S2 = Σdxn·x̂ 2                            = 4
    #   pass 2: dy = inv·γ·dxn − a − (y − mean)·b2 5, d conv_b 1               = 6
    # A kernel's own recomputation (y again for x̂ or dy) is not the function's.
    elements = float(pixels * C)
    fwd_eval_ops, fwd_train_ops = (10 + 2) * elements, (10 + 2 + 2) * elements
    pass1_ops, pass2_ops = (10 + 8 + 4) * elements, (10 + 8 + 6) * elements
    w_oihw = conv["w"].permute(3, 2, 0, 1).contiguous()
    x_cl = x[:, None].contiguous(memory_format=torch.channels_last)  # NCHW view of one channel
    dy_cl = dy.permute(0, 3, 1, 2)  # NCHW view in channels-last memory

    # K4f: y, and the sums of y as stored
    res = compare(f"K4f entry_conv {shape} (y, sum, sum of squares)", lambda: ec.entry_conv_forward(conv, x),
                  lambda: ec.entry_conv_reference(conv, x), tols=[("abs", 1e-5), ("max", 1e-5), ("max", 1e-5)],
                  repeat=True, library_fn=lambda: F.conv2d(x_cl, w_oihw, conv["b"], padding=1))
    rows["entry_conv"].add(shape, res, x_bytes + y_bytes + small, conv_ops + 3.0 * pixels * C)
    y, s1, s2 = ec.entry_conv_forward(conv, x)
    res = compare(f"K5s entry_block_stats {shape} (sum, sum of squares; y not written)",
                  lambda: fe.entry_block_stats_apply(conv, x), lambda: ec.entry_conv_reference(conv, x)[1:],
                  rtol_of_max=1e-5, repeat=True)
    rows["entry_block_stats"].add(shape, res, x_bytes + small, conv_ops + 3.0 * pixels * C)
    # K5s runs the one-wave conv (entry_conv_run_kernel<float, false>), whose
    # conv of FP32 FMAs is its bound: printed as its floor, as in bfloat16
    print(f"  K5s {shape}: floor of a conv of FP32 FMAs {bound_ms(x_bytes + small, conv_ops + 3.0 * pixels * C)[0]:.4f} "
          "ms, its bound")
    # both held to K2s on the stored y (the running variance is sum y^2 / n -
    # mean^2) and to the float64 sums of y; K5s sums in float32 a tile, so
    # its last bits are not K4f's
    k2s = fb.batch_stats(y)
    yd = y.double()
    exact = (yd.sum(dim=(0, 1, 2)), (yd * yd).sum(dim=(0, 1, 2)))
    del yd
    for name, sums in (("K4f", (s1, s2)), ("K5s", fe.entry_block_stats_apply(conv, x))):
        for got, want, want64 in zip(sums, k2s, exact):
            err, limit = (got - want).abs().max().item(), 1e-6 * want.abs().max().item()
            if not err <= limit:
                raise AssertionError(f"{name} sums against batch_stats(y): {err} exceeds {limit}")
            err, limit = (got.double() - want64).abs().max().item(), 1e-5 * want64.abs().max().item()
            if not err <= limit:
                raise AssertionError(f"{name} sums against the float64 sums of y: {err} exceeds {limit}")
    print("  K4f and K5s sums equal K2s batch_stats(y) within 1e-6 of max and the float64 sums of y within 1e-5")
    n = float(pixels)
    mean = s1 / n
    var = s2 / n - mean * mean

    # the library as the default path reaches it: autograd through the model's
    # own conv (`layers.conv2d`), which gives dW and db in one backward call
    w_leaf, b_leaf = w_oihw.clone().requires_grad_(True), conv["b"].clone().requires_grad_(True)
    y_graph = L.conv2d(w_leaf, b_leaf, x[..., None])

    def library_wgrad():
        return torch.autograd.grad(y_graph, (w_leaf, b_leaf), dy, retain_graph=True)

    (lib_dw, lib_db), (dw, db) = library_wgrad(), ec.entry_conv_wgrad(x, dy)
    for what, got, want in (("dW", dw, lib_dw.permute(2, 3, 1, 0)), ("db", db, lib_db)):  # OIHW → HWIO
        err, limit = (got - want).abs().max().item(), 1e-4 * want.abs().max().item()
        if not err <= limit:
            raise AssertionError(f"K4w {what} against autograd through layers.conv2d: {err} exceeds {limit}")
    res = compare(f"K4w entry_conv_wgrad {shape} (dW, db)", lambda: ec.entry_conv_wgrad(x, dy),
                  lambda: ec.entry_conv_wgrad_reference(x, dy), rtol_of_max=1e-4, repeat=True,
                  library_fn=library_wgrad)
    rows["entry_conv_wgrad"].add(shape, res, x_bytes + y_bytes + small, conv_ops + 1.0 * pixels * C)
    alone = lambda: torch.nn.grad.conv2d_weight(x_cl, w_oihw.shape, dy_cl, padding=1)  # noqa: E731
    print(f"  K4w library: autograd through layers.conv2d (dW and db) {res.library_ms:.4f} ms "
          f"({shown(res.library_device_ms)} on the device); torch.nn.grad.conv2d_weight called alone (dW only) "
          f"{time_ms(alone):.4f} ms ({shown(device_ms(alone))} on the device)")
    del dy, dy_cl, y_graph, w_leaf, b_leaf

    # K5f: eval (running statistics, rate 0) and train (batch statistics, dropout)
    block = (conv["w"], conv["b"], scale, bias)
    res = compare(f"K5f entry_block_fwd eval {shape}",
                  lambda: fe.entry_block_fwd(x, *block, run_mean, run_var, gw, gb, pool, eps),
                  lambda: fe.reference_entry_block(x, *block, run_mean, run_var, gw, gb, pool, eps), atol=1e-5)
    rows["entry_block_fwd_eval"].add(shape, res, x_bytes + out_bytes + small, conv_ops + mix_ops + fwd_eval_ops)
    mask = fb.dropout_keep_mask(seed, shape, rate, device=device)
    res = compare(f"K5f entry_block_fwd train rate {rate} {shape}",
                  lambda: fe.entry_block_fwd(x, *block, mean, var, gw, gb, pool, eps, rate=rate, seed=seed),
                  lambda: fe.reference_entry_block(x, *block, mean, var, gw, gb, pool, eps, mask, 1.0 - rate),
                  atol=1e-5)
    rows["entry_block_fwd_train"].add(shape, res, x_bytes + out_bytes + small, conv_ops + mix_ops + fwd_train_ops)
    for r in (0.0, rate):  # the same mask as K2f: F.conv2d -> K2f with that seed
        fused = fe.entry_block_fwd(x, *block, mean, var, gw, gb, pool, eps, rate=r, seed=seed)
        pair = fb.fused_bn_glu_pool(ec.entry_conv_reference(conv, x)[0], scale, bias, mean, var, gw, gb, pool, eps,
                                    rate=r, seed=seed)
        err = (fused - pair).abs().max().item()
        if not err <= 1e-5:
            raise AssertionError(f"K5f rate {r} against F.conv2d -> K2f with the same seed: {err} exceeds 1e-5")
        print(f"  K5f rate {r} equals F.conv2d -> K2f with the same seed within {err:.3e} (limit 1e-5)")
        # K5f runs K2f's float32 tile code (csrc/f32_tile.cuh) on the y it
        # computes in K4f's order: K4f -> K2f with the same seed, bit for bit
        pair = fb.fused_bn_glu_pool(y, scale, bias, mean, var, gw, gb, pool, eps, rate=r, seed=seed)
        if not torch.equal(fused, pair):
            raise AssertionError(f"K5f float32 rate {r} differs from K4f -> K2f float32 with the same seed: largest "
                                 f"difference {(fused - pair).abs().max().item():.3e}")
        print(f"  K5f float32 rate {r} equals K4f -> K2f float32 with the same seed bit for bit")
    del fused, pair, y

    # K5b1, K5b2: the two backward passes with the host-side step between them
    args = (x, dout, *block, mean, var, gw, gb)
    res = compare(f"K5b1 entry_block_bwd_reduce rate {rate} {shape} (d glu_w, d glu_b, S1, S2)",
                  lambda: fe.entry_block_bwd_reduce(*args, pool, eps, rate=rate, seed=seed),
                  lambda: fe.entry_block_bwd_reduce_reference(*args, pool, eps, mask, 1.0 - rate),
                  rtol_of_max=1e-4, repeat=True)
    rows["entry_block_bwd_reduce"].add(shape, res, x_bytes + out_bytes + 2 * small,
                                       conv_ops + 3 * mix_ops + pass1_ops)  # conv; lin, dxn, d glu_w
    dgw, dgb, r1, r2 = fe.entry_block_bwd_reduce(*args, pool, eps, rate=rate, seed=seed)
    a, b2 = fb.bwd_coefficients(scale, var, eps, r1, r2, pixels)
    # K5b1 runs K2b's float32 reduce pass (csrc/f32_tile.cuh) on the y it
    # computes and sums into K2b's slots: K4f -> K2b's reduce pass without
    # dy_partial with the same seed, bit for bit
    y = ec.entry_conv_forward(conv, x)[0]
    pair = fb.bwd_reduce(y, dout, scale, bias, mean, var, gw, gb, pool, eps, rate=rate, seed=seed, recompute=True)[1:]
    del y
    if not all(torch.equal(p, q) for p, q in zip((dgw, dgb, r1, r2), pair)):
        worst = max((p - q).abs().max().item() / q.abs().max().item() for p, q in zip((dgw, dgb, r1, r2), pair))
        raise AssertionError(f"K5b1 float32 differs from K4f -> K2b reduce float32: {worst:.3e} of max")
    print("  K5b1 float32 equals K4f -> K2b reduce float32 without dy_partial with the same seed bit for bit")
    del pair

    def exact_wgrad():
        """Pass 2 in float64. d conv_b is zero in exact arithmetic (a shift of
        the conv bias cancels in the normalisation): the gauge-leaf rule holds
        it, 1e-4 of its max plus 1e-6 of the block's largest gradient."""
        dbl = [v.double() for v in (*args, a, b2)]
        dw64, dcb64 = fe.entry_block_bwd_wgrad_reference(*dbl, pool, eps, mask.double(), 1.0 - rate)
        top = max(v.abs().max().item() for v in (dw64, dgw, dgb, r1, r2))
        return (dw64, dcb64), (0.0, GRAD_FLOOR * top)

    res = compare(f"K5b2 entry_block_bwd_wgrad rate {rate} {shape} (dW, d conv_b against float64)",
                  lambda: fe.entry_block_bwd_wgrad(*args, a, b2, pool, eps, rate=rate, seed=seed),
                  lambda: fe.entry_block_bwd_wgrad_reference(*args, a, b2, pool, eps, mask, 1.0 - rate),
                  rtol_of_max=1e-4, repeat=True, exact_fn=exact_wgrad)
    rows["entry_block_bwd_wgrad"].add(shape, res, x_bytes + out_bytes + 2 * small,
                                      2 * conv_ops + 2 * mix_ops + pass2_ops)  # conv, dW; lin, dxn
    # K5b2 runs the recompute fixup's float32 tile code on the y it computes
    # and takes dW from the dy tile: K4f -> fixup -> K4w with the same seed
    # gives the same dy, summed in another order (d conv_b, a gauge leaf, with
    # a floor of 1e-6 of dW's max)
    dw, dcb = fe.entry_block_bwd_wgrad(*args, a, b2, pool, eps, rate=rate, seed=seed)
    y = ec.entry_conv_forward(conv, x)[0]
    dy = fb.bwd_fixup_recompute(y, dout, scale, bias, mean, var, gw, gb, a, b2, pool, eps, rate=rate, seed=seed)
    del y
    pair = ec.entry_conv_wgrad(x, dy)
    del dy
    floor = 1e-6 * pair[0].abs().max().item()
    for what, got, want, extra in (("dW", dw, pair[0], 0.0), ("d conv_b", dcb, pair[1], floor)):
        err, limit = (got - want).abs().max().item(), 1e-6 * want.abs().max().item() + extra
        if not err <= limit:
            raise AssertionError(f"K5b2 float32 {what} against K4f -> fixup -> K4w float32: {err} exceeds {limit}")
        print(f"  K5b2 float32 {what} equals K4f -> recompute fixup -> K4w float32 within {err:.3e} "
              f"(limit {limit:.3e}: 1e-6 of max{' + the gauge floor' if extra else ''})")
    del dw, dcb, pair

    # K6: the crows entries themselves at this shape (their gate, their
    # counting, the autograd Function under them): bit for bit what K5's
    # wrappers give, and held to the plain versions on their own
    def same_bits(what, outs, wants):
        for out, want in zip(outs, wants):
            if not torch.equal(out, want):
                raise AssertionError(f"{what} differs from the fused entry block's own wrapper")

    def held(what, outs, refs, floors=None):
        """→ (largest error, its limit): each output within 1e-4 of its
        reference's max, plus its floor."""
        worst, worst_limit = 0.0, 0.0
        for out, ref, floor in zip(outs, refs, floors or [0.0] * len(outs)):
            err, limit = (out - ref).abs().max().item(), 1e-4 * ref.abs().max().item() + floor
            if not err <= limit:
                raise AssertionError(f"{what}: max abs error {err} exceeds {limit}")
            if err >= worst:
                worst, worst_limit = err, limit
        return worst, worst_limit

    res = compare(f"K6 crows_stats_apply {shape} (sum, sum of squares)", lambda: cr.crows_stats_apply(conv, x),
                  lambda: ec.entry_conv_reference(conv, x)[1:], rtol_of_max=1e-5, repeat=True)
    rows["crows_stats"].add(shape, res, x_bytes + small, conv_ops + 3.0 * pixels * C)
    same_bits("crows_stats_apply", cr.crows_stats_apply(conv, x), fe.entry_block_stats_apply(conv, x))
    crows_fwd = lambda: cr.crows_apply(conv, scale, bias, mean, var, gw, gb, x, seed, rate, pool, eps, True)  # noqa: E731
    res = compare(f"K6 crows_apply forward rate {rate} {shape}", crows_fwd,
                  lambda: fe.reference_entry_block(x, *block, mean, var, gw, gb, pool, eps, mask, 1.0 - rate),
                  atol=1e-5)
    rows["crows_fwd"].add(shape, res, x_bytes + out_bytes + small, conv_ops + mix_ops + fwd_train_ops)
    same_bits("crows_apply forward", [crows_fwd()],
              [fe.entry_block_fwd(x, *block, mean, var, gw, gb, pool, eps, rate=rate, seed=seed)])
    leaves = [v.clone().requires_grad_(True) for v in (*block, gw, gb)]
    cr.crows_apply({"w": leaves[0], "b": leaves[1]}, leaves[2], leaves[3], mean, var, leaves[4], leaves[5], x, seed,
                   rate, pool, eps, True).backward(dout)
    dw_c, dcb_c, dscale_c, dbias_c, dgw_c, dgb_c = (leaf.grad for leaf in leaves)
    pass1, pass2 = (dgw_c, dgb_c, dbias_c, dscale_c), (dw_c, dcb_c)  # d bias = S1, d scale = S2
    same_bits("crows_apply backward, pass 1", pass1, (dgw, dgb, r1, r2))
    same_bits("crows_apply backward, pass 2", pass2,
              fe.entry_block_bwd_wgrad(*args, a, b2, pool, eps, rate=rate, seed=seed))
    exact, floors = exact_wgrad()
    crows_errs = {
        "crows_bwd_reduce": held("crows_apply backward, pass 1", pass1,
                                 fe.entry_block_bwd_reduce_reference(*args, pool, eps, mask, 1.0 - rate)),
        "crows_bwd_wgrad": held("crows_apply backward, pass 2 (against float64)", [v.double() for v in pass2],
                                exact, floors),
    }
    for name, (err, limit) in crows_errs.items():
        # the Function's backward launches both passes in one call: the
        # errors are this call's, the times those of the same kernel above
        rows[name] = copy.copy(rows[SAME_KERNEL[name]])
        rows[name].err, rows[name].limit = err, limit
        print(f"  K6 {name} {shape}: bit for bit as {SAME_KERNEL[name]}; err/limit {err:.3e}/{limit:.3e}")
    del leaves, pass1, pass2, exact

    # the keep-mask kernel (a test helper): bit-equal to dropout_keep_mask
    got = fb.dropout_mask(seed, shape, rate, device)
    if not torch.equal(got, mask):
        raise AssertionError("dropout_mask kernel differs from dropout_keep_mask")
    mask_err = (got.float() - mask.float()).abs().max().item()
    mask_ms = time_ms(lambda: fb.dropout_mask(seed, shape, rate, device))
    mask_device_ms = device_ms(lambda: fb.dropout_mask(seed, shape, rate, device))
    plain_ms = time_ms(lambda: fb.dropout_keep_mask(seed, shape, rate, device=device), warmup=1, runs=3)
    mask_bound, _ = bound_ms(y_bytes, 0.0)
    print(f"  dropout_mask {shape}: bit-equal to dropout_keep_mask ({int(got.sum().item())} kept); "
          f"kernel {mask_ms:.4f} ms ({shown(mask_device_ms)} ms of it on the device), plain {plain_ms:.4f} ms, "
          f"bound {mask_bound:.4f} ms (bytes)")
    del got, mask
    torch.cuda.empty_cache()
    return [{"name": "dropout_mask", "route": "cuda", "source": CSRC + "entry_block.cu",
             "replaces": "tests/test_fused_block.py:189", "launches": None, "max_abs_err": mask_err, "ms": mask_ms,
             "device_ms": mask_device_ms, "plain_ms": plain_ms, "bound_ms": mask_bound, "bound_by": "bytes", "library_ms": None}]


def onedot_kernels(device, rows, rng):
    """Phase 3 for K1's onedot kernel at the shape the frontend hands it
    (flagship, batch 24), float32 and int16 audio: against its plain version
    and against a float64 DFT (1e-5 of max each), twice bit for bit, timed
    beside one cuBLAS SGEMM of the same product."""
    import torch

    from dcase2019_task4_tpu_torch.config import Config
    from dcase2019_task4_tpu_torch.ops import fused_mel

    cfg = Config()
    d, B = cfg.dsp, cfg.train.batch_size
    front = flagship_frontend(device, onedot=True)
    ob = front.onedot_bases()
    kw = dict(n_fft=d.n_window, hop=d.hop_length, T=d.max_frames)
    nb, M = front.mel_fb.shape
    audio = (0.1 * rng.standard_normal((B, d.max_samples + d.n_window))).astype(np.float32)

    def frames_of(chunks):  # [B, T, n_fft] views of the hop rows
        return chunks.reshape(B, -1).unfold(1, d.n_window, d.hop_length)[:, : d.max_frames]

    for dtype in ("float32", "int16"):
        a = torch.as_tensor(audio, device=device)
        if dtype == "int16":
            a = torch.clamp(torch.round(a * 32768.0), -32768, 32767).to(torch.int16)
        chunks = front._hop_chunks(a)
        x64 = fused_mel._dequantize(chunks).double()
        spec64 = torch.fft.rfft(frames_of(x64) * front.window.double(), dim=-1)[..., :nb].abs()
        exact = spec64 @ front.mel_fb.double()
        del x64, spec64
        errs = [(fn(chunks, ob, **kw).double() - exact).abs().max().item()
                for fn in (fused_mel.fused_stft_mel_onedot, fused_mel.fused_stft_mel_onedot_reference)]
        scale = exact.abs().max().item()
        print(f"  K1 onedot {dtype} against a float64 DFT: kernel {errs[0]:.3e}, plain float32 version {errs[1]:.3e} "
              f"({errs[0] / scale:.2e} and {errs[1] / scale:.2e} of max; limit 1e-5 of max)")
        if not errs[0] <= 1e-5 * scale:
            raise AssertionError(f"K1 onedot {dtype}: error {errs[0]} against float64 exceeds 1e-5 of max {scale}")
        del exact
        library_fn = None
        if dtype == "float32":
            raw = frames_of(chunks).contiguous()  # the frames, made outside the timed call
            library_fn = lambda: torch.matmul(raw, ob.dft)  # noqa: E731 — one cuBLAS SGEMM of the product
        res = compare(f"K1 fused_stft_mel_onedot {dtype} {list(chunks.shape)} (library: one SGEMM "
                      f"[{B}, {d.max_frames}, {d.n_window}] @ {list(ob.dft.shape)}, the product alone)",
                      lambda: fused_mel.fused_stft_mel_onedot(chunks, ob, **kw),
                      lambda: fused_mel.fused_stft_mel_onedot_reference(chunks, ob, **kw),
                      rtol_of_max=1e-5, library_fn=library_fn, repeat=True)
        # what the function needs: the product, the magnitudes, the mel product;
        # the audio in its own dtype, the basis, the mel matrix and the mel out
        n_frames = B * d.max_frames
        n_ops = n_frames * (2.0 * d.n_window * 2 * nb + 4 * nb + 2.0 * nb * M)
        n_bytes = chunks.numel() * chunks.element_size() + (ob.dft.numel() + ob.mel_fb.numel() + n_frames * M) * 4
        bound, by = bound_ms(n_bytes, n_ops)
        print(f"  K1 onedot {dtype} bound: {n_ops / 1e9:.3f} GFLOP, {n_bytes / 1e6:.1f} MB -> {bound:.4f} ms by {by}; "
              f"device {shown(res.device_ms)} ms")
        if dtype == "float32":
            rows["fused_stft_mel_onedot"].add(chunks.shape, res, n_bytes, n_ops)
            del raw
        else:
            rows["fused_stft_mel_onedot"].note_err(res)
    del front, ob


def knob_kernels(device, rows, rng):
    """Phase 3 for the JAX package's three A/B knobs at the flagship shapes,
    in the modes the knobs path runs (dropout at the model's rate, the
    packed draw): K1 through the cos‖sin basis (`onedot_kernels`), K2f
    with the packed draw, K2b's first pass without dy_partial and the
    recompute fixup at the three block geometries (the autograd Function
    with the fixup mode on against itself with it off), K5f and K5b1 with
    the packed draw at the block-1 shape, and the packed keep-mask kernel
    bit for bit with its keep share. Returns the helper's reading."""
    import torch

    from dcase2019_task4_tpu_torch.config import Config
    from dcase2019_task4_tpu_torch.ops import entry_conv as ec
    from dcase2019_task4_tpu_torch.ops import fused_block as fb
    from dcase2019_task4_tpu_torch.ops import fused_entry_block as fe

    cfg = Config()
    d, m = cfg.dsp, cfg.model
    B, eps, rate = cfg.train.batch_size, m.bn_eps, m.dropout
    keep = 1.0 - rate

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    onedot_kernels(device, rows, rng)

    # K2 at the three block geometries with the packed draw; K2b without dy_partial
    C = m.nb_filters[1]
    pool = tuple(m.pooling[0])
    seed = torch.tensor([20190416], dtype=torch.int64)
    packed = dict(rate=rate, seed=seed, pack_bits=True)
    for T, Fq in ((d.max_frames, d.n_mels), (d.max_frames // 2, d.n_mels // 4), (d.max_frames // 4, d.n_mels // 16)):
        y = t(rng.standard_normal((B, T, Fq, C)))
        scale, bias = t(1 + 0.1 * rng.standard_normal(C)), t(0.1 * rng.standard_normal(C))
        w, gb = t(rng.standard_normal((C, C)) / np.sqrt(C)), t(0.1 * rng.standard_normal(C))
        dout = t(rng.standard_normal((B, T // pool[0], Fq // pool[1], C)))
        shape, pixels = list(y.shape), B * T * Fq
        y_bytes, out_bytes, small = y.numel() * 4, dout.numel() * 4, (C * C + 5 * C) * 4
        mix_ops = 2.0 * pixels * C * C
        s, sq = fb.batch_stats(y)
        mean = s / pixels
        var = sq / pixels - mean * mean
        vecs = (scale, bias, mean, var, w, gb)
        mask = fb.dropout_keep_mask(seed, y.shape, rate, device=device, pack_bits=True)

        res = compare(f"K2f fused_bn_glu_pool train, packed draw, rate {rate} {shape}",
                      lambda: fb.fused_bn_glu_pool(y, *vecs, pool, eps, **packed),
                      lambda: fb.reference_block(y, *vecs, pool, eps, mask, keep), atol=1e-5)
        rows["fused_bn_glu_pool_train_packed"].add(shape, res, y_bytes + out_bytes + small, mix_ops + 14.0 * y.numel())
        unit = (torch.ones(C, device=device), torch.zeros(C, device=device), torch.zeros(C, device=device),
                torch.ones(C, device=device), torch.zeros(C, C, device=device), torch.ones(C, device=device))
        pooled = fb.fused_bn_glu_pool(torch.zeros_like(y), *unit, pool, eps, **packed)
        kept = pooled.double().sum().item() * pool[0] * pool[1] * 2.0 * keep
        n_kept = int(mask.sum(dtype=torch.float64).item())
        if round(kept) != n_kept:
            raise AssertionError(f"K2f packed {shape}: kernel kept {kept} elements, dropout_keep_mask {n_kept}")
        print(f"  K2f packed {shape}: kept {n_kept} of {mask.numel()} elements, as dropout_keep_mask(pack_bits=True)")
        del pooled

        # up to dxn 9 per element (x̂ 2, xn 2, σ 4, lin + b 1) + 8 (the pass
        # table of entry_kernels); the first pass's sums 3 more, the fixup's dy 5
        res = compare(f"K2b bwd_reduce without dy_partial, packed draw {shape} (dw, db, S1, S2)",
                      lambda: fb.bwd_reduce(y, dout, *vecs, pool, eps, recompute=True, **packed)[1:],
                      lambda: fb.bwd_reduce_reference(y, dout, *vecs, pool, eps, mask, keep)[1:],
                      rtol_of_max=1e-4, repeat=True)
        rows["bwd_reduce_nodyp"].add(shape, res, y_bytes + out_bytes + 2 * small, 3 * mix_ops + 20.0 * y.numel())
        fixup_recompute_row(rows["bwd_fixup_recompute"], y, dout, vecs, pool, eps, rate, seed, mask)

        def function_grads(recompute):
            leaves = [v.clone().requires_grad_(True) for v in (y, scale, bias, w, gb)]
            fb.fused_bn_glu_dropout_pool(leaves[0], leaves[1], leaves[2], mean, var, leaves[3], leaves[4], seed,
                                         rate, pool, eps, True, pack_bits=True, recompute=recompute).backward(dout)
            return [v.grad for v in leaves]

        on, off = function_grads(True), function_grads(False)
        err, limit = (on[0] - off[0]).abs().max().item(), 1e-6 * off[0].abs().max().item()
        if not err <= limit or not all(torch.equal(p, q) for p, q in zip(on[1:], off[1:])):
            raise AssertionError(f"K2b Function {shape}: the recompute fixup's dy differs from the stored one's by "
                                 f"{err} (limit {limit}), or another gradient differs")
        print(f"  K2b Function {shape}: dy with the recompute fixup within {err:.3e} of the stored fixup's (limit "
              f"{limit:.3e}); dscale, dbias, dw, db bit for bit")
        del y, dout, mask, on, off
        torch.cuda.empty_cache()

    # K5f and K5b1 with the packed draw at the block-1 shape
    T, Fq, C = d.max_frames, d.n_mels, m.nb_filters[0]
    x = t(rng.standard_normal((B, T, Fq)))
    lim = np.sqrt(2.0) * np.sqrt(6.0 / (9 * (1 + C)))
    conv = {"w": t(rng.uniform(-lim, lim, (3, 3, 1, C))), "b": t(0.1 * rng.standard_normal(C))}
    scale, bias = t(1 + 0.1 * rng.standard_normal(C)), t(0.1 * rng.standard_normal(C))
    gw, gb = t(rng.standard_normal((C, C)) / np.sqrt(C)), t(0.1 * rng.standard_normal(C))
    dout = t(rng.standard_normal((B, T // pool[0], Fq // pool[1], C)))
    pixels = B * T * Fq
    shape = [B, T, Fq, C]
    s, sq = fe.entry_block_stats_apply(conv, x)
    mean = s / pixels
    var = sq / pixels - mean * mean
    block = (conv["w"], conv["b"], scale, bias, mean, var, gw, gb)
    x_bytes, out_bytes, small = x.numel() * 4, dout.numel() * 4, (10 * C + C * C + 5 * C) * 4
    conv_ops, mix_ops, elements = 2.0 * 9 * pixels * C, 2.0 * pixels * C * C, float(pixels * C)
    mask = fb.dropout_keep_mask(seed, shape, rate, device=device, pack_bits=True)
    res = compare(f"K5f entry_block_fwd train, packed draw, rate {rate} {shape}",
                  lambda: fe.entry_block_fwd(x, *block, pool, eps, **packed),
                  lambda: fe.reference_entry_block(x, *block, pool, eps, mask, keep), atol=1e-5)
    rows["entry_block_fwd_train_packed"].add(shape, res, x_bytes + out_bytes + small,
                                             conv_ops + mix_ops + 14.0 * elements)  # entry_kernels' counts
    fused = fe.entry_block_fwd(x, *block, pool, eps, **packed)
    pair = fb.fused_bn_glu_pool(ec.entry_conv_reference(conv, x)[0], scale, bias, mean, var, gw, gb, pool, eps,
                                **packed)
    err = (fused - pair).abs().max().item()
    if not err <= 1e-5:
        raise AssertionError(f"K5f packed against F.conv2d -> K2f packed with the same seed: {err} exceeds 1e-5")
    print(f"  K5f packed equals F.conv2d -> K2f packed with the same seed within {err:.3e} (limit 1e-5)")
    del fused, pair
    res = compare(f"K5b1 entry_block_bwd_reduce, packed draw, rate {rate} {shape} (d glu_w, d glu_b, S1, S2)",
                  lambda: fe.entry_block_bwd_reduce(x, dout, *block, pool, eps, **packed),
                  lambda: fe.entry_block_bwd_reduce_reference(x, dout, *block, pool, eps, mask, keep),
                  rtol_of_max=1e-4, repeat=True)
    rows["entry_block_bwd_reduce_packed"].add(shape, res, x_bytes + out_bytes + 2 * small,
                                              conv_ops + 3 * mix_ops + 22.0 * elements)

    # the packed keep-mask kernel (a test helper): bit for bit, and its keep share
    got = fb.dropout_mask(seed, shape, rate, device, pack_bits=True)
    if not torch.equal(got, mask):
        raise AssertionError("dropout_mask kernel (packed draw) differs from dropout_keep_mask(pack_bits=True)")
    n = got.numel()
    p_keep = 1.0 - fb.dropout_threshold(rate, True) / 256.0
    share = got.double().mean().item()
    if not abs(share - p_keep) < 5.0 * np.sqrt(p_keep * (1 - p_keep) / n):
        raise AssertionError(f"packed keep share {share} is not within 5 sigma of {p_keep}")
    mask_ms = time_ms(lambda: fb.dropout_mask(seed, shape, rate, device, pack_bits=True))
    mask_device_ms = device_ms(lambda: fb.dropout_mask(seed, shape, rate, device, pack_bits=True))
    plain_ms = time_ms(lambda: fb.dropout_keep_mask(seed, shape, rate, device=device, pack_bits=True), warmup=1,
                       runs=3)
    mask_bound, _ = bound_ms(n * 4, 0.0)
    print(f"  dropout_mask packed {shape}: bit-equal to dropout_keep_mask(pack_bits=True); keep share {share:.6f} "
          f"(1 - t8/256 = {p_keep:.6f}); kernel {mask_ms:.4f} ms ({shown(mask_device_ms)} ms of it on the device), "
          f"plain {plain_ms:.4f} ms, bound {mask_bound:.4f} ms (bytes)")
    del got, mask, x, dout
    torch.cuda.empty_cache()
    return [{"name": "dropout_mask_packed", "route": "cuda", "source": CSRC + "entry_block.cu",
             "replaces": "tests/test_fused_block.py:227", "launches": None, "max_abs_err": 0.0, "ms": mask_ms,
             "device_ms": mask_device_ms, "plain_ms": plain_ms, "bound_ms": mask_bound, "bound_by": "bytes",
             "library_ms": None, "keep_share": share}]


def entry_pool_slack(y, scale, bias, mean, var, w, b, pool, eps, mask=None, keep=1.0, layout="planes"):
    """Slack of the fused first block's bf16 pooled output: `pool_slack`'s
    terms, with one rounding after a float32 sum flipped where `layout`
    rounds (a pt-row column sum for "planes", each g for "crows"), plus one
    conv output y rounding to the other bfloat16 neighbour (the kernel's and
    the plain version's nine-term sums differ in the last bit now and then):
    Δxn = ulp(max|y|)·max|inv·γ| moves lin by Δxn·max|W| and the gate by
    Δxn·max|lin|/4, over pt·pf."""
    import torch

    inv = torch.rsqrt(var + eps)
    xn = (y.float() - mean) * inv * scale + bias
    lin = xn.bfloat16().float() @ w.bfloat16().float() + b
    dxn = bf16_ulp(y.float().abs().max()).item() * (inv * scale).abs().max().item()
    y_flip = dxn * (w.abs().max().item() + lin.abs().max().item() / 4) / (keep * pool[0] * pool[1])
    if layout == "planes":
        del xn, lin
        return pool_slack(y, scale, bias, mean, var, w, b, pool, eps, mask, keep) + y_flip
    g = lin * torch.sigmoid(xn)
    del lin
    if mask is not None:
        g = g * mask * (1.0 / keep)
    B, T, F, C = g.shape
    pt, pf = pool
    top = g.reshape(B, T // pt, pt, F // pf, pf, C).abs().amax(dim=(2, 4))
    xn_max, w_max = xn.abs().max().item(), w.abs().max().item()
    del g, xn
    return bf16_ulp(top) + (flip_slack(xn_max, w_max) + sum_slack(C, xn_max, w_max)) / (keep * pt * pf) + y_flip


def conv9_order_bf16(conv, x):
    """The bfloat16 entry conv formed in conv9's order (csrc/entry_block.cu):
    y = bf16(((cb + x00 w00) + x01 w01) + ...), the taps dt-major, in
    float32 tensor operations on x's device. A product of a bfloat16 x and
    a bfloat16-rounded weight is exact in float32, so each step rounds once,
    as an FMA does: the kernels' y to the bit."""
    import torch
    import torch.nn.functional as F

    from dcase2019_task4_tpu_torch.ops import _build

    B, T, Fq = x.shape
    w = _build.round_to(conv["w"], torch.bfloat16)
    xp = F.pad(x.float(), (1, 1, 1, 1))
    y = conv["b"].float().expand(B, T, Fq, -1).contiguous()
    for dt in range(3):
        for df in range(3):
            y = y + xp[:, dt:dt + T, df:df + Fq, None] * w[dt, df, 0]
    return y.to(torch.bfloat16)


def entry_bf16_kernels(device, rows, rng):
    """Phase 3 for the bfloat16 modes of the entry-block family at the
    flagship block-1 shape (x [B, 864, 64] -> y [B, 864, 64, 64] -> pooled
    [B, 432, 16, 64]), as the flagship bfloat16 model hands them over: the
    features cast to bfloat16, float32 parameters, bfloat16 cotangents.
    Every kernel against its plain version, which rounds where the kernel
    rounds; the folds repeated bit for bit; the crows entries bit for bit
    as the fused entry block's wrappers in the crows layout. Bounds count
    the conv's nine-tap and the GLU's C×C products on bfloat16 operands
    (989 TFLOP/s), the rest at 67 TFLOP/s, bfloat16 tensors at two bytes a
    value."""
    import torch

    from dcase2019_task4_tpu_torch.config import Config
    from dcase2019_task4_tpu_torch.models import layers as L
    from dcase2019_task4_tpu_torch.ops import crows_block as cr
    from dcase2019_task4_tpu_torch.ops import entry_conv as ec
    from dcase2019_task4_tpu_torch.ops import fused_block as fb
    from dcase2019_task4_tpu_torch.ops import fused_entry_block as fe

    cfg = Config()
    d, m = cfg.dsp, cfg.model
    B, T, Fq, C = cfg.train.batch_size, d.max_frames, d.n_mels, m.nb_filters[0]
    pool, eps, rate = tuple(m.pooling[0]), m.bn_eps, m.dropout
    bf16, keep = torch.bfloat16, 1.0 - rate

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    x = t(rng.standard_normal((B, T, Fq))).to(bf16)
    lim = np.sqrt(2.0) * np.sqrt(6.0 / (9 * (1 + C)))
    conv = {"w": t(rng.uniform(-lim, lim, (3, 3, 1, C))), "b": t(0.1 * rng.standard_normal(C))}
    scale, bias = t(1 + 0.1 * rng.standard_normal(C)), t(0.1 * rng.standard_normal(C))
    gw, gb = t(rng.standard_normal((C, C)) / np.sqrt(C)), t(0.1 * rng.standard_normal(C))
    run_mean, run_var = t(0.2 * rng.standard_normal(C)), t(rng.uniform(0.5, 2.0, C))
    dy = t(rng.standard_normal((B, T, Fq, C))).to(bf16)
    dout = t(rng.standard_normal((B, T // pool[0], Fq // pool[1], C))).to(bf16)
    seed = torch.tensor([20190416], dtype=torch.int64)
    pixels = B * T * Fq
    shape = [B, T, Fq, C]
    x_bytes, y_bytes, out_bytes = x.numel() * 2, pixels * C * 2, dout.numel() * 2
    small = (10 * C + C * C + 5 * C) * 4
    conv_ops, mix_ops = 2.0 * 9 * pixels * C, 2.0 * pixels * C * C
    elements = float(pixels * C)  # per element of the chain: see entry_kernels
    fwd_eval_ops, fwd_train_ops = (10 + 2) * elements, (10 + 2 + 2) * elements
    pass1_ops, pass2_ops = (10 + 8 + 4) * elements, (10 + 8 + 6) * elements
    w_oihw = conv["w"].permute(3, 2, 0, 1).contiguous()
    x_max, w_max = x.float().abs().max().item(), conv["w"].abs().max().item()

    # K4f: y in bfloat16 and the float32 sums of y as stored; the library is the
    # default bfloat16 path's own conv (cuDNN, bias added in bfloat16)
    res = compare(f"K4f entry_conv bf16 {shape} (y bf16, sum, sum of squares)",
                  lambda: ec.entry_conv_forward(conv, x), lambda: ec.entry_conv_reference(conv, x),
                  tols=[("ulp", sum_slack(9, x_max, w_max)), ("max", 1e-5), ("max", 1e-5)], repeat=True,
                  library_fn=lambda: L.conv2d(w_oihw, conv["b"], x[..., None]))
    rows["entry_conv_bf16"].add(shape, res, x_bytes + y_bytes + small, 3.0 * pixels * C, conv_ops)
    y, s1, s2 = ec.entry_conv_forward(conv, x)
    if not torch.equal(y, conv9_order_bf16(conv, x)):
        raise AssertionError("K4f bf16 y differs from the y formed in conv9's order (K5f bf16 = K4f -> K2f rests on it)")
    print("  K4f bf16 y equals, bit for bit, the y formed in conv9's order on the card")
    # K5s: the bound counts the conv on bfloat16 operands at the tensor cores'
    # rate; the kernel's conv stays in conv9's order of FP32 FMAs (K5f bf16's
    # bits rest on it), whose floor, the conv at the FP32 rate, is printed too
    res = compare(f"K5s entry_block_stats bf16 {shape} (sum, sum of squares of the rounded y; y not written)",
                  lambda: fe.entry_block_stats_apply(conv, x), lambda: ec.entry_conv_reference(conv, x)[1:],
                  rtol_of_max=1e-5, repeat=True)
    rows["entry_block_stats_bf16"].add(shape, res, x_bytes + small, 3.0 * pixels * C, conv_ops)
    floor = bound_ms(x_bytes + small, conv_ops + 3.0 * pixels * C)[0]
    print(f"  K5s bf16 {shape}: floor of a conv of FP32 FMAs {floor:.4f} ms, beside its bound "
          f"{bound_ms(x_bytes + small, 3.0 * pixels * C, conv_ops)[0]:.4f} ms")
    k2s = fb.batch_stats(y)
    stats = fe.entry_block_stats_apply(conv, x)
    if not all(torch.equal(p, q) for p, q in zip(stats, (s1, s2))):
        raise AssertionError("K5s bf16 sums differ from K4f bf16's: the two modes must split the batch alike")
    for name, sums in (("K4f", (s1, s2)), ("K5s", stats)):
        for got, want in zip(sums, k2s):
            err, limit = (got - want).abs().max().item(), 1e-6 * want.abs().max().item()
            if not err <= limit:
                raise AssertionError(f"{name} bf16 sums against batch_stats(y): {err} exceeds {limit}")
    print("  K5s bf16 sums equal K4f bf16's bit for bit, and both K2s batch_stats of the stored bfloat16 y within "
          "1e-6 of max")
    mean = s1 / float(pixels)
    var = s2 / float(pixels) - mean * mean

    # K4w: dW of the bfloat16 weights in two output-frequency parities, db float32
    w_leaf, b_leaf = w_oihw.clone().requires_grad_(True), conv["b"].clone().requires_grad_(True)
    y_graph = L.conv2d(w_leaf, b_leaf, x[..., None])

    def library_wgrad():
        return torch.autograd.grad(y_graph, (w_leaf, b_leaf), dy, retain_graph=True)

    parts = ec.entry_conv_wgrad_parts_reference(x, dy)
    slack = sum(bf16_ulp(p) for p in parts)
    res = compare(f"K4w entry_conv_wgrad bf16 {shape} (dW per output-frequency parity, db)",
                  lambda: ec.entry_conv_wgrad(x, dy), lambda: ec.entry_conv_wgrad_reference(x, dy),
                  tols=[("parts", slack), ("max", 1e-4)], repeat=True, library_fn=library_wgrad)
    rows["entry_conv_wgrad_bf16"].add(shape, res, x_bytes + y_bytes + small, 1.0 * pixels * C, conv_ops)
    check_parts("K4w bf16 output-frequency parities", lambda: ec.entry_conv_wgrad_parts(x, dy), parts)
    del dy, y_graph, w_leaf, b_leaf, slack, parts

    # K5f: eval (running statistics) and train (batch statistics, dropout), planes rounding
    block = (conv["w"], conv["b"], scale, bias)
    y_ref = ec.entry_conv_reference(conv, x)[0]
    slack = entry_pool_slack(y_ref, scale, bias, run_mean, run_var, gw, gb, pool, eps)
    res = compare(f"K5f entry_block_fwd eval bf16 {shape}",
                  lambda: fe.entry_block_fwd(x, *block, run_mean, run_var, gw, gb, pool, eps),
                  lambda: fe.reference_entry_block(x, *block, run_mean, run_var, gw, gb, pool, eps),
                  tols=[("ulp", slack)])
    rows["entry_block_fwd_eval_bf16"].add(shape, res, x_bytes + out_bytes + small, fwd_eval_ops, conv_ops + mix_ops)
    mask = fb.dropout_keep_mask(seed, shape, rate, device=device)
    slack = entry_pool_slack(y_ref, scale, bias, mean, var, gw, gb, pool, eps, mask, keep)
    res = compare(f"K5f entry_block_fwd train bf16 rate {rate} {shape}",
                  lambda: fe.entry_block_fwd(x, *block, mean, var, gw, gb, pool, eps, rate=rate, seed=seed),
                  lambda: fe.reference_entry_block(x, *block, mean, var, gw, gb, pool, eps, mask, keep),
                  tols=[("ulp", slack)])
    rows["entry_block_fwd_train_bf16"].add(shape, res, x_bytes + out_bytes + small, fwd_train_ops, conv_ops + mix_ops)
    # the planes layout runs K2f's bfloat16 tile code on the same bfloat16 y:
    # K5f equals K4f -> K2f with the same seed bit for bit
    for r in (0.0, rate):
        fused = fe.entry_block_fwd(x, *block, mean, var, gw, gb, pool, eps, rate=r, seed=seed)
        pair = fb.fused_bn_glu_pool(y, scale, bias, mean, var, gw, gb, pool, eps, rate=r, seed=seed)
        if not torch.equal(fused, pair):
            raise AssertionError(f"K5f bf16 rate {r} differs from K4f -> K2f bf16 with the same seed: largest "
                                 f"difference {(fused.float() - pair.float()).abs().max().item():.3e}")
        print(f"  K5f bf16 rate {r} equals K4f -> K2f bf16 with the same seed bit for bit")
    del fused, pair, slack

    # K5b1, K5b2: the two backward passes with the host-side step between them
    args = (x, dout, *block, mean, var, gw, gb)
    res = compare(f"K5b1 entry_block_bwd_reduce bf16 rate {rate} {shape} (d glu_w, d glu_b, S1, S2 float32)",
                  lambda: fe.entry_block_bwd_reduce(*args, pool, eps, rate=rate, seed=seed),
                  lambda: fe.entry_block_bwd_reduce_reference(*args, pool, eps, mask, keep),
                  rtol_of_max=1e-4, repeat=True)
    rows["entry_block_bwd_reduce_bf16"].add(shape, res, x_bytes + out_bytes + 2 * small, pass1_ops,
                                            conv_ops + 3 * mix_ops)  # conv; lin, dxn, d glu_w
    dgw, dgb, r1, r2 = fe.entry_block_bwd_reduce(*args, pool, eps, rate=rate, seed=seed)
    a, b2 = fb.bwd_coefficients(scale, var, eps, r1, r2, pixels)
    # K5b1 runs K2b's bfloat16 tile code (csrc/bf16_tile.cuh) on the y it
    # computes: against K4f -> K2b's reduce pass without dy_partial, same seed
    pair = fb.bwd_reduce(y, dout, scale, bias, mean, var, gw, gb, pool, eps, rate=rate, seed=seed, recompute=True)[1:]
    same = all(torch.equal(p, q) for p, q in zip((dgw, dgb, r1, r2), pair))
    worst = max((p - q).abs().max().item() / q.abs().max().item() for p, q in zip((dgw, dgb, r1, r2), pair))
    if not worst <= 1e-4:
        raise AssertionError(f"K5b1 bf16 against K4f -> K2b reduce bf16: {worst} of max exceeds 1e-4")
    print("  K5b1 bf16 against K4f -> K2b reduce bf16 without dy_partial, same seed: "
          + ("bit-equal" if same else f"largest difference {worst:.3e} of max (the same tile code on the same y, "
                                      "summed over other runs of tiles)"))
    del pair

    def pass2_slacks(layout):
        """dW: one ulp of each part's sum plus one dy element rounding the
        other way (ulp(max|dy|)·max|x|); d conv_b, zero in exact arithmetic,
        is held to 1e-4 of its max plus the float32 rounding of its sum over
        the pixels (n·max|dy|·2^-24); and the plain part sums with that one
        dy flip, for `check_parts`."""
        dyv, _ = fe._pass2_dy(x, dout, *block, mean, var, gw, gb, a, b2, pool, eps, mask, keep)
        dy_max = dyv.abs().max().item()
        del dyv
        parts = fe.entry_block_bwd_wgrad_parts_reference(x, dout, *block, mean, var, gw, gb, a, b2, pool, eps, mask,
                                                         keep, layout)
        flip = bf16_ulp(torch.tensor(dy_max)).item() * x_max
        return sum(bf16_ulp(p) for p in parts) + flip, sum_slack(pixels, dy_max, 1.0), parts, flip

    def with_floor(plain, floor):
        return lambda: (plain(), (0.0, floor))

    dw_slack, dcb_floor, parts, flip = pass2_slacks("planes")
    plain2 = lambda: fe.entry_block_bwd_wgrad_reference(*args, a, b2, pool, eps, mask, keep)  # noqa: E731
    res = compare(f"K5b2 entry_block_bwd_wgrad bf16 rate {rate} {shape} (dW per output-frequency parity, d conv_b)",
                  lambda: fe.entry_block_bwd_wgrad(*args, a, b2, pool, eps, rate=rate, seed=seed), plain2,
                  tols=[("parts", dw_slack), ("max", 1e-4)], repeat=True, exact_fn=with_floor(plain2, dcb_floor))
    rows["entry_block_bwd_wgrad_bf16"].add(shape, res, x_bytes + out_bytes + 2 * small, pass2_ops,
                                           2 * conv_ops + 2 * mix_ops)  # conv, dW; lin, dxn
    check_parts("K5b2 bf16 output-frequency parities",
                lambda: fe.entry_block_bwd_wgrad_parts(*args, a, b2, pool, eps, rate=rate, seed=seed), parts, flip)

    # K6 in bfloat16: the crows entries (their gate, counting and Function)
    # with the crows mode bits: pool of element-rounded g, dW in batch halves
    def same_bits(what, outs, wants):
        for out, want in zip(outs, wants):
            if not torch.equal(out, want):
                raise AssertionError(f"{what} differs from the fused entry block's own wrapper in the crows layout")

    res = compare(f"K6 crows_stats_apply bf16 {shape}", lambda: cr.crows_stats_apply(conv, x),
                  lambda: ec.entry_conv_reference(conv, x)[1:], rtol_of_max=1e-5, repeat=True)
    rows["crows_stats_bf16"].add(shape, res, x_bytes + small, 3.0 * pixels * C, conv_ops)
    same_bits("crows_stats_apply bf16", cr.crows_stats_apply(conv, x), fe.entry_block_stats_apply(conv, x))
    slack = entry_pool_slack(y_ref, scale, bias, mean, var, gw, gb, pool, eps, mask, keep, "crows")
    crows_fwd = lambda: cr.crows_apply(conv, scale, bias, mean, var, gw, gb, x, seed, rate, pool, eps, True)  # noqa: E731
    res = compare(f"K6 crows_apply forward bf16 rate {rate} {shape} (each g rounded before the window sum)", crows_fwd,
                  lambda: fe.reference_entry_block(x, *block, mean, var, gw, gb, pool, eps, mask, keep, "crows"),
                  tols=[("ulp", slack)])
    rows["crows_fwd_bf16"].add(shape, res, x_bytes + out_bytes + small, fwd_train_ops, conv_ops + mix_ops)
    same_bits("crows_apply forward bf16", [crows_fwd()],
              [fe.entry_block_fwd(x, *block, mean, var, gw, gb, pool, eps, rate=rate, seed=seed, layout="crows")])
    del slack, y_ref
    dw_slack_c, dcb_floor_c, parts, flip = pass2_slacks("crows")
    plain2c = lambda: fe.entry_block_bwd_wgrad_reference(*args, a, b2, pool, eps, mask, keep, "crows")  # noqa: E731
    res = compare(f"K6 pass 2 bf16 rate {rate} {shape} (dW in batch halves, d conv_b)",
                  lambda: fe.entry_block_bwd_wgrad(*args, a, b2, pool, eps, rate=rate, seed=seed, layout="crows"),
                  plain2c, tols=[("parts", dw_slack_c), ("max", 1e-4)], repeat=True,
                  exact_fn=with_floor(plain2c, dcb_floor_c))
    rows["crows_bwd_wgrad_bf16"].add(shape, res, x_bytes + out_bytes + 2 * small, pass2_ops,
                                     2 * conv_ops + 2 * mix_ops)
    check_parts("K6 pass 2 bf16 batch halves",
                lambda: fe.entry_block_bwd_wgrad_parts(*args, a, b2, pool, eps, rate=rate, seed=seed, layout="crows"),
                parts, flip)
    del parts
    leaves = [v.clone().requires_grad_(True) for v in (*block, gw, gb)]
    cr.crows_apply({"w": leaves[0], "b": leaves[1]}, leaves[2], leaves[3], mean, var, leaves[4], leaves[5], x, seed,
                   rate, pool, eps, True).backward(dout)
    dw_c, dcb_c, dscale_c, dbias_c, dgw_c, dgb_c = (leaf.grad for leaf in leaves)
    same_bits("crows_apply backward bf16, pass 1", (dgw_c, dgb_c, dbias_c, dscale_c), (dgw, dgb, r1, r2))
    same_bits("crows_apply backward bf16, pass 2", (dw_c, dcb_c),
              fe.entry_block_bwd_wgrad(*args, a, b2, pool, eps, rate=rate, seed=seed, layout="crows"))
    # pass 1 is the planes kernel's (no crows mode bit): its row holds that
    # kernel's times and this call's bits
    rows["crows_bwd_reduce_bf16"] = copy.copy(rows["entry_block_bwd_reduce_bf16"])
    print(f"  K6 crows_apply bf16 backward through its Function: pass 1 bit for bit as entry_block_bwd_reduce, pass 2 "
          f"as entry_block_bwd_wgrad(layout='crows')")
    del leaves, mask, args, dw_slack, dw_slack_c
    torch.cuda.empty_cache()


def fixup_recompute_row(row, y, dout, vecs, pool, eps, rate, seed, mask):
    """K2b's recompute fixup at one shape, as the knobs paths run it (the
    packed draw at `rate`, `mask` its keep-mask): a and b2 from the first
    pass without dy_partial, then dy against `bwd_fixup_recompute_reference`
    (float32: 1e-4 of max; bfloat16: rounded once, one ulp plus the slack of
    dxn's two channel products and of dy's three float32 terms), a repeat
    bit for bit; added to `row` with its bytes (y and dout in, dy out, the
    parameters) and operations (two channel products, 22 an element: up to
    dxn 17 as in `knob_kernels`, dy 5)."""
    import torch

    from dcase2019_task4_tpu_torch.ops import fused_block as fb

    scale, bias, mean, var, w, gb = vecs
    B, T, Fq, C = y.shape
    keep, bf16 = 1.0 - rate, y.dtype == torch.bfloat16
    packed = dict(rate=rate, seed=seed, pack_bits=True)
    _, _, _, s1, s2 = fb.bwd_reduce(y, dout, *vecs, pool, eps, recompute=True, **packed)
    a, b2 = fb.bwd_coefficients(scale, var, eps, s1, s2, B * T * Fq)
    tols = dict(rtol_of_max=1e-4)
    if bf16:
        ref = fb.bwd_fixup_recompute_reference(y, dout, *vecs, a, b2, pool, eps, mask, keep)
        tols = dict(tols=[("ulp", dyp_slack(y, dout, scale, bias, mean, var, w, pool, eps, keep)
                           + 4 * EPS32 * (ref.float().abs().max().item() + a.abs().max().item()
                                          + (y.float() - mean).abs().max().item() * b2.abs().max().item()))])
        del ref
    res = compare(f"K2b bwd_fixup_recompute{' bf16' if bf16 else ''}, packed draw {list(y.shape)} pool {pool}",
                  lambda: fb.bwd_fixup_recompute(y, dout, *vecs, a, b2, pool, eps, **packed),
                  lambda: fb.bwd_fixup_recompute_reference(y, dout, *vecs, a, b2, pool, eps, mask, keep),
                  repeat=True, **tols)
    n_bytes = (2 * y.numel() + dout.numel()) * y.element_size() + (C * C + 7 * C) * 4
    mix_ops, elementwise = 2.0 * B * T * Fq * C * C, 22.0 * y.numel()
    row.add(list(y.shape), res, n_bytes, *((elementwise, 2 * mix_ops) if bf16 else (2 * mix_ops + elementwise,)))
    return res


def cold_fixup_device_ms(y, dyp, a, b2, mean, shape, l2_bytes: float = 50e6) -> Optional[float]:
    """Device time of K2b's fixup with its inputs out of the L2: the call
    walks in turn through copies of (y, dy_partial) that hold together more
    than twice the 50 MB L2, so each traced call reads tensors that the
    calls before it have evicted. The fixup writes over its dy_partial; the
    values drift from call to call, the bytes moved do not."""
    import torch

    from dcase2019_task4_tpu_torch.ops import fused_block as fb

    per_set = 2 * y.numel() * y.element_size()
    n_sets = max(2, int(np.ceil(2 * l2_bytes / per_set)) + 1)
    sets = [(y.clone(), dyp.clone()) for _ in range(n_sets)]
    turn = [0]

    def next_call():
        yk, dk = sets[turn[0] % n_sets]
        turn[0] += 1
        fb.bwd_fixup(yk, dk, a, b2, mean)

    for _ in range(n_sets):  # one pass through every set before the traces
        next_call()
    on_device = device_ms(next_call, only="bn_bwd_fixup_kernel")
    print(f"  K2b bwd_fixup bf16 {shape}: {shown(on_device)} ms on the device with the inputs out of the L2 "
          f"({n_sets} sets of {per_set / 1e6:.1f} MB in turn)")
    del sets
    torch.cuda.empty_cache()
    return on_device


def block_geometries(cfg):
    """(T, F) of the activation at each of the three conv blocks of `cfg`."""
    d, m = cfg.dsp, cfg.model
    geometries = [(d.max_frames, d.n_mels)]
    for pt, pf in [tuple(p) for p in m.pooling][:2]:
        geometries.append((geometries[-1][0] // pt, geometries[-1][1] // pf))
    return geometries


def k3_bf16_kernels(device, rows, rng, cfg, suffix: str = ""):
    """The bfloat16 rows of K3 (forward, dx, wgrad) at blocks 2 and 3 of
    `cfg`, batch 24: products of bfloat16 operands (9·C per output),
    float32 sums, bytes at two a value; the weight gradient's class sums
    read from the kernel (`check_parts`)."""
    import torch
    import torch.nn.functional as F

    from dcase2019_task4_tpu_torch.ops import packed_conv as pc

    B, C = cfg.train.batch_size, cfg.model.nb_filters[1]
    bf16 = torch.bfloat16

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    for T, Fq in block_geometries(cfg)[1:]:
        lim = np.sqrt(2.0) * np.sqrt(6.0 / (18 * C))
        w, b = t(rng.uniform(-lim, lim, (3, 3, C, C))), t(0.1 * rng.standard_normal(C))
        params = {"w": w, "b": b}
        x, dy = t(rng.standard_normal((B, T, Fq, C))).to(bf16), t(rng.standard_normal((B, T, Fq, C))).to(bf16)
        w_oihw = w.permute(3, 2, 0, 1).contiguous().to(bf16)
        x_cl, dy_cl = (v.permute(0, 3, 1, 2) for v in (x, dy))  # NCHW views in channels-last memory
        act_bytes, conv_ops = x.numel() * 2, 2.0 * x.numel() * 9 * C
        shape = list(x.shape)
        taps = 9 * C
        res = compare(f"K3f conv2d_forward bf16 {shape}", lambda: pc.conv2d_forward(params, x),
                      lambda: pc.conv2d_reference(params, x),
                      tols=[("ulp", sum_slack(taps, x.abs().max().item(), w.abs().max().item()))],
                      library_fn=lambda: F.conv2d(x_cl, w_oihw, b.to(bf16), padding=1))
        rows["conv2d_forward_bf16" + suffix].add(shape, res, 2 * act_bytes + w.numel() * 4, 0.0, conv_ops)
        res = compare(f"K3dx conv2d_dx bf16 {shape}", lambda: pc.conv2d_dx(w, dy),
                      lambda: pc.conv2d_dx_reference(w, dy),
                      tols=[("ulp", sum_slack(taps, dy.abs().max().item(), w.abs().max().item()))],
                      library_fn=lambda: torch.nn.grad.conv2d_input(x_cl.shape, w_oihw, dy_cl, padding=1))
        rows["conv2d_dx_bf16" + suffix].add(shape, res, 2 * act_bytes + w.numel() * 4, 0.0, conv_ops)
        # the gradient of the bfloat16 weights: each output-frequency class's sum
        # rounded (k lane copies in the original; the whole sum at k = 1): on
        # top of dW's own ulp, per class one ulp of its sum and the float32
        # bar of the class sums, 1e-4 of their max (a sum over B·T·F/k
        # pixels that cancels near zero differs between the two versions by
        # many of its own ulps); the kernel's class sums held by check_parts
        k = pc.pack_factor(Fq, C)
        parts = pc.conv2d_wgrad_parts_reference(x, dy)
        slack = sum(bf16_ulp(p) for p in parts) + k * 1e-4 * parts.abs().max().item()
        res = compare(f"K3w conv2d_wgrad bf16 {shape}, {k} output-frequency class(es) (dW of the bfloat16 weights, "
                      f"db float32)", lambda: pc.conv2d_wgrad(x, dy), lambda: pc.conv2d_wgrad_reference(x, dy),
                      tols=[("parts", slack), ("max", 1e-4)], repeat=True,
                      library_fn=lambda: torch.nn.grad.conv2d_weight(x_cl, w_oihw.shape, dy_cl, padding=1))
        check_parts(f"K3w bf16 {shape} output-frequency classes", lambda: pc.conv2d_wgrad_parts(x, dy), parts)
        del parts, slack
        rows["conv2d_wgrad_bf16" + suffix].add(shape, res, 2 * act_bytes + (w.numel() + C) * 4, 0.0, conv_ops)
        del x, dy, x_cl, dy_cl
        torch.cuda.empty_cache()


def stats_bf16_exact(y, sums):
    """K2s on bfloat16 y (stats_bf16_kernel, float32 sums over runs of 64 of
    a thread's rows) held to the float64 sums of y, each channel within 1e-6
    relative."""
    yd = y.double()
    errs = []
    for name, got, want in zip(("sum y", "sum y^2"), sums, (yd.sum(dim=(0, 1, 2)), (yd * yd).sum(dim=(0, 1, 2)))):
        errs.append(((got.double() - want).abs() / want.abs()).max().item())
        if not errs[-1] <= 1e-6:
            raise AssertionError(f"K2s bf16 {list(y.shape)} {name}: {errs[-1]:.3e} relative to the float64 sums")
    print(f"  K2s bf16 {list(y.shape)}: sum y, sum y^2 within {errs[0]:.2e}, {errs[1]:.2e} relative of the float64 "
          "sums (bar 1e-6)")


def bf16_block_kernels(device, rows, rng, cfg, suffix: str = "", with_k3: bool = True):
    """Phase 3 for the bfloat16 modes of K3 and K2 at a configuration's
    shapes, rows named with `suffix`: the scaled configuration's (K3 at
    blocks 2 and 3, [B, 432, 32, 128] and [B, 216, 8, 128]; K2 at the three
    blocks, [B, 864, 128, 128] and [B, 432, 32, 128] with pool (2, 4),
    [B, 216, 8, 128] with pool (2, 8)), or the flagship's (K3 at
    [B, 432, 16, 64] and [B, 216, 4, 64], where its weight gradient rounds
    per output-frequency class; K2 at [B, 864, 64, 64], [B, 432, 16, 64],
    [B, 216, 4, 64]), batch 24, bfloat16 activations and float32 parameters,
    as a bfloat16 model hands them over; K2's alone without `with_k3`."""
    import torch

    from dcase2019_task4_tpu_torch.ops import fused_block as fb

    m = cfg.model
    B, C, eps, rate = cfg.train.batch_size, m.nb_filters[1], m.bn_eps, m.dropout
    bf16 = torch.bfloat16

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    pools = [tuple(p) for p in m.pooling]
    geometries = block_geometries(cfg)
    if with_k3:
        k3_bf16_kernels(device, rows, rng, cfg, suffix)

    # K2 at the three blocks: the C×C channel products on bfloat16 operands, the
    # rest float32; y, dout, the pooled output, dy_partial and dy at two bytes a value
    seed = torch.tensor([20190415], dtype=torch.int64)
    for (T, Fq), pool in zip(geometries, pools):
        y = t(rng.standard_normal((B, T, Fq, C))).to(bf16)
        scale, bias = t(1 + 0.1 * rng.standard_normal(C)), t(0.1 * rng.standard_normal(C))
        w, gb = t(rng.standard_normal((C, C)) / np.sqrt(C)), t(0.1 * rng.standard_normal(C))
        run_mean, run_var = t(0.2 * rng.standard_normal(C)), t(rng.uniform(0.5, 2.0, C))
        dout = t(rng.standard_normal((B, T // pool[0], Fq // pool[1], C))).to(bf16)
        shape, pixels = list(y.shape), B * T * Fq
        y_bytes, out_bytes, small = y.numel() * 2, dout.numel() * 2, (C * C + 5 * C) * 4
        mix_ops = 2.0 * pixels * C * C
        vecs = (scale, bias, run_mean, run_var, w, gb)

        slack = pool_slack(y, *vecs, pool, eps)
        res = compare(f"K2f fused_bn_glu_pool eval bf16 {shape} pool {pool}",
                      lambda: fb.fused_bn_glu_pool(y, *vecs, pool, eps),
                      lambda: fb.reference_block(y, *vecs, pool, eps), tols=[("ulp", slack)])
        rows["fused_bn_glu_pool_eval_bf16" + suffix].add(shape, res, y_bytes + out_bytes + small, 12.0 * y.numel(), mix_ops)
        del slack

        res = compare(f"K2s batch_stats bf16 {shape}", lambda: fb.batch_stats(y), lambda: fb.batch_stats_reference(y),
                      rtol_of_max=1e-5, repeat=True, library_fn=lambda: torch.var_mean(y, dim=(0, 1, 2), correction=0))
        rows["batch_stats_bf16" + suffix].add(shape, res, y_bytes + 2 * C * 4, 3.0 * y.numel())
        s, sq = fb.batch_stats(y)
        stats_bf16_exact(y, (s, sq))
        mean = s / pixels
        var = sq / pixels - mean * mean

        mask = fb.dropout_keep_mask(seed, y.shape, rate, device=device)
        slack = pool_slack(y, scale, bias, mean, var, w, gb, pool, eps, mask, 1.0 - rate)
        res = compare(f"K2f fused_bn_glu_pool train bf16 rate {rate} {shape} pool {pool}",
                      lambda: fb.fused_bn_glu_pool(y, scale, bias, mean, var, w, gb, pool, eps, rate=rate, seed=seed),
                      lambda: fb.reference_block(y, scale, bias, mean, var, w, gb, pool, eps, mask, 1.0 - rate),
                      tols=[("ulp", slack)])
        rows["fused_bn_glu_pool_train_bf16" + suffix].add(shape, res, y_bytes + out_bytes + small, 14.0 * y.numel(), mix_ops)
        del slack
        # the mask alone, as at float32: g = mask / (2·keep) in each window
        unit = (torch.ones(C, device=device), torch.zeros(C, device=device), torch.zeros(C, device=device),
                torch.ones(C, device=device), torch.zeros(C, C, device=device), torch.ones(C, device=device))
        pooled = fb.fused_bn_glu_pool(torch.zeros_like(y), *unit, pool, eps, rate=rate, seed=seed)
        kept = pooled.double().sum().item() * pool[0] * pool[1] * 2.0 * (1.0 - rate)
        n_kept = int(mask.sum(dtype=torch.float64).item())
        if round(kept) != n_kept:
            raise AssertionError(f"K2f train bf16 {shape}: kernel kept {kept} elements, dropout_keep_mask {n_kept}")
        print(f"  K2f train bf16 {shape}: kept {n_kept} of {mask.numel()} elements, as dropout_keep_mask")

        slack = dyp_slack(y, dout, scale, bias, mean, var, w, pool, eps, 1.0 - rate)
        res = compare(f"K2b bwd_reduce bf16 rate {rate} {shape} (dy_partial bf16; dw, db, S1, S2 float32)",
                      lambda: fb.bwd_reduce(y, dout, scale, bias, mean, var, w, gb, pool, eps, rate=rate, seed=seed),
                      lambda: fb.bwd_reduce_reference(y, dout, scale, bias, mean, var, w, gb, pool, eps, mask, 1.0 - rate),
                      tols=[("ulp", slack)] + [("max", 1e-4)] * 4, repeat=True)
        rows["bwd_reduce_bf16" + suffix].add(shape, res, 2 * y_bytes + out_bytes + 2 * small, 30.0 * y.numel(), 3 * mix_ops)
        dyp, _, _, s1, s2 = fb.bwd_reduce(y, dout, scale, bias, mean, var, w, gb, pool, eps, rate=rate, seed=seed)
        a, b2 = fb.bwd_coefficients(scale, var, eps, s1, s2, pixels)
        # the same inputs on both sides: what differs is the float32 rounding of three terms
        fix_slack = 4 * EPS32 * (dyp.float().abs().max().item() + a.abs().max().item()
                                 + (y.float() - mean).abs().max().item() * b2.abs().max().item())
        res = compare(f"K2b bwd_fixup bf16 {shape}", lambda: fb.bwd_fixup(y, dyp.clone(), a, b2, mean),
                      lambda: fb.bwd_fixup_reference(y, dyp.clone(), a, b2, mean), tols=[("ulp", fix_slack)],
                      repeat=True, device_only="bn_bwd_fixup_kernel")
        clone_ms = time_ms(lambda: dyp.clone())
        res = res._replace(ms=max(res.ms - clone_ms, 0.0), plain_ms=max(res.plain_ms - clone_ms, 0.0))
        if suffix:  # the tensors of the smaller blocks sit in the 50 MB L2: read it cold
            res = res._replace(device_ms=cold_fixup_device_ms(y, dyp, a, b2, mean, shape))
        rows["bwd_fixup_bf16" + suffix].add(shape, res, 3 * y_bytes, 3.0 * y.numel())
        print(f"  K2b bwd_fixup bf16 {shape}: clone of dy_partial {clone_ms:.4f} ms taken off both times")

        # the recompute fixup (DCASE_FUSED_BWD_RECOMPUTE) with the packed draw, as
        # the knobs paths run it
        pmask = fb.dropout_keep_mask(seed, y.shape, rate, device=device, pack_bits=True)
        fixup_recompute_row(rows["bwd_fixup_recompute_bf16" + suffix], y, dout, (scale, bias, mean, var, w, gb), pool,
                            eps, rate, seed, pmask)
        del pmask

        # the whole backward through the autograd Function against the formulas
        leaves = [v.clone().requires_grad_(True) for v in (y, scale, bias, w, gb)]
        fb.fused_bn_glu_dropout_pool(leaves[0], leaves[1], leaves[2], mean, var, leaves[3], leaves[4],
                                     seed, rate, pool, eps, True).backward(dout)
        ref = fb.bwd_reference(y, dout, scale, bias, mean, var, w, gb, pool, eps, mask, 1.0 - rate)
        ref_dyp = fb.bwd_reduce_reference(y, dout, scale, bias, mean, var, w, gb, pool, eps, mask, 1.0 - rate)[0]
        got, want = leaves[0].grad.float(), ref[0].float()
        limit = bf16_ulp(torch.maximum(got.abs(), want.abs())) + bf16_ulp(ref_dyp) + slack + fix_slack
        if ((got - want).abs() > limit).any():
            raise AssertionError(f"K2b Function bf16 {shape}: dy beyond one ulp of dy and one of dy_partial + slack")
        del got, want, ref_dyp
        for name, leaf, want in zip(("dscale", "dbias", "dw", "db"), leaves[1:], ref[1:]):
            err, limit = (leaf.grad - want).abs().max().item(), 1e-4 * want.abs().max().item()
            if not err <= limit:
                raise AssertionError(f"K2b Function bf16 {shape}: {name} error {err} exceeds {limit}")
        del y, dout, mask, dyp, leaves, ref, pooled
        torch.cuda.empty_cache()
    if suffix == "_flagship":  # K2s at a width of four channels a thread (C % 8 != 0), block 3's geometry
        y = t(np.random.default_rng(SEED + 36).standard_normal((B, *geometries[-1], 36))).to(bf16)
        before = fb.batch_stats.launches_bf16
        sums = fb.batch_stats(y)
        if fb.batch_stats.launches_bf16 != before + 1 or not all(
                torch.equal(p, q) for p, q in zip(sums, fb.batch_stats(y))):
            raise AssertionError(f"K2s bf16 {list(y.shape)}: not one launch, or a repeat gives other bits")
        stats_bf16_exact(y, sums)


def make_clips(n: int, rng):
    """n seeded synthetic 10 s clips → (names, events per clip, audio)."""
    from dcase2019_task4_tpu_torch.config import DEFAULT_CLASSES, Config
    from dcase2019_task4_tpu_torch.data.audio_io import synth_clip

    d = Config().dsp
    names, all_events, clips = [], [], []
    for i in range(n):
        events = []
        for _ in range(int(rng.integers(1, 4))):
            on = float(rng.uniform(0, 8))
            events.append((int(rng.integers(0, len(DEFAULT_CLASSES))), on, on + float(rng.uniform(0.5, 10 - on))))
        name = f"clip_{i:03d}.wav"
        names.append(name)
        all_events.append(events)
        clips.append(np.clip(synth_clip(name, events, d.max_len_seconds, d.sample_rate), -1, 1))
    return names, all_events, clips


def pack_clips(clips):
    """→ (int16 reflect-padded audio [B, Lp], valid frames [B]) as the data
    pipeline packs a batch."""
    from dcase2019_task4_tpu_torch.config import Config
    from dcase2019_task4_tpu_torch.data.pipeline import quantize_audio_int16
    from dcase2019_task4_tpu_torch.ops.mel import host_reflect_pad

    d = Config().dsp
    padded, frames = host_reflect_pad(clips, d.max_samples, d.n_window, d.hop_length, d.max_frames)
    return quantize_audio_int16(padded), frames


def fit_scaler(frontend, audio_i16, frames, device):
    """Scaler state fitted on one batch's log-mel features."""
    import torch

    audio = torch.as_tensor(audio_i16, device=device).to(torch.float32) / 32768.0
    feats = frontend.log_mel(audio, torch.as_tensor(frames, device=device)).double().cpu().numpy()
    return {"mean_": feats.mean(axis=(0, 1)).tolist(),
            "mean_of_square_": (feats ** 2).mean(axis=(0, 1)).tolist()}


def write_inputs(workdir: str, device):
    """48 synthetic wavs, and two checkpoints of one seeded flagship CRNN
    whose scaler is fitted on the first batch's log-mel features: one with
    the default configuration, one whose stored configuration has
    `entry_block_pallas=True` (the parameters are the same); a checkpoint of
    a seeded CRNN stored with `scaled_config()`, its scaler fitted on that
    configuration's 128-mel features of the same batch; and one of the
    flagship stored with bfloat16 compute and `entry_block_pallas=True`
    (the flagship's scaler)."""
    from dcase2019_task4_tpu_torch.config import DEFAULT_CLASSES, Config, scaled_config
    from dcase2019_task4_tpu_torch.data.audio_io import write_wav
    from dcase2019_task4_tpu_torch.data.encoder import LabelCodec
    from dcase2019_task4_tpu_torch.models.crnn import CRNN, seeded_init_
    from dcase2019_task4_tpu_torch.train import checkpoints as ckpt

    cfg = Config()
    d = cfg.dsp
    wav_dir = os.path.join(workdir, "wavs")
    os.makedirs(wav_dir)
    names, _, clips = make_clips(N_CLIPS, np.random.default_rng(SEED))
    for name, audio in zip(names, clips):
        write_wav(os.path.join(wav_dir, name), audio, d.sample_rate)
    audio_i16, frames = pack_clips(clips[: cfg.train.batch_size])
    scaler = fit_scaler(flagship_frontend(device), audio_i16, frames, device)

    scaled = scaled_config()
    scaled_scaler = fit_scaler(flagship_frontend(device, scaled), audio_i16, frames, device)
    paths = []
    for name, stored, fitted in (
            ("model.npz", cfg, scaler),
            ("model_entry_block.npz",
             dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, entry_block_pallas=True)), scaler),
            ("model_scaled.npz", scaled, scaled_scaler),
            ("model_bf16_entry_block.npz",
             dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, compute_dtype="bfloat16",
                                                                entry_block_pallas=True)), scaler)):
        params, bn_state = ckpt.params_to_jax(seeded_init_(CRNN(stored.model), SEED))
        meta = {
            "epoch": 0,
            "valid_metric": {},
            "pooling_time_ratio": stored.model.pooling_time_ratio,
            "scaler": fitted,
            "many_hot_encoder": LabelCodec(DEFAULT_CLASSES, d.max_frames // stored.model.pooling_time_ratio).state_dict(),
            "config": dataclasses.asdict(stored),
            "mean_teacher": True,
        }
        paths.append(os.path.join(workdir, name))
        ckpt.save_inference_checkpoint(paths[-1], params, bn_state, meta)
    return wav_dir, paths


def read_tsv(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f, delimiter="\t"))


def print_device_time(what: str, fn, card: str, k1: str = "fused_stft_mel_kernel"):
    """Prints what the card spends on one call of `fn` (torch.profiler: every
    kernel and copy) and K1's part of it (kernels whose name holds `k1`)."""
    from torch.autograd import DeviceType

    prof = profiled(fn)
    if prof is None:
        print(f"  device time of {what}: not measured")
        return
    events = [(e.name, event_us(e)) for e in prof.events() if e.device_type == DeviceType.CUDA]
    k1 = sum(us for name, us in events if k1 in name) / 1e3
    print(f"  device time of {what}: {sum(us for _, us in events) / 1e3:.3f} ms in {len(events)} kernels and "
          f"copies, K1 {k1:.3f} ms of it, on {card}")


def phase_predict(device, card: str, work: str):
    """Phase 4, its inputs written into `work` (phase 9 exports and imports
    the same checkpoints)."""
    import torch

    from dcase2019_task4_tpu_torch import cli

    wav_dir, (model, model_entry_block, model_scaled, model_bf16) = write_inputs(work, device)
    out, tags = os.path.join(work, "events.tsv"), os.path.join(work, "tags.tsv")
    argv = ["-m", model, "-i", wav_dir, "-p", out, "--weak_fname", tags]

    zero_launches()
    res = cli.predict(argv + ["--device", "cuda"])
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"  launches during predict: {launches}")
    check_launches(launches, PREDICT_MIN, 1, "the predict run")
    strong = res["strong"]
    if res["n_files"] != N_CLIPS or strong.shape != (N_CLIPS, 108, 10) or not np.isfinite(strong).all():
        raise AssertionError(f"strong probabilities: n_files {res['n_files']}, shape {strong.shape}")
    events, tag_rows = read_tsv(out), read_tsv(tags)
    if len(tag_rows) != N_CLIPS or any(set(r) != {"event_label", "onset", "offset", "filename"} for r in events):
        raise AssertionError("events / tags TSV malformed")
    for r in events:
        if not 0.0 <= float(r["onset"]) < float(r["offset"]):
            raise AssertionError(f"bad event row {r}")
    print(f"  events TSV: {len(events)} rows; tags TSV: {len(tag_rows)} rows")

    t0 = time.perf_counter()
    cli.predict(argv + ["--device", "cuda"])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    clips_per_s = N_CLIPS / warm_s
    print(f"  warm CUDA predict: {N_CLIPS} clips in {warm_s:.3f} s ({1e3 * warm_s:.3f} ms) = {clips_per_s:.2f} clips/s "
          f"(checkpoint load, wav decode, features, model, decode, TSV writes) on {card}")
    print_device_time("one warm predict call", lambda: cli.predict(argv + ["--device", "cuda"]), card)

    cpu = cli.predict(argv + ["--device", "cpu"])
    diff = float(np.abs(cpu["strong"] - strong).max())
    print(f"  CUDA vs CPU (plain versions) strong max abs diff: {diff:.3e} (limit {STRONG_TOL})")
    if not diff <= STRONG_TOL:
        raise AssertionError(f"CUDA and CPU strong probabilities differ by {diff}")

    # the same weights, stored with entry_block_pallas=True: the checkpoint's
    # configuration alone selects the fused first block
    argv = ["-m", model_entry_block, "-i", wav_dir, "-p", out, "--weak_fname", tags]
    zero_launches()
    res = cli.predict(argv + ["--device", "cuda"])
    torch.cuda.synchronize()
    launches_entry = read_launches()
    print(f"  launches during predict with entry_block_pallas=True in the checkpoint: {launches_entry}")
    check_launches(launches_entry, PREDICT_ENTRY_BLOCK, 1, "the predict run with the fused first block")
    if res["strong"].shape != strong.shape or not np.isfinite(res["strong"]).all():
        raise AssertionError(f"strong probabilities with the fused first block: shape {res['strong'].shape}")
    cpu_entry = cli.predict(argv + ["--device", "cpu"])
    for what, other in (("the default configuration on the card", strong), ("its own CPU run", cpu_entry["strong"])):
        diff = float(np.abs(res["strong"] - other).max())
        print(f"  fused first block vs {what}: strong max abs diff {diff:.3e} (limit {STRONG_TOL})")
        if not diff <= STRONG_TOL:
            raise AssertionError(f"strong probabilities with the fused first block differ from {what} by {diff}")
    t0 = time.perf_counter()
    cli.predict(argv + ["--device", "cuda"])
    torch.cuda.synchronize()
    print(f"  warm CUDA predict with the fused first block: {N_CLIPS / (time.perf_counter() - t0):.2f} clips/s "
          f"({clips_per_s:.2f} with the default configuration) on {card}")
    launches_scaled = predict_bf16(model_scaled, wav_dir, work, card, "scaled", PREDICT_SCALED)
    launches_bf16 = predict_bf16(model_bf16, wav_dir, work, card, "flagship bfloat16 entry_block_pallas",
                                 PREDICT_BF16_ENTRY_BLOCK)

    # the default checkpoint (stored without the knob) with K1's onedot knob on
    argv = ["-m", model, "-i", wav_dir, "-p", out, "--weak_fname", tags]
    with knobs(False, onedot=True):
        zero_launches()
        res = cli.predict(argv + ["--device", "cuda"])
        torch.cuda.synchronize()
        launches_onedot = read_launches()
        print(f"  launches during predict with DCASE_FUSED_MEL_ONEDOT on: {launches_onedot}")
        check_launches(launches_onedot, PREDICT_ONEDOT, 1, "the predict run with K1's onedot variant")
        if res["strong"].shape != strong.shape or not np.isfinite(res["strong"]).all():
            raise AssertionError(f"strong probabilities with onedot K1: shape {res['strong'].shape}")
        t0 = time.perf_counter()
        cli.predict(argv + ["--device", "cuda"])
        torch.cuda.synchronize()
        print(f"  warm CUDA predict with onedot K1: {N_CLIPS / (time.perf_counter() - t0):.2f} clips/s "
              f"({clips_per_s:.2f} with the FFT K1) on {card}")
        print_device_time("one warm predict call with onedot K1", lambda: cli.predict(argv + ["--device", "cuda"]),
                          card, k1="fused_stft_mel_onedot_kernel")
        cpu_onedot = cli.predict(argv + ["--device", "cpu"])
    for what, other in (("its own CPU run", cpu_onedot["strong"]), ("the FFT K1 on the card", strong)):
        diff = float(np.abs(res["strong"] - other).max())
        print(f"  onedot K1 vs {what}: strong max abs diff {diff:.3e} (limit {STRONG_TOL})")
        if not diff <= STRONG_TOL:
            raise AssertionError(f"strong probabilities with onedot K1 differ from {what} by {diff}")
    return ({"predict": launches, "predict_entry_block": launches_entry, "predict_scaled": launches_scaled,
             "predict_bf16_entry_block": launches_bf16, "predict_onedot": launches_onedot}, clips_per_s)


def predict_bf16(model: str, wav_dir: str, work: str, card: str, what: str, per_run):
    """`cli.predict` on a bfloat16 checkpoint: the bfloat16 kernels of its
    path (`per_run`, exact), the CUDA run against the CPU run (plain
    versions) within 5e-3."""
    import torch

    from dcase2019_task4_tpu_torch import cli

    tag = what.split()[0]
    out, cpu_out = os.path.join(work, f"events_{tag}.tsv"), os.path.join(work, f"events_{tag}_cpu.tsv")
    argv = ["-m", model, "-i", wav_dir]
    zero_launches()
    res = cli.predict(argv + ["-p", out, "--device", "cuda"])
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"  launches during predict with the {what} checkpoint: {launches}")
    check_launches(launches, per_run, 1, f"the predict run with the {what} checkpoint")
    strong = res["strong"]
    if res["n_files"] != N_CLIPS or strong.shape != (N_CLIPS, 108, 10) or not np.isfinite(strong).all():
        raise AssertionError(f"{what} strong probabilities: n_files {res['n_files']}, shape {strong.shape}")
    t0 = time.perf_counter()
    cli.predict(argv + ["-p", out, "--device", "cuda"])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    print(f"  warm CUDA predict, {what} checkpoint: {N_CLIPS} clips in {warm_s:.3f} s = {N_CLIPS / warm_s:.2f} "
          f"clips/s on {card}")
    print_device_time(f"one warm predict call with the {what} checkpoint",
                      lambda: cli.predict(argv + ["-p", out, "--device", "cuda"]), card)
    t0 = time.perf_counter()
    cpu = cli.predict(argv + ["-p", cpu_out, "--device", "cpu"])
    diff = float(np.abs(cpu["strong"] - strong).max())
    rows_gpu = {tuple(r.values()) for r in read_tsv(out)}
    rows_cpu = {tuple(r.values()) for r in read_tsv(cpu_out)}
    print(f"  {what} checkpoint, CUDA vs CPU (plain versions, {time.perf_counter() - t0:.1f} s): strong max abs diff "
          f"{diff:.3e} (limit {SCALED_STRONG_TOL}); event rows {len(rows_gpu)} vs {len(rows_cpu)}, "
          f"{len(rows_gpu ^ rows_cpu)} rows in one TSV only")
    if not diff <= SCALED_STRONG_TOL:
        raise AssertionError(f"{what} checkpoint: CUDA and CPU strong probabilities differ by {diff}")
    return launches


def train_batch(cfg, n_weak: int, n_unlabel: int, n_strong: int):
    """A packed training batch [weak | unlabeled | synthetic] of seeded
    synthetic clips: int16 audio, valid frames, targets from the LabelCodec
    (weak tags on every frame, −1 for unlabeled, event grids for strong)."""
    from dcase2019_task4_tpu_torch.config import DEFAULT_CLASSES
    from dcase2019_task4_tpu_torch.data.encoder import LabelCodec, events_to_frames

    d, ptr = cfg.dsp, cfg.model.pooling_time_ratio
    codec = LabelCodec(DEFAULT_CLASSES, d.max_frames // ptr)
    _, all_events, clips = make_clips(n_weak + n_unlabel + n_strong, np.random.default_rng(SEED + 1))
    targets = []
    for i, events in enumerate(all_events):
        if i < n_weak:
            targets.append(codec.encode_strong(sorted({DEFAULT_CLASSES[c] for c, _, _ in events})))
        elif i < n_weak + n_unlabel:
            targets.append(codec.encode_strong("empty"))
        else:
            on, off = events_to_frames([e[1] for e in events], [e[2] for e in events],
                                       d.sample_rate, d.hop_length, ptr)
            targets.append(codec.encode_strong([(DEFAULT_CLASSES[e[0]], a, b) for e, a, b in zip(events, on, off)]))
    audio, frames = pack_clips(clips)
    return audio, frames, np.stack(targets).astype(np.float32)


def is_gauge_leaf(name: str) -> bool:
    """Parameters whose step-1 gradient is rounding noise: conv biases ahead
    of a BatchNorm (which takes the batch mean off again) and the attention
    head's logits."""
    return name.endswith(".conv.bias") or name.startswith("dense_softmax.")


def compare_metrics(step: int, on_card: dict, on_cpu: dict):
    for k, v in on_cpu.items():
        if not abs(v.item() - on_card[k]) <= TRAIN_TOL:
            raise AssertionError(f"step {step} {k}: CUDA {on_card[k]} vs CPU {v.item()}")


def dx_launches_only_its_kernel(device):
    """Phase 5: a float32 dx call at the flagship's block 2 ([B, 432, 16,
    64]) launches conv3x3_nhwc_kernel and nothing else: the weights are read
    flipped and transposed by the kernel, with no bias, so no copy, flip or
    fill runs beside it. Held on the ops the call dispatches (every op that
    reaches PyTorch's dispatcher, under a TorchDispatchMode: an allocation
    and views only) and on its launch count; the profiler's kernels of the
    call are printed, and held too where the trace came back."""
    import torch
    from torch.autograd import DeviceType
    from torch.utils._python_dispatch import TorchDispatchMode

    from dcase2019_task4_tpu_torch.config import Config
    from dcase2019_task4_tpu_torch.ops import packed_conv as pc

    cfg = Config()
    C, B = cfg.model.nb_filters[1], cfg.train.batch_size
    rng = np.random.default_rng(SEED + 11)
    w = torch.as_tensor(rng.uniform(-0.1, 0.1, (3, 3, C, C)).astype(np.float32), device=device)
    dy = torch.as_tensor(rng.standard_normal((B, cfg.dsp.max_frames // 2, cfg.dsp.n_mels // 4, C)).astype(np.float32),
                         device=device)
    allowed = {"aten.detach.default", "aten.empty_like.default", "aten.empty.memory_format"}

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.append(str(func))
            return func(*args, **(kwargs or {}))

    pc.conv2d_dx(w, dy)  # built and warm
    torch.cuda.synchronize()
    before = pc.conv2d_dx.launches
    with Ops() as ops:
        pc.conv2d_dx(w, dy)
    torch.cuda.synchronize()
    if pc.conv2d_dx.launches != before + 1:
        raise AssertionError(f"float32 conv2d_dx launched its kernel {pc.conv2d_dx.launches - before} times in one call")
    extra = [op for op in ops.seen if op not in allowed]
    if extra:
        raise AssertionError(f"a float32 conv2d_dx call dispatched {extra} beside its kernel")
    prof = profiled(lambda: pc.conv2d_dx(w, dy))
    names = None
    if prof is not None:
        names = sorted({e.name for e in prof.events() if e.device_type == DeviceType.CUDA and event_us(e) > 0})
        if any("conv3x3_nhwc_kernel" not in n for n in names):
            raise AssertionError(f"a float32 conv2d_dx call ran {names} on the device")
    print(f"  float32 conv2d_dx {list(dy.shape)}: dispatched {sorted(set(ops.seen))}, launched its kernel once; "
          f"device kernels of the call: {names if names is not None else 'not measured'}")


def phase_train(device, card: str):
    import torch

    from dcase2019_task4_tpu_torch.config import Config
    from dcase2019_task4_tpu_torch.train import steps
    from dcase2019_task4_tpu_torch.utils.scaler import Scaler

    dx_launches_only_its_kernel(device)
    cfg = Config()
    tr = cfg.train
    n_weak, n_unlabel, n_strong = tr.batch_size // 4, tr.batch_size // 2, tr.batch_size // 4
    weak_slice, strong_slice = slice(0, n_weak), slice(n_weak + n_unlabel, tr.batch_size)
    audio, frames, target = train_batch(cfg, n_weak, n_unlabel, n_strong)
    mean, std = Scaler().load_state_dict(fit_scaler(flagship_frontend(device), audio, frames, device)).mean_std_f32

    def adam(params):
        return torch.optim.Adam(params, lr=tr.lr, betas=(tr.beta1, tr.beta2), eps=tr.adam_eps)

    def build(dev):
        step = steps.make_train_step(
            weak_slice, strong_slice, mean_teacher=True, rampup_length=10,
            max_consistency_cost=tr.max_consistency_cost, ema_alpha=tr.ema_alpha,
            frontend=flagship_frontend(dev), scaler_mean=mean, scaler_std=std, noise_std=tr.noise_std)
        batch = {"audio": torch.as_tensor(audio, device=dev), "frames": torch.as_tensor(frames, device=dev),
                 "target": torch.as_tensor(target, device=dev)}
        return step, batch

    base = steps.init_train_state(cfg.model, adam, torch.Generator().manual_seed(SEED))
    state = steps.TrainState(copy.deepcopy(base.student).to(device), copy.deepcopy(base.teacher).to(device), None)
    state.optimizer = adam(state.student.parameters())
    step, batch = build(device)
    generator = torch.Generator().manual_seed(SEED + 2)
    acc = step.zero_metrics(device)

    def buffers(model):
        return [b.detach().clone() for blk in model.cnn for b in (blk.bn.running_mean, blk.bn.running_var)]

    teacher_before = [p.detach().clone() for p in state.teacher.parameters()]
    buf_before = buffers(state.student), buffers(state.teacher)
    history, step_ms, first_grads = [], [], None
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics, acc = step(state, batch, generator, acc)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        history.append({k: v.item() for k, v in metrics.items()})  # read outside the step
        print(f"  step {i + 1}: {step_ms[-1]:.2f} ms, " + ", ".join(f"{k} {v:.5f}" for k, v in history[-1].items()))
        if i == 0:
            first_grads = [p.grad.detach().cpu().clone() for p in state.student.parameters()]
            alpha = steps.ema_alpha_at(0, tr.ema_alpha)
            for old, new, cur in zip(teacher_before, state.teacher.parameters(), state.student.parameters()):
                want = alpha * old + (1.0 - alpha) * cur.detach()
                if not torch.allclose(new, want, rtol=1e-6, atol=1e-7):
                    raise AssertionError("teacher parameters are not α·old + (1−α)·student after step 1")
            if all(torch.equal(a, b) for a, b in zip(teacher_before, state.teacher.parameters())):
                raise AssertionError("teacher parameters did not move")
    launches = read_launches()
    print(f"  launches during {TRAIN_STEPS} train steps: {launches}")
    check_launches(launches, STEP_MIN, TRAIN_STEPS, f"{TRAIN_STEPS} train steps")
    if not all(np.isfinite(v) for h in history for v in h.values()):
        raise AssertionError("a training metric is not finite")
    if not history[-1]["loss"] < history[0]["loss"]:
        raise AssertionError(f"loss did not fall: {history[0]['loss']} -> {history[-1]['loss']}")
    sums = {k: v.item() for k, v in acc.items()}
    for k in step.metric_keys:
        if abs(sums[k] - sum(h[k] for h in history)) > 1e-4:
            raise AssertionError(f"metric accumulator {k} is not the sum of the steps' metrics")
    buf_after = buffers(state.student), buffers(state.teacher)
    for before, after in zip(buf_before, buf_after):
        if any(torch.equal(a, b) for a, b in zip(before, after)):
            raise AssertionError("a BatchNorm buffer did not move")
    if all(torch.equal(a, b) for a, b in zip(*buf_after)):
        raise AssertionError("student and teacher BatchNorm buffers are equal")
    warm_ms = float(np.median(step_ms[1:]))
    print(f"  MT step: {warm_ms:.3f} ms per step (median of steps 2-{TRAIN_STEPS}, synchronised; "
          f"first step {step_ms[0]:.1f} ms) on {card}")
    print(f"  peak device memory over the steps: {torch.cuda.max_memory_allocated() / 2 ** 20:.0f} MiB")
    profile_step(step, state, batch, generator, acc, card, warm_ms,
                 noise_shape=(tr.batch_size, cfg.dsp.max_frames, cfg.dsp.n_mels))

    # the same steps with the generator on the card: no draw on the host, no
    # copy of the noise (not repeatable against the CPU, so checked for finite
    # losses only)
    card_generator = torch.Generator(device=device).manual_seed(SEED + 3)
    card_ms = []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics, acc = step(state, batch, card_generator, acc)
        torch.cuda.synchronize()
        card_ms.append(1e3 * (time.perf_counter() - t0))
    if not all(np.isfinite(v.item()) for v in metrics.values()):
        raise AssertionError("a training metric is not finite with the generator on the card")
    default_card_ms = float(np.median(card_ms[1:]))
    print(f"  MT step with the generator on the card: {default_card_ms:.3f} ms per step "
          f"(median of {TRAIN_STEPS - 1}; {warm_ms:.3f} ms with the CPU generator) on {card}")
    step_totals = {}
    default_block1 = block1_device_ms(step, state, batch, card_generator, acc, "step", card, step_totals)

    # steps 1 and 2 again on the CPU: plain versions, same state, same generator seed
    cpu_state = steps.TrainState(base.student, base.teacher, base.optimizer)
    cpu_step, cpu_batch = build(torch.device("cpu"))
    cpu_generator, cpu_acc = torch.Generator().manual_seed(SEED + 2), cpu_step.zero_metrics()
    t0 = time.perf_counter()
    cpu_state, cpu_metrics, cpu_acc = cpu_step(cpu_state, cpu_batch, cpu_generator, cpu_acc)
    print(f"  CPU step 1 (plain versions): {time.perf_counter() - t0:.1f} s")
    compare_metrics(1, history[0], cpu_metrics)
    names = [n for n, _ in cpu_state.student.named_parameters()]
    cpu_grads = [p.grad.detach().clone() for p in cpu_state.student.parameters()]
    worst, worst_gauge = compare_step1_gradients(names, cpu_grads, first_grads, "CUDA against CPU")
    t0 = time.perf_counter()
    cpu_state, cpu_metrics2, cpu_acc = cpu_step(cpu_state, cpu_batch, cpu_generator, cpu_acc)
    print(f"  CPU step 2 (plain versions, after the first update): {time.perf_counter() - t0:.1f} s")
    compare_metrics(2, history[1], cpu_metrics2)
    print(f"  CUDA vs CPU: step 1 loss {history[0]['loss']:.6f} vs {cpu_metrics['loss'].item():.6f}, "
          f"step 2 loss {history[1]['loss']:.6f} vs {cpu_metrics2['loss'].item():.6f} (limit {TRAIN_TOL}); "
          f"worst gradient leaf at {worst:.2f} of its limit ({TRAIN_TOL} of its max), worst gauge leaf at "
          f"{worst_gauge:.2f} of its ({TRAIN_TOL} of its max + {GRAD_FLOOR} of the largest)")
    all_launches = {"step": launches}

    # the same state, batch and seeds under each first-block configuration
    for path, n_steps, cpu_check in (("step_entry_block", TRAIN_STEPS, True), ("step_crows", 3, False),
                                     ("step_entry_conv", 3, False)):
        flag = FIRST_BLOCK_FLAGS[path]
        print(f"  -- {flag}=True: {n_steps} steps from the same state, batch and generator seed")
        model_cfg = dataclasses.replace(cfg.model, **{flag: True})
        fresh = steps.init_train_state(model_cfg, adam, torch.Generator().manual_seed(SEED))
        st = steps.TrainState(copy.deepcopy(fresh.student).to(device), copy.deepcopy(fresh.teacher).to(device), None)
        st.optimizer = adam(st.student.parameters())
        gen, acc2 = torch.Generator().manual_seed(SEED + 2), step.zero_metrics(device)
        hist, grads1 = [], None
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        for i in range(n_steps):
            st, metrics, acc2 = step(st, batch, gen, acc2)
            torch.cuda.synchronize()
            hist.append({k: v.item() for k, v in metrics.items()})
            print(f"  step {i + 1}: " + ", ".join(f"{k} {v:.5f}" for k, v in hist[-1].items()))
            if i == 0:
                grads1 = [p.grad.detach().cpu().clone() for p in st.student.parameters()]
        all_launches[path] = read_launches()
        print(f"  launches during {n_steps} steps with {flag}: {all_launches[path]}")
        check_launches(all_launches[path], PATHS[path], n_steps, f"{n_steps} train steps with {flag}")
        if not all(np.isfinite(v) for h in hist for v in h.values()):
            raise AssertionError(f"a training metric is not finite with {flag}")
        if not hist[-1]["loss"] < hist[0]["loss"]:
            raise AssertionError(f"loss did not fall with {flag}: {hist[0]['loss']} -> {hist[-1]['loss']}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        # step 1 against the default configuration's step 1 on the card
        for k, v in history[0].items():
            if not abs(v - hist[0][k]) <= TRAIN_TOL:
                raise AssertionError(f"step 1 {k} with {flag}: {hist[0][k]} vs default {v}")
        w, wg = compare_step1_gradients(names, first_grads, grads1, f"{flag} against the default configuration")
        print(f"  {flag}: step 1 loss {hist[0]['loss']:.6f} (default {history[0]['loss']:.6f}), loss after {n_steps} "
              f"steps {hist[-1]['loss']:.6f}; worst gradient leaf at {w:.2f} of its limit, worst gauge leaf at "
              f"{wg:.2f}; peak device memory {peak:.0f} MiB")
        if cpu_check:
            cpu_st = steps.TrainState(fresh.student, fresh.teacher, fresh.optimizer)
            t0 = time.perf_counter()
            cpu_st, cpu_m, _ = cpu_step(cpu_st, cpu_batch, torch.Generator().manual_seed(SEED + 2), cpu_step.zero_metrics())
            print(f"  CPU step 1 with {flag} (plain versions): {time.perf_counter() - t0:.1f} s")
            compare_metrics(1, hist[0], cpu_m)
            compare_step1_gradients(names, [p.grad.detach().clone() for p in cpu_st.student.parameters()], grads1,
                                    f"{flag}, CUDA against CPU")
        gen_card, ms = torch.Generator(device=device).manual_seed(SEED + 3), []
        for _ in range(max(n_steps, 4)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, metrics, acc2 = step(st, batch, gen_card, acc2)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        if not all(np.isfinite(v.item()) for v in metrics.values()):
            raise AssertionError(f"a training metric is not finite with {flag} and the generator on the card")
        print(f"  MT step with {flag} and the generator on the card: {float(np.median(ms[1:])):.3f} ms per step "
              f"(median of {len(ms) - 1}; default configuration {default_card_ms:.3f} ms) on {card}")
        block1 = block1_device_ms(step, st, batch, gen_card, acc2, path, card)
        print(f"  block 1 device time in one step: {shown(block1, 3)} ms with {flag}, {shown(default_block1, 3)} ms default, on {card}")
        del st, fresh
        torch.cuda.empty_cache()
    return all_launches, warm_ms, step_totals.get("step")


def phase_train_bf16(device, card: str, cfg, what: str, path: str, n_steps: int, profile: bool):
    """A bfloat16 configuration's Mean-Teacher step (with SpecAugment where
    the configuration has it): step 1 at a batch of 4 [1|2|1] on the card
    against the CPU from one state and one CPU generator, then `n_steps`
    steps at the full batch [6|12|6] with the generator on the card: launches
    per step exact, ms per step, peak memory, and either a torch.profiler
    breakdown of one warm step (`profile`) or block 1's device time in one.
    → ({path: launches}, ms per step, step-1 loss, block 1's device ms)."""
    import torch

    tr = cfg.train
    packed, scaler = step_data(cfg, device)

    # step 1 at a batch of 4, card against CPU, one state and one CPU generator
    small = train_batch(cfg, 1, 2, 1)
    results = []
    for dev in (device, torch.device("cpu")):
        step, batch = built_step(cfg, dev, small, scaler, 1, 2)
        zero_launches()
        t0 = time.perf_counter()
        st, metrics, _ = step(seeded_state(cfg, dev), batch, torch.Generator().manual_seed(SEED + 2),
                              step.zero_metrics(dev))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            check_launches(read_launches(), PATHS[path], 1, f"{what} step 1 at batch 4")
        results.append(({k: v.item() for k, v in metrics.items()},
                        {n: p.grad.detach().cpu().clone() for n, p in st.student.named_parameters()}))
        print(f"  {what} step 1, batch 4 [1|2|1], on {dev.type}: {time.perf_counter() - t0:.1f} s, "
              + ", ".join(f"{k} {v:.5f}" for k, v in results[-1][0].items()))
    (m_gpu, g_gpu), (m_cpu, g_cpu) = results
    compare_metrics(1, m_gpu, {k: torch.tensor(v) for k, v in m_cpu.items()})
    top = max(g.abs().max().item() for g in g_cpu.values())
    worst, worst_gauge = 0.0, 0.0
    for name, want in g_cpu.items():
        # under the crows layout block 1's conv weight sums two batch halves
        # that nearly cancel, each rounded to bfloat16 as the original rounds
        # it: one rounding of a half flipping is large against the sum
        gauge = is_gauge_leaf(name) or (cfg.model.entry_block_crows and name == "cnn.0.conv.weight")
        limit = SCALED_GRAD_TOL * want.abs().max().item() + (SCALED_GAUGE_FLOOR if gauge else SCALED_GRAD_FLOOR) * top
        err = (g_gpu[name] - want).abs().max().item()
        print(f"    {name:28s} max {want.abs().max().item():.3e}  err {err:.3e}  err/limit {err / limit:.2f}"
              f"{'  (gauge: floor applies)' if gauge else ''}")
        if not err <= limit:
            raise AssertionError(f"{what} step 1, {name}: CUDA and CPU gradients differ by {err} (limit {limit})")
        if gauge:
            worst_gauge = max(worst_gauge, err / limit)
        else:
            worst = max(worst, err / limit)
    print(f"  {what} step 1, CUDA vs CPU: loss {m_gpu['loss']:.6f} vs {m_cpu['loss']:.6f} (limit {TRAIN_TOL}); worst "
          f"gradient leaf at {worst:.2f} of its limit ({SCALED_GRAD_TOL} of its max + {SCALED_GRAD_FLOOR} of the "
          f"largest), worst gauge leaf at {worst_gauge:.2f} of its ({SCALED_GAUGE_FLOOR} of the largest)")

    # n_steps at the full batch with the generator on the card
    step, batch = built_step(cfg, device, packed, scaler, tr.batch_size // 4, tr.batch_size // 2)
    state = seeded_state(cfg, device)
    generator = torch.Generator(device=device).manual_seed(SEED + 3)
    acc = step.zero_metrics(device)
    history, step_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    for i in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics, acc = step(state, batch, generator, acc)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        history.append({k: v.item() for k, v in metrics.items()})
        print(f"  {what} step {i + 1}: {step_ms[-1]:.2f} ms, "
              + ", ".join(f"{k} {v:.5f}" for k, v in history[-1].items()))
    launches = read_launches()
    print(f"  launches during {n_steps} {what} steps: {launches}")
    check_launches(launches, PATHS[path], n_steps, f"{n_steps} {what} train steps")
    if not all(np.isfinite(v) for h in history for v in h.values()):
        raise AssertionError(f"a {what} training metric is not finite")
    warm_ms = float(np.median(step_ms[1:]))
    print(f"  {what} MT step with the generator on the card: {warm_ms:.3f} ms per step (median of steps "
          f"2-{n_steps}; first step {step_ms[0]:.1f} ms) on {card}")
    print(f"  peak device memory over the {what} steps: {torch.cuda.max_memory_allocated() / 2 ** 20:.0f} MiB")
    block1 = None
    if profile:
        profile_step(step, state, batch, generator, acc, card, warm_ms,
                     noise_shape=(tr.batch_size, cfg.dsp.max_frames, cfg.dsp.n_mels))
    else:
        block1 = block1_device_ms(step, state, batch, generator, acc, path, card)
    return {path: launches}, warm_ms, m_gpu["loss"], block1


def phase_train_flagship_bf16(device, card: str):
    """The flagship `Config()` in bfloat16 under the default first block and
    each first-block flag, each held to its own CPU run (the JAX package's
    own engines differ in bfloat16, so the gap between flags is printed, not
    held)."""
    from dcase2019_task4_tpu_torch.config import Config

    cfg = Config()
    launches, summary = {}, []
    for path in ("step_bf16", "step_bf16_entry_block", "step_bf16_crows", "step_bf16_entry_conv"):
        flag = FIRST_BLOCK_FLAGS.get(path)
        model = dataclasses.replace(cfg.model, compute_dtype="bfloat16", **({flag: True} if flag else {}))
        what = f"flagship bf16 {flag or 'default first block'}"
        print(f"  -- {what}")
        got, ms, loss, block1 = phase_train_bf16(device, card, dataclasses.replace(cfg, model=model), what, path, 3,
                                                 profile=False)
        launches.update(got)
        summary.append((what, ms, loss, block1))
    _, base_ms, base_loss, base_block1 = summary[0]
    for what, ms, loss, block1 in summary:
        print(f"  {what}: {ms:.3f} ms per step (default {base_ms:.3f}), block 1 {shown(block1, 3)} ms on the device "
              f"(default {shown(base_block1, 3)}), step-1 loss at batch 4 {loss:.6f}, {loss - base_loss:+.2e} from the "
              f"default's (information: the JAX package's engines differ in bfloat16 too) on {card}")
    return launches, summary[0][1]


def step_data(cfg, device):
    """The full training batch of `cfg` ([weak | unlabeled | synthetic] of
    its batch size) and its scaler, fitted with the FFT K1 on that batch."""
    from dcase2019_task4_tpu_torch.utils.scaler import Scaler

    tr = cfg.train
    audio, frames, target = train_batch(cfg, tr.batch_size // 4, tr.batch_size // 2, tr.batch_size // 4)
    mean, std = Scaler().load_state_dict(
        fit_scaler(flagship_frontend(device, cfg, onedot=False), audio, frames, device)).mean_std_f32
    return (audio, frames, target), (mean, std)


def built_step(cfg, dev, packed, scaler, n_weak: int, n_unlabel: int, mesh=None):
    """`make_train_step` for `cfg` on `dev` (SpecAugment where `cfg` has it),
    its frontend built now (so K1's knob as it is now), and the batch; with
    `mesh` the data-parallel step of one rank."""
    import torch

    from dcase2019_task4_tpu_torch.train import steps

    tr = cfg.train
    sa = dict(time_masks=tr.sa_time_masks, max_time_width=tr.sa_max_time_width, freq_masks=tr.sa_freq_masks,
              max_freq_width=tr.sa_max_freq_width) if tr.spec_augment else None
    n = len(packed[1])
    step = steps.make_train_step(
        slice(0, n_weak), slice(n_weak + n_unlabel, n), mean_teacher=True, rampup_length=10,
        max_consistency_cost=tr.max_consistency_cost, ema_alpha=tr.ema_alpha, frontend=flagship_frontend(dev, cfg),
        scaler_mean=scaler[0], scaler_std=scaler[1], noise_std=tr.noise_std, spec_augment_cfg=sa, mesh=mesh)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in zip(("audio", "frames", "target"), packed)}
    return step, batch


def seeded_state(cfg, dev):
    """The seeded TrainState of `cfg` on `dev` with a fresh Adam."""
    import torch

    from dcase2019_task4_tpu_torch.train import steps

    tr = cfg.train

    def adam(params):
        return torch.optim.Adam(params, lr=tr.lr, betas=(tr.beta1, tr.beta2), eps=tr.adam_eps)

    base = steps.init_train_state(cfg.model, adam, torch.Generator().manual_seed(SEED))
    st = steps.TrainState(copy.deepcopy(base.student).to(dev), copy.deepcopy(base.teacher).to(dev), None)
    st.optimizer = adam(st.student.parameters())
    return st


def step_device_ms(step, state, batch, generator, acc) -> Optional[float]:
    """What the card spends on one step: torch.profiler's sum over every
    kernel and copy of one traced step that holds K1 (`holds_k1`), opened
    by an uncounted spin kernel; a trace without it is taken again, up to
    five times even after another reading was lost (the knobs steps' device
    time went unread in two PRs); None when no trace held it."""
    import torch
    from torch.autograd import DeviceType

    def spin_then_step():
        open_trace()
        step(state, batch, generator, acc)

    prof = profiled(spin_then_step, with_host=True, complete=holds_k1, tries=5, retry=True)
    if prof is None:
        return None
    return sum(event_us(e) for e in prof.events()
               if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.name) / 1e3


def knob_card_steps(device, cfg, path: str, n_steps: int, on: bool, data):
    """`n_steps` MT steps of `cfg` at its full batch on the card with the
    generator on the card, the three knobs `on` (or off): launches per step
    exact (PATHS[path]), ms per step, peak memory and one traced step's
    device time. → (launches, ms per step, peak MiB, device ms, state, step,
    batch, generator, acc)."""
    import torch

    tr = cfg.train
    packed, scaler = data
    with knobs(on):
        step, batch = built_step(cfg, device, packed, scaler, tr.batch_size // 4, tr.batch_size // 2)
        state = seeded_state(cfg, device)
        generator = torch.Generator(device=device).manual_seed(SEED + 3)
        acc = step.zero_metrics(device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        ms = []
        for _ in range(n_steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics, acc = step(state, batch, generator, acc)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        launches = read_launches()
        check_launches(launches, expected(path), n_steps, f"{n_steps} steps of {path}")
        if not all(np.isfinite(v.item()) for v in metrics.values()):
            raise AssertionError(f"a training metric of {path} is not finite")
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        on_device = step_device_ms(step, state, batch, generator, acc)
    return launches, ms, peak, on_device, (step, state, batch, generator, acc)


def phase_train_knobs(device, card: str):
    """The knobs path: the flagship float32 MT step with the three knobs on.
    Step 1 at a batch of 4 [1|2|1] on the card against the CPU with the same
    knobs (loss and metrics 1e-4, gradient leaves 1e-4 of their max, the
    gauge leaves with their floor); then at batch 24 with the generator on
    the card, in turns with the default (default, knobs, knobs, default;
    three steps each, launches per step exact in each): ms per step, the
    device time of one traced step and peak memory beside the default's,
    and a profile of one knobs step. Then two steps each, launches exact, of
    the same knobs under `entry_block_pallas` (K5 with the packed draw), and
    of the scaled configuration and the flagship in bfloat16 (the bfloat16
    recompute fixup). → {path: launches}."""
    import torch

    from dcase2019_task4_tpu_torch.config import Config, scaled_config

    cfg = Config()
    data = step_data(cfg, device)
    small = train_batch(cfg, 1, 2, 1)
    results = []
    with knobs(True):
        for dev in (device, torch.device("cpu")):
            step, batch = built_step(cfg, dev, small, data[1], 1, 2)
            zero_launches()
            t0 = time.perf_counter()
            st, metrics, _ = step(seeded_state(cfg, dev), batch, torch.Generator().manual_seed(SEED + 2),
                                  step.zero_metrics(dev))
            if dev.type == "cuda":
                torch.cuda.synchronize()
                check_launches(read_launches(), expected("step_knobs"), 1, "the knobs step 1 at batch 4")
            results.append((metrics, [p.grad.detach().cpu().clone() for p in st.student.parameters()]))
            print(f"  knobs step 1, batch 4 [1|2|1], on {dev.type}: {time.perf_counter() - t0:.1f} s, "
                  + ", ".join(f"{k} {v.item():.5f}" for k, v in metrics.items()))
    (m_gpu, g_gpu), (m_cpu, g_cpu) = results
    compare_metrics(1, {k: v.item() for k, v in m_gpu.items()}, m_cpu)
    names = [n for n, _ in st.student.named_parameters()]
    worst, worst_gauge = compare_step1_gradients(names, g_cpu, g_gpu, "the three knobs on, CUDA against CPU")
    print(f"  knobs step 1, CUDA vs CPU: loss {m_gpu['loss'].item():.6f} vs {m_cpu['loss'].item():.6f} (limit "
          f"{TRAIN_TOL}); worst gradient leaf at {worst:.2f} of its limit, worst gauge leaf at {worst_gauge:.2f}")

    # batch 24, in turns with the default
    all_launches, summary = {}, {"step": [], "step_knobs": []}
    for path, on in (("step", False), ("step_knobs", True), ("step_knobs", True), ("step", False)):
        launches, ms, peak, on_device, run = knob_card_steps(device, cfg, path, 3, on, data)
        all_launches.setdefault(path, launches)
        summary[path].append((ms, peak, on_device))
        print(f"  {path}: ms per step {', '.join(f'{v:.2f}' for v in ms)}; one step's device time "
              f"{shown(on_device, 3)} ms; peak device memory {peak:.0f} MiB; launches per step exact")
        if on and len(summary[path]) == 1:
            with knobs(True):
                profile_step(*run, card, float(np.median(ms[1:])),
                             noise_shape=(cfg.train.batch_size, cfg.dsp.max_frames, cfg.dsp.n_mels))
        del run
        torch.cuda.empty_cache()

    def med(path, i):  # over the two runs of a path: i = 0 ms per step (steps 2-3), 1 peak MiB, 2 device ms
        vals = [float(np.median(r[0][1:])) if i == 0 else r[i] for r in summary[path]]
        vals = [v for v in vals if v is not None]
        return float(np.median(vals)) if vals else None

    print(f"  MT step with the three knobs on: {med('step_knobs', 0):.3f} ms per step (default {med('step', 0):.3f}), "
          f"device time {shown(med('step_knobs', 2), 3)} ms (default {shown(med('step', 2), 3)}), peak memory "
          f"{med('step_knobs', 1):.0f} MiB (default {med('step', 1):.0f}); medians of two runs each, steps 2-3, "
          f"in turns, on {card}")
    all_launches["step_knobs_entry_block"] = knob_card_steps(
        device, dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, entry_block_pallas=True)),
        "step_knobs_entry_block", 2, True, data)[0]
    print("  knobs under entry_block_pallas: 2 steps, launches per step exact (K5 with the packed draw)")
    del all_launches["step"]  # the default path's launches are phase 5's own
    for path, kcfg in (("step_knobs_scaled", scaled_config()),
                       ("step_knobs_bf16", dataclasses.replace(cfg, model=dataclasses.replace(
                           cfg.model, compute_dtype="bfloat16")))):
        launches, ms, peak, on_device, _ = knob_card_steps(device, kcfg, path, 2, True, step_data(kcfg, device))
        all_launches[path] = launches
        print(f"  {path}: 2 steps, {', '.join(f'{v:.2f}' for v in ms)} ms, device time {shown(on_device, 3)} ms, "
              f"peak {peak:.0f} MiB; launches per step exact (the bfloat16 recompute fixup, packed draw)")
        torch.cuda.empty_cache()
    return all_launches


def compare_step1_gradients(names, want, got, what: str):
    """Every leaf within 1e-4 of its own max. The gauge leaves alone get a
    float32 noise floor of 1e-6 of the step's largest gradient on top: a conv
    bias ahead of a BatchNorm has a zero gradient in exact arithmetic, and
    the attention head's logits (near-uniform softmax at this init) have
    sums that cancel almost completely, so what float32 leaves there is
    rounding noise of the terms summed. Those are held in function space
    instead: Adam divides such noise by its own size and moves these leaves
    by about the learning rate in either run, and step 2, taken after that
    update, must give the same loss and metrics in both.
    → (worst leaf, worst gauge leaf) as shares of their limits."""
    top = max(g.abs().max().item() for g in want)
    worst, worst_gauge, failures = 0.0, 0.0, []
    print(f"  step 1 gradients, {what} (largest gradient {top:.3e}):")
    for name, a, b in zip(names, want, got):
        a, b = a.cpu(), b.cpu()
        err, own = (a - b).abs().max().item(), a.abs().max().item()
        gauge = is_gauge_leaf(name)
        limit = TRAIN_TOL * own + (GRAD_FLOOR * top if gauge else 0.0)
        print(f"    {name:28s} max {own:.3e}  err {err:.3e}  err/max {err / max(own, 1e-30):.2e}  "
              f"err/largest {err / top:.2e}  err/limit {err / max(limit, 1e-300):.2f}{'  (gauge: floor applies)' if gauge else ''}")
        if gauge:
            worst_gauge = max(worst_gauge, err / max(limit, 1e-300))
        else:
            worst = max(worst, err / max(limit, 1e-300))
        if not err <= limit:
            failures.append(f"{name}: differ by {err:.3e} (limit {limit:.3e})")
    if failures:
        raise AssertionError(f"step 1 gradients, {what}:\n  " + "\n  ".join(failures))
    return worst, worst_gauge


# Kernels of block 1 in one profiled MT step, by first-block configuration:
# (substring of the kernel's name, launches that belong to block 1). K2's
# kernels run for all three blocks; block 1's activation is eight times the
# next one's, so its launches are the longest of each name.
BLOCK1_KERNELS = {
    "step": (("bn_glu_pool_kernel", 2), ("bn_glu_pool_bwd_kernel", 1), ("bn_bwd_fixup_kernel", 1), ("stats_kernel", 2)),
    "step_entry_block": (("entry_conv_run_kernel", 2), ("entry_block_fwd_f32_kernel", 2),
                         ("entry_block_bwd_reduce_f32_kernel", 1), ("entry_block_bwd_wgrad_f32_kernel", 1)),
    "step_entry_conv": (("entry_conv_kernel", 2), ("entry_conv_dw_f32_kernel", 1), ("bn_glu_pool_kernel", 2),
                        ("bn_glu_pool_bwd_kernel", 1), ("bn_bwd_fixup_kernel", 1)),
}
BLOCK1_KERNELS["step_crows"] = BLOCK1_KERNELS["step_entry_block"]
BF16_NAMES = {"bn_glu_pool_kernel": "bn_glu_pool_bf16_kernel", "bn_glu_pool_bwd_kernel": "bn_glu_pool_bwd_bf16_kernel",
              "entry_conv_kernel": "entry_conv_run_kernel", "entry_conv_dw_f32_kernel": "entry_conv_dw_bf16_kernel",
              "stats_kernel": "stats_bf16_kernel",
              "entry_block_fwd_f32_kernel": "entry_block_fwd_bf16_kernel",
              "entry_block_bwd_reduce_f32_kernel": "entry_block_bwd_reduce_bf16_kernel",
              "entry_block_bwd_wgrad_f32_kernel": "entry_block_bwd_wgrad_bf16_kernel"}
BLOCK1_KERNELS.update({f"step_bf16{path[4:]}": tuple((BF16_NAMES.get(k, k), n) for k, n in BLOCK1_KERNELS[path])
                       for path in ("step", "step_entry_block", "step_crows", "step_entry_conv")})


def block1_device_ms(step, state, batch, generator, acc, path: str, card: str,
                     step_totals: Optional[dict] = None) -> Optional[float]:
    """Device time of CRNN block 1 (teacher and student forward, student
    backward) in one profiled step: its kernels by name, plus, in the default
    configuration, what the cuDNN convolution operators spent on the device
    (forward ×2 and the weight gradient). A reading, printed per item with
    the whole step's device time beside it (kept in `step_totals[path]`
    where given); None when the profiler gave no trace with all of block
    1's kernels."""
    from torch.autograd import DeviceType

    def kernels_of(prof):
        return [(e.name, event_us(e)) for e in prof.events() if e.device_type == DeviceType.CUDA]

    def complete(prof):
        names = [name for name, _ in kernels_of(prof)]
        return all(sum(pattern in name for name in names) >= count for pattern, count in BLOCK1_KERNELS[path])

    prof = profiled(lambda: step(state, batch, generator, acc), with_host=True, complete=complete)
    if prof is None:
        print(f"  block 1 in one step ({path}, {card}): not measured")
        return None
    launches = kernels_of(prof)
    total, items = 0.0, []
    for pattern, count in BLOCK1_KERNELS[path]:
        times = sorted((us for name, us in launches if pattern in name), reverse=True)
        if len(times) < count:
            raise AssertionError(f"block 1 of {path}: {len(times)} launches of {pattern} in the profile, expected >= {count}")
        ms = sum(times[:count]) / 1e3
        total += ms
        items.append(f"{pattern} ×{count} {ms:.3f}")
    if path in ("step", "step_bf16"):
        for op in ("aten::cudnn_convolution", "aten::convolution_backward"):
            found = [e for e in prof.key_averages() if e.key == op]
            ms = sum(float(getattr(e, "device_time_total", 0.0) or getattr(e, "cuda_time_total", 0.0)) for e in found) / 1e3
            total += ms
            items.append(f"{op} ×{sum(e.count for e in found)} {ms:.3f}" if found else f"{op} not measured")
    print(f"  block 1 in one step ({path}, {card}): {total:.3f} ms = " + " + ".join(items))
    print(f"  the whole step's device time in that profile ({path}): {sum(us for _, us in launches) / 1e3:.3f} ms "
          f"in {len(launches)} kernels and copies")
    if step_totals is not None:
        step_totals[path] = sum(us for _, us in launches) / 1e3
    return total


# The spin kernels that open a step's trace, uncounted. Late in a run of this
# script on an H100 the traces of a step lost their first records: behind one
# spin of 20000 cycles every trace (422-478 device events, five tries) lacked
# the spin and K1, the step's first kernel, and behind one of 60 million
# cycles (30 ms) two of seven readings still did; so the first records are
# spent on spins, not on the step.
STEP_SPINS = 32


def open_trace():
    """STEP_SPINS short spin kernels, then a wait for them: what a step's
    trace may lose at its start."""
    import torch

    for _ in range(STEP_SPINS):
        torch.cuda._sleep(20000)
    torch.cuda.synchronize()


def holds_k1(prof) -> bool:
    """Whether a step's trace holds its first kernel, K1 (either variant):
    traces of an H100 lost it in some runs and kept it in others, with and
    without an opening spin kernel, so a trace without it is taken again."""
    from torch.autograd import DeviceType

    return any(e.device_type == DeviceType.CUDA and "fused_stft_mel" in e.name for e in prof.events())


def profile_step(step, state, batch, generator, acc, card: str, step_ms: float, noise_shape):
    """torch.profiler over one warm step: device time by kernel (kernel
    events only: an operator's row repeats the time of the kernels it
    launched), and the device's idle share of an unprofiled step. Prints
    "not measured" when the profiler gave no trace."""
    import torch
    from torch.autograd import DeviceType

    wall = []

    def timed_step():
        open_trace()  # so that K1 is not among the trace's first records
        t0 = time.perf_counter()
        step(state, batch, generator, acc)
        torch.cuda.synchronize()
        wall.append(1e3 * (time.perf_counter() - t0))

    prof = profiled(timed_step, with_host=True, complete=holds_k1)
    events = [] if prof is None else [e for e in prof.key_averages()
                                      if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                                      and "spin_kernel" not in e.key]
    if not events:
        print(f"  profile of one warm step on {card}: not measured")
        return
    wall_ms = wall[-1]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"  profile of one warm step on {card}: wall {wall_ms:.2f} ms (profiler on), "
          f"device busy {busy_ms:.3f} ms in {sum(e.count for e in events)} kernels and copies = "
          f"{100.0 * busy_ms / step_ms:.1f} % of the {step_ms:.3f} ms step (idle {100.0 * (1.0 - busy_ms / step_ms):.1f} %)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:24]:
        print(f"    {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:90]}")
    k3_ms = sum(e.self_device_time_total for e in events if "conv3x3" in e.key) / 1e3
    print(f"  K3 (forward, dx and wgrad kernels; their fold not counted): {k3_ms:.3f} ms = "
          f"{100.0 * k3_ms / busy_ms:.1f} % of the step's device time")
    host = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU]
    print("  the same step on the host, by self CPU time (profiler on):")
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:10]:
        print(f"    {e.self_cpu_time_total / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:90]}")
    # the step's one large host-side draw: the teacher's noise from the CPU generator
    t0 = time.perf_counter()
    for _ in range(5):
        torch.randn(noise_shape, generator=generator, device=generator.device)
    print(f"  host: drawing the teacher's noise {list(noise_shape)} from the CPU generator takes "
          f"{1e3 * (time.perf_counter() - t0) / 5:.3f} ms per step, during which the card waits")


# K3's, K2's and K5's bfloat16 kernels: their products must be tensor-core instructions
MMA_KERNELS = ("conv3x3_bf16_kernel", "conv3x3_wgrad_bf16_kernel", "bn_glu_pool_bf16_kernel",
               "bn_glu_pool_bwd_bf16_kernel", "bn_bwd_fixup_recompute_bf16_kernel", "entry_block_fwd_bf16_kernel",
               "entry_block_bwd_reduce_bf16_kernel", "entry_block_bwd_wgrad_bf16_kernel", "entry_conv_dw_bf16_kernel")
# the float32 products redesigned as register-tiled FP32 FMAs: FFMA, and no
# tensor-core instruction (no TF32); bn_glu_pool_kernel is K2f's float32
# forward alone, bn_glu_pool_bwd_kernel K2b's float32 reduce pass alone,
# bn_bwd_fixup_recompute_kernel its float32 recompute fixup alone,
# entry_block_*_f32_kernel K5's three float32 kernels and
# entry_conv_run_kernel K4f / K5s on bfloat16 x and K5s on float32 x, whose
# conv is FP32 FMAs in conv9's order, entry_conv_dw_f32_kernel K4w on float32
# x (no name here is a substring of another listed name)
FFMA_KERNELS = ("fused_stft_mel_onedot_kernel", "conv3x3_wgrad_kernel", "conv3x3_nhwc_kernel",
                "bn_glu_pool_bwd_kernel", "bn_glu_pool_kernel", "bn_bwd_fixup_recompute_kernel",
                "entry_block_bwd_reduce_f32_kernel", "entry_block_fwd_f32_kernel", "entry_block_bwd_wgrad_f32_kernel",
                "entry_conv_run_kernel", "entry_conv_dw_f32_kernel")
# the kernels whose ptxas report phase 2 prints apart and fails on a spill: K4w's
NO_SPILL_KERNELS = ("entry_conv_dw_f32_kernel", "entry_conv_dw_bf16_kernel")


def check_mma(path):
    """Which instruction each product kernel was compiled to, read from the
    built library's machine code (`cuobjdump -sass`): K3's, K2's and K5's
    bfloat16 kernels (K2b's recompute fixup and K5's bfloat16 forward too)
    must hold HGMMA (`wgmma`) or HMMA (`mma.sync`), the FP32 product kernels
    (onedot K1, K3's float32 forward / dx and weight gradient, K2f's forward,
    K2b's reduce pass and recompute fixup, K5's float32 forward and passes,
    the bfloat16 K4f / K5s conv) FFMA and
    neither HGMMA nor HMMA. FFMA counts the float32 FMAs on the CUDA
    cores."""
    from dcase2019_task4_tpu_torch.ops import _build

    counts = _build.sass_counts(path, MMA_KERNELS + FFMA_KERNELS)
    for kernel in MMA_KERNELS + FFMA_KERNELS:
        found = {name: c for name, c in counts.items() if kernel in name}
        if not found:
            raise AssertionError(f"{kernel}: not in the machine code of {path}")
        for name, c in found.items():
            op = "HGMMA" if c["HGMMA"] else "HMMA" if c["HMMA"] else "FFMA" if c["FFMA"] else None
            print(f"  {kernel} ({name[:70]}): {op or 'no product instruction'}; "
                  + ", ".join(f"{k} {v}" for k, v in c.items()))
            if kernel in MMA_KERNELS and op not in ("HGMMA", "HMMA"):
                raise AssertionError(f"{name}: neither HGMMA nor HMMA in its machine code")
            if kernel in FFMA_KERNELS and op != "FFMA":
                raise AssertionError(f"{name}: an FP32-FMA kernel with {op or 'no FFMA'} in its machine code")


def check_spills(log, kernels):
    """Print ptxas's registers and spills of each instantiation of `kernels`
    (substrings of the mangled names) from the build log; fail where one
    spills or is missing."""
    lines = log.splitlines()
    for kernel in kernels:
        found = 0
        for i, line in enumerate(lines):
            if "Compiling entry" in line and kernel in line:
                found += 1
                report = " ".join(s.strip() for s in lines[i + 1:i + 4] if "spill" in s or "registers" in s)
                name = line.split("'")[1]
                print(f"  ptxas of {kernel} ({name[:60]}): {report}")
                if "0 bytes spill stores, 0 bytes spill loads" not in report:
                    raise AssertionError(f"{kernel} spills: {report}")
        if not found:
            raise AssertionError(f"no ptxas report of {kernel} in the build log")


# the training CLI path (phase 6): the kernels it launches a step, and the
# Mean-Teacher run's record keys (the JAX package's)
TRAIN_CLI_KERNELS = sorted(set(PREDICT_MIN) | set(STEP_MIN))
SUPERVISED_STEP = {"fused_stft_mel": 1, "conv2d_forward": 2, "conv2d_dx": 2, "conv2d_wgrad": 2,
                   "fused_bn_glu_pool_train": 3, "batch_stats": 3, "bwd_reduce": 3, "bwd_fixup": 3}
TRAIN_ONLY = ("conv2d_dx", "conv2d_wgrad", "fused_bn_glu_pool_train", "batch_stats", "bwd_reduce", "bwd_fixup")
RECORD_KEYS = ("epoch", "epoch_time_s", "loss", "weak_class_loss", "strong_class_loss", "consistency_strong",
               "consistency_weak", "consistency_weight", "weak_ema_class_loss", "strong_ema_class_loss",
               "event_macro_f1", "weak_macro_f1", "global_valid", "saved_best", "steps_per_s", "queue_wait_share")
CLI_SUBPART, CLI_EPOCHS, PARITY_SUBPART = 96, 2, 24


def off_card(tensors: dict):
    """The keys of `tensors` whose tensor does not lie on the card."""
    return [k for k, v in tensors.items() if v.device.type != "cuda"]


@contextlib.contextmanager
def watched_steps(seen: dict):
    """Every batch a train step receives must lie on the card; `seen`
    counts the steps, and keeps a copy on the card of the first
    `seen["keep"]` batches in `seen["kept"]` where it asks for them. The
    feed's copy counters start at 0."""
    from dcase2019_task4_tpu_torch.data import pipeline
    from dcase2019_task4_tpu_torch.train import steps

    real = steps.TrainStep.__call__

    def call(self, state, batch, generator, acc):
        off = off_card(batch)
        if off:
            raise AssertionError(f"a train step received {off} off the card")
        if seen["steps"] < seen.get("keep", 0):
            seen["kept"].append({k: v.clone() for k, v in batch.items()})
        seen["steps"] += 1
        return real(self, state, batch, generator, acc)

    pipeline.device_prefetch.batches = pipeline.device_prefetch.pinned = 0
    steps.TrainStep.__call__ = call
    try:
        yield
    finally:
        steps.TrainStep.__call__ = real


@contextlib.contextmanager
def quiet_log():
    """The training log's INFO lines (sed reports) off stdout."""
    import logging

    from dcase2019_task4_tpu_torch.utils.logger import get_logger

    log = get_logger()
    level = log.level
    log.setLevel(logging.WARNING)
    try:
        yield
    finally:
        log.setLevel(level)


def train_cli(command: str, args, card: str, per_step: dict, seen: Optional[dict] = None):
    """One training CLI run on the card: every batch on the card, copied
    from pinned memory (or, under --device_cache, gathered there: none
    copied), the training kernels launched `per_step` times a step,
    nothing off the path launched, every record's losses finite. `seen`
    (watched_steps) may ask for the first batches. → (launches, records)."""
    from dcase2019_task4_tpu_torch import cli
    from dcase2019_task4_tpu_torch.data import pipeline
    from dcase2019_task4_tpu_torch.utils.metrics_writer import read_metrics

    seen = {"steps": 0} if seen is None else seen
    with watched_steps(seen), quiet_log():
        zero_launches()
        t0 = time.perf_counter()
        cli.main([command, *args])
        wall = time.perf_counter() - t0
        launches = read_launches()
    n = seen["steps"]
    fed = pipeline.device_prefetch.batches, pipeline.device_prefetch.pinned
    if n == 0 or fed != ((0, 0) if "--device_cache" in args else (n, n)):
        raise AssertionError(f"{command}: {n} steps, {fed[0]} batches copied to the card, {fed[1]} from pinned memory")
    for name, count in launches.items():
        if name not in TRAIN_CLI_KERNELS and count:
            raise AssertionError(f"{command} launched {name} {count} times, which its path has no use for")
        if name in TRAIN_CLI_KERNELS and count < 1:
            raise AssertionError(f"{command} launched {name} no time")
        if name in TRAIN_ONLY and count != n * per_step[name]:
            raise AssertionError(f"{command}: {name} launched {count} times in {n} steps "
                                 f"(expected {per_step[name]} a step)")
    store = args[args.index("--store_dir") + 1]
    records = read_metrics(os.path.join(store, "metrics.jsonl"))
    for r in records:
        keys = RECORD_KEYS if command == "train_meanteacher" else [k for k in RECORD_KEYS if "consistency" not in k
                                                                    and "_ema_" not in k]
        missing = [k for k in keys if k not in r]
        losses = [k for k in r if "loss" in k or k.startswith("consistency_")]
        if missing or not all(np.isfinite(r[k]) for k in losses):
            raise AssertionError(f"{command} epoch {r['epoch']}: missing {missing} or a loss not finite: {r}")
        print(f"  {command} epoch {r['epoch']}: {r['epoch_time_s']:.2f} s with validation and checkpoints, "
              f"{r['steps_per_s']:.3f} steps/s in the training loop, queue wait {100 * r['queue_wait_share']:.2f} % "
              f"of the loop, loss {r['loss']:.4f}, event F1 {r['event_macro_f1']:.4f}, weak F1 "
              f"{r['weak_macro_f1']:.4f} on {card}")
    for f in ("model/baseline_best", "predictions/baseline_validation.tsv", "predictions/baseline_eval2019.tsv"):
        if not os.path.exists(os.path.join(store, f)):
            raise AssertionError(f"{command} left no {f}")
    print(f"  {command}: {n} steps, {len(records)} epochs, {wall:.1f} s in all (clips rendered on the host, "
          f"the final test included) on {card}")
    return launches, records


def host_batch_times(exp):
    """The worker thread's work for one training batch, timed on this
    machine's CPU: rendering an unlabeled clip (that stream is not cached),
    and assembling and pinning whole batches of an epoch (the weak and
    synthetic clips cached by the scaler pass)."""
    from dcase2019_task4_tpu_torch.data.pipeline import pin_batch

    names = [s.name for s in exp.pipeline.streams]
    unlabeled = exp.pipeline.streams[names.index("unlabeled")]
    n = exp.pipeline.sampler.batch_sizes[names.index("unlabeled")]
    t0 = time.perf_counter()
    for fn in unlabeled.filenames[:n]:
        unlabeled.source.get_audio(fn)
    render = (time.perf_counter() - t0) / n
    batches = exp.pipeline.sampler.epoch_batches(1)
    t0 = time.perf_counter()
    for b in batches:
        pin_batch(exp.pipeline.assemble(b))
    batch = (time.perf_counter() - t0) / len(batches)
    print(f"  host work a training batch on this machine's CPU: render {render * 1e3:.3f} ms an unlabeled clip "
          f"({n} a batch, {n * render * 1e3:.3f} ms); assemble and pin {batch * 1e3:.3f} ms a batch of "
          f"{exp.pipeline.batch_size} ({len(batches)} batches), a ceiling of {1 / batch:.3f} steps/s for the loop")


def parity_epoch(card: str):
    """One short epoch of the Experiment on the card and on the CPU from the
    same state, dropout and noise 0: batches bit for bit, the scaler moments
    within 1e-5 of their largest, the epoch's loss means within 1e-4, the
    validation probabilities within 1e-4."""
    from dcase2019_task4_tpu_torch.config import Config
    from dcase2019_task4_tpu_torch.train.experiment import Experiment

    base = Config()
    cfg = dataclasses.replace(base, model=dataclasses.replace(base.model, dropout=0.0),
                              train=dataclasses.replace(base.train, noise_std=0.0))
    with quiet_log():
        exps = {dev: Experiment(cfg, subpart_data=PARITY_SUBPART, synthetic_audio=True, seed=SEED, device=dev).build()
                for dev in ("cuda", "cpu")}
    card_exp, cpu_exp = exps["cuda"], exps["cpu"]
    for key in ("mean_", "mean_of_square_"):
        a, b = getattr(card_exp.scaler, key), getattr(cpu_exp.scaler, key)
        err = float(np.abs(a - b).max() / np.abs(b).max())
        print(f"  scaler {key}: card against CPU {err:.3g} of the largest (limit 1e-5)")
        if not err <= 1e-5:
            raise AssertionError(f"scaler {key} differs by {err:.3g} of its largest")
    # the same state on both: the card's scaler, then the card's weights
    cpu_exp.scaler.load_state_dict(card_exp.scaler.state_dict())
    cpu_exp._build_steps()
    cpu_exp.state.student.load_state_dict(card_exp.state.student.state_dict())
    cpu_exp.state.teacher.load_state_dict(card_exp.state.teacher.state_dict())
    for a, b in zip(card_exp.pipeline.iter_epoch(0, prefetch=0), cpu_exp.pipeline.iter_epoch(0, prefetch=0)):
        for k in b:
            if not np.array_equal(a[k], b[k]):
                raise AssertionError(f"the epoch's batches differ in {k}")
    host_batch_times(card_exp)
    means = {}
    for dev, exp in exps.items():
        with quiet_log():
            means[dev] = exp.train_epoch(0).averages("")
    worst = max(abs(means["cuda"][k] - means["cpu"][k]) for k in means["cpu"])
    print(f"  parity epoch ({len(card_exp.pipeline)} steps at batch {card_exp.pipeline.batch_size}): loss means "
          f"card {means['cuda']['loss']:.6f}, CPU {means['cpu']['loss']:.6f}, largest difference {worst:.3g} "
          f"(limit 1e-4)")
    if not worst <= 1e-4:
        raise AssertionError(f"an epoch loss mean differs by {worst:.3g}")
    for stream in ("valid_synth_stream", "valid_weak_stream"):
        got = [(s.cpu(), w.cpu()) for _, s, w in card_exp._eval_batches(getattr(card_exp, stream))]
        want = [(s, w) for _, s, w in cpu_exp._eval_batches(getattr(cpu_exp, stream))]
        err = max(float((a - b).abs().max()) for g, w in zip(got, want) for a, b in zip(g, w))
        print(f"  {stream} probabilities: card against CPU {err:.3g} (limit 1e-4)")
        if not err <= 1e-4:
            raise AssertionError(f"{stream} probabilities differ by {err:.3g}")


def phase_train_cli(card: str):
    """Phase 6: train_meanteacher for two epochs and train_crnn for one
    through the port's CLI at the flagship Config() on the card, the best
    checkpoint against a CPU evaluator, then one short epoch on the card and
    on the CPU. → launches by path."""
    from dcase2019_task4_tpu_torch.config import Config
    from dcase2019_task4_tpu_torch.eval.evaluate import CheckpointEvaluator

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        mt = os.path.join(tmp, "mt")
        launches["train_meanteacher"], records = train_cli(
            "train_meanteacher", ["--synthetic_audio", "-s", str(CLI_SUBPART), "--epochs", str(CLI_EPOCHS),
                                  "--store_dir", mt], card, STEP_MIN)
        if len(records) != CLI_EPOCHS:
            raise AssertionError(f"train_meanteacher wrote {len(records)} epoch records")
        launches["train_crnn"], _ = train_cli(
            "train_crnn", ["--synthetic_audio", "-s", str(CLI_SUBPART), "--epochs", "1",
                           "--store_dir", os.path.join(tmp, "crnn")], card, SUPERVISED_STEP)
        best = os.path.join(mt, "model", "baseline_best")
        with quiet_log():
            on = {dev: CheckpointEvaluator(best, device=dev, synthetic_audio=True).test_model(
                Config().paths.validation, PARITY_SUBPART) for dev in ("cuda", "cpu")}
        err = float(np.abs(on["cuda"]["strong"] - on["cpu"]["strong"]).max())
        print(f"  baseline_best restored by the CheckpointEvaluator: strong probabilities of {PARITY_SUBPART} "
              f"validation clips, card against CPU {err:.3g} (limit {STRONG_TOL}); event F1 card "
              f"{on['cuda']['event_macro_f1']:.4f}, CPU {on['cpu']['event_macro_f1']:.4f}")
        if not err <= STRONG_TOL:
            raise AssertionError(f"the best checkpoint's strong probabilities differ by {err:.3g}")
    parity_epoch(card)
    return launches, records


# phase 7: the rest of the user paths. One eval batch of the predict path
# (K1, K3f at blocks 2-3, K2f eval at the three blocks); K1 alone in precompute
PREDICT_BATCH = {name: count // 2 for name, count in PREDICT_MIN.items()}
PRECOMPUTE_BATCH = {"fused_stft_mel": 1}
LONG_SECONDS = {"long_25s.wav": 25.0, "long_07s.wav": 7.0, "long_10s.wav": 10.0}


@contextlib.contextmanager
def captured_experiments(seen: list):
    """Each Experiment a training CLI runs lands in `seen`."""
    from dcase2019_task4_tpu_torch.train.experiment import Experiment

    run = Experiment.run

    def recorded(self, *args, **kwargs):
        seen.append(self)
        return run(self, *args, **kwargs)

    Experiment.run = recorded
    try:
        yield
    finally:
        Experiment.run = run


def long_windows(lengths, overlap: bool):
    """The JAX package's windows (eval/evaluate.py:306-317) at the
    flagship, over the files in name order as a wav folder is read: 10 s
    windows, end to end or half a window apart on the pooled-frame grid.
    `lengths` maps a file to its samples. → [(file, start s)]."""
    from dcase2019_task4_tpu_torch.config import Config

    cfg = Config()
    d, ptr = cfg.dsp, cfg.model.pooling_time_ratio
    hop = max(1, (d.max_frames // ptr) // 2) * d.hop_length * ptr if overlap else d.max_samples
    return [(name, w * hop / d.sample_rate) for name in sorted(lengths)
            for w in range(1 + max(0, -(-(lengths[name] - d.max_samples) // hop)))]


def events_of(path: str):
    return [(r["event_label"], float(r["onset"]), float(r["offset"]), r["filename"]) for r in read_tsv(path)]


def decoded_timelines(probs, windows, overlap: bool, frame_s: float):
    """The probabilities the decoder thresholds, per file: each window's
    own [T', C] from its start, or (overlap) the file's windows averaged
    where they overlap into one timeline from 0 s, as predict_long does.
    → {file: [(start s, [n, C])]}."""
    out = {}
    for p, (name, t0) in zip(probs, windows):
        out.setdefault(name, []).append((t0, np.asarray(p, np.float64)))
    if overlap:
        for name, entries in out.items():
            first = [int(round(t0 / frame_s)) for t0, _ in entries]
            n = max(first) + entries[0][1].shape[0]
            buf = np.zeros((n, entries[0][1].shape[1]))
            cnt = np.zeros((n, 1))
            for f0, (_, p) in zip(first, entries):
                buf[f0:f0 + len(p)] += p
                cnt[f0:f0 + len(p)] += 1.0
            out[name] = [(0.0, buf / np.maximum(cnt, 1.0))]
    return out


def same_rows(what: str, got, want, probs_a, probs_b, windows, thresholds, median_windows, overlap: bool,
              frame_s: float):
    """Event rows equal, unless each row that differs has, of its own file
    and class and within its class's median window of its span, a
    probability of either run (as the decoder reads it: per window, or the
    averaged timeline under `overlap`) that lies within the runs' largest
    difference there of the class's threshold, where a decision may flip
    (printed, as tests/test_torch_experiment.py allows)."""
    if got == want:
        return
    from dcase2019_task4_tpu_torch.config import DEFAULT_CLASSES

    lines = [decoded_timelines(p, windows, overlap, frame_s) for p in (probs_a, probs_b)]
    diff = max(float(np.abs(pa - pb).max()) for name in lines[0]
               for (_, pa), (_, pb) in zip(lines[0][name], lines[1][name]))
    differ = sorted(set(got) ^ set(want))
    for label, on, off, name in differ:
        c = list(DEFAULT_CLASSES).index(label)
        margin = int(median_windows[c]) + 1
        near = 0
        for line in lines:
            for t0, p in line[name]:
                lo = max(0, int(np.floor((on - t0) / frame_s)) - margin)
                hi = min(len(p), int(np.ceil((off - t0) / frame_s)) + margin)
                if lo < hi:
                    near += int((np.abs(p[lo:hi, c] - thresholds[c]) <= diff).sum())
        print(f"  {what}: row {(label, on, off, name)} differs; {near} of its class's probabilities near its span "
              f"lie within {diff:.3g} of the threshold")
        if near == 0:
            raise AssertionError(f"{what}: the event row {(label, on, off, name)} differs with no probability of "
                                 f"its file and class near the threshold")


def resident_epoch(card: str, streamed_records, work: str):
    """(a) `train_meanteacher --device_cache` at phase 6's flagship run:
    the resident rows, epoch 0's gathered batches against the streamed
    pipeline's bit for bit, each epoch's loss means within 1e-4 of phase
    6's streamed records, the training kernels exactly their count a step.
    → (launches, the best checkpoint)."""
    import torch

    mt = os.path.join(work, "mt_resident")
    # every batch is kept on the card (clones: nothing is copied to the host
    # inside the loop); epoch 0's are compared after the run
    exps, seen = [], {"steps": 0, "keep": float("inf"), "kept": []}
    with captured_experiments(exps):
        launches, records = train_cli(
            "train_meanteacher", ["--synthetic_audio", "-s", str(CLI_SUBPART), "--epochs", str(CLI_EPOCHS),
                                  "--store_dir", mt, "--device_cache"], card, STEP_MIN, seen)
    (exp,) = exps
    dd = exp._device_data
    steps = len(exp.pipeline)
    if dd is None or len(records) != CLI_EPOCHS or seen["steps"] != CLI_EPOCHS * steps:
        raise AssertionError(f"the resident run: {len(records)} records, {seen['steps']} steps")
    on_card = sum(t.numel() * t.element_size() for t in dd.data.values())
    if off_card(dd.data):
        raise AssertionError(f"the resident arrays {off_card(dd.data)} are not on the card")
    print(f"  resident dataset: {dd.n_real} clips in {dd.data['audio'].shape[0]} rows, {on_card / 2**20:.1f} MiB on "
          f"the card (estimate {dd.nbytes / 2**20:.1f} MiB) on {card}")
    for s in exp.epoch_stats:
        print(f"  resident epoch {s['epoch']}: the loop {s['seconds']:.3f} s for {s['steps']} steps = "
              f"{s['steps'] / s['seconds']:.3f} steps/s, queue wait {s['queue_wait_s']:.1f} s on {card}")
    got = seen["kept"][:steps]
    for i, want in enumerate(exp.pipeline.iter_epoch(0, prefetch=0)):
        for k in want:
            if not np.array_equal(got[i][k].cpu().numpy(), want[k]):
                raise AssertionError(f"epoch 0 batch {i}: the gathered {k} is not the streamed pipeline's")
    print(f"  epoch 0's {steps} gathered batches equal the streamed pipeline's bit for bit")
    del seen["kept"][:]
    worst = 0.0
    for mine, theirs in zip(records, streamed_records):
        for k in theirs:
            if "loss" in k or k.startswith("consistency_"):
                worst = max(worst, abs(mine[k] - theirs[k]))
    print(f"  per-epoch loss means against phase 6's streamed run: largest difference {worst:.3g} (limit {TRAIN_TOL})")
    if not worst <= TRAIN_TOL:
        raise AssertionError(f"a resident epoch's loss mean differs from the streamed run's by {worst:.3g}")
    torch.cuda.synchronize()
    return launches, os.path.join(mt, "model", "baseline_best")


def tuned_thresholds(card: str, best: str, work: str):
    """(b) `evaluate --tune_thresholds --save_thresholds` on the resident
    run's best checkpoint (24 validation clips): the three JSON files with
    the ten classes; then `predict` reads them back, and its events are the
    decode of its probabilities under them. → (launches by path, the
    event thresholds and windows flags, the event thresholds, the
    windows)."""
    import torch

    from dcase2019_task4_tpu_torch import cli
    from dcase2019_task4_tpu_torch.config import DEFAULT_CLASSES, Config
    from dcase2019_task4_tpu_torch.data.encoder import LabelCodec
    from dcase2019_task4_tpu_torch.data.manifests import load_manifest, subpart_manifest
    from dcase2019_task4_tpu_torch.eval.decode import decode_batch

    cfg = Config()
    validation = cfg.paths.validation
    saved = os.path.join(work, "tuned.json")
    launches = {}
    with quiet_log():
        zero_launches()
        t0 = time.perf_counter()
        res = cli.evaluate(["-m", best, "--synthetic_audio", "-s", str(PARITY_SUBPART), "--sets", validation,
                            "--tune_thresholds", "--save_thresholds", saved, "--device", "cuda"])[validation]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches["evaluate_tune_thresholds"] = read_launches()
    check_launches(launches["evaluate_tune_thresholds"], PREDICT_BATCH, 1, "evaluate --tune_thresholds")
    root, ext = os.path.splitext(saved)
    files = {"weak": saved, "event": f"{root}.event{ext}", "windows": f"{root}.event_windows{ext}"}
    tuned = {}
    for what, path in files.items():
        with open(path) as f:
            tuned[what] = json.load(f)
        if list(tuned[what]) != list(DEFAULT_CLASSES):
            raise AssertionError(f"{path} holds {list(tuned[what])}, not the ten classes")
    print(f"  evaluate --tune_thresholds on {PARITY_SUBPART} validation clips: {wall:.2f} s on {card}; weak macro F1 "
          f"{res['weak_macro_f1']:.4f} → tuned {res['tuned_weak_macro_f1']:.4f}, event macro F1 "
          f"{res['event_macro_f1']:.4f} → tuned {res['tuned_event_macro_f1']:.4f}; windows "
          f"{sorted(set(tuned['windows'].values()))}; three JSON files of ten classes written")
    out = os.path.join(work, "tuned_events.tsv")
    with quiet_log():
        zero_launches()
        pred = cli.predict(["-m", best, "-i", validation, "-s", str(PARITY_SUBPART), "--synthetic_audio", "-p", out,
                            "--thresholds_json", files["event"], "--median_windows_json", files["windows"],
                            "--device", "cuda"])
        torch.cuda.synchronize()
        launches["predict_tuned"] = read_launches()
    check_launches(launches["predict_tuned"], PREDICT_BATCH, 1, "predict with the tuned JSON files")
    d = cfg.dsp
    names = subpart_manifest(load_manifest(validation), PARITY_SUBPART).filenames
    codec = LabelCodec(DEFAULT_CLASSES, d.max_frames // cfg.model.pooling_time_ratio)
    want = decode_batch(torch.as_tensor(pred["strong"]), names, codec, d.sample_rate, d.hop_length,
                        cfg.model.pooling_time_ratio, threshold=np.asarray(list(tuned["event"].values())),
                        median_window=np.asarray(list(tuned["windows"].values())))
    if events_of(out) != want:
        raise AssertionError("predict's events are not the decode of its probabilities under the tuned files")
    print(f"  predict --thresholds_json --median_windows_json: {len(want)} event rows, the decode under the tuned "
          f"thresholds and windows")
    return (launches, ["--thresholds_json", files["event"], "--median_windows_json", files["windows"]],
            np.asarray(list(tuned["event"].values())), np.asarray(list(tuned["windows"].values())))


def long_predict(card: str, best: str, work: str, tuned, thresholds, median_windows):
    """(c) `predict --long` and `--long --overlap` on wavs of 25, 7 and 10 s,
    with the tuned thresholds and windows (`tuned`: their flags;
    `thresholds`, `median_windows`: the values they hold): the JAX
    package's window count, strong probabilities within 1e-4 of the CPU
    run's, the same TSV rows. → launches by path."""
    import torch

    from dcase2019_task4_tpu_torch import cli
    from dcase2019_task4_tpu_torch.config import DEFAULT_CLASSES, Config
    from dcase2019_task4_tpu_torch.data.audio_io import synth_clip, write_wav

    cfg = Config()
    d, frames = cfg.dsp, cfg.dsp.max_frames // cfg.model.pooling_time_ratio
    wav_dir = os.path.join(work, "long_wavs")
    os.makedirs(wav_dir)
    rng = np.random.default_rng(SEED)
    lengths = {}
    for name, dur in LONG_SECONDS.items():
        events = []
        for _ in range(int(rng.integers(2, 5))):
            on = float(rng.uniform(0, dur - 0.5))
            events.append((int(rng.integers(0, len(DEFAULT_CLASSES))), on, on + float(rng.uniform(0.5, dur - on))))
        audio = np.clip(synth_clip(name, events, dur, d.sample_rate), -1, 1)
        write_wav(os.path.join(wav_dir, name), audio, d.sample_rate)
        lengths[name] = len(audio)
    frame_s = d.hop_length * cfg.model.pooling_time_ratio / d.sample_rate
    launches = {}
    for path, flags in (("predict_long", []), ("predict_long_overlap", ["--overlap"])):
        runs = {}
        for dev in ("cuda", "cpu"):
            out = os.path.join(work, f"{path}_{dev}.tsv")
            with quiet_log():
                zero_launches()
                t0 = time.perf_counter()
                res = cli.predict(["-m", best, "-i", wav_dir, "-p", out, "--long", *flags, *tuned, "--device", dev])
                if dev == "cuda":
                    torch.cuda.synchronize()
                    launches[path] = read_launches()
                runs[dev] = (res, events_of(out), time.perf_counter() - t0)
        res, rows, wall = runs["cuda"]
        windows = long_windows(lengths, bool(flags))
        want = len(windows)
        if res["n_windows"] != want or runs["cpu"][0]["n_windows"] != want or res["n_files"] != len(LONG_SECONDS):
            raise AssertionError(f"{path}: {res['n_windows']} windows, the formula gives {want}")
        check_launches(launches[path], PREDICT_BATCH, -(-want // 24), path)
        strong, cpu_strong = res["strong"], runs["cpu"][0]["strong"]
        if strong.shape != (want, frames, len(DEFAULT_CLASSES)) or not np.isfinite(strong).all():
            raise AssertionError(f"{path}: strong probabilities of shape {strong.shape}")
        diff = float(np.abs(strong - cpu_strong).max())
        print(f"  {path}: {len(LONG_SECONDS)} files ({', '.join(f'{s:g} s' for s in LONG_SECONDS.values())}), "
              f"{want} windows, {len(rows)} event rows, {wall:.2f} s on {card} (CPU {runs['cpu'][2]:.2f} s); "
              f"strong against the CPU run {diff:.3g} (limit {STRONG_TOL})")
        if not diff <= STRONG_TOL:
            raise AssertionError(f"{path}: card and CPU strong probabilities differ by {diff:.3g}")
        for label, on, off, fname in rows:
            if not 0.0 <= on < off <= LONG_SECONDS[fname] + 1e-6:
                raise AssertionError(f"{path}: bad event row {(label, on, off, fname)}")
        same_rows(path, rows, runs["cpu"][1], strong, cpu_strong, windows, thresholds, median_windows, bool(flags),
                  frame_s)
    return launches


@contextlib.contextmanager
def metadata_set(names):
    """A filename TSV in a fresh folder of the checkout's dataset_metadata,
    and its audio folder where the configuration maps it (as a user lays
    out a set for `precompute`); both removed at the end. → (tsv, audio
    folder)."""
    import shutil

    from dcase2019_task4_tpu_torch.config import Config

    paths = Config().paths
    meta = tempfile.mkdtemp(prefix="chip_smoke_", dir=paths.metadata_dir)
    tsv = os.path.join(meta, "clips.tsv")
    audio = paths.audio_dir_for_meta(tsv)
    made = audio  # the outermost folder this makes
    while not os.path.exists(os.path.dirname(made)):
        made = os.path.dirname(made)
    try:
        with open(tsv, "w") as f:
            f.write("filename\n" + "".join(f"{n}\n" for n in names))
        os.makedirs(audio)
        yield tsv, audio
    finally:
        shutil.rmtree(meta)
        shutil.rmtree(made, ignore_errors=True)


def precompute_cli(card: str, work: str):
    """(d) `precompute` of 48 synthetic 10 s clips on the card and on the
    CPU: the same files, each within 1e-5 of max of the CPU run's. →
    launches by path."""
    import torch

    from dcase2019_task4_tpu_torch import cli
    from dcase2019_task4_tpu_torch.config import Config
    from dcase2019_task4_tpu_torch.data.audio_io import write_wav
    from dcase2019_task4_tpu_torch.data.features_cache import NpyFeatureSource

    cfg = Config()
    names, _, clips = make_clips(N_CLIPS, np.random.default_rng(SEED))
    launches, walls = {}, {}
    with metadata_set(names) as (tsv, audio_dir):
        for name, audio in zip(names, clips):
            write_wav(os.path.join(audio_dir, name), audio, cfg.dsp.sample_rate)
        for dev in ("cuda", "cpu"):
            with quiet_log():
                zero_launches()
                t0 = time.perf_counter()
                done = cli.precompute(["--sets", tsv, "--feature_dir", os.path.join(work, dev), "--device", dev])
                if dev == "cuda":
                    torch.cuda.synchronize()
                    launches["precompute"] = read_launches()
                walls[dev] = time.perf_counter() - t0
            if done != {tsv: names}:
                raise AssertionError(f"precompute on {dev} cached {done}")
    check_launches(launches["precompute"], PRECOMPUTE_BATCH, N_CLIPS // 24, "precompute")
    card_files, cpu_files = (NpyFeatureSource(cfg, os.path.join(work, dev)) for dev in ("cuda", "cpu"))
    worst = 0.0
    for name in names:
        a, b = card_files.get_features(name), cpu_files.get_features(name)
        if a.shape != b.shape or a.shape[1] != cfg.dsp.n_mels or not np.isfinite(a).all():
            raise AssertionError(f"precompute: {name} has shape {a.shape} on the card, {b.shape} on the CPU")
        worst = max(worst, float(np.abs(a - b).max() / np.abs(b).max()))
    print(f"  precompute: {len(names)} clips to .npy in {walls['cuda']:.2f} s on {card} (CPU {walls['cpu']:.2f} s), "
          f"card against CPU {worst:.3g} of max (limit 1e-5)")
    if not worst <= 1e-5:
        raise AssertionError(f"precomputed features differ by {worst:.3g} of max")
    return launches


def phase_rest(card: str, streamed_records):
    """Phase 7: the resident training epoch, threshold tuning, long-clip
    predict and feature precompute through the port's CLI on the card. →
    launches by path."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        launches, best = resident_epoch(card, streamed_records, work)
        launches = {"train_meanteacher_device_cache": launches}
        tuned_launches, tuned, thresholds, windows = tuned_thresholds(card, best, work)
        launches.update(tuned_launches)
        launches.update(long_predict(card, best, work, tuned, thresholds, windows))
        launches.update(precompute_cli(card, work))
    print(f"  phase 7: {time.perf_counter() - t0:.1f} s")
    return launches


# phase 8: data parallel. (a) the training CLI under --data_parallel in a
# group of one NCCL rank; (b) two ranks on the one card over Gloo (NCCL
# refuses two ranks on one device) against one process over their global
# batch; (c) evaluate --data_parallel on those two ranks against one
# process. Two ranks that share a card show correctness, not scaling.
DP_WORLD = 2
DP_RANK_SIZES = (6, 12, 6)  # a rank's [weak | unlabeled | synthetic]; the global batch is 48
DP_PATHS = {"step": ({}, False), "step_entry_block": ({"entry_block_pallas": True}, False),
            "step_crows": ({"entry_block_crows": True}, False), "step_entry_conv": ({"entry_conv_pallas": True}, False),
            "step_bf16": ({}, True)}
# a Mean-Teacher step's collectives under every first-block path: Σy, Σy²
# of both models' three blocks, S1 / S2 of the student's three backward
# passes, one flat gradient buffer
DP_COLLECTIVES = {"bn_stats": 6, "bn_backward": 3, "gradients": 1}
BN_TOL = 1e-5
DP_EVAL_SUBPART, DP_EVAL_THRESHOLD = 24, 0.05
CHILD = [sys.executable, os.path.abspath(__file__)]  # the command of a phase-8 process


def dp_config(flags: dict, bf16: bool):
    """The flagship `Config()` with dropout and noise 0, the first-block
    `flags`, float32 or bfloat16 compute."""
    from dcase2019_task4_tpu_torch.config import Config

    base = Config()
    model = dataclasses.replace(base.model, dropout=0.0, compute_dtype="bfloat16" if bf16 else "float32", **flags)
    return dataclasses.replace(base, model=model, train=dataclasses.replace(base.train, noise_std=0.0))


def at_rate_zero(per_step: dict) -> dict:
    """A path's launches a step with the dropout off: each forward kernel
    counts under its eval form (the wrappers count by the rate), the crows
    forward on the fused entry block's own counter."""
    out = {}
    for name, count in per_step.items():
        if name.startswith("crows_fwd"):
            continue
        if name.startswith(("fused_bn_glu_pool_train", "entry_block_fwd_train")):
            name = name.replace("_train", "_eval")
        out[name] = out.get(name, 0) + count
    return out


def dp_step(cfg, dev, packed, scaler, sizes, path: str, mesh=None) -> dict:
    """One Mean-Teacher step from the seeded state on the batch `packed`
    laid out `sizes` ([weak | unlabeled | synthetic]); with `mesh` one
    rank's. → its metrics (the ranks' mean), the student's gradients, both
    models' BatchNorm buffers, the parameters after it, its launches
    (checked exact) and its collectives, on the host."""
    import torch

    from dcase2019_task4_tpu_torch.parallel import mesh as pmesh

    state = seeded_state(cfg, dev)
    if mesh is not None:
        pmesh.replicate_state(state, mesh)
    step, batch = built_step(cfg, dev, packed, scaler, sizes[0], sizes[1], mesh=mesh)
    zero_launches()
    pmesh.collectives.clear()
    state, metrics, _ = step(state, batch, torch.Generator(device=dev).manual_seed(SEED), step.zero_metrics(dev))
    torch.cuda.synchronize()
    launches, collectives = read_launches(), dict(pmesh.collectives)
    check_launches(launches, at_rate_zero(PATHS[path]), 1, f"{path} data-parallel step")
    metrics = step.mean_over_ranks(metrics)

    def host(named):
        return {k: v.detach().float().cpu().clone() for k, v in named}

    buffers = {f"{who}.{k}": v for who, model in (("student", state.student), ("teacher", state.teacher))
               for k, v in host((k, v) for k, v in model.state_dict().items() if "running_" in k).items()}
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": host((n, p.grad) for n, p in state.student.named_parameters()),
            "params": host(state.student.named_parameters()), "bn": buffers, "collectives": collectives,
            "launches": launches}


def dp_rank_rows(world: int = DP_WORLD) -> np.ndarray:
    """Rows of the stream-major global batch in the ranks' shard-major order."""
    from dcase2019_task4_tpu_torch.parallel.mesh import interleave_for_sharding

    return interleave_for_sharding(np.arange(sum(DP_RANK_SIZES) * world), DP_RANK_SIZES, world)


def child_dp_ranks(args: dict) -> int:
    """(b) and (c) in one rank: the step under every path of DP_PATHS on
    this rank's cut of the global batch, then `evaluate --data_parallel`."""
    import torch

    from dcase2019_task4_tpu_torch import cli
    from dcase2019_task4_tpu_torch.parallel import mesh as pmesh, multihost

    rank, world, device = args["rank"], args["world"], torch.device(args["device"])
    multihost.initialize(f"file://{args['store']}", world, rank, backend=args["backend"], device=device)
    try:
        mesh = pmesh.make_mesh(device)
        data = np.load(args["batch"])
        n = sum(DP_RANK_SIZES)
        rows = dp_rank_rows(world)[rank * n:(rank + 1) * n]
        packed = tuple(data[k][rows] for k in ("audio", "frames", "target"))
        out = {"backend": mesh.backend, "world_size": mesh.world_size}
        for path, (flags, bf16) in DP_PATHS.items():
            t0 = time.perf_counter()
            out[path] = dp_step(dp_config(flags, bf16), device, packed, (data["mean"], data["std"]), DP_RANK_SIZES,
                                path, mesh)
            out[path]["seconds"] = time.perf_counter() - t0
        with quiet_log():
            zero_launches()
            out["evaluate"] = cli.evaluate(args["evaluate"] + ["--device", str(device), "--data_parallel"])
            out["evaluate_launches"] = read_launches()
        torch.save(out, f"{args['out']}.rank{rank}.pt")
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()
    return 0


def child_world1(args: dict) -> int:
    """(a) in a child whose environment is torchrun's for one rank:
    `train_meanteacher --data_parallel` at phase 6's run, its launches and
    its collectives a step."""
    import torch.distributed as dist

    from dcase2019_task4_tpu_torch.parallel import mesh as pmesh
    from dcase2019_task4_tpu_torch.train import steps

    per_step, real = [], steps.TrainStep.__call__

    def counted(self, *a, **kw):
        before = dict(pmesh.collectives)
        out = real(self, *a, **kw)
        per_step.append({k: v - before.get(k, 0) for k, v in pmesh.collectives.items() if v != before.get(k, 0)})
        return out

    steps.TrainStep.__call__ = counted
    try:
        launches, records = train_cli("train_meanteacher", args["argv"], args["card"], STEP_MIN)
    finally:
        steps.TrainStep.__call__ = real
    out = {"backend": str(dist.get_backend()), "world_size": dist.get_world_size(), "launches": launches,
           "records": records, "per_step": per_step}
    dist.destroy_process_group()
    with open(args["out"], "w") as f:
        json.dump(out, f)
    return 0


def start_children(kind: str, args_per_child, env_per_child=None):
    """`python3 chip_smoke.py --child kind ARGS` for each entry, all at once
    → a function that waits for them (`timeout` seconds in all), stops every
    one still running when one fails or the time is up, prints their output
    indented, and fails unless each exited 0."""
    env_per_child = env_per_child or [{}] * len(args_per_child)
    procs = [subprocess.Popen([*CHILD, "--child", kind, json.dumps(a)], cwd=REPO,
                              env=dict(os.environ, **e), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for a, e in zip(args_per_child, env_per_child)]

    def wait(timeout: float = 600.0):
        outs = [""] * len(procs)
        try:
            deadline = time.monotonic() + timeout
            for i, p in enumerate(procs):
                outs[i] = p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for i, (p, text) in enumerate(zip(procs, outs)):
            for line in (text or "").splitlines():
                print(f"    [{kind} {i}] {line}")
            if p.returncode != 0:
                raise AssertionError(f"{kind} child {i} exited {p.returncode}")

    return wait


def free_port() -> int:
    """A free TCP port on this machine's loopback (torchrun's MASTER_PORT)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dp_world1(card: str, streamed_records, work: str):
    """(a) → (launches, the best checkpoint, collectives a step)."""
    mt = os.path.join(work, "mt_dp")
    out = os.path.join(work, "world1.json")
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(free_port())}
    t0 = time.perf_counter()
    start_children("world1", [{"card": card, "out": out,
                               "argv": ["--synthetic_audio", "-s", str(CLI_SUBPART), "--epochs", str(CLI_EPOCHS),
                                        "--store_dir", mt, "--data_parallel"]}], [env])()
    with open(out) as f:
        res = json.load(f)
    print(f"  (a) train_meanteacher --data_parallel in a group of {res['world_size']} over {res['backend']}: "
          f"{time.perf_counter() - t0:.1f} s with the child's start")
    if res["backend"] != "nccl" or res["world_size"] != 1:
        raise AssertionError(f"(a) ran over {res['backend']} at world size {res['world_size']}")
    per_step = res["per_step"]
    if not per_step or any(s != DP_COLLECTIVES for s in per_step):
        raise AssertionError(f"(a) collectives a step {per_step[:3]}..., expected {DP_COLLECTIVES}")
    print(f"  (a) collectives a step, every one of {len(per_step)} steps: {DP_COLLECTIVES} (one NCCL all-reduce each)")
    worst = 0.0
    for mine, theirs in zip(res["records"], streamed_records):
        for k in theirs:
            if "loss" in k or k.startswith("consistency_"):
                worst = max(worst, abs(mine[k] - theirs[k]))
        print(f"  (a) epoch {mine['epoch']}: {mine['steps_per_s']:.3f} steps/s under --data_parallel against "
              f"{theirs['steps_per_s']:.3f} in phase 6, on {card}")
    print(f"  (a) per-epoch loss means against phase 6's run: largest difference {worst:.3g} (limit {TRAIN_TOL})")
    if len(res["records"]) != CLI_EPOCHS or not worst <= TRAIN_TOL:
        raise AssertionError(f"(a) {len(res['records'])} epochs, loss means {worst:.3g} from phase 6's")
    return res["launches"], os.path.join(mt, "model", "baseline_best"), DP_COLLECTIVES


def dp_compare(path: str, single: dict, ranks, bf16: bool):
    """One path's ranks against the one process: metrics, gradients
    (the bfloat16 step at phase 5's bfloat16 bars), both models' BatchNorm
    buffers, the ranks' parameters bit for bit, launches and collectives."""
    import torch

    r0 = ranks[0]
    for r in ranks:
        if r["collectives"].get("bn_stats") != 6 or r["collectives"].get("bn_backward") != 3 \
                or r["collectives"].get("gradients") != 1:
            raise AssertionError(f"{path}: a rank's collectives {r['collectives']}")
    worst_m = max(abs(r0["metrics"][k] - v) for k, v in single["metrics"].items())
    if not worst_m <= TRAIN_TOL:
        raise AssertionError(f"{path}: the ranks' metrics differ from one process's by {worst_m:.3g}")
    names = list(single["grads"])
    if bf16:
        top = max(g.abs().max().item() for g in single["grads"].values())
        worst, worst_gauge, share = 0.0, 0.0, 0.0
        for name in names:
            want, got = single["grads"][name], r0["grads"][name]
            gauge = is_gauge_leaf(name)
            floor = SCALED_GAUGE_FLOOR if gauge else SCALED_GRAD_FLOOR
            limit = SCALED_GRAD_TOL * want.abs().max().item() + floor * top
            err = (got - want).abs().max().item()
            if not err <= limit:
                raise AssertionError(f"{path}, {name}: the ranks' gradient differs by {err} (limit {limit})")
            if gauge:
                worst_gauge = max(worst_gauge, err / limit)
            else:
                worst = max(worst, err / limit)
                share = max(share, err / want.abs().max().item())
        grad_note = (f"worst leaf at {worst:.2f} of its limit ({SCALED_GRAD_TOL} of its max + {SCALED_GRAD_FLOOR} of "
                     f"the largest; {share:.2e} of its max), worst gauge leaf at {worst_gauge:.2f}")
    else:
        worst, worst_gauge = compare_step1_gradients(names, [single["grads"][n] for n in names],
                                                     [r0["grads"][n] for n in names], f"{path}, {len(ranks)} ranks against one")
        grad_note = (f"worst leaf at {worst:.2f} of its limit ({TRAIN_TOL} of its max), worst gauge leaf at "
                     f"{worst_gauge:.2f}")
    worst_bn = max((r0["bn"][k] - v).abs().max().item() for k, v in single["bn"].items())
    if not worst_bn <= BN_TOL:
        raise AssertionError(f"{path}: a BatchNorm buffer differs by {worst_bn:.3g} (limit {BN_TOL})")
    for r in ranks[1:]:
        for name, v in r0["params"].items():
            if not torch.equal(v, r["params"][name]):
                raise AssertionError(f"{path}: the ranks' {name} differ after the step")
    seconds = " / ".join(f"{r['seconds']:.1f}" for r in ranks)
    print(f"  (b) {path}: metrics within {worst_m:.3g} (limit {TRAIN_TOL}); gradients {grad_note}; BatchNorm "
          f"buffers of both models within {worst_bn:.3g} (limit {BN_TOL}); the ranks' parameters bit-equal; "
          f"collectives {r0['collectives']}; step in the ranks {seconds} s (first call of its kernels included)")


def dp_against_one(device, best: str, work: str, world: int, backend: str, rank_devices):
    """(b) and (c): `world` ranks over `backend`, rank r on `rank_devices[r]`,
    each on its [6|12|6] cut of a global batch of world × 24 clips, against
    one process on `device` over the whole batch, under every path of
    DP_PATHS; then `evaluate --data_parallel` on the ranks against one
    process, on `best`. → launches by path."""
    import torch

    from dcase2019_task4_tpu_torch import cli
    from dcase2019_task4_tpu_torch.config import Config
    from dcase2019_task4_tpu_torch.utils.scaler import Scaler

    launches = {}
    sizes = [b * world for b in DP_RANK_SIZES]
    cfg0 = dp_config({}, False)
    audio, frames, target = train_batch(cfg0, *sizes)
    mean, std = Scaler().load_state_dict(
        fit_scaler(flagship_frontend(device, cfg0, onedot=False), audio, frames, device)).mean_std_f32
    batch_path = os.path.join(work, "batch.npz")
    np.savez(batch_path, audio=audio, frames=frames, target=target, mean=mean, std=std)
    # a low threshold, so the 2-epoch model's TSV has rows; the tuners too
    eval_args = ["-m", best, "--synthetic_audio", "-s", str(DP_EVAL_SUBPART), "--sets", Config().paths.validation,
                 "--threshold", str(DP_EVAL_THRESHOLD), "--tune_thresholds", "-p"]
    out = os.path.join(work, "ranks")
    t0 = time.perf_counter()
    wait = start_children("ranks", [{"rank": r, "world": world, "backend": backend, "device": str(rank_devices[r]),
                                     "store": os.path.join(work, "store"), "batch": batch_path, "out": out,
                                     "evaluate": eval_args + [os.path.join(work, "ranks_eval.tsv")]}
                                    for r in range(world)])
    # the one process over the global batch while the ranks start
    single = {}
    try:
        for path, (flags, bf16) in DP_PATHS.items():
            single[path] = dp_step(dp_config(flags, bf16), device, (audio, frames, target), (mean, std), sizes, path)
    except BaseException:
        with contextlib.suppress(Exception):
            wait(timeout=1.0)  # stops the ranks
        raise
    wait()
    what = f"{world} {backend} ranks"
    print(f"  (b, c) {what}: {time.perf_counter() - t0:.1f} s with their start")
    ranks = [torch.load(f"{out}.rank{r}.pt", weights_only=False) for r in range(world)]
    if any(r["backend"] != backend or r["world_size"] != world for r in ranks):
        raise AssertionError(f"(b) the ranks did not run as a {backend} group of {world}")
    for path, (_, bf16) in DP_PATHS.items():
        dp_compare(path, single[path], [r[path] for r in ranks], bf16)
        launches[f"{path}_{world}_ranks"] = ranks[0][path]["launches"]

    # (c) the same evaluate in one process
    with quiet_log():
        zero_launches()
        one = cli.evaluate(eval_args + [os.path.join(work, "single_eval.tsv"), "--device", str(device)])
        launches["evaluate_one_process"] = read_launches()
    for r in ranks:
        if r["evaluate"] != one:
            raise AssertionError(f"(c) evaluate on {what} {r['evaluate']} against one process {one}")
    rows_ranks = read_tsv(os.path.join(work, "ranks_eval.tsv"))
    rows_one = read_tsv(os.path.join(work, "single_eval.tsv"))
    if rows_ranks != rows_one:
        raise AssertionError(f"(c) the TSVs differ: {len(rows_ranks)} rows on {what}, {len(rows_one)} in one")
    (res,) = one.values()
    n_ranks = [r["evaluate_launches"]["fused_stft_mel"] for r in ranks]
    print(f"  (c) evaluate --data_parallel --threshold {DP_EVAL_THRESHOLD} --tune_thresholds on {what} "
          f"({DP_EVAL_SUBPART} validation clips, K1 launched {n_ranks} times by the ranks, "
          f"{launches['evaluate_one_process']['fused_stft_mel']} by one process): event F1 "
          f"{res['event_macro_f1']:.4f}, weak F1 {res['weak_macro_f1']:.4f}, tuned event F1 "
          f"{res['tuned_event_macro_f1']:.4f}, {len(rows_one)} TSV rows: all equal to one process's")
    return launches


def phase_data_parallel(device, card: str, streamed_records):
    """Phase 8 → (launches by path, the counts of the kernels line's
    "parallel" entry)."""
    t_phase = time.perf_counter()
    launches = {}
    with tempfile.TemporaryDirectory() as work:
        launches["train_meanteacher_data_parallel"], best, per_step = dp_world1(card, streamed_records, work)
        launches.update(dp_against_one(device, best, work, DP_WORLD, "gloo", [device] * DP_WORLD))
    print(f"  phase 8: {time.perf_counter() - t_phase:.1f} s")
    return launches, {"collectives_a_step": per_step, "gloo_ranks_on_one_card": DP_WORLD,
                      "paths_held": list(DP_PATHS)}


def data_parallel_cards(n_cards: int) -> int:
    """`python3 chip_smoke.py --cards N`: phase 8's (b) and (c) with one NCCL
    rank a card on N cards, against one process on the first, on the seeded
    flagship checkpoint of phase 4; after the build, and nothing else. The
    last line is the result line, with the cards' count."""
    import torch

    from dcase2019_task4_tpu_torch.ops import _build

    if torch.cuda.device_count() < n_cards:
        print(f"chip_smoke --cards {n_cards}: {torch.cuda.device_count()} cards", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    card = card_line()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    info = _build.build()
    print(f"  built in {info['seconds']:.2f} s")
    device = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as work:
        _, paths = write_inputs(work, device)
        launches = dp_against_one(device, paths[0], work, n_cards, "nccl",
                                  [torch.device("cuda", r) for r in range(n_cards)])
    print(f"  {n_cards} NCCL ranks, one a card: {time.perf_counter() - t0:.1f} s in all on {card} (each card)")
    print(card)
    print(json.dumps({"parallel": {"nccl_ranks": n_cards, "paths_held": list(DP_PATHS),
                                   "launches_by_path": launches}}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


# ------------------------------------------------------------------ phase 9

# One call of a serving artifact at batch 24: exactly these launches
SERVE = {"fused_stft_mel": 1, "conv2d_forward": 2, "fused_bn_glu_pool_eval": 3}
SERVE_ENTRY_BLOCK = {"fused_stft_mel": 1, "conv2d_forward": 2, "fused_bn_glu_pool_eval": 2, "entry_block_fwd_eval": 1}
SERVE_ENTRY_CONV = dict(SERVE, entry_conv=1)
SERVE_CROWS = dict(SERVE_ENTRY_BLOCK, crows_fwd_eval=1)  # K5f's kernel, counted on crows' own counter too
SERVE_BF16_ENTRY_BLOCK = {"fused_stft_mel": 1, "conv2d_forward_bf16": 2, "fused_bn_glu_pool_eval_bf16": 2,
                          "entry_block_fwd_eval_bf16": 1}
SERVE_TOL = 1e-6  # artifact against the evaluator's direct path, as a share of the largest probability
# the CUDA kernel a row of the default step launches, as torch.profiler names it
STEP_KERNELS = {"fused_stft_mel": "fused_stft_mel_kernel", "conv2d_forward": "conv3x3_nhwc_kernel",
                "conv2d_dx": "conv3x3_nhwc_kernel", "conv2d_wgrad": "conv3x3_wgrad_kernel",
                "fused_bn_glu_pool_train": "bn_glu_pool_kernel", "batch_stats": "stats_kernel",
                "bwd_reduce": "bn_glu_pool_bwd_kernel", "bwd_fixup": "bn_bwd_fixup_kernel"}
PORT_PACKAGES = ("models", "train", "data", "eval")


def port_modules_beyond_export():
    """The port's models / train / data / eval modules this process holds,
    but for `eval.export` (and its package)."""
    return sorted(m for m in sys.modules if m.startswith("dcase2019_task4_tpu_torch.")
                  and m.split(".")[1] in PORT_PACKAGES
                  and m not in ("dcase2019_task4_tpu_torch.eval", "dcase2019_task4_tpu_torch.eval.export"))


def warm_ms(fn, runs: int = 5) -> float:
    """Median host ms of `runs` synchronised calls after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def call_artifact(served, audio, frames, per_call: dict, what: str):
    """One call of a loaded artifact, its launches held exact (K6's on
    crows' own counter under "crows_fwd_eval") → (strong, weak, launches,
    warm ms)."""
    import torch

    from dcase2019_task4_tpu_torch.ops import crows_block

    zero_launches()
    crows_before = crows_block.crows_apply.launches_eval
    strong, weak = served(audio, frames)
    torch.cuda.synchronize()
    launches = read_launches()
    check_launches(launches, per_call, 1, f"one call of the {what} artifact")
    launches["crows_fwd_eval"] = crows_block.crows_apply.launches_eval - crows_before
    if launches["crows_fwd_eval"] != per_call.get("crows_fwd_eval", 0):
        raise AssertionError(f"the {what} artifact launched K6 {launches['crows_fwd_eval']} times")
    ms = warm_ms(lambda: served(audio, frames))
    return strong.cpu().numpy(), weak.cpu().numpy(), {k: v for k, v in launches.items() if v}, ms


def child_serve(args: dict) -> int:
    """`--child serve ARGS`: load an artifact with torch and eval.export
    alone, call it on the saved batch → its outputs (.npy) and a JSON line."""
    from dcase2019_task4_tpu_torch.eval.export import load_serving

    t0 = time.perf_counter()
    served = load_serving(args["artifact"])
    load_s = time.perf_counter() - t0
    loaded = port_modules_beyond_export()
    if loaded:
        raise AssertionError(f"loading the artifact imported {loaded}")
    audio, frames = np.load(args["audio"]), np.load(args["frames"])
    strong, weak, launches, ms = call_artifact(served, audio, frames, args["per_call"], args["what"])
    if port_modules_beyond_export():
        raise AssertionError(f"calling the artifact imported {port_modules_beyond_export()}")
    np.save(args["out"] + ".strong.npy", strong)
    np.save(args["out"] + ".weak.npy", weak)
    figures = {"load_s": load_s, "warm_ms": ms, "launches": launches,
               "modules": sorted(m for m in sys.modules if m.startswith("dcase2019_task4_tpu_torch."))}
    with open(args["out"] + ".json", "w") as f:
        json.dump(figures, f)
    print(json.dumps(figures))
    return 0


def serving_checkpoints(work: str, model: str, model_bf16_entry_block: str):
    """(name, checkpoint, launches of one call) of phase 9's exports: phase
    4's default and `entry_block_pallas` checkpoints, and the same weights
    stored with `entry_conv_pallas` and with `entry_block_crows`, and phase
    4's bfloat16 `entry_block_pallas` checkpoint."""
    from dcase2019_task4_tpu_torch.train import checkpoints as ckpt

    params, bn_state = ckpt.load_inference_state(model)
    meta = ckpt.read_metadata(model)
    cases = [("default", model, SERVE), ("entry_block_pallas", os.path.join(work, "model_entry_block.npz"),
                                         SERVE_ENTRY_BLOCK)]
    for flag, per_call in (("entry_conv_pallas", SERVE_ENTRY_CONV), ("entry_block_crows", SERVE_CROWS)):
        stored = copy.deepcopy(meta)
        stored["config"]["model"][flag] = True
        path = os.path.join(work, f"model_{flag}.npz")
        ckpt.save_inference_checkpoint(path, params, bn_state, stored)
        cases.append((flag, path, per_call))
    cases.append(("bf16 entry_block_pallas", model_bf16_entry_block, SERVE_BF16_ENTRY_BLOCK))
    return cases


def export_case(device, what: str, ckpt_path: str, audio, frames, work: str) -> dict:
    """`evaluate --export` of one checkpoint at batch 24 on the card, and
    the evaluator's direct path (features → predict) on the 24 clips: its
    outputs and warm ms."""
    import torch

    from dcase2019_task4_tpu_torch import cli
    from dcase2019_task4_tpu_torch.eval.evaluate import CheckpointEvaluator

    artifact = os.path.join(work, what.replace(" ", "_") + ".dc19serve")
    t0 = time.perf_counter()
    header = cli.evaluate(["-m", ckpt_path, "--export", artifact, "--device", str(device)])
    export_s = time.perf_counter() - t0
    if header["batch_size"] != 24 or header["platforms"] != [device.type]:
        raise AssertionError(f"the {what} artifact's header: {header}")
    ev = CheckpointEvaluator(ckpt_path, device=device)
    strong, weak = (t.cpu().numpy() for t in ev._predict(ev.features(audio, frames)))
    direct_ms = warm_ms(lambda: ev._predict(ev.features(audio, frames)))
    del ev
    torch.cuda.empty_cache()
    return {"artifact": artifact, "strong": strong, "weak": weak, "export_s": export_s, "direct_ms": direct_ms,
            "bytes": os.path.getsize(artifact)}


def held_to_direct(case: dict, what: str, got_strong, got_weak, where: str, per_call: dict, served_ms, card: str):
    """The artifact's outputs within SERVE_TOL of max of the direct path's;
    its line printed → the figures of the kernels line."""
    errs = [float(np.abs(g - w).max() / np.abs(w).max()) for g, w in ((got_strong, case["strong"]),
                                                                       (got_weak, case["weak"]))]
    print(f"  {what}: exported in {case['export_s']:.2f} s, {case['bytes'] / 2 ** 20:.2f} MiB; loaded in {where}; "
          f"strong / weak against the direct path {errs[0]:.3e} / {errs[1]:.3e} of max (limit {SERVE_TOL}); launches "
          f"a call {per_call}; warm call: artifact {served_ms:.3f} ms, direct path {case['direct_ms']:.3f} ms on {card}")
    if not max(errs) <= SERVE_TOL:
        raise AssertionError(f"the {what} artifact differs from the direct path by {errs} of max")
    return {"export_s": case["export_s"], "bytes": case["bytes"], "direct_ms": case["direct_ms"],
            "artifact_ms": served_ms, "max_err_of_max": max(errs)}


def reference_checkpoint(model: str, path: str):
    """The weights of the port checkpoint `model` written as the reference's
    torch.save file (main.py:293-309): its names, no attention head, the
    flagship's kwargs left to the reference's defaults."""
    import torch

    from dcase2019_task4_tpu_torch.train import checkpoints as ckpt

    sd = ckpt.params_from_jax(*ckpt.load_inference_state(model))
    meta = ckpt.read_metadata(model)
    cnn, rnn, dense = {}, {}, {}
    names = {"conv": "conv{}", "bn": "batchnorm{}", "act": "glu{}.linear"}
    for key, value in sd.items():
        part, rest = key.split(".", 1)
        if part == "cnn":
            i, layer, leaf = rest.split(".")
            if leaf != "num_batches_tracked":
                cnn[f"{names[layer].format(i)}.{leaf}"] = value
        elif part == "rnn":
            rnn[f"rnn.{rest}"] = value
        elif part == "dense":
            dense[rest] = value
    torch.save({"model": {"name": "CRNN", "args": [], "kwargs": {}, "state_dict": {"cnn": cnn, "rnn": rnn,
                                                                                  "dense": dense}},
                "scaler": meta["scaler"], "many_hot_encoder": meta["many_hot_encoder"],
                "pooling_time_ratio": meta["pooling_time_ratio"]}, path)


def serving_import(device, work: str, model: str, card: str) -> dict:
    """Phase 9 (b): `evaluate` and `predict --torch_checkpoint` on 24
    synthetic validation clips from the reference-layout file of phase 4's
    default weights, against `predict` on the port's own checkpoint."""
    import torch

    from dcase2019_task4_tpu_torch import cli
    from dcase2019_task4_tpu_torch.config import Config
    from dcase2019_task4_tpu_torch.eval.evaluate import CheckpointEvaluator

    ref = os.path.join(work, "reference_baseline_best")
    reference_checkpoint(model, ref)
    validation = Config().paths.validation
    common = ["--synthetic_audio", "-s", "24", "--device", str(device)]
    runs = {}
    for what, argv in (("evaluate", ["evaluate", "-m", ref, "--torch_checkpoint", "--sets", validation]),
                       ("predict", ["predict", "-m", ref, "--torch_checkpoint", "-i", validation,
                                    "-p", os.path.join(work, "ref_events.tsv")]),
                       ("own evaluate", ["evaluate", "-m", model, "--sets", validation]),
                       ("own predict", ["predict", "-m", model, "-i", validation,
                                        "-p", os.path.join(work, "own_events.tsv")])):
        zero_launches()
        t0 = time.perf_counter()
        runs[what] = getattr(cli, argv[0])(argv[1:] + common)
        if device.type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check_launches(read_launches(), PREDICT_BATCH, 1, f"{what} on 24 validation clips")
        print(f"  {what}{' --torch_checkpoint' if 'own' not in what else ''}: {seconds:.2f} s, launches "
              f"{PREDICT_BATCH} exact")
    ref_head = CheckpointEvaluator.from_torch_checkpoint(ref, device="cpu").model.dense_softmax
    own_head = CheckpointEvaluator(model, device="cpu").model.dense_softmax
    aligned = all(torch.equal(a, b) for a, b in zip(ref_head.parameters(), own_head.parameters()))
    if not aligned:
        raise AssertionError("the imported attention head is not the checkpoint's (seeded_init_ with seed 0 both)")
    pred, own = runs["predict"], runs["own predict"]
    if pred["strong"].shape != (24, 108, 10) or not np.array_equal(pred["strong"], own["strong"]):
        raise AssertionError("strong probabilities of the imported file are not the port checkpoint's bits")
    weak_err = float(np.abs(pred["weak"] - own["weak"]).max())
    if not weak_err <= SERVE_TOL:
        raise AssertionError(f"weak probabilities of the imported file differ by {weak_err}")
    (ref_metrics,), (own_metrics,) = runs["evaluate"].values(), runs["own evaluate"].values()
    if ref_metrics != own_metrics:
        raise AssertionError(f"evaluate --torch_checkpoint {ref_metrics} against the port checkpoint's {own_metrics}")
    print(f"  imported file against the port's own checkpoint of the same weights on {card}: strong bit for bit, "
          f"weak {weak_err:.3e} (limit {SERVE_TOL}; the head aligned: both seeded_init_ with seed 0), "
          f"evaluate's F1s equal ({ref_metrics})")
    return {"weak_max_abs_err": weak_err, "event_macro_f1": ref_metrics["event_macro_f1"]}


def start_profiler(work: str):
    """tools/profile_step_torch.py --batch 24 in a child → a function that
    waits for it (its stdout lines printed) and returns its JSON line."""
    proc = subprocess.Popen([sys.executable, os.path.join(REPO, "tools", "profile_step_torch.py"), "--batch", "24",
                             "--trace_dir", os.path.join(work, "profile_trace")], cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)

    def wait(timeout: float = 600.0) -> dict:
        try:
            out, err = proc.communicate(timeout=timeout)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        for line in out.splitlines()[:-1]:
            print(f"    [profile_step_torch] {line}")
        if proc.returncode != 0:
            print(err[-4000:])
            raise AssertionError(f"tools/profile_step_torch.py exited {proc.returncode}")
        return json.loads(out.splitlines()[-1])

    return wait


def profiler_held(result: dict, card: str, step_device_ms: Optional[float]) -> dict:
    """Phase 9 (c): every kernel of the default step's row named in the
    profiler's top ops with a time above 0; its device ms a step beside
    phase 5's."""
    for row in STEP_MIN:
        if not sum(t for name, t, _ in result["ops"] if STEP_KERNELS[row] in name) > 0:
            raise AssertionError(f"the profiler's top ops name no {STEP_KERNELS[row]} ({row}) with time")
    phase5 = "not measured" if step_device_ms is None else f"{step_device_ms:.3f} ms"
    print(f"  profile_step_torch.py: {result['device_ms_per_step']:.3f} device ms a step (all device events of its "
          f"traced card-generator steps, summed by name) against phase 5's profiled step {phase5}; "
          f"{result['ms_per_step']:.3f} ms a step on the host clock; every kernel of the default step named, on {card}")
    return {"device_ms_per_step": result["device_ms_per_step"], "phase5_step_device_ms": step_device_ms}


def phase_serving(device, card: str, work: str, step_device_ms: Optional[float]) -> dict:
    """Phase 9 → the figures of the kernels line's "serving" entry. (a)
    `evaluate --export` at batch 24 on the card of phase 4's default and
    `entry_block_pallas` checkpoints, each artifact loaded and called in a
    child that imports torch and eval.export alone (`--child serve`), beside
    (c) the step profiler's child, all three at once; then the exports of
    the same weights stored with `entry_conv_pallas` and `entry_block_crows`
    and of phase 4's bfloat16 `entry_block_pallas` checkpoint, loaded here;
    each artifact against the evaluator's direct path on the same 24
    clips. (b) The reference-layout file of the default weights through
    `evaluate` and `predict --torch_checkpoint`."""
    from dcase2019_task4_tpu_torch.eval.export import load_serving

    t_phase = time.perf_counter()
    model, model_bf16 = os.path.join(work, "model.npz"), os.path.join(work, "model_bf16_entry_block.npz")
    _, _, clips = make_clips(24, np.random.default_rng(SEED + 9))
    audio, frames = pack_clips(clips)
    batch = {"audio": os.path.join(work, "serve_audio.npy"), "frames": os.path.join(work, "serve_frames.npy")}
    np.save(batch["audio"], audio)
    np.save(batch["frames"], frames)
    cases = serving_checkpoints(work, model, model_bf16)
    in_child = cases[:2]  # default and entry_block_pallas
    exported = {what: export_case(device, what, path, audio, frames, work) for what, path, _ in in_child}
    wait_serve = start_children("serve", [dict(batch, artifact=exported[what]["artifact"], per_call=per_call,
                                                what=what, out=os.path.join(work, what.replace(" ", "_")))
                                           for what, _, per_call in in_child])
    wait_profiler = start_profiler(work)
    wait_serve(300.0)
    profile = wait_profiler()
    figures = {"exports": {}}
    for what, _, per_call in in_child:
        out = os.path.join(work, what.replace(" ", "_"))
        with open(out + ".json") as f:
            served_ms = json.load(f)["warm_ms"]
        figures["exports"][what] = held_to_direct(exported[what], what, np.load(out + ".strong.npy"),
                                                  np.load(out + ".weak.npy"), "a child with torch and eval.export "
                                                  "alone", per_call, served_ms, card)
    for what, path, per_call in cases[2:]:
        case = export_case(device, what, path, audio, frames, work)
        got_strong, got_weak, _, served_ms = call_artifact(load_serving(case["artifact"]), audio, frames, per_call,
                                                           what)
        figures["exports"][what] = held_to_direct(case, what, got_strong, got_weak, "this process", per_call,
                                                  served_ms, card)
    figures["import"] = serving_import(device, work, model, card)
    figures["profiler"] = profiler_held(profile, card, step_device_ms)
    figures["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 9: {figures['seconds']:.1f} s")
    return figures


# ----------------------------------------------------------------- phase 10
# the semi-supervised study's tools and the graft entry points (graft_entry_torch.py):
# (b)'s run, cut to 24 labeled files a manifest, 96 unlabeled, 3 epochs
ENTRY = SERVE  # one eval-mode forward at batch 4: K1 1, K3f 2, K2f eval 3
STUDY_SUBPART, STUDY_UNLABELED, STUDY_EPOCHS, STUDY_BAND = 24, 96, 3, (0.4, 0.6)
STUDY_ARMS = ("supervised", "mt", "mt_cc0", "mt_nv")
STUDY_ARGS = ["--subpart", str(STUDY_SUBPART), "--subpart_unlabeled", str(STUDY_UNLABELED), "--epochs",
              str(STUDY_EPOCHS), "--eval_every", "1", "--nuisance_shift", "0.4,0.6", "--arms", ",".join(STUDY_ARMS)]
STUDY_STEP_KERNELS = sorted(set(STEP_MIN) | set(PREDICT_MIN))  # the study's arms launch each of these
DIAG_RENDERS, DIAG_STD_TOL, DIAG_FLIP_TOL = 2, 1e-4, 1e-5


def study_tools():
    """The port's study tools, imported from tools/."""
    tools = os.path.join(REPO, "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import ablate_ssl_torch
    import diag_invariance_torch
    import twin_epochs_torch

    return ablate_ssl_torch, diag_invariance_torch, twin_epochs_torch


def entry_on_card(card: str) -> dict:
    """(a) `graft_entry_torch.entry()` on the card: launches exact, strong
    and weak within 1e-4 of the same forward on the CPU; then
    `dryrun_multichip(2)` on two Gloo ranks sharing the card."""
    import torch

    import graft_entry_torch

    zero_launches()
    forward, args = graft_entry_torch.entry()
    strong, weak = forward(*args)
    torch.cuda.synchronize()
    check_launches(read_launches(), ENTRY, 1, "entry()")
    forward_cpu, args_cpu = graft_entry_torch.entry(device="cpu")
    strong_cpu, weak_cpu = forward_cpu(*args_cpu)
    diff = max(float((strong.cpu() - strong_cpu).abs().max()), float((weak.cpu() - weak_cpu).abs().max()))
    print(f"  (a) entry(): strong {tuple(strong.shape)}, weak {tuple(weak.shape)}, launches exact "
          f"{ENTRY}; card against CPU {diff:.3e} (limit {STRONG_TOL})")
    if not diff <= STRONG_TOL:
        raise AssertionError(f"entry() on the card is {diff:.3e} from the CPU forward")
    t0 = time.perf_counter()
    loss = graft_entry_torch.dryrun_multichip(2)
    print(f"  (a) dryrun_multichip(2) on two Gloo ranks on {card}: loss {loss:.6f}, "
          f"{time.perf_counter() - t0:.1f} s")
    return {"entry_card_vs_cpu": diff, "dryrun_loss": loss}


def arm_counts_on_cpu(ablate, arm: str) -> dict:
    """steps_per_epoch and the clip counts of `arm` from an Experiment of (b)'s
    arguments built on the CPU. The counts come from the manifests, splits
    and sampler alone, so the build leaves out the scaler's pass, the steps
    and the resident rows."""
    d = ablate.ARMS[arm]
    exp = ablate.arm_experiment(d["mean_teacher"], d["max_cc"], STUDY_SUBPART, STUDY_EPOCHS, SEED, 1.0,
                                STUDY_UNLABELED, device_cache=False, labeled_band=STUDY_BAND,
                                paired_view=d.get("paired", False), device="cpu")
    exp._fit_scaler = exp._build_steps = lambda: None
    with quiet_log():
        exp.build()
    streams = exp.pipeline.streams
    return {"steps_per_epoch": len(exp.pipeline),
            "n_labeled_clips": sum(len(s) for s in streams if s.name in ("weak", "synthetic")),
            "n_unlabeled_clips": sum(len(s) for s in streams if s.name == "unlabeled")}


def study_ablation(card: str, work: str) -> tuple:
    """(b) `tools/ablate_ssl_torch.py` on the four arms → (its JSON, the
    launches of the run)."""
    from dcase2019_task4_tpu_torch.utils.metrics_writer import read_metrics

    ablate, _, _ = study_tools()
    out, store = os.path.join(work, "ablation.json"), os.path.join(work, "ablation")
    zero_launches()
    t0 = time.perf_counter()
    rc = ablate.main(STUDY_ARGS + ["--device", "cuda", "--store", store, "--out", out])
    seconds = time.perf_counter() - t0
    launches = read_launches()
    if rc not in (0, 1):
        raise AssertionError(f"ablate_ssl_torch.py exited {rc}")
    print(f"  (b) ablate_ssl_torch.py {' '.join(STUDY_ARGS)}: exit {rc} "
          f"({'mt beat supervised by the margin' if rc == 0 else 'mt did not beat supervised by the margin'}: "
          f"a verdict at {STUDY_EPOCHS} epochs, not a failure), {seconds:.1f} s on {card}")
    with open(out) as f:
        doc = json.load(f)
    runs = {r["arm"]: r for r in doc["runs"]}
    if sorted(runs) != sorted(STUDY_ARMS) or sorted(doc["summary"]) != sorted(STUDY_ARMS):
        raise AssertionError(f"the ablation JSON holds the arms {sorted(runs)}")
    for arm in STUDY_ARMS:
        want = arm_counts_on_cpu(ablate, arm)
        got = {k: runs[arm][k] for k in want}
        if got != want:
            raise AssertionError(f"{arm}: {got} on the card, {want} from the CPU build")
        records = read_metrics(os.path.join(store, f"{arm}_s{SEED}", "metrics.jsonl"))
        losses = [r[k] for r in records for k in r if "loss" in k or k.startswith("consistency_")]
        if len(records) != STUDY_EPOCHS or not losses or not np.all(np.isfinite(losses)):
            raise AssertionError(f"{arm}: {len(records)} epochs, loss means {losses}")
        r = runs[arm]
        print(f"  (b) {arm}: {got}, best event F1 {r['best_event_macro_f1']}, weak F1 {r['best_weak_macro_f1']}, "
              f"{r['wall_s']} s; loss means finite ({len(losses)})")
    missing = [k for k in STUDY_STEP_KERNELS if launches[k] < 1]
    if missing:
        raise AssertionError(f"the study launched no {missing}")
    print(f"  (b) launches over the four arms: {({k: launches[k] for k in STUDY_STEP_KERNELS})}")
    return {"exit": rc, "seconds": seconds, "runs": doc["runs"], "summary": doc["summary"]}, launches, store


def study_invariance(store: str) -> dict:
    """(c) `diag_invariance_torch` with 2 renders on (b)'s mt and mt_nv best
    checkpoints, on the card and on the CPU: stds within 1e-4, flip rates
    equal unless a probability lies within 1e-5 of 0.5 (printed)."""
    _, diag, _ = study_tools()
    out = {}
    for arm in ("mt", "mt_nv"):
        ckpt = os.path.join(store, f"{arm}_s{SEED}", "model", "baseline_best")
        s_card, w_card, epoch = diag.probabilities(ckpt, DIAG_RENDERS, STUDY_SUBPART, 1.0, device="cuda")
        s_cpu, w_cpu, _ = diag.probabilities(ckpt, DIAG_RENDERS, STUDY_SUBPART, 1.0, device="cpu")
        got, want = diag.dispersion(s_card, w_card, epoch), diag.dispersion(s_cpu, w_cpu, epoch)
        gaps = {k: abs(got[k] - want[k]) for k in ("strong_std", "weak_std")}
        print(f"  (c) {arm}: card {got}; CPU stds {want['strong_std']:.6g} / {want['weak_std']:.6g}, flip rate "
              f"{want['flip_rate']:.6g}; gaps {gaps} (limit {DIAG_STD_TOL})")
        if max(gaps.values()) > DIAG_STD_TOL:
            raise AssertionError(f"{arm}: the dispersion on the card is {gaps} from the CPU's")
        if got["flip_rate"] != want["flip_rate"]:
            flipped = (s_card >= 0.5) != (s_cpu >= 0.5)
            near = flipped & (np.abs(s_card - 0.5) <= DIAG_FLIP_TOL) & (np.abs(s_cpu - 0.5) <= DIAG_FLIP_TOL)
            print(f"  (c) {arm}: flip rate {got['flip_rate']} on the card, {want['flip_rate']} on the CPU; "
                  f"flipped cells (card, CPU): {list(zip(s_card[flipped].tolist(), s_cpu[flipped].tolist()))}")
            if not np.array_equal(flipped, near):
                raise AssertionError(f"{arm}: a decision flipped with no probability within {DIAG_FLIP_TOL} of 0.5")
        out[arm] = {"card": got, "cpu": want}
    return out


def study_twin(card: str, work: str) -> dict:
    """(d) `tools/twin_epochs_torch.py --epochs 1 --subpart 24` at the
    flagship on the card: `ok`."""
    _, _, twin = study_tools()
    out = os.path.join(work, "twin.json")
    t0 = time.perf_counter()
    with quiet_log():
        rc = twin.main(["--epochs", "1", "--subpart", str(STUDY_SUBPART), "--device", "cuda", "--out", out])
    with open(out) as f:
        doc = json.load(f)
    row = doc["per_epoch"][0]
    print(f"  (d) twin_epochs_torch.py --epochs 1 --subpart {STUDY_SUBPART}: exit {rc}, ok {doc['ok']}, loss port "
          f"{row['ours']['loss']:.6f} twin {row['torch']['loss']:.6f}, scaler gaps {doc['scaler_gap']}, "
          f"{time.perf_counter() - t0:.1f} s on {doc['card']}")
    if rc != 0 or doc["ok"] is not True:
        raise AssertionError(f"twin_epochs_torch.py: exit {rc}, ok {doc['ok']}")
    return {"per_epoch": doc["per_epoch"], "final_eval": doc["final_eval"], "scaler_gap": doc["scaler_gap"]}


def phase_study(card: str) -> tuple:
    """Phase 10 → (the study's launches, its figures)."""
    t_phase = time.perf_counter()
    figures = {"entry": entry_on_card(card)}
    with tempfile.TemporaryDirectory() as work:
        figures["ablation"], launches, store = study_ablation(card, work)
        figures["invariance"] = study_invariance(store)
        figures["twin"] = study_twin(card, work)
    figures["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 10: {figures['seconds']:.1f} s")
    return launches, figures


# phase 11: the flat-layout checkpoint (DCASE_FLAT_OPT=1) and legacy v1 checkpoints


@contextlib.contextmanager
def flat_opt(on: bool):
    """DCASE_FLAT_OPT set to 1 (or unset) inside; restored after."""
    before = os.environ.pop("DCASE_FLAT_OPT", None)
    if on:
        os.environ["DCASE_FLAT_OPT"] = "1"
    try:
        yield
    finally:
        os.environ.pop("DCASE_FLAT_OPT", None)
        if before is not None:
            os.environ["DCASE_FLAT_OPT"] = before


def same_state(a, b) -> list:
    """Names of the student and teacher parameters that differ in any bit."""
    import torch

    out = []
    for model in ("student", "teacher"):
        for (name, p), q in zip(getattr(a, model).named_parameters(), getattr(b, model).parameters()):
            if not torch.equal(p, q):
                out.append(f"{model}.{name}")
    return out


def tail_launches(state, step_no: int, alpha: float, card: str):
    """The kernels the update tail (Adam's step and the EMA) puts on the card
    once, from the gradients the last step left, counted in a trace with
    the host's launch calls beside the device's kernel events. The trace
    opens with `open_trace`'s spin kernels (uncounted): traces of this short
    tail without them came back with no device event. The state takes one
    more update."""
    from torch.autograd import DeviceType

    from dcase2019_task4_tpu_torch.train import steps

    def tail():
        state.optimizer.step()
        steps.ema_update(state.student, state.teacher, step_no, alpha)

    def spin_then_tail():
        open_trace()
        tail()

    def holds_the_tail(prof) -> bool:
        return any(e.device_type == DeviceType.CUDA and "multi_tensor_apply" in e.name for e in prof.events())

    tail()  # warm: the first call allocates what later calls reuse
    prof = profiled(spin_then_tail, with_host=True, complete=holds_the_tail, tries=5, retry=True)
    if prof is None:
        print(f"  Adam + EMA tail launches: not measured on {card}")
        return
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and "emcpy" not in e.name
               and "emset" not in e.name and "spin_kernel" not in e.name]
    calls = [e for e in events if e.device_type == DeviceType.CPU and e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                                                                                 "cudaLaunchKernelExC")]
    print(f"  Adam + EMA tail launches (the one tail of either DCASE_FLAT_OPT setting): {len(kernels)} kernels on "
          f"the card, {len(calls) - STEP_SPINS} launch calls on the host, on {card}")


def phase_flat_opt(device, card: str):
    """Phase 11 at the flagship (float32, TF32 off). (a) One Mean-Teacher
    step at batch 24 from one state with DCASE_FLAT_OPT unset and set: loss,
    every metric, the student's and the teacher's parameters bit for bit
    (the switch is a checkpoint layout and leaves the step alone); (b) the
    flat checkpoint after it (Adam's moments one 1-D leaf each) restored on
    the card and on the CPU, then three more steps at a batch of 4 [1|2|1]
    on both (phase 5's CPU batch for the bf16 steps), each step's metrics
    within TRAIN_TOL; (c) that flat checkpoint restored into a fresh state
    on the card, and one step taken from both bit for bit; (d) a plain-Adam
    v1 pickle written with numpy and pickle, refused without the opt-in and
    restored behind it leaf for leaf; (e) the launches of the Adam and EMA
    tail, read from the profiler. Under cuDNN's deterministic algorithms
    (block 1's conv and its gradients), which bit-for-bit claims need."""
    import torch

    t_phase = time.perf_counter()
    deterministic, torch.backends.cudnn.deterministic = torch.backends.cudnn.deterministic, True
    try:
        flat_opt_checks(device, card)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    print(f"  phase 11: {time.perf_counter() - t_phase:.1f} s on {card}")


def flat_opt_checks(device, card: str):
    """The checks of phase 11 (`phase_flat_opt`)."""
    import pickle

    import torch

    from dcase2019_task4_tpu_torch.config import Config
    from dcase2019_task4_tpu_torch.train import checkpoints as ckpt
    from dcase2019_task4_tpu_torch.train import steps
    from dcase2019_task4_tpu_torch.utils.scaler import Scaler

    cfg = Config()
    tr = cfg.train
    mean, std = None, None

    def adam(params):
        return torch.optim.Adam(params, lr=tr.lr, betas=(tr.beta1, tr.beta2), eps=tr.adam_eps)

    def batch_of(n: int, dev):
        """(the step's slices, the packed batch on `dev`) of n clips [n/4 | n/2 | n/4]."""
        n_weak, n_unlabel = n // 4, n // 2
        audio, frames, target = train_batch(cfg, n_weak, n_unlabel, n // 4)
        return (slice(0, n_weak), slice(n_weak + n_unlabel, n)), {
            "audio": torch.as_tensor(audio, device=dev), "frames": torch.as_tensor(frames, device=dev),
            "target": torch.as_tensor(target, device=dev)}

    def built(dev, base, slices):
        """(state on `dev` with `base`'s weights, a step over `slices`)."""
        st = steps.TrainState(copy.deepcopy(base.student).to(dev), copy.deepcopy(base.teacher).to(dev), None)
        st.optimizer = adam(st.student.parameters())
        step = steps.make_train_step(
            *slices, mean_teacher=True, rampup_length=10, max_consistency_cost=tr.max_consistency_cost,
            ema_alpha=tr.ema_alpha, frontend=flagship_frontend(dev), scaler_mean=mean, scaler_std=std,
            noise_std=tr.noise_std)
        return st, step

    def take(st, step, batch, seed):
        st, metrics, _ = step(st, batch, torch.Generator().manual_seed(seed), step.zero_metrics(batch["audio"].device))
        torch.cuda.synchronize()
        return metrics

    slices, batch = batch_of(tr.batch_size, device)
    mean, std = Scaler().load_state_dict(
        fit_scaler(flagship_frontend(device), batch["audio"].cpu().numpy(), batch["frames"].cpu().numpy(),
                   device)).mean_std_f32
    base = steps.init_train_state(cfg.model, adam, torch.Generator().manual_seed(SEED))

    # (a) step 1 from one state under each setting
    runs = {}
    for name, flat in (("unset", False), ("flat", True)):
        with flat_opt(flat):
            st, step = built(device, base, slices)
            runs[name] = (st, step, take(st, step, batch, SEED + 2))
    differ = same_state(runs["unset"][0], runs["flat"][0])
    metrics_differ = [k for k, v in runs["unset"][2].items() if not torch.equal(v, runs["flat"][2][k])]
    if differ or metrics_differ:
        raise AssertionError(f"step 1 under DCASE_FLAT_OPT=1 is not the step with it unset: metrics {metrics_differ}, "
                             f"parameters {differ[:4]} ({len(differ)} differ)")
    n_params = sum(p.numel() for p in base.student.parameters())
    print(f"  step 1 at batch {tr.batch_size}, DCASE_FLAT_OPT=1 against unset: loss "
          f"{runs['flat'][2]['loss'].item():.9g} both, every metric, the {n_params} student and {n_params} teacher "
          f"parameters bit for bit on {card}")

    st, step, _ = runs["flat"]
    with tempfile.TemporaryDirectory() as work, flat_opt(True):
        # (b) steps 2-4 at a batch of 4 on the card and on the CPU, from the
        # card's state after step 1 through its flat checkpoint
        path = os.path.join(work, "flat_step1.npz")
        ckpt.save_checkpoint(path, st, {"epoch": 0})
        moments = [a.shape for p, a in ckpt.train_state_leaves(st) if p.endswith((".mu", ".nu"))]
        if moments != [(n_params,), (n_params,)]:
            raise AssertionError(f"the flat checkpoint's moments are not one 1-D leaf each: {moments}")
        small, card_batch = batch_of(4, device)
        _, cpu_batch = batch_of(4, torch.device("cpu"))
        card_st, card_step = built(device, base, small)
        cpu_st, cpu_step = built(torch.device("cpu"), base, small)
        ckpt.restore_checkpoint(path, card_st)
        ckpt.restore_checkpoint(path, cpu_st)
        worst, t0 = 0.0, time.perf_counter()
        for i in range(2, 5):
            m = take(card_st, card_step, card_batch, SEED + 2 + i)
            cpu_m = take(cpu_st, cpu_step, cpu_batch, SEED + 2 + i)
            compare_metrics(i, {k: v.item() for k, v in m.items()}, cpu_m)
            worst = max(worst, max(abs(v.item() - m[k].item()) for k, v in cpu_m.items()))
            print(f"  step {i} at batch 4 from the flat checkpoint: loss {m['loss'].item():.7f} on the card, "
                  f"{cpu_m['loss'].item():.7f} on the CPU")
        print(f"  steps 2-4, card against CPU: largest metric difference {worst:.3g} (limit {TRAIN_TOL}); "
              f"{time.perf_counter() - t0:.1f} s for the three steps on both, on {card}")

        # (c) the flat checkpoint after step 1 restored into a fresh state on
        # the card, one step on from both
        fresh_base = steps.init_train_state(cfg.model, adam, torch.Generator().manual_seed(SEED + 9))
        other, _ = built(device, fresh_base, slices)
        ckpt.restore_checkpoint(path, other)
        if other.step != st.step or ckpt.adam_count(other.optimizer) != ckpt.adam_count(st.optimizer):
            raise AssertionError("the restored flat state has another step or Adam count")
        m_a, m_b = take(st, step, batch, SEED + 20), take(other, step, batch, SEED + 20)
        differ = same_state(st, other) + [k for k, v in m_a.items() if not torch.equal(v, m_b[k])]
        if differ:
            raise AssertionError(f"the step after a flat restore is not the saved state's step: {differ[:4]}")
        print(f"  flat checkpoint after step 1 restored into a fresh state: step 2 at batch {tr.batch_size} "
              f"from both bit for bit (loss {m_a['loss'].item():.9g}) on {card}")

    # (d) a plain-Adam v1 pickle, written as the JAX package's test writes one
    with tempfile.TemporaryDirectory() as work, flat_opt(False):
        leaves = [np.asarray(a) for _, a in ckpt.train_state_leaves(runs["unset"][0])]
        legacy = os.path.join(work, "v1.pkl")
        with open(legacy, "wb") as f:
            pickle.dump({"version": 1, "leaves": leaves, "metadata": {"epoch": 9}}, f)
        target, _ = built(device, fresh_base, slices)
        try:
            ckpt.restore_checkpoint(legacy, target, allow_legacy_pickle=False)
            raise AssertionError("a v1 file was read without the opt-in")
        except ValueError as e:
            if "allow_legacy_pickle" not in str(e):
                raise
        _, meta = ckpt.restore_checkpoint(legacy, target, allow_legacy_pickle=True)
        got = ckpt.train_state_leaves(target)
        bad = [p for (p, a), b in zip(got, leaves) if not np.array_equal(a, b)]
        if bad or meta != {"epoch": 9} or len(got) != len(leaves):
            raise AssertionError(f"the v1 restore differs: {bad[:4]}")
        print(f"  v1 pickle of {len(leaves)} leaves: refused without the opt-in, restored behind it leaf for leaf "
              f"on {card}")

    # (e) the tail's launches (last: it takes one more update)
    st_ = runs["unset"][0]
    tail_launches(st_, st_.step, tr.ema_alpha, card)


CHILDREN = {"world1": child_world1, "ranks": child_dp_ranks, "serve": child_serve}


def set_up() -> bool:
    """False without a card. Otherwise: the port on the path, the JAX
    package's knobs off (as with their variables unset; the knobs path
    turns them on itself), TF32 off."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return False
    sys.path.insert(0, REPO)
    from dcase2019_task4_tpu_torch.ops import fused_block, fused_mel

    fused_mel.ONEDOT = fused_block.RECOMPUTE_FIXUP = fused_block.PACK_BITS = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return True


def main() -> int:
    import torch

    if not set_up():
        return 2
    if sys.argv[1:2] == ["--child"]:  # a process of phase 8
        return CHILDREN[sys.argv[2]](json.loads(sys.argv[3]))
    if sys.argv[1:2] == ["--cards"]:  # phase 8's ranks, one a card
        return data_parallel_cards(int(sys.argv[2]))
    from dcase2019_task4_tpu_torch.ops import _build, fused_block

    device = torch.device("cuda", 0)
    t_start = time.perf_counter()

    print("== phase 1: card")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}, "
          f"count {torch.cuda.device_count()}")

    print("== phase 2: build")
    info = _build.build()
    print(f"  built {os.path.relpath(info['path'], REPO)} in {info['seconds']:.2f} s")
    log = info["log"] or (_build.BUILD_DIR / "build.log").read_text()
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")
    check_spills(log, NO_SPILL_KERNELS)
    _build.library()
    check_mma(info["path"])

    print("== phase 3: kernels against their plain versions (float32 with TF32 off, then bfloat16)")
    rows, helpers = phase_kernels(device)
    fused_block.dropout_mask.launches = 0  # a test helper: phases 4 and 5 may not launch it
    fused_block.dropout_mask.launches_packed = 0

    print("== phase 4: predict through the CLI")
    inputs = tempfile.TemporaryDirectory()  # phase 4's checkpoints, exported and imported again in phase 9
    launches, clips_per_s = phase_predict(device, card, inputs.name)

    print("== phase 5: Mean-Teacher training steps")
    train_launches, step_ms, step_device_ms = phase_train(device, card)
    launches.update(train_launches)
    print("== phase 5, scaled configuration (bfloat16, 128 mels, 128 channels, SpecAugment)")
    from dcase2019_task4_tpu_torch.config import scaled_config

    scaled_launches, scaled_ms, _, _ = phase_train_bf16(device, card, scaled_config(), "scaled", "step_scaled",
                                                        TRAIN_STEPS, profile=True)
    launches.update(scaled_launches)
    print("== phase 5, the flagship in bfloat16 under the default first block and each first-block flag")
    bf16_launches, bf16_ms = phase_train_flagship_bf16(device, card)
    launches.update(bf16_launches)
    print("== phase 5, the knobs path: DCASE_FUSED_MEL_ONEDOT, DCASE_FUSED_BWD_RECOMPUTE and DCASE_DROPOUT_PACK on")
    launches.update(phase_train_knobs(device, card))
    print("== phase 6: training through the CLI (train_meanteacher, train_crnn), then a short epoch on card and CPU")
    cli_launches, streamed_records = phase_train_cli(card)
    launches.update(cli_launches)
    print("== phase 7: the rest of the user paths (--device_cache, --tune_thresholds, predict --long, precompute)")
    launches.update(phase_rest(card, streamed_records))
    print("== phase 8: data parallel (--data_parallel over NCCL at world size 1; two Gloo ranks on the one card)")
    dp_launches, parallel = phase_data_parallel(device, card, streamed_records)
    launches.update(dp_launches)
    print("== phase 9: serving export (evaluate --export), reference import (--torch_checkpoint), step profiler")
    serving = phase_serving(device, card, inputs.name, step_device_ms)
    inputs.cleanup()
    print("== phase 10: the study's tools (ablate_ssl, diag_invariance, twin_epochs) and graft entry / dryrun")
    study_launches, study = phase_study(card)
    launches["study"] = study_launches
    print("== phase 11: the flat-layout checkpoint (DCASE_FLAT_OPT=1) and legacy v1 checkpoints")
    phase_flat_opt(device, card)

    report = []
    for name, (src, replaces) in KERNELS.items():
        row = rows[name]
        on_path = launches[ROW_PATH[name]][name]
        if on_path < 1:
            raise AssertionError(f"{name} was launched no time on its path ({ROW_PATH[name]})")
        report.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": on_path, "max_abs_err": row.err, "err_limit": row.limit,
            "ms": row.ms, "device_ms": row.device_ms, "plain_ms": row.plain_ms,
            "bound_ms": row.bound, "bound_by": row.bound_by, "library_ms": row.library_ms,
            "library_device_ms": row.library_device_ms, "bound_by_shape": row.shapes, "path": ROW_PATH[name],
            "launches_by_path": {path: counts[name] for path, counts in launches.items()},
        })
        if name in SAME_KERNEL:
            report[-1]["same_kernel_as"] = SAME_KERNEL[name]
        if name in KERNEL_NAMES:
            report[-1]["kernel"] = KERNEL_NAMES[name]
    for helper, counter in zip(helpers, ("launches", "launches_packed")):  # as counted over phases 4 and 5
        helper["launches"] = getattr(fused_block.dropout_mask, counter)
        if helper["launches"] != 0:
            raise AssertionError(f"the keep-mask helper was launched {helper['launches']} times by a path")
    print(f"  predict clips/s (warm): {clips_per_s:.2f}; MT step {step_ms:.3f} ms; scaled MT step {scaled_ms:.3f} ms; "
          f"flagship bf16 MT step {bf16_ms:.3f} ms on {card}; whole script {time.perf_counter() - t_start:.0f} s")
    print(card)
    print(json.dumps({"kernels": report, "helpers": helpers, "parallel": parallel, "serving": serving,
                      "study": study}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
