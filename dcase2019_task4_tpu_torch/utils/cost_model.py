"""Analytic FLOP and device-memory byte model of the Mean-Teacher train step
(counterpart of dcase2019_task4_tpu/utils/cost_model.py), with the peaks
of an NVIDIA H100 80GB HBM3 (SXM, 700 W).

* `model_flops` counts MODEL flops (the MFU convention): the conv, GLU,
  GRU and head arithmetic the architecture needs, and the frontend's
  windowed DFT and mel product, however the kernels compute them; a copy of
  the JAX package's count. Elementwise work (BN, sigmoid, losses, Adam,
  EMA) is left out.
* `hbm_bytes` models the step's device-memory traffic on the port's
  default path (float32 flagship unless the configuration says bfloat16,
  no first-block flag, no knob) by listing every large tensor each pass
  reads and writes, in the JAX package's items. Where the port's tensors
  differ from the TPU path's, the items differ:
    - `entry_conv_fwd` / `entry_conv_bwd`: block 1 is `F.conv2d` (cuDNN,
      models/crnn.py), which reads the features and writes y; the port never
      materialises JAX's lane-padded im2col patch tensor (written and read
      twice a model there). Its weight gradient reads the features and dy;
      the features take no gradient, so there is no dx.
    - `frontend`: K1 writes the linear mel once ([B, T, M] float32), and the
      student's and teacher's features stay float32 in a bfloat16 model too
      (K1 and the features are float32 in the port).
    - `batch_stats`: K2s reads each block's y once a model to form the
      batch statistics (the JAX model counts no such pass).
    - `small_allowance`: without the DFT bases, which the port's FFT K1
      does not read (its window, twiddle and band tables are a few KB).
  This is a model, not a measurement: cuDNN's and PyTorch's temporaries
  are not in it, so `hbm_util_pct` is a lower bound.
* `step_utilization` turns a measured step time into `mfu_pct` (against
  the float32 peak for a float32 model, the dense bfloat16 tensor-core
  peak for a bfloat16 one) and `hbm_util_pct`.
"""

from __future__ import annotations

from dcase2019_task4_tpu_torch.config import Config

# NVIDIA H100 80GB HBM3 (SXM, 700 W), the peaks chip_smoke.py bounds kernels by
H100_PEAK_HBM_BYTES_PER_S = 3.35e12
H100_PEAK_FLOPS_FP32 = 67e12  # float32 outside the tensor cores
H100_PEAK_FLOPS_BF16 = 989e12  # bfloat16 on the tensor cores, dense


def _conv_stack_dims(cfg: Config):
    """Yield (t_in, f_in, c_in, c_out, kernel, pool) per conv block."""
    m = cfg.model
    t, f, c_in = cfg.dsp.max_frames, cfg.dsp.n_mels, m.n_in_channel
    for i, c_out in enumerate(m.nb_filters):
        yield t, f, c_in, c_out, m.kernel_size[i], m.pooling[i]
        t //= m.pooling[i][0]
        f //= m.pooling[i][1]
        c_in = c_out


def model_flops(cfg: Config, batch: int, mean_teacher: bool = True) -> dict:
    """Per-step model FLOPs, itemized. Backward = 2x forward for every
    param-bearing student op (dx + dw); the teacher is forward-only; the
    frontend is not differentiated (features do not depend on params)."""
    d, m = cfg.dsp, cfg.model
    B, T = batch, d.max_frames
    K = d.n_window // 2 + 1  # spectrum bins

    # windowed DFT as cos+sin projections (one clean featurization; the
    # teacher's noise is added to the linear mel, ops/mel.py log_mel_pair)
    frontend = 2 * B * T * d.n_window * K * 2 + 2 * B * T * K * d.n_mels

    conv = glu = 0
    for t, f, c_in, c_out, ks, _pool in _conv_stack_dims(cfg):
        conv += 2 * B * t * f * (ks * ks * c_in) * c_out
        if m.activation in ("glu", "cg"):
            glu += 2 * B * t * f * c_out * c_out  # 1x1 dense gate
    t_r, f_r, c_r = T, d.n_mels, m.nb_filters[-1]
    for _t, _f, _ci, _co, _k, pool in _conv_stack_dims(cfg):
        t_r //= pool[0]
        f_r //= pool[1]

    H, gru = m.n_rnn_cell, 0
    d_in = c_r * f_r  # freq squeezed (flattened if f_r > 1, models/crnn.py)
    for layer in range(m.n_layers_rnn):
        gru += 2 * (2 * B * t_r * 3 * H * (d_in + H))  # both directions
        d_in = 2 * H
    heads = 2 * (2 * B * t_r * 2 * H * m.nclass)  # dense + dense_softmax

    fwd = conv + glu + gru + heads
    total = frontend + 3 * fwd + (fwd if mean_teacher else 0)
    return {
        "frontend": frontend, "conv_fwd": conv, "glu_fwd": glu,
        "gru_fwd": gru, "heads_fwd": heads,
        "student_fwd_bwd": 3 * fwd, "teacher_fwd": fwd if mean_teacher else 0,
        "total": total,
    }


def hbm_bytes(cfg: Config, batch: int, mean_teacher: bool = True, bwd_recompute: bool = False) -> dict:
    """Per-step device-memory traffic of the port's default path, itemized
    (the module docstring says where the items differ from the JAX
    package's). `bwd_recompute` mirrors DCASE_FUSED_BWD_RECOMPUTE=1
    (ops/fused_block.py): the recompute fixup rebuilds dxn instead of
    round-tripping dy_partial."""
    d, m = cfg.dsp, cfg.model
    B, T = batch, d.max_frames
    bf = 2 if m.compute_dtype == "bfloat16" else 4
    n_models = 2 if mean_teacher else 1
    samples = d.max_samples + d.n_window

    out = {}
    # ---- frontend (K1, ops/fused_mel.py) --------------------------------
    # int16 feed read + dequantized float32 write and K1's read; K1's linear
    # mel written once and read; the float32 features of each model written
    # and read by block 1
    feats = B * T * d.n_mels * 4
    out["frontend"] = B * samples * 2 + 2 * B * samples * 4 + 2 * feats + 2 * n_models * feats

    blocks = list(_conv_stack_dims(cfg))
    t0, f0, c0, c_out0, _ks0, pool0 = blocks[0]
    x1 = B * t0 * f0 * c0 * bf                 # block 1's input in the compute dtype
    conv1 = B * t0 * f0 * c_out0 * bf           # block 1's conv output y
    pooled1 = conv1 // (pool0[0] * pool0[1])

    # ---- entry conv (cuDNN F.conv2d, models/crnn.py) ---------------------
    # fwd per model: read x, write y; student bwd: the weight gradient reads
    # x and dy (no dx: the features take no gradient)
    out["entry_conv_fwd"] = n_models * (x1 + conv1)
    out["entry_conv_bwd"] = x1 + conv1

    # ---- block-1 fused BN→GLU→dropout→pool (K2, ops/fused_block.py) ------
    # fwd per model: read y, write the pooled tile
    out["block1_fwd"] = n_models * (conv1 + pooled1)
    # student bwd: default = reduce(read y + dout, write dy_partial) +
    # fixup(read y + dy_partial, write dy) = 5 big + 1 pooled;
    # recompute = reduce(read y + dout) + fixup(read y + dout, write dy)
    out["block1_bwd"] = (3 * conv1 + 2 * pooled1) if bwd_recompute else (5 * conv1 + pooled1)

    # ---- interior blocks (K3 convs + K2 blocks) -------------------------
    inner = 0
    stats = n_models * conv1  # K2s reads block 1's y once a model
    for t, f, c_in, c_out, _ks, pool in blocks[1:]:
        x_in = B * t * f * c_in * bf           # block input (= prev pooled)
        conv_i = B * t * f * c_out * bf        # conv-out at input resolution
        pooled_i = conv_i // (pool[0] * pool[1])
        # fwd per model: conv reads input + writes conv-out; fused block
        # reads conv-out + writes pooled
        inner += n_models * (x_in + 2 * conv_i + pooled_i)
        # student bwd: fused-block passes over conv-out, then conv dx (read
        # d(conv-out), write dx) + wgrad (read input + d(conv-out))
        block_bwd = (3 * conv_i + 2 * pooled_i) if bwd_recompute else (5 * conv_i + pooled_i)
        inner += block_bwd + (conv_i + x_in) + (x_in + conv_i)
        stats += n_models * conv_i
    out["interior_blocks"] = inner
    out["batch_stats"] = stats

    # ---- everything small: GRU and head activations both directions,
    # params + grads + Adam moments + EMA (~10 passes over ~P params),
    # stats and loss vectors. Explicit allowance.
    t_rnn = blocks[-1][0] // blocks[-1][5][0]
    gru_act = B * t_rnn * 2 * m.n_rnn_cell * 4
    out["small_allowance"] = 10 * _param_count(cfg) * 4 + 20 * gru_act
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out


def _param_count(cfg: Config) -> int:
    m = cfg.model
    n = 0
    for _t, _f, c_in, c_out, ks, _p in _conv_stack_dims(cfg):
        n += ks * ks * c_in * c_out + c_out      # conv w+b
        n += 4 * c_out                            # BN scale/bias/mean/var
        n += c_out * c_out + c_out                # GLU gate
    H = m.n_rnn_cell
    d_in = m.nb_filters[-1]
    for layer in range(m.n_layers_rnn):
        n += 2 * (3 * H * (d_in + H) + 6 * H)     # both directions
        d_in = 2 * H
    n += 2 * (2 * H * m.nclass + m.nclass)        # dense + dense_softmax
    return n


def step_utilization(cfg: Config, batch: int, step_seconds: float, mean_teacher: bool = True,
                     bwd_recompute: bool = False) -> dict:
    """MFU and device-memory bandwidth utilization of a step measured on an
    H100 at `step_seconds`: flops against the float32 peak for a float32
    model and the bfloat16 tensor-core peak for a bfloat16 one."""
    fl = model_flops(cfg, batch, mean_teacher)
    by = hbm_bytes(cfg, batch, mean_teacher, bwd_recompute)
    peak = H100_PEAK_FLOPS_BF16 if cfg.model.compute_dtype == "bfloat16" else H100_PEAK_FLOPS_FP32
    return {
        "flops_per_step": fl["total"],
        "hbm_bytes_per_step": by["total"],
        "mfu_pct": round(100 * fl["total"] / step_seconds / peak, 2),
        "hbm_util_pct": round(100 * by["total"] / step_seconds / H100_PEAK_HBM_BYTES_PER_S, 2),
        "flops_breakdown": fl,
        "hbm_breakdown": by,
    }
