"""Import reference PyTorch checkpoints into the port (counterpart of
dcase2019_task4_tpu/train/torch_import.py).

The reference's published artifact is a torch.save dict
{"model": {"kwargs": ..., "state_dict": {"cnn": ..., "rnn": ..., "dense": ...}},
 "scaler": ..., "many_hot_encoder": ..., "pooling_time_ratio": ...}
(main.py:293-309). The port's CRNN is itself torch, in the reference's
layouts, so every leaf is copied as it is:

  reference                              port CRNN
  cnn.conv{i}.weight [O, I, kh, kw]  →   cnn.{i}.conv.weight
  cnn.conv{i}.bias                   →   cnn.{i}.conv.bias
  cnn.batchnorm{i}.weight / .bias    →   cnn.{i}.bn.weight / .bias
  cnn.batchnorm{i}.running_mean/var  →   cnn.{i}.bn.running_mean / running_var
  cnn.glu{i}.linear.weight [O, I]    →   cnn.{i}.act.weight (cg{i} alike)
  rnn.rnn.weight_ih_l{k}[_reverse]   →   rnn.weight_ih_l{k}[_reverse] (and w_hh, biases)
  dense.weight / .bias               →   dense.weight / .bias

The reference does not serialize its attention head (`dense_softmax` is
absent from CRNN.state_dict, models/CRNN.py:49-57), so an imported model
keeps its own: the port fills it by `models.crnn.seeded_init_` with seed
0. The JAX package keeps the head of its `jax.random.PRNGKey(0)` init,
which the port cannot reproduce, so an imported checkpoint's weak
probabilities differ between the two packages by that head, and parity is
held with the head aligned (ROADMAP Queue 3).
"""

from __future__ import annotations

from typing import Dict

import torch

from dcase2019_task4_tpu_torch.config import ModelConfig
from dcase2019_task4_tpu_torch.data.encoder import LabelCodec
from dcase2019_task4_tpu_torch.models.crnn import CRNN, seeded_init_
from dcase2019_task4_tpu_torch.utils.scaler import Scaler


def _t(v) -> torch.Tensor:
    """A torch tensor or a numpy array → a detached float32 CPU tensor."""
    return torch.as_tensor(v).detach().to(device="cpu", dtype=torch.float32)


def import_model_state_dict(torch_sd: Dict, model: CRNN) -> CRNN:
    """Copy a reference CRNN state_dict ({"cnn", "rnn", "dense"}) into
    `model` in place (every parameter and BatchNorm statistic but the
    attention head) and return it."""
    cnn_sd, rnn_sd, dense_sd = torch_sd["cnn"], torch_sd["rnn"], torch_sd["dense"]
    pairs = []
    for i, block in enumerate(model.cnn):
        pairs += [(block.conv.weight, cnn_sd[f"conv{i}.weight"]), (block.conv.bias, cnn_sd[f"conv{i}.bias"]),
                  (block.bn.weight, cnn_sd[f"batchnorm{i}.weight"]), (block.bn.bias, cnn_sd[f"batchnorm{i}.bias"]),
                  (block.bn.running_mean, cnn_sd[f"batchnorm{i}.running_mean"]),
                  (block.bn.running_var, cnn_sd[f"batchnorm{i}.running_var"])]
        for act in ("glu", "cg"):
            if f"{act}{i}.linear.weight" in cnn_sd:
                pairs += [(block.act.weight, cnn_sd[f"{act}{i}.linear.weight"]),
                          (block.act.bias, cnn_sd[f"{act}{i}.linear.bias"])]
    for name, leaf in model.rnn.named_parameters():
        pairs.append((leaf, rnn_sd[f"rnn.{name}"]))
    pairs += [(model.dense.weight, dense_sd["weight"]), (model.dense.bias, dense_sd["bias"])]
    with torch.no_grad():
        for leaf, value in pairs:
            value = _t(value)
            if value.shape != leaf.shape:
                raise ValueError(f"reference leaf of shape {tuple(value.shape)} for a port leaf of {tuple(leaf.shape)}")
            leaf.copy_(value)
    return model


def import_reference_checkpoint(path: str, cfg=None):
    """Load a reference torch.save checkpoint file → (model on the CPU,
    scaler, codec, pooling_time_ratio). The model's configuration comes
    from the checkpoint's stored kwargs, with the reference's defaults
    (the JAX package's, torch_import.py:115-128). `cfg` is the JAX
    signature's, and is not read there either."""
    state = torch.load(path, map_location="cpu", weights_only=False)
    kw = state["model"]["kwargs"]
    mc = ModelConfig(
        n_in_channel=kw.get("n_in_channel", 1),
        nclass=kw.get("nclass", 10),
        attention=kw.get("attention", True),
        n_rnn_cell=kw.get("n_RNN_cell", 64),
        n_layers_rnn=kw.get("n_layers_RNN", 2),
        activation=kw.get("activation", "glu"),
        dropout=kw.get("dropout", 0.5),
        kernel_size=tuple(kw.get("kernel_size", (3, 3, 3))),
        padding=tuple(kw.get("padding", (1, 1, 1))),
        stride=tuple(kw.get("stride", (1, 1, 1))),
        nb_filters=tuple(kw.get("nb_filters", (64, 64, 64))),
        pooling=tuple(tuple(p) for p in kw.get("pooling", ((2, 4),) * 3)),
    )
    model = import_model_state_dict(state["model"]["state_dict"], seeded_init_(CRNN(mc), 0))
    scaler = Scaler().load_state_dict(state["scaler"])
    codec = LabelCodec.load_state_dict(state["many_hot_encoder"])
    return model, scaler, codec, state["pooling_time_ratio"]
