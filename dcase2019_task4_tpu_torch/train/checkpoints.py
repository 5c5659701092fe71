"""Checkpoint weight bridge, numpy only (counterpart of
dcase2019_task4_tpu/train/checkpoints.py, which imports jax).

Reads the JAX package's v2 checkpoint — one ``.npz`` with a ``leaf_NNNNN``
array per pytree leaf and a ``__meta__`` entry of UTF-8 JSON holding the
metadata, per-leaf dtypes, shapes and keypath strings — and selects the
leaves of the stored TrainState's ``params`` and ``bn_state`` by their
keypaths (``.params['cnn'][0]['conv']['w']``), which is all inference
reads. Loading uses ``allow_pickle=False``; the legacy pickle format is not
read. The writer emits the same layout holding params and bn_state only,
so a process without jax can produce a checkpoint the port's CLI loads.

`params_from_jax` / `params_to_jax` map between that pytree (HWIO convs,
[in, out] dense weights) and the port's CRNN state_dict (OIHW,
[out, in]).
"""

from __future__ import annotations

import io
import json
import os
import re
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from dcase2019_task4_tpu_torch.ops.gru import state_from_jax, state_to_jax

_KEY = re.compile(r"\.(\w+)|\['([^']*)'\]|\[(\d+)\]")


def _decode_leaf(arr: np.ndarray, dtype_tag: str) -> np.ndarray:
    """Undo the writer's bit-cast of non-native dtypes; bfloat16 widens to
    float32 (exact) since numpy has no bfloat16."""
    if dtype_tag == str(arr.dtype):
        return arr
    if dtype_tag == "bfloat16":
        return (arr.astype(np.uint32) << 16).view(np.float32)
    return arr.view(np.dtype(dtype_tag))


def _parse_path(path: str) -> List:
    keys, pos = [], 0
    for m in _KEY.finditer(path):
        if m.start() != pos:
            raise ValueError(f"unparseable leaf path {path!r}")
        attr, key, idx = m.groups()
        keys.append(int(idx) if idx is not None else (attr if attr is not None else key))
        pos = m.end()
    if pos != len(path):
        raise ValueError(f"unparseable leaf path {path!r}")
    return keys


def _insert(tree: Dict, keys: List, value):
    """Place value at keys in nested dicts; integer keys become lists once
    the tree is complete (see _listify)."""
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def _listify(node):
    if not isinstance(node, dict):
        return node
    if node and all(isinstance(k, int) for k in node):
        return [_listify(node[i]) for i in range(len(node))]
    return {k: _listify(v) for k, v in node.items()}


def _load(path: str, want_leaves: bool) -> Tuple[Dict, Dict]:
    with open(path, "rb") as f:
        if f.read(2) != b"PK":
            raise ValueError(f"{path} is not an npz (v2) checkpoint; legacy pickle checkpoints are not read")
    with np.load(path, allow_pickle=False) as z:
        meta_doc = json.loads(bytes(z["__meta__"]).decode("utf-8"))
        tree: Dict = {}
        if want_leaves:
            paths = meta_doc.get("leaf_paths")
            if paths is None:
                raise ValueError(f"{path} has no leaf_paths; re-save it with a current writer")
            for i, p in enumerate(paths):
                keys = _parse_path(p)
                if keys[0] in ("params", "bn_state"):
                    _insert(tree, keys, _decode_leaf(z[f"leaf_{i:05d}"], meta_doc["dtypes"][i]))
    return _listify(tree), meta_doc


def read_metadata(path: str) -> Dict[str, Any]:
    return _load(path, want_leaves=False)[1]["metadata"]


def load_inference_state(path: str) -> Tuple[Dict, Dict]:
    """→ (params, bn_state) as nested dicts/lists of numpy arrays, the JAX
    package's pytree layout."""
    tree, _ = _load(path, want_leaves=True)
    if "params" not in tree or "bn_state" not in tree:
        raise ValueError(f"{path} holds no params/bn_state leaves")
    return tree["params"], tree["bn_state"]


def _flatten(node, prefix: str, out: List):
    """JAX flatten order: dict keys sorted, lists in order."""
    if isinstance(node, dict):
        for k in sorted(node):
            _flatten(node[k], f"{prefix}['{k}']", out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _flatten(v, f"{prefix}[{i}]", out)
    else:
        out.append((prefix, np.asarray(node)))


def _json_default(o):
    if isinstance(o, np.generic):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"checkpoint metadata value {o!r} is not JSON-serializable")


def save_inference_checkpoint(path: str, params: Dict, bn_state: Dict, metadata: Dict[str, Any]):
    """Write params and bn_state (JAX pytree layout, numpy) as a v2 npz with
    the same metadata document the JAX writer produces."""
    leaves: List = []
    _flatten(params, ".params", leaves)
    _flatten(bn_state, ".bn_state", leaves)
    arrays = {f"leaf_{i:05d}": a for i, (_, a) in enumerate(leaves)}
    meta_doc = {
        "version": 2,
        "n_leaves": len(leaves),
        "dtypes": [str(a.dtype) for _, a in leaves],
        "leaf_paths": [p for p, _ in leaves],
        "leaf_shapes": [list(a.shape) for _, a in leaves],
        "metadata": metadata,
    }
    meta_json = json.dumps(meta_doc, default=_json_default)
    buf = io.BytesIO()
    np.savez(buf, __meta__=np.frombuffer(meta_json.encode("utf-8"), dtype=np.uint8), **arrays)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def params_from_jax(params: Dict, bn_state: Dict) -> Dict[str, torch.Tensor]:
    """JAX CRNN pytrees → the port's CRNN state_dict (HWIO → OIHW convs,
    [in, out] → [out, in] dense weights)."""
    sd: Dict[str, torch.Tensor] = {}
    for i, (block, bn) in enumerate(zip(params["cnn"], bn_state["cnn"])):
        p = f"cnn.{i}"
        sd[f"{p}.conv.weight"] = _t(block["conv"]["w"]).permute(3, 2, 0, 1).contiguous()
        sd[f"{p}.conv.bias"] = _t(block["conv"]["b"])
        sd[f"{p}.bn.weight"] = _t(block["bn"]["scale"])
        sd[f"{p}.bn.bias"] = _t(block["bn"]["bias"])
        sd[f"{p}.bn.running_mean"] = _t(bn["mean"])
        sd[f"{p}.bn.running_var"] = _t(bn["var"])
        sd[f"{p}.bn.num_batches_tracked"] = torch.tensor(0)
        if "act" in block:
            sd[f"{p}.act.weight"] = _t(block["act"]["w"]).t().contiguous()
            sd[f"{p}.act.bias"] = _t(block["act"]["b"])
    sd.update(state_from_jax(params["rnn"], prefix="rnn."))
    for head in ("dense", "dense_softmax"):
        if head in params:
            sd[f"{head}.weight"] = _t(params[head]["w"]).t().contiguous()
            sd[f"{head}.bias"] = _t(params[head]["b"])
    return sd


def params_to_jax(model) -> Tuple[Dict, Dict]:
    """The port's CRNN → (params, bn_state) in the JAX pytree layout."""

    def np_(t):
        return t.detach().cpu().numpy().astype(np.float32)

    params: Dict = {"cnn": [], "rnn": state_to_jax(model.rnn)}
    bn_state: Dict = {"cnn": []}
    for block in model.cnn:
        entry = {
            "conv": {"w": np_(block.conv.weight.permute(2, 3, 1, 0)), "b": np_(block.conv.bias)},
            "bn": {"scale": np_(block.bn.weight), "bias": np_(block.bn.bias)},
        }
        if block.act is not None:
            entry["act"] = {"w": np_(block.act.weight.t()), "b": np_(block.act.bias)}
        params["cnn"].append(entry)
        bn_state["cnn"].append({"mean": np_(block.bn.running_mean), "var": np_(block.bn.running_var)})
    params["dense"] = {"w": np_(model.dense.weight.t()), "b": np_(model.dense.bias)}
    if model.dense_softmax is not None:
        params["dense_softmax"] = {"w": np_(model.dense_softmax.weight.t()), "b": np_(model.dense_softmax.bias)}
    return params, bn_state


# ------------------------------------------------- training-state bridge


def _named_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """A JAX params-shaped pytree (params, Adam mu or nu) → tensors by the
    port's parameter names."""
    zeros = {"cnn": [{"mean": 0.0, "var": 0.0}] * len(params["cnn"])}
    sd = params_from_jax(params, zeros)
    return {k: v for k, v in sd.items() if "running_" not in k and "num_batches" not in k}


def _named_to_jax(named: Dict[str, torch.Tensor]) -> Dict:
    """Tensors by the port's parameter names → a JAX params-shaped pytree."""

    def np_(t):
        return t.detach().cpu().numpy().astype(np.float32)

    cnn, i = [], 0
    while f"cnn.{i}.conv.weight" in named:
        p = f"cnn.{i}"
        entry = {
            "conv": {"w": np_(named[f"{p}.conv.weight"].permute(2, 3, 1, 0)), "b": np_(named[f"{p}.conv.bias"])},
            "bn": {"scale": np_(named[f"{p}.bn.weight"]), "bias": np_(named[f"{p}.bn.bias"])},
        }
        if f"{p}.act.weight" in named:
            entry["act"] = {"w": np_(named[f"{p}.act.weight"].t()), "b": np_(named[f"{p}.act.bias"])}
        cnn.append(entry)
        i += 1
    rnn, layer = [], 0
    while f"rnn.weight_ih_l{layer}" in named:
        rnn.append({
            d: {jk: np_(named[f"rnn.{tk}_l{layer}{suf}"])
                for jk, tk in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"), ("b_ih", "bias_ih"), ("b_hh", "bias_hh"))}
            for d, suf in (("fwd", ""), ("bwd", "_reverse"))
        })
        layer += 1
    tree: Dict = {"cnn": cnn, "rnn": rnn}
    for head in ("dense", "dense_softmax"):
        if f"{head}.weight" in named:
            tree[head] = {"w": np_(named[f"{head}.weight"].t()), "b": np_(named[f"{head}.bias"])}
    return tree


def train_state_from_jax(state, params, bn_state, ema_params=None, ema_bn_state=None,
                         mu=None, nu=None, step: int = 0):
    """Load numpy pytrees in the JAX layout into a TrainState (train/steps.py)
    in place: student, teacher (when given), Adam's `exp_avg` / `exp_avg_sq`
    / `step` (when mu and nu are given; both packages then take the same
    step from the same state) and the step counter. Returns `state`."""
    state.student.load_state_dict(params_from_jax(params, bn_state))
    if ema_params is not None:
        state.teacher.load_state_dict(params_from_jax(ema_params, ema_bn_state))
    if mu is not None:
        first, second = _named_from_jax(mu), _named_from_jax(nu)
        for name, p in state.student.named_parameters():
            state.optimizer.state[p] = {
                "step": torch.tensor(float(step)),
                "exp_avg": first[name].to(p.device),
                "exp_avg_sq": second[name].to(p.device),
            }
    state.step = int(step)
    return state


def train_state_to_jax(state) -> Dict:
    """The inverse: {"params", "bn_state", "ema_params", "ema_bn_state",
    "mu", "nu", "step"} as numpy pytrees in the JAX layout (mu and nu zeros
    before the first update, the EMA entries None without a teacher)."""
    params, bn_state = params_to_jax(state.student)
    out: Dict = {"params": params, "bn_state": bn_state, "ema_params": None, "ema_bn_state": None,
                 "step": int(state.step)}
    if state.teacher is not None:
        out["ema_params"], out["ema_bn_state"] = params_to_jax(state.teacher)
    for key, field in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        named = {}
        for name, p in state.student.named_parameters():
            moment = state.optimizer.state.get(p, {}).get(field)
            named[name] = torch.zeros_like(p) if moment is None else moment
        out[key] = _named_to_jax(named)
    return out
