"""Checkpoints and the weight bridge, numpy only (counterpart of
dcase2019_task4_tpu/train/checkpoints.py, which imports jax).

The JAX package's v2 checkpoint is one ``.npz`` with a ``leaf_NNNNN``
array per pytree leaf and a ``__meta__`` entry of UTF-8 JSON holding the
metadata, per-leaf dtypes, shapes and keypath strings
(``.params['cnn'][0]['conv']['w']``). Leaves are selected by their
keypaths. Loading uses ``allow_pickle=False``.

The legacy v1 checkpoint, a pickle of ``{"version": 1, "leaves": [...],
"metadata": {...}}`` with the leaves in the JAX TrainState's flatten order,
is read only behind the JAX package's opt-in (``allow_legacy_pickle=True``
or ``DCASE_ALLOW_LEGACY_PICKLE=1``), and then through an unpickler that
admits numpy's array reconstruction and plain builtins and refuses any
other class by name without importing it.

* Inference reads the stored TrainState's ``params`` and ``bn_state``
  (`load_inference_state`); `save_inference_checkpoint` writes only those.
* Training saves and restores the whole TrainState (`save_checkpoint`,
  `restore_checkpoint`): student, teacher, both BatchNorm states, Adam's
  moments and count, and the step, as the JAX TrainState's leaves in its
  flatten order, so each package restores the other's checkpoint. Plain
  Adam is optax.adam's state (``.opt_state[0].count / .mu / .nu``); the
  ramped Adam is its optax.inject_hyperparams state (``.opt_state.count``,
  ``.hyperparams``, ``.hyperparams_states``, ``.inner_state[0]``), whose
  hyperparameters are those the last update used, as optax stores them.
  Under DCASE_FLAT_OPT=1 (`flat_opt_layout`) Adam's ``mu`` and ``nu`` are
  written as ONE 1-D leaf each, the layout of the JAX package's flat tail
  (optax.flatten): the parameters raveled in the JAX tree's order (dict
  keys sorted, HWIO convs, [in, out] dense weights), which is not the
  port's own buffer order. The port's optimizer keeps its moments per
  parameter either way: the flat tail's update is the per-leaf update
  element by element, so the switch is only this file layout. A
  checkpoint restores only under the setting that wrote it.

`params_from_jax` / `params_to_jax` map between that pytree (HWIO convs,
[in, out] dense weights) and the port's CRNN state_dict (OIHW,
[out, in]).
"""

from __future__ import annotations

import dataclasses
import importlib
import io
import json
import os
import pickle
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from dcase2019_task4_tpu_torch.ops.gru import state_from_jax, state_to_jax

_KEY = re.compile(r"\.(\w+)|\['([^']*)'\]|\[(\d+)\]")


def flat_opt_layout() -> bool:
    """DCASE_FLAT_OPT=1, the JAX package's switch of its flat update tail
    (optax.flatten): Adam's moments are written and read as one 1-D leaf
    each. Read where a checkpoint is written or restored."""
    return os.environ.get("DCASE_FLAT_OPT", "0") == "1"


def _layout_name(flat: bool) -> str:
    return "flat (DCASE_FLAT_OPT=1)" if flat else "per-leaf (DCASE_FLAT_OPT unset)"


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


# ------------------------------------------------- legacy v1 (pickle) files

# what a v1 file may name: numpy's array and scalar reconstruction (under
# numpy 1 and numpy 2 module names) and builtins that build plain data
_NUMPY_NAMES = {
    "numpy": {"ndarray", "dtype"},
    "numpy.core.multiarray": {"_reconstruct", "scalar"},
    "numpy._core.multiarray": {"_reconstruct", "scalar"},
    "numpy.core.numeric": {"_frombuffer"},
    "numpy._core.numeric": {"_frombuffer"},
}
_BUILTIN_NAMES = {"bool", "bytearray", "bytes", "complex", "dict", "float", "frozenset", "int", "list", "range",
                  "set", "slice", "str", "tuple"}


class _LegacyUnpickler(pickle.Unpickler):
    """Unpickles a v1 checkpoint without importing anything beyond numpy and
    builtins: every other global is refused by its name."""

    def find_class(self, module, name):
        if module == "builtins" and name in _BUILTIN_NAMES:
            return super().find_class(module, name)
        if name in _NUMPY_NAMES.get(module, ()):
            try:
                return getattr(importlib.import_module(module), name)
            except ImportError:  # a numpy 2 file under numpy 1, or the reverse
                swap = ("numpy._core", "numpy.core") if "._core" in module else ("numpy.core", "numpy._core")
                return getattr(importlib.import_module(module.replace(*swap)), name)
        if module.split(".")[0] == "ml_dtypes":
            raise pickle.UnpicklingError(
                f"the legacy checkpoint holds a leaf of dtype ml_dtypes.{name} (bfloat16 and its kin), which "
                "needs the ml_dtypes package; re-save it as an npz (v2) checkpoint with the JAX package")
        raise pickle.UnpicklingError(f"the legacy checkpoint names {module}.{name}; only numpy arrays and "
                                     "builtins are read from a v1 file")


def _legacy_pickle_allowed(allow_legacy_pickle) -> bool:
    if allow_legacy_pickle is None:
        return os.environ.get("DCASE_ALLOW_LEGACY_PICKLE", "0") == "1"
    return bool(allow_legacy_pickle)


def _legacy_pickle_error(path: str) -> ValueError:
    return ValueError(
        f"{path} is not an npz (v2) checkpoint. Legacy v1 checkpoints are "
        "pickles, and unpickling executes arbitrary code — load one ONLY if "
        "you created it yourself, by passing allow_legacy_pickle=True or "
        "setting DCASE_ALLOW_LEGACY_PICKLE=1."
    )


def _is_zip(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(2) == b"PK"


def _load_v1(path: str, allow_legacy_pickle) -> Tuple[List[np.ndarray], Dict]:
    """→ (leaves, metadata) of a v1 file, behind the opt-in."""
    if not _legacy_pickle_allowed(allow_legacy_pickle):
        raise _legacy_pickle_error(path)
    with open(path, "rb") as f:
        payload = _LegacyUnpickler(f).load()
    if not isinstance(payload, dict) or payload.get("version") != 1 or "leaves" not in payload:
        raise ValueError(f"{path} is not a v1 checkpoint (a dict of version 1 with leaves and metadata)")
    return [np.asarray(a) for a in payload["leaves"]], payload["metadata"]


def _tree_from_v1(path: str, leaves: List[np.ndarray], template: List, exact: bool = True) -> Dict:
    """v1 leaves, positional, placed at the (keypath, array) template's
    keypaths: as many leaves as the template (at least as many when not
    `exact`), each of the template leaf's shape."""
    if len(leaves) < len(template) or (exact and len(leaves) != len(template)):
        raise ValueError(f"legacy checkpoint {path} holds {len(leaves)} leaves but the template has "
                         f"{len(template)} — the configs differ")
    diffs = [f"  leaf {i}: saved {tuple(a.shape)}, template {q} {tuple(t.shape)}"
             for i, (a, (q, t)) in enumerate(zip(leaves, template)) if a.shape != t.shape]
    if diffs:
        raise ValueError(f"legacy checkpoint {path} does not match the template:\n" + "\n".join(diffs[:8]))
    tree: Dict = {}
    for (q, _), a in zip(template, leaves):
        _insert(tree, _parse_path(q), a)
    return _listify(tree)


# ------------------------------------------------- v2 (npz) files


def _load(path: str, want_leaves: bool, keep=("params", "bn_state")) -> Tuple[Dict, Dict]:
    with np.load(path, allow_pickle=False) as z:
        meta_doc = json.loads(bytes(z["__meta__"]).decode("utf-8"))
        tree: Dict = {}
        if want_leaves:
            paths = meta_doc.get("leaf_paths")
            if paths is None:
                raise ValueError(f"{path} has no leaf_paths; re-save it with a current writer")
            for i, p in enumerate(paths):
                keys = _parse_path(p)
                if keep is None or keys[0] in keep:
                    _insert(tree, keys, _decode_leaf(z[f"leaf_{i:05d}"], meta_doc["dtypes"][i]))
    return _listify(tree), meta_doc


def read_metadata(path: str, allow_legacy_pickle=None) -> Dict[str, Any]:
    """The checkpoint's metadata; of a v1 file only behind the opt-in
    (None: the DCASE_ALLOW_LEGACY_PICKLE switch)."""
    if not _is_zip(path):
        return _load_v1(path, allow_legacy_pickle)[1]
    return _load(path, want_leaves=False)[1]["metadata"]


def load_inference_state(path: str, allow_legacy_pickle=None) -> Tuple[Dict, Dict]:
    """→ (params, bn_state) as nested dicts/lists of numpy arrays, the JAX
    package's pytree layout. Of a v1 file (behind the opt-in) the leading
    leaves, as many as the params and bn_state of the model that its
    metadata's config builds."""
    if not _is_zip(path):
        from dcase2019_task4_tpu_torch.eval.evaluate import config_from_metadata
        from dcase2019_task4_tpu_torch.models.crnn import CRNN

        leaves, metadata = _load_v1(path, allow_legacy_pickle)
        params, bn_state = params_to_jax(CRNN(config_from_metadata(metadata).model, device="cpu"))
        template: List = []
        _flatten(params, ".params", template)
        _flatten(bn_state, ".bn_state", template)
        tree = _tree_from_v1(path, leaves, template, exact=False)
        return tree["params"], tree["bn_state"]
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


def _write(path: str, leaves: List, metadata: Dict[str, Any]):
    """(keypath, array) leaves in order → a v2 npz at `path` (atomic)."""
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


def save_inference_checkpoint(path: str, params: Dict, bn_state: Dict, metadata: Dict[str, Any]):
    """Write params and bn_state (JAX pytree layout, numpy) as a v2 npz with
    the same metadata document the JAX writer produces."""
    leaves: List = []
    _flatten(params, ".params", leaves)
    _flatten(bn_state, ".bn_state", leaves)
    _write(path, leaves, metadata)


def config_to_dict(cfg) -> Dict:
    def conv(o):
        if dataclasses.is_dataclass(o):
            return {k: conv(v) for k, v in dataclasses.asdict(o).items()}
        return o

    return conv(cfg)


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


def _ravel_jax(tree) -> np.ndarray:
    """A JAX params-shaped pytree → one 1-D array in ravel_pytree's order."""
    leaves: List = []
    _flatten(tree, "", leaves)
    return np.concatenate([a.reshape(-1) for _, a in leaves])


def _unravel_jax(flat: np.ndarray, like) -> Dict:
    """The inverse of `_ravel_jax`, shaped as the pytree `like`."""
    leaves: List = []
    _flatten(like, "", leaves)
    sizes = [a.size for _, a in leaves]
    if flat.shape != (sum(sizes),):
        raise ValueError(f"a flat optimizer leaf of shape {flat.shape} does not fit {sum(sizes)} parameters")
    tree: Dict = {}
    for (q, a), part in zip(leaves, np.split(flat, np.cumsum(sizes)[:-1])):
        _insert(tree, _parse_path(q), part.reshape(a.shape))
    return _listify(tree)


def train_state_from_jax(state, params, bn_state, ema_params=None, ema_bn_state=None,
                         mu=None, nu=None, step: int = 0, count: Optional[int] = None):
    """Load numpy pytrees in the JAX layout into a TrainState (train/steps.py)
    in place: student, teacher (when given), Adam's `exp_avg` / `exp_avg_sq`
    / `step` (when mu and nu are given, the step from `count`, default
    `step`; both packages then take the same step from the same state) and
    the step counter. Returns `state`."""
    state.student.load_state_dict(params_from_jax(params, bn_state))
    if ema_params is not None:
        state.teacher.load_state_dict(params_from_jax(ema_params, ema_bn_state))
    if mu is not None:
        first, second = _named_from_jax(mu), _named_from_jax(nu)
        for name, p in state.student.named_parameters():
            state.optimizer.state[p] = {
                "step": torch.tensor(float(step if count is None else count)),
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


# ------------------------------------------------- whole TrainState on disk


def adam_count(optimizer) -> int:
    """The updates Adam has taken (0 before the first)."""
    for st in optimizer.state.values():
        if "step" in st:
            return int(st["step"])
    return 0


def train_state_leaves(state, ramped_adam: bool = False) -> List:
    """The TrainState as (keypath, array) leaves of the JAX TrainState, in
    its flatten order (see the module docstring); Adam's moments one 1-D
    leaf each under DCASE_FLAT_OPT=1."""
    j = train_state_to_jax(state)
    leaves: List = []
    for key in ("params", "bn_state", "ema_params", "ema_bn_state"):
        if j[key] is not None:
            _flatten(j[key], f".{key}", leaves)
    count = np.asarray(adam_count(state.optimizer), np.int32)
    inner = ".opt_state[0]"
    if ramped_adam:
        group = state.optimizer.param_groups[0]
        hyper = {"b1": group["betas"][0], "b2": group["betas"][1], "learning_rate": group["lr"]}
        leaves.append((".opt_state.count", count))
        leaves += [(f".opt_state.hyperparams['{k}']", np.asarray(hyper[k], np.float32)) for k in sorted(hyper)]
        leaves += [(f".opt_state.hyperparams_states['{k}'].count", count) for k in sorted(hyper)]
        inner = ".opt_state.inner_state[0]"
    leaves.append((f"{inner}.count", count))
    for key in ("mu", "nu"):
        if flat_opt_layout():
            leaves.append((f"{inner}.{key}", _ravel_jax(j[key])))
        else:
            _flatten(j[key], f"{inner}.{key}", leaves)
    leaves.append((".step", np.asarray(state.step, np.int32)))
    return leaves


def save_checkpoint(path: str, state, metadata: Dict[str, Any], ramped_adam: bool = False):
    """The whole TrainState (train/steps.py) as a v2 npz the JAX package's
    restore_checkpoint takes into its template (plain Adam, or with
    `ramped_adam` the ramped Adam's state; its moments per-leaf or flat as
    DCASE_FLAT_OPT says)."""
    _write(path, train_state_leaves(state, ramped_adam), metadata)


def restore_checkpoint(path: str, state, ramped_adam: bool = False, allow_legacy_pickle=None):
    """Load a whole-TrainState checkpoint (either package's writer) of plain
    Adam, or with `ramped_adam` of the ramped Adam, into `state` in place →
    (state, metadata). The stored optimizer, keypaths and shapes must be
    those of `state`, as the JAX template restore demands, and the moments'
    layout (per-leaf or flat) that of this process's DCASE_FLAT_OPT. A v1 file is read only behind the opt-in (None: the
    DCASE_ALLOW_LEGACY_PICKLE switch), positionally into `state`'s leaves."""
    flat = flat_opt_layout()
    if not _is_zip(path):
        leaves, metadata = _load_v1(path, allow_legacy_pickle)
        template = train_state_leaves(state, ramped_adam)
        try:
            tree = _tree_from_v1(path, leaves, template)
        except ValueError as e:
            raise ValueError(f"{e}\n(this state: {'ramped' if ramped_adam else 'plain'} Adam, the "
                             f"{_layout_name(flat)} optimizer layout)")
        ramped = ramped_adam
    else:
        tree, meta_doc = _load(path, want_leaves=True, keep=None)
        metadata = meta_doc["metadata"]
        stored = meta_doc["leaf_paths"]
        ramped = any(p.startswith(".opt_state.inner_state") for p in stored)
        if ramped != ramped_adam:
            names = {True: "ramped Adam", False: "plain Adam"}
            raise ValueError(f"checkpoint {path} holds the state of {names[ramped]}; "
                             f"this run uses {names[ramped_adam]}")
        stored_flat = any(p.endswith(".mu") for p in stored)
        if stored_flat != flat:
            raise ValueError(f"checkpoint {path} holds the {_layout_name(stored_flat)} optimizer layout; this "
                             f"run reads the {_layout_name(flat)} one: restore it under the DCASE_FLAT_OPT "
                             "setting that wrote it")
        want = train_state_leaves(state, ramped)
        diffs = [f"  leaf {i}: saved {p} {tuple(shape)}, template {q} {tuple(a.shape)}"
                 for i, ((q, a), p, shape) in enumerate(zip(want, stored, meta_doc["leaf_shapes"]))
                 if p != q or list(a.shape) != list(shape)]
        if len(stored) != len(want) or diffs:
            raise ValueError(f"checkpoint {path} does not match the train state ({len(stored)} leaves saved, "
                             f"{len(want)} in the template):\n" + "\n".join(diffs[:8]))
    opt = tree["opt_state"]
    inner = opt["inner_state"][0] if ramped else opt[0]
    mu, nu = inner["mu"], inner["nu"]
    if flat:
        like = params_to_jax(state.student)[0]
        mu, nu = _unravel_jax(mu, like), _unravel_jax(nu, like)
    train_state_from_jax(state, tree["params"], tree["bn_state"], tree.get("ema_params"), tree.get("ema_bn_state"),
                         mu, nu, step=int(tree["step"]), count=int(inner["count"]))
    return state, metadata
