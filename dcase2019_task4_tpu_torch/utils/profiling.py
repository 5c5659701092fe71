"""Profiling hooks (counterpart of dcase2019_task4_tpu/utils/profiling.py,
which wraps jax.profiler).

  * `trace(dir)`: a context manager around `torch.profiler.profile`, CPU
    activity and, when a card is used, CUDA activity; on exit it writes a
    chrome trace (`<time>.pt.trace.json`) into `dir`.
  * `top_device_ops(dir)`: reads the newest trace in `dir` and returns the
    device ops by total time: kernels, copies and memsets (the trace's
    `kernel`, `gpu_memcpy` and `gpu_memset` events), summed by name.
  * `Throughput`: a steady-state items/s meter with warm-up discard (a copy).
  * `card_line(device)`: the card's name and power limit, written beside
    every number a tool measures on it.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
import subprocess
import time
from typing import List, Optional, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(trace_dir: str, cuda: Optional[bool] = None):
    """Profile the block; `cuda` (default: whether torch sees a card) adds
    the device activity. The chrome trace lands in `trace_dir`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    if cuda:
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(trace_dir, f"{time.time_ns()}.pt.trace.json"))


def card_line(device) -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` of
    the card that holds a CUDA `device`, or "cpu" for the CPU. The card is
    found by its UUID: nvidia-smi numbers the cards physically and ignores
    CUDA_VISIBLE_DEVICES, which renumbers torch's. Raises if nvidia-smi has
    no line for the card."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = torch.cuda.current_device() if device.index is None else device.index
    uuid = str(torch.cuda.get_device_properties(index).uuid).lower()
    out = subprocess.run(["nvidia-smi", "--query-gpu=uuid,name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    for line in out.stdout.strip().splitlines():
        card_uuid, _, rest = line.partition(", ")
        if card_uuid.strip().lower().removeprefix("gpu-") == uuid:
            return rest.strip()
    raise RuntimeError(f"nvidia-smi lists no card of UUID {uuid} (cuda:{index}): {out.stdout!r}")


def _newest_trace(trace_dir: str) -> Optional[str]:
    paths = [p for pattern in ("*.json", "*.json.gz")
             for p in glob.glob(os.path.join(trace_dir, "**", pattern), recursive=True)]
    return max(paths, key=os.path.getmtime) if paths else None


def top_device_ops(trace_dir: str, top: int = 20) -> List[Tuple[str, float, str]]:
    """→ [(op name, total ms, launch shape)] of the newest trace in
    `trace_dir`, the longest first: every device event's duration summed by
    name; the shape is the first launch's grid and block (empty for copies
    and memsets)."""
    path = _newest_trace(trace_dir)
    if path is None:
        return []
    with (gzip.open(path, "rt") if path.endswith(".gz") else open(path)) as f:
        tr = json.load(f)
    events = tr.get("traceEvents", []) if isinstance(tr, dict) else tr
    durs: dict = collections.defaultdict(float)
    shapes: dict = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        name = e.get("name", "?")
        durs[name] += float(e.get("dur", 0))
        if name not in shapes:
            args = e.get("args", {})
            shapes[name] = f"grid {args['grid']} block {args['block']}" if "grid" in args and "block" in args else ""
    ranked = sorted(durs.items(), key=lambda kv: -kv[1])[:top]
    return [(name, us / 1000.0, shapes[name]) for name, us in ranked]


class Throughput:
    """Steady-state items/sec: discards `warmup` updates, then rates the
    rest."""

    def __init__(self, warmup: int = 3):
        self.warmup = warmup
        self.count = 0
        self.items = 0
        self._t0 = None

    def update(self, n_items: int):
        self.count += 1
        if self.count == self.warmup:
            self._t0 = time.time()
            self.items = 0
        elif self.count > self.warmup:
            self.items += n_items

    @property
    def items_per_sec(self) -> float:
        if self._t0 is None or self.items == 0:
            return 0.0
        return self.items / (time.time() - self._t0)
