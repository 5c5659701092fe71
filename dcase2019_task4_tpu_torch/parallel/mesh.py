"""Data parallelism over a torch.distributed process group (counterpart of
dcase2019_task4_tpu/parallel/mesh.py).

The JAX package runs one program over a 1-D device mesh: the step runs
under shard_map, each device takes its contiguous chunk of the global
batch, BatchNorm sums are psum'd and the gradients pmean'd. PyTorch runs
one process per card, so here the mesh is a process group: NCCL between
cards, Gloo on the CPU (or wherever the caller names it). `make_mesh`
returns a `Mesh`, the small handle that the step, the model, the pipeline,
the Experiment and the evaluator take where the JAX functions take `mesh`.
A group launched by `torchrun` stands for the JAX package's single-process
mesh, and a group brought up by `multihost.initialize` for its multi-host
runtime: one design serves both.

Each rank holds only its own chunk of the global batch (`BatchPipeline`
assembles this rank's cut, `DeviceResidentData` gathers it), so the JAX
package's `shard_batch`, which places a global batch on the mesh's
devices, has no counterpart.

The collectives are `all_reduce` and `broadcast` on tensors, which Gloo
also runs on CUDA tensors. Host tensors go through a Gloo group beside an
NCCL one. Every call is counted in `collectives` under what it carries:

  * "bn_stats": Σy, Σy² of a training BatchNorm, one buffer a layer
    (models/crnn.py; the plain path's differentiable sum in models/layers.py);
  * "bn_backward": S1, S2 of a fused block's backward between its two
    passes (ops/fused_block.py, ops/fused_entry_block.py), and the
    cotangent of the plain path's sum;
  * "gradients": the student's gradients, one flat buffer a step;
  * "metrics", "counts", "objects", "state": per-epoch metric sums,
    validation counts, gathered evaluation results, broadcast state.
"""

from __future__ import annotations

import collections
import dataclasses
import pickle
from typing import List, Sequence

import numpy as np
import torch
import torch.distributed as dist

# collectives issued since the last `clear()`, by what they carry
collectives: collections.Counter = collections.Counter()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A process group as the port's mesh. `group` carries the collectives
    of tensors on `device`, `cpu_group` those of host tensors (the same
    group unless the backend is NCCL). `multihost`: the group came up
    through `multihost.initialize` (device-resident data refuses it, as the
    JAX package refuses several processes)."""

    group: object
    cpu_group: object
    rank: int
    world_size: int
    device: torch.device
    backend: str
    multihost: bool = False

    def group_for(self, tensor: torch.Tensor):
        return self.cpu_group if tensor.device.type == "cpu" else self.group

    def src(self, group, rank: int = 0) -> int:
        """The global rank of group rank `rank`."""
        return rank if group is None else dist.get_global_rank(group, rank)


def make_mesh(device, group=None, multihost: bool = False) -> Mesh:
    """The handle of `group` (the default group when None) for this rank,
    whose tensors live on `device`. Needs an initialised process group. On
    a card the device becomes the current one, as NCCL expects."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs a process group: run under torchrun, or call "
                           "parallel.multihost.initialize first")
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = str(dist.get_backend(group))
    cpu_group = group
    if backend != "gloo":
        ranks = None if group is None else dist.get_process_group_ranks(group)
        cpu_group = dist.new_group(ranks=ranks, backend="gloo")
    return Mesh(group, cpu_group, dist.get_rank(group), dist.get_world_size(group), device, backend, multihost)


def all_reduce_(tensor: torch.Tensor, mesh: Mesh, what: str) -> torch.Tensor:
    """Sum `tensor` over the ranks, in place; counted under `what`."""
    dist.all_reduce(tensor, group=mesh.group_for(tensor))
    collectives[what] += 1
    return tensor


def broadcast_(tensor: torch.Tensor, mesh: Mesh, what: str, src: int = 0) -> torch.Tensor:
    """`tensor` of group rank `src` on every rank, in place; counted under
    `what`."""
    group = mesh.group_for(tensor)
    dist.broadcast(tensor, src=mesh.src(group, src), group=group)
    collectives[what] += 1
    return tensor


class _AllReduceSum(torch.autograd.Function):
    """Σ over the ranks, whose backward sums the cotangent over the ranks:
    the transpose of the JAX package's psum under shard_map without its
    replication check (check_vma=False)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_reduce_(x.clone(), mesh, "bn_stats")

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.mesh, "bn_backward"), None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Σ of x over the ranks, with a gradient (see `_AllReduceSum`)."""
    return _AllReduceSum.apply(x, mesh)


def mean_over_ranks_(tensors: Sequence[torch.Tensor], mesh: Mesh, what: str) -> None:
    """Each tensor ← its mean over the ranks, in place, through ONE
    all-reduce of a flat buffer (the JAX package's pmean of a pytree); the
    tensors share a device and a dtype."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce_(flat, mesh, what).div_(mesh.world_size)
    parts = flat.split([t.numel() for t in tensors])
    torch._foreach_copy_(list(tensors), [v.view_as(t) for t, v in zip(tensors, parts)])


@torch.no_grad()
def replicate_state(state, mesh: Mesh):
    """Rank 0's TrainState on every rank, so the ranks provably start
    equal: the student's and the teacher's parameters and BatchNorm
    buffers, the optimizer's state (moments and step counts) and the host
    step counter, in one broadcast of a flat buffer for each (device,
    dtype) among them. → state (updated in place)."""
    tensors = list(state.student.state_dict().values())
    if state.teacher is not None:
        tensors += list(state.teacher.state_dict().values())
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            moments = state.optimizer.state.get(p, {})
            tensors += [moments[k] for k in sorted(moments) if isinstance(moments[k], torch.Tensor)]
    tensors.append(torch.tensor([state.step], dtype=torch.int64))
    kinds = {}
    for t in tensors:
        kinds.setdefault((t.device, t.dtype), []).append(t)
    for ts in kinds.values():
        flat = broadcast_(torch.cat([t.reshape(-1) for t in ts]), mesh, "state")
        for t, v in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(v.view_as(t))
    state.step = int(tensors[-1][0])
    return state


def all_gather_objects(obj, mesh: Mesh) -> List:
    """Every rank's `obj` (picklable), in rank order, on every rank: the
    sizes by one all-reduce, then each rank's bytes broadcast from it, all
    on host tensors."""
    data = torch.frombuffer(bytearray(pickle.dumps(obj)), dtype=torch.uint8)
    sizes = torch.zeros(mesh.world_size, dtype=torch.int64)
    sizes[mesh.rank] = data.numel()
    all_reduce_(sizes, mesh, "objects")
    out = []
    for r in range(mesh.world_size):
        buf = data if r == mesh.rank else torch.empty(int(sizes[r]), dtype=torch.uint8)
        out.append(pickle.loads(broadcast_(buf, mesh, "objects", src=r).numpy().tobytes()))
    return out


# ------------------------------------------- the JAX package's index helpers


def tile_stream_layout(batch_sizes: Sequence[int], n_devices: int):
    """Global multi-stream layout for data parallelism.

    Per-device sub-batches [w, u, s] tile to global [w·n | u·n | s·n] so the
    loss slices stay static AND every shard holds the same stream mix.
    Returns (global_batch_sizes, global_slices)."""
    global_sizes = [b * n_devices for b in batch_sizes]
    slices, start = [], 0
    for b in global_sizes:
        slices.append(slice(start, start + b))
        start += b
    return global_sizes, slices


def interleave_for_sharding(pairs: np.ndarray, batch_sizes: Sequence[int], n_devices: int) -> np.ndarray:
    """Reorder a global [w·n | u·n | s·n] batch of (stream, idx) pairs so
    that contiguous per-device shards each contain the per-device layout
    [w | u | s]."""
    n_streams = len(batch_sizes)
    out = []
    offsets = np.cumsum([0] + [b * n_devices for b in batch_sizes])
    for d in range(n_devices):
        for s in range(n_streams):
            b = batch_sizes[s]
            seg = pairs[offsets[s] + d * b : offsets[s] + (d + 1) * b]
            out.append(seg)
    return np.concatenate(out, axis=0)
