"""Several processes, one card each (counterpart of
dcase2019_task4_tpu/parallel/multihost.py).

`initialize` brings up the process group from an explicit coordinator
address, process count and process index (the `--multihost` flags); a
group launched by `torchrun` comes up from its environment instead
(cli.py). Every process runs the same program and builds only its cut of
each global batch from the shared (seed, epoch) (`host_shard_pairs`), so
sampling needs no traffic. Validation files are dealt round-robin
(`shard_rows`, data/manifests.shard_manifest) and the additive metric
counts summed (`all_sum_hosts`). Process 0 writes the checkpoints, and
`sync_hosts` holds the others until they are on disk.

The JAX package's `make_global_batch` assembles each host's arrays into
one global array over the mesh. PyTorch has no global array: each rank's
step runs on its own chunk and the collectives inside the step
(parallel/mesh.py) join the ranks, so it has no counterpart.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from dcase2019_task4_tpu_torch.parallel.mesh import Mesh, all_reduce_

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def initialize(coordinator_address: str, num_processes: int, process_id: int, backend: Optional[str] = None,
               device="cuda") -> str:
    """`init_process_group` for process `process_id` of `num_processes`,
    meeting at `coordinator_address`: "host:port" (TCP; process 0 listens
    there) or an init-method URL such as "file:///shared/store". The
    backend is NCCL for a CUDA `device`, Gloo for the CPU, or the one the
    caller names (Gloo on the card lets several ranks share one card, which
    NCCL refuses). A failure raises; nothing falls back to another backend.
    → the backend."""
    if num_processes is None or process_id is None or coordinator_address is None:
        raise ValueError("multi-host needs --coordinator_address, --num_processes and --process_id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} is not in [0, {num_processes})")
    backend = backend or BACKENDS[torch.device(device).type]
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes, rank=process_id)
    return backend


def host_shard_pairs(pairs: np.ndarray, process_index: int, process_count: int) -> np.ndarray:
    """Rows of the global (stream, idx) batch this host must materialize.

    The global batch axis is sharded contiguously over processes in
    process-index order; batch size must divide evenly."""
    B = pairs.shape[0]
    if B % process_count:
        raise ValueError(f"global batch {B} not divisible by {process_count} hosts")
    per = B // process_count
    return pairs[process_index * per : (process_index + 1) * per]


def shard_rows(n: int, process_index: int, process_count: int) -> np.ndarray:
    """Row indices of an n-item evaluation set this host scores: every
    process_count-th item (round-robin — balanced for any n, no divisibility
    requirement). The per-host metric COUNTS merge additively
    (eval/sed_scores.py count_vector), so the partition choice only affects
    load balance, never the merged numbers."""
    return np.arange(process_index, n, process_count)


def all_sum_hosts(vec: np.ndarray, mesh: Optional[Mesh]) -> np.ndarray:
    """Element-wise sum of a small host-local float64 vector over the ranks
    (one all-reduce; the identity without a mesh). Merges the additive
    metric counts of sharded evaluation."""
    out = torch.as_tensor(np.asarray(vec, np.float64)).clone()
    if mesh is not None:
        all_reduce_(out, mesh, "counts")
    return out.numpy()


def sync_hosts(mesh: Optional[Mesh]) -> None:
    """A barrier of the ranks (a no-op without a mesh or at world size 1):
    the ranks that read a checkpoint process 0 wrote wait for it."""
    if mesh is not None and mesh.world_size > 1:
        dist.barrier(group=mesh.cpu_group)
