"""Entry points of the PyTorch/CUDA port (the counterparts of
__graft_entry__.py's, which build the JAX package's).

entry(device)               — the flagship forward (K1 log-mel frontend +
                              eval-mode CRNN) and its inputs, on one card.
dryrun_multichip(n, device) — ONE full Mean-Teacher training step (K1
                              frontend, student + EMA teacher, Adam, EMA) on
                              each of n ranks of a torch.distributed group,
                              the batch split over the ranks (data
                              parallel, parallel/mesh.py), at tiny shapes.

    python graft_entry_torch.py [--device cuda] [--dryrun N]

Imports torch, numpy and the port only. The entry points run on the card
unless the caller passes device="cpu"; "cuda" without a card raises.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

BATCH = 4  # entry()'s batch, as __graft_entry__.py's
# dryrun_multichip's tiny shapes (__graft_entry__.py:112-131): 1.11 s clips
# → 96 frames → 12 pooled frames; a rank's batch [weak 2 | unlabeled 4 |
# synthetic 2]; the global batch is that layout tiled rank-major
RANK_BATCH = 8
WEAK, STRONG = slice(0, 2), slice(6, 8)
RANK_TIMEOUT_S = 600.0  # the longest the dry run waits for its ranks


def entry(device="cuda"):
    """→ (forward, (model, frontend, padded_audio, n_frames)):
    `forward(*args)` gives (strong [4, 108, 10], weak [4, 10]) of the
    flagship `Config()`, weights from `seeded_init_(model, 0)`, inputs made
    as __graft_entry__.py makes them (seeded normal audio × 0.1, every frame
    valid)."""
    import torch

    from dcase2019_task4_tpu_torch.config import Config
    from dcase2019_task4_tpu_torch.eval.evaluate import resolve_device
    from dcase2019_task4_tpu_torch.models.crnn import CRNN, seeded_init_
    from dcase2019_task4_tpu_torch.ops.mel import MelFrontend

    device = resolve_device(str(device))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = Config()
    d = cfg.dsp
    model = seeded_init_(CRNN(cfg.model), 0).to(device).eval()
    frontend = MelFrontend(sample_rate=d.sample_rate, n_window=d.n_window, hop_length=d.hop_length,
                           n_mels=d.n_mels, f_min=d.f_min, f_max=d.f_max, max_frames=d.max_frames, device=device)

    def forward(model, frontend, padded_audio, n_frames):
        feats = frontend.log_mel(padded_audio, n_frames)
        return model(feats)

    rng = np.random.default_rng(0)
    padded = torch.as_tensor(rng.standard_normal((BATCH, d.max_samples + d.n_window)).astype(np.float32) * 0.1,
                             device=device)
    frames = torch.full((BATCH,), d.max_frames, dtype=torch.int32, device=device)
    return forward, (model, frontend, padded, frames)


def dryrun_batch(n_ranks: int):
    """The global batch of the dry run ({"audio", "frames", "target"},
    numpy), drawn as __graft_entry__.py draws it."""
    from dcase2019_task4_tpu_torch.config import DSPConfig

    d = DSPConfig(max_len_seconds=1.11)
    B = RANK_BATCH * n_ranks
    rng = np.random.default_rng(0)
    return {
        "audio": (rng.standard_normal((B, d.max_samples + d.n_window)) * 0.1).astype(np.float32),
        "frames": np.full((B,), d.max_frames, np.int32),
        "target": rng.integers(0, 2, (B, d.max_frames // 8, 10)).astype(np.float32),
    }


def dryrun_step(rank: int, n_ranks: int, device, mesh=None) -> float:
    """One Mean-Teacher step of the tiny model on rank `rank`'s chunk of the
    global batch → the step's loss, averaged over the ranks."""
    import torch

    from dcase2019_task4_tpu_torch.config import DSPConfig, ModelConfig
    from dcase2019_task4_tpu_torch.ops.mel import MelFrontend
    from dcase2019_task4_tpu_torch.parallel.mesh import replicate_state
    from dcase2019_task4_tpu_torch.train.steps import init_train_state, make_train_step

    d = DSPConfig(max_len_seconds=1.11)
    m = ModelConfig(nclass=10, nb_filters=(16, 16, 16), n_rnn_cell=16)
    frontend = MelFrontend(sample_rate=d.sample_rate, n_window=d.n_window, hop_length=d.hop_length,
                           n_mels=d.n_mels, f_min=d.f_min, f_max=d.f_max, max_frames=d.max_frames, device=device)
    step = make_train_step(WEAK, STRONG, mean_teacher=True, rampup_length=100, frontend=frontend,
                           scaler_mean=np.zeros(d.n_mels, np.float32), scaler_std=np.ones(d.n_mels, np.float32),
                           mesh=mesh)
    state = init_train_state(m, lambda p: torch.optim.Adam(p, lr=1e-3), torch.Generator().manual_seed(0),
                             with_ema=True, device=device)
    if mesh is not None:
        replicate_state(state, mesh)
    rows = slice(rank * RANK_BATCH, (rank + 1) * RANK_BATCH)
    batch = {k: torch.as_tensor(v[rows], device=device) for k, v in dryrun_batch(n_ranks).items()}
    generator = torch.Generator(device=device).manual_seed(1 + rank)
    state, metrics, _ = step(state, batch, generator, step.zero_metrics(device))
    return float(step.mean_over_ranks(metrics)["loss"])


def _rank_main(rank: int, n_ranks: int, store: str, device_type: str, backend: str, results):
    """One process of `dryrun_multichip`: join the group, take the step, put
    (rank, loss) or (rank, the error) on `results`."""
    import torch
    import torch.distributed as dist

    from dcase2019_task4_tpu_torch.parallel import mesh as pmesh
    from dcase2019_task4_tpu_torch.parallel import multihost

    torch.set_num_threads(1)
    try:
        device = torch.device("cpu") if device_type == "cpu" else torch.device(
            "cuda", rank % torch.cuda.device_count())
        multihost.initialize(f"file://{store}", n_ranks, rank, backend=backend, device=device)
        try:
            loss = dryrun_step(rank, n_ranks, device, pmesh.make_mesh(device))
            dist.barrier()
        finally:
            dist.destroy_process_group()
        results.put((rank, loss))
    except Exception as e:  # the parent reports every rank's failure
        results.put((rank, f"{type(e).__name__}: {e}"))
        raise


def dryrun_multichip(n_ranks: int, device="cuda") -> float:
    """Spawn `n_ranks` processes in one torch.distributed group, each taking
    one Mean-Teacher step on its chunk of the global batch; assert a finite
    loss equal on every rank and print it. → the loss. On the card the
    group is NCCL with a card a rank, or Gloo where there are more ranks
    than cards (NCCL refuses two ranks on one card); on the CPU it is Gloo.
    "cuda" without a card raises."""
    import multiprocessing

    import torch

    from dcase2019_task4_tpu_torch.eval.evaluate import resolve_device

    device_type = resolve_device(str(device)).type
    backend = "nccl" if device_type == "cuda" and n_ranks <= torch.cuda.device_count() else "gloo"
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank_main, args=(r, n_ranks, os.path.join(tmp, "store"), device_type, backend,
                                                       results))
                 for r in range(n_ranks)]
        for p in procs:
            p.start()
        try:
            got = dict(results.get(timeout=RANK_TIMEOUT_S) for _ in procs)  # drained before the joins
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    losses = [got[r] for r in range(n_ranks)]
    failed = [f"rank {r}: {v}" for r, v in enumerate(losses) if isinstance(v, str)]
    if failed:
        raise RuntimeError("dryrun_multichip: " + "; ".join(failed))
    loss = losses[0]
    assert np.isfinite(loss), f"multichip dryrun loss not finite: {loss}"
    assert all(v == loss for v in losses), f"the ranks' losses differ: {losses}"
    print(f"dryrun_multichip({n_ranks}): OK, loss={loss:.4f}")
    return loss


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="graft_entry_torch.py", description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--dryrun", type=int, default=0, metavar="N", help="run dryrun_multichip(N) instead of entry")
    args = ap.parse_args(argv)
    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("graft_entry_torch.py runs on a card by default and torch.cuda.is_available() is False; "
              "pass --device cpu to run on the CPU", file=sys.stderr)
        return 2
    if args.dryrun:
        dryrun_multichip(args.dryrun, args.device)
        return 0
    forward, fargs = entry(args.device)
    strong, weak = forward(*fargs)
    print(f"entry(): strong {tuple(strong.shape)} weak {tuple(weak.shape)} on {args.device}, "
          f"finite {bool(torch.isfinite(strong).all() and torch.isfinite(weak).all())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
