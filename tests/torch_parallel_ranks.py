"""One rank of the port's data-parallel CPU tests (tests/test_torch_parallel.py,
tests/test_torch_parallel_experiment.py): the process group comes up over
Gloo from a `file://` store, the rank runs the cases of its mode and
writes what they gave to `<out>.rank<r>.pkl`.

    python tests/torch_parallel_ranks.py <mode> <rank> <world> <store> <out> [<json args>]

Modes:
  * grads — the exact parameter gradients of the flagship CRNN at [16, 96,
    64] (this rank's 8 clips, the gradient mean over the ranks) under the
    fused engines and the plain BatchNorm path; one Mean-Teacher step of
    the tiny model on this rank's shard-major cut of a global batch of 32;
    on rank 0, the same step in a group of world size 1 and without a group;
  * experiment — two epochs of the tiny Mean-Teacher Experiment from the
    initial checkpoint the test wrote, the resident batches against the
    streamed cut, and `evaluate`, `predict` and `predict --long --overlap`
    with `--data_parallel` on the best checkpoint.

Imports torch and the port only; the test modules call `spawn`.
"""

import json
import os
import pickle
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from dcase2019_task4_tpu_torch.config import ModelConfig  # noqa: E402
from dcase2019_task4_tpu_torch.models.crnn import CRNN  # noqa: E402
from dcase2019_task4_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from dcase2019_task4_tpu_torch.parallel import multihost  # noqa: E402
from dcase2019_task4_tpu_torch.train import steps as tsteps  # noqa: E402

# the pin's geometry (tests/test_sharding.py::test_fused_grads_sharded_match_single_device)
PIN_B, PIN_T, PIN_F = 16, 96, 64
ENGINES = {"default": {}, "planes": {"entry_block_pallas": True}, "crows": {"entry_block_crows": True},
           "plain": {"fused_block": False}}
# the Mean-Teacher step at TINY (tests/test_sharding.py::test_sharded_step_matches_single_device)
TINY = ModelConfig(nclass=3, nb_filters=(8, 8, 8), n_rnn_cell=8, dropout=0.0)
STEP_SIZES = (4, 8, 4)  # a rank's [weak | unlabeled | synthetic]


def pin_inputs():
    """(x [16, 96, 64], the cotangent of the strong output [16, 12, 10])."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((PIN_B, PIN_T, PIN_F)).astype(np.float32)
    cts = rng.standard_normal((PIN_B, PIN_T // 8, 10)).astype(np.float32)
    return x, cts


def pin_model(engine: str, weights) -> CRNN:
    """The flagship CRNN under `engine` with `weights` (a state_dict: the
    pin's, JAX's `CRNN.init(PRNGKey(0))`, which the test writes)."""
    model = CRNN(ModelConfig(dropout=0.0, **ENGINES[engine]))
    model.load_state_dict(weights)
    return model.train()


def pin_grads(engine: str, weights, x, cts, mesh=None):
    """{name: d loss / d param} with loss = the mean over the clips of
    Σ strong · cts; under a mesh x and cts are this rank's clips and the
    gradients are averaged over the ranks, as the train step does."""
    model = pin_model(engine, weights)
    strong, _ = model(torch.from_numpy(x), torch.Generator().manual_seed(0), mesh=mesh)
    (strong * torch.from_numpy(cts)).sum(dim=(1, 2)).mean().backward()
    if mesh is not None:
        pmesh.mean_over_ranks_([p.grad for p in model.parameters() if p.grad is not None], mesh, "gradients")
    # the attention head takes no part in this loss: its gradient is zero
    return {name: np.zeros(tuple(p.shape), np.float32) if p.grad is None else p.grad.numpy().copy()
            for name, p in model.named_parameters()}


def step_batch(world: int):
    """The global batch of the MT step in stream-major order ([w·n | u·n |
    s·n], the single process's) and the shard-major row order of the ranks."""
    n = sum(STEP_SIZES) * world
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((n, 64, 64)).astype(np.float32)
    target = np.zeros((n, 8, 3), np.float32)
    w, u = STEP_SIZES[0] * world, STEP_SIZES[1] * world
    target[:w, :, 0] = 1.0
    target[w:w + u] = -1.0
    target[w + u:, 2:5, 1] = 1.0
    order = pmesh.interleave_for_sharding(np.arange(n), STEP_SIZES, world)
    return {"features": feats, "target": target}, order


def slices(sizes):
    bounds = np.cumsum([0, *sizes])
    return slice(int(bounds[0]), int(bounds[1])), slice(int(bounds[2]), int(bounds[3]))


def mt_step(batch, mesh=None, sizes=STEP_SIZES):
    """One Mean-Teacher step of the tiny model from the seeded state → the
    metrics (mean over the ranks), and the student's parameters and both
    models' BatchNorm buffers after it."""
    state = tsteps.init_train_state(TINY, lambda p: torch.optim.Adam(p, lr=1e-3), torch.Generator().manual_seed(0))
    if mesh is not None:
        pmesh.replicate_state(state, mesh)
    weak, strong = slices(sizes)
    step = tsteps.make_train_step(weak, strong, mean_teacher=True, rampup_length=100, noise_std=0.0, mesh=mesh)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    state, metrics, _ = step(state, batch, torch.Generator().manual_seed(1), step.zero_metrics())
    metrics = step.mean_over_ranks(metrics)

    def buffers(model):
        return {k: v.numpy().copy() for k, v in model.state_dict().items() if "running_" in k}

    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": {k: p.detach().numpy().copy() for k, p in state.student.named_parameters()},
            "student_bn": buffers(state.student), "teacher_bn": buffers(state.teacher)}


def grads_mode(mesh, rank, world, args):
    out = {"grads": {}, "collectives": {}}
    x, cts = pin_inputs()
    weights = torch.load(args["weights"])
    per = PIN_B // world
    for engine in ENGINES:
        pmesh.collectives.clear()
        out["grads"][engine] = pin_grads(engine, weights, x[rank * per:(rank + 1) * per],
                                         cts[rank * per:(rank + 1) * per], mesh)
        out["collectives"][engine] = dict(pmesh.collectives)
    batch, order = step_batch(world)
    cut = order[rank * len(order) // world:(rank + 1) * len(order) // world]
    pmesh.collectives.clear()
    out["step"] = mt_step({k: v[cut] for k, v in batch.items()}, mesh)
    out["step_collectives"] = dict(pmesh.collectives)
    # world size 1: a group of this rank alone against no group (every rank
    # makes every group, as new_group asks)
    groups = [dist.new_group([r], backend="gloo") for r in range(world)]
    if rank == 0:
        one = pmesh.make_mesh("cpu", group=groups[0])
        solo, _ = step_batch(1)
        out["world1"] = {"group": mt_step(solo, one), "none": mt_step(solo), "world_size": one.world_size,
                         "grads_group": pin_grads("default", weights, x, cts, one),
                         "grads_none": pin_grads("default", weights, x, cts)}
    return out


def experiment_mode(mesh, rank, world, args):
    from dcase2019_task4_tpu_torch import cli
    from dcase2019_task4_tpu_torch.config import Config, DSPConfig, TrainConfig
    from dcase2019_task4_tpu_torch.data.pipeline import DeviceResidentData
    from dcase2019_task4_tpu_torch.train import checkpoints as ckpt
    from dcase2019_task4_tpu_torch.train.experiment import Experiment

    cfg = Config(dsp=DSPConfig(max_len_seconds=1.0),
                 model=ModelConfig(nclass=10, nb_filters=(16, 16, 16), n_rnn_cell=16, dropout=0.0),
                 train=TrainConfig(batch_size=args["batch"], n_epoch=1, num_prefetch=1, noise_std=0.0))
    saved = []
    real_save = ckpt.save_checkpoint
    ckpt.save_checkpoint = lambda path, *a, **kw: (saved.append(os.path.basename(path)), real_save(path, *a, **kw))
    exp = Experiment(cfg, mean_teacher=True, subpart_data=args["subpart"], synthetic_audio=True, seed=0,
                     device="cpu", mesh=mesh).build()
    exp.restore(args["init"])
    valids, meters = [], []
    real_validate, real_epoch = exp.validate, exp.train_epoch
    exp.validate = lambda epoch: valids.append(real_validate(epoch)) or valids[-1]
    exp.train_epoch = lambda epoch: meters.append(real_epoch(epoch)) or meters[-1]
    exp.run(store_dir=args["store"], n_epoch=2)
    ckpt.save_checkpoint = real_save
    out = {"valid": valids, "loss_means": [m.averages("") for m in meters], "saved": saved,
           "slices": (exp.weak_slice, exp.strong_slice), "n_steps": len(exp.pipeline),
           "valid_files": list(exp.valid_synth_stream.filenames) + list(exp.valid_weak_stream.filenames)}
    # the resident rows against the streamed cut, batch for batch
    resident = DeviceResidentData(exp.pipeline, "cpu", mesh=mesh)
    same, n = True, 0
    for epoch in (0, 1):
        for a, b in zip(resident.iter_epoch(exp.pipeline.sampler, epoch), exp.pipeline.iter_epoch(epoch, prefetch=0)):
            same = same and all(np.array_equal(a[k].numpy(), b[k]) for k in b)
            n += 1
    out["resident_same"], out["resident_batches"] = same, n
    for command in ("evaluate", "predict", "predict_long"):
        run = cli.evaluate if command == "evaluate" else cli.predict
        out[command] = run(args[command] + ["--data_parallel", "--device", "cpu"])
    return out


def spawn(mode: str, tmp, world: int = 2, args: str = "{}"):
    """This script's ranks, started, each logging to `<tmp>/out.rank<r>.log`
    → a function that waits for them (stopping them all if one fails or
    they outlast the timeout) and returns their results in rank order."""
    out = str(tmp / "out")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    logs = [open(f"{out}.rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.join(ROOT, "tests", "torch_parallel_ranks.py"), mode,
                               str(r), str(world), str(tmp / "store"), out, args],
                              cwd=ROOT, env=env, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]

    def results(timeout: float = 600.0):
        try:
            for p in procs:
                p.wait(timeout=timeout)
        finally:
            for p, log in zip(procs, logs):
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()
        for r, p in enumerate(procs):
            with open(f"{out}.rank{r}.log") as f:
                assert p.returncode == 0, f"rank {r} failed:\n{f.read()[-4000:]}"
        loaded = []
        for r in range(world):
            with open(f"{out}.rank{r}.pkl", "rb") as f:
                loaded.append(pickle.load(f))
        return loaded

    return results


def main():
    mode, rank, world, store, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
    args = json.loads(sys.argv[6]) if len(sys.argv) > 6 else {}
    torch.set_num_threads(1)
    multihost.initialize(f"file://{store}", world, rank, backend="gloo", device="cpu")
    try:
        mesh = pmesh.make_mesh("cpu")
        result = (grads_mode if mode == "grads" else experiment_mode)(mesh, rank, world, args)
        result.update(rank=rank, world=world, backend=mesh.backend)
        with open(f"{out}.rank{rank}.pkl", "wb") as f:
            pickle.dump(result, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
