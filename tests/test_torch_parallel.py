"""Port parity: data-parallel training on two Gloo ranks (parallel/,
models/crnn.py, ops/fused_block.py, ops/fused_entry_block.py, train/steps.py).

The ranks run in two processes of tests/torch_parallel_ranks.py, spawned
once for the module, their group meeting at a `file://` store under
tmp_path (no TCP port: the suite's workers run files side by side). The JAX
references run here while the ranks work, with the Pallas kernels
interpreted, on the conftest's 8-virtual-device mesh.

  * The copied index helpers equal the JAX package's on random inputs.
  * The pin (tests/test_sharding.py::test_fused_grads_sharded_match_single_device):
    the exact parameter gradients of the flagship CRNN at [16, 96, 64],
    dropout 0, loss = the mean over the clips of Σ strong · cts, under the
    default, planes and crows engines, each rank on its 8 clips with the
    gradients averaged over the ranks, against the port's single process,
    JAX's single device `g_single` and, for the default engine, JAX's
    8-device shard_map gradients; the same at the plain BatchNorm path
    (`fused_block=False`, the differentiable all-reduce) against JAX's
    plain path. Bar: rtol 1e-4, atol 1e-6, the pin's own.
  * One Mean-Teacher step of the tiny model, two ranks on their
    shard-major cuts of a global batch of 32 against one process on the
    whole batch (tests/test_sharding.py::test_sharded_step_matches_single_device):
    metrics 1e-5, parameters rtol 1e-3 / atol 5e-4 (float32 sums in
    another order pass through Adam's first, normalising step), both
    models' BatchNorm buffers 1e-5; the ranks' parameters bit-equal; the
    collectives of the step: 6 BatchNorm statistics, 3 S1 / S2 and 1
    gradient reduction.
  * A group of world size 1 gives the bits of no group.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcase2019_task4_tpu.config import ModelConfig as JModel
from dcase2019_task4_tpu.data import manifests as jmanifests
from dcase2019_task4_tpu.models.crnn import CRNN as JCRNN
from dcase2019_task4_tpu.parallel import mesh as jmesh
from dcase2019_task4_tpu.parallel import multihost as jmultihost
from dcase2019_task4_tpu_torch.config import Config
from dcase2019_task4_tpu_torch.data import manifests as tmanifests
from dcase2019_task4_tpu_torch.parallel import mesh as tmesh
from dcase2019_task4_tpu_torch.parallel import multihost as tmultihost
from dcase2019_task4_tpu_torch.train import checkpoints as tckpt

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_ranks as drv  # noqa: E402

WORLD = 2
RTOL, ATOL = 1e-4, 1e-6
JAX_FLAGS = {"default": {}, "planes": {"entry_block_pallas": True}, "crows": {"entry_block_crows": True}}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for torch: the suite runs several workers on the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The pin's parameters, JAX's `CRNN.init(PRNGKey(0))` of the flagship
    configuration, as (JAX pytrees, the port's state_dict written for the
    ranks)."""
    params, state = JCRNN(JModel(dropout=0.0)).init(jax.random.PRNGKey(0))
    params, state = jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)
    path = tmp_path_factory.mktemp("weights") / "pin.pt"
    torch.save(tckpt.params_from_jax(params, state), path)
    return params, state, path


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, weights):
    return drv.spawn("grads", tmp_path_factory.mktemp("parallel"), args=json.dumps({"weights": str(weights[2])}))


@pytest.fixture(scope="module")
def results(ranks, jax_grads):
    return ranks()


@pytest.fixture(scope="module")
def jax_grads(ranks, weights):
    """JAX's gradients of the pin: the single device under each engine
    (kernels interpreted) and the plain path, and the default engine over
    the 8-device mesh."""
    from jax.sharding import PartitionSpec as P

    x, cts = drv.pin_inputs()
    x, cts = jnp.asarray(x), jnp.asarray(cts)
    params = jax.tree.map(jnp.asarray, weights[0])
    state = jax.tree.map(jnp.asarray, weights[1])
    key = jax.random.PRNGKey(9)
    out = {}

    def loss_of(model):
        def loss(p, xb, cb, axis=None, axis_size=1):
            s, _, _ = model.apply(p, state, xb, train=True, rng=key, batch_axis=axis, axis_size=axis_size)
            return jnp.mean(jnp.sum(s * cb, axis=(1, 2)))
        return loss

    for engine, flags in JAX_FLAGS.items():
        loss = loss_of(JCRNN(JModel(fused_block=True, fused_interpret=True, dropout=0.0, **flags)))
        out[engine] = jax.jit(jax.grad(loss))(params, x, cts)
        if engine == "default":
            def shard_fn(p, xb, cb):
                return jax.lax.pmean(jax.grad(lambda pp: loss(pp, xb, cb, "data", 8))(p), "data")

            sharded = jax.shard_map(shard_fn, mesh=jmesh.make_mesh(), in_specs=(P(), P("data"), P("data")),
                                    out_specs=P(), check_vma=False)
            out["sharded"] = jax.jit(sharded)(params, x, cts)
    out["plain"] = jax.jit(jax.grad(loss_of(JCRNN(JModel(fused_block=False, dropout=0.0)))))(params, x, cts)
    return {k: {n: t.numpy() for n, t in tckpt._named_from_jax(jax.tree.map(np.asarray, g)).items()}
            for k, g in out.items()}


def assert_grads_close(got, want, what):
    assert set(got) >= set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=RTOL, atol=ATOL, err_msg=f"{what}: {name}")


# ------------------------------------------------------------ index helpers


@pytest.mark.parametrize("helper", ["tile_stream_layout", "interleave_for_sharding", "host_shard_pairs",
                                    "shard_rows", "shard_manifest"])
def test_the_copied_helpers_equal_the_jax_packages(helper):
    rng = np.random.default_rng(11)
    if helper == "shard_manifest":
        tsv = Config().paths.validation
        full = tmanifests.load_manifest(tsv), jmanifests.load_manifest(tsv)
    for _ in range(5):
        n_dev = int(rng.integers(1, 6))
        sizes = [int(b) for b in rng.integers(1, 5, size=int(rng.integers(1, 4)))]
        if helper == "tile_stream_layout":
            assert tmesh.tile_stream_layout(sizes, n_dev) == jmesh.tile_stream_layout(sizes, n_dev)
        elif helper == "interleave_for_sharding":
            pairs = rng.integers(0, 100, size=(sum(sizes) * n_dev, 2))
            np.testing.assert_array_equal(tmesh.interleave_for_sharding(pairs, sizes, n_dev),
                                          jmesh.interleave_for_sharding(pairs, sizes, n_dev))
        elif helper == "host_shard_pairs":
            pairs = rng.integers(0, 100, size=(sum(sizes) * n_dev * 2, 2))
            for p in range(n_dev):
                np.testing.assert_array_equal(tmultihost.host_shard_pairs(pairs, p, n_dev),
                                              jmultihost.host_shard_pairs(pairs, p, n_dev))
        elif helper == "shard_rows":
            n = int(rng.integers(0, 40))
            for p in range(n_dev):
                np.testing.assert_array_equal(tmultihost.shard_rows(n, p, n_dev), jmultihost.shard_rows(n, p, n_dev))
        else:
            mine = tmanifests.subpart_manifest(full[0], 60, n_dev)
            theirs = jmanifests.subpart_manifest(full[1], 60, n_dev)
            for p in range(n_dev):
                a, b = tmanifests.shard_manifest(mine, p, n_dev), jmanifests.shard_manifest(theirs, p, n_dev)
                assert a.filenames == b.filenames
                assert [(r["filename"], r["event_label"], r["onset"]) for r in a.rows] == [
                    (f, None if isinstance(e, float) else e, None if o != o else o)
                    for f, e, o in zip(b.df["filename"], b.df["event_label"], b.df["onset"])]


# ------------------------------------------------------------------ the pin


@pytest.mark.parametrize("engine", ["default", "planes", "crows"])
def test_fused_grads_on_two_ranks_match_one_process_and_jax(results, jax_grads, weights, engine):
    r0, r1 = results
    for name in r0["grads"][engine]:  # every rank takes the same averaged gradient
        np.testing.assert_array_equal(r0["grads"][engine][name], r1["grads"][engine][name], err_msg=name)
    x, cts = drv.pin_inputs()
    single = drv.pin_grads(engine, torch.load(weights[2]), x, cts)
    assert_grads_close(r0["grads"][engine], single, f"{engine}: two ranks against one process")
    assert_grads_close(r0["grads"][engine], jax_grads[engine], f"{engine}: two ranks against JAX g_single")
    if engine == "default":
        assert_grads_close(r0["grads"][engine], jax_grads["sharded"], "two ranks against JAX over 8 devices")
    assert r0["collectives"][engine] == {"bn_stats": 3, "bn_backward": 3, "gradients": 1}


def test_plain_batchnorm_grads_on_two_ranks_match_one_process_and_jax(results, jax_grads, weights):
    """fused_block=False: the statistics through the differentiable
    all-reduce, whose backward sums the cotangent over the ranks."""
    r0, r1 = results
    for name in r0["grads"]["plain"]:
        np.testing.assert_array_equal(r0["grads"]["plain"][name], r1["grads"]["plain"][name], err_msg=name)
    x, cts = drv.pin_inputs()
    single = drv.pin_grads("plain", torch.load(weights[2]), x, cts)
    assert_grads_close(r0["grads"]["plain"], single, "plain: two ranks against one process")
    assert_grads_close(r0["grads"]["plain"], jax_grads["plain"], "plain: two ranks against JAX")
    assert r0["collectives"]["plain"] == {"bn_stats": 3, "bn_backward": 3, "gradients": 1}


# ------------------------------------------------------ one Mean-Teacher step


def test_one_mt_step_on_two_ranks_matches_one_process(results):
    r0, r1 = results
    batch, _ = drv.step_batch(WORLD)
    sizes = [b * WORLD for b in drv.STEP_SIZES]
    single = drv.mt_step(batch, sizes=sizes)
    for k, v in single["metrics"].items():
        assert abs(r0["step"]["metrics"][k] - v) <= 1e-5, (k, r0["step"]["metrics"][k], v)
        assert r0["step"]["metrics"][k] == r1["step"]["metrics"][k], k
    for name, want in single["params"].items():
        np.testing.assert_allclose(r0["step"]["params"][name], want, rtol=1e-3, atol=5e-4, err_msg=name)
        np.testing.assert_array_equal(r0["step"]["params"][name], r1["step"]["params"][name], err_msg=name)
    for model in ("student_bn", "teacher_bn"):
        for name, want in single[model].items():
            np.testing.assert_allclose(r0["step"][model][name], want, rtol=0, atol=1e-5, err_msg=f"{model} {name}")
            np.testing.assert_array_equal(r0["step"][model][name], r1["step"][model][name])


def test_the_step_issues_its_collectives(results):
    """Per step: the BatchNorm sums of both models' three blocks, the S1 /
    S2 of the student's three backward passes and one flat gradient
    reduction (beside them: the state broadcast once, and the metrics)."""
    got = results[0]["step_collectives"]
    assert (got["bn_stats"], got["bn_backward"], got["gradients"]) == (6, 3, 1)
    assert got["metrics"] == 1


def test_world_size_one_is_bit_equal_to_no_group(results):
    w = results[0]["world1"]
    assert w["world_size"] == 1
    assert w["group"]["metrics"] == w["none"]["metrics"]
    for part in ("params", "student_bn", "teacher_bn"):
        for name, want in w["none"][part].items():
            np.testing.assert_array_equal(w["group"][part][name], want, err_msg=f"{part} {name}")
    for name, want in w["grads_none"].items():
        np.testing.assert_array_equal(w["grads_group"][name], want, err_msg=name)
