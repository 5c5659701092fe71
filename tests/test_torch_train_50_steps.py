"""The north star's training bar at length: 50 Mean-Teacher steps of the
port against the JAX plain path, loss within 2e-4 at every step.

The geometry, the batches' recipe, the initial state and the tolerance are
those of tests/test_torch_train_step.py::test_20_steps_track_the_jax_plain_path
(its helpers, imported): float32 trajectories under Adam from zero moments,
the port running its fused block on the plain versions, the JAX side its
plain path. A file of its own so that a distributed run puts it on a worker
of its own.
"""

import numpy as np

from tests.test_torch_train_step import _cfg, _feature_batches, _run_both


def test_50_mt_steps_track_the_jax_plain_path():
    batches = _feature_batches(50, 8, teacher=True)
    jl, tl, _, _ = _run_both(_cfg(False), batches, True)
    assert np.isfinite(tl).all() and tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=0, atol=2e-4)
