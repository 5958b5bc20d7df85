"""Port parity: tpu_dra_torch.workloads.pipeline (the GPipe schedule with
send/recv between neighbouring stages) against the reference's
make_pipeline_forward on its 8-device CPU mesh and against
pipeline_reference.

The port runs on four spawned gloo ranks (one RankPool for the module),
one stage each; the reference's jitted schedule on four of its CPU
devices. Weights are the reference's (init_stage_params), microbatches
numpy-seeded.

Tolerance: fp32, max |diff| / max |ref| <= 1e-5 (the same four gelu
matmul stages, summed in different orders).
"""

import numpy as np
import pytest
import torch

from tpu_dra_torch.workloads import _dist
from tpu_dra_torch.workloads import pipeline as tp

torch.set_num_threads(2)

WORLD = 4
D = 16
TOL = 1e-5


@pytest.fixture(scope="module")
def pool():
    with _dist.RankPool([torch.device("cpu")] * WORLD, timeout_s=120) as p:
        yield p


def _weights(seed=2):
    import jax

    from tpu_dra.workloads import pipeline as jp

    return np.array(jp.init_stage_params(jax.random.PRNGKey(seed), WORLD,
                                         D))


def _mbs(m, seed=4):
    return np.random.RandomState(seed).standard_normal((m, 2, D)).astype(
        np.float32)


def _task(weights, mbs):
    cpus = np.empty(WORLD, dtype=object)
    cpus[:] = [torch.device("cpu")] * WORLD
    mesh = _dist.Mesh(cpus, ("stage",))
    w = tp.shard_stage_params(torch.from_numpy(weights), mesh)
    return tp.make_pipeline_forward(mesh)(w, torch.from_numpy(mbs)).numpy()


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("m", [1, 6, 12])
def test_pipeline_matches_reference(pool, m):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from tpu_dra.workloads import pipeline as jp

    weights, mbs = _weights(), _mbs(m)
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("stage",))
    want = np.asarray(jp.make_pipeline_forward(mesh)(
        jp.shard_stage_params(jnp.asarray(weights), mesh), jnp.asarray(mbs)))
    results = pool.run(_task, weights, mbs)
    for got in results:   # broadcast from the last stage to every rank
        assert got.shape == mbs.shape
        assert _rel(got, want) <= TOL


def test_pipeline_matches_sequential_reference(pool):
    weights, mbs = _weights(seed=9), _mbs(6, seed=10)
    got = pool.run(_task, weights, mbs)[0]
    want = tp.pipeline_reference(torch.from_numpy(weights),
                                 torch.from_numpy(mbs)).numpy()
    assert _rel(got, want) <= TOL


def test_pipeline_reference_matches_the_jax_one():
    import jax.numpy as jnp

    from tpu_dra.workloads import pipeline as jp

    weights, mbs = _weights(), _mbs(3)
    want = np.asarray(jp.pipeline_reference(jnp.asarray(weights),
                                            jnp.asarray(mbs)))
    got = tp.pipeline_reference(torch.from_numpy(weights),
                                torch.from_numpy(mbs)).numpy()
    assert _rel(got, want) <= TOL


def test_one_stage_is_the_stage_function():
    """Over one rank there is no send or receive: the schedule is the
    stage applied to each microbatch."""
    w = torch.from_numpy(_weights()[:1])
    mbs = torch.from_numpy(_mbs(5))

    class One:
        def group(self, axis):
            return None

        def size(self, axis):
            return 1

        def index(self, axis):
            return 0

    got = tp.make_pipeline_forward(One())(w, mbs)
    torch.testing.assert_close(got, tp.stage_fn(w[0], mbs))
