"""Port parity: tpu_dra_torch.workloads.ulysses (all-to-all sequence
parallelism) against the reference's make_ulysses_attention on its
8-device CPU mesh.

The port runs on two spawned gloo ranks (one RankPool for the module),
each with its sequence block; outputs and the gradients of
sum(out * dout) with respect to its blocks are concatenated in rank
order. The reference's jitted body runs over two of its CPU devices with
plain attention ("reference"); the port's with the kernels' plain
versions ("flash") and with plain attention. RoPE runs at global
positions on both.

Tolerance: fp32, max |diff| / max |ref| <= 1e-5 (the same attention per
head, summed in different orders).
"""

import numpy as np
import pytest
import torch

from tpu_dra_torch.workloads import _dist
from tpu_dra_torch.workloads import ulysses as tu

torch.set_num_threads(2)

WORLD = 2
TOL = 1e-5


@pytest.fixture(scope="module")
def pool():
    with _dist.RankPool([torch.device("cpu")] * WORLD, timeout_s=120) as p:
        yield p


def _inputs(heads, seed=0, s_local=32, d=16):
    shape = (2, WORLD * s_local, heads, d)
    return [np.random.RandomState(seed + i).standard_normal(shape)
            .astype(np.float32) for i in range(4)]


def _task(arrays, causal, rope, impl):
    cpus = np.empty(WORLD, dtype=object)
    cpus[:] = [torch.device("cpu")] * WORLD
    mesh = _dist.Mesh(cpus, ("seq",))
    q, k, v, dout = (_dist.shard(torch.from_numpy(a), mesh, "seq", 1)
                     for a in arrays)
    q, k, v = (x.clone().requires_grad_() for x in (q, k, v))
    fn = tu.make_ulysses_attention(mesh, axis_name="seq", causal=causal,
                                   impl=impl, rope=rope)
    out = fn(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    return [x.detach().numpy() for x in (out, *grads)]


def _reference(arrays, causal, rope):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from tpu_dra.workloads import ulysses as ju

    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("seq",))
    fn = ju.make_ulysses_attention(mesh, axis_name="seq", causal=causal,
                                   impl="reference", rope=rope)
    q, k, v, dout = (jnp.asarray(a) for a in arrays)
    out, vjp = jax.vjp(fn, q, k, v)
    return [np.asarray(x) for x in (out, *vjp(dout))]


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("impl", ["flash", "reference"])
@pytest.mark.parametrize("rope", [True, False], ids=["rope", "norope"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ulysses_matches_reference(pool, causal, rope, impl):
    arrays = _inputs(heads=4)
    results = pool.run(_task, arrays, causal, rope, impl)
    got = [np.concatenate([r[i] for r in results], axis=1) for i in range(4)]
    for name, g, w in zip(("out", "dq", "dk", "dv"), got,
                          _reference(arrays, causal, rope)):
        assert _rel(g, w) <= TOL, f"{name}: {_rel(g, w)}"


def test_one_head_per_rank(pool):
    arrays = _inputs(heads=WORLD, seed=5)
    results = pool.run(_task, arrays, True, True, "flash")
    got = np.concatenate([r[0] for r in results], axis=1)
    assert _rel(got, _reference(arrays, True, True)[0]) <= TOL


def _indivisible_task():
    cpus = np.empty(WORLD, dtype=object)
    cpus[:] = [torch.device("cpu")] * WORLD
    mesh = _dist.Mesh(cpus, ("seq",))
    q = torch.zeros(1, 8, 3, 16)
    try:
        tu.make_ulysses_attention(mesh)(q, q, q)
    except ValueError as e:
        return str(e)
    return None


def test_indivisible_heads_refused(pool):
    """H % N != 0 raises on every rank before any all-to-all."""
    errors = pool.run(_indivisible_task)
    assert all(e and "heads % axis_size" in e for e in errors), errors


def test_one_rank_is_plain_attention():
    """Over a group of one the all-to-alls are the identity: ulysses is
    attend itself."""
    from tpu_dra_torch.workloads.flashattention import attend

    q, k, v = (torch.from_numpy(a) for a in _inputs(heads=2)[:3])
    torch.testing.assert_close(
        tu.ulysses_attention(q, k, v, group=None, rope=True),
        attend(q, k, v, causal=True, rope=True))
