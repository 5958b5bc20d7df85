"""Port parity: tpu_dra_torch.workloads.ringattention (the ring over a
process group, and the ring emulated in one process) against the
reference's make_ring_attention on its 8-device CPU mesh.

The port's ring runs on four spawned gloo ranks (one RankPool for the
module), each with its sequence block; its outputs and its gradients
of sum(out * dout) with respect to its blocks are concatenated in rank
order. The reference's jitted ring runs over four of its CPU devices
with the plain per-step partials ("jnp"); the port's with the flash
partials ("flash": the kernels' plain versions on the CPU) and with its
plain ones ("reference"). At world 4 a causal ring takes all three
cases: future, diagonal and past blocks.

Tolerance: fp32, max |diff| / max |ref| <= 3e-5 for the output and each
gradient: the same partials merged in the same order, summed
differently inside each partial (the flash partials' backward
recomputes the probabilities from the lse). Measured worst 1.01e-5, on
dq of the causal ring with the flash partials.
"""

import numpy as np
import pytest
import torch

from tpu_dra_torch.workloads import _dist
from tpu_dra_torch.workloads import ringattention as tr

torch.set_num_threads(2)

WORLD = 4
SHAPE = (1, WORLD * 128, 2, 16)   # s_local 128: the flash ring's least
TOL = 3e-5


@pytest.fixture(scope="module")
def pool():
    with _dist.RankPool([torch.device("cpu")] * WORLD, timeout_s=120) as p:
        yield p


def _inputs(seed=0, shape=SHAPE):
    return [np.random.RandomState(seed + i).standard_normal(shape)
            .astype(np.float32) for i in range(4)]   # q, k, v, dout


def _seq_mesh():
    cpus = np.empty(WORLD, dtype=object)
    cpus[:] = [torch.device("cpu")] * WORLD
    return _dist.Mesh(cpus, ("seq",))


def _ring_task(arrays, causal, impl):
    """This rank's blocks through the ring, forward and backward."""
    mesh = _seq_mesh()
    q, k, v, dout = (_dist.shard(torch.from_numpy(a), mesh, "seq", 1)
                     for a in arrays)
    q, k, v = (x.clone().requires_grad_() for x in (q, k, v))
    fn = tr.make_ring_attention(mesh, axis_name="seq", causal=causal,
                                impl=impl)
    out = fn(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    return [x.detach().numpy() for x in (out, *grads)]


def _gather(results):
    return [np.concatenate([r[i] for r in results], axis=1)
            for i in range(4)]


def _reference(arrays, causal):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from tpu_dra.workloads import ringattention as jr

    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("seq",))
    fn = jr.make_ring_attention(mesh, axis_name="seq", causal=causal,
                                impl="jnp")
    q, k, v, dout = (jnp.asarray(a) for a in arrays)
    out, vjp = jax.vjp(fn, q, k, v)
    return [np.asarray(x) for x in (out, *vjp(dout))]


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("impl", ["flash", "reference"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ring_matches_reference(pool, causal, impl):
    arrays = _inputs()
    got = _gather(pool.run(_ring_task, arrays, causal, impl))
    want = _reference(arrays, causal)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert g.shape == w.shape
        assert _rel(g, w) <= TOL, f"{name}: {_rel(g, w)}"


def test_ring_matches_unsharded_attention(pool):
    """The causal ring's output against plain attention over the whole
    sequence (the reference's reference_attention, ported)."""
    arrays = _inputs(seed=7)
    got = _gather(pool.run(_ring_task, arrays, True, "flash"))[0]
    q, k, v = (torch.from_numpy(a) for a in arrays[:3])
    want = tr.reference_attention(q, k, v, causal=True).numpy()
    assert _rel(got, want) <= TOL


def test_local_ring_matches_distributed_ring(pool):
    """ring_attention_local (ranks in turn in one process) computes what
    the four ranks compute, forward and backward."""
    arrays = _inputs(seed=3)
    dist_out = _gather(pool.run(_ring_task, arrays, True, "flash"))
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays[:3])
    cases = {}
    out = tr.ring_attention_local(q, k, v, WORLD, causal=True, impl="flash",
                                  partial_counts=cases)
    grads = torch.autograd.grad(out, (q, k, v), torch.from_numpy(arrays[3]))
    for g, w in zip((out, *grads), dist_out):
        assert _rel(g.detach().numpy(), w) <= TOL
    # 4 diagonal steps, 6 past, 6 future (which launch nothing).
    assert cases == {tr.DIAGONAL: 4, tr.PAST: 6, tr.FUTURE: 6}


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_local_ring_matches_one_flash_call(n, causal):
    """The emulated ring against one flash_attention_with_lse over the
    whole S (the comparison chip_smoke's ring_local makes on the card),
    forward and backward, rope off."""
    from tpu_dra_torch.workloads.flashattention import (
        flash_attention_with_lse,
    )

    arrays = _inputs(seed=11, shape=(1, 512, 2, 64))
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays[:3])
    dout = torch.from_numpy(arrays[3])
    ring = tr.ring_attention_local(q, k, v, n, causal=causal, impl="flash")
    full, _ = flash_attention_with_lse(q, k, v, causal=causal)
    for g, w in zip((ring, *torch.autograd.grad(ring, (q, k, v), dout)),
                    (full, *torch.autograd.grad(full, (q, k, v), dout))):
        assert _rel(g.detach().numpy(), w.detach().numpy()) <= TOL


def test_flash_ring_refuses_unaligned_blocks():
    """The reference's refusal: s_local % 128 == 0 and d >= 8."""
    q = torch.zeros(1, 64, 2, 16)
    with pytest.raises(ValueError, match="s_local % 128"):
        tr.ring_attention(q, q, q, group=None, impl="flash")
    with pytest.raises(ValueError, match="unknown ring attention impl"):
        tr.ring_attention(q, q, q, group=None, impl="pallas")


def test_auto_takes_plain_partials_on_the_cpu():
    assert not tr._use_flash("auto", torch.zeros(1, 128, 2, 16))
    assert tr._use_flash("flash", torch.zeros(1, 128, 2, 16))


def test_merge_is_nan_free_before_the_first_contribution():
    """(0, NEG_INF) is the merge's identity: merged with the start it
    stays NaN-free, and a real partial then wins outright."""
    acc_o = torch.zeros(1, 4, 1, 8)
    acc_lse = torch.full((1, 1, 4), tr.NEG_INF)
    o, lse = tr.merge(acc_o, acc_lse, torch.zeros_like(acc_o),
                      torch.full_like(acc_lse, tr.NEG_INF))
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    part = torch.randn(1, 4, 1, 8)
    o2, lse2 = tr.merge(o, lse, part, torch.zeros_like(lse))
    torch.testing.assert_close(o2, part)
    torch.testing.assert_close(lse2, torch.zeros_like(lse))


def test_step_cases_follow_the_block_order():
    assert [tr.step_case(1, kv, True) for kv in range(4)] == [
        tr.PAST, tr.DIAGONAL, tr.FUTURE, tr.FUTURE]
    assert {tr.step_case(1, kv, False) for kv in range(4)} == {tr.PAST}
