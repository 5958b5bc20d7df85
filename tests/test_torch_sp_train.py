"""Port parity: tpu_dra_torch.workloads.sp_train (the sequence-parallel
train step, Ulysses attention inside the forward) against the
reference's make_sp_train_step on its 8-device CPU mesh.

The port runs on four spawned gloo ranks (one RankPool for the module),
each with the full (replicated) weights and its sequence block of the
tokens; the reference's jitted step runs over four of its CPU devices.
Both start from the reference's weights (params_from_jax).

Tolerances (fp32): the loss within 1e-5 relative; each leaf's SGD update
within 1e-4 of the update's own max plus 1e-6 of the leaf's max |value|
(the fp32 cancellation in new - old), as the DP x TP test: the same
gradient, reduced in a different order (per-shard sums all-reduced over
the axis here, the shard_map transpose there).
"""

import numpy as np
import pytest
import torch

from tpu_dra_torch.workloads import _dist
from tpu_dra_torch.workloads import model as tm
from tpu_dra_torch.workloads import sp_train as ts

torch.set_num_threads(2)

WORLD = 4
CFG = dict(vocab=64, d_model=WORLD * 4, n_heads=WORLD, n_layers=2, d_ff=64,
           max_seq=WORLD * 8)
LR = 0.1


@pytest.fixture(scope="module")
def pool():
    with _dist.RankPool([torch.device("cpu")] * WORLD, timeout_s=120) as p:
        yield p


def _task(tree, tokens, steps, impl):
    cpus = np.empty(WORLD, dtype=object)
    cpus[:] = [torch.device("cpu")] * WORLD
    mesh = _dist.Mesh(cpus, ("seq",))
    cfg = tm.ModelConfig(**CFG, dtype=torch.float32, attn_impl=impl)
    model = tm.TransformerLM(cfg, tm.params_from_jax(tree, cfg, "cpu"))
    step = ts.make_sp_train_step(model, mesh, lr=LR)
    losses = [float(step(torch.from_numpy(tokens))) for _ in range(steps)]
    # `model` shares the trained parameters.
    return losses, tm.local_params(model)


def _reference(seed, steps):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from tpu_dra.workloads import model as jm
    from tpu_dra.workloads.sp_train import make_sp_train_step

    cfg = jm.ModelConfig(**CFG, dtype=jnp.float32)
    params = jm.init_params(jax.random.PRNGKey(seed), cfg)
    old = jax.tree.map(np.asarray, params)
    tokens = np.random.RandomState(seed + 1).randint(
        0, CFG["vocab"], (2, CFG["max_seq"]))
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("seq",))
    step = make_sp_train_step(jm.TransformerLM(cfg), mesh, lr=LR)
    losses = []
    for _ in range(steps):
        params, loss = step(params, jnp.asarray(tokens))
        losses.append(float(loss))
    return old, tokens, jax.tree.map(np.asarray, params), losses


def _named(tree):
    out = {"embed": tree["embed"], "unembed": tree["unembed"]}
    for i, bp in enumerate(tree["blocks"]):
        for name, leaf in bp.items():
            out[f"blocks.{i}.{name}"] = np.asarray(leaf, np.float32)
    return out


@pytest.mark.parametrize("impl", ["flash", "reference"])
def test_sp_step_matches_reference(pool, impl):
    old, tokens, new, want = _reference(seed=0, steps=1)
    results = pool.run(_task, old, tokens, 1, impl)
    for losses, _ in results:
        assert abs(losses[0] - want[0]) <= 1e-5 * want[0]
    got = _named(results[0][1])
    for name, w in _named(new).items():
        o = _named(old)[name]
        scale = np.abs(w - o).max()
        assert scale > 0, name
        err = np.abs((got[name] - o) - (w - o)).max()
        assert err <= 1e-4 * scale + 1e-6 * np.abs(o).max(), \
            f"{name}: update err {err} vs scale {scale}"


def test_every_rank_holds_the_same_weights(pool):
    """Replicated parameters stay replicated: the all-reduced gradients
    update every rank alike."""
    old, tokens, _, _ = _reference(seed=2, steps=1)
    results = pool.run(_task, old, tokens, 2, "flash")
    first = _named(results[0][1])
    for _, params in results[1:]:
        for name, leaf in _named(params).items():
            np.testing.assert_array_equal(leaf, first[name], err_msg=name)


def test_losses_over_steps_match_reference(pool):
    old, tokens, _, want = _reference(seed=4, steps=3)
    losses, _ = pool.run(_task, old, tokens, 3, "flash")[0]
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    assert losses[-1] < losses[0]
