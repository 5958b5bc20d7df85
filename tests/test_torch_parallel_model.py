"""Port parity: the DP x TP train step of tpu_dra_torch.workloads.model
(param_specs, shard_params, build_train_step) and its remat policies,
against the reference's jitted step on its 8-device CPU mesh.

The port runs on four spawned gloo ranks (one RankPool for the module);
the reference lays the same (data, model) grid over four of its CPU
devices. Both start from the reference's weights (params_from_jax) and
the same numpy tokens; the port's shards are gathered back
(unshard_params, which undoes wqkv's per-head regrouping).

Tolerances:
- fp32: the loss within 1e-5 relative; each leaf's SGD update
  (new - old) within 1e-4 of the update's own max plus 1e-6 of the
  leaf's max |value| (the fp32 cancellation in new - old). The two sides
  sum the same function in different orders, in different process
  layouts; measured, every fp32 update is within the cancellation term
  alone, and the loss within 1e-7.
- bf16: the loss within 1e-2 relative and the updates within 5e-2, the
  reference's own bf16 bounds (tests/test_flashattention.py, the
  rmsnorm-scale leaves); measured worst 2.1e-2 of an update.
- remat "dots"/"full" against "none" on the same grid: 1e-6 relative
  (recomputation repeats the same operations).
"""

import numpy as np
import pytest
import torch

from tpu_dra_torch.workloads import _dist
from tpu_dra_torch.workloads import model as tm

torch.set_num_threads(2)

WORLD = 4
SMALL = dict(vocab=128, d_model=64, n_heads=4, n_layers=2, d_ff=128,
             max_seq=32)
BATCH = 4
LR = 0.1
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def pool():
    with _dist.RankPool([torch.device("cpu")] * WORLD, timeout_s=120) as p:
        yield p


def _grid_mesh(grid):
    cpus = np.empty(WORLD, dtype=object)
    cpus[:] = [torch.device("cpu")] * WORLD
    return _dist.Mesh(cpus.reshape(grid), ("data", "model"))


def _train_task(grid, tree, tokens, dtype, remat="none", steps=1):
    """One rank: the DP x TP model on its shard, `steps` SGD steps on the
    global batch; returns its coordinates, the losses, its shards."""
    mesh = _grid_mesh(grid)
    cfg = tm.ModelConfig(**SMALL, dtype=DTYPES[dtype], remat=remat)
    model = tm.TransformerLM(cfg, tm.shard_params(
        tm.params_from_jax(tree, cfg, "cpu"), mesh, cfg), mesh)
    step = tm.build_train_step(model, lr=LR)
    losses = [float(step(torch.from_numpy(tokens))) for _ in range(steps)]
    return {"coords": mesh.coords, "losses": losses,
            "params": tm.local_params(model)}


def _gathered(results, cfg):
    """The full tree from the data-rank-0 column, in 'model' order."""
    column = sorted((r for r in results if r["coords"]["data"] == 0),
                    key=lambda r: r["coords"]["model"])
    return tm.unshard_params([r["params"] for r in column], cfg)


def _named(tree):
    out = {"embed": tree["embed"], "unembed": tree["unembed"]}
    for i, bp in enumerate(tree["blocks"]):
        for name, leaf in bp.items():
            out[f"blocks.{i}.{name}"] = np.asarray(leaf, np.float32)
    return out


def _reference_step(grid, dtype, seed=0):
    """(old tree, tokens, new tree, loss) of the reference's jitted step on
    a `grid` (data, model) mesh of its CPU devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from tpu_dra.workloads import model as jm

    jdtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    cfg = jm.ModelConfig(**SMALL, dtype=jdtype)
    params = jm.init_params(jax.random.PRNGKey(seed), cfg)
    old = jax.tree.map(np.asarray, params)
    tokens = np.random.RandomState(seed + 1).randint(
        0, SMALL["vocab"], (BATCH, SMALL["max_seq"]))
    mesh = Mesh(np.array(jax.devices()[:WORLD]).reshape(grid),
                ("data", "model"))
    step = jm.make_train_step(jm.TransformerLM(cfg), mesh, lr=LR)
    new, loss = step(jm.shard_params(params, mesh, cfg), jnp.asarray(tokens))
    return old, tokens, jax.tree.map(np.asarray, new), float(loss)


def _check_update(got, want, old, tol):
    for name, w in _named(want).items():
        o = _named(old)[name]
        d_want, d_got = w - o, _named(got)[name] - o
        scale = np.abs(d_want).max()
        assert scale > 0, f"{name} not updated by the reference"
        err = np.abs(d_got - d_want).max()
        assert err <= tol * scale + 1e-6 * np.abs(o).max(), \
            f"{name}: update err {err} vs scale {scale}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grid", [(2, 2), (1, 4), (4, 1)],
                         ids=["dp2xtp2", "tp4", "dp4"])
def test_dp_tp_step_matches_reference(pool, grid, dtype):
    old, tokens, new, loss = _reference_step(grid, dtype)
    results = pool.run(_train_task, grid, old, tokens, dtype)
    cfg = tm.ModelConfig(**SMALL)
    # Every rank holds its own place and the same (global) loss.
    assert sorted((r["coords"]["data"], r["coords"]["model"])
                  for r in results) == sorted(np.ndindex(*grid))
    assert len({r["losses"][0] for r in results}) == 1
    loss_tol, upd_tol = (1e-5, 1e-4) if dtype == "float32" else (1e-2, 5e-2)
    assert abs(results[0]["losses"][0] - loss) <= loss_tol * loss
    _check_update(_gathered(results, cfg), new, old, upd_tol)


def test_model_ranks_hold_their_own_heads(pool):
    """Under TP each 'model' rank holds a quarter of every sharded leaf;
    the data ranks of one column hold the same shards."""
    old, tokens, _, _ = _reference_step((2, 2), "float32")
    results = pool.run(_train_task, (2, 2), old, tokens, "float32")
    by = {(r["coords"]["data"], r["coords"]["model"]): r["params"]
          for r in results}
    for data in (0, 1):
        blk = by[(data, 0)]["blocks"][0]
        assert blk["wqkv"].shape == (64, 96)
        assert blk["wo"].shape == (32, 64)
        assert by[(data, 0)]["embed"].shape == (64, 64)
        assert by[(data, 1)]["unembed"].shape == (64, 64)
    np.testing.assert_array_equal(by[(0, 1)]["blocks"][1]["w_up"],
                                  by[(1, 1)]["blocks"][1]["w_up"])
    assert not np.array_equal(by[(0, 0)]["blocks"][1]["w_up"],
                              by[(0, 1)]["blocks"][1]["w_up"])


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_matches_none_on_the_mesh(pool, remat):
    old, tokens, _, _ = _reference_step((2, 2), "float32", seed=3)
    runs = {policy: pool.run(_train_task, (2, 2), old, tokens, "float32",
                             policy, 2)
            for policy in ("none", remat)}
    cfg = tm.ModelConfig(**SMALL)
    np.testing.assert_allclose(runs[remat][0]["losses"],
                               runs["none"][0]["losses"], rtol=1e-6)
    got, want = (_named(_gathered(runs[p], cfg)) for p in (remat, "none"))
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=1e-6,
                                   atol=1e-6 * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_shard_then_unshard_is_the_identity(tp):
    """shard_params on each 'model' index, unshard_params back: every
    leaf as it was (no group needed: a mesh stand-in with the index)."""
    cfg = tm.ModelConfig(**SMALL, dtype=torch.float32)
    full = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")

    class At:
        def __init__(self, i):
            self.i = i

        def group(self, axis):
            return None

        def size(self, axis):
            return tp if axis == "model" else 1

        def index(self, axis):
            return self.i if axis == "model" else 0

    shards = [tm.tree_map(lambda x: x.numpy(),
                          tm.shard_params(full, At(i), cfg))
              for i in range(tp)]
    back = _named(tm.unshard_params(shards, cfg))
    for name, leaf in _named(tm.tree_map(lambda x: x.numpy(), full)).items():
        np.testing.assert_array_equal(back[name], leaf, err_msg=name)


def test_wqkv_regroup_gives_each_rank_its_heads():
    """Block r of the regrouped [D, 3D] is (q, k, v) of heads
    [r*H/tp, (r+1)*H/tp): a contiguous column split would give rank 0 all
    of q and none of v."""
    d, heads, tp = 8, 4, 2
    dh = d // heads
    w = torch.arange(d * 3 * d, dtype=torch.float32).reshape(d, 3 * d)
    blocks = tm._qkv_regroup(w, tp).chunk(tp, dim=1)
    for r, blk in enumerate(blocks):
        cols = slice(r * heads // tp * dh, (r + 1) * heads // tp * dh)
        q, k, v = w[:, :d], w[:, d:2 * d], w[:, 2 * d:]
        torch.testing.assert_close(
            blk, torch.cat([q[:, cols], k[:, cols], v[:, cols]], dim=1))
    torch.testing.assert_close(
        tm._qkv_regroup(tm._qkv_regroup(w, tp), tp, inverse=True), w)


def _refuse_task(grid):
    mesh = _grid_mesh(grid)
    cfg = tm.ModelConfig(**SMALL, dtype=torch.float32)
    model = tm.TransformerLM(cfg, tm.shard_params(tm.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"), mesh, cfg), mesh)
    step = tm.build_train_step(model)
    try:
        step(torch.zeros((3, SMALL["max_seq"]), dtype=torch.long))
    except ValueError as e:
        return str(e)
    return None


def test_batch_the_data_axis_does_not_divide_is_refused(pool):
    """The ranks' mean losses average to the reference's global mean only
    over equal blocks: a batch of 3 over 2 data ranks raises on every
    rank, before any collective."""
    errors = pool.run(_refuse_task, (2, 2))
    assert all(e and "does not divide" in e for e in errors), errors


def test_heads_the_model_axis_does_not_divide_are_refused():
    cfg = tm.ModelConfig(**{**SMALL, "n_heads": 2})
    with pytest.raises(ValueError, match="n_heads"):
        tm._check_tp(cfg, 4)


def _logits_task(grid, tree, tokens):
    mesh = _grid_mesh(grid)
    cfg = tm.ModelConfig(**SMALL, dtype=torch.float32)
    model = tm.TransformerLM(cfg, tm.shard_params(
        tm.params_from_jax(tree, cfg, "cpu"), mesh, cfg), mesh)
    with torch.no_grad():
        logits = model(torch.from_numpy(tokens))
    return mesh.coords, logits.numpy()


def test_vocab_parallel_logits_are_the_full_logits(pool):
    """The 'model' ranks' logit shards, concatenated in 'model' order,
    are the single-device model's logits (fp32, 1e-5 relative)."""
    old, tokens, _, _ = _reference_step((1, 4), "float32")
    results = pool.run(_logits_task, (1, 4), old, tokens)
    got = np.concatenate([lg for _, lg in sorted(
        results, key=lambda r: r[0]["model"])], axis=-1)
    cfg = tm.ModelConfig(**SMALL, dtype=torch.float32)
    with torch.no_grad():
        want = tm.TransformerLM(cfg, tm.params_from_jax(old, cfg, "cpu"))(
            torch.from_numpy(tokens)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
