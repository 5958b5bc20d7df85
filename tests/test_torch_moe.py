"""Port parity: tpu_dra_torch.workloads.moe (routing, the MoE FFN, the
expert-parallel FFN) and moe_model (the MoE LM and its DP x TP step,
experts on the 'model' axis) against the reference's modules on its
8-device CPU mesh.

The port's collective paths run on four spawned gloo ranks (one
RankPool for the module); the reference's on four of its CPU devices.
Weights are the reference's (params_from_jax, the moe sub-tree
included), inputs numpy-seeded. Routing must agree exactly: argmax takes
the first maximum on both sides and the capacity cut-off follows the
(b, s) order, under DP too (the port's ranks continue the positions from
the lower data ranks' counts).

Tolerances (fp32): routing tensors exact; outputs and the aux loss
within 1e-5 relative (max |diff| / max |ref|); the LM step's loss within
1e-5 relative and each leaf's update within 1e-4 of its own max plus
1e-6 of the leaf's max |value| (the fp32 cancellation in new - old).
"""

import numpy as np
import pytest
import torch

from tpu_dra_torch.workloads import _dist
from tpu_dra_torch.workloads import model as tm
from tpu_dra_torch.workloads import moe as tmoe
from tpu_dra_torch.workloads import moe_model as tmm

torch.set_num_threads(2)

WORLD = 4
D_MODEL, D_FF = 16, 32
LM = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=16,
          n_experts=4)
BATCH = 4
LR = 0.1
TOL = 1e-5


@pytest.fixture(scope="module")
def pool():
    with _dist.RankPool([torch.device("cpu")] * WORLD, timeout_s=120) as p:
        yield p


def _cpus(shape):
    cpus = np.empty(WORLD, dtype=object)
    cpus[:] = [torch.device("cpu")] * WORLD
    return cpus.reshape(shape)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _ref_moe(n_experts, seed=1):
    import jax
    import jax.numpy as jnp

    from tpu_dra.workloads import moe as jmoe

    params = jmoe.init_moe_params(jax.random.PRNGKey(seed), D_MODEL, D_FF,
                                  n_experts, dtype=jnp.float32)
    x = np.random.RandomState(seed + 2).standard_normal(
        (2, 16, D_MODEL)).astype(np.float32)
    return jax.tree.map(np.array, params), x


def _port(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _dense_masks(route, n_experts, capacity):
    """The slot form (slot, gate) as the reference's dense dispatch and
    combine [B,S,E,C]: 1 (or the gate) at (b, s, e, c) iff the token holds
    slot e·C + c."""
    slot = route.slot.long()
    dispatch = torch.zeros(*slot.shape, n_experts * capacity + 1)
    dispatch.scatter_(-1, torch.where(slot < 0, n_experts * capacity,
                                      slot)[..., None], 1.0)
    dispatch = dispatch[..., :-1].reshape(*slot.shape, n_experts, capacity)
    return dispatch, dispatch * route.gate[..., None, None]


@pytest.mark.parametrize("factor", [1.25, 0.5], ids=["cap1.25", "cap0.5"])
def test_route_top1_matches_reference(factor):
    """Dispatch and combine exact, aux within TOL; at capacity factor 0.5
    overflow is dropped in (b, s) order."""
    import jax.numpy as jnp

    from tpu_dra.workloads import moe as jmoe

    tree, x = _ref_moe(4)
    cap = max(1, int(factor * 2 * 16 / 4))
    want = jmoe.route_top1(jnp.asarray(x), jnp.asarray(tree["router"]), 4,
                           cap)
    route = tmoe.route_top1(torch.from_numpy(x),
                            torch.from_numpy(tree["router"]), 4, cap)
    got = (*_dense_masks(route, 4, cap), route.aux)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert _rel(got[1].numpy(), want[1]) <= TOL
    assert _rel(got[2].numpy(), want[2]) <= TOL
    if factor < 1:
        assert got[0].sum() < 2 * 16   # some tokens dropped
    # Each slot holds the token that holds it.
    tos = route.token_of_slot.long()
    filled = tos >= 0
    assert int(filled.sum()) == int((route.slot >= 0).sum())
    assert torch.equal(route.slot.reshape(-1)[tos[filled]].long(),
                       torch.arange(4 * cap)[filled])


def _dense_moe_ffn(params, x, capacity_factor, compute_dtype):
    """The MoE FFN as the reference writes it: dense one-hot [B,S,E,C]
    dispatch and combine masks and their einsums."""
    import torch.nn.functional as F

    n_experts = params["router"].shape[-1]
    b, s, _ = x.shape
    capacity = tmoe.capacity_of(capacity_factor, b * s, n_experts)
    probs = torch.softmax(x.float() @ params["router"].float(), dim=-1)
    onehot = F.one_hot(probs.argmax(-1), n_experts).float()
    flat = onehot.reshape(-1, n_experts)
    pos = (torch.cumsum(flat, dim=0) * flat - 1.0).reshape(onehot.shape)
    keep = (pos >= 0) & (pos < capacity)
    dispatch = (F.one_hot(pos.clamp(0, capacity - 1).long(), capacity)
                .float() * (onehot * keep)[..., None])
    combine = dispatch * (probs * onehot).amax(-1)[..., None, None]
    density = flat.sum(0) / flat.shape[0]
    density_proxy = probs.sum((0, 1)) / flat.shape[0]
    aux = (density * density_proxy).sum() * n_experts ** 2
    cd = compute_dtype
    buffers = torch.einsum("bsec,bsd->ecd", dispatch.to(cd), x.to(cd))
    h = F.gelu(torch.einsum("ecd,edf->ecf", buffers, params["w_up"].to(cd)),
               approximate="tanh")
    out_buf = torch.einsum("ecf,efd->ecd", h, params["w_down"].to(cd))
    out = torch.einsum("bsec,ecd->bsd", combine.to(cd), out_buf)
    return out.to(x.dtype), aux


# The dense form rounds the gate's gradient through a [B,S,E,C] GEMM
# output in the compute dtype; the slot form keeps it in fp32. In bf16
# that is up to 2^-9 of each token's gate gradient, so x's and the
# router's gradients agree to two bf16 units (2^-7); everything else
# agrees exactly.
GRAD_TOL = {torch.float32: TOL, torch.bfloat16: 2.0 ** -7}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("factor", [1.25, 0.5], ids=["cap1.25", "cap0.5"])
def test_slot_form_matches_the_dense_masks(factor, dtype):
    """moe_ffn by slot index against the dense one-hot formula: the
    forward and the aux bit for bit, w_up's and w_down's gradients bit
    for bit, x's and the router's within GRAD_TOL."""
    tree, x = _ref_moe(4)
    results = []
    for fn in (tmoe.moe_ffn, _dense_moe_ffn):
        params = {k: v.clone().requires_grad_()
                  for k, v in _port(tree).items()}
        xt = torch.from_numpy(x).requires_grad_()
        out, aux = fn(params, xt, capacity_factor=factor,
                      compute_dtype=dtype)
        grads = torch.autograd.grad(out.square().sum() + aux,
                                    [xt, params["router"], params["w_up"],
                                     params["w_down"]])
        results.append((out.detach(), aux.detach(), grads))
    (out, aux, grads), (want_out, want_aux, want_grads) = results
    assert torch.equal(out, want_out)
    assert torch.equal(aux, want_aux)
    dx, drouter, dw_up, dw_down = grads
    assert torch.equal(dw_up, want_grads[2])
    assert torch.equal(dw_down, want_grads[3])
    assert _rel(dx.numpy(), want_grads[0].numpy()) <= GRAD_TOL[dtype]
    assert _rel(drouter.numpy(), want_grads[1].numpy()) <= GRAD_TOL[dtype]


def _plain_slot_ffn(params, x, capacity_factor, compute_dtype):
    """moe_ffn's top-1 slot form in plain autograd: route_top1's slots,
    the dispatch an index into x's rows with a zero row after them, the
    combine each token's slot row times its gate in fp32, rounded once.
    The gate scales rounded to the rows' dtype (the forward's value), and
    its gradient, the fp32 dot of dout and the row, reaches the fp32 gate
    unrounded (a term that is zero in the forward)."""
    import torch.nn.functional as F

    cd = compute_dtype
    n_experts = params["router"].shape[-1]
    b, s, d = x.shape
    capacity = tmoe.capacity_of(capacity_factor, b * s, n_experts)
    route = tmoe.route_top1(x, params["router"], n_experts, capacity)

    def rows_at(rows, idx):
        idx = idx.reshape(-1).long()
        padded = torch.cat([rows, rows.new_zeros(1, d)])
        return padded[torch.where(idx < 0, rows.shape[0], idx)]

    buffers = rows_at(x.to(cd).reshape(b * s, d), route.token_of_slot)
    h = F.gelu(torch.einsum("ecd,edf->ecf", buffers.view(n_experts, -1, d),
                            params["w_up"].to(cd)), approximate="tanh")
    out_buf = torch.einsum("ecf,efd->ecd", h, params["w_down"].to(cd))
    picked = rows_at(out_buf.reshape(-1, d), route.slot).float()
    gate = route.gate.reshape(-1, 1)
    rounded = gate.detach().to(cd).float()
    out = picked * rounded + (gate - gate.detach()) * picked
    return out.to(cd).view(b, s, d).to(x.dtype), route.aux


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("factor", [1.25, 0.5], ids=["cap1.25", "cap0.5"])
def test_moe_ffn_is_the_plain_slot_form_bit_for_bit(factor, dtype):
    """moe_ffn (the k-way dispatch and combine at k = 1) against the
    top-1 slot form in plain autograd: the output, the aux and the
    gradients of x, the router, w_up and w_down, bit for bit."""
    tree, x = _ref_moe(4)
    results = []
    for fn in (tmoe.moe_ffn, _plain_slot_ffn):
        params = {k: v.clone().requires_grad_()
                  for k, v in _port(tree).items()}
        xt = torch.from_numpy(x).requires_grad_()
        out, aux = fn(params, xt, capacity_factor=factor,
                      compute_dtype=dtype)
        grads = torch.autograd.grad(out.square().sum() + aux,
                                    [xt, params["router"], params["w_up"],
                                     params["w_down"]])
        results.append((out.detach(), aux.detach(), *grads))
    for name, got, want in zip(("out", "aux", "dx", "drouter", "dw_up",
                                "dw_down"), *results):
        assert got.dtype == want.dtype and torch.equal(got, want), name


def test_moe_ffn_matches_reference():
    import jax.numpy as jnp

    from tpu_dra.workloads import moe as jmoe

    tree, x = _ref_moe(4)
    want_out, want_aux = jmoe.moe_ffn(
        {k: jnp.asarray(v) for k, v in tree.items()}, jnp.asarray(x))
    out, aux = tmoe.moe_ffn(_port(tree), torch.from_numpy(x))
    assert _rel(out.numpy(), want_out) <= TOL
    assert _rel(aux.numpy(), want_aux) <= TOL


def _ep_task(tree, x, grads=False):
    mesh = _dist.Mesh(_cpus(WORLD), ("expert",))
    params = tmoe.shard_moe_params(_port(tree), mesh)
    xt = torch.from_numpy(x)
    if grads:
        params = {k: v.clone().requires_grad_() for k, v in params.items()}
        xt.requires_grad_()
    out, aux = tmoe.make_expert_parallel_ffn(mesh)(params, xt)
    res = {"out": out.detach().numpy(), "aux": float(aux)}
    if grads:
        g = torch.autograd.grad(out.square().sum() + aux,
                                [params["router"], params["w_up"],
                                 params["w_down"], xt])
        res["grads"] = [t.numpy() for t in g]
    return res


@pytest.mark.parametrize("n_experts", [4, 8], ids=["1-per-rank",
                                                   "2-per-rank"])
def test_expert_parallel_ffn_matches_reference(pool, n_experts):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from tpu_dra.workloads import moe as jmoe

    tree, x = _ref_moe(n_experts)
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("expert",))
    want_out, want_aux = jmoe.make_expert_parallel_ffn(mesh)(
        jmoe.shard_moe_params({k: jnp.asarray(v) for k, v in tree.items()},
                              mesh), jnp.asarray(x))
    for res in pool.run(_ep_task, tree, x):
        assert _rel(res["out"], want_out) <= TOL
        assert abs(res["aux"] - float(want_aux)) <= TOL * float(want_aux)


def test_expert_parallel_gradients_are_the_unsharded_ones(pool):
    """The EP FFN's gradients (router and x replicated on every rank;
    each rank's experts) against moe_ffn's on one device."""
    tree, x = _ref_moe(8)
    results = pool.run(_ep_task, tree, x, True)
    params = {k: v.clone().requires_grad_() for k, v in _port(tree).items()}
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = tmoe.moe_ffn(params, xt)
    want = torch.autograd.grad(out.square().sum() + aux,
                               [params["router"], params["w_up"],
                                params["w_down"], xt])
    router, w_up, w_down, dx = (t.numpy() for t in want)
    for res in results:
        assert _rel(res["grads"][0], router) <= TOL
        assert _rel(res["grads"][3], dx) <= TOL
    assert _rel(np.concatenate([r["grads"][1] for r in results]),
                w_up) <= TOL
    assert _rel(np.concatenate([r["grads"][2] for r in results]),
                w_down) <= TOL


def _lm_task(grid, tree, tokens):
    mesh = _dist.Mesh(_cpus(grid), ("data", "model"))
    cfg = tmm.MoEModelConfig(**LM, dtype=torch.float32)
    model = tmm.MoETransformerLM(cfg, tmm.shard_params(
        tm.params_from_jax(tree, cfg, "cpu"), mesh, cfg), mesh)
    loss = float(tmm.make_train_step(model, lr=LR)(torch.from_numpy(tokens)))
    return mesh.coords, loss, tm.local_params(model)


def _ref_lm_step(grid, seed=5):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from tpu_dra.workloads import moe_model as jmm

    cfg = jmm.MoEModelConfig(**LM, dtype=jnp.float32)
    params = jmm.init_params(jax.random.PRNGKey(seed), cfg)
    old = jax.tree.map(np.asarray, params)
    tokens = np.random.RandomState(seed).randint(0, LM["vocab"],
                                                 (BATCH, LM["max_seq"]))
    mesh = Mesh(np.array(jax.devices()[:WORLD]).reshape(grid),
                ("data", "model"))
    step = jmm.make_train_step(jmm.MoETransformerLM(cfg), mesh, lr=LR)
    new, loss = step(jmm.shard_params(params, mesh, cfg), jnp.asarray(tokens))
    return old, tokens, jax.tree.map(np.asarray, new), float(loss)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in (tree.items() if isinstance(tree, dict)
                 else enumerate(tree)):
        if isinstance(v, (dict, list)):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


@pytest.mark.parametrize("grid", [(2, 2), (1, 4)], ids=["dp2xep2", "ep4"])
def test_moe_lm_step_matches_reference(pool, grid):
    """The MoE LM's step (LM loss + 1e-2 x router aux) on the DP x TP
    mesh, experts on 'model' and routing global over 'data'."""
    old, tokens, new, loss = _ref_lm_step(grid)
    results = pool.run(_lm_task, grid, old, tokens)
    for _, got_loss, _ in results:
        assert abs(got_loss - loss) <= 1e-5 * loss
    column = sorted((r for r in results if r[0]["data"] == 0),
                    key=lambda r: r[0]["model"])
    cfg = tmm.MoEModelConfig(**LM)
    got = _leaves(tmm.unshard_params([r[2] for r in column], cfg))
    olds = _leaves(old)
    for name, w in _leaves(new).items():
        o = olds[name]
        scale = np.abs(w - o).max()
        assert scale > 0, f"{name} not updated by the reference"
        err = np.abs((got[name] - o) - (w - o)).max()
        assert err <= 1e-4 * scale + 1e-6 * np.abs(o).max(), \
            f"{name}: update err {err} vs scale {scale}"


def test_moe_blocks_alternate_and_the_aux_joins_the_loss():
    """Block 1 of 2 is the MoE block (moe_every 2); the loss is the LM
    nll plus router_aux_weight x the blocks' aux."""
    cfg = tmm.MoEModelConfig(**LM, dtype=torch.float32)
    params = tmm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert "moe" in params["blocks"][1] and "w_up" in params["blocks"][0]
    model = tmm.MoETransformerLM(cfg, params)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, LM["vocab"], (2, LM["max_seq"])))
    logits, aux = model(tokens[:, :-1])
    nll = tm.token_nll(model, logits, tokens[:, 1:]).mean()
    loss = tmm.loss_fn(model, tokens)
    torch.testing.assert_close(loss, nll + cfg.router_aux_weight * aux)
    assert float(aux.detach()) > 0
    names = dict(model.named_parameters())
    assert names["blocks.1.moe.w_up"].shape == (4, 32, 64)


def test_params_from_jax_carries_the_moe_subtree():
    import jax

    from tpu_dra.workloads import moe_model as jmm

    cfg_j = jmm.MoEModelConfig(**LM)
    tree = jax.tree.map(np.asarray, jmm.init_params(jax.random.PRNGKey(1),
                                                    cfg_j))
    cfg = tmm.MoEModelConfig(**LM, dtype=torch.float32)
    got = tm.params_from_jax(tree, cfg, "cpu")
    for name, leaf in _leaves(tree).items():
        np.testing.assert_array_equal(_leaves(got)[name], leaf)
