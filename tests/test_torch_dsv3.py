"""The DeepSeek-V3-family LM (tpu_dra_torch/workloads/dsv3_model.py: MLA,
the top-k dropless MoE over held experts, a shared expert) against the
benchmark's plain fp32 reference of the family
(portbench/reference/dsv3_lm.py, which imports nothing of the port), at
a small size of Moonlight-16B-A3B's shape: d 64, 4 heads, q.k 32 nope +
16 rope, v 32, kv rank 32, 16 routed experts of which 4 are held, top-3,
2 shared units, 1 dense + 2 MoE blocks. The size is written in the
configuration's own keys, and the port's config made from them as the
benchmark makes it (portbench/models/dsv3_lm.py: model_config).

Here, on the CPU: logits, loss and every parameter's gradient; routing
(selection by s + b, gates by s); droplessness under routing as uneven
as it gets; the share test (the four shares of four experts, summed, with
the shared expert once, equal the uncut reference layer); the plain
versions of the route, combine and pair-dot kernels against loops; what
the flash wrappers take at split head dims. On the card (marker
``card``): the (192, 128) Hopper kernels against their plain versions
(ragged S, B > 1), the three MoE kernels against theirs, and a train
step on the kernels.

    python -m pytest tests/test_torch_dsv3.py -q            # here
    python -m pytest tests/test_torch_dsv3.py -q -m card    # card

This file imports neither jax nor the JAX package.
"""

import dataclasses
import math

import pytest
import torch

from portbench.models.dsv3_lm import model_config
from portbench.reference import dsv3_lm as ref
from portbench.reference.precision import fp32_matmuls
from tpu_dra_torch.workloads import _cuda
from tpu_dra_torch.workloads import _flash_kernels as fk
from tpu_dra_torch.workloads import _moe_kernels as mk
from tpu_dra_torch.workloads import dsv3_model as dm
from tpu_dra_torch.workloads import moe

torch.set_num_threads(2)   # the suite runs 6 workers beside timing tests

KEYS = {"vocab_size": 128, "hidden_size": 64, "num_attention_heads": 4,
        "num_hidden_layers": 3, "intermediate_size": 96, "rms_norm_eps": 1e-5,
        "qk_nope_head_dim": 32, "qk_rope_head_dim": 16, "v_head_dim": 32,
        "kv_lora_rank": 32, "rope_theta": 50000, "first_k_dense_replace": 1,
        "moe_intermediate_size": 24, "router_experts": 16,
        "experts_held": [4, 8], "n_routed_experts": 4,
        "num_experts_per_tok": 3, "n_shared_experts": 2,
        "routed_scaling_factor": 2.446, "aux_loss_alpha": 1e-4}
SMALL = dataclasses.replace(model_config(KEYS, 32), dtype=torch.float32,
                            attn_impl="flash")
# A bias of this scale changes some selections (the top-3 of 16 sigmoid
# scores lie ~0.05 apart).
BIAS_STD = 0.05


def _params(cfg=SMALL, seed=0):
    return dm.init_params(cfg, torch.Generator().manual_seed(seed),
                          device="cpu", bias_std=BIAS_STD)


def _tokens(cfg=SMALL, seed=1, b=2, s=17):
    return torch.randint(0, cfg.vocab, (b, s),
                         generator=torch.Generator().manual_seed(seed))


def _named(tree, prefix=""):
    """{dotted name: leaf} of a parameter tree, as named_parameters."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for key, value in items:
        out.update(_named(value, f"{prefix}{key}."))
    return out


def _rel(a, b):
    return (torch.linalg.vector_norm(a - b)
            / torch.linalg.vector_norm(b).clamp(min=1e-30)).item()


def _normed_input(cfg=SMALL, seed=2, b=2, s=24):
    x = torch.randn(b, s, cfg.d_model,
                    generator=torch.Generator().manual_seed(seed))
    return ref.rmsnorm(x, torch.ones(cfg.d_model), cfg.norm_eps)


class TestAgainstReference:
    # Both sides are fp32 with the same selections; they differ in the
    # order of their sums (flash's plain version and the reference's
    # einsums, SwiGLU's fused gate/up product): rounding of fp32, ~1e-7
    # relative per product, grown over three blocks. 1e-5 on the logits
    # and loss, 1e-4 on each leaf's gradient (the smallest leaves, the
    # norm scales and kv_norm, carry the largest relative rounding).
    @pytest.mark.parametrize("impl", ["flash", "reference"])
    def test_logits_loss_and_every_gradient(self, impl):
        cfg = dataclasses.replace(SMALL, attn_impl=impl)
        params, tokens = _params(cfg), _tokens(cfg)
        model = dm.DSV3LM(cfg, params)
        logits, aux = model(tokens[:, :-1])
        loss = dm.loss_fn(model, tokens)
        named = dict(model.named_parameters())
        grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
        tree = dm._dense.tree_map(lambda x: x.clone().requires_grad_(), params)
        leaves = _named(tree)
        with fp32_matmuls():
            want_logits, want_aux = ref.forward(KEYS, tree, tokens[:, :-1])
            want_loss = ref.loss(KEYS, tree, tokens)
            want = dict(zip(leaves, torch.autograd.grad(
                want_loss, list(leaves.values()), allow_unused=True)))
        assert _rel(logits, want_logits) < 1e-5
        assert aux.item() == pytest.approx(want_aux.item(), rel=1e-5)
        assert loss.item() == pytest.approx(want_loss.item(), rel=1e-5)
        assert set(grads) == {n for n in leaves if not n.endswith(".bias")}
        for name, g in grads.items():
            assert _rel(g, want[name]) < 1e-4, name
        # The selection bias gets no gradient and is no parameter.
        assert all(want[n] is None for n in leaves if n.endswith(".bias"))

    def test_step_leaves_the_bias_and_moves_the_rest(self):
        params = _params()
        before = dm._dense.tree_map(torch.clone, params)
        step = dm.make_train_step(dm.DSV3LM(SMALL, params), lr=1e-2)
        losses = [step(_tokens(seed=s)).item() for s in range(3)]
        assert all(math.isfinite(x) for x in losses)
        for name, leaf in _named(params).items():
            moved = not torch.equal(leaf, _named(before)[name])
            assert moved != name.endswith(".bias"), name


class TestRouting:
    def test_selection_by_s_plus_b_gates_by_s(self):
        cfg = SMALL
        p = _params()["blocks"][1]["moe"]
        h = _normed_input()
        p = dict(p, bias=torch.linspace(-0.3, 0.3, cfg.n_routed))
        route = moe.route_topk(h, p["router"], p["bias"], cfg.top_k,
                               range(0, 16), cfg.routed_scale)
        s = torch.sigmoid(h @ p["router"])
        by_sb = torch.topk(s + p["bias"], cfg.top_k, -1).indices
        by_s = torch.topk(s, cfg.top_k, -1).indices
        assert not torch.equal(by_sb.sort(-1).values, by_s.sort(-1).values)
        # With every expert held, pair p's row holds an expert's p-th
        # pair: the row's expert is the selected one.
        rows = torch.tensor(route.rows)
        expert_of_row = torch.bucketize(torch.arange(int(rows[-1])),
                                        rows[1:], right=True)
        assert torch.equal(expert_of_row[route.slot.long()],
                           by_sb.reshape(-1))
        picked = s.gather(-1, by_sb)
        want = cfg.routed_scale * picked / picked.sum(-1, keepdim=True)
        torch.testing.assert_close(route.gates, want.reshape(-1))

    def test_dropless_however_uneven(self):
        """Every held pair gets its own row, even when every token picks
        the same held experts."""
        cfg = SMALL
        p = _params()["blocks"][1]["moe"]
        h = _normed_input(b=3, s=40)
        bias = torch.zeros(cfg.n_routed)
        bias[[5, 6, 12]] = 10.0        # 5, 6 held (of 4..7), 12 not
        route = moe.route_topk(h, p["router"], bias, cfg.top_k, range(4, 8),
                               cfg.routed_scale)
        chosen = torch.topk(torch.sigmoid(h @ p["router"]) + bias, 3,
                            -1).indices.reshape(-1)
        held = (chosen >= 4) & (chosen < 8)
        n = int(held.sum())
        assert n == 2 * 3 * 40 and route.rows == [0, 0, 120, 240, 240]
        slots = route.slot[held].long()
        assert torch.equal(slots.sort().values, torch.arange(n))
        assert (route.slot[~held] == -1).all()
        assert torch.equal(route.token_of_row[slots].long(),
                           torch.nonzero(held)[:, 0] // 3)

    def test_share_sums_to_the_uncut_layer(self):
        """The four shares of four of the 16 experts, the shared expert
        counted once, sum to the reference's whole layer."""
        cfg = dataclasses.replace(SMALL, experts_held=(0, 16))
        keys = dict(KEYS, experts_held=[0, 16], n_routed_experts=16)
        p = _params(cfg)["blocks"][1]["moe"]
        h = _normed_input(b=2, s=24)
        with fp32_matmuls():
            want, want_aux = ref.moe(keys, p, h, torch.matmul)
            shared = ref.swiglu(h, p["shared_gate"], p["shared_up"],
                                p["shared_down"], torch.matmul)
        total, auxes = 0, []
        for lo in range(0, 16, 4):
            share = dict(p, **{k: p[k][lo:lo + 4]
                               for k in ("w_gate", "w_up", "w_down")})
            out, aux = moe.topk_ffn(share, h, top_k=cfg.top_k,
                                    experts=range(lo, lo + 4),
                                    scale=cfg.routed_scale,
                                    compute_dtype=torch.float32)
            total = total + out
            auxes.append(aux)
        total = total - 3 * shared
        # fp32 sums in two orders (rounding, ~1e-7 relative a product).
        assert _rel(total, want) < 1e-5
        assert all(a.item() == pytest.approx(want_aux.item(), rel=1e-6)
                   for a in auxes)


class TestPlainKernels:
    def test_route_topk_plain_matches_a_loop(self):
        g = torch.Generator().manual_seed(3)
        expert = torch.stack([torch.randperm(16, generator=g)[:3]
                              for _ in range(50)])
        slot, pair_of_row, token_of_row, offsets, stats = mk.route_topk_plain(
            expert, 3, 4, 9)
        flat = expert.reshape(-1).tolist()
        rows, want = 0, {}
        starts = []
        for e in range(4, 9):
            starts.append(rows)
            for p_, x in enumerate(flat):
                if x == e:
                    want[p_] = rows
                    rows += 1
        assert offsets.tolist() == starts + [rows]
        assert stats.tolist() == [rows, max(flat.count(e) for e in range(4, 9))]
        for p_ in range(len(flat)):
            assert slot[p_].item() == want.get(p_, -1)
        for p_, r in want.items():
            assert pair_of_row[r].item() == p_
            assert token_of_row[r].item() == p_ // 3

    def test_combine_and_pair_dot_plain_match_loops(self):
        g = torch.Generator().manual_seed(4)
        k, t, n, d = 3, 10, 12, 16
        idx = torch.randint(-1, n, (t * k,), generator=g)
        src = torch.randn(n, d, generator=g)
        gate = torch.rand(t * k, generator=g)
        out = mk.combine_rows_plain(src, idx, gate, k)
        dots = mk.pair_dot_plain(out, src, idx, k)
        for i in range(t):
            want = sum((gate[i * k + j] * src[idx[i * k + j]]
                        for j in range(k) if idx[i * k + j] >= 0),
                       torch.zeros(d))
            torch.testing.assert_close(out[i], want)
            for j in range(k):
                p_ = i * k + j
                w = (out[i] @ src[idx[p_]]) if idx[p_] >= 0 else 0.0
                assert dots[p_].item() == pytest.approx(float(w), abs=1e-5)
        assert torch.equal(mk.combine_rows_plain(src, idx, None, k),
                           mk.combine_rows_plain(src, idx,
                                                 torch.ones(t * k), k))

    def test_route_topk_refuses_too_many_held(self):
        with pytest.raises(ValueError, match="held experts"):
            mk.route_topk(torch.zeros(4, 3, dtype=torch.long), 3, 0, 17)


class TestSplitHeadDims:
    def test_routes_and_refusals(self):
        assert fk.route(torch.bfloat16, 192, 128) == "sm90"
        assert fk.route(torch.bfloat16, 192, 192) == "mma"
        q = torch.zeros(1, 64, 2, 192, dtype=torch.bfloat16)
        v = torch.zeros(1, 64, 2, 128, dtype=torch.bfloat16)
        got = fk._kernel_inputs(q, q, v, None)
        assert got[2].shape[-1] == 128
        with pytest.raises(ValueError, match="no fused rope"):
            fk._kernel_inputs(q, q, v, (q, q))
        with pytest.raises(TypeError, match="bfloat16 only"):
            fk._kernel_inputs(q.float(), q.float(), v.float(), None)
        with pytest.raises(ValueError, match="share"):
            fk._kernel_inputs(q[..., :160], q[..., :160], v, None)

    def test_dims_carry_v_and_its_strides(self):
        q = torch.zeros(2, 64, 2, 192, dtype=torch.bfloat16)
        kv = torch.zeros(2, 64, 2, 256, dtype=torch.bfloat16)
        v = kv[..., 128:]
        assert fk._dims(q, True, None, v) == (
            2, 64, 2, 2, 192, 128, *q.stride()[:3], *q.stride()[:3],
            *kv.stride()[:3], 1, 0, 0, 2)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("b,s,causal", [(1, 40, True), (2, 1000, True),
                                        (3, 384, True), (1, 256, False)])
def test_split_kernels_match_plain(b, s, causal, cuda_device):
    """(192, 128) forward and fused backward against their plain
    versions: 5e-3 on o and 1e-3 on the gradients (chip_smoke.py's bf16
    bounds: P rounded per tile on one side, per block on the other), lse
    within 1e-4."""
    g = torch.Generator(device=cuda_device).manual_seed(s)
    q, k = (torch.randn(b, s, 4, 192, generator=g, device=cuda_device)
            .to(torch.bfloat16) for _ in range(2))
    kv = torch.randn(b, s, 4, 256, generator=g, device=cuda_device).to(
        torch.bfloat16)
    v = kv[..., 128:]
    do = torch.randn(b, s, 4, 128, generator=g, device=cuda_device).to(
        torch.bfloat16)
    _cuda.reset_launches()
    o, lse = fk.fwd(q, k, v, None, causal=causal)
    o_p, lse_p = fk.fwd_plain(q, k, v, None, causal=causal)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dlse = torch.randn(b, 4, s, generator=g, device=cuda_device) * 0.1
    got = fk.bwd(q, k, v, do, lse, delta, dlse, None, causal=causal)
    want = fk.bwd_plain(q, k, v, do, lse, delta, dlse, None, causal=causal)
    torch.cuda.synchronize()
    assert _cuda.launches()["flash_fwd_sm90"] == 1
    assert _cuda.launches()["flash_bwd_sm90"] == 1
    assert _rel(o.float(), o_p.float()) < 5e-3
    assert (lse - lse_p).abs().max().item() < 1e-4
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == w.shape and _rel(a.float(), w.float()) < 1e-3, name


@pytest.mark.card
def test_moe_kernels_match_plain(cuda_device):
    """The route and the combine bit for bit (the plain combine rounds
    as the kernel's fused multiply-adds do); the pair dot within fp32
    rounding of its sum (another order)."""
    g = torch.Generator().manual_seed(5)
    t, k, d = 3000, 6, 2048
    expert = torch.stack([torch.randperm(64, generator=g)[:k]
                          for _ in range(t)])
    want = mk.route_topk_plain(expert, k, 8, 16)
    _cuda.reset_launches()
    got = mk.route_topk(expert.to(cuda_device), k, 8, 16)
    n = int(want[4][0])
    for name, a, w in zip(("slot", "pair", "token", "offsets", "stats"),
                          got, want):
        a = a.cpu()
        if name in ("pair", "token"):
            a, w = a[:n], w[:n]
        assert torch.equal(a, w), name
    slot = want[0]
    src = torch.randn(n, d, generator=g).to(torch.bfloat16)
    gate = torch.rand(t * k, generator=g)
    out = mk.combine_rows(src.to(cuda_device), slot.to(cuda_device),
                          gate.to(cuda_device), k).cpu()
    out_p = mk.combine_rows_plain(src, slot, gate, k)
    assert torch.equal(out, out_p)
    a = torch.randn(t, d, generator=g).to(torch.bfloat16)
    dots = mk.pair_dot(a.to(cuda_device), src.to(cuda_device),
                       slot.to(cuda_device), k).cpu()
    torch.testing.assert_close(dots, mk.pair_dot_plain(a, src, slot, k),
                               rtol=1e-5, atol=1e-3)
    assert _cuda.launches()["moe_route_topk"] == 1


@pytest.mark.card
def test_step_on_the_kernels(cuda_device):
    """A bf16 step at the Moonlight widths (two blocks, a small vocab):
    every attention on the Hopper kernels at (192, 128), the MoE on the
    top-k kernels, and a finite loss."""
    cfg = dm.DSV3Config(vocab=1024, d_model=2048, n_heads=16, n_layers=2,
                        d_ff=11264, max_seq=1024, qk_nope_dim=128,
                        qk_rope_dim=64, v_head_dim=128, kv_rank=512,
                        moe_d_ff=1408, n_routed=64, experts_held=(0, 8),
                        top_k=6, n_shared=2)
    params = dm.init_params(
        cfg, torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    step = dm.make_train_step(dm.DSV3LM(cfg, params))
    tokens = torch.randint(0, cfg.vocab, (2, 1025), device=cuda_device)
    step(tokens)
    _cuda.reset_launches()
    loss = step(tokens)
    torch.cuda.synchronize()
    assert math.isfinite(loss.item())
    launches = _cuda.launches()
    assert {name: launches[name] for name in fk.ARGTYPES} == {
        "flash_fwd_sm90": 2, "flash_fwd": 0, "flash_bwd_sm90": 2,
        "flash_bwd_mma": 0}
    assert launches["moe_route"] == 0
    assert launches["moe_route_topk"] == 1
    assert launches["moe_combine_rows"] == 2      # combine, dispatch's dx
    assert launches["moe_gather_rows"] == 2       # dispatch, combine's dy
    assert launches["moe_pair_dot"] == 1
