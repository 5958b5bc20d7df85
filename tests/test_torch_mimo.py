"""The MiMo-V2-Flash-family LM (tpu_dra_torch/workloads/mimo_model.py:
hybrid attention, grouped K/V heads, a sliding window with learned
sinks, the top-k MoE with no shared expert) against the benchmark's plain
fp32 reference of the family (portbench/reference/mimo_lm.py, which
imports nothing of the port), at a small size of MiMo-V2-Flash's shape:
d 64, 8 query heads over 2 (global) and 4 (window) K/V heads, q.k 48 / v
32 with 16 roped dims, a window of 16 over S 64 and a ragged 61, 16
routed experts of which 8 are held, top-4, 1 dense + 2 MoE blocks. The
size is written in the configuration's own keys, and the port's config
made from them as the benchmark makes it (portbench/models/mimo_lm.py:
model_config).

Here, on the CPU: logits, loss and every gradient (the sinks' too); the
plain kernels' window and group paths against a loop over heads and
rows; the sink rescale against an explicit extra logit column; the
window's edge; the tile and pair counts; what the wrappers refuse; the
share test for a layer with no shared expert. On the card (marker
``card``): the (192, 128) Hopper kernels with grouped K/V heads and the
window against their plain versions, at 64 query heads over 4 and 8 K/V
heads, at S 32768 and ragged lengths, the window's tile skipping, and a
train step on the kernels.

    python -m pytest tests/test_torch_mimo.py -q            # here
    python -m pytest tests/test_torch_mimo.py -q -m card    # card

This file imports neither jax nor the JAX package.
"""

import dataclasses
import math

import pytest
import torch
from torch.utils.checkpoint import checkpoint

from portbench.models.mimo_lm import model_config
from portbench.reference import mimo_lm as ref
from portbench.reference.precision import fp32_matmuls
from tpu_dra_torch.workloads import _cuda
from tpu_dra_torch.workloads import _flash_kernels as fk
from tpu_dra_torch.workloads import flashattention as fa
from tpu_dra_torch.workloads import mimo_model as mm
from tpu_dra_torch.workloads import moe

torch.set_num_threads(2)   # the suite runs 6 workers beside timing tests

KEYS = {"vocab_size": 128, "hidden_size": 64, "num_attention_heads": 8,
        "num_key_value_heads": 2, "swa_num_key_value_heads": 4,
        "swa_num_attention_heads": 8, "num_hidden_layers": 3,
        "intermediate_size": 96, "layernorm_epsilon": 1e-5,
        "head_dim": 48, "v_head_dim": 32, "swa_head_dim": 48,
        "swa_v_head_dim": 32, "partial_rotary_factor": 0.334,
        "rope_theta": 5000000, "swa_rope_theta": 10000,
        "sliding_window": 16, "hybrid_layer_pattern": [0, 1, 1],
        "moe_layer_freq": [0, 1, 1], "attention_value_scale": 0.707,
        "moe_intermediate_size": 24, "router_experts": 16,
        "experts_held": [4, 12], "n_routed_experts": 8,
        "num_experts_per_tok": 4, "aux_loss_alpha": 1e-4,
        "sink_offset": math.log(16)}
SMALL = dataclasses.replace(model_config(KEYS, 64), dtype=torch.float32,
                            attn_impl="flash")
# A bias of this scale changes some selections (the top-4 of 16 sigmoid
# scores lie ~0.05 apart).
BIAS_STD = 0.05


def _params(cfg=SMALL, seed=0):
    p = mm.init_params(cfg, torch.Generator().manual_seed(seed),
                       device="cpu", bias_std=BIAS_STD)
    return p


def _tokens(cfg=SMALL, seed=1, b=2, s=65):
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
    return (torch.linalg.vector_norm(a.float() - b.float())
            / torch.linalg.vector_norm(b.float()).clamp(min=1e-30)).item()


class TestAgainstReference:
    # Both sides are fp32 with the same selections; they differ in the
    # order of their sums (the plain kernels' and the reference's
    # einsums, the sink as sigmoid(lse - s) on one side and an extra
    # softmax column on the other): rounding of fp32, ~1e-7 relative per
    # product, grown over three blocks. 1e-5 on the logits and loss,
    # 1e-4 on each leaf's gradient (the smallest leaves, the norm scales
    # and the sinks, carry the largest relative rounding).
    @pytest.mark.parametrize("s", [65, 62], ids=["s64", "s61"])
    @pytest.mark.parametrize("impl", ["flash", "reference"])
    def test_logits_loss_and_every_gradient(self, impl, s):
        cfg = dataclasses.replace(SMALL, attn_impl=impl)
        params, tokens = _params(cfg), _tokens(cfg, s=s)
        model = mm.MiMoLM(cfg, params)
        logits, aux = model(tokens[:, :-1])
        loss = mm.loss_fn(model, tokens)
        named = dict(model.named_parameters())
        grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
        tree = mm._dense.tree_map(lambda x: x.clone().requires_grad_(), params)
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
        assert {n for n in grads if n.endswith(".sinks")} == {
            "blocks.1.attn.sinks", "blocks.2.attn.sinks"}
        for name, g in grads.items():
            assert _rel(g, want[name]) < 1e-4, name
        assert all(want[n] is None for n in leaves if n.endswith(".bias"))

    def test_dropped_sink_is_seen(self):
        """The sinks carry weight at this size: the logits move by far
        more than the comparison's 1e-5 without them."""
        params, tokens = _params(), _tokens()
        with_sinks, _ = mm.MiMoLM(SMALL, params)(tokens[:, :-1])
        cfg = dataclasses.replace(SMALL, sink_offset=-1e4)
        without, _ = mm.MiMoLM(cfg, params)(tokens[:, :-1])
        assert _rel(without, with_sinks) > 1e-2

    def test_step_leaves_the_bias_and_moves_the_rest(self):
        params = _params()
        before = mm._dense.tree_map(torch.clone, params)
        step = mm.make_train_step(mm.MiMoLM(SMALL, params), lr=1e-2)
        losses = [step(_tokens(seed=s)).item() for s in range(3)]
        assert all(math.isfinite(x) for x in losses)
        for name, leaf in _named(params).items():
            moved = not torch.equal(leaf, _named(before)[name])
            assert moved != name.endswith(".bias"), name


def _loop_attention(q, k, v, window):
    """(o, lse) in float64 by a loop over batch, heads and rows: query
    head h reads K/V head h // (H / Hkv); row i over keys (i - W, i] (all
    of [0, i] for W 0)."""
    b, s, h, d = q.shape
    group = h // k.shape[2]
    o = torch.zeros(b, s, h, v.shape[-1], dtype=torch.float64)
    lse = torch.zeros(b, h, s, dtype=torch.float64)
    for bi in range(b):
        for hi in range(h):
            for i in range(s):
                lo = max(0, i - window + 1) if window else 0
                kk = k[bi, lo:i + 1, hi // group].double()
                vv = v[bi, lo:i + 1, hi // group].double()
                sc = kk @ q[bi, i, hi].double() / math.sqrt(d)
                lse[bi, hi, i] = torch.logsumexp(sc, 0)
                o[bi, i, hi] = torch.softmax(sc, 0) @ vv
    return o, lse


class TestPlainKernels:
    @pytest.mark.parametrize("hkv,window,s", [(2, 16, 64), (4, 16, 61),
                                              (2, 0, 61), (8, 5, 23)])
    def test_window_and_groups_match_a_loop(self, hkv, window, s):
        """fwd_plain's o and lse and bwd_plain's gradients (by autograd
        of the loop: the cotangents of o and of lse) at fp32: float
        rounding, 1e-5."""
        g = torch.Generator().manual_seed(s + hkv)
        q = torch.randn(2, s, 8, 48, generator=g)
        k = torch.randn(2, s, hkv, 48, generator=g)
        v = torch.randn(2, s, hkv, 32, generator=g)
        do = torch.randn(2, s, 8, 32, generator=g)
        dlse = torch.randn(2, 8, s, generator=g)
        o, lse = fk.fwd_plain(q, k, v, None, causal=True, window=window)
        qd, kd, vd = (x.double().requires_grad_() for x in (q, k, v))
        want_o, want_lse = _loop_attention(qd, kd, vd, window)
        assert _rel(o, want_o) < 1e-5 and _rel(lse, want_lse) < 1e-5
        delta = (do * o).sum(-1).transpose(1, 2)
        got = fk.bwd_plain(q, k, v, do, lse, delta, dlse, None, causal=True,
                           window=window)
        want = torch.autograd.grad(
            (want_o * do.double()).sum() + (want_lse * dlse.double()).sum(),
            (qd, kd, vd))
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            assert a.shape == w.shape and _rel(a, w) < 1e-5, name

    def test_window_edge(self):
        """i - j = W - 1 is kept, i - j = W dropped: with equal scores a
        row's output is the mean of the values of the keys it keeps."""
        s, w = 40, 7
        q = torch.zeros(1, s, 2, 16)
        k = torch.randn(1, s, 1, 16)
        v = torch.eye(s)[None, :, None, :]       # key j's value: e_j
        for got in (fk.fwd_plain(q, k, v, None, causal=True, window=w)[0],
                    fa.attend(q, k, v, impl="reference", window=w),
                    fa.attend(q, k, v, impl="flash", window=w)):
            for i in range(s):
                kept = (got[0, i, 1] > 0).nonzero()[:, 0].tolist()
                assert kept == list(range(max(0, i - w + 1), i + 1)), i
        assert fk.band_mask(s, w)[20, 20 - (w - 1)]
        assert not fk.band_mask(s, w)[20, 20 - w]

    def test_sink_is_an_extra_logit_column(self):
        """o sigmoid(lse - s_h) equals softmax over [scores, s_h] with the
        sink's column dropped, times V."""
        g = torch.Generator().manual_seed(3)
        q, k = torch.randn(2, 30, 4, 16, generator=g), torch.randn(
            2, 30, 2, 16, generator=g)
        v = torch.randn(2, 30, 2, 8, generator=g)
        sinks = torch.randn(4, generator=g) + 2.0
        o, lse = fk.fwd_plain(q, k, v, None, causal=True, window=6)
        got = o * torch.sigmoid(lse - sinks[:, None]).transpose(1, 2)[..., None]
        scores = torch.einsum("bqhd,bkhd->bhqk", q,
                              fk.expand_heads(k, 4)) / 4.0
        scores = scores.masked_fill(~fk.band_mask(30, 6), float("-inf"))
        col = sinks[None, :, None, None].expand(2, 4, 30, 1)
        p = torch.softmax(torch.cat([scores, col], -1), -1)[..., :-1]
        want = torch.einsum("bhqk,bkhd->bqhd", p, fk.expand_heads(v, 4))
        assert _rel(got, want) < 1e-6

    @pytest.mark.parametrize("s,window", [(61, 16), (32767, 128),
                                          (32768, 128), (1000, 300)])
    def test_tile_and_pair_counts(self, s, window):
        """fwd_tiles counts the 128 x 128 tiles that meet each Q tile's
        band; band_pairs the band's (query, key) pairs."""
        n = -(-s // 128)
        meets = 0
        for qt in range(n):
            rows = range(qt * 128, min(s, qt * 128 + 128))
            lo = max(0, rows[0] - window + 1)
            meets += qt - lo // 128 + 1
        assert fk.fwd_tiles(s, window) == meets
        assert fk.band_pairs(s, window) == sum(min(i + 1, window)
                                               for i in range(s))
        assert fk.fwd_tiles(s, 0) == n * (n + 1) // 2


class TestRefusals:
    def _meta(self, hq, hkv, d, dv):
        return (torch.empty(1, 64, hq, d, device="meta"),
                torch.empty(1, 64, hkv, d, device="meta"),
                torch.empty(1, 64, hkv, dv, device="meta"))

    @pytest.mark.parametrize("hq,hkv,d,dv,window,causal,match", [
        (8, 2, 128, 128, 0, True, "run at"),       # groups off (192, 128)
        (8, 8, 64, 64, 16, True, "run at"),        # a window off it
        (8, 3, 192, 128, 0, True, "do not divide"),
        (8, 2, 192, 128, 16, False, "needs causal"),
        (8, 2, 192, 128, -1, True, "positive"),
    ])
    def test_what_no_route_takes(self, hq, hkv, d, dv, window, causal,
                                 match):
        q, k, v = self._meta(hq, hkv, d, dv)
        with pytest.raises(ValueError, match=match):
            fk.check_group(q, k, v, window, causal)

    def test_grouped_window_passes_at_the_split_pair(self):
        q, k, v = self._meta(64, 8, 192, 128)
        fk.check_group(q, k, v, 128, True)
        assert fk.route(torch.bfloat16, 192, 128) == "sm90"

    def test_fp32_at_the_split_pair_is_refused(self):
        q = torch.zeros(1, 64, 4, 192)
        k = torch.zeros(1, 64, 2, 192)
        v = torch.zeros(1, 64, 2, 128)
        with pytest.raises(TypeError, match="bfloat16 only"):
            fk._kernel_inputs(q, k, v, None)

    def test_dims_carry_kv_heads_strides_and_window(self):
        q = torch.zeros(2, 64, 8, 192, dtype=torch.bfloat16)
        kv = torch.zeros(2, 64, 2, 320, dtype=torch.bfloat16)
        k, v = kv[..., :192], kv[..., 192:]
        assert fk._dims(q, True, None, v, k, 128) == (
            2, 64, 8, 2, 192, 128, *q.stride()[:3], *kv.stride()[:3],
            *kv.stride()[:3], 1, 128, 0, 2)


class TestNoSharedExpert:
    def test_share_sums_to_the_uncut_layer(self):
        """The two shares of eight of the 16 experts of a layer with no
        shared expert sum to the reference's whole layer; no moe.shared
        work runs."""
        cfg = dataclasses.replace(SMALL, experts_held=(0, 16))
        keys = dict(KEYS, experts_held=[0, 16], n_routed_experts=16)
        p = _params(cfg)["blocks"][1]["moe"]
        assert not any(name.startswith("shared") for name in p)
        h = torch.randn(2, 24, 64, generator=torch.Generator().manual_seed(2))
        h = ref.rmsnorm(h, torch.ones(64), 1e-5)
        with fp32_matmuls():
            want, want_aux = ref.moe(keys, p, h, torch.matmul)
        total, auxes = 0, []
        for lo in range(0, 16, 8):
            share = dict(p, **{k: p[k][lo:lo + 8]
                               for k in ("w_gate", "w_up", "w_down")})
            out, aux = moe.topk_ffn(share, h, top_k=cfg.top_k,
                                    experts=range(lo, lo + 8), scale=1.0,
                                    compute_dtype=torch.float32)
            total = total + out
            auxes.append(aux)
        # fp32 sums in two orders (rounding, ~1e-7 relative a product).
        assert _rel(total, want) < 1e-5
        assert all(a.item() == pytest.approx(want_aux.item(), rel=1e-6)
                   for a in auxes)


class TestWindowRange:
    def test_window_range_holds_its_calls_and_their_backward(self):
        """Under a profiler, attention.window holds each window layer's
        attend call (attention.fwd inside it, counted), and the benchmark's
        window reader links each window layer's attention backward to it,
        the global layers' to attention.fwd alone."""
        from torch.profiler import ProfilerActivity, profile

        from portbench import window_ranges
        from tpu_dra_torch.infra import trace

        step = mm.make_train_step(mm.MiMoLM(SMALL, _params()), lr=1e-2)
        step(_tokens())
        trace.read_counters()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            step(_tokens())
        counts = trace.read_counters()
        events = prof.events()
        n_window = sum(SMALL.hybrid_pattern)
        assert sum(e.name == "attention.window" for e in events) == n_window
        assert counts["attention.window_pairs"] == n_window * 2 * 8 * \
            fk.band_pairs(64, 16)
        assert counts["attention.window_tiles"] == n_window * 2 * 8 * \
            fk.fwd_tiles(64, 16)
        program = window_ranges.from_events(events, 1)
        flash = [(name, node) for *_, name, node in program.links
                 if node == "_FlashAttentionBackward"]
        assert flash.count(("attention.window", "_FlashAttentionBackward")) \
            == n_window
        assert flash.count(("attention.fwd", "_FlashAttentionBackward")) \
            == SMALL.n_layers


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)


def _operands(s, hkv, device, seed=0, b=1, hq=64):
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(b, s, hq, 192, generator=g, device=device).to(
        torch.bfloat16)
    # k and v as views of one [B, S, Hkv, 320] projection: their own strides.
    kv = torch.randn(b, s, hkv, 320, generator=g, device=device).to(
        torch.bfloat16)
    do = torch.randn(b, s, hq, 128, generator=g, device=device).to(
        torch.bfloat16)
    dlse = torch.randn(b, hq, s, generator=g, device=device) * 0.1
    return q, kv[..., :192], kv[..., 192:], do, dlse


def _kernels(q, k, v, do, dlse, window):
    _cuda.reset_launches()
    o, lse = fk.fwd(q, k, v, None, causal=True, window=window)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    grads = fk.bwd(q, k, v, do, lse, delta, dlse, None, causal=True,
                   window=window)
    torch.cuda.synchronize()
    assert _cuda.launches()["flash_fwd_sm90"] == 1
    assert _cuda.launches()["flash_bwd_sm90"] == 1
    return o, lse, delta, grads


def _group(x, j, size):
    return x[:, :, j * size:(j + 1) * size]


@pytest.mark.card
@pytest.mark.parametrize("hkv,window,s", [(4, 0, 1000), (8, 128, 1000),
                                          (8, 128, 2048), (4, 128, 777),
                                          (8, 0, 2048)])
def test_grouped_window_kernels_match_plain(hkv, window, s, cuda_device):
    """Both kernels at 64 query heads against the plain versions of the
    first and the last K/V group (a group's outputs depend on it alone):
    5e-3 on o and 1e-3 on the gradients, lse within 1e-4
    (test_torch_dsv3's bounds for the (192, 128) instances: P rounded per
    tile on one side, per block on the other; dK and dV summed over the
    group in fp32 on both)."""
    q, k, v, do, dlse = _operands(s, hkv, cuda_device, seed=s + hkv)
    o, lse, delta, (dq, dk, dv) = _kernels(q, k, v, do, dlse, window)
    size = 64 // hkv
    for j in (0, hkv - 1):
        qj, doj = _group(q, j, size), _group(do, j, size)
        kj, vj = k[:, :, j:j + 1], v[:, :, j:j + 1]
        lj, dj, dlj = (x[:, j * size:(j + 1) * size] for x in
                       (lse, delta, dlse))
        o_p, lse_p = fk.fwd_plain(qj, kj, vj, None, causal=True,
                                  window=window)
        assert _rel(_group(o, j, size), o_p) < 5e-3
        assert (lj - lse_p).abs().max().item() < 1e-4
        want = fk.bwd_plain(qj, kj, vj, doj, lj, dj, dlj, None, causal=True,
                            window=window)
        got = (_group(dq, j, size), dk[:, :, j:j + 1], dv[:, :, j:j + 1])
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            assert a.shape == w.shape and _rel(a, w) < 1e-3, (name, j)


def _fp32_group(q, k, v, window, rows):
    """(o, lse) in fp32 of query heads q [B, S, G, D] over one K/V head k
    [B, S, 1, D], v [B, S, 1, Dv]: row blocks of `rows` over only the keys
    they may see, each checkpointed (the plain versions' [S, S] scores
    do not fit at S 32768)."""
    s = q.shape[1]

    def part(qc, kc, vc, start, lo):
        sc = torch.einsum("bqhd,bkd->bhqk", qc, kc) / math.sqrt(q.shape[-1])
        i = torch.arange(start, start + qc.shape[1], device=q.device)[:, None]
        j = torch.arange(lo, lo + kc.shape[1], device=q.device)[None, :]
        keep = (j <= i) & ((i - j < window) if window else True)
        sc = sc.masked_fill(~keep, float("-inf"))
        lse = torch.logsumexp(sc, -1)
        o = torch.einsum("bhqk,bkd->bqhd", torch.exp(sc - lse[..., None]), vc)
        return o, lse

    outs, lses = [], []
    for start in range(0, s, rows):
        end = min(s, start + rows)
        lo = max(0, start - window + 1) if window else 0
        o, lse = checkpoint(part, q[:, start:end], k[:, lo:end, 0],
                            v[:, lo:end, 0], start, lo, use_reentrant=False)
        outs.append(o)
        lses.append(lse)
    return torch.cat(outs, 1), torch.cat(lses, -1)


@pytest.mark.card
@pytest.mark.parametrize("hkv,window,s", [(4, 0, 32768), (8, 128, 32768),
                                          (8, 128, 32767), (4, 0, 32767)])
def test_grouped_window_kernels_at_the_cells_length(hkv, window, s,
                                                    cuda_device):
    """Both kernels at the cell's shapes (B1, 64 query heads, S 32767 as
    the step runs it, and 32768) against an fp32 computation of the first
    K/V group by autograd (its inputs the same bf16 values): 1e-2 on o
    and the gradients, 2e-4 on lse. The kernels round p and dS to bf16
    before their products and every output once (2^-9 relative each);
    1e-2 is ~5 of those on a norm, and the (192, 128) kernels read
    3e-3 to 5e-3 there against fp32 (PERF.md)."""
    q, k, v, do, dlse = _operands(s, hkv, cuda_device, seed=7)
    o, lse, _, (dq, dk, dv) = _kernels(q, k, v, do, dlse, window)
    size = 64 // hkv
    qj, kj, vj = (x.float().requires_grad_() for x in
                  (_group(q, 0, size), k[:, :, :1], v[:, :, :1]))
    rows = 1024 if window else 256
    o_r, lse_r = _fp32_group(qj, kj, vj, window, rows)
    loss = ((o_r * _group(do, 0, size).float()).sum()
            + (lse_r * dlse[:, :size]).sum())
    want = torch.autograd.grad(loss, (qj, kj, vj))
    readings = {"o": _rel(_group(o, 0, size), o_r),
                "lse": (lse[:, :size] - lse_r).abs().max().item()}
    for name, a, w in zip(("dq", "dk", "dv"),
                          (_group(dq, 0, size), dk[:, :, :1], dv[:, :, :1]),
                          want):
        readings[name] = _rel(a, w)
    print(f"readings hkv={hkv} window={window} s={s}: {readings}")
    assert readings["lse"] < 2e-4, readings
    assert all(readings[n] < 1e-2 for n in ("o", "dq", "dk", "dv")), readings


def _ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    times = []
    for _ in range(reps):
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


@pytest.mark.card
def test_window_visits_only_the_band(cuda_device):
    """A window call visits ceil((W - 1) / 128) + 1 key tiles a Q tile
    (fwd_tiles: 511 of the causal triangle's 32,896 at S 32768), so it
    takes a small part of a causal call's time: under 1/8 in each
    direction, where masking the whole triangle would take as long."""
    s = 32768
    q, k, v, do, dlse = _operands(s, 8, cuda_device, seed=11)
    assert fk.fwd_tiles(s, 128) == 511 and fk.fwd_tiles(s, 0) == 32896
    o, lse = fk.fwd(q, k, v, None, causal=True)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    times = {}
    for window in (0, 128):
        times[window, "fwd"] = _ms(
            lambda: fk.fwd(q, k, v, None, causal=True, window=window))
        times[window, "bwd"] = _ms(
            lambda: fk.bwd(q, k, v, do, lse, delta, dlse, None, causal=True,
                           window=window))
    print(f"window ms (B1 S32768 H64/8): {times}")
    assert times[128, "fwd"] < times[0, "fwd"] / 8, times
    assert times[128, "bwd"] < times[0, "bwd"] / 8, times


@pytest.mark.card
def test_step_on_the_kernels(cuda_device):
    """A bf16 step at the MiMo-V2-Flash widths (a global dense block and
    a window MoE block, a small vocab): every attention on the Hopper
    kernels at (192, 128) with grouped K/V heads, the MoE on the top-k
    kernels, the sinks trained, and a finite loss."""
    keys = dict(KEYS, vocab_size=1024, hidden_size=4096,
                num_attention_heads=64, num_key_value_heads=4,
                swa_num_key_value_heads=8, num_hidden_layers=2,
                intermediate_size=16384, head_dim=192, v_head_dim=128,
                swa_head_dim=192, swa_v_head_dim=128,
                swa_num_attention_heads=64, sliding_window=128,
                hybrid_layer_pattern=[0, 1],
                moe_layer_freq=[0, 1], moe_intermediate_size=2048,
                router_experts=256, experts_held=[0, 8], n_routed_experts=8,
                num_experts_per_tok=8, sink_offset=math.log(128))
    cfg = model_config(keys, 2048)
    params = mm.init_params(
        cfg, torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    sinks = params["blocks"][1]["attn"]["sinks"].clone()
    step = mm.make_train_step(mm.MiMoLM(cfg, params))
    tokens = torch.randint(0, cfg.vocab, (1, 2049), device=cuda_device)
    step(tokens)
    _cuda.reset_launches()
    loss = step(tokens)
    torch.cuda.synchronize()
    assert math.isfinite(loss.item())
    assert not torch.equal(params["blocks"][1]["attn"]["sinks"], sinks)
    launches = _cuda.launches()
    assert {name: launches[name] for name in fk.ARGTYPES} == {
        "flash_fwd_sm90": 2, "flash_fwd": 0, "flash_bwd_sm90": 2,
        "flash_bwd_mma": 0}
    assert launches["moe_route_topk"] == 1
