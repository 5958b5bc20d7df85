"""The Kimi Linear-family LM (tpu_dra_torch/workloads/kimi_model.py: Kimi
Delta Attention 3:1 with NoPE MLA, the top-k MoE with a shared expert)
against the benchmark's plain fp32 reference of the family
(portbench/reference/kimi_lm.py, which imports nothing of the port), at
a small size of Kimi Linear's shape: d 64, 2 KDA heads of 16, MLA of 4
heads at q.k 16 + 8 / v 16 and kv rank 24, 16 routed experts of which 8
are held, top-4, a shared expert, one dense KDA block, two MoE KDA blocks
and one MoE MLA block (one whole 3:1 period). The size is written in
the configuration's own keys, and the port's config made from them as
the benchmark makes it (portbench/models/kimi_lm.py: model_config).

Here, on the CPU: the reference's chunked KDA against its token-by-token
definition (ragged lengths, decays strong enough that a chunk's
exp(cumulative log-decay) overflows fp32); the port's plain chunk form
and its hand-written backward (the kernels' stages) against autograd of
the definition; logits, loss and every gradient of the model against
the reference; the EP share test; MLA without NoPE bit for bit as
before; the KDA range and counters under a CPU profile; the planted
faults of the token mixer seen by the benchmark's comparison. On the
card (marker ``card``): the chunk kernels and the fused short conv and
gated norm against their plain versions, and a train step at the
published widths.

    python -m pytest tests/test_torch_kimi.py -q            # here
    python -m pytest tests/test_torch_kimi.py -q -m card    # card

This file imports neither jax nor the JAX package.
"""

import dataclasses
import math

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from portbench import checks, spec
from portbench.drivers import train
from portbench.models import kimi_lm as bench
from portbench.models.kimi_lm import model_config
from portbench.reference import kimi_lm as ref
from portbench.reference.precision import fp32_matmuls
from tpu_dra_torch.infra import trace
from tpu_dra_torch.workloads import _cuda
from tpu_dra_torch.workloads import _kda_kernels as kk
from tpu_dra_torch.workloads import kda as kda_mod
from tpu_dra_torch.workloads import kimi_model as km
from tpu_dra_torch.workloads import mla as mla_mod
from tpu_dra_torch.workloads import dsv3_model, moe

torch.set_num_threads(2)   # the suite runs 6 workers beside timing tests

KEYS = {"vocab_size": 128, "vocab": 128, "hidden_size": 64,
        "num_attention_heads": 4, "qk_nope_head_dim": 16,
        "qk_rope_head_dim": 8, "v_head_dim": 16, "kv_lora_rank": 24,
        "q_lora_rank": None, "mla_use_nope": True, "num_hidden_layers": 4,
        "intermediate_size": 96, "moe_intermediate_size": 24,
        "first_k_dense_replace": 1, "num_experts": 8, "router_experts": 16,
        "experts_held": [4, 12], "num_experts_per_token": 4,
        "num_shared_experts": 1, "routed_scaling_factor": 2.446,
        "rms_norm_eps": 1e-5, "rope_theta": 10000,
        "linear_attn_config": {"full_attn_layers": [4], "head_dim": 16,
                               "kda_layers": [1, 2, 3], "num_heads": 2,
                               "short_conv_kernel_size": 4},
        "kda_l2_eps": 1e-6, "a_log_offset": math.log(4.0),
        "a_log_std": 0.69, "aux_loss_alpha": 1e-4, "bias_std": 0.05}
SMALL = dataclasses.replace(model_config(KEYS, 130), dtype=torch.float32,
                            attn_impl="flash")
# A bias of this scale changes some selections (the top-4 of 16 sigmoid
# scores lie ~0.05 apart).
BIAS_STD = 0.05


def _params(cfg=SMALL, seed=0):
    return km.init_params(cfg, torch.Generator().manual_seed(seed),
                          device="cpu", bias_std=BIAS_STD)


def _tokens(cfg=SMALL, seed=1, b=2, s=131):
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
    a, b = a.float().cpu(), b.float().cpu()
    return (torch.linalg.vector_norm(a - b)
            / torch.linalg.vector_norm(b).clamp(min=1e-30)).item()


def _kda_inputs(b, s, h, d, dtype=torch.float64, strength=1.0, seed=0):
    """q (L2-normed, / sqrt d), k (L2-normed), v, g <= 0 (per channel,
    per-head scales from 1 to 16, times `strength`) and beta."""
    g_ = torch.Generator().manual_seed(seed)
    r = lambda *shape: torch.randn(*shape, generator=g_, dtype=dtype)
    q = F.normalize(r(b, s, h, d), dim=-1) / math.sqrt(d)
    k = F.normalize(r(b, s, h, d), dim=-1)
    a = torch.linspace(1.0, 16.0, h, dtype=dtype)
    g = -a[:, None] * F.softplus(r(b, s, h, d)) * strength
    return q, k, r(b, s, h, d), g, torch.sigmoid(r(b, s, h))


def _carried(ins, o):
    """||o - o'|| / ||o|| over the first head's second chunk, o' the
    recurrence started afresh there: how much of o the state carried in
    from the first chunk makes."""
    c = kk.CHUNK
    part = [x.detach()[:, c:2 * c] for x in ins]
    return _rel(ref.kda_recurrent(*part)[:, :, 0], o.detach()[:, c:2 * c, 0])


# ---------------------------------------------------------------------------
# The recurrence: definition, chunk form, plain kernels
# ---------------------------------------------------------------------------

class TestChunkForm:
    # The strongest heads decay by ~10 nats a token (~40 at strength 4):
    # a chunk's cumulative log-decay passes -90, past which exp(-G), the
    # factor a chunk form without per-pair decays would take, overflows
    # fp32. Both chunk forms take each pair's decay channel by channel
    # and never exponentiate a positive sum.
    @pytest.mark.parametrize("s,strength", [(150, 1.0), (61, 1.0),
                                            (129, 4.0), (64, 0.02),
                                            (333, 0.05), (1000, 0.01)],
                             ids=["s150", "s61", "s129-strong", "s64-weak",
                                  "s333-weak", "s1000-weak"])
    def test_reference_chunked_is_the_recurrence(self, s, strength):
        """kda_chunked against kda_recurrent in fp32, outputs and every
        input's gradient: fp32 rounding over two orders of sums, 1e-5."""
        ins = [x.float().requires_grad_()
               for x in _kda_inputs(2, s, 3, 16, strength=strength)]
        assert (ins[3].detach().cumsum(1)[:, :64] < -90).any() or \
            strength < 1
        do = torch.randn(2, s, 3, 16, generator=torch.Generator().manual_seed(9))
        want = ref.kda_recurrent(*ins)
        got = ref.kda_chunked(*ins)
        assert _rel(got, want) < 1e-5
        for a, w in zip(torch.autograd.grad(got, ins, do),
                        torch.autograd.grad(want, ins, do)):
            assert _rel(a, w) < 1e-5

    @pytest.mark.parametrize("s,strength", [(150, 1.0), (200, 4.0),
                                            (64, 0.02), (333, 0.05),
                                            (1000, 0.01)])
    def test_plain_kernels_are_the_recurrence(self, s, strength):
        """chunk_fwd_plain and the hand-written chunk_bwd_plain (the
        kernels' stages: intra, state passes, dstate, intra_bwd) against
        the definition and its autograd, from fp64 inputs computed in
        fp32: 2e-5 (the decays' gradient sums ~64 terms a channel). The
        weak decays' multi-chunk cases carry the state across chunks:
        their mildest head loses 0.5-2.6 nats a chunk."""
        ins = [x.requires_grad_() for x in _kda_inputs(2, s, 3, 16,
                                                       strength=strength)]
        want = ref.kda_recurrent(*ins)
        if strength < 1 and s > 2 * kk.CHUNK:
            assert _carried(ins, want) > 0.05
        do = torch.randn_like(want)
        want_grads = torch.autograd.grad(want, ins, do)
        plain = [x.detach() for x in ins]
        assert _rel(kk.chunk_fwd_plain(*plain), want) < 2e-5
        for name, a, w in zip("q k v g beta".split(),
                              kk.chunk_bwd_plain(*plain, do), want_grads):
            assert _rel(a, w) < 2e-5, name

    def test_wrappers_run_the_plain_versions_on_the_cpu(self):
        ins = _kda_inputs(1, 70, 2, 16, dtype=torch.float32)
        do = torch.randn(1, 70, 2, 16)
        assert torch.equal(kk.chunk_fwd(*ins), kk.chunk_fwd_plain(*ins))
        for a, b in zip(kk.chunk_bwd(*ins, do), kk.chunk_bwd_plain(*ins, do)):
            assert torch.equal(a, b)

    def test_chunk_buffers_round_trip(self):
        x = torch.randn(2, 130, 3, 5)
        c = kk.to_chunks(x)
        assert c.shape == (2, 3, 3, 64, 5)
        assert torch.equal(kk.from_chunks(c, 130), x)
        assert not c[:, :, -1, 2:].any()


# ---------------------------------------------------------------------------
# The model against the reference
# ---------------------------------------------------------------------------

class TestAgainstReference:
    # Both sides are fp32 with the same selections; they differ in the
    # order of their sums (the port's conv1d and plain chunk form, the
    # reference's shifted sums and per-chunk solves): rounding of fp32,
    # ~1e-7 relative per product, grown over four blocks and a recurrence
    # of 130 tokens. 1e-5 on the logits and loss, 1e-4 on each leaf's
    # gradient but A_log's, 5e-4: two numbers per layer, each a sum over
    # every token and channel of the decay's terms of both signs, which
    # cancel to ~1% of their magnitudes (the rounding of the sum stays).
    @pytest.mark.parametrize("s", [131, 63], ids=["s130", "s62"])
    def test_logits_loss_and_every_gradient(self, s):
        params, tokens = _params(), _tokens(s=s)
        model = km.KimiLM(SMALL, params)
        logits, aux = model(tokens[:, :-1])
        loss = km.loss_fn(model, tokens)
        named = dict(model.named_parameters())
        grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
        tree = km._dense.tree_map(lambda x: x.clone().requires_grad_(), params)
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
            tol = 5e-4 if name.endswith(".a_log") else 1e-4
            assert _rel(g, want[name]) < tol, name
        assert all(want[n] is None for n in leaves if n.endswith(".bias"))

    def test_leaves_match_the_reference(self):
        """The port's tree and the reference's leaves: the same paths and
        shapes, so the benchmark's weights build both."""
        got = {n: tuple(x.shape) for n, x in _named(_params()).items()}
        want = {".".join(map(str, path)): shape
                for path, shape, _ in ref.leaves(KEYS)}
        assert got == want

    def test_layer_kinds_follow_the_config(self):
        assert SMALL.kda_pattern == (1, 1, 1, 0)
        model = km.KimiLM(SMALL, _params())
        assert [b.mixer for b in model.blocks] == [kda_mod.kda] * 3 + [
            mla_mod.mla]
        assert [hasattr(b, "moe") for b in model.blocks] == [False] + [True] * 3

    def test_a_wrong_pattern_is_refused(self):
        cfg = dataclasses.replace(SMALL, kda_pattern=(1, 0))
        with pytest.raises(ValueError, match="kda_pattern"):
            km.KimiLM(cfg, _params())

    def test_share_sums_to_the_uncut_layer(self):
        """The four shares of four of the 16 experts, the shared expert
        counted once, sum to the reference's whole layer."""
        cfg = dataclasses.replace(SMALL, experts_held=(0, 16))
        keys = dict(KEYS, experts_held=[0, 16], num_experts=16)
        p = _params(cfg)["blocks"][1]["moe"]
        h = torch.randn(2, 24, 64, generator=torch.Generator().manual_seed(5))
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


def _mla_with_rope(cfg, p, h):
    """mla.mla as it was before its NoPE form, line for line."""
    cd = cfg.dtype
    b, s, _ = h.shape
    heads, nope, rdims = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    q = (h @ p["wq"].to(cd)).view(b, s, heads, nope + rdims)
    c, k_pe = (h @ p["wkv_a"].to(cd)).split([cfg.kv_rank, rdims], -1)
    c = km._dense._rmsnorm(c, p["kv_norm"], cfg.norm_eps)
    kv = (c @ p["wkv_b"].to(cd)).view(b, s, heads, nope + cfg.v_head_dim)
    k_nope, v = kv.split([nope, cfg.v_head_dim], -1)
    cos, sin = mla_mod.rope_tables(s, rdims, cfg.rope_theta, h.device)
    q = torch.cat([q[..., :nope], mla_mod.rope(q[..., nope:], cos, sin)], -1)
    k_pe = mla_mod.rope(k_pe.view(b, s, 1, rdims), cos, sin)
    k = torch.cat([k_nope, k_pe.expand(b, s, heads, rdims)], -1)
    o = mla_mod.attend(q, k, v, causal=True, impl=cfg.attn_impl, rope=False)
    return o.reshape(b, s, heads * cfg.v_head_dim) @ p["wo"].to(cd)


class TestMLA:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_rope_form_is_unchanged(self, dtype):
        """With mla_use_nope off (the DeepSeek-V3 family's, Moonlight's
        path) mla returns what it returned before, bit for bit."""
        cfg = dsv3_model.DSV3Config(vocab=64, d_model=32, n_heads=2,
                                    n_layers=1, d_ff=48, dtype=dtype,
                                    attn_impl="flash", first_dense=1)
        assert not cfg.mla_use_nope
        p = dsv3_model.init_params(cfg, torch.Generator().manual_seed(2),
                                   device="cpu")["blocks"][0]["attn"]
        h = torch.randn(2, 20, 32, generator=torch.Generator().manual_seed(3)
                        ).to(dtype)
        assert torch.equal(mla_mod.mla(cfg, p, h), _mla_with_rope(cfg, p, h))

    def test_nope_form_rotates_nothing(self):
        """The NoPE layer against the reference's (q_pe and k_pe enter the
        scores unrotated), and away from the rope form by far more than
        rounding."""
        p = _params()["blocks"][3]["attn"]
        h = torch.randn(2, 20, 64, generator=torch.Generator().manual_seed(4))
        with fp32_matmuls():
            want = ref.mla(KEYS, p, h, torch.matmul)
        assert _rel(mla_mod.mla(SMALL, p, h), want) < 1e-5
        roped = dataclasses.replace(SMALL, mla_use_nope=False)
        assert _rel(mla_mod.mla(roped, p, h), want) > 1e-3


# ---------------------------------------------------------------------------
# Tracing
# ---------------------------------------------------------------------------

class TestTracing:
    def test_range_and_counters_under_a_cpu_profile(self):
        trace.read_counters()
        step = km.make_train_step(km.KimiLM(SMALL, _params()), lr=1e-2)
        tokens = _tokens(s=131)
        step(tokens)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            step(tokens)
        counts = trace.read_counters()
        names = [e.name for e in prof.events()]
        n_kda, b, s = 3, 2, 130
        assert names.count("attention.kda") == n_kda
        assert counts["attention.kda_tokens"] == n_kda * b * s
        assert counts["attention.kda_chunks"] == n_kda * b * 2 * 3
        # Nothing counts without a profiler session.
        step(tokens)
        assert trace.read_counters() == {}

    def test_kda_range_holds_the_chunk_op(self):
        model = km.KimiLM(SMALL, _params())
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            km.loss_fn(model, _tokens())
        trace.read_counters()
        events = prof.events()
        spans = [(e.time_range.start, e.time_range.end) for e in events
                 if e.name == "attention.kda"]
        chunk = [e.time_range.start for e in events
                 if e.name == "_KDAChunk"]
        assert len(chunk) == 3
        assert all(any(a <= t <= z for a, z in spans) for t in chunk)


# ---------------------------------------------------------------------------
# The benchmark's comparison at a tiny size
# ---------------------------------------------------------------------------

def _tiny_cell():
    full = spec.resolve("kimi_linear.s32k_uniform")
    return dataclasses.replace(
        full, config=dict(full.config, **KEYS, compute_dtype="float32"),
        traffic=dict(full.traffic, batch=2, seq=130, pool=4), limits={})


def test_token_mixer_faults_fail_the_comparison():
    """Through the benchmark's own set-up and reference on the CPU, the
    port in fp32 (at this size a bf16 step's decays, -exp(A_log)
    softplus(f) with A up to 16 a channel, turn f's rounding into a gap
    as large as a fault's): the sound program's readings against those
    of each planted fault of the token mixer. Gated DeltaNet's per-head
    gate and gated linear attention (no erase) each read at least 100x
    the sound program's gap on some compared number."""
    cell = _tiny_cell()
    device = torch.device("cpu")
    seed = 3_000_000_019

    def numbers(fault):
        state = train.setup(cell, seed, device, fault=fault)
        ref_readings = train.reference_readings(cell, seed, state["pool"],
                                                device)
        return checks.numbers(state["program"], ref_readings)

    sound = numbers(None)
    assert all(math.isfinite(v) for v in sound.values())
    for fault in ("gate_per_head", "no_delta"):
        got = numbers(fault)
        assert any(got[n] >= 100 * sound[n] for n in checks.NUMBERS), fault
    # The fault is planted for its step's calls only.
    assert kda_mod._KDAChunk.__name__ == "_KDAChunk"


def test_faults_are_the_familys():
    assert bench.FAULTS == ("unchanged", "half_batch", "gate_per_head",
                            "no_delta")
    with pytest.raises(ValueError, match="unknown fault"):
        bench.build(_tiny_cell().config, _tiny_cell().traffic,
                    _params(dataclasses.replace(
                        model_config(KEYS, 130), dtype=torch.float32)),
                    fault="no_such")


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("b,s,h,strength", [(2, 150, 3, 1.0), (1, 64, 2, 1.0),
                                            (1, 1000, 2, 1.0),
                                            (2, 333, 2, 0.05),
                                            (1, 1000, 2, 0.01)])
def test_kernels_match_the_plain_versions(cuda_device, b, s, h, strength):
    """The five chunk kernels against their plain versions (fp32 chunk
    form on the same bf16 inputs): both round o, dq, dk and dv to bf16
    once, 1e-3. The weak decays carry the state across chunks (the
    mildest head loses 0.5-2.6 nats a chunk)."""
    ins = [x.to(cuda_device) for x in _kda_inputs(b, s, h, 128,
                                                  dtype=torch.float32,
                                                  strength=strength)]
    ins = [x.bfloat16() for x in ins[:3]] + ins[3:]
    do = torch.randn(b, s, h, 128, device=cuda_device).bfloat16()
    _cuda.reset_launches()
    got = [kk.chunk_fwd(*ins)] + list(kk.chunk_bwd(*ins, do))
    torch.cuda.synchronize()
    want = [kk.chunk_fwd_plain(*ins)] + list(kk.chunk_bwd_plain(*ins, do))
    for name, a, w in zip("o dq dk dv dg dbeta".split(), got, want):
        assert _rel(a, w) < 1e-3, name
    launches = _cuda.launches()
    assert {n: launches[n] for n in kk.ARGTYPES} == {
        "kda_intra": 2, "kda_state_fwd": 2, "kda_state_bwd": 1,
        "kda_dstate": 1, "kda_intra_bwd": 1}


@pytest.mark.card
@pytest.mark.parametrize("norm", [True, False])
def test_mixer_kernels_match_the_plain_versions(cuda_device, norm):
    """The fused short conv (SiLU, the head's L2 norm) and gated RMSNorm
    against their plain versions, forward and backward, at 4 heads of
    128 over 300 tokens: both compute in fp32 and round to bf16 once
    (one bf16 ulp apart at most, ~3e-3 of the norm); the weights'
    gradients are fp32 sums in two orders, 1e-4."""
    from tpu_dra_torch.workloads import _mixer_kernels as mx

    g = torch.Generator(device=cuda_device).manual_seed(7)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=cuda_device) * scale

    x, dout = randn(2, 300, 512).bfloat16(), randn(2, 300, 512).bfloat16()
    w = randn(4, 512, scale=0.5)
    got = mx.short_conv(x, w, norm, 0.088, 1e-6)
    want = mx.short_conv_plain(x, w, norm, 0.088, 1e-6, 128)
    assert _rel(got, want) < 5e-3
    (dx, dw), (pdx, pdw) = (mx.short_conv_bwd(x, w, dout, norm, 0.088, 1e-6),
                            mx.short_conv_bwd(x.cpu(), w.cpu(), dout.cpu(),
                                              norm, 0.088, 1e-6))
    assert _rel(dx, pdx) < 5e-3 and _rel(dw, pdw) < 1e-4
    o, gate = randn(2, 300, 512).bfloat16(), randn(2, 300, 512).bfloat16()
    bias, scale = randn(512, scale=0.1), 1 + randn(128, scale=0.1)
    assert _rel(mx.gated_norm(o, gate, bias, scale, 1e-5),
                mx.gated_norm_plain(o, gate, bias, scale, 1e-5)) < 5e-3
    got = mx.gated_norm_bwd(o, gate, bias, scale, dout, 1e-5)
    want = mx.gated_norm_bwd(*(t.cpu() for t in (o, gate, bias, scale, dout)),
                             1e-5)
    for name, a, b in zip(("do", "dgate", "dbias", "dscale"), got, want):
        assert _rel(a, b) < (5e-3 if name in ("do", "dgate") else 1e-4), name


@pytest.mark.card
def test_step_on_the_kernels(cuda_device):
    """A bf16 step at the Kimi Linear widths (a dense KDA block and a MoE
    MLA block, a small vocab): KDA on the chunk kernels, MLA on the
    (192, 128) Hopper kernels, a finite loss."""
    keys = dict(KEYS, vocab_size=1024, vocab=1024, hidden_size=2304,
                num_attention_heads=32, qk_nope_head_dim=128,
                qk_rope_head_dim=64, v_head_dim=128, kv_lora_rank=512,
                num_hidden_layers=2, intermediate_size=9216,
                moe_intermediate_size=1024, router_experts=256,
                experts_held=[0, 8], num_experts=8, num_experts_per_token=8,
                linear_attn_config={"full_attn_layers": [2], "head_dim": 128,
                                    "kda_layers": [1], "num_heads": 32,
                                    "short_conv_kernel_size": 4})
    cfg = model_config(keys, 2048)
    params = km.init_params(
        cfg, torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    step = km.make_train_step(km.KimiLM(cfg, params))
    tokens = torch.randint(0, cfg.vocab, (1, 2049), device=cuda_device)
    step(tokens)
    _cuda.reset_launches()
    loss = step(tokens)
    torch.cuda.synchronize()
    assert math.isfinite(loss.item())
    launches = _cuda.launches()
    assert {n: launches[n] for n in kk.ARGTYPES} == {
        "kda_intra": 2, "kda_state_fwd": 2, "kda_state_bwd": 1,
        "kda_dstate": 1, "kda_intra_bwd": 1}
    assert launches["flash_fwd_sm90"] == 1 and launches["flash_bwd_sm90"] == 1
    assert (launches["short_conv_fwd"], launches["short_conv_bwd"],
            launches["gated_norm_fwd"], launches["gated_norm_bwd"]) == \
        (3, 3, 1, 1)
