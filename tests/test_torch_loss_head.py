"""The LM loss head: model.token_nll, its fused Function (model._FusedNLL)
and the cross-entropy kernels under it (csrc/loss_head.cu, through
tpu_dra_torch/workloads/_loss_kernels.py).

Here, on the CPU, against the port's formula before the kernels
(``_parent_token_nll`` below, a copy of it):

- token_nll on fp32 logits, and on bf16 logits (which it casts), is that
  formula bit for bit, values and gradients; so are the three families'
  loss_fn on the CPU, which take the plain path.
- _FusedNLL over the plain versions (what the kernels compute) against
  it: fp32 values bit for bit and gradients within fp32 rounding; bf16
  values bit for bit and gradients within one bf16 ulp, equal off the
  targets (the formula rounds dnll * p - dnll, the Function dnll * (p -
  1)). The three families' loss_fn with the Function taken on the CPU:
  every gradient within fp32 rounding.
- The vocab-parallel loss at world 2 (gloo ranks): bit for bit.
- The benchmark's fault variants' call (fp32 logits from the forward).
- ``loss.head`` and ``loss.fused_rows`` under a profiler; the C
  declarations against the argtypes; the wrappers' refusals.

On the card (marker ``card``; each test skips without a CUDA device):
the kernels against the plain versions at the cells' vocabularies (lse
within 2e-6 relative, nll within 2e-6 of max(|nll|, |lse|), since it is
lse less one logit, dlogits within one bf16 ulp), one launch of each per
train step with ``loss.fused_rows`` = B x (S - 1), and no fp32 [N, V]
tensor written anywhere in the step.

    python -m pytest tests/test_torch_loss_head.py -q           # here
    python -m pytest tests/test_torch_loss_head.py -q -m card   # card

This file imports neither jax nor the reference package.
"""

import dataclasses
import re
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from tpu_dra_torch.infra import trace
from tpu_dra_torch.workloads import _cuda, _dist
from tpu_dra_torch.workloads import _loss_kernels as lk
from tpu_dra_torch.workloads import dsv3_model, moe_model
from tpu_dra_torch.workloads import model as tm

torch.set_num_threads(2)

# The cells' vocabularies (flagship and moe_lm 32768, Moonlight's slice
# 20480) and one that is no power of two.
VOCABS = (1000, 20480, 32768)
ROWS = 6


def _parent_token_nll(model, logits, targets):
    """model.token_nll before the loss head's kernels, which its callers
    gave fp32 logits."""
    if model.tp_size == 1:
        lse = torch.logsumexp(logits, dim=-1)
        return lse - logits.gather(-1, targets[..., None])[..., 0]
    group = model.tp
    with torch.no_grad():
        peak = logits.amax(-1)
        dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=group)
    sumexp = _dist.reduce_from(torch.exp(logits - peak[..., None]).sum(-1),
                               group)
    lse = torch.log(sumexp) + peak
    cols = logits.shape[-1]
    local = targets - model.tp_index * cols
    inside = (local >= 0) & (local < cols)
    picked = logits.gather(-1, local.clamp(0, cols - 1)[..., None])[..., 0]
    target_logit = _dist.reduce_from(picked * inside, group)
    return lse - target_logit


def _parent_loss_fn(model, tokens):
    """The three families' loss_fn before the kernels: the forward's fp32
    logits, then _parent_token_nll's mean (plus the weighted aux)."""
    out = model(tokens[:, :-1])
    logits, aux = out if isinstance(out, tuple) else (out, None)
    nll = _parent_token_nll(model, logits, tokens[:, 1:]).mean()
    if isinstance(model, dsv3_model.DSV3LM):
        return nll + model.cfg.aux_weight * aux
    if isinstance(model, moe_model.MoETransformerLM):
        return nll + model.cfg.router_aux_weight * aux
    return nll


ONE_DEVICE = types.SimpleNamespace(tp_size=1)


def _logits(rows, vocab, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, vocab, generator=g) * 3
    x[1] = 60 * torch.sign(torch.randn(vocab, generator=g))   # +-60
    x[2] = 1.5                                                # all equal
    targets = torch.randint(0, vocab, (rows,), generator=g)
    targets[1] = int(x[1].argmax())
    return x.to(dtype), targets


def _value_and_grad(fn, logits, targets, dnll):
    x = logits.clone().requires_grad_()
    nll = fn(x, targets)
    grad, = torch.autograd.grad(nll, x, dnll)
    return nll.detach(), grad


def _parent(x, targets):
    return _parent_token_nll(ONE_DEVICE, x.float(), targets)


def _dnll(rows, seed=1):
    return torch.rand(rows, generator=torch.Generator().manual_seed(seed))


# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("vocab", VOCABS)
def test_token_nll_is_the_parent_formula_bit_for_bit(vocab, dtype):
    logits, targets = _logits(ROWS, vocab, dtype)
    dnll = _dnll(ROWS)
    got = _value_and_grad(lambda x, t: tm.token_nll(ONE_DEVICE, x, t),
                          logits, targets, dnll)
    want = _value_and_grad(_parent, logits, targets, dnll)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("vocab", VOCABS)
def test_fused_function_on_fp32_is_the_parent_within_rounding(vocab):
    logits, targets = _logits(ROWS, vocab, torch.float32)
    dnll = _dnll(ROWS)
    nll, grad = _value_and_grad(tm._FusedNLL.apply, logits, targets, dnll)
    want_nll, want_grad = _value_and_grad(_parent, logits, targets, dnll)
    assert torch.equal(nll, want_nll)
    assert grad.dtype == torch.float32
    # dnll * (p - 1) against dnll * p - dnll at the targets: one fp32
    # rounding of dnll apart; elsewhere the same product.
    off = torch.ones_like(grad, dtype=torch.bool)
    off[torch.arange(ROWS), targets] = False
    assert torch.equal(grad[off], want_grad[off])
    torch.testing.assert_close(grad, want_grad, rtol=0,
                               atol=2 ** -23 * float(dnll.max()))


@pytest.mark.parametrize("vocab", VOCABS)
def test_fused_function_on_bf16_is_the_parent_within_an_ulp(vocab):
    logits, targets = _logits(ROWS, vocab, torch.bfloat16)
    dnll = _dnll(ROWS)
    nll, grad = _value_and_grad(tm._FusedNLL.apply, logits, targets, dnll)
    want_nll, want_grad = _value_and_grad(_parent, logits, targets, dnll)
    assert nll.dtype == torch.float32 and torch.equal(nll, want_nll)
    assert grad.dtype == torch.bfloat16
    apart = lk.bf16_ulps_apart(grad, want_grad)
    assert int(apart.max()) <= 1
    off = torch.ones_like(apart, dtype=torch.bool)
    off[torch.arange(ROWS), targets] = False
    assert not apart[off].any()


def test_plain_versions_are_the_function_halves():
    """lse_nll_plain's lse is logsumexp of the fp32 logits; dlogits_plain
    is dnll * (softmax - onehot), summing to 0 over each row."""
    logits, targets = _logits(ROWS, 1000, torch.float32)
    lse, nll = lk.lse_nll_plain(logits, targets)
    assert torch.equal(lse, torch.logsumexp(logits, -1))
    assert torch.equal(nll, lse - logits[torch.arange(ROWS), targets])
    dnll = _dnll(ROWS)
    d = lk.dlogits_plain(logits, targets, lse, dnll)
    want = dnll[:, None] * (torch.softmax(logits.double(), -1)
                            - torch.nn.functional.one_hot(targets, 1000))
    torch.testing.assert_close(d.double(), want, rtol=0, atol=1e-6)


DENSE = tm.ModelConfig(vocab=64, d_model=32, n_heads=2, n_layers=2,
                       d_ff=64, max_seq=16, dtype=torch.float32,
                       attn_impl="flash")
MOE = moe_model.MoEModelConfig(vocab=64, d_model=32, n_heads=2, n_layers=2,
                               d_ff=64, max_seq=16, dtype=torch.float32,
                               attn_impl="flash", n_experts=4)
DSV3 = dsv3_model.DSV3Config(vocab=64, d_model=32, n_heads=2, n_layers=2,
                             d_ff=48, max_seq=16, dtype=torch.float32,
                             attn_impl="flash", moe_d_ff=16, n_routed=8,
                             experts_held=(2, 6), top_k=2)
FAMILIES = {"dense": (DENSE, tm), "moe": (MOE, moe_model),
            "dsv3": (DSV3, dsv3_model)}


def _family(name, dtype=torch.float32, seed=0):
    cfg, module = FAMILIES[name]
    cfg = dataclasses.replace(cfg, dtype=dtype)
    g = torch.Generator().manual_seed(seed)
    params = module.init_params(cfg, g, device="cpu")
    cls = {"dense": tm.TransformerLM, "moe": moe_model.MoETransformerLM,
           "dsv3": dsv3_model.DSV3LM}[name]
    return cls(cfg, params), module


def _tokens(vocab=64, seed=1):
    return torch.randint(0, vocab, (3, 17),
                         generator=torch.Generator().manual_seed(seed))


def _loss_and_grads(model, loss):
    params = list(model.parameters())
    value = loss(model, _tokens())
    return value.detach(), torch.autograd.grad(value, params)


def _fused_on_the_cpu(monkeypatch):
    """token_nll takes _FusedNLL for any tp_size-1 logits: on the CPU its
    halves are the plain versions, the kernels' arithmetic."""
    def token_nll(model, logits, targets):
        nll = tm._FusedNLL.apply(logits.reshape(-1, logits.shape[-1]),
                                 targets.reshape(-1))
        return nll.view(targets.shape)
    monkeypatch.setattr(tm, "token_nll", token_nll)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_fn_gradients_match_the_parent(family, fused, monkeypatch):
    """The CPU path is the parent's bit for bit; the fused Function's
    gradients are within fp32 rounding of it (4e-6 of each leaf's
    largest; measured 2.4e-7 to 4.7e-7). 48 trained tokens make dnll =
    1/48, whose products round: at 1/32 both forms are exact."""
    model, module = _family(family)
    want_loss, want = _loss_and_grads(model, _parent_loss_fn)
    if fused:
        _fused_on_the_cpu(monkeypatch)
    loss, grads = _loss_and_grads(model, module.loss_fn)
    assert torch.equal(loss, want_loss)
    for g, w in zip(grads, want):
        if not fused:
            assert torch.equal(g, w)
        else:
            torch.testing.assert_close(
                g, w, rtol=0, atol=4e-6 * float(w.abs().max()))


def test_forward_still_returns_fp32_logits():
    for family in FAMILIES:
        model, _ = _family(family, dtype=torch.bfloat16)
        out = model(_tokens()[:, :-1])
        logits = out[0] if isinstance(out, tuple) else out
        assert logits.dtype == torch.float32, family
        x, _ = model.trunk(_tokens()[:, :-1])
        assert model.head(x).dtype == torch.bfloat16, family
        assert torch.equal(model.head(x).float(), logits), family


def test_benchmark_fault_variants_call_token_nll_on_fp32_logits():
    """portbench's fault variants take the forward's fp32 logits to
    token_nll per token; the parent's formula bit for bit."""
    from portbench.models import transformer_lm as bench_dense

    model, _ = _family("dense")
    tokens = _tokens()
    per_token, extra = bench_dense._dense_terms(model, tokens)
    logits = model(tokens[:, :-1])
    assert logits.dtype == torch.float32 and extra == 0.0
    assert torch.equal(per_token,
                       _parent_token_nll(model, logits, tokens[:, 1:]))
    half = bench_dense.half_batch(bench_dense._dense_terms)(model, tokens)
    flat = per_token.reshape(-1)
    assert torch.equal(half, flat[:flat.numel() // 2].mean())


@pytest.fixture(autouse=True)
def _no_counts_left():
    trace.read_counters()
    yield
    trace.read_counters()


def test_fused_rows_count_under_a_profiler(monkeypatch):
    model, module = _family("dense")
    step = tm.build_train_step(model, 1e-2, module.loss_fn)
    step(_tokens())
    assert trace.read_counters() == {}          # nothing recorded
    _fused_on_the_cpu(monkeypatch)
    step(_tokens())
    assert trace.read_counters() == {}          # no profiler: no count
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(_tokens())
    assert trace.read_counters() == {"loss.fused_rows": 3 * 16}
    heads = [e for e in prof.events() if e.name == "loss.head"]
    assert len(heads) == 1


def test_plain_path_counts_no_rows_and_no_kernel():
    _cuda.reset_launches()
    model, module = _family("dense", dtype=torch.bfloat16)
    with profile(activities=[ProfilerActivity.CPU]):
        tm.build_train_step(model, 1e-2, module.loss_fn)(_tokens())
    assert "loss.fused_rows" not in trace.read_counters()
    assert not any(_cuda.launches()[e] for e in lk.ARGTYPES)


@pytest.mark.parametrize("entry", list(lk.ARGTYPES))
def test_c_declaration_matches_argtypes(entry):
    """Each entry point of csrc/loss_head.cu takes what its declared
    argtypes say, and the build loads it with them."""
    source = (_cuda.CSRC / "loss_head.cu").read_text()
    decl = re.search(rf'extern "C" int {entry}\((.*?)\)\s*\{{', source,
                     re.S).group(1)
    kinds = {"void*": _cuda.PTR, "int": _cuda.INT}
    got = [kinds[p.strip().rsplit(" ", 1)[0].removeprefix("const ")]
           for p in decl.split(",")]
    assert got == lk.ARGTYPES[entry]
    assert _cuda.ENTRY_POINTS["loss_head"][entry] == got
    assert set(re.findall(r'extern "C" int (\w+)\(', source)) == set(
        lk.ARGTYPES)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    t = torch.zeros(4, dtype=torch.long)
    with pytest.raises(TypeError, match="bfloat16"):
        lk._rows(torch.zeros(4, 8, dtype=torch.float16), t)
    with pytest.raises(ValueError, match="multiple of 8"):
        lk._rows(torch.zeros(4, 12, dtype=torch.bfloat16), t)
    with pytest.raises(ValueError, match="targets of shape"):
        lk._rows(torch.zeros(4, 8, dtype=torch.bfloat16), t[:3])
    with pytest.raises(ValueError, match="per-row vector"):
        lk._rows_vector(torch.zeros(4, 1), 4)
    # A 2-byte offset into a bf16 buffer: rows off 16-byte boundaries.
    with pytest.raises(ValueError, match="16-byte boundary"):
        lk._rows(torch.zeros(33, 8, dtype=torch.bfloat16).view(-1)[1:257]
                 .view(32, 8), torch.zeros(32, dtype=torch.long))


# ---------------------------------------------------------------------------
# The vocab-parallel loss at world 2 (gloo ranks)
# ---------------------------------------------------------------------------

WORLD = 2
TP_CFG = dict(vocab=128, d_model=64, n_heads=4, n_layers=2, d_ff=128,
              max_seq=32)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def pool():
    with _dist.RankPool([torch.device("cpu")] * WORLD, timeout_s=120) as p:
        yield p


def _vocab_parallel_task(dtype, tokens):
    """One 'model' rank of a (1, 2) mesh: token_nll on this rank's vocab
    shard of logits, and a train step's loss and gradients, each against
    the parent's form."""
    devices = np.empty(WORLD, dtype=object)
    devices[:] = [torch.device("cpu")] * WORLD
    mesh = _dist.Mesh(devices.reshape(1, WORLD), ("data", "model"))
    cfg = tm.ModelConfig(**TP_CFG, dtype=DTYPES[dtype])
    full = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    model = tm.TransformerLM(cfg, tm.shard_params(full, mesh, cfg), mesh)
    tokens = torch.from_numpy(tokens)
    g = torch.Generator().manual_seed(5)
    shard = torch.randn(4, 31, cfg.vocab // WORLD, generator=g)
    shard = shard.to(cfg.dtype)
    targets = tokens[:, 1:]
    got = _value_and_grad(lambda x, t: tm.token_nll(model, x, t), shard,
                          targets, torch.ones(4, 31))
    want = _value_and_grad(
        lambda x, t: _parent_token_nll(model, x.float(), t), shard,
        targets, torch.ones(4, 31))
    params = list(model.parameters())
    loss = tm.loss_fn(model, tokens)
    grads = torch.autograd.grad(loss, params)
    parent_loss = _parent_loss_fn(model, tokens)
    parent_grads = torch.autograd.grad(parent_loss, params)

    def apart(a, b):   # (elements that differ, the largest difference)
        d = (a.float() - b.float()).abs()
        return int((a != b).sum()), float(d.max()) if d.numel() else 0.0
    return {
        "nll": apart(*got[:1], *want[:1]), "dlogits": apart(got[1], want[1]),
        "loss": apart(loss, parent_loss),
        "grads": max(apart(a, b) for a, b in zip(grads, parent_grads)),
        "fused_rows": trace.read_counters().get("loss.fused_rows"),
    }


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_vocab_parallel_loss_is_the_parent_bit_for_bit(pool, dtype):
    tokens = np.random.default_rng(3).integers(
        0, TP_CFG["vocab"], (4, 32)).astype(np.int64)
    for rank in pool.run(_vocab_parallel_task, dtype, tokens):
        assert rank == {"nll": (0, 0.0), "dlogits": (0, 0.0),
                        "loss": (0, 0.0), "grads": (0, 0.0),
                        "fused_rows": None}


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m card on the card)")
    return torch.device("cuda")


def _card_logits(rows, vocab, seed):
    """bf16 rows of N(0, 3^2) logits; row 1 at +-60, row 2 all equal, row
    3 uniform in [-60, 60] (its exponentials run into fp32's subnormals),
    row 4 all -60; random targets, row 1's at its largest logit."""
    x, targets = _logits(rows, vocab, torch.float32, seed)
    g = torch.Generator().manual_seed(seed + 1)
    x[3] = torch.rand(vocab, generator=g) * 120 - 60
    x[4] = -60.0
    return x.bfloat16(), targets


@pytest.mark.card
@pytest.mark.parametrize("vocab", [32768, 20480])
def test_kernels_match_plain(vocab, cuda_device):
    rows = 300
    logits, targets = _card_logits(rows, vocab, seed=vocab)
    logits, targets = logits.to(cuda_device), targets.to(cuda_device)
    dnll = (torch.rand(rows, generator=torch.Generator().manual_seed(2))
            + 0.5).to(cuda_device)
    _cuda.reset_launches()
    lse, nll = lk.lse_nll(logits, targets)
    d = lk.dlogits(logits, targets, lse, dnll)
    torch.cuda.synchronize()
    assert {e: _cuda.launches()[e] for e in lk.ARGTYPES} == {
        "loss_lse_nll": 1, "loss_dlogits": 1}
    want_lse, want_nll = lk.lse_nll_plain(logits, targets)
    assert lse.dtype == nll.dtype == torch.float32
    assert ((lse - want_lse).abs() <= 2e-6 * want_lse.abs()).all()
    scale = torch.maximum(want_nll.abs(), want_lse.abs())
    assert ((nll - want_nll).abs() <= 2e-6 * scale).all()
    want_d = lk.dlogits_plain(logits, targets, lse, dnll)
    assert d.dtype == torch.bfloat16 and d.shape == logits.shape
    assert int(lk.bf16_ulps_apart(d, want_d).max()) <= 1
    # Every row's gradient sums to ~0 (softmax less one-hot).
    assert float(d.float().sum(-1).abs().max()) < 1e-2


def _card_family(name, cuda_device):
    # d_ff 1024: no activation of the dense model has N x V elements.
    cfg = {"dense": tm.ModelConfig(vocab=512, d_model=256, n_heads=2,
                                   n_layers=2, d_ff=1024, max_seq=256),
           "moe": moe_model.MoEModelConfig(vocab=512, d_model=256,
                                           n_heads=2, n_layers=4, d_ff=512,
                                           max_seq=256, n_experts=4)}[name]
    module = {"dense": tm, "moe": moe_model}[name]
    cls = {"dense": tm.TransformerLM, "moe": moe_model.MoETransformerLM}
    params = module.init_params(
        cfg, torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    step = module.make_train_step(cls[name](cfg, params))
    g = torch.Generator(device=cuda_device).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (4, cfg.max_seq), generator=g,
                           device=cuda_device)
    return cfg, step, tokens


@pytest.mark.card
@pytest.mark.parametrize("family", ["dense", "moe"])
def test_step_launches_each_kernel_once_and_counts_its_rows(family,
                                                            cuda_device):
    cfg, step, tokens = _card_family(family, cuda_device)
    step(tokens)              # the first call builds and caches
    torch.cuda.synchronize()
    _cuda.reset_launches()
    with profile(activities=[ProfilerActivity.CPU]):
        loss = step(tokens)
        torch.cuda.synchronize()
    assert torch.isfinite(loss).item()
    assert {e: _cuda.launches()[e] for e in lk.ARGTYPES} == {
        "loss_lse_nll": 1, "loss_dlogits": 1}
    assert trace.read_counters()["loss.fused_rows"] == 4 * (cfg.max_seq - 1)


class _Outputs(TorchDispatchMode):
    """(op, dtype, numel) of every tensor every op outputs."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.seen += [(str(func), t.dtype, t.numel()) for t in
                      tree_leaves(out) if isinstance(t, torch.Tensor)]
        return out


@pytest.mark.card
def test_step_writes_no_fp32_logits_sized_tensor(cuda_device):
    cfg, step, tokens = _card_family("dense", cuda_device)
    step(tokens)
    torch.cuda.synchronize()
    n_by_v = tokens.shape[0] * (tokens.shape[1] - 1) * cfg.vocab
    # Control: the plain form writes one (its fp32 cast at the least).
    logits = torch.zeros(tokens.shape[0] * (tokens.shape[1] - 1), cfg.vocab,
                         dtype=torch.bfloat16, device=cuda_device)
    with _Outputs() as control:
        lk.lse_nll_plain(logits, tokens[:, 1:].reshape(-1))
    assert (torch.float32, n_by_v) in {(d, n) for _, d, n in control.seen}
    with _Outputs() as log:
        step(tokens)
        torch.cuda.synchronize()
    # The log holds the backward too: the bf16 dlogits' allocation.
    assert ("aten.empty_like.default", torch.bfloat16, n_by_v) in log.seen
    big = [op for op, d, n in log.seen
           if d == torch.float32 and n == n_by_v]
    assert not big, big
