"""The MoE FFN's routing and row-copy kernels (csrc/moe_route.cu, through
tpu_dra_torch/workloads/_moe_kernels.py).

Here, on the CPU: the plain versions against loops written out token by
token, the wrappers' refusals, the C declarations against the argtypes,
and the kernel modules' independence (none imports another). On
the card (marker ``card``; each test skips without a CUDA device): the
kernels against the plain versions — route's five outputs and the top-1
dispatch and combine (forward, dx, d(out_buf)) bit for bit, the gate's
gradient within fp32 rounding — and a MoE LM train step that launches
them with no host synchronisation.

    python -m pytest tests/test_torch_moe_kernels.py -q           # here
    python -m pytest tests/test_torch_moe_kernels.py -q -m card   # card

This file imports neither jax nor the reference package.
"""

import ast
import re
import subprocess
import sys

import pytest
import torch

from tpu_dra_torch.workloads import _cuda
from tpu_dra_torch.workloads import _moe_kernels as mk
from tpu_dra_torch.workloads import moe

torch.set_num_threads(2)

# The MoE LM cell's routing: B8 x S1024 tokens, 8 experts, capacity
# factor 1.25.
T_CELL, E_CELL = 8 * 1024, 8
C_CELL = moe.capacity_of(1.25, T_CELL, E_CELL)


def _moe_launches(**counts):
    """Every MoE entry point's launch count: `counts`, zero elsewhere."""
    return {**dict.fromkeys(mk.ARGTYPES, 0), **counts}


def _read_moe_launches():
    launches = _cuda.launches()
    return {name: launches[name] for name in mk.ARGTYPES}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)


def _experts(t, n_experts, seed):
    """Skewed expert ids: expert e drawn with weight e + 1."""
    g = torch.Generator().manual_seed(seed)
    weights = torch.arange(1, n_experts + 1, dtype=torch.float)
    return torch.multinomial(weights, t, replacement=True, generator=g)


def _route_loop(expert, offset, capacity, lo, hi):
    """route's outputs, one token at a time."""
    n_experts = len(offset)
    seen = list(offset)
    pos, slot = [], []
    token_of_slot = [-1] * ((hi - lo) * capacity)
    for t, e in enumerate(expert):
        pos.append(seen[e])
        kept = lo <= e < hi and seen[e] < capacity
        slot.append((e - lo) * capacity + seen[e] if kept else -1)
        if kept:
            token_of_slot[slot[-1]] = t
        seen[e] += 1
    counts = [seen[e] - offset[e] for e in range(n_experts)]
    kept = [sum(p < capacity for p in pos)]
    return pos, slot, token_of_slot, counts, kept


# (tokens, experts, capacity, offset seed or None, this rank's experts)
ROUTE_CASES = {
    "cell": (T_CELL, E_CELL, C_CELL, None, (0, E_CELL)),
    "ragged": (3 * 8192 + 777, E_CELL, 3000, None, (0, E_CELL)),
    "small": (1000, 4, 150, None, (0, 4)),
    "offset": (T_CELL, E_CELL, C_CELL, 5, (0, E_CELL)),
    "ep_rank": (T_CELL, E_CELL, C_CELL, None, (2, 4)),
    "offset_ep_rank": (5000, E_CELL, 900, 7, (6, 8)),
}


def _route_inputs(case, seed=0):
    t, n_experts, capacity, offset_seed, (lo, hi) = ROUTE_CASES[case]
    expert = _experts(t, n_experts, seed)
    offset = torch.zeros(n_experts, dtype=torch.int32)
    if offset_seed is not None:
        g = torch.Generator().manual_seed(offset_seed)
        offset = torch.randint(0, capacity, (n_experts,), generator=g,
                               dtype=torch.int32)
    return expert, offset, capacity, lo, hi


@pytest.mark.parametrize("case", ["small", "offset_ep_rank", "ep_rank"])
def test_route_plain_matches_a_loop(case):
    expert, offset, capacity, lo, hi = _route_inputs(case)
    got = mk.route_plain(expert, offset, capacity, lo, hi)
    want = _route_loop(expert.tolist(), offset.tolist(), capacity, lo, hi)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert g.tolist() == w


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_gather_rows_plain_rounds_once(dtype):
    g = torch.Generator().manual_seed(1)
    src = torch.randn(6, 16, generator=g).to(dtype)
    idx = torch.tensor([3, -1, 0, 5, -1, 3, 2], dtype=torch.int32)
    scale = torch.rand(7, generator=g)
    copy = mk.gather_rows_plain(src, idx)
    scaled = mk.gather_rows_plain(src, idx, scale)
    for i, j in enumerate(idx.tolist()):
        if j < 0:
            for out in (copy, scaled):
                assert not out[i].any()
            continue
        assert torch.equal(copy[i], src[j])
        assert torch.equal(scaled[i], (src[j].float() * scale[i]).to(dtype))
    # The top-1 combine and its gate's gradient: the k-way sum and the
    # pair dot at k = 1.
    assert torch.equal(mk.combine_rows_plain(src, idx, scale, 1), scaled)
    dots = mk.pair_dot_plain(scaled, src, idx, 1)
    for i, j in enumerate(idx.tolist()):
        want = 0.0 if j < 0 else float((scaled[i].double()
                                        * src[j].double()).sum())
        assert dots[i].item() == pytest.approx(want, rel=1e-5, abs=1e-6)


@pytest.mark.parametrize("entry", list(mk.ARGTYPES))
def test_c_declaration_matches_argtypes(entry):
    """Each entry point of csrc/moe_route.cu takes what its declared
    argtypes say, and the build loads it with them."""
    source = (_cuda.CSRC / "moe_route.cu").read_text()
    decl = re.search(rf'extern "C" int {entry}\((.*?)\)\s*\{{', source,
                     re.S).group(1)
    kinds = {"void*": _cuda.PTR, "int": _cuda.INT}
    got = [kinds[p.strip().rsplit(" ", 1)[0].removeprefix("const ")]
           for p in decl.split(",")]
    assert got == mk.ARGTYPES[entry]
    assert _cuda.ENTRY_POINTS["moe_route"][entry] == got
    assert set(re.findall(r'extern "C" int (\w+)\(', source)) == set(
        mk.ARGTYPES)


KERNEL_MODULES = ("_flash_kernels", "_moe_kernels", "_loss_kernels")


@pytest.mark.parametrize("module", KERNEL_MODULES)
def test_kernel_modules_do_not_import_each_other(module):
    """Each kernel module sits on _cuda alone: importing it loads none of
    the other kernel modules nor anything that does, and its source names
    none of the others' names."""
    others = sorted(set(KERNEL_MODULES) - {module})
    code = (f"import sys, tpu_dra_torch.workloads.{module}; "
            f"print(any('tpu_dra_torch.workloads.' + m in sys.modules "
            f"for m in {others!r}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.strip() == "False"
    tree = ast.parse((_cuda.CSRC.parent / f"{module}.py").read_text())
    names = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    names |= {a.name.rsplit(".", 1)[-1] for n in ast.walk(tree)
              if isinstance(n, (ast.Import, ast.ImportFrom))
              for a in n.names}
    names |= {n.module.rsplit(".", 1)[-1] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert not names & set(others)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="experts"):
        mk.route(torch.zeros(4, dtype=torch.long),
                 torch.zeros(4, dtype=torch.int32), 2, 2, 5)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        mk._rows(torch.zeros(4, 8, dtype=torch.float16))
    with pytest.raises(ValueError, match="multiple of 8"):
        mk._rows(torch.zeros(4, 12))
    with pytest.raises(ValueError, match="index of shape"):
        mk._index(torch.zeros(3, 2, dtype=torch.int32), 3)


def test_cpu_path_counts_no_kernel():
    _cuda.reset_launches()
    expert, offset, capacity, lo, hi = _route_inputs("small")
    _, slot, token_of_slot, _, _ = mk.route(expert, offset, capacity, lo,
                                            hi)
    x = torch.randn(len(expert), 8)
    mk.gather_rows(x, token_of_slot)
    mk.combine_rows(x, slot, None, 1)
    mk.pair_dot(x, x, slot, 1)
    assert _read_moe_launches() == _moe_launches()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.card
@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_route_kernel_matches_plain(case, cuda_device):
    expert, offset, capacity, lo, hi = _route_inputs(case, seed=11)
    want = mk.route_plain(expert, offset, capacity, lo, hi)
    _cuda.reset_launches()
    got = mk.route(expert.to(cuda_device), offset.to(cuda_device), capacity,
                   lo, hi)
    torch.cuda.synchronize()
    assert _cuda.launches()["moe_route"] == 1
    for name, g, w in zip(("pos", "slot", "token_of_slot", "counts", "kept"),
                          got, want):
        assert g.dtype == torch.int32 and g.is_cuda, name
        assert torch.equal(g.cpu(), w), name


def _dispatch_and_combine(x, out_buf, gate, slot, token_of_slot, dbuf, dout):
    """Forward and backward of the dispatch and combine Functions as the
    top-1 layer calls them (k = 1, the gate rounded to the rows' dtype in
    the forward)."""
    x, out_buf, gate = (t.clone().requires_grad_()
                        for t in (x, out_buf, gate))
    scale, gate_of_slot = moe.top1_scales(gate, token_of_slot, out_buf.dtype)
    buf = moe._Dispatch.apply(x, token_of_slot, slot, 1)
    out = moe._Combine.apply(out_buf, gate, scale, slot, token_of_slot,
                             gate_of_slot, 1)
    dx, = torch.autograd.grad(buf, x, dbuf)
    d_buf, d_gate = torch.autograd.grad(out, [out_buf, gate], dout)
    return buf, out, dx, d_buf, d_gate


@pytest.mark.card
@pytest.mark.parametrize("d", [2048, 136])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_dispatch_and_combine_match_plain(dtype, d, cuda_device):
    """The cell's routing (D 2048) and a D that is not a whole number of
    a warp's 16-byte loads (136)."""
    expert, offset, capacity, lo, hi = _route_inputs("cell", seed=12)
    _, slot, token_of_slot, _, _ = mk.route_plain(expert, offset, capacity,
                                                  lo, hi)
    g = torch.Generator().manual_seed(13)
    n_slots = token_of_slot.numel()
    x, dout = (torch.randn(T_CELL, d, generator=g).to(dtype)
               for _ in range(2))
    out_buf, dbuf = (torch.randn(n_slots, d, generator=g).to(dtype)
                     for _ in range(2))
    gate = torch.rand(T_CELL, generator=g)
    args = (x, out_buf, gate, slot, token_of_slot, dbuf, dout)
    want = _dispatch_and_combine(*args)
    _cuda.reset_launches()
    got = _dispatch_and_combine(*(t.to(cuda_device) for t in args))
    torch.cuda.synchronize()
    assert _read_moe_launches() == _moe_launches(
        moe_gather_rows=2, moe_combine_rows=2, moe_pair_dot=1)
    for name, g_, w in zip(("buf", "out", "dx", "d_out_buf"), got, want):
        assert g_.dtype == dtype and torch.equal(g_.cpu(), w), name
    d_gate, want_gate = got[4].cpu(), want[4]
    assert d_gate.dtype == torch.float32
    assert not d_gate[slot < 0].any()
    # fp32 sums of D products in two orders.
    tol = 1e-5 * float(want_gate.abs().max())
    torch.testing.assert_close(d_gate, want_gate, rtol=1e-5, atol=tol)


@pytest.mark.card
def test_moe_lm_step_runs_the_kernels_without_a_host_sync(cuda_device):
    from tpu_dra_torch.workloads import moe_model

    cfg = moe_model.MoEModelConfig(vocab=512, d_model=256, n_heads=2,
                                   n_layers=4, d_ff=512, max_seq=256,
                                   n_experts=4)
    params = moe_model.init_params(
        cfg, torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    step = moe_model.make_train_step(moe_model.MoETransformerLM(cfg, params))
    g = torch.Generator(device=cuda_device).manual_seed(1)
    tokens = [torch.randint(0, cfg.vocab, (4, cfg.max_seq), generator=g,
                            device=cuda_device) for _ in range(2)]
    step(tokens[0])            # the first call builds and caches
    torch.cuda.synchronize()
    _cuda.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = step(tokens[1])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(loss).item()
    n_moe = sum(cfg.is_moe_block(i) for i in range(cfg.n_layers))
    # Per MoE block: the route; the dispatch and the combine's backward
    # (gathers); the combine and the dispatch's backward (k-way sums at
    # k = 1); the gate's gradient.
    assert _read_moe_launches() == _moe_launches(
        moe_route=n_moe, moe_gather_rows=2 * n_moe,
        moe_combine_rows=2 * n_moe, moe_pair_dot=n_moe)
