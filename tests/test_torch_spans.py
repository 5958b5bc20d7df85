"""The port's device plane (tpu_dra_torch.infra.trace: device_span,
count, read_counters) and the ranges and counters of its train step, on
the CPU under torch.profiler's CPU activity.

- Off (no profiler session), a range is the one shared no-op context
  and a count records nothing.
- Under the profiler, a tiny dense step, a tiny MoE step, a tiny
  DeepSeek-V3-family step and a tiny MiMo-V2-Flash-family step open
  every range of DEVICE_SPANS that their
  paths reach, nested as the step nests them (the MoE dispatch and
  combine once more in the backward), and route_top1 and route_topk
  count what their own outputs hold.
- Profiling changes no number: the loss and every updated parameter are
  bit-identical with and without it.
"""

import collections
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpu_dra_torch.infra import trace
from tpu_dra_torch.workloads import model as tm
from tpu_dra_torch.workloads import dsv3_model, mimo_model, moe, moe_model

torch.set_num_threads(2)   # the suite runs 6 workers beside timing tests

ROOT = Path(__file__).resolve().parents[1]
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
MIMO = mimo_model.MiMoConfig(vocab=64, d_model=32, n_heads=4, n_layers=2,
                             d_ff=48, max_seq=16, dtype=torch.float32,
                             attn_impl="flash", n_kv_heads=2, swa_kv_heads=2,
                             qk_head_dim=16, v_head_dim=8, rope_dims=8,
                             window=4, hybrid_pattern=(0, 1), moe_d_ff=16,
                             n_routed=8, experts_held=(2, 6), top_k=2)
# Range -> the range that directly holds it in a step.
PARENT = {
    "step.forward": "step", "step.backward": "step", "step.sgd": "step",
    "attention.fwd": "step.forward", "attention.bwd": "step.backward",
    "moe.route": "step.forward", "moe.dispatch": "step.forward",
    "moe.experts": "step.forward", "moe.combine": "step.forward",
    "mla.project": "step.forward", "moe.shared": "step.forward",
    "loss.head": "step.forward", "attention.window": "step.forward",
}
MOE_SPANS = {"moe.route", "moe.dispatch", "moe.experts", "moe.combine"}
# Ranges only the DeepSeek-V3 family opens (MLA's projections, the shared
# expert).
DSV3_SPANS = {"mla.project", "moe.shared"}
# Ranges only the MiMo-V2-Flash family opens (a window layer's attention,
# which holds its attention.fwd).
MIMO_SPANS = {"attention.window"}
# Ranges only the Kimi Linear family opens (a KDA layer's mixing).
KIMI_SPANS = {"attention.kda"}
# Ranges that their autograd Function's backward opens again, inside
# step.backward.
IN_BACKWARD_TOO = {"moe.dispatch", "moe.combine"}


@pytest.fixture(autouse=True)
def _no_counts_left():
    trace.read_counters()
    yield
    trace.read_counters()


def _model(cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    if isinstance(cfg, mimo_model.MiMoConfig):
        return mimo_model.MiMoLM(
            cfg, mimo_model.init_params(cfg, g, device="cpu"))
    if isinstance(cfg, dsv3_model.DSV3Config):
        return dsv3_model.DSV3LM(
            cfg, dsv3_model.init_params(cfg, g, device="cpu"))
    if isinstance(cfg, moe_model.MoEModelConfig):
        return moe_model.MoETransformerLM(
            cfg, moe_model.init_params(cfg, g, device="cpu"))
    return tm.TransformerLM(cfg, tm.init_params(cfg, g, device="cpu"))


def _step(model):
    if isinstance(model, mimo_model.MiMoLM):
        return mimo_model.make_train_step(model, lr=1e-2)
    if isinstance(model, dsv3_model.DSV3LM):
        return dsv3_model.make_train_step(model, lr=1e-2)
    if isinstance(model, moe_model.MoETransformerLM):
        return moe_model.make_train_step(model, lr=1e-2)
    return tm.make_train_step(model, lr=1e-2)


def _tokens(seed=1):
    return torch.randint(0, 64, (2, 17),
                         generator=torch.Generator().manual_seed(seed))


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.events()


def _ranges(events):
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in events if e.name in trace.DEVICE_SPANS)


def _holder(ranges, inner):
    """The innermost range that holds `inner` in time (not itself)."""
    best = None
    for r in ranges:
        if r is inner or not (r[0] <= inner[0] and inner[1] <= r[1]):
            continue
        if best is None or r[0] >= best[0]:
            best = r
    return best


class TestOff:
    def test_span_is_the_shared_noop(self):
        assert not trace.recording()
        spans = [trace.device_span(name) for name in trace.DEVICE_SPANS]
        spans.append(trace.device_span("step", 7))
        assert all(s is trace._NO_SPAN for s in spans)
        with trace.device_span("step.forward") as inside:
            assert inside is None

    def test_count_records_nothing(self):
        trace.count("moe.kept", torch.tensor(5))
        trace.count("moe.slots", 40)
        assert trace.read_counters() == {}

    def test_a_step_counts_nothing(self):
        _step(_model(MOE))(_tokens())
        assert trace.read_counters() == {}

    def test_module_does_not_import_torch(self):
        code = ("import sys; import tpu_dra_torch.infra.trace as t; "
                "assert not t.recording(); "
                "assert t.device_span('step') is t._NO_SPAN; "
                "assert 'torch' not in sys.modules, 'torch imported'")
        proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                              capture_output=True, text=True, timeout=60)
        assert proc.returncode == 0, proc.stderr


class TestCounters:
    def test_tensor_and_int_counts_then_reset(self):
        counters = trace.DeviceCounters()
        counters.add("moe.kept", torch.tensor(3))
        counters.add("moe.kept", torch.tensor([2.0, 4.0]).sum())
        counters.add("moe.slots", 10)
        counters.add("moe.slots", 6)
        assert counters.read() == {"moe.kept": 9.0, "moe.slots": 16}
        assert counters.read() == {}
        counters.add("moe.routed", torch.tensor(1))
        counters.add("moe.kept", torch.tensor(0))
        assert counters.read() == {"moe.routed": 1.0, "moe.kept": 0.0}

    def test_unknown_names_raise(self):
        with pytest.raises(ValueError, match="unknown counter"):
            trace.DeviceCounters().add("moe.nope", 1)
        with profile(activities=[ProfilerActivity.CPU]):
            assert trace.recording()
            with pytest.raises(ValueError, match="unknown device span"):
                trace.device_span("step.nope")
        assert not trace.recording()

    def test_route_counts_its_own_outputs(self):
        g = torch.Generator().manual_seed(3)
        x = torch.randn(2, 24, 16, generator=g)
        router = torch.randn(16, 4, generator=g)
        capacity = moe.capacity_of(1.0, 48, 4)
        route, _ = _profiled(
            lambda: moe.route_top1(x, router, 4, capacity))
        counts = trace.read_counters()
        assert counts["moe.kept"] == (route.slot >= 0).sum().item()
        assert counts["moe.kept"] == (route.token_of_slot >= 0).sum().item()
        assert 0 < counts["moe.kept"] < 48     # capacity 12 drops some
        assert counts["moe.slots"] == 4 * capacity
        assert counts["moe.routed"] == 48
        assert trace.read_counters() == {}


class TestRangesInTheStep:
    @pytest.mark.parametrize("cfg", [DENSE, MOE, DSV3, MIMO],
                             ids=["dense", "moe", "dsv3", "mimo"])
    def test_every_range_nested_as_the_step(self, cfg):
        step = _step(_model(cfg))
        step(_tokens())
        _, events = _profiled(lambda: step(_tokens(2)))
        ranges = _ranges(events)
        want = set(trace.DEVICE_SPANS)
        if cfg is not DSV3:
            want -= DSV3_SPANS
        if cfg is not MIMO:
            want -= MIMO_SPANS
        want -= KIMI_SPANS
        if cfg is DENSE:
            want -= MOE_SPANS
        assert {name for _, _, name in ranges} == want
        steps = [r for r in ranges if r[2] == "step"]
        assert len(steps) == 1
        held = collections.Counter()   # (range, its holder) -> count
        for r in ranges:
            holder = _holder(ranges, r)
            if r[2] == "step":
                assert holder is None
                continue
            in_window = (r[2], holder[2]) == ("attention.fwd",
                                              "attention.window")
            if not (r[2] in IN_BACKWARD_TOO and holder[2] == "step.backward"
                    or in_window):
                assert holder[2] == PARENT[r[2]], r
            held[r[2], holder[2]] += 1
        n_window = sum(cfg.hybrid_pattern) if cfg is MIMO else 0
        assert held["attention.fwd", "attention.window"] == n_window
        assert held["attention.window", "step.forward"] == n_window
        assert held["attention.fwd", "step.forward"] == cfg.n_layers - n_window
        assert held["attention.bwd", "step.backward"] == cfg.n_layers
        assert held["loss.head", "step.forward"] == 1
        if cfg is not DENSE:
            n_moe = sum(cfg.is_moe_block(i) for i in range(cfg.n_layers))
            assert all(held[n, "step.forward"] == n_moe for n in MOE_SPANS)
            assert all(held[n, "step.backward"] == n_moe
                       for n in IN_BACKWARD_TOO)
        if cfg is DSV3:
            assert held["mla.project", "step.forward"] == cfg.n_layers
            assert held["moe.shared", "step.forward"] == n_moe

    def test_step_range_carries_its_count(self):
        step = _step(_model(DENSE))
        step(_tokens())
        with profile(activities=[ProfilerActivity.CPU],
                     record_shapes=True) as prof:
            step(_tokens())
            step(_tokens(2))
        args = [e.kwinputs.get("arg") for e in
                sorted(prof.events(), key=lambda e: e.time_range.start)
                if e.name == "step"]
        assert args == [1, 2]

    def test_ranges_are_function_scope(self, tmp_path):
        # A user-scope range (torch.profiler.record_function) is mirrored
        # on the device's timeline as one more device operation; the
        # port's ranges are function scope and have no mirror.
        step = _step(_model(MOE))
        step(_tokens())
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            step(_tokens())
        prof.export_chrome_trace(str(tmp_path / "t.json"))
        events = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
        cats = {e["cat"] for e in events if e.get("name") in
                trace.DEVICE_SPANS}
        assert cats == {"cpu_op"}

    def test_moe_step_counts_its_routes(self):
        step = _step(_model(MOE))
        _profiled(lambda: step(_tokens()))
        counts = trace.read_counters()
        tokens = 2 * 16
        capacity = moe.capacity_of(MOE.capacity_factor, tokens,
                                   MOE.n_experts)
        assert counts["moe.routed"] == tokens
        assert counts["moe.slots"] == MOE.n_experts * capacity
        assert 0 < counts["moe.kept"] <= tokens

    def test_dsv3_step_counts_its_routes(self):
        """moe.assigned is every held (token, k) pair: nothing dropped."""
        model = _model(DSV3)
        step = _step(model)
        tokens = _tokens()
        block = model.blocks[1]
        with torch.no_grad():
            x = model.embed_tokens(tokens[:, :-1])
            x = model.blocks[0](x)[0]
            x = x + dsv3_model.mla(DSV3, dict(block.attn.named_parameters()),
                                   tm._rmsnorm(x, block.ln1_scale, 1e-5))
            h = tm._rmsnorm(x, block.ln2_scale, 1e-5)
            chosen = torch.topk(torch.sigmoid(h @ block.moe.router)
                                + block.moe.bias, DSV3.top_k, -1).indices
        held = chosen.ge(2) & chosen.lt(6)
        loads = torch.bincount(chosen[held], minlength=8)
        _profiled(lambda: step(tokens))
        counts = trace.read_counters()
        assert counts["moe.routed"] == 2 * 16
        assert counts["moe.assigned"] == held.sum().item()
        assert counts["moe.load_max"] == loads.max().item()
        assert counts["moe.tokens_held"] == held.any(-1).sum().item()
        # The widths the benchmark's MoE readers need: experts held,
        # pairs selected and the bytes of a row, per route call.
        assert counts["moe.held"] == 4
        assert counts["moe.selected"] == 2 * 16 * DSV3.top_k
        assert counts["moe.row_bytes"] == (DSV3.d_model
                                           * DSV3.dtype.itemsize)
        assert "moe.kept" not in counts and "moe.slots" not in counts

    @pytest.mark.parametrize("cfg", [DENSE, MOE, DSV3],
                             ids=["dense", "moe", "dsv3"])
    def test_profiling_changes_no_number(self, cfg):
        plain, traced = _model(cfg), _model(cfg)
        loss_plain = _step(plain)(_tokens())
        loss_traced, _ = _profiled(lambda: _step(traced)(_tokens()))
        assert torch.equal(loss_plain, loss_traced)
        for (name, a), (_, b) in zip(plain.named_parameters(),
                                     traced.named_parameters()):
            assert torch.equal(a, b), name
