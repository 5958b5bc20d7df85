"""The readers of the port's ranges and counters (portbench/ranges.py's
attribution rule) on traces whose answers are known, ``ranges.from_events``
on synthetic profiler events, and CPU-profiler runs of tiny steps that the
readers trace back to their live session.

The six readers that came before the ranges read the same values from
the same events whether or not the program opened its ranges: the
port's ranges are host events only (function scope, no device-side
mirror), so ``trace.from_profile`` lists the same device operations."""

import types

import pytest
import torch
from torch.autograd import DeviceType

from portbench import ranges, spec
from portbench.ranges import BACKWARD_NODE, open_at
from portbench.trace import STEP_RANGE, TraceRun, from_profile

H100 = "NVIDIA H100 80GB HBM3"
OLD_READERS = ("model.mfu", "model.gemm_ms_per_step", "kernels.attn_roofline",
               "kernels.attn_ms_per_step", "device.idle_share",
               "device.peak_mem_gib")
NEW_READERS = ("attention.device_ms_per_step", "model.forward_ms_per_step",
               "model.backward_ms_per_step", "model.sgd_ms_per_step",
               "moe.route_ms_per_step", "moe.dispatch_ms_per_step",
               "moe.experts_ms_per_step", "moe.expert_fill")


def read(name, run):
    return spec.metric_reader(name)(run)


def _run(launched=(), ranges_=(), links=(), counters=None, steps=1):
    """A synthetic TraceRun of `launched` with its program view: the
    program's ranges, each op's launch and the linked backward nodes."""
    launched = sorted(launched)
    run = TraceRun(
        kernels=[(a, b, n) for a, b, n, _, _ in launched], host_ops=[],
        window_s=1.0, steps=steps, tokens_per_step=8184,
        flops_per_token=2_919_432_192.0,
        attention_calls=[(8, 1023, 16, 128)] * 8,
        peak_mem_bytes=3 * 2 ** 30, device_name=H100)
    program = None
    if ranges_:
        program = ranges.ProgramTrace(ranges=sorted(ranges_),
                                      launched=launched,
                                      links=sorted(links), steps=steps)
    ranges.remember(run, program, counters)
    return run


# One step on the host (us): forward [0, 100) holding attention.fwd
# [10, 30) and moe.route [40, 60); backward [100, 200) on the stepping
# thread 1, autograd's thread 2 holding attention.bwd [120, 150) and a
# node linked to moe.route [160, 170); sgd [200, 250).
RANGES = [
    (0.0, 260.0, "step", 1), (0.0, 100.0, "step.forward", 1),
    (10.0, 30.0, "attention.fwd", 1), (40.0, 60.0, "moe.route", 1),
    (100.0, 200.0, "step.backward", 1), (120.0, 150.0, "attention.bwd", 2),
    (200.0, 250.0, "step.sgd", 1),
]
LINKS = [(160.0, 170.0, 2, "moe.route", "MmBackward0")]
# Device ops run later than their launch: (start, end, name, launch, thread)
LAUNCHED = [
    (1000.0, 1100.0, "nvjet_embed", 5.0, 1),
    (1100.0, 1400.0, "flash_fwd_sm90_kernel", 20.0, 1),
    (1400.0, 1450.0, "router_mm", 45.0, 1),
    (1500.0, 1600.0, "nvjet_bwd", 110.0, 2),
    (1600.0, 2200.0, "flash_bwd_sm90_kernel", 130.0, 2),
    (2200.0, 2250.0, "elementwise_delta", 125.0, 2),
    (2300.0, 2320.0, "router_mm_bwd", 165.0, 2),
    (2400.0, 2500.0, "sgd_add", 210.0, 1),
    (2500.0, 2501.0, "no_launch_found", None, None),
]


class TestAttribution:
    def test_by_launch_time_not_device_time(self):
        run = _run(LAUNCHED, RANGES, LINKS)
        # Every device op starts after the whole host step has ended;
        # each is placed by its launch alone.
        assert read("model.forward_ms_per_step", run) == pytest.approx(0.45)
        assert read("model.backward_ms_per_step", run) == \
            pytest.approx(0.77)
        assert read("model.sgd_ms_per_step", run) == pytest.approx(0.1)

    def test_nested_ranges_count_in_their_holders(self):
        run = _run(LAUNCHED, RANGES, LINKS)
        assert read("attention.device_ms_per_step", run) == \
            pytest.approx(0.3 + 0.6 + 0.05)
        assert ranges.range_ms_per_step(run, "attention.fwd") == \
            pytest.approx(0.3)
        assert ranges.range_ms_per_step(run, "step") == pytest.approx(1.32)

    def test_sequence_number_link_counts_backward(self):
        run = _run(LAUNCHED, RANGES, LINKS)
        assert read("moe.route_ms_per_step", run) == \
            pytest.approx(0.05 + 0.02)
        without = _run(LAUNCHED, RANGES)   # no links
        assert read("moe.route_ms_per_step", without) == pytest.approx(0.05)
        assert read("model.backward_ms_per_step", without) == \
            pytest.approx(0.77)

    def test_phases_partition_busy_time(self):
        run = _run(LAUNCHED[:-1], RANGES, LINKS, steps=2)
        phases = sum(read(f"model.{p}_ms_per_step", run)
                     for p in ("forward", "backward", "sgd"))
        assert phases * 2 / 1e3 == pytest.approx(run.busy_s)
        # An op with no launch found is under no range: the sum falls
        # short of busy time by its share.
        short = _run(LAUNCHED, RANGES, LINKS)
        total = sum(read(f"model.{p}_ms_per_step", short)
                    for p in ("forward", "backward", "sgd"))
        assert short.busy_s * 1e3 - total == pytest.approx(0.001)

    def test_moe_readers_and_fill(self):
        launched = [(0.0, 4.0, "cast", 1.0, 1), (4.0, 10.0, "bmm", 2.0, 1),
                    (10.0, 30.0, "gemm_up", 5.0, 1),
                    (30.0, 32.0, "bmm_c", 8.0, 1),
                    (40.0, 43.0, "bmm_bwd", 21.0, 2)]
        ranges = [(0.5, 3.0, "moe.dispatch", 1), (4.0, 6.0, "moe.experts", 1),
                  (7.0, 9.0, "moe.combine", 1)]
        links = [(20.0, 22.0, 2, "moe.dispatch", "BmmBackward0")]
        run = _run(launched, ranges, links,
                   counters={"moe.kept": 30908.0, "moe.slots": 40896,
                             "moe.routed": 32736})
        assert read("moe.dispatch_ms_per_step", run) == \
            pytest.approx((4 + 6 + 2 + 3) / 1e3)
        assert read("moe.experts_ms_per_step", run) == pytest.approx(0.02)
        assert read("moe.route_ms_per_step", run) is None
        assert read("moe.expert_fill", run) == \
            pytest.approx(100 * 30908 / 40896)

    def test_readers_find_nothing_without_ranges(self):
        run = _run(LAUNCHED)
        for name in NEW_READERS:
            assert read(name, run) is None, name
        assert read("moe.expert_fill", _run(counters={"moe.kept": 3.0})) \
            is None

    def test_a_run_with_no_session_reads_nothing(self):
        # Not remembered, and no live profiler session made it.
        run = TraceRun(kernels=[(0.0, 1.0, "k")], host_ops=[], **FIELDS)
        assert ranges.of(run) is None
        for name in NEW_READERS[:-1]:
            assert read(name, run) is None, name

    def test_open_at(self):
        got = open_at([(0, 10, "a"), (2, 4, "b"), (5, 6, "c")],
                      [3, None, 10, 11, 5])
        assert [sorted(x[2] for x in g) for g in got] == \
            [["a", "b"], [], ["a"], [], ["a", "c"]]


def _ev(name, start, end, *, device=DeviceType.CPU, thread=1, id=0,
        linked=0, seq=-1, fwd_thread=0):
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=start, end=end),
        device_type=device, thread=thread, id=id,
        linked_correlation_id=linked, sequence_nr=seq, fwd_thread=fwd_thread)


def _events(with_ranges: bool, mirrored: bool = False):
    """A traced step as torch.profiler lists it: the benchmark's own range
    (mirrored on the device's timeline), aten ops, runtime calls, kernels
    and a backward node on thread 2; with the program's ranges, their
    host events too (`mirrored`: and a device-side mirror of each, as a
    user-scope range would leave)."""
    cuda = DeviceType.CUDA
    ev = [
        _ev("portbench.step", 0, 300), _ev("portbench.step", 900, 1800,
                                           device=cuda, thread=7),
        _ev("aten::mm", 42, 48, id=11, seq=5),
        _ev("cudaLaunchKernel", 43, 44, id=101, linked=11),
        _ev("nvjet_tst_256x128_NNT", 1000, 1100, device=cuda, thread=7,
            id=101, linked=11),
        _ev("_FlashAttention", 12, 28, id=12, seq=6),
        _ev("cudaLaunchKernel", 20, 21, id=102, linked=12),
        _ev("void flash::flash_fwd_sm90_kernel<128>", 1100, 1300,
            device=cuda, thread=7, id=102, linked=12),
        _ev(BACKWARD_NODE + ": MmBackward0", 160, 170, thread=2, seq=5,
            fwd_thread=1),
        _ev("aten::mm", 161, 169, thread=2, id=13),
        _ev("cuLaunchKernelEx", 162, 163, thread=2, id=103, linked=13),
        _ev("nvjet_tst_128x248_TNT", 1400, 1500, device=cuda, thread=7,
            id=103, linked=13),
        _ev("aten::sub_", 210, 215, id=14),
        _ev("cudaLaunchKernel", 211, 212, id=104, linked=14),
        _ev("void at::native::vectorized_elementwise_kernel<4>", 1600, 1650,
            device=cuda, thread=7, id=104, linked=14),
        _ev("cudaMemsetAsync", 213, 214, id=105, linked=14),
        _ev("Memset (Device)", 1700, 1710, device=cuda, thread=7, id=105,
            linked=14),
        # A device operation whose launch the trace lost: under no range.
        _ev("void orphan_kernel", 1750, 1760, device=cuda, thread=7,
            id=106),
    ]
    if with_ranges:
        for a, b, name, thread in RANGES:
            ev.append(_ev(name, a, b, thread=thread))
            if mirrored:
                ev.append(_ev(name, a + 900, b + 900, device=cuda,
                              thread=7))
    return ev


FIELDS = dict(window_s=0.002, steps=1, tokens_per_step=8184,
              flops_per_token=2_919_432_192.0,
              attention_calls=[(8, 1023, 16, 128)] * 8,
              peak_mem_bytes=3 * 2 ** 30, device_name=H100)


class TestFromEvents:
    def test_existing_readers_unmoved_by_the_programs_ranges(self):
        before = from_profile(_events(False), **FIELDS)
        after = from_profile(_events(True), **FIELDS)
        assert after.kernels == before.kernels
        assert len(before.kernels) == 6
        for name in OLD_READERS:
            assert read(name, after) == read(name, before), name

    def test_no_ranges_no_program(self):
        assert ranges.from_events(_events(False), 1) is None

    @pytest.mark.parametrize("mirrored", [False, True])
    def test_launches_ranges_and_links(self, mirrored):
        program = ranges.from_events(_events(True, mirrored), 1)
        assert [r[2] for r in program.ranges] == \
            [r[2] for r in sorted(RANGES)]
        assert len(program.launched) == 6     # mirrors are no operations
        launch = {name: (t, th) for _, _, name, t, th in program.launched}
        assert launch["nvjet_tst_256x128_NNT"] == (43.0, 1)
        assert launch["nvjet_tst_128x248_TNT"] == (162.0, 2)
        assert launch["Memset (Device)"] == (213.0, 1)
        assert launch["void orphan_kernel"] == (None, None)
        assert program.links == [
            (160.0, 170.0, 2, "moe.route", "MmBackward0")]
        assert program.range_ms_per_step("moe.route") == pytest.approx(0.2)
        assert program.range_ms_per_step("attention.fwd") == \
            pytest.approx(0.2)
        assert program.range_ms_per_step("step.sgd") == pytest.approx(0.06)


def _tiny(moe: bool):
    from tpu_dra_torch.workloads import model as tm
    from tpu_dra_torch.workloads import moe_model

    torch.manual_seed(0)
    g = torch.Generator().manual_seed(0)
    kw = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
              max_seq=16, dtype=torch.float32, attn_impl="flash")
    if moe:
        cfg = moe_model.MoEModelConfig(n_experts=4, **kw)
        model = moe_model.MoETransformerLM(
            cfg, moe_model.init_params(cfg, g, device="cpu"))
        step = moe_model.make_train_step(model, lr=1e-2)
    else:
        cfg = tm.ModelConfig(**kw)
        step = tm.make_train_step(
            tm.TransformerLM(cfg, tm.init_params(cfg, g, device="cpu")),
            lr=1e-2)
    tokens = torch.randint(0, 64, (2, 17), generator=g)
    step(tokens)
    return lambda: step(tokens)


def _profiled(step):
    """A CPU profile of one step, inside the benchmark's step range as the
    driver records it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(STEP_RANGE):
            step()
    return prof


class TestSession:
    def test_cpu_profile_links_moe_backward_to_its_ranges(self):
        from tpu_dra_torch.infra.trace import read_counters

        read_counters()
        step = _tiny(moe=True)
        prof = _profiled(step)
        run = from_profile(prof.events(), **dict(FIELDS, device_name="cpu"))
        program = ranges.of(run)
        linked = {(name, node) for _, _, _, name, node in program.links}
        assert ("moe.route", "MmBackward0") in linked   # the router matmul
        assert ("moe.dispatch", "BmmBackward0") in linked   # the dispatch
        assert ("moe.combine", "BmmBackward0") in linked
        assert ("moe.experts", "GeluBackward0") in linked
        assert {name for _, _, name, _ in program.ranges} >= {
            "step", "step.forward", "step.backward", "step.sgd",
            "moe.route"}
        assert program.launched == [] and run.kernels == []
        # The counters are read once per run: a second reader of the same
        # run sees the same counts, though the port's were reset.
        counts = ranges.counters(run)
        assert counts["moe.routed"] == 2 * 16
        assert ranges.counters(run) == counts
        assert read("moe.expert_fill", run) == pytest.approx(
            100 * counts["moe.kept"] / counts["moe.slots"])
        assert read_counters() == {}

    def test_each_run_finds_its_own_session(self):
        moe_run = _profiled(_tiny(moe=True))
        dense_run = _profiled(_tiny(moe=False))
        fields = dict(FIELDS, device_name="cpu")
        a = ranges.of(from_profile(moe_run.events(), **fields))
        b = ranges.of(from_profile(dense_run.events(), **fields))
        assert "moe.route" in {r[2] for r in a.ranges}
        assert "moe.route" not in {r[2] for r in b.ranges}
        assert {r[2] for r in b.ranges} >= {"step", "attention.bwd"}


def test_traced_cpu_run_reads_the_counters():
    # The driver's own traced run, at a test's size on the CPU: the
    # readers go back to its profiler session and to the port's counters.
    # The CPU has no device operations, so the device-time readers find
    # nothing to read.
    from portbench.drivers import train
    from portbench.tests import tiny

    cell = tiny.cell("moe_lm.s1k_uniform")
    result = train.run(cell, 2 ** 33 + 5, 0.2, True, torch.device("cpu"))
    fill = result["metrics"]["moe.expert_fill"]["value"]
    assert 0 < fill <= 100
    assert not set(NEW_READERS[:-1]) & set(result["metrics"])


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in
                                  spec.load_benchmark()["workloads"]])
def test_cell_reads_every_metric_on_the_card(name, cuda_device, monkeypatch):
    from portbench import trace
    from portbench.drivers import train

    made = []
    from_profile = trace.from_profile

    def keep(events, **fields):
        made.append((events, from_profile(events, **fields)))
        return made[-1][1]

    monkeypatch.setattr(trace, "from_profile", keep)
    cell = spec.resolve(name)
    result = train.run(cell, 2 ** 36 + 29, 3.0, True, cuda_device)
    assert result["correct"] is True, result["checks"]
    events, run = made[0]     # the driver's own
    # No program range has a mirror among the device's operations.
    assert not {e.name for e in events if e.device_type == DeviceType.CUDA
                } & set(ranges.PROGRAM_RANGES)
    # Every per-layer metric the cell lists reads a value; the program's
    # phases hold all of the device's busy time, and attention's ranges
    # hold at least its kernels.
    metrics = result["metrics"]
    assert {m["name"] for m in cell.per_layer} == set(metrics)
    phases = sum(metrics[f"model.{p}_ms_per_step"]["value"]
                 for p in ("forward", "backward", "sgd"))
    assert phases >= 0.99 * run.busy_s / run.steps * 1e3
    assert metrics["attention.device_ms_per_step"]["value"] >= \
        metrics["kernels.attn_ms_per_step"]["value"]
