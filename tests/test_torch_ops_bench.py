"""The port's ops benches (tpu_dra_torch/bench.py) against the
reference's (bench.py: bench_fake_v5p_configs, bench_prepare_sustained,
bench_sched_churn, bench_topology, bench_sched_failover,
bench_trace_overhead, bench_chaos_recovery, bench_sched_scale10k) at
small sizes on the CPU.

Each pair runs at the same small size; the port's key set must equal the
reference's after the stated rename (``fake_v5p`` -> ``fake_h100``; every
other key keeps its name), and the port's record must hold the
invariants the reference's hack/perf.sh gates and chip_smoke.py's ops
phase holds: no RPC error and no leaked claim under load, a pipeline
in-flight peak of at most 16, no full relist, no more CEL compiles than
distinct selector sources, no leaked claim after churn, contiguity 1.0
with nothing unplaced, failover p50 within 2000 ms, the MIG and MPS keys
present, the scheduler's pool of 4 workers, and at scale-out no full
relist and no watcher-queue overflow. Latencies are asserted only where
a gate bounds them: the tier runs under parallel load.
"""

import pytest

import bench as ref_bench
from tpu_dra_torch import bench as port_bench
from tpu_dra_torch.infra import faults as port_faults
from tpu_dra_torch.infra import featuregates as port_gates

FAILOVER_P50_GATE_MS = 2000.0   # hack/perf.sh PERF_FAILOVER_P50_GATE_MS
PIPELINE_INFLIGHT_MAX = 16      # hack/perf.sh, the admission window


@pytest.fixture(autouse=True)
def _port_state():
    port_faults.FAULTS.reset()
    port_gates.Features.reset()
    yield
    port_faults.FAULTS.reset()
    port_gates.Features.reset()


def _renamed(keys):
    return {k.replace("fake_v5p", "fake_h100") for k in keys}


def test_fake_inventory_configs():
    port = port_bench.bench_fake_inventory_configs(n_cycles=3, warmup=1)
    ref = ref_bench.bench_fake_v5p_configs(n_cycles=3, warmup=1)
    assert not [k for k in port if k.endswith("_error")], port
    assert set(port) == _renamed(ref)
    assert port["claim_to_ready_p50_subslice_fake_h100_ms"] > 0
    assert port["claim_to_ready_p50_multiprocess_ms"] > 0
    assert 0 < port["multiprocess_sharing_phase_ms"] \
        < port["claim_to_ready_p50_multiprocess_ms"]
    assert port["claim_to_ready_batch_claims_fake_h100"] == 4
    assert port["claim_to_ready_batch64_claims"] == 64


def test_fake_inventory_leaves_no_gate_override():
    port_gates.Features.set_from_string("TimeSlicingSettings=true")
    before = port_gates.Features.overrides_snapshot()
    port_bench.bench_fake_inventory_configs(n_cycles=1, warmup=0)
    assert port_gates.Features.overrides_snapshot() == before


def test_prepare_sustained():
    port = port_bench.bench_prepare_sustained(duration_s=2, workers=2)
    ref = ref_bench.bench_prepare_sustained(duration_s=1, workers=2)
    assert set(port) == set(ref)
    assert port["prepare_sustained_errors"] == 0, \
        port.get("prepare_sustained_first_error")
    assert port["prepare_sustained_leaked_claims"] == 0
    assert port["prepare_sustained_rpcs"] > 0
    assert 1 <= port["prepare_sustained_pipeline_inflight_peak"] \
        <= PIPELINE_INFLIGHT_MAX
    assert port["prepare_sustained_inflight_peak"] <= 2
    assert port["prepare_sustained_journal_appends"] \
        >= port["prepare_sustained_journal_group_syncs"] > 0
    assert port["prepare_sustained_batch_mix"] == "1,1,1,1,2,4"


def test_sched_churn():
    port = port_bench.bench_sched_churn(n_nodes=8, n_pods=40)
    ref = ref_bench.bench_sched_churn(n_nodes=8, n_pods=40)
    assert set(port) == set(ref)
    assert "sched_churn_gc_leak" not in port
    assert port["sched_full_relists"] == 0
    assert port["sched_cel_compiles"] <= port["sched_cel_distinct_exprs"] == 2
    assert port["sched_workers"] == ref["sched_workers"] == 4
    assert port["sched_churn_pods"] == 40
    assert port["sched_churn_window"] == 16   # half of 8 x 4 GPUs


def test_sched_churn_ignores_a_worker_pool(caplog):
    """The scheduler once ran one worker and ignored a pool; it now runs
    the pool it is given, and reports its size."""
    for workers in (1, 2):
        port = port_bench.bench_sched_churn(n_nodes=2, n_pods=4,
                                            workers=workers)
        assert port["sched_workers"] == workers
        assert "sched_churn_gc_leak" not in port
    assert "ignored" not in caplog.text


def test_chaos_recovery():
    port = port_bench.bench_chaos_recovery(n=3)
    ref = ref_bench.bench_chaos_recovery(n=1)
    assert set(port) == set(ref)
    assert port["chaos_recovery_crashes"] == 3
    assert 0 < port["chaos_recovery_p50_ms"] <= port["chaos_recovery_p95_ms"]


def test_chaos_recovery_on_a_passed_backend():
    """The backend seam (the card passes NVML): a claim of every GPU of
    the backend, with no sharing config, recovers after each crash, and
    the backend stays open for its owner."""
    from tpu_dra_torch.native.gpuinfo import FakeBackend, default_fake_gpus

    backend = FakeBackend(default_fake_gpus(1))
    port = port_bench.bench_chaos_recovery(n=2, backend=backend)
    assert port["chaos_recovery_crashes"] == 2
    assert [g.index for g in backend.gpus()] == [0]


def test_sched_scale10k():
    """Both packages' scale-out bench at a tiny size: the reference's key
    set, no full relist, no watcher-queue overflow, the pool's 4
    workers, and a hollow fleet that saw the binds of its nodes."""
    kw = dict(n_nodes=20, n_pods=100, n_watchers=4, baseline_nodes=10,
              baseline_pods=50)
    port = port_bench.bench_sched_scale10k(**kw)
    ref = ref_bench.bench_sched_scale10k(**kw)
    assert set(port) == set(ref)
    assert port["sched_scale10k_full_relists"] == 0
    assert port["sched_scale10k_hollow_overflow_errors"] == 0
    assert port["sched_scale10k_workers"] == 4
    assert port["sched_scale10k_churn_nodes"] == 20
    assert port["sched_scale10k_baseline_nodes"] == 10
    assert port["sched_scale10k_hollow_watchers"] == 4
    assert port["sched_scale10k_hollow_bookmarks"] >= 4
    assert 0 < port["sched_scale10k_hollow_events_max"] \
        <= port["sched_scale10k_hollow_events_total"]
    assert port["sched_scale10k_throughput_ratio"] > 0
    assert "sched_scale10k_churn_gc_leak" not in port


@pytest.mark.parametrize("sub,key,fn", [
    ("chaos", "chaos_recovery", "bench_chaos_recovery"),
    ("scale10k", "sched_scale10k", "bench_sched_scale10k"),
])
def test_subcommand_prints_its_line(monkeypatch, capsys, sub, key, fn):
    import json

    monkeypatch.setattr(port_bench, fn, lambda: {f"{key}_x": 1})
    assert port_bench.main([sub]) == 0
    assert json.loads(capsys.readouterr().out) == {key: {f"{key}_x": 1}}


def test_topology():
    port = port_bench.bench_topology(n_pods=40)
    ref = ref_bench.bench_topology(n_pods=40)
    assert set(port) == set(ref)
    assert port["topo_contiguity_ratio"] == 1.0
    assert port["topo_unplaced_pods"] == 0
    assert port["topo_alloc_fallback"] == 0
    assert port["topo_alloc_contiguous"] > 0
    assert port["topo_churn_pods"] == 40
    assert 1 <= port["topo_free_cuboid_p50_chips"] <= 8
    assert port["topo_mesh"] == "8x(8x1x1)"


def test_sched_failover():
    port = port_bench.bench_sched_failover(n_failovers=2)
    ref = ref_bench.bench_sched_failover(n_failovers=1)
    assert set(port) == set(ref)
    assert port["sched_failover_rounds"] == 2
    assert port["sched_failover_lease_duration_s"] == 0.4
    assert port["sched_failover_to_alloc_p50_ms"] <= FAILOVER_P50_GATE_MS
    assert port["sched_failover_to_alloc_max_ms"] \
        >= port["sched_failover_to_alloc_p50_ms"] > 0


def test_trace_overhead_restores_the_tracer():
    from tpu_dra_torch.infra.trace import TRACER

    port = port_bench.bench_trace_overhead(20_000)
    ref = ref_bench.bench_trace_overhead(2_000)
    assert set(port) == set(ref)
    assert port["trace_overhead_spans"] == 20_000
    assert port["trace_spans_per_s"] > 0
    assert TRACER.enabled
    TRACER.set_enabled(False)
    try:
        port_bench.bench_trace_overhead(2_000)
        assert not TRACER.enabled
    finally:
        TRACER.set_enabled(True)


def test_ops_subcommand_prints_one_line_per_bench(monkeypatch, capsys):
    """``python -m tpu_dra_torch.bench ops`` prints each bench's record
    as it finishes, with its phase_s and the host's cpu_count."""
    calls = []

    def fake(name):
        def run(**kw):
            calls.append((name, kw))
            return {f"{name}_key": 1}
        return run

    for fn in ("bench_fake_inventory_configs", "bench_prepare_sustained",
               "bench_sched_churn", "bench_topology",
               "bench_sched_failover", "bench_trace_overhead"):
        monkeypatch.setattr(port_bench, fn, fake(fn))
    assert port_bench.main(["ops"]) == 0
    import json

    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [next(iter(x)) for x in lines] == [
        "fake_inventory", "prepare_sustained", "sched_churn", "topology",
        "sched_failover", "trace_overhead"]
    for line in lines:
        (rec,) = line.values()
        assert rec["phase_s"] >= 0 and rec["cpu_count"] >= 1
    assert calls[1] == ("bench_prepare_sustained", {"duration_s": None})


CLEAN = {
    "fake_inventory": {"claim_to_ready_p50_subslice_fake_h100_ms": 1.0,
                       "claim_to_ready_p50_multiprocess_ms": 2.0},
    "prepare_sustained": {"prepare_sustained_errors": 0,
                          "prepare_sustained_leaked_claims": 0,
                          "prepare_sustained_pipeline_inflight_peak": 8},
    "sched_churn": {"sched_full_relists": 0, "sched_cel_compiles": 2,
                    "sched_cel_distinct_exprs": 2, "sched_workers": 4},
    "topology": {"topo_contiguity_ratio": 1.0, "topo_unplaced_pods": 0},
    "sched_failover": {"sched_failover_to_alloc_p50_ms": 440.0},
}


@pytest.mark.parametrize("name,bad", [
    ("fake_inventory", {"fake_h100_subslice_error": "boom"}),
    ("fake_inventory", {"claim_to_ready_p50_multiprocess_ms": None}),
    ("prepare_sustained", {"prepare_sustained_errors": 1}),
    ("prepare_sustained", {"prepare_sustained_leaked_claims": 1}),
    ("prepare_sustained", {"prepare_sustained_pipeline_inflight_peak": 17}),
    ("sched_churn", {"sched_full_relists": 1}),
    ("sched_churn", {"sched_cel_compiles": 3}),
    ("sched_churn", {"sched_churn_gc_leak": 2}),
    ("sched_churn", {"sched_workers": 1}),
    ("topology", {"topo_contiguity_ratio": 0.9}),
    ("topology", {"topo_unplaced_pods": 1}),
    ("sched_failover", {"sched_failover_to_alloc_p50_ms": 2000.5}),
])
def test_chip_smoke_ops_checks(name, bad):
    """chip_smoke.py's ops phase passes a clean record and fails each
    hack/perf.sh invariant it holds."""
    import chip_smoke

    chip_smoke._check_ops(name, dict(CLEAN[name]))
    with pytest.raises(RuntimeError, match="chip_smoke check failed"):
        chip_smoke._check_ops(name, {**CLEAN[name], **bad})


def _clean_walk():
    return {"schedules": 1, "events": 4, "injected": {"trace.emit": 1},
            "violations": []}


@pytest.fixture
def smoke_stubs(monkeypatch):
    """chip_smoke's chaos and scale phases with their benches stubbed and
    a fake NVML, so only the phases' own checks run."""
    import chip_smoke
    from tpu_dra_torch.native import gpuinfo
    from tpu_dra_torch.simcluster import chaos

    summary = {**_clean_walk(), "watch_flake_violations": [],
               **{w: _clean_walk() for w in chaos.WALKS}}
    recovery = {"chaos_recovery_p50_ms": 5.0, "chaos_recovery_p95_ms": 6.0,
                "chaos_recovery_crashes": chip_smoke.CHAOS_RECOVERY_CRASHES}
    scale = {"sched_scale10k_full_relists": 0,
             "sched_scale10k_hollow_overflow_errors": 0,
             "sched_scale10k_throughput_ratio": 1.0}
    monkeypatch.setattr(chaos, "walk_matrix", lambda seeds, n: summary)
    monkeypatch.setattr(port_bench, "bench_chaos_recovery",
                        lambda n, backend=None: dict(recovery))
    monkeypatch.setattr(port_bench, "bench_sched_scale10k",
                        lambda **kw: dict(scale))
    monkeypatch.setattr(gpuinfo, "NativeBackend",
                        lambda: gpuinfo.FakeBackend(
                            gpuinfo.default_fake_gpus(1)))
    monkeypatch.setattr(gpuinfo, "nvidia_smi", lambda: None)
    return chip_smoke, summary, scale


def test_chip_smoke_chaos_phase_checks(smoke_stubs, capsys):
    """The chaos phase prints its line (every walk, the unfired re-arm
    sites named) and passes a clean matrix; a violation in any one walk
    fails it."""
    import json

    chip_smoke, summary, _ = smoke_stubs
    chip_smoke.phase_chaos()
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["phase"] == "chaos"
    assert set(line["walks"]) == {"plugin", "scheduler", "topology",
                                  "node_death", "leader_kill"}
    assert "k8s.api.request" in line["walks"]["scheduler"]["unfired_sites"]
    assert line["witness_cycles"] == []
    summary["node_death"]["violations"] = ["seed 0: boom"]
    with pytest.raises(RuntimeError, match="node_death walk violations"):
        chip_smoke.phase_chaos()


@pytest.mark.parametrize("bad", [
    {"sched_scale10k_full_relists": 1},
    {"sched_scale10k_hollow_overflow_errors": 2},
])
def test_chip_smoke_scale_phase_checks(smoke_stubs, bad):
    chip_smoke, _, scale = smoke_stubs
    chip_smoke.phase_scale()          # clean: the ratio is read only
    scale.update(bad)
    with pytest.raises(RuntimeError, match="chip_smoke check failed"):
        chip_smoke.phase_scale()
