"""The port's ops benches (tpu_dra_torch/bench.py) against the
reference's (bench.py: bench_fake_v5p_configs, bench_prepare_sustained,
bench_sched_churn, bench_topology, bench_sched_failover,
bench_trace_overhead) at small sizes on the CPU.

Each pair runs at the same small size; the port's key set must equal the
reference's after the stated rename (``fake_v5p`` -> ``fake_h100``; every
other key keeps its name), and the port's record must hold the
invariants the reference's hack/perf.sh gates and chip_smoke.py's ops
phase holds: no RPC error and no leaked claim under load, a pipeline
in-flight peak of at most 16, no full relist, no more CEL compiles than
distinct selector sources, no leaked claim after churn, contiguity 1.0
with nothing unplaced, failover p50 within 2000 ms, the MIG and MPS keys
present. Latencies are asserted only where a gate bounds them: the
tier runs under parallel load.
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
    assert port["sched_workers"] == 1
    assert port["sched_churn_pods"] == 40
    assert port["sched_churn_window"] == 16   # half of 8 x 4 GPUs


def test_sched_churn_ignores_a_worker_pool(caplog):
    port = port_bench.bench_sched_churn(n_nodes=2, n_pods=4, workers=4)
    assert port["sched_workers"] == 1
    assert "workers=4 ignored" in caplog.text


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
                    "sched_cel_distinct_exprs": 2},
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
