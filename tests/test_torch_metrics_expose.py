"""Port parity: the reference's Prometheus text-exposition cases
(tests/test_metrics_expose.py) over tpu_dra_torch.infra.metrics.

All 16 of the reference's cases run here against the port's Registry,
DefaultRegistry, METRICS_CATALOG and MetricsServer: HELP/TYPE order, the
escaping of help text and label values, stable label order, cumulative
buckets with +Inf, names and reserved suffixes, a parse of the whole
default registry, the empty-state contract of ``Histogram.empty`` /
``Histogram.percentile`` and ``value()``, concurrent scrapes, healthz
and 404, and the failover series wired from the port's kubelet-plugin
pipeline and server and its leader elector. The port keeps the
reference's tpu_dra_ series names, so the expected names are unchanged.
"""

import math
import re
import threading
import urllib.request

from tpu_dra_torch.infra.metrics import (
    Counter, Gauge, Histogram, MetricsServer, Registry,
)


def scrape(port: int) -> str:
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=5) as resp:
        assert resp.status == 200
        assert resp.headers["Content-Type"].startswith("text/plain")
        return resp.read().decode()


class TestTextExposition:
    def test_help_and_type_lines_precede_samples(self):
        reg = Registry()
        c = reg.counter("tpu_dra_x_total", "helpful text")
        c.inc(3)
        lines = reg.expose().splitlines()
        assert lines[0] == "# HELP tpu_dra_x_total helpful text"
        assert lines[1] == "# TYPE tpu_dra_x_total counter"
        assert lines[2] == "tpu_dra_x_total 3.0"

    def test_help_escapes_newline_and_backslash(self):
        reg = Registry()
        reg.counter("tpu_dra_x_total", "line1\nline2 \\ tail")
        text = reg.expose()
        assert r"line1\nline2 \\ tail" in text
        # The logical HELP line must stay ONE physical line.
        help_lines = [ln for ln in text.splitlines()
                      if ln.startswith("# HELP")]
        assert len(help_lines) == 1

    def test_label_value_escaping(self):
        """A label value carrying quote/backslash/newline must not tear
        the sample line — the Prometheus escaping rules apply."""
        reg = Registry()
        c = reg.counter("tpu_dra_evil_total")
        c.inc(labels={"reason": 'say "hi"\nback\\slash'})
        sample = [ln for ln in reg.expose().splitlines()
                  if ln.startswith("tpu_dra_evil_total{")]
        assert sample == [
            'tpu_dra_evil_total{reason="say \\"hi\\"\\nback\\\\slash"}'
            ' 1.0']

    def test_label_sets_render_sorted_and_stable(self):
        """Same state ⇒ byte-identical exposition, label names sorted
        within a sample, label sets sorted across samples — scrape
        diffs must be deterministic."""
        reg = Registry()
        c = reg.counter("tpu_dra_s_total")
        # Insert in 'random' orders; rendering must not care.
        c.inc(labels={"b": "2", "a": "1"})
        c.inc(labels={"a": "0", "b": "9"})
        c.inc(labels={"b": "2", "a": "1"})
        first = reg.expose()
        assert first == reg.expose()
        samples = [ln for ln in first.splitlines()
                   if ln.startswith("tpu_dra_s_total{")]
        assert samples == [
            'tpu_dra_s_total{a="0",b="9"} 1.0',
            'tpu_dra_s_total{a="1",b="2"} 2.0',
        ]

    def test_histogram_buckets_ordered_cumulative_with_inf(self):
        reg = Registry()
        h = reg.histogram("tpu_dra_lat_seconds", buckets=(0.1, 1.0, 10.0))
        for v in (0.05, 0.5, 5.0, 50.0):
            h.observe(v)
        lines = reg.expose().splitlines()
        buckets = [ln for ln in lines if "_bucket{" in ln]
        # le values ascend, counts are cumulative, +Inf terminates with
        # the total observation count.
        assert buckets == [
            'tpu_dra_lat_seconds_bucket{le="0.1"} 1',
            'tpu_dra_lat_seconds_bucket{le="1.0"} 2',
            'tpu_dra_lat_seconds_bucket{le="10.0"} 3',
            'tpu_dra_lat_seconds_bucket{le="+Inf"} 4',
        ]
        assert "tpu_dra_lat_seconds_sum 55.55" in lines
        assert "tpu_dra_lat_seconds_count 4" in lines

    def test_metric_naming_and_reserved_suffixes(self):
        """Every metric the project registers obeys the tpu_dra_ name
        contract, and type-reserved suffixes are not abused: gauges
        never end _total, non-histograms never claim _bucket/_sum/
        _count (which would collide with histogram series)."""
        from tpu_dra_torch.infra.metrics import DefaultRegistry
        name_re = re.compile(r"^tpu_dra_[a-z0-9_]+$")
        for m in DefaultRegistry._metrics:
            assert name_re.match(m.name), m.name
            if m.kind == "gauge":
                assert not m.name.endswith("_total"), \
                    f"gauge {m.name} uses the counter suffix"
            if m.kind != "histogram":
                assert not m.name.endswith(("_bucket", "_sum",
                                            "_count")), \
                    f"{m.kind} {m.name} squats a histogram suffix"

    def test_whole_default_registry_exposition_parses(self):
        """Every line of the real registry's exposition is a comment or
        a well-formed sample (loose promfmt parse) — one malformed help
        string anywhere breaks the whole scrape."""
        from tpu_dra_torch.infra.metrics import DefaultRegistry
        sample_re = re.compile(
            r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? [^ ]+$')
        for ln in DefaultRegistry.expose().splitlines():
            if not ln or ln.startswith("#"):
                continue
            assert sample_re.match(ln), f"malformed sample line: {ln!r}"


class TestEmptyStateContract:
    def test_percentile_on_empty_histogram(self):
        h = Histogram("tpu_dra_e_seconds")
        assert h.empty
        # The documented empty-state contract: default (0.0), or the
        # caller's sentinel — never an exception, never a stale value.
        assert h.percentile(0.5) == 0.0
        assert math.isnan(h.percentile(0.5, default=float("nan")))
        h.observe(0.2)
        assert not h.empty
        assert h.percentile(0.5) == 0.25  # bucket upper bound

    def test_percentile_above_largest_bucket_is_inf(self):
        h = Histogram("tpu_dra_e_seconds", buckets=(1.0,))
        h.observe(100.0)
        assert h.percentile(0.5) == float("inf")

    def test_value_never_touched_vs_zero(self):
        c = Counter("tpu_dra_v_total")
        # Never touched: the default (0.0) — same as an incremented-to-
        # zero counter, per the documented contract...
        assert c.value(labels={"k": "a"}) == 0.0
        # ...with labelsets()/a sentinel default as the discriminator.
        assert c.value(labels={"k": "a"}, default=-1.0) == -1.0
        assert c.labelsets() == []
        c.inc(0, labels={"k": "a"})
        assert c.value(labels={"k": "a"}) == 0.0
        assert c.labelsets() == [{"k": "a"}]

    def test_gauge_value_default(self):
        g = Gauge("tpu_dra_v_gauge")
        assert g.value() == 0.0
        assert g.value(default=float("nan")) != g.value(default=0.0) \
            or math.isnan(g.value(default=float("nan")))
        g.set(0.0)
        assert g.labelsets() == [{}]


class TestMetricsServerScrape:
    def test_concurrent_scrapes_are_well_formed(self):
        """N writer threads mutate counters/histograms while scrapers
        pull /metrics: every scrape parses, counter samples are
        monotone across scrapes, and the final scrape shows the full
        tally (no torn lines, no lost writes)."""
        reg = Registry()
        c = reg.counter("tpu_dra_scrape_total", "writes")
        h = reg.histogram("tpu_dra_scrape_seconds", "lat",
                          buckets=(0.5, 1.0))
        srv = MetricsServer(port=0, registry=reg)
        srv.start()
        try:
            stop = threading.Event()
            n_writers, per_writer = 4, 500

            def writer(i):
                for j in range(per_writer):
                    c.inc(labels={"w": str(i)})
                    h.observe((j % 3) * 0.4)

            threads = [threading.Thread(target=writer, args=(i,))
                       for i in range(n_writers)]
            for t in threads:
                t.start()
            sample_re = re.compile(
                r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? [^ ]+$')
            seen: dict = {}
            scrapes = 0
            while any(t.is_alive() for t in threads) or scrapes < 3:
                body = scrape(srv.port)
                scrapes += 1
                for ln in body.splitlines():
                    if not ln or ln.startswith("#"):
                        continue
                    assert sample_re.match(ln), f"torn line: {ln!r}"
                    name, _, val = ln.rpartition(" ")
                    if name.startswith("tpu_dra_scrape_total{"):
                        prev = seen.get(name, 0.0)
                        assert float(val) >= prev, \
                            f"counter went backwards: {ln}"
                        seen[name] = float(val)
                if scrapes > 200:
                    break
            for t in threads:
                t.join()
            stop.set()
            final = scrape(srv.port)
            total = sum(
                float(ln.rpartition(" ")[2])
                for ln in final.splitlines()
                if ln.startswith("tpu_dra_scrape_total{"))
            assert total == n_writers * per_writer
            assert (f"tpu_dra_scrape_seconds_count "
                    f"{n_writers * per_writer}") in final
        finally:
            srv.stop()

    def test_healthz_and_404(self):
        reg = Registry()
        srv = MetricsServer(port=0, registry=reg)
        srv.start()
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/healthz",
                    timeout=5) as resp:
                assert resp.status == 200
            try:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/nope", timeout=5)
                raise AssertionError("404 expected")
            except urllib.error.HTTPError as e:
                assert e.code == 404
        finally:
            srv.stop()


class TestFailoverMetrics:
    """Observability: the HA/hot-restart instruments exist
    with the right kinds and wire up from their call sites."""

    def test_failover_metrics_registered(self):
        from tpu_dra_torch.infra.metrics import METRICS_CATALOG, DefaultRegistry
        kinds = {m.name: m.kind for m in DefaultRegistry._metrics}
        expected = {
            "tpu_dra_sched_leader": "gauge",
            "tpu_dra_sched_lease_transitions_total": "counter",
            "tpu_dra_rpc_drain_seconds": "histogram",
            "tpu_dra_rpc_reconnects_total": "counter",
        }
        for name, kind in expected.items():
            assert name in METRICS_CATALOG, name
            # drain/reconnect register lazily with their modules; the
            # election pair registers at metrics import.
            if name in kinds:
                assert kinds[name] == kind, (name, kinds[name])

    def test_drain_and_reconnect_series_observe(self):
        import tpu_dra_torch.kubeletplugin.pipeline as pipeline_mod
        import tpu_dra_torch.kubeletplugin.server as server_mod
        from tpu_dra_torch.infra.metrics import DefaultRegistry

        drain_before = pipeline_mod.RPC_DRAIN_SECONDS.count
        pipeline_mod.RPC_DRAIN_SECONDS.observe(0.001)
        server_mod.RPC_RECONNECTS.inc()
        text = DefaultRegistry.expose()
        assert "tpu_dra_rpc_drain_seconds_count" in text
        assert "tpu_dra_rpc_reconnects_total" in text
        assert pipeline_mod.RPC_DRAIN_SECONDS.count == drain_before + 1

    def test_leader_gauge_tracks_election(self):
        from tpu_dra_torch.infra.leaderelect import LeaderElector
        from tpu_dra_torch.infra.metrics import SCHED_LEADER
        from tpu_dra_torch.k8s import FakeCluster

        elector = LeaderElector(FakeCluster(), "m-rep",
                                lease_duration_s=1.0,
                                clock=lambda: 0.0, seed=3)
        elector.tick()  # creates the lease: leader
        assert SCHED_LEADER.value(labels={"identity": "m-rep"}) == 1
        elector.stop()
        assert SCHED_LEADER.value(labels={"identity": "m-rep"}) == 0
