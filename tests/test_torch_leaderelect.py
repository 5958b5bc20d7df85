"""The scheduler's HA on the port: the leader elector
(tpu_dra_torch/infra/leaderelect.py against tpu_dra/infra/leaderelect.py),
the Lease helpers (tpu_dra_torch/k8s/fake.py against tpu_dra/k8s/fake.py),
the port's Scheduler behind electors (the port's counterparts of
tests/test_stress_failover.py::TestSchedulerHAFailover), and the
scheduler inventory helpers (tpu_dra_torch/testing.py against
tpu_dra/testing.py's seed_sched_inventory and make_sched_pod).

The parity script drives both packages' electors, each over its own
fake cluster, with one fake clock, the same seeds and manual tick():
acquire, renew, expiry, takeover, a double-takeover race with one
winner, step-down under an injected ``sched.lease_renew`` fault and a
fenced stale write. The Lease's holder/transition/time sequence, each
elector's state, the callbacks and the fencing verdicts must be equal:
the tolerance is exact.
"""

import threading
import time

import pytest

from tpu_dra_torch.infra import faults as port_faults
from tpu_dra_torch.infra import featuregates as port_gates
from tpu_dra_torch.infra import leaderelect as port_le
from tpu_dra_torch.k8s import fake as port_fake
from tpu_dra_torch.k8s import resources as port_resources
from tpu_dra_torch.k8s.client import ConflictError
from tpu_dra_torch.simcluster.scheduler import Scheduler
from tpu_dra_torch.testing import (
    DEFAULT_SCHED_SELECTOR, make_sched_pod, seed_sched_inventory,
)

LEASE_S = 1.0


@pytest.fixture(autouse=True)
def _port_state():
    port_faults.FAULTS.reset()
    port_gates.Features.reset()
    yield
    port_faults.FAULTS.reset()
    port_gates.Features.reset()


def _packages():
    """(leaderelect, fake, resources, faults, client) of each package."""
    from tpu_dra.infra import faults as ref_faults
    from tpu_dra.infra import leaderelect as ref_le
    from tpu_dra.k8s import client as ref_client
    from tpu_dra.k8s import fake as ref_fake
    from tpu_dra.k8s import resources as ref_resources
    from tpu_dra_torch.k8s import client as port_client

    return {
        "port": (port_le, port_fake, port_resources, port_faults,
                 port_client),
        "ref": (ref_le, ref_fake, ref_resources, ref_faults, ref_client),
    }


class RacingClient:
    """Forwards to the cluster; before this client's next Lease update,
    runs `rival` (another elector's tick) to the end — so both read the
    same resourceVersion and the rival's CAS lands first."""

    def __init__(self, cluster, leases):
        self._cluster = cluster
        self._leases = leases
        self.rival = None

    def __getattr__(self, name):
        return getattr(self._cluster, name)

    def update(self, gvr, obj, namespace=None):
        if gvr.key == self._leases.key and self.rival is not None:
            rival, self.rival = self.rival, None
            rival()
        return self._cluster.update(gvr, obj, namespace)


def _election_script(pkg):
    le, fake, resources, faults, client = pkg
    cluster = fake.FakeCluster()
    le.install_fencing(cluster)
    clock = [1000.0]
    events, trace, electors = [], [], []

    def elector(ident, seed, api=cluster):
        el = le.LeaderElector(
            api, ident, lease_duration_s=LEASE_S, renew_interval_s=0.25,
            clock=lambda: clock[0], seed=seed,
            on_started_leading=lambda g: events.append((ident, "start", g)),
            on_stopped_leading=lambda r: events.append((ident, "stop", r)))
        electors.append(el)
        return el

    def snap(step):
        spec = cluster.get(resources.LEASES, le.LEASE_NAME,
                           le.LEASE_NAMESPACE)["spec"]
        trace.append((step, spec["holderIdentity"], spec["leaseTransitions"],
                      spec["leaseDurationSeconds"], spec["acquireTime"],
                      spec["renewTime"],
                      [(e.identity, e.is_leader, e.generation)
                       for e in electors]))

    a, b = elector("rep-a", 1), elector("rep-b", 2)
    a.tick()
    snap("acquire")
    b.tick()
    snap("standby")
    clock[0] += 0.5
    a.tick()
    snap("renew")
    b.tick()
    snap("standby inside the lease")
    clock[0] += LEASE_S + 0.2   # rep-a dies cold: no renew since
    b.tick()
    snap("takeover after expiry")
    a.tick()
    snap("deposed leader steps down")

    # Two standbys race one expired lease: both read the same RV; rep-d's
    # takeover lands first, rep-c's CAS is refused.
    clock[0] += LEASE_S + 0.5
    racing = RacingClient(cluster, resources.LEASES)
    c = elector("rep-c", 3, api=racing)
    d = elector("rep-d", 4)
    racing.rival = d.tick
    c.tick()
    snap("double takeover")

    # The leader's renews fail: it keeps acting until a lease duration
    # has passed since its last renew, then steps down.
    faults.FAULTS.arm("sched.lease_renew", faults.Always())
    try:
        clock[0] += 0.5
        d.tick()
        snap("renew failing inside the lease")
        clock[0] += 0.6
        d.tick()
        snap("renew failing past the lease")
    finally:
        faults.FAULTS.reset()

    # Fencing: the lease is at generation 3; a write stamped 2 (the
    # deposed rep-b) is refused, 3 and an unstamped write pass.
    claim = cluster.create(resources.RESOURCECLAIMS, {
        "apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
        "metadata": {"name": "c1", "namespace": "default"}, "spec": {}})
    verdicts = []
    for stamp in ("2", "3", None):
        cur = cluster.get(resources.RESOURCECLAIMS, "c1", "default")
        cur["metadata"]["annotations"] = (
            {} if stamp is None else {le.FENCING_ANNOTATION: stamp})
        try:
            cluster.update(resources.RESOURCECLAIMS, cur, "default")
            verdicts.append((stamp, "ok"))
        except client.ConflictError as e:
            verdicts.append((stamp, str(e)))
    assert claim["metadata"]["name"] == "c1"
    return trace, events, verdicts


def test_elector_script_matches_the_reference():
    pkgs = _packages()
    port = _election_script(pkgs["port"])
    ref = _election_script(pkgs["ref"])
    assert port == ref
    trace, events, verdicts = port
    assert [t[1] for t in trace] == [
        "rep-a", "rep-a", "rep-a", "rep-a", "rep-b", "rep-b", "rep-d",
        "rep-d", "rep-d"]
    assert [t[2] for t in trace] == [1, 1, 1, 1, 2, 2, 3, 3, 3]
    # rep-b has not ticked since rep-d took over: it still believes it
    # leads, and its stamp (2) is what fencing refuses below.
    assert trace[-1][-1] == [("rep-a", False, 1), ("rep-b", True, 2),
                             ("rep-c", False, None), ("rep-d", False, 3)]
    assert [e[:2] for e in events] == [
        ("rep-a", "start"), ("rep-b", "start"), ("rep-a", "stop"),
        ("rep-d", "start"), ("rep-d", "stop")]
    assert events[2][2] == "deposed by rep-b"
    assert events[4][2].startswith("renew failing past lease duration")
    assert verdicts[0][1].endswith(
        "fenced write refused (lease generation 2 < current 3)")
    assert verdicts[1:] == [("3", "ok"), (None, "ok")]


@pytest.mark.parametrize("t", [0.0, 1.5, 1e9 + 0.123456])
def test_lease_helpers_match_the_reference(t):
    from tpu_dra.k8s import fake as ref_fake

    assert port_fake.lease_micro_time(t) == ref_fake.lease_micro_time(t)
    stamp = port_fake.lease_micro_time(t)
    assert port_fake.parse_lease_micro_time(stamp) == \
        ref_fake.parse_lease_micro_time(stamp)
    assert port_fake.new_lease("l", "ns", "h", 0.4, t) == \
        ref_fake.new_lease("l", "ns", "h", 0.4, t)
    for bad in (None, "", "garbled"):
        assert port_fake.parse_lease_micro_time(bad) == 0.0


def test_stale_resource_version_lease_update_refused():
    """The fake's resourceVersion CAS is the compare half of the
    election: a Lease update carrying a stale RV is refused."""
    cluster = port_fake.FakeCluster()
    lease = cluster.create(port_resources.LEASES, port_fake.new_lease(
        port_le.LEASE_NAME, port_le.LEASE_NAMESPACE, "a", 1.0, 0.0))
    fresh = dict(lease, spec=dict(lease["spec"], holderIdentity="b"))
    cluster.update(port_resources.LEASES, fresh, port_le.LEASE_NAMESPACE)
    stale = dict(lease, spec=dict(lease["spec"], holderIdentity="c"))
    with pytest.raises(ConflictError):
        cluster.update(port_resources.LEASES, stale,
                       port_le.LEASE_NAMESPACE)
    assert cluster.get(port_resources.LEASES, port_le.LEASE_NAME,
                       port_le.LEASE_NAMESPACE)["spec"]["holderIdentity"] \
        == "b"


def test_scheduler_takes_the_electors_fencing_annotation():
    from tpu_dra_torch.simcluster import scheduler

    assert scheduler.FENCING_ANNOTATION is port_le.FENCING_ANNOTATION


class TestSchedulerHAFailover:
    """The port's counterparts of the reference's
    test_stress_failover.py::TestSchedulerHAFailover, on the port's
    Scheduler (one queue worker) behind tick-driven electors."""

    @staticmethod
    def _mk_sched(cluster):
        sched = Scheduler(cluster, resync_interval=0.05,
                          gc_sweep_interval=0.2)
        sched.start(standby=True)
        for inf in sched._informers.values():
            inf.RELIST_BACKOFF_BASE = 0.01
        return sched

    @staticmethod
    def _claim_of(cluster, pod_name):
        for c in cluster.list(port_resources.RESOURCECLAIMS,
                              namespace="default"):
            owner = (c["metadata"].get("annotations") or {}).get(
                "sim/owner-pod")
            if owner == pod_name:
                return c
        return None

    def _wait_allocated(self, cluster, pod_name, timeout=5.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            c = self._claim_of(cluster, pod_name)
            if c is not None and (c.get("status") or {}).get("allocation"):
                return c
            time.sleep(0.02)
        return None

    def test_standby_promotes_on_expiry(self):
        """The leader dies (renews stop); the warm standby waits out the
        lease, takes over, resyncs and allocates — stamped with the new
        generation."""
        cluster = port_fake.FakeCluster()
        port_le.install_fencing(cluster)
        seed_sched_inventory(cluster, nodes=2, gpus_per_node=2)
        clock = [0.0]
        scheds, electors = [], []
        try:
            for ident in ("rep-a", "rep-b"):
                sched = self._mk_sched(cluster)

                def on_started(gen, s=sched):
                    s.set_lease_generation(gen)
                    s.promote()

                electors.append(port_le.LeaderElector(
                    cluster, ident, lease_duration_s=LEASE_S,
                    renew_interval_s=0.25, clock=lambda: clock[0],
                    on_started_leading=on_started, seed=7))
                scheds.append(sched)

            electors[0].tick()  # creates the lease: rep-a leads
            assert electors[0].is_leader and not scheds[0].is_standby
            electors[1].tick()  # live foreign leader: stays standby
            assert not electors[1].is_leader and scheds[1].is_standby

            make_sched_pod(cluster, "pod-pre")
            claim = self._wait_allocated(cluster, "pod-pre")
            assert claim is not None, "leader never allocated"
            assert claim["metadata"]["annotations"][
                port_le.FENCING_ANNOTATION] == "1"

            clock[0] = LEASE_S * 0.5
            electors[1].tick()
            assert not electors[1].is_leader
            clock[0] = LEASE_S + 0.1
            electors[1].tick()
            assert electors[1].is_leader and not scheds[1].is_standby
            assert electors[1].generation == 2

            make_sched_pod(cluster, "pod-post")
            claim = self._wait_allocated(cluster, "pod-post")
            assert claim is not None, "standby never resumed allocation"
            # Both incarnations' workers saw the pod; only the new
            # generation's commit may land (rep-a is fenced).
            assert claim["metadata"]["annotations"][
                port_le.FENCING_ANNOTATION] == "2"
        finally:
            for sched in scheds:
                sched.stop()

    def test_deposed_fenced_write_refused(self):
        cluster = port_fake.FakeCluster()
        port_le.install_fencing(cluster)
        lease = port_fake.new_lease(port_le.LEASE_NAME,
                                    port_le.LEASE_NAMESPACE, "rep-b", 1.0,
                                    0.0)
        lease["spec"]["leaseTransitions"] = 2
        cluster.create(port_resources.LEASES, lease)
        claim = cluster.create(port_resources.RESOURCECLAIMS, {
            "apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
            "metadata": {"name": "c1", "namespace": "default"},
            "spec": {}})

        stale = dict(claim, metadata=dict(
            claim["metadata"],
            annotations={port_le.FENCING_ANNOTATION: "1"}))
        with pytest.raises(ConflictError, match="fenced write refused"):
            cluster.update(port_resources.RESOURCECLAIMS, stale, "default")

        current = dict(claim, metadata=dict(
            claim["metadata"],
            annotations={port_le.FENCING_ANNOTATION: "2"}))
        updated = cluster.update(port_resources.RESOURCECLAIMS, current,
                                 "default")

        unstamped = dict(updated, metadata=dict(
            updated["metadata"], annotations={}))
        cluster.update(port_resources.RESOURCECLAIMS, unstamped, "default")

    def test_double_takeover_race_single_winner(self):
        for round_i in range(10):
            cluster = port_fake.FakeCluster()
            cluster.create(port_resources.LEASES, port_fake.new_lease(
                port_le.LEASE_NAME, port_le.LEASE_NAMESPACE, "dead-leader",
                0.5, 0.0))
            clock = [100.0]  # far past expiry
            a = port_le.LeaderElector(
                cluster, "rep-a", lease_duration_s=0.5,
                clock=lambda: clock[0], seed=round_i)
            b = port_le.LeaderElector(
                cluster, "rep-b", lease_duration_s=0.5,
                clock=lambda: clock[0], seed=round_i + 1)
            barrier = threading.Barrier(2)

            def race(el):
                barrier.wait()
                el.tick()

            threads = [threading.Thread(target=race, args=(el,))
                       for el in (a, b)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            leaders = [el for el in (a, b) if el.is_leader]
            assert len(leaders) == 1, (
                f"round {round_i}: {len(leaders)} leaders after the race")
            lease = cluster.get(port_resources.LEASES, port_le.LEASE_NAME,
                                port_le.LEASE_NAMESPACE)
            assert lease["spec"]["leaseTransitions"] == 2
            assert lease["spec"]["holderIdentity"] == leaders[0].identity


class TestSchedInventory:
    """seed_sched_inventory / make_sched_pod against the reference's
    (tpu_dra/testing.py): the same objects, GPU attributes in place of
    the TPU ones."""

    def test_objects_match_the_reference_after_the_name_map(self):
        from tpu_dra import testing as ref_testing
        from tpu_dra.k8s import FakeCluster as RefCluster
        from tpu_dra.k8s import resources as ref_resources

        port_c, ref_c = port_fake.FakeCluster(), RefCluster()
        names = seed_sched_inventory(port_c, nodes=3, gpus_per_node=4,
                                     node_fmt="n{i:03d}",
                                     claim_counts=(2, 4))
        ref_names = ref_testing.seed_sched_inventory(
            ref_c, nodes=3, chips_per_node=4, node_fmt="n{i:03d}",
            claim_counts=(2, 4))
        assert names == ref_names
        port_t = port_c.list(port_resources.RESOURCECLAIMTEMPLATES,
                             namespace="default")
        ref_t = ref_c.list(ref_resources.RESOURCECLAIMTEMPLATES,
                           namespace="default")
        assert [t["metadata"]["name"] for t in port_t] == \
            [t["metadata"]["name"] for t in ref_t] == \
            ["tmpl", "tmpl2", "tmpl4"]
        for pt, rt in zip(port_t, ref_t):
            (preq,) = pt["spec"]["spec"]["devices"]["requests"]
            (rreq,) = rt["spec"]["spec"]["devices"]["requests"]
            assert preq["exactly"].get("count") == \
                rreq["exactly"].get("count")
            assert preq["exactly"]["deviceClassName"] == "gpu.dev"
        (dc,) = port_c.list(port_resources.DEVICECLASSES)
        assert dc["metadata"]["name"] == "gpu.dev"
        assert dc["spec"]["selectors"] == [
            {"cel": {"expression": DEFAULT_SCHED_SELECTOR}}]
        port_s = port_c.list(port_resources.RESOURCESLICES)
        ref_s = ref_c.list(ref_resources.RESOURCESLICES)
        assert [s["spec"]["nodeName"] for s in port_s] == \
            [s["spec"]["nodeName"] for s in ref_s]
        assert [len(s["spec"]["devices"]) for s in port_s] == \
            [len(s["spec"]["devices"]) for s in ref_s]
        port_pod = make_sched_pod(port_c, "p", template="tmpl2")
        ref_pod = ref_testing.make_sched_pod(ref_c, "p", template="tmpl2")
        assert port_pod["spec"] == ref_pod["spec"]

    def test_slices_carry_the_plugins_attribute_set(self, tmp_path):
        """A seeded node's slice publishes the attributes a GpuDriver
        publishes from a FakeBackend, and the placement scoring reads its
        topology: nodes_per_clique nodes share one clique id."""
        from tpu_dra_torch.gpuplugin.deviceinfo import enumerate_allocatable
        from tpu_dra_torch.native.gpuinfo import default_fake_gpus
        from tpu_dra_torch.topology import placement

        cluster = port_fake.FakeCluster()
        seed_sched_inventory(cluster, nodes=4, gpus_per_node=8,
                             nodes_per_clique=2)
        plugin = [d.to_resource_api() for d in enumerate_allocatable(
            default_fake_gpus(8, clique_id="x")).values()]
        slices = cluster.list(port_resources.RESOURCESLICES)
        for sl in slices:
            assert sl["spec"]["driver"] == "gpu.dev"
            for dev, ref in zip(sl["spec"]["devices"], plugin):
                assert dev["name"] == ref["name"]
                assert set(dev["attributes"]) == set(ref["attributes"])
        topos = [placement.node_topology_from_slices([sl]) for sl in slices]
        assert [(t.clique_id, t.worker_index) for t in topos] == [
            ("nvl-0", 0), ("nvl-0", 1), ("nvl-1", 0), ("nvl-1", 1)]
        assert all(len(t.coord_of) == 8 for t in topos)
        uuids = [d["attributes"]["uuid"]["string"]
                 for sl in slices for d in sl["spec"]["devices"]]
        assert len(set(uuids)) == len(uuids)

    def test_pods_of_each_template_are_allocated(self):
        from tpu_dra_torch.infra.metrics import TOPO_ALLOCS

        port_gates.Features.set_from_string("TopologyAwareScheduling=true")
        cluster = port_fake.FakeCluster()
        seed_sched_inventory(cluster, nodes=2, gpus_per_node=8,
                             claim_counts=(2, 4, 8))
        contig0 = TOPO_ALLOCS.value(labels={"outcome": "contiguous"})
        sched = Scheduler(cluster, resync_interval=0.05,
                          gc_sweep_interval=3600.0)
        sched.start()
        try:
            wants = {"one": ("tmpl", 1), "two": ("tmpl2", 2),
                     "four": ("tmpl4", 4), "eight": ("tmpl8", 8)}
            for pod, (tmpl, _) in wants.items():
                make_sched_pod(cluster, pod, template=tmpl)

            def placed():
                out = {}
                for c in cluster.list(port_resources.RESOURCECLAIMS,
                                      namespace="default"):
                    alloc = (c.get("status") or {}).get("allocation")
                    if alloc:
                        owner = c["metadata"]["annotations"]["sim/owner-pod"]
                        out[owner] = alloc["devices"]["results"]
                return out

            assert cluster.wait_for(lambda: len(placed()) == 4, timeout=10)
            got = placed()
            for pod, (_, n) in wants.items():
                results = got[pod]
                assert len(results) == n
                assert len({r["pool"] for r in results}) == 1
                assert all(r["driver"] == "gpu.dev" for r in results)
            for pod in wants:
                node = cluster.get(port_resources.PODS, pod,
                                   "default")["spec"]["nodeName"]
                assert node == got[pod][0]["pool"]
            assert sched.verify_index() == []
            assert sched.verify_topology() == []
            # Every multi-GPU pick took the placement scoring.
            assert TOPO_ALLOCS.value(labels={"outcome": "contiguous"}) \
                - contig0 == 3
        finally:
            sched.stop()
