"""The port's ComputeDomain controller (tpu_dra_torch.cdcontroller): the
behaviour tests of tests/test_cdcontroller.py, run on the port against
its FakeCluster, then its stamped objects held against the reference's.

Behaviours: stamping (finalizer, DaemonSet, RCTs), readiness transitions,
daemon-pod deletion handling, ordered teardown, and stale-object GC.

Parity (exact, after test_torch_cd_api.CD_NAME_MAP):
templates.daemon_daemonset, daemon_claim_template and
workload_claim_template against tpu_dra.cdcontroller.templates', and the
status.topology the controller stamps under TopologyAwareScheduling.
"""

import uuid

import pytest

from test_torch_cd_api import cd_to_port
from tpu_dra_torch.api import types as apitypes
from tpu_dra_torch.cdcontroller import Controller
from tpu_dra_torch.cdcontroller import templates
from tpu_dra_torch.cdcontroller.templates import daemon_object_name
from tpu_dra_torch.infra import featuregates
from tpu_dra_torch.infra.faults import FAULTS
from tpu_dra_torch.k8s import (
    COMPUTEDOMAINS, DAEMONSETS, FakeCluster, NODES, PODS,
    RESOURCECLAIMTEMPLATES,
)
from tpu_dra_torch.k8s.client import NotFoundError


@pytest.fixture(autouse=True)
def _reset_port_registries():
    featuregates.Features.reset()
    FAULTS.reset()
    yield
    featuregates.Features.reset()
    FAULTS.reset()


NS = "gpu-dra-driver"
LABEL = apitypes.COMPUTE_DOMAIN_LABEL_KEY


def make_cd(cluster, name="cd-1", namespace="user-ns", num_nodes=2,
            rct_name="my-workload-rct", allocation_mode="Single"):
    return cluster.create(COMPUTEDOMAINS, {
        "apiVersion": apitypes.API_VERSION,
        "kind": "ComputeDomain",
        "metadata": {"name": name, "namespace": namespace},
        "spec": {"numNodes": num_nodes,
                 "channel": {"resourceClaimTemplate": {"name": rct_name},
                             "allocationMode": allocation_mode}},
    })


@pytest.fixture
def harness():
    cluster = FakeCluster()
    controller = Controller(cluster, namespace=NS, image="img:test",
                            gc_interval=3600.0)
    controller.start()
    yield {"cluster": cluster, "controller": controller}
    controller.stop()


def get_cd(cluster, name="cd-1", namespace="user-ns"):
    return cluster.get(COMPUTEDOMAINS, name, namespace)


class TestStamping:
    def test_finalizer_and_objects_created(self, harness):
        cluster = harness["cluster"]
        cd = make_cd(cluster)
        dsname = daemon_object_name(cd)

        assert cluster.wait_for(lambda: apitypes.COMPUTE_DOMAIN_FINALIZER in (
            get_cd(cluster)["metadata"].get("finalizers") or []))
        assert cluster.wait_for(
            lambda: _exists(cluster, DAEMONSETS, dsname, NS))
        assert cluster.wait_for(
            lambda: _exists(cluster, RESOURCECLAIMTEMPLATES, dsname, NS))
        assert cluster.wait_for(lambda: _exists(
            cluster, RESOURCECLAIMTEMPLATES, "my-workload-rct", "user-ns"))

        ds = cluster.get(DAEMONSETS, dsname, NS)
        uid = cd["metadata"]["uid"]
        assert ds["metadata"]["labels"][LABEL] == uid
        assert ds["spec"]["template"]["spec"]["nodeSelector"][LABEL] == uid

        daemon_rct = cluster.get(RESOURCECLAIMTEMPLATES, dsname, NS)
        params = daemon_rct["spec"]["spec"]["devices"]["config"][0][
            "opaque"]["parameters"]
        assert params["kind"] == "ComputeDomainDaemonConfig"
        assert params["domainID"] == uid

        workload = cluster.get(RESOURCECLAIMTEMPLATES, "my-workload-rct",
                               "user-ns")
        params = workload["spec"]["spec"]["devices"]["config"][0][
            "opaque"]["parameters"]
        assert params["kind"] == "ComputeDomainChannelConfig"
        assert params["domainID"] == uid
        assert params["allocationMode"] == "Single"
        req = workload["spec"]["spec"]["devices"]["requests"][0]
        assert req["exactly"]["deviceClassName"] == apitypes.DEVICE_CLASS_CHANNEL

    def test_allocation_mode_all_propagated(self, harness):
        cluster = harness["cluster"]
        make_cd(cluster, name="cd-all", rct_name="rct-all",
                allocation_mode="All")
        assert cluster.wait_for(
            lambda: _exists(cluster, RESOURCECLAIMTEMPLATES, "rct-all",
                            "user-ns"))
        workload = cluster.get(RESOURCECLAIMTEMPLATES, "rct-all", "user-ns")
        params = workload["spec"]["spec"]["devices"]["config"][0][
            "opaque"]["parameters"]
        assert params["allocationMode"] == "All"

    def test_reconcile_idempotent(self, harness):
        cluster = harness["cluster"]
        cd = make_cd(cluster)
        dsname = daemon_object_name(cd)
        assert cluster.wait_for(lambda: _exists(cluster, DAEMONSETS, dsname, NS))
        # Force another pass; nothing should error or duplicate.
        harness["controller"].enqueue(cd["metadata"]["uid"])
        assert cluster.wait_for(lambda: len(
            cluster.list(DAEMONSETS, namespace=NS)) == 1)


class TestReadiness:
    """Readiness is counted from cd.status.nodes — the entries the
    domain daemons maintain (controller._update_readiness) — not the
    DaemonSet's kubelet-aggregated numberReady."""

    def _register_nodes(self, cluster, cd, ready, registered=None,
                        name=None):
        name = name or cd["metadata"]["name"]
        fresh = get_cd(cluster, name)
        n = registered if registered is not None else ready
        fresh.setdefault("status", {})["nodes"] = [
            {"name": f"node-{i}", "ipAddress": f"10.0.0.{i}",
             "cliqueID": "s0", "index": i,
             "status": "Ready" if i < ready else "NotReady"}
            for i in range(n)]
        cluster.update_status(COMPUTEDOMAINS, fresh)

    def test_ready_when_numnodes_met(self, harness):
        cluster = harness["cluster"]
        cd = make_cd(cluster, num_nodes=2)
        assert cluster.wait_for(
            lambda: _exists(cluster, DAEMONSETS, daemon_object_name(cd), NS))
        self._register_nodes(cluster, cd, ready=2)
        assert cluster.wait_for(lambda: (get_cd(cluster).get("status") or {})
                                .get("status") == "Ready")
        # Drop below numNodes: a previously-Ready domain DEGRADES (with
        # the why recorded), it does not read as never-started.
        self._register_nodes(cluster, cd, ready=1, registered=2)
        assert cluster.wait_for(lambda: get_cd(cluster)["status"]["status"]
                                == "Degraded")
        assert "1/2 members ready" in \
            get_cd(cluster)["status"]["statusReason"]
        # Recovery republishes cleanly: Ready again, reason gone.
        self._register_nodes(cluster, cd, ready=2)
        assert cluster.wait_for(lambda: get_cd(cluster)["status"]["status"]
                                == "Ready")
        assert "statusReason" not in get_cd(cluster)["status"]

    def test_numnodes_zero_follows_scheduled(self, harness):
        cluster = harness["cluster"]
        cd = make_cd(cluster, name="cd-z", num_nodes=0, rct_name="rct-z")
        assert cluster.wait_for(
            lambda: _exists(cluster, DAEMONSETS, daemon_object_name(cd), NS))
        self._register_nodes(cluster, cd, ready=3, name="cd-z")
        assert cluster.wait_for(
            lambda: (get_cd(cluster, "cd-z").get("status") or {})
            .get("status") == "Ready")
        # A registered-but-not-ready node degrades the previously-Ready
        # open-ended CD (every registered daemon must be ready).
        self._register_nodes(cluster, cd, ready=2, registered=3, name="cd-z")
        assert cluster.wait_for(
            lambda: get_cd(cluster, "cd-z")["status"]["status"] == "Degraded")

    def test_numnodes_zero_scheduled_lower_bound(self, harness):
        """A daemon pod scheduled but not yet registered (image pull in
        flight) must hold the open-ended CD NotReady: flipping Ready at
        ready==registered would let an early channel prepare snapshot a
        peer env missing the pending node."""
        cluster = harness["cluster"]
        cd = make_cd(cluster, name="cd-s", num_nodes=0, rct_name="rct-s")
        assert cluster.wait_for(
            lambda: _exists(cluster, DAEMONSETS, daemon_object_name(cd), NS))
        ds = cluster.get(DAEMONSETS, daemon_object_name(cd), NS)
        ds["status"] = {"numberReady": 0, "desiredNumberScheduled": 2}
        cluster.update_status(DAEMONSETS, ds)
        # One node registered+ready; DS says two are scheduled.
        self._register_nodes(cluster, cd, ready=1, name="cd-s")
        assert cluster.wait_for(
            lambda: (get_cd(cluster, "cd-s").get("status") or {})
            .get("status") == "NotReady")
        # Second daemon registers ready -> Ready.
        self._register_nodes(cluster, cd, ready=2, name="cd-s")
        assert cluster.wait_for(
            lambda: get_cd(cluster, "cd-s")["status"]["status"] == "Ready")

    def test_numnodes_zero_ready_settle(self):
        """Open-ended readiness holds through a settle window after the
        last membership change: expected membership lags label-driven
        daemon summoning, so the first node's readiness must not flip
        the domain Ready while later participants may still be labeling
        their nodes."""
        import time as _time

        cluster = FakeCluster()
        controller = Controller(cluster, namespace=NS, image="img:test",
                                gc_interval=3600.0, open_ready_settle_s=0.6)
        controller.start()
        try:
            cd = make_cd(cluster, name="cd-t", num_nodes=0,
                         rct_name="rct-t")
            assert cluster.wait_for(lambda: _exists(
                cluster, DAEMONSETS, daemon_object_name(cd), NS))
            self._register_nodes(cluster, cd, ready=1, name="cd-t")
            # Inside the settle window the domain must hold NotReady even
            # though every registered daemon is ready.
            _time.sleep(0.2)
            assert (get_cd(cluster, "cd-t").get("status") or {}).get(
                "status") != "Ready"
            # Window elapses with no membership change -> Ready, without
            # any further status traffic (the delayed re-enqueue fires).
            assert cluster.wait_for(
                lambda: (get_cd(cluster, "cd-t").get("status") or {}).get(
                    "status") == "Ready", timeout=5.0)
        finally:
            controller.stop()

    def test_numnodes_zero_restart_does_not_flap(self):
        """A restarted controller over an already-Ready open-ended domain
        adopts the member set as settled — re-arming the window would
        flap every stable CD to NotReady on each controller roll."""
        import time as _time

        cluster = FakeCluster()
        c1 = Controller(cluster, namespace=NS, image="img:test",
                        gc_interval=3600.0, open_ready_settle_s=0.3)
        c1.start()
        try:
            cd = make_cd(cluster, name="cd-r", num_nodes=0,
                         rct_name="rct-r")
            assert cluster.wait_for(lambda: _exists(
                cluster, DAEMONSETS, daemon_object_name(cd), NS))
            self._register_nodes(cluster, cd, ready=2, name="cd-r")
            assert cluster.wait_for(
                lambda: (get_cd(cluster, "cd-r").get("status") or {}).get(
                    "status") == "Ready", timeout=5.0)
        finally:
            c1.stop()
        # Restart with a LONG settle window: if the new controller
        # re-armed it, the domain would flip NotReady and stick there.
        c2 = Controller(cluster, namespace=NS, image="img:test",
                        gc_interval=3600.0, open_ready_settle_s=30.0)
        c2.start()
        try:
            c2.enqueue(cd["metadata"]["uid"])
            deadline = _time.monotonic() + 1.5
            while _time.monotonic() < deadline:
                assert (get_cd(cluster, "cd-r").get("status") or {}).get(
                    "status") == "Ready", "restart flapped a stable CD"
                _time.sleep(0.1)
        finally:
            c2.stop()


class TestPodDeletion:
    def test_pod_delete_removes_node_from_status(self, harness):
        cluster = harness["cluster"]
        cd = make_cd(cluster, num_nodes=2)
        uid = cd["metadata"]["uid"]

        # Daemon registered two nodes into the CD status (as cd-daemon does).
        fresh = get_cd(cluster)
        fresh["status"] = {"status": "Ready", "nodes": [
            {"name": "node-a", "ipAddress": "10.0.0.1", "cliqueID": "s0",
             "index": 0, "status": "Ready"},
            {"name": "node-b", "ipAddress": "10.0.0.2", "cliqueID": "s0",
             "index": 1, "status": "Ready"},
        ]}
        cluster.update_status(COMPUTEDOMAINS, fresh)

        pod = cluster.create(PODS, {
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": "daemon-b", "namespace": NS,
                         "labels": {LABEL: uid}},
            "status": {"podIP": "10.0.0.2"},
        })
        assert cluster.wait_for(lambda: _exists(cluster, PODS, "daemon-b", NS))
        cluster.delete(PODS, "daemon-b", NS)

        def node_b_gone():
            nodes = (get_cd(cluster).get("status") or {}).get("nodes") or []
            return [n["name"] for n in nodes] == ["node-a"]
        assert cluster.wait_for(node_b_gone)
        # Member loss mid-job: Ready -> Degraded with the member named —
        # never a CD stuck Ready with a dead member, never an anonymous
        # NotReady.
        status = get_cd(cluster)["status"]
        assert status["status"] == "Degraded"
        assert "node-b" in status["statusReason"]

    def test_member_loss_fault_retries_until_recorded(self, harness):
        """cd.member_loss firing on the first attempt must not leave the
        CD Ready with a dead member: the keyed queue item retries."""
        from tpu_dra_torch.infra.faults import FAULTS, OneShot

        cluster = harness["cluster"]
        cd = make_cd(cluster, name="cd-f", num_nodes=2, rct_name="rct-f")
        uid = cd["metadata"]["uid"]
        fresh = get_cd(cluster, "cd-f")
        fresh["status"] = {"status": "Ready", "nodes": [
            {"name": "node-a", "ipAddress": "10.0.0.1", "cliqueID": "s0",
             "index": 0, "status": "Ready"},
            {"name": "node-b", "ipAddress": "10.0.0.2", "cliqueID": "s0",
             "index": 1, "status": "Ready"},
        ]}
        cluster.update_status(COMPUTEDOMAINS, fresh)
        cluster.create(PODS, {
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": "daemon-f", "namespace": NS,
                         "labels": {LABEL: uid}},
            "status": {"podIP": "10.0.0.2"},
        })
        assert cluster.wait_for(lambda: _exists(cluster, PODS, "daemon-f", NS))
        with FAULTS.armed("cd.member_loss", OneShot()):
            cluster.delete(PODS, "daemon-f", NS)
            assert cluster.wait_for(
                lambda: get_cd(cluster, "cd-f")["status"]["status"]
                == "Degraded", timeout=10), \
                "member loss not recorded past the injected fault"
        nodes = get_cd(cluster, "cd-f")["status"]["nodes"]
        assert [n["name"] for n in nodes] == ["node-a"]

    def test_growth_settle_is_not_degraded(self):
        """A Ready open-ended CD gaining an all-ready member re-arms the
        settle window — that is GROWTH, not loss: the hold must read
        NotReady, never Degraded, and must not
        bump the regression counter."""
        import time as _time

        from tpu_dra_torch.cdcontroller.controller import degraded_total

        cluster = FakeCluster()
        controller = Controller(cluster, namespace=NS, image="img:test",
                                gc_interval=3600.0,
                                open_ready_settle_s=0.5)
        controller.start()
        try:
            cd = make_cd(cluster, name="cd-g", num_nodes=0,
                         rct_name="rct-g")
            assert cluster.wait_for(lambda: _exists(
                cluster, DAEMONSETS, daemon_object_name(cd), NS))

            def register(n_ready):
                fresh = get_cd(cluster, "cd-g")
                fresh.setdefault("status", {})["nodes"] = [
                    {"name": f"node-{i}", "ipAddress": f"10.0.0.{i}",
                     "cliqueID": "s0", "index": i, "status": "Ready"}
                    for i in range(n_ready)]
                cluster.update_status(COMPUTEDOMAINS, fresh)

            register(2)
            assert cluster.wait_for(
                lambda: (get_cd(cluster, "cd-g").get("status") or {})
                .get("status") == "Ready", timeout=5.0)
            before = degraded_total.value()
            # Growth: a third all-ready member joins.
            register(3)
            deadline = _time.monotonic() + 0.4
            while _time.monotonic() < deadline:
                assert (get_cd(cluster, "cd-g").get("status") or {}).get(
                    "status") != "Degraded", \
                    "growth misread as member loss"
                _time.sleep(0.05)
            assert cluster.wait_for(
                lambda: get_cd(cluster, "cd-g")["status"]["status"]
                == "Ready", timeout=5.0)
            assert degraded_total.value() == before
        finally:
            controller.stop()

    def test_never_ready_cd_stays_not_ready(self, harness):
        """Degraded is a REGRESSION state: a domain that never reached
        Ready keeps reading NotReady when members churn."""
        cluster = harness["cluster"]
        cd = make_cd(cluster, name="cd-n", num_nodes=2, rct_name="rct-n")
        assert cluster.wait_for(lambda: _exists(
            cluster, DAEMONSETS, daemon_object_name(cd), NS))
        fresh = get_cd(cluster, "cd-n")
        fresh["status"] = {"status": "NotReady", "nodes": [
            {"name": "node-a", "ipAddress": "10.0.0.1", "cliqueID": "s0",
             "index": 0, "status": "Ready"}]}
        cluster.update_status(COMPUTEDOMAINS, fresh)
        import time as _time
        _time.sleep(0.3)
        assert get_cd(cluster, "cd-n")["status"]["status"] == "NotReady"


class TestTeardown:
    def test_ordered_teardown(self, harness):
        cluster = harness["cluster"]
        cd = make_cd(cluster)
        uid = cd["metadata"]["uid"]
        dsname = daemon_object_name(cd)
        assert cluster.wait_for(lambda: _exists(cluster, DAEMONSETS, dsname, NS))
        assert cluster.wait_for(lambda: _exists(
            cluster, RESOURCECLAIMTEMPLATES, "my-workload-rct", "user-ns"))

        # A node labeled into this CD (as the CD kubelet plugin does).
        cluster.create(NODES, {
            "apiVersion": "v1", "kind": "Node",
            "metadata": {"name": "node-a", "labels": {LABEL: uid}}})
        assert cluster.wait_for(lambda: _exists(cluster, NODES, "node-a"))

        cluster.delete(COMPUTEDOMAINS, "cd-1", "user-ns")

        assert cluster.wait_for(
            lambda: not _exists(cluster, COMPUTEDOMAINS, "cd-1", "user-ns"))
        assert not _exists(cluster, DAEMONSETS, dsname, NS)
        assert not _exists(cluster, RESOURCECLAIMTEMPLATES, dsname, NS)
        assert not _exists(cluster, RESOURCECLAIMTEMPLATES,
                           "my-workload-rct", "user-ns")
        node = cluster.get(NODES, "node-a")
        assert LABEL not in (node["metadata"].get("labels") or {})


class TestTeardownRenamedRCT:
    def test_renamed_workload_rct_does_not_wedge_teardown(self, harness):
        """A workload RCT stamped under an older spec name still carries the
        CD label; teardown must collect it by label, not by current name."""
        cluster = harness["cluster"]
        cd = make_cd(cluster, rct_name="rct-new")
        uid = cd["metadata"]["uid"]
        assert cluster.wait_for(lambda: _exists(
            cluster, RESOURCECLAIMTEMPLATES, "rct-new", "user-ns"))
        # Simulate an RCT left over from a previous spec name.
        cluster.create(RESOURCECLAIMTEMPLATES, {
            "apiVersion": "resource.k8s.io/v1",
            "kind": "ResourceClaimTemplate",
            "metadata": {"name": "rct-old", "namespace": "user-ns",
                         "labels": {LABEL: uid}},
            "spec": {"spec": {}}})
        cluster.delete(COMPUTEDOMAINS, "cd-1", "user-ns")
        assert cluster.wait_for(
            lambda: not _exists(cluster, COMPUTEDOMAINS, "cd-1", "user-ns"))
        assert not _exists(cluster, RESOURCECLAIMTEMPLATES, "rct-old",
                           "user-ns")


class TestStalePodDeletion:
    def test_replacement_pod_with_same_ip_survives(self, harness):
        """hostNetwork daemons: the replacement pod reuses the node IP; the
        old pod's deletion event must not strip the registration."""
        cluster = harness["cluster"]
        cd = make_cd(cluster, num_nodes=1)
        uid = cd["metadata"]["uid"]
        fresh = get_cd(cluster)
        fresh["status"] = {"status": "Ready", "nodes": [
            {"name": "node-a", "ipAddress": "10.0.0.1", "cliqueID": "s0",
             "index": 0, "status": "Ready"}]}
        cluster.update_status(COMPUTEDOMAINS, fresh)
        for podname in ("daemon-old", "daemon-new"):
            cluster.create(PODS, {
                "apiVersion": "v1", "kind": "Pod",
                "metadata": {"name": podname, "namespace": NS,
                             "labels": {LABEL: uid}},
                "status": {"podIP": "10.0.0.1"}})
        assert cluster.wait_for(
            lambda: _exists(cluster, PODS, "daemon-new", NS))
        cluster.delete(PODS, "daemon-old", NS)
        import time
        time.sleep(0.5)  # give the (wrong) removal a chance to happen
        nodes = (get_cd(cluster).get("status") or {}).get("nodes") or []
        assert [n["name"] for n in nodes] == ["node-a"]


class TestCleanup:
    def test_sweep_collects_orphans(self, harness):
        cluster = harness["cluster"]
        ghost_uid = str(uuid.uuid4())
        cluster.create(RESOURCECLAIMTEMPLATES, {
            "apiVersion": "resource.k8s.io/v1",
            "kind": "ResourceClaimTemplate",
            "metadata": {"name": "orphan-rct", "namespace": NS,
                         "labels": {LABEL: ghost_uid}},
            "spec": {"spec": {}}})
        cluster.create(NODES, {
            "apiVersion": "v1", "kind": "Node",
            "metadata": {"name": "node-x", "labels": {LABEL: ghost_uid}}})
        harness["controller"]._cleanup.sweep()
        assert not _exists(cluster, RESOURCECLAIMTEMPLATES, "orphan-rct", NS)
        node = cluster.get(NODES, "node-x")
        assert LABEL not in (node["metadata"].get("labels") or {})

    def test_sweep_spares_live_cd_objects(self, harness):
        cluster = harness["cluster"]
        cd = make_cd(cluster)
        dsname = daemon_object_name(cd)
        assert cluster.wait_for(lambda: _exists(cluster, DAEMONSETS, dsname, NS))
        harness["controller"]._cleanup.sweep()
        assert _exists(cluster, DAEMONSETS, dsname, NS)


def _exists(cluster, gvr, name, ns=None):
    try:
        cluster.get(gvr, name, ns)
        return True
    except NotFoundError:
        return False


class TestDaemonSetUpgrade:
    def test_existing_daemonset_converges_on_new_template(self):
        """Controller upgrades must reach running CDs: on AlreadyExists the
        stamped DaemonSet is compared against the fresh template and
        updated when it differs (stamped objects are not create-only)."""
        cluster = FakeCluster()
        c1 = Controller(cluster, namespace=NS, image="img:v1",
                        gc_interval=3600.0)
        c1.start()
        try:
            cd = make_cd(cluster)
            dsname = daemon_object_name(cd)
            assert cluster.wait_for(
                lambda: _exists(cluster, DAEMONSETS, dsname, NS))
        finally:
            c1.stop()

        c2 = Controller(cluster, namespace=NS, image="img:v2",
                        gc_interval=3600.0)
        c2.start()
        try:
            c2.enqueue(cd["metadata"]["uid"])

            def image():
                ds = cluster.get(DAEMONSETS, dsname, NS)
                return ds["spec"]["template"]["spec"]["containers"][0]["image"]

            assert cluster.wait_for(lambda: image() == "img:v2")
        finally:
            c2.stop()

    def test_unchanged_daemonset_not_rewritten(self, harness):
        """Subset comparison: a reconcile with an identical template must
        not churn the object (server defaulting would otherwise cause a
        perpetual update loop)."""
        cluster = harness["cluster"]
        cd = make_cd(cluster)
        dsname = daemon_object_name(cd)
        assert cluster.wait_for(lambda: _exists(cluster, DAEMONSETS, dsname, NS))
        rv = cluster.get(DAEMONSETS, dsname, NS)["metadata"]["resourceVersion"]
        harness["controller"].enqueue(cd["metadata"]["uid"])
        import time
        time.sleep(0.3)
        assert (cluster.get(DAEMONSETS, dsname, NS)["metadata"]
                ["resourceVersion"] == rv)


# ---------------------------------------------------------------------------
# Stamped objects against the reference's
# ---------------------------------------------------------------------------

REF_CD = {"apiVersion": "resource.tpu.dev/v1beta1", "kind": "ComputeDomain",
          "metadata": {"name": "train", "namespace": "team", "uid": "u-1"},
          "spec": {"numNodes": 4, "channel": {
              "resourceClaimTemplate": {"name": "train-rct"},
              "allocationMode": "All"}}}


@pytest.mark.parametrize("kw", [
    {},
    {"log_verbosity": 4, "feature_gates": "TopologyAwareScheduling=true",
     "service_account": "cd-daemon"},
], ids=["defaults", "options"])
def test_daemon_daemonset_matches_reference(kw):
    """tpu_dra.cdcontroller.templates.daemon_daemonset, exact after the
    name map (its max-nodes argument named for cliques)."""
    from tpu_dra.cdcontroller import templates as ref
    want = ref.daemon_daemonset(
        REF_CD, namespace="tpu-dra-driver", image="img:1",
        daemon_claim_template=ref.daemon_object_name(REF_CD),
        max_nodes_per_slice_domain=16, **kw)
    got = templates.daemon_daemonset(
        cd_to_port(REF_CD), namespace="gpu-dra-driver", image="img:1",
        daemon_claim_template=templates.daemon_object_name(
            cd_to_port(REF_CD)),
        max_nodes_per_clique_domain=16, **kw)
    assert got == cd_to_port(want)


def test_claim_templates_match_reference():
    """tpu_dra.cdcontroller.templates.daemon_claim_template and
    workload_claim_template, exact after the name map."""
    from tpu_dra.cdcontroller import templates as ref
    port_cd = cd_to_port(REF_CD)
    assert templates.daemon_claim_template(
        port_cd, namespace="gpu-dra-driver") == cd_to_port(
        ref.daemon_claim_template(REF_CD, namespace="tpu-dra-driver"))
    assert templates.workload_claim_template(port_cd) == cd_to_port(
        ref.workload_claim_template(REF_CD))


def test_status_topology_stamped_like_reference(harness):
    """Under TopologyAwareScheduling a multi-node domain carries the
    member summary (placement.domain_topology) in status.topology; with
    one member, or with the gate off, none."""
    featuregates.Features.set_from_string("TopologyAwareScheduling=true")
    cluster = harness["cluster"]
    cd = make_cd(cluster, num_nodes=3)
    assert cluster.wait_for(
        lambda: _exists(cluster, DAEMONSETS, daemon_object_name(cd), NS))
    fresh = get_cd(cluster)
    fresh.setdefault("status", {})["nodes"] = [
        {"name": f"node-{i}", "ipAddress": f"10.0.0.{i}",
         "cliqueID": "c0" if i < 2 else "c1", "index": i % 2,
         "status": "Ready"} for i in range(3)]
    cluster.update_status(COMPUTEDOMAINS, fresh)
    assert cluster.wait_for(lambda: (get_cd(cluster).get("status") or {})
                            .get("topology") == {"cliques": 2,
                                                 "cliqueAligned": False})
    assert get_cd(cluster)["status"]["status"] == "Ready"
