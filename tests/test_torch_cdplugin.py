"""The port's ComputeDomain kubelet plugin (tpu_dra_torch.cdplugin): the
behaviour tests of tests/test_cdplugin.py, run on the port with the
port's names, then its workload env held against the reference's.

Behaviours: channel prepare (namespace assert -> node label -> blocked
readiness wait -> rendezvous env injection), daemon prepare (domain dir
+ identity env), channel exclusivity ordering, the retry envelope with
permanent-error short-circuit, checkpoint GC.

Parity: ``ComputeDomainManager.workload_env`` over single-clique and
multi-clique ``status.nodes`` against tpu_dra.cdplugin.computedomain's,
key for key and value for value after the name map
(test_torch_cd_api.CD_NAME_MAP; exact), plus the rendezvous keys the
port adds (PORT_ONLY_ENV), checked against the node order. And the
clique identity: node-local or per-GPU cliques read as no multi-node
NVLink domain, so two HGX nodes without a fabric manager never share a
clique.
"""

import json
import os
import threading
import time
import uuid

import pytest

from test_torch_cd_api import PORT_ONLY_ENV, cd_to_port
from tpu_dra_torch.api import types as apitypes
from tpu_dra_torch.cddaemon.computedomain import (
    ComputeDomainManager as DaemonCDManager,
)
from tpu_dra_torch.cdi.handler import CDIHandler
from tpu_dra_torch.cdplugin.cleanup import CheckpointCleanup
from tpu_dra_torch.cdplugin.computedomain import (
    ComputeDomainManager, PermanentError, RetryableNotReady,
)
from tpu_dra_torch.cdplugin.device_state import DeviceState
from tpu_dra_torch.cdplugin.driver import CDDriver
from tpu_dra_torch.cdplugin.deviceinfo import published_devices
from tpu_dra_torch.gpuplugin.checkpoint import CheckpointManager
from tpu_dra_torch.infra import featuregates
from tpu_dra_torch.infra.faults import FAULTS
from tpu_dra_torch.k8s import (
    COMPUTEDOMAINS, FakeCluster, NODES, RESOURCECLAIMS, RESOURCESLICES,
)
from tpu_dra_torch.kubeletplugin.server import Claim


@pytest.fixture(autouse=True)
def _reset_port_registries():
    featuregates.Features.reset()
    FAULTS.reset()
    yield
    featuregates.Features.reset()
    FAULTS.reset()


NS = "user-ns"
LABEL = apitypes.COMPUTE_DOMAIN_LABEL_KEY
DRIVER = apitypes.COMPUTE_DOMAIN_DRIVER_NAME


def make_cd(cluster, name="cd-1", namespace=NS, rct_name="rct"):
    return cluster.create(COMPUTEDOMAINS, {
        "apiVersion": apitypes.API_VERSION, "kind": "ComputeDomain",
        "metadata": {"name": name, "namespace": namespace},
        "spec": {"numNodes": 2, "channel": {
            "resourceClaimTemplate": {"name": rct_name},
            "allocationMode": "Single"}},
    })


def make_channel_claim(cluster, cd, devices=("channel-0",),
                       allocation_mode="Single", namespace=NS, name=None):
    cfg = {"apiVersion": apitypes.API_VERSION,
           "kind": "ComputeDomainChannelConfig",
           "domainID": cd["metadata"]["uid"],
           "allocationMode": allocation_mode}
    return _make_claim(cluster, devices, cfg, namespace, name)


def make_daemon_claim(cluster, cd, namespace="gpu-dra-driver"):
    cfg = {"apiVersion": apitypes.API_VERSION,
           "kind": "ComputeDomainDaemonConfig",
           "domainID": cd["metadata"]["uid"]}
    return _make_claim(cluster, ["daemon"], cfg, namespace, None)


def _make_claim(cluster, devices, cfg, namespace, name):
    return cluster.create(RESOURCECLAIMS, {
        "apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
        "metadata": {"name": name or f"claim-{uuid.uuid4().hex[:8]}",
                     "namespace": namespace},
        "spec": {"devices": {"requests": [{"name": "r0"}]}},
        "status": {"allocation": {"devices": {
            "results": [{"request": "r0", "driver": DRIVER,
                         "pool": "node-a", "device": d} for d in devices],
            "config": [{"requests": ["r0"],
                        "opaque": {"driver": DRIVER, "parameters": cfg}}],
        }}},
    })


def register_node(cluster, cd, node="node-a", ip="10.0.0.1",
                  clique_id="clique-A", index=0, ready=True):
    """Play the cd-daemon: insert the node into CD status. ready=True
    also plays the controller's readiness flip (channel prepare gates on
    domain-level Ready, not just this-node Ready — assert_node_ready)."""
    mgr = DaemonCDManager(
        cluster, cd_name=cd["metadata"]["name"],
        cd_namespace=cd["metadata"]["namespace"],
        cd_uid=cd["metadata"]["uid"], node_name=node, node_ip=ip,
        clique_id=clique_id)
    mgr.ensure_node_info()
    if ready:
        mgr.set_node_status(True)
        fresh = cluster.get(COMPUTEDOMAINS, cd["metadata"]["name"],
                            cd["metadata"]["namespace"])
        fresh.setdefault("status", {})["status"] = (
            apitypes.COMPUTE_DOMAIN_STATUS_READY)
        cluster.update_status(COMPUTEDOMAINS, fresh)
    return mgr


@pytest.fixture
def harness(tmp_path):
    cluster = FakeCluster()
    cluster.create(NODES, {"apiVersion": "v1", "kind": "Node",
                           "metadata": {"name": "node-a"}})
    cd_manager = ComputeDomainManager(
        cluster, node_name="node-a",
        driver_plugin_dir=str(tmp_path / "plugin"))
    cd_manager.start()
    cdi = CDIHandler(str(tmp_path / "cdi"),
                     vendor="k8s.compute-domain.gpu.dev")
    checkpoints = CheckpointManager(str(tmp_path / "plugin"))
    state = DeviceState(cd_manager=cd_manager, cdi=cdi,
                        checkpoints=checkpoints,
                        driver_name=DRIVER, node_name="node-a",
                        clique_id="clique-A")
    driver = CDDriver(state=state, client=cluster, driver_name=DRIVER,
                      node_name="node-a", clique_id="clique-A",
                      plugin_dir=str(tmp_path / "plugin"),
                      retry_timeout=3.0)
    driver.start()
    yield {"cluster": cluster, "cd_manager": cd_manager, "state": state,
           "driver": driver, "cdi": cdi, "tmp": tmp_path}
    driver.shutdown()
    cd_manager.stop()
    checkpoints.close()


def prepare(h, claim_obj):
    claim = Claim(uid=claim_obj["metadata"]["uid"],
                  name=claim_obj["metadata"]["name"],
                  namespace=claim_obj["metadata"]["namespace"])
    return h["driver"].prepare_claims([claim])[claim.uid]


def unprepare(h, claim_obj):
    claim = Claim(uid=claim_obj["metadata"]["uid"],
                  name=claim_obj["metadata"]["name"],
                  namespace=claim_obj["metadata"]["namespace"])
    return h["driver"].unprepare_claims([claim])[claim.uid]


def claim_env(h, claim_uid):
    path = os.path.join(str(h["tmp"] / "cdi"),
                        f"k8s.compute-domain.gpu.dev-claim_{claim_uid}.json")
    with open(path) as f:
        spec = json.load(f)
    return dict(e.split("=", 1)
                for e in spec["devices"][0]["containerEdits"]["env"])


class TestPublishing:
    def test_channel0_and_daemon_published(self, harness):
        slices = harness["cluster"].list(RESOURCESLICES)
        assert len(slices) == 1
        names = [d["name"] for d in slices[0]["spec"]["devices"]]
        assert names == ["channel-0", "daemon"]
        assert slices[0]["spec"]["driver"] == DRIVER


class TestChannelPrepare:
    def test_happy_path_injects_rendezvous_env(self, harness):
        cluster = harness["cluster"]
        cd = make_cd(cluster)
        register_node(cluster, cd, "node-a", "10.0.0.1", "clique-A", ready=True)
        register_node(cluster, cd, "node-b", "10.0.0.2", "clique-A", ready=True)
        claim = make_channel_claim(cluster, cd)
        res = prepare(harness, claim)
        assert res.error == ""
        # Node got labeled into the CD.
        node = cluster.get(NODES, "node-a")
        assert node["metadata"]["labels"][LABEL] == cd["metadata"]["uid"]
        env = claim_env(harness, claim["metadata"]["uid"])
        assert env["COMPUTE_DOMAIN_UUID"] == cd["metadata"]["uid"]
        assert env["GPU_WORKER_ID"] == "0"
        assert env["GPU_PROCESS_COUNT"] == "2"
        assert env["GPU_WORKER_HOSTNAMES"] == \
            "gpu-cd-daemon-0000,gpu-cd-daemon-0001"
        assert env["GPU_COORDINATOR_ADDRESS"] == "10.0.0.1:8476"
        assert env["GPU_CD_CHANNELS"] == "0"
        assert "GPU_NUM_CLIQUES" not in env  # homogeneous

    def test_blocks_until_node_ready_then_completes(self, harness):
        cluster = harness["cluster"]
        cd = make_cd(cluster)
        claim = make_channel_claim(cluster, cd)
        done = {}

        def run():
            done["res"] = prepare(harness, claim)

        t = threading.Thread(target=run)
        t.start()
        # The prepare retry loop labels the node; wait for the label (that
        # is what summons the daemon pod), then play the daemon.
        assert cluster.wait_for(
            lambda: (cluster.get(NODES, "node-a")["metadata"].get("labels")
                     or {}).get(LABEL) == cd["metadata"]["uid"], timeout=3)
        register_node(cluster, cd, "node-a", "10.0.0.1", ready=True)
        t.join(timeout=10)
        assert done["res"].error == ""

    def test_namespace_mismatch_is_permanent(self, harness):
        cluster = harness["cluster"]
        cd = make_cd(cluster)  # lives in user-ns
        claim = make_channel_claim(cluster, cd, namespace="other-ns")
        res = prepare(harness, claim)
        assert res.error.startswith("permanent")
        assert "does not match" in res.error

    def test_undersized_workload_degrades_after_settle_grace(self, harness,
                                                             monkeypatch):
        """A workload running fewer pods than spec.numNodes can never flip
        the domain Ready (daemons are summoned by its own labels): after
        the settle grace the gate degrades to this-node-Ready and the pod
        starts with a best-effort peer env instead of wedging forever."""
        from tpu_dra_torch.cdplugin.device_state import DeviceState as DS
        monkeypatch.setattr(DS, "DOMAIN_SETTLE_GRACE_S", 0.2)
        cluster = harness["cluster"]
        cd = make_cd(cluster)  # numNodes=2
        # Only THIS node's daemon registers and is ready; play the daemon
        # without the controller flip (domain stays NotReady).
        mgr = register_node(cluster, cd, "node-a", "10.0.0.1", ready=False)
        mgr.set_node_status(True)
        claim = make_channel_claim(cluster, cd)
        t0 = time.monotonic()
        res = prepare(harness, claim)
        assert res.error == ""
        assert time.monotonic() - t0 >= 0.2  # held strict for the grace
        env = claim_env(harness, claim["metadata"]["uid"])
        assert env["GPU_PROCESS_COUNT"] == "1"  # best-effort snapshot

    def test_per_cd_change_signal(self, harness):
        """wait_for_change is keyed by CD uid: churn on OTHER CDs must not
        wake a waiter (each spurious wake costs a claim fetch + prepare
        attempt on a real cluster)."""
        mgr = harness["state"]._cd
        cluster = harness["cluster"]
        cd_a = make_cd(cluster, name="cd-a", rct_name="rct-a")
        cd_b = make_cd(cluster, name="cd-b", rct_name="rct-b")
        assert cluster.wait_for(
            lambda: mgr.get_by_uid(cd_a["metadata"]["uid"]) is not None)
        # First churn on B also lets A's informer delivery settle (the
        # list/watch add events for a just-created CD can still be in
        # flight when get_by_uid first returns — snapshotting gen_a
        # before they land made this test flaky).
        register_node(cluster, cd_b, "node-x", "10.9.9.9", ready=True)
        assert cluster.wait_for(lambda: mgr.change_gen(
            cd_b["metadata"]["uid"]) > 0)
        gen_a = mgr.change_gen(cd_a["metadata"]["uid"])
        gen_b = mgr.change_gen(cd_b["metadata"]["uid"])
        # More churn on B; A's generation must not move.
        register_node(cluster, cd_b, "node-y", "10.9.9.10", ready=True)
        assert cluster.wait_for(lambda: mgr.change_gen(
            cd_b["metadata"]["uid"]) > gen_b)
        assert mgr.change_gen(cd_a["metadata"]["uid"]) == gen_a

    def test_retry_budget_exhausts_when_never_ready(self, harness):
        cluster = harness["cluster"]
        cd = make_cd(cluster)
        register_node(cluster, cd, "node-a", "10.0.0.1", ready=False)
        claim = make_channel_claim(cluster, cd)
        res = prepare(harness, claim)
        assert "retry budget exhausted" in res.error

    def test_allocation_mode_all(self, harness):
        cluster = harness["cluster"]
        cd = make_cd(cluster)
        register_node(cluster, cd, "node-a", "10.0.0.1", ready=True)
        claim = make_channel_claim(cluster, cd, allocation_mode="All")
        assert prepare(harness, claim).error == ""
        env = claim_env(harness, claim["metadata"]["uid"])
        assert env["GPU_CD_CHANNELS"] == "all"

    def test_heterogeneous_multislice_env(self, harness):
        cluster = harness["cluster"]
        cd = make_cd(cluster)
        register_node(cluster, cd, "node-a", "10.0.0.1", "clique-A")
        register_node(cluster, cd, "node-b", "10.0.0.2", "clique-B")
        claim = make_channel_claim(cluster, cd)
        assert prepare(harness, claim).error == ""
        env = claim_env(harness, claim["metadata"]["uid"])
        assert env["GPU_NUM_CLIQUES"] == "2"
        assert env["GPU_CLIQUE_INDEX"] == "0"  # clique-A sorts first
        assert env["GPU_PROCESS_COUNT"] == "1"  # only clique-A members
        # The multi-clique coordinator must be GLOBAL (same on every
        # clique): compute clique-B's view directly and compare.
        cd_fresh = cluster.get(COMPUTEDOMAINS, "cd-1", NS)
        env_b = ComputeDomainManager(
            cluster, node_name="node-b",
            driver_plugin_dir=str(harness["tmp"] / "b")).workload_env(
                cd_fresh, [0], "Single")
        assert (env_b["GPU_CLIQUES_COORDINATOR_ADDRESS"]
                == env["GPU_CLIQUES_COORDINATOR_ADDRESS"]
                == "10.0.0.1:8476")
        assert env_b["GPU_CLIQUE_INDEX"] == "1"
        # One rendezvous for the whole domain, each node its rank.
        assert (env_b["MASTER_ADDR"], env_b["MASTER_PORT"]) == \
            (env["MASTER_ADDR"], env["MASTER_PORT"]) == ("10.0.0.1", "8476")
        assert (env["NODE_RANK"], env_b["NODE_RANK"]) == ("0", "1")
        assert env["NNODES"] == env_b["NNODES"] == "2"

    def test_cd_topology_env_exported(self, harness):
        """The controller-stamped clique-alignment verdict
        (status.topology) surfaces in the workload env as GPU_CD_CLIQUES
        / GPU_CD_CLIQUE_ALIGNED; a CD without the stamp exports neither
        key."""
        cluster = harness["cluster"]
        cd = make_cd(cluster)
        register_node(cluster, cd, "node-a", "10.0.0.1", ready=True)
        mgr = ComputeDomainManager(
            cluster, node_name="node-a",
            driver_plugin_dir=str(harness["tmp"] / "topo"))
        cd_fresh = cluster.get(COMPUTEDOMAINS, "cd-1", NS)
        env = mgr.workload_env(cd_fresh, [0], "Single")
        assert "GPU_CD_CLIQUES" not in env
        assert "GPU_CD_CLIQUE_ALIGNED" not in env
        cd_fresh.setdefault("status", {})["topology"] = {
            "cliques": 2, "cliqueAligned": False}
        env = mgr.workload_env(cd_fresh, [0], "Single")
        assert env["GPU_CD_CLIQUES"] == "2"
        assert env["GPU_CD_CLIQUE_ALIGNED"] == "false"
        cd_fresh["status"]["topology"] = {"cliques": 1,
                                          "cliqueAligned": True}
        env = mgr.workload_env(cd_fresh, [0], "Single")
        assert env["GPU_CD_CLIQUES"] == "1"
        assert env["GPU_CD_CLIQUE_ALIGNED"] == "true"

    def test_idempotent(self, harness):
        cluster = harness["cluster"]
        cd = make_cd(cluster)
        register_node(cluster, cd, "node-a", "10.0.0.1", ready=True)
        claim = make_channel_claim(cluster, cd)
        res1 = prepare(harness, claim)
        res2 = prepare(harness, claim)
        assert res1.error == res2.error == ""
        assert (res1.devices[0].cdi_device_ids
                == res2.devices[0].cdi_device_ids)


class TestChannelExclusivity:
    def test_channel_held_by_other_claim_retries_then_fails(self, harness):
        cluster = harness["cluster"]
        cd = make_cd(cluster)
        register_node(cluster, cd, "node-a", "10.0.0.1", ready=True)
        claim1 = make_channel_claim(cluster, cd)
        assert prepare(harness, claim1).error == ""
        claim2 = make_channel_claim(cluster, cd)
        res = prepare(harness, claim2)
        assert "still prepared" in res.error
        # After unprepare of claim1, claim2 succeeds.
        assert unprepare(harness, claim1) == ""
        assert prepare(harness, claim2).error == ""

    def test_unprepare_releases_node_label_on_last_claim(self, harness):
        cluster = harness["cluster"]
        cd = make_cd(cluster)
        register_node(cluster, cd, "node-a", "10.0.0.1", ready=True)
        claim = make_channel_claim(cluster, cd)
        assert prepare(harness, claim).error == ""
        assert unprepare(harness, claim) == ""
        node = cluster.get(NODES, "node-a")
        assert LABEL not in (node["metadata"].get("labels") or {})


class TestConcurrentUnprepare:
    def test_concurrent_last_two_claims_release_label(self, harness):
        """Two concurrent unprepares of the last two channel claims of one
        CD must still release the node label: without whole-method
        serialization, each could see the other's claim still
        checkpointed, both would skip remove_node_label, and the label
        would leak with no kubelet retry left."""
        cluster = harness["cluster"]
        mgr = harness["cd_manager"]
        real_remove = mgr.remove_node_label
        calls = {"n": 0}

        def counting_remove(uid):
            calls["n"] += 1
            return real_remove(uid)

        mgr.remove_node_label = counting_remove
        try:
            for round_ in range(5):
                cd = make_cd(cluster, name=f"cd-conc-{round_}")
                register_node(cluster, cd, "node-a", "10.0.0.1", ready=True)
                c1 = make_channel_claim(cluster, cd, devices=("channel-1",))
                c2 = make_channel_claim(cluster, cd, devices=("channel-2",))
                assert prepare(harness, c1).error == ""
                assert prepare(harness, c2).error == ""
                calls["n"] = 0
                errs = {}
                ts = [threading.Thread(
                          target=lambda c=c, i=i: errs.__setitem__(
                              i, unprepare(harness, c)))
                      for i, c in enumerate((c1, c2))]
                for t in ts:
                    t.start()
                for t in ts:
                    t.join(timeout=10)
                assert errs == {0: "", 1: ""}
                # Serialized unprepare: the one that ran second saw an empty
                # still_used set and released the label.
                assert calls["n"] >= 1
                node = cluster.get(NODES, "node-a")
                assert LABEL not in (node["metadata"].get("labels") or {})
                cluster.delete(COMPUTEDOMAINS, cd["metadata"]["name"], NS)
        finally:
            mgr.remove_node_label = real_remove


class TestDaemonPrepare:
    def test_domain_dir_and_env(self, harness):
        cluster = harness["cluster"]
        cd = make_cd(cluster)
        claim = make_daemon_claim(cluster, cd)
        res = prepare(harness, claim)
        assert res.error == ""
        env = claim_env(harness, claim["metadata"]["uid"])
        assert env["COMPUTE_DOMAIN_UUID"] == cd["metadata"]["uid"]
        assert env["GPU_CLIQUE_ID"] == "clique-A"
        dom_dir = harness["cd_manager"].domain_dir(cd["metadata"]["uid"])
        assert os.path.isdir(dom_dir)
        assert "COMPUTE_DOMAIN_NAME=cd-1" in open(
            os.path.join(dom_dir, "domain.env")).read()

    def test_domain_dir_gc(self, harness):
        cluster = harness["cluster"]
        cd = make_cd(cluster)
        claim = make_daemon_claim(cluster, cd)
        assert prepare(harness, claim).error == ""
        uid = cd["metadata"]["uid"]
        # CD vanishes (bypass finalizers in fake by direct store surgery).
        cluster.delete(COMPUTEDOMAINS, "cd-1", NS)
        assert cluster.wait_for(
            lambda: harness["cd_manager"].get_by_uid(uid) is None)
        removed = harness["cd_manager"].gc_domain_dirs()
        assert uid in removed
        assert not os.path.isdir(harness["cd_manager"].domain_dir(uid))


class TestCheckpointGC:
    def test_abandoned_prepare_started_collected(self, harness):
        cluster = harness["cluster"]
        cd = make_cd(cluster)
        register_node(cluster, cd, "node-a", "10.0.0.1", ready=False)
        claim = make_channel_claim(cluster, cd)
        res = prepare(harness, claim)  # exhausts retry -> PrepareStarted
        assert "exhausted" in res.error
        uid = claim["metadata"]["uid"]
        assert uid in harness["state"].prepared_claim_uids()

        gc = CheckpointCleanup(client=cluster, state=harness["state"],
                               cd_manager=harness["cd_manager"])
        # Claim still exists: GC must keep it.
        assert gc.sweep() == 0
        assert uid in harness["state"].prepared_claim_uids()
        # Claim deleted: GC collects.
        cluster.delete(RESOURCECLAIMS, claim["metadata"]["name"], NS)
        assert gc.sweep() == 1
        assert uid not in harness["state"].prepared_claim_uids()

    def test_gc_drop_releases_leaked_node_label(self, harness):
        """An abandoned PREPARE_STARTED claim added the node label before
        its ResourceClaim was deleted; kubelet will never unprepare it, so
        GC's drop must run the same last-claim label accounting as
        unprepare — otherwise the label leaks forever."""
        cluster = harness["cluster"]
        cd = make_cd(cluster)
        register_node(cluster, cd, "node-a", "10.0.0.1", ready=False)
        claim = make_channel_claim(cluster, cd)
        res = prepare(harness, claim)  # label added, readiness never comes
        assert "exhausted" in res.error
        node = cluster.get(NODES, "node-a")
        assert (node["metadata"].get("labels") or {}).get(LABEL) \
            == cd["metadata"]["uid"]
        cluster.delete(RESOURCECLAIMS, claim["metadata"]["name"], NS)
        gc = CheckpointCleanup(client=cluster, state=harness["state"],
                               cd_manager=harness["cd_manager"])
        assert gc.sweep() == 1
        node = cluster.get(NODES, "node-a")
        assert LABEL not in (node["metadata"].get("labels") or {})

    def test_recreated_same_name_claim_not_collected(self, harness):
        cluster = harness["cluster"]
        cd = make_cd(cluster)
        register_node(cluster, cd, "node-a", "10.0.0.1", ready=False)
        claim = make_channel_claim(cluster, cd, name="stable-name")
        prepare(harness, claim)
        uid = claim["metadata"]["uid"]
        cluster.delete(RESOURCECLAIMS, "stable-name", NS)
        make_channel_claim(cluster, cd, name="stable-name")  # new UID
        gc = CheckpointCleanup(client=cluster, state=harness["state"],
                               cd_manager=harness["cd_manager"])
        assert gc.sweep() == 1  # old uid gone (uid comparison, not name)
        assert uid not in harness["state"].prepared_claim_uids()


class TestUnprepareRetry:
    def test_label_survives_failed_unprepare_for_kubelet_retry(self, harness):
        """Side-effect rollback must precede checkpoint removal: if label
        removal fails transiently, kubelet's unprepare retry still finds
        the claim and completes the cleanup (deleting the record first
        would make the retry a no-op and leak the label forever)."""
        cluster = harness["cluster"]
        cd = make_cd(cluster)
        register_node(cluster, cd, "node-a", "10.0.0.1", ready=True)
        claim = make_channel_claim(cluster, cd)
        assert prepare(harness, claim).error == ""

        mgr = harness["cd_manager"]
        real = mgr.remove_node_label
        calls = {"n": 0}

        def flaky(uid):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("transient api error")
            return real(uid)

        mgr.remove_node_label = flaky
        try:
            err = unprepare(harness, claim)
            assert "remove node label" in err
            # Claim record retained -> the retry has state to finish with.
            assert (claim["metadata"]["uid"]
                    in harness["state"].prepared_claim_uids())
            # Retry (kubelet re-calls unprepare) completes the cleanup.
            assert unprepare(harness, claim) == ""
        finally:
            mgr.remove_node_label = real
        assert (claim["metadata"]["uid"]
                not in harness["state"].prepared_claim_uids())
        node = cluster.get(NODES, "node-a")
        assert LABEL not in (node["metadata"].get("labels") or {})


class TestLegacyCheckpointBackfill:
    """Legacy (V1-era) checkpoint records lack claim name/namespace; the
    GC sweep must backfill identity from the API server by UID so they
    become collectible — or collect them immediately when the claim is
    gone everywhere."""

    def _make_legacy(self, harness, claim):
        """Strip identity from the checkpoint record, simulating a V1
        checkpoint loaded after upgrade."""
        state = harness["state"]
        with state._lock:
            rec = state._checkpoint.claims[claim["metadata"]["uid"]]
            rec.name = ""
            rec.namespace = ""
            state._ckpt_mgr.store(state._checkpoint)

    def test_backfill_then_collect(self, harness):
        cluster = harness["cluster"]
        cd = make_cd(cluster)
        register_node(cluster, cd, "node-a", "10.0.0.1", ready=False)
        claim = make_channel_claim(cluster, cd)
        res = prepare(harness, claim)  # readiness never comes
        assert "exhausted" in res.error
        uid = claim["metadata"]["uid"]
        self._make_legacy(harness, claim)

        gc = CheckpointCleanup(client=cluster, state=harness["state"],
                               cd_manager=harness["cd_manager"])
        # Claim still exists: sweep backfills identity, keeps the record.
        assert gc.sweep() == 0
        snap = harness["state"].checkpoint_snapshot()
        assert snap.claims[uid].name == claim["metadata"]["name"]
        assert snap.claims[uid].namespace == NS
        # Claim deleted: the (now-identified) record is collected.
        cluster.delete(RESOURCECLAIMS, claim["metadata"]["name"], NS)
        assert gc.sweep() == 1
        assert uid not in harness["state"].prepared_claim_uids()

    def test_orphan_legacy_record_collected_immediately(self, harness):
        cluster = harness["cluster"]
        cd = make_cd(cluster)
        register_node(cluster, cd, "node-a", "10.0.0.1", ready=False)
        claim = make_channel_claim(cluster, cd)
        res = prepare(harness, claim)
        assert "exhausted" in res.error
        uid = claim["metadata"]["uid"]
        self._make_legacy(harness, claim)
        cluster.delete(RESOURCECLAIMS, claim["metadata"]["name"], NS)

        gc = CheckpointCleanup(client=cluster, state=harness["state"],
                               cd_manager=harness["cd_manager"])
        # No claim with this UID anywhere -> abandoned, collected now,
        # including the node-label rollback drop_claim performs.
        assert gc.sweep() == 1
        assert uid not in harness["state"].prepared_claim_uids()
        node = cluster.get(NODES, "node-a")
        assert LABEL not in (node["metadata"].get("labels") or {})


class TestLostSpecRetry:
    def test_completed_claim_with_lost_spec_reprepares(self, harness):
        """A crash class: the terminal checkpoint sync survives a crash
        but the claim spec's never-synced rename does not. The idempotent fast path must NOT vouch for the vanished
        file — the retry re-runs the prepare and rewrites it."""
        cluster = harness["cluster"]
        cd = make_cd(cluster)
        register_node(cluster, cd, "node-a", "10.0.0.1", "clique-A",
                      ready=True)
        register_node(cluster, cd, "node-b", "10.0.0.2", "clique-A",
                      ready=True)
        claim = make_channel_claim(cluster, cd)
        assert prepare(harness, claim).error == ""
        uid = claim["metadata"]["uid"]
        spec_path = harness["cdi"].claim_spec_path(uid)
        os.unlink(spec_path)               # the crash-lost rename
        res = prepare(harness, claim)      # kubelet retry
        assert res.error == ""
        assert os.path.exists(spec_path)
        env = claim_env(harness, uid)
        assert env["COMPUTE_DOMAIN_UUID"] == cd["metadata"]["uid"]


# ---------------------------------------------------------------------------
# workload_env against the reference's
# ---------------------------------------------------------------------------

def _nodes(*members):
    """status.nodes of (name, ip, sliceID, index) members (reference
    names; cd_to_port maps them)."""
    return [{"name": n, "ipAddress": ip, "sliceID": s, "index": i,
             "status": "Ready"} for n, ip, s, i in members]


SINGLE = _nodes(("n-b", "10.0.0.2", "s0", 1), ("n-a", "10.0.0.1", "s0", 0),
                ("n-c", "10.0.0.3", "s0", 2))
MULTI = _nodes(("n-a", "10.0.0.1", "sA", 0), ("n-b", "10.0.0.2", "sA", 1),
               ("n-c", "10.0.1.1", "sB", 0), ("n-d", "10.0.1.2", "sB", 1))
LOOSE = _nodes(("n-a", "10.0.0.1", "", 0), ("n-b", "10.0.0.2", "", 1))
MIXED = _nodes(("n-a", "10.0.0.1", "", 0), ("n-b", "10.0.0.2", "sA", 0),
               ("n-c", "10.0.0.3", "sA", 1))
NO_ZERO = _nodes(("n-a", "10.0.0.1", "s0", 1), ("n-b", "10.0.0.2", "s0", 2))

ENV_CASES = [
    ("single", SINGLE, None),
    ("single_topology", SINGLE, {"slices": 1, "sliceAligned": True}),
    ("multi", MULTI, None),
    ("multi_topology", MULTI, {"slices": 2, "sliceAligned": False}),
    ("no_clique", LOOSE, None),
    ("mixed", MIXED, None),
    ("no_index_zero", NO_ZERO, None),
]
CHANNELS = [([0], "Single"), ([0, 3], "Single"), ([5], "All")]


def _env_pair(nodes, topology, me, channel_ids, mode, tmp_path):
    from tpu_dra.cdplugin.computedomain import (
        ComputeDomainManager as RefManager,
    )
    status = {"status": "Ready", "nodes": nodes}
    if topology is not None:
        status["topology"] = topology
    cd = {"apiVersion": "resource.tpu.dev/v1beta1", "kind": "ComputeDomain",
          "metadata": {"name": "cd", "namespace": "ns", "uid": "uid-1"},
          "spec": {"numNodes": len(nodes)}, "status": status}
    ref = RefManager(None, node_name=me,
                     driver_plugin_dir=str(tmp_path / "ref"))
    port = ComputeDomainManager(None, node_name=me,
                                driver_plugin_dir=str(tmp_path / "port"))
    return (ref.workload_env(cd, channel_ids, mode),
            port.workload_env(cd_to_port(cd), channel_ids, mode))


@pytest.mark.parametrize("channels", CHANNELS, ids=lambda c: f"{c[1]}{c[0]}")
@pytest.mark.parametrize("case", ENV_CASES, ids=lambda c: c[0])
def test_workload_env_matches_reference(case, channels, tmp_path):
    """Every node's env of each member set: the reference's env, mapped
    (tpu_dra.cdplugin.computedomain.ComputeDomainManager.workload_env,
    exact), equals the port's without its rendezvous keys; those name
    the global coordinator (index 0 of the first clique in sorted order:
    the reference's multi-slice coordinator) at the coordinator port and
    the node's place in (clique, index) order."""
    _name, nodes, topology = case
    channel_ids, mode = channels
    order = sorted(nodes, key=lambda n: (n["sliceID"], n["index"]))
    first = order[0]["sliceID"]
    coord = next((n for n in order
                  if n["sliceID"] == first and n["index"] == 0), None)
    for me in (n["name"] for n in nodes):
        ref, port = _env_pair(nodes, topology, me, channel_ids, mode,
                              tmp_path)
        assert {k: v for k, v in port.items()
                if k not in PORT_ONLY_ENV} == cd_to_port(ref)
        rank = [n["name"] for n in order].index(me)
        want = {"NODE_RANK": str(rank), "NNODES": str(len(nodes))}
        if coord is not None:
            want.update(MASTER_ADDR=coord["ipAddress"], MASTER_PORT="8476")
        assert {k: port[k] for k in PORT_ONLY_ENV if k in port} == want
        if len({n["sliceID"] for n in nodes}) > 1 and coord is not None:
            assert ref["MEGASCALE_COORDINATOR_ADDRESS"] == \
                f"{port['MASTER_ADDR']}:{port['MASTER_PORT']}"


def test_coordinator_port_flag_reaches_the_env(tmp_path):
    """The CD plugin's --coordinator-port (default the reference's 8476)
    is the env's MASTER_PORT and the coordinators' port."""
    from tpu_dra_torch.cdplugin.main import flags

    assert flags().parse(["--node-name", "n"]).coordinator_port == 8476
    assert flags().parse(["--node-name", "n", "--coordinator-port",
                          "9100"]).coordinator_port == 9100
    mgr = ComputeDomainManager(None, node_name="n-a",
                               driver_plugin_dir=str(tmp_path),
                               coordinator_port=9100)
    env = mgr.workload_env({"metadata": {"uid": "u"}, "status": {
        "nodes": cd_to_port(SINGLE)}}, [0], "Single")
    assert env["MASTER_PORT"] == "9100"
    assert env["GPU_COORDINATOR_ADDRESS"] == "10.0.0.1:9100"


# ---------------------------------------------------------------------------
# Clique identity
# ---------------------------------------------------------------------------

def _gpus(count, clique_id="", no_links=False, worker=0):
    import dataclasses

    from tpu_dra_torch.native import gpuinfo
    gpus = gpuinfo.default_fake_gpus(count, clique_id=clique_id,
                                     worker_index=worker)
    if no_links:   # NVML's reading of a GPU with no active NVLink
        gpus = [dataclasses.replace(g, clique_id=g.uuid) for g in gpus]
    return gpus


class TestCliqueIdentity:
    def test_discovery_maps_node_local_and_linkless_to_no_domain(self):
        from tpu_dra_torch.cddaemon.main import discover_clique_id
        from tpu_dra_torch.native.gpuinfo import FakeBackend

        fabric = "0a1b2c3d-0000-4000-8000-00000000beef.7"
        assert discover_clique_id(FakeBackend(_gpus(8))) == ""
        assert discover_clique_id(FakeBackend(_gpus(1, no_links=True))) \
            == ""
        assert discover_clique_id(FakeBackend(_gpus(4, fabric))) == fabric
        assert discover_clique_id(FakeBackend([])) == ""
        with pytest.raises(RuntimeError, match="disagree"):
            discover_clique_id(FakeBackend(
                _gpus(2, fabric) + [g for g in _gpus(4, fabric + "x")
                                    if g.index >= 2]))

    @pytest.mark.parametrize("no_links", [False, True],
                             ids=["node_local", "per_gpu"])
    def test_two_hgx_nodes_without_fabric_never_share_a_clique(
            self, no_links, tmp_path):
        """Two 8-GPU nodes whose NVML reads no fabric clique (the
        node-local clique "", or each GPU its own clique when no NVLink
        is active) through the whole stack: each daemon registers
        cliqueID "", the controller's status.topology counts no clique
        and no alignment, and each channel env says so."""
        from tpu_dra_torch.native.gpuinfo import FakeBackend
        from tpu_dra_torch.testing import DomainSim

        featuregates.Features.set_from_string("TopologyAwareScheduling=true")
        backends = {"hgx-a": FakeBackend(_gpus(8, no_links=no_links)),
                    "hgx-b": FakeBackend(_gpus(8, no_links=no_links,
                                               worker=1))}
        with DomainSim(backends, namespace="clq",
                       root=str(tmp_path)) as sim:
            assert [n.clique_id for n in sim.nodes] == ["", ""]
            cd = sim.create_cd("clq")

            def stamped():
                st = sim.cluster.get(COMPUTEDOMAINS, "clq", "clq").get(
                    "status") or {}
                return st.get("topology") is not None
            res = sim.prepare_channels(cd)
            assert res["ok"], res["error"]
            assert sim.cluster.wait_for(stamped, timeout=10)
            status = sim.cluster.get(COMPUTEDOMAINS, "clq", "clq")["status"]
            assert [n["cliqueID"] for n in status["nodes"]] == ["", ""]
            assert status["topology"] == {"cliques": 0,
                                          "cliqueAligned": False}
            for env in res["envs"].values():
                assert env["GPU_CLIQUE_ID"] == ""
                assert "GPU_NUM_CLIQUES" not in env
            left = sim.teardown(cd, res["claims"])
            assert left["cd_deleted"] and not left["labeled_nodes"]

    def test_one_fabric_clique_is_one_domain(self):
        """Nodes whose GPUs report one fabric clique id ARE one NVLink
        domain: the controller's summary counts one aligned clique."""
        from tpu_dra_torch.topology.placement import domain_topology

        fabric = "0a1b2c3d-0000-4000-8000-00000000beef.7"
        assert domain_topology([{"cliqueID": fabric, "index": i}
                                for i in range(2)]) == \
            {"cliques": 1, "cliqueAligned": True}
