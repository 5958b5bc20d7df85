"""The port's cluster tier end to end on the CPU: a two-node SimCluster
(tpu_dra_torch.simcluster) over fake per-node GPU inventories, the driver
installed from the port's chart (manifests.all_manifests(): the chart's
default render, the webhook with a self-signed cert), and the quickstart
demos applied as a user would.

Every driver component runs as a subprocess from the chart's manifests:
both kubelet plugins per node, the compute-domain controller, the
webhook, and a domain daemon per member node. The pods' claims are
allocated by the sim scheduler and prepared by the plugins over their
dra.sock; each container runs with its claims' CDI env. Checked: two
exclusive-GPU pods on distinct GPUs, a claim shared by two containers, a
MIG pod, a two-node ComputeDomain across two NVLink cliques whose pods
read NODE_RANK/NNODES/MASTER_ADDR, a pod without a claim reading
CUDA_VISIBLE_DEVICES="", a pod that trains a small model through
``bench claim-child``, a bad opaque config denied at admission, and
after deletion every claim deallocated and no claim spec left on a node.

The reference's cluster tier gives no run to compare against (its
multi-node SimCluster cannot start), so this holds the port to the
reference's module behaviour, which tests/test_torch_simcluster.py,
test_torch_webhook.py and test_torch_deploy_chart.py compare directly.
"""

import json
import math
import os
import shutil
import time

import pytest

from tpu_dra_torch.api.types import API_VERSION, GPU_DRIVER_NAME
from tpu_dra_torch.cdi.handler import CDIHandler
from tpu_dra_torch.deploy import demos, manifests
from tpu_dra_torch.k8s import PODS, RESOURCECLAIMS, RESOURCESLICES
from tpu_dra_torch.k8s.client import ApiError
from tpu_dra_torch.simcluster import SimCluster
from tpu_dra_torch.simcluster.cluster import short_workdir

ENV_KEYS = ("CUDA_VISIBLE_DEVICES", "NODE_RANK", "NNODES", "MASTER_ADDR",
            "MASTER_PORT")
PRINT_ENV = ["python", "-c",
             "import json, os; print(json.dumps({k: os.environ.get(k) "
             f"for k in {ENV_KEYS!r}}}))"]
SMALL = json.dumps(dict(vocab=128, d_model=64, n_heads=2, n_layers=2,
                        d_ff=128, max_seq=64, dtype="float32"))
TRAIN = ["python", "-m", "tpu_dra_torch.bench", "claim-child",
         "--device-type", "cpu", "--steps", "2", "--config", SMALL]
TIMEOUT_S = 120.0


def _wait(pred, timeout=TIMEOUT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            got = pred()
        except Exception:  # noqa: BLE001 — a read racing a write
            got = None
        if got:
            return got
        time.sleep(0.1)
    return None


def _ended(api, ns, n):
    pods = api.list(PODS, namespace=ns)
    return len(pods) == n and all(
        (p.get("status") or {}).get("phase") in ("Succeeded", "Failed")
        for p in pods)


def _one_thread(pod):
    for ctr in pod["spec"]["containers"]:
        ctr["env"] = [{"name": "OMP_NUM_THREADS", "value": "1"}]
    return pod


@pytest.fixture(scope="module")
def run():
    """The cluster, the chart, every demo applied at once, run to the
    end; yields (cluster, {namespace: [pod]}) and tears down."""
    work = short_workdir("sce-")
    cluster = SimCluster(work, num_nodes=2, gpus_per_node=4,
                         clique_ids=["clique-a", "clique-b"], mig_gpus=[3])
    cluster.start()
    try:
        cluster.install(manifests.all_manifests())
        assert _wait(lambda: len(cluster.api.list(RESOURCESLICES)) == 4), \
            "the plugins never published"
        no_claim = {"apiVersion": "v1", "kind": "Namespace",
                    "metadata": {"name": "gpu-none"}}
        bare = {"apiVersion": "v1", "kind": "Pod",
                "metadata": {"name": "bare", "namespace": "gpu-none"},
                "spec": {"restartPolicy": "Never", "containers": [
                    {"name": "ctr", "command": PRINT_ENV}]}}
        # A claim stays allocated until its pod is deleted, so the pods
        # must fit at once: 8 GPUs, the domain's pods placed first (one
        # GPU and the one channel of each node), then 5 whole GPUs and a
        # MIG device of a GPU 3.
        cluster.install(demos.cd_train(2, PRINT_ENV))
        assert _wait(lambda: all(
            p["spec"].get("nodeName") for p in
            cluster.api.list(PODS, namespace="gpu-cd")) and len(
            cluster.api.list(PODS, namespace="gpu-cd")) == 2), \
            "the domain's pods were never bound"
        docs = (demos.test1_exclusive_per_pod(PRINT_ENV)
                + demos.test2_shared_claim_two_containers(PRINT_ENV)
                + demos.test5_mig(PRINT_ENV, pods=1)
                + [no_claim, bare])
        train = demos.test4_multi_gpu(TRAIN, count=2)
        train[-1] = _one_thread(train[-1])
        cluster.install(docs + train)
        want = {"gpu-test1": 2, "gpu-test2": 1, "gpu-test5": 1,
                "gpu-cd": 2, "gpu-none": 1, "gpu-test4": 1}
        for ns, n in want.items():
            assert _wait(lambda: _ended(cluster.api, ns, n)), \
                f"{ns}: pods never ended"
        yield cluster, {ns: cluster.api.list(PODS, namespace=ns)
                        for ns in want}
    finally:
        cluster.stop()
        shutil.rmtree(work, ignore_errors=True)


def _env(cluster, pod, ctr="ctr"):
    return json.loads(cluster.pod_log(pod, ctr).strip().splitlines()[-1])


def _claim(cluster, pod, entry="gpu"):
    name = {s["name"]: s["resourceClaimName"] for s in
            pod["status"]["resourceClaimStatuses"]}[entry]
    return cluster.api.get(RESOURCECLAIMS, name,
                           pod["metadata"]["namespace"])


def _uuid_of(cluster, node, device):
    for sl in cluster.api.list(RESOURCESLICES):
        if sl["spec"]["nodeName"] == node and \
                sl["spec"]["driver"] == GPU_DRIVER_NAME:
            for d in sl["spec"]["devices"]:
                if d["name"] == device:
                    return d["attributes"]["uuid"]["string"]
    raise KeyError((node, device))


def _results(claim):
    return claim["status"]["allocation"]["devices"]["results"]


def test_every_pod_succeeded(run):
    cluster, pods = run
    for ns, items in pods.items():
        for p in items:
            assert p["status"]["phase"] == "Succeeded", (
                ns, p["metadata"]["name"],
                cluster.pod_log(p, p["spec"]["containers"][0]["name"]))


def test_exclusive_pods_on_distinct_gpus(run):
    cluster, pods = run
    seen = set()
    for p in pods["gpu-test1"]:
        (r,) = _results(_claim(cluster, p))
        assert r["pool"] == p["spec"]["nodeName"]
        seen.add((r["pool"], r["device"]))
        assert _env(cluster, p)["CUDA_VISIBLE_DEVICES"] == \
            _uuid_of(cluster, r["pool"], r["device"])
    assert len(seen) == 2


def test_claim_shared_by_two_containers(run):
    cluster, pods = run
    (p,) = pods["gpu-test2"]
    (r,) = _results(_claim(cluster, p))
    uuid = _uuid_of(cluster, r["pool"], r["device"])
    assert [_env(cluster, p, c)["CUDA_VISIBLE_DEVICES"]
            for c in ("ctr0", "ctr1")] == [uuid, uuid]


def test_mig_pod(run):
    cluster, pods = run
    (p,) = pods["gpu-test5"]
    (r,) = _results(_claim(cluster, p))
    assert r["device"].startswith("gpu-3-mig-"), r
    assert _env(cluster, p)["CUDA_VISIBLE_DEVICES"].startswith("MIG-")


def test_compute_domain_across_cliques(run):
    cluster, pods = run
    envs = {p["spec"]["nodeName"]: _env(cluster, p)
            for p in pods["gpu-cd"]}
    assert sorted(envs) == ["n0", "n1"]
    assert sorted(e["NODE_RANK"] for e in envs.values()) == ["0", "1"]
    assert {e["NNODES"] for e in envs.values()} == {"2"}
    assert len({(e["MASTER_ADDR"], e["MASTER_PORT"])
                for e in envs.values()}) == 1
    assert None not in {e["MASTER_ADDR"] for e in envs.values()}
    for p in pods["gpu-cd"]:
        (ch,) = _results(_claim(cluster, p, "channel"))
        assert ch["pool"] == p["spec"]["nodeName"]


def test_pod_without_claim_sees_no_gpu(run):
    cluster, pods = run
    (p,) = pods["gpu-none"]
    assert _env(cluster, p)["CUDA_VISIBLE_DEVICES"] == ""


def test_pod_trains_on_its_claim(run):
    cluster, pods = run
    (p,) = pods["gpu-test4"]
    rec = _env(cluster, p)
    assert rec["steps"] == 2 and all(math.isfinite(x)
                                     for x in rec["losses"])
    got = sorted(rec["claim_uuids"])
    want = sorted(_uuid_of(cluster, r["pool"], r["device"])
                  for r in _results(_claim(cluster, p)))
    assert got == want and len(got) == 2


def test_bad_config_denied_at_admission(run):
    cluster, _ = run
    bad = {"apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
           "metadata": {"name": "bad", "namespace": "default"},
           "spec": {"devices": {
               "requests": [{"name": "gpu", "exactly": {
                   "deviceClassName": "gpu.dev"}}],
               "config": [{"requests": ["gpu"], "opaque": {
                   "driver": GPU_DRIVER_NAME, "parameters": {
                       "apiVersion": API_VERSION, "kind": "GpuConfig",
                       "bogus": 1}}}]}}}

    def denied():
        try:
            cluster.api.create(RESOURCECLAIMS, bad, namespace="default")
        except ApiError as e:
            return "denied the request" in str(e)
        cluster.api.delete(RESOURCECLAIMS, "bad", "default")
        return False  # admitted: the webhook pod is not serving yet

    assert _wait(denied, 60)


def test_deletion_deallocates_and_unprepares(run):
    cluster, pods = run
    for ns, items in pods.items():
        for p in items:
            cluster.api.delete(PODS, p["metadata"]["name"], ns)
    assert _wait(lambda: not [c for ns in pods for c in
                              cluster.api.list(RESOURCECLAIMS,
                                               namespace=ns)]), \
        "template claims outlived their pods"
    for node in ("n0", "n1"):
        cdi = CDIHandler(os.path.join(cluster.node_dir(node), "fs", "var",
                                      "run", "cdi"))
        assert _wait(lambda: cdi.list_claim_uids() == [], 30), node
