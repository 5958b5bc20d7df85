"""Port parity: the sim cluster's control plane (tpu_dra_torch.simcluster
gvk, cel, scheduler, workloads; k8s.fakeserver; topology.placement's
scheduler half) against tpu_dra's, in one process on the CPU.

- gvk: the port's kind table agrees with its fake API server's registry,
  and its aliases resolve as the reference's do.
- CEL: the same expressions over the same typed attribute dicts give the
  reference's results (True, False, or a CelError), short-circuit
  included; the compile cache keeps the reference's counts.
- placement: best_placement, max_free_cuboid, fragmentation_score,
  enumerate_shapes and rank_candidate_nodes pick exactly what the
  reference's pick, on the reference's own Mesh blocks (the port's read
  any block with dims, wrap and neighbors).
- scheduler: the reference's TestScheduler cases for GPUs and MIG
  devices, and the port's allocations held against the reference's on
  the same inventory and claims after the name map (chip-N <-> gpu-N,
  chip-N-ss... <-> gpu-N-mig-...); event mode, GC, eviction, standby.
- WorkloadController: the reference's DaemonSet cases.
"""

import json
import os
import random
import threading
import time
import urllib.request

import pytest

from tpu_dra.k8s import FakeCluster as RefCluster
from tpu_dra.k8s import resources as ref_res
from tpu_dra.simcluster import cel as ref_cel
from tpu_dra.simcluster.gvk import resolve_kind as ref_resolve_kind
from tpu_dra.simcluster.scheduler import Scheduler as RefScheduler
from tpu_dra.topology import mesh as ref_mesh
from tpu_dra.topology import placement as ref_placement
from tpu_dra_torch.infra import featuregates
from tpu_dra_torch.infra.faults import FAULTS
from tpu_dra_torch.infra.metrics import (
    CEL_CACHE_HITS, CEL_CACHE_MISSES, CEL_COMPILES,
)
from tpu_dra_torch.k8s import (
    DAEMONSETS, DEVICECLASSES, NODES, PODS, RESOURCECLAIMS,
    RESOURCECLAIMTEMPLATES, RESOURCESLICES, FakeCluster, HttpApiClient,
)
from tpu_dra_torch.k8s.fakeserver import KNOWN_GVRS, FakeApiServer
from tpu_dra_torch.simcluster import cel
from tpu_dra_torch.simcluster.gvk import (
    _KINDS, gvr_for_doc, gvr_for_kind, resolve_kind,
)
from tpu_dra_torch.simcluster.scheduler import (
    FENCING_ANNOTATION, AllocationIndex, Scheduler,
)
from tpu_dra_torch.simcluster.workloads import WorkloadController
from tpu_dra_torch.topology import placement
from tpu_dra_torch.topology.mesh import NvlinkFabric


@pytest.fixture(autouse=True)
def _port_globals():
    """The port's own feature gates, faults and CEL cache (conftest
    resets only the reference's)."""
    featuregates.Features.reset()
    FAULTS.reset()
    cel.clear_cache()
    yield
    featuregates.Features.reset()
    FAULTS.reset()
    cel.clear_cache()


# ---------------------------------------------------------------------------
# gvk + fake API server
# ---------------------------------------------------------------------------

class TestGvk:
    @pytest.mark.parametrize("alias", [
        "po", "pods", "cd", "rct", "deviceclass", "crd", "ds", "rs", "dc",
        "svc", "sa", "deploy", "node", "secrets", "clusterrolebinding",
        "validatingwebhookconfiguration", "nosuchkind",
    ])
    def test_aliases_resolve_as_reference(self, alias):
        assert resolve_kind(alias) == ref_resolve_kind(alias)

    def test_every_kind_in_fakeserver_registry(self):
        for kind in _KINDS:
            g = gvr_for_kind(kind)
            assert (g.group, g.version, g.plural) in KNOWN_GVRS, kind
            assert KNOWN_GVRS[(g.group, g.version, g.plural)].namespaced \
                == g.namespaced, kind

    def test_registry_matches_reference_kinds(self):
        """The same kinds, one group renamed (resource.tpu.dev ->
        resource.gpu.dev)."""
        from tpu_dra.k8s.fakeserver import KNOWN_GVRS as REF_GVRS
        rename = {"resource.tpu.dev": "resource.gpu.dev"}
        assert {(rename.get(g, g), v, p) for g, v, p in REF_GVRS} \
            == set(KNOWN_GVRS)
        assert gvr_for_doc({"kind": "ComputeDomain"}).group \
            == "resource.gpu.dev"

    def test_http_crud_watch_and_selectors(self):
        """FakeApiServer over HTTP with the port's HttpApiClient: create
        (AlreadyExists surfaced), list with a label selector, merge
        patch, status update, a watch stream's ADDED/MODIFIED/DELETED,
        and a 404 for an unknown plural."""
        from tpu_dra_torch.k8s.client import AlreadyExistsError
        server = FakeApiServer()
        server.start()
        try:
            api = HttpApiClient(base_url=server.url)
            stop = threading.Event()
            events = []

            def watch():
                for ev, obj in api.watch(PODS, namespace="default",
                                         stop=stop):
                    events.append((ev, obj["metadata"]["name"]))
                    if ev == "DELETED":
                        return

            t = threading.Thread(target=watch, daemon=True)
            t.start()
            time.sleep(0.3)
            pod = {"apiVersion": "v1", "kind": "Pod",
                   "metadata": {"name": "p", "namespace": "default",
                                "labels": {"a": "b"}}, "spec": {}}
            api.create(PODS, pod, namespace="default")
            with pytest.raises(AlreadyExistsError):
                api.create(PODS, pod, namespace="default")
            assert [p["metadata"]["name"] for p in
                    api.list(PODS, namespace="default",
                             label_selector="a=b")] == ["p"]
            assert api.list(PODS, namespace="default",
                            label_selector="a=c") == []
            api.patch(PODS, "p", {"metadata": {"labels": {"x": "y"}}},
                      namespace="default")
            got = api.get(PODS, "p", "default")
            got["status"] = {"phase": "Running"}
            api.update_status(PODS, got, "default")
            assert api.get(PODS, "p", "default")["status"]["phase"] \
                == "Running"
            api.delete(PODS, "p", "default")
            t.join(10)
            stop.set()
            assert events[0] == ("ADDED", "p") and \
                events[-1] == ("DELETED", "p")
            assert ("MODIFIED", "p") in events
            with pytest.raises(urllib.request.HTTPError):
                urllib.request.urlopen(server.url + "/api/v1/nosuchplural",
                                       timeout=5)
        finally:
            server.stop()


    def test_reference_client_reads_the_port_server_as_its_own(self):
        """The reference's HttpApiClient against the port's server and
        against the reference's own FakeApiServer: the same requests
        give the same objects and the same errors (resourceVersion and
        uid, which each server mints, aside)."""
        from tpu_dra.k8s.client import HttpApiClient as RefHttp
        from tpu_dra.k8s.fakeserver import FakeApiServer as RefServer
        from tpu_dra.k8s.resources import PODS as REF_PODS

        def drive(server):
            server.start()
            try:
                api = RefHttp(base_url=server.url)
                out = []
                pod = {"apiVersion": "v1", "kind": "Pod",
                       "metadata": {"name": "p", "namespace": "ns",
                                    "labels": {"a": "b"}}, "spec": {}}
                out.append(api.create(REF_PODS, pod, namespace="ns"))
                for call in (lambda: api.create(REF_PODS, pod,
                                                namespace="ns"),
                             lambda: api.get(REF_PODS, "q", "ns")):
                    try:
                        call()
                    except Exception as e:  # noqa: BLE001 — compared
                        out.append(type(e).__name__)
                out.append(api.patch(REF_PODS, "p", {"spec": {"x": 1}},
                                     namespace="ns"))
                out.append(api.list(REF_PODS, namespace="ns",
                                    label_selector="a=b"))
                api.delete(REF_PODS, "p", "ns")
                out.append(api.list(REF_PODS, namespace="ns"))
                return json.loads(json.dumps(out).replace(
                    server.url, "URL"))
            finally:
                server.stop()

        def strip(x):
            if isinstance(x, dict):
                return {k: strip(v) for k, v in x.items()
                        if k not in ("resourceVersion", "uid",
                                     "creationTimestamp")}
            if isinstance(x, list):
                return [strip(v) for v in x]
            return x

        assert strip(drive(FakeApiServer())) == strip(drive(RefServer()))


# ---------------------------------------------------------------------------
# CEL
# ---------------------------------------------------------------------------

ATTRS = [
    {"type": {"string": "gpu"}, "productName": {"string": "NVIDIA H100"},
     "index": {"int": 0}, "healthy": {"bool": True},
     "cudaComputeCapability": {"version": "9.0.0"}},
    {"type": {"string": "mig"}, "productName": {"string": "NVIDIA H100"},
     "index": {"int": 3}, "profile": {"string": "3g.40gb"},
     "placementStart": {"int": 4}},
    {"type": {"string": "gpu"}, "index": {"int": 7}},
    {},
]
EXPRS = [
    'device.driver == "D" && device.attributes["D"].type == "gpu"',
    'device.driver == "other" && device.attributes["D"].nosuch == 1',
    "device.attributes['D'].index >= 3",
    "device.attributes['D'].index > 3 || device.attributes['D'].type == 'mig'",
    "device.attributes['D'].type == 'gpu' || device.attributes['D'].nosuch == 1",
    "device.attributes['D'].type == 'mig' && device.attributes['D'].profile == '3g.40gb'",
    "!(device.attributes['D'].index == 0)",
    "device.attributes['D'].productName.lowerAscii().matches('^nvidia h1.*$')",
    "device.attributes['D'].productName.matches('a100')",
    "device.attributes['D'].index == 'zero'",
    "device.attributes['other'].type == 'gpu'",
    "device.attributes['D'].healthy == true",
    "device.attributes['D'].healthy > false",
    "device.attributes['D'].cudaComputeCapability == '9.0.0'",
    "(device.attributes['D'].index <= 3) && !(device.attributes['D'].type != 'gpu')",
    "device.attributes['D'].index == ",
    "device.attributes['D'].type.matches('[')",
    "device.nosuch == 1",
    "true",
    "1",
]


def _outcome(mod, expr, driver, attrs):
    try:
        return mod.evaluate(expr, driver=driver, attributes=attrs)
    except mod.CelError:
        return "error"


class TestCelParity:
    @pytest.mark.parametrize("expr", EXPRS)
    @pytest.mark.parametrize("driver", ["D", "other"])
    def test_same_result_as_reference(self, expr, driver):
        for attrs in ATTRS:
            expr_d = expr.replace("'D'", "'gpu.dev'").replace(
                '"D"', '"gpu.dev"')
            drv = "gpu.dev" if driver == "D" else driver
            assert _outcome(cel, expr_d, drv, attrs) == \
                _outcome(ref_cel, expr_d, drv, attrs), (expr_d, attrs)

    def test_random_conjunctions_match_reference(self):
        """Random &&/||/! trees over atoms that select, reject or raise:
        the short-circuit order decides which raise surfaces."""
        rng = random.Random(0)
        atoms = ["device.attributes['gpu.dev'].index == 3",
                 "device.attributes['gpu.dev'].type == 'gpu'",
                 "device.attributes['gpu.dev'].nosuch == 1",
                 "device.driver == 'gpu.dev'",
                 "device.attributes['gpu.dev'].index == 'x'"]

        def tree(depth):
            if depth == 0 or rng.random() < 0.3:
                return rng.choice(atoms)
            op = rng.choice(["&&", "||", "!"])
            if op == "!":
                return f"!({tree(depth - 1)})"
            return f"({tree(depth - 1)}) {op} ({tree(depth - 1)})"

        for _ in range(200):
            expr = tree(3)
            for attrs in ATTRS:
                assert _outcome(cel, expr, "gpu.dev", attrs) == \
                    _outcome(ref_cel, expr, "gpu.dev", attrs), expr

    def test_device_class_selectors_put_driver_first(self):
        """The port's DeviceClass selectors never read another driver's
        attributes: a compute-domain device is no match, not an error."""
        from tpu_dra_torch.deploy.manifests import all_manifests
        cd_dev = {"attributes": {"type": {"string": "channel"}}}
        for dc in [d for d in all_manifests() if d["kind"] == "DeviceClass"]:
            expr = dc["spec"]["selectors"][0]["cel"]["expression"]
            assert expr.startswith("device.driver == ")
            prog = cel.compile_expr(expr)
            for driver in ("gpu.dev", "compute-domain.gpu.dev", "x"):
                prog.evaluate(driver=driver,
                              attributes=cd_dev["attributes"])


def _counts():
    return (CEL_COMPILES.value(), CEL_CACHE_HITS.value(),
            CEL_CACHE_MISSES.value())


def dev(arch="hopper", typ="gpu", index=0):
    return {"attributes": {"architecture": {"string": arch},
                           "type": {"string": typ},
                           "index": {"int": index}}}


class TestCelCache:
    """The reference's compile-cache cases (tests/test_cel_cache.py) on
    the port's cache, with GPU attributes."""

    EXPR = ('device.driver == "gpu.dev" && '
            'device.attributes["gpu.dev"].architecture == "hopper"')

    def test_one_compile_many_devices(self):
        c0, h0, m0 = _counts()
        results = [cel.device_matches(self.EXPR, d, "gpu.dev") for d in
                   (dev("hopper"), dev("ampere"), dev("hopper", index=3),
                    {"attributes": {}}, dev("hopper"))]
        assert results == [True, False, True, False, True]
        c1, h1, m1 = _counts()
        assert (c1 - c0, m1 - m0, h1 - h0) == (1, 1, 4)

    def test_cache_keyed_by_full_source(self):
        a = "device.attributes['gpu.dev'].architecture == 'hopper'"
        b = "device.attributes['gpu.dev'].architecture == 'ampere'"
        c0 = CEL_COMPILES.value()
        assert cel.evaluate(a, driver="gpu.dev",
                            attributes=dev("hopper")["attributes"])
        assert not cel.evaluate(b, driver="gpu.dev",
                                attributes=dev("hopper")["attributes"])
        assert CEL_COMPILES.value() - c0 == 2

    def test_program_reuse_across_drivers(self):
        prog = cel.compile_expr(self.EXPR)
        assert prog is cel.compile_expr(self.EXPR)
        assert prog.matches(dev(), "gpu.dev")
        assert not prog.matches(dev(), "compute-domain.gpu.dev")

    def test_syntax_errors_negatively_cached(self):
        bad = "device.attributes['gpu.dev'].architecture =="
        c0 = CEL_COMPILES.value()
        for _ in range(3):
            with pytest.raises(cel.CelError):
                cel.compile_expr(bad)
            assert not cel.device_matches(bad, dev(), "gpu.dev")
        assert CEL_COMPILES.value() - c0 == 1

    def test_compile_many_conjunction(self):
        progs = cel.compile_many(
            [self.EXPR, "device.attributes['gpu.dev'].index >= 1"])
        assert all(p.matches(dev(index=2), "gpu.dev") for p in progs)
        assert not all(p.matches(dev(index=0), "gpu.dev") for p in progs)
        assert cel.compile_many([self.EXPR, "not (valid"]) is None

    def test_concurrent_compiles_stay_bounded(self):
        exprs = [f"device.attributes['gpu.dev'].index == {i}"
                 for i in range(8)]
        c0 = CEL_COMPILES.value()
        errs = []

        def worker():
            try:
                for e in exprs * 5:
                    cel.device_matches(e, dev(index=3), "gpu.dev")
            except Exception as exc:  # noqa: BLE001
                errs.append(exc)

        threads = [threading.Thread(target=worker) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs
        assert CEL_COMPILES.value() - c0 <= len(exprs)

    def test_cache_overflow_clears_and_recovers(self, monkeypatch):
        monkeypatch.setattr(cel, "_CACHE_MAX", 8)
        for i in range(20):
            cel.evaluate(f"device.attributes['gpu.dev'].index == {i}",
                         driver="gpu.dev", attributes=dev()["attributes"])
        assert cel.cache_info()["entries"] <= 8


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

MESHES = [((8, 1, 1), (False, False, False)),
          ((4, 2, 1), (False, False, False)),
          ((4, 4, 1), (True, True, False)),
          ((2, 2, 2), (False, False, False)),
          ((4, 4, 4), (True, True, True))]


def _random_free(dims, rng, fill):
    coords = [(x, y, z) for x in range(dims[0]) for y in range(dims[1])
              for z in range(dims[2])]
    return {c for c in coords if rng.random() >= fill}


class TestPlacementParity:
    @pytest.mark.parametrize("dims,wrap", MESHES)
    def test_best_placement_and_max_free_cuboid(self, dims, wrap):
        mesh = ref_mesh.Mesh(dims=dims, wrap=wrap)
        rng = random.Random(hash(dims) & 0xffff)
        for trial in range(12):
            free = _random_free(dims, rng, fill=rng.choice([0, 0.2, 0.5]))
            for count in (1, 2, 3, 4, 8):
                assert placement.best_placement(mesh, free, count) == \
                    ref_placement.best_placement(mesh, free, count), \
                    (trial, count)
            assert placement.max_free_cuboid(mesh, free) == \
                ref_placement.max_free_cuboid(mesh, free)

    @pytest.mark.parametrize("dims,wrap", MESHES)
    def test_shapes_and_scores(self, dims, wrap):
        mesh = ref_mesh.Mesh(dims=dims, wrap=wrap)
        for count in (1, 2, 4, 6, 8):
            assert placement.enumerate_shapes(count, dims) == \
                ref_placement.enumerate_shapes(count, dims)
            assert list(placement.enumerate_placements(mesh, count)) == \
                list(ref_placement.enumerate_placements(mesh, count))
        free = set(mesh.all_coords())
        some = next(iter(ref_placement.enumerate_placements(mesh, 2)))[2]
        after = free.difference(some)
        assert placement.fragmentation_score(some, after, mesh) == \
            ref_placement.fragmentation_score(some, after, mesh)

    def test_rank_candidate_nodes(self):
        rng = random.Random(5)
        for _ in range(20):
            infos = [(f"n{i}", rng.choice(["", "a", "b", "c"]),
                      rng.randrange(4)) for i in range(rng.randrange(1, 9))]
            assert placement.rank_candidate_nodes(infos) == \
                ref_placement.rank_candidate_nodes(infos)

    def test_nvlink_fabric_pick_is_first_block_in_pci_order(self):
        """On the all-to-all switch every placement of a count scores
        alike: the pick is the first free run of consecutive GPUs."""
        fabric = NvlinkFabric((8, 1, 1))
        free = {(i, 0, 0) for i in (0, 2, 3, 4, 6, 7)}
        assert placement.best_placement(fabric, free, 2) == \
            ((2, 0, 0), (3, 0, 0))
        assert placement.best_placement(fabric, free, 3) == \
            ((2, 0, 0), (3, 0, 0), (4, 0, 0))
        assert placement.best_placement(fabric, free, 4) is None
        assert placement.max_free_cuboid(fabric, free) == 3

    def test_allocation_violations(self):
        slices = [_gpu_slice("n0", 4)]
        ok = _allocated("c1", "n0", ["gpu-1", "gpu-2"])
        scattered = _allocated("c2", "n0", ["gpu-0", "gpu-3"])
        assert placement.allocation_violations([ok], slices) == []
        out = placement.allocation_violations([ok, scattered], slices)
        assert len(out) == 1 and "c2" in out[0]


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------

GPU_CLASS = ('device.driver == "gpu.dev" && '
             'device.attributes["gpu.dev"].type == "gpu"')
MIG_CLASS = ('device.driver == "gpu.dev" && '
             'device.attributes["gpu.dev"].type == "mig"')


def _gpu_device(i, mig=()):
    out = [{"name": f"gpu-{i}", "attributes": {
        "type": {"string": "gpu"}, "index": {"int": i},
        "coordX": {"int": i}, "coordY": {"int": 0}, "coordZ": {"int": 0},
        "clique": {"string": ""}, "workerIndex": {"int": 0}}}]
    for start in mig:
        out.append({"name": f"gpu-{i}-mig-1g10gb-{start}", "attributes": {
            "type": {"string": "mig"}, "index": {"int": i}}})
    return out


def _gpu_slice(node, gpus, mig=()):
    return {"apiVersion": "resource.k8s.io/v1", "kind": "ResourceSlice",
            "metadata": {"name": f"{node}-gpu.dev"},
            "spec": {"driver": "gpu.dev", "nodeName": node,
                     "pool": {"name": node, "generation": 1},
                     "devices": [d for i in range(gpus)
                                 for d in _gpu_device(i, mig)]}}


def _allocated(name, node, devices):
    return {"metadata": {"name": name}, "status": {"allocation": {
        "devices": {"results": [{"driver": "gpu.dev", "pool": node,
                                 "device": d} for d in devices]}}}}


def make_cluster(gpus=2, mig=(), nodes=("n0",)):
    c = FakeCluster()
    for node in nodes:
        c.create(NODES, {"apiVersion": "v1", "kind": "Node",
                         "metadata": {"name": node}})
        c.create(RESOURCESLICES, _gpu_slice(node, gpus, mig))
    for name, expr in (("gpu.dev", GPU_CLASS), ("mig.gpu.dev", MIG_CLASS)):
        c.create(DEVICECLASSES, {
            "apiVersion": "resource.k8s.io/v1", "kind": "DeviceClass",
            "metadata": {"name": name},
            "spec": {"selectors": [{"cel": {"expression": expr}}]}})
    return c


def pod_with_claim(name, claim_entry, ns="default"):
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": ns},
            "spec": {"containers": [{"name": "c", "image": "x",
                                     "command": ["true"],
                                     "resources": {"claims": [{"name": "t"}]}}],
                     "resourceClaims": [dict(claim_entry, name="t")]}}


def claim_doc(name, cls, count=1, ns="default"):
    exactly = {"deviceClassName": cls, **({"count": count}
                                          if count != 1 else {})}
    return {"apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
            "metadata": {"name": name, "namespace": ns},
            "spec": {"devices": {"requests": [
                {"name": "r", "exactly": exactly}]}}}


def allocations(c, ns="default"):
    return {cl["metadata"]["name"]:
            [r["device"] for r in ((cl.get("status") or {}).get(
                "allocation") or {}).get("devices", {}).get("results", [])]
            for cl in c.list(RESOURCECLAIMS, namespace=ns)}


class TestScheduler:
    """The reference's TestScheduler cases, for GPUs and MIG devices."""

    def test_claim_from_template_and_allocation(self):
        c = make_cluster()
        c.create(RESOURCECLAIMTEMPLATES, {
            "apiVersion": "resource.k8s.io/v1",
            "kind": "ResourceClaimTemplate",
            "metadata": {"name": "tmpl", "namespace": "default"},
            "spec": {"spec": {"devices": {"requests": [
                {"name": "gpu", "exactly": {"deviceClassName": "gpu.dev"}}]}}},
        }, namespace="default")
        c.create(PODS, pod_with_claim(
            "p1", {"resourceClaimTemplateName": "tmpl"}), namespace="default")
        s = Scheduler(c)
        for _ in range(3):
            s.reconcile_once()
        pod = c.get(PODS, "p1", "default")
        assert pod["spec"].get("nodeName") == "n0"
        (claim,) = c.list(RESOURCECLAIMS, namespace="default")
        assert claim["metadata"]["annotations"]["sim/owner-pod"] == "p1"
        res = claim["status"]["allocation"]["devices"]["results"][0]
        assert (res["driver"], res["pool"], res["device"]) == \
            ("gpu.dev", "n0", "gpu-0")

    def test_exclusive_devices_not_double_allocated(self):
        c = make_cluster(gpus=1)
        for name in ("c1", "c2"):
            c.create(RESOURCECLAIMS, claim_doc(name, "gpu.dev"),
                     namespace="default")
            c.create(PODS, pod_with_claim(f"p-{name}",
                                          {"resourceClaimName": name}),
                     namespace="default")
        s = Scheduler(c)
        for _ in range(3):
            s.reconcile_once()
        assert sorted(len(v) for v in allocations(c).values()) == [0, 1]

    def test_shared_claim_pins_second_pod_to_same_node(self):
        c = make_cluster(nodes=("n0", "n1"))
        c.create(RESOURCECLAIMS, claim_doc("shared", "gpu.dev"),
                 namespace="default")
        for p in ("p1", "p2"):
            c.create(PODS, pod_with_claim(p, {"resourceClaimName": "shared"}),
                     namespace="default")
        s = Scheduler(c)
        for _ in range(3):
            s.reconcile_once()
        assert {c.get(PODS, p, "default")["spec"]["nodeName"]
                for p in ("p1", "p2")} == {"n0"}

    def test_gpu_and_mig_mutually_exclusive(self):
        """A whole-GPU allocation blocks its MIG devices and a MIG device
        blocks the whole GPU; two MIG devices of one GPU coexist."""
        c = make_cluster(gpus=1, mig=(0, 1))
        for name, cls in (("mig1", "mig.gpu.dev"), ("whole", "gpu.dev"),
                          ("mig2", "mig.gpu.dev")):
            c.create(RESOURCECLAIMS, claim_doc(name, cls),
                     namespace="default")
            c.create(PODS, pod_with_claim(f"p-{name}",
                                          {"resourceClaimName": name}),
                     namespace="default")
        s = Scheduler(c)
        for _ in range(4):
            s.reconcile_once()
        got = allocations(c)
        assert got["whole"] == []
        assert sorted(got["mig1"] + got["mig2"]) == \
            ["gpu-0-mig-1g10gb-0", "gpu-0-mig-1g10gb-1"]

    def test_whole_gpu_first_blocks_mig(self):
        c = make_cluster(gpus=1, mig=(0,))
        # Pods are scheduled in name order: the whole GPU's first.
        for k, (name, cls) in enumerate((("whole", "gpu.dev"),
                                         ("mig1", "mig.gpu.dev"))):
            c.create(RESOURCECLAIMS, claim_doc(name, cls),
                     namespace="default")
            c.create(PODS, pod_with_claim(f"p{k}-{name}",
                                          {"resourceClaimName": name}),
                     namespace="default")
        s = Scheduler(c)
        for _ in range(3):
            s.reconcile_once()
        assert allocations(c) == {"whole": ["gpu-0"], "mig1": []}

    def test_count_request(self):
        c = make_cluster(gpus=4)
        c.create(RESOURCECLAIMS, claim_doc("quad", "gpu.dev", count=4),
                 namespace="default")
        c.create(PODS, pod_with_claim("p1", {"resourceClaimName": "quad"}),
                 namespace="default")
        Scheduler(c).reconcile_once()
        assert sorted(allocations(c)["quad"]) == \
            [f"gpu-{i}" for i in range(4)]

    def test_broken_or_missing_class_allocates_nothing(self):
        c = make_cluster()
        c.create(DEVICECLASSES, {
            "apiVersion": "resource.k8s.io/v1", "kind": "DeviceClass",
            "metadata": {"name": "broken"},
            "spec": {"selectors": [{"cel": {"expression": "device.x =="}}]}})
        for name, cls in (("b", "broken"), ("m", "nosuch")):
            c.create(RESOURCECLAIMS, claim_doc(name, cls),
                     namespace="default")
            c.create(PODS, pod_with_claim(f"p-{name}",
                                          {"resourceClaimName": name}),
                     namespace="default")
        s = Scheduler(c)
        s.reconcile_once()
        assert allocations(c) == {"b": [], "m": []}

    def test_topology_pick_is_contiguous(self):
        """TopologyAwareScheduling: a 2-GPU claim on a node with GPU 1
        taken lands on a contiguous pair, never {0, 2}."""
        featuregates.Features.set_from_string("TopologyAwareScheduling=true")
        c = make_cluster(gpus=4)
        c.create(RESOURCECLAIMS, claim_doc("one", "gpu.dev"),
                 namespace="default")
        c.create(PODS, pod_with_claim("p0", {"resourceClaimName": "one"}),
                 namespace="default")
        s = Scheduler(c)
        s.reconcile_once()
        assert allocations(c)["one"] == ["gpu-0"]
        c.create(RESOURCECLAIMS, claim_doc("pair", "gpu.dev", count=2),
                 namespace="default")
        c.create(PODS, pod_with_claim("p1", {"resourceClaimName": "pair"}),
                 namespace="default")
        s.reconcile_once()
        assert allocations(c)["pair"] == ["gpu-1", "gpu-2"]
        assert s.verify_topology() == []


# Reference inventory under the name map: chip-N <-> gpu-N, subslice
# chip-N-ss-1c-K <-> MIG gpu-N-mig-1g10gb-K.
def _ref_cluster(gpus, mig):
    c = RefCluster()
    c.create(ref_res.NODES, {"apiVersion": "v1", "kind": "Node",
                             "metadata": {"name": "n0"}})
    devices = []
    for i in range(gpus):
        devices.append({"name": f"chip-{i}",
                        "attributes": {"type": {"string": "chip"}}})
        devices += [{"name": f"chip-{i}-ss-1c-{k}",
                     "attributes": {"type": {"string": "subslice"}}}
                    for k in mig]
    c.create(ref_res.RESOURCESLICES, {
        "apiVersion": "resource.k8s.io/v1", "kind": "ResourceSlice",
        "metadata": {"name": "n0-tpu.dev"},
        "spec": {"driver": "tpu.dev", "nodeName": "n0",
                 "pool": {"name": "n0", "generation": 1},
                 "devices": devices}})
    for name, typ in (("tpu.dev", "chip"), ("tpu-subslice.tpu.dev",
                                            "subslice")):
        c.create(ref_res.DEVICECLASSES, {
            "apiVersion": "resource.k8s.io/v1", "kind": "DeviceClass",
            "metadata": {"name": name},
            "spec": {"selectors": [{"cel": {"expression":
                f'device.driver == "tpu.dev" && '
                f'device.attributes["tpu.dev"].type == "{typ}"'}}]}})
    return c


def _to_port_name(ref_name):
    if "-ss-1c-" in ref_name:
        chip, k = ref_name.split("-ss-1c-")
        return f"gpu-{chip.split('-')[1]}-mig-1g10gb-{k}"
    return "gpu-" + ref_name.split("-")[1]


@pytest.mark.parametrize("seed", range(6))
def test_allocations_match_reference(seed):
    """A random sequence of whole and MIG claims (counts 1-2) through
    both schedulers' sync passes: the same claims allocate, to the same
    devices after the name map."""
    rng = random.Random(seed)
    gpus, mig = 3, (0, 1)
    port, ref = make_cluster(gpus=gpus, mig=mig), _ref_cluster(gpus, mig)
    ps, rs = Scheduler(port), RefScheduler(ref)
    for k in range(rng.randrange(3, 8)):
        whole = rng.random() < 0.5
        count = rng.choice([1, 1, 2])
        pname, rname = (("gpu.dev", "tpu.dev") if whole else
                        ("mig.gpu.dev", "tpu-subslice.tpu.dev"))
        port.create(RESOURCECLAIMS, claim_doc(f"c{k}", pname, count),
                    namespace="default")
        ref.create(ref_res.RESOURCECLAIMS, claim_doc(f"c{k}", rname, count),
                   namespace="default")
        for cl, res in ((port, PODS), (ref, ref_res.PODS)):
            cl.create(res, pod_with_claim(f"p{k}",
                                          {"resourceClaimName": f"c{k}"}),
                      namespace="default")
        ps.reconcile_once()
        rs.reconcile_once()
    want = {k: sorted(_to_port_name(d) for d in v)
            for k, v in allocations(ref).items()}
    assert {k: sorted(v) for k, v in allocations(port).items()} == want


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


class TestEventMode:
    def test_bind_gc_and_evict(self):
        """Event mode: a template pod binds; deleting the pod GCs its
        claim; a device that leaves the published slice evicts its claim
        and unbinds the pod, which re-binds on the surviving GPU."""
        c = make_cluster(gpus=2)
        c.create(RESOURCECLAIMTEMPLATES, {
            "apiVersion": "resource.k8s.io/v1",
            "kind": "ResourceClaimTemplate",
            "metadata": {"name": "t", "namespace": "default"},
            "spec": {"spec": {"devices": {"requests": [
                {"name": "gpu", "exactly": {"deviceClassName": "gpu.dev"}}]}}},
        }, namespace="default")
        s = Scheduler(c, resync_interval=0.2, gc_sweep_interval=0.5)
        s.start()
        try:
            c.create(PODS, pod_with_claim(
                "p1", {"resourceClaimTemplateName": "t"}),
                namespace="default")
            assert _wait(lambda: allocations(c).get("p1-t") == ["gpu-0"])
            assert _wait(lambda: c.get(PODS, "p1", "default")["spec"].get(
                "nodeName") == "n0")
            # gpu-0 leaves the slice: the claim is evicted and re-placed.
            sl = c.get(RESOURCESLICES, "n0-gpu.dev")
            sl["spec"]["devices"] = [d for d in sl["spec"]["devices"]
                                     if d["name"] != "gpu-0"]
            c.update(RESOURCESLICES, sl)
            assert _wait(lambda: allocations(c).get("p1-t") == ["gpu-1"])
            assert s.verify_index() == []
            c.delete(PODS, "p1", "default")
            assert _wait(lambda: allocations(c) == {})
        finally:
            s.stop()

    def test_dropped_event_resyncs(self):
        """A dropped watch event dirties the index; the guarded resync
        converges it and allocation carries on without double use."""
        from tpu_dra_torch.infra.faults import EveryNth
        c = make_cluster(gpus=2)
        s = Scheduler(c, resync_interval=0.2)
        s.start()
        try:
            FAULTS.arm("sched.watch_event", EveryNth(2))
            for k in range(2):
                c.create(RESOURCECLAIMS, claim_doc(f"c{k}", "gpu.dev"),
                         namespace="default")
                c.create(PODS, pod_with_claim(
                    f"p{k}", {"resourceClaimName": f"c{k}"}),
                    namespace="default")
            assert _wait(lambda: sorted(sum(allocations(c).values(), []))
                         == ["gpu-0", "gpu-1"])
            FAULTS.reset()
            assert _wait(lambda: s.verify_index() == [])
        finally:
            s.stop()

    def test_standby_writes_nothing_until_promoted(self):
        c = make_cluster(gpus=1)
        c.create(RESOURCECLAIMS, claim_doc("c", "gpu.dev"),
                 namespace="default")
        c.create(PODS, pod_with_claim("p", {"resourceClaimName": "c"}),
                 namespace="default")
        s = Scheduler(c, resync_interval=0.2)
        s.start(standby=True)
        try:
            assert s.is_standby
            time.sleep(0.5)
            assert allocations(c) == {"c": []}
            s.set_lease_generation(7)
            s.promote()
            assert _wait(lambda: allocations(c) == {"c": ["gpu-0"]})
            claim = c.get(RESOURCECLAIMS, "c", "default")
            assert claim["metadata"]["annotations"][FENCING_ANNOTATION] \
                == "7"
        finally:
            s.stop()


class TestAllocationIndex:
    def test_sharded_refcounts_and_stale_events(self):
        idx = AllocationIndex(n_shards=4)

        def claim(name, devs, rv, pool="n0"):
            return {"metadata": {"name": name, "namespace": "d",
                                 "resourceVersion": str(rv)},
                    "status": {"allocation": {"devices": {"results": [
                        {"driver": "gpu.dev", "pool": pool, "device": d}
                        for d in devs]}}}}

        idx.apply(claim("a", ["gpu-0-mig-1g10gb-0"], 5))
        idx.apply(claim("b", ["gpu-0-mig-1g10gb-1"], 6))
        assert idx.is_taken("gpu.dev", "n0", "gpu-0")  # parent blocked
        idx.remove(claim("a", [], 7))
        assert idx.is_taken("gpu.dev", "n0", "gpu-0")  # b still holds it
        idx.apply(claim("b", ["gpu-0-mig-1g10gb-1"], 3))  # stale: ignored
        idx.remove(claim("b", [], 8))
        assert not idx.is_taken("gpu.dev", "n0", "gpu-0")
        assert idx.try_commit("n0", [("d/c", (("gpu.dev", "n0",
                                                "gpu-1"),))])
        assert not idx.try_commit("n0", [("d/e", (("gpu.dev", "n0",
                                                   "gpu-1-mig-1g10gb-0"),))])


# ---------------------------------------------------------------------------
# WorkloadController
# ---------------------------------------------------------------------------

class TestWorkloadController:
    def _ds(self, selector):
        return {"apiVersion": "apps/v1", "kind": "DaemonSet",
                "metadata": {"name": "d", "namespace": "default"},
                "spec": {"selector": {"matchLabels": {"a": "b"}},
                         "template": {
                             "metadata": {"labels": {"a": "b"}},
                             "spec": {"nodeSelector": selector,
                                      "containers": [{"name": "c",
                                                      "image": "x",
                                                      "command": ["true"]}]}}}}

    def test_daemonset_follows_node_labels(self):
        c = FakeCluster()
        c.create(NODES, {"apiVersion": "v1", "kind": "Node",
                         "metadata": {"name": "n0", "labels": {}}})
        c.create(DAEMONSETS, self._ds({"want": "yes"}), namespace="default")
        wc = WorkloadController(c)
        wc.reconcile_once()
        assert not c.list(PODS, namespace="default")
        node = c.get(NODES, "n0")
        node["metadata"]["labels"] = {"want": "yes"}
        c.update(NODES, node)
        wc.reconcile_once()
        pods = c.list(PODS, namespace="default")
        assert [p["metadata"]["name"] for p in pods] == ["d-n0"]
        assert pods[0]["spec"]["nodeName"] == "n0"
        node = c.get(NODES, "n0")
        node["metadata"]["labels"] = {}
        c.update(NODES, node)
        wc.reconcile_once()
        assert not c.list(PODS, namespace="default")

    def test_number_ready_and_template_roll(self):
        c = FakeCluster()
        c.create(NODES, {"apiVersion": "v1", "kind": "Node",
                         "metadata": {"name": "n0",
                                      "labels": {"want": "yes"}}})
        c.create(DAEMONSETS, self._ds({"want": "yes"}), namespace="default")
        wc = WorkloadController(c)
        wc.reconcile_once()
        assert c.get(DAEMONSETS, "d", "default")["status"]["numberReady"] \
            == 0
        pod = c.get(PODS, "d-n0", "default")
        pod.setdefault("status", {})["conditions"] = [
            {"type": "Ready", "status": "True"}]
        c.update_status(PODS, pod, "default")
        wc.reconcile_once()
        assert c.get(DAEMONSETS, "d", "default")["status"]["numberReady"] \
            == 1
        uid = c.get(PODS, "d-n0", "default")["metadata"]["uid"]
        ds = c.get(DAEMONSETS, "d", "default")
        ds["spec"]["template"]["spec"]["containers"][0]["command"] = ["x"]
        c.update(DAEMONSETS, ds)
        wc.reconcile_once()   # rolls: deletes the old-template pod
        wc.reconcile_once()   # and stamps the new one
        assert c.get(PODS, "d-n0", "default")["metadata"]["uid"] != uid

    def test_deployment_replicas_and_orphan_gc(self):
        c = FakeCluster()
        from tpu_dra_torch.k8s import DEPLOYMENTS
        dep = {"apiVersion": "apps/v1", "kind": "Deployment",
               "metadata": {"name": "w", "namespace": "default"},
               "spec": {"replicas": 2, "template": {
                   "metadata": {"labels": {"a": "b"}},
                   "spec": {"containers": [{"name": "c",
                                            "command": ["true"]}]}}}}
        c.create(DEPLOYMENTS, dep, namespace="default")
        wc = WorkloadController(c)
        wc.reconcile_once()
        assert sorted(p["metadata"]["name"] for p in
                      c.list(PODS, namespace="default")) == ["w-0", "w-1"]
        c.delete(DEPLOYMENTS, "w", "default")
        wc.reconcile_once()
        assert c.list(PODS, namespace="default") == []


# ---------------------------------------------------------------------------
# per-node fake inventory (the sim's counterpart of the reference's fake
# sysfs tree per node)
# ---------------------------------------------------------------------------

class TestFakeInventory:
    def test_each_node_reads_its_own_gpus(self, tmp_path, monkeypatch):
        from tpu_dra_torch.native import gpuinfo
        paths = []
        for node, (clique, worker) in enumerate((("a", 0), ("a", 1),
                                                 ("b", 0))):
            path = str(tmp_path / f"n{node}.json")
            gpuinfo.write_fake_inventory(path, 3, clique_id=clique,
                                         worker_index=worker,
                                         node_index=node, mig_mode=[2])
            paths.append(path)
        monkeypatch.setenv(gpuinfo.BACKEND_ENV, "fake")
        uuids = set()
        for node, path in enumerate(paths):
            monkeypatch.setenv(gpuinfo.INVENTORY_ENV, path)
            gpus = gpuinfo.get_backend().gpus()
            assert [g.index for g in gpus] == [0, 1, 2]
            assert [g.mig_mode for g in gpus] == [False, False, True]
            assert {g.clique_id for g in gpus} == {"ab"[node // 2]}
            assert [g.coords for g in gpus] == [(i, 0, 0) for i in range(3)]
            uuids |= {g.uuid for g in gpus}
        assert len(uuids) == 9

    def test_inventory_is_read_only_under_the_fake_backend(
            self, tmp_path, monkeypatch):
        from tpu_dra_torch.native import gpuinfo
        monkeypatch.setenv(gpuinfo.INVENTORY_ENV, str(tmp_path / "none"))
        monkeypatch.setenv(gpuinfo.BACKEND_ENV, "fake")
        with pytest.raises(FileNotFoundError):
            gpuinfo.get_backend()
        monkeypatch.delenv(gpuinfo.INVENTORY_ENV)
        assert len(gpuinfo.get_backend().gpus()) == 8

    def test_short_workdir_fits_the_socket_paths(self):
        import shutil
        from tpu_dra_torch.simcluster.cluster import short_workdir
        work = short_workdir()
        try:
            sock = os.path.join(work, "n0", "fs", "var", "lib", "kubelet",
                                "plugins_registry",
                                "compute-domain.gpu.dev-reg.sock")
            assert len(sock) <= 107
        finally:
            shutil.rmtree(work)


class TestWorkQueueDedupe:
    """The scheduler's queue (infra/workqueue.py ``dedupe=True``), the
    semantics of the reference's test_infra.py dedupe case on the port's
    one-worker queue: a waiting same-key item absorbs an enqueue, one in
    flight does not, and a failure's retry is never counted."""

    def test_absorbs_only_into_a_waiting_item(self):
        from tpu_dra_torch.infra.workqueue import (
            ExponentialFailureRateLimiter, WorkQueue,
        )
        q = WorkQueue(ExponentialFailureRateLimiter(0.001, 0.01))
        release = threading.Event()
        runs = []

        def slow(_obj):
            runs.append("slow")
            assert release.wait(3)

        t = q.run_in_thread()
        try:
            q.enqueue(None, slow, key="k", dedupe=True)
            assert _wait(lambda: runs == ["slow"], 3)
            # In flight: this one must not be absorbed.
            q.enqueue(None, lambda _o: runs.append("fast"), key="k",
                      dedupe=True)
            for _ in range(5):   # waiting: absorbed
                q.enqueue(None, lambda _o: runs.append("x"), key="k",
                          dedupe=True)
            release.set()
            assert _wait(lambda: len(runs) >= 2, 3)
            time.sleep(0.1)
            assert runs == ["slow", "fast"]
            fails = []

            def flaky(_obj):
                fails.append(1)
                if len(fails) == 1:
                    raise RuntimeError("retry me")

            q.enqueue(None, flaky, key="j", dedupe=True)
            assert _wait(lambda: len(fails) == 2, 3)
            assert q._queued_keys == {}
        finally:
            q.shutdown()
            t.join(5)
        assert not t.is_alive()


# ---------------------------------------------------------------------------
# NodeSim's containerd half, against the reference's
# ---------------------------------------------------------------------------

class TestNodeSimParity:
    """CDI resolution and path rewriting of the port's NodeSim against
    the reference's, on the same spec files and mounts."""

    def _sims(self, tmp_path):
        from tpu_dra.simcluster.nodesim import NodeSim as RefNodeSim
        from tpu_dra_torch.simcluster.nodesim import NodeSim
        port = NodeSim(FakeCluster(), "n0", str(tmp_path / "port"),
                       api_url="http://x")
        ref = RefNodeSim(RefCluster(), "n0", str(tmp_path / "ref"),
                         api_url="http://x")
        return port, ref

    def test_cdi_edits(self, tmp_path):
        port, ref = self._sims(tmp_path)
        specs = [
            {"cdiVersion": "0.6.0", "kind": "k8s.gpu.dev/gpu",
             "containerEdits": {"env": ["COMMON=1"]},
             "devices": [{"name": "GPU-a", "containerEdits": {
                 "env": ["CUDA_VISIBLE_DEVICES=GPU-a", "X=a=b"],
                 "mounts": [{"containerPath": "/mps",
                             "hostPath": "/h/mps"}]}},
                 {"name": "GPU-b", "containerEdits": {
                     "env": ["CUDA_VISIBLE_DEVICES=GPU-b"]}}]},
            {"cdiVersion": "0.6.0", "kind": "k8s.gpu.dev/claim",
             "devices": [{"name": "u1", "containerEdits": {
                 "env": ["CLAIM=u1"],
                 "mounts": [{"containerPath": "/c",
                             "hostPath": "/h/c"}]}}]},
        ]
        for sim in (port, ref):
            root = os.path.join(sim.hostfs, "var", "run", "cdi")
            os.makedirs(root)
            for i, spec in enumerate(specs):
                with open(os.path.join(root, f"s{i}.json"), "w") as f:
                    json.dump(spec, f)
            with open(os.path.join(root, "ignored.yaml"), "w") as f:
                f.write("kind: x\n")
        for ids in (["k8s.gpu.dev/gpu=GPU-a", "k8s.gpu.dev/claim=u1"],
                    ["k8s.gpu.dev/gpu=GPU-b"], ["k8s.gpu.dev/gpu=none"],
                    []):
            assert port._cdi_edits(ids) == ref._cdi_edits(ids), ids

    def test_host_paths_stay_in_sim_tree(self, tmp_path):
        """A manifest hostPath that exists on the host (a stand-in for a
        real /var/run/cdi, outside the sim's tree) maps under the node's
        fs and is left untouched; a hostPath under the node's dir, made
        by a component inside the sim, is used as it is."""
        from tpu_dra_torch.simcluster.nodesim import NodeSim, _RunningPod
        workdir = tmp_path / "sim"
        sim = NodeSim(FakeCluster(), "n0", str(workdir / "n0"),
                      api_url="http://x")
        real_cdi = tmp_path / "host" / "var" / "run" / "cdi"
        real_cdi.mkdir(parents=True)
        inside = workdir / "n0" / "fs" / "mps" / "claim"
        pod = {"metadata": {"name": "p", "uid": "u"}, "spec": {"volumes": [
            {"name": "cdi", "hostPath": {"path": str(real_cdi)}},
            {"name": "reg", "hostPath": {
                "path": "/var/lib/kubelet/plugins_registry"}},
            {"name": "mps", "hostPath": {"path": str(inside)}}]}}
        ctr = {"volumeMounts": [
            {"name": "cdi", "mountPath": "/var/run/cdi"},
            {"name": "reg", "mountPath": "/registry"},
            {"name": "mps", "mountPath": "/mps"}]}
        mounts = dict(sim._mount_map(pod, ctr, _RunningPod("u")))
        assert mounts["/var/run/cdi"] == os.path.join(
            sim.hostfs, str(real_cdi).lstrip("/"))
        assert mounts["/registry"] == os.path.join(
            sim.hostfs, "var/lib/kubelet/plugins_registry")
        assert mounts["/mps"] == str(inside)
        for host in mounts.values():
            assert host.startswith(str(workdir) + os.sep), host
        assert list(real_cdi.iterdir()) == []

    @pytest.mark.parametrize("value", ["/mps", "/mps/pipe", "/mpsx",
                                       "/c/d/e", "rel", "/", ""])
    def test_rewrite_path(self, value):
        from tpu_dra.simcluster.nodesim import NodeSim as RefNodeSim
        from tpu_dra_torch.simcluster.nodesim import NodeSim
        mounts = [("/c/d", "/h/cd"), ("/mps", "/h/mps"), ("/c", "/h/c")]
        assert NodeSim._rewrite_path(value, mounts) == \
            RefNodeSim._rewrite_path(value, mounts)
