"""Process-level drive of the port's kubelet plugin, on the CPU.

- ``python -m tpu_dra_torch.gpuplugin.main`` as a subprocess with
  ``TPU_DRA_TORCH_GPUINFO_BACKEND=fake``, against the reference's
  FakeApiServer over HTTP (the port's HttpApiClient on the wire): it
  publishes the fake node's ResourceSlice, registers with the plugin
  watcher afterwards, and serves NodePrepareResources /
  NodeUnprepareResources on dra.sock (gRPC, the test acting as kubelet,
  as tests/test_process_e2e.py does) and dra-fast.sock (framed); SIGTERM
  drains it and it exits 0.
- A framed prepare in a subprocess whose ``grpc`` and
  ``google.protobuf`` imports fail: the card's transport needs neither.
- main's flags, its refusal without a GPU, and the metrics/health HTTP
  server with the self-probe.

Every socket client and subprocess has its own timeout.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import textwrap
import time
import urllib.request

import pytest
import torch

from tpu_dra.k8s.fakeserver import FakeApiServer
from tpu_dra_torch.api.types import GPU_DRIVER_NAME
from tpu_dra_torch.k8s import NODES, RESOURCECLAIMS, RESOURCESLICES
from tpu_dra_torch.k8s.client import HttpApiClient, NotFoundError
from tpu_dra_torch.kubeletplugin import wire
from tpu_dra_torch.kubeletplugin.server import (
    framed_stubs, kubelet_stubs, registration_stubs,
)

torch.set_num_threads(2)   # the suite runs 6 workers beside timing tests

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 30.0


def wait_for(predicate, timeout=30.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return predicate()


@pytest.fixture
def plugin(tmp_path):
    server = FakeApiServer()
    server.start()
    api = HttpApiClient(base_url=server.url, timeout=TIMEOUT_S)
    api.create(NODES, {"apiVersion": "v1", "kind": "Node",
                       "metadata": {"name": "node-a"}})
    dirs = {k: str(tmp_path / k) for k in ("plugin", "registry", "cdi",
                                            "drv", "tmp")}
    os.makedirs(dirs["tmp"])
    env = dict(os.environ, PYTHONPATH=REPO, KUBE_API_URL=server.url,
               TPU_DRA_TORCH_GPUINFO_BACKEND="fake", NODE_NAME="node-a",
               PLUGIN_DIR=dirs["plugin"], REGISTRY_DIR=dirs["registry"],
               CDI_ROOT=dirs["cdi"], NVIDIA_DRIVER_ROOT=dirs["drv"],
               TMPDIR=dirs["tmp"], ADDITIONAL_XIDS_TO_IGNORE="94,95")
    # stderr to a file, not a pipe: an undrained pipe blocks a chatty
    # child once the pipe buffer fills.
    errfile = open(tmp_path / "plugin.stderr", "w+b")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_dra_torch.gpuplugin.main"], env=env,
        stderr=errfile, cwd=str(tmp_path))
    yield {"api": api, "proc": proc, "dirs": dirs,
           "stderr": tmp_path / "plugin.stderr"}
    if proc.poll() is None:
        proc.kill()
        proc.wait(timeout=TIMEOUT_S)
    errfile.close()
    server.stop()


def _diag(p):
    return p["stderr"].read_text(errors="replace")[-4000:]


def _claim(api, name, device):
    return api.create(RESOURCECLAIMS, {
        "apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
        "metadata": {"name": name, "namespace": "default"},
        "spec": {"devices": {"requests": [{"name": "gpu"}]}},
        "status": {"allocation": {"devices": {"results": [
            {"request": "gpu", "driver": GPU_DRIVER_NAME, "pool": "node-a",
             "device": device}], "config": []}}}})


def _drive(p, prepare, unprepare, name, device, index):
    """Prepare and unprepare one claim as kubelet; returns its env."""
    claim = _claim(p["api"], name, device)
    req = [wire.Claim(namespace="default", uid=claim["metadata"]["uid"],
                      name=name)]
    resp = prepare(wire.NodePrepareResourcesRequest(claims=req))
    entry = resp.claims[claim["metadata"]["uid"]]
    assert entry.error == "", entry.error
    assert [d.device_name for d in entry.devices] == [device]
    spec_path = os.path.join(
        p["dirs"]["cdi"], f"k8s.gpu.dev-claim_{claim['metadata']['uid']}.json")
    with open(spec_path) as f:
        env = dict(e.split("=", 1) for e in
                   json.load(f)["devices"][0]["containerEdits"]["env"])
    assert env["GPU_VISIBLE_INDICES"] == str(index)
    out = unprepare(wire.NodeUnprepareResourcesRequest(claims=req))
    assert out.claims[claim["metadata"]["uid"]].error == ""
    assert not os.path.exists(spec_path)
    return env


def test_plugin_process_publishes_registers_prepares_and_drains(plugin):
    p = plugin
    api = p["api"]
    assert wait_for(lambda: api.list(RESOURCESLICES)), _diag(p)
    devices = api.list(RESOURCESLICES)[0]["spec"]["devices"]
    assert [d["name"] for d in devices] == [f"gpu-{i}" for i in range(8)]
    reg_sock = os.path.join(p["dirs"]["registry"], "gpu.dev-reg.sock")
    assert wait_for(lambda: os.path.exists(reg_sock)), _diag(p)
    channel, get_info, notify = registration_stubs(reg_sock)
    try:
        info = get_info(wire.InfoRequest(), timeout=TIMEOUT_S)
        notify(wire.RegistrationStatus(plugin_registered=True),
               timeout=TIMEOUT_S)
    finally:
        channel.close()
    assert info.name == GPU_DRIVER_NAME
    assert info.endpoint == os.path.join(p["dirs"]["plugin"], "dra.sock")

    channel, prepare, unprepare = kubelet_stubs(info.endpoint)
    try:
        _drive(p, lambda r: prepare(r, timeout=TIMEOUT_S),
               lambda r: unprepare(r, timeout=TIMEOUT_S), "c-grpc",
               "gpu-2", 2)
    finally:
        channel.close()
    client, prepare, unprepare = framed_stubs(
        os.path.join(p["dirs"]["plugin"], "dra-fast.sock"),
        timeout_s=TIMEOUT_S)
    try:
        _drive(p, prepare, unprepare, "c-framed", "gpu-5", 5)
    finally:
        client.close()

    p["proc"].send_signal(signal.SIGTERM)
    assert p["proc"].wait(timeout=TIMEOUT_S) == 0, _diag(p)
    err = _diag(p)
    assert "Traceback" not in err, err
    assert '"additional-xids-to-ignore": "94,95"' in err
    # The SIGTERM flight-recorder dump lands in the process's TMPDIR.
    assert any(n.startswith("tpu-dra-flightrec-")
               for n in os.listdir(p["dirs"]["tmp"]))


def test_plugin_without_a_gpu_refuses(tmp_path):
    """The default backend is NVML: on a host without its library the
    plugin exits non-zero naming it, and serves nothing."""
    env = {k: v for k, v in os.environ.items()
           if k != "TPU_DRA_TORCH_GPUINFO_BACKEND"}
    env.update(PYTHONPATH=REPO, KUBE_API_URL="http://127.0.0.1:9",
               PLUGIN_DIR=str(tmp_path / "plugin"),
               LD_LIBRARY_PATH=str(tmp_path))
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_dra_torch.gpuplugin.main",
         "--node-name", "n"], env=env, capture_output=True, text=True,
        timeout=120, cwd=str(tmp_path))
    if proc.returncode == 0:
        pytest.fail("the plugin served without a GPU")
    assert "libnvidia-ml.so.1" in proc.stderr or "NVML" in proc.stderr, \
        proc.stderr[-2000:]
    assert not os.path.exists(tmp_path / "plugin" / "dra.sock")


NO_GRPC = textwrap.dedent("""
    import sys
    sys.modules["grpc"] = None
    sys.modules["google.protobuf"] = None
    import os, tempfile
    sys.path.insert(0, {repo!r})
    from tpu_dra_torch.api.types import GPU_DRIVER_NAME
    from tpu_dra_torch.bench import bench_claim_to_ready
    from tpu_dra_torch.cdi.handler import CDIHandler
    from tpu_dra_torch.gpuplugin.checkpoint import CheckpointManager
    from tpu_dra_torch.gpuplugin.device_state import DeviceState
    from tpu_dra_torch.gpuplugin.driver import GpuDriver
    from tpu_dra_torch.k8s import FakeCluster, RESOURCECLAIMS
    from tpu_dra_torch.kubeletplugin import wire
    from tpu_dra_torch.kubeletplugin.server import (
        DRAPluginServer, DriverCallbacks, framed_stubs, self_probe)
    from tpu_dra_torch.native.gpuinfo import FakeBackend

    tmp = {tmp!r}
    try:
        DRAPluginServer("gpu.dev", "n", DriverCallbacks(),
                        os.path.join(tmp, "refused")).start()
        raise SystemExit("a gRPC server started without grpc")
    except RuntimeError as e:
        assert "import grpc" in str(e) and "kubelet_grpc=False" in str(e), e
    cluster, backend = FakeCluster(), FakeBackend()
    state = DeviceState(backend=backend,
                        cdi=CDIHandler(os.path.join(tmp, "cdi")),
                        checkpoints=CheckpointManager(os.path.join(tmp, "p")),
                        driver_name=GPU_DRIVER_NAME, node_name="n")
    driver = GpuDriver(state=state, client=cluster,
                       driver_name=GPU_DRIVER_NAME, node_name="n",
                       plugin_dir=os.path.join(tmp, "p"),
                       registry_dir=os.path.join(tmp, "r"),
                       kubelet_grpc=False)
    driver.start()
    assert driver.first_published.is_set()
    assert driver.server.registration_socket is None
    assert not os.path.exists(driver.server.dra_socket)
    claim = cluster.create(RESOURCECLAIMS, {{
        "metadata": {{"name": "c", "namespace": "default"}},
        "status": {{"allocation": {{"devices": {{"results": [{{
            "request": "gpu", "driver": GPU_DRIVER_NAME, "pool": "n",
            "device": "gpu-1"}}], "config": []}}}}}}}})
    uid = claim["metadata"]["uid"]
    client, prepare, unprepare = framed_stubs(driver.server.fast_socket,
                                              timeout_s=30)
    req = [wire.Claim(namespace="default", uid=uid, name="c")]
    res = prepare(wire.NodePrepareResourcesRequest(claims=req)).claims[uid]
    assert res.error == "" and res.devices[0].device_name == "gpu-1", res
    assert unprepare(wire.NodeUnprepareResourcesRequest(
        claims=req)).claims[uid].error == ""
    assert self_probe(driver.server, timeout=30)
    client.close()
    driver.shutdown()
    out = bench_claim_to_ready(FakeBackend(), n_cycles=4, warmup=1,
                               scratch=tmp)
    assert out["claim_to_ready_p50_1chip_grpc_ms"] is None
    assert "import grpc" in out["claim_to_ready_grpc_unavailable"] or \\
        "grpc" in out["claim_to_ready_grpc_unavailable"]
    assert out["claim_to_ready_p50_ms"] > 0
    loaded = sorted(m for m in sys.modules
                    if (m == "grpc" or m.startswith(("grpc.",
                                                     "google.protobuf")))
                    and sys.modules[m] is not None)
    print("OK", loaded)
""")


def test_framed_transport_needs_neither_grpc_nor_protobuf(tmp_path):
    # A short directory: unix socket paths are limited to 107 bytes.
    short = tempfile.mkdtemp(prefix="ng")
    try:
        proc = subprocess.run(
            [sys.executable, "-c", NO_GRPC.format(repo=REPO, tmp=short)],
            capture_output=True, text=True, timeout=180, cwd=str(tmp_path),
            env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    finally:
        shutil.rmtree(short, ignore_errors=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-4000:]
    assert proc.stdout.strip().splitlines()[-1] == "OK []"


class TestFlagsAndHealthServer:
    def test_flags_mirror_the_nvidia_env_names(self, monkeypatch):
        from tpu_dra_torch.gpuplugin.main import flags
        monkeypatch.setenv("NODE_NAME", "node-z")
        monkeypatch.setenv("NVIDIA_DRIVER_ROOT", "/run/nvidia/driver")
        monkeypatch.setenv("ADDITIONAL_XIDS_TO_IGNORE", "94")
        monkeypatch.setenv("FEATURE_GATES", "NVMLDeviceHealthCheck=false")
        ns = flags().parse([])
        assert (ns.node_name, ns.driver_root, ns.additional_xids_to_ignore,
                ns.feature_gates) == ("node-z", "/run/nvidia/driver", "94",
                                      "NVMLDeviceHealthCheck=false")
        assert ns.plugin_dir == "/var/lib/kubelet/plugins/gpu.dev"
        assert ns.registry_dir == "/var/lib/kubelet/plugins_registry"
        ns = flags().parse(["--driver-root", "/", "--healthcheck-port", "9"])
        assert (ns.driver_root, ns.healthcheck_port) == ("/", 9)

    def test_healthz_runs_the_self_probe(self, tmp_path, monkeypatch):
        import tempfile

        from tpu_dra_torch.cdi.handler import CDIHandler
        from tpu_dra_torch.gpuplugin.checkpoint import CheckpointManager
        from tpu_dra_torch.gpuplugin.device_state import DeviceState
        from tpu_dra_torch.gpuplugin.driver import GpuDriver
        from tpu_dra_torch.infra import debug
        from tpu_dra_torch.infra.metrics import MetricsServer
        from tpu_dra_torch.k8s import FakeCluster
        from tpu_dra_torch.kubeletplugin.server import self_probe
        from tpu_dra_torch.native.gpuinfo import FakeBackend

        monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
        state = DeviceState(
            backend=FakeBackend(), cdi=CDIHandler(str(tmp_path / "cdi")),
            checkpoints=CheckpointManager(str(tmp_path / "p")),
            driver_name=GPU_DRIVER_NAME, node_name="n")
        driver = GpuDriver(state=state, client=FakeCluster(),
                           driver_name=GPU_DRIVER_NAME, node_name="n",
                           plugin_dir=str(tmp_path / "p"),
                           registry_dir=str(tmp_path / "r"))
        driver.start()
        srv = MetricsServer(port=0, health_probe=lambda: self_probe(
            driver.server, timeout=TIMEOUT_S))
        srv.start()
        base = f"http://127.0.0.1:{srv.port}"
        try:
            def get(path):
                with urllib.request.urlopen(base + path,
                                            timeout=TIMEOUT_S) as r:
                    return r.status, r.read().decode()
            assert get("/healthz") == (200, "ok")
            status, text = get("/metrics")
            assert status == 200
            assert "# TYPE tpu_dra_claim_prepare_seconds histogram" in text
            assert "tpu_dra_rpc_loop_lag_seconds_count" in text
            status, stacks = get("/debug/stacks")
            assert status == 200 and "--- thread" in stacks
            assert debug.stack_dump_path() == str(
                tmp_path / "thread-stacks.dump")
            assert os.path.exists(tmp_path / "thread-stacks.dump")
            driver.shutdown()
            with pytest.raises(urllib.error.HTTPError) as err:
                get("/healthz")
            assert err.value.code == 503
        finally:
            srv.stop()


def test_http_client_against_the_reference_apiserver():
    """The port's HttpApiClient (and its retrying wrapper) on the
    reference's FakeApiServer: create, get, list with selectors, update
    with the resourceVersion conflict, delete and 404."""
    from tpu_dra_torch.k8s.client import ConflictError, RetryingApiClient

    server = FakeApiServer()
    server.start()
    try:
        api = RetryingApiClient(HttpApiClient(base_url=server.url,
                                              timeout=TIMEOUT_S))
        obj = api.create(NODES, {"apiVersion": "v1", "kind": "Node",
                                 "metadata": {"name": "n1",
                                              "labels": {"x": "y"}}})
        assert obj["metadata"]["uid"]
        assert api.get(NODES, "n1")["metadata"]["labels"] == {"x": "y"}
        assert len(api.list(NODES, label_selector="x=y")) == 1
        assert not api.list(NODES, label_selector="x=z")
        claim = _claim(api, "c1", "gpu-0")
        stale = dict(claim, metadata=dict(claim["metadata"]))
        claim["spec"]["devices"]["requests"][0]["name"] = "gpu2"
        api.update(RESOURCECLAIMS, claim)
        with pytest.raises(ConflictError):
            api.update(RESOURCECLAIMS, stale)
        got = api.get(RESOURCECLAIMS, "c1", "default")
        assert got["spec"]["devices"]["requests"][0]["name"] == "gpu2"
        api.delete(NODES, "n1")
        with pytest.raises(NotFoundError):
            api.get(NODES, "n1")
    finally:
        server.stop()


def test_fake_cluster_matches_the_reference_fake():
    """The port's cut FakeCluster against the reference's on the verbs
    the plugin uses: the same objects back, the same errors."""
    from tpu_dra.k8s import FakeCluster as RefCluster
    from tpu_dra.k8s import RESOURCESLICES as REF_SLICES
    from tpu_dra.k8s.client import ConflictError as RefConflict
    from tpu_dra.k8s.client import NotFoundError as RefNotFound
    from tpu_dra_torch.k8s import FakeCluster
    from tpu_dra_torch.k8s.client import AlreadyExistsError, ConflictError

    def drive(cluster, slices, not_found, conflict):
        out = []
        obj = cluster.create(slices, {"metadata": {"name": "s", "labels": {
            "a": "b"}}, "spec": {"devices": [1]}})
        out.append(sorted(obj["metadata"]))
        stale = cluster.get(slices, "s")
        stale["spec"]["devices"] = [2]
        out.append(cluster.update(slices, stale)["spec"])
        with pytest.raises(conflict):
            cluster.update(slices, stale)
        out.append([o["metadata"]["name"]
                    for o in cluster.list(slices, label_selector="a=b")])
        out.append(cluster.list(slices, label_selector="a!=b"))
        cluster.delete(slices, "s")
        cluster.delete(slices, "s")
        with pytest.raises(not_found):
            cluster.get(slices, "s")
        return out

    port = FakeCluster()
    assert drive(port, RESOURCESLICES, NotFoundError, ConflictError) == \
        drive(RefCluster(), REF_SLICES, RefNotFound, RefConflict)
    port.create(RESOURCESLICES, {"metadata": {"name": "x"}})
    with pytest.raises(AlreadyExistsError):
        port.create(RESOURCESLICES, {"metadata": {"name": "x"}})
