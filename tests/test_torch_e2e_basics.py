"""The port's e2e tier on the CPU (tpu_dra_torch.e2e): the basics,
admission and debug suites (tests/e2e/test_basics.sh, test_admission.sh,
test_debug.sh) on one two-node SimCluster with the chart's default
render installed; then the two demos the port added (gpu-test6,
gpu-test-passthrough) through deploy/render.py, and the fake backend's
cross-process health-event file.

Each suite is the runner's own (run_suite: cleanup, then the suite), so
a suite that fails here fails as `python -m tpu_dra_torch.e2e` does.
The reference's e2e tier gives no run to compare against (its multi-node
SimCluster cannot start), so the suites hold the assertions of
tests/e2e/test_*.sh.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch
import yaml

from tpu_dra_torch.api import types as port_types
from tpu_dra_torch.api.scheme import StrictDecoder
from tpu_dra_torch.e2e.__main__ import run_suite
from tpu_dra_torch.e2e.cluster import MIG_GPU, E2ECluster
from tpu_dra_torch.e2e.helpers import E2E
from tpu_dra_torch.infra import featuregates as port_gates
from tpu_dra_torch.native import gpuinfo

torch.set_num_threads(2)   # the suite runs 6 workers beside timing tests

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def e2e():
    up = E2ECluster().start()
    try:
        yield E2E(up)
    finally:
        up.stop()


@pytest.mark.parametrize("suite", ["basics", "admission", "debug"])
def test_suite(e2e, suite):
    rec = run_suite(e2e, suite)
    assert rec["ok"], rec.get("traceback") or rec


class TestDemos:
    """gpu-test6 and gpu-test-passthrough: rendered by deploy/render.py,
    their opaque configs decoded by the port's strict decoder, and the
    passthrough claim prepared under its gate."""

    @pytest.fixture(scope="class")
    def rendered(self, tmp_path_factory):
        out = tmp_path_factory.mktemp("demos")
        proc = subprocess.run(
            [sys.executable, "-m", "tpu_dra_torch.deploy.render", "-o",
             str(out / "chart"), "--demo-dir", str(out / "demo")],
            capture_output=True, text=True, timeout=120, cwd=ROOT)
        assert proc.returncode == 0, proc.stderr
        docs = {}
        for name in ("gpu-test6", "gpu-test-passthrough"):
            with open(out / "demo" / f"{name}.yaml") as f:
                docs[name] = [d for d in yaml.safe_load_all(f) if d]
        return docs

    def test_test6_selectors(self, rendered):
        claims = {d["metadata"]["name"]: d for d in rendered["gpu-test6"]
                  if d["kind"] == "ResourceClaim"}
        assert sorted(claims) == ["mig0", "mig1", "no-such-architecture"]
        for name, c in claims.items():
            (req,) = c["spec"]["devices"]["requests"]
            assert req["exactly"]["deviceClassName"] == "mig.gpu.dev"
            expr = req["exactly"]["selectors"][0]["cel"]["expression"]
            assert expr.startswith('device.driver == "gpu.dev" && ')
        assert "placementStart == 0" in claims["mig0"]["spec"]["devices"][
            "requests"][0]["exactly"]["selectors"][0]["cel"]["expression"]
        (pod,) = [d for d in rendered["gpu-test6"]
                  if d["kind"] == "Pod" and d["metadata"]["name"] == "pod0"]
        assert [c["resources"]["claims"] for c in pod["spec"][
            "containers"]] == [[{"name": "mig0"}], [{"name": "mig1"}]]

    def test_test6_selectors_pick_one_gpu(self, rendered):
        """Over the devices the mig.gpu.dev class admits, the CEL of
        mig0/mig1 picks exactly the two placements of the MIG GPU of a
        fake H100 node, and the negative control none; no selector
        errs on any of them (nothing rests on error absorption)."""
        import dataclasses

        from tpu_dra_torch.gpuplugin.deviceinfo import enumerate_allocatable
        from tpu_dra_torch.simcluster import cel
        gpus = [dataclasses.replace(g, mig_mode=g.index == MIG_GPU)
                for g in gpuinfo.default_fake_gpus(4)]
        backend = gpuinfo.FakeBackend(gpus)
        devices = enumerate_allocatable(gpus,
                                        mig_profiles=backend.mig_profiles)
        picked = {}
        for c in rendered["gpu-test6"]:
            if c["kind"] != "ResourceClaim":
                continue
            expr = c["spec"]["devices"]["requests"][0]["exactly"][
                "selectors"][0]["cel"]["expression"]
            prog = cel.compile_expr(expr)
            picked[c["metadata"]["name"]] = sorted(
                name for name, d in devices.items() if d.type == "mig"
                and prog.evaluate(driver=port_types.GPU_DRIVER_NAME,
                                 attributes=d.to_resource_api()[
                                     "attributes"]))
        assert picked == {"mig0": [f"gpu-{MIG_GPU}-mig-3g40gb-0"],
                          "mig1": [f"gpu-{MIG_GPU}-mig-3g40gb-4"],
                          "no-such-architecture": []}

    def test_passthrough_config_decodes(self, rendered):
        (claim,) = [d for d in rendered["gpu-test-passthrough"]
                    if d["kind"] == "ResourceClaim"]
        (cfg,) = claim["spec"]["devices"]["config"]
        obj = StrictDecoder.decode(cfg["opaque"]["parameters"])
        assert type(obj).KIND == port_types.PASSTHROUGH_CONFIG_KIND

    def test_passthrough_claim_prepared_under_gate(self, rendered,
                                                   tmp_path):
        from test_torch_mig import claim
        from test_torch_passthrough import Node
        from tpu_dra_torch.gpuplugin.passthrough import VFIO_DRIVER
        (doc,) = [d for d in rendered["gpu-test-passthrough"]
                  if d["kind"] == "ResourceClaim"]
        params = doc["spec"]["devices"]["config"][0]["opaque"]["parameters"]
        node = Node(tmp_path)   # sets PassthroughSupport=true
        try:
            res = node.state.prepare(claim("pt", ["gpu-0"], [params]))
            assert res.error == ""
            assert node.driver(0) == VFIO_DRIVER
            assert node.state.unprepare("pt") is None
        finally:
            node.state.close()
            port_gates.Features.reset()


def test_events_file_across_processes(tmp_path):
    """Events appended to the file by one process reach another
    process's FakeBackend.wait_health_event in the order written; the
    backend starts at the file's size then (an older line is not
    replayed), a half-written line waits for its newline, and injected
    events still work beside the file."""
    path = tmp_path / "health_events"
    gpuinfo.append_health_event(str(path), gpuinfo.HealthEvent(
        1, "xid", 48, "before the backend"))
    reader = textwrap.dedent(f"""
        import json, sys
        from tpu_dra_torch.native import gpuinfo
        b = gpuinfo.get_backend("fake")
        print("ready", flush=True)
        got = []
        while len(got) < 4:
            e = b.wait_health_event(30.0)
            if e is None:
                break
            got.append([e.gpu_index, e.kind, e.code, e.description])
        print(json.dumps({{"got": got, "healthy": [
            g.healthy for g in b.gpus()]}}), flush=True)
    """)
    env = {**os.environ, "PYTHONPATH": ROOT,
           gpuinfo.EVENTS_ENV: str(path),
           gpuinfo.INVENTORY_ENV: "", "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen([sys.executable, "-c", reader], env=env,
                            stdout=subprocess.PIPE, text=True, cwd=ROOT)
    try:
        assert proc.stdout.readline().strip() == "ready"
        events = [gpuinfo.HealthEvent(0, "xid", 79, "fallen off the bus"),
                  gpuinfo.HealthEvent(2, "ecc_dbe", 48, ""),
                  gpuinfo.HealthEvent(0, "recovered", 0, "serviced")]
        for e in events:
            gpuinfo.append_health_event(str(path), e)
        with open(path, "a") as f:
            f.write("3 79 xid half")
            f.flush()
            f.write(" a line\n")
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["got"] == [[0, "xid", 79, "fallen off the bus"],
                          [2, "ecc_dbe", 48, ""],
                          [0, "recovered", 0, "serviced"],
                          [3, "xid", 79, "half a line"]]
    assert rec["healthy"][:4] == [True, True, False, False]

    backend = gpuinfo.FakeBackend(gpuinfo.default_fake_gpus(2),
                                  events_file=str(path))
    assert backend.wait_health_event(0.1) is None
    backend.inject_health_event(gpuinfo.HealthEvent(1, "xid", 79))
    assert backend.wait_health_event(0.1).gpu_index == 1
    gpuinfo.append_health_event(str(path), gpuinfo.HealthEvent(0, "xid", 79))
    assert backend.wait_health_event(5.0).gpu_index == 0
