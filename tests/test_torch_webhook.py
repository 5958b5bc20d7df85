"""Port parity: tpu_dra_torch.webhook (AdmissionHandler, the v1
conversion, WebhookServer) and simcluster.admission's WebhookCaller
against tpu_dra's, on the CPU.

The same AdmissionReviews go to both handlers, each in its own dialect
(TpuConfig <-> GpuConfig, SubsliceConfig <-> MigDeviceConfig, the
reference's Multiprocess sharing <-> MPS, tpu.dev <-> gpu.dev, the
compute-domain kinds as they are): every case must be allowed by both or
denied by both. The device-spec conversion to v1 is driver-agnostic and
held equal on the same inputs.
"""

import json
import urllib.request

import pytest

from tpu_dra.api import types as ref_types
from tpu_dra.infra import featuregates as ref_gates
from tpu_dra.webhook import AdmissionHandler as RefHandler
from tpu_dra.webhook.server import (
    convert_device_spec_to_v1 as ref_convert,
)
from tpu_dra_torch.api import types as port_types
from tpu_dra_torch.deploy import demos, manifests
from tpu_dra_torch.infra import featuregates
from tpu_dra_torch.k8s import RESOURCECLAIMS, HttpApiClient
from tpu_dra_torch.k8s.client import ApiError
from tpu_dra_torch.k8s.fakeserver import FakeApiServer
from tpu_dra_torch.k8s.resources import VALIDATINGWEBHOOKCONFIGURATIONS
from tpu_dra_torch.simcluster.admission import WebhookCaller
from tpu_dra_torch.webhook import AdmissionHandler, WebhookServer
from tpu_dra_torch.webhook.server import (
    ConversionError, convert_device_spec_to_v1,
)

GATES = "TimeSlicingSettings=true,MultiprocessSupport=true"


@pytest.fixture(autouse=True)
def _gates():
    featuregates.Features.reset()
    featuregates.Features.set_from_string(GATES)
    ref_gates.Features.set_from_string(GATES)
    yield
    featuregates.Features.reset()


def review(obj, kind="ResourceClaim", group="resource.k8s.io",
           version="v1", uid="req-1"):
    return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "request": {"uid": uid,
                        "resource": {"group": group, "version": version,
                                     "resource": kind.lower() + "s"},
                        "kind": {"kind": kind}, "object": obj}}


def claim(params, driver, request="r", targets=("r",), kind="ResourceClaim",
          flat=False):
    req = ({"name": request, "deviceClassName": "c"} if flat
           else {"name": request, "exactly": {"deviceClassName": "c"}})
    devices = {"requests": [req],
               "config": [{"requests": list(targets),
                           "opaque": {"driver": driver,
                                      **({"parameters": params}
                                         if params is not None else {})}}]}
    if kind == "ResourceClaimTemplate":
        return {"kind": kind, "metadata": {"name": "t"},
                "spec": {"spec": {"devices": devices}}}
    return {"kind": kind, "metadata": {"name": "c"},
            "spec": {"devices": devices}}


REF = (ref_types.API_VERSION, ref_types.TPU_DRIVER_NAME,
       ref_types.COMPUTE_DOMAIN_DRIVER_NAME)
PORT = (port_types.API_VERSION, port_types.GPU_DRIVER_NAME,
        port_types.COMPUTE_DOMAIN_DRIVER_NAME)

# (name, ref params, port params, to the CD driver?)
CASES = [
    ("plain", {"kind": "TpuConfig"}, {"kind": "GpuConfig"}, False),
    ("unknown-field", {"kind": "TpuConfig", "junk": 1},
     {"kind": "GpuConfig", "junk": 1}, False),
    ("unknown-kind", {"kind": "Nope"}, {"kind": "Nope"}, False),
    ("time-slicing", {"kind": "TpuConfig", "sharing": {
        "strategy": "TimeSlicing", "timeSlicingConfig": {"interval": "Long"}}},
     {"kind": "GpuConfig", "sharing": {
         "strategy": "TimeSlicing",
         "timeSlicingConfig": {"interval": "Long"}}}, False),
    ("bad-interval", {"kind": "TpuConfig", "sharing": {
        "strategy": "TimeSlicing",
        "timeSlicingConfig": {"interval": "Forever"}}},
     {"kind": "GpuConfig", "sharing": {
         "strategy": "TimeSlicing",
         "timeSlicingConfig": {"interval": "Forever"}}}, False),
    ("bad-strategy", {"kind": "TpuConfig", "sharing": {"strategy": "X"}},
     {"kind": "GpuConfig", "sharing": {"strategy": "X"}}, False),
    ("partition", {"kind": "SubsliceConfig"}, {"kind": "MigDeviceConfig"},
     False),
    ("passthrough-junk", {"kind": "PassthroughConfig", "x": 1},
     {"kind": "PassthroughConfig", "x": 1}, False),
    ("channel", {"kind": "ComputeDomainChannelConfig", "domainID": "u"},
     {"kind": "ComputeDomainChannelConfig", "domainID": "u"}, True),
    ("channel-no-domain", {"kind": "ComputeDomainChannelConfig"},
     {"kind": "ComputeDomainChannelConfig"}, True),
    ("channel-bad-mode", {"kind": "ComputeDomainChannelConfig",
                          "domainID": "u", "allocationMode": "Bogus"},
     {"kind": "ComputeDomainChannelConfig", "domainID": "u",
      "allocationMode": "Bogus"}, True),
    ("daemon", {"kind": "ComputeDomainDaemonConfig", "domainID": "u"},
     {"kind": "ComputeDomainDaemonConfig", "domainID": "u"}, True),
    ("missing-parameters", None, None, False),
]


def _both(case, version="v1", **kw):
    """(reference allowed, port allowed) for one case, each in its own
    dialect."""
    _name, ref_p, port_p, to_cd = case
    out = []
    for (api, drv, cd_drv), params, handler in (
            (REF, ref_p, RefHandler()), (PORT, port_p, AdmissionHandler())):
        if params is not None:
            params = {"apiVersion": api, **params}
        obj = claim(params, cd_drv if to_cd else drv, **kw)
        resp = handler.review(review(obj, kind=obj["kind"],
                                     version=version))["response"]
        out.append(resp["allowed"])
    return out


class TestAdmissionParity:
    @pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
    @pytest.mark.parametrize("kind", ["ResourceClaim",
                                      "ResourceClaimTemplate"])
    def test_same_verdict(self, case, kind):
        ref_ok, port_ok = _both(case, kind=kind)
        assert ref_ok == port_ok

    @pytest.mark.parametrize("version", ["v1", "v1beta1", "v1beta2"])
    def test_versions(self, version):
        for case in CASES:
            ref_ok, port_ok = _both(case, version=version,
                                    flat=version == "v1beta1")
            assert ref_ok == port_ok, (case[0], version)

    def test_unknown_request_target(self):
        ref_ok, port_ok = _both(CASES[0], targets=("nosuch",))
        assert (ref_ok, port_ok) == (False, False)

    def test_foreign_driver_other_group_future_version_missing_object(self):
        h = AdmissionHandler()
        foreign = claim({"anything": 1}, "other.example.com")
        assert h.review(review(foreign))["response"]["allowed"]
        assert h.review(review(foreign, group="apps"))["response"]["allowed"]
        bad = claim({"apiVersion": port_types.API_VERSION,
                     "kind": "GpuConfig", "junk": 1}, "gpu.dev")
        assert h.review(review(bad, version="v2"))["response"]["allowed"]
        assert not h.review({"request": {"uid": "x"}})["response"]["allowed"]

    def test_denial_names_the_config(self):
        bad = claim({"apiVersion": port_types.API_VERSION,
                     "kind": "GpuConfig", "junk": 1}, "gpu.dev")
        out = AdmissionHandler().review(review(bad))["response"]
        assert out["status"]["code"] == 422
        assert "config[0]" in out["status"]["message"]
        assert "junk" in out["status"]["message"]


CONVERSIONS = [
    {"requests": [{"name": "r1", "deviceClassName": "x",
                   "selectors": [{"cel": {"expression": "true"}}],
                   "allocationMode": "ExactCount", "count": 2,
                   "adminAccess": True}],
     "constraints": [{"requests": ["r1"], "matchAttribute": "x/y"}],
     "config": [{"requests": ["r1"], "opaque": {"driver": "x",
                                                "parameters": {}}}]},
    {"requests": [{"name": "r", "firstAvailable": [
        {"name": "a", "deviceClassName": "x"}]}]},
    {"requests": [{"name": "r", "exactly": {"deviceClassName": "x"}}]},
    {"requests": ["notadict"]},
    {},
]


class TestConversionParity:
    @pytest.mark.parametrize("devices", CONVERSIONS)
    @pytest.mark.parametrize("version", ["v1", "v1beta1", "v1beta2",
                                         "v1alpha3"])
    def test_same_as_reference(self, devices, version):
        def run(fn):
            try:
                return fn(devices, version)
            except ValueError as e:
                return type(e).__name__
        assert run(convert_device_spec_to_v1) == run(ref_convert)

    def test_input_untouched_and_error_type(self):
        devices = json.loads(json.dumps(CONVERSIONS[0]))
        convert_device_spec_to_v1(devices, "v1beta1")
        assert devices == CONVERSIONS[0]
        with pytest.raises(ConversionError):
            convert_device_spec_to_v1({}, "v1alpha3")


def _bad_gpu_claim(name="bad"):
    obj = claim({"apiVersion": port_types.API_VERSION, "kind": "GpuConfig",
                 "junk": 1}, "gpu.dev")
    obj.update(apiVersion="resource.k8s.io/v1")
    obj["metadata"] = {"name": name, "namespace": "default"}
    return obj


class TestServerAndCaller:
    def test_http_roundtrip_and_readyz(self):
        server = WebhookServer(port=0, addr="127.0.0.1")
        server.start()
        try:
            base = f"http://127.0.0.1:{server.port}"
            assert urllib.request.urlopen(f"{base}/readyz",
                                          timeout=5).read() == b"ok"
            req = urllib.request.Request(
                f"{base}/validate-resource-claim-parameters",
                data=json.dumps(review(_bad_gpu_claim())).encode(),
                headers={"Content-Type": "application/json"})
            out = json.loads(urllib.request.urlopen(req, timeout=5).read())
            assert out["response"]["allowed"] is False
        finally:
            server.stop()

    def test_tls_with_the_manifests_cert(self, tmp_path):
        """The serving cert of manifests.all_manifests() (the chart's
        selfsigned mode: the Secret and the webhook configuration's
        caBundle): the TLS server serves it and a client pinned to that
        CA bundle (as the API server's admission chain pins caBundle)
        verifies it."""
        import base64
        import ssl
        docs = manifests.all_manifests()
        (secret,) = [d for d in docs if d["kind"] == "Secret"]
        (vwc,) = [d for d in docs
                  if d["kind"] == "ValidatingWebhookConfiguration"]
        ca_bundle = vwc["webhooks"][0]["clientConfig"]["caBundle"]
        cert, key = tmp_path / "tls.crt", tmp_path / "tls.key"
        cert.write_bytes(base64.b64decode(secret["data"]["tls.crt"]))
        key.write_bytes(base64.b64decode(secret["data"]["tls.key"]))
        server = WebhookServer(port=0, addr="127.0.0.1",
                               cert_file=str(cert), key_file=str(key))
        server.start()
        try:
            ctx = WebhookCaller._tls_context({"caBundle": ca_bundle})
            assert isinstance(ctx, ssl.SSLContext)
            out = urllib.request.urlopen(
                f"https://127.0.0.1:{server.port}/readyz", context=ctx,
                timeout=5).read()
            assert out == b"ok"
        finally:
            server.stop()

    def test_caller_denies_through_the_api_server(self):
        """A ValidatingWebhookConfiguration with a URL clientConfig: the
        fake API server's admission chain calls the port's webhook and
        refuses the bad claim with the apiserver's message; a good claim
        is created; an unreachable Fail-policy webhook fails the call."""
        hook = WebhookServer(port=0, addr="127.0.0.1")
        hook.start()
        api_server = FakeApiServer()
        api_server.admission_hook = WebhookCaller(api_server.cluster)
        api_server.start()
        try:
            api = HttpApiClient(base_url=api_server.url)
            (vwc,) = [d for d in manifests.all_manifests()
                      if d["kind"] == "ValidatingWebhookConfiguration"]
            vwc["webhooks"][0]["clientConfig"] = {
                "url": f"http://127.0.0.1:{hook.port}"
                       "/validate-resource-claim-parameters"}
            api.create(VALIDATINGWEBHOOKCONFIGURATIONS, vwc)
            with pytest.raises(ApiError) as e:
                api.create(RESOURCECLAIMS, _bad_gpu_claim(),
                           namespace="default")
            assert "resource-claim-parameters.gpu.dev" in str(e.value)
            assert "denied the request" in str(e.value)
            good = _bad_gpu_claim("good")
            del good["spec"]["devices"]["config"][0]["opaque"][
                "parameters"]["junk"]
            api.create(RESOURCECLAIMS, good, namespace="default")
            vwc = api.get(VALIDATINGWEBHOOKCONFIGURATIONS, vwc["metadata"][
                "name"])
            vwc["webhooks"][0]["failurePolicy"] = "Fail"
            vwc["webhooks"][0]["clientConfig"] = {
                "url": "http://127.0.0.1:1/nowhere"}
            api.update(VALIDATINGWEBHOOKCONFIGURATIONS, vwc)
            with pytest.raises(ApiError) as e:
                api.create(RESOURCECLAIMS, _bad_gpu_claim("x"),
                           namespace="default")
            assert "failed calling webhook" in str(e.value)
        finally:
            api_server.stop()
            hook.stop()


class TestManifests:
    def test_all_manifests(self):
        docs = manifests.all_manifests()
        kinds = [d["kind"] for d in docs]
        for want in ("Namespace", "CustomResourceDefinition", "DeviceClass",
                     "ClusterRole", "Deployment", "DaemonSet", "Service",
                     "ValidatingWebhookConfiguration",
                     "ValidatingAdmissionPolicy"):
            assert want in kinds, f"missing {want}"
        assert [d["metadata"]["name"] for d in docs
                if d["kind"] == "DeviceClass"] == [
            "gpu.dev", "mig.gpu.dev", port_types.DEVICE_CLASS_DAEMON,
            port_types.DEVICE_CLASS_CHANNEL]

    def test_every_command_is_a_port_module(self):
        import importlib.util
        for doc in manifests.all_manifests():
            spec = (doc.get("spec") or {}).get("template", {}).get("spec")
            if not spec:
                continue
            for ctr in spec["containers"]:
                cmd = ctr["command"]
                assert cmd[:2] == ["python", "-m"], cmd
                assert cmd[2].startswith("tpu_dra_torch."), cmd
                assert importlib.util.find_spec(cmd[2]) is not None, cmd

    def test_demo_specs_are_valid_configs(self):
        """Every demo's configs are admitted under the chart's default
        gates; gpu-test-passthrough's only with the PassthroughSupport
        gate its docstring names, and refused without it."""
        handler = AdmissionHandler()
        for name, docs in demos.all_demos().items():
            for doc in docs:
                if doc["kind"] not in ("ResourceClaim",
                                       "ResourceClaimTemplate"):
                    continue
                if name == "gpu-test-passthrough":
                    out = handler.review(review(doc, kind=doc["kind"]))
                    assert not out["response"]["allowed"]
                    assert "PassthroughSupport" in \
                        out["response"]["status"]["message"]
                    featuregates.Features.set_from_string(
                        GATES + ",PassthroughSupport=true")
                out = handler.review(review(doc, kind=doc["kind"]))
                featuregates.Features.reset()
                featuregates.Features.set_from_string(GATES)
                assert out["response"]["allowed"], (
                    f"{name}: {out['response'].get('status')}")

    def test_yaml_render(self, tmp_path, capsys):
        import yaml

        from tpu_dra_torch.deploy.render import main
        assert main(["-o", str(tmp_path / "m"), "--demo-dir",
                     str(tmp_path / "demo"), "--set", "image.repository=img",
                     "--set", "image.tag=test", "--set",
                     "webhook.tls.mode=secret", "--set",
                     "webhook.tls.secret.name=gpu-dra-driver-webhook-tls",
                     "--set", "webhook.tls.secret.caBundle=QUJD"]) == 0
        written = capsys.readouterr().out.split()
        assert len(written) == 1 + len(demos.all_demos())
        docs = list(yaml.safe_load_all(open(written[0])))
        assert docs == manifests.all_manifests("gpu-dra-driver", "img:test",
                                               "QUJD")
