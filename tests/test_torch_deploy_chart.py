"""Port parity: tpu_dra_torch.deploy.helmlite against tpu_dra's, and the
port's chart against its manifests, on the CPU.

- helmlite renders the REFERENCE's chart (deployments/helm/
  tpu-dra-driver) into the same documents as the reference's
  render_chart, over the default values and the reference tests' value
  overrides, and raises the same TemplateError where the reference does
  (generated cert material is masked: it is random per render); the
  template-language cases of tests/test_helmlite.py give the same text
  through both engines.
- The port's chart (tpu_dra_torch/deploy/chart/gpu-dra-driver) is
  manifests.all_manifests(): its default render, with the overrides the
  arguments imply. The reference tests' cases of its chart
  (tests/test_deploy_chart.py: TestDefaultRender, TestWebhookTLS in all
  three modes, TestGating, TestRenderCli) hold the port's chart after
  the GPU/TPU renames, and every value the reference's chart refuses is
  refused by the port's with the same message, each rendered through its
  own package's helmlite.
"""

import base64
import json
import os
import subprocess
import sys

import pytest
import yaml

from tpu_dra.deploy import helmlite as ref_helmlite
from tpu_dra_torch.api import types as apitypes
from tpu_dra_torch.api.crd import compute_domain_crd
from tpu_dra_torch.deploy import helmlite, manifests
from tpu_dra_torch.deploy.helmlite import TemplateError, render_chart

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_CHART = os.path.join(ROOT, "deployments", "helm", "tpu-dra-driver")
CHART = os.path.join(ROOT, "tpu_dra_torch", "deploy", "chart",
                     "gpu-dra-driver")


def _mask(docs):
    """Cert material is random per render: mask Secret data and every
    caBundle."""
    out = json.loads(json.dumps(docs))
    for d in out:
        if d.get("kind") == "Secret":
            d["data"] = {k: "MASKED" for k in d.get("data") or {}}
        for wh in d.get("webhooks") or []:
            if "caBundle" in wh.get("clientConfig", {}):
                wh["clientConfig"]["caBundle"] = "MASKED"
    return out


def _key(d):
    return json.dumps(d, sort_keys=True)


REF_OVERRIDES = [
    None,
    {"webhook": {"enabled": False}},
    {"resources": {"computeDomains": {"enabled": False}}},
    {"resources": {"tpus": {"enabled": False}}},
    {"webhook": {"tls": {"mode": "cert-manager"}}},
    {"webhook": {"tls": {"mode": "cert-manager", "certManager": {
        "issuerType": "issuer", "issuerName": "mine"}}}},
    {"webhook": {"tls": {"mode": "secret", "secret": {"name": "s",
                                                      "caBundle": "QQ=="}}}},
    {"image": {"repository": "example.com/x", "tag": "v9"}},
    {"allowDefaultNamespace": True},
    # failures
    {"webhook": {"tls": {"mode": "bogus"}}},
    {"webhook": {"tls": {"mode": "secret"}}},
    {"resources": {"tpus": {"enabled": False},
                   "computeDomains": {"enabled": False}}},
    {"resourceApiVersion": ""},
    {"resourceApiVersion": "apps/v1"},
]


class TestReferenceChart:
    @pytest.mark.parametrize("override", REF_OVERRIDES)
    @pytest.mark.parametrize("namespace", ["tpu-dra-driver", "default"])
    def test_same_documents_as_reference(self, override, namespace):
        def run(fn):
            try:
                return sorted(map(_key, _mask(
                    fn(REF_CHART, override, release_name="tpu-dra-driver",
                       namespace=namespace))))
            except Exception as e:  # noqa: BLE001 — compared below
                return (type(e).__name__, str(e))
        port, ref = run(render_chart), run(ref_helmlite.render_chart)
        assert port == ref

    def test_gke_overlay(self):
        import yaml
        path = os.path.join(ROOT, "demo", "clusters", "gke",
                            "values-gke.yaml")
        if not os.path.exists(path):
            pytest.fail(f"the reference's overlay moved: {path}")
        with open(path) as f:
            overlay = yaml.safe_load(f)
        kw = {"release_name": "r", "namespace": "tpu-dra-driver"}
        assert sorted(map(_key, _mask(render_chart(REF_CHART, overlay,
                                                   **kw)))) \
            == sorted(map(_key, _mask(ref_helmlite.render_chart(
                REF_CHART, overlay, **kw))))


def _render_src(mod, src, data):
    tree, defines = mod._parse(mod._lex(src))
    ctx = mod._Ctx(data, data, {}, defines, mod._make_functions())
    return mod._render_nodes(tree, ctx)


TEMPLATES = [
    ('{{- $x := "hi" }}{{ $x }}', {}),
    ('{{- $all := list }}{{- range $k, $v := .m }}'
     '{{- $all = append $all (printf "%s=%t" $k $v) }}{{- end }}'
     '{{ join "," $all }}', {"m": {"b": False, "a": True}}),
    ('{{- range .xs }}{{- $y := . }}{{- end }}{{ $y }}', {"xs": [1]}),
    ('{{ $z = 1 }}', {}),
    ('{{ printf "%s-%d-%v-%t-%q-%5s|" "a" 3 4.5 true "q" "w" }}', {}),
    ('{{ printf "%s %s" "a" }}', {}),
    ('{{ fail "nope" }}', {}),
    ('{{ add 1 2 3 }} {{ sub 5 2 }} {{ mul 2 3 }} {{ trunc 3 "abcdef" }} '
     '{{ trimSuffix "-x" "a-x" }} {{ upper "a" }} {{ replace "a" "b" "aa" }}',
     {}),
    ('{{ keys .m | join "," }}', {"m": {"b": 1, "a": 2}}),
    ('{{- define "t" }}[{{ .v }}]{{ end }}{{ include "t" . }}', {"v": 3}),
    ('{{- define "t" }}{{ $q }}{{ end }}{{ $q := 1 }}{{ include "t" . }}',
     {}),
    ('{{ if and .a (not .b) }}y{{ else if .b }}b{{ else }}n{{ end }}',
     {"a": True, "b": False}),
    ('{{ with .m }}{{ .k | default "d" | quote }}{{ end }}', {"m": {}}),
    ('x:{{ toYaml .m | nindent 2 }}', {"m": {"a": [1, 2], "b": {"c": "d"}}}),
    ('{{ ternary "y" "n" (eq .a 1) }} {{ hasKey .m "k" }} {{ len .l }} '
     '{{ contains "b" "abc" }} {{ hasPrefix "a" "ab" }} {{ empty "" }}',
     {"a": 1, "m": {"k": 0}, "l": [1, 2]}),
    ('{{ .a.b.c }}', {"a": {"b": {"c": "deep"}}}),
    ('{{ nosuchfn 1 }}', {}),
    ('{{ required "need x" .x }}', {}),
    ('{{ b64enc "hi" }} {{ toString 3 }} {{ int "4" }} {{ squote "s" }}', {}),
]


class TestEngineParity:
    @pytest.mark.parametrize("src,data", TEMPLATES)
    def test_same_text(self, src, data):
        def run(mod):
            try:
                return _render_src(mod, src, json.loads(json.dumps(data)))
            except Exception as e:  # noqa: BLE001 — compared below
                return (type(e).__name__, str(e))
        assert run(helmlite) == run(ref_helmlite)

    def test_null_override_deletes_default_key(self):
        base = {"a": {"b": 1, "c": 2}}
        assert helmlite._deep_merge(base, {"a": {"b": None}}) == \
            ref_helmlite._deep_merge(base, {"a": {"b": None}}) == \
            {"a": {"c": 2}}

    def test_self_signed_cert(self):
        pair = helmlite._gen_self_signed_cert(
            "svc.ns.svc", ["127.0.0.1"], ["svc", "svc.ns"], 2)
        assert pair["Cert"].startswith("-----BEGIN CERTIFICATE-----")
        assert "PRIVATE KEY-----" in pair["Key"]


def render(overrides=None, namespace="gpu-dra-driver"):
    return render_chart(CHART, overrides, namespace=namespace)


def by_kind_name(docs):
    return {(d["kind"], d["metadata"]["name"]): d for d in docs}


def _masked_keys(docs):
    return sorted(map(_key, _mask(docs)))


class TestPortChart:
    def test_default_render_is_all_manifests(self):
        assert _masked_keys(render_chart(CHART)) == \
            _masked_keys(manifests.all_manifests())

    @pytest.mark.parametrize("ns,image,ca", [
        ("gpu-dra-driver", "gpu-dra-driver:latest", "QUJD"),
        ("other", "example.com/gpu:v2", ""),
    ])
    def test_values_track_manifest_parameters(self, ns, image, ca):
        repo, tag = image.rsplit(":", 1)
        values = {"image": {"repository": repo, "tag": tag}}
        if ca:
            values["webhook"] = {"tls": {"mode": "secret", "secret": {
                "name": manifests.WEBHOOK_TLS_SECRET, "caBundle": ca}}}
        docs = render_chart(CHART, values, namespace=ns)
        assert _masked_keys(docs) == \
            _masked_keys(manifests.all_manifests(ns, image, ca))
        if ca:
            (vwc,) = [d for d in docs
                      if d["kind"] == "ValidatingWebhookConfiguration"]
            assert vwc["webhooks"][0]["clientConfig"]["caBundle"] == ca
            assert "Secret" not in {d["kind"] for d in docs}

    def test_self_signed_mode_adds_secret_with_the_ca(self):
        docs = render_chart(CHART, {"webhook": {"tls": {
            "mode": "selfsigned"}}})
        (secret,) = [d for d in docs if d["kind"] == "Secret"]
        assert secret["metadata"]["name"] == manifests.WEBHOOK_TLS_SECRET
        (vwc,) = [d for d in docs
                  if d["kind"] == "ValidatingWebhookConfiguration"]
        assert vwc["webhooks"][0]["clientConfig"]["caBundle"] == \
            secret["data"]["tls.crt"]
        assert base64.b64decode(secret["data"]["tls.crt"]).startswith(
            b"-----BEGIN CERTIFICATE-----")
        rest = [d for d in docs if d["kind"] != "Secret"]
        assert _masked_keys(rest) == \
            _masked_keys(manifests.all_manifests(ca_bundle="x"))

    def test_webhook_disabled_and_plugin_values(self):
        docs = render_chart(CHART, {
            "webhook": {"enabled": False},
            "featureGates": {"MultiprocessSupport": False},
            "kubeletPlugin": {"kubeletRoot": "/k", "cdiRoot": "/c",
                              "gpuPluginHealthPort": 9001}})
        assert not [d for d in docs if "webhook" in d["metadata"]["name"]]
        (ds,) = [d for d in docs if d["kind"] == "DaemonSet"]
        gpu = ds["spec"]["template"]["spec"]["containers"][0]
        env = {e["name"]: e.get("value") for e in gpu["env"]}
        assert env["PLUGIN_DIR"] == "/k/plugins/gpu.dev"
        assert env["CDI_ROOT"] == "/c"
        assert env["FEATURE_GATES"] == \
            "MultiprocessSupport=false,TimeSlicingSettings=true"
        assert env["HEALTHCHECK_PORT"] == "9001"
        assert gpu["livenessProbe"]["httpGet"]["port"] == 9001

    def test_crd_is_the_api_module(self):
        crds = [d for d in render_chart(CHART)
                if d["kind"] == "CustomResourceDefinition"]
        assert crds == [compute_domain_crd()]

    def test_strict_render_errors(self, tmp_path):
        import shutil
        bad = tmp_path / "chart"
        shutil.copytree(CHART, bad)
        with open(bad / "templates" / "broken.yaml", "w") as f:
            f.write("x: {{ nosuchfn 1 }}\n")
        with pytest.raises(TemplateError):
            render_chart(str(bad))

    def test_namespaces_and_crds_install_first(self):
        kinds = [d["kind"] for d in manifests.all_manifests()]
        assert kinds[:2] == ["Namespace", "CustomResourceDefinition"]

    def test_default_image_is_the_chart_app_version(self):
        with open(os.path.join(CHART, "Chart.yaml")) as f:
            app_version = yaml.safe_load(f)["appVersion"]
        assert manifests.DEFAULT_IMAGE == f"gpu-dra-driver:{app_version}"


class TestDefaultRender:
    """tests/test_deploy_chart.py::TestDefaultRender over the port's
    chart (a Namespace added: the port's chart renders its namespace so
    that applying the render alone creates it)."""

    def test_all_expected_kinds(self):
        assert sorted({d["kind"] for d in render()}) == sorted({
            "Namespace", "CustomResourceDefinition", "DaemonSet",
            "Deployment", "DeviceClass", "ServiceAccount", "ClusterRole",
            "ClusterRoleBinding", "NetworkPolicy", "Secret", "Service",
            "ValidatingWebhookConfiguration", "ValidatingAdmissionPolicy",
            "ValidatingAdmissionPolicyBinding"})

    def test_every_doc_well_formed(self):
        for d in render():
            assert d.get("apiVersion"), d
            assert d.get("kind"), d
            assert d.get("metadata", {}).get("name"), d

    def test_device_class_names_match_api_constants(self):
        names = {d["metadata"]["name"] for d in render()
                 if d["kind"] == "DeviceClass"}
        assert names == {manifests.DEVICE_CLASS_GPU,
                         manifests.DEVICE_CLASS_MIG,
                         apitypes.DEVICE_CLASS_DAEMON,
                         apitypes.DEVICE_CLASS_CHANNEL}

    def test_gpu_class_extended_resource_name_v1_only(self):
        gpu = by_kind_name(render())[("DeviceClass", "gpu.dev")]
        assert gpu["spec"]["extendedResourceName"] == "gpu.dev/gpu"
        mig = by_kind_name(render())[("DeviceClass", "mig.gpu.dev")]
        assert "extendedResourceName" not in mig["spec"]
        old = by_kind_name(render(
            {"resourceApiVersion": "resource.k8s.io/v1beta2"}))
        assert "extendedResourceName" not in \
            old[("DeviceClass", "gpu.dev")]["spec"]
        assert {d["apiVersion"] for (k, _), d in old.items()
                if k == "DeviceClass"} == {"resource.k8s.io/v1beta2"}

    def test_device_class_cel_uses_driver_names(self):
        for d in render():
            if d["kind"] != "DeviceClass":
                continue
            expr = d["spec"]["selectors"][0]["cel"]["expression"]
            assert expr.startswith('device.driver == "')
            assert (apitypes.GPU_DRIVER_NAME in expr
                    or apitypes.COMPUTE_DOMAIN_DRIVER_NAME in expr)

    def test_namespaced_objects_in_release_namespace(self):
        cluster_scoped = {"Namespace", "CustomResourceDefinition",
                          "DeviceClass", "ClusterRole",
                          "ClusterRoleBinding",
                          "ValidatingWebhookConfiguration",
                          "ValidatingAdmissionPolicy",
                          "ValidatingAdmissionPolicyBinding"}
        for d in render(namespace="prod-ns"):
            if d["kind"] in cluster_scoped:
                assert "namespace" not in d["metadata"], d["kind"]
            else:
                assert d["metadata"]["namespace"] == "prod-ns", d["kind"]

    def test_namespace_override(self):
        docs = render({"namespaceOverride": "other"}, namespace="default")
        assert {d["metadata"]["namespace"] for d in docs
                if "namespace" in d["metadata"]} == {"other"}
        assert by_kind_name(docs)[("Namespace", "other")]

    def test_workload_selectors_match_pod_labels(self):
        for d in render():
            if d["kind"] not in ("Deployment", "DaemonSet"):
                continue
            sel = d["spec"]["selector"]["matchLabels"]
            pod = d["spec"]["template"]["metadata"]["labels"]
            for k, v in sel.items():
                assert pod.get(k) == v, (d["metadata"]["name"], k)

    def test_image_defaults_to_app_version(self):
        with open(os.path.join(CHART, "Chart.yaml")) as f:
            app_version = yaml.safe_load(f)["appVersion"]
        ctr = by_kind_name(render())[("Deployment",
                                      "gpu-dra-driver-controller")]
        image = ctr["spec"]["template"]["spec"]["containers"][0]["image"]
        assert image == f"gpu-dra-driver:{app_version}"

    def test_feature_gates_env_joined(self):
        docs = by_kind_name(render(
            {"featureGates": {"A": True, "B": False}}))
        ds = docs[("DaemonSet", "gpu-dra-driver-kubelet-plugin")]
        envs = {e["name"]: e.get("value") for c in
                ds["spec"]["template"]["spec"]["containers"]
                for e in c["env"]}
        assert envs["FEATURE_GATES"] == ("A=true,B=false,"
                                         "MultiprocessSupport=true,"
                                         "TimeSlicingSettings=true")

    def test_log_verbosity_in_every_driver_container(self):
        for v in (4, 7):
            for d in render({"logVerbosity": v}):
                spec = (d.get("spec") or {}).get("template", {}).get("spec")
                if not spec:
                    continue
                for c in spec["containers"]:
                    env = {e["name"]: e.get("value") for e in c["env"]}
                    assert env["LOG_VERBOSITY"] == str(v), \
                        (d["metadata"]["name"], c["name"])

    def test_image_pull_secrets_and_tolerations(self):
        docs = render({"imagePullSecrets": [{"name": "regcred"}],
                       "controller": {"tolerations": [{
                           "key": "k", "operator": "Exists"}]}})
        for d in docs:
            spec = (d.get("spec") or {}).get("template", {}).get("spec")
            if spec:
                assert spec["imagePullSecrets"] == [{"name": "regcred"}], \
                    d["metadata"]["name"]
        by = by_kind_name(docs)
        ctrl = by[("Deployment", "gpu-dra-driver-controller")]
        assert ctrl["spec"]["template"]["spec"]["tolerations"] == [
            {"key": "k", "operator": "Exists"}]
        assert ctrl["spec"]["template"]["spec"]["priorityClassName"] == \
            "system-cluster-critical"
        ds = by[("DaemonSet", "gpu-dra-driver-kubelet-plugin")]
        assert ds["spec"]["template"]["spec"]["priorityClassName"] == \
            "system-node-critical"
        assert "imagePullSecrets" not in by_kind_name(render())[
            ("DaemonSet", "gpu-dra-driver-kubelet-plugin")]["spec"][
            "template"]["spec"]

    def test_plugin_health_ports_distinct(self):
        ds = by_kind_name(render())[("DaemonSet",
                                     "gpu-dra-driver-kubelet-plugin")]
        ports = [c["livenessProbe"]["httpGet"]["port"]
                 for c in ds["spec"]["template"]["spec"]["containers"]]
        assert len(ports) == len(set(ports)) == 2

    def test_daemon_sa_wired_controller_to_rbac(self):
        docs = by_kind_name(render())
        ctr = docs[("Deployment", "gpu-dra-driver-controller")]
        envs = {e["name"]: e.get("value") for e in
                ctr["spec"]["template"]["spec"]["containers"][0]["env"]}
        assert ("ServiceAccount", envs["DAEMON_SERVICE_ACCOUNT"]) in docs

    def test_controller_env_names_its_flags(self):
        """Every env var the chart gives the controller is one its flags
        read (a misspelt name would be silently ignored)."""
        from tpu_dra_torch.cdcontroller.main import flags
        read = {f.env for f in flags()._flags}
        ctr = by_kind_name(render())[("Deployment",
                                      "gpu-dra-driver-controller")]
        for e in ctr["spec"]["template"]["spec"]["containers"][0]["env"]:
            assert e["name"] in read, e["name"]

    def test_rbac_bindings_reference_existing_roles(self):
        docs = by_kind_name(render())
        for (kind, name), d in docs.items():
            if kind != "ClusterRoleBinding":
                continue
            assert ("ClusterRole", d["roleRef"]["name"]) in docs
            for s in d["subjects"]:
                assert ("ServiceAccount", s["name"]) in docs

    def test_network_policies_gated(self):
        names = {d["metadata"]["name"] for d in render()
                 if d["kind"] == "NetworkPolicy"}
        assert names == {"gpu-dra-driver-controller",
                         "gpu-dra-driver-kubelet-plugin",
                         "gpu-dra-driver-webhook"}
        for comp, name in (("controller", "gpu-dra-driver-controller"),
                           ("kubeletPlugin", "gpu-dra-driver-kubelet-plugin"),
                           ("webhook", "gpu-dra-driver-webhook")):
            left = {d["metadata"]["name"] for d in render(
                {comp: {"networkPolicy": {"enabled": False}}})
                if d["kind"] == "NetworkPolicy"}
            assert left == names - {name}, comp


class TestWebhookTLS:
    def test_selfsigned_secret_and_cabundle_share_cert(self):
        docs = by_kind_name(render())
        sec = docs[("Secret", "gpu-dra-driver-webhook-tls")]
        vwc = docs[("ValidatingWebhookConfiguration",
                    "gpu-dra-driver-webhook")]
        assert (sec["data"]["tls.crt"]
                == vwc["webhooks"][0]["clientConfig"]["caBundle"])
        assert base64.b64decode(sec["data"]["tls.crt"]).startswith(
            b"-----BEGIN CERTIFICATE-----")
        assert b"PRIVATE KEY" in base64.b64decode(sec["data"]["tls.key"])

    def test_selfsigned_cert_has_service_san(self):
        sec = by_kind_name(render(namespace="ns1"))[
            ("Secret", "gpu-dra-driver-webhook-tls")]
        dns = _cert_dns_names(base64.b64decode(sec["data"]["tls.crt"]))
        assert "gpu-dra-driver-webhook.ns1.svc" in dns
        assert "gpu-dra-driver-webhook.ns1.svc.cluster.local" in dns

    def test_cert_manager_mode(self):
        docs = render({"webhook": {"tls": {"mode": "cert-manager"}}})
        kinds = {d["kind"] for d in docs}
        assert "Issuer" in kinds and "Certificate" in kinds
        assert "Secret" not in kinds
        vwc = [d for d in docs
               if d["kind"] == "ValidatingWebhookConfiguration"][0]
        assert vwc["metadata"]["annotations"][
            "cert-manager.io/inject-ca-from"] == \
            "gpu-dra-driver/gpu-dra-driver-webhook-cert"
        assert "caBundle" not in vwc["webhooks"][0]["clientConfig"]

    def test_cert_manager_external_issuer(self):
        docs = render({"webhook": {"tls": {"mode": "cert-manager",
                                           "certManager": {
                                               "issuerType": "clusterissuer",
                                               "issuerName": "corp-ca"}}}})
        cert = [d for d in docs if d["kind"] == "Certificate"][0]
        assert cert["spec"]["issuerRef"] == {"kind": "ClusterIssuer",
                                             "name": "corp-ca"}
        assert not any(d["kind"] == "Issuer" for d in docs)

    def test_secret_mode_uses_operator_secret(self):
        docs = by_kind_name(render(
            {"webhook": {"tls": {"mode": "secret",
                                 "secret": {"name": "my-tls",
                                            "caBundle": "QUJD"}}}}))
        dep = docs[("Deployment", "gpu-dra-driver-webhook")]
        vol = dep["spec"]["template"]["spec"]["volumes"][0]
        assert vol["secret"]["secretName"] == "my-tls"
        vwc = docs[("ValidatingWebhookConfiguration",
                    "gpu-dra-driver-webhook")]
        assert vwc["webhooks"][0]["clientConfig"]["caBundle"] == "QUJD"

    def test_webhook_disabled(self):
        kinds = {d["kind"] for d in render({"webhook": {"enabled": False}})}
        assert "ValidatingWebhookConfiguration" not in kinds
        assert "Secret" not in kinds
        # The VAP backstop stays: it is the webhook-down guard.
        assert "ValidatingAdmissionPolicy" in kinds

    def test_admission_policy_disabled(self):
        kinds = {d["kind"] for d in render(
            {"admissionPolicy": {"enabled": False}})}
        assert not kinds & {"ValidatingAdmissionPolicy",
                            "ValidatingAdmissionPolicyBinding"}
        assert "ValidatingWebhookConfiguration" in kinds


def _cert_dns_names(pem: bytes):
    try:
        from cryptography import x509
    except ImportError:
        import re
        import tempfile
        with tempfile.NamedTemporaryFile(suffix=".pem") as f:
            f.write(pem)
            f.flush()
            out = subprocess.run(
                ["openssl", "x509", "-in", f.name, "-noout", "-text"],
                capture_output=True, text=True, check=True).stdout
        return re.findall(r"DNS:([^,\s]+)", out)
    cert = x509.load_pem_x509_certificate(pem)
    san = cert.extensions.get_extension_for_class(
        x509.SubjectAlternativeName).value
    return san.get_values_for_type(x509.DNSName)


class TestGating:
    def test_compute_domains_disabled(self):
        docs = render({"resources": {"computeDomains": {"enabled": False}}})
        names = {(d["kind"], d["metadata"]["name"]) for d in docs}
        assert ("Deployment", "gpu-dra-driver-controller") not in names
        assert ("ServiceAccount", "gpu-dra-driver-cd-daemon") not in names
        assert ("NetworkPolicy", "gpu-dra-driver-controller") not in names
        ds = [d for d in docs if d["kind"] == "DaemonSet"][0]
        assert [c["name"] for c in
                ds["spec"]["template"]["spec"]["containers"]] == \
            ["gpu-plugin"]

    def test_gpus_disabled(self):
        docs = render({"resources": {"gpus": {"enabled": False}}})
        dc = {d["metadata"]["name"] for d in docs
              if d["kind"] == "DeviceClass"}
        assert dc == {apitypes.DEVICE_CLASS_DAEMON,
                      apitypes.DEVICE_CLASS_CHANNEL}
        ds = [d for d in docs if d["kind"] == "DaemonSet"][0]
        assert [c["name"] for c in
                ds["spec"]["template"]["spec"]["containers"]] == \
            ["cd-plugin"]

    @pytest.mark.parametrize("overrides,namespace,frag", [
        (None, "default", "default' namespace"),
        ({"webhook": {"tls": {"mode": "bogus"}}}, "x", "webhook.tls.mode"),
        ({"webhook": {"tls": {"mode": "secret"}}}, "x", "secret.name"),
        ({"webhook": {"tls": {"mode": "secret", "secret": {
            "name": "s"}}}}, "x", "secret.caBundle"),
        ({"resources": {"tpus": {"enabled": False},
                        "computeDomains": {"enabled": False}}}, "x",
         "At least one"),
        ({"resourceApiVersion": ""}, "x", "resourceApiVersion"),
        ({"resourceApiVersion": "apps/v1"}, "x", "resource.k8s.io"),
        ({"webhook": {"tls": {"mode": "cert-manager",
                              "certManager": {"issuerType": "issuer"}}}},
         "x", "issuerName"),
        ({"webhook": {"tls": {"mode": "cert-manager",
                              "certManager": {"issuerType": "acme"}}}},
         "x", "issuerType"),
    ])
    def test_validation_failures(self, overrides, namespace, frag):
        """Both charts refuse the override, each through its own
        package's helmlite, with the same message after the renames; the
        reference's override names resources.tpus, the port's
        resources.gpus."""
        port_over = json.loads(json.dumps(overrides or {}).replace(
            '"tpus"', '"gpus"'))
        with pytest.raises(TemplateError, match=frag.replace("'", ".")) as p:
            render(port_over, namespace=namespace)
        with pytest.raises(ref_helmlite.TemplateError) as r:
            ref_helmlite.render_chart(REF_CHART, overrides,
                                      release_name="tpu-dra-driver",
                                      namespace=namespace)
        assert str(p.value) == str(r.value).replace("tpus", "gpus")

    def test_default_namespace_opt_in(self):
        assert render({"allowDefaultNamespace": True}, namespace="default")
        assert render({"namespaceOverride": "gpu"}, namespace="default")


RENDER = [sys.executable, "-m", "tpu_dra_torch.deploy.render"]


class TestRenderCli:
    def _run(self, *args):
        return subprocess.run(RENDER + list(args), capture_output=True,
                              text=True, timeout=120, cwd=ROOT)

    def test_cli_renders_and_sets_values(self):
        out = self._run("--set", "image.repository=example.com/gpu-dra",
                        "--set", "image.tag=v9", "--set", "logVerbosity=6",
                        "--set", "webhook.enabled=false", "-n", "ns2")
        assert out.returncode == 0, out.stderr
        docs = [d for d in yaml.safe_load_all(out.stdout) if d]
        ctr = by_kind_name(docs)[("Deployment",
                                  "gpu-dra-driver-controller")]
        c = ctr["spec"]["template"]["spec"]["containers"][0]
        assert c["image"] == "example.com/gpu-dra:v9"
        assert {e["name"]: e.get("value") for e in c["env"]}[
            "LOG_VERBOSITY"] == "6"
        assert ctr["metadata"]["namespace"] == "ns2"
        assert not [d for d in docs if "webhook" in d["metadata"]["name"]]

    def test_cli_values_file_and_demo_dir(self, tmp_path):
        values = tmp_path / "v.yaml"
        values.write_text("controller:\n  replicas: 3\n")
        out = self._run("--values", str(values), "-o",
                        str(tmp_path / "out"), "--demo-dir",
                        str(tmp_path / "demo"))
        assert out.returncode == 0, out.stderr
        with open(tmp_path / "out" / "gpu-dra-driver.yaml") as f:
            docs = [d for d in yaml.safe_load_all(f) if d]
        assert by_kind_name(docs)[("Deployment", "gpu-dra-driver-"
                                   "controller")]["spec"]["replicas"] == 3
        from tpu_dra_torch.deploy import demos
        assert sorted(os.listdir(tmp_path / "demo")) == sorted(
            f"{n}.yaml" for n in demos.all_demos())

    @pytest.mark.parametrize("arg,frag", [
        ("webhook.tls.mode=nope", "webhook.tls.mode"),
        ("resources.gpus.enabled=false", "At least one"),
    ])
    def test_cli_fails_on_bad_values(self, arg, frag):
        extra = (["--set", "resources.computeDomains.enabled=false"]
                 if "gpus" in arg else [])
        out = self._run("--set", arg, *extra)
        assert out.returncode == 1
        assert frag in out.stderr
        assert out.stdout == ""

    def test_cli_bad_set_syntax(self):
        out = self._run("--set", "novalue")
        assert out.returncode == 1
        assert "key.path=value" in out.stderr
