"""Port parity: tpu_dra_torch.deploy.helmlite against tpu_dra's, and the
port's chart against its manifests, on the CPU.

- helmlite renders the REFERENCE's chart (deployments/helm/
  tpu-dra-driver) into the same documents as the reference's
  render_chart, over the default values and the reference tests' value
  overrides, and raises the same TemplateError where the reference does
  (generated cert material is masked: it is random per render); the
  template-language cases of tests/test_helmlite.py give the same text
  through both engines.
- The port's chart (tpu_dra_torch/deploy/chart/gpu-dra-driver) renders
  by default to exactly manifests.all_manifests(), and its values move
  the documents as manifests' parameters do.
"""

import base64
import json
import os

import pytest

from tpu_dra.deploy import helmlite as ref_helmlite
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


class TestPortChart:
    def test_default_render_is_all_manifests(self):
        assert sorted(map(_key, render_chart(CHART))) == \
            sorted(map(_key, manifests.all_manifests()))

    @pytest.mark.parametrize("ns,image,ca", [
        ("gpu-dra-driver", "gpu-dra-driver:latest", "QUJD"),
        ("other", "example.com/gpu:v2", ""),
    ])
    def test_values_track_manifest_parameters(self, ns, image, ca):
        repo, tag = image.rsplit(":", 1)
        docs = render_chart(CHART, {"image": {"repository": repo,
                                              "tag": tag},
                                    "webhook": {"caBundle": ca}},
                            namespace=ns)
        assert sorted(map(_key, docs)) == \
            sorted(map(_key, manifests.all_manifests(ns, image, ca)))

    def test_self_signed_mode_adds_secret_with_the_ca(self):
        docs = render_chart(CHART, {"webhook": {"tls": {
            "mode": "selfSigned"}}})
        (secret,) = [d for d in docs if d["kind"] == "Secret"]
        assert secret["metadata"]["name"] == manifests.WEBHOOK_TLS_SECRET
        (vwc,) = [d for d in docs
                  if d["kind"] == "ValidatingWebhookConfiguration"]
        assert vwc["webhooks"][0]["clientConfig"]["caBundle"] == \
            secret["data"]["tls.crt"]
        assert base64.b64decode(secret["data"]["tls.crt"]).startswith(
            b"-----BEGIN CERTIFICATE-----")
        rest = [d for d in docs if d["kind"] != "Secret"]
        assert sorted(map(_key, _mask(rest))) == sorted(map(_key, _mask(
            manifests.all_manifests(ca_bundle="x"))))

    def test_webhook_disabled_and_plugin_values(self):
        docs = render_chart(CHART, {
            "webhook": {"enabled": False},
            "featureGates": "TimeSlicingSettings=true",
            "kubeletPlugin": {"kubeletRoot": "/k", "cdiRoot": "/c",
                              "gpuPluginHealthPort": 9001}})
        assert not [d for d in docs if "webhook" in d["metadata"]["name"]]
        (ds,) = [d for d in docs if d["kind"] == "DaemonSet"]
        gpu = ds["spec"]["template"]["spec"]["containers"][0]
        env = {e["name"]: e.get("value") for e in gpu["env"]}
        assert env["PLUGIN_DIR"] == "/k/plugins/gpu.dev"
        assert env["CDI_ROOT"] == "/c"
        assert env["FEATURE_GATES"] == "TimeSlicingSettings=true"
        assert env["HEALTHCHECK_PORT"] == "9001"
        assert gpu["livenessProbe"]["httpGet"]["port"] == 9001

    def test_crd_is_the_api_module(self):
        from tpu_dra_torch.api.crd import compute_domain_crd
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
