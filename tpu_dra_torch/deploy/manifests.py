"""Cluster manifests for the GPU DRA driver (counterpart of
tpu_dra/deploy/manifests.py), as Python dicts: the sim cluster installs
them without parsing YAML, and the chart under ``chart/gpu-dra-driver``
renders to the same documents (``all_manifests()``).

- DeviceClasses ``gpu.dev`` (a whole GPU), ``mig.gpu.dev`` (a MIG
  device) and the compute-domain daemon and channel classes, each
  selector with the driver clause first;
- RBAC, the compute-domain controller Deployment and the kubelet-plugin
  DaemonSet (``python -m tpu_dra_torch.gpuplugin.main`` and
  ``.cdplugin.main`` on every node labeled ``gpu.dev/present``);
- the webhook (Deployment, Service, ValidatingWebhookConfiguration) and
  the ValidatingAdmissionPolicy that refuses unknown opaque config kinds.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from tpu_dra_torch.api import types as apitypes
from tpu_dra_torch.api.crd import compute_domain_crd

APP = "gpu-dra-driver"
DEFAULT_NAMESPACE = "gpu-dra-driver"
DEFAULT_IMAGE = "gpu-dra-driver:latest"
# Gates enabled in the rendered deployment so the demos that share a GPU
# (time slicing, MPS) work out of the box; operators can override.
DEFAULT_FEATURE_GATES = "MultiprocessSupport=true,TimeSlicingSettings=true"
# The node label the plugin DaemonSet selects.
NODE_LABEL = "gpu.dev/present"
KUBELET_ROOT = "/var/lib/kubelet"
CDI_ROOT = "/var/run/cdi"
DEVICE_CLASS_GPU = "gpu.dev"
DEVICE_CLASS_MIG = "mig.gpu.dev"
WEBHOOK_TLS_SECRET = f"{APP}-webhook-tls"


def namespace(ns: str = DEFAULT_NAMESPACE) -> Dict:
    return {"apiVersion": "v1", "kind": "Namespace",
            "metadata": {"name": ns}}


# ---------------------------------------------------------------------------
# DeviceClasses (CEL selectors over published device attributes)
# ---------------------------------------------------------------------------

def _device_class(name: str, driver: str, device_type: str,
                  extended_resource: str = "") -> Dict:
    # The driver clause first: && short-circuits, so a device of another
    # driver never has its attributes read.
    cel = (f'device.driver == "{driver}" && '
           f'device.attributes["{driver}"].type == "{device_type}"')
    spec: Dict = {"selectors": [{"cel": {"expression": cel}}]}
    if extended_resource:
        spec = {"extendedResourceName": extended_resource, **spec}
    return {
        "apiVersion": "resource.k8s.io/v1",
        "kind": "DeviceClass",
        "metadata": {"name": name},
        "spec": spec,
    }


def device_classes() -> List[Dict]:
    gpu = apitypes.GPU_DRIVER_NAME
    cd = apitypes.COMPUTE_DOMAIN_DRIVER_NAME
    return [
        _device_class(DEVICE_CLASS_GPU, gpu, "gpu",
                      extended_resource="gpu.dev/gpu"),
        _device_class(DEVICE_CLASS_MIG, gpu, "mig"),
        _device_class(apitypes.DEVICE_CLASS_DAEMON, cd, "daemon"),
        _device_class(apitypes.DEVICE_CLASS_CHANNEL, cd, "channel"),
    ]


# ---------------------------------------------------------------------------
# RBAC
# ---------------------------------------------------------------------------

def rbac(ns: str = DEFAULT_NAMESPACE) -> List[Dict]:
    rules = [
        {"apiGroups": [apitypes.GROUP],
         "resources": ["computedomains", "computedomains/status"],
         "verbs": ["get", "list", "watch", "create", "update", "patch",
                   "delete"]},
        {"apiGroups": ["resource.k8s.io"],
         "resources": ["resourceclaims", "resourceclaimtemplates",
                       "resourceslices", "deviceclasses"],
         "verbs": ["get", "list", "watch", "create", "update", "patch",
                   "delete"]},
        {"apiGroups": ["apps"], "resources": ["daemonsets", "deployments"],
         "verbs": ["get", "list", "watch", "create", "update", "patch",
                   "delete"]},
        {"apiGroups": [""], "resources": ["nodes", "pods"],
         "verbs": ["get", "list", "watch", "patch", "update"]},
        {"apiGroups": [""], "resources": ["events"],
         "verbs": ["create", "patch"]},
    ]
    return [
        {"apiVersion": "v1", "kind": "ServiceAccount",
         "metadata": {"name": APP, "namespace": ns}},
        {"apiVersion": "rbac.authorization.k8s.io/v1", "kind": "ClusterRole",
         "metadata": {"name": APP}, "rules": rules},
        {"apiVersion": "rbac.authorization.k8s.io/v1",
         "kind": "ClusterRoleBinding",
         "metadata": {"name": APP},
         "roleRef": {"apiGroup": "rbac.authorization.k8s.io",
                     "kind": "ClusterRole", "name": APP},
         "subjects": [{"kind": "ServiceAccount", "name": APP,
                       "namespace": ns}]},
    ]


# ---------------------------------------------------------------------------
# Controller Deployment
# ---------------------------------------------------------------------------

def controller_deployment(ns: str = DEFAULT_NAMESPACE,
                          image: str = DEFAULT_IMAGE) -> Dict:
    labels = {"app.kubernetes.io/name": f"{APP}-controller"}
    return {
        "apiVersion": "apps/v1", "kind": "Deployment",
        "metadata": {"name": f"{APP}-controller", "namespace": ns,
                     "labels": labels},
        "spec": {
            "replicas": 1,
            "selector": {"matchLabels": labels},
            "template": {
                "metadata": {"labels": labels},
                "spec": {
                    "serviceAccountName": APP,
                    "priorityClassName": "system-cluster-critical",
                    "containers": [{
                        "name": "controller",
                        "image": image,
                        "command": ["python", "-m",
                                    "tpu_dra_torch.cdcontroller.main"],
                        "env": [
                            {"name": "NAMESPACE", "valueFrom": {"fieldRef": {
                                "fieldPath": "metadata.namespace"}}},
                            {"name": "DAEMON_IMAGE", "value": image},
                            {"name": "HTTP_ENDPOINT_PORT", "value": "8080"},
                        ],
                        "ports": [{"name": "metrics",
                                   "containerPort": 8080}],
                    }],
                },
            },
        },
    }


# ---------------------------------------------------------------------------
# Kubelet plugin DaemonSet (both plugins on every GPU node)
# ---------------------------------------------------------------------------

def kubelet_plugin_daemonset(ns: str = DEFAULT_NAMESPACE,
                             image: str = DEFAULT_IMAGE) -> Dict:
    labels = {"app.kubernetes.io/name": f"{APP}-kubelet-plugin"}
    plugins = f"{KUBELET_ROOT}/plugins"
    registry = f"{KUBELET_ROOT}/plugins_registry"
    host_mounts = [
        {"name": "plugins", "hostPath": {
            "path": plugins, "type": "DirectoryOrCreate"}},
        {"name": "plugins-registry", "hostPath": {
            "path": registry, "type": "DirectoryOrCreate"}},
        {"name": "cdi", "hostPath": {"path": CDI_ROOT,
                                     "type": "DirectoryOrCreate"}},
        {"name": "dev", "hostPath": {"path": "/dev"}},
        {"name": "sys", "hostPath": {"path": "/sys"}},
    ]
    mounts = [
        {"name": "plugins", "mountPath": plugins},
        {"name": "plugins-registry", "mountPath": registry},
        {"name": "cdi", "mountPath": CDI_ROOT},
        {"name": "dev", "mountPath": "/dev"},
        {"name": "sys", "mountPath": "/sys", "readOnly": True},
    ]

    def env(driver: str, port: str) -> List[Dict]:
        return [
            {"name": "NODE_NAME", "valueFrom": {"fieldRef": {
                "fieldPath": "spec.nodeName"}}},
            {"name": "NAMESPACE", "valueFrom": {"fieldRef": {
                "fieldPath": "metadata.namespace"}}},
            {"name": "CDI_ROOT", "value": CDI_ROOT},
            {"name": "PLUGIN_DIR", "value": f"{plugins}/{driver}"},
            {"name": "REGISTRY_DIR", "value": registry},
            {"name": "FEATURE_GATES", "value": DEFAULT_FEATURE_GATES},
            # Distinct healthcheck ports: both containers share the pod
            # network namespace.
            {"name": "HEALTHCHECK_PORT", "value": port},
        ]

    def container(name: str, module: str, driver: str, port: int,
                  extra_env: List[Dict]) -> Dict:
        return {
            "name": name,
            "image": image,
            "command": ["python", "-m", module],
            "securityContext": {"privileged": True},
            "env": env(driver, str(port)) + extra_env,
            "livenessProbe": {
                "httpGet": {"path": "/healthz", "port": port},
                "periodSeconds": 10,
                "failureThreshold": 3,
            },
            "volumeMounts": mounts,
        }

    return {
        "apiVersion": "apps/v1", "kind": "DaemonSet",
        "metadata": {"name": f"{APP}-kubelet-plugin", "namespace": ns,
                     "labels": labels},
        "spec": {
            "selector": {"matchLabels": labels},
            "template": {
                "metadata": {"labels": labels},
                "spec": {
                    "serviceAccountName": APP,
                    "priorityClassName": "system-node-critical",
                    "nodeSelector": {NODE_LABEL: "true"},
                    # Prestart validation: the node's GPUs are readable.
                    "initContainers": [{
                        "name": "validate",
                        "image": image,
                        "command": ["python", "-c",
                                    "from tpu_dra_torch.native.gpuinfo "
                                    "import get_backend; "
                                    "print(len(get_backend().gpus()), "
                                    "'gpus')"],
                        "volumeMounts": mounts,
                    }],
                    "containers": [
                        container("gpu-plugin",
                                  "tpu_dra_torch.gpuplugin.main",
                                  apitypes.GPU_DRIVER_NAME, 8081,
                                  [{"name": "MPS_IMAGE", "value": image}]),
                        container("cd-plugin",
                                  "tpu_dra_torch.cdplugin.main",
                                  apitypes.COMPUTE_DOMAIN_DRIVER_NAME, 8082,
                                  []),
                    ],
                    "volumes": host_mounts,
                },
            },
        },
    }


# ---------------------------------------------------------------------------
# Webhook
# ---------------------------------------------------------------------------

def webhook_manifests(ns: str = DEFAULT_NAMESPACE,
                      image: str = DEFAULT_IMAGE,
                      ca_bundle: str = "") -> List[Dict]:
    labels = {"app.kubernetes.io/name": f"{APP}-webhook"}
    deployment = {
        "apiVersion": "apps/v1", "kind": "Deployment",
        "metadata": {"name": f"{APP}-webhook", "namespace": ns,
                     "labels": labels},
        "spec": {
            "replicas": 1,
            "selector": {"matchLabels": labels},
            "template": {
                "metadata": {"labels": labels},
                "spec": {"containers": [{
                    "name": "webhook",
                    "image": image,
                    "command": ["python", "-m",
                                "tpu_dra_torch.webhook.main"],
                    "env": [
                        {"name": "TLS_CERT_FILE",
                         "value": "/etc/webhook/tls/tls.crt"},
                        {"name": "TLS_KEY_FILE",
                         "value": "/etc/webhook/tls/tls.key"},
                        {"name": "WEBHOOK_PORT", "value": "8443"},
                        {"name": "FEATURE_GATES",
                         "value": DEFAULT_FEATURE_GATES},
                    ],
                    "ports": [{"containerPort": 8443}],
                    "readinessProbe": {"httpGet": {
                        "path": "/readyz", "port": 8443, "scheme": "HTTPS"}},
                    "volumeMounts": [{"name": "tls",
                                      "mountPath": "/etc/webhook/tls",
                                      "readOnly": True}],
                }],
                    "volumes": [{"name": "tls", "secret": {
                        "secretName": WEBHOOK_TLS_SECRET}}]},
            },
        },
    }
    service = {
        "apiVersion": "v1", "kind": "Service",
        "metadata": {"name": f"{APP}-webhook", "namespace": ns},
        "spec": {"selector": labels,
                 "ports": [{"port": 443, "targetPort": 8443}]},
    }
    config = {
        "apiVersion": "admissionregistration.k8s.io/v1",
        "kind": "ValidatingWebhookConfiguration",
        "metadata": {"name": f"{APP}-webhook"},
        "webhooks": [{
            "name": "resource-claim-parameters.gpu.dev",
            "admissionReviewVersions": ["v1"],
            "sideEffects": "None",
            "failurePolicy": "Ignore",
            "clientConfig": {
                "service": {"name": f"{APP}-webhook", "namespace": ns,
                            "path": "/validate-resource-claim-parameters"},
                **({"caBundle": ca_bundle} if ca_bundle else {}),
            },
            "rules": [{
                "apiGroups": ["resource.k8s.io"],
                "apiVersions": ["v1", "v1beta1", "v1beta2"],
                "operations": ["CREATE", "UPDATE"],
                "resources": ["resourceclaims", "resourceclaimtemplates"],
            }],
        }],
    }
    return [deployment, service, config]


def webhook_tls_secret(ns: str = DEFAULT_NAMESPACE) -> Tuple[Dict, str]:
    """A self-signed serving cert for the webhook Service: (the Secret
    the webhook Deployment mounts, the base64 CA bundle to pass to
    all_manifests). Needs the cryptography package or the openssl CLI
    (helmlite's genSelfSignedCert)."""
    import base64

    from tpu_dra_torch.deploy.helmlite import _gen_self_signed_cert

    svc = f"{APP}-webhook"
    pair = _gen_self_signed_cert(
        f"{svc}.{ns}.svc", [], [svc, f"{svc}.{ns}", f"{svc}.{ns}.svc"], 365)

    def b64(text: str) -> str:
        return base64.b64encode(text.encode()).decode()

    secret = {"apiVersion": "v1", "kind": "Secret",
              "metadata": {"name": WEBHOOK_TLS_SECRET, "namespace": ns},
              "type": "kubernetes.io/tls",
              "data": {"tls.crt": b64(pair["Cert"]),
                       "tls.key": b64(pair["Key"])}}
    return secret, b64(pair["Cert"])


def validating_admission_policy() -> List[Dict]:
    """Deploy-time CEL guard: rejects opaque configs owned by this driver
    whose apiVersion/kind are not among the known ones — a structural
    gate that works even when the webhook is down (failurePolicy
    Ignore). Two policies, since claims ('spec') and templates
    ('spec.spec') nest the device spec differently."""
    known_kinds = [apitypes.GPU_CONFIG_KIND, apitypes.MIG_DEVICE_CONFIG_KIND,
                   apitypes.PASSTHROUGH_CONFIG_KIND,
                   apitypes.COMPUTE_DOMAIN_CHANNEL_CONFIG_KIND,
                   apitypes.COMPUTE_DOMAIN_DAEMON_CONFIG_KIND]
    kinds_cel = "[" + ", ".join(f"'{k}'" for k in known_kinds) + "]"
    drivers_cel = (f"['{apitypes.GPU_DRIVER_NAME}', "
                   f"'{apitypes.COMPUTE_DOMAIN_DRIVER_NAME}']")

    def _expr(spec_path: str) -> str:
        return (
            f"!has({spec_path}.devices) || "
            f"!has({spec_path}.devices.config) || "
            f"{spec_path}.devices.config.all(c, "
            "!has(c.opaque) || !(c.opaque.driver in " + drivers_cel + ") || "
            "(has(c.opaque.parameters.kind) && "
            "c.opaque.parameters.kind in " + kinds_cel + " && "
            "c.opaque.parameters.apiVersion == '"
            + apitypes.API_VERSION + "'))")

    out: List[Dict] = []
    for suffix, resource, spec_path in (
            ("claims", "resourceclaims", "object.spec"),
            ("templates", "resourceclaimtemplates", "object.spec.spec")):
        name = f"{APP}-opaque-config-{suffix}"
        out.append({
            "apiVersion": "admissionregistration.k8s.io/v1",
            "kind": "ValidatingAdmissionPolicy",
            "metadata": {"name": name},
            "spec": {
                "failurePolicy": "Fail",
                "matchConstraints": {"resourceRules": [{
                    "apiGroups": ["resource.k8s.io"],
                    "apiVersions": ["v1"],
                    "operations": ["CREATE", "UPDATE"],
                    "resources": [resource],
                }]},
                "validations": [{
                    "expression": _expr(spec_path),
                    "message": "opaque device config owned by gpu.dev has "
                               "an unknown kind or apiVersion",
                }],
            },
        })
        out.append({
            "apiVersion": "admissionregistration.k8s.io/v1",
            "kind": "ValidatingAdmissionPolicyBinding",
            "metadata": {"name": name},
            "spec": {"policyName": name, "validationActions": ["Deny"]},
        })
    return out


def all_manifests(ns: str = DEFAULT_NAMESPACE,
                  image: str = DEFAULT_IMAGE,
                  ca_bundle: str = "") -> List[Dict]:
    return ([namespace(ns), compute_domain_crd()]
            + device_classes()
            + rbac(ns)
            + [controller_deployment(ns, image),
               kubelet_plugin_daemonset(ns, image)]
            + webhook_manifests(ns, image, ca_bundle)
            + validating_admission_policy())
