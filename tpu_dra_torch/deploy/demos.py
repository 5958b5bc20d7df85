"""Demo / quickstart specs (counterpart of tpu_dra/deploy/demos.py): the
quickstart ladder for GPUs, plus a ComputeDomain across nodes.

Every workload container runs ``python -m tpu_dra_torch.bench
claim-child`` by default: the flagship train step on the GPUs its
claims' CDI env names (the steps and launch counts on one JSON line of
its log). A caller that wants another workload passes ``command``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from tpu_dra_torch.api import types as apitypes
from tpu_dra_torch.deploy.manifests import (
    DEFAULT_IMAGE, DEVICE_CLASS_GPU, DEVICE_CLASS_MIG,
)

WORKLOAD_IMAGE = DEFAULT_IMAGE


def claim_child_command(steps: int = 3) -> List[str]:
    return ["python", "-m", "tpu_dra_torch.bench", "claim-child",
            "--steps", str(steps)]


def _ns(name: str) -> Dict:
    return {"apiVersion": "v1", "kind": "Namespace",
            "metadata": {"name": name}}


def _rct(name: str, ns: str, device_class: str, count: int = 1,
         config: Optional[Dict] = None, request: str = "gpu") -> Dict:
    spec: Dict = {"devices": {"requests": [{
        "name": request,
        "exactly": {"deviceClassName": device_class,
                    **({"count": count} if count != 1 else {})},
    }]}}
    if config:
        spec["devices"]["config"] = [{
            "requests": [request],
            "opaque": {"driver": apitypes.GPU_DRIVER_NAME,
                       "parameters": config}}]
    return {"apiVersion": "resource.k8s.io/v1",
            "kind": "ResourceClaimTemplate",
            "metadata": {"name": name, "namespace": ns},
            "spec": {"spec": spec}}


def _pod(name: str, ns: str, claims: Dict[str, Dict],
         command: Optional[List[str]] = None, containers: int = 1) -> Dict:
    """A pod whose every container references every claim of `claims`
    (pod-claim name -> source)."""
    ctrs = []
    for i in range(containers):
        ctrs.append({
            "name": f"ctr{i}" if containers > 1 else "ctr",
            "image": WORKLOAD_IMAGE,
            "command": list(command or claim_child_command()),
            "resources": {"claims": [{"name": n} for n in claims]},
        })
    return {
        "apiVersion": "v1", "kind": "Pod",
        "metadata": {"name": name, "namespace": ns},
        "spec": {
            "restartPolicy": "Never",
            "containers": ctrs,
            "resourceClaims": [{"name": n, **src}
                               for n, src in claims.items()],
        },
    }


# -- the quickstart ladder --------------------------------------------------

def test1_exclusive_per_pod(command=None, pods: int = 2) -> List[Dict]:
    """gpu-test1: `pods` pods, each with its own exclusive GPU."""
    ns = "gpu-test1"
    return [_ns(ns), _rct("single-gpu", ns, DEVICE_CLASS_GPU)] + [
        _pod(f"pod{i}", ns,
             {"gpu": {"resourceClaimTemplateName": "single-gpu"}}, command)
        for i in range(pods)]


def test2_shared_claim_two_containers(command=None) -> List[Dict]:
    """gpu-test2: one claim shared by two containers of one pod."""
    ns = "gpu-test2"
    return [_ns(ns), _rct("shared-gpu", ns, DEVICE_CLASS_GPU),
            _pod("pod0", ns,
                 {"gpu": {"resourceClaimTemplateName": "shared-gpu"}},
                 command, containers=2)]


def test3_time_sliced_across_pods(command=None) -> List[Dict]:
    """gpu-test3: one ResourceClaim (not a template) time-shared by two
    pods."""
    ns = "gpu-test3"
    claim = {
        "apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
        "metadata": {"name": "ts-gpu", "namespace": ns},
        "spec": {"devices": {
            "requests": [{"name": "gpu",
                          "exactly": {"deviceClassName": DEVICE_CLASS_GPU}}],
            "config": [{"requests": ["gpu"], "opaque": {
                "driver": apitypes.GPU_DRIVER_NAME,
                "parameters": {
                    "apiVersion": apitypes.API_VERSION,
                    "kind": apitypes.GPU_CONFIG_KIND,
                    "sharing": {"strategy": apitypes.TimeSlicingStrategy,
                                "timeSlicingConfig": {"interval": "Long"}},
                }}}],
        }},
    }
    return [_ns(ns), claim] + [
        _pod(f"pod{i}", ns, {"gpu": {"resourceClaimName": "ts-gpu"}},
             command) for i in range(2)]


def test4_multi_gpu(command=None, count: int = 4) -> List[Dict]:
    """gpu-test4: one pod claiming `count` GPUs on one node."""
    ns = "gpu-test4"
    return [_ns(ns), _rct("multi-gpu", ns, DEVICE_CLASS_GPU, count=count),
            _pod("pod0", ns,
                 {"gpu": {"resourceClaimTemplateName": "multi-gpu"}},
                 command)]


def test5_mig(command=None, pods: int = 2) -> List[Dict]:
    """gpu-test5: `pods` pods, each claiming a MIG device (of the same
    GPU where it has room)."""
    ns = "gpu-test5"
    return [_ns(ns), _rct("mig", ns, DEVICE_CLASS_MIG)] + [
        _pod(f"pod{i}", ns, {"gpu": {"resourceClaimTemplateName": "mig"}},
             command) for i in range(pods)]


def test_mps_shared_gpu(command=None) -> List[Dict]:
    """gpu-test-mps: one pod, two containers sharing a GPU through the
    claim's MPS control daemon."""
    ns = "gpu-test-mps"
    config = {
        "apiVersion": apitypes.API_VERSION, "kind": apitypes.GPU_CONFIG_KIND,
        "sharing": {"strategy": apitypes.MpsStrategy,
                    "mpsConfig": {"defaultActiveThreadPercentage": 50}},
    }
    return [_ns(ns), _rct("mps-gpu", ns, DEVICE_CLASS_GPU, config=config),
            _pod("pod0", ns,
                 {"gpu": {"resourceClaimTemplateName": "mps-gpu"}},
                 command, containers=2)]


def print_env_command(tag: str) -> List[str]:
    """A container that prints its tag and CUDA_VISIBLE_DEVICES."""
    return ["python", "-c",
            f"import os; print('{tag} CUDA_VISIBLE_DEVICES=%s' % "
            "os.environ.get('CUDA_VISIBLE_DEVICES'))"]


def _mig_claim(name: str, ns: str, expr: str) -> Dict:
    # The driver clause first: && decides on its left-hand side, so the
    # selector never reads another driver's attributes (the sim's CEL
    # absorbs no error).
    cel = f'device.driver == "{apitypes.GPU_DRIVER_NAME}" && {expr}'
    return {"apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
            "metadata": {"name": name, "namespace": ns},
            "spec": {"devices": {"requests": [{
                "name": "mig",
                "exactly": {"deviceClassName": DEVICE_CLASS_MIG,
                            "selectors": [{"cel": {"expression": cel}}]},
            }]}}}


TEST6_PROFILE = "3g.40gb"
TEST6_STARTS = (0, 4)


def test6_cel_selection(gpu_index: int = 3,
                        commands: Optional[List[List[str]]] = None
                        ) -> List[Dict]:
    """gpu-test6: CEL attribute selection. One pod, two containers, each
    consuming a different MIG device of one GPU: claim ``mig0`` and
    ``mig1`` pin the TEST6_PROFILE devices at placementStart 0 and 4 of
    the GPU at `gpu_index` by the published attributes (productName,
    architecture, index, profile, placementStart), so a wrong attribute
    name, type or value leaves a claim unallocated. A third claim's
    selector (an architecture no GPU has) cannot be satisfied: its pod,
    ``pod-unsatisfiable``, must stay Pending."""
    ns = "gpu-test6"
    attr = f"device.attributes['{apitypes.GPU_DRIVER_NAME}']"
    claims = [_mig_claim(f"mig{i}", ns, (
        f"{attr}.productName.lowerAscii().matches('^nvidia h100.*$') && "
        f"{attr}.architecture == 'hopper' && "
        f"{attr}.index == {gpu_index} && "
        f"{attr}.profile == '{TEST6_PROFILE}' && "
        f"{attr}.placementStart == {start}"))
        for i, start in enumerate(TEST6_STARTS)]
    cmds = commands or [print_env_command(f"CTR{i}") for i in range(2)]
    pod = {
        "apiVersion": "v1", "kind": "Pod",
        "metadata": {"name": "pod0", "namespace": ns},
        "spec": {
            "restartPolicy": "Never",
            "containers": [{
                "name": f"ctr{i}", "image": WORKLOAD_IMAGE,
                "command": list(cmds[i]),
                "resources": {"claims": [{"name": f"mig{i}"}]}}
                for i in range(2)],
            "resourceClaims": [{"name": f"mig{i}",
                                "resourceClaimName": f"mig{i}"}
                               for i in range(2)],
        },
    }
    never = _mig_claim("no-such-architecture", ns,
                       f"{attr}.architecture == 'Rubin99'")
    pending = _pod("pod-unsatisfiable", ns, {
        "mig": {"resourceClaimName": "no-such-architecture"}},
        ["python", "-c", "print('must never run')"])
    return [_ns(ns)] + claims + [pod, never, pending]


def test_passthrough(command=None) -> List[Dict]:
    """gpu-test-passthrough: a whole GPU claimed for VFIO passthrough to
    a VM workload. Needs the PassthroughSupport feature gate on the
    kubelet plugin (off by default). The prepared claim rebinds the
    GPU's PCI function to vfio-pci and injects /dev/vfio/vfio and
    /dev/vfio/<iommu-group> instead of /dev/nvidia*."""
    ns = "gpu-test-passthrough"
    claim = {
        "apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
        "metadata": {"name": "pt-gpu", "namespace": ns},
        "spec": {"devices": {
            "requests": [{"name": "gpu",
                          "exactly": {"deviceClassName": DEVICE_CLASS_GPU}}],
            "config": [{"requests": ["gpu"], "opaque": {
                "driver": apitypes.GPU_DRIVER_NAME,
                "parameters": {
                    "apiVersion": apitypes.API_VERSION,
                    "kind": apitypes.PASSTHROUGH_CONFIG_KIND,
                }}}],
        }},
    }
    pod = _pod("vm-launcher", ns, {"gpu": {"resourceClaimName": "pt-gpu"}},
               command or ["sh", "-c", "ls -l /dev/vfio && sleep 3600"])
    pod["spec"]["containers"][0]["name"] = "vm"
    return [_ns(ns), claim, pod]


# -- multi-node ComputeDomain ---------------------------------------------

def cd_train(num_nodes: int = 2, command=None) -> List[Dict]:
    """A ComputeDomain of `num_nodes` nodes and one pod per node, each
    with a GPU claim and the domain's channel claim: claim-child takes
    the domain path (NODE_RANK, NNODES, MASTER_ADDR in its env) and the
    nodes' GPUs train as one group."""
    ns = "gpu-cd"
    cd = {
        "apiVersion": apitypes.API_VERSION, "kind": "ComputeDomain",
        "metadata": {"name": "train-cd", "namespace": ns},
        "spec": {"numNodes": num_nodes, "channel": {
            "resourceClaimTemplate": {"name": "train-channel"},
            "allocationMode": apitypes.ALLOCATION_MODE_SINGLE}},
    }
    pods = []
    for i in range(num_nodes):
        pod = _pod(f"train-{i}", ns,
                   {"gpu": {"resourceClaimTemplateName": "single-gpu"},
                    "channel": {"resourceClaimTemplateName":
                                "train-channel"}}, command)
        # One pod per node: the channel device exists once per node.
        pod["spec"]["affinity"] = {"podAntiAffinity": {
            "requiredDuringSchedulingIgnoredDuringExecution": [{
                "labelSelector": {"matchLabels": {"app": "gpu-cd-train"}},
                "topologyKey": "kubernetes.io/hostname"}]}}
        pod["metadata"]["labels"] = {"app": "gpu-cd-train"}
        pods.append(pod)
    return [_ns(ns), _rct("single-gpu", ns, DEVICE_CLASS_GPU), cd] + pods


def all_demos() -> Dict[str, List[Dict]]:
    return {
        "gpu-test1": test1_exclusive_per_pod(),
        "gpu-test2": test2_shared_claim_two_containers(),
        "gpu-test3": test3_time_sliced_across_pods(),
        "gpu-test4": test4_multi_gpu(),
        "gpu-test5": test5_mig(),
        "gpu-test6": test6_cel_selection(),
        "gpu-test-passthrough": test_passthrough(),
        "gpu-test-mps": test_mps_shared_gpu(),
        "gpu-cd-train": cd_train(),
    }
