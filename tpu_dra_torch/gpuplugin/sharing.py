"""GPU sharing: time-slicing and MPS (counterpart of TimeSlicingManager,
MultiprocessDaemon and MultiprocessManager in tpu_dra/tpuplugin/sharing.py).

- ``TimeSlicingManager`` programs each GPU's compute time slice through
  the backend (``nvidia-smi compute-policy --set-timeslice`` on a real
  node) and drops exclusive compute mode, since time-slicing implies
  shared access. A GPU that supports neither setting (as on a
  virtualised host) already runs at the driver's default time slice:
  setting the default there is a no-op when the GPU reads compute mode
  DEFAULT, while any other level, or a mode that cannot be read, fails.
- ``MpsManager`` runs one MPS control daemon per claim as a Deployment
  (the reference's create -> assert ready -> CDI edits -> stop lifecycle).
  Its container runs ``nvidia-cuda-mps-control -f`` in the foreground, so
  kubelet owns the process, with the pipe and log directories under the
  claim's directory, a hostPath volume. The daemon reads the claim's
  limits from the ``CUDA_MPS_*`` env of its container, and the tenants
  get the same env and the pipe directory through the claim's CDI edits:
  one function (``MpsControlDaemon.limits``) renders both. The GPUs are
  set to EXCLUSIVE_PROCESS before the daemon starts, so that only the
  MPS server opens a context on them.
"""

from __future__ import annotations

import logging
import os
import shutil
import time
from typing import Dict, List, Optional

from tpu_dra_torch.api import types as apitypes
from tpu_dra_torch.infra.quantity import Quantity
from tpu_dra_torch.k8s import DEPLOYMENTS, new_object_meta
from tpu_dra_torch.k8s.client import (
    AlreadyExistsError, ApiClient, ConflictError, NotFoundError,
)
from tpu_dra_torch.native.gpuinfo import (
    NVML_COMPUTEMODE_DEFAULT, NVML_ERROR_NOT_SUPPORTED, Gpu, GpuInfoBackend,
    NvmlError,
)

log = logging.getLogger("tpu_dra_torch.sharing")

MPS_CONTROL = "nvidia-cuda-mps-control"
MPS_APP_LABEL = "gpu-mps-control-daemon"
MPS_CLAIM_LABEL = "gpu.dev/claim-uid"
# Where the claim's directory is mounted, in the daemon and the tenants.
MPS_CONTAINER_DIR = "/mps"
ENV_MPS_PIPE = "CUDA_MPS_PIPE_DIRECTORY"
ENV_MPS_LOG = "CUDA_MPS_LOG_DIRECTORY"
ENV_MPS_THREADS = "CUDA_MPS_ACTIVE_THREAD_PERCENTAGE"
ENV_MPS_PINNED = "CUDA_MPS_PINNED_DEVICE_MEM_LIMIT"
# The control daemon answers on its pipe: what the readiness probe asks.
MPS_PROBE = f"echo get_server_list | {MPS_CONTROL}"
MPS_QUIT = f"echo quit | {MPS_CONTROL}"


class TimeSlicingManager:
    """Programs per-GPU time-slice levels."""

    def __init__(self, backend: GpuInfoBackend):
        self._backend = backend

    def set_timeslice(self, gpus: List[Gpu],
                      config: apitypes.TimeSlicingConfig) -> None:
        level = config.level()
        default = level == apitypes.TIME_SLICE_INTERVALS[
            apitypes.DEFAULT_TIME_SLICE]
        for gpu in gpus:
            try:
                self._backend.set_timeslice(gpu.index, level)
            except NvmlError as e:
                if not (default and e.code == NVML_ERROR_NOT_SUPPORTED):
                    raise
                log.info("GPU %d supports no time-slice policy: it runs "
                         "at the default", gpu.index)
            # Time-slicing implies shared access: drop exclusive mode
            # (compute mode DEFAULT).
            try:
                self._backend.set_exclusive_mode(gpu.index, False)
            except NvmlError as e:
                # A GPU whose compute mode cannot be set is shared
                # already only when it reads DEFAULT; a mode that cannot
                # be read proves nothing, so the failure stands.
                if (e.code != NVML_ERROR_NOT_SUPPORTED
                        or self._backend.compute_mode(gpu.index)
                        != NVML_COMPUTEMODE_DEFAULT):
                    raise

    def reset(self, gpus: List[Gpu]) -> None:
        self.set_timeslice(gpus, apitypes.TimeSlicingConfig("Default"))


def mps_deployment_name(claim_uid: str) -> str:
    return f"gpu-mps-{claim_uid[:13]}"


class MpsControlDaemon:
    """The MPS control daemon of one claim: its directory (pipe/ and
    log/) and the Deployment that runs it on this node."""

    def __init__(self, claim_uid: str, gpus: List[Gpu],
                 config: apitypes.MpsConfig, *, node_name: str,
                 namespace: str, root_dir: str, client: ApiClient,
                 image: str):
        self._claim_uid = claim_uid
        self._gpus = sorted(gpus, key=lambda g: g.index)
        self._config = config
        self._node_name = node_name
        self._namespace = namespace
        self._dir = os.path.join(root_dir, claim_uid)
        self._client = client
        self._image = image
        self._name = mps_deployment_name(claim_uid)

    @property
    def deployment_name(self) -> str:
        return self._name

    @property
    def host_dir(self) -> str:
        return self._dir

    def limits(self) -> Dict[str, int]:
        """Pinned device-memory limit per GPU (bytes by UUID): the one
        source the daemon's env and the tenants' env are rendered from."""
        uuids = [g.uuid for g in self._gpus]
        indices = {g.uuid: g.index for g in self._gpus}
        cfg = self._config
        if cfg.per_device_pinned_memory_limit is not None:
            return cfg.per_device_pinned_memory_limit.normalize(
                uuids, indices, cfg.default_pinned_device_memory_limit)
        if cfg.default_pinned_device_memory_limit is not None:
            return {u: Quantity(cfg.default_pinned_device_memory_limit).value
                    for u in uuids}
        return {}

    def limits_env(self) -> Dict[str, str]:
        """The CUDA_MPS_* env of the limits. CUDA numbers the pinned
        limits by device ordinal, which is the GPU's place in the claim's
        CUDA_VISIBLE_DEVICES (index order), in whole MiB."""
        env: Dict[str, str] = {}
        pct = self._config.default_active_thread_percentage
        if pct is not None:
            env[ENV_MPS_THREADS] = str(pct)
        limits = self.limits()
        if limits:
            env[ENV_MPS_PINNED] = ",".join(
                f"{i}={limits[g.uuid] >> 20}M"
                for i, g in enumerate(self._gpus) if g.uuid in limits)
        return env

    def _container_env(self) -> List[Dict[str, str]]:
        env = {
            "CUDA_VISIBLE_DEVICES": ",".join(g.uuid for g in self._gpus),
            ENV_MPS_PIPE: f"{MPS_CONTAINER_DIR}/pipe",
            ENV_MPS_LOG: f"{MPS_CONTAINER_DIR}/log",
            **self.limits_env(),
        }
        return [{"name": k, "value": v} for k, v in sorted(env.items())]

    def deployment(self) -> Dict:
        labels = {"app.kubernetes.io/name": MPS_APP_LABEL,
                  MPS_CLAIM_LABEL: self._claim_uid}
        probe = {"exec": {"command": ["sh", "-c", MPS_PROBE]}}
        return {
            "apiVersion": "apps/v1",
            "kind": "Deployment",
            "metadata": new_object_meta(self._name, self._namespace,
                                        labels=labels),
            "spec": {
                "replicas": 1,
                "selector": {"matchLabels": {
                    MPS_CLAIM_LABEL: self._claim_uid}},
                "template": {
                    "metadata": {"labels": dict(labels)},
                    "spec": {
                        "nodeName": self._node_name,
                        "containers": [{
                            "name": "mps-control-daemon",
                            "image": self._image,
                            # Foreground: the pod's process is the daemon.
                            "command": [MPS_CONTROL, "-f"],
                            "env": self._container_env(),
                            "startupProbe": {**probe,
                                             "initialDelaySeconds": 1,
                                             "periodSeconds": 1,
                                             "failureThreshold": 30},
                            "readinessProbe": {**probe, "periodSeconds": 5},
                            # The daemon stops its MPS server on quit.
                            "lifecycle": {"preStop": {"exec": {
                                "command": ["sh", "-c", MPS_QUIT]}}},
                            "volumeMounts": [
                                {"name": "mps", "mountPath": MPS_CONTAINER_DIR},
                                {"name": "shm", "mountPath": "/dev/shm"},
                            ],
                        }],
                        "volumes": [
                            {"name": "mps",
                             "hostPath": {"path": self._dir,
                                          "type": "DirectoryOrCreate"}},
                            {"name": "shm",
                             "emptyDir": {"medium": "Memory",
                                          "sizeLimit": "64Mi"}},
                        ],
                    },
                },
            },
        }

    def start(self) -> None:
        """The claim's directory and its Deployment (idempotent)."""
        os.makedirs(os.path.join(self._dir, "pipe"), exist_ok=True)
        os.makedirs(os.path.join(self._dir, "log"), exist_ok=True)
        try:
            self._client.create(DEPLOYMENTS, self.deployment())
        except (AlreadyExistsError, ConflictError):
            pass  # a re-prepare after a crashed attempt

    def assert_ready(self, timeout: float = 30.0,
                     interval: float = 0.05) -> None:
        """Block until the Deployment reports a ready replica."""
        deadline = time.monotonic() + timeout
        while True:
            try:
                dep = self._client.get(DEPLOYMENTS, self._name,
                                       self._namespace)
            except NotFoundError:
                dep = None
            if dep and (dep.get("status") or {}).get("readyReplicas", 0) >= 1:
                return
            if time.monotonic() >= deadline:
                raise TimeoutError(f"MPS control daemon {self._name} not "
                                   f"ready within {timeout}s")
            time.sleep(interval)

    def cdi_edits(self) -> Dict:
        """The tenants' edits: the claim's directory mounted at
        MPS_CONTAINER_DIR, the pipe directory and the limits as env."""
        env = {ENV_MPS_PIPE: f"{MPS_CONTAINER_DIR}/pipe",
               **self.limits_env()}
        mounts = [{"hostPath": self._dir, "containerPath": MPS_CONTAINER_DIR,
                   "options": ["rw", "nosuid", "nodev", "bind"]}]
        return {"env": env, "mounts": mounts}

    def stop(self) -> None:
        """Delete the Deployment and the claim's directory (idempotent: a
        prepare that failed before its Deployment was made unwinds here
        too)."""
        try:
            self._client.delete(DEPLOYMENTS, self._name, self._namespace)
        except NotFoundError:
            pass
        shutil.rmtree(self._dir, ignore_errors=True)


class MpsManager:
    """Per-claim MPS control daemons on this node."""

    def __init__(self, backend: GpuInfoBackend, client: ApiClient, *,
                 node_name: str, namespace: str, root_dir: str,
                 image: str = "gpu-dra-driver:latest",
                 ready_timeout: float = 30.0):
        self._backend = backend
        self._client = client
        self._node_name = node_name
        self._namespace = namespace
        self._root_dir = root_dir
        self._image = image
        self._ready_timeout = ready_timeout

    def daemon(self, claim_uid: str, gpus: List[Gpu],
               config: apitypes.MpsConfig) -> MpsControlDaemon:
        return MpsControlDaemon(
            claim_uid, gpus, config, node_name=self._node_name,
            namespace=self._namespace, root_dir=self._root_dir,
            client=self._client, image=self._image)

    def start(self, claim_uid: str, gpus: List[Gpu],
              config: apitypes.MpsConfig,
              ready_timeout: Optional[float] = None) -> MpsControlDaemon:
        # Only the MPS server may open a context on the claim's GPUs.
        for gpu in gpus:
            self._backend.set_exclusive_mode(gpu.index, True)
        d = self.daemon(claim_uid, gpus, config)
        d.start()
        d.assert_ready(timeout=ready_timeout if ready_timeout is not None
                       else self._ready_timeout)
        return d

    def stop(self, claim_uid: str, gpus: List[Gpu]) -> None:
        """Delete the claim's Deployment and directory, then clear
        exclusive mode. A GPU whose mode cannot be cleared is logged, not
        raised: the GPU may be gone."""
        self.daemon(claim_uid, gpus, apitypes.MpsConfig()).stop()
        for gpu in gpus:
            try:
                self._backend.set_exclusive_mode(gpu.index, False)
            except Exception as e:  # noqa: BLE001 — the GPU may be gone
                log.warning("clearing exclusive mode on GPU %d failed: %s",
                            gpu.index, e)

    def claim_deployments(self) -> Dict[str, List[str]]:
        """Claim UID -> the GPU UUIDs its daemon serves, for every MPS
        Deployment of this node (startup reconciliation)."""
        deps = self._client.list(
            DEPLOYMENTS, self._namespace,
            label_selector=f"app.kubernetes.io/name={MPS_APP_LABEL}")
        out: Dict[str, List[str]] = {}
        for d in deps:
            pod = d["spec"]["template"]["spec"]
            if pod.get("nodeName") != self._node_name:
                continue
            env = {e["name"]: e["value"]
                   for e in pod["containers"][0].get("env", [])}
            uid = (d["metadata"].get("labels") or {}).get(MPS_CLAIM_LABEL)
            if uid:
                out[uid] = [u for u in env.get("CUDA_VISIBLE_DEVICES",
                                               "").split(",") if u]
        return out
