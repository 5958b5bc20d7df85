"""CDI spec generation for NVIDIA GPUs (counterpart of
tpu_dra/cdi/handler.py).

Two kinds of spec go into the CDI root (host /var/run/cdi) for the
container runtime to apply:

- one "standard" per-node spec (class ``gpu``): one CDI device per GPU
  with its ``/dev/nvidiaN`` node, and spec-wide edits that every
  container using any GPU needs — the ``/dev/nvidiactl``,
  ``/dev/nvidia-uvm`` and ``/dev/nvidia-uvm-tools`` nodes and read-only
  mounts of the host driver's user-space libraries (``libcuda``,
  ``libnvidia-ml``), found under a configurable driver root;
- one transient per-claim spec (class ``claim``) with the claim-scoped
  env: the GPUs' UUIDs in ``CUDA_VISIBLE_DEVICES`` and
  ``NVIDIA_VISIBLE_DEVICES`` (a UUID names the right device whatever
  index order the container sees), the fabric coordinates
  (``topology.meshexport``) and the sharing strategy.

Claim specs are rendered through a per-shape template cache whose output
is byte-identical to the direct serialization, and every spec is written
tmp-file + rename through the vfs seam.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

from tpu_dra_torch.infra import vfs
from tpu_dra_torch.infra.faults import FAULTS
from tpu_dra_torch.native.gpuinfo import Gpu
from tpu_dra_torch.topology.meshexport import (
    ENV_CUDA_VISIBLE, ENV_NVIDIA_VISIBLE, ENV_VISIBLE_INDICES,
)

CDI_VERSION = "0.5.0"
CDI_VENDOR = "k8s.gpu.dev"
CDI_CLASS_GPU = "gpu"
CDI_CLASS_CLAIM = "claim"
# Device nodes every CUDA process opens besides its GPU's /dev/nvidiaN.
CONTROL_DEVICE_NODES = ("/dev/nvidiactl", "/dev/nvidia-uvm",
                        "/dev/nvidia-uvm-tools")
# The driver's user-space libraries a CUDA container needs, and where a
# host keeps them (relative to the driver root).
DRIVER_LIBRARIES = ("libcuda.so.1", "libnvidia-ml.so.1",
                    "libnvidia-ptxjitcompiler.so.1")
DRIVER_LIBRARY_DIRS = ("usr/lib/x86_64-linux-gnu", "usr/lib64", "usr/lib",
                       "lib/x86_64-linux-gnu", "lib64")


class CDIHandler:
    """Writes CDI specs to `cdi_root` (host /var/run/cdi)."""

    def __init__(self, cdi_root: str, driver_root: str = "/",
                 driver_libraries: Optional[Sequence[str]] = None,
                 dev_root: str = "/", vendor: str = CDI_VENDOR):
        self._vendor = vendor
        self._cdi_root = cdi_root
        self._driver_root = driver_root.rstrip("/") or "/"
        self._dev_root = dev_root.rstrip("/") or "/"
        self._driver_libraries = (list(driver_libraries)
                                  if driver_libraries is not None
                                  else self._find_driver_libraries())
        # Claim-spec template cache: serialized scaffold per claim SHAPE
        # (mounts + deviceNodes content — everything except env values
        # and the uid), spliced per claim. See serialize_claim_spec.
        self._claim_tpl_cache: Dict = {}
        os.makedirs(cdi_root, exist_ok=True)

    def _find_driver_libraries(self) -> List[str]:
        """Host paths of the driver libraries under the driver root, the
        first directory holding each one."""
        found = []
        for name in DRIVER_LIBRARIES:
            for d in DRIVER_LIBRARY_DIRS:
                path = os.path.join(self._driver_root, d, name)
                if os.path.exists(path):
                    found.append(path)
                    break
        return found

    def _container_path(self, host_path: str) -> str:
        rel = os.path.relpath(host_path, self._driver_root)
        return "/" + rel if not rel.startswith("..") else host_path

    # -- spec paths ---------------------------------------------------------

    def _standard_spec_path(self) -> str:
        return os.path.join(self._cdi_root,
                            f"{self._vendor}-{CDI_CLASS_GPU}.json")

    def _claim_spec_path(self, claim_uid: str) -> str:
        return os.path.join(self._cdi_root,
                            f"{self._vendor}-{CDI_CLASS_CLAIM}_{claim_uid}.json")

    def standard_spec_path(self) -> str:
        return self._standard_spec_path()

    # -- device ids ---------------------------------------------------------

    def get_standard_device(self, gpu_uuid: str) -> str:
        """Fully-qualified CDI id for a GPU."""
        return f"{self._vendor}/{CDI_CLASS_GPU}={gpu_uuid}"

    def get_claim_device(self, claim_uid: str) -> str:
        return f"{self._vendor}/{CDI_CLASS_CLAIM}={claim_uid}"

    # -- spec generation ----------------------------------------------------

    def _device_node(self, path: str) -> Dict[str, str]:
        return {"path": path,
                "hostPath": os.path.join(self._dev_root, path.lstrip("/"))}

    def create_standard_device_spec_file(self, gpus: List[Gpu]) -> str:
        """Per-node spec: one CDI device per GPU with its /dev/nvidiaN
        node, plus the control nodes and driver-library mounts every GPU
        container needs."""
        devices = []
        for gpu in gpus:
            edits: Dict = {
                "deviceNodes": [self._device_node(gpu.dev_path)],
                "env": [f"GPU_{gpu.index}_UUID={gpu.uuid}"],
            }
            devices.append({"name": gpu.uuid, "containerEdits": edits})

        container_edits: Dict = {
            "deviceNodes": [self._device_node(p)
                            for p in CONTROL_DEVICE_NODES],
        }
        if self._driver_libraries:
            container_edits["mounts"] = [{
                "hostPath": path,
                "containerPath": self._container_path(path),
                "options": ["ro", "nosuid", "nodev", "bind"],
            } for path in self._driver_libraries]

        spec = {
            "cdiVersion": CDI_VERSION,
            "kind": f"{self._vendor}/{CDI_CLASS_GPU}",
            "devices": devices,
            "containerEdits": container_edits,
        }
        path = self._standard_spec_path()
        _atomic_write_json(path, spec)
        return path

    # Sentinels the template builder serializes in place of the dynamic
    # fields. json.dumps renders each NUL as a six-char unicode escape, so the
    # tokens cannot collide with any real uid or env value.
    _ENV_SENTINEL = "\x00env\x00"
    _UID_SENTINEL = "\x00uid\x00"
    _TPL_CACHE_MAX = 64

    def _build_claim_template(self, mounts, device_nodes):
        """Serialize the claim-shape's static scaffold once with
        sentinel env/uid, then split it into splice parts. Byte-layout
        source of truth stays json.dumps(indent=2, sort_keys=True) —
        the template is DERIVED from it, never hand-formatted, so the
        cached render is byte-identical to the direct path."""
        text = self._serialize_claim_spec_direct(
            self._UID_SENTINEL, {"": self._ENV_SENTINEL[1:]},
            mounts, device_nodes)
        env_tok = json.dumps(f"={self._ENV_SENTINEL[1:]}")
        uid_tok = json.dumps(self._UID_SENTINEL)
        i = text.index(env_tok)
        j = text.index(uid_tok)
        nl = text.rindex("\n", 0, i)
        # (prefix incl. the env-open newline, per-item indent, middle
        # between env's last item and the uid, suffix after the uid)
        return (text[:nl + 1], text[nl + 1:i],
                text[i + len(env_tok):j], text[j + len(uid_tok):])

    def _claim_template(self, mounts, device_nodes):
        key = (json.dumps(mounts, sort_keys=True) if mounts else None,
               json.dumps(device_nodes, sort_keys=True)
               if device_nodes else None)
        tpl = self._claim_tpl_cache.get(key)
        if tpl is None:
            tpl = self._build_claim_template(mounts, device_nodes)
            if len(self._claim_tpl_cache) >= self._TPL_CACHE_MAX:
                self._claim_tpl_cache.pop(
                    next(iter(self._claim_tpl_cache)))
            self._claim_tpl_cache[key] = tpl
        return tpl

    def _serialize_claim_spec_direct(self, claim_uid: str,
                                     env: Dict[str, str],
                                     mounts: Optional[List[Dict]] = None,
                                     device_nodes: Optional[List[Dict]]
                                     = None) -> str:
        """Uncached reference serialization (template builder input,
        empty-env shapes, and the byte-identity test oracle)."""
        edits: Dict = {"env": [f"{k}={v}" for k, v in sorted(env.items())]}
        if mounts:
            edits["mounts"] = mounts
        if device_nodes:
            edits["deviceNodes"] = device_nodes
        spec = {
            "cdiVersion": CDI_VERSION,
            "kind": f"{self._vendor}/{CDI_CLASS_CLAIM}",
            "devices": [{"name": claim_uid, "containerEdits": edits}],
        }
        return json.dumps(spec, indent=2, sort_keys=True)

    def serialize_claim_spec(self, claim_uid: str,
                             env: Dict[str, str],
                             mounts: Optional[List[Dict]] = None,
                             device_nodes: Optional[List[Dict]] = None):
        """(path, text) of the transient per-claim spec — the CPU half
        of create_claim_spec_file, split out so an async writer can run
        the pure-I/O half off-thread.

        Hot path: the shape scaffold (everything but env values and the
        uid) is serialized once per (mounts, deviceNodes) content and
        cached; per claim only the env lines and uid are spliced in.
        The cache key IS the canonical serialization of the shape
        content, so any mount/device-node change is a different key, and
        env changes never touch the template at all."""
        # Injection site: a failed claim-spec write is the canonical
        # mid-prepare failure (full disk, ENOSPC on /var/run/cdi) —
        # the prepare rollback path must unwind cleanly from here.
        FAULTS.check("cdi.claim_write", claim_uid=claim_uid)
        path = self._claim_spec_path(claim_uid)
        if not env:
            # "env": [] collapses to one line — a different scaffold
            # shape; rare enough to serialize directly.
            return path, self._serialize_claim_spec_direct(
                claim_uid, env, mounts, device_nodes)
        pre, indent, mid, post = self._claim_template(mounts, device_nodes)
        env_lines = ",\n".join(
            indent + json.dumps(f"{k}={v}")
            for k, v in sorted(env.items()))
        return path, (pre + env_lines + mid
                      + json.dumps(claim_uid) + post)

    def write_claim_spec(self, path: str, text: str) -> None:
        """The I/O half: tmp write + rename through the vfs seam (see
        _atomic_write_json for why both are crash points)."""
        tmp = path + ".tmp"
        vfs.write_text(tmp, text)
        vfs.replace(tmp, path)

    def create_claim_spec_file(self, claim_uid: str,
                               env: Dict[str, str],
                               mounts: Optional[List[Dict]] = None,
                               device_nodes: Optional[List[Dict]] = None) -> str:
        """Transient per-claim spec carrying claim-scoped edits."""
        path, text = self.serialize_claim_spec(
            claim_uid, env, mounts=mounts, device_nodes=device_nodes)
        self.write_claim_spec(path, text)
        return path

    def claim_spec_path(self, claim_uid: str) -> str:
        """Public path accessor: harnesses read the claim env back from
        the spec exactly the way a container runtime would."""
        return self._claim_spec_path(claim_uid)

    def claim_spec_exists(self, claim_uid: str) -> bool:
        """Idempotency guard for the prepare fast path: a crash can lose
        the spec's (never-synced) rename while the checkpoint already
        shows PrepareCompleted; the fast path must re-apply, not vouch
        for a file that is gone."""
        return os.path.exists(self._claim_spec_path(claim_uid))

    def list_claim_uids(self) -> List[str]:
        """UIDs of all transient per-claim specs currently on disk (startup
        orphan GC: a crash between a prepare's CDI write and its checkpoint
        store leaves a spec for a claim the checkpoint never learned of)."""
        prefix = f"{self._vendor}-{CDI_CLASS_CLAIM}_"
        try:
            names = os.listdir(self._cdi_root)
        except FileNotFoundError:
            return []
        return [n[len(prefix):-len(".json")] for n in names
                if n.startswith(prefix) and n.endswith(".json")]

    def delete_claim_spec_file(self, claim_uid: str) -> None:
        try:
            vfs.unlink(self._claim_spec_path(claim_uid))
        except FileNotFoundError:
            pass

    def read_spec(self, path: str) -> Dict:
        with open(path) as f:
            return json.load(f)

    def container_edits(self, cdi_ids: Sequence[str]) -> Dict:
        """What a container runtime applies for `cdi_ids` (the ids a
        prepared claim hands kubelet): the env, device nodes and mounts
        of each named device in this CDI root plus its spec's spec-wide
        edits, merged in id order. Env is a dict (a later id's value for
        a name wins); nodes and mounts are deduplicated by path."""
        specs: Dict[str, Dict] = {}
        env: Dict[str, str] = {}
        nodes: List[Dict] = []
        mounts: List[Dict] = []

        def merge(edits: Dict) -> None:
            for item in edits.get("env") or []:
                name, _, value = item.partition("=")
                env[name] = value
            for node in edits.get("deviceNodes") or []:
                if all(n["path"] != node["path"] for n in nodes):
                    nodes.append(node)
            for m in edits.get("mounts") or []:
                if all(x["containerPath"] != m["containerPath"]
                       for x in mounts):
                    mounts.append(m)

        for cdi_id in cdi_ids:
            kind, _, name = cdi_id.partition("=")
            vendor, _, cls = kind.partition("/")
            path = (self._standard_spec_path() if cls == CDI_CLASS_GPU
                    else self._claim_spec_path(name))
            if path not in specs:
                specs[path] = self.read_spec(path)
                merge(specs[path].get("containerEdits") or {})
            device = next((d for d in specs[path]["devices"]
                           if d["name"] == name), None)
            if device is None:
                raise KeyError(f"CDI device {cdi_id} is not in {path}")
            merge(device["containerEdits"])
        return {"env": env, "deviceNodes": nodes, "mounts": mounts}


def _atomic_write_json(path: str, doc: Dict) -> None:
    # Through the vfs seam: a CDI spec write is part of the durability
    # contract (orphan GC reconciles a spec whose claim never committed),
    # so a crash enumerator must see both the tmp write and the rename as
    # distinct crash points.
    tmp = path + ".tmp"
    vfs.write_text(tmp, json.dumps(doc, indent=2, sort_keys=True))
    vfs.replace(tmp, path)


def visible_gpus_env(gpus: List[Gpu]) -> Dict[str, str]:
    """The GPU selection env of a claim: the GPUs' UUIDs in index order
    for CUDA and the container toolkit, and their node indices, which
    key the exported coordinates (meshexport)."""
    ordered = sorted(gpus, key=lambda g: g.index)
    uuids = ",".join(g.uuid for g in ordered)
    return {
        ENV_CUDA_VISIBLE: uuids,
        ENV_NVIDIA_VISIBLE: uuids,
        ENV_VISIBLE_INDICES: ",".join(str(g.index) for g in ordered),
    }
