"""NodeSim: the kubelet + containerd analog for one simulated node
(counterpart of tpu_dra/simcluster/nodesim.py).

For every pod bound to this node it does what kubelet does, with the real
driver in the loop:

1. waits until every pod claim is allocated,
2. calls NodePrepareResources on the REAL plugin's ``dra.sock`` for each
   driver named in the allocation results (gRPC where ``grpc`` imports,
   as kubelet does; else the plugin's framed ``dra-fast.sock``),
3. resolves the returned CDI device ids against the REAL CDI spec files
   the plugin wrote under this node's CDI root and applies their env
   edits (containerd's CDI injection analog),
4. launches each container's command as a subprocess (image ignored —
   the sim's containers share the host interpreter),
5. runs startup/readiness/liveness probes (exec + httpGet) and mirrors
   them into pod conditions,
6. on pod deletion: SIGTERM, NodeUnprepareResources, status cleanup.

A container sees exactly the GPUs its claims' CDI env names: that env
sets ``CUDA_VISIBLE_DEVICES``, and a container that no claim gives a GPU
gets ``CUDA_VISIBLE_DEVICES=""`` (the sim's "no /dev/nvidia* in the
container"). A privileged container (the kubelet plugins) sees every GPU
of the host, as a privileged pod sees every device node. Every container
gets the node's inventory env (``inventory_env``): the fake backend and
this node's inventory file on a simulated node, nothing on a node the
sim puts on the card's host, whose plugin reads NVML.

Driver DaemonSet pods (the plugins themselves) are launched the same way
from the same manifests the chart renders — they are just pods whose
commands happen to be ``python -m tpu_dra_torch...``. Each pod gets a
``TMPDIR`` of its own (a container's /tmp is its own), so a stack dump
(``infra/debug.py``) lands in ``<node>/pods/<uid>/tmp``. On a node given
``mps_binary`` (a simulated node: its GPUs are fake, so NVIDIA's MPS
daemon cannot serve them) that argv stands for
``nvidia-cuda-mps-control`` in commands and probes, as
``testing.MpsNodeSim`` substitutes it.
"""

from __future__ import annotations

import base64
import hashlib
import json
import logging
import os
import shlex
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from typing import Dict, List, Optional, Tuple

from tpu_dra_torch.k8s.client import ApiClient, ApiError, NotFoundError
from tpu_dra_torch.native.gpuinfo import EVENTS_ENV, INVENTORY_ENV
from tpu_dra_torch.k8s.resources import PODS, RESOURCECLAIMS, SECRETS, SERVICES
from tpu_dra_torch.gpuplugin.sharing import MPS_CONTROL
from tpu_dra_torch.simcluster.admission import ENDPOINT_ANNOTATION

log = logging.getLogger("simcluster.nodesim")

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DOMAIN_DAEMON_MODULE = "tpu_dra_torch.cddaemon.main"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _RunningPod:
    def __init__(self, uid: str):
        self.uid = uid
        self.procs: List[subprocess.Popen] = []
        self.claim_refs: List[Tuple[str, str, str]] = []  # (uid, name, ns)
        self.prepared_drivers: List[str] = []
        self.ready = False
        self.next_probe = 0.0
        self.logs_dir = ""
        self.restart_at: Optional[float] = None
        self.links: List[str] = []  # short symlinks for CDI mounts


class NodeSim:
    def __init__(self, client: ApiClient, node_name: str, node_dir: str,
                 *, api_url: str, interval: float = 0.2,
                 inventory_env: Optional[Dict[str, str]] = None,
                 mps_binary: Optional[List[str]] = None):
        self._client = client
        self._mps_binary = list(mps_binary or [])
        self._inventory_env = dict(inventory_env or {})
        self._node = node_name
        self._dir = node_dir          # <node_dir>/fs is the node's "/"
        self._api_url = api_url
        self._interval = interval
        self._running: Dict[str, _RunningPod] = {}
        # Pods whose claims are being prepared, each on a worker thread of
        # its own (kubelet's pod workers): a prepare that waits (a
        # ComputeDomain channel retries until its domain is Ready) must
        # not hold up the node's other pods, among them the domain's
        # daemon that it waits for.
        self._starting: Dict[str, threading.Thread] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def hostfs(self) -> str:
        return os.path.join(self._dir, "fs")

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"nodesim-{self._node}")
        self._thread.start()

    # How long stop() waits for a pod worker's prepare to return.
    STOP_PREPARE_WAIT_S = 75.0

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=10)
        for t in list(self._starting.values()):
            t.join(timeout=self.STOP_PREPARE_WAIT_S)
        for rp in self._running.values():
            self._terminate(rp)

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self.reconcile_once()
            except Exception:  # noqa: BLE001
                log.exception("nodesim %s reconcile failed", self._node)

    # ------------------------------------------------------------------

    def reconcile_once(self) -> None:
        pods = {p["metadata"]["uid"]: p for p in self._client.list(PODS)
                if p["spec"].get("nodeName") == self._node}
        # Reap pods whose object vanished or is terminating.
        for uid in list(self._running):
            pod = pods.get(uid)
            if pod is None or pod["metadata"].get("deletionTimestamp"):
                self._teardown(self._running.pop(uid))
        for uid, pod in pods.items():
            if pod["metadata"].get("deletionTimestamp"):
                continue
            rp = self._running.get(uid)
            if rp is None:
                phase = (pod.get("status") or {}).get("phase", "Pending")
                if phase in ("", "Pending") and uid not in self._starting:
                    worker = threading.Thread(
                        target=self._start_worker, args=(pod,), daemon=True,
                        name=f"nodesim-{self._node}-{uid[:12]}")
                    self._starting[uid] = worker
                    worker.start()
            else:
                self._update_running(pod, rp)

    def _start_worker(self, pod: Dict) -> None:
        try:
            self._maybe_start(pod)
        except Exception:  # noqa: BLE001 — the next reconcile retries
            log.exception("nodesim %s: starting pod %s failed", self._node,
                          pod["metadata"]["name"])
        finally:
            self._starting.pop(pod["metadata"]["uid"], None)

    # -- startup --------------------------------------------------------

    def _maybe_start(self, pod: Dict) -> None:
        ns = pod["metadata"].get("namespace", "default")
        uid = pod["metadata"]["uid"]
        claims = self._resolve_claims(pod, ns)
        if claims is None:
            return  # not all allocated yet
        rp = _RunningPod(uid)
        rp.logs_dir = os.path.join(self._dir, "pods", uid, "logs")
        os.makedirs(rp.logs_dir, exist_ok=True)
        # Per-pod-claim CDI edits, applied per CONTAINER below by each
        # container's resources.claims — kubelet/containerd semantics: a
        # container only receives the CDI devices of the claims it
        # references, so two containers sharing a pod can see different
        # MIG env from the same GPU (the gpu-test6 shape).
        edits: Dict[str, Tuple[Dict[str, str], List[Tuple[str, str]]]] = {}
        try:
            for entry_name, claim in claims:
                rp.claim_refs.append((claim["metadata"]["uid"],
                                      claim["metadata"]["name"], ns))
                ids = self._prepare_claim(claim, rp)
                env_part, mounts_part = self._cdi_edits(ids)
                linked: List[Tuple[str, str]] = []
                # Short symlinks for mount targets: a rewritten AF_UNIX
                # socket path (coordinator pipe) must stay <= 107 chars.
                digest = hashlib.sha1(uid.encode()).hexdigest()[:10]
                for cpath, hpath in mounts_part:
                    link = os.path.join(self._dir,
                                        f"m-{digest}-{len(rp.links)}")
                    if os.path.islink(link):
                        os.unlink(link)
                    os.symlink(hpath, link)
                    rp.links.append(link)
                    linked.append((cpath, link))
                edits[entry_name] = (env_part, linked)
        except Exception as e:  # noqa: BLE001
            # kubelet semantics: a failed prepare is retried on the next
            # sync, NOT unprepared — prepare is idempotent, and the CD
            # channel path deliberately fails-and-retries until the domain
            # reports Ready (cd device_state.go:456-504).
            log.warning("pod %s/%s prepare failed (will retry): %s", ns,
                        pod["metadata"]["name"], e)
            self._set_status(pod, phase="Pending", ready=False,
                             message=f"prepare failed: {e}")
            return
        if self._stop.is_set():
            self._unprepare_all(rp)
            return
        try:
            for ctr in pod["spec"].get("containers") or []:
                names = [c.get("name") for c in
                         (ctr.get("resources") or {}).get("claims") or []]
                ctr_env: Dict[str, str] = {}
                ctr_mounts: List[Tuple[str, str]] = []
                for n in names:
                    env_part, mounts_part = edits.get(n, ({}, []))
                    ctr_env.update(env_part)
                    ctr_mounts.extend(mounts_part)
                rp.procs.append(self._launch(pod, ctr, ctr_env, rp,
                                             cdi_mounts=ctr_mounts))
        except Exception as e:  # noqa: BLE001
            log.warning("pod %s/%s launch failed: %s", ns,
                        pod["metadata"]["name"], e)
            self._terminate(rp)
            self._set_status(pod, phase="Failed", ready=False,
                             message=str(e))
            return
        # Running is written before the reconcile loop can see the pod:
        # a container that exits at once is then reaped (Succeeded)
        # after it, never overwritten by it.
        self._set_status(pod, phase="Running", ready=False,
                         pids=self._pids(rp))
        self._running[uid] = rp
        self._publish_endpoints(pod, rp)

    def _publish_endpoints(self, pod: Dict, rp: _RunningPod) -> None:
        """Endpoints-controller analog: annotate Services selecting this
        pod with the pod's actual (port-remapped) endpoint so the sim's
        admission chain can dial registered webhooks."""
        ns = pod["metadata"].get("namespace", "default")
        labels = pod["metadata"].get("labels") or {}
        try:
            services = self._client.list(SERVICES, namespace=ns)
        except ApiError:
            return
        for svc in services:
            selector = (svc.get("spec") or {}).get("selector") or {}
            if not selector or not all(labels.get(k) == v
                                       for k, v in selector.items()):
                continue
            ports = (svc["spec"].get("ports") or [{}])
            target = str(ports[0].get("targetPort", ports[0].get("port", "")))
            # Scheme and port must come from the SAME container — the one
            # actually serving the target port (a TLS webhook container
            # must not force https onto a sibling's plain-HTTP port).
            serving = None
            for proc in rp.procs:
                ctr = getattr(proc, "_ctr", {}) or {}
                ctr_ports = {str(p.get("containerPort", ""))
                             for p in ctr.get("ports") or []}
                if target in ctr_ports or \
                        target in getattr(proc, "_port_map", {}):
                    serving = proc
                    break
            serving = serving or (rp.procs[0] if rp.procs else None)
            if serving is None:
                continue
            env = getattr(serving, "_env", {}) or {}
            scheme = "https" if env.get("TLS_CERT_FILE") else "http"
            mapped = (getattr(serving, "_port_map", {}) or {}).get(
                target, target)
            endpoint = f"{scheme}://127.0.0.1:{mapped}"
            current = (svc["metadata"].get("annotations") or {}).get(
                ENDPOINT_ANNOTATION)
            if current == endpoint:
                continue  # already published: no RV churn
            try:
                self._client.patch(SERVICES, svc["metadata"]["name"],
                                   {"metadata": {"annotations": {
                                       ENDPOINT_ANNOTATION: endpoint}}},
                                   namespace=ns)
                log.info("service %s/%s -> %s", ns,
                         svc["metadata"]["name"], endpoint)
            except ApiError:
                pass

    def _resolve_claims(self, pod: Dict,
                        ns: str) -> Optional[List[Tuple[str, Dict]]]:
        """(pod-claim-entry name, claim) pairs — the entry name is what a
        container's resources.claims references."""
        statuses = {s["name"]: s["resourceClaimName"] for s in
                    ((pod.get("status") or {})
                     .get("resourceClaimStatuses") or [])}
        claims = []
        for entry in (pod["spec"].get("resourceClaims") or []):
            name = entry.get("resourceClaimName") or statuses.get(
                entry["name"])
            if not name:
                return None
            try:
                claim = self._client.get(RESOURCECLAIMS, name, ns)
            except NotFoundError:
                return None
            if not (claim.get("status") or {}).get("allocation"):
                return None
            claims.append((entry["name"], claim))
        return claims

    def _plugin_dir(self, driver: str) -> str:
        return os.path.join(self.hostfs, "var", "lib", "kubelet",
                            "plugins", driver)

    def _rpc(self, driver: str, method: str, request, timeout: float):
        """One DRA RPC to `driver`'s plugin on this node, over gRPC where
        it imports (kubelet's transport), else the framed socket."""
        from tpu_dra_torch.kubeletplugin.server import (
            framed_stubs, import_grpc, kubelet_stubs,
        )

        try:
            import_grpc()
        except RuntimeError:
            sock = os.path.join(self._plugin_dir(driver), "dra-fast.sock")
            if not os.path.exists(sock):
                raise RuntimeError(f"plugin socket missing: {sock}")
            client, prepare, unprepare = framed_stubs(sock,
                                                      timeout_s=timeout)
            try:
                return (prepare if method == "prepare" else
                        unprepare)(request)
            finally:
                client.close()
        sock = os.path.join(self._plugin_dir(driver), "dra.sock")
        if not os.path.exists(sock):
            raise RuntimeError(f"plugin socket missing: {sock}")
        channel, prepare, unprepare = kubelet_stubs(sock)
        try:
            return (prepare if method == "prepare" else unprepare)(
                request, timeout=timeout)
        finally:
            channel.close()

    def _prepare_claim(self, claim: Dict, rp: _RunningPod) -> List[str]:
        """kubelet's NodePrepareResources over the plugin's unix socket."""
        from tpu_dra_torch.kubeletplugin import wire

        alloc = claim["status"]["allocation"]
        drivers = sorted({r.get("driver", "") for r in
                          (alloc.get("devices") or {}).get("results") or []})
        uid = claim["metadata"]["uid"]
        req = wire.NodePrepareResourcesRequest(claims=[wire.Claim(
            uid=uid, name=claim["metadata"]["name"],
            namespace=claim["metadata"].get("namespace", "default"))])
        cdi_ids: List[str] = []
        for driver in drivers:
            resp = self._rpc(driver, "prepare", req, timeout=60)
            result = resp.claims.get(uid)
            if result is None or result.error:
                raise RuntimeError(
                    f"{driver} prepare: "
                    f"{result.error if result else 'no entry'}")
            for dev in result.devices:
                cdi_ids.extend(dev.cdi_device_ids)
            if driver not in rp.prepared_drivers:
                rp.prepared_drivers.append(driver)
        return cdi_ids

    def _cdi_edits(self, cdi_ids: List[str]
                   ) -> Tuple[Dict[str, str], List[Tuple[str, str]]]:
        """containerd's CDI resolution analog: map fully-qualified device
        ids to (env, mounts) edits from the spec files under this node's
        CDI root. Mounts come back as (containerPath, hostPath) pairs for
        the env-rewrite map — the sim cannot bind-mount, so paths that
        reference a mount are rewritten to the host location instead."""
        cdi_root = os.path.join(self.hostfs, "var", "run", "cdi")
        specs = []
        if os.path.isdir(cdi_root):
            for fn in sorted(os.listdir(cdi_root)):
                if fn.endswith(".json"):
                    with open(os.path.join(cdi_root, fn)) as f:
                        specs.append(json.load(f))
        env: Dict[str, str] = {}
        mounts: List[Tuple[str, str]] = []

        def apply(edits: Dict) -> None:
            for kv in (edits or {}).get("env") or []:
                k, _, v = kv.partition("=")
                env[k] = v
            for m in (edits or {}).get("mounts") or []:
                if m.get("containerPath") and m.get("hostPath"):
                    mounts.append((m["containerPath"], m["hostPath"]))

        for cdi_id in cdi_ids:
            kind, _, name = cdi_id.partition("=")
            for spec in specs:
                if spec.get("kind") != kind:
                    continue
                for dev in spec.get("devices") or []:
                    if dev.get("name") == name:
                        apply(spec.get("containerEdits") or {})
                        apply(dev.get("containerEdits") or {})
        return env, mounts

    # -- container launch ----------------------------------------------

    def _launch(self, pod: Dict, ctr: Dict, cdi_env: Dict[str, str],
                rp: _RunningPod,
                cdi_mounts: Optional[List[Tuple[str, str]]] = None
                ) -> subprocess.Popen:
        ns = pod["metadata"].get("namespace", "default")
        mounts = self._mount_map(pod, ctr, rp)
        mounts.extend(cdi_mounts or [])
        mounts.sort(key=lambda kv: -len(kv[0]))
        env = dict(os.environ)
        env.pop("CUDA_VISIBLE_DEVICES", None)  # the launching shell's
        env.pop(INVENTORY_ENV, None)
        env.pop(EVENTS_ENV, None)
        env.update({
            "PYTHONPATH": REPO,
            "KUBE_API_URL": self._api_url,   # in-cluster config analog
            **self._inventory_env,
        })
        # The containerization shim: paths that are pod-local in a real
        # cluster must be disambiguated per pod/node here, and a domain
        # daemon of each node must listen on a port of its own.
        env.setdefault("WORK_DIR",
                       os.path.join(self._dir, "pods", rp.uid, "work"))
        env["TMPDIR"] = os.path.join(self._dir, "pods", rp.uid, "tmp")
        os.makedirs(env["TMPDIR"], exist_ok=True)
        env.setdefault("HOSTS_FILE", os.path.join(self._dir, "hosts"))
        env.setdefault("DOMAIN_DAEMON_PORT", str(free_port()))
        for e in ctr.get("env") or []:
            value = e.get("value")
            if value is None and "valueFrom" in e:
                value = self._field_ref(pod, e["valueFrom"])
            if value is None:
                continue
            env[e["name"]] = self._rewrite_path(str(value), mounts)
        for k, v in cdi_env.items():
            env[k] = self._rewrite_path(v, mounts)
        privileged = bool((ctr.get("securityContext") or {}).get(
            "privileged"))
        if not privileged and "CUDA_VISIBLE_DEVICES" not in cdi_env:
            # No claim gave this container a GPU: it sees none.
            env["CUDA_VISIBLE_DEVICES"] = ""
        # Sim containers share one network namespace (the host), so fixed
        # listen ports from the manifest must be remapped per pod; probes
        # consult the same map.
        port_map: Dict[str, str] = {}
        for key in ("HEALTHCHECK_PORT", "WEBHOOK_PORT",
                    "HTTP_ENDPOINT_PORT"):
            if env.get(key, "0") not in ("", "0"):
                port_map[env[key]] = str(free_port())
                env[key] = port_map[env[key]]
        cmd = [self._rewrite_path(c, mounts) for c in
               list(ctr.get("command") or []) + list(ctr.get("args") or [])]
        if self._mps_binary and cmd[:1] == [MPS_CONTROL]:
            cmd[:1] = self._mps_binary
        if DOMAIN_DAEMON_MODULE in cmd and "DOMAIN_DAEMON_BINARY" not in env:
            # The native domain daemon, built from this checkout's source
            # at first use (cached by source hash).
            from tpu_dra_torch.cddaemon import binary
            env["DOMAIN_DAEMON_BINARY"] = str(binary.build())
        if not cmd:
            raise RuntimeError(
                f"container {ctr['name']} has no command (images are not "
                "runnable in the sim)")
        if cmd[0] == "python":
            cmd[0] = sys.executable
        out = open(os.path.join(rp.logs_dir, f"{ctr['name']}.log"), "ab")
        proc = subprocess.Popen(
            cmd, env=env, stdout=out, stderr=subprocess.STDOUT,
            cwd=os.path.join(self._dir, "pods", rp.uid))
        proc._ctr = ctr          # type: ignore[attr-defined]
        proc._logfile = out      # type: ignore[attr-defined]
        proc._env = env          # type: ignore[attr-defined]
        proc._port_map = port_map  # type: ignore[attr-defined]
        proc._mounts = mounts      # type: ignore[attr-defined]
        log.info("node %s: started %s/%s:%s (pid %d)", self._node, ns,
                 pod["metadata"]["name"], ctr["name"], proc.pid)
        return proc

    def _mps_substitute(self, text: str) -> str:
        """A shell line naming nvidia-cuda-mps-control, with the node's
        mps_binary in its place."""
        if not self._mps_binary:
            return text
        return text.replace(MPS_CONTROL, shlex.join(self._mps_binary))

    def _mount_map(self, pod: Dict, ctr: Dict,
                   rp: _RunningPod) -> List[Tuple[str, str]]:
        """containerPath -> hostPath mappings for env rewriting. hostPath
        volumes land under the node's hostfs; secret volumes are
        materialized from the Secret object."""
        vols = {v["name"]: v for v in pod["spec"].get("volumes") or []}
        out: List[Tuple[str, str]] = []
        for vm in ctr.get("volumeMounts") or []:
            vol = vols.get(vm["name"])
            if vol is None:
                continue
            if "hostPath" in vol:
                path = vol["hostPath"]["path"]
                # Objects created by components that already run inside the
                # sim on this node (the plugin's MPS daemon Deployment,
                # pinned to its node) carry hostPaths under the node's
                # dir; every other path, a real host's /var/run/cdi among
                # them, gets the hostfs prefix, so the sim never writes
                # outside its tree.
                host = (path if self._in_node_dir(path) else
                        os.path.join(self.hostfs, path.lstrip("/")))
                os.makedirs(host, exist_ok=True)
                out.append((vm["mountPath"], host))
            elif "secret" in vol:
                host = os.path.join(self._dir, "pods", rp.uid, "secrets",
                                    vm["name"])
                os.makedirs(host, exist_ok=True)
                try:
                    sec = self._client.get(
                        SECRETS, vol["secret"]["secretName"],
                        pod["metadata"].get("namespace", "default"))
                    for k, v in (sec.get("data") or {}).items():
                        with open(os.path.join(host, k), "wb") as f:
                            f.write(base64.b64decode(v))
                except (NotFoundError, ApiError):
                    pass
                out.append((vm["mountPath"], host))
        # Longest prefix first so nested mounts resolve correctly.
        out.sort(key=lambda kv: -len(kv[0]))
        return out

    def _in_node_dir(self, path: str) -> bool:
        root = os.path.realpath(self._dir)
        return os.path.commonpath([os.path.realpath(path), root]) == root

    @staticmethod
    def _rewrite_path(value: str, mounts: List[Tuple[str, str]]) -> str:
        for cpath, hpath in mounts:
            if value == cpath or value.startswith(cpath.rstrip("/") + "/"):
                return hpath + value[len(cpath.rstrip("/")):]
        return value

    def _field_ref(self, pod: Dict, value_from: Dict) -> Optional[str]:
        path = (value_from.get("fieldRef") or {}).get("fieldPath", "")
        return {
            "metadata.name": pod["metadata"]["name"],
            "metadata.namespace": pod["metadata"].get("namespace",
                                                      "default"),
            "metadata.uid": pod["metadata"].get("uid", ""),
            "spec.nodeName": self._node,
            "spec.serviceAccountName":
                pod["spec"].get("serviceAccountName", "default"),
            "status.podIP": "127.0.0.1",
        }.get(path)

    # -- running-pod upkeep ---------------------------------------------

    def _update_running(self, pod: Dict, rp: _RunningPod) -> None:
        rcs = [p.poll() for p in rp.procs]
        if all(rc is not None for rc in rcs):
            restart = pod["spec"].get("restartPolicy", "Always")
            failed = any(rc != 0 for rc in rcs)
            if restart == "Always" or (restart == "OnFailure" and failed):
                if rp.restart_at is None:
                    rp.restart_at = time.monotonic() + 1.0
                if time.monotonic() >= rp.restart_at:
                    rp.restart_at = None
                    for i, p in enumerate(rp.procs):
                        np_ = subprocess.Popen(
                            p.args, env=p._env,  # type: ignore
                            stdout=p._logfile,   # type: ignore
                            stderr=subprocess.STDOUT)
                        # Carry ALL sim bookkeeping across the restart —
                        # losing _port_map/_mounts would break probe-port
                        # resolution and endpoint publishing afterwards.
                        for attr in ("_ctr", "_logfile", "_env",
                                     "_port_map", "_mounts"):
                            setattr(np_, attr, getattr(p, attr, None))
                        rp.procs[i] = np_
                return
            del self._running[rp.uid]
            self._unprepare_all(rp)
            self._set_status(pod, phase="Failed" if failed else "Succeeded",
                             ready=False)
            return
        if time.monotonic() >= rp.next_probe:
            rp.next_probe = time.monotonic() + 2.0
            ready = all(self._probe_ok(p) for p in rp.procs)
            if ready != rp.ready:
                rp.ready = ready
                self._set_status(pod, phase="Running", ready=ready,
                                 pids=self._pids(rp))
            # Re-publish endpoints each probe tick: a Service created
            # after its backing pod started must still get annotated.
            self._publish_endpoints(pod, rp)

    @staticmethod
    def _pids(rp: _RunningPod) -> Dict[str, int]:
        return {p._ctr["name"]: p.pid  # type: ignore[attr-defined]
                for p in rp.procs if p.poll() is None}

    def _probe_ok(self, proc: subprocess.Popen) -> bool:
        ctr = proc._ctr  # type: ignore[attr-defined]
        probe = (ctr.get("startupProbe") or ctr.get("readinessProbe")
                 or ctr.get("livenessProbe"))
        if probe is None:
            return True
        if "exec" in probe:
            mounts = getattr(proc, "_mounts", [])
            cmd = [self._mps_substitute(self._rewrite_path(c, mounts))
                   for c in probe["exec"].get("command") or []]
            if cmd and cmd[0] == "python":
                cmd[0] = sys.executable
            try:
                return subprocess.run(
                    cmd, env=proc._env,  # type: ignore[attr-defined]
                    capture_output=True, timeout=10).returncode == 0
            except Exception:  # noqa: BLE001 # drflow: swallow-ok[probe failure IS the signal: returns not-ready]
                return False
        if "httpGet" in probe:
            hg = probe["httpGet"]
            port_map = getattr(proc, "_port_map", {})
            port = port_map.get(str(hg.get("port")), str(hg.get("port")))
            url = (f"{'https' if hg.get('scheme') == 'HTTPS' else 'http'}"
                   f"://127.0.0.1:{port}{hg.get('path', '/')}")
            try:
                import ssl
                ctx = ssl._create_unverified_context() \
                    if hg.get("scheme") == "HTTPS" else None
                urllib.request.urlopen(url, timeout=5, context=ctx)
                return True
            except Exception:  # noqa: BLE001 # drflow: swallow-ok[probe failure IS the signal: returns not-ready]
                return False
        return True

    # -- teardown -------------------------------------------------------

    def _terminate(self, rp: _RunningPod) -> None:
        for p in rp.procs:
            if p.poll() is None:
                try:
                    p.send_signal(signal.SIGTERM)
                except OSError:
                    pass
        deadline = time.monotonic() + 10
        for p in rp.procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()

    def _teardown(self, rp: _RunningPod) -> None:
        self._terminate(rp)
        self._unprepare_all(rp)

    def _unprepare_all(self, rp: _RunningPod) -> None:
        for driver in rp.prepared_drivers:
            self._unprepare(rp, driver)
        rp.prepared_drivers = []
        for link in rp.links:
            try:
                os.unlink(link)
            except OSError:
                pass
        rp.links = []

    def _unprepare(self, rp: _RunningPod, driver: str) -> None:
        from tpu_dra_torch.kubeletplugin import wire

        if not os.path.isdir(self._plugin_dir(driver)):
            return
        req = wire.NodeUnprepareResourcesRequest(claims=[
            wire.Claim(uid=uid, name=name, namespace=ns)
            for uid, name, ns in rp.claim_refs])
        try:
            resp = self._rpc(driver, "unprepare", req, timeout=30)
            errors = {u: r.error for u, r in resp.claims.items() if r.error}
            if errors:
                log.warning("unprepare via %s: %s", driver, errors)
        except Exception as e:  # noqa: BLE001
            log.warning("unprepare via %s failed: %s", driver, e)

    def _set_status(self, pod: Dict, *, phase: str, ready: bool,
                    message: str = "",
                    pids: Optional[Dict[str, int]] = None) -> None:
        ns = pod["metadata"].get("namespace", "default")
        try:
            fresh = self._client.get(PODS, pod["metadata"]["name"], ns)
        except NotFoundError:
            return
        if fresh["metadata"].get("uid") != pod["metadata"].get("uid"):
            # A pod of the same name made since (a DaemonSet's pod rolled
            # while this one's prepare was retrying): not ours to set.
            return
        status = fresh.setdefault("status", {})
        status["phase"] = phase
        status["podIP"] = "127.0.0.1"
        status["conditions"] = [{
            "type": "Ready",
            "status": "True" if ready else "False",
            **({"message": message} if message else {}),
        }]
        # containerID carries the sim process pid (`sim://<pid>`) — the
        # containerd://<hash> analog. The e2e debug suite resolves it to
        # deliver signals the way `kubectl exec kill` would on a real
        # cluster (tests/e2e/test_debug.sh; reference
        # tests/bats/test_basics.bats:89-100).
        status["containerStatuses"] = [
            {"name": c["name"], "ready": ready,
             "state": {"running": {}} if phase == "Running" else {},
             **({"containerID": f"sim://{pids[c['name']]}"}
                if pids and c["name"] in pids else {})}
            for c in fresh["spec"].get("containers") or []]
        try:
            self._client.update_status(PODS, fresh, ns)
        except ApiError:
            pass  # conflict: next tick rewrites
