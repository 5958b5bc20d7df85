"""SimCluster assembly + ``python -m tpu_dra_torch.simcluster`` server
mode (counterpart of tpu_dra/simcluster/cluster.py).

Each simulated node gets a directory (``<workdir>/<node>``) whose ``fs``
is the node's "/" (kubelet plugin dirs, CDI root) and its own fake GPU
inventory file (``gpuinfo.write_fake_inventory``): its plugin
subprocesses read that file through the fake backend, so every node has
GPUs of its own. With ``card_node=True`` node ``n0`` is the host this
runs on: its plugins read NVML (native backend) and prepare the host's
GPUs. Unlike the reference's, a node's inventory holds only its own
worker index and clique, so N nodes start for any N. Each fake node also
has a health-events file (``events_file(node)``, the reference's fake
``sys/class/accel/health_events``): a line ``"<gpu> <code> <kind>
<text>"`` appended to it reaches that node's plugin as a health event,
and its MPS control daemons run ``testing.MPS_STANDIN``.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import sys
import tempfile
import threading
from typing import Dict, List, Optional

from tpu_dra_torch.deploy.manifests import NODE_LABEL
from tpu_dra_torch.k8s.client import AlreadyExistsError, HttpApiClient
from tpu_dra_torch.k8s.fakeserver import FakeApiServer
from tpu_dra_torch.k8s.resources import NODES
from tpu_dra_torch.native.gpuinfo import (
    BACKEND_ENV, EVENTS_ENV, INVENTORY_ENV, write_fake_inventory,
)
from tpu_dra_torch.simcluster.admission import WebhookCaller
from tpu_dra_torch.simcluster.gvk import gvr_for_doc
from tpu_dra_torch.simcluster.nodesim import NodeSim
from tpu_dra_torch.simcluster.scheduler import Scheduler
from tpu_dra_torch.simcluster.workloads import WorkloadController
from tpu_dra_torch.testing import MPS_STANDIN

log = logging.getLogger("simcluster")

# The longest socket path under a workdir (a node's compute-domain
# registration socket), less the workdir itself: AF_UNIX paths end at
# 107 bytes.
_SOCKET_TAIL = len("/n00/fs/var/lib/kubelet/plugins_registry/"
                   "compute-domain.gpu.dev-reg.sock")


def short_workdir(prefix: str = "sc-") -> str:
    """A fresh workdir under the temporary directory, or under /tmp when
    that one is too deep for the nodes' socket paths."""
    tmp = tempfile.gettempdir()
    if len(tmp) + len(prefix) + 9 + _SOCKET_TAIL > 107:
        tmp = "/tmp"
    return tempfile.mkdtemp(prefix=prefix, dir=tmp)


class SimCluster:
    """N simulated GPU nodes around a FakeApiServer; see module docstring.

    gpus_per_node: each fake node's GPU count. clique_ids: per-node
    NVLink clique ("" = a node-local clique of its own); equal ids share
    one clique, and a node's worker index is its rank among the nodes of
    its clique. mig_gpus: GPU indices in MIG mode on every fake node.
    card_node: node n0 is this host, read through NVML."""

    def __init__(self, workdir: str, *, num_nodes: int = 2,
                 gpus_per_node: int = 2,
                 clique_ids: Optional[List[str]] = None,
                 mig_gpus: Optional[List[int]] = None,
                 card_node: bool = False):
        self.workdir = workdir
        self.server = FakeApiServer()
        # The admission chain: registered validating webhooks are called
        # on create/update, like the real apiserver.
        self.server.admission_hook = WebhookCaller(self.server.cluster)
        self.nodes: Dict[str, NodeSim] = {}
        self._num_nodes = num_nodes
        self._gpus = gpus_per_node
        self._clique_ids = (list(clique_ids) if clique_ids
                            else [""] * num_nodes)
        if len(self._clique_ids) != num_nodes:
            raise ValueError("clique_ids must have one entry per node")
        self._mig_gpus = list(mig_gpus or [])
        self._card_node = card_node
        self.scheduler: Optional[Scheduler] = None
        self.workloads: Optional[WorkloadController] = None
        self.api: Optional[HttpApiClient] = None

    @property
    def url(self) -> str:
        return self.server.url

    def node_dir(self, name: str) -> str:
        return os.path.join(self.workdir, name)

    def _inventory_env(self, i: int, name: str) -> Dict[str, str]:
        if self._card_node and i == 0:
            return {BACKEND_ENV: "native"}
        clique = self._clique_ids[i]
        worker = self._clique_ids[:i].count(clique) if clique else 0
        path = os.path.join(self.node_dir(name), "gpus.json")
        write_fake_inventory(path, self._gpus, clique_id=clique,
                             worker_index=worker, node_index=i,
                             mig_mode=self._mig_gpus)
        events = self.events_file(name)
        open(events, "a").close()
        return {BACKEND_ENV: "fake", INVENTORY_ENV: path,
                EVENTS_ENV: events}

    def events_file(self, name: str) -> str:
        """The health-events file of fake node `name`
        (gpuinfo.append_health_event writes to it)."""
        return os.path.join(self.node_dir(name), "health_events")

    def start(self) -> "SimCluster":
        self.server.start()
        self.api = HttpApiClient(base_url=self.server.url)
        for i in range(self._num_nodes):
            # Short names throughout: the kubelet registry socket path
            # must stay under the AF_UNIX 107-byte limit
            # (<workdir>/<node>/fs/var/lib/kubelet/plugins_registry/
            # compute-domain.gpu.dev-reg.sock).
            name = f"n{i}"
            os.makedirs(os.path.join(self.node_dir(name), "fs"),
                        exist_ok=True)
            env = self._inventory_env(i, name)
            self.api.create(NODES, {
                "apiVersion": "v1", "kind": "Node",
                "metadata": {"name": name, "labels": {NODE_LABEL: "true"}},
            })
            fake = env.get(BACKEND_ENV) == "fake"
            sim = NodeSim(self.api, name, self.node_dir(name),
                          api_url=self.server.url, inventory_env=env,
                          mps_binary=MPS_STANDIN if fake else None)
            sim.start()
            self.nodes[name] = sim
        self.scheduler = Scheduler(self.api)
        self.scheduler.start()
        self.workloads = WorkloadController(self.api)
        self.workloads.start()
        return self

    def stop(self) -> None:
        if self.workloads:
            self.workloads.stop()
        if self.scheduler:
            self.scheduler.stop()
        for sim in self.nodes.values():
            sim.stop()
        self.server.stop()

    # ------------------------------------------------------------------

    def install(self, docs: List[Dict]) -> int:
        """Apply manifests (the ``kubectl apply -f`` of the install
        step). Returns the number of objects created."""
        assert self.api is not None
        n = 0
        for doc in docs:
            if not doc:
                continue
            gvr = gvr_for_doc(doc)
            ns = doc["metadata"].get("namespace")
            try:
                self.api.create(gvr, doc, namespace=ns)
                n += 1
            except AlreadyExistsError:
                self.api.update(gvr, doc, ns)
        return n

    def pod_log(self, pod: Dict, container: str) -> str:
        """A container's output so far (kubectl logs)."""
        path = os.path.join(self.node_dir(pod["spec"]["nodeName"]), "pods",
                            pod["metadata"]["uid"], "logs",
                            f"{container}.log")
        with open(path, errors="replace") as f:
            return f.read()


def main(argv=None) -> int:
    """Serve a sim cluster until SIGTERM. Writes {url, workdir, pid} as
    JSON to --state-file once ready, and prints it."""
    import argparse

    ap = argparse.ArgumentParser(prog="python -m tpu_dra_torch.simcluster")
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--nodes", type=int, default=2)
    ap.add_argument("--gpus-per-node", type=int, default=2)
    ap.add_argument("--clique-ids", default="",
                    help="comma-separated per-node NVLink clique ids "
                         "(equal ids share a clique)")
    ap.add_argument("--mig-gpus", default="",
                    help="comma-separated GPU indices in MIG mode on "
                         "every fake node")
    ap.add_argument("--card-node", action="store_true",
                    help="node n0 is this host, its GPUs read by NVML")
    ap.add_argument("--install", action="store_true",
                    help="apply the driver's manifests once up")
    ap.add_argument("--state-file", default="")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    cliques = ([s.strip() for s in args.clique_ids.split(",")]
               if args.clique_ids else None)
    mig = [int(s) for s in args.mig_gpus.split(",") if s.strip()]
    cluster = SimCluster(args.workdir, num_nodes=args.nodes,
                         gpus_per_node=args.gpus_per_node,
                         clique_ids=cliques, mig_gpus=mig,
                         card_node=args.card_node).start()
    if args.install:
        from tpu_dra_torch.deploy.manifests import all_manifests
        cluster.install(all_manifests())
    state = {"url": cluster.url, "workdir": args.workdir,
             "pid": os.getpid()}
    if args.state_file:
        with open(args.state_file, "w") as f:
            json.dump(state, f)
    print(json.dumps(state), flush=True)

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    stop.wait()
    cluster.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
