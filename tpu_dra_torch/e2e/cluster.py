"""The e2e tier's cluster (counterpart of hack/e2e-up.sh and
e2e-down.sh in sim mode): a SimCluster of two nodes with the chart's
default render installed.

By default both nodes are simulated, with GPUS_PER_NODE fake H100s each
(hack/e2e-up.sh's default of 4 per node: gpu-test4 claims four GPUs of
one node), GPU MIG_GPU of each in MIG mode, in NVLink cliques of their
own. With card_node, n0 is this host and its plugins read NVML; n1 stays
simulated and carries what the card cannot show (MIG, MPS compute mode,
health events, time-slice settings).
"""

from __future__ import annotations

import shutil
from tpu_dra_torch.deploy import manifests
from tpu_dra_torch.simcluster import SimCluster
from tpu_dra_torch.simcluster.cluster import short_workdir

GPUS_PER_NODE = 4
MIG_GPU = 3
CLIQUES = ["clique-a", "clique-b"]


class E2ECluster:
    """Start with start(); the cluster is `cluster`; stop() stops every
    process and removes the workdir."""

    def __init__(self, *, card_node: bool = False):
        self.card_node = card_node
        self.workdir = short_workdir("e2e-")
        self.cluster = SimCluster(self.workdir, num_nodes=2,
                                  gpus_per_node=GPUS_PER_NODE,
                                  clique_ids=CLIQUES, mig_gpus=[MIG_GPU],
                                  card_node=card_node)

    def start(self) -> "E2ECluster":
        self.cluster.start()
        self.cluster.install(manifests.all_manifests())
        return self

    def stop(self) -> None:
        try:
            self.cluster.stop()
        finally:
            shutil.rmtree(self.workdir, ignore_errors=True)
