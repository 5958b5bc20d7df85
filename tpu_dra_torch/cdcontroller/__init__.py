"""ComputeDomain controller (counterpart of tpu_dra.cdcontroller).

Cluster-scoped, single-replica control loop: watches ComputeDomain CRs and
materializes per-CD infrastructure — a per-CD DaemonSet of domain daemons
(landing only on nodes the CD kubelet plugin labels), the daemon + workload
ResourceClaimTemplates, Ready/NotReady status transitions, and garbage
collection of everything when the CD goes away.
"""

from tpu_dra_torch.cdcontroller.controller import Controller  # noqa: F401
