"""simcluster: a cluster-in-processes (counterpart of tpu_dra/simcluster).

Stands in for the cluster pieces the driver does NOT own, so the pieces
it DOES own run for real, as subprocesses, wired over real HTTP and
unix-socket RPC:

- FakeApiServer        -> the API server (HTTP + watch)
- Scheduler            -> claims-from-templates + DRA allocation + binding
                          (upstream kube-scheduler's DRA plugin analog)
- WorkloadController   -> DaemonSet/Deployment -> Pod stamping + status
                          (kube-controller-manager analog)
- NodeSim              -> per-node kubelet: runs pod commands as real
                          subprocesses, drives the REAL driver plugins over
                          their dra.sock, applies REAL CDI spec edits to
                          container env, runs probes, reports status
- WebhookCaller        -> the API server's admission chain

The driver components themselves (kubelet plugins, CD controller, CD
daemon, webhook) are launched from the manifests
(``tpu_dra_torch.deploy.manifests``, which the chart renders to).

``python -m tpu_dra_torch.simcluster`` serves a cluster until signalled.
"""

from tpu_dra_torch.simcluster.cluster import SimCluster  # noqa: F401
