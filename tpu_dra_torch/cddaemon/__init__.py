"""ComputeDomain node daemon (counterpart of tpu_dra.cddaemon).

Runs in each per-CD DaemonSet pod: wraps the native ``gpu-domain-daemon``
binary (``binary.build``), registers this node into the CD status with a
stable per-clique index, maintains the peer rendezvous config
(/etc/hosts + nodes.cfg, SIGUSR1 re-resolve), and exposes the ``check``
readiness probe.
"""
