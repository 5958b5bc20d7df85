"""ComputeDomain controller entrypoint (counterpart of
tpu_dra/cdcontroller/main.py): flags (with --max-nodes-per-clique-domain),
the metrics endpoint and the run loop.

Run: ``python -m tpu_dra_torch.cdcontroller.main [flags]``
"""

from __future__ import annotations

import signal
import threading

from tpu_dra_torch.cdcontroller.controller import Controller
from tpu_dra_torch.infra import debug
from tpu_dra_torch.infra.flags import (
    Flag, FlagSet, apply_feature_gates, feature_gate_flag, logging_flags,
    setup_logging,
)
from tpu_dra_torch.infra.featuregates import Features
from tpu_dra_torch.infra.metrics import MetricsServer
from tpu_dra_torch.k8s.client import HttpApiClient, RetryingApiClient


def flags() -> FlagSet:
    return FlagSet("gpu-cd-controller", [
        Flag("namespace", "NAMESPACE", default="gpu-dra-driver",
             help="driver namespace (DaemonSets + daemon RCTs land here)"),
        Flag("image", "DAEMON_IMAGE", default="gpu-dra-driver:latest",
             help="image for the per-CD domain-daemon DaemonSet"),
        Flag("daemon-service-account", "DAEMON_SERVICE_ACCOUNT", default="",
             help="serviceAccountName for stamped daemon pods "
                  "(empty = namespace default SA)"),
        Flag("max-nodes-per-clique-domain", "MAX_NODES_PER_CLIQUE_DOMAIN",
             default=64, type=int,
             help="upper bound on hosts per NVLink clique of a domain"),
        Flag("kube-api-url", "KUBE_API_URL", default=None,
             help="API server URL (default: in-cluster config)"),
        Flag("http-endpoint-port", "HTTP_ENDPOINT_PORT", default=0, type=int,
             help="metrics/pprof HTTP port (0 = disabled)"),
        Flag("gc-interval-seconds", "GC_INTERVAL_SECONDS", default=600,
             type=int, help="stale-object GC period"),
        feature_gate_flag(),
        *logging_flags(),
    ])


def main(argv=None) -> int:
    fs = flags()
    ns = fs.parse(argv)
    logger = setup_logging(ns.v, ns.log_json)
    apply_feature_gates(ns)
    fs.dump_config(ns, logger)
    debug.start_debug_signal_handlers()

    # Transient API-server failures (rolling upgrade, LB blips)
    # retry with jittered backoff instead of crash-looping the pod.
    client = RetryingApiClient(HttpApiClient(base_url=ns.kube_api_url))
    controller = Controller(
        client, namespace=ns.namespace, image=ns.image,
        log_verbosity=ns.v, feature_gates=Features.as_string(),
        max_nodes_per_clique_domain=ns.max_nodes_per_clique_domain,
        gc_interval=ns.gc_interval_seconds,
        daemon_service_account=ns.daemon_service_account)

    metrics_srv = None
    if ns.http_endpoint_port:
        metrics_srv = MetricsServer(addr="0.0.0.0",  # noqa: S104
                                    port=ns.http_endpoint_port)
        metrics_srv.start()

    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())

    controller.start()
    logger.info("compute-domain controller running (namespace %s)",
                ns.namespace)
    stop.wait()
    controller.stop()
    if metrics_srv:
        metrics_srv.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
