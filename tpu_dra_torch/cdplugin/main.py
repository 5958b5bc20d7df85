"""ComputeDomain kubelet plugin entrypoint (counterpart of
tpu_dra/cdplugin/main.py): env-mirrored flags, clique-identity discovery
at startup, driver + GC construction, serve until signalled.

Run: ``python -m tpu_dra_torch.cdplugin.main [flags]``
"""

from __future__ import annotations

import signal
import threading

from tpu_dra_torch.api.types import COMPUTE_DOMAIN_DRIVER_NAME
from tpu_dra_torch.cddaemon.main import discover_clique_id
from tpu_dra_torch.cdi.handler import CDIHandler
from tpu_dra_torch.cdplugin.cleanup import CheckpointCleanup
from tpu_dra_torch.cdplugin.computedomain import (
    COORDINATOR_PORT, ComputeDomainManager,
)
from tpu_dra_torch.cdplugin.device_state import DeviceState
from tpu_dra_torch.cdplugin.driver import CDDriver
from tpu_dra_torch.infra import debug
from tpu_dra_torch.infra.flags import (
    Flag, FlagSet, apply_feature_gates, feature_gate_flag, logging_flags,
    setup_logging,
)
from tpu_dra_torch.infra.metrics import MetricsServer
from tpu_dra_torch.k8s.client import HttpApiClient, RetryingApiClient
from tpu_dra_torch.native.gpuinfo import get_backend
from tpu_dra_torch.gpuplugin.checkpoint import CheckpointManager

CDI_VENDOR_CD = "k8s.compute-domain.gpu.dev"


def flags() -> FlagSet:
    return FlagSet("gpu-cd-kubelet-plugin", [
        Flag("node-name", "NODE_NAME", required=True,
             help="name of the node this plugin runs on"),
        Flag("cdi-root", "CDI_ROOT", default="/var/run/cdi",
             help="directory for CDI spec files"),
        Flag("plugin-dir", "PLUGIN_DIR",
             default=f"/var/lib/kubelet/plugins/{COMPUTE_DOMAIN_DRIVER_NAME}",
             help="kubelet plugin dir (dra.sock, checkpoint, domains/)"),
        Flag("registry-dir", "REGISTRY_DIR",
             default="/var/lib/kubelet/plugins_registry",
             help="kubelet plugin watcher registry dir"),
        Flag("kube-api-url", "KUBE_API_URL", default=None,
             help="API server URL (default: in-cluster config)"),
        Flag("healthcheck-port", "HEALTHCHECK_PORT", default=0, type=int,
             help="metrics/health HTTP port (0 = disabled)"),
        Flag("gc-interval-seconds", "GC_INTERVAL_SECONDS", default=600,
             type=int, help="checkpoint/domain-dir GC period"),
        Flag("coordinator-port", "COORDINATOR_PORT",
             default=COORDINATOR_PORT, type=int,
             help="port of the domain's rendezvous (MASTER_PORT of the "
                  "workload env)"),
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

    backend = get_backend()
    clique_id = discover_clique_id(backend)
    # Transient API-server failures (rolling upgrade, LB blips)
    # retry with jittered backoff instead of crash-looping the pod.
    client = RetryingApiClient(HttpApiClient(base_url=ns.kube_api_url))
    cd_manager = ComputeDomainManager(
        client, node_name=ns.node_name, driver_plugin_dir=ns.plugin_dir,
        coordinator_port=ns.coordinator_port)
    cd_manager.start()

    cdi = CDIHandler(ns.cdi_root, vendor=CDI_VENDOR_CD)
    state = DeviceState(
        cd_manager=cd_manager, cdi=cdi,
        checkpoints=CheckpointManager(ns.plugin_dir),
        driver_name=COMPUTE_DOMAIN_DRIVER_NAME, node_name=ns.node_name,
        clique_id=clique_id)
    driver = CDDriver(
        state=state, client=client,
        driver_name=COMPUTE_DOMAIN_DRIVER_NAME, node_name=ns.node_name,
        clique_id=clique_id, plugin_dir=ns.plugin_dir,
        registry_dir=ns.registry_dir)
    gc = CheckpointCleanup(client=client, state=state, cd_manager=cd_manager,
                           interval=ns.gc_interval_seconds)

    metrics_srv = None
    if ns.healthcheck_port:
        from tpu_dra_torch.kubeletplugin.server import self_probe
        metrics_srv = MetricsServer(
            addr="0.0.0.0", port=ns.healthcheck_port,  # noqa: S104
            health_probe=lambda: self_probe(driver.server))
        metrics_srv.start()

    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())

    driver.start()
    gc.start()
    logger.info("cd kubelet plugin serving on %s (clique %r)",
                driver.server.dra_socket, clique_id)
    stop.wait()
    gc.stop()
    driver.shutdown()
    cd_manager.stop()
    if metrics_srv:
        metrics_srv.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
