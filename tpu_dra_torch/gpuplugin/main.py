"""GPU kubelet plugin entry point (counterpart of
tpu_dra/tpuplugin/main.py): env-mirrored flags, debug signal handlers,
the driver over the node's GPUs, serve until signalled.

    python -m tpu_dra_torch.gpuplugin.main --node-name NODE \\
        [--kube-api-url URL] [--plugin-dir DIR] [--registry-dir DIR] ...

The GPUs come from NVML (``gpuinfo.get_backend()``, which raises on a
host without a GPU); ``TPU_DRA_TORCH_GPUINFO_BACKEND=fake`` serves the
fake 8-GPU node instead. The plugin serves NodePrepareResources and
NodeUnprepareResources on ``dra.sock`` (gRPC, kubelet's protocol) and
``dra-fast.sock`` (framed), and registers with kubelet's plugin watcher
after its first ResourceSlice publish. SIGTERM or SIGINT drains it.

With MultiprocessSupport on, MPS claims get a control-daemon Deployment
in ``--namespace`` (image ``--mps-image``, directories under
``--mps-root-dir``); with PassthroughSupport on, passthrough claims are
rebound to vfio-pci through the sysfs under ``--sysfs-root``, and the
plugin refuses to start where vfio_pci or the IOMMU is missing. Not
copied: the reference's tpuctl path (``NativeBackend``'s setters do its
work).
"""

from __future__ import annotations

import signal
import threading

from tpu_dra_torch.api.types import GPU_DRIVER_NAME
from tpu_dra_torch.cdi.handler import CDIHandler
from tpu_dra_torch.gpuplugin.checkpoint import CheckpointManager
from tpu_dra_torch.gpuplugin.device_state import DeviceState
from tpu_dra_torch.gpuplugin.driver import GpuDriver
from tpu_dra_torch.gpuplugin.passthrough import PassthroughManager, PciSysfs
from tpu_dra_torch.gpuplugin.sharing import MpsManager, TimeSlicingManager
from tpu_dra_torch.infra import debug, featuregates, trace
from tpu_dra_torch.infra.flags import (
    Flag, FlagSet, apply_feature_gates, feature_gate_flag, logging_flags,
    setup_logging,
)
from tpu_dra_torch.infra.metrics import MetricsServer
from tpu_dra_torch.k8s.client import HttpApiClient, RetryingApiClient
from tpu_dra_torch.kubeletplugin.server import self_probe
from tpu_dra_torch.native.gpuinfo import get_backend


def flags() -> FlagSet:
    return FlagSet("gpu-kubelet-plugin", [
        Flag("node-name", "NODE_NAME", required=True,
             help="name of the node this plugin runs on"),
        Flag("namespace", "NAMESPACE", default="gpu-dra-driver",
             help="driver namespace (MPS daemon Deployments land here)"),
        Flag("cdi-root", "CDI_ROOT", default="/var/run/cdi",
             help="directory for CDI spec files"),
        Flag("plugin-dir", "PLUGIN_DIR",
             default=f"/var/lib/kubelet/plugins/{GPU_DRIVER_NAME}",
             help="kubelet plugin dir (dra.sock, checkpoint, locks)"),
        Flag("registry-dir", "REGISTRY_DIR",
             default="/var/lib/kubelet/plugins_registry",
             help="kubelet plugin watcher registry dir"),
        Flag("driver-root", "NVIDIA_DRIVER_ROOT", default="/",
             help="host root to resolve the NVIDIA driver's files under"),
        Flag("kube-api-url", "KUBE_API_URL", default=None,
             help="API server URL (default: in-cluster config)"),
        Flag("healthcheck-port", "HEALTHCHECK_PORT", default=0, type=int,
             help="metrics/health HTTP port (0 = disabled)"),
        Flag("additional-xids-to-ignore", "ADDITIONAL_XIDS_TO_IGNORE",
             default="", help="comma-separated XIDs the health monitor "
                              "skips, beside its default list"),
        Flag("mps-image", "MPS_IMAGE", default="gpu-dra-driver:latest",
             help="image of the per-claim MPS control-daemon Deployments "
                  "(one that holds nvidia-cuda-mps-control)"),
        Flag("mps-root-dir", "MPS_ROOT_DIR", default="",
             help="host directory of the claims' MPS pipe and log "
                  "directories (default: <plugin-dir>/mps)"),
        Flag("mps-ready-timeout", "MPS_READY_TIMEOUT", default=30.0,
             type=float, help="seconds an MPS daemon has to become ready"),
        Flag("sysfs-root", "SYSFS_ROOT", default="/",
             help="root the passthrough rebind finds sysfs, /dev and "
                  "/proc under"),
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
    # SIGUSR1 -> flight-recorder dump (recent spans + fault firings +
    # queue events): the "what is this plugin doing RIGHT NOW" lever.
    trace.install_signal_handler()

    backend = get_backend()
    # Transient API-server failures (rolling upgrade, LB blips) retry
    # with jittered backoff instead of crash-looping the pod.
    client = RetryingApiClient(HttpApiClient(base_url=ns.kube_api_url))
    cdi = CDIHandler(ns.cdi_root, driver_root=ns.driver_root)
    ts_manager = None
    if featuregates.enabled(featuregates.TimeSlicingSettings):
        ts_manager = TimeSlicingManager(backend)
    mps_manager = None
    if featuregates.enabled(featuregates.MultiprocessSupport):
        mps_manager = MpsManager(
            backend, client, node_name=ns.node_name, namespace=ns.namespace,
            root_dir=ns.mps_root_dir or f"{ns.plugin_dir}/mps",
            image=ns.mps_image, ready_timeout=ns.mps_ready_timeout)
    pt_manager = None
    if featuregates.enabled(featuregates.PassthroughSupport):
        pt_manager = PassthroughManager(PciSysfs(ns.sysfs_root))
        # A node that advertises passthrough without vfio or an IOMMU
        # would fail every passthrough claim at prepare: fail fast.
        pt_manager.prechecks()
    state = DeviceState(
        backend=backend, cdi=cdi,
        checkpoints=CheckpointManager(ns.plugin_dir),
        driver_name=GPU_DRIVER_NAME, node_name=ns.node_name,
        ts_manager=ts_manager, mps_manager=mps_manager,
        pt_manager=pt_manager)

    xids = [int(c) for c in ns.additional_xids_to_ignore.split(",") if c]
    driver = GpuDriver(
        state=state, client=client, driver_name=GPU_DRIVER_NAME,
        node_name=ns.node_name, plugin_dir=ns.plugin_dir,
        registry_dir=ns.registry_dir, additional_codes_to_ignore=xids)

    metrics_srv = None
    if ns.healthcheck_port:
        metrics_srv = MetricsServer(
            addr="0.0.0.0", port=ns.healthcheck_port,  # noqa: S104
            health_probe=lambda: self_probe(driver.server))
        metrics_srv.start()

    stop = threading.Event()

    def _on_stop_signal(signum, _frame):
        # Snapshot the flight recorder on SIGTERM before the drain: if
        # the drain wedges, the evidence of what was in flight exists.
        if signum == signal.SIGTERM:
            trace.dump_flight_recorder("sigterm")
        stop.set()

    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, _on_stop_signal)

    driver.start()
    logger.info("gpu kubelet plugin serving on %s (kubelet gRPC) + %s "
                "(framed)", driver.server.dra_socket,
                driver.server.fast_socket)
    stop.wait()
    driver.shutdown()
    if metrics_srv:
        metrics_srv.stop()
    backend.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
