"""DRA plugin RPC server + registration + ResourceSlice publishing
(counterpart of tpu_dra/kubeletplugin/server.py).

- serves the DRAPlugin service (NodePrepareResources/NodeUnprepareResources)
  on unix sockets under the plugin dir: gRPC on ``dra.sock`` (kubelet's
  protocol) and the framed transport on ``dra-fast.sock``;
- serves the Registration service on a socket under the kubelet plugin
  registry so kubelet's plugin watcher discovers the driver;
- publishes the ResourceSlice describing this node's devices.

One event loop thread (aio_server.EventLoopThread) hosts every listener;
the blocking handlers (``DraHandlers``: pipeline admission, flock, group
commit) run on an executor, whatever the transport. The messages are
``wire``'s hand-written proto3 codec, so this module and the framed
transport run without ``grpc`` and without ``google.protobuf``. ``grpc``
is imported only where a gRPC socket is served or dialled: the kubelet
DRA and registration listeners, ``kubelet_stubs`` and ``self_probe``'s
gRPC leg. A server built with ``kubelet_grpc=False`` serves the framed
socket alone and never imports it; one built with ``kubelet_grpc=True``
(the default) refuses to start without it, naming the failed import.

Not copied: ``RetryingFramedClient``, the client that masks a plugin
hot restart, and its reconnect counter. They come with the hot-restart
slice.
"""

from __future__ import annotations

import asyncio
import os
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from tpu_dra_torch.k8s import ApiClient, RESOURCESLICES
from tpu_dra_torch.k8s.client import NotFoundError
from tpu_dra_torch.kubeletplugin import aio_server, wire
from tpu_dra_torch.kubeletplugin.aio_server import (
    FRAME_HEADER, METHOD_ERROR, METHOD_PING, METHOD_PREPARE,
    METHOD_UNPREPARE, EventLoopThread, FramedRpcServer,
    aio_service_handlers,
)

_DRA_SERVICE = "k8s.io.kubelet.pkg.apis.dra.v1.DRAPlugin"
_REG_SERVICE = "pluginregistration.Registration"


@dataclass
class PreparedDevice:
    """One device result returned to kubelet (dra.v1 Device)."""
    pool_name: str
    device_name: str
    cdi_device_ids: List[str] = field(default_factory=list)
    request_names: List[str] = field(default_factory=list)


@dataclass
class PrepareResult:
    devices: List[PreparedDevice] = field(default_factory=list)
    error: str = ""


@dataclass
class Claim:
    uid: str
    name: str
    namespace: str


class DriverCallbacks:
    """Implemented by the driver (gpuplugin.driver.GpuDriver).

    The claims list is the RPC's batch — kubelet sends a pod's claims in
    ONE NodePrepareResources call. Implementations must return one entry
    per claim uid with per-claim error isolation (one bad claim must not
    fail its batch siblings); they may treat the batch as a single unit
    of work (one lock acquisition, group-committed durable state)."""

    def prepare_claims(self, claims: List[Claim]) -> Dict[str, PrepareResult]:
        raise NotImplementedError

    def unprepare_claims(self, claims: List[Claim]) -> Dict[str, str]:
        """uid -> error string ('' = success)."""
        raise NotImplementedError

    def record_wire(self, stage_s: Dict[str, float]) -> None:
        """Server-side wire-time attribution hook: per-RPC seconds for
        the request-decode and response-encode stages plus the whole
        handler wall ({'decode','encode','handler'}). The default drops
        it."""


def import_grpc():
    """The ``grpc`` module, or a RuntimeError that says which import
    failed and that the framed socket needs none of it."""
    try:
        import grpc
        import grpc.aio  # noqa: F401 — the listeners' server type
    except ImportError as e:
        raise RuntimeError(
            f"the kubelet gRPC sockets need the grpc package, and "
            f"'import grpc' failed: {e}. Build the server with "
            f"kubelet_grpc=False to serve the framed socket "
            f"(dra-fast.sock) alone.") from e
    return grpc


class DraHandlers:
    """Transport-independent DRA method implementations.

    Every method here BLOCKS (pipeline admission, flock, fdatasync) —
    the async front-end must only ever call them through an executor.
    Two surfaces per method: ``*_msg`` for transports handing parsed
    messages (grpc.aio) and ``*_bytes`` for the framed path (wire parse
    and serialize included in the decode/encode stopwatches, so the
    attribution stays honest about what each transport pays)."""

    def __init__(self, callbacks: DriverCallbacks):
        self._callbacks = callbacks

    # -- NodePrepareResources ----------------------------------------------

    def node_prepare_msg(self, request: wire.NodePrepareResourcesRequest
                         ) -> wire.NodePrepareResourcesResponse:
        t_in = time.perf_counter()
        claims = [Claim(uid=c.uid, name=c.name, namespace=c.namespace)
                  for c in request.claims]
        t_decoded = time.perf_counter()
        results = dict(self._callbacks.prepare_claims(claims))
        t_done = time.perf_counter()
        resp = self._build_prepare_response(claims, results)
        t_out = time.perf_counter()
        self._callbacks.record_wire({"decode": t_decoded - t_in,
                                     "encode": t_out - t_done,
                                     "handler": t_out - t_in})
        return resp

    def node_prepare_bytes(self, body: bytes) -> bytes:
        t_in = time.perf_counter()
        request = wire.NodePrepareResourcesRequest.FromString(body)
        claims = [Claim(uid=c.uid, name=c.name, namespace=c.namespace)
                  for c in request.claims]
        t_decoded = time.perf_counter()
        results = dict(self._callbacks.prepare_claims(claims))
        t_done = time.perf_counter()
        payload = self._build_prepare_response(
            claims, results).SerializeToString()
        t_out = time.perf_counter()
        self._callbacks.record_wire({"decode": t_decoded - t_in,
                                     "encode": t_out - t_done,
                                     "handler": t_out - t_in})
        return payload

    @staticmethod
    def _build_prepare_response(claims: List[Claim],
                                results: Dict[str, PrepareResult]
                                ) -> wire.NodePrepareResourcesResponse:
        for claim in claims:
            # A driver bug that dropped a claim from the result map must
            # surface as that claim's error, not a missing response entry
            # kubelet could misread as success-shaped.
            results.setdefault(
                claim.uid,
                PrepareResult(error="driver returned no result for claim"))
        resp = wire.NodePrepareResourcesResponse()
        for uid, res in results.items():
            if res.error:
                resp.claims[uid] = wire.NodePrepareResourceResponse(
                    error=res.error)
            else:
                resp.claims[uid] = wire.NodePrepareResourceResponse(
                    devices=[wire.Device(
                        request_names=list(d.request_names),
                        pool_name=d.pool_name, device_name=d.device_name,
                        cdi_device_ids=list(d.cdi_device_ids))
                        for d in res.devices])
        return resp

    # -- NodeUnprepareResources --------------------------------------------

    def node_unprepare_msg(self, request: wire.NodeUnprepareResourcesRequest
                           ) -> wire.NodeUnprepareResourcesResponse:
        claims = [Claim(uid=c.uid, name=c.name, namespace=c.namespace)
                  for c in request.claims]
        return self._build_unprepare_response(
            claims, dict(self._callbacks.unprepare_claims(claims)))

    def node_unprepare_bytes(self, body: bytes) -> bytes:
        request = wire.NodeUnprepareResourcesRequest.FromString(body)
        return self.node_unprepare_msg(request).SerializeToString()

    @staticmethod
    def _build_unprepare_response(claims: List[Claim],
                                  errors: Dict[str, str]
                                  ) -> wire.NodeUnprepareResourcesResponse:
        for claim in claims:
            errors.setdefault(claim.uid,
                              "driver returned no result for claim")
        # Success is an empty entry for the uid.
        return wire.NodeUnprepareResourcesResponse(claims={
            uid: wire.NodeUnprepareResourceResponse(error=err or "")
            for uid, err in errors.items()})

    # -- framed dispatch ----------------------------------------------------

    def dispatch_frame(self, method: int, body: bytes) -> bytes:
        if method == METHOD_PREPARE:
            return self.node_prepare_bytes(body)
        if method == METHOD_UNPREPARE:
            return self.node_unprepare_bytes(body)
        raise ValueError(f"unknown framed-RPC method id {method}")


def _dra_aio_services(handlers: DraHandlers) -> Dict[str, Dict[str, tuple]]:
    return {_DRA_SERVICE: {
        "NodePrepareResources": (
            handlers.node_prepare_msg,
            wire.NodePrepareResourcesRequest.FromString,
            wire.NodePrepareResourcesResponse.SerializeToString),
        "NodeUnprepareResources": (
            handlers.node_unprepare_msg,
            wire.NodeUnprepareResourcesRequest.FromString,
            wire.NodeUnprepareResourcesResponse.SerializeToString),
    }}


def _registration_services(driver_name: str, endpoint: str,
                           on_status: Optional[Callable[[bool, str], None]]
                           ) -> Dict[str, Dict[str, tuple]]:
    def get_info(request):
        return wire.PluginInfo(type="DRAPlugin", name=driver_name,
                               endpoint=endpoint, supported_versions=["v1"])

    def notify(request):
        if on_status:
            on_status(request.plugin_registered, request.error)
        return wire.RegistrationStatusResponse()

    return {_REG_SERVICE: {
        "GetInfo": (get_info, wire.InfoRequest.FromString,
                    wire.PluginInfo.SerializeToString),
        "NotifyRegistrationStatus": (
            notify, wire.RegistrationStatus.FromString,
            wire.RegistrationStatusResponse.SerializeToString),
    }}


def registration_stubs(registration_socket: str):
    """Client-side gRPC stubs acting as kubelet's plugin watcher:
    (channel, get_info, notify_registration_status). Close the channel
    when done."""
    grpc = import_grpc()
    channel = grpc.insecure_channel(f"unix://{registration_socket}")
    get_info = channel.unary_unary(
        f"/{_REG_SERVICE}/GetInfo",
        request_serializer=wire.InfoRequest.SerializeToString,
        response_deserializer=wire.PluginInfo.FromString)
    notify = channel.unary_unary(
        f"/{_REG_SERVICE}/NotifyRegistrationStatus",
        request_serializer=wire.RegistrationStatus.SerializeToString,
        response_deserializer=wire.RegistrationStatusResponse.FromString)
    return channel, get_info, notify


def _grpc_probe(server: "DRAPluginServer", timeout: float) -> bool:
    """self_probe's gRPC leg: an empty NodePrepareResources on the DRA
    socket, and GetInfo on the registration socket once it is served."""
    grpc = import_grpc()
    try:
        channel, prepare, _ = kubelet_stubs(server.dra_socket)
        try:
            prepare(wire.NodePrepareResourcesRequest(), timeout=timeout)
        finally:
            channel.close()
        reg_sock = server.registration_socket
        if reg_sock:
            reg_channel, get_info, _ = registration_stubs(reg_sock)
            try:
                info = get_info(wire.InfoRequest(), timeout=timeout)
                if info.name != server.driver_name:
                    return False
            finally:
                reg_channel.close()
        return True
    except grpc.RpcError:
        return False


def self_probe(server: "DRAPluginServer", timeout: float = 3.0) -> bool:
    """Liveness self-probe: dial the plugin's own sockets as kubelet
    would — GetInfo on the registration socket, NodePrepareResources with
    an empty request on the DRA socket (both when the server serves
    gRPC) — plus a ping on the framed socket, and report whether all
    answered."""
    try:
        if server.kubelet_grpc and not _grpc_probe(server, timeout):
            return False
        if server.fast_socket and os.path.exists(server.fast_socket):
            client = FramedClient(server.fast_socket, timeout_s=timeout)
            try:
                if not client.ping():
                    return False
            finally:
                client.close()
        return True
    except OSError:
        return False


def kubelet_stubs(dra_socket: str):
    """Client-side gRPC stubs acting as kubelet: (channel, prepare,
    unprepare).

    Single source of truth for the DRA v1 method paths and serializers
    used by the tests and the gRPC side of the bench; close the returned
    channel when done. The framed equivalent is ``framed_stubs``."""
    grpc = import_grpc()
    channel = grpc.insecure_channel(f"unix://{dra_socket}")
    prepare = channel.unary_unary(
        f"/{_DRA_SERVICE}/NodePrepareResources",
        request_serializer=wire.NodePrepareResourcesRequest.SerializeToString,
        response_deserializer=wire.NodePrepareResourcesResponse.FromString)
    unprepare = channel.unary_unary(
        f"/{_DRA_SERVICE}/NodeUnprepareResources",
        request_serializer=wire.NodeUnprepareResourcesRequest.SerializeToString,
        response_deserializer=wire.NodeUnprepareResourcesResponse.FromString)
    return channel, prepare, unprepare


class FramedRpcError(RuntimeError):
    """Server-side error surfaced over the framed transport."""


class FramedClient:
    """Blocking framed-RPC client over the plugin's fast socket.

    NOT thread-safe: one request/response in flight per connection by
    protocol design — use one client per thread (concurrency =
    connections)."""

    def __init__(self, fast_socket: str, timeout_s: float = 30.0):
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.settimeout(timeout_s)
        self._sock.connect(fast_socket)

    def _call(self, method: int, payload: bytes) -> bytes:
        self._sock.sendall(FRAME_HEADER.pack(len(payload), method)
                           + payload)
        header = self._read_exact(FRAME_HEADER.size)
        length, resp_method = FRAME_HEADER.unpack(header)
        body = self._read_exact(length)
        if resp_method == METHOD_ERROR:
            raise FramedRpcError(body.decode("utf-8", "replace"))
        return body

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("framed-RPC server closed the "
                                      "connection mid-response")
            buf += chunk
        return buf

    def prepare(self, request: wire.NodePrepareResourcesRequest
                ) -> wire.NodePrepareResourcesResponse:
        body = self._call(METHOD_PREPARE, request.SerializeToString())
        return wire.NodePrepareResourcesResponse.FromString(body)

    def unprepare(self, request: wire.NodeUnprepareResourcesRequest
                  ) -> wire.NodeUnprepareResourcesResponse:
        body = self._call(METHOD_UNPREPARE, request.SerializeToString())
        return wire.NodeUnprepareResourcesResponse.FromString(body)

    def ping(self) -> bool:
        return self._call(METHOD_PING, b"") == b""

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass  # drflow: swallow-ok[idempotent close on teardown]


def framed_stubs(fast_socket: str, timeout_s: float = 30.0):
    """Framed-transport analog of kubelet_stubs: (client, prepare,
    unprepare) with the same request/response message types — call
    ``client.close()`` when done."""
    client = FramedClient(fast_socket, timeout_s=timeout_s)
    return client, client.prepare, client.unprepare


class DRAPluginServer:
    """Hosts the DRA + Registration services on unix sockets.

    plugin_dir:   /var/lib/kubelet/plugins/<driver>/   (dra.sock +
                  dra-fast.sock live here)
    registry_dir: /var/lib/kubelet/plugins_registry/   (watcher socket)
    kubelet_grpc: serve dra.sock and the registration socket over gRPC
                  (kubelet's protocol). False serves dra-fast.sock alone
                  and never imports grpc.

    One asyncio event loop thread (aio_server.EventLoopThread) reacts
    for every listener; one executor runs every blocking handler."""

    # Executor width bounds concurrent blocking DRA handlers (below the
    # pipeline's in-flight window of 16: the pool, not the window, is
    # the binding concurrency limit; excess RPCs queue in the executor).
    RPC_POOL_WORKERS = 8
    # Registration gets its own tiny pool: kubelet's GetInfo/
    # NotifyRegistrationStatus must answer even while every RPC worker
    # is wedged in a stalled prepare (a data-path stall must not read
    # as a dead plugin and deregister the driver).
    REG_POOL_WORKERS = 2

    def __init__(self, driver_name: str, node_name: str,
                 callbacks: DriverCallbacks,
                 plugin_dir: str, registry_dir: Optional[str] = None,
                 kubelet_grpc: bool = True):
        self.driver_name = driver_name
        self.node_name = node_name
        self.kubelet_grpc = kubelet_grpc
        self._callbacks = callbacks
        self._plugin_dir = plugin_dir
        self._registry_dir = registry_dir
        os.makedirs(plugin_dir, exist_ok=True)
        if registry_dir:
            os.makedirs(registry_dir, exist_ok=True)
        self.dra_socket = os.path.join(plugin_dir, "dra.sock")
        self.fast_socket = os.path.join(plugin_dir, "dra-fast.sock")
        self.registration_socket: Optional[str] = None
        self.registration_registered = threading.Event()
        self._loop_thread: Optional[EventLoopThread] = None
        self._pool: Optional[ThreadPoolExecutor] = None
        self._reg_pool: Optional[ThreadPoolExecutor] = None
        self._server = None           # grpc.aio server (DRA socket)
        self._framed: Optional[FramedRpcServer] = None
        self._reg_server = None       # grpc.aio server (registration)
        self._stopped = False
        # Serializes start_registration() against stop(): they run on
        # different threads (publish retry queue vs driver shutdown).
        self._reg_lock = threading.Lock()

    # -- loop-side coroutines (no blocking work here) -----------------------

    async def _start_main(self) -> None:
        handlers = DraHandlers(self._callbacks)
        if self.kubelet_grpc:
            grpc = import_grpc()
            self._server = grpc.aio.server()
            for h in aio_service_handlers(_dra_aio_services(handlers),
                                          self._pool):
                self._server.add_generic_rpc_handlers([h])
            self._server.add_insecure_port(f"unix://{self.dra_socket}")
            await self._server.start()
        self._framed = FramedRpcServer(self.fast_socket,
                                       handlers.dispatch_frame, self._pool)
        await self._framed.start()
        asyncio.get_running_loop().create_task(aio_server.lag_monitor())

    async def _start_registration(self, reg_sock: str) -> None:
        grpc = import_grpc()
        self._reg_server = grpc.aio.server()
        services = _registration_services(
            self.driver_name, self.dra_socket,
            on_status=lambda ok, err: (
                self.registration_registered.set() if ok else None))
        for h in aio_service_handlers(services, self._reg_pool):
            self._reg_server.add_generic_rpc_handlers([h])
        self._reg_server.add_insecure_port(f"unix://{reg_sock}")
        await self._reg_server.start()

    async def _stop_servers(self, grace: float) -> None:
        if self._server is not None:
            await self._server.stop(grace)
        if self._framed is not None:
            await self._framed.stop()
        if self._reg_server is not None:
            await self._reg_server.stop(grace)

    # -- lifecycle (called from plain threads) ------------------------------

    def start(self, register: bool = True) -> None:
        if self.kubelet_grpc:
            import_grpc()   # refuse before any socket or thread exists
        for sock in (self.dra_socket, self.fast_socket):
            if os.path.exists(sock):
                os.unlink(sock)
        self._loop_thread = EventLoopThread()
        self._pool = ThreadPoolExecutor(
            max_workers=self.RPC_POOL_WORKERS,
            thread_name_prefix="gpu-dra-rpc")
        self._loop_thread.submit(self._start_main()).result(timeout=10.0)
        if register:
            self.start_registration()

    def start_registration(self) -> None:
        """Expose the plugin-watcher socket. Separate from start() so the
        driver can gate kubelet registration on the first successful
        ResourceSlice publish: kubelet should not route claims here before
        the scheduler can see this node's inventory. Idempotent, a no-op
        without a registry dir or without kubelet gRPC, and refuses after
        stop(): the gated first publish runs on the retry queue, whose
        worker can still be mid-callback when the driver shuts down —
        starting a registration server then would leak it and advertise
        a dead plugin to kubelet."""
        with self._reg_lock:
            if self._stopped or self._reg_server is not None \
                    or not self._registry_dir or not self.kubelet_grpc:
                return
            reg_sock = os.path.join(
                self._registry_dir, f"{self.driver_name}-reg.sock")
            if os.path.exists(reg_sock):
                os.unlink(reg_sock)
            if self._reg_pool is None:
                self._reg_pool = ThreadPoolExecutor(
                    max_workers=self.REG_POOL_WORKERS,
                    thread_name_prefix="gpu-dra-reg")
            self._loop_thread.submit(
                self._start_registration(reg_sock)).result(timeout=10.0)
            self.registration_socket = reg_sock

    def stop(self, grace: float = 2.0) -> None:
        with self._reg_lock:
            self._stopped = True
        if self._loop_thread is not None:
            self._loop_thread.submit(self._stop_servers(grace)).result(
                timeout=grace + 10.0)
            # Drain the executors BEFORE stopping the loop: an
            # in-flight handler finishing after loop close would try to
            # deliver its future result onto a dead loop.
            for pool in (self._pool, self._reg_pool):
                if pool is not None:
                    pool.shutdown(wait=True)
            self._loop_thread.stop()
        else:
            for pool in (self._pool, self._reg_pool):
                if pool is not None:
                    pool.shutdown(wait=True)


# ---------------------------------------------------------------------------
# ResourceSlice publishing
# ---------------------------------------------------------------------------

def build_resource_slice(driver_name: str, node_name: str,
                         devices: List[Dict], pool_generation: int = 1) -> Dict:
    """Render a resource.k8s.io/v1 ResourceSlice for this node's devices.
    `devices` entries are {name, attributes, capacity} dicts produced by
    the device model."""
    return {
        "apiVersion": "resource.k8s.io/v1",
        "kind": "ResourceSlice",
        "metadata": {
            "name": f"{node_name}-{driver_name}",
            "ownerReferences": [],
        },
        "spec": {
            "driver": driver_name,
            "nodeName": node_name,
            "pool": {
                "name": node_name,
                "generation": pool_generation,
                "resourceSliceCount": 1,
            },
            "devices": devices,
        },
    }


def publish_resources(client: ApiClient, driver_name: str, node_name: str,
                      devices: List[Dict], pool_generation: int = 1) -> Dict:
    """Create-or-update this node's ResourceSlice."""
    slice_obj = build_resource_slice(driver_name, node_name, devices,
                                     pool_generation)
    try:
        current = client.get(RESOURCESLICES, slice_obj["metadata"]["name"])
        slice_obj["metadata"]["resourceVersion"] = \
            current["metadata"].get("resourceVersion")
        return client.update(RESOURCESLICES, slice_obj)
    except NotFoundError:
        return client.create(RESOURCESLICES, slice_obj)
