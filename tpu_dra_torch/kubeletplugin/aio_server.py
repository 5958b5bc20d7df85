"""Asyncio RPC front-end for the DRA plugin (counterpart of
tpu_dra/kubeletplugin/aio_server.py, copied as it is).

One event loop on a dedicated thread hosts BOTH prepare transports:

- **grpc.aio** on the kubelet DRA socket — wire-compatible with
  kubelet's gRPC client, served by async behaviors that offload the
  blocking handler to an executor (``aio_service_handlers``, which
  imports ``grpc`` itself: nothing else here needs it).

- **framed-RPC** on a second unix socket (``dra-fast.sock``): a 5-byte
  header (u32 LE body length + u8 method id) framing the SAME dra.v1
  protobuf payloads, one request/response in flight per connection
  (concurrency = connections). It needs only ``asyncio`` and
  ``struct``.

Event-loop/thread boundary discipline: coroutines here only frame, parse
headers, and await — every blocking stage (pipeline admission with its
window semaphore, SharedFlock, DeviceState group commit with its
fdatasync) runs inside ``run_in_executor`` on the RPC pool. The framed
dispatcher runs decode→handler→encode as ONE executor task so the
driver's per-thread wire-attribution pairing (record_wire reads a
thread-local queue share) holds.
"""

from __future__ import annotations

import asyncio
import struct
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, Optional, Set

from tpu_dra_torch.infra.metrics import DefaultRegistry

# Event-loop scheduling lag: how late a timed callback fires vs its
# deadline. The front-end's "is the loop healthy" observable — a
# blocking call smuggled onto the loop shows up here long before RPC
# p99 does (buckets sized for µs-scale lag up to a seized loop).
RPC_LOOP_LAG = DefaultRegistry.histogram(
    "tpu_dra_rpc_loop_lag_seconds",
    "asyncio event-loop scheduling lag of the RPC front-end: observed "
    "minus intended delay of a periodic timer on the loop; sustained "
    "growth means blocking work leaked onto the loop thread",
    buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
             0.05, 0.25, 1.0))

# RPCs currently offloaded past framing (decode→handler→encode running
# on the executor). Distinct from tpu_dra_prepare_inflight_rpcs: that
# gauge counts RPCs past PIPELINE admission; this one counts everything
# the front-end accepted, including RPCs still queued on the admission
# window — the difference is the admission backlog under sustained load.
SUSTAINED_INFLIGHT = DefaultRegistry.gauge(
    "tpu_dra_rpc_sustained_inflight",
    "RPCs currently dispatched by the async front-end (framed + gRPC), "
    "admitted or queued on the pipeline window; bounded by client "
    "concurrency, watched by the sustained-load bench")

# Framed-RPC wire format: u32 LE body length + u8 method id, then the
# dra.v1 protobuf payload. Responses reuse the header with method id
# echoing the request's (or METHOD_ERROR carrying a utf-8 message).
FRAME_HEADER = struct.Struct("<IB")
METHOD_PREPARE = 1
METHOD_UNPREPARE = 2
METHOD_PING = 3
METHOD_ERROR = 0xFF
MAX_FRAME_BYTES = 16 << 20  # a NodePrepareResources batch is ~KBs; 16MiB
# rejects a corrupt/hostile length before readexactly tries to buffer it

_LAG_INTERVAL_S = 0.05


class EventLoopThread:
    """One asyncio loop on a daemon thread, submit-from-anywhere.

    The loop is the front-end's reactor; everything blocking belongs on
    the executor the caller passes to the servers (never here)."""

    def __init__(self, name: str = "gpu-dra-rpc-loop"):
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    def _run(self) -> None:
        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()
        # Drain callbacks scheduled during shutdown, then close.
        self.loop.run_until_complete(self.loop.shutdown_asyncgens())
        self.loop.close()

    def submit(self, coro) -> Future:
        """Schedule a coroutine on the loop; returns a concurrent
        Future (callers block on .result() from plain threads)."""
        return asyncio.run_coroutine_threadsafe(coro, self.loop)

    def stop(self, timeout: float = 5.0) -> None:
        def _cancel_all() -> None:
            for task in asyncio.all_tasks(self.loop):
                task.cancel()
            self.loop.call_soon(self.loop.stop)

        self.loop.call_soon_threadsafe(_cancel_all)
        self._thread.join(timeout)


async def lag_monitor(interval_s: float = _LAG_INTERVAL_S) -> None:
    """Periodic timer observing its own scheduling lag into
    RPC_LOOP_LAG. Cancelled by EventLoopThread.stop()."""
    loop = asyncio.get_running_loop()
    while True:
        deadline = loop.time() + interval_s
        await asyncio.sleep(interval_s)
        RPC_LOOP_LAG.observe(max(loop.time() - deadline, 0.0))


class FramedRpcServer:
    """The framed-RPC unix-socket listener.

    ``dispatch(method_id, body) -> bytes`` is the blocking handler
    (decode + driver callback + encode), run on `pool` — one executor
    task per request, never on the loop. Per-connection requests are
    processed in order (the client blocks on its response), so
    concurrency equals client connections — which is exactly how the
    sustained-load bench keeps the admission window and the journal
    barrier queue full."""

    def __init__(self, path: str, dispatch: Callable[[int, bytes], bytes],
                 pool: ThreadPoolExecutor):
        self.path = path
        self._dispatch = dispatch
        self._pool = pool
        self._server: Optional[asyncio.AbstractServer] = None
        # Open client connections (loop thread only).
        self._writers: Set[asyncio.StreamWriter] = set()

    async def start(self) -> None:
        self._server = await asyncio.start_unix_server(
            self._serve_conn, path=self.path)

    async def stop(self) -> None:
        """Stop listening and close every client connection: since
        Python 3.12 wait_closed() waits for the connections too, and an
        idle client (one between RPCs, or a kubelet that keeps its
        connection) would hold a restart until the caller's timeout. The
        driver drains in-flight RPCs before it stops the server; a
        client that finds its connection closed redials."""
        if self._server is not None:
            self._server.close()
            for writer in list(self._writers):
                writer.close()
            await self._server.wait_closed()

    async def _serve_conn(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        loop = asyncio.get_running_loop()
        self._writers.add(writer)
        try:
            while True:
                header = await reader.readexactly(FRAME_HEADER.size)
                length, method = FRAME_HEADER.unpack(header)
                if length > MAX_FRAME_BYTES:
                    payload = f"frame of {length} bytes exceeds " \
                              f"{MAX_FRAME_BYTES}".encode()
                    writer.write(FRAME_HEADER.pack(len(payload),
                                                   METHOD_ERROR) + payload)
                    await writer.drain()
                    break
                body = await reader.readexactly(length)
                if method == METHOD_PING:
                    writer.write(FRAME_HEADER.pack(0, METHOD_PING))
                    await writer.drain()
                    continue
                _inflight_adjust(+1)
                try:
                    try:
                        payload = await loop.run_in_executor(
                            self._pool, self._dispatch, method, body)
                        out_method = method
                    except Exception as e:  # noqa: BLE001 — one bad
                        # request must fail ITS response, not the conn
                        payload = str(e).encode()
                        out_method = METHOD_ERROR
                finally:
                    _inflight_adjust(-1)
                writer.write(FRAME_HEADER.pack(len(payload), out_method)
                             + payload)
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionResetError,
                BrokenPipeError):
            pass  # drflow: swallow-ok[client closed the connection —
            # the disconnect IS the protocol's end-of-stream]
        finally:
            self._writers.discard(writer)
            writer.close()


_inflight_lock = threading.Lock()
_inflight_count = 0


def _inflight_adjust(delta: int) -> None:
    """Process-wide in-flight counter feeding SUSTAINED_INFLIGHT (the
    gauge spans every front-end instance in the process; the bench and
    tests read one number). The gauge set happens INSIDE the counter
    lock: set-after-release would let two finishing RPCs publish out
    of order and park a stale nonzero value on an idle front-end."""
    global _inflight_count
    with _inflight_lock:
        _inflight_count += delta
        SUSTAINED_INFLIGHT.set(_inflight_count)


def aio_service_handlers(services: Dict[str, Dict[str, tuple]],
                         pool: ThreadPoolExecutor):
    """Build grpc.aio generic handlers from {service: {method:
    (sync_behavior, req_deserializer, resp_serializer)}}.

    Each async behavior awaits the SYNC behavior on the executor — the
    whole blocking handler (pipeline admission, flock, group commit)
    stays off the loop, and runs on one executor thread end-to-end so
    the driver's thread-local wire attribution pairs correctly."""
    import grpc

    out = []
    for service_name, methods in services.items():
        handlers = {}
        for method_name, (behavior, req_des, resp_ser) in methods.items():
            async def call(request, context, _behavior=behavior):
                loop = asyncio.get_running_loop()
                _inflight_adjust(+1)
                try:
                    return await loop.run_in_executor(pool, _behavior,
                                                      request)
                finally:
                    _inflight_adjust(-1)

            handlers[method_name] = grpc.unary_unary_rpc_method_handler(
                call, request_deserializer=req_des,
                response_serializer=resp_ser)
        out.append(grpc.method_handlers_generic_handler(service_name,
                                                        handlers))
    return out
