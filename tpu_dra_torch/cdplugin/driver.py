"""Retry-aware CD plugin driver (counterpart of
tpu_dra/cdplugin/driver.py).

Every claim is retried with backoff inside a 45 s envelope (kubelet
re-calls prepare until the pod leaves ContainerCreating, so returning an
error after 45 s is safe and keeps the retry loop responsive); a
``PermanentError`` short-circuits. Claims are processed concurrently
because daemon-prepare and channel-prepare are co-dependent: the channel
claim's readiness wait can only resolve once the daemon pod (whose own
claim prepares through this same server) is up.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

from tpu_dra_torch.cdplugin.computedomain import PermanentError, RetryableNotReady
from tpu_dra_torch.cdplugin.device_state import DeviceState
from tpu_dra_torch.infra.metrics import DefaultRegistry
from tpu_dra_torch.k8s import ApiClient, RESOURCECLAIMS
from tpu_dra_torch.k8s.client import NotFoundError
from tpu_dra_torch.kubeletplugin.server import (
    Claim, DRAPluginServer, DriverCallbacks, PrepareResult, publish_resources,
)
from tpu_dra_torch.cdplugin.deviceinfo import published_devices

log = logging.getLogger("tpu_dra_torch.cdplugin")

ERROR_RETRY_MAX_TIMEOUT = 45.0

cd_prepare_seconds = DefaultRegistry.histogram(
    "tpu_dra_cd_claim_prepare_seconds",
    "CD plugin per-claim prepare latency (includes readiness wait)")


class CDDriver(DriverCallbacks):
    def __init__(self, *, state: DeviceState, client: ApiClient,
                 driver_name: str, node_name: str, clique_id: str,
                 plugin_dir: str, registry_dir: Optional[str] = None,
                 retry_timeout: float = ERROR_RETRY_MAX_TIMEOUT):
        self._state = state
        self._client = client
        self._driver_name = driver_name
        self._node_name = node_name
        self._clique_id = clique_id
        self._retry_timeout = retry_timeout
        self.server = DRAPluginServer(
            driver_name=driver_name, node_name=node_name, callbacks=self,
            plugin_dir=plugin_dir, registry_dir=registry_dir)

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        self.server.start()
        self.publish_resources()

    def shutdown(self) -> None:
        self.server.stop()

    def publish_resources(self) -> None:
        publish_resources(self._client, self._driver_name, self._node_name,
                          published_devices(self._clique_id))

    # -- DRA callbacks ------------------------------------------------------

    def prepare_claims(self, claims: List[Claim]) -> Dict[str, PrepareResult]:
        """Concurrent per-claim preparation."""
        results: Dict[str, PrepareResult] = {}
        threads = []
        lock = threading.Lock()

        def work(claim: Claim) -> None:
            res = self._prepare_with_retry(claim)
            with lock:
                results[claim.uid] = res

        for claim in claims:
            t = threading.Thread(target=work, args=(claim,),
                                 name=f"cd-prepare-{claim.uid[:8]}")
            t.start()
            threads.append(t)
        for t in threads:
            t.join()
        return results

    def unprepare_claims(self, claims: List[Claim]) -> Dict[str, str]:
        errors: Dict[str, str] = {}
        for claim in claims:
            err = self._state.unprepare(claim.uid)
            errors[claim.uid] = err or ""
        return errors

    # -- retry envelope -----------------------------------------------------

    def _prepare_with_retry(self, claim: Claim) -> PrepareResult:
        """Retry ladder: the CD-daemon rate-limiter preset (5ms–6s expo
        with 0.5 relative jitter) inside the retry envelope. The fast base
        matters: the CD readiness dance usually converges in hundreds of
        ms (daemon pod start + status registration), and a coarse 250ms
        ladder would make backoff sleep the dominant term of the whole CD
        claim-to-ready time."""
        from tpu_dra_torch.infra.workqueue import default_cd_daemon_rate_limiter

        t0 = time.monotonic()
        deadline = t0 + self._retry_timeout
        limiter = default_cd_daemon_rate_limiter()
        attempt = 0
        # Per-CD change generation (learned from the first retryable
        # failure): `seen` from the PREVIOUS wait, so a CD event landing
        # while an attempt runs makes the next wait return immediately.
        seen = None
        cd_uid = ""
        while True:
            attempt += 1
            try:
                obj = self._fetch_claim(claim)
                result = self._state.prepare(obj)
                cd_prepare_seconds.observe(time.monotonic() - t0)
                return result
            except PermanentError as e:
                return PrepareResult(error=f"permanent: {e}")
            except RetryableNotReady as e:
                now = time.monotonic()
                if now >= deadline:
                    return PrepareResult(
                        error=f"retry budget exhausted after {attempt} "
                              f"attempts: {e}")
                log.debug("claim %s not ready (attempt %d): %s",
                          claim.uid, attempt, e)
                if getattr(e, "cd_uid", "") and e.cd_uid != cd_uid:
                    cd_uid, seen = e.cd_uid, None
                # Event-driven wake: readiness converges at watch latency;
                # the ladder delay is only the no-event fallback, clipped
                # to the remaining budget (a 6s ladder rung must not
                # forfeit a deadline an event would have beaten).
                delay = min(limiter.when(0), deadline - now)
                seen = self._state.wait_cd_change(cd_uid, seen, delay)
            except Exception as e:  # noqa: BLE001 — unexpected: report
                return PrepareResult(error=f"prepare: {e}")

    def _fetch_claim(self, claim: Claim) -> Dict:
        try:
            obj = self._client.get(RESOURCECLAIMS, claim.name,
                                   claim.namespace)
        except NotFoundError as e:
            raise PermanentError(
                f"resourceclaim {claim.namespace}/{claim.name} not found"
            ) from e
        if obj["metadata"].get("uid") != claim.uid:
            raise PermanentError(
                f"claim UID mismatch for {claim.namespace}/{claim.name}")
        return obj
