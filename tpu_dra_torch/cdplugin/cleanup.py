"""CD plugin checkpoint + domain-dir garbage collection (counterpart of
tpu_dra/cdplugin/cleanup.py).

Periodic GC of ``PrepareStarted`` (partially prepared) claims whose
ResourceClaim no longer exists in the API server (compared by name+UID,
so a recreated same-name claim is not collected), plus the per-CD
config-dir sweep.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, Optional

from tpu_dra_torch.cdplugin.computedomain import ComputeDomainManager
from tpu_dra_torch.cdplugin.device_state import DeviceState
from tpu_dra_torch.k8s import ApiClient, RESOURCECLAIMS
from tpu_dra_torch.k8s.client import NotFoundError
from tpu_dra_torch.gpuplugin.checkpoint import PREPARE_STARTED

log = logging.getLogger("tpu_dra_torch.cdplugin.cleanup")


class CheckpointCleanup:
    def __init__(self, *, client: ApiClient, state: DeviceState,
                 cd_manager: ComputeDomainManager,
                 interval: float = 600.0):
        self._client = client
        self._state = state
        self._cd = cd_manager
        self._interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="cd-ckpt-gc")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self.sweep()
            except Exception:  # noqa: BLE001 — GC must not die
                log.exception("checkpoint GC failed")

    def sweep(self) -> int:
        """Collect abandoned PrepareStarted claims; returns count."""
        collected = 0
        snapshot = self._state.checkpoint_snapshot()
        # Lazily-built uid index over ONE cluster-wide LIST per sweep:
        # only legacy records need it, and N of them must not cost N lists.
        uid_index: Optional[Dict[str, Dict]] = None
        for uid, prepared in list(snapshot.claims.items()):
            if prepared.state != PREPARE_STARTED:
                continue
            if not prepared.name:
                # Legacy (V1-era) record without claim identity: backfill
                # it from the API server by UID. Found -> record becomes
                # collectible on a later
                # sweep once the claim disappears; not found anywhere ->
                # the claim is gone and the record is abandoned now.
                if uid_index is None:
                    uid_index = {c["metadata"].get("uid", ""): c
                                 for c in self._client.list(RESOURCECLAIMS)}
                match = uid_index.get(uid)
                if match is not None:
                    if self._state.backfill_claim_identity(
                            uid, match["metadata"]["name"],
                            match["metadata"].get("namespace", "")):
                        log.info("backfilled legacy checkpoint identity "
                                 "for claim %s (%s/%s)", uid,
                                 match["metadata"].get("namespace", ""),
                                 match["metadata"]["name"])
                    # else: record unprepared between snapshot and now —
                    # nothing was written, nothing to collect.
                    continue  # claim still exists: kubelet will retry
                if self._state.drop_claim(uid):
                    log.info("GC abandoned legacy claim %s", uid)
                    collected += 1
                continue
            try:
                obj = self._client.get(RESOURCECLAIMS, prepared.name,
                                       prepared.namespace)
                if obj["metadata"].get("uid") == uid:
                    continue  # claim still exists: kubelet will retry
            except NotFoundError:
                pass
            if self._state.drop_claim(uid):
                log.info("GC abandoned PrepareStarted claim %s (%s/%s)",
                         uid, prepared.namespace, prepared.name)
                collected += 1
        self._cd.gc_domain_dirs()
        return collected
