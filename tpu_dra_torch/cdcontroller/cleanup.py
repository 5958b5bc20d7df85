"""Generic stale-object garbage collection (counterpart of
tpu_dra/cdcontroller/cleanup.py).

Periodic (10 min) + on-demand GC: any object labeled with a
ComputeDomain UID whose CD no longer exists is deleted (finalizers
stripped first if needed). A size-1 dedup flag coalesces on-demand
requests.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, List, Optional, Tuple

from tpu_dra_torch.api import types as apitypes
from tpu_dra_torch.k8s import ApiClient
from tpu_dra_torch.k8s.client import GVR, NotFoundError

log = logging.getLogger("tpu_dra_torch.cdcontroller.cleanup")


class CleanupManager:
    def __init__(self, *, client: ApiClient,
                 cd_exists: Callable[[str], bool],
                 targets: List[Tuple[GVR, Optional[str]]],
                 interval: float = 600.0,
                 extra_sweeps: Optional[List[Callable[[], None]]] = None):
        self._client = client
        self._cd_exists = cd_exists
        self._targets = targets
        self._interval = interval
        self._extra = extra_sweeps or []
        self._stop = threading.Event()
        self._kick = threading.Event()  # size-1 dedup: a set flag is "queued"
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="cd-cleanup")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._kick.set()
        if self._thread:
            self._thread.join(timeout=5)

    def request(self) -> None:
        """On-demand sweep; duplicate requests coalesce."""
        self._kick.set()

    def collect_uid(self, uid: str) -> None:
        """Immediate targeted GC for one departed CD."""
        self._collect(lambda u: u == uid)

    def _run(self) -> None:
        while not self._stop.is_set():
            self._kick.wait(timeout=self._interval)
            self._kick.clear()
            if self._stop.is_set():
                return
            try:
                self.sweep()
            except Exception:  # noqa: BLE001 — GC must not die
                log.exception("cleanup sweep failed")

    def sweep(self) -> None:
        self._collect(lambda uid: not self._cd_exists(uid))
        for fn in self._extra:
            fn()

    def _collect(self, is_stale: Callable[[str], bool]) -> None:
        for gvr, ns in self._targets:
            try:
                objs = self._client.list(
                    gvr, namespace=ns,
                    label_selector=apitypes.COMPUTE_DOMAIN_LABEL_KEY)
            except NotFoundError:
                continue
            for obj in objs:
                uid = (obj["metadata"].get("labels") or {}).get(
                    apitypes.COMPUTE_DOMAIN_LABEL_KEY, "")
                if not uid or not is_stale(uid):
                    continue
                meta = obj["metadata"]
                log.info("GC stale %s %s/%s (cd %s)", gvr.plural,
                         meta.get("namespace", ""), meta["name"], uid)
                if meta.get("finalizers"):
                    meta["finalizers"] = []
                    try:
                        self._client.update(gvr, obj,
                                            namespace=meta.get("namespace"))
                    except NotFoundError:
                        continue
                self._client.delete(gvr, meta["name"], meta.get("namespace"))
