"""Runtime lock-order witness (counterpart of tpu_dra/infra/lockwitness.py).

What static rules cannot see is the ACQUISITION ORDER two threads impose
on a pair of locks. This module is a lockdep-style witness: an opt-in
instrumented Lock/RLock that records, per thread, the stack of held
locks and adds an edge ``A -> B`` to a process-global graph whenever B
is acquired while A is held. A cycle in that graph is a potential
deadlock — two threads CAN interleave into it even if this run did not
— and is recorded as a violation the moment the closing edge appears.
Hold times are tracked per lock class so "I/O crept under a lock"
pathologies show up as outliers even when no cycle forms.

Lock identity is the CREATION SITE (``file:line`` of the allocation),
not the instance: a scheduler with 5 informers has 5 instances of one
lock class, and ordering rules are per-class (as in lockdep). Nested
acquisition of two instances of the SAME class (per-GPU locks taken in
sorted order) is recorded separately as a self-nest, not a cycle —
ordered same-class acquisition is the holder's documented
responsibility, the witness can't prove the sort.

``install()`` (refcounted) monkeypatches ``threading.Lock`` /
``threading.RLock`` so locks *subsequently created by tpu_dra_torch
code* are witnessed; stdlib- and third-party-created locks (Condition
internals, torch) pass through raw. The chaos harnesses install it for
every walk and assert an acyclic graph at quiesce. ``export_edges`` /
``load_edges`` carry the observed edge set to a file
(``TPU_DRA_LOCK_WITNESS_EXPORT``), and ``set_yield_hook`` lets a
controlled scheduler see every witnessed acquire and release.

The copy differs from the reference in three ways only, so that both
witnesses can live in one process (the reference's is installed for a
whole test session under ``TPU_DRA_LOCK_WITNESS=1``):

- the raw constructors are taken from ``threading`` at import, as the
  reference takes them, only while ``threading.Lock`` is still
  ``_thread.allocate_lock``; if another witness had patched ``threading``
  by then, its factories are passed over for ``_thread``'s own;
- the creation key matches ``tpu_dra_torch/`` frames only (the
  reference's matches any path holding ``tpu_dra``, this package's
  too);
- the last ``uninstall()`` restores the constructors this witness
  replaced at its first ``install()``, and only while its own factories
  are still in place: if another witness patched or restored over them
  meanwhile, that one owns ``threading.Lock`` and it is left alone.
"""

from __future__ import annotations

import _thread
import json
import os
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

# The module-level alias of threading.Lock is what a static lock-order
# graph reads as this witness's lock creation site.
_real_lock = threading.Lock
_real_rlock = threading.RLock
if _real_lock is not _thread.allocate_lock:
    _real_lock, _real_rlock = _thread.allocate_lock, _thread.RLock


@dataclass
class _ClassStats:
    acquisitions: int = 0
    max_hold_s: float = 0.0
    self_nests: int = 0


@dataclass
class _Edge:
    thread: str
    count: int = 0


class LockWitness:
    """Process-global acquisition-order graph + per-class hold stats."""

    def __init__(self):
        self._graph_lock = _real_lock()
        self._edges: Dict[Tuple[str, str], _Edge] = {}
        self._stats: Dict[str, _ClassStats] = {}
        self._violations: List[str] = []
        self._seen_cycles: Set[Tuple[str, ...]] = set()
        self._tls = threading.local()
        # instance -> the held-stack entry of the thread that acquired
        # it. A plain Lock may be released by another thread (a
        # SharedFlock's last holder out releases the Flock a first
        # holder took): that release ends the acquirer's hold, or every
        # lock the acquirer takes afterwards would read as nested in it.
        self._holds: Dict[int, dict] = {}

    # -- per-thread held stack ----------------------------------------------

    def _held(self) -> List[dict]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        elif held and any("gone" in e for e in held):
            held[:] = [e for e in held if "gone" not in e]
        return held

    def _close_hold(self, key: str, entry: dict) -> None:
        dt = time.monotonic() - entry["t0"]
        with self._graph_lock:
            st = self._stats.setdefault(key, _ClassStats())
            if dt > st.max_hold_s:
                st.max_hold_s = dt

    # -- events from witnessed locks ----------------------------------------

    def acquired(self, key: str, instance: int) -> None:
        held = self._held()
        for entry in held:
            if entry["instance"] == instance:
                entry["depth"] += 1  # RLock reentry: no new edge, no push
                return
        new_edges: List[Tuple[str, str]] = []
        self_nest = False
        for entry in held:
            if entry["key"] == key:
                self_nest = True
            else:
                new_edges.append((entry["key"], key))
        entry = {"key": key, "instance": instance, "depth": 1,
                 "t0": time.monotonic()}
        held.append(entry)
        self._holds[instance] = entry
        if not (new_edges or self_nest):
            with self._graph_lock:
                self._stats.setdefault(key, _ClassStats()).acquisitions += 1
            return
        tname = threading.current_thread().name
        with self._graph_lock:
            st = self._stats.setdefault(key, _ClassStats())
            st.acquisitions += 1
            if self_nest:
                st.self_nests += 1
            for src, dst in new_edges:
                edge = self._edges.get((src, dst))
                if edge is None:
                    self._edges[(src, dst)] = _Edge(thread=tname, count=1)
                    self._check_cycle_locked(src, dst)
                else:
                    edge.count += 1

    def released(self, key: str, instance: int) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            entry = held[i]
            if entry["instance"] == instance:
                entry["depth"] -= 1
                if entry["depth"] == 0:
                    del held[i]
                    self._holds.pop(instance, None)
                    self._close_hold(key, entry)
                return
        # Released by a thread that did not acquire it: end the
        # acquirer's hold (its own thread drops the entry at its next
        # witnessed operation). A lock acquired before install() has no
        # entry anywhere: nothing to do.
        entry = self._holds.pop(instance, None)
        if entry is not None:
            entry["gone"] = True
            self._close_hold(key, entry)

    def force_release(self, key: str, instance: int) -> int:
        """Condition._release_save seam: the inner RLock is FULLY
        released regardless of recursion depth — drop the whole entry
        (closing its hold window) and return the depth so
        force_acquire can restore it after the wait."""
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            entry = held[i]
            if entry["instance"] == instance:
                del held[i]
                self._holds.pop(instance, None)
                self._close_hold(key, entry)
                return entry["depth"]
        return 1

    def force_acquire(self, key: str, instance: int, depth: int) -> None:
        """Condition._acquire_restore seam: re-enter at full depth."""
        self.acquired(key, instance)
        for entry in self._held():
            if entry["instance"] == instance:
                entry["depth"] = depth
                return

    # -- cycle detection ------------------------------------------------------

    def _check_cycle_locked(self, src: str, dst: str) -> None:
        """A new edge src->dst closes a cycle iff dst already reaches
        src. Runs under self._graph_lock at edge-insertion time, so the first
        interleaving that COULD deadlock is reported even if this run
        sailed through."""
        path = self._find_path_locked(dst, src)
        if path is None:
            return
        cycle = [src] + path  # src -> dst -> ... -> src
        nodes = cycle[:-1]
        canon = min(tuple(nodes[i:] + nodes[:i])
                    for i in range(len(nodes)))
        if canon in self._seen_cycles:
            return
        self._seen_cycles.add(canon)
        self._violations.append(
            "lock-order cycle (potential deadlock): "
            + " -> ".join(cycle)
            + f" (closing edge {src} -> {dst} added by thread "
            + threading.current_thread().name + ")")

    def _find_path_locked(self, start: str,
                          goal: str) -> Optional[List[str]]:
        stack: List[Tuple[str, List[str]]] = [(start, [start])]
        seen = {start}
        adj: Dict[str, List[str]] = {}
        for (s, d) in self._edges:
            adj.setdefault(s, []).append(d)
        while stack:
            node, path = stack.pop()
            if node == goal:
                return path
            for nxt in adj.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    # -- reporting ------------------------------------------------------------

    def edges(self) -> Dict[Tuple[str, str], int]:
        with self._graph_lock:
            return {k: e.count for k, e in self._edges.items()}

    def cycles(self) -> List[str]:
        with self._graph_lock:
            return list(self._violations)

    @staticmethod
    def _format_outlier(key: str, st: _ClassStats,
                        max_hold_s: float) -> str:
        return (f"lock {key} held for {st.max_hold_s * 1e3:.1f}ms "
                f"(> {max_hold_s * 1e3:.0f}ms outlier threshold; "
                "blocking work crept under a data lock?)")

    def _outliers_locked(self, max_hold_s: float,
                         base: Optional[Dict[str, float]] = None
                         ) -> List[str]:
        """Outlier lines; with `base`, only classes whose max hold GREW
        past the threshold since that snapshot. Caller holds _graph_lock."""
        return [self._format_outlier(key, st, max_hold_s)
                for key, st in sorted(self._stats.items())
                if st.max_hold_s > max_hold_s
                and (base is None or st.max_hold_s > base.get(key, 0.0))]

    def hold_outliers(self, max_hold_s: float) -> List[str]:
        with self._graph_lock:
            return self._outliers_locked(max_hold_s)

    def violations(self, max_hold_s: Optional[float] = None) -> List[str]:
        """Cycles (always) plus hold-time outliers (when a threshold is
        given) — the chaos-invariant seam."""
        out = self.cycles()
        if max_hold_s is not None:
            out.extend(self.hold_outliers(max_hold_s))
        return out

    def snapshot(self) -> Dict:
        """Opaque window marker for violations_since: under a
        session-level install (TPU_DRA_LOCK_WITNESS=1) the graph is
        never reset, so a harness must report only what ITS walk added."""
        with self._graph_lock:
            return {"cycles": len(self._violations),
                    "max_hold": {k: s.max_hold_s
                                 for k, s in self._stats.items()}}

    def violations_since(self, snap: Dict,
                         max_hold_s: Optional[float] = None) -> List[str]:
        """violations() restricted to what happened after `snap`:
        cycles recorded since, plus classes whose max hold GREW past
        the threshold inside the window (a pre-window outlier whose max
        did not move is someone else's violation)."""
        base = snap.get("max_hold", {})
        with self._graph_lock:
            out = list(self._violations[snap.get("cycles", 0):])
            if max_hold_s is not None:
                out.extend(self._outliers_locked(max_hold_s, base=base))
        return out

    def stats(self) -> Dict[str, Dict]:
        with self._graph_lock:
            return {k: {"acquisitions": s.acquisitions,
                        "max_hold_ms": round(s.max_hold_s * 1e3, 3),
                        "self_nests": s.self_nests}
                    for k, s in sorted(self._stats.items())}

    def reset(self) -> None:
        """Drop graph + stats (NOT per-thread held stacks: locks held
        across a reset simply stop contributing edges)."""
        with self._graph_lock:
            self._edges.clear()
            self._stats.clear()
            self._violations.clear()
            self._seen_cycles.clear()


WITNESS = LockWitness()


# ---------------------------------------------------------------------------
# Edge export
# ---------------------------------------------------------------------------
# A chaos matrix or a model-checker run dumps the edge set it OBSERVED,
# for a static analysis to hold against its own lock-order graph.
# Exports MERGE: several processes accumulate into one file, so the
# check sees the union of everything that ran.
# ``TPU_DRA_LOCK_WITNESS_EXPORT=<path>`` makes the export automatic at
# the final uninstall() of each generation (chaos harness close).

EXPORT_ENV = "TPU_DRA_LOCK_WITNESS_EXPORT"

# (path, frozenset(edges)) of the last auto-export: a model checker
# installs and uninstalls around EVERY explored schedule, and a
# read-merge-rewrite per schedule would be redundant IO — the
# refcount-zero flush skips when nothing changed.
_last_export: Optional[Tuple[str, frozenset]] = None


def export_edges(path: Optional[str] = None,
                 only_if_changed: bool = False) -> Optional[str]:
    """Merge the witness's observed edge set into the JSON file at
    `path` (default: $TPU_DRA_LOCK_WITNESS_EXPORT; no-op returning None
    when neither names a destination). Best-effort: an unwritable
    export path must not take down the harness that observed the
    edges — the gate reading the file is where absence gets loud."""
    global _last_export
    path = path or os.environ.get(EXPORT_ENV)
    if not path:
        return None
    edges = {(s, d) for (s, d) in WITNESS.edges()}
    own = frozenset(edges)  # pre-merge: the signature is OUR edges only
    if only_if_changed and _last_export == (path, own):
        return path
    try:
        with open(path, encoding="utf-8") as fh:
            doc = json.load(fh)
        for e in doc.get("edges", ()):
            if isinstance(e, list) and len(e) == 2:
                edges.add((e[0], e[1]))
    except (OSError, ValueError):
        pass
    # Tmp + rename: a failed write (ENOSPC) must leave the previous
    # accumulation intact — truncating it in place would let the NEXT
    # exporter silently restart the merge from its own edges alone.
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump({"edges": sorted(list(e) for e in edges)}, fh,
                      indent=0)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None
    _last_export = (path, own)
    return path


def load_edges(path: str) -> List[Tuple[str, str]]:
    """The exported edge set, as (src, dst) creation-site pairs."""
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    return [(e[0], e[1]) for e in doc.get("edges", ())
            if isinstance(e, list) and len(e) == 2]


# ---------------------------------------------------------------------------
# Yield-point hook (a controlled scheduler's seam)
# ---------------------------------------------------------------------------
# The witness's instrumentation points double as a deterministic model
# checker's yield points: when a hook is set,
# every witnessed acquire/release first reports to it. The hook decides
# whether the calling thread is under controlled scheduling — for a
# controlled thread, "lock.acquire" BLOCKS until the cooperative
# scheduler grants the op (and guarantees the lock is model-free, so
# the real acquire below cannot block); uncontrolled threads pass
# through untouched. Events:
#   lock.acquire  — before the real acquire (the schedulable point)
#   lock.acquired — after a successful acquire (model bookkeeping only)
#   lock.release  — before the real release (model-release on grant)

_yield_hook = None


def set_yield_hook(fn) -> None:
    global _yield_hook
    _yield_hook = fn


def clear_yield_hook() -> None:
    global _yield_hook
    _yield_hook = None


# ---------------------------------------------------------------------------
# Instrumented locks
# ---------------------------------------------------------------------------

class _WitnessBase:
    """Wraps a real lock; reports acquire/release to WITNESS. Undeclared
    attributes delegate to the inner lock so Condition & friends keep
    working when handed one explicitly."""

    def __init__(self, inner, key: str):
        self._inner = inner
        self._key = key

    def acquire(self, blocking: bool = True, timeout: float = -1):
        hook = _yield_hook
        if hook is not None:
            hook("lock.acquire", self._key, id(self), blocking)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            if hook is not None:
                hook("lock.acquired", self._key, id(self), blocking)
            WITNESS.acquired(self._key, id(self))
        return ok

    def release(self) -> None:
        hook = _yield_hook
        if hook is not None:
            hook("lock.release", self._key, id(self), True)
        self._inner.release()
        WITNESS.released(self._key, id(self))

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self._key} {self._inner!r}>"


class WitnessLock(_WitnessBase):
    def locked(self) -> bool:
        return self._inner.locked()


class WitnessRLock(_WitnessBase):
    # threading.Condition probes these when handed an RLock explicitly.
    def _is_owned(self) -> bool:
        return self._inner._is_owned()

    def _release_save(self):
        hook = _yield_hook
        if hook is not None:
            # Full-depth release (cond.wait entry): the model must drop
            # the whole ownership or a controlled sibling could never
            # acquire past the "held" entry of a parked waiter.
            hook("lock.release_save", self._key, id(self), True)
        state = self._inner._release_save()
        # The inner RLock is now FULLY released whatever the recursion
        # depth: close the hold window entirely, or a reentrant
        # cond.wait() would be booked as one long lock hold.
        depth = WITNESS.force_release(self._key, id(self))
        return (state, depth)

    def _acquire_restore(self, state) -> None:
        hook = _yield_hook
        if hook is not None:
            hook("lock.acquire", self._key, id(self), True)
        inner_state, depth = state
        self._inner._acquire_restore(inner_state)
        if hook is not None:
            hook("lock.acquired", self._key, id(self), True)
        WITNESS.force_acquire(self._key, id(self), depth)


# ---------------------------------------------------------------------------
# Opt-in install (refcounted monkeypatch)
# ---------------------------------------------------------------------------

_install_mu = _real_lock()
_install_count = 0
# The threading.Lock / threading.RLock values the first install of a
# generation replaced (the originals, or another witness's factories).
_replaced: Optional[Tuple[object, object]] = None

_PACKAGE = "tpu_dra_torch" + os.sep


def _creation_key(depth: int = 2) -> Optional[str]:
    """``file:line`` of the tpu_dra_torch frame allocating the lock, or
    None for foreign code (left unwitnessed)."""
    try:
        frame = sys._getframe(depth)
    except ValueError:
        return None
    fn = frame.f_code.co_filename
    idx = fn.rfind(_PACKAGE)
    if idx < 0 or "lockwitness" in fn:
        return None
    return f"{fn[idx:].replace(os.sep, '/')}:{frame.f_lineno}"


def _lock_factory():
    key = _creation_key()
    if key is None:
        return _real_lock()
    return WitnessLock(_real_lock(), key)


def _rlock_factory():
    key = _creation_key()
    if key is None:
        return _real_rlock()
    return WitnessRLock(_real_rlock(), key)


def install(reset: bool = True) -> None:
    """Start witnessing locks created from here on by tpu_dra_torch code.
    Refcounted: nested harnesses install/uninstall freely; the first
    install of a generation resets the graph (unless reset=False)."""
    global _install_count, _replaced
    with _install_mu:
        if _install_count == 0:
            if reset:
                WITNESS.reset()
            _replaced = (threading.Lock, threading.RLock)
            threading.Lock = _lock_factory
            threading.RLock = _rlock_factory
        _install_count += 1


def uninstall() -> None:
    global _install_count, _replaced
    with _install_mu:
        if _install_count == 0:
            return
        _install_count -= 1
        if _install_count == 0:
            # Restore what the first install replaced, unless another
            # witness has patched (or restored) over our factories since:
            # then it owns the constructors and undoes them itself.
            if threading.Lock is _lock_factory:
                threading.Lock = _replaced[0]
            if threading.RLock is _rlock_factory:
                threading.RLock = _replaced[1]
            _replaced = None
            last_out = True
        else:
            last_out = False
    if last_out:
        # The generation's graph is complete: flush it (no-op unless the
        # env names a file; skipped when the merged edge set already
        # matches the last flush).
        export_edges(only_if_changed=True)


def installed() -> bool:
    with _install_mu:
        return _install_count > 0
