"""drflow: interprocedural escape, atomicity and error-flow analysis.

Three defect classes repeatedly bit this codebase and stayed outside
the existing rule families' reach (SURVEY §20): zero-copy informer
views escaping into helpers that mutate them (R3's statement-order
taint stops at the function boundary), check-then-act atomicity
violations across lock releases (draracer sees the LOCKS, not the
staleness of the data read under them — the exact bug family drmc's
racy-index fixture replays), and silently-swallowed exceptions. drflow
is the combined dataflow rule family covering them, built on
draracer's whole-tree ``TreeResolver`` (module-qualified resolution,
CHA, callback points-to) and the SAME per-module extraction blob
(``facts_key = "R9"``: the cache stores it once, both rules absorb it).

- **R13 — whole-tree view escape analysis.** A lister/get_by_index
  result is a VIEW of live informer-cache state (SURVEY §10). R13
  lifts R3's taint to the tree: a view flowing through call arguments,
  returns, container stores (``self._cache[k] = view``,
  ``acc.append(view)``) and closure captures must reach only read-only
  sinks. ``copy.deepcopy`` / ``json_deepcopy`` (one shared predicate
  with R3, alias-aware — ``rules.is_laundering_chain``) launder a view
  into a private object; ``# drflow: view-ok[reason]`` marks a
  sanctioned hatch. Findings carry the seed site (where the view was
  read) so runtime view-shadow drift (k8s.informer.viewshadow) can be
  cross-validated observed⊆static: every drift site must be a
  statically implicated seed (``check_view_shadow``).

- **R14 — stale-snapshot check-then-act.** A value read under a data
  lock goes STALE the moment the lock releases — by leaving the
  ``with`` body, or by being RETURNED out of a locked getter (the
  interprocedural seed). Guarding on that stale value and then writing
  the same state it was derived from, without re-validation, is the
  lost-update/TOCTOU shape. Re-validation is recognized structurally:
  a live re-read of the same attribute under the lock between check
  and act, an act callee that re-reads it under its own lock, or a
  callee annotated ``# drflow: REVALIDATES:<field>`` (the scheduler's
  snapshot→try_commit protocol, documented rather than suppressed).

- **R15 — swallowed-exception audit.** Every BROAD handler (bare
  ``except``, ``except Exception``/``BaseException``) must do
  SOMETHING with the error: re-raise, use the bound exception value,
  increment a metric, log, or call a degrade-path helper.
  ``# drflow: swallow-ok[reason]`` sanctions a deliberate swallow —
  the reason is mandatory. Handlers whose try body guards a registered
  fault site with a declared degradation (``DEGRADATIONS`` in
  infra/faults.py) must additionally route to that degradation or
  re-raise: an injected fault that only gets logged is a failure mode
  chaos thinks is covered but production quietly eats.

Annotation grammar (SURVEY §20): ``# drflow: view-ok[reason]``,
``# drflow: swallow-ok[reason]``, ``# drflow: REVALIDATES:<field>``
(``*`` = everything it touches), parsed by the shared extraction and
matched on the finding's line or the line above (view/swallow) or the
``def`` line (REVALIDATES).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from tpu_dra_torch.analysis.core import (
    Finding, Module, ProjectContext, Rule, register,
)
from tpu_dra_torch.analysis.raceanalysis import (
    TreeResolver, extract_module, shared_resolver,
)
from tpu_dra_torch.analysis.rules import attr_chain, is_laundering_chain

# R3's propagation vocabulary, shared verbatim so intra- and
# inter-procedural taint agree on what carries a view along.
from tpu_dra_torch.analysis.rules import (  # noqa: E402
    _PROPAGATORS, _READERS, _VIEW_TAILS,
)

# Container-store method names: calling one with a tainted argument
# makes the receiver a container OF views (elements are views; the
# container itself may be restructured freely).
_CONTAINER_STORES = {"append", "add", "insert", "setdefault", "extend",
                     "update"}

# Taint fixpoint bound: chains in this tree are shallow (a view rarely
# crosses more than 3-4 hops); the bound only guards pathological
# fixtures from hanging lint.
_MAX_ROUNDS = 12

# -- R15 discipline vocabulary ----------------------------------------------

_BROAD_EXC = {"Exception", "BaseException"}
_LOG_TAILS = {"print", "print_exc", "exception", "warning", "warn",
              "error", "critical", "info", "debug", "log"}
_METRIC_TAILS = {"inc", "observe"}
_DEGRADE_RE = re.compile(
    r"degrade|quarantin|requeue|backoff|abort|wedge|unwind|rollback|"
    r"restore|reinsert|evict|unhealthy|supersede|kill", re.IGNORECASE)


# ---------------------------------------------------------------------------
# Descriptor helpers
# ---------------------------------------------------------------------------

def _desc_chain_loose(desc: Optional[Dict]) -> List[str]:
    """Dotted chain of a descriptor, looking through subscripts and
    calls (the descriptor analog of rules.attr_chain)."""
    out: List[str] = []
    d = desc
    while isinstance(d, dict):
        t = d.get("t")
        if t == "attr":
            out.append(d["attr"])
            d = d.get("base")
        elif t == "sub":
            d = d.get("base")
        elif t == "call":
            d = d.get("func")
        elif t == "name":
            out.append(d["id"])
            break
        else:
            break
    return list(reversed(out))


def _is_view_chain(chain: Sequence[str]) -> bool:
    return (tuple(chain[-2:]) in _VIEW_TAILS
            or (bool(chain) and chain[-1] == "get_by_index"))


# ---------------------------------------------------------------------------
# R13: whole-tree escape analysis
# ---------------------------------------------------------------------------

# Taint entities: ("l", fid, name) a local/param, ("r", fid) a return
# value, ("a", cid, attr) a class attribute. Each carries a provenance
# (seed_site, kind): kind "view" = the value IS a view (mutating it is
# a finding), "container" = it HOLDS views (indexing/iterating yields
# views; restructuring the container itself is fine).
_Prov = Tuple[str, str]


class _CalleeCache:
    """resolve_call over a bare FUNC descriptor (no call record).
    The fabricated ``{"expr": desc}`` wrappers are kept alive for the
    resolver's lifetime: resolve_call memoizes by ``id(call)``, and a
    garbage-collected wrapper's id being reused by the next one would
    poison that memo with another call's resolution."""

    def __init__(self, res: TreeResolver):
        self.res = res
        self._memo: Dict[Tuple[str, int], List[str]] = {}
        self._keep: List[Dict] = []

    def callees(self, func_desc: Dict, fid: str) -> List[str]:
        key = (fid, id(func_desc))
        hit = self._memo.get(key)
        if hit is None:
            wrapper = {"expr": func_desc}
            self._keep.append(wrapper)
            hit = self.res.resolve_call(wrapper, fid)[0]
            self._memo[key] = hit
        return hit


class _TaintEngine:
    def __init__(self, res: TreeResolver, calls: _CalleeCache):
        self.res = res
        self.t: Dict[Tuple, _Prov] = {}
        self.changed = False
        self._calls = calls
        self._imports: Dict[str, Dict[str, str]] = {
            rel: facts.get("imports", {})
            for rel, facts in res.modules.items()}

    def mark(self, ent: Tuple, prov: _Prov) -> None:
        if ent not in self.t:
            self.t[ent] = prov
            self.changed = True

    def lookup_local(self, fid: str, name: str) -> Optional[_Prov]:
        """A local's taint, searching enclosing function scopes too
        (closure captures: a nested handler mutating a captured view)."""
        res = self.res
        scope: Optional[str] = fid
        while scope is not None:
            prov = self.t.get(("l", scope, name))
            if prov is not None:
                return prov
            rec = res.funcs.get(scope)
            if rec is None:
                break
            qual = rec["qual"]
            rel = res.func_mod[scope]
            scope = (f"{rel}::{qual.rsplit('.', 1)[0]}"
                     if "." in qual else None)
        return None

    def callees(self, func_desc: Dict, fid: str) -> List[str]:
        return self._calls.callees(func_desc, fid)

    def attr_taint(self, cid: Optional[str],
                   attr: str) -> Optional[_Prov]:
        info = self.res.classes.get(cid) if cid else None
        if info is None:
            return None
        for c in self.res._mro(info):
            prov = self.t.get(("a", c.cid, attr))
            if prov is not None:
                return prov
        return None

    def taints(self, desc: Optional[Dict], fid: str,
               depth: int = 0) -> Optional[_Prov]:
        """The provenance a value expression carries in `fid`'s scope,
        or None (clean)."""
        if desc is None or depth > 8:
            return None
        t = desc.get("t")
        if t == "name":
            return self.lookup_local(fid, desc["id"])
        if t in ("sub", "iter"):
            inner = self.taints(desc.get("base") or desc.get("of"),
                                fid, depth + 1)
            # Indexing / iterating either kind yields an element view.
            return (inner[0], "view") if inner else None
        if t == "attr":
            base_prov = self.taints(desc.get("base"), fid, depth + 1)
            if base_prov:
                return (base_prov[0], "view")
            base_t = self.res.resolve_type(desc.get("base"), fid)
            cid = base_t.get("cls") if base_t else None
            prov = self.attr_taint(cid, desc["attr"])
            if prov is not None:
                return prov
            # A property access carries its GETTER's return taint
            # (``pods = self.pods`` where the getter hands out views).
            info = self.res.classes.get(cid) if cid else None
            m = (self.res.class_method(info, desc["attr"])
                 if info else None)
            if m is not None:
                decs = self.res.funcs.get(m, {}).get("decorators") or ()
                if any(d.split(".")[-1] in ("property", "cached_property")
                       for d in decs):
                    return self.t.get(("r", m))
            return None
        if t == "container":
            for e in desc.get("elems", ()):
                inner = self.taints(e, fid, depth + 1)
                if inner:
                    return (inner[0], "container")
            return None
        if t == "call":
            chain = _desc_chain_loose(desc.get("func"))
            rel = self.res.func_mod.get(fid, "")
            if is_laundering_chain(chain, self._imports.get(rel)):
                return None  # the sanctioned hatch: a private copy
            if _is_view_chain(chain):
                line = desc.get("line", 0)
                return (f"{rel}:{line}", "view")
            func = desc.get("func") or {}
            if (len(chain) == 1 and chain[0] in _PROPAGATORS):
                for a in desc.get("args", ()):
                    inner = self.taints(a, fid, depth + 1)
                    if inner:
                        return inner
                return None
            if func.get("t") == "attr" and func["attr"] in _READERS:
                # d.get/.values/.items/.copy on a tainted receiver:
                # still (a shallow view of) the same objects.
                return self.taints(func.get("base"), fid, depth + 1)
            for c in self.callees(func, fid):
                prov = self.t.get(("r", c))
                if prov is not None:
                    return prov
            return None
        return None


class _R13Pass:
    def __init__(self, res: TreeResolver, calls: _CalleeCache):
        self.res = res
        self.eng = _TaintEngine(res, calls)
        # relpath:line of every view-producing call site the analyzer
        # recognized, and the subset implicated in a finding — the
        # runtime shadow's observed⊆static gate keys on these.
        self.recognized: Set[str] = set()
        self.implicated: Set[str] = set()

    def run(self) -> List[Finding]:
        res, eng = self.res, self.eng
        for fid, rec in res.funcs.items():
            rel = res.func_mod[fid]
            for call in rec.get("calls", ()):
                if _is_view_chain(_desc_chain_loose(call["expr"])):
                    self.recognized.add(f"{rel}:{call['line']}")
        for _ in range(_MAX_ROUNDS):
            eng.changed = False
            for fid, rec in res.funcs.items():
                self._propagate(fid, rec)
            if not eng.changed:
                break
        return self._findings()

    def _propagate(self, fid: str, rec: Dict) -> None:
        res, eng = self.res, self.eng
        info = res.class_of(fid)
        for name, descs in rec.get("locals", {}).items():
            for d in descs:
                prov = eng.taints(d, fid)
                if prov:
                    eng.mark(("l", fid, name), prov)
        # A laundering function's own return is BY DEFINITION clean —
        # json_deepcopy's scalar fast path (`return obj`) must not
        # taint every laundered copy in the tree.
        if not is_laundering_chain([rec["name"]]):
            for rdesc in rec.get("returns", ()):
                prov = eng.taints(rdesc, fid)
                if prov:
                    eng.mark(("r", fid), prov)
        for sa in rec.get("self_assigns", ()):
            if info is None:
                continue
            prov = eng.taints(sa["value"], fid)
            if prov:
                eng.mark(("a", info.cid, sa["attr"]), prov)
        for call in rec.get("calls", ()):
            args = call.get("args") or []
            kwargs = call.get("kwargs") or {}
            expr = call["expr"]
            # Container stores: receiver becomes a container of views.
            if (expr.get("t") == "attr"
                    and expr["attr"] in _CONTAINER_STORES and args):
                stored = eng.taints(args[-1], fid)
                if stored:
                    base = expr.get("base") or {}
                    prov = (stored[0], "container")
                    if (base.get("t") == "attr"
                            and base.get("base", {}).get("t") == "name"
                            and base["base"]["id"] == "self"
                            and info is not None):
                        eng.mark(("a", info.cid, base["attr"]), prov)
                    elif base.get("t") == "name":
                        eng.mark(("l", fid, base["id"]), prov)
            if not args and not kwargs:
                continue
            taints = {i: eng.taints(a, fid) for i, a in enumerate(args)}
            kw_taints = {k: eng.taints(v, fid)
                         for k, v in kwargs.items()}
            if not any(taints.values()) and not any(kw_taints.values()):
                continue
            for c in eng.callees(expr, fid):
                crec = res.funcs.get(c)
                if crec is None:
                    continue
                params = [p["name"] for p in crec["params"]]
                if crec.get("cls") and params \
                        and params[0] in ("self", "cls"):
                    params = params[1:]
                for i, prov in taints.items():
                    if prov and i < len(params):
                        eng.mark(("l", c, params[i]), prov)
                for k, prov in kw_taints.items():
                    if prov and k in params:
                        eng.mark(("l", c, k), prov)

    def _findings(self) -> List[Finding]:
        res, eng = self.res, self.eng
        out: List[Finding] = []
        seen: Set[Tuple[str, int, str]] = set()
        for fid, rec in res.funcs.items():
            rel = res.func_mod[fid]
            ann = (res.modules[rel].get("drflow") or {}).get("view_ok", {})
            info = res.class_of(fid)
            for m in rec.get("mutations", ()):
                if m["root"] == "self":
                    prov = (eng.t.get(("a", info.cid, m["attr"]))
                            if info is not None else None)
                    shown = f"self.{m['attr']}"
                else:
                    prov = eng.lookup_local(fid, m["root"])
                    shown = m["root"]
                if prov is None or prov[1] != "view":
                    continue
                hatch = next((ann[str(ln)] for ln in (m["line"],
                                                      m["line"] - 1)
                              if str(ln) in ann), None)
                if hatch is not None:
                    # Sanctioned hatch: STILL a statically-known flow —
                    # a runtime drift seeded here must read as
                    # explained, not as under-approximation.
                    self.implicated.add(prov[0])
                    if not hatch:
                        out.append(Finding(
                            rule="R13", path=rel, line=m["line"], col=0,
                            message="'# drflow: view-ok' without a "
                                    "reason — the annotation grammar "
                                    "is view-ok[reason] (SURVEY §20)"))
                    continue
                key = (rel, m["line"], shown)
                if key in seen:
                    continue
                seen.add(key)
                self.implicated.add(prov[0])
                out.append(Finding(
                    rule="R13", path=rel, line=m["line"], col=0,
                    message=f"{m['what']} '{shown}' in {rec['qual']}()"
                            f", a zero-copy informer view that escaped "
                            f"interprocedurally (view read at {prov[0]})"
                            " — deepcopy/json_deepcopy the object "
                            "before writing, or annotate '# drflow: "
                            "view-ok[reason]' (SURVEY §20)"))
        return out


# ---------------------------------------------------------------------------
# R14: stale-snapshot check-then-act
# ---------------------------------------------------------------------------

class _R14Pass:
    def __init__(self, res: TreeResolver, calls: _CalleeCache):
        self.res = res
        self._calls = calls
        # fid -> attrs this function re-reads (kind r) under a held
        # data lock — the "re-checks live state" signal for act
        # callees, computed lazily.
        self._live_reads: Dict[str, Set[str]] = {}
        self._reval: Dict[str, str] = {}  # fid -> REVALIDATES field
        for rel, facts in res.modules.items():
            rv = (facts.get("drflow") or {}).get("revalidates", {})
            if not rv:
                continue
            lines = {int(k): v for k, v in rv.items()}
            for qual, frec in facts["functions"].items():
                field = (lines.get(frec.get("line", -1))
                         or lines.get(frec.get("line", -1) - 1))
                if field:
                    self._reval[f"{rel}::{qual}"] = field
        # cid -> attrs written OUTSIDE __init__ anywhere in the tree:
        # only mutable state can go stale. A snapshot derived purely
        # from construction-time handles (self._ckpt_mgr) is a value,
        # not a racing read.
        self._written: Dict[str, Set[str]] = {}
        for fid, rec in res.funcs.items():
            if rec["name"] == "__init__":
                continue
            info = res.class_of(fid)
            if info is None:
                continue
            w = self._written.setdefault(info.cid, set())
            w.update(a["attr"] for a in rec.get("accesses", ())
                     if a["kind"] == "w" and a["base"] == "self")
            w.update(m["attr"] for m in rec.get("mutations", ())
                     if m["root"] == "self")
            w.update(sa["attr"] for sa in rec.get("self_assigns", ()))

    def _mutable_attrs(self, cid: Optional[str]) -> Set[str]:
        info = self.res.classes.get(cid) if cid else None
        if info is None:
            return set()
        out: Set[str] = set()
        for c in self.res._mro(info):
            out |= self._written.get(c.cid, set())
        return out

    def _receiver_cid(self, fid: str, base: str) -> Optional[str]:
        res = self.res
        if base == "self":
            info = res.class_of(fid)
            return info.cid if info else None
        t = res.resolve_type({"t": "name", "id": base}, fid)
        return t.get("cls") if t else None

    def _writes_state(self, fid: str) -> bool:
        rec = self.res.funcs.get(fid) or {}
        return (any(a["kind"] == "w" and a["base"] == "self"
                    for a in rec.get("accesses", ()))
                or any(m["root"] == "self"
                       for m in rec.get("mutations", ())))

    def _is_reservation(self, fid: str, rec: Dict, seed: Dict) -> bool:
        """The snapshot block COMMITTED something while it held the
        lock — a test-and-set, not a naked check, so the actor is
        serialized even though the data it read is stale:

        - the guarded expression itself called a receiver method that
          writes state (``spawn = ... and self._claim_spawn_slot()``);
        - or some attribute is both guard-read and written under the
          lock before the release (``if self._sync_in_flight: wait
          ... self._sync_in_flight = True`` — the group-sync leader
          claim in journal_barrier)."""
        res = self.res
        cid = self._receiver_cid(fid, seed["base"])
        info = res.classes.get(cid) if cid else None
        for mname in seed.get("rhs_calls", ()):
            cands = (res.class_method_cha(info, mname) if info
                     else res.methods_by_name.get(mname, []))
            if any(self._writes_state(c) for c in cands):
                return True
        held_rw: Dict[str, List[str]] = {}
        for acc in rec.get("accesses", ()):
            if (acc["base"] == seed["base"]
                    and acc["line"] <= seed["release"]
                    and any(h[0] == seed["base"]
                            and h[1] == seed["lock_attr"]
                            for h in acc["held"])):
                held_rw.setdefault(acc["attr"], []).append(acc["kind"])
        return any("r" in kinds and "w" in kinds
                   for kinds in held_rw.values())

    def live_reads(self, fid: str) -> Set[str]:
        hit = self._live_reads.get(fid)
        if hit is None:
            hit = set()
            rec = self.res.funcs.get(fid) or {}
            for acc in rec.get("accesses", ()):
                if acc["kind"] == "r" and acc["base"] == "self" \
                        and acc["held"]:
                    hit.add(acc["attr"])
            self._live_reads[fid] = hit
        return hit

    def _revalidated_by(self, fid: str, attrs: Sequence[str]) -> bool:
        field = self._reval.get(fid)
        if field == "*":
            return True
        if field and field in attrs:
            return True
        return bool(self.live_reads(fid) & set(attrs))

    def _seeds(self, fid: str, rec: Dict) -> List[Dict]:
        res = self.res
        seeds = [dict(s, kind="with") for s in rec.get("snap_binds", ())]
        for cb in rec.get("call_binds", ()):
            func = cb["desc"].get("func") or {}
            chain = _desc_chain_loose(func)
            if not chain or len(chain) < 2:
                continue  # a bare function call is not a receiver read
            for c in self._calls.callees(func, fid):
                ret = res.funcs.get(c, {}).get("ret_locked")
                if not ret:
                    continue
                if self._reval.get(c):
                    continue  # the getter itself IS the validation
                seeds.append({
                    "var": cb["var"], "line": cb["line"],
                    "base": chain[0], "lock_attr": ret["lock_attr"],
                    "release": cb["line"], "attrs": ret["attrs"],
                    "kind": "getter", "callee": c})
                break
        return seeds

    def run(self) -> List[Finding]:
        res = self.res
        out: List[Finding] = []
        seen: Set[Tuple[str, int]] = set()
        for fid, rec in res.funcs.items():
            rel = res.func_mod[fid]
            for seed in self._seeds(fid, rec):
                mutable = self._mutable_attrs(
                    self._receiver_cid(fid, seed["base"]))
                seed["attrs"] = [a for a in seed["attrs"] if a in mutable]
                if not seed["attrs"]:
                    continue  # construction-time handles cannot go stale
                if seed["kind"] == "with" \
                        and self._is_reservation(fid, rec, seed):
                    continue
                for test in rec.get("tests", ()):
                    if test["line"] <= seed["release"] \
                            or seed["var"] not in test["names"]:
                        continue
                    f = self._check_act(fid, rec, rel, seed, test)
                    if f is not None and (f.path, f.line) not in seen:
                        seen.add((f.path, f.line))
                        out.append(f)
        return out

    def _check_act(self, fid: str, rec: Dict, rel: str, seed: Dict,
                   test: Dict) -> Optional[Finding]:
        res = self.res
        attrs = set(seed["attrs"])
        lo, hi = test["span"]
        base = seed["base"]

        def revalidated_before(line: int) -> bool:
            """A live re-read of the snapshotted state under the lock
            anywhere between the RELEASE and the act — the acted-on
            decision was refreshed (rebinding the variable under a new
            acquisition included)."""
            for acc in rec.get("accesses", ()):
                if (acc["base"] == base and acc["attr"] in attrs
                        and acc["kind"] == "r"
                        and seed["release"] < acc["line"] <= line
                        and any(h[0] == base
                                and h[1] == seed["lock_attr"]
                                for h in acc["held"])):
                    return True
            for call in rec.get("calls", ()):
                if not (seed["release"] < call["line"] <= line):
                    continue
                for c in res.resolve_call(call, fid)[0]:
                    if self._revalidated_by(c, seed["attrs"]):
                        return True
            return False

        # Act form 1: a direct write of the snapshotted state.
        for acc in rec.get("accesses", ()):
            if (acc["kind"] == "w" and acc["base"] == base
                    and acc["attr"] in attrs
                    and lo <= acc["line"] <= hi):
                if revalidated_before(acc["line"]):
                    return None
                return self._finding(rel, acc["line"], rec, seed, test,
                                     f"{base}.{acc['attr']}")
        # Act form 2: a call on the same receiver that writes the
        # snapshotted state (the getter/act method pair).
        for call in rec.get("calls", ()):
            if not (lo <= call["line"] <= hi):
                continue
            chain = _desc_chain_loose(call["expr"])
            if not chain or chain[0] != base:
                continue
            for c in res.resolve_call(call, fid)[0]:
                crec = res.funcs.get(c)
                if crec is None or self._revalidated_by(c, seed["attrs"]):
                    continue
                writes = {a["attr"] for a in crec.get("accesses", ())
                          if a["kind"] == "w" and a["base"] == "self"}
                writes |= {m["attr"] for m in crec.get("mutations", ())
                           if m["root"] == "self"}
                hit = writes & attrs
                if hit:
                    if revalidated_before(call["line"]):
                        return None
                    return self._finding(
                        rel, call["line"], rec, seed, test,
                        f"{base}.{sorted(hit)[0]} (via "
                        f"{crec['qual']}())")
        return None

    def _finding(self, rel: str, line: int, rec: Dict, seed: Dict,
                 test: Dict, target: str) -> Finding:
        how = ("read under the lock" if seed["kind"] == "with"
               else "returned by a locked getter")
        return Finding(
            rule="R14", path=rel, line=line, col=0,
            message=f"check-then-act on a stale snapshot in "
                    f"{rec['qual']}(): '{seed['var']}' ({how} at line "
                    f"{seed['line']}, lock {seed['base']}."
                    f"{seed['lock_attr']} released) guards the branch "
                    f"at line {test['line']} and then {target} is "
                    "written without re-validating against live state "
                    "— re-read under the lock, route through a "
                    "'# drflow: REVALIDATES:<field>' commit, or "
                    "restructure (SURVEY §20)")


# ---------------------------------------------------------------------------
# R15: swallowed-exception audit (lexical, per module)
# ---------------------------------------------------------------------------

def _broad_handler(h: ast.ExceptHandler) -> bool:
    t = h.type
    if t is None:
        return True
    elts = t.elts if isinstance(t, ast.Tuple) else [t]
    for e in elts:
        chain = attr_chain(e)
        if chain and chain[-1] in _BROAD_EXC:
            return True
    return False


def _handler_discipline(h: ast.ExceptHandler) -> Optional[str]:
    """What the handler DOES with the error, or None (silent swallow):
    're-raise', 'uses the exception value', 'metric', 'log',
    'degrade-path call'."""
    for node in ast.walk(h):
        if isinstance(node, ast.Raise):
            return "re-raise"
    if h.name:
        for node in ast.walk(h):
            if isinstance(node, ast.Name) and node.id == h.name \
                    and isinstance(node.ctx, ast.Load):
                return "uses the exception value"
    for node in ast.walk(h):
        if not isinstance(node, ast.Call):
            continue
        chain = attr_chain(node.func)
        if not chain:
            continue
        tail = chain[-1]
        if tail in _METRIC_TAILS:
            return "metric"
        if tail in _LOG_TAILS:
            return "log"
        if _DEGRADE_RE.search(tail):
            return "degrade-path call"
    return None


def _handler_degrades(h: ast.ExceptHandler, want: str) -> bool:
    """Whether the handler routes to the site's DECLARED degradation:
    re-raises, or calls something whose name carries `want` (or any
    generic degrade verb — a stronger action than the declared one is
    not a finding)."""
    for node in ast.walk(h):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            chain = attr_chain(node.func)
            if chain and (want in chain[-1]
                          or _DEGRADE_RE.search(chain[-1])):
                return True
    return False


def _guarded_sites(try_node: ast.Try, ctx: ProjectContext) -> List[str]:
    """Registered fault sites whose guards sit in this try's BODY: the
    handler below is the code that runs when the injected fault fires."""
    out: List[str] = []
    for stmt in try_node.body:
        for node in ast.walk(stmt):
            if not isinstance(node, ast.Call):
                continue
            chain = attr_chain(node.func)
            if (len(chain) >= 2 and chain[-1] in ("check", "fires", "pull")
                    and any(c.lstrip("_").lower() == "faults"
                            for c in chain[:-1])
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                    and node.args[0].value in ctx.fault_sites):
                out.append(node.args[0].value)
    return out


def _site_degradation_findings(module: Module, h: ast.ExceptHandler,
                               sites: Sequence[str],
                               ctx: ProjectContext) -> Iterator[Finding]:
    for site in sites:
        want = ctx.fault_degradations.get(site)
        if want and not _handler_degrades(h, want):
            yield Finding(
                rule="R15", path=module.relpath, line=h.lineno,
                col=h.col_offset,
                message=f"handler guards fault site {site!r} but does "
                        f"not route to its declared degradation "
                        f"({want}, infra/faults.py DEGRADATIONS) — an "
                        "injected fault that is only logged leaves the "
                        "degrade path untested (SURVEY §20)")
            return


def r15_scan(module: Module, ctx: ProjectContext) -> Iterator[Finding]:
    facts = extract_module(module)
    swallow_ok: Dict[str, str] = (facts.get("drflow") or {}).get(
        "swallow_ok", {})

    def sanctioned(line: int) -> Optional[Tuple[int, str]]:
        for ln in (line, line - 1):
            if str(ln) in swallow_ok:
                return ln, swallow_ok[str(ln)]
        return None

    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Try):
            continue
        sites = None  # computed lazily: most handlers need no registry
        for h in node.handlers:
            if not _broad_handler(h):
                # Narrow handlers never swallow-audit, but a try body
                # guarding a declared-degradation fault site holds its
                # handler — broad or not — to the declared route
                # (FaultInjected is usually caught narrowly).
                if sites is None:
                    sites = _guarded_sites(node, ctx)
                yield from _site_degradation_findings(
                    module, h, sites, ctx)
                continue
            ann = sanctioned(h.lineno)
            disc = _handler_discipline(h)
            if disc is None:
                if ann is not None and ann[1]:
                    continue  # justified deliberate swallow
                if ann is not None:
                    yield Finding(
                        rule="R15", path=module.relpath, line=h.lineno,
                        col=h.col_offset,
                        message="'# drflow: swallow-ok' without a "
                                "reason — the annotation grammar is "
                                "swallow-ok[reason] (SURVEY §20)")
                    continue
                yield Finding(
                    rule="R15", path=module.relpath, line=h.lineno,
                    col=h.col_offset,
                    message="broad except handler swallows the error "
                            "silently: no re-raise, no metric inc, no "
                            "log, no degrade-path call, bound "
                            "exception unused — count/log/degrade, or "
                            "annotate '# drflow: swallow-ok[reason]' "
                            "(SURVEY §20)")
                continue
            if ann is not None:
                continue  # annotated AND disciplined: fine either way
            if sites is None:
                sites = _guarded_sites(node, ctx)
            yield from _site_degradation_findings(module, h, sites, ctx)


# ---------------------------------------------------------------------------
# The combined rule
# ---------------------------------------------------------------------------

@register
class FlowAnalysis(Rule):
    """drflow (R13-R15): see the module docstring. One Rule riding
    draracer's extraction through the shared facts key; R15 is lexical
    (scan-phase, per-file cacheable), R13/R14 resolve whole-tree in
    finalize."""

    rule_id = "R13"
    provides = frozenset({"R13", "R14", "R15"})
    facts_key = "R9"  # the draracer extraction blob, stored once
    title = "escape / stale-snapshot / swallowed-error flow analysis"

    def __init__(self):
        self.tree_facts: Dict[str, Dict] = {}
        self._last_facts: Optional[Dict] = None
        # Populated by finalize for the CLI (--check-view-shadow):
        # every recognized view-read site and the statically implicated
        # subset, relpath:line-keyed like the lock witness.
        self.view_sites_recognized: Set[str] = set()
        self.view_sites_implicated: Set[str] = set()

    def scan(self, module: Module, ctx: ProjectContext) -> Iterator[Finding]:
        if module.is_test:
            return iter(())
        facts = extract_module(module)
        self.tree_facts[module.relpath] = facts
        self._last_facts = facts
        return r15_scan(module, ctx)

    def module_facts(self) -> Optional[Dict]:
        # Normally draracer (same facts_key, registered first) already
        # contributed the shared blob and the runner's setdefault keeps
        # that copy — but under a --rules filter that excludes R9-R11,
        # drflow is the only contributor; returning None there would
        # leave finalize with an EMPTY tree (no R13/R14 at all).
        facts, self._last_facts = self._last_facts, None
        return facts

    def absorb_facts(self, relpath: str, facts: Dict,
                     ctx: ProjectContext) -> None:
        self.tree_facts[relpath] = facts

    def finalize(self, ctx: ProjectContext) -> Iterator[Finding]:
        if not self.tree_facts:
            return
        res = shared_resolver(self.tree_facts)
        calls = _CalleeCache(res)
        r13 = _R13Pass(res, calls)
        yield from r13.run()
        self.view_sites_recognized = r13.recognized
        self.view_sites_implicated = r13.implicated
        yield from _R14Pass(res, calls).run()


# ---------------------------------------------------------------------------
# View-shadow cross-validation (the lint.sh observed⊆static gate)
# ---------------------------------------------------------------------------

def check_view_shadow(rule: FlowAnalysis,
                      drifts: Sequence[Dict]) -> List[str]:
    """Every runtime view-shadow drift (a zero-copy informer view whose
    content hash changed between hand-out and quiesce —
    k8s.informer.viewshadow) must be explained by the static escape
    analysis: its hand-out site must be an R13-implicated view seed.
    An unexplained drift means R13 under-approximates (or never saw
    the site at all) — the gate FAILS so the model gets fixed rather
    than quietly trusted. Returns violation lines (empty = validated);
    the standing green state is zero drifts AND zero findings."""
    out: List[str] = []
    for d in drifts:
        site = d.get("site", "?")
        what = d.get("key", d.get("kind", "object"))
        if site in rule.view_sites_implicated:
            continue
        if site not in rule.view_sites_recognized:
            out.append(
                f"view drift at {site} ({what}): site unknown to the "
                "static analyzer (not a recognized lister/"
                "get_by_index read — the extraction is blind to this "
                "hand-out path)")
        else:
            out.append(
                f"view drift at {site} ({what}): a runtime mutation "
                "of this view maps to NO static R13 finding — the "
                "escape analysis under-approximates this flow")
    return out
