"""draracer: interprocedural lockset & guarded-by inference (R9-R11).

dralint's R1/R2 stop at the lexical horizon: they see one function at a
time and trust the ``*_locked`` naming convention at call sites. Raced
state that crosses a function or file boundary is invisible to them.
This module is the
whole-program half (SURVEY §16), three rules over one shared per-module
extraction:

- **R9 — interprocedural locked-call discipline.** A whole-tree call
  graph (module-qualified def/method resolution, conservative for
  dynamic dispatch) over which the R1 lock context is propagated
  *interprocedurally*: a call that RESOLVES to a ``*_locked`` function
  — through an import alias, a bound reference, or a helper chain in
  another file — must be reachable only through lock acquisitions. A
  function all of whose static call sites hold a lock inherits the
  context; a chain from an exposed root (no static callers, a thread
  target, an escaping reference) that reaches a ``*_locked`` callee
  without passing an acquisition is a finding, reported at the callee's
  call site with an example chain.

- **R10 — guarded-by inference.** Per class, learn which attributes are
  predominantly accessed under which ``with <recv>.<lock>:`` context
  (lock attributes are discovered from the same creation-site registry
  that keys the runtime lockwitness), then flag reads/writes of a
  guarded attribute outside any acquisition of its guard. An explicit
  ``# GUARDED_BY: <lock>`` comment on the attribute's assignment pins
  intent (``# GUARDED_BY: none`` exempts); ``--locks-report`` prints
  the per-attribute table.

- **R11 — static lock-order graph.** Lock identity is the creation
  site (``relpath:line`` of the ``threading.Lock()`` call) — the SAME
  key the runtime witness uses, so the two graphs are comparable.
  Nested ``with``-acquisitions and lock-acquiring calls made under a
  held lock yield edges; the graph must be acyclic at lint time, and
  ``check_witness`` asserts a runtime-exported edge set (chaos matrix,
  drmc run) is a SUBSET of the static graph — an unexplained runtime
  edge means the call graph under-approximates and fails the gate.

Resolution rules (documented in SURVEY §16.2, exercised per-rule in
tests/test_raceanalysis.py):

1. ``self.m()`` → the enclosing class's method (then base classes).
2. Bare names → nested defs, then module functions, then imports
   (``from x import f [as g]``; ``import x as m; m.f()``).
3. ``obj.m()`` → obj's class when inferable from a parameter
   annotation, a constructor assignment (``obj = Cls(...)``), a typed
   attribute (``self._shards = [Cls(...)]`` + subscript/iteration), or
   a helper's inferred return type; otherwise the DYNAMIC-DISPATCH
   fallback: every class in the tree defining ``m`` (suppressed for
   ubiquitous builtin-ish names, always applied for ``*_locked``).
4. Lock expressions resolve to creation sites through the same engine;
   a with-item that LOOKS like a data lock but cannot be resolved to a
   creation site is itself an R11 finding (an unresolvable acquisition
   would silently punch a hole in the static graph).

Test modules contribute nothing (they call ``*_locked`` helpers in
controlled single-thread contexts and access attributes freely); the
witness gates only run chaos/drmc code, which lives in the tree and IS
analyzed.
"""

from __future__ import annotations

import ast
import io
import re
import tokenize
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from tpu_dra_torch.analysis.core import (
    Finding, Module, ProjectContext, Rule, register,
)
from tpu_dra_torch.analysis.rules import (
    _MUTATORS as _MUTATOR_METHODS, _STATE_MUTATORS, attr_chain,
    is_data_lock_name, module_imports as _module_imports,
)

# Guarded-by inference thresholds (SURVEY §16.3): an attribute is
# inferred lock-guarded when at least MIN_GUARDED accesses vote for one
# guard and those votes are at least GUARD_RATIO of all counted
# accesses. Below either bar the attribute is treated as unshared or
# deliberately torn-read tolerant, and R10 stays silent.
MIN_GUARDED = 4
GUARD_RATIO = 0.75

# Pure builtins whose result directly derives from their arguments —
# attrs read inside them still count as snapshot reads for R14.
_PURE_BUILTINS = {
    "len", "sorted", "list", "tuple", "set", "dict", "frozenset",
    "min", "max", "sum", "any", "all", "bool", "int", "float", "str",
    "reversed", "enumerate", "zip", "abs", "round",
}

# Method names too ubiquitous for the dynamic-dispatch fallback: an
# unresolved receiver calling one of these must not edge into every
# class that happens to define it (dict.get vs SomeClass.get). The
# fallback still ALWAYS applies to *_locked names — they are the
# convention's own namespace and never collide with builtins.
_NO_GLOBAL_FALLBACK = {
    "get", "put", "pop", "add", "set", "run", "start", "stop", "close",
    "acquire", "release", "wait", "notify", "notify_all", "update",
    "append", "extend", "remove", "clear", "copy", "keys", "values",
    "items", "join", "send", "recv", "read", "write", "flush", "open",
    "list", "create", "delete", "patch", "watch", "reset", "load",
    "store", "apply", "check", "name", "format", "to_dict", "value",
}


# ---------------------------------------------------------------------------
# Expression descriptors (JSON-able, resolved in finalize)
# ---------------------------------------------------------------------------

def _lock_ctor_kind(call: ast.Call,
                    lock_names: Dict[str, str]) -> Optional[str]:
    """'lock'/'cond' when `call` creates a threading lock — by dotted
    name (``threading.Lock()``), by import (``from threading import
    Lock``), or through a module-level constructor alias
    (``_real_lock = threading.Lock``); the module's `lock_names` table
    carries the import/alias name → kind mapping."""
    chain = attr_chain(call.func)
    if not chain:
        return None
    tail = chain[-1]
    if chain[:-1] == ["threading"]:
        if tail in ("Lock", "RLock"):
            return "lock"
        if tail == "Condition":
            return "cond"
        return None
    if len(chain) == 1:
        return lock_names.get(tail)
    return None


def _find_lock_creations(node: ast.AST,
                         lock_names: Dict[str, str]) -> List[int]:
    """Line numbers of every lock-creating call anywhere under `node`
    (the creation-site registry: the same ``relpath:line`` keys the
    runtime witness assigns — a dict-comprehension of per-chip locks is
    one class at the comprehension's line). A bare ``Condition()``
    creates its RLock inside threading (unwitnessed) — its site is
    still recorded so the static graph can reason about it; it simply
    never appears in a runtime edge set."""
    out: List[int] = []
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            kind = _lock_ctor_kind(sub, lock_names)
            if kind == "lock":
                out.append(sub.lineno)
            elif kind == "cond" and not any(
                    isinstance(a, ast.Call)
                    and _lock_ctor_kind(a, lock_names) == "lock"
                    for a in sub.args):
                out.append(sub.lineno)
    return sorted(set(out))


def describe_expr(node: ast.AST,
                  lock_names: Dict[str, str]) -> Dict:
    """A compact JSON descriptor of `node` sufficient for the finalize
    resolver: names, attribute/subscript chains, constructor calls and
    embedded lock creations. Anything else degrades to 'unknown'."""
    if isinstance(node, ast.Call):
        kind = _lock_ctor_kind(node, lock_names)
        if kind == "lock":
            return {"t": "lock", "line": node.lineno}
        if kind == "cond":
            for a in node.args:
                if (isinstance(a, ast.Call)
                        and _lock_ctor_kind(a, lock_names) == "lock"):
                    return {"t": "lock", "line": a.lineno}
            return {"t": "lock", "line": node.lineno, "bare_cond": True}
        desc: Dict = {"t": "call", "func": describe_expr(node.func,
                                                        lock_names),
                      "line": node.lineno}
        # Positional args ride along (capped): drflow's taint walk and
        # the functools.partial chase both need to see through a call
        # expression used as a VALUE (``snap = sorted(lister.list())``,
        # ``partial(self._on_evt, key)``) — call RECORDS carry args
        # only for calls made as statements/receivers.
        if node.args:
            desc["args"] = [describe_expr(a, lock_names)
                            for a in node.args[:5]]
        arg_locks = _find_lock_creations(node, lock_names)
        if arg_locks:
            desc["arg_locks"] = arg_locks
        return desc
    if isinstance(node, ast.Name):
        return {"t": "name", "id": node.id}
    if isinstance(node, ast.Attribute):
        return {"t": "attr", "base": describe_expr(node.value, lock_names),
                "attr": node.attr}
    if isinstance(node, ast.Subscript):
        return {"t": "sub", "base": describe_expr(node.value, lock_names)}
    if isinstance(node, (ast.List, ast.Tuple, ast.Set)):
        locks = _find_lock_creations(node, lock_names)
        ctors = [describe_expr(e, lock_names) for e in node.elts[:4]
                 if isinstance(e, ast.Call)]
        return {"t": "container", "locks": locks, "elems": ctors}
    if isinstance(node, (ast.Dict, ast.DictComp, ast.ListComp,
                         ast.SetComp, ast.GeneratorExp)):
        locks = _find_lock_creations(node, lock_names)
        elems: List[Dict] = []
        if isinstance(node, ast.Dict):
            elems = [describe_expr(v, lock_names) for v in node.values[:4]
                     if isinstance(v, ast.Call)]
        elif isinstance(node, (ast.ListComp, ast.SetComp,
                               ast.GeneratorExp)):
            if isinstance(node.elt, ast.Call):
                elems = [describe_expr(node.elt, lock_names)]
        elif isinstance(node, ast.DictComp):
            if isinstance(node.value, ast.Call):
                elems = [describe_expr(node.value, lock_names)]
        return {"t": "container", "locks": locks, "elems": elems}
    if isinstance(node, ast.Constant):
        return {"t": "const"}
    if isinstance(node, ast.IfExp):
        return describe_expr(node.body, lock_names)
    if isinstance(node, ast.BoolOp) and node.values:
        return describe_expr(node.values[-1], lock_names)
    if isinstance(node, ast.Lambda):
        # Position-keyed: the module records the lambda's body as its
        # own function record, so a registered lambda handler resolves.
        return {"t": "lambda", "line": node.lineno,
                "col": node.col_offset}
    return {"t": "unknown"}


def _held_entry(desc: Dict) -> Dict:
    """A held-stack entry: the descriptor plus its root variable and
    final attribute. Guard identity for R10 is (root var, lock attr),
    which is only meaningful for a SIMPLE ``<name>.<attr>`` chain —
    same variable ⇒ same object ⇒ same class. Crossing a subscript,
    call, or second attribute hop means a DIFFERENT object's
    same-named lock (``self._shards[i]._lock``): it must neither
    satisfy nor vote for the receiver's own guard, so base stays None
    (R11 still uses the full expression)."""
    if desc.get("t") == "attr" and desc["base"].get("t") == "name":
        return {"expr": desc, "base": desc["base"]["id"],
                "attr": desc["attr"]}
    if desc.get("t") == "name":
        return {"expr": desc, "base": desc["id"], "attr": desc["id"]}
    return {"expr": desc, "base": None, "attr": None}


def _lockish_desc(node: ast.AST) -> bool:
    chain = attr_chain(node)
    return bool(chain) and is_data_lock_name(chain[-1])


# ---------------------------------------------------------------------------
# Per-function extraction
# ---------------------------------------------------------------------------

class _FuncRecorder(ast.NodeVisitor):
    """One pass over one function body collecting everything R9/R10/R11
    need, with the lexical held-lock stack tracked the same way R1's
    visitor tracks it (nested defs/lambdas are separate records and do
    NOT inherit; comprehensions execute inline and do)."""

    def __init__(self, rec: Dict, lock_names: Dict[str, str]):
        self.rec = rec
        self.lock_names = lock_names
        self.held: List[Dict] = []       # held-stack entries
        self._explicit: List[Tuple[str, Dict]] = []  # (chainstr, entry)

    # -- scope boundaries ---------------------------------------------------

    def visit_FunctionDef(self, node):  # noqa: N802 — nested def
        self.rec["locals"].setdefault(node.name, []).append(
            {"t": "nested", "qual": f"{self.rec['qual']}.{node.name}"})
        # Body handled by the module walker as its own record.

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):  # noqa: N802
        pass  # opaque: no lock context, no records

    def visit_ClassDef(self, node):  # noqa: N802
        pass  # nested classes: out of scope for the resolver

    # -- bindings -----------------------------------------------------------

    def _bind(self, target: ast.AST, desc: Dict) -> None:
        if isinstance(target, ast.Name):
            self.rec["locals"].setdefault(target.id, []).append(desc)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._bind(elt, {"t": "unknown"})

    def visit_Assign(self, node):  # noqa: N802
        desc = describe_expr(node.value, self.lock_names)
        for t in node.targets:
            self._bind(t, desc)
            self._record_self_assign(t, node, desc)
            self._record_flow_bind(t, node, desc)
            if isinstance(t, ast.Subscript) and desc.get("t") in (
                    "call", "name", "attr", "sub", "iter"):
                # d[k] = Cls(...): the container binding gains the
                # element — ``inf[name] = Informer(...)`` must let
                # ``inf["pods"].on_add(...)`` resolve its receiver.
                # Non-call elements ride along too: ``self._cache[k] =
                # view`` makes the cache a container OF the view for
                # drflow's taint walk.
                elem = {"t": "container", "locks": [], "elems": [desc]}
                if isinstance(t.value, ast.Name):
                    self.rec["locals"].setdefault(
                        t.value.id, []).append(elem)
                elif (isinstance(t.value, ast.Attribute)
                        and isinstance(t.value.value, ast.Name)
                        and t.value.value.id == "self"):
                    self.rec["self_assigns"].append(
                        {"attr": t.value.attr, "line": node.lineno,
                         "value": elem})
        self.generic_visit(node)

    def visit_AnnAssign(self, node):  # noqa: N802
        if node.value is not None:
            desc = describe_expr(node.value, self.lock_names)
            self._bind(node.target, desc)
            self._record_self_assign(node.target, node, desc)
        self.generic_visit(node)

    def _record_self_assign(self, target, stmt, desc: Dict) -> None:
        if (isinstance(target, ast.Attribute)
                and isinstance(target.value, ast.Name)
                and target.value.id == "self"):
            self.rec["self_assigns"].append(
                {"attr": target.attr, "line": stmt.lineno, "value": desc})

    def _record_flow_bind(self, target, stmt, desc: Dict) -> None:
        """drflow (R13/R14) bindings: call results bound to a name
        (with their line — `locals` descriptors are lineless), and
        snapshot binds — a name bound under a held data lock from
        state rooted at the lock's own receiver, which goes STALE the
        moment the with-block releases (R14's check-then-act seed)."""
        if not isinstance(target, ast.Name):
            return
        if desc.get("t") == "call":
            self.rec.setdefault("call_binds", []).append(
                {"var": target.id, "line": stmt.lineno, "desc": desc})
        lock = next((h for h in reversed(self.held)
                     if h.get("attr") and is_data_lock_name(h["attr"])
                     and h.get("end") is not None), None)
        if lock is None:
            return
        base = lock.get("base")
        attrs: set = set()
        rhs_calls: set = set()

        def collect(n: ast.AST) -> None:
            """Receiver-state attrs the bound value DIRECTLY derives
            from. A non-builtin call's ARGUMENTS are consumed by the
            callee — the bind takes the call's RESULT, whose staleness
            is the locked-getter seed's job — but the call's receiver
            chain is still a direct read (``self._proc.poll()`` reads
            ``_proc``); pure builtins (len/sorted/min ...) pass their
            arguments' reads through (``n = len(self._items)``)."""
            if isinstance(n, ast.Call):
                cchain = attr_chain(n.func)
                if len(cchain) == 2 and cchain[0] == base:
                    # A receiver-method call INSIDE the guarded
                    # expression: if it writes state, the bind is a
                    # test-and-set claim, not a naked check (R14).
                    rhs_calls.add(cchain[1])
                if (isinstance(n.func, ast.Name)
                        and n.func.id in _PURE_BUILTINS):
                    for a in n.args:
                        collect(a)
                else:
                    collect(n.func)
                return
            chain = attr_chain(n) if isinstance(n, ast.Attribute) else None
            if (chain and len(chain) > 1 and chain[0] == base
                    and chain[1] != lock["attr"]):
                attrs.add(chain[1])
            for child in ast.iter_child_nodes(n):
                collect(child)

        collect(stmt.value)
        if not attrs:
            return  # nothing receiver-state-derived: not a snapshot
        self.rec.setdefault("snap_binds", []).append(
            {"var": target.id, "line": stmt.lineno, "base": base,
             "lock_attr": lock["attr"], "release": lock["end"],
             "attrs": sorted(attrs), "rhs_calls": sorted(rhs_calls)})

    def visit_Return(self, node):  # noqa: N802
        # A value returned while holding a data lock is a SNAPSHOT the
        # moment it crosses the return (the getter pattern): callers
        # that guard-then-act on it are R14's interprocedural seed.
        if node.value is not None:
            lock = next((h for h in reversed(self.held)
                         if h.get("attr")
                         and is_data_lock_name(h["attr"])), None)
            if lock is not None and lock.get("base") == "self":
                attrs = set()
                for n in ast.walk(node.value):
                    chain = (attr_chain(n)
                             if isinstance(n, ast.Attribute) else None)
                    if (chain and len(chain) > 1 and chain[0] == "self"
                            and chain[1] != lock["attr"]):
                        attrs.add(chain[1])
                if attrs:
                    cur = self.rec.setdefault(
                        "ret_locked", {"lock_attr": lock["attr"],
                                       "attrs": []})
                    cur["attrs"] = sorted(set(cur["attrs"]) | attrs)
        self.generic_visit(node)

    def _record_test(self, node) -> None:
        names = sorted({n.id for n in ast.walk(node.test)
                        if isinstance(n, ast.Name)})
        if not names or not node.body:
            return
        end = max((getattr(s, "end_lineno", None) or s.lineno
                   for s in node.body), default=node.lineno)
        self.rec.setdefault("tests", []).append(
            {"line": node.lineno, "names": names,
             "span": [node.body[0].lineno, end]})

    def visit_If(self, node):  # noqa: N802
        self._record_test(node)
        self.generic_visit(node)

    visit_While = visit_If  # noqa: N815

    def _visit_comp(self, node):
        # Comprehensions execute inline: generator targets are scope
        # bindings (`l` in ``max(l.when(i) for l in self._limiters)``).
        for gen in node.generators:
            self._bind(gen.target,
                       {"t": "iter",
                        "of": describe_expr(gen.iter, self.lock_names)})
        self.generic_visit(node)

    visit_GeneratorExp = _visit_comp  # noqa: N815
    visit_ListComp = _visit_comp      # noqa: N815
    visit_SetComp = _visit_comp       # noqa: N815
    visit_DictComp = _visit_comp      # noqa: N815

    def visit_For(self, node):  # noqa: N802
        desc = describe_expr(node.iter, self.lock_names)
        if (desc.get("t") == "call"
                and desc["func"].get("t") == "name"
                and desc["func"].get("id") == "enumerate"):
            # for i, x in enumerate(xs): second target iterates xs
            if (isinstance(node.target, ast.Tuple)
                    and len(node.target.elts) == 2
                    and isinstance(node.iter, ast.Call)
                    and node.iter.args):
                inner = describe_expr(node.iter.args[0], self.lock_names)
                self._bind(node.target.elts[1], {"t": "iter", "of": inner})
                self._bind(node.target.elts[0], {"t": "unknown"})
                self.generic_visit(node)
                return
        self._bind(node.target, {"t": "iter", "of": desc})
        self.generic_visit(node)

    # -- acquisitions -------------------------------------------------------

    def visit_With(self, node):  # noqa: N802
        # EVERY with-item is a potential acquisition: naming (`*_lock`)
        # is only the "must resolve" flag (R11's unresolvable-lock
        # finding) — whether the item IS a lock is decided at finalize
        # by resolving it to creation sites or a lock-wrapping class's
        # acquire/__enter__ (SharedFlock). The runtime witness sees a
        # `self._plock` no matter what it is called; so must we. An
        # ``open(...)``/ExitStack item resolves to nothing and
        # contributes nothing.
        pushed: List[Dict] = []
        for item in node.items:
            self.visit(item.context_expr)
            desc = describe_expr(item.context_expr, self.lock_names)
            if desc.get("t") in ("lock", "call", "attr", "name", "sub"):
                self.rec["acquires"].append(
                    {"lock": desc, "line": item.context_expr.lineno,
                     "held": [h["expr"] for h in self.held],
                     "lockish": _lockish_desc(item.context_expr),
                     "via": "with"})
                entry = _held_entry(desc)
                # The with's last line = the release boundary: a value
                # bound inside and used past it crossed the release
                # (R14). Explicit .acquire() entries carry no end —
                # flow-insensitively held to function exit, so nothing
                # lexically "crosses" their release.
                entry["end"] = getattr(node, "end_lineno", None)
                self.held.append(entry)
                pushed.append(entry)
            if item.optional_vars is not None:
                self._bind(item.optional_vars, desc)
        for stmt in node.body:
            self.visit(stmt)
        # Pop the with's OWN entries by identity — an unbalanced
        # explicit .acquire() in the body stays held past the with
        # (flow-insensitive), and a tail slice would pop IT instead of
        # the with-item, corrupting the stack for the rest of the
        # function.
        for entry in pushed:
            for i in range(len(self.held) - 1, -1, -1):
                if self.held[i] is entry:
                    del self.held[i]
                    break

    def visit_Call(self, node):  # noqa: N802
        chain = attr_chain(node.func)
        tail = chain[-1] if chain else ""
        if tail == "enter_context" and isinstance(node.func, ast.Attribute) \
                and len(node.args) == 1:
            # stack.enter_context(self._chip_locks[idx]): an ExitStack
            # acquisition — held until the stack unwinds, which the
            # flow-insensitive model rounds up to "rest of function"
            # (over-approximates edges in the safe direction). A
            # non-lock argument resolves to a class and is chased as a
            # wrapper or contributes nothing.
            arg = node.args[0]
            desc = describe_expr(arg, self.lock_names)
            self.rec["acquires"].append(
                {"lock": desc, "line": node.lineno,
                 "held": [h["expr"] for h in self.held],
                 "lockish": _lockish_desc(arg), "via": "enter_context"})
            self.held.append(_held_entry(desc))
            self.visit(arg)
            return
        if tail == "acquire" and len(chain) >= 2 \
                and isinstance(node.func, ast.Attribute):
            # Explicit X.acquire(): held for the rest of the function
            # (or until a matching .release()) — flow-insensitive, which
            # over-approximates edges in the right direction. Recorded
            # for EVERY receiver; finalize decides whether it is a lock
            # (creation site), a lock-wrapping object (SharedFlock: the
            # class's acquire method is chased), or neither (Semaphore:
            # no edges). `lockish` marks receivers the *_lock naming
            # convention claims are locks — those MUST resolve.
            recv = describe_expr(node.func.value, self.lock_names)
            entry = _held_entry(recv)
            self.rec["acquires"].append(
                {"lock": recv, "line": node.lineno,
                 "held": [h["expr"] for h in self.held],
                 "lockish": is_data_lock_name(chain[-2]),
                 "via": "acquire"})
            self.held.append(entry)
            self._explicit.append((".".join(chain[:-1]), entry))
        elif tail == "release" and len(chain) >= 2 \
                and isinstance(node.func, ast.Attribute):
            key = ".".join(chain[:-1])
            for i in range(len(self._explicit) - 1, -1, -1):
                if self._explicit[i][0] == key:
                    entry = self._explicit.pop(i)[1]
                    if entry in self.held:
                        self.held.remove(entry)
                    break
        elif isinstance(node.func, (ast.Name, ast.Attribute)):
            self.rec["calls"].append(
                {"expr": describe_expr(node.func, self.lock_names),
                 "line": node.lineno,
                 "held": [h["expr"] for h in self.held],
                 "args": [describe_expr(a, self.lock_names)
                          for a in node.args[:8]],
                 "kwargs": {kw.arg: describe_expr(kw.value,
                                                  self.lock_names)
                            for kw in node.keywords if kw.arg}})
            # A *_locked bound reference passed as an argument escapes
            # the lexical context (thread targets, callbacks).
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                self._maybe_ref(arg)
        # Visit children, but skip the call's own name: the method
        # attribute in `self._claims.pop()` is not a data access — the
        # receiver `self._claims` below it is, so descend past it.
        for child in ast.iter_child_nodes(node):
            if child is node.func:
                if isinstance(child, ast.Attribute):
                    self.visit(child.value)
                elif not isinstance(child, ast.Name):
                    self.visit(child)
            else:
                self.visit(child)

    def _maybe_ref(self, node: ast.AST) -> None:
        if isinstance(node, (ast.Name, ast.Attribute)):
            chain = attr_chain(node)
            if chain:
                self.rec["refs"].append(
                    {"expr": describe_expr(node, self.lock_names),
                     "line": node.lineno,
                     "held": [h["expr"] for h in self.held],
                     "locked_name": chain[-1].endswith("_locked")})

    # -- attribute accesses (R10) -------------------------------------------

    def visit_Attribute(self, node):  # noqa: N802
        if isinstance(node.value, ast.Name) and not (
                node.attr.startswith("__") and node.attr.endswith("__")):
            kind = "w" if isinstance(node.ctx, (ast.Store, ast.Del)) else "r"
            self.rec["accesses"].append(
                {"base": node.value.id, "attr": node.attr,
                 "line": node.lineno, "kind": kind,
                 "held": [[h["base"], h["attr"]] for h in self.held
                          if h["base"] is not None]})
        if node.attr.endswith("_locked") and isinstance(node.ctx, ast.Load):
            self._maybe_ref(node)
        self.generic_visit(node)

    def visit_Name(self, node):  # noqa: N802
        if node.id.endswith("_locked") and isinstance(node.ctx, ast.Load):
            self._maybe_ref(node)

    def run(self, fn) -> None:
        for stmt in fn.body:
            self.visit(stmt)
        # Mutator-method calls on first-level attrs count as writes:
        # upgrade the recorded read at the same (base, attr, line).
        writes = set()
        for call in ast.walk(fn):
            if (isinstance(call, ast.Call)
                    and isinstance(call.func, ast.Attribute)
                    and call.func.attr in _STATE_MUTATORS
                    and isinstance(call.func.value, ast.Attribute)
                    and isinstance(call.func.value.value, ast.Name)):
                writes.add((call.func.value.value.id,
                            call.func.value.attr, call.func.value.lineno))
        for acc in self.rec["accesses"]:
            if (acc["base"], acc["attr"], acc["line"]) in writes:
                acc["kind"] = "w"


# ---------------------------------------------------------------------------
# Per-module extraction (shared by R9/R10/R11 via one facts blob)
# ---------------------------------------------------------------------------

_GUARD_RE = re.compile(
    r"#\s*GUARDED_BY:\s*(?P<guard>[A-Za-z_][A-Za-z0-9_.]*|none)")


def _parse_guard_comments(source: str) -> Dict[int, str]:
    out: Dict[int, str] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                m = _GUARD_RE.search(tok.string)
                if m:
                    out[tok.start[0]] = m.group("guard")
    except (tokenize.TokenError, IndentationError):
        pass
    return out




def _scoped_returns(fn) -> List[ast.AST]:
    """Return-expression nodes of `fn`'s own scope (nested defs and
    lambdas are separate records; their returns must not leak into the
    enclosing function's return-type summary)."""
    out: List[ast.AST] = []
    stack: List[ast.AST] = list(fn.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, ast.Return) and node.value is not None:
            out.append(node.value)
        stack.extend(ast.iter_child_nodes(node))
    return out


def _scoped_nested_defs(fn) -> List[ast.AST]:
    """Function defs nested anywhere in `fn`'s own scope (inside
    if/with/try blocks included), excluding defs inside deeper nested
    functions — those belong to the nested record's own recursion."""
    out: List[ast.AST] = []
    stack: List[ast.AST] = list(fn.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.append(node)
            continue
        if isinstance(node, ast.Lambda):
            continue
        stack.extend(ast.iter_child_nodes(node))
    return out


def _scoped_lambdas(fn) -> List[ast.Lambda]:
    """Lambdas anywhere in `fn`'s own scope (descending through other
    lambdas: each gets its own record), stopping at nested defs."""
    out: List[ast.Lambda] = []
    stack: List[ast.AST] = list(fn.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if isinstance(node, ast.Lambda):
            out.append(node)
        stack.extend(ast.iter_child_nodes(node))
    return out


def _scoped_walk(fn) -> Iterator[ast.AST]:
    """Every node in `fn`'s own scope, stopping at nested defs and
    lambdas (their bodies belong to their own records)."""
    stack: List[ast.AST] = list(fn.body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _collect_mutations(fn) -> List[Dict]:
    """drflow (R13) mutation sinks in `fn`'s own scope: writes through
    an attribute/subscript chain, ``del``, and mutator-method calls —
    each reduced to the chain's ROOT: a local/param name
    (``{"root": name}``) or a self attribute (``{"root": "self",
    "attr": a}``). A plain ``self.a = v`` / ``x = v`` REBINDS rather
    than mutates and is not recorded (stores are tracked separately
    through self_assigns / locals)."""
    out: List[Dict] = []

    def add(chain: List[str], line: int, what: str,
            rebind_ok: bool) -> None:
        if not chain:
            return
        if chain[0] == "self":
            if len(chain) < 2 or (rebind_ok and len(chain) == 2):
                return
            out.append({"root": "self", "attr": chain[1],
                        "line": line, "what": what})
        elif not rebind_ok or len(chain) > 1:
            out.append({"root": chain[0], "line": line, "what": what})

    for node in _scoped_walk(fn):
        targets: Tuple = ()
        what = "assignment to"
        if isinstance(node, ast.Assign):
            targets = tuple(node.targets)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = (node.target,)
        elif isinstance(node, ast.Delete):
            targets, what = tuple(node.targets), "del of"
        for t in targets:
            if isinstance(t, ast.Subscript):
                add(attr_chain(t), t.lineno, what, rebind_ok=False)
            elif isinstance(t, ast.Attribute):
                # x.y = v mutates x; self.y = v rebinds the attribute.
                add(attr_chain(t), t.lineno, what, rebind_ok=True)
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _MUTATOR_METHODS):
            add(attr_chain(node.func.value), node.lineno,
                f".{node.func.attr}() on", rebind_ok=False)
    return out


# drflow annotation grammar (SURVEY §20): ``# drflow: view-ok[reason]``
# sanctions a mutation of a laundered-by-protocol view (R13);
# ``# drflow: swallow-ok[reason]`` sanctions a silent except handler
# (R15; the reason is REQUIRED — an empty one still counts as a
# finding under --require-justified semantics); ``# drflow:
# REVALIDATES:<field>`` on a def declares the function re-checks
# <field> against live state under its lock, which sanctions
# check-then-act flows routed through it (R14). ``<field>`` may be
# ``*`` (revalidates everything it touches).
_DRFLOW_RE = re.compile(
    r"#\s*drflow:\s*(?P<kind>view-ok|swallow-ok|REVALIDATES)"
    r"(?:\[(?P<reason>[^\]]*)\])?"
    r"(?::(?P<field>[A-Za-z_*][A-Za-z0-9_.*]*))?")


def _parse_drflow_comments(source: str) -> Dict[str, Dict[str, str]]:
    out: Dict[str, Dict[str, str]] = {
        "view_ok": {}, "swallow_ok": {}, "revalidates": {}}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type != tokenize.COMMENT:
                continue
            m = _DRFLOW_RE.search(tok.string)
            if not m:
                continue
            line = str(tok.start[0])
            kind = m.group("kind")
            if kind == "REVALIDATES":
                out["revalidates"][line] = m.group("field") or "*"
            else:
                out[kind.replace("-", "_")][line] = (
                    m.group("reason") or "").strip()
    except (tokenize.TokenError, IndentationError):
        pass
    return out


def extract_module(module: Module) -> Dict:
    """The shared extraction: functions (with calls/refs/acquires/
    accesses), classes, imports, module-global locks, GUARDED_BY
    annotations. Memoized on the Module object — R9/R10/R11 all read
    the same blob and it is cached once under R9's facts key."""
    cached = getattr(module, "_race_facts", None)
    if cached is not None:
        return cached
    imports = _module_imports(module.tree)
    lock_names: Dict[str, str] = {}
    for n, t in imports.items():
        if t in ("threading.Lock", "threading.RLock"):
            lock_names[n] = "lock"
        elif t == "threading.Condition":
            lock_names[n] = "cond"
    # Constructor aliases: ``_real_lock = threading.Lock`` (lockwitness
    # keeps raw references so its own internals stay unwitnessed) —
    # calls through the alias are still creations at the CALL site.
    for node in module.tree.body:
        if isinstance(node, ast.Assign) and isinstance(
                node.value, (ast.Attribute, ast.Name)):
            chain = attr_chain(node.value)
            kind = None
            if chain[-2:] in (["threading", "Lock"],
                              ["threading", "RLock"]):
                kind = "lock"
            elif chain[-2:] == ["threading", "Condition"]:
                kind = "cond"
            elif len(chain) == 1 and chain[0] in lock_names:
                kind = lock_names[chain[0]]
            if kind:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        lock_names[t.id] = kind
    guards = _parse_guard_comments(module.source)

    functions: Dict[str, Dict] = {}
    classes: Dict[str, Dict] = {}
    global_locks: Dict[str, List[int]] = {}

    def record_function(node, qual: str, cls: Optional[str]) -> None:
        rec = {
            "qual": qual, "name": node.name, "cls": cls,
            "line": node.lineno,
            "locked_name": node.name.endswith("_locked"),
            "params": [
                {"name": a.arg,
                 "ann": (".".join(attr_chain(a.annotation))
                         if a.annotation is not None
                         and attr_chain(a.annotation) else None)}
                for a in (node.args.posonlyargs + node.args.args
                          + node.args.kwonlyargs)]
            + ([{"name": node.args.vararg.arg, "vararg": True,
                 "ann": (".".join(attr_chain(node.args.vararg.annotation))
                         if node.args.vararg.annotation is not None
                         and attr_chain(node.args.vararg.annotation)
                         else None)}]
               if node.args.vararg is not None else []),
            "locals": {}, "calls": [], "refs": [],
            "acquires": [], "accesses": [], "self_assigns": [],
            "returns": [],
            # Return annotation: the fallback type when no return
            # expression resolves (``def counter(...) -> Counter``
            # returning through a generic register() helper).
            "ret_ann": (".".join(attr_chain(node.returns))
                        if getattr(node, "returns", None) is not None
                        and attr_chain(node.returns) else None),
            "decorators": [".".join(attr_chain(d))
                           for d in node.decorator_list
                           if attr_chain(d)],
            "mutations": _collect_mutations(node),
        }
        v = _FuncRecorder(rec, lock_names)
        v.run(node)
        for ret in _scoped_returns(node):
            rec["returns"].append(describe_expr(ret, lock_names))
        functions[qual] = rec
        # Nested defs become their own records — no inherited lock
        # context (the R1 nested-def reset, now whole-tree).
        for sub in _scoped_nested_defs(node):
            record_function(sub, f"{qual}.{sub.name}", cls)
        # Lambdas too: a ``lambda obj: self._on_claim(None, obj)``
        # registered as a handler is a deferred body with NO inherited
        # lock context; `cls` rides along so `self` resolves.
        for lam in _scoped_lambdas(node):
            lq = f"<lambda@{lam.lineno}:{lam.col_offset}>"
            lrec = {
                "qual": lq, "name": "<lambda>", "cls": cls,
                "line": lam.lineno, "locked_name": False,
                "params": [{"name": a.arg, "ann": None}
                           for a in (lam.args.posonlyargs + lam.args.args
                                     + lam.args.kwonlyargs)],
                "locals": {}, "calls": [], "refs": [],
                "acquires": [], "accesses": [], "self_assigns": [],
                "returns": [describe_expr(lam.body, lock_names)],
                "ret_ann": None,
            }
            lv = _FuncRecorder(lrec, lock_names)
            lv.visit(lam.body)
            functions[lq] = lrec

    global_insts: Dict[str, Dict] = {}

    for node in module.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            record_function(node, node.name, None)
        elif isinstance(node, ast.ClassDef):
            cinfo: Dict = {
                "bases": [".".join(attr_chain(b)) for b in node.bases
                          if attr_chain(b)],
                "line": node.lineno,
                "class_locks": {},
            }
            for sub in node.body:
                if isinstance(sub, ast.Assign):
                    locks = _find_lock_creations(sub.value, lock_names)
                    if locks:
                        for t in sub.targets:
                            if isinstance(t, ast.Name):
                                cinfo["class_locks"][t.id] = locks
                elif isinstance(sub, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    record_function(sub, f"{node.name}.{sub.name}",
                                    node.name)
            classes[node.name] = cinfo
        elif isinstance(node, ast.Assign):
            locks = _find_lock_creations(node.value, lock_names)
            if locks:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        global_locks[t.id] = locks
            elif isinstance(node.value, ast.Call):
                # Module-global singleton (``FAULTS = FaultRegistry()``,
                # ``_PREPS = _METRICS.counter(...)``): the instance's
                # type is resolved lazily in the <module> pseudo-scope.
                desc = describe_expr(node.value, lock_names)
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        global_insts[t.id] = desc

    # The <module> pseudo-record: a resolution scope for module-level
    # value expressions (global singleton types chase imports and
    # helper returns exactly like function-local code).
    functions["<module>"] = {
        "qual": "<module>", "name": "<module>", "cls": None, "line": 0,
        "locked_name": False, "params": [], "locals": {}, "calls": [],
        "refs": [], "acquires": [], "accesses": [], "self_assigns": [],
        "returns": [], "ret_ann": None,
    }

    facts = {
        "imports": imports,
        "functions": functions,
        "classes": classes,
        "global_locks": global_locks,
        "global_insts": global_insts,
        "guards": {str(k): v for k, v in guards.items()},
        "drflow": _parse_drflow_comments(module.source),
    }
    module._race_facts = facts  # type: ignore[attr-defined]
    return facts


# ---------------------------------------------------------------------------
# Whole-tree resolver (finalize-time)
# ---------------------------------------------------------------------------

_MISSING_CHAIN = object()


@dataclass
class _ClassInfo:
    cid: str                      # "relpath::ClassName"
    relpath: str
    name: str
    bases: List[str]              # raw base chains, resolved lazily
    methods: Dict[str, str] = field(default_factory=dict)  # name -> fid
    lock_attrs: Dict[str, List[str]] = field(default_factory=dict)
    attr_types: Dict[str, Dict] = field(default_factory=dict)
    guard_ann: Dict[str, str] = field(default_factory=dict)
    attr_lines: Dict[str, int] = field(default_factory=dict)


class TreeResolver:
    """The whole-tree symbol/type/call resolver R9-R11 share. Built in
    finalize from every module's facts; all resolution rules live here
    so fixtures can target them one at a time."""

    def __init__(self, modules: Dict[str, Dict]):
        self.modules = modules              # relpath -> facts
        self.dotted: Dict[str, str] = {}    # dotted module name -> relpath
        self.classes: Dict[str, _ClassInfo] = {}
        self.funcs: Dict[str, Dict] = {}    # fid -> record
        self.func_mod: Dict[str, str] = {}  # fid -> relpath
        self.methods_by_name: Dict[str, List[str]] = {}
        self.returns: Dict[str, Optional[Dict]] = {}   # fid -> type
        self.subclasses: Dict[str, List[str]] = {}  # cid -> direct subs
        # (fid, id(call record)) -> resolve_call result; call records
        # live as long as the resolver (facts are held by `modules`).
        self._call_memo: Dict[Tuple[str, int],
                              Tuple[List[str], bool]] = {}
        # (fid, id(desc)) -> (desc, result) for top-level resolve_type.
        # The DESC REFERENCE in the value is load-bearing: it pins the
        # descriptor alive so its id can never be reused by a transient
        # dict (the id-keyed-memo poisoning bug class).
        self._type_memo: Dict[Tuple[str, int],
                              Tuple[Dict, Optional[Dict]]] = {}
        # (chain tuple, rel) -> class id; the unique-global-name
        # fallback scans every class otherwise (hot under drflow).
        self._chain_memo: Dict[Tuple[Tuple[str, ...], Optional[str]],
                               Optional[str]] = {}
        # Type results move during _build (return-summary fixpoints,
        # ctor-arg flow update the tables resolve_type reads): the
        # memo only switches on once the tables are final.
        self._memo_enabled = False
        self._build()
        self._memo_enabled = True

    # -- construction -------------------------------------------------------

    @staticmethod
    def _dotted_name(relpath: str) -> str:
        p = relpath[:-3] if relpath.endswith(".py") else relpath
        if p.endswith("/__init__"):
            p = p[: -len("/__init__")]
        return p.replace("/", ".")

    def _build(self) -> None:
        # Sorted: the modules dict's insertion order varies between
        # warm/cold/parallel runs; resolution (methods_by_name order,
        # unique-name class fallbacks) must not.
        for rel, facts in sorted(self.modules.items()):
            self.dotted[self._dotted_name(rel)] = rel
            for cname, cinfo in facts["classes"].items():
                cid = f"{rel}::{cname}"
                info = _ClassInfo(cid=cid, relpath=rel, name=cname,
                                  bases=list(cinfo.get("bases", ())))
                for attr, lines in cinfo.get("class_locks", {}).items():
                    info.lock_attrs[attr] = [f"{rel}:{ln}" for ln in lines]
                self.classes[cid] = info
            for qual, rec in facts["functions"].items():
                fid = f"{rel}::{qual}"
                self.funcs[fid] = rec
                self.func_mod[fid] = rel
        # Attach methods + attr tables.
        for rel, facts in sorted(self.modules.items()):
            guards = {int(k): v for k, v in facts.get("guards", {}).items()}
            for qual, rec in facts["functions"].items():
                fid = f"{rel}::{qual}"
                cls = rec.get("cls")
                if cls and qual == f"{cls}.{rec['name']}":
                    cid = f"{rel}::{cls}"
                    info = self.classes.get(cid)
                    if info is not None:
                        info.methods[rec["name"]] = fid
                        self.methods_by_name.setdefault(
                            rec["name"], []).append(fid)
                for sa in rec.get("self_assigns", ()):
                    cid = f"{rel}::{cls}" if cls else None
                    info = self.classes.get(cid) if cid else None
                    if info is None:
                        continue
                    attr, val = sa["attr"], sa["value"]
                    info.attr_lines.setdefault(attr, sa["line"])
                    locks = self._desc_lock_lines(val)
                    if locks:
                        info.lock_attrs.setdefault(attr, [])
                        for ln in locks:
                            site = f"{rel}:{ln}"
                            if site not in info.lock_attrs[attr]:
                                info.lock_attrs[attr].append(site)
                    ctor = self._desc_ctor(val)
                    if ctor is not None:
                        info.attr_types.setdefault(attr, ctor)
                    ann = guards.get(sa["line"]) or guards.get(
                        sa["line"] - 1)
                    if ann and attr not in info.guard_ann:
                        info.guard_ann[attr] = ann
        # Subclass index (class-hierarchy analysis): a call resolved to
        # a BASE-typed receiver must also consider every override a
        # subclass supplies — the annotation says TpuInfoBackend, the
        # runtime object is a FakeBackend whose chips() takes its own
        # lock. Built after every class is registered so forward
        # references resolve.
        for cid, info in self.classes.items():
            for b in info.bases:
                bid = self._resolve_class_chain(b.split("."),
                                                rel=info.relpath)
                if bid and bid in self.classes:
                    self.subclasses.setdefault(bid, []).append(cid)
        # Return-type summaries: a couple of fixpoint rounds is plenty
        # for the helper patterns the tree uses (_shard_for, _lock_for).
        self.returns = {fid: None for fid in self.funcs}
        for _ in range(3):
            changed = False
            for fid, rec in self.funcs.items():
                if self.returns[fid] is not None:
                    continue
                for rdesc in rec.get("returns", ()):
                    t = self.resolve_type(rdesc, fid)
                    if t is not None:
                        self.returns[fid] = t
                        changed = True
                        break
            if not changed:
                break
        # Return-annotation fallback: a factory whose return expression
        # funnels through a generic helper (``return self.register(
        # Counter(...))``) still declares what it hands back.
        for fid, rec in self.funcs.items():
            ann = rec.get("ret_ann")
            if self.returns.get(fid) is None and ann:
                cid = self._resolve_class_chain(
                    ann.split("."), rel=self.func_mod[fid])
                if cid:
                    self.returns[fid] = {"cls": cid}
        # Post-returns pass: attribute types that only resolve through
        # helper returns or parameter annotations (``self._rl =
        # default_controller_rate_limiter()``, ``self._limiters =
        # <vararg param>``) — needs the return summaries above.
        for fid, rec in self.funcs.items():
            info = self.class_of(fid)
            if info is None:
                continue
            for sa in rec.get("self_assigns", ()):
                attr = sa["attr"]
                if attr in info.attr_types or attr in info.lock_attrs:
                    continue
                t = self.resolve_type(sa["value"], fid)
                if t is None:
                    continue
                if "cls" in t:
                    info.attr_types[attr] = {"cls": t["cls"]}
                elif "container_of" in t:
                    info.attr_types[attr] = {"elem": t["container_of"]}
                elif "lock" in t:
                    info.lock_attrs[attr] = list(t["lock"])
        self._ctor_arg_flow()
        self._callback_flow()

    def _ctor_arg_flow(self) -> None:
        """Constructor-argument flow: ``self.x = <param>`` in a class's
        ``__init__`` takes the lock/class of the argument passed at
        each resolved construction site — the informer hands its RLock
        to ``_Lister``, the driver hands a ``Flock`` to ``SharedFlock``;
        the receiving attribute inherits the creation sites."""
        for _ in range(2):
            changed = False
            for fid, rec in self.funcs.items():
                for call in rec.get("calls", ()):
                    fn = self.resolve_type(call["expr"], fid)
                    if not fn or "clsref" not in fn:
                        continue
                    info = self.classes.get(fn["clsref"])
                    init = (self.class_method(info, "__init__")
                            if info else None)
                    if init is None:
                        continue
                    irec = self.funcs[init]
                    params = [p["name"] for p in irec["params"]][1:]
                    p2a: Dict[str, List[str]] = {}
                    for sa in irec.get("self_assigns", ()):
                        v = sa["value"]
                        if v.get("t") == "name" and v["id"] in params:
                            p2a.setdefault(v["id"], []).append(sa["attr"])
                    if not p2a:
                        continue
                    bound: Dict[str, Dict] = dict(
                        zip(params, call.get("args", ())))
                    bound.update(call.get("kwargs", {}))
                    for pname, attrs in p2a.items():
                        adesc = bound.get(pname)
                        if adesc is None:
                            continue
                        at = self.resolve_type(adesc, fid)
                        if at is None:
                            continue
                        for attr in attrs:
                            if "lock" in at:
                                cur = info.lock_attrs.setdefault(attr, [])
                                for s in at["lock"]:
                                    if s not in cur:
                                        cur.append(s)
                                        changed = True
                            elif "cls" in at \
                                    and attr not in info.attr_types:
                                info.attr_types[attr] = {"cls": at["cls"]}
                                changed = True
            if not changed:
                break

    def _callback_flow(self) -> None:
        """Callback-registry points-to: a bound method handed to
        ``informer.on_add(self._pod_added)`` is appended into the
        informer's handler list and invoked later as ``h(*args)`` under
        the informer's lock — an acquisition path no direct call graph
        sees. Tracks (a) callables appended/assigned into ``self._X``
        (directly or through the receiving method's parameter) and
        (b) per-parameter callable sets flowing from resolved call
        sites, to a fixpoint; ``_callables_of`` then resolves an
        indirect call expression to its candidate targets."""
        self.attr_callables: Dict[Tuple[str, str], Set[str]] = {}
        self.param_callables: Dict[Tuple[str, str], Set[str]] = {}
        param_sinks: Dict[Tuple[str, str], List[Tuple[str, str]]] = {}
        for fid, rec in self.funcs.items():
            info = self.class_of(fid)
            if info is None:
                continue
            pnames = {p["name"] for p in rec["params"]}
            for sa in rec.get("self_assigns", ()):
                v = sa["value"]
                sink = (info.cid, sa["attr"])
                if v.get("t") == "name" and v["id"] in pnames:
                    param_sinks.setdefault((fid, v["id"]), []).append(sink)
            for call in rec["calls"]:
                e = call["expr"]
                if not (e.get("t") == "attr" and e["attr"] == "append"
                        and e["base"].get("t") == "attr"
                        and e["base"]["base"].get("t") == "name"
                        and e["base"]["base"]["id"] == "self"
                        and call.get("args")):
                    continue
                a0 = call["args"][0]
                sink = (info.cid, e["base"]["attr"])
                if a0.get("t") == "name" and a0["id"] in pnames:
                    param_sinks.setdefault((fid, a0["id"]), []).append(sink)
                else:
                    t = self.resolve_type(a0, fid)
                    if t and "func" in t:
                        self.attr_callables.setdefault(
                            sink, set()).add(t["func"])
        for _ in range(6):  # bounded fixpoint (chains are shallow)
            changed = False
            for fid, rec in self.funcs.items():
                for call in rec["calls"]:
                    args = call.get("args")
                    kwargs = call.get("kwargs")
                    if not args and not kwargs:
                        continue
                    for m in self.resolve_call(call, fid,
                                               chase_callbacks=False)[0]:
                        mrec = self.funcs.get(m)
                        if mrec is None:
                            continue
                        params = [p["name"] for p in mrec["params"]]
                        if mrec.get("cls") and params \
                                and params[0] in ("self", "cls"):
                            params = params[1:]
                        bound = dict(zip(params, args or ()))
                        for k, v in (kwargs or {}).items():
                            if k in params:
                                bound[k] = v
                        for pname, adesc in bound.items():
                            fset = self._callables_of(adesc, fid)
                            if not fset:
                                continue
                            cur = self.param_callables.setdefault(
                                (m, pname), set())
                            if fset - cur:
                                cur |= fset
                                changed = True
                            for sink in param_sinks.get((m, pname), ()):
                                scur = self.attr_callables.setdefault(
                                    sink, set())
                                if fset - scur:
                                    scur |= fset
                                    changed = True
            if not changed:
                break

    def _callables_of(self, desc: Dict, fid: str,
                      depth: int = 0) -> Set[str]:
        """Candidate targets of an indirect-call expression: a bound
        reference, a parameter fed callables at resolved call sites, a
        handler-list attribute, or an element of one."""
        if depth > 6 or desc is None:
            return set()
        t_res = self.resolve_type(desc, fid)
        if t_res is not None and "func" in t_res:
            return {t_res["func"]}
        t = desc.get("t")
        if t == "attr":
            base = self.resolve_type(desc["base"], fid)
            cid = base.get("cls") if base else None
            if cid in self.classes:
                out: Set[str] = set()
                for c in self._mro(self.classes[cid]):
                    out |= self.attr_callables.get(
                        (c.cid, desc["attr"]), set())
                return out
            return set()
        if t == "name":
            nm = desc["id"]
            rec = self.funcs.get(fid)
            if rec is None:
                return set()
            if any(p["name"] == nm for p in rec["params"]):
                return set(self.param_callables.get((fid, nm), ()))
            for b in rec["locals"].get(nm, ()):
                out = self._callables_of(b, fid, depth + 1)
                if out:
                    return out
            return set()
        if t == "iter":
            return self._callables_of(desc["of"], fid, depth + 1)
        if t == "sub":
            return self._callables_of(desc["base"], fid, depth + 1)
        if t == "lambda":
            rel = self.func_mod.get(fid)
            lfid = f"{rel}::<lambda@{desc['line']}:{desc['col']}>"
            if lfid in self.funcs:
                return {lfid}
        if t == "call":
            # functools.partial(self._on_evt, key): the partial IS the
            # callable — its target is the first argument.
            chain = self._desc_chain(desc.get("func", {})) or []
            if chain and chain[-1] == "partial" and desc.get("args"):
                return self._callables_of(desc["args"][0], fid,
                                          depth + 1)
        return set()

    @staticmethod
    def _desc_lock_lines(desc: Dict) -> List[int]:
        t = desc.get("t")
        if t == "lock":
            return [desc["line"]]
        if t == "container":
            return list(desc.get("locks", ()))
        if t == "call":
            return list(desc.get("arg_locks", ()))
        return []

    def _desc_ctor(self, desc: Dict) -> Optional[Dict]:
        """{'cls': cid} or {'elem': cid} when the descriptor constructs
        (a container of) a tree-known class."""
        t = desc.get("t")
        if t == "call":
            chain = self._desc_chain(desc["func"])
            return None if chain is None else self._ctor_of(chain)
        if t == "container":
            for e in desc.get("elems", ()):
                inner = self._desc_ctor(e)
                if inner and "cls" in inner:
                    return {"elem": inner["cls"]}
        return None

    def _ctor_of(self, chain: List[str]) -> Optional[Dict]:
        cid = self._resolve_class_chain(chain)
        return {"cls": cid} if cid else None

    @staticmethod
    def _desc_chain(desc: Dict) -> Optional[List[str]]:
        out: List[str] = []
        d = desc
        while True:
            t = d.get("t")
            if t == "attr":
                out.append(d["attr"])
                d = d["base"]
            elif t == "name":
                out.append(d["id"])
                return list(reversed(out))
            else:
                return None

    # -- symbol resolution --------------------------------------------------

    def _module_symbol(self, rel: str, name: str, depth: int = 0):
        """('class', cid) | ('func', fid) | ('lock', [sites]) |
        ('module', relpath) | None — following import aliases across
        the tree (bounded depth: import cycles must not hang lint)."""
        if depth > 4 or rel not in self.modules:
            return None
        facts = self.modules[rel]
        if name in facts["classes"]:
            return ("class", f"{rel}::{name}")
        if name in facts["functions"] and "." not in name:
            return ("func", f"{rel}::{name}")
        if name in facts["global_locks"]:
            return ("lock", [f"{rel}:{ln}"
                             for ln in facts["global_locks"][name]])
        if name in facts.get("global_insts", {}):
            return ("inst", (rel, facts["global_insts"][name]))
        target = facts["imports"].get(name)
        if target is None:
            return None
        if target in self.dotted:
            return ("module", self.dotted[target])
        if "." in target:
            mod, _, leaf = target.rpartition(".")
            if mod in self.dotted:
                return self._module_symbol(self.dotted[mod], leaf,
                                           depth + 1)
        return None

    def _resolve_class_chain(self, chain: List[str],
                             rel: Optional[str] = None) -> Optional[str]:
        """ClassName / mod.ClassName chains to a class id; with no
        module context, fall back to a unique global name match."""
        key = (tuple(chain), rel)
        hit = self._chain_memo.get(key, _MISSING_CHAIN)
        if hit is not _MISSING_CHAIN:
            return hit
        out = self._resolve_class_chain_uncached(chain, rel)
        self._chain_memo[key] = out
        return out

    def _resolve_class_chain_uncached(self, chain: List[str],
                                      rel: Optional[str] = None
                                      ) -> Optional[str]:
        if rel is not None:
            sym = self._module_symbol(rel, chain[0])
            if sym is not None:
                kind, val = sym
                if kind == "class" and len(chain) == 1:
                    return val
                if kind == "module" and len(chain) == 2:
                    sub = self._module_symbol(val, chain[1])
                    if sub and sub[0] == "class":
                        return sub[1]
            if len(chain) == 1:
                local = f"{rel}::{chain[0]}"
                if local in self.classes:
                    return local
        name = chain[-1]
        cands = [cid for cid in self.classes
                 if cid.endswith(f"::{name}")]
        return cands[0] if len(cands) == 1 else None

    def class_of(self, fid: str) -> Optional[_ClassInfo]:
        rec = self.funcs.get(fid)
        if rec is None or not rec.get("cls"):
            return None
        return self.classes.get(f"{self.func_mod[fid]}::{rec['cls']}")

    def _mro(self, info: _ClassInfo, seen=None) -> List[_ClassInfo]:
        seen = seen if seen is not None else set()
        if info.cid in seen:
            return []
        seen.add(info.cid)
        out = [info]
        for b in info.bases:
            bid = self._resolve_class_chain(b.split("."),
                                            rel=info.relpath)
            if bid and bid in self.classes:
                out.extend(self._mro(self.classes[bid], seen))
        return out

    def class_lock_attrs(self, info: _ClassInfo) -> Dict[str, List[str]]:
        out: Dict[str, List[str]] = {}
        for c in reversed(self._mro(info)):
            out.update(c.lock_attrs)
        return out

    def class_method(self, info: _ClassInfo, name: str) -> Optional[str]:
        for c in self._mro(info):
            fid = c.methods.get(name)
            if fid is not None:
                return fid
        return None

    def _descendants(self, cid: str) -> Set[str]:
        out: Set[str] = set()
        stack = list(self.subclasses.get(cid, ()))
        while stack:
            c = stack.pop()
            if c in out:
                continue
            out.add(c)
            stack.extend(self.subclasses.get(c, ()))
        return out

    def class_method_cha(self, info: _ClassInfo, name: str) -> List[str]:
        """Dispatch candidates for `info`-typed receiver calling `name`:
        the MRO resolution PLUS every override (or first definition) a
        transitive subclass supplies — the receiver's static type is an
        upper bound, not the runtime class."""
        out: List[str] = []
        m = self.class_method(info, name)
        if m is not None:
            out.append(m)
        for sub in sorted(self._descendants(info.cid)):
            sm = self.classes[sub].methods.get(name)
            if sm is not None and sm not in out:
                out.append(sm)
        return out

    def class_attr_type(self, info: _ClassInfo, attr: str) -> Optional[Dict]:
        for c in self._mro(info):
            t = c.attr_types.get(attr)
            if t is not None:
                return t
        return None

    def class_guard_ann(self, info: _ClassInfo, attr: str) -> Optional[str]:
        for c in self._mro(info):
            g = c.guard_ann.get(attr)
            if g is not None:
                return g
        return None

    # -- type resolution ----------------------------------------------------

    def resolve_type(self, desc: Dict, fid: str,
                     depth: int = 0) -> Optional[Dict]:
        """{'cls': cid} | {'lock': [sites]} for an expression descriptor
        evaluated in `fid`'s scope, else None (unknown). Top-level
        resolutions are memoized (descriptors are immutable once
        extracted; the memo holds the desc so id-reuse cannot alias)."""
        if depth > 6 or desc is None:
            return None
        if depth == 0 and self._memo_enabled:
            key = (fid, id(desc))
            hit = self._type_memo.get(key)
            if hit is not None and hit[0] is desc:
                return hit[1]
            out = self._resolve_type_inner(desc, fid, 0)
            self._type_memo[key] = (desc, out)
            return out
        return self._resolve_type_inner(desc, fid, depth)

    def _resolve_type_inner(self, desc: Dict, fid: str,
                            depth: int) -> Optional[Dict]:
        rel = self.func_mod.get(fid)
        rec = self.funcs.get(fid)
        if rec is None or rel is None:
            return None
        t = desc.get("t")
        if t == "lock":
            return {"lock": [f"{rel}:{desc['line']}"]}
        if t == "name":
            nm = desc["id"]
            if nm == "self":
                info = self.class_of(fid)
                return {"cls": info.cid} if info else None
            # Own locals, then enclosing-function scopes (closures: a
            # worker nested in a harness captures the harness's lock).
            scope_fid: Optional[str] = fid
            while scope_fid is not None:
                srec = self.funcs.get(scope_fid)
                if srec is None:
                    break
                for b in srec["locals"].get(nm, ()):
                    if b.get("t") == "nested":
                        return {"func": f"{rel}::{b['qual']}"}
                    r = self.resolve_type(b, scope_fid, depth + 1)
                    if r is not None:
                        return r
                for p in srec.get("params", ()):
                    if p["name"] == nm and p.get("ann"):
                        cid = self._resolve_class_chain(
                            p["ann"].split("."), rel=rel)
                        if cid:
                            # ``*limiters: RateLimiter`` annotates the
                            # ELEMENT type; the name binds a tuple.
                            return ({"container_of": cid}
                                    if p.get("vararg") else {"cls": cid})
                qual = srec["qual"]
                scope_fid = (f"{rel}::{qual.rsplit('.', 1)[0]}"
                             if "." in qual else None)
            sym = self._module_symbol(rel, nm)
            if sym is not None:
                kind, val = sym
                if kind == "lock":
                    return {"lock": val}
                if kind == "class":
                    return {"clsref": val}
                if kind == "func":
                    return {"func": val}
                if kind == "module":
                    return {"mod": val}
                if kind == "inst":
                    irel, idesc = val
                    return self.resolve_type(idesc, f"{irel}::<module>",
                                             depth + 1)
            return None
        if t == "attr":
            base = self.resolve_type(desc["base"], fid, depth + 1)
            if base is None:
                return None
            if "cls" in base:
                info = self.classes.get(base["cls"])
                if info is None:
                    return None
                locks = self.class_lock_attrs(info).get(desc["attr"])
                if locks:
                    return {"lock": locks}
                at = self.class_attr_type(info, desc["attr"])
                if at is not None:
                    if "cls" in at:
                        return {"cls": at["cls"]}
                    if "elem" in at:
                        return {"container_of": at["elem"]}
                m = self.class_method(info, desc["attr"])
                if m is not None:
                    decs = self.funcs.get(m, {}).get("decorators") or ()
                    if any(d.split(".")[-1] in ("property",
                                                "cached_property")
                           for d in decs):
                        # Property access: the VALUE is the getter's
                        # return, not a bound method.
                        return self.returns.get(m)
                    return {"func": m, "method": True,
                            "of_cls": info.cid, "mname": desc["attr"]}
                return None
            if "mod" in base:
                sym = self._module_symbol(base["mod"], desc["attr"])
                if sym is not None:
                    kind, val = sym
                    if kind == "lock":
                        return {"lock": val}
                    if kind == "class":
                        return {"clsref": val}
                    if kind == "func":
                        return {"func": val}
                    if kind == "inst":
                        irel, idesc = val
                        return self.resolve_type(
                            idesc, f"{irel}::<module>", depth + 1)
                return None
            return None
        if t == "sub":
            base = self.resolve_type(desc["base"], fid, depth + 1)
            if base and "container_of" in base:
                return {"cls": base["container_of"]}
            if base and "lock" in base:
                # Subscript into a lock container (self._chip_locks[i]):
                # every element shares the container's creation site(s).
                return {"lock": base["lock"]}
            return None
        if t == "iter":
            base = self.resolve_type(desc["of"], fid, depth + 1)
            if base and "container_of" in base:
                return {"cls": base["container_of"]}
            if base and "lock" in base:
                return {"lock": base["lock"]}
            return None
        if t == "call":
            if desc.get("arg_locks"):
                # e.g. self._locks.setdefault(k, threading.Lock()) — the
                # expression yields a lock created at the embedded site.
                return {"lock": [f"{rel}:{ln}"
                                 for ln in desc["arg_locks"]]}
            fn = self.resolve_type(desc["func"], fid, depth + 1)
            if fn is None:
                return None
            if "clsref" in fn:
                return {"cls": fn["clsref"]}
            if "func" in fn:
                return self.returns.get(fn["func"])
            return None
        if t == "container":
            ctor = self._desc_ctor(desc)
            if ctor and "elem" in ctor:
                return {"container_of": ctor["elem"]}
            if desc.get("locks"):
                return None
        return None

    # -- call resolution ----------------------------------------------------

    def resolve_call(self, call: Dict, fid: str,
                     chase_callbacks: bool = True
                     ) -> Tuple[List[str], bool]:
        """(candidate fids, via_fallback): the callee set for a call
        descriptor. Dynamic-dispatch conservatism: an unresolvable
        receiver falls back to every tree class defining the method —
        always for *_locked names, never for builtin-ish names.
        `chase_callbacks=False` is the registry-construction mode (the
        callback fixpoint itself must not consume its own output).
        Memoized per call record: R9 and R11 (callees + edge pass)
        each re-resolve every call, and the resolution chase dominates
        finalize time."""
        if chase_callbacks:
            key = (fid, id(call))
            hit = self._call_memo.get(key)
            if hit is None:
                hit = self._resolve_call_uncached(call, fid, True)
                self._call_memo[key] = hit
            return hit
        return self._resolve_call_uncached(call, fid, False)

    def _resolve_call_uncached(self, call: Dict, fid: str,
                               chase_callbacks: bool
                               ) -> Tuple[List[str], bool]:
        desc = call["expr"]
        fn = self.resolve_type(desc, fid)
        if fn is not None and "func" in fn:
            if fn.get("method") and fn.get("of_cls") in self.classes:
                return self.class_method_cha(
                    self.classes[fn["of_cls"]], fn["mname"]), False
            return [fn["func"]], False
        if fn is None and desc.get("t") == "attr":
            # Receiver resolved to a class that does not itself define
            # the method (abstract protocol): subclasses that do are
            # still dispatch candidates.
            base = self.resolve_type(desc["base"], fid)
            cid = base.get("cls") if base else None
            if cid in self.classes:
                cands = self.class_method_cha(self.classes[cid],
                                              desc["attr"])
                if cands:
                    return cands, False
        if chase_callbacks:
            cbs = self._callables_of(desc, fid)
            if cbs:
                return sorted(cbs), False
        chain = self._desc_chain(desc)
        if chain and len(chain) >= 2:
            name = chain[-1]
            if name.endswith("_locked") or name not in _NO_GLOBAL_FALLBACK:
                cands = self.methods_by_name.get(name, [])
                if name.endswith("_locked") or len(cands) <= 4:
                    return list(cands), True
        return [], False

    def resolve_lock_sites(self, desc: Dict, fid: str) -> List[str]:
        r = self.resolve_type(desc, fid)
        if r is not None and "lock" in r:
            return r["lock"]
        return []


# Draracer and drflow finalize against the SAME tree facts (shared
# through one cache key): building the resolver twice per run would
# double the dominant finalize cost. Keyed by the facts objects'
# identities — a new run's fresh extraction misses, a second rule's
# identical absorption hits.
_RESOLVER_CACHE: Optional[Tuple[frozenset, TreeResolver]] = None


def shared_resolver(tree_facts: Dict[str, Dict]) -> TreeResolver:
    global _RESOLVER_CACHE
    key = frozenset((rel, id(f)) for rel, f in tree_facts.items())
    if _RESOLVER_CACHE is not None and _RESOLVER_CACHE[0] == key:
        return _RESOLVER_CACHE[1]
    res = TreeResolver(tree_facts)
    _RESOLVER_CACHE = (key, res)
    return res


# ---------------------------------------------------------------------------
# R9/R10/R11: one combined rule over the shared extraction
# ---------------------------------------------------------------------------

@register
class RaceAnalysis(Rule):
    """draracer (R9-R11): see the module docstring. One Rule so the
    three passes share a single extraction blob through the facts
    protocol; core filters findings per requested rule id."""

    rule_id = "R9"
    provides = frozenset({"R9", "R10", "R11"})
    title = "interprocedural lockset / guarded-by / lock-order"

    def __init__(self):
        self.tree_facts: Dict[str, Dict] = {}
        self._last_facts: Optional[Dict] = None
        # Populated by finalize, read by the CLI (--locks-report,
        # --check-witness) the same way FaultSiteRegistry feeds
        # --sites-report.
        self.resolver: Optional[TreeResolver] = None
        self.static_edges: Dict[Tuple[str, str], List[str]] = {}
        self.guard_table: List[Dict] = []

    def scan(self, module: Module, ctx: ProjectContext) -> Iterator[Finding]:
        if module.is_test:
            return iter(())
        facts = extract_module(module)
        self._last_facts = facts
        self.tree_facts[module.relpath] = facts
        return iter(())

    def module_facts(self) -> Optional[Dict]:
        facts, self._last_facts = self._last_facts, None
        return facts

    def absorb_facts(self, relpath: str, facts: Dict,
                     ctx: ProjectContext) -> None:
        self.tree_facts[relpath] = facts

    # -- finalize -----------------------------------------------------------

    def finalize(self, ctx: ProjectContext) -> Iterator[Finding]:
        if not self.tree_facts:
            return
        res = self.resolver = shared_resolver(self.tree_facts)
        yield from self._r9(res)
        yield from self._r10(res)
        yield from self._r11(res)

    # -- R9 -----------------------------------------------------------------

    @staticmethod
    def _desc_lockish(desc: Dict) -> bool:
        """Naming-convention heldness: the descriptor's chain tail is a
        data-lock name (the R1-era lexical signal, kept so a lockish
        item that fails to RESOLVE still counts as held for R9 — R11
        separately flags it as unresolvable)."""
        d = desc
        while d.get("t") == "sub":
            d = d["base"]
        if d.get("t") == "attr":
            return is_data_lock_name(d["attr"])
        if d.get("t") == "name":
            return is_data_lock_name(d["id"])
        return d.get("t") == "lock"

    def _holds_lock(self, res: TreeResolver, call: Dict,
                     fid: str) -> bool:
        """Whether a call site holds an actual LOCK. Every with-item is
        on the recorder's held stack (R11 needs that), but an open()/
        ExitStack context manager must not count as a lock for R9 —
        heldness requires a lock creation site, a lock-wrapping class
        (SharedFlock), or at least the lock naming convention."""
        for h in call["held"]:
            if (self._desc_lockish(h)
                    or res.resolve_lock_sites(h, fid)
                    or self._wrapper_methods(res, h, fid)):
                return True
        return False

    def _r9(self, res: TreeResolver) -> Iterator[Finding]:
        # Call edges + per-function entries.
        entries: Dict[str, List[Tuple[str, bool]]] = {f: []
                                                      for f in res.funcs}
        exposed: Set[str] = set()
        locked_calls: List[Tuple[str, Dict, List[str]]] = []
        for fid, rec in res.funcs.items():
            for call in rec["calls"]:
                cands, _ = res.resolve_call(call, fid)
                held = self._holds_lock(res, call, fid)
                for c in cands:
                    if c in entries:
                        entries[c].append((fid, held))
                locked_cands = [c for c in cands
                                if res.funcs[c]["locked_name"]]
                chain = res._desc_chain(call["expr"]) or []
                if not locked_cands and chain \
                        and chain[-1].endswith("_locked"):
                    # Literal *_locked call that did not resolve (R1's
                    # territory) — still participates in propagation.
                    locked_cands = ["<unresolved>"]
                if locked_cands:
                    locked_calls.append((fid, call, locked_cands))
            seen_refs: Set[Tuple[int, str]] = set()
            for ref in rec["refs"]:
                t = res.resolve_type(ref["expr"], fid)
                target = t.get("func") if t else None
                if target is not None:
                    exposed.add(target)
                is_locked_target = (
                    res.funcs.get(target, {}).get("locked_name")
                    if target is not None else ref.get("locked_name"))
                if is_locked_target:
                    chain = res._desc_chain(ref["expr"]) or ["<ref>"]
                    key = (ref["line"], chain[-1])
                    if key in seen_refs:
                        continue
                    seen_refs.add(key)
                    yield Finding(
                        rule="R9", path=res.func_mod[fid],
                        line=ref["line"], col=0,
                        message=f"reference to *_locked function "
                                f"{chain[-1]} escapes its lock context "
                                "(a stored/passed bound reference runs "
                                "later, without the lock — call it "
                                "inside the 'with', or pass a "
                                "non-locked wrapper)")
        for fid in res.funcs:
            if not entries[fid]:
                exposed.add(fid)
        # protected(f) greatest fixpoint: f is protected when it
        # declares the lock (*_locked), or every static entry holds a
        # lock or comes from a protected caller — and f is not exposed.
        protected = {fid: True for fid in res.funcs}
        changed = True
        while changed:
            changed = False
            for fid, rec in res.funcs.items():
                if not protected[fid] or rec["locked_name"]:
                    continue
                ok = fid not in exposed and all(
                    held or protected.get(g, False)
                    for g, held in entries[fid])
                if not ok:
                    protected[fid] = False
                    changed = True
        for fid, call, cands in locked_calls:
            rec = res.funcs[fid]
            if rec["locked_name"] or protected[fid] \
                    or self._holds_lock(res, call, fid):
                continue
            chain = res._desc_chain(call["expr"]) or ["<call>"]
            callee = next((c for c in cands if c != "<unresolved>"), None)
            via = (f" (resolves to {callee})"
                   if callee and not chain[-1].endswith("_locked") else "")
            root = self._unprotected_root(fid, entries, protected,
                                          exposed, res)
            yield Finding(
                rule="R9", path=res.func_mod[fid], line=call["line"],
                col=0,
                message=f"{'.'.join(chain)}(){via} needs its caller's "
                        "lock, but the surrounding function "
                        f"{rec['qual']}() is reachable without one "
                        f"({root}) — acquire the lock, rename the "
                        "chain *_locked, or break the path")

    @staticmethod
    def _wrapper_methods(res: TreeResolver, desc: Dict,
                         fid: str) -> List[str]:
        """acquire/__enter__ methods of the class a non-lock
        acquisition expression resolves to (lock wrappers: SharedFlock,
        Flock) — chased through TACQ so their inner creation sites
        count as held."""
        t = res.resolve_type(desc, fid)
        cid = t.get("cls") if t else None
        info = res.classes.get(cid) if cid else None
        if info is None:
            return []
        out: List[str] = []
        for m in ("acquire", "__enter__"):
            for mf in res.class_method_cha(info, m):
                if mf not in out:
                    out.append(mf)
        return out

    @staticmethod
    def _unprotected_root(fid: str, entries, protected, exposed,
                          res: TreeResolver, limit: int = 6) -> str:
        chain = [fid]
        cur = fid
        for _ in range(limit):
            nxt = next((g for g, held in entries.get(cur, ())
                        if not held and not protected.get(g, True)), None)
            if nxt is None or nxt in chain:
                break
            chain.append(nxt)
            cur = nxt
        chain.reverse()
        names = [f"{res.funcs[f]['qual']}()" for f in chain]
        tag = ("exposed entry point" if cur in exposed
               else "unlocked call path")
        return f"{tag}: " + " -> ".join(names)

    # -- R10 ----------------------------------------------------------------

    def _r10(self, res: TreeResolver) -> Iterator[Finding]:
        # (cid, attr) -> {"guards": {lockattr: n}, "unguarded": [...],
        #                 "declared": n}
        stats: Dict[Tuple[str, str], Dict] = {}
        for fid, rec in res.funcs.items():
            if rec["name"] == "__init__":
                continue
            info = res.class_of(fid)
            for acc in rec["accesses"]:
                base = acc["base"]
                if base == "self":
                    cinfo = info
                else:
                    t = res.resolve_type({"t": "name", "id": base}, fid)
                    cinfo = (res.classes.get(t["cls"])
                             if t and "cls" in t else None)
                if cinfo is None:
                    continue
                lock_attrs = res.class_lock_attrs(cinfo)
                attr = acc["attr"]
                if attr in lock_attrs:
                    continue  # the lock itself is not guarded data
                if res.class_method(cinfo, attr) is not None:
                    continue  # bound-method access, not data
                key = (cinfo.cid, attr)
                st = stats.setdefault(
                    key, {"guards": {}, "unguarded": [], "declared": 0})
                guards_here = [lattr for b, lattr in acc["held"]
                               if b == base and lattr in lock_attrs]
                if guards_here:
                    for g in guards_here:
                        st["guards"][g] = st["guards"].get(g, 0) + 1
                elif rec["locked_name"] and base == "self":
                    st["declared"] += 1
                else:
                    st["unguarded"].append(
                        (res.func_mod[fid], acc["line"], acc["kind"],
                         rec["qual"]))
        self.guard_table = []
        for (cid, attr), st in sorted(stats.items()):
            cinfo = res.classes[cid]
            ann = res.class_guard_ann(cinfo, attr)
            lock_attrs = res.class_lock_attrs(cinfo)
            if not lock_attrs and ann is None:
                continue  # lock-free class: nothing to guard with
            total = (sum(st["guards"].values()) + st["declared"]
                     + len(st["unguarded"]))
            guard: Optional[str] = None
            how = ""
            if ann == "none":
                how = "annotated unguarded"
            elif ann:
                guard = ann.split(".")[-1]
                how = "annotated"
                if guard not in lock_attrs:
                    yield Finding(
                        rule="R10", path=cinfo.relpath,
                        line=cinfo.attr_lines.get(attr, 1), col=0,
                        message=f"GUARDED_BY: {ann} on "
                                f"{cinfo.name}.{attr} names no known "
                                f"lock attribute of {cinfo.name} "
                                f"(known: {sorted(lock_attrs) or '-'})")
                    continue
            elif st["guards"]:
                best = max(st["guards"], key=lambda g: st["guards"][g])
                votes = st["guards"][best] + st["declared"] * (
                    1 if len(lock_attrs) == 1 else 0)
                if votes >= MIN_GUARDED and votes / max(total, 1) \
                        >= GUARD_RATIO:
                    guard, how = best, "inferred"
            self.guard_table.append({
                "class": f"{cinfo.relpath}::{cinfo.name}", "attr": attr,
                "guard": guard, "how": how or "-",
                "guarded": sum(st["guards"].values()) + st["declared"],
                "unguarded": len(st["unguarded"]),
            })
            if guard is None:
                continue
            for path, line, kind, qual in st["unguarded"]:
                word = "write to" if kind == "w" else "read of"
                yield Finding(
                    rule="R10", path=path, line=line, col=0,
                    message=f"{word} {cinfo.name}.{attr} outside its "
                            f"guard self.{guard} ({how}; "
                            f"{self.guard_table[-1]['guarded']} guarded "
                            f"vs {self.guard_table[-1]['unguarded']} "
                            f"unguarded accesses) in {qual}() — acquire "
                            "the lock, or annotate '# GUARDED_BY: none' "
                            "if torn reads are tolerated")

    # -- R11 ----------------------------------------------------------------

    def _r11(self, res: TreeResolver) -> Iterator[Finding]:
        # TACQ: sites each function may acquire, directly or through
        # any call — worklist fixpoint over the call graph.
        direct: Dict[str, Set[str]] = {}
        callees: Dict[str, Set[str]] = {}
        for fid, rec in res.funcs.items():
            d: Set[str] = set()
            cs: Set[str] = set()
            for acq in rec["acquires"]:
                sites = res.resolve_lock_sites(acq["lock"], fid)
                if sites:
                    d.update(sites)
                    continue
                # A lock-WRAPPING object (SharedFlock, Flock): the
                # acquisition delegates to the class's acquire/enter
                # methods — chase them through TACQ like any call.
                wrappers = self._wrapper_methods(res, acq["lock"], fid)
                if wrappers:
                    cs.update(wrappers)
                elif acq["lockish"]:
                    yield Finding(
                        rule="R11", path=res.func_mod[fid],
                        line=acq["line"], col=0,
                        message="acquisition of a data-lock-named "
                                "expression that resolves to no "
                                "creation site — the static lock-order "
                                "graph cannot model it (name the lock "
                                "via an attribute the analyzer can "
                                "trace, or rename it off the *_lock "
                                "convention if it is not a threading "
                                "lock)")
            direct[fid] = d
            for call in rec["calls"]:
                for c in res.resolve_call(call, fid)[0]:
                    cs.add(c)
            callees[fid] = cs
        tacq: Dict[str, Set[str]] = {f: set(direct[f]) for f in res.funcs}
        changed = True
        while changed:
            changed = False
            for fid in res.funcs:
                before = len(tacq[fid])
                for c in callees[fid]:
                    tacq[fid] |= tacq.get(c, set())
                if len(tacq[fid]) != before:
                    changed = True

        def sites_of(desc: Dict, fid: str) -> List[str]:
            """Creation sites a held/acquired expression stands for —
            directly, or through a lock-wrapping class's acquire path."""
            s = res.resolve_lock_sites(desc, fid)
            if s:
                return s
            out: Set[str] = set()
            for m in self._wrapper_methods(res, desc, fid):
                out |= tacq.get(m, set())
            return sorted(out)
        # Edges: nested with-acquisitions + lock-acquiring calls under
        # a held lock. Same-site nesting is the witness's self-nest
        # carve-out (sorted same-class acquisition), not an edge.
        edges: Dict[Tuple[str, str], List[str]] = {}

        def add_edge(src: str, dst: str, where: str) -> None:
            if src != dst:
                edges.setdefault((src, dst), []).append(where)

        for fid, rec in res.funcs.items():
            rel = res.func_mod[fid]
            for acq in rec["acquires"]:
                dsts = sites_of(acq["lock"], fid)
                held_sites = [s for h in acq["held"]
                              for s in sites_of(h, fid)]
                for a in held_sites:
                    for b in dsts:
                        add_edge(a, b, f"{rel}:{acq['line']}")
            for call in rec["calls"]:
                if not call["held"]:
                    continue
                held_sites = [s for h in call["held"]
                              for s in sites_of(h, fid)]
                if not held_sites:
                    continue
                for c in res.resolve_call(call, fid)[0]:
                    for b in tacq.get(c, ()):
                        for a in held_sites:
                            add_edge(a, b, f"{rel}:{call['line']}")
        self.static_edges = edges
        cycle = _find_cycle(set(edges))
        if cycle:
            path = " -> ".join(cycle + [cycle[0]])
            src = cycle[0]
            dst = cycle[1] if len(cycle) > 1 else cycle[0]
            where = edges.get((src, dst), ["?:1"])[0]
            rel, _, line = where.rpartition(":")
            yield Finding(
                rule="R11", path=rel or where, line=int(line or 1), col=0,
                message=f"static lock-order cycle (potential deadlock): "
                        f"{path} — break the inversion or restructure "
                        "the acquisition order")


def _find_cycle(edge_set: Set[Tuple[str, str]]) -> Optional[List[str]]:
    adj: Dict[str, List[str]] = {}
    for s, d in edge_set:
        adj.setdefault(s, []).append(d)
    WHITE, GRAY, BLACK = 0, 1, 2
    color: Dict[str, int] = {}
    stack: List[str] = []

    def dfs(n: str) -> Optional[List[str]]:
        color[n] = GRAY
        stack.append(n)
        for m in adj.get(n, ()):
            c = color.get(m, WHITE)
            if c == GRAY:
                return stack[stack.index(m):]
            if c == WHITE:
                out = dfs(m)
                if out is not None:
                    return out
        stack.pop()
        color[n] = BLACK
        return None

    for n in list(adj):
        if color.get(n, WHITE) == WHITE:
            out = dfs(n)
            if out is not None:
                return out
    return None


# ---------------------------------------------------------------------------
# Witness cross-validation (the lint.sh / race.sh observed⊆static gate)
# ---------------------------------------------------------------------------

def check_witness(rule: RaceAnalysis,
                  observed: Sequence[Tuple[str, str]]) -> List[str]:
    """Every runtime-observed lock-order edge must be explained by the
    static graph (observed ⊆ static, site-keyed). An unexplained edge
    means the call graph under-approximates — the gate FAILS so the
    model is fixed rather than quietly trusted. Returns violation
    lines (empty = validated)."""
    static = set(rule.static_edges)
    nodes = {n for e in static for n in e}
    # Sites the analyzer discovered at all (a lock class can exist with
    # no outgoing/incoming static edges yet).
    if rule.resolver is not None:
        for rel, facts in rule.resolver.modules.items():
            for rec in facts["functions"].values():
                for sa in rec.get("self_assigns", ()):
                    for ln in TreeResolver._desc_lock_lines(sa["value"]):
                        nodes.add(f"{rel}:{ln}")
                # Function-local creations too (a drmc scenario's
                # truth_lock): misdiagnosing their edges as "unknown
                # site" would send the maintainer hunting outside the
                # tree instead of at the call graph.
                for descs in rec.get("locals", {}).values():
                    for d in descs:
                        for ln in TreeResolver._desc_lock_lines(d):
                            nodes.add(f"{rel}:{ln}")
            for lines in facts.get("global_locks", {}).values():
                nodes.update(f"{rel}:{ln}" for ln in lines)
            for cinfo in facts.get("classes", {}).values():
                for lines in cinfo.get("class_locks", {}).values():
                    nodes.update(f"{rel}:{ln}" for ln in lines)
    out: List[str] = []
    for src, dst in observed:
        if (src, dst) in static:
            continue
        missing = [n for n in (src, dst) if n not in nodes]
        if missing:
            out.append(
                f"runtime edge {src} -> {dst}: site(s) "
                f"{', '.join(missing)} unknown to the static analyzer "
                "(lock created outside the scanned tree, or the "
                "creation expression is not traced)")
        else:
            out.append(
                f"runtime edge {src} -> {dst} is not in the static "
                "lock-order graph — the call graph under-approximates "
                "this acquisition path")
    return out


def locks_report(rule: RaceAnalysis) -> List[Dict]:
    """The --locks-report table (mirrors --sites-report): one row per
    (class, attribute) the guarded-by pass considered."""
    return list(rule.guard_table)
