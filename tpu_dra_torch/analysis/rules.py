"""dralint rules: the project invariants, machine-checked.

The rule set encodes the ownership and concurrency discipline PRs 1-4
rely on (SURVEY §§8-12). Naming conventions the rules key on:

- **data locks** are attributes/names matching ``*_lock`` / ``*_locks``
  (or exactly ``lock``), plus condition variables ``*_cond``. They are
  hold-time-bounded: no blocking work inside their ``with`` bodies.
- **operation gates** — ``Flock`` file locks (``_flock``), the flock's
  in-process serializer (``_tlock``), spawn slots — are long-held BY
  DESIGN and deliberately do not match the data-lock pattern; the
  runtime lock witness (infra/lockwitness.py) still watches them.
- ``*_locked``-suffixed functions assert "my caller holds the lock".

All rules are lexical: they see one function at a time and do not chase
data flow across call boundaries. That is the point — the conventions
are designed so that the invariant is CHECKABLE at the call site, and
the rules fail loudly where the convention is skipped, not silently
where an alias laundered a view through a helper.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Set, Tuple

from tpu_dra_torch.analysis.core import (
    Finding, Module, ProjectContext, Rule, register,
)

# ---------------------------------------------------------------------------
# Shared AST helpers
# ---------------------------------------------------------------------------


def attr_chain(node: ast.AST) -> List[str]:
    """Dotted-name components of an Attribute/Name chain, looking through
    subscripts and calls: ``self._informers["x"].lister.list`` ->
    ``["self", "_informers", "lister", "list"]``."""
    out: List[str] = []
    while True:
        if isinstance(node, ast.Attribute):
            out.append(node.attr)
            node = node.value
        elif isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node, ast.Call):
            node = node.func
        elif isinstance(node, ast.Name):
            out.append(node.id)
            break
        else:
            break
    return list(reversed(out))


def _norm(name: str) -> str:
    return name.lstrip("_").lower()


def is_data_lock_name(name: str) -> bool:
    n = _norm(name)
    return (n in ("lock", "locks", "cond")
            or n.endswith(("_lock", "_locks", "_cond")))


def is_cond_name(name: str) -> bool:
    n = _norm(name)
    return n == "cond" or n.endswith("_cond")


def lockish_context(item: ast.withitem) -> Optional[str]:
    """The lock's display name when a with-item acquires a data lock."""
    chain = attr_chain(item.context_expr)
    if chain and is_data_lock_name(chain[-1]):
        return ".".join(chain)
    return None


def base_name(node: ast.AST) -> Optional[str]:
    """The root Name of an Attribute/Subscript chain (``pod`` for
    ``pod["spec"]["nodeName"]``), or None."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def module_imports(tree: ast.AST) -> Dict[str, str]:
    """name -> dotted target for module-level imports (shared by the
    draracer extraction and the laundering predicate below)."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                out[alias.asname or alias.name.split(".")[0]] = alias.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            for alias in node.names:
                out[alias.asname or alias.name] = \
                    f"{node.module}.{alias.name}"
    return out


def is_laundering_chain(chain: List[str],
                        imports: Optional[Dict[str, str]] = None) -> bool:
    """THE sanctioned view-laundering predicate (SURVEY §10/§20),
    shared by R3 and drflow R13: ``copy.deepcopy`` and the JSON-shaped
    fast path ``json_deepcopy`` (k8s.client) turn a zero-copy informer
    view into a private object. Both spellings are recognized directly
    and through module import aliases (``from copy import deepcopy as
    dc``; ``import copy as c; c.deepcopy``) when the module's import
    map is supplied."""
    if not chain:
        return False
    dotted = ".".join(chain)
    if imports and chain[0] in imports:
        dotted = ".".join([imports[chain[0]], *chain[1:]])
    parts = dotted.split(".")
    return (parts[-1] == "json_deepcopy"
            or parts[-2:] == ["copy", "deepcopy"]
            or parts == ["deepcopy"])


# ---------------------------------------------------------------------------
# R1/R2 shared visitor: lexical lock context
# ---------------------------------------------------------------------------

class _LockContextVisitor(ast.NodeVisitor):
    """Tracks, per lexical position, which data locks the surrounding
    code provably holds: enclosing ``with *_lock`` bodies plus an
    enclosing ``*_locked`` function. A nested non-``_locked`` function
    body runs LATER, not under the lock, so entering one clears the
    stack (callbacks defined under a lock are not 'under the lock')."""

    def __init__(self, module: Module, ctx: ProjectContext):
        self.module = module
        self.ctx = ctx
        self.lock_stack: List[str] = []
        self.func_stack: List[str] = []
        # Lexically inside an ``async def`` body: blocking work here
        # stalls the event loop, not just a lock's waiters (the R2
        # coroutine check, SURVEY §21). A nested sync def resets it the
        # same way it resets the lock stack — its body runs when
        # called, which for the narrow lexical check is "elsewhere"
        # (typically on an executor or as a callback).
        self.coro_depth = 0
        self.findings: List[Finding] = []

    # -- scope handling -----------------------------------------------------

    def _visit_function(self, node) -> None:
        saved = self.lock_stack
        saved_coro = self.coro_depth
        self.lock_stack = ([f"{node.name}()"]
                           if node.name.endswith("_locked") else [])
        self.coro_depth = (self.coro_depth + 1
                           if isinstance(node, ast.AsyncFunctionDef) else 0)
        self.func_stack.append(node.name)
        self.generic_visit(node)
        self.func_stack.pop()
        self.lock_stack = saved
        self.coro_depth = saved_coro

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function

    def visit_Lambda(self, node: ast.Lambda) -> None:
        saved = self.lock_stack
        saved_coro = self.coro_depth
        self.lock_stack = []
        self.coro_depth = 0
        self.generic_visit(node)
        self.lock_stack = saved
        self.coro_depth = saved_coro

    def in_coroutine(self) -> bool:
        return self.coro_depth > 0

    def visit_With(self, node: ast.With) -> None:
        held = [lockish_context(item) for item in node.items]
        held = [h for h in held if h]
        for item in node.items:
            self.visit(item)
        self.lock_stack.extend(held)
        for stmt in node.body:
            self.visit(stmt)
        if held:
            del self.lock_stack[-len(held):]

    def holds_lock(self) -> bool:
        return bool(self.lock_stack)

    def emit(self, rule: str, node: ast.AST, message: str) -> None:
        self.findings.append(Finding(
            rule=rule, path=self.module.relpath, line=node.lineno,
            col=node.col_offset, message=message))


@register
class LockedCallDiscipline(Rule):
    """R1: ``*_locked`` functions may only be called with the lock
    provably held — from a ``with *_lock`` body or from another
    ``*_locked`` function."""

    rule_id = "R1"
    title = "locked-call discipline"

    class _V(_LockContextVisitor):
        def visit_Call(self, node: ast.Call) -> None:
            chain = attr_chain(node.func)
            if chain and chain[-1].endswith("_locked"):
                if not self.holds_lock():
                    self.emit("R1", node,
                              f"{chain[-1]}() called without holding a "
                              "lock (call it from a 'with *_lock' body "
                              "or from another *_locked method)")
            self.generic_visit(node)

    def scan(self, module: Module, ctx: ProjectContext) -> Iterator[Finding]:
        v = self._V(module, ctx)
        v.visit(module.tree)
        return iter(v.findings)


# -- R2: blocking work under a data lock ------------------------------------

_CLIENT_VERBS = {"get", "list", "create", "update", "delete", "patch",
                 "watch", "update_status", "list_with_rv", "request"}
_MUTEX_WAITERS = {"wait", "communicate"}


def blocking_reason(node: ast.Call) -> Optional[str]:
    """Why this call blocks, or None. Deliberately conservative: plain
    file I/O is allowed (checkpoint stores under the state lock are the
    crash-consistency design), condition-variable waits release the
    lock they guard, and thread-safe in-memory work is fine."""
    chain = attr_chain(node.func)
    if not chain:
        return None
    last = chain[-1]
    recv = chain[:-1]
    if chain[-2:] == ["time", "sleep"] or chain == ["sleep"]:
        return "time.sleep"
    if chain[0] == "subprocess":
        return f"subprocess.{last} (fork/exec)"
    if last == "Popen":
        return "Popen (fork/exec)"
    if chain[0] == "socket" and last in ("socket", "create_connection"):
        return f"socket.{last}"
    if chain[0] == "fcntl" and last in ("flock", "lockf"):
        return f"fcntl.{last} (file-lock syscall)"
    if chain[-2:] == ["vfs", "flock"]:
        return "vfs.flock (file-lock syscall behind the durable-op seam)"
    if chain[0] == "os" and last in ("system", "popen", "waitpid"):
        return f"os.{last}"
    if last in _MUTEX_WAITERS and recv:
        if is_cond_name(recv[-1]):
            return None  # Condition.wait releases the lock it guards
        return f".{last}() (blocks the holder)"
    if last == "join" and recv and not node.args:
        # str.join always takes a positional iterable; a thread/process
        # join takes none (timeout is keyword-only in this codebase).
        return ".join() (blocks on another thread)"
    if last in _CLIENT_VERBS and any("client" in _norm(c) for c in recv):
        return f"API-client .{last}() (network round-trip w/ retries)"
    return None


def coroutine_blocking_reason(node: ast.Call) -> Optional[str]:
    """Why this call would stall the event loop from a coroutine, or
    None (the R2 coroutine check, SURVEY §21). Everything that blocks
    under a lock blocks the loop too, plus the loop-specific set the
    front-end swap made load-bearing: fdatasync/fsync (the journal's
    group commit), flock (already in the shared set), Future.result()
    and Event/lock acquire waits — all of which belong on an executor
    (``run_in_executor``), never in an ``async def`` body."""
    reason = blocking_reason(node)
    if reason:
        return reason
    chain = attr_chain(node.func)
    if not chain:
        return None
    last = chain[-1]
    recv = chain[:-1]
    if chain[0] in ("os", "vfs") and last in ("fdatasync", "fsync"):
        return f"{chain[0]}.{last} (durable-sync syscall)"
    if last == "result" and recv:
        return ".result() (blocks the loop on a Future)"
    if last == "acquire" and recv and is_data_lock_name(recv[-1]):
        return ".acquire() on a data lock (blocks the loop)"
    if last in _MUTEX_WAITERS and recv and is_cond_name(recv[-1]):
        # Condition.wait releases ITS lock but still parks the thread —
        # on the loop thread that parks the whole reactor.
        return ".wait() (parks the loop thread)"
    return None


@register
class NoBlockingUnderLock(Rule):
    """R2: no blocking operations inside a ``with *_lock`` body or a
    ``*_locked`` function — sleeps, subprocess spawns, socket/API-client
    verbs and flock syscalls stall every other thread queued on the
    lock (and the watchdog/readiness paths behind them).

    Coroutine family member (SURVEY §21): the same discipline lexically
    inside ``async def`` bodies, where the victim is the event loop —
    flock, fdatasync, ``Future.result()``, lock acquires and the shared
    blocking set must be offloaded to an executor, never awaited-around
    on the loop thread."""

    rule_id = "R2"
    title = "no blocking work under a data lock"

    class _V(_LockContextVisitor):
        def visit_Call(self, node: ast.Call) -> None:
            if self.holds_lock():
                reason = blocking_reason(node)
                if reason:
                    self.emit("R2", node,
                              f"blocking call {reason} while holding "
                              f"{self.lock_stack[-1]}")
            if self.in_coroutine():
                reason = coroutine_blocking_reason(node)
                if reason:
                    self.emit("R2", node,
                              f"blocking call {reason} inside a "
                              "coroutine — it stalls the event loop; "
                              "offload it to an executor "
                              "(run_in_executor)")
            self.generic_visit(node)

    def scan(self, module: Module, ctx: ProjectContext) -> Iterator[Finding]:
        v = self._V(module, ctx)
        v.visit(module.tree)
        return iter(v.findings)


# ---------------------------------------------------------------------------
# R3: zero-copy informer reads are read-only
# ---------------------------------------------------------------------------

_VIEW_TAILS = (("lister", "list"), ("lister", "get"))
_MUTATORS = {"update", "append", "extend", "insert", "setdefault", "pop",
             "popitem", "clear", "remove", "sort", "add", "discard"}
_READERS = {"get", "keys", "values", "items", "copy", "index", "count"}
_PROPAGATORS = {"sorted", "list", "reversed", "iter", "next", "tuple",
                "filter", "enumerate"}


def _is_view_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    chain = attr_chain(node.func)
    return (tuple(chain[-2:]) in _VIEW_TAILS
            or (chain and chain[-1] == "get_by_index"))


class _TaintWalker:
    """Statement-order taint tracking within one function: names bound
    to informer-cache views (lister reads, index lookups, watch-event
    payloads in ``copy_events=False`` modules) must not be mutated.
    ``copy.deepcopy`` — or the JSON-shaped fast path
    ``k8s.client.json_deepcopy`` — launders a view into a private
    object."""

    def __init__(self, module: Module, zero_copy_events: bool,
                 imports: Optional[Dict[str, str]] = None):
        self.module = module
        self.zero_copy_events = zero_copy_events
        self.imports = imports
        self.findings: List[Finding] = []

    # -- expression classification -----------------------------------------

    def _tainted_expr(self, node: ast.AST, tainted: Set[str]) -> bool:
        if _is_view_call(node):
            return True
        if isinstance(node, ast.Name):
            return node.id in tainted
        if isinstance(node, (ast.Attribute, ast.Subscript)):
            base = base_name(node)
            return base in tainted if base else False
        if isinstance(node, ast.Call):
            chain = attr_chain(node.func)
            if is_laundering_chain(chain, self.imports):
                return False  # the sanctioned escape hatches
            if chain and chain[-1] in _PROPAGATORS and len(chain) == 1:
                return any(self._tainted_expr(a, tainted)
                           for a in node.args)
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _READERS):
                return self._tainted_expr(node.func.value, tainted)
            return False
        if isinstance(node, ast.BoolOp):
            return any(self._tainted_expr(v, tainted) for v in node.values)
        if isinstance(node, ast.IfExp):
            return (self._tainted_expr(node.body, tainted)
                    or self._tainted_expr(node.orelse, tainted))
        return False

    # -- statement walk ------------------------------------------------------

    def run(self, fn) -> None:
        tainted: Set[str] = set()
        if self.zero_copy_events and fn.name.startswith("_on_"):
            args = fn.args
            for a in (args.posonlyargs + args.args + args.kwonlyargs):
                if a.arg not in ("self", "cls"):
                    tainted.add(a.arg)
        self._walk(fn.body, tainted)

    def _taint_target(self, target: ast.AST, is_view: bool,
                      tainted: Set[str]) -> None:
        if isinstance(target, ast.Name):
            (tainted.add if is_view else tainted.discard)(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._taint_target(elt, is_view, tainted)

    def _check_write_target(self, target: ast.AST, tainted: Set[str],
                            what: str) -> None:
        if isinstance(target, (ast.Attribute, ast.Subscript)):
            base = base_name(target)
            if base and base in tainted:
                self.findings.append(Finding(
                    rule="R3", path=self.module.relpath,
                    line=target.lineno, col=target.col_offset,
                    message=f"{what} on '{base}', a zero-copy informer "
                            "view (copy.deepcopy it before writing — "
                            "SURVEY §10 ownership rule)"))

    def _check_mutator_calls(self, node: ast.AST, tainted: Set[str]) -> None:
        for call in ast.walk(node):
            if (isinstance(call, ast.Call)
                    and isinstance(call.func, ast.Attribute)
                    and call.func.attr in _MUTATORS):
                base = base_name(call.func.value)
                if base and base in tainted:
                    self.findings.append(Finding(
                        rule="R3", path=self.module.relpath,
                        line=call.lineno, col=call.col_offset,
                        message=f".{call.func.attr}() on '{base}', a "
                                "zero-copy informer view (copy.deepcopy "
                                "it before mutating)"))

    def _walk(self, stmts, tainted: Set[str]) -> None:
        for stmt in stmts:
            if isinstance(stmt, ast.Assign):
                is_view = self._tainted_expr(stmt.value, tainted)
                for t in stmt.targets:
                    self._check_write_target(t, tainted, "assignment")
                self._check_mutator_calls(stmt.value, tainted)
                for t in stmt.targets:
                    self._taint_target(t, is_view, tainted)
            elif isinstance(stmt, ast.AugAssign):
                self._check_write_target(stmt.target, tainted,
                                         "augmented assignment")
                self._check_mutator_calls(stmt.value, tainted)
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                self._check_write_target(stmt.target, tainted, "assignment")
                self._taint_target(stmt.target,
                                   self._tainted_expr(stmt.value, tainted),
                                   tainted)
            elif isinstance(stmt, ast.Delete):
                for t in stmt.targets:
                    self._check_write_target(t, tainted, "del")
            elif isinstance(stmt, ast.For):
                self._check_mutator_calls(stmt.iter, tainted)
                self._taint_target(stmt.target,
                                   self._tainted_expr(stmt.iter, tainted),
                                   tainted)
                self._walk(stmt.body, tainted)
                self._walk(stmt.orelse, tainted)
            elif isinstance(stmt, ast.While):
                self._check_mutator_calls(stmt.test, tainted)
                self._walk(stmt.body, tainted)
                self._walk(stmt.orelse, tainted)
            elif isinstance(stmt, ast.If):
                self._check_mutator_calls(stmt.test, tainted)
                self._walk(stmt.body, tainted)
                self._walk(stmt.orelse, tainted)
            elif isinstance(stmt, ast.With):
                for item in stmt.items:
                    self._check_mutator_calls(item.context_expr, tainted)
                    if item.optional_vars is not None:
                        self._taint_target(
                            item.optional_vars,
                            self._tainted_expr(item.context_expr, tainted),
                            tainted)
                self._walk(stmt.body, tainted)
            elif isinstance(stmt, ast.Try):
                self._walk(stmt.body, tainted)
                for h in stmt.handlers:
                    self._walk(h.body, tainted)
                self._walk(stmt.orelse, tainted)
                self._walk(stmt.finalbody, tainted)
            elif isinstance(stmt, (ast.Expr, ast.Return)):
                if stmt.value is not None:
                    self._check_mutator_calls(stmt.value, tainted)
            # nested defs: a fresh scope, fresh taint — handled by the
            # rule driving one _TaintWalker per FunctionDef.


@register
class ZeroCopyViewsReadOnly(Rule):
    """R3: objects read zero-copy from an informer cache (lister.list /
    lister.get / get_by_index results; handler payloads in modules that
    build ``copy_events=False`` informers) are views of live cache
    state — mutating one corrupts every other reader and the watch-
    event diffing built on the cache."""

    rule_id = "R3"
    title = "zero-copy informer reads are read-only"

    @staticmethod
    def _module_has_zero_copy_events(module: Module) -> bool:
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Call):
                for kw in node.keywords:
                    if (kw.arg == "copy_events"
                            and isinstance(kw.value, ast.Constant)
                            and kw.value.value is False):
                        return True
        return False

    def scan(self, module: Module, ctx: ProjectContext) -> Iterator[Finding]:
        zero_copy = self._module_has_zero_copy_events(module)
        imports = module_imports(module.tree)
        findings: List[Finding] = []
        for node in ast.walk(module.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                walker = _TaintWalker(module, zero_copy, imports)
                walker.run(node)
                findings.extend(walker.findings)
        return iter(findings)


# ---------------------------------------------------------------------------
# R4: fault-site registry coverage (both directions)
# ---------------------------------------------------------------------------

@dataclass
class _SiteUse:
    site: str
    path: str
    line: int
    kind: str  # "guard" | "arm"


@register
class FaultSiteRegistry(Rule):
    """R4: every fault-site literal consulted (``FAULTS.check/fires/
    pull``) or armed (``arm/disarm/armed``) must be declared in the
    central ``SITES`` registry (a typo'd site chaos-tests nothing), and
    every registered site must be exercised by at least one chaos walk
    or test AND consulted by at least one production guard — orphans in
    either direction rot the failure model."""

    rule_id = "R4"
    title = "fault-site registry coverage"

    _GUARDS = {"check", "fires", "pull"}
    _ARMS = {"arm", "disarm", "armed"}

    def __init__(self):
        self.uses: List[_SiteUse] = []
        self.local_registered: Dict[str, Set[str]] = {}  # relpath -> sites
        self.exercised: Set[str] = set()
        self.guarded: Set[str] = set()
        self._last_facts: Optional[Dict] = None

    def scan(self, module: Module, ctx: ProjectContext) -> Iterator[Finding]:
        local: Set[str] = set()
        uses: List[_SiteUse] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = attr_chain(node.func)
            if not chain or len(chain) < 2:
                continue
            recv_is_faults = any(_norm(c) == "faults" for c in chain[:-1])
            if not recv_is_faults:
                continue
            kind = None
            if chain[-1] in self._GUARDS:
                kind = "guard"
            elif chain[-1] in self._ARMS:
                kind = "arm"
            elif chain[-1] == "register_site":
                if (node.args and isinstance(node.args[0], ast.Constant)
                        and isinstance(node.args[0].value, str)):
                    local.add(node.args[0].value)
                continue
            if kind is None:
                continue
            if not (node.args and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                continue  # dynamic site expression (chaos rearm loops)
            site = node.args[0].value
            uses.append(_SiteUse(site=site, path=module.relpath,
                                 line=node.lineno, kind=kind))
        # Any registered-site literal appearing in a test or chaos module
        # counts as exercised (CHAOS_SITES tuples, parametrized tests) —
        # recorded as a use too so the --sites-report table shows the
        # same evidence the gate accepts (a dynamically armed site must
        # not read as 'arms 0').
        if module.is_test or module.is_chaos:
            arm_lines = {(u.site, u.line) for u in uses}
            for node in ast.walk(module.tree):
                if (isinstance(node, ast.Constant)
                        and isinstance(node.value, str)
                        and node.value in ctx.fault_sites
                        and (node.value, node.lineno) not in arm_lines):
                    uses.append(_SiteUse(
                        site=node.value, path=module.relpath,
                        line=node.lineno, kind="literal"))
        # The module's contribution, both merged into the aggregate and
        # exported as cacheable facts (absorb_facts replays them for
        # files the runner skipped).
        facts = {"uses": [[u.site, u.line, u.kind] for u in uses],
                 "registered": sorted(local),
                 "is_exercising": bool(module.is_test or module.is_chaos)}
        self._last_facts = facts
        self.absorb_facts(module.relpath, facts, ctx)
        return iter(())

    def module_facts(self) -> Optional[Dict]:
        facts, self._last_facts = self._last_facts, None
        return facts

    def absorb_facts(self, relpath: str, facts: Dict,
                     ctx: ProjectContext) -> None:
        exercising = facts.get("is_exercising", False)
        for site, line, kind in facts.get("uses", ()):
            self.uses.append(_SiteUse(site=site, path=relpath,
                                      line=line, kind=kind))
            if kind == "guard" and not exercising:
                self.guarded.add(site)
            if kind in ("arm", "literal") and exercising:
                self.exercised.add(site)
        self.local_registered[relpath] = set(facts.get("registered", ()))

    def finalize(self, ctx: ProjectContext) -> Iterator[Finding]:
        dynamic: Set[str] = set()
        for sites in self.local_registered.values():
            dynamic |= sites
        known = set(ctx.fault_sites) | dynamic
        for use in self.uses:
            if use.site not in known:
                yield Finding(
                    rule="R4", path=use.path, line=use.line, col=0,
                    message=f"unknown fault site {use.site!r}: not in "
                            "infra/faults.py SITES (a typo here "
                            "chaos-tests nothing)")
        if ctx.fault_sites_path not in ctx.scanned:
            return  # partial run: no orphan evidence
        for site, line in sorted(ctx.fault_sites.items()):
            if site not in self.exercised:
                yield Finding(
                    rule="R4", path=ctx.fault_sites_path, line=line, col=0,
                    message=f"registered fault site {site!r} is never "
                            "armed by any chaos walk or test (orphan: "
                            "its failure mode is unexercised)")
            if site not in self.guarded:
                yield Finding(
                    rule="R4", path=ctx.fault_sites_path, line=line, col=0,
                    message=f"registered fault site {site!r} has no "
                            "production guard (FAULTS.check/fires/pull) "
                            "— arming it does nothing)")


# ---------------------------------------------------------------------------
# R5: metric names centrally cataloged, tpu_dra_-prefixed
# ---------------------------------------------------------------------------

_METRIC_NAME_RE = re.compile(r"^tpu_dra_[a-z0-9_]+$")
_REGISTER_VERBS = {"counter", "gauge", "histogram"}


@register
class MetricCatalog(Rule):
    """R5: every metric registered in production code must carry the
    ``tpu_dra_`` prefix and be declared in ``METRICS_CATALOG``
    (infra/metrics.py) — the one place dashboards, the bench gates and
    SURVEY point at; and every cataloged name must actually be
    registered somewhere (orphan detection both directions)."""

    rule_id = "R5"
    title = "metric catalog coverage"

    def __init__(self):
        self.registered: Set[str] = set()
        self._last_facts: Optional[Dict] = None

    def module_facts(self) -> Optional[Dict]:
        facts, self._last_facts = self._last_facts, None
        return facts

    def absorb_facts(self, relpath: str, facts: Dict,
                     ctx: ProjectContext) -> None:
        self.registered.update(facts.get("registered", ()))

    def scan(self, module: Module, ctx: ProjectContext) -> Iterator[Finding]:
        if module.is_test:
            return iter(())
        mod_registered: Set[str] = set()
        findings: List[Finding] = []
        for node in ast.walk(module.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _REGISTER_VERBS
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                continue
            name = node.args[0].value
            mod_registered.add(name)
            self.registered.add(name)
            if not _METRIC_NAME_RE.match(name):
                findings.append(Finding(
                    rule="R5", path=module.relpath, line=node.lineno, col=0,
                    message=f"metric {name!r} does not match the "
                            "tpu_dra_[a-z0-9_]+ naming contract"))
            elif ctx.metric_catalog and name not in ctx.metric_catalog:
                findings.append(Finding(
                    rule="R5", path=module.relpath, line=node.lineno, col=0,
                    message=f"metric {name!r} is not declared in "
                            "infra/metrics.py METRICS_CATALOG"))
        self._last_facts = {"registered": sorted(mod_registered)}
        return iter(findings)

    def finalize(self, ctx: ProjectContext) -> Iterator[Finding]:
        if not self.registered or ctx.metric_catalog_path not in ctx.scanned:
            return  # partial run (e.g. tests only): no orphan evidence
        for name, line in sorted(ctx.metric_catalog.items()):
            if name not in self.registered:
                yield Finding(
                    rule="R5", path=ctx.metric_catalog_path, line=line,
                    col=0,
                    message=f"cataloged metric {name!r} is never "
                            "registered (orphan catalog entry)")


# ---------------------------------------------------------------------------
# R6: feature-gate names must exist
# ---------------------------------------------------------------------------

@register
class FeatureGateNames(Rule):
    """R6: gate names referenced as strings — ``enabled("...")`` and
    ``set_from_string("A=true,B=false")`` — must exist in
    infra/featuregates.py. The runtime raises on unknown gates, but
    only on the code path that consults them; the linter catches the
    typo before a gate silently never flips."""

    rule_id = "R6"
    title = "feature-gate names exist"

    def scan(self, module: Module, ctx: ProjectContext) -> Iterator[Finding]:
        if not ctx.gate_names:
            return iter(())
        findings: List[Finding] = []
        for node in ast.walk(module.tree):
            if not (isinstance(node, ast.Call) and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                continue
            chain = attr_chain(node.func)
            if not chain:
                continue
            if (chain[-1] == "enabled"
                    and any(c in ("featuregates", "Features")
                            for c in chain[:-1])):
                name = node.args[0].value
                if name not in ctx.gate_names:
                    findings.append(Finding(
                        rule="R6", path=module.relpath, line=node.lineno,
                        col=0,
                        message=f"unknown feature gate {name!r}"))
            elif chain[-1] == "set_from_string":
                for part in node.args[0].value.split(","):
                    name = part.split("=", 1)[0].strip()
                    if name and name not in ctx.gate_names:
                        findings.append(Finding(
                            rule="R6", path=module.relpath,
                            line=node.lineno, col=0,
                            message=f"unknown feature gate {name!r} in "
                                    "gate string"))
        return iter(findings)


# ---------------------------------------------------------------------------
# R7: mutation-under-try needs a paired unwind in the handler
# ---------------------------------------------------------------------------

_STATE_MUTATORS = {"pop", "popitem", "update", "append", "extend",
                   "insert", "clear", "remove", "add", "discard",
                   "setdefault", "sort"}
_UNWIND_NAME_RE = re.compile(r"unwind|rollback|abort|reinsert|restore",
                             re.IGNORECASE)


def _self_state_mutations(fn) -> List[int]:
    """Line numbers of lexical mutations of ``self``-rooted state in
    `fn`: attribute/subscript assignment, ``del``, augmented
    assignment, or a mutator-method call on a ``self.*`` receiver."""
    out: List[int] = []

    def rooted_at_self(node: ast.AST) -> bool:
        chain = attr_chain(node)
        return bool(chain) and chain[0] == "self" and len(chain) > 1

    for node in ast.walk(fn):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        elif isinstance(node, ast.Delete):
            targets = node.targets
        for t in targets:
            if isinstance(t, (ast.Attribute, ast.Subscript)) \
                    and rooted_at_self(t):
                out.append(t.lineno)
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _STATE_MUTATORS
                and rooted_at_self(node.func.value)):
            out.append(node.lineno)
    return out


def _handler_has_unwind(handler: ast.ExceptHandler) -> bool:
    """A handler 'pairs' the mutation when it re-raises, calls an
    unwind/rollback helper, or compensates with its own self-state
    mutation (reinserting what the failed operation removed)."""
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            chain = attr_chain(node.func)
            if chain and _UNWIND_NAME_RE.search(chain[-1]):
                return True
    return bool(_self_state_mutations(handler))


@register
class PrepareUnwindDiscipline(Rule):
    """R7: in the prepare pipelines (functions whose name contains
    ``prepare``), an ``except`` path that swallows an error AFTER the
    function has mutated driver state must carry a paired unwind — a
    ``*unwind*``/``*rollback*`` call, a compensating self-state
    mutation, or a re-raise. A handler that just logs and moves on
    leaves memory ahead of disk: exactly the bug class chaos seed 5
    found on the unprepare path (SURVEY §9), now checked lexically."""

    rule_id = "R7"
    title = "prepare-pipeline except paths unwind"

    def scan(self, module: Module, ctx: ProjectContext) -> Iterator[Finding]:
        if module.is_test or module.is_chaos:
            return iter(())
        findings: List[Finding] = []
        for fn in ast.walk(module.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if "prepare" not in fn.name.lower():
                continue
            mutations = _self_state_mutations(fn)
            if not mutations:
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.Try):
                    continue
                for handler in node.handlers:
                    # Mutations lexically before this handler (earlier
                    # statements or the try body it guards) are at
                    # stake; later ones never ran when it fires.
                    if not any(ln < handler.lineno for ln in mutations):
                        continue
                    if _handler_has_unwind(handler):
                        continue
                    findings.append(Finding(
                        rule="R7", path=module.relpath,
                        line=handler.lineno, col=handler.col_offset,
                        message=f"except path in {fn.name}() swallows "
                                "an error after mutating driver state "
                                "with no paired unwind/rollback "
                                "(compensate, call *_unwind_*, or "
                                "re-raise — SURVEY §9)"))
        return iter(findings)


# ---------------------------------------------------------------------------
# R8: no success externalization before the terminal durable store
# ---------------------------------------------------------------------------

def _is_terminal_store(node: ast.Call) -> bool:
    chain = attr_chain(node.func)
    if not chain:
        return False
    if chain[-1] in ("fdatasync", "fsync"):
        return True
    # journal_commit appends the terminal record and journal_barrier is
    # its durability point (the cross-RPC group fdatasync) — both count,
    # so the rule keeps its teeth on the journaled hot path.
    return (chain[-1] in ("store", "store_batch", "journal_commit",
                          "journal_barrier")
            and any("ckpt" in _norm(c) or "checkpoint" in _norm(c)
                    for c in chain[:-1]))


def _is_checkpoint_mutation(node: ast.AST) -> Optional[int]:
    """Line of a mutation of checkpoint state (component named
    *checkpoint* or ``claims``), else None."""
    def matches(target: ast.AST) -> bool:
        if not isinstance(target, (ast.Attribute, ast.Subscript)):
            return False
        chain = attr_chain(target)
        return any("checkpoint" in _norm(c) or _norm(c) == "claims"
                   for c in chain)

    targets = []
    if isinstance(node, ast.Assign):
        targets = node.targets
    elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        targets = [node.target]
    elif isinstance(node, ast.Delete):
        targets = node.targets
    elif (isinstance(node, ast.Call)
          and isinstance(node.func, ast.Attribute)
          and node.func.attr in _STATE_MUTATORS
          and matches(node.func.value)):
        return node.lineno
    for t in targets:
        if matches(t):
            return t.lineno
    return None


def _success_externalizations(fn) -> List[Tuple[int, str]]:
    """(line, what) of success externalization points: a success
    PrepareResult filled into a result map (no ``error`` kwarg), or a
    success-metric ``.inc()``."""
    out: List[Tuple[int, str]] = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            val = node.value
            if (isinstance(val, ast.Call)
                    and attr_chain(val.func)[-1:] == ["PrepareResult"]
                    and not any(kw.arg == "error" for kw in val.keywords)
                    and any(isinstance(t, ast.Subscript)
                            for t in node.targets)):
                out.append((node.lineno, "success PrepareResult fill"))
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr == "inc"
              and any("success" in _norm(c)
                      for c in attr_chain(node.func.value))):
            out.append((node.lineno, "success-counter inc"))
    return out


@register
class NoSuccessBeforeTerminalStore(Rule):
    """R8: no success externalization — a success RPC-result fill, a
    success-metric increment — lexically between a checkpoint mutation
    and the terminal ``store``/``fdatasync`` that persists it. Anyone
    observing the success (kubelet starting a container, a dashboard)
    would be ahead of disk: a crash in that window un-happens what was
    already announced. The durable-ordering rule drmc checks
    dynamically (crash enumeration), stated lexically."""

    rule_id = "R8"
    title = "no success externalization before the terminal store"

    def scan(self, module: Module, ctx: ProjectContext) -> Iterator[Finding]:
        if module.is_test or module.is_chaos:
            return iter(())
        findings: List[Finding] = []
        for fn in ast.walk(module.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            stores = [n.lineno for n in ast.walk(fn)
                      if isinstance(n, ast.Call) and _is_terminal_store(n)]
            if not stores:
                continue
            mutations = [ln for n in ast.walk(fn)
                         for ln in [_is_checkpoint_mutation(n)]
                         if ln is not None]
            if not mutations:
                continue
            for line, what in _success_externalizations(fn):
                if (any(m < line for m in mutations)
                        and any(s > line for s in stores)):
                    findings.append(Finding(
                        rule="R8", path=module.relpath, line=line, col=0,
                        message=f"{what} in {fn.name}() after a "
                                "checkpoint mutation but before the "
                                "terminal store — success must not be "
                                "externalized until the state backing "
                                "it is durable (SURVEY §13)"))
        return iter(findings)


# ---------------------------------------------------------------------------
# R12: span begin/end discipline (the claim tracer, SURVEY §19)
# ---------------------------------------------------------------------------

_SPAN_CLOSERS = {"end", "abandon"}


def _is_tracer_recv(chain: List[str]) -> bool:
    """Receiver names the tracer by convention (``TRACER``, ``tracer``,
    ``self._tracer`` …) — the same naming-keys-the-rule design as the
    ``*_lock`` family."""
    return any("tracer" in _norm(c) for c in chain[:-1])


def _span_begin_call(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "begin"
            and _is_tracer_recv(attr_chain(node.func)))


def _walk_scope(fn) -> Iterator[ast.AST]:
    """Walk `fn`'s body WITHOUT descending into nested functions /
    lambdas — each nested scope gets its own R12 visit, so a begin
    there is neither double-reported nor credited with an outer close."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _close_target(node: ast.Call) -> Optional[str]:
    """The span variable a close call closes: ``x.end()`` /
    ``x.abandon()`` / ``TRACER.end(x)`` / ``TRACER.abandon(x)``."""
    if not isinstance(node.func, ast.Attribute) \
            or node.func.attr not in _SPAN_CLOSERS:
        return None
    recv = node.func.value
    if isinstance(recv, ast.Name):
        chain = attr_chain(node.func)
        if _is_tracer_recv(chain):
            if node.args and isinstance(node.args[0], ast.Name):
                return node.args[0].id
            return None
        return recv.id
    return None


@register
class SpanBeginEndDiscipline(Rule):
    """R12: every ``tracer.begin(...)`` outside the ``with``-form must
    have an ``end()``/``abandon()`` on all paths — a span that leaks
    open poisons the trace-completeness invariants chaos and drmc gate
    on (zero open spans at quiesce / every terminal state), and its
    trace silently stops attributing.

    Lexical approximation (same altitude as R7): a begun span held in a
    local variable must be (a) discarded — a finding outright, the span
    can never be closed; (b) closed somewhere — no close at all is a
    finding; and (c) closed in a ``finally`` block whenever anything
    between the begin and the close can raise (a call, a raise, an
    early return) — a straight-line begin/close pair needs no finally.
    A span that ESCAPES the function (returned, stored into an
    attribute/subscript, aliased, or passed to a non-close call) is the
    caller's to close — the dynamic zero-open-span gates backstop those
    paths. The ``with TRACER.span(...)`` form closes itself and is
    always clean."""

    rule_id = "R12"
    title = "span begin/end discipline"

    def scan(self, module: Module, ctx: ProjectContext) -> Iterator[Finding]:
        if module.is_test or module.is_chaos:
            return iter(())
        findings: List[Finding] = []
        for fn in ast.walk(module.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            findings.extend(self._scan_function(module, fn))
        return iter(findings)

    def _scan_function(self, module: Module, fn) -> List[Finding]:
        begins: Dict[str, ast.Call] = {}       # var -> begin call node
        discarded: List[ast.Call] = []
        closes: Dict[str, List[ast.Call]] = {}
        escaped: Set[str] = set()
        finally_calls: Set[int] = set()        # id() of calls in finalbody
        for node in _walk_scope(fn):
            if isinstance(node, ast.Try):
                for stmt in node.finalbody:
                    for sub in ast.walk(stmt):
                        if isinstance(sub, ast.Call):
                            finally_calls.add(id(sub))
            elif isinstance(node, ast.Expr) \
                    and _span_begin_call(node.value):
                discarded.append(node.value)
            elif isinstance(node, ast.Assign):
                if _span_begin_call(node.value):
                    if len(node.targets) == 1 \
                            and isinstance(node.targets[0], ast.Name):
                        begins[node.targets[0].id] = node.value
                    # attribute/subscript/tuple target: escapes — the
                    # holder's owner closes it (device_state's b.span).
                elif isinstance(node.value, ast.Name):
                    escaped.add(node.value.id)  # aliased/stored
            elif isinstance(node, (ast.Return, ast.Yield)) \
                    and node.value is not None:
                for sub in ast.walk(node.value):
                    if isinstance(sub, ast.Name):
                        escaped.add(sub.id)
            elif isinstance(node, ast.Call):
                target = _close_target(node)
                if target is not None:
                    closes.setdefault(target, []).append(node)
                else:
                    for arg in list(node.args) \
                            + [kw.value for kw in node.keywords]:
                        if isinstance(arg, ast.Name):
                            escaped.add(arg.id)
        out: List[Finding] = []
        for call in discarded:
            out.append(Finding(
                rule="R12", path=module.relpath, line=call.lineno,
                col=call.col_offset,
                message=f"tracer.begin() result discarded in {fn.name}()"
                        " — the span can never be ended (bind it and "
                        "end()/abandon() it, or use the with-form)"))
        for var, begin in sorted(begins.items()):
            if var in escaped:
                continue  # ownership transferred; dynamic gates cover it
            var_closes = closes.get(var, [])
            if not var_closes:
                out.append(Finding(
                    rule="R12", path=module.relpath, line=begin.lineno,
                    col=begin.col_offset,
                    message=f"span '{var}' begun in {fn.name}() is never"
                            " end()ed/abandon()ed — it leaks open and "
                            "fails the quiesce zero-open-span invariant"))
                continue
            if any(id(c) in finally_calls for c in var_closes):
                continue  # closed on all paths by construction
            last_close = max(c.lineno for c in var_closes)
            # Exclude the begin/close calls AND their sub-expressions
            # (a multi-line begin's attribute dict is not risky work).
            own = {id(n) for n in ast.walk(begin)}
            for c in var_closes:
                own |= {id(n) for n in ast.walk(c)}
            risky = False
            for node in _walk_scope(fn):
                if id(node) in own:
                    continue
                if begin.lineno < getattr(node, "lineno", -1) < last_close:
                    if isinstance(node, (ast.Raise, ast.Return)):
                        risky = True
                        break
                    if isinstance(node, ast.Call):
                        risky = True
                        break
            if risky:
                out.append(Finding(
                    rule="R12", path=module.relpath, line=begin.lineno,
                    col=begin.col_offset,
                    message=f"span '{var}' begun in {fn.name}() is "
                            "closed, but code between begin and close "
                            "can raise/return past it — move the "
                            "end()/abandon() into a finally (or use "
                            "the with-form)"))
        return out


# ---------------------------------------------------------------------------
# Site-coverage report (informational; --sites-report)
# ---------------------------------------------------------------------------

def site_coverage(report_rule: FaultSiteRegistry,
                  ctx: ProjectContext) -> List[Tuple[str, List[str], List[str]]]:
    """(site, guard locations, arm/exercise locations) per registered
    site — the arm column includes literal evidence in test/chaos
    modules (dynamic arms via site tuples), matching what R4 accepts."""
    out = []
    for site in sorted(ctx.fault_sites):
        # Sorted: the collection order differs between fresh scans and
        # cache-replayed facts; the table must not.
        guards = sorted(f"{u.path}:{u.line}" for u in report_rule.uses
                        if u.site == site and u.kind == "guard")
        arms = sorted({f"{u.path}:{u.line}" for u in report_rule.uses
                       if u.site == site and u.kind in ("arm", "literal")})
        out.append((site, guards, arms))
    return out
