"""CEL-subset evaluator for scheduler-side device selection (counterpart
of tpu_dra/simcluster/cel.py).

The upstream kube-scheduler evaluates full CEL over published device
attributes when allocating DRA claims (DeviceClass selectors plus
per-request selectors). The sim implements the subset the port's
DeviceClasses and demos use, so a wrong attribute name, a type mismatch,
or a non-matching value FAILS selection instead of silently matching:

    device.driver == "gpu.dev"
    device.attributes['gpu.dev'].type == 'mig'
    device.attributes['gpu.dev'].index >= 1
    device.attributes['gpu.dev'].productName.lowerAscii().matches('h100')
    a && b, a || b, !a, (a)

Compilation and evaluation are split: an expression is tokenized and
parsed ONCE into an AST (`compile_expr`), cached in a process-wide table
keyed by the full source string, and the AST is then evaluated against
any number of devices, as the real scheduler does with cel-go programs.
Cache hits/misses/compiles are counted on ``tpu_dra_torch.infra.metrics``
(CEL_CACHE_HITS / CEL_CACHE_MISSES / CEL_COMPILES).

Evaluation context is one published resourceapi.Device: the slice's
driver name plus the device's typed attribute map
({"string": v} | {"int": v} | {"bool": v} | {"version": v}).

An unknown attribute, a driver-key mismatch in `device.attributes[...]`,
or a type error raises CelError — callers treat that as "device does not
match", the observable behavior of a CEL runtime error in the real
scheduler. ``&&`` and ``||`` short-circuit as CEL's do, so the right-hand
side is never evaluated (and cannot raise) when the left decides: the
port's DeviceClass selectors put the driver clause first, so a device of
another driver reads as no match without touching its attributes.
Syntax errors (including bad regex literals) surface at compile time and
are negatively cached, so a broken DeviceClass selector costs one parse,
not one per candidate device.
"""

from __future__ import annotations

import re
import threading
from typing import Any, Dict, List, Optional, Tuple

from tpu_dra_torch.infra.metrics import (
    CEL_CACHE_HITS, CEL_CACHE_MISSES, CEL_COMPILES,
)

_TOKEN_RE = re.compile(r"""
    \s*(?:
      (?P<op>&&|\|\||==|!=|>=|<=|>|<|!|\(|\)|\[|\]|\.)
    | (?P<str>'(?:[^'\\]|\\.)*'|"(?:[^"\\]|\\.)*")
    | (?P<int>-?\d+)
    | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
    )""", re.VERBOSE)


class CelError(Exception):
    pass


def _tokenize(expr: str) -> List[Tuple[str, str]]:
    tokens = []
    pos = 0
    while pos < len(expr):
        m = _TOKEN_RE.match(expr, pos)
        if m is None or m.end() == pos:
            rest = expr[pos:].strip()
            if not rest:
                break
            raise CelError(f"cannot tokenize at {rest[:20]!r}")
        pos = m.end()
        for kind in ("op", "str", "int", "ident"):
            val = m.group(kind)
            if val is not None:
                tokens.append((kind, val))
                break
    return tokens


# ---------------------------------------------------------------------------
# AST nodes — compile once, evaluate per device
# ---------------------------------------------------------------------------

def _truthy(v: Any) -> bool:
    if not isinstance(v, bool):
        raise CelError(f"non-bool in boolean context: {v!r}")
    return v


class _Node:
    __slots__ = ()

    def eval(self, driver: str, attributes: Dict[str, Dict]) -> Any:
        raise NotImplementedError


class _Const(_Node):
    __slots__ = ("value",)

    def __init__(self, value: Any):
        self.value = value

    def eval(self, driver, attributes) -> Any:
        return self.value


class _Driver(_Node):
    __slots__ = ()

    def eval(self, driver, attributes) -> Any:
        return driver


class _Attr(_Node):
    """`device.attributes['<domain>'].<name>` — domain/driver match and
    attribute existence are per-device facts, so they stay eval-time."""

    __slots__ = ("domain", "name")

    def __init__(self, domain: str, name: str):
        self.domain = domain
        self.name = name

    def eval(self, driver, attributes) -> Any:
        if self.domain != driver:
            # The real API nests attribute names under the driver's
            # domain; a wrong key must not match anything.
            raise CelError(
                f"attribute domain {self.domain!r} does not match driver "
                f"{driver!r}")
        if self.name not in attributes:
            raise CelError(f"unknown attribute {self.name!r}")
        typed = attributes[self.name]
        for typ in ("string", "int", "bool", "version"):
            if typ in typed:
                val = typed[typ]
                return int(val) if typ == "int" else val
        raise CelError(f"attribute {self.name!r} has no supported type")


class _Not(_Node):
    __slots__ = ("inner",)

    def __init__(self, inner: _Node):
        self.inner = inner

    def eval(self, driver, attributes) -> Any:
        return not _truthy(self.inner.eval(driver, attributes))


class _And(_Node):
    __slots__ = ("lhs", "rhs")

    def __init__(self, lhs: _Node, rhs: _Node):
        self.lhs = lhs
        self.rhs = rhs

    def eval(self, driver, attributes) -> Any:
        # Short-circuit like CEL: the rhs is not evaluated (and cannot
        # raise) when the lhs already decides.
        if not _truthy(self.lhs.eval(driver, attributes)):
            return False
        return _truthy(self.rhs.eval(driver, attributes))


class _Or(_Node):
    __slots__ = ("lhs", "rhs")

    def __init__(self, lhs: _Node, rhs: _Node):
        self.lhs = lhs
        self.rhs = rhs

    def eval(self, driver, attributes) -> Any:
        if _truthy(self.lhs.eval(driver, attributes)):
            return True
        return _truthy(self.rhs.eval(driver, attributes))


class _Cmp(_Node):
    __slots__ = ("op", "lhs", "rhs")

    def __init__(self, op: str, lhs: _Node, rhs: _Node):
        self.op = op
        self.lhs = lhs
        self.rhs = rhs

    def eval(self, driver, attributes) -> Any:
        lhs = self.lhs.eval(driver, attributes)
        rhs = self.rhs.eval(driver, attributes)
        op = self.op
        if type(lhs) is not type(rhs):
            raise CelError(
                f"type mismatch: {type(lhs).__name__} {op} "
                f"{type(rhs).__name__}")
        if op == "==":
            return lhs == rhs
        if op == "!=":
            return lhs != rhs
        if isinstance(lhs, bool):
            raise CelError(f"ordering comparison on bool ({op})")
        if op == ">=":
            return lhs >= rhs
        if op == "<=":
            return lhs <= rhs
        if op == ">":
            return lhs > rhs
        return lhs < rhs


class _LowerAscii(_Node):
    __slots__ = ("inner",)

    def __init__(self, inner: _Node):
        self.inner = inner

    def eval(self, driver, attributes) -> Any:
        value = self.inner.eval(driver, attributes)
        if not isinstance(value, str):
            raise CelError("lowerAscii() on non-string")
        return value.lower()


class _Matches(_Node):
    """CEL matches() is an unanchored RE2 search; the pattern is a
    literal, so it is compiled once with the expression."""

    __slots__ = ("inner", "pattern")

    def __init__(self, inner: _Node, pattern: "re.Pattern"):
        self.inner = inner
        self.pattern = pattern

    def eval(self, driver, attributes) -> Any:
        value = self.inner.eval(driver, attributes)
        if not isinstance(value, str):
            raise CelError("matches() on non-string")
        return self.pattern.search(value) is not None


class Program:
    """A compiled CEL expression: evaluate against any device."""

    __slots__ = ("source", "_root")

    def __init__(self, source: str, root: _Node):
        self.source = source
        self._root = root

    def evaluate(self, *, driver: str, attributes: Dict[str, Dict]) -> bool:
        """True iff the expression selects a device with the given
        driver/attributes; CelError on runtime type/attribute errors."""
        result = self._root.eval(driver, attributes)
        if not isinstance(result, bool):
            raise CelError(f"expression is not boolean: {result!r}")
        return result

    def matches(self, device: Dict, driver: str) -> bool:
        """Evaluate against a published resourceapi.Device entry; a CEL
        runtime error means the device is not selectable."""
        try:
            return self.evaluate(driver=driver,
                                 attributes=device.get("attributes") or {})
        except CelError:
            return False


class _Parser:
    """Recursive descent over the token list, producing an AST (the
    compile half; short-circuit lives in the _And/_Or nodes)."""

    def __init__(self, tokens: List[Tuple[str, str]]):
        self._toks = tokens
        self._i = 0

    # -- token helpers --------------------------------------------------

    def _peek(self):
        return self._toks[self._i] if self._i < len(self._toks) else None

    def _next(self):
        tok = self._peek()
        if tok is None:
            raise CelError("unexpected end of expression")
        self._i += 1
        return tok

    def _accept(self, kind: str, value: str = None) -> bool:
        tok = self._peek()
        if tok and tok[0] == kind and (value is None or tok[1] == value):
            self._i += 1
            return True
        return False

    def _expect(self, kind: str, value: str = None):
        tok = self._next()
        if tok[0] != kind or (value is not None and tok[1] != value):
            raise CelError(f"expected {value or kind}, got {tok[1]!r}")
        return tok

    # -- grammar --------------------------------------------------------

    def parse(self) -> _Node:
        node = self._or()
        if self._peek() is not None:
            raise CelError(f"trailing tokens at {self._peek()[1]!r}")
        return node

    def _or(self) -> _Node:
        node = self._and()
        while self._accept("op", "||"):
            node = _Or(node, self._and())
        return node

    def _and(self) -> _Node:
        node = self._cmp()
        while self._accept("op", "&&"):
            node = _And(node, self._cmp())
        return node

    def _cmp(self) -> _Node:
        lhs = self._unary()
        tok = self._peek()
        if tok and tok[0] == "op" and tok[1] in ("==", "!=", ">=",
                                                 "<=", ">", "<"):
            op = self._next()[1]
            return _Cmp(op, lhs, self._unary())
        return lhs

    def _unary(self) -> _Node:
        if self._accept("op", "!"):
            return _Not(self._unary())
        return self._primary()

    def _primary(self) -> _Node:
        if self._accept("op", "("):
            node = self._or()
            self._expect("op", ")")
            return self._methods(node)
        tok = self._next()
        if tok[0] == "str":
            return self._methods(_Const(_unquote(tok[1])))
        if tok[0] == "int":
            return _Const(int(tok[1]))
        if tok[0] == "ident":
            if tok[1] in ("true", "false"):
                return _Const(tok[1] == "true")
            if tok[1] == "device":
                return self._methods(self._device_chain())
            raise CelError(f"unknown identifier {tok[1]!r}")
        raise CelError(f"unexpected token {tok[1]!r}")

    def _device_chain(self) -> _Node:
        self._expect("op", ".")
        field = self._expect("ident")[1]
        if field == "driver":
            return _Driver()
        if field != "attributes":
            raise CelError(f"unknown device field {field!r}")
        self._expect("op", "[")
        key = _unquote(self._expect("str")[1])
        self._expect("op", "]")
        self._expect("op", ".")
        name = self._expect("ident")[1]
        return _Attr(key, name)

    def _methods(self, node: _Node) -> _Node:
        """Postfix method calls on a value: .lowerAscii(), .matches(re)."""
        while True:
            save = self._i
            if not self._accept("op", "."):
                return node
            tok = self._peek()
            if tok is None or tok[0] != "ident" or tok[1] not in (
                    "lowerAscii", "matches"):
                self._i = save
                return node
            method = self._next()[1]
            self._expect("op", "(")
            if method == "lowerAscii":
                self._expect("op", ")")
                node = _LowerAscii(node)
            else:
                pattern = _unquote(self._expect("str")[1])
                self._expect("op", ")")
                try:
                    compiled = re.compile(pattern)
                except re.error as e:
                    raise CelError(f"bad matches() pattern "
                                   f"{pattern!r}: {e}") from e
                node = _Matches(node, compiled)


def _unquote(raw: str) -> str:
    body = raw[1:-1]
    return re.sub(r"\\(.)", r"\1", body)


# ---------------------------------------------------------------------------
# Compile cache
# ---------------------------------------------------------------------------

# source string -> Program | CelError (negative entries keep a broken
# selector from being re-parsed per candidate device). Keyed by the FULL
# source string so near-identical expressions ('v5p' vs 'v5e') never
# collide. Bounded as a leak guard: selector sources come from
# DeviceClasses and claim specs, so real populations are tiny; synthetic
# floods (a fuzzer minting unique expressions) clear and restart rather
# than growing without bound.
_CACHE_MAX = 4096
_cache: Dict[str, Any] = {}
_cache_lock = threading.Lock()


def compile_expr(source: str) -> Program:
    """Parse `source` into a Program, memoized process-wide. Raises
    CelError on syntax errors (also memoized)."""
    cached = _cache.get(source)  # lock-free fast path (GIL-atomic read)
    if cached is None:
        CEL_CACHE_MISSES.inc()
        with _cache_lock:
            cached = _cache.get(source)
            if cached is None:
                CEL_COMPILES.inc()
                if len(_cache) >= _CACHE_MAX:
                    _cache.clear()
                try:
                    cached = Program(source, _Parser(_tokenize(source)).parse())
                except CelError as e:
                    cached = e
                _cache[source] = cached
    else:
        CEL_CACHE_HITS.inc()
    if isinstance(cached, CelError):
        raise cached
    return cached


def cache_info() -> Dict[str, int]:
    """Introspection for tests/bench: cached entry count (compiled +
    negative) — counters live on tpu_dra_torch.infra.metrics."""
    with _cache_lock:
        programs = sum(1 for v in _cache.values() if isinstance(v, Program))
        return {"entries": len(_cache), "programs": programs,
                "errors": len(_cache) - programs}


def clear_cache() -> None:
    """Test hook: drop all cached programs (counters are not reset)."""
    with _cache_lock:
        _cache.clear()


# ---------------------------------------------------------------------------
# Convenience entry points (compile-cache-backed)
# ---------------------------------------------------------------------------

def evaluate(expr: str, *, driver: str, attributes: Dict[str, Dict]) -> bool:
    """True iff `expr` selects a device with the given driver/attributes.
    Raises CelError on unsupported syntax, unknown attributes, or type
    errors (callers treat that as no-match)."""
    return compile_expr(expr).evaluate(driver=driver, attributes=attributes)


def device_matches(expr: str, device: Dict, driver: str) -> bool:
    """Evaluate against a published resourceapi.Device entry; a CEL error
    means the device is not selectable by this expression (the real
    scheduler's observable behavior for runtime errors)."""
    try:
        return evaluate(expr, driver=driver,
                        attributes=device.get("attributes") or {})
    except CelError:
        return False


def compile_many(sources: List[str]) -> Optional[List[Program]]:
    """Compile a selector conjunction; None when ANY source fails to
    compile — a broken selector selects nothing, not everything."""
    progs = []
    for s in sources:
        try:
            progs.append(compile_expr(s))
        except CelError:
            return None
    return progs
