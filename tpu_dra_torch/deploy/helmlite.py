"""helmlite: a Go-template-subset renderer for Helm charts (counterpart
of tpu_dra/deploy/helmlite.py).

Where no ``helm`` binary is installed, a chart must still be renderable
and validatable (the ``helm template`` gate). This module implements the
template subset the port's chart (``tpu_dra_torch/deploy/chart/
gpu-dra-driver``) and the reference's chart use:

- actions: ``{{ expr }}`` with ``{{-``/``-}}`` whitespace trimming
- blocks: if / else if / else, range (list and map, with ``$k, $v :=``),
  with, define/include
- pipelines: ``expr | fn arg | fn``
- terms: ``.a.b.c`` field chains, ``$`` root, ``$var`` (range/with vars),
  string literals, ints, bools, parenthesized expressions, function calls
- statements: ``$x := expr`` (declare) and ``$x = expr`` (reassign the
  nearest enclosing declaration, Go scoping — so list-building inside a
  range mutates the outer variable, the sprig append/join idiom)
- functions: quote, squote, default, toYaml, nindent, indent, printf
  (Go verbs %s %d %v %t %q %f, width), include, b64enc, eq, ne, not, and,
  or, empty, hasKey, trunc, trimSuffix, trimPrefix, lower, upper, replace,
  required, ternary, dict, list, len, contains, hasPrefix, hasSuffix,
  add, sub, mul, append, join, keys, toString, int, fail,
  genSelfSignedCert (real PEM pair via the cryptography package, with
  an ``openssl req -x509`` CLI fallback on hosts without it)

Truthiness follows Go templates: false, 0, "", nil, empty list/map are
falsy. Rendering is strict: unknown functions and malformed actions raise
``TemplateError`` (the ``helm template`` failure analog) rather than
emitting garbage YAML.
"""

from __future__ import annotations

import base64
import re
from typing import Any, Callable, Dict, List, Optional, Tuple


class TemplateError(Exception):
    pass


# ---------------------------------------------------------------------------
# Lexing: split into literal text and {{ action }} nodes with trim markers
# ---------------------------------------------------------------------------

_ACTION_RE = re.compile(r"\{\{(-?)\s*(.*?)\s*(-?)\}\}", re.DOTALL)


def _lex(src: str) -> List[Tuple[str, str]]:
    """Returns [('text', s) | ('action', body)] with whitespace trimming
    already applied per the -/- markers."""
    nodes: List[Tuple[str, str]] = []
    pos = 0
    for m in _ACTION_RE.finditer(src):
        text = src[pos:m.start()]
        if m.group(1) == "-":
            text = text.rstrip(" \t\n\r")
        nodes.append(("text", text))
        nodes.append(("action", m.group(2)))
        pos = m.end()
        if m.group(3) == "-":
            rest = src[pos:]
            trimmed = rest.lstrip(" \t\n\r")
            pos += len(rest) - len(trimmed)
    nodes.append(("text", src[pos:]))
    return nodes


# ---------------------------------------------------------------------------
# Parsing: build a block tree
# ---------------------------------------------------------------------------

class _Node:
    pass


class _Text(_Node):
    def __init__(self, s: str):
        self.s = s


class _Expr(_Node):
    def __init__(self, src: str):
        self.src = src


class _If(_Node):
    def __init__(self):
        # list of (condition_src | None for else, body nodes)
        self.branches: List[Tuple[Optional[str], List[_Node]]] = []


class _Range(_Node):
    def __init__(self, var_k, var_v, src):
        self.var_k, self.var_v, self.src = var_k, var_v, src
        self.body: List[_Node] = []


class _With(_Node):
    def __init__(self, src):
        self.src = src
        self.body: List[_Node] = []


class _Define(_Node):
    def __init__(self, name):
        self.name = name
        self.body: List[_Node] = []


class _Assign(_Node):
    """``$x := expr`` (declare in current scope) or ``$x = expr``
    (reassign nearest enclosing declaration — Go semantics, so a
    ``$gates = append $gates ...`` inside range mutates the outer var)."""

    def __init__(self, name: str, declare: bool, src: str):
        self.name, self.declare, self.src = name, declare, src


_RANGE_RE = re.compile(
    r"^range(?:\s+(\$\w+)\s*(?:,\s*(\$\w+))?\s*:=)?\s+(.*)$", re.DOTALL)
_ASSIGN_RE = re.compile(r"^\$(\w+)\s*(:?=)\s*(.*)$", re.DOTALL)


def _parse(nodes: List[Tuple[str, str]]) -> Tuple[List[_Node], Dict[str, List[_Node]]]:
    defines: Dict[str, List[_Node]] = {}
    root: List[_Node] = []
    stack: List[Tuple[Any, List[_Node]]] = [(None, root)]

    def body() -> List[_Node]:
        return stack[-1][1]

    for kind, val in nodes:
        if kind == "text":
            if val:
                body().append(_Text(val))
            continue
        action = val.strip()
        if action.startswith("/*") or action.startswith("//"):
            continue  # comment
        if action.startswith("if "):
            node = _If()
            node.branches.append((action[3:].strip(), []))
            body().append(node)
            stack.append((node, node.branches[-1][1]))
        elif action.startswith("else"):
            owner = stack[-1][0]
            if not isinstance(owner, _If):
                raise TemplateError(f"'else' outside if: {action!r}")
            stack.pop()
            cond = action[4:].strip()
            if cond.startswith("if "):
                cond = cond[3:].strip()
            else:
                cond = None
            owner.branches.append((cond, []))
            stack.append((owner, owner.branches[-1][1]))
        elif action.startswith("range"):
            m = _RANGE_RE.match(action)
            if not m:
                raise TemplateError(f"bad range: {action!r}")
            node = _Range(m.group(1), m.group(2), m.group(3).strip())
            body().append(node)
            stack.append((node, node.body))
        elif action.startswith("with "):
            node = _With(action[5:].strip())
            body().append(node)
            stack.append((node, node.body))
        elif action.startswith("define "):
            m = re.match(r'define\s+"([^"]+)"', action)
            if not m:
                raise TemplateError(f"bad define: {action!r}")
            node = _Define(m.group(1))
            stack.append((node, node.body))
        elif action == "end":
            owner, _ = stack.pop()
            if owner is None:
                raise TemplateError("unbalanced 'end'")
            if isinstance(owner, _Define):
                defines[owner.name] = owner.body
        else:
            m = _ASSIGN_RE.match(action)
            if m:
                body().append(_Assign(m.group(1), m.group(2) == ":=",
                                      m.group(3).strip()))
            else:
                body().append(_Expr(action))
    if len(stack) != 1:
        raise TemplateError("unclosed block at EOF")
    return root, defines


# ---------------------------------------------------------------------------
# Expression evaluation
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    \s*(
        "(?:[^"\\]|\\.)*"        # double-quoted string
      | `[^`]*`                  # raw string
      | \$\w+(?:\.[\w.]+)?       # $var with optional attached .field chain
      | \$                       # bare $ (root)
      | \.[\w.]*                 # field chain .a.b / bare .
      | -?\d+(?:\.\d+)?          # number
      | \|                       # pipe
      | \(|\)
      | [A-Za-z_][\w]*           # ident (function, true/false)
    )""", re.VERBOSE)


def _tokenize(src: str) -> List[str]:
    out, pos = [], 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise TemplateError(f"cannot tokenize: {src[pos:]!r}")
        out.append(m.group(1))
        pos = m.end()
    return out


def _truthy(v: Any) -> bool:
    if v is None or v is False:
        return False
    if isinstance(v, (int, float)) and v == 0:
        return False
    if isinstance(v, (str, list, dict, tuple)) and len(v) == 0:
        return False
    return True


class _Ctx:
    def __init__(self, root: Any, dot: Any, vars_: Dict[str, Any],
                 defines: Dict[str, List[_Node]], functions,
                 parent: Optional["_Ctx"] = None):
        self.root, self.dot, self.vars = root, dot, vars_
        self.defines, self.functions = defines, functions
        self.parent = parent

    def child(self, dot=None, extra_vars=None) -> "_Ctx":
        # Own-vars dict + parent link (not a flat copy) so that a Go-style
        # reassignment inside the child block mutates the declaring scope.
        return _Ctx(self.root, self.dot if dot is None else dot,
                    dict(extra_vars or {}), self.defines, self.functions,
                    parent=self)

    def lookup_var(self, name: str) -> Tuple[bool, Any]:
        c: Optional[_Ctx] = self
        while c is not None:
            if name in c.vars:
                return True, c.vars[name]
            c = c.parent
        return False, None

    def declare_var(self, name: str, value: Any) -> None:
        self.vars[name] = value

    def assign_var(self, name: str, value: Any) -> None:
        c: Optional[_Ctx] = self
        while c is not None:
            if name in c.vars:
                c.vars[name] = value
                return
            c = c.parent
        raise TemplateError(f"assignment to undeclared variable ${name}")


def _resolve_field(base: Any, chain: str) -> Any:
    cur = base
    for part in [p for p in chain.split(".") if p]:
        if isinstance(cur, dict):
            cur = cur.get(part)
        else:
            cur = getattr(cur, part, None)
        if cur is None:
            return None
    return cur


class _ExprEval:
    """Evaluates one pipeline: stages separated by '|'; each stage is a
    term or a function call whose last argument is the previous stage's
    output."""

    def __init__(self, ctx: _Ctx):
        self.ctx = ctx

    def eval(self, src: str) -> Any:
        tokens = _tokenize(src)
        stages: List[List[str]] = [[]]
        depth = 0
        for t in tokens:
            if t == "(":
                depth += 1
            elif t == ")":
                depth -= 1
            if t == "|" and depth == 0:
                stages.append([])
            else:
                stages[-1].append(t)
        value, first = None, True
        for stage in stages:
            if not stage:
                raise TemplateError(f"empty pipeline stage in {src!r}")
            value = self._eval_stage(stage, None if first else [value])
            first = False
        return value

    def _eval_stage(self, tokens: List[str], piped: Optional[List[Any]]) -> Any:
        pos = [0]

        def peek():
            return tokens[pos[0]] if pos[0] < len(tokens) else None

        def term() -> Any:
            t = peek()
            if t is None:
                raise TemplateError(f"unexpected end in {tokens!r}")
            pos[0] += 1
            if t == "(":
                # sub-pipeline until matching ')'
                depth, sub = 1, []
                while depth > 0:
                    nxt = peek()
                    if nxt is None:
                        raise TemplateError("unbalanced paren")
                    pos[0] += 1
                    if nxt == "(":
                        depth += 1
                    elif nxt == ")":
                        depth -= 1
                        if depth == 0:
                            break
                    sub.append(nxt)
                return _ExprEval(self.ctx).eval(" ".join(sub))
            if t.startswith('"'):
                return t[1:-1].replace('\\"', '"').replace("\\\\", "\\") \
                    .replace("\\n", "\n").replace("\\t", "\t")
            if t.startswith("`"):
                return t[1:-1]
            if t == "$":
                return self.ctx.root
            if t.startswith("$"):
                name, chain = t[1:], ""
                if "." in name:
                    name, chain = name.split(".", 1)
                found, base = self.ctx.lookup_var(name)
                if not found:
                    raise TemplateError(f"undefined variable ${name}")
                return _resolve_field(base, chain) if chain else base
            if t.startswith("."):
                return _resolve_field(self.ctx.dot, t)
            if re.fullmatch(r"-?\d+", t):
                return int(t)
            if re.fullmatch(r"-?\d+\.\d+", t):
                return float(t)
            if t == "true":
                return True
            if t == "false":
                return False
            if t == "nil":
                return None
            # function call: consume remaining tokens as args
            fn = self.ctx.functions.get(t)
            if fn is None:
                raise TemplateError(f"unknown function {t!r}")
            args = []
            while peek() is not None:
                args.append(term())
            if piped is not None:
                args.extend(piped)
            return fn(self.ctx, *args)

        first = term()
        # A bare term stage with piped input and leftovers is a call-less
        # stage (e.g. `.Values.x | quote` handled above); leftover tokens
        # after a non-function term is an error.
        if peek() is not None:
            raise TemplateError(f"trailing tokens in {tokens!r}")
        if piped is not None and not callable(first) and tokens and \
                not re.fullmatch(r"[A-Za-z_]\w*", tokens[0]):
            raise TemplateError(
                f"stage {tokens!r} cannot accept piped input")
        return first


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------

def _render_nodes(nodes: List[_Node], ctx: _Ctx) -> str:
    out: List[str] = []
    for node in nodes:
        if isinstance(node, _Text):
            out.append(node.s)
        elif isinstance(node, _Expr):
            v = _ExprEval(ctx).eval(node.src)
            if v is None:
                continue
            out.append(v if isinstance(v, str) else _gostr(v))
        elif isinstance(node, _If):
            for cond, body in node.branches:
                if cond is None or _truthy(_ExprEval(ctx).eval(cond)):
                    out.append(_render_nodes(body, ctx))
                    break
        elif isinstance(node, _Range):
            coll = _ExprEval(ctx).eval(node.src)
            if isinstance(coll, dict):
                items = [(k, coll[k]) for k in sorted(coll)]
            elif coll:
                items = list(enumerate(coll))
            else:
                items = []
            for k, v in items:
                extra = {}
                if node.var_k and node.var_v:
                    extra = {node.var_k[1:]: k, node.var_v[1:]: v}
                elif node.var_k:
                    extra = {node.var_k[1:]: v}
                out.append(_render_nodes(
                    node.body, ctx.child(dot=v, extra_vars=extra)))
        elif isinstance(node, _With):
            v = _ExprEval(ctx).eval(node.src)
            if _truthy(v):
                out.append(_render_nodes(node.body, ctx.child(dot=v)))
        elif isinstance(node, _Assign):
            v = _ExprEval(ctx).eval(node.src)
            if node.declare:
                ctx.declare_var(node.name, v)
            else:
                ctx.assign_var(node.name, v)
        else:
            raise TemplateError(f"unhandled node {node!r}")
    return "".join(out)


def _gostr(v: Any) -> str:
    if v is True:
        return "true"
    if v is False:
        return "false"
    return str(v)


def _to_yaml(v: Any) -> str:
    import yaml

    return yaml.safe_dump(v, default_flow_style=False, sort_keys=False).rstrip("\n")


_VERB_RE = re.compile(r"%(0?\d*)([sdvtqf%])")


def _go_sprintf(fmt: str, args: Tuple[Any, ...]) -> str:
    """Go fmt verb subset: %s %d %v %t %q %f, optional zero-padded width
    (e.g. %04d), and %% escape. Errors on arg-count mismatch like Go's
    EXTRA/MISSING markers would surface — strict beats garbage YAML."""
    it = iter(args)

    def sub(m: re.Match) -> str:
        width, verb = m.group(1), m.group(2)
        if verb == "%":
            return "%"
        try:
            a = next(it)
        except StopIteration:
            raise TemplateError(f"printf {fmt!r}: missing argument")
        if verb == "t":
            s = "true" if _truthy(a) else "false"
        elif verb == "d":
            s = str(int(a))
        elif verb == "f":
            s = str(float(a))
        elif verb == "q":
            return '"' + _gostr(a).replace('"', '\\"') + '"'
        else:
            s = _gostr(a)
        if width:
            pad = "0" if width.startswith("0") else " "
            s = s.rjust(int(width), pad)
        return s

    out = _VERB_RE.sub(sub, fmt)
    if next(it, None) is not None:
        raise TemplateError(f"printf {fmt!r}: too many arguments")
    return out


def _gen_self_signed_cert_openssl(cn: str, ips: List[str],
                                  dns_names: List[str],
                                  days: int) -> Dict[str, str]:
    """`openssl req -x509` fallback for hosts without the cryptography
    package.  Same contract as the primary path: self-signed CA cert
    (BasicConstraints critical CA:TRUE, EKU serverAuth, SAN covering the
    CN plus extra DNS/IP entries) and an unencrypted RSA-2048 key, both
    PEM.  The key comes out PKCS#8 ("BEGIN PRIVATE KEY") rather than
    TraditionalOpenSSL, which every PEM consumer in the charts accepts."""
    import os
    import subprocess
    import tempfile

    sans = [f"DNS.1 = {cn}"]
    for d in dns_names or []:
        if d and d != cn:
            sans.append(f"DNS.{len(sans) + 1} = {d}")
    n_ip = 0
    for ip in ips or []:
        if ip:
            n_ip += 1
            sans.append(f"IP.{n_ip} = {ip}")
    conf = (
        "[req]\n"
        "distinguished_name = dn\n"
        "prompt = no\n"
        "[dn]\n"
        f"CN = {cn}\n"
        "[v3_ext]\n"
        "basicConstraints = critical,CA:TRUE\n"
        "extendedKeyUsage = serverAuth\n"
        "subjectAltName = @alt\n"
        "[alt]\n" + "\n".join(sans) + "\n")
    with tempfile.TemporaryDirectory(prefix="helmlite-cert-") as tmp:
        cfg = os.path.join(tmp, "req.cnf")
        crt = os.path.join(tmp, "tls.crt")
        key = os.path.join(tmp, "tls.key")
        with open(cfg, "w") as f:
            f.write(conf)
        proc = subprocess.run(
            ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
             "-sha256", "-days", str(int(days)), "-keyout", key,
             "-out", crt, "-config", cfg, "-extensions", "v3_ext"],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise TemplateError(
                f"genSelfSignedCert: openssl fallback failed: {proc.stderr}")
        with open(crt) as f:
            cert_pem = f.read()
        with open(key) as f:
            key_pem = f.read()
    return {"Cert": cert_pem, "Key": key_pem}


def _gen_self_signed_cert(cn: str, ips: List[str], dns_names: List[str],
                          days: int) -> Dict[str, str]:
    """helm/sprig genSelfSignedCert analog: returns {Cert, Key} PEM pair.
    The cert is its own CA (BasicConstraints CA=true) so charts can use
    Cert as both the server certificate and the webhook caBundle."""
    import datetime
    import ipaddress

    try:
        from cryptography import x509
        from cryptography.hazmat.primitives import hashes, serialization
        from cryptography.hazmat.primitives.asymmetric import rsa
        from cryptography.x509.oid import ExtendedKeyUsageOID, NameOID
    except ImportError:
        return _gen_self_signed_cert_openssl(cn, ips, dns_names, days)

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, cn)])
    sans: List[x509.GeneralName] = [x509.DNSName(cn)]
    for d in dns_names or []:
        if d and d != cn:
            sans.append(x509.DNSName(str(d)))
    for ip in ips or []:
        if ip:
            sans.append(x509.IPAddress(ipaddress.ip_address(str(ip))))
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name).issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=int(days)))
        .add_extension(x509.BasicConstraints(ca=True, path_length=None),
                       critical=True)
        .add_extension(x509.SubjectAlternativeName(sans), critical=False)
        .add_extension(x509.ExtendedKeyUsage(
            [ExtendedKeyUsageOID.SERVER_AUTH]), critical=False)
        .sign(key, hashes.SHA256())
    )
    return {
        "Cert": cert.public_bytes(serialization.Encoding.PEM).decode(),
        "Key": key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.TraditionalOpenSSL,
            serialization.NoEncryption()).decode(),
    }


def _make_functions() -> Dict[str, Callable]:
    def quote(ctx, v):
        return '"' + _gostr("" if v is None else v).replace('"', '\\"') + '"'

    def squote(ctx, v):
        return "'" + _gostr("" if v is None else v) + "'"

    def default(ctx, dflt, v=None):
        return v if _truthy(v) else dflt

    def to_yaml(ctx, v):
        return _to_yaml(v)

    def nindent(ctx, n, s):
        pad = " " * int(n)
        return "\n" + "\n".join(
            pad + line if line else line for line in _gostr(s).split("\n"))

    def indent(ctx, n, s):
        pad = " " * int(n)
        return "\n".join(
            pad + line if line else line for line in _gostr(s).split("\n"))

    def include(ctx, name, dot):
        body = ctx.defines.get(name)
        if body is None:
            raise TemplateError(f"include of undefined template {name!r}")
        # Fresh variable scope (Go template-invocation semantics): the
        # callee sees only its argument, not the caller's $vars.
        return _render_nodes(body, _Ctx(ctx.root, dot, {}, ctx.defines,
                                        ctx.functions))

    def printf(ctx, fmt, *args):
        return _go_sprintf(fmt, args)

    def required(ctx, msg, v):
        if not _truthy(v):
            raise TemplateError(f"required value missing: {msg}")
        return v

    def ternary(ctx, if_true, if_false, cond):
        return if_true if _truthy(cond) else if_false

    return {
        "quote": quote,
        "squote": squote,
        "default": default,
        "toYaml": to_yaml,
        "nindent": nindent,
        "indent": indent,
        "include": include,
        "printf": printf,
        "b64enc": lambda ctx, s: base64.b64encode(
            _gostr(s).encode()).decode(),
        "eq": lambda ctx, a, b: a == b,
        "ne": lambda ctx, a, b: a != b,
        "not": lambda ctx, v: not _truthy(v),
        "and": lambda ctx, *vs: all(_truthy(v) for v in vs),
        "or": lambda ctx, *vs: next((v for v in vs if _truthy(v)),
                                    vs[-1] if vs else None),
        "empty": lambda ctx, v: not _truthy(v),
        "hasKey": lambda ctx, d, k: isinstance(d, dict) and k in d,
        "len": lambda ctx, v: len(v) if v is not None else 0,
        "trunc": lambda ctx, n, s: _gostr(s)[:int(n)],
        "trimSuffix": lambda ctx, suf, s: _gostr(s)[:-len(suf)]
        if _gostr(s).endswith(suf) else _gostr(s),
        "lower": lambda ctx, s: _gostr(s).lower(),
        "upper": lambda ctx, s: _gostr(s).upper(),
        "replace": lambda ctx, old, new, s: _gostr(s).replace(old, new),
        "required": required,
        "ternary": ternary,
        "dict": lambda ctx, *kv: {kv[i]: kv[i + 1]
                                  for i in range(0, len(kv), 2)},
        "list": lambda ctx, *vs: list(vs),
        "contains": lambda ctx, sub, s: sub in _gostr(s),
        "hasPrefix": lambda ctx, pre, s: _gostr(s).startswith(pre),
        "hasSuffix": lambda ctx, suf, s: _gostr(s).endswith(suf),
        "trimPrefix": lambda ctx, pre, s: _gostr(s)[len(pre):]
        if _gostr(s).startswith(pre) else _gostr(s),
        "add": lambda ctx, *vs: sum(int(v) for v in vs),
        "sub": lambda ctx, a, b: int(a) - int(b),
        "mul": lambda ctx, *vs: __import__("math").prod(int(v) for v in vs),
        "append": lambda ctx, lst, *items: list(lst or []) + list(items),
        "join": lambda ctx, sep, lst: sep.join(_gostr(v) for v in lst or []),
        "keys": lambda ctx, d: sorted((d or {}).keys()),
        "toString": lambda ctx, v: _gostr(v),
        "int": lambda ctx, v: int(v),
        "fail": _fail,
        "genSelfSignedCert": lambda ctx, cn, ips, dns, days:
            _gen_self_signed_cert(cn, ips, dns, days),
    }


def _fail(ctx, msg):
    raise TemplateError(f"fail: {_gostr(msg)}")


# ---------------------------------------------------------------------------
# Chart driver
# ---------------------------------------------------------------------------

def _deep_merge(base: Dict, override: Dict) -> Dict:
    out = dict(base)
    for k, v in (override or {}).items():
        if v is None:
            # Helm semantics: an explicit null in an override DELETES the
            # default key (how overlays drop a default nodeSelector entry,
            # e.g. demo/clusters/gke/values-gke.yaml).
            out.pop(k, None)
        elif isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def render_chart(chart_dir: str, values_override: Optional[Dict] = None,
                 release_name: str = "gpu-dra-driver",
                 namespace: str = "gpu-dra-driver") -> List[Dict]:
    """The `helm template` analog: renders every templates/*.yaml plus
    crds/*.yaml and returns the parsed document list. Raises TemplateError
    or yaml.YAMLError on malformed output — the validation gate. Needs
    PyYAML (imported here, so that the rest of the port never does)."""
    import os

    import yaml

    with open(os.path.join(chart_dir, "Chart.yaml")) as f:
        chart_meta = yaml.safe_load(f)
    with open(os.path.join(chart_dir, "values.yaml")) as f:
        values = yaml.safe_load(f) or {}
    values = _deep_merge(values, values_override or {})

    root = {
        "Values": values,
        "Release": {"Name": release_name, "Namespace": namespace,
                    "Service": "Helm"},
        "Chart": {"Name": chart_meta.get("name", ""),
                  "Version": chart_meta.get("version", ""),
                  "AppVersion": chart_meta.get("appVersion", "")},
    }

    tdir = os.path.join(chart_dir, "templates")
    sources = {}
    for fn in sorted(os.listdir(tdir)):
        if fn.endswith((".yaml", ".tpl")):
            with open(os.path.join(tdir, fn)) as f:
                sources[fn] = f.read()

    # First pass: collect defines from every file (helm shares them).
    defines: Dict[str, List[_Node]] = {}
    parsed = {}
    for fn, src in sources.items():
        tree, defs = _parse(_lex(src))
        defines.update(defs)
        parsed[fn] = tree

    functions = _make_functions()
    docs: List[Dict] = []
    for fn, tree in parsed.items():
        if fn.endswith(".tpl"):
            continue
        ctx = _Ctx(root, root, {}, defines, functions)
        text = _render_nodes(tree, ctx)
        for doc in yaml.safe_load_all(text):
            if doc:
                docs.append(doc)

    cdir = os.path.join(chart_dir, "crds")
    if os.path.isdir(cdir):
        for fn in sorted(os.listdir(cdir)):
            with open(os.path.join(cdir, fn)) as f:
                for doc in yaml.safe_load_all(f.read()):
                    if doc:
                        docs.append(doc)
    return docs
