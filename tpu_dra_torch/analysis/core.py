"""dralint core: AST lint framework for project invariants.

The reference driver keeps its heavily threaded control plane honest
with `go vet`, golangci-lint and `go test -race` (Makefile:96). This
package is the Python reproduction's analog, except the rules are not
generic style checks — they are THIS project's concurrency and
ownership invariants (SURVEY §§8-12), machine-checked:

- visitor-based rules over ``ast`` trees (one parse per file, every
  rule sees every module);
- findings carry ``file:line:col``, a stable rule id, and a message;
- ``# dralint: ignore[R2]`` (or bare ``# dralint: ignore``) on the
  finding's line or the line directly above suppresses it — the
  suppression count is reported, so waivers stay visible;
- human (``path:line:col: Rn message``) and ``--json`` output;
- cross-file rules (orphan detection) run in a ``finalize`` phase
  after every module has been scanned.

Registries (fault sites, the metric catalog, feature-gate names) are
parsed from the infra modules' ASTs, not imported — linting must not
execute project code or depend on import-time side effects.
"""

from __future__ import annotations

import ast
import io
import json
import re
import tokenize
from dataclasses import dataclass, field
from pathlib import Path
from typing import (
    Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple,
)

from tpu_dra_torch.infra.metrics import DefaultRegistry as _METRICS

# Lint observability (METRICS_CATALOG, R5-checked like every other
# metric): findings emitted and per-file cache hits, so CI can trend
# both the invariant debt and the incremental cache's effectiveness.
_LINT_FINDINGS = _METRICS.counter(
    "tpu_dra_lint_findings_total",
    "dralint findings emitted across runs in this process")
_LINT_CACHE_HITS = _METRICS.counter(
    "tpu_dra_lint_cache_hits_total",
    "dralint per-file result-cache hits (stat or content-hash tier)")

_SUPPRESS_RE = re.compile(
    r"#\s*dralint:\s*ignore(?:\[(?P<rules>[^\]]*)\])?(?P<rest>[^#]*)")

# A suppression is JUSTIFIED when the comment carries prose beyond the
# ignore tag (``# dralint: ignore[R7] — rollback is the caller's``).
# --require-justified gates unjustified suppressions to zero, so the waiver
# count can never grow without a visible reason in the diff.
_JUSTIFY_MIN_CHARS = 3


@dataclass(frozen=True)
class Finding:
    """One rule violation, anchored to a source location."""
    rule: str
    path: str
    line: int
    col: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"

    def to_dict(self) -> Dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message}


@dataclass
class Module:
    """One parsed source file plus its suppression map."""
    path: Path
    relpath: str          # repo-root-relative, for stable output
    source: str
    tree: ast.AST
    # line -> None (suppress all rules) or the set of suppressed rule ids
    suppressions: Dict[int, Optional[Set[str]]] = field(default_factory=dict)
    # line -> the ignore comment carries a justification string
    justified: Dict[int, bool] = field(default_factory=dict)

    @property
    def is_test(self) -> bool:
        parts = Path(self.relpath).parts
        return "tests" in parts or Path(self.relpath).name.startswith("test_")

    @property
    def is_chaos(self) -> bool:
        return "chaos" in Path(self.relpath).name

    def suppressed(self, rule: str, line: int) -> bool:
        """A finding at `line` is waived by an ignore comment on the
        same line or the line directly above it."""
        return _lookup_suppressed(self.suppressions, rule, line)

    def suppression_justified(self, rule: str, line: int) -> bool:
        return _lookup_justified(self.suppressions, self.justified,
                                 rule, line)


_MISSING = object()


def _lookup_suppressed(lines: Dict[int, Optional[Set[str]]],
                       rule: str, line: int) -> bool:
    """The one definition of waiver semantics (same line or line
    directly above; None = all rules), shared by parsed modules and the
    result cache's replayed suppression maps — warm and cold runs must
    agree byte for byte."""
    for ln in (line, line - 1):
        rules = lines.get(ln, _MISSING)
        if rules is _MISSING:
            continue
        if rules is None or rule in rules:
            return True
    return False


def _lookup_justified(lines: Dict[int, Optional[Set[str]]],
                      justified: Dict[int, bool],
                      rule: str, line: int) -> bool:
    """Whether the comment that suppresses (rule, line) carries a
    justification string — resolved against the same line-or-above
    comment `_lookup_suppressed` matched."""
    for ln in (line, line - 1):
        rules = lines.get(ln, _MISSING)
        if rules is _MISSING:
            continue
        if rules is None or rule in rules:
            return justified.get(ln, False)
    return False


def _parse_suppressions(
        source: str) -> Tuple[Dict[int, Optional[Set[str]]],
                              Dict[int, bool]]:
    out: Dict[int, Optional[Set[str]]] = {}
    just: Dict[int, bool] = {}
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _SUPPRESS_RE.search(tok.string)
            if not m:
                continue
            rest = (m.group("rest") or "").strip(" \t-—:.,")
            has_reason = len(rest) >= _JUSTIFY_MIN_CHARS
            ln = tok.start[0]
            just[ln] = just.get(ln, False) or has_reason
            raw = m.group("rules")
            if raw is None:
                out[ln] = None
            else:
                rules = {r.strip() for r in raw.split(",") if r.strip()}
                prev = out.get(ln, _MISSING)
                if prev is None:
                    continue  # bare ignore on the same line already wins
                merged = rules if prev is _MISSING else (prev | rules)
                out[ln] = merged
    except (tokenize.TokenError, IndentationError):
        pass  # unparseable comments: no suppressions, findings stand
    return out, just


def parse_module(path: Path, root: Path,
                 source: Optional[str] = None) -> Optional[Module]:
    if source is None:
        source = path.read_text(encoding="utf-8")
    try:
        tree = ast.parse(source, filename=str(path))
    except SyntaxError:
        return None  # compileall owns syntax errors
    try:
        rel = str(path.relative_to(root))
    except ValueError:
        rel = str(path)
    suppressions, justified = _parse_suppressions(source)
    return Module(path=path, relpath=rel, source=source, tree=tree,
                  suppressions=suppressions, justified=justified)


# ---------------------------------------------------------------------------
# Project registries (parsed, never imported)
# ---------------------------------------------------------------------------

@dataclass
class ProjectContext:
    """Shared state for a lint run: the project registries plus anchors
    for cross-file orphan findings."""
    root: Path
    fault_sites: Dict[str, int] = field(default_factory=dict)   # site -> line
    # site -> declared degradation-helper name (faults.DEGRADATIONS):
    # drflow R15 requires handlers guarding these sites to route there.
    fault_degradations: Dict[str, str] = field(default_factory=dict)
    fault_sites_path: str = ""
    metric_catalog: Dict[str, int] = field(default_factory=dict)
    metric_catalog_path: str = ""
    gate_names: Set[str] = field(default_factory=set)
    # Relpaths this run scanned. Orphan rules (R4/R5) only report
    # registry entries as unused when the registry's own file was in
    # view — a single-file lint is not evidence of project-wide orphans.
    scanned: Set[str] = field(default_factory=set)

    @classmethod
    def load(cls, root: Path) -> "ProjectContext":
        ctx = cls(root=root)
        faults = root / "tpu_dra_torch" / "infra" / "faults.py"
        if faults.exists():
            ctx.fault_sites_path = str(faults.relative_to(root))
            ctx.fault_sites = _dict_literal_keys(faults, "SITES")
            ctx.fault_degradations = _dict_literal_items(
                faults, "DEGRADATIONS")
        metrics = root / "tpu_dra_torch" / "infra" / "metrics.py"
        if metrics.exists():
            ctx.metric_catalog_path = str(metrics.relative_to(root))
            ctx.metric_catalog = _dict_literal_keys(metrics, "METRICS_CATALOG")
        gates = root / "tpu_dra_torch" / "infra" / "featuregates.py"
        if gates.exists():
            ctx.gate_names = _string_constants(gates)
        return ctx


def _dict_literal_keys(path: Path, name: str) -> Dict[str, int]:
    """String keys (and their line numbers) of the module-level dict
    literal assigned to `name`."""
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
        for t in targets:
            if (isinstance(t, ast.Name) and t.id == name
                    and isinstance(node.value, ast.Dict)):
                return {k.value: k.lineno for k in node.value.keys
                        if isinstance(k, ast.Constant)
                        and isinstance(k.value, str)}
    return {}


def _dict_literal_items(path: Path, name: str) -> Dict[str, str]:
    """String key -> string value of the module-level dict literal
    assigned to `name` (non-string entries are skipped)."""
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
        for t in targets:
            if (isinstance(t, ast.Name) and t.id == name
                    and isinstance(node.value, ast.Dict)):
                return {k.value: v.value
                        for k, v in zip(node.value.keys,
                                        node.value.values)
                        if isinstance(k, ast.Constant)
                        and isinstance(k.value, str)
                        and isinstance(v, ast.Constant)
                        and isinstance(v.value, str)}
    return {}


def _string_constants(path: Path) -> Set[str]:
    """Module-level ``Name = "Name"`` assignments — the feature-gate
    constant idiom (featuregates.py)."""
    tree = ast.parse(path.read_text(encoding="utf-8"))
    out: Set[str] = set()
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)
                and node.targets[0].id == node.value.value):
            out.add(node.value.value)
    return out


# ---------------------------------------------------------------------------
# Rule registry
# ---------------------------------------------------------------------------

class Rule:
    """One lint rule. ``scan`` runs per module; ``finalize`` once after
    all modules (cross-file orphan checks). Rules are instantiated per
    run — they may keep collection state between scan and finalize.

    Rules with cross-file state additionally speak the FACTS protocol
    so the per-file result cache can skip re-scanning unchanged files:
    ``module_facts()`` (called right after ``scan(module)``) returns the
    JSON-able contribution that module made to the rule's aggregate
    state, and ``absorb_facts`` replays a cached contribution for a
    file the runner did not re-parse. Per-file findings are cached
    separately by the runner; finalize always recomputes."""

    rule_id: str = ""
    title: str = ""
    # Rule ids this rule emits. Most rules emit exactly their own id;
    # a combined pass (raceanalysis R9-R11) declares the full set so
    # --rules filtering keeps working (core also post-filters findings
    # by id, so asking for R10 from a combined rule yields only R10).
    provides: frozenset = frozenset()
    # Cache key this rule's FACTS live under. Defaults to rule_id; a
    # rule that CONSUMES another rule's extraction (drflow R13-R15
    # rides draracer's per-module blob) names that rule's id here so
    # the blob is stored once and replayed to both — absorb_facts gets
    # the shared blob, module_facts should return None (the producing
    # rule already contributed it).
    facts_key: str = ""

    @classmethod
    def provided_ids(cls) -> frozenset:
        return cls.provides or frozenset({cls.rule_id})

    @classmethod
    def facts_id(cls) -> str:
        return cls.facts_key or cls.rule_id

    def scan(self, module: Module, ctx: ProjectContext) -> Iterator[Finding]:
        return iter(())

    def finalize(self, ctx: ProjectContext) -> Iterator[Finding]:
        return iter(())

    def module_facts(self) -> Optional[Dict]:
        return None

    def absorb_facts(self, relpath: str, facts: Dict,
                     ctx: ProjectContext) -> None:
        pass


_RULE_CLASSES: List[type] = []


def register(cls: type) -> type:
    _RULE_CLASSES.append(cls)
    return cls


def all_rules() -> List[Rule]:
    return [cls() for cls in _RULE_CLASSES]


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------

@dataclass
class Report:
    findings: List[Finding] = field(default_factory=list)
    suppressed: List[Finding] = field(default_factory=list)
    files: int = 0
    cache_hits: int = 0
    # Suppressed findings whose ignore comment has no justification
    # string — the lint.sh --require-justified gate.
    unjustified: List[Finding] = field(default_factory=list)
    # Per-rule-class wall-clock seconds (scan accumulated across files
    # + finalize), keyed by the rule's primary id — the --rule-table
    # timing column. Parallel scans bill the pool's wall time to
    # "<scan-pool>" since per-rule attribution dissolves across
    # processes.
    timings: Dict[str, float] = field(default_factory=dict)
    # The context the run was performed against (registries + scanned
    # set) — lets callers (e.g. --sites-report) reuse the parse.
    ctx: Optional["ProjectContext"] = None

    @property
    def ok(self) -> bool:
        return not self.findings

    @staticmethod
    def _by_rule(findings: List[Finding]) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return dict(sorted(out.items()))

    def to_dict(self) -> Dict:
        # Per-rule counts ride along so CI can trend suppressions the
        # same way the human formatter surfaces them.
        return {"files": self.files,
                "cache_hits": self.cache_hits,
                "findings": [f.to_dict() for f in self.findings],
                "suppressed": [f.to_dict() for f in self.suppressed],
                "findings_by_rule": self._by_rule(self.findings),
                "suppressed_by_rule": self._by_rule(self.suppressed),
                "timings_s": {k: round(v, 4)
                              for k, v in sorted(self.timings.items())},
                "suppressed_unjustified":
                    [f.to_dict() for f in self.unjustified]}


def iter_python_files(paths: Sequence[Path]) -> Iterator[Path]:
    seen: Set[Path] = set()
    for p in paths:
        if p.is_dir():
            for f in sorted(p.rglob("*.py")):
                if "__pycache__" in f.parts or f in seen:
                    continue
                seen.add(f)
                yield f
        elif p.suffix == ".py" and p not in seen:
            seen.add(p)
            yield p


def default_paths(root: Path) -> List[Path]:
    """What a bare run lints: the port's package, its tests
    (``tests/test_torch_*.py``) and ``chip_smoke.py``."""
    paths = [root / "tpu_dra_torch"]
    paths += sorted((root / "tests").glob("test_torch_*.py"))
    paths.append(root / "chip_smoke.py")
    return [p for p in paths if p.exists()]


def find_root(start: Path) -> Path:
    """The repo root: the nearest ancestor holding the infra registries."""
    cur = start.resolve()
    if cur.is_file():
        cur = cur.parent
    while True:
        if (cur / "tpu_dra_torch" / "infra" / "faults.py").exists():
            return cur
        if cur.parent == cur:
            return start.resolve() if start.is_dir() else start.parent
        cur = cur.parent


# ---------------------------------------------------------------------------
# Per-file result cache
# ---------------------------------------------------------------------------
# Whole-tree lint re-parses ~190 files per run even though almost none
# changed between runs. Entries are
# keyed by (path, mtime_ns, size) and the cache as a whole by a
# rules-version hash (the analyzer's own sources) plus a registries
# hash (faults/metrics/featuregates — their content changes the verdict
# for OTHER files, e.g. an unknown-site finding). An entry stores the
# file's scan-phase findings, its suppression map (finalize findings
# must still honor line-level waivers in unparsed files), and the
# cross-file FACTS each rule contributed (Rule.module_facts), which are
# replayed through absorb_facts so finalize sees the whole tree.

CACHE_VERSION = 3
CACHE_FILENAME = ".dralint-torch-cache.json"

_RULES_SOURCES = ("core.py", "rules.py", "raceanalysis.py",
                  "flowanalysis.py")
_REGISTRY_SOURCES = ("infra/faults.py", "infra/metrics.py",
                     "infra/featuregates.py")


def _hash_sources(files: Iterable[Path]) -> str:
    import hashlib
    h = hashlib.sha1()
    for f in files:
        try:
            h.update(f.read_bytes())
        except OSError:
            h.update(b"?")
    return h.hexdigest()


def cache_keys(root: Path) -> Dict[str, str]:
    analysis = Path(__file__).resolve().parent
    return {
        "rules_version": _hash_sources(analysis / n
                                       for n in _RULES_SOURCES),
        "registries": _hash_sources(root / "tpu_dra_torch" / n
                                    for n in _REGISTRY_SOURCES),
    }


def _load_cache(path: Path, keys: Dict[str, str]) -> Dict:
    try:
        doc = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError, ValueError):
        return {"files": {}}
    if (not isinstance(doc, dict) or doc.get("version") != CACHE_VERSION
            or doc.get("rules_version") != keys["rules_version"]
            or doc.get("registries") != keys["registries"]
            or not isinstance(doc.get("files"), dict)):
        return {"files": {}}
    return doc


class _CachedSuppressions:
    """Module.suppressed() semantics over a cached suppression map —
    finalize findings anchored in an unparsed file still honor its
    waiver comments (and their justification strings)."""

    def __init__(self, doc: Dict):
        lines = doc.get("lines", doc) or {}
        self._lines: Dict[int, Optional[Set[str]]] = {}
        for line, rules in lines.items():
            self._lines[int(line)] = (None if rules is None
                                      else set(rules))
        self._just: Dict[int, bool] = {
            int(line): bool(v)
            for line, v in (doc.get("just") or {}).items()}

    def suppressed(self, rule: str, line: int) -> bool:
        return _lookup_suppressed(self._lines, rule, line)

    def suppression_justified(self, rule: str, line: int) -> bool:
        return _lookup_justified(self._lines, self._just, rule, line)


def _suppressions_doc(mod: Module) -> Dict:
    return {"lines": {str(ln): (None if rules is None else sorted(rules))
                      for ln, rules in mod.suppressions.items()},
            "just": {str(ln): v for ln, v in mod.justified.items()}}


def _rel(path: Path, root: Path) -> str:
    try:
        return str(path.relative_to(root))
    except ValueError:
        return str(path)


# ---------------------------------------------------------------------------
# Per-module scan (shared by the serial loop and the --jobs pool)
# ---------------------------------------------------------------------------

def _scan_module(mod: Module, active: Sequence[Rule], ctx: ProjectContext,
                 timings: Optional[Dict[str, float]] = None,
                 ) -> Tuple[List[Finding], List[Finding], Dict[str, Dict]]:
    """Run every rule's scan phase over one module, returning
    (findings, suppressed, facts-by-key). The one definition of the
    scan-phase protocol — the multiprocessing workers and the in-process
    loop must agree byte for byte or warm/cold/parallel runs diverge."""
    import time
    mod_findings: List[Finding] = []
    mod_suppressed: List[Finding] = []
    facts: Dict[str, Dict] = {}
    for rule in active:
        t0 = time.perf_counter() if timings is not None else 0.0
        for finding in rule.scan(mod, ctx):
            if mod.suppressed(finding.rule, finding.line):
                mod_suppressed.append(finding)
            else:
                mod_findings.append(finding)
        rule_facts = rule.module_facts()
        if rule_facts is not None:
            # setdefault: two rules sharing a facts_key (draracer and
            # drflow both ride the R9 extraction) contribute it once.
            facts.setdefault(rule.facts_id(), rule_facts)
        if timings is not None:
            timings[rule.rule_id] = (timings.get(rule.rule_id, 0.0)
                                     + time.perf_counter() - t0)
    return mod_findings, mod_suppressed, facts


# Pool workers re-create the registries once per process (initializer),
# not once per file — ProjectContext.load parses three infra modules.
_POOL_STATE: Optional[Tuple[Path, "ProjectContext"]] = None


def _pool_init(root_str: str) -> None:
    global _POOL_STATE
    # Rule registration lives in the package __init__ — inherited under
    # fork, but a spawn-based start method needs the explicit import.
    import tpu_dra_torch.analysis  # noqa: F401
    root = Path(root_str)
    _POOL_STATE = (root, ProjectContext.load(root))


def _pool_scan(item: Tuple[str, str]) -> Tuple[str, Optional[Dict]]:
    """One file's scan phase in a worker process: returns a cache-entry
    -shaped payload (findings/suppressed/suppressions/facts) the parent
    absorbs exactly like a cache hit. None = unparseable (compileall
    owns syntax errors, same as the serial path)."""
    rel, source = item
    assert _POOL_STATE is not None
    root, ctx = _POOL_STATE
    mod = parse_module(root / rel, root, source=source)
    if mod is None:
        return rel, None
    mod_findings, mod_suppressed, facts = _scan_module(
        mod, all_rules(), ctx)
    return rel, {
        "findings": [f.to_dict() for f in mod_findings],
        "suppressed": [f.to_dict() for f in mod_suppressed],
        "suppressions": _suppressions_doc(mod),
        "facts": facts,
    }


def resolve_jobs(jobs: object) -> int:
    """'auto'/0 -> min(8, cpu count), else int(jobs) floored at 1."""
    import os
    if jobs in ("auto", 0, "0", None):
        return max(1, min(8, os.cpu_count() or 1))
    return max(1, int(jobs))  # type: ignore[arg-type]


def run(paths: Sequence[Path], root: Optional[Path] = None,
        rules: Optional[Iterable[Rule]] = None,
        rule_ids: Optional[Set[str]] = None,
        use_cache: bool = False, jobs: int = 1) -> Report:
    import hashlib
    import time

    paths = [Path(p) for p in paths]
    root = Path(root) if root else find_root(paths[0] if paths else Path("."))
    ctx = ProjectContext.load(root)
    active = list(rules) if rules is not None else all_rules()
    if rule_ids:
        active = [r for r in active if r.provided_ids() & rule_ids]
    # The cache stores full-rule-set results; a rule-filtered run must
    # not read partial entries as authoritative nor poison future runs.
    # (Callers passing explicit `rules` with use_cache=True — the CLI —
    # are expected to pass the full registry.)
    use_cache = use_cache and rule_ids is None
    cache_path = root / CACHE_FILENAME
    keys = cache_keys(root) if use_cache else {}
    cache = _load_cache(cache_path, keys) if use_cache else {"files": {}}

    report = Report(ctx=ctx)
    pending: List[Tuple[str, str]] = []  # (relpath, source) to scan
    cached: Dict[str, Dict] = {}     # relpath -> valid cache entry
    stats: Dict[str, Dict] = {}      # relpath -> fresh stat for new entry
    refreshed: Dict[str, Dict] = {}  # content-hash hits with new stat keys
    for f in iter_python_files(paths):
        rel = _rel(f, root)
        # A stat/read failure raises: silently skipping an unreadable
        # file would drop its findings AND its contribution to the
        # R9-R11 call graph — "lint tier green" must never mean "lint
        # could not see the tree".
        st = f.stat()
        entry = cache["files"].get(rel) if use_cache else None
        if (entry is not None and entry.get("mtime_ns") == st.st_mtime_ns
                and entry.get("size") == st.st_size):
            cached[rel] = entry
            continue
        data = f.read_bytes()
        sha = hashlib.sha1(data).hexdigest() if use_cache else ""
        if (entry is not None and entry.get("sha1")
                and entry["sha1"] == sha):
            # Content-hash fallback tier: a touch or a content-equal
            # rewrite changed the stat key but not the bytes — reuse
            # the entry and refresh its stat key so the next run hits
            # on the cheap tier again.
            entry = {**entry, "mtime_ns": st.st_mtime_ns,
                     "size": st.st_size}
            cached[rel] = entry
            refreshed[rel] = entry
            continue
        pending.append((rel, data.decode("utf-8")))
        stats[rel] = {"mtime_ns": st.st_mtime_ns,
                      "size": st.st_size, "sha1": sha}

    # Scan phase. Every module is scanned by FRESH per-file rule
    # instances (exactly what a pool worker does) and reduced to a
    # cache-entry-shaped payload; `active` instances are populated
    # purely through absorb_facts below, in sorted relpath order, so
    # warm, cold, serial and --jobs runs feed finalize identically.
    rule_classes = [type(r) for r in active]
    scanned: Dict[str, Dict] = {}         # relpath -> entry payload
    modules_by_rel: Dict[str, Module] = {}
    jobs = min(resolve_jobs(jobs), max(1, len(pending)))
    if set(rule_classes) != set(_RULE_CLASSES):
        # Pool workers instantiate the REGISTERED rule set; a filtered
        # or custom rule list must scan serially or the workers would
        # silently run different rules than the caller asked for.
        jobs = 1
    if jobs > 1:
        import multiprocessing
        t0 = time.perf_counter()
        with multiprocessing.Pool(jobs, initializer=_pool_init,
                                  initargs=(str(root),)) as pool:
            for rel, payload in pool.imap_unordered(
                    _pool_scan, pending, chunksize=4):
                if payload is not None:
                    scanned[rel] = payload
        report.timings["<scan-pool>"] = time.perf_counter() - t0
    else:
        for rel, source in pending:
            mod = parse_module(root / rel, root, source=source)
            if mod is None:
                continue  # compileall owns syntax errors
            mod_findings, mod_suppressed, facts = _scan_module(
                mod, [cls() for cls in rule_classes], ctx,
                timings=report.timings)
            modules_by_rel[rel] = mod
            scanned[rel] = {
                "findings": [f.to_dict() for f in mod_findings],
                "suppressed": [f.to_dict() for f in mod_suppressed],
                "suppressions": _suppressions_doc(mod),
                "facts": facts,
            }

    report.files = len(scanned) + len(cached)
    report.cache_hits = len(cached)
    ctx.scanned = set(scanned) | set(cached)

    by_rel: Dict[str, object] = {}
    new_entries: Dict[str, Dict] = dict(refreshed)
    entries = {**cached, **scanned}
    for rel in sorted(entries):
        entry = entries[rel]
        replayed = modules_by_rel.get(rel) or _CachedSuppressions(
            entry.get("suppressions") or {})
        by_rel[rel] = replayed
        for rule in active:
            facts = (entry.get("facts") or {}).get(rule.facts_id())
            if facts is not None:
                rule.absorb_facts(rel, facts, ctx)
        report.findings.extend(Finding(**d) for d in entry["findings"])
        for d in entry["suppressed"]:
            f = Finding(**d)
            report.suppressed.append(f)
            if not replayed.suppression_justified(f.rule, f.line):
                report.unjustified.append(f)
        if use_cache and rel in stats:
            new_entries[rel] = {**stats[rel],
                                "findings": entry["findings"],
                                "suppressed": entry["suppressed"],
                                "suppressions": entry["suppressions"],
                                "facts": entry["facts"]}

    for rule in active:
        t0 = time.perf_counter()
        for finding in rule.finalize(ctx):
            mod = by_rel.get(finding.path)
            if mod is not None and mod.suppressed(finding.rule, finding.line):
                report.suppressed.append(finding)
                if not mod.suppression_justified(finding.rule,
                                                 finding.line):
                    report.unjustified.append(finding)
            else:
                report.findings.append(finding)
        report.timings[rule.rule_id] = (
            report.timings.get(rule.rule_id, 0.0)
            + time.perf_counter() - t0)
    if rule_ids:
        report.findings = [f for f in report.findings
                           if f.rule in rule_ids]
        report.suppressed = [f for f in report.suppressed
                             if f.rule in rule_ids]
        report.unjustified = [f for f in report.unjustified
                              if f.rule in rule_ids]
    report.findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    report.suppressed.sort(key=lambda f: (f.path, f.line, f.col, f.rule))

    _LINT_FINDINGS.inc(len(report.findings))
    _LINT_CACHE_HITS.inc(report.cache_hits)
    if use_cache:
        # Merge, never replace wholesale: a single-file lint must not
        # evict the rest of the tree's entries. Vanished files linger
        # harmlessly (their stat key can never match again).
        files = dict(cache["files"])
        files.update(new_entries)
        doc = {"version": CACHE_VERSION, **keys, "files": files}
        try:
            cache_path.write_text(json.dumps(doc))
        except OSError:
            pass  # read-only checkout: cache is best-effort
    return report


def lint_sources(sources: Dict[str, str],
                 ctx: Optional[ProjectContext] = None,
                 rule_ids: Optional[Set[str]] = None) -> List[Finding]:
    """Lint a {relpath: source} set as one small tree (the CROSS-MODULE
    test seam the interprocedural rules need): returns UNSUPPRESSED
    findings, using a synthetic context unless one is given. Relpaths
    become module identities — ``pkg/mod_a.py`` is importable from a
    sibling fixture as ``from pkg.mod_a import f``."""
    ctx = ctx or ProjectContext(root=Path("."))
    mods: List[Module] = []
    for relpath, source in sources.items():
        suppressions, justified = _parse_suppressions(source)
        mods.append(Module(path=Path(relpath), relpath=relpath,
                           source=source, tree=ast.parse(source),
                           suppressions=suppressions,
                           justified=justified))
    # The test seam acts as a full-project run: orphan rules see the
    # registries as in-view so fixtures can exercise both directions.
    ctx.scanned = ({m.relpath for m in mods}
                   | {ctx.fault_sites_path, ctx.metric_catalog_path}
                   | ctx.scanned)
    active = all_rules()
    if rule_ids:
        active = [r for r in active if r.provided_ids() & rule_ids]
    by_rel = {m.relpath: m for m in mods}
    out: List[Finding] = []
    for rule in active:
        for mod in mods:
            for finding in rule.scan(mod, ctx):
                if not mod.suppressed(finding.rule, finding.line):
                    out.append(finding)
        for finding in rule.finalize(ctx):
            mod = by_rel.get(finding.path)
            if mod is None or not mod.suppressed(finding.rule,
                                                 finding.line):
                out.append(finding)
    if rule_ids:
        out = [f for f in out if f.rule in rule_ids]
    out.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return out


def lint_source(source: str, relpath: str = "fixture.py",
                ctx: Optional[ProjectContext] = None,
                rule_ids: Optional[Set[str]] = None) -> List[Finding]:
    """Single-module lint seam (the original fixture entry point)."""
    return lint_sources({relpath: source}, ctx=ctx, rule_ids=rule_ids)


def render(report: Report, as_json: bool = False,
           show_suppressed: bool = False) -> str:
    if as_json:
        return json.dumps(report.to_dict(), indent=2)
    lines = [f.format() for f in report.findings]
    if show_suppressed:
        lines += [f"{f.format()} (suppressed)" for f in report.suppressed]
    lines.append(f"dralint: {report.files} files, "
                 f"{len(report.findings)} findings, "
                 f"{len(report.suppressed)} suppressed")
    return "\n".join(lines)
