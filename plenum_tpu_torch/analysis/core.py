"""plenum-lint core — findings, rule protocol, pragmas, the driver.

The analyzer is pure stdlib-`ast`: it never imports the modules it
checks, so it can run under any interpreter state (no torch import, no
CUDA context, no native build) and is safe as a tier-1 gate. Each rule
encodes one bug class the system has shipped and fixed by hand (see
docs/static_analysis.md for the catalog and the incident behind every
rule; the README's port section says how each rule reads torch code).

Suppression layers, weakest to strongest:

* inline pragma  — ``# plenum-lint: disable=PT006`` on the finding's
  line (or ``disable=all``); a pragma comment alone on one of the first
  five lines of a file disables the codes for the whole file.
* baseline      — ``plenum_tpu_torch/lint_baseline.json`` grandfathers
  known findings by (rule, path, symbol, message) so the gate only
  fails on NEW findings (see baseline.py).
* rule disable  — ``--disable PT005`` / per-rule severity overrides at
  the CLI / Analyzer level.
"""
from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Set

SEVERITIES = ("error", "warning")

# the package the analyzer checks: finding paths, rule scopes and the
# engine's program scope all live under it
PACKAGE = "plenum_tpu_torch"

PRAGMA_RE = re.compile(
    r"#\s*plenum-lint:\s*disable=([A-Za-z0-9_, ]+|all)")
# pragma-only lines near the top of a file disable codes file-wide
FILE_PRAGMA_HEAD_LINES = 5


def iter_pragmas(lines):
    """Yield ``(lineno, codes, file_wide)`` for every pragma comment —
    the ONE implementation of the pragma syntax, shared by the
    per-module rules (ModuleContext) and the whole-program engine
    (engine/symtab.py), so both suppression layers can never drift."""
    for i, line in enumerate(lines, start=1):
        m = PRAGMA_RE.search(line)
        if not m:
            continue
        codes = {c.strip().upper() for c in m.group(1).split(",")
                 if c.strip()}
        file_wide = (i <= FILE_PRAGMA_HEAD_LINES
                     and line.strip().startswith("#"))
        yield i, codes, file_wide


@dataclass(frozen=True)
class Finding:
    rule: str        # "PT001"
    severity: str    # "error" | "warning"
    path: str        # repo-relative posix path
    line: int
    col: int
    message: str     # line-number-free (stable across drift)
    symbol: str      # dotted enclosing scope, e.g. "VerifyDaemon._batcher"

    def location(self) -> str:
        return "%s:%d:%d" % (self.path, self.line, self.col)

    def render(self) -> str:
        loc = " [%s]" % self.symbol if self.symbol else ""
        return "%s: %s %s: %s%s" % (self.location(), self.rule,
                                    self.severity, self.message, loc)


def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain; None for anything dynamic
    (subscripts, call results) — rules treat dynamic receivers as
    unmatchable rather than guessing."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def attr_parts(node: ast.AST) -> List[str]:
    """Every attribute/name component of a chain (dynamic roots allowed:
    ``self._engine[0].x`` still yields ["x"])."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return parts


def walk_skipping_nested_defs(node: ast.AST) -> Iterable[ast.AST]:
    """Walk a function body without descending into nested function /
    class definitions (which get their own analysis context)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
            stack.extend(ast.iter_child_nodes(n))


class ModuleContext:
    """One parsed file handed to every rule: tree + source lines +
    pragma map + enclosing-symbol resolution."""

    def __init__(self, rel_path: str, source: str, tree: ast.Module):
        self.rel_path = rel_path
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self.line_pragmas: Dict[int, Set[str]] = {}
        self.file_pragmas: Set[str] = set()
        self._scan_pragmas()
        self._parents: Dict[int, ast.AST] = {}
        for parent in ast.walk(tree):
            for child in ast.iter_child_nodes(parent):
                self._parents[id(child)] = parent

    # ------------------------------------------------------------ pragmas

    def _scan_pragmas(self) -> None:
        for i, codes, file_wide in iter_pragmas(self.lines):
            self.line_pragmas.setdefault(i, set()).update(codes)
            if file_wide:
                self.file_pragmas.update(codes)

    def suppressed(self, code: str, line: int) -> bool:
        for codes in (self.file_pragmas, self.line_pragmas.get(line, ())):
            if "ALL" in codes or code.upper() in codes:
                return True
        return False

    # ------------------------------------------------------------ symbols

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self._parents.get(id(node))

    def symbol_for(self, node: ast.AST) -> str:
        """Dotted class/function scope enclosing `node` ("" at module
        level) — the stable coordinate baselines key on."""
        names: List[str] = []
        cur: Optional[ast.AST] = node
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                names.append(cur.name)
            cur = self.parent(cur)
        return ".".join(reversed(names))

    def finding(self, rule: "Rule", node: ast.AST, message: str,
                symbol: str = None) -> Finding:
        return Finding(
            rule=rule.code, severity=rule.severity, path=self.rel_path,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0),
            message=message,
            symbol=self.symbol_for(node) if symbol is None else symbol)


class Rule:
    """One named check. Subclasses set `code`/`name`/`severity` and
    implement check(ctx); `applies` gives cheap path scoping so rules
    only parse-walk the layers their bug class lives in."""

    code = "PT000"
    name = "abstract"
    severity = "error"
    # code of a ProgramRule that supersedes this one: when that rule is
    # active AND the engine builds, this rule is held out of the run (it
    # becomes the engine-unavailable fallback). None = always runs.
    subsumed_by: Optional[str] = None

    def applies(self, rel_path: str) -> bool:
        return True

    def check(self, ctx: ModuleContext) -> List[Finding]:  # pragma: no cover
        raise NotImplementedError


class ProgramRule(Rule):
    """Whole-program rule: sees the inter-procedural engine (symbol
    table, call graph, bottom-up summaries) instead of one module at a
    time. ``check_program`` runs ONCE per analysis over the full
    program scope; findings are filtered to the scanned files by the
    driver, so ``--changed`` stays meaningful while resolution is
    always whole-tree."""

    def check(self, ctx: ModuleContext) -> List[Finding]:
        return []

    def check_program(self, engine,
                      rel_paths) -> List[Finding]:  # pragma: no cover
        raise NotImplementedError


class ParseErrorRule(Rule):
    """Synthetic rule code for unparseable files — a syntax error in the
    scanned tree must fail the gate, not be skipped silently."""
    code = "PT000"
    name = "parse-error"


_PARSE_ERROR = ParseErrorRule()


class Analyzer:
    def __init__(self, rules: Sequence[Rule], root: str,
                 use_engine_cache: bool = True):
        """root: repository root; finding paths are relative to it."""
        self.rules = [r for r in rules
                      if not isinstance(r, ProgramRule)]
        self.program_rules = [r for r in rules
                              if isinstance(r, ProgramRule)]
        # subsumed heuristics: held out while their superseding
        # ProgramRule is active — they re-enter the per-module pass
        # only when the engine fails to build (the fallback path)
        program_codes = {r.code for r in self.program_rules}
        self.held_rules = [r for r in self.rules
                           if r.subsumed_by in program_codes]
        self.rules = [r for r in self.rules
                      if r not in self.held_rules]
        self.root = os.path.abspath(root)
        self.use_engine_cache = use_engine_cache
        self.engine = None  # built lazily by run_files
        self.engine_error: Optional[str] = None

    # --------------------------------------------------------- file walk

    def collect_files(self, paths: Sequence[str]) -> List[str]:
        out: List[str] = []
        for p in paths:
            p = os.path.abspath(p)
            if os.path.isfile(p):
                if p.endswith(".py"):
                    out.append(p)
                continue
            for base, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d != "__pycache__"
                                 and not d.startswith("."))
                for f in sorted(files):
                    if f.endswith(".py"):
                        out.append(os.path.join(base, f))
        # stable order, no duplicates
        seen, uniq = set(), []
        for f in out:
            if f not in seen:
                seen.add(f)
                uniq.append(f)
        return uniq

    def _rel(self, path: str) -> str:
        rel = os.path.relpath(os.path.abspath(path), self.root)
        return rel.replace(os.sep, "/")

    # ----------------------------------------------------------- analyze

    def run_files(self, files: Sequence[str]) -> List[Finding]:
        findings: List[Finding] = []
        module_rules = list(self.rules)
        if self.program_rules:
            try:
                findings.extend(self._run_program_rules(files))
            except Exception as exc:
                # engine unavailable: the subsumed heuristics are the
                # fallback — coverage degrades to per-module precision
                # instead of disappearing
                self.engine_error = "%s: %s" % (
                    type(exc).__name__, exc)
                module_rules = module_rules + self.held_rules
        for path in files:
            findings.extend(self.run_one(path, module_rules))
        findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
        return findings

    def _program_scope(self, files: Sequence[str]) -> List[str]:
        """The file set the engine resolves over: the whole package
        tree when it exists (inter-procedural rules must see callees
        outside a --changed diff), else just the scanned files (fixture
        trees)."""
        pkg = os.path.join(self.root, PACKAGE)
        scope = list(files)
        if os.path.isdir(pkg):
            known = set(scope)
            scope.extend(p for p in self.collect_files([pkg])
                         if p not in known)
        return scope

    def _run_program_rules(self, files: Sequence[str]
                           ) -> List[Finding]:
        from plenum_tpu_torch.analysis.engine import Engine
        if self.engine is None:
            self.engine = Engine.build(
                self._program_scope(files), self.root,
                use_cache=self.use_engine_cache)
        scanned = {self._rel(p) for p in files}
        out: List[Finding] = []
        for rule in self.program_rules:
            for f in rule.check_program(self.engine, scanned):
                if f.path in scanned and rule.applies(f.path) \
                        and not self.engine.suppressed(
                            f.path, f.rule, f.line):
                    out.append(f)
        return out

    def run_one(self, path: str,
                rules: Optional[Sequence[Rule]] = None) -> List[Finding]:
        rel = self._rel(path)
        try:
            with open(path, "r", encoding="utf-8") as f:
                source = f.read()
            tree = ast.parse(source, filename=path)
        except (SyntaxError, ValueError, OSError) as exc:
            return [Finding(
                rule=_PARSE_ERROR.code, severity="error", path=rel,
                line=getattr(exc, "lineno", None) or 1, col=0,
                message="cannot parse file: %s" % exc, symbol="")]
        ctx = ModuleContext(rel, source, tree)
        out: List[Finding] = []
        for rule in (self.rules if rules is None else rules):
            if not rule.applies(rel):
                continue
            for finding in rule.check(ctx):
                if not ctx.suppressed(finding.rule, finding.line):
                    out.append(finding)
        return out

    def run_paths(self, paths: Sequence[str]) -> List[Finding]:
        return self.run_files(self.collect_files(paths))
