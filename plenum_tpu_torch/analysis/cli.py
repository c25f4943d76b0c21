"""plenum-lint CLI for the port — text/JSON/SARIF reporting, --changed
mode, baselines.

    python -m plenum_tpu_torch.analysis plenum_tpu_torch/     # vs baseline
    python -m plenum_tpu_torch.analysis --changed      # git-diff files only
    python -m plenum_tpu_torch.analysis --json plenum_tpu_torch/ops/
    python -m plenum_tpu_torch.analysis --write-baseline  # re-grandfather

The default baseline is ``plenum_tpu_torch/lint_baseline.json``.

Exit codes: 0 clean (or warnings only), 1 non-baselined error findings,
2 usage errors. ``--changed`` with an empty diff prints a clean message
and exits 0 (the scripts/metrics_stats empty-store convention).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import Dict, List

from plenum_tpu_torch.analysis import default_baseline, repo_root
from plenum_tpu_torch.analysis.baseline import Baseline
from plenum_tpu_torch.analysis.core import PACKAGE, Analyzer, Finding
from plenum_tpu_torch.analysis.rules import RULE_CLASSES, build_rules

JSON_SCHEMA_VERSION = 1


def changed_py_files(root: str) -> List[str]:
    """Tracked-modified + untracked .py files, repo-relative. A failing
    git (not a repo, binary missing, hang) raises RuntimeError — the
    pre-commit gate must fail CLOSED, not read as an empty diff.

    Renames are followed: ``--name-status -M`` reports ``R<score>\\t
    old\\tnew`` and the NEW path joins the scan set (a plain
    ``--name-only``/``--diff-filter`` diff dropped renamed files, so a
    renamed file with findings exited clean)."""
    def run_git(*args: str) -> str:
        try:
            res = subprocess.run(["git", *args], cwd=root,
                                 capture_output=True, text=True,
                                 timeout=30)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError("cannot run git for --changed: %s" % e)
        if res.returncode != 0:
            raise RuntimeError(
                "git failed for --changed (git %s): %s" % (
                    " ".join(args),
                    res.stderr.strip() or res.returncode))
        return res.stdout

    out: List[str] = []
    for line in run_git("diff", "--name-status", "-M", "HEAD",
                        "--").splitlines():
        parts = line.rstrip("\n").split("\t")
        if len(parts) < 2 or not parts[0]:
            continue
        status = parts[0][0]
        if status == "D":
            continue
        # renames/copies list "R<score>\told\tnew" — scan the NEW path
        out.append(parts[2] if status in ("R", "C") and len(parts) > 2
                   else parts[1])
    out.extend(line.strip() for line in
               run_git("ls-files", "--others",
                       "--exclude-standard").splitlines()
               if line.strip())
    seen, files = set(), []
    for rel in out:
        if rel.endswith(".py") and rel not in seen:
            seen.add(rel)
            path = os.path.join(root, rel)
            if os.path.isfile(path):
                files.append(path)
    return files


def _parse_severities(specs: List[str]) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for spec in specs:
        for item in spec.split(","):
            item = item.strip()
            if not item:
                continue
            code, _, sev = item.partition("=")
            if not sev:
                raise ValueError(
                    "--severity takes CODE=LEVEL, got %r" % item)
            out[code.strip().upper()] = sev.strip().lower()
    return out


def _to_json(findings: List[Finding], baselined: set,
             files_scanned: int) -> dict:
    items = []
    for f in findings:
        items.append({
            "rule": f.rule, "severity": f.severity, "path": f.path,
            "line": f.line, "col": f.col, "message": f.message,
            "symbol": f.symbol, "baselined": f in baselined})
    new = [f for f in findings if f not in baselined]
    return {
        "version": JSON_SCHEMA_VERSION,
        "tool": "plenum-lint",
        "findings": items,
        "summary": {
            "files": files_scanned,
            "findings": len(findings),
            "new": len(new),
            "baselined": len(findings) - len(new),
            "errors": sum(1 for f in new if f.severity == "error"),
            "warnings": sum(1 for f in new if f.severity == "warning"),
        },
    }


def _callgraph_mode(root: str, needle: str) -> int:
    """Resolve one symbol in the whole-program engine and print its
    summary, direct callees and callers — the triage companion for
    PT012–PT014 findings (which report at the SOURCE site; this walks
    the reach)."""
    from plenum_tpu_torch.analysis.engine import Engine
    pkg = os.path.join(root, PACKAGE)
    if not os.path.isdir(pkg):
        print("plenum_lint: no %s/ package under %s" % (PACKAGE, root),
              file=sys.stderr)
        return 2
    files = Analyzer([], root).collect_files([pkg])
    eng = Engine.build(files, root)
    matches = eng.graph.find_symbol(needle)
    if not matches:
        print("plenum_lint: no symbol matches %r" % needle,
              file=sys.stderr)
        return 2
    for sym in matches[:10]:
        fn = eng.function(sym)
        s = eng.summaries.get(sym)
        print("%s  (%s:%d)" % (eng.symbol_display(sym),
                               eng.path_of(sym), fn["line"]))
        if s is not None:
            print("  summary: pure=%s nondet=%s returns_open=%s "
                  "closes=%s buckets=%s" % (
                      s.pure, sorted(s.nondet) or "-",
                      sorted(s.returns_open) or "-",
                      sorted(s.closes) or "-", s.routes_bucket))
        callees = eng.graph.callees(sym)
        callers = eng.graph.callers(sym)
        print("  callees (%d):" % len(callees))
        for c in callees:
            print("    -> %s" % eng.symbol_display(c))
        print("  callers (%d):" % len(callers))
        for c in callers:
            print("    <- %s" % eng.symbol_display(c))
        print()
    if len(matches) > 10:
        print("plenum_lint: %d more matches not shown"
              % (len(matches) - 10))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m plenum_tpu_torch.analysis", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: %s/)" % PACKAGE)
    ap.add_argument("--changed", action="store_true",
                    help="lint only .py files in the git diff "
                         "(tracked-modified + untracked)")
    ap.add_argument("--json", action="store_true", dest="as_json")
    ap.add_argument("--sarif", action="store_true", dest="as_sarif",
                    help="emit SARIF 2.1.0 (CI/code-review ingestion; "
                         "baselined findings carry baselineState="
                         "unchanged)")
    ap.add_argument("--callgraph", default=None, metavar="SYMBOL",
                    help="debugging mode: resolve SYMBOL (qualified "
                         "or bare name) in the whole-program engine "
                         "and print its summary, callees and callers")
    ap.add_argument("--root", default=None,
                    help="repo root (default: autodetected from the "
                         "package location)")
    ap.add_argument("--baseline", default=None,
                    help="baseline file (default: <root>/%s/"
                         "lint_baseline.json)" % PACKAGE)
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, grandfathered or not")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the baseline from the current "
                         "findings (justifications default to TODO)")
    ap.add_argument("--disable", default="",
                    help="comma-separated rule codes to skip")
    ap.add_argument("--select", default="",
                    help="comma-separated rule codes to run exclusively")
    ap.add_argument("--severity", action="append", default=[],
                    metavar="CODE=LEVEL",
                    help="override a rule's severity (error|warning); "
                         "warnings never affect the exit code")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for cls in RULE_CLASSES:
            print("%s %-32s %s" % (cls.code, cls.name, cls.severity))
        return 0

    root = os.path.abspath(args.root) if args.root else repo_root()

    if args.callgraph:
        return _callgraph_mode(root, args.callgraph)

    try:
        severities = _parse_severities(args.severity)
        rules = build_rules(
            disable=[c for c in args.disable.split(",") if c],
            select=[c for c in args.select.split(",") if c],
            severities=severities, root=root)
    except ValueError as e:
        print("plenum_lint: %s" % e, file=sys.stderr)
        return 2

    if args.changed:
        try:
            files = changed_py_files(root)
        except RuntimeError as e:
            print("plenum_lint: %s" % e, file=sys.stderr)
            return 2
        if args.paths:
            scopes = [os.path.abspath(p) for p in args.paths]
            files = [f for f in files
                     if any(os.path.abspath(f) == s
                            or os.path.abspath(f).startswith(s + os.sep)
                            for s in scopes)]
        if not files:
            print("plenum_lint: no changed Python files — nothing "
                  "to lint")
            return 0
    else:
        paths = args.paths or [os.path.join(root, PACKAGE)]
        missing = [p for p in paths if not os.path.exists(p)]
        if missing:
            # a typo'd path must not read as a permanently-clean lint
            print("plenum_lint: no such path(s): %s"
                  % ", ".join(missing), file=sys.stderr)
            return 2
        files = Analyzer(rules, root).collect_files(paths)

    analyzer = Analyzer(rules, root)
    findings = analyzer.run_files(files)

    baseline_path = args.baseline or default_baseline(root)
    if args.write_baseline:
        # merge, don't clobber: entries for files outside this run's
        # scope (or rules not run) were not re-checked — a scoped
        # rewrite must never delete their justifications
        scanned = {analyzer._rel(p) for p in files}
        active = {r.code for r in rules}
        kept = [e for e in Baseline.load(baseline_path).entries
                if e["path"] not in scanned or e["rule"] not in active]
        fresh = Baseline.from_findings(findings).entries
        Baseline(kept + fresh).save(baseline_path)
        print("plenum_lint: wrote %d baseline entr%s (+%d out-of-scope "
              "kept) to %s — fill in the justifications before "
              "committing" % (len(fresh),
                              "y" if len(fresh) == 1 else "ies",
                              len(kept), baseline_path))
        return 0

    baseline = (Baseline([]) if args.no_baseline
                else Baseline.load(baseline_path))
    new, old = baseline.match(findings)
    baselined = set(old)

    if args.as_sarif:
        from plenum_tpu_torch.analysis.sarif import to_sarif
        print(json.dumps(to_sarif(findings, baselined, rules),
                         indent=2))
    elif args.as_json:
        print(json.dumps(_to_json(findings, baselined, len(files)),
                         indent=2))
    else:
        for f in new:
            print(f.render())
        scanned = {analyzer._rel(p) for p in files}
        active = {r.code for r in rules}
        # an entry for a file outside this run's scope (or a rule not
        # run) is not stale — it just wasn't checked
        stale = [k for k in baseline.stale()
                 if k[1] in scanned and k[0] in active]
        if stale:
            print("plenum_lint: %d stale baseline entr%s (fixed code? "
                  "prune %s):" % (
                      len(stale), "y" if len(stale) == 1 else "ies",
                      os.path.relpath(baseline_path, root)))
            for rule, path, symbol, _ in stale:
                print("  %s %s [%s]" % (rule, path, symbol))
        print("plenum_lint: %d file(s), %d finding(s) — %d new, %d "
              "baselined" % (len(files), len(findings), len(new),
                             len(old)))
    return 1 if any(f.severity == "error" for f in new) else 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
