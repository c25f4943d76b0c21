"""Engine facade — build facts (cached), link, summarize, query.

``Engine.build(files, root)`` is what the Analyzer and the CLI call:
it reads every file once, reuses cached facts for unchanged content,
links the call graph and computes summaries. ``stats`` records how
much work the cache saved (the repeat-run speedup test pins this).
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence, Set

from plenum_tpu_torch.analysis.engine.cache import FactsCache, content_hash
from plenum_tpu_torch.analysis.engine.callgraph import CallGraph
from plenum_tpu_torch.analysis.engine.summaries import (
    FunctionSummary, compute_regions, compute_summaries)
from plenum_tpu_torch.analysis.engine.symtab import extract_file_facts


class Engine:
    def __init__(self, files: Dict[str, dict], root: str,
                 parse_errors: Dict[str, str], stats: dict):
        self.files = files              # rel_path -> facts
        self.root = root
        self.parse_errors = parse_errors
        self.stats = stats
        self.graph = CallGraph(files)
        self.summaries: Dict[str, FunctionSummary] = \
            compute_summaries(self.graph)
        # executing-region sets (prod/worker/daemon) per symbol, and
        # mirrored onto the summaries for --callgraph triage
        self.regions: Dict[str, Set[str]] = compute_regions(self.graph)
        for sym, regs in self.regions.items():
            s = self.summaries.get(sym)
            if s is not None:
                s.regions = regs

    # ------------------------------------------------------------ build

    @classmethod
    def build(cls, paths: Sequence[str], root: str,
              cache: Optional[FactsCache] = None,
              use_cache: bool = True) -> "Engine":
        """paths: absolute .py files forming the program scope."""
        root = os.path.abspath(root)
        if cache is None and use_cache:
            cache = FactsCache.for_root(root)
        t0 = time.perf_counter()
        files: Dict[str, dict] = {}
        parse_errors: Dict[str, str] = {}
        parsed = cached = 0
        for path in paths:
            rel = os.path.relpath(os.path.abspath(path), root) \
                .replace(os.sep, "/")
            try:
                with open(path, "rb") as f:
                    data = f.read()
            except OSError as e:
                parse_errors[rel] = str(e)
                continue
            sha = content_hash(data)
            facts = cache.get(rel, sha) if cache else None
            if facts is None:
                try:
                    facts = extract_file_facts(
                        rel, data.decode("utf-8", errors="replace"))
                except (SyntaxError, ValueError) as e:
                    parse_errors[rel] = str(e)
                    continue
                parsed += 1
                if cache:
                    cache.put(rel, sha, facts)
            else:
                cached += 1
            files[rel] = facts
        if cache:
            cache.prune(list(files) + list(parse_errors))
            cache.save()
        stats = {"files": len(files), "parsed": parsed,
                 "cached": cached, "build_s": 0.0}
        eng = cls(files, root, parse_errors, stats)
        # whole build including linking + summaries: the cache-speedup
        # gate compares THIS cold vs warm, not just extraction
        stats["build_s"] = time.perf_counter() - t0
        return eng

    # ------------------------------------------------------------ query

    def suppressed(self, rel_path: str, code: str, line: int) -> bool:
        facts = self.files.get(rel_path)
        if not facts:
            return False
        pragmas = facts.get("pragmas", {})
        code = code.upper()
        head = pragmas.get("file", ())
        if "ALL" in head or code in head:
            return True
        at = pragmas.get("lines", {}).get(str(line), ())
        return "ALL" in at or code in at

    def symbol_display(self, sym: str) -> str:
        return self.graph.display(sym)

    def function(self, sym: str) -> Optional[dict]:
        return self.graph.functions.get(sym)

    def path_of(self, sym: str) -> str:
        return self.graph.fn_path[sym]

    def roots_matching(self, specs) -> List[str]:
        """Symbols matching (rel_path, compiled-regex-on-qname) specs."""
        out: List[str] = []
        for sym, fn in self.graph.functions.items():
            path = self.graph.fn_path[sym]
            for spec_path, rx in specs:
                if path == spec_path and rx.search(fn["qname"]):
                    out.append(sym)
                    break
        return out

    def reachable(self, roots: Sequence[str]) -> Set[str]:
        return self.graph.reachable_from(roots)
