"""plenum-lint whole-program engine — symtab, callgraph, summaries.

PT001–PT011 are per-function AST rules: each looks at one module in
isolation. The bug classes of PT012 (lane planning must be a pure
function of the ordered batch), PT013 (every ``*_dispatch`` half must
be collected) and PT014 (every compiled launch must route through a
bounded bucket shape) are *inter-procedural*: the property lives in how
functions compose across files, which no single-module walk can see.

This package gives rules a whole-program view in three layers, each
built on the one below:

* **symtab** (`symtab.py`) — per-file fact extraction: every function
  and class in the project indexed by module-qualified name, with
  decorator records, import maps, call sites (and how each call's
  result flows: returned / named / escaped / discarded), plus the raw
  rule facts (nondeterminism sources, dispatch/collect effects, device
  launch sites, bucket-routing evidence). Facts are plain JSON-able
  dicts — deliberately AST-free — so they cache per file.
* **callgraph** (`callgraph.py`) — whole-program linking: call sites
  resolved to project symbols (module functions through import maps,
  ``self.method`` through base-class resolution, unique-name fallback
  for attribute calls), Tarjan SCC condensation so cyclic call
  clusters get one fixpoint, and a bottom-up order for summaries.
* **summaries** (`summaries.py`) — per-function summaries computed
  bottom-up over the condensation: nondeterminism taint, open
  dispatch generations handed to callers, bucket-routing evidence.

`cache.py` persists the extraction layer keyed by file content hash
(``.plenum_lint_torch_cache.json`` at the repo root): linking and summaries
are cheap enough to recompute every run, so a warm run re-parses only
files whose bytes changed and the tier-1 gate stays fast.

Entry point::

    from plenum_tpu_torch.analysis.engine import Engine
    eng = Engine.build(files, root=repo_root)   # cached per content hash
    eng.summaries["plenum_tpu_torch.ops.sha256:pad_messages"]
    eng.callees(sym), eng.callers(sym)
"""
from __future__ import annotations

from plenum_tpu_torch.analysis.engine.callgraph import CallGraph
from plenum_tpu_torch.analysis.engine.engine import Engine
from plenum_tpu_torch.analysis.engine.symtab import extract_file_facts
from plenum_tpu_torch.analysis.engine.summaries import FunctionSummary

__all__ = ["CallGraph", "Engine", "FunctionSummary",
           "extract_file_facts"]
