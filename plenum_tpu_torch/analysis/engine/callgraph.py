"""Whole-program call graph over extracted file facts.

Symbols are keyed ``module:qname``
(``plenum_tpu_torch.ops.sha256:pad_messages``,
``plenum_tpu_torch.state.pruning_state:PruningState.flush``).
Resolution, in decreasing confidence:

* plain name ``f()`` — a function defined in the same module, else a
  ``from m import f`` target when ``m`` is a project module;
* ``alias.f()`` — ``import m as alias`` → ``m:f`` when ``m`` is a
  project module (or ``m:Class.f`` is NOT attempted: two-element
  chains only resolve module functions);
* ``self.m()`` / ``cls.m()`` — method lookup through the enclosing
  class and its project base classes (linearized depth-first, cycle
  guarded — the decorator/method-resolution tests pin this);
* any other attribute call ``obj.m()`` — linked iff exactly ONE
  project symbol has terminal name ``m`` (the unique-name fallback:
  over-linking common verbs like ``get``/``send`` would flood the
  taint rules, so ambiguous names stay unresolved).

Cycles are first-class: ``sccs()`` returns Tarjan's strongly-connected
components in reverse topological (callee-first) order, which is the
bottom-up schedule `summaries.py` computes over — every function in a
cycle shares one fixpoint.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Set, Tuple


class CallGraph:
    def __init__(self, files: Dict[str, dict]):
        """files: rel_path -> file facts (symtab.extract_file_facts)."""
        self.files = files
        # symbol -> function facts;  symbol = "module:qname"
        self.functions: Dict[str, dict] = {}
        self.fn_path: Dict[str, str] = {}
        # module -> {plain name -> symbol} for module-level functions
        self._module_funcs: Dict[str, Dict[str, str]] = {}
        # module -> file facts (import maps for base-class resolution)
        self._module_facts: Dict[str, dict] = {}
        # (module, class qname) -> class record
        self._classes: Dict[Tuple[str, str], dict] = {}
        # terminal name -> [symbols] (unique-name fallback)
        self._by_name: Dict[str, List[str]] = {}
        # jitted callables: symbols + (module, name) assignment targets
        self.jit_symbols: Set[str] = set()
        self._jit_assigned: Set[Tuple[str, str]] = set()
        self._index()
        self.edges: Dict[str, List[Tuple[str, dict]]] = {}
        self.redges: Dict[str, List[str]] = {}
        self._link()

    # ------------------------------------------------------------ index

    def _index(self) -> None:
        for path, facts in self.files.items():
            mod = facts["module"]
            self._module_facts.setdefault(mod, facts)
            mfuncs = self._module_funcs.setdefault(mod, {})
            for cname, crec in facts.get("classes", {}).items():
                self._classes[(mod, cname)] = crec
            for f in facts["functions"]:
                sym = "%s:%s" % (mod, f["qname"])
                self.functions[sym] = f
                self.fn_path[sym] = path
                if "." not in f["qname"]:
                    mfuncs[f["qname"]] = sym
                self._by_name.setdefault(f["name"], []).append(sym)
                if f.get("jitted"):
                    self.jit_symbols.add(sym)
            for jn in facts.get("jit_names", ()):
                self._jit_assigned.add((mod, jn))

    def display(self, sym: str) -> str:
        return sym.replace(":", ".", 1)

    def find_symbol(self, needle: str) -> List[str]:
        """Symbols whose display name ends with `needle` (CLI lookup)."""
        needle = needle.strip()
        out = [s for s in self.functions
               if self.display(s) == needle or s == needle]
        if out:
            return out
        return sorted(s for s in self.functions
                      if self.display(s).endswith("." + needle)
                      or self.functions[s]["qname"] == needle
                      or self.functions[s]["name"] == needle)

    # -------------------------------------------------------- resolution

    def _resolve_base(self, mod: str, base: str):
        """(module, class qname) of a base-class reference, or None."""
        facts = self._module_facts.get(mod)
        if facts is None:
            return None
        if "." in base:
            root, rest = base.split(".", 1)
            target_mod = facts["imports"].get(root)
            if target_mod and (target_mod, rest) in self._classes:
                return (target_mod, rest)
            return None
        if (mod, base) in self._classes:
            return (mod, base)
        fi = facts["from_imports"].get(base)
        if fi and (fi[0], fi[1]) in self._classes:
            return (fi[0], fi[1])
        return None

    def resolve_method(self, mod: str, cls: str,
                       name: str) -> Optional[str]:
        """Walk cls and its project bases depth-first for `name`."""
        seen: Set[Tuple[str, str]] = set()
        stack = [(mod, cls)]
        while stack:
            m, c = stack.pop(0)
            if (m, c) in seen:
                continue
            seen.add((m, c))
            rec = self._classes.get((m, c))
            if rec is None:
                continue
            if name in rec["methods"]:
                sym = "%s:%s.%s" % (m, c, name)
                if sym in self.functions:
                    return sym
            for base in rec["bases"]:
                resolved = self._resolve_base(m, base)
                if resolved:
                    stack.append(resolved)
        return None

    def resolve_call(self, caller_sym: str, chain: List[str],
                     fallback: bool = True) -> Optional[str]:
        facts = self.files[self.fn_path[caller_sym]]
        mod = facts["module"]
        fn = self.functions[caller_sym]
        if not chain:
            return None
        if len(chain) == 1:
            name = chain[0]
            local = self._module_funcs.get(mod, {}).get(name)
            if local:
                return local
            fi = facts["from_imports"].get(name)
            if fi:
                target = self._module_funcs.get(fi[0], {}).get(fi[1])
                if target:
                    return target
            return None
        if chain[0] in ("self", "cls") and fn.get("cls") \
                and len(chain) == 2:
            hit = self.resolve_method(mod, fn["cls"], chain[1])
            if hit:
                return hit
        if len(chain) == 2:
            target_mod = facts["imports"].get(chain[0])
            if target_mod:
                hit = self._module_funcs.get(target_mod, {}) \
                    .get(chain[1])
                if hit:
                    return hit
            fi = facts["from_imports"].get(chain[0])
            if fi:
                # `from pkg import mod` then mod.f()
                sub = "%s.%s" % (fi[0], fi[1])
                hit = self._module_funcs.get(sub, {}).get(chain[1])
                if hit:
                    return hit
        # unique-name fallback for attribute calls on unknown receivers
        if not fallback:
            return None
        term = chain[-1]
        cands = self._by_name.get(term, [])
        if len(cands) == 1:
            return cands[0]
        return None

    def is_jit_callee(self, caller_sym: str, chain: List[str]) -> bool:
        """Does this call site invoke a compiled callable
        (``torch.compile`` / ``torch.jit.trace`` / a graphed callable)?"""
        resolved = self.resolve_call(caller_sym, chain)
        if resolved is not None and resolved in self.jit_symbols:
            return True
        facts = self.files[self.fn_path[caller_sym]]
        mod = facts["module"]
        if len(chain) == 1:
            if (mod, chain[0]) in self._jit_assigned:
                return True
            fi = facts["from_imports"].get(chain[0])
            if fi and (fi[0], fi[1]) in self._jit_assigned:
                return True
        if len(chain) == 2:
            target_mod = facts["imports"].get(chain[0])
            if target_mod and (target_mod, chain[1]) \
                    in self._jit_assigned:
                return True
        return False

    # ----------------------------------------------------------- linking

    def _link(self) -> None:
        for sym, fn in self.functions.items():
            out: List[Tuple[str, dict]] = []
            for call in fn["calls"]:
                callee = self.resolve_call(sym, call["chain"])
                if callee is not None and callee != sym:
                    out.append((callee, call))
                    self.redges.setdefault(callee, []).append(sym)
            self.edges[sym] = out

    def callees(self, sym: str) -> List[str]:
        seen, out = set(), []
        for callee, _ in self.edges.get(sym, ()):
            if callee not in seen:
                seen.add(callee)
                out.append(callee)
        return out

    def callers(self, sym: str) -> List[str]:
        seen, out = set(), []
        for caller in self.redges.get(sym, ()):
            if caller not in seen:
                seen.add(caller)
                out.append(caller)
        return out

    def reachable_from(self, roots: Iterable[str]) -> Set[str]:
        """Forward closure over call edges (cycle-safe)."""
        seen: Set[str] = set()
        stack = [r for r in roots if r in self.functions]
        while stack:
            sym = stack.pop()
            if sym in seen:
                continue
            seen.add(sym)
            stack.extend(c for c in self.callees(sym) if c not in seen)
        return seen

    # -------------------------------------------------------------- SCC

    def sccs(self) -> List[List[str]]:
        """Tarjan strongly-connected components, callee-first (reverse
        topological) — the bottom-up summary schedule. Iterative: the
        project graph is deep enough to blow the recursion limit."""
        index: Dict[str, int] = {}
        low: Dict[str, int] = {}
        on_stack: Set[str] = set()
        stack: List[str] = []
        out: List[List[str]] = []
        counter = [0]

        for start in self.functions:
            if start in index:
                continue
            work: List[Tuple[str, int]] = [(start, 0)]
            while work:
                node, ei = work[-1]
                if ei == 0:
                    index[node] = low[node] = counter[0]
                    counter[0] += 1
                    stack.append(node)
                    on_stack.add(node)
                advanced = False
                callees = self.callees(node)
                while ei < len(callees):
                    nxt = callees[ei]
                    ei += 1
                    if nxt not in index:
                        work[-1] = (node, ei)
                        work.append((nxt, 0))
                        advanced = True
                        break
                    if nxt in on_stack:
                        low[node] = min(low[node], index[nxt])
                if advanced:
                    continue
                work[-1] = (node, ei)
                if ei >= len(callees):
                    work.pop()
                    if work:
                        parent = work[-1][0]
                        low[parent] = min(low[parent], low[node])
                    if low[node] == index[node]:
                        comp = []
                        while True:
                            w = stack.pop()
                            on_stack.discard(w)
                            comp.append(w)
                            if w == node:
                                break
                        out.append(comp)
        return out
