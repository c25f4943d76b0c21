"""PT004 cross-thread-shared-state.

Historical context: the verify daemon runs device launches on a
dedicated worker thread while its asyncio loop keeps coalescing, and
the flight recorder (observability/tracing.py) is written from both.
The sanctioned shapes are (a) hold a lock around every cross-thread
attribute write, or (b) the Tracer fixed-slot pattern — writes go into
preallocated ring slots (``self._buf[i] = rec``, a subscript store, not
an attribute rebind) under a tiny critical section.

Encoding, per class: find thread entry points — methods passed as
``threading.Thread(target=self.X)``, ``pool.submit(self.X, ...)`` or
``loop.run_in_executor(pool, self.X, ...)`` — and take their same-class
transitive call closure as the worker side. Any ``self.attr`` written
both by the worker side and by other methods (``__init__`` excluded:
construction happens before the thread exists), where either write is
outside a ``with <something lock-ish>`` block, is flagged. Subscript
stores (the fixed-slot pattern) are not attribute writes and pass.

Pipeline boundaries (runtime/pipeline.py) add two more shapes:

* **Queue-crossing values must be immutable** — bytes, numpy views,
  frozen job records. A ``put``/``put_nowait`` whose argument is a
  freshly built MUTABLE container (dict/list/set literal or
  comprehension) hands the other thread state the producer can still
  reach; flagged wherever it appears.
* **Consensus state is prod-thread-owned** — a worker-side unlocked
  write to a consensus-named attribute (prepares/commits/propagates/
  stashes/suspicions/view_no/last_ordered/ledger/state roots/request
  queues) is flagged even with NO loop-side co-writer: the pipeline
  ownership contract says workers parse, the prod thread counts, so
  the write itself is the defect, not just the race.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from plenum_tpu_torch.analysis.core import (
    Finding, ModuleContext, Rule, attr_parts, dotted)

LOCKISH = ("lock", "mutex", "cond", "sem")

# attribute-name fragments that mean "consensus state" at the pipeline
# boundary: prod-thread-owned, never worker-writable (the
# OrderingService/Propagator vocabulary)
CONSENSUS_ATTRS = ("prepare", "commit", "propagat", "stash", "suspic",
                   "view_no", "last_ordered", "ledger", "state_root",
                   "requestqueue", "request_queue")

# ast nodes that build a fresh MUTABLE container — the shapes that must
# not cross a thread queue (immutable bytes/views/frozen records do)
_MUTABLE_BUILDS = (ast.Dict, ast.List, ast.Set, ast.ListComp,
                   ast.SetComp, ast.DictComp)


def _consensus_attr(attr: str) -> bool:
    low = attr.lower()
    return any(frag in low for frag in CONSENSUS_ATTRS)


def _lockish_expr(expr: ast.AST) -> bool:
    for n in ast.walk(expr):
        name = n.attr if isinstance(n, ast.Attribute) else (
            n.id if isinstance(n, ast.Name) else None)
        if name and any(m in name.lower() for m in LOCKISH):
            return True
    return False


def _self_attr(node: ast.AST):
    if isinstance(node, ast.Attribute) \
            and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _entry_points(cls: ast.ClassDef) -> Set[str]:
    """Method names handed to another thread within this class."""
    out: Set[str] = set()

    def method_ref(node) -> str:
        attr = _self_attr(node)
        return attr if attr else None

    for node in ast.walk(cls):
        if not isinstance(node, ast.Call):
            continue
        name = dotted(node.func) or ""
        parts = attr_parts(node.func)
        if name.endswith("Thread") or (parts and parts[0] == "Thread"):
            for kw in node.keywords:
                if kw.arg == "target":
                    ref = method_ref(kw.value)
                    if ref:
                        out.add(ref)
        elif parts and parts[0] == "submit" and node.args:
            ref = method_ref(node.args[0])
            if ref:
                out.add(ref)
        elif parts and parts[0] == "run_in_executor" \
                and len(node.args) >= 2:
            ref = method_ref(node.args[1])
            if ref:
                out.add(ref)
    return out


class CrossThreadSharedStateRule(Rule):
    code = "PT004"
    name = "cross-thread-shared-state"
    # the engine-backed region analysis (PT016/PT017) supersedes this
    # same-class heuristic: whole-program spawn-target resolution sees
    # cross-class/cross-module worker reach this rule cannot. PT004
    # runs only as the fallback when the engine fails to build.
    subsumed_by = "PT016"

    def applies(self, rel_path: str) -> bool:
        return rel_path.startswith("plenum_tpu_torch/")

    def check(self, ctx: ModuleContext) -> List[Finding]:
        out: List[Finding] = []
        out.extend(self._check_queue_puts(ctx))
        for cls in ast.walk(ctx.tree):
            if isinstance(cls, ast.ClassDef):
                out.extend(self._check_class(ctx, cls))
        return out

    def _check_queue_puts(self, ctx: ModuleContext) -> List[Finding]:
        """Queue-crossing immutability: a put/put_nowait whose argument
        is a freshly built mutable container (dict/list/set literal or
        comprehension) hands the consuming thread state the producer
        can still reach. Queue payloads must be immutable — bytes,
        numpy views, frozen/slotted job records."""
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            parts = attr_parts(node.func)
            if not parts or parts[0] not in ("put", "put_nowait"):
                continue
            for arg in node.args:
                if isinstance(arg, _MUTABLE_BUILDS):
                    out.append(ctx.finding(
                        self, arg,
                        "a freshly built mutable %s crosses a thread "
                        "queue via %s() — queue payloads must be "
                        "immutable (bytes, numpy views, frozen "
                        "records): the consumer would share state the "
                        "producer can still mutate" % (
                            type(arg).__name__.lower(), parts[0]),
                        symbol=dotted(node.func) or parts[0]))
                    break
        return out

    def _check_class(self, ctx: ModuleContext,
                     cls: ast.ClassDef) -> List[Finding]:
        methods: Dict[str, ast.AST] = {
            m.name: m for m in cls.body
            if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))}
        entries = _entry_points(cls) & set(methods)
        if not entries:
            return []
        # worker side: entry points + same-class transitive callees
        worker: Set[str] = set()
        frontier = list(entries)
        while frontier:
            name = frontier.pop()
            if name in worker:
                continue
            worker.add(name)
            for node in ast.walk(methods[name]):
                if isinstance(node, ast.Call):
                    callee = _self_attr(node.func)
                    if callee in methods and callee not in worker:
                        frontier.append(callee)

        # writes: attr -> list of (method, node, locked)
        def writes(method) -> List[Tuple[str, ast.AST, bool]]:
            found: List[Tuple[str, ast.AST, bool]] = []

            def visit(node, locked):
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)) \
                        and node is not method:
                    return
                if isinstance(node, ast.With):
                    inner = locked or any(
                        _lockish_expr(item.context_expr)
                        for item in node.items)
                    for child in ast.iter_child_nodes(node):
                        visit(child, inner)
                    return
                targets = []
                if isinstance(node, ast.Assign):
                    targets = node.targets
                elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                    targets = [node.target]
                for tgt in targets:
                    attr = _self_attr(tgt)
                    if attr:
                        found.append((attr, node, locked))
                for child in ast.iter_child_nodes(node):
                    visit(child, locked)

            visit(method, False)
            return found

        worker_writes: Dict[str, List] = {}
        loop_writes: Dict[str, List] = {}
        for name, node in methods.items():
            if name == "__init__":
                continue
            bucket = worker_writes if name in worker else loop_writes
            for attr, site, locked in writes(node):
                bucket.setdefault(attr, []).append((name, site, locked))

        out: List[Finding] = []
        # pipeline ownership contract: consensus-named attributes are
        # prod-thread-owned — an unlocked worker-side write is the
        # defect itself, no loop-side co-writer needed
        dual = set(worker_writes) & set(loop_writes)
        for attr in sorted(set(worker_writes) - dual):
            if not _consensus_attr(attr):
                continue
            unlocked = [s for s in worker_writes[attr] if not s[2]]
            if not unlocked:
                continue
            name, site, _ = unlocked[0]
            out.append(ctx.finding(
                self, site,
                "self.%s (consensus state) is written from the "
                "worker-thread path (%s) — consensus state is owned "
                "by the prod thread; workers may only parse and hand "
                "immutable results back over the queue" % (
                    attr,
                    "/".join(sorted({s[0] for s in worker_writes[attr]
                                     }))),
                symbol="%s.%s" % (cls.name, name)))
        for attr in sorted(dual):
            w_sites = worker_writes[attr]
            l_sites = loop_writes[attr]
            unlocked = [s for s in w_sites + l_sites if not s[2]]
            if not unlocked:
                continue
            name, site, _ = unlocked[0]
            out.append(ctx.finding(
                self, site,
                "self.%s is written from both the worker-thread path "
                "(%s) and loop code (%s) without a lock — use a lock or "
                "the Tracer fixed-slot pattern" % (
                    attr,
                    "/".join(sorted({s[0] for s in w_sites})),
                    "/".join(sorted({s[0] for s in l_sites}))),
                symbol="%s.%s" % (cls.name, name)))
        return out
