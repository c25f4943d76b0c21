"""PT008 per-item-loop-in-hot-3pc-handler.

Historical bug class: per-message 3PC handlers under ``consensus/``
scanning a request/digest/vote collection with a Python loop. The
incident is ``OrderingService._has_prepared``: every inbound PREPARE
re-counted the sender dict with a comprehension (``len([s for s in
self.prepares[key] if s != primary])``) — O(n) per message, O(n²) per
batch per node, and at 25 validators the counting loop alone dominated
the ordering money path (BENCH_r05: ~209 ordered req/s against ~62k
device verifies/s). The fix is columnar: incremental quorum counters
bumped at vote insert (one dict read per check) and batch intake
(``process_prepare_batch``/``process_commit_batch``) that hoists the
shared checks and compares the digest column in one vectorized pass.

Encoding: inside a HOT per-message handler — a function whose name is
``process_*``/``_process_*``/``validate_*``/``_try_*``/``_has_*``
mentioning a 3PC message type (prepare/commit/pre-prepare/propagate)
and NOT itself a ``*_batch`` variant — any ``for`` loop or
comprehension iterating a request/digest/vote collection
(``prepares``/``commits``/``propagates``/``requests``/``digests``/
``req_idr``/``votes``/``shares``, plain or behind an attribute /
subscript / ``.items()``-style call) is flagged. Batch handlers are
exempt: one loop per inbound BATCH is the columnar design, not the
quadratic shape. Intentionally scalar paths (rare, cold, or
correctness-bound per-item work such as per-share BLS validation)
carry a justified baseline entry or an inline pragma.
"""
from __future__ import annotations

import ast
import re
from typing import List

from plenum_tpu_torch.analysis.core import Finding, ModuleContext, Rule

HANDLER_NAME = re.compile(r"^_?(process|validate|try|has)_")
MSG_3PC = re.compile(
    r"(prepare|pre_?prepare|commit|propagate|three_?pc|3pc)",
    re.IGNORECASE)
COLLECTION = re.compile(
    r"^(prepares|commits|propagates|requests|digests|req_?idr|votes|"
    r"shares|prepares_store|commits_store)$", re.IGNORECASE)

# iterator-protocol helpers that still walk the same collection
_ITER_METHODS = {"items", "keys", "values", "get"}


def _collection_name(node: ast.AST) -> str:
    """The terminal name of an iterable expression: ``self.prepares``,
    ``self.prepares[key]``, ``commits.items()``, ``state.propagates``
    all resolve to the collection identifier the loop walks."""
    if isinstance(node, ast.Call):
        callee = node.func
        if isinstance(callee, ast.Attribute) \
                and callee.attr in _ITER_METHODS:
            return _collection_name(callee.value)
        return ""
    if isinstance(node, ast.Subscript):
        return _collection_name(node.value)
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


class PerItemHotLoopRule(Rule):
    code = "PT008"
    name = "per-item-loop-in-hot-3pc-handler"

    def applies(self, rel_path: str) -> bool:
        return rel_path.startswith(("plenum_tpu_torch/consensus/",
                                    "plenum_tpu_torch/gateway/"))

    @staticmethod
    def _is_hot_handler(name: str) -> bool:
        return bool(HANDLER_NAME.match(name)) \
            and bool(MSG_3PC.search(name)) \
            and "batch" not in name.lower()

    def check(self, ctx: ModuleContext) -> List[Finding]:
        out: List[Finding] = []
        for func in ast.walk(ctx.tree):
            if not isinstance(func, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            if not self._is_hot_handler(func.name):
                continue
            for node in ast.walk(func):
                if isinstance(node, ast.For):
                    iters = [node.iter]
                elif isinstance(node, (ast.ListComp, ast.SetComp,
                                       ast.GeneratorExp, ast.DictComp)):
                    iters = [g.iter for g in node.generators]
                else:
                    continue
                for it in iters:
                    coll = _collection_name(it)
                    if not coll or not COLLECTION.match(coll):
                        continue
                    out.append(ctx.finding(
                        self, node,
                        "per-item loop over '%s' inside hot per-message "
                        "handler %s — O(items) per inbound message is "
                        "quadratic per batch; use an incremental "
                        "counter maintained at insert, or move the "
                        "work to the columnar *_batch intake "
                        "(process_prepare_batch/process_commit_batch)"
                        % (coll, func.name)))
                    break
        return out
