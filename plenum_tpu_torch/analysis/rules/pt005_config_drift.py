"""PT005 config-literal-drift.

Historical bug class: tuning knobs hard-coded at their use sites drift
apart from ``common/config.py``. The
MERKLE_DEVICE_* routing thresholds were single-sourced after the ledger
and the engine disagreed, and VERIFIER_BATCH_THRESHOLD likewise across
the
AdaptiveVerifier, the hub and the node. A literal that silently equals
a Config value is a knob the operator cannot turn.

Encoding: ``common/config.py`` is parsed (AST only, constant folding
for ``a * b`` / ``1 << k`` style definitions) into a value → knob-names
map. Integer literals >= 32 in ``ops/`` and ``server/`` that equal a
knob value are flagged, but ONLY in threshold-shaped positions —
parameter defaults, call keyword arguments and comparison operands —
where a tunable hides. Arithmetic, indexing and shape math (the 32s
and 64s of digest widths and SHA blocks all over the kernels) are
structure, not tuning, and stay out of scope.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, List, Tuple

from plenum_tpu_torch.analysis.core import (
    PACKAGE, Finding, ModuleContext, Rule)

MIN_VALUE = 32   # below this, collisions are noise (0/1/8/16 everywhere)


def _fold(node: ast.AST):
    """Constant-fold the arithmetic subset Config definitions use."""
    if isinstance(node, ast.Constant) \
            and isinstance(node.value, (int, float)) \
            and not isinstance(node.value, bool):
        return node.value
    if isinstance(node, ast.BinOp):
        left, right = _fold(node.left), _fold(node.right)
        if left is None or right is None:
            return None
        try:
            if isinstance(node.op, ast.Mult):
                return left * right
            if isinstance(node.op, ast.Add):
                return left + right
            if isinstance(node.op, ast.Sub):
                return left - right
            if isinstance(node.op, ast.FloorDiv):
                return left // right
            if isinstance(node.op, ast.LShift):
                return left << right
            if isinstance(node.op, ast.Pow):
                return left ** right
        except (TypeError, ZeroDivisionError):
            return None
    return None


def load_config_values(config_path: str) -> Dict[int, List[str]]:
    """value → [knob names] for every int-valued Config class default."""
    with open(config_path, "r", encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=config_path)
    values: Dict[int, List[str]] = {}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.ClassDef) and node.name == "Config"):
            continue
        for stmt in node.body:
            if not isinstance(stmt, ast.Assign):
                continue
            v = _fold(stmt.value)
            if not isinstance(v, int) or isinstance(v, bool) \
                    or v < MIN_VALUE:
                continue
            for tgt in stmt.targets:
                if isinstance(tgt, ast.Name):
                    values.setdefault(v, []).append(tgt.id)
    return values


class ConfigLiteralDriftRule(Rule):
    code = "PT005"
    name = "config-literal-drift"

    def __init__(self, config_values: Dict[int, List[str]] = None,
                 root: str = None):
        self._values = config_values
        self._root = root

    def _ensure_values(self) -> Dict[int, List[str]]:
        if self._values is None:
            path = os.path.join(self._root or os.getcwd(), PACKAGE,
                                "common", "config.py")
            self._values = load_config_values(path) \
                if os.path.exists(path) else {}
        return self._values

    def applies(self, rel_path: str) -> bool:
        return rel_path.startswith(("plenum_tpu_torch/ops/",
                                    "plenum_tpu_torch/server/"))

    @staticmethod
    def _threshold_position(node: ast.AST, parent: ast.AST) -> bool:
        if isinstance(parent, ast.arguments):
            return node in parent.defaults or node in parent.kw_defaults
        if isinstance(parent, ast.keyword):
            return True
        if isinstance(parent, ast.Compare):
            # ordering comparisons are threshold checks; ==/!= against a
            # width (len(sig) != 64) is structure, not tuning
            return any(isinstance(op, (ast.Gt, ast.GtE, ast.Lt, ast.LtE))
                       for op in parent.ops)
        return False

    def check(self, ctx: ModuleContext) -> List[Finding]:
        values = self._ensure_values()
        if not values:
            return []
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Constant)
                    and isinstance(node.value, int)
                    and not isinstance(node.value, bool)):
                continue
            v = node.value
            if v < MIN_VALUE or v not in values:
                continue
            parent = ctx.parent(node)
            if not self._threshold_position(node, parent):
                continue
            out.append(ctx.finding(
                self, node,
                "literal %d duplicates Config.%s — reference the config "
                "knob so the operator's override reaches this site" % (
                    v, "/".join(sorted(set(values[v]))))))
        return out
