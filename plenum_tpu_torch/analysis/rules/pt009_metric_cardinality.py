"""PT009 unbounded-metric-cardinality.

Bug class the telemetry plane was designed to prevent rather
than ship: a metric name built dynamically at a record site —
``hub.observe("latency_%s" % peer, ...)``, ``telemetry.count(f"retry_
{ledger_id}")`` — mints a new time series per distinct value. Every
monitoring system that has ever fallen over has fallen over this way:
the histogram/counter registry grows without bound (each telemetry
histogram is a preallocated ~4 KB bucket array), snapshots and
Prometheus exposition balloon, and the "metric" becomes an unqueryable
per-entity log. The whole point of the ``TM`` registry and ``SEAM_*``
constants (observability/telemetry.py) is that the metric-name set is
CLOSED at code-review time — the dead-name test pins every registry
entry to a recording site, and this rule pins every recording site to
the registry.

Encoding: at a telemetry record call — a call whose method is one of
``observe`` / ``record_launch`` / ``record_roundtrip`` / ``timer``
(any receiver), or ``count`` / ``gauge`` on a receiver whose
attribute chain mentions ``telemetry`` (scoping that keeps
``list.count``/``str.count`` out) — the metric/seam name argument must
not be a DYNAMIC string: f-strings, ``%``/``+`` formatting,
``str.format``/``join`` calls, or any expression mixing a non-constant
into the name is a finding. Registry constants (``TM.X``, ``SEAM_*``
names, aliased imports) and plain literals pass — a literal is bounded
cardinality even when it bypasses the registry (the dead-name test is
the instrument that catches orphaned literals).
"""
from __future__ import annotations

import ast
from typing import List, Optional

from plenum_tpu_torch.analysis.core import (
    Finding, ModuleContext, Rule, attr_parts)

# record methods checked on ANY receiver: these names are unique to the
# telemetry API, so a match is a record site
RECORD_METHODS = {"observe", "record_launch", "record_roundtrip", "timer"}
# record methods common enough to collide with builtins (str.count,
# list.count): only checked when the receiver chain says telemetry
SCOPED_METHODS = {"count", "gauge"}
_TELEMETRY_RECEIVER_PARTS = {"telemetry", "hub", "tm", "tmy", "tm_hub"}


def _name_arg(call: ast.Call) -> Optional[ast.AST]:
    """The metric/seam name argument: first positional, or the
    ``name``/``seam`` keyword."""
    if call.args:
        return call.args[0]
    for kw in call.keywords:
        if kw.arg in ("name", "seam"):
            return kw.value
    return None


def _is_literal_str(node: ast.AST) -> bool:
    """String expressions with exactly ONE possible value: literals,
    f-strings without interpolation, literal-only concatenation."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str)
    if isinstance(node, ast.JoinedStr):
        return not any(isinstance(v, ast.FormattedValue)
                       for v in node.values)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        return _is_literal_str(node.left) and _is_literal_str(node.right)
    return False


def _is_dynamic_string(node: ast.AST) -> bool:
    """True when the expression can take unboundedly many string
    values: f-strings with interpolation, %/+ formatting with any
    non-literal operand, .format()/.join() calls. A bare Name /
    Attribute reference (a registry constant) and literal-only
    construction are bounded; the SAME name inside a formatting
    expression is not — formatting is exactly how variable values
    leak into metric names."""
    if isinstance(node, ast.JoinedStr):
        return any(isinstance(v, ast.FormattedValue) for v in node.values)
    if isinstance(node, ast.BinOp):
        if isinstance(node.op, ast.Mod):
            return not (_is_literal_str(node.left)
                        and _is_literal_str(node.right))
        if isinstance(node.op, ast.Add):
            # TM.X-style references are bounded on their own, but any
            # concatenation involving one is only bounded when EVERY
            # operand is a literal — a Name operand is a variable part
            return not (_is_literal_str(node.left)
                        and _is_literal_str(node.right))
    if isinstance(node, ast.Call):
        callee = node.func
        if isinstance(callee, ast.Attribute) \
                and callee.attr in ("format", "join"):
            return True
    return False


class UnboundedMetricCardinalityRule(Rule):
    code = "PT009"
    name = "unbounded-metric-cardinality"

    def applies(self, rel_path: str) -> bool:
        return rel_path.startswith("plenum_tpu_torch/")

    def check(self, ctx: ModuleContext) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            callee = node.func
            if not isinstance(callee, ast.Attribute):
                continue
            method = callee.attr
            if method in RECORD_METHODS:
                pass
            elif method in SCOPED_METHODS:
                parts = {p.lower() for p in attr_parts(callee.value)}
                if not (parts & _TELEMETRY_RECEIVER_PARTS):
                    continue
            else:
                continue
            arg = _name_arg(node)
            if arg is None or not _is_dynamic_string(arg):
                continue
            out.append(ctx.finding(
                self, node,
                "dynamically-built metric name at telemetry %s() — "
                "every distinct value mints a new time series "
                "(unbounded registry growth, ballooning exposition); "
                "use a TM/SEAM_* registry constant and carry the "
                "variable part as a value, not a name" % method))
        return out
