"""PT011 state-access-without-declared-keys.

Bug class the conflict-lane executor makes structural: the
lane planner (server/execution_lanes.py) partitions every ordered
batch from the handlers' ``touched_keys`` declarations, and the
batched read-window prefetch serves exactly the DECLARED read keys.
A ``WriteRequestHandler`` whose ``dynamic_validation`` /
``update_state`` reaches a state key its ``touched_keys`` cannot
produce breaks the contract the whole pipeline rests on: the request
would lane-plan as non-conflicting while actually racing another
lane's writes, and its reads would silently miss the prefetch window.
Execution stays byte-correct either way (the executor applies in
batch order and reads go pending-buffer-first), but the declaration
drift is invisible at runtime — exactly the kind of rot a lint rule
has to keep dead.

Encoding: inside a class whose base name ends with
``WriteRequestHandler`` / ``WriteHandler``, every
``*.state.get(key)`` / ``*.state.set(key, ...)`` call (receiver
``self.state`` or a local assigned from ``*.get_state(...)``) in a
``dynamic_validation`` or ``update_state`` override is checked for
**reachability from the declaration**: the key expression must be a
call to a function the class's ``touched_keys`` itself calls (the
"key recipe" — ``nym_to_state_key``, ``_path_aml_version``, …), a
name bound from such a call, or a constant name ``touched_keys``
references (``FROZEN_LEDGERS_PATH``). Classes without a declaration
(or with an explicit ``return None`` opt-out) get every state access
flagged — handlers whose key sets are inherently dynamic (NODE's
whole-state alias scan, TAA's digest chains read from state) carry
justified baseline entries; that friction is the point, because an
opt-out silently costs the serial lane.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from plenum_tpu_torch.analysis.core import (
    Finding, ModuleContext, Rule, attr_parts)

_HANDLER_BASES = ("WriteRequestHandler", "WriteHandler")
_CHECKED_METHODS = ("dynamic_validation", "update_state")


def _is_handler_class(cls: ast.ClassDef) -> bool:
    for base in cls.bases:
        parts = attr_parts(base)
        if parts and (parts[0].endswith(_HANDLER_BASES[0])
                      or parts[0].endswith(_HANDLER_BASES[1])):
            return True
    return False


def _terminal_func_name(call: ast.Call) -> Optional[str]:
    if isinstance(call.func, ast.Name):
        return call.func.id
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    return None


def _recipes(touched: Optional[ast.FunctionDef]) -> Optional[Set[str]]:
    """Names reachable from the declaration: functions/methods it
    calls plus the FREE names it loads (shared key constants like
    FROZEN_LEDGERS_PATH). touched_keys' own locals and parameters are
    excluded — a checked method binding the same local name ('key')
    to an undeclared recipe must not inherit reachability from the
    declaration's unrelated local. None = no touched_keys method."""
    if touched is None:
        return None
    bound: Set[str] = {a.arg for a in touched.args.args}
    bound.update(a.arg for a in touched.args.posonlyargs)
    bound.update(a.arg for a in touched.args.kwonlyargs)
    for node in ast.walk(touched):
        targets = ()
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            targets = (node.target,)
        elif isinstance(node, (ast.For, ast.comprehension)):
            targets = (node.target,)
        for t in targets:
            for sub in ast.walk(t):
                if isinstance(sub, ast.Name):
                    bound.add(sub.id)
    out: Set[str] = set()
    for node in ast.walk(touched):
        if isinstance(node, ast.Call):
            name = _terminal_func_name(node)
            if name:
                out.add(name)
        elif isinstance(node, ast.Name) and node.id not in bound:
            out.add(node.id)
    return out


def _key_reachable(expr: ast.AST, recipes: Set[str],
                   recipe_vars: Set[str]) -> bool:
    if isinstance(expr, ast.Call):
        name = _terminal_func_name(expr)
        return name is not None and name in recipes
    if isinstance(expr, ast.Name):
        return expr.id in recipes or expr.id in recipe_vars
    return False


class DeclaredKeysRule(Rule):
    code = "PT011"
    name = "state-access-without-declared-keys"

    def applies(self, rel_path: str) -> bool:
        return rel_path.startswith("plenum_tpu_torch/")

    def check(self, ctx: ModuleContext) -> List[Finding]:
        out: List[Finding] = []
        for cls in ast.walk(ctx.tree):
            if not isinstance(cls, ast.ClassDef) \
                    or not _is_handler_class(cls):
                continue
            methods: Dict[str, ast.FunctionDef] = {
                n.name: n for n in cls.body
                if isinstance(n, ast.FunctionDef)}
            recipes = _recipes(methods.get("touched_keys"))
            for name in _CHECKED_METHODS:
                func = methods.get(name)
                if func is None:
                    continue
                out.extend(self._check_method(ctx, cls, func, recipes))
        return out

    def _check_method(self, ctx: ModuleContext, cls: ast.ClassDef,
                      func: ast.FunctionDef,
                      recipes: Optional[Set[str]]) -> List[Finding]:
        out: List[Finding] = []
        # locals assigned from key recipes, and locals holding states
        # resolved via *.get_state(...) (cross-ledger reads)
        recipe_vars: Set[str] = set()
        state_vars: Set[str] = set()
        for node in ast.walk(func):
            if isinstance(node, ast.Assign) \
                    and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                target = node.targets[0].id
                value = node.value
                if isinstance(value, ast.Call):
                    vname = _terminal_func_name(value)
                    if vname == "get_state":
                        state_vars.add(target)
                    elif recipes and vname in recipes:
                        recipe_vars.add(target)
                elif isinstance(value, ast.Name) and recipes \
                        and value.id in recipes:
                    recipe_vars.add(target)
        for node in ast.walk(func):
            if not isinstance(node, ast.Call) \
                    or not isinstance(node.func, ast.Attribute) \
                    or node.func.attr not in ("get", "set") \
                    or not node.args:
                continue
            parts = attr_parts(node.func)
            if len(parts) < 2:
                continue
            receiver_is_state = parts[1] == "state" \
                or parts[1] in state_vars
            if not receiver_is_state:
                continue
            if recipes is None:
                out.append(ctx.finding(
                    self, node,
                    "state.%s in %s of a WriteRequestHandler with no "
                    "touched_keys declaration — declare the handler's "
                    "read/write key recipes (a superset computable "
                    "from the request) so the conflict-lane executor "
                    "can plan it, or return None and record the "
                    "inherently-dynamic justification in the baseline"
                    % (node.func.attr, func.name)))
                continue
            if _key_reachable(node.args[0], recipes, recipe_vars):
                continue
            out.append(ctx.finding(
                self, node,
                "state.%s in %s with a key expression not reachable "
                "from the class's touched_keys declaration — every "
                "state access in dynamic_validation/update_state must "
                "use a key recipe (function or constant) that "
                "touched_keys itself declares, or the lane planner "
                "will misplan the request's conflicts"
                % (node.func.attr, func.name)))
        return out
