"""PT002 host-sync-in-dispatch.

Historical bug class: the ops/ seams are split into a *dispatch* half
(enqueue the kernel launches, return tensors still being computed) and
a *collect* half (copy the result to the host). The whole pipelining
design — the proof and mesh pipelines, the hub's flush/collect split —
depends on dispatch halves never waiting on the card: one stray
``.item()`` / ``.cpu()`` / ``torch.cuda.synchronize()`` there
serializes every overlapped launch. The port has hit the class twice:
the trie dispatch and ``sha256_ragged_cuda`` each waited on the card
until it was found by hand. Device enumeration has one sanctioned home
too: ``ops/mesh.py`` (probe_platform / default_device) asks CUDA once
and caches the answer.

Two checks:

* anywhere in the package except ``ops/mesh.py``: calls to
  ``torch.cuda.is_available`` / ``device_count`` / ``current_device``
  / ``get_device_properties`` — route through ``mesh.probe_platform``
  / ``mesh.default_device`` / ``mesh.device_index``, or carry a pragma
  with the reason.
* in ``ops/`` dispatch-half functions ("dispatch" in the name or a
  ``*_async`` suffix, and not a collect): ``.item()``, ``.tolist()``,
  ``.cpu()``, ``.numpy()``, ``.to("cpu")``, ``torch.cuda.synchronize``,
  ``Event.synchronize`` / ``Stream.synchronize``, and ``np.asarray`` /
  ``float`` / ``int`` / ``bool`` applied to a tensor-tainted
  expression. An expression is tensor-tainted when it comes from a
  ``torch.*`` call, a tensor-only method, a ``*_cuda`` kernel wrapper
  or ``to_tensor``, carried through local assignments.

``.item()`` and ``.tolist()`` also exist on numpy arrays, so they count
only on a tensor-tainted receiver; ``.cpu()``, ``.numpy()``,
``.to("cpu")`` and ``.synchronize()`` have no host-only meaning and
count on any receiver.
"""
from __future__ import annotations

import ast
import os
from typing import List, Set

from plenum_tpu_torch.analysis.core import (
    PACKAGE, Finding, ModuleContext, Rule, dotted,
    walk_skipping_nested_defs)

MESH_PATH = "plenum_tpu_torch/ops/mesh.py"
PROBE_NAMES = ("is_available", "device_count", "current_device",
               "get_device_properties")
EAGER_PROBES = {"torch.cuda.%s" % p for p in PROBE_NAMES}
HOST_CONVERTERS = {"np.asarray", "numpy.asarray", "float", "int", "bool"}
# device→host on any receiver
SYNC_METHODS = {"cpu", "numpy", "synchronize"}
# device→host only on a tensor (numpy arrays have them too)
TENSOR_SYNC_METHODS = {"item", "tolist"}
# methods only a tensor has: their result is a tensor
TENSOR_METHODS = {"cuda", "contiguous", "new_empty", "new_zeros",
                  "new_ones", "new_full", "new_tensor", "index_select",
                  "masked_fill", "narrow", "unsqueeze", "record_stream"}
TENSOR_HELPERS = {"to_tensor"}


def _is_dispatch_half(name: str) -> bool:
    low = name.lower()
    return ("collect" not in low
            and ("dispatch" in low or low.endswith("_async")))


def _to_cpu(call: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")`` /
    ``x.to(torch.device("cpu"))``."""
    args = list(call.args) + [k.value for k in call.keywords
                              if k.arg == "device"]
    for a in args:
        if isinstance(a, ast.Constant) and a.value == "cpu":
            return True
        if isinstance(a, ast.Call) and dotted(a.func) == "torch.device" \
                and a.args and isinstance(a.args[0], ast.Constant) \
                and a.args[0].value == "cpu":
            return True
    return False


def _device_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = dotted(node.func)
    if name and name.split(".", 1)[0] == "torch":
        return name not in EAGER_PROBES
    term = node.func.attr if isinstance(node.func, ast.Attribute) \
        else (node.func.id if isinstance(node.func, ast.Name) else "")
    return (term in TENSOR_METHODS or term in TENSOR_HELPERS
            or term.endswith("_cuda"))


class HostSyncInDispatchRule(Rule):
    code = "PT002"
    name = "host-sync-in-dispatch"

    def applies(self, rel_path: str) -> bool:
        return rel_path.startswith("plenum_tpu_torch/")

    def check(self, ctx: ModuleContext) -> List[Finding]:
        out: List[Finding] = []
        if ctx.rel_path != MESH_PATH:
            for node in ast.walk(ctx.tree):
                if isinstance(node, ast.Call):
                    name = dotted(node.func)
                    if name in EAGER_PROBES:
                        out.append(ctx.finding(
                            self, node,
                            "eager %s() outside ops/mesh.py — route "
                            "device/platform questions through the "
                            "mesh's one cached probe (probe_platform / "
                            "default_device / device_index)" % name))
        for fn in dispatch_halves(ctx):
            out.extend(self._check_dispatch(ctx, fn))
        return out

    def _check_dispatch(self, ctx: ModuleContext,
                        fn: ast.AST) -> List[Finding]:
        out: List[Finding] = []
        tainted: Set[str] = set()

        def expr_tainted(expr: ast.AST) -> bool:
            for n in ast.walk(expr):
                if _device_call(n):
                    return True
                if isinstance(n, ast.Name) and n.id in tainted:
                    return True
            return False

        def note(node, what):
            out.append(ctx.finding(
                self, node,
                "%s in dispatch-half %s() forces a host sync — the "
                "dispatch/collect overlap (and every pipelined launch "
                "behind it) serializes here" % (what, fn.name)))

        # flow-insensitive taint over this function's OWN assignments
        # (nested defs excluded — their locals are a different scope),
        # iterated to a fixpoint so a->b->c chains resolve regardless
        # of the walk's visit order
        assigns = [sub for sub in walk_skipping_nested_defs(fn)
                   if isinstance(sub, ast.Assign)]
        changed = True
        while changed:
            changed = False
            for sub in assigns:
                if not expr_tainted(sub.value):
                    continue
                for tgt in sub.targets:
                    for n in ast.walk(tgt):
                        if isinstance(n, ast.Name) \
                                and n.id not in tainted:
                            tainted.add(n.id)
                            changed = True
        for sub in walk_skipping_nested_defs(fn):
            if not isinstance(sub, ast.Call):
                continue
            name = dotted(sub.func)
            attr = sub.func.attr if isinstance(sub.func, ast.Attribute) \
                else None
            if name == "torch.cuda.synchronize":
                note(sub, "torch.cuda.synchronize()")
            elif attr in SYNC_METHODS:
                note(sub, ".%s()" % attr)
            elif attr == "to" and _to_cpu(sub):
                note(sub, '.to("cpu")')
            elif attr in TENSOR_SYNC_METHODS \
                    and expr_tainted(sub.func.value):
                note(sub, ".%s() on a tensor" % attr)
            elif name in HOST_CONVERTERS and sub.args \
                    and expr_tainted(sub.args[0]):
                note(sub, "%s() on a tensor" % name)
        return out


def dispatch_halves(ctx: ModuleContext) -> List[ast.AST]:
    """The dispatch-half functions of one ``ops/`` module, in source
    order (none elsewhere): what PT002 holds to no host sync, and what
    chip_smoke.py's lint phase calls on the card under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    if not ctx.rel_path.startswith("plenum_tpu_torch/ops/"):
        return []
    found = [node for node in ast.walk(ctx.tree)
             if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
             and _is_dispatch_half(node.name)]
    return sorted(found, key=lambda n: n.lineno)


def list_dispatch_halves(root: str) -> List[str]:
    """Every dispatch half of the ops/ modules under `root` as
    "ops/<module>.py:<function or Class.method>", module by module in
    source order."""
    ops = os.path.join(root, PACKAGE, "ops")
    out: List[str] = []
    for name in sorted(os.listdir(ops)):
        if not name.endswith(".py"):
            continue
        rel = "%s/ops/%s" % (PACKAGE, name)
        with open(os.path.join(ops, name), encoding="utf-8") as f:
            source = f.read()
        ctx = ModuleContext(rel, source, ast.parse(source, filename=rel))
        out.extend("ops/%s:%s" % (name, ctx.symbol_for(fn))
                   for fn in dispatch_halves(ctx))
    return out
