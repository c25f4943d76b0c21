"""Per-file fact extraction — the cacheable layer of the engine.

``extract_file_facts(rel_path, source)`` parses one module and distills
everything the whole-program layers need into plain JSON-able dicts:

* the **symbol table** entry for every function/method (including
  nested defs), with decorator records and the enclosing class;
* the **import maps** (``import x.y as z`` / ``from a import b as c``)
  the callgraph resolves names through;
* every **call site** with its terminal name chain and the local flow
  of its *result* — ``returned`` / ``named`` (bound to locals, whose
  later uses are summarized) / ``escapes`` (stored, passed on,
  embedded in a container) / ``discarded`` (bare expression
  statement). PT013 reads dispatch-handle lifecycles straight off
  this;
* **rule facts**: nondeterminism sources (PT012), dispatch/collect
  effects (PT013), compiled-callable definitions (``torch.compile``,
  ``torch.jit.trace``, CUDA graph capture), device-launch shapes and
  bucket-routing evidence (PT014);
* the file's **pragma map**, so whole-program findings still honor
  ``# plenum-lint: disable=PTxxx``.

No AST node survives into the output — that is what makes the cache
(`cache.py`) a straight JSON dump keyed by content hash.
"""
from __future__ import annotations

import ast
from typing import Any, Dict, List, Optional, Set, Tuple

from plenum_tpu_torch.analysis.core import attr_parts, dotted, iter_pragmas

# bump when the extraction output changes shape or meaning — stale
# cache entries from an older extractor must never feed the linker
FACTS_VERSION = 2

# sanctioned bounded-shape helpers: a compiled launch routes through a
# bucket iff one of these is called on the way to the shape (the
# "forgot to round the batch axis" bug class). The port's four:
# ops/mesh.py pow2_at_least and Mesh.padded_size, ops/ed25519.py
# launch_lanes, ops/sha256.py pad_messages
BUCKET_HELPERS = frozenset({
    "pow2_at_least", "launch_lanes", "padded_size", "pad_messages",
})

# torch's compile-once-per-shape boundaries. A ctypes launch of an
# nvcc-built kernel (ops/cuda_lib.py) compiles nothing per shape, so it
# is not one; torch.compile with dynamic=True traces symbolic shapes
# and is not one either
COMPILE_CALLS = frozenset({
    "torch.compile", "torch.jit.trace", "torch.cuda.make_graphed_callables",
})
# context managers whose body is captured at the shapes it runs with
GRAPH_CAPTURES = frozenset({"torch.cuda.graph"})

# random-module entropy sources (an unseeded module-level generator;
# seeded instances — self._rng.choice — resolve to a different chain
# root and stay out)
RANDOM_FNS = frozenset({
    "random", "randint", "randrange", "choice", "choices", "shuffle",
    "sample", "uniform", "getrandbits", "randbytes", "betavariate",
    "gauss", "normalvariate", "expovariate",
})

# wall-clock reads that are nondeterministic across replicas when the
# VALUE escapes into state/messages (timer deltas never escape)
TIME_FNS = frozenset({
    "time", "time_ns", "monotonic", "monotonic_ns",
    "perf_counter", "perf_counter_ns",
})

_STR_BUILDERS = frozenset({"str", "repr", "format", "hex", "chr"})
_STR_METHODS = frozenset({"format", "encode", "decode", "join", "hex",
                          "lower", "upper", "strip"})

# ---- thread-region facts (PT016/PT017) --------------------------------

# names that mean "this context manager is a lock" — shared vocabulary
# with the PT004 heuristic so the engine-backed rules agree with the
# fallback on what counts as locked
LOCKISH = ("lock", "mutex", "cond", "sem")

# ast nodes that build a fresh MUTABLE container — the shapes that must
# not cross a thread queue (immutable bytes/views/frozen records do)
_MUTABLE_BUILDS = (ast.Dict, ast.List, ast.Set, ast.ListComp,
                   ast.SetComp, ast.DictComp)
_MUTABLE_CTORS = frozenset({"dict", "list", "set", "bytearray",
                            "defaultdict", "deque"})

# method names that mutate their receiver in place — used to detect a
# payload mutated AFTER it was handed over a queue. Deliberately a
# whitelist: matching any later line would false-positive on
# else-branches that merely mention the name (job.run() after put)
_MUTATOR_METHODS = frozenset({
    "append", "appendleft", "add", "update", "extend", "insert",
    "remove", "discard", "pop", "popleft", "clear", "setdefault",
})


def _lockish_name(name: str) -> bool:
    low = name.lower()
    return any(frag in low for frag in LOCKISH)


def _root_name(node: ast.AST) -> Optional[str]:
    """Base Name of an attribute/subscript chain, or None."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def is_bucket_helper(name: str) -> bool:
    """Sanctioned-helper check, alias-tolerant: ``from ops import
    pow2_at_least as _pow2_at_least`` must still count."""
    return name.lstrip("_") in BUCKET_HELPERS


def module_name(rel_path: str) -> str:
    """'plenum_tpu_torch/ops/sha3.py' → 'plenum_tpu_torch.ops.sha3';
    '__init__.py' collapses onto its package."""
    mod = rel_path[:-3] if rel_path.endswith(".py") else rel_path
    parts = mod.split("/")
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def dispatch_family(name: str) -> Optional[str]:
    """The effect family a call NAME opens, or None. ``X_dispatch`` /
    ``dispatch_X`` / ``begin_X`` all open family ``X``."""
    if name.endswith("_dispatch") and len(name) > len("_dispatch"):
        return name[: -len("_dispatch")]
    if name.startswith("dispatch_") and len(name) > len("dispatch_"):
        return name[len("dispatch_"):]
    if name.startswith("begin_") and len(name) > len("begin_"):
        return name[len("begin_"):]
    return None


def collect_families(name: str) -> List[str]:
    """Families a call NAME closes: ``X_collect`` / ``collect_X`` /
    ``end_X`` / ``resolve_X`` / ``X_resolve``."""
    out: List[str] = []
    if name.endswith("_collect"):
        out.append(name[: -len("_collect")])
    if name.startswith("collect_"):
        out.append(name[len("collect_"):])
    if name.startswith("end_"):
        out.append(name[len("end_"):])
    if name.startswith("resolve_"):
        out.append(name[len("resolve_"):])
    if name.endswith("_resolve"):
        out.append(name[: -len("_resolve")])
    return out


def _chain(node: ast.AST) -> List[str]:
    """Root-first attribute chain of a call target: ``self.state.get``
    → ['self', 'state', 'get']; [] when the root is dynamic."""
    parts = attr_parts(node)
    if not parts:
        return []
    # attr_parts is leaf-first, with the Name root appended last only
    # when the chain bottoms out at a Name
    if isinstance(node, ast.Name) or (
            isinstance(node, ast.Attribute) and _has_name_root(node)):
        return list(reversed(parts))
    return ["<dyn>"] + list(reversed(parts))


def _has_name_root(node: ast.AST) -> bool:
    while isinstance(node, ast.Attribute):
        node = node.value
    return isinstance(node, ast.Name)


def _decorator_record(dec: ast.AST) -> str:
    """Stable string for one decorator: dotted name, or
    ``outer(inner)`` for call decorators like
    ``functools.partial(torch.compile, ...)``."""
    if isinstance(dec, ast.Call):
        outer = dotted(dec.func) or "<dyn>"
        inner = ""
        if dec.args:
            inner = dotted(dec.args[0]) or ""
        return "%s(%s)" % (outer, inner) if inner else outer
    return dotted(dec) or "<dyn>"


def _dynamic_shapes(call: ast.Call) -> bool:
    """``torch.compile(..., dynamic=True)``: symbolic shapes, no
    per-shape recompile."""
    return any(k.arg == "dynamic" and isinstance(k.value, ast.Constant)
               and k.value.value is True for k in call.keywords)


def _is_jit_expr(node: ast.AST) -> bool:
    """True for expressions producing a compiled callable:
    ``torch.compile(fn)``, ``torch.jit.trace(fn, example)``,
    ``torch.cuda.make_graphed_callables(fn, sample)``, or a
    ``partial(torch.compile, ...)``."""
    if not isinstance(node, ast.Call):
        return False
    name = dotted(node.func)
    if name in COMPILE_CALLS:
        return not _dynamic_shapes(node)
    if name in ("functools.partial", "partial") and node.args:
        return dotted(node.args[0]) in COMPILE_CALLS \
            and not _dynamic_shapes(node)
    return False


def _jit_decorated(decorators: List[ast.AST]) -> bool:
    """``@torch.compile``, ``@torch.compile(...)`` (static shapes) or
    ``@partial(torch.compile, ...)``."""
    for d in decorators:
        if dotted(d) in COMPILE_CALLS or _is_jit_expr(d):
            return True
    return False


def _is_graph_capture(node: ast.AST) -> bool:
    """A ``with torch.cuda.graph(g):`` block: every launch in its body
    is recorded at the shapes it runs with."""
    if not isinstance(node, (ast.With, ast.AsyncWith)):
        return False
    return any(isinstance(item.context_expr, ast.Call)
               and dotted(item.context_expr.func) in GRAPH_CAPTURES
               for item in node.items)


class _FunctionExtractor:
    """One function's facts: call sites with result flow, local-name
    flows, nondeterminism sources, dispatch effects, launch evidence."""

    def __init__(self, fn: ast.AST, qname: str, cls: Optional[str],
                 imports: Dict[str, str],
                 from_imports: Dict[str, Tuple[str, str]]):
        self.fn = fn
        self.qname = qname
        self.cls = cls
        self.imports = imports
        self.from_imports = from_imports
        self.parents: Dict[int, ast.AST] = {}
        self.calls: List[dict] = []
        self.nondet: List[dict] = []
        self.attr_writes: List[dict] = []
        self.spawns: List[dict] = []
        self.handoffs: List[dict] = []
        self.name_flows: Dict[str, dict] = {}
        self.mutates = False
        self.buckets = False
        self.params: Set[str] = set()
        self._str_names: Set[str] = set()
        self._set_names: Set[str] = set()
        self._bucket_names: Set[str] = set()
        self._cond_names: Set[str] = set()
        self._const_names: Set[str] = set()
        # locals derived purely from parameters/consts: launches fed
        # by these are pass-through too (the caller owns the shapes)
        self._passthrough: Set[str] = set()

    # ------------------------------------------------------------ walk

    def run(self) -> dict:
        fn = self.fn
        for parent in self._walk_own(fn):
            for child in ast.iter_child_nodes(parent):
                self.parents[id(child)] = parent
        args = fn.args
        self.params = {a.arg for a in
                       list(args.posonlyargs) + list(args.args)
                       + list(args.kwonlyargs)}
        if args.vararg:
            self.params.add(args.vararg.arg)
        if args.kwarg:
            self.params.add(args.kwarg.arg)
        self._prepass()
        self._extract_calls()
        self._extract_name_flows()
        self._extract_nondet()
        self._extract_threading()
        decorator_nodes = list(getattr(fn, "decorator_list", ()))
        decorators = [_decorator_record(d) for d in decorator_nodes]
        return {
            "qname": self.qname,
            "name": fn.name,
            "cls": self.cls,
            "params": sorted(self.params),
            "line": fn.lineno,
            "col": fn.col_offset,
            "is_async": isinstance(fn, ast.AsyncFunctionDef),
            "decorators": decorators,
            "jitted": _jit_decorated(decorator_nodes),
            "calls": self.calls,
            "nondet": self.nondet,
            "name_flows": self.name_flows,
            "mutates": self.mutates,
            "buckets": self.buckets,
            "attr_writes": self.attr_writes,
            "spawns": self.spawns,
            "handoffs": self.handoffs,
        }

    def _walk_own(self, fn: ast.AST):
        """The function's own statements — nested def/class bodies are
        separate symbols (lambdas stay: they share the local scope)."""
        yield fn
        stack = list(ast.iter_child_nodes(fn))
        while stack:
            n = stack.pop()
            yield n
            if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                stack.extend(ast.iter_child_nodes(n))

    def _parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self.parents.get(id(node))

    def _enclosing(self, node: ast.AST, kinds) -> bool:
        cur = self._parent(node)
        while cur is not None and cur is not self.fn:
            if isinstance(cur, kinds):
                return True
            cur = self._parent(cur)
        return False

    # --------------------------------------------------------- prepass

    def _prepass(self) -> None:
        """Flow-insensitive fixpoint binding local names to string-ish
        / set-origin / bucket-derived / const / param-passthrough
        values (iterated until no set grows: assignment chains resolve
        regardless of statement order)."""
        assigns = [n for n in self._walk_own(self.fn)
                   if isinstance(n, ast.Assign)]
        changed = True
        while changed:
            changed = False
            for a in assigns:
                names = [t.id for t in a.targets
                         if isinstance(t, ast.Name)]
                if not names:
                    continue
                before = (len(self._str_names), len(self._set_names),
                          len(self._bucket_names),
                          len(self._cond_names),
                          len(self._const_names),
                          len(self._passthrough))
                if self._stringish(a.value):
                    self._str_names.update(names)
                if self._set_origin(a.value):
                    self._set_names.update(names)
                if self._bucket_expr(a.value):
                    self._bucket_names.update(names)
                if self._cond_bucket_expr(a.value):
                    self._cond_names.update(names)
                roots = self._filtered_roots(a.value) \
                    - self._const_names
                if not roots:
                    # value carries no caller data at all (config
                    # reads, literals): shape-innocent
                    self._const_names.update(names)
                elif roots <= (self.params | self._passthrough):
                    self._passthrough.update(names)
                after = (len(self._str_names), len(self._set_names),
                         len(self._bucket_names),
                         len(self._cond_names),
                         len(self._const_names),
                         len(self._passthrough))
                changed = changed or before != after
        for n in self._walk_own(self.fn):
            if isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = (n.targets if isinstance(n, ast.Assign)
                           else [n.target])
                for t in targets:
                    if isinstance(t, (ast.Attribute, ast.Subscript)):
                        self.mutates = True
            elif isinstance(n, (ast.Global, ast.Nonlocal)):
                self.mutates = True

    # ------------------------------------------------- value predicates

    def _stringish(self, expr: ast.AST) -> bool:
        """Provably str/bytes-valued (so ``hash()`` of it is salted by
        PYTHONHASHSEED and diverges across replica processes)."""
        if isinstance(expr, ast.Constant):
            return isinstance(expr.value, (str, bytes))
        if isinstance(expr, ast.JoinedStr):
            return True
        if isinstance(expr, ast.Tuple):
            return any(self._stringish(e) for e in expr.elts)
        if isinstance(expr, ast.BinOp) and isinstance(
                expr.op, (ast.Add, ast.Mod)):
            return self._stringish(expr.left) \
                or self._stringish(expr.right)
        if isinstance(expr, ast.Call):
            if isinstance(expr.func, ast.Name) \
                    and expr.func.id in _STR_BUILDERS:
                return True
            if isinstance(expr.func, ast.Attribute) \
                    and expr.func.attr in _STR_METHODS:
                return True
            return False
        if isinstance(expr, ast.Name):
            return expr.id in self._str_names
        return False

    def _set_origin(self, expr: ast.AST) -> bool:
        """Iteration over this expression is hash-order (unordered):
        set literals, set()/frozenset(), set algebra. Dicts stay out —
        CPython dict iteration is insertion-ordered, deterministic
        whenever the insertions are."""
        if isinstance(expr, (ast.Set, ast.SetComp)):
            return True
        if isinstance(expr, ast.Call):
            if isinstance(expr.func, ast.Name) \
                    and expr.func.id in ("set", "frozenset"):
                return True
            if isinstance(expr.func, ast.Attribute) \
                    and expr.func.attr in (
                        "union", "intersection", "difference",
                        "symmetric_difference") \
                    and self._set_origin(expr.func.value):
                return True
            return False
        if isinstance(expr, ast.BinOp) and isinstance(
                expr.op, (ast.BitAnd, ast.BitOr, ast.Sub, ast.BitXor)):
            return self._set_origin(expr.left) \
                and self._set_origin(expr.right)
        if isinstance(expr, ast.Name):
            return expr.id in self._set_names
        return False

    def _bucket_expr(self, expr: ast.AST) -> bool:
        """Bucket-routed on EVERY branch: an IfExp only counts when
        both arms route (``padded_size(B) if sharded else B`` is the
        r05 bug shape, not evidence)."""
        if isinstance(expr, ast.IfExp):
            return self._bucket_expr(expr.body) \
                and self._bucket_expr(expr.orelse)
        if isinstance(expr, ast.Call):
            ch = _chain(expr.func)
            if ch and is_bucket_helper(ch[-1]):
                return True
            return any(self._bucket_expr(a) for a in
                       list(expr.args) +
                       [k.value for k in expr.keywords])
        if isinstance(expr, ast.Name):
            return expr.id in self._bucket_names
        return any(self._bucket_expr(c)
                   for c in ast.iter_child_nodes(expr))

    def _cond_bucket_expr(self, expr: ast.AST) -> bool:
        """Bucket-routed on SOME branch but raw on another — the
        conditional half-bucketing PT014 flags outright."""
        if isinstance(expr, ast.IfExp):
            body = self._bucket_expr(expr.body)
            orelse = self._bucket_expr(expr.orelse)
            if body != orelse:
                return True
            return self._cond_bucket_expr(expr.body) \
                or self._cond_bucket_expr(expr.orelse)
        if isinstance(expr, ast.Name):
            return expr.id in self._cond_names
        return any(self._cond_bucket_expr(c)
                   for c in ast.iter_child_nodes(expr))

    # ----------------------------------------------------------- calls

    def _disposition(self, call: ast.Call) -> Tuple[str, List[str]]:
        """How the call's RESULT flows locally."""
        node: ast.AST = call
        parent = self._parent(node)
        while isinstance(parent, (ast.Await, ast.Tuple, ast.Starred)):
            node = parent
            parent = self._parent(node)
        if isinstance(parent, (ast.Return, ast.Yield, ast.YieldFrom)):
            return "returned", []
        if isinstance(parent, ast.Lambda):
            # a lambda body's value is returned to the lambda's caller
            return "returned", []
        if isinstance(parent, ast.Assign) and parent.value in (
                call, node):
            names, escapes = [], False
            for t in parent.targets:
                for sub in ast.walk(t):
                    if isinstance(sub, ast.Name):
                        names.append(sub.id)
                    elif isinstance(sub, (ast.Attribute, ast.Subscript)):
                        escapes = True
            if escapes and not names:
                return "escapes", []
            if names:
                return "named", names
            return "escapes", []
        if isinstance(parent, ast.Expr):
            return "discarded", []
        return "escapes", []

    def _extract_calls(self) -> None:
        for node in self._walk_own(self.fn):
            if not isinstance(node, ast.Call):
                continue
            chain = _chain(node.func)
            if not chain:
                # dynamic callee: record the builder-launch pattern
                # _build_x(...)(...) — a shape-keyed cached builder of
                # a compiled callable — and drop the rest
                if isinstance(node.func, ast.Call):
                    inner = _chain(node.func.func)
                    if inner and inner[-1].startswith("_build"):
                        flow, names = self._disposition(node)
                        self.calls.append(self._call_record(
                            node, ["<built>", inner[-1]], flow, names,
                            builder=True))
                continue
            terminal = chain[-1]
            if is_bucket_helper(terminal):
                self.buckets = True
            flow, names = self._disposition(node)
            self.calls.append(self._call_record(node, chain, flow,
                                                names))

    def _call_record(self, node: ast.Call, chain: List[str],
                     flow: str, names: List[str],
                     builder: bool = False) -> dict:
        args_all_const = True
        for a in list(node.args) + [k.value for k in node.keywords]:
            if not isinstance(a, ast.Constant):
                args_all_const = False
                break
        call_args = list(node.args) + [k.value for k in node.keywords]
        arg_bucketed = any(self._bucket_expr(a) for a in call_args)
        arg_cond = any(self._cond_bucket_expr(a) for a in call_args)
        # data roots of the operand expressions: a launch whose
        # operands all come in through the function's own parameters
        # is a pass-through seam — the CALLER shaped them, so the
        # bucket obligation lifts one frame up (summaries propagate
        # it as launches_param_shapes); self-rooted operands belong
        # to the object, whose class carries the evidence
        roots: Set[str] = set()
        for a in call_args:
            self._data_roots(a, roots)
        roots = {r for r in roots
                 if r not in self.imports
                 and r not in self.from_imports
                 and not r.isupper()
                 and r not in self._const_names}
        self_rooted = bool(roots & {"self", "cls"})
        caller_shaped = self.params | self._passthrough
        # empty roots = operands carry no caller data at all (module
        # constants, literal shapes): fixed per process, neither a
        # lift nor a finding — param_only must NOT be vacuously true
        # or const-shaped helpers would push a phantom bucket
        # obligation onto every caller
        arg_static = not roots
        arg_param_only = (not self_rooted and bool(roots)
                          and roots <= caller_shaped)
        arg_self_rooted = self_rooted and (
            roots - {"self", "cls"}) <= caller_shaped
        rec = {
            "chain": chain,
            "line": node.lineno,
            "col": node.col_offset,
            "flow": flow,
            "names": names,
            "in_except": self._enclosing(node, ast.ExceptHandler),
            "in_lambda": self._enclosing(node, ast.Lambda),
            "args_all_const": args_all_const,
            "arg_static": arg_static,
            "arg_bucketed": arg_bucketed,
            "arg_cond_bucketed": arg_cond,
            "arg_param_only": arg_param_only,
            "arg_self_rooted": arg_self_rooted,
        }
        if builder:
            rec["builder"] = True
        if self._in_graph_capture(node):
            rec["captured"] = True
        return rec

    def _in_graph_capture(self, node: ast.AST) -> bool:
        """An outermost call of a ``with torch.cuda.graph(...)`` body:
        the work the capture records (its argument calls only build
        the operands)."""
        cur = self._parent(node)
        while cur is not None and cur is not self.fn:
            if isinstance(cur, ast.Call):
                return False
            if _is_graph_capture(cur):
                return True
            cur = self._parent(cur)
        return False

    def _filtered_roots(self, expr: ast.AST) -> Set[str]:
        roots: Set[str] = set()
        self._data_roots(expr, roots)
        return {r for r in roots
                if r not in self.imports
                and r not in self.from_imports
                and not r.isupper()}

    # size aggregators: their result is a NEW scalar shape decision
    # made HERE, not a caller-shaped extent passing through — a launch
    # fed by one owns the bucket obligation locally (the pre-fix
    # per-level Keccak shape: nblocks = max(need), raw len(msgs) rows)
    _SIZE_DECIDERS = frozenset({"len", "max", "min", "sum"})

    def _data_roots(self, expr: ast.AST, out: Set[str]) -> None:
        """Base names of the value-carrying chains in an operand
        expression — subscript indices and callee NAMES are not data
        (``self._levels[h]`` is rooted at self). ``len()``/``max()``
        results root at the '<decided>' sentinel (never a parameter),
        severing pass-through."""
        if isinstance(expr, ast.Name):
            out.add(expr.id)
            return
        if isinstance(expr, (ast.Attribute, ast.Subscript)):
            self._data_roots(expr.value, out)
            return
        if isinstance(expr, ast.Call):
            if isinstance(expr.func, ast.Name) \
                    and expr.func.id in self._SIZE_DECIDERS:
                out.add("<decided>")
                return
            if isinstance(expr.func, ast.Attribute):
                self._data_roots(expr.func.value, out)
            for a in expr.args:
                self._data_roots(a, out)
            for k in expr.keywords:
                self._data_roots(k.value, out)
            return
        for c in ast.iter_child_nodes(expr):
            self._data_roots(c, out)

    # ------------------------------------------------------ name flows

    def _extract_name_flows(self) -> None:
        """Summarize how each local is USED — enough for handle
        lifecycle checks without keeping the AST."""
        for node in self._walk_own(self.fn):
            if not isinstance(node, ast.Name) \
                    or not isinstance(node.ctx, ast.Load):
                continue
            flow = self.name_flows.setdefault(
                node.id, {"returned": False, "escapes": False,
                          "closers": []})
            parent = self._parent(node)
            # receiver of a method call: h.results() / h.collect()
            if isinstance(parent, ast.Attribute) \
                    and parent.value is node:
                gp = self._parent(parent)
                if isinstance(gp, ast.Call) and gp.func is parent:
                    if parent.attr not in flow["closers"]:
                        flow["closers"].append(parent.attr)
                    continue
                flow["escapes"] = True
                continue
            # climb through tuple/await wrappers
            n: ast.AST = node
            while isinstance(parent, (ast.Tuple, ast.Await,
                                      ast.Starred, ast.List)):
                n = parent
                parent = self._parent(n)
            if isinstance(parent, (ast.Return, ast.Yield,
                                   ast.YieldFrom)):
                flow["returned"] = True
            elif isinstance(parent, ast.Call) and parent.func is not n:
                ch = _chain(parent.func)
                closer = ch[-1] if ch else "<dyn>"
                if closer not in flow["closers"]:
                    flow["closers"].append(closer)
            elif isinstance(parent, (ast.Assign, ast.AnnAssign)):
                # value re-bound to another local: treat as escaping
                # (handle aliasing is out of scope for v1)
                flow["escapes"] = True
            elif parent is not None and not isinstance(
                    parent, (ast.Expr, ast.Compare, ast.BoolOp,
                             ast.UnaryOp, ast.If, ast.While)):
                flow["escapes"] = True

    # --------------------------------------------------------- nondet

    def _extract_nondet(self) -> None:
        for node in self._walk_own(self.fn):
            if isinstance(node, ast.Call):
                self._nondet_call(node)
            elif isinstance(node, ast.For):
                self._nondet_iter(node.iter)
            elif isinstance(node, (ast.ListComp, ast.SetComp,
                                   ast.DictComp, ast.GeneratorExp)):
                for gen in node.generators:
                    self._nondet_iter(gen.iter)

    def _note(self, node: ast.AST, kind: str, detail: str) -> None:
        self.nondet.append({"kind": kind, "line": node.lineno,
                            "col": node.col_offset, "detail": detail})

    def _module_of(self, chain: List[str]) -> Optional[Tuple[str, str]]:
        """(module, func) for a 1–2 element chain through the import
        maps; None when the root isn't an imported module."""
        if len(chain) == 1:
            tgt = self.from_imports.get(chain[0])
            if tgt:
                return tgt[0], tgt[1]
            return None
        if len(chain) == 2:
            mod = self.imports.get(chain[0])
            if mod:
                return mod, chain[1]
        return None

    def _nondet_call(self, node: ast.Call) -> None:
        chain = _chain(node.func)
        if not chain:
            return
        if chain == ["hash"] and node.args:
            if self._stringish(node.args[0]):
                self._note(node, "hash-salted",
                           "hash() of a str/bytes value")
            return
        if chain == ["id"] and node.args:
            self._note(node, "id", "id() of an object")
            return
        resolved = self._module_of(chain)
        if resolved:
            mod, fn_name = resolved
            if mod == "random" and fn_name in RANDOM_FNS:
                self._note(node, "random",
                           "unseeded random.%s()" % fn_name)
            elif mod == "time" and fn_name in TIME_FNS:
                flow, names = self._disposition(node)
                returned = flow == "returned" or any(
                    self.name_flows.get(nm, {}).get("returned")
                    for nm in names)
                if returned:
                    self._note(node, "time-value",
                               "time.%s() escapes as a value"
                               % fn_name)

    def _nondet_iter(self, it: ast.AST) -> None:
        if self._set_origin(it):
            self._note(it, "set-iter",
                       "iteration over a set (hash order)")

    # ---------------------------------------- thread regions (PT016/17)

    def _under_lock(self, node: ast.AST) -> bool:
        """Enclosed by a ``with <something lock-ish>`` block."""
        cur = self._parent(node)
        while cur is not None and cur is not self.fn:
            if isinstance(cur, (ast.With, ast.AsyncWith)):
                for item in cur.items:
                    for sub in ast.walk(item.context_expr):
                        name = sub.attr if isinstance(
                            sub, ast.Attribute) else (
                            sub.id if isinstance(sub, ast.Name)
                            else None)
                        if name and _lockish_name(name):
                            return True
            cur = self._parent(cur)
        return False

    def _spawn_payload(self, expr: ast.AST):
        """(target chains, captured self-attrs) of a callable handed to
        another thread. A lambda target contributes every call chain in
        its body (they all run on the spawned thread) plus the self
        attributes it closes over — the closure-capture evidence
        PT017's escape check reads."""
        if isinstance(expr, ast.Lambda):
            targets: List[List[str]] = []
            captured: Set[str] = set()
            for n in ast.walk(expr.body):
                if isinstance(n, ast.Call):
                    ch = _chain(n.func)
                    if ch:
                        targets.append(ch)
                elif isinstance(n, ast.Attribute) \
                        and isinstance(n.value, ast.Name) \
                        and n.value.id == "self" \
                        and isinstance(n.ctx, ast.Load):
                    parent = self._parent(n)
                    invoked = isinstance(parent, ast.Call) \
                        and parent.func is n
                    if not invoked:
                        captured.add(n.attr)
            return targets, sorted(captured)
        ch = _chain(expr)
        return ([ch] if ch else []), []

    def _extract_threading(self) -> None:
        """Thread-creation, queue-handoff, and self-attr write facts —
        the raw material the region propagation (summaries.py) and the
        PT016/PT017 ownership rules consume."""
        # self-attribute rebinds (subscript stores excluded: the
        # sanctioned Tracer fixed-slot pattern writes into preallocated
        # ring slots, which is not an attribute rebind). A ``*_locked``
        # function name is the repo's caller-holds-the-lock convention
        # (ops/mesh.py) — its writes count as locked.
        fn_locked = self.fn.name.endswith("_locked")
        for node in self._walk_own(self.fn):
            if isinstance(node, (ast.Assign, ast.AugAssign,
                                 ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for tgt in targets:
                    if isinstance(tgt, ast.Attribute) \
                            and isinstance(tgt.value, ast.Name) \
                            and tgt.value.id == "self":
                        self.attr_writes.append({
                            "attr": tgt.attr,
                            "line": node.lineno,
                            "col": node.col_offset,
                            "locked": fn_locked
                            or self._under_lock(node),
                        })
        # in-place name mutations, for the mutated-after-handoff check
        mutations: List[Tuple[int, str]] = []
        for node in self._walk_own(self.fn):
            if isinstance(node, (ast.Assign, ast.AugAssign,
                                 ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for tgt in targets:
                    if isinstance(tgt, (ast.Attribute, ast.Subscript)):
                        root = _root_name(tgt)
                        if root:
                            mutations.append((node.lineno, root))
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _MUTATOR_METHODS:
                root = _root_name(node.func.value)
                if root:
                    mutations.append((node.lineno, root))
        # spawns and handoffs
        for node in self._walk_own(self.fn):
            if not isinstance(node, ast.Call):
                continue
            chain = _chain(node.func)
            if not chain:
                continue
            terminal = chain[-1]
            target_expr = None
            kind = None
            if terminal == "Thread":
                for kw in node.keywords:
                    if kw.arg == "target":
                        target_expr = kw.value
                        kind = "thread"
            elif terminal == "submit" and len(chain) >= 2 and node.args:
                target_expr = node.args[0]
                kind = "submit"
            elif terminal == "run_in_executor" and len(node.args) >= 2:
                target_expr = node.args[1]
                kind = "run_in_executor"
            if kind is not None and target_expr is not None:
                targets, captured = self._spawn_payload(target_expr)
                if targets or captured:
                    self.spawns.append({
                        "kind": kind,
                        "targets": targets,
                        "captured_attrs": captured,
                        "line": node.lineno,
                        "col": node.col_offset,
                    })
                continue
            if terminal in ("put", "put_nowait") and len(chain) >= 2 \
                    and node.args:
                arg0 = node.args[0]
                mutable = isinstance(arg0, _MUTABLE_BUILDS) or (
                    isinstance(arg0, ast.Call)
                    and isinstance(arg0.func, ast.Name)
                    and arg0.func.id in _MUTABLE_CTORS)
                arg_names = sorted({a.id for a in node.args
                                    if isinstance(a, ast.Name)})
                mutated_after = sorted({
                    nm for ln, nm in mutations
                    if nm in arg_names and ln > node.lineno})
                self.handoffs.append({
                    "op": terminal,
                    "recv": ".".join(chain[:-1]),
                    "line": node.lineno,
                    "col": node.col_offset,
                    "arg_mutable": mutable,
                    "mutable_kind": (type(arg0).__name__.lower()
                                     if isinstance(arg0, _MUTABLE_BUILDS)
                                     else (arg0.func.id if mutable
                                           else "")),
                    "arg_names": arg_names,
                    "mutated_after": mutated_after,
                })


def _scan_pragmas(source: str) -> dict:
    """The engine's JSON-able view of core.iter_pragmas (one shared
    pragma implementation — suppression must agree across layers)."""
    lines: Dict[str, List[str]] = {}
    file_codes: List[str] = []
    for i, codes, file_wide in iter_pragmas(source.splitlines()):
        lines.setdefault(str(i), []).extend(sorted(codes))
        if file_wide:
            file_codes.extend(codes)
    return {"file": sorted(set(file_codes)), "lines": lines}


def extract_file_facts(rel_path: str, source: str) -> dict:
    """Parse one module → its JSON-able fact record. Raises
    SyntaxError/ValueError like ast.parse (callers map that to PT000)."""
    tree = ast.parse(source, filename=rel_path)
    imports: Dict[str, str] = {}
    from_imports: Dict[str, Tuple[str, str]] = {}
    classes: Dict[str, dict] = {}
    functions: List[dict] = []
    jit_names: List[str] = []

    for node in tree.body:
        if isinstance(node, ast.Import):
            for alias in node.names:
                imports[alias.asname or alias.name.split(".")[0]] = \
                    alias.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            for alias in node.names:
                from_imports[alias.asname or alias.name] = \
                    (node.module, alias.name)
        # jit assignments are picked up by visit_scope below (it walks
        # module scope too — one detector, class-level included)

    def _block_stmts(body):
        """Statements of a scope INCLUDING control-flow blocks — a def
        nested inside ``if config.PIPELINE_ENABLED:`` (the node's
        pipeline wiring) is still a symbol. Function/class bodies stay
        out: they are their own scopes."""
        for node in body:
            yield node
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            for field in ("body", "orelse", "finalbody"):
                yield from _block_stmts(getattr(node, field, None) or [])
            for h in getattr(node, "handlers", None) or []:
                yield from _block_stmts(h.body)

    def visit_scope(body, qprefix: str, cls: Optional[str]) -> None:
        for node in _block_stmts(body):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qname = (qprefix + "." + node.name) if qprefix \
                    else node.name
                fx = _FunctionExtractor(node, qname, cls, imports,
                                        from_imports)
                functions.append(fx.run())
                visit_scope(node.body, qname, cls)
            elif isinstance(node, ast.ClassDef):
                qname = (qprefix + "." + node.name) if qprefix \
                    else node.name
                classes[qname] = {
                    "bases": [dotted(b) or "" for b in node.bases],
                    "line": node.lineno,
                    "methods": [n.name for n in node.body
                                if isinstance(n, (ast.FunctionDef,
                                                  ast.AsyncFunctionDef))],
                }
                visit_scope(node.body, qname, qname)
            elif isinstance(node, ast.Assign) \
                    and _is_jit_expr(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        jit_names.append(t.id)

    visit_scope(tree.body, "", None)
    return {
        "version": FACTS_VERSION,
        "path": rel_path,
        "module": module_name(rel_path),
        "imports": imports,
        "from_imports": {k: list(v) for k, v in from_imports.items()},
        "classes": classes,
        "functions": functions,
        "jit_names": jit_names,
        "pragmas": _scan_pragmas(source),
    }
