"""PT006 broad-except-on-device-path.

Historical bug class: ``except Exception:`` wrapped around a device or
crypto call swallows real backend failures (a CUDA error, out of
memory, bad shapes, a mis-built kernel library) together with the
benign not-supported signals it meant to absorb. A host-transfer guard
was once narrowed to ``(AttributeError, NotImplementedError)`` with one
debug log after a broad except hid an actual transfer bug; that is the
precedent this rule enforces. In the port it is also the rule "no
fallback that hides the device or the kernel": a kernel failure on the
card that is swallowed, or served by the plain version, is a defect.

A broad handler (bare ``except``, ``Exception`` or ``BaseException``)
fires only when its ``try`` body reaches device/crypto work:

* any call in a file under ``ops/`` or ``crypto/`` (everything there IS
  the device path);
* elsewhere: calls rooted in a name imported from ``torch`` /
  ``plenum_tpu_torch.ops*`` (``ops/cuda_lib`` included: the kernels'
  build and load) / ``plenum_tpu_torch.crypto*`` / ``cryptography``,
  calls through receivers whose attribute names mention
  device/verify/bls seams, or torch's device markers
  (``synchronize``, ``cuda_lib.load``, the ``*_cuda`` kernel
  wrappers).

Handlers that re-raise (a bare ``raise`` in the handler body) pass:
catch-log-reraise does not swallow anything.
"""
from __future__ import annotations

import ast
import re
from typing import List, Optional, Set

from plenum_tpu_torch.analysis.core import (
    Finding, ModuleContext, Rule, attr_parts)

DEVICE_MODULE_RE = re.compile(
    r"^(torch|cryptography|plenum_tpu_torch\.(ops|crypto))($|\.)")
DEVICE_ATTRS = {"synchronize", "cuda"}
CUDA_LIB = "cuda_lib"
WRAPPER_SUFFIX = "_cuda"
SEAM_SUBSTRINGS = ("device", "verif", "bls")
BROAD_NAMES = {"Exception", "BaseException"}


def _broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    names = [t] if not isinstance(t, ast.Tuple) else list(t.elts)
    for n in names:
        if isinstance(n, ast.Name) and n.id in BROAD_NAMES:
            return True
    return False


def _device_marker(parts) -> bool:
    """torch's device markers in a leaf-first attribute chain:
    ``.synchronize()``, ``.cuda()``, a ``*_cuda`` kernel wrapper, or
    anything reached through ``cuda_lib`` (the kernels' build/load)."""
    return (parts[0] in DEVICE_ATTRS or parts[0].endswith(WRAPPER_SUFFIX)
            or CUDA_LIB in parts)


def _reraises(handler: ast.ExceptHandler) -> bool:
    return any(isinstance(n, ast.Raise) and n.exc is None
               for n in ast.walk(handler))


def _imported_device_aliases(tree: ast.Module) -> Set[str]:
    aliases: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if DEVICE_MODULE_RE.match(a.name):
                    aliases.add(a.asname or a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module:
            if DEVICE_MODULE_RE.match(node.module):
                for a in node.names:
                    aliases.add(a.asname or a.name)
    return aliases


class BroadExceptOnDevicePathRule(Rule):
    code = "PT006"
    name = "broad-except-on-device-path"

    def applies(self, rel_path: str) -> bool:
        return rel_path.startswith("plenum_tpu_torch/")

    def check(self, ctx: ModuleContext) -> List[Finding]:
        aliases = _imported_device_aliases(ctx.tree)
        in_device_dir = ctx.rel_path.startswith(
            ("plenum_tpu_torch/ops/", "plenum_tpu_torch/crypto/"))
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Try):
                continue
            evidence = self._device_evidence(
                node.body, aliases, in_device_dir)
            if evidence is None:
                continue
            for handler in node.handlers:
                if _broad(handler) and not _reraises(handler):
                    out.append(ctx.finding(
                        self, handler,
                        "broad except over a device/crypto path (%s in "
                        "the try) swallows backend failures — narrow to "
                        "the specific exception types and log once at "
                        "debug; a kernel failure on the card must "
                        "surface, never fall back to the plain "
                        "version" % evidence))
        return out

    @staticmethod
    def _device_evidence(body, aliases: Set[str],
                         in_device_dir: bool) -> Optional[str]:
        for stmt in body:
            for n in ast.walk(stmt):
                if isinstance(n, (ast.Import, ast.ImportFrom)):
                    mod = (n.names[0].name if isinstance(n, ast.Import)
                           else (n.module or ""))
                    if DEVICE_MODULE_RE.match(mod):
                        return "import %s" % mod
                if isinstance(n, ast.Call):
                    parts = attr_parts(n.func)
                    if not parts:
                        continue
                    if in_device_dir:
                        return ".".join(reversed(parts))
                    if parts[-1] in aliases or _device_marker(parts):
                        return ".".join(reversed(parts))
                    if any(s in p.lower() for p in parts
                           if p not in ("self", "cls")
                           for s in SEAM_SUBSTRINGS):
                        return ".".join(reversed(parts))
                elif isinstance(n, ast.Attribute):
                    # non-call seam references still place the try on the
                    # device path (e.g. a worker-thread method handed to
                    # run_in_executor as an argument)
                    if _device_marker([n.attr]) or any(
                            s in n.attr.lower() for s in SEAM_SUBSTRINGS):
                        return n.attr
        return None
