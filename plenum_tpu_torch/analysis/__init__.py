"""plenum-lint for the port — AST-based consensus-safety and
device-hygiene analyzer over ``plenum_tpu_torch/``.

Rules encode the system's shipped-and-fixed bug classes (PT001–PT017;
see docs/static_analysis.md), with the device rules (PT002, PT006,
PT013, PT014) reading torch and CUDA idioms. Pure stdlib ``ast`` —
importing or running the analyzer never imports torch, creates a CUDA
context or builds a native library, which is what lets
tests/test_torch_lint_clean.py gate tier-1 in-process.

Programmatic entry point::

    from plenum_tpu_torch.analysis import run_analysis
    new, baselined, baseline = run_analysis(paths, root=repo_root,
                                            baseline_path=...)

Command line: ``python -m plenum_tpu_torch.analysis plenum_tpu_torch/``.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

from plenum_tpu_torch.analysis.baseline import Baseline
from plenum_tpu_torch.analysis.core import PACKAGE, Analyzer, Finding, Rule
from plenum_tpu_torch.analysis.rules import RULE_CLASSES, build_rules

__all__ = ["Analyzer", "Baseline", "Finding", "Rule", "RULE_CLASSES",
           "build_rules", "default_baseline", "repo_root", "run_analysis"]

BASELINE_NAME = "lint_baseline.json"


def repo_root() -> str:
    """The checkout root (three levels above this package)."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def default_baseline(root: str = None) -> str:
    """The port's baseline, inside the package it covers (the repo
    root's lint_baseline.json belongs to the JAX package)."""
    return os.path.join(root or repo_root(), PACKAGE, BASELINE_NAME)


def run_analysis(paths: Sequence[str], root: str = None,
                 baseline_path: Optional[str] = None,
                 disable: Sequence[str] = (),
                 select: Sequence[str] = (),
                 severities=None,
                 ) -> Tuple[List[Finding], List[Finding], Baseline]:
    """Run the full registry over `paths` → (new, baselined, baseline).
    `baseline_path=None` means no baseline (everything is new)."""
    root = root or repo_root()
    analyzer = Analyzer(
        build_rules(disable=disable, select=select,
                    severities=severities, root=root), root)
    findings = analyzer.run_paths(paths)
    baseline = (Baseline.load(baseline_path) if baseline_path
                else Baseline([]))
    new, baselined = baseline.match(findings)
    return new, baselined, baseline
