"""Tier-1 lint gate of the port — plenum_tpu_torch/ must be clean against
its own baseline, plenum_tpu_torch/lint_baseline.json.

One in-process run of the port's full PT001–PT017 registry over the
whole package (pure stdlib ast: no torch import, no CUDA context; the
whole-program engine rides its own content-hash cache,
.plenum_lint_torch_cache.json) feeds every test here through one
module-scoped fixture. A host sync in an ops/ dispatch half, an eager
CUDA probe outside ops/mesh.py or a broad except that swallows a kernel
failure on the card then fails the ordinary test run with the finding
text in the assertion.

Workflow when this fails: fix the finding, suppress the line with
``# plenum-lint: disable=PTxxx`` and a reason, or add a justified entry
to plenum_tpu_torch/lint_baseline.json (python -m
plenum_tpu_torch.analysis --write-baseline, then fill the
justification in).
"""
import os
import time

import pytest

from plenum_tpu_torch.analysis import (
    Baseline, default_baseline, repo_root, run_analysis)

REPO = repo_root()
PACKAGE = os.path.join(REPO, "plenum_tpu_torch")

# one full-registry whole-tree run, engine build included. A cold run
# takes ~13 s on one CPU core (a warm one ~4 s); the budget leaves room
# for a loaded test machine while still catching a rule gone quadratic
# or a cache that stopped hitting
GATE_BUDGET_S = 60.0


@pytest.fixture(scope="module")
def gate():
    t0 = time.perf_counter()
    new, baselined, baseline = run_analysis(
        [PACKAGE], root=REPO, baseline_path=default_baseline(REPO))
    return new, baselined, baseline, time.perf_counter() - t0


def test_plenum_tpu_torch_is_lint_clean(gate):
    new, _, _, wall = gate
    assert wall < GATE_BUDGET_S, (
        "the port's lint gate took %.1fs (budget %.0fs) — a rule went "
        "quadratic or the engine cache stopped hitting" % (
            wall, GATE_BUDGET_S))
    assert new == [], (
        "plenum-lint found %d non-baselined finding(s) in the port:\n%s\n\n"
        "Fix it, add an inline '# plenum-lint: disable=PTxxx' with a "
        "reason, or baseline it with a justification in "
        "plenum_tpu_torch/lint_baseline.json." % (
            len(new), "\n".join(f.render() for f in new)))


def test_port_baseline_has_no_stale_entries(gate):
    """Fixed code must shed its baseline entries — a stale entry could
    silently absorb a future regression elsewhere in the file."""
    _, _, baseline, _ = gate
    assert baseline.stale() == [], (
        "stale plenum_tpu_torch/lint_baseline.json entries (the code they "
        "matched was fixed — prune them): %r" % (baseline.stale(),))


def test_port_baseline_absorbs_every_entry_it_holds(gate):
    _, baselined, baseline, _ = gate
    assert len(baselined) == sum(int(e.get("count", 1))
                                 for e in baseline.entries)


def test_port_baseline_entries_are_justified():
    for e in Baseline.load(default_baseline(REPO)).entries:
        just = e.get("justification", "")
        assert just and "TODO" not in just, (
            "baseline entry without a real justification: %r" % (e,))


def test_port_baseline_holds_no_device_rule_entry():
    """A host sync in a dispatch half (PT002), a dropped dispatch
    generation (PT013) or an unbounded compile boundary (PT014) is
    fixed or carries an inline pragma with its reason, never a baseline
    entry."""
    rules = {e["rule"] for e in
             Baseline.load(default_baseline(REPO)).entries}
    assert not rules & {"PT002", "PT013", "PT014"}


def test_gate_covers_the_ports_device_seams():
    """The rules that state the port's own rules reach the files they
    guard: every ops/ module's dispatch halves (PT002), the verify
    daemon and the client's proof checks (PT006), the pipeline runtime
    (PT016/PT017)."""
    from plenum_tpu_torch.analysis.rules import RULE_CLASSES
    rules = {cls.code: cls() for cls in RULE_CLASSES
             if cls.code != "PT005"}
    for probe in ("plenum_tpu_torch/ops/sha256.py",
                  "plenum_tpu_torch/ops/mesh.py",
                  "plenum_tpu_torch/sha256_ceilings.py"):
        assert rules["PT002"].applies(probe), probe
    for probe in ("plenum_tpu_torch/server/verify_daemon.py",
                  "plenum_tpu_torch/client/client.py",
                  "plenum_tpu_torch/server/catchup.py"):
        assert rules["PT006"].applies(probe), probe
    for probe in ("plenum_tpu_torch/runtime/pipeline.py",
                  "plenum_tpu_torch/server/node.py"):
        assert rules["PT016"].applies(probe), probe
        assert rules["PT017"].applies(probe), probe
