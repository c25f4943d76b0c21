"""Byzantine adversary subsystem: pluggable malicious behaviors, a
deterministic seed-driven fault scheduler, and safety/liveness invariant
checkers evaluated every sim tick.

Reference corpus: plenum/test/malicious_behaviors_node.py (request
tampering, duplicate/conflicting 3PC, malign sending) + the 73
view-change test files. Injection happens ONLY through the interception
seam (ExternalBus tap via ReplicaService.install_network_tap /
NodeStack.wire_tap) — production classes carry zero behavior logic.

Usage sketch::

    adv = AdversaryController(mock_timer, seed=7)
    adv.corrupt(nodes[0], EquivocatingPrimary())
    adv.at(5.0, lambda: adv.release(nodes[0]), "stop equivocation")
    Scenario(mock_timer, nodes, adversary=adv).run(20)   # checks
    # safety invariants every tick, raises InvariantViolation on fork
"""
from plenum_tpu_torch.testing.adversary.behaviors import (  # noqa: F401
    Behavior, ConflictingPrepare, DuplicateThreePC, EquivocatingNewView,
    EquivocatingPrimary, LinkFault, LyingCatchupSeeder, Partition,
    PoisonedBlsShare, SilentNode, TamperedPropagate)
from plenum_tpu_torch.testing.adversary.controller import (  # noqa: F401
    AdversaryController)
from plenum_tpu_torch.testing.adversary.invariants import (  # noqa: F401
    InvariantChecker, InvariantViolation)
from plenum_tpu_torch.testing.adversary.scenario import (  # noqa: F401
    LivenessViolation, Scenario, SLOViolation)
