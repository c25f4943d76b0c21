"""Runtime ownership sanitizer — region pins and handoff tokens.

The static half of the ownership story is plenum-lint's thread-region
analysis (PT016/PT017): every function gets a set of executing regions
(prod / worker / daemon), and consensus-named state may only be
written from the prod region. This module is the runtime twin: the
same contract, enforced at the same seams, on live threads — so every
e2e test that runs with the sanitizer on doubles as a race check.

Three pieces:

* :class:`OwnershipSanitizer` — label-based region pins. A node binds
  its thread identities to region names (``bind_region("prod")``),
  pins consensus-critical objects to regions by label
  (``pin("vote stores", "prod")``), and guarded code calls
  ``check(label)`` at its intake seams. A check on an unpinned label
  is a no-op (the exact ``_owner_thread is None`` behavior of the old
  ``OrderingService`` guard this generalizes); a check from the wrong
  thread raises :class:`RegionViolation` naming the owning region and
  both thread ids, with the flight-recorder timeline dumped first
  (the Scenario invariant-dump convention).
* :class:`HandoffToken` — queue-boundary ownership transfer. The
  producer releases the token toward the consuming region before
  ``put``; the consumer acquires it after ``get``. Acquiring a token
  that was not released to your region means a payload was touched
  out of turn — the runtime shape of PT017's handoff discipline.
* :data:`CONSENSUS_PINS` — the canonical label → attribute-fragment
  table. Every pinned label names state in the static analysis's
  consensus-owned vocabulary (pt004/PT016 ``CONSENSUS_ATTRS``); the
  agreement test in tests/test_sanitizer.py pins that correspondence
  so the static and runtime halves cannot drift.

Opt-in: ``Config.SANITIZER_ENABLED`` (tri-state, None = environment
decides) or ``PLENUM_TPU_SANITIZE=1``. The sim-pool test fixtures set
the environment flag suite-wide; production default is off.
"""
from __future__ import annotations

import logging
import os
import tempfile
import threading
from typing import Dict, Optional, Tuple

logger = logging.getLogger(__name__)

# label -> consensus-attribute fragments (the PT004/PT016 vocabulary)
# the pinned object's state lives under. Static/runtime agreement:
# every fragment here MUST appear in analysis.rules.pt004_threads.
# CONSENSUS_ATTRS — tests/test_sanitizer.py enforces the subset — and
# a PT016-clean seam outside this table needs no pin at all.
CONSENSUS_PINS: Dict[str, Tuple[str, ...]] = {
    "3PC intake": ("prepare", "commit", "view_no", "last_ordered"),
    "vote stores": ("prepare", "commit"),
    "stashes": ("stash",),
    "state pending buffers": ("state_root", "ledger"),
    "lane planner": ("request_queue", "requestqueue"),
}

_dump_seq = [0]


def sanitizer_enabled(config=None) -> bool:
    """The one opt-in rule: an explicit ``Config.SANITIZER_ENABLED``
    (True/False) wins; None defers to ``PLENUM_TPU_SANITIZE`` (the
    test fixtures' suite-wide switch); absent both → off."""
    val = getattr(config, "SANITIZER_ENABLED", None) \
        if config is not None else None
    if val is not None:
        return bool(val)
    env = os.environ.get("PLENUM_TPU_SANITIZE")
    return env not in (None, "", "0", "false")


class RegionViolation(RuntimeError):
    """Consensus-owned state touched from the wrong thread region.
    A RuntimeError subclass so the original ``bind_owner_thread``
    contract (and every test pinned to it) holds unchanged."""


class OwnershipSanitizer:
    """Region pins for consensus-critical objects.

    Thread-safety of the sanitizer itself: bindings and pins are
    written during single-threaded wiring (node construction, worker
    startup) and only read afterwards; ``check`` is a dict lookup plus
    an int compare, cheap enough for vote-counting hot paths (the
    sanitizer_overhead bench gates it under 2%)."""

    def __init__(self, name: str = "", tracer=None):
        self.name = name
        self.tracer = tracer
        self._regions: Dict[str, int] = {}   # region -> thread ident
        self._pins: Dict[str, str] = {}      # label  -> owning region

    # ------------------------------------------------------------ wiring

    def bind_region(self, region: str, ident: Optional[int] = None
                    ) -> None:
        """Declare which thread IS a region (None = current thread)."""
        self._regions[region] = int(
            threading.get_ident() if ident is None else ident)

    def pin(self, label: str, region: str) -> None:
        """Pin a labeled object to its owning region."""
        self._pins[label] = region

    def pinned(self, label: str) -> Optional[str]:
        return self._pins.get(label)

    @property
    def pins(self) -> Dict[str, str]:
        return dict(self._pins)

    # ------------------------------------------------------------ checks

    def check(self, label: str) -> None:
        """Assert the calling thread owns ``label``. Unpinned labels
        and unbound regions pass — enabling the sanitizer never
        changes behavior until a pin says otherwise."""
        region = self._pins.get(label)
        if region is None:
            return
        owner = self._regions.get(region)
        if owner is None:
            return
        current = threading.get_ident()
        if current != owner:
            self.violation(label, region, owner, current)

    def violation(self, label: str, region: str, owner: int,
                  current: int) -> None:
        """Raise with owning region + both threads named, flight
        recorder dumped first. The message prefix is byte-identical to
        the original OrderingService guard for label='3PC intake',
        region='prod' — one implementation, same contract."""
        msg = ("%s off the %s thread: consensus state is owned by "
               "thread %d, called from %d" % (label, region, owner,
                                              current))
        path = self.dump_trace()
        if path:
            logger.error("ownership violation — flight-recorder "
                         "timeline dumped to %s (load in "
                         "ui.perfetto.dev)", path)
            msg += " [flight recorder: %s]" % path
        raise RegionViolation(msg)

    def dump_trace(self, path: Optional[str] = None,
                   tag: str = "sanitizer_violation") -> Optional[str]:
        """Write this node's tracer ring buffer as a Chrome trace —
        the Scenario invariant-dump convention, scoped to one node.
        → path, or None when nothing is traced."""
        tracer = self.tracer
        if tracer is None or not getattr(tracer, "enabled", False):
            return None
        from plenum_tpu_torch.observability.export import export_chrome_trace
        if path is None:
            out_dir = os.environ.get("PLENUM_TPU_TRACE_DIR") \
                or tempfile.gettempdir()
            _dump_seq[0] += 1
            path = os.path.join(
                out_dir, "%s_trace_%d_%d.json"
                % (tag, os.getpid(), _dump_seq[0]))
        try:
            return export_chrome_trace([tracer], path)
        except OSError:
            logger.warning("could not write flight-recorder trace to "
                           "%s", path, exc_info=True)
            return None


class HandoffToken:
    """Ownership transfer across one queue boundary.

    States: held by a region ("prod"), or in flight toward one
    (("in-flight", "worker")). ``release(to)`` is called by the
    producer just before ``put``; ``acquire(region)`` by the consumer
    right after ``get``. Acquiring from the wrong state means the
    payload crossed the boundary out of turn. The sanctioned serial
    step-down (dead worker, prod runs the job inline) drops the token
    instead: with one thread left there is no handoff to discipline."""

    __slots__ = ("sanitizer", "label", "state")

    def __init__(self, sanitizer: OwnershipSanitizer, label: str,
                 holder: str = "prod"):
        self.sanitizer = sanitizer
        self.label = label
        self.state = holder

    def release(self, to_region: str) -> None:
        self.state = ("in-flight", to_region)

    def acquire(self, region: str) -> None:
        if self.state != ("in-flight", region):
            owner = self.state[1] if isinstance(self.state, tuple) \
                else self.state
            san = self.sanitizer
            san.violation(
                "handoff token %r" % self.label, owner,
                san._regions.get(owner, -1), threading.get_ident())
        # cross-region by design, ordered without a lock: release
        # happens-before put() and the consumer's acquire happens-after
        # get() (or after done.set() on the way back) — the queue's own
        # synchronization is the fence
        self.state = region  # plenum-lint: disable=PT016
