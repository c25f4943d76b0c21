"""Gateway admission control — backpressure from the telemetry plane
(port of plenum_tpu/gateway/admission.py).

The controller reads the signals the pool already exports —
backlog depth (``TM.BACKLOG_DEPTH``-shaped gauge fed by the forwarder)
and the ordered-request p99 (merged ``TM.ORDERED_E2E_MS`` histograms)
— and turns them into one small state machine with three levels:

* ``ADMIT_ALL``   — both signals under their high-water marks.
* ``SHED_READS``  — either signal over its high mark: reads are
  degraded FIRST (they have a correct fallback — the signed-read
  cache still serves proof-fresh answers, and a shed read costs the
  client a retry, not durability); writes still flow.
* ``SHED_WRITES`` — either signal past its HARD mark: writes shed
  too; only cache-served reads survive. The pool drains.

Recovery is hysteretic: a level is only left when BOTH signals are
back under the LOW marks — a gauge oscillating around one mark must
not flap the decision batch to batch.

The controller never talks to nodes: pressure arrives via
``observe(backlog, ordered_p99_ms)`` from whatever feeds the gateway
(the forwarder's in-flight accounting + the pool's merged telemetry),
so it is a pure, clock-free state machine the tests drive directly.
"""
from __future__ import annotations

from typing import Optional

ADMIT_ALL = 0
SHED_READS = 1
SHED_WRITES = 2

_LEVEL_NAMES = {ADMIT_ALL: "admit_all", SHED_READS: "shed_reads",
                SHED_WRITES: "shed_writes"}


def _cfg(config, name: str):
    from plenum_tpu_torch.common.config import Config
    return getattr(config, name, getattr(Config, name))


class AdmissionController:
    """Three-level shed ladder with per-signal hysteresis."""

    def __init__(self, config=None):
        self.backlog_high = float(_cfg(config, "GATEWAY_BACKLOG_HIGH"))
        self.backlog_low = float(_cfg(config, "GATEWAY_BACKLOG_LOW"))
        self.backlog_hard = float(_cfg(config, "GATEWAY_BACKLOG_HARD"))
        self.p99_high = float(_cfg(config, "GATEWAY_P99_HIGH_MS"))
        self.p99_low = float(_cfg(config, "GATEWAY_P99_LOW_MS"))
        self.p99_hard = float(_cfg(config, "GATEWAY_P99_HARD_MS"))
        self.level = ADMIT_ALL
        self._backlog = 0.0
        self._p99: Optional[float] = None

    # ------------------------------------------------------- pressure

    def observe(self, backlog: float,
                ordered_p99_ms: Optional[float]) -> int:
        """Feed the current pressure signals; → the (possibly new)
        level. Escalation is immediate; de-escalation steps one level
        at a time and only when BOTH signals sit under the low marks."""
        self._backlog = float(backlog)
        self._p99 = ordered_p99_ms
        p99 = ordered_p99_ms if ordered_p99_ms is not None else 0.0
        if self._backlog >= self.backlog_hard or p99 >= self.p99_hard:
            self.level = SHED_WRITES
        elif self._backlog >= self.backlog_high or p99 >= self.p99_high:
            self.level = max(self.level, SHED_READS)
        elif self._backlog < self.backlog_low and p99 < self.p99_low:
            if self.level > ADMIT_ALL:
                self.level -= 1
        return self.level

    # ------------------------------------------------------- verdicts

    def admits_read(self) -> bool:
        """Forwarded (cache-missing) reads survive only below
        SHED_READS; cache HITS are always served — they cost the pool
        nothing and carry their own proof of correctness."""
        return self.level < SHED_READS

    def admits_write(self) -> bool:
        return self.level < SHED_WRITES

    def level_name(self) -> str:
        return _LEVEL_NAMES[self.level]

    def snapshot(self) -> dict:
        return {"level": self.level_name(),
                "backlog": self._backlog,
                "ordered_p99_ms": self._p99}
