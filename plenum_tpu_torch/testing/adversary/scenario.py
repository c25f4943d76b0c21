"""Scenario runner: drives a sim pool tick by tick, evaluating the
safety invariant checkers after EVERY tick, with bounded-window
liveness assertions for the recovery phase of a fault plan.

When a safety invariant fails and the pool is traced (Config
TRACING_ENABLED), the runner automatically dumps the merged pool
flight-recorder timeline (observability/) next to the failure — the
ring buffers hold exactly the window leading up to the violation —
plus the joined JOURNEY report (observability/journey.py): per-request
causal records, the per-link clock model, and the equivocation
evidence chain (every (viewNo:ppSeqNo) slot where nodes processed
conflicting PRE-PREPARE digests, with who observed which digest from
whom, and when). A fork dump therefore names the culprit slot and
sender without rerunning anything.
Override the directory with PLENUM_TPU_TRACE_DIR.

Soak mode (docs/robustness.md): `soak(rounds, fault, ...)` repeats
inject → measure recovery (sim seconds) → heal → settle, gating each
round's latency through `check_slo` — an SLO violation dumps the same
merged timeline with the measured latency and threshold embedded in
the filename and assertion text."""
from __future__ import annotations

import logging
import os
import tempfile
from typing import Callable, List, Optional

from plenum_tpu_torch.runtime.sanitizer import RegionViolation
from plenum_tpu_torch.testing.adversary.invariants import InvariantChecker

logger = logging.getLogger(__name__)

# process-wide dump counter: two failing scenarios in one process (e.g.
# one pytest run) must not overwrite each other's timelines
_dump_seq = [0]


class LivenessViolation(AssertionError):
    """The pool failed to make progress inside the bounded window."""


class SLOViolation(AssertionError):
    """A recovery-latency SLO was exceeded. The assertion text (and the
    auto-dumped flight-recorder filename) embeds the measured latency
    and the threshold, so a soak failure is triageable from the
    artifact alone — no need to rerun to learn how bad it was."""


class Scenario:
    def __init__(self, timer, nodes, adversary=None,
                 honest: Optional[List[str]] = None,
                 checker: Optional[InvariantChecker] = None,
                 step: float = 0.05):
        self.timer = timer
        self.nodes = list(nodes)
        self.adversary = adversary
        if honest is None:
            corrupted = set(adversary.adversaries) if adversary else set()
            honest = [n.name for n in nodes if n.name not in corrupted]
        self.honest_names = list(honest)
        self.checker = checker or InvariantChecker(nodes, honest)
        self.step = step
        if adversary is not None and not adversary.pool_names():
            adversary.set_pool(nodes)

    # ------------------------------------------------------------- drive

    @property
    def honest(self) -> List:
        return [n for n in self.nodes if n.name in self.honest_names]

    def run(self, seconds: float) -> "Scenario":
        """Pump the pool for `seconds` of sim time, checking every
        safety invariant after every tick."""
        end = self.timer.get_current_time() + seconds
        while self.timer.get_current_time() < end:
            self._tick()
        return self

    def run_until(self, condition: Callable[[], bool], timeout: float,
                  desc: str) -> "Scenario":
        """Pump until condition() holds; LivenessViolation on timeout —
        the bounded-window liveness assertion."""
        deadline = self.timer.get_current_time() + timeout
        while not condition():
            if self.timer.get_current_time() >= deadline:
                raise LivenessViolation(
                    "liveness: {} not reached within {}s (t={})".format(
                        desc, timeout, self.timer.get_current_time()))
            self._tick()
        return self

    def _tick(self) -> None:
        try:
            # service inside the try: an ownership-sanitizer violation
            # raised mid-service gets the same pool-wide dump treatment
            # as a failed safety invariant
            for node in self.nodes:
                node.service()
            self.timer.run_for(self.step)
            self.checker.check()
        except (AssertionError, RegionViolation) as e:
            path = self.dump_trace()
            if path:
                logger.error("safety invariant failed — flight-recorder "
                             "timeline dumped to %s (load in "
                             "ui.perfetto.dev)", path)
                if e.args and isinstance(e.args[0], str):
                    e.args = ("%s [flight recorder: %s]"
                              % (e.args[0], path),) + e.args[1:]
            jpath, equivs = self.dump_journey()
            if jpath:
                logger.error("journey + equivocation evidence dumped "
                             "to %s (%d equivocating slot(s))",
                             jpath, equivs)
                if e.args and isinstance(e.args[0], str):
                    tag = " [journeys: %s" % jpath
                    if equivs:
                        tag += "; EQUIVOCATION in %d slot(s)" % equivs
                    e.args = (e.args[0] + tag + "]",) + e.args[1:]
            raise

    def dump_trace(self, path: Optional[str] = None,
                   tag: str = "invariant_failure") -> Optional[str]:
        """Merge every traced node's ring buffer into one pool-wide
        Chrome trace-event file. → path, or None when no node has
        tracing enabled. `tag` lands in the generated filename so an
        artifact directory full of dumps stays self-describing (SLO
        dumps embed the measured latency and threshold there)."""
        from plenum_tpu_torch.observability.export import (
            export_chrome_trace, pool_tracers)
        tracers = [t for t in pool_tracers(self.nodes)
                   if getattr(t, "enabled", False)]
        if not tracers:
            return None
        if path is None:
            out_dir = os.environ.get("PLENUM_TPU_TRACE_DIR") \
                or tempfile.gettempdir()
            _dump_seq[0] += 1
            path = os.path.join(
                out_dir, "%s_trace_%d_%d.json"
                % (tag, os.getpid(), _dump_seq[0]))
        try:
            return export_chrome_trace(tracers, path)
        except OSError:
            logger.warning("could not write flight-recorder trace to %s",
                           path, exc_info=True)
            return None

    def dump_journey(self, path: Optional[str] = None,
                     tag: str = "invariant_failure"
                     ) -> tuple:
        """Join every traced node's buffer into the journey report —
        per-request causal records plus the equivocation evidence
        chain — and write it next to the timeline dump. → (path,
        equivocating_slot_count), or (None, 0) when nothing is traced
        or the write fails. The report is the triage half of a fork
        dump: the timeline shows WHERE time went, the evidence chain
        shows WHO sent conflicting digests for WHICH slot, and WHEN
        each honest node saw them."""
        import json

        from plenum_tpu_torch.observability import journey
        from plenum_tpu_torch.observability.export import pool_tracers
        tracers = [t for t in pool_tracers(self.nodes)
                   if getattr(t, "enabled", False)]
        if not tracers:
            return None, 0
        report = journey.journeys_from_tracers(tracers)
        doc = journey.to_json(report)
        doc["causal_violations"] = journey.causal_violations(report)
        if path is None:
            out_dir = os.environ.get("PLENUM_TPU_TRACE_DIR") \
                or tempfile.gettempdir()
            _dump_seq[0] += 1
            path = os.path.join(
                out_dir, "%s_journeys_%d_%d.json"
                % (tag, os.getpid(), _dump_seq[0]))
        try:
            with open(path, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
        except (OSError, TypeError, ValueError):
            logger.warning("could not write journey report to %s",
                           path, exc_info=True)
            return None, 0
        return path, len(doc.get("equivocations") or ())

    # ------------------------------------------------- recovery SLOs

    def measure(self, condition: Callable[[], bool], within: float,
                desc: str) -> float:
        """Pump until condition() holds → elapsed SIM seconds (the
        recovery-latency measurement primitive: deterministic under
        MockTimer, independent of host load)."""
        t0 = self.timer.get_current_time()
        self.run_until(condition, within, desc)
        return self.timer.get_current_time() - t0

    def check_slo(self, name: str, measured_s: float,
                  threshold_s: float) -> float:
        """Gate a measured recovery latency against its SLO. On
        violation the merged flight-recorder timeline is auto-dumped
        with the measured latency AND the threshold embedded in the
        filename, and the raised assertion text carries both plus the
        dump path — the failure artifact alone tells the whole story."""
        if measured_s <= threshold_s:
            return measured_s
        tag = "slo_%s_%.2fs_gt_%.2fs" % (name, measured_s, threshold_s)
        path = self.dump_trace(tag=tag.replace("/", "_"))
        text = ("recovery SLO '%s' violated: measured %.2fs > "
                "threshold %.2fs (sim time)" % (name, measured_s,
                                                threshold_s))
        if path:
            logger.error("%s — flight-recorder timeline dumped to %s "
                         "(load in ui.perfetto.dev)", text, path)
            text += " [flight recorder: %s]" % path
        raise SLOViolation(text)

    # ------------------------------------------------------ soak mode

    def soak(self, rounds: int, fault: Callable[[int], tuple],
             settle: float = 5.0, within: float = 60.0,
             slo: Optional[float] = None,
             slo_name: str = "recovery") -> List[dict]:
        """Repeated fault rounds with per-tick safety invariants and
        per-round recovery-latency measurement — the long-run shape
        where real RBFT deployments break (faults landing on a pool
        still digesting the previous fault's recovery).

        fault(round_idx) → (desc, recovered_condition, heal_fn|None):
        inject the fault before returning; `recovered_condition` is
        pumped under invariant checks until true (LivenessViolation
        after `within` sim seconds); heal_fn (if any) runs after
        recovery; then the pool settles for `settle` sim seconds before
        the next round. With `slo` set, every round's recovery latency
        is gated through check_slo (auto-dumping timelines on
        violation). → per-round records [{round, fault, recovery_s}]."""
        results: List[dict] = []
        for r in range(rounds):
            desc, recovered, heal = fault(r)
            latency = self.measure(
                recovered, within, "round %d: %s" % (r, desc))
            if heal is not None:
                heal()
            if settle:
                self.run(settle)
            results.append({"round": r, "fault": desc,
                            "recovery_s": round(latency, 3)})
            if slo is not None:
                self.check_slo("%s_round%d" % (slo_name, r), latency,
                               slo)
        return results

    # ------------------------------------------------- liveness helpers

    def await_ordering_resumes(self, extra_batches: int = 1,
                               within: float = 30.0) -> "Scenario":
        """Honest nodes must each order `extra_batches` more batches
        within the window (the fault is over / absorbed)."""
        base = {n.name: _last_seq(n) for n in self.honest}

        def resumed():
            return all(_last_seq(n) >= base[n.name] + extra_batches
                       for n in self.honest)

        return self.run_until(
            resumed, within,
            "+{} ordered batches on every honest node".format(
                extra_batches))

    def await_view_change(self, min_view: int = 1,
                          within: float = 60.0) -> "Scenario":
        """Every honest node must complete a view change to at least
        `min_view` (adversarial-primary recovery)."""

        def done():
            return all(
                _replica(n).view_no >= min_view
                and not _replica(n).data.waiting_for_new_view
                for n in self.honest)

        return self.run_until(
            done, within, "view change to >= {}".format(min_view))

    def await_catchup_done(self, node, within: float = 60.0) -> "Scenario":
        """The node's leecher must finish syncing every ledger within
        the window (catchup-completion liveness)."""
        return self.run_until(
            lambda: not node.leecher.in_progress, within,
            "catchup completes on {}".format(node.name))


def _replica(node):
    return getattr(node, "replica", node)


def _last_seq(node) -> int:
    return _replica(node).last_ordered[1]
