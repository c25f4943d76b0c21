"""Replica-level monitoring services beyond the primary-connection
monitor: freshness watchdog + forced (chaos) view changes.

Reference: plenum/server/consensus/monitoring/
freshness_monitor_service.py (a NON-primary watchdog: if the primary
fails to keep state signatures fresh — no freshness batches — every
node votes a view change) and forced_view_change_service.py (periodic
debug view changes when ForceViewChangeFreq > 0).
"""
from __future__ import annotations

import logging
from typing import Callable, Optional

from plenum_tpu_torch.common.messages.internal_messages import VoteForViewChange
from plenum_tpu_torch.runtime.timer import RepeatingTimer, TimerService

logger = logging.getLogger(__name__)


class FreshnessMonitorService:
    """Votes for a view change when the oldest ledger's signed state age
    exceeds ACCEPTABLE_FRESHNESS_INTERVALS_COUNT stale periods — the
    primary is alive enough to dodge the connection monitor but not
    doing its freshness duty."""

    def __init__(self, data, timer: TimerService, bus, freshness_checker,
                 config, get_time: Optional[Callable[[], float]] = None):
        self._data = data
        self._timer = timer
        self._bus = bus
        self._freshness_checker = freshness_checker
        self._config = config
        self._get_time = get_time or timer.get_current_time
        self._repeating = None
        interval = config.STATE_FRESHNESS_UPDATE_INTERVAL
        if freshness_checker is not None and interval > 0:
            self._repeating = RepeatingTimer(timer, interval,
                                             self._check_freshness)

    def cleanup(self):
        if self._repeating is not None:
            self._repeating.stop()

    def _check_freshness(self):
        if self._is_state_fresh_enough():
            return
        logger.info("%s: state signatures stale — voting view change",
                    self._data.name)
        self._bus.send(VoteForViewChange(
            suspicion="STATE_SIGS_ARE_NOT_UPDATED"))

    def _is_state_fresh_enough(self) -> bool:
        if not self._data.node_mode_participating or \
                self._data.waiting_for_new_view:
            return True     # catching up / mid view change: not primary's fault
        threshold = (self._config.ACCEPTABLE_FRESHNESS_INTERVALS_COUNT
                     * self._config.STATE_FRESHNESS_UPDATE_INTERVAL)
        return self._state_age() < threshold

    def _state_age(self) -> float:
        oldest = min(
            (self._freshness_checker.get_last_update(lid)
             for lid in self._freshness_checker.ledger_ids),
            default=self._get_time())
        return self._get_time() - oldest


class ForcedViewChangeService:
    """Periodic forced view changes (chaos/debug tool, reference
    forced_view_change_service.py; disabled unless ForceViewChangeFreq
    is set > 0)."""

    def __init__(self, timer: TimerService, bus, config):
        self._bus = bus
        self._repeating = None
        freq = config.ForceViewChangeFreq
        if freq > 0:
            self._repeating = RepeatingTimer(timer, freq,
                                             self._force_view_change)

    def cleanup(self):
        if self._repeating is not None:
            self._repeating.stop()

    def _force_view_change(self):
        self._bus.send(VoteForViewChange(
            suspicion="DEBUG_FORCE_VIEW_CHANGE"))
