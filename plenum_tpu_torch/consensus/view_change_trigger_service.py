"""ViewChangeTriggerService — InstanceChange votes → NeedViewChange.

Reference: plenum/server/consensus/view_change_trigger_service.py (146 LoC)
+ plenum/server/view_change/instance_change_provider.py (vote cache with
TTL). Suspicions/timeouts become INSTANCE_CHANGE broadcasts; a strong
quorum (n-f) of votes for the same higher view — including our own —
starts the view change.
"""
from __future__ import annotations

import logging
from typing import Dict, Optional

from plenum_tpu_torch.common.config import Config
from plenum_tpu_torch.common.messages.internal_messages import (
    NeedViewChange, VoteForViewChange)
from plenum_tpu_torch.utils.metrics import MetricsName, NullMetricsCollector
from plenum_tpu_torch.common.messages.node_messages import InstanceChange
from plenum_tpu_torch.consensus.consensus_shared_data import ConsensusSharedData
from plenum_tpu_torch.runtime.stashing_router import DISCARD
from plenum_tpu_torch.runtime.timer import TimerService

logger = logging.getLogger(__name__)

GENERIC_SUSPICION_CODE = 25


class InstanceChangeCache:
    """view_no -> voter -> vote timestamp, with TTL expiry.

    Optionally persisted to a KV store (reference
    instance_change_provider.py backs its cache with nodeStatusDB): a
    node that restarts mid-vote-collection neither forgets peers' still-
    fresh votes nor re-counts expired ones — the TTL applies to the
    reloaded timestamps unchanged. Timestamps must come from a
    WALL-CLOCK timer (time.time, or a MockTimer pinned to an epoch) for
    persistence to be meaningful across restarts; reloaded votes whose
    age is negative (a process-relative clock like perf_counter, or a
    clock jump) are dropped rather than trusted forever."""

    _KEY = b"instance_change_votes"

    def __init__(self, timer: TimerService, ttl: float, store=None):
        self._timer = timer
        self._ttl = ttl
        self._store = store
        self._votes: Dict[int, Dict[str, float]] = {}
        if store is not None:
            try:
                import json
                raw = store.get(self._KEY)
                now = timer.get_current_time()
                for v, voters in json.loads(bytes(raw).decode()).items():
                    fresh = {voter: ts for voter, ts in voters.items()
                             if 0 <= now - ts <= ttl}
                    if fresh:
                        self._votes[int(v)] = fresh
            except KeyError:
                pass
            except Exception:
                logger.exception("corrupt instance-change vote cache; "
                                 "starting empty")

    def _save(self):
        if self._store is None:
            return
        # global sweep first: votes for scattered views that never reach
        # quorum must not accumulate forever (each lives at most TTL)
        now = self._timer.get_current_time()
        for v in list(self._votes):
            voters = self._votes[v]
            for voter in [x for x, ts in voters.items()
                          if now - ts > self._ttl]:
                del voters[voter]
            if not voters:
                del self._votes[v]
        import json
        self._store.put(self._KEY, json.dumps(
            {str(v): voters for v, voters in self._votes.items()}
        ).encode())

    def add_vote(self, view_no: int, voter: str):
        self._votes.setdefault(view_no, {})[voter] = \
            self._timer.get_current_time()
        self._save()

    def votes_summary(self) -> dict:
        """view_no -> voter list (validator-info IC_queue block).
        Expired votes are dropped first — the operator must see the
        same state the quorum logic counts."""
        for v in list(self._votes):
            self._expire(v)
        return {str(v): sorted(voters)
                for v, voters in self._votes.items()}

    def votes(self, view_no: int) -> int:
        self._expire(view_no)
        return len(self._votes.get(view_no, {}))

    def has_vote_from(self, view_no: int, voter: str) -> bool:
        self._expire(view_no)
        return voter in self._votes.get(view_no, {})

    def _expire(self, view_no: int):
        now = self._timer.get_current_time()
        votes = self._votes.get(view_no, {})
        stale = [v for v, ts in votes.items() if now - ts > self._ttl]
        for voter in stale:
            del votes[voter]
        if stale:
            self._save()

    def clear_below(self, view_no: int):
        cleared = [v for v in self._votes if v <= view_no]
        for v in cleared:
            del self._votes[v]
        if cleared:
            self._save()


class ViewChangeTriggerService:
    def __init__(self, data: ConsensusSharedData, timer: TimerService,
                 bus, network, config: Optional[Config] = None,
                 vote_store=None):
        self._data = data
        self._timer = timer
        self._bus = bus
        self._network = network
        self._config = config or Config()
        self.metrics = NullMetricsCollector()  # node injects the real one
        self._cache = InstanceChangeCache(
            timer, self._config.OUTDATED_INSTANCE_CHANGES_CHECK_INTERVAL,
            store=vote_store)
        bus.subscribe(VoteForViewChange, self.process_vote_for_view_change)
        network.subscribe(InstanceChange, self.process_instance_change)

    def process_vote_for_view_change(self, msg: VoteForViewChange):
        proposed = msg.view_no if msg.view_no is not None \
            else self._data.view_no + 1
        self._send_instance_change(proposed, msg.suspicion)

    def _send_instance_change(self, proposed_view_no: int, reason):
        code = getattr(reason, "code", GENERIC_SUSPICION_CODE)
        if not isinstance(code, int):
            code = GENERIC_SUSPICION_CODE
        msg = InstanceChange(viewNo=proposed_view_no, reason=code)
        self.metrics.add_event(MetricsName.INSTANCE_CHANGE_SENT, 1)
        logger.info("%s voting for view change to %d (%s)",
                    self._data.name, proposed_view_no, reason)
        self._cache.add_vote(proposed_view_no, self._data.name)
        self._network.send(msg)
        self._try_start(proposed_view_no)

    def process_instance_change(self, msg: InstanceChange, frm: str):
        if msg.viewNo == self._data.view_no \
                and self._data.waiting_for_new_view \
                and frm != self._data.name:
            # the one-ahead straggler deadlock: we already ADOPTED this
            # view change (our vote was consumed when it started) but
            # it cannot complete until the sender's side assembles the
            # same quorum — with a mute node, their count stalls at
            # n-f-1 forever while we uselessly vote for view+1.
            # Re-affirming our own vote for the PENDING view lets them
            # reach n-f and join us. Bounded: only in response to a
            # peer's vote, throttled to one resend per window.
            self._reaffirm_pending_vote(msg.viewNo)
            return None
        if msg.viewNo <= self._data.view_no:
            return (DISCARD, "instance change for current/old view")
        self._cache.add_vote(msg.viewNo, frm)
        self._try_start(msg.viewNo)
        return None

    def _reaffirm_pending_vote(self, view_no: int):
        now = self._timer.get_current_time()
        # throttle is per VIEW: a later view change deadlocking shortly
        # after the previous one re-affirmed must not wait out a stale
        # cross-view window
        last_view, last_at = getattr(self, "_last_reaffirm", (None, 0.0))
        if last_view == view_no and \
                now - last_at < self._config.VIEW_CHANGE_RESEND_TIMEOUT:
            return
        self._last_reaffirm = (view_no, now)
        logger.info("%s re-affirming instance-change vote for pending "
                    "view %d (peers still gathering the quorum)",
                    self._data.name, view_no)
        self._network.send(InstanceChange(viewNo=view_no,
                                          reason=GENERIC_SUSPICION_CODE))

    def _try_start(self, view_no: int):
        if view_no <= self._data.view_no:
            return
        votes = self._cache.votes(view_no)
        if not self._data.quorums.view_change.is_reached(votes):
            return
        if not self._cache.has_vote_from(view_no, self._data.name):
            # quorum of OTHERS without us: join anyway (we are behind)
            self._cache.add_vote(view_no, self._data.name)
        self._cache.clear_below(view_no)
        self._bus.send(NeedViewChange(view_no=view_no))
