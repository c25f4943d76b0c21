"""ViewChangeService — the NEW_VIEW protocol.

Reference: plenum/server/consensus/view_change_service.py:
process_need_view_change (:71), _build_view_change_msg (:141),
process_view_change_message (:162), _send_new_view_if_needed (:242),
_finish_view_change (:314), NewViewBuilder.calc_checkpoint (:363) /
calc_batches (:398).

Flow: NeedViewChange → view_no += 1, broadcast VIEW_CHANGE carrying this
replica's prepared/preprepared evidence + checkpoints; every node acks
others' VIEW_CHANGEs to the NEW primary; the new primary, once it holds
n-f VIEW_CHANGEs (each confirmed by quorum of acks or direct receipt),
deterministically computes the checkpoint and batch set and broadcasts
NEW_VIEW; everyone validates it by recomputing the same decision.
"""
from __future__ import annotations

import hashlib
import logging
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from plenum_tpu_torch.common.config import Config
from plenum_tpu_torch.utils.metrics import MetricsName, NullMetricsCollector
from plenum_tpu_torch.common.messages.internal_messages import (
    NeedMasterCatchup, NeedViewChange, NewViewAccepted,
    NewViewCheckpointsApplied, VoteForViewChange, ViewChangeStarted)
from plenum_tpu_torch.common.messages.node_messages import (
    Checkpoint, MessageRep, MessageReq, NewView, ViewChange,
    ViewChangeAck)
from plenum_tpu_torch.common.serializers.serialization import serialize_msg_for_signing
from plenum_tpu_torch.consensus.batch_id import BatchID, batch_id_from
from plenum_tpu_torch.consensus.consensus_shared_data import ConsensusSharedData
from plenum_tpu_torch.observability.tracing import CAT_RECOVERY, NullTracer
from plenum_tpu_torch.observability.telemetry import TM, NullTelemetryHub
from plenum_tpu_torch.consensus.primary_selector import (
    RoundRobinConstantNodesPrimariesSelector)
from plenum_tpu_torch.runtime.stashing_router import DISCARD, StashingRouter
from plenum_tpu_torch.runtime.timer import RepeatingTimer, TimerService

logger = logging.getLogger(__name__)

STASH_FUTURE_VIEW = 7


def view_change_digest(vc: ViewChange) -> str:
    return hashlib.sha256(serialize_msg_for_signing(vc.as_dict())).hexdigest()


class NewViewBuilder:
    """Deterministic batch-set / checkpoint merge from n-f VIEW_CHANGEs
    (reference view_change_service.py:355-487). Pure functions of the
    input set — every honest node computes the same NEW_VIEW."""

    def __init__(self, data: ConsensusSharedData):
        self._data = data

    def calc_checkpoint(self, vcs: List[ViewChange]) -> Optional[dict]:
        """Highest checkpoint claimed by a weak quorum (f+1) and not
        ahead of a strong quorum's progress.

        Candidates are keyed by (seqNoEnd, digest) — NOT whole-dict
        equality: a CHK_FREQ-aligned checkpoint and a caught-up node's
        virtual checkpoint at the same position differ in bookkeeping
        fields (viewNo/seqNoStart) while agreeing on the part that
        matters. The returned dict is built canonically from the key, so
        the primary and every validator compute the identical value and
        ties cannot split on iteration order."""
        votes: Dict[tuple, int] = defaultdict(int)
        for vc in vcs:
            seen = set()
            for chk in vc.checkpoints:
                key = (chk["seqNoEnd"], chk["digest"])
                if key not in seen:
                    seen.add(key)
                    votes[key] += 1
        def can_participate_from(vc: ViewChange, end: int) -> bool:
            """stable ≤ end: the node re-orders forward from `end`.
            stable > end: the node is PAST the candidate — it already
            ordered everything up to its stable, and re-application
            skips seqs ≤ its last_ordered (ordering_service
            already_ordered guard), so it participates by skipping. A
            caught-up node at an unaligned position therefore never
            vetoes lower candidates (that veto deadlocked pools whose
            members caught up to distinct positions)."""
            if vc.stableCheckpoint <= end:
                return True
            return max((c["seqNoEnd"] for c in vc.checkpoints),
                       default=vc.stableCheckpoint) >= end

        best = None
        for (end, digest), have in votes.items():
            # at least f+1 replicas have this checkpoint
            if not self._data.quorums.weak.is_reached(have):
                continue
            # at least n-f replicas can participate after it
            reachable = sum(1 for vc in vcs
                            if can_participate_from(vc, end))
            if not self._data.quorums.strong.is_reached(reachable):
                continue
            if best is None or (end, digest) > best:
                best = (end, digest)
        if best is None:
            return None
        return Checkpoint(instId=self._data.inst_id, viewNo=0,
                          seqNoStart=best[0], seqNoEnd=best[0],
                          digest=best[1]).as_dict()

    def calc_batches(self, checkpoint: Optional[dict],
                     vcs: List[ViewChange]) -> Optional[List[BatchID]]:
        """Batches to re-order in the new view: PBFT-style merge —
        a batch is included if prepared in ≥ f+1 VIEW_CHANGEs (strong
        evidence it may have been ordered) or preprepared in ≥ n-f
        (could not have been ordered differently)."""
        if checkpoint is None:
            return None
        start = checkpoint["seqNoEnd"]
        max_seq = max((batch_id_from(b).pp_seq_no
                       for vc in vcs for b in vc.prepared + vc.preprepared),
                      default=start)
        batches: List[BatchID] = []
        for seq in range(start + 1, max_seq + 1):
            bid = self._select_batch_for_seq(seq, vcs)
            if bid is None:
                # nothing at all was pre-prepared here, so nothing after
                # it can have been ordered either (primaries allocate
                # seq_nos sequentially): safe end of the chain
                break
            batches.append(bid)
        return batches

    def _select_batch_for_seq(self, seq: int,
                              vcs: List[ViewChange]) -> Optional[BatchID]:
        """Deterministic choice for one seq_no. Safety: a batch ordered at
        this seq had n-f commits ⇒ n-f prepared ⇒ any n-f subset of
        VIEW_CHANGEs contains ≥ n-2f ≥ f+1 that prepared it, so it always
        shows up as a weak-quorum prepared candidate. If no candidate has
        weak-quorum prepared support, nothing was ordered here and any
        deterministic pick among pre-prepared candidates preserves
        consistency (everyone computes from the same referenced set)."""
        prepared_votes: Dict[Tuple, int] = defaultdict(int)
        preprepared_votes: Dict[Tuple, int] = defaultdict(int)
        for vc in vcs:
            for b in vc.prepared:
                b = batch_id_from(b)
                if b.pp_seq_no == seq:
                    prepared_votes[(b.pp_view_no, b.pp_digest)] += 1
            for b in vc.preprepared:
                b = batch_id_from(b)
                if b.pp_seq_no == seq:
                    preprepared_votes[(b.pp_view_no, b.pp_digest)] += 1
        best = None
        for (view, digest), votes in prepared_votes.items():
            if self._data.quorums.weak.is_reached(votes):
                if best is None or (view, digest) > best:
                    best = (view, digest)
        if best is None and preprepared_votes:
            # keep the chain contiguous: deterministic (votes, view,
            # digest)-max among pre-prepared candidates
            ranked = sorted(preprepared_votes.items(),
                            key=lambda kv: (kv[1], kv[0]))
            best = ranked[-1][0]
        if best is None:
            return None
        return BatchID(self._data.view_no, best[0], seq, best[1])


class ViewChangeService:
    def __init__(self, data: ConsensusSharedData, timer: TimerService,
                 bus, network, stasher: Optional[StashingRouter] = None,
                 config: Optional[Config] = None,
                 primaries_selector=None, digest_source=None):
        self._data = data
        self._timer = timer
        self._bus = bus
        self._network = network
        self._config = config or Config()
        self.metrics = NullMetricsCollector()  # node injects the real one
        self.tracer = NullTracer()             # node injects the real one
        self.telemetry = NullTelemetryHub()    # node injects the real one
        # consecutive FAILED view changes (NEW_VIEW timeout or computed
        # mismatch) since the last completed one: each failure doubles
        # the next NEW_VIEW wait up to NEW_VIEW_TIMEOUT_MAX (PBFT-style
        # escalation — colliding view changes need a widening window to
        # ever overlap); any success resets to the base timeout
        self.consecutive_failed_view_changes = 0
        # a mismatch counts ONCE per view: every straggler VIEW_CHANGE/
        # ack re-enters _finish_view_change and re-detects the same
        # mismatch — re-counting each would escalate straight to the cap
        self._mismatch_counted_view: Optional[int] = None
        self._selector = primaries_selector or \
            RoundRobinConstantNodesPrimariesSelector(data.validators)
        self._builder = NewViewBuilder(data)
        # MUST be the same source CheckpointService uses (audit root in
        # production), so virtual checkpoints match across nodes
        self._digest_source = digest_source or (lambda s: "chk-%d" % s)

        self._stasher = stasher or StashingRouter(limit=10000,
                                                  buses=[bus, network])
        self._stasher.subscribe(ViewChange, self.process_view_change_message)
        self._stasher.subscribe(ViewChangeAck, self.process_view_change_ack)
        self._stasher.subscribe(NewView, self.process_new_view_message)
        bus.subscribe(NeedViewChange, self.process_need_view_change)

        # view_no -> frm -> ViewChange
        self._view_changes: Dict[int, Dict[str, ViewChange]] = \
            defaultdict(dict)
        # future-view VIEW_CHANGE senders (join-on-f+1 evidence)
        self._future_vc_votes: Dict[int, set] = defaultdict(set)
        # view_no -> (frm, digest) -> set of ack senders
        self._acks: Dict[int, Dict[Tuple[str, str], set]] = \
            defaultdict(lambda: defaultdict(set))
        self._new_view: Optional[NewView] = None
        self._new_view_timer: Optional[RepeatingTimer] = None
        self._resend_timer: Optional[RepeatingTimer] = None
        # ---- view-change self-heal (MessageReq): a node that loses the
        # NEW_VIEW (or the referenced VIEW_CHANGEs it needs to validate
        # one) on a lossy wire has NO retransmission path — the 3PC
        # MessageReq gap scan is disabled mid view change, and without
        # re-requests the NEW_VIEW timeout just escalates into a vote
        # for view+1 that splits the pool further (found by the seeded
        # loss fuzz once the coalesced wire shifted which messages the
        # seed drops). While waiting_for_new_view a slow timer re-sends
        # our own VIEW_CHANGE and re-requests what's missing; peers
        # answer from their stores.
        network.subscribe(MessageReq, self.process_message_req)
        network.subscribe(MessageRep, self.process_message_rep)
        # solicited-reply guard: (msg_type, view_no, name) -> digest|""
        self._rep_requested: Dict[Tuple, str] = {}
        # a NEW_VIEW learned from a MESSAGE_RESPONSE is only trusted if
        # our own recomputation matches it — on mismatch it is dropped
        # (not escalated): the answerer, unlike the primary, proved
        # nothing by sending it
        self._nv_from_rep = False
        # staleness latch for a rep-learned NEW_VIEW: a forged one can
        # reference VIEW_CHANGE digests that exist NOWHERE, so it never
        # even reaches the recompute gate (the referenced-set quorum in
        # _finish_view_change stays unreachable) — without an expiry the
        # victim holds the forgery forever, re-requesting unobtainable
        # VIEW_CHANGEs instead of the real NEW_VIEW. A rep-learned
        # NEW_VIEW that fails to complete within one full re-request
        # period is discarded and the NEW_VIEW re-requested afresh: a
        # byzantine answer costs one period, not the view.
        self._nv_rep_stale = False

    # ------------------------------------------------------------ trigger

    def process_need_view_change(self, msg: NeedViewChange):
        proposed = msg.view_no if msg.view_no is not None \
            else self._data.view_no + 1
        if proposed <= self._data.view_no and self._data.view_no != 0:
            return
        # stamp only once the proposal is ACCEPTED — a rejected (stale)
        # NeedViewChange must not restart the duration clock of a view
        # change already in flight
        self._vc_started_at = time.perf_counter()
        self._start_view_change(proposed)

    def _start_view_change(self, proposed_view_no: int):
        old_view = self._data.view_no
        self._data.view_no = proposed_view_no
        self._data.waiting_for_new_view = True
        self._data.primary_name = self._selector.select_master_primary(
            proposed_view_no)
        self._new_view = None
        self._nv_from_rep = False
        self._nv_rep_stale = False
        for v in [v for v in self._future_vc_votes
                  if v <= proposed_view_no]:
            del self._future_vc_votes[v]
        logger.info("%s starting view change %d → %d (new primary %s)",
                    self._data.name, old_view, proposed_view_no,
                    self._data.primary_name)
        self.tracer.instant("view_change_start", CAT_RECOVERY,
                            key=str(proposed_view_no),
                            timeout=self.new_view_timeout())
        # pool-health bridge: view changes become a counted telemetry
        # trajectory, not just recovery-lane instants
        self.telemetry.count(TM.VIEW_CHANGES)
        # tell ordering to revert uncommitted + archive old-view PPs
        self._bus.send(ViewChangeStarted(view_no=proposed_view_no))
        vc = self._build_view_change_msg()
        self._view_changes[proposed_view_no][self._data.name] = vc
        self._network.send(vc)
        self._schedule_new_view_timeout()
        self._stasher.process_all_stashed(STASH_FUTURE_VIEW)
        self._try_finish()

    def _build_view_change_msg(self) -> ViewChange:
        checkpoints = [c.as_dict() for c in self._data.checkpoints]
        # VIRTUAL checkpoint at our last-ordered position: after catchup
        # a rejoining node's stable checkpoint sits at the caught-up seq
        # with no CHK_FREQ-aligned checkpoint anywhere to match it, which
        # would veto every candidate in NewViewBuilder.calc_checkpoint
        # (its stable > candidate end) and deadlock the view change.
        # Every node advertising its current position — digest from the
        # SHARED source (audit root) — guarantees caught-up nodes present
        # identical candidates. Fixed viewNo/seqNoStart so dict equality
        # holds across nodes regardless of when each ordered the batch.
        last = self._data.last_ordered_3pc[1]
        if not any(c.get("seqNoEnd") == last for c in checkpoints):
            checkpoints.append(Checkpoint(
                instId=self._data.inst_id, viewNo=0, seqNoStart=last,
                seqNoEnd=last,
                digest=self._digest_source(last)).as_dict())
        return ViewChange(
            viewNo=self._data.view_no,
            stableCheckpoint=self._data.stable_checkpoint,
            prepared=[list(b) for b in self._data.prepared],
            preprepared=[list(b) for b in self._data.preprepared],
            checkpoints=checkpoints,
        )

    def new_view_timeout(self) -> float:
        """The CURRENT NEW_VIEW wait: base doubled per consecutive
        failed view change, capped at NEW_VIEW_TIMEOUT_MAX."""
        base = self._config.NEW_VIEW_TIMEOUT
        cap = getattr(self._config, "NEW_VIEW_TIMEOUT_MAX",
                      Config.NEW_VIEW_TIMEOUT_MAX)
        return min(float(cap), float(base) * (
            2 ** min(self.consecutive_failed_view_changes, 16)))

    def _view_change_failed(self, reason: str, view_no: int):
        """Count a failed view change and escalate the running timer so
        the NEXT wait (this timer's re-fire and any view change started
        meanwhile) uses the doubled window."""
        self.consecutive_failed_view_changes += 1
        timeout = self.new_view_timeout()
        if self._new_view_timer is not None:
            self._new_view_timer.update_interval(timeout)
        self.tracer.instant("vc_timeout_escalated", CAT_RECOVERY,
                            key=str(view_no), reason=reason,
                            failed=self.consecutive_failed_view_changes,
                            next_timeout=timeout)
        logger.warning("%s view change %d failed (%s); consecutive "
                       "failures %d, NEW_VIEW timeout now %.1fs",
                       self._data.name, view_no, reason,
                       self.consecutive_failed_view_changes, timeout)

    def _schedule_new_view_timeout(self):
        self._cancel_timers()
        view_at_schedule = self._data.view_no

        def on_timeout():
            if self._data.waiting_for_new_view \
                    and self._data.view_no == view_at_schedule:
                logger.warning("%s NEW_VIEW timeout in view %d",
                               self._data.name, view_at_schedule)
                self._view_change_failed("NEW_VIEW_TIMEOUT",
                                         view_at_schedule)
                self._bus.send(VoteForViewChange(
                    suspicion="NEW_VIEW_TIMEOUT",
                    view_no=view_at_schedule + 1))

        self._new_view_timer = RepeatingTimer(
            self._timer, self.new_view_timeout(), on_timeout)
        self._resend_timer = RepeatingTimer(
            self._timer,
            getattr(self._config, "VIEW_CHANGE_REREQUEST_INTERVAL",
                    Config.VIEW_CHANGE_REREQUEST_INTERVAL),
            self._rerequest_missing)

    def _cancel_timers(self):
        if self._new_view_timer is not None:
            self._new_view_timer.stop()
            self._new_view_timer = None
        if self._resend_timer is not None:
            self._resend_timer.stop()
            self._resend_timer = None
        self._rep_requested.clear()

    def _rerequest_missing(self, from_timer: bool = True):
        """Periodic self-heal while waiting_for_new_view: re-send our
        own VIEW_CHANGE (peers and the new primary may have lost it)
        and re-request whatever blocks completion — the NEW_VIEW itself
        while we hold none, or the referenced VIEW_CHANGE messages we
        still miss once we do. Only PERIODIC (timer) invocations touch
        the rep-NEW_VIEW staleness latch: the inline call right after
        accepting a rep answer must not arm it, or a reply landing just
        before a timer tick would be discarded moments after it was
        learned instead of after the documented full period."""
        if not self._data.waiting_for_new_view:
            return
        view_no = self._data.view_no
        own = self._view_changes[view_no].get(self._data.name)
        if own is not None:
            self._network.send(own)
        inst_id = self._data.inst_id
        if from_timer and self._new_view is not None \
                and self._nv_from_rep:
            if self._nv_rep_stale:
                # the rep-learned NEW_VIEW survived a full re-request
                # period without completing — its references may be
                # fabrications nobody can serve. Discard and start over
                # from the NEW_VIEW request (honest answers re-land in
                # one round trip; a liar costs one more period).
                logger.warning(
                    "%s rep-learned NEW_VIEW for view %d stalled a full "
                    "re-request period — discarded, re-requesting",
                    self._data.name, view_no)
                self._new_view = None
                self._nv_from_rep = False
                self._nv_rep_stale = False
            else:
                self._nv_rep_stale = True
        if self._new_view is None:
            self._rep_requested[("NEW_VIEW", view_no, "")] = ""
            self._network.send(MessageReq(
                msg_type="NEW_VIEW",
                params={"instId": inst_id, "viewNo": view_no}))
            return
        have = self._view_changes[view_no]
        # sorted: set iteration follows the per-process str hash salt
        # (PT012) — re-request order must not differ across replicas
        for frm, digest in sorted(
                {tuple(x) for x in self._new_view.viewChanges}):
            if frm in have \
                    and view_change_digest(have[frm]) == digest:
                continue
            self._rep_requested[("VIEW_CHANGE", view_no, frm)] = digest
            self._network.send(MessageReq(
                msg_type="VIEW_CHANGE",
                params={"instId": inst_id, "viewNo": view_no,
                        "name": frm}))

    def process_message_req(self, req: MessageReq, frm: str):
        """Answer a peer's view-change re-request from our stores. Any
        node that holds the accepted NEW_VIEW (we keep it after
        finishing) or the asked-for VIEW_CHANGE can answer — not just
        the primary."""
        params = req.params or {}
        if params.get("instId") != self._data.inst_id:
            return
        view_no = params.get("viewNo")
        if view_no is None:
            return
        msg = None
        if req.msg_type == "NEW_VIEW":
            # never relay a rep-learned NEW_VIEW that has not passed our
            # own recomputation yet (_nv_from_rep clears on completion):
            # serving it would propagate a byzantine answerer's forgery
            # to every other node still missing the real one
            if self._new_view is not None \
                    and self._new_view.viewNo == view_no \
                    and not self._nv_from_rep:
                msg = self._new_view.as_dict()
        elif req.msg_type == "VIEW_CHANGE":
            vc = self._view_changes.get(view_no, {}).get(
                params.get("name"))
            if vc is not None:
                msg = vc.as_dict()
        if msg is not None:
            self._network.send(
                MessageRep(msg_type=req.msg_type, params=params, msg=msg),
                [frm])

    def process_message_rep(self, rep: MessageRep, frm: str):
        """A peer's answer to a view-change re-request. Only solicited
        replies are accepted, and a VIEW_CHANGE reply only counts when
        its content digest equals the digest the NEW_VIEW referenced
        for that node — a fabricated vote cannot match (the digest
        covers the whole message), so attribution to `name` is safe."""
        if rep.msg_type not in ("NEW_VIEW", "VIEW_CHANGE") \
                or rep.msg is None:
            return
        params = rep.params or {}
        if params.get("instId") != self._data.inst_id \
                or not self._data.waiting_for_new_view:
            return
        view_no = params.get("viewNo")
        if view_no != self._data.view_no:
            return
        # only message RECONSTRUCTION and digest validation live inside
        # the guard — attacker-controlled bytes can raise anything
        # there. Real processing runs outside it: an internal error in
        # our own view-change machinery must surface, not be swallowed
        # and blamed on the answering peer.
        nv = vc = vc_name = None
        try:
            if rep.msg_type == "NEW_VIEW":
                if ("NEW_VIEW", view_no, "") not in self._rep_requested:
                    return
                candidate = NewView(**rep.msg)
                if candidate.viewNo != view_no \
                        or self._new_view is not None:
                    return
                nv = candidate
            else:
                name = params.get("name")
                digest = self._rep_requested.get(
                    ("VIEW_CHANGE", view_no, name))
                if digest is None:
                    return
                candidate = ViewChange(**rep.msg)
                if candidate.viewNo != view_no \
                        or view_change_digest(candidate) != digest:
                    return
                vc, vc_name = candidate, name
        except Exception as e:   # malformed reply from a byzantine peer
            logger.warning("%s bad view-change MESSAGE_RESPONSE from "
                           "%s: %s", self._data.name, frm, e)
            return
        if nv is not None:
            self._new_view = nv
            self._nv_from_rep = True
            self._nv_rep_stale = False
            del self._rep_requested[("NEW_VIEW", view_no, "")]
            logger.info("%s recovered NEW_VIEW for view %d from %s",
                        self._data.name, view_no, frm)
            # pull the referenced VIEW_CHANGEs we miss right away
            # instead of waiting a whole re-request period (inline call:
            # must not arm the staleness latch)
            self._rerequest_missing(from_timer=False)
        else:
            del self._rep_requested[("VIEW_CHANGE", view_no, vc_name)]
            self.process_view_change_message(vc, vc_name)
        self._try_finish()

    # ----------------------------------------------------------- messages

    def process_view_change_message(self, vc: ViewChange, frm: str):
        if vc.viewNo < self._data.view_no:
            return (DISCARD, "old view change")
        if vc.viewNo > self._data.view_no:
            # f+1 distinct senders proposing the same higher view carry
            # at least one honest vote — join them (classic PBFT
            # liveness: a node whose own INSTANCE_CHANGE quorum never
            # formed must not ignore a view change the rest of the pool
            # is visibly running, or it wedges at the old view whenever
            # ordering resumes below the next checkpoint boundary)
            self._future_vc_votes[vc.viewNo].add(frm)
            if self._data.quorums.weak.is_reached(
                    len(self._future_vc_votes[vc.viewNo])):
                view_no = vc.viewNo
                logger.info(
                    "%s joining view change to %d on f+1 VIEW_CHANGE "
                    "evidence", self._data.name, view_no)
                self._bus.send(NeedViewChange(view_no=view_no))
                if self._data.view_no == view_no:
                    # adopted: fall through to normal processing (the
                    # stash replay inside ran before THIS message was
                    # stashed, so stashing it now would lose the vote)
                    return self.process_view_change_message(vc, frm)
            return (STASH_FUTURE_VIEW, "future view change")
        self._view_changes[vc.viewNo][frm] = vc
        # ack to the new primary (they may not have received it directly)
        primary = self._selector.select_master_primary(vc.viewNo)
        if self._data.name != primary and frm != primary:
            ack = ViewChangeAck(viewNo=vc.viewNo, name=frm,
                                digest=view_change_digest(vc))
            self._network.send(ack, [primary])
        self._try_finish()
        return None

    def process_view_change_ack(self, ack: ViewChangeAck, frm: str):
        if ack.viewNo < self._data.view_no:
            return (DISCARD, "old ack")
        if ack.viewNo > self._data.view_no:
            return (STASH_FUTURE_VIEW, "future ack")
        self._acks[ack.viewNo][(ack.name, ack.digest)].add(frm)
        self._try_finish()
        return None

    def process_new_view_message(self, nv: NewView, frm: str):
        if nv.viewNo < self._data.view_no:
            return (DISCARD, "old new view")
        if nv.viewNo > self._data.view_no:
            return (STASH_FUTURE_VIEW, "future new view")
        primary = self._selector.select_master_primary(nv.viewNo)
        if frm != primary:
            return (DISCARD, "NEW_VIEW from non-primary")
        if not self._data.waiting_for_new_view:
            return (DISCARD, "not in view change")
        self._new_view = nv
        self._nv_from_rep = False
        self._nv_rep_stale = False
        self._try_finish()
        return None

    # ------------------------------------------------------------- finish

    def _confirmed_view_changes(self, view_no: int
                                ) -> List[Tuple[str, ViewChange]]:
        """(sender, VIEW_CHANGE) pairs usable as NEW_VIEW evidence. The
        new primary only uses a VIEW_CHANGE once a quorum (n-f-1) of
        nodes confirms the same digest (acks from others + its own direct
        receipt) — a byzantine node cannot feed the primary a VIEW_CHANGE
        nobody else saw. Non-primaries recompute from direct receipts."""
        vcs = self._view_changes[view_no]
        if self._data.primary_name != self._data.name:
            return list(vcs.items())
        confirmed = []
        for frm, vc in vcs.items():
            if frm == self._data.name:
                confirmed.append((frm, vc))
                continue
            ackers = self._acks[view_no][(frm, view_change_digest(vc))]
            ackers = ackers - {frm, self._data.name}
            # the primary's own direct receipt counts as one confirmation
            # (otherwise a single dead node makes the quorum unreachable)
            if self._data.quorums.view_change_ack.is_reached(
                    len(ackers) + 1):
                confirmed.append((frm, vc))
        return confirmed

    def _try_finish(self):
        if not self._data.waiting_for_new_view:
            return
        view_no = self._data.view_no
        confirmed = self._confirmed_view_changes(view_no)
        if not self._data.quorums.view_change.is_reached(len(confirmed)):
            return
        i_am_primary = self._data.primary_name == self._data.name
        if i_am_primary and self._new_view is None:
            self._send_new_view(view_no, confirmed)
        if self._new_view is None:
            return
        self._finish_view_change(self._new_view)

    def _send_new_view(self, view_no: int,
                       confirmed: List[Tuple[str, ViewChange]]):
        """NEW_VIEW references EXACTLY the set it was computed from —
        validators recompute over the referenced set, so any mismatch
        between reference and computation would make honest nodes reject
        our own NEW_VIEW."""
        vcs = [vc for _, vc in confirmed]
        checkpoint = self._builder.calc_checkpoint(vcs)
        batches = self._builder.calc_batches(checkpoint, vcs)
        if batches is None:
            return  # not enough evidence yet; wait for more view changes
        nv = NewView(
            viewNo=view_no,
            viewChanges=sorted(
                [[frm, view_change_digest(vc)] for frm, vc in confirmed]),
            checkpoint=checkpoint,
            batches=[list(b) for b in batches],
        )
        self._new_view = nv
        self._nv_from_rep = False
        self._nv_rep_stale = False
        self._network.send(nv)

    def _finish_view_change(self, nv: NewView):
        # validate the primary's decision by recomputing it from our own
        # set of VIEW_CHANGEs (if we have them all)
        view_no = self._data.view_no
        have = self._view_changes[view_no]
        # sorted: `usable` feeds calc_checkpoint/calc_batches — the
        # recomputation of the primary's NEW_VIEW decision — and set
        # iteration order follows the per-process str hash salt
        # (PT012): replicas fed the identical NEW_VIEW must build the
        # identical usable list or their accept/reject verdicts could
        # split on tie-breaks
        referenced = sorted({tuple(x) for x in nv.viewChanges})
        usable = [have[frm] for frm, digest in referenced
                  if frm in have
                  and view_change_digest(have[frm]) == digest]
        if not self._data.quorums.view_change.is_reached(len(usable)):
            return  # wait until we hold the referenced VIEW_CHANGEs
        checkpoint = self._builder.calc_checkpoint(usable)
        batches = self._builder.calc_batches(checkpoint, usable)
        if checkpoint != nv.checkpoint or \
                [list(b) for b in (batches or [])] != \
                [list(batch_id_from(b)) for b in nv.batches]:
            if self._nv_from_rep:
                # a relayed NEW_VIEW that fails our recomputation is
                # evidence against the ANSWERER, not the primary: drop
                # it and keep waiting (the primary's direct NEW_VIEW —
                # or another answer — can still complete this view)
                logger.warning("%s relayed NEW_VIEW for view %d fails "
                               "recompute — discarded", self._data.name,
                               view_no)
                self._new_view = None
                self._nv_from_rep = False
                self._nv_rep_stale = False
                return
            logger.warning("%s NEW_VIEW mismatch — voting next view",
                           self._data.name)
            if self._mismatch_counted_view != view_no:
                self._mismatch_counted_view = view_no
                self._view_change_failed("NEW_VIEW_MISMATCH", view_no)
            self._bus.send(VoteForViewChange(
                suspicion="NEW_VIEW_MISMATCH", view_no=view_no + 1))
            return
        self._data.waiting_for_new_view = False
        # the NEW_VIEW just passed our recomputation — wherever it came
        # from, it is now validated and servable to peers' re-requests
        self._nv_from_rep = False
        self._nv_rep_stale = False
        self._cancel_timers()
        # a COMPLETED view change de-escalates: the next one starts
        # from the base NEW_VIEW_TIMEOUT again
        self.consecutive_failed_view_changes = 0
        started = getattr(self, "_vc_started_at", None)
        if started is not None:
            self.metrics.add_event(
                MetricsName.VIEW_CHANGE_TIME,
                time.perf_counter() - started)
            self._vc_started_at = None
        self.tracer.instant("view_change_done", CAT_RECOVERY,
                            key=str(view_no))
        self._bus.send(NewViewAccepted(
            view_no=view_no,
            view_changes=list(nv.viewChanges),
            checkpoint=checkpoint,
            batches=[batch_id_from(b) for b in nv.batches]))
        self._bus.send(NewViewCheckpointsApplied(
            view_no=view_no,
            view_changes=list(nv.viewChanges),
            checkpoint=checkpoint,
            batches=[batch_id_from(b) for b in nv.batches]))
        logger.info("%s completed view change to view %d",
                    self._data.name, view_no)
        if checkpoint is not None and \
                checkpoint["seqNoEnd"] > self._data.last_ordered_3pc[1]:
            # the agreed checkpoint is ahead of what we ordered: the
            # re-order set starts after it, so the gap is only
            # recoverable by catchup — adopting silently would skip
            # those batches forever and fork our state
            logger.info("%s behind new-view checkpoint (%d > %d) — "
                        "catching up", self._data.name,
                        checkpoint["seqNoEnd"],
                        self._data.last_ordered_3pc[1])
            self._bus.send(NeedMasterCatchup())

    def rearm_new_view_timeout(self):
        """Re-arm the NEW_VIEW timeout for the CURRENT data.view_no.
        Needed when catchup re-targets a pending view change (pool
        evidence raised data.view_no past the view the running timer
        was scheduled for): the timer's view guard would otherwise
        never fire again — no escalation, no further votes — and the
        node would wedge silently with reads still pinned."""
        if self._data.waiting_for_new_view:
            self._schedule_new_view_timeout()

    def absorb_view_from_catchup(self, ordered_view_no: int):
        """Catchup proved view >= `ordered_view_no` completed pool-wide
        (the audit ledger holds a batch ORDERED in that view — ordering
        only resumes after a NEW_VIEW lands). A node still waiting for
        that NEW_VIEW missed it, typically while disconnected, and no
        retransmission path exists: MessageReq only heals 3PC gaps and
        is disabled mid view change. Without this it wedges — stashing
        all new-view 3PC traffic, re-voting for view changes nobody
        else wants, and serving reads from its pinned root forever.
        Complete the view change from the catchup evidence instead:
        same bookkeeping as _finish_view_change, with nothing to
        re-order (catchup already delivered the committed batches)."""
        # evidence must be a batch ordered AT OR PAST the pending view,
        # and view >= 1: batches at view v (v >= 1) can only exist once
        # view v's NEW_VIEW completed, whereas view-0 batches predate
        # any view change and prove nothing about one
        if not self._data.waiting_for_new_view \
                or ordered_view_no < max(1, self._data.view_no):
            return
        view_no = self._data.view_no
        self._data.waiting_for_new_view = False
        self._new_view = None
        self._cancel_timers()
        self.consecutive_failed_view_changes = 0
        self._vc_started_at = None
        self.tracer.instant("view_change_done", CAT_RECOVERY,
                            key=str(view_no), absorbed="catchup")
        logger.info("%s view change to %d absorbed from catchup "
                    "evidence (pool ordered in view %d)",
                    self._data.name, view_no, ordered_view_no)
        self._bus.send(NewViewAccepted(
            view_no=view_no, view_changes=[], checkpoint=None,
            batches=[]))
