"""OrderingService — the three-phase commit itself.

Reference: plenum/server/consensus/ordering_service.py (2,491 LoC):
batch creation (send_3pc_batch :1961, send_pre_prepare :2169),
PRE-PREPARE/PREPARE/COMMIT processing (:501/:223/:436), ordering
(_order_3pc_key :1482), and re-ordering after view change
(process_new_view_checkpoints_applied :2380).

Execution is delegated through the BatchExecutor seam (the request
pipeline implements it over ledgers + MPT state; tests use SimExecutor),
keeping this service pure protocol logic — deterministic, mock-timed,
network-agnostic. Bulk signature verification happens OUTSIDE this
service (requests arrive already finalized via quorum of PROPAGATEs), so
the TPU batch path never blocks 3PC.
"""
from __future__ import annotations

import hashlib
import logging
from abc import ABC, abstractmethod
from collections import OrderedDict, defaultdict
from typing import Dict, List, Optional, Set, Tuple

from plenum_tpu_torch.common.config import Config
from plenum_tpu_torch.observability.tracing import CAT_3PC, NullTracer
from plenum_tpu_torch.observability.telemetry import TM, NullTelemetryHub
from plenum_tpu_torch.utils.metrics import MetricsName, NullMetricsCollector
from plenum_tpu_torch.common.constants import AUDIT_LEDGER_ID, DOMAIN_LEDGER_ID
from plenum_tpu_torch.common.messages.internal_messages import (
    CheckpointStabilized, NeedViewChange, NewViewCheckpointsApplied,
    MasterReorderedAfterVC, RaisedSuspicion, ViewChangeStarted)
from plenum_tpu_torch.common.messages.node_messages import (
    Commit, NewView, OldViewPrePrepareReply, OldViewPrePrepareRequest,
    Ordered, PrePrepare, Prepare)
from plenum_tpu_torch.consensus.batch_id import BatchID, batch_id_from
from plenum_tpu_torch.consensus.consensus_shared_data import ConsensusSharedData
from plenum_tpu_torch.runtime.sanitizer import OwnershipSanitizer
from plenum_tpu_torch.runtime.stashing_router import (
    DISCARD, PROCESS, StashingRouter)
from plenum_tpu_torch.runtime.timer import TimerService

logger = logging.getLogger(__name__)

# stash buckets (any verdict >= STASH stashes into its own bucket)
STASH_VIEW_3PC = 2          # future view / waiting for NEW_VIEW
STASH_CATCH_UP = 3          # node is catching up
STASH_WATERMARKS = 4        # outside [h, H]
STASH_WAITING_PREDECESSOR = 5  # PRE-PREPARE arrived out of order
STASH_WAITING_REQUESTS = 8     # PRE-PREPARE references unknown requests

def digest_match_mask(expected: List[str], got: List[str]):
    """One pass over two aligned digest columns — the per-inbound-batch
    check that replaces per-message handler dispatch. Measured on this
    workload: a plain zip of C-level string compares beats numpy at
    every realistic envelope size (unicode array CONSTRUCTION is
    7x the whole comparison below ~64 items, and wire envelopes carry
    tens of votes, not thousands), so the column stays a Python list.
    The seam still isolates the policy: a future binary-digest column
    can swap in a frombuffer compare here without touching callers."""
    return [g == e for g, e in zip(got, expected)]

class SuspiciousNode(Exception):
    def __init__(self, node: str, code: int, reason: str, msg=None):
        super().__init__("suspicion {} on {}: {}".format(code, node, reason))
        self.node = node
        self.code = code
        self.reason = reason
        self.msg = msg


class Suspicions:
    """Byzantine suspicion codes (reference plenum/server/suspicion_codes.py)."""
    PPR_DIGEST_WRONG = 5
    PPR_STATE_WRONG = 14
    PPR_TXN_WRONG = 15
    PPR_AUDIT_TXN_ROOT_HASH_WRONG = 19
    PPR_TIME_WRONG = 16
    PR_DIGEST_WRONG = 8
    PR_STATE_WRONG = 17
    PR_TXN_WRONG = 18
    CM_BLS_SIG_WRONG = 21
    PPR_BLS_MULTISIG_WRONG = 22
    PPR_FRM_NON_PRIMARY = 2
    DUPLICATE_PPR_SENT = 3
    NEW_VIEW_INVALID_BATCHES = 26
    # structurally invalid flat wire envelope (truncated / corrupted /
    # over-length / bad offsets) — fully sender-attributable: the
    # envelope arrived whole on that peer's authenticated stream
    WIRE_MALFORMED = 30


class BatchExecutor(ABC):
    """Seam to the request/ledger pipeline (reference WriteRequestManager +
    node executeBatch glue)."""

    @abstractmethod
    def apply_batch(self, pre_prepare_digests: List[str], ledger_id: int,
                    pp_time: int, pp_digest: str = "",
                    original_view_no: int = None) -> Tuple[str, str, str]:
        """Apply finalized requests (by digest) as one uncommitted batch.
        ``pp_digest`` is the PrePrepare digest binding the batch content —
        known to the ordering service at apply time, recorded in the audit
        txn for recovery/audit provenance.  ``original_view_no`` is the
        view the batch was FIRST proposed in — audit txns must record it
        (not the current view) so re-applying an old-view PrePrepare after
        a view change reproduces the identical audit root (reference
        three_pc_batch.original_view_no + audit_batch_handler viewNo).
        → (state_root_b58, txn_root_b58, audit_root_b58)."""

    @abstractmethod
    def revert_unordered_batches(self) -> int:
        """Revert ALL uncommitted batches (view change). → count reverted."""

    @abstractmethod
    def revert_last_batch(self):
        """Revert only the newest applied (uncommitted) batch — used when
        ONE incoming PRE-PREPARE fails root comparison; earlier good
        batches must stay applied."""

    @abstractmethod
    def commit_batch(self, ordered: Ordered):
        """Durably commit the oldest applied batch."""

    def is_request_known(self, digest: str) -> bool:
        return True


class SimExecutor(BatchExecutor):
    """Deterministic executor for rung-2 consensus tests: 'roots' are a
    hash chain over batch digests; no real ledgers."""

    def __init__(self):
        self.committed_root = "genesis"
        self.applied: List[Tuple] = []
        self.committed: List[Ordered] = []

    def apply_batch(self, digests, ledger_id, pp_time, pp_digest="",
                    original_view_no=None):
        from plenum_tpu_torch.common.serializers.base58 import b58encode
        base = self.applied[-1][0] if self.applied else self.committed_root
        h = hashlib.sha256(
            (base + "|" + "|".join(digests)).encode()).digest()
        root = b58encode(h)
        self.applied.append((root, list(digests), ledger_id))
        return root, root, root

    def revert_unordered_batches(self) -> int:
        n = len(self.applied)
        self.applied = []
        return n

    def revert_last_batch(self):
        if self.applied:
            self.applied.pop()

    def commit_batch(self, ordered: Ordered):
        if self.applied:
            self.committed_root = self.applied.pop(0)[0]
        self.committed.append(ordered)


class OrderingService:
    def __init__(self, data: ConsensusSharedData, timer: TimerService,
                 bus, network, executor: BatchExecutor,
                 stasher: Optional[StashingRouter] = None,
                 config: Optional[Config] = None,
                 bls_bft_replica=None,
                 get_current_time=None,
                 freshness_checker=None):
        self._data = data
        self._timer = timer
        self._bus = bus
        self._network = network
        self._executor = executor
        self._config = config or Config()
        # pipeline ownership contract: when bound (pipelined node),
        # 3PC intake off the prod thread is a programming error, not
        # a race to debug later — fail loud at the seam. The guard is
        # the runtime sanitizer's region-pin API (one implementation
        # shared with the node-wide pins); until bind_owner_thread or
        # attach_sanitizer runs, every check is a no-op.
        self._sanitizer = OwnershipSanitizer(name=self.name)
        self.metrics = NullMetricsCollector()  # node injects the real one
        self.tracer = NullTracer()             # node injects the real one
        self.telemetry = NullTelemetryHub()    # node injects the real one
        # (view, ppSeqNo) -> perf_counter at first PP create/process:
        # the 3PC-stage latency histogram's start marks (popped at
        # order; cleared wholesale on view change / catchup)
        self._tm_3pc_t0: Dict[Tuple[int, int], float] = {}
        # journey plane: per-key quorum-close perf marks and last-vote
        # straggler margins for PREPARE/COMMIT — same lifecycle as
        # _tm_3pc_t0 (popped at order, cleared on view change,
        # truncated at catchup, GC'd at checkpoint stabilization)
        self._tm_prep_close: Dict[Tuple[int, int], float] = {}
        self._tm_com_close: Dict[Tuple[int, int], float] = {}
        self._tm_prep_margin: Dict[Tuple[int, int], float] = {}
        self._tm_com_margin: Dict[Tuple[int, int], float] = {}
        self._tm_q_maps = (self._tm_prep_close, self._tm_com_close,
                           self._tm_prep_margin, self._tm_com_margin)
        # a PRE-PREPARE carries ~72 wire bytes per request digest; a
        # batch big enough to push it past the transport frame limit
        # would be dropped by the stack and wedge ordering at the first
        # full batch — clamp the configured size to what always fits
        frame_cap = max(1, (self._config.MSG_LEN_LIMIT - 8192) // 72)
        self._max_batch_size = min(self._config.Max3PCBatchSize, frame_cap)
        if self._max_batch_size < self._config.Max3PCBatchSize:
            logger.warning(
                "Max3PCBatchSize %d exceeds what a PRE-PREPARE frame can "
                "carry under MSG_LEN_LIMIT=%d; clamped to %d",
                self._config.Max3PCBatchSize, self._config.MSG_LEN_LIMIT,
                self._max_batch_size)
        self._bls = bls_bft_replica
        self._freshness_checker = freshness_checker
        # optional hook: called with (view_no, pp_seq_no) after this
        # PRIMARY sends a batch (backup primaries persist it so a
        # restart resumes the seq — server/last_sent_pp_store.py)
        self.on_pp_sent = None
        self._get_time = get_current_time or (
            lambda: int(timer.get_current_time()))

        self._stasher = stasher or StashingRouter(
            limit=100000, buses=[bus, network])
        self._stasher.subscribe(PrePrepare, self.process_preprepare)
        self._stasher.subscribe(Prepare, self.process_prepare)
        self._stasher.subscribe(Commit, self.process_commit)
        self._stasher.subscribe(OldViewPrePrepareRequest,
                                self.process_old_view_preprepare_request)
        self._stasher.subscribe(OldViewPrePrepareReply,
                                self.process_old_view_preprepare_reply)
        bus.subscribe(ViewChangeStarted, self.process_view_change_started)
        bus.subscribe(NewViewCheckpointsApplied,
                      self.process_new_view_checkpoints_applied)
        bus.subscribe(CheckpointStabilized, self.process_checkpoint_stabilized)

        # finalized request digests awaiting ordering, per ledger
        self.requestQueues: Dict[int, OrderedDict] = defaultdict(OrderedDict)
        self._queue_entry_time: Dict[str, float] = {}

        # 3PC message logs, keyed (view_no, pp_seq_no)
        self.sent_preprepares: Dict[Tuple[int, int], PrePrepare] = {}
        self.prePrepares: Dict[Tuple[int, int], PrePrepare] = {}
        self.prepares: Dict[Tuple[int, int], Dict[str, Prepare]] = \
            defaultdict(dict)
        self.commits: Dict[Tuple[int, int], Dict[str, Commit]] = \
            defaultdict(dict)
        # incremental quorum counters — _has_prepared/_has_committed
        # used to SCAN the vote dicts per inbound message (O(n) per
        # message, O(n^2) per batch per node at 25 validators); the
        # counts are now maintained at insert/remove so the quorum
        # check is one dict read. prepare counter excludes the primary
        # (the prepare quorum is over non-primary voters).
        self._prepare_vote_count: Dict[Tuple[int, int], int] = {}
        self._commit_vote_count: Dict[Tuple[int, int], int] = {}
        # optional per-node coalescing outbox (ThreePCOutbox): broadcast
        # Prepare/Commit/PrePrepare ride ONE wire batch per tick instead
        # of a message each; None = legacy per-message sends
        self.outbox = None
        self.ordered: Set[Tuple[int, int]] = set()
        self.batches: Dict[Tuple[int, int], PrePrepare] = {}  # applied order
        # PrePrepares kept from the old view for re-ordering
        self.old_view_preprepares: Dict[Tuple[int, int, str], PrePrepare] = {}
        self._new_view_bids_to_reorder: List[BatchID] = []

        self.lastPrePrepareSeqNo = 0
        # highest pp_seq_no applied to uncommitted state, in order —
        # PRE-PREPAREs must apply sequentially or roots diverge
        self._last_applied_seq = 0
        self._first_batch_after_vc = False
        # highest seq covered by the latest NEW_VIEW's batch set: the
        # window in which PRE-PREPAREs at or below last_ordered may still
        # be (re-)processed (reference prev_view_prepare_cert)
        self._prev_view_prepare_cert = 0

    # ======================================================== properties

    @property
    def name(self):
        return self._data.name

    @property
    def view_no(self):
        return self._data.view_no

    @property
    def is_master(self):
        return self._data.is_master

    def _is_primary(self) -> bool:
        return self._data.is_primary

    # =========================================================== batching

    def add_finalized_request(self, digest: str,
                              ledger_id: int = DOMAIN_LEDGER_ID):
        """Owner feeds quorum-propagated requests here (reference
        Replica.readyFor3PC)."""
        self.add_finalized_requests((digest,), ledger_id)

    def add_finalized_requests(self, digests,
                               ledger_id: int = DOMAIN_LEDGER_ID):
        """Columnar variant: one propagate batch's worth of finalized
        digests enters the proposal queue in one call, and the stash
        replay / re-apply resume below runs ONCE per batch instead of
        once per request (the per-request replay was an O(stash) scan
        multiplied by every digest in the intake)."""
        q = self.requestQueues[ledger_id]
        now = self._timer.get_current_time()
        entry_time = self._queue_entry_time
        for digest in digests:
            if digest not in q:
                q[digest] = True
                entry_time[digest] = now
        # a stashed PRE-PREPARE may have been waiting for these requests
        self._stasher.process_all_stashed(STASH_WAITING_REQUESTS)
        # ...and so may a paused new-view re-apply (the re-order path
        # checks request availability like process_preprepare does, but
        # is driven directly, not through the stasher)
        if self._new_view_bids_to_reorder:
            self._reapply_ready_batches()

    def send_3pc_batch(self) -> int:
        """Primary: create and send batches if triggers fire. Called every
        prod tick (reference ordering_service.py:1961). → batches sent."""
        if not self._is_primary() or self._data.waiting_for_new_view:
            return 0
        if not self._data.node_mode_participating:
            return 0
        sent = 0
        for ledger_id in list(self.requestQueues.keys()):
            queue = self.requestQueues[ledger_id]
            if not queue:
                continue
            in_flight = self.lastPrePrepareSeqNo - self._data.last_ordered_3pc[1]
            if in_flight >= self._config.Max3PCBatchesInFlight:
                break
            full = len(queue) >= self._max_batch_size
            oldest = next(iter(queue), None)
            waited = (self._timer.get_current_time()
                      - self._queue_entry_time.get(oldest, 0))
            if not full and waited < self._config.Max3PCBatchWait:
                continue
            if not self._data.is_in_watermarks(self.lastPrePrepareSeqNo + 1):
                break
            with self.metrics.measure_time(MetricsName.PP_CREATE_TIME):
                self._send_one_batch(ledger_id, queue)
            sent += 1
        sent += self._send_freshness_batches()
        return sent

    def _send_freshness_batches(self) -> int:
        """EMPTY batches for ledgers whose signed state went stale
        (reference ordering_service.py send_3pc_freshness_batch): keeps
        BLS root signatures fresh with zero client traffic."""
        if self._freshness_checker is None:
            return 0
        sent = 0
        for ledger_id, _age in self._freshness_checker.get_outdated(
                self._get_time()):
            if self.requestQueues.get(ledger_id):
                continue    # real traffic queued: it will refresh anyway
            in_flight = (self.lastPrePrepareSeqNo
                         - self._data.last_ordered_3pc[1])
            if in_flight >= self._config.Max3PCBatchesInFlight:
                break
            if not self._data.is_in_watermarks(self.lastPrePrepareSeqNo + 1):
                break
            self._send_batch_of(ledger_id, [])
            # optimistic bump so one stale period emits one batch; the
            # ordered batch will set the real time
            self._freshness_checker.update_freshness(ledger_id,
                                                     self._get_time())
            sent += 1
        return sent

    def _send_one_batch(self, ledger_id: int, queue: OrderedDict):
        digests = []
        while queue and len(digests) < self._max_batch_size:
            d, _ = queue.popitem(last=False)
            self._queue_entry_time.pop(d, None)
            digests.append(d)
        self._send_batch_of(ledger_id, digests)

    def _send_batch_of(self, ledger_id: int, digests: List[str]):
        with self.tracer.span(
                "pp_create", CAT_3PC,
                key="%d:%d" % (self.view_no, self.lastPrePrepareSeqNo + 1),
                batch_size=len(digests), ledger_id=ledger_id):
            self._send_batch_of_inner(ledger_id, digests)

    def _send_batch_of_inner(self, ledger_id: int, digests: List[str]):
        self.metrics.add_event(MetricsName.THREE_PC_BATCH_SIZE,
                               len(digests))
        pp_seq_no = self.lastPrePrepareSeqNo + 1
        if self.telemetry.enabled:
            self._tm_3pc_t0[(self.view_no, pp_seq_no)] = \
                self.telemetry.clock()
        pp_time = self._get_time()
        pp_digest = self.generate_pp_digest(digests, self.view_no, pp_time)
        state_root, txn_root, audit_root = self._executor.apply_batch(
            digests, ledger_id, pp_time, pp_digest,
            original_view_no=self.view_no)
        params = dict(
            instId=self._data.inst_id,
            viewNo=self.view_no,
            ppSeqNo=pp_seq_no,
            ppTime=pp_time,
            reqIdr=digests,
            discarded="0",
            digest=pp_digest,
            ledgerId=ledger_id,
            stateRootHash=state_root,
            txnRootHash=txn_root,
            sub_seq_no=0,
            final=False,
            auditTxnRootHash=audit_root,
            originalViewNo=self.view_no,
        )
        if self._bls is not None:
            params = self._bls.update_pre_prepare(params, ledger_id)
        pp = PrePrepare(**params)
        self.lastPrePrepareSeqNo = pp_seq_no
        self._last_applied_seq = pp_seq_no
        self._data.pp_seq_no = pp_seq_no
        self.sent_preprepares[(self.view_no, pp_seq_no)] = pp
        self.prePrepares[(self.view_no, pp_seq_no)] = pp
        self.batches[(self.view_no, pp_seq_no)] = pp
        self._add_to_preprepared(pp)
        self._send_3pc(pp)
        if self.on_pp_sent is not None:
            self.on_pp_sent(self.view_no, pp_seq_no)
        self._try_prepared(pp)  # n=1 pools order immediately

    def _send_3pc(self, msg):
        """Broadcast one 3PC vote: coalesced through the node's outbox
        when attached (one THREE_PC_BATCH per tick on the wire), the
        plain per-message send otherwise."""
        if self.outbox is not None:
            self.outbox.queue(msg)
        else:
            self._network.send(msg)

    @staticmethod
    def generate_pp_digest(req_digests: List[str], original_view_no: int,
                           pp_time: int) -> str:
        # length-prefixed fields: no two distinct batch contents may
        # collide (['ab','c'] vs ['a','bc'] would without framing)
        h = hashlib.sha256()
        for field in [str(original_view_no), str(pp_time), *req_digests]:
            raw = field.encode()
            h.update(len(raw).to_bytes(4, "big"))
            h.update(raw)
        return h.hexdigest()

    # ====================================================== PRE-PREPARE

    def process_preprepare(self, pp: PrePrepare, frm: str):
        with self.metrics.measure_time(MetricsName.PP_PROCESS_TIME), \
                self.tracer.span("pp_process", CAT_3PC,
                                 key="%d:%d" % (pp.viewNo, pp.ppSeqNo),
                                 batch_size=len(pp.reqIdr), frm=frm,
                                 digest=pp.digest):
            return self._process_preprepare(pp, frm)

    def _process_preprepare(self, pp: PrePrepare, frm: str):
        verdict = self._validate_3pc(pp, frm)
        if verdict is not None:
            return verdict
        key = (pp.viewNo, pp.ppSeqNo)
        sender_is_primary = frm == self._data.primary_name
        if self._is_primary():
            # the primary does not process others' pre-prepares
            return (DISCARD, "primary ignores incoming PRE-PREPARE")
        if not sender_is_primary:
            self._raise_suspicion(frm, Suspicions.PPR_FRM_NON_PRIMARY,
                                  "PRE-PREPARE from non-primary", pp)
            return (DISCARD, "PRE-PREPARE from non-primary")
        # A PRE-PREPARE for a seq this node already ordered is only
        # acceptable during new-view re-ordering (the new primary
        # re-broadcasts old-view batches; peers that ordered them in the
        # old view must still vote so lagging peers reach quorum) — the
        # reference's has_already_ordered path (ordering_service.py:826,
        # 874 + msg_validator:140). Beyond the re-order window, discard.
        already_ordered = pp.ppSeqNo <= self._data.last_ordered_3pc[1]
        if already_ordered and pp.ppSeqNo > self._prev_view_prepare_cert:
            return (DISCARD, "already ordered")
        if self.is_master and not already_ordered \
                and pp.ppSeqNo > self._last_applied_seq + 1:
            # must apply in sequence or state roots diverge
            return (STASH_WAITING_PREDECESSOR, "out-of-order PRE-PREPARE")
        if self.is_master and not already_ordered and not all(
                self._executor.is_request_known(d) for d in pp.reqIdr):
            # normal reordering: our PROPAGATE quorum for one of the
            # requests hasn't completed yet — wait, don't crash/discard
            return (STASH_WAITING_REQUESTS, "unknown requests in batch")
        if key in self.prePrepares:
            if self.prePrepares[key].digest != pp.digest:
                self._raise_suspicion(frm, Suspicions.DUPLICATE_PPR_SENT,
                                      "conflicting PRE-PREPARE", pp)
            return (DISCARD, "duplicate PRE-PREPARE")
        # content checks
        if pp.digest != self.generate_pp_digest(
                list(pp.reqIdr), pp.originalViewNo
                if pp.originalViewNo is not None else pp.viewNo, pp.ppTime):
            self._raise_suspicion(frm, Suspicions.PPR_DIGEST_WRONG,
                                  "pp digest mismatch", pp)
            return (DISCARD, "wrong digest")
        deviation = abs(self._get_time() - pp.ppTime)
        if deviation > self._config.ACCEPTABLE_DEVIATION_PREPREPARE_SECS:
            self._raise_suspicion(frm, Suspicions.PPR_TIME_WRONG,
                                  "pp time too far off", pp)
            return (DISCARD, "bad ppTime")
        if self.is_master and (pp.stateRootHash is None
                               or pp.txnRootHash is None):
            # a PRE-PREPARE without roots would bypass the apply-and-
            # compare defense (e.g. one forged through a MESSAGE_RESPONSE)
            self._raise_suspicion(frm, Suspicions.PPR_STATE_WRONG,
                                  "PRE-PREPARE without root hashes", pp)
            return (DISCARD, "missing root hashes")
        if self._bls is not None:
            err = self._bls.validate_pre_prepare(pp, frm)
            if err:
                self._raise_suspicion(
                    frm, Suspicions.PPR_BLS_MULTISIG_WRONG, err, pp)
                return (DISCARD, "bad BLS in PRE-PREPARE")
        # apply and compare roots (only the master executes batches, and
        # only for batches not yet ordered — an already-ordered batch is
        # in committed state; re-applying it would corrupt the roots)
        if self.is_master and not already_ordered:
            state_root, txn_root, audit_root = self._executor.apply_batch(
                list(pp.reqIdr), pp.ledgerId, pp.ppTime, pp.digest,
                original_view_no=pp.originalViewNo
                if pp.originalViewNo is not None else pp.viewNo)
            if pp.stateRootHash is not None and state_root != pp.stateRootHash:
                self._executor.revert_last_batch()
                self._raise_suspicion(frm, Suspicions.PPR_STATE_WRONG,
                                      "state root mismatch", pp)
                return (DISCARD, "state root mismatch")
            if pp.txnRootHash is not None and txn_root != pp.txnRootHash:
                self._executor.revert_last_batch()
                self._raise_suspicion(frm, Suspicions.PPR_TXN_WRONG,
                                      "txn root mismatch", pp)
                return (DISCARD, "txn root mismatch")
            if pp.auditTxnRootHash is not None \
                    and audit_root != pp.auditTxnRootHash:
                self._executor.revert_last_batch()
                self._raise_suspicion(
                    frm, Suspicions.PPR_AUDIT_TXN_ROOT_HASH_WRONG,
                    "audit root mismatch", pp)
                return (DISCARD, "audit root mismatch")
        self.prePrepares[key] = pp
        self.batches[key] = pp
        # 3PC-stage start mark ONLY for a fully validated, accepted
        # PRE-PREPARE (an earlier pre-validation stamp let any peer
        # grow the map with garbage keys); the watermark-window cap is
        # a backstop against a byzantine primary spraying future seqs
        if self.telemetry.enabled and \
                len(self._tm_3pc_t0) <= self._config.LOG_SIZE * 2:
            self._tm_3pc_t0.setdefault(key, self.telemetry.clock())
        self.lastPrePrepareSeqNo = max(self.lastPrePrepareSeqNo, pp.ppSeqNo)
        if self.is_master and not already_ordered:
            self._last_applied_seq = pp.ppSeqNo
        self._consume_from_queue(pp)
        self._add_to_preprepared(pp)
        # drop any PREPAREs that arrived before this PRE-PREPARE and do
        # not match it — they must not count toward the prepared quorum
        stale = {s: p for s, p in self.prepares[key].items()
                 if p.digest != pp.digest}
        for sender, prep in stale.items():
            del self.prepares[key][sender]
            if sender != self._data.primary_name:
                self._prepare_vote_count[key] = \
                    self._prepare_vote_count.get(key, 1) - 1
            self._raise_suspicion(sender, Suspicions.PR_DIGEST_WRONG,
                                  "PREPARE digest mismatch", prep)
        if self._bls is not None:
            self._bls.process_pre_prepare(pp, frm)
        self._send_prepare(pp)
        # the successor may be waiting on us
        self._stasher.process_all_stashed(STASH_WAITING_PREDECESSOR)
        return None

    def _add_to_preprepared(self, pp: PrePrepare):
        bid = BatchID(pp.viewNo,
                      pp.originalViewNo if pp.originalViewNo is not None
                      else pp.viewNo,
                      pp.ppSeqNo, pp.digest)
        self._data.add_preprepared(bid)

    def _send_prepare(self, pp: PrePrepare):
        prepare = Prepare(
            instId=self._data.inst_id,
            viewNo=pp.viewNo,
            ppSeqNo=pp.ppSeqNo,
            ppTime=pp.ppTime,
            digest=pp.digest,
            stateRootHash=pp.stateRootHash,
            txnRootHash=pp.txnRootHash,
            auditTxnRootHash=pp.auditTxnRootHash,
        )
        if self._bls is not None:
            self._bls.process_prepare(prepare, self.name)
        self._add_prepare_vote((pp.viewNo, pp.ppSeqNo), self.name, prepare)
        self._send_3pc(prepare)
        self._try_prepared(pp)

    def _add_prepare_vote(self, key: Tuple[int, int], frm: str,
                          prepare: Prepare):
        """Record one PREPARE vote, keeping the incremental quorum
        counter exact (the prepare quorum excludes the primary)."""
        self._sanitizer.check("vote stores")
        self.prepares[key][frm] = prepare
        if frm != self._data.primary_name:
            count = self._prepare_vote_count[key] = \
                self._prepare_vote_count.get(key, 0) + 1
            if self.tracer.enabled or self.telemetry.enabled:
                self._note_vote("prepare", key, frm, count,
                                self._data.quorums.prepare,
                                self._tm_prep_close,
                                self._tm_prep_margin)

    def _note_vote(self, phase: str, key: Tuple[int, int], frm: str,
                   count: int, quorum, close_t: dict,
                   margin: dict) -> None:
        """Journey plane: the vote from ``frm`` just moved this key's
        counter to ``count`` — detect the quorum-close transition
        (naming the closing voter) and account votes landing after the
        close as per-peer straggler lateness. Purely advisory: nothing
        here feeds back into the vote stores or quorum checks, and the
        caller guards on tracer/telemetry being live so the default
        Null objects keep the vote path free."""
        if not quorum.is_reached(count):
            return
        if not quorum.is_reached(count - 1):
            # this vote supplied the quorum-closing ballot on this node
            if self.tracer.enabled:
                self.tracer.instant(phase + "_quorum", CAT_3PC,
                                    key="%d:%d" % key, closer=frm,
                                    votes=count)
            if self.telemetry.enabled and \
                    len(close_t) <= self._config.LOG_SIZE * 2:
                close_t[key] = self.telemetry.clock()
            return
        # straggler: the quorum was already closed when this vote landed
        if self.tracer.enabled:
            self.tracer.instant(phase + "_vote_late", CAT_3PC,
                                key="%d:%d" % key, frm=frm)
        if self.telemetry.enabled:
            t0 = close_t.get(key)
            if t0 is not None:
                late_ms = (self.telemetry.clock() - t0) * 1e3
                margin[key] = late_ms
                self.telemetry.observe_labeled(
                    TM.PEER_VOTE_LATENESS_MS, frm, late_ms)

    # ========================================================== PREPARE

    def process_prepare(self, prepare: Prepare, frm: str):
        with self.metrics.measure_time(MetricsName.PREPARE_PROCESS_TIME), \
                self.tracer.span(
                    "prepare_process", CAT_3PC,
                    key="%d:%d" % (prepare.viewNo, prepare.ppSeqNo),
                    frm=frm):
            return self._process_prepare(prepare, frm)

    def _process_prepare(self, prepare: Prepare, frm: str):
        verdict = self._validate_3pc(prepare, frm)
        if verdict is not None:
            return verdict
        key = (prepare.viewNo, prepare.ppSeqNo)
        if frm in self.prepares[key]:
            return (DISCARD, "duplicate PREPARE from {}".format(frm))
        pp = self.prePrepares.get(key)
        if pp is not None and prepare.digest != pp.digest:
            self._raise_suspicion(frm, Suspicions.PR_DIGEST_WRONG,
                                  "PREPARE digest mismatch", prepare)
            return (DISCARD, "PREPARE digest mismatch")
        self._add_prepare_vote(key, frm, prepare)
        if pp is not None:
            self._try_prepared(pp)
        return None

    # ------------------------------------- pipeline ownership contract

    def attach_sanitizer(self, sanitizer: OwnershipSanitizer) -> None:
        """Share the node-wide sanitizer (its region bindings and the
        vote-store/stash pins) instead of the service-local default.
        Call before bind_owner_thread so the prod binding lands on the
        shared instance."""
        self._sanitizer = sanitizer

    def bind_owner_thread(self, ident: int) -> None:
        """Pin 3PC intake to the prod thread (pipelined node). Every
        ``process_*_batch`` / ``process_*_columns`` call off that
        thread raises — the pipeline's ownership contract (workers
        parse, the prod thread counts votes) enforced at the seam
        instead of trusted by convention. Implemented as a sanitizer
        region pin: identical RuntimeError contract, one guard
        implementation for the whole node."""
        self._sanitizer.bind_region("prod", int(ident))
        self._sanitizer.pin("3PC intake", "prod")

    def _assert_owner(self) -> None:
        self._sanitizer.check("3PC intake")

    def process_prepare_batch(self, prepares: List[Prepare], frm: str):
        """Columnar PREPARE intake: one sender's wire batch processed in
        one pass — shared checks hoisted out of the per-item path, the
        digest column checked against the matching PRE-PREPAREs in ONE
        vectorized comparison, quorum counters bumped per item, and
        _try_prepared run once per touched batch instead of once per
        message."""
        self._assert_owner()
        with self.metrics.measure_time(MetricsName.PREPARE_PROCESS_TIME), \
                self.tracer.span("prepare_batch", CAT_3PC, frm=frm,
                                 n=len(prepares)):
            return self._process_prepare_batch(prepares, frm)

    def _process_prepare_batch(self, prepares: List[Prepare], frm: str):
        survivors = self._columnar_precheck(prepares, frm)
        if not survivors:
            return
        # vote inserts + digest columns for items whose PP is here
        prepares_store = self.prepares
        pre_prepares = self.prePrepares
        checked: List[Tuple[Prepare, PrePrepare]] = []
        touched: Dict[Tuple[int, int], PrePrepare] = {}
        for p in survivors:
            key = (p.viewNo, p.ppSeqNo)
            if frm in prepares_store[key]:
                continue   # duplicate PREPARE
            pp = pre_prepares.get(key)
            if pp is None:
                # PRE-PREPARE not here yet: store the vote, it counts
                # when the PP lands (same as the per-message path)
                self._add_prepare_vote(key, frm, p)
                continue
            checked.append((p, pp))
        if checked:
            mask = digest_match_mask(
                [pp.digest for _, pp in checked],
                [p.digest for p, _ in checked])
            for (p, pp), ok in zip(checked, mask):
                key = (p.viewNo, p.ppSeqNo)
                if frm in prepares_store[key]:
                    # duplicate WITHIN this envelope: an earlier entry
                    # for the same key won the insert while this one
                    # was already collected (first-valid-wins, exactly
                    # like sequential per-message processing)
                    continue
                if not ok:
                    self._raise_suspicion(frm, Suspicions.PR_DIGEST_WRONG,
                                          "PREPARE digest mismatch", p)
                    continue
                self._add_prepare_vote(key, frm, p)
                touched[key] = pp
        for pp in touched.values():
            self._try_prepared(pp)

    def _columnar_precheck(self, msgs: list, frm: str,
                           on_late=None) -> list:
        """The _validate_3pc verdicts for a whole single-sender batch:
        sender/instance/participation checked ONCE, the view/watermark
        integer compares inlined per item. Items that must stash are
        routed into the stasher's normal buckets (their per-message
        handlers replay them later); survivors are returned for the
        columnar fast path."""
        if not msgs:
            return msgs
        data = self._data
        inst_id = data.inst_id
        if frm not in data.validators:
            return []                       # DISCARD all: not a validator
        stash = self._stasher.stash
        if not data.node_mode_participating:
            for m in msgs:
                stash(STASH_CATCH_UP, m, frm)
            return []
        view_no = data.view_no
        waiting_nv = data.waiting_for_new_view
        low = data.low_watermark
        high = data.high_watermark
        out = []
        for m in msgs:
            if m.instId != inst_id:
                continue                    # DISCARD: wrong instance
            v = m.viewNo
            if v < view_no:
                if on_late is not None:
                    on_late(m, frm)
                continue                    # DISCARD: old view
            if v > view_no:
                stash(STASH_VIEW_3PC, m, frm)
                continue
            if waiting_nv:
                stash(STASH_VIEW_3PC, m, frm)
                continue
            s = m.ppSeqNo
            if s <= low:
                if on_late is not None:
                    on_late(m, frm)
                continue                    # DISCARD: below low watermark
            if s > high:
                stash(STASH_WATERMARKS, m, frm)
                continue
            out.append(m)
        return out

    def process_prepare_columns(self, cols, frm: str):
        """Flat-wire PREPARE intake: the parsed envelope columns
        (numpy views — no message objects were built on the receive
        path) run the vectorized precheck, the digest column check and
        the incremental quorum counters directly; a typed Prepare is
        materialized ONLY for the votes that enter the vote store, a
        stash bucket or a suspicion report."""
        self._assert_owner()
        with self.metrics.measure_time(MetricsName.PREPARE_PROCESS_TIME), \
                self.tracer.span("prepare_batch", CAT_3PC, frm=frm,
                                 n=cols.n):
            return self._process_prepare_columns(cols, frm)

    def _process_prepare_columns(self, cols, frm: str):
        idxs = self._precheck_columns(cols, frm)
        if not idxs:
            return
        prepares_store = self.prepares
        pre_prepares = self.prePrepares
        view_col = cols.view.tolist()
        seq_col = cols.seq.tolist()
        checked: List[Tuple[int, Tuple[int, int], PrePrepare]] = []
        touched: Dict[Tuple[int, int], PrePrepare] = {}
        for i in idxs:
            key = (view_col[i], seq_col[i])
            if frm in prepares_store[key]:
                continue   # duplicate PREPARE
            pp = pre_prepares.get(key)
            if pp is None:
                # PRE-PREPARE not here yet: store the vote, it counts
                # when the PP lands (same as the per-message path)
                p = cols.materialize(i)
                if p is None:
                    continue
                self._add_prepare_vote(key, frm, p)
                continue
            checked.append((i, key, pp))
        if checked:
            mask = digest_match_mask(
                [pp.digest for _, _, pp in checked],
                [cols.digest_hex(i) for i, _, _ in checked])
            for (i, key, pp), ok in zip(checked, mask):
                if frm in prepares_store[key]:
                    # duplicate WITHIN this envelope (first-valid-wins,
                    # exactly like sequential per-message processing)
                    continue
                p = cols.materialize(i)
                if p is None:
                    continue   # bad entry: dropped like the typed path
                if not ok:
                    self._raise_suspicion(frm, Suspicions.PR_DIGEST_WRONG,
                                          "PREPARE digest mismatch", p)
                    continue
                self._add_prepare_vote(key, frm, p)
                touched[key] = pp
        for pp in touched.values():
            self._try_prepared(pp)

    def process_commit_columns(self, cols, frm: str):
        """Flat-wire COMMIT intake: vectorized precheck over the
        parsed columns, counter bumps per stored vote, one _try_order
        per touched key. BLS share validation stays per item — each
        COMMIT carries its own share (inside the materialized vote the
        store needs anyway)."""
        self._assert_owner()
        with self.metrics.measure_time(MetricsName.COMMIT_PROCESS_TIME), \
                self.tracer.span("commit_batch", CAT_3PC, frm=frm,
                                 n=cols.n):
            return self._process_commit_columns(cols, frm)

    def _process_commit_columns(self, cols, frm: str):
        idxs = self._precheck_columns(
            cols, frm, on_late=self._late_commit_backfill)
        if not idxs:
            return
        commits_store = self.commits
        pre_prepares = self.prePrepares
        bls = self._bls
        view_col = cols.view.tolist()
        seq_col = cols.seq.tolist()
        touched: Dict[Tuple[int, int], PrePrepare] = {}
        for i in idxs:
            key = (view_col[i], seq_col[i])
            if frm in commits_store[key]:
                continue   # duplicate COMMIT
            c = cols.materialize(i)
            if c is None:
                continue
            pp = pre_prepares.get(key)
            if bls is not None and pp is not None:
                err = bls.validate_commit(c, frm, pp)
                if err:
                    self._raise_suspicion(frm, Suspicions.CM_BLS_SIG_WRONG,
                                          err, c)
                    continue
            self._add_commit_vote(key, frm, c)
            if pp is not None:
                touched[key] = pp
        for key, pp in touched.items():
            self._try_order(pp)
            if key in self.ordered and bls is not None:
                bls.retry_backfill(key, self.commits[key], pp,
                                   self._data.quorums)

    def _precheck_columns(self, cols, frm: str,
                          on_late=None) -> List[int]:
        """``_columnar_precheck`` evaluated over parsed flat columns:
        the sender/participation gates run once, then ONE pass of
        C-level int compares over the column values (``tolist`` of the
        numpy views — at wire-typical envelope sizes scalar compares
        beat numpy temporaries by an order of magnitude, the same
        measurement that shaped digest_match_mask). Items that must
        stash are materialized into the stasher's normal buckets;
        survivors are returned as column indices — no message objects
        exist for them."""
        n = cols.n
        data = self._data
        if frm not in data.validators:
            return []                       # DISCARD all: not a validator
        stash = self._stasher.stash
        inst_id = data.inst_id
        if not data.node_mode_participating:
            # a flat section is handed WHOLE to every instance present
            # in it, so the catch-up stash must keep only THIS
            # instance's rows — stashing all of them would multiply
            # every vote by the instance count (and let junk instIds
            # eat the bounded stash), where the per-message wire
            # discards wrong-instance votes before the stash verdict
            inst = cols.inst.tolist()
            for i in range(n):
                if inst[i] != inst_id:
                    continue
                m = cols.materialize(i)
                if m is not None:
                    stash(STASH_CATCH_UP, m, frm)
            return []
        view_no = data.view_no
        waiting_nv = data.waiting_for_new_view
        low = data.low_watermark
        high = data.high_watermark
        inst = cols.inst.tolist()
        view = cols.view.tolist()
        seq = cols.seq.tolist()
        out: List[int] = []
        for i in range(n):
            if inst[i] != inst_id:
                continue                    # DISCARD: wrong instance
            v = view[i]
            if v < view_no:
                if on_late is not None:
                    m = cols.materialize(i)
                    if m is not None:
                        on_late(m, frm)
                continue                    # DISCARD: old view
            if v > view_no or waiting_nv:
                m = cols.materialize(i)
                if m is not None:
                    stash(STASH_VIEW_3PC, m, frm)
                continue
            s = seq[i]
            if s <= low:
                if on_late is not None:
                    m = cols.materialize(i)
                    if m is not None:
                        on_late(m, frm)
                continue                    # DISCARD: below low watermark
            if s > high:
                m = cols.materialize(i)
                if m is not None:
                    stash(STASH_WATERMARKS, m, frm)
                continue
            out.append(i)
        return out

    def _has_prepared(self, key: Tuple[int, int]) -> bool:
        """Quorum n-f-1 of PREPAREs (non-primary nodes incl. self) —
        answered from the incremental counter, not a sender scan."""
        if key not in self.prePrepares:
            return False
        return self._data.quorums.prepare.is_reached(
            self._prepare_vote_count.get(key, 0))

    def _try_prepared(self, pp: PrePrepare):
        key = (pp.viewNo, pp.ppSeqNo)
        n = self._data.total_nodes
        if n > 1 and not self._has_prepared(key):
            return
        if key in self.ordered:
            return
        bid = BatchID(pp.viewNo,
                      pp.originalViewNo if pp.originalViewNo is not None
                      else pp.viewNo,
                      pp.ppSeqNo, pp.digest)
        if bid not in self._data.prepared:
            self._data.add_prepared(bid)
            self._data.last_batch_prepared = bid
            # quorum marker: PREPARE certificate reached on this node
            self.tracer.instant("prepared", CAT_3PC, key="%d:%d" % key,
                                votes=len(self.prepares[key]))
            self._send_commit(pp)
        self._try_order(pp)

    def _send_commit(self, pp: PrePrepare):
        key = (pp.viewNo, pp.ppSeqNo)
        params = dict(instId=self._data.inst_id, viewNo=pp.viewNo,
                      ppSeqNo=pp.ppSeqNo)
        if self._bls is not None:
            params = self._bls.update_commit(params, pp)
        commit = Commit(**params)
        self._add_commit_vote(key, self.name, commit)
        self._send_3pc(commit)

    def _add_commit_vote(self, key: Tuple[int, int], frm: str,
                         commit: Commit):
        self._sanitizer.check("vote stores")
        self.commits[key][frm] = commit
        count = self._commit_vote_count[key] = \
            self._commit_vote_count.get(key, 0) + 1
        if self.tracer.enabled or self.telemetry.enabled:
            self._note_vote("commit", key, frm, count,
                            self._data.quorums.commit,
                            self._tm_com_close, self._tm_com_margin)

    # =========================================================== COMMIT

    def process_commit(self, commit: Commit, frm: str):
        with self.metrics.measure_time(MetricsName.COMMIT_PROCESS_TIME), \
                self.tracer.span(
                    "commit_process", CAT_3PC,
                    key="%d:%d" % (commit.viewNo, commit.ppSeqNo),
                    frm=frm):
            return self._process_commit(commit, frm)

    def _process_commit(self, commit: Commit, frm: str):
        if commit.viewNo < self.view_no \
                or commit.ppSeqNo <= self._data.low_watermark:
            # superseded view or below the stable checkpoint:
            # _validate_3pc discards it below, but a late share for a
            # batch we DID order can still complete a missing BLS
            # multi-sig (proof liveness must survive a view change or a
            # checkpoint racing the last honest COMMIT)
            self._late_commit_backfill(commit, frm)
        verdict = self._validate_3pc(commit, frm)
        if verdict is not None:
            return verdict
        key = (commit.viewNo, commit.ppSeqNo)
        if frm in self.commits[key]:
            return (DISCARD, "duplicate COMMIT from {}".format(frm))
        if self._bls is not None:
            pp = self.prePrepares.get(key)
            if pp is not None:
                err = self._bls.validate_commit(commit, frm, pp)
                if err:
                    self._raise_suspicion(frm, Suspicions.CM_BLS_SIG_WRONG,
                                          err, commit)
                    return (DISCARD, "bad BLS sig in COMMIT")
        self._add_commit_vote(key, frm, commit)
        pp = self.prePrepares.get(key)
        if pp is not None:
            self._try_order(pp)
            if key in self.ordered and self._bls is not None:
                # late COMMIT on an already-ordered batch: if the batch
                # missed its bls_signatures quorum at ordering time
                # (e.g. a poisoned deferred share ate a slot), this
                # share may complete the multi-sig now — no batch stays
                # proof-less forever (cheap no-op otherwise)
                self._bls.retry_backfill(key, self.commits[key], pp,
                                         self._data.quorums)
        return None

    def _late_commit_backfill(self, commit: Commit, frm: str) -> bool:
        """COMMIT from a superseded view, or below the stable
        checkpoint, for a batch this node already ordered: it cannot
        affect consensus, but its BLS share may complete a multi-sig the
        batch missed at ordering time (a poisoned deferred share ate a
        quorum slot and the view changed, or the checkpoint stabilized,
        before enough honest shares landed). Cheap no-op unless the
        batch is registered proof-less. The BLS layer's own record
        decides, not `ordered`: a stable checkpoint drops the batch
        from `ordered` while its multi-sig may still be missing, and a
        gate on `ordered` would leave that proof missing for good."""
        if self._bls is None:
            return False
        key = (commit.viewNo, commit.ppSeqNo)
        if not self._bls.awaits_backfill(key):
            return False
        # the view change may have cleared the PrePrepare stores — the
        # BLS layer is key-driven, pp is informational only
        pp = self.prePrepares.get(key) or self.batches.get(key)
        candidates = dict(self.commits.get(key) or {})
        candidates.setdefault(frm, commit)
        return self._bls.retry_backfill(key, candidates, pp,
                                        self._data.quorums)

    def process_commit_batch(self, commits: List[Commit], frm: str):
        """Columnar COMMIT intake: one sender's wire batch in one pass
        (hoisted checks, counter bumps, one _try_order per touched
        key). BLS share validation stays per item — each COMMIT carries
        its own share."""
        self._assert_owner()
        with self.metrics.measure_time(MetricsName.COMMIT_PROCESS_TIME), \
                self.tracer.span("commit_batch", CAT_3PC, frm=frm,
                                 n=len(commits)):
            return self._process_commit_batch(commits, frm)

    def _process_commit_batch(self, commits: List[Commit], frm: str):
        survivors = self._columnar_precheck(
            commits, frm, on_late=self._late_commit_backfill)
        if not survivors:
            return
        commits_store = self.commits
        pre_prepares = self.prePrepares
        bls = self._bls
        touched: Dict[Tuple[int, int], PrePrepare] = {}
        for c in survivors:
            key = (c.viewNo, c.ppSeqNo)
            if frm in commits_store[key]:
                continue   # duplicate COMMIT
            pp = pre_prepares.get(key)
            if bls is not None and pp is not None:
                err = bls.validate_commit(c, frm, pp)
                if err:
                    self._raise_suspicion(frm, Suspicions.CM_BLS_SIG_WRONG,
                                          err, c)
                    continue
            self._add_commit_vote(key, frm, c)
            if pp is not None:
                touched[key] = pp
        for key, pp in touched.items():
            self._try_order(pp)
            if key in self.ordered and bls is not None:
                bls.retry_backfill(key, self.commits[key], pp,
                                   self._data.quorums)

    def process_preprepare_batch(self, pps: List[PrePrepare], frm: str):
        """PRE-PREPAREs from one wire batch: low-volume (one per
        instance per tick) but they must flow through the SAME stash/
        verdict machinery as singles — route each through the stasher."""
        self._assert_owner()
        route = self._stasher.route
        for pp in pps:
            route(pp, frm)

    def _has_committed(self, key: Tuple[int, int]) -> bool:
        return self._data.quorums.commit.is_reached(
            self._commit_vote_count.get(key, 0))

    def _try_order(self, pp: PrePrepare):
        key = (pp.viewNo, pp.ppSeqNo)
        if key in self.ordered:
            return
        n = self._data.total_nodes
        if n > 1:
            if not self._has_prepared(key) or not self._has_committed(key):
                return
        # order strictly in sequence
        if pp.ppSeqNo != self._data.last_ordered_3pc[1] + 1:
            return
        self._order(pp)
        # cascade: later batches may now be orderable
        next_key = (self.view_no, pp.ppSeqNo + 1)
        next_pp = self.prePrepares.get(next_key)
        if next_pp is not None:
            self._try_order(next_pp)

    def _consume_from_queue(self, pp: PrePrepare):
        """Requests inside a PrePrepare leave the proposal queue — a later
        primary must not re-propose them after a view change."""
        queue = self.requestQueues.get(pp.ledgerId)
        if queue is not None:
            for digest in pp.reqIdr:
                queue.pop(digest, None)
                self._queue_entry_time.pop(digest, None)

    def _order(self, pp: PrePrepare):
        with self.metrics.measure_time(MetricsName.ORDER_TIME), \
                self.tracer.span("order", CAT_3PC,
                                 key="%d:%d" % (pp.viewNo, pp.ppSeqNo),
                                 batch_size=len(pp.reqIdr),
                                 # digest↔batch join key for the
                                 # journey plane (advisory, read only
                                 # by observability/journey.py)
                                 digests=pp.reqIdr,
                                 commits=len(self.commits[
                                     (pp.viewNo, pp.ppSeqNo)])):
            return self._order_inner(pp)

    def _order_inner(self, pp: PrePrepare):
        key = (pp.viewNo, pp.ppSeqNo)
        t0 = self._tm_3pc_t0.pop(key, None)
        if t0 is not None:
            self.telemetry.observe(TM.STAGE_3PC_MS,
                                   (self.telemetry.clock() - t0) * 1e3)
        # quorum-close margins: lateness of the last straggler vote
        # observed before order (0 = every counted vote arrived by the
        # close) — the aggregate view of the journey plane's per-batch
        # straggler-wait attribution
        prep_margin = self._tm_prep_margin.pop(key, None)
        com_margin = self._tm_com_margin.pop(key, None)
        closed = self._tm_prep_close.pop(key, None)
        if closed is not None:
            self.telemetry.observe(TM.QUORUM_CLOSE_MARGIN_MS,
                                   prep_margin or 0.0)
        if self._tm_com_close.pop(key, None) is not None:
            self.telemetry.observe(TM.QUORUM_CLOSE_MARGIN_MS,
                                   com_margin or 0.0)
        self.ordered.add(key)
        self._data.last_ordered_3pc = key
        self._consume_from_queue(pp)
        if self._freshness_checker is not None:
            self._freshness_checker.update_freshness(pp.ledgerId, pp.ppTime)
        if self._bls is not None:
            self._bls.process_order(key, self.commits[key], pp,
                                    self._data.quorums)
        ordered = Ordered(
            instId=pp.instId,
            viewNo=pp.viewNo,
            valid_reqIdr=list(pp.reqIdr),
            invalid_reqIdr=[],
            ppSeqNo=pp.ppSeqNo,
            ppTime=pp.ppTime,
            ledgerId=pp.ledgerId,
            stateRootHash=pp.stateRootHash,
            txnRootHash=pp.txnRootHash,
            auditTxnRootHash=pp.auditTxnRootHash,
            primaries=[self._data.primary_name or ""],
            originalViewNo=pp.originalViewNo,
            digest=pp.digest,
        )
        self._bus.send(ordered)
        if self._new_view_bids_to_reorder:
            self._new_view_bids_to_reorder = [
                b for b in self._new_view_bids_to_reorder
                if b.pp_seq_no > pp.ppSeqNo]
            if not self._new_view_bids_to_reorder and self.is_master:
                self._bus.send(MasterReorderedAfterVC())

    # ======================================================= validation

    def _validate_3pc(self, msg, frm: str = None):
        """Common 3PC message validation verdicts (reference
        ordering_service_msg_validator.py)."""
        if msg.instId != self._data.inst_id:
            return (DISCARD, "wrong instance")
        if frm is not None and frm not in self._data.validators:
            # votes from non-members (e.g. a freshly demoted node whose
            # instances keep running) must not count toward any quorum
            return (DISCARD, "sender not a pool validator")
        if not self._data.node_mode_participating:
            return (STASH_CATCH_UP, "catching up")
        if msg.viewNo < self.view_no:
            return (DISCARD, "old view")
        if msg.viewNo > self.view_no:
            return (STASH_VIEW_3PC, "future view")
        if self._data.waiting_for_new_view:
            return (STASH_VIEW_3PC, "waiting for NEW_VIEW")
        if msg.ppSeqNo <= self._data.low_watermark:
            return (DISCARD, "below low watermark")
        if msg.ppSeqNo > self._data.high_watermark:
            return (STASH_WATERMARKS, "above high watermark")
        return None

    def _raise_suspicion(self, frm: str, code: int, reason: str, msg):
        self._bus.send(RaisedSuspicion(
            inst_id=self._data.inst_id,
            ex=SuspiciousNode(frm, code, reason, msg)))

    # ===================================================== view changes

    def process_view_change_started(self, msg: ViewChangeStarted):
        """Revert uncommitted work; keep old-view PrePrepares for
        re-ordering (reference ordering_service view_change hooks)."""
        # obsolete the previous NEW_VIEW's re-order set FIRST: the
        # add_finalized_request calls below must not resume a stale
        # re-apply onto the state we are about to revert (the coming
        # NEW_VIEW defines a fresh set)
        self._new_view_bids_to_reorder = []
        if self.is_master:
            self._executor.revert_unordered_batches()
        self._last_applied_seq = self._data.last_ordered_3pc[1]
        # reverted (unordered) requests go back in the queue: if NEW_VIEW
        # re-orders them they are consumed again at re-apply; if not, the
        # new primary re-proposes them
        for key, pp in list(self.prePrepares.items()) + \
                list(self.sent_preprepares.items()):
            if pp.ppSeqNo > self._data.last_ordered_3pc[1]:
                for digest in pp.reqIdr:
                    self.add_finalized_request(digest, pp.ledgerId)
        for key, pp in self.prePrepares.items():
            ov = pp.originalViewNo if pp.originalViewNo is not None \
                else pp.viewNo
            self.old_view_preprepares[(ov, pp.ppSeqNo, pp.digest)] = pp
        for key, pp in self.sent_preprepares.items():
            ov = pp.originalViewNo if pp.originalViewNo is not None \
                else pp.viewNo
            self.old_view_preprepares[(ov, pp.ppSeqNo, pp.digest)] = pp
        self.sent_preprepares.clear()
        self.prePrepares.clear()
        self.prepares.clear()
        self.commits.clear()
        self._prepare_vote_count.clear()
        self._commit_vote_count.clear()
        self.batches.clear()
        # stale 3PC-latency start marks die with the view's vote state
        self._tm_3pc_t0.clear()
        for m in self._tm_q_maps:
            m.clear()

    def process_new_view_checkpoints_applied(
            self, msg: NewViewCheckpointsApplied):
        """Re-order batches chosen by the NEW_VIEW (reference :2380).
        Re-application is strictly sequential: a missing old-view
        PrePrepare pauses everything after it until the reply arrives —
        applying out of order would diverge the uncommitted state."""
        # ALL batches in the NEW_VIEW re-enter 3PC — including ones this
        # node already ordered in the old view: it must still register
        # them and vote PREPARE/COMMIT so peers that had NOT ordered them
        # can reach quorum in the new view (reference processes every
        # NEW_VIEW batch through process_preprepare; has_already_ordered
        # only skips apply/execute, ordering_service.py:826,874).
        pending = sorted((batch_id_from(b) for b in msg.batches),
                         key=lambda b: b.pp_seq_no)
        self._new_view_bids_to_reorder = list(pending)
        self._prev_view_prepare_cert = max(
            (b.pp_seq_no for b in pending), default=0)
        missing = [b for b in pending if self.old_view_preprepares.get(
            (b.pp_view_no, b.pp_seq_no, b.pp_digest)) is None]
        if missing:
            req = OldViewPrePrepareRequest(
                instId=self._data.inst_id,
                batch_ids=[list(b) for b in missing])
            self._network.send(req)
        self.lastPrePrepareSeqNo = self._data.last_ordered_3pc[1]
        self._reapply_ready_batches()
        if not msg.batches and self.is_master:
            self._bus.send(MasterReorderedAfterVC())

    def _reapply_ready_batches(self):
        """Re-apply pending new-view batches in sequence, stopping at the
        first one whose old-view PrePrepare we still lack (or that fails
        validation and must be re-fetched from another node)."""
        for bid in sorted(self._new_view_bids_to_reorder,
                          key=lambda b: b.pp_seq_no):
            if (self.view_no, bid.pp_seq_no) in self.prePrepares:
                continue  # already re-applied
            if self.is_master and \
                    bid.pp_seq_no > self._last_applied_seq + 1 and \
                    bid.pp_seq_no > self._data.last_ordered_3pc[1] + 1:
                # gap below this batch (we accepted a NEW_VIEW checkpoint
                # ahead of our own ordering): applying would run it onto
                # state missing its predecessors and loop on root
                # mismatches — wait for catchup (on_catchup_finished
                # resumes us). _last_applied_seq advances per re-apply,
                # so sequential re-ordering of many batches is unaffected.
                break
            pp = self.old_view_preprepares.get(
                (bid.pp_view_no, bid.pp_seq_no, bid.pp_digest))
            if pp is None:
                break  # wait for OldViewPrePrepareReply
            if not self._reapply_old_view_preprepare(bid, pp):
                break  # bad stored PP dropped; wait for a fresh reply

    def _reapply_old_view_preprepare(self, bid: BatchID,
                                     old_pp: PrePrepare) -> bool:
        """Re-apply one old-view PrePrepare chosen by the NEW_VIEW.

        Replies to OldViewPrePrepareRequest come from untrusted peers, so
        the PP gets the same content defenses as process_preprepare
        (reference routes these through the full processing path): the
        digest must be recomputable from the content, and on the master
        the apply result must reproduce the PP's claimed roots.  A forged
        PP whose digest field merely matches the NEW_VIEW BatchID is
        dropped and re-requested from the other nodes."""
        if old_pp.digest != self.generate_pp_digest(
                list(old_pp.reqIdr), bid.pp_view_no, old_pp.ppTime):
            self._discard_bad_old_view_pp(bid, "digest mismatch")
            return False
        params = dict(old_pp.as_dict())
        params["viewNo"] = self.view_no
        params["originalViewNo"] = bid.pp_view_no
        pp = PrePrepare(**params)
        key = (pp.viewNo, pp.ppSeqNo)
        already_ordered = pp.ppSeqNo <= self._data.last_ordered_3pc[1]
        if self.is_master and not already_ordered and not all(
                self._executor.is_request_known(d) for d in pp.reqIdr):
            # same contract as process_preprepare's
            # STASH_WAITING_REQUESTS: our PROPAGATE quorum for one of
            # the batch's requests hasn't completed yet (a node that
            # slept through the original proposal can hold the PP but
            # not the request). Pause the sequential re-apply — NOT a
            # bad-PP discard — and add_finalized_request resumes it
            # when the request lands. Applying would KeyError and kill
            # the prod loop mid-view-change.
            return False
        if self.is_master and not already_ordered:
            if pp.stateRootHash is None or pp.txnRootHash is None:
                self._discard_bad_old_view_pp(bid, "missing root hashes")
                return False
            state_root, txn_root, audit_root = self._executor.apply_batch(
                list(pp.reqIdr), pp.ledgerId, pp.ppTime, pp.digest,
                original_view_no=bid.pp_view_no)
            if (state_root != pp.stateRootHash
                    or txn_root != pp.txnRootHash
                    or (pp.auditTxnRootHash is not None
                        and audit_root != pp.auditTxnRootHash)):
                self._executor.revert_last_batch()
                self._discard_bad_old_view_pp(bid, "root mismatch")
                return False
            self._last_applied_seq = pp.ppSeqNo
        self.prePrepares[key] = pp
        self.batches[key] = pp
        self.lastPrePrepareSeqNo = max(self.lastPrePrepareSeqNo, pp.ppSeqNo)
        self._consume_from_queue(pp)
        self._add_to_preprepared(pp)
        if self._is_primary():
            self.sent_preprepares[key] = pp
            self._network.send(pp)
            self._try_prepared(pp)
        else:
            self._send_prepare(pp)
        return True

    def _discard_bad_old_view_pp(self, bid: BatchID, reason: str):
        """Drop a stored old-view PP that failed re-validation and ask the
        rest of the pool for the real one."""
        self.old_view_preprepares.pop(
            (bid.pp_view_no, bid.pp_seq_no, bid.pp_digest), None)
        req = OldViewPrePrepareRequest(
            instId=self._data.inst_id, batch_ids=[list(bid)])
        self._network.send(req)

    def process_old_view_preprepare_request(
            self, msg: OldViewPrePrepareRequest, frm: str):
        pps = []
        for bid in msg.batch_ids:
            bid = batch_id_from(bid)
            pp = self.old_view_preprepares.get(
                (bid.pp_view_no, bid.pp_seq_no, bid.pp_digest))
            if pp is not None:
                pps.append(pp.as_dict())
        if pps:
            self._network.send(
                OldViewPrePrepareReply(instId=self._data.inst_id,
                                       preprepares=pps), [frm])
        return None

    def process_old_view_preprepare_reply(self, msg: OldViewPrePrepareReply,
                                          frm: str):
        for pp_dict in msg.preprepares:
            try:
                pp = PrePrepare(**pp_dict)
            except Exception:
                continue
            ov = pp.originalViewNo if pp.originalViewNo is not None \
                else pp.viewNo
            self.old_view_preprepares[(ov, pp.ppSeqNo, pp.digest)] = pp
        # whatever is now contiguous from the front can be re-applied
        self._reapply_ready_batches()
        return None

    def prepare_for_catchup(self):
        """Catchup is about to make the pool's committed history
        authoritative: un-register ALL 3PC state above last_ordered (the
        caller reverts the executor's uncommitted batches). Without this
        a surviving PrePrepare could reach commit quorum after catchup
        and 'order' with nothing staged — silently dropping its txns.
        Un-ordered requests go back to the queues; if the pool did order
        them, catchup + the dedup index neutralize the re-proposal."""
        last = self._data.last_ordered_3pc[1]
        for key, pp in list(self.prePrepares.items()) + \
                list(self.sent_preprepares.items()):
            if pp.ppSeqNo > last:
                for digest in pp.reqIdr:
                    self.add_finalized_request(digest, pp.ledgerId)
        for store in (self.sent_preprepares, self.prePrepares,
                      self.prepares, self.commits, self.batches,
                      self._prepare_vote_count, self._commit_vote_count,
                      self._tm_3pc_t0) + self._tm_q_maps:
            for k in [k for k in store if k[1] > last]:
                del store[k]
        # the dropped batches must not be advertised as prepared evidence
        # in a later VIEW_CHANGE — nobody could supply their PrePrepares
        self._data.preprepared = [b for b in self._data.preprepared
                                  if b.pp_seq_no <= last]
        self._data.prepared = [b for b in self._data.prepared
                               if b.pp_seq_no <= last]
        self.lastPrePrepareSeqNo = last
        self._last_applied_seq = last

    # ====================================================== checkpoints

    def process_checkpoint_stabilized(self, msg: CheckpointStabilized):
        """GC 3PC logs at or below the stable checkpoint (reference
        ordering_service.py:2459 gc)."""
        stable_seq = msg.last_stable_3pc[1]
        for store in (self.sent_preprepares, self.prePrepares,
                      self.prepares, self.commits, self.batches,
                      self._prepare_vote_count, self._commit_vote_count,
                      self._tm_3pc_t0) + self._tm_q_maps:
            for key in [k for k in store if k[1] <= stable_seq]:
                del store[key]
        self.ordered = {k for k in self.ordered if k[1] > stable_seq}
        self._stasher.process_all_stashed(STASH_WATERMARKS)

    # ============================================================= misc

    def on_catchup_finished(self):
        self._stasher.process_all_stashed(STASH_CATCH_UP)
        # a node that accepted a NEW_VIEW while behind its checkpoint
        # paused re-ordering (the gap below the re-order set is only
        # coverable by catchup) — resume now that the gap is filled
        if self._new_view_bids_to_reorder:
            self._reapply_ready_batches()

    def on_view_change_completed(self):
        self._stasher.process_all_stashed(STASH_VIEW_3PC)
