"""NodeBatchExecutor — the real BatchExecutor over ledgers + MPT state.

Bridges OrderingService (which speaks request digests and roots) to the
WriteRequestManager pipeline (reference: the Node.executeBatch /
apply_reqs glue, plenum/server/node.py:2661 + ordering_service
create_3pc_batch). Replaces SimExecutor in full-node pools.

Shard-parallel deterministic execution (docs/execution.md): each
ordered batch runs through three sub-stages, each its own flight-
recorder span so ``scripts/trace_budget`` attributes the execute
budget line by line:

* ``exec_validate`` — resolve every request, collect the handlers'
  declared state touches (``WriteRequestHandler.touched_keys``),
  partition the batch into deterministic execution lanes (union-find
  over shared keys, server/execution_lanes.py), pre-invalidate handler
  read caches for the batch's declared writes, and prefetch every
  declared read key's pre-batch value in ONE deduplicated walk per
  state (``PruningState.begin_read_window``).
* ``lane_apply`` — the per-request validate→apply stream in batch
  order (the canonical schedule every schedule must be byte-equal to);
  validation reads are dict hits against pending-buffer + read window.
* ``hash_resolve`` — ONE merged hash resolution for every state the
  batch wrote (``flush_states_merged``: per-state bulk structural
  merge, then all states' dirty nodes hashed in shared level-wise
  SHA3 dispatches), overlapped with the ledger leaf-hash launches and
  the verifier-hub kick inside the fused device window.

Lane assignment is a pure function of the ordered batch — every honest
node partitions identically — and the applied state is a function of
batch order alone, so lanes can never diverge roots (tests +
bench gate assert byte-equality against the serial path).
"""
from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional, Tuple

from plenum_tpu_torch.common.constants import AUDIT_LEDGER_ID
from plenum_tpu_torch.common.messages.node_messages import Ordered
from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.consensus.ordering_service import BatchExecutor
from plenum_tpu_torch.observability.tracing import (
    CAT_DEVICE, CAT_EXECUTE, NullTracer)
from plenum_tpu_torch.observability.telemetry import TM, NullTelemetryHub
from plenum_tpu_torch.server.execution_lanes import exec_fanout, plan_lanes
from plenum_tpu_torch.server.three_pc_batch import ThreePcBatch
from plenum_tpu_torch.server.write_request_manager import WriteRequestManager
from plenum_tpu_torch.state.pruning_state import flush_states_merged
from plenum_tpu_torch.utils.metrics import MetricsName, NullMetricsCollector

logger = logging.getLogger(__name__)


class NodeBatchExecutor(BatchExecutor):
    def __init__(self, write_manager: WriteRequestManager,
                 requests_source: Callable[[str], Optional[Request]],
                 get_view_no: Callable[[], int] = None,
                 primaries_for_view: Callable[[int], List[str]] = None,
                 get_pp_seq_no: Callable[[], int] = None,
                 on_batch_committed: Callable = None,
                 on_request_rejected: Callable[[str, str, int],
                                               None] = None,
                 fused_dispatch: bool = True,
                 device_kick: Callable[[], None] = None,
                 lanes: bool = None, lane_min: int = None,
                 merged_device_hash=None):
        """requests_source(digest) → Request (the propagator's store).
        get_pp_seq_no() → seq of the batch being applied NOW (the
        ordering service's apply position + 1) — must survive catchup
        fast-forwards and view changes, so it cannot be a local counter.
        primaries_for_view(view_no) → primaries of that view — keyed by
        the batch's ORIGINAL view so re-applied batches reproduce the
        same audit txn (reference PrimaryBatchHandler.post_batch_applied
        selects primaries from three_pc_batch.original_view_no).
        lanes/lane_min: conflict-lane execution (Config.EXEC_LANES /
        EXEC_LANE_MIN when None); merged_device_hash: the merged
        resolve's level routing (Config.EXEC_MERGED_DEVICE_HASH when
        None)."""
        from plenum_tpu_torch.common.config import Config
        self.write_manager = write_manager
        self._requests_source = requests_source
        self.metrics = NullMetricsCollector()  # node injects the real one
        self.tracer = NullTracer()             # node injects the real one
        self.telemetry = NullTelemetryHub()    # node injects the real one
        self._get_view_no = get_view_no or (lambda: 0)
        self._primaries_for_view = primaries_for_view or (lambda v: [])
        self._get_pp_seq_no = get_pp_seq_no
        self._pp_seq_no = 0
        self._on_batch_committed = on_batch_committed
        self._on_request_rejected = on_request_rejected or \
            (lambda d, r, s: None)
        # fused per-3PC-batch device dispatch (Config.FUSED_BATCH_
        # DISPATCH): the batch's ledger leaf-hash launch, a verifier-hub
        # kick, and the MPT pending-apply share ONE overlapped device
        # window per applied batch instead of serialized round trips.
        # device_kick() flushes whatever verify generation is queued
        # (CoalescingVerifierHub) into that same window.
        self._fused = fused_dispatch
        self._device_kick = device_kick
        self._lanes = getattr(Config, "EXEC_LANES", True) \
            if lanes is None else lanes
        self._lane_min = getattr(Config, "EXEC_LANE_MIN", 8) \
            if lane_min is None else lane_min
        self._merged_device_hash = merged_device_hash
        # pipeline execution fan-out (set_exec_map); None = serial
        self._exec_map = None
        # staged batches by apply order (mirrors write manager staging)
        self._staged: List[ThreePcBatch] = []
        # runtime ownership sanitizer (node-injected): lane planning
        # and batch commit are prod-thread seams — exec_map fans ITEMS
        # to pool threads, but the plan/commit decisions stay owned
        self._sanitizer = None

    def set_sanitizer(self, sanitizer) -> None:
        self._sanitizer = sanitizer

    @property
    def db(self):
        return self.write_manager.database_manager

    def _next_pp_seq_no(self) -> int:
        """Seq number of the batch being applied NOW: the ordering
        service's position when wired, the local counter's successor in
        standalone use (bench/tests) — single-sourced for the reject
        path and the post-apply advance."""
        return self._get_pp_seq_no() if self._get_pp_seq_no is not None \
            else self._pp_seq_no + 1

    # -------------------------------------------------------------- apply

    def apply_batch(self, pre_prepare_digests: List[str], ledger_id: int,
                    pp_time: int, pp_digest: str = "",
                    original_view_no: int = None) -> Tuple[str, str, str]:
        with self.metrics.measure_time(MetricsName.BATCH_APPLY_TIME), \
                self.telemetry.timer(TM.STAGE_EXECUTE_MS), \
                self.tracer.span("batch_apply", CAT_EXECUTE,
                                 key=pp_digest or None,
                                 batch_size=len(pre_prepare_digests),
                                 ledger_id=ledger_id):
            return self._apply_batch(pre_prepare_digests, ledger_id,
                                     pp_time, pp_digest, original_view_no)

    def _plan_and_prefetch(self, requests: List[Request], key: str,
                           windows: List):
        """exec_validate sub-stage: declared touches → lane plan →
        cache pre-invalidation → one read-window prefetch per touched
        state. Installed windows append to the CALLER's `windows` list
        as they open, so the caller's finally closes every window even
        when a later prefetch raises mid-way. → the lane plan."""
        touched = self.write_manager.touched_keys
        if self._sanitizer is not None:
            self._sanitizer.check("lane planner")
        with self.tracer.span("exec_validate", CAT_EXECUTE, key=key,
                              batch_size=len(requests)) as sp:
            plan = plan_lanes([touched(r) for r in requests])
            self.telemetry.observe(TM.EXEC_LANES_PER_BATCH, plan.n_lanes)
            self.telemetry.observe(TM.EXEC_CONFLICT_PCT,
                                   plan.conflict_ratio * 100.0)
            if plan.serial_requests:
                self.telemetry.count(TM.EXEC_SERIAL_FALLBACK,
                                     plan.serial_requests)
            self.write_manager.invalidate_read_caches(
                plan.write_keys_by_ledger)
            for lid, keys in plan.read_keys_by_ledger.items():
                state = self.db.get_state(lid)
                if state is not None and state.begin_read_window(keys):
                    windows.append(state)
            sp.add(lanes=plan.n_lanes, serial=plan.serial_requests)
        return plan

    def _apply_batch(self, pre_prepare_digests: List[str], ledger_id: int,
                     pp_time: int, pp_digest: str = "",
                     original_view_no: int = None) -> Tuple[str, str, str]:
        ledger = self.db.get_ledger(ledger_id)
        state = self.db.get_state(ledger_id)
        requests: List[Request] = []
        for digest in pre_prepare_digests:
            request = self._requests_source(digest)
            if request is None:
                raise KeyError(
                    "request {} not available for apply".format(digest))
            requests.append(request)
        plan = None
        windows: List = []
        valid = []
        # state updates happen per request (later requests' validation
        # must see them), but the ledger staging of the whole batch is
        # ONE appendTxns call at the end — txns group by their
        # handler's ledger (one group for a normal per-ledger batch)
        staged: Dict[int, List[dict]] = {}
        seq_base: Dict[int, int] = {}
        validate = self.write_manager.dynamic_validation
        apply_deferred = self.write_manager.apply_request_deferred
        try:
            if self._lanes and len(requests) >= self._lane_min:
                plan = self._plan_and_prefetch(
                    requests, pp_digest or None, windows)
            with self.tracer.span(
                    "lane_apply", CAT_EXECUTE, key=pp_digest or None,
                    batch_size=len(requests),
                    lanes=plan.n_lanes if plan else 0):
                # batch order is the canonical schedule: every request
                # observes exactly the writes ordered before it (reads
                # go pending-buffer → read window → trie), so the lane
                # machinery can never diverge from serial semantics
                for digest, request in zip(pre_prepare_digests, requests):
                    try:
                        validate(request, pp_time)
                    except Exception as e:
                        logger.info(
                            "request %s failed dynamic validation: %s",
                            digest, e)
                        self._on_request_rejected(
                            digest, str(e), self._next_pp_seq_no())
                        continue
                    handler_lid = self.write_manager.ledger_id_for_request(
                        request)
                    group = staged.get(handler_lid)
                    if group is None:
                        group = staged[handler_lid] = []
                        seq_base[handler_lid] = self.db.get_ledger(
                            handler_lid).uncommitted_size
                    txn, _lgr = apply_deferred(
                        request, pp_time,
                        seq_base[handler_lid] + len(group) + 1)
                    group.append(txn)
                    valid.append(digest)
        finally:
            for st in windows:
                st.end_read_window()
        with self.tracer.span("hash_resolve", CAT_EXECUTE,
                              key=pp_digest or None, groups=len(staged)):
            state_root = self._stage_and_resolve(staged, state, ledger,
                                                 len(valid), pp_digest)
        self._pp_seq_no = self._next_pp_seq_no()
        txn_root = ledger.hashToStr(ledger.uncommitted_root_hash)
        view_no = self._get_view_no()
        ov = original_view_no if original_view_no is not None else view_no
        batch = ThreePcBatch(
            ledger_id=ledger_id,
            inst_id=0,
            view_no=view_no,
            pp_seq_no=self._pp_seq_no,
            pp_time=pp_time,
            state_root=state_root,
            txn_root=txn_root,
            valid_digests=valid,
            pp_digest=pp_digest,
            primaries=self._primaries_for_view(ov),
            original_view_no=ov,
        )
        self.write_manager.post_apply_batch(batch)
        self._staged.append(batch)
        audit = self.db.get_ledger(AUDIT_LEDGER_ID)
        audit_root = audit.hashToStr(audit.uncommitted_root_hash)
        return state_root, txn_root, audit_root

    def _stage_and_resolve(self, staged: Dict[int, List[dict]], state,
                           ledger, n_valid: int, pp_digest: str) -> str:
        """hash_resolve sub-stage: stage every ledger group's txns and
        resolve every written state's dirty trie nodes in ONE merged
        level-wise pass, all inside the fused device window."""
        if self._fused and staged:
            # FUSED per-batch device window: launch every ledger group's
            # leaf-hash dispatch, kick the verifier hub's queued
            # generation into the same window, run the merged MPT
            # pending-resolve (per-state bulk structural merge + shared
            # level-wise hash dispatches across ALL written states)
            # WHILE those launches are in flight, then collect the
            # staged hashes — one overlapped round trip where the
            # per-message path serialized them. Results are
            # bit-identical: the streams touch disjoint structures and
            # each collect point is unchanged.
            with self.telemetry.timer(TM.STAGE_DISPATCH_MS), \
                    self.tracer.span(
                    "fused_dispatch", CAT_DEVICE, key=pp_digest or None,
                    groups=len(staged), batch_size=n_valid):
                in_flight = [
                    (lid, self.db.get_ledger(lid).stage_txns_dispatch(
                        txns))
                    for lid, txns in staged.items()]
                if self._device_kick is not None:
                    self._device_kick()
                state_root = self._resolve_states(staged, state, ledger)
                for lid, handle in in_flight:
                    self.db.get_ledger(lid).stage_txns_collect(handle)
        else:
            for lid, txns in staged.items():
                self.db.get_ledger(lid).appendTxns(txns)
            state_root = self._resolve_states(staged, state, ledger)
        return state_root

    def set_exec_map(self, fn) -> None:
        """Install the pipeline's execution fan-out: an order-preserving
        parallel map the merged state flush uses to run independent
        per-state structural merges concurrently (runtime/pipeline.py
        exec_map). None/unset = serial."""
        self._exec_map = fn

    def _resolve_states(self, staged: Dict[int, List[dict]], state,
                        ledger) -> str:
        """Merge every written state's hash resolution (lanes and
        ledgers share the level-wise dispatches); the batch ledger's
        head read afterwards is a no-op flush."""
        if self._lanes and staged:
            lanes_fan = exec_fanout(len(staged))
            flush_states_merged(
                [self.db.get_state(lid) for lid in staged],
                use_device=self._merged_device_hash,
                exec_map=self._exec_map if lanes_fan > 1 else None)
        return ledger.hashToStr(state.headHash) if state else ""

    # ------------------------------------------------------------- revert

    def revert_unordered_batches(self) -> int:
        n = self.write_manager.revert_all_uncommitted()
        self._staged = []
        if self._get_pp_seq_no is None:
            self._pp_seq_no -= n
        return n

    def revert_last_batch(self):
        if self._staged:
            self._staged.pop()
            self.write_manager.post_batch_rejected()
            if self._get_pp_seq_no is None:
                self._pp_seq_no -= 1

    # ------------------------------------------------------------- commit

    def commit_batch(self, ordered: Ordered):
        with self.metrics.measure_time(MetricsName.BATCH_COMMIT_TIME), \
                self.telemetry.timer(TM.STAGE_COMMIT_MS), \
                self.tracer.span(
                    "batch_commit", CAT_EXECUTE,
                    key="%d:%d" % (ordered.viewNo, ordered.ppSeqNo),
                    batch_size=len(ordered.valid_reqIdr)):
            return self._commit_batch(ordered)

    def _commit_batch(self, ordered: Ordered):
        if self._sanitizer is not None:
            self._sanitizer.check("state pending buffers")
        if not self._staged:
            logger.warning("commit with no staged batch at %s",
                           (ordered.viewNo, ordered.ppSeqNo))
            return
        batch = self._staged.pop(0)
        if batch.pp_digest and ordered.digest and \
                batch.pp_digest != ordered.digest:
            logger.warning("ordered digest %s != staged batch digest %s at %s",
                           ordered.digest, batch.pp_digest,
                           (ordered.viewNo, ordered.ppSeqNo))
        committed = self.write_manager.commit_batch(batch)
        # free ordered requests from the in-flight store
        if self._on_batch_committed is not None:
            self._on_batch_committed(ordered, committed)

    # -------------------------------------------------------------- reads

    def is_request_known(self, digest: str) -> bool:
        return self._requests_source(digest) is not None
