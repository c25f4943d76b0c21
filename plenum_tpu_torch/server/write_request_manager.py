"""Write/Read request managers — the handler registry + batch pipeline.

Reference: plenum/server/request_managers/write_request_manager.py:33
(apply_request :148, commit_batch :178, update_state :128) and
read_request_manager.py. The write manager stages request batches onto
ledgers + MPT state (uncommitted), creates the audit txn via the batch
handler chain, and commits or reverts whole batches as 3PC decides.
"""
from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

from plenum_tpu_torch.common.constants import AUDIT_LEDGER_ID
from plenum_tpu_torch.common.exceptions import InvalidClientRequest
from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.common.txn_util import append_txn_metadata, reqToTxn
from plenum_tpu_torch.server.batch_handlers import (
    AuditBatchHandler, BatchRequestHandler)
from plenum_tpu_torch.server.database_manager import DatabaseManager
from plenum_tpu_torch.server.request_handlers import (
    ReadRequestHandler, WriteRequestHandler)
from plenum_tpu_torch.server.three_pc_batch import ThreePcBatch

logger = logging.getLogger(__name__)


class WriteRequestManager:
    def __init__(self, database_manager: DatabaseManager):
        from plenum_tpu_torch.utils.metrics import (
            MetricsName, NullMetricsCollector)
        self._mn = MetricsName
        self.metrics = NullMetricsCollector()  # node injects the real one
        self.database_manager = database_manager
        self.request_handlers: Dict[str, WriteRequestHandler] = {}
        self.batch_handlers: Dict[int, List[BatchRequestHandler]] = {}
        self.audit_b_handler: Optional[AuditBatchHandler] = None
        # TAA acceptance enforcement (reference do_taa_validation);
        # installed by NodeBootstrap.init_managers
        self.taa_validator = None
        # txn payload versioning seam (reference
        # plenum/server/txn_version_controller.py — downstream ledgers
        # override to gate validation rules on the pool version)
        from plenum_tpu_torch.common.txn_version_controller import (
            TxnVersionController)
        self.txn_version_controller = TxnVersionController()
        # staged batches in apply order: (ledger_id, txn_count)
        self._applied_batches: List[Tuple[int, int]] = []
        # lazily-resolved TAA key helpers for touched_keys (hot lane-
        # planning path: one tuple lookup instead of two imports per
        # request)
        self._taa_key_helpers = None

    # -------------------------------------------------------- registration

    def register_req_handler(self, handler: WriteRequestHandler):
        self.request_handlers[handler.txn_type] = handler

    def register_batch_handler(self, handler: BatchRequestHandler,
                               ledger_id: Optional[int] = None):
        lid = ledger_id if ledger_id is not None else handler.ledger_id
        chain = self.batch_handlers.setdefault(lid, [])
        chain.append(handler)
        if isinstance(handler, AuditBatchHandler):
            self.audit_b_handler = handler

    def is_valid_type(self, txn_type: str) -> bool:
        return txn_type in self.request_handlers

    def type_to_ledger_id(self, txn_type: str) -> Optional[int]:
        h = self.request_handlers.get(txn_type)
        return h.ledger_id if h else None

    # --------------------------------------------------------- validation

    def static_validation(self, request: Request):
        handler = self.request_handlers.get(request.txn_type)
        if handler is None:
            raise InvalidClientRequest(
                request.identifier, request.reqId,
                "unknown txn type {}".format(request.txn_type))
        handler.static_validation(request)

    def dynamic_validation(self, request: Request, req_pp_time=None):
        handler = self.request_handlers.get(request.txn_type)
        if handler is None:
            raise InvalidClientRequest(
                request.identifier, request.reqId,
                "unknown txn type {}".format(request.txn_type))
        if self.taa_validator is not None and req_pp_time is not None:
            self.taa_validator.validate(request, handler.ledger_id,
                                        req_pp_time)
        self._reject_frozen_ledger_write(request, handler.ledger_id)
        handler.dynamic_validation(request, req_pp_time)

    def _reject_frozen_ledger_write(self, request: Request,
                                    ledger_id: Optional[int]):
        """Frozen ledgers accept no writes (reference ledgers_freeze/).
        Base ledgers can never be frozen (static validation), so the
        hot path skips the state lookup entirely."""
        from plenum_tpu_torch.common.constants import (
            CONFIG_LEDGER_ID, VALID_LEDGER_IDS)
        if ledger_id is None or ledger_id in VALID_LEDGER_IDS:
            return
        from plenum_tpu_torch.server.freeze_handlers import get_frozen_ledgers
        config_state = self.database_manager.get_state(CONFIG_LEDGER_ID)
        if config_state is None:
            return
        if ledger_id in get_frozen_ledgers(config_state,
                                           is_committed=False):
            raise InvalidClientRequest(
                request.identifier, request.reqId,
                "ledger {} is frozen".format(ledger_id))

    # -------------------------------------------------------------- apply

    def apply_request(self, request: Request, batch_ts: int) -> dict:
        """Stage one request: reqToTxn, update uncommitted state, stage
        ledger txn. Returns the txn."""
        from plenum_tpu_torch.common.constants import (
            TXN_METADATA, TXN_METADATA_SEQ_NO, TXN_METADATA_TIME)
        handler = self.request_handlers[request.txn_type]
        txn = reqToTxn(request)
        ledger = handler.ledger
        # one metadata write: seq_no + time together (append_txn_metadata
        # + append_txns_metadata used to each rebuild this dict)
        txn[TXN_METADATA] = {
            TXN_METADATA_SEQ_NO: ledger.uncommitted_size + 1,
            TXN_METADATA_TIME: batch_ts,
        }
        ledger.appendTxns([txn])
        handler.update_state(txn, None, request)
        return txn

    def ledger_id_for_request(self, request: Request) -> int:
        return self.request_handlers[request.txn_type].ledger_id

    # --------------------------------------------------- execution lanes

    def touched_keys(self, request: Request):
        """The request's declared state touches for lane planning
        (server/execution_lanes.py): the handler's own declaration
        widened by the pipeline reads dynamic_validation performs on
        the handler's behalf — TAA acceptance checks read the active
        agreement / acceptance digest / AML records out of the CONFIG
        state for every write on a TAA-protected ledger. None =
        undeclared (serial lane)."""
        handler = self.request_handlers.get(request.txn_type)
        if handler is None:
            return None
        tk = handler.touched_keys(request)
        if tk is None:
            return None
        if self.taa_validator is not None and \
                self.database_manager.is_taa_acceptance_required(
                    handler.ledger_id):
            taa = self._taa_key_helpers
            if taa is None:
                from plenum_tpu_torch.common.constants import (
                    CONFIG_LEDGER_ID, TAA_ACCEPTANCE_DIGEST)
                from plenum_tpu_torch.server.taa_handlers import (
                    TAA_STATIC_READ_KEYS, _path_digest)
                taa = self._taa_key_helpers = (
                    CONFIG_LEDGER_ID, TAA_ACCEPTANCE_DIGEST,
                    TAA_STATIC_READ_KEYS, TAA_STATIC_READ_KEYS[:1],
                    _path_digest)
            config_lid, digest_field, all_keys, latest_only, path = taa
            acceptance = request.taaAcceptance
            if acceptance:
                extra = list(all_keys)
                digest = acceptance.get(digest_field)
                if isinstance(digest, str):
                    extra.append((config_lid, path(digest)))
            else:
                extra = latest_only  # taa:latest only
            tk = tk.with_reads(extra)
        return tk

    def invalidate_read_caches(self, write_keys_by_ledger) -> None:
        """Lane safety: before a planned batch applies, drop every
        handler read-cache entry for a state key the batch DECLARES it
        will write (NymHandler.invalidate_for_writes) — no cached
        pre-batch record can survive into a batch that rewrites it,
        whatever order lanes resolve their reads in."""
        for lid, keys in write_keys_by_ledger.items():
            for handler in self.request_handlers.values():
                if handler.ledger_id != lid:
                    continue
                invalidate = getattr(handler, "invalidate_for_writes",
                                     None)
                if invalidate is not None:
                    invalidate(keys)

    def apply_request_deferred(self, request: Request, batch_ts: int,
                               seq_no: int) -> Tuple[dict, object]:
        """apply_request minus the ledger staging: state updates run
        now (later requests' dynamic validation must see them), the txn
        is returned with metadata for the caller to stage in ONE
        appendTxns call per batch — a per-request appendTxns([txn]) was
        measurable overhead on the apply hot path. → (txn, ledger)."""
        from plenum_tpu_torch.common.constants import (
            TXN_METADATA, TXN_METADATA_SEQ_NO, TXN_METADATA_TIME)
        handler = self.request_handlers[request.txn_type]
        txn = reqToTxn(request)
        txn[TXN_METADATA] = {
            TXN_METADATA_SEQ_NO: seq_no,
            TXN_METADATA_TIME: batch_ts,
        }
        handler.update_state(txn, None, request)
        return txn, handler.ledger

    def post_apply_batch(self, three_pc_batch: ThreePcBatch):
        """Run the batch-handler chain after a batch's requests applied
        (audit txn creation happens here)."""
        for handler in self.batch_handlers.get(three_pc_batch.ledger_id, []):
            handler.post_batch_applied(three_pc_batch)
        for handler in self.batch_handlers.get(AUDIT_LEDGER_ID, []):
            handler.post_batch_applied(three_pc_batch)
        self._applied_batches.append(
            (three_pc_batch.ledger_id, len(three_pc_batch.valid_digests)))

    # ------------------------------------------------------------- commit

    def commit_batch(self, three_pc_batch: ThreePcBatch):
        committed = []
        with self.metrics.measure_time(self._mn.LEDGER_COMMIT_TIME):
            for handler in self.batch_handlers.get(
                    three_pc_batch.ledger_id, []):
                result = handler.commit_batch(three_pc_batch)
                if result:
                    committed = result
        with self.metrics.measure_time(self._mn.AUDIT_BATCH_TIME):
            for handler in self.batch_handlers.get(AUDIT_LEDGER_ID, []):
                handler.commit_batch(three_pc_batch)
        for txn in committed:
            self.txn_version_controller.update_version(txn)
        if self._applied_batches:
            self._applied_batches.pop(0)
        return committed

    # ------------------------------------------------------------- revert

    def post_batch_rejected(self, ledger_id: Optional[int] = None):
        """Revert the NEWEST applied batch."""
        if not self._applied_batches:
            return
        lid, count = self._applied_batches.pop()
        ledger = self.database_manager.get_ledger(lid)
        state = self.database_manager.get_state(lid)
        audit = self.database_manager.get_ledger(AUDIT_LEDGER_ID)
        if ledger is not None and count:
            ledger.discardTxns(count)
        if audit is not None and audit.uncommittedTxns:
            audit.discardTxns(1)
        self._rewind_states()

    def revert_all_uncommitted(self) -> int:
        """Revert every staged batch (view change start)."""
        n = 0
        while self._applied_batches:
            self.post_batch_rejected()
            n += 1
        return n

    def _rewind_states(self):
        """Reset every state head to match the last remaining staged batch
        (or the committed root if none): heads are recomputed from the
        audit ledger's staged entries."""
        for handler in self.request_handlers.values():
            clear = getattr(handler, "clear_caches", None)
            if clear is not None:
                clear()
        audit = self.database_manager.get_ledger(AUDIT_LEDGER_ID)
        last_roots = None
        if audit is not None and audit.uncommittedTxns:
            from plenum_tpu_torch.common.txn_util import get_payload_data
            from plenum_tpu_torch.server.batch_handlers import AUDIT_TXN_STATE_ROOT
            last_roots = get_payload_data(
                audit.uncommittedTxns[-1]).get(AUDIT_TXN_STATE_ROOT, {})
        for lid in self.database_manager.ledger_ids:
            if lid == AUDIT_LEDGER_ID:
                continue
            state = self.database_manager.get_state(lid)
            ledger = self.database_manager.get_ledger(lid)
            if state is None:
                continue
            if last_roots is not None and str(lid) in last_roots:
                state.revertToHead(ledger.strToHash(last_roots[str(lid)]))
            else:
                state.revertToHead(state.committedHeadHash)

    @property
    def applied_batch_count(self) -> int:
        return len(self._applied_batches)


class ActionRequestManager:
    """Actions bypass consensus: authenticated + validated, executed
    locally on the receiving node, answered directly (reference
    plenum/server/request_managers/action_request_manager.py —
    downstream ledgers register concrete handlers like POOL_RESTART;
    the framework ships the seam)."""

    def __init__(self):
        self.request_handlers: Dict[str, object] = {}

    def register_action_handler(self, handler):
        self.request_handlers[handler.txn_type] = handler

    def is_valid_type(self, txn_type: str) -> bool:
        return txn_type in self.request_handlers

    def _handler(self, request: Request):
        handler = self.request_handlers.get(request.txn_type)
        if handler is None:
            raise InvalidClientRequest(
                request.identifier, request.reqId,
                "unknown action type {}".format(request.txn_type))
        return handler

    def static_validation(self, request: Request):
        self._handler(request).static_validation(request)

    def dynamic_validation(self, request: Request):
        self._handler(request).dynamic_validation(request)

    def process_action(self, request: Request) -> dict:
        return self._handler(request).process_action(request)


class ReadRequestManager:
    def __init__(self):
        self.request_handlers: Dict[str, ReadRequestHandler] = {}

    def register_req_handler(self, handler: ReadRequestHandler):
        self.request_handlers[handler.txn_type] = handler

    def is_valid_type(self, txn_type: str) -> bool:
        return txn_type in self.request_handlers

    def static_validation(self, request: Request):
        pass

    def get_result(self, request: Request) -> dict:
        handler = self.request_handlers.get(request.txn_type)
        if handler is None:
            raise InvalidClientRequest(
                request.identifier, request.reqId,
                "unknown read type {}".format(request.txn_type))
        return handler.get_result(request)

    def get_results_batch(self, requests: List[Request]) -> list:
        """Serve many reads in one pass: requests are grouped per
        handler, and handlers exposing `get_results_batch` (GET_NYM —
        one batched state-engine walk for values + proofs) take whole
        groups at once; the rest answer one by one. Result slots align
        with `requests`; a slot holds the result dict OR the exception
        that request raised — per-request failures never fail the
        batch."""
        out: list = [None] * len(requests)
        groups: Dict[str, list] = {}
        for i, request in enumerate(requests):
            if request.txn_type not in self.request_handlers:
                out[i] = InvalidClientRequest(
                    request.identifier, request.reqId,
                    "unknown read type {}".format(request.txn_type))
                continue
            groups.setdefault(request.txn_type, []).append(i)
        for txn_type, idxs in groups.items():
            handler = self.request_handlers[txn_type]
            batch = getattr(handler, "get_results_batch", None)
            if batch is not None and len(idxs) > 1:
                for i, res in zip(idxs, batch([requests[i]
                                               for i in idxs])):
                    out[i] = res
                continue
            for i in idxs:
                try:
                    out[i] = handler.get_result(requests[i])
                except Exception as e:  # slot-aligned: the caller nacks
                    # this request and serves the rest of the batch
                    out[i] = e
        return out
