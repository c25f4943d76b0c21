"""Ledger freezing: retire plugin ledgers while preserving their final
roots for audit. Frozen ledgers accept no writes (enforced in
WriteRequestManager.dynamic_validation); the leecher never syncs
plugin ledgers, so no catchup exclusion is needed here.

Reference: plenum/server/request_handlers/ledgers_freeze/ —
LedgersFreezeHandler (TRUSTEE-only write on the config ledger recording
{ledger_id: {ledger, state, seq_no}} final roots from the audit
ledger), GetFrozenLedgersHandler (read), StaticLedgersFreezeHelper
(state path "4:FROZEN_LEDGERS" — same marker here for state-proof
compatibility).
"""
from __future__ import annotations

from typing import Dict, Optional

from plenum_tpu_torch.common.constants import (
    AUDIT_LEDGER_ID, CONFIG_LEDGER_ID, DOMAIN_LEDGER_ID,
    GET_FROZEN_LEDGERS, LEDGERS_FREEZE, ROLE, TRUSTEE, VALID_LEDGER_IDS)
from plenum_tpu_torch.common.exceptions import (
    InvalidClientRequest, UnauthorizedClientRequest)
from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.common.txn_util import (
    get_payload_data, get_seq_no, get_txn_time)
from plenum_tpu_torch.server.batch_handlers import (
    AUDIT_TXN_LEDGER_ROOT, AUDIT_TXN_LEDGERS_SIZE, AUDIT_TXN_STATE_ROOT)
from plenum_tpu_torch.server.database_manager import DatabaseManager
from plenum_tpu_torch.server.execution_lanes import TouchedKeys
from plenum_tpu_torch.server.request_handlers import (
    ReadRequestHandler, WriteRequestHandler, decode_state_value,
    encode_state_value, nym_to_state_key)

LEDGERS_IDS = "ledgers_ids"
FROZEN_LEDGERS_PATH = b"4:FROZEN_LEDGERS"


def get_frozen_ledgers(config_state, is_committed: bool = True
                       ) -> Dict[int, dict]:
    if config_state is None:
        return {}
    raw = config_state.get(FROZEN_LEDGERS_PATH, isCommitted=is_committed)
    val, _, _ = decode_state_value(raw)
    return {int(k): v for k, v in (val or {}).items()}


class LedgersFreezeHandler(WriteRequestHandler):
    def __init__(self, database_manager: DatabaseManager):
        super().__init__(database_manager, LEDGERS_FREEZE,
                         CONFIG_LEDGER_ID)

    def static_validation(self, request: Request):
        lids = request.operation.get(LEDGERS_IDS)
        if not isinstance(lids, list) or not lids or \
                not all(isinstance(lid, int) for lid in lids):
            raise InvalidClientRequest(
                request.identifier, request.reqId,
                "ledgers_ids must be a non-empty list of ints")
        if any(lid in VALID_LEDGER_IDS for lid in lids):
            raise InvalidClientRequest(
                request.identifier, request.reqId,
                "base ledgers {} can't be frozen".format(
                    tuple(VALID_LEDGER_IDS)))

    def touched_keys(self, request: Request):
        """One fixed config key (the frozen-ledger registry) plus the
        author's domain record — both computable from the request, so
        freezes lane-plan despite reading the audit ledger (lane keys
        cover STATE touches; ledger reads don't conflict)."""
        return TouchedKeys(
            reads=((CONFIG_LEDGER_ID, FROZEN_LEDGERS_PATH),
                   (DOMAIN_LEDGER_ID,
                    nym_to_state_key(request.identifier or ""))),
            writes=((CONFIG_LEDGER_ID, FROZEN_LEDGERS_PATH),))

    def dynamic_validation(self, request: Request, req_pp_time=None):
        domain_state = self.database_manager.get_state(DOMAIN_LEDGER_ID)
        val, _, _ = decode_state_value(domain_state.get(
            nym_to_state_key(request.identifier or ""), isCommitted=False))
        if (val or {}).get(ROLE) != TRUSTEE:
            raise UnauthorizedClientRequest(
                request.identifier, request.reqId,
                "only TRUSTEE can freeze ledgers")
        audit = self.database_manager.get_ledger(AUDIT_LEDGER_ID)
        if audit is None or audit.size == 0:
            raise InvalidClientRequest(
                request.identifier, request.reqId,
                "no audit history to freeze ledgers against")
        sizes = get_payload_data(audit.get_last_txn()).get(
            AUDIT_TXN_LEDGERS_SIZE) or {}
        missing = [lid for lid in request.operation[LEDGERS_IDS]
                   if str(lid) not in sizes]
        if missing:
            raise InvalidClientRequest(
                request.identifier, request.reqId,
                "ledgers {} have never existed".format(missing))

    def update_state(self, txn: dict, prev_result, request: Request,
                     is_committed: bool = False):
        seq_no, txn_time = get_seq_no(txn), get_txn_time(txn)
        lids = get_payload_data(txn)[LEDGERS_IDS]
        frozen = {str(k): v for k, v in get_frozen_ledgers(
            self.state, is_committed=False).items()}
        audit_data = get_payload_data(
            self.database_manager.get_ledger(AUDIT_LEDGER_ID)
            .get_last_txn())
        for lid in lids:
            frozen[str(lid)] = {
                "ledger": (audit_data.get(AUDIT_TXN_LEDGER_ROOT)
                           or {}).get(str(lid)),
                "state": (audit_data.get(AUDIT_TXN_STATE_ROOT)
                          or {}).get(str(lid)),
                "seq_no": (audit_data.get(AUDIT_TXN_LEDGERS_SIZE)
                           or {}).get(str(lid), 0),
            }
        self.state.set(FROZEN_LEDGERS_PATH,
                       encode_state_value(frozen, seq_no, txn_time))
        return frozen


class GetFrozenLedgersHandler(ReadRequestHandler):
    def __init__(self, database_manager: DatabaseManager):
        super().__init__(database_manager, GET_FROZEN_LEDGERS,
                         CONFIG_LEDGER_ID)

    def get_result(self, request: Request) -> dict:
        frozen = get_frozen_ledgers(self.state, is_committed=True)
        return {"identifier": request.identifier, "reqId": request.reqId,
                "type": GET_FROZEN_LEDGERS,
                "data": {str(k): v for k, v in frozen.items()} or None}
