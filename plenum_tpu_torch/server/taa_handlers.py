"""Transaction Author Agreement: config-ledger agreement lifecycle +
write-acceptance enforcement.

Reference: plenum/server/request_handlers/txn_author_agreement_handler.py,
txn_author_agreement_aml_handler.py, txn_author_agreement_disable_handler
.py, get_txn_author_agreement{,_aml}_handler.py, static_taa_helper.py,
and write_request_manager.py:297 (do_taa_validation).

State layout in the CONFIG MPT (same scheme as the reference's
StaticTAAHelper paths):
    taa:latest          -> digest of the active TAA ('' when disabled)
    taa:v:<version>     -> digest
    taa:d:<digest>      -> {text, version, ratification_ts[, retirement_ts]}
    taa:aml:latest      -> {version, aml, amlContext}
    taa:aml:v:<version> -> same
"""
from __future__ import annotations

from datetime import datetime, timezone
from hashlib import sha256
from typing import Optional

from plenum_tpu_torch.common.constants import (
    AML, AML_CONTEXT, AML_VERSION, CONFIG_LEDGER_ID, DOMAIN_LEDGER_ID,
    GET_TXN_AUTHOR_AGREEMENT, GET_TXN_AUTHOR_AGREEMENT_AML,
    TAA_ACCEPTANCE_DIGEST, TAA_ACCEPTANCE_MECHANISM, TAA_ACCEPTANCE_TIME,
    TRUSTEE, TXN_AUTHOR_AGREEMENT, TXN_AUTHOR_AGREEMENT_AML,
    TXN_AUTHOR_AGREEMENT_DISABLE, TXN_AUTHOR_AGREEMENT_RATIFICATION_TS,
    TXN_AUTHOR_AGREEMENT_RETIREMENT_TS, TXN_AUTHOR_AGREEMENT_TEXT,
    TXN_AUTHOR_AGREEMENT_VERSION)
from plenum_tpu_torch.common.exceptions import (
    InvalidClientRequest, UnauthorizedClientRequest)
from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.common.txn_util import (
    get_payload_data, get_seq_no, get_txn_time)
from plenum_tpu_torch.server.database_manager import DatabaseManager
from plenum_tpu_torch.server.execution_lanes import TouchedKeys
from plenum_tpu_torch.server.request_handlers import (
    ReadRequestHandler, WriteRequestHandler, decode_state_value,
    encode_state_value, nym_to_state_key)


def taa_digest(text: str, version: str) -> str:
    """sha256(version + text) hex — reference StaticTAAHelper.taa_digest."""
    return sha256((version + text).encode()).hexdigest()


def _path_latest() -> bytes:
    return b"taa:latest"


def _path_version(version: str) -> bytes:
    return "taa:v:{}".format(version).encode()


def _path_digest(digest: str) -> bytes:
    return "taa:d:{}".format(digest).encode()


def _path_aml_latest() -> bytes:
    return b"taa:aml:latest"


def _path_aml_version(version: str) -> bytes:
    return "taa:aml:v:{}".format(version).encode()


# the fixed CONFIG keys every TAA acceptance check can read (active
# digest, then the AML registry when an acceptance is present) — the
# write manager widens lane-plan declarations with these
# (WriteRequestManager.touched_keys); the acceptance-digest slot is
# per-request (_path_digest)
TAA_STATIC_READ_KEYS = ((CONFIG_LEDGER_ID, _path_latest()),
                        (CONFIG_LEDGER_ID, _path_aml_latest()))


class TaaAccess:
    """Read-side helpers over the config state (shared by handlers and
    the write manager's acceptance validation)."""

    def __init__(self, database_manager: DatabaseManager):
        self._db = database_manager

    @property
    def state(self):
        return self._db.get_state(CONFIG_LEDGER_ID)

    def _get(self, path: bytes, is_committed: bool):
        raw = self.state.get(path, isCommitted=is_committed)
        return decode_state_value(raw)

    def active_digest(self, is_committed: bool = False) -> Optional[str]:
        val, _, _ = self._get(_path_latest(), is_committed)
        digest = (val or {}).get("digest")
        return digest or None

    def digest_for_version(self, version: str,
                           is_committed: bool = False) -> Optional[str]:
        val, _, _ = self._get(_path_version(version), is_committed)
        return (val or {}).get("digest")

    def taa_by_digest(self, digest: str, is_committed: bool = False):
        """→ (data dict, seq_no, txn_time) or (None, None, None)."""
        return self._get(_path_digest(digest), is_committed)

    def aml(self, version: str = None, is_committed: bool = False):
        path = (_path_aml_latest() if version is None
                else _path_aml_version(version))
        val, seq_no, txn_time = self._get(path, is_committed)
        return val, seq_no, txn_time


class _ConfigWriteHandler(WriteRequestHandler):
    """Common TRUSTEE-only authorization for TAA writes."""

    def _require_trustee(self, request: Request):
        domain_state = self.database_manager.get_state(DOMAIN_LEDGER_ID)
        val, _, _ = decode_state_value(domain_state.get(
            nym_to_state_key(request.identifier or ""), isCommitted=False))
        if (val or {}).get("role") != TRUSTEE:
            raise UnauthorizedClientRequest(
                request.identifier, request.reqId,
                "only TRUSTEE can manage the transaction author agreement")


class TxnAuthorAgreementHandler(_ConfigWriteHandler):
    def __init__(self, database_manager: DatabaseManager):
        super().__init__(database_manager, TXN_AUTHOR_AGREEMENT,
                         CONFIG_LEDGER_ID)
        self._taa = TaaAccess(database_manager)

    def static_validation(self, request: Request):
        op = request.operation
        version = op.get(TXN_AUTHOR_AGREEMENT_VERSION)
        if not isinstance(version, str) or not version:
            raise InvalidClientRequest(request.identifier, request.reqId,
                                       "TAA must have a version")
        text = op.get(TXN_AUTHOR_AGREEMENT_TEXT)
        retirement = op.get(TXN_AUTHOR_AGREEMENT_RETIREMENT_TS)
        if text is None and retirement is None:
            raise InvalidClientRequest(
                request.identifier, request.reqId,
                "TAA needs text (new agreement) or retirement_ts (update)")
        if text is not None and not isinstance(text, str):
            raise InvalidClientRequest(request.identifier, request.reqId,
                                       "TAA text must be a string")

    def dynamic_validation(self, request: Request, req_pp_time=None):
        self._require_trustee(request)
        op = request.operation
        version = op[TXN_AUTHOR_AGREEMENT_VERSION]
        existing_digest = self._taa.digest_for_version(version)
        is_new = existing_digest is None
        if is_new:
            if op.get(TXN_AUTHOR_AGREEMENT_TEXT) is None:
                raise InvalidClientRequest(
                    request.identifier, request.reqId,
                    "a new TAA version must include its text")
            if op.get(TXN_AUTHOR_AGREEMENT_RATIFICATION_TS) is None:
                raise InvalidClientRequest(
                    request.identifier, request.reqId,
                    "a new TAA version must include ratification_ts")
            if op.get(TXN_AUTHOR_AGREEMENT_RETIREMENT_TS) is not None:
                # a born-retired TAA would become active yet unacceptable,
                # wedging every domain write
                raise InvalidClientRequest(
                    request.identifier, request.reqId,
                    "a new TAA version cannot include retirement_ts")
            aml, _, _ = self._taa.aml()
            if not aml:
                raise InvalidClientRequest(
                    request.identifier, request.reqId,
                    "TAA cannot be set before a TAA AML is set")
        else:
            # existing version: only retirement may change (reference
            # forbids editing ratified text)
            taa_data, _, _ = self._taa.taa_by_digest(existing_digest)
            text = op.get(TXN_AUTHOR_AGREEMENT_TEXT)
            if text is not None and \
                    text != (taa_data or {}).get(TXN_AUTHOR_AGREEMENT_TEXT):
                raise InvalidClientRequest(
                    request.identifier, request.reqId,
                    "the text of an existing TAA version cannot change")
            ratification = op.get(TXN_AUTHOR_AGREEMENT_RATIFICATION_TS)
            if ratification is not None and ratification != \
                    (taa_data or {}).get(TXN_AUTHOR_AGREEMENT_RATIFICATION_TS):
                raise InvalidClientRequest(
                    request.identifier, request.reqId,
                    "ratification_ts of an existing TAA cannot change")
            if existing_digest == self._taa.active_digest() and \
                    TXN_AUTHOR_AGREEMENT_RETIREMENT_TS in op:
                raise InvalidClientRequest(
                    request.identifier, request.reqId,
                    "the latest TAA cannot be retired; set a newer one "
                    "or send TXN_AUTHOR_AGREEMENT_DISABLE")

    def update_state(self, txn: dict, prev_result, request: Request,
                     is_committed: bool = False):
        data = get_payload_data(txn)
        version = data[TXN_AUTHOR_AGREEMENT_VERSION]
        seq_no, txn_time = get_seq_no(txn), get_txn_time(txn)
        existing_digest = self._taa.digest_for_version(version)
        if existing_digest is None:
            digest = taa_digest(data[TXN_AUTHOR_AGREEMENT_TEXT], version)
            record = {
                TXN_AUTHOR_AGREEMENT_TEXT: data[TXN_AUTHOR_AGREEMENT_TEXT],
                TXN_AUTHOR_AGREEMENT_VERSION: version,
                TXN_AUTHOR_AGREEMENT_RATIFICATION_TS:
                    data.get(TXN_AUTHOR_AGREEMENT_RATIFICATION_TS),
            }
            if TXN_AUTHOR_AGREEMENT_RETIREMENT_TS in data:
                record[TXN_AUTHOR_AGREEMENT_RETIREMENT_TS] = \
                    data[TXN_AUTHOR_AGREEMENT_RETIREMENT_TS]
            self.state.set(_path_latest(), encode_state_value(
                {"digest": digest}, seq_no, txn_time))
            self.state.set(_path_version(version), encode_state_value(
                {"digest": digest}, seq_no, txn_time))
        else:
            digest = existing_digest
            record, _, _ = self._taa.taa_by_digest(digest)
            record = dict(record or {})
            if TXN_AUTHOR_AGREEMENT_RETIREMENT_TS in data:
                if data[TXN_AUTHOR_AGREEMENT_RETIREMENT_TS] is None:
                    record.pop(TXN_AUTHOR_AGREEMENT_RETIREMENT_TS, None)
                else:
                    record[TXN_AUTHOR_AGREEMENT_RETIREMENT_TS] = \
                        data[TXN_AUTHOR_AGREEMENT_RETIREMENT_TS]
        self.state.set(_path_digest(digest),
                       encode_state_value(record, seq_no, txn_time))
        return record


class TxnAuthorAgreementAmlHandler(_ConfigWriteHandler):
    def __init__(self, database_manager: DatabaseManager):
        super().__init__(database_manager, TXN_AUTHOR_AGREEMENT_AML,
                         CONFIG_LEDGER_ID)
        self._taa = TaaAccess(database_manager)

    def static_validation(self, request: Request):
        op = request.operation
        if not isinstance(op.get(AML_VERSION), str) or not op[AML_VERSION]:
            raise InvalidClientRequest(request.identifier, request.reqId,
                                       "AML must have a version")
        aml = op.get(AML)
        if not isinstance(aml, dict) or not aml:
            raise InvalidClientRequest(
                request.identifier, request.reqId,
                "AML must be a non-empty mechanisms dict")

    def touched_keys(self, request: Request):
        """AML state paths are pure functions of the request (version
        string), so the handler can declare: the version slot read by
        uniqueness validation, the author's domain record, and the
        latest+versioned slots update_state writes."""
        version = request.operation.get(AML_VERSION)
        if not isinstance(version, str) or not version:
            return None
        reads = [(CONFIG_LEDGER_ID, _path_aml_version(version)),
                 (DOMAIN_LEDGER_ID,
                  nym_to_state_key(request.identifier or ""))]
        return TouchedKeys(reads=reads, writes=(
            (CONFIG_LEDGER_ID, _path_aml_latest()),
            (CONFIG_LEDGER_ID, _path_aml_version(version))))

    def dynamic_validation(self, request: Request, req_pp_time=None):
        self._require_trustee(request)
        if self._taa.aml(version=request.operation[AML_VERSION])[0]:
            raise InvalidClientRequest(
                request.identifier, request.reqId,
                "AML version {} already exists".format(
                    request.operation[AML_VERSION]))

    def update_state(self, txn: dict, prev_result, request: Request,
                     is_committed: bool = False):
        data = get_payload_data(txn)
        seq_no, txn_time = get_seq_no(txn), get_txn_time(txn)
        value = {AML_VERSION: data[AML_VERSION], AML: data[AML],
                 AML_CONTEXT: data.get(AML_CONTEXT)}
        encoded = encode_state_value(value, seq_no, txn_time)
        self.state.set(_path_aml_latest(), encoded)
        self.state.set(_path_aml_version(data[AML_VERSION]), encoded)
        return value


class TxnAuthorAgreementDisableHandler(_ConfigWriteHandler):
    def __init__(self, database_manager: DatabaseManager):
        super().__init__(database_manager, TXN_AUTHOR_AGREEMENT_DISABLE,
                         CONFIG_LEDGER_ID)
        self._taa = TaaAccess(database_manager)

    def static_validation(self, request: Request):
        pass

    def dynamic_validation(self, request: Request, req_pp_time=None):
        self._require_trustee(request)
        if self._taa.active_digest() is None:
            raise InvalidClientRequest(request.identifier, request.reqId,
                                       "no active TAA to disable")

    def update_state(self, txn: dict, prev_result, request: Request,
                     is_committed: bool = False):
        seq_no, txn_time = get_seq_no(txn), get_txn_time(txn)
        active = self._taa.active_digest()
        if active is not None:
            # retire the active agreement as of this txn's time
            record, _, _ = self._taa.taa_by_digest(active)
            record = dict(record or {})
            record.setdefault(TXN_AUTHOR_AGREEMENT_RETIREMENT_TS, txn_time)
            self.state.set(_path_digest(active),
                           encode_state_value(record, seq_no, txn_time))
        self.state.set(_path_latest(), encode_state_value(
            {"digest": ""}, seq_no, txn_time))
        return None


class GetTxnAuthorAgreementHandler(ReadRequestHandler):
    def __init__(self, database_manager: DatabaseManager):
        super().__init__(database_manager, GET_TXN_AUTHOR_AGREEMENT,
                         CONFIG_LEDGER_ID)
        self._taa = TaaAccess(database_manager)

    def get_result(self, request: Request) -> dict:
        op = request.operation
        digest = op.get("digest")
        if digest is None and op.get("version") is not None:
            # an unknown version must answer null, never fall back to
            # the active agreement (the client would accept wrong text)
            digest = self._taa.digest_for_version(op["version"],
                                                  is_committed=True) or ""
        if digest is None:
            digest = self._taa.active_digest(is_committed=True)
        data, seq_no, txn_time = (None, None, None)
        if digest:
            data, seq_no, txn_time = self._taa.taa_by_digest(
                digest, is_committed=True)
            if data is not None:
                data = dict(data)
                data["digest"] = digest
        return {"identifier": request.identifier, "reqId": request.reqId,
                "type": GET_TXN_AUTHOR_AGREEMENT, "data": data,
                "seqNo": seq_no, "txnTime": txn_time}


class GetTxnAuthorAgreementAmlHandler(ReadRequestHandler):
    def __init__(self, database_manager: DatabaseManager):
        super().__init__(database_manager, GET_TXN_AUTHOR_AGREEMENT_AML,
                         CONFIG_LEDGER_ID)
        self._taa = TaaAccess(database_manager)

    def get_result(self, request: Request) -> dict:
        data, seq_no, txn_time = self._taa.aml(
            version=request.operation.get("version"), is_committed=True)
        return {"identifier": request.identifier, "reqId": request.reqId,
                "type": GET_TXN_AUTHOR_AGREEMENT_AML, "data": data,
                "seqNo": seq_no, "txnTime": txn_time}


# ------------------------------------------------- acceptance validation

class TaaAcceptanceValidator:
    """Per-write taaAcceptance enforcement (reference
    write_request_manager.py:297 do_taa_validation): required on
    TAA-protected ledgers while a TAA is active; digest must name a
    known, unretired agreement; mechanism must be in the AML; the
    acceptance time must be a whole UTC date inside
    [ratification - BEFORE, pp_time + AFTER]."""

    def __init__(self, database_manager: DatabaseManager, config):
        self._db = database_manager
        self._taa = TaaAccess(database_manager)
        self._config = config

    def validate(self, request: Request, ledger_id: int,
                 req_pp_time: int) -> None:
        acceptance = request.taaAcceptance
        if not self._db.is_taa_acceptance_required(ledger_id):
            if acceptance:
                raise InvalidClientRequest(
                    request.identifier, request.reqId,
                    "taaAcceptance is not expected for ledger {}".format(
                        ledger_id))
            return
        active = self._taa.active_digest()
        if not active:
            if acceptance:
                raise InvalidClientRequest(
                    request.identifier, request.reqId,
                    "taaAcceptance while no TAA is active")
            return
        if not acceptance:
            raise InvalidClientRequest(
                request.identifier, request.reqId,
                "the active transaction author agreement must be accepted")
        digest = acceptance.get(TAA_ACCEPTANCE_DIGEST)
        taa_data, _, taa_time = self._taa.taa_by_digest(digest or "")
        if taa_data is None:
            raise InvalidClientRequest(
                request.identifier, request.reqId,
                "unknown TAA digest {}".format(digest))
        retirement = taa_data.get(TXN_AUTHOR_AGREEMENT_RETIREMENT_TS)
        if retirement is not None and retirement < req_pp_time:
            raise InvalidClientRequest(
                request.identifier, request.reqId,
                "TAA version {} is retired".format(
                    taa_data.get(TXN_AUTHOR_AGREEMENT_VERSION)))
        mechanism = acceptance.get(TAA_ACCEPTANCE_MECHANISM)
        aml, _, _ = self._taa.aml()
        if not aml or mechanism not in (aml.get(AML) or {}):
            raise InvalidClientRequest(
                request.identifier, request.reqId,
                "acceptance mechanism {} is not in the AML".format(
                    mechanism))
        ts = acceptance.get(TAA_ACCEPTANCE_TIME)
        try:
            accepted = datetime.fromtimestamp(ts, tz=timezone.utc)
        except (TypeError, ValueError, OSError, OverflowError):
            raise InvalidClientRequest(
                request.identifier, request.reqId,
                "malformed TAA acceptance time {!r}".format(ts))
        if (accepted.hour, accepted.minute, accepted.second,
                accepted.microsecond) != (0, 0, 0, 0):
            raise InvalidClientRequest(
                request.identifier, request.reqId,
                "TAA acceptance time must be rounded to a UTC date "
                "(privacy: no sub-day precision on the ledger)")
        ratified = taa_data.get(TXN_AUTHOR_AGREEMENT_RATIFICATION_TS)
        if ratified is None:
            ratified = taa_time or 0
        lo = datetime.fromtimestamp(
            ratified - self._config.TAA_ACCEPTANCE_TIME_BEFORE_TAA,
            tz=timezone.utc).date()
        hi = datetime.fromtimestamp(
            req_pp_time + self._config.TAA_ACCEPTANCE_TIME_AFTER_PP_TIME,
            tz=timezone.utc).date()
        if not (lo <= accepted.date() <= hi):
            raise InvalidClientRequest(
                request.identifier, request.reqId,
                "TAA acceptance date {} outside [{}, {}]".format(
                    accepted.date(), lo, hi))
