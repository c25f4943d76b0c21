"""Request handlers — per-txn-type validation/apply logic.

Reference: plenum/server/request_handlers/ — `WriteRequestHandler`,
`ReadRequestHandler` interfaces (handler_interfaces/*.py), concrete NYM
(nym_handler.py), NODE (node_handler.py), GET_TXN (get_txn_handler.py),
audit (audit_handler.py — its batch-level logic lives in
batch_handlers.py here).

A write handler implements:
  static_validation(request)    — schema-level, no state
  dynamic_validation(request)   — against uncommitted state
  update_state(txn, prev, req)  — apply to the head (uncommitted) state
"""
from __future__ import annotations

import json
from abc import ABC, abstractmethod
from typing import Optional

from plenum_tpu_torch.common.constants import (
    DATA, DOMAIN_LEDGER_ID, GET_TXN, NODE, NYM, POOL_LEDGER_ID, ROLE,
    SERVICES, STEWARD, TARGET_NYM, TRUSTEE, TXN_METADATA,
    TXN_METADATA_SEQ_NO, TXN_METADATA_TIME, TXN_PAYLOAD, TXN_PAYLOAD_DATA,
    TXN_PAYLOAD_METADATA, TXN_PAYLOAD_METADATA_FROM, TXN_TYPE, VALIDATOR,
    VERKEY)
from plenum_tpu_torch.common.exceptions import (
    InvalidClientRequest, UnauthorizedClientRequest)
from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.common.txn_util import (
    get_from, get_payload_data, get_seq_no, get_txn_time)
from plenum_tpu_torch.server.database_manager import DatabaseManager
from plenum_tpu_torch.server.execution_lanes import TouchedKeys


class RequestHandler(ABC):
    def __init__(self, database_manager: DatabaseManager, txn_type: str,
                 ledger_id: Optional[int]):
        self.database_manager = database_manager
        self.txn_type = txn_type
        self.ledger_id = ledger_id
        self._ledger = None
        self._state = None

    @property
    def ledger(self):
        # memoized: the registry is fixed after node bootstrap, and this
        # property sits on the per-request apply path (2 dict hops per
        # access adds up at 25-node scale)
        ledger = self._ledger
        if ledger is None:
            ledger = self._ledger = \
                self.database_manager.get_ledger(self.ledger_id)
        return ledger

    @property
    def state(self):
        state = self._state
        if state is None:
            state = self._state = \
                self.database_manager.get_state(self.ledger_id)
        return state


class WriteRequestHandler(RequestHandler):
    @abstractmethod
    def static_validation(self, request: Request): ...

    @abstractmethod
    def dynamic_validation(self, request: Request, req_pp_time=None): ...

    @abstractmethod
    def update_state(self, txn: dict, prev_result, request: Request,
                     is_committed: bool = False): ...

    def touched_keys(self, request: Request):
        """Declared state touches for the conflict-lane executor
        (server/execution_lanes.py): a ``TouchedKeys`` whose read/write
        sets are a SUPERSET of every ``state.get``/``state.set`` key
        this handler's ``dynamic_validation`` + ``update_state`` can
        reach for `request` — computable from the request alone, never
        from state content. Return None when the key set is inherently
        dynamic (whole-state scans, digest chains read from state):
        the request then takes the designated serial lane and is
        excluded from batched read prefetch. Lint rule PT011 flags
        state accesses not reachable from this declaration."""
        return None

    def apply_request(self, request: Request, batch_ts: int):
        """Default apply: reqToTxn + update_state; returns (start, txn)."""
        from plenum_tpu_torch.common.txn_util import (append_txn_metadata, reqToTxn)
        txn = append_txn_metadata(reqToTxn(request), txn_time=batch_ts)
        self.update_state(txn, None, request)
        return txn


class ReadRequestHandler(RequestHandler):
    @abstractmethod
    def get_result(self, request: Request) -> dict: ...

    def make_state_proof(self, key: bytes, root: bytes) -> dict:
        """Structured state proof a client can verify against ONE node:
        {root_hash, proof_nodes, multi_signature?} — the multi-sig from
        the BlsStore is what lets the root itself be trusted without
        f+1 matching replies (reference
        handler_interfaces/read_request_handler.py:39-56: bls_store.get
        on the proof root → MULTI_SIGNATURE in the proof dict)."""
        from plenum_tpu_torch.common.constants import (
            MULTI_SIGNATURE, PROOF_NODES, ROOT_HASH)
        from plenum_tpu_torch.common.serializers.base58 import b58encode
        root_b58 = b58encode(bytes(root))
        proof = {
            ROOT_HASH: root_b58,
            PROOF_NODES: self.state.generate_state_proof(
                key, root=root, serialize=True),
        }
        bls_store = getattr(self.database_manager, "bls_store", None)
        if bls_store is not None:
            multi_sig = bls_store.get(root_b58)
            if multi_sig is not None:
                proof[MULTI_SIGNATURE] = multi_sig.as_dict()
        return proof

    def make_state_proof_batch(self, keys, root, with_values=False):
        """N-key batched form of make_state_proof: proof nodes for every
        key come from ONE state-engine call (level-wise device SHA3,
        shared spine loads — state/device_state.py) and the BLS
        multi-sig for the shared root resolves once, so a single node
        can serve proof-bearing reads at scale. Each returned dict is
        byte-identical to make_state_proof(key, root).

        with_values=True → (values, proof_dicts): the SAME single walk
        resolves every key's value (a proof walk finds it anyway), so
        read serving never pays a second batched walk for the data."""
        from plenum_tpu_torch.common.constants import (
            MULTI_SIGNATURE, PROOF_NODES, ROOT_HASH)
        from plenum_tpu_torch.common.serializers.base58 import b58encode
        root_b58 = b58encode(bytes(root))
        if with_values:
            values, serialized = self.state.get_with_proofs_batch(
                keys, root=root, serialize=True)
        else:
            values = None
            serialized = self.state.generate_state_proof_batch(
                keys, root=root, serialize=True)
        multi_sig_dict = None
        bls_store = getattr(self.database_manager, "bls_store", None)
        if bls_store is not None:
            multi_sig = bls_store.get(root_b58)
            if multi_sig is not None:
                multi_sig_dict = multi_sig.as_dict()
        out = []
        for nodes in serialized:
            proof = {ROOT_HASH: root_b58, PROOF_NODES: nodes}
            if multi_sig_dict is not None:
                # shallow copy: replies are serialized independently and
                # must not alias one mutable dict
                proof[MULTI_SIGNATURE] = dict(multi_sig_dict)
            out.append(proof)
        return (values, out) if with_values else out


class ActionRequestHandler(RequestHandler):
    """Non-ledger actions: validated and executed locally, no consensus
    (reference handler_interfaces/action_request_handler.py)."""

    def __init__(self, database_manager: DatabaseManager, txn_type: str):
        super().__init__(database_manager, txn_type, ledger_id=None)

    def static_validation(self, request: Request):
        pass

    def dynamic_validation(self, request: Request):
        pass

    @abstractmethod
    def process_action(self, request: Request) -> dict: ...


# --------------------------------------------------------------- helpers

# the leaf codec lives in common (clients rebuild proof leaves from it);
# re-exported here for the handler-side callers
from plenum_tpu_torch.common.state_codec import (  # noqa: F401
    decode_state_value, encode_state_value, nym_to_state_key)


# ------------------------------------------------------------------- NYM

class NymHandler(WriteRequestHandler):
    """Reference: plenum/server/request_handlers/nym_handler.py — identity
    registration/rotation on the domain ledger."""

    def __init__(self, database_manager: DatabaseManager):
        super().__init__(database_manager, NYM, DOMAIN_LEDGER_ID)
        # (head_root, state_key) → raw state value, carried from
        # dynamic_validation to the immediately following update_state so
        # the hot apply path walks the trie once per request, not twice
        self._lookup_memo = None
        # identifier → decoded nym record (or None), saving a trie walk
        # + JSON decode per request for repeat authors: author role
        # checks (dynamic validation) AND verkey resolution (client
        # authentication) both hit it, and in a loaded pool most
        # requests in a batch share a handful of authors. Exactly
        # invalidated: update_state pops the nym it writes; any state
        # rewind clears it wholesale (clear_caches)
        self._nym_cache: dict = {}

    def static_validation(self, request: Request):
        op = request.operation
        if not op.get(TARGET_NYM):
            raise InvalidClientRequest(request.identifier, request.reqId,
                                       "NYM must have a dest")
        role = op.get(ROLE)
        if role not in (None, STEWARD, TRUSTEE):
            raise InvalidClientRequest(
                request.identifier, request.reqId,
                "invalid role {}".format(role))

    def touched_keys(self, request: Request):
        """NYM touches exactly two keys, both computable from the
        request: the target nym's record (read in validation, written
        in update_state) and the author's record (role checks via
        cached_nym_record)."""
        dest = request.operation.get(TARGET_NYM)
        if not isinstance(dest, str) or not dest:
            return None
        key = nym_to_state_key(dest)
        reads = [(DOMAIN_LEDGER_ID, key)]
        idr = request.identifier
        if isinstance(idr, str) and idr:
            reads.append((DOMAIN_LEDGER_ID, nym_to_state_key(idr)))
        return TouchedKeys(reads=reads,
                           writes=((DOMAIN_LEDGER_ID, key),))

    def dynamic_validation(self, request: Request, req_pp_time=None):
        op = request.operation
        key = nym_to_state_key(op[TARGET_NYM])
        raw = self.state.get(key, isCommitted=False)
        # memo keyed by the state's mutation counter, NOT headHash —
        # reading headHash would force the write buffer to flush (and
        # hash) once per request, defeating the batched apply
        self._lookup_memo = (getattr(self.state, "mutation_count", None),
                             key, raw)
        existing, _, _ = decode_state_value(raw)
        is_creation = existing is None
        if is_creation:
            # new nym with a privileged role needs a privileged author
            if op.get(ROLE) in (STEWARD, TRUSTEE):
                author = self._author_role(request)
                if author != TRUSTEE:
                    raise UnauthorizedClientRequest(
                        request.identifier, request.reqId,
                        "only TRUSTEE can create {}".format(op.get(ROLE)))
        else:
            # key rotation: only the nym owner may change its verkey
            if VERKEY in op and request.identifier != op[TARGET_NYM]:
                raise UnauthorizedClientRequest(
                    request.identifier, request.reqId,
                    "only the owner can rotate a verkey")
            # role edits (promotion AND demotion) need a TRUSTEE author —
            # otherwise any authenticated client could grant itself
            # TRUSTEE (reference nym_handler dynamic auth rules)
            if ROLE in op and op.get(ROLE) != existing.get(ROLE):
                if self._author_role(request) != TRUSTEE:
                    raise UnauthorizedClientRequest(
                        request.identifier, request.reqId,
                        "only TRUSTEE can change a nym's role")

    _MISS = object()

    def cached_nym_record(self, identifier: str):
        """Decoded uncommitted-state record for a nym (None = absent),
        through the invalidation-exact cache."""
        rec = self._nym_cache.get(identifier, self._MISS)
        if rec is not self._MISS:
            return rec
        rec, _, _ = decode_state_value(self.state.get(
            nym_to_state_key(identifier), isCommitted=False))
        from plenum_tpu_torch.common.config import Config
        if len(self._nym_cache) > Config.NYM_CACHE_MAX:
            self._nym_cache.clear()
        self._nym_cache[identifier] = rec
        return rec

    def _author_role(self, request: Request):
        idr = request.identifier
        if idr is None:
            return None
        return (self.cached_nym_record(idr) or {}).get(ROLE)

    def clear_caches(self):
        """State was rewound under us (batch revert / catchup): every
        cached read may now be stale."""
        self._nym_cache.clear()
        self._lookup_memo = None

    def invalidate_for_writes(self, state_keys):
        """Lane safety for the nym read cache: before a lane-planned
        batch applies, drop every cached record whose state key the
        batch DECLARES it will write. In-order apply already pops the
        written nym at each update_state, so this pre-invalidation is
        a structural guarantee, not a fix for a live bug: whatever
        order lanes resolve their reads in, a record the batch touches
        can never be served from a pre-batch cache entry. Keys that
        don't decode to an identifier clear the cache wholesale (the
        nym key codec is identifier.encode(); anything else means the
        caller's key space changed under us)."""
        for key in state_keys:
            try:
                self._nym_cache.pop(bytes(key).decode(), None)
            except UnicodeDecodeError:
                self._nym_cache.clear()
                return

    def update_state(self, txn: dict, prev_result, request: Request,
                     is_committed: bool = False):
        payload = txn[TXN_PAYLOAD]
        data = payload[TXN_PAYLOAD_DATA]
        md = txn.get(TXN_METADATA) or {}
        seq_no = md.get(TXN_METADATA_SEQ_NO)
        nym = data[TARGET_NYM]
        key = nym_to_state_key(nym)
        memo = self._lookup_memo
        if memo is not None and memo[1] == key and \
                memo[0] == getattr(self.state, "mutation_count", object()):
            raw = memo[2]
        else:
            raw = self.state.get(key, isCommitted=False)
        existing, _, _ = decode_state_value(raw)
        value = dict(existing or {})
        value["identifier"] = payload[TXN_PAYLOAD_METADATA].get(
            TXN_PAYLOAD_METADATA_FROM)
        if ROLE in data:
            value[ROLE] = data[ROLE]
        if VERKEY in data:
            value[VERKEY] = data[VERKEY]
        value.setdefault("seqNo", seq_no)
        self.state.set(key, encode_state_value(
            value, seq_no, md.get(TXN_METADATA_TIME)))
        self._nym_cache.pop(nym, None)
        return value

    def get_nym_details(self, nym: str, is_committed=True):
        return decode_state_value(self.state.get(nym_to_state_key(nym),
                                                 isCommitted=is_committed))


# ------------------------------------------------------------------ NODE

class NodeHandler(WriteRequestHandler):
    """Pool membership: NODE txns add nodes / update services & keys.
    Reference: plenum/server/request_handlers/node_handler.py +
    pool_manager semantics."""

    def __init__(self, database_manager: DatabaseManager,
                 steward_provider=None):
        super().__init__(database_manager, NODE, POOL_LEDGER_ID)
        self._steward_provider = steward_provider
        # aliases seeded at pool construction without pool-ledger NODE
        # records (wired by the node owner): they have no state entry, so
        # without this a steward could "create" a NODE txn reusing a seed
        # alias and hijack/demote a validator it does not own
        self.reserved_aliases = lambda: set()

    def static_validation(self, request: Request):
        op = request.operation
        if not op.get(TARGET_NYM):
            raise InvalidClientRequest(request.identifier, request.reqId,
                                       "NODE must have a dest")
        data = op.get(DATA)
        if not isinstance(data, dict) or not data.get("alias"):
            raise InvalidClientRequest(request.identifier, request.reqId,
                                       "NODE data must include alias")
        services = data.get(SERVICES)
        if services is not None and (
                not isinstance(services, list)
                or any(s != VALIDATOR for s in services)):
            raise InvalidClientRequest(
                request.identifier, request.reqId,
                "services must be a list drawn from ['{}']".format(
                    VALIDATOR))

    def touched_keys(self, request: Request):
        # inherently dynamic key set: alias uniqueness and steward
        # ownership scan the WHOLE pool state head (_committed_aliases /
        # _steward_owns_node), so the touched keys are a function of
        # state content, not of the request — NODE txns take the
        # serial lane (PT011 baseline records the scans as justified)
        return None

    def dynamic_validation(self, request: Request, req_pp_time=None):
        op = request.operation
        existing, _, _ = decode_state_value(self.state.get(
            nym_to_state_key(op[TARGET_NYM]), isCommitted=False))
        data = op.get(DATA, {})
        author_role = self._author_role(request)
        if existing is None:
            # new node: author must be a steward (reference node_handler
            # auth: pool membership writes are steward-gated), one node
            # per steward, alias must be unique
            if author_role not in (STEWARD, TRUSTEE):
                raise UnauthorizedClientRequest(
                    request.identifier, request.reqId,
                    "only a STEWARD or TRUSTEE may add a node")
            if data.get("alias") in self.reserved_aliases() \
                    and author_role != TRUSTEE:
                raise UnauthorizedClientRequest(
                    request.identifier, request.reqId,
                    "alias {} belongs to a genesis validator — only a "
                    "TRUSTEE may write its record".format(
                        data.get("alias")))
            if author_role == STEWARD and self._steward_owns_node(
                    request.identifier):
                raise UnauthorizedClientRequest(
                    request.identifier, request.reqId,
                    "steward already has a node")
            aliases = self._committed_aliases()
            if data.get("alias") in aliases:
                raise InvalidClientRequest(
                    request.identifier, request.reqId,
                    "node alias {} already taken".format(data.get("alias")))
        else:
            # edits: only the owning steward or a TRUSTEE
            if author_role != TRUSTEE and \
                    request.identifier != existing.get("identifier"):
                raise UnauthorizedClientRequest(
                    request.identifier, request.reqId,
                    "only the node's steward or a TRUSTEE may edit it")
            if data.get("alias") and \
                    data["alias"] != existing.get("alias"):
                raise InvalidClientRequest(
                    request.identifier, request.reqId,
                    "node alias cannot change")

    def _author_role(self, request: Request):
        """Author roles live in the DOMAIN state (nym registry)."""
        if request.identifier is None:
            return None
        domain_state = self.database_manager.get_state(DOMAIN_LEDGER_ID)
        if domain_state is None:
            return None
        val, _, _ = decode_state_value(domain_state.get(
            nym_to_state_key(request.identifier), isCommitted=False))
        return (val or {}).get(ROLE)

    def _steward_owns_node(self, steward_nym: str) -> bool:
        for key, value in self.state.head.items():
            val, _, _ = decode_state_value(value)
            if isinstance(val, dict) and \
                    val.get("identifier") == steward_nym:
                return True
        return False

    def _committed_aliases(self):
        aliases = set()
        for key, value in self.state.head.items():
            val, _, _ = decode_state_value(value)
            if isinstance(val, dict) and "alias" in val:
                aliases.add(val["alias"])
        return aliases

    def update_state(self, txn: dict, prev_result, request: Request,
                     is_committed: bool = False):
        data = get_payload_data(txn)
        nym = data[TARGET_NYM]
        existing, _, _ = decode_state_value(
            self.state.get(nym_to_state_key(nym), isCommitted=False))
        value = dict(existing or {})
        value.update(data.get(DATA, {}))
        # record the owning steward on creation (edit authorization key)
        value.setdefault("identifier", get_from(txn))
        self.state.set(nym_to_state_key(nym),
                       encode_state_value(value, get_seq_no(txn),
                                          get_txn_time(txn)))
        return value


# ---------------------------------------------------------------- GET_TXN

class GetTxnHandler(ReadRequestHandler):
    """Reference: plenum/server/request_handlers/get_txn_handler.py."""

    def __init__(self, database_manager: DatabaseManager):
        super().__init__(database_manager, GET_TXN, None)

    def get_result(self, request: Request) -> dict:
        op = request.operation
        lid = op.get("ledgerId", DOMAIN_LEDGER_ID)
        seq_no = op.get(DATA)
        ledger = self.database_manager.get_ledger(lid)
        if ledger is None:
            raise InvalidClientRequest(request.identifier, request.reqId,
                                       "unknown ledger {}".format(lid))
        txn = ledger.getBySeqNo(seq_no) if isinstance(seq_no, int) else None
        return {
            TXN_TYPE: GET_TXN,
            "identifier": request.identifier,
            "reqId": request.reqId,
            "seqNo": seq_no,
            "data": txn,
        }


# ------------------------------------------------------------------- NYM read

class GetNymHandler(ReadRequestHandler):
    def __init__(self, database_manager: DatabaseManager):
        super().__init__(database_manager, "105", DOMAIN_LEDGER_ID)

    def _resolve_root(self, request: Request):
        """Validate the operation and resolve the state root it reads:
        → (nym, state_key, root|None). Shared by the single and the
        batched serving paths so both answer identically."""
        nym = request.operation.get(TARGET_NYM)
        if not isinstance(nym, str) or not nym:
            raise InvalidClientRequest(request.identifier, request.reqId,
                                       "GET_NYM must have a dest")
        key = nym_to_state_key(nym)
        ts = request.operation.get("timestamp")
        if ts is not None and (isinstance(ts, bool)
                               or not isinstance(ts, (int, float))):
            raise InvalidClientRequest(
                request.identifier, request.reqId,
                "timestamp must be a number")
        if ts is not None:
            # state-at-a-time: resolve the committed root at (or before)
            # the timestamp via the ts store; the MPT keeps history, so
            # old roots stay readable and provable (reference
            # state_ts_store + get_nym_handler timestamp path)
            ts_store = self.database_manager.get_store("state_ts")
            root = (ts_store.get_equal_or_prev(ts, self.ledger_id)
                    if ts_store is not None else None)
        else:
            # graceful read degradation: while the node recovers
            # (catchup / view change) reads keep serving the pinned
            # pre-recovery committed root — the newest root that still
            # has a BLS multi-sig — instead of the unsigned
            # intermediate roots catchup commits txn by txn
            root = self.database_manager.pinned_read_root(self.ledger_id)
            if root is None:
                root = self.state.committedHeadHash
        return nym, key, root

    @staticmethod
    def _assemble(request: Request, nym: str, value, proof) -> dict:
        data, seq_no, txn_time = decode_state_value(value)
        return {
            TXN_TYPE: "105",
            "identifier": request.identifier,
            "reqId": request.reqId,
            "dest": nym,
            "data": data,
            "seqNo": seq_no,
            # the client re-encodes (data, seqNo, txnTime) to check the
            # proof leaf byte-for-byte — the time must travel with it
            "txnTime": txn_time,
            "state_proof": proof,
        }

    def get_result(self, request: Request) -> dict:
        nym, key, root = self._resolve_root(request)
        if root is None:
            value, proof = None, None
        else:
            value = self.state.get_for_root_hash(root, key)
            proof = self.make_state_proof(key, root)
        return self._assemble(request, nym, value, proof)

    def get_results_batch(self, requests) -> list:
        """Serve MANY GET_NYMs at once: requests reading the same root
        (the common case — every current-state read shares the
        committed root) resolve their values and their proofs through
        ONE batched state-engine walk each (make_state_proof_batch),
        with the BLS multi-sig looked up once per root. Per-request
        validation failures come back as exception instances in the
        result slots, so one bad request never fails the batch."""
        out: list = [None] * len(requests)
        by_root: dict = {}
        for i, request in enumerate(requests):
            try:
                nym, key, root = self._resolve_root(request)
            except InvalidClientRequest as e:
                out[i] = e
                continue
            if root is None:
                out[i] = self._assemble(request, nym, None, None)
            else:
                by_root.setdefault(bytes(root), []).append(
                    (i, request, nym, key))
        for root, items in by_root.items():
            keys = [key for _, _, _, key in items]
            # ONE walk serves both the values and the proofs
            values, proofs = self.make_state_proof_batch(
                keys, root, with_values=True)
            for (i, request, nym, _), value, proof in zip(items, values,
                                                          proofs):
                out[i] = self._assemble(request, nym, value, proof)
        return out
