"""Pool client: signs, submits, and confirms requests against a pool.

The reference keeps only the Wallet in-tree (plenum/client/wallet.py)
and delegates the full client to the external SDK; this framework ships
the client too, because rung-2/3 testing and the ops scripts need one:

- submit to all nodes (or a subset), track REQACK / REQNACK / REJECT
- confirm a request once f+1 nodes return matching Reply results
  (Quorums.reply — the BFT read quorum on write acks)
- accept a state-proof-bearing read from ONE node when the proof's
  BLS multi-signature verifies against the pool's registered keys
  (reference read_request_handler.py:39-56 attaches the multi-sig
  precisely so clients don't need f+1 matching answers)
- timer-driven resubmission of unconfirmed requests

Transport-agnostic: `send_fn(node_name, msg_dict)` is injected — the
SimNetwork client channel in tests, the TCP client stack in deployment
(server side: plenum_tpu_torch/server/networked_node.py clientstack).
Inbound replies are fed to `receive(node_name, msg)` as either
MessageBase objects or wire dicts.

Port of plenum_tpu/client/client.py (RequestStatus, PoolClient) on the
port's modules; the state-proof checks give the JAX package's verdicts and
message strings.
"""
from __future__ import annotations

import json
import logging
from typing import Callable, Dict, List, Optional, Sequence

from plenum_tpu_torch.common.constants import OP_FIELD_NAME
from plenum_tpu_torch.common.messages.node_messages import (
    Reject, Reply, RequestAck, RequestNack)
from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.consensus.quorums import Quorums
from plenum_tpu_torch.runtime.timer import RepeatingTimer, TimerService
from plenum_tpu_torch.client.wallet import Wallet

# what attacker-controlled proof bytes can raise on their way into the
# aggregate check once _check_proof_pre has let them through (base58
# text, an n-f set of registered keys): each reads as "the proof does
# not verify". Anything else — a kernel failure on the card
# (RuntimeError) above all — is not a verdict on the proof and surfaces
PROOF_INPUT_ERRORS = (ValueError, KeyError, TypeError)

logger = logging.getLogger(__name__)

_CLIENT_MSG_CLASSES = {c.typename: c for c in
                       (Reply, RequestAck, RequestNack, Reject)}


class RequestStatus:
    """Per-request bookkeeping: who acked/nacked, which results arrived."""

    def __init__(self, req: Request):
        self.request = req
        self.acks: set = set()
        self.nacks: Dict[str, str] = {}
        self.rejects: Dict[str, str] = {}
        self.replies: Dict[str, dict] = {}   # node -> result
        self.confirmed_result: Optional[dict] = None
        self.failed: bool = False            # terminally nacked/rejected
        self.proven: bool = False            # accepted via state proof

    @property
    def key(self):
        return (self.request.identifier, self.request.reqId)


def _result_fingerprint(result: dict) -> str:
    """Node-agnostic identity of a Reply result for quorum matching."""
    return json.dumps(result, sort_keys=True, default=str)


class PoolClient:
    def __init__(self, wallet: Wallet, node_names: Sequence[str],
                 send_fn: Callable[[str, dict], None],
                 timer: TimerService = None,
                 resubmit_interval: float = 15.0,
                 bls_verifier=None,
                 bls_key_provider: Callable[[str], Optional[str]] = None,
                 proof_max_age: Optional[float] = None,
                 get_time: Callable[[], float] = None):
        """bls_verifier + bls_key_provider(node_name → BLS pk) enable
        single-node trust for proof-bearing reads; without them every
        read needs the f+1 matching-reply quorum.

        proof_max_age (seconds, against get_time — wall clock by
        default): reject single-node proofs whose multi-sig timestamp
        is older than this, EXCEPT for reads that explicitly ask for
        historical state (operation carries a timestamp). Without a
        window, one malicious node can answer a current-state read
        with a genuine-but-stale proof (e.g. an absence proof captured
        before the value was written)."""
        import time as _time
        self.wallet = wallet
        self.node_names = list(node_names)
        self._send = send_fn
        self.quorums = Quorums(len(self.node_names))
        self._bls_verifier = bls_verifier
        self._bls_keys = bls_key_provider
        self._proof_max_age = proof_max_age
        self._get_time = get_time or _time.time
        self._pending: Dict[tuple, RequestStatus] = {}
        self._completed: Dict[tuple, RequestStatus] = {}
        self._resubmitter = None
        if timer is not None and resubmit_interval > 0:
            self._resubmitter = RepeatingTimer(
                timer, resubmit_interval, self._resubmit_pending)

    # ---------------------------------------------------------- submit

    def submit(self, operation: dict, identifier: str = None,
               taa_acceptance: dict = None) -> Request:
        """Sign an operation with the wallet and send it to every node."""
        req = self.wallet.sign_op(operation, identifier=identifier,
                                  taa_acceptance=taa_acceptance)
        return self.submit_request(req)

    def submit_request(self, req: Request) -> Request:
        status = RequestStatus(req)
        self._pending[status.key] = status
        self._broadcast(req)
        return req

    def _broadcast(self, req: Request):
        for name in self.node_names:
            try:
                self._send(name, req.as_dict())
            except Exception:
                logger.warning("send to %s failed", name, exc_info=True)

    def _resubmit_pending(self):
        for status in list(self._pending.values()):
            self._broadcast(status.request)

    # --------------------------------------------------------- receive

    def receive(self, node_name: str, msg) -> None:
        """Feed one inbound client-stack message (object or wire dict)."""
        if isinstance(msg, dict):
            msg = self._from_wire(msg)
            if msg is None:
                return
        if isinstance(msg, Reply):
            self._on_reply(node_name, msg)
        elif isinstance(msg, RequestAck):
            self._on_status(node_name, msg, "acks")
        elif isinstance(msg, RequestNack):
            self._on_status(node_name, msg, "nacks")
        elif isinstance(msg, Reject):
            self._on_status(node_name, msg, "rejects")

    @staticmethod
    def _result_key(result: dict):
        """(identifier, reqId) from a Reply result — write results are
        committed txns (author/reqId under txn.metadata, txn_util
        format), read results carry them at top level."""
        try:
            from plenum_tpu_torch.common.txn_util import get_from, get_req_id
            frm, rid = get_from(result), get_req_id(result)
            if frm is not None or rid is not None:
                return (frm, rid)
        except Exception:
            pass
        return (result.get("identifier"), result.get("reqId"))

    @staticmethod
    def _from_wire(d: dict):
        cls = _CLIENT_MSG_CLASSES.get(d.get(OP_FIELD_NAME))
        if cls is None:
            return None
        fields = {k: v for k, v in d.items() if k != OP_FIELD_NAME}
        try:
            return cls(**fields)
        except Exception:
            logger.warning("malformed client-stack message: %r", d)
            return None

    def _on_status(self, node_name: str, msg, bucket: str):
        key = (msg.identifier, msg.reqId)
        status = self._pending.get(key) or self._completed.get(key)
        if status is None:
            return
        if bucket == "acks":
            status.acks.add(node_name)
            return
        getattr(status, bucket)[node_name] = msg.reason
        # terminal failure: once n-f nodes nacked/rejected, fewer than
        # f+1 can ever produce matching Replies — stop resubmitting
        refused = set(status.nacks) | set(status.rejects)
        if (key in self._pending
                and self.quorums.strong.is_reached(len(refused))):
            status.failed = True
            self._completed[key] = self._pending.pop(key)

    def _on_reply(self, node_name: str, msg: Reply):
        result = msg.result or {}
        key = self._result_key(result)
        status = self._pending.get(key)
        if status is None:
            return
        status.replies[node_name] = result
        # a verified state proof makes THIS single reply trustworthy:
        # the multi-sig (n-f nodes) vouches for the root, the proof
        # nodes tie the value to the root — no reply quorum needed. The
        # proof is only trusted for the REQUEST's own question: a reply
        # whose dest/type differ from what we asked carries a possibly
        # valid proof of the wrong fact (single-node substitution). The
        # freshness window applies to current-state reads only — a read
        # that names a timestamp WANTS an old root
        if self._proof_answers_request(status.request, result):
            historical = (status.request.operation or {}).get(
                "timestamp") is not None
            max_age = None if historical else self._proof_max_age
            if self.verify_state_proof(result, max_age=max_age,
                                       now=self._get_time()):
                status.confirmed_result = result
                status.proven = True
                self._completed[key] = self._pending.pop(key)
                return
        by_fp: Dict[str, List[str]] = {}
        for node, res in status.replies.items():
            by_fp.setdefault(_result_fingerprint(res), []).append(node)
        for fp, nodes in by_fp.items():
            if self.quorums.reply.is_reached(len(nodes)):
                status.confirmed_result = status.replies[nodes[0]]
                self._completed[key] = self._pending.pop(key)
                break

    # ----------------------------------------------------- state proofs

    @staticmethod
    def _proof_answers_request(req: Request, result: dict) -> bool:
        """The proof path is only valid when the result claims to answer
        exactly the operation we asked: same read type, same dest.
        Writes and mismatched reads always go through the reply
        quorum — otherwise one malicious node could 'confirm' a pending
        request with a valid proof of some unrelated fact."""
        from plenum_tpu_torch.common.constants import TARGET_NYM, TXN_TYPE
        op = req.operation or {}
        if op.get(TXN_TYPE) != "105":
            return False
        return (isinstance(result, dict)
                and result.get(TXN_TYPE) == "105"
                and result.get("dest") == op.get(TARGET_NYM))

    def verify_state_proof(self, result: dict,
                           max_age: Optional[float] = None,
                           now: Optional[float] = None) -> bool:
        """True iff `result` carries a state proof whose BLS multi-sig
        verifies against n-f registered pool keys AND whose proof nodes
        tie the claimed value to the signed root. Every check fails
        closed: a reply that can't be proven simply falls back to the
        reply quorum.

        max_age (seconds, with `now`) additionally rejects proofs whose
        multi-sig timestamp is older than the window — without it a
        single node can serve provably-stale state (a valid multi-sig
        over an OLD root, e.g. an absence proof predating a committed
        write). Leave it None for historical (timestamped) queries,
        where an old root is the point."""
        if not isinstance(result, dict):
            return False
        from plenum_tpu_torch.common.constants import STATE_PROOF
        # 1. cheap shape checks first — no pairing work for a reply
        # that could never be proof-confirmed
        kv = self._expected_state_kv(result)
        if kv is None:
            return False
        state_key, state_value = kv
        return self.verify_proof_dict(result.get(STATE_PROOF), state_key,
                                      state_value, max_age=max_age,
                                      now=now)

    def verify_proof_dict(self, sp, key: bytes, value: Optional[bytes],
                          ledger_id: Optional[int] = None,
                          max_age: Optional[float] = None,
                          now: Optional[float] = None) -> bool:
        """End-to-end check of ONE `{root_hash, proof_nodes,
        multi_signature}` dict as produced by the server's
        make_state_proof / make_state_proof_batch: the BLS multi-sig
        must verify against n-f registered pool keys AND vouch for
        exactly the proof's root on `ledger_id` (domain by default),
        and the proof nodes must tie `value` (or its absence, value
        None) to that root. Every check fails closed; callers that
        need to KNOW which check failed (the gateway's signed-read
        cache, diagnostics) use ``check_proof_dict``."""
        return self.check_proof_dict(sp, key, value, ledger_id=ledger_id,
                                     max_age=max_age, now=now) is None

    def check_proof_dict(self, sp, key: bytes, value: Optional[bytes],
                         ledger_id: Optional[int] = None,
                         max_age: Optional[float] = None,
                         now: Optional[float] = None) -> Optional[str]:
        """``verify_proof_dict`` with an attributable verdict: None on
        success, else a message NAMING the first failed check — a root
        mismatch (the multi-sig vouches for a different root than the
        proof claims), proof-node corruption (undecodable trie data or
        nodes that do not tie the value to the root) and an invalid
        multi-signature are different operational facts: the first is
        a stale/substituted answer, the second a mangled proof, the
        third a forged (or mis-keyed) signature."""
        pre = self._check_proof_pre(sp, ledger_id, max_age, now)
        if isinstance(pre, str):
            return pre
        multi, keys = pre
        # 4. the aggregated signature itself (the expensive pairing)
        try:
            sig_ok = self._bls_verifier.verify_multi_sig(
                multi.signature, multi.value.as_single_value(), keys)
        except PROOF_INPUT_ERRORS as e:
            return "multi-sig invalid: aggregate verification " \
                   "raised (%s)" % e
        if not sig_ok:
            return "multi-sig invalid: aggregate signature does not " \
                   "verify against the registered keys"
        return self._check_proof_nodes(sp, key, value)

    def check_proof_dicts(self, checks,
                          ledger_id: Optional[int] = None,
                          max_age: Optional[float] = None,
                          now: Optional[float] = None) -> list:
        """``check_proof_dict`` over a batch of (sp, key, value)
        triples sharing one ledger/freshness context → verdict per
        item. The cheap structural checks run per proof; every
        surviving proof's aggregate pairing then goes through ONE
        ``verify_multi_sigs_batch`` call — a single launch of the pairing
        kernel (ops/bls381_pairing.py) at or above the verifier's
        pairing_device_min (the signed-read seam this batches is the same
        check the gateway cache admits on)."""
        results = [None] * len(checks)
        pending = []
        for i, (sp, key, value) in enumerate(checks):
            pre = self._check_proof_pre(sp, ledger_id, max_age, now)
            if isinstance(pre, str):
                results[i] = pre
            else:
                pending.append((i, pre[0], pre[1]))
        if not pending:
            return results
        try:
            verdicts = self._bls_verifier.verify_multi_sigs_batch(
                [(m.signature, m.value.as_single_value(), keys)
                 for _, m, keys in pending])
        except PROOF_INPUT_ERRORS as e:
            msg = "multi-sig invalid: aggregate verification " \
                  "raised (%s)" % e
            for i, _, _ in pending:
                results[i] = msg
            return results
        for (i, _, _), ok in zip(pending, verdicts):
            if not ok:
                results[i] = "multi-sig invalid: aggregate signature " \
                             "does not verify against the registered keys"
            else:
                sp, key, value = checks[i]
                results[i] = self._check_proof_nodes(sp, key, value)
        return results

    def _check_proof_pre(self, sp, ledger_id, max_age, now):
        """Steps 1-3 of ``check_proof_dict`` (everything before the
        pairing): an error string, or (MultiSignature, keys) ready for
        the aggregate check."""
        if self._bls_verifier is None or self._bls_keys is None:
            return "no BLS verifier/keys configured"
        from plenum_tpu_torch.common.constants import (
            DOMAIN_LEDGER_ID, MULTI_SIGNATURE, PROOF_NODES, ROOT_HASH)
        if ledger_id is None:
            ledger_id = DOMAIN_LEDGER_ID
        if not isinstance(sp, dict) or MULTI_SIGNATURE not in sp:
            return "malformed state proof: not a dict with a " \
                   "multi-signature"
        try:
            from plenum_tpu_torch.crypto.bls import MultiSignature
            multi = MultiSignature.from_dict(sp[MULTI_SIGNATURE])
        except Exception as e:
            return "multi-sig invalid: unparseable multi-signature " \
                   "(%s)" % e
        # 2. the multi-sig must vouch for exactly the proof's root, on
        # the ledger this read serves, and recently enough
        if multi.value.state_root_hash != sp.get(ROOT_HASH):
            return "root mismatch: multi-signature vouches for root " \
                   "%r, proof claims %r" % (multi.value.state_root_hash,
                                            sp.get(ROOT_HASH))
        if multi.value.ledger_id != ledger_id:
            return "ledger mismatch: multi-signature covers ledger " \
                   "%r, read serves %r" % (multi.value.ledger_id,
                                           ledger_id)
        if max_age is not None:
            ts = multi.value.timestamp
            ref = now if now is not None else __import__("time").time()
            if not isinstance(ts, (int, float)) or ref - ts > max_age:
                return "stale proof: multi-signature timestamp %r " \
                       "outside the %.0fs freshness window" % (ts,
                                                               max_age)
        # 3. enough distinct, registered signers (n-f)
        participants = list(multi.participants)
        try:
            distinct = len(set(participants))
        except TypeError:   # a list or dict where a name should be
            return "multi-sig invalid: unparseable multi-signature " \
                   "(participant names are not hashable)"
        if distinct != len(participants):
            return "multi-sig invalid: duplicate participants"
        if not self.quorums.bls_signatures.is_reached(len(participants)):
            return "multi-sig invalid: %d signers below the n-f " \
                   "quorum" % len(participants)
        keys = []
        for name in participants:
            # participant names are proof-controlled input: a provider
            # that raises on a stranger (dict lookup) must read as
            # "unregistered", not as a crash
            try:
                pk = self._bls_keys(name)
            except (KeyError, TypeError, AttributeError):
                pk = None
            if pk is None:
                return "multi-sig invalid: unregistered signer %r" % name
            keys.append(pk)
        # the signature is proof-controlled too: only text reaches the
        # base58 codec, whose Python version raises AttributeError on
        # anything else (the native one TypeError); checked last, where
        # the aggregate check would read it, so every earlier check
        # names the same failure as in the reference
        if not isinstance(multi.signature, (str, bytes)):
            return "multi-sig invalid: unparseable multi-signature " \
                   "(signature is not text: %r)" % (multi.signature,)
        return multi, keys

    @staticmethod
    def _check_proof_nodes(sp, key: bytes,
                           value: Optional[bytes]) -> Optional[str]:
        """Step 5 of ``check_proof_dict``: the proof nodes must tie
        `value` (or its absence) to the signed root."""
        from plenum_tpu_torch.common.constants import PROOF_NODES, ROOT_HASH
        try:
            from plenum_tpu_torch.common.serializers.base58 import b58decode
            from plenum_tpu_torch.state.pruning_state import PruningState
            root = b58decode(sp[ROOT_HASH])
            nodes = PruningState.deserialize_proof(sp[PROOF_NODES])
        except Exception as e:
            return "proof-node corruption: undecodable proof data " \
                   "(%s)" % e
        try:
            proven = PruningState.verify_state_proof(
                root, key, value, nodes)
        except Exception as e:
            return "proof-node corruption: proof walk raised (%s)" % e
        if not proven:
            return "proof-node corruption: proof nodes do not tie " \
                   "the claimed value to the signed root"
        return None

    @staticmethod
    def _expected_state_kv(result: dict):
        """(state_key, expected_encoded_value|None) for a read result,
        or None when the result type has no state mapping. The encoding
        must match the write handler's byte-for-byte (GET_NYM:
        request_handlers.nym_to_state_key / encode_state_value)."""
        from plenum_tpu_torch.common.constants import TXN_TYPE
        if result.get(TXN_TYPE) != "105":
            return None
        dest = result.get("dest")
        if not isinstance(dest, str) or not dest:
            return None
        from plenum_tpu_torch.common.state_codec import (
            encode_state_value, nym_to_state_key)
        key = nym_to_state_key(dest)
        if result.get("data") is None:
            return key, None  # proof of absence
        return key, encode_state_value(result["data"], result.get("seqNo"),
                                       result.get("txnTime"))

    # ----------------------------------------------------------- query

    def status_of(self, req: Request) -> Optional[RequestStatus]:
        key = (req.identifier, req.reqId)
        return self._pending.get(key) or self._completed.get(key)

    def result_of(self, req: Request) -> Optional[dict]:
        status = self.status_of(req)
        return status.confirmed_result if status else None

    def is_confirmed(self, req: Request) -> bool:
        return self.result_of(req) is not None

    @property
    def pending_count(self) -> int:
        return len(self._pending)

    def close(self):
        if self._resubmitter is not None:
            self._resubmitter.stop()
