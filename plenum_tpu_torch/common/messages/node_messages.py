"""The wire protocol: all inter-node message schemas.

Reference: plenum/common/messages/node_messages.py:26-525 — message op names
and field wire names are kept for parity (they are protocol facts, the
"what"; the implementation around them is new).

Deliberately dropped reference classes (superseded, not missing):

- ``ViewChangeDone`` / ``CurrentState`` (node_messages.py:~500) — the
  *legacy pre-2.0* view-change protocol. This framework implements only
  the reference's own replacement (the "plenum 2.0" consensus used by
  ``ReplicaService``): ``ViewChange`` / ``ViewChangeAck`` / ``NewView``
  below, matching view_change_service.py. Carrying both protocols is
  the dual-path legacy the reference itself was migrating off.
- ``FutureViewChangeDone`` / ``ViewChangeStartMessage`` /
  ``ViewChangeContinueMessage`` — internal shims of that same legacy
  protocol (node restart mid-ViewChangeDone); our restart path recovers
  via the audit ledger + catchup instead (server/node.py restart flow).
- ``PoolLedgerTxns`` — legacy client push of pool txns; clients learn
  the pool via catchup (LedgerStatus/CatchupReq on the client stack).
- ``BlacklistMsg`` — defined but vestigial in the reference (blacklists
  are node-local; nothing ever processes a received BlacklistMsg).
  Suspicion accounting lives in server/blacklister.py.
"""
from plenum_tpu_torch.common.messages.fields import (
    AnyField, AnyMapField, AnyValueField, BatchIDField, BlsMultiSignatureField,
    BooleanField, ChooseField, IterableField, LedgerIdField,
    LimitedLengthStringField, MapField, MerkleRootField, MessageField,
    NonEmptyStringField, NonNegativeNumberField, ProtocolVersionField,
    SerializedValueField, SignatureField, StringifiedNonNegativeNumberField,
    TimestampField, ViewChangeField)
from plenum_tpu_torch.common.messages.message_base import MessageBase

# ---------------------------------------------------------------- transport

class Batch(MessageBase):
    """Outbox coalescing envelope (reference node_messages.py:26,
    plenum/common/batched.py)."""
    typename = "BATCH"
    schema = (
        ("messages", IterableField(SerializedValueField())),
        ("signature", SignatureField(nullable=True)),
    )


# ------------------------------------------------------------ client-facing

class RequestAck(MessageBase):
    typename = "REQACK"
    schema = (
        ("identifier", LimitedLengthStringField()),
        ("reqId", NonNegativeNumberField()),
    )


class RequestNack(MessageBase):
    typename = "REQNACK"
    schema = (
        ("identifier", LimitedLengthStringField()),
        ("reqId", NonNegativeNumberField()),
        ("reason", LimitedLengthStringField(max_length=4096)),
    )


class Reject(MessageBase):
    typename = "REJECT"
    schema = (
        ("identifier", LimitedLengthStringField()),
        ("reqId", NonNegativeNumberField()),
        ("reason", LimitedLengthStringField(max_length=4096)),
    )


class Reply(MessageBase):
    typename = "REPLY"
    schema = (
        ("result", AnyMapField()),
    )


# ------------------------------------------------------------- propagation

class Propagate(MessageBase):
    typename = "PROPAGATE"
    schema = (
        ("request", AnyMapField()),
        ("senderClient", LimitedLengthStringField(nullable=True)),
    )


class PropagateBatch(MessageBase):
    """Many PROPAGATEs in one wire message (no reference equivalent —
    the reference sends one PROPAGATE per request, plenum/server/
    propagator.py:204, and amortizes only at the ZMQ frame layer).
    At n nodes every request is handled n-1 times per node; batching at
    the MESSAGE level amortizes handler dispatch, validation, and sim/
    transport delivery across a whole tick of requests — the difference
    between the 25-node pool collapsing and draining. `clients` uses ""
    for requests whose submitting client is unknown."""

    typename = "PROPAGATE_BATCH"
    schema = (
        ("requests", IterableField(AnyMapField(), min_length=1)),
        # "" = submitting client unknown (relay hop)
        ("clients", IterableField(AnyField())),
        # advisory causal stamp [origin, flush_seq, perf_ts, wall_ts]
        # (flat_wire.TraceStamp.as_list) — observability-only; malformed
        # content decodes to None and never affects request handling
        ("traceCtx", AnyField(nullable=True, optional=True)),
    )


# ----------------------------------------------------------------- 3PC

class PrePrepare(MessageBase):
    typename = "PREPREPARE"
    schema = (
        ("instId", NonNegativeNumberField()),
        ("viewNo", NonNegativeNumberField()),
        ("ppSeqNo", NonNegativeNumberField()),
        ("ppTime", TimestampField()),
        ("reqIdr", IterableField(NonEmptyStringField())),   # request digests
        ("discarded", StringifiedNonNegativeNumberField(nullable=True)),
        ("digest", NonEmptyStringField()),
        ("ledgerId", LedgerIdField()),
        ("stateRootHash", MerkleRootField(nullable=True)),
        ("txnRootHash", MerkleRootField(nullable=True)),
        ("sub_seq_no", NonNegativeNumberField()),
        ("final", BooleanField()),
        ("poolStateRootHash", MerkleRootField(nullable=True, optional=True)),
        ("auditTxnRootHash", MerkleRootField(nullable=True, optional=True)),
        ("blsMultiSig", BlsMultiSignatureField(nullable=True, optional=True)),
        ("blsMultiSigs", IterableField(BlsMultiSignatureField(),
                                       nullable=True, optional=True)),
        ("originalViewNo", NonNegativeNumberField(nullable=True, optional=True)),
    )


class Prepare(MessageBase):
    typename = "PREPARE"
    schema = (
        ("instId", NonNegativeNumberField()),
        ("viewNo", NonNegativeNumberField()),
        ("ppSeqNo", NonNegativeNumberField()),
        ("ppTime", TimestampField()),
        ("digest", NonEmptyStringField()),
        ("stateRootHash", MerkleRootField(nullable=True)),
        ("txnRootHash", MerkleRootField(nullable=True)),
        ("auditTxnRootHash", MerkleRootField(nullable=True, optional=True)),
    )


class Commit(MessageBase):
    typename = "COMMIT"
    schema = (
        ("instId", NonNegativeNumberField()),
        ("viewNo", NonNegativeNumberField()),
        ("ppSeqNo", NonNegativeNumberField()),
        ("blsSig", NonEmptyStringField(nullable=True, optional=True)),
        ("blsSigs", MapField(StringifiedNonNegativeNumberField(),
                             NonEmptyStringField(),
                             nullable=True, optional=True)),
    )


class ThreePCBatch(MessageBase):
    """One sender's whole tick of broadcast 3PC votes — PRE-PREPAREs,
    PREPAREs and COMMITs across ALL of its protocol instances — in ONE
    wire message (no reference equivalent; the reference sends each vote
    separately and amortizes only at the ZMQ frame layer). At n nodes
    with f+1 RBFT instances every 3PC phase is otherwise its own
    broadcast per instance per in-flight batch; coalescing at the
    MESSAGE level amortizes serialization (one msgpack pack for the
    whole batch), transport delivery, and receive-side dispatch — and
    hands the receiver a COLUMN of same-sender votes for the columnar
    `process_prepare_batch` / `process_commit_batch` intake.

    `messages` entries are the inner messages' `to_dict()` wire form
    (op field included) in SEND ORDER — FIFO per sender preserves the
    PP-before-PREPARE-before-COMMIT causality the per-message wire had.
    In-process transports (SimNetwork) deliver live MessageBase objects
    instead; `as_dict` normalizes to wire form only when a real
    transport serializes the envelope."""

    typename = "THREE_PC_BATCH"
    schema = (
        ("messages", IterableField(AnyField(), min_length=1)),
        # advisory causal stamp [origin, flush_seq, perf_ts, wall_ts]
        # (flat_wire.TraceStamp.as_list) — observability-only; malformed
        # content decodes to None and never affects vote handling
        ("traceCtx", AnyField(nullable=True, optional=True)),
    )

    def as_dict(self):
        d = {"messages": [
            m.to_dict() if isinstance(m, MessageBase) else m
            for m in self.messages]}
        if getattr(self, "traceCtx", None) is not None:
            d["traceCtx"] = list(self.traceCtx)
        return d


class FlatBatch(MessageBase):
    """Flat zero-copy wire envelope (common/serializers/flat_wire.py):
    PREPARE/COMMIT votes as contiguous typed columns, PRE-PREPAREs and
    PROPAGATEs as length-prefixed sections — ONE pack and ONE parse per
    peer per tick, zero intermediate Python message objects on the
    receive path. The payload is opaque bytes to the transport (msgpack
    wraps it as a single bin field, no canonical-sort recursion into
    the votes); `to_legacy_messages` re-materializes typed messages for
    the fault-injection unwrap seams. The typed THREE_PC_BATCH /
    PROPAGATE_BATCH path stays as validated fallback
    (Config.FLAT_WIRE=False or an installed adversary tap)."""

    typename = "FLAT_WIRE"
    schema = (
        ("payload", SerializedValueField()),
    )


class Ordered(MessageBase):
    typename = "ORDERED"
    schema = (
        ("instId", NonNegativeNumberField()),
        ("viewNo", NonNegativeNumberField()),
        ("valid_reqIdr", IterableField(NonEmptyStringField())),
        ("invalid_reqIdr", IterableField(NonEmptyStringField())),
        ("ppSeqNo", NonNegativeNumberField()),
        ("ppTime", TimestampField()),
        ("ledgerId", LedgerIdField()),
        ("stateRootHash", MerkleRootField(nullable=True)),
        ("txnRootHash", MerkleRootField(nullable=True)),
        ("auditTxnRootHash", MerkleRootField(nullable=True, optional=True)),
        ("primaries", IterableField(NonEmptyStringField())),
        ("nodeReg", IterableField(NonEmptyStringField(), nullable=True,
                                  optional=True)),
        ("originalViewNo", NonNegativeNumberField(nullable=True, optional=True)),
        ("digest", NonEmptyStringField(nullable=True, optional=True)),
    )


class Checkpoint(MessageBase):
    typename = "CHECKPOINT"
    schema = (
        ("instId", NonNegativeNumberField()),
        ("viewNo", NonNegativeNumberField()),
        ("seqNoStart", NonNegativeNumberField()),
        ("seqNoEnd", NonNegativeNumberField()),
        ("digest", NonEmptyStringField()),
    )


# ----------------------------------------------------------- view change

class InstanceChange(MessageBase):
    typename = "INSTANCE_CHANGE"
    schema = (
        ("viewNo", NonNegativeNumberField()),
        ("reason", NonNegativeNumberField()),
    )


class ViewChange(MessageBase):
    typename = "VIEW_CHANGE"
    schema = (
        ("viewNo", NonNegativeNumberField()),
        ("stableCheckpoint", NonNegativeNumberField()),
        ("prepared", IterableField(BatchIDField())),
        ("preprepared", IterableField(BatchIDField())),
        ("checkpoints", IterableField(AnyMapField())),  # Checkpoint dicts
    )


class ViewChangeAck(MessageBase):
    typename = "VIEW_CHANGE_ACK"
    schema = (
        ("viewNo", NonNegativeNumberField()),
        ("name", NonEmptyStringField()),
        ("digest", NonEmptyStringField()),
    )


class NewView(MessageBase):
    typename = "NEW_VIEW"
    schema = (
        ("viewNo", NonNegativeNumberField()),
        ("viewChanges", IterableField(ViewChangeField())),
        ("checkpoint", AnyMapField(nullable=True)),      # Checkpoint dict
        ("batches", IterableField(BatchIDField())),
        ("primary", NonEmptyStringField(nullable=True, optional=True)),
    )


class OldViewPrePrepareRequest(MessageBase):
    typename = "OLD_VIEW_PREPREPARE_REQ"
    schema = (
        ("instId", NonNegativeNumberField()),
        ("batch_ids", IterableField(BatchIDField())),
    )


class OldViewPrePrepareReply(MessageBase):
    typename = "OLD_VIEW_PREPREPARE_REP"
    schema = (
        ("instId", NonNegativeNumberField()),
        ("preprepares", IterableField(AnyMapField())),
    )


# --------------------------------------------------------------- catchup

class LedgerStatus(MessageBase):
    typename = "LEDGER_STATUS"
    schema = (
        ("ledgerId", LedgerIdField()),
        ("txnSeqNo", NonNegativeNumberField()),
        ("viewNo", NonNegativeNumberField(nullable=True)),
        ("ppSeqNo", NonNegativeNumberField(nullable=True)),
        ("merkleRoot", MerkleRootField()),
        ("protocolVersion", ProtocolVersionField(nullable=True)),
    )


class ConsistencyProof(MessageBase):
    typename = "CONSISTENCY_PROOF"
    schema = (
        ("ledgerId", LedgerIdField()),
        ("seqNoStart", NonNegativeNumberField()),
        ("seqNoEnd", NonNegativeNumberField()),
        ("viewNo", NonNegativeNumberField(nullable=True)),
        ("ppSeqNo", NonNegativeNumberField(nullable=True)),
        ("oldMerkleRoot", MerkleRootField()),
        ("newMerkleRoot", MerkleRootField()),
        ("hashes", IterableField(NonEmptyStringField())),
    )


class CatchupReq(MessageBase):
    typename = "CATCHUP_REQ"
    schema = (
        ("ledgerId", LedgerIdField()),
        ("seqNoStart", NonNegativeNumberField()),
        ("seqNoEnd", NonNegativeNumberField()),
        ("catchupTill", NonNegativeNumberField()),
    )


class CatchupRep(MessageBase):
    typename = "CATCHUP_REP"
    schema = (
        ("ledgerId", LedgerIdField()),
        ("txns", MapField(StringifiedNonNegativeNumberField(), AnyMapField())),
        ("consProof", IterableField(NonEmptyStringField())),
        # optional per-txn RFC 6962 audit paths (seqNo → b58 sibling
        # hashes) against the leecher's agreed (target_size, target_root)
        # — lets a leecher reject a lying chunk at rep time instead of
        # after buffering the whole range; absent from legacy reps
        ("auditPaths", MapField(StringifiedNonNegativeNumberField(),
                                IterableField(NonEmptyStringField()),
                                optional=True, nullable=True)),
    )


# ----------------------------------------------------- message re-request

class MessageReq(MessageBase):
    """Request a missing protocol message (reference node_messages.py:460)."""
    typename = "MESSAGE_REQUEST"
    allowed_types = {"LEDGER_STATUS", "CONSISTENCY_PROOF", "PREPREPARE",
                     "PREPARE", "COMMIT", "PROPAGATE", "VIEW_CHANGE",
                     "NEW_VIEW"}
    schema = (
        ("msg_type", ChooseField(values=allowed_types)),
        ("params", AnyMapField()),
    )


class MessageRep(MessageBase):
    typename = "MESSAGE_RESPONSE"
    schema = (
        ("msg_type", ChooseField(values=MessageReq.allowed_types)),
        ("params", AnyMapField()),
        ("msg", AnyValueField()),
    )


# ---------------------------------------------------------------- observer

class BatchCommitted(MessageBase):
    typename = "BATCH_COMMITTED"
    schema = (
        ("requests", IterableField(AnyMapField())),
        ("ledgerId", LedgerIdField()),
        ("instId", NonNegativeNumberField()),
        ("viewNo", NonNegativeNumberField()),
        ("ppSeqNo", NonNegativeNumberField()),
        ("ppTime", TimestampField()),
        ("stateRoot", MerkleRootField(nullable=True)),
        ("txnRoot", MerkleRootField(nullable=True)),
        ("seqNoStart", NonNegativeNumberField()),
        ("seqNoEnd", NonNegativeNumberField()),
        ("auditTxnRootHash", MerkleRootField(nullable=True, optional=True)),
        ("primaries", IterableField(NonEmptyStringField())),
        ("nodeReg", IterableField(NonEmptyStringField(), nullable=True,
                                  optional=True)),
        ("originalViewNo", NonNegativeNumberField(nullable=True, optional=True)),
        ("digest", NonEmptyStringField(nullable=True, optional=True)),
    )


class ObservedData(MessageBase):
    typename = "OBSERVED_DATA"
    schema = (
        ("msg_type", ChooseField(values={"BATCH"})),
        ("msg", AnyField()),
    )


# ------------------------------------------------------- replica lifecycle

class BackupInstanceFaulty(MessageBase):
    typename = "BACKUP_INSTANCE_FAULTY"
    schema = (
        ("viewNo", NonNegativeNumberField()),
        ("instances", IterableField(NonNegativeNumberField())),
        ("reason", NonNegativeNumberField()),
    )
