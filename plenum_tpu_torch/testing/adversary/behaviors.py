"""Pluggable malicious behaviors, mirroring the reference corpus
(plenum/test/malicious_behaviors_node.py): equivocating primary,
duplicate/conflicting 3PC, tampered PROPAGATE payloads, poisoned
deferred BLS shares, and per-link delay/reorder/drop/corrupt faults.

A Behavior is a send/recv transformer installed on ONE adversarial
node's network seam by the AdversaryController. Both hooks follow the
ExternalBus tap protocol: return ``None`` to pass the message through
unchanged, or a list of (message, destination) pairs that replaces it
(empty list = swallow). All randomness MUST come from
``self.controller.random`` so a fixed seed reproduces the identical
fault trace."""
from __future__ import annotations

import logging
from typing import List, Optional, Tuple

from plenum_tpu_torch.common.messages.node_messages import (
    CatchupRep, Commit, ConsistencyProof, MessageRep, NewView,
    PrePrepare, Prepare, Propagate, PropagateBatch)

logger = logging.getLogger(__name__)


class Behavior:
    """Base: benign pass-through. Subclasses override on_send /
    on_incoming / on_tick."""

    name = "behavior"

    def __init__(self):
        self.controller = None
        self.node_name = None

    def attach(self, node_name: str, controller) -> None:
        self.node_name = node_name
        self.controller = controller

    def detach(self) -> None:
        pass

    def record(self, event: str) -> None:
        self.controller.record("{}[{}] {}".format(
            self.name, self.node_name, event))

    def on_send(self, msg, dst) -> Optional[List[Tuple]]:
        return None

    def on_incoming(self, msg, frm) -> Optional[List[Tuple]]:
        return None

    def on_tick(self) -> None:
        """Deterministic scheduler tick (release held messages etc.)."""


def _broadcast_targets(controller, node_name, dst) -> List[str]:
    """Materialize a send's destination set from the pool roster."""
    if dst is None:
        return [n for n in controller.pool_names() if n != node_name]
    if isinstance(dst, str):
        return [dst]
    return list(dst)


class EquivocatingPrimary(Behavior):
    """The primary proposes DIFFERENT batches to different replicas
    (reference: malicious send of conflicting PRE-PREPAREs). Half the
    recipients get the real PRE-PREPARE; the other half get a forged
    variant with the batch contents stripped and the digest recomputed
    (so it passes the digest check and fails only at the apply-and-
    compare defense — the strongest equivocation an adversary without
    the honest executor state can mount)."""

    name = "equivocate-pp"

    def __init__(self, real_count: Optional[int] = None):
        """real_count: how many recipients get the REAL PrePrepare
        (None = half). 0 = everyone gets the forged variant — the
        stall-inducing extreme; >=1 leaves a seed for MessageReq
        self-healing."""
        super().__init__()
        self._real_count = real_count

    def on_send(self, msg, dst):
        if not isinstance(msg, PrePrepare):
            return None
        targets = _broadcast_targets(self.controller, self.node_name, dst)
        if len(targets) < 2:
            return None
        shuffled = self.controller.random.shuffle(sorted(targets))
        half = max(1, len(shuffled) // 2) if self._real_count is None \
            else max(0, min(self._real_count, len(shuffled)))
        group_a, group_b = shuffled[:half], shuffled[half:]
        if not group_b:
            return None
        from plenum_tpu_torch.consensus.ordering_service import OrderingService
        params = dict(msg.as_dict())
        params["reqIdr"] = []
        ov = params.get("originalViewNo")
        params["digest"] = OrderingService.generate_pp_digest(
            [], ov if ov is not None else msg.viewNo, msg.ppTime)
        forged = PrePrepare(**params)
        self.record("pp seq={} real->{} forged->{}".format(
            msg.ppSeqNo, ",".join(sorted(group_a)) or "-",
            ",".join(sorted(group_b))))
        out = [(forged, group_b)]
        if group_a:
            out.insert(0, (msg, group_a))
        return out


class DuplicateThreePC(Behavior):
    """Every outgoing 3PC message is sent `copies` times (reference
    duplicate-3PC malicious behavior). Honest nodes must count each
    sender once per (view, seq)."""

    name = "duplicate-3pc"

    def __init__(self, copies: int = 3, message_types=(PrePrepare,
                                                       Prepare, Commit)):
        super().__init__()
        self._copies = copies
        self._types = tuple(message_types)

    def on_send(self, msg, dst):
        if not isinstance(msg, self._types):
            return None
        self.record("x{} {} seq={}".format(
            self._copies, type(msg).__name__,
            getattr(msg, "ppSeqNo", "?")))
        return [(msg, dst)] * self._copies


class ConflictingPrepare(Behavior):
    """A non-primary vote-splitter: victims receive a PREPARE whose
    digest disagrees with the PRE-PREPARE (reference conflicting-3PC
    behavior); everyone else gets the real vote. Honest nodes must
    discard the conflicting vote (PR_DIGEST_WRONG) and still reach
    quorum from honest votes."""

    name = "conflicting-prepare"

    def __init__(self, victims=None):
        super().__init__()
        self._victims = set(victims) if victims is not None else None

    def on_send(self, msg, dst):
        if not isinstance(msg, Prepare):
            return None
        targets = _broadcast_targets(self.controller, self.node_name, dst)
        victims = [t for t in targets
                   if self._victims is None or t in self._victims]
        rest = [t for t in targets if t not in victims]
        if not victims:
            return None
        params = dict(msg.as_dict())
        params["digest"] = "f" * len(msg.digest)
        conflicting = Prepare(**params)
        self.record("seq={} conflicting->{}".format(
            msg.ppSeqNo, ",".join(sorted(victims))))
        out = [(conflicting, victims)]
        if rest:
            out.append((msg, rest))
        return out


class TamperedPropagate(Behavior):
    """Request tampering (reference malicious_behaviors_node
    changesRequest): every relayed PROPAGATE carries a mutated
    operation. The tampered copy hashes to a different digest, so it
    can never join the f+1 identical-propagate quorum of the honest
    request — finalization must come from honest relays only."""

    name = "tamper-propagate"

    def _tamper(self, request: dict) -> dict:
        req = dict(request)
        op = dict(req.get("operation") or {})
        op["dest"] = "Tampered" + str(op.get("dest", ""))[:20]
        req["operation"] = op
        return req

    def on_send(self, msg, dst):
        if isinstance(msg, Propagate):
            self.record("tampered propagate req={}".format(
                (msg.request or {}).get("reqId")))
            return [(Propagate(request=self._tamper(msg.request),
                               senderClient=msg.senderClient), dst)]
        if isinstance(msg, PropagateBatch):
            self.record("tampered propagate batch n={}".format(
                len(msg.requests)))
            return [(PropagateBatch(
                requests=[self._tamper(r) for r in msg.requests],
                clients=list(msg.clients)), dst)]
        return None


class PoisonedBlsShare(Behavior):
    """COMMITs carry a BLS share that decodes fine but signs the WRONG
    value (a stale share from an earlier batch), or — every `garble_every`
    poisonings — an undecodable string. Drives the deferred-verification
    defense in consensus/bls_bft_replica.py: the aggregate check fails,
    the per-share unroll assigns blame, the adaptive strict window
    engages, and the multi-sig backfill recovers the proof from late
    honest shares."""

    name = "poison-bls"

    def __init__(self, garble_every: int = 0):
        super().__init__()
        self._stale_sig = None
        self._garble_every = garble_every
        self._count = 0

    def on_send(self, msg, dst):
        if not isinstance(msg, Commit) or \
                getattr(msg, "blsSig", None) is None:
            return None
        self._count += 1
        stale, self._stale_sig = self._stale_sig, msg.blsSig
        if self._garble_every and self._count % self._garble_every == 0:
            poisoned = "!!not-base58!!"
        elif stale is not None and stale != msg.blsSig:
            poisoned = stale          # valid share over the wrong value
        else:
            poisoned = msg.blsSig[::-1]
        params = dict(msg.as_dict())
        params["blsSig"] = poisoned
        self.record("seq={} poisoned".format(msg.ppSeqNo))
        return [(Commit(**params), dst)]


class SilentNode(Behavior):
    """A crashed (or byzantine-silent) node: every outgoing message is
    swallowed, and optionally every incoming one too. Installed on the
    primary this is the classic fail-stop failover scenario — honest
    nodes' disconnect/freshness watchdogs must vote a view change and
    ordering must resume under the new primary. Unlike
    SimNetwork.disconnect it keeps the transport 'connected' (no
    Disconnected events), which is the HARD variant: a hung process
    holds its sockets open, so only protocol-level timeouts can notice."""

    name = "silent-node"

    def __init__(self, drop_incoming: bool = True,
                 message_types=None):
        """message_types: restrict the silence (None = everything) —
        e.g. only 3PC messages, keeping heartbeats alive."""
        super().__init__()
        self._drop_incoming = drop_incoming
        self._types = tuple(message_types) if message_types else None
        self._dropped = 0

    def _silent_for(self, msg) -> bool:
        return self._types is None or isinstance(msg, self._types)

    def on_send(self, msg, dst):
        if not self._silent_for(msg):
            return None
        self._dropped += 1
        if self._dropped == 1:
            self.record("went silent")
        return []

    def on_incoming(self, msg, frm):
        if not self._drop_incoming or not self._silent_for(msg):
            return None
        return []


class EquivocatingNewView(Behavior):
    """A byzantine NEW primary abusing the one message only it may
    send. Modes:

    * ``equivocate`` — `real_count` recipients (None = half) get the
      honest NEW_VIEW; the rest get a forgery with a tampered
      checkpoint digest. Honest validators recompute the decision from
      the referenced VIEW_CHANGEs (``_finish_view_change``), detect the
      mismatch and vote the next view — the pool must converge past
      the equivocator.
    * ``stale`` — the first NEW_VIEW is swallowed and every later one
      is replaced by the previously captured (now stale) message, which
      receivers discard as an old view. Nobody ever completes the view
      change under this primary, so the NEW_VIEW timeout (and its
      escalation) is what recovers the pool.
    """

    name = "equivocate-nv"

    def __init__(self, mode: str = "equivocate",
                 real_count: Optional[int] = None):
        assert mode in ("equivocate", "stale")
        super().__init__()
        self._mode = mode
        self._real_count = real_count
        self._last: Optional[NewView] = None

    @staticmethod
    def _forge(msg: NewView) -> NewView:
        params = dict(msg.as_dict())
        chk = dict(params.get("checkpoint") or {})
        chk["digest"] = "forged-" + str(chk.get("digest", ""))[:32]
        params["checkpoint"] = chk
        return NewView(**params)

    def on_send(self, msg, dst):
        # a NEW_VIEW answer to a peer's re-request (MessageRep) is the
        # same message on a different path — a byzantine primary lies
        # there too, or the self-heal re-request would fetch the honest
        # NEW_VIEW straight out of the liar's own store
        if isinstance(msg, MessageRep) and msg.msg_type == "NEW_VIEW" \
                and msg.msg is not None:
            if self._mode == "stale":
                # swallowing is the stale liar's reply-path analogue:
                # `_last` already holds the CURRENT honest NEW_VIEW, so
                # replaying it here would heal the victims
                self.record("NEW_VIEW rep swallowed")
                return []
            forged = self._forge(NewView(**msg.msg))
            self.record("NEW_VIEW rep forged")
            return [(MessageRep(msg_type=msg.msg_type, params=msg.params,
                                msg=forged.as_dict()), dst)]
        if not isinstance(msg, NewView):
            return None
        if self._mode == "stale":
            prev, self._last = self._last, msg
            if prev is None:
                self.record("view={} NEW_VIEW swallowed".format(
                    msg.viewNo))
                return []
            self.record("view={} replaced by stale view={}".format(
                msg.viewNo, prev.viewNo))
            return [(prev, dst)]
        targets = _broadcast_targets(self.controller, self.node_name, dst)
        if not targets:
            return None
        shuffled = self.controller.random.shuffle(sorted(targets))
        half = max(0, len(shuffled) // 2) if self._real_count is None \
            else max(0, min(self._real_count, len(shuffled)))
        group_real, group_forged = shuffled[:half], shuffled[half:]
        if not group_forged:
            return None
        self.record("view={} real->{} forged->{}".format(
            msg.viewNo, ",".join(sorted(group_real)) or "-",
            ",".join(sorted(group_forged))))
        out = [(self._forge(msg), group_forged)]
        if group_real:
            out.insert(0, (msg, group_real))
        return out


class LyingCatchupSeeder(Behavior):
    """A byzantine catchup provider: consistency proofs advertise a
    forged root (they can never reach the leecher's quorum, only delay
    it), and catchup reps are garbled — the per-txn content is mutated
    while the audit paths still claim the honest range, so a leecher
    verifying against the quorum-agreed root rejects the chunk at rep
    time, marks this peer bad, and re-requests elsewhere. ``stall_every``
    > 0 swallows every Nth rep instead (the silent-stall variant that
    only the retry backoff + peer rotation can route around)."""

    name = "lying-seeder"

    def __init__(self, lie_cons_proofs: bool = True,
                 garble_reps: bool = True, stall_every: int = 0):
        super().__init__()
        self._lie_proofs = lie_cons_proofs
        self._garble = garble_reps
        self._stall_every = stall_every
        self._reps = 0

    def on_send(self, msg, dst):
        if isinstance(msg, ConsistencyProof) and self._lie_proofs:
            from plenum_tpu_torch.ledger.ledger import Ledger
            params = dict(msg.as_dict())
            params["newMerkleRoot"] = Ledger.hashToStr(
                b"\x11" * 32)
            self.record("lied cons-proof {}..{}".format(
                msg.seqNoStart, msg.seqNoEnd))
            return [(ConsistencyProof(**params), dst)]
        if isinstance(msg, CatchupRep):
            self._reps += 1
            if self._stall_every and \
                    self._reps % self._stall_every == 0:
                self.record("stalled rep n={}".format(len(msg.txns)))
                return []
            if self._garble:
                garbled = {seq: dict(txn, lie=self._reps)
                           for seq, txn in msg.txns.items()}
                self.record("garbled rep n={}".format(len(garbled)))
                return [(CatchupRep(
                    ledgerId=msg.ledgerId, txns=garbled,
                    consProof=list(msg.consProof),
                    auditPaths=getattr(msg, "auditPaths", None)), dst)]
        return None


class Partition(Behavior):
    """One side of a network partition: sends reach only the peers in
    ``reachable`` and incoming traffic from outside it is dropped.
    Install one instance per node with reachable = that node's own
    group (AdversaryController.partition wires a whole pool split);
    releasing the behaviors heals the partition — LinkFault-style held
    state does not exist here, so healing is instantaneous."""

    name = "partition"

    def __init__(self, reachable):
        super().__init__()
        self._reachable = set(reachable)

    def on_send(self, msg, dst):
        targets = _broadcast_targets(self.controller, self.node_name, dst)
        kept = [t for t in targets if t in self._reachable]
        if len(kept) == len(targets):
            return None
        return [(msg, kept)] if kept else []

    def on_incoming(self, msg, frm):
        if frm in self._reachable:
            return None
        return []


class LinkFault(Behavior):
    """Per-link chaos: probabilistic drop / corrupt / delay (delay with
    jitter ⇒ reorder) on matching sends. All draws come from the
    controller's seeded SimRandom; held messages are released by the
    controller's deterministic tick, so the whole fault pattern replays
    bit-identically for a fixed seed."""

    name = "link-fault"

    def __init__(self, drop_p: float = 0.0, corrupt_p: float = 0.0,
                 delay_p: float = 0.0, delay: float = 1.0,
                 jitter: float = 0.5, dst=None, message_types=None):
        super().__init__()
        self._drop_p = drop_p
        self._corrupt_p = corrupt_p
        self._delay_p = delay_p
        self._delay = delay
        self._jitter = jitter
        self._dst = set(dst) if dst is not None else None
        self._types = tuple(message_types) if message_types else None
        self._held: List[Tuple[float, object, object]] = []

    def _matches(self, msg, dst) -> bool:
        if self._types is not None and not isinstance(msg, self._types):
            return False
        if self._dst is not None:
            targets = _broadcast_targets(self.controller, self.node_name,
                                         dst)
            return bool(set(targets) & self._dst)
        return True

    def _corrupt(self, msg):
        if hasattr(msg, "digest") and isinstance(msg.digest, str):
            params = dict(msg.as_dict())
            params["digest"] = "0" * len(msg.digest)
            return type(msg)(**params)
        return msg

    def on_send(self, msg, dst):
        if not self._matches(msg, dst):
            return None
        rng = self.controller.random
        roll = rng.float(0.0, 1.0)
        if roll < self._drop_p:
            self.record("drop {}".format(type(msg).__name__))
            return []
        if roll < self._drop_p + self._corrupt_p:
            self.record("corrupt {}".format(type(msg).__name__))
            return [(self._corrupt(msg), dst)]
        if roll < self._drop_p + self._corrupt_p + self._delay_p:
            extra = self._delay + rng.float(0.0, self._jitter)
            release = self.controller.now() + extra
            self._held.append((release, msg, dst))
            self.record("hold {} for {:.2f}s".format(
                type(msg).__name__, extra))
            return []
        return None

    def on_tick(self):
        now = self.controller.now()
        due = [h for h in self._held if h[0] <= now]
        if not due:
            return
        self._held = [h for h in self._held if h[0] > now]
        for _, msg, dst in due:
            self.controller.raw_send(self.node_name, msg, dst)

    def detach(self):
        # flush anything still held so messages are not lost forever
        for _, msg, dst in self._held:
            self.controller.raw_send(self.node_name, msg, dst)
        self._held = []
