"""Catchup — ledger synchronization (leecher + seeder).

Reference: plenum/server/catchup/ — SeederService (seeder_service.py:14,
answers LedgerStatus/CatchupReq with txns + consistency proofs),
ConsProofService (cons_proof_service.py:24, agrees on a target size+root
from peer evidence), CatchupRepService (catchup_rep_service.py:18,
fetches txn ranges split across peers and verifies them against the
agreed root), NodeLeecherService (node_leecher_service.py:21, the state
machine ordering ledgers: audit → pool → config → domain,
docs/source/catchup.md:14).

Verification model: the target (size, root) is fixed by a quorum of
ConsistencyProofs; fetched txns are replayed into a shadow merkle tree
and accepted only if the resulting root matches the agreed target root —
the root binds every byte, so a lying seeder can delay but never corrupt
(a failed range is re-requested from other peers).
"""
from __future__ import annotations

import logging
import zlib
from collections import defaultdict
from enum import Enum, auto
from typing import Callable, Dict, List, Optional, Set, Tuple

from plenum_tpu_torch.common.config import Config
from plenum_tpu_torch.common.constants import (
    AUDIT_LEDGER_ID, CONFIG_LEDGER_ID, DOMAIN_LEDGER_ID, POOL_LEDGER_ID)
from plenum_tpu_torch.common.messages.internal_messages import CatchupFinished
from plenum_tpu_torch.common.messages.node_messages import (
    CatchupRep, CatchupReq, ConsistencyProof, LedgerStatus)
from plenum_tpu_torch.common.serializers.serializers import MsgPackSerializer
from plenum_tpu_torch.consensus.quorums import Quorums
from plenum_tpu_torch.ledger.ledger import Ledger
from plenum_tpu_torch.ledger.merkle_verifier import (
    MerkleVerifier, ProofError)
from plenum_tpu_torch.ledger.tree_hasher import TreeHasher
from plenum_tpu_torch.observability.tracing import CAT_RECOVERY, NullTracer
from plenum_tpu_torch.runtime.timer import TimerService

logger = logging.getLogger(__name__)

CATCHUP_LEDGER_ORDER = [AUDIT_LEDGER_ID, POOL_LEDGER_ID, CONFIG_LEDGER_ID,
                        DOMAIN_LEDGER_ID]


# the node stack's codec (network/stack.py): a catchup rep's frame size
_WIRE = MsgPackSerializer()


class SeederService:
    """Answers peers' catchup questions from our committed ledgers."""

    def __init__(self, db_manager, network, name: str = "?",
                 view_source: Callable[[], Tuple[int, int]] = None,
                 config: Optional[Config] = None):
        """view_source() → (view_no, last_ordered_pp_seq_no): stamped on
        responses so a rejoining node can adopt the POOL's current view —
        the audit ledger alone records only original (pre-view-change)
        views (reference: LedgerStatus carries viewNo/ppSeqNo)."""
        self._db = db_manager
        self._network = network
        self.name = name
        self._view_source = view_source or (lambda: (0, 0))
        self._config = config or Config()
        network.subscribe(LedgerStatus, self.process_ledger_status)
        network.subscribe(CatchupReq, self.process_catchup_req)

    def _own_status(self, lid: int) -> LedgerStatus:
        # a non-None viewNo marks this as a RESPONSE: seeders only answer
        # solicitations (viewNo None), so two up-to-date peers can never
        # ping-pong statuses at each other forever
        ledger = self._db.get_ledger(lid)
        view_no, pp_seq_no = self._view_source()
        return LedgerStatus(ledgerId=lid, txnSeqNo=ledger.size,
                            viewNo=view_no, ppSeqNo=pp_seq_no,
                            merkleRoot=ledger.root_hash,
                            protocolVersion=2)

    def process_ledger_status(self, status: LedgerStatus, frm: str):
        if status.viewNo is not None:
            return  # a response to someone's solicitation, not for us
        ledger = self._db.get_ledger(status.ledgerId)
        if ledger is None:
            return
        if status.txnSeqNo < ledger.size:
            # requester is behind: prove our extension over their prefix
            proof = self._build_consistency_proof(
                status.ledgerId, status.txnSeqNo, ledger.size)
            if proof is not None:
                self._network.send(proof, [frm])
        else:
            # same or ahead: echo our status so they can count the quorum
            self._network.send(self._own_status(status.ledgerId), [frm])

    def _build_consistency_proof(self, lid: int, start: int, end: int
                                 ) -> Optional[ConsistencyProof]:
        ledger = self._db.get_ledger(lid)
        try:
            if start == 0:
                # a proof from the empty prefix is trivially empty
                # (RFC 6962: PROOF(0, D[n]) = {}); the new root alone
                # carries the commitment
                hashes = []
                old_root = Ledger.hashToStr(ledger.hasher.hash_empty())
            else:
                hashes = [Ledger.hashToStr(h) for h in
                          ledger.tree.consistency_proof(start, end)]
                old_root = Ledger.hashToStr(
                    ledger.tree.merkle_tree_hash(0, start))
        except Exception:
            logger.warning("%s cannot build consistency proof %s..%s",
                           self.name, start, end)
            return None
        view_no, pp_seq_no = self._view_source()
        return ConsistencyProof(
            ledgerId=lid, seqNoStart=start, seqNoEnd=end,
            viewNo=view_no, ppSeqNo=pp_seq_no,
            oldMerkleRoot=old_root, newMerkleRoot=ledger.root_hash,
            hashes=hashes)

    def _catchup_audit_paths(self, ledger: Ledger, start: int, end: int,
                             till: int) -> Optional[Dict[str, List[str]]]:
        """Per-txn inclusion proofs for the served range against the
        size-`till` prefix tree the leecher agreed on. ONE batched pass:
        the proofs share a subtree memo on the host path and ride the
        pipelined device engine above the routing threshold (the
        catchup rep server is a production proof-batch consumer). A
        digest→b58 memo collapses the heavily shared upper siblings."""
        if not (start <= end <= till <= ledger.size and till > 0):
            return None  # we cannot prove against a tree we don't have
        try:
            paths = ledger.tree.inclusion_proofs_batch(
                list(range(start - 1, end)), till)
        except (IndexError, KeyError, ValueError):
            # the host tree cannot prove the range (the JAX package
            # catches every exception here; a failing device call is not
            # caught, so it cannot pass as reps without audit paths)
            logger.warning("%s cannot build catchup audit paths "
                           "%s..%s@%s", self.name, start, end, till,
                           exc_info=True)
            return None
        to_str = Ledger.hashToStr
        memo: Dict[bytes, str] = {}

        def enc(h):
            s = memo.get(h)
            if s is None:
                s = memo[h] = to_str(h)
            return s

        return {str(seq): [enc(h) for h in path]
                for seq, path in zip(range(start, end + 1), paths)}

    def process_catchup_req(self, req: CatchupReq, frm: str):
        ledger = self._db.get_ledger(req.ledgerId)
        if ledger is None:
            return
        end = min(req.seqNoEnd, ledger.size)
        if end < req.seqNoStart:
            return
        start = req.seqNoStart
        till = req.catchupTill or end
        # chunked reps: a large range leaves as several bounded
        # messages, each independently verifiable from its audit paths.
        # Proofs are materialized per GROUP (a few chunks — large
        # enough to engage the device routing, small enough to bound
        # memory to the group, not the whole requested range).
        conf = self._config
        chunk = max(1, getattr(conf, "CATCHUP_REP_CHUNK",
                               Config.CATCHUP_REP_CHUNK))
        group = max(chunk, conf.MERKLE_DEVICE_PROOF_MIN)
        want_paths = getattr(conf, "CATCHUP_REP_AUDIT_PATHS",
                             Config.CATCHUP_REP_AUDIT_PATHS)
        for glo in range(start, end + 1, group):
            ghi = min(glo + group - 1, end)
            proofs = self._catchup_audit_paths(ledger, glo, ghi, till) \
                if want_paths else None
            for lo in range(glo, ghi + 1, chunk):
                hi = min(lo + chunk - 1, ghi)
                txns = {}
                for seq in range(lo, hi + 1):
                    txn = ledger.getBySeqNo(seq)
                    if txn is None:
                        return
                    txns[str(seq)] = txn
                audit = {k: proofs[k] for k in txns} if proofs else None
                self._send_reps(req.ledgerId, txns, audit, frm)

    def _send_reps(self, ledger_id: int, txns: dict, audit, frm: str):
        """One CatchupRep for `txns`, or, where its wire frame would pass
        MSG_LEN_LIMIT (the sending stack drops such a frame, so the peer
        would wait for the chunk forever), two halves, each split again as
        it needs. The JAX package sends the chunk whole: 1,000 NYM txns
        with their audit paths are ~1 MB (ROADMAP C 8)."""
        rep = CatchupRep(ledgerId=ledger_id, txns=txns, consProof=[],
                         auditPaths=audit)
        limit = getattr(self._config, "MSG_LEN_LIMIT", Config.MSG_LEN_LIMIT)
        if len(txns) > 1 and \
                len(_WIRE.serialize(rep.to_dict())) > limit:
            keys = list(txns)
            for part in (keys[:len(keys) // 2], keys[len(keys) // 2:]):
                self._send_reps(ledger_id, {k: txns[k] for k in part},
                                {k: audit[k] for k in part}
                                if audit else None, frm)
            return
        self._network.send(rep, [frm])


class LeecherState(Enum):
    IDLE = auto()
    SYNCING = auto()
    DONE = auto()


class LedgerLeecher:
    """Catchup of ONE ledger: cons-proof phase then rep phase."""

    def __init__(self, lid: int, db_manager, network, timer: TimerService,
                 quorums_source: Callable[[], Quorums],
                 on_txn: Callable[[int, dict], None],
                 on_done: Callable[[int], None],
                 config: Optional[Config] = None,
                 view_tracker: Optional[Dict[str, int]] = None,
                 bad_peers: Optional[Set[str]] = None,
                 record: Callable[..., None] = None,
                 name: str = "?"):
        # peer → highest view_no that peer has reported (shared across
        # ledgers by NodeLeecherService; feeds pool_view_estimate)
        self._view_tracker = view_tracker if view_tracker is not None \
            else {}
        # peers whose reps failed audit-path verification (shared across
        # ledgers: a seeder lying about one ledger is not trusted with
        # the others either); chunk assignment skips them
        self._bad_peers = bad_peers if bad_peers is not None else set()
        # recovery-trace hook: record(event_name, **args) → flight
        # recorder instant (NodeLeecherService wires the node tracer)
        self._record = record or (lambda event, **args: None)
        # per-NODE jitter salt: without it every node computes the
        # identical jittered delay for the same (lid, retry) and the
        # pool re-requests in lockstep anyway — crc32, not hash(),
        # because str hashing is randomized per process and would break
        # seeded-sim replay
        self._jitter_salt = zlib.crc32(name.encode())
        self.lid = lid
        self._db = db_manager
        self._network = network
        self._timer = timer
        self._quorums = quorums_source
        self._on_txn = on_txn
        self._on_done = on_done
        self._config = config or Config()
        self.state = LeecherState.IDLE
        self._statuses_same: Set[str] = set()
        self._cons_proofs: Dict[Tuple, Set[str]] = defaultdict(set)
        self.target_size: Optional[int] = None
        self.target_root: Optional[str] = None
        self._buffer: Dict[int, dict] = {}
        # retry machinery: one-shot self-rescheduling with capped
        # exponential backoff (NOT a fixed-period RepeatingTimer — see
        # plenum-lint PT007); the generation guard makes stale scheduled
        # callbacks no-ops after stop()/restart, and the kept closure
        # reference lets stop() actually cancel the heap entry (a
        # backoff-max delay would otherwise sit there ~75s post-catchup)
        self.retry_count = 0
        self._retry_gen = 0
        self._retry_cb = None
        self.next_retry_delay: Optional[float] = None

    @property
    def ledger(self) -> Ledger:
        return self._db.get_ledger(self.lid)

    # ------------------------------------------------------------- start

    def start(self):
        self.state = LeecherState.SYNCING
        self._statuses_same = set()
        self._cons_proofs.clear()
        self._buffer.clear()
        self.target_size = None
        self.target_root = None
        self.retry_count = 0
        self._broadcast_status()
        self._schedule_retry()

    def _broadcast_status(self):
        ledger = self.ledger
        self._network.send(LedgerStatus(
            ledgerId=self.lid, txnSeqNo=ledger.size, viewNo=None,
            ppSeqNo=None, merkleRoot=ledger.root_hash, protocolVersion=2))

    def stop(self):
        self._retry_gen += 1  # belt: any uncancelled retry is a no-op
        if self._retry_cb is not None:
            self._timer.cancel(self._retry_cb)
            self._retry_cb = None
        self.state = LeecherState.DONE

    def _finish(self):
        self.stop()
        self._on_done(self.lid)

    # ------------------------------------------------- retry + backoff

    def _retry_delay(self) -> float:
        """Capped exponential backoff with deterministic jitter:
        retry i waits min(base * 2^i, cap) plus up to JITTER_FRAC of
        that. Jitter derives from (node-name salt, lid, retry) — int
        tuples hash stably in CPython, and the crc32 salt makes it
        differ ACROSS nodes — so the whole fault pattern replays
        bit-identically under a seeded sim while the pool's re-request
        bursts desynchronize (N laggards starting catchup together must
        not hammer the seeders in lockstep). Progress resets
        retry_count (and with it the delay) to the base."""
        conf = self._config
        base = float(conf.CATCHUP_TXN_TIMEOUT)
        cap = float(getattr(conf, "CATCHUP_RETRY_BACKOFF_MAX",
                            Config.CATCHUP_RETRY_BACKOFF_MAX))
        frac = float(getattr(conf, "CATCHUP_RETRY_JITTER_FRAC",
                             Config.CATCHUP_RETRY_JITTER_FRAC))
        delay = min(cap, base * (2 ** min(self.retry_count, 16)))
        unit = (hash((self._jitter_salt, self.lid,
                      self.retry_count)) & 0xFFFF) / 65536.0
        return delay * (1.0 + frac * unit)

    def _schedule_retry(self):
        self._retry_gen += 1
        gen = self._retry_gen
        if self._retry_cb is not None:
            self._timer.cancel(self._retry_cb)
        delay = self._retry_delay()
        self.next_retry_delay = delay

        def fire():
            if gen != self._retry_gen \
                    or self.state != LeecherState.SYNCING:
                return
            self._retry()

        self._retry_cb = fire
        self._timer.schedule(delay, fire)

    def _retry(self):
        if self.state != LeecherState.SYNCING:
            return
        # count BEFORE re-requesting so the very first retry already
        # rotates the chunk assignment off whichever peer just starved
        # it (and the next wait doubles)
        self.retry_count += 1
        self._record("catchup_retry", lid=self.lid,
                     retry=self.retry_count,
                     delay=round(self.next_retry_delay or 0.0, 3),
                     bad_peers=len(self._bad_peers))
        if self.target_size is None:
            self._broadcast_status()
        else:
            self._request_missing()
        self._schedule_retry()

    def _note_progress(self):
        """A peer answered usefully (target adopted / txns buffered):
        the backoff restarts from the base period. The pending retry is
        re-armed too — resetting only the counter would leave an
        escalated (up-to-cap) delay already sitting in the timer heap,
        so a chunk still missing (stalling seeder) would wait out the
        stale long window even though the pool just proved responsive."""
        if self.retry_count:
            self.retry_count = 0
            self._schedule_retry()

    # ----------------------------------------------------- status phase

    def process_ledger_status(self, status: LedgerStatus, frm: str):
        if self.state != LeecherState.SYNCING or status.ledgerId != self.lid:
            return
        if status.viewNo is not None:
            self._view_tracker[frm] = max(
                self._view_tracker.get(frm, 0), status.viewNo)
        ledger = self.ledger
        # "same" means same size AND same root — an equal-size peer with a
        # different root is divergence, not agreement
        if status.txnSeqNo == ledger.size \
                and status.merkleRoot == ledger.root_hash:
            self._statuses_same.add(frm)
            if self._quorums().ledger_status.is_reached(
                    len(self._statuses_same)) and self.target_size is None:
                self._finish()

    def process_consistency_proof(self, proof: ConsistencyProof, frm: str):
        if self.state != LeecherState.SYNCING or proof.ledgerId != self.lid:
            return
        if proof.viewNo is not None:
            self._view_tracker[frm] = max(
                self._view_tracker.get(frm, 0), proof.viewNo)
        if proof.seqNoStart != self.ledger.size:
            return
        key = (proof.seqNoStart, proof.seqNoEnd, proof.newMerkleRoot)
        self._cons_proofs[key].add(frm)
        quorum = self._quorums().consistency_proof
        agreed = [k for k, votes in self._cons_proofs.items()
                  if quorum.is_reached(len(votes))]
        if not agreed:
            return
        # go for the largest agreed extension
        start, end, root = max(agreed, key=lambda k: k[1])
        if self.target_size is None or end > self.target_size:
            self.target_size = end
            self.target_root = root
            self._note_progress()
            self._request_missing()

    # -------------------------------------------------------- rep phase

    def _request_missing(self):
        if self.target_size is None:
            return
        start = self.ledger.size + 1
        missing = [s for s in range(start, self.target_size + 1)
                   if s not in self._buffer]
        if not missing:
            self._try_apply()
            return
        connecteds = sorted(self._network.connecteds)
        # skip peers whose reps failed proof verification; if that
        # leaves nobody, fall back to everyone (a wrongly-blamed pool
        # beats a stalled catchup — the root check still protects us)
        peers = [p for p in connecteds if p not in self._bad_peers] \
            or connecteds or [None]
        # rotate assignment by retry round: a dead or silently lying
        # peer must not keep receiving the same chunk forever (the
        # pre-rotation deterministic split starved exactly like that)
        rot = self.retry_count % len(peers)
        peers = peers[rot:] + peers[:rot]
        # split contiguous chunks across peers
        chunk = max(1, (len(missing) + len(peers) - 1) // len(peers))
        for i, peer in enumerate(peers):
            lo = i * chunk
            if lo >= len(missing):
                break
            hi = min(lo + chunk, len(missing)) - 1
            req = CatchupReq(ledgerId=self.lid,
                             seqNoStart=missing[lo],
                             seqNoEnd=missing[hi],
                             catchupTill=self.target_size)
            self._network.send(req, [peer] if peer else None)

    def _verify_rep_proofs(self, rep: CatchupRep, frm: str) -> bool:
        """Per-rep fast rejection: when the seeder attached audit paths,
        verify every txn's inclusion against the quorum-agreed
        (target_size, target_root) BEFORE buffering — a lying chunk is
        dropped (and re-requested elsewhere) at rep time instead of
        poisoning the buffer until the whole-range root replay. Leaf
        hashing batches through the TreeHasher TPU seam. Legacy reps
        without paths still ride the final root check."""
        paths = getattr(rep, "auditPaths", None)
        if not paths or self.target_root is None:
            return True
        ledger = self.ledger
        try:
            items = self._rep_proof_items(rep.txns, paths)
            root = Ledger.strToHash(self.target_root) if items else None
        except Exception:
            # a host parse of the seeder's own fields (no kernel runs
            # here): whatever a malformed rep raises, from the codecs or
            # the serializer, rejects the chunk
            logger.warning("ledger %s: catchup rep from %s carries "
                           "malformed txns or audit paths — discarding "
                           "the chunk", self.lid, frm, exc_info=True)
            return False
        if not items:
            return True
        try:
            MerkleVerifier(ledger.hasher).verify_leaf_inclusion_batch(
                items, self.target_size, root)
        except ProofError:
            # the only verdict on well-formed items; a kernel failure of
            # the leaf hashing on the card (RuntimeError) is no verdict
            # on the seeder and surfaces
            logger.warning("ledger %s: catchup rep from %s failed audit-"
                           "path verification — discarding the chunk",
                           self.lid, frm, exc_info=True)
            return False
        return True

    def _rep_proof_items(self, txns, paths) -> list:
        """(leaf bytes, index, [sibling hashes]) for each txn of a rep
        that lies in (ledger size, target size] and carries a path."""
        ledger = self.ledger
        items = []
        for seq_str, txn in txns.items():
            seq = int(seq_str)
            if not ledger.size < seq <= self.target_size:
                continue
            path_strs = paths.get(seq_str)
            if path_strs is None:
                continue  # unproven txn rides the final root check
            items.append((ledger.serialize_for_tree(txn), seq - 1,
                          [Ledger.strToHash(s) for s in path_strs]))
        return items

    def process_catchup_rep(self, rep: CatchupRep, frm: str):
        if self.state != LeecherState.SYNCING or rep.ledgerId != self.lid:
            return
        if self.target_size is None:
            return
        if not self._verify_rep_proofs(rep, frm):
            # a proven-lying seeder is excluded from chunk assignment
            # (for every ledger) and its chunk re-requested elsewhere
            # right away instead of waiting out the retry period — but
            # only on the FIRST conviction: an already-convicted peer
            # spamming garbled reps must not amplify into a broadcast
            # re-request per rep (the retry backoff owns re-requests
            # from here on). Verified reps from convicted peers are
            # still accepted below: the all-convicted fallback depends
            # on a wrongly-blamed peer being able to redeem itself.
            if frm not in self._bad_peers:
                self._bad_peers.add(frm)
                self._record("catchup_bad_peer", lid=self.lid, peer=frm)
                self._request_missing()
            return
        added = False
        for seq_str, txn in rep.txns.items():
            seq = int(seq_str)
            if self.ledger.size < seq <= self.target_size:
                self._buffer[seq] = txn
                added = True
        if added:
            self._note_progress()
        self._try_apply()

    def _try_apply(self):
        """All txns present → replay into a shadow tree, accept only if
        the root matches the quorum-agreed target root."""
        ledger = self.ledger
        start = ledger.size + 1
        if self.target_size is None or self.target_size < start:
            self._finish()
            return
        if any(s not in self._buffer
               for s in range(start, self.target_size + 1)):
            return
        shadow = ledger.tree.copy_shadow()
        txns = [self._buffer[s] for s in range(start, self.target_size + 1)]
        # one batched device dispatch hashes the whole caught-up range
        # (TreeHasher TPU seam) before the sequential frontier merge
        leaf_hashes = ledger.hasher.hash_leaves(
            [ledger.serialize_for_tree(txn) for txn in txns])
        for leaf_hash in leaf_hashes:
            shadow._append_hash(leaf_hash)
        got_root = Ledger.hashToStr(shadow.root_hash)
        if got_root != self.target_root:
            logger.warning("catchup root mismatch on ledger %s: got %s "
                           "expected %s — discarding buffer and retrying",
                           self.lid, got_root, self.target_root)
            self._buffer.clear()
            self._request_missing()
            return
        for seq, txn in zip(range(start, self.target_size + 1), txns):
            self._on_txn(self.lid, txn)
        self._buffer.clear()
        self._finish()


class NodeLeecherService:
    """State machine over all ledgers: audit → pool → config → domain
    (reference node_leecher_service.py:21-27; audit first — it drives
    consistency of the rest, catchup.md:14-23)."""

    def __init__(self, db_manager, network, timer: TimerService,
                 quorums_source: Callable[[], Quorums],
                 on_catchup_txn: Callable[[int, dict], None],
                 on_finished: Callable[[], None],
                 config: Optional[Config] = None,
                 name: str = "?",
                 peer_ok: Callable[[str], bool] = None):
        """peer_ok(frm) → False rejects a catchup message before it can
        touch any leecher state: the Node wires current pool membership
        + its blacklist, so an unknown or blacklisted sender can neither
        vote on targets nor feed reps (it could previously pad the
        status/cons-proof quorums with fabricated senders)."""
        self._db = db_manager
        self._network = network
        self._timer = timer
        self._on_finished = on_finished
        self.name = name
        self.in_progress = False
        self._quorums = quorums_source
        self._peer_ok = peer_ok or (lambda frm: True)
        self.tracer = NullTracer(name)  # node injects the real one
        # peer → highest view reported in any status/proof this catchup
        self._view_tracker: Dict[str, int] = {}
        # peers whose reps failed proof verification (shared: lying
        # about one ledger disqualifies a seeder for all of them)
        self.bad_peers: Set[str] = set()
        self._leechers: Dict[int, LedgerLeecher] = {}
        for lid in CATCHUP_LEDGER_ORDER:
            if self._db.get_ledger(lid) is None:
                continue
            self._leechers[lid] = LedgerLeecher(
                lid, db_manager, network, timer, quorums_source,
                on_txn=on_catchup_txn, on_done=self._on_ledger_done,
                config=config, view_tracker=self._view_tracker,
                bad_peers=self.bad_peers, record=self._record,
                name=name)
        self._order = [lid for lid in CATCHUP_LEDGER_ORDER
                       if lid in self._leechers]
        self._current = 0
        network.subscribe(LedgerStatus, self._route_status)
        network.subscribe(ConsistencyProof, self._route_proof)
        network.subscribe(CatchupRep, self._route_rep)

    def _record(self, event: str, **args):
        """Recovery-lane flight-recorder instant (leecher retry/backoff
        + bad-peer events land on the node's merged timeline)."""
        self.tracer.instant(event, CAT_RECOVERY, **args)

    # ------------------------------------------------------------ routing

    def _active(self) -> Optional[LedgerLeecher]:
        if not self.in_progress or self._current >= len(self._order):
            return None
        return self._leechers[self._order[self._current]]

    def _route_status(self, msg: LedgerStatus, frm: str):
        if not self._peer_ok(frm):
            return
        leecher = self._leechers.get(msg.ledgerId)
        if leecher is not None:
            leecher.process_ledger_status(msg, frm)

    def _route_proof(self, msg: ConsistencyProof, frm: str):
        if not self._peer_ok(frm):
            return
        leecher = self._leechers.get(msg.ledgerId)
        if leecher is not None:
            leecher.process_consistency_proof(msg, frm)

    def _route_rep(self, msg: CatchupRep, frm: str):
        if not self._peer_ok(frm):
            return
        leecher = self._leechers.get(msg.ledgerId)
        if leecher is not None:
            leecher.process_catchup_rep(msg, frm)

    # ------------------------------------------------------------- drive

    def start(self):
        if self.in_progress:
            return
        self.in_progress = True
        self._current = 0
        self._view_tracker.clear()
        # a fresh catchup forgives past liars: membership may have
        # changed, and the per-rep verification re-convicts instantly
        self.bad_peers.clear()
        self._start_current()

    def pool_view_estimate(self) -> Optional[int]:
        """The pool's current view as evidenced by peers during this
        catchup: the (f+1)-th largest reported view — at least one honest
        peer has reached it. None until f+1 peers have reported. Needed
        because audit txns record each batch's ORIGINAL view, so a node
        rejoining after a view change that only re-ordered old-view
        batches cannot learn the new view from the audit ledger alone."""
        views = sorted(self._view_tracker.values(), reverse=True)
        f = self._quorums().f
        if len(views) < f + 1:
            return None
        return views[f]

    def _start_current(self):
        active = self._active()
        if active is None:
            self._finish()
            return
        active.start()

    def _on_ledger_done(self, lid: int):
        if not self.in_progress:
            return
        self._current += 1
        if self._current >= len(self._order):
            self._finish()
        else:
            self._start_current()

    def _finish(self):
        self.in_progress = False
        for leecher in self._leechers.values():
            leecher.stop()
        self._on_finished()
