"""BlsBftReplica — BLS multi-signatures woven into 3PC.

Reference: crypto/bls/bls_bft_replica.py:7 (ABC: validate/process/update
per 3PC message, process_order :83) + plenum/bls/bls_bft_replica_plenum.py
(concrete, 400 LoC) + plenum/bls/bls_store.py (BlsStore).

Flow: the primary's PRE-PREPARE fixes the pool state root; every replica's
COMMIT carries its BLS signature share over (ledger_id, state_root,
txn_root, pool_root, timestamp); COMMIT validation checks the share; on
ordering, n-f shares aggregate into a MultiSignature persisted in the
BlsStore keyed by state root — the material for client state proofs.
"""
from __future__ import annotations

import logging
from typing import Dict, Optional

from plenum_tpu_torch.observability.tracing import CAT_BLS, NullTracer
from plenum_tpu_torch.utils.metrics import MetricsName, NullMetricsCollector
from plenum_tpu_torch.crypto.bls import (
    BlsCryptoSigner, BlsCryptoVerifier, MultiSignature, MultiSignatureValue)

logger = logging.getLogger(__name__)


class BlsStore:
    """state_root (b58 str) → MultiSignature (reference plenum/bls/bls_store.py:8)."""

    def __init__(self, kv=None):
        from plenum_tpu_torch.storage.kv_memory import KeyValueStorageInMemory
        # "is None", not "or": an empty store (len 0) is still the store
        self._kv = kv if kv is not None else KeyValueStorageInMemory()

    def put(self, multi_sig: MultiSignature):
        import json
        self._kv.put(multi_sig.value.state_root_hash.encode(),
                     json.dumps(multi_sig.as_dict()).encode())

    def get(self, state_root: str) -> Optional[MultiSignature]:
        import json
        try:
            raw = self._kv.get(state_root.encode())
        except KeyError:
            return None
        return MultiSignature.from_dict(json.loads(bytes(raw).decode()))

    def items(self):
        """→ [(state_root_b58, MultiSignature)] — audit/invariant
        tooling walks every stored proof (backed by the KV iterator)."""
        import json
        out = []
        for k, v in self._kv.iterator(include_value=True):
            out.append((bytes(k).decode(),
                        MultiSignature.from_dict(
                            json.loads(bytes(v).decode()))))
        return out


class BlsKeyRegister:
    """node name → BLS public key (reference
    plenum/bls/bls_key_register_pool_ledger.py — keys come from the pool
    ledger; here a provider callable so the pool manager can back it)."""

    def __init__(self, provider=None):
        self._provider = provider or (lambda node: None)

    def get_key_by_name(self, node_name: str) -> Optional[str]:
        return self._provider(node_name)


class BlsBftReplica:
    def __init__(self, node_name: str,
                 bls_signer: Optional[BlsCryptoSigner],
                 bls_verifier: BlsCryptoVerifier,
                 key_register: BlsKeyRegister,
                 bls_store: Optional[BlsStore] = None,
                 get_pool_root=None,
                 defer_share_verify: bool = True):
        self._name = node_name
        # optimistic batch verification (config BLS_DEFER_SHARE_VERIFY):
        # per-share pairings move off the COMMIT hot path; ordering
        # checks the aggregate once and only unrolls per share on
        # failure (classic optimistic batch-verify; the per-share
        # fallback preserves blame assignment)
        self._defer_share_verify = defer_share_verify
        self._defer_configured = defer_share_verify
        # adaptive defense: if an invalid deferred share ever costs a
        # batch its multi-sig (it ate a quorum slot that arrival-time
        # verification would have rejected), switch to strict
        # arrival-time checks for a while so a byzantine peer cannot
        # SUSTAIN proof suppression, then retry the fast path
        self._strict_until_seq = -1
        self.metrics = NullMetricsCollector()  # node injects the real one
        self.tracer = NullTracer()             # node injects the real one
        self._signer = bls_signer
        self._verifier = bls_verifier
        self._keys = key_register
        self.bls_store = bls_store or BlsStore()
        self._get_pool_root = get_pool_root or (lambda: "")
        # (view_no, pp_seq_no) -> pp fields needed to bind commit sigs
        self._pp_values: Dict[tuple, MultiSignatureValue] = {}
        # shares already pairing-checked in validate_commit, so
        # process_order doesn't pay a second ~5 ms pairing per share:
        # (view_no, pp_seq_no, sender) -> sig string
        self._verified_shares: Dict[tuple, str] = {}
        # batches ordered WITHOUT a bls_signatures quorum of valid
        # shares (e.g. a byzantine share ate a quorum slot): kept so
        # late valid COMMITs can backfill the multi-sig — a poisoned
        # share may delay a state proof but never suppress it for good.
        # (view_no, pp_seq_no) -> True; values live in _pp_values.
        self._pending_backfill: Dict[tuple, bool] = {}
        # candidate shares for pending backfills, accumulated ACROSS
        # retry calls: a view change clears the ordering service's
        # commit store for the superseded view, so each late COMMIT may
        # arrive alone — the aggregation quorum is over everything seen.
        # key -> {sender: Commit} (first share per sender wins, matching
        # first-verified semantics on the arrival path).
        self._backfill_commits: Dict[tuple, Dict[str, "Commit"]] = {}

    def warm_pool_keys(self, validators) -> None:
        """Front-load the verifier's key-dependent work (G2 subgroup
        checks, aggregate key, prepared Miller lines) at catchup /
        membership-change time so the first state-proof verify after a
        pool change doesn't stall the ordering loop (the cold cost is
        ~350 ms at n=100 when paid lazily)."""
        warm = getattr(self._verifier, "warm_keys", None)
        if warm is None:
            return
        pks = [k for k in (self._keys.get_key_by_name(n)
                           for n in validators) if k]
        if not pks:
            return
        try:
            warm(pks)
        except Exception:
            logger.warning("%s: BLS key warm-up failed", self._name,
                           exc_info=True)

    # ------------------------------------------------------- PRE-PREPARE

    def update_pre_prepare(self, params: dict, ledger_id: int) -> dict:
        params["poolStateRootHash"] = self._get_pool_root() or None
        return params

    def validate_pre_prepare(self, pp, sender: str) -> Optional[str]:
        return None  # multi-sig inside PP validated lazily on use

    def process_pre_prepare(self, pp, sender: str):
        self._remember_value(pp)

    def _remember_value(self, pp):
        self._pp_values[(pp.viewNo, pp.ppSeqNo)] = MultiSignatureValue(
            ledger_id=pp.ledgerId,
            state_root_hash=pp.stateRootHash or "",
            txn_root_hash=pp.txnRootHash or "",
            pool_state_root_hash=pp.poolStateRootHash or "",
            timestamp=pp.ppTime,
        )

    # ------------------------------------------------------------ PREPARE

    def process_prepare(self, prepare, sender: str):
        pass

    # ------------------------------------------------------------- COMMIT

    def update_commit(self, params: dict, pp) -> dict:
        if self._signer is None:
            return params
        self._remember_value(pp)
        value = self._pp_values[(pp.viewNo, pp.ppSeqNo)]
        params["blsSig"] = self._signer.sign(value.as_single_value())
        return params

    def validate_commit(self, commit, sender: str, pp) -> Optional[str]:
        with self.metrics.measure_time(MetricsName.BLS_VALIDATE_TIME):
            return self._validate_commit(commit, sender, pp)

    def _validate_commit(self, commit, sender: str, pp) -> Optional[str]:
        sig = getattr(commit, "blsSig", None)
        if sig is None:
            return None  # shares are optional (node without BLS keys)
        pk = self._keys.get_key_by_name(sender)
        if pk is None:
            return None  # unknown key: can't check, don't block consensus
        self._remember_value(pp)
        if self._defer_share_verify \
                and commit.ppSeqNo > self._strict_until_seq:
            # cryptographic check deferred to process_order's single
            # aggregate pairing; nothing to reject here
            return None
        value = self._pp_values[(commit.viewNo, commit.ppSeqNo)]
        if not self._verifier.verify_sig(sig, value.as_single_value(), pk):
            return "invalid BLS signature share from {}".format(sender)
        self._verified_shares[(commit.viewNo, commit.ppSeqNo, sender)] = sig
        return None

    def process_commit(self, commit, sender: str):
        pass

    # -------------------------------------------------------------- ORDER

    def process_order(self, key, commits: Dict[str, "Commit"], pp,
                      quorums=None):
        with self.metrics.measure_time(MetricsName.BLS_AGGREGATE_TIME), \
                self.tracer.span("bls_aggregate", CAT_BLS,
                                 key="%d:%d" % key, shares=len(commits)):
            return self._process_order(key, commits, pp, quorums)

    def _process_order(self, key, commits: Dict[str, "Commit"], pp,
                       quorums=None):
        """Aggregate shares → MultiSignature → BlsStore (reference
        bls_bft_replica_plenum.py process_order). Every share is verified
        EXACTLY once: most were pairing-checked in validate_commit (the
        memo skips a second ~5 ms pairing here); a COMMIT that arrived
        (and was counted for consensus) before its PrePrepare was never
        checked, so it is verified now. The aggregate is only persisted
        with a bls_signatures (n-f) quorum of valid shares, so stored
        proofs always verify. `key` is the batch's ORIGINAL
        (view, seq) — `pp` is unused here (backfill retries after a
        view change may no longer hold the PrePrepare, only the
        key)."""
        value = self._pp_values.get(key)
        if value is None:
            return
        signed = value.as_single_value()
        sigs, participants, pks = [], [], []
        deferred_unchecked = []      # indices never pairing-checked
        for sender, commit in commits.items():
            sig = getattr(commit, "blsSig", None)
            if sig is None:
                continue
            pk = self._keys.get_key_by_name(sender)
            if pk is None:
                continue
            checked = self._verified_shares.get(
                (key[0], key[1], sender)) == sig
            if not checked and not self._defer_share_verify:
                if not self._verifier.verify_sig(sig, signed, pk):
                    logger.warning(
                        "%s dropping invalid BLS share from %s at %s",
                        self._name, sender, key)
                    continue
                checked = True
            if not checked:
                deferred_unchecked.append(len(sigs))
            sigs.append(sig)
            participants.append(sender)
            pks.append(pk)
        if deferred_unchecked:
            # OPTIMISTIC BATCH VERIFY: one aggregate pairing covers all
            # shares (what the stored proof's verification checks is
            # exactly this aggregate). Only on failure unroll per share
            # to drop the bad ones and assign blame — the honest-path
            # cost is 2 pairings per ordered batch, not 2 per share.
            # Deferred shares are UNVERIFIED attacker-controlled strings:
            # an undecodable one must route to the per-share unroll
            # (verify_sig absorbs decode errors), never crash ordering.
            try:
                agg = self._verifier.create_multi_sig(sigs)
            except Exception:
                agg = None
            if agg is not None and \
                    self._verifier.verify_multi_sig(agg, signed, pks):
                multi = MultiSignature(signature=agg,
                                       participants=sorted(participants),
                                       value=value)
                if quorums is None \
                        or quorums.bls_signatures.is_reached(len(sigs)):
                    self.bls_store.put(multi)
                    self._pending_backfill.pop(key, None)
                else:
                    self._await_backfill(key, commits)
                self._gc(key[1])
                return
            # the unroll is the batch seam: every deferred share gets
            # its own pairing check, and above BLS_PAIRING_DEVICE_MIN
            # they all run as ONE device launch (bls.verify_sigs_batch)
            verdicts = dict(zip(deferred_unchecked,
                                self._verifier.verify_sigs_batch(
                                    [(sigs[i], signed, pks[i])
                                     for i in deferred_unchecked])))
            keep = []
            for i, (sig, sender, pk) in enumerate(
                    zip(sigs, participants, pks)):
                if verdicts.get(i, True):
                    keep.append(i)
                else:
                    logger.warning(
                        "%s dropping invalid BLS share from %s at %s",
                        self._name, sender, key)
            sigs = [sigs[i] for i in keep]
            participants = [participants[i] for i in keep]
            if quorums is not None \
                    and not quorums.bls_signatures.is_reached(len(sigs)):
                # an invalid deferred share ate a quorum slot and cost
                # this batch its state proof — arrival-time checks
                # would have rejected that COMMIT. Go strict for a
                # window so the attacker cannot sustain suppression.
                # max(): a backfill retry for an OLD batch must never
                # REWIND a window armed by later abuse.
                self._strict_until_seq = max(self._strict_until_seq,
                                             key[1] + 100)
                logger.warning(
                    "%s: deferred BLS share verification abused at %s —"
                    " strict arrival checks until seq %d", self._name,
                    key, self._strict_until_seq)
        if quorums is not None \
                and not quorums.bls_signatures.is_reached(len(sigs)):
            self._await_backfill(key, commits)
            return
        if not sigs:
            self._await_backfill(key, commits)
            return
        multi = MultiSignature(
            signature=self._verifier.create_multi_sig(sigs),
            participants=sorted(participants),
            value=value)
        self.bls_store.put(multi)
        self._pending_backfill.pop(key, None)
        self._gc(key[1])

    # ----------------------------------------------------------- backfill

    def _await_backfill(self, key, commits: Dict[str, "Commit"]) -> None:
        """Register `key` proof-less, its shares so far the first
        candidates: a stable checkpoint or a view change may clear the
        ordering service's commit store before a late share lands, and
        the late shares alone may never reach the quorum."""
        self._pending_backfill[key] = True
        pool = self._backfill_commits.setdefault(key, {})
        for sender, commit in commits.items():
            if getattr(commit, "blsSig", None) is not None:
                pool.setdefault(sender, commit)

    def awaits_backfill(self, key) -> bool:
        """True while the batch `key` was ordered without a stored
        multi-sig and late shares may still complete it."""
        return key in self._pending_backfill

    def retry_backfill(self, key, commits: Dict[str, "Commit"], pp,
                       quorums=None) -> bool:
        """Late valid COMMITs for a batch that missed its bls_signatures
        quorum at ordering time retry the aggregation (ADVICE: a
        byzantine share may DELAY a stored state proof, never suppress
        it permanently). Called by the ordering service whenever a
        COMMIT lands on an already-ordered batch; cheap no-op unless the
        batch is registered proof-less AND enough candidate shares have
        now accumulated. → True once a multi-sig got stored."""
        if key not in self._pending_backfill:
            return False
        if key not in self._pp_values:
            # value GC'd — the proof window for this batch has passed
            del self._pending_backfill[key]
            self._backfill_commits.pop(key, None)
            return False
        pool = self._backfill_commits.setdefault(key, {})
        for sender, commit in commits.items():
            if getattr(commit, "blsSig", None) is not None:
                pool.setdefault(sender, commit)
        candidates = sum(
            1 for sender in pool
            if self._keys.get_key_by_name(sender) is not None)
        if quorums is not None \
                and not quorums.bls_signatures.is_reached(candidates):
            return False    # still short — wait for more late shares
        self._process_order(key, pool, pp, quorums)
        done = key not in self._pending_backfill
        if done:
            self._backfill_commits.pop(key, None)
            logger.info("%s: backfilled BLS multi-sig for %s from late "
                        "COMMIT shares", self._name, key)
        return done

    def _gc(self, below_seq: int):
        for k in [k for k in self._pp_values if k[1] < below_seq - 10]:
            del self._pp_values[k]
        for k in [k for k in self._verified_shares
                  if k[1] < below_seq - 10]:
            del self._verified_shares[k]
        for k in [k for k in self._pending_backfill
                  if k[1] < below_seq - 10]:
            del self._pending_backfill[k]
        for k in [k for k in self._backfill_commits
                  if k[1] < below_seq - 10]:
            del self._backfill_commits[k]
