"""Safety invariant checkers evaluated every sim tick.

Safety (checked continuously by Scenario.run):
  1. AGREEMENT — no two honest nodes order different batches at the
     same (original_view, seqNo): digest, state/txn roots and request
     set must match across nodes AND across time (a node must never
     rewrite its own history).
  2. LEDGER CONSISTENCY — honest nodes' ledgers agree at every size
     they both reach (checkpoint convergence: same prefix ⇒ same root).
  3. PROOF HONESTY — no honest node stores a BLS multi-sig over a
     state root that honest nodes did not order (a poisoned share must
     never smuggle a proof for a root the pool disagrees on).

Liveness (bounded-window assertions driven by Scenario helpers, not
every tick): ordering resumes after the fault stops; the view change
completes when the primary is the adversary."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple


class InvariantViolation(AssertionError):
    """A byzantine-safety invariant broke — the pool forked."""


def _replica_of(node):
    return getattr(node, "replica", node)


class InvariantChecker:
    def __init__(self, nodes, honest_names: Optional[List[str]] = None):
        self._nodes = list(nodes)
        self._honest = set(honest_names) if honest_names is not None \
            else {n.name for n in nodes}
        # (orig_view, seq) -> (digest, state_root, txn_root, reqs) agreed
        # by the first honest orderer; every later observation must match
        self._ordered_history: Dict[Tuple[int, int], Tuple] = {}
        self._ordered_by: Dict[Tuple[int, int], str] = {}
        # per-node count of ordered_log entries already folded in
        self._seen_ordered: Dict[str, int] = {}
        # ledger label -> size -> (root, first_node)
        self._ledger_roots: Dict[str, Dict[int, Tuple[str, str]]] = {}
        self.checks = 0

    # ------------------------------------------------------------ public

    def honest_nodes(self) -> List:
        return [n for n in self._nodes if n.name in self._honest]

    def ordered_state_roots(self) -> set:
        return {v[1] for v in self._ordered_history.values()
                if v[1] is not None}

    def check(self) -> None:
        """Run every safety invariant; raises InvariantViolation."""
        self.checks += 1
        for node in self.honest_nodes():
            self._check_agreement(node)
        for node in self.honest_nodes():
            self._check_ledgers(node)
        roots = self.ordered_state_roots()
        for node in self.honest_nodes():
            self._check_multisigs(node, roots)

    # ------------------------------------------------- 1: agreement

    def _check_agreement(self, node) -> None:
        replica = _replica_of(node)
        log = replica.ordered_log
        start = self._seen_ordered.get(node.name, 0)
        for ordered in log[start:]:
            ov = ordered.originalViewNo \
                if ordered.originalViewNo is not None else ordered.viewNo
            key = (ov, ordered.ppSeqNo)
            value = (ordered.digest, ordered.stateRootHash,
                     ordered.txnRootHash,
                     tuple(ordered.valid_reqIdr))
            agreed = self._ordered_history.get(key)
            if agreed is None:
                self._ordered_history[key] = value
                self._ordered_by[key] = node.name
            elif agreed != value:
                raise InvariantViolation(
                    "SAFETY FORK at {}: {} ordered {} but {} ordered {}"
                    .format(key, self._ordered_by[key], agreed,
                            node.name, value))
        self._seen_ordered[node.name] = len(log)

    # ------------------------------------------- 2: ledger consistency

    def _check_ledgers(self, node) -> None:
        for label in ("domain_ledger", "audit_ledger"):
            ledger = getattr(node, label, None)
            if ledger is None:
                continue
            size, root = ledger.size, ledger.root_hash
            seen = self._ledger_roots.setdefault(label, {})
            agreed = seen.get(size)
            if agreed is None:
                seen[size] = (root, node.name)
            elif agreed[0] != root:
                raise InvariantViolation(
                    "LEDGER FORK: {} size {} — {} has root {} but {} "
                    "has {}".format(label, size, agreed[1], agreed[0],
                                    node.name, root))

    # --------------------------------------------- 3: proof honesty

    def _check_multisigs(self, node, honest_roots: set) -> None:
        bls = getattr(node, "bls_bft_replica", None)
        if bls is None:
            bls = getattr(_replica_of(node).ordering, "_bls", None)
        store = getattr(bls, "bls_store", None)
        if store is None or not honest_roots:
            return
        for root, multi in store.items():
            if root not in honest_roots:
                raise InvariantViolation(
                    "DISHONEST PROOF: {} stores a multi-sig over state "
                    "root {} which no honest node ordered"
                    .format(node.name, root))
            if multi.value.state_root_hash != root:
                raise InvariantViolation(
                    "CORRUPT PROOF: {} multi-sig keyed {} signs root {}"
                    .format(node.name, root,
                            multi.value.state_root_hash))
