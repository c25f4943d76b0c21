"""Peer blacklisting + suspicion reporting.

Reference: plenum/server/blacklister.py (Blacklister/SimpleBlacklister)
+ node.reportSuspiciousNode (node.py:2860). The reference deliberately
does NOT auto-blacklist nodes on suspicions ("TODO: Consider
blacklisting nodes again") because most suspicion codes are not
sender-attributable: under an equivocating primary, honest nodes'
PREPAREs mismatch each other's local PRE-PREPARE (PR_DIGEST_WRONG
against honest senders), and MessageReq re-attributes fetched
PRE-PREPAREs to the primary, letting one byzantine responder frame it.

So: every suspicion is logged and counted per peer; automatic
blacklisting is opt-in (Config.BLACKLIST_ON_SUSPICION) and then applies
only to DUPLICATE_PPR_SENT, the one code whose evidence names its
author. Operators (or future attributable evidence) can always
blacklist explicitly — the traffic filter honors the list either way.
"""
from __future__ import annotations

import logging
from abc import ABC, abstractmethod
from collections import Counter
from typing import Set

from plenum_tpu_torch.consensus.ordering_service import Suspicions

logger = logging.getLogger(__name__)

# codes whose offending evidence provably names its author: two
# conflicting PRE-PREPAREs signed for the same (view, seq), and a
# structurally corrupt flat wire envelope (it arrived whole on that
# peer's authenticated stream — nobody else could have framed it)
AUTO_BLACKLIST_CODES = frozenset({
    Suspicions.DUPLICATE_PPR_SENT,
    Suspicions.WIRE_MALFORMED,
})


class Blacklister(ABC):
    @abstractmethod
    def blacklist(self, name: str) -> None: ...

    @abstractmethod
    def is_blacklisted(self, name: str) -> bool: ...


class SimpleBlacklister(Blacklister):
    def __init__(self, name: str):
        self.name = name
        self.blacklisted: Set[str] = set()
        self.suspicion_counts: Counter = Counter()

    def report_suspicion(self, node: str, code, reason: str,
                         auto_blacklist: bool = False) -> None:
        """reference reportSuspiciousNode: always log + count;
        blacklist only attributable evidence, and only when enabled."""
        self.suspicion_counts[node] += 1
        logger.warning("%s raised suspicion on node %s for %s; code %s",
                       self.name, node, reason, code)
        if auto_blacklist and code in AUTO_BLACKLIST_CODES:
            self.blacklist(node)

    def blacklist(self, name: str) -> None:
        if name not in self.blacklisted:
            logger.warning("%s: blacklisting %s", self.name, name)
        self.blacklisted.add(name)

    def is_blacklisted(self, name: str) -> bool:
        return name in self.blacklisted
