"""Signed-read cache — proof-carrying read responses, served locally
(port of plenum_tpu/gateway/read_cache.py).

A GET_NYM answer from the pool carries a ``{root_hash, proof_nodes,
multi_signature}`` state proof: n-f nodes' BLS multi-signature vouches
for the root, the proof nodes tie the value to it. That makes the
RESPONSE itself the unit of trust — the gateway can replay it to any
number of clients without asking the pool again, because the proof
verifies identically in every hand (the same single-node-trust
argument as ``PoolClient.verify_proof_dict``, one tier earlier).

Freshness semantics:

* **Verified on insert.** An entry is stored only if the injected
  ``check_proof`` (``PoolClient.check_proof_dict``) returns None; the
  named error is surfaced to the caller otherwise. The cache never
  stores — and therefore never serves — an unproven answer.
* **Window on the multi-sig timestamp.** A hit is served only while
  ``now - multi_signature.value.timestamp <= fresh_s`` — the same
  clock the proof's signers stamped, so a gateway with a skewed local
  clock fails toward the pool, not toward stale data.
* **Root pinning.** The cache tracks the newest signed root it has
  observed per ledger (the pinned-root idea at the gateway);
  entries proven under an OLDER root are invalidated lazily on
  lookup. A pool that moved on makes the whole generation miss at
  once, which is exactly when the answers may have changed.

Capacity is LRU-bounded (``GATEWAY_CACHE_MAX``): state keys are
client-chosen, so an unbounded map is an allocation attack.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Optional, Tuple

from plenum_tpu_torch.observability.telemetry import TM, NullTelemetryHub

CacheKey = Tuple[int, bytes]   # (ledger_id, state_key)


class _Entry:
    __slots__ = ("result", "root", "signed_ts")

    def __init__(self, result: dict, root: str, signed_ts: float):
        self.result = result
        self.root = root
        self.signed_ts = signed_ts


class SignedReadCache:
    def __init__(self, check_proof: Callable[..., Optional[str]],
                 fresh_s: float = None, max_entries: int = None,
                 telemetry=None):
        """``check_proof(sp, key, value, ledger_id=..., max_age=...,
        now=...) -> Optional[str]`` is ``PoolClient.check_proof_dict``
        (or a stand-in with its contract): None = proven, else the
        named failed check. ``fresh_s`` and ``max_entries`` default to
        the Config class's GATEWAY_CACHE_FRESH_S and GATEWAY_CACHE_MAX;
        a Gateway passes its own config's values."""
        from plenum_tpu_torch.common.config import Config
        self._check = check_proof
        self.fresh_s = float(Config.GATEWAY_CACHE_FRESH_S
                             if fresh_s is None else fresh_s)
        self.max_entries = int(Config.GATEWAY_CACHE_MAX
                               if max_entries is None else max_entries)
        self._entries: "OrderedDict[CacheKey, _Entry]" = OrderedDict()
        self._newest_root: dict = {}       # ledger_id -> (ts, root)
        self._tm = telemetry if telemetry is not None \
            else NullTelemetryHub()

    def __len__(self) -> int:
        return len(self._entries)

    # -------------------------------------------------------- insert

    def put(self, ledger_id: int, state_key: bytes,
            expected_value: Optional[bytes], result: dict,
            now: float) -> Optional[str]:
        """Verify + store one proof-bearing read result; → None on
        success or the named failed check (entry NOT stored)."""
        from plenum_tpu_torch.common.constants import (
            MULTI_SIGNATURE, ROOT_HASH, STATE_PROOF)
        sp = result.get(STATE_PROOF) if isinstance(result, dict) else None
        if not isinstance(sp, dict):
            return "no state proof attached"
        err = self._check(sp, state_key, expected_value,
                          ledger_id=ledger_id, max_age=self.fresh_s,
                          now=now)
        if err is not None:
            return err
        try:
            signed_ts = float(sp[MULTI_SIGNATURE]["value"]["timestamp"])
            root = sp[ROOT_HASH]
        except (KeyError, TypeError, ValueError):
            # check_proof passed, so this shape should be impossible —
            # refuse rather than store an entry we cannot age
            return "malformed state proof: no usable timestamp/root"
        key = (int(ledger_id), bytes(state_key))
        self._entries[key] = _Entry(result, root, signed_ts)
        self._entries.move_to_end(key)
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)
        newest = self._newest_root.get(int(ledger_id))
        if newest is None or signed_ts >= newest[0]:
            self._newest_root[int(ledger_id)] = (signed_ts, root)
        return None

    # -------------------------------------------------------- lookup

    def get(self, ledger_id: int, state_key: bytes,
            now: float) -> Optional[dict]:
        """→ the cached proof-bearing result, or None (miss / stale /
        superseded root)."""
        key = (int(ledger_id), bytes(state_key))
        entry = self._entries.get(key)
        if entry is None:
            self._tm.count(TM.GATEWAY_CACHE_MISSES, 1)
            return None
        newest = self._newest_root.get(int(ledger_id))
        superseded = newest is not None and entry.root != newest[1]
        if superseded or now - entry.signed_ts > self.fresh_s:
            del self._entries[key]
            self._tm.count(TM.GATEWAY_CACHE_MISSES, 1)
            return None
        self._entries.move_to_end(key)
        self._tm.count(TM.GATEWAY_CACHE_HITS, 1)
        return entry.result
