"""Gateway intake — untrusted client envelopes in, screened batches out
(port of plenum_tpu/gateway/intake.py).

Three jobs, all at the trust boundary between "millions of users" and
the consensus pool:

* **Wire guard.** Client-facing senders speak the ``FLAT_WIRE``
  PROPAGATE envelope (one parse per envelope, request blobs behind a
  u32 offset table). Every structural violation — bad magic, version
  skew, truncated or over-length payload (``parse_envelope``'s
  ``max_bytes`` bound, wired to ``Config.MSG_LEN_LIMIT``) — is
  attributable to the sender: the sender takes a strike and, past
  ``GATEWAY_SENDER_STRIKES``, is shed (envelopes dropped unread).
  Nothing a sender puts on the wire can raise past ``unpack_client``
  — the intake loop cannot crash. Entry-level garbage (an
  undecodable request blob) costs only that entry, the flat-wire
  contract.
* **Dedup.** Retried and multiply-routed requests are collapsed on
  ``(identifier, reqId, signature)`` before any signature work — the
  same pure-function argument as ``dedup_items``: co-arriving copies
  of one request need one verdict.
* **Batched pre-screen.** Every admitted write's ed25519 signature
  joins ONE device dispatch through the injected verifier (by default
  a standalone ``CoalescingVerifierHub`` over the ed25519 kernel on
  the intake's device) — the batched-verify amortization applied where
  the fan-in is widest. The pre-screen is
  a FILTER, not the authority: nodes re-authenticate everything the
  gateway forwards (defense in depth — a compromised gateway can
  deny service, never forge admission), which is also why the
  admitted stream produces byte-identical ledger/state roots with or
  without a gateway in front.
"""
from __future__ import annotations

import logging
from collections import OrderedDict
from typing import List, Optional, Tuple

from plenum_tpu_torch.common.serializers import flat_wire
from plenum_tpu_torch.common.serializers.base58 import b58decode
from plenum_tpu_torch.common.serializers.serialization import (
    serialize_msg_for_signing)
from plenum_tpu_torch.crypto.signer import verkey_from_identifier
from plenum_tpu_torch.observability.telemetry import TM, NullTelemetryHub
from plenum_tpu_torch.observability.tracing import CAT_INTAKE, NullTracer

logger = logging.getLogger(__name__)

# dedup window: recently-seen request identities (client-chosen, so
# bounded); far above any one intake batch, far below allocation-attack
# territory
DEDUP_WINDOW_MAX = 1 << 16


class SenderRegistry:
    """Strike accounting for client-facing senders. Bounded LRU — the
    sender id space is client-chosen, so the registry must not be an
    allocation attack; evicting a stranger's strike record only
    forgives, never falsely sheds. ``strikes`` and ``max_senders``
    default to the Config class's GATEWAY_SENDER_STRIKES and
    GATEWAY_SENDER_REGISTRY_MAX; a Gateway passes its own config's."""

    def __init__(self, strikes: int = None, max_senders: int = None,
                 telemetry=None):
        from plenum_tpu_torch.common.config import Config
        self.strikes = int(Config.GATEWAY_SENDER_STRIKES
                           if strikes is None else strikes)
        self.max_senders = int(Config.GATEWAY_SENDER_REGISTRY_MAX
                               if max_senders is None else max_senders)
        self._counts: "OrderedDict[str, int]" = OrderedDict()
        self._tm = telemetry if telemetry is not None \
            else NullTelemetryHub()

    def is_shed(self, sender: str) -> bool:
        n = self._counts.get(sender)
        return n is not None and n >= self.strikes

    def strike(self, sender: str) -> bool:
        """One structural violation by ``sender``; → True when the
        sender is (now) shed."""
        n = self._counts.get(sender, 0) + 1
        self._counts[sender] = n
        self._counts.move_to_end(sender)
        while len(self._counts) > self.max_senders:
            self._counts.popitem(last=False)
        if n == self.strikes:
            self._tm.count(TM.GATEWAY_SHED_SENDERS, 1)
        return n >= self.strikes


class GatewayIntake:
    """The screening pipeline. Collaborators are all injected —
    ``verifier`` (any batch_verifier provider; None builds a standalone
    ``CoalescingVerifierHub`` over the ed25519 kernel on ``device``:
    None means CUDA and raises without a card, "cpu" runs the kernel's
    plain version), ``verkey_provider`` (identifier → verkey str, e.g.
    pool-state-backed; None falls back to cryptonym identifiers),
    ``telemetry`` (the gateway's hub) — so the intake runs without a
    Node."""

    def __init__(self, verifier=None, verkey_provider=None,
                 senders: SenderRegistry = None, telemetry=None,
                 max_envelope_bytes: int = None, tracer=None,
                 device=None):
        from plenum_tpu_torch.common.config import Config
        if verifier is None:
            from plenum_tpu_torch.crypto.batch_verifier import (
                CoalescingVerifierHub, TorchBatchVerifier)
            verifier = CoalescingVerifierHub(
                batch=TorchBatchVerifier(device), telemetry=telemetry)
        self._verifier = verifier
        self._verkeys = verkey_provider
        self._tm = telemetry if telemetry is not None \
            else NullTelemetryHub()
        self.tracer = tracer if tracer is not None else NullTracer()
        self.senders = senders if senders is not None \
            else SenderRegistry(telemetry=self._tm)
        self.max_envelope_bytes = int(Config.MSG_LEN_LIMIT
                                      if max_envelope_bytes is None
                                      else max_envelope_bytes)
        self._seen: "OrderedDict[tuple, None]" = OrderedDict()

    # ------------------------------------------------------ wire guard

    def unpack_client(self, data, sender: str
                      ) -> Optional[List[Tuple[dict, str]]]:
        """One client-facing FLAT_WIRE envelope → [(request dict,
        client id)], or None when the envelope was dropped (sender
        already shed, or struck for this structural violation). Never
        raises on sender-controlled bytes."""
        if self.senders.is_shed(sender):
            return None
        try:
            env = flat_wire.parse_envelope(
                data, max_bytes=self.max_envelope_bytes)
        except flat_wire.FlatWireError as e:
            self._strike(sender, str(e))
            return None
        out: List[Tuple[dict, str]] = []
        for sec in env.sections:
            if sec.kind != flat_wire.KIND_PROPAGATE:
                # a client has no business sending 3PC sections; the
                # whole envelope is sender-attributable garbage
                self._strike(sender, "non-PROPAGATE section %d at the "
                                     "client boundary" % sec.kind)
                return None
            for i in range(sec.n):
                try:
                    req = sec.request(i)
                except Exception:
                    logger.warning("gateway: bad request entry from %s "
                                   "— dropped", sender)
                    continue
                out.append((req, sec.client(i) or sender))
        return out

    def _strike(self, sender: str, why: str) -> None:
        self._tm.count(TM.WIRE_MALFORMED, 1)
        shed = self.senders.strike(sender)
        logger.warning("gateway: malformed envelope from %s (%s)%s",
                       sender, why, " — sender shed" if shed else "")

    # ----------------------------------------------------------- dedup

    def fresh_only(self, msgs: List[Tuple[dict, str]]
                   ) -> List[Tuple[dict, str]]:
        """Drop requests whose (identifier, reqId, signature) identity
        was already seen in the dedup window."""
        out = []
        for msg, client in msgs:
            ident = (msg.get("identifier"), msg.get("reqId"),
                     msg.get("signature")) if isinstance(msg, dict) \
                else None
            if ident is not None and ident in self._seen:
                self._tm.count(TM.GATEWAY_DEDUP_HITS, 1)
                continue
            if ident is not None:
                self._seen[ident] = None
                while len(self._seen) > DEDUP_WINDOW_MAX:
                    self._seen.popitem(last=False)
            out.append((msg, client))
        return out

    # ------------------------------------------------------ pre-screen

    def screen_dispatch(self, msgs: List[Tuple[dict, str]]):
        """Phase 1 (non-blocking): every screenable signature joins one
        coalesced device dispatch. → opaque handle for
        ``screen_conclude``. Requests the gateway cannot screen (no
        single signature, unresolvable verkey) pass through unscreened
        — the nodes are the authority; the pre-screen only exists to
        keep OBVIOUS garbage off the pool's verifier."""
        items, slots = [], []
        for msg, _client in msgs:
            item = self._verify_item(msg)
            slots.append(None if item is None else len(items))
            if item is not None:
                items.append(item)
        pending = self._verifier.dispatch(items) if items else None
        return (list(msgs), slots, pending)

    def screen_ready(self, handle) -> bool:
        pending = handle[2]
        if pending is None:
            return True
        r = getattr(pending, "ready", None)
        return bool(r()) if r is not None else True

    def screen_flush(self) -> None:
        fn = getattr(self._verifier, "flush", None)
        if fn is not None:
            fn()

    def screen_conclude(self, handle) -> List[Tuple[dict, str]]:
        """Phase 2 (harvests the device): → the surviving requests;
        signature rejects are counted and dropped."""
        msgs, slots, pending = handle
        results = pending.collect() if pending is not None else []
        out = []
        traced = getattr(self.tracer, "enabled", False)
        for (msg, client), slot in zip(msgs, slots):
            if slot is not None and not results[slot]:
                self._tm.count(TM.GATEWAY_SIG_REJECTS, 1)
                continue
            if traced:
                # journey anchor: the same digest the pool keys
                # ``request_accepted`` on, so a gateway-fronted pool's
                # journeys start at the trust boundary, not the first
                # replica. Hashing is paid only when tracing is on.
                digest = _request_digest(msg)
                if digest is not None:
                    self.tracer.instant("gateway_admit", CAT_INTAKE,
                                        key=digest)
            out.append((msg, client))
        return out

    def _verify_item(self, msg) -> Optional[tuple]:
        """(signing bytes, sig64, verkey32) for a single-signature
        request dict, or None when unscreenable."""
        if not isinstance(msg, dict):
            return None
        sig = msg.get("signature")
        idr = msg.get("identifier")
        if not isinstance(sig, str) or not isinstance(idr, str) \
                or msg.get("signatures"):
            return None
        try:
            sig_raw = b58decode(sig)
            verkey = self._verkeys(idr) if self._verkeys is not None \
                else None
            vk = verkey_from_identifier(idr, verkey)
            payload = {k: v for k, v in msg.items()
                       if k not in ("signature", "signatures")}
            ser = serialize_msg_for_signing(payload)
        except Exception:
            return None
        if len(sig_raw) != 64 or len(vk) != 32:
            return None
        return (ser, sig_raw, vk)


def _request_digest(msg) -> Optional[str]:
    """The pool's request digest (Request.digest: sha256 over the
    signed state) computed from the raw dict — the join key between a
    gateway admit and the node-side journey. None when the dict cannot
    produce one (unscreenable shapes pass through undigested)."""
    if not isinstance(msg, dict):
        return None
    try:
        from plenum_tpu_torch.common.request import Request
        return Request(**{k: msg[k] for k in (
            "identifier", "reqId", "operation", "signature",
            "signatures", "protocolVersion", "taaAcceptance",
            "endorser") if k in msg}).digest
    except (TypeError, ValueError, KeyError):
        return None
