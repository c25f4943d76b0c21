"""Typed pub-sub buses.

Reference: plenum/common/event_bus.py:6 (InternalBus), :11 (ExternalBus);
base Router plenum/common/router.py:5. All intra-replica coordination is
messages on an InternalBus; all network sends go through an ExternalBus whose
send handler is the transport (or the SimNetwork in tests).
"""
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Type


def _unwrap_three_pc_batch(message) -> Optional[list]:
    """Inner typed messages of a coalesced envelope — THREE_PC_BATCH or
    a flat-wire FLAT_WIRE envelope — or None when `message` is neither.
    Lazy import: the runtime layer must stay importable without the
    message schema module loaded. Dict entries (a real-transport typed
    envelope) are reconstructed through the message factory and flat
    payloads re-materialized through the codec so the tap always sees
    typed per-message granularity; an unreconstructable entry is
    dropped here exactly as the node's own intake would drop it."""
    from plenum_tpu_torch.common.messages.node_messages import (
        FlatBatch, ThreePCBatch)
    if isinstance(message, FlatBatch):
        from plenum_tpu_torch.common.serializers import flat_wire
        # malformed / all-entries-invalid envelopes pass through WHOLE
        # (the receiving node owns that judgement) — the policy is
        # single-sourced next to the codec
        return flat_wire.unwrap_for_tap(message.payload)
    if not isinstance(message, ThreePCBatch):
        return None
    from plenum_tpu_torch.common.messages.message_factory import (
        node_message_factory)
    out = []
    for entry in message.messages:
        if isinstance(entry, dict):
            try:
                entry = node_message_factory.get_instance(**entry)
            except Exception:
                continue
        out.append(entry)
    return out


class Router:
    """Maps message type → list of handlers; dispatch is synchronous."""

    def __init__(self):
        self._handlers: Dict[Type, List[Callable]] = {}

    def subscribe(self, message_type: Type, handler: Callable) -> Callable:
        self._handlers.setdefault(message_type, []).append(handler)
        def unsubscribe():
            self._handlers[message_type].remove(handler)
        return unsubscribe

    def handlers(self, message_type: Type) -> List[Callable]:
        return self._handlers.get(message_type, [])


class InternalBus(Router):
    def send(self, message: Any, *args):
        result = None
        for handler in self.handlers(type(message)):
            result = handler(message, *args)
        return result


class ExternalBus(Router):
    """Network-facing bus: `send` goes out via the transport handler;
    `process_incoming` dispatches received messages with their sender name.
    Tracks connected peers (reference event_bus.py:11).

    An optional TAP is the single interception seam for fault-injection
    tooling (testing/adversary): it sees every send/receive and may
    rewrite, duplicate, or drop traffic. The bus itself carries no
    behavior — it only routes what the tap returns."""

    class Connected(NamedTuple):
        pass

    class Disconnected(NamedTuple):
        pass

    def __init__(self, send_handler: Callable[[Any, Optional[Any]], None]):
        super().__init__()
        self._send_handler = send_handler
        self._connecteds = set()
        self._tap = None

    @property
    def connecteds(self) -> set:
        return self._connecteds

    def set_tap(self, tap) -> None:
        """Install a send/recv tap: an object with
        ``on_send(message, dst) -> Optional[List[(message, dst)]]`` and
        ``on_incoming(message, frm) -> Optional[List[(message, frm)]]``.
        ``None`` means pass-through; a list replaces the original
        (empty list = drop). Only one tap per bus — chaining belongs in
        the tap implementation, not here."""
        if self._tap is not None and tap is not None:
            raise ValueError("tap already installed")
        self._tap = tap

    def clear_tap(self) -> None:
        self._tap = None

    @property
    def has_tap(self) -> bool:
        """True while a fault-injection tap is installed — coalescing
        senders (ThreePCOutbox) fall back to per-message sends so the
        tap keeps seeing the per-type wire granularity its behaviors
        match on."""
        return self._tap is not None

    def send(self, message: Any, dst=None) -> None:
        """dst None = broadcast; str = single peer; list = multiple peers."""
        if self._tap is not None:
            routed = self._tap.on_send(message, dst)
            if routed is not None:
                for m, d in routed:
                    self._send_handler(m, d)
                return
        self._send_handler(message, dst)

    def send_raw(self, message: Any, dst=None) -> None:
        """Send bypassing the tap — used by the tap itself to release
        held/rewritten traffic without re-entering interception."""
        self._send_handler(message, dst)

    def process_incoming(self, message: Any, frm: str):
        if self._tap is not None and not isinstance(
                message, (self.Connected, self.Disconnected)):
            # coalesced 3PC envelopes from honest (untapped) senders
            # unwrap BEFORE the tap: behaviors match on per-type 3PC
            # votes, and an envelope passed through whole would smuggle
            # every inner vote past them — the receive-side mirror of
            # the ThreePCOutbox per-message degrade on the send side
            inner = _unwrap_three_pc_batch(message)
            if inner is not None:
                result = None
                for entry in inner:
                    result = self.process_incoming(entry, frm)
                return result
            routed = self._tap.on_incoming(message, frm)
            if routed is not None:
                result = None
                for m, f in routed:
                    result = self._dispatch(m, f)
                return result
        return self._dispatch(message, frm)

    def _dispatch(self, message: Any, frm: str):
        result = None
        for handler in self.handlers(type(message)):
            result = handler(message, frm)
        return result

    def update_connecteds(self, connecteds: set) -> None:
        new = connecteds - self._connecteds
        gone = self._connecteds - connecteds
        self._connecteds = set(connecteds)
        for name in new:
            self.process_incoming(self.Connected(), name)
        for name in gone:
            self.process_incoming(self.Disconnected(), name)
