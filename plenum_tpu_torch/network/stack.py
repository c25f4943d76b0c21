"""Authenticated TCP mesh transport — the ZStack equivalent.

Reference: stp_zmq/zstack.py:52 (ZStack: ROUTER listener + per-remote
DEALER sockets, CurveCP, ping/pong :750-794, quota-bounded service
:481-605, 128KB limit), kit_zstack.py:28 (KITZStack registry-driven
reconnects), plenum/common/batched.py:20,91 (per-remote outbox
coalescing into signed Batch messages), plenum/common/stacks.py:30,167
(NodeZStack / ClientZStack with client connection limits).

Design: asyncio TCP instead of libzmq. Each node runs
one listener; for every registry peer it also dials an outgoing
connection (the "DEALER"): application data is sent ONLY on the dialed
connection, received ONLY on accepted ones — same directionality as the
reference's DEALER→ROUTER flow, so either side can restart and the
dialer's keep-in-touch loop re-establishes the link. Every connection is
encrypted+authenticated by the SIGMA handshake in crypto_channel (the
CurveZMQ stand-in); node listeners only accept registry verkeys, the
client listener accepts anonymous initiators (request signatures still
authenticate writes). Wire frames are 4-byte length-prefixed msgpack;
outboxes coalesce per tick into Ed25519-signed BATCH envelopes; receive
side is quota-bounded per service() call (backpressure for the
single-threaded prod loop).

Deliberately superseded reference components (not missing):

- ``ClientMessageProvider`` (stp_zmq/client_message_provider.py:14), the
  bounded retry deque for replies to disconnected clients. Client ids
  here are per-connection, so a queued reply could never be re-routed to
  a reconnect; instead the node re-serves committed Replies from its
  payload-digest index when the client re-sends the request
  (server/node.py `_committed_reply`) — the reference's own durable
  recovery path, minus the lossy in-memory queue in front of it.
- ``PortDispenser`` (stp_core/network/port_dispenser.py:11), the
  file-locked port allocator for parallel test runs. Rung-3 tests bind
  OS-assigned ports (``HA("127.0.0.1", 0)``, tests/test_network_stack.py)
  and read the bound port back, which cannot collide by construction.
"""
from __future__ import annotations

import asyncio
import logging
import time
from collections import deque
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Set

from plenum_tpu_torch.common.config import Config
from plenum_tpu_torch.common.constants import OP_FIELD_NAME
from plenum_tpu_torch.common.serializers.base58 import b58decode, b58encode
from plenum_tpu_torch.common.serializers.serializers import MsgPackSerializer
from plenum_tpu_torch.network.crypto_channel import (
    HandshakeError, Initiator, Responder, Session)
from plenum_tpu_torch.network.keys import NodeKeys

logger = logging.getLogger(__name__)

from plenum_tpu_torch.utils.metrics import MetricsName as _MN
_ENC_TIME = _MN.WIRE_ENCODE_TIME
_BYTES_SENT = _MN.TRANSPORT_BYTES_SENT

serializer = MsgPackSerializer()

PING_OP = "ping_"
PONG_OP = "pong_"
BATCH_OP = "BATCH"


def pack_message_groups(msgs, budget, msg_len_limit, who=""):
    """Shared size-budgeted packing for outbox flushes (node batches
    and client-reply coalescing use the SAME rules): yields
    ('raw', msg) for messages that must travel alone and
    ('group', [msgs]) for batchable runs under `budget`. A single
    message past `msg_len_limit` is dropped loudly — sending it would
    make the peer's read_frame limit check kill the connection.
    Each grouped message also costs a msgpack bin header (<=5 bytes);
    at thousands of small messages per batch that per-item overhead
    alone can push the sealed frame past the limit, so it is part of
    the size accounting."""
    PER_MSG = 8
    group, group_size = [], 0
    for m in msgs:
        if len(m) > msg_len_limit:
            logger.error(
                "%s: message of %d bytes exceeds the %d-byte frame "
                "limit - dropped (%r...)", who, len(m), msg_len_limit,
                m[:128])
            continue
        if len(m) + PER_MSG > budget:
            # too big to share an envelope, fine as its own raw frame
            if group:
                yield ('group', group)
                group, group_size = [], 0
            yield ('raw', m)
            continue
        if group and group_size + len(m) + PER_MSG > budget:
            yield ('group', group)
            group, group_size = [], 0
        group.append(m)
        group_size += len(m) + PER_MSG
    if group:
        yield ('group', group)


class HA(NamedTuple):
    host: str
    port: int


class RemoteInfo(NamedTuple):
    name: str
    ha: HA
    verkey: bytes  # raw 32-byte ed25519 verkey


class Connection:
    """One established (handshaken) stream + its read loop."""

    def __init__(self, reader, writer, session: Session, label: str):
        self.reader = reader
        self.writer = writer
        self.session = session
        self.label = label
        self.last_seen = time.monotonic()
        self.alive = True
        self.bytes_in = 0
        self.bytes_out = 0

    def send_frame(self, payload: bytes):
        data = self.session.encrypt(payload)
        self.writer.write(len(data).to_bytes(4, "big") + data)
        self.bytes_out += len(data) + 4

    async def read_frame(self, limit: int) -> Optional[bytes]:
        try:
            hdr = await self.reader.readexactly(4)
            n = int.from_bytes(hdr, "big")
            if n > limit + 64:  # AEAD tag + slack
                raise HandshakeError("oversized frame {}".format(n))
            data = await self.reader.readexactly(n)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            return None
        self.bytes_in += n + 4
        self.last_seen = time.monotonic()
        return self.session.decrypt(data)

    def close(self):
        self.alive = False
        try:
            self.writer.close()
        except Exception:
            pass


async def _handshake_frames(reader, writer, step_in: bool, payload=None,
                            timeout: float = 10.0):
    """Length-prefixed plaintext handshake frame IO."""
    if payload is not None:
        writer.write(len(payload).to_bytes(4, "big") + payload)
        await writer.drain()
    if step_in:
        hdr = await asyncio.wait_for(reader.readexactly(4), timeout)
        n = int.from_bytes(hdr, "big")
        if n > 4096:
            raise HandshakeError("oversized handshake frame")
        return await asyncio.wait_for(reader.readexactly(n), timeout)
    return None


class Remote:
    """Peer handle: registry entry + outgoing connection + outbox
    (reference stp_zmq/remote.py)."""

    def __init__(self, info: RemoteInfo):
        self.info = info
        self.conn: Optional[Connection] = None
        self.outbox: deque = deque()
        self.connecting = False
        self.next_retry = 0.0
        self.retry_count = 0
        self.ping_sent_at = 0.0

    @property
    def name(self):
        return self.info.name

    @property
    def is_connected(self) -> bool:
        return self.conn is not None and self.conn.alive

    def disconnect(self):
        if self.conn is not None:
            self.conn.close()
            self.conn = None


class StackBase:
    """Shared listener + rx-queue machinery."""

    def __init__(self, name: str, ha: HA, keys: NodeKeys,
                 config: Optional[Config] = None):
        self.name = name
        self.ha = ha
        self.keys = keys
        self.config = config or Config()
        self._server: Optional[asyncio.AbstractServer] = None
        # decoded inbound messages: (msg_dict, frm_name)
        self.rx: deque = deque()
        self._tasks: Set[asyncio.Task] = set()
        self._stopped = False
        self.msg_len_limit = self.config.MSG_LEN_LIMIT
        from plenum_tpu_torch.utils.metrics import NullMetricsCollector
        self.metrics = NullMetricsCollector()  # host node injects
        # interception seam for fault-injection tooling
        # (testing/adversary): on_send(msg, dst) / on_incoming(msg, frm)
        # may rewrite, duplicate, or drop wire traffic; None =
        # pass-through. The stack itself carries no fault behavior.
        self.wire_tap = None

    # ------------------------------------------------------------ server

    async def start(self):
        self._server = await asyncio.start_server(
            self._on_accept, self.ha.host, self.ha.port)
        if self.ha.port == 0:  # ephemeral: record the real port
            self.ha = HA(self.ha.host,
                         self._server.sockets[0].getsockname()[1])
        logger.info("%s listening on %s:%d", self.name, *self.ha)

    async def stop(self):
        self._stopped = True
        if self._server is not None:
            self._server.close()
            self._server = None
        for t in list(self._tasks):
            t.cancel()
        self._tasks.clear()
        # server.close() does NOT cancel established connection handlers
        # — a "stopped" stack whose read loops keep answering heartbeats
        # is a zombie peers never detect as dead
        self._close_connections()

    def _close_connections(self):
        """Subclasses close every live connection they hold."""

    def _spawn(self, coro) -> asyncio.Task:
        task = asyncio.get_event_loop().create_task(coro)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        return task

    async def _on_accept(self, reader, writer):
        raise NotImplementedError

    # --------------------------------------------------------- rx path

    def _enqueue_wire(self, payload: bytes, frm: str):
        """Decode one wire frame (possibly a BATCH) into rx entries."""
        try:
            msg = serializer.deserialize(payload)
        except Exception:
            logger.warning("%s: undecodable frame from %s", self.name, frm)
            return
        if not isinstance(msg, dict):
            logger.warning("%s: non-dict frame from %s", self.name, frm)
            return
        self.rx.append((msg, frm))

    def service(self, on_message: Callable[[dict, str], None],
                quota: Optional[int] = None,
                size_quota: Optional[int] = None) -> int:
        """Drain up to quota inbound messages (reference zstack.py:481
        quota-bounded service)."""
        count = 0
        size = 0
        quota = quota if quota is not None else len(self.rx)
        while self.rx and count < quota:
            msg, frm = self.rx.popleft()
            count += 1
            size += len(str(msg))
            if self.wire_tap is not None:
                routed = self.wire_tap.on_incoming(msg, frm)
                if routed is not None:
                    for m, f in routed:
                        try:
                            on_message(m, f)
                        except Exception:
                            logger.exception(
                                "%s: handler failed for msg from %s",
                                self.name, f)
                    continue
            try:
                on_message(msg, frm)
            except Exception:
                logger.exception("%s: handler failed for msg from %s",
                                 self.name, frm)
            if size_quota is not None and size >= size_quota:
                break
        if count:
            self.metrics.add_event(_MN.TRANSPORT_MSGS_RECV, count)
        return count


class NodeStack(StackBase):
    """Inter-validator mesh: KIT reconnects + signed batching + liveness."""

    def __init__(self, name: str, ha: HA, keys: NodeKeys,
                 registry: Dict[str, RemoteInfo],
                 config: Optional[Config] = None,
                 on_connections_changed: Callable[[Set[str]], None] = None):
        super().__init__(name, ha, keys, config)
        self.remotes: Dict[str, Remote] = {}
        self._vk_to_name: Dict[bytes, str] = {}
        self._incoming: Dict[str, Connection] = {}
        self._on_conns_changed = on_connections_changed or (lambda s: None)
        self._last_connecteds: Set[str] = set()
        for info in registry.values():
            if info.name != self.name:
                self.add_remote(info)

    def _close_connections(self):
        for conn in list(self._incoming.values()):
            conn.close()
        self._incoming.clear()
        for remote in self.remotes.values():
            remote.disconnect()

    # ------------------------------------------------------- membership

    def add_remote(self, info: RemoteInfo):
        self.remotes[info.name] = Remote(info)
        self._vk_to_name[info.verkey] = info.name

    def remove_remote(self, name: str):
        remote = self.remotes.pop(name, None)
        if remote is not None:
            self._vk_to_name.pop(remote.info.verkey, None)
            remote.disconnect()
        conn = self._incoming.pop(name, None)
        if conn is not None:
            conn.close()
        self._emit_connecteds()

    def update_remote(self, info: RemoteInfo):
        """HA or key change from a pool NODE txn → reconnect."""
        old = self.remotes.get(info.name)
        if old is not None and old.info == info:
            return
        self.remove_remote(info.name)
        self.add_remote(info)

    @property
    def connecteds(self) -> Set[str]:
        return {n for n, r in self.remotes.items() if r.is_connected}

    def _emit_connecteds(self):
        conns = self.connecteds
        if conns != self._last_connecteds:
            self._last_connecteds = set(conns)
            self._on_conns_changed(conns)

    # -------------------------------------------------------- listener

    async def _on_accept(self, reader, writer):
        try:
            responder = Responder(self.keys.sk,
                                  allowed_vks=set(self._vk_to_name),
                                  allow_anonymous=False)
            m1 = await _handshake_frames(reader, writer, True)
            m2 = responder.consume_message1(m1)
            m3 = await _handshake_frames(reader, writer, True, payload=m2)
            responder.consume_message3(m3)
        except (HandshakeError, asyncio.TimeoutError, ConnectionError,
                OSError, asyncio.IncompleteReadError) as e:
            logger.info("%s: inbound handshake failed: %s", self.name, e)
            writer.close()
            return
        frm = self._vk_to_name[responder.peer_verkey]
        conn = Connection(reader, writer, responder.session(),
                          "{}<-{}".format(self.name, frm))
        old = self._incoming.get(frm)
        if old is not None:
            old.close()
        self._incoming[frm] = conn
        try:
            await self._read_loop(conn, frm)
        except (HandshakeError, ConnectionError, OSError,
                asyncio.IncompleteReadError) as e:
            # a bad frame (oversize, corrupt AEAD) must drop THIS link,
            # not surface as an unhandled asyncio exception
            logger.warning("%s: read from %s failed: %s",
                           self.name, frm, e)
            conn.close()
            if self._incoming.get(frm) is conn:
                del self._incoming[frm]

    async def _read_loop(self, conn: Connection, frm: str):
        while conn.alive:
            payload = await conn.read_frame(self.msg_len_limit)
            if payload is None:
                conn.close()
                break
            self._dispatch_frame(payload, frm, conn)
        if self._incoming.get(frm) is conn:
            del self._incoming[frm]

    def _dispatch_frame(self, payload: bytes, frm: str, conn: Connection):
        if payload == b"pi":
            # liveness probe: answer on the same (incoming) stream
            try:
                conn.send_frame(b"po")
            except Exception:
                conn.close()
            return
        if payload == b"po":
            remote = self.remotes.get(frm)
            if remote is not None:
                remote.ping_sent_at = 0.0
            return
        self._unpack_wire(payload, frm)

    def _unpack_wire(self, payload: bytes, frm: str):
        self.metrics.add_event(_MN.TRANSPORT_BYTES_RECV, len(payload))
        with self.metrics.measure_time(_MN.WIRE_DECODE_TIME):
            return self._unpack_wire_inner(payload, frm)

    def _unpack_wire_inner(self, payload: bytes, frm: str):
        try:
            msg = serializer.deserialize(payload)
        except Exception:
            logger.warning("%s: undecodable frame from %s", self.name, frm)
            return
        if not isinstance(msg, dict):
            return
        if msg.get(OP_FIELD_NAME) == BATCH_OP:
            if not self._verify_batch_sig(msg, frm):
                logger.warning("%s: bad batch signature from %s",
                               self.name, frm)
                return
            for raw in msg.get("messages", []):
                self._enqueue_wire(raw if isinstance(raw, bytes)
                                   else bytes(raw), frm)
            return
        self.rx.append((msg, frm))

    def _verify_batch_sig(self, batch: dict, frm: str) -> bool:
        remote = self.remotes.get(frm)
        if remote is None:
            return False
        sig = batch.get("signature")
        if not sig:
            return False
        from plenum_tpu_torch.network.crypto_channel import (
            Ed25519PublicKey, InvalidSignature)
        content = b"".join(bytes(m) for m in batch.get("messages", []))
        try:
            Ed25519PublicKey.from_public_bytes(
                remote.info.verkey).verify(b58decode(sig), content)
            return True
        except (InvalidSignature, ValueError):
            return False

    # ---------------------------------------------------- KIT lifecycle

    def service_lifecycle(self):
        """Reconnects + heartbeats; call every prod tick (reference
        keep_in_touch.py:36 serviceLifecycle)."""
        if self._stopped:
            # a prod after stop() must not re-dial peers and resurrect
            # the zombie stop() just killed
            return
        now = time.monotonic()
        for remote in self.remotes.values():
            if remote.is_connected:
                self._maybe_ping(remote, now)
            elif not remote.connecting and now >= remote.next_retry:
                remote.connecting = True
                self._spawn(self._connect(remote))
        self._emit_connecteds()

    def _maybe_ping(self, remote: Remote, now: float):
        if not self.config.ENABLE_HEARTBEATS:
            return
        conn = remote.conn
        idle = now - conn.last_seen
        if remote.ping_sent_at and \
                now - remote.ping_sent_at > 2 * self.config.HEARTBEAT_FREQ:
            logger.info("%s: %s unresponsive, dropping link",
                        self.name, remote.name)
            remote.disconnect()
            remote.ping_sent_at = 0.0
            return
        if idle > self.config.HEARTBEAT_FREQ and not remote.ping_sent_at:
            try:
                conn.send_frame(b"pi")
                remote.ping_sent_at = now
            except Exception:
                remote.disconnect()

    async def _connect(self, remote: Remote):
        try:
            reader, writer = await asyncio.open_connection(
                remote.info.ha.host, remote.info.ha.port)
            initiator = Initiator(self.keys.sk,
                                  expected_peer_vk=remote.info.verkey)
            m2 = await _handshake_frames(reader, writer, True,
                                         payload=initiator.message1())
            m3 = initiator.consume_message2(m2)
            await _handshake_frames(reader, writer, False, payload=m3)
            conn = Connection(reader, writer, initiator.session(),
                              "{}->{}".format(self.name, remote.name))
            remote.conn = conn
            remote.retry_count = 0
            remote.ping_sent_at = 0.0
            self._spawn(self._outgoing_read_loop(remote, conn))
            logger.info("%s connected to %s", self.name, remote.name)
            self._emit_connecteds()
        except (HandshakeError, asyncio.TimeoutError, ConnectionError,
                OSError, asyncio.IncompleteReadError) as e:
            logger.debug("%s: connect to %s failed: %s",
                         self.name, remote.name, e)
            remote.retry_count += 1
            backoff = min(self.config.RETRY_TIMEOUT_NOT_RESTRICTED,
                          0.1 * (2 ** min(remote.retry_count, 6)))
            remote.next_retry = time.monotonic() + backoff
        finally:
            remote.connecting = False

    async def _outgoing_read_loop(self, remote: Remote, conn: Connection):
        """The dialed link mostly carries our sends; inbound on it is
        control traffic (pongs) or a peer answering on our link."""
        while conn.alive:
            payload = await conn.read_frame(self.msg_len_limit)
            if payload is None:
                conn.close()
                break
            self._dispatch_frame(payload, remote.name, conn)
        if remote.conn is conn:
            remote.conn = None
            self._emit_connecteds()

    # ---------------------------------------------------------- tx path

    def send(self, msg_dict: dict, dst=None):
        """Enqueue; dst None = broadcast, str or list of names."""
        if self.wire_tap is not None:
            routed = self.wire_tap.on_send(msg_dict, dst)
            if routed is not None:
                for m, d in routed:
                    self._send_untapped(m, d)
                return
        self._send_untapped(msg_dict, dst)

    def _send_untapped(self, msg_dict: dict, dst=None):
        raw = serializer.serialize(msg_dict)
        if len(raw) > self.msg_len_limit:
            logger.warning("%s: dropping oversized %dB message",
                           self.name, len(raw))
            return
        if dst is None:
            dsts = list(self.remotes)
        elif isinstance(dst, str):
            dsts = [dst]
        else:
            dsts = list(dst)
        for name in dsts:
            remote = self.remotes.get(name)
            if remote is None:
                logger.info("%s: no remote %s", self.name, name)
                continue
            remote.outbox.append(raw)

    def flush_outboxes(self) -> int:
        """Coalesce each remote's outbox into signed BATCH frames
        (reference batched.py:91 flushOutBoxes). → messages flushed."""
        flushed = 0
        for remote in self.remotes.values():
            if not remote.outbox:
                continue
            if not remote.is_connected:
                # bound memory while disconnected
                while len(remote.outbox) > 10000:
                    remote.outbox.popleft()
                continue
            msgs = list(remote.outbox)
            remote.outbox.clear()
            flushed += len(msgs)
            try:
                if len(msgs) == 1:
                    self._count_sent(len(msgs[0]))
                    remote.conn.send_frame(msgs[0])
                else:
                    with self.metrics.measure_time(_ENC_TIME):
                        frames = self._make_batches(msgs)
                    for frame in frames:
                        self._count_sent(len(frame))
                        remote.conn.send_frame(frame)
            except Exception:
                logger.info("%s: send to %s failed; dropping link",
                            self.name, remote.name)
                remote.disconnect()
                remote.outbox.extendleft(reversed(msgs))
                flushed -= len(msgs)
        self._emit_connecteds()
        return flushed

    def _count_sent(self, nbytes: int):
        self.metrics.add_event(_BYTES_SENT, nbytes)

    def _make_batches(self, msgs: List[bytes]) -> List[bytes]:
        """Pack serialized messages into signed batches under the size
        limit (reference prepare_batch.py split_messages_on_batches) —
        the packing rules live in pack_message_groups, shared with the
        client-reply coalescer."""
        frames = []
        for kind, val in pack_message_groups(
                msgs, self.msg_len_limit - 512, self.msg_len_limit,
                who=self.name):
            frames.append(val if kind == 'raw' else self._seal_batch(val))
        return frames

    def _seal_batch(self, group: List[bytes]) -> bytes:
        if len(group) == 1:
            return group[0]
        sig = b58encode(self.keys.sign(b"".join(group)))
        return serializer.serialize({
            OP_FIELD_NAME: BATCH_OP, "messages": group, "signature": sig})


class ClientStack(StackBase):
    """Client-facing listener (reference ClientZStack: one listener,
    anonymous-encrypted clients, connection limit protection)."""

    def __init__(self, name: str, ha: HA, keys: NodeKeys,
                 config: Optional[Config] = None):
        super().__init__(name, ha, keys, config)
        self._clients: Dict[str, Connection] = {}
        self._order: deque = deque()  # client ids, accept order
        self._counter = 0
        # per-client outbox for tick-coalesced replies: a committed
        # batch produces hundreds of Replies to the same client, and
        # one AEAD frame per Reply made the reply path the measured
        # wall of the multi-process pool (~150 us/reply). Queued sends
        # coalesce into BATCH envelopes at flush (reference batched.py
        # does this for the node stack; the client stack needs it just
        # as much under load)
        self._outboxes: Dict[str, List[bytes]] = {}

    def _close_connections(self):
        for conn in list(self._clients.values()):
            conn.close()
        self._clients.clear()
        self._order.clear()

    async def _on_accept(self, reader, writer):
        try:
            responder = Responder(self.keys.sk, allowed_vks=None,
                                  allow_anonymous=True)
            m1 = await _handshake_frames(reader, writer, True)
            m2 = responder.consume_message1(m1)
            m3 = await _handshake_frames(reader, writer, True, payload=m2)
            responder.consume_message3(m3)
        except (HandshakeError, asyncio.TimeoutError, ConnectionError,
                OSError, asyncio.IncompleteReadError) as e:
            logger.info("%s: client handshake failed: %s", self.name, e)
            writer.close()
            return
        self._counter += 1
        peer = writer.get_extra_info("peername") or ("?", 0)
        client_id = "client:{}:{}#{}".format(peer[0], peer[1], self._counter)
        conn = Connection(reader, writer, responder.session(), client_id)
        self._clients[client_id] = conn
        self._order.append(client_id)
        self._enforce_connection_limit()
        while conn.alive:
            payload = await conn.read_frame(self.msg_len_limit)
            if payload is None:
                conn.close()
                break
            self._enqueue_wire(payload, client_id)
        self._clients.pop(client_id, None)

    def _enforce_connection_limit(self):
        limit = self.config.MAX_CONNECTED_CLIENTS_NUM
        while len(self._clients) > limit and self._order:
            victim = self._order.popleft()
            conn = self._clients.pop(victim, None)
            if conn is not None:
                logger.info("%s: evicting client %s (connection limit)",
                            self.name, victim)
                conn.close()

    def send_to_client(self, client_id: str, msg_dict: dict) -> bool:
        """Immediate single-frame send (scripts/net_diag echo; tests).
        Production replies go through queue_to_client — do not mix the
        two for one client in the same tick or replies can reorder
        relative to the queued batch."""
        conn = self._clients.get(client_id)
        if conn is None or not conn.alive:
            return False
        try:
            conn.send_frame(serializer.serialize(msg_dict))
            return True
        except Exception:
            conn.close()
            self._clients.pop(client_id, None)
            return False

    def queue_to_client(self, client_id: str, msg_dict: dict) -> bool:
        """Coalescing variant of send_to_client: the message rides the
        next flush_client_outboxes() as part of a BATCH envelope."""
        conn = self._clients.get(client_id)
        if conn is None or not conn.alive:
            return False
        self._outboxes.setdefault(client_id, []).append(
            serializer.serialize(msg_dict))
        return True

    def flush_client_outboxes(self) -> int:
        """One frame (or a few, under the size limit) per client per
        tick instead of one per message. Client batches are NOT signed —
        the AEAD channel already authenticates the node end-to-end
        (unlike node-stack batches, which peers re-verify by verkey).
        Packing rules (incl. the oversize-drop guard) come from
        pack_message_groups, shared with the node stack."""
        if not self._outboxes:
            return 0
        flushed = 0
        outboxes, self._outboxes = self._outboxes, {}
        for client_id, msgs in outboxes.items():
            conn = self._clients.get(client_id)
            if conn is None or not conn.alive:
                # reply loss under churn must be diagnosable
                logger.debug(
                    "%s: dropping %d queued repl(y/ies) for %s — "
                    "connection gone before flush", self.name, len(msgs),
                    client_id)
                continue
            try:
                for kind, val in pack_message_groups(
                        msgs, self.msg_len_limit - 512,
                        self.msg_len_limit, who=self.name):
                    if kind == 'raw' or len(val) == 1:
                        conn.send_frame(val if kind == 'raw' else val[0])
                    else:
                        conn.send_frame(serializer.serialize(
                            {OP_FIELD_NAME: BATCH_OP, "messages": val}))
                flushed += len(msgs)
            except Exception:
                logger.debug(
                    "%s: connection to %s died mid-flush — dropping its "
                    "%d-message outbox", self.name, client_id, len(msgs))
                conn.close()
                self._clients.pop(client_id, None)
        return flushed


class ClientConnection:
    """Dialing side for wallets/tests: anonymous encrypted channel to a
    node's client listener."""

    def __init__(self, ha: HA, expected_verkey: Optional[bytes] = None):
        self.ha = ha
        self._expected_vk = expected_verkey
        self.conn: Optional[Connection] = None
        self.rx: deque = deque()
        self._reader_task = None

    async def connect(self):
        reader, writer = await asyncio.open_connection(*self.ha)
        try:
            initiator = Initiator(None, expected_peer_vk=self._expected_vk)
            m2 = await _handshake_frames(reader, writer, True,
                                         payload=initiator.message1())
            m3 = initiator.consume_message2(m2)
            await _handshake_frames(reader, writer, False, payload=m3)
        except BaseException:
            # a failed handshake must not leak the socket
            writer.close()
            raise
        self.conn = Connection(reader, writer, initiator.session(), "client")
        self._reader_task = asyncio.get_event_loop().create_task(
            self._read_loop())

    async def _read_loop(self):
        while self.conn is not None and self.conn.alive:
            try:
                payload = await self.conn.read_frame(Config.MSG_LEN_LIMIT)
            except Exception:
                # oversize/corrupt frame or transport error: the link is
                # unusable — close it so owners polling conn.alive
                # (NetworkedPoolClient.pump) redial instead of hanging
                # on a dead reader task forever
                logger.info("client read loop failed; closing link",
                            exc_info=True)
                self.conn.close()
                break
            if payload is None:
                # peer went away: mark the link dead so owners polling
                # `conn.alive` (NetworkedPoolClient.pump) can redial
                self.conn.close()
                break
            try:
                msg = serializer.deserialize(payload)
                if isinstance(msg, dict) and \
                        msg.get(OP_FIELD_NAME) == BATCH_OP:
                    # coalesced node->client frame: unpack in order;
                    # one undecodable entry costs ONE message (same
                    # blast radius as un-coalesced frames), not the
                    # tail of the envelope
                    for raw in msg.get("messages", []):
                        try:
                            self.rx.append(serializer.deserialize(
                                raw if isinstance(raw, bytes)
                                else bytes(raw)))
                        except Exception:
                            logger.warning(
                                "undecodable entry in client batch "
                                "frame - skipped")
                else:
                    self.rx.append(msg)
            except Exception:
                pass

    def send(self, msg_dict: dict):
        self.conn.send_frame(serializer.serialize(msg_dict))

    def close(self):
        if self._reader_task is not None:
            self._reader_task.cancel()
        if self.conn is not None:
            self.conn.close()
