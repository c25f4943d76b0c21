"""RemoteVerifier — batch-verification provider that offloads to the
verify daemon (server/verify_daemon.py) over a local socket.

Same dispatch()/collect() interface as the in-process providers
(crypto/batch_verifier.py), plus ready(): the node's prod loop polls it
so the daemon round trip (device launch + tunnel RTT) overlaps consensus
work instead of blocking a tick. The socket is plain blocking TCP used
non-blockingly for reads; frames are length-prefixed MessagePack in the
port's own codec (common/serializers/msgpack_codec.py; see the daemon's
protocol doc).
"""
from __future__ import annotations

import logging
import socket
import struct
import time
from typing import Dict, List, Sequence, Tuple

from plenum_tpu_torch.common.serializers.msgpack_codec import packb, unpackb

logger = logging.getLogger(__name__)

LEN = struct.Struct("<I")
# re-dial pacing: a dead daemon must not turn every dispatch into a
# blocking connect attempt on the prod loop
RECONNECT_COOLDOWN = 1.0
RECONNECT_TIMEOUT = 0.5

VerifyItem = Tuple[bytes, bytes, bytes]


class _RemotePending:
    def __init__(self, verifier: "RemoteVerifier", req_id: int, n: int):
        self._verifier = verifier
        self._req_id = req_id
        self._n = n

    def ready(self) -> bool:
        v = self._verifier
        if self._req_id in v._results or v._sock is None:
            return True
        v._pump(block=False)
        return self._req_id in v._results or v._sock is None

    def collect(self) -> List[bool]:
        v = self._verifier
        while self._req_id not in v._results:
            if v._sock is None:
                v._results.setdefault(self._req_id, b"")
                break
            # block until THIS request's frame lands — returning on just
            # any response would mis-handle out-of-order harvest when
            # more than one request is in flight
            v._pump(block=True, until=self._req_id)
        body = v._results.pop(self._req_id, b"")
        # a short body (daemon rejected the frame, or the link dropped
        # mid-request) fails the missing tail instead of crashing the
        # caller's result slicing
        return [i < len(body) and body[i] == 1 for i in range(self._n)]


class RemoteVerifier:
    """Failure policy: if the daemon drops or times out, every in-flight
    request resolves to all-False (the node nacks those client requests;
    clients resubmit) and the connection is re-dialed lazily on the next
    dispatch — a daemon restart must never take the node's prod loop
    down with an unhandled ConnectionError."""

    name = "remote"

    def __init__(self, addr: Tuple[str, int] = None, timeout: float = 30.0):
        self._addr = addr or ("127.0.0.1", 9999)
        self._timeout = timeout
        self._sock = None
        self._rx = b""
        self._results: Dict[int, bytes] = {}
        self._outstanding: Dict[int, int] = {}  # req_id -> item count
        self._next_id = 0
        self._last_dial_fail = 0.0
        # initial connect is best-effort: in multi-process deployments
        # the daemon may come up after the node (start-ordering race,
        # daemon restart); dispatch() re-dials lazily, so construction
        # must not hard-fail
        try:
            self._connect()
        except OSError as e:
            logger.warning(
                "verify daemon at %s:%d not reachable at construction "
                "(%s) — will re-dial on first dispatch", self._addr[0],
                self._addr[1], e)
            self._sock = None
            self._last_dial_fail = time.monotonic()

    def _connect(self, timeout: float = None):
        self._sock = socket.create_connection(
            self._addr, timeout=self._timeout if timeout is None
            else timeout)
        self._sock.settimeout(self._timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._rx = b""

    def _drop_link(self):
        """Fail all in-flight requests and discard the socket."""
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._sock = None
        for req_id in list(self._outstanding):
            self._results[req_id] = b""  # short body == all False
            del self._outstanding[req_id]

    def close(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    # -------------------------------------------------------- dispatch

    def dispatch(self, items: Sequence[VerifyItem]) -> _RemotePending:
        self._next_id += 1
        req_id = self._next_id
        frame = packb(
            [req_id, [[bytes(m), bytes(s), bytes(vk)]
                      for m, s, vk in items]])
        self._outstanding[req_id] = len(items)
        if self._sock is None and time.monotonic() - self._last_dial_fail \
                < RECONNECT_COOLDOWN:
            # paced re-dial: fail this batch WITHOUT touching the
            # cooldown clock — refreshing it here would push the expiry
            # forward on every dispatch and starve reconnection forever
            # under sustained traffic
            self._drop_link()
            return _RemotePending(self, req_id, len(items))
        try:
            if self._sock is None:
                # short-timeout re-dial: the prod loop must not block up
                # to self._timeout per intake batch while the daemon
                # host is black-holing SYNs
                self._connect(timeout=RECONNECT_TIMEOUT)
                logger.info("reconnected to verify daemon at %s:%d",
                            self._addr[0], self._addr[1])
            self._sock.sendall(LEN.pack(len(frame)) + frame)
        except OSError as e:
            if self._sock is None:
                self._last_dial_fail = time.monotonic()
                logger.warning("verify daemon at %s:%d unavailable (%s); "
                               "failing batch of %d", self._addr[0],
                               self._addr[1], e, len(items))
            else:
                logger.warning("verify daemon link lost (%s); failing "
                               "in-flight requests", e)
            self._drop_link()
        return _RemotePending(self, req_id, len(items))

    def verify_batch(self, items: Sequence[VerifyItem]) -> List[bool]:
        return self.dispatch(items).collect()

    def daemon_stats(self) -> dict:
        """The daemon's counters since the last call (server/
        verify_daemon.py's stats frame), which it then zeroes. Raises
        ConnectionError when the daemon cannot be reached."""
        import json
        if self._sock is None:
            self._connect(timeout=RECONNECT_TIMEOUT)
        self._next_id += 1
        req_id = self._next_id
        frame = packb([req_id, "stats"])
        self._outstanding[req_id] = 0
        self._sock.sendall(LEN.pack(len(frame)) + frame)
        self._pump(block=True, until=req_id)
        body = self._results.pop(req_id, b"")
        if not body:
            raise ConnectionError("verify daemon gave no stats")
        return json.loads(bytes(body).decode())

    # ------------------------------------------------------------- recv

    def _pump(self, block: bool, until: int = None):
        """Read frames. block=False drains whatever is buffered;
        block=True reads until the `until` req_id arrives (or, with no
        target, until anything does) or the timeout drops the link."""
        if self._sock is None:
            return  # dropped link already resolved everything to False
        self._sock.settimeout(self._timeout if block else 0.0)
        try:
            while True:
                chunk = self._sock.recv(1 << 20)
                if not chunk:
                    raise ConnectionError("verify daemon closed")
                self._rx += chunk
                self._drain_frames()
                if block and (until in self._results if until is not None
                              else bool(self._results)):
                    return
        except (BlockingIOError, socket.timeout):
            if block:
                self._drop_link()
        except (ConnectionError, OSError):
            self._drop_link()
        finally:
            if self._sock is not None:
                self._sock.settimeout(self._timeout)

    def _drain_frames(self):
        while len(self._rx) >= 4:
            (n,) = LEN.unpack(self._rx[:4])
            if len(self._rx) < 4 + n:
                return
            req_id, body = unpackb(self._rx[4:4 + n])
            self._rx = self._rx[4 + n:]
            self._results[req_id] = body
            self._outstanding.pop(req_id, None)
