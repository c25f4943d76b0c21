"""Ready-to-wire networked pool client: PoolClient over real sockets.

The reference delegates socket clients to the external SDK; this
framework ships one so `PoolClient` is usable against a live pool with
no manual transport assembly (README quick start). It dials every
node's client listener with the anonymous-encrypted `ClientConnection`
(network/stack.py), reconnects dropped links with backoff, feeds
inbound Replies into `PoolClient.receive`, and drives resubmission off
a wall-clock QueueTimer — the client-side mirror of the node's
keep-in-touch loop.

Async, single event loop, same cooperative style as NetworkedNode:
call `await client.start()`, then `await client.pump()` periodically
(or `run_until_confirmed`).
"""
from __future__ import annotations

import asyncio
import logging
import time
from typing import Dict, Optional, Sequence, Tuple

from plenum_tpu_torch.client.client import PoolClient
from plenum_tpu_torch.client.wallet import Wallet
from plenum_tpu_torch.network.crypto_channel import HandshakeError
from plenum_tpu_torch.network.stack import HA, ClientConnection
from plenum_tpu_torch.runtime.timer import QueueTimer

logger = logging.getLogger(__name__)


class NetworkedPoolClient:
    """PoolClient + one ClientConnection per node.

    node_addrs: name -> (HA, expected node verkey bytes or None).
    """

    RECONNECT_BACKOFF = 1.0

    def __init__(self, wallet: Wallet,
                 node_addrs: Dict[str, Tuple[HA, Optional[bytes]]],
                 timer: Optional[QueueTimer] = None,
                 resubmit_interval: float = 5.0):
        self.timer = timer or QueueTimer(get_current_time=time.time)
        self.node_addrs = dict(node_addrs)
        self._conns: Dict[str, ClientConnection] = {}
        self._next_dial: Dict[str, float] = {}
        self.pool = PoolClient(wallet, list(node_addrs), self._send,
                               timer=self.timer,
                               resubmit_interval=resubmit_interval)

    # ------------------------------------------------------------ wiring

    def _send(self, node_name: str, msg_dict: dict) -> None:
        conn = self._conns.get(node_name)
        if conn is None or conn.conn is None or not conn.conn.alive:
            # resubmission retries once the link is back
            logger.debug("client: %s not connected; dropping send",
                         node_name)
            return
        try:
            conn.send(msg_dict)
        except Exception:
            logger.info("client: send to %s failed; closing link",
                        node_name)
            conn.close()

    async def _dial(self, name: str) -> None:
        ha, verkey = self.node_addrs[name]
        conn = ClientConnection(ha, expected_verkey=verkey)
        try:
            await conn.connect()
        except (HandshakeError, ConnectionError, OSError,
                asyncio.TimeoutError, asyncio.IncompleteReadError) as e:
            # same failure set the node stacks' dial paths tolerate: a
            # down listener, a rotated verkey, or an accept-then-close
            # must cost one backoff, not fail the whole client
            logger.debug("client: dial %s failed: %s", name, e)
            self._next_dial[name] = time.monotonic() + \
                self.RECONNECT_BACKOFF
            return
        self._conns[name] = conn

    async def start(self) -> None:
        await asyncio.gather(*(self._dial(n) for n in self.node_addrs))

    async def stop(self) -> None:
        for conn in self._conns.values():
            conn.close()
        self._conns.clear()

    # ------------------------------------------------------------- pump

    async def pump(self) -> None:
        """One cooperative tick: drain inbound replies, heal links,
        fire timers (resubmission)."""
        for name, conn in list(self._conns.items()):
            while conn.rx:
                self.pool.receive(name, conn.rx.popleft())
            if conn.conn is None or not conn.conn.alive:
                self._conns.pop(name, None)
        now = time.monotonic()
        for name in self.node_addrs:
            if name not in self._conns and \
                    now >= self._next_dial.get(name, 0.0):
                await self._dial(name)
        self.timer.service()

    async def run_until_confirmed(self, req, timeout: float = 30.0):
        """Pump until `req` is confirmed (f+1 matching Replies) or
        `timeout` elapses; returns the confirmed result dict."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            await self.pump()
            if self.pool.is_confirmed(req):
                return self.pool.result_of(req)
            await asyncio.sleep(0.01)
        raise TimeoutError("request {} unconfirmed after {}s".format(
            (req.identifier, req.reqId), timeout))

    # ------------------------------------------------------- convenience

    def submit(self, operation: dict, **kwargs):
        return self.pool.submit(operation, **kwargs)
