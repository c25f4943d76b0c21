"""NetworkedNode — a consensus Node on real sockets.

Reference: plenum/server/node.py owns NodeZStack + ClientZStack and its
`prod` (node.py:1037) services stacks, replicas, timer, and flushes
outboxes every tick (§3.2). Here the same wiring is a thin Prodable
around the rung-2-tested Node core: inbound wire dicts are deserialized
through the message factory and fed to the node's ExternalBus; the
node's sends are serialized onto the NodeStack's per-remote outboxes and
flushed once per tick; client frames go to process_client_request and
replies back through the ClientStack.
"""
from __future__ import annotations

import logging
from typing import Dict, List, Optional

from plenum_tpu_torch.common.config import Config
from plenum_tpu_torch.common.messages.message_factory import node_message_factory
from plenum_tpu_torch.runtime.bus import ExternalBus
from plenum_tpu_torch.runtime.motor import Prodable
from plenum_tpu_torch.runtime.timer import QueueTimer
from plenum_tpu_torch.network.keys import NodeKeys
from plenum_tpu_torch.network.stack import (
    HA, ClientStack, NodeStack, RemoteInfo)
from plenum_tpu_torch.server.node import Node
from plenum_tpu_torch.utils.metrics import MetricsName

logger = logging.getLogger(__name__)


class NetworkedNode(Prodable):
    def __init__(self, name: str, registry: Dict[str, RemoteInfo],
                 keys: NodeKeys, node_ha: HA, client_ha: HA,
                 config: Optional[Config] = None,
                 timer: Optional[QueueTimer] = None,
                 storage_factory=None,
                 genesis_txns: Optional[List[dict]] = None,
                 metrics=None, info_dir: Optional[str] = None,
                 device=None):
        """`device` serves every kernel of the node (None means CUDA and
        raises without a card; "cpu" runs their plain versions)."""
        import time
        self._name = name
        self.config = config or Config()
        # wall-clock timer: ppTime/TimestampField expect epoch seconds
        self.timer = timer or QueueTimer(get_current_time=time.time)
        self.registry = dict(registry)

        self.nodestack = NodeStack(
            name, node_ha, keys, registry, self.config,
            on_connections_changed=self._on_conns_changed)
        self.clientstack = ClientStack(name + ".client", client_ha, keys,
                                       self.config)

        # the ExternalBus the consensus core sees; its send handler feeds
        # the stack outboxes
        self.bus = ExternalBus(send_handler=self._send_to_nodes)
        validators = sorted(registry)
        # BLS signer derived from the same seed the transport identity
        # uses — deterministic, so it matches the blskey the bootstrap
        # scripts put in the genesis NODE txn (bootstrap.py:58)
        bls_signer = None
        if getattr(self.config, "BLS_SIGN", True):
            from plenum_tpu_torch.crypto.bls import BlsCryptoSignerPlenum
            bls_signer, _ = BlsCryptoSignerPlenum.generate(keys.seed)
        self.node = Node(name, validators, self.timer, self.bus,
                         config=self.config,
                         storage_factory=storage_factory,
                         client_reply_handler=self._reply_to_client,
                         genesis_txns=genesis_txns,
                         bls_signer=bls_signer,
                         metrics=metrics, device=device)

        # periodic metrics flush + validator-info dump (reference
        # node.py: dump_additional_info / flush on prod)
        from plenum_tpu_torch.runtime.timer import RepeatingTimer

        def _guarded(label, fn):
            # a transient I/O error must neither crash the prod tick nor
            # kill the repeating timer
            def run():
                try:
                    fn()
                except Exception:
                    logger.warning("%s: %s failed", name, label,
                                   exc_info=True)
            return run

        if metrics is not None:
            RepeatingTimer(self.timer, self.config.METRICS_FLUSH_INTERVAL,
                           _guarded("metrics flush",
                                    metrics.flush_accumulated))
        self.info_tool = None
        if info_dir is not None:
            from plenum_tpu_torch.server.validator_info import (
                ValidatorNodeInfoTool)
            self.info_tool = ValidatorNodeInfoTool(self.node,
                                                   metrics=metrics)
            RepeatingTimer(
                self.timer, self.config.VALIDATOR_INFO_DUMP_INTERVAL,
                _guarded("validator-info dump",
                         lambda: self.info_tool.dump_json_file(info_dir)))

    # --------------------------------------------------------- tx glue

    def _send_to_nodes(self, message, dst=None):
        self.nodestack.send(message.to_dict(), dst)

    def _reply_to_client(self, client_id: str, msg):
        # queued: a committed batch's replies coalesce into per-client
        # BATCH frames at the end-of-tick flush
        self.clientstack.queue_to_client(client_id, msg.to_dict())

    def _on_conns_changed(self, connecteds):
        self.bus.update_connecteds(set(connecteds))

    # --------------------------------------------------------- rx glue

    def _on_node_wire_msg(self, msg_dict: dict, frm: str):
        try:
            msg = node_message_factory.get_instance(**msg_dict)
        except Exception as e:
            logger.warning("%s: invalid message from %s: %s",
                           self._name, frm, e)
            return
        self.bus.process_incoming(msg, frm)

    def _on_client_wire_msg(self, msg_dict: dict, client_id: str):
        self.node.process_client_request(msg_dict, client_id)

    # Batched client intake with deferred harvest: each tick's client
    # frames become ONE verifier dispatch (device batch / daemon frame);
    # the result is harvested on a later tick once it has landed, so the
    # verification round trip overlaps consensus work instead of
    # blocking the prod loop (same pipelining the in-process bench pool
    # gets from dispatch/conclude). While a batch is in flight, newly
    # arrived frames BUFFER (never a blocking conclude inside prod —
    # that would stall every consensus tick for a device round trip);
    # the buffered frames become the next, deeper dispatch.
    _pending_auth = None
    _pending_since = None
    _client_buf: list

    def _collect_client_msgs(self) -> int:
        import time as _time
        buf = self.__dict__.setdefault("_client_buf", [])
        count = self.clientstack.service(
            lambda d, cid: buf.append((d, cid)),
            quota=self.config.CLIENT_TO_NODE_STACK_QUOTA,
            size_quota=self.config.CLIENT_TO_NODE_STACK_SIZE)
        if self._pending_auth is not None:
            # liveness fallback: a wedged daemon/device must not buffer
            # forever — after the timeout, harvest blocking
            if _time.monotonic() - self._pending_since > \
                    self.config.CLIENT_AUTH_TIMEOUT:
                pending, self._pending_auth = self._pending_auth, None
                logger.warning("%s: verify batch fallback harvest after "
                            "%.1fs", self._name,
                            _time.monotonic() - self._pending_since)
                self.node.conclude_client_batch(pending)
            else:
                return count
        if buf:
            self._client_buf = []
            self._pending_auth = self.node.dispatch_client_batch(buf)
            self._pending_since = _time.monotonic()
            logger.debug("%s: dispatched verify batch of %d",
                        self._name, len(buf))
            # a coalescing provider (torch_hub) needs an explicit flush to
            # start its launch — in this process nothing else will
            self.node.authnr.flush()
        return count

    # -------------------------------------------------------- Prodable

    @property
    def name(self) -> str:
        return self._name

    def start(self, loop) -> None:
        loop.create_task(self.nodestack.start())
        loop.create_task(self.clientstack.start())

    async def start_async(self):
        await self.nodestack.start()
        await self.clientstack.start()

    def stop(self) -> None:
        import asyncio
        for stack in (self.nodestack, self.clientstack):
            try:
                asyncio.get_event_loop().create_task(stack.stop())
            except RuntimeError:
                pass

    async def prod(self, limit: int = None) -> int:
        """One tick (reference node.py:1037): rx quotas → consensus →
        timer → lifecycle → flush."""
        # harvest a landed verification batch before taking new work
        if self._pending_auth is not None and \
                self.node.client_batch_ready(self._pending_auth):
            import time as _time
            pending, self._pending_auth = self._pending_auth, None
            logger.debug("%s: verify batch landed after %.2fs", self._name,
                        _time.monotonic() - (self._pending_since or 0))
            self.node.conclude_client_batch(pending)
        metrics = self.node.metrics
        if self.nodestack.metrics is not metrics:
            self.nodestack.metrics = metrics
            self.clientstack.metrics = metrics
        with metrics.measure_time(MetricsName.NODE_RX_TIME):
            c = self.nodestack.service(
                self._on_node_wire_msg,
                quota=self.config.NODE_TO_NODE_STACK_QUOTA,
                size_quota=self.config.NODE_TO_NODE_STACK_SIZE)
        with metrics.measure_time(MetricsName.CLIENT_RX_TIME):
            c += self._collect_client_msgs()
        c += self.node.service()
        with metrics.measure_time(MetricsName.TIMER_SERVICE_TIME):
            c += self.timer.service()
        with metrics.measure_time(MetricsName.LIFECYCLE_TIME):
            self.nodestack.service_lifecycle()
        with metrics.measure_time(MetricsName.TRANSPORT_FLUSH_TIME):
            flushed = self.nodestack.flush_outboxes()
            self.clientstack.flush_client_outboxes()
        if flushed:
            metrics.add_event(MetricsName.TRANSPORT_BATCH_SIZE, flushed)
        return c
