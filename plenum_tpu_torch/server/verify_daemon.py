"""Verification daemon — one process verifies the client signatures of
every node process on the host, with the ed25519 kernel on the card.

Deployment shape for multi-process pools on one host (port of the JAX
package's server/verify_daemon.py). The daemon plays the role the
CoalescingVerifierHub plays inside a single process
(crypto/batch_verifier.py): requests from all connected nodes are
coalesced within a small window, deduplicated (every node verifies the
same client requests) and verified in fused launches; results are
scattered back per request.

Pipelining: the verification runs on a worker thread while the asyncio
loop keeps reading frames, so batch k+1 accumulates during batch k's
device round trip.

Wire protocol (both directions): 4-byte little-endian length prefix +
MessagePack payload (the port's own codec,
common/serializers/msgpack_codec.py, byte-equal to the `msgpack` package's
output, so the JAX package's RemoteVerifier speaks to this daemon too).
  request : [req_id, [[msg, sig, vk], ...]]
  response: [req_id, results_bytes]   (one 0/1 byte per item)
  stats   : [req_id, "stats"] → [req_id, JSON bytes] with the daemon's
            counters since the last stats request (verified items, fused
            batches, the hub's launches with their sizes, and this
            process's kernel launches, `ops.launch_counts`), which it then
            zeroes.

Backends: "torch_hub" (a CoalescingVerifierHub on `device`, the JAX
package's "adaptive") and "cpu" (the scalar RFC 8032 check, the JAX
package's OpenSSL "cpu"). Fused batches below `cpu_floor` items take the
scalar check (the hub's threshold); larger ones are chunked to at most
`bucket` items, one launch each, or bucket × the mesh's devices when such
a chunk clears the mesh gate (ops/mesh.py: the chunk then splits over the
devices, one launch each). The JAX package's XLA compile cache and its
padding of the tail chunk (one compiled shape for XLA) have no
counterpart here.

The daemon applies its config's MESH_* keys to the process's mesh
(configure_from), as a node does; the JAX package's daemon never does,
so its mesh keeps the Config class defaults (ROADMAP C).

Reference equivalence: the reference verifies inline through libsodium
(plenum/server/client_authn.py:84); this daemon is the device-native
replacement for that native-library seam at multi-process scale.
"""
from __future__ import annotations

import asyncio
import json
import logging
import os
import struct
from concurrent.futures import ThreadPoolExecutor
from typing import List, Tuple

from plenum_tpu_torch.common.serializers.msgpack_codec import packb, unpackb
from plenum_tpu_torch.observability.tracing import CAT_DEVICE, NullTracer

logger = logging.getLogger(__name__)

LEN = struct.Struct("<I")
MAX_FRAME = 64 * 1024 * 1024
# per-connection response backlog past which the peer is declared stalled
# and dropped: the daemon serves every node on the host, so one wedged
# reader must not buffer the others' memory away
WRITE_HIGH_WATER = 8 * 1024 * 1024
STATS = "stats"
BACKENDS = ("torch_hub", "cpu")


class VerifyDaemon:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 backend: str = "torch_hub", window: float = None,
                 bucket: int = None, cpu_floor: int = None, config=None,
                 device=None):
        """bucket: device launches are chunked to at most this many items.
        cpu_floor: fused batches below this take the scalar check (a
        near-empty device launch costs more than scalar verification).
        Both only apply to backend "torch_hub"; backend="cpu" verifies
        directly. None takes config's VERIFY_DAEMON_* values (the class
        defaults when no config is given); explicit args win. The worker
        pool is sized from config's PIPELINE_WORKERS (the JAX package
        reads the Config class there; ROADMAP C). `device` serves
        "torch_hub": None means CUDA and raises without a card."""
        from plenum_tpu_torch.common.config import Config
        from plenum_tpu_torch.crypto.batch_verifier import create_verifier
        if backend not in BACKENDS:
            raise ValueError("unknown daemon backend {!r}; one of {}".format(
                backend, BACKENDS))
        config = config or Config()
        self.host = host
        self.port = port
        self._backend_name = backend
        self._bucket = config.VERIFY_DAEMON_BUCKET \
            if bucket is None else bucket
        self._cpu_floor = config.VERIFY_DAEMON_CPU_FLOOR \
            if cpu_floor is None else cpu_floor
        self._window = config.VERIFY_DAEMON_WINDOW \
            if window is None else window
        self.device = None
        kwargs = {}
        if backend == "torch_hub":
            from plenum_tpu_torch.ops import resolve_device
            self.device = resolve_device(device)
            kwargs = {"device": self.device, "threshold": self._cpu_floor}
        self._verifier = create_verifier(backend, **kwargs)
        from plenum_tpu_torch.ops import mesh as mesh_mod
        mesh_mod.configure_from(config)
        self._queue: asyncio.Queue = asyncio.Queue()
        # the FALLBACK is 1, not the node pipeline's cores−1 auto: device
        # launches serialize anyway, and a busy worker is exactly what
        # lets the NEXT batch coalesce deeper — only an explicit
        # PIPELINE_WORKERS raises it
        from plenum_tpu_torch.runtime.pipeline import resolve_workers
        self.workers = resolve_workers(
            getattr(config, "PIPELINE_WORKERS", None), fallback=1)
        self._pool = ThreadPoolExecutor(max_workers=self.workers)
        self._server = None
        self._batcher_task = None
        self._writers = set()
        self.served = 0
        self.launches = 0
        # flight recorder: the daemon runs in its own process, so it
        # gets its own tracer (attach a real one + trace_file to dump
        # Perfetto timelines of coalescing vs device round trips)
        self.tracer = NullTracer("verify-daemon")
        self.trace_file = None

    async def start(self):
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._batcher_task = asyncio.get_running_loop().create_task(
            self._batcher())
        logger.info("verify daemon listening on %s:%d", self.host, self.port)

    async def stop(self):
        # cancel the batcher FIRST: left running past shutdown it would
        # keep consuming frames that buffered before the connections die
        # below, answering them all-False through the shut-down pool —
        # and a restarted daemon on the same port never sees them
        if self._batcher_task is not None:
            self._batcher_task.cancel()
            try:
                await self._batcher_task
            except (asyncio.CancelledError, Exception):
                pass
            self._batcher_task = None
        if self._server is not None:
            self._server.close()
            # abort (RST), don't close (FIN-after-flush), live node
            # connections: a graceful close can deliver a final reply
            # ahead of the FIN, so the client keeps dispatching into the
            # dead link instead of re-dialing the restarted daemon.
            # Also required for 3.12's wait_closed(), which waits for
            # EVERY client connection, not just the listener.
            for w in list(self._writers):
                try:
                    w.transport.abort()
                except Exception:
                    pass
            await self._server.wait_closed()
        self._pool.shutdown(wait=False)
        self._dump_trace()

    def _dump_trace(self):
        if self.trace_file is None or not getattr(
                self.tracer, "enabled", False):
            return
        try:
            from plenum_tpu_torch.observability.export import (
                export_chrome_trace)
            export_chrome_trace([self.tracer], self.trace_file)
        except Exception:
            logger.warning("trace dump failed", exc_info=True)

    def stats(self, reset: bool = False) -> dict:
        """Counters since the last reset: verified items, fused batches,
        the hub's launches [(unique items, lanes)] and this process's
        kernel launches."""
        from plenum_tpu_torch.ops import launch_counts
        hub_launches = getattr(self._verifier, "launches", [])
        out = {"backend": self._backend_name, "served": self.served,
               "batches": self.launches,
               "hub_launches": [list(x) for x in hub_launches],
               "kernels": launch_counts(reset=reset),
               "pid": os.getpid()}
        if reset:
            self.served = self.launches = 0
            del hub_launches[:]
        return out

    # ------------------------------------------------------------ conns

    def _verify_bucketed(self, items):
        """Chunk to at most `bucket` items and dispatch every chunk FIRST
        (one hub generation, so one launch, each) so the launches
        pipeline through the device queue, then collect."""
        if self._backend_name == "cpu" or self._bucket <= 0 \
                or len(items) < self._cpu_floor:
            return self._verifier.verify_batch(items)
        b = self._bucket
        from plenum_tpu_torch.ops.mesh import get_mesh
        mesh = get_mesh()
        if mesh.should_shard(b * mesh.n_devices, self.device):
            # one fused launch spans every device, but only where the
            # scaled launch clears the gate: otherwise it would take the
            # passthrough path at a larger size for no mesh benefit
            b *= mesh.n_devices
        chunks = [items[i:i + b] for i in range(0, len(items), b)]
        # daemon-seam lane accounting + round trip: this method runs on
        # the worker thread start-to-finish, so the wall time here IS the
        # fused dispatch→collect round trip
        from plenum_tpu_torch.observability import telemetry as tmy
        tm_hub = tmy.get_seam_hub()
        first_call = tm_hub.record_launch(
            tmy.SEAM_DAEMON, len(items), len(items), shape=b)
        t0 = tm_hub.clock()
        pendings = []
        for c in chunks:
            pendings.append(self._verifier.dispatch(c))
            self._verifier.flush()
        out = []
        for p in pendings:
            out.extend(p.collect())
        tm_hub.record_roundtrip(tmy.SEAM_DAEMON,
                                (tm_hub.clock() - t0) * 1e3,
                                first_call=first_call)
        return out

    def _write(self, writer, frame: bytes) -> None:
        try:
            if writer.transport.is_closing():
                return
            writer.write(LEN.pack(len(frame)) + frame)
            # bounded buffering without stalling the batcher on one slow
            # peer: a connection whose response backlog passes the
            # high-water mark is aborted (abort, not close — close would
            # keep the backlog alive trying to flush it to the stalled
            # reader). Its node fails in-flight requests to all-False and
            # re-dials — see RemoteVerifier's failure policy.
            if writer.transport.get_write_buffer_size() \
                    > WRITE_HIGH_WATER:
                logger.warning(
                    "dropping stalled verify client (write backlog %d "
                    "bytes)", writer.transport.get_write_buffer_size())
                self._writers.discard(writer)
                writer.transport.abort()
        except Exception:
            pass

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter):
        self._writers.add(writer)
        try:
            while True:
                hdr = await reader.readexactly(4)
                (n,) = LEN.unpack(hdr)
                if n > MAX_FRAME:
                    logger.warning("oversized frame (%d); closing", n)
                    break
                payload = await reader.readexactly(n)
                try:
                    req_id, items = unpackb(payload)
                except (ValueError, TypeError, IndexError, KeyError):
                    # garbage frame: close THIS connection cleanly; an
                    # escaped decode error would kill the reader task
                    # with an unretrieved-exception warning instead
                    logger.warning("undecodable frame; closing",
                                   exc_info=True)
                    break
                if items == STATS:
                    # read-and-reset, answered at once: every frame
                    # queued before it has been answered only if the
                    # caller waited for its replies, as RemoteVerifier's
                    # collect does
                    self._write(writer, packb([req_id, json.dumps(
                        self.stats(reset=True)).encode()]))
                    continue
                await self._queue.put((writer, req_id, items))
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            self._writers.discard(writer)
            try:
                writer.close()
            except Exception:
                pass

    # ---------------------------------------------------------- batching

    async def _batcher(self):
        loop = asyncio.get_running_loop()
        while True:
            first = await self._queue.get()
            batch = [first]
            # event-driven coalescing: sleep exactly until the next frame
            # or the window deadline — a polling loop would burn the CPU
            # the node processes need
            with self.tracer.span("coalesce", CAT_DEVICE) as _csp:
                deadline = loop.time() + self._window
                while True:
                    remaining = deadline - loop.time()
                    if remaining <= 0:
                        break
                    try:
                        batch.append(await asyncio.wait_for(
                            self._queue.get(), remaining))
                    except asyncio.TimeoutError:
                        break
                _csp.add(requests=len(batch))
            self.tracer.counter("verify_queue_depth", self._queue.qsize())
            all_items: List[Tuple[bytes, bytes, bytes]] = []
            spans = []
            for _, _, items in batch:
                lo = len(all_items)
                try:
                    all_items.extend(
                        (bytes(m), bytes(s), bytes(vk))
                        for m, s, vk in items)
                except Exception:
                    # malformed frame from one client: answer all-False
                    # for ITS span; the batcher must survive (it serves
                    # every node on the host)
                    del all_items[lo:]
                    logger.warning("malformed verify request", exc_info=True)
                spans.append((lo, len(all_items) - lo))
            # dedup byte-identical items across nodes: every node on the
            # host verifies the SAME client requests, so n connected
            # nodes would otherwise cost n× the device work per request
            from plenum_tpu_torch.crypto.batch_verifier import dedup_items
            order, index = dedup_items(all_items)
            t_launch = loop.time()
            logger.debug("batch: %d items (%d unique) from %d requests",
                         len(all_items), len(order), len(batch))
            try:
                # this span IS the device round trip as the loop sees it
                # (the worker thread serializes launches, so a deep span
                # here means the NEXT batch coalesced under it)
                with self.tracer.span("device_verify", CAT_DEVICE,
                                      items=len(all_items),
                                      unique=len(order),
                                      requests=len(batch)):
                    uniq_results = await loop.run_in_executor(
                        self._pool, self._verify_bucketed, order)
                results = [uniq_results[i] for i in index]
            except Exception:  # plenum-lint: disable=PT006 — the daemon
                # serves every node on the host: ANY backend failure
                # must answer all-False (the nodes nack those requests,
                # the traceback is logged) and keep the batcher alive
                logger.warning("verify batch failed", exc_info=True)
                results = [False] * len(all_items)
            logger.debug("batch done in %.2fs", loop.time() - t_launch)
            self.served += len(all_items)
            self.launches += 1
            for (writer, req_id, _), (lo, cnt) in zip(batch, spans):
                body = bytes(bytearray(
                    1 if results[lo + i] else 0 for i in range(cnt)))
                self._write(writer, packb([req_id, body]))
            if self.trace_file is not None and self.launches % 25 == 0:
                # periodic (SIGTERM skips stop()), AFTER the replies are
                # written and on a side thread
                await loop.run_in_executor(None, self._dump_trace)


async def run_daemon(host="127.0.0.1", port=0, backend="torch_hub",
                     ready_file=None, window: float = None,
                     bucket: int = None, cpu_floor: int = None,
                     trace_file=None, config=None, device=None):
    """Serve until SIGTERM (then stop cleanly) or cancellation."""
    import signal
    daemon = VerifyDaemon(host, port, backend, window=window,
                          bucket=bucket, cpu_floor=cpu_floor, config=config,
                          device=device)
    if trace_file:
        from plenum_tpu_torch.observability.tracing import Tracer
        daemon.tracer = Tracer("verify-daemon")
        daemon.trace_file = trace_file
    dev = daemon.device
    if dev is not None and dev.type == "cuda":
        # load the kernel's library and bring up the CUDA context now,
        # before the ready file, so the first batch pays neither
        import torch
        from plenum_tpu_torch.ops import cuda_lib
        cuda_lib.load("ed25519_verify")
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
    await daemon.start()
    if ready_file:
        # one-shot startup handshake before any frame is served — not a
        # hot-loop write
        tmp = ready_file + ".tmp"
        with open(tmp, "w") as f:  # plenum-lint: disable=PT001
            f.write(str(daemon.port))
        os.replace(tmp, ready_file)
    stop = asyncio.Event()
    asyncio.get_running_loop().add_signal_handler(signal.SIGTERM, stop.set)
    try:
        await stop.wait()
    finally:
        await daemon.stop()


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--backend", default="torch_hub", choices=BACKENDS)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where torch_hub verifies (default: the card)")
    ap.add_argument("--base-dir", default=None,
                    help="read plenum_tpu_config.py (and PLENUM_TPU_* "
                         "env vars) for the VERIFY_DAEMON_* and "
                         "PIPELINE_WORKERS values")
    ap.add_argument("--window", type=float, default=None,
                    help="coalescing window s (default: "
                         "VERIFY_DAEMON_WINDOW)")
    ap.add_argument("--bucket", type=int, default=None,
                    help="largest launch (default: VERIFY_DAEMON_BUCKET)")
    ap.add_argument("--cpu-floor", type=int, default=None,
                    help="scalar floor (default: VERIFY_DAEMON_CPU_FLOOR)")
    ap.add_argument("--ready-file", default=None,
                    help="write the bound port here once listening")
    ap.add_argument("--trace-file", default=None,
                    help="record coalesce/device spans and dump a "
                         "Chrome trace-event JSON here (periodically "
                         "and on clean stop)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from plenum_tpu_torch.common.config import Config
    asyncio.run(run_daemon(args.host, args.port, args.backend,
                           args.ready_file, args.window, args.bucket,
                           args.cpu_floor, trace_file=args.trace_file,
                           config=Config.load(args.base_dir),
                           device=args.device))


if __name__ == "__main__":
    main()
