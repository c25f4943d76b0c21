"""The port's verify daemon (server/verify_daemon.py) and RemoteVerifier
(crypto/remote_verifier.py) in the shapes of tests/test_verify_daemon.py,
on the CPU: a round trip with tampered items, pipelined dispatches that
coalesce, the daemon dying mid-flight and coming back, a daemon that
starts after its client, and a garbage frame. The daemon runs in-process
with both backends: "cpu" (the scalar RFC 8032 check) and "torch_hub" on
device="cpu" (the ed25519 kernel's plain version), whose launches are
chunked at the bucket and whose small batches take the scalar floor. Its
frames are the JAX package's: a JAX RemoteVerifier talks to the port's
daemon and the port's to the JAX daemon."""
import asyncio
import socket
import struct

import pytest

from plenum_tpu.crypto.remote_verifier import RemoteVerifier as JaxRemote
from plenum_tpu.server.verify_daemon import VerifyDaemon as JaxDaemon
from plenum_tpu_torch.crypto import remote_verifier
from plenum_tpu_torch.crypto.batch_verifier import create_verifier
from plenum_tpu_torch.crypto.remote_verifier import RemoteVerifier
from plenum_tpu_torch.crypto.signer import SimpleSigner
from plenum_tpu_torch.server.verify_daemon import VerifyDaemon

BACKENDS = {"cpu": dict(backend="cpu"),
            "torch_hub": dict(backend="torch_hub", device="cpu", bucket=8,
                              cpu_floor=4)}


def make_items(n, tamper=()):
    signer = SimpleSigner(seed=b"\x77" * 32)
    items = []
    for i in range(n):
        msg = b"payload-%d" % i
        sig = bytes(64) if i in tamper else signer.sign_bytes(msg)
        items.append((msg, sig, signer.verraw))
    return items


def _run(body, window=0.001, **daemon_kw):
    async def main():
        daemon = VerifyDaemon(window=window, **daemon_kw)
        await daemon.start()
        loop = asyncio.get_running_loop()
        try:
            await body(daemon, loop)
        finally:
            await daemon.stop()
    asyncio.run(main())


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_remote_verifier_roundtrip(backend):
    async def body(daemon, loop):
        rv = await loop.run_in_executor(
            None, lambda: RemoteVerifier(("127.0.0.1", daemon.port)))
        results = await loop.run_in_executor(
            None, rv.verify_batch, make_items(20, tamper={3, 17}))
        assert results == [i not in (3, 17) for i in range(20)]
        stats = await loop.run_in_executor(None, rv.daemon_stats)
        assert stats["served"] == 20 and stats["batches"] == 1
        if backend == "torch_hub":     # 20 unique items in buckets of 8
            assert stats["hub_launches"] == [[8, 8], [8, 8], [4, 4]]
        again = await loop.run_in_executor(None, rv.daemon_stats)
        assert (again["served"], again["hub_launches"]) == (0, [])
        rv.close()
    _run(body, **BACKENDS[backend])


def test_small_batches_take_the_scalar_floor():
    async def body(daemon, loop):
        rv = await loop.run_in_executor(
            None, lambda: RemoteVerifier(("127.0.0.1", daemon.port)))
        assert await loop.run_in_executor(
            None, rv.verify_batch, make_items(3, tamper={0})) == \
            [False, True, True]
        stats = await loop.run_in_executor(None, rv.daemon_stats)
        assert stats["served"] == 3 and stats["hub_launches"] == []
        rv.close()
    _run(body, **BACKENDS["torch_hub"])


def test_remote_verifier_pipelined_dispatches_coalesce():
    async def body(daemon, loop):
        rv = await loop.run_in_executor(
            None, lambda: RemoteVerifier(("127.0.0.1", daemon.port)))

        def run():
            pendings = [rv.dispatch(make_items(6, tamper={i}))
                        for i in range(4)]
            return [p.collect() for p in pendings]
        for i, results in enumerate(await loop.run_in_executor(None, run)):
            assert results == [j != i for j in range(6)]
        p = await loop.run_in_executor(None, rv.dispatch, make_items(4))
        for _ in range(300):
            if p.ready():
                break
            await asyncio.sleep(0.01)
        assert p.ready() and p.collect() == [True] * 4
        stats = await loop.run_in_executor(None, rv.daemon_stats)
        assert stats["served"] == 28 and stats["batches"] <= 5
        rv.close()
    _run(body, window=0.05, **BACKENDS["torch_hub"])


def test_remote_verifier_survives_daemon_death():
    """In-flight batches resolve all-False (nodes nack, clients resubmit)
    and the next dispatch after the daemon returns reconnects; the node
    never verifies on its own."""
    async def main():
        daemon = VerifyDaemon(backend="cpu", window=0.001)
        await daemon.start()
        port = daemon.port
        loop = asyncio.get_running_loop()
        rv = await loop.run_in_executor(
            None, lambda: RemoteVerifier(("127.0.0.1", port), timeout=2.0))
        p = await loop.run_in_executor(None, rv.dispatch, make_items(5))
        await daemon.stop()
        for _ in range(100):
            if await loop.run_in_executor(None, p.ready):
                break
            await asyncio.sleep(0.02)
        assert p.ready() and p.collect() == [False] * 5
        daemon2 = VerifyDaemon(port=port, backend="cpu", window=0.001)
        await daemon2.start()
        await asyncio.sleep(remote_verifier.RECONNECT_COOLDOWN + 0.1)
        p2 = await loop.run_in_executor(None, rv.dispatch, make_items(3))
        assert await loop.run_in_executor(None, p2.collect) == [True] * 3
        rv.close()
        await daemon2.stop()
    asyncio.run(main())


def test_remote_verifier_tolerates_daemon_starting_late():
    async def main():
        loop = asyncio.get_running_loop()
        probe = socket.socket()
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
        probe.close()
        rv = await loop.run_in_executor(
            None, lambda: RemoteVerifier(("127.0.0.1", port), timeout=2.0))
        p = await loop.run_in_executor(None, rv.dispatch, make_items(2))
        assert await loop.run_in_executor(None, p.collect) == [False, False]
        daemon = VerifyDaemon(port=port, backend="cpu", window=0.001)
        await daemon.start()
        await asyncio.sleep(remote_verifier.RECONNECT_COOLDOWN + 0.1)
        assert await loop.run_in_executor(
            None, rv.verify_batch, make_items(4, tamper={2})) == \
            [True, True, False, True]
        rv.close()
        await daemon.stop()
    asyncio.run(main())


def test_daemon_survives_undecodable_frame():
    async def body(daemon, loop):
        sock = socket.socket()
        await loop.run_in_executor(None, sock.connect,
                                   ("127.0.0.1", daemon.port))
        junk = b"\xc1\xff\x00garbage-not-msgpack"
        await loop.run_in_executor(
            None, sock.sendall, struct.pack("<I", len(junk)) + junk)
        assert await loop.run_in_executor(None, sock.recv, 1) == b""
        sock.close()
        rv = await loop.run_in_executor(
            None, lambda: RemoteVerifier(("127.0.0.1", daemon.port)))
        assert await loop.run_in_executor(
            None, rv.verify_batch, make_items(3, tamper={1})) == \
            [True, False, True]
        rv.close()
    _run(body, backend="cpu")


def test_frames_are_the_jax_packages_both_ways():
    items = make_items(6, tamper={4})
    want = [i != 4 for i in range(6)]

    async def main():
        loop = asyncio.get_running_loop()
        for daemon, client in ((VerifyDaemon(backend="cpu", window=0.001),
                                JaxRemote),
                               (JaxDaemon(backend="cpu", window=0.001),
                                RemoteVerifier)):
            await daemon.start()
            rv = await loop.run_in_executor(
                None, lambda: client(("127.0.0.1", daemon.port)))
            assert await loop.run_in_executor(
                None, rv.verify_batch, items) == want
            rv.close()
            await daemon.stop()
    asyncio.run(main())


def test_create_verifier_makes_the_remote_provider():
    rv = create_verifier("remote", addr=("127.0.0.1", 1), timeout=0.2)
    assert isinstance(rv, RemoteVerifier)
    assert rv.verify_batch(make_items(2)) == [False, False]
    rv.close()
