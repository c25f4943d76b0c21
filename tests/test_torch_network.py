"""The port's transport (network/keys.py, crypto_channel.py, stack.py on
crypto/pure_channel_crypto.py and the port's MessagePack codec) in the
shapes of tests/test_network_stack.py: the SIGMA handshake's mutual
authentication and rejections, a two-node mesh that connects, delivers,
coalesces signed batches, reconnects after a restart and bounds its
receive quota. Each stack shape runs port↔port and, mixed, port↔JAX in
both directions, as does a client connection: the two packages speak the
same bytes."""
import asyncio
import types

import pytest

from plenum_tpu.common.config import Config as JaxConfig
from plenum_tpu.network import keys as jkeys
from plenum_tpu.network import stack as jstack
from plenum_tpu.network.crypto_channel import Responder as JaxResponder
from plenum_tpu_torch.common.config import Config
from plenum_tpu_torch.network import keys as pkeys
from plenum_tpu_torch.network import stack as pstack
from plenum_tpu_torch.network.crypto_channel import (
    HandshakeError, Initiator, Responder)
from plenum_tpu_torch.network.keys import NodeKeys

PORT = types.SimpleNamespace(keys=pkeys, stack=pstack, Config=Config)
JAX = types.SimpleNamespace(keys=jkeys, stack=jstack, Config=JaxConfig)
SIDES = {"port-port": (PORT, PORT), "port-jax": (PORT, JAX),
         "jax-port": (JAX, PORT)}
NAMES = ["Alpha", "Beta"]


# ------------------------------------------------------ handshake (sans-IO)

def test_handshake_mutual_auth_and_traffic():
    ka, kb = NodeKeys(b"\x01" * 32), NodeKeys(b"\x02" * 32)
    init = Initiator(ka.sk, expected_peer_vk=kb.verkey_raw)
    resp = Responder(kb.sk, allowed_vks={ka.verkey_raw})
    m2 = resp.consume_message1(init.message1())
    resp.consume_message3(init.consume_message2(m2))
    si, sr = init.session(), resp.session()
    assert sr.peer_verkey == ka.verkey_raw
    assert sr.decrypt(si.encrypt(b"hello consensus")) == b"hello consensus"
    assert si.decrypt(sr.encrypt(b"reply" * 100)) == b"reply" * 100


def test_handshake_with_the_jax_package_both_ways():
    ka, kb = NodeKeys(b"\x01" * 32), jkeys.NodeKeys(b"\x02" * 32)
    init = Initiator(ka.sk, expected_peer_vk=kb.verkey_raw)
    resp = JaxResponder(kb.sk, allowed_vks={ka.verkey_raw})
    m2 = resp.consume_message1(init.message1())
    resp.consume_message3(init.consume_message2(m2))
    si, sr = init.session(), resp.session()
    for n in (0, 1, 63, 64, 65, 600, 5000):
        msg = bytes(range(256)) * (n // 256) + bytes(n % 256)
        assert sr.decrypt(si.encrypt(msg)) == msg
        assert si.decrypt(sr.encrypt(msg)) == msg


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 447, 448, 449, 4097])
def test_aead_equals_the_jax_packages_pure_copy(n):
    """The port's ChaCha20-Poly1305 against the JAX package's copy on the
    same key, nonce, data and associated data, on both sides of each
    64-byte block boundary."""
    from plenum_tpu.crypto.pure_channel_crypto import (
        ChaCha20Poly1305 as JaxAead)
    from plenum_tpu_torch.crypto.pure_channel_crypto import ChaCha20Poly1305
    key, nonce = bytes(range(32)), bytes(range(7, 19))
    data, aad = bytes(i * 7 % 256 for i in range(n)), b"aad" * (n % 5)
    sealed = ChaCha20Poly1305(key).encrypt(nonce, data, aad)
    assert sealed == JaxAead(key).encrypt(nonce, data, aad)
    assert ChaCha20Poly1305(key).decrypt(nonce, sealed, aad) == data


@pytest.mark.parametrize("counter", [0, 1, 0xFFFFFFFF])
@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 4097])
def test_c_keystream_equals_the_python_loop(n, counter):
    """csrc/chacha20.c, which the channel cipher runs once it is built,
    against the Python keystream it replaces, across block boundaries
    and the 32-bit block counter's wrap."""
    from plenum_tpu_torch.crypto import pure_channel_crypto as pc
    native = pc._load_native_xor()
    assert native is not None
    key, nonce = bytes(range(3, 35)), bytes(range(12))
    data = bytes(i * 13 % 256 for i in range(n))
    assert native(key, counter, nonce, data) == \
        pc._chacha20_xor(key, counter, nonce, data)
    with pytest.raises(ValueError):
        native(key[:31], counter, nonce, data)


def test_cipher_runs_the_python_keystream_when_the_c_does_not_build(
        monkeypatch):
    import subprocess

    from plenum_tpu.crypto.pure_channel_crypto import (
        ChaCha20Poly1305 as JaxAead)
    from plenum_tpu_torch.crypto import pure_channel_crypto as pc
    from plenum_tpu_torch.ops import cuda_lib

    def no_compiler(name):
        raise subprocess.CalledProcessError(1, ["cc"])

    monkeypatch.setattr(cuda_lib, "load_host", no_compiler)
    monkeypatch.setattr(pc, "_xor_impl", None)
    key, nonce, data = bytes(range(32)), bytes(12), bytes(range(200))
    sealed = pc.ChaCha20Poly1305(key).encrypt(nonce, data, b"a")
    assert pc._xor_impl is pc._chacha20_xor
    assert sealed == JaxAead(key).encrypt(nonce, data, b"a")


def test_keys_equal_the_jax_packages():
    for seed in (b"\x01" * 32, b"\x7f" * 32):
        k, j = NodeKeys(seed), jkeys.NodeKeys(seed)
        assert (k.verkey_raw, k.verkey, k.sign(b"m")) == \
            (j.verkey_raw, j.verkey, j.sign(b"m"))


@pytest.mark.parametrize("case", ["unknown_initiator", "wrong_responder",
                                  "anonymous_refused"])
def test_handshake_rejections(case):
    ka, kb, kc = (NodeKeys(bytes([i]) * 32) for i in (1, 2, 3))
    if case == "unknown_initiator":
        init = Initiator(kc.sk, expected_peer_vk=kb.verkey_raw)
        resp = Responder(kb.sk, allowed_vks={ka.verkey_raw})
    elif case == "wrong_responder":
        init = Initiator(ka.sk, expected_peer_vk=kb.verkey_raw)
        resp = Responder(kc.sk, allowed_vks=None)
        with pytest.raises(HandshakeError):
            init.consume_message2(resp.consume_message1(init.message1()))
        return
    else:
        init = Initiator(None, expected_peer_vk=kb.verkey_raw)
        resp = Responder(kb.sk, allowed_vks={ka.verkey_raw},
                         allow_anonymous=False)
    m3 = init.consume_message2(resp.consume_message1(init.message1()))
    with pytest.raises(HandshakeError):
        resp.consume_message3(m3)


def test_anonymous_initiator_where_allowed():
    kb = NodeKeys(b"\x02" * 32)
    init = Initiator(None, expected_peer_vk=kb.verkey_raw)
    resp = Responder(kb.sk, allow_anonymous=True)
    resp.consume_message3(init.consume_message2(
        resp.consume_message1(init.message1())))
    assert resp.session().peer_verkey is None


# ------------------------------------------------------------ the stacks

async def _mesh(sides):
    keys = {n: side.keys.NodeKeys(bytes([i + 10]) * 32)
            for i, (n, side) in enumerate(zip(NAMES, sides))}
    stacks, registry = {}, {}
    for name, side in zip(NAMES, sides):
        stacks[name] = side.stack.NodeStack(
            name, side.stack.HA("127.0.0.1", 0), keys[name], {},
            side.Config())
        await stacks[name].start()
        registry[name] = (stacks[name].ha, keys[name].verkey_raw)
    for (name, stack), side in zip(stacks.items(), sides):
        for other, (ha, vk) in registry.items():
            if other != name:
                stack.add_remote(side.stack.RemoteInfo(
                    other, side.stack.HA(*ha), vk))
    return stacks, keys, registry


async def _pump(stacks, seconds, until):
    end = asyncio.get_running_loop().time() + seconds
    while asyncio.get_running_loop().time() < end:
        for s in stacks.values():
            s.service_lifecycle()
            s.flush_outboxes()
        if until():
            return True
        await asyncio.sleep(0.02)
    return until()


async def _connected(stacks):
    a, b = stacks["Alpha"], stacks["Beta"]
    assert await _pump(stacks, 8, lambda: a.connecteds == {"Beta"}
                       and b.connecteds == {"Alpha"})


@pytest.mark.parametrize("sides", sorted(SIDES))
def test_stack_delivers_and_coalesces_signed_batches(sides):
    async def main():
        stacks, _, _ = await _mesh(SIDES[sides])
        await _connected(stacks)
        a, b = stacks["Alpha"], stacks["Beta"]
        a.send({"op": "TEST", "x": 1}, "Beta")
        for i in range(50):             # one tick's outbox: one batch
            a.send({"op": "TEST", "i": i}, "Beta")
        got = []
        await _pump(stacks, 8, lambda: b.service(
            lambda m, f: got.append((m, f))) and False or len(got) == 51)
        assert got[0] == ({"op": "TEST", "x": 1}, "Alpha")
        assert [m["i"] for m, _ in got[1:]] == list(range(50))
        b.send({"op": "TEST", "back": True}, "Alpha")
        back = []
        await _pump(stacks, 8, lambda: a.service(
            lambda m, f: back.append((m, f))) or back)
        assert back == [({"op": "TEST", "back": True}, "Beta")]
        for s in stacks.values():
            await s.stop()
    asyncio.run(main())


@pytest.mark.parametrize("sides", ["port-port", "jax-port"])
def test_stack_reconnects_after_peer_restart(sides):
    async def main():
        stacks, keys, registry = await _mesh(SIDES[sides])
        await _connected(stacks)
        a, b = stacks["Alpha"], stacks["Beta"]
        await b.stop()
        for r in a.remotes.values():
            r.disconnect()
        await _pump({"Alpha": a}, 0.3, lambda: False)
        assert a.connecteds == set()
        side = SIDES[sides][1]
        b2 = side.stack.NodeStack("Beta", side.stack.HA(*registry["Beta"][0]),
                                  keys["Beta"], {}, side.Config())
        b2.add_remote(side.stack.RemoteInfo(
            "Alpha", side.stack.HA(*registry["Alpha"][0]),
            registry["Alpha"][1]))
        await b2.start()
        stacks2 = {"Alpha": a, "Beta": b2}
        assert await _pump(stacks2, 8, lambda: a.connecteds == {"Beta"})
        a.send({"op": "TEST", "x": 2}, "Beta")
        got = []
        await _pump(stacks2, 8, lambda: b2.service(
            lambda m, f: got.append(m)) or got)
        assert got and got[0]["x"] == 2
        await a.stop()
        await b2.stop()
    asyncio.run(main())


def test_rx_quota_bounds_service():
    async def main():
        stacks, _, _ = await _mesh(SIDES["port-port"])
        await _connected(stacks)
        a, b = stacks["Alpha"], stacks["Beta"]
        for i in range(30):
            a.send({"op": "TEST", "i": i}, "Beta")
        await _pump(stacks, 8, lambda: len(b.rx) == 30)
        got = []
        assert b.service(lambda m, f: got.append(m), quota=10) == 10
        assert len(b.rx) == 20
        for s in stacks.values():
            await s.stop()
    asyncio.run(main())


@pytest.mark.parametrize("sides", sorted(SIDES))
def test_client_connection_round_trip(sides):
    """A client connection of one package to a client stack of the other
    (or the same): a request in, a coalesced reply batch out."""
    client_side, node_side = SIDES[sides]

    async def main():
        keys = node_side.keys.NodeKeys(b"\x21" * 32)
        stack = node_side.stack.ClientStack(
            "Alpha.client", node_side.stack.HA("127.0.0.1", 0), keys,
            node_side.Config())
        await stack.start()
        conn = client_side.stack.ClientConnection(
            client_side.stack.HA(*stack.ha),
            expected_verkey=keys.verkey_raw)
        await conn.connect()
        conn.send({"op": "REQUEST", "reqId": 7, "blob": b"\x00\xff" * 300})
        got = []
        end = asyncio.get_running_loop().time() + 8
        while not got and asyncio.get_running_loop().time() < end:
            stack.service(lambda m, cid: got.append((m, cid)))
            await asyncio.sleep(0.02)
        (msg, cid), = got
        assert msg == {"op": "REQUEST", "reqId": 7, "blob": b"\x00\xff" * 300}
        for i in range(3):
            stack.queue_to_client(cid, {"op": "REPLY", "i": i})
        stack.flush_client_outboxes()
        while len(conn.rx) < 3 and asyncio.get_running_loop().time() < end:
            await asyncio.sleep(0.02)
        assert [m["i"] for m in conn.rx] == [0, 1, 2]
        conn.close()
        await stack.stop()
    asyncio.run(main())
