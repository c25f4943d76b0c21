"""The port's NetworkedPoolClient (client/network_client.py) against the
JAX package's, the shape of tests/test_network_client.py: a live 4-node
socket pool of the port's NetworkedNodes (device="cpu"), one node's
client listener down at dial time. The client starts with three links,
confirms a write on f + 1 matching replies, redials the fourth link once
its listener is back, and heals a killed link. The same signed requests
sent by the JAX package's client to a JAX pool of the same keys confirm
at the same seqNos with the same txns (their times aside).
Tolerance: none."""
import asyncio

import pytest

from tests.torch_two_packages import JAX, NAMES, PORT, jax_warm_off, node_kw, \
    pkg

N_WRITES = 3


def _classes(name):
    import importlib
    mod = lambda m: importlib.import_module(name + "." + m)  # noqa: E731
    client = mod("client")
    return (client.NetworkedPoolClient, client.Wallet,
            mod("network.keys").NodeKeys, mod("network.stack"),
            mod("server.networked_node").NetworkedNode,
            mod("common.request").Request)


def _run(name):
    """The JAX test's pool and client, for package `name`, with N_WRITES
    writes of fixed reqIds. → (links at start, links after the redial,
    Alpha's link alive after the kill, [(seqNo, txn items)] (the txn's
    time is in txnMetadata, left out), domain sizes)."""
    p = pkg(name)
    (NetworkedPoolClient, Wallet, NodeKeys, stack, NetworkedNode,
     Request) = _classes(name)
    cfg = p.Config(Max3PCBatchSize=5, Max3PCBatchWait=0.1, CHK_FREQ=5,
                   LOG_SIZE=15, HEARTBEAT_FREQ=2,
                   **({"VERIFIER_PROVIDER": "cpu"} if name == JAX else {}))
    c = p.constants

    async def main():
        keys = {n: NodeKeys(bytes([i + 110]) * 32)
                for i, n in enumerate(NAMES)}
        nodes, registry = {}, {}
        for n in NAMES:
            node = NetworkedNode(
                n, {m: stack.RemoteInfo(m, stack.HA("127.0.0.1", 1),
                                        keys[m].verkey_raw) for m in NAMES},
                keys[n], stack.HA("127.0.0.1", 0),
                stack.HA("127.0.0.1", 0), config=cfg, **node_kw(p))
            await node.start_async()
            nodes[n] = node
            registry[n] = stack.RemoteInfo(n, node.nodestack.ha,
                                           keys[n].verkey_raw)
        for node in nodes.values():
            for info in registry.values():
                if info.name != node.name:
                    node.nodestack.update_remote(info)
        everyone = list(nodes.values())

        async def pump_nodes(seconds, until):
            end = asyncio.get_event_loop().time() + seconds
            while asyncio.get_event_loop().time() < end:
                for n in everyone:
                    await n.prod()
                if until():
                    return True
                await asyncio.sleep(0.01)
            return until()

        assert await pump_nodes(10, lambda: all(
            len(n.nodestack.connecteds) == 3 for n in everyone))
        author = p.Signer(seed=b"\x71" * 32)
        wallet = Wallet("w1")
        wallet.add_identifier(signer=author)
        addrs = {n: (nodes[n].clientstack.ha, keys[n].verkey_raw)
                 for n in NAMES}
        await nodes["Delta"].clientstack.stop()
        client = NetworkedPoolClient(wallet, addrs, resubmit_interval=2.0)
        client.RECONNECT_BACKOFF = 0.1
        await client.start()
        links_at_start = len(client._conns)

        async def drive():
            while True:
                for n in everyone:
                    await n.prod()
                await asyncio.sleep(0.005)

        driver = asyncio.get_event_loop().create_task(drive())
        try:
            results = []
            for i in range(N_WRITES):
                dest = p.Signer(seed=bytes([0x72 + i]) * 32)
                req = wallet.sign_request(Request(
                    identifier=author.identifier, reqId=1000 + i,
                    operation={"type": c.NYM, c.TARGET_NYM: dest.identifier,
                               c.VERKEY: dest.verkey}))
                client.pool.submit_request(req)
                result = await client.run_until_confirmed(req, timeout=30)
                txn = dict(result["txn"])
                results.append((result["txnMetadata"]["seqNo"],
                                sorted(txn.items())))
            await nodes["Delta"].clientstack.start()
            await asyncio.sleep(0.15)
            deadline = asyncio.get_event_loop().time() + 10
            while asyncio.get_event_loop().time() < deadline \
                    and len(client._conns) < 4:
                await client.pump()
                await asyncio.sleep(0.02)
            links_after = len(client._conns)
            client._conns["Alpha"].conn.close()
            await asyncio.sleep(0.05)
            deadline = asyncio.get_event_loop().time() + 10
            while asyncio.get_event_loop().time() < deadline and not (
                    "Alpha" in client._conns
                    and client._conns["Alpha"].conn.alive):
                await client.pump()
                await asyncio.sleep(0.02)
            healed = "Alpha" in client._conns and \
                client._conns["Alpha"].conn.alive
        finally:
            driver.cancel()
        sizes = [n.node.domain_ledger.size for n in everyone]
        await client.stop()
        for n in everyone:
            await n.nodestack.stop()
            await n.clientstack.stop()
        return links_at_start, links_after, healed, results, sizes

    return asyncio.run(main())


@pytest.fixture(scope="module")
def runs():
    with jax_warm_off():
        return _run(PORT), _run(JAX)


def test_client_confirms_redials_and_heals(runs):
    links_at_start, links_after, healed, results, sizes = runs[0]
    assert links_at_start == 3
    assert [seq for seq, _ in results] == list(range(1, N_WRITES + 1))
    assert sizes == [N_WRITES] * len(NAMES)
    assert links_after == 4 and healed


def test_confirmed_results_equal_the_jax_clients(runs):
    """Links, seqNos, the confirmed txns (type, data, metadata) and the
    nodes' domain sizes: all equal."""
    assert runs[0] == runs[1]
