"""A small sim pool of the port's Nodes on the CPU, for
tests/test_torch_native.py: run here in the test process it uses the
port's C branches; run as `python -m tests.torch_pool_parity` under
PLENUM_TPU_NO_NATIVE=1 it uses the pure-Python branches and prints its
result as one JSON line. It imports nothing of the JAX package."""
import json

POOL_WRITES = 8
POOL_CONF = dict(Max3PCBatchSize=10, Max3PCBatchWait=0.2, CHK_FREQ=5,
                 LOG_SIZE=15)
POOL_SEED = b"\x53" * 32


def pool_requests(make_requests, signer):
    """POOL_WRITES signed NYM writes, one with a changed operation, one
    with a changed signature character and one with a malformed
    identifier (the C intake declines it; the Python chain nacks it)."""
    reqs = make_requests(POOL_WRITES + 3, signer)
    reqs[-3]["operation"] = dict(reqs[-3]["operation"], verkey="~" + "1" * 22)
    sig = reqs[-2]["signature"]
    reqs[-2]["signature"] = sig[:-1] + ("2" if sig[-1] != "2" else "3")
    reqs[-1]["identifier"] = "not base58!"
    return reqs


def order(nodes, timer, reqs):
    """Every request to every node in one batch; pump until ordered."""
    for n in nodes:
        n.process_client_batch([(r, "client") for r in reqs])
    for _ in range(400):
        for n in nodes:
            n.service()
        timer.run_for(0.01)
        if all(n.domain_ledger.size >= POOL_WRITES for n in nodes):
            return
    raise AssertionError("pool stalled")


def pool_result(nodes, sinks):
    """Each node's pool, domain, config and audit ledger roots and pool,
    domain and config state roots; each node's replies and nacks; the
    class of the domain state's trie."""
    db = [n.db_manager for n in nodes]
    return {"roots": [[d.get_ledger(lid).root_hash for lid in (0, 1, 2, 3)]
                      + [d.get_state(lid).committedHeadHash.hex()
                         for lid in (0, 1, 2)] for d in db],
            "replies": [json.loads(json.dumps(s, sort_keys=True, default=str))
                        for s in sinks],
            "trie": type(db[0].get_state(1)._trie).__name__}


def port_pool():
    """The port's four nodes on the CPU (plain kernels below lowered
    floors) order the requests; → roots, replies and the trie class."""
    from plenum_tpu_torch.common.config import Config
    from plenum_tpu_torch.crypto.signer import SimpleSigner
    from plenum_tpu_torch.runtime.sim_random import DefaultSimRandom
    from plenum_tpu_torch.server.node import Node
    from plenum_tpu_torch.testing import pool
    from plenum_tpu_torch.testing.mock_timer import MockTimer
    from plenum_tpu_torch.testing.sim_network import SimNetwork
    conf = Config(SHA256_BATCH_THRESHOLD=2, STATE_DEVICE_HASH_FLOOR=2,
                  STATE_DEVICE_BATCH_MIN=2, **POOL_CONF)
    timer = MockTimer()
    timer.set_time(1600000000)
    net = SimNetwork(timer, DefaultSimRandom(77))
    sinks = [[] for _ in pool.NAMES]
    nodes = [Node(name, pool.NAMES, timer, net.create_peer(name),
                  config=conf, device="cpu",
                  client_reply_handler=lambda c, m, s=s: s.append(
                      (type(m).__name__, m.to_dict())))
             for name, s in zip(pool.NAMES, sinks)]
    order(nodes, timer,
           pool_requests(pool.make_requests, SimpleSigner(seed=POOL_SEED)))
    return pool_result(nodes, sinks)




if __name__ == "__main__":
    print(json.dumps(port_pool()))
