"""Multi-process pool harness: the port's counterparts of bench.py's
run_multiprocess_pool (:255), _drive_mp_client (:390) and
make_mp_requests (:44), at the same sizes (4 nodes, POOL_REQS 4,000,
Max3PCBatchSize 2,000, bench.py's pool config file :338-352).

Four node OS processes (`python -m plenum_tpu_torch.start_node`) boot from
a pool directory written by `bootstrap.generate_pool` and talk over the
real TCP stack (network/stack.py). A client sends every request to
every node over its encrypted client connection and counts REPLYs per
connection: in bench.py's order ("by_node": one node all the requests,
then the next) or, as a second variant, "broadcast" (each request to
every node before the next). provider="remote" starts a verify daemon
process (server/verify_daemon.py) that verifies every node's client
signatures with the ed25519 kernel; provider="cpu" has each node verify
on its own (the scalar RFC 8032 check).

`device` is where the node processes and the daemon run their kernels:
"cuda" (the card) or "cpu" (their plain versions, for the tests). Each
process's log goes to a file; each node process writes its device and
kernel launch counts to a file when it stops; the daemon's counters come
over its stats frame. After the run the harness reads every node's
domain, audit and state roots and the BLS multi-signature of its latest
state root back from the node's data directory, and, when asked, the
validator-info JSON each node dumps into <base>/<name>/. client=
"networked" drives the pool with the port's NetworkedPoolClient (one
wallet, each write confirmed on f + 1 matching replies) instead of
bench.py's raw client.
"""
from __future__ import annotations

import asyncio
import json
import os
import random
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

NAMES = ["Alpha", "Beta", "Gamma", "Delta"]
POOL_REQS = 4000             # bench.py POOL_REQS
CLIENT_BATCH = 2000          # bench.py CLIENT_BATCH: Max3PCBatchSize
MP_TRUSTEE_SEED = b"\x42" * 32
DAEMON_PORT_OFFSET = 9       # bench.py: the daemon at base_port + 9
ORDERS = ("by_node", "broadcast")    # the client's send orders, bench.py's
CLIENTS = ("mp", "networked")        # bench.py's raw client, the port's own
STATS_FILE = "stats.json"
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def make_mp_requests(n: int) -> List[dict]:
    """Requests for the multi-process pool, authored by its trustee."""
    from plenum_tpu_torch.crypto.signer import DidSigner
    from plenum_tpu_torch.testing.pool import make_requests
    return make_requests(n, DidSigner(seed=MP_TRUSTEE_SEED))


def free_base_port(span: int = 10, tries: int = 200) -> int:
    """A port p with p .. p+span-1 all free on 127.0.0.1 now (the pool's
    node and client ports, then the daemon's). p lies below Linux's
    ephemeral range (32768 up), as bench.py's 19000-23000 do, so that
    no socket of another process dials out from it later."""
    rng = random.Random(os.getpid() ^ time.monotonic_ns())
    for _ in range(tries):
        base = rng.randrange(15000, 32000 - span)
        socks = []
        try:
            for p in range(base, base + span):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no free run of {} ports".format(span))


def write_pool_config(base_dir: str, provider: str, daemon_port: int,
                      batch: int = CLIENT_BATCH,
                      extra: Optional[dict] = None) -> None:
    """bench.py's pool config file (:338-352), plus `extra` keys."""
    lines = ["Max3PCBatchSize = %d" % batch,
             "Max3PCBatchWait = 0.05",
             "CHK_FREQ = 10",
             "LOG_SIZE = 30",
             "CLIENT_TO_NODE_STACK_QUOTA = 4000",
             "NODE_TO_NODE_STACK_QUOTA = 4096",
             "NODE_TO_NODE_STACK_SIZE = %d" % (16 << 20),
             "CLIENT_TO_NODE_STACK_SIZE = %d" % (16 << 20),
             "VERIFIER_PROVIDER = %r" % provider,
             "VERIFIER_DAEMON_PORT = %d" % daemon_port,
             "METRICS_FLUSH_INTERVAL = 2"]
    lines += ["%s = %r" % kv for kv in sorted((extra or {}).items())]
    with open(os.path.join(base_dir, "plenum_tpu_config.py"), "w") as f:
        f.write("\n".join(lines) + "\n")


def _child_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_REPO, env.get("PYTHONPATH")) if p)
    return env


def _stop(procs, timeout: float = 30.0) -> None:
    """SIGTERM every live process, wait, then kill what is left."""
    for p in procs:
        if p is not None and p.poll() is None:
            p.send_signal(signal.SIGTERM)
    end = time.monotonic() + timeout
    for p in procs:
        if p is None:
            continue
        try:
            p.wait(timeout=max(0.1, end - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def start_daemon(base_dir: str, port: int, device: str, log_path: str,
                 wait_s: float = 120.0) -> subprocess.Popen:
    """The verify daemon on `device`, listening on `port`; returns once
    it is ready. Raises (and stops it) if it exits or is not ready in
    `wait_s`."""
    ready = os.path.join(base_dir, "daemon_ready")
    with open(log_path, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "plenum_tpu_torch.server.verify_daemon",
             "--port", str(port), "--device", device,
             "--base-dir", base_dir, "--ready-file", ready],
            cwd=_REPO, env=_child_env(), stdout=out,
            stderr=subprocess.STDOUT)
    deadline = time.monotonic() + wait_s
    while not os.path.exists(ready):
        if proc.poll() is not None or time.monotonic() > deadline:
            _stop([proc])
            raise RuntimeError("verify daemon failed to start (rc {}); see "
                               "{}".format(proc.returncode, log_path))
        time.sleep(0.05)
    return proc


def settle_audit(base_dir: str, quiet_s: float = 1.0,
                 timeout: float = 30.0) -> bool:
    """Wait until the four nodes' audit ledgers, read from their data
    directories while they run, have one size that has not changed for
    `quiet_s`: a batch that holds no new write (a re-sent request the
    pool had ordered already) may still be in commit on one node when
    the client has all its replies. → whether that happened in
    `timeout`; the caller compares the roots either way."""
    from plenum_tpu_torch.storage.kv_file import KeyValueStorageFile

    def sizes():
        out = []
        for name in NAMES:
            kv = KeyValueStorageFile(os.path.join(base_dir, name, "data"),
                                     "audit_ledger", read_only=True)
            out.append(kv.size)
            kv.close()
        return out

    end = time.monotonic() + timeout
    last, since = None, time.monotonic()
    while time.monotonic() < end:
        now = sizes()
        if now != last:
            last, since = now, time.monotonic()
        elif len(set(now)) == 1 and time.monotonic() - since >= quiet_s:
            return True
        time.sleep(0.1)
    return False


def read_node_state(base_dir: str, name: str) -> dict:
    """A stopped node's committed state, read back from its data
    directory: domain, audit and domain-state roots (b58), the domain
    txns, and the BLS multi-signature stored for the latest state root
    with whether it verifies under the pool's BLS keys."""
    from plenum_tpu_torch.bootstrap import pool_genesis_txns
    from plenum_tpu_torch.common.constants import ALIAS, BLS_KEY, DATA
    from plenum_tpu_torch.common.txn_util import get_payload_data
    from plenum_tpu_torch.consensus.bls_bft_replica import BlsStore
    from plenum_tpu_torch.crypto.bls import BlsCryptoVerifierPlenum
    from plenum_tpu_torch.ledger.ledger import Ledger
    from plenum_tpu_torch.state.pruning_state import PruningState
    from plenum_tpu_torch.storage.kv_file import KeyValueStorageFile
    data_dir = os.path.join(base_dir, name, "data")
    stores = {n: KeyValueStorageFile(data_dir, n, read_only=True)
              for n in ("domain_ledger", "audit_ledger", "domain_state",
                        "bls_store")}
    try:
        domain = Ledger(txn_store=stores["domain_ledger"])
        audit = Ledger(txn_store=stores["audit_ledger"])
        state_root = PruningState(stores["domain_state"]) \
            .committedHeadHash_b58
        multi = BlsStore(stores["bls_store"]).get(state_root)
        keys = {}
        for txn in pool_genesis_txns(base_dir):
            d = get_payload_data(txn).get(DATA, {})
            if d.get(BLS_KEY):
                keys[d[ALIAS]] = d[BLS_KEY]
        ok = multi is not None \
            and multi.value.state_root_hash == state_root \
            and BlsCryptoVerifierPlenum().verify_multi_sig(
                multi.signature, multi.value.as_single_value(),
                [keys[p] for p in multi.participants])
        return {"domain_root": domain.root_hash,
                "audit_root": audit.root_hash, "state_root": state_root,
                "domain_size": domain.size, "audit_size": audit.size,
                "domain_txns": [t for _, t in domain.getAllTxn()],
                "multi_sig": multi.as_dict() if multi else None,
                "multi_sig_ok": bool(ok)}
    finally:
        for kv in stores.values():
            kv.close()


def info_path(base_dir: str, name: str) -> str:
    """Where a node of the pool dumps its validator info
    (server/validator_info.py dump_json_file, info_dir <base>/<name>)."""
    return os.path.join(base_dir, name, "%s_info.json" % name.lower())


def wait_validator_info(base_dir: str, since: float,
                        timeout: float) -> Dict[str, dict]:
    """Every node's validator-info dump, once each file was written after
    `since` (the nodes dump on their timer, so a dump taken after the audit
    ledgers settled holds the final state). Raises if a node wrote none
    in `timeout` seconds."""
    end = time.monotonic() + timeout
    while True:
        stale = [n for n in NAMES
                 if not os.path.exists(info_path(base_dir, n))
                 or os.path.getmtime(info_path(base_dir, n)) <= since]
        if not stale:
            break
        if time.monotonic() > end:
            raise RuntimeError("no validator-info dump newer than the "
                               "settle from {}".format(stale))
        time.sleep(0.1)
    out = {}
    for name in NAMES:
        with open(info_path(base_dir, name)) as f:
            out[name] = json.load(f)
    return out


def replay_roots(txns: List[dict]) -> dict:
    """The domain root and domain-state root (b58) that `txns`, a node's
    committed domain txns in order, give when replayed on the host: the
    port's Ledger with hashlib leaves and NymHandler over a PruningState
    with no device engine. No kernel runs, so the roots the node
    processes made with sha256_ragged and SHA3 are held against hashes
    made without them."""
    from plenum_tpu_torch.common.constants import DOMAIN_LEDGER_ID
    from plenum_tpu_torch.ledger.ledger import Ledger
    from plenum_tpu_torch.server.database_manager import DatabaseManager
    from plenum_tpu_torch.server.request_handlers import NymHandler
    from plenum_tpu_torch.state.pruning_state import PruningState
    from plenum_tpu_torch.storage.kv_memory import KeyValueStorageInMemory
    dm = DatabaseManager()
    ledger, state = Ledger(), PruningState(KeyValueStorageInMemory())
    dm.register_new_database(DOMAIN_LEDGER_ID, ledger, state)
    handler = NymHandler(dm)
    for txn in txns:
        ledger.add(dict(txn))
        handler.update_state(txn, None, None, is_committed=True)
    state.commit()
    return {"domain_root": ledger.root_hash,
            "state_root": state.committedHeadHash_b58}


def run_multiprocess_pool(reqs: List[dict], provider: str,
                          device: str = "cuda",
                          log_dir: Optional[str] = None,
                          profile_node: Optional[str] = None,
                          before_pool: Optional[Callable] = None,
                          extra_conf: Optional[dict] = None,
                          batch: int = CLIENT_BATCH,
                          timeout: float = 600.0,
                          generate_pool: Optional[Callable] = None,
                          order: str = "by_node",
                          info_dump_s: Optional[float] = None,
                          client: str = "mp") -> dict:
    """Order `reqs` on four node processes over TCP (bench.py
    run_multiprocess_pool). provider "remote" starts the verify daemon on
    `device` first; `before_pool(daemon_addr)` then runs before the node
    processes start, after which the daemon's counters are zeroed.
    `profile_node` runs that node under cProfile (its stats in
    <log_dir>/<name>.<provider>.prof). Every process's log goes to
    `log_dir` (a temporary directory when None, removed after).
    `generate_pool(base_dir, names, base_port=, trustee_seed=)` writes
    the pool directory: bootstrap.generate_pool unless given (the tests
    pass the JAX package's, whose directories the port boots as they
    are). `order` is the client's send order (ORDERS; drive_mp_client).
    `client` "networked" sends the writes of reqs[1:] (their operations,
    signed anew by the trustee's wallet) through drive_networked_client
    instead; `order` does not apply there. `info_dump_s` sets the nodes'
    VALIDATOR_INFO_DUMP_INTERVAL and, once the audit ledgers settle,
    waits for a dump newer than the settle from every node and returns
    it under "validator_info".

    → {"provider", "order", "driver" (`client`), "elapsed", "ordered",
    "required", "rate", "client": the client's timing, "nodes": {name:
    {"device",
    "kernels", "pid", "view_no" (the node's view at stop), and
    read_node_state's keys}},
    "daemon": its counters over the run or None, "profile": path or
    None}. Raises if a process fails to start, the pool does not order
    the probe, or `timeout` passes; every process it started is stopped
    before it returns or raises."""
    from plenum_tpu_torch.ops import resolve_device
    resolve_device(device)
    if order not in ORDERS:
        raise ValueError("order must be one of {}".format(ORDERS))
    if client not in CLIENTS:
        raise ValueError("client must be one of {}".format(CLIENTS))
    if info_dump_s is not None:
        extra_conf = dict(extra_conf or {},
                          VALIDATOR_INFO_DUMP_INTERVAL=info_dump_s)
    if generate_pool is None:
        from plenum_tpu_torch.bootstrap import generate_pool
    base_dir = tempfile.mkdtemp(prefix="plenum_tpu_torch_mp_")
    log_dir = log_dir or os.path.join(base_dir, "logs")
    os.makedirs(log_dir, exist_ok=True)
    procs, daemon_proc, rv = [], None, None
    try:
        base_port = free_base_port()
        generate_pool(base_dir, NAMES, base_port=base_port,
                      trustee_seed=MP_TRUSTEE_SEED)
        daemon_port = base_port + DAEMON_PORT_OFFSET
        write_pool_config(base_dir, provider, daemon_port, batch, extra_conf)
        if provider == "remote":
            from plenum_tpu_torch.crypto.remote_verifier import RemoteVerifier
            daemon_proc = start_daemon(
                base_dir, daemon_port, device,
                os.path.join(log_dir, "daemon.log"))
            addr = ("127.0.0.1", daemon_port)
            if before_pool is not None:
                before_pool(addr)
            rv = RemoteVerifier(addr, timeout=600)
            rv.daemon_stats()       # zero the daemon's counters
        prof = None
        env = _child_env()
        for name in NAMES:
            cmd = [sys.executable, "-m", "plenum_tpu_torch.start_node",
                   "--name", name, "--base-dir", base_dir,
                   "--device", device, "--log-file",
                   os.path.join(log_dir, "%s.%s.log" % (name, provider)),
                   "--stats-file", os.path.join(base_dir, name, STATS_FILE)]
            if name == profile_node:
                prof = os.path.join(log_dir, "%s.%s.prof" % (name, provider))
                cmd[1:1] = ["-m", "cProfile", "-o", prof]
            with open(os.path.join(log_dir, "%s.%s.out" % (name, provider)),
                      "w") as out:
                procs.append(subprocess.Popen(
                    cmd, cwd=_REPO, env=env, stdout=out,
                    stderr=subprocess.STDOUT))
        timing = {}
        if client == "networked":
            ordered, required, elapsed = drive_networked_client(
                base_dir, [r["operation"] for r in reqs], procs, timeout,
                timing)
        else:
            ordered, required, elapsed = drive_mp_client(
                base_dir, reqs, procs, timeout, timing, order)
        daemon = rv.daemon_stats() if rv is not None else None
        settle_audit(base_dir)
        infos = None
        if info_dump_s is not None:
            infos = wait_validator_info(base_dir, time.time(),
                                        4 * info_dump_s + 10)
        _stop(procs)
        nodes = {}
        for name, p in zip(NAMES, procs):
            path = os.path.join(base_dir, name, STATS_FILE)
            if p.returncode != 0 or not os.path.exists(path):
                raise RuntimeError("node {} did not stop cleanly (rc {}); "
                                   "see {}".format(name, p.returncode,
                                                   log_dir))
            with open(path) as f:
                nodes[name] = json.load(f)
            nodes[name].update(read_node_state(base_dir, name))
            if infos is not None:
                nodes[name]["validator_info"] = infos[name]
        return {"provider": provider, "order": order, "driver": client,
                "elapsed": elapsed,
                "ordered": ordered, "required": required,
                "rate": ordered / elapsed if elapsed else 0.0,
                "client": timing, "nodes": nodes, "daemon": daemon,
                "profile": prof}
    finally:
        if rv is not None:
            rv.close()
        _stop(procs + [daemon_proc])
        shutil.rmtree(base_dir, ignore_errors=True)


def drive_mp_client(base_dir: str, reqs: List[dict], procs,
                    timeout: float = 600.0, timing: Optional[dict] = None,
                    order: str = "by_node"):
    """Async client (bench.py _drive_mp_client): one encrypted connection
    per node, send every request to every node, count REPLYs per
    connection. `order` "by_node" is bench.py's: one node all the
    requests, then the next; "broadcast" sends each request to every node
    before the next, so that no node meets most requests first in its
    peers' PROPAGATEs (which it verifies one at a time on its host). Done
    when EVERY node replied to every request after the first (the probe,
    sent until every node replies, so that a primary is in place before
    the clock starts). → (ordered on the slowest node, required,
    elapsed seconds). `timing` receives "send_s", the seconds the client
    took to encrypt and queue every request, and "client_cpu_s", its CPU
    seconds until the last reply. Raises if a node process exits, a node
    never comes up or the probe is never ordered."""
    timing = {} if timing is None else timing
    from plenum_tpu_torch.bootstrap import (client_ha_from_pool_genesis,
                                            registry_from_pool_genesis)
    from plenum_tpu_torch.network.stack import ClientConnection
    registry = registry_from_pool_genesis(base_dir)

    def check_alive():
        dead = [p.args for p in procs if p.poll() is not None]
        if dead:
            raise RuntimeError("node process exited: {}".format(dead))

    async def drive():
        conns: Dict[str, ClientConnection] = {}
        deadline = time.perf_counter() + 120
        try:
            for name in NAMES:
                ha = client_ha_from_pool_genesis(base_dir, name)
                while True:
                    check_alive()
                    conn = ClientConnection(
                        ha, expected_verkey=registry[name].verkey)
                    try:
                        await conn.connect()
                        conns[name] = conn
                        break
                    except OSError:
                        if time.perf_counter() > deadline:
                            raise RuntimeError(
                                "node %s never came up" % name)
                        await asyncio.sleep(0.2)
            probe = reqs[0]
            t_probe = time.perf_counter() + 120
            while True:
                check_alive()
                for conn in conns.values():
                    conn.send(dict(probe))
                await asyncio.sleep(0.5)
                if all(any(m.get("op") == "REPLY" for m in c.rx)
                       for c in conns.values()):
                    break
                if time.perf_counter() > t_probe:
                    raise RuntimeError("pool never ordered the probe "
                                       "request")
            t0 = time.perf_counter()
            cpu0 = time.process_time()
            rest = reqs[1:]
            required = frozenset(r["reqId"] for r in rest)
            if order == "by_node":
                for conn in conns.values():
                    for r in rest:
                        conn.send(r)
            else:
                for r in rest:
                    for conn in conns.values():
                        conn.send(r)
            timing["send_s"] = time.perf_counter() - t0
            seen = {n: set() for n in conns}
            hard_deadline = t0 + timeout
            while time.perf_counter() < hard_deadline:
                for name, conn in conns.items():
                    for m in conn.rx:
                        if m.get("op") == "REPLY":
                            # a write REPLY's result is the committed
                            # txn: reqId lives in txn.metadata
                            result = m.get("result", {})
                            rid = result.get("txn", {}).get(
                                "metadata", {}).get("reqId")
                            if rid is None:
                                rid = result.get("reqId")
                            if rid in required:
                                seen[name].add(rid)
                    conn.rx.clear()
                if all(len(s) == len(required) for s in seen.values()):
                    timing["client_cpu_s"] = time.process_time() - cpu0
                    return len(required), len(required), \
                        time.perf_counter() - t0
                check_alive()
                await asyncio.sleep(0.02)
            return (min(len(s) for s in seen.values()), len(required),
                    time.perf_counter() - t0)
        finally:
            for conn in conns.values():
                conn.close()

    return asyncio.run(drive())


def drive_networked_client(base_dir: str, ops: List[dict], procs,
                           timeout: float = 600.0,
                           timing: Optional[dict] = None):
    """The pool driven by the port's NetworkedPoolClient
    (client/network_client.py): the trustee's wallet signs every
    operation, the client sends each request to every node over its
    encrypted links and confirms it on f + 1 matching replies
    (PoolClient). ops[0] is the probe, confirmed first so that a primary
    is in place before the clock starts; then the other writes are
    signed, sent, and each confirmed in turn with run_until_confirmed.
    → (writes the pool client holds confirmed at the end, writes sent,
    elapsed seconds). `timing` receives
    "send_s" (the seconds to queue every request), "client_cpu_s",
    "redials" (links that came back after their first dial) and
    "seq_nos" (the confirmed results' distinct seqNos). Raises if a node
    process exits or a write is not confirmed in `timeout`."""
    timing = {} if timing is None else timing
    from plenum_tpu_torch.bootstrap import (client_ha_from_pool_genesis,
                                            registry_from_pool_genesis)
    from plenum_tpu_torch.client import NetworkedPoolClient, Wallet
    from plenum_tpu_torch.crypto.signer import DidSigner
    registry = registry_from_pool_genesis(base_dir)
    wallet = Wallet("mp-trustee")
    wallet.add_identifier(signer=DidSigner(seed=MP_TRUSTEE_SEED))
    addrs = {name: (client_ha_from_pool_genesis(base_dir, name),
                    registry[name].verkey) for name in NAMES}

    def check_alive():
        dead = [p.args for p in procs if p.poll() is not None]
        if dead:
            raise RuntimeError("node process exited: {}".format(dead))

    async def drive():
        client = NetworkedPoolClient(wallet, addrs)
        client.RECONNECT_BACKOFF = 0.2
        links = {}
        dial = client._dial

        async def counting_dial(name):
            await dial(name)
            if name in client._conns:
                links[name] = links.get(name, 0) + 1

        client._dial = counting_dial
        await client.start()
        try:
            deadline = time.perf_counter() + 120
            probe = client.submit(ops[0])
            while not client.pool.is_confirmed(probe):
                check_alive()
                if time.perf_counter() > deadline:
                    raise RuntimeError("pool never confirmed the probe "
                                       "request")
                await client.pump()
                await asyncio.sleep(0.05)
            reqs = [wallet.sign_op(op) for op in ops[1:]]
            t0 = time.perf_counter()
            cpu0 = time.process_time()
            for req in reqs:
                client.pool.submit_request(req)
            timing["send_s"] = time.perf_counter() - t0
            seq_nos = set()
            for req in reqs:
                check_alive()
                result = await client.run_until_confirmed(
                    req, timeout=max(1.0, t0 + timeout - time.perf_counter()))
                seq_nos.add(result["txnMetadata"]["seqNo"])
            elapsed = time.perf_counter() - t0
            timing["client_cpu_s"] = time.process_time() - cpu0
            timing["redials"] = sum(links.values()) - len(links)
            timing["seq_nos"] = sorted(seq_nos)
            confirmed = sum(1 for req in reqs if client.pool.is_confirmed(req))
            return confirmed, len(reqs), elapsed
        finally:
            await client.stop()

    return asyncio.run(drive())
