"""The BLS pool under attack (testing/byzantine.py drive_bls_attack) on
both packages, on the CPU, at chip_smoke.py phase 12b's size unless told
otherwise: the port's Nodes on device="cpu" (every kernel's plain
version) and the JAX package's on the host (its BLS pairing pinned to
the native library, its state engine and verifier on the host). Both
use the host ed25519 verifier for the intake. Prints one JSON object a
package: the views and last ordered batches after each chunk, every
node's final view, the honest nodes' batches still waiting for a
multi-signature backfill and their batches with no stored
multi-signature, the number of share unrolls, the domain sizes and
roots; then whether the fault traces, views, unrolls and roots are
equal. Too large for the test suite (25 nodes take minutes); run it from
the repo's root:

    python -m tests.torch_attack_parity [--nodes 25] [--writes 200]
                                        [--chunk 50]
"""
import argparse
import json
import logging
import os
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("PLENUM_TPU_BLS_TOWER", "native")

from plenum_tpu_torch.testing import byzantine  # noqa: E402
from tests.torch_two_packages import (  # noqa: E402
    JAX, PORT, conf, jax_warm_off, node_kw, pkg)


def build(p, n_nodes):
    """byzantine.make_bls_pool's pool of package `p`."""
    timer = p.MockTimer()
    timer.set_time(byzantine.SIM_EPOCH)
    net = p.SimNetwork(timer, p.Random(byzantine.ATTACK_NET_SEED))
    extra = dict(VERIFIER_PROVIDER="cpu")
    if p.name == JAX:
        extra["STATE_DEVICE_ENGINE"] = False
    cfg = conf(p, **byzantine.ATTACK_CONF, **extra)
    names = byzantine.attack_names(n_nodes)
    signers = {n: p.bls.BlsCryptoSignerPlenum.generate(
        byzantine.bls_seed(i))[0] for i, n in enumerate(names)}
    genesis = [p.bootstrap.node_genesis_txn(
        n, verkey="v%d" % i, node_ip="127.0.0.1", node_port=1,
        client_ip="127.0.0.1", client_port=2, steward_nym="S%d" % i,
        bls_key=signers[n].pk) for i, n in enumerate(names)]
    nodes = [p.Node(n, names, timer, net.create_peer(n), config=cfg,
                    client_reply_handler=lambda c, m: None,
                    bls_signer=signers[n], genesis_txns=genesis,
                    **node_kw(p)) for n in names]
    return timer, nodes


def attack(name, n_nodes, writes, chunk) -> dict:
    p = pkg(name)
    t0 = time.perf_counter()
    timer, nodes = build(p, n_nodes)
    run = byzantine.drive_bls_attack(timer, nodes, p.adversary, writes,
                                     chunk)
    honest = run["honest"]
    return {
        "package": name,
        "wall_s": round(time.perf_counter() - t0, 1),
        "chunks": [{"views": c["views"],
                    "last_ordered": [list(k) for k in c["last_ordered"]]}
                   for c in run["chunks"]],
        "views": [n.view_no for n in nodes],
        "pending_backfill": {
            n.name: sorted(map(list, n.bls_bft_replica._pending_backfill))
            for n in honest if n.bls_bft_replica._pending_backfill},
        "proofless": {n.name: len(byzantine.proofless_batches(n))
                      for n in honest if byzantine.proofless_batches(n)},
        "unrolls": len(run["unrolls"]),
        "sizes": sorted({n.domain_ledger.size for n in honest}),
        "roots": sorted({n.domain_ledger.root_hash for n in honest}),
        "trace": run["controller"].trace_lines(),
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, default=25)
    ap.add_argument("--writes", type=int, default=200)
    ap.add_argument("--chunk", type=int, default=50)
    args = ap.parse_args()
    logging.disable(logging.WARNING)
    out = {}
    for name in (PORT, JAX):
        with jax_warm_off():
            out[name] = attack(name, args.nodes, args.writes, args.chunk)
        shown = {k: v for k, v in out[name].items() if k != "trace"}
        print(json.dumps(shown), flush=True)
    port, ref = out[PORT], out[JAX]
    print(json.dumps({key: port[key] == ref[key] for key in (
        "trace", "chunks", "views", "unrolls", "sizes", "roots",
        "pending_backfill", "proofless")}))


if __name__ == "__main__":
    main()
