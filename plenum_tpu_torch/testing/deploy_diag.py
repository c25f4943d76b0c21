"""Repeated remote runs of the deployment in bench.py's send order, for the
stall and view-change fault of ROADMAP C. Each run prints one JSON line:
the writes every node replied to, the wall, each node's view and
committed domain txns at stop, and the links each node's stack dropped
as unresponsive (a peer that answered no ping within 2 x HEARTBEAT_FREQ;
the bytes queued on a dropped link are lost). Each line also gives the
daemon's fused batches and served items (which regime a run was in: tens
of batches in a fast run, hundreds in a slow one), each node's 3PC
batches (its audit ledger's size) and the client's seconds to encrypt
and queue the requests. A first line times one ChaCha20-Poly1305 seal of
64 KiB on the wire's path and the Python keystream alone.

    python3 -m plenum_tpu_torch.testing.deploy_diag [--writes 3000]
        [--runs 3] [--profile-node Delta] [--timeout 300]

Node logs go to chiprun_out/diag/<run>/ under the repo root; the profiled
node (first run only) prints its top functions by own time. Needs the
card: the node processes and the verify daemon run on CUDA.
"""
import argparse
import glob
import json
import os
import pstats
import time

from plenum_tpu_torch.testing import mp_pool

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DROPPED = "unresponsive, dropping link"


def cipher_times() -> dict:
    from plenum_tpu_torch.crypto import pure_channel_crypto as pc
    key, nonce, data = b"k" * 32, b"n" * 12, b"x" * 65536
    aead = pc.ChaCha20Poly1305(key)
    aead.encrypt(nonce, b"x", b"")          # builds or loads the C keystream
    t = time.perf_counter()
    aead.encrypt(nonce, data, b"")
    seal = time.perf_counter() - t
    t = time.perf_counter()
    pc._chacha20_xor(key, 1, nonce, data)
    python = time.perf_counter() - t
    return {"c_keystream": pc._xor_impl is not pc._chacha20_xor,
            "aead_64k_ms": seal * 1e3, "python_keystream_64k_ms": python * 1e3}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--writes", type=int, default=3000)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--profile-node", default=None)
    ap.add_argument("--timeout", type=float, default=300.0)
    args = ap.parse_args()
    print(json.dumps(cipher_times()), flush=True)
    reqs = mp_pool.make_mp_requests(args.writes + 1)
    for i in range(args.runs):
        log_dir = os.path.join(_REPO, "chiprun_out", "diag", str(i))
        t = time.perf_counter()
        res = mp_pool.run_multiprocess_pool(
            reqs, "remote", device="cuda", log_dir=log_dir,
            timeout=args.timeout, order="by_node",
            profile_node=args.profile_node if i == 0 else None)
        dropped = {}
        for path in sorted(glob.glob(os.path.join(log_dir, "*.log"))):
            with open(path) as f:
                n = sum(DROPPED in line for line in f)
            dropped[os.path.basename(path).split(".")[0]] = n
        print(json.dumps({
            "run": i, "ordered": res["ordered"], "required": res["required"],
            "elapsed_s": res["elapsed"], "wall_s": time.perf_counter() - t,
            "client_send_s": res["client"].get("send_s"),
            "daemon_batches": res["daemon"]["batches"],
            "daemon_served": res["daemon"]["served"],
            "batches_3pc": {k: v["audit_size"]
                            for k, v in res["nodes"].items()},
            "view_no": {k: v["view_no"] for k, v in res["nodes"].items()},
            "domain_txns": {k: len(v["domain_txns"])
                            for k, v in res["nodes"].items()},
            "links_dropped": dropped}), flush=True)
        if res["profile"]:
            pstats.Stats(res["profile"]).sort_stats("tottime").print_stats(18)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
