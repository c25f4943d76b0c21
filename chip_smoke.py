#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (plenum_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run it from the root of a checkout: it builds the CUDA kernels from
plenum_tpu_torch/csrc/ into plenum_tpu_torch/_build/ and then

1. prints the card's name and power limit and the build time;
2. holds each kernel against its plain PyTorch version on the card:
   ed25519 verify on 16,384 signatures that mix valid ones with every
   rejection path (and a 512-signature subset against the RFC 8032 scalar
   verify), SHA-256 on ragged messages at B = 1023/1024/1025 and on 2^20
   node pairs (against hashlib too);
3. drives the main path: a domain ledger of 2^20 NYM txns recovered with
   Ledger.recoverTreeFromTxnLog (root checked against hashlib), 2,000
   signed NYM requests (1% tampered) authenticated by four CoreAuthNrs
   sharing one CoalescingVerifierHub, the accepted ones staged in 3PC
   batches of Max3PCBatchSize and committed, and every reply's audit path
   checked on the host. Both kernels' launch counters are zeroed just
   before and read just after; each must have launched;
4. holds each kernel against its plain version again at the main path's
   own shapes (the verify batch, the 2^20 leaves, the first tree level,
   the staged batches), times both there and prints {"kernels": [...]},
   the card line and, last, {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero and prints no
result; so does a machine without CUDA, or a directory that holds this
script and nothing else of the repository. The tolerance is none
everywhere: verdicts, digests and roots must be equal.
"""
import hashlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

SEED = 42
MICRO_BATCH = 16384          # bench.py MICRO_BATCH: the verify kernel check
SCALAR_SUBSET = 512
SHA_RAGGED_BATCHES = (1023, 1024, 1025)
NODE_PAIRS = 1 << 20
LEDGER_TXNS = 1 << 20        # bench.py micro_merkle's ledger size
CLIENT_BATCH = 2000          # bench.py CLIENT_BATCH: one client batch
BAD_REQUESTS = CLIENT_BATCH // 100
N_NODES = 4
TXN_TIME = 1700000000

# One H100 SXM at its 700 W limit (NVIDIA's data sheet): HBM bandwidth,
# and 32-bit integer instructions over all 128 lanes of the 132 SMs at
# the rate behind the sheet's 67 TFLOP/s float32 figure (33.5 T lane
# instructions/s, a multiply-add counted once). No integer instruction
# issues faster, so the times below are lower bounds.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12
# SHA-256, per 64-byte block, in the fewest Hopper instructions: a round
# is Sigma1 and Sigma0 (3 funnel shifts + 1 three-input xor each), Ch and
# Maj (one LOP3 each) and 4 three-input adds = 14; a schedule word is
# sigma0 and sigma1 (2 shifts + 1 shift + 1 xor each) and 2 adds = 10;
# then 8 state adds: 64*14 + 48*10 + 8.
SHA256_OPS_PER_BLOCK = 64 * 14 + 48 * 10 + 8
# ed25519 verify, 32-bit multiplies per signature: the kernel's schedule
# does 1,564 field squarings (36 products of 32-bit limbs each, using
# symmetry) and 2,130 field multiplications (64 each) — two decompressions
# (256 sq + 18 mul each), the 16-entry table (28 sq + 108 mul), 64
# windows of 4 doublings + 2 additions (1,024 sq + 1,984 mul) and the two
# final products. Reductions and carries are not counted.
ED25519_MULS_PER_VERIFY = 1564 * 36 + 2130 * 64
ED25519_BYTES_PER_SIG = 2 * 20 * 4 + 2 * 4 + 2 * 8 * 4 + 4


def log(*args):
    print(*args, flush=True)


def check(cond, what):
    if not cond:
        raise RuntimeError("check failed: " + what)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(torch, fn, reps):
    """(mean device milliseconds per call of fn over `reps` calls after one
    warm-up call, from CUDA events; the warm-up call's result)."""
    first = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, first


def bound(ops, nbytes):
    """(least milliseconds, what bounds them) for `ops` 32-bit integer
    operations and `nbytes` bytes moved."""
    t_ops, t_bytes = ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def u32_max_abs_err(torch, a, b):
    mask = 0xFFFFFFFF
    return int(((a.long() & mask) - (b.long() & mask)).abs().max().item())


def where_the_time_goes(torch, run_main_path):
    """Run the main path once more under torch.profiler (device busy time
    per kernel and the device's idle share of the wall time) and once
    under cProfile (host functions by own time)."""
    import cProfile
    import io
    import pstats
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    t0 = time.perf_counter()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        run_main_path()
    wall_us = (time.perf_counter() - t0) * 1e6
    busy = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            busy[e.name] = busy.get(e.name, 0.0) + e.time_range.elapsed_us()
    if busy:
        total = sum(busy.values())
        log("profile: device busy {:.3f} ms of {:.3f} ms wall, idle share "
            "{:.6f}".format(total / 1e3, wall_us / 1e3, 1 - total / wall_us))
        for name, us in sorted(busy.items(), key=lambda kv: -kv[1])[:8]:
            log("  device {:.3f} ms  {}".format(us / 1e3, name[:90]))
    else:
        log("profile: device time not measured (no device events traced)")
    prof_host = cProfile.Profile()
    prof_host.enable()
    run_main_path()
    prof_host.disable()
    out = io.StringIO()
    pstats.Stats(prof_host, stream=out).sort_stats("tottime").print_stats(14)
    log("profile: host functions by own time (under cProfile)")
    for line in out.getvalue().splitlines():
        if line.strip():
            log("  " + line.rstrip())


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="also profile the main path (device busy "
                             "time, host functions)")
    profile = parser.parse_args(argv).profile
    sys.path.insert(0, REPO)
    import numpy as np
    import torch
    from plenum_tpu_torch import testing
    from plenum_tpu_torch.common.config import Config
    from plenum_tpu_torch.common.request import Request
    from plenum_tpu_torch.common.txn_util import reqToTxn
    from plenum_tpu_torch.crypto import ed25519 as scalar
    from plenum_tpu_torch.crypto.batch_verifier import (
        CoalescingVerifierHub, TorchBatchVerifier)
    from plenum_tpu_torch.crypto.signer import SimpleSigner
    from plenum_tpu_torch.ledger.ledger import Ledger, _seq_key
    from plenum_tpu_torch.ledger.merkle_verifier import MerkleVerifier
    from plenum_tpu_torch.ledger.tree_hasher import TreeHasher
    from plenum_tpu_torch.ops import cuda_lib, to_tensor
    from plenum_tpu_torch.ops import ed25519 as ed
    from plenum_tpu_torch.ops import sha256 as sha
    from plenum_tpu_torch.server.client_authn import CoreAuthNr
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    dev = torch.device("cuda")
    t_all = time.perf_counter()

    # ------------------------------------------------ 1. device and build
    card = card_line()
    log("card:", card, "| torch", torch.__version__, "cuda",
        torch.version.cuda, "| devices", torch.cuda.device_count())
    t0 = time.perf_counter()
    built = cuda_lib.build()
    for name, info in built.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "stack" in line:
                log("  nvcc {}: {}".format(name, line.strip()))
    for name in cuda_lib.SOURCES:
        cuda_lib.load(name)
    log("build: {:.1f} s ({} libraries compiled)".format(
        time.perf_counter() - t0, len(built)))

    # ----------------------------------------- 2. kernels vs plain versions
    t0 = time.perf_counter()
    msgs, sigs, vks, kinds = testing.adversarial_signatures(
        MICRO_BATCH, SEED, unique=SCALAR_SUBSET)
    arrays, valid = ed.host_pack(msgs, sigs, vks)
    ed_in = [to_tensor(a, dev) for a in arrays]
    ok_kernel = ed.verify_cuda(*ed_in)
    torch.cuda.synchronize()
    ok_plain = ed.verify_plain(*ed_in)
    ed_err = int((ok_kernel.int() - ok_plain.int()).abs().max().item())
    check(ed_err == 0, "ed25519 kernel verdicts equal the plain version's")
    verdicts = ok_kernel.cpu().numpy() & valid
    want = [scalar.verify(m, s, v) for m, s, v in
            zip(msgs[:SCALAR_SUBSET], sigs[:SCALAR_SUBSET],
                vks[:SCALAR_SUBSET])]
    check(verdicts[:SCALAR_SUBSET].tolist() == want,
          "ed25519 kernel verdicts equal RFC 8032 on the scalar subset")
    by_kind = {}
    for kind, v in zip(kinds, verdicts):
        acc, rej = by_kind.get(kind, (0, 0))
        by_kind[kind] = (acc + int(v), rej + int(not v))
    check(by_kind["valid"][1] == 0, "every valid signature is accepted")
    check(all(a == 0 for k, (a, _) in by_kind.items()
              if k not in ("valid", "a_small_order")),
          "every tampered signature is rejected")
    log("ed25519: kernel == plain on {} signatures, == RFC 8032 on {}; "
        "accepted/rejected by kind {}".format(MICRO_BATCH, SCALAR_SUBSET,
                                              by_kind))

    rng = np.random.RandomState(SEED)
    boundary = [0, 1, 55, 56, 63, 64, 119, 120, 300]
    sha_err = 0
    for n in SHA_RAGGED_BATCHES:
        lens = [boundary[i % len(boundary)] if i % 2
                else int(rng.randint(301)) for i in range(n)]
        ragged = [rng.randint(0, 256, size=ln, dtype=np.uint8).tobytes()
                  for ln in lens]
        words, nvalid, _ = sha.pad_messages(ragged)
        w, nv = to_tensor(words, dev), to_tensor(nvalid, dev)
        dk = sha.sha256_blocks_cuda(w, nv)
        dp = sha.sha256_blocks_plain(w, nv)
        sha_err = max(sha_err, u32_max_abs_err(torch, dk, dp))
        check(sha.digests_to_bytes(dk.cpu().numpy().view(np.uint32))
              == [hashlib.sha256(m).digest() for m in ragged],
              "SHA-256 kernel equals hashlib on ragged B={}".format(n))
    check(sha_err == 0, "SHA-256 kernel equals the plain version (ragged)")
    pairs = rng.randint(0, 256, size=(NODE_PAIRS, 64), dtype=np.uint8)
    w = sha._node_words_from_digest_pairs(to_tensor(pairs, dev))
    nv = torch.full((NODE_PAIRS,), 2, dtype=torch.int32, device=dev)
    dk = sha.sha256_blocks_cuda(w, nv)
    dp = sha.sha256_blocks_plain(w, nv)
    sha_err = max(sha_err, u32_max_abs_err(torch, dk, dp))
    check(sha_err == 0, "SHA-256 kernel equals the plain version (pairs)")
    got = sha.digests_to_array(dk.cpu().numpy().view(np.uint32))
    flat = pairs.tobytes()
    want = b"".join(hashlib.sha256(b"\x01" + flat[i * 64:(i + 1) * 64])
                    .digest() for i in range(NODE_PAIRS))
    check(got.tobytes() == want, "SHA-256 kernel equals hashlib on 2^20 "
                                 "node pairs")
    log("sha256: kernel == plain == hashlib on ragged B={} and on {} node "
        "pairs".format(SHA_RAGGED_BATCHES, NODE_PAIRS))
    log("phase 2: {:.1f} s".format(time.perf_counter() - t0))

    # --------------------------------------------------- 3. the main path
    t0 = time.perf_counter()
    blobs = testing.nym_txn_blobs(LEDGER_TXNS, SEED, TXN_TIME)
    signer = SimpleSigner(seed=hashlib.sha256(b"trustee").digest())
    reqs, bad = testing.nym_requests(CLIENT_BATCH, signer, SEED,
                                     n_bad=BAD_REQUESTS)
    log("set-up: {} ledger txns, {} signed requests ({} tampered) in "
        "{:.1f} s".format(len(blobs), len(reqs), len(bad),
                          time.perf_counter() - t0))

    def run_main_path():
        """The slice as a node runs it: recover the 2^20-txn ledger,
        authenticate the client batch on four nodes sharing one hub, stage,
        commit and reply. → (ledger, recovered root, hub, nodes, verdicts
        per node, [(reply, tree size)], host seconds per phase)."""
        phases = {}
        t_main = t0 = time.perf_counter()
        ledger = Ledger(tree_hasher=TreeHasher(
            batch_backend=sha.TorchSha256Backend(dev)))
        ledger._store.setBatch((_seq_key(i + 1), b) for i, b in
                               enumerate(blobs))
        ledger.recoverTreeFromTxnLog()
        root = ledger.root_hash_raw
        phases["recover_2^20"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        hub = CoalescingVerifierHub(batch=TorchBatchVerifier(dev))
        nodes = [CoreAuthNr(verifier=hub) for _ in range(N_NODES)]
        for node in nodes:
            node.addIdr(signer.identifier, signer.verkey)
        handles = [node.dispatch_batch([Request(**r) for r in reqs])
                   for node in nodes]
        nodes[0].flush()
        auth = [node.conclude_batch(h) for node, h in zip(nodes, handles)]
        phases["authenticate"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        accepted = [r for r, v in zip(reqs, auth[0]) if v is not None]
        replies = []
        batch = Config.Max3PCBatchSize
        for lo in range(0, len(accepted), batch):
            txns = [reqToTxn(Request(**r)) for r in accepted[lo:lo + batch]]
            ledger.append_txns_metadata(txns, txn_time=TXN_TIME)
            ledger.stage_txns_collect(ledger.stage_txns_dispatch(txns))
            (first, last), _ = ledger.commitTxns(len(txns))
            replies.extend((info, last) for info in
                           ledger.merkleInfoBatch(range(first, last + 1)))
        torch.cuda.synchronize()
        phases["stage_commit_reply"] = time.perf_counter() - t0
        phases["main_path"] = time.perf_counter() - t_main
        return ledger, root, hub, nodes, auth, replies, phases

    sha.sha256_blocks_cuda.launches = 0
    ed.verify_cuda.launches = 0
    ledger, recovered_root, hub, nodes, auth, replies, phases = \
        run_main_path()
    launches = {"sha256_compress": sha.sha256_blocks_cuda.launches,
                "ed25519_verify": ed.verify_cuda.launches}
    log("main path launches:", launches, "| host seconds:",
        json.dumps({k: round(v, 3) for k, v in phases.items()}))

    t0 = time.perf_counter()
    check(recovered_root == TreeHasher().hash_full_tree(blobs),
          "recovered 2^20-txn root equals the hashlib root")
    check(all(a == auth[0] for a in auth[1:]), "the four nodes agree")
    rejected = {i for i, v in enumerate(auth[0]) if v is None}
    check(rejected == bad, "exactly the tampered requests are rejected")
    check(hub.launches == [(CLIENT_BATCH, ed.launch_lanes(CLIENT_BATCH))],
          "the four nodes' dispatches made one deduplicated launch")
    check(len(replies) == CLIENT_BATCH - BAD_REQUESTS, "one reply per "
                                                       "accepted request")
    check(ledger.size == LEDGER_TXNS + len(replies), "ledger size")
    verifier = MerkleVerifier(TreeHasher())
    written = set()
    for info, size in replies:
        txn = ledger.getBySeqNo(info["seqNo"])
        written.add(txn["txn"]["metadata"]["reqId"])
        verifier.verify_leaf_inclusion(
            ledger.serialize_for_tree(txn), info["seqNo"] - 1,
            [ledger.strToHash(h) for h in info["auditPath"]], size,
            ledger.strToHash(info["rootHash"]))
    check(not written & {reqs[i]["reqId"] for i in bad},
          "no tampered request reached the ledger")
    check(all(n > 0 for n in launches.values()),
          "every kernel of the path launched on the main path")
    log("main path checks: 2^20 root == hashlib, {} audit paths verified, "
        "{} tampered requests rejected ({:.1f} s)".format(
            len(replies), len(bad), time.perf_counter() - t0))

    # ---------- 4. kernels vs plain and times at the main path's shapes
    # The inputs of the main path's launches, rebuilt from its own data:
    # the deduplicated verify batch padded as verify_batch_async pads it,
    # the 2^20 recovered leaves, the first tree level (pairs of the leaf
    # digests) and the two staged 3PC batches (the committed blobs).
    t0 = time.perf_counter()
    items = []
    for r in reqs:
        items.extend(nodes[0]._verify_items(Request(**r))[0])
    lanes = ed.launch_lanes(len(items))
    arrays, _ = ed.host_pack(*[list(c) for c in zip(*items)])
    arrays = [np.concatenate([a, np.repeat(a[:1], lanes - len(items), 0)])
              for a in arrays]
    ed_main = [to_tensor(a, dev) for a in arrays]
    ed_ms, ok_kernel = cuda_ms(torch, lambda: ed.verify_cuda(*ed_main), 20)
    ed_plain_ms, ok_plain = cuda_ms(torch,
                                    lambda: ed.verify_plain(*ed_main), 1)
    ed_err = max(ed_err, int((ok_kernel.int() - ok_plain.int()).abs().max()
                             .item()))
    check(ed_err == 0, "ed25519 kernel verdicts equal the plain version's "
                       "at the main path's {} lanes".format(lanes))
    ed_bound_ms, ed_bound_by = bound(lanes * ED25519_MULS_PER_VERIFY,
                                     lanes * ED25519_BYTES_PER_SIG)

    words, nvalid, nblocks = sha.pad_messages([b"\x00" + b for b in blobs])
    sha_main = [to_tensor(words, dev), to_tensor(nvalid, dev)]
    del words
    sha_ms, dk = cuda_ms(torch, lambda: sha.sha256_blocks_cuda(*sha_main), 10)
    sha_plain_ms, dp = cuda_ms(
        torch, lambda: sha.sha256_blocks_plain(*sha_main), 1)
    sha_err = max(sha_err, u32_max_abs_err(torch, dk, dp))
    blocks = int(nvalid.astype(np.int64).sum())
    # each hashed block read once, nvalid read and the digest written once
    sha_bound_ms, sha_bound_by = bound(blocks * SHA256_OPS_PER_BLOCK,
                                       blocks * 64 + (4 + 32) * LEDGER_TXNS)
    leaf_digests = sha.digests_to_array(dk.cpu().numpy().view(np.uint32))
    level_pairs = to_tensor(leaf_digests.reshape(-1, 64), dev)
    level = [sha._node_words_from_digest_pairs(level_pairs),
             torch.full((LEDGER_TXNS // 2,), 2, dtype=torch.int32,
                        device=dev)]
    sha_level_ms, dk = cuda_ms(torch,
                               lambda: sha.sha256_blocks_cuda(*level), 10)
    sha_err = max(sha_err, u32_max_abs_err(
        torch, dk, sha.sha256_blocks_plain(*level)))
    staged = []
    for lo in range(0, len(replies), Config.Max3PCBatchSize):
        hi = min(lo + Config.Max3PCBatchSize, len(replies))
        staged.append([b"\x00" + ledger._store.get(_seq_key(LEDGER_TXNS + i))
                       for i in range(lo + 1, hi + 1)])
    for msgs in staged:
        w_b, nv_b, _ = sha.pad_messages(msgs)
        w_b, nv_b = to_tensor(w_b, dev), to_tensor(nv_b, dev)
        sha_err = max(sha_err, u32_max_abs_err(
            torch, sha.sha256_blocks_cuda(w_b, nv_b),
            sha.sha256_blocks_plain(w_b, nv_b)))
    check(sha_err == 0, "SHA-256 kernel equals the plain version at the "
                        "main path's shapes")
    log("kernel == plain at the main path's shapes: ed25519_verify B={} "
        "({} signatures); sha256_compress on the {} leaves x {} blocks ({} "
        "blocks hashed), the first tree level of {} pairs and the staged "
        "batches of {} leaves ({:.1f} s)".format(
            lanes, len(items), LEDGER_TXNS, nblocks, blocks,
            LEDGER_TXNS // 2, [len(m) for m in staged],
            time.perf_counter() - t0))
    log("plain version, not a yardstick: ed25519 {:.3f} ms, sha256 {:.3f} "
        "ms — card {}".format(ed_plain_ms, sha_plain_ms, card))
    ed_micro_ms, _ = cuda_ms(torch, lambda: ed.verify_cuda(*ed_in), 5)
    log("other shapes: ed25519_verify B={} {:.3f} ms; sha256_compress on "
        "{} node pairs (the first tree level) {:.3f} ms".format(
            MICRO_BATCH, ed_micro_ms, LEDGER_TXNS // 2, sha_level_ms))

    if profile:
        where_the_time_goes(torch, run_main_path)

    kernels = [
        {"name": "ed25519_verify", "route": "cuda",
         "source": "plenum_tpu_torch/csrc/ed25519_verify.cu",
         "replaces": "plenum_tpu/ops/ed25519_pallas.py:339",
         "launches": launches["ed25519_verify"], "max_abs_err": ed_err,
         "ms": ed_ms, "plain_ms": ed_plain_ms, "bound_ms": ed_bound_ms,
         "bound_by": ed_bound_by, "library_ms": None},
        {"name": "sha256_compress", "route": "cuda",
         "source": "plenum_tpu_torch/csrc/sha256.cu",
         "replaces": "plenum_tpu/ops/sha256_pallas.py:74",
         "launches": launches["sha256_compress"], "max_abs_err": sha_err,
         "ms": sha_ms, "plain_ms": sha_plain_ms, "bound_ms": sha_bound_ms,
         "bound_by": sha_bound_by, "library_ms": None},
    ]
    log("total: {:.1f} s".format(time.perf_counter() - t_all))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
