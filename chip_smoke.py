#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (plenum_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run it from the root of a checkout: it builds the CUDA kernels from
plenum_tpu_torch/csrc/ into plenum_tpu_torch/_build/ and then

1. prints the card's name and power limit, the build time and ptxas's
   registers, stack and spills per kernel, and one {"native": ...} line:
   the port's native host branches (csrc/fastpath.c, rlp_c.c and mpt_c.c
   as CPython extensions, csrc/kvlog.c through ctypes, each built by
   ops/cuda_lib.py at the package's first import), each one's backend
   ("native" or "python"), the trie class PruningState chose, the store
   class bootstrap chose, each source's compile time and whether Python.h
   was found; kvlog must load, and the three extensions must load where
   Python.h is;
2. holds each kernel against its plain PyTorch version on the card:
   ed25519 verify (four lanes per signature) on 16,384 signatures that mix
   valid ones with every rejection path, on its first 1, 3, 5, 127, 129
   and 2,001 rows (ragged tails of the lane groups), and a 512-signature
   subset against the RFC 8032 scalar verify; SHA-256's ragged entry
   (raw bytes, padded on the card) and its pre-padded entry on ragged
   messages at B = 1023/1024/1025, and the pre-padded entry on 2^20 node
   pairs (all against hashlib too); the Merkle level entry
   (sha256_node_levels) on every level above 1, 2, 3, 511, 512, 513,
   1,023, 1,024, 1,025, 4,095, 4,097 and 2^18 ± 1 digests (across its
   CTAs' 512 children and its launches' nine levels) against its plain
   version and hashlib; the append entry (sha256_append_levels, through
   DeviceMerkleTree.append_leaf_hashes, one sha256_append_groups call an
   append) on appends of 1, 2, 3, 255, 256, 257, 1,023, 1,025 and 4,097
   leaves onto trees of 2^12 ± 1 leaves with K = 1, 4, 9 and 16 levels a
   group (16: groups split into launches of nine), every complete node
   against its plain version (the same append on the CPU from the same
   levels) and hashlib; SHA-256's ragged, level, append and compress
   wrappers called under torch.cuda.set_sync_debug_mode("error"), and
   invalid offsets raising ValueError at the ragged entry's host copy;
   then the ceilings of plenum_tpu_torch/sha256_ceilings.py measured on
   the card (the compression's integer mix with its adds as IADD3 and as
   IMAD, each opcode's rate alone, one node hash's latency, an empty
   launch, sha256_compress in both routings of its adds and its SASS by
   pipe), printed as one JSON line;
   The SHA3-256 kernel's two entries (digests, and the fused compare
   against refs), each in both layouts (five lanes and one lane per
   message), against their plain version and hashlib at B = 1, 4, 5, 6,
   7, 31, 32, 33, 127, 129 and 2,001 on messages of 0 to ~530 bytes (the
   absorb boundaries 135/136/137 and 271/272 among them), with one
   corrupted ref that must give False; both wrappers called under
   torch.cuda.set_sync_debug_mode("error") (neither may synchronise);
   negative, decreasing and past-the-data offsets raising ValueError at
   the host copy, and a good launch after them; ptxas must give the
   SHA3 kernels no stack frame;
3. drives the ledger path: a domain ledger of 2^20 NYM txns recovered
   with Ledger.recoverTreeFromTxnLog (root checked against hashlib),
   2,000 signed NYM requests (1% tampered) authenticated by four
   CoreAuthNrs sharing one CoalescingVerifierHub, the accepted ones
   staged in 3PC batches of Config.Max3PCBatchSize (1,000) and committed,
   and every reply's audit path checked on the host;
4. holds each kernel against its plain version again at the ledger
   path's own shapes (the 2,000-signature verify batch, the 2^20 leaves,
   the 20 tree levels above them, the staged batches) and times both
   there (and the verify kernel at 16,384 signatures too). The 2^20 level
   build is held against the step it replaced (each level of 256 pairs or
   more copied to the card, its words built by
   _node_words_from_digest_pairs, sha256_compress, a copy back; hashlib
   below), level by level and, as a SHA-256 of all 2^20 - 1 entries,
   against the recovered ledger's hash store; the two are timed in turns
   (old, new, new, old; host wall) and once each under torch.profiler
   (device time by kernel and copy), the new kernel alone per launch;
5. drives the pool path at the headline's shape (bench.py run_pool over
   make_sim_pool): four Nodes on SimNetwork and MockTimer sharing one
   CoalescingVerifierHub order 4,000 signed NYM writes sent in client
   chunks of 2,000 (Max3PCBatchSize 2,000) with 20 tampered requests
   among them, through dispatch_client_batch / conclude_client_batch,
   service() and the timer, then serve 4,000 GET_NYM reads of the
   written DIDs with state proofs from one node. It checks the ordered
   count on every node, equal ledger and state roots across the nodes,
   the domain root against hashlib, the domain state root against a
   host-only trie fed the same writes, the nacks, and the reads. The
   pool's writes then run once more in a child process
   (`chip_smoke.py --pool-turn`) with PLENUM_TPU_NO_NATIVE=1, on the
   port's pure-Python host branches: both turns print wall, ordered
   req/s and ORDERED_E2E_MS p50/p99, and their domain, audit and state
   roots must be equal (under --profile each side's writes run once more
   under cProfile for a host table by area);
6. holds ed25519 verify and SHA-256's ragged entry against their plain
   versions (and hashlib) on the pool's own launches — the hub's
   deduplicated batches, the ledgers' staged leaf batches and tree
   levels — and both SHA3 entries against theirs and hashlib on every
   state level the pool hashed on the card. Both SHA3 entries are timed
   at the pool's largest hashed and verified levels and at 65,536 rows
   drawn from them: the kernel alone (CUDA events over 50 back-to-back
   launches, inputs on the card) and the round trip (host clock over the
   ops/trie.py dispatch and collect, its result checked against
   hashlib at every shape), each beside its bound;
7. drives the headline deployment (bench.py run_multiprocess_pool, through
   plenum_tpu_torch.testing.mp_pool): four node processes
   (python -m plenum_tpu_torch.start_node --device cuda) from a pool
   directory of keys and genesis, over TCP with the encrypted transport,
   each signing its state roots with BLS (the native C build of
   csrc/bls12_381.c), order signed NYM writes, the runs in turns:
   "remote" (3,000 writes, bench.py's 4,000 cut so that phase 8 fits the
   script's time; a verify daemon process on the card verifies
   every node's client signatures with ed25519_verify), "cpu" (1,000;
   each node verifies on its own, RFC 8032 on the host), "remote",
   "cpu", the client sending in bench.py's order (one node all the
   requests, then the next); then "remote" and "cpu" once more with the
   client's second order ("broadcast": each request to every node before
   the next). Before the first
   remote pool starts, the 16,384-signature set goes through the daemon
   and its verdicts must equal verify_plain's on the card. Every run must
   see every node reply to every write, equal domain, audit and state
   roots on the four nodes (read back from their data directories),
   domain and state roots equal to a replay of the committed txns on the
   host (the port's Ledger with hashlib leaves and its host trie, no
   kernel), and a
   BLS multi-signature on each node's latest state root that verifies
   under the pool's keys; each node process must run on the card and
   choose KeyValueStorageNative through bootstrap, and in
   the remote runs launch sha256_ragged and sha3_ragged, the daemon
   ed25519_verify. It prints each run's wall and ordered requests/s, the
   daemon's launches and their sizes and each node process's device and
   launches; under --profile, node Alpha of the first remote and cpu
   runs runs under cProfile and its host time is printed by module.
   Then one more remote run: the port's NetworkedPoolClient sends 500
   writes (signed by the trustee's wallet) to the four node processes
   and confirms each on f + 1 matching replies; it prints the run's
   wall, req/s and redials (its 3PC batches stay below
   SHA256_BATCH_THRESHOLD, so its kernel is the daemon's ed25519). The
   nodes dump their validator info every second in every run, and each
   node's last dump (after the audit ledgers settle) must give the
   domain size and the replay's domain and state roots, and the
   genesis' pool counts.
   Process logs go to chiprun_out/mp_logs/.
8. drives catchup seeding from the card: the ledger path's 2^20 NYM txns
   recovered into a new domain ledger, its device Merkle tree attached
   with warm=True (one build of the 2^20 leaf digests on the card), a
   CatchupReq for its last 2,048 txns (the first serving call: it
   mirrors the top levels on the host), then 1,706 txns (the pool's
   clamped 3PC batch) staged and committed one by one, and a CatchupReq
   for the last 32,768 txns up to 2^20 + 1,706 served by the port's
   SeederService: its sync appends the 1,706 leaves (capacity 2^20 →
   2^21, mirrors kept; sha256_append_levels) and its 16 groups of 2,048
   proofs go through ProofPipeline. Every rep of both requests must be
   byte-equal (msgpack) to a second seeder's whose ledger has no engine
   (the host memo path), every audit path verify under MerkleVerifier
   against the root at 2^20 + 1,706, and the device tree's root equal the
   host tree's; the append's launches equal their plain version and
   hashlib. It prints the warm build's wall, proofs per second on the
   device path and the host memo path timed in turns (device, host, host,
   device), the append's kernel-alone time beside its bound and its
   latency floor (its levels times one node hash's latency, plus its
   launches times an empty launch's, both from the ceilings), the latency
   of one level, the proof gather's device time, the tree's dispatch
   stats and the launches.

9. drives the BLS12-381 kernels of csrc/bls381.cu, bls381_agg.cu and
   bls381_msm.cu (phase "bls", after
   phase 8): BASELINE.json's config 3 at its published sizes, n = 4, 25
   and 100 validators from seeded keys: 256 jobs x 100 shares through the
   G1 aggregate (bench.py micro_bls's shape; held against
   g1_aggregate_compressed), the public keys of n = 4/25/100 through the
   G2 aggregate (held against the host sums), 10,000 state-proof commits
   at n = 100 (distinct roots from the seed; each multi-signature is
   (sum of sk) * H(m), the first 16 held equal to create_multi_sig of
   their 100 shares) with seven adversarial checks through one
   verify_multi_sigs_batch launch of the pairing kernel (its host
   pre-checks, dispatch and collect timed apart; honest verdicts all True,
   the adversarial ones the scalar path's), and bls_ops.g1_msm at 8 and
   4,096 points (held against the host double-and-add); then the read
   path: a BLS pool of four nodes on the card (make_sim_pool with
   signers) orders 4,000 signed NYM writes in two chunks of 2,000, after
   each one node serves 2,000 GET_NYM reads and the port's
   PoolClient.check_proof_dicts checks their state proofs in one call
   (every verdict None, two roots), and 16 tampered replies (a flipped
   multi-signature, a wrong value, a wrong root) fail with the JAX
   package's messages. Each kernel is then held against its plain
   version on the path's own inputs (for the verify launch: its
   adversarial rows and 1,024 seeded honest jobs) and on the adversarial
   pairing jobs of tests/test_bls381_pairing.py, timed (cuda_ms and the
   kernel alone) beside its bound, and the four dispatches are called
   under torch.cuda.set_sync_debug_mode("error"). Each kernel must have
   launched on config 3's path and bls_pairing on the read path; each
   entry gives both paths' launches ("launches_by_path"), and its bound
   counts the least work of the function (ops/bls381.py COST). The
   phase also measures the field core (plenum_tpu_torch/bls_field_core:
   one Montgomery multiply's and squaring's latency on one thread, their
   rate across the card, every chain checked against Python integers,
   one {"bls_field_core": ...} line), times the verify launch's three
   kernels apart (lines and G1 decompression, Miller, final
   exponentiation: "kernel_ms_per_launch") and the verify's own launch
   between CUDA events ("verify_launch_ms", beside its collect), and a
   node's share unroll at n = 4 (four jobs of two pairs) on the kernel
   and on the host library ("unroll_4_jobs"). The aggregates (each
   distinct point decompressed once, sums on sextets, one inversion
   by safegcd a job) are also held against their plain versions on
   adversarial sets (a point repeated within and across jobs, all
   infinity, an empty job, an undecodable encoding shared by two jobs, P
   + (-P), an off-curve x, n = 1, more distinct points than a block of
   the decompression launch holds, and for G2 the sign rule's points);
   their three launches are timed apart ("kernel_ms_per_stage": prep,
   sum, store) beside a latency floor ("floor_ms": the critical path's
   multiplies and squarings at this run's field-core latencies, one
   inversion's, three empty launches'); the field core line gives one
   inversion's latency by safegcd and by Fermat; and the host library's
   g1_aggregate_compressed on the same 256 jobs ("host_library_ms") sits
   beside aggregate_g1_jobs's wall split into pack, kernel and collect
   ("wall_ms").
10. drives the pipelined pool (phase 10, pipeline_phase): the pool path's
   4,000 writes and 20 tampered ones in chunks of 2,000, with its
   settings and the flat wire, in one process, twice in turns: with
   PIPELINE_ENABLED and SANITIZER_ENABLED (each node parses the wire and
   pre-screens propagated signatures on its parse worker, fans host-trie
   merges over its execution pool, and arms the ownership sanitizer),
   then with both off; then the pipelined turn once more under
   torch.cuda.set_sync_debug_mode("warn"). The roots must be equal
   across the nodes and between the turns, every tampered request
   nacked, ed25519_verify, sha256_ragged and sha3_ragged launched in the
   pipelined turn, every kernel dispatch and every synchronizing CUDA
   call on the thread that services the nodes, and no sanitizer
   violation. Each turn prints its wall, ordered req/s, ORDERED_E2E_MS
   p50/p99 and the PIPELINE_PARSE_MS, PIPELINE_PRESCREEN_MS and
   PIPELINE_QUEUE_WAIT_MS p50/p99;
11. drives the gateway tier open-loop (phase 11, gateway_phase, through
   plenum_tpu_torch.testing.gateway_load) at bench.py
   gateway_open_loop's defaults: 4 BLS nodes on the card, Poisson
   arrivals at 600 requests per simulated second for 8 simulated seconds
   (30% reads, 80% of them on 16 hot keys; 2% retries; 10% of writes
   update a hot key), ticks of 0.05 s, envelopes of 64 requests from 4
   senders, plus 20 writes with bad signatures; the gateway's pre-screen
   hub on the card. Every node's domain and state roots must be equal,
   and equal to a fresh pool's fed the forwarded stream; every bad
   signature rejected and never written; bench.py gateway_gate's
   conditions must hold; the gateway hub must have launched
   ed25519_verify, and every verify batch of the path equal verify_plain.
   It prints p50, p99 and p999, shed %, cache-hit %, dedup hits, admitted
   and ordered writes, the wall and the launches.
12. drives Byzantine pools on the card (phase 12, adversary_phase, through
   plenum_tpu_torch.testing.byzantine and the adversary harness): 12a,
   bench.py bench_recovery at its sizes (25 nodes, network seed 77,
   adversary seed 7, its Config and SLOs; the port's default verifier
   where bench.py names "cpu"): failover under a silent primary, the
   ex-primary's catchup, a laggard's catchup under a garbling and a
   stalling seeder while a third peer churns; no liveness or invariant
   violation, the liar among the bad peers, the laggard's domain ledger
   equal to the target's, the honest roots equal; it prints the sim-second
   latencies beside the SLOs (a miss is printed as a finding), the trace
   events, ordered p50/p99, the wall and the launches (none: six writes
   stay below the hub's threshold). 12b, 25 BLS validators (Max3PCBatchSize
   50) under PoisonedBlsShare and TamperedPropagate order 200 writes sent
   to every node in chunks of 50 (cut from 400, ATTACK_WRITES): every
   write ordered on every honest node with equal domain and state roots,
   no tampered request written,
   every ordered batch multi-signed with nothing left to backfill, the
   strict window engaged, bls_pairing launched from the nodes' share
   unrolls, the first device-sized unroll's verdicts equal to the host
   library's per-share verify_sig and its pairing launch to the plain
   version, every distinct ed25519 batch equal to verify_plain; it
   prints the launches, the verify batches' sizes, the unrolls' shares,
   the pairing's jobs per launch and the wall.
13. drives the device-mesh dispatcher (phase 13, mesh_phase, through
   plenum_tpu_torch/ops/mesh.py), after the deployment. 13a: the card's
   own mesh (its devices and platform, the card count, and the process
   mesh's stats after every earlier path: on one card every dispatch
   passed through) and bench.py micro_mesh's overhead gate: verify_batch
   on 8,192 signatures (seed 11, 256 keys) with the mesh consulted and
   passing through against the mesh disabled, interleaved best of 3,
   printed beside the 5% gate as one {"mesh_overhead": ...} line and
   not failed on. 13b: the card repeated 2 and 4 times as the mesh's
   device list (shard_min 1, min_per_device 1), each entry on a stream
   of its own: ed25519 on phase 2's 16,384-signature adversarial set and
   at 8,192, the verify daemon's bucketed verify, the G1 aggregate on
   config 3's 256 x 100 jobs, the pairing on config 3's jobs, the Merkle
   build of the 2^20 ledger from raw leaves and from digests then an
   append of 1,706 leaves, a 2,048-proof gather, and the trie's hash and
   verify levels at the pool's 1,706 and 3,177 rows. Each seam's output
   must equal, byte for byte, its unsharded launch (the mesh disabled)
   and its host oracle (RFC 8032, the host BLS library and
   pairing_job_host, hashlib, MerkleVerifier), each kernel's launches
   (zeroed before the sharded run, read after it) equal the shards (the
   level kernel's: the shards' launches plus the top levels'), and the
   mesh count one sharded dispatch of the padded size's share a device;
   each seam's wall sharded and unsharded is printed. 13c: on a machine
   with two or more cards the same over the real cards and micro_mesh's
   weak-scaling sweep ({"mesh_weak_scaling": ...}); with one card, one
   line that says the multi-card run was not made and why. The process
   mesh is restored after the phase.
14. runs the port's lint (lint_phase, right after phase 9): the analyzer
   (python -m plenum_tpu_torch.analysis, every rule over the whole
   package against plenum_tpu_torch/lint_baseline.json) runs in a child
   process started after the build, and its result is printed as one
   {"lint": {"files", "new", "baselined", "s", "cpu_s"}} line (the
   analyzer's own seconds); any finding outside the baseline fails the run. Then PT002's
   check on the card: a copy from pageable memory must raise
   under torch.cuda.set_sync_debug_mode("error"); the analyzer's list of
   ops/ dispatch halves must equal LINT_HALVES (twelve); each half runs
   once on the card in that mode (phase 9's four BLS halves there, on
   its config's inputs; the other eight here, on 64 rows, the Merkle
   halves on a 4,096-leaf tree after its one mirror download), is
   collected by its own collect half and must equal the same call on the
   CPU (the plain versions). Its launches are comparisons and count on
   no path.

Then it prints {"kernels": [...]}, the card line and, last, {"ok": true,
"device": {...}}. Every entry's "ms" is cuda_ms, one definition for all
eleven; the SHA3 entries also carry "kernel_ms" and "round_trip_ms" at the
pool's shape, sha256_append_levels "kernel_ms", "floor_ms" and
"level_latency_ms" at phase 8's append, sha256_compress, sha256_ragged and
ed25519_verify "kernel_ms" at their timed shapes (the kernel alone, as
kernel_ms times it).

Each path's kernel launch counters are zeroed just before it and read
just after; every kernel of a path must have launched in it (a node
process or the daemon starts at zero, and the daemon's counters are
zeroed after its check; phase 12a, a host path, claims none). The
kernels line gives each kernel's launches over all the paths (those of
phases 10, 11, 12a, 12b and 13 also apart, in "launches_by_path"); the BLS
entries carry "kernel_ms", "plain_ms" on the inputs they were held on,
and their Montgomery multiplies.

Any failed check raises, so the script exits non-zero and prints no
result; so does a machine without CUDA, or a directory that holds this
script and nothing else of the repository. The tolerance is none
everywhere: verdicts, digests and roots must be equal.
"""
import atexit
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
SHA_BOUNDARY_LENGTHS = (0, 55, 56, 63, 64, 119, 120)
ED25519_TAILS = (1, 3, 5, 127, 129, 2001)   # batch sizes off the 32-row block
NODE_PAIRS = 1 << 20
LEDGER_TXNS = 1 << 20        # bench.py micro_merkle's ledger size
CLIENT_BATCH = 2000          # bench.py CLIENT_BATCH: one client batch
BAD_REQUESTS = CLIENT_BATCH // 100
N_NODES = 4
TXN_TIME = 1700000000
POOL_REQS = 4000             # bench.py POOL_REQS
POOL_BAD = 20                # tampered requests, spread over the chunks
MP_REQS = 3000               # the deployment's writes (bench.py POOL_REQS
                             # is 4,000; cut so that phase 8 fits the
                             # script's time; at 1,500 a node's batches can
                             # all stay below SHA256_BATCH_THRESHOLD, off
                             # the card)
MP_CPU_REQS = 1000           # the "cpu" side's writes: at 4,000 a node's
                             # verify of one intake batch, then in pure
                             # Python, blocked it past the peers' 10 s
                             # heartbeat
MP_TIMEOUT_S = 600
ATTACK_NODES = 25            # BASELINE.json configs 3 and 5: 25 validators
ATTACK_WRITES = 200          # phase 12b's writes (cut from 400: from the
                             # third chunk the poisoner's strict-mode
                             # suspicions drive view changes, as in the JAX
                             # package on the same pool, that double each
                             # chunk's wall; 400 took over 20 min on an
                             # H100's host), in chunks of
ATTACK_CHUNK = 50            # 50 (>= the hub's threshold of 32; the
                             # pool's Max3PCBatchSize, byzantine.ATTACK_CONF)
NETWORKED_WRITES = 500       # phase 7's NetworkedPoolClient run
INFO_DUMP_S = 1.0            # the deployment nodes' validator-info interval
GATEWAY_BAD = 20             # bad-signature writes added to the gateway
                             # path's schedule (phase 11)
# the five-lane groups' and the warps' boundaries (six messages a warp of
# groups, 32 a warp of threads), and a ragged tail of both
SHA3_BATCHES = (1, 4, 5, 6, 7, 31, 32, 33, 127, 129, 2001)
SHA3_LENGTHS = (0, 135, 136, 137, 271, 272, 530)
# the throughput shape: 32 x the JAX package's MESH_SHARD_MIN (2,048), the
# level size from which it treats a level as large
SHA3_WIDE_ROWS = 65536
# children below sha256_node_levels: a CTA's 512, a launch's nine levels
# (2^10 children before a second launch) and 2^k +- 1 around them
NODE_LEVEL_COUNTS = (1, 2, 3, 511, 512, 513, 1023, 1024, 1025, 4095, 4097,
                     (1 << 18) - 1, (1 << 18) + 1)
LEDGER_LEVELS = LEDGER_TXNS.bit_length() - 1
# appends held against the plain version and hashlib: around a warp, a
# CTA's 256 level-1 parents and its 512 children, onto 2^12 +- 1 leaves
APPEND_BASES = ((1 << 12) - 1, (1 << 12) + 1)
APPEND_BATCHES = (1, 2, 3, 255, 256, 257, 1023, 1025, 4097)
APPEND_GROUP_LEVELS = (1, 4, 9, 16)   # K: 16 splits a group into launches
COMMIT_BATCH = 1706          # the pool's 3PC batch, clamped by the frame
CATCHUP_TAIL = 32768         # txns a lagging node asks a seeder for

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
# Keccak-f[1600], per absorbed 136-byte block, in the fewest Hopper
# instructions (csrc/sha3.cu keeps 64-bit lanes, two 32-bit halves each):
# a round is theta (5 column parities of 5 lanes: 2 three-input xors a
# half = 20; 5 D lanes, a 1-bit rotation as 2 funnel shifts and an xor a
# half = 20; 25 lanes xored with D = 50), rho (24 rotations, 2 funnel
# shifts each = 48), chi (one LOP3 a half = 50) and iota (2); then the
# absorb xors 17 lanes (34).
KECCAK_OPS_PER_BLOCK = 24 * (20 + 20 + 50 + 48 + 50 + 2) + 17 * 2
LINT_TIMEOUT_S = 300         # the analyzer's child process (lint_phase)
LINT_ROWS = 64               # each dispatch half's batch in lint_phase
LINT_TREE = 1 << 12          # leaves of lint_phase's Merkle trees
# the dispatch halves lint_phase holds to no host sync on the card: the
# port's analyzer (PT002) must name exactly these, so a new half fails
# the run until the phase checks it
LINT_HALVES = (
    "ops/bls381.py:aggregate_dispatch",
    "ops/bls381_pairing.py:pairing_dispatch",
    "ops/bls381_pairing.py:msm_dispatch",
    "ops/bls381_pairing.py:g2_aggregate_dispatch",
    "ops/ed25519.py:verify_batch_async",
    "ops/merkle.py:DeviceMerkleTree.dispatch_proof_batch",
    "ops/merkle.py:DeviceMerkleTree.dispatch_path_batch",
    "ops/mesh.py:DeviceMesh.dispatch",
    "ops/sha256.py:sha256_many_dispatch",
    "ops/sha256.py:TorchSha256Backend.leaf_hashes_dispatch",
    "ops/trie.py:dispatch_node_hash_batch",
    "ops/trie.py:dispatch_node_verify_batch",
)
# the analyzer's child: its JSON report, its exit code and its own
# seconds (wall and CPU) as one JSON line
LINT_CHILD = """\
import contextlib, io, json, sys, time
t0, c0 = time.perf_counter(), time.process_time()
from plenum_tpu_torch.analysis import cli
out = io.StringIO()
with contextlib.redirect_stdout(out):
    rc = cli.main(["--json", sys.argv[1]])
print(json.dumps({"rc": rc, "report": json.loads(out.getvalue()),
                  "s": time.perf_counter() - t0,
                  "cpu_s": time.process_time() - c0}))
"""


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


def once_ms(torch, fn):
    """(device milliseconds of one call of fn, from CUDA events; its
    result): the plain versions' time, which is no yardstick of speed,
    taken once and cold."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def bound(ops, nbytes):
    """(least milliseconds, what bounds them) for `ops` 32-bit integer
    operations and `nbytes` bytes moved."""
    t_ops, t_bytes = ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def u32_max_abs_err(torch, a, b):
    mask = 0xFFFFFFFF
    return int(((a.long() & mask) - (b.long() & mask)).abs().max().item())


def device_time(torch, fn):
    """Run fn once under torch.profiler → ({kernel or copy name: (device
    microseconds, count)}, wall microseconds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    t0 = time.perf_counter()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        fn()
    wall_us = (time.perf_counter() - t0) * 1e6
    busy = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, count = busy.get(e.name, (0.0, 0))
            busy[e.name] = (us + e.time_range.elapsed_us(), count + 1)
    return busy, wall_us


def hashlib_levels(digests, levels):
    """The `levels` RFC 6962 levels above `digests` ([n, 32] uint8) with
    hashlib, each level's digests joined."""
    out, cur = [], [bytes(r) for r in digests]
    for _ in range(levels):
        cur = [hashlib.sha256(b"\x01" + cur[2 * i] + cur[2 * i + 1]).digest()
               for i in range(len(cur) // 2)]
        out.append(b"".join(cur))
    return out


def where_the_time_goes(torch, run_main_path, label):
    """Run a path once more under torch.profiler (device busy time per
    kernel and the device's idle share of the wall time) and once under
    cProfile (host functions by own time, and own time by package area)."""
    import cProfile

    traced, wall_us = device_time(torch, run_main_path)
    busy = {name: us for name, (us, _) in traced.items()}
    if busy:
        total = sum(busy.values())
        log("profile {}: device busy {:.3f} ms of {:.3f} ms wall, idle "
            "share {:.6f}".format(label, total / 1e3, wall_us / 1e3,
                                  1 - total / wall_us))
        for name, us in sorted(busy.items(), key=lambda kv: -kv[1])[:8]:
            log("  device {:.3f} ms  {}".format(us / 1e3, name[:90]))
    else:
        log("profile {}: device time not measured (no device events "
            "traced)".format(label))
    prof_host = cProfile.Profile()
    prof_host.enable()
    run_main_path()
    prof_host.disable()
    host_table(prof_host, label, depth=2)


def host_table(source, label, depth):
    """Print a cProfile run's (a Profile, or the file it was dumped to)
    host functions by own time, then its own
    time by package area: the first `depth` parts of the path under the
    repository (2: plenum_tpu_torch/<package>, 3: down to the module).
    Time the process spent waiting in select/epoll is shown apart."""
    import io
    import pstats
    out = io.StringIO()
    stats = pstats.Stats(source, stream=out)
    stats.sort_stats("tottime").print_stats(14)
    log("profile {}: host functions by own time (under cProfile)".format(
        label))
    for line in out.getvalue().splitlines():
        if line.strip():
            log("  " + line.rstrip())
    areas, waiting = {}, 0.0
    for (path, _, name), (_, _, tottime, _, _) in stats.stats.items():
        if "poll" in name and ("epoll" in name or "select" in name):
            waiting += tottime
            continue
        rel = os.path.relpath(path, REPO) if path.startswith(REPO) else ""
        parts = rel.split(os.sep)
        area = os.sep.join(parts[:depth]) \
            if parts[0] == "plenum_tpu_torch" \
            else "other (stdlib, torch, builtins)"
        areas[area] = areas.get(area, 0.0) + tottime
    total = sum(areas.values())
    log("profile {}: host own time by area, {:.3f} s in all (and {:.3f} s "
        "waiting in select/epoll)".format(label, total, waiting))
    for area, t in sorted(areas.items(), key=lambda kv: -kv[1])[:12]:
        log("  {:.3f} s  {:.4f}  {}".format(t, t / total, area))
    return areas, waiting


def sha3_phase(torch, dev):
    """Both SHA3-256 entries, in both layouts (five lanes and one lane per
    message), against their plain version and hashlib at B = SHA3_BATCHES
    on messages of SHA3_LENGTHS and random lengths up to 600 bytes; one
    corrupted ref per batch must give False. Then: neither wrapper
    synchronises (set_sync_debug_mode "error"), and offsets that are
    negative, decreasing or past the data raise ValueError at the host
    copy, after which a good launch still equals hashlib. → (largest
    digest byte difference, number of differing verdicts)."""
    import numpy as np
    from plenum_tpu_torch.ops import sha256 as sha
    from plenum_tpu_torch.ops import sha3, to_tensor
    rng = np.random.RandomState(SEED + 3)
    err = eq_err = 0
    for n in SHA3_BATCHES:
        lens = [SHA3_LENGTHS[i % len(SHA3_LENGTHS)] if i % 2
                else int(rng.randint(600)) for i in range(n)]
        msgs = [rng.randint(0, 256, size=ln, dtype=np.uint8).tobytes()
                for ln in lens]
        want = [hashlib.sha3_256(m).digest() for m in msgs]
        data, offsets, refs = sha.upload_ragged(msgs, dev, want)
        dp = sha3.sha3_ragged_plain(data, offsets).cpu().numpy()
        bad = refs.clone()
        bad[n // 2, int(rng.randint(32))] ^= 1 << int(rng.randint(8))
        for lanes in (5, 1):
            dk = sha3.sha3_ragged_cuda(data, offsets, lanes).host()
            err = max(err, int(np.abs(dk.astype(np.int64) - dp).max()))
            check(sha3.digests_to_bytes(dk) == want,
                  "SHA3 kernel ({} lanes) equals hashlib at B={}".format(
                      lanes, n))
            for r, expect in ((refs, [True] * n),
                              (bad, [i != n // 2 for i in range(n)])):
                ok = sha3.sha3_ragged_eq_cuda(data, offsets, r, lanes).host()
                okp = sha3.sha3_ragged_eq_plain(data, offsets, r)
                eq_err += int((ok != okp.cpu().numpy()).sum())
                check(ok.tolist() == expect,
                      "SHA3 fused compare ({} lanes) at B={}: True on the "
                      "refs, False on the corrupted one".format(lanes, n))
    check(err == 0, "SHA3 kernel equals the plain version")
    check(eq_err == 0, "SHA3 fused compare equals the plain version")
    log("sha3: both entries in both layouts == plain == hashlib at B={} "
        "(lengths {} among them); the corrupted ref gives False".format(
            SHA3_BATCHES, SHA3_LENGTHS))

    # no read-back before the launch: the inputs are on the card already
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        launches = [sha3.sha3_ragged_cuda(data, offsets),
                    sha3.sha3_ragged_eq_cuda(data, offsets, refs)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(sha3.digests_to_bytes(launches[0].host()) == want
          and bool(launches[1].host().all()),
          "the launches made under the sync check are right")
    n = len(want)
    cases = {"negative": [-1] + [0] * n,
             "decreasing": [0] * (n - 1) + [data.shape[0], 0],
             "past nbytes": [0] * n + [data.shape[0] + 1]}
    for what, offs in cases.items():
        bad_off = to_tensor(np.asarray(offs, dtype=np.int64), dev)
        for launch in (lambda: sha3.sha3_ragged_cuda(data, bad_off),
                       lambda: sha3.sha3_ragged_eq_cuda(data, bad_off, refs)):
            try:
                launch().host()
            except ValueError as e:
                check("non-decreasing" in str(e), "the offsets' message")
            else:
                raise RuntimeError("check failed: {} offsets raise at the "
                                   "host copy".format(what))
    torch.cuda.synchronize()
    check(sha3.digests_to_bytes(sha3.sha3_ragged_cuda(data, offsets).host())
          == want, "a good launch after the bad offsets equals hashlib")
    log("sha3: neither wrapper synchronises (sync debug mode \"error\"); "
        "{} offsets raise ValueError at the host copy of both entries, and "
        "the card stays usable".format(", ".join(cases)))
    return err, eq_err


def node_levels_phase(torch, dev):
    """sha256_node_levels against its plain version (on the card) and
    hashlib on every level above NODE_LEVEL_COUNTS random digests (levels
    1..floor(log2 n), and one for n = 1, which has no parent), through the
    wrapper and through the array entry (one upload, one copy back). →
    the largest digest byte difference."""
    import numpy as np
    from plenum_tpu_torch.ops import sha256 as sha
    from plenum_tpu_torch.ops import to_tensor
    rng = np.random.RandomState(SEED + 5)
    err = 0
    for n in NODE_LEVEL_COUNTS:
        digests = rng.randint(0, 256, size=(n, 32), dtype=np.uint8)
        levels = max(n.bit_length() - 1, 1)
        d = to_tensor(digests, dev)
        dk = sha.sha256_node_levels_cuda(d, levels)
        dp = sha.sha256_node_levels_plain(d, levels)
        if dk.numel():
            err = max(err, int((dk.int() - dp.int()).abs().max().item()))
        want = hashlib_levels(digests, levels)
        got = sha.sha256_node_levels_array(digests, levels, dev)
        check(dk.cpu().numpy().tobytes() == b"".join(want)
              and [g.tobytes() for g in got] == want,
              "sha256_node_levels equals hashlib at {} children".format(n))
    check(err == 0, "sha256_node_levels equals the plain version")
    log("sha256_node_levels: kernel == plain == hashlib on every level "
        "above {} children".format(NODE_LEVEL_COUNTS))
    return err


def _launch_append(sha, tree, groups, k, fn=None):
    """The append launches of `groups` (ops/merkle.py append_groups, k
    levels a group) on `tree`'s levels in place, in one call of `fn` (the
    grouped CUDA wrapper by default). → its launches."""
    parents = [w for _, group in groups for w in group]
    return (fn or sha.sha256_append_groups_cuda)(
        tree._level(groups[0][0]), [tree._level(lv) for lv, _, _ in parents],
        [(p0, cnt) for _, p0, cnt in parents], k)


def sha256_sync_phase(torch, dev):
    """None of sha256_ragged_cuda, sha256_node_levels_cuda,
    sha256_append_groups_cuda and sha256_blocks_cuda synchronises
    (set_sync_debug_mode "error");
    offsets that are negative, decreasing or past the data raise
    ValueError at the ragged entry's host copy, after which a good launch
    still equals hashlib."""
    import numpy as np
    from plenum_tpu_torch.ops import sha256 as sha
    from plenum_tpu_torch.ops import to_tensor
    from plenum_tpu_torch.ops.merkle import DeviceMerkleTree, append_groups
    rng = np.random.RandomState(SEED + 6)
    msgs = [rng.randint(0, 256, size=int(rng.randint(300)),
                        dtype=np.uint8).tobytes() for _ in range(1025)]
    want = [hashlib.sha256(b"\x00" + m).digest() for m in msgs]
    digests = rng.randint(0, 256, size=(1025, 32), dtype=np.uint8)
    data, offsets = sha.upload_ragged(msgs, dev)
    d = to_tensor(digests, dev)
    # 800 leaves, then 224 more placed in level 0: the append's launches
    tree = DeviceMerkleTree(device=dev)
    tree.build_from_leaf_hashes(digests[:800])
    tree._level(0)[800:1024].copy_(d[800:1024])
    leaves = torch.zeros((1027, 32), dtype=torch.uint8, device=dev)
    words, nvalid, _ = sha.pad_messages(msgs)
    w, nv = to_tensor(words, dev), to_tensor(nvalid, dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rag = sha.sha256_ragged_cuda(data, offsets, 0x00)
        be = sha.sha256_ragged_cuda(data, offsets, 0x00,
                                    out=leaves[1:1026])
        lv = sha.sha256_node_levels_cuda(d, 10)
        _launch_append(sha, tree, append_groups(800, 1024, 4), 4)
        blocks = sha.sha256_blocks_cuda(w, nv)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    top = tree._buf[1024:].cpu().numpy().tobytes()
    check(sha.digests_to_bytes(sha.to_host(rag)) == want
          and be.host().shape == (0, 8)
          and leaves.cpu().numpy().tobytes() == bytes(32) + b"".join(want)
          + bytes(32)
          and lv.cpu().numpy().tobytes() == b"".join(
              hashlib_levels(digests, 10))
          and top == b"".join(hashlib_levels(digests[:1024], 10))
          and sha.digests_to_bytes(blocks.cpu().numpy().view(np.uint32))
          == [hashlib.sha256(m).digest() for m in msgs],
          "the launches made under the sync check are right (the ragged "
          "entry's big-endian store among them)")
    n = len(msgs)
    cases = {"negative": [-1] + [0] * n,
             "decreasing": [0] * (n - 1) + [data.shape[0], 0],
             "past nbytes": [0] * n + [data.shape[0] + 1]}
    for what, offs in cases.items():
        bad = to_tensor(np.asarray(offs, dtype=np.int64), dev)
        try:
            sha.to_host(sha.sha256_ragged_cuda(data, bad, 0x00))
        except ValueError as e:
            check("non-decreasing" in str(e), "the offsets' message")
        else:
            raise RuntimeError("check failed: {} offsets raise at the host "
                               "copy".format(what))
    torch.cuda.synchronize()
    check(sha.digests_to_bytes(sha.to_host(sha.sha256_ragged_cuda(
        data, offsets, 0x00))) == want,
        "a good launch after the bad offsets equals hashlib")
    log("sha256: none of the ragged, level, append and compress wrappers "
        "synchronises (sync debug mode \"error\"); {} offsets raise "
        "ValueError at the ragged entry's host copy, and the card stays "
        "usable".format(", ".join(cases)))


def append_levels_phase(torch, dev):
    """sha256_append_levels (through DeviceMerkleTree.append_leaf_hashes)
    against its plain version and hashlib: appends of APPEND_BATCHES leaves
    onto trees of APPEND_BASES leaves, APPEND_GROUP_LEVELS levels a group;
    the plain version appends on the CPU from the card tree's levels
    before the append (once: its result does not depend on K), and every
    complete node of every level must be equal. → the largest digest byte
    difference between kernel and plain version."""
    import numpy as np
    from plenum_tpu_torch.ops.merkle import DeviceMerkleTree
    rng = np.random.RandomState(SEED + 7)
    err = 0
    for n0 in APPEND_BASES:
        base = rng.randint(0, 256, size=(n0, 32), dtype=np.uint8)
        for b in APPEND_BATCHES:
            app = rng.randint(0, 256, size=(b, 32), dtype=np.uint8)
            n1 = n0 + b
            depth = (n1 - 1).bit_length()
            # the new leaves, then every level's complete nodes
            want = [app.tobytes()] + hashlib_levels(
                np.concatenate([base, app]), depth)
            plain_t = None
            for k in APPEND_GROUP_LEVELS:
                card_t = DeviceMerkleTree(device=dev, fused_levels=k)
                card_t.build_from_leaf_hashes(base)
                if plain_t is None:       # its result does not depend on K
                    plain_t = DeviceMerkleTree(device="cpu", fused_levels=k)
                    plain_t.load_levels(card_t._buf.cpu().numpy(), n0)
                    plain_t.append_leaf_hashes(app)
                card_t.append_leaf_hashes(app)
                got = card_t._buf.cpu()
                for h in range(depth + 1):
                    o, m = card_t._offset(h), n1 >> h
                    lo = o + (n0 if h == 0 else 0)
                    a, p = got[lo:o + m], plain_t._buf[lo:o + m]
                    if m:
                        err = max(err, int((a.int() - p.int()).abs().max()))
                    check(a.numpy().tobytes() == want[h],
                          "sha256_append_levels equals hashlib at level {} "
                          "of {} + {} leaves, K = {}".format(h, n0, b, k))
    check(err == 0, "sha256_append_levels equals its plain version")
    log("sha256_append_levels: kernel == plain == hashlib on every level "
        "of appends of {} leaves onto {} leaves, K = {}".format(
            APPEND_BATCHES, APPEND_BASES, APPEND_GROUP_LEVELS))
    return err


def kernel_ms(torch, fn, reps=50):
    """Device milliseconds per call of fn over `reps` back-to-back calls
    on inputs already on the card, from CUDA events. A sleep kernel holds
    the stream while the host queues the calls, so the events time the
    launches alone and not the host's enqueueing."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def round_trip_ms(fn, reps=20):
    """Median host milliseconds of fn(), a dispatch and its collect, after
    one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return sorted(times)[len(times) // 2]


def sha3_times(torch, dev, blobs, vblobs, vrefs):
    """Both SHA3 entries timed at the pool's largest hashed level `blobs`
    and verified level (`vblobs`, `vrefs`), and at SHA3_WIDE_ROWS rows
    drawn from them (the pool's mix of lengths): the kernel alone
    (kernel_ms, 50 launches) and the round trip through ops/trie.py
    (round_trip_ms of dispatch + collect, the upload included), each
    beside its bound, after one round trip's result is held against
    hashlib at that shape; the plain version at the pool's shapes. →
    {entry: the pool shape's "ms" (cuda_ms, as for every kernel),
    "kernel_ms", "round_trip_ms", "plain_ms", "bound_ms", "bound_by"}."""
    import numpy as np
    from plenum_tpu_torch.ops import sha256 as sha
    from plenum_tpu_torch.ops import sha3
    from plenum_tpu_torch.ops import trie as trie_ops
    rng = np.random.RandomState(SEED + 4)
    staging = sha.PinnedStaging()
    out = {}
    for name, pool_rows, refs in (("sha3_ragged", blobs, None),
                                  ("sha3_ragged_eq", vblobs, vrefs)):
        pick = rng.randint(len(pool_rows), size=SHA3_WIDE_ROWS)
        wide = [pool_rows[i] for i in pick]
        shapes = [("pool", pool_rows, refs),
                  ("wide", wide,
                   None if refs is None else [refs[i] for i in pick])]
        for shape, rows, r in shapes:
            args = sha.upload_ragged(rows, dev, r or ())
            if r is None:
                def kernel(args=args):
                    return sha3.sha3_ragged_cuda(*args)

                def trip(rows=rows):
                    return trie_ops.collect_node_hash_batch(
                        trie_ops.dispatch_node_hash_batch(rows, dev, staging))
                plain = sha3.sha3_ragged_plain
            else:
                def kernel(args=args):
                    return sha3.sha3_ragged_eq_cuda(*args)

                def trip(rows=rows, r=r):
                    return trie_ops.collect_node_verify_batch(
                        trie_ops.dispatch_node_verify_batch(rows, r, dev,
                                                            staging))
                plain = sha3.sha3_ragged_eq_plain
            want = [hashlib.sha3_256(b).digest() for b in rows]
            got = trip()
            if r is None:
                check(sha3.digests_to_bytes(got) == want, "{} equals hashlib "
                      "at {} rows".format(name, len(rows)))
            else:
                check(got.tolist() == [w == x for w, x in zip(want, r)],
                      "{} equals hashlib at {} rows".format(name, len(rows)))
            k_ms = kernel_ms(torch, kernel)
            rt_ms = round_trip_ms(trip)
            blocks = sum(len(b) // 136 + 1 for b in rows)
            nbytes = sum(map(len, rows)) + 8 * (len(rows) + 1) \
                + (32 * len(rows) if r is None else 33 * len(rows))
            b_ms, b_by = bound(blocks * KECCAK_OPS_PER_BLOCK, nbytes)
            log("{} at {} rows ({}, {} blocks, lanes {}): kernel alone "
                "{:.5f} ms, round trip {:.5f} ms; bound {:.6f} ms ({}), "
                "kernel {:.2%} of it".format(
                    name, len(rows), shape, blocks,
                    sha3.lanes_for(len(rows)), k_ms, rt_ms, b_ms, b_by,
                    b_ms / k_ms))
            if shape == "pool":
                ms, _ = cuda_ms(torch, kernel, 20)
                plain_ms, _ = once_ms(torch, lambda: plain(*args))
                log("{} at {} rows: {:.5f} ms a call (cuda_ms, the host's "
                    "enqueueing included, as for every kernel's \"ms\")"
                    .format(name, len(rows), ms))
                out[name] = {"ms": ms, "kernel_ms": k_ms,
                             "round_trip_ms": rt_ms, "plain_ms": plain_ms,
                             "bound_ms": b_ms, "bound_by": b_by}
    return out


def pool_requests(signer):
    """bench.py's headline requests (POOL_REQS NYM writes by one author)
    in chunks of CLIENT_BATCH, and POOL_BAD more whose signatures no
    longer match — half with a changed operation, half with a changed
    signature character — spread over the chunks. → (chunks, the valid
    requests, the tampered reqIds)."""
    from plenum_tpu_torch.testing import pool
    reqs = pool.make_requests(POOL_REQS, signer)
    bad = pool.make_requests(POOL_BAD, signer, first_req_id=POOL_REQS + 1)
    for i, r in enumerate(bad):
        if i % 2:
            r["operation"] = dict(r["operation"], verkey="~" + "1" * 22)
        else:
            sig = r["signature"]
            r["signature"] = sig[:-1] + ("2" if sig[-1] != "2" else "3")
    n_chunks = POOL_REQS // CLIENT_BATCH
    per = POOL_BAD // n_chunks
    chunks = [reqs[i * CLIENT_BATCH:(i + 1) * CLIENT_BATCH]
              + bad[i * per:(i + 1) * per] for i in range(n_chunks)]
    return chunks, reqs, {r["reqId"] for r in bad}


def native_line():
    """The native host branches of this process: each branch's backend
    ("native" or "python"), the trie class PruningState chose, the store
    class bootstrap chose, the compile time of each of the four sources
    (built at the port's first import; null when _build/ held it already)
    and whether Python.h was found. kvlog needs only the C compiler and
    must load; the three extensions need Python.h and must load where it
    is. → the backends."""
    import sysconfig
    from plenum_tpu_torch.bootstrap import native_backends
    from plenum_tpu_torch.ops import cuda_lib
    native = native_backends()
    sources = cuda_lib.HOST_EXT_SOURCES + ("kvlog",)
    build_s = {n: cuda_lib.host_build_seconds.get(n) for n in sources}
    headers = cuda_lib.python_headers()
    include = sysconfig.get_paths()["include"]
    log(json.dumps({"native": dict(
        native, build_s=build_s,
        build_wall_s=sum(v for v in build_s.values() if v is not None),
        python_h=headers, include=include)}))
    check(native["kvlog"] == "native"
          and native["store"] == "KeyValueStorageNative",
          "csrc/kvlog.c builds and bootstrap chooses KeyValueStorageNative")
    if os.environ.get(cuda_lib.NO_NATIVE_ENV):
        log("native: {} is set, so fastpath, rlp_c and mpt_c keep their "
            "Python branches".format(cuda_lib.NO_NATIVE_ENV))
    elif headers:
        check(all(native[n] == "native" for n in cuda_lib.HOST_EXT_SOURCES)
              and native["trie"] == "NativeTrie",
              "fastpath, rlp_c and mpt_c load as the port's extensions and "
              "PruningState chooses NativeTrie")
    else:
        log("native: no Python.h under {}, so fastpath, rlp_c and mpt_c "
            "cannot build here; their Python branches run".format(include))
    return native


def pool_turns(torch, dev, signer, native, profile):
    """The pool's writes with the C host branches (the pool path's own
    run, in this process) and without them (python_pool_turn's child):
    each turn's wall, ordered req/s and ORDERED_E2E_MS p50/p99, and their
    domain, audit and state roots, which must be equal (the C turn's are
    the roots the pool path checked). With `profile`, each side's writes
    run once more under cProfile for a host table by area."""
    if profile:
        import cProfile
        chunks, _, _ = pool_requests(signer)
        prof = cProfile.Profile()
        prof.enable()
        run_pool_writes(torch, dev, chunks)
        prof.disable()
        host_table(prof, "pool writes, C branches", depth=2)
    python = python_pool_turn(profile)
    for name, turn in (("this process", native),
                       ("child, PLENUM_TPU_NO_NATIVE=1", python)):
        log("pool turn, {}: {} writes ordered on every node in {:.3f} s "
            "wall, {:.1f} ordered requests/s; ORDERED_E2E_MS p50 {} p99 {}; "
            "branches {}".format(name, turn["ordered"], turn["wall_s"],
                                 turn["req_s"], turn["ordered_e2e_ms_p50"],
                                 turn["ordered_e2e_ms_p99"],
                                 turn["native"]))
    log("pool turns: wall this process / child {:.4f}; the child process "
        "took {:.1f} s in all; its launches {}".format(
            native["wall_s"] / python["wall_s"], python["process_s"],
            {k: v for k, v in python["launches"].items() if v}))
    check(python["ordered"] == native["ordered"] == POOL_REQS,
          "both pool turns ordered every write")
    check(python["native"]["fastpath"] == python["native"]["rlp_c"]
          == python["native"]["mpt_c"] == "python"
          and python["native"]["trie"] == "Trie",
          "PLENUM_TPU_NO_NATIVE=1 keeps the Python branches")
    check(python["roots"] == native["roots"],
          "the pool's domain, audit and state roots are equal with the C "
          "branches and with the Python branches")


def run_pool_writes(torch, dev, chunks, extra_conf=None):
    """The pool's writes: four nodes (make_sim_pool, one hub on the card,
    `extra_conf` over its settings) order every chunk. → (nodes, what
    each node sent, wall seconds)."""
    from plenum_tpu_torch.testing import pool
    nodes, timer = pool.make_sim_pool(pool.NAMES, "torch_hub", device=dev,
                                      extra_conf=extra_conf)
    # No client transport is attached (as in bench.py's pool, so no node
    # builds Replies for the writes); each node's reply callback collects
    # what it sends: the nacks, then the read replies.
    sent = [[] for _ in nodes]
    for node, out in zip(nodes, sent):
        node._reply_to_client = lambda c, m, out=out: out.append(m)
    per_chunk = [len(c) for c in chunks]
    valid = [CLIENT_BATCH] * len(chunks)

    def expected(injected):
        done = 0
        for n_sent, n_valid in zip(per_chunk, valid):
            if injected >= n_sent:
                injected -= n_sent
                done += n_valid
        return done

    t_w = time.perf_counter()
    pool.pipelined_intake(nodes, timer, chunks, "bench-client",
                          expected=expected)
    deadline = time.perf_counter() + 300
    while time.perf_counter() < deadline and not all(
            nd.domain_ledger.size >= POOL_REQS for nd in nodes):
        for nd in nodes:
            nd.service()
        timer.run_for(0.01)
    torch.cuda.synchronize()
    return nodes, sent, time.perf_counter() - t_w


def node_roots(node):
    """A node's domain, audit and domain state roots."""
    from plenum_tpu_torch.common.constants import (
        AUDIT_LEDGER_ID, DOMAIN_LEDGER_ID)
    db = node.db_manager
    return {"domain": db.get_ledger(DOMAIN_LEDGER_ID).root_hash,
            "audit": db.get_ledger(AUDIT_LEDGER_ID).root_hash,
            "state": db.get_state(DOMAIN_LEDGER_ID).committedHeadHash.hex()}


def pool_turn_line(nodes, writes_s):
    """One pool turn's numbers and roots: wall, ordered req/s,
    ORDERED_E2E_MS p50/p99, the native branches, and node Alpha's domain,
    audit and domain state roots (hex)."""
    from plenum_tpu_torch.bootstrap import native_backends
    from plenum_tpu_torch.testing import pool
    p50, p99, _ = pool.pool_latency_summary(nodes)
    return {"wall_s": writes_s, "req_s": POOL_REQS / writes_s,
            "ordered": min(n.domain_ledger.size for n in nodes),
            "ordered_e2e_ms_p50": p50, "ordered_e2e_ms_p99": p99,
            "native": native_backends(), "roots": node_roots(nodes[0])}


def python_pool_turn(profile):
    """The pool's writes in a fresh child process with
    PLENUM_TPU_NO_NATIVE=1 (the port's pure-Python host branches; the
    kernels and kvlog as before) on the card; with `profile`, the child
    then runs them again under cProfile and its host table is printed
    here. → its pool_turn_line, with the child's launches and its process
    wall."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py"), "--pool-turn"]
        + (["--profile"] if profile else []),
        capture_output=True, text=True, timeout=600, cwd=REPO,
        env=dict(os.environ, PLENUM_TPU_NO_NATIVE="1"))
    if proc.returncode != 0:
        raise RuntimeError("the pool turn without the C branches failed "
                           "(rc {}):\n{}".format(proc.returncode,
                                                 proc.stderr[-4000:]))
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        log(line)
    turn = json.loads(lines[-1])["pool_turn"]
    turn["process_s"] = time.perf_counter() - t0
    return turn


def pool_turn_main(torch, profile):
    """--pool-turn: the pool's writes alone on the card, printed as one
    {"pool_turn": ...} line with the launches this process made; with
    `profile`, first the host table of a second run under cProfile."""
    from plenum_tpu_torch.crypto.signer import SimpleSigner
    from plenum_tpu_torch.ops import launch_counts
    dev = torch.device("cuda")
    signer = SimpleSigner(seed=hashlib.sha256(b"trustee").digest())
    chunks, _, _ = pool_requests(signer)
    nodes, _, writes_s = run_pool_writes(torch, dev, chunks)
    line = pool_turn_line(nodes, writes_s)
    line["launches"] = launch_counts()
    if profile:
        import cProfile
        prof = cProfile.Profile()
        prof.enable()
        run_pool_writes(torch, dev, chunks)
        prof.disable()
        host_table(prof, "pool writes, {}".format(
            "Python branches" if os.environ.get("PLENUM_TPU_NO_NATIVE")
            else "C branches"), depth=2)
    print(json.dumps({"pool_turn": line}), flush=True)
    return 0

# the text of torch's warning in set_sync_debug_mode("warn")
SYNC_WARNING = "synchronizing CUDA operation"


def pipeline_phase(torch, dev, signer):
    """Phase 10: the pipelined pool. The pool path's writes (POOL_REQS
    NYM writes and POOL_BAD tampered ones in chunks of CLIENT_BATCH, the
    pool path's settings, flat wire) in one process, twice in turns: with
    PIPELINE_ENABLED and SANITIZER_ENABLED (wire parse and the ed25519
    pre-screen on each node's parse worker, host-trie merges on its
    execution pool, the ownership sanitizer armed), then with both off.
    Then the pipelined turn once more under
    torch.cuda.set_sync_debug_mode("warn"), every synchronizing call
    recorded with its thread. Checks: domain, audit and state roots equal
    across the nodes and between the turns; every tampered request nacked
    by every node; ed25519_verify, sha256_ragged and sha3_ragged launched
    in the pipelined turn; every kernel dispatch and every synchronizing
    CUDA call on the thread that services the nodes, none on a worker; no
    sanitizer violation. → {"launches": both timed turns' launches,
    "turns": each turn's line}."""
    import threading
    import warnings
    from plenum_tpu_torch.common.messages.node_messages import RequestNack
    from plenum_tpu_torch.observability.export import pool_telemetry
    from plenum_tpu_torch.observability.telemetry import TM, merged_snapshot
    from plenum_tpu_torch.ops import ed25519 as ed
    from plenum_tpu_torch.ops import launch_counts
    from plenum_tpu_torch.ops import sha256 as sha
    from plenum_tpu_torch.ops import trie as trie_ops
    from plenum_tpu_torch.runtime import sanitizer

    t_phase = time.perf_counter()
    chunks, _, bad_ids = pool_requests(signer)
    main = threading.get_ident()
    threads = []          # (dispatch point, thread) of every kernel call
    violations = []
    real = {"verify": ed.verify, "ragged": sha.sha256_ragged,
            "hash_nodes": trie_ops.hash_nodes,
            "verify_nodes": trie_ops.dispatch_node_verify_batch}

    def on_thread(name, fn):
        def wrapped(*args, **kw):
            threads.append((name, threading.get_ident()))
            return fn(*args, **kw)
        return wrapped

    real_violation = sanitizer.OwnershipSanitizer.violation

    def counted_violation(self, *args):
        violations.append(args)
        return real_violation(self, *args)

    def turn(pipeline, label):
        conf = dict(PIPELINE_ENABLED=pipeline, SANITIZER_ENABLED=pipeline)
        launch_counts(reset=True)
        nodes, sent, writes_s = run_pool_writes(torch, dev, chunks, conf)
        launches = launch_counts()
        for n in nodes:
            if n._pipeline is not None:
                n._pipeline.stop()
        line = pool_turn_line(nodes, writes_s)
        hists = merged_snapshot(pool_telemetry(nodes)).get(
            "histograms") or {}
        for name in (TM.PIPELINE_PARSE_MS, TM.PIPELINE_PRESCREEN_MS,
                     TM.PIPELINE_QUEUE_WAIT_MS):
            h = hists.get(name) or {}
            line[name] = {"p50": h.get("p50"), "p99": h.get("p99"),
                          "count": h.get("count", 0)}
        line.update(launches={k: v for k, v in launches.items() if v},
                    workers=nodes[0]._pipeline.workers
                    if nodes[0]._pipeline is not None else 0,
                    nacked=[{m.reqId for m in out
                             if isinstance(m, RequestNack)} for out in sent],
                    roots_by_node=[node_roots(n) for n in nodes])
        log("pipelined pool, {}: {} writes ordered on every node in {:.3f} "
            "s wall, {:.1f} ordered requests/s; ORDERED_E2E_MS p50 {} p99 "
            "{}; {} p50/p99 {}/{} ({} jobs), {} p50/p99 {}/{} ({}), {} "
            "p50/p99 {}/{} ({}); workers {}; launches {}".format(
                label, line["ordered"], writes_s, line["req_s"],
                line["ordered_e2e_ms_p50"], line["ordered_e2e_ms_p99"],
                *[v for name in (TM.PIPELINE_PARSE_MS,
                                 TM.PIPELINE_PRESCREEN_MS,
                                 TM.PIPELINE_QUEUE_WAIT_MS)
                  for v in (name, line[name]["p50"], line[name]["p99"],
                            line[name]["count"])],
                line["workers"], line["launches"]))
        return line

    ed.verify = on_thread("ed25519", real["verify"])
    sha.sha256_ragged = on_thread("sha256_ragged", real["ragged"])
    trie_ops.hash_nodes = on_thread("sha3", real["hash_nodes"])
    trie_ops.dispatch_node_verify_batch = on_thread(
        "sha3_eq", real["verify_nodes"])
    sanitizer.OwnershipSanitizer.violation = counted_violation
    syncs = []
    try:
        on = turn(True, "pipeline and sanitizer on")
        off = turn(False, "pipeline and sanitizer off")
        launches = {k: on["launches"].get(k, 0) + off["launches"].get(k, 0)
                    for k in set(on["launches"]) | set(off["launches"])}
        t0 = time.perf_counter()
        shown = warnings.showwarning

        def record_sync(message, category, *args, **kw):
            if SYNC_WARNING in str(message):
                syncs.append(threading.get_ident())
            else:
                shown(message, category, *args, **kw)

        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = record_sync
            torch.cuda.set_sync_debug_mode("warn")
            try:
                checked = turn(True, "pipeline on, sync debug mode warn")
            finally:
                torch.cuda.set_sync_debug_mode("default")
                warnings.showwarning = shown
        sync_s = time.perf_counter() - t0
    finally:
        ed.verify, sha.sha256_ragged = real["verify"], real["ragged"]
        trie_ops.hash_nodes = real["hash_nodes"]
        trie_ops.dispatch_node_verify_batch = real["verify_nodes"]
        sanitizer.OwnershipSanitizer.violation = real_violation

    log("pipelined pool: wall on / off {:.4f} ({:.3f} / {:.3f} s); the "
        "sync-debug turn {:.1f} s, {} synchronizing CUDA calls, from "
        "threads {}; kernel dispatches by point {}".format(
            on["wall_s"] / off["wall_s"], on["wall_s"], off["wall_s"],
            sync_s, len(syncs), sorted({t == main for t in syncs}),
            {name: sum(1 for n, _ in threads if n == name)
             for name in sorted({n for n, _ in threads})}))
    for line in (on, off, checked):
        check(line["ordered"] == POOL_REQS,
              "the pipelined pool's turns ordered every write")
        check(all(r == line["roots_by_node"][0]
                  for r in line["roots_by_node"]),
              "domain, audit and state roots equal across the nodes")
        check(all(n == bad_ids for n in line["nacked"]),
              "every node nacked exactly the tampered requests")
    check(on["roots"] == off["roots"] == checked["roots"],
          "the pool's roots are byte-equal with the pipeline and sanitizer "
          "on and off")
    for name in ("ed25519_verify", "sha256_ragged", "sha3_ragged"):
        check(on["launches"].get(name, 0) > 0,
              "{} launched in the pipelined turn".format(name))
    check(threads and all(t == main for _, t in threads),
          "every kernel dispatch of the three turns ran on the thread that "
          "services the nodes")
    check(all(t == main for t in syncs),
          "no synchronizing CUDA call on a parse worker or the execution "
          "pool")
    check(on["workers"] >= 1 and not violations,
          "no sanitizer violation")
    log("phase 10 (pipelined pool): {:.1f} s".format(
        time.perf_counter() - t_phase))
    return {"launches": launches, "turns": {"on": on, "off": off}}


def gateway_phase(torch, dev):
    """Phase 11: the gateway tier, driven open-loop at bench.py
    gateway_open_loop's defaults through plenum_tpu_torch.testing.
    gateway_load: 4 BLS nodes (Max3PCBatchSize 200, wait 0.05 s, CHK_FREQ
    10, LOG_SIZE 30), backlog marks 150 / 75 / 1,000, Poisson arrivals at
    600 requests per simulated second for 8 simulated seconds from
    random.Random(4242) (30% reads, 80% of them on 16 hot keys; 2%
    retries; 10% of writes update a hot key), ticks of 0.05 s, envelopes
    of 64 requests from 4 senders, the pool's ordered p99 fed to the
    ladder every 20 ticks; and 20 writes with bad signatures added from
    their own seed. The gateway's pre-screen hub and all four nodes run
    on the card. Checks: every node's domain and state roots equal, and
    equal to a fresh pool's fed the forwarded stream straight through
    process_client_batch; every bad signature counted in sig_rejects
    (unless shed) and never written; bench.py gateway_gate's conditions;
    the gateway hub launched ed25519_verify, each of its batches held
    against verify_plain. → {"launches": the open loop's launches,
    "result": its summary}."""
    from plenum_tpu_torch.ops import ed25519 as ed
    from plenum_tpu_torch.ops import launch_counts
    from plenum_tpu_torch.testing import gateway_load as gl

    t_phase = time.perf_counter()
    batches = []
    real_verify = ed.verify

    def recording_verify(*args):
        batches.append(args)
        return real_verify(*args)

    launch_counts(reset=True)
    ed.verify = recording_verify
    try:
        run = gl.run_open_loop(device=dev, n_bad=GATEWAY_BAD)
    finally:
        ed.verify = real_verify
    torch.cuda.synchronize()
    launches = {k: v for k, v in launch_counts().items() if v}
    result = gl.summary(run)
    hub = run["gateway"].intake._verifier
    node_hub_launches = [len(n.authnr._verifier.launches)
                         for n in run["nodes"]]
    log("gateway: {} arrivals ({} reads, {} writes) in {:.1f} s wall, "
        "completed {}; p50 {} p99 {} p999 {} ms over {} samples; shed {}% "
        "(reads {}, writes {}), cache hits {}%, dedup hits {}; admitted "
        "writes {}, ordered {}; sig_rejects {}; levels {}; pool "
        "ORDERED_E2E_MS p50 {} p99 {}".format(
            result["arrivals"], result["reads_arrived"],
            result["writes_arrived"], result["wall_s"], result["completed"],
            result["gateway_p50_ms"], result["gateway_p99_ms"],
            result["gateway_p999_ms"], result["e2e_samples"],
            result["gateway_shed_pct"], result["shed_reads"],
            result["shed_writes"], result["gateway_cache_hit_pct"],
            result["dedup_hits"], result["admitted_writes"],
            result["ordered_writes"], result["sig_rejects"],
            result["shed_levels_seen"], result["ordered_p50_ms"],
            result["ordered_p99_ms"]))
    log("gateway: launches {}; the gateway hub's launches (unique "
        "signatures) {}; each node's hub launches {}".format(
            launches, [u for u, _ in hub.launches], node_hub_launches))

    t0 = time.perf_counter()
    nodes = run["nodes"]
    check(run["completed"], "the open loop ended with every admitted write "
                            "ordered")
    check(len({n.domain_ledger.root_hash for n in nodes}) == 1
          and len({bytes(n.db_manager.get_state(1).committedHeadHash)
                   for n in nodes}) == 1,
          "every node's domain and state roots are equal")
    replay = gl.replay_pool(gl.forwarded_stream(run), device=dev)
    check([n.domain_ledger.root_hash for n in replay]
          == [n.domain_ledger.root_hash for n in nodes]
          and [bytes(n.db_manager.get_state(1).committedHeadHash)
               for n in replay]
          == [bytes(n.db_manager.get_state(1).committedHeadHash)
              for n in nodes],
          "the roots equal a fresh pool's fed the forwarded stream")
    written = {txn["txn"]["metadata"]["reqId"]
               for _, txn in nodes[0].domain_ledger.getAllTxn()}
    bad = set(range(gl.BAD_REQ_ID, gl.BAD_REQ_ID + GATEWAY_BAD))
    check(not written & bad, "no bad-signature write reached the ledger")
    check(result["sig_rejects"] == GATEWAY_BAD if not result["shed_writes"]
          else result["sig_rejects"] <= GATEWAY_BAD,
          "every bad signature screened is counted in sig_rejects")
    failures = gl.gate(result)
    check(not failures and result["e2e_samples"] > 0,
          "gateway_gate's conditions hold: {}".format(failures))
    check(hub.launches and launches.get("ed25519_verify", 0)
          >= len(hub.launches),
          "the gateway hub launched ed25519_verify")
    # each node's hub verifies the batch the gateway's hub verified: each
    # distinct batch is held against the plain version once
    distinct = {}
    for args in batches:
        distinct.setdefault(b"".join(a.cpu().numpy().tobytes()
                                     for a in args), args)
    ed_err = 0
    for args in distinct.values():
        ed_err = max(ed_err, int((ed.verify_cuda(*args).int()
                                  - ed.verify_plain(*args).int()).abs().max()
                                 .item()))
    check(ed_err == 0, "ed25519 kernel verdicts equal the plain version's "
                       "on the gateway path's batches")
    log("gateway checks: roots equal on the four nodes and to the replay "
        "pool's, {} bad signatures rejected, gate passed, ed25519 == plain "
        "on the {} distinct of the path's {} verify batches {} ({:.1f} s)"
        .format(result["sig_rejects"], len(distinct), len(batches),
                [int(a[0].shape[0]) for a in batches],
                time.perf_counter() - t0))
    log("phase 11 (gateway): {:.1f} s".format(time.perf_counter() - t_phase))
    return {"launches": launches, "result": result, "ed_err": ed_err}


def adversary_phase(torch, dev):
    """Phase 12: Byzantine pools on the card, through the adversary
    harness (plenum_tpu_torch.testing.adversary, driven by
    plenum_tpu_torch.testing.byzantine).

    12a, recovery: bench.py bench_recovery at its own sizes, seeds, Config
    and SLOs (25 nodes; failover under a silent primary, the ex-primary's
    catchup, then a laggard's catchup under a garbling and a stalling
    seeder while a third peer leaves at 0.2 s and rejoins at 3.0 s), the
    nodes on the card with the port's default verifier (torch_hub) where
    bench.py names "cpu". Checks: no liveness or invariant violation, the
    garbling liar among the laggard's bad peers, the laggard's domain
    ledger equal to the target's, every honest node's domain and state
    roots equal. An SLO miss is printed, not checked.

    12b, a BLS pool of ATTACK_NODES validators under PoisonedBlsShare (one
    non-primary) and TamperedPropagate (another): ATTACK_WRITES signed NYM
    writes sent to every node in chunks of ATTACK_CHUNK, Max3PCBatchSize
    ATTACK_CHUNK. Checks: every write ordered on every honest node with
    equal roots, no tampered request written, every ordered batch
    multi-signed and nothing left to backfill, the strict window engaged
    on an honest node, bls_pairing launched from the nodes' share
    unrolls, the first device-sized unroll's verdicts equal the host
    library's per-share verify_sig, its pairing launch equal to the plain
    version, and each distinct ed25519 batch equal to verify_plain.
    → {"launches": {"recovery": ..., "bls_attack": ...}, "ed_err",
    "pairing_err"}."""
    from collections import Counter

    from plenum_tpu_torch.common.config import Config
    from plenum_tpu_torch.crypto.bls import BlsCryptoVerifierPlenum
    from plenum_tpu_torch.ops import bls381_pairing as bp
    from plenum_tpu_torch.ops import ed25519 as ed
    from plenum_tpu_torch.ops import launch_counts
    from plenum_tpu_torch.testing import byzantine

    t_phase = time.perf_counter()
    # ------------------------------------------------------- 12a recovery
    log("recovery: bench.py bench_recovery's pool of {} nodes (network seed "
        "{}, adversary seed {}, {}); one difference: VERIFIER_PROVIDER is "
        "the port's default {!r} on the card, where bench.py names "
        "\"cpu\"".format(byzantine.RECOVERY_NODES, byzantine.RECOVERY_NET_SEED,
                         byzantine.RECOVERY_ADV_SEED, byzantine.RECOVERY_CONF,
                         Config.VERIFIER_PROVIDER))
    launch_counts(reset=True)
    t0 = time.perf_counter()
    report, nodes = byzantine.run_recovery(byzantine.RECOVERY_NODES,
                                           device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rec_launches = {k: v for k, v in launch_counts().items() if v}
    violations = report.get("violations", [])
    log("recovery: failover {} s (SLO {} s), catchup {} s (SLO {} s) in sim "
        "seconds; catchup_bad_peers {}; roles {}; trace_events {}; ordered "
        "p50 {} ms p99 {} ms over {} samples; wall {:.1f} s; launches {} "
        "(the pool's six writes stay below the hub's threshold of {}: a "
        "host path, no launch claimed)".format(
            report["failover_s"], report["failover_slo_s"],
            report["catchup_s"], report["catchup_slo_s"],
            report["catchup_bad_peers"], report["roles"],
            report["trace_events"], report["ordered_p50_ms"],
            report["ordered_p99_ms"], report["e2e_samples"], wall,
            rec_launches, Config.VERIFIER_BATCH_THRESHOLD))
    slo_misses = [v for v in violations if v.startswith("recovery SLO")]
    if slo_misses:
        log("recovery: FINDING, SLO missed: {}".format(slo_misses))
    check(not [v for v in violations if v not in slo_misses],
          "recovery: no liveness violation ({})".format(violations))
    check(report["roles"]["liar"] in report["catchup_bad_peers"],
          "recovery: the garbling seeder is among the laggard's bad peers")
    by_name = {n.name: n for n in nodes}
    laggard = by_name[report["roles"]["laggard"]]
    honest = [by_name[n] for n in report["honest"]]
    check(laggard.domain_ledger.size == honest[0].domain_ledger.size
          and laggard.domain_ledger.root_hash
          == honest[0].domain_ledger.root_hash,
          "recovery: the laggard's domain ledger size and root equal the "
          "target's")
    check(len({(n.domain_ledger.root_hash,
                bytes(n.db_manager.get_state(1).committedHeadHash))
               for n in honest}) == 1,
          "recovery: every honest node's domain and state roots are equal")
    log("recovery checks passed: no liveness or invariant violation, liar "
        "{} convicted, laggard {} at size {}".format(
            report["roles"]["liar"], laggard.name,
            laggard.domain_ledger.size))

    # ---------------------------------------------- 12b BLS pool attacked
    ed_batches, pairing_batches = [], []
    real_verify, real_pairing_jobs = ed.verify, bp.pairing_jobs

    def recording_verify(*args):
        ed_batches.append(args)
        return real_verify(*args)

    def recording_pairing_jobs(jobs, device=None):
        out = real_pairing_jobs(jobs, device)
        pairing_batches.append((list(jobs), out[0].tolist()))
        return out

    launch_counts(reset=True)
    ed.verify, bp.pairing_jobs = recording_verify, recording_pairing_jobs
    t0 = time.perf_counter()
    try:
        run = byzantine.run_bls_attack(ATTACK_NODES, ATTACK_WRITES,
                                       ATTACK_CHUNK, device=dev)
    finally:
        ed.verify, bp.pairing_jobs = real_verify, real_pairing_jobs
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    atk_launches = {k: v for k, v in launch_counts().items() if v}
    honest = run["honest"]
    unrolls = run["unrolls"]
    device_min = Config.BLS_PAIRING_DEVICE_MIN
    sized = [u for u in unrolls if len(u[1]) >= device_min]
    log("bls attack: {} validators, poisoner {}, tamperer {}, primary {}; "
        "{} writes in chunks of {} ordered on {} honest nodes at sizes {} in "
        "{:.2f} sim s, {:.1f} s wall; launches {}; ed25519_verify batch "
        "sizes {}; share unrolls {} (shares each {}), {} with at least {} "
        "shares; bls_pairing jobs per launch {}; invariant checks {}".format(
            ATTACK_NODES, run["adversaries"]["poison"],
            run["adversaries"]["tamper"], run["adversaries"]["primary"],
            ATTACK_WRITES, ATTACK_CHUNK, len(honest),
            sorted({n.domain_ledger.size for n in honest}), run["sim_s"],
            wall, atk_launches,
            sorted(Counter(int(a[0].shape[0]) for a in ed_batches)
                   .items()),
            len(unrolls), sorted(Counter(len(u[1]) for u in unrolls)
                                 .items()), len(sized), device_min,
            sorted(Counter(len(j) for j, _ in pairing_batches).items()),
            run["scenario"].checker.checks))
    check(all(n.domain_ledger.size == ATTACK_WRITES for n in honest),
          "bls attack: all {} writes ordered on every honest node".format(
              ATTACK_WRITES))
    check(len({(n.domain_ledger.root_hash,
                bytes(n.db_manager.get_state(1).committedHeadHash))
               for n in honest}) == 1,
          "bls attack: domain and state roots equal on every honest node")
    check(not any("Tampered" in str(txn)
                  for n in honest for _, txn in n.domain_ledger.getAllTxn()),
          "bls attack: no tampered request was written")
    check(all(not byzantine.proofless_batches(n)
              and not n.bls_bft_replica._pending_backfill for n in honest),
          "bls attack: every ordered batch on every honest node has a "
          "stored multi-signature and nothing is left to backfill")
    check(any(n.bls_bft_replica._strict_until_seq > 0 for n in honest),
          "bls attack: an honest node engaged the strict window")
    check(sized and atk_launches.get("bls_pairing", 0) >= 1
          and pairing_batches,
          "bls attack: bls_pairing launched from a node's share unroll")
    _, checks, verdicts = sized[0]
    host = BlsCryptoVerifierPlenum()
    check(verdicts == [host.verify_sig(s, m, pk) for s, m, pk in checks]
          and not all(verdicts),
          "bls attack: the first unroll's verdicts ({} shares, {} False) "
          "equal the host library's per-share verify_sig".format(
              len(checks), verdicts.count(False)))
    jobs, card_verdicts = pairing_batches[0]
    plain = real_pairing_jobs(jobs, torch.device("cpu"))[0].tolist()
    pairing_err = int(sum(a != b for a, b in zip(card_verdicts, plain)))
    check(pairing_err == 0, "bls attack: the first unroll's pairing launch "
                            "({} jobs) equals the plain version".format(
                                len(jobs)))
    distinct = {}
    for args in ed_batches:
        distinct.setdefault(b"".join(a.cpu().numpy().tobytes()
                                     for a in args), args)
    ed_err = 0
    for args in distinct.values():
        ed_err = max(ed_err, int((ed.verify_cuda(*args).int()
                                  - ed.verify_plain(*args).int()).abs().max()
                                 .item()))
    check(ed_err == 0 and atk_launches.get("ed25519_verify", 0) > 0,
          "bls attack: ed25519_verify launched and equals verify_plain on "
          "the {} distinct of the path's {} verify batches".format(
              len(distinct), len(ed_batches)))
    log("bls attack checks passed ({:.1f} s)".format(
        time.perf_counter() - t0 - wall))
    log("phase 12 (adversary): {:.1f} s".format(
        time.perf_counter() - t_phase))
    return {"launches": {"recovery": rec_launches,
                         "bls_attack": atk_launches},
            "ed_err": ed_err, "pairing_err": pairing_err}


def pool_path(torch, dev, signer, profile, sha3_errs):
    """Phases 5 and 6: the pool path, and every kernel it ran held against
    its plain version on the pool's own inputs. → {"launches": per
    kernel, "ed_err" and "rag_err": the largest differences of
    ed25519_verify and sha256_ragged there, "kernels": the two SHA3
    entries' lines}."""
    import numpy as np
    from plenum_tpu_torch.common.constants import (
        AUDIT_LEDGER_ID, CONFIG_LEDGER_ID, DOMAIN_LEDGER_ID, POOL_LEDGER_ID,
        TARGET_NYM, VERKEY)
    from plenum_tpu_torch.common.messages.node_messages import (
        Reply, RequestNack)
    from plenum_tpu_torch.common.state_codec import (
        encode_state_value, nym_to_state_key)
    from plenum_tpu_torch.ledger.tree_hasher import TreeHasher
    from plenum_tpu_torch.ops import ed25519 as ed
    from plenum_tpu_torch.ops import sha256 as sha
    from plenum_tpu_torch.ops import sha3
    from plenum_tpu_torch.ops import trie as trie_ops
    from plenum_tpu_torch.state.pruning_state import PruningState
    from plenum_tpu_torch.storage.kv_memory import KeyValueStorageInMemory
    from plenum_tpu_torch.testing import pool

    t0 = time.perf_counter()
    chunks, reqs, bad_ids = pool_requests(signer)
    dests = [r["operation"][TARGET_NYM] for r in reqs]
    reads = [{"identifier": signer.identifier, "reqId": 10 ** 6 + i,
              "operation": {"type": "105", TARGET_NYM: d}}
             for i, d in enumerate(dests)]
    log("pool set-up: {} signed requests ({} tampered) in {:.1f} s".format(
        sum(map(len, chunks)), len(bad_ids), time.perf_counter() - t0))

    # The inputs of the pool's launches, recorded on their way to the
    # kernel wrappers (the wrappers launch and count as always) so that
    # phase 6 can replay them against the plain versions: the hub's
    # deduplicated verify batches, the ledgers' staged leaf batches and
    # tree levels, and the state levels.
    levels, verify_levels = [], []
    verify_batches, sha_batches = [], []
    hash_nodes = trie_ops.hash_nodes
    dispatch_verify = trie_ops.dispatch_node_verify_batch
    ed_verify, sha_ragged = ed.verify, sha.sha256_ragged

    def recording_verify(*args):
        verify_batches.append(args)
        return ed_verify(*args)

    def recording_sha256_ragged(data, offsets, prefix=-1):
        sha_batches.append((data, offsets, prefix))
        return sha_ragged(data, offsets, prefix)

    def recording_hash_nodes(blobs, device=None, staging=None):
        levels.append(list(blobs))
        return hash_nodes(blobs, device, staging)

    def recording_dispatch_verify(blobs, expected, device=None,
                                  staging=None):
        verify_levels.append((list(blobs), list(expected)))
        return dispatch_verify(blobs, expected, device, staging)

    def run_pool_path():
        """Order every chunk on four nodes, then serve the reads from one.
        → (nodes, hub, nacks per node, read replies, wall seconds of the
        writes, of the reads)."""
        nodes, sent, writes_s = run_pool_writes(torch, dev, chunks)
        hub = nodes[0].authnr._verifier
        nacks = [[m for m in out if isinstance(m, RequestNack)]
                 for out in sent]
        reader = nodes[1]
        before = len(sent[1])
        t_r = time.perf_counter()
        reader.process_client_batch([(r, "reader") for r in reads])
        torch.cuda.synchronize()
        reads_s = time.perf_counter() - t_r
        return nodes, hub, nacks, sent[1][before:], writes_s, reads_s

    counters = {"ed25519_verify": ed.verify_cuda,
                "sha256_compress": sha.sha256_blocks_cuda,
                "sha256_ragged": sha.sha256_ragged_cuda,
                "sha256_node_levels": sha.sha256_node_levels_cuda,
                "sha3_ragged": sha3.sha3_ragged_cuda,
                "sha3_ragged_eq": sha3.sha3_ragged_eq_cuda}
    for fn in counters.values():
        fn.launches = 0
    sha3.sha3_ragged_cuda.rows = []
    sha3.sha3_ragged_eq_cuda.rows = []
    trie_ops.hash_nodes = recording_hash_nodes
    trie_ops.dispatch_node_verify_batch = recording_dispatch_verify
    ed.verify, sha.sha256_ragged = recording_verify, recording_sha256_ragged
    try:
        nodes, hub, nacks, replies, writes_s, reads_s = run_pool_path()
    finally:
        trie_ops.hash_nodes = hash_nodes
        trie_ops.dispatch_node_verify_batch = dispatch_verify
        ed.verify, sha.sha256_ragged = ed_verify, sha_ragged
    launches = {k: fn.launches for k, fn in counters.items()}
    p50, p99, e2e = pool.pool_latency_summary(nodes)
    log("pool path launches:", launches)
    log("pool: {} requests ordered on every node in {:.3f} s wall, {:.1f} "
        "ordered requests/s; ORDERED_E2E_MS p50 {} p99 {} over {} "
        "intake-to-commit samples".format(
            min(n.domain_ledger.size for n in nodes), writes_s,
            POOL_REQS / writes_s, p50, p99, e2e))
    log("pool: hub launches {} (unique signatures each: {}), {} "
        "signatures per launch".format(
            len(hub.launches), [u for u, _ in hub.launches],
            sum(u for u, _ in hub.launches) / max(1, len(hub.launches))))
    log("pool: sha3_ragged launches {} rows {}; sha3_ragged_eq launches {} "
        "rows {}; sha256_ragged launches {}".format(
            launches["sha3_ragged"], sha3.sha3_ragged_cuda.rows,
            launches["sha3_ragged_eq"], sha3.sha3_ragged_eq_cuda.rows,
            launches["sha256_ragged"]))
    log("pool: {} GET_NYM reads with state proofs served in {:.3f} s "
        "wall".format(len(reads), reads_s))

    # ------------------------------------------------ pool path checks
    t0 = time.perf_counter()
    check(all(n.domain_ledger.size == POOL_REQS for n in nodes),
          "all {} requests ordered on every node".format(POOL_REQS))
    for lid in (DOMAIN_LEDGER_ID, AUDIT_LEDGER_ID, POOL_LEDGER_ID,
                CONFIG_LEDGER_ID):
        check(len({n.db_manager.get_ledger(lid).root_hash
                   for n in nodes}) == 1,
              "ledger {} roots equal across the nodes".format(lid))
    state = [n.db_manager.get_state(DOMAIN_LEDGER_ID) for n in nodes]
    check(len({(s.headHash, s.committedHeadHash) for s in state}) == 1,
          "domain state roots equal across the nodes")
    ledger = nodes[0].domain_ledger
    blobs = [ledger.serialize_for_tree(ledger.getBySeqNo(i))
             for i in range(1, ledger.size + 1)]
    check(ledger.root_hash_raw == TreeHasher().hash_full_tree(blobs),
          "domain ledger root equals the hashlib Merkle root")
    host = PruningState(KeyValueStorageInMemory())
    written = set()
    for i in range(1, ledger.size + 1):
        txn = ledger.getBySeqNo(i)
        data, md = txn["txn"]["data"], txn["txnMetadata"]
        written.add(txn["txn"]["metadata"]["reqId"])
        host.set(nym_to_state_key(data[TARGET_NYM]), encode_state_value(
            {"identifier": txn["txn"]["metadata"]["from"],
             VERKEY: data[VERKEY], "seqNo": md["seqNo"]},
            md["seqNo"], md["txnTime"]))
    check(state[0].committedHeadHash == host.headHash,
          "domain state root equals a host-only trie fed the same writes")
    check(not written & bad_ids, "no tampered request reached the ledger")
    for node_nacks in nacks:
        check({m.reqId for m in node_nacks} == bad_ids,
              "every node nacked exactly the tampered requests")
    got = [m for m in replies if isinstance(m, Reply)]
    check(len(got) == len(reads), "one reply per read")
    root = state[1].committedHeadHash
    for i, m in enumerate(got):
        res = m.result
        check(res["data"][VERKEY] == "~" + dests[i],
              "read {} returns the written verkey".format(i))
        if i % 40 == 0:
            key = nym_to_state_key(dests[i])
            check(PruningState.verify_state_proof(
                root, key, bytes(state[1].get(key)),
                PruningState.deserialize_proof(
                    res["state_proof"]["proof_nodes"])),
                "read {}'s state proof verifies".format(i))
    for name in ("ed25519_verify", "sha256_ragged", "sha3_ragged",
                 "sha3_ragged_eq"):
        check(launches[name] > 0, "{} launched on the pool path".format(
            name))
    log("pool path checks: roots equal on the four nodes, domain root == "
        "hashlib, state root == host trie, {} tampered requests nacked by "
        "every node, {} reads verified ({:.1f} s)".format(
            len(bad_ids), len(got), time.perf_counter() - t0))

    turn = pool_turn_line(nodes, writes_s)

    if profile:
        where_the_time_goes(torch, run_pool_path, "pool path")

    # ------ 6. the kernels against their plain versions at the pool's
    # shapes: the verify batches and SHA-256 launches the pool made, then
    # the SHA3 levels it hashed and verified
    t0 = time.perf_counter()
    check(len(verify_batches) == launches["ed25519_verify"]
          and len(sha_batches) == launches["sha256_ragged"],
          "every ed25519 and SHA-256 launch of the pool was recorded")
    ed_err = rag_err = 0
    for args in verify_batches:
        ed_err = max(ed_err, int((ed.verify_cuda(*args).int()
                                  - ed.verify_plain(*args).int()).abs().max()
                                 .item()))
    check(ed_err == 0, "ed25519 kernel verdicts equal the plain version's "
                       "on the pool's verify batches")
    for data, offsets, prefix in sha_batches:
        dk = sha.sha256_ragged_cuda(data, offsets, prefix)
        rag_err = max(rag_err, u32_max_abs_err(
            torch, dk.digests, sha.sha256_ragged_plain(data, offsets,
                                                       prefix)))
        flat, bounds = data.cpu().numpy().tobytes(), offsets.cpu().tolist()
        pre = b"" if prefix < 0 else bytes([prefix])
        check(sha.digests_to_bytes(sha.to_host(dk))
              == [hashlib.sha256(pre + flat[a:b]).digest()
                  for a, b in zip(bounds, bounds[1:])],
              "SHA-256 ragged entry equals hashlib on a pool batch")
    check(rag_err == 0, "SHA-256 ragged entry equals the plain version on "
                        "the pool's batches")
    log("kernel == plain at the pool's shapes: ed25519_verify on {} "
        "batches ({} signatures), sha256_ragged on {} batches ({} "
        "messages, == hashlib) ({:.1f} s)".format(
            len(verify_batches), [int(a[0].shape[0]) for a in verify_batches],
            len(sha_batches), [int(o.shape[0]) - 1 for _, o, _ in sha_batches],
            time.perf_counter() - t0))
    t0 = time.perf_counter()
    err, eq_err = sha3_errs
    for blobs in levels:
        data, offsets = sha.upload_ragged(blobs, dev)
        dk = sha3.sha3_ragged_cuda(data, offsets).host()
        dp = sha3.sha3_ragged_plain(data, offsets).cpu().numpy()
        err = max(err, int(np.abs(dk.astype(np.int64) - dp).max()))
        check(sha3.digests_to_bytes(dk)
              == [hashlib.sha3_256(b).digest() for b in blobs],
              "SHA3 kernel equals hashlib on a pool level")
    for blobs, refs in verify_levels:
        data, offsets, r = sha.upload_ragged(blobs, dev, refs)
        ok = sha3.sha3_ragged_eq_cuda(data, offsets, r).host()
        eq_err += int((ok != sha3.sha3_ragged_eq_plain(data, offsets, r)
                       .cpu().numpy()).sum())
        check(bool(ok.all()), "every read level verifies")
    check(err == 0 and eq_err == 0, "SHA3 entries equal the plain version "
                                     "on the pool's levels")
    log("sha3 at the pool's shapes: both entries == plain == hashlib on "
        "{} hashed levels (rows {}) and {} verified levels (rows {}) "
        "({:.1f} s)".format(len(levels), sorted(map(len, levels)),
                            len(verify_levels),
                            sorted(len(b) for b, _ in verify_levels),
                            time.perf_counter() - t0))
    big = max(levels, key=len)
    vblobs, vrefs = max(verify_levels, key=lambda v: len(v[0]))
    times = sha3_times(torch, dev, big, vblobs, vrefs)
    kernels = [
        {"name": "sha3_ragged", "route": "cuda",
         "source": "plenum_tpu_torch/csrc/sha3.cu",
         "replaces": "plenum_tpu/ops/sha3.py:136",
         "launches": launches["sha3_ragged"], "max_abs_err": err,
         "ms": times["sha3_ragged"]["ms"],
         "plain_ms": times["sha3_ragged"]["plain_ms"],
         "bound_ms": times["sha3_ragged"]["bound_ms"],
         "bound_by": times["sha3_ragged"]["bound_by"], "library_ms": None,
         "kernel_ms": times["sha3_ragged"]["kernel_ms"],
         "round_trip_ms": times["sha3_ragged"]["round_trip_ms"]},
        {"name": "sha3_ragged_eq", "route": "cuda",
         "source": "plenum_tpu_torch/csrc/sha3.cu",
         "replaces": "plenum_tpu/ops/trie_jax.py:74",
         "launches": launches["sha3_ragged_eq"], "max_abs_err": eq_err,
         "ms": times["sha3_ragged_eq"]["ms"],
         "plain_ms": times["sha3_ragged_eq"]["plain_ms"],
         "bound_ms": times["sha3_ragged_eq"]["bound_ms"],
         "bound_by": times["sha3_ragged_eq"]["bound_by"], "library_ms": None,
         "kernel_ms": times["sha3_ragged_eq"]["kernel_ms"],
         "round_trip_ms": times["sha3_ragged_eq"]["round_trip_ms"]},
    ]
    return {"launches": launches, "ed_err": ed_err, "rag_err": rag_err,
            "kernels": kernels, "turn": turn}


def deployment_phase(torch, dev, profile):
    """Phase 7: the headline deployment (bench.py run_multiprocess_pool,
    through plenum_tpu_torch.testing.mp_pool): four node processes on the
    card over TCP, BLS-signing their state roots. "remote" runs a verify
    daemon process on the card; before its pool starts the 16,384-signature
    set goes through the daemon (a RemoteVerifier) and its verdicts must
    equal verify_plain's on the card; then the daemon's counters are
    zeroed. "cpu" has each node verify on its own (RFC 8032 on the host).
    The runs alternate remote, cpu, remote, cpu with the client in
    bench.py's send order, then remote, cpu in the "broadcast" order.
    Each run's roots are held against mp_pool.replay_roots, a replay of
    the committed txns on the host. → {"launches": the
    kernels' launches in the node processes and the daemon over all runs,
    "runs": per run its wall and rate}."""
    from plenum_tpu_torch import testing
    from plenum_tpu_torch.crypto import bls_ops
    from plenum_tpu_torch.crypto.remote_verifier import RemoteVerifier
    from plenum_tpu_torch.ops import ed25519 as ed
    from plenum_tpu_torch.ops import to_tensor
    from plenum_tpu_torch.testing import mp_pool

    check(bls_ops.BACKEND == "native", "the BLS backend is the native C "
                                       "build")
    log("deployment: BLS backend {}".format(bls_ops.BACKEND))
    t0 = time.perf_counter()
    reqs = mp_pool.make_mp_requests(MP_REQS + 1)
    msgs, sigs, vks, _ = testing.adversarial_signatures(
        MICRO_BATCH, SEED, unique=SCALAR_SUBSET)
    arrays, valid = ed.host_pack(msgs, sigs, vks)
    plain = (ed.verify_plain(*[to_tensor(a, dev) for a in arrays])
             .cpu().numpy() & valid).tolist()
    log("deployment set-up: {} signed requests, the {}-signature check set "
        "and its plain verdicts in {:.1f} s".format(
            len(reqs), MICRO_BATCH, time.perf_counter() - t0))

    # the daemon's scalar floor (Config.VERIFY_DAEMON_CPU_FLOOR): one
    # host verify against one device round trip at small batches
    from plenum_tpu_torch.crypto.batch_verifier import (
        ScalarVerifier, TorchBatchVerifier)
    items = list(zip(msgs, sigs, vks))[:SCALAR_SUBSET]
    t = time.perf_counter()
    ScalarVerifier().verify_batch(items[:32])
    scalar_ms = (time.perf_counter() - t) * 1e3 / 32
    batch = TorchBatchVerifier(dev)
    trips = {}
    for n in (1, 8, 64, 512):
        batch.verify_batch(items[:n])
        t = time.perf_counter()
        for _ in range(5):
            batch.verify_batch(items[:n])
        trips[n] = (time.perf_counter() - t) * 1e3 / 5
    log("deployment: scalar RFC 8032 verify {:.3f} ms a signature (host); "
        "device round trip (pack, launch, copy back) {} ms at {} "
        "signatures".format(scalar_ms,
                            [round(v, 4) for v in trips.values()],
                            list(trips)))

    def daemon_check(addr):
        rv = RemoteVerifier(addr, timeout=600)
        t = time.perf_counter()
        got = rv.verify_batch(list(zip(msgs, sigs, vks)))
        wall = time.perf_counter() - t
        stats = rv.daemon_stats()
        rv.close()
        check(got == plain, "the daemon's verdicts on the {}-signature set "
                            "equal verify_plain's on the card".format(
                                MICRO_BATCH))
        check(stats["kernels"]["ed25519_verify"] > 0,
              "the daemon verified the check set with the kernel")
        log("deployment: daemon == verify_plain on {} signatures ({} "
            "accepted) in {:.3f} s through the socket; its launches {} "
            "(unique items each: {})".format(
                MICRO_BATCH, sum(got), wall,
                stats["kernels"]["ed25519_verify"],
                [u for u, _ in stats["hub_launches"]]))

    launches, runs = {}, []
    plan = [("remote", MP_REQS, "by_node", "mp"),
            ("cpu", MP_CPU_REQS, "by_node", "mp")] * 2 + [
        ("remote", MP_REQS, "broadcast", "mp"),
        ("cpu", MP_CPU_REQS, "broadcast", "mp"),
        ("remote", NETWORKED_WRITES, "broadcast", "networked")]
    for i, (provider, n, order, client) in enumerate(plan):
        t_run = time.perf_counter()
        res = mp_pool.run_multiprocess_pool(
            reqs[:n + 1], provider, device="cuda",
            log_dir=os.path.join(REPO, "chiprun_out", "mp_logs", str(i)),
            profile_node="Alpha" if profile and i < 2 else None,
            before_pool=daemon_check if i == 0 else None,
            timeout=MP_TIMEOUT_S, order=order, info_dump_s=INFO_DUMP_S,
            client=client)
        nodes = res["nodes"]
        provider = "{} ({})".format(provider, order if client == "mp"
                                    else "NetworkedPoolClient")
        if client == "networked":
            check(res["ordered"] == res["required"] == n,
                  "{}: the client holds all {} writes confirmed on f + 1 "
                  "matching replies ({} confirmed)".format(
                      provider, n, res["ordered"]))
        else:
            check(res["ordered"] == res["required"] == n,
                  "{}: every node replied to all {} writes ({} on the "
                  "slowest)".format(provider, n, res["ordered"]))
        for key in ("domain_root", "audit_root", "state_root"):
            check(len({v[key] for v in nodes.values()}) == 1,
                  "{}: {}s equal on the four nodes".format(provider, key))
        t = time.perf_counter()
        replay = mp_pool.replay_roots(nodes["Alpha"]["domain_txns"])
        check(all(v["domain_root"] == replay["domain_root"]
                  and v["state_root"] == replay["state_root"]
                  for v in nodes.values()),
              "{}: the four nodes' domain and state roots equal a host "
              "replay of the committed txns (hashlib leaves, host trie)"
              .format(provider))
        replay_s = time.perf_counter() - t
        n_txns = len(nodes["Alpha"]["domain_txns"])
        infos = [v["validator_info"]["Node_info"] for v in nodes.values()]
        pools = [v["validator_info"]["Pool_info"] for v in nodes.values()]
        check(all(vi["Ledger_sizes"]["domain"] == n_txns
                  and vi["Committed_ledger_root_hashes"]["domain"]
                  == replay["domain_root"]
                  and vi["Committed_state_root_hashes"]["domain"]
                  == replay["state_root"] for vi in infos),
              "{}: every node's validator-info dump gives the domain size "
              "{} and the replay's domain and state roots".format(
                  provider, n_txns))
        check(all(p["Total_nodes_count"] == len(mp_pool.NAMES)
                  and p["f_value"] == (len(mp_pool.NAMES) - 1) // 3
                  and sorted(p["Validators"]) == sorted(mp_pool.NAMES)
                  and vi["Ledger_sizes"]["pool"] == len(mp_pool.NAMES)
                  for p, vi in zip(pools, infos)),
              "{}: every node's validator-info pool counts match the "
              "genesis".format(provider))
        if client == "networked":
            check(len(res["client"]["seq_nos"]) == n,
                  "{}: the client confirmed {} writes at distinct seqNos on "
                  "f + 1 matching replies".format(provider, n))
            log("deployment {} {}: {} writes confirmed in {:.3f} s wall, "
                "{:.1f} req/s, {} redials".format(
                    i, provider, n, res["elapsed"], res["rate"],
                    res["client"]["redials"]))
        check(all(v["multi_sig_ok"] for v in nodes.values()),
              "{}: each node's latest state root carries a BLS multi-sig "
              "that verifies under the pool's keys".format(provider))
        check(all(v["device"].startswith("cuda") for v in nodes.values()),
              "{}: every node process ran on the card".format(provider))
        per_node = {name: {k: c for k, c in v["kernels"].items() if c}
                    for name, v in nodes.items()}
        check(all(v["native"] == nodes["Alpha"]["native"]
                  and v["native"]["store"] == "KeyValueStorageNative"
                  for v in nodes.values()),
              "{}: every node process chose KeyValueStorageNative through "
              "bootstrap and the same host branches".format(provider))
        if i == 0:
            log("deployment: the node processes' host branches {}".format(
                nodes["Alpha"]["native"]))
        if provider.startswith("remote"):
            # the client run's 500 writes make 3PC batches below
            # SHA256_BATCH_THRESHOLD: its path is the daemon's ed25519
            if client == "mp":
                check(all(v["kernels"]["sha256_ragged"] > 0
                          and v["kernels"]["sha3_ragged"] > 0
                          for v in nodes.values()),
                      "remote: every node process launched sha256_ragged "
                      "and sha3_ragged")
            daemon = res["daemon"]
            check(daemon["kernels"]["ed25519_verify"] > 0,
                  "remote: the daemon launched ed25519_verify")
            log("deployment {} {}: daemon {} items in {} fused batches, "
                "ed25519_verify launches {} (unique items each: {}); 3PC "
                "batches per node {}".format(
                    i, provider, daemon["served"], daemon["batches"],
                    daemon["kernels"]["ed25519_verify"],
                    [u for u, _ in daemon["hub_launches"]],
                    {k: v["audit_size"] for k, v in nodes.items()}))
            for k, c in daemon["kernels"].items():
                launches[k] = launches.get(k, 0) + c
        for v in nodes.values():
            for k, c in v["kernels"].items():
                launches[k] = launches.get(k, 0) + c
        log("deployment {} {}: {} writes ordered on every node in {:.3f} s "
            "wall, {:.1f} ordered requests/s (run with set-up and stop "
            "{:.1f} s; the client took {:.3f} s to encrypt and queue the "
            "requests, {:.3f} CPU s in all); roots equal on the four nodes "
            "and to the host replay of {} txns ({:.1f} s), multi-sigs verify; "
            "view numbers at stop {}; node processes: {}"
            .format(i, provider, n, res["elapsed"], res["rate"],
                    time.perf_counter() - t_run, res["client"]["send_s"],
                    res["client"]["client_cpu_s"],
                    len(nodes["Alpha"]["domain_txns"]), replay_s,
                    [nodes[name]["view_no"] for name in nodes],
                    {name: (nodes[name]["device"], per_node[name])
                     for name in nodes}))
        runs.append({"provider": res["provider"], "order": order,
                     "client": client, "writes": n,
                     "wall_s": res["elapsed"], "req_s": res["rate"],
                     "view_no": max(v["view_no"] for v in nodes.values()),
                     "client_cpu_s": res["client"]["client_cpu_s"]})
        if res["profile"]:
            host_table(res["profile"],
                       "node Alpha, deployment {}".format(provider),
                       depth=3)
    log("deployment runs: " + json.dumps(runs))
    log("deployment: the node processes' BLS kernel launches {} (none is "
        "expected: a node unrolls its shares only when an aggregate fails; "
        "not a check)".format({k: launches.get(k, 0) for k in (
            "bls_pairing", "bls_g1_aggregate", "bls_g2_aggregate",
            "bls_g1_msm")}))
    return {"launches": launches, "runs": runs}


def level_build_phase(torch, dev, leaf_digests, hash_store):
    """The 20 levels above the main path's 2^20 leaf digests ([2^20, 32]
    uint8): sha256_node_levels (the launches of node_level_split) against
    its plain version, against the step it replaced, level by level, and
    against the recovered ledger's hash store (a SHA-256 of its 2^20 - 1
    subtree entries); then the kernel alone (all launches, and each), the
    wrapper (cuda_ms), and the two level builds in turns (old, new, new,
    old; host wall) and once each under torch.profiler. → the numbers of
    the kernels line's entry."""
    import numpy as np
    from plenum_tpu_torch import carry
    from plenum_tpu_torch.ledger.tree_hasher import TreeHasher
    from plenum_tpu_torch.ops import cuda_lib, to_tensor
    from plenum_tpu_torch.ops import sha256 as sha

    class OldLevelStep:
        """The level step before sha256_node_levels, from the functions
        kept: one level's pairs copied to the card from pageable memory,
        their words built by _node_words_from_digest_pairs, sha256_compress
        and a pageable copy back. It has no node_levels_array, so
        TreeHasher.hash_node_levels_array takes the levels one by one
        (hashlib below its threshold of 256 pairs), as the tree did."""

        def node_hashes_array(self, pairs):
            words = sha._node_words_from_digest_pairs(torch.from_numpy(
                np.ascontiguousarray(pairs)).to(dev))
            nvalid = torch.full((pairs.shape[0],), 2, dtype=torch.int32,
                                device=dev)
            return sha.digests_to_array(sha.to_host(
                sha.sha256_blocks_cuda(words, nvalid)))

    old_hasher = TreeHasher(batch_backend=OldLevelStep())
    new_hasher = TreeHasher(batch_backend=sha.TorchSha256Backend(dev))

    def old():
        return old_hasher.hash_node_levels_array(leaf_digests, LEDGER_LEVELS)

    def new():
        return new_hasher.hash_node_levels_array(leaf_digests, LEDGER_LEVELS)

    t0 = time.perf_counter()
    old_levels, new_levels = old(), new()
    check(len(new_levels) == LEDGER_LEVELS
          and all(a.tobytes() == b.tobytes()
                  for a, b in zip(old_levels, new_levels)),
          "every level of the 2^20 build equals the old level step's")
    _, nodes = carry.arrays_from_hash_store(hash_store, LEDGER_TXNS)
    old_sum = hashlib.sha256(b"".join(a.tobytes() for a in old_levels))
    check(nodes.shape[0] == LEDGER_TXNS - 1
          and hashlib.sha256(nodes.tobytes()).digest() == old_sum.digest(),
          "the recovered ledger's subtree entries equal the old level "
          "step's")
    d = to_tensor(leaf_digests, dev)
    ms, dk = cuda_ms(
        torch, lambda: sha.sha256_node_levels_cuda(d, LEDGER_LEVELS), 10)
    plain_ms, dp = once_ms(
        torch, lambda: sha.sha256_node_levels_plain(d, LEDGER_LEVELS))
    err = int((dk.int() - dp.int()).abs().max().item())
    check(err == 0 and dk.cpu().numpy().tobytes()
          == b"".join(a.tobytes() for a in new_levels),
          "sha256_node_levels equals the plain version on the 2^20 build")
    log("sha256_node_levels: the 2^20 build's {} levels == plain == the old "
        "level step, level by level; the recovered hash store's {} subtree "
        "entries == the old step's (SHA-256 {}) ({:.1f} s)".format(
            LEDGER_LEVELS, nodes.shape[0], old_sum.hexdigest(),
            time.perf_counter() - t0))

    split = sha.node_level_split(LEDGER_TXNS, LEDGER_LEVELS,
                                 sha._node_wave(cuda_lib.load("sha256"), dev))
    alone = kernel_ms(torch,
                      lambda: sha.sha256_node_levels_cuda(d, LEDGER_LEVELS))
    # two blocks a node; the children read once, the nodes written once
    n_all = LEDGER_TXNS - 1
    b_ms, b_by = bound(2 * n_all * SHA256_OPS_PER_BLOCK,
                       32 * (LEDGER_TXNS + n_all))
    log("sha256_node_levels kernel alone: all {} levels ({} nodes, {} "
        "launches of {} levels) {:.5f} ms, bound {:.5f} ms ({}), {:.2%} of "
        "it; wrapper (cuda_ms) {:.5f} ms; plain version {:.3f} ms".format(
            LEDGER_LEVELS, n_all, len(split), split, alone, b_ms, b_by,
            b_ms / alone, ms, plain_ms))
    per_launch, src, done = [], d, 0
    for lv in split:
        nodes = sum(src.shape[0] >> k for k in range(1, lv + 1))
        t = kernel_ms(torch,
                      lambda src=src, lv=lv: sha.sha256_node_levels_cuda(src,
                                                                         lv))
        b_t, _ = bound(2 * nodes * SHA256_OPS_PER_BLOCK,
                       32 * (src.shape[0] + nodes))
        per_launch.append(t)
        log("  launch of levels {}-{} ({} children, {} nodes): {:.5f} ms, "
            "bound {:.6f} ms, {:.2%} of it".format(
                done + 1, done + lv, src.shape[0], nodes, t, b_t, b_t / t))
        last = dk[sum(LEDGER_TXNS >> k for k in range(1, done + lv)):]
        src = last[:LEDGER_TXNS >> (done + lv)]
        done += lv

    walls = {"old": [], "new": []}
    for which in ("old", "new", "new", "old"):
        fn = old if which == "old" else new
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls[which].append(1e3 * (time.perf_counter() - t))
    log("level build of the 2^20 leaf digests (arrays in, arrays out), "
        "host wall in turns old, new, new, old: old {} ms, new {} ms".format(
            " / ".join("{:.3f}".format(w) for w in walls["old"]),
            " / ".join("{:.3f}".format(w) for w in walls["new"])))
    for which, fn in (("old", old), ("new", new)):
        busy, _ = device_time(torch, fn)
        log("level build {} under torch.profiler: device {:.4f} ms in {} "
            "kernels and copies".format(
                which, sum(us for us, _ in busy.values()) / 1e3,
                sum(c for _, c in busy.values())))
        for name, (us, count) in sorted(busy.items(),
                                        key=lambda kv: -kv[1][0])[:8]:
            log("  device {:.4f} ms  x{}  {}".format(us / 1e3, count,
                                                      name[:90]))
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "err": err, "kernel_ms": alone,
            "kernel_ms_per_launch": per_launch, "split": split,
            "build_wall_ms": {k: sorted(v) for k, v in walls.items()}}


def catchup_phase(torch, dev, blobs, profile, ceilings):
    """Phase 8: catchup seeding from the card (see the module docstring);
    the append's latency floor from `ceilings` (sha256_ceilings.measure).
    → {"launches", "entry": the kernels line's sha256_append_levels
    numbers but its launches, "err"}."""
    import numpy as np
    from plenum_tpu_torch import testing
    from plenum_tpu_torch.common.config import Config
    from plenum_tpu_torch.common.constants import DOMAIN_LEDGER_ID
    from plenum_tpu_torch.common.messages.node_messages import CatchupReq
    from plenum_tpu_torch.common.serializers.serializers import (
        MsgPackSerializer)
    from plenum_tpu_torch.ledger.compact_merkle_tree import CompactMerkleTree
    from plenum_tpu_torch.ledger.ledger import Ledger, _seq_key
    from plenum_tpu_torch.ledger.merkle_verifier import MerkleVerifier
    from plenum_tpu_torch.ledger.tree_hasher import TreeHasher
    from plenum_tpu_torch.ops import launch_counts
    from plenum_tpu_torch.ops import sha256 as sha
    from plenum_tpu_torch.ops.merkle import append_groups
    from plenum_tpu_torch.server.catchup import SeederService
    from plenum_tpu_torch.server.database_manager import DatabaseManager

    conf = Config()
    wire = MsgPackSerializer()

    class Net:
        """The seeder's network: subscriptions dropped, reps captured."""

        def __init__(self):
            self.sent = []

        def subscribe(self, *args):
            pass

        def send(self, msg, dst=None):
            self.sent.append(msg.to_dict())

    def serve(ledger, lo, hi, till):
        """(reps, host seconds) of one CatchupReq for txns lo..hi proved
        against the size-`till` tree, served by a SeederService of
        `ledger`."""
        db = DatabaseManager()
        db.register_new_database(DOMAIN_LEDGER_ID, ledger, None)
        net = Net()
        seeder = SeederService(db, net, name="Alpha", config=conf)
        t = time.perf_counter()
        seeder.process_catchup_req(CatchupReq(
            ledgerId=DOMAIN_LEDGER_ID, seqNoStart=lo, seqNoEnd=hi,
            catchupTill=till), "Beta")
        torch.cuda.synchronize()
        return net.sent, time.perf_counter() - t

    def host_ledger():
        """The same committed txns and hash store, no engine: the seeder
        of the host memo path."""
        return Ledger(tree=CompactMerkleTree(ledger.hasher,
                                             ledger.tree.hash_store),
                      txn_store=ledger._store)

    def same_reps(a, b, what):
        check(len(a) == len(b) and all(
            wire.serialize(x) == wire.serialize(y) for x, y in zip(a, b)),
            "{}: the device seeder's {} reps are byte-equal to the host "
            "memo seeder's".format(what, len(a)))

    t0 = time.perf_counter()
    ledger = Ledger(tree_hasher=TreeHasher(
        batch_backend=sha.TorchSha256Backend(dev)))
    ledger._store.setBatch((_seq_key(i + 1), b) for i, b in enumerate(blobs))
    ledger.recoverTreeFromTxnLog()
    commit = [ledger.txn_serializer.deserialize(b) for b in
              testing.nym_txn_blobs(COMMIT_BATCH, SEED + 8, TXN_TIME)]
    log("phase 8 set-up: domain ledger of {} txns recovered, {} txns to "
        "commit ({:.1f} s)".format(LEDGER_TXNS, len(commit),
                                   time.perf_counter() - t0))

    # ---- the path: attach (warm build), serve, commit, serve
    launch_counts(reset=True)
    t = time.perf_counter()
    eng = ledger.tree.attach_device_engine(
        proof_min=conf.MERKLE_DEVICE_PROOF_MIN,
        chunk=conf.MERKLE_DEVICE_PROOF_CHUNK,
        pipeline_depth=conf.MERKLE_DEVICE_PIPELINE_DEPTH,
        fused_levels=conf.MERKLE_FUSED_LEVELS, warm=True, device=dev)
    torch.cuda.synchronize()
    warm_ms = 1e3 * (time.perf_counter() - t)
    first, first_s = serve(ledger, LEDGER_TXNS - 2047, LEDGER_TXNS,
                           LEDGER_TXNS)
    ledger.append_txns_metadata(commit, txn_time=TXN_TIME)
    ledger.stage_txns_collect(ledger.stage_txns_dispatch(commit))
    ledger.commitTxns(len(commit))
    till = LEDGER_TXNS + COMMIT_BATCH
    lagged = eng.tree_size
    lo = till - CATCHUP_TAIL + 1
    reps, serve_s = serve(ledger, lo, till, till)
    launches = launch_counts()
    stats = dict(eng.dispatch_stats)
    log("phase 8 launches: {} | warm build of {} leaf digests {:.3f} ms; "
        "CatchupReq of 2,048 txns {:.3f} s; of {} txns up to {} (engine "
        "synced from {}) {:.3f} s".format(
            launches, LEDGER_TXNS, warm_ms, first_s, CATCHUP_TAIL, till,
            lagged, serve_s))
    log("phase 8 dispatch stats: {}".format(json.dumps(stats)))

    # ---- checks
    t0 = time.perf_counter()
    check(stats["build_dispatches"] == 1 and lagged == LEDGER_TXNS
          and eng.tree_size == till and eng._cap == 2 * LEDGER_TXNS,
          "one warm build; the commit left the engine behind; the catchup's "
          "sync appended {} leaves and doubled the capacity".format(
              COMMIT_BATCH))
    groups = append_groups(LEDGER_TXNS, till, eng.fused_levels)
    check(launches["sha256_append_levels"] == len(groups)
          and launches["sha256_node_levels"] > 0
          and launches["sha256_ragged"] > 0,
          "the path launched sha256_append_levels ({} groups), "
          "sha256_node_levels and sha256_ragged".format(len(groups)))
    host = host_ledger()
    same_reps(first, serve(host_ledger(), LEDGER_TXNS - 2047, LEDGER_TXNS,
                           LEDGER_TXNS)[0], "2,048 txns")
    host_reps, host_s = serve(host, lo, till, till)
    same_reps(reps, host_reps, "{} txns".format(CATCHUP_TAIL))
    root = ledger.tree.root_hash
    check(eng.root_hash == root == host.tree.root_hash
          == ledger.tree.merkle_tree_hash(0, till),
          "the device tree's root equals the host tree's")
    verifier = MerkleVerifier(TreeHasher())
    served = 0
    for rep in reps:
        for seq, txn in rep["txns"].items():
            served += 1
            check(verifier.verify_leaf_inclusion(
                ledger.serialize_for_tree(txn), int(seq) - 1,
                [ledger.strToHash(h) for h in rep["auditPaths"][seq]],
                till, root), "the audit path of txn {} verifies".format(seq))
    check(served == CATCHUP_TAIL, "every txn of the range was served")

    # the append of the sync again, on the tree's own levels with the new
    # nodes blanked: the kernel, and its plain version on the CPU, against
    # the engine's nodes and the host tree's hash store
    new_rows = np.concatenate([
        np.arange(eng._offset(lv) + p0, eng._offset(lv) + p0 + cnt)
        for _, group in groups for lv, p0, cnt in group])
    done = eng._buf.clone()
    eng._buf[torch.from_numpy(new_rows).to(dev)] = 0
    blank = eng._buf.cpu()
    k = eng.fused_levels
    _launch_append(sha, eng, groups, k)
    check(torch.equal(eng._buf, done),
          "the append's launches equal the synced tree")
    plain = type(eng)(device="cpu", fused_levels=eng.fused_levels)
    plain._buf, plain._cap = blank, eng._cap
    _launch_append(sha, plain, groups, k, sha.sha256_append_groups_plain)
    got = done.cpu()[torch.from_numpy(new_rows)]
    err = int((got.int() - plain._buf[torch.from_numpy(new_rows)].int())
              .abs().max())
    want = b"".join(ledger.tree.hash_store.read_subtree((p0 + i) << lv, lv)
                    for _, group in groups for lv, p0, cnt in group
                    for i in range(cnt))
    check(err == 0 and got.numpy().tobytes() == want,
          "sha256_append_levels equals its plain version and hashlib at "
          "the catchup's append ({} nodes)".format(new_rows.shape[0]))
    log("phase 8 checks: reps byte-equal to the host memo seeder's; {} "
        "audit paths verify; roots equal; the append's {} nodes == plain "
        "== hashlib ({:.1f} s)".format(served, new_rows.shape[0],
                                       time.perf_counter() - t0))

    # ---- times
    nodes = int(new_rows.shape[0])
    ms, _ = cuda_ms(torch, lambda: _launch_append(sha, eng, groups, k), 20)
    plain_ms, _ = once_ms(torch, lambda: _launch_append(
        sha, eng, groups, k, sha.sha256_append_groups_plain))
    alone = kernel_ms(torch, lambda: _launch_append(sha, eng, groups, k))
    top = [(groups[-1][0] + len(groups[-1][1]) - 1,
            [groups[-1][1][-1]])]          # the last level: one node
    level_ms = kernel_ms(torch, lambda: _launch_append(sha, eng, top, 1))
    check(torch.equal(eng._buf, done), "the timed launches changed nothing")
    # leaves read, new nodes written, once each
    b_ms, b_by = bound(2 * nodes * SHA256_OPS_PER_BLOCK,
                       32 * (COMMIT_BATCH + nodes))
    levels = sum(len(g) for _, g in groups)
    n_launch = len(sha.append_launches([len(g) for _, g in groups]))
    floor_ms = levels * ceilings["node"]["per_node_ms"] \
        + n_launch * ceilings["empty_launch_ms"]
    log("sha256_append_levels at the catchup's append ({} leaves onto {}: "
        "{} nodes on {} levels in {} launches of K = {}, one call): kernel "
        "alone {:.5f} ms, bound {:.6f} ms ({}), {:.3%} of it; latency "
        "floor {:.5f} ms ({} levels x one node hash {:.5f} ms + {} "
        "launches x an empty launch {:.5f} ms), the kernel {:.2f}x it; "
        "one level of one node (latency) {:.5f} ms; wrapper (cuda_ms, one "
        "call) {:.5f} ms; plain version {:.3f} ms".format(
            COMMIT_BATCH, LEDGER_TXNS, nodes, levels, n_launch, k, alone,
            b_ms, b_by, b_ms / alone, floor_ms, levels,
            ceilings["node"]["per_node_ms"], n_launch,
            ceilings["empty_launch_ms"], alone / floor_ms, level_ms, ms,
            plain_ms))

    idx = np.arange(lo - 1, lo - 1 + conf.MERKLE_DEVICE_PROOF_MIN)
    g = min(eng._n_low(), till.bit_length() - 1)
    rows = eng._upload(eng.sibling_rows(idx, g))
    gather_ms = kernel_ms(torch, lambda: eng._buf.index_select(0, rows))
    log("proof gather (index_select of {} leaves x {} levels, {} bytes): "
        "{:.5f} ms on the card".format(idx.shape[0], g, 32 * rows.shape[0],
                                       gather_ms))

    spans = [(glo - 1, min(glo + conf.MERKLE_DEVICE_PROOF_MIN - 1, till))
             for glo in range(lo, till + 1, conf.MERKLE_DEVICE_PROOF_MIN)]

    def proofs(tree):
        for a, b in spans:
            tree.inclusion_proofs_batch(list(range(a, b)), till)
        torch.cuda.synchronize()

    walls = {"device": [], "host": []}
    for which in ("device", "host", "host", "device"):
        tree = ledger.tree if which == "device" else host.tree
        t = time.perf_counter()
        proofs(tree)
        walls[which].append(time.perf_counter() - t)
    pps = {k: [CATCHUP_TAIL / w for w in v] for k, v in walls.items()}
    log("proofs of the {} txns in {} groups, in turns device, host, host, "
        "device: device {} s ({} proofs/s), host memo {} s ({} proofs/s)"
        .format(CATCHUP_TAIL, len(spans),
                " / ".join("{:.4f}".format(w) for w in walls["device"]),
                " / ".join("{:.0f}".format(p) for p in pps["device"]),
                " / ".join("{:.4f}".format(w) for w in walls["host"]),
                " / ".join("{:.0f}".format(p) for p in pps["host"])))
    if profile:
        # the device's share of a proofs turn: its busy time under
        # torch.profiler against the unprofiled turns' wall (the profiler
        # slows the host many times over)
        busy, _ = device_time(torch, lambda: proofs(ledger.tree))
        total = sum(us for us, _ in busy.values()) / 1e3
        wall = 1e3 * min(walls["device"])
        log("device proof path under torch.profiler: device busy {:.3f} ms "
            "against {:.3f} ms of unprofiled wall, idle share {:.6f}".format(
                total, wall, 1 - total / wall) if busy else
            "device proof path: device time not measured (no device "
            "events traced)")
        for name, (us, count) in sorted(busy.items(),
                                        key=lambda kv: -kv[1][0])[:6]:
            log("  device {:.4f} ms  x{}  {}".format(us / 1e3, count,
                                                      name[:90]))
        where_the_time_goes(torch, lambda: serve(ledger, lo, till, till),
                            "catchup seeding")
    return {"launches": launches, "err": err, "entry": {
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "kernel_ms": alone, "floor_ms": floor_ms, "level_latency_ms": level_ms,
        "gather_ms": gather_ms, "warm_build_ms": warm_ms,
        "proofs_per_s": pps}}


def aggregate_phase(torch, dev, g1_in, g2_in, agg_jobs, shares, keys, core,
                    ceilings):
    """The aggregates beyond the path's check: each against its plain
    version on the adversarial sets; each launch's three stages timed
    apart (prep, sum, store: kernel alone on a scratch the full launch
    filled); the latency floor of each on the path's inputs from this
    run's field core (a multiply's, a squaring's and an inversion's
    latency) and an empty launch; the host library's time for the same
    256 G1 jobs beside the wall of aggregate_g1_jobs split into pack,
    kernel and collect. → {entry name: fields for its kernels-line row}."""
    from plenum_tpu_torch import testing
    from plenum_tpu_torch.crypto import bls_ops
    from plenum_tpu_torch.ops import bls381, bls381_pairing as bp
    funcs = {"g1": (bls381.pack_g1_jobs, bls381.g1_aggregate_cuda,
                    bls381.g1_aggregate_plain, bls381.g1_aggregate_scratch),
             "g2": (bp.pack_g2_jobs, bp.g2_aggregate_cuda,
                    bp.g2_aggregate_plain, bp.g2_aggregate_scratch)}
    # past the distinct points, testing.aggregate_jobs' adversarial cases;
    # G1 at n = 130, more than a block of the decompression launch holds,
    # G2 at 34 against its 32 keys
    sets = {(group, n): testing.aggregate_jobs(group, pts, n)
            for group, pts, n in (("g1", shares, 5), ("g1", shares, 130),
                                  ("g2", keys, 34))}
    for (group, n), jobs in sets.items():
        pack, cuda_fn, plain_fn, _ = funcs[group]
        t = bls381.upload(pack(jobs, n), dev)
        got, want = cuda_fn(*t), plain_fn(*t)
        check(all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(got, want)),
              "bls_{}_aggregate equals its plain version on the adversarial "
              "set at n = {} ({} distinct points)".format(
                  group, n, int(t[0].shape[0])))
        check(got[3].cpu().tolist()[:9] == testing.AGGREGATE_JOBS_OK,
              "bls_{}_aggregate voids exactly the jobs with a bad point "
              "(n = {})".format(group, n))
        # an index past the table and a negative one void their jobs
        index = t[-1].clone()
        index[1, 0], index[2, 1] = int(t[0].shape[0]), -1
        got, want = cuda_fn(*t[:-1], index), plain_fn(*t[:-1], index)
        check(all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(got, want))
              and got[3].cpu().tolist()[:3] == [True, False, False],
              "bls_{}_aggregate voids the jobs whose index leaves the table, "
              "as its plain version (n = {})".format(group, n))
    log("bls aggregates == plain on the adversarial sets {}".format(
        [(g, n, len(j)) for (g, n), j in sets.items()]))

    mul_ns, sqr_ns = (core["fp_mul"]["latency_ns"],
                      core["fp_sqr"]["latency_ns"])
    inv_ns, fermat_ns = (core["fp_inv_var"]["latency_ns"],
                         core["fp_inv"]["latency_ns"])
    # each stage's critical path in (multiplies, squarings): a point's
    # decompression on one lane; the sum's levels of products (two an
    # addition: the longest sextet's mixed additions, then the tree);
    # the store's products around its one inversion
    prep = {"g1": bls381.COST["g1_decompress"],
            "g2": bls381.COST["g2_decompress"]}
    store = {"g1": bls381.G1_STORE, "g2": 2 * bls381.S + 9 * bls381.M}
    rows = {}
    for group, tensors in (("g1", g1_in), ("g2", g2_in)):
        _, cuda_fn, _, scratch_fn = funcs[group]
        D, (B, n) = int(tensors[0].shape[0]), tuple(tensors[-1].shape)
        scratch = scratch_fn(B, D, dev)
        first = cuda_fn(*tensors, scratch=scratch)
        stage_ms = [kernel_ms(torch, lambda st=st: cuda_fn(
            *tensors, scratch=scratch, stages=(st, st)), reps=5)
            for st in range(3)]
        again = cuda_fn(*tensors, scratch=scratch)
        check(all(torch.equal(a, b) for a, b in zip(first, again)),
              "bls_{}_aggregate on a reused scratch equals its first "
              "launch".format(group))
        inf, valid, index = (t.cpu().numpy() for t in tensors[-3:])
        finite = (valid != 0) & (inf == 0)
        groups = bls381.AGG_SUM_GROUPS[group]
        madds = max(max(int(finite[index[b, g::groups]].sum()) - 1, 0)
                    for b in range(B) for g in range(groups))
        levels = 2 * madds + 2 * (groups - 1).bit_length()
        chain = prep[group] + levels * bls381.M + store[group]
        floor_ms = (chain[0] * mul_ns + chain[1] * sqr_ns + inv_ns) / 1e6 \
            + 3 * ceilings["empty_launch_ms"]
        rows["bls_{}_aggregate".format(group)] = dict(
            kernel_ms_per_stage={"prep": stage_ms[0], "sum": stage_ms[1],
                                 "store": stage_ms[2]},
            floor_ms=floor_ms,
            floor_chain={"fp_mul": int(chain[0]), "fp_sqr": int(chain[1]),
                         "inversions": 1, "launches": 3},
            shape="{} jobs x {}, {} distinct points".format(B, n, D))
        log("bls_{}_aggregate at {} jobs x {} ({} distinct): per stage prep "
            "{:.4f} + sum {:.4f} + store {:.4f} ms; latency floor {:.4f} ms "
            "({} multiplies x {:.1f} ns + {} squarings x {:.1f} ns + an "
            "inversion {:.1f} ns + 3 launches x {:.5f} ms)".format(
                group, B, n, D, *stage_ms, floor_ms, int(chain[0]), mul_ns,
                int(chain[1]), sqr_ns, inv_ns, ceilings["empty_launch_ms"]))
    log("bls inversion on one thread: safegcd {:.1f} ns, Fermat {:.1f} ns "
        "({:.1f}x)".format(inv_ns, fermat_ns, fermat_ns / inv_ns))

    # bench.py micro_bls's vs_cpu_floor: the host library on the same 256
    # jobs, beside aggregate_g1_jobs's wall split into its parts
    def median3(fn):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = fn()
            times.append(1e3 * (time.perf_counter() - t0))
        return sorted(times)[1], out
    host_ms, host_pts = median3(lambda: [bls_ops.g1_aggregate_compressed(j)
                                         for j in agg_jobs])
    n = max(len(j) for j in agg_jobs)
    parts = {"pack": [], "kernel": [], "collect": []}
    for _ in range(3):
        t0 = time.perf_counter()
        t = bls381.upload(bls381.pack_g1_jobs(agg_jobs, n), dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = bls381.g1_aggregate_cuda(*t)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        pts, _ = bls381.aggregate_collect(out)
        t3 = time.perf_counter()
        for key, v in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[key].append(1e3 * v)
    wall_ms, (wall_pts, _) = median3(lambda: bls381.aggregate_g1_jobs(
        agg_jobs, dev))
    check(pts == wall_pts == host_pts,
          "aggregate_g1_jobs equals the host library's g1_aggregate_compressed"
          " on the {} jobs".format(len(agg_jobs)))
    split = {k: sorted(v)[1] for k, v in parts.items()}
    log("bls G1 aggregate of {} jobs: host library {:.2f} ms; "
        "aggregate_g1_jobs {:.2f} ms (pack {:.2f}, kernel {:.2f}, collect "
        "{:.2f})".format(len(agg_jobs), host_ms, wall_ms, split["pack"],
                         split["kernel"], split["collect"]))
    rows["bls_g1_aggregate"].update(host_library_ms=host_ms,
                                    wall_ms=dict(split, total=wall_ms))
    for row in rows.values():
        row.update(inversion_ns={"safegcd": inv_ns, "fermat": fermat_ns})
    return rows


BLS_VALIDATORS = (4, 25, 100)   # BASELINE.json config 3
BLS_AGG_JOBS = 256               # bench.py micro_bls: 256 jobs x 100 shares
BLS_AGG_MESSAGES = 16            # distinct signed roots among those jobs
BLS_COMMITS = 10000              # state-proof commits verified at n = 100
BLS_CREATE_CHECK = 16            # commits also held against create_multi_sig
BLS_SAMPLE = 1024                # honest jobs held against the plain version
BLS_MSM_POINTS = (8, 4096)
READ_WRITES = 4000               # the BLS pool's writes, in two chunks
READ_TAMPERED = 16


def bls_phase(torch, dev, ceilings):
    """Phase 9: the BLS12-381 kernels (csrc/bls381*.cu) on config 3 of
    BASELINE.json and on the read path. Counts are zeroed just before
    each of the two paths and read just after it; the comparisons with
    the plain versions and the timings come after. → {"launches",
    "kernels"}."""
    import random
    from plenum_tpu_torch import bls_field_core, carry
    from plenum_tpu_torch.client.client import PoolClient
    from plenum_tpu_torch.common.config import Config
    from plenum_tpu_torch.common.constants import TARGET_NYM
    from plenum_tpu_torch.common.serializers.base58 import b58encode
    from plenum_tpu_torch.crypto import bls, bls_ops
    from plenum_tpu_torch.crypto.signer import SimpleSigner
    from plenum_tpu_torch.ops import bls381, bls381_pairing as bp
    from plenum_tpu_torch.testing import pool

    t_phase = t0 = time.perf_counter()
    rng = random.Random(SEED)
    keys = [bls.generate_bls_keys(hashlib.sha256(
        b"bls-validator-%d-%d" % (SEED, i)).digest())[:2]
        for i in range(max(BLS_VALIDATORS))]
    signers = carry.bls_signers(keys)
    pks = [s.pk for s in signers]
    sk_sum = sum(sk for sk, _ in keys) % bls_ops.R
    agg_msgs = [b"state-root-commitment-%d" % i
                for i in range(BLS_AGG_MESSAGES)]
    agg_shares = [[bls.b58_decode(s.sign(m)) for s in signers]
                  for m in agg_msgs]
    agg_jobs = [agg_shares[j % BLS_AGG_MESSAGES] for j in range(BLS_AGG_JOBS)]
    g2_jobs = [[bls.b58_decode(pk) for pk in pks[:n]] for n in BLS_VALIDATORS]
    value = [bls.MultiSignatureValue(
        1, b58encode(rng.randbytes(32)), b58encode(rng.randbytes(32)),
        b58encode(rng.randbytes(32)), TXN_TIME + i)
        for i in range(BLS_COMMITS)]
    msgs = [v.as_single_value() for v in value]
    multis = [bls.b58_encode(bls_ops.g1_compress(bls_ops.g1_mul(
        bls_ops.hash_to_g1(m, b"PLENUM_TPU_BLS_SIG"), sk_sum)))
        for m in msgs]
    verifier = bls.BlsCryptoVerifierPlenum(
        device_pairing=True, pairing_device_min=Config.BLS_PAIRING_DEVICE_MIN,
        device=dev)
    for i in range(BLS_CREATE_CHECK):
        check(multis[i] == verifier.create_multi_sig(
            [s.sign(msgs[i]) for s in signers]),
            "commit {}'s multi-signature equals create_multi_sig of its "
            "{} shares".format(i, len(signers)))
    # verify-level adversarial checks, in the same launch as the commits
    flipped = bytearray(bls.b58_decode(multis[0]))
    flipped[-1] ^= 1
    foreign = bls.generate_bls_keys(b"foreign")[1]
    adv_checks = [(multis[0], msgs[1], pks),           # wrong message
                  (multis[1], msgs[0], pks),           # another commit's
                  (bls.b58_encode(bytes(flipped)), msgs[0], pks),
                  (multis[2], msgs[2], pks[:-1]),      # a subset of keys
                  (multis[2], msgs[2], pks[:-1] + [foreign]),
                  (multis[3], msgs[3], pks[::-1]),     # reordered: valid
                  (multis[3], msgs[3], [])]
    checks = [(m, msg, pks) for m, msg in zip(multis, msgs)] + adv_checks
    log("bls set-up: {} validators' keys, {} x {} shares, {} commits' "
        "multi-signatures (the first {} equal to create_multi_sig) in "
        "{:.1f} s".format(len(signers), BLS_AGG_MESSAGES, len(signers),
                          BLS_COMMITS, BLS_CREATE_CHECK,
                          time.perf_counter() - t0))

    # the read path's pool: four nodes with BLS signers (n = 4)
    read_signers = carry.bls_signers(keys[:len(pool.NAMES)])
    bls_by_name = dict(zip(pool.NAMES, read_signers))
    writer = SimpleSigner(seed=hashlib.sha256(b"bls-reader").digest())
    writes = pool.make_requests(READ_WRITES, writer)
    chunks = [writes[:READ_WRITES // 2], writes[READ_WRITES // 2:]]

    # the launches of the path, recorded on their way to the wrappers so
    # that they can be replayed against the plain versions afterwards
    recorded = {"pairing": [], "g1_aggregate": [], "g2_aggregate": [],
                "msm": []}
    real = {"pairing": bp.pairing, "g1_aggregate": bls381.g1_aggregate,
            "g2_aggregate": bp.g2_aggregate, "msm": bp.msm}

    # each pairing launch on the path between CUDA events: its device time
    # inside the verify, beside the verify's collect
    launch_events = []

    def recording(name):
        def fn(*tensors):
            recorded[name].append(tensors)
            if name != "pairing":
                return real[name](*tensors)
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = real[name](*tensors)
            ev[1].record()
            launch_events.append((int(tensors[0].shape[0]), ev))
            return out
        return fn

    times = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        times[name] = time.perf_counter() - t
        return out

    wrappers = {"bls_pairing": bp.pairing_cuda,
                "bls_g1_aggregate": bls381.g1_aggregate_cuda,
                "bls_g2_aggregate": bp.g2_aggregate_cuda,
                "bls_g1_msm": bp.msm_cuda}

    def zero_counts():
        for fn in wrappers.values():
            fn.launches = 0

    def read_counts():
        return {name: fn.launches for name, fn in wrappers.items()}

    # the verify goes through verify_multi_sigs_batch; its host pre-checks
    # end where it hands its jobs to multi_pairing_is_one_jobs, whose
    # pairing_jobs calls pairing_dispatch and pairing_collect
    seen = {}
    real_jobs_fn = bls_ops.multi_pairing_is_one_jobs
    real_dispatch, real_collect = bp.pairing_dispatch, bp.pairing_collect

    def jobs_seen(jobs, *args):
        seen["t"] = time.perf_counter()
        seen["jobs"] = [list(j) for j in jobs]
        return real_jobs_fn(seen["jobs"], *args)

    zero_counts()
    bp.pairing, bp.g2_aggregate, bp.msm = (
        recording("pairing"), recording("g2_aggregate"), recording("msm"))
    bls381.g1_aggregate = recording("g1_aggregate")
    try:
        t_path = time.perf_counter()
        agg_points, agg_ok = timed("g1_aggregate", bls381.aggregate_g1_jobs,
                                   agg_jobs, dev)
        g2_points, g2_ok = timed("g2_aggregate", lambda: bp.
                                 g2_aggregate_collect(bp.g2_aggregate_dispatch(
                                     g2_jobs, max(BLS_VALIDATORS), dev)))
        # the verify, split: host pre-checks, dispatch, collect
        bls_ops.multi_pairing_is_one_jobs = jobs_seen
        bp.pairing_dispatch = lambda *a: timed("verify_dispatch",
                                               real_dispatch, *a)
        bp.pairing_collect = lambda *a: timed("verify_collect",
                                              real_collect, *a)
        try:
            t = time.perf_counter()
            verdicts = verifier.verify_multi_sigs_batch(checks)
        finally:
            bls_ops.multi_pairing_is_one_jobs = real_jobs_fn
            bp.pairing_dispatch, bp.pairing_collect = (real_dispatch,
                                                       real_collect)
        times["verify_prechecks"] = seen["t"] - t
        jobs = seen["jobs"]
        msm_out = {}
        for n in BLS_MSM_POINTS:
            pts = [agg_shares[k % BLS_AGG_MESSAGES][k % len(signers)]
                   for k in range(n)]
            ss = [rng.randrange(bls_ops.R) for _ in range(n)]
            msm_out[n] = (pts, ss, timed("msm_%d" % n, bls_ops.g1_msm, pts,
                                         ss, True, Config.BLS_MSM_DEVICE_MIN,
                                         dev))
        config3_launches = read_counts()
        zero_counts()
        # the read path
        nodes, timer = pool.make_sim_pool(pool.NAMES, "torch_hub",
                                          device=dev, bls_signers=bls_by_name)
        sent = []
        reader = nodes[1]
        reader._reply_to_client = lambda c, m: sent.append(m)
        client = PoolClient(None, pool.NAMES, lambda n, m: None,
                            bls_verifier=bls.BlsCryptoVerifierPlenum(
                                device_pairing=True,
                                pairing_device_min=Config
                                .BLS_PAIRING_DEVICE_MIN, device=dev),
                            bls_key_provider={
                                n: s.pk for n, s in bls_by_name.items()}.get)
        read_results, proof_verdicts, roots = [], [], []
        ordered = 0
        for k, chunk in enumerate(chunks):
            t = time.perf_counter()
            pool.pipelined_intake(nodes, timer, [chunk], "bls-client",
                                  expected=lambda n, base=ordered: base + n)
            ordered += len(chunk)
            for _ in range(3000):
                root = reader.db_manager.get_state(1).committedHeadHash_b58
                if all(nd.domain_ledger.size >= ordered for nd in nodes) \
                        and reader.db_manager.bls_store.get(root):
                    break
                for nd in nodes:
                    nd.service()
                timer.run_for(0.01)
            times["read_writes_%d" % k] = time.perf_counter() - t
            roots.append(root)
            t = time.perf_counter()
            del sent[:]
            reader.process_client_batch([({
                "identifier": writer.identifier,
                "reqId": 10 ** 7 + k * 10 ** 5 + i,
                "operation": {"type": "105",
                              TARGET_NYM: r["operation"][TARGET_NYM]}},
                "reader") for i, r in enumerate(chunk)])
            results = [m.to_dict()["result"] for m in sent]
            times["read_serve_%d" % k] = time.perf_counter() - t
            proof_checks = [(r.get("state_proof"),)
                            + PoolClient._expected_state_kv(r)
                            for r in results]
            proof_verdicts.append(timed("read_check_%d" % k,
                                        client.check_proof_dicts,
                                        proof_checks))
            read_results.append(results)
        tampered, want_msgs = [], []
        for i, r in enumerate(read_results[1][:READ_TAMPERED]):
            sp = json.loads(json.dumps(r["state_proof"]))
            key, val = PoolClient._expected_state_kv(r)
            if i % 3 == 0:
                raw = bytearray(bls.b58_decode(
                    sp["multi_signature"]["signature"]))
                raw[-1] ^= 1
                sp["multi_signature"]["signature"] = bls.b58_encode(bytes(raw))
                want_msgs.append("multi-sig invalid: aggregate signature "
                                 "does not verify against the registered "
                                 "keys")
            elif i % 3 == 1:
                val = val[:-1] + bytes([val[-1] ^ 1])
                want_msgs.append("proof-node corruption: proof nodes do not "
                                 "tie the claimed value to the signed root")
            else:
                sp["root_hash"] = roots[0]
                want_msgs.append(
                    "root mismatch: multi-signature vouches for root %r, "
                    "proof claims %r" % (roots[1], roots[0]))
            tampered.append((sp, key, val))
        tampered_verdicts = client.check_proof_dicts(tampered)
        torch.cuda.synchronize()
        read_launches = read_counts()
        path_s = time.perf_counter() - t_path
    finally:
        bp.pairing, bp.g2_aggregate, bp.msm = (
            real["pairing"], real["g2_aggregate"], real["msm"])
        bls381.g1_aggregate = real["g1_aggregate"]
    launches = {name: config3_launches[name] + read_launches[name]
                for name in wrappers}
    log("bls path launches: config 3 {}, read path {} in {:.1f} s; host "
        "seconds: {}".format(config3_launches, read_launches, path_s,
                             json.dumps({k: round(v, 4)
                                         for k, v in times.items()})))

    # ---- the path's checks
    t0 = time.perf_counter()
    check(all(config3_launches[k] > 0 for k in wrappers),
          "every BLS kernel launched on config 3's path")
    check(read_launches["bls_pairing"] > 0,
          "the read path's check_proof_dicts launched bls_pairing")
    check(agg_ok.all(), "every 100-share aggregate decoded")
    want_agg = [bls_ops.g1_aggregate_compressed(s) for s in agg_shares]
    check(all(p == want_agg[j % BLS_AGG_MESSAGES]
              for j, p in enumerate(agg_points)),
          "the {} x {} G1 aggregate equals g1_aggregate_compressed".format(
              BLS_AGG_JOBS, len(signers)))
    for n, got in zip(BLS_VALIDATORS, g2_points):
        want = None
        for pk in pks[:n]:
            want = bls_ops.g2_add(want, bls_ops.g2_decompress(
                bls.b58_decode(pk)))
        check(got == ((want[0].c0, want[0].c1), (want[1].c0, want[1].c1)),
              "the G2 aggregate of {} public keys equals the host sum".format(
                  n))
    check(all(verdicts[:BLS_COMMITS]),
          "every one of the {} honest commits verifies".format(BLS_COMMITS))
    scalar = [verifier.verify_multi_sig(*c) for c in adv_checks]
    check(verdicts[BLS_COMMITS:] == scalar,
          "the adversarial checks' verdicts equal the scalar path's {}"
          .format(scalar))
    for n, (pts, ss, got) in msm_out.items():
        check(got == bls_ops.g1_msm(pts, ss),
              "g1_msm on the card equals the host double-and-add at {} "
              "points".format(n))
    check(all(v is None for vs in proof_verdicts for v in vs)
          and sum(map(len, proof_verdicts)) == READ_WRITES,
          "all {} read replies' state proofs check valid".format(
              READ_WRITES))
    check(len(set(roots)) == 2, "the two chunks' reads carry two roots")
    check(tampered_verdicts == want_msgs,
          "the tampered replies fail with the JAX package's messages")
    log("bls checks: the {} x {} aggregate == g1_aggregate_compressed, the "
        "G2 aggregates of {} keys == the host sums, {} honest commits True "
        "and the adversarial checks {} as the scalar path, MSM at {} points "
        "== host, {} read proofs valid under 2 roots and {} tampered ones "
        "failing as expected ({:.1f} s)".format(
            BLS_AGG_JOBS, len(signers), BLS_VALIDATORS, BLS_COMMITS, scalar,
            BLS_MSM_POINTS, READ_WRITES, READ_TAMPERED,
            time.perf_counter() - t0))

    # ---- the field core: one multiply's and one squaring's latency on one
    # thread, their rate across the card, every chain checked
    t = time.perf_counter()
    core = bls_field_core.measure(dev)
    log(json.dumps({"bls_field_core": core}))
    log("bls field core measured in {:.1f} s".format(time.perf_counter() - t))

    # ---- the adversarial pairing jobs of tests/test_bls381_pairing.py
    G1I, G2I = bls381.G1_INF, bls381.G2_INF
    neg_g2 = bls_ops.g2_compress(bls_ops.g2_neg(bls_ops.G2_GEN))
    good = jobs[0]
    flip = bytearray(good[0][0])
    flip[19] ^= 0x10
    x = 3
    while True:              # an on-curve G1 point outside the subgroup
        yy = (x * x * x + 4) % bls_ops.Q
        y = pow(yy, (bls_ops.Q + 1) // 4, bls_ops.Q)
        if y * y % bls_ops.Q == yy and not bls_ops.g1_in_subgroup((x, y)):
            break
        x += 1
    cp = bls_ops.g1_mul(bls_ops.G1_GEN, 5)
    g2gen = bls_ops.g2_compress(bls_ops.G2_GEN)
    adv_jobs = [good, [good[0], jobs[1][1]], [(bytes(flip), neg_g2), good[1]],
                [(G1I, g2gen)], [(bls_ops.g1_compress(cp), g2gen),
                                 (bls_ops.g1_compress(bls_ops.g1_neg(cp)),
                                  g2gen)],
                [(bls_ops.g1_compress((x, y)), g2gen)],
                [good[1], (G1I, G2I)], [(G1I, G2I), (G1I, G2I)]]
    host = [bls_ops.pairing_job_host(j) for j in adv_jobs]
    check(host == [True, False, False, False, True, False, False, True],
          "the adversarial jobs' host verdicts")
    arrays = bls381.upload(bp._pack_pair_arrays(adv_jobs, len(adv_jobs), 2),
                           dev)
    kv, kok = bp.pairing_cuda(*arrays)
    pv, pok = bp.pairing_plain(*arrays)
    pair_err = int((kv.cpu().int() - pv.cpu().int()).abs().max()
                   + (kok.cpu().int() - pok.cpu().int()).abs().max())
    check(pair_err == 0 and kv.cpu().tolist() == host,
          "bls_pairing equals its plain version and pairing_job_host on the "
          "adversarial jobs")

    # ---- each kernel against its plain version on the path's inputs, and
    # its times (ms: cuda_ms of the wrapper; kernel_ms: the kernel alone)
    card_rows = {}
    # the verify launch: its adversarial rows and a seeded sample
    pair_in = [t for t in recorded["pairing"] if t[0].shape[0] == len(jobs)]
    check(len(pair_in) == 1, "one pairing launch verified the commits")
    pair_in = pair_in[0]
    # every honest commit verified (checked above), so each made a job, and
    # jobs come in the order of the checks
    honest = BLS_COMMITS
    sample = sorted(set(random.Random(SEED).sample(range(honest),
                                                   BLS_SAMPLE))
                    | set(range(honest, len(jobs))))
    idx = torch.tensor(sample, device=dev)
    # the per-job arrays (G1 points, key indices) sampled, the keys whole
    sub = [t.index_select(0, idx).contiguous() for t in pair_in[:5]] \
        + list(pair_in[5:])
    pair_ms, (kv, kok) = cuda_ms(torch, lambda: bp.pairing_cuda(*pair_in), 2)
    plain_ms, (pv, pok) = once_ms(torch, lambda: bp.pairing_plain(*sub))
    pair_err = max(pair_err, int((kv.index_select(0, idx).cpu().int()
                                  - pv.cpu().int()).abs().max()
                                 + (kok.index_select(0, idx).cpu().int()
                                    - pok.cpu().int()).abs().max()))
    check(pair_err == 0, "bls_pairing equals its plain version on the "
                         "adversarial rows and {} honest jobs of the verify "
                         "launch".format(BLS_SAMPLE))
    pair_alone = kernel_ms(torch, lambda: bp.pairing_cuda(*pair_in), reps=2)
    cost = bp.pairing_cost(*bp.expand_keys(*(t.cpu().numpy()
                                              for t in pair_in)),
                           kok.cpu().numpy())
    nbytes = sum(t.numel() * t.element_size() for t in pair_in) \
        + 2 * len(jobs)
    b_ms, b_by = bound(bls381.int32_ops(cost), nbytes)
    # the launch's three kernels apart (lines and G1 decompression, Miller,
    # final exponentiation), each rerun on the scratch a full launch filled
    B, P, K = (int(pair_in[0].shape[0]), int(pair_in[0].shape[1]),
               int(pair_in[5].shape[0]))
    scratch = bp.pairing_scratch(B, P, K, dev)
    bp.pairing_cuda(*pair_in, scratch=scratch)
    split = [kernel_ms(torch, lambda st=st: bp.pairing_cuda(
        *pair_in, scratch=scratch, stages=(st, st)), reps=2)
        for st in range(3)]
    kv2, kok2 = bp.pairing_cuda(*pair_in, scratch=scratch)
    check(torch.equal(kv2, kv) and torch.equal(kok2, kok),
          "bls_pairing on a reused scratch equals its first launch")
    # the verify's own launch between CUDA events
    verify_launch = [ev for n, ev in launch_events if n == len(jobs)]
    check(len(verify_launch) == 1, "one timed pairing launch in the verify")
    verify_launch_ms = verify_launch[0][0].elapsed_time(verify_launch[0][1])
    # a node's share unroll at n = 4 (BLS_PAIRING_DEVICE_MIN): four jobs of
    # two pairs, one key each, on the kernel and on the host library
    unroll_msg = b"state-root-unroll"
    unroll_checks = [(s.sign(unroll_msg), unroll_msg, s.pk)
                     for s in signers[:Config.BLS_PAIRING_DEVICE_MIN]]
    captured = {}

    def capture(jobs_, *args):
        captured["jobs"] = [list(j) for j in jobs_]
        return real_jobs_fn(captured["jobs"], *args)
    bls_ops.multi_pairing_is_one_jobs = capture
    try:
        unroll_verdicts = verifier.verify_sigs_batch(unroll_checks)
    finally:
        bls_ops.multi_pairing_is_one_jobs = real_jobs_fn
    unroll_jobs = captured["jobs"]
    check(unroll_verdicts == [True] * len(unroll_checks)
          and len(unroll_jobs) == Config.BLS_PAIRING_DEVICE_MIN,
          "the share unroll's {} jobs verify on the card".format(
              len(unroll_jobs)))
    unroll_in = bls381.upload(bp._pack_pair_arrays(
        unroll_jobs, len(unroll_jobs), 2), dev)
    unroll_alone = kernel_ms(torch, lambda: bp.pairing_cuda(*unroll_in),
                             reps=5)
    unroll_trip = round_trip_ms(lambda: bp.pairing_jobs(unroll_jobs, dev),
                                reps=5)
    host_times = []
    for _ in range(5):
        t = time.perf_counter()
        host_v = [bls_ops.pairing_job_host(j) for j in unroll_jobs]
        host_times.append(1e3 * (time.perf_counter() - t))
    unroll_host = sorted(host_times)[len(host_times) // 2]
    check(host_v == [True] * len(unroll_jobs)
          and bp.pairing_jobs(unroll_jobs, dev)[0].tolist() == host_v,
          "the share unroll's verdicts on the card equal the host library's")
    log("bls_pairing at {} jobs x {} pairs ({} keys): kernel alone {:.4f} "
        "ms = lines and G1 {:.4f} + Miller {:.4f} + final exponentiation "
        "{:.4f}; the verify's own launch {:.4f} ms against its collect "
        "{:.4f} s; the share unroll at n = {} ({} jobs x 2 pairs): kernel "
        "alone {:.4f} ms, round trip {:.4f} ms, host library {:.4f} ms"
        .format(B, P, K, pair_alone, split[0], split[1], split[2],
                verify_launch_ms, times["verify_collect"],
                Config.BLS_PAIRING_DEVICE_MIN, len(unroll_jobs),
                unroll_alone, unroll_trip, unroll_host))
    card_rows["bls_pairing"] = dict(
        max_abs_err=pair_err, ms=pair_ms, kernel_ms=pair_alone,
        kernel_ms_per_launch={"lines": split[0], "miller": split[1],
                              "final_exp": split[2]},
        verify_launch_ms=verify_launch_ms,
        unroll_4_jobs={"kernel_ms": unroll_alone,
                       "round_trip_ms": unroll_trip,
                       "host_library_ms": unroll_host},
        plain_ms=plain_ms, plain_jobs=len(sample), bound_ms=b_ms,
        bound_by=b_by,
        shape="{} jobs x {} pairs, {} keys".format(B, P, K),
        fp_mul_sqr=cost.tolist())

    def entry(name, plain_fn, cuda_fn, tensors, count, reps):
        ms, got = cuda_ms(torch, lambda: cuda_fn(*tensors), reps)
        p_ms, want = once_ms(torch, lambda: plain_fn(*tensors))
        err = max(int((a.cpu().long() - b.cpu().long()).abs().max())
                  for a, b in zip(got, want))
        check(err == 0, "{} equals its plain version on the path's "
                        "inputs".format(name))
        alone = kernel_ms(torch, lambda: cuda_fn(*tensors), reps=reps)
        host = [t.cpu().numpy() for t in tensors]
        outs = [t.cpu().numpy() for t in got]
        cost = count(host, outs)
        nbytes = sum(t.numel() * t.element_size() for t in tensors + got)
        b_ms, b_by = bound(bls381.int32_ops(cost), nbytes)
        card_rows[name] = dict(max_abs_err=err, ms=ms, kernel_ms=alone,
                               plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                               shape=str([tuple(t.shape) for t in tensors][0]),
                               fp_mul_sqr=cost.tolist())

    entry("bls_g1_aggregate", bls381.g1_aggregate_plain,
          bls381.g1_aggregate_cuda, recorded["g1_aggregate"][0],
          lambda h, o: bls381.g1_aggregate_cost(*h, o[3], o[2]), 5)
    entry("bls_g2_aggregate", bp.g2_aggregate_plain, bp.g2_aggregate_cuda,
          recorded["g2_aggregate"][0],
          lambda h, o: bp.g2_aggregate_cost(*h, o[3], o[2]), 5)
    for name, extra in aggregate_phase(
            torch, dev, recorded["g1_aggregate"][0],
            recorded["g2_aggregate"][0], agg_jobs,
            [s for m in agg_shares for s in m],
            [bls.b58_decode(pk) for pk in pks], core, ceilings).items():
        card_rows[name].update(extra)
    msm_in = [t for t in recorded["msm"] if t[4].shape[0] == max(
        BLS_MSM_POINTS)][0]
    entry("bls_g1_msm", bp.msm_plain, bp.msm_cuda, msm_in,
          lambda h, o: bp.msm_cost(*bp.expand_points(*h), o[3], o[2]), 5)
    card_rows["bls_g1_msm"]["window_bits"] = bp.msm_window(
        int(msm_in[4].shape[0]))
    card_rows["bls_g1_msm"]["distinct_points"] = int(msm_in[0].shape[0])
    for small in recorded["msm"]:
        if small[4].shape[0] != msm_in[4].shape[0]:
            got, want = bp.msm_cuda(*small), bp.msm_plain(*small)
            check(all(torch.equal(a.cpu(), b.cpu()) for a, b in
                      zip(got, want)), "bls_g1_msm equals its plain version "
                                       "at {} points".format(
                                           small[4].shape[0]))
    for name, row in card_rows.items():
        log("{}: {} ms {:.4f}, kernel alone {:.4f} ms, bound {:.5f} ms ({}; "
            "the function's Montgomery multiplies, squarings and inversion "
            "multiply-adds {}), {:.3%} of it; plain {:.1f} ms; == plain"
            .format(
                name, row["shape"], row["ms"], row["kernel_ms"],
                row["bound_ms"], row["bound_by"], row["fp_mul_sqr"],
                row["bound_ms"] / row["kernel_ms"], row["plain_ms"]))

    # ---- no dispatch synchronises (lint_phase collects these launches
    # and holds them against the plain versions)
    with_sync_check = [
        ("ops/bls381_pairing.py:pairing_dispatch", lambda d: (
            lambda: bp.pairing_dispatch(adv_jobs, d), bp.pairing_collect)),
        ("ops/bls381.py:aggregate_dispatch", lambda d: (
            lambda: bls381.aggregate_dispatch(agg_jobs[:4], len(signers), d),
            bls381.aggregate_collect)),
        ("ops/bls381_pairing.py:msm_dispatch", lambda d: (
            lambda: bp.msm_dispatch(msm_out[8][0], msm_out[8][1], d),
            bp.msm_collect)),
        ("ops/bls381_pairing.py:g2_aggregate_dispatch", lambda d: (
            lambda: bp.g2_aggregate_dispatch(g2_jobs, max(BLS_VALIDATORS), d),
            bp.g2_aggregate_collect))]
    synced = sync_checked(torch, dev, with_sync_check)
    log("bls: {} launched under set_sync_debug_mode(\"error\")".format(
        [n.rsplit(":", 1)[1] for n, _ in with_sync_check]))
    log("phase 9 (bls): {:.1f} s".format(time.perf_counter() - t_phase))
    replaces = {"bls_pairing": "plenum_tpu/ops/bls381_pairing.py:241",
                "bls_g1_aggregate": "plenum_tpu/ops/bls381_jax.py:363",
                "bls_g2_aggregate": "plenum_tpu/ops/bls381_pairing.py:342",
                "bls_g1_msm": "plenum_tpu/ops/bls381_pairing.py:285"}
    sources = {"bls_pairing": "bls381.cu", "bls_g1_aggregate": "bls381_agg.cu",
               "bls_g2_aggregate": "bls381_agg.cu",
               "bls_g1_msm": "bls381_msm.cu"}
    kernels = [dict({"name": name, "route": "cuda",
                     "source": "plenum_tpu_torch/csrc/" + sources[name],
                     "replaces": replaces[name],
                     "launches": launches[name],
                     "launches_by_path": {"config3": config3_launches[name],
                                          "read": read_launches[name]},
                     "library_ms": None},
                    **card_rows[name]) for name in replaces]
    return {"launches": launches, "kernels": kernels, "synced": synced,
            "mesh_inputs": {
                "agg_jobs": agg_jobs,
                "agg_want": [want_agg[j % BLS_AGG_MESSAGES]
                             for j in range(BLS_AGG_JOBS)],
                "pair_jobs": jobs, "honest": BLS_COMMITS}}


MESH_SHARDS = (2, 4)         # phase 13b: the card repeated 2 and 4 times
MESH_VERIFY = 8192           # bench.py micro_mesh's batch (seed 11, 256 keys)
MESH_PROOFS = 2048           # a catchup seeder's proof group
MESH_TRIE_ROWS = (1706, 3177)   # the pool's largest hashed / verified levels
MESH_PAIR_SAMPLE = 8         # honest pairing jobs held against the host
MESH_OVERHEAD_GATE_PCT = 5.0    # bench.py micro_mesh's gate


def mesh_phase(torch, dev, ed_set, blobs, leaf_digests, root, bls_in):
    """Phase 13: the device-mesh dispatcher (ops/mesh.py). 13a: the card's
    real mesh (its devices, the earlier paths' dispatch counts, bench.py
    micro_mesh's single-device overhead gate: verify_batch at 8,192
    signatures with the mesh consulted and passing through against the
    mesh disabled, interleaved best of 3, printed and not failed on).
    13b: a virtual mesh of the card repeated MESH_SHARDS times (shard_min
    1, min_per_device 1): every sharded seam at its path's size held
    byte-equal to its unsharded launch and its host oracle, each kernel's
    launches equal to the shards (counts zeroed before each sharded run,
    read after it), the mesh's counters as expected, each seam's wall
    sharded and unsharded printed. 13c: the same over the real cards, and
    micro_mesh's weak-scaling sweep, on a machine with two or more;
    otherwise one line that says why it was not made. The process mesh is
    restored afterwards. → {"launches": the sharded runs' launches}."""
    import random

    import numpy as np
    from plenum_tpu_torch.common.config import Config
    from plenum_tpu_torch.crypto import bls_ops, ed25519 as scalar
    from plenum_tpu_torch.crypto.fixtures import make_signed_batch
    from plenum_tpu_torch.ledger.merkle_verifier import MerkleVerifier
    from plenum_tpu_torch.ledger.tree_hasher import TreeHasher
    from plenum_tpu_torch.ops import (
        bls381, bls381_pairing as bp, cuda_lib, ed25519 as ed,
        launch_counts, mesh, trie)
    from plenum_tpu_torch.ops import sha256 as sha
    from plenum_tpu_torch.ops.merkle import DeviceMerkleTree
    from plenum_tpu_torch.server.verify_daemon import VerifyDaemon

    t_phase = time.perf_counter()
    m = mesh.get_mesh()
    cards = torch.cuda.device_count()
    hasher = TreeHasher()

    def sync_wall(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t, out

    # ---------------------------------------------- 13a: the real mesh
    before = mesh.mesh_stats()
    log("mesh 13a: n_devices {}, platform {}, cards {}; the process mesh "
        "after the earlier paths: {}".format(
            m.n_devices, mesh.probe_platform(), cards, json.dumps(before)))
    if m.n_devices == 1:
        check(before["sharded_dispatches"] == 0
              and before["passthrough_dispatches"] > 0,
              "on one card every dispatch of the earlier paths passed "
              "through the mesh")
    msgs, sigs, vks = make_signed_batch(MESH_VERIFY, seed=11, unique=256,
                                        msg_prefix=b"mesh")
    prior = (m.enabled, m.shard_min, m.max_devices, m.cpu_shard,
             m.min_per_device, m._given)
    launches = {}
    try:
        mesh.configure(enabled=True, shard_min=MESH_VERIFY + 1)
        ed.verify_batch(msgs, sigs, vks, dev)          # warm
        on_s, off_s = [], []
        for _ in range(3):
            mesh.configure(enabled=True)
            on_s.append(sync_wall(lambda: ed.verify_batch(
                msgs, sigs, vks, dev))[0])
            mesh.configure(enabled=False)
            off_s.append(sync_wall(lambda: ed.verify_batch(
                msgs, sigs, vks, dev))[0])
        overhead = 100.0 * (min(on_s) / min(off_s) - 1.0)
        log(json.dumps({"mesh_overhead": {
            "batch": MESH_VERIFY, "passthrough_s": on_s,
            "disabled_s": off_s, "single_device_overhead_pct": overhead,
            "overhead_gate_pct": MESH_OVERHEAD_GATE_PCT,
            "within_gate": overhead < MESH_OVERHEAD_GATE_PCT}}))

        # ------------ each seam unsharded (the mesh off), and its oracle
        a_msgs, a_sigs, a_vks, a_verdicts = ed_set
        a_want = [scalar.verify(*x) for x in
                  zip(a_msgs[:SCALAR_SUBSET], a_sigs[:SCALAR_SUBSET],
                      a_vks[:SCALAR_SUBSET])]
        items = list(zip(msgs, sigs, vks))
        unique = len(set(items))
        agg_jobs, agg_want = bls_in["agg_jobs"], bls_in["agg_want"]
        pair_jobs, honest = bls_in["pair_jobs"], bls_in["honest"]
        pair_sample = sorted(random.Random(SEED).sample(
            range(honest), MESH_PAIR_SAMPLE)) \
            + list(range(honest, len(pair_jobs)))
        pair_host = [bls_ops.pairing_job_host(pair_jobs[i])
                     for i in pair_sample]
        extra_raw = [b"mesh-append-%d" % i for i in range(COMMIT_BATCH)]
        extra = [hasher.hash_leaf(x) for x in extra_raw]
        size = LEDGER_TXNS + COMMIT_BATCH
        root2 = hasher.hash_children(root, hasher.hash_full_tree(extra_raw))
        proof_idx = sorted(random.Random(SEED).sample(range(size),
                                                      MESH_PROOFS))
        t_blobs = blobs[:MESH_TRIE_ROWS[0]]
        v_blobs = blobs[:MESH_TRIE_ROWS[1]]
        v_refs = [hashlib.sha3_256(b).digest() for b in v_blobs]
        v_refs[7] = bytes(32)
        daemon_conf = {"MESH_ENABLED": True, "MESH_SHARD_MIN": 1,
                       "MESH_MAX_DEVICES": 0}

        def built(digests=False):
            tree = DeviceMerkleTree(device=dev)
            if digests:
                tree.build_from_leaf_hashes(leaf_digests)
            else:
                tree.build(blobs)
            return tree

        def daemon_verify(enabled):
            daemon = VerifyDaemon(backend="torch_hub", device=dev,
                                  config=Config(**dict(
                                      daemon_conf, MESH_ENABLED=enabled)))
            try:
                return daemon._verify_bucketed(items), \
                    daemon._verifier.launches
            finally:
                daemon._pool.shutdown(wait=False)

        seams = {
            "ed25519_adversarial": lambda: ed.verify_batch(
                a_msgs, a_sigs, a_vks, dev),
            "ed25519_8192": lambda: ed.verify_batch(msgs, sigs, vks, dev),
            "g1_aggregate": lambda: bls381.aggregate_g1_jobs(agg_jobs, dev),
            "pairing": lambda: bp.pairing_jobs(pair_jobs, dev),
            "merkle_build": built,
            "merkle_build_digests": lambda: built(digests=True),
            "trie_hash": lambda: trie.collect_node_hash_batch(
                trie.dispatch_node_hash_batch(t_blobs, dev)),
            "trie_verify": lambda: trie.collect_node_verify_batch(
                trie.dispatch_node_verify_batch(v_blobs, v_refs, dev)),
        }
        mesh.configure(enabled=False)
        walls, ref = {}, {}
        for name, fn in seams.items():
            walls[name], ref[name] = sync_wall(fn)
        walls["daemon_bucketed"], (ref["daemon_bucketed"], _) = sync_wall(
            lambda: daemon_verify(False))
        t_ref = ref.pop("merkle_build")
        ref_levels = t_ref._buf.clone()
        launch_counts(reset=True)
        walls["merkle_append"], _ = sync_wall(
            lambda: t_ref.append_leaf_hashes(extra))
        append_launches = launch_counts(reset=True)
        walls["merkle_gather"], ref["merkle_gather"] = sync_wall(
            lambda: t_ref.inclusion_proofs(proof_idx))
        verifier = MerkleVerifier(hasher)
        check(ref["ed25519_adversarial"].tolist() == a_verdicts.tolist()
              and ref["ed25519_adversarial"][:SCALAR_SUBSET].tolist()
              == a_want, "the unsharded adversarial verdicts equal phase "
                         "2's and RFC 8032's")
        check(ref["ed25519_8192"].all()
              and ref["daemon_bucketed"] == [True] * MESH_VERIFY
              and all(scalar.verify(*x) for x in items[:256]),
              "the 8,192 signatures verify: unsharded, through the daemon, "
              "and by RFC 8032")
        check(ref["g1_aggregate"][0] == agg_want,
              "the unsharded G1 aggregate equals the host library's")
        check(ref["pairing"][0][:honest].all()
              and [bool(ref["pairing"][0][i]) for i in pair_sample]
              == pair_host, "the unsharded pairing: the honest jobs True, "
                            "the sample and the adversarial jobs as "
                            "pairing_job_host")
        check(torch.equal(ref.pop("merkle_build_digests")._buf, ref_levels)
              and t_ref.root_hash == root2,
              "the unsharded builds are equal, their root and the "
              "append's hashlib's")
        leaf_of = lambda i: blobs[i] if i < LEDGER_TXNS \
            else extra_raw[i - LEDGER_TXNS]              # noqa: E731
        check(all(verifier.verify_leaf_inclusion(leaf_of(i), i, p, size,
                                                 root2)
                  for i, p in zip(proof_idx, ref["merkle_gather"])),
              "the unsharded tree's {} proofs verify against hashlib's "
              "root".format(MESH_PROOFS))
        check(ref["trie_hash"].tobytes()
              == b"".join(hashlib.sha3_256(b).digest() for b in t_blobs)
              and ref["trie_verify"].tolist()
              == [i != 7 for i in range(len(v_blobs))],
              "the unsharded trie levels equal hashlib")
        wave = sha._node_wave(cuda_lib.load("sha256"), dev)

        def sharded(devices):
            """Every sharded seam over `devices` (none: the host's cards),
            each checked → {kernel: launches}."""
            mesh.configure(enabled=True, shard_min=1, min_per_device=1,
                           max_devices=0, devices=devices)
            d = m.n_devices
            got, s_walls = {}, {}

            def run(name, fn, rows, want):
                launch_counts(reset=True)
                n0 = m.sharded_dispatches
                s_walls[name], out = sync_wall(fn)
                counts = {k: v for k, v in launch_counts(reset=True).items()
                          if v}
                check(counts == want, "{} over {} shards launched {}, not "
                      "{}".format(name, d, counts, want))
                per = m.padded_size(rows) // d
                check(m.sharded_dispatches == n0 + 1
                      and m.last_per_device == per,
                      "{}: one sharded dispatch of {} rows a device".format(
                          name, per))
                for k, v in counts.items():
                    got[k] = got.get(k, 0) + v
                return out

            per = LEDGER_TXNS // d
            levels = d * len(sha.node_level_split(
                per, per.bit_length() - 1, wave)) \
                + len(sha.node_level_split(d, d.bit_length() - 1, wave))
            want = {"ed25519_adversarial": {"ed25519_verify": d},
                    "ed25519_8192": {"ed25519_verify": d},
                    "g1_aggregate": {"bls_g1_aggregate": d},
                    "pairing": {"bls_pairing": d},
                    "merkle_build": {"sha256_ragged": d,
                                     "sha256_node_levels": levels},
                    "merkle_build_digests": {"sha256_node_levels": levels},
                    "trie_hash": {"sha3_ragged": d},
                    "trie_verify": {"sha3_ragged_eq": d}}
            rows = {"ed25519_adversarial": len(a_msgs),
                    "ed25519_8192": MESH_VERIFY,
                    "g1_aggregate": len(agg_jobs),
                    "pairing": len(pair_jobs), "merkle_build": LEDGER_TXNS,
                    "merkle_build_digests": LEDGER_TXNS,
                    "trie_hash": len(t_blobs), "trie_verify": len(v_blobs)}
            out = {name: run(name, fn, rows[name], want[name])
                   for name, fn in seams.items()}
            # the daemon's hub launches the batch's distinct signatures
            out["daemon_bucketed"], hub_launches = run(
                "daemon_bucketed", lambda: daemon_verify(True), unique,
                {"ed25519_verify": d})
            tree = out.pop("merkle_build")
            check(torch.equal(tree._buf, ref_levels)
                  and torch.equal(out.pop("merkle_build_digests")._buf,
                                  ref_levels)
                  and tree.root_hash == root,
                  "the sharded builds from leaves and from digests are "
                  "byte-equal to the unsharded build, their root hashlib's")
            launch_counts(reset=True)
            tree.append_leaf_hashes(extra)
            check(launch_counts(reset=True) == append_launches
                  and torch.equal(tree._buf, t_ref._buf)
                  and tree.root_hash == root2,
                  "the append onto the sharded build equals the unsharded "
                  "tree's, byte for byte, and its root hashlib's")
            out["merkle_gather"] = run(
                "merkle_gather", lambda: tree.inclusion_proofs(proof_idx),
                MESH_PROOFS, {})
            for name, got_out in out.items():
                check(same_output(got_out, ref[name]),
                      "the sharded {} equals the unsharded launch".format(
                          name))
            check(hub_launches == [(unique, m.padded_size(unique))],
                  "the daemon's bucket of {} x {} devices made one launch "
                  "of its {} distinct signatures at the mesh's padded "
                  "size".format(Config.VERIFY_DAEMON_BUCKET, d, unique))
            log("mesh over {} shards ({}): every seam equal to its "
                "unsharded launch and its host oracle; wall sharded / "
                "unsharded (s): {}".format(
                    d, "{} x {}".format(len(devices), devices[0])
                    if devices else "the cards",
                    json.dumps({k: [v, walls[k]]
                                for k, v in s_walls.items()})))
            return got

        for k in MESH_SHARDS:
            for name, n in sharded([dev] * k).items():
                launches[name] = launches.get(name, 0) + n

        # ------------------------------------------ 13c: the real cards
        if cards >= 2:
            for name, n in sharded([]).items():
                launches[name] = launches.get(name, 0) + n
            log(json.dumps({"mesh_weak_scaling": _weak_scaling(
                torch, mesh, ed, make_signed_batch, dev)}))
        else:
            log("mesh 13c: the multi-card run was not made: this machine "
                "has {} card, so the sharded seams are checked on the "
                "virtual mesh only".format(cards))
    finally:
        mesh.configure(enabled=prior[0], shard_min=prior[1],
                       max_devices=prior[2], cpu_shard=prior[3],
                       min_per_device=prior[4], devices=prior[5] or [])
    log("phase 13 (mesh): launches of the sharded runs {} ({:.1f} s)".format(
        launches, time.perf_counter() - t_phase))
    return {"launches": launches}


def _weak_scaling(torch, mesh, ed, make_signed_batch, dev):
    """bench.py micro_mesh's weak-scaling sweep over the host's cards: a
    constant batch a card (max(512, 8,192 / cards)), d = 1, 2, 4 ...
    cards, four pipelined verify_batch_async calls two deep, best of 3;
    efficiency(d) = rate(d) / (d x rate(1))."""
    m = mesh.get_mesh()
    mesh.configure(devices=[], max_devices=0)
    n_all = m.n_devices
    per_dev = max(512, MESH_VERIFY // n_all)
    wm, ws, wv = make_signed_batch(per_dev * n_all, seed=11, unique=256,
                                   msg_prefix=b"mesh")
    sweep, d = {}, 1
    while d <= n_all:
        mesh.configure(enabled=True, max_devices=d, shard_min=1)
        n = per_dev * d
        sm, ss, sv = wm[:n], ws[:n], wv[:n]
        ed.verify_batch(sm, ss, sv, dev)                # warm

        def run():
            pend = []
            for _ in range(4):
                pend.append(ed.verify_batch_async(sm, ss, sv, dev))
                if len(pend) > 2:
                    pend.pop(0)[0].cpu()
            for h in pend:
                h[0].cpu()

        best = None
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            run()
            t = time.perf_counter() - t
            best = t if best is None else min(best, t)
        sweep[str(d)] = {"batch": n, "verify_per_s": 4 * n / best}
        d *= 2
    for entry in sweep.values():
        entry["scaling_efficiency_vs_1"] = entry["verify_per_s"] / (
            int(entry["batch"] // per_dev) * sweep["1"]["verify_per_s"])
    return sweep


def start_lint():
    """The port's analyzer (plenum_tpu_torch.analysis, the whole package
    against plenum_tpu_torch/lint_baseline.json) in a child process
    started after the build, so that its CPU seconds overlap the card's
    phases; lint_phase reads its line. The child is killed at exit if it
    still runs."""
    proc = subprocess.Popen(
        [sys.executable, "-c", LINT_CHILD,
         os.path.join(REPO, "plenum_tpu_torch")],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    atexit.register(stop)
    return proc


def sync_checked(torch, dev, calls):
    """Launch each dispatch half of `calls` — (name, prepare), where
    prepare(device) → (dispatch, collect) does the set-up a half needs
    and returns it ready to call — on `dev` under
    torch.cuda.set_sync_debug_mode("error"), so that a half that waits
    for the card raises. → {name: (prepare, handle, collect)}: the
    handles are collected later, by lint_phase."""
    ready = [(name, prepare) + tuple(prepare(dev)) for name, prepare in calls]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        handles = [(name, prepare, dispatch(), collect)
                   for name, prepare, dispatch, collect in ready]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return {name: (prepare, handle, collect)
            for name, prepare, handle, collect in handles}


def same_output(a, b):
    """Equal collected results: arrays element for element (and of one
    dtype and shape), sequences part by part, anything else by ==."""
    import numpy as np
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return isinstance(a, np.ndarray) and isinstance(b, np.ndarray) \
            and a.dtype == b.dtype and a.shape == b.shape \
            and np.array_equal(a, b)
    if isinstance(a, (tuple, list)):
        return isinstance(b, (tuple, list)) and len(a) == len(b) \
            and all(map(same_output, a, b))
    return a == b


def lint_phase(torch, dev, lint, synced):
    """The port's lint on the card's run. Reads the analyzer's child
    (start_lint): exit code 0 and no finding outside the baseline, printed
    as one {"lint": ...} line. Then PT002's check on the card: the
    analyzer's list of ops/ dispatch halves must be LINT_HALVES; every
    half runs once on LINT_ROWS-row inputs under
    set_sync_debug_mode("error") (sync_checked; `synced` holds the halves
    an earlier phase already ran so: phase 9's four BLS halves, launched
    there on its config's inputs), each result is collected by its own
    collect half and must equal the same dispatch and collect on the CPU,
    the plain versions. A Merkle tree's first proof batch after a build
    downloads its host mirrors, by design: each tree serves one batch
    before its checked one. → {"lint": the line's fields, "halves": the
    halves checked, "s": the phase's seconds}."""
    import numpy as np
    from plenum_tpu_torch import testing
    from plenum_tpu_torch.analysis.rules.pt002_host_sync import (
        list_dispatch_halves)
    from plenum_tpu_torch.ops import ed25519 as ed
    from plenum_tpu_torch.ops import mesh, trie
    from plenum_tpu_torch.ops import sha256 as sha
    from plenum_tpu_torch.ops.merkle import DeviceMerkleTree

    t_phase = time.perf_counter()
    try:
        out, err = lint.communicate(timeout=LINT_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        lint.kill()
        lint.communicate()
        raise RuntimeError("check failed: the analyzer ended within {} s"
                           .format(LINT_TIMEOUT_S))
    check(lint.returncode == 0 and out.strip(),
          "the analyzer's child ran: {}".format(err.strip()[-2000:]))
    result = json.loads(out.strip().splitlines()[-1])
    summary = result["report"]["summary"]
    line = {"files": summary["files"], "new": summary["new"],
            "baselined": summary["baselined"], "s": result["s"],
            "cpu_s": result["cpu_s"]}
    log(json.dumps({"lint": line}))
    for f in result["report"]["findings"]:
        if not f["baselined"]:
            log("  {}:{}:{}: {} {}".format(f["path"], f["line"], f["col"],
                                          f["rule"], f["message"]))
    check(result["rc"] == 0 and summary["new"] == 0,
          "the port's tree has no lint finding outside its baseline")

    # the check has teeth: a copy from pageable memory waits for the card
    # and must raise (why ops.to_tensor stages in pinned memory)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        torch.from_numpy(np.zeros(8, dtype=np.int32)).to(dev)
        refused = False
    except RuntimeError:
        refused = True
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    check(refused, "set_sync_debug_mode(\"error\") refuses a copy from "
                   "pageable memory")

    halves = list_dispatch_halves(REPO)
    check(tuple(halves) == LINT_HALVES,
          "the analyzer's dispatch halves {} are the ones this phase runs "
          "on the card".format(halves))

    rng = np.random.RandomState(SEED + 16)
    blobs = [rng.randint(0, 256, size=int(rng.randint(1, 600)),
                         dtype=np.uint8).tobytes() for _ in range(LINT_ROWS)]
    refs = [hashlib.sha3_256(b).digest() for b in blobs]
    refs[LINT_ROWS // 2] = bytes(32)
    msgs, sigs, vks, _ = testing.adversarial_signatures(LINT_ROWS, SEED + 16,
                                                        unique=8)
    ed_arrays, _ = ed.host_pack(msgs, sigs, vks)
    digests = rng.randint(0, 256, size=(LINT_TREE, 32), dtype=np.uint8)
    idx = sorted(int(i) for i in rng.choice(LINT_TREE, LINT_ROWS,
                                            replace=False))

    def tree_on(d, dispatch, collect):
        tree = DeviceMerkleTree(device=d)
        # gather the bottom levels on the device at this size (the class
        # keeps the top 2^18 nodes of a tree on the host)
        tree._TOP_CACHE = LINT_TREE >> 4
        tree.build_from_leaf_hashes(digests)
        collect(tree, dispatch(tree, idx[:1]))       # the mirror download
        return (lambda: dispatch(tree, idx),
                lambda h: collect(tree, h))

    def mesh_on(d):
        m = mesh.DeviceMesh(enabled=True, shard_min=1, min_per_device=1,
                            cpu_shard=True, devices=[d, d])
        padded = mesh.pad_rows(ed_arrays, m.padded_size(LINT_ROWS))
        return (lambda: m.dispatch(ed.verify, padded, n=LINT_ROWS,
                                   label="lint"),
                lambda outs: m.gather(outs, d)[:LINT_ROWS].cpu().numpy())

    def backend_on(d):
        backend = sha.TorchSha256Backend(d)
        return (lambda: backend.leaf_hashes_dispatch(blobs),
                backend.leaf_hashes_collect)

    own = [
        ("ops/ed25519.py:verify_batch_async", lambda d: (
            lambda: ed.verify_batch_async(msgs, sigs, vks, d),
            lambda h: h[0].cpu().numpy() & h[1])),
        ("ops/merkle.py:DeviceMerkleTree.dispatch_proof_batch",
         lambda d: tree_on(
             d, lambda t, i: t.dispatch_proof_batch(i),
             lambda t, h: t.collect_proof_batch(h))),
        ("ops/merkle.py:DeviceMerkleTree.dispatch_path_batch",
         lambda d: tree_on(
             d, lambda t, i: t.dispatch_path_batch(i),
             lambda t, h: t.collect_path_batch(h))),
        ("ops/mesh.py:DeviceMesh.dispatch", mesh_on),
        ("ops/sha256.py:sha256_many_dispatch", lambda d: (
            lambda: sha.sha256_many_dispatch(blobs, d, 0x00),
            sha.sha256_many_collect)),
        ("ops/sha256.py:TorchSha256Backend.leaf_hashes_dispatch",
         backend_on),
        ("ops/trie.py:dispatch_node_hash_batch", lambda d: (
            lambda: trie.dispatch_node_hash_batch(blobs, d),
            trie.collect_node_hash_batch)),
        ("ops/trie.py:dispatch_node_verify_batch", lambda d: (
            lambda: trie.dispatch_node_verify_batch(blobs, refs, d),
            trie.collect_node_verify_batch)),
    ]
    launched = dict(synced)
    launched.update(sync_checked(
        torch, dev, [(name, prepare) for name, prepare in own
                     if name not in synced]))
    check(sorted(launched) == sorted(LINT_HALVES),
          "every dispatch half ran on the card under the sync check")
    cpu = torch.device("cpu")
    got = {}
    for name in LINT_HALVES:
        prepare, handle, collect = launched[name]
        got[name] = collect(handle)
        dispatch, plain_collect = prepare(cpu)
        check(same_output(got[name], plain_collect(dispatch())),
              "{} on the card, collected, equals its plain version".format(
                  name))
    check(same_output(
        got["ops/trie.py:dispatch_node_hash_batch"],
        np.frombuffer(b"".join(hashlib.sha3_256(b).digest() for b in blobs),
                      dtype=np.uint8).reshape(-1, 32)),
        "the trie's hash half equals hashlib")
    seconds = time.perf_counter() - t_phase
    log("lint: {} dispatch halves ran under set_sync_debug_mode(\"error\") "
        "({} of them in phase 9), each == its plain version; phase {:.1f} s"
        .format(len(LINT_HALVES), len(synced), seconds))
    return {"lint": line, "halves": list(LINT_HALVES), "s": seconds}


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="also profile the main path (device busy "
                             "time, host functions)")
    parser.add_argument("--pool-turn", action="store_true",
                        help="run the pool's writes alone and print one "
                             "{\"pool_turn\": ...} line (the pool path "
                             "runs this in a child process with "
                             "PLENUM_TPU_NO_NATIVE=1)")
    args = parser.parse_args(argv)
    profile = args.profile
    sys.path.insert(0, REPO)
    import numpy as np
    import torch
    from plenum_tpu_torch import sha256_ceilings, testing
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
    if args.pool_turn:
        return pool_turn_main(torch, profile)

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
            if any(w in line for w in ("entry function", "registers",
                                       "spill", "stack")):
                log("  nvcc {}: {}".format(name, line.strip()))
    if "sha3" in built:
        frames = [line for line in built["sha3"]["log"].splitlines()
                  if "stack frame" in line]
        check(frames and all(line.strip().startswith("0 bytes stack frame")
                             for line in frames),
              "ptxas gives the SHA3 kernels no stack frame")
    for name in cuda_lib.SOURCES:
        cuda_lib.load(name)
    for name in cuda_lib.HOST_SOURCES:   # built once for the node processes
        cuda_lib.load_host(name)
    log("build: {:.1f} s ({} libraries compiled)".format(
        time.perf_counter() - t0, len(built)))
    native_line()
    lint = start_lint()

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

    for n in ED25519_TAILS:
        tail = [t[:n] for t in ed_in]
        ed_err = max(ed_err, int((ed.verify_cuda(*tail).int()
                                  - ed.verify_plain(*tail).int()).abs().max()
                                 .item()))
    check(ed_err == 0, "ed25519 kernel verdicts equal the plain version's on "
                       "the tail batches")
    log("ed25519: kernel == plain on {} signatures and on their first {}, == "
        "RFC 8032 on {}; accepted/rejected by kind {}".format(
            MICRO_BATCH, ED25519_TAILS, SCALAR_SUBSET, by_kind))
    ed_set = (msgs, sigs, vks, verdicts)         # phase 13's adversarial set

    rng = np.random.RandomState(SEED)
    sha_err = rag_err = 0
    for n in SHA_RAGGED_BATCHES:
        lens = [SHA_BOUNDARY_LENGTHS[i % len(SHA_BOUNDARY_LENGTHS)] if i % 2
                else int(rng.randint(301)) for i in range(n)]
        ragged = [rng.randint(0, 256, size=ln, dtype=np.uint8).tobytes()
                  for ln in lens]
        for prefix in (-1, 0x00, 0x01):
            data, offsets = (to_tensor(a, dev)
                             for a in sha.ragged_arrays(ragged))
            dk = sha.sha256_ragged_cuda(data, offsets, prefix)
            rag_err = max(rag_err, u32_max_abs_err(
                torch, dk.digests, sha.sha256_ragged_plain(data, offsets,
                                                           prefix)))
            pre = b"" if prefix < 0 else bytes([prefix])
            check(sha.digests_to_bytes(sha.to_host(dk))
                  == [hashlib.sha256(pre + m).digest() for m in ragged],
                  "SHA-256 ragged entry equals hashlib on B={} prefix {}"
                  .format(n, prefix))
        words, nvalid, _ = sha.pad_messages(ragged)
        w, nv = to_tensor(words, dev), to_tensor(nvalid, dev)
        dk = sha.sha256_blocks_cuda(w, nv)
        dp = sha.sha256_blocks_plain(w, nv)
        sha_err = max(sha_err, u32_max_abs_err(torch, dk, dp))
        check(sha.digests_to_bytes(dk.cpu().numpy().view(np.uint32))
              == [hashlib.sha256(m).digest() for m in ragged],
              "SHA-256 kernel equals hashlib on ragged B={}".format(n))
    check(rag_err == 0, "SHA-256 ragged entry equals the plain version")
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
    log("sha256: ragged entry == plain == hashlib on ragged B={} (lengths "
        "{} among them, no prefix and both RFC 6962 prefixes); pre-padded "
        "entry == plain == hashlib there and on {} node pairs".format(
            SHA_RAGGED_BATCHES, SHA_BOUNDARY_LENGTHS, NODE_PAIRS))
    node_err = node_levels_phase(torch, dev)
    append_err = append_levels_phase(torch, dev)
    sha256_sync_phase(torch, dev)
    sha3_errs = sha3_phase(torch, dev)
    t1 = time.perf_counter()
    ceilings = sha256_ceilings.measure(dev)
    log(json.dumps({"sha256_ceilings": ceilings}))
    log("sha256 ceilings measured in {:.1f} s".format(
        time.perf_counter() - t1))
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
    sha.sha256_ragged_cuda.launches = 0
    sha.sha256_node_levels_cuda.launches = 0
    ed.verify_cuda.launches = 0
    ledger, recovered_root, hub, nodes, auth, replies, phases = \
        run_main_path()
    launches = {"sha256_compress": sha.sha256_blocks_cuda.launches,
                "sha256_ragged": sha.sha256_ragged_cuda.launches,
                "sha256_node_levels": sha.sha256_node_levels_cuda.launches,
                "ed25519_verify": ed.verify_cuda.launches}
    log("main path launches:", launches, "| host seconds:",
        json.dumps({k: round(v, 3) for k, v in phases.items()}))

    t0 = time.perf_counter()
    check(recovered_root == TreeHasher().hash_full_tree(blobs),
          "recovered 2^20-txn root equals the hashlib root")
    check(all(a == auth[0] for a in auth[1:]), "the four nodes agree")
    rejected = {i for i, v in enumerate(auth[0]) if v is None}
    check(rejected == bad, "exactly the tampered requests are rejected")
    check(hub.launches == [(CLIENT_BATCH, CLIENT_BATCH)],
          "the four nodes' dispatches made one deduplicated launch of "
          "exactly the unique signatures")
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
    check(all(n > 0 for k, n in launches.items() if k != "sha256_compress"),
          "every kernel of the path launched on the main path")
    split = sha.node_level_split(LEDGER_TXNS, LEDGER_LEVELS,
                                 sha._node_wave(cuda_lib.load("sha256"), dev))
    check(launches["sha256_node_levels"] == len(split)
          <= -(-LEDGER_LEVELS // sha.NODE_LEVELS)
          and launches["sha256_compress"] == 0,
          "the 2^20 level build made its {} launches (levels {}), at most "
          "ceil({} / {}), and the old level step none".format(
              len(split), split, LEDGER_LEVELS, sha.NODE_LEVELS))
    log("main path checks: 2^20 root == hashlib, {} audit paths verified, "
        "{} tampered requests rejected ({:.1f} s)".format(
            len(replies), len(bad), time.perf_counter() - t0))

    # ---------- 4. kernels vs plain and times at the main path's shapes
    # The inputs of the main path's launches, rebuilt from its own data:
    # the deduplicated verify batch (launched at exactly its size), the
    # 2^20 recovered leaves (raw bytes, RFC 6962 prefix 0x00), the first
    # tree level (pairs of the leaf digests) and the two staged 3PC batches
    # (the committed blobs).
    t0 = time.perf_counter()
    items = []
    for r in reqs:
        items.extend(nodes[0]._verify_items(Request(**r))[0])
    arrays, _ = ed.host_pack(*[list(c) for c in zip(*items)])
    ed_main = [to_tensor(a, dev) for a in arrays]
    ed_ms, ok_kernel = cuda_ms(torch, lambda: ed.verify_cuda(*ed_main), 20)
    ed_plain_ms, ok_plain = once_ms(torch, lambda: ed.verify_plain(*ed_main))
    ed_err = max(ed_err, int((ok_kernel.int() - ok_plain.int()).abs().max()
                             .item()))
    check(ed_err == 0, "ed25519 kernel verdicts equal the plain version's "
                       "at the main path's {} signatures".format(len(items)))
    ed_bound_ms, ed_bound_by = bound(len(items) * ED25519_MULS_PER_VERIFY,
                                     len(items) * ED25519_BYTES_PER_SIG)
    ed_alone = kernel_ms(torch, lambda: ed.verify_cuda(*ed_main))
    ed_micro_ms, _ = cuda_ms(torch, lambda: ed.verify_cuda(*ed_in), 10)
    ed_micro_bound_ms, _ = bound(MICRO_BATCH * ED25519_MULS_PER_VERIFY,
                                 MICRO_BATCH * ED25519_BYTES_PER_SIG)

    leaf_data, leaf_off = sha.ragged_arrays(blobs)
    leaf_in = [to_tensor(leaf_data, dev), to_tensor(leaf_off, dev)]
    rag_ms, dk = cuda_ms(
        torch, lambda: sha.sha256_ragged_cuda(*leaf_in, 0x00), 10)
    rag_alone = kernel_ms(
        torch, lambda: sha.sha256_ragged_cuda(*leaf_in, 0x00), 20)
    rag_plain_ms, dp = once_ms(
        torch, lambda: sha.sha256_ragged_plain(*leaf_in, 0x00))
    rag_err = max(rag_err, u32_max_abs_err(torch, dk.digests, dp))
    leaf_digests = sha.digests_to_array(sha.to_host(dk))
    check(leaf_digests.tobytes() == b"".join(
        hashlib.sha256(b"\x00" + b).digest() for b in blobs),
        "SHA-256 ragged entry equals hashlib on the 2^20 leaves")
    lens = np.diff(leaf_off)
    leaf_blocks = int(((lens + 1 + 9 + 63) // 64).sum())
    # raw bytes, offsets and digests each moved once
    rag_bound_ms, rag_bound_by = bound(
        leaf_blocks * SHA256_OPS_PER_BLOCK,
        leaf_data.nbytes + leaf_off.nbytes + 32 * LEDGER_TXNS)

    level_pairs = to_tensor(leaf_digests.reshape(-1, 64), dev)
    level = [sha._node_words_from_digest_pairs(level_pairs),
             torch.full((LEDGER_TXNS // 2,), 2, dtype=torch.int32,
                        device=dev)]
    sha_ms, dk = cuda_ms(torch, lambda: sha.sha256_blocks_cuda(*level), 10)
    sha_plain_ms, dp = once_ms(
        torch, lambda: sha.sha256_blocks_plain(*level))
    sha_err = max(sha_err, u32_max_abs_err(torch, dk, dp))
    pair_bytes = leaf_digests.tobytes()
    check(sha.digests_to_array(dk.cpu().numpy().view(np.uint32)).tobytes()
          == b"".join(hashlib.sha256(b"\x01" + pair_bytes[i:i + 64]).digest()
                      for i in range(0, len(pair_bytes), 64)),
          "SHA-256 kernel equals hashlib on the first tree level")
    sha_alone = kernel_ms(torch, lambda: sha.sha256_blocks_cuda(*level))
    # each hashed block read once, nvalid read and the digest written once
    sha_bound_ms, sha_bound_by = bound(
        LEDGER_TXNS * SHA256_OPS_PER_BLOCK,
        LEDGER_TXNS * 64 + (4 + 32) * (LEDGER_TXNS // 2))
    adds = sha256_ceilings.COMPRESS_ADDS
    sha_ceiling_ms = ceilings["compress"]["ceiling_ms_by_adds"][adds]
    log("sha256_compress at the first tree level ({} messages x 2 blocks, "
        "adds routed as {}): kernel alone {:.5f} ms, bound {:.5f} ms ({}), "
        "{:.2%} of it; the measured ceiling of its own instructions at its "
        "mix's rate {:.5f} ms, the kernel {:.2%} of it; wrapper (cuda_ms) "
        "{:.5f} ms; == plain == hashlib".format(
            LEDGER_TXNS // 2, adds, sha_alone, sha_bound_ms, sha_bound_by,
            sha_bound_ms / sha_alone, sha_ceiling_ms,
            sha_ceiling_ms / sha_alone, sha_ms))
    levels = level_build_phase(torch, dev, leaf_digests,
                               ledger.tree.hash_store)
    staged = []
    for lo in range(0, len(replies), Config.Max3PCBatchSize):
        hi = min(lo + Config.Max3PCBatchSize, len(replies))
        staged.append([ledger._store.get(_seq_key(LEDGER_TXNS + i))
                       for i in range(lo + 1, hi + 1)])
    for msgs in staged:
        data, offsets = (to_tensor(a, dev) for a in sha.ragged_arrays(msgs))
        dk = sha.sha256_ragged_cuda(data, offsets, 0x00)
        rag_err = max(rag_err, u32_max_abs_err(
            torch, dk.digests, sha.sha256_ragged_plain(data, offsets, 0x00)))
        check(sha.digests_to_bytes(sha.to_host(dk))
              == [hashlib.sha256(b"\x00" + m).digest() for m in msgs],
              "SHA-256 ragged entry equals hashlib on a staged batch")
    check(rag_err == 0, "SHA-256 ragged entry equals the plain version at "
                        "the main path's shapes")
    check(sha_err == 0, "SHA-256 kernel equals the plain version at the "
                        "main path's shapes")
    log("kernel == plain at the main path's shapes: ed25519_verify on {} "
        "signatures; sha256_ragged on the {} leaves ({} blocks hashed, == "
        "hashlib) and the staged batches of {} leaves; sha256_compress on "
        "the first tree level of {} pairs ({:.1f} s)".format(
            len(items), LEDGER_TXNS, leaf_blocks, [len(m) for m in staged],
            LEDGER_TXNS // 2, time.perf_counter() - t0))
    log("plain version, not a yardstick: ed25519 {:.3f} ms, sha256_ragged "
        "{:.3f} ms, sha256_compress {:.3f} ms — card {}".format(
            ed_plain_ms, rag_plain_ms, sha_plain_ms, card))
    log("ed25519_verify: {} signatures {:.4f} ms, kernel alone {:.4f} ms "
        "(bound {:.5f} ms), {} signatures {:.4f} ms (bound {:.5f} ms); "
        "sha256_ragged at the 2^20 leaves {:.4f} ms, kernel alone {:.4f} "
        "ms (bound {:.5f} ms)".format(
            len(items), ed_ms, ed_alone, ed_bound_ms, MICRO_BATCH,
            ed_micro_ms, ed_micro_bound_ms, rag_ms, rag_alone,
            rag_bound_ms))

    if profile:
        where_the_time_goes(torch, run_main_path, "ledger path")

    pool_result = pool_path(torch, dev, signer, profile, sha3_errs)
    pool_turns(torch, dev, signer, pool_result["turn"], profile)

    t0 = time.perf_counter()
    catchup = catchup_phase(torch, dev, blobs, profile, ceilings)
    log("phase 8: {:.1f} s".format(time.perf_counter() - t0))

    pool_launches = pool_result["launches"]
    ed_err = max(ed_err, pool_result["ed_err"])
    rag_err = max(rag_err, pool_result["rag_err"])
    launches = {k: launches.get(k, 0) + pool_launches.get(k, 0)
                + catchup["launches"].get(k, 0)
                for k in set(launches) | set(pool_launches)
                | set(catchup["launches"])}
    kernels = [
        {"name": "ed25519_verify", "route": "cuda",
         "source": "plenum_tpu_torch/csrc/ed25519_verify.cu",
         "replaces": "plenum_tpu/ops/ed25519_pallas.py:339",
         "launches": launches["ed25519_verify"], "max_abs_err": ed_err,
         "ms": ed_ms, "plain_ms": ed_plain_ms, "bound_ms": ed_bound_ms,
         "bound_by": ed_bound_by, "library_ms": None, "kernel_ms": ed_alone},
        {"name": "sha256_compress", "route": "cuda",
         "source": "plenum_tpu_torch/csrc/sha256.cu",
         "replaces": "plenum_tpu/ops/sha256_pallas.py:74",
         "launches": launches["sha256_compress"], "max_abs_err": sha_err,
         "ms": sha_ms, "plain_ms": sha_plain_ms, "bound_ms": sha_bound_ms,
         "bound_by": sha_bound_by, "library_ms": None,
         "kernel_ms": sha_alone, "ceiling_ms": sha_ceiling_ms},
        {"name": "sha256_ragged", "route": "cuda",
         "source": "plenum_tpu_torch/csrc/sha256.cu",
         "replaces": "plenum_tpu/ops/sha256_pallas.py:74",
         "launches": launches["sha256_ragged"], "max_abs_err": rag_err,
         "ms": rag_ms, "plain_ms": rag_plain_ms, "bound_ms": rag_bound_ms,
         "bound_by": rag_bound_by, "library_ms": None,
         "kernel_ms": rag_alone},
        {"name": "sha256_node_levels", "route": "cuda",
         "source": "plenum_tpu_torch/csrc/sha256.cu",
         "replaces": "plenum_tpu/ops/sha256_pallas.py:74",
         "launches": launches["sha256_node_levels"],
         "max_abs_err": max(node_err, levels["err"]), "ms": levels["ms"],
         "plain_ms": levels["plain_ms"], "bound_ms": levels["bound_ms"],
         "bound_by": levels["bound_by"], "library_ms": None,
         "kernel_ms": levels["kernel_ms"],
         "kernel_ms_per_launch": levels["kernel_ms_per_launch"],
         "build_wall_ms": levels["build_wall_ms"]},
        dict({"name": "sha256_append_levels", "route": "cuda",
              "source": "plenum_tpu_torch/csrc/sha256.cu",
              "replaces": "plenum_tpu/ops/sha256_pallas.py:74",
              "launches": launches["sha256_append_levels"],
              "max_abs_err": max(append_err, catchup["err"]),
              "library_ms": None}, **catchup["entry"]),
    ] + pool_result["kernels"]

    bls_result = bls_phase(torch, dev, ceilings)
    kernels += bls_result["kernels"]
    lint_phase(torch, dev, lint, bls_result["synced"])

    pipeline = pipeline_phase(torch, dev, signer)
    gateway = gateway_phase(torch, dev)
    adversary = adversary_phase(torch, dev)
    for entry in kernels:
        name = entry["name"]
        by_path = {"pipelined_pool": pipeline["launches"].get(name, 0),
                   "gateway": gateway["launches"].get(name, 0),
                   "recovery": adversary["launches"]["recovery"].get(
                       name, 0),
                   "bls_attack": adversary["launches"]["bls_attack"].get(
                       name, 0)}
        entry["launches"] += sum(by_path.values())
        entry.setdefault("launches_by_path", {}).update(by_path)
        if name == "ed25519_verify":
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       gateway["ed_err"],
                                       adversary["ed_err"])
        if name == "bls_pairing":
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       adversary["pairing_err"])

    t0 = time.perf_counter()
    deploy = deployment_phase(torch, dev, profile)
    for entry in kernels:
        entry["launches"] += deploy["launches"].get(entry["name"], 0)
    log("deployment launches (node processes and daemon): {} ({:.1f} s)"
        .format(deploy["launches"], time.perf_counter() - t0))
    meshed = mesh_phase(torch, dev, ed_set, blobs, leaf_digests,
                        recovered_root, bls_result["mesh_inputs"])
    for entry in kernels:
        n = meshed["launches"].get(entry["name"], 0)
        entry["launches"] += n
        entry["launches_by_path"]["mesh"] = n
    log("total: {:.1f} s".format(time.perf_counter() - t_all))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
