"""Measure on one card what it issues of SHA-256's work, the ceilings the
SHA-256 kernels of csrc/sha256.cu are held against (PERF.md), on a machine
with a CUDA device:

    python3 -m plenum_tpu_torch.sha256_ceilings

Runs the microkernels of csrc/sha256_ceilings.cu (built by ops/cuda_lib.py
into plenum_tpu_torch/_build/) and prints one JSON line:

- "mix": the compression's own instruction mix (ceil_mix_kernel: a chain
  of compressions in registers per thread, one wave of CTAs at the
  compress kernel's launch bounds), once with its adds as the compiler's
  IADD3s and once with every add but h + K as an IMAD
  (sha256_compress_block_t's ADDS): lane-instructions per SM per clock
  and the share of INT32_OPS_PER_S, from the SASS of the loop body
  (cuobjdump) times its iterations over the time of the iterations alone
  (the difference of runs of N and 2N iterations, CUDA events), at the SM
  clock the kernel itself read (clock64 against the global timer);
  the loop body's SASS by opcode and by pipe;
- "ops": the same rate for one opcode alone (SHF, LOP3, IADD3, IMAD) and
  for SHF, LOP3 or IADD3 in turns with IMAD: which pipe each issues on;
- "node_by_adds": the latency of one Merkle node hash (one thread, L = 1
  and 64 dependent nodes, kernel alone as chip_smoke.py's kernel_ms
  times it) in both routings of the adds, and "node" that of the routing
  csrc/sha256.cu gives a node hash (NODE_ADDS): the floor of one level of
  an append; and
  "empty_launch_ms", an empty launch timed the same way, the floor of a
  launch;
- "compress": sha256_compress's kernel alone at 2^19 messages x 2 blocks
  in both routings of its adds, its digests equal to the wrapper's;
  beside them the time the kernel's own per-block loop (SASS) takes at
  the measured rate of the same routing's mix; and the SASS of
  sha256_compress_kernel as libsha256 holds it (the whole kernel and its
  per-block loop, routed as COMPRESS_ADDS), by opcode and pipe, with its
  resident CTAs per SM.

`measure()` returns the same dictionary; chip_smoke.py calls it.
"""
import ctypes
import json
import re
import subprocess
import sys
from collections import Counter

import numpy as np
import torch

from plenum_tpu_torch.fe_mul_sass import library_sass, sass_listing
from plenum_tpu_torch.node_level_splits import kernel_ms
from plenum_tpu_torch.ops import cuda_lib
from plenum_tpu_torch.ops import sha256 as sha

# chip_smoke.py's bound: 32-bit integer instructions over all 128 lanes of
# the 132 SMs of an H100 SXM at 1.98 GHz (33.5 T lane-instructions/s)
INT32_OPS_PER_S = 33.5e12
ADDS = ("iadd3", "imad_all")        # csrc/sha256.cu's ADDS_ALU, ADDS_ALL
# the routings csrc/sha256.cu ships: sha256_compress and sha256_ragged put
# their adds on IMAD, a node hash (the levels, the append) on the ALU
COMPRESS_ADDS = "imad_all"
NODE_ADDS = "iadd3"
OPS = ("SHF", "LOP3", "IADD3", "IMAD", "SHF+IMAD", "LOP3+IMAD",
       "IADD3+IMAD")                                        # OP_* order
THREADS = 256
MIX_ITERS = 64          # compressions a thread, ~1 ms a launch
OP_ITERS = 2048         # 128 instructions an iteration
COMPRESS_B = 1 << 19
PIPES = {"alu": ("LOP3", "SHF", "IADD3", "SHL", "SHR", "PRMT", "ISETP",
                 "SEL", "LEA", "IMNMX", "PLOP3", "BMSK", "FLO", "POPC"),
         "fma": ("IMAD", "IMUL", "FFMA", "FMUL", "FADD"),
         "memory": ("LDG", "STG", "LDS", "STS", "LDGSTS", "LDC", "LD", "ST",
                    "ATOM", "ATOMS", "RED", "LDSM")}

_SIGNATURES = {
    "ceil_mix": [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3,
    "ceil_op": [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3,
    "ceil_occupancy": [ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int)],
    "ceil_compress": [ctypes.c_int] + [ctypes.c_void_p] * 3
    + [ctypes.c_int] * 2 + [ctypes.c_void_p],
    "ceil_node_chain": [ctypes.c_int] + [ctypes.c_void_p] * 2
    + [ctypes.c_int, ctypes.c_void_p],
    "ceil_empty": [ctypes.c_void_p],
}


def _call(name, *args):
    err = getattr(cuda_lib.load("sha256_ceilings", _SIGNATURES), name)(*args)
    if err != 0:
        raise RuntimeError("{} failed: CUDA error {}".format(name, err))


def pipe_of(op: str) -> str:
    base = op.split(".")[0]
    for pipe, ops in PIPES.items():
        if base in ops:
            return pipe
    return "other"


def by_pipe(ops: Counter) -> dict:
    """{"instructions", "alu", "fma", "memory", "other", "ops": {opcode:
    n}} of an opcode count (opcodes with modifiers, IMAD.IADD apart)."""
    out = {"instructions": sum(ops.values()), "alu": 0, "fma": 0,
           "memory": 0, "other": 0}
    for op, n in ops.items():
        out[pipe_of(op)] += n
    out["ops"] = dict(sorted(ops.items(), key=lambda kv: -kv[1]))
    return out


def loop_body(insns) -> list:
    """The instructions of the longest backward branch's loop in a kernel's
    listing (sass_listing): from the branch target to the branch."""
    best = []
    for addr, op, text in insns:
        m = re.search(r"\bBRA\s+(0x[0-9a-f]+)", text)
        if op.startswith("BRA") and m and int(m.group(1), 16) < addr:
            body = [i for i in insns if int(m.group(1), 16) <= i[0] <= addr]
            if len(body) > len(best):
                best = body
    return best


def kernel_listing(listing: dict, pattern: str) -> list:
    """The listing of the one kernel whose (mangled) name matches."""
    names = [n for n in listing if re.search(pattern, n)]
    if len(names) != 1:
        raise RuntimeError("expected one kernel matching {}, got {}".format(
            pattern, names))
    return listing[names[0]]


def _occupancy(which: int, arg: int) -> int:
    ctas = ctypes.c_int(0)
    _call("ceil_occupancy", which, arg, ctypes.byref(ctas))
    return ctas.value


def _rate(launch, body: int, grid: int, iters: int, sms: int) -> dict:
    """Run `launch(iters, clocks)` at iters and 2 x iters in turns (five
    of each, after a warm-up), the fastest of each timed by CUDA events;
    → the body's lane-instructions per SM per clock over the difference,
    at the SM clock CTA 0 read in the longest run."""
    clocks = torch.zeros(4, dtype=torch.int64, device="cuda")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    launch(iters, clocks)
    best = {iters: float("inf"), 2 * iters: float("inf")}
    for _ in range(5):
        for n in (iters, 2 * iters):
            ev[0].record()
            launch(n, clocks)
            ev[1].record()
            torch.cuda.synchronize()
            best[n] = min(best[n], ev[0].elapsed_time(ev[1]))
    c = clocks.cpu().numpy()
    ghz = float(c[2] - c[0]) / float(c[3] - c[1])
    ms = best[2 * iters] - best[iters]
    lane_insns = float(body) * iters * grid * THREADS
    per_s = lane_insns / (ms * 1e-3)
    return {"lane_instr_per_sm_per_clk": per_s / (sms * ghz * 1e9),
            "share_of_int32_ops_per_s": per_s / INT32_OPS_PER_S,
            "clock_ghz": ghz, "ms_per_iteration": ms / iters,
            "grid": grid}


def measure(dev=None) -> dict:
    dev = torch.device("cuda" if dev is None else dev)
    # a measurement of the card itself, which needs its SM count; it runs
    # only on the card, from chip_smoke.py or this module's command line
    props = torch.cuda.get_device_properties(dev)  # plenum-lint: disable=PT002
    sms = props.multi_processor_count
    listing = sass_listing(library_sass("sha256_ceilings"))
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731
    out = {"sms": sms, "mix": {}, "ops": {}}

    for mode, name in enumerate(ADDS):
        body = Counter(op for _, op, _ in loop_body(kernel_listing(
            listing, r"ceil_mix_kernelILi{}E".format(mode))))
        occ = _occupancy(0, mode)
        grid = sms * occ
        buf = torch.empty((grid * THREADS, 4), dtype=torch.int32, device=dev)
        rate = _rate(lambda n, clk: _call(
            "ceil_mix", mode, grid, n, buf.data_ptr(), clk.data_ptr(),
            stream()), sum(body.values()), grid, MIX_ITERS, sms)
        out["mix"][name] = dict(rate, ctas_per_sm=occ, body=by_pipe(body))

    for op, name in enumerate(OPS):
        body = Counter(o for _, o, _ in loop_body(kernel_listing(
            listing, r"ceil_op_kernelILi{}E".format(op))))
        occ = _occupancy(1, op)
        grid = sms * occ
        buf = torch.empty((grid * THREADS,), dtype=torch.int32, device=dev)
        rate = _rate(lambda n, clk: _call(
            "ceil_op", op, grid, n, buf.data_ptr(), clk.data_ptr(),
            stream()), sum(body.values()), grid, OP_ITERS, sms)
        out["ops"][name] = dict(rate, ctas_per_sm=occ,
                                body=by_pipe(body)["ops"])

    digest = torch.arange(32, dtype=torch.uint8, device=dev)
    node_out = torch.empty_like(digest)
    out["node_by_adds"] = {}
    for mode, name in enumerate(ADDS):
        node = {}
        for L in (1, 64):
            node["L{}_ms".format(L)] = kernel_ms(lambda: _call(
                "ceil_node_chain", mode, digest.data_ptr(),
                node_out.data_ptr(), L, stream()))
        node["per_node_ms"] = (node["L64_ms"] - node["L1_ms"]) / 63
        out["node_by_adds"][name] = node
    out["node"] = dict(out["node_by_adds"][NODE_ADDS], adds=NODE_ADDS)
    out["empty_launch_ms"] = kernel_ms(lambda: _call("ceil_empty", stream()))

    rng = np.random.RandomState(0)
    words = torch.from_numpy(rng.randint(
        -2 ** 31, 2 ** 31, size=(COMPRESS_B, 2, 16), dtype=np.int64)
        .astype(np.int32)).to(dev)
    nvalid = torch.full((COMPRESS_B,), 2, dtype=torch.int32, device=dev)
    want = sha.sha256_blocks_cuda(words, nvalid)
    modes_ms = {}
    for mode, name in enumerate(ADDS):
        dst = torch.empty((COMPRESS_B, 8), dtype=torch.int32, device=dev)
        modes_ms[name] = kernel_ms(lambda: _call(
            "ceil_compress", mode, words.data_ptr(), nvalid.data_ptr(),
            dst.data_ptr(), COMPRESS_B, 2, stream()))
        if not torch.equal(dst, want):
            raise RuntimeError("sha256_compress with adds routed as {} "
                               "differs".format(name))
    # what the mix's measured rate allows the kernel's own instructions:
    # its per-block loop once a block of every message
    ceiling_ms = {}
    for mode, name in enumerate(ADDS):
        body = loop_body(kernel_listing(
            listing, r"sha256_compress_kernelILi{}E".format(mode)))
        mix = out["mix"][name]
        rate = mix["lane_instr_per_sm_per_clk"] * sms * mix["clock_ghz"] * 1e9
        ceiling_ms[name] = 1e3 * len(body) * COMPRESS_B * 2 / rate
    kernel = kernel_listing(sass_listing(library_sass("sha256")),
                            r"sha256_compress_kernel")
    out["compress"] = {
        "adds": COMPRESS_ADDS, "kernel_ms_by_adds": modes_ms,
        "ceiling_ms_by_adds": ceiling_ms,
        "ctas_per_sm": {name: _occupancy(2, m) for m, name in enumerate(ADDS)},
        "sass": by_pipe(Counter(op for _, op, _ in kernel)),
        "sass_per_block_loop": by_pipe(Counter(
            op for _, op, _ in loop_body(kernel)))}
    return out


def main() -> int:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    result = measure()
    result["card"] = card
    print(json.dumps({"sha256_ceilings": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
