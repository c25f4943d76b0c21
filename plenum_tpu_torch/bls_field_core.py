"""Measure the BLS12-381 field core of csrc/bls381.cu on one card: the
latency of one Montgomery multiply and of one squaring on one thread, and
their rate across the card, and the latency of one inversion by safegcd
(the aggregates') beside one by Fermat (the pairing's and the MSM's), on a
machine with a CUDA device:

    python3 -m plenum_tpu_torch.bls_field_core

Runs bls_fp_chain (built by ops/cuda_lib.py into plenum_tpu_torch/_build/):
each thread a chain of dependent multiplies x <- x b R^-1 (or squarings
x <- x^2 R^-1) of its own operand. Latency: one thread, chains of N and 2N
steps, the difference of their kernel-alone times (CUDA events) over N, and
the clock64 cycles of the loop the same way; rate: CHAINS threads (a wave
of 256-thread blocks at the kernel's registers) of N and 2N steps, their
multiplies over the difference of the times. Every chain's result is
checked: chain t starts from operand t mod 64, so each equals the chain of
its residue, and those 64 equal Python integers. An inversion's latency
the same way on chains x <- x^-1 + b (each inversion's input the last's
output; safegcd's inverse in the standard domain, Fermat's in the
Montgomery domain, as the kernels use them) of INV_STEPS and twice as
many steps. Prints one JSON line; `measure()` returns the same dictionary,
and chip_smoke.py calls it.
"""
import json
import random
import sys

import numpy as np
import torch

from plenum_tpu_torch.ops import bls381, mesh

Q = bls381.Q
R = 1 << 384
OPERANDS = 64
LATENCY_STEPS = 4096
RATE_STEPS = 256
INV_STEPS = 64
CHAINS = 132 * 4 * 256          # four 256-thread blocks an SM
SEED = 42


def _words(values) -> np.ndarray:
    return np.frombuffer(b"".join(int(v).to_bytes(48, "little")
                                  for v in values), dtype=np.int32).copy()


MODES = {"fp_mul": 0, "fp_sqr": 1, "fp_inv_var": 2, "fp_inv": 3}


def _want(a: int, b: int, steps: int, mode: int) -> int:
    """The chain's result in Python integers."""
    rinv = pow(R, -1, Q)
    if mode == 1:
        return pow(a, 1 << steps, Q) * pow(rinv, (1 << steps) - 1, Q) % Q
    if mode == 0:
        return a * pow(b * rinv % Q, steps, Q) % Q
    for _ in range(steps):   # Fermat's in the Montgomery domain: a^-1 R^2
        a = (pow(a, Q - 2, Q) * (R * R if mode == 3 else 1) + b) % Q
    return a


def _run(lib, dev, mode, steps, chains, a, b):
    """(kernel milliseconds, loop cycles of chain 0, results [chains, 12])
    of one launch after a warm-up launch."""
    out = torch.empty((chains, 12), dtype=torch.int32, device=dev)
    cycles = torch.zeros((1,), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        err = lib.bls_fp_chain(mode, steps, chains, a.data_ptr(),
                               b.data_ptr(), out.data_ptr(),
                               cycles.data_ptr(), stream)
        bls381.launch_error("bls_fp_chain", err)
    launch()
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    launch()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end), int(cycles.item()), out


def _check(out, a_vals, b_val, steps, mode):
    first = out[:OPERANDS].cpu().numpy()
    got = [int.from_bytes(first[i].tobytes(), "little")
           for i in range(min(OPERANDS, out.shape[0]))]
    want = [_want(a, b_val, steps, mode) for a in a_vals[:len(got)]]
    if got != want:
        raise RuntimeError("bls_fp_chain: mode {} chain of {} steps differs "
                           "from Python integers".format(mode, steps))
    n = out.shape[0]
    if n > OPERANDS:
        idx = torch.arange(n, device=out.device) % OPERANDS
        if not torch.equal(out, out[:OPERANDS].index_select(0, idx)):
            raise RuntimeError("bls_fp_chain: chains of one operand differ")


def measure(dev=None) -> dict:
    dev = torch.device("cuda") if dev is None else dev
    lib = bls381.library()
    rng = random.Random(SEED)
    a_vals = [rng.randrange(Q) for _ in range(OPERANDS)]
    b_val = rng.randrange(Q)
    a = torch.from_numpy(_words(a_vals)).to(dev)
    b = torch.from_numpy(_words([b_val])).to(dev)
    result = {}
    for name in ("fp_mul", "fp_sqr"):
        mode = MODES[name]
        lat = {}
        for steps in (LATENCY_STEPS, 2 * LATENCY_STEPS):
            ms, cyc, out = _run(lib, dev, mode, steps, 1, a, b)
            _check(out, a_vals, b_val, steps, mode)
            lat[steps] = (ms, cyc)
        (ms1, c1), (ms2, c2) = lat[LATENCY_STEPS], lat[2 * LATENCY_STEPS]
        rate = {}
        for steps in (RATE_STEPS, 2 * RATE_STEPS):
            ms, _, out = _run(lib, dev, mode, steps, CHAINS, a, b)
            _check(out, a_vals, b_val, steps, mode)
            rate[steps] = ms
        per_s = CHAINS * RATE_STEPS / (1e-3 * (rate[2 * RATE_STEPS]
                                               - rate[RATE_STEPS]))
        ops = 588 if mode == 0 else 456
        result[name] = {
            "latency_ns": 1e6 * (ms2 - ms1) / LATENCY_STEPS,
            "latency_cycles": (c2 - c1) / LATENCY_STEPS,
            "per_s": per_s,
            "bound_per_s": 33.5e12 / ops,
            "share_of_bound": per_s / (33.5e12 / ops),
            "chains": CHAINS,
        }
    for name in ("fp_inv_var", "fp_inv"):
        mode = MODES[name]
        lat = {}
        for steps in (INV_STEPS, 2 * INV_STEPS):
            ms, cyc, out = _run(lib, dev, mode, steps, 1, a, b)
            _check(out, a_vals, b_val, steps, mode)
            lat[steps] = (ms, cyc)
        (ms1, c1), (ms2, c2) = lat[INV_STEPS], lat[2 * INV_STEPS]
        result[name] = {"latency_ns": 1e6 * (ms2 - ms1) / INV_STEPS,
                        "latency_cycles": (c2 - c1) / INV_STEPS}
    return result


if __name__ == "__main__":
    if not mesh.is_accelerator():
        print("bls_field_core: no CUDA device is available", file=sys.stderr)
        sys.exit(1)
    print(json.dumps({"bls_field_core": measure()}))
