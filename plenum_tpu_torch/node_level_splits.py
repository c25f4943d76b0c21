"""Time the Merkle level kernel (csrc/sha256.cu, sha256_node_levels) on one
card under several splits of the 20 levels above 2^20 random digests into
launches, beside the step it replaced, on a machine with a CUDA device:

    python3 -m plenum_tpu_torch.node_level_splits

Each split's launches are enqueued back to back through the kernel's C
entry and their output is held against the wrapper's (which uses
ops/sha256.py's node_level_split) before it is timed. Times are the
kernel alone: CUDA events around 20 repetitions queued behind a sleep
kernel, so the host's enqueueing is not timed. The old step is
sha256_compress on each level's pre-built words, levels of 256 pairs or
more (the 12 the tree sent to the card). Prints one line per split and
per old level, then one JSON line.
"""
import json
import subprocess
import sys

import numpy as np
import torch

from plenum_tpu_torch.ops import to_tensor
from plenum_tpu_torch.ops import sha256 as sha

N = 1 << 20
LEVELS = 20
SPLITS = ([2, 9, 9], [9, 9, 2], [1, 1, 9, 9], [3, 9, 8], [2] * 10, [1] * 20,
          [4] * 5, [9], [2], [1])


def kernel_ms(fn, reps: int = 20) -> float:
    """Device milliseconds per call of fn over `reps` calls queued behind
    a sleep kernel, after one warm-up call."""
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


def main() -> int:
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    fn = sha._lib().sha256_node_levels
    digests = to_tensor(np.random.RandomState(0).randint(
        0, 256, size=(N, 32), dtype=np.uint8), dev)
    rows = [N >> k for k in range(1, LEVELS + 1)]
    ref = sha.sha256_node_levels_cuda(digests, LEVELS)
    out = torch.empty_like(ref)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def chain(split):
        src, n_in, at, done = digests.data_ptr(), N, 0, 0
        for lv in split:
            if fn(src, n_in, out.data_ptr() + 32 * at, lv, stream):
                raise RuntimeError("sha256_node_levels launch failed")
            last = at + sum(rows[done:done + lv - 1])
            src, n_in = out.data_ptr() + 32 * last, rows[done + lv - 1]
            at = last + n_in
            done += lv

    wave = sha._node_wave(sha._lib(), dev)
    chosen = sha.node_level_split(N, LEVELS, wave)
    print("card: {}; {} CTAs a wave; the wrapper's split {}".format(
        card, wave, chosen))
    result = {"card": card, "wave_ctas": wave, "split": chosen,
              "splits_ms": {}, "old_levels_ms": []}
    for split in SPLITS:
        if sum(split) == LEVELS:
            out.zero_()
            chain(split)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise RuntimeError("split {} differs from the wrapper's "
                                   "output".format(split))
        ms = kernel_ms(lambda: chain(split))
        result["splits_ms"][",".join(map(str, split))] = ms
        print("levels per launch {}: {:.5f} ms".format(split, ms))

    words, at = [], 0
    below = digests
    for m in rows[:12]:
        words.append((sha._node_words_from_digest_pairs(
            below[:2 * m].reshape(m, 64)),
            torch.full((m,), 2, dtype=torch.int32, device=dev)))
        below = ref[at:at + m]
        at += m
    for k, (w, nv) in enumerate(words, start=1):
        ms = kernel_ms(lambda: sha.sha256_blocks_cuda(w, nv))
        result["old_levels_ms"].append(ms)
        print("old step, level {} ({} pairs): sha256_compress {:.5f} "
              "ms".format(k, w.shape[0], ms))
    old_all = kernel_ms(lambda: [sha.sha256_blocks_cuda(w, nv)
                                 for w, nv in words])
    result["old_12_levels_ms"] = old_all
    print("old step, 12 levels back to back: {:.5f} ms".format(old_all))
    print(json.dumps({"node_level_splits": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
