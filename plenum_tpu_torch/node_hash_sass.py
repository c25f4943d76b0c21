"""Count the SASS instructions of one Merkle node hash H(0x01 || l || r)
in the three forms of csrc/node_hash_forms.cu, on a machine with the CUDA
toolkit:

    python3 -m plenum_tpu_torch.node_hash_sass

Builds the file for sm_90a with the kernels' nvcc flags into
plenum_tpu_torch/_build/, disassembles it with cuobjdump -sass, and prints
per kernel its instruction count (NOPs left out), then one JSON line with
the three counts: the level step before sha256_node_levels (two pre-padded
blocks loaded as words), the new step with block 2's zero words kept from
folding, and the new step as sha256_node_levels_kernel runs it.
"""
import json
import sys

from plenum_tpu_torch.fe_mul_sass import source_counts

KERNELS = ("node_hash_padded", "node_hash_unfolded", "node_hash_folded")


def main() -> int:
    counts = source_counts("node_hash_forms")
    for name in KERNELS:
        print(name, counts[name])
    print(json.dumps({"node_hash_sass": {
        name: counts[name]["instructions"] for name in KERNELS}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
