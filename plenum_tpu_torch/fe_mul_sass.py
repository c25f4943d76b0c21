"""Count the SASS instructions of one ed25519 field multiply in the two
forms considered for csrc/ed25519_verify.cu, on a machine with the CUDA
toolkit:

    python3 -m plenum_tpu_torch.fe_mul_sass

Builds csrc/fe_mul_forms.cu for sm_90a with the kernels' nvcc flags into
plenum_tpu_torch/_build/, disassembles it with cuobjdump -sass, and prints
per kernel its instruction count (NOPs left out) and its integer
multiplies, then one JSON line with the multiply's
count in each form: the multiply kernel minus the kernel that does the
same loads and stores around an addition.
"""
import json
import os
import re
import subprocess
import sys

from plenum_tpu_torch.ops import cuda_lib

KERNELS = ("fe_mul_r25", "fe_add_r25", "fe_mul_r51", "fe_add_r51")
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def sass_counts(sass: str) -> dict:
    """{kernel: {"instructions": n, "multiplies": m}} from cuobjdump -sass
    output."""
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            name = m.group(1)
            counts[name] = {"instructions": 0, "multiplies": 0}
            continue
        m = _INSN.search(line)
        if name is None or not m:
            continue
        op = m.group(2)
        if op == "NOP":
            continue
        counts[name]["instructions"] += 1
        if op.startswith(("IMAD", "IMUL")):
            counts[name]["multiplies"] += 1
    return counts


def source_counts(name: str) -> dict:
    """Build csrc/<name>.cu for sm_90a with the kernels' nvcc flags into
    plenum_tpu_torch/_build/ as a cubin, disassemble it with cuobjdump
    -sass → sass_counts of it."""
    nvcc = cuda_lib._nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    os.makedirs(cuda_lib.BUILD_DIR, exist_ok=True)
    cubin = os.path.join(cuda_lib.BUILD_DIR, name + ".cubin")
    flags = [f for f in cuda_lib.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    subprocess.run([nvcc] + flags + ["-cubin", "-o", cubin,
                                     os.path.join(cuda_lib.CSRC,
                                                  name + ".cu")],
                   check=True)
    sass = subprocess.run([cuobjdump, "-sass", cubin], check=True,
                          capture_output=True, text=True).stdout
    return sass_counts(sass)


def main() -> int:
    counts = source_counts("fe_mul_forms")
    for name in KERNELS:
        print(name, counts[name])
    print(json.dumps({"fe_mul_sass": {
        "radix_2^25.5_10x32": counts["fe_mul_r25"]["instructions"]
        - counts["fe_add_r25"]["instructions"],
        "radix_2^51_5x64": counts["fe_mul_r51"]["instructions"]
        - counts["fe_add_r51"]["instructions"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
