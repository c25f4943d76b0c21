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


def sass_listing(sass: str) -> dict:
    """{kernel: [(address, opcode, instruction text)]} from cuobjdump -sass
    output, NOPs left out; the opcode with its modifiers (IMAD.MOV.U32)."""
    listing, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            name = m.group(1)
            listing[name] = []
            continue
        m = _INSN.search(line)
        if name is None or not m or m.group(2) == "NOP":
            continue
        addr = int(re.search(r"/\*([0-9a-f]{4,})\*/", line).group(1), 16)
        listing[name].append((addr, m.group(2), line.strip()))
    return listing


def sass_counts(sass: str) -> dict:
    """{kernel: {"instructions": n, "multiplies": m}} from cuobjdump -sass
    output."""
    return {name: {"instructions": len(insns),
                   "multiplies": sum(op.startswith(("IMAD", "IMUL"))
                                     for _, op, _ in insns)}
            for name, insns in sass_listing(sass).items()}


def _disassemble(binary: str) -> str:
    cuobjdump = os.path.join(os.path.dirname(cuda_lib._nvcc()), "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", binary], check=True,
                          capture_output=True, text=True).stdout


def library_sass(name: str) -> str:
    """cuobjdump -sass of the built library of csrc/<name>.cu (built first
    if needed), as the wrappers load it."""
    cuda_lib.load(name)
    return _disassemble(cuda_lib.lib_path(name))


def source_counts(name: str) -> dict:
    """Build csrc/<name>.cu for sm_90a with the kernels' nvcc flags into
    plenum_tpu_torch/_build/ as a cubin, disassemble it with cuobjdump
    -sass → sass_counts of it."""
    nvcc = cuda_lib._nvcc()
    os.makedirs(cuda_lib.BUILD_DIR, exist_ok=True)
    cubin = os.path.join(cuda_lib.BUILD_DIR, name + ".cubin")
    flags = [f for f in cuda_lib.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    subprocess.run([nvcc] + flags + ["-cubin", "-o", cubin,
                                     os.path.join(cuda_lib.CSRC,
                                                  name + ".cu")],
                   check=True)
    return sass_counts(_disassemble(cubin))


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
