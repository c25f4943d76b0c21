"""plenum_tpu_torch — the PyTorch/CUDA port of plenum_tpu.

The port mirrors the JAX package's layout (common/, crypto/, storage/,
ledger/, server/, ops/) and names, and imports nothing of it: every host
module it needs is its own copy. The device work sits in `ops/`, where
each Pallas kernel of the JAX package is a hand-written CUDA kernel for
Hopper (sources in `csrc/`), built with nvcc at first use and bound with
ctypes. Entry points that touch the device take `device=None`, meaning
CUDA; the tests pass `device="cpu"`, which runs each kernel's plain
PyTorch version instead.
"""

__version__ = "0.1.0"
