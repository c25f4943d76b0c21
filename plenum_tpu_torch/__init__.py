"""plenum_tpu_torch — the PyTorch/CUDA port of plenum_tpu.

The port mirrors the JAX package's layout (common/, crypto/, storage/,
ledger/, state/, consensus/, runtime/, observability/, server/, testing/,
ops/) and names, and imports nothing of it: every host module it needs
is its own copy, keeping only the pure-Python branch where the JAX
package loads a native extension. The device work sits in `ops/`, where
each Pallas kernel of the JAX package is a hand-written CUDA kernel for
Hopper (sources in `csrc/`), built with nvcc at first use and bound with
ctypes. Entry points that touch the device take `device=None`, meaning
CUDA; the tests pass `device="cpu"`, which runs each kernel's plain
PyTorch version instead.
"""

__version__ = "0.1.0"
