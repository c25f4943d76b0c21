"""Build and load the port's CUDA kernels.

Each source under `plenum_tpu_torch/csrc/` is compiled by its own `nvcc`
into a shared library with a plain C interface for Hopper (`sm_90a`), at
first use, into `plenum_tpu_torch/_build/` (listed in .gitignore). The
file name carries a hash of the source and of the csrc/ files it
includes, so an edited kernel is rebuilt and a stale library is never
loaded. `build()` starts every missing compile at
once and waits for all of them. The libraries are loaded with ctypes;
wrappers pass every pointer and the stream as `c_void_p`, with each
function's argtypes set once, when its module first loads the library.

`load_host()` does the same for the port's host C sources (the BLS12-381
arithmetic, the wire's ChaCha20 keystream, one ed25519 verification, the
kvlog store), compiled by the host C compiler; `try_load_host()` gives
None instead of raising, for callers that keep a Python version of the
same function. `load_host_ext()` builds the host sources that are CPython
extensions (`fastpath`, `rlp_c`, `mpt_c`: they build Python objects
directly) against the interpreter's headers and imports them under
`plenum_tpu_torch._build.<name>`, never a bare name; `try_load_host_ext()`
gives None when the build or the import fails, or when
PLENUM_TPU_NO_NATIVE is set, and the caller runs its pure-Python branch.
Every compile writes a file of its own (the pid in its name) and moves it
into place with `os.replace`, so processes that build the same library at
once (node processes, test workers) never load a half-written one.
"""
import ctypes
import hashlib
import logging
import os
import re
import shutil
import subprocess
import sysconfig
import time
from typing import Dict, Iterable, Optional

logger = logging.getLogger(__name__)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

SOURCES = ("sha256", "sha3", "ed25519_verify", "sha256_ceilings", "bls381",
           "bls381_agg", "bls381_msm")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

HOST_SOURCES = ("bls12_381", "chacha20", "ed25519_host", "kvlog")
HOST_EXT_SOURCES = ("fastpath", "rlp_c", "mpt_c")
HOST_CC_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c11"]
# the kill switch of the three extensions, as in the JAX package: set, their
# callers run their pure-Python branches (kvlog, a store chosen when it
# builds, is not covered, there either)
NO_NATIVE_ENV = "PLENUM_TPU_NO_NATIVE"

_loaded: Dict[str, object] = {}   # ctypes libraries and extension modules
_typed = set()          # (library, function) whose signature is set
# seconds each host compile of this process took, by source name
host_build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _source(name: str) -> str:
    return os.path.join(CSRC, name + ".cu")


def _hash_source(h, path: str) -> None:
    """Feed `path` and the csrc/ files it includes ("...") into `h`."""
    with open(path, "rb") as f:
        text = f.read()
    h.update(text)
    for inc in re.findall(rb'^#include "([^"]+)"', text, re.M):
        _hash_source(h, os.path.join(CSRC, inc.decode()))


def lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    _hash_source(h, _source(name))
    return os.path.join(BUILD_DIR, "lib{}-{}.so".format(
        name, h.hexdigest()[:16]))


def build(names: Iterable[str] = SOURCES) -> Dict[str, dict]:
    """Compile every library in `names` that is not built yet, one nvcc
    process per source, all started together. → {name: {"seconds",
    "log"}} for the sources compiled now; raises with nvcc's output if any
    compile fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    todo = {n: lib_path(n) for n in names if not os.path.exists(lib_path(n))}
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name, out in todo.items():
        tmp = "{}.{}.tmp".format(out, os.getpid())
        procs[name] = (tmp, out, subprocess.Popen(
            [nvcc] + NVCC_FLAGS + ["-o", tmp, _source(name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    results, failures = {}, []
    for name, (tmp, out, proc) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            failures.append("nvcc failed for {} (rc {}):\n{}".format(
                name, proc.returncode, log))
            continue
        os.replace(tmp, out)
        results[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failures:
        raise RuntimeError("\n".join(failures))
    return results


def load(name: str, signatures: Dict[str, list] = None) -> ctypes.CDLL:
    """The loaded library for `name`, building it first if needed. Each
    function named in `signatures` gets those argtypes and an int restype
    (every entry returns a CUDA error), once."""
    lib = _loaded.get(name)
    if lib is None:
        path = lib_path(name)
        if not os.path.exists(path):
            build([name])
        lib = _loaded[name] = ctypes.CDLL(path)
    for fn, argtypes in (signatures or {}).items():
        if (name, fn) not in _typed:
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
            _typed.add((name, fn))
    return lib


def _host_hash(name: str, flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    with open(os.path.join(CSRC, name + ".c"), "rb") as f:
        h.update(f.read())
    return h.hexdigest()[:16]


def host_lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, "lib{}-host-{}.so".format(
        name, _host_hash(name, HOST_CC_FLAGS)))


def _ext_flags():
    return HOST_CC_FLAGS + ["-I", sysconfig.get_paths()["include"]]


def host_ext_path(name: str) -> str:
    """Where csrc/<name>.c's extension is built: the hash covers the
    source, the flags and the interpreter's include directory, and the
    suffix carries its ABI tag, so another Python rebuilds it."""
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return os.path.join(BUILD_DIR, "{}-host-{}{}".format(
        name, _host_hash(name, _ext_flags()), suffix))


def _compile_host(name: str, flags, path: str) -> None:
    """Compile csrc/<name>.c into `path` unless it is there."""
    if os.path.exists(path):
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "{}.{}.tmp".format(path, os.getpid())
    t0 = time.perf_counter()
    try:
        subprocess.run([os.environ.get("CC", "cc")] + flags
                       + ["-o", tmp, os.path.join(CSRC, name + ".c")],
                       check=True, capture_output=True)
        os.replace(tmp, path)
        host_build_seconds[name] = time.perf_counter() - t0
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library for `csrc/<name>.c`, compiled first with
    the host C compiler (`$CC`, else `cc`) if it is not built yet.
    Raises subprocess.CalledProcessError (with the compiler's output)
    when the compile fails and OSError when the library does not load."""
    key = "host:" + name
    lib = _loaded.get(key)
    if lib is None:
        path = host_lib_path(name)
        _compile_host(name, HOST_CC_FLAGS, path)
        lib = _loaded[key] = ctypes.CDLL(path)
    return lib


def try_load_host(name: str) -> Optional[ctypes.CDLL]:
    """load_host(name), or None (logged) when the host C compiler cannot
    build the library or it does not load: the caller then runs its
    Python version of the same function."""
    try:
        return load_host(name)
    except (OSError, subprocess.SubprocessError) as e:
        logger.warning("csrc/%s.c did not build or load (%s); its Python "
                       "version runs instead", name, e)
        return None


def python_headers() -> bool:
    """Whether this interpreter's Python.h is there (the extensions
    need it; kvlog and the other ctypes libraries do not)."""
    return os.path.exists(os.path.join(sysconfig.get_paths()["include"],
                                       "Python.h"))


def load_host_ext(name: str):
    """The CPython extension built from `csrc/<name>.c`, compiled first
    against this interpreter's headers if it is not built yet, imported
    once a process as `plenum_tpu_torch._build.<name>` (its init function
    stays PyInit_<name>). Raises as load_host does, and ImportError when
    the module does not load."""
    key = "ext:" + name
    mod = _loaded.get(key)
    if mod is None:
        import importlib.machinery
        import importlib.util
        path = host_ext_path(name)
        _compile_host(name, _ext_flags(), path)
        qualified = "plenum_tpu_torch._build." + name
        loader = importlib.machinery.ExtensionFileLoader(qualified, path)
        spec = importlib.util.spec_from_file_location(qualified, path,
                                                      loader=loader)
        mod = importlib.util.module_from_spec(spec)
        loader.exec_module(mod)
        _loaded[key] = mod
    return mod


def try_load_host_ext(name: str):
    """load_host_ext(name), or None when PLENUM_TPU_NO_NATIVE is set or
    the extension does not build or load (logged): the caller then runs
    its pure-Python branch, which gives the same bytes. This is host
    routing; no kernel depends on it."""
    if os.environ.get(NO_NATIVE_ENV):
        return None
    try:
        return load_host_ext(name)
    except (OSError, ImportError, subprocess.SubprocessError) as e:
        logger.warning("csrc/%s.c did not build or load as an extension "
                       "(%s); its Python branch runs instead", name, e)
        return None
