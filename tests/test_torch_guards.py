"""Guards of the PyTorch/CUDA port: plenum_tpu_torch and chip_smoke.py
import neither jax nor plenum_tpu, every entry point that touches the
device raises when CUDA is absent and the caller did not ask for the CPU,
and chip_smoke.py refuses to report without a card or without the
package beside it."""
import ast
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "plenum_tpu"}


def _port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "plenum_tpu_torch")):
        paths.extend(os.path.join(root, f) for f in files
                     if f.endswith(".py"))
    return sorted(paths)


def _imported_top_names(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", None)) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_imports_neither_jax_nor_plenum_tpu(path):
    assert not _imported_top_names(path) & FORBIDDEN


def test_import_scan_matches_exact_top_level_names(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import plenum_tpu_torch.ops\nfrom jaxtyping import x\n"
                   "import plenum_tpu.ops as o\n"
                   "importlib.import_module('jax.numpy')\n")
    assert _imported_top_names(str(src)) == {"plenum_tpu_torch", "jaxtyping",
                                             "plenum_tpu", "jax"}


def _entry_points():
    from plenum_tpu_torch import carry
    from plenum_tpu_torch.crypto.batch_verifier import (
        CoalescingVerifierHub, TorchBatchVerifier)
    from plenum_tpu_torch.ops import ed25519, resolve_device, sha256
    from plenum_tpu_torch.server.client_authn import CoreAuthNr
    empty = np.zeros((0, 32), dtype=np.uint8)
    return {
        "resolve_device": lambda: resolve_device(),
        "sha256_many": lambda: sha256.sha256_many([b"abc"]),
        "sha256_node_pairs_array": lambda: sha256.sha256_node_pairs_array(
            np.zeros((1, 64), dtype=np.uint8)),
        "TorchSha256Backend": lambda: sha256.TorchSha256Backend(),
        "verify_batch": lambda: ed25519.verify_batch(
            [b"m"], [bytes(64)], [bytes(32)]),
        "TorchBatchVerifier": lambda: TorchBatchVerifier(),
        "CoalescingVerifierHub": lambda: CoalescingVerifierHub(),
        "CoreAuthNr": lambda: CoreAuthNr(),
        "ledger_from_arrays": lambda: carry.ledger_from_arrays(
            [], empty, empty),
        "authnr_from_registry": lambda: carry.authnr_from_registry({}),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_device_entry_points_raise_without_cuda(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()


def test_entry_points_run_on_the_cpu_when_asked(monkeypatch):
    from plenum_tpu_torch.crypto.batch_verifier import TorchBatchVerifier
    from plenum_tpu_torch.ops import sha256
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert sha256.sha256_many([b"abc"], device="cpu")[0].hex().startswith(
        "ba7816bf")
    assert TorchBatchVerifier("cpu").device == torch.device("cpu")


def _run_smoke(cwd, script):
    return subprocess.run([sys.executable, script], cwd=cwd,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_chip_smoke_refuses_without_a_card():
    proc = _run_smoke(REPO, "chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no CUDA device" in proc.stderr


def test_chip_smoke_refuses_without_the_package(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(str(tmp_path), "chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "No module named 'plenum_tpu_torch'" in proc.stderr
