"""Guards of the PyTorch/CUDA port: plenum_tpu_torch and chip_smoke.py
import neither jax nor plenum_tpu and load no native extension of the JAX
package, every entry point that touches the device raises when CUDA is
absent and the caller did not ask for the CPU, the device mesh reads its
stats without CUDA and never shards a CPU node's launches onto a card,
the Node builds the branch that was not ported before (the pipeline
runtime) and routes BLS pairing batches to its device, no port source
names the JAX package's native directory, chip_smoke.py refuses to
report without a card or without the package beside it, and the port's
lint (plenum_tpu_torch.analysis) keeps its baseline and its program
scope inside plenum_tpu_torch/."""
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


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_loads_no_native_extension_of_the_jax_package(path):
    """The JAX package loads its optional C extensions through
    native.try_load_ext; the port builds its own copies of those C
    sources (csrc/), and its one loader (ops/cuda_lib.py) loads them and
    its CUDA libraries."""
    with open(path) as f:
        src = f.read()
    assert "try_load_ext" not in src and "build_and_load" not in src
    if "ctypes.CDLL(" in src:
        assert os.path.relpath(path, REPO) == os.path.join(
            "plenum_tpu_torch", "ops", "cuda_lib.py")


def test_import_scan_matches_exact_top_level_names(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import plenum_tpu_torch.ops\nfrom jaxtyping import x\n"
                   "import plenum_tpu.ops as o\n"
                   "importlib.import_module('jax.numpy')\n")
    assert _imported_top_names(str(src)) == {"plenum_tpu_torch", "jaxtyping",
                                             "plenum_tpu", "jax"}


def _node(**kw):
    from plenum_tpu_torch.server.node import Node
    from plenum_tpu_torch.runtime.sim_random import DefaultSimRandom
    from plenum_tpu_torch.testing.mock_timer import MockTimer
    from plenum_tpu_torch.testing.sim_network import SimNetwork
    timer = MockTimer()
    net = SimNetwork(timer, DefaultSimRandom(0))
    return Node("Alpha", ["Alpha", "Beta", "Gamma", "Delta"], timer,
                net.create_peer("Alpha"), **kw)


def _entry_points():
    from plenum_tpu_torch import carry
    from plenum_tpu_torch.crypto.batch_verifier import (
        CoalescingVerifierHub, TorchBatchVerifier, create_verifier)
    from plenum_tpu_torch.ops import ed25519, resolve_device, sha256, sha3
    from plenum_tpu_torch.ops import bls381, bls381_pairing, merkle, trie
    from plenum_tpu_torch.server.client_authn import CoreAuthNr
    from plenum_tpu_torch.state.device_state import DeviceStateEngine
    from plenum_tpu_torch.state.pruning_state import PruningState
    from plenum_tpu_torch.storage.kv_memory import KeyValueStorageInMemory
    from plenum_tpu_torch import bootstrap, start_node
    from plenum_tpu_torch.server.verify_daemon import VerifyDaemon
    from plenum_tpu_torch.testing import mp_pool, pool
    from plenum_tpu_torch.gateway import Gateway, GatewayIntake
    empty = np.zeros((0, 32), dtype=np.uint8)
    return {
        "build_networked_node": lambda: bootstrap.build_networked_node(
            "Alpha", "no-such-pool"),
        "start_node": lambda: start_node.main(
            ["--name", "Alpha", "--base-dir", "no-such-pool"]),
        "VerifyDaemon": lambda: VerifyDaemon(backend="torch_hub"),
        "run_multiprocess_pool": lambda: mp_pool.run_multiprocess_pool(
            [], "remote"),
        "sha3_256_many": lambda: sha3.sha3_256_many([b"abc"]),
        "hash_nodes": lambda: trie.hash_nodes([b"abc"]),
        "dispatch_node_verify_batch": lambda: trie.dispatch_node_verify_batch(
            [b"abc"], [bytes(32)]),
        "DeviceStateEngine": lambda: DeviceStateEngine(
            KeyValueStorageInMemory()),
        "attach_device_engine": lambda: PruningState(
            KeyValueStorageInMemory()).attach_device_engine(),
        "state_from_nodes": lambda: carry.state_from_nodes([], bytes(32)),
        "create_verifier": lambda: create_verifier("torch_hub"),
        "Node": lambda: _node(),
        "GatewayIntake": lambda: GatewayIntake(),
        "Gateway": lambda: Gateway(forward_writes=lambda env: None),
        "make_sim_pool": lambda: pool.make_sim_pool(pool.NAMES, "cpu"),
        "resolve_device": lambda: resolve_device(),
        "sha256_many": lambda: sha256.sha256_many([b"abc"]),
        "sha256_node_pairs_array": lambda: sha256.sha256_node_pairs_array(
            np.zeros((1, 64), dtype=np.uint8)),
        "sha256_node_levels_array": lambda: sha256.sha256_node_levels_array(
            np.zeros((2, 32), dtype=np.uint8), 1),
        "TorchSha256Backend": lambda: sha256.TorchSha256Backend(),
        "verify_batch": lambda: ed25519.verify_batch(
            [b"m"], [bytes(64)], [bytes(32)]),
        "TorchBatchVerifier": lambda: TorchBatchVerifier(),
        "CoalescingVerifierHub": lambda: CoalescingVerifierHub(),
        "CoreAuthNr": lambda: CoreAuthNr(),
        "ledger_from_arrays": lambda: carry.ledger_from_arrays(
            [], empty, empty),
        "DeviceMerkleTree": lambda: merkle.DeviceMerkleTree(),
        "merkle_tree_from_levels": lambda: carry.merkle_tree_from_levels(
            [], 0),
        "authnr_from_registry": lambda: carry.authnr_from_registry({}),
        "pairing_jobs": lambda: bls381_pairing.pairing_jobs(
            [[(bls381.G1_INF, bls381.G2_INF)]]),
        "aggregate_g1_jobs": lambda: bls381.aggregate_g1_jobs(
            [[bls381.G1_INF]]),
        "msm_g1": lambda: bls381_pairing.msm_g1([bls381.G1_INF], [1]),
        "g2_aggregate_dispatch": lambda: bls381_pairing
        .g2_aggregate_dispatch([[bls381.G2_INF]], 1),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_device_entry_points_raise_without_cuda(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()


def test_entry_points_run_on_the_cpu_when_asked(monkeypatch):
    import hashlib
    from plenum_tpu_torch.crypto.batch_verifier import TorchBatchVerifier
    from plenum_tpu_torch.ops import sha256, sha3, trie
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert sha256.sha256_many([b"abc"], device="cpu")[0].hex().startswith(
        "ba7816bf")
    assert TorchBatchVerifier("cpu").device == torch.device("cpu")
    assert sha3.sha3_256_many([b"abc"], device="cpu") == \
        [hashlib.sha3_256(b"abc").digest()]
    assert trie.hash_nodes([b"abc"], device="cpu") == \
        [hashlib.sha3_256(b"abc").digest()]
    assert _node(device="cpu").device == torch.device("cpu")


def test_sha3_cuda_wrappers_refuse_cpu_tensors():
    from plenum_tpu_torch.ops import sha3
    from plenum_tpu_torch.ops.sha256 import upload_ragged
    data, offsets = upload_ragged([b"abc"], torch.device("cpu"))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        sha3.sha3_ragged_cuda(data, offsets)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        sha3.sha3_ragged_eq_cuda(data, offsets,
                                 torch.zeros((1, 32), dtype=torch.uint8))


@pytest.mark.parametrize("branch", ["PIPELINE_ENABLED"])
def test_node_raises_on_branches_not_ported(branch):
    """The pipeline runtime (ROADMAP A7) is ported: a Node with it on
    builds its pipeline, raises nothing, and stops cleanly. No Node
    branch is left unported."""
    from plenum_tpu_torch.common.config import Config
    node = _node(device="cpu", config=Config(**{branch: True}))
    assert node._pipeline is not None and node._prescreen_cache is not None
    node._pipeline.stop()


def test_node_routes_bls_device_pairing_to_its_device(monkeypatch):
    """BLS_DEVICE_PAIRING is on by default, as in the JAX package: a Node
    built on device="cpu" sends a batch of BLS_PAIRING_DEVICE_MIN share
    checks to the pairing kernel's plain version, and a verifier routed to
    the card raises without CUDA rather than running on the CPU."""
    from plenum_tpu_torch.common.config import Config
    from plenum_tpu_torch.crypto import bls
    from plenum_tpu_torch.ops import bls381_pairing as bp
    assert Config.BLS_DEVICE_PAIRING is True
    signer, _ = bls.BlsCryptoSignerPlenum.generate(b"\x02" * 32)
    verifier = _node(device="cpu", bls_signer=signer).bls_bft_replica \
        ._verifier
    launched = []
    real = bp.pairing_plain
    monkeypatch.setattr(bp, "pairing_plain", lambda *a: launched.append(
        int(a[0].shape[0])) or real(*a))
    n = Config.BLS_PAIRING_DEVICE_MIN
    checks = [(signer.sign(b"m"), b"m", signer.pk)] * n
    assert verifier.verify_sigs_batch(checks) == [True] * n
    assert launched == [n]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    on_card = bls.BlsCryptoVerifierPlenum(device_pairing=True,
                                          pairing_device_min=n)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        on_card.verify_sigs_batch(checks)


def test_mesh_module_imports_neither_jax_nor_plenum_tpu():
    """ops/mesh.py (the device-mesh dispatcher) is among the scanned
    sources and clean, and importing it and reading its stats loads
    neither package in a fresh interpreter."""
    path = os.path.join(REPO, "plenum_tpu_torch", "ops", "mesh.py")
    assert path in _port_sources()
    assert not _imported_top_names(path) & FORBIDDEN
    code = ("import sys\n"
            "from plenum_tpu_torch.ops import mesh\n"
            "mesh.get_mesh().stats(); mesh.mesh_stats()\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'jax', 'plenum_tpu'}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_mesh_stats_without_cuda_raise_nothing_and_shard_nothing(
        monkeypatch):
    """Without CUDA the mesh's stats and mesh_stats() probe nothing and
    raise nothing (a validator-info dump must not wake a card), and the
    host's mesh is one CPU, so no batch shards."""
    from plenum_tpu_torch.ops import mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(mesh, "_PROBE", {"platform": None,
                                         "device_count": None})
    fresh = mesh.DeviceMesh(shard_min=1, cpu_shard=True)
    st = fresh.stats()
    assert "n_devices" not in st and "platform" not in st
    assert "enabled" in mesh.mesh_stats()
    assert not fresh.should_shard(10 ** 6)
    assert fresh.stats()["n_devices"] == 1
    assert fresh.stats()["sharded_dispatches"] == 0
    assert not torch.cuda.is_initialized()


def test_cpu_node_never_shards_onto_a_card_mesh(monkeypatch):
    """A Node built with device="cpu" whose config turns the mesh on at
    the lowest gate, with the process's mesh set to a card twice: its
    verifier, ledger tree and state engine launches all pass through on
    the CPU, none shards, and no CUDA context is made."""
    import hashlib
    from plenum_tpu_torch.common.config import Config
    from plenum_tpu_torch.crypto.fixtures import make_signed_batch
    from plenum_tpu_torch.ops import mesh, trie
    from plenum_tpu_torch.ops.merkle import DeviceMerkleTree
    m = mesh.get_mesh()
    prior = (m.enabled, m.max_devices, m.shard_min, m.cpu_shard, m._given)
    try:
        node = _node(device="cpu", config=Config(
            MESH_SHARD_MIN=1, MESH_CPU_SHARD=True,
            VERIFIER_BATCH_THRESHOLD=1))
        mesh.configure(devices=[torch.device("cuda", 0)] * 2)
        assert m.enabled and m.shard_min == 1 and m.n_devices == 2
        before = (m.sharded_dispatches, m.passthrough_dispatches)
        items = list(zip(*make_signed_batch(4, seed=5)))
        assert node.authnr._verifier.verify_batch(items) == [True] * 4
        tree = DeviceMerkleTree(device="cpu")
        tree.build([b"x%d" % i for i in range(16)])
        assert tree._buf.device.type == "cpu"
        assert trie.hash_nodes([b"abc"] * 4, device="cpu") == \
            [hashlib.sha3_256(b"abc").digest()] * 4
        assert m.sharded_dispatches == before[0]
        assert m.passthrough_dispatches == before[1] + 3
        assert not torch.cuda.is_initialized()
    finally:
        mesh.configure(enabled=prior[0], max_devices=prior[1],
                       shard_min=prior[2], cpu_shard=prior[3],
                       devices=prior[4] or [])


def _port_files():
    out = []
    for root, _, files in os.walk(os.path.join(REPO, "plenum_tpu_torch")):
        if os.path.basename(root) in ("_build", "__pycache__"):
            continue
        out.extend(os.path.join(root, f) for f in files
                   if f.endswith((".py", ".c", ".cu", ".cpp", ".h")))
    return sorted(out + [os.path.join(REPO, "chip_smoke.py")])


def test_port_names_no_path_of_the_jax_packages_native_code():
    """The port builds its own copies of C sources (csrc/); nothing in it
    points at the JAX package's plenum_tpu/native/ directory."""
    offenders = []
    for path in _port_files():
        with open(path, encoding="utf-8") as f:
            if "plenum_tpu/native" in f.read():
                offenders.append(os.path.relpath(path, REPO))
    assert offenders == []


def test_port_loads_its_c_builds_from_its_own_build_directory():
    """Every host C library and extension the port loaded (the node's
    modules load fastpath, rlp_c, mpt_c and kvlog at import or first use)
    is a file under plenum_tpu_torch/_build/, none under the JAX
    package's native directory."""
    from plenum_tpu_torch import bootstrap
    from plenum_tpu_torch.ops import cuda_lib
    import plenum_tpu_torch.server.node  # noqa: F401
    assert bootstrap.native_backends()["kvlog"] == "native"
    files = {key: getattr(lib, "__file__", None) or lib._name
             for key, lib in cuda_lib._loaded.items()
             if key.startswith(("ext:", "host:"))}
    assert {"ext:fastpath", "ext:rlp_c", "ext:mpt_c", "host:kvlog"} \
        <= set(files)
    build = os.path.join(REPO, "plenum_tpu_torch", "_build")
    native = os.path.join(REPO, "plenum_tpu", "native")
    for key, path in files.items():
        assert os.path.dirname(os.path.realpath(path)) == \
            os.path.realpath(build), key
        assert not os.path.realpath(path).startswith(native), key


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


def test_port_lint_baseline_names_only_port_paths():
    """The port's analyzer keeps its own baseline, inside the package it
    covers; the root lint_baseline.json belongs to the JAX package."""
    from plenum_tpu_torch.analysis import Baseline, default_baseline
    path = default_baseline(REPO)
    assert os.path.dirname(path) == os.path.join(REPO, "plenum_tpu_torch")
    entries = Baseline.load(path).entries
    assert entries
    for e in entries:
        assert e["path"].startswith("plenum_tpu_torch/"), e


def test_port_lint_program_scope_lies_in_the_port():
    """Run over the whole tree, the port's analyzer resolves symbols only
    within its program scope, and every module of that scope lies under
    plenum_tpu_torch/ (the listing alone: no parse)."""
    from plenum_tpu_torch.analysis import Analyzer
    from plenum_tpu_torch.analysis.engine.symtab import module_name
    analyzer = Analyzer([], REPO)
    scope = analyzer._program_scope(analyzer.collect_files(
        [os.path.join(REPO, "plenum_tpu_torch")]))
    assert scope
    for path in scope:
        rel = analyzer._rel(path)
        assert rel.startswith("plenum_tpu_torch/"), rel
        assert module_name(rel).split(".")[0] == "plenum_tpu_torch", rel


def test_port_lint_engine_never_resolves_into_the_jax_package(tmp_path):
    """A port module calling into plenum_tpu stays unresolved even with
    the JAX package's module beside it on disk."""
    from plenum_tpu_torch.analysis import Analyzer
    from plenum_tpu_torch.analysis.engine import Engine
    (tmp_path / "plenum_tpu").mkdir()
    (tmp_path / "plenum_tpu" / "helpers.py").write_text(
        "def leaf():\n    return 1\n")
    (tmp_path / "plenum_tpu_torch").mkdir()
    (tmp_path / "plenum_tpu_torch" / "m.py").write_text(
        "from plenum_tpu.helpers import leaf\n\n\n"
        "def caller():\n    return leaf()\n")
    analyzer = Analyzer([], str(tmp_path))
    scope = analyzer._program_scope(analyzer.collect_files(
        [str(tmp_path / "plenum_tpu_torch")]))
    eng = Engine.build(scope, str(tmp_path), use_cache=False)
    assert set(eng.files) == {"plenum_tpu_torch/m.py"}
    assert eng.graph.callees("plenum_tpu_torch.m:caller") == []
