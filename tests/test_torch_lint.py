"""The port's plenum-lint (plenum_tpu_torch.analysis) held against the JAX
package's (plenum_tpu.analysis) on mirrored fixtures.

* Rules that read no device idiom (PT001, PT003–PT005, PT007–PT013,
  PT015–PT017): every bad and good fixture of tests/test_plenum_lint.py
  runs at the same relative path under each package's prefix (imports
  renamed), and both analyzers give the same (rule, line, col, symbol).
* PT002, PT006 and PT014 read device idioms: a torch translation of each
  JAX fixture fires or stays clean as its JAX twin does, on the same
  symbols; port-only cases pin what the translation adds (.item() on a
  tensor, CUDA graph capture, a ctypes launch being no compile boundary).
* Pragmas, the baseline's round trip and stale entries, --json and
  --sarif on a mirrored tree, the CLI flags and the engine's call graph
  and summaries, each against the JAX analyzer.
"""
import ast
import json
import os
import re
import subprocess
import sys
import textwrap

import pytest

import test_plenum_lint as ref
from plenum_tpu import analysis as jax_lint
from plenum_tpu.analysis import baseline as jax_baseline
from plenum_tpu.analysis import cli as jax_cli
from plenum_tpu.analysis import core as jax_core
from plenum_tpu.analysis import engine as jax_engine
from plenum_tpu.analysis import rules as jax_rules
from plenum_tpu.analysis.rules import pt005_config_drift as jax_pt005
from plenum_tpu_torch import analysis as port_lint
from plenum_tpu_torch.analysis import baseline as port_baseline
from plenum_tpu_torch.analysis import cli as port_cli
from plenum_tpu_torch.analysis import core as port_core
from plenum_tpu_torch.analysis import engine as port_engine
from plenum_tpu_torch.analysis import rules as port_rules
from plenum_tpu_torch.analysis.rules import pt005_config_drift as port_pt005

REPO = port_lint.repo_root()


class Side:
    """One analyzer with its package prefix."""

    def __init__(self, pkg, core, rules, pt005, baseline, cli, engine):
        self.pkg, self.core, self.rules = pkg, core, rules
        self.pt005, self.baseline, self.cli = pt005, baseline, cli
        self.engine = engine

    def path(self, rel):
        return "%s/%s" % (self.pkg, rel)

    def source(self, src):
        return re.sub(r"\bplenum_tpu\b", self.pkg, textwrap.dedent(src))

    def rule(self, code):
        for cls in self.rules.RULE_CLASSES:
            if cls.code == code:
                if code == "PT005":
                    return cls(config_values=self.pt005.load_config_values(
                        os.path.join(REPO, self.pkg, "common", "config.py")))
                return cls()
        raise AssertionError(code)


JAX = Side("plenum_tpu", jax_core, jax_rules, jax_pt005, jax_baseline,
           jax_cli, jax_engine)
PORT = Side("plenum_tpu_torch", port_core, port_rules, port_pt005,
            port_baseline, port_cli, port_engine)


def snippet(side, code, src, rel):
    """One per-module rule over an in-memory module at <pkg>/rel."""
    source, path = side.source(src), side.path(rel)
    ctx = side.core.ModuleContext(path, source, ast.parse(source))
    rule = side.rule(code)
    assert rule.applies(path), (code, path)
    return [f for f in rule.check(ctx) if not ctx.suppressed(f.rule, f.line)]


def program(side, codes, files, root):
    """The rules `codes` through the Analyzer (engine included) over a
    fixture tree written under `root`, each file at <pkg>/rel."""
    for rel, src in files.items():
        p = root / side.path(rel)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(side.source(src))
    analyzer = side.core.Analyzer([side.rule(c) for c in codes], str(root),
                                  use_engine_cache=False)
    return analyzer.run_files(analyzer.collect_files([str(root)]))


def key(findings, side):
    return sorted((f.rule, f.path[len(side.pkg) + 1:], f.line, f.col,
                   f.symbol) for f in findings)


# ------------------------------------------------- mirrored rule fixtures

# fixtures that lived inline in tests/test_plenum_lint.py's test bodies

PT010_NESTED = """
    class Stack:
        def flush_all(self, out):
            for chunk in out:
                for m in chunk:
                    self.serializer.serialize(m)
"""

PRAGMA_LINE = """
    import time

    def process_x(self, frm):
        time.sleep(1)  # plenum-lint: disable=PT001
        time.sleep(2)
"""

PRAGMA_FILE = """\
    # plenum-lint: disable=PT001
    import time

    def process_x(self, frm):
        time.sleep(1)
"""

PT012_SET_BAD = """
    class ViewChangeService:
        def _finish_view_change(self, nv):
            referenced = {tuple(x) for x in nv.viewChanges}
            return [frm for frm, digest in referenced]
"""

PT012_SET_GOOD = """
    class ViewChangeService:
        def _finish_view_change(self, nv):
            referenced = sorted({tuple(x) for x in nv.viewChanges})
            return [frm for frm, digest in referenced]
"""

PT012_RANDOM_TIME = """
    import random
    import time

    def plan_lanes(touches):
        lane = random.choice(touches)
        return lane

    def _stamp():
        return time.time()

    def plan_more(touches):
        return _stamp()

    def _timer_delta_ok(t0):
        elapsed = time.time() - t0
        return len([elapsed])
"""

PT012_PRAGMA = """
    import random

    def plan_lanes(touches):
        return random.choice(touches)  # plenum-lint: disable=PT012
"""

PT013_BLS_BAD = """
    from plenum_tpu.ops.bls381_pairing import (
        msm_dispatch, pairing_dispatch)

    def check_batch(jobs):
        handles = pairing_dispatch(jobs, 2)
        return len(jobs)

    def msm_fire(points, scalars):
        msm_dispatch(points, scalars)
"""

PT013_BLS_GOOD = """
    from plenum_tpu.ops.bls381_pairing import (
        msm_collect, msm_dispatch, pairing_collect,
        pairing_dispatch)

    def check_batch(jobs):
        return pairing_collect(pairing_dispatch(jobs, 2))

    def msm_start(self, points, scalars):
        self._inflight = msm_dispatch(points, scalars)

    def msm_handoff(points, scalars):
        return msm_dispatch(points, scalars)

    def msm_run(points, scalars):
        return msm_collect(msm_handoff(points, scalars))
"""

PT015_HELPER = """
    from plenum_tpu.network.flat_wire import TraceStamp

    class BatchTagger:
        def tag(self, raw):
            return TraceStamp.from_wire(raw)
"""

PT015_HELPER_ROOT = """
    from plenum_tpu.server.batch_tagger import BatchTagger

    class OrderingService:
        def _order(self, batch, raw):
            tag = BatchTagger().tag(raw)
            return (batch, tag)
"""

PT015_DECODE_CALLS_ROOT = """
    from plenum_tpu.consensus.ordering_service import OrderingService

    def decode_trace_stamp(raw):
        OrderingService()._order(raw)
        return None
"""

PT015_PLAIN_ROOT = """
    class OrderingService:
        def _order(self, batch):
            return batch
"""

PT016_DUAL = """
    import threading

    class Stage:
        def start(self):
            self._t = threading.Thread(target=self._work)
            self._t.start()

        def _work(self):
            self.cursor = 1

        def advance(self):
            self.cursor = 2
"""

PT016_LOCKED = """
    import threading

    class Stage:
        def start(self):
            self._t = threading.Thread(target=self._work)
            self._t.start()

        def _work(self):
            with self._lock:
                self.cursor = 1

        def advance(self):
            with self._lock:
                self.cursor = 2
"""

PT016_INIT = """
    import threading

    class Stage:
        def __init__(self):
            self.prepares = {}
            self._t = threading.Thread(target=self._work)

        def _work(self):
            return self.prepares
"""

PT017_FRESH = """
    class Stage:
        def feed(self, env, frm):
            self._queue.put({"env": env, "frm": frm})
"""

PT017_MUTATE_AFTER = """
    class Stage:
        def submit(self, items):
            batch = list(items)
            self._queue.put(batch)
            batch.append(None)
"""

PT017_KV_PUT = """
    class Store:
        def save(self, key, items):
            batch = list(items)
            self._store.put(key, batch)
            batch.append(None)
"""

PT017_CAPTURE = """
    import threading

    class Node:
        def start(self):
            t = threading.Thread(
                target=lambda: self._drain(self.prepares))
            t.start()

        def _drain(self, votes):
            return votes
"""

PT017_METHOD_TARGET = """
    import threading

    class Node:
        def start(self):
            t = threading.Thread(target=self._worker_loop)
            t.start()

        def _worker_loop(self):
            return None
"""

# (id, rule code, relative path, source, fires)
SNIPPET_CASES = [
    ("pt001-bad", "PT001", "server/svc.py", ref.PT001_BAD, True),
    ("pt001-good", "PT001", "consensus/svc.py", ref.PT001_GOOD, False),
    ("pt003-bad", "PT003", "server/propagator.py", ref.PT003_BAD, True),
    ("pt003-good", "PT003", "server/propagator.py", ref.PT003_GOOD, False),
    ("pt004-bad", "PT004", "server/daemon.py", ref.PT004_BAD, True),
    ("pt004-good", "PT004", "server/daemon.py", ref.PT004_GOOD, False),
    ("pt004-pipeline-bad", "PT004", "runtime/stage.py",
     ref.PT004_PIPELINE_BAD, True),
    ("pt004-pipeline-good", "PT004", "runtime/stage.py",
     ref.PT004_PIPELINE_GOOD, False),
    ("pt005-bad", "PT005", "server/newdaemon.py", ref.PT005_BAD, True),
    ("pt005-good", "PT005", "server/newdaemon.py", ref.PT005_GOOD, False),
    ("pt007-bad", "PT007", "server/catchup2.py", ref.PT007_BAD, True),
    ("pt007-good", "PT007", "server/catchup2.py", ref.PT007_GOOD, False),
    ("pt008-bad", "PT008", "consensus/ordering2.py", ref.PT008_BAD, True),
    ("pt008-good", "PT008", "consensus/ordering2.py", ref.PT008_GOOD,
     False),
    ("pt009-bad", "PT009", "server/some_service.py", ref.PT009_BAD, True),
    ("pt009-good", "PT009", "server/some_service.py", ref.PT009_GOOD,
     False),
    ("pt010-bad", "PT010", "network/some_stack.py", ref.PT010_BAD, True),
    ("pt010-good", "PT010", "network/some_stack.py", ref.PT010_GOOD,
     False),
    ("pt010-nested", "PT010", "network/some_stack.py", PT010_NESTED, True),
    ("pt011-bad", "PT011", "server/handlers_x.py", ref.PT011_BAD, True),
    ("pt011-good", "PT011", "server/handlers_x.py", ref.PT011_GOOD, False),
    ("pragma-line", "PT001", "server/s.py", PRAGMA_LINE, True),
    ("pragma-file", "PT001", "server/s.py", PRAGMA_FILE, False),
    ("pragma-all", "PT001", "server/s.py",
     PRAGMA_FILE.replace("disable=PT001", "disable=all"), False),
]

# (id, rule codes, {relative path: source}, fires)
PROGRAM_CASES = [
    ("pt012-jitter-bad", ["PT012"], {
        "server/catchup.py": ref.PT012_BAD_JITTER,
        "consensus/view_change_service.py": ref.PT012_ROOT_CALLER}, True),
    ("pt012-jitter-good", ["PT012"], {
        "server/catchup.py": ref.PT012_GOOD_JITTER,
        "consensus/view_change_service.py": ref.PT012_ROOT_CALLER}, False),
    ("pt012-unreachable", ["PT012"], {
        "server/catchup.py": ref.PT012_BAD_JITTER}, False),
    ("pt012-set-bad", ["PT012"], {
        "consensus/view_change_service.py": PT012_SET_BAD}, True),
    ("pt012-set-good", ["PT012"], {
        "consensus/view_change_service.py": PT012_SET_GOOD}, False),
    ("pt012-random-time", ["PT012"], {
        "server/execution_lanes.py": PT012_RANDOM_TIME}, True),
    ("pt012-pragma", ["PT012"], {
        "server/execution_lanes.py": PT012_PRAGMA}, False),
    ("pt013-bad", ["PT013"], {
        "state/device_state.py": ref.PT013_BAD}, True),
    ("pt013-bad-cross", ["PT013"], {
        "state/device_state.py": ref.PT013_BAD_CROSS}, True),
    ("pt013-good", ["PT013"], {
        "state/device_state.py": ref.PT013_GOOD}, False),
    ("pt013-bls-bad", ["PT013"], {
        "crypto/bls_router.py": PT013_BLS_BAD}, True),
    ("pt013-bls-good", ["PT013"], {
        "crypto/bls_router.py": PT013_BLS_GOOD}, False),
    ("pt015-root-parses", ["PT015"], {
        "consensus/ordering_service.py": ref.PT015_ROOT_PARSES,
        "network/flat_wire.py": ref.PT015_PARSE_DEF}, True),
    ("pt015-helper", ["PT015"], {
        "consensus/ordering_service.py": PT015_HELPER_ROOT,
        "server/batch_tagger.py": PT015_HELPER,
        "network/flat_wire.py": ref.PT015_PARSE_DEF}, True),
    ("pt015-seam", ["PT015"], {
        "observability/wire_recv.py": ref.PT015_SEAM_PARSES,
        "network/flat_wire.py": ref.PT015_PARSE_DEF}, False),
    ("pt015-decode-calls-root", ["PT015"], {
        "network/flat_wire.py": PT015_DECODE_CALLS_ROOT,
        "consensus/ordering_service.py": PT015_PLAIN_ROOT}, True),
    ("pt016-cross-module", ["PT016"], {
        "runtime/pipeline.py": ref.PT016_PIPELINE_MOD,
        "consensus/ordering.py": ref.PT016_ORDERING_BAD}, True),
    ("pt016-good", ["PT016"], {
        "runtime/pipeline.py": ref.PT016_PIPELINE_GOOD}, False),
    ("pt016-dual", ["PT016"], {"runtime/stage.py": PT016_DUAL}, True),
    ("pt016-locked", ["PT016"], {"runtime/stage.py": PT016_LOCKED}, False),
    ("pt016-init", ["PT016"], {"runtime/stage.py": PT016_INIT}, False),
    ("pt017-fresh", ["PT017"], {"runtime/stage.py": PT017_FRESH}, True),
    ("pt017-mutate-after", ["PT017"], {
        "runtime/stage.py": PT017_MUTATE_AFTER}, True),
    ("pt017-kv-put", ["PT017"], {"storage/kv.py": PT017_KV_PUT}, False),
    ("pt017-capture", ["PT017"], {"server/node.py": PT017_CAPTURE}, True),
    ("pt017-method-target", ["PT017"], {
        "server/node.py": PT017_METHOD_TARGET}, False),
    ("pt004-held-out", ["PT004", "PT016", "PT017"], {
        "runtime/stage.py": ref.PT004_PIPELINE_BAD}, True),
]


@pytest.mark.parametrize("code,rel,src,fires",
                         [c[1:] for c in SNIPPET_CASES],
                         ids=[c[0] for c in SNIPPET_CASES])
def test_module_rule_fixture_mirrors_the_jax_analyzer(code, rel, src,
                                                      fires):
    jax_f = snippet(JAX, code, src, rel)
    port_f = snippet(PORT, code, src, rel)
    assert bool(jax_f) == fires, jax_f
    assert key(port_f, PORT) == key(jax_f, JAX)


@pytest.mark.parametrize("codes,files,fires",
                         [c[1:] for c in PROGRAM_CASES],
                         ids=[c[0] for c in PROGRAM_CASES])
def test_program_rule_fixture_mirrors_the_jax_analyzer(codes, files, fires,
                                                       tmp_path):
    jax_f = program(JAX, codes, files, tmp_path / "jax")
    port_f = program(PORT, codes, files, tmp_path / "port")
    assert bool(jax_f) == fires, jax_f
    assert key(port_f, PORT) == key(jax_f, JAX)


def test_module_rules_are_scoped_like_the_jax_analyzer():
    """Every per-module rule applies to the same relative paths under
    its package's prefix (PT002 aside: the port checks ops/mesh.py's
    dispatch half, the JAX package exempts the whole module)."""
    rels = ["server/node.py", "consensus/ordering_service.py",
            "gateway/intake.py", "network/stack.py", "client/client.py",
            "ops/merkle.py", "crypto/bls.py", "runtime/pipeline.py",
            "common/serializers/flat_wire.py", "testing/sim_network.py",
            "storage/kv.py", "ops/mesh.py"]
    for jcls, pcls in zip(JAX.rules.RULE_CLASSES, PORT.rules.RULE_CLASSES):
        assert jcls.code == pcls.code and jcls.name == pcls.name
        if jcls.code == "PT002":
            continue
        j, p = JAX.rule(jcls.code), PORT.rule(pcls.code)
        for rel in rels:
            assert j.applies(JAX.path(rel)) == p.applies(PORT.path(rel)), \
                (jcls.code, rel)
        assert not p.applies(JAX.path("server/node.py"))


# --------------------------------------------- device rules, translated

PT002_BAD = """
    import numpy as np
    import torch

    def _probe():
        return torch.cuda.device_count()   # an eager probe

    def dispatch_batch(rows):
        out = _kernel_cuda(torch.as_tensor(rows, device="cuda"))
        torch.cuda.synchronize()
        return np.asarray(out)
"""

PT002_GOOD = """
    import numpy as np
    import torch

    def dispatch_batch(rows):
        idx = np.asarray(list(rows))       # host data: no taint
        return _kernel_cuda(torch.from_numpy(idx).cuda(non_blocking=True))

    def collect_batch(handle):
        return handle.cpu().numpy()        # collect half MAY sync
"""

PT002_NESTED = """
    import numpy as np
    import torch

    def dispatch_batch(rows):
        def worker(x):
            out = torch.add(x, x)
            return out
        out = [1, 2, 3]               # host list, same name
        return int(out[0]), np.asarray(out), worker
"""

PT002_CHAIN = """
    import numpy as np
    import torch

    def dispatch_batch(rows):
        c = b                          # chain head textually first
        b = a
        a = torch.as_tensor(rows)
        return np.asarray(c)           # still a device sync
"""

PT002_NESTED_JAX = """
    import jax.numpy as jnp
    import numpy as np

    def dispatch_batch(rows):
        def worker(x):
            out = jnp.add(x, x)
            return out
        out = [1, 2, 3]               # host list, same name
        return int(out[0]), np.asarray(out), worker
"""

PT002_CHAIN_JAX = """
    import jax.numpy as jnp
    import numpy as np

    def dispatch_batch(rows):
        c = b                          # chain head textually first
        b = a
        a = jnp.asarray(rows)
        return np.asarray(c)           # still a device sync
"""

PT006_TORCH_MARKERS = """
    import torch

    def warm():
        try:
            torch.cuda.synchronize()
        except Exception:
            return None

    def launch(data, offsets):
        try:
            return sha3_ragged_cuda(data, offsets)
        except Exception:
            return None

    def build():
        try:
            return cuda_lib.load("sha3")
        except BaseException:
            return None
"""

PT006_ANY_CALL = """
    def load():
        try:
            return _local_builder()
        except Exception:
            return None
"""

PT014_BAD = """
    import numpy as np
    import torch

    @torch.compile(dynamic=False)
    def _keccak_kernel(words, nblocks):
        return words

    def dispatch_level_hash(blobs):
        need = [len(b) // 136 + 1 for b in blobs]
        nblocks = max(need)
        arr = np.zeros((len(blobs), nblocks, 17), dtype=np.uint32)
        return _keccak_kernel(torch.from_numpy(arr), nblocks)
"""

PT014_GOOD = """
    import numpy as np
    import torch

    from plenum_tpu_torch.ops.mesh import pow2_at_least

    @torch.compile(dynamic=False)
    def _keccak_kernel(words, nblocks):
        return words

    def dispatch_level_hash(blobs):
        need = [len(b) // 136 + 1 for b in blobs]
        nblocks = pow2_at_least(max(need))
        bp = pow2_at_least(len(blobs))
        arr = np.zeros((bp, nblocks, 17), dtype=np.uint32)
        return _keccak_kernel(torch.from_numpy(arr), nblocks)
"""

PT014_CONDITIONAL = """
    import numpy as np
    import torch

    from plenum_tpu_torch.ops.mesh import pow2_at_least

    @torch.compile
    def _kernel(rows):
        return rows

    def dispatch_jobs(jobs, sharded):
        bp = pow2_at_least(len(jobs)) if sharded else len(jobs)
        arr = np.zeros((bp, 48), dtype=np.uint8)
        return _kernel(torch.from_numpy(arr))
"""

PT014_PASSTHROUGH = """
    import numpy as np
    import torch

    @torch.compile
    def _kernel(rows):
        return rows

    def compress(rows, nvalid):
        return _kernel(rows)

    def caller_raw(msgs):
        arr = np.zeros((len(msgs), 64), dtype=np.uint8)
        return compress(torch.from_numpy(arr), len(msgs))
"""

PT014_PAIRING_BAD = """
    import numpy as np
    import torch

    @torch.compile
    def _pairing_kernel(rows):
        return rows

    def pairing_dispatch(jobs, n_pairs):
        arr = np.zeros((len(jobs), n_pairs, 48), dtype=np.uint8)
        return _pairing_kernel(torch.from_numpy(arr))
"""

PT014_PAIRING_GOOD = """
    import numpy as np
    import torch

    from plenum_tpu_torch.ops.mesh import pow2_at_least

    @torch.compile
    def _pairing_kernel(rows):
        return rows

    def pairing_dispatch(jobs, n_pairs):
        bp = pow2_at_least(len(jobs))
        pp = pow2_at_least(n_pairs)
        arr = np.zeros((bp, pp, 48), dtype=np.uint8)
        return _pairing_kernel(torch.from_numpy(arr))
"""

# (id, rule, JAX fixture at its relative path, torch translation, kind)
DEVICE_CASES = [
    ("pt002-bad", "PT002", "ops/newkernel.py", ref.PT002_BAD, PT002_BAD,
     "snippet"),
    ("pt002-good", "PT002", "ops/newkernel.py", ref.PT002_GOOD,
     PT002_GOOD, "snippet"),
    ("pt002-nested", "PT002", "ops/newkernel.py", PT002_NESTED_JAX,
     PT002_NESTED, "snippet"),
    ("pt002-chain", "PT002", "ops/newkernel.py", PT002_CHAIN_JAX,
     PT002_CHAIN, "snippet"),
    ("pt006-bad", "PT006", "server/v.py", ref.PT006_BAD,
     ref.PT006_BAD.replace("ed25519_jax", "ed25519"), "snippet"),
    ("pt006-good", "PT006", "server/v.py", ref.PT006_GOOD,
     ref.PT006_GOOD.replace("ed25519_jax", "ed25519"), "snippet"),
    ("pt006-any-call-crypto", "PT006", "crypto/newlib.py", PT006_ANY_CALL,
     PT006_ANY_CALL, "snippet"),
    ("pt006-any-call-storage", "PT006", "storage/helper2.py",
     PT006_ANY_CALL, PT006_ANY_CALL, "snippet"),
    ("pt014-keccak-bad", "PT014", "ops/sha3.py", ref.PT014_BAD_KECCAK,
     PT014_BAD, "program"),
    ("pt014-keccak-good", "PT014", "ops/sha3.py", ref.PT014_GOOD_KECCAK,
     PT014_GOOD, "program"),
    ("pt014-conditional", "PT014", "ops/bls.py", ref.PT014_BAD_CONDITIONAL,
     PT014_CONDITIONAL, "program"),
    ("pt014-passthrough", "PT014", "ops/shim.py", """
        import jax
        import jax.numpy as jnp
        import numpy as np

        @jax.jit
        def _kernel(rows):
            return rows

        def compress(rows, nvalid):
            return _kernel(rows)

        def caller_raw(msgs):
            arr = np.zeros((len(msgs), 64), dtype=np.uint8)
            return compress(jnp.asarray(arr), len(msgs))
     """, PT014_PASSTHROUGH, "program"),
    ("pt014-pairing-bad", "PT014", "ops/bls381_pairing.py", """
        import jax
        import jax.numpy as jnp
        import numpy as np

        @jax.jit
        def _pairing_kernel(rows):
            return rows

        def pairing_dispatch(jobs, n_pairs):
            arr = np.zeros((len(jobs), n_pairs, 48), dtype=np.uint8)
            return _pairing_kernel(jnp.asarray(arr))
     """, PT014_PAIRING_BAD, "program"),
    ("pt014-pairing-good", "PT014", "ops/bls381_pairing.py", """
        import jax
        import jax.numpy as jnp
        import numpy as np

        from plenum_tpu.ops import pow2_at_least

        @jax.jit
        def _pairing_kernel(rows):
            return rows

        def pairing_dispatch(jobs, n_pairs):
            bp = pow2_at_least(len(jobs))
            pp = pow2_at_least(n_pairs)
            arr = np.zeros((bp, pp, 48), dtype=np.uint8)
            return _pairing_kernel(jnp.asarray(arr))
     """, PT014_PAIRING_GOOD, "program"),
]


def _device_findings(side, code, rel, src, kind, root):
    if kind == "snippet":
        if not side.rule(code).applies(side.path(rel)):
            return []
        return snippet(side, code, src, rel)
    return program(side, [code], {rel: src}, root)


@pytest.mark.parametrize("code,rel,jax_src,torch_src,kind",
                         [c[1:] for c in DEVICE_CASES],
                         ids=[c[0] for c in DEVICE_CASES])
def test_device_rule_translation_fires_as_its_jax_twin(code, rel, jax_src,
                                                       torch_src, kind,
                                                       tmp_path):
    jax_f = _device_findings(JAX, code, rel, jax_src, kind,
                             tmp_path / "jax")
    port_f = _device_findings(PORT, code, rel, torch_src, kind,
                              tmp_path / "port")
    assert sorted(f.symbol for f in port_f) \
        == sorted(f.symbol for f in jax_f), (jax_f, port_f)


def _pt002(src, rel="ops/newkernel.py"):
    return snippet(PORT, "PT002", src, rel)


def test_pt002_flags_each_torch_host_sync_in_a_dispatch_half():
    findings = _pt002("""
        import numpy as np
        import torch

        def foo_dispatch(rows, ev, stream, arr, device):
            t = torch.as_tensor(rows)
            n = t.item()
            lst = t.tolist()
            host = t.cpu()
            arr = host.numpy()
            back = t.to("cpu")
            ev.synchronize()
            stream.synchronize()
            ok = bool(t.any())
            return n, lst, arr, back, ok
    """)
    what = sorted(f.message.split(" in dispatch-half")[0] for f in findings)
    assert what == sorted([".item() on a tensor", ".tolist() on a tensor",
                           ".cpu()", ".numpy()", '.to("cpu")',
                           ".synchronize()", ".synchronize()",
                           "bool() on a tensor"])


def test_pt002_host_arrays_in_a_dispatch_half_stay_clean():
    assert _pt002("""
        import numpy as np
        import torch

        def foo_dispatch(rows, device):
            idx = np.asarray(rows)
            n = int(idx.shape[0])
            first = idx[0].item()
            lens = idx.tolist()
            t = torch.from_numpy(idx).to(device, non_blocking=True)
            u = to_tensor(idx, device)
            return t, u, n, first, lens
    """) == []


def test_to_tensor_on_the_cpu_keeps_dtype_and_bits():
    """to_tensor, the one upload (pinned and non-blocking on CUDA), gives
    the plain versions on the CPU the array's values, uint32 as int32 of
    the same bits, also from a read-only array."""
    import numpy as np
    import torch
    from plenum_tpu_torch.ops import to_tensor
    ro = np.arange(6, dtype=np.int64)
    ro.flags.writeable = False
    for a in (np.array([[0, 1, 2 ** 31, 2 ** 32 - 1]], dtype=np.uint32),
              ro, np.zeros(3, dtype=np.uint8)):
        got = to_tensor(a, "cpu")
        want = a.view(np.int32) if a.dtype == np.uint32 else a
        assert got.dtype == torch.from_numpy(want.copy()).dtype
        assert np.array_equal(got.numpy(), want)


def test_pt002_probes_are_exempt_in_mesh_only():
    src = """
        import torch

        def probe():
            return torch.cuda.is_available(), torch.cuda.current_device()
    """
    assert _pt002(src, "ops/mesh.py") == []
    assert len(_pt002(src, "ops/sha256.py")) == 2
    assert len(_pt002(src, "sha256_ceilings.py")) == 2
    # the mesh's dispatch half is held to the rule all the same
    assert len(_pt002("""
        def dispatch(self, t):
            return t.cpu()
    """, "ops/mesh.py")) == 1
    # dispatch halves are an ops/ concept: a server's isn't checked
    assert _pt002("""
        def dispatch_batch(self, t):
            return t.cpu()
    """, "server/client_authn.py") == []


def test_pt006_reads_torch_device_markers():
    findings = snippet(PORT, "PT006", PT006_TORCH_MARKERS, "server/w.py")
    assert sorted(f.symbol for f in findings) == ["build", "launch", "warm"]


def _pt014(files, tmp_path):
    return program(PORT, ["PT014"], files, tmp_path)


def test_pt014_guards_trace_and_graph_boundaries(tmp_path):
    findings = _pt014({"ops/graphs.py": """
        import numpy as np
        import torch

        def _step(x):
            return x

        _traced = torch.jit.trace(_step, torch.zeros(8, 64))

        def run_traced(msgs):
            arr = np.zeros((len(msgs), 64), dtype=np.uint8)
            return _traced(torch.from_numpy(arr))

        _graphed = torch.cuda.make_graphed_callables(_step, (None,))

        def run_graphed(msgs):
            arr = np.zeros((len(msgs), 64), dtype=np.uint8)
            return _graphed(torch.from_numpy(arr))

        def capture(msgs, g):
            arr = np.zeros((len(msgs), 64), dtype=np.uint8)
            with torch.cuda.graph(g):
                out = _step(torch.from_numpy(arr))
            return out
    """}, tmp_path)
    assert sorted(f.symbol for f in findings) \
        == ["capture", "run_graphed", "run_traced"]


def test_pt014_bucketed_capture_and_dynamic_compile_stay_clean(tmp_path):
    assert _pt014({"ops/graphs.py": """
        import numpy as np
        import torch

        from plenum_tpu_torch.ops.mesh import pow2_at_least

        def _step(x):
            return x

        @torch.compile(dynamic=True)
        def _symbolic(x):
            return x

        def capture(msgs, g):
            arr = np.zeros((pow2_at_least(len(msgs)), 64), dtype=np.uint8)
            with torch.cuda.graph(g):
                out = _step(torch.from_numpy(arr))
            return out

        def run_symbolic(msgs):
            arr = np.zeros((len(msgs), 64), dtype=np.uint8)
            return _symbolic(torch.from_numpy(arr))
    """}, tmp_path) == []


def test_pt014_ctypes_launch_is_no_compile_boundary(tmp_path):
    """The BLS seams' conditional bucket before an nvcc-built kernel's
    ctypes launch: a finding in the JAX package, none in the port."""
    src = """
        import numpy as np

        from plenum_tpu_torch.ops.mesh import pow2_at_least

        def pairing_cuda(rows):
            return rows

        def pairing_dispatch(jobs, sharded):
            b = pow2_at_least(len(jobs)) if sharded else len(jobs)
            return pairing_cuda(np.zeros((b, 48), dtype=np.uint8))
    """
    assert _pt014({"ops/bls381_pairing.py": src}, tmp_path) == []


# ------------------------------------------------- baseline, held alike

def _fake_findings(side):
    F = side.core.Finding
    p = side.pkg
    return [F("PT006", "error", p + "/x.py", 10, 4, "msg", "A.b"),
            F("PT006", "error", p + "/x.py", 30, 4, "msg", "A.b"),
            F("PT001", "error", p + "/y.py", 5, 0, "other", "C.d")]


def _baseline_story(side, tmp_path):
    """The baseline's round trip, count budget, line drift and stale
    entries, as one record of outcomes."""
    B = side.baseline.Baseline
    findings = _fake_findings(side)
    path = str(tmp_path / (side.pkg + ".json"))
    B.from_findings(findings, justification="because").save(path)
    loaded = B.load(path)
    out = [len(loaded.entries), [e.get("count", 1) for e in loaded.entries]]
    new, old = loaded.match(findings)
    out.append((len(new), len(old)))
    new, old = loaded.match(findings + [findings[0]])
    out.append((len(new), len(old)))
    drifted = [f.__class__(f.rule, f.severity, f.path, f.line + 100, f.col,
                           f.message, f.symbol) for f in findings]
    new, old = loaded.match(drifted[:2])
    out.append((len(new), len(old)))
    out.append([(r, p[len(side.pkg):], s, m) for r, p, s, m
                in loaded.stale()])
    out.append(B.load(str(tmp_path / "nope.json")).entries)
    return out


def test_baseline_round_trip_and_stale_match_the_jax_analyzer(tmp_path):
    assert _baseline_story(PORT, tmp_path) == _baseline_story(JAX, tmp_path)


def test_baseline_version_mismatch_rejected_alike(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text(json.dumps({"version": 99, "entries": []}))
    for side in (JAX, PORT):
        with pytest.raises(ValueError):
            side.baseline.Baseline.load(str(path))


# ------------------------------------------------------ CLI, held alike

def _mirror_tree(side, root):
    """A fixture tree with findings of a per-module and a program rule."""
    for rel, src in (("server/s.py", ref.PT001_BAD),
                     ("runtime/stage.py", ref.PT004_PIPELINE_BAD),
                     ("server/clean.py", ref.PT001_GOOD)):
        p = root / side.path(rel)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(side.source(src))
    return root / side.pkg


def _cli(side, args, capsys):
    code = side.cli.main(args)
    return code, capsys.readouterr().out


def _strip(side, text):
    return text.replace(side.pkg + "/", "<pkg>/")


def test_cli_json_matches_the_jax_analyzer(tmp_path, capsys):
    outs = []
    for side in (JAX, PORT):
        root = tmp_path / side.pkg
        pkg = _mirror_tree(side, root)
        code, out = _cli(side, ["--json", "--no-baseline", "--root",
                                str(root), str(pkg)], capsys)
        data = json.loads(_strip(side, out))
        outs.append((code, data["summary"],
                     [(f["rule"], f["path"], f["line"], f["col"],
                       f["symbol"], f["baselined"])
                      for f in data["findings"]]))
    assert outs[0][0] == 1 and outs[0][2]
    assert outs[1] == outs[0]


def test_cli_sarif_matches_the_jax_analyzer(tmp_path, capsys):
    outs = []
    for side in (JAX, PORT):
        root = tmp_path / side.pkg
        pkg = _mirror_tree(side, root)
        bpath = tmp_path / (side.pkg + "-baseline.json")
        _cli(side, ["--root", str(root), "--baseline", str(bpath),
                    "--write-baseline", str(pkg / "server" / "s.py")],
             capsys)
        code, out = _cli(side, ["--sarif", "--root", str(root),
                                "--baseline", str(bpath), str(pkg)], capsys)
        run = json.loads(out)["runs"][0]
        outs.append((code, json.loads(out)["version"],
                     [r["id"] for r in run["tool"]["driver"]["rules"]],
                     [(r["ruleId"], r["baselineState"],
                       _strip(side, r["locations"][0]["physicalLocation"]
                              ["artifactLocation"]["uri"]),
                       r["locations"][0]["physicalLocation"]["region"])
                      for r in run["results"]]))
    assert {s for _, s, _, _ in outs[0][3]} == {"new", "unchanged"}
    assert outs[1] == outs[0]


# (id, argv after the root and baseline flags, paths under the package)
CLI_CASES = [
    ("select", ["--select", "PT003", "--no-baseline"], ["server/s.py"]),
    ("disable", ["--disable", "PT001", "--no-baseline"], ["server/s.py"]),
    ("severity", ["--severity", "PT001=warning", "--no-baseline"],
     ["server/s.py"]),
    ("unknown-code", ["--disable", "PT999"], ["server/s.py"]),
    ("bad-severity", ["--severity", "PT001=fatal"], ["server/s.py"]),
    ("missing-path", ["--no-baseline"], ["server/nope.py"]),
    ("whole-package", ["--no-baseline"], [""]),
    ("changed-not-a-repo", ["--changed"], []),
]


@pytest.mark.parametrize("argv,paths", [c[1:] for c in CLI_CASES],
                         ids=[c[0] for c in CLI_CASES])
def test_cli_flag_exit_codes_match_the_jax_analyzer(argv, paths, tmp_path,
                                                    capsys):
    codes = []
    for side in (JAX, PORT):
        root = tmp_path / side.pkg
        pkg = _mirror_tree(side, root)
        code, out = _cli(side, ["--root", str(root)] + argv
                         + [str(pkg / p) for p in paths], capsys)
        codes.append((code, _strip(side, out).replace(str(root), "<root>")))
    assert codes[1] == codes[0]


def test_cli_write_baseline_round_trip_matches(tmp_path, capsys):
    for side in (JAX, PORT):
        root = tmp_path / side.pkg
        pkg = _mirror_tree(side, root)
        bpath = tmp_path / (side.pkg + ".json")
        assert _cli(side, ["--root", str(root), "--baseline", str(bpath),
                           "--write-baseline", str(pkg)], capsys)[0] == 0
        assert _cli(side, ["--root", str(root), "--baseline", str(bpath),
                           str(pkg)], capsys)[0] == 0
    entries = [[(e["rule"], _strip(side, e["path"]), e["symbol"])
                for e in json.loads((tmp_path / (side.pkg + ".json"))
                                    .read_text())["entries"]]
               for side in (JAX, PORT)]
    assert entries[1] == entries[0]


def test_cli_changed_empty_diff_is_clean_alike(tmp_path, capsys):
    for side in (JAX, PORT):
        code, out = _cli(side, ["--changed", str(tmp_path)], capsys)
        assert code == 0 and "no changed Python files" in out


def test_cli_list_rules_matches_the_jax_catalog(capsys):
    outs = [_cli(side, ["--list-rules"], capsys) for side in (JAX, PORT)]
    assert outs[1] == outs[0]
    assert [line.split()[0] for line in outs[1][1].splitlines()] \
        == ["PT%03d" % i for i in range(1, 18)]


def test_module_entry_point_lists_rules():
    res = subprocess.run(
        [sys.executable, "-m", "plenum_tpu_torch.analysis", "--list-rules"],
        capture_output=True, text=True, timeout=60, cwd=REPO)
    assert res.returncode == 0
    assert [line.split()[0] for line in res.stdout.splitlines()] \
        == ["PT%03d" % i for i in range(1, 18)]


def test_module_entry_point_fails_on_host_sync_and_broad_except(tmp_path):
    """The acceptance shapes: .item() on a tensor in an ops/ dispatch
    half exits 1 with PT002; a broad except around a *_cuda call exits 1
    with PT006."""
    ops = tmp_path / "plenum_tpu_torch" / "ops"
    ops.mkdir(parents=True)
    (ops / "x.py").write_text(textwrap.dedent("""
        import torch

        def foo_dispatch(rows):
            t = torch.as_tensor(rows)
            return t.item()
    """))
    (ops / "y.py").write_text(textwrap.dedent("""
        def verify(data):
            try:
                return ed25519_verify_cuda(data)
            except Exception:
                return None
    """))
    for name, code in (("x.py", "PT002"), ("y.py", "PT006")):
        res = subprocess.run(
            [sys.executable, "-m", "plenum_tpu_torch.analysis", "--root",
             str(tmp_path), "--no-baseline", str(ops / name)],
            capture_output=True, text=True, timeout=60, cwd=REPO)
        assert res.returncode == 1, res.stdout + res.stderr
        assert " %s error" % code in res.stdout


# ------------------------------------------------ engine, held alike

ENGINE_TREE = {
    "base.py": """
        class BaseHandler:
            def commit(self):
                return 1
    """,
    "sub.py": """
        from plenum_tpu.base import BaseHandler

        class NymHandler(BaseHandler):
            def apply(self):
                return self.commit()

            def stage(self, blobs):
                return dispatch_node_hash_batch(blobs)

            def drop(self, blobs):
                self.stage(blobs)
    """,
    "cycle.py": """
        import random

        def ping(n):
            return pong(n - 1) if n else random.random()

        def pong(n):
            return ping(n)

        def leaf():
            return 1
    """,
    "ops/k.py": """
        import functools

        import torch

        @torch.compile
        def plain_compiled(x):
            return x

        @functools.partial(torch.compile, mode="max-autotune")
        def partial_compiled(x):
            return x

        @staticmethod
        def not_compiled(x):
            return x

        assigned = torch.compile(not_compiled)
    """,
}


def _engine(side, root):
    files = []
    for rel, src in ENGINE_TREE.items():
        p = root / side.path(rel)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(side.source(src))
        files.append(str(p))
    return side.engine.Engine.build(sorted(files), str(root),
                                    use_cache=False)


def _graph_record(side, eng):
    """Callees, callers and summaries of every symbol, with the package
    prefix taken out."""
    def strip(sym):
        return sym.replace(side.pkg + ".", "<pkg>.", 1)
    out = {}
    for sym in sorted(eng.graph.functions):
        s = eng.summaries[sym]
        out[strip(sym)] = (
            [strip(c) for c in eng.graph.callees(sym)],
            [strip(c) for c in eng.graph.callers(sym)],
            sorted(s.nondet), s.pure, sorted(s.returns_open),
            sorted(s.closes), s.routes_bucket, sorted(s.regions))
    return out


def test_engine_call_graph_and_summaries_match_the_jax_engine(tmp_path):
    jax_eng = _engine(JAX, tmp_path / "jax")
    port_eng = _engine(PORT, tmp_path / "port")
    jrec, prec = _graph_record(JAX, jax_eng), _graph_record(PORT, port_eng)
    # the compiled callables differ by idiom (jax.jit there, torch.compile
    # here) and are compared below; everything else is the same graph
    assert {k: v for k, v in prec.items() if "ops.k" not in k} \
        == {k: v for k, v in jrec.items() if "ops.k" not in k}
    assert prec["<pkg>.sub:NymHandler.apply"][0] \
        == ["<pkg>.base:BaseHandler.commit"]
    assert "random" in prec["<pkg>.cycle:pong"][2]
    funcs = {f["name"]: f for f in
             port_eng.files["plenum_tpu_torch/ops/k.py"]["functions"]}
    assert funcs["plain_compiled"]["jitted"]
    assert funcs["partial_compiled"]["jitted"]
    assert not funcs["not_compiled"]["jitted"]
    assert port_eng.files["plenum_tpu_torch/ops/k.py"]["jit_names"] \
        == ["assigned"]


def test_engine_module_names_and_cache_file_are_the_ports():
    from plenum_tpu_torch.analysis.engine import cache, symtab
    assert symtab.module_name("plenum_tpu_torch/ops/sha256.py") \
        == "plenum_tpu_torch.ops.sha256"
    assert symtab.module_name("plenum_tpu_torch/ops/__init__.py") \
        == "plenum_tpu_torch.ops"
    assert cache.CACHE_BASENAME == ".plenum_lint_torch_cache.json"
    from plenum_tpu.analysis.engine import cache as jax_cache
    assert cache.CACHE_BASENAME != jax_cache.CACHE_BASENAME
    assert sorted(symtab.BUCKET_HELPERS) == [
        "launch_lanes", "pad_messages", "padded_size", "pow2_at_least"]


def test_bucket_helpers_exist_where_the_port_defines_them():
    """Each helper PT014 accepts as bucket evidence is a function of the
    port (a renamed helper would leave the rule without evidence)."""
    from plenum_tpu_torch.analysis.engine.symtab import BUCKET_HELPERS
    from plenum_tpu_torch.ops import ed25519, mesh, sha256
    homes = {"pow2_at_least": mesh, "padded_size": mesh.DeviceMesh,
             "launch_lanes": ed25519, "pad_messages": sha256}
    assert set(homes) == set(BUCKET_HELPERS)
    for name, home in homes.items():
        assert callable(getattr(home, name)), name


def test_default_baseline_is_the_ports_own():
    assert port_lint.default_baseline(REPO) == os.path.join(
        REPO, "plenum_tpu_torch", "lint_baseline.json")
    assert jax_lint.repo_root() == port_lint.repo_root()


def test_chip_smoke_runs_every_dispatch_half_the_analyzer_names():
    """chip_smoke.py's lint phase runs each ops/ dispatch half on the card
    under set_sync_debug_mode("error"); its list must be the analyzer's,
    so that a new half fails here before it reaches the card."""
    import importlib.util
    from plenum_tpu_torch.analysis.rules.pt002_host_sync import (
        list_dispatch_halves)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_module", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.LINT_HALVES == tuple(list_dispatch_halves(REPO))
    assert len(smoke.LINT_HALVES) == 12
