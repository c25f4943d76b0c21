"""The port's validator-info dump (server/validator_info.py) against the
JAX package's: on the same 4-node sim pool after the same writes, each
node's ValidatorNodeInfoTool.info has the JAX package's sections and
keys, and equal ledger sizes, ledger and state roots, 3PC positions and
pool counts (what varies by host or time is left out: hardware, memory,
timestamps, latencies, span counts, and the version and device-mesh
sections, which name each package's own stack); dump_json_file writes
the same file name with the same content. build_networked_node passes info_dir
<base>/<name>, so a node built from a pool directory dumps there on
VALIDATOR_INFO_DUMP_INTERVAL, as the JAX package's does. Tolerance:
none."""
import json
import os

import pytest

from tests.torch_two_packages import (
    BASE_CONF, JAX, NAMES, PORT, Pool, jax_warm_off, pkg)

# sections whose values vary by host or time, or name the package's own
# stack (Software: its version and framework; Device_mesh: each
# package's mesh dispatcher, whose device counts name its own devices;
# its keys are held equal below)
VARYING = ("timestamp", "uptime_s", "Hardware_info", "Memory_info",
           "Latencies", "Software", "Device_mesh", "Extractions",
           "Telemetry", "Freshness_status", "Metrics")
# keys equal, values not: the port's verifier hub records spans of its
# own on the node's tracer (hub_flush, hub_collect)
SPAN_COUNTS = ("Tracing",)


def _tool(name, node):
    import importlib
    mod = importlib.import_module(name + ".server.validator_info")
    return mod.ValidatorNodeInfoTool(node, get_time=lambda: 1600000100.0)


@pytest.fixture(scope="module")
def infos():
    out = {}
    with jax_warm_off():
        for name in (PORT, JAX):
            pl = Pool(pkg(name), 19, config=dict(BASE_CONF,
                                                 TRACING_ENABLED=True))
            sc = pl.scenario()
            for i in range(4):
                pl.submit(i, 700 + i)
            sc.run(8)
            out[name] = (pl, [_tool(name, n) for n in pl.nodes])
    return out


def _keys(d, depth=2):
    if not isinstance(d, dict) or depth == 0:
        return None
    return {k: _keys(v, depth - 1) for k, v in d.items()}


def test_info_has_the_jax_packages_sections_and_keys(infos):
    import importlib
    # both meshes enumerated and probed, so each dump carries every key
    # its package's mesh_stats() can give
    for name in (PORT, JAX):
        mesh = importlib.import_module(name + ".ops.mesh")
        mesh.probe_platform()
        assert mesh.get_mesh().n_devices >= 1
    port = [t.info for t in infos[PORT][1]]
    ref = [t.info for t in infos[JAX][1]]
    from plenum_tpu_torch.ops.mesh import mesh_stats
    for p_info, r_info in zip(port, ref):
        assert set(p_info) == set(r_info)
        for key in set(p_info) - set(VARYING):
            assert _keys(p_info[key]) == _keys(r_info[key]), key
        assert set(p_info["Software"]) == {"plenum_tpu_torch", "python",
                                           "torch"}
        assert set(p_info["Device_mesh"]) == set(r_info["Device_mesh"])
        assert p_info["Device_mesh"] == mesh_stats()


def test_info_values_equal_the_jax_packages(infos):
    for p_tool, r_tool in zip(infos[PORT][1], infos[JAX][1]):
        p_info, r_info = p_tool.info, r_tool.info
        assert p_info["Node_info"]["Ledger_sizes"]["domain"] == 4
        for key in set(p_info) - set(VARYING + SPAN_COUNTS):
            assert p_info[key] == r_info[key], key
        assert p_info["Pool_info"]["Total_nodes_count"] == len(NAMES)
        assert p_info["Pool_info"]["f_value"] == 1


def test_dump_json_file_writes_the_same_file(infos, tmp_path):
    files = {}
    for name in (PORT, JAX):
        out = tmp_path / name
        path = infos[name][1][0].dump_json_file(str(out))
        assert os.path.dirname(path) == str(out)
        with open(path) as f:
            files[name] = (os.path.basename(path), json.load(f))
    assert files[PORT][0] == files[JAX][0] == "alpha_info.json"
    port, ref = files[PORT][1], files[JAX][1]
    for key in set(port) - set(VARYING + SPAN_COUNTS):
        assert port[key] == ref[key], key


@pytest.mark.parametrize("name", [PORT, JAX])
def test_build_networked_node_dumps_into_its_directory(name, tmp_path):
    """A node built from a pool directory dumps <name>_info.json into
    <base>/<name>/ once VALIDATOR_INFO_DUMP_INTERVAL has passed on its
    timer, with the genesis' pool counts."""
    import importlib
    import time
    p = pkg(name)
    bootstrap = importlib.import_module(name + ".bootstrap")
    base = str(tmp_path / "pool")
    bootstrap.generate_pool(base, NAMES, base_port=19700)
    cfg = p.Config(VALIDATOR_INFO_DUMP_INTERVAL=0.05,
                   **({"VERIFIER_PROVIDER": "cpu"} if name == JAX else {}))
    kw = {"device": "cpu"} if name == PORT else {}
    with jax_warm_off():
        node = bootstrap.build_networked_node("Beta", base, config=cfg, **kw)
    path = os.path.join(base, "Beta", "beta_info.json")
    assert not os.path.exists(path)
    time.sleep(0.1)
    node.timer.service()
    with open(path) as f:
        info = json.load(f)
    assert info["alias"] == "Beta"
    assert info["Pool_info"]["Total_nodes_count"] == len(NAMES)
    assert info["Node_info"]["Ledger_sizes"]["pool"] == len(NAMES)
    assert info["Node_info"]["Ledger_sizes"]["domain"] == \
        node.node.domain_ledger.size
