"""The port's ed25519 verify (plenum_tpu_torch/ops/ed25519.py) against the
JAX package on the same inputs: the numpy host packing, the plain PyTorch
field and point helpers against the Pallas kernel's helpers run on numpy
(the `numpy_field` way of tests/test_ed25519_pallas.py: no XLA compile),
and the plain verify's verdicts against the RFC 8032 scalar verify on a
batch that mixes valid signatures with every rejection path. Tolerance:
none — limbs, masks and verdicts must be equal."""
import functools
import random

import numpy as np
import pytest
import torch

import plenum_tpu.ops.ed25519_pallas as edp
from plenum_tpu.crypto import ed25519 as jax_scalar
from plenum_tpu.ops import ed25519_jax as edj
from plenum_tpu_torch import testing
from plenum_tpu_torch.ops import ed25519 as ted
from plenum_tpu_torch.ops import to_tensor

P = edj.P


@pytest.fixture
def numpy_field(monkeypatch):
    """Run the Pallas module's array code on numpy (no jax op dispatch)."""
    monkeypatch.setattr(edp, "jnp", np)
    monkeypatch.setattr(
        edp, "_sqn",
        lambda x, n: functools.reduce(lambda a, _: edp._fsq(a), range(n), x))


def _rows(vals):
    """Python ints → ([20, B] int64 port tensor, Pallas limb list)."""
    arr = np.stack([edj._int_to_limbs(v) for v in vals]).T    # [20, B]
    return (torch.from_numpy(arr.astype(np.int64)),
            [np.ascontiguousarray(arr[i:i + 1]) for i in range(edp.NLIMB)])


def _assert_fe_equal(port, pallas):
    np.testing.assert_array_equal(
        port.numpy(), np.concatenate(pallas, axis=0).astype(np.int64))


def _batch(n, seed):
    msgs, sigs, vks, kinds = testing.adversarial_signatures(n, seed,
                                                            unique=12)
    return msgs, sigs, vks, kinds


@pytest.mark.parametrize("n,seed", [(16, 1), (64, 2)])
def test_host_pack_matches_jax(n, seed):
    msgs, sigs, vks, _ = _batch(n, seed)
    got, got_valid = ted.host_pack(msgs, sigs, vks)
    want, want_valid = edj.host_pack(msgs, sigs, vks)
    np.testing.assert_array_equal(got_valid, want_valid)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.astype(np.int64),
                                      w.astype(np.int64))
    # the rejection paths the host owns are all present in the batch
    assert not got_valid.all() and got_valid.any()


def test_field_helpers_match_pallas(numpy_field):
    rng = random.Random(3)
    a_int = [rng.randrange(P) for _ in range(48)] + [0, 1, P - 1, P - 19]
    b_int = [rng.randrange(P) for _ in range(len(a_int))]
    (ta, pa), (tb, pb) = _rows(a_int), _rows(b_int)
    _assert_fe_equal(ted.fmul(ta, tb), edp._fmul(pa, pb))
    _assert_fe_equal(ted.fsq(ta), edp._fsq(pa))
    _assert_fe_equal(ted.fadd(ta, tb), edp._fadd(pa, pb))
    _assert_fe_equal(ted.fsub(ta, tb), edp._fsub(pa, pb))
    _assert_fe_equal(ted.fneg(ta), edp._fneg(pa))
    _assert_fe_equal(ted.fcanon(ted.fsub(ta, tb)),
                     edp._fcanon(edp._fsub(pa, pb)))
    _assert_fe_equal(ted.pow_p58(ta), edp._pow_p58(pa))
    np.testing.assert_array_equal(
        ted.feq(ted.fadd(ta, tb), ted.fadd(tb, ta)).numpy(), True)
    for j, (x, y) in enumerate(zip(a_int, b_int)):
        assert edj._limbs_to_int(ted.fmul(ta, tb)[:, j].tolist()) % P \
            == x * y % P


def test_decompress_and_point_ops_match_pallas(numpy_field):
    msgs, sigs, vks, _ = _batch(39, 4)
    arrays, _ = ted.host_pack(msgs, sigs, vks)
    ay, asign = arrays[0].T, arrays[1]
    t_ay = torch.from_numpy(ay.astype(np.int64))
    p_ay = [np.ascontiguousarray(ay[i:i + 1]) for i in range(edp.NLIMB)]
    t_x, t_ok = ted.decompress(t_ay, torch.from_numpy(asign.astype(np.int64)))
    p_x, p_ok = edp._decompress(p_ay, asign.reshape(1, -1))
    np.testing.assert_array_equal(t_ok.numpy(), np.asarray(p_ok)[0])
    assert t_ok.any() and not t_ok.all()
    _assert_fe_equal(t_x, p_x)

    one_t, one_p = _rows([1] * ay.shape[1])
    t_pt = (t_x, t_ay, one_t, ted.fmul(t_x, t_ay))
    p_pt = (p_x, p_ay, one_p, edp._fmul(p_x, p_ay))
    for got, want in zip(ted.pt_double(*t_pt), edp._pt_double(*p_pt)):
        _assert_fe_equal(got, want)
    t_2 = ted.pt_double(*t_pt)
    p_2 = edp._pt_double(*p_pt)
    for got, want in zip(ted.pt_add(*t_pt, *t_2), edp._pt_add(*p_pt, *p_2)):
        _assert_fe_equal(got, want)
    t_q = t_2[:3] + (ted.fmul(t_2[3], ted._const(ted._TWOD_L, t_2[3])),)
    p_q = p_2[:3] + (edp._fmul_const(p_2[3], edp._TWOD),)
    for got, want in zip(ted.pt_add_prescaled(*t_pt, *t_q),
                         edp._pt_add_prescaled(*p_pt, *p_q)):
        _assert_fe_equal(got, want)
    d = 7
    t_n = [torch.from_numpy(np.repeat(t[d][:, None], ay.shape[1], 1)
                            .astype(np.int64))
           for t in (ted._NB_SUB, ted._NB_ADD, ted._NB_T2D)]
    p_n = [[np.full((1, ay.shape[1]), int(t[d, k]), dtype=np.int32)
            for k in range(edp.NLIMB)]
           for t in (edp._NB_SUB, edp._NB_ADD, edp._NB_T2D)]
    for got, want in zip(ted.pt_add_niels(*t_pt, *t_n),
                         edp._pt_add_niels_const(*p_pt, *p_n)):
        _assert_fe_equal(got, want)


def test_base_table_matches_jax():
    for got, want in zip((ted._NB_SUB, ted._NB_ADD, ted._NB_T2D),
                         (edj._NB_SUB, edj._NB_ADD, edj._NB_T2D)):
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("n,seed", [(16, 5), (52, 6)])
def test_verify_plain_matches_rfc8032(n, seed):
    msgs, sigs, vks, kinds = _batch(n, seed)
    want = [jax_scalar.verify(m, s, v) for m, s, v in zip(msgs, sigs, vks)]
    arrays, valid = ted.host_pack(msgs, sigs, vks)
    ok = ted.verify(*[to_tensor(a, "cpu") for a in arrays])
    got = ok.numpy() & valid
    assert got.tolist() == want
    assert any(want) and not all(want)
    # the batch entry must give the same verdicts
    assert ted.verify_batch(msgs, sigs, vks, device="cpu").tolist() == want
    assert {k for k, w in zip(kinds, want) if w} <= {"valid",
                                                     "a_small_order"}


@pytest.mark.parametrize("n,seed", [(26, 8), (104, 9)])
def test_host_scalar_verify_equals_the_python_and_jax_packages(n, seed):
    """crypto/ed25519.verify, whose points csrc/ed25519_host.c checks once
    it is built, against its Python check and the JAX package's scalar
    verify on every rejection path of the adversarial batch."""
    from plenum_tpu_torch.crypto import ed25519 as scalar
    assert scalar._load_native_check() is not None
    msgs, sigs, vks, kinds = _batch(n, seed)
    want = [jax_scalar.verify(m, s, v) for m, s, v in zip(msgs, sigs, vks)]
    assert [scalar.verify(m, s, v)
            for m, s, v in zip(msgs, sigs, vks)] == want
    assert [scalar.verify_python(m, s, v)
            for m, s, v in zip(msgs, sigs, vks)] == want
    assert scalar._check_impl is not scalar._check_python
    assert any(want) and not all(want)
    assert len(set(kinds)) == len(testing.KINDS)


@pytest.mark.parametrize("n", [1, 7, 9, 52])
def test_verify_batch_launches_exactly_n_rows(n, monkeypatch):
    msgs, sigs, vks, _ = _batch(n, 8)
    rows = []
    plain = ted.verify_plain

    def counting_plain(ay, *rest):
        rows.append(int(ay.shape[0]))
        return plain(ay, *rest)

    monkeypatch.setattr(ted, "verify_plain", counting_plain)
    want = [jax_scalar.verify(m, s, v) for m, s, v in zip(msgs, sigs, vks)]
    assert ted.verify_batch(msgs, sigs, vks, device="cpu").tolist() == want
    assert rows == [n]


def test_cuda_wrapper_rejects_cpu_and_bad_shapes():
    arrays, _ = ted.host_pack(*_batch(8, 7)[:3])
    ts = [to_tensor(a, "cpu") for a in arrays]
    with pytest.raises(ValueError):
        ted.verify_cuda(*ts)
    ts[0] = ts[0][:, :19].contiguous()
    with pytest.raises(ValueError):
        ted.verify_cuda(*ts)
