"""The port's pure-Python MessagePack codec against the `msgpack` package:
byte-equal packing of txn-shaped data and exact round trips."""
import msgpack
import pytest
from hypothesis import given, settings, strategies as st

from plenum_tpu.common.serializers import serializers as jax_ser
from plenum_tpu_torch.common.serializers import msgpack_codec
from plenum_tpu_torch.common.serializers.serialization import (
    ledger_txn_serializer)

_scalars = (st.none() | st.booleans()
            | st.integers(min_value=-(1 << 63), max_value=(1 << 64) - 1)
            | st.text(max_size=300) | st.binary(max_size=300)
            | st.floats(allow_nan=False))
_values = st.recursive(
    _scalars,
    lambda inner: st.lists(inner, max_size=20)
    | st.dictionaries(st.text(max_size=12), inner, max_size=20),
    max_leaves=40)


@settings(max_examples=80, deadline=None)
@given(_values)
def test_packb_is_byte_equal_to_msgpack(obj):
    assert msgpack_codec.packb(obj) == msgpack.packb(obj, use_bin_type=True)
    assert msgpack_codec.unpackb(msgpack_codec.packb(obj)) == \
        msgpack.unpackb(msgpack.packb(obj, use_bin_type=True), raw=False,
                        strict_map_key=False)


@settings(max_examples=60, deadline=None)
@given(st.dictionaries(st.text(max_size=12), _values, max_size=12))
def test_ledger_serializer_matches_sorted_msgpack(txn):
    want = msgpack.packb(jax_ser._sort_deep(txn), use_bin_type=True)
    assert ledger_txn_serializer.serialize(txn) == want
    assert ledger_txn_serializer.deserialize(want) == \
        msgpack.unpackb(want, raw=False, strict_map_key=False)


@pytest.mark.parametrize("n", [0, 15, 16, 255, 256, 65535, 65536])
def test_length_boundaries(n):
    for obj in ("x" * n, b"y" * n, list(range(min(n, 70000))),
                {str(i): i for i in range(n)}):
        assert msgpack_codec.packb(obj) == msgpack.packb(obj,
                                                         use_bin_type=True)
        assert msgpack_codec.unpackb(msgpack_codec.packb(obj)) == \
            (list(obj) if isinstance(obj, list) else obj)


@pytest.mark.parametrize("bad", [b"", b"\xc1", b"\xa3ab", b"\x91",
                                 b"\xc0\xc0"])
def test_unpackb_rejects_malformed(bad):
    with pytest.raises(ValueError):
        msgpack_codec.unpackb(bad)


def test_packb_rejects_out_of_range_and_unknown_types():
    with pytest.raises(OverflowError):
        msgpack_codec.packb(1 << 64)
    with pytest.raises(OverflowError):
        msgpack_codec.packb(-(1 << 63) - 1)
    with pytest.raises(TypeError):
        msgpack_codec.packb({1, 2})
