"""Serializer implementations (reference: common/serializers/*.py).

MsgPack for the ledger (csrc/fastpath.c's canonical packer when it builds,
else the port's own pure-Python codec; both byte-equal to the `msgpack`
package's), ordered JSON for state values (bit-identical across nodes —
consensus-critical), Base58 for roots, Base64 for proof nodes, and the
canonical signing serialization.
"""
import base64
import json
from abc import ABC, abstractmethod
from typing import Any

from plenum_tpu_torch.common.serializers.base58 import b58decode, b58encode
from plenum_tpu_torch.common.serializers.msgpack_codec import packb, unpackb
from plenum_tpu_torch.ops.cuda_lib import try_load_host_ext

_fp = try_load_host_ext("fastpath")


class Serializer(ABC):
    @abstractmethod
    def serialize(self, data: Any, to_bytes=True) -> Any:
        ...

    @abstractmethod
    def deserialize(self, data: Any) -> Any:
        ...


class MsgPackSerializer(Serializer):
    """Reference: common/serializers/msgpack_serializer.py:13.
    Keys are sorted at every nesting level so serialization is canonical
    across nodes (consensus digests depend on it)."""

    def serialize(self, data: Any, to_bytes=True) -> bytes:
        if _fp is not None:
            try:
                return _fp.canonical_msgpack(data)
            except TypeError:
                pass  # non-str keys, too deep, etc. — the Python path decides
        return packb(data, sort_keys=True)

    def deserialize(self, data: Any) -> Any:
        if isinstance(data, (bytes, bytearray, memoryview)):
            return unpackb(data)
        return data


class OrderedJsonSerializer(Serializer):
    """Canonical JSON: sorted keys, no whitespace (reference:
    common/serializers/json_serializer.py:46 — state values must serialize
    bit-identically on every node)."""

    def serialize(self, data: Any, to_bytes=True):
        if to_bytes and _fp is not None:
            try:
                return _fp.canonical_json_ascii(data)
            except TypeError:
                pass
        out = json.dumps(data, sort_keys=True, separators=(',', ':'))
        return out.encode('utf-8') if to_bytes else out

    def deserialize(self, data: Any) -> Any:
        if isinstance(data, (bytes, bytearray, memoryview)):
            data = bytes(data).decode('utf-8')
        return json.loads(data)


JsonSerializer = OrderedJsonSerializer


class SigningSerializer(Serializer):
    """Canonical msg → bytes for signing (reference:
    common/serializers/signing_serializer.py + serialize_msg_for_signing):
    deterministic field order, nested dicts flattened the same way on every
    node. We use canonical JSON with sorted keys over the 'plain' dict."""

    def serialize(self, data: Any, to_bytes=True, topLevelKeysToIgnore=None):
        if hasattr(data, 'as_dict'):
            data = data.as_dict()
        elif hasattr(data, '_asdict'):
            data = data._asdict()
        if isinstance(data, dict) and topLevelKeysToIgnore:
            data = {k: v for k, v in data.items()
                    if k not in topLevelKeysToIgnore}
        out = json.dumps(data, sort_keys=True, separators=(',', ':'),
                         ensure_ascii=False)
        return out.encode('utf-8') if to_bytes else out

    def deserialize(self, data):
        if isinstance(data, (bytes, bytearray)):
            data = data.decode('utf-8')
        return json.loads(data)


class Base58Serializer(Serializer):
    def serialize(self, data: bytes, to_bytes=False) -> str:
        return b58encode(data)

    def deserialize(self, data) -> bytes:
        return b58decode(data)


class Base64Serializer(Serializer):
    def serialize(self, data, to_bytes=True):
        return base64.b64encode(data)

    def deserialize(self, data):
        return base64.b64decode(data)
