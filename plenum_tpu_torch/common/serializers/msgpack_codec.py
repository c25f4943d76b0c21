"""Pure-Python MessagePack packer and unpacker for the types transactions
use: dict, list/tuple, str, bytes, int, bool, None and float.

The port carries its own codec so that it does not need the `msgpack`
package. `packb(x)` is byte-equal to `msgpack.packb(x, use_bin_type=True)`
and `unpackb(b)` returns what `msgpack.unpackb(b, raw=False,
strict_map_key=False)` returns; the ledger's txn serializer calls them
with dict keys already sorted.
"""
import struct
from typing import Any, Tuple

_pack_be16 = struct.Struct(">H").pack
_pack_be32 = struct.Struct(">I").pack
_pack_be64 = struct.Struct(">Q").pack
_pack_i8 = struct.Struct(">b").pack
_pack_i16 = struct.Struct(">h").pack
_pack_i32 = struct.Struct(">i").pack
_pack_i64 = struct.Struct(">q").pack
_pack_f64 = struct.Struct(">d").pack


def _pack_int(v: int, out: bytearray) -> None:
    if v >= 0:
        if v < 0x80:
            out.append(v)
        elif v <= 0xff:
            out += b"\xcc" + bytes((v,))
        elif v <= 0xffff:
            out += b"\xcd" + _pack_be16(v)
        elif v <= 0xffffffff:
            out += b"\xce" + _pack_be32(v)
        elif v <= 0xffffffffffffffff:
            out += b"\xcf" + _pack_be64(v)
        else:
            raise OverflowError("int too big to pack: %d" % v)
    elif v >= -32:
        out.append(v & 0xff)
    elif v >= -0x80:
        out += b"\xd0" + _pack_i8(v)
    elif v >= -0x8000:
        out += b"\xd1" + _pack_i16(v)
    elif v >= -0x80000000:
        out += b"\xd2" + _pack_i32(v)
    elif v >= -0x8000000000000000:
        out += b"\xd3" + _pack_i64(v)
    else:
        raise OverflowError("int too small to pack: %d" % v)


def _pack_len(n: int, fix_base: int, fix_max: int, codes: Tuple,
              out: bytearray) -> None:
    """Header of a str/bin/array/map of `n` items: the fix form where the
    type has one, else the 8-, 16- or 32-bit length form."""
    if n <= fix_max:
        out.append(fix_base | n)
    elif codes[0] is not None and n <= 0xff:
        out += bytes((codes[0], n))
    elif n <= 0xffff:
        out += bytes((codes[1],)) + _pack_be16(n)
    elif n <= 0xffffffff:
        out += bytes((codes[2],)) + _pack_be32(n)
    else:
        raise ValueError("object too large to pack: %d" % n)


_STR = (0xd9, 0xda, 0xdb)
_BIN = (0xc4, 0xc5, 0xc6)
_ARR = (None, 0xdc, 0xdd)
_MAP = (None, 0xde, 0xdf)


def _pack(obj: Any, out: bytearray, sort_keys: bool) -> None:
    t = type(obj)
    if t is str:
        raw = obj.encode("utf-8")
        _pack_len(len(raw), 0xa0, 31, _STR, out)
        out += raw
    elif t is int:
        _pack_int(obj, out)
    elif t is dict or isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 15, _MAP, out)
        for k in (sorted(obj) if sort_keys else obj):
            _pack(k, out, sort_keys)
            _pack(obj[k], out, sort_keys)
    elif t is list or t is tuple or isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 15, _ARR, out)
        for v in obj:
            _pack(v, out, sort_keys)
    elif obj is None:
        out.append(0xc0)
    elif t is bool:
        out.append(0xc3 if obj else 0xc2)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _pack_len(len(raw), 0, -1, _BIN, out)
        out += raw
    elif isinstance(obj, float):
        out += b"\xcb" + _pack_f64(obj)
    else:
        raise TypeError("can not serialize %r object" % t.__name__)


def packb(obj: Any, sort_keys: bool = False) -> bytes:
    """MessagePack bytes of `obj` (bin type for bytes, as
    `use_bin_type=True`). sort_keys=True orders every dict's keys, which
    equals packing the JAX package's `_sort_deep(obj)`."""
    out = bytearray()
    _pack(obj, out, sort_keys)
    return bytes(out)


_FIXED = {
    0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
    0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4), 0xd3: (">q", 8),
    0xca: (">f", 4), 0xcb: (">d", 8),
}
_LEN = {0xd9: 1, 0xda: 2, 0xdb: 4, 0xc4: 1, 0xc5: 2, 0xc6: 4,
        0xdc: 2, 0xdd: 4, 0xde: 2, 0xdf: 4}
_LEN_FMT = {1: ">B", 2: ">H", 4: ">I"}


def _take(data: bytes, pos: int, n: int) -> int:
    end = pos + n
    if end > len(data):
        raise ValueError("truncated msgpack data")
    return end


def _unpack(data: bytes, pos: int) -> Tuple[Any, int]:
    if pos >= len(data):
        raise ValueError("truncated msgpack data")
    code = data[pos]
    pos += 1
    if code < 0x80:
        return code, pos
    if code >= 0xe0:
        return code - 0x100, pos
    if 0xa0 <= code <= 0xbf:
        end = _take(data, pos, code & 0x1f)
        return data[pos:end].decode("utf-8"), end
    if 0x90 <= code <= 0x9f:
        return _unpack_array(data, pos, code & 0x0f)
    if 0x80 <= code <= 0x8f:
        return _unpack_map(data, pos, code & 0x0f)
    if code == 0xc0:
        return None, pos
    if code == 0xc2:
        return False, pos
    if code == 0xc3:
        return True, pos
    fixed = _FIXED.get(code)
    if fixed is not None:
        end = _take(data, pos, fixed[1])
        return struct.unpack(fixed[0], data[pos:end])[0], end
    width = _LEN.get(code)
    if width is None:
        raise ValueError("unsupported msgpack type byte 0x%02x" % code)
    end = _take(data, pos, width)
    n = struct.unpack(_LEN_FMT[width], data[pos:end])[0]
    pos = end
    if code in (0xdc, 0xdd):
        return _unpack_array(data, pos, n)
    if code in (0xde, 0xdf):
        return _unpack_map(data, pos, n)
    end = _take(data, pos, n)
    raw = data[pos:end]
    return (raw.decode("utf-8") if code in (0xd9, 0xda, 0xdb) else raw), end


def _unpack_array(data: bytes, pos: int, n: int) -> Tuple[list, int]:
    out = []
    for _ in range(n):
        v, pos = _unpack(data, pos)
        out.append(v)
    return out, pos


def _unpack_map(data: bytes, pos: int, n: int) -> Tuple[dict, int]:
    out = {}
    for _ in range(n):
        k, pos = _unpack(data, pos)
        v, pos = _unpack(data, pos)
        out[k] = v
    return out, pos


def unpackb(data: bytes) -> Any:
    """The object packed in `data`; raises ValueError on malformed or
    trailing bytes."""
    data = bytes(data)
    if not data:
        raise ValueError("empty msgpack data")
    obj, pos = _unpack(data, 0)
    if pos != len(data):
        raise ValueError("extra bytes after msgpack object")
    return obj
