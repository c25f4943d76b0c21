"""Minimal RLP encoding (trie node serialization).

The reference uses RLP for MPT nodes (state/util/fast_rlp.py). Wire
compatibility with Ethereum is not a goal, but RLP is compact, canonical,
and self-delimiting, so trie hashes are well-defined. Supports bytes and
(nested) lists of bytes — all a trie node needs.

This file is the reference implementation; the CPython extension built
from csrc/rlp_c.c replaces `encode`/`decode` at import when it builds
(ops/cuda_lib.try_load_host_ext; PLENUM_TPU_NO_NATIVE keeps this codec).
The two are byte-equal (tests/test_torch_native.py).
"""
from typing import List, Tuple, Union

RlpItem = Union[bytes, List["RlpItem"]]

# both backends bound LIST nesting identically (DoS guard; trie nodes
# are depth <= 2): a list nested more than MAX_DEPTH levels deep is
# invalid to encode AND to decode, in the C and Python codecs alike —
# the backends MUST agree on validity or nodes with and without a C
# compiler would diverge, and encode must never produce what decode
# rejects. Bytes leaves carry no depth of their own.
MAX_DEPTH = 64


# one-byte length prefixes, precomputed (the hot path: trie refs are
# 32-byte hashes and node bodies are usually short)
_STR_PFX = [bytes([0x80 + n]) for n in range(56)]
_LIST_PFX = [bytes([0xC0 + n]) for n in range(56)]


def _encode_py(item: RlpItem, _depth: int = 0) -> bytes:
    t = type(item)
    if t is bytes:
        n = len(item)
        if n == 1 and item[0] < 0x80:
            return item
        if n < 56:
            return _STR_PFX[n] + item
        return _len_prefix(n, 0x80) + item
    if t is list or t is tuple:
        if _depth >= MAX_DEPTH:
            raise ValueError("RLP nesting too deep")
        parts = []
        for x in item:
            if type(x) is bytes:          # inline the dominant case
                n = len(x)
                if n == 1 and x[0] < 0x80:
                    parts.append(x)
                elif n < 56:
                    parts.append(_STR_PFX[n] + x)
                else:
                    parts.append(_len_prefix(n, 0x80) + x)
            else:
                parts.append(_encode_py(x, _depth + 1))
        body = b"".join(parts)
        n = len(body)
        if n < 56:
            return _LIST_PFX[n] + body
        return _len_prefix(n, 0xC0) + body
    # subclasses (and bytearray) take the old isinstance-based path —
    # the exact-type checks above are only a fast path, not a contract
    # change
    if isinstance(item, (bytes, bytearray)):
        return _encode_py(bytes(item), _depth)
    if isinstance(item, (list, tuple)):
        return _encode_py(list(item), _depth)
    raise TypeError("cannot RLP-encode {}".format(type(item)))


def _len_prefix(length: int, offset: int) -> bytes:
    if length < 56:
        return bytes([offset + length])
    ll = length.to_bytes((length.bit_length() + 7) // 8, "big")
    return bytes([offset + 55 + len(ll)]) + ll


def decode(data: bytes) -> RlpItem:
    data = bytes(data)
    item, pos = _decode_at(data, 0, len(data), 0)
    if pos != len(data):
        raise ValueError("trailing RLP bytes")
    return item


def _decode_at(data: bytes, pos: int, end: int,
               depth: int = 0) -> Tuple[RlpItem, int]:
    """Decode one item at offset `pos`, bounded by `end`; returns
    (item, next_pos). Offset-based so only final payloads are sliced —
    the old remainder-slicing decoder copied O(n²) bytes on branch
    nodes (this is the hottest path in the MPT)."""
    if pos >= end:
        raise ValueError("empty RLP")
    b0 = data[pos]
    if b0 < 0x80:
        return data[pos:pos + 1], pos + 1
    if b0 < 0xB8:  # short string
        n = b0 - 0x80
        nxt = pos + 1 + n
        if nxt > end:
            raise ValueError("truncated RLP")
        if n == 1 and data[pos + 1] < 0x80:
            raise ValueError("non-canonical RLP single byte")
        return data[pos + 1:nxt], nxt
    if b0 < 0xC0:  # long string
        body, nxt = _read_len_at(data, pos, b0 - 0xB7, 56, end)
        return data[body:nxt], nxt
    if 0xC0 <= b0 and depth >= MAX_DEPTH:
        raise ValueError("RLP nesting too deep")
    if b0 < 0xF8:  # short list
        n = b0 - 0xC0
        nxt = pos + 1 + n
        if nxt > end:
            raise ValueError("truncated RLP")
        body = pos + 1
    else:  # long list
        body, nxt = _read_len_at(data, pos, b0 - 0xF7, 56, end)
    out = []
    p = body
    while p < nxt:
        item, p = _decode_at(data, p, nxt, depth + 1)
        out.append(item)
    return out, nxt


def _read_len_at(data: bytes, pos: int, ln: int, minimum: int,
                 end: int) -> Tuple[int, int]:
    """→ (payload_start, payload_end) for a long-form item at pos."""
    if pos + 1 + ln > end:
        raise ValueError("truncated RLP")
    if data[pos + 1] == 0:
        raise ValueError("leading zero in RLP length")
    n = int.from_bytes(data[pos + 1:pos + 1 + ln], "big")
    if n < minimum:
        raise ValueError("non-canonical RLP length")
    start = pos + 1 + ln
    if start + n > end:
        raise ValueError("truncated RLP")
    return start, start + n


# keep the pure-Python pair importable regardless of backend (the
# implementations self-recurse, so the native override below cannot
# hijack their internals)
encode_py = _encode_py
decode_py = decode
encode = _encode_py
BACKEND = "python"

from plenum_tpu_torch.ops.cuda_lib import try_load_host_ext  # noqa: E402

_c = try_load_host_ext("rlp_c")
if _c is not None:
    encode = _c.encode
    decode = _c.decode
    BACKEND = "native"
