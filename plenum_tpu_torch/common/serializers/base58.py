"""Base58 codec (bitcoin alphabet), pure Python. Used for merkle roots,
audit paths and DIDs (reference: common/serializers/base58_serializer.py;
a copy of the JAX package's pure-Python branch)."""

ALPHABET = b'123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz'
_INDEX = {c: i for i, c in enumerate(ALPHABET)}
_A = ALPHABET.decode('ascii')
# chunked conversion: peel 10 digits (58^10 < 2^59) per bigint divmod —
# ~10x fewer bigint ops than digit-at-a-time (hot path: every merkle /
# state root crossing a serialization boundary goes through here)
_B58_10 = 58 ** 10
_DIGITS10 = {}


def _enc10(r: int) -> str:
    """10-digit base58 block with leading '1' padding, memoized."""
    got = _DIGITS10.get(r)
    if got is None:
        out = []
        v = r
        for _ in range(10):
            v, d = divmod(v, 58)
            out.append(_A[d])
        got = ''.join(reversed(out))
        if len(_DIGITS10) < 1 << 16:
            _DIGITS10[r] = got
    return got


# hash-sized payloads repeat heavily (audit-path nodes shared by every
# Reply in a batch; roots re-encoded per peer), so memoize those
_ENC32 = {}


def b58encode(data: bytes) -> str:
    if type(data) is bytes and len(data) == 32:
        got = _ENC32.get(data)
        if got is not None:
            return got
        out = _encode_backend(data)
        if len(_ENC32) >= 1 << 16:
            for stale in list(_ENC32)[:1 << 15]:
                del _ENC32[stale]
        _ENC32[data] = out
        return out
    return _encode_backend(data)


def _b58encode_raw(data: bytes) -> str:
    n = int.from_bytes(data, 'big')
    blocks = []
    while n >= _B58_10:
        n, r = divmod(n, _B58_10)
        blocks.append(_enc10(r))
    head = ''
    while n > 0:
        n, d = divmod(n, 58)
        head = _A[d] + head
    body = head + ''.join(reversed(blocks))
    # preserve leading zero bytes
    pad = 0
    for b in data:
        if b == 0:
            pad += 1
        else:
            break
    return '1' * pad + body


def _b58decode_py(s) -> bytes:
    if isinstance(s, bytes):
        s = s.decode('ascii')
    n = 0
    for ch in s.encode('ascii'):
        try:
            n = n * 58 + _INDEX[ch]
        except KeyError:
            raise ValueError("Invalid base58 character: {!r}".format(chr(ch)))
    full = n.to_bytes((n.bit_length() + 7) // 8, 'big') if n else b''
    pad = 0
    for ch in s:
        if ch == '1':
            pad += 1
        else:
            break
    return b'\x00' * pad + full


# csrc/fastpath.c's codec when it builds (byte-identical output;
# tests/test_torch_native.py cross-checks both directions)
from plenum_tpu_torch.ops.cuda_lib import try_load_host_ext as _try_load

_fp = _try_load("fastpath")
if _fp is not None:
    _encode_backend = _fp.b58encode
    b58decode = _fp.b58decode
else:
    _encode_backend = _b58encode_raw
    b58decode = _b58decode_py


def is_b58(s, length: int = None) -> bool:
    try:
        raw = b58decode(s)
    except Exception:
        return False
    return length is None or len(raw) == length
