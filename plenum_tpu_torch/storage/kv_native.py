"""Native log-structured KV store — ctypes bridge to the port's
csrc/kvlog.c (the framework's RocksDB-equivalent, reference
storage/kv_store_rocksdb.py:15), built by ops/cuda_lib.load_host.

Same .kvlog on-disk format as KeyValueStorageFile, so the two backends
open each other's files; unlike the Python backend, VALUES STAY ON
DISK — only the C index (key bytes + offsets) is resident. A sorted
key cache on the Python side provides ordered iteration; it is rebuilt
from the C index snapshot on open and maintained incrementally after.
"""
from __future__ import annotations

import ctypes
import os
import struct
from typing import Iterable, Iterator, Tuple

from plenum_tpu_torch.storage.kv_store import KeyValueStorage, to_bytes
from plenum_tpu_torch.utils.sorted_fallback import SortedSet

_lib = None


def _get_lib():
    global _lib
    if _lib is None:
        from plenum_tpu_torch.ops.cuda_lib import load_host
        lib = load_host("kvlog")
        lib.kv_open.argtypes = [ctypes.c_char_p]
        lib.kv_open.restype = ctypes.c_void_p
        lib.kv_close.argtypes = [ctypes.c_void_p]
        lib.kv_flush.argtypes = [ctypes.c_void_p]
        lib.kv_put.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                               ctypes.c_uint32, ctypes.c_char_p,
                               ctypes.c_uint32]
        lib.kv_put.restype = ctypes.c_int
        lib.kv_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                               ctypes.c_uint32, ctypes.c_char_p,
                               ctypes.c_uint64]
        lib.kv_get.restype = ctypes.c_long
        lib.kv_remove.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_uint32]
        lib.kv_remove.restype = ctypes.c_int
        lib.kv_batch_begin.argtypes = [ctypes.c_void_p]
        lib.kv_batch_begin.restype = ctypes.c_int
        lib.kv_batch_end.argtypes = [ctypes.c_void_p]
        lib.kv_batch_end.restype = ctypes.c_int
        lib.kv_apply_packed.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.c_uint64]
        lib.kv_apply_packed.restype = ctypes.c_int
        lib.kv_count.argtypes = [ctypes.c_void_p]
        lib.kv_count.restype = ctypes.c_uint64
        lib.kv_garbage.argtypes = [ctypes.c_void_p]
        lib.kv_garbage.restype = ctypes.c_uint64
        lib.kv_keys_size.argtypes = [ctypes.c_void_p]
        lib.kv_keys_size.restype = ctypes.c_uint64
        lib.kv_keys.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.kv_compact.argtypes = [ctypes.c_void_p]
        lib.kv_compact.restype = ctypes.c_int
        _lib = lib
    return _lib


def available() -> bool:
    """Whether csrc/kvlog.c builds and loads here (the store is then
    KeyValueStorageNative; bootstrap keeps KeyValueStorageFile else)."""
    from plenum_tpu_torch.ops.cuda_lib import try_load_host
    if try_load_host("kvlog") is None:
        return False
    _get_lib()
    return True


class KeyValueStorageNative(KeyValueStorage):
    def __init__(self, db_dir: str, db_name: str):
        os.makedirs(db_dir, exist_ok=True)
        self._path = os.path.join(db_dir, db_name + ".kvlog")
        self._lib = _get_lib()
        self._db = self._lib.kv_open(self._path.encode())
        if not self._db:
            raise IOError("kvlog open failed: {}".format(self._path))
        self._closed = False
        self._keys = SortedSet(self._snapshot_keys())

    def _handle(self):
        """The C engine dereferences the handle unchecked — a NULL from
        a closed store would segfault the process, so guard here."""
        if self._closed or not self._db:
            raise ValueError("operation on closed kvlog store {}".format(
                self._path))
        return self._db

    def _snapshot_keys(self):
        size = self._lib.kv_keys_size(self._handle())
        if size == 0:
            return []
        buf = ctypes.create_string_buffer(size)
        self._lib.kv_keys(self._handle(), buf)
        keys, pos, raw = [], 0, buf.raw
        while pos + 4 <= size:
            (klen,) = struct.unpack_from("<I", raw, pos)
            keys.append(raw[pos + 4:pos + 4 + klen])
            pos += 4 + klen
        return keys

    # ------------------------------------------------------------- ops

    def put(self, key, value):
        key, value = to_bytes(key), to_bytes(value)
        if self._lib.kv_put(self._handle(), key, len(key), value,
                            len(value)) != 0:
            raise IOError("kvlog put failed")
        self._keys.add(key)

    def get(self, key) -> bytes:
        key = to_bytes(key)
        cap = 4096
        while True:
            buf = ctypes.create_string_buffer(cap)
            n = self._lib.kv_get(self._handle(), key, len(key), buf, cap)
            if n < 0:
                if n == -2:
                    raise IOError("kvlog read failed")
                raise KeyError(key)
            if n <= cap:
                return buf.raw[:n]
            cap = n

    def get_or_none(self, key):
        key = to_bytes(key)
        if key not in self._keys:
            return None
        return self.get(key)

    def remove(self, key):
        key = to_bytes(key)
        if self._lib.kv_remove(self._handle(), key, len(key)) != 0:
            raise IOError("kvlog remove failed")
        self._keys.discard(key)

    def _apply_packed(self, parts, ordered_ops):
        """ordered_ops = [(key, is_put)] in BATCH ORDER — the key cache
        must see remove-then-put of one key end live, like the engine."""
        packed = b"".join(parts)
        if self._lib.kv_apply_packed(self._handle(), packed,
                                     len(packed)) != 0:
            raise IOError("kvlog batch failed")
        for key, is_put in ordered_ops:
            if is_put:
                self._keys.add(key)
            else:
                self._keys.discard(key)

    def setBatch(self, batch: Iterable[Tuple]):
        """One FFI call: records packed host-side into the wire format,
        applied by the engine as a single atomic batch frame."""
        parts, ops = [], []
        for key, value in batch:
            key, value = to_bytes(key), to_bytes(value)
            parts.append(struct.pack("<II", len(key), len(value)))
            parts.append(key)
            parts.append(value)
            ops.append((key, True))
        self._apply_packed(parts, ops)

    def do_ops_in_batch(self, batch: Iterable[Tuple]):
        """batch of ('put', key, value) / ('remove', key) — one atomic
        on-disk frame, like setBatch."""
        parts, ops = [], []
        for op, key, *rest in batch:
            key = to_bytes(key)
            if op == "put":
                value = to_bytes(rest[0])
                parts.append(struct.pack("<II", len(key), len(value)))
                parts.append(key)
                parts.append(value)
                ops.append((key, True))
            elif op == "remove":
                parts.append(struct.pack("<II", len(key), 0xFFFFFFFF))
                parts.append(key)
                ops.append((key, False))
            else:
                raise ValueError("unknown batch op {}".format(op))
        self._apply_packed(parts, ops)

    def iterator(self, start=None, end=None,
                 include_value=True) -> Iterator:
        start = to_bytes(start) if start is not None else None
        end = to_bytes(end) if end is not None else None
        keys = list(self._keys.irange(start, end))
        if include_value:
            # materialized snapshot, like the file backend: mutations
            # during consumption must not change what the iterator yields
            return iter([(k, self.get(k)) for k in keys])
        return iter(keys)

    # ------------------------------------------------------ maintenance

    def compact(self):
        if self._lib.kv_compact(self._handle()) != 0:
            raise IOError("kvlog compact failed")

    @property
    def garbage_bytes(self) -> int:
        return self._lib.kv_garbage(self._handle())

    def __len__(self):
        return self._lib.kv_count(self._handle())

    @property
    def size(self) -> int:
        return self._lib.kv_count(self._handle())

    def drop(self):
        self._lib.kv_close(self._db)
        if os.path.exists(self._path):
            os.unlink(self._path)
        self._db = self._lib.kv_open(self._path.encode())
        self._keys = SortedSet()

    def close(self):
        if not self._closed:
            self._lib.kv_close(self._db)
            self._db = None
            self._closed = True

    @property
    def closed(self) -> bool:
        return self._closed
