"""Durable file-backed KV store: append-only log + in-memory index, with
log compaction on open. Fills the role RocksDB plays in the reference
(storage/kv_store_rocksdb.py:15); the port's node stores always use it (the
JAX package's native kvlog engine is ROADMAP A8). Simple, crash-safe (torn tails are
truncated on recovery), and adequate for ledgers whose hot path is
sequential append.

Record format: [klen u32][vlen u32 | 0xFFFFFFFF=tombstone][key][value].
Batches are framed as one [klen=0xFFFFFFFE][body_len][records...] record,
so a crash mid-batch truncates the WHOLE batch on recovery (atomicity —
the role RocksDB WriteBatch plays in the reference).
"""
import os
import struct
from typing import Iterable, Tuple

from plenum_tpu_torch.utils.sorted_fallback import SortedDict

from plenum_tpu_torch.storage.kv_store import KeyValueStorage, to_bytes

_HDR = struct.Struct('<II')
_TOMBSTONE = 0xFFFFFFFF
_BATCH = 0xFFFFFFFE


class KeyValueStorageFile(KeyValueStorage):
    def __init__(self, db_dir: str, db_name: str, read_only: bool = False):
        self._path = os.path.join(db_dir, db_name + '.kvlog')
        os.makedirs(db_dir, exist_ok=True)
        self._index = SortedDict()
        self._closed = False
        self._read_only = read_only
        self._recover()
        self._fh = None if read_only else open(self._path, 'ab')

    def _recover(self):
        if not os.path.exists(self._path):
            return
        valid_end = 0
        with open(self._path, 'rb') as fh:
            data = fh.read()
        pos = 0
        while pos + _HDR.size <= len(data):
            klen, vlen = _HDR.unpack_from(data, pos)
            if klen == _BATCH:
                if pos + _HDR.size + vlen > len(data):
                    break  # torn batch: drop it whole
                end = pos + _HDR.size + vlen
                self._apply_records(data, pos + _HDR.size, end)
                pos = end
            else:
                body = klen + (0 if vlen == _TOMBSTONE else vlen)
                if pos + _HDR.size + body > len(data):
                    break  # torn tail
                self._apply_records(data, pos, pos + _HDR.size + body)
                pos += _HDR.size + body
            valid_end = pos
        if valid_end < len(data) and not self._read_only:
            with open(self._path, 'r+b') as fh:
                fh.truncate(valid_end)

    def _apply_records(self, data: bytes, pos: int, end: int):
        while pos + _HDR.size <= end:
            klen, vlen = _HDR.unpack_from(data, pos)
            body = klen + (0 if vlen == _TOMBSTONE else vlen)
            if pos + _HDR.size + body > end:
                break  # defensive: malformed interior record
            key = data[pos + _HDR.size: pos + _HDR.size + klen]
            if vlen == _TOMBSTONE:
                self._index.pop(key, None)
            else:
                val = data[pos + _HDR.size + klen: pos + _HDR.size + klen + vlen]
                self._index[key] = val
            pos += _HDR.size + body

    def _append(self, key: bytes, value) -> None:
        if self._read_only:
            raise RuntimeError("read-only store")
        if value is None:
            rec = _HDR.pack(len(key), _TOMBSTONE) + key
        else:
            rec = _HDR.pack(len(key), len(value)) + key + value
        self._fh.write(rec)

    def put(self, key, value):
        key, value = to_bytes(key), to_bytes(value)
        self._append(key, value)
        self._fh.flush()
        self._index[key] = value

    def get(self, key) -> bytes:
        return self._index[to_bytes(key)]

    def remove(self, key):
        key = to_bytes(key)
        if key in self._index:
            self._append(key, None)
            self._fh.flush()
            del self._index[key]

    @staticmethod
    def _record(key: bytes, value) -> bytes:
        if value is None:
            return _HDR.pack(len(key), _TOMBSTONE) + key
        return _HDR.pack(len(key), len(value)) + key + value

    def _write_framed(self, records, updates):
        """One atomic batch frame: all-or-nothing on crash recovery."""
        if self._read_only:
            raise RuntimeError("read-only store")
        body = b''.join(records)
        self._fh.write(_HDR.pack(_BATCH, len(body)) + body)
        self._fh.flush()
        for key, value in updates:
            if value is None:
                self._index.pop(key, None)
            else:
                self._index[key] = value

    def setBatch(self, batch: Iterable[Tuple]):
        records, updates = [], []
        for key, value in batch:
            key, value = to_bytes(key), to_bytes(value)
            records.append(self._record(key, value))
            updates.append((key, value))
        self._write_framed(records, updates)

    def do_ops_in_batch(self, batch: Iterable[Tuple]):
        records, updates = [], []
        for op, key, *rest in batch:
            key = to_bytes(key)
            if op == 'put':
                value = to_bytes(rest[0])
                records.append(self._record(key, value))
                updates.append((key, value))
            elif op == 'remove':
                records.append(self._record(key, None))
                updates.append((key, None))
            else:
                raise ValueError("unknown batch op {}".format(op))
        self._write_framed(records, updates)

    def iterator(self, start=None, end=None, include_value=True):
        start = to_bytes(start) if start is not None else None
        end = to_bytes(end) if end is not None else None
        keys = list(self._index.irange(minimum=start, maximum=end))
        if include_value:
            return iter([(k, self._index[k]) for k in keys])
        return iter(keys)

    def compact(self):
        """Rewrite the log with only live records."""
        tmp = self._path + '.compact'
        with open(tmp, 'wb') as fh:
            for k, v in self._index.items():
                fh.write(_HDR.pack(len(k), len(v)) + k + v)
        if self._fh:
            self._fh.close()
        os.replace(tmp, self._path)
        self._fh = open(self._path, 'ab')

    def drop(self):
        self._index.clear()
        if self._fh:
            self._fh.close()
        if os.path.exists(self._path):
            os.remove(self._path)
        if not self._read_only:
            self._fh = open(self._path, 'ab')

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
        self._closed = True

    @property
    def closed(self):
        return self._closed

    @property
    def size(self):
        return len(self._index)
