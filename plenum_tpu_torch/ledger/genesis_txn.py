"""Genesis transaction bootstrap (reference: ledger/genesis_txn/ — file
with one JSON txn per line, or an in-memory list)."""
import json
import os
from typing import Iterator, List


class GenesisTxnInitiatorFromFile:
    def __init__(self, data_dir: str, txn_file: str):
        self._path = os.path.join(data_dir, txn_file)

    def __call__(self) -> Iterator[dict]:
        if not os.path.exists(self._path):
            return
        with open(self._path) as fh:
            for line in fh:
                line = line.strip()
                if line:
                    yield json.loads(line)


class GenesisTxnInitiatorFromMem:
    def __init__(self, txns: List[dict]):
        self._txns = txns

    def __call__(self) -> Iterator[dict]:
        return iter([json.loads(json.dumps(t)) for t in self._txns])


def create_genesis_txn_file(txns: List[dict], data_dir: str, txn_file: str):
    os.makedirs(data_dir, exist_ok=True)
    path = os.path.join(data_dir, txn_file)
    with open(path, 'w') as fh:
        for txn in txns:
            fh.write(json.dumps(txn, sort_keys=True) + '\n')
    return path
