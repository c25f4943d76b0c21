"""KV storage factory (reference: storage/helper.py:20 initKeyValueStorage;
port of plenum_tpu/storage/helper.py).

The table holds 'memory' and 'file' only, as the JAX package's does: its
'native' entry imports a module that does not exist, so there
initKeyValueStorage('native', ...) raises ValueError, and here too. Nodes
reach KeyValueStorageNative through bootstrap, not through this factory."""
from plenum_tpu_torch.storage.kv_memory import KeyValueStorageInMemory
from plenum_tpu_torch.storage.kv_file import KeyValueStorageFile


_BACKENDS = {
    'memory': lambda d, n, **kw: KeyValueStorageInMemory(),
    'file': KeyValueStorageFile,
}


def initKeyValueStorage(storage_type: str, data_dir: str, db_name: str,
                        read_only: bool = False, **kwargs):
    backend = _BACKENDS.get(storage_type)
    if backend is None:
        raise ValueError("unknown storage type {}".format(storage_type))
    return backend(data_dir, db_name, read_only=read_only, **kwargs) \
        if storage_type != 'memory' else backend(data_dir, db_name)
