from plenum_tpu_torch.storage.kv_store import KeyValueStorage  # noqa: F401
from plenum_tpu_torch.storage.kv_memory import KeyValueStorageInMemory  # noqa: F401
from plenum_tpu_torch.storage.kv_file import KeyValueStorageFile  # noqa: F401
from plenum_tpu_torch.storage.helper import initKeyValueStorage  # noqa: F401
