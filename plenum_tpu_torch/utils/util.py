"""Small shared helpers (reference: plenum/common/util.py)."""
import random
import string
import time
from collections import Counter
from typing import Any, Callable, Iterable, List, Optional, Sequence


def max_faulty(n: int) -> int:
    """f = ⌊(n-1)/3⌋ — max byzantine faults tolerated by an n-node pool
    (reference: plenum/common/util.py:220 getMaxFailures)."""
    return (n - 1) // 3


def check_if_more_than_f_same_items(items: Iterable[Any], f: int) -> Optional[Any]:
    """Return the item that occurs more than f times, if any (reference:
    plenum/common/util.py checkIfMoreThanFSameItems). Items are compared by a
    canonical JSON encoding (sorted keys at every nesting level) so dicts
    deserialized from different nodes with different key order still match."""
    import json

    def canon(i):
        try:
            return json.dumps(i, sort_keys=True, default=repr)
        except TypeError:
            return repr(i)

    keyed = [(canon(i), i) for i in items]
    counts = Counter(k for k, _ in keyed)
    if not counts:
        return None
    key, cnt = counts.most_common(1)[0]
    if cnt > f:
        for k, item in keyed:
            if k == key:
                return item
    return None


def random_string(size: int = 20, rng: Optional[random.Random] = None) -> str:
    rng = rng or random
    return ''.join(rng.choice(string.ascii_letters + string.digits)
                   for _ in range(size))


def hex_to_bytes(h: str) -> bytes:
    return bytes.fromhex(h)


def pop_keys(mapping: dict, cond: Callable[[Any], bool]) -> None:
    for k in [k for k in mapping if cond(k)]:
        mapping.pop(k)


def get_utc_epoch() -> int:
    """Integer UTC epoch seconds — consensus timestamps are ints (reference:
    plenum/common/util.py get_utc_epoch)."""
    return int(time.time())


def first(seq: Iterable[Any], default: Any = None) -> Any:
    for x in seq:
        return x
    return default


def update_named_tuple(nt, **kwargs):
    return nt._replace(**kwargs)


def min_containing_range(seqs: Sequence[int]) -> Optional[range]:
    if not seqs:
        return None
    return range(min(seqs), max(seqs) + 1)


def compare_3pc_keys(key1, key2) -> int:
    """Negative if key1 is after key2 (reference:
    plenum/common/util.py compare_3PC_keys). Keys are (view_no, pp_seq_no)."""
    if key1[0] == key2[0]:
        return key2[1] - key1[1]
    return key2[0] - key1[0]
