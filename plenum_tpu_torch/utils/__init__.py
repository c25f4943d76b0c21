from plenum_tpu_torch.utils.util import (  # noqa: F401
    max_faulty,
    check_if_more_than_f_same_items,
    random_string,
    hex_to_bytes,
    pop_keys,
    get_utc_epoch,
    first,
    update_named_tuple,
)
