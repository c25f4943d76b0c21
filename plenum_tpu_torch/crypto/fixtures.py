"""Deterministic signature fixtures shared by chip_smoke.py and the tests
— one generator so every harness exercises the same data path (port of
plenum_tpu/crypto/fixtures.py).
"""
from typing import List, Tuple

import numpy as np


def make_signed_batch(count: int, seed: int = 0, unique: int = None,
                      msg_prefix: bytes = b"fixture"
                      ) -> Tuple[List[bytes], List[bytes], List[bytes]]:
    """→ (msgs, sigs, verkeys), `unique` distinct keypairs tiled to
    `count` entries. Keygen and signing run the port's own RFC 8032
    code (crypto/ed25519.py); Ed25519 is deterministic, so the outputs
    are bit-identical to the JAX package's OpenSSL-signed ones. Only the
    `unique` keypairs are signed, each in a few milliseconds of pure
    Python."""
    from plenum_tpu_torch.crypto.signer import SimpleSigner

    unique = min(count, unique or count)
    rng = np.random.RandomState(seed)
    msgs, sigs, vks = [], [], []
    for i in range(unique):
        kseed = bytes(rng.randint(0, 256, 32, dtype=np.uint8))
        signer = SimpleSigner(seed=kseed)
        msg = msg_prefix + b"-%d" % i
        msgs.append(msg)
        sigs.append(signer.sign_bytes(msg))
        vks.append(signer.verraw)
    reps = (count + unique - 1) // unique
    return ((msgs * reps)[:count], (sigs * reps)[:count],
            (vks * reps)[:count])
