"""Seeds derived from the run's ``--seed`` (any whole number, however
large): one per purpose, so that no two streams share a draw."""
from __future__ import annotations

import hashlib


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for the stream named by `tags` under `seed`."""
    key = ":".join(str(t) for t in (seed, *tags)).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "big") >> 1
