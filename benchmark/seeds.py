"""Seeds derived from a run's `--seed`: one per purpose, so that weights,
inputs and the correctness sample draw from streams of their own."""
from __future__ import annotations

import hashlib


def subseed(seed: int, *tags) -> int:
    """A 63-bit seed for `tags` under `seed` (any whole number)."""
    text = ":".join([str(int(seed))] + [str(t) for t in tags]).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1
