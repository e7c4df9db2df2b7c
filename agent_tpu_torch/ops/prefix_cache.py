"""Content-hashed prefix cache: a repeated prompt skips its prefill —
counterpart of ``agent_tpu.ops.prefix_cache``.

A request's prefill output is keyed by a chained content hash of ``(model
version, padded length, token blocks)``: ``h_{j+1} = sha256(h_j ||
block_j)`` over fixed-size token blocks, seeded with the model's weights
key and the row's length, so two models or two pad buckets never collide.
Values are the exact float32 rows the prefill produced, so a hit equals the
cold encode that stored it. For this encoder-decoder family the encoder
output is the whole prefill state (the decoder's KV starts empty). Bounded
LRU on entries and bytes; the hit, miss and eviction counters feed the
serving ops' ``prefix_cache`` result field and the usage line's
``cache_hit_rows``.

Host-only and touched only by the device thread (inside the ops' execute
paths), so it takes no lock.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Optional

import numpy as np

# Tokens hashed per link of the chain.
HASH_BLOCK_TOKENS = 64


def prefix_key(model_version: str, ids_row: np.ndarray) -> str:
    """Chained content hash of one padded token row under one model."""
    row = np.ascontiguousarray(ids_row, dtype=np.int32)
    h = hashlib.sha256(f"{model_version}|L{row.shape[0]}".encode("utf-8"))
    for start in range(0, row.shape[0], HASH_BLOCK_TOKENS):
        h = hashlib.sha256(h.digest() + row[start:start + HASH_BLOCK_TOKENS].tobytes())
    return h.hexdigest()


class PrefixCache:
    """Bounded LRU of prefill rows keyed by :func:`prefix_key`."""

    def __init__(self, max_entries: int = 512, max_bytes: int = 256 * 2 ** 20) -> None:
        self.max_entries = max(1, int(max_entries))
        self.max_bytes = max(1, int(max_bytes))
        self._store: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self.bytes_used = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._store)

    def get(self, key: str) -> Optional[np.ndarray]:
        row = self._store.get(key)
        if row is None:
            self.misses += 1
            return None
        self._store.move_to_end(key)
        self.hits += 1
        return row

    def put(self, key: str, row: np.ndarray) -> None:
        if key in self._store:
            self._store.move_to_end(key)
            return
        row = np.ascontiguousarray(row, dtype=np.float32)
        if row.nbytes > self.max_bytes:
            return  # larger than the whole budget: never cached
        self._store[key] = row
        self.bytes_used += row.nbytes
        while len(self._store) > self.max_entries or self.bytes_used > self.max_bytes:
            _, victim = self._store.popitem(last=False)
            self.bytes_used -= victim.nbytes
            self.evictions += 1

    def clear(self) -> None:
        self._store.clear()
        self.bytes_used = 0

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "entries": len(self._store),
            "bytes": self.bytes_used,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "hit_rate": round(self.hits / total, 4) if total else 0.0,
        }
